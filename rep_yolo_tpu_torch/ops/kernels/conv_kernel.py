"""Channel-major float 3x3 and 1x1 convolutions: CUDA kernels + plain versions.

Replaces ``rep_yolo_tpu/ops/pallas/conv_kernel.py``: ``conv3x3_cmajor`` (K10
``conv3x3_cmajor``: 3x3, stride 1, zero padding 1) and ``conv1x1_cmajor``
(K11 ``conv1x1_cmajor``, over 1-3 input sections read in place of their
concat), each followed by bias and SiLU or no activation. They run the DER
blocks' ``"bf16"`` deploy path (``DERBlock.forward_cm``). Source:
``csrc/conv_kernel.cu``.

Activations are NCHW, bfloat16 or float32; the output is in x's dtype. The
sums and the epilogue are float32 with one rounding at the end; the bias is
the float32 value of the conv's bias parameter. Weights are a ``CMConv``,
packed once per dtype. The wrappers take the plain versions for CPU tensors
only; on a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rep_yolo_tpu_torch import device as D

LAUNCHES = {"conv3x3_cmajor": 0, "conv1x1_cmajor": 0}
_BM = 32            # output channels per block of the kernels
_ACTS = {"silu": 1, None: 0}
_DTYPES = (torch.bfloat16, torch.float32)


def _lib():
    lib = D.load_kernel("conv_kernel")
    if not getattr(lib, "_typed", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3_cmajor.argtypes = [vp] * 4 + [i32] * 7 + [vp]
        lib.conv3x3_cmajor.restype = i32
        lib.conv1x1_cmajor.argtypes = [vp] * 3 + [i32] * 3 + [vp] * 3 \
            + [i32] * 5 + [vp]
        lib.conv1x1_cmajor.restype = i32
        lib._typed = True
    return lib


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


class CMConv:
    """One deploy conv's weights for K10 / K11: ``weight`` (O, C, k, k) as
    the model holds it, ``bias`` (O,) float32. ``packed(dtype)`` is the
    kernels' copy in that dtype, made at the first launch and kept:

    - bfloat16, 3x3: (Opad, nchunks * 144), k = chunk * 144 + tap * 16 + c
      over chunks of 16 input channels, tap = u * 3 + v;
    - bfloat16, 1x1: (Opad, Cp), Cp = C rounded up to 16;
    - float32, 3x3: (Opad / 32, Cp, 9, 32), Cp = C rounded up to 8;
    - float32, 1x1: (Opad / 32, Cp, 32), Cp = C rounded up to 16;

    Opad = O rounded up to 32; the padding is zeros."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor | None):
        self.weight = weight.detach()
        O = self.weight.shape[0]
        if bias is None:
            bias = torch.zeros(O, device=self.weight.device)
        self.bias = bias.detach().float().contiguous()
        self.k = self.weight.shape[-1]
        self._packed: dict[torch.dtype, torch.Tensor] = {}

    @property
    def c_in(self) -> int:
        return self.weight.shape[1]

    @property
    def c_out(self) -> int:
        return self.weight.shape[0]

    def packed(self, dtype: torch.dtype) -> torch.Tensor:
        if dtype not in self._packed:
            O, C, k, _ = self.weight.shape
            opad = _up(O, _BM)
            cp = _up(C, 8 if (k == 3 and dtype == torch.float32) else 16)
            w = torch.zeros((opad, cp, k * k), dtype=dtype,
                            device=self.weight.device)
            w[:O, :C] = self.weight.reshape(O, C, k * k).to(dtype)
            if dtype == torch.bfloat16:
                if k == 3:                    # (Opad, chunk, tap, c)
                    w = w.reshape(opad, cp // 16, 16, 9).permute(0, 1, 3, 2)
                w = w.reshape(opad, -1)
            else:                             # (Opad/32, c, tap, 32)
                w = w.reshape(opad // _BM, _BM, cp, k * k).permute(0, 2, 3, 1)
            self._packed[dtype] = w.contiguous()
        return self._packed[dtype]


def _sections(xs) -> list[torch.Tensor]:
    return list(xs) if isinstance(xs, (list, tuple)) else [xs]


def _epilogue(y: torch.Tensor, act: str | None) -> torch.Tensor:
    if act == "silu":
        return F.silu(y)
    if act is None:
        return y
    raise ValueError(f"unknown activation {act!r}")


def _plain(x: torch.Tensor, cw: CMConv, act: str | None) -> torch.Tensor:
    """float32 conv of x with the weights rounded to x's dtype, the bias and
    the activation in float32, then one rounding to x's dtype."""
    w = cw.weight.to(x.dtype).float()
    y = F.conv2d(x.float(), w, cw.bias.to(x.device), padding=cw.k // 2)
    return _epilogue(y, act).to(x.dtype)


def _check(name: str, xs, cw: CMConv, act) -> None:
    x0 = xs[0]
    dev, dt = x0.device, x0.dtype
    if act not in _ACTS:
        raise ValueError(f"{name}: unknown activation {act!r}")
    if dt not in _DTYPES:
        raise ValueError(f"{name}: expected bfloat16 or float32, got {dt}")
    for t in xs:
        if t.dim() != 4 or x0.dim() != 4 or t.device != dev or t.dtype != dt \
                or t.shape[0] != x0.shape[0] or t.shape[2:] != x0.shape[2:]:
            raise ValueError(f"{name}: expected NCHW {dt} sections of one "
                             f"(B, H, W) on {dev}, got "
                             f"{[(t.dtype, tuple(t.shape)) for t in xs]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: input is not contiguous")
    if sum(t.shape[1] for t in xs) != cw.c_in:
        raise ValueError(f"{name}: {sum(t.shape[1] for t in xs)} input "
                         f"channels, the weights take {cw.c_in}")
    if cw.weight.device != dev or cw.bias.device != dev:
        raise ValueError(f"{name}: weights on {cw.weight.device}, input on "
                         f"{dev}")


# ---------------------------------------------------------------------------
# K10: 3x3
# ---------------------------------------------------------------------------

def conv3x3_cmajor_plain(x: torch.Tensor, cw: CMConv,
                         act: str | None = "silu") -> torch.Tensor:
    """x (B, C, H, W) -> (B, O, H, W) in x's dtype; stride 1, pad 1."""
    return _plain(x, cw, act)


def conv3x3_cmajor(x: torch.Tensor, cw: CMConv,
                   act: str | None = "silu") -> torch.Tensor:
    """K10. CPU tensors take ``conv3x3_cmajor_plain``."""
    if x.device.type == "cpu":
        return conv3x3_cmajor_plain(x, cw, act)
    _check("conv3x3_cmajor", [x], cw, act)
    if cw.k != 3:
        raise ValueError(f"conv3x3_cmajor: the weights are {cw.k}x{cw.k}")
    B, C, H, W = x.shape
    y = torch.empty((B, cw.c_out, H, W), dtype=x.dtype, device=x.device)
    err = _lib().conv3x3_cmajor(
        D.ptr(x), D.ptr(cw.packed(x.dtype)), D.ptr(cw.bias), D.ptr(y), B, C,
        H, W, cw.c_out, int(x.dtype == torch.bfloat16), _ACTS[act],
        D.stream_handle(x))
    D.check_launch("conv3x3_cmajor", err)
    LAUNCHES["conv3x3_cmajor"] += 1
    return y


# ---------------------------------------------------------------------------
# K11: 1x1 over sections
# ---------------------------------------------------------------------------

def conv1x1_cmajor_plain(xs, cw: CMConv,
                         act: str | None = "silu") -> torch.Tensor:
    """conv1x1(concat(xs, 1)): sections (B, C_s, H, W) -> (B, O, H, W) in
    their dtype."""
    xs = _sections(xs)
    return _plain(torch.cat(xs, 1) if len(xs) > 1 else xs[0], cw, act)


def conv1x1_cmajor(xs, cw: CMConv, act: str | None = "silu") -> torch.Tensor:
    """K11. CPU tensors take ``conv1x1_cmajor_plain``. In bfloat16 every
    section's channel count and H*W must be even and its data 4-byte
    aligned (pairs of channels and of pixels are read as one 32-bit
    word)."""
    xs = _sections(xs)
    if xs[0].device.type == "cpu":
        return conv1x1_cmajor_plain(xs, cw, act)
    _check("conv1x1_cmajor", xs, cw, act)
    if cw.k != 1 or not 1 <= len(xs) <= 3:
        raise ValueError(f"conv1x1_cmajor: {len(xs)} sections, weights "
                         f"{cw.k}x{cw.k}")
    B, _, H, W = xs[0].shape
    cs = [t.shape[1] for t in xs]
    bf16 = xs[0].dtype == torch.bfloat16
    if bf16 and (any(c % 2 for c in cs) or (H * W) % 2
                 or any(t.data_ptr() % 4 for t in xs)):
        raise ValueError(f"conv1x1_cmajor: bfloat16 needs even section "
                         f"channels, an even H*W and 4-byte aligned "
                         f"sections, got {cs}, {H}x{W}")
    y = torch.empty((B, cw.c_out, H, W), dtype=xs[0].dtype,
                    device=xs[0].device)
    ptrs = [D.ptr(t) for t in xs] + [None] * (3 - len(xs))
    cs3 = cs + [0] * (3 - len(cs))
    err = _lib().conv1x1_cmajor(
        *ptrs, *cs3, D.ptr(cw.packed(xs[0].dtype)), D.ptr(cw.bias), D.ptr(y),
        B, H * W, cw.c_out, int(bf16), _ACTS[act], D.stream_handle(xs[0]))
    D.check_launch("conv1x1_cmajor", err)
    LAUNCHES["conv1x1_cmajor"] += 1
    return y
