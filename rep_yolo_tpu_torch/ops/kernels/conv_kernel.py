"""Channel-major 3x3 and 1x1 convolutions, float and int8: CUDA kernels +
plain versions.

Replaces ``rep_yolo_tpu/ops/pallas/conv_kernel.py``: ``conv3x3_cmajor`` (K10
``conv3x3_cmajor``: 3x3, stride 1, zero padding 1) and ``conv1x1_cmajor``
(K11 ``conv1x1_cmajor``, over 1-3 input sections read in place of their
concat), each followed by bias and SiLU or no activation. They run the DER
blocks' ``"bf16"`` deploy path (``DERBlock.forward_cm``). Source:
``csrc/conv_kernel.cu``: in bfloat16 implicit GEMMs on ``wgmma`` (pixels
on M, output channels on N), in float32 FFMA.

Activations are NCHW, bfloat16 or float32; the output is in x's dtype. The
sums and the epilogue are float32 with one rounding at the end; the bias is
the float32 value of the conv's bias parameter. Weights are a ``CMConv``,
packed once per dtype. The wrappers take the plain versions for CPU tensors
only; on a CUDA tensor they launch the kernel or raise.

And the int8 ones, ``conv3x3_cmajor_q8`` (K13) and ``conv1x1_cmajor_q8``
(K14, 1-3 sections), which the kernel benches reach
(``rep_yolo_tpu_torch/tools/kernel_bench*.py``). Source:
``csrc/conv_cmajor_q8.cu``; K13 runs K4's int8 ``wgmma`` core
(``csrc/conv_wgmma.cuh``) on NCHW input, its tile from ``k13_route``. The
input (B, C, H, W) is int8 at ``s_in`` or float32 / bfloat16 quantized in
the kernel at ``s_in``; the weights are a ``CMQConv``, quantized once per
output channel (K13 reads ``packed_wgmma3``, K14 ``packed_cm``); the output
is bfloat16 (the float32 epilogue rounded once) or int8 at ``out_scale``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from rep_yolo_tpu_torch import device as D
from rep_yolo_tpu_torch.ops.kernels import conv_flat as K_conv
from rep_yolo_tpu_torch.ops.kernels.conv_flat import QConv

LAUNCHES = {"conv3x3_cmajor": 0, "conv1x1_cmajor": 0,
            "conv3x3_cmajor_q8": 0, "conv1x1_cmajor_q8": 0}
_BM = 32            # output channels per block of the float32 and int8 kernels
_NG = 8             # bfloat16: output channels per core-matrix row group
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

    - bfloat16, 3x3: (Cp / 16, 9, Opad / 8, 2, 8, 8): [chunk][tap][o // 8]
      [half][o % 8][c % 8] with c = 16 chunk + 8 half + c % 8, tap = u * 3
      + v, Opad = O rounded up to 8 (the wgmma B operand's core matrices,
      8 output channels x 8 input channels, in the order the kernel reads
      them: one k16 step per (chunk, tap));
    - bfloat16, 1x1: (Cp / 16, Opad / 8, 2, 8, 8), the same over k16
      steps of the input channels;
    - float32, 3x3: (Opad / 32, Cp, 9, 32), Cp = C rounded up to 8;
    - float32, 1x1: (Opad / 32, Cp, 32), Cp = C rounded up to 16;

    bfloat16: Cp = C rounded up to 16; float32: Opad = O rounded up to 32.
    The padding is zeros."""

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
            bf16 = dtype == torch.bfloat16
            opad = _up(O, _NG if bf16 else _BM)
            cp = _up(C, 8 if (k == 3 and not bf16) else 16)
            w = torch.zeros((opad, cp, k * k), dtype=dtype,
                            device=self.weight.device)
            w[:O, :C] = self.weight.reshape(O, C, k * k).to(dtype)
            if bf16:                          # (c16, tap, o8, half, o, c)
                w = w.reshape(opad // _NG, _NG, cp // 16, 2, 8, k * k) \
                    .permute(2, 5, 0, 3, 1, 4)
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
    """K11. CPU tensors take ``conv1x1_cmajor_plain``. The sections are
    read in place, each from its own tensor."""
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


# ---------------------------------------------------------------------------
# K13 / K14: int8
# ---------------------------------------------------------------------------

_KQ = 32            # input channels per k-step of the int8 kernels
_IN_TYPES = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}


def _lib_q8():
    lib = D.load_kernel("conv_cmajor_q8")
    if not getattr(lib, "_typed", False):
        vp, i32, i64, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_float)
        lib.conv3x3_cmajor_q8.argtypes = [vp] * 5 + [i32] * 10 + [f] * 3 \
            + [i32, vp]
        lib.conv3x3_cmajor_q8.restype = i32
        lib.conv1x1_cmajor_q8.argtypes = [vp] * 3 + [i32] * 3 + [vp] * 4 \
            + [i32, i64] + [i32] * 3 + [f] * 3 + [i32, vp]
        lib.conv1x1_cmajor_q8.restype = i32
        lib._typed = True
    return lib


class CMQConv(QConv):
    """One conv's int8 weights for K13 / K14: ``QConv``'s per-output-channel
    quantization (``w_q``, ``s_w``, ``bias``). K13 reads ``QConv``'s
    ``packed_wgmma3`` (K4's operand: the same implicit GEMM). ``packed_cm``
    is K14's copy (and the TPU kernels' row-major form of the 3x3):

    - 3x3: (Opad, Cpad / 32, 9, 32) int8, tap = u * 3 + v;
    - 1x1: (Opad, Cpad) int8;

    Opad = O rounded up to 32, Cpad = C rounded up to 32, zeros there."""

    def packed_cm(self) -> torch.Tensor:
        if "cm" not in self._packed:
            O, k, _, cp4 = self.w_q.shape
            C = self.c_in
            opad, cpad = _up(O, _BM), _up(C, _KQ)
            w = torch.zeros((opad, k * k, cpad), dtype=torch.int8,
                            device=self.w_q.device)
            w[:O, :, :C] = self.w_q.reshape(O, k * k, cp4)[..., :C]
            if k == 3:
                w = w.reshape(opad, 9, cpad // _KQ, _KQ).permute(0, 2, 1, 3)
            self._packed["cm"] = w.reshape(opad, -1).contiguous()
        return self._packed["cm"]


def _plain_q8(x: torch.Tensor, qw: QConv, s_in: float, act,
              out_scale) -> torch.Tensor:
    """K4's plain version on NCHW: int8 x (or float x quantized at
    ``s_in``) -> (B, O, H, W) int8 at ``out_scale`` or bfloat16."""
    y = K_conv.conv3x3_q8_plain(x.permute(0, 2, 3, 1), qw, s_in, 1, act,
                                out_scale, torch.bfloat16)
    return y.permute(0, 3, 1, 2).contiguous()


def _check_q8(name: str, xs, qw: QConv, act) -> None:
    x0 = xs[0]
    dev, dt = x0.device, x0.dtype
    if act not in K_conv._ACTS:
        raise ValueError(f"{name}: unknown activation {act!r}")
    if dt not in _IN_TYPES:
        raise ValueError(f"{name}: expected int8, float32 or bfloat16 input, "
                         f"got {dt}")
    for t in xs:
        if t.dim() != 4 or t.device != dev or t.dtype != dt \
                or t.shape[0] != x0.shape[0] or t.shape[2:] != x0.shape[2:]:
            raise ValueError(f"{name}: expected NCHW {dt} sections of one "
                             f"(B, H, W) on {dev}, got "
                             f"{[(t.dtype, tuple(t.shape)) for t in xs]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: input is not contiguous")
    if sum(t.shape[1] for t in xs) != qw.c_in:
        raise ValueError(f"{name}: {sum(t.shape[1] for t in xs)} input "
                         f"channels, the weights take {qw.c_in}")
    if any(t.device != dev for t in (qw.w_q, qw.s_w, qw.bias)):
        raise ValueError(f"{name}: weights on {qw.w_q.device}, input on "
                         f"{dev}")


def conv3x3_cmajor_q8_plain(x: torch.Tensor, qw: QConv, s_in: float,
                            act: str | None = "silu",
                            out_scale: float | None = None) -> torch.Tensor:
    """x (B, C, H, W) int8 at ``s_in`` or float -> (B, O, H, W) bfloat16, or
    int8 at ``out_scale``; stride 1, pad 1."""
    return _plain_q8(x, qw, s_in, act, out_scale)


def k13_route(C: int, O: int, B: int, H: int, W: int,
              dtype: torch.dtype) -> tuple:
    """K13's route for a 3x3 of ``C`` -> ``O`` channels on a (B, C, H, W)
    map of ``dtype``: ``("wgmma", BN, MI, TW)``, K4's stride-1 int8 wgmma
    core on NCHW input. BN: the smallest of ``K4_TILES`` that holds O, else
    128, never narrower: a block's time goes to staging its input (loads,
    quantizing, the byte transpose), which a narrower tile repeats for
    every BN output channels (on one H100 it lost at every multi-chunk
    kernel_bench shape, thin grids included). MI 2; TW ``k4_width``'s with
    widths a multiple of 4 (the epilogue stores 4 pixels a thread). Refuses
    a dtype other than int8, float32 and bfloat16, and an empty shape."""
    if dtype not in _IN_TYPES:
        raise ValueError(f"conv3x3_cmajor_q8: {dtype} input")
    if min(C, O, B, H, W) <= 0:
        raise ValueError(f"conv3x3_cmajor_q8: shape {(B, C, H, W)} -> {O}")
    return _k13_route(int(O), int(B), int(H), int(W))


@functools.lru_cache(maxsize=None)
def _k13_route(O, B, H, W) -> tuple:
    table = K_conv.K4_TILES
    bn = next((b for b in table if O <= b), max(table))
    return "wgmma", bn, table[bn], K_conv.k4_width(H, W, 128 * table[bn], 1,
                                                    3, 4)[0]


def conv3x3_cmajor_q8(x: torch.Tensor, qw: QConv, s_in: float,
                      act: str | None = "silu",
                      out_scale: float | None = None) -> torch.Tensor:
    """K13, on the tile ``k13_route`` picks. CPU tensors take
    ``conv3x3_cmajor_q8_plain``."""
    if x.device.type == "cpu":
        return conv3x3_cmajor_q8_plain(x, qw, s_in, act, out_scale)
    _check_q8("conv3x3_cmajor_q8", [x], qw, act)
    if qw.k != 3:
        raise ValueError(f"conv3x3_cmajor_q8: the weights are {qw.k}x{qw.k}")
    B, C, H, W = x.shape
    _, bn, mi, tw = k13_route(C, qw.c_out, B, H, W, x.dtype)
    y = torch.empty((B, qw.c_out, H, W), device=x.device,
                    dtype=torch.bfloat16 if out_scale is None else torch.int8)
    s, inv_s, inv_out = K_conv._scales(s_in, out_scale)
    err = _lib_q8().conv3x3_cmajor_q8(
        D.ptr(x), D.ptr(qw.packed_wgmma3()), D.ptr(qw.s_w), D.ptr(qw.bias),
        D.ptr(y), B, C, H, W, qw.c_out, _IN_TYPES[x.dtype],
        0 if out_scale is not None else 2, bn, mi, tw, s, inv_s, inv_out,
        K_conv._ACTS[act], D.stream_handle(x))
    D.check_launch("conv3x3_cmajor_q8", err)
    LAUNCHES["conv3x3_cmajor_q8"] += 1
    return y


def conv1x1_cmajor_q8_plain(xs, qw: QConv, s_in: float,
                            act: str | None = "silu",
                            out_scale: float | None = None) -> torch.Tensor:
    """conv1x1(concat(xs, 1)): sections (B, C_s, H, W), int8 at ``s_in`` or
    float quantized at ``s_in`` -> (B, O, H, W) bfloat16 or int8."""
    xs = _sections(xs)
    return _plain_q8(torch.cat(xs, 1) if len(xs) > 1 else xs[0], qw, s_in,
                     act, out_scale)


def conv1x1_cmajor_q8(xs, qw: QConv, s_in: float, act: str | None = "silu",
                      out_scale: float | None = None) -> torch.Tensor:
    """K14. CPU tensors take ``conv1x1_cmajor_q8_plain``. The sections are of
    one dtype."""
    xs = _sections(xs)
    if xs[0].device.type == "cpu":
        return conv1x1_cmajor_q8_plain(xs, qw, s_in, act, out_scale)
    _check_q8("conv1x1_cmajor_q8", xs, qw, act)
    if qw.k != 1 or not 1 <= len(xs) <= 3:
        raise ValueError(f"conv1x1_cmajor_q8: {len(xs)} sections, weights "
                         f"{qw.k}x{qw.k}")
    B, _, H, W = xs[0].shape
    cs = [t.shape[1] for t in xs]
    y = torch.empty((B, qw.c_out, H, W), device=xs[0].device,
                    dtype=torch.bfloat16 if out_scale is None else torch.int8)
    s, inv_s, inv_out = K_conv._scales(s_in, out_scale)
    ptrs = [D.ptr(t) for t in xs] + [None] * (3 - len(xs))
    cs3 = cs + [0] * (3 - len(cs))
    err = _lib_q8().conv1x1_cmajor_q8(
        *ptrs, *cs3, D.ptr(qw.packed_cm()), D.ptr(qw.s_w), D.ptr(qw.bias),
        D.ptr(y), B, H * W, qw.c_out, _IN_TYPES[xs[0].dtype],
        0 if out_scale is not None else 2, s, inv_s, inv_out,
        K_conv._ACTS[act], D.stream_handle(xs[0]))
    D.check_launch("conv1x1_cmajor_q8", err)
    LAUNCHES["conv1x1_cmajor_q8"] += 1
    return y
