"""Int8 3x3 and 1x1 convolutions: CUDA kernels + plain versions.

Replaces ``rep_yolo_tpu/ops/pallas/conv_flat.py``: ``conv3x3_flat_q8`` (K4
``conv3x3_q8``, which also computes the stem's stride-2 conv that the TPU
kernel reached by space-to-depth) and ``conv1x1_flat_q8`` (K5
``conv1x1_q8``: 1-3 input sections, optional fused 2x2/s2 max pool).
Source: ``csrc/conv_flat.cu``.

Activations are channels-last, ``(B, H, W, C)``: int8 at a calibrated
per-tensor scale (C a multiple of 4), or float32 quantized inside K4 at
``s_in``. Weights are a ``QConv``, quantized once. The output is int8 at
``out_scale`` or, without one, float32 (the JAX kernels emit bf16 there).
The wrappers take the plain versions for CPU tensors only; on a CUDA
tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from rep_yolo_tpu_torch import device as D
from rep_yolo_tpu_torch.ops.quant import (epilogue, quantize,
                                          quantize_weights, requant)

LAUNCHES = {"conv3x3_q8": 0, "conv1x1_q8": 0}
_TO = 32            # output channels per block of the kernels
_ACTS = {"silu": 1, None: 0}


def _lib():
    lib = D.load_kernel("conv_flat")
    if not getattr(lib, "_typed", False):
        vp, i32, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.conv3x3_q8.argtypes = [vp] * 5 + [i32] * 10 + [f] * 3 + [i32, vp]
        lib.conv3x3_q8.restype = i32
        lib.conv1x1_q8.argtypes = [vp] * 3 + [i32] * 4 + [vp] * 4 \
            + [i32] * 7 + [f] * 2 + [i32, vp]
        lib.conv1x1_q8.restype = i32
        lib._typed = True
    return lib


def fold_weight(weight: torch.Tensor, in_scale: torch.Tensor | None = None,
                perm: torch.Tensor | None = None) -> torch.Tensor:
    """Fold an int8 input's per-channel scales and pending channel
    permutation into float (O, C, k, k) weights (port of ``neck_flat._fold``):
    logical input channel c lives at physical channel ``perm[c]``, and
    ``in_scale`` is in physical order, so the conv runs at s_in = 1 on the
    raw physical data."""
    w = weight.detach().float()
    if perm is not None:
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(len(perm), device=perm.device)
        w = w[:, inv.to(w.device)]
    if in_scale is not None:
        w = w * in_scale.to(w.device)[None, :, None, None]
    return w


class QConv:
    """One conv's weights, quantized once when the int8 plan is built.

    ``w_q`` (O, k, k, Cp) int8, per output channel at ``s_w`` (O,) f32, with
    the input channels zero-padded to Cp, a multiple of 4 (exact); ``bias``
    (O,) f32. ``in_scale`` (C,) and ``perm`` (C,) fold an int8 input's
    per-channel scales (the concat's section scales) and pending channel
    permutation (GSConv's shuffle) into the float weights before they are
    quantized (``fold_weight``). The kernels' packed copy is made at the
    first launch and kept."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor | None,
                 in_scale: torch.Tensor | None = None,
                 perm: torch.Tensor | None = None):
        w = fold_weight(weight, in_scale, perm)
        if bias is None:
            bias = torch.zeros(w.shape[0], device=w.device)
        w_q, self.s_w = quantize_weights(w)
        O, C, k, _ = w.shape
        cp = -(-C // 4) * 4
        self.w_q = torch.zeros((O, k, k, cp), dtype=torch.int8,
                               device=w.device)
        self.w_q[..., :C] = w_q.permute(0, 2, 3, 1)
        self.bias = bias.detach().float().contiguous()
        self.c_in, self.k = C, k
        self._packed: dict[int, torch.Tensor] = {}

    @property
    def c_out(self) -> int:
        return self.w_q.shape[0]

    def packed(self, kc: int) -> torch.Tensor:
        """int32 words [O/32][Cp/kc][k*k][kc/4][32] (O zero-padded to a
        multiple of 32): one contiguous block per (output block, chunk)."""
        if kc not in self._packed:
            O, k, _, cp = self.w_q.shape
            opad = -(-O // _TO) * _TO
            w = torch.zeros((opad, k * k, cp), dtype=torch.int8,
                            device=self.w_q.device)
            w[:O] = self.w_q.reshape(O, k * k, cp)
            words = w.view(torch.int32)                # (opad, k*k, cp/4)
            self._packed[kc] = words.reshape(
                opad // _TO, _TO, k * k, cp // kc, kc // 4).permute(
                    0, 3, 2, 4, 1).contiguous()
        return self._packed[kc]


def _chunk(channels) -> int:
    """Input channels per chunk: the largest multiple of 4, at most 64,
    that divides every section."""
    g = 0
    for c in channels:
        g = math.gcd(g, int(c))
    for kc in range(64, 0, -4):
        if g % kc == 0:
            return kc
    raise ValueError(f"channels {list(channels)} are not multiples of 4")


def _scales(s_in: float, out_scale: float | None):
    return (float(s_in), 1.0 / float(s_in),
            0.0 if out_scale is None else 1.0 / float(out_scale))


def _check_cuda(name: str, ts, qw: QConv) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device != dev or t.dim() != 4:
            raise ValueError(f"{name}: expected 4-d CUDA tensors on one "
                             f"device, got {t.device} {tuple(t.shape)}")
    for t in (qw.w_q, qw.s_w, qw.bias):
        if t.device != dev:
            raise ValueError(f"{name}: weights on {t.device}, input on {dev}")


# ---------------------------------------------------------------------------
# K4: 3x3
# ---------------------------------------------------------------------------

def conv3x3_q8_plain(x: torch.Tensor, qw: QConv, s_in: float,
                     stride: int = 1, act: str | None = "silu",
                     out_scale: float | None = None) -> torch.Tensor:
    """x (B, H, W, C) int8 at ``s_in`` or float -> (B, Ho, Wo, O), pad 1.
    The s32 sums are exact (float64 products of int8 values)."""
    xq = x if x.dtype == torch.int8 else quantize(x, s_in)
    C = xq.shape[-1]
    w = qw.w_q[..., :C].permute(0, 3, 1, 2).double()
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), w, stride=stride,
                   padding=1)
    y = epilogue(acc.permute(0, 2, 3, 1), qw.s_w, qw.bias, s_in, act)
    return requant(y, out_scale).contiguous()


def conv3x3_q8(x: torch.Tensor, qw: QConv, s_in: float, stride: int = 1,
               act: str | None = "silu",
               out_scale: float | None = None) -> torch.Tensor:
    """K4. CPU tensors take ``conv3x3_q8_plain``."""
    if x.device.type == "cpu":
        return conv3x3_q8_plain(x, qw, s_in, stride, act, out_scale)
    _check_cuda("conv3x3_q8", [x], qw)
    B, H, W, C = x.shape
    cp = qw.w_q.shape[-1]
    if qw.k != 3 or stride not in (1, 2) or act not in _ACTS:
        raise ValueError(f"conv3x3_q8: k={qw.k} stride={stride} act={act}")
    if x.dtype == torch.int8:
        if C != cp:
            raise ValueError(f"conv3x3_q8: int8 input has {C} channels, "
                             f"the weights {cp} (a multiple of 4)")
    elif x.dtype != torch.float32 or C != qw.c_in:
        raise ValueError(f"conv3x3_q8: expected int8 or float32 input with "
                         f"{qw.c_in} channels, got {x.dtype} {C}")
    x = x.contiguous()
    kc = _chunk([cp])
    ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    O = qw.c_out
    y = torch.empty((B, ho, wo, O), device=x.device,
                    dtype=torch.float32 if out_scale is None else torch.int8)
    s, inv_s, inv_out = _scales(s_in, out_scale)
    err = _lib().conv3x3_q8(
        D.ptr(x), D.ptr(qw.packed(kc)), D.ptr(qw.s_w), D.ptr(qw.bias),
        D.ptr(y), B, H, W, C, cp, kc, stride, O,
        int(x.dtype == torch.float32), int(out_scale is None), s, inv_s,
        inv_out, _ACTS[act], D.stream_handle(x))
    D.check_launch("conv3x3_q8", err)
    LAUNCHES["conv3x3_q8"] += 1
    return y


# ---------------------------------------------------------------------------
# K5: 1x1 over sections, optional 2x2/s2 max pool
# ---------------------------------------------------------------------------

def _pool2(y: torch.Tensor) -> torch.Tensor:
    B, H, W, C = y.shape
    return y.reshape(B, H // 2, 2, W // 2, 2, C).amax((2, 4))


def conv1x1_q8_plain(xs, qw: QConv, s_in: float, act: str | None = "silu",
                     out_scale: float | None = None,
                     pool: bool = False) -> torch.Tensor:
    """conv1x1(concat(xs, -1)) for int8 sections (B, H, W, C_s) at
    ``s_in`` (a section's own scale folded into ``qw``), then requant, then
    (``pool``) the 2x2/s2 max pool."""
    xs = list(xs) if isinstance(xs, (list, tuple)) else [xs]
    x = torch.cat(xs, -1) if len(xs) > 1 else xs[0]
    if x.dtype != torch.int8:
        x = quantize(x, s_in)
    w = qw.w_q.reshape(qw.c_out, -1)[:, :x.shape[-1]]
    acc = torch.matmul(x.double(), w.double().t())
    y = requant(epilogue(acc, qw.s_w, qw.bias, s_in, act), out_scale)
    return (_pool2(y) if pool else y).contiguous()


def conv1x1_q8(xs, qw: QConv, s_in: float, act: str | None = "silu",
               out_scale: float | None = None,
               pool: bool = False) -> torch.Tensor:
    """K5. CPU tensors take ``conv1x1_q8_plain``."""
    xs = list(xs) if isinstance(xs, (list, tuple)) else [xs]
    if xs[0].device.type == "cpu":
        return conv1x1_q8_plain(xs, qw, s_in, act, out_scale, pool)
    _check_cuda("conv1x1_q8", xs, qw)
    B, H, W, _ = xs[0].shape
    cs = [t.shape[-1] for t in xs]
    if not 1 <= len(xs) <= 3 or qw.k != 1 or act not in _ACTS:
        raise ValueError(f"conv1x1_q8: {len(xs)} sections, k={qw.k}, "
                         f"act={act}")
    if any(t.dtype != torch.int8 or t.shape[:3] != (B, H, W) for t in xs) \
            or any(c % 4 for c in cs) or sum(cs) != qw.w_q.shape[-1]:
        raise ValueError(f"conv1x1_q8: expected int8 sections (B, H, W, C) "
                         f"with C multiples of 4 summing to "
                         f"{qw.w_q.shape[-1]}, got "
                         f"{[(t.dtype, tuple(t.shape)) for t in xs]}")
    if pool and (H % 2 or W % 2):
        raise ValueError(f"conv1x1_q8: pool needs even H, W, got {H}x{W}")
    xs = [t.contiguous() for t in xs]
    kc = _chunk(cs)
    O = qw.c_out
    shape = (B, H // 2, W // 2, O) if pool else (B, H, W, O)
    y = torch.empty(shape, device=xs[0].device,
                    dtype=torch.float32 if out_scale is None else torch.int8)
    s, _, inv_out = _scales(s_in, out_scale)
    ptrs = [D.ptr(t) for t in xs] + [None] * (3 - len(xs))
    cs3 = cs + [0] * (3 - len(cs))
    err = _lib().conv1x1_q8(
        *ptrs, *cs3, len(xs), D.ptr(qw.packed(kc)), D.ptr(qw.s_w),
        D.ptr(qw.bias), D.ptr(y), B, H, W, kc, O, int(pool),
        int(out_scale is None), s, inv_out, _ACTS[act],
        D.stream_handle(xs[0]))
    D.check_launch("conv1x1_q8", err)
    LAUNCHES["conv1x1_q8"] += 1
    return y
