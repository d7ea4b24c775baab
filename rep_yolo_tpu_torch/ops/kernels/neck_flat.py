"""The int8 neck's depthwise 5x5 convs and SPP max pyramid: CUDA kernels +
plain versions.

Replace ``rep_yolo_tpu/ops/pallas/conv_flat.py:conv5x5_flat_q8`` as the neck
calls it (GSConv's depthwise 5x5, a block-diagonal dense 5x5 on the TPU: K7
``dwconv5x5_q8``), ``rep_yolo_tpu/ops/pallas/neck_flat.py:dwconv5x5_flat_q8``
(the exact-weight depthwise 5x5 of ``set_dw5_dense(False)``: K12
``dwconv5x5_f32w_q8``) and ``rep_yolo_tpu/ops/pallas/neck_flat.py:
spp_pools_flat`` (K8 ``spp_pools_q8``). Source: ``csrc/neck_flat.cu``.

Maps are channels-last int8 ``(B, H, W, C)``, C a multiple of 4 for K7 and
K8. The wrappers take the plain versions for CPU tensors only; on a CUDA
tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rep_yolo_tpu_torch import device as D
from rep_yolo_tpu_torch.ops.quant import epilogue, quantize_weights, requant

LAUNCHES = {"dwconv5x5_q8": 0, "dwconv5x5_f32w_q8": 0, "spp_pools_q8": 0}
_ACTS = {"silu": 1, None: 0}
SPP_K = (5, 9, 13)
_SMEM = 232448              # bytes of shared memory a block may use


def _lib():
    lib = D.load_kernel("neck_flat")
    if not getattr(lib, "_typed", False):
        vp, i32, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dwconv5x5_q8.argtypes = [vp] * 5 + [i32] * 5 + [f] * 2 + [i32, vp]
        lib.dwconv5x5_q8.restype = i32
        lib.dwconv5x5_f32w_q8.argtypes = [vp] * 4 + [i32] * 5 + [f, i32, vp]
        lib.dwconv5x5_f32w_q8.restype = i32
        lib.spp_pools_q8.argtypes = [vp, vp] + [i32] * 4 + [vp]
        lib.spp_pools_q8.restype = i32
        lib._typed = True
    return lib


class QDepthwise:
    """A depthwise 5x5 conv's weights, quantized once when the int8 plan is
    built: ``w_q`` (C, 25) int8 per output channel at ``s_w`` (C,) f32, after
    ``in_scale`` (C,) is folded into the float weights; ``bias`` (C,) f32.
    These are the block-diagonal dense kernel's values: its per-channel
    maximum runs over the diagonal and zeros."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor | None,
                 in_scale: torch.Tensor | None = None):
        C = weight.shape[0]
        if weight.shape[1:] != (1, 5, 5) or C % 4:
            raise ValueError(f"QDepthwise: expected (C, 1, 5, 5) weights with "
                             f"C % 4 == 0, got {tuple(weight.shape)}")
        w = weight.detach().float().reshape(C, 25)
        if in_scale is not None:
            w = w * in_scale.to(w.device)[:, None]
        self.w_q, self.s_w = quantize_weights(w)
        self.bias = (torch.zeros(C, device=w.device) if bias is None
                     else bias.detach().float().contiguous())
        # word (g, tap): channels 4g..4g+3 at that tap, as the kernel reads
        self.words = self.w_q.reshape(C // 4, 4, 25).permute(
            0, 2, 1).contiguous().view(torch.int32).reshape(C // 4, 25)

    @property
    def c(self) -> int:
        return self.w_q.shape[0]


def dwconv5x5_q8_plain(x: torch.Tensor, qd: QDepthwise, s_in: float = 1.0,
                       act: str | None = "silu",
                       out_scale: float | None = None) -> torch.Tensor:
    """x (B, H, W, C) int8 -> (B, H, W, C) int8 at ``out_scale`` or float32:
    depthwise 5x5, pad 2, the s32 sums exact (float64 products of int8)."""
    C = qd.c
    acc = F.conv2d(x.permute(0, 3, 1, 2).double(),
                   qd.w_q.reshape(C, 1, 5, 5).double(), padding=2, groups=C)
    y = epilogue(acc.permute(0, 2, 3, 1), qd.s_w, qd.bias, s_in, act)
    return requant(y, out_scale).contiguous()


def dwconv5x5_q8(x: torch.Tensor, qd: QDepthwise, s_in: float = 1.0,
                 act: str | None = "silu",
                 out_scale: float | None = None) -> torch.Tensor:
    """K7. CPU tensors take ``dwconv5x5_q8_plain``."""
    if x.device.type == "cpu":
        return dwconv5x5_q8_plain(x, qd, s_in, act, out_scale)
    if x.dtype != torch.int8 or x.dim() != 4 or x.shape[-1] != qd.c \
            or act not in _ACTS:
        raise ValueError(f"dwconv5x5_q8: expected int8 (B, H, W, {qd.c}), "
                         f"got {x.dtype} {tuple(x.shape)}, act={act}")
    if any(t.device != x.device for t in (qd.words, qd.s_w, qd.bias)):
        raise ValueError(f"dwconv5x5_q8: weights not on {x.device}")
    x = x.contiguous()
    B, H, W, C = x.shape
    y = torch.empty((B, H, W, C), device=x.device,
                    dtype=torch.float32 if out_scale is None else torch.int8)
    err = _lib().dwconv5x5_q8(
        D.ptr(x), D.ptr(qd.words), D.ptr(qd.s_w), D.ptr(qd.bias), D.ptr(y),
        B, H, W, C // 4, int(out_scale is None), float(s_in),
        0.0 if out_scale is None else 1.0 / float(out_scale), _ACTS[act],
        D.stream_handle(x))
    D.check_launch("dwconv5x5_q8", err)
    LAUNCHES["dwconv5x5_q8"] += 1
    return y


class QDepthwiseF32:
    """A depthwise 5x5 conv's weights for K12, made once when the int8 plan
    is built: ``w`` (25, C) float32, tap ``u * 5 + v``, the input's
    per-channel scale ``in_scale`` (C,) folded in (``kern * scale_vec``, as
    the JAX package folds it for ``dwconv5x5_flat_q8``); ``bias`` (C,)
    float32."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor | None,
                 in_scale: torch.Tensor | None = None):
        C = weight.shape[0]
        if weight.shape[1:] != (1, 5, 5):
            raise ValueError(f"QDepthwiseF32: expected (C, 1, 5, 5) weights, "
                             f"got {tuple(weight.shape)}")
        w = weight.detach().float().reshape(C, 25)
        if in_scale is not None:
            w = w * in_scale.to(w.device).float()[:, None]
        self.w = w.t().contiguous()
        self.bias = (torch.zeros(C, device=w.device) if bias is None
                     else bias.detach().float().contiguous())

    @property
    def c(self) -> int:
        return self.w.shape[1]


def dwconv5x5_f32w_q8_plain(x: torch.Tensor, qd: QDepthwiseF32,
                            act: str | None = "silu",
                            out_scale: float | None = None) -> torch.Tensor:
    """x (B, H, W, C) int8 -> (B, H, W, C) int8 at ``out_scale`` or float32:
    depthwise 5x5, pad 2, float32 products and sums in the JAX kernel's
    order (``_dw5_kernel``: each kernel row's five taps left to right, then
    the row added to the accumulator), then the bias and the activation."""
    B, H, W, C = x.shape
    xp = F.pad(x.float(), (0, 0, 2, 2, 2, 2))
    acc = None
    for u in range(5):
        row = None
        for v in range(5):
            t = xp[:, u:u + H, v:v + W, :] * qd.w[u * 5 + v]
            row = t if row is None else row + t
        acc = row if acc is None else acc + row
    y = acc + qd.bias
    if act == "silu":
        y = y * torch.sigmoid(y)
    elif act is not None:
        raise ValueError(f"unknown activation {act!r}")
    return requant(y, out_scale).contiguous()


def dwconv5x5_f32w_q8(x: torch.Tensor, qd: QDepthwiseF32,
                      act: str | None = "silu",
                      out_scale: float | None = None) -> torch.Tensor:
    """K12. CPU tensors take ``dwconv5x5_f32w_q8_plain``."""
    if x.device.type == "cpu":
        return dwconv5x5_f32w_q8_plain(x, qd, act, out_scale)
    if x.dtype != torch.int8 or x.dim() != 4 or x.shape[-1] != qd.c \
            or act not in _ACTS:
        raise ValueError(f"dwconv5x5_f32w_q8: expected int8 (B, H, W, "
                         f"{qd.c}), got {x.dtype} {tuple(x.shape)}, act={act}")
    if any(t.device != x.device for t in (qd.w, qd.bias)):
        raise ValueError(f"dwconv5x5_f32w_q8: weights not on {x.device}")
    x = x.contiguous()
    B, H, W, C = x.shape
    y = torch.empty((B, H, W, C), device=x.device,
                    dtype=torch.float32 if out_scale is None else torch.int8)
    err = _lib().dwconv5x5_f32w_q8(
        D.ptr(x), D.ptr(qd.w), D.ptr(qd.bias), D.ptr(y), B, H, W, C,
        int(out_scale is None),
        0.0 if out_scale is None else 1.0 / float(out_scale), _ACTS[act],
        D.stream_handle(x))
    D.check_launch("dwconv5x5_f32w_q8", err)
    LAUNCHES["dwconv5x5_f32w_q8"] += 1
    return y


def spp_pools_q8_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) int8 -> (B, H, W, 4C): [x, mp5, mp9, mp13], stride 1,
    pads -inf (max pools of the exact float copy)."""
    xf = x.permute(0, 3, 1, 2).float()
    pools = [F.max_pool2d(xf, k, 1, k // 2).to(x.dtype).permute(0, 2, 3, 1)
             for k in SPP_K]
    return torch.cat([x] + pools, -1).contiguous()


def spp_pools_q8(x: torch.Tensor) -> torch.Tensor:
    """K8. CPU tensors take ``spp_pools_q8_plain``."""
    if x.device.type == "cpu":
        return spp_pools_q8_plain(x)
    if x.dtype != torch.int8 or x.dim() != 4 or x.shape[-1] % 4:
        raise ValueError(f"spp_pools_q8: expected int8 (B, H, W, C), C % 4 "
                         f"== 0, got {x.dtype} {tuple(x.shape)}")
    B, H, W, C = x.shape
    vec = 16 if C % 16 == 0 else 4
    if 2 * H * W * vec > _SMEM:
        raise ValueError(f"spp_pools_q8: a {H}x{W} map does not fit a block's "
                         f"shared memory")
    x = x.contiguous()
    y = torch.empty((B, H, W, 4 * C), device=x.device, dtype=torch.int8)
    err = _lib().spp_pools_q8(D.ptr(x), D.ptr(y), B, H, W, C // 4,
                              D.stream_handle(x))
    D.check_launch("spp_pools_q8", err)
    LAUNCHES["spp_pools_q8"] += 1
    return y
