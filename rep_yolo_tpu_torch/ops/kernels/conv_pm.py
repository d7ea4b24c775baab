"""Pixel-major int8 3x3 and 1x1 convolutions on K4 / K5, and their plain
versions.

Replaces ``rep_yolo_tpu/ops/pallas/conv_pm.py``: ``conv3x3_pm_q8`` (a 3x3
stride-1 SAME conv) and ``conv1x1_pm_q8`` (a 1x1 over a list of 1-3
sections), each on an input quantized at ``s_in`` or arriving int8, with s32
sums, ``acc * (s_w * s_in) + bias``, SiLU, ReLU or no activation, and a
bfloat16 output or int8 at ``out_scale``. They run the DER blocks'
``"xla_q8"`` deploy path (``DERBlock.forward_xla_q8``), whose convs are
exactly this math.

Pixel-major ``(B, H*W, C)`` is NHWC's memory image, which is the layout of
K4 ``conv3x3_q8`` and K5 ``conv1x1_q8`` (``csrc/conv_flat.cu``). So these
rows get no third copy of the same sum: the wrappers view the maps as
(B, H, W, C) and call K4 / K5, which carry the contract's ReLU, bfloat16
store and (K5) float input. A bfloat16 input is widened to float32 first,
which is exact. Every call here launches K4 or K5 once: ``LAUNCHES`` counts
these calls, and K4's and K5's own counters move with them.
"""

from __future__ import annotations

import torch

from rep_yolo_tpu_torch.ops.kernels import conv_flat as K_conv
from rep_yolo_tpu_torch.ops.kernels.conv_flat import QConv

LAUNCHES = {"conv3x3_pm_q8": 0, "conv1x1_pm_q8": 0}


def _sections(xs) -> list[torch.Tensor]:
    return list(xs) if isinstance(xs, (list, tuple)) else [xs]


def _widen(x: torch.Tensor) -> torch.Tensor:
    return x.float() if x.dtype == torch.bfloat16 else x


def conv3x3_pm_q8_plain(x: torch.Tensor, qw: QConv, s_in: float, H: int,
                        W: int, act: str | None = "silu",
                        out_scale: float | None = None) -> torch.Tensor:
    """x (B, H*W, C) int8 at ``s_in`` or float -> (B, H*W, O) bfloat16, or
    int8 at ``out_scale``."""
    B, HW, C = x.shape
    y = K_conv.conv3x3_q8_plain(_widen(x).reshape(B, H, W, C), qw, s_in, 1,
                                act, out_scale, torch.bfloat16)
    return y.reshape(B, HW, -1)


def conv3x3_pm_q8(x: torch.Tensor, qw: QConv, s_in: float, H: int, W: int,
                  act: str | None = "silu",
                  out_scale: float | None = None) -> torch.Tensor:
    """Row 11 on K4. CPU tensors take ``conv3x3_pm_q8_plain``."""
    if x.device.type == "cpu":
        return conv3x3_pm_q8_plain(x, qw, s_in, H, W, act, out_scale)
    if x.dim() != 3 or x.shape[1] != H * W:
        raise ValueError(f"conv3x3_pm_q8: expected (B, {H}*{W}, C), got "
                         f"{tuple(x.shape)}")
    B, HW, C = x.shape
    y = K_conv.conv3x3_q8(_widen(x).reshape(B, H, W, C), qw, s_in, 1, act,
                          out_scale, torch.bfloat16)
    LAUNCHES["conv3x3_pm_q8"] += 1
    return y.reshape(B, HW, -1)


def conv1x1_pm_q8_plain(xs, qw: QConv, s_in: float, act: str | None = "silu",
                        out_scale: float | None = None) -> torch.Tensor:
    """conv1x1(concat(xs, -1)) of sections (B, H*W, C_s), int8 at ``s_in``
    (a section's own scale folded into ``qw``) or float quantized at
    ``s_in`` -> (B, H*W, O) bfloat16 or int8. One weight scale per output
    channel across all sections."""
    xs = [_widen(t) for t in _sections(xs)]
    B, HW, _ = xs[0].shape
    y = K_conv.conv1x1_q8_plain([t.reshape(B, HW, 1, -1) for t in xs], qw,
                                s_in, act, out_scale, False, torch.bfloat16)
    return y.reshape(B, HW, -1)


def conv1x1_pm_q8(xs, qw: QConv, s_in: float, act: str | None = "silu",
                  out_scale: float | None = None) -> torch.Tensor:
    """Row 12 on K5. CPU tensors take ``conv1x1_pm_q8_plain``."""
    xs = [_widen(t) for t in _sections(xs)]
    if xs[0].device.type == "cpu":
        return conv1x1_pm_q8_plain(xs, qw, s_in, act, out_scale)
    if any(t.dim() != 3 for t in xs):
        raise ValueError(f"conv1x1_pm_q8: expected (B, H*W, C) sections, got "
                         f"{[tuple(t.shape) for t in xs]}")
    B, HW, _ = xs[0].shape
    y = K_conv.conv1x1_q8([t.reshape(B, HW, 1, t.shape[-1]) for t in xs],
                          qw, s_in, act, out_scale, False, torch.bfloat16)
    LAUNCHES["conv1x1_pm_q8"] += 1
    return y.reshape(B, HW, -1)
