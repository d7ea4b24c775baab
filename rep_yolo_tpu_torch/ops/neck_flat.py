"""The int8 region's maps and the dispatch of a conv on them.

Port of the framework side of ``rep_yolo_tpu/ops/pallas/neck_flat.py``
(``FlatT`` and its helpers, ``_fold``, ``flat_conv``, ``upsample2x_flat``,
``gs_shuffle_flat``). A region map is a ``Q8Map``: channels-last int8 data
at a scale that is one float or a per-channel vector (a concat of sections
quantized at different scales), with an optional pending channel
permutation (GSConv's shuffle, which moves no bytes: its consumers fold it
into their weight rows). An unmaterialized concat is a list of them, which
the 1x1 kernel reads as accumulating sections.

Weights are folded and quantized once per plan: the fold needs the input
map's scales and permutation, which the plan fixes and the plan's first
forward carries, so ``quantized`` builds them then and keeps them in the
layer's cache.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from rep_yolo_tpu_torch.ops.kernels import conv_flat as K_conv
from rep_yolo_tpu_torch.ops.kernels import neck_flat as K_neck
from rep_yolo_tpu_torch.ops.quant import f32, quantize


@dataclasses.dataclass
class Q8Map:
    """``data`` (B, H, W, C) int8; ``scale`` a float or a (C,) float32
    vector in ``data``'s channel order; ``perm`` (C,) int64 or None: logical
    channel c lives at ``data[..., perm[c]]``."""

    data: torch.Tensor
    scale: float | torch.Tensor
    perm: torch.Tensor | None = None

    @property
    def c(self) -> int:
        return self.data.shape[-1]

    def scale_vec(self) -> torch.Tensor:
        if isinstance(self.scale, torch.Tensor):
            return self.scale
        return torch.full((self.c,), float(self.scale), dtype=torch.float32,
                          device=self.data.device)

    def to_float(self) -> torch.Tensor:
        """Dequantized float32 NCHW in logical channel order, for a consumer
        outside the region (``flat_to_nhwc``; the only place the shuffle
        moves bytes)."""
        if isinstance(self.scale, torch.Tensor):
            y = self.data.float() * self.scale.to(self.data.device)
        else:
            y = self.data.float() * f32(self.scale).to(self.data.device)
        if self.perm is not None:
            y = y[..., self.perm.to(y.device)]
        return y.permute(0, 3, 1, 2).contiguous()


def is_flat(x) -> bool:
    """A Q8Map, or a non-empty list of them (an unmaterialized concat)."""
    if isinstance(x, Q8Map):
        return True
    return (isinstance(x, (list, tuple)) and len(x) > 0
            and all(isinstance(t, Q8Map) for t in x))


def flat_hw(x) -> tuple[int, int]:
    t = x if isinstance(x, Q8Map) else x[0]
    return t.data.shape[1], t.data.shape[2]


def quantize_to_flat(x: torch.Tensor, s: float) -> Q8Map:
    """Float NCHW -> region entry at scale s (quantized before the
    transpose, which then moves a quarter of the bytes)."""
    return Q8Map(quantize(x, s).permute(0, 2, 3, 1).contiguous(), float(s))


def flat_to_float(x) -> torch.Tensor:
    """A Q8Map or an unmaterialized concat -> float32 NCHW."""
    if isinstance(x, (list, tuple)):
        return torch.cat([t.to_float() for t in x], 1)
    return x.to_float()


def quantize_flat(y: torch.Tensor, s: float) -> Q8Map:
    """Float (B, H, W, C) -> Q8Map at s (``quantize_flat_bf16``: re-entry
    after a float elementwise island, GSBottleneck's residual add)."""
    return Q8Map(quantize(y, s), float(s))


def materialize_perm(t: Q8Map) -> Q8Map:
    """Apply a pending permutation to the bytes."""
    if t.perm is None:
        return t
    p = t.perm.to(t.data.device)
    return Q8Map(t.data[..., p].contiguous(), t.scale_vec()[p])


def gs_shuffle_perm(c2: int, device=None) -> torch.Tensor:
    """GSConv's channel shuffle (even channels of the concat, then odd) as
    a logical -> physical permutation."""
    return torch.cat([torch.arange(0, c2, 2), torch.arange(1, c2, 2)]).to(
        device)


def upsample2x(t: Q8Map) -> Q8Map:
    """Nearest 2x upsample of the int8 data, same scale and permutation."""
    B, H, W, C = t.data.shape
    d = t.data[:, :, None, :, None, :].expand(B, H, 2, W, 2, C)
    return Q8Map(d.reshape(B, 2 * H, 2 * W, C), t.scale, t.perm)


def fold_meta(x) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(per-channel scales in physical order, logical -> physical
    permutation or None) of a Q8Map or of a concat of them, whose sections
    keep their own channels: ``_fold`` of each section's weight rows."""
    ts = x if isinstance(x, (list, tuple)) else [x]
    sv = torch.cat([t.scale_vec().to(ts[0].data.device) for t in ts])
    if all(t.perm is None for t in ts):
        return sv, None
    perms, off = [], 0
    for t in ts:
        p = (torch.arange(t.c) if t.perm is None else t.perm.cpu()) + off
        perms.append(p)
        off += t.c
    return sv, torch.cat(perms)


def is_dw5(conv: nn.Conv2d) -> bool:
    """GSConv's depthwise 5x5 (K7, or K12 with ``conv.dw5_dense`` False,
    which ``DetectionNet.set_q8`` sets from ``Q8Region.dw5_dense``)."""
    return (conv.groups == conv.in_channels == conv.out_channels
            and conv.kernel_size == (5, 5))


def quantized(cache: dict, name: str, conv: nn.Conv2d, x):
    """``conv``'s weights with ``x``'s scales and permutation folded in,
    quantized at the plan's first forward and kept in ``cache``. A
    depthwise 5x5 gets K7's per-channel int8 weights, or with
    ``conv.dw5_dense`` False K12's float32 ones (the JAX
    ``set_dw5_dense``)."""
    qw = cache.get(name)
    if qw is None:
        sv, perm = fold_meta(x)
        if conv.groups == 1:
            qw = K_conv.QConv(conv.weight, conv.bias, sv, perm)
        elif is_dw5(conv):
            # the depthwise input is GSConv's own cv1 output: no shuffle
            if perm is not None:
                raise ValueError(f"{name}: depthwise input with a pending "
                                 "channel permutation")
            qw = (K_neck.QDepthwise(conv.weight, conv.bias, sv)
                  if getattr(conv, "dw5_dense", True) else
                  K_neck.QDepthwiseF32(conv.weight, conv.bias, sv))
        else:
            raise ValueError(f"{name}: no int8 kernel for groups="
                             f"{conv.groups}, k={conv.kernel_size}")
        cache[name] = qw
    return qw


def flat_conv(x, conv: nn.Conv2d, cache: dict, name: str, act: str | None,
              out_scale: float | None):
    """A deploy conv on int8 input (``neck_flat.flat_conv``): a concat or a
    1x1 -> K5, a 3x3 at stride 1 or 2 -> K4, the depthwise 5x5 -> K7 (or
    K12), all at s_in = 1 on the folded weights. Returns a Q8Map at ``out_scale``, or
    float32 (B, H', W', O) without one."""
    qw = quantized(cache, name, conv, x)
    k, s = conv.kernel_size[0], conv.stride[0]
    if isinstance(x, (list, tuple)) or k == 1:
        if k != 1 or s != 1:
            raise ValueError(f"{name}: a concat input needs a 1x1 conv")
        xs = [t.data for t in x] if isinstance(x, (list, tuple)) else [x.data]
        y = K_conv.conv1x1_q8(xs, qw, 1.0, act, out_scale)
    elif isinstance(qw, K_neck.QDepthwise):
        y = K_neck.dwconv5x5_q8(x.data, qw, 1.0, act, out_scale)
    elif isinstance(qw, K_neck.QDepthwiseF32):
        y = K_neck.dwconv5x5_f32w_q8(x.data, qw, act, out_scale)
    elif k == 3 and s in (1, 2) and conv.padding == (1, 1):
        y = K_conv.conv3x3_q8(x.data, qw, 1.0, s, act, out_scale)
    else:
        raise ValueError(f"{name}: no int8 kernel for k={k} s={s}")
    return y if out_scale is None else Q8Map(y, float(out_scale))
