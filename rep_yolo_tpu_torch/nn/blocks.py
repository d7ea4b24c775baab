"""The Rep-YOLO block set in PyTorch: train-form parameter holders and
deploy-form forwards.

Port of the flagship's blocks in ``rep_yolo_tpu/nn/blocks.py``. Every
module is named after the reference torch keys (``cv1.conv.weight``,
``stage1.0.rbr_conv.0.bn.running_mean``, ``m.query_conv.conv.weight``,
...), so a reference state dict loads with ``load_state_dict``. With
``deploy=False`` a block only holds the unfused parameters; ``nn.fuse``
turns them into the ``deploy=True`` block's state, and only deploy blocks
run forward. Activations inside the network are NCHW tensors; the
attention blocks hand their kernels NHWC views.

Reference quirks kept as they are: CA returns the pooled (B,C,1,1)
tensor; q and k share one BN; VerticalAttention uses raw energies; the
centre pixel counts in both criss-cross branches.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from rep_yolo_tpu_torch.ops.kernels import axial_attention as K_axial

BN_EPS = 1e-3


def autopad(k: int, p: int | None = None) -> int:
    return k // 2 if p is None else p


def _act(name: str | None, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name is None:
        return x
    raise ValueError(f"unknown activation {name!r}")


class BN(nn.Module):
    """Reference ``BatchNorm2d`` state (weight, bias, running stats). Only
    the train form holds it: ``nn.fuse`` folds every BN into a conv or into
    the attention blocks' packed constants."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))


def _conv(c1, c2, k, s, p, g=1, bias=False) -> nn.Conv2d:
    return nn.Conv2d(c1, c2, k, s, p, groups=g, bias=bias)


class ConvBnAct(nn.Module):
    """Reference ``Conv``: conv + BN + act; deploy: one biased conv + act."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, act="silu",
                 deploy=False):
        super().__init__()
        self.act = act
        self.conv = _conv(c1, c2, k, s, autopad(k, p), g, bias=deploy)
        if not deploy:
            self.bn = BN(c2)

    def forward(self, x):
        return _act(self.act, self.conv(x))


class MP(nn.Module):
    def forward(self, x):
        return F.max_pool2d(x, 2, 2)


class Upsample(nn.Module):
    def forward(self, x):
        return F.interpolate(x, scale_factor=2, mode="nearest")


class Concat(nn.Module):
    def forward(self, xs):
        return torch.cat(xs, 1)


class Add(nn.Module):
    """ADD; broadcasts CA's pooled (B,C,1,1) output."""

    def forward(self, xs):
        return xs[0] + xs[1]


class RepSBlock(nn.Module):
    """MobileOne-style block (reference models/common.py:3374-3434)."""

    def __init__(self, c1, c2, k=3, s=1, p=1, num_conv_branches=1,
                 deploy=False):
        super().__init__()
        if deploy:
            self.reparam_conv = _conv(c1, c2, k, s, p, bias=True)
            return
        if c1 == c2 and s == 1:
            self.rbr_skip = BN(c1)
        if k > 1:
            self.rbr_scale = ConvBnAct(c1, c2, 1, s, 0, act=None)
        self.rbr_conv = nn.ModuleList(
            ConvBnAct(c1, c2, k, s, p, act=None)
            for _ in range(num_conv_branches))

    def forward(self, x):
        return F.silu(self.reparam_conv(x))


class DERBlock(nn.Module):
    """Three full-width RepS stages, three half-width stages between 1x1
    convs, concat [stage1, mid1, mid3] -> 1x1 (reference
    models/common.py:3644-3654; dropout is identity at inference)."""

    def __init__(self, c1, c2, num_blocks_per_stage=1, num_conv_branches=1,
                 deploy=False):
        super().__init__()
        half = c1 // 2

        def stage(ch):
            return nn.ModuleList(
                [RepSBlock(ch, ch, 3, 1, 1, num_conv_branches, deploy)])

        for i in (1, 2, 3):
            setattr(self, f"stage{i}", stage(c1))
        for i in (4, 5, 6):
            setattr(self, f"stage{i}", stage(half))
        for i in range(3):
            setattr(self, f"cv{i}_1", ConvBnAct(c1, half, deploy=deploy))
            setattr(self, f"cv{i}_2", ConvBnAct(half, c1, deploy=deploy))
        self.cv1 = ConvBnAct(3 * c1, c2, deploy=deploy)

    def forward(self, x):
        x1 = self.stage1[0](x)
        x3 = self.stage3[0](self.stage2[0](x1))
        x4_1 = self.cv0_2(self.stage4[0](self.cv0_1(x3)))
        x4_2 = self.cv1_2(self.stage5[0](self.cv1_1(x4_1)))
        x4_3 = self.cv2_2(self.stage6[0](self.cv2_1(x4_2)))
        return self.cv1(torch.cat([x1, x4_1, x4_3], 1))


class SPPCSPC(nn.Module):
    """CSP spatial pyramid pooling, k = 5, 9, 13 (reference
    models/common.py:270-290)."""

    def __init__(self, c1, c2, n=1, e=0.5, k=(5, 9, 13), deploy=False):
        super().__init__()
        c_ = int(2 * c2 * e)
        self.k = k
        self.cv1 = ConvBnAct(c1, c_, deploy=deploy)
        self.cv2 = ConvBnAct(c1, c_, deploy=deploy)
        self.cv3 = ConvBnAct(c_, c_, 3, deploy=deploy)
        self.cv4 = ConvBnAct(c_, c_, deploy=deploy)
        self.cv5 = ConvBnAct((len(k) + 1) * c_, c_, deploy=deploy)
        self.cv6 = ConvBnAct(c_, c_, 3, deploy=deploy)
        self.cv7 = ConvBnAct(2 * c_, c2, deploy=deploy)

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        pooled = [x1] + [F.max_pool2d(x1, k, 1, k // 2) for k in self.k]
        y1 = self.cv6(self.cv5(torch.cat(pooled, 1)))
        return self.cv7(torch.cat([y1, self.cv2(x)], 1))


class GSConv(nn.Module):
    """Half-width conv + 5x5 depthwise conv, concat, channel shuffle (even
    channels, then odd; reference models/common.py:3807-3825)."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, act="silu",
                 deploy=False):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = ConvBnAct(c1, c_, k, s, p, g, act, deploy)
        self.cv2 = ConvBnAct(c_, c_, 5, 1, p, c_, act, deploy)

    def forward(self, x):
        x1 = self.cv1(x)
        y = torch.cat([x1, self.cv2(x1)], 1)
        return torch.cat([y[:, 0::2], y[:, 1::2]], 1)


class GSBottleneck(nn.Module):
    """reference models/common.py:3827-3838."""

    def __init__(self, c1, c2, e=0.5, deploy=False):
        super().__init__()
        c_ = int(c2 * e)
        self.conv_lighting = nn.Sequential(
            GSConv(c1, c_, 1, 1, deploy=deploy),
            GSConv(c_, c2, 3, 1, act=None, deploy=deploy))
        self.shortcut = ConvBnAct(c1, c2, 1, 1, act=None, deploy=deploy)

    def forward(self, x):
        return self.conv_lighting(x) + self.shortcut(x)


class VoVGSCSP(nn.Module):
    """reference models/common.py:3846-3861 (its unused ``res`` conv is not
    built)."""

    def __init__(self, c1, c2, n=1, e=0.5, deploy=False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, deploy=deploy)
        self.cv2 = ConvBnAct(c1, c_, deploy=deploy)
        self.gsb = nn.Sequential(*(GSBottleneck(c_, c_, 1.0, deploy)
                                   for _ in range(n)))
        self.cv3 = ConvBnAct(2 * c_, c2, deploy=deploy)

    def forward(self, x):
        return self.cv3(torch.cat([self.cv2(x), self.gsb(self.cv1(x))], 1))


class CA(nn.Module):
    """Channel attention; returns ``pooled * sigmoid(h) + pooled`` of shape
    (B,C,1,1) (reference quirk, models/common.py:3788-3802)."""

    def __init__(self, c1, ratio=16):
        super().__init__()
        self.f1 = nn.Conv2d(c1, c1 // ratio, 1, bias=False)
        self.f2 = nn.Conv2d(c1 // ratio, c1, 1, bias=False)

    def forward(self, x):
        pooled = x.mean((2, 3), keepdim=True)
        h = self.f2(F.relu(self.f1(pooled)))
        return pooled * torch.sigmoid(h) + pooled


class AxialAttention(nn.Module):
    """CrissCrossAttention (``criss_cross=True``) or VerticalAttention.

    Projections: conv -> SiLU -> shared BN -> ReLU6 for q and k (one BN,
    ``bn``), depthwise conv -> SiLU -> ``bn1`` -> ReLU6 for v (reference
    models/common.py:3675-3779). The deploy block holds those constants
    packed as the kernels take them (``wqk`` (2*c8, C), ``pq`` (3, 2*c8),
    ``pv`` (4, C); packed by ``nn.fuse``) and runs the fused kernels."""

    def __init__(self, c1, criss_cross: bool, deploy=False):
        super().__init__()
        c8 = c1 // 8
        self.criss_cross = criss_cross
        if deploy:
            self.register_buffer("wqk", torch.zeros(2 * c8, c1))
            self.register_buffer("pq", torch.zeros(3, 2 * c8))
            self.register_buffer("pv", torch.zeros(4, c1))
        else:
            g8 = math.gcd(c1, c8)
            self.query_conv = ConvBnAct(c1, c8, 1, 1, g=g8)
            self.key_conv = ConvBnAct(c1, c8, 1, 1, g=g8)
            self.value_conv = ConvBnAct(c1, c1, 1, 1, g=c1)
            self.bn = BN(c8)
            self.bn1 = BN(c1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        y = K_axial.axial_attention(x.permute(0, 2, 3, 1), self.wqk, self.pq,
                                    self.pv, self.gamma, self.criss_cross)
        return y.permute(0, 3, 1, 2)


class CrissCrossAttention(AxialAttention):
    def __init__(self, c1, deploy=False):
        super().__init__(c1, True, deploy)


class VerticalAttention(AxialAttention):
    def __init__(self, c1, deploy=False):
        super().__init__(c1, False, deploy)


class CCVA(nn.Module):
    """C3 whose inner stacks are CrissCrossAttention + VerticalAttention
    (reference models/common.py:3781-3786)."""

    def __init__(self, c1, c2, e=0.5, deploy=False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, deploy=deploy)
        self.cv2 = ConvBnAct(c1, c_, deploy=deploy)
        self.cv3 = ConvBnAct(2 * c_, c2, deploy=deploy)
        self.m = CrissCrossAttention(c_, deploy)
        self.m1 = VerticalAttention(c_, deploy)

    def forward(self, x):
        h = self.m1(self.m(self.cv1(x)))
        return self.cv3(torch.cat([h, self.cv2(x)], 1))


class RepConv(nn.Module):
    """RepVGG block: 3x3+BN || 1x1+BN || BN identity, summed, SiLU
    (reference models/common.py:476-529); deploy: ``rbr_reparam``."""

    def __init__(self, c1, c2, k=3, s=1, g=1, act="silu", deploy=False):
        super().__init__()
        if k != 3:
            raise ValueError(f"RepConv supports k=3, got {k}")
        self.act = act
        if deploy:
            self.rbr_reparam = _conv(c1, c2, 3, s, 1, g, bias=True)
            return
        self.rbr_dense = nn.Sequential(_conv(c1, c2, 3, s, 1, g), BN(c2))
        self.rbr_1x1 = nn.Sequential(_conv(c1, c2, 1, s, 0, g), BN(c2))
        if c1 == c2 and s == 1:
            self.rbr_identity = BN(c1)

    def forward(self, x):
        return _act(self.act, self.rbr_reparam(x))


class Implicit(nn.Module):
    """ImplicitA / ImplicitM state: ``implicit`` (1, C, 1, 1)."""

    def __init__(self, c: int, value: float):
        super().__init__()
        self.implicit = nn.Parameter(torch.full((1, c, 1, 1), value))


class IDetect(nn.Module):
    """YOLOR detect head (reference models/yolo.py:93-133). Deploy: the
    implicit ia/im are folded into ``m`` by ``nn.fuse``. Returns raw maps
    (B, H, W, na, no) per level."""

    def __init__(self, nc, anchors, ch, deploy=False):
        super().__init__()
        self.nc, self.no = nc, nc + 5
        self.nl, self.na = len(anchors), len(anchors[0]) // 2
        self.m = nn.ModuleList(nn.Conv2d(c, self.no * self.na, 1)
                               for c in ch)
        if not deploy:
            self.ia = nn.ModuleList(Implicit(c, 0.0) for c in ch)
            self.im = nn.ModuleList(Implicit(self.no * self.na, 1.0)
                                    for _ in ch)

    def forward(self, xs):
        outs = []
        for conv, x in zip(self.m, xs):
            y = conv(x)
            b, _, h, w = y.shape
            outs.append(y.permute(0, 2, 3, 1).reshape(b, h, w, self.na,
                                                     self.no))
        return outs
