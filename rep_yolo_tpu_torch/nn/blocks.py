"""The Rep-YOLO block set in PyTorch: train-form and deploy-form forwards.

Port of the flagship's blocks in ``rep_yolo_tpu/nn/blocks.py``. Every
module is named after the reference torch keys (``cv1.conv.weight``,
``stage1.0.rbr_conv.0.bn.running_mean``, ``m.query_conv.conv.weight``,
...), so a reference state dict loads with ``load_state_dict``. A block
built with ``deploy=False`` holds the unfused train form and computes what
the JAX block computes with ``train=True`` under ``module.train()`` (batch
statistics, running averages updated, dropout) and with ``train=False``
under ``eval()``; ``nn.fuse`` turns its state into the ``deploy=True``
block's. Activations inside the network are NCHW tensors; the attention
blocks hand their kernels NHWC views.

Reference quirks kept as they are: CA returns the pooled (B,C,1,1)
tensor; q and k share one BN (in training its running statistics are
updated twice, q first); dropout in CrissCrossAttention falls on the row
attention only; VerticalAttention uses raw energies; the centre pixel
counts in both criss-cross branches.

The train form's 3x3 stride-1 pad-1 ungrouped bias-free convs go through
``conv``: the ones ``DetectionNet.set_wgrad`` routes (the JAX package's
``set_pallas_wgrad``) take their weight gradient from K9 (``wgrad3x3``).

The int8 region (``models/region.py``) runs the stem and the DER blocks
through the int8 kernels instead: ``RepSBlock.forward_stem_q8`` and
``DERBlock.forward_q8`` take and give channels-last (B, H, W, C) maps. The
neck's blocks and the head run there through ``forward_flat`` (port of the
JAX blocks' flat paths): int8 ``Q8Map`` in (or an unmaterialized concat of
them), a ``Q8Map`` at ``out_scale`` out, or float32 channels-last where
``out_scale`` is None (the region's exit). ``scale(key)`` gives the
calibrated input scale of the block's conv ``key`` (e.g. ``"cv2/conv"``),
``cache`` keeps the block's folded, quantized weights.

``DetectionNet.set_der_fast("bf16")`` runs the deploy DER blocks through
``DERBlock.forward_cm`` on the channel-major float kernels (K10, K11), NCHW
in the activation dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from rep_yolo_tpu_torch.ops import neck_flat as NF
from rep_yolo_tpu_torch.ops.kernels import axial_attention as K_axial
from rep_yolo_tpu_torch.ops.kernels import conv_flat as K_conv
from rep_yolo_tpu_torch.ops.kernels import conv_kernel as K_cm
from rep_yolo_tpu_torch.ops.kernels import neck_flat as K_neck
from rep_yolo_tpu_torch.ops.kernels import wgrad as K_wgrad
from rep_yolo_tpu_torch.ops.quant import f32

# The reference's BatchNorm hyperparameters in flax's terms: running average
# momentum 0.97 (torch momentum 0.03), eps 1e-3.
BN_MOMENTUM = 0.97
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
    """Reference ``BatchNorm2d`` state (weight, bias, running stats) with
    flax's ``nn.BatchNorm`` semantics (JAX ``BN``). Only the train form holds
    it: ``nn.fuse`` folds every BN into a conv or into the attention blocks'
    packed constants.

    Training normalizes with the batch mean and the biased batch variance,
    and moves the running averages by ``m * running + (1 - m) * batch`` with
    that same biased variance (``F.batch_norm`` would move ``running_var``
    with the unbiased one). ``eval()`` normalizes with the running
    statistics."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, BN_EPS)
        with torch.no_grad():
            var, mean = torch.var_mean(x, (0, 2, 3), correction=0)
            m = BN_MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            BN_EPS)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training, keep each element with probability
    ``1 - p`` and scale what is kept by ``1 / (1 - p)``. The masks come from
    ``generator`` (``DetectionNet.set_generator``; None: torch's default
    generator of the tensor's device)."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: torch.Generator | None = None

    def keep_mask(self, x: torch.Tensor) -> torch.Tensor:
        return torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        return torch.where(self.keep_mask(x), x / (1.0 - self.p),
                           torch.zeros((), dtype=x.dtype, device=x.device))


def _conv(c1, c2, k, s, p, g=1, bias=False) -> nn.Conv2d:
    return nn.Conv2d(c1, c2, k, s, p, groups=g, bias=bias)


def wgrad_eligible(m: nn.Module) -> bool:
    """A 3x3 stride-1 pad-1 ungrouped conv without bias: the convs the JAX
    ``ConvUnit`` can route to its wgrad kernel (``nn/blocks.py:466``)."""
    return (isinstance(m, nn.Conv2d) and m.kernel_size == (3, 3)
            and m.stride == (1, 1) and m.padding == (1, 1)
            and m.dilation == (1, 1) and m.groups == 1 and m.bias is None)


def wgrad_default_select(c1: int, c2: int) -> bool:
    """The JAX package's default select off the TPU (``c1 <= 64 and c2 <=
    64``, ``_wgrad_default_select``)."""
    return c1 <= 64 and c2 <= 64


def conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Run the train form's conv ``m``: a conv routed by
    ``DetectionNet.set_wgrad`` (attribute ``wgrad``) as ``Conv3x3WGrad``,
    whose weight gradient is K9; any other as itself."""
    if getattr(m, "wgrad", False):
        return K_wgrad.conv3x3_wgrad(x, m.weight)
    return m(x)


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
        y = conv(self.conv, x)
        if hasattr(self, "bn"):
            y = self.bn(y)
        return _act(self.act, y)

    def forward_flat(self, x, out_scale, scale=None, cache=None,
                     name="conv"):
        return NF.flat_conv(x, self.conv, cache, name, self.act, out_scale)


def _sub(scale, cache, prefix):
    """The scale lookup and weight cache of a sub-block."""
    return (lambda k: scale(f"{prefix}/{k}")), cache.setdefault(prefix, {})


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
        if hasattr(self, "reparam_conv"):
            return F.silu(self.reparam_conv(x))
        # the branches' BN outputs summed in the JAX order: skip, scale,
        # conv_0..N; N >= 2 identical branches run as one conv over the
        # output-concatenated kernels, as in the JAX train form (not routed)
        parts = []
        if hasattr(self, "rbr_skip"):
            parts.append(self.rbr_skip(x))
        if hasattr(self, "rbr_scale"):
            parts.append(self.rbr_scale(x))
        if len(self.rbr_conv) > 1:
            c = self.rbr_conv[0].conv
            y = F.conv2d(x, torch.cat([b.conv.weight for b in self.rbr_conv]),
                         None, c.stride, c.padding)
            n = c.out_channels
            parts += [b.bn(y[:, i * n:(i + 1) * n])
                      for i, b in enumerate(self.rbr_conv)]
        else:
            parts += [b(x) for b in self.rbr_conv]
        out = parts[0]
        for t in parts[1:]:
            out = out + t
        return F.silu(out)

    def q8_weights(self) -> K_conv.QConv:
        return K_conv.QConv(self.reparam_conv.weight, self.reparam_conv.bias)

    def forward_stem_q8(self, x: torch.Tensor, qw: K_conv.QConv,
                        s_in: float, out_scale: float) -> torch.Tensor:
        """The thin stride-2 stem straight into the int8 region (port of
        ``RepSBlock._stem_fast_q8``): x (B, H, W, c1) float -> (B, H/2,
        W/2, c2) int8 at ``out_scale``. The JAX package reached this conv by
        space-to-depth and a 2x2 kernel embedded in a 3x3, a TPU layout
        trick that adds only zero taps; K4 computes the stride-2 conv
        directly, with the same weight scales and s32 sums."""
        return K_conv.conv3x3_q8(x, qw, s_in, stride=2, act="silu",
                                 out_scale=out_scale)


# The 13 convs of a DER block in dataflow order: (name, module path, JAX
# scope suffix), and the conv whose input scale each int8 output is
# emitted at (nn/blocks.py DERBlock._fast_deploy of the JAX package).
DER_CONVS = (
    ("st1", "stage1.0.reparam_conv", "stage1/reparam_conv"),
    ("st2", "stage2.0.reparam_conv", "stage2/reparam_conv"),
    ("st3", "stage3.0.reparam_conv", "stage3/reparam_conv"),
    ("cv0_1", "cv0_1.conv", "cv0_1/conv"),
    ("st4", "stage4.0.reparam_conv", "stage4/reparam_conv"),
    ("cv0_2", "cv0_2.conv", "cv0_2/conv"),
    ("cv1_1", "cv1_1.conv", "cv1_1/conv"),
    ("st5", "stage5.0.reparam_conv", "stage5/reparam_conv"),
    ("cv1_2", "cv1_2.conv", "cv1_2/conv"),
    ("cv2_1", "cv2_1.conv", "cv2_1/conv"),
    ("st6", "stage6.0.reparam_conv", "stage6/reparam_conv"),
    ("cv2_2", "cv2_2.conv", "cv2_2/conv"),
    ("cv1", "cv1.conv", "cv1/conv"),
)
DER_NEXT = {"st1": "st2", "st2": "st3", "st3": "cv0_1", "cv0_1": "st4",
            "st4": "cv0_2", "cv0_2": "cv1_1", "cv1_1": "st5",
            "st5": "cv1_2", "cv1_2": "cv2_1", "cv2_1": "st6",
            "st6": "cv2_2", "cv2_2": "cv1"}


class DERBlock(nn.Module):
    """Three full-width RepS stages, three half-width stages between 1x1
    convs, concat [stage1, mid1, mid3] -> 1x1 (reference
    models/common.py:3644-3654); Dropout(0.2) after every stage, in stage
    order (identity at inference)."""

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
        self.dropout = Dropout(0.2)

    def forward(self, x):
        def stage(i, h):
            return self.dropout(getattr(self, f"stage{i}")[0](h))

        x1 = stage(1, x)
        x3 = stage(3, stage(2, x1))
        x4_1 = self.cv0_2(stage(4, self.cv0_1(x3)))
        x4_2 = self.cv1_2(stage(5, self.cv1_1(x4_1)))
        x4_3 = self.cv2_2(stage(6, self.cv2_1(x4_2)))
        return self.cv1(torch.cat([x1, x4_1, x4_3], 1))

    @staticmethod
    def q8_scales(scales, prefix: str) -> dict[str, float] | None:
        """The 13 convs' input scales under ``prefix`` (e.g. ``l1``), or
        None when any is missing: the block then declines the int8 path."""
        out = {}
        for name, _, key in DER_CONVS:
            s = scales.get(f"{prefix}/{key}")
            if s is None or s <= 0.0:
                return None
            out[name] = float(s)
        return out

    def q8_weights(self, sc: dict[str, float]) -> dict[str, K_conv.QConv]:
        """The 13 convs quantized once. The concat's sections arrive int8
        at three scales (x1 at s(st2), x4_1 at s(cv1_1), x4_3 at s(cv1)):
        cv1 folds them into its input channels and then quantizes the whole
        matrix, one scale per output channel, and runs at s_in = 1."""
        mods = dict(self.named_modules())
        c1 = self.stage1[0].reparam_conv.in_channels
        out = {}
        for name, path, _ in DER_CONVS:
            conv = mods[path]
            fold = None
            if name == "cv1":
                fold = torch.cat([torch.full((c1,), sc[k], dtype=torch.float32)
                                  for k in ("st2", "cv1_1", "cv1")])
            out[name] = K_conv.QConv(conv.weight, conv.bias, fold)
        return out

    def forward_q8(self, x: torch.Tensor, qw: dict[str, K_conv.QConv],
                   sc: dict[str, float], out_scale: float | None,
                   pool: bool) -> torch.Tensor:
        """The block on the int8 kernels (port of ``_fast_deploy``, q8).

        x (B, H, W, c1): int8 at s(st1), or float, quantized by K4. Every
        conv emits int8 at its successor's input scale; cv1 runs over the
        three sections with the trailing MP fused when ``pool``, and emits
        int8 at ``out_scale`` or float32 (the region's exit)."""
        def conv(name, h):
            q, s, nxt = qw[name], sc[name], sc[DER_NEXT[name]]
            if q.k == 3:
                return K_conv.conv3x3_q8(h, q, s, 1, "silu", nxt)
            return K_conv.conv1x1_q8(h, q, s, "silu", nxt)

        x1 = conv("st1", x)
        x3 = conv("st3", conv("st2", x1))
        x4_1 = conv("cv0_2", conv("st4", conv("cv0_1", x3)))
        x4_2 = conv("cv1_2", conv("st5", conv("cv1_1", x4_1)))
        x4_3 = conv("cv2_2", conv("st6", conv("cv2_1", x4_2)))
        return K_conv.conv1x1_q8([x1, x4_1, x4_3], qw["cv1"], 1.0, "silu",
                                 out_scale, pool)

    def cm_weights(self) -> dict[str, K_cm.CMConv]:
        """The 13 deploy convs as K10 / K11 take them (packed at their first
        launch)."""
        mods = dict(self.named_modules())
        return {name: K_cm.CMConv(mods[path].weight, mods[path].bias)
                for name, path, _ in DER_CONVS}

    def forward_cm(self, x: torch.Tensor,
                   cw: dict[str, K_cm.CMConv]) -> torch.Tensor:
        """The deploy block on the channel-major kernels (port of
        ``_fast_deploy``, "bf16"): x (B, c1, H, W) NCHW in the activation
        dtype -> (B, c2, H, W) in it. The six RepS stages run K10, the six
        1x1 convs and cv1 (over the three sections, no concat) K11; every
        conv's output is rounded to the activation dtype."""
        def conv(name, h):
            q = cw[name]
            if q.k == 3:
                return K_cm.conv3x3_cmajor(h, q, "silu")
            return K_cm.conv1x1_cmajor(h, q, "silu")

        x1 = conv("st1", x)
        x3 = conv("st3", conv("st2", x1))
        x4_1 = conv("cv0_2", conv("st4", conv("cv0_1", x3)))
        x4_2 = conv("cv1_2", conv("st5", conv("cv1_1", x4_1)))
        x4_3 = conv("cv2_2", conv("st6", conv("cv2_1", x4_2)))
        return K_cm.conv1x1_cmajor([x1, x4_1, x4_3], cw["cv1"], "silu")


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

    def forward_flat(self, x, out_scale, scale, cache):
        """Seven int8 convs around K8, the [x1, mp5, mp9, mp13] pyramid that
        cv5 reads as one section at x1's scale, tiled."""
        if tuple(self.k) != K_neck.SPP_K:
            raise ValueError(f"SPPCSPC flat path needs k={K_neck.SPP_K}")
        s = {n: scale(f"{n}/conv") for n in ("cv3", "cv4", "cv5", "cv6",
                                              "cv7")}

        def cv(name, h, out):
            return getattr(self, name).forward_flat(h, out, cache=cache,
                                                    name=name)

        x1 = cv("cv4", cv("cv3", cv("cv1", x, s["cv3"]), s["cv4"]), s["cv5"])
        sc = x1.scale.repeat(4) if isinstance(x1.scale, torch.Tensor) \
            else x1.scale
        pooled = NF.Q8Map(K_neck.spp_pools_q8(x1.data), sc)
        y1 = cv("cv6", cv("cv5", pooled, s["cv6"]), s["cv7"])
        y2 = cv("cv2", x, s["cv7"])
        return cv("cv7", [y1, y2], out_scale)


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

    def forward_flat(self, x, out_scale, scale, cache):
        """cv1 emits int8 at cv2's input scale, cv2 is the depthwise 5x5
        (K7). With ``out_scale`` the shuffle rides as the map's permutation
        (its per-channel scales shuffle with it); on the float exit it is a
        gather of the dequantized concat."""
        s_cv2 = scale("cv2/conv")
        x1 = self.cv1.forward_flat(x, s_cv2, cache=cache, name="cv1")
        x2 = self.cv2.forward_flat(x1, out_scale, cache=cache, name="cv2")
        if "perm" not in cache:
            c_ = x1.c
            cache["perm"] = NF.gs_shuffle_perm(2 * c_, x1.data.device)
            if out_scale is not None:
                cache["scale"] = torch.cat([x1.scale_vec(), x2.scale_vec()])
        if out_scale is not None:
            return NF.Q8Map(torch.cat([x1.data, x2.data], -1), cache["scale"],
                            cache["perm"])
        x1f = x1.data.float() * f32(s_cv2).to(x2.device)
        return torch.cat([x1f, x2], -1)[..., cache["perm"]]


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

    def forward_flat(self, x, out_scale, scale, cache):
        """Both branches exit in float32, add, then requant at
        ``out_scale`` (the JAX package adds in bf16)."""
        gs1, gs2 = self.conv_lighting
        y = gs1.forward_flat(x, scale("gs2/cv1/conv"),
                             *_sub(scale, cache, "gs1"))
        y = gs2.forward_flat(y, None, *_sub(scale, cache, "gs2"))
        out = y + self.shortcut.forward_flat(x, None, cache=cache,
                                             name="shortcut")
        return out if out_scale is None else NF.quantize_flat(out, out_scale)


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

    def forward_flat(self, x, out_scale, scale, cache):
        s_cv3 = scale("cv3/conv")
        x1 = self.cv1.forward_flat(x, scale("gsb_0/gs1/cv1/conv"),
                                   cache=cache, name="cv1")
        n = len(self.gsb)
        for i, g in enumerate(self.gsb):
            nxt = scale(f"gsb_{i + 1}/gs1/cv1/conv") if i + 1 < n else s_cv3
            x1 = g.forward_flat(x1, nxt, *_sub(scale, cache, f"gsb_{i}"))
        y = self.cv2.forward_flat(x, s_cv3, cache=cache, name="cv2")
        return self.cv3.forward_flat([y, x1], out_scale, cache=cache,
                                     name="cv3")


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
    ``pv`` (4, C); packed by ``nn.fuse``) and runs the fused kernels. The
    train form runs the JAX block's einsum formulation (``train=True``:
    Dropout(0.2) on the row attention ``att_w``)."""

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
            if criss_cross:
                self.dropout = Dropout(0.2)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        if hasattr(self, "wqk"):
            y = K_axial.axial_attention(x.permute(0, 2, 3, 1), self.wqk,
                                        self.pq, self.pv, self.gamma,
                                        self.criss_cross)
            return y.permute(0, 3, 1, 2)
        # q then k through the shared bn: two updates of its statistics
        q = F.relu6(self.bn(self.query_conv(x))).permute(0, 2, 3, 1)
        k = F.relu6(self.bn(self.key_conv(x))).permute(0, 2, 3, 1)
        v = F.relu6(self.bn1(self.value_conv(x))).permute(0, 2, 3, 1)
        qT, kT, vT = (t.transpose(1, 2) for t in (q, k, v))   # (B, W, H, C)
        e_hT = torch.einsum("bwhc,bwgc->bwhg", qT, kT)
        if not self.criss_cross:
            out = torch.einsum("bwgc,bwhg->bwhc", vT, e_hT).transpose(1, 2)
        else:
            # joint softmax over the column and row energies, one max and
            # one denominator (JAX CrissCrossAttention)
            e_w = torch.einsum("bhwc,bhgc->bhwg", q, k)
            m = torch.maximum(e_hT.amax(-1).transpose(1, 2),
                              e_w.amax(-1))[..., None]        # (B, H, W, 1)
            # exp in float32, as the JAX block takes it for any map dtype
            x_h = torch.exp((e_hT - m.transpose(1, 2)).float()).to(e_hT.dtype)
            x_w = torch.exp((e_w - m).float()).to(e_w.dtype)
            s = x_h.sum(-1).transpose(1, 2) + x_w.sum(-1)     # (B, H, W)
            att_hT = x_h / s[..., None].transpose(1, 2)
            att_w = self.dropout(x_w / s[..., None])
            out = (torch.einsum("bwgc,bwhg->bwhc", vT, att_hT).transpose(1, 2)
                   + torch.einsum("bhgc,bhwg->bhwc", v, att_w))
        return (self.gamma * out).permute(0, 3, 1, 2) + x


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
        if hasattr(self, "rbr_reparam"):
            return _act(self.act, self.rbr_reparam(x))
        out = (self.rbr_dense[1](conv(self.rbr_dense[0], x))
               + self.rbr_1x1[1](self.rbr_1x1[0](x)))
        if hasattr(self, "rbr_identity"):
            out = out + self.rbr_identity(x)
        return _act(self.act, out)

    def forward_flat(self, x, out_scale, scale=None, cache=None):
        return NF.flat_conv(x, self.rbr_reparam, cache, "rbr_reparam",
                            self.act, out_scale)


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
        for i, (conv1x1, x) in enumerate(zip(self.m, xs)):
            if hasattr(self, "ia"):     # train form: im(conv(x + ia))
                y = conv1x1(x + self.ia[i].implicit) * self.im[i].implicit
            else:
                y = conv1x1(x)
            b, _, h, w = y.shape
            outs.append(y.permute(0, 2, 3, 1).reshape(b, h, w, self.na,
                                                     self.no))
        return outs

    def forward_flat(self, xs, cache):
        """Levels whose input is an int8 map run their 1x1 on K5 with a
        float32 output and no activation (``_flat_head_level``)."""
        outs = []
        for i, (conv, x) in enumerate(zip(self.m, xs)):
            if isinstance(x, NF.Q8Map):
                y = NF.flat_conv(x, conv, cache, f"m_{i}", None, None)
            else:
                y = conv(x).permute(0, 2, 3, 1)
            b, h, w, _ = y.shape
            outs.append(y.reshape(b, h, w, self.na, self.no))
        return outs
