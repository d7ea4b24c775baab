"""Routed network executor: ModelConfig plan -> ``nn.Module``.

Port of ``rep_yolo_tpu/models/network.py`` (``DetectionNet.__call__``):
the float graph, train form (``train()`` / ``eval()``, the JAX ``train``
argument) or deploy form, and for a deploy net with ``set_q8`` the int8
region planned by ``models/region.py`` (the backbone, and with
``Q8Region.neck`` the neck and head too), or with ``set_der_fast("bf16")``
the DER blocks on the channel-major float kernels (with ``"xla_q8"`` on the
int8 pixel-major ones, K4 / K5). ``cast`` runs a deploy net
in bfloat16 with float32 attention islands. Layer ``i`` lives at
``model.{i}``, so state keys match the reference's.
"""

from __future__ import annotations

import torch
from torch import nn

from rep_yolo_tpu_torch.models.config import LayerSpec, ModelConfig
from rep_yolo_tpu_torch.models.region import (Q8Region, RegionPlan, Step,
                                              plan_region)
from rep_yolo_tpu_torch.nn import blocks as B
from rep_yolo_tpu_torch.ops import neck_flat as NF
from rep_yolo_tpu_torch.ops.kernels import pool_flat as K_pool


def build_module(spec: LayerSpec, deploy: bool) -> nn.Module:
    """The module for one plan row (the flagship's module set only)."""
    a, n, c1 = spec.args, spec.name, spec.c1
    if n == "Conv":
        return B.ConvBnAct(c1, *a, deploy=deploy)
    if n == "RepConv":
        return B.RepConv(c1, *a, deploy=deploy)
    if n == "RepS_Block":
        # yaml args [c2, k, s, p]; one conv branch, as the JAX package pins
        return B.RepSBlock(c1, a[0], a[1], a[2] if len(a) > 2 else 1,
                           a[3] if len(a) > 3 else 0, 1, deploy)
    if n == "DER_Block":
        return B.DERBlock(c1, a[0], a[1] if len(a) > 1 else 2,
                          a[2] if len(a) > 2 else 1, deploy)
    if n == "SPPCSPC":
        return B.SPPCSPC(c1, a[0], n=a[1], deploy=deploy)
    if n == "GSConv":
        return B.GSConv(c1, *a, deploy=deploy)
    if n == "VoVGSCSP":
        return B.VoVGSCSP(c1, a[0], deploy=deploy)
    if n == "CA":
        return B.CA(*a)
    if n == "CCVA":
        return B.CCVA(c1, a[0], deploy=deploy)
    if n == "IDetect":
        return B.IDetect(nc=a[0], anchors=a[1], ch=a[2], deploy=deploy)
    if n == "MP":
        return B.MP()
    if n in ("nn.Upsample", "Upsample"):
        return B.Upsample()
    if n == "Concat":
        return B.Concat()
    if n == "ADD":
        return B.Add()
    raise ValueError(f"unsupported module {n!r}")


# The CA / CCVA / ADD attention sandwiches: a net cast to another dtype keeps
# their weights and activations in ``island_dtype`` (float32: the attention
# kernels K1 / K2 are float32).
ISLANDS = (B.CA, B.CCVA, B.Add)


def der_fast_default_select(c1: int, h: int, w: int) -> bool:
    """The JAX ``set_cmajor_deploy`` default: every DER block with c1 <=
    512, the flagship's four."""
    return c1 <= 512


def _to(t, dtype: torch.dtype):
    if isinstance(t, list):
        return [_to(v, dtype) for v in t]
    return t.to(dtype) if torch.is_tensor(t) and t.is_floating_point() else t


class DetectionNet(nn.Module):
    """Input NHWC float images in [0, 1]; output the raw head maps
    (B, H_l, W_l, na, no) per level.

    The train form trains: ``set_wgrad`` routes its 3x3 convs' weight
    gradients to K9 and ``set_generator`` gives its dropout masks their
    generator; in ``eval()``, ``set_fused_attention`` routes its attention
    to K2. All are held here, per network.

    ``set_q8(Q8Region(scales))`` switches on the int8 region; the plan is
    computed once per input size (``region_plan`` holds the last one's
    decisions) and the region's weights are quantized once: the stem's and
    the DERs' with the plan, the neck's at the plan's first forward (their
    folds need the input maps' scales and permutations).

    ``cast(dtype)`` runs the deploy net in ``dtype`` (bfloat16 serving);
    ``set_der_fast("bf16")`` routes its DER blocks to K10 / K11,
    ``set_der_fast("xla_q8", scales=)`` to K4 / K5 int8-resident."""

    def __init__(self, cfg: ModelConfig, deploy: bool = False):
        super().__init__()
        self.cfg = cfg
        self.deploy = deploy
        self.model = nn.ModuleList(build_module(s, deploy) for s in cfg.layers)
        self.q8: Q8Region | None = None
        self.region_plan: dict[int, str] = {}
        self._plans: dict[tuple[int, int], RegionPlan] = {}
        self._q8w: dict[int, object] = {}
        self.dtype: torch.dtype | None = None     # None: as loaded, no casts
        self.island_dtype = torch.float32
        self.der_fast: str | None = None
        self.der_scales: dict[str, float] = {}
        self._der_select = der_fast_default_select
        self._cmw: dict[int, dict | None] = {}

    def set_wgrad(self, enable: bool, select=None) -> None:
        """Port of the JAX ``set_pallas_wgrad(enable, select)``: with
        ``enable``, every 3x3 stride-1 pad-1 ungrouped bias-free conv of the
        train form that passes ``select(c1, c2)`` (default: the JAX
        package's off-TPU select, ``B.wgrad_default_select``) takes its
        weight gradient from K9. Off by default."""
        select = select or B.wgrad_default_select
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.wgrad = (enable and B.wgrad_eligible(m)
                           and bool(select(m.in_channels, m.out_channels)))

    def set_fused_attention(self, enable: bool | None) -> None:
        """Port of the JAX ``set_fused_attention(enable)``, held per network:
        the train form's attention blocks, in ``eval()``, attend with K2
        (kernel-table row 3) at every size. ``enable=None`` is the default:
        on for CUDA tensors (the port's deploy attention always runs K1 /
        K2), off on the CPU. The train forward never takes the kernel;
        deploy blocks always do."""
        for m in self.modules():
            if isinstance(m, B.AxialAttention):
                m.fused = enable

    def set_generator(self, generator: torch.Generator | None) -> None:
        """The generator every dropout mask of the train form is drawn
        from (on the device of the activations)."""
        for m in self.modules():
            if isinstance(m, B.Dropout):
                m.generator = generator

    def set_q8(self, region: Q8Region | None) -> None:
        """Turn the int8 region on (calibrated scales) or off (None)."""
        if region is not None and not self.deploy:
            raise RuntimeError("the int8 region runs the deploy form; fuse "
                               "first")
        if region is not None and (self.der_fast is not None
                                   or self.dtype not in (None, torch.float32)):
            raise RuntimeError("the int8 region runs a float32 net without "
                               "der_fast (one mode switch in the JAX package)")
        self.q8 = region
        # the depthwise 5x5 convs' int8 route (NF.quantized reads it)
        for m in self.modules():
            if isinstance(m, nn.Conv2d) and NF.is_dw5(m):
                m.dw5_dense = region is None or region.dw5_dense
        self.region_plan = {}
        self._plans.clear()
        self._q8w.clear()

    def set_der_fast(self, mode: str | None, select=None,
                     scales: dict[str, float] | None = None) -> None:
        """Port of the JAX ``set_cmajor_deploy(mode, scales, select)`` for
        modes ``"bf16"`` and ``"xla_q8"`` (or None: off): every deploy DER
        block that passes ``select(c1, h, w)`` (default
        ``der_fast_default_select``) runs ``DERBlock.forward_cm`` on K10 /
        K11 in the net's activation dtype ("bf16"), or
        ``DERBlock.forward_xla_q8`` on K4 / K5 with the calibrated
        ``scales`` (``ops.quant.calibrate``; "xla_q8"). A block whose 13
        scales are not all there runs its regular deploy path, as the JAX
        ``_fast_deploy`` returns None."""
        if mode not in (None, "bf16", "xla_q8"):
            raise ValueError(f"unknown DER fast mode {mode!r}")
        if mode is not None and not self.deploy:
            raise RuntimeError("der_fast runs the deploy form; fuse first")
        if mode is not None and self.q8 is not None:
            raise RuntimeError("der_fast and the int8 region are one mode "
                               "switch in the JAX package; set_q8(None) "
                               "first")
        self.der_fast = mode
        self.der_scales = dict(scales or {})
        self._der_select = select or der_fast_default_select
        self._cmw.clear()

    def der_fast_declined(self) -> list[int]:
        """The layers of the DER blocks that a forward since the last
        ``set_der_fast`` selected for "xla_q8" but that ran their regular
        path, their scales missing."""
        return sorted(i for i, w in self._cmw.items() if w is None)

    def cast(self, dtype: torch.dtype,
             island_dtype: torch.dtype = torch.float32) -> None:
        """Cast every floating parameter and buffer to ``dtype`` (the JAX
        ``bench.py`` casts its fused tree so) but the attention islands'
        (``ISLANDS``), which go to ``island_dtype``. The forward then hands
        each layer its inputs in its own dtype: the islands upcast at their
        edges and the next layer rounds back."""
        if not self.deploy:
            raise RuntimeError("cast runs the deploy form; fuse first")
        if self.q8 is not None and dtype != torch.float32:
            raise RuntimeError("the int8 region runs a float32 net")
        for mod in self.model:
            mod.to(island_dtype if isinstance(mod, ISLANDS) else dtype)
        self.dtype, self.island_dtype = dtype, island_dtype
        self._cmw.clear()

    def _der_cm(self, spec: LayerSpec, mod: nn.Module, x):
        """The DER block on K10 / K11 ("bf16") or K4 / K5 ("xla_q8") when
        ``set_der_fast`` selects it, else None (also for an "xla_q8" block
        without its scales)."""
        if self.der_fast is None or not isinstance(mod, B.DERBlock) \
                or not self._der_select(x.shape[1], x.shape[2], x.shape[3]):
            return None
        if spec.i not in self._cmw:
            if self.der_fast == "bf16":
                self._cmw[spec.i] = mod.cm_weights()
            else:
                sc = B.DERBlock.q8_scales(self.der_scales, f"l{spec.i}")
                self._cmw[spec.i] = None if sc is None else \
                    {"qw": mod.q8_weights(sc), "sc": sc}
        w = self._cmw[spec.i]
        if w is None:
            return None
        if self.der_fast == "bf16":
            return mod.forward_cm(x.contiguous(), w)
        return mod.forward_xla_q8(x, w["qw"], w["sc"])

    def plan_for(self, h: int, w: int) -> RegionPlan:
        """The region plan for (h, w) inputs, made once per size; the
        weights of the stem and DERs it runs in int8 are quantized once, and
        each neck layer gets the cache its ``forward_flat`` fills."""
        if (h, w) not in self._plans:
            plan = plan_region(self.cfg, self.q8, h, w)
            for i, step in plan.steps.items():
                if i in self._q8w:
                    continue
                mod = self.model[i]
                if step.kind == "stem":
                    self._q8w[i] = mod.q8_weights()
                elif step.kind == "der":
                    self._q8w[i] = mod.q8_weights(step.scales)
                elif step.kind in ("flat", "head"):
                    self._q8w[i] = {}
            self._plans[(h, w)] = plan
        plan = self._plans[(h, w)]
        self.region_plan = dict(plan.strings)
        return plan

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        steps = ({} if self.q8 is None
                 else self.plan_for(x.shape[1], x.shape[2]).steps)
        first = steps.get(self.cfg.layers[0].i)
        # NCHW inside: cuDNN's f32 convolutions run NCHW kernels and
        # transpose around channels_last activations (PERF.md); the int8
        # stem reads the NHWC images as they are
        y = x if first is not None and first.kind == "stem" else \
            x.permute(0, 3, 1, 2).contiguous()
        saved: dict[int, object] = {}
        floats: dict[int, torch.Tensor] = {}   # dequantized region maps
        for spec, mod in zip(self.cfg.layers, self.model):
            step = steps.get(spec.i)
            raw = step.raw if step is not None else ()

            def fetch(j):
                jj = spec.i - 1 if j == -1 else j
                t = y if j in (spec.i - 1, -1) else saved[j]
                if NF.is_flat(t) and jj not in raw:
                    if jj not in floats:
                        floats[jj] = NF.flat_to_float(t)
                    return floats[jj]
                return t

            inp = fetch(spec.f[0]) if len(spec.f) == 1 else \
                [fetch(j) for j in spec.f]
            if spec.name == "IDetect" and not isinstance(inp, list):
                inp = [inp]
            if self.dtype is not None:
                inp = _to(inp, self.island_dtype if isinstance(mod, ISLANDS)
                          else self.dtype)
            if step is not None:
                y = self._run_q8(spec, mod, step, inp)
            else:
                y = self._der_cm(spec, mod, inp)
                if y is None:
                    y = mod(inp)
            if spec.save:
                saved[spec.i] = y
        return y

    def _run_q8(self, spec: LayerSpec, mod: nn.Module, step: Step, inp):
        if step.kind == "mp_fused":
            return inp
        if step.kind == "mp_pool":
            return NF.Q8Map(K_pool.max_pool2_q8(inp.data), inp.scale,
                            inp.perm)
        if step.kind == "upsample":
            return NF.upsample2x(inp)
        if step.kind == "concat":
            return [t for x in inp
                    for t in (x if isinstance(x, list) else [x])]
        if step.kind == "head":
            return mod.forward_flat(inp, self._q8w[spec.i])
        if step.kind == "flat":
            x = inp if step.s_in is None else NF.quantize_to_flat(inp,
                                                                  step.s_in)
            region = self.q8
            y = mod.forward_flat(x, step.out_scale,
                                 lambda k: region.scale(f"l{spec.i}/{k}"),
                                 self._q8w[spec.i])
            if step.out_scale is None:
                return y.permute(0, 3, 1, 2).contiguous()   # the float exit
            return y
        if step.cm_in:
            x = inp.data
        elif spec.f == (-1,) and step.kind == "stem":
            x = inp                                  # the NHWC images
        else:
            x = inp.permute(0, 2, 3, 1).contiguous()
        qw = self._q8w[spec.i]
        if step.kind == "stem":
            y = mod.forward_stem_q8(x, qw, step.s_in, step.out_scale)
        else:
            y = mod.forward_q8(x, qw, step.scales, step.out_scale, step.pool)
        if step.out_scale is None:
            return y.permute(0, 3, 1, 2).contiguous()   # the float exit
        return NF.Q8Map(y, step.out_scale)
