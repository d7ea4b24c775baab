"""Routed network executor: ModelConfig plan -> ``nn.Module``.

Port of the float branch of ``rep_yolo_tpu/models/network.py``
(``DetectionNet.__call__`` without the int8 region planner). Layer ``i``
lives at ``model.{i}``, so state keys match the reference's.
"""

from __future__ import annotations

import torch
from torch import nn

from rep_yolo_tpu_torch.models.config import LayerSpec, ModelConfig
from rep_yolo_tpu_torch.nn import blocks as B


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


class DetectionNet(nn.Module):
    """Input NHWC float images in [0, 1]; output the raw head maps
    (B, H_l, W_l, na, no) per level. Only the deploy form runs."""

    def __init__(self, cfg: ModelConfig, deploy: bool = False):
        super().__init__()
        self.cfg = cfg
        self.deploy = deploy
        self.model = nn.ModuleList(build_module(s, deploy) for s in cfg.layers)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        if not self.deploy:
            raise RuntimeError("only the fused deploy graph runs; fuse first")
        # NCHW inside: cuDNN's f32 convolutions run NCHW kernels and
        # transpose around channels_last activations (PERF.md)
        y = x.permute(0, 3, 1, 2).contiguous()
        saved: dict[int, torch.Tensor] = {}
        for spec, mod in zip(self.cfg.layers, self.model):
            def fetch(j):
                return y if j in (spec.i - 1, -1) else saved[j]

            inp = fetch(spec.f[0]) if len(spec.f) == 1 else \
                [fetch(j) for j in spec.f]
            if spec.name == "IDetect" and not isinstance(inp, list):
                inp = [inp]
            y = mod(inp)
            if spec.save:
                saved[spec.i] = y
        return y
