"""High-level model API: build / init / strides / bias-init / fuse / predict.

Port of ``rep_yolo_tpu/models/model.py`` (float path). The network holds
its own weights; ``fuse()`` returns the deploy model built from
``nn.fuse.fuse_state_dict`` of the train-form state.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from rep_yolo_tpu_torch.device import resolve_device
from rep_yolo_tpu_torch.models import heads as heads_lib
from rep_yolo_tpu_torch.models.config import ModelConfig, parse_config
from rep_yolo_tpu_torch.models.network import DetectionNet
from rep_yolo_tpu_torch.nn import blocks as B
from rep_yolo_tpu_torch.nn.fuse import fuse_state_dict
from rep_yolo_tpu_torch.utils.weights import load_weights


class RepYOLO:
    """A built detection model: config + network + derived geometry."""

    def __init__(self, cfg: ModelConfig, net: DetectionNet,
                 strides: Sequence[float], anchors_px: np.ndarray):
        self.cfg = cfg
        self.net = net
        self.strides = tuple(strides)
        self.anchors_px = anchors_px                       # (nl, na, 2)
        self.anchors_grid = anchors_px / np.asarray(
            strides, np.float32)[:, None, None]

    @property
    def deploy(self) -> bool:
        return self.net.deploy

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    @classmethod
    def from_config(cls, cfg: str | dict | ModelConfig, ch: int = 3,
                    nc: int | None = None, anchors=None, deploy: bool = False,
                    device=None) -> "RepYOLO":
        if not isinstance(cfg, ModelConfig):
            cfg = parse_config(cfg, ch=ch, nc=nc, anchors=anchors)
        net = DetectionNet(cfg, deploy).to(resolve_device(device)).eval()
        strides = derive_strides(cfg)
        anchors_px = np.asarray(cfg.anchors, np.float32).reshape(
            cfg.nl, cfg.na, 2)
        anchors_px, strides = _check_anchor_order(anchors_px, strides)
        return cls(cfg, net, strides, anchors_px)

    # -- weights -----------------------------------------------------------

    def init(self, generator: torch.Generator) -> "RepYOLO":
        """Seeded init of the train-form weights (torch-default conv init,
        identity BNs, zero gamma, implicit 0 / 1 with std 0.02), then the
        detect-bias prior. For runs without weights."""
        def uniform(shape, bound):
            return (torch.rand(shape, generator=generator) * 2 - 1) * bound

        state = {}
        for name, mod in self.net.named_modules():
            p = f"{name}." if name else ""
            if isinstance(mod, torch.nn.Conv2d):
                bound = 1.0 / math.sqrt(mod.weight[0].numel())
                state[p + "weight"] = uniform(mod.weight.shape, bound)
                if mod.bias is not None:
                    state[p + "bias"] = uniform(mod.bias.shape, bound)
            elif isinstance(mod, B.BN):
                c = mod.weight.shape[0]
                state.update({p + "weight": torch.ones(c),
                              p + "bias": torch.zeros(c),
                              p + "running_mean": torch.zeros(c),
                              p + "running_var": torch.ones(c)})
            elif isinstance(mod, B.Implicit):
                mean = 0.0 if ".ia." in p else 1.0
                state[p + "implicit"] = mean + 0.02 * torch.randn(
                    mod.implicit.shape, generator=generator)
            elif isinstance(mod, B.AxialAttention):
                state[p + "gamma"] = torch.zeros(1)
        state = initialize_detect_biases(state, self.cfg, self.strides)
        self.load_state(state)
        return self

    def load_state(self, state: dict) -> "RepYOLO":
        """Load a reference-keyed state dict (numpy or tensors)."""
        load_weights(self.net, state)
        return self

    # -- deploy transform and forward --------------------------------------

    def fuse(self) -> "RepYOLO":
        """The deploy model (new network, fused weights)."""
        fused = fuse_state_dict(self.net.state_dict())
        net = DetectionNet(self.cfg, deploy=True).to(self.device).eval()
        load_weights(net, fused)
        return RepYOLO(self.cfg, net, self.strides, self.anchors_px)

    def cast(self, dtype: torch.dtype) -> "RepYOLO":
        """Cast the fused model to ``dtype`` in place (the JAX ``bench.py``
        casts every float leaf of the fused tree to bfloat16), but for the
        CA / CCVA / ADD attention islands, which stay float32 on the
        float32 attention kernels (``DetectionNet.cast``). The forward then
        takes images in ``dtype`` (others are cast at the stem) and returns
        raw maps in it; the decodes work in float32."""
        self.net.cast(dtype)
        return self

    @torch.no_grad()
    def apply(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Raw head maps (B, H, W, na, no) for NHWC images in [0, 1]."""
        return self.net(x)

    @torch.no_grad()
    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """Decoded predictions (B, N, no), reference row order."""
        maps = self.net(x)[: self.cfg.nl]
        return heads_lib.decode_predictions(maps, self.anchors_px,
                                            self.strides)

    @torch.no_grad()
    def predict_topk(self, x: torch.Tensor, k: int = 1024,
                     conf_thres: float | None = None) -> torch.Tensor:
        """Serving decode: (B, k, no), top-k by objectness, see
        ``heads.decode_topk``."""
        maps = self.net(x)[: self.cfg.nl]
        return heads_lib.decode_topk(maps, self.anchors_px, self.strides,
                                     k=k, conf_thres=conf_thres)


def derive_strides(cfg: ModelConfig, s: int = 256) -> list[float]:
    """Stride per detect level by a shape pass over the plan (spatial
    sizes only, no compute)."""
    size: dict[int, int] = {}
    h = s
    for spec in cfg.layers:
        src = [s if j == -1 else size[j] for j in spec.f]
        h = src[0]
        a, n = spec.args, spec.name
        if n in ("Conv", "GSConv", "RepConv"):
            k = a[1] if len(a) > 1 else 1
            st = a[2] if len(a) > 2 else 1
            h = (h + 2 * (k // 2) - k) // st + 1
        elif n == "RepS_Block":
            k, st = a[1], a[2] if len(a) > 2 else 1
            p = a[3] if len(a) > 3 else 0
            h = (h + 2 * p - k) // st + 1
        elif n == "MP":
            h = h // 2
        elif n in ("nn.Upsample", "Upsample"):
            h = h * 2
        elif n == "IDetect":
            return [s / size[j] for j in spec.f][: cfg.nl]
        size[spec.i] = h
    raise ValueError("config has no detect head")


def _check_anchor_order(anchors_px: np.ndarray, strides: Sequence[float]):
    """Flip the anchor levels if their mean areas do not follow the
    strides (reference utils/autoanchor.py:12-21)."""
    a = anchors_px.prod(-1).mean(-1)
    if np.sign(a[-1] - a[0]) != np.sign(strides[-1] - strides[0]):
        anchors_px = anchors_px[::-1].copy()
    return anchors_px, list(strides)


def initialize_detect_biases(state: dict, cfg: ModelConfig,
                             strides: Sequence[float]) -> dict:
    """Focal-prior init of the detect conv biases (reference
    models/yolo.py:621-629): obj += log(8/(640/s)^2), cls +=
    log(0.6/(nc-0.99))."""
    head = f"model.{cfg.head_index}"
    na, nc, no = cfg.na, cfg.nc, cfg.nc + 5
    out = dict(state)
    i = 0
    while f"{head}.m.{i}.bias" in out:
        b = torch.as_tensor(out[f"{head}.m.{i}.bias"]).float().clone()
        b = b.reshape(na, no)
        b[:, 4] += math.log(8 / (640 / strides[i]) ** 2)
        b[:, 5:] += math.log(0.6 / (nc - 0.99))
        out[f"{head}.m.{i}.bias"] = b.reshape(-1)
        i += 1
    return out
