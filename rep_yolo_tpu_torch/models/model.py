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

    def with_anchors(self, anchors_px: np.ndarray) -> "RepYOLO":
        """A view of this model with other pixel anchors (the autoanchor
        result; reference utils/autoanchor.py:54-57): the (nl * na, 2) set
        reshaped into levels, its order checked against the strides, the
        stride-normalized grid recomputed. The network and its parameters
        are shared: anchors are decode and loss constants, not weights."""
        a = np.asarray(anchors_px, np.float32).reshape(self.cfg.nl,
                                                       self.cfg.na, 2)
        a, strides = _check_anchor_order(a, list(self.strides))
        return RepYOLO(self.cfg, self.net, strides, a)

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

    @torch.no_grad()
    def predict_tta(self, x: torch.Tensor) -> torch.Tensor:
        """Test-time-augmented inference (reference models/yolo.py:569-585,
        the JAX ``predict_tta``): 3 scales (1.0, 0.83, 0.67) x flips (none,
        lr, none), each size rounded up to the largest stride, the decoded
        boxes de-scaled and de-flipped to the input's frame, concatenated
        along the rows. The resize is ``jax.image.resize(..., "bilinear")``'s:
        a triangle filter widened by the scale when it shrinks
        (``resize_matrix``)."""
        b, h, w, c = x.shape
        gs = int(max(self.strides))
        outs = []
        for s, flip in zip((1.0, 0.83, 0.67), (False, True, False)):
            nh = max(gs, int(math.ceil(h * s / gs) * gs))
            nw = max(gs, int(math.ceil(w * s / gs) * gs))
            xi = x
            if (nh, nw) != (h, w):
                ry = resize_matrix(h, nh, x.device).to(x.dtype)
                rx = resize_matrix(w, nw, x.device).to(x.dtype)
                xi = torch.einsum("bhwc,hy,wx->byxc", x, ry, rx)
            if flip:
                xi = xi.flip(2)
            yi = self.predict(xi)
            sx, sy = w / nw, h / nh
            boxes = yi[..., :4] * torch.tensor(
                [sx, sy, sx, sy], dtype=yi.dtype, device=yi.device)
            if flip:
                boxes = torch.cat([w - boxes[..., :1], boxes[..., 1:]], -1)
            outs.append(torch.cat([boxes, yi[..., 4:]], -1))
        return torch.cat(outs, 1)


def resize_matrix(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image.resize``'s bilinear resample
    along one axis (``jax._src.image.scale.compute_weight_mat``, antialias
    on): sample i sits at (i + 0.5) n_in / n_out - 0.5; the triangle kernel
    is widened by n_in / n_out when shrinking; each column is normalised
    to sum 1, and zeroed where the sample falls outside the input."""
    inv = torch.tensor(n_in / n_out, dtype=torch.float32)
    ks = torch.clamp(inv, min=1.0)
    f = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    d = (f[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs()
    wgt = torch.clamp(1 - d / ks, min=0.0)
    tot = wgt.sum(0, keepdim=True)
    wgt = torch.where(tot.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                      wgt / torch.where(tot != 0, tot, torch.ones_like(tot)),
                      torch.zeros_like(wgt))
    inside = (f >= -0.5) & (f <= n_in - 0.5)
    return torch.where(inside[None, :], wgt, torch.zeros_like(wgt)).to(device)


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
