"""Optimizer: 3-group SGD (nesterov) or Adam with YOLO warmup and one-cycle.

Port of ``rep_yolo_tpu/train/optim.py`` (reference train.py:115-208):

- group 0: BN weights and the implicit ``ia``/``im`` -- lr, no weight decay;
- group 1: conv weights -- lr and weight decay (scaled by the effective
  batch, ``scaled_weight_decay``);
- group 2: every bias (conv and BN) -- its own warmup ramp;
- frozen: the attention ``gamma``s (reference quirk: no group of the
  reference holds them) -- lr 0; their momentum buffer still accumulates.

Groups are keyed on the port's reference keys: a ``.weight`` is group 1
under an ``nn.Conv2d`` and group 0 under a BN. The update is in place on
the parameters and buffers (the JAX package returns new trees) and matches
``torch.optim.SGD(nesterov=True)``:

    g = grad + wd * p;  buf = m * buf + g;  p -= lr * (g + m * buf).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from rep_yolo_tpu_torch.nn import blocks as B

G_BN_IMPLICIT = 0   # no decay
G_KERNEL = 1        # decay
G_BIAS = 2          # bias warmup
G_FROZEN = 3        # never stepped (reference gamma quirk)


def group_of(key: str, module: nn.Module) -> int:
    """The optimizer group of parameter ``key`` held by ``module``."""
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "gamma":
        return G_FROZEN
    if isinstance(module, B.Implicit):
        return G_BN_IMPLICIT
    if leaf == "bias":
        return G_BIAS
    if leaf == "weight" and isinstance(module, nn.Conv2d):
        return G_KERNEL
    return G_BN_IMPLICIT


def param_groups(net: nn.Module) -> dict[str, int]:
    """{parameter key: group} over ``net.named_parameters()``."""
    mods = dict(net.named_modules())
    return {k: group_of(k, mods[k.rsplit(".", 1)[0] if "." in k else ""])
            for k, _ in net.named_parameters()}


def one_cycle_factor(epoch: float, epochs: int, lrf: float) -> float:
    """Cosine 1 -> lrf over ``epochs`` (reference utils/general.py:186)."""
    return ((1 - math.cos(epoch * math.pi / epochs)) / 2) * (lrf - 1) + 1


def linear_factor(epoch: float, epochs: int, lrf: float) -> float:
    return (1 - epoch / (epochs - 1)) * (1.0 - lrf) + lrf


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr0: float = 0.01
    lrf: float = 0.1
    momentum: float = 0.937
    weight_decay: float = 0.0005     # already batch-scaled by the caller
    warmup_epochs: float = 3.0
    warmup_momentum: float = 0.8
    warmup_bias_lr: float = 0.1
    epochs: int = 300
    nb: int = 100                    # batches per epoch
    linear_lr: bool = False
    adam: bool = False
    warmup_floor: int = 1000         # min warmup iterations

    @property
    def nw(self) -> int:
        """Warmup iterations (reference train.py:307)."""
        return max(round(self.warmup_epochs * self.nb), self.warmup_floor)


def schedule(cfg: OptimConfig, step: int) -> tuple[tuple, float]:
    """(lr of groups 0-3, momentum) at global iteration ``step``."""
    epoch = step / cfg.nb
    lf = (linear_factor(epoch, cfg.epochs, cfg.lrf) if cfg.linear_lr
          else one_cycle_factor(epoch, cfg.epochs, cfg.lrf))
    target = cfg.lr0 * lf
    if step >= cfg.nw:
        return (target, target, target, 0.0), cfg.momentum
    frac = min(max(step / max(cfg.nw, 1), 0.0), 1.0)
    lr_bias = cfg.warmup_bias_lr + frac * (target - cfg.warmup_bias_lr)
    mom = cfg.warmup_momentum + frac * (cfg.momentum - cfg.warmup_momentum)
    return (frac * target, frac * target, lr_bias, 0.0), mom


@torch.no_grad()
def apply_updates(params: dict[str, torch.Tensor],
                  grads: dict[str, torch.Tensor],
                  momentum: dict[str, torch.Tensor],
                  second: dict[str, torch.Tensor], groups: dict[str, int],
                  step: int, cfg: OptimConfig) -> None:
    """One optimizer step at iteration ``step``, in place on ``params``,
    ``momentum`` (SGD buffer or Adam m) and ``second`` (Adam v)."""
    lrs, mom = schedule(cfg, step)
    for gid in sorted(set(groups.values())):
        keys = [k for k in params if groups[k] == gid]
        p = [params[k] for k in keys]
        g = [grads[k] for k in keys]
        m = [momentum[k] for k in keys]
        if gid == G_KERNEL and cfg.weight_decay:
            g = torch._foreach_add(g, p, alpha=cfg.weight_decay)
        if cfg.adam:
            b1, b2 = cfg.momentum, 0.999
            # the bias corrections in float32, as the JAX package has them
            c1, c2 = (float(1 - np.float32(b) ** np.float32(step + 1))
                      for b in (b1, b2))
            v = [second[k] for k in keys]
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, g, alpha=1 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, g, g, value=1 - b2)
            den = torch._foreach_sqrt(torch._foreach_div(v, c2))
            torch._foreach_add_(den, 1e-8)
            torch._foreach_addcdiv_(p, torch._foreach_div(m, c1), den,
                                    value=-lrs[gid])
        else:
            torch._foreach_mul_(m, mom)
            torch._foreach_add_(m, g)
            torch._foreach_add_(p, torch._foreach_add(g, m, alpha=mom),
                                alpha=-lrs[gid])


def accumulate_steps(total_batch: int, nbs: int = 64) -> int:
    """Gradient accumulation count (reference train.py:116-117)."""
    return max(round(nbs / total_batch), 1)


def scaled_weight_decay(wd: float, total_batch: int, nbs: int = 64) -> float:
    """Weight decay scaled by the effective batch (reference train.py:118)."""
    return wd * total_batch * accumulate_steps(total_batch, nbs) / nbs
