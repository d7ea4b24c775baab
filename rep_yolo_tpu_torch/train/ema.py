"""Model EMA (port of ``rep_yolo_tpu/train/ema.py``, reference
utils/torch_utils.py:269-303): decay(t) = 0.9999 * (1 - exp(-t / 2000)) over
the parameters and the BN running statistics, keyed like the state dict.
The shadow copy is updated in place."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def init_ema(net: nn.Module) -> dict[str, torch.Tensor]:
    """A copy of every floating-point entry of ``net``'s state dict."""
    return {k: v.detach().clone() for k, v in net.state_dict().items()
            if v.is_floating_point()}


@torch.no_grad()
def update_ema(ema: dict[str, torch.Tensor], net: nn.Module, updates: int,
               decay: float = 0.9999, tau: float = 2000.0) -> None:
    """ema = ema * d + (1 - d) * current, d from the ``updates``-th update
    (counted from 1), computed in float32 as the JAX package does."""
    f32 = np.float32
    d = f32(decay) * (f32(1.0) - np.exp(-f32(updates) / f32(tau)))
    cur = net.state_dict()
    keys = list(ema)
    e = [ema[k] for k in keys]
    torch._foreach_mul_(e, float(d))
    torch._foreach_add_(e, [cur[k] for k in keys], alpha=float(f32(1.0) - d))
