"""Anchor-grid decode of the raw head maps (port of the decode functions of
``rep_yolo_tpu/models/heads.py``; the IDetect module is in ``nn.blocks``).

Decode math (reference models/yolo.py:129-130):
    xy = (sigmoid(t_xy) * 2 - 0.5 + grid) * stride
    wh = (sigmoid(t_wh) * 2) ** 2 * anchor_pixels
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from rep_yolo_tpu_torch.nn.blocks import IDetect

__all__ = ["IDetect", "make_grid", "decode_level", "decode_predictions",
           "decode_topk"]


def make_grid(ny: int, nx: int, device=None) -> torch.Tensor:
    """(ny, nx, 2) grid of (x, y) cell indices."""
    ys, xs = torch.meshgrid(torch.arange(ny, device=device),
                            torch.arange(nx, device=device), indexing="ij")
    return torch.stack([xs, ys], -1).float()


def decode_level(p: torch.Tensor, anchors_px, stride: float) -> torch.Tensor:
    """One raw map (B,H,W,na,no) -> (B, na*H*W, no), rows in the
    reference's (na, H, W) order."""
    b, h, w, na, no = p.shape
    y = torch.sigmoid(p)
    grid = make_grid(h, w, p.device)[None, :, :, None, :]
    anchors = torch.as_tensor(anchors_px, dtype=y.dtype, device=p.device)
    xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * stride
    wh = (y[..., 2:4] * 2.0) ** 2 * anchors[None, None, None]
    out = torch.cat([xy, wh, y[..., 4:]], -1)
    return out.permute(0, 3, 1, 2, 4).reshape(b, na * h * w, no)


def decode_predictions(ps: Sequence[torch.Tensor], anchors_px,
                       strides: Sequence[float]) -> torch.Tensor:
    """All levels: list[(B,H,W,na,no)] -> (B, N, no)."""
    return torch.cat([decode_level(p, anchors_px[i], strides[i])
                      for i, p in enumerate(ps)], 1)


_TABLES: dict = {}


def _slot_table(ps, anchors_px, strides, device) -> torch.Tensor:
    """Constant (N, 5) [grid_x, grid_y, anchor_w, anchor_h, stride] per
    slot, in the natural (h, w, a) flatten order of the raw maps."""
    shapes = tuple(tuple(p.shape[1:4]) for p in ps)
    key = (shapes, np.asarray(anchors_px).tobytes(), tuple(strides),
           str(device))
    if key not in _TABLES:
        tables = []
        for i, (h, w, na) in enumerate(shapes):
            gy, gx = np.mgrid[0:h, 0:w]
            g = np.broadcast_to(np.stack([gx, gy], -1)[:, :, None, :],
                                (h, w, na, 2)).reshape(-1, 2)
            a = np.broadcast_to(np.asarray(anchors_px)[i][None, None],
                                (h, w, na, 2)).reshape(-1, 2)
            s = np.full((h * w * na, 1), strides[i], np.float32)
            tables.append(np.concatenate([g, a, s], 1).astype(np.float32))
        _TABLES[key] = torch.as_tensor(np.concatenate(tables, 0),
                                       device=device)
    return _TABLES[key]


def decode_topk(ps: Sequence[torch.Tensor], anchors_px,
                strides: Sequence[float], k: int = 1024,
                conf_thres: float | None = None) -> torch.Tensor:
    """Serving decode: the top-``k`` candidates by RAW objectness logit,
    decoded after selection, rows score-descending (exact for nc == 1).
    With ``conf_thres`` the objectness gate is applied at the logit level
    (sigmoid(t) > c <=> t > logit(c)); gated rows decode with obj forced to
    a large negative logit, so feed the result to
    ``non_max_suppression(presorted=True)``."""
    no = ps[0].shape[-1]
    raw = torch.cat([p.reshape(p.shape[0], -1, no) for p in ps], 1)
    table = _slot_table(ps, anchors_px, strides, raw.device)
    k = min(k, raw.shape[1])
    obj = raw[..., 4].float()
    if conf_thres is not None:
        gate = math.log(conf_thres / (1.0 - conf_thres))
        obj = torch.where(obj > gate, obj, torch.full_like(obj, -1e4))
    g, idx = torch.topk(obj, k, dim=1)
    sel = torch.gather(raw, 1, idx[..., None].expand(-1, -1, no)).float()
    if conf_thres is not None:
        sel[..., 4] = torch.where(g > -1e4, sel[..., 4],
                                  torch.full_like(g, -1e4))
    t = table[idx]
    y = torch.sigmoid(sel)
    xy = (y[..., 0:2] * 2.0 - 0.5 + t[..., 0:2]) * t[..., 4:5]
    wh = (y[..., 2:4] * 2.0) ** 2 * t[..., 2:4]
    return torch.cat([xy, wh, y[..., 4:]], -1)
