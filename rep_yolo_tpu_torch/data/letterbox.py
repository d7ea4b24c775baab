"""Eval-path letterbox (port of ``rep_yolo_tpu/data/augment.py``
``letterbox_batch`` / ``_interp_matrix``): resize the content to fit, centre
it, pad with 114, scale to [0, 1]. The resample is two dense bilinear
interpolation matrices, as in the JAX package, so both agree closely."""

from __future__ import annotations

import torch

PAD_VALUE = 114.0


def _interp_matrix(coords: torch.Tensor, src_size: int,
                   bound: torch.Tensor | None = None):
    """Dense bilinear matrices R (..., out, src) sampling at ``coords``
    (..., out); taps outside [0, bound) get zero weight. Also returns the row
    sums."""
    i0 = torch.floor(coords)
    f = coords - i0
    src = torch.arange(src_size, dtype=torch.float32, device=coords.device)
    hi = float(src_size) if bound is None else bound
    r = torch.zeros((*coords.shape, src_size), dtype=torch.float32,
                    device=coords.device)
    for d, wgt in ((0, 1.0 - f), (1, f)):
        idx = i0 + d
        ok = (idx >= 0) & (idx < hi)
        r = r + torch.where((src == idx[..., None]) & ok[..., None],
                            wgt[..., None], torch.zeros_like(r))
    return r, r.sum(-1)


def letterbox_batch(images: torch.Tensor, hw: torch.Tensor,
                    size: int | tuple[int, int], scaleup: bool = False):
    """images (B, H0, W0, 3) canvases whose top-left ``hw`` (B, 2) pixels
    hold the content -> (imgs (B, sh, sw, 3) float in [0, 1], ratio (B,),
    pad (B, 2) as (pad_x, pad_y))."""
    size_h, size_w = (size, size) if isinstance(size, int) else size
    images = images.float()
    hw = hw.float()
    dev = images.device
    idx_y = torch.arange(size_h, dtype=torch.float32, device=dev)
    idx_x = torch.arange(size_w, dtype=torch.float32, device=dev)
    outs, ratios, pads = [], [], []
    for img, (h, w) in zip(images, hw):
        r = torch.minimum(size_h / h, size_w / w)
        if not scaleup:
            r = torch.minimum(r, torch.ones_like(r))
        nh, nw = torch.round(h * r), torch.round(w * r)
        oy = torch.round((size_h - nh) / 2.0)
        ox = torch.round((size_w - nw) / 2.0)
        ry, sy = _interp_matrix((idx_y - oy) / r, img.shape[0], bound=h)
        rx, sx = _interp_matrix((idx_x - ox) / r, img.shape[1], bound=w)
        out = torch.einsum("ywc,xw->yxc",
                           torch.einsum("yh,hwc->ywc", ry, img), rx)
        out = out + PAD_VALUE * (1.0 - sy[:, None] * sx[None, :])[..., None]
        outs.append(out / 255.0)
        ratios.append(r)
        pads.append(torch.stack([(size_w - nw) / 2.0, (size_h - nh) / 2.0]))
    return torch.stack(outs), torch.stack(ratios), torch.stack(pads)
