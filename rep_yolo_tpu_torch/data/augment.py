"""The train step's input normalization (port of
``rep_yolo_tpu/data/augment.py:identity_batch``; the random augmentations
are not ported yet)."""

from __future__ import annotations

import torch


def identity_batch(images: torch.Tensor, hw: torch.Tensor,
                   labels: torch.Tensor):
    """The no-augment input contract (reference train.py:351 ``imgs/255``
    with the letterboxed collate). The loader's canvases are uint8 0-255,
    (B, H, W, 3), with the aspect-kept content at the top left occupying
    (h, w) = ``hw``; labels are xywh normalized to the content. Returns
    (images float 0-1, labels normalized to the canvas)."""
    # times the float32 reciprocal: what XLA compiles the JAX package's
    # ``/ 255.0`` to (the quotient differs by an ulp in about half the pixels)
    img = images.float() * (1.0 / 255.0)
    H, W = images.shape[1], images.shape[2]
    sy = (hw[:, 0] / H)[:, None]
    sx = (hw[:, 1] / W)[:, None]
    labels = torch.stack([labels[..., 0],
                          labels[..., 1] * sx, labels[..., 2] * sy,
                          labels[..., 3] * sx, labels[..., 4] * sy], -1)
    return img, labels
