"""Datasets and the epoch loader (port of the synthetic part of
``rep_yolo_tpu/data/datasets.py``; the YOLO-directory dataset needs an image
decoder and is not ported yet).

``make_synthetic_dataset`` draws the JAX generator's numpy stream and holds
the images in memory (the JAX package writes them as JPEG files and decodes
them again), so its labels for a seed equal the JAX package's and its pixels
do not. ``load_item`` makes the aspect-kept canvas of ``_decode_canvas``
(longest side = ``img_size``, content top left, pad 114) with
``F.interpolate``; ``Loader`` gives fixed-shape batches.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

PAD_VALUE = 114


class InMemoryDataset:
    """Images (h, w, 3) uint8 RGB and labels (n, 5) [cls, xc, yc, w, h]
    normalized to the image."""

    def __init__(self, images: list[np.ndarray], labels: list[np.ndarray],
                 img_size: int, max_labels: int, nc: int):
        self.images = images
        self.labels = labels
        self.img_size = img_size
        self.max_labels = max_labels
        self.nc = nc

    def __len__(self) -> int:
        return len(self.images)

    def canvas(self, i: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (canvas (S, S, 3) uint8, hw (2,), orig (2,))."""
        S = self.img_size
        img = self.images[i]
        h0, w0 = img.shape[:2]
        r = S / max(h0, w0)
        if r != 1:
            t = torch.from_numpy(img).permute(2, 0, 1)[None].float()
            t = F.interpolate(t, size=(int(h0 * r), int(w0 * r)),
                              mode="area" if r < 1 else "bilinear",
                              align_corners=None if r < 1 else False)
            img = t[0].permute(1, 2, 0).round().clamp(0, 255).to(
                torch.uint8).numpy()
        h, w = img.shape[:2]
        out = np.full((S, S, 3), PAD_VALUE, np.uint8)
        out[:h, :w] = img
        return out, np.asarray([h, w], np.float32), \
            np.asarray([h0, w0], np.float32)

    def load_item(self, i: int):
        """-> (canvas, hw (2,), labels (M, 5), mask (M,), orig (2,))."""
        canvas, hw, orig = self.canvas(i)
        M = self.max_labels
        lab = np.zeros((M, 5), np.float32)
        mask = np.zeros((M,), bool)
        rows = self.labels[i][:M]
        lab[: len(rows)] = rows
        mask[: len(rows)] = True
        return canvas, hw, lab, mask, orig


def make_synthetic_dataset(n: int, img_size: int = 640, nc: int = 1,
                           max_labels: int = 120,
                           seed: int = 0) -> InMemoryDataset:
    """Random boxes on noise, drawn as the JAX package's generator draws
    them (same numpy stream, same labels)."""
    rng = np.random.default_rng(seed)
    images, labels = [], []
    for _ in range(n):
        h = int(rng.integers(img_size // 2, img_size * 3 // 2))
        w = int(rng.integers(img_size // 2, img_size * 3 // 2))
        img = rng.integers(0, 80, (h, w, 3), np.uint8)
        rows = []
        for _ in range(int(rng.integers(1, 6))):
            bw = float(rng.uniform(0.08, 0.4))
            bh = float(rng.uniform(0.08, 0.4))
            xc = float(rng.uniform(bw / 2, 1 - bw / 2))
            yc = float(rng.uniform(bh / 2, 1 - bh / 2))
            c = int(rng.integers(0, nc))
            x1, y1 = int((xc - bw / 2) * w), int((yc - bh / 2) * h)
            x2, y2 = int((xc + bw / 2) * w), int((yc + bh / 2) * h)
            img[y1:y2, x1:x2] = tuple(int(v) for v in
                                      rng.integers(150, 255, 3))
            rows.append((c, xc, yc, bw, bh))
        images.append(img)
        labels.append(np.asarray(rows, np.float32))
    return InMemoryDataset(images, labels, img_size, max_labels, nc)


class Loader:
    """Shuffled epochs of fixed-shape numpy batches, the last partial batch
    dropped (the JAX ``Loader``'s order for a seed: ``default_rng(seed +
    epoch).shuffle``)."""

    def __init__(self, ds: InMemoryDataset, batch_size: int, seed: int = 0):
        self.ds = ds
        self.bs = batch_size
        self.seed = seed

    def __len__(self) -> int:
        return len(self.ds) // self.bs

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        idx = np.arange(len(self.ds))
        np.random.default_rng(self.seed + epoch).shuffle(idx)
        for b in range(len(self)):
            sel = idx[b * self.bs:(b + 1) * self.bs]
            items = [self.ds.load_item(i) for i in sel]
            yield dict(images=np.stack([it[0] for it in items]),
                       hw=np.stack([it[1] for it in items]),
                       labels=np.stack([it[2] for it in items]),
                       mask=np.stack([it[3] for it in items]),
                       orig_shapes=np.stack([it[4] for it in items]),
                       indices=sel)
