"""Autoanchor: the anchors' best possible recall (BPR) on a dataset, and a
whitened k-means with genetic evolution where it is below 0.98 (port of
``rep_yolo_tpu/utils/autoanchor.py``; reference utils/autoanchor.py:23-160).

Numpy and scipy on the host, run once before training. The same rng stream,
k-means call and evolution loop as the JAX package, so on one dataset both
give the same BPR and the same anchors. The images' sizes come from the
dataset's ``image_shapes()``, (h, w) per image.
"""

from __future__ import annotations

import numpy as np


def _label_wh(ds, img_size: int, rng=None, jitter: bool = False) -> np.ndarray:
    """Label (w, h) in pixels after the longest-side resize to ``img_size``,
    each image's scaled by one U(0.9, 1.1) with ``jitter`` (reference
    utils/autoanchor.py:28-30, 112-113). Images without labels draw none."""
    shapes = ds.image_shapes()
    whs = []
    for (h0, w0), l in zip(shapes, ds.labels):
        if l.shape[0] == 0:
            continue
        w0, h0 = int(w0), int(h0)
        r = img_size / max(w0, h0)
        s = np.asarray([w0 * r, h0 * r])
        if jitter and rng is not None:
            s = s * rng.uniform(0.9, 1.1)
        whs.append(l[:, 3:5] * s)
    return (np.concatenate(whs) if whs
            else np.zeros((0, 2), np.float32)).astype(np.float32)


def _metric(k: np.ndarray, wh: np.ndarray):
    r = wh[:, None] / k[None]
    x = np.minimum(r, 1.0 / r).min(2)
    best = x.max(1)
    return x, best


def check_anchors(ds, anchors_px: np.ndarray, img_size: int = 640,
                  thr: float = 4.0, seed: int = 0):
    """-> (bpr, new anchors (nl * na, 2) or None): None where the BPR of
    ``anchors_px`` reaches 0.98, or where the evolved set recalls no more
    (reference utils/autoanchor.py:23-59)."""
    rng = np.random.default_rng(seed)
    wh = _label_wh(ds, img_size, rng, jitter=True)
    if wh.shape[0] == 0:
        return 1.0, None
    k = np.asarray(anchors_px).reshape(-1, 2)
    _, best = _metric(k, wh)
    bpr = float((best > 1.0 / thr).mean())
    if bpr >= 0.98:
        return bpr, None
    new = kmean_anchors(ds, n=k.shape[0], img_size=img_size, thr=thr,
                        gen=1000, seed=seed)
    _, best_new = _metric(new, wh)
    if float((best_new > 1.0 / thr).mean()) > bpr:
        return bpr, new
    return bpr, None


def kmean_anchors(ds, n: int = 9, img_size: int = 640, thr: float = 4.0,
                  gen: int = 1000, seed: int = 0) -> np.ndarray:
    """``n`` anchors (n, 2) float32 by area: k-means of the whitened label
    sizes, then ``gen`` generations of mutation kept where the fitness rises
    (reference utils/autoanchor.py:62-160)."""
    from scipy.cluster.vq import kmeans

    inv_thr = 1.0 / thr
    rng = np.random.default_rng(seed)
    wh0 = _label_wh(ds, img_size)
    wh = wh0[(wh0 >= 2.0).any(1)]
    if wh.shape[0] < n:
        raise ValueError(f"too few labels ({wh.shape[0]}) for {n} anchors")

    def fitness(k):
        _, best = _metric(k, wh)
        return float((best * (best > inv_thr)).mean())

    s = wh.std(0)
    k, _ = kmeans(wh / s, n, iter=30, seed=seed)
    if len(k) != n:
        raise ValueError("k-means returned fewer centroids than requested")
    k = k * s

    f, shape, mp, sigma = fitness(k), k.shape, 0.9, 0.1
    for _ in range(gen):
        v = np.ones(shape)
        while (v == 1).all():
            v = ((rng.random(shape) < mp) * rng.random()
                 * rng.standard_normal(shape) * sigma + 1).clip(0.3, 3.0)
        kg = (k.copy() * v).clip(min=2.0)
        fg = fitness(kg)
        if fg > f:
            f, k = fg, kg.copy()

    return k[np.argsort(k.prod(1))].astype(np.float32)
