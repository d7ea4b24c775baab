"""Hub-style high-level API: robust-input inference + model ensembling.

Port of ``rep_yolo_tpu/hub.py``, the reference's hub surface:

- ``load()`` / ``create()`` / ``custom()`` — build a model from a cfg (and
  optionally restore a checkpoint of either package), fused for deploy
  (reference hubconf.py:22-78 and models/experimental.py:237-262
  ``attempt_load``).
- ``AutoShape`` — robust-input wrapper: numpy images / file paths / lists in
  any size -> letterbox -> batched fused forward -> NMS on the card ->
  coordinates scaled back to each original frame (reference
  models/common.py:881-948 ``autoShape``).
- ``Detections`` — results object: per-image arrays, ``print()``,
  ``save()``, ``pandas()``-style dict rows (reference
  models/common.py:951-1028).
- ``EnsembleModel`` — multi-checkpoint NMS-ensemble: per-model decoded
  predictions concatenated before NMS (reference
  models/experimental.py:69-83 ``Ensemble``, 'nms ensemble' branch).
- ``nms_module()`` — the reference's ``NMS`` module
  (models/common.py:868-878) as a closure over thresholds.

The forward and NMS run on the model's device (the card unless
``device="cpu"``); only image decode and the letterbox run on the host
(``letterbox_np``: a pure numpy bilinear resize, no cv2 needed).
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from rep_yolo_tpu_torch.models.model import RepYOLO
from rep_yolo_tpu_torch.ops.nms import non_max_suppression


def _resize_np(img: np.ndarray, new_hw: tuple[int, int]) -> np.ndarray:
    """Bilinear resize in pure numpy (no cv2 dependency on host)."""
    h, w = img.shape[:2]
    nh, nw = new_hw
    if (h, w) == (nh, nw):
        return img
    ys = np.linspace(0, h - 1, nh)
    xs = np.linspace(0, w - 1, nw)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    a = img[y0][:, x0].astype(np.float32)
    b = img[y0][:, x1].astype(np.float32)
    c = img[y1][:, x0].astype(np.float32)
    d = img[y1][:, x1].astype(np.float32)
    return a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx \
        + c * wy * (1 - wx) + d * wy * wx


def letterbox_np(img: np.ndarray, size: int,
                 color: float = 114.0) -> tuple[np.ndarray, float, tuple]:
    """Host letterbox (reference utils/datasets.py:984-1014, auto=False):
    scale to fit, pad to (size, size). Returns (img, ratio, (dw, dh))."""
    h, w = img.shape[:2]
    r = min(size / h, size / w)
    nh, nw = int(round(h * r)), int(round(w * r))
    resized = _resize_np(img, (nh, nw))
    out = np.full((size, size, img.shape[2]), color, np.float32)
    dh, dw = (size - nh) // 2, (size - nw) // 2
    out[dh:dh + nh, dw:dw + nw] = resized
    return out, r, (dw, dh)


@dataclasses.dataclass
class Detections:
    """Per-image detection results (reference models/common.py:951-1028)."""

    xyxy: list          # per image: (n, 6) [x1,y1,x2,y2,conf,cls] np arrays
    names: Sequence[str]
    shapes: list        # original (h, w) per image

    def __len__(self):
        return len(self.xyxy)

    def print(self):
        for i, det in enumerate(self.xyxy):
            counts = {}
            for c in det[:, 5].astype(int):
                counts[c] = counts.get(c, 0) + 1
            parts = [f"{v} {self.names[k] if k < len(self.names) else k}"
                     for k, v in sorted(counts.items())]
            print(f"image {i}/{len(self)}: {self.shapes[i][1]}x"
                  f"{self.shapes[i][0]} " + (", ".join(parts) or "(no detections)"))

    def pandas(self) -> list[list[dict]]:
        """Rows of dicts per image (pandas-free xyxy frame equivalent)."""
        out = []
        for det in self.xyxy:
            rows = []
            for x1, y1, x2, y2, conf, cls in det:
                c = int(cls)
                rows.append({
                    "xmin": float(x1), "ymin": float(y1),
                    "xmax": float(x2), "ymax": float(y2),
                    "confidence": float(conf), "class": c,
                    "name": self.names[c] if c < len(self.names) else str(c),
                })
            out.append(rows)
        return out

    def save(self, save_dir: str | Path = "runs/hub"):
        save_dir = Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        for i, det in enumerate(self.xyxy):
            lines = [" ".join(f"{v:.6g}" for v in row) for row in det]
            (save_dir / f"image{i}.txt").write_text("\n".join(lines) + "\n")
        return save_dir


class AutoShape:
    """Robust-input wrapper: images in -> Detections out. The port's model
    holds its weights, so it takes the ``RepYOLO`` alone (the JAX class
    takes (model, variables))."""

    def __init__(self, model: RepYOLO, *, size: int = 640,
                 conf: float = 0.25, iou: float = 0.45,
                 names: Sequence[str] = ("item",), max_det: int = 300,
                 tta: bool = False):
        self.model = model
        self.size = size
        self.conf = conf
        self.iou = iou
        self.names = tuple(names)
        self.max_det = max_det
        self.tta = tta

    @torch.inference_mode()
    def _infer(self, x: torch.Tensor, tta: bool):
        pred = (self.model.predict_tta(x) if tta
                else self.model.predict(x))
        return non_max_suppression(
            pred.float(), self.conf, self.iou, max_det=self.max_det,
            max_nms=1024, nc=self.model.cfg.nc)

    @staticmethod
    def _to_numpy_image(im) -> np.ndarray:
        if isinstance(im, (str, Path)):
            from rep_yolo_tpu_torch.data.datasets import read_image

            return read_image(str(im))
        arr = np.asarray(im)
        if arr.ndim == 2:
            arr = arr[..., None].repeat(3, -1)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32)
        return arr

    def __call__(self, images) -> Detections:
        if not isinstance(images, (list, tuple)):
            images = [images]
        arrs = [self._to_numpy_image(im) for im in images]
        shapes = [a.shape[:2] for a in arrs]
        boxed = [letterbox_np(a, self.size) for a in arrs]
        batch = np.stack([b[0] for b in boxed])
        ratios = [b[1] for b in boxed]
        pads = [b[2] for b in boxed]

        x = torch.from_numpy(np.asarray(batch / 255.0, np.float32))
        det = self._infer(x.to(self.model.device), self.tta)
        boxes, scores, classes, valid = (
            t.cpu().numpy() for t in (det.boxes, det.scores, det.classes,
                                      det.valid))

        out = []
        for i in range(len(arrs)):
            m = valid[i]
            b = boxes[i][m]
            (dw, dh), r = pads[i], ratios[i]
            b[:, [0, 2]] = (b[:, [0, 2]] - dw) / r
            b[:, [1, 3]] = (b[:, [1, 3]] - dh) / r
            h, w = shapes[i]
            b[:, [0, 2]] = b[:, [0, 2]].clip(0, w)
            b[:, [1, 3]] = b[:, [1, 3]].clip(0, h)
            out.append(np.concatenate(
                [b, scores[i][m, None], classes[i][m, None].astype(np.float32)],
                axis=1))
        return Detections(out, self.names, shapes)


class EnsembleModel:
    """NMS-ensemble of models: concat decoded predictions then one NMS
    (reference models/experimental.py:69-83). Members are ``RepYOLO``
    models (each holds its weights)."""

    def __init__(self, members: Sequence[RepYOLO]):
        assert members, "empty ensemble"
        self.members = list(members)
        self.cfg = self.members[0].cfg

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([m.predict(x) for m in self.members], 1)


def nms_module(conf: float = 0.25, iou: float = 0.45, max_det: int = 300):
    """The reference NMS module (models/common.py:868-878) as a function."""
    def run(pred):
        return non_max_suppression(pred, conf, iou, max_det=max_det)
    return run


def load(cfg: str = "cfg/rep_yolo.yaml", ckpt: str | None = None, *,
         nc: int | None = None, fuse: bool = True, size: int = 640,
         conf: float = 0.25, iou: float = 0.45,
         names: Sequence[str] = ("person",), autoshape: bool = True,
         rng: int = 0, device=None):
    """Build (and optionally restore) a model on ``device`` (the card by
    default); returns AutoShape by default (reference hubconf.create,
    hubconf.py:22-60), else the ``RepYOLO``. ``ckpt``: a checkpoint ``.npz``
    of either package, a ``TrainState`` (its EMA weights) or a variables
    tree (``train.checkpoint.read_weights``); without one, the port's
    seeded init from ``rng`` (not the JAX ``PRNGKey(rng)``'s draws)."""
    from rep_yolo_tpu_torch.device import resolve_device
    from rep_yolo_tpu_torch.train.checkpoint import read_weights

    model = RepYOLO.from_config(cfg, nc=nc, device=resolve_device(device))
    if ckpt is not None:
        model.load_state(read_weights(ckpt))
    else:
        model.init(torch.Generator().manual_seed(rng))
    if fuse:
        model = model.fuse()
    if autoshape:
        return AutoShape(model, size=size, conf=conf, iou=iou, names=names)
    return model


create = load  # reference hubconf naming
custom = functools.partial(load, fuse=True)  # reference hubconf.custom
