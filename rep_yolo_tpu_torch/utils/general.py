"""General utilities (port of ``rep_yolo_tpu/utils/general.py``'s
``check_img_size``, ``increment_path`` and the image-weight helpers)."""

from __future__ import annotations

import glob
import math
import re
from pathlib import Path

import numpy as np


def check_img_size(img_size: int, s: int = 32) -> int:
    """Round img_size up to a multiple of stride s
    (reference utils/general.py:123-129)."""
    new_size = int(math.ceil(img_size / s) * s)
    if new_size != img_size:
        print(f"WARNING: --img-size {img_size} must be multiple of "
              f"max stride {s}, updating to {new_size}")
    return new_size


def increment_path(path: str | Path, exist_ok: bool = False) -> Path:
    """runs/exp -> runs/exp{2,3,...} (reference utils/general.py:1227-1237)."""
    path = Path(path)
    if not path.exists() or exist_ok:
        return path
    dirs = glob.glob(f"{path}*")
    matches = [re.search(rf"{re.escape(path.name)}(\d+)", Path(d).name)
               for d in dirs]
    i = [int(m.group(1)) for m in matches if m]
    n = max(i) + 1 if i else 2
    return Path(f"{path}{n}")


def labels_to_class_weights(labels_list, nc: int = 1) -> np.ndarray:
    """Inverse-frequency class weights, normalized to sum 1; a class with
    no label counts once (reference utils/general.py:188-204)."""
    classes = np.concatenate(
        [lab[:, 0].astype(int) for lab in labels_list if len(lab)]) \
        if labels_list else np.zeros(0, int)
    weights = np.bincount(classes, minlength=nc).astype(np.float64)
    weights[weights == 0] = 1
    weights = 1.0 / weights
    return weights / weights.sum()


def labels_to_image_weights(labels_list, nc: int = 1,
                            class_weights=None) -> np.ndarray:
    """Each image's sampling weight: its label count per class times the
    class weights, summed (reference utils/general.py:207-213, the
    image-weights resampling of reference train.py:324-335)."""
    if class_weights is None:
        class_weights = np.ones(nc)
    counts = np.array([
        np.bincount(lab[:, 0].astype(int), minlength=nc) if len(lab)
        else np.zeros(nc) for lab in labels_list])
    return (counts * class_weights.reshape(1, nc)).sum(1)
