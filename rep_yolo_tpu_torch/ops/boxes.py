"""Box geometry (port of rep_yolo_tpu/ops/boxes.py, the part NMS needs)."""

from __future__ import annotations

import torch

from rep_yolo_tpu_torch.ops.kernels.nms import box_iou

__all__ = ["xywh2xyxy", "box_iou"]


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) [xc, yc, w, h] -> [x1, y1, x2, y2]."""
    xc, yc, w, h = x.unbind(-1)
    return torch.stack([xc - w / 2, yc - h / 2, xc + w / 2, yc + h / 2], -1)
