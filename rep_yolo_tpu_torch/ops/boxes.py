"""Box geometry (port of the parts of ``rep_yolo_tpu/ops/boxes.py`` that NMS,
the training losses and evaluation need). Same formulas and eps placement as
the JAX package (and the reference's ``utils/general.py``)."""

from __future__ import annotations

import math

import torch

from rep_yolo_tpu_torch.ops.kernels.nms import box_iou

__all__ = ["xywh2xyxy", "box_iou", "bbox_iou", "clip_coords", "scale_coords"]


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) [xc, yc, w, h] -> [x1, y1, x2, y2]."""
    xc, yc, w, h = x.unbind(-1)
    return torch.stack([xc - w / 2, yc - h / 2, xc + w / 2, yc + h / 2], -1)


def clip_coords(boxes: torch.Tensor,
                img_shape: tuple[int, int]) -> torch.Tensor:
    """Clip xyxy boxes to the image (height, width); returns a new
    tensor."""
    h, w = img_shape
    hi = torch.tensor([w, h, w, h], dtype=boxes.dtype, device=boxes.device)
    return torch.minimum(torch.clamp(boxes, min=0), hi)


def scale_coords(img1_shape: tuple[int, int], coords: torch.Tensor,
                 img0_shape: tuple[int, int], ratio_pad=None) -> torch.Tensor:
    """Rescale xyxy coords from the letterboxed ``img1_shape`` back to
    ``img0_shape`` (reference utils/general.py:319-332: gain = the smaller
    ratio, centred padding), then clip to the original image."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0],
                   img1_shape[1] / img0_shape[1])
        pad = ((img1_shape[1] - img0_shape[1] * gain) / 2,
               (img1_shape[0] - img0_shape[0] * gain) / 2)
    else:
        gain = ratio_pad[0][0]
        pad = ratio_pad[1]
    offset = torch.tensor([pad[0], pad[1], pad[0], pad[1]],
                          dtype=coords.dtype, device=coords.device)
    return clip_coords((coords - offset) / gain, img0_shape)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, *, xywh: bool = True,
             CIoU: bool = False, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU, or CIoU, of broadcastable (..., 4) boxes; eps added
    to h1, h2 and the union, and the CIoU weight ``v / (v - iou + 1 + eps)``
    held constant in the gradient, as in the reference."""
    if xywh:
        b1_x1, b1_x2 = box1[..., 0] - box1[..., 2] / 2, \
            box1[..., 0] + box1[..., 2] / 2
        b1_y1, b1_y2 = box1[..., 1] - box1[..., 3] / 2, \
            box1[..., 1] + box1[..., 3] / 2
        b2_x1, b2_x2 = box2[..., 0] - box2[..., 2] / 2, \
            box2[..., 0] + box2[..., 2] / 2
        b2_y1, b2_y2 = box2[..., 1] - box2[..., 3] / 2, \
            box2[..., 1] + box2[..., 3] / 2
    else:
        b1_x1, b1_y1, b1_x2, b1_y2 = box1.unbind(-1)
        b2_x1, b2_y1, b2_x2, b2_y2 = box2.unbind(-1)

    inter = (torch.clamp(torch.minimum(b1_x2, b2_x2)
                         - torch.maximum(b1_x1, b2_x1), min=0)
             * torch.clamp(torch.minimum(b1_y2, b2_y2)
                           - torch.maximum(b1_y1, b2_y1), min=0))
    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / (union + eps)
    if not CIoU:
        return iou
    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2
            + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha + eps)
