"""Greedy-NMS keep mask: CUDA kernel + plain version.

Replaces ``rep_yolo_tpu/ops/pallas/nms_kernel.py:nms_keep_pallas`` (kernel
``_nms_kernel``). Source: ``csrc/nms.cu`` (a 64-bit suppression bitmask per
row, then one warp per image scanning the rows in score order).

boxes ``(B, K, 4)`` f32 xyxy, score-descending per image with class
offsets applied; valid ``(B, K)`` bool. Returns keep ``(B, K)`` bool,
exactly greedy NMS. The plain version is the port of
``nms_keep_matrix_xla`` (the fixed point of
``keep <- valid & (keep @ M == 0)``).
"""

from __future__ import annotations

import ctypes

import torch

from rep_yolo_tpu_torch import device as D

LAUNCHES = {"nms_keep": 0}
MAX_K = 8192             # csrc/nms.cu: 4 mask words per lane


def _lib():
    lib = D.load_kernel("nms")
    if not getattr(lib, "_typed", False):
        vp = ctypes.c_void_p
        lib.nms_keep.argtypes = [vp] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, vp]
        lib.nms_keep.restype = ctypes.c_int
        lib._typed = True
    return lib


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., D, 4) x (..., K, 4) xyxy -> (..., D, K) IoU, iou[d, k] = inter /
    (area_d + area_k - inter) (the operation order the kernel
    reproduces)."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


def nms_keep_plain(boxes: torch.Tensor, valid: torch.Tensor,
                   iou_thres: float) -> torch.Tensor:
    """Fixed-point greedy NMS keep mask (any device, any K)."""
    boxes = boxes.float()
    K = boxes.shape[1]
    iou = box_iou(boxes, boxes)
    ids = torch.arange(K, device=boxes.device)
    later = ids[:, None] < ids[None, :]                  # M[a, b]: a before b
    m = ((~(iou <= iou_thres)) & later).float()          # NaN suppresses
    keep0 = valid.float()
    keep = keep0
    for _ in range(K + 1):
        hits = torch.bmm(keep[:, None, :], m)[:, 0]
        new = torch.where(hits > 0.5, torch.zeros_like(keep0), keep0)
        if torch.equal(new, keep):
            break
        keep = new
    return keep > 0.5


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor,
             iou_thres: float) -> torch.Tensor:
    """Keep mask. CPU tensors take ``nms_keep_plain``; CUDA tensors launch
    the kernel (K <= MAX_K) or raise."""
    if boxes.device.type == "cpu":
        return nms_keep_plain(boxes, valid, iou_thres)
    if boxes.device.type != "cuda" or valid.device != boxes.device:
        raise ValueError(f"nms_keep: expected CUDA tensors, got "
                         f"{boxes.device} / {valid.device}")
    B, K, four = boxes.shape
    if four != 4 or valid.shape != (B, K):
        raise ValueError(f"nms_keep: bad shapes {boxes.shape} {valid.shape}")
    if K > MAX_K:
        raise ValueError(f"nms_keep: K={K} exceeds {MAX_K}")
    boxes = boxes.float().contiguous()
    valid_u8 = valid.to(torch.uint8).contiguous()
    words = -(-K // 64)
    mask = torch.empty((B, K, words), device=boxes.device, dtype=torch.int64)
    keep = torch.empty((B, K), device=boxes.device, dtype=torch.uint8)
    err = _lib().nms_keep(D.ptr(boxes), D.ptr(valid_u8), D.ptr(mask),
                          D.ptr(keep), B, K, float(iou_thres),
                          D.stream_handle(boxes))
    D.check_launch("nms_keep", err)
    LAUNCHES["nms_keep"] += 1
    return keep.bool()
