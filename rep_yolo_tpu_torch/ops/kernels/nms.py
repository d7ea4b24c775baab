"""Greedy-NMS keep mask: CUDA kernel + plain version.

Replaces ``rep_yolo_tpu/ops/pallas/nms_kernel.py:nms_keep_pallas`` (kernel
``_nms_kernel``). Source: ``csrc/nms.cu``: a 64-bit suppression bitmask of
the words on or right of each 64-row tile's diagonal (``mask_words``,
``tile_offset``: packed tile after tile, each tile row-major; then the
rows' valid bits), then one block per image scanning the row tiles in score
order, each tile one TMA bulk copy (a ring of ``STAGES``) resolved by a warp
from its diagonal words.

boxes ``(B, K, 4)`` f32 xyxy, score-descending per image with class
offsets applied; valid ``(B, K)`` bool. Returns keep ``(B, K)`` bool,
exactly greedy NMS. The plain version is the port of
``nms_keep_matrix_xla`` (the fixed point of
``keep <- valid & (keep @ M == 0)``). ``nms_keep`` goes through the custom
op ``rep_yolo_torch::nms_keep`` (``torch.library``): the kernel on CUDA
tensors, the plain version on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from rep_yolo_tpu_torch import device as D

LAUNCHES = {"nms_keep": 0}
MAX_K = 8192             # csrc/nms.cu: a ring of three 64 KB tiles at most
BITS = 64                # rows of a tile, columns of a mask word
STAGES = 3               # tiles in the scan's ring


def _lib():
    lib = D.load_kernel("nms")
    if not getattr(lib, "_typed", False):
        vp = ctypes.c_void_p
        lib.nms_keep.argtypes = [vp] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, vp]
        lib.nms_keep.restype = ctypes.c_int
        lib.nms_mask.argtypes = [vp] * 3 + [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_float, vp]
        lib.nms_mask.restype = ctypes.c_int
        lib.nms_scan.argtypes = [vp] * 2 + [ctypes.c_int] * 2 + [vp]
        lib.nms_scan.restype = ctypes.c_int
        lib.nms_mask_words.argtypes = [ctypes.c_int]
        lib.nms_mask_words.restype = ctypes.c_longlong
        lib.nms_scan_smem.argtypes = [ctypes.c_int]
        lib.nms_scan_smem.restype = ctypes.c_int
        lib._typed = True
    return lib


def words(K: int) -> int:
    """Mask words of a row, and row tiles of an image: ceil(K / 64)."""
    return -(-K // BITS)


def tile_offset(t: int, W: int) -> int:
    """Offset of row tile t in an image's packed mask, in words: tiles
    0..t-1 hold 64 (W - s) words each (the words s..W-1 of their rows)."""
    return BITS * (t * W - t * (t - 1) // 2)


def valid_words(W: int) -> int:
    """The valid bits' words after an image's tiles: a word a tile, padded
    to an even count (whole 16-byte copies)."""
    return W + W % 2


def mask_words(K: int) -> int:
    """Words of one image's packed mask (``csrc/nms.cu:nms_mask_words``):
    the tiles, then the valid bits."""
    W = words(K)
    return tile_offset(W, W) + valid_words(W)


def scan_smem(K: int) -> int:
    """Shared memory of the scan in bytes (``nms_scan_smem``): a ring of
    ``STAGES`` tiles of 64 x W words, the valid bits, the removed set (W
    words) and an mbarrier a stage."""
    W = words(K)
    return (STAGES * BITS * W + valid_words(W) + W + STAGES) * 8


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
    """Keep mask (``rep_yolo_torch::nms_keep``). CPU tensors take
    ``nms_keep_plain``; CUDA tensors launch the kernel (K <= MAX_K) or
    raise."""
    return torch.ops.rep_yolo_torch.nms_keep(boxes, valid, float(iou_thres))


def launch_nms_keep(boxes, valid, iou_thres):
    """K3's launch on CUDA tensors, the CUDA implementation of
    ``rep_yolo_torch::nms_keep``."""
    if boxes.device.type != "cuda" or valid.device != boxes.device:
        raise ValueError(f"nms_keep: expected CUDA tensors, got "
                         f"{boxes.device} / {valid.device}")
    B, K, four = boxes.shape
    if four != 4 or valid.shape != (B, K):
        raise ValueError(f"nms_keep: bad shapes {boxes.shape} {valid.shape}")
    if K > MAX_K:
        raise ValueError(f"nms_keep: K={K} exceeds {MAX_K}")
    boxes, valid_u8, mask, keep = _buffers(boxes, valid)
    err = _lib().nms_keep(D.ptr(boxes), D.ptr(valid_u8), D.ptr(mask),
                          D.ptr(keep), B, K, float(iou_thres),
                          D.stream_handle(boxes))
    D.check_launch("nms_keep", err)
    LAUNCHES["nms_keep"] += 1
    return keep.bool()


# the custom op: the kernel on CUDA tensors, the plain version on CPU
# tensors, the shape alone under torch.export's fake tensors
_nms_keep_op = torch.library.custom_op(
    "rep_yolo_torch::nms_keep", launch_nms_keep, mutates_args=(),
    device_types="cuda",
    schema="(Tensor boxes, Tensor valid, float iou_thres) -> Tensor")
_nms_keep_op.register_kernel("cpu", nms_keep_plain)
_nms_keep_op.register_fake(lambda boxes, valid, iou_thres: torch.empty(
    valid.shape, dtype=torch.bool, device=valid.device))


def _buffers(boxes, valid):
    B, K = valid.shape
    mask = torch.empty((B, mask_words(K)), device=boxes.device,
                       dtype=torch.int64)
    keep = torch.empty((B, K), device=boxes.device, dtype=torch.uint8)
    return (boxes.float().contiguous(), valid.to(torch.uint8).contiguous(),
            mask, keep)


def nms_stages(boxes: torch.Tensor, valid: torch.Tensor,
               iou_thres: float):
    """The mask kernel and the scan as two callables on CUDA tensors, for
    timing each apart; they launch what ``nms_keep`` launches and count
    nothing. Returns (mask_fn, scan_fn, keep): keep is the scan's output."""
    B, K = valid.shape
    boxes, valid_u8, mask, keep = _buffers(boxes, valid)
    lib, stream = _lib(), D.stream_handle(boxes)

    def mask_fn():
        D.check_launch("nms_mask", lib.nms_mask(
            D.ptr(boxes), D.ptr(valid_u8), D.ptr(mask), B, K,
            float(iou_thres), stream))

    def scan_fn():
        D.check_launch("nms_scan", lib.nms_scan(
            D.ptr(mask), D.ptr(keep), B, K, stream))

    return mask_fn, scan_fn, keep
