"""Batched, class-aware, fixed-shape NMS.

Port of ``rep_yolo_tpu/ops/nms.py:non_max_suppression`` (reference
utils/general.py:953-1045 semantics): objectness gate, nc == 1 score
shortcut, multi-label or best-class candidates, top-``max_nms`` prefilter,
class offset ``MAX_WH``, exact greedy suppression, optional merge, and
fixed ``(B, max_det)`` outputs with a validity mask.

Suppression backends (``method=``):
- ``"kernel"``: ``ops.kernels.nms.nms_keep`` — the CUDA kernel on the card
  (K <= 8192, evaluation's ``max_nms``); on CPU tensors its plain version.
  The default on CUDA.
- ``"matrix"``: the plain fixed-point version (any device, any K).
- ``"greedy"``: a literal greedy loop, the parity oracle.
``"auto"`` is ``"kernel"`` on CUDA, else ``"matrix"`` (``"greedy"`` above
``MATRIX_MAX_K`` candidates, where the K x K matrix grows large).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rep_yolo_tpu_torch.ops.boxes import xywh2xyxy
from rep_yolo_tpu_torch.ops.kernels import nms as K_nms

MAX_WH = 4096.0  # class-offset multiplier (reference utils/general.py:965)
MATRIX_MAX_K = 4096  # "auto" on the CPU: the matrix version up to this K


class Detections(NamedTuple):
    boxes: torch.Tensor    # (B, max_det, 4) xyxy
    scores: torch.Tensor   # (B, max_det)
    classes: torch.Tensor  # (B, max_det) int32
    valid: torch.Tensor    # (B, max_det) bool
    count: torch.Tensor    # (B,) int32


def _greedy_keep(boxes: torch.Tensor, valid: torch.Tensor,
                 iou_thres: float) -> torch.Tensor:
    """Literal greedy NMS per image over score-desc slots: pick the first
    alive candidate, kill every candidate with !(IoU <= thr)."""
    keep = torch.zeros_like(valid)
    for b in range(boxes.shape[0]):
        alive = valid[b].clone()
        while bool(alive.any()):
            i = int(torch.nonzero(alive)[0])
            keep[b, i] = True
            iou = K_nms.box_iou(boxes[b, i][None, None], boxes[b][None])
            alive &= iou[0, 0] <= iou_thres
            alive[i] = False
    return keep


def _resolve_method(method: str, k: int, device: torch.device) -> str:
    if method != "auto":
        return method
    if device.type == "cuda":
        return "kernel"
    return "matrix" if k <= MATRIX_MAX_K else "greedy"


def non_max_suppression(prediction: torch.Tensor, conf_thres: float = 0.25,
                        iou_thres: float = 0.45, *, max_det: int = 300,
                        max_nms: int = 4096, multi_label: bool = False,
                        agnostic: bool = False, nc: int | None = None,
                        method: str = "auto", merge: bool = False,
                        presorted: bool = False) -> Detections:
    """prediction: (B, N, 5+nc) decoded [xc, yc, w, h, obj, cls...].

    presorted=True (nc == 1 serving path): rows are already
    score-descending with the conf gate applied upstream
    (``heads.decode_topk(conf_thres=...)``), so the candidate top-k is
    skipped. merge=True: each kept box becomes the score-weighted mean of
    the candidates overlapping it above ``iou_thres``."""
    B, N, no = prediction.shape
    nc = no - 5 if nc is None else nc
    multi_label = multi_label and nc > 1
    if presorted and (nc != 1 or multi_label):
        raise ValueError("presorted NMS requires nc == 1")
    dev = prediction.device
    pred = prediction.float()
    k = N if presorted else min(max_nms, N * nc if multi_label else N)
    method = _resolve_method(method, k, dev)
    ninf = torch.tensor(-float("inf"), device=dev)

    if presorted:
        sel_box = xywh2xyxy(pred[..., :4])
        scores = pred[..., 4]
        top_scores = torch.where(scores > conf_thres, scores, ninf)
        sel_cls = torch.zeros_like(scores)
        nms_boxes = sel_box
    else:
        box = xywh2xyxy(pred[..., :4])                        # (B,N,4)
        obj = pred[..., 4]
        scores = obj[..., None] if nc == 1 else pred[..., 5:] * obj[..., None]
        if multi_label:
            flat = scores.reshape(B, -1)                      # (B, N*nc)
            cand = (flat > conf_thres) & (obj > conf_thres).repeat_interleave(
                nc, dim=1)
            cls_idx = torch.arange(nc, device=dev).repeat(N)
            box_idx = torch.arange(N, device=dev).repeat_interleave(nc)
        else:
            flat, cls_idx = scores.max(-1)
            cand = (flat > conf_thres) & (obj > conf_thres)
            box_idx = torch.arange(N, device=dev)
        masked = torch.where(cand, flat, ninf)
        # sorted desc, ties lower index first, as jax.lax.top_k (torch.topk
        # leaves the order of equal scores open)
        top_scores, top_i = torch.sort(masked, dim=1, descending=True,
                                       stable=True)
        top_scores, top_i = top_scores[:, :k], top_i[:, :k]
        bi = box_idx[top_i]
        sel_box = torch.gather(box, 1, bi[..., None].expand(-1, -1, 4))
        ci = cls_idx[top_i] if multi_label else torch.gather(cls_idx, 1, top_i)
        sel_cls = ci.float()
        offset = torch.zeros_like(sel_cls) if agnostic else sel_cls * MAX_WH
        nms_boxes = sel_box + offset[..., None]
    cand_valid = top_scores > -float("inf")

    if method == "kernel":
        keep = K_nms.nms_keep(nms_boxes, cand_valid, float(iou_thres))
    elif method == "matrix":
        keep = K_nms.nms_keep_plain(nms_boxes, cand_valid, float(iou_thres))
    elif method == "greedy":
        keep = _greedy_keep(nms_boxes, cand_valid, float(iou_thres))
    else:
        raise ValueError(f"unknown NMS method {method!r}")

    # fixed-shape selection: slots are score-descending, so the first
    # max_det kept slots (in slot order) ARE the greedy selections in order
    if k < max_det:
        pad = max_det - k
        keep = torch.nn.functional.pad(keep, (0, pad))
        top_scores = torch.nn.functional.pad(top_scores, (0, pad),
                                             value=-float("inf"))
        sel_box = torch.nn.functional.pad(sel_box, (0, 0, 0, pad))
        sel_cls = torch.nn.functional.pad(sel_cls, (0, pad))
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    idx = order[:, :max_det]
    ok = torch.gather(keep, 1, idx)
    vals = torch.gather(top_scores, 1, idx)
    out_boxes = torch.gather(sel_box, 1, idx[..., None].expand(-1, -1, 4))
    if merge:
        sel_nms = torch.gather(nms_boxes, 1,
                               idx.clamp(max=k - 1)[..., None].expand(-1, -1, 4))
        iou = K_nms.box_iou(sel_nms, nms_boxes)               # (B, D, k)
        wgt = (iou > iou_thres).float() * torch.where(
            cand_valid, top_scores, torch.zeros_like(top_scores))[:, None, :]
        denom = wgt.sum(-1, keepdim=True).clamp(min=1e-9)
        out_boxes = torch.einsum("bdk,bkc->bdc", wgt, sel_box[:, :k]) / denom
    zero = torch.zeros((), device=dev)
    out_boxes = torch.where(ok[..., None], out_boxes, zero)
    out_scores = torch.where(ok, vals, zero)
    out_cls = torch.where(ok, torch.gather(sel_cls, 1, idx).to(torch.int32),
                          torch.full_like(idx, -1, dtype=torch.int32))
    return Detections(out_boxes, out_scores, out_cls, ok,
                      ok.sum(1).to(torch.int32))


def detections_to_numpy(det: Detections) -> list[np.ndarray]:
    """Per-image (n, 6) [x1, y1, x2, y2, conf, cls] arrays."""
    boxes, scores, classes, valid = (t.detach().cpu().numpy() for t in
                                     (det.boxes, det.scores, det.classes,
                                      det.valid))
    return [np.concatenate([boxes[b][m], scores[b][m, None],
                            classes[b][m, None].astype(np.float32)], 1)
            for b, m in enumerate(valid)]
