"""Evaluation metrics: AP per class, confusion matrix, fitness.

The port's own numpy copy of ``rep_yolo_tpu/utils/metrics.py`` (the port
imports nothing of the JAX package), the same code line for line, so it
gives the same bits on the same arrays: 101-point COCO interpolated AP with
the precision envelope (reference utils/metrics.py:18-106), fitness =
0.1*mAP50 + 0.9*mAP (reference :12-15), and the greedy IoU TP-matching of
test.py's eval loop (reference test.py:176-210).
"""

from __future__ import annotations

import numpy as np


def fitness(p, r, map50, map_):
    """Weighted fitness (reference utils/metrics.py:12-15)."""
    return 0.1 * map50 + 0.9 * map_


def compute_ap(recall: np.ndarray, precision: np.ndarray):
    """101-point interpolated AP (reference utils/metrics.py:81-106)."""
    mrec = np.concatenate(([0.0], recall, [recall[-1] + 0.01]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(x, mrec, mpre), x) if hasattr(np, "trapezoid") \
        else np.trapz(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def ap_per_class(tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray,
                 target_cls: np.ndarray, return_curves: bool = False):
    """Per-class P, R, AP, F1 (reference utils/metrics.py:18-78).

    tp: (n, n_iou) bool/0-1 TP matrix; conf: (n,); pred_cls: (n,);
    target_cls: (m,). Returns (p, r, ap, f1, unique_classes) where p/r/f1
    are at the max-F1 confidence and ap is (nc, n_iou). With
    return_curves a dict of the underlying curves is appended —
    px/p/r/f1 over the confidence grid and py = per-class precision over
    the recall grid at IoU 0.5 (what the reference's plot path feeds to
    plot_pr_curve/plot_mc_curve, utils/metrics.py:71-75).
    """
    i = np.argsort(-conf)
    tp, conf, pred_cls = tp[i], conf[i], pred_cls[i]

    unique_classes = np.unique(target_cls)
    nc = unique_classes.shape[0]
    n_iou = tp.shape[1] if tp.ndim > 1 else 1
    tp = tp.reshape(-1, n_iou)

    px = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, n_iou))
    p = np.zeros((nc, 1000))
    r = np.zeros((nc, 1000))
    py = np.zeros((nc, 101))
    rec_grid = np.linspace(0, 1, 101)
    for ci, c in enumerate(unique_classes):
        sel = pred_cls == c
        n_l = (target_cls == c).sum()
        n_p = sel.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[sel]).cumsum(0)
        tpc = tp[sel].cumsum(0)
        recall = tpc / (n_l + 1e-16)
        r[ci] = np.interp(-px, -conf[sel], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p[ci] = np.interp(-px, -conf[sel], precision[:, 0], left=1)
        for j in range(n_iou):
            ap[ci, j], mpre, mrec = compute_ap(recall[:, j],
                                               precision[:, j])
            if j == 0:
                py[ci] = np.interp(rec_grid, mrec, mpre)

    f1 = 2 * p * r / (p + r + 1e-16)
    i = f1.mean(0).argmax()
    out = (p[:, i], r[:, i], ap, f1[:, i], unique_classes.astype(np.int32))
    if return_curves:
        return out + (dict(px=px, p=p, r=r, f1=f1,
                           rec_grid=rec_grid, py=py),)
    return out


def match_predictions(pred: np.ndarray, labels: np.ndarray,
                      iouv: np.ndarray) -> np.ndarray:
    """Greedy per-image TP matching across IoU thresholds
    (reference test.py:176-210 semantics).

    pred: (n, 6) [x1,y1,x2,y2,conf,cls]; labels: (m, 5) [cls,x1,y1,x2,y2];
    iouv: (n_iou,) thresholds. Returns (n, n_iou) bool.
    """
    correct = np.zeros((pred.shape[0], iouv.shape[0]), bool)
    if labels.shape[0] == 0 or pred.shape[0] == 0:
        return correct
    detected = set()
    tcls = labels[:, 0]
    tbox = labels[:, 1:5]
    iou_all = _box_iou_np(tbox, pred[:, :4])          # (m, n)
    for cls in np.unique(tcls):
        ti = np.flatnonzero(tcls == cls)
        pi = np.flatnonzero(pred[:, 5] == cls)
        if pi.size == 0:
            continue
        ious = iou_all[np.ix_(ti, pi)]                # (t, p)
        best_gt = ious.argmax(0)                      # per prediction
        best_iou = ious.max(0)
        # iterate predictions in their (confidence-sorted) order, exactly
        # like the reference's nonzero() walk (test.py:199-209)
        for j in range(pi.size):
            if best_iou[j] <= iouv[0]:
                continue
            d = ti[best_gt[j]]
            if d not in detected:
                detected.add(d)
                correct[pi[j]] = best_iou[j] > iouv
                if len(detected) == len(ti):
                    break
    return correct


def _box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    area1 = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area2 = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[:, None] + area2[None] - inter + 1e-16)


class ConfusionMatrix:
    """Detection confusion matrix (reference utils/metrics.py:109-158)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections: np.ndarray, labels: np.ndarray):
        detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int)
        det_classes = detections[:, 5].astype(int)
        iou = _box_iou_np(labels[:, 1:], detections[:, :4])

        xi, xj = np.nonzero(iou > self.iou_thres)
        if xi.shape[0]:
            matches = np.stack([xi, xj, iou[xi, xj]], axis=1)
            if xi.shape[0] > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        else:
            matches = np.zeros((0, 3))

        n = matches.shape[0] > 0
        m0, m1, _ = matches.T.astype(np.int16)
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and j.sum() == 1:
                self.matrix[gc, det_classes[m1[j]][0]] += 1
            else:
                self.matrix[self.nc, gc] += 1
        if n:
            for i in range(det_classes.shape[0]):
                if not (m1 == i).any():
                    self.matrix[det_classes[i], self.nc] += 1
