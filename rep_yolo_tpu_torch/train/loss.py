"""Training objectives: the classic YOLO loss and the simOTA loss, on
fixed-shape targets.

Port of ``rep_yolo_tpu/train/loss.py`` (``compute_loss``,
``compute_loss_ota``; the aux and bin losses are not ported yet):

- targets are (B, M, 5) [cls, x, y, w, h] (normalized xywh) with a (B, M)
  validity mask;
- ``find_3_positive``'s neighbour expansion is a dense (B, M, na, 5)
  candidate lattice with masks;
- simOTA's dynamic-k selection takes k argmax-and-mask passes
  (``_topk_iter``, lowest index first on ties), over candidates flattened
  (B, M, na, 5) per level and the levels concatenated, exactly as the JAX
  package orders them: costs of neighbouring cells are often exactly
  equal, so the tie order decides the match (``torch.topk``'s is not
  specified);
- the classic loss adds the (1 - iou) box term twice, a reference quirk
  (reference utils/loss.py:473,475).

Head maps are (B, H, W, na, no); candidates index [b, gj, gi, a]. The
objectness targets are written with one scatter over the candidates; where
two candidates write one cell, which value stays is unspecified (as in the
JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from rep_yolo_tpu_torch.ops.boxes import bbox_iou, box_iou, xywh2xyxy


@dataclasses.dataclass(frozen=True)
class LossConfig:
    nc: int = 1
    box_gain: float = 0.05
    obj_gain: float = 0.7
    cls_gain: float = 0.3
    cls_pw: float = 1.0
    obj_pw: float = 1.0
    anchor_t: float = 4.0
    gr: float = 1.0                 # obj-iou ratio (train.py sets model.gr=1.0)
    fl_gamma: float = 0.0
    label_smoothing: float = 0.0
    balance: tuple = (4.0, 1.0, 0.4)   # P3-P5 (reference utils/loss.py:442)

    @property
    def cp(self) -> float:
        return 1.0 - 0.5 * self.label_smoothing

    @property
    def cn(self) -> float:
        return 0.5 * self.label_smoothing


def _topk_iter(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis by k argmax-and-mask passes; on ties the
    lowest index comes first (``argmax`` returns the first maximum), as in
    the JAX package's ``_topk_iter`` and ``lax.top_k``."""
    vals, idxs = [], []
    iota = torch.arange(x.shape[-1], device=x.device)
    for _ in range(k):
        i = torch.argmax(x, -1)
        vals.append(torch.amax(x, -1))
        idxs.append(i)
        x = torch.where(iota == i[..., None], -torch.inf, x)
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def balance_for(nl: int) -> tuple:
    """Per-level objectness balance (reference utils/loss.py:442)."""
    if nl == 3:
        return (4.0, 1.0, 0.4)
    return tuple([4.0, 1.0, 0.25, 0.06, 0.02][:nl])


def bce_with_logits(x, z, pos_weight: float = 1.0):
    """Elementwise BCEWithLogits with pos_weight (torch semantics)."""
    return pos_weight * z * F.softplus(-x) + (1.0 - z) * F.softplus(x)


def focal_bce(x, z, gamma: float, pos_weight: float = 1.0,
              alpha: float = 0.25):
    """FocalLoss (reference utils/loss.py:121-148), without the mean."""
    loss = bce_with_logits(x, z, pos_weight)
    p = torch.sigmoid(x)
    p_t = z * p + (1 - z) * (1 - p)
    alpha_factor = z * alpha + (1 - z) * (1 - alpha)
    return loss * alpha_factor * (1.0 - p_t) ** gamma


def _obj_bce(x, z, cfg: LossConfig):
    if cfg.fl_gamma > 0:
        return focal_bce(x, z, cfg.fl_gamma, cfg.obj_pw)
    return bce_with_logits(x, z, cfg.obj_pw)


def _cls_bce(x, z, cfg: LossConfig):
    if cfg.fl_gamma > 0:
        return focal_bce(x, z, cfg.fl_gamma, cfg.cls_pw)
    return bce_with_logits(x, z, cfg.cls_pw)


def masked_mean(x, mask):
    m = mask.to(x.dtype)
    return (x * m).sum() / torch.clamp(m.sum(), min=1.0)


class Candidates(NamedTuple):
    """Dense per-level candidate lattice, all (B, M, na, 5)."""
    gi: torch.Tensor       # grid x index (int64, clamped)
    gj: torch.Tensor       # grid y index
    valid: torch.Tensor    # bool
    txy: torch.Tensor      # target xy in grid units (..., 2)
    twh: torch.Tensor      # target wh in grid units (..., 2)
    anchor: torch.Tensor   # (na, 2) stride-normalized anchors of the level


# 5-offset stencil (reference utils/loss.py:515-518): centre, +x, +y, -x, -y
_OFF = ((0., 0.), (0.5, 0.), (0., 0.5), (-0.5, 0.), (0., -0.5))


def find_3_positive(targets: torch.Tensor, tmask: torch.Tensor,
                    shape_hw: tuple[int, int], anchors: torch.Tensor,
                    anchor_t: float, g: float = 0.5) -> Candidates:
    """Reference ``find_3_positive`` (utils/loss.py:801-852) for one level:
    targets (B, M, 5) normalized, anchors (na, 2) in grid units."""
    H, W = shape_hw
    dev = targets.device
    na = anchors.shape[0]
    gain = torch.tensor([W, H, W, H], dtype=torch.float32, device=dev)
    txywh = targets[..., 1:5] * gain
    gxy, gwh = txywh[..., :2], txywh[..., 2:]

    r = gwh[:, :, None, :] / anchors[None, None]             # (B, M, na, 2)
    ratio_ok = torch.amax(torch.maximum(r, 1.0 / r), -1) < anchor_t
    base_valid = tmask[:, :, None] & ratio_ok

    gxi = gain[:2] - gxy
    jj = (gxy[..., 0] % 1.0 < g) & (gxy[..., 0] > 1.0)
    kk = (gxy[..., 1] % 1.0 < g) & (gxy[..., 1] > 1.0)
    ll = (gxi[..., 0] % 1.0 < g) & (gxi[..., 0] > 1.0)
    mm = (gxi[..., 1] % 1.0 < g) & (gxi[..., 1] > 1.0)
    off_ok = torch.stack([torch.ones_like(jj), jj, kk, ll, mm], -1)

    valid = base_valid[..., None] & off_ok[:, :, None, :]     # (B, M, na, 5)
    B, Mt = tmask.shape
    off = torch.tensor(_OFF, dtype=torch.float32, device=dev)
    gij = torch.floor(gxy[:, :, None, None, :] - (2.0 * g) * off)
    gij = gij.expand(B, Mt, na, 5, 2)
    gi = torch.clamp(gij[..., 0].long(), 0, W - 1)
    gj = torch.clamp(gij[..., 1].long(), 0, H - 1)
    txy = gxy[:, :, None, None, :].expand(gij.shape)
    twh = gwh[:, :, None, None, :].expand(gij.shape)
    return Candidates(gi=gi, gj=gj, valid=valid, txy=txy, twh=twh,
                      anchor=anchors)


def _gather_preds(pi: torch.Tensor, gi, gj):
    """pi (B, H, W, na, no); gi, gj (B, M, na, 5) -> (B, M, na, 5, no)."""
    B, _, _, na, _ = pi.shape
    b = torch.arange(B, device=pi.device)[:, None, None, None]
    a = torch.arange(na, device=pi.device)[None, None, :, None]
    return pi[b, gj, gi, a]


def _scatter_obj(shape, gi, gj, a, b, valid, values, like):
    """Zeros of ``shape`` (B, H, W, na) with ``values`` written at the valid
    [b, gj, gi, a]."""
    tobj = torch.zeros(shape, dtype=like.dtype, device=like.device)
    b, gj, gi, a = (t.expand(valid.shape)[valid] for t in (b, gj, gi, a))
    tobj[b, gj, gi, a] = values.expand(valid.shape)[valid].to(like.dtype)
    return tobj


def compute_loss(preds: Sequence[torch.Tensor], targets: torch.Tensor,
                 tmask: torch.Tensor, anchors_grid, cfg: LossConfig):
    """Classic YOLO loss (reference utils/loss.py:450-504). Returns
    (total * B, {box, obj, cls, total})."""
    B = preds[0].shape[0]
    dev = preds[0].device
    anchors_grid = torch.as_tensor(anchors_grid, dtype=torch.float32,
                                   device=dev)
    lbox = lobj = lcls = torch.zeros((), device=dev)
    for i, pi in enumerate(preds):
        H, W, na = pi.shape[1], pi.shape[2], pi.shape[3]
        cand = find_3_positive(targets, tmask, (H, W), anchors_grid[i],
                               cfg.anchor_t)
        ps = _gather_preds(pi, cand.gi, cand.gj)               # (B,M,na,5,no)

        gij = torch.stack([cand.gi, cand.gj], -1).float()
        pxy = torch.sigmoid(ps[..., 0:2]) * 2.0 - 0.5
        pwh = ((torch.sigmoid(ps[..., 2:4]) * 2.0) ** 2
               * cand.anchor[None, None, :, None, :])
        pbox = torch.cat([pxy, pwh], -1)
        tbox = torch.cat([cand.txy - gij, cand.twh], -1)
        iou = bbox_iou(pbox, tbox, xywh=True, CIoU=True)
        # reference quirk: the (1 - iou) term is added twice
        lbox = lbox + 2.0 * masked_mean(1.0 - iou, cand.valid)

        obj_val = (1.0 - cfg.gr) + cfg.gr * torch.clamp(iou.detach(), min=0)
        b = torch.arange(B, device=dev)[:, None, None, None]
        a = torch.arange(na, device=dev)[None, None, :, None]
        tobj = _scatter_obj(pi.shape[:4], cand.gi, cand.gj, a, b, cand.valid,
                            obj_val, pi)
        lobj = lobj + _obj_bce(pi[..., 4], tobj, cfg).mean() * cfg.balance[i]

        if cfg.nc > 1:
            onehot = F.one_hot(targets[..., 0].long(), cfg.nc).to(pi.dtype)
            t = cfg.cn + (cfg.cp - cfg.cn) * onehot[:, :, None, None, :]
            ce = _cls_bce(ps[..., 5:], t.expand(ps[..., 5:].shape),
                          cfg).mean(-1)
            lcls = lcls + masked_mean(ce, cand.valid) * cfg.nc

    return _finish(lbox, lobj, lcls, cfg, B)


def _finish(lbox, lobj, lcls, cfg: LossConfig, B: int):
    lbox = lbox * cfg.box_gain
    lobj = lobj * cfg.obj_gain
    lcls = lcls * cfg.cls_gain
    total = lbox + lobj + lcls
    return total * B, {"box": lbox, "obj": lobj, "cls": lcls, "total": total}


# ---------------------------------------------------------------------------
# simOTA
# ---------------------------------------------------------------------------

@torch.no_grad()
def _ota_match(targets, tmask, cands: Sequence[Candidates],
               preds: Sequence[torch.Tensor], strides, img_size: int,
               cfg: LossConfig, top_candidates: int = 10):
    """simOTA matching (reference utils/loss.py:644-799). Returns, per level,
    (fg mask (B, C_l), matched target index (B, C_l)), C_l = M * na * 5
    candidates in (M, na, 5) order."""
    B, M = tmask.shape
    dev = targets.device
    per_level = []
    for i, (pi, cand) in enumerate(zip(preds, cands)):
        ps = _gather_preds(pi, cand.gi, cand.gj)              # (B,M,na,5,no)
        C = M * cand.gi.shape[2] * 5
        gij = torch.stack([cand.gi, cand.gj], -1).float()
        pxy = (torch.sigmoid(ps[..., :2]) * 2.0 - 0.5 + gij) * strides[i]
        pwh = ((torch.sigmoid(ps[..., 2:4]) * 2.0) ** 2
               * cand.anchor[None, None, :, None, :] * strides[i])
        pxyxy = xywh2xyxy(torch.cat([pxy, pwh], -1)).reshape(B, C, 4)
        per_level.append((pxyxy, ps[..., 4:5].reshape(B, C, 1),
                          ps[..., 5:].reshape(B, C, cfg.nc),
                          cand.valid.reshape(B, C)))

    pxyxy = torch.cat([p[0] for p in per_level], 1)                # (B, C, 4)
    p_obj = torch.cat([p[1] for p in per_level], 1)
    p_cls = torch.cat([p[2] for p in per_level], 1)
    valid = torch.cat([p[3] for p in per_level], 1)                # (B, C)
    C = pxyxy.shape[1]

    txyxy = xywh2xyxy(targets[..., 1:5] * img_size)                # (B, M, 4)
    pair_mask = tmask[:, :, None] & valid[:, None, :]
    pair_iou = torch.where(pair_mask, box_iou(txyxy, pxyxy), 0.0)  # (B, M, C)
    iou_loss = -torch.log(pair_iou + 1e-8)

    k_top = min(top_candidates, C)
    topk_iou, _ = _topk_iter(pair_iou, k_top)
    dynamic_ks = torch.clamp(topk_iou.sum(-1).int(), min=1)       # (B, M)

    gt_onehot = F.one_hot(targets[..., 0].long(), cfg.nc).float()
    y = torch.sqrt(torch.sigmoid(p_cls) * torch.sigmoid(p_obj))
    y = torch.clamp(y, 1e-7, 1.0 - 1e-7)
    logit_y = torch.log(y / (1.0 - y))                            # (B, C, nc)
    pair_cls_loss = bce_with_logits(logit_y[:, None],
                                    gt_onehot[:, :, None]).sum(-1)
    cost = pair_cls_loss + 3.0 * iou_loss
    INF = 1e9
    cost = torch.where(pair_mask, cost, INF)

    # candidate j matched to gt i iff its cost is among the k_i smallest of
    # row i, ties to the lowest index (reference topk(largest=False))
    _, sel_idx = _topk_iter(-cost, k_top)                         # (B, M, k)
    sel_on = torch.arange(k_top, device=dev)[None, None, :] \
        < dynamic_ks[..., None]
    matching = ((sel_idx[..., None] == torch.arange(C, device=dev))
                & sel_on[..., None]).any(-2)
    matching = matching & pair_mask

    # a candidate matched to several targets keeps its least-cost one
    col_counts = matching.sum(1)                                  # (B, C)
    argmin_gt = torch.argmin(torch.where(matching, cost, INF), 1)  # (B, C)
    keep_row = F.one_hot(argmin_gt, M).bool().transpose(1, 2)     # (B, M, C)
    matching = torch.where((col_counts > 1)[:, None, :], matching & keep_row,
                           matching)

    fg = matching.any(1)                                          # (B, C)
    matched_gt = torch.argmax(matching.to(torch.uint8), 1)        # (B, C)
    out, start = [], 0
    for pxyxy_l, *_ in per_level:
        c = pxyxy_l.shape[1]
        out.append((fg[:, start:start + c], matched_gt[:, start:start + c]))
        start += c
    return out


def _level_loss(pi, cand: Candidates, fg, mgt, targets, cfg: LossConfig,
                balance: float):
    """One level's OTA box, objectness and class losses."""
    B, H, W, na = pi.shape[:4]
    C = fg.shape[1]
    dev = pi.device
    gi = cand.gi.reshape(B, C)
    gj = cand.gj.reshape(B, C)
    a = torch.arange(na, device=dev)[:, None].expand(
        cand.valid.shape[1:]).reshape(1, C).expand(B, C)
    anchor = cand.anchor[a.reshape(-1)].reshape(B, C, 2)
    b_idx = torch.arange(B, device=dev)[:, None].expand(B, C)
    ps = pi[b_idx, gj, gi, a]                                     # (B, C, no)

    gain = torch.tensor([W, H, W, H], dtype=torch.float32, device=dev)
    t_sel = torch.gather(targets, 1, mgt[..., None].expand(B, C, 5))
    tbox = t_sel[..., 1:5] * gain
    grid = torch.stack([gi, gj], -1).float()
    tbox = torch.cat([tbox[..., :2] - grid, tbox[..., 2:]], -1)

    pxy = torch.sigmoid(ps[..., :2]) * 2.0 - 0.5
    pwh = (torch.sigmoid(ps[..., 2:4]) * 2.0) ** 2 * anchor
    iou = bbox_iou(torch.cat([pxy, pwh], -1), tbox, xywh=True, CIoU=True)
    lbox = masked_mean(1.0 - iou, fg)

    obj_val = (1.0 - cfg.gr) + cfg.gr * torch.clamp(iou.detach(), min=0)
    tobj = _scatter_obj(pi.shape[:4], gi, gj, a, b_idx, fg, obj_val, pi)
    lobj = _obj_bce(pi[..., 4], tobj, cfg).mean() * balance

    lcls = torch.zeros((), device=dev)
    if cfg.nc > 1:
        onehot = F.one_hot(t_sel[..., 0].long(), cfg.nc).to(pi.dtype)
        t = cfg.cn + (cfg.cp - cfg.cn) * onehot
        ce = _cls_bce(ps[..., 5:], t, cfg).mean(-1)
        lcls = masked_mean(ce, fg) * cfg.nc
    return lbox, lobj, lcls


def compute_loss_ota(preds: Sequence[torch.Tensor], targets: torch.Tensor,
                     tmask: torch.Tensor, anchors_grid, strides,
                     img_size: int, cfg: LossConfig):
    """simOTA loss (reference utils/loss.py:588-642). preds: (B, H, W, na,
    no) maps; targets (B, M, 5) normalized; img_size in pixels. Returns
    (total * B, {box, obj, cls, total})."""
    B = tmask.shape[0]
    dev = preds[0].device
    anchors_grid = torch.as_tensor(anchors_grid, dtype=torch.float32,
                                   device=dev)
    cands = [find_3_positive(targets, tmask, (p.shape[1], p.shape[2]),
                             anchors_grid[i], cfg.anchor_t)
             for i, p in enumerate(preds)]
    matches = _ota_match(targets, tmask, cands, preds, strides, img_size, cfg)
    lbox = lobj = lcls = torch.zeros((), device=dev)
    for i, (pi, cand) in enumerate(zip(preds, cands)):
        lb, lo, lc = _level_loss(pi, cand, *matches[i], targets, cfg,
                                 cfg.balance[i])
        lbox, lobj, lcls = lbox + lb, lobj + lo, lcls + lc
    return _finish(lbox, lobj, lcls, cfg, B)
