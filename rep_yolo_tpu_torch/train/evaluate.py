"""mAP evaluation loop (port of ``rep_yolo_tpu/train/evaluate.py``, the
reference test.py:21-285).

Device side: letterbox -> forward (``model.predict``: the fused, int8,
bfloat16 or unfused train-form model) -> class-aware multi-label NMS (conf
0.001, IoU 0.65, ``max_nms`` 8192, ``max_det`` 300; on the card K3 takes all
8192 candidates). Host side: coordinate scale-back, greedy IoU TP-matching
over 10 thresholds, AP aggregation (``utils/metrics.py``), in the JAX
package's float32 arithmetic. The loop is pipelined as the JAX one: batch
k + 1 is dispatched before batch k's detections are matched on the host,
and on the card batch k's detections come back by a non-blocking copy that
waits on its own event, so the host matches while the device runs.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from rep_yolo_tpu_torch.data.datasets import Loader, collate
from rep_yolo_tpu_torch.data.letterbox import letterbox_batch
from rep_yolo_tpu_torch.ops.nms import non_max_suppression
from rep_yolo_tpu_torch.utils.metrics import (ap_per_class, fitness,
                                              match_predictions)


@dataclasses.dataclass
class EvalResult:
    mp: float
    mr: float
    map50: float
    map: float
    per_class: dict
    speed_ms: tuple      # (inference+nms ms/img, total ms/img)
    fitness: float


def _rect_plan(ds, batch_size: int, img_size: int, stride: int = 64,
               pad: float = 0.5):
    """Aspect-bucketed rect-eval batching (reference utils/datasets.py:
    424-446 + test.py:91 rect=True pad=0.5), as the JAX package plans it:
    images sorted by aspect ratio, each batch letterboxed to the smallest
    stride-multiple (h, w) canvas covering its aspect extremes, capped at
    img_size. Returns (order, per-batch shapes)."""
    ars = np.asarray([l_hw[0] / l_hw[1] for l_hw in ds.image_shapes()])
    order = np.argsort(ars, kind="stable")
    nb = -(-len(order) // batch_size)
    shapes = []
    for b in range(nb):
        ari = ars[order[b * batch_size:(b + 1) * batch_size]]
        mini, maxi = ari.min(), ari.max()
        sh, sw = 1.0, 1.0
        if maxi < 1:          # all wide: shrink height
            sh = maxi
        elif mini > 1:        # all tall: shrink width
            sw = 1 / mini
        bh = int(np.ceil(sh * img_size / stride + pad) * stride)
        bw = int(np.ceil(sw * img_size / stride + pad) * stride)
        shapes.append((min(bh, img_size), min(bw, img_size)))
    return order, shapes


def make_eval_step(model, img_size, conf_thres: float = 0.001,
                   iou_thres: float = 0.65, max_nms: int = 8192):
    """(uint8 padded batch, content hw) on the model's device ->
    (Detections in letterboxed pixels, ratio, pad). ``img_size``: int
    (square) or (h, w)."""

    def step(images: torch.Tensor, hw: torch.Tensor):
        imgs, ratio, pad = letterbox_batch(images, hw, img_size)
        pred = model.predict(imgs)
        det = non_max_suppression(pred, conf_thres, iou_thres, max_det=300,
                                  max_nms=max_nms, multi_label=True,
                                  nc=model.cfg.nc)
        return det, ratio, pad

    return torch.no_grad()(step)


class _Pending:
    """One batch's detections on their way to the host: on the card a
    non-blocking copy into pinned memory and the event after it."""

    def __init__(self, det, ratio, pad, batch):
        self.batch = batch
        tensors = (det.boxes, det.scores, det.classes, det.valid, ratio, pad)
        if det.boxes.is_cuda:
            self.host = [t.to("cpu", non_blocking=True) for t in tensors]
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = list(tensors), None

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
        boxes, scores, classes, valid, ratio, pad = (t.numpy()
                                                     for t in self.host)
        dets = [np.concatenate([boxes[b][m], scores[b][m, None],
                                classes[b][m, None].astype(np.float32)], 1)
                for b, m in enumerate(valid)]
        return dets, ratio, pad


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def evaluate(model, ds, batch_size: int = 8, img_size: int = 640,
             conf_thres: float = 0.001, iou_thres: float = 0.65,
             save_json: str | None = None, rect: bool = False,
             rect_stride: int = 64, plots_dir=None) -> EvalResult:
    """mAP of ``model`` (a ``RepYOLO`` holding its weights, on its device)
    over ``ds`` (``DetectionDataset`` or the in-memory synthetic one).
    ``save_json`` writes COCO-format detections ([x,y,w,h] boxes, image id
    from the file stem) for pycocotools (the reference's --save-json path,
    test.py:152-275). ``rect=True`` evaluates with aspect-bucketed
    rectangular batches (reference test.py:91). ``plots_dir`` needs
    ``utils/plots.py``, which is not ported yet: it raises.
    ``speed_ms``: host ms per image of (dispatch and the wait for the
    detections, the whole loop), after a ``torch.cuda.synchronize``."""
    if plots_dir:
        raise NotImplementedError("evaluation plots (plots_dir) need "
                                  "utils/plots.py, which is not ported to "
                                  "rep_yolo_tpu_torch yet")
    dev = model.device
    steps: dict = {}

    def get_step(shape):
        if shape not in steps:
            steps[shape] = make_eval_step(model, shape, conf_thres,
                                          iou_thres)
        return steps[shape]

    iouv = np.linspace(0.5, 0.95, 10)
    stats = []
    json_dets = [] if save_json else None
    # COCO GT uses category ids 1..90; map from our 0..79 training ids
    # when the class count says COCO (reference test.py:83,172 coco91class)
    cls_map = coco80_to_coco91() if model.cfg.nc == 80 else None
    t_inf = 0.0
    n_img = 0
    _sync(dev)
    t_total0 = time.perf_counter()

    def process(pending: _Pending):
        nonlocal t_inf
        t0 = time.perf_counter()
        dets, ratio, pad = pending.wait()    # the device's batch k is done
        t_inf += time.perf_counter() - t0
        batch = pending.batch
        n_valid = batch.get("n_valid", len(dets))
        for i, d in enumerate(dets[:n_valid]):
            # scale detections back to original frame
            r = ratio[i]
            pw, ph = pad[i]
            h0, w0 = batch["orig_shapes"][i]
            h, w = batch["hw"][i]
            # content (h,w) was itself a resize of (h0,w0) by r0
            r0 = h / h0
            if d.shape[0]:
                d = d.copy()
                d[:, [0, 2]] = (d[:, [0, 2]] - pw) / r / r0
                d[:, [1, 3]] = (d[:, [1, 3]] - ph) / r / r0
                d[:, [0, 2]] = d[:, [0, 2]].clip(0, w0)
                d[:, [1, 3]] = d[:, [1, 3]].clip(0, h0)
            # ground truth in original pixels
            m = batch["mask"][i]
            lab = batch["labels"][i][m]
            if lab.shape[0]:
                cx, cy, bw, bh = (lab[:, 1] * w0, lab[:, 2] * h0,
                                  lab[:, 3] * w0, lab[:, 4] * h0)
                gt = np.stack([lab[:, 0], cx - bw / 2, cy - bh / 2,
                               cx + bw / 2, cy + bh / 2], 1)
            else:
                gt = np.zeros((0, 5), np.float32)
            correct = match_predictions(d, gt, iouv)
            stats.append((correct, d[:, 4], d[:, 5], gt[:, 0]))
            if json_dets is not None:
                files = getattr(ds, "img_files", None)
                idx = int(batch["indices"][i])
                stem = Path(files[idx]).stem if files else str(idx)
                image_id = int(stem) if stem.isnumeric() else stem
                for x1, y1, x2, y2, score, cls in d:
                    json_dets.append({
                        "image_id": image_id,
                        "category_id": (cls_map[int(cls)] if cls_map
                                        else int(cls)),
                        "bbox": [round(float(x1), 3), round(float(y1), 3),
                                 round(float(x2 - x1), 3),
                                 round(float(y2 - y1), 3)],
                        "score": round(float(score), 5),
                    })

    if rect:
        # aspect-bucketed rect batches (tail batch padded by repeating
        # the last item; padded rows masked out of the stats)
        order, bshapes = _rect_plan(ds, batch_size, img_size, rect_stride)

        def batches():
            for b, shape in enumerate(bshapes):
                sel = order[b * batch_size:(b + 1) * batch_size]
                n_valid = len(sel)
                sel = np.concatenate(
                    [sel, np.repeat(sel[-1:], batch_size - n_valid)])
                out = collate([ds.load_item(i) for i in sel], sel)
                out.update(n_valid=n_valid, shape=shape)
                yield out
    else:
        def batches():
            yield from Loader(ds, batch_size, shuffle=False,
                              drop_last=False).epoch(0)

    # pipelined loop: dispatch batch k+1 (asynchronous on the card), then
    # host-match batch k while the device runs
    pending = None
    for batch in batches():
        step = get_step(batch.get("shape", img_size))
        t0 = time.perf_counter()
        det, ratio, pad = step(torch.from_numpy(batch["images"]).to(dev),
                               torch.from_numpy(batch["hw"]).to(dev))
        nxt = _Pending(det, ratio, pad, batch)
        t_inf += time.perf_counter() - t0
        n_img += batch.get("n_valid", batch["images"].shape[0])
        if pending is not None:
            process(pending)
        pending = nxt
    if pending is not None:
        process(pending)

    _sync(dev)
    t_total = time.perf_counter() - t_total0
    if stats:
        tp = np.concatenate([s[0] for s in stats])
        conf = np.concatenate([s[1] for s in stats])
        pcls = np.concatenate([s[2] for s in stats])
        tcls = np.concatenate([s[3] for s in stats])
    else:
        tp = np.zeros((0, 10))
        conf = pcls = tcls = np.zeros((0,))

    if tp.shape[0] and tcls.shape[0]:
        p, r, ap, f1, classes = ap_per_class(tp, conf, pcls, tcls)
        ap50, ap_all = ap[:, 0], ap.mean(1)
        mp, mr = p.mean(), r.mean()
        map50, map_ = ap50.mean(), ap_all.mean()
        per_class = {int(c): dict(p=float(p[i]), r=float(r[i]),
                                  ap50=float(ap50[i]), ap=float(ap_all[i]))
                     for i, c in enumerate(classes)}
    else:
        mp = mr = map50 = map_ = 0.0
        per_class = {}

    if json_dets is not None:
        p = Path(save_json)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(json_dets))

    return EvalResult(
        mp=float(mp), mr=float(mr), map50=float(map50), map=float(map_),
        per_class=per_class,
        speed_ms=(1000 * t_inf / max(n_img, 1),
                  1000 * t_total / max(n_img, 1)),
        fitness=float(fitness(mp, mr, map50, map_)),
    )


def coco80_to_coco91() -> list[int]:
    """Training-index (0..79) -> COCO91 category id (reference
    utils/general.py coco80_to_coco91_class)."""
    return [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19,
            20, 21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38,
            39, 40, 41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55,
            56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75,
            76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87, 88, 89, 90]


def coco_eval(pred_json: str, gt_json: str) -> tuple[float, float]:
    """pycocotools cross-check (reference test.py:253-275): returns
    (mAP@0.5:0.95, mAP@0.5). Requires pycocotools (ImportError without it)
    and a COCO GT json."""
    from pycocotools.coco import COCO
    from pycocotools.cocoeval import COCOeval

    gt = COCO(gt_json)
    dt = gt.loadRes(pred_json)
    ev = COCOeval(gt, dt, "bbox")
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    return float(ev.stats[0]), float(ev.stats[1])
