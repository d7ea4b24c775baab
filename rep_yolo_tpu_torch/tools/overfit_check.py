"""End-to-end learning check (port of ``tools/overfit_check.py``): overfit
one synthetic box and check that the detector finds its location through
``predict`` and NMS.

The loss can fall while localization is broken, so a loss-only overfit
check does not see it. Here the tiny graph at 64 px trains on one batch of
two identical images, each a bright box at pixels x 35-55, y 13-38 on a
grey canvas (label (0.7, 0.4, 0.3, 0.4), M = 8 label slots), for 2000
steps of simOTA with lr0 0.01; then the train-form model in ``eval()``
predicts image 0 and NMS (conf 0.25, IoU 0.45, ``max_nms`` 256) keeps its
boxes. The JAX tool reports ``[34.8, 13.7, 54.3, 38.4] @ conf 0.91``.

Ends with one JSON line: the top box, its confidence, its IoU with the
drawn box, the steps, the seconds and ``ok``: IoU >= 0.8 and confidence >=
0.5 (the exit code is 1 if not). Runs on the card unless ``--device cpu``.

Usage: python -m rep_yolo_tpu_torch.tools.overfit_check [--steps 2000]
    [--seed 0]   (the model's init seed; the JAX tool's is 0)
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

S, BSZ, M, STEPS = 64, 2, 8, 2000
BOX = (35.0, 13.0, 55.0, 38.0)     # the drawn box, pixels x0, y0, x1, y1
MIN_IOU, MIN_CONF = 0.8, 0.5
TINY = str(pathlib.Path(__file__).resolve().parents[2] / "cfg"
           / "rep_yolo_tiny_test.yaml")


def batch(dev: torch.device):
    """(images, hw, labels, mask) of the one training batch: float 0-255
    canvases (the loader's contract), the box in every image."""
    imgs = np.full((BSZ, S, S, 3), 0.3 * 255, np.float32)
    imgs[:, 13:38, 35:55] = 255.0
    labels = np.zeros((BSZ, M, 5), np.float32)
    labels[:, 0] = [0, 0.7, 0.4, 0.3, 0.4]
    mask = np.zeros((BSZ, M), bool)
    mask[:, 0] = True
    hw = np.full((BSZ, 2), S, np.float32)
    return [torch.from_numpy(a).to(dev) for a in (imgs, hw, labels, mask)]


def box_iou(a, b) -> float:
    """IoU of two x0, y0, x1, y1 boxes."""
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    area = lambda r: (r[2] - r[0]) * (r[3] - r[1])  # noqa: E731
    return float(inter / (area(a) + area(b) - inter))


def run(steps: int = STEPS, device=None, log=print, seed: int = 0) -> dict:
    """Train ``steps`` steps from the init of ``seed``, then detect;
    returns the JSON line's dict."""
    from rep_yolo_tpu_torch.device import resolve_device
    from rep_yolo_tpu_torch.models.model import RepYOLO
    from rep_yolo_tpu_torch.ops.nms import (detections_to_numpy,
                                            non_max_suppression)
    from rep_yolo_tpu_torch.train import optim as optim_lib
    from rep_yolo_tpu_torch.train.loss import LossConfig
    from rep_yolo_tpu_torch.train.trainer import (create_train_state,
                                                  make_train_step)

    dev = resolve_device(device)
    model = RepYOLO.from_config(TINY, nc=1, device=dev)
    model.init(torch.Generator().manual_seed(seed))
    opt_cfg = optim_lib.OptimConfig(lr0=0.01, epochs=steps, nb=1)
    step = make_train_step(model, LossConfig(nc=1), opt_cfg, S,
                           loss_mode="ota")
    state = create_train_state(model, seed=1)
    imgs, hw, labels, mask = batch(dev)
    t0 = time.perf_counter()
    first = last = None
    for i in range(steps):
        total = step(state, imgs, hw, labels, mask)["total"]
        if i % 500 == 0 or i == steps - 1:
            last = float(total)
            first = last if first is None else first
            log(f"step {i}: loss {last:.4f}")
    model.net.eval()
    pred = model.predict(imgs * (1.0 / 255.0))
    det = detections_to_numpy(non_max_suppression(pred, 0.25, 0.45,
                                                  max_nms=256))[0]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    top = det[0] if len(det) else None
    iou = box_iou(top[:4], BOX) if top is not None else 0.0
    conf = float(top[4]) if top is not None else 0.0
    return {"box": None if top is None else [float(v) for v in top[:4]],
            "conf": conf, "iou": iou, "expected_box": list(BOX),
            "detections": len(det), "first_loss": first, "last_loss": last,
            "steps": steps, "seed": seed, "seconds": secs,
            "device": str(dev),
            "ok": iou >= MIN_IOU and conf >= MIN_CONF}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("rep-yolo-tpu-torch overfit_check")
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--seed", type=int, default=0,
                   help="the model's init seed")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    out = run(args.steps, args.device, seed=args.seed)
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
