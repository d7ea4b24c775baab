"""Evaluation CLI (port of ``rep_yolo_tpu/cli/test.py``, the reference
test.py:288-352): mAP over a dataset with the eval NMS settings, a
``--task speed`` mode (fixed 0.25 / 0.45 thresholds, reference
test.py:335-337) and a ``--task study`` resolution sweep.

Example (the card; ``--device cpu`` and ``cfg/rep_yolo_tiny_test.yaml`` with
``--img-size 64`` on a machine without one):
    python -m rep_yolo_tpu_torch.cli.test --weights runs/train/exp/best \\
        --data <dir of images/ and labels/> --rect --fast int8

``--weights`` is a checkpoint of either package in the ``.npz`` form
(``train/checkpoint.py``); its EMA weights are scored. ``--fast int8``
calibrates on the first 8 images, as the JAX CLI does, and runs the int8
region (``--dw5-exact``: GSConv's depthwise 5x5 on K12's float32 weights
instead of K7's int8 ones, the JAX ``set_dw5_dense(False)``). ``--no-fuse``
scores the train-form model, whose attention runs on K2 on the card.
``--plots-dir`` defaults to '' here (the JAX CLI writes plots to
runs/test): the plots need ``utils/plots.py``, which is not ported yet, so
a non-empty value raises. Like ``serve.build_engine``, the card runs with
TF32 off and cuDNN's deterministic algorithms. The printed JSON holds the
kernel launches of the evaluation (``launches``; none on the CPU).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser("rep-yolo-tpu-torch test")
    p.add_argument("--weights", default=None)
    p.add_argument("--cfg", default="cfg/rep_yolo.yaml")
    p.add_argument("--data", required=True,
                   help="dataset dir (YOLO layout), .txt list or YAML")
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--conf-thres", type=float, default=0.001)
    p.add_argument("--iou-thres", type=float, default=0.65)
    p.add_argument("--nc", type=int, default=1)
    p.add_argument("--task", default="val",
                   choices=["val", "test", "speed", "study"])
    p.add_argument("--save-json", default=None,
                   help="write COCO-format detections to this path")
    p.add_argument("--coco-gt", default=None,
                   help="COCO GT annotations json: run the pycocotools "
                        "cross-check")
    p.add_argument("--verbose", action="store_true",
                   help="per-class P/R/AP table")
    p.add_argument("--no-fuse", action="store_true")
    p.add_argument("--fast", default=None, choices=["int8"],
                   help="calibrate on the first 8 images and run the int8 "
                        "region")
    p.add_argument("--dw5-exact", action="store_true",
                   help="with --fast int8: the depthwise 5x5 on K12 "
                        "(float32 weights) instead of K7")
    p.add_argument("--rect", action="store_true",
                   help="aspect-bucketed rectangular eval batches")
    p.add_argument("--rect-stride", type=int, default=64)
    p.add_argument("--plots-dir", default="",
                   help="not ported yet: '' (the default) or it raises")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    return p.parse_args(argv)


def calibration_images(ds, img_size: int, dev, n: int = 8) -> torch.Tensor:
    """The first ``n`` images of ``ds``, letterboxed at ``img_size`` on
    ``dev``: the batch the int8 modes calibrate on."""
    from rep_yolo_tpu_torch.data.letterbox import letterbox_batch

    items = [ds.load_item(i) for i in range(min(n, len(ds)))]
    cal, _, _ = letterbox_batch(
        torch.from_numpy(np.stack([it[0] for it in items])).to(dev),
        torch.from_numpy(np.stack([it[1] for it in items])).to(dev),
        img_size)
    return cal


def calibrate_int8(model, ds, img_size: int, dw5_dense: bool = True,
                   n: int = 8):
    """Calibrate on ``calibration_images`` (the first ``n``) and switch the
    fused model to the int8 region (``ops.quant.enable_int8_fast_path``),
    as the JAX CLI does for ``--fast int8``. Returns the scales."""
    from rep_yolo_tpu_torch.ops.quant import enable_int8_fast_path

    return enable_int8_fast_path(
        model, calibration_images(ds, img_size, model.device, n),
        dw5_dense=dw5_dense)


def main(argv=None):
    args = parse_args(argv)
    from rep_yolo_tpu_torch.cli.detect import load_model_and_vars
    from rep_yolo_tpu_torch.data.datasets import (DetectionDataset,
                                                  load_dataset_spec)
    from rep_yolo_tpu_torch.device import resolve_device
    from rep_yolo_tpu_torch.ops.kernels import launch_counts
    from rep_yolo_tpu_torch.train.evaluate import coco_eval, evaluate

    if args.plots_dir:
        raise NotImplementedError("--plots-dir: evaluation plots need "
                                  "utils/plots.py, which is not ported to "
                                  "rep_yolo_tpu_torch yet")
    if args.dw5_exact and (args.fast != "int8" or args.no_fuse
                           or args.task == "study"):
        raise ValueError("--dw5-exact picks the int8 region's depthwise "
                         "kernel: it needs --fast int8 on the fused model, "
                         "and --task study runs no int8 region")
    if resolve_device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    if args.task == "speed":   # reference test.py:335-337
        args.conf_thres, args.iou_thres = 0.25, 0.45

    # dataset YAML: resolves nc/names/split paths BEFORE the model is
    # built (nc shapes the head)
    names = None
    data_path = args.data
    if data_path.endswith((".yaml", ".yml")):
        spec = load_dataset_spec(data_path)
        args.nc = spec["nc"]
        names = spec["names"] or None
        data_path = (spec["test"] if args.task == "test" and spec["test"]
                     else spec["val"])

    model = load_model_and_vars(args)

    if args.task == "study":   # resolution sweep (reference test.py:339-352)
        rows = []
        for sz in range(256, 1536 + 128, 128):
            ds = DetectionDataset.from_path(data_path, sz, args.nc)
            res = evaluate(model, ds, batch_size=args.batch_size,
                           img_size=sz, conf_thres=args.conf_thres,
                           iou_thres=args.iou_thres)
            rows.append([sz, res.mp, res.mr, res.map50, res.map,
                         res.speed_ms[0], res.speed_ms[1]])
            print(f"study @{sz}px: mAP50={res.map50:.4f} "
                  f"mAP={res.map:.4f} {res.speed_ms[0]:.1f} ms/img")
        out_file = Path(f"study_{Path(args.data).name}.txt")
        out_file.write_text("\n".join(
            " ".join(f"{v:.6g}" for v in r) for r in rows) + "\n")
        print(f"saved {out_file}")
        return rows

    ds = DetectionDataset.from_path(data_path, args.img_size, args.nc)
    if args.fast == "int8" and not args.no_fuse:
        calibrate_int8(model, ds, args.img_size,
                       dw5_dense=not args.dw5_exact)
    before = launch_counts()
    res = evaluate(model, ds, batch_size=args.batch_size,
                   img_size=args.img_size, conf_thres=args.conf_thres,
                   iou_thres=args.iou_thres, save_json=args.save_json,
                   rect=args.rect, rect_stride=args.rect_stride)
    out = dict(P=res.mp, R=res.mr, map50=res.map50, map=res.map,
               fitness=res.fitness,
               ms_per_img_infer=res.speed_ms[0],
               ms_per_img_total=res.speed_ms[1],
               launches={k: n - before[k] for k, n in launch_counts().items()
                         if n > before[k]})
    if args.verbose and res.per_class:
        print(f"{'class':>12} {'P':>8} {'R':>8} {'AP50':>8} {'AP':>8}")
        for c, d in sorted(res.per_class.items()):
            label = names[c] if names and 0 <= c < len(names) else str(c)
            print(f"{label:>12} {d['p']:8.3f} {d['r']:8.3f} "
                  f"{d['ap50']:8.3f} {d['ap']:8.3f}")
    if args.save_json and args.coco_gt:
        try:
            out["coco_map"], out["coco_map50"] = coco_eval(
                args.save_json, args.coco_gt)
        except ImportError:
            print("pycocotools not available; skipping COCO cross-check")
    print(json.dumps(out, indent=2))
    return res


if __name__ == "__main__":
    main()
