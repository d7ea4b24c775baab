"""Score one checkpoint in every serving mode of the port.

    python -m rep_yolo_tpu_torch.tools.eval_modes \
        --weights runs/train/demo/best --val-data synthetic:128

The checkpoint's weights (a ``TrainState``'s EMA weights, or a variables
tree: ``train.checkpoint.read_weights``) are loaded into the cfg's model
(its anchors: a checkpoint carries none) and scored by
``train/evaluate.py`` on the validation set in each mode. ``--val-data
synthetic[:N]`` is written, as ``cli.train`` writes its own, into
``synthetic_val`` beside the checkpoint and read from there: a run's
``best`` is scored on the files its run scored.

- ``fused_f32``: the fused deploy model in float32 (K1 / K2, K3);
- ``unfused_row3``: the train-form model in ``eval()`` (K2 on row 3);
- ``bf16``: fused, cast to bfloat16 (the attention islands in float32);
- ``bf16_der_fast``: that, with the DER blocks on K10 / K11;
- ``int8_k7`` / ``int8_k12``: fused, calibrated on the first 8 images, the
  int8 region with GSConv's depthwise 5x5 on K7 / on K12;
- ``xla_q8``: fused, calibrated so, the DER blocks int8-resident on K4 / K5
  (``set_der_fast("xla_q8", scales=...)``).

One JSON line a mode: P, R, mAP@.5, mAP@.5:.95, host ms per image and the
kernel launches per forward (the counts zeroed before the evaluation and
read after it); then one line of each mode's gaps to ``fused_f32``. Runs
on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

MODES = ("fused_f32", "unfused_row3", "bf16", "bf16_der_fast", "int8_k7",
         "int8_k12", "xla_q8")
SCORES = ("P", "R", "map50", "map")


def parse_args(argv=None):
    p = argparse.ArgumentParser("rep-yolo-tpu-torch eval_modes")
    p.add_argument("--weights", required=True,
                   help="a checkpoint path (without .npz) of either package")
    p.add_argument("--cfg", default="cfg/rep_yolo.yaml")
    p.add_argument("--val-data", default="synthetic:128",
                   help="'synthetic[:N]' (the generator at seed + 1, as "
                        "cli.train's, written beside the checkpoint), a "
                        "YOLO-layout dir, a .txt list or a dataset YAML")
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--nc", type=int, default=1)
    p.add_argument("--max-labels", type=int, default=120)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    return p.parse_args(argv)


def mode_model(weights: dict, cfg: str, mode: str, val, img_size: int,
               dev: torch.device, nc: int = 1, calib=None,
               calib_n: int = 8):
    """The model of one mode on ``weights`` (a port state dict); the int8
    modes calibrate on the first ``calib_n`` images of ``calib`` (default
    ``val``)."""
    from rep_yolo_tpu_torch.cli.test import (calibrate_int8,
                                             calibration_images)
    from rep_yolo_tpu_torch.models.model import RepYOLO
    from rep_yolo_tpu_torch.ops.quant import calibrate

    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; the modes: {MODES}")
    cal = val if calib is None else calib
    model = RepYOLO.from_config(cfg, nc=nc, device=dev).load_state(weights)
    if mode == "unfused_row3":
        return model
    model = model.fuse()
    if mode in ("bf16", "bf16_der_fast"):
        model.cast(torch.bfloat16)
    if mode == "bf16_der_fast":
        model.net.set_der_fast("bf16")
    elif mode.startswith("int8"):
        calibrate_int8(model, cal, img_size, dw5_dense=mode == "int8_k7",
                       n=calib_n)
    elif mode == "xla_q8":
        scales = calibrate(model, [calibration_images(cal, img_size, dev,
                                                      calib_n)])
        model.net.set_der_fast("xla_q8", scales=scales)
    return model


def score_modes(weights: dict, val, cfg: str, img_size: int,
                batch_size: int, dev: torch.device, nc: int = 1,
                modes=MODES, calib=None,
                calib_n: int = 8) -> dict[str, dict]:
    """{mode: {P, R, map50, map, fitness, ms_per_img, seconds, launches,
    launches_per_forward}} of ``weights`` on ``val``, for each of
    ``modes``; ``calib`` / ``calib_n`` as ``mode_model``'s."""
    from rep_yolo_tpu_torch.ops.kernels import (launch_counts,
                                                reset_launch_counts)
    from rep_yolo_tpu_torch.train.evaluate import evaluate

    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda: None
    fwd = -(-len(val) // batch_size)
    rows = {}
    for mode in modes:
        model = mode_model(weights, cfg, mode, val, img_size, dev, nc,
                           calib, calib_n)
        sync()
        reset_launch_counts()
        t = time.perf_counter()
        res = evaluate(model, val, batch_size=batch_size, img_size=img_size)
        sync()
        secs = time.perf_counter() - t
        counts = launch_counts()
        if mode == "xla_q8" and model.net.der_fast_declined():
            raise ValueError(f"xla_q8: the calibration gave no scales for "
                             f"the DER blocks of layers "
                             f"{model.net.der_fast_declined()}")
        rows[mode] = {"P": res.mp, "R": res.mr, "map50": res.map50,
                      "map": res.map, "fitness": res.fitness,
                      "ms_per_img": list(res.speed_ms), "seconds": secs,
                      "launches": counts,
                      "launches_per_forward": {k: n / fwd for k, n in
                                               counts.items() if n}}
        del model
    return rows


def gaps(rows: dict[str, dict], base: str = "fused_f32") -> dict:
    """Each mode's scores minus ``base``'s."""
    return {m: {k: rows[m][k] - rows[base][k] for k in SCORES}
            for m in rows if m != base}


def main(argv=None) -> dict[str, dict]:
    from rep_yolo_tpu_torch.cli.train import build_val_set
    from rep_yolo_tpu_torch.device import resolve_device
    from rep_yolo_tpu_torch.train.checkpoint import read_weights

    args = parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # the settings serve.build_engine serves with
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    val = build_val_set(args, root=Path(args.weights).parent)
    print(json.dumps({"weights": args.weights, "val": args.val_data,
                      "images": len(val), "batch": args.batch_size,
                      "img_size": args.img_size, "device": str(dev),
                      "device_name": torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"}), flush=True)
    weights = read_weights(args.weights)
    with torch.inference_mode():
        rows = score_modes(weights, val, args.cfg, args.img_size,
                           args.batch_size, dev, args.nc)
    for mode, row in rows.items():
        print(json.dumps({"mode": mode, **{k: v for k, v in row.items()
                                           if k != "launches"}}), flush=True)
    print(json.dumps({"gaps_to_fused_f32": gaps(rows)}), flush=True)
    return rows


if __name__ == "__main__":
    main()
