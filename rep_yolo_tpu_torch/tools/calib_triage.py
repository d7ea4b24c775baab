"""Where the int8 modes' loss to float32 comes from, for one checkpoint.

    python -m rep_yolo_tpu_torch.tools.calib_triage \
        --weights runs/train/demo/best --val-data synthetic:128

Scores ``fused_f32`` and the three int8 modes of ``tools/eval_modes``
(``int8_k7``, ``int8_k12``, ``xla_q8``) on the synthetic val set (the
generator at seed + 1) over a grid of:

- the images scored: the set's JPEG files (written beside the checkpoint
  and read back, as ``cli.train`` and ``eval_modes`` do), or its pixels in
  memory, never written (as ``eval_modes`` scored before the port trained
  from files);
- the images the int8 modes calibrate on: the same two;
- how many: the first 8 (the CLIs' count) or the first 64.

One JSON line a cell: the scored set, the calibration set and count, and
each int8 mode's P, R, mAP@.5, mAP@.5:.95 with its gaps to ``fused_f32``
on the same scored set. Takes ``eval_modes``' arguments; runs on the card
unless ``--device cpu``.
"""

from __future__ import annotations

import itertools
import json
from pathlib import Path

import torch

from rep_yolo_tpu_torch.tools import eval_modes as EM

INT8_MODES = ("int8_k7", "int8_k12", "xla_q8")
SETS = ("files", "memory")
CALIB_COUNTS = (8, 64)


def main(argv=None) -> list[dict]:
    from rep_yolo_tpu_torch.cli.train import _synthetic_n
    from rep_yolo_tpu_torch.data.datasets import make_synthetic_dataset
    from rep_yolo_tpu_torch.device import resolve_device
    from rep_yolo_tpu_torch.train.checkpoint import read_weights

    args = EM.parse_args(argv)
    if not args.val_data.startswith("synthetic"):
        raise ValueError("calib_triage compares a synthetic set's files "
                         "with its pixels: --val-data synthetic[:N]")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    n = _synthetic_n(args.val_data)
    sets = {name: make_synthetic_dataset(
        n, args.img_size, args.nc, args.max_labels, seed=args.seed + 1,
        root=Path(args.weights).parent / "synthetic_val"
        if name == "files" else None) for name in SETS}
    weights = read_weights(args.weights)
    rows = []
    with torch.inference_mode():
        base = {name: EM.score_modes(weights, ds, args.cfg, args.img_size,
                                     args.batch_size, dev, args.nc,
                                     modes=("fused_f32",))["fused_f32"]
                for name, ds in sets.items()}
        for scored, calib, k in itertools.product(SETS, SETS, CALIB_COUNTS):
            got = EM.score_modes(weights, sets[scored], args.cfg,
                                 args.img_size, args.batch_size, dev,
                                 args.nc, modes=INT8_MODES,
                                 calib=sets[calib], calib_n=k)
            got["fused_f32"] = base[scored]
            row = {"scored": scored, "calibrated_on": calib,
                   "calib_images": k,
                   "modes": {m: {s: got[m][s] for s in EM.SCORES}
                             for m in ("fused_f32", *INT8_MODES)},
                   "gaps_to_fused_f32": EM.gaps(got)}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
