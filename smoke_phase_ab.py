#!/usr/bin/env python3
"""Time the CLI and evaluation phases of ``chip_smoke.py`` on one card,
for an A/B of their depth between two trees.

Run it with the tree to time as the working directory: this checkout, or
another commit's ``git archive`` unpacked into a gitignored directory
(its own ``chip_smoke.py`` and ``rep_yolo_tpu_torch/`` are the ones
imported and run):

    python3 smoke_phase_ab.py                       # this tree
    (cd _chipcheck/parent && python3 ../../smoke_phase_ab.py)

It builds the kernels, then runs that tree's ``train_cli`` (plain and
``--hyp scratch.p5``), ``loader_native``, ``train_cli_files``,
``eval_train_cli``, ``eval_modes``, ``test_cli`` and ``train_resume``
phases in ``chip_smoke.py``'s order, with their gates, and prints one
JSON line: each phase's seconds, their sum without ``loader_native``
(which both trees run alike) and the total. Run the two trees in one call
on one card, in turns.
"""

import json
import pathlib
import sys
import time

ROOT = pathlib.Path.cwd()
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("smoke_phase_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        cs.phase_device_build(torch)
    secs = {}

    def timed(name, fn, *a, **k):
        t = time.perf_counter()
        out = fn(*a, **k)
        secs[name] = time.perf_counter() - t
        return out

    # as chip_smoke.py's training phases run: cuDNN picks its algorithms
    torch.backends.cudnn.deterministic = False
    timed("train_cli", cs.phase_train_cli, torch)
    timed("train_cli_augment", cs.phase_train_cli, torch, hyp="scratch.p5")
    ds = timed("loader_native", cs.phase_loader_native, torch)
    timed("train_cli_files", cs.phase_train_cli_files, torch, dev, ds)
    run = timed("eval_train_cli", cs.phase_eval_train_cli, torch)
    with torch.inference_mode():
        timed("eval_modes", cs.phase_eval_modes, torch, dev, run)
        timed("test_cli", cs.phase_test_cli, torch, dev, run)
    timed("train_resume", cs.phase_train_resume, torch, run)
    print(json.dumps({"tree": str(ROOT), "seconds": secs,
                      "phases_s": sum(v for k, v in secs.items()
                                      if k != "loader_native"),
                      "total_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
