"""Relaunch unfinished training runs with ``--resume`` (port of
``tools/resume_daemon.py``).

Scans ``<root>/*/last.json`` for runs whose saved epoch is short of their
``opt.json``'s ``--epochs`` and relaunches each as ``python -m
rep_yolo_tpu_torch.cli.train --resume <run>/last`` with the argument list
the JAX daemon builds. That list carries ``--data``, ``--cfg``,
``--epochs``, ``--batch-size``, ``--img-size``, ``--project`` and
``--name`` alone: a relaunched run takes the CLI's defaults for every
other flag (``--hyp``, ``--val-data``, ``--eval-every``, ...), as under the
JAX daemon.

Usage (e.g. from a boot-time systemd unit or cron):
  python -m rep_yolo_tpu_torch.tools.resume_daemon --root runs/train [--once]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def find_unfinished(root: Path) -> list[tuple[Path, dict]]:
    out = []
    for meta_path in sorted(root.glob("*/last.json")):
        run_dir = meta_path.parent
        try:
            meta = json.loads(meta_path.read_text())
            opt = json.loads((run_dir / "opt.json").read_text())
        except (OSError, ValueError):
            continue
        if meta.get("epoch", 0) + 1 < opt.get("epochs", 0):
            out.append((run_dir, opt))
    return out


def relaunch_cmd(run_dir: Path, opt: dict) -> list[str]:
    return [sys.executable, "-m", "rep_yolo_tpu_torch.cli.train",
            "--resume", str(run_dir / "last"),
            "--data", opt["data"], "--cfg", opt["cfg"],
            "--epochs", str(opt["epochs"]),
            "--batch-size", str(opt["batch_size"]),
            "--img-size", str(opt["img_size"]),
            "--project", str(run_dir.parent), "--name", run_dir.name]


def relaunch(run_dir: Path, opt: dict) -> int:
    cmd = relaunch_cmd(run_dir, opt)
    print("relaunch:", " ".join(cmd))
    return subprocess.call(cmd)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", default="runs/train")
    p.add_argument("--interval", type=float, default=300.0)
    p.add_argument("--once", action="store_true")
    args = p.parse_args(argv)

    while True:
        for run_dir, opt in find_unfinished(Path(args.root)):
            relaunch(run_dir, opt)
        if args.once:
            break
        time.sleep(args.interval)


if __name__ == "__main__":
    main()
