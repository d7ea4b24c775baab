"""Training logs (port of ``rep_yolo_tpu/utils/logger.py``): TensorBoard
scalars where ``torch.utils.tensorboard`` imports, always a ``metrics.csv``,
and JSON snapshots of a run's settings (``hyp.json``).

The CSV writer is the JAX package's, quirk included: its columns are fixed
by the first row written, and a later row's other keys are dropped
(``extrasaction="ignore"``). ``cli.train`` logs the four ``train/*`` scalars
first, so its ``val/*`` rows come out as the step alone (``2,,,,``), as in
the JAX demo run's ``metrics.csv``.
"""

from __future__ import annotations

import csv
import json
import sys
import types
from pathlib import Path
from typing import Mapping


class RunLogger:
    def __init__(self, log_dir: str | Path, wandb_project: str | None = None):
        if wandb_project:
            raise NotImplementedError("wandb_project: logging to Weights & "
                                      "Biases is not ported to "
                                      "rep_yolo_tpu_torch yet")
        self.dir = Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._csv_path = self.dir / "metrics.csv"
        self._csv_fields: list[str] | None = None
        try:
            writer = self._writer_class()
        except ImportError:
            self._tb = None
        else:
            self._tb = writer(log_dir=str(self.dir / "tb"))

    @staticmethod
    def _writer_class():
        """``torch.utils.tensorboard.SummaryWriter`` on TensorBoard's own
        stub of TensorFlow: the scalars' event files need no TensorFlow,
        whose import takes ~15 s where it is installed. The stub is
        TensorBoard's switch (``tensorboard.compat.notf``); a process that
        has imported TensorFlow keeps it."""
        import tensorboard.compat  # noqa: F401  (ImportError: no TensorBoard)

        if "tensorflow" not in sys.modules:
            sys.modules.setdefault("tensorboard.compat.notf",
                                   types.ModuleType("tensorboard.compat.notf"))
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter

    def log_scalars(self, step: int, scalars: Mapping[str, float]):
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)
        row = {"step": step, **{k: float(v) for k, v in scalars.items()}}
        write_header = not self._csv_path.exists() or self._csv_fields is None
        if self._csv_fields is None:
            self._csv_fields = list(row.keys())
        with open(self._csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._csv_fields,
                               extrasaction="ignore")
            if write_header and f.tell() == 0:
                w.writeheader()
            w.writerow(row)

    def log_config(self, name: str, cfg: dict):
        (self.dir / f"{name}.json").write_text(json.dumps(cfg, indent=2,
                                                          default=str))

    def close(self):
        if self._tb is not None:
            self._tb.close()
