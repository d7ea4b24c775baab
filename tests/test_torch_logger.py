"""The port's run logger (``rep_yolo_tpu_torch/utils/logger.py``) against the
JAX package's (``rep_yolo_tpu/utils/logger.py``), on the CPU.

Driven with the same calls, both write byte-identical ``metrics.csv`` and
``hyp.json``: the train CLI's pattern (the hyp snapshot, the four
``train/*`` scalars an epoch, the five ``val/*`` ones an evaluation, whose
columns the CSV drops as the JAX writer does), a second logger appending to
the same directory as a resumed run does, and a run whose first row is the
validation one.
"""

import numpy as np
import pytest

from rep_yolo_tpu.utils.logger import RunLogger as JaxRunLogger
from rep_yolo_tpu_torch.train.hyp import load_hyp
from rep_yolo_tpu_torch.utils.logger import RunLogger

TRAIN = ("train/box", "train/obj", "train/cls", "train/total")
VAL = ("val/P", "val/R", "val/mAP50", "val/mAP", "val/fitness")


def _drive(cls, run, calls):
    """``calls``: a list of loggers' calls, (step, {tag: value}) each; None
    closes the logger and opens a new one on the same directory."""
    log = cls(run)
    log.log_config("hyp", load_hyp("scratch.p5"))
    for call in calls:
        if call is None:
            log.close()
            log = cls(run)
            continue
        log.log_scalars(*call)
    log.close()


def _calls(order: str):
    rng = np.random.default_rng(0)
    train = lambda: dict(zip(TRAIN, rng.random(4)))  # noqa: E731
    val = lambda: dict(zip(VAL, rng.random(5).tolist()))  # noqa: E731
    if order == "train_first":        # --eval-every 3 over 6 epochs
        return [c for e in range(6) for c in
                [(e, train())] + ([(e, val())] if e % 3 == 2 else [])]
    if order == "resumed":            # 3 epochs, then a resumed run's 2
        first = [(0, train()), (0, val()), (1, train()), (1, val()),
                 (2, train())]
        return first + [None, (3, train()), (3, val()), (4, train())]
    return [(0, val()), (0, train()), (1, val())]     # val_first


@pytest.mark.parametrize("order", ["train_first", "resumed", "val_first"])
def test_metrics_csv_and_hyp_json_equal_jax(tmp_path, order):
    calls = _calls(order)
    _drive(RunLogger, tmp_path / "port", calls)
    _drive(JaxRunLogger, tmp_path / "jax", calls)
    for name in ("metrics.csv", "hyp.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    rows = (tmp_path / "port" / "metrics.csv").read_text().splitlines()
    if order == "train_first":
        # the JAX quirk, copied: a val row keeps its step alone
        assert rows[0] == "step," + ",".join(TRAIN) and rows[4] == "2,,,,"


def test_wandb_is_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="Weights & Biases"):
        RunLogger(tmp_path, wandb_project="p")


def _scalars(run):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    acc = EventAccumulator(str(run / "tb"))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_tensorboard_scalars_equal_jax(tmp_path):
    """The event files, written on TensorBoard's stub of TensorFlow, carry
    every scalar of every call (the ``val/*`` ones too), as the JAX
    logger's do."""
    calls = _calls("train_first")
    _drive(RunLogger, tmp_path / "port", calls)
    _drive(JaxRunLogger, tmp_path / "jax", calls)
    got = _scalars(tmp_path / "port")
    assert sorted(got) == sorted(TRAIN + VAL)
    assert got == _scalars(tmp_path / "jax")
    assert got["val/mAP"][1][0] == 5
