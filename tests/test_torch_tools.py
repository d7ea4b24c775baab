"""The port's tools on the CPU: ``tools/overfit_check.py`` (the batch, the
IoU, the run's plumbing at a few steps; the full 2000-step run is slow) and
``tools/eval_modes.py`` (every mode's model and score against the same
model built and evaluated directly, the gaps, the CLI's lines) and
``tools/calib_triage.py`` (its grid's cells against the int8 modes scored
directly). No tool falls back to the CPU when no card is present."""

import json
import pathlib

import numpy as np
import pytest
import torch

from rep_yolo_tpu_torch.cli.test import calibrate_int8, calibration_images
from rep_yolo_tpu_torch.data.datasets import make_synthetic_dataset
from rep_yolo_tpu_torch.models.model import RepYOLO
from rep_yolo_tpu_torch.ops.quant import calibrate
from rep_yolo_tpu_torch.tools import calib_triage as CT
from rep_yolo_tpu_torch.tools import eval_modes as EM
from rep_yolo_tpu_torch.tools import overfit_check as OC
from rep_yolo_tpu_torch.train.checkpoint import read_weights, save_checkpoint
from rep_yolo_tpu_torch.train.evaluate import evaluate
from rep_yolo_tpu_torch.train.trainer import create_train_state

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = str(ROOT / "cfg" / "rep_yolo_tiny_test.yaml")


def test_overfit_batch_is_the_jax_tools():
    """The arrays ``tools/overfit_check.py`` builds (lines 35-43)."""
    imgs = np.full((2, 64, 64, 3), 0.3 * 255, np.float32)
    for b in range(2):
        imgs[b, 13:38, 35:55] = 255.0
    labels = np.zeros((2, 8, 5), np.float32)
    labels[:, 0] = [0, 0.7, 0.4, 0.3, 0.4]
    mask = np.zeros((2, 8), bool)
    mask[:, 0] = True
    got = OC.batch(torch.device("cpu"))
    for a, b in zip(got, (imgs, np.full((2, 2), 64, np.float32), labels,
                          mask)):
        np.testing.assert_array_equal(a.numpy(), b)
    # the label is the drawn box, to within a pixel
    x, y, w, h = labels[0, 0, 1:] * 64
    assert (x - w / 2, y - h / 2, x + w / 2, y + h / 2) == pytest.approx(
        OC.BOX, abs=1)


@pytest.mark.parametrize("a, b, iou", [
    ((0, 0, 2, 2), (0, 0, 2, 2), 1.0), ((0, 0, 2, 2), (1, 0, 3, 2), 1 / 3),
    ((0, 0, 1, 1), (2, 2, 3, 3), 0.0),
    ((34.8, 13.7, 54.3, 38.4), OC.BOX, 0.9148)])
def test_box_iou(a, b, iou):
    assert OC.box_iou(a, b) == pytest.approx(iou, abs=1e-4)
    # a detection row's float32 values give a float the JSON line takes
    got = OC.box_iou(np.asarray(a, np.float32), b)
    assert type(got) is float and got == pytest.approx(iou, abs=1e-4)


def test_overfit_check_plumbing(capsys):
    rc = OC.main(["--steps", "3", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["steps"] == 3 and out["device"] == "cpu"
    assert out["seed"] == 0
    assert np.isfinite([out["first_loss"], out["last_loss"]]).all()
    assert out["ok"] == (out["iou"] >= 0.8 and out["conf"] >= 0.5)
    assert rc == (0 if out["ok"] else 1)
    # another init seed: another model, so another first loss
    OC.main(["--steps", "1", "--seed", "5", "--device", "cpu"])
    other = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert other["seed"] == 5 and other["first_loss"] != out["first_loss"]


@pytest.mark.slow
def test_overfit_check_localizes_on_cpu():
    out = OC.run(device="cpu", log=lambda line: None)
    assert out["ok"], out


def test_tools_need_the_card_unless_cpu_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OC.run(steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EM.main(["--weights", str(tmp_path / "none")])


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny TrainState whose EMA weights differ from its parameters."""
    path = tmp_path_factory.mktemp("modes") / "best"
    model = RepYOLO.from_config(TINY, device="cpu")
    model.init(torch.Generator().manual_seed(3))
    st = create_train_state(model, seed=1)
    with torch.no_grad():
        for k, v in st.ema.items():
            if v.is_floating_point() and not k.endswith("running_var"):
                v.mul_(0.9)
    save_checkpoint(path, st, meta=dict(epoch=0))
    return path


def _direct(weights, mode, val):
    """The mode's model as the port's entry points build it."""
    m = RepYOLO.from_config(TINY, device="cpu").load_state(weights)
    if mode == "unfused_row3":
        return m
    m = m.fuse()
    if mode in ("bf16", "bf16_der_fast"):
        m.cast(torch.bfloat16)
    if mode == "bf16_der_fast":
        m.net.set_der_fast("bf16")
    if mode.startswith("int8"):
        calibrate_int8(m, val, 64, dw5_dense=mode == "int8_k7")
    if mode == "xla_q8":
        m.net.set_der_fast("xla_q8", scales=calibrate(
            m, [calibration_images(val, 64, torch.device("cpu"))]))
    return m


def test_eval_modes_scores_every_mode(checkpoint, capsys):
    rows = EM.main(["--weights", str(checkpoint), "--cfg", TINY,
                    "--val-data", "synthetic:4", "--img-size", "64",
                    "--batch-size", "2", "--device", "cpu"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines[0]["images"] == 4 and lines[0]["device_name"] == "cpu"
    assert [r["mode"] for r in lines[1:-1]] == list(EM.MODES) == list(rows)
    gaps = lines[-1]["gaps_to_fused_f32"]
    assert list(gaps) == list(EM.MODES[1:])
    weights = read_weights(checkpoint)
    # the JPEG files eval_modes wrote beside the checkpoint and scored
    val = make_synthetic_dataset(4, 64, 1, 120, seed=1,
                                 root=checkpoint.parent / "synthetic_val")
    with torch.inference_mode():
        for mode in EM.MODES:
            res = evaluate(_direct(weights, mode, val), val, batch_size=2,
                           img_size=64)
            got = rows[mode]
            assert (got["P"], got["R"], got["map50"], got["map"]) == (
                res.mp, res.mr, res.map50, res.map), mode
            if mode != "fused_f32":
                assert gaps[mode]["map"] == got["map"] - \
                    rows["fused_f32"]["map"]
    # the train form in eval() scores as its fused form
    assert abs(rows["unfused_row3"]["map50"] -
               rows["fused_f32"]["map50"]) < 1e-3
    with pytest.raises(ValueError, match="unknown mode"):
        EM.mode_model(weights, TINY, "int4", val, 64, torch.device("cpu"))


def test_calib_triage_grid(checkpoint, capsys):
    """Every cell of the grid once, in order; each cell's int8 scores are
    those of the mode calibrated on that set's first images and scored on
    the other, built and evaluated directly; its float32 base is the
    scored set's."""
    rows = CT.main(["--weights", str(checkpoint), "--cfg", TINY,
                    "--val-data", "synthetic:3", "--img-size", "64",
                    "--batch-size", "2", "--device", "cpu"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines == json.loads(json.dumps(rows))
    assert [(r["scored"], r["calibrated_on"], r["calib_images"])
            for r in rows] == [(a, b, k) for a in CT.SETS for b in CT.SETS
                               for k in CT.CALIB_COUNTS]
    weights = read_weights(checkpoint)
    sets = {"files": make_synthetic_dataset(
        3, 64, 1, 120, seed=1, root=checkpoint.parent / "synthetic_val"),
        "memory": make_synthetic_dataset(3, 64, 1, 120, seed=1)}
    assert not np.array_equal(sets["files"].load_item(0)[0],
                              sets["memory"].load_item(0)[0])
    with torch.inference_mode():
        for r in rows[1:3]:             # files scored, memory calibrated
            val, cal = sets[r["scored"]], sets[r["calibrated_on"]]
            for mode in CT.INT8_MODES:
                m = EM.mode_model(weights, TINY, mode, val, 64,
                                  torch.device("cpu"), calib=cal,
                                  calib_n=r["calib_images"])
                res = evaluate(m, val, batch_size=2, img_size=64)
                got = r["modes"][mode]
                assert (got["P"], got["R"], got["map50"], got["map"]) == (
                    res.mp, res.mr, res.map50, res.map), (r, mode)
                assert r["gaps_to_fused_f32"][mode]["map"] == \
                    got["map"] - r["modes"]["fused_f32"]["map"]
        res = evaluate(EM.mode_model(weights, TINY, "fused_f32",
                                     sets["memory"], 64, torch.device("cpu")),
                       sets["memory"], batch_size=2, img_size=64)
        assert rows[-1]["modes"]["fused_f32"]["map"] == res.map
    with pytest.raises(ValueError, match="synthetic"):
        CT.main(["--weights", str(checkpoint), "--val-data", "data.yaml"])
