"""``rep_yolo_tpu_torch.hub`` against ``rep_yolo_tpu.hub`` on
cfg/rep_yolo_tiny_test.yaml at 64 px on the CPU, one set of weights on
both sides (``test_torch_detect.tiny_variables``).

- ``letterbox_np`` / ``_resize_np`` equal to JAX's bit for bit.
- ``AutoShape`` against JAX ``AutoShape`` on one batch that holds every
  input kind (a path, a uint8 array, a float array, a 2-D grey image, in
  mixed sizes), plain and ``tta=True``: the same detection counts, boxes
  within 1e-3 px, scores within 1e-5.
- ``Detections.pandas`` / ``save`` / ``print`` with the same content as
  JAX's on the same arrays.
- ``EnsembleModel.predict`` equal to the members' predictions
  concatenated; ``load(ckpt=)`` on a JAX variables-tree checkpoint.
"""

import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rep_yolo_tpu import hub as jax_hub
from rep_yolo_tpu.models.model import RepYOLO as JaxRepYOLO
from rep_yolo_tpu.train import checkpoint as JC
from rep_yolo_tpu_torch import hub
from test_torch_detect import SIZE, TINY, port_model, tiny_variables

BOX_ATOL, SCORE_ATOL = 1e-3, 1e-5


@pytest.fixture(scope="module")
def variables():
    return tiny_variables()


def _inputs(tmp_path):
    rng = np.random.default_rng(4)
    smooth = lambda h, w: cv2.GaussianBlur(  # noqa: E731
        rng.integers(0, 256, (h, w, 3), np.uint8), (5, 5), 0)
    path = tmp_path / "a.jpg"
    cv2.imwrite(str(path), smooth(50, 70))
    grey = cv2.cvtColor(smooth(64, 40), cv2.COLOR_BGR2GRAY)
    return [str(path), smooth(90, 64), smooth(33, 48).astype(np.float32),
            grey]


def test_letterbox_np_is_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    for shape, size in (((37, 53, 3), 64), ((64, 64, 3), 64),
                        ((120, 40, 3), 96), ((20, 30, 1), 64)):
        for img in (rng.integers(0, 256, shape).astype(np.uint8),
                    rng.uniform(0, 255, shape).astype(np.float32)):
            got, want = hub.letterbox_np(img, size), \
                jax_hub.letterbox_np(img, size)
            assert np.array_equal(got[0], want[0])
            assert got[0].dtype == want[0].dtype
            assert got[1:] == want[1:]
            for hw in ((11, 17), shape[:2], (64, 5)):
                assert np.array_equal(hub._resize_np(img, hw),
                                      jax_hub._resize_np(img, hw))


@pytest.mark.parametrize("tta", [False, True])
def test_autoshape_matches_jax(variables, tmp_path, tta):
    images = _inputs(tmp_path)
    jm, jv = JaxRepYOLO.from_config(TINY).fuse(variables)
    want = jax_hub.AutoShape(jm, jv, size=SIZE, conf=0.1, tta=tta)(images)
    auto = hub.AutoShape(port_model(variables), size=SIZE, conf=0.1, tta=tta)
    got = auto(images)
    assert got.shapes == want.shapes
    assert [d.shape for d in got.xyxy] == [d.shape for d in want.xyxy]
    assert sum(len(d) for d in got.xyxy) > 0
    for g, w in zip(got.xyxy, want.xyxy):
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=BOX_ATOL)
        np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=SCORE_ATOL)
        assert np.array_equal(g[:, 5], w[:, 5])
    # a single image is a batch of one
    one = auto(images[1])
    assert len(one) == 1 and one.shapes == [images[1].shape[:2]]
    for (h, w), d in zip(got.shapes, got.xyxy):       # inside each frame
        assert (d[:, [0, 2]] >= 0).all() and (d[:, [0, 2]] <= w).all()
        assert (d[:, [1, 3]] >= 0).all() and (d[:, [1, 3]] <= h).all()


def test_detections_outputs_match_jax(tmp_path, capsys):
    rng = np.random.default_rng(2)
    xyxy = [np.concatenate([rng.uniform(0, 60, (n, 4)), rng.uniform(0, 1, (
        n, 1)), rng.integers(0, 3, (n, 1))], 1).astype(np.float32)
        for n in (3, 0, 2)]
    names, shapes = ("person", "car"), [(48, 64), (30, 30), (64, 20)]
    got = hub.Detections(xyxy, names, shapes)
    want = jax_hub.Detections(xyxy, names, shapes)
    assert len(got) == len(want) == 3
    assert got.pandas() == want.pandas()
    got.print()
    printed = capsys.readouterr().out
    want.print()
    assert printed == capsys.readouterr().out and "(no detections)" in printed
    gd, wd = got.save(tmp_path / "port"), want.save(tmp_path / "jax")
    for i in range(3):
        assert (gd / f"image{i}.txt").read_text() == \
            (wd / f"image{i}.txt").read_text()


def test_ensemble_and_nms_module(variables):
    a = port_model(variables)
    b = port_model(tiny_variables(seed=1))
    ens = hub.EnsembleModel([a, b])
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (2, SIZE, SIZE, 3)).astype(np.float32))
    got = ens.predict(x)
    assert torch.equal(got, torch.cat([a.predict(x), b.predict(x)], 1))
    assert ens.cfg is a.cfg
    det = hub.nms_module(conf=0.1, iou=0.45, max_det=50)(got)
    assert det.boxes.shape == (2, 50, 4) and int(det.count.sum()) > 0


def test_load_reads_a_jax_checkpoint(variables, tmp_path, monkeypatch):
    with monkeypatch.context() as m:           # the JAX npz form
        m.setitem(sys.modules, "orbax.checkpoint", None)
        JC.save_checkpoint(tmp_path / "vars", {
            k: jax.tree.map(jnp.asarray, v) for k, v in variables.items()})
    auto = hub.load(TINY, ckpt=str(tmp_path / "vars"), size=SIZE,
                    device="cpu")
    assert isinstance(auto, hub.AutoShape) and auto.model.deploy
    ref = port_model(variables)
    x = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 1, (1, SIZE, SIZE, 3)).astype(np.float32))
    for g, w in zip(auto.model.apply(x), ref.apply(x)):
        assert torch.equal(g, w)
    model = hub.create(TINY, size=SIZE, autoshape=False, device="cpu")
    assert model.deploy and hub.custom.keywords == {"fuse": True}
