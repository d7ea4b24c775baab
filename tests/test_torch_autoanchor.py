"""Port parity for autoanchor, on the CPU.

``rep_yolo_tpu_torch/utils/autoanchor.py`` against
``rep_yolo_tpu/utils/autoanchor.py`` on the same seeded synthetic set (the
JAX package writes it to disk and reads the image sizes back with PIL; the
port keeps it in memory and reads ``image_shapes()``): the BPR and the
anchors equal. ``RepYOLO.with_anchors`` against the JAX model's, and
``cli.train`` with augmentation (mosaic-9, paste-in and cutout on) and
autoanchor on, end to end on the tiny graph.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from rep_yolo_tpu.utils import autoanchor as JAA
from rep_yolo_tpu_torch.cli import train as cli
from rep_yolo_tpu_torch.data.datasets import make_synthetic_dataset
from rep_yolo_tpu_torch.utils import autoanchor as TAA

TINY = "cfg/rep_yolo_tiny_test.yaml"
SIZE = 64
N_IMAGES = 12

ROOT = pathlib.Path(__file__).resolve().parents[1]

ANCHOR_CASES = {
    # spanning the synthetic boxes (0.08-0.4 of 64 px content): kept
    "good_fit": np.asarray([[[6, 6], [10, 10], [14, 14]],
                            [[16, 16], [20, 20], [24, 24]],
                            [[26, 26], [30, 30], [34, 34]]], np.float32),
    # 100x too large: BPR 0, an evolved set replaces them
    "bad_fit": np.full((3, 3, 2), 2000.0, np.float32),
}


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    from rep_yolo_tpu.data.datasets import \
        make_synthetic_dataset as jax_synthetic

    root = tmp_path_factory.mktemp("synthetic")
    jds = jax_synthetic(N_IMAGES, SIZE, nc=1, max_labels=16, seed=0,
                        root=root)
    tds = make_synthetic_dataset(N_IMAGES, SIZE, nc=1, max_labels=16,
                                 seed=0)
    return jds, tds


def test_label_wh_matches_jax(datasets):
    """The label sizes, and with jitter the rng stream they draw."""
    jds, tds = datasets
    for jitter in (False, True):
        got = TAA._label_wh(tds, SIZE, np.random.default_rng(3), jitter)
        ref = JAA._label_wh(jds, SIZE, np.random.default_rng(3), jitter)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", sorted(ANCHOR_CASES))
def test_check_anchors_matches_jax(datasets, case):
    jds, tds = datasets
    anchors = ANCHOR_CASES[case]
    bpr, new = TAA.check_anchors(tds, anchors, img_size=SIZE, thr=4.0,
                                 seed=1)
    rbpr, rnew = JAA.check_anchors(jds, anchors, img_size=SIZE, thr=4.0,
                                   seed=1)
    assert bpr == rbpr
    if case == "good_fit":
        assert bpr >= 0.98 and new is None and rnew is None
    else:
        assert bpr < 0.98 and new.shape == (9, 2)
        np.testing.assert_array_equal(new, rnew)
        bpr2, _ = TAA.check_anchors(tds, new.reshape(3, 3, 2),
                                    img_size=SIZE, thr=4.0)
        assert bpr2 > bpr


def test_kmean_anchors_matches_jax(datasets):
    jds, tds = datasets
    got = TAA.kmean_anchors(tds, n=6, img_size=SIZE, gen=50, seed=2)
    ref = JAA.kmean_anchors(jds, n=6, img_size=SIZE, gen=50, seed=2)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert (np.diff(got.prod(1)) >= 0).all() and (got >= 2.0 - 1e-6).all()
    with pytest.raises(ValueError, match="too few labels"):
        TAA.kmean_anchors(make_synthetic_dataset(1, SIZE, seed=0), n=9,
                          img_size=SIZE)


@pytest.mark.parametrize("order", ["ascending", "descending"])
def test_with_anchors_matches_jax(order):
    """Anchors, grid and strides against the JAX model's ``with_anchors``
    (a set given largest first comes out flipped); the network and its
    parameters are shared and untouched."""
    from rep_yolo_tpu.models.model import RepYOLO as JaxRepYOLO
    from rep_yolo_tpu_torch.models.model import RepYOLO

    jm = JaxRepYOLO.from_config(TINY)
    tm = RepYOLO.from_config(TINY, device="cpu")
    nl, na = tm.cfg.nl, tm.cfg.na
    flat = np.asarray([[4 + 3 * i, 5 + 2 * i] for i in range(nl * na)],
                      np.float32)
    if order == "descending":
        flat = flat[::-1].copy()
    before = {k: v.clone() for k, v in tm.net.state_dict().items()}
    t2, j2 = tm.with_anchors(flat), jm.with_anchors(flat)
    np.testing.assert_array_equal(t2.anchors_px, j2.anchors_px)
    np.testing.assert_array_equal(t2.anchors_grid, j2.anchors_grid)
    assert t2.strides == tuple(j2.strides)
    areas = t2.anchors_px.prod(-1).mean(-1)
    assert (np.diff(areas) >= 0).all()
    assert t2.net is tm.net
    assert all(torch.equal(v, before[k])
               for k, v in tm.net.state_dict().items())


def test_cli_trains_with_a2b_and_autoanchor_on_cpu(tmp_path, monkeypatch):
    """``run_training`` on the tiny graph at 64 px with augmentation on (a
    hyp with mosaic-9, paste-in and cutout above 0) and autoanchor on, over
    a cfg whose anchors are 20 times too large: the JAX CLI's autoanchor
    line, ``anchors.json`` with the evolved set, finite losses, and the
    in-training evaluation decoding with that set."""
    import rep_yolo_tpu_torch.train.evaluate as E

    cfg = tmp_path / "tiny_big_anchors.yaml"
    text = open(TINY).read()
    for row in ("[10, 13, 16, 30, 33, 23]", "[30, 61, 62, 45, 59, 119]",
                "[116, 90, 156, 198, 373, 326]"):
        big = [v * 20 for v in json.loads(row)]
        text = text.replace(row, json.dumps(big))
    cfg.write_text(text)
    hyp = tmp_path / "hyp.yaml"
    hyp.write_text("mosaic9: 0.5\npaste_in: 0.5\ncutout: 0.3\n")
    args = cli.parse_args(["--cfg", str(cfg), "--data", "synthetic:4",
                           "--epochs", "1", "--batch-size", "2",
                           "--img-size", str(SIZE), "--hyp", str(hyp),
                           "--eval-every", "1", "--device", "cpu",
                           "--project", str(tmp_path / "runs")])
    scored = []
    evaluate = E.evaluate

    def spy(model, *a, **kw):
        scored.append(model.anchors_px.copy())
        return evaluate(model, *a, **kw)

    monkeypatch.setattr(E, "evaluate", spy)
    lines = []
    records = cli.run_training(args, emit=lines.append)
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r[k]) for r in records
               for k in ("box", "obj", "cls", "total"))
    assert lines[0].startswith("autoanchor: BPR 0.0000 < 0.98 — evolved")
    run = json.loads(lines[1])["run_dir"]
    saved = json.loads(open(f"{run}/anchors.json").read())
    assert saved["bpr"] == 0.0
    evolved = np.asarray(saved["anchors_px"], np.float32)
    assert evolved.shape == (3, 3, 2) and evolved.max() < 100
    assert len(scored) == 1
    np.testing.assert_array_equal(scored[0], evolved)


def test_demo_anchors_copy_matches_run():
    """``chip_smoke.py``'s autoanchor_demo reads the JAX demo run's figures
    from ``tests/golden/demo_anchors.json``, a verbatim copy of
    ``runs/train/demo/anchors.json`` kept where a copy of the repo without
    ``runs/`` still has it."""
    copy = ROOT / "tests" / "golden" / "demo_anchors.json"
    run = ROOT / "runs" / "train" / "demo" / "anchors.json"
    assert copy.read_bytes() == run.read_bytes()
    ref = json.loads(copy.read_text())
    assert ref["bpr"] == 0.9986899563318777
    assert np.asarray(ref["anchors_px"]).shape == (3, 3, 2)
