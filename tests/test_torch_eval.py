"""Port parity for evaluation (``rep_yolo_tpu_torch/train/evaluate.py``,
``utils/metrics.py``, the file dataset and the ``Loader``), on the CPU.

- The metrics on seeded arrays, ties in confidence included: ``ap_per_class``,
  ``match_predictions``, ``ConfusionMatrix.process_batch`` and ``fitness``
  bit-equal to the JAX package's.
- ``_rect_plan`` with the order and shapes of the JAX one on the synthetic
  set of ``tests/test_infra.py::test_rect_eval``; the ``Loader`` in order
  and shuffled, with and without the last partial batch, batch for batch
  the JAX ``Loader``'s on the same image files.
- ``evaluate`` end to end on ``cfg/rep_yolo_tiny_test.yaml`` at 64 px on
  PNG files written from a seeded generator with their long side at 64 px
  (r = 1, so both packages build the same canvases whatever resize they
  use), the same weights carried across with ``state_dict_from_jax``: the
  TP matrices identical and mAP@.5 and mAP@.5:.95 within 1e-6, for the
  fused model, the unfused one (attention gammas 0.5, its attention on the
  row-3 route's plain version) and the fused one with ``rect=True``. A
  mismatch dumps both sides.
- The resized file canvas against the JAX ``_decode_canvas`` (cv2 only).
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rep_yolo_tpu.train.evaluate as JE
import rep_yolo_tpu.utils.metrics as JM
import rep_yolo_tpu_torch.train.evaluate as PE
import rep_yolo_tpu_torch.utils.metrics as PM
from rep_yolo_tpu.data import datasets as JD
from rep_yolo_tpu.models.model import RepYOLO as JaxRepYOLO
from rep_yolo_tpu_torch.data import datasets as PD
from rep_yolo_tpu_torch.models.model import RepYOLO
from rep_yolo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from rep_yolo_tpu_torch.utils.weights import state_dict_from_jax

TINY = str(pathlib.Path(__file__).resolve().parents[1] / "cfg"
           / "rep_yolo_tiny_test.yaml")
MAP_TOL = 1e-6

# (h, w) of the PNG set: long side 64 (no resize), wide and tall, so that
# the rect plan makes (32, 64) and (64, 32) buckets at stride 32
PNG_SHAPES = [(16, 64), (64, 64), (12, 64), (64, 14), (40, 64), (64, 48),
              (64, 16), (64, 64), (28, 64)]


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _pred_and_labels(rng, n, m, nc, tie_every=3):
    """n predictions (x1, y1, x2, y2, conf, cls), confidences tied in runs,
    boxes near m labels (cls, x1, y1, x2, y2)."""
    lab_xy = rng.uniform(0, 80, (m, 2))
    lab_wh = rng.uniform(8, 30, (m, 2))
    labels = np.concatenate([rng.integers(0, nc, (m, 1)), lab_xy,
                             lab_xy + lab_wh], 1).astype(np.float32)
    src = rng.integers(0, m, n)
    xy = lab_xy[src] + rng.normal(0, 3, (n, 2))
    wh = lab_wh[src] * rng.uniform(0.7, 1.3, (n, 2))
    conf = np.round(rng.uniform(0, 1, n) * 20) / 20        # many ties
    conf[::tie_every] = conf[0]
    cls = np.where(rng.uniform(size=n) < 0.8, labels[src, 0],
                   rng.integers(0, nc, n))
    order = np.argsort(-conf, kind="stable")
    pred = np.concatenate([xy, xy + wh, conf[:, None], cls[:, None]],
                          1).astype(np.float32)[order]
    return pred, labels


@pytest.mark.parametrize("nc", [1, 3])
def test_metrics_bit_equal_to_jax(nc):
    rng = np.random.default_rng(nc)
    iouv = np.linspace(0.5, 0.95, 10)
    stats, cm_j, cm_p = [], JM.ConfusionMatrix(nc), PM.ConfusionMatrix(nc)
    for _ in range(6):
        pred, labels = _pred_and_labels(rng, int(rng.integers(0, 40)),
                                        int(rng.integers(1, 8)), nc)
        got = PM.match_predictions(pred, labels, iouv)
        ref = JM.match_predictions(pred, labels, iouv)
        np.testing.assert_array_equal(got, ref)
        cm_p.process_batch(pred, labels)
        cm_j.process_batch(pred, labels)
        stats.append((ref, pred[:, 4], pred[:, 5], labels[:, 0]))
    np.testing.assert_array_equal(cm_p.matrix, cm_j.matrix)
    tp, conf, pcls, tcls = (np.concatenate([s[i] for s in stats])
                            for i in range(4))
    assert tp.any() and not tp.all()
    got = PM.ap_per_class(tp, conf, pcls, tcls, return_curves=True)
    ref = JM.ap_per_class(tp, conf, pcls, tcls, return_curves=True)
    for a, b in zip(got[:5], ref[:5]):
        np.testing.assert_array_equal(a, b)
    for k in ref[5]:
        np.testing.assert_array_equal(got[5][k], ref[5][k])
    p, r, ap = ref[0].mean(), ref[1].mean(), ref[2]
    assert PM.fitness(p, r, ap[:, 0].mean(), ap.mean()) == \
        JM.fitness(p, r, ap[:, 0].mean(), ap.mean())


# ---------------------------------------------------------------------------
# datasets, loader, rect plan
# ---------------------------------------------------------------------------

def test_rect_plan_matches_jax(tmp_path):
    jds = JD.make_synthetic_dataset(7, 64, 1, 8, seed=3,
                                    root=tmp_path / "synth")
    pds = PD.make_synthetic_dataset(7, 64, 1, 8, seed=3)
    np.testing.assert_array_equal(pds.image_shapes(), jds.image_shapes())
    for bs, stride in ((2, 32), (3, 64), (4, 16)):
        order, shapes = PE._rect_plan(pds, bs, 64, stride)
        ref_order, ref_shapes = JE._rect_plan(jds, bs, 64, stride)
        np.testing.assert_array_equal(order, ref_order)
        assert shapes == ref_shapes


def write_png_set(root, shapes=PNG_SHAPES, seed=0, nc=1):
    """Seeded boxes-on-noise images of the given (h, w) as lossless PNG in
    a YOLO layout (``root/images``, ``root/labels``)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "labels").mkdir(parents=True, exist_ok=True)
    for i, (h, w) in enumerate(shapes):
        img = rng.integers(0, 80, (h, w, 3), np.uint8)
        rows = []
        for _ in range(int(rng.integers(1, 4))):
            bw, bh = rng.uniform(0.15, 0.5), rng.uniform(0.15, 0.5)
            xc = rng.uniform(bw / 2, 1 - bw / 2)
            yc = rng.uniform(bh / 2, 1 - bh / 2)
            x1, y1 = int((xc - bw / 2) * w), int((yc - bh / 2) * h)
            x2, y2 = int((xc + bw / 2) * w), int((yc + bh / 2) * h)
            img[y1:y2, x1:x2] = rng.integers(150, 255, 3)
            rows.append((int(rng.integers(0, nc)), xc, yc, bw, bh))
        Image.fromarray(img).save(root / "images" / f"{i:05d}.png")
        (root / "labels" / f"{i:05d}.txt").write_text("\n".join(
            f"{c} {x:.6f} {y:.6f} {a:.6f} {b:.6f}" for c, x, y, a, b in rows))
    return root


def _jax_file_dataset(root, size=64):
    return JD.DetectionDataset.from_path(str(root / "images"), size, 1,
                                         cache=False)


@pytest.mark.parametrize("shuffle,drop_last,bs", [
    (False, False, 4), (False, True, 4), (True, False, 2), (True, True, 3)])
def test_loader_matches_jax(tmp_path, shuffle, drop_last, bs):
    root = write_png_set(tmp_path)
    pds = PD.DetectionDataset.from_path(str(root / "images"), 64, 1)
    jds = _jax_file_dataset(root)
    assert pds.img_files == jds.img_files
    got = PD.Loader(pds, bs, shuffle=shuffle, seed=5, drop_last=drop_last)
    ref = JD.Loader(jds, bs, shuffle=shuffle, seed=5, drop_last=drop_last)
    assert len(got) == len(ref)
    for epoch in (0, 1):
        pairs = list(zip(got.epoch(epoch), ref.epoch(epoch), strict=True))
        assert len(pairs) == len(ref)
        for a, b in pairs:
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_dataset_yaml_and_txt_list(tmp_path):
    root = write_png_set(tmp_path / "set", PNG_SHAPES[:3])
    files = sorted(str(p) for p in (root / "images").iterdir())
    (tmp_path / "list.txt").write_text("\n".join(files))
    (tmp_path / "data.yaml").write_text(
        "val: set/images\ntrain: set/images\nnc: 1\nnames: ['person']\n")
    a = PD.DetectionDataset.from_path(str(tmp_path / "list.txt"), 64)
    b = PD.DetectionDataset.from_path(str(tmp_path / "data.yaml"), 64)
    assert a.img_files == b.img_files == files
    for la, lb in zip(a.labels, b.labels):
        np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(a.image_shapes(), [s for s in
                                                     PNG_SHAPES[:3]])
    assert PD.image_decoder() in ("cv2", "pil")


def test_resized_canvas_matches_jax(tmp_path):
    """Images resized on the way to the canvas (down and up): the port's
    file canvas uses cv2 with the JAX flags, so it equals the JAX
    ``_decode_canvas``."""
    pytest.importorskip("cv2")
    root = write_png_set(tmp_path, [(100, 80), (30, 50), (64, 200)], seed=2)
    pds = PD.DetectionDataset.from_path(str(root / "images"), 64, 1)
    jds = _jax_file_dataset(root)
    for i in range(len(pds)):
        for a, b in zip(pds.canvas(i), jds._decode_canvas(i)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# evaluate end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    """JAX train-form variables of the tiny graph, seeded (numpy-random BN
    statistics, attention gammas 0.5): the JAX model and the port's train
    form on the same weights."""
    jmodel = JaxRepYOLO.from_config(TINY)
    variables = dict(jax.jit(lambda r: jmodel.net.init(
        {"params": r}, jnp.zeros((1, 64, 64, 3)), train=False))(
            jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    variables["batch_stats"] = jax.tree.map(lambda a: jnp.asarray(
        rng.uniform(0.5, 1.5, a.shape).astype(np.float32)),
        variables["batch_stats"])
    variables["params"] = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.full_like(a, 0.5) if path[-1].key == "gamma"
        else a, variables["params"])
    port = RepYOLO.from_config(TINY, device="cpu").load_state(
        state_dict_from_jax(variables))
    return jmodel, variables, port


def _recording(monkeypatch, module):
    """Record every TP matrix ``module``'s evaluate computes."""
    out = []
    fn = module.match_predictions

    def rec(*a):
        out.append(fn(*a))
        return out[-1]

    monkeypatch.setattr(module, "match_predictions", rec)
    return out


@pytest.mark.parametrize("mode", ["fused", "unfused", "fused_rect"])
def test_evaluate_matches_jax(tmp_path, monkeypatch, weights, mode):
    jmodel, variables, port = weights
    root = write_png_set(tmp_path)
    jds = _jax_file_dataset(root)
    pds = PD.DetectionDataset.from_path(str(root / "images"), 64, 1)
    rect = mode == "fused_rect"
    kw = dict(batch_size=4, img_size=64, rect=rect, rect_stride=32)
    if mode == "unfused":
        jm, jv, pm = jmodel, variables, port
        pm.net.set_fused_attention(True)       # row 3 (its plain version)
    else:
        (jm, jv), pm = jmodel.fuse(variables), port.fuse()
    tp_j = _recording(monkeypatch, JE)
    tp_p = _recording(monkeypatch, PE)
    try:
        ref = JE.evaluate(jm, jv, jds, **kw)
        reset_launch_counts()
        got = PE.evaluate(pm, pds, **kw)
    finally:
        port.net.set_fused_attention(None)
    assert sum(launch_counts().values()) == 0             # plain versions
    n_det = sum(len(t) for t in tp_j)
    same = (len(tp_p) == len(tp_j) == len(PNG_SHAPES) and all(
        a.shape == b.shape and np.array_equal(a, b)
        for a, b in zip(tp_p, tp_j)))
    gaps = {k: abs(getattr(got, k) - getattr(ref, k))
            for k in ("map50", "map", "mp", "mr", "fitness")}
    if not same or max(gaps.values()) > MAP_TOL:
        dump = tmp_path / f"mismatch_{mode}.json"
        dump.write_text(json.dumps({
            "port": [t.astype(int).tolist() for t in tp_p],
            "jax": [t.astype(int).tolist() for t in tp_j],
            "port_res": repr(got), "jax_res": repr(ref)}))
        pytest.fail(f"{mode}: TP identical {same}, gaps {gaps}; both "
                    f"sides in {dump}")
    assert n_det > 50 and 0 < ref.map50            # a meaningful comparison
