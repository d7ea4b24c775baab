"""Port parity for the whole first slice: cfg/rep_yolo_tiny_test.yaml at 64
px, batch 2, through the JAX package and rep_yolo_tpu_torch on the CPU.

JAX init -> gammas 0.7 and numpy-random BN statistics -> carried into the
port with ``state_dict_from_jax``. Then: the fused state dicts, the deploy
raw maps (f32, atol = rtol = 1e-4), ``predict``, ``predict_topk`` and NMS
at a low conf (valid rows only: top-k tie order differs between
``torch.topk`` and ``lax.top_k``), and the letterbox. Plus a port-only
golden check of the full flagship, the serving engine on the CPU, and an
AST scan that the port imports neither JAX nor the JAX package.
"""

import ast
import json
import pathlib
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rep_yolo_tpu.data.augment import letterbox_batch as jax_letterbox
from rep_yolo_tpu.models.config import parse_config as jax_parse
from rep_yolo_tpu.models.model import RepYOLO as JaxRepYOLO
from rep_yolo_tpu.models.model import initialize_detect_biases
from rep_yolo_tpu.ops.nms import non_max_suppression as jax_nms
from rep_yolo_tpu_torch.data.letterbox import letterbox_batch
from rep_yolo_tpu_torch.device import resolve_device
from rep_yolo_tpu_torch.models.config import parse_config
from rep_yolo_tpu_torch.models.model import RepYOLO
from rep_yolo_tpu_torch.nn.fuse import fuse_state_dict
from rep_yolo_tpu_torch.ops.nms import non_max_suppression
from rep_yolo_tpu_torch.utils.weights import (load_reference_npz,
                                              state_dict_from_jax)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = str(ROOT / "cfg" / "rep_yolo_tiny_test.yaml")
FLAGSHIP = str(ROOT / "cfg" / "rep_yolo.yaml")
TOL = dict(atol=1e-4, rtol=1e-4)
CONF = 0.002


def _set_gamma(tree, value):
    return {k: (_set_gamma(v, value) if isinstance(v, dict) else
                (jnp.full_like(v, value) if k == "gamma" else v))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def slice_run():
    jmodel = JaxRepYOLO.from_config(TINY)
    # RepYOLO.init, traced once instead of run op by op
    variables = dict(jax.jit(lambda r: jmodel.net.init(
        {"params": r}, jnp.zeros((1, 64, 64, 3)), train=False))(
            jax.random.PRNGKey(0)))
    variables["params"] = initialize_detect_biases(
        variables["params"], jmodel.cfg, jmodel.strides)
    rng = np.random.default_rng(0)
    stats = jax.tree.map(lambda a: jnp.asarray(
        rng.uniform(0.5, 1.5, a.shape).astype(np.float32)),
        variables["batch_stats"])
    variables = {"params": _set_gamma(dict(variables["params"]), 0.7),
                 "batch_stats": stats}
    jdeploy, jfused = jmodel.fuse(variables)
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)

    tmodel = RepYOLO.from_config(TINY, device="cpu").load_state(
        state_dict_from_jax(variables))
    tdeploy = tmodel.fuse()
    xt = torch.from_numpy(x)
    return dict(jmodel=jmodel, jdeploy=jdeploy, jfused=jfused, x=x,
                tmodel=tmodel, tdeploy=tdeploy, xt=xt,
                state=state_dict_from_jax(variables))


def test_config_and_strides_match_jax():
    for cfg in (TINY, FLAGSHIP):
        j, t = jax_parse(cfg), parse_config(cfg)
        assert [(l.i, l.f, l.name, l.args, l.c1, l.c2, l.save)
                for l in j.layers] == \
            [(l.i, l.f, l.name, l.args, l.c1, l.c2, l.save)
             for l in t.layers]
        assert j.anchors == t.anchors and j.nc == t.nc
    g = np.load(ROOT / "tests" / "golden" / "model_io.npz")
    tm = RepYOLO.from_config(FLAGSHIP, device="cpu")
    np.testing.assert_array_equal(tm.strides, g["strides"])
    np.testing.assert_allclose(tm.anchors_grid, g["anchors_norm"], rtol=1e-6)


def test_fused_state_matches_jax(slice_run):
    ours = fuse_state_dict({k: torch.tensor(v)
                            for k, v in slice_run["state"].items()})
    # the JAX fused variables, with the attention constants packed
    ref = fuse_state_dict(state_dict_from_jax(slice_run["jfused"]))
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), ref[k].numpy(),
                                   err_msg=k, atol=1e-5, rtol=1e-5)


def test_deploy_raw_maps_match_jax(slice_run):
    ref = slice_run["jdeploy"].apply(slice_run["jfused"], slice_run["x"])
    got = slice_run["tdeploy"].apply(slice_run["xt"])
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_predict_matches_jax(slice_run):
    ref = np.asarray(slice_run["jdeploy"].predict(slice_run["jfused"],
                                                  slice_run["x"]))
    got = slice_run["tdeploy"].predict(slice_run["xt"]).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def _match_rows(a, b):
    """Every row of a has a row of b within tolerance, and vice versa."""
    assert a.shape == b.shape
    for p, q in ((a, b), (b, a)):
        d = np.abs(p[:, None, :] - q[None, :, :]) \
            - (TOL["atol"] + TOL["rtol"] * np.abs(q[None, :, :]))
        assert (d.max(-1) <= 0).any(1).all()


def test_predict_topk_and_nms_match_jax(slice_run):
    ref = np.asarray(slice_run["jdeploy"].predict_topk(
        slice_run["jfused"], slice_run["x"], k=1024, conf_thres=CONF))
    got = slice_run["tdeploy"].predict_topk(slice_run["xt"], k=1024,
                                            conf_thres=CONF)
    n_valid = (ref[..., 4] > CONF).sum(1)
    assert n_valid.min() >= 20, n_valid
    np.testing.assert_array_equal((got[..., 4] > CONF).sum(1).numpy(),
                                  n_valid)
    for b in range(ref.shape[0]):
        m = ref[b, :, 4] > CONF
        _match_rows(got[b].numpy()[got[b, :, 4].numpy() > CONF], ref[b][m])

    det_j = jax_nms(jnp.asarray(ref), CONF, 0.45, presorted=True,
                    method="matrix")
    det_t = non_max_suppression(got, CONF, 0.45, presorted=True)
    np.testing.assert_array_equal(det_t.count.numpy(),
                                  np.asarray(det_j.count))
    for b in range(ref.shape[0]):
        vj = np.asarray(det_j.valid[b])
        vt = det_t.valid[b].numpy()
        rows_j = np.concatenate([np.asarray(det_j.boxes[b])[vj],
                                 np.asarray(det_j.scores[b])[vj, None]], 1)
        rows_t = np.concatenate([det_t.boxes[b].numpy()[vt],
                                 det_t.scores[b].numpy()[vt, None]], 1)
        _match_rows(rows_t, rows_j)


def test_letterbox_matches_jax():
    rng = np.random.default_rng(4)
    canvas = rng.integers(0, 255, (2, 48, 40, 3)).astype(np.uint8)
    hw = np.array([[48, 40], [30, 37]], np.float32)
    for size in (64, (32, 64)):
        ref = jax_letterbox(jnp.asarray(canvas), jnp.asarray(hw), size)
        got = letterbox_batch(torch.from_numpy(canvas), torch.from_numpy(hw),
                              size)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_golden_flagship_zf():
    """Port only: the full flagship from model_weights.npz at 256 px
    against the reference's fused output (tolerance of
    tests/test_golden_model.py)."""
    golden = ROOT / "tests" / "golden"
    g = np.load(golden / "model_io.npz")
    model = RepYOLO.from_config(FLAGSHIP, device="cpu").load_state(
        load_reference_npz(golden / "model_weights.npz")).fuse()
    zf = model.predict(torch.from_numpy(g["x"].transpose(0, 2, 3, 1).copy()))
    np.testing.assert_allclose(zf.numpy(), g["zf"], rtol=5e-3, atol=2e-2)


def test_serving_engine_http_roundtrip():
    from rep_yolo_tpu_torch.serve import build_engine, make_server

    engine = build_engine(TINY, None, 64, 2, conf=0.01, iou=0.45,
                          device="cpu")
    imgs = np.random.default_rng(5).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    srv = make_server(engine, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        health = json.loads(urllib.request.urlopen(url + "/v1/health").read())
        req = urllib.request.Request(url + "/v1/infer", data=imgs.tobytes(),
                                     headers={"X-Shape": "1,64,64,3"})
        resp = json.loads(urllib.request.urlopen(req).read())
        direct = engine(imgs)
    finally:
        srv.shutdown()
        srv.server_close()
        engine.close()
    assert health["status"] == "ok" and health["max_batch"] == 2
    np.testing.assert_allclose(np.asarray(resp["detections"][0]).reshape(
        -1, 6), np.asarray(direct[0]).reshape(-1, 6))


def test_entry_points_need_cuda_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from rep_yolo_tpu_torch.serve import build_engine

    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        build_engine(TINY, None, 64, 1, 0.25, 0.45)
    assert resolve_device("cpu").type == "cpu"


def test_port_imports_no_jax():
    files = sorted((ROOT / "rep_yolo_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "flax", "rep_yolo_tpu"), \
                    f"{f.relative_to(ROOT)} imports {n}"
