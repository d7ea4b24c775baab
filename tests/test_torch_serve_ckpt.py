"""``serve --ckpt``: the port's server loads checkpoints of either package
(``serve.build_engine(ckpt=...)``, ``train.checkpoint.read_weights``), on
cfg/rep_yolo_tiny_test.yaml at 64 px on the CPU.

- A JAX variables tree from a seeded init (random BN statistics, gammas
  0.7), through the JAX ``strip_to_deploy`` + ``save_checkpoint``: the
  port's engine serves the ``.npz`` the JAX writer falls back to without
  orbax, the JAX server (``deploy/server.py``, loaded by its path) the
  orbax directory the same call writes with orbax; the same seeded images
  give the same detection counts, boxes within 1e-3 px and scores within
  1e-5 (both float32 on the CPU, summed in another order). The half tree
  (``half=True``, bfloat16 leaves) serves the bfloat16-rounded weights in
  float32, raw maps identical to a model built from them.
- A ``TrainState`` ``.npz`` of the port's ``save_checkpoint`` serves its
  EMA weights, raw maps identical to a model loaded through
  ``read_checkpoint`` as ``cli.test`` does; a JAX ``TrainState``'s gives
  its EMA's state dict; the port's stripped state dict saved as a
  variables tree serves too.
- ``--ckpt`` parses; a file of neither form raises naming its keys;
  ``--weights`` with ``--ckpt`` is refused.
"""

import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rep_yolo_tpu.models.model import RepYOLO as JaxRepYOLO
from rep_yolo_tpu.models.model import initialize_detect_biases
from rep_yolo_tpu.train import checkpoint as JC
from rep_yolo_tpu.train.trainer import create_train_state as jax_train_state
from rep_yolo_tpu_torch import serve
from rep_yolo_tpu_torch.models.model import RepYOLO
from rep_yolo_tpu_torch.train import checkpoint as C
from rep_yolo_tpu_torch.train.trainer import create_train_state
from rep_yolo_tpu_torch.utils.weights import (state_dict_from_jax,
                                              train_state_from_jax)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = str(ROOT / "cfg" / "rep_yolo_tiny_test.yaml")
CONF, IOU, BATCH = 0.002, 0.45, 2
BOX_ATOL, SCORE_ATOL = 1e-3, 1e-5


def _images():
    return np.random.default_rng(1).uniform(
        0, 1, (BATCH, 64, 64, 3)).astype(np.float32)


def _set_gamma(tree, value):
    return {k: (_set_gamma(v, value) if isinstance(v, dict) else
                (jnp.full_like(v, value) if k == "gamma" else v))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_variables():
    model = JaxRepYOLO.from_config(TINY)
    v = dict(jax.jit(lambda r: model.net.init(
        {"params": r}, jnp.zeros((1, 64, 64, 3)), train=False))(
            jax.random.PRNGKey(3)))
    v["params"] = initialize_detect_biases(v["params"], model.cfg,
                                           model.strides)
    rng = np.random.default_rng(0)
    stats = jax.tree.map(lambda a: jnp.asarray(
        rng.uniform(0.5, 1.5, a.shape).astype(np.float32)), v["batch_stats"])
    return {"params": _set_gamma(dict(v["params"]), 0.7),
            "batch_stats": stats}


def _save_npz(monkeypatch, path, tree):
    """The JAX ``save_checkpoint`` without orbax: its ``.npz`` fallback."""
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "orbax.checkpoint", None)
        JC.save_checkpoint(path, tree)
    assert pathlib.Path(f"{path}.npz").exists()


def _jax_server():
    spec = importlib.util.spec_from_file_location(
        "jax_deploy_server", ROOT / "deploy" / "server.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(boxes, scores, valid):
    return np.concatenate([boxes[valid], scores[valid, None]], 1)


def _match_rows(a, b):
    """Every row of a has a row of b within the tolerances, and back."""
    assert a.shape == b.shape
    tol = np.array([BOX_ATOL] * 4 + [SCORE_ATOL])
    for p, q in ((a, b), (b, a)):
        d = np.abs(p[:, None, :] - q[None, :, :]) - tol
        assert (d.max(-1) <= 0).any(1).all()


def _engine(weights=None, **kw):
    return serve.build_engine(TINY, weights, 64, BATCH, CONF, IOU,
                              device="cpu", **kw)


def _raw_maps(engine):
    with torch.no_grad():
        return engine.model.apply(torch.from_numpy(_images()))


def test_jax_deploy_checkpoint_serves_as_the_jax_server(jax_variables,
                                                        tmp_path,
                                                        monkeypatch):
    deploy = JC.strip_to_deploy(jax_variables, half=False)
    JC.save_checkpoint(tmp_path / "srv", deploy)   # orbax, read by JAX
    assert (tmp_path / "srv.orbax").is_dir(), (
        "the JAX save_checkpoint wrote no orbax directory (orbax does not "
        "import?): the JAX server cannot read its own .npz fallback")
    _save_npz(monkeypatch, tmp_path / "port", deploy)
    infer, fused, _ = _jax_server().build_engine(
        TINY, str(tmp_path / "srv"), 64, BATCH, CONF, IOU)
    ref = infer(fused, jnp.asarray(_images()))
    engine = _engine(ckpt=str(tmp_path / "port"))
    try:
        got = engine.infer(torch.from_numpy(_images()))
    finally:
        engine.close()
    counts = np.asarray(ref.count)
    assert counts.min() >= 3, counts
    np.testing.assert_array_equal(got.count.numpy(), counts)
    for b in range(BATCH):
        _match_rows(_rows(got.boxes[b].numpy(), got.scores[b].numpy(),
                          got.valid[b].numpy()),
                    _rows(np.asarray(ref.boxes[b]), np.asarray(ref.scores[b]),
                          np.asarray(ref.valid[b])))


def test_half_deploy_checkpoint_serves_the_rounded_weights(jax_variables,
                                                           tmp_path,
                                                           monkeypatch):
    _save_npz(monkeypatch, tmp_path / "half",
              JC.strip_to_deploy(jax_variables, half=True))
    with np.load(tmp_path / "half.npz") as z:
        assert {z[k].dtype.str for k in z.files} == {"|V2"}   # bfloat16
    rounded = jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32),
        jax_variables)
    engine = _engine(ckpt=str(tmp_path / "half"))
    ref = RepYOLO.from_config(TINY, device="cpu").load_state(
        state_dict_from_jax(rounded)).fuse()
    try:
        got = _raw_maps(engine)
    finally:
        engine.close()
    with torch.no_grad():
        want = ref.apply(torch.from_numpy(_images()))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _port_state():
    model = RepYOLO.from_config(TINY, device="cpu")
    model.init(torch.Generator().manual_seed(5))
    st = create_train_state(model, seed=6)
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():                     # an EMA apart from the model
        for k, t in st.ema.items():
            if t.is_floating_point():
                t.add_(0.05 * torch.randn(t.shape, generator=g))
    return st


def test_train_state_serves_its_ema(tmp_path):
    st = _port_state()
    C.save_checkpoint(tmp_path / "best", st, meta={"epoch": 0})
    path = tmp_path / "best"
    engine = _engine(ckpt=str(path))
    ref = RepYOLO.from_config(TINY, device="cpu").load_state(
        C.read_checkpoint(path)["ema"]).fuse()        # as cli.test loads
    plain = RepYOLO.from_config(TINY, device="cpu").load_state(
        {k: v.numpy() for k, v in st.model.net.state_dict().items()}).fuse()
    try:
        got = _raw_maps(engine)
    finally:
        engine.close()
    with torch.no_grad():
        want = ref.apply(torch.from_numpy(_images()))
        other = plain.apply(torch.from_numpy(_images()))
    for a, b, c in zip(got, want, other):
        assert torch.equal(a, b)
        assert not torch.equal(a, c)          # the EMA, not the model


def test_jax_train_state_and_port_variables_tree(jax_variables, tmp_path):
    js = jax_train_state(jax_variables, jax.random.PRNGKey(1))
    js = js._replace(ema=js.ema._replace(variables=jax.tree.map(
        lambda a: np.asarray(a) + 0.5, js.ema.variables)))
    np.savez(tmp_path / "jax_state.npz", **JC._flatten(js))
    want = train_state_from_jax(js)["ema"]
    got = C.read_weights(tmp_path / "jax_state")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the port's strip_to_deploy + save_checkpoint: a variables tree
    st = _port_state()
    C.save_checkpoint(tmp_path / "stripped", C.strip_to_deploy(st),
                      net=st.model.net)
    with np.load(tmp_path / "stripped.npz") as z:
        assert {k.split("/")[0] for k in z.files} == {"params",
                                                      "batch_stats"}
    got = C.read_weights(tmp_path / "stripped")
    for k, t in st.ema.items():
        np.testing.assert_array_equal(got[k], t.bfloat16().float().numpy(),
                                      err_msg=k)


def test_ckpt_parses_and_a_file_of_neither_form_names_its_keys(tmp_path):
    args = serve.parse_args(["--ckpt", str(tmp_path / "best")])
    assert args.ckpt == str(tmp_path / "best") and args.weights is None
    np.savez(tmp_path / "other.npz", foo=np.zeros(2), **{"bar/baz":
                                                         np.ones(3)})
    with pytest.raises(ValueError, match="bar.*foo"):
        _engine(ckpt=str(tmp_path / "other"))
    with pytest.raises(ValueError, match="model.0"):   # reference-keyed
        _engine(ckpt=str(ROOT / "tests" / "golden" / "model_weights"))
    with pytest.raises(FileNotFoundError):
        _engine(ckpt=str(tmp_path / "missing"))


def test_weights_with_ckpt_is_refused(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        serve.parse_args(["--weights", "w.npz", "--ckpt", "c"])
    assert e.value.code == 2
    assert "not allowed with" in capsys.readouterr().err
    with pytest.raises(ValueError, match="not both"):
        _engine(weights="w.npz", ckpt="c")
