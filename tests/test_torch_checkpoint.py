"""Checkpoints, the run directory and the evaluation entry points of the port
(``train/checkpoint.py``, ``cli/train.py``, ``cli/test.py``,
``cli/detect.load_model_and_vars``), on the CPU.

- A port checkpoint holds exactly the JAX ``_flatten`` keys of a
  ``TrainState`` of the same graph (shapes and dtypes too), and the JAX
  ``load_checkpoint`` reads it; a JAX-form ``.npz`` loads in the port with
  the same weights, EMA and optimizer buffers; an orbax directory raises.
- ``cli.train --val-data synthetic:4 --eval-every 1`` on the tiny graph:
  eval lines, ``best`` / ``last`` / ``epoch_000`` written, the run directory
  numbered on; ``cli.test`` on PNG files with ``--weights`` (fused, int8
  with K7 and with K12, rect, unfused) exits 0 and scores the checkpoint's
  EMA weights as ``evaluate`` does.
- The reparam property (the counterpart of ``tests/test_reparam.py:40``): a
  train-form model in ``eval()`` against its fused deploy form on the same
  weights at 64 px, once with the attention on the row-3 route's plain
  version and once on the einsum path.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rep_yolo_tpu.models.model import RepYOLO as JaxRepYOLO
from rep_yolo_tpu.train import checkpoint as JC
from rep_yolo_tpu.train.trainer import create_train_state as jax_train_state
from rep_yolo_tpu_torch.cli import test as cli_test
from rep_yolo_tpu_torch.cli import train as cli_train
from rep_yolo_tpu_torch.cli.detect import load_model_and_vars
from rep_yolo_tpu_torch.data.datasets import DetectionDataset
from rep_yolo_tpu_torch.models.model import RepYOLO
from rep_yolo_tpu_torch.train import checkpoint as C
from rep_yolo_tpu_torch.train.evaluate import evaluate
from rep_yolo_tpu_torch.train.trainer import create_train_state
from rep_yolo_tpu_torch.utils.general import increment_path
from rep_yolo_tpu_torch.utils.weights import (state_dict_from_jax,
                                              train_state_from_jax)
from test_torch_eval import PNG_SHAPES, TINY, write_png_set


@pytest.fixture(scope="module")
def jax_state():
    """A JAX TrainState of the tiny graph with numpy-random leaves (shapes
    by ``jax.eval_shape``, no init compile)."""
    model = JaxRepYOLO.from_config(TINY)
    shapes = jax.eval_shape(lambda r: model.net.init(
        {"params": r}, jnp.zeros((1, 64, 64, 3)), train=False),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    variables = jax.tree.map(lambda s: rng.normal(
        0, 0.1, s.shape).astype(s.dtype), shapes)
    state = jax_train_state(variables, jax.random.PRNGKey(3))
    # distinct EMA, momentum and counters
    bump = lambda t, d: jax.tree.map(lambda a: np.asarray(a) + d, t)  # noqa
    return state._replace(
        opt=state.opt._replace(step=np.int32(17),
                               momentum=bump(state.opt.momentum, 0.25)),
        ema=state.ema._replace(updates=np.int32(9),
                               variables=bump(state.ema.variables, 0.5)))


def _port_state(seed=0):
    model = RepYOLO.from_config(TINY, device="cpu")
    model.init(torch.Generator().manual_seed(seed))
    return create_train_state(model, seed=seed + 1)


def test_checkpoint_keys_are_the_jax_flatten_keys(jax_state, tmp_path):
    st = _port_state()
    st.step, st.ema_updates = 5, 4
    C.save_checkpoint(tmp_path / "last", st, meta=dict(epoch=2))
    ref = JC._flatten(jax_state)
    with np.load(tmp_path / "last.npz") as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
    # the meta, and the port's generator states beside it
    meta = json.loads((tmp_path / "last.json").read_text())
    assert meta == {"epoch": 2, **C.generator_states(st)}
    # the JAX package reads it into its own template
    back = JC.load_checkpoint(tmp_path / "last", jax_state)
    assert int(back.opt.step) == 5 and int(back.ema.updates) == 4
    sd = state_dict_from_jax(back.ema.variables)
    for k, v in st.ema.items():
        np.testing.assert_array_equal(sd[k], v.numpy(), err_msg=k)
    sd = state_dict_from_jax({"params": back.params,
                              "batch_stats": back.batch_stats})
    for k, v in st.model.net.state_dict().items():
        np.testing.assert_array_equal(sd[k], v.numpy(), err_msg=k)


def test_jax_npz_loads_in_the_port(jax_state, tmp_path):
    np.savez(tmp_path / "ck.npz", **JC._flatten(jax_state))
    st = C.load_checkpoint(tmp_path / "ck", _port_state(7))
    ref = train_state_from_jax(jax_state)
    assert (st.step, st.ema_updates) == (17, 9)
    for got, want in ((st.ema, ref["ema"]), (st.momentum, ref["momentum"]),
                      (st.model.net.state_dict(), ref["state"])):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k],
                                          err_msg=k)
    # a round trip through the port's writer keeps every leaf
    C.save_checkpoint(tmp_path / "again", st)
    with np.load(tmp_path / "again.npz") as z:
        for k, v in JC._flatten(jax_state).items():
            if k != "4":                   # the rng: the port's own seed
                np.testing.assert_array_equal(z[k], v, err_msg=k)
    (tmp_path / "o.orbax").mkdir()
    with pytest.raises(NotImplementedError, match="npz"):
        C.load_checkpoint(tmp_path / "o", st)


def test_strip_latest_and_increment(tmp_path):
    st = _port_state()
    w = C.strip_to_deploy(st)
    assert set(w) == set(st.ema)
    assert all(v.dtype == torch.bfloat16 for v in w.values())
    assert all(v.dtype == torch.float32
               for v in C.strip_to_deploy(st, half=False).values())
    assert C.latest_run(tmp_path) is None
    for name in ("a", "b"):
        C.save_checkpoint(tmp_path / name / "last", st, meta={})
        os.utime(tmp_path / name / "last.json", (1e9, 1e9 + (name == "b")))
    assert C.latest_run(tmp_path) == (tmp_path / "b" / "last").resolve()
    assert increment_path(tmp_path / "exp") == tmp_path / "exp"
    (tmp_path / "exp").mkdir()
    assert increment_path(tmp_path / "exp") == tmp_path / "exp2"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of ``cli.train`` on the tiny graph with evaluation."""
    root = tmp_path_factory.mktemp("train")
    argv = ["--cfg", TINY, "--data", "synthetic:4", "--val-data",
            "synthetic:4", "--epochs", "1", "--batch-size", "2",
            "--img-size", "64", "--no-augment", "--no-autoanchor",
            "--eval-every", "1", "--project", str(root), "--device", "cpu"]
    lines = []
    cli_train.run_training(cli_train.parse_args(argv), emit=lines.append)
    return root, argv, [json.loads(s) for s in lines]


def test_cli_train_evaluates_and_saves(trained):
    root, argv, lines = trained
    evals = [r["eval"] for r in lines if "eval" in r]
    assert len(evals) == 1 and np.isfinite(list(evals[0].values())[:5]).all()
    run = root / "exp"
    for name in ("last", "epoch_000"):
        assert (run / f"{name}.npz").exists() and (run / f"{name}.json").exists()
    assert ((run / "best.npz").exists()) == (evals[0]["fitness"] > 0)
    assert json.loads((run / "opt.json").read_text())["val_data"] == \
        "synthetic:4"
    # the JAX CLI's epoch line (rep_yolo_tpu/cli/train.py:490-492)
    results = (run / "results.txt").read_text().splitlines()
    assert len(results) == 1 and re.fullmatch(
        r"epoch 0/0 box \d+\.\d{4} obj \d+\.\d{4} cls \d+\.\d{4} "
        r"total \d+\.\d{4} \(\d+\.\ds\)", results[0])
    assert lines[0]["val"] == 4 and lines[0]["run_dir"] == str(run)


@pytest.mark.parametrize("flags", [[], ["--fast", "int8"],
                                   ["--fast", "int8", "--dw5-exact"],
                                   ["--rect", "--rect-stride", "32"],
                                   ["--no-fuse"]])
def test_cli_test_scores_the_checkpoint(trained, tmp_path, flags, capsys):
    root, _, _ = trained
    data = write_png_set(tmp_path / "val")
    weights = str(root / "exp" / "last")
    argv = ["--cfg", TINY, "--data", str(data / "images"), "--img-size",
            "64", "--batch-size", "4", "--weights", weights, "--device",
            "cpu"] + flags
    res = cli_test.main(argv)
    text = capsys.readouterr().out
    out = json.loads(text[text.rindex('{\n  "P"'):])
    assert out["map50"] == res.map50 and out["map"] == res.map
    args = cli_test.parse_args(argv)
    model = load_model_and_vars(args)
    ds = DetectionDataset.from_path(str(data / "images"), 64)
    if args.fast == "int8":
        cli_test.calibrate_int8(model, ds, 64, dw5_dense=not args.dw5_exact)
    ref = evaluate(model, ds, batch_size=4, img_size=64, rect=args.rect,
                   rect_stride=args.rect_stride)
    for k in ("mp", "mr", "map50", "map"):
        assert getattr(res, k) == getattr(ref, k), k


def test_cli_test_loads_the_ema_and_refuses_plots(trained, tmp_path):
    root, _, _ = trained
    args = cli_test.parse_args(["--cfg", TINY, "--data", "x", "--weights",
                                str(root / "exp" / "last"), "--no-fuse",
                                "--device", "cpu"])
    model = load_model_and_vars(args)
    ema = C.read_checkpoint(root / "exp" / "last")["ema"]
    for k, v in model.net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ema[k], err_msg=k)
    with pytest.raises(NotImplementedError):
        cli_test.main(["--cfg", TINY, "--data", str(tmp_path),
                       "--plots-dir", "runs/test", "--device", "cpu"])


@pytest.mark.parametrize("flags", [[], ["--fast", "int8", "--no-fuse"],
                                   ["--fast", "int8", "--task", "study"]])
def test_cli_test_refuses_dw5_exact_without_int8(tmp_path, flags):
    """``--dw5-exact`` where no int8 region runs is an error, not a float
    evaluation that looks like K12's."""
    with pytest.raises(ValueError, match="--dw5-exact"):
        cli_test.main(["--cfg", TINY, "--data", str(tmp_path), "--dw5-exact",
                       "--device", "cpu"] + flags)


@pytest.mark.slow
def test_cli_test_study(trained, tmp_path, monkeypatch):
    root, _, _ = trained
    data = write_png_set(tmp_path / "val", PNG_SHAPES[:2])
    monkeypatch.chdir(tmp_path)
    rows = cli_test.main(["--cfg", TINY, "--data", str(data / "images"),
                          "--task", "study", "--weights",
                          str(root / "exp" / "last"), "--device", "cpu"])
    assert len(rows) == 11 and (tmp_path / "study_images.txt").exists()


# ---------------------------------------------------------------------------
# the reparam property
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row3", [True, False])
def test_train_form_eval_matches_fused_deploy(row3):
    """|f_train(x; eval) - f_deploy(x)| within the JAX test's rtol 5e-3 /
    atol 2e-2, on seeded weights with random BN statistics and every
    attention gamma 0.5 (so the attention counts)."""
    model = RepYOLO.from_config(TINY, device="cpu")
    model.init(torch.Generator().manual_seed(42))
    g = torch.Generator().manual_seed(43)
    state = {}
    for k, v in model.net.state_dict().items():
        if k.endswith("running_mean"):
            v = 0.3 * torch.randn(v.shape, generator=g)
        elif k.endswith("running_var"):
            v = 0.5 + torch.rand(v.shape, generator=g)
        elif k.endswith("gamma"):
            v = torch.full_like(v, 0.5)
        state[k] = v
    model.load_state(state)
    model.net.set_fused_attention(row3)
    x = torch.from_numpy(np.random.default_rng(7).uniform(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    z_train = model.predict(x)
    z_deploy = model.fuse().predict(x)
    np.testing.assert_allclose(z_deploy.numpy(), z_train.numpy(),
                               rtol=5e-3, atol=2e-2)
