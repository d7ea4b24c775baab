"""Resume, the run directory's logs and the resume daemon of the port
(``cli/train.py --resume``, ``train/checkpoint.py``'s generator states,
``tools/resume_daemon.py``), on the CPU.

- A run of the tiny graph at 64 px with ``--hyp scratch.p5`` (augmentation
  on, so the augment generator is drawn from) over 2 epochs, and a copy of
  it resumed from ``epoch_000``, end with the same ``last.npz`` bit for
  bit and the same generator states; the fresh run wrote ``init``,
  ``hyp.json``, ``metrics.csv`` and JAX's text lines in ``results.txt``.
- A JAX-written ``last.npz`` (no generator states) resumes at its
  ``.json``'s epoch + 1 with its step, the generators seeded as at a fresh
  start, and one line saying so.
- The resume daemon finds the same unfinished runs as the JAX daemon and
  relaunches them with the JAX daemon's argument list, the module swapped.
"""

import hashlib
import importlib.util
import json
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from rep_yolo_tpu.train import checkpoint as JC
from rep_yolo_tpu_torch.cli import train as cli
from rep_yolo_tpu_torch.models.model import RepYOLO
from rep_yolo_tpu_torch.tools import resume_daemon as D
from rep_yolo_tpu_torch.train import checkpoint as C
from rep_yolo_tpu_torch.train.hyp import load_hyp
from rep_yolo_tpu_torch.train.trainer import create_train_state
from test_torch_checkpoint import jax_state  # noqa: F401 (a fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = str(ROOT / "cfg" / "rep_yolo_tiny_test.yaml")
ARGS = ["--cfg", TINY, "--data", "synthetic:16", "--batch-size", "8",
        "--img-size", "64", "--hyp", "scratch.p5", "--eval-every", "0",
        "--epochs", "2", "--device", "cpu"]
# rep_yolo_tpu/cli/train.py:490-492
EPOCH_LINE = re.compile(r"epoch (\d+)/(\d+) box \d+\.\d{4} obj \d+\.\d{4} "
                        r"cls \d+\.\d{4} total \d+\.\d{4} \(\d+\.\ds\)")


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The straight run: (its directory, its emitted lines)."""
    root = tmp_path_factory.mktemp("resume")
    lines = []
    cli.run_training(cli.parse_args(ARGS + ["--project", str(root), "--name",
                                            "a"]), emit=lines.append)
    return root / "a", lines


def _read_npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_fresh_run_writes_the_jax_run_directory(straight):
    run, lines = straight
    results = (run / "results.txt").read_text().splitlines()
    assert [EPOCH_LINE.fullmatch(r).groups() for r in results] == [
        ("0", "1"), ("1", "1")]
    csv = (run / "metrics.csv").read_text().splitlines()
    assert csv[0] == "step,train/box,train/obj,train/cls,train/total"
    assert [r.split(",")[0] for r in csv[1:]] == ["0", "1"]
    # the CSV's total is the epoch's mean of the steps' totals, as printed
    steps = [json.loads(s) for s in lines if s.startswith('{"epoch"')]
    for e, row in enumerate(csv[1:]):
        mean = np.mean([r["total"] for r in steps if r["epoch"] == e])
        assert abs(float(row.split(",")[4]) - mean) < 1e-12
        assert results[e].split()[9] == f"{float(row.split(',')[4]):.4f}"
    assert json.loads((run / "hyp.json").read_text()) == load_hyp("scratch.p5")
    assert json.loads((run / "init.json").read_text())["epoch"] == -1
    init, last = _read_npz(run / "init.npz"), _read_npz(run / "last.npz")
    assert sorted(init) == sorted(last)
    assert int(init["2/0"]) == 0 and int(last["2/0"]) == 4
    assert (run / "anchors.json").is_file()      # autoanchor ran


def test_resumed_run_equals_the_straight_run(straight, tmp_path, capsys):
    """Resumed from ``epoch_000`` in a copy of the run: the same
    ``last.npz`` bit for bit (no op of this path is nondeterministic on
    the CPU), the same ``.json`` with its generator states."""
    run, _ = straight
    copy = tmp_path / "b"
    shutil.copytree(run, copy)
    for f in copy.glob("last.*"):
        f.unlink()
    saved = json.loads((copy / "epoch_000.json").read_text())
    lines = []
    records = cli.run_training(cli.parse_args(
        ARGS + ["--resume", str(copy / "epoch_000")]), emit=lines.append)
    out = capsys.readouterr().out.splitlines()
    assert f"resumed {copy / 'epoch_000'} at epoch 1" in out
    head, resumed = (json.loads(s) for s in lines[:2])
    assert head["run_dir"] == str(copy)
    assert resumed["start_epoch"] == 1 and resumed["step"] == 2
    assert resumed["generators_sha256"] == {
        k: hashlib.sha256(saved[k].encode()).hexdigest()
        for k in C.GENERATOR_KEYS}
    assert [(r["epoch"], r["step"]) for r in records] == [(1, 3), (1, 4)]
    want, got = _read_npz(run / "last.npz"), _read_npz(copy / "last.npz")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].tobytes() == want[k].tobytes(), k
    assert json.loads((copy / "last.json").read_text()) == \
        json.loads((run / "last.json").read_text())
    # the resumed epoch appends its lines to the copied run's logs
    results = (copy / "results.txt").read_text().splitlines()
    assert [EPOCH_LINE.fullmatch(r).group(1) for r in results] == \
        ["0", "1", "1"]
    assert results[2].split()[:10] == results[1].split()[:10]
    csv = (copy / "metrics.csv").read_text().splitlines()
    assert len(csv) == 4 and csv[3] == csv[2]


def test_generator_states_round_trip(tmp_path):
    model = RepYOLO.from_config(TINY, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    st = create_train_state(model, seed=5)
    st.generator.seed()
    st.aug_generator.seed()
    C.save_checkpoint(tmp_path / "ck", st, meta=dict(epoch=0))
    meta = json.loads((tmp_path / "ck.json").read_text())
    assert set(meta) == {"epoch", *C.GENERATOR_KEYS}
    fresh = create_train_state(model, seed=9)
    C.load_checkpoint(tmp_path / "ck", fresh, seed=9)
    assert C.generator_states(fresh) == C.generator_states(st)


def _jax_checkpoint(state, path, epoch):
    """A JAX ``last.npz`` in the JAX ``.npz`` form and its ``.json``, the
    BN variances of the random leaves made positive."""
    flat = {k: np.abs(v) + 0.5 if k.endswith("/var") else v
            for k, v in JC._flatten(state).items()}
    np.savez(path.with_suffix(".npz"), **flat)
    path.with_suffix(".json").write_text(json.dumps(
        {"epoch": epoch, "fitness": 0.0}))


def test_jax_checkpoint_resumes_and_reseeds(jax_state, tmp_path,  # noqa: F811
                                            capsys):
    run = tmp_path / "jax_run"
    run.mkdir()
    _jax_checkpoint(jax_state, run / "last", epoch=1)
    args = cli.parse_args(["--cfg", TINY, "--data", "synthetic:4",
                           "--batch-size", "2", "--img-size", "64",
                           "--epochs", "3", "--no-augment", "--no-autoanchor",
                           "--eval-every", "0", "--device", "cpu",
                           "--resume", str(run / "last")])
    lines = []
    records = cli.run_training(args, emit=lines.append)
    out = capsys.readouterr().out.splitlines()
    assert f"resumed {run / 'last'} at epoch 2" in out
    reseed = [s for s in out if "no generator states" in s]
    assert len(reseed) == 1 and "seeded from 1" in reseed[0]
    # the generators as create_train_state(model, seed=args.seed + 1) has them
    model = RepYOLO.from_config(TINY, device="cpu")
    fresh = C.generator_states(create_train_state(model, seed=1))
    resumed = json.loads(lines[1])
    assert resumed["generators_sha256"] == {
        k: hashlib.sha256(v.encode()).hexdigest() for k, v in fresh.items()}
    assert [(r["epoch"], r["step"]) for r in records] == [(2, 18), (2, 19)]
    assert not (run / "init.npz").exists()
    assert json.loads((run / "last.json").read_text())["epoch"] == 2


def _jax_daemon():
    spec = importlib.util.spec_from_file_location(
        "jax_resume_daemon", ROOT / "tools" / "resume_daemon.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_resume_daemon_matches_jax(tmp_path, monkeypatch):
    J = _jax_daemon()
    root = tmp_path / "train"
    opt = vars(cli.parse_args(["--data", "synthetic:768", "--val-data",
                               "synthetic:128", "--epochs", "24",
                               "--eval-every", "3", "--hyp", "scratch.p5",
                               "--name", "demo"]))
    for name, epoch in (("done", 23), ("demo", 3), ("fresh", -1),
                        ("bad", None), ("no_opt", 0)):
        (root / name).mkdir(parents=True)
        (root / name / "last.json").write_text(
            "{" if epoch is None else json.dumps({"epoch": epoch}))
        if name != "no_opt":
            (root / name / "opt.json").write_text(json.dumps(opt))
    found = D.find_unfinished(root)
    assert found == J.find_unfinished(root)
    assert [d.name for d, _ in found] == ["demo", "fresh"]
    calls = []
    monkeypatch.setattr(subprocess, "call",
                        lambda cmd: calls.append(cmd) or 0)
    D.main(["--root", str(root), "--once"])
    J.main(["--root", str(root), "--once"])
    assert len(calls) == 4
    for port, ref in zip(calls[:2], calls[2:]):
        assert port == [a.replace("rep_yolo_tpu.cli.train",
                                  "rep_yolo_tpu_torch.cli.train")
                        for a in ref]
    # the JAX daemon's list, copied: the relaunched run takes the CLI's
    # defaults for the flags it leaves out
    args = cli.parse_args(calls[0][3:])
    assert args.resume == str(root / "demo" / "last")
    assert (args.hyp, args.val_data, args.eval_every) == ("scratch.p5", None,
                                                          1)
    cli.check_ported(args)


def test_demo_run_schedule_matches_jax():
    """The JAX demo run's optimizer schedule (scratch.p5, 24 epochs of 96
    batches of 8), every step: the four groups' learning rates and the
    momentum, the accumulation ramp, the weight decay and the loss gains,
    as the two CLIs build them."""
    import jax.numpy as jnp

    from rep_yolo_tpu.train import optim as JO
    from rep_yolo_tpu.train.hyp import load_hyp as jax_load_hyp
    from rep_yolo_tpu.train.hyp import scale_gains as jax_scale_gains
    from rep_yolo_tpu.train.trainer import accum_target_for as jax_accum
    from rep_yolo_tpu_torch.train import optim as PO
    from rep_yolo_tpu_torch.train.hyp import scale_gains
    from rep_yolo_tpu_torch.train.trainer import accum_target_for

    hyp, jhyp = load_hyp("scratch.p5"), jax_load_hyp("scratch.p5")
    assert hyp == jhyp
    assert scale_gains(hyp, 3, 1, 640) == jax_scale_gains(jhyp, 3, 1, 640)
    kw = dict(lr0=hyp["lr0"], lrf=hyp["lrf"], momentum=hyp["momentum"],
              warmup_epochs=hyp["warmup_epochs"],
              warmup_momentum=hyp["warmup_momentum"],
              warmup_bias_lr=hyp["warmup_bias_lr"], epochs=24, nb=96)
    cfg = PO.OptimConfig(weight_decay=PO.scaled_weight_decay(
        hyp["weight_decay"], 8), **kw)
    jcfg = JO.OptimConfig(weight_decay=JO.scaled_weight_decay(
        jhyp["weight_decay"], 8), **kw)
    assert cfg.weight_decay == jcfg.weight_decay and cfg.nw == jcfg.nw == 1000
    final = PO.accumulate_steps(8)
    assert final == JO.accumulate_steps(8) == 8
    steps = range(24 * 96)
    jlrs, jmom = JO.schedule(jcfg, jnp.arange(24 * 96))
    got = np.array([[*lrs, mom] for lrs, mom in
                    (PO.schedule(cfg, s) for s in steps)])
    want = np.concatenate([np.asarray(jlrs).T, np.asarray(jmom)[:, None]], 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert [accum_target_for(s, cfg.nw, final) for s in steps] == \
        [jax_accum(s, jcfg.nw, final) for s in steps]
