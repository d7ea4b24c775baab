"""``cli.train`` on image files (``rep_yolo_tpu_torch/cli/train.py``), on the
CPU: the tiny graph at 64 px on a handful of images.

- ``--data <dir>`` (the JAX generator's files) and ``--data <data.yaml>``
  (its ``nc`` and its val split as the default ``--val-data``) train, with
  the loader's line, the label cache and finite losses.
- ``synthetic[:N]`` writes ``<run>/synthetic`` and ``<run>/synthetic_val``
  byte for byte as the JAX CLI's ``make_synthetic_dataset`` calls write
  them (seed, seed + 1), and trains from those files.
- With ``--cache-images ram`` and N a multiple of the batch,
  ``--native-loader`` and ``--no-native-loader`` give the same losses bit
  for bit (the same canvases, the same order).
- ``--image-weights`` hands each epoch the JAX CLI's image weights: class
  weights times (1 - the last evaluation's per-class mAP)^2 / nc.
- The loader choice: the native loader's line (``, cached`` with
  ``--cache-images``); ``--native-loader`` raises where its C++ does not
  build, and the default then takes the Python loader and says why.
- The feed thread: batches in order, an error in the thread raised in the
  caller, and a consumer that stops early leaves no thread behind.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from rep_yolo_tpu.data import datasets as JD
from rep_yolo_tpu.utils import general as JG
from rep_yolo_tpu_torch.cli import train as cli
from rep_yolo_tpu_torch.data import native_loader as PN

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = str(ROOT / "cfg" / "rep_yolo_tiny_test.yaml")
SIZE = 64
BASE = ["--cfg", TINY, "--img-size", str(SIZE), "--batch-size", "4",
        "--epochs", "1", "--no-autoanchor", "--device", "cpu"]



@pytest.fixture
def native():
    """Skip where the native loader does not build (decided at run time,
    not while the module is imported)."""
    if not PN.available():
        pytest.skip(f"native loader unavailable: {PN.build_error()}")


@pytest.fixture(scope="module")
def yolo_dir(tmp_path_factory):
    """A YOLO directory written by the JAX generator: 8 train images at
    seed 3, 4 val images at seed 4."""
    root = tmp_path_factory.mktemp("yolo")
    JD.make_synthetic_dataset(8, SIZE, 1, 120, seed=3, root=root / "train")
    JD.make_synthetic_dataset(4, SIZE, 1, 120, seed=4, root=root / "val")
    return root


def _train(argv, tmp_path, capsys=None):
    lines = []
    records = cli.run_training(cli.parse_args(
        BASE + argv + ["--project", str(tmp_path), "--name", "r"]),
        emit=lines.append)
    out = capsys.readouterr().out.splitlines() if capsys else []
    assert records and all(np.isfinite(r[k]) for r in records
                           for k in ("box", "obj", "cls", "total"))
    return records, [json.loads(s) for s in lines if s.startswith("{")], out


def test_cli_trains_on_a_directory(native, yolo_dir, tmp_path, capsys):
    records, lines, out = _train(
        ["--data", str(yolo_dir / "train"), "--no-augment", "--eval-every",
         "0"], tmp_path, capsys)
    assert "loader: native (cv2 decode threads, C++ resize)" in out
    assert "train: 8 images, 2 batches/epoch" in out
    assert [r["step"] for r in records] == [1, 2]
    assert all(r["wait_ms"] >= 0 for r in records)
    assert (yolo_dir / "train" / "labels.cache.npz").is_file()
    assert lines[0]["train"] == 8 and lines[0]["batches_per_epoch"] == 2


def test_cli_trains_on_a_yaml(yolo_dir, tmp_path, capsys):
    """The YAML's nc replaces --nc; its val split is scored; the Python
    loader keeps dropping the last partial batch (8 images, batch 3)."""
    data = tmp_path / "data.yaml"
    data.write_text(f"train: {yolo_dir / 'train'}\nval: {yolo_dir / 'val'}"
                    "\nnc: 2\nnames: [a, b]\n")
    records, lines, out = _train(
        ["--data", str(data), "--no-native-loader", "--eval-every", "1",
         "--batch-size", "3"], tmp_path, capsys)
    assert "loader: python (--no-native-loader)" in out
    assert [r["step"] for r in records] == [1, 2]
    assert lines[0]["val"] == 4
    evals = [r for r in lines if "eval" in r]
    assert len(evals) == 1
    opt = json.loads((tmp_path / "r" / "opt.json").read_text())
    assert opt["nc"] == 1 and opt["val_data"] is None      # as given
    ckpt = np.load(tmp_path / "r" / "last.npz")
    assert any(v.shape[-1] == 3 * (5 + 2) for v in ckpt.values())


def test_cli_writes_the_synthetic_sets_as_jax(tmp_path):
    _train(["--data", "synthetic:4", "--val-data", "synthetic:3",
            "--no-augment", "--eval-every", "0"], tmp_path)
    ref = tmp_path / "ref"
    JD.make_synthetic_dataset(4, SIZE, 1, 120, seed=0, root=ref / "t")
    JD.make_synthetic_dataset(3, SIZE, 1, 120, seed=1, root=ref / "v")
    for got, want, n in (("synthetic", "t", 4), ("synthetic_val", "v", 3)):
        files = sorted((tmp_path / "r" / got).rglob("*.*"))
        assert len(files) == 2 * n
        for f in files:
            g = (ref / want / f.relative_to(tmp_path / "r" / got))
            assert f.read_bytes() == g.read_bytes(), f


def test_native_and_python_loaders_give_the_same_losses(native, yolo_dir,
                                                        tmp_path):
    """With the canvases cached in RAM both loaders serve the same arrays
    in the same order (8 images, batch 4: no partial batch), so the two
    runs (augmented, the tiny graph) agree bit for bit."""
    runs = {}
    for flag in ("--native-loader", "--no-native-loader"):
        records, _, _ = _train(
            ["--data", str(yolo_dir / "train"), "--cache-images", "ram",
             "--epochs", "2", "--eval-every", "0", flag], tmp_path / flag)
        runs[flag] = [(r["step"], r["box"], r["obj"], r["cls"], r["total"])
                      for r in records]
    assert len(runs["--native-loader"]) == 4
    assert runs["--native-loader"] == runs["--no-native-loader"]


def test_image_weights_follow_the_last_evaluation(yolo_dir, tmp_path,
                                                  monkeypatch):
    """Each epoch's loader gets JAX's image weights: the class weights of
    the training labels times (1 - per-class mAP)^2 / nc, the mAPs from
    the evaluation before the epoch (zeros before the first)."""
    from rep_yolo_tpu_torch.data import datasets as PD
    import rep_yolo_tpu_torch.train.evaluate as E

    seen, maps = [], []
    epoch = PD.Loader.epoch

    def spy(self, e, image_weights=None):
        seen.append(image_weights)
        return epoch(self, e, image_weights)

    evaluate = E.evaluate

    def scores(*a, **kw):
        res = evaluate(*a, **kw)
        res.per_class[0] = dict(res.per_class.get(0, {}), ap=0.25)
        maps.append(0.25)
        return res

    monkeypatch.setattr(PD.Loader, "epoch", spy)
    monkeypatch.setattr(E, "evaluate", scores)
    _train(["--data", str(yolo_dir / "train"), "--no-native-loader",
            "--image-weights", "--epochs", "2", "--eval-every", "1",
            "--no-augment"], tmp_path)
    labels = JD.DetectionDataset.from_path(str(yolo_dir / "train"), SIZE,
                                           cache=False).labels
    cw = JG.labels_to_class_weights(labels, 1)
    want = [JG.labels_to_image_weights(labels, 1, cw * (1 - m) ** 2 / 1)
            for m in (0.0, 0.25)]
    train_calls = [w for w in seen if w is not None]
    assert len(train_calls) == 2 and maps == [0.25, 0.25]
    for got, ref in zip(train_calls, want):
        np.testing.assert_array_equal(got, ref)


def test_loader_choice(yolo_dir, tmp_path, monkeypatch):
    from rep_yolo_tpu_torch.data import datasets as PD

    ds = PD.DetectionDataset.from_path(str(yolo_dir / "train"), SIZE)
    args = cli.parse_args(BASE + ["--data", "x", "--workers", "3"])
    if PN.available():
        loader, line = cli.make_loader(args, ds)
        assert isinstance(loader, PN.NativeLoader) and loader.n_threads == 3
        assert len(loader) == 2 and line == (
            "loader: native (cv2 decode threads, C++ resize)")
        assert [len(b["indices"]) for b in loader.epoch(0)] == [4, 4]
        loader.close()
        cached = cli.parse_args(BASE + ["--data", "x", "--cache-images",
                                        "ram"])
        loader, line = cli.make_loader(cached, ds)
        assert line == "loader: native (cv2 decode threads, C++ resize, " \
            "cached)"
        loader.close()
    monkeypatch.setattr(PN, "_lib", None)
    monkeypatch.setattr(PN, "_build_error", "g++ failed here")
    loader, line = cli.make_loader(args, ds)
    assert isinstance(loader, PD.Loader) and line == (
        "loader: python (native loader unavailable: g++ failed here)")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed here"):
        cli.make_loader(cli.parse_args(BASE + ["--data", "x",
                                               "--native-loader"]), ds)
    mem = PD.make_synthetic_dataset(2, SIZE)
    assert cli.make_loader(args, mem)[1] == \
        "loader: python (in-memory synthetic set)"


def test_feed_keeps_order_raises_and_stops():
    dev = torch.device("cpu")
    batches = [{k: np.full((2, 3), i, np.float32)
                for k in cli.BATCH_KEYS} for i in range(5)]
    got = [int(x[0][0, 0]) for x, wait in cli.feed(iter(batches), dev)]
    assert got == list(range(5))

    def broken():
        yield batches[0]
        raise OSError("a decode failed")

    with pytest.raises(OSError, match="a decode failed"):
        list(cli.feed(broken(), dev))
    import threading
    before = threading.active_count()
    it = cli.feed(iter(batches * 4), dev)
    next(it)
    it.close()
    assert threading.active_count() == before
