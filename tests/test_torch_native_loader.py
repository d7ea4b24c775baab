"""The port's native loader (``rep_yolo_tpu_torch/data/native_loader.py``:
cv2 decode in a pool of threads, the C++ resize of
``rep_yolo_tpu_torch/native/loader.cpp``) on the CPU, against the JAX
package's native loader (libjpeg / libpng decode, the same resize) and the
port's ``Loader``.

- It builds into ``rep_yolo_tpu_torch/_build/`` (never beside a source);
  where that directory cannot be made, ``available()`` is False and
  ``build_error()`` says why, and ``cli.train`` takes the Python loader.
- ``load_one`` equals the JAX native ``load_one`` byte for byte, on JPEG and
  PNG files, shrunk and grown; the resize does on odd shapes too.
- ``NativeLoader`` yields ``Loader(drop_last=False)``'s batches in
  ``Loader``'s order at 2 and 8 threads, over 20 repeated epochs,
  shuffled, sharded and resampled by image weights: the case where the
  JAX loader's completion-order queue lets a later batch overtake an
  earlier one.
- Its batch contents equal the JAX native loader's, index by index, and
  the tail batch's empty slots hold pad 114, hw (0, 0), index -1 and no
  label; a cached dataset is served by gathers equal to ``load_item``.
- The 64 seeded images at 640 px that ``chip_smoke.py``'s
  ``loader_native`` writes give the JPEG files and native canvases whose
  hashes ``tests/golden/native_canvases_640.json`` holds (the card checks
  its canvases against them).
- A tail batch (one empty slot) through the port's ``augment_batch``
  matches the JAX ``augment_batch`` on mirrored draws, with no NaN.
"""

import os

import numpy as np
import pytest
import torch

from rep_yolo_tpu.data import datasets as JD
from rep_yolo_tpu.data import native_loader as JN
from rep_yolo_tpu_torch.data import datasets as PD
from rep_yolo_tpu_torch.data import native_loader as PN

SIZE = 64
N = 11
BATCH = 4
THREADS = 8

@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    """The seeded set; skips where the native loader does not build
    (decided at run time, not while the module is imported)."""
    if not PN.available():
        pytest.skip(f"native loader unavailable: {PN.build_error()}")
    return PD.make_synthetic_dataset(N, SIZE, 2, 8, seed=7,
                                     root=tmp_path_factory.mktemp("native"))


def _jax_native():
    if not JN.available():
        pytest.skip(f"the JAX native loader: {JN.build_error()}")


def _indices(loader, epoch, **kw):
    return [int(i) for b in loader.epoch(epoch, **kw) for i in b["indices"]]


def test_builds_into_the_build_dir(ds):
    so = PN.library_path()
    assert so.is_file() and so.parent.parent == PN.BUILD_DIR
    assert so.parent.parent.name == "_build" and \
        so.parent.parent.parent.name == "rep_yolo_tpu_torch"
    assert PN.build_error() is None
    assert PN.build_command(so)[:2] == ["g++", "-O3"]


def test_unwritable_build_dir_falls_back(tmp_path, monkeypatch):
    """A build directory that cannot be made (under a file here; a
    read-only install alike) is a build error, not an exception: the CLI
    takes the Python loader and its line says why."""
    from rep_yolo_tpu_torch.cli import train as cli

    blocker = tmp_path / "install"
    blocker.write_text("")
    monkeypatch.setattr(PN, "BUILD_DIR", blocker / "_build")
    monkeypatch.setattr(PN, "_tried", False)
    monkeypatch.setattr(PN, "_lib", None)
    monkeypatch.setattr(PN, "_build_error", None)
    assert not PN.available()
    assert PN.build_error().startswith(f"cannot build into {blocker}")
    assert PN.load_one(str(tmp_path / "x.jpg"), SIZE) is None
    src = PD.make_synthetic_dataset(2, SIZE, 1, 8, seed=1,
                                    root=tmp_path / "set")
    args = cli.parse_args(["--data", "x", "--batch-size", "2"])
    loader, line = cli.make_loader(args, src)
    assert isinstance(loader, PD.Loader)
    assert line.startswith("loader: python (native loader unavailable: "
                           f"cannot build into {blocker}")


@pytest.mark.parametrize("kind", ["jpeg", "png"])
def test_load_one_matches_jax_native(ds, kind, tmp_path):
    _jax_native()
    import cv2

    files = list(ds.img_files)
    if kind == "png":
        files = []
        for i, f in enumerate(ds.img_files[:3]):
            files.append(str(tmp_path / f"{i}.png"))
            cv2.imwrite(files[-1], cv2.imread(f))
    for f in files:
        for size in (SIZE, 2 * SIZE + 13):        # shrink and grow
            got, ref = PN.load_one(f, size), JN.load_one(f, size)
            assert got[0].tobytes() == ref[0].tobytes(), f
            np.testing.assert_array_equal(got[1], ref[1])
            assert got[2] == ref[2]
    assert PN.load_one(str(tmp_path / "missing.jpg"), SIZE) is None


@pytest.mark.parametrize("hw", [(37, 91), (130, 45), (5, 300)])
def test_resize_matches_jax_native_on_odd_shapes(ds, hw, tmp_path):
    """Random pixels of odd shapes, through a lossless PNG for the JAX
    loader, resized by each to 64 and 96 px: byte for byte."""
    _jax_native()
    import cv2

    rgb = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), np.uint8)
    png = str(tmp_path / "odd.png")
    cv2.imwrite(png, rgb[..., ::-1])
    for size in (SIZE, 96):
        got, ref = PN.load_one(png, size), JN.load_one(png, size)
        assert got[0].tobytes() == ref[0].tobytes(), size
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == ref[2] == hw


ORDER_CASES = {"shuffled": dict(), "in_order": dict(shuffle=False),
               "shard0of2": dict(shard_index=0, num_shards=2),
               "shard1of2": dict(shard_index=1, num_shards=2),
               "weights": dict(weights=True)}


@pytest.mark.parametrize("threads", [2, THREADS])
@pytest.mark.parametrize("case", sorted(ORDER_CASES))
def test_order_equals_loader_over_20_epochs(ds, case, threads):
    kw = dict(ORDER_CASES[case])
    iw = np.arange(N, dtype=np.float64) + 1 if kw.pop("weights", False) \
        else None
    native = PN.NativeLoader(ds, 2, seed=3, n_threads=threads, **kw)
    ref = PD.Loader(ds, 2, seed=3, drop_last=False, **kw)
    try:
        assert len(native) == len(ref)
        for epoch in range(20):
            got = list(native.epoch(epoch, image_weights=iw))
            want = list(ref.epoch(epoch, image_weights=iw))
            assert [list(b["indices"][b["indices"] >= 0]) for b in got] == \
                [list(b["indices"]) for b in want], epoch
    finally:
        native.close()


def test_batches_match_jax_native_and_tail(ds):
    """Every slot equals the JAX native loader's batch slot of the same
    index (the JAX loader's batch order may differ); the tail's empty
    slots are padding."""
    _jax_native()
    jds = JD.DetectionDataset(img_files=ds.img_files, labels=ds.labels,
                              img_size=SIZE, max_labels=8, nc=2)
    native = PN.NativeLoader(ds, BATCH, seed=1, n_threads=THREADS)
    jnative = JN.NativeLoader(jds, BATCH, seed=1, n_threads=THREADS)
    try:
        ref = {}
        for b in jnative.epoch(0):
            for j, i in enumerate(b["indices"]):
                if i >= 0:
                    ref[int(i)] = (b["images"][j], b["hw"][j],
                                   b["labels"][j], b["mask"][j])
        got = list(native.epoch(0))
        assert len(got) == len(native) == -(-N // BATCH)
        for b in got:
            for j, i in enumerate(b["indices"]):
                if i < 0:
                    continue
                for a, r in zip((b["images"][j], b["hw"][j], b["labels"][j],
                                 b["mask"][j]), ref[int(i)]):
                    assert a.dtype == r.dtype
                    np.testing.assert_array_equal(a, r)
        tail = got[-1]
        k = N % BATCH
        assert list(tail["indices"][k:]) == [-1] * (BATCH - k)
        assert (tail["images"][k:] == 114).all()
        assert (tail["hw"][k:] == 0).all() and not tail["mask"][k:].any()
        assert tail["mask"][:k].any(1).all()
    finally:
        native.close()
        jnative.close()


def test_an_unfinished_epoch_leaves_the_next_whole(ds):
    """Batches of an epoch left early never leak into the next one."""
    native = PN.NativeLoader(ds, 2, seed=4, n_threads=THREADS)
    ref = PD.Loader(ds, 2, seed=4, drop_last=False)
    try:
        for epoch in range(6):
            it = native.epoch(epoch)
            next(it)
            it.close()
            got = _indices(native, epoch + 100)
            want = _indices(ref, epoch + 100)
            assert [i for i in got if i >= 0] == want
    finally:
        native.close()
    with pytest.raises(RuntimeError):
        next(native.epoch(0))
    with pytest.raises(TypeError):
        PN.NativeLoader(PD.make_synthetic_dataset(2, SIZE), 2)


@pytest.mark.parametrize("mode", ["ram", "disk"])
def test_cached_epoch_gathers_the_cache(ds, tmp_path, mode):
    import shutil

    root = tmp_path / "set"
    shutil.copytree(os.path.dirname(os.path.dirname(ds.img_files[0])), root)
    cached = PD.DetectionDataset.from_path(str(root / "images"), SIZE, 2, 8)
    cached.cache_images(mode, workers=2)
    native = PN.NativeLoader(cached, BATCH, seed=2, n_threads=2)
    ref = PD.Loader(cached, BATCH, seed=2, drop_last=False)
    try:
        got, want = list(native.epoch(5)), list(ref.epoch(5))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            n = len(w["indices"])
            np.testing.assert_array_equal(g["indices"][:n], w["indices"])
            for k in ("images", "hw", "labels", "mask"):
                np.testing.assert_array_equal(g[k][:n], w[k])
            assert (g["images"][n:] == 114).all() and \
                not g["mask"][n:].any()
    finally:
        native.close()


@pytest.fixture(scope="module")
def set640(ds, tmp_path_factory):
    """``chip_smoke.py``'s ``loader_native`` set: 64 images at 640 px."""
    return PD.make_synthetic_dataset(64, 640, 1, 120, seed=0,
                                     root=tmp_path_factory.mktemp("s640"))


def test_golden_640_canvases(set640):
    """The JPEG files and native canvases of ``loader_native``'s set equal
    ``tests/golden/native_canvases_640.json``, which the card checks its
    own against (where its cv2 writes the same JPEG bytes)."""
    import json
    import pathlib
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke

    ref = json.loads(chip_smoke.NATIVE_GOLDEN.read_text())
    got = chip_smoke.canvas_hashes(set640, PN.load_one)
    assert got["jpeg_sha256"] == ref["jpeg_sha256"]
    assert got["canvas_sha256"] == ref["canvas_sha256"]


@pytest.mark.parametrize("case", ["separable", "mosaic9"])
def test_tail_batch_augments_as_jax(ds, case):
    """The native loader's tail batch (three images, one empty slot: pad
    114, hw (0, 0), no label), which mosaic and mixup may take as a
    partner, through the port's ``augment_batch`` against the jitted JAX
    ``augment_batch`` (as the JAX train step runs it) on draws mirrored
    from one JAX key, as ``tests/test_torch_augment.py`` holds a full
    batch: masks identical, labels 1e-5, images ``UNIT_TOL`` but for at
    most 0.2 % of the elements (XLA's HSV hue sectors), whose pixels keep
    their largest and smallest channel; neither side gives a NaN."""
    import jax

    from rep_yolo_tpu.data import augment as JA
    from rep_yolo_tpu_torch.data import augment as TA
    from test_torch_augment import (KEY, LABEL_TOL, UNIT_TOL, _cfg, _close,
                                    _jax_draws)

    native = PN.NativeLoader(ds, BATCH, shuffle=False, n_threads=2)
    try:
        batches = list(native.epoch(0))
    finally:
        native.close()
    tail = batches[-1]
    assert list(tail["indices"]) == [8, 9, 10, -1]
    hyp = dict(mixup=0.5, fliplr=0.5, flipud=0.5)
    if case == "mosaic9":
        hyp.update(mosaic9=0.5)
    jcfg, tcfg = _cfg(**hyp)
    args = tuple(tail[k] for k in ("images", "hw", "labels", "mask"))
    draws = _jax_draws(KEY, BATCH, jcfg, slots=args[2].shape[1])
    # the empty slot is some image's partner
    assert (draws.partners == BATCH - 1).any()
    ref = jax.jit(lambda im, h, lb, mk, k: JA.augment_batch(
        im, h, lb, mk, k, jcfg))(*args, KEY)
    got = TA.augment_batch(*map(torch.from_numpy, args), draws, tcfg)
    img, rimg = got.images.numpy(), np.asarray(ref.images)
    assert np.isfinite(rimg).all() and np.isfinite(np.asarray(
        ref.labels)).all()
    assert np.isfinite(img).all() and torch.isfinite(got.labels).all()
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    _close(got.labels.numpy(), ref.labels, LABEL_TOL, "labels")
    off = np.abs(img - rimg) > UNIT_TOL
    assert off.sum() <= 0.002 * off.size, int(off.sum())
    px = off.any(-1)
    if px.any():
        for f in (np.max, np.min):
            _close(f(img[px], -1), f(rimg[px], -1), UNIT_TOL, f.__name__)
