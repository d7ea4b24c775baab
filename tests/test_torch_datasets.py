"""Port parity for the file-based training data
(``rep_yolo_tpu_torch/data/datasets.py``, ``utils/general.py``), on the CPU.

- ``make_synthetic_dataset(root=)`` writes the JAX package's files byte for
  byte (the JPEGs and the label texts) for the same seed, with the same
  labels.
- The label cache: each package reads the ``labels.cache.npz`` the other
  wrote (without parsing a label file) and gets the same labels; an edited
  label file invalidates it.
- ``cache_images("ram" | "disk")``: the canvases equal the JAX package's,
  and the ``.npy`` files are the JAX package's, byte for byte.
- ``Loader``: JAX's batches (indices and arrays) with and without shuffle,
  shards, image weights (all-zero ones too) and the last partial batch.
- ``epoch_quad``: JAX's arrays exactly.
- ``labels_to_class_weights`` / ``labels_to_image_weights`` equal JAX's.
"""

import os

import numpy as np
import pytest

from rep_yolo_tpu.data import datasets as JD
from rep_yolo_tpu.utils import general as JG
from rep_yolo_tpu_torch.data import datasets as PD
from rep_yolo_tpu_torch.utils import general as PG

SIZE = 64
N = 10
MAX_LABELS = 8


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """The same seeded set written by each package: (jax, port)."""
    root = tmp_path_factory.mktemp("synthetic")
    return (JD.make_synthetic_dataset(N, SIZE, 2, MAX_LABELS, seed=5,
                                      root=root / "jax"),
            PD.make_synthetic_dataset(N, SIZE, 2, MAX_LABELS, seed=5,
                                      root=root / "port"))


def _label_file(img: str) -> str:
    return img.replace(f"{os.sep}images{os.sep}",
                       f"{os.sep}labels{os.sep}")[:-4] + ".txt"


def _same_batch(got: dict, ref: dict, keys=("images", "hw", "labels", "mask",
                                              "orig_shapes", "indices")):
    for k in keys:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_synthetic_files_match_jax(sets):
    jds, pds = sets
    assert isinstance(pds, PD.DetectionDataset) and len(pds) == N
    for j, p in zip(jds.img_files, pds.img_files):
        assert os.path.basename(j) == os.path.basename(p)
        with open(j, "rb") as a, open(p, "rb") as b:
            assert a.read() == b.read(), p
        with open(_label_file(j)) as a, open(_label_file(p)) as b:
            assert a.read() == b.read(), p
    for a, b in zip(jds.labels, pds.labels):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # without a root: in memory, the same labels
    mem = PD.make_synthetic_dataset(N, SIZE, 2, MAX_LABELS, seed=5)
    assert isinstance(mem, PD.InMemoryDataset)
    for a, b in zip(mem.labels, pds.labels):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_label_cache_is_shared_and_invalidated(sets, tmp_path, writer,
                                               monkeypatch):
    """One package writes ``labels.cache.npz``; the other reads it without
    parsing a label file, with the same labels; after a label file is
    edited, the reader parses anew and sees the edit."""
    import shutil

    root = tmp_path / "set"
    shutil.copytree(os.path.dirname(os.path.dirname(sets[1].img_files[0])),
                    root)
    images = str(root / "images")
    make, read = (JD, PD) if writer == "jax" else (PD, JD)
    first = make.DetectionDataset.from_path(images, SIZE, nc=2,
                                            max_labels=MAX_LABELS)
    cache = root / "images" / "labels.cache.npz"
    assert cache.is_file()
    with np.load(cache) as z:
        assert sorted(z.files) == ["counts", "data", "key"]
    assert PD._cache_key(first.img_files, 2) == \
        JD._cache_key(first.img_files, 2)

    def no_parse(*a):
        raise AssertionError("parsed a label file despite the cache")

    with monkeypatch.context() as m:
        m.setattr(read, "load_label_file", no_parse)
        hit = read.DetectionDataset.from_path(images, SIZE, nc=2,
                                              max_labels=MAX_LABELS)
    assert hit.img_files == first.img_files
    for a, b in zip(hit.labels, first.labels):
        np.testing.assert_array_equal(a, b)
    # an edited label file changes its size and mtime: the key
    path = _label_file(first.img_files[3])
    with open(path, "a") as f:
        f.write("\n1 0.500000 0.500000 0.100000 0.100000")
    os.utime(path, ns=(1, 10 ** 18))
    stale = read.DetectionDataset.from_path(images, SIZE, nc=2,
                                            max_labels=MAX_LABELS)
    assert len(stale.labels[3]) == len(first.labels[3]) + 1
    np.testing.assert_array_equal(stale.labels[3],
                                  JD.load_label_file(path, 2))
    # and the cache was rewritten under the new key, which the other reads
    with monkeypatch.context() as m:
        m.setattr(make, "load_label_file", no_parse)
        again = make.DetectionDataset.from_path(images, SIZE, nc=2,
                                                max_labels=MAX_LABELS)
    np.testing.assert_array_equal(again.labels[3], stale.labels[3])
    # nc is in the key
    assert PD._cache_key(first.img_files, 3) != \
        PD._cache_key(first.img_files, 2)


def test_from_path_yaml_split_and_list(sets, tmp_path):
    """A dataset YAML's split and nc, and a ``.txt`` list with its cache
    beside it, as the JAX package reads them."""
    images = os.path.dirname(sets[1].img_files[0])
    (tmp_path / "data.yaml").write_text(
        f"train: {images}\nval: {images}\nnc: 2\nnames: [a, b]\n")
    ds = PD.DetectionDataset.from_path(tmp_path / "data.yaml", SIZE,
                                       split="train")
    assert ds.nc == 2 and ds.img_files == sets[1].img_files
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(sets[1].img_files[:4]))
    got = PD.DetectionDataset.from_path(str(lst), SIZE, nc=2)
    ref = JD.DetectionDataset.from_path(str(lst), SIZE, nc=2)
    assert got.img_files == ref.img_files and (tmp_path /
                                               "list.cache.npz").is_file()
    for a, b in zip(got.labels, ref.labels):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["ram", "disk"])
def test_cache_images_match_jax(sets, tmp_path, mode):
    import shutil

    roots = {}
    for name, ds in zip(("jax", "port"), sets):
        roots[name] = tmp_path / name
        shutil.copytree(os.path.dirname(os.path.dirname(ds.img_files[0])),
                        roots[name])
    jds = JD.DetectionDataset.from_path(str(roots["jax"] / "images"), SIZE,
                                        2, MAX_LABELS, cache=False)
    pds = PD.DetectionDataset.from_path(str(roots["port"] / "images"), SIZE,
                                        2, MAX_LABELS, cache=False)
    plain = [pds.load_item(i) for i in range(N)]
    jds.cache_images(mode, workers=2)
    pds.cache_images(mode, workers=2)
    assert pds.cache_mode == mode
    for i in range(N):
        got, ref = pds.load_item(i), jds.load_item(i)
        for a, b, c in zip(got, ref, plain[i]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    if mode == "disk":
        for j, p in zip(jds.img_files, pds.img_files):
            for suffix in (".r64.npy", ".r64.hw.npy"):
                with open(j[:-4] + suffix, "rb") as a, \
                        open(p[:-4] + suffix, "rb") as b:
                    assert a.read() == b.read()
        # the JAX package's cache files are read as they are
        other = PD.DetectionDataset.from_path(str(roots["jax"] / "images"),
                                              SIZE, 2, MAX_LABELS)
        other.cache_images("disk")
        for i in range(N):
            _same_batch(dict(zip("abcde", other.load_item(i))),
                        dict(zip("abcde", plain[i])), keys="abcde")


LOADER_CASES = {
    "in_order": dict(shuffle=False),
    "shuffled": dict(),
    "shuffled_tail": dict(drop_last=False),
    "shard0of3": dict(shard_index=0, num_shards=3, drop_last=False),
    "shard2of3": dict(shard_index=2, num_shards=3),
    "shard1of2_tail": dict(shard_index=1, num_shards=2, drop_last=False),
    "weights": dict(weights="ramp"),
    "weights_tail": dict(weights="ramp", drop_last=False),
    "weights_zero": dict(weights="zero", drop_last=False),
    "weights_shard": dict(weights="ramp", shard_index=1, num_shards=2),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_matches_jax(sets, case):
    kw = dict(LOADER_CASES[case])
    weights = kw.pop("weights", None)
    iw = {None: None, "ramp": np.arange(N, dtype=np.float64) ** 2,
          "zero": np.zeros(N)}[weights]
    jds, pds = sets
    order_kw = {k: v for k, v in kw.items() if k != "drop_last"}
    for epoch in (0, 3):
        args = dict(batch_size=3, seed=11, **kw)
        ref = list(JD.Loader(jds, **args).epoch(epoch, image_weights=iw))
        loader = PD.Loader(pds, **args)
        got = list(loader.epoch(epoch, image_weights=iw))
        assert len(got) == len(ref) > 0
        assert len(loader) == len(JD.Loader(jds, **args))
        for g, r in zip(got, ref):
            _same_batch(g, r)
        every = JD.Loader(jds, 1, seed=11, drop_last=False, **order_kw)
        np.testing.assert_array_equal(
            PD.epoch_order(N, 11, epoch, image_weights=iw, **order_kw),
            np.concatenate([r["indices"] for r in every.epoch(
                epoch, image_weights=iw)]))
    if weights == "zero":      # all-zero weights: uniform draws
        assert len(set(int(i) for b in got for i in b["indices"])) > 1


@pytest.mark.parametrize("bs,drop_last", [(4, True), (8, False), (4, False)])
def test_epoch_quad_matches_jax(sets, bs, drop_last):
    """Both branches of the quad collate, and with the last partial batch
    a group of fewer than four (always the 2x upscale)."""
    jds, pds = sets
    for epoch in (0, 1, 2):
        ref = list(JD.Loader(jds, bs, seed=2, drop_last=drop_last)
                   .epoch_quad(epoch))
        got = list(PD.Loader(pds, bs, seed=2, drop_last=drop_last)
                   .epoch_quad(epoch))
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            _same_batch(g, r)
    with pytest.raises(ValueError):
        next(PD.Loader(pds, 3).epoch_quad(0))


def test_label_weights_match_jax(sets):
    labels = list(sets[1].labels) + [np.zeros((0, 5), np.float32)]
    for nc in (2, 3):
        cw = PG.labels_to_class_weights(labels, nc)
        np.testing.assert_array_equal(cw, JG.labels_to_class_weights(labels,
                                                                     nc))
        maps = np.linspace(0.1, 0.9, nc)
        w = cw * (1 - maps) ** 2 / nc
        for class_w in (None, w):
            np.testing.assert_array_equal(
                PG.labels_to_image_weights(labels, nc, class_w),
                JG.labels_to_image_weights(labels, nc, class_w))
