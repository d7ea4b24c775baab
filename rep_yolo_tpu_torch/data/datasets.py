"""Datasets and the epoch loader (port of ``rep_yolo_tpu/data/datasets.py``).

- ``make_synthetic_dataset`` draws the JAX generator's numpy stream. With a
  ``root`` it writes the JAX package's YOLO layout there (``images/NNNNN.jpg``
  through ``cv2.imwrite``, ``labels/NNNNN.txt`` at ``%.6f``), byte for byte
  as the JAX package writes it, and returns a ``DetectionDataset`` of those
  files; without one it holds the images in memory (``InMemoryDataset``,
  resized with ``F.interpolate``), so its labels equal the JAX package's and
  its pixels skip the JPEG round trip.
- ``DetectionDataset`` reads a YOLO-layout directory, a ``.txt`` list of
  images or a dataset YAML from disk (``from_path``), with the JAX package's
  image discovery, label checks and label cache (``load_labels_cached``: one
  ``labels.cache.npz`` beside the directory, or ``<list>.cache.npz``, in the
  JAX package's format and key, so each package reads the other's). Images
  decode with cv2, else PIL (``read_image``). Its canvas resizes with
  ``cv2.resize`` and the JAX package's flags (INTER_AREA below scale 1,
  INTER_LINEAR above) when cv2 is importable, so its canvases equal the JAX
  ``_decode_canvas``'s; without cv2 it takes the in-memory canvas's
  ``F.interpolate``, which differs from cv2 by a few LSB where an image is
  resized. ``cache_images("ram" | "disk")`` pre-decodes the canvases: in
  memory, or as ``.r{S}.npy`` / ``.r{S}.hw.npy`` siblings of the images.

Both make the aspect-kept canvas of ``_decode_canvas`` (longest side =
``img_size``, content top left, pad 114). ``Loader`` gives fixed-shape
batches in the JAX ``Loader``'s order: shuffled or in order, resampled by
image weights, sliced to a shard, with or without the last partial batch;
``epoch_quad`` is the JAX quad collate. ``data/native_loader.py`` gives the
same epochs from C++ decode threads.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch
import torch.nn.functional as F

PAD_VALUE = 114
IMG_FORMATS = {".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".webp"}


# ---------------------------------------------------------------------------
# canvases
# ---------------------------------------------------------------------------

def torch_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """uint8 (h0, w0, 3) -> (h, w, 3): area averaging when shrinking,
    bilinear when growing."""
    shrink = h < img.shape[0]
    t = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    t = F.interpolate(t.float(), size=(h, w),
                      mode="area" if shrink else "bilinear",
                      align_corners=None if shrink else False)
    return t[0].permute(1, 2, 0).round().clamp(0, 255).to(
        torch.uint8).numpy()


def cv2_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """``cv2.resize`` with the JAX ``_decode_canvas``'s flags."""
    import cv2

    interp = cv2.INTER_AREA if h < img.shape[0] else cv2.INTER_LINEAR
    return cv2.resize(img, (w, h), interpolation=interp)


def make_canvas(img: np.ndarray, size: int,
                resize: Callable = torch_resize):
    """-> (canvas (S, S, 3) uint8, hw (2,), orig (2,)): the longest side
    resized to ``size``, content top left, pad 114."""
    h0, w0 = img.shape[:2]
    r = size / max(h0, w0)
    if r != 1:
        img = resize(img, int(h0 * r), int(w0 * r))
    h, w = img.shape[:2]
    out = np.full((size, size, 3), PAD_VALUE, np.uint8)
    out[:h, :w] = img
    return out, np.asarray([h, w], np.float32), \
        np.asarray([h0, w0], np.float32)


def _item(canvas, hw, orig, rows: np.ndarray, max_labels: int):
    lab = np.zeros((max_labels, 5), np.float32)
    mask = np.zeros((max_labels,), bool)
    rows = rows[:max_labels]
    lab[: len(rows)] = rows
    mask[: len(rows)] = True
    return canvas, hw, lab, mask, orig


# ---------------------------------------------------------------------------
# in memory: the synthetic generator
# ---------------------------------------------------------------------------

class InMemoryDataset:
    """Images (h, w, 3) uint8 RGB and labels (n, 5) [cls, xc, yc, w, h]
    normalized to the image."""

    def __init__(self, images: list[np.ndarray], labels: list[np.ndarray],
                 img_size: int, max_labels: int, nc: int):
        self.images = images
        self.labels = labels
        self.img_size = img_size
        self.max_labels = max_labels
        self.nc = nc

    def __len__(self) -> int:
        return len(self.images)

    def image_shapes(self) -> np.ndarray:
        """(n, 2) original (h, w) per image."""
        return np.asarray([im.shape[:2] for im in self.images], np.float32)

    def canvas(self, i: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (canvas (S, S, 3) uint8, hw (2,), orig (2,))."""
        return make_canvas(self.images[i], self.img_size)

    def load_item(self, i: int):
        """-> (canvas, hw (2,), labels (M, 5), mask (M,), orig (2,))."""
        return _item(*self.canvas(i), self.labels[i], self.max_labels)


def make_synthetic_dataset(n: int, img_size: int = 640, nc: int = 1,
                           max_labels: int = 120, seed: int = 0,
                           root: str | Path | None = None):
    """Random boxes on noise, drawn as the JAX package's generator draws
    them (same numpy stream, same labels). With ``root``, written there in
    the JAX package's layout and returned as a ``DetectionDataset`` of the
    files (labels as drawn, not re-read); else an ``InMemoryDataset``."""
    rng = np.random.default_rng(seed)
    images, drawn = [], []
    for _ in range(n):
        h = int(rng.integers(img_size // 2, img_size * 3 // 2))
        w = int(rng.integers(img_size // 2, img_size * 3 // 2))
        img = rng.integers(0, 80, (h, w, 3), np.uint8)
        rows = []
        for _ in range(int(rng.integers(1, 6))):
            bw = float(rng.uniform(0.08, 0.4))
            bh = float(rng.uniform(0.08, 0.4))
            xc = float(rng.uniform(bw / 2, 1 - bw / 2))
            yc = float(rng.uniform(bh / 2, 1 - bh / 2))
            c = int(rng.integers(0, nc))
            x1, y1 = int((xc - bw / 2) * w), int((yc - bh / 2) * h)
            x2, y2 = int((xc + bw / 2) * w), int((yc + bh / 2) * h)
            img[y1:y2, x1:x2] = tuple(int(v) for v in
                                      rng.integers(150, 255, 3))
            rows.append((c, xc, yc, bw, bh))
        images.append(img)
        drawn.append(rows)
    labels = [np.asarray(rows, np.float32) for rows in drawn]
    if root is None:
        return InMemoryDataset(images, labels, img_size, max_labels, nc)
    files = write_yolo_dir(Path(root), images, drawn)
    return DetectionDataset(img_files=files, labels=labels,
                            img_size=img_size, max_labels=max_labels, nc=nc)


def write_yolo_dir(root: Path, images: list[np.ndarray],
                   rows: list[list[tuple]]) -> list[str]:
    """``images/NNNNN.jpg`` (RGB uint8 through ``cv2.imwrite``, its default
    quality 95) and ``labels/NNNNN.txt`` (each row ``(cls, x, y, w, h)`` of
    Python numbers at ``%.6f``) under ``root``, as the JAX
    ``make_synthetic_dataset`` writes them. Returns the image paths."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("writing the synthetic set as JPEG files needs "
                          "cv2 (opencv-python), as in the JAX package") from e
    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "labels").mkdir(parents=True, exist_ok=True)
    files = []
    for i, (img, lab) in enumerate(zip(images, rows)):
        fp = root / "images" / f"{i:05d}.jpg"
        cv2.imwrite(str(fp), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        (root / "labels" / f"{i:05d}.txt").write_text(
            "\n".join(f"{c} {x:.6f} {y:.6f} {bw:.6f} {bh:.6f}"
                      for c, x, y, bw, bh in lab))
        files.append(str(fp))
    return files


# ---------------------------------------------------------------------------
# on disk: YOLO layout
# ---------------------------------------------------------------------------

def load_dataset_spec(path: str | Path) -> dict:
    """Parse a reference-style dataset YAML (train/val/test paths, nc,
    names, optional download command): returns {train, val, test, nc,
    names, download}. Relative paths resolve against the YAML's directory.
    The download command is returned, never executed."""
    import yaml

    path = Path(path)
    with open(path) as f:
        spec = yaml.safe_load(f)
    out = {"nc": int(spec.get("nc", 1)),
           "names": [str(n) for n in spec.get("names", [])],
           "download": spec.get("download")}
    if out["names"] and len(out["names"]) != out["nc"]:
        raise ValueError(
            f"{path}: {len(out['names'])} names but nc={out['nc']} "
            "(reference train.py:85 asserts this)")
    for split in ("train", "val", "test"):
        v = spec.get(split)
        if v is None:
            out[split] = None
            continue
        items = v if isinstance(v, list) else [v]
        resolved = []
        for it in items:
            p = Path(str(it))
            resolved.append(str(p if p.is_absolute() else path.parent / p))
        out[split] = resolved if isinstance(v, list) else resolved[0]
    return out


def _img2label(p: str) -> str:
    """images/... .jpg -> labels/... .txt (reference utils/datasets.py:346-349)."""
    sa = f"{os.sep}images{os.sep}"
    sb = f"{os.sep}labels{os.sep}"
    stem, _ = os.path.splitext(p)
    if sa in stem:
        stem = stem.replace(sa, sb)
    return stem + ".txt"


def discover_images(path: "str | Path | list") -> list[str]:
    """Expand a dir / txt-list / list-of-either into an image file list
    (reference utils/datasets.py:365-385)."""
    if isinstance(path, (list, tuple)):
        out: list[str] = []
        for p in path:
            out += discover_images(p)
        return out
    path = Path(path)
    files: list[str] = []
    if path.is_dir():
        files = sorted(str(p) for p in path.rglob("*")
                       if p.suffix.lower() in IMG_FORMATS)
    elif path.is_file() and path.suffix == ".txt":
        base = path.parent
        for line in path.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            p = Path(line)
            files.append(str(p if p.is_absolute() else base / p))
    else:
        raise FileNotFoundError(f"no images at {path}")
    return files


def image_decoder() -> str:
    """"cv2" or "pil": the decoder ``read_image`` uses; raises when there
    is neither."""
    for mod, name in (("cv2", "cv2"), ("PIL.Image", "pil")):
        try:
            __import__(mod)
            return name
        except ImportError:
            continue
    raise ImportError("reading image files needs an image decoder: install "
                      "opencv-python (cv2) or Pillow (PIL)")


def read_rgb(path: str) -> np.ndarray:
    """Decode an image file to RGB uint8 (h, w, 3): cv2, else PIL."""
    if image_decoder() == "cv2":
        import cv2

        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(f"image not found: {path}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def read_image(path: str) -> np.ndarray:
    """Decode an image file to RGB float32 HWC (the JAX ``read_image``)."""
    return read_rgb(path).astype(np.float32)


def load_label_file(path: str, nc: int) -> np.ndarray:
    """Parse one YOLO label txt -> (n,5) [cls,x,y,w,h]; verify like the
    reference cache (reference utils/datasets.py:477-509)."""
    if not os.path.exists(path):
        return np.zeros((0, 5), np.float32)
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 5:
                rows.append([float(x) for x in parts[:5]])
    if not rows:
        return np.zeros((0, 5), np.float32)
    l = np.asarray(rows, np.float32)  # noqa: E741 - the JAX package's name
    assert (l >= 0).all(), f"negative labels in {path}"
    assert (l[:, 1:] <= 1).all(), f"non-normalized coords in {path}"
    assert (l[:, 0] < nc).all(), f"class id >= nc in {path}"
    l = np.unique(l, axis=0) if len(l) != len(np.unique(l, axis=0)) else l  # noqa: E741
    return l


def _cache_key(files: list[str], nc: int) -> str:
    """md5 of ``nc``, the image paths and the sizes and mtimes of every
    image and label file: any added, removed or edited file invalidates the
    cache. ``nc`` is in the key because a hit skips ``load_label_file``'s
    ``cls < nc`` check (the JAX package's key, byte for byte)."""
    h = hashlib.md5()
    h.update(f"nc={nc}".encode())
    for f in files:
        h.update(f.encode())
        for p in (f, _img2label(f)):
            try:
                st = os.stat(p)
                h.update(f"{st.st_size},{st.st_mtime_ns}".encode())
            except OSError:
                h.update(b"missing")
    return h.hexdigest()


def _cache_path_for(path: Path) -> Path:
    return (path / "labels.cache.npz") if path.is_dir() \
        else path.with_suffix(".cache.npz")


def load_labels_cached(files: list[str], nc: int,
                       cache_path: Path | None) -> list[np.ndarray]:
    """Every label file parsed and checked, memoized in one ``.npz`` keyed
    on ``_cache_key`` (``key``, ``counts`` (n,) int64 and ``data`` (sum,
    5): the ragged labels end to end). A missing, stale or unreadable
    cache is parsed anew and rewritten; a directory that cannot be written
    leaves the labels uncached."""
    key = _cache_key(files, nc)
    if cache_path is not None and cache_path.exists():
        try:
            with np.load(cache_path, allow_pickle=False) as z:
                if str(z["key"]) == key:
                    counts = z["counts"]
                    data = z["data"]
                    offs = np.concatenate([[0], np.cumsum(counts)])
                    return [data[offs[i]:offs[i + 1]]
                            for i in range(len(counts))]
        except Exception:
            pass            # corrupt or stale: parse anew
    labels = [load_label_file(_img2label(f), nc) for f in files]
    if cache_path is not None:
        try:
            data = (np.concatenate(labels, axis=0) if labels
                    else np.zeros((0, 5), np.float32))
            np.savez(cache_path, key=key,
                     counts=np.asarray([len(l) for l in labels], np.int64),
                     data=data)
        except OSError:
            pass            # a read-only dataset: the cache is best effort
    return labels


def canvas_resize() -> Callable:
    """The file canvas's resize: ``cv2_resize`` when cv2 is importable,
    else ``torch_resize``."""
    try:
        import cv2  # noqa: F401
        return cv2_resize
    except ImportError:
        return torch_resize


CACHE_MODES = ("ram", "disk")


@dataclasses.dataclass
class DetectionDataset:
    """Image files and their labels (n, 5) [cls, xc, yc, w, h], decoded
    into fixed-shape canvases at ``load_item`` (or served from
    ``cache_images``' canvases)."""

    img_files: list[str]
    labels: list[np.ndarray]
    img_size: int = 640
    max_labels: int = 120
    nc: int = 1
    cache_mode: str | None = dataclasses.field(default=None, init=False)

    @classmethod
    def from_path(cls, path, img_size: int = 640, nc: int = 1,
                  max_labels: int = 120, split: str = "val",
                  cache: bool = True) -> "DetectionDataset":
        """A YOLO-layout directory (``images/`` beside ``labels/``), a
        ``.txt`` list of images, a list of either, or a dataset YAML (its
        ``split`` paths and its ``nc``). With ``cache`` the labels go
        through ``load_labels_cached`` at ``labels.cache.npz`` in the
        (first) directory, or ``<list>.cache.npz`` beside a list."""
        if str(path).endswith((".yaml", ".yml")):
            spec = load_dataset_spec(path)
            nc = spec["nc"]
            path = spec[split]
            if path is None:
                raise ValueError(f"the dataset YAML has no {split!r} split")
        files = discover_images(path)
        first = path[0] if isinstance(path, (list, tuple)) else path
        labels = load_labels_cached(
            files, nc, _cache_path_for(Path(first)) if cache else None)
        return cls(img_files=files, labels=labels, img_size=img_size,
                   max_labels=max_labels, nc=nc)

    def __len__(self) -> int:
        return len(self.img_files)

    def image_shapes(self) -> np.ndarray:
        """(n, 2) original (h, w) per image, memoized: header-only reads
        with PIL, else a decode."""
        if getattr(self, "_shapes", None) is None:
            try:
                from PIL import Image
            except ImportError:
                Image = None
            shapes = []
            for f in self.img_files:
                if Image is None:
                    shapes.append(read_rgb(f).shape[:2])
                    continue
                with Image.open(f) as im:
                    w, h = im.size
                shapes.append((h, w))
            self._shapes = np.asarray(shapes, np.float32)
        return self._shapes

    def cache_images(self, mode: str = "ram", workers: int = 8) -> None:
        """Pre-decode every canvas (the reference's --cache-images): "ram"
        holds them in memory (S * S * 3 bytes each), "disk" writes each
        once as ``<image>.r{S}.npy`` with its (h, w, h0, w0) in
        ``<image>.r{S}.hw.npy`` (files already there are kept), read back
        at ``load_item``."""
        if mode not in CACHE_MODES:
            raise ValueError(f"cache mode {mode!r}: one of {CACHE_MODES}")
        from concurrent.futures import ThreadPoolExecutor

        if mode == "ram":
            with ThreadPoolExecutor(workers) as ex:
                self._ram = list(ex.map(self.decode_canvas,
                                        range(len(self))))
        else:
            def write(i):
                p = self._npy_path(i)
                if not p.exists():
                    canvas, hw, orig = self.decode_canvas(i)
                    np.save(p, canvas)
                    np.save(str(p)[:-4] + ".hw.npy",
                            np.concatenate([hw, orig]))
            with ThreadPoolExecutor(workers) as ex:
                list(ex.map(write, range(len(self))))
        self.cache_mode = mode

    def _npy_path(self, i: int) -> Path:
        return Path(self.img_files[i]).with_suffix(f".r{self.img_size}.npy")

    def decode_canvas(self, i: int) -> tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
        """Image ``i`` decoded and resized: (canvas (S, S, 3) uint8, hw
        (2,), orig (2,))."""
        return make_canvas(read_rgb(self.img_files[i]), self.img_size,
                           canvas_resize())

    def canvas(self, i: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (canvas (S, S, 3) uint8, hw (2,), orig (2,)), from the cache
        where ``cache_images`` filled one."""
        if self.cache_mode == "ram":
            return self._ram[i]
        if self.cache_mode == "disk":
            p = self._npy_path(i)
            hw_orig = np.load(str(p)[:-4] + ".hw.npy")
            return np.load(p), hw_orig[:2], hw_orig[2:]
        return self.decode_canvas(i)

    def load_item(self, i: int):
        """-> (canvas, hw (2,), labels (M, 5), mask (M,), orig (2,))."""
        return _item(*self.canvas(i), self.labels[i], self.max_labels)


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def epoch_order(n: int, seed: int, epoch: int, shuffle: bool = True,
                image_weights: "np.ndarray | None" = None,
                shard_index: int = 0, num_shards: int = 1) -> np.ndarray:
    """An epoch's image indices, with the JAX ``Loader``'s numpy calls: with
    ``image_weights``, ``n`` draws with replacement from
    ``default_rng(seed + epoch)`` by the normalized weights (weights that
    sum to 0 become uniform); else ``arange(n)``, shuffled by
    ``default_rng(seed + epoch)`` with ``shuffle``; then every
    ``num_shards``-th from ``shard_index``."""
    if image_weights is not None:
        w = np.asarray(image_weights, np.float64)
        if w.sum() <= 0:
            w = np.ones_like(w)
        w = w / w.sum()
        idx = np.random.default_rng(seed + epoch).choice(
            n, size=n, replace=True, p=w)
    else:
        idx = np.arange(n)
        if shuffle:
            np.random.default_rng(seed + epoch).shuffle(idx)
    return idx[shard_index::num_shards]


class Loader:
    """Epochs of fixed-shape numpy batches in the JAX ``Loader``'s order
    (``epoch_order``); with ``drop_last`` the last partial batch is
    dropped. ``shard_index`` / ``num_shards`` give one process its slice of
    every epoch."""

    def __init__(self, ds, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 shard_index: int = 0, num_shards: int = 1):
        self.ds = ds
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.shard_index = shard_index
        self.num_shards = num_shards

    def __len__(self) -> int:
        n = len(self.ds) // self.num_shards
        return n // self.bs if self.drop_last else -(-n // self.bs)

    def epoch(self, epoch: int = 0,
              image_weights: "np.ndarray | None" = None) -> Iterator[dict]:
        idx = epoch_order(len(self.ds), self.seed, epoch, self.shuffle,
                          image_weights, self.shard_index, self.num_shards)
        nb = len(idx) // self.bs if self.drop_last \
            else -(-len(idx) // self.bs)
        for b in range(nb):
            sel = idx[b * self.bs:(b + 1) * self.bs]
            yield collate([self.ds.load_item(i) for i in sel], sel)

    def epoch_quad(self, epoch: int = 0) -> Iterator[dict]:
        """The quad collate (reference collate_fn4): every 4 items become
        one 2S x 2S image, the first item upscaled 2x (nearest) with
        probability 0.5 (and always for a partial group of the tail) or the
        four stitched in a 2 x 2 grid, their labels renormalized to the
        quad canvas; ``batch_size // 4`` images a batch, the draws from
        ``default_rng(seed + 1000 + epoch)``, as in the JAX package."""
        if self.bs % 4:
            raise ValueError("the quad collate needs batch_size % 4 == 0")
        rng = np.random.default_rng(self.seed + 1000 + epoch)
        S = self.ds.img_size
        for batch in self.epoch(epoch):
            imgs, hw = batch["images"], batch["hw"]
            labels, mask = batch["labels"], batch["mask"]
            B, M = mask.shape
            out_i, out_hw, out_l, out_m = [], [], [], []
            for g in range(0, B, 4):
                canvas = np.full((2 * S, 2 * S, 3), PAD_VALUE, imgs.dtype)
                lab = np.zeros((4 * M, 5), np.float32)
                msk = np.zeros((4 * M,), bool)
                if rng.random() < 0.5 or g + 4 > B:
                    h, w = int(hw[g][0]), int(hw[g][1])
                    canvas[: 2 * h, : 2 * w] = np.repeat(np.repeat(
                        imgs[g][:h, :w], 2, 0), 2, 1)
                    lab[:M] = labels[g]
                    msk[:M] = mask[g]
                    out_hw.append([2 * h, 2 * w])
                else:
                    for j, (oy, ox) in enumerate(((0, 0), (0, S), (S, 0),
                                                  (S, S))):
                        k = g + j
                        h, w = int(hw[k][0]), int(hw[k][1])
                        canvas[oy:oy + h, ox:ox + w] = imgs[k][:h, :w]
                        # content-normalized -> the 2S square's
                        ll = labels[k].copy()
                        ll[:, 1] = (labels[k][:, 1] * w + ox) / (2 * S)
                        ll[:, 2] = (labels[k][:, 2] * h + oy) / (2 * S)
                        ll[:, 3] = labels[k][:, 3] * w / (2 * S)
                        ll[:, 4] = labels[k][:, 4] * h / (2 * S)
                        lab[j * M:(j + 1) * M] = ll
                        msk[j * M:(j + 1) * M] = mask[k]
                    out_hw.append([2 * S, 2 * S])
                out_i.append(canvas)
                out_l.append(lab)
                out_m.append(msk)
            yield dict(images=np.stack(out_i),
                       hw=np.asarray(out_hw, np.float32),
                       labels=np.stack(out_l), mask=np.stack(out_m),
                       orig_shapes=np.asarray(out_hw, np.float32),
                       indices=batch["indices"][::4])


def collate(items: list, indices) -> dict:
    """``load_item`` tuples -> a batch dict of stacked arrays."""
    return dict(images=np.stack([it[0] for it in items]),
                hw=np.stack([it[1] for it in items]),
                labels=np.stack([it[2] for it in items]),
                mask=np.stack([it[3] for it in items]),
                orig_shapes=np.stack([it[4] for it in items]),
                indices=np.asarray(indices))
