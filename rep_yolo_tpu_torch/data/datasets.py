"""Datasets and the epoch loader (port of ``rep_yolo_tpu/data/datasets.py``).

- ``make_synthetic_dataset`` draws the JAX generator's numpy stream and holds
  the images in memory (``InMemoryDataset``; the JAX package writes them as
  JPEG files and decodes them again), so its labels for a seed equal the JAX
  package's and its pixels do not. Its canvas resizes with ``F.interpolate``.
- ``DetectionDataset`` reads a YOLO-layout directory, a ``.txt`` list of
  images or a dataset YAML from disk (``from_path``), with the JAX package's
  image discovery and label checks. Images decode with cv2, else PIL
  (``read_image``). Its canvas resizes with ``cv2.resize`` and the JAX
  package's flags (INTER_AREA below scale 1, INTER_LINEAR above) when cv2 is
  importable, so its canvases equal the JAX ``_decode_canvas``'s; without
  cv2 it takes the in-memory canvas's ``F.interpolate``, which differs from
  cv2 by a few LSB where an image is resized. The on-disk label cache
  (``load_labels_cached``, ``.cache`` files) is not ported yet: labels are
  parsed at every ``from_path``.

Both make the aspect-kept canvas of ``_decode_canvas`` (longest side =
``img_size``, content top left, pad 114). ``Loader`` gives fixed-shape
batches, shuffled or in order, with or without the last partial batch.
"""

from __future__ import annotations

import dataclasses
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
                           max_labels: int = 120,
                           seed: int = 0) -> InMemoryDataset:
    """Random boxes on noise, drawn as the JAX package's generator draws
    them (same numpy stream, same labels)."""
    rng = np.random.default_rng(seed)
    images, labels = [], []
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
        labels.append(np.asarray(rows, np.float32))
    return InMemoryDataset(images, labels, img_size, max_labels, nc)


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


def canvas_resize() -> Callable:
    """The file canvas's resize: ``cv2_resize`` when cv2 is importable,
    else ``torch_resize``."""
    try:
        import cv2  # noqa: F401
        return cv2_resize
    except ImportError:
        return torch_resize


@dataclasses.dataclass
class DetectionDataset:
    """Image files and their labels (n, 5) [cls, xc, yc, w, h], decoded
    into fixed-shape canvases at ``load_item``."""

    img_files: list[str]
    labels: list[np.ndarray]
    img_size: int = 640
    max_labels: int = 120
    nc: int = 1

    @classmethod
    def from_path(cls, path, img_size: int = 640, nc: int = 1,
                  max_labels: int = 120,
                  split: str = "val") -> "DetectionDataset":
        """A YOLO-layout directory (``images/`` beside ``labels/``), a
        ``.txt`` list of images, a list of either, or a dataset YAML (its
        ``split`` paths and its ``nc``). Labels are parsed and checked on
        every call (the JAX package's ``.cache`` file is not ported)."""
        if str(path).endswith((".yaml", ".yml")):
            spec = load_dataset_spec(path)
            nc = spec["nc"]
            path = spec[split]
            if path is None:
                raise ValueError(f"the dataset YAML has no {split!r} split")
        files = discover_images(path)
        labels = [load_label_file(_img2label(f), nc) for f in files]
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

    def canvas(self, i: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (canvas (S, S, 3) uint8, hw (2,), orig (2,))."""
        return make_canvas(read_rgb(self.img_files[i]), self.img_size,
                           canvas_resize())

    def load_item(self, i: int):
        """-> (canvas, hw (2,), labels (M, 5), mask (M,), orig (2,))."""
        return _item(*self.canvas(i), self.labels[i], self.max_labels)


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

class Loader:
    """Epochs of fixed-shape numpy batches, in the JAX ``Loader``'s order:
    with ``shuffle`` the indices are ``default_rng(seed + epoch).shuffle``d,
    and with ``drop_last`` the last partial batch is dropped."""

    def __init__(self, ds, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True):
        self.ds = ds
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.ds)
        return n // self.bs if self.drop_last else -(-n // self.bs)

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        for b in range(len(self)):
            sel = idx[b * self.bs:(b + 1) * self.bs]
            yield collate([self.ds.load_item(i) for i in sel], sel)


def collate(items: list, indices) -> dict:
    """``load_item`` tuples -> a batch dict of stacked arrays."""
    return dict(images=np.stack([it[0] for it in items]),
                hw=np.stack([it[1] for it in items]),
                labels=np.stack([it[2] for it in items]),
                mask=np.stack([it[3] for it in items]),
                orig_shapes=np.stack([it[4] for it in items]),
                indices=np.asarray(indices))
