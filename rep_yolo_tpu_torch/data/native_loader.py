"""The native loader (port of ``rep_yolo_tpu/data/native_loader.py``):
images decoded by cv2 in a pool of threads and resized and padded by C++.

``native/loader.cpp`` (the resize of the JAX package's native loader) is
built with g++ at first use into ``_build/native-<hash>/libryloader.so``,
keyed by a hash of the source and the command, and loaded with ctypes;
nothing is built at import time. ``available()`` says whether it builds
and loads, ``build_error()`` why not (g++ failed or is missing, or the
build directory cannot be written), ``build_seconds()`` how long the build
took in this process.

``NativeLoader`` gives the epochs of ``data.datasets.Loader(...,
drop_last=False)``: the index order is computed with the same numpy calls
(``datasets.epoch_order``: the seeded shuffle, image-weight resampling,
shard slicing). Each thread of the pool decodes a batch's images with cv2
(``datasets.read_rgb``; its libjpeg-turbo decode equals the JAX loader's
libjpeg one byte for byte) and pads each by the C++ resize (ctypes drops
the GIL for the call); batches are handed out in the order they were
claimed, whatever thread finishes first. The last batch may be partial:
its empty slots hold pad 114, ``hw`` (0, 0), index -1 and no label; an
image that does not decode leaves its slot so too, as in the JAX package.
A dataset cached by ``cache_images`` is served by gathers from its cache
instead (the decode is already paid). The resize is the JAX native
loader's, so a canvas equals its byte for byte; it differs from cv2's
resize (the JAX package's own test allows a mean of 10 levels).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator

import numpy as np

from rep_yolo_tpu_torch.data.datasets import PAD_VALUE, epoch_order, read_rgb

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "native" / "loader.cpp"
BUILD_DIR = PKG_DIR / "_build"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LOCK = threading.Lock()
_lib = None
_tried = False
_build_error: str | None = None
_build_seconds: float | None = None


def build_command(out: Path) -> list[str]:
    """The g++ command that builds ``native/loader.cpp`` into ``out``."""
    return ["g++", *FLAGS, str(SOURCE), "-o", str(out)]


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(build_command(Path("x"))).encode())
    return BUILD_DIR / f"native-{key.hexdigest()[:16]}" / "libryloader.so"


def _build() -> tuple[Path | None, str | None]:
    """-> (the library, None) or (None, the build error)."""
    global _build_seconds
    so = library_path()
    if so.exists():
        return so, None
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    t = time.perf_counter()
    try:
        so.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(build_command(tmp), check=True, capture_output=True,
                       text=True)
        os.replace(tmp, so)
    except subprocess.CalledProcessError as e:
        return None, f"{' '.join(e.cmd)}\n{e.stderr}"
    except FileNotFoundError as e:
        return None, f"g++ not found: {e}"
    except OSError as e:                # e.g. a read-only install
        return None, f"cannot build into {so.parent}: {e}"
    finally:
        _build_seconds = (_build_seconds or 0.0) + time.perf_counter() - t
    return so, None


def _load():
    """The library with its entry typed, or None where it does not build
    or load."""
    global _lib, _tried, _build_error
    with _LOCK:
        if _tried:
            return _lib
        _tried = True
        so, _build_error = _build()
        if so is not None:
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as e:
                _build_error = f"{so} does not load: {e}"
                return None
            lib.ryt_resize_pad.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_void_p]
            _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


def build_seconds() -> float | None:
    """Seconds the g++ build took in this process, a failed one included
    (None: nothing was built)."""
    _load()
    return _build_seconds


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def _decode_into(lib, path: str, img_size: int, canvas: np.ndarray,
                 hw: np.ndarray) -> tuple[int, int] | None:
    """Image ``path`` decoded by ``read_rgb``, resized and padded by the
    library into ``canvas`` (S, S, 3) with its content (h, w) in ``hw``.
    -> (h0, w0), or None where it does not decode."""
    try:
        rgb = np.ascontiguousarray(read_rgb(path))
    except Exception:
        return None
    lib.ryt_resize_pad(_ptr(rgb), rgb.shape[0], rgb.shape[1], img_size,
                       _ptr(canvas), _ptr(hw))
    return rgb.shape[0], rgb.shape[1]


def load_one(path: str, img_size: int):
    """One image decoded, resized and padded natively: (canvas (S, S, 3)
    uint8, hw (2,) float32, (h0, w0)), or None where it does not decode or
    the library does not load."""
    lib = _load()
    if lib is None:
        return None
    canvas = np.empty((img_size, img_size, 3), np.uint8)
    hw = np.empty((2,), np.float32)
    orig = _decode_into(lib, path, img_size, canvas, hw)
    return None if orig is None else (canvas, hw, orig)


class NativeLoader:
    """Batches decoded ahead by the pool of threads, with ``Loader``'s
    epoch order; labels and masks come from the dataset's parsed labels,
    padded once. ``n_threads`` defaults to min(8, CPUs)."""

    def __init__(self, ds, batch_size: int, shuffle: bool = True,
                 seed: int = 0, n_threads: int | None = None,
                 shard_index: int = 0, num_shards: int = 1):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        if not hasattr(ds, "img_files"):
            raise TypeError("the native loader reads image files: "
                            f"{type(ds).__name__} has none")
        self.lib = lib
        self.ds = ds
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.n_threads = n_threads or min(8, os.cpu_count() or 1)
        self.pool = ThreadPoolExecutor(self.n_threads)
        self.closed = False
        M, n = ds.max_labels, len(ds.img_files)
        self.all_labels = np.zeros((n, M, 5), np.float32)
        self.all_masks = np.zeros((n, M), bool)
        for i, lab in enumerate(ds.labels):
            k = min(len(lab), M)
            self.all_labels[i, :k] = lab[:k]
            self.all_masks[i, :k] = True

    def _epoch_order(self, epoch: int,
                     image_weights: "np.ndarray | None") -> np.ndarray:
        return epoch_order(len(self.ds), self.seed, epoch, self.shuffle,
                           image_weights, self.shard_index, self.num_shards)

    def __len__(self) -> int:
        n = -(-len(self.ds) // self.num_shards)   # the first shard's items
        return -(-n // self.bs)                   # the partial tail counts

    def _batch(self, images, hw, indices, count: int) -> dict:
        idx = np.clip(indices, 0, len(self.ds.img_files) - 1)
        return dict(images=images, hw=hw, labels=self.all_labels[idx],
                    mask=self.all_masks[idx]
                    & (np.arange(self.bs) < count)[:, None],
                    indices=indices)

    def _empty(self):
        S = self.ds.img_size
        return (np.full((self.bs, S, S, 3), PAD_VALUE, np.uint8),
                np.zeros((self.bs, 2), np.float32),
                np.full((self.bs,), -1, np.int32))

    def epoch(self, epoch: int = 0,
              image_weights: "np.ndarray | None" = None) -> Iterator[dict]:
        if self.closed:
            raise RuntimeError("the native loader is closed")
        idx = self._epoch_order(epoch, image_weights)
        if getattr(self.ds, "cache_mode", None) is not None:
            yield from self._epoch_cached(idx)
        else:
            yield from self._epoch_pool(idx)

    def _decode_batch(self, sel: np.ndarray) -> dict:
        images, hw, indices = self._empty()
        for j, i in enumerate(sel):
            indices[j] = i
            # an image that does not decode keeps its padding
            _decode_into(self.lib, self.ds.img_files[i], self.ds.img_size,
                         images[j], hw[j])
        return self._batch(images, hw, indices, len(sel))

    def _epoch_pool(self, idx: np.ndarray) -> Iterator[dict]:
        """Batches decoded by the pool, a batch a task, every thread busy
        and at most four more batches waiting; handed out in claim
        order."""
        sels = [idx[b:b + self.bs] for b in range(0, len(idx), self.bs)]
        ahead = deque()
        try:
            for sel in sels:
                ahead.append(self.pool.submit(self._decode_batch, sel))
                if len(ahead) > self.n_threads + 4:
                    yield ahead.popleft().result()
            while ahead:
                yield ahead.popleft().result()
        finally:
            for f in ahead:
                f.cancel()

    def _epoch_cached(self, idx: np.ndarray) -> Iterator[dict]:
        """Batches gathered from the dataset's cache, the tail padded as
        the pool pads it."""
        for b0 in range(0, len(idx), self.bs):
            sel = idx[b0:b0 + self.bs]
            images, hw, indices = self._empty()
            for j, i in enumerate(sel):
                canvas, chw, _ = self.ds.canvas(int(i))
                images[j], hw[j], indices[j] = canvas, chw, i
            yield self._batch(images, hw, indices, len(sel))

    def close(self) -> None:
        if self.pool is not None:
            self.pool.shutdown(cancel_futures=True)
            self.pool = None
        self.closed = True

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
