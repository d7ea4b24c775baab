"""Device resolution and the lazy build of the CUDA kernels.

Entry points run on ``cuda`` unless the caller asks for the CPU; without a
CUDA device they raise instead of silently running elsewhere.

Kernels live in ``csrc/*.cu`` with a plain C interface. ``load_kernel``
compiles them with ``nvcc`` for ``sm_90a`` into ``_build/<hash>/`` (one
``nvcc`` per source, all started together), keyed by a hash of the sources
and flags, and loads the shared library with ctypes. Nothing is built at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

PKG_DIR = pathlib.Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
# Per-source extra flags. The NMS IoU must round exactly like its plain
# version (no fused multiply-add contraction), or boxes at the threshold
# flip.
EXTRA_FLAGS = {"nms.cu": ["--fmad=false"]}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def have_cuda() -> bool:
    return torch.cuda.is_available()


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card. Raise when a CUDA device is asked for (or
    defaulted to) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not have_cuda():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def _flags(src: pathlib.Path) -> list[str]:
    return ARCH_FLAGS + COMMON_FLAGS + EXTRA_FLAGS.get(src.name, [])


def _build_key() -> str:
    h = hashlib.sha256()
    for src in sorted(CSRC_DIR.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
        h.update(" ".join(_flags(src)).encode())
    return h.hexdigest()[:16]


def build_kernels() -> dict[str, pathlib.Path]:
    """Compile every ``csrc/*.cu`` that is not built yet, in parallel.
    Returns {source stem: path of its shared library}."""
    out_dir = BUILD_DIR / _build_key()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs, libs = [], {}
    for src in sorted(CSRC_DIR.glob("*.cu")):
        lib = out_dir / f"lib{src.stem}.so"
        libs[src.stem] = lib
        if lib.exists():
            continue
        tmp = out_dir / f"lib{src.stem}.so.tmp{os.getpid()}"
        cmd = [nvcc, *_flags(src), "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for src, lib, tmp, cmd, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{' '.join(cmd)}\n{out.decode(errors='replace')}")
            continue
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return libs


def load_kernel(stem: str) -> ctypes.CDLL:
    """The loaded shared library built from ``csrc/<stem>.cu``."""
    with _LOCK:
        if stem not in _LIBS:
            libs = build_kernels()
            if stem not in libs:
                raise KeyError(f"no kernel source csrc/{stem}.cu")
            _LIBS[stem] = ctypes.CDLL(str(libs[stem]))
        return _LIBS[stem]


def stream_handle(t: torch.Tensor) -> ctypes.c_void_p:
    """The current CUDA stream of ``t``'s device, as a ctypes pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_launch(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a C entry."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
