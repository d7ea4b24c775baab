"""The launch floor: an empty kernel (``csrc/launch_floor.cu``) launched at
a kernel call's grid, block and dynamic shared memory.

A yardstick for ``chip_smoke.py``'s timing phases, not a kernel of the port:
it replaces no TPU kernel, no path calls it, and it counts no launches. It
runs on the card only.
"""

from __future__ import annotations

import ctypes

import torch

from rep_yolo_tpu_torch import device as D

KERNEL_NAME = "launch_floor_kernel"


def _lib():
    lib = D.load_kernel("launch_floor")
    if not getattr(lib, "_typed", False):
        lib.launch_floor.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.launch_floor.restype = ctypes.c_int
        lib._typed = True
    return lib


def _dim3(t) -> tuple[int, int, int]:
    t = tuple(int(v) for v in t)
    return t + (1,) * (3 - len(t))


def launch_floor(grid, block, smem: int = 0,
                 device: torch.device | str = "cuda") -> None:
    """Launch the empty kernel once on ``device``'s current stream: ``grid``
    and ``block`` are 1-3 ints each."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"launch_floor: runs on the card, got {dev}")
    err = _lib().launch_floor(*_dim3(grid), *_dim3(block), int(smem),
                              ctypes.c_void_p(
                                  torch.cuda.current_stream(dev).cuda_stream))
    D.check_launch("launch_floor", err)
