"""2x2 stride-2 max pool over int8: CUDA kernel + plain version.

Replaces ``rep_yolo_tpu/ops/pallas/pool_flat.py:max_pool2_flat``. Source:
``csrc/pool_flat.cu`` (K6 ``max_pool2_q8``: bytewise signed max of each
window's four 16-channel vectors, or 4-channel words when C % 16 or an
address is off 16 bytes). x ``(B, H, W, C)`` int8, H and W even, C a
multiple of 4; the output keeps x's scale. The kernel picks its own grid
from the shape (``launch_dims`` reads it). The wrapper takes the plain
version for CPU tensors only; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from rep_yolo_tpu_torch import device as D

LAUNCHES = {"max_pool2_q8": 0}


def _lib():
    lib = D.load_kernel("pool_flat")
    if not getattr(lib, "_typed", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.max_pool2_q8.argtypes = [vp, vp] + [i32] * 4 + [vp]
        lib.max_pool2_q8.restype = i32
        lib.max_pool2_q8_dims.argtypes = [i32] * 5 + [ctypes.POINTER(i32)]
        lib.max_pool2_q8_dims.restype = i32
        lib._typed = True
    return lib


def launch_dims(B: int, H: int, W: int, C: int,
                aligned16: bool = True) -> tuple[tuple, tuple, int]:
    """(grid, block, dynamic shared memory) of K6's launch on a (B, H, W, C)
    int8 map whose pointers are 16-byte aligned or not, as the kernel picks
    them (on the card: it loads the kernel)."""
    dims = (ctypes.c_int * 7)()
    D.check_launch("max_pool2_q8_dims", _lib().max_pool2_q8_dims(
        B, H, W, C // 4, int(aligned16), dims))
    return tuple(dims[:3]), tuple(dims[3:6]), dims[6]


def max_pool2_q8_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, C), any dtype."""
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax((2, 4)).contiguous()


def max_pool2_q8(x: torch.Tensor) -> torch.Tensor:
    """K6. CPU tensors take ``max_pool2_q8_plain``."""
    if x.device.type == "cpu":
        return max_pool2_q8_plain(x)
    if x.device.type != "cuda" or x.dtype != torch.int8 or x.dim() != 4:
        raise ValueError(f"max_pool2_q8: expected a 4-d CUDA int8 tensor, "
                         f"got {x.device} {x.dtype} {tuple(x.shape)}")
    B, H, W, C = x.shape
    if H % 2 or W % 2 or C % 4:
        raise ValueError(f"max_pool2_q8: needs even H, W and C % 4 == 0, "
                         f"got {tuple(x.shape)}")
    x = x.contiguous()
    if x.data_ptr() % 4:
        raise ValueError("max_pool2_q8: the map must start on a 4-byte "
                         "boundary")
    y = torch.empty((B, H // 2, W // 2, C), device=x.device,
                    dtype=torch.int8)
    err = _lib().max_pool2_q8(D.ptr(x), D.ptr(y), B, H, W, C // 4,
                              D.stream_handle(x))
    D.check_launch("max_pool2_q8", err)
    LAUNCHES["max_pool2_q8"] += 1
    return y
