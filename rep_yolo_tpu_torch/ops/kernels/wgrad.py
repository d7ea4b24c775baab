"""Weight gradient of a 3x3 stride-1 pad-1 conv: CUDA kernel + plain version,
and the autograd function that routes a conv's backward to it.

Replaces ``rep_yolo_tpu/ops/pallas/wgrad_kernel.py:wgrad3x3_nhwc`` and its
custom vjp ``conv3x3_pallas_wgrad``. Source: ``csrc/wgrad.cu`` (K9
``wgrad3x3``: Winograd F(3x3, 2x2), its 16 products per 2x2 tile of dY as 16
GEMMs on the TF32 tensor cores in 3xTF32, split-K over the tiles reduced in
a fixed order).

Tensors are the network's: x (B, C, H, W) and dY (B, O, H, W) float32, dW
(O, C, 3, 3) (OIHW). The wrapper takes the plain version for CPU tensors
only; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rep_yolo_tpu_torch import device as D

LAUNCHES = {"wgrad3x3": 0}


def _lib():
    lib = D.load_kernel("wgrad")
    if not getattr(lib, "_typed", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.wgrad3x3_workspace.argtypes = [i32] * 5
        lib.wgrad3x3_workspace.restype = ctypes.c_longlong
        lib.wgrad3x3.argtypes = [vp] * 4 + [i32] * 5 + [vp]
        lib.wgrad3x3.restype = i32
        lib._typed = True
    return lib


def wgrad3x3_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """One ``einsum`` per tap over the zero-padded x: (O, C, 3, 3)."""
    H, W = dy.shape[2], dy.shape[3]
    xp = F.pad(x, (1, 1, 1, 1))
    taps = [torch.einsum("nchw,nohw->oc", xp[:, :, u:u + H, v:v + W], dy)
            for u in range(3) for v in range(3)]
    return torch.stack(taps, -1).reshape(dy.shape[1], x.shape[1], 3, 3)


def wgrad3x3(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """K9. CPU tensors take ``wgrad3x3_plain``."""
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return wgrad3x3_plain(x, dy)
    if (x.device.type != "cuda" or dy.device != x.device
            or x.dtype != torch.float32 or dy.dtype != torch.float32
            or x.dim() != 4 or dy.dim() != 4
            or x.shape[0] != dy.shape[0] or x.shape[2:] != dy.shape[2:]):
        raise ValueError(
            f"wgrad3x3: expected float32 CUDA x (B, C, H, W) and dy (B, O, "
            f"H, W) on one device, got {x.device} {x.dtype} "
            f"{tuple(x.shape)} and {dy.device} {dy.dtype} {tuple(dy.shape)}")
    B, C, H, W = x.shape
    O = dy.shape[1]
    x, dy = x.contiguous(), dy.contiguous()
    lib = _lib()
    dw = torch.empty((O, C, 3, 3), device=x.device, dtype=torch.float32)
    ws = torch.empty((lib.wgrad3x3_workspace(B, C, H, W, O),),
                     device=x.device, dtype=torch.float32)
    err = lib.wgrad3x3(D.ptr(x), D.ptr(dy), D.ptr(dw), D.ptr(ws), B, C, H, W,
                       O, D.stream_handle(x))
    D.check_launch("wgrad3x3", err)
    LAUNCHES["wgrad3x3"] += 1
    return dw


class Conv3x3WGrad(torch.autograd.Function):
    """``F.conv2d(x, w, padding=1)`` whose weight gradient is ``wgrad3x3``
    (port of ``conv3x3_pallas_wgrad``); the input gradient stays a library
    call (cuDNN), as the JAX package left it to XLA."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.conv2d(x, w, None, 1, 1)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(x.shape, w, dy, padding=1)
        if ctx.needs_input_grad[1]:
            dw = wgrad3x3(x, dy)
        return dx, dw


def conv3x3_wgrad(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return Conv3x3WGrad.apply(x, w)
