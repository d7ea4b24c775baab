"""Fused axial (criss-cross / vertical) attention: CUDA kernels + plain version.

Replaces ``rep_yolo_tpu/ops/pallas/axial_attention.py``:
``criss_cross_fused_x`` / ``vertical_fused_x`` (kernel body
``_axis_kernel_x``). Source: ``csrc/axial_attention.cu`` (K1
``axial_project``: per-pixel q/k/v projection; K2 ``axial_attend``: the
energies, joint softmax or raw energies, aggregation and residual).

Layouts follow the TPU kernel: x ``(B, H, W, C)`` f32; packed deploy
constants ``wqk (2*c8, C)``, ``pq (3, 2*c8)``, ``pv (4, C)`` (see
``nn.blocks.axial_consts``). The wrappers take the plain versions for CPU
tensors only; on a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from rep_yolo_tpu_torch import device as D

# Launches on the card, per wrapper (the attend kernel counted per mode).
LAUNCHES = {"axial_project": 0, "axial_attend_criss_cross": 0,
            "axial_attend_vertical": 0}

_SMEM_LIMIT = 48 * 1024


def _lib():
    lib = D.load_kernel("axial_attention")
    if not getattr(lib, "_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.axial_project.argtypes = [vp] * 7 + [i64, i32, i32, vp]
        lib.axial_project.restype = i32
        lib.axial_attend.argtypes = [vp] * 6 + [i32] * 6 + [vp]
        lib.axial_attend.restype = i32
        lib.axial_attend_smem.argtypes = [i32] * 4
        lib.axial_attend_smem.restype = i64
        lib._typed = True
    return lib


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path; the reference the kernels are held to)
# ---------------------------------------------------------------------------

def project_plain(x, wqk, pq, pv):
    """x (B,H,W,C) -> q, k (B,H,W,c8), v (B,H,W,C)."""
    c8 = wqk.shape[0] // 2
    qk = torch.matmul(x, wqk.t())
    qk = torch.clamp(torch.nn.functional.silu(qk + pq[0]) * pq[1] + pq[2],
                     0.0, 6.0)
    v = torch.nn.functional.silu(x * pv[0] + pv[1])
    v = torch.clamp(v * pv[2] + pv[3], 0.0, 6.0)
    return qk[..., :c8], qk[..., c8:], v


def attend_plain(q, k, v, x, gamma, criss_cross: bool):
    """Energies, softmax (criss-cross) or raw energies (vertical),
    aggregation and residual: gamma * out + x."""
    e_h = torch.einsum("bhwc,bgwc->bhwg", q, k)          # column energies
    if not criss_cross:
        return gamma * torch.einsum("bhwg,bgwc->bhwc", e_h, v) + x
    e_w = torch.einsum("bhwc,bhgc->bhwg", q, k)          # row energies
    m = torch.maximum(e_w.amax(-1, keepdim=True), e_h.amax(-1, keepdim=True))
    p_w = torch.exp(e_w - m)
    p_h = torch.exp(e_h - m)
    s = p_w.sum(-1, keepdim=True) + p_h.sum(-1, keepdim=True)
    out = (torch.einsum("bhwg,bhgc->bhwc", p_w, v)
           + torch.einsum("bhwg,bgwc->bhwc", p_h, v)) / s
    return gamma * out + x


def axial_attention_plain(x, wqk, pq, pv, gamma, criss_cross: bool):
    q, k, v = project_plain(x, wqk, pq, pv)
    return attend_plain(q, k, v, x, gamma, criss_cross)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda_f32(name: str, *ts):
    for t in ts:
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected CUDA float32 tensors, got "
                             f"{t.device} {t.dtype}")
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{name}: tensors on different devices")


def project(x, wqk, pq, pv):
    """K1: q, k, v from x. CPU tensors take ``project_plain``."""
    if x.device.type == "cpu":
        return project_plain(x, wqk, pq, pv)
    _check_cuda_f32("axial_project", x, wqk, pq, pv)
    B, H, W, C = x.shape
    c8 = wqk.shape[0] // 2
    if wqk.shape != (2 * c8, C) or pq.shape != (3, 2 * c8) \
            or pv.shape != (4, C) or c8 < 1:
        raise ValueError(f"axial_project: bad constant shapes {wqk.shape} "
                         f"{pq.shape} {pv.shape} for C={C}")
    x, wqk, pq, pv = (t.contiguous() for t in (x, wqk, pq, pv))
    q = torch.empty((B, H, W, c8), device=x.device, dtype=x.dtype)
    k = torch.empty_like(q)
    v = torch.empty_like(x)
    err = _lib().axial_project(D.ptr(x), D.ptr(wqk), D.ptr(pq), D.ptr(pv),
                               D.ptr(q), D.ptr(k), D.ptr(v), B * H * W, C,
                               c8, D.stream_handle(x))
    D.check_launch("axial_project", err)
    LAUNCHES["axial_project"] += 1
    return q, k, v


def attend(q, k, v, x, gamma, criss_cross: bool):
    """K2: gamma * attention(q, k, v) + x. CPU tensors take
    ``attend_plain``."""
    if x.device.type == "cpu":
        return attend_plain(q, k, v, x, gamma, criss_cross)
    _check_cuda_f32("axial_attend", q, k, v, x, gamma)
    B, H, W, C = x.shape
    c8 = q.shape[-1]
    if q.shape != (B, H, W, c8) or k.shape != q.shape or v.shape != x.shape \
            or gamma.numel() != 1:
        raise ValueError("axial_attend: shape mismatch")
    lib = _lib()
    if lib.axial_attend_smem(H, W, c8, int(criss_cross)) > _SMEM_LIMIT:
        raise ValueError(f"axial_attend: {H}x{W} exceeds the kernel's "
                         f"shared-memory tile")
    q, k, v, x, gamma = (t.contiguous() for t in (q, k, v, x, gamma))
    y = torch.empty_like(x)
    err = lib.axial_attend(D.ptr(q), D.ptr(k), D.ptr(v), D.ptr(x),
                           D.ptr(gamma), D.ptr(y), B, H, W, C, c8,
                           int(criss_cross), D.stream_handle(x))
    D.check_launch("axial_attend", err)
    LAUNCHES["axial_attend_criss_cross" if criss_cross
             else "axial_attend_vertical"] += 1
    return y


def axial_attention(x, wqk, pq, pv, gamma, criss_cross: bool):
    """Whole attention block from x (B,H,W,C): K1 then K2."""
    q, k, v = project(x, wqk, pq, pv)
    return attend(q, k, v, x, gamma, criss_cross)
