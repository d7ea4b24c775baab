"""Fused axial (criss-cross / vertical) attention: CUDA kernels + plain version.

Replaces ``rep_yolo_tpu/ops/pallas/axial_attention.py``:
``criss_cross_fused_x`` / ``vertical_fused_x`` (kernel body
``_axis_kernel_x``) and, on the row-3 route, ``criss_cross_fused`` /
``vertical_fused``. Source: ``csrc/axial_attention.cu``: K1
``axial_project`` (the q/k/v projection, 32 / 64-pixel tiles of the whole
C); K2 ``axial_line``, one line kernel (a block a column or a row, its keys
and values streamed once in chunks) in three modes: vertical (raw column
energies), and criss-cross as a row pass (softmax statistics, partials
out) then a column pass that merges the two under the joint softmax.

Layouts follow the TPU kernel: x ``(B, H, W, C)`` f32; packed deploy
constants ``wqk (2*c8, C)``, ``pq (3, 2*c8)``, ``pv (4, C)`` (see
``nn.blocks.axial_consts``). The wrappers take the plain versions for CPU
tensors only; on a CUDA tensor they launch the kernel or raise. They go
through the custom ops ``rep_yolo_torch::axial_project`` and
``rep_yolo_torch::axial_attend`` (``torch.library``), whose CUDA
implementation is the kernel launch and whose CPU implementation is the
plain version, so a ``torch.export`` graph holds the ops on either device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rep_yolo_tpu_torch import device as D

# Launches on the card, per wrapper (the attend kernel counted per mode).
LAUNCHES = {"axial_project": 0, "axial_attend_criss_cross": 0,
            "axial_attend_vertical": 0}

SMEM_MAX = 232448                # bytes of shared memory a block may use
THREADS = 256                    # threads a block, K1 and K2
NUM_SMS = 132                    # H100 SXM: K1 picks its pixel tile by it

# K1: P_TJ column threads x 32 pixel threads, rp pixels and rj columns a
# thread
P_TJ = 8
# K2: at most V_MAX_TC channel float4s and V_MAX_RQ query pixels a thread,
# at most V_MAX_QT query pixels a tile
V_MAX_TC, V_MAX_RQ, V_MAX_QT = 64, 8, 256
V_MAX_STAGES = 4                 # key chunks in flight
V_SMEM_BUDGET = 96 * 1024        # fewer stages past this (2 blocks an SM)
# K2's modes (LineMode in csrc/axial_attention.cu)
LINE_RAW, LINE_ROW, LINE_MERGE = 0, 1, 2


def _lib():
    lib = D.load_kernel("axial_attention")
    if not getattr(lib, "_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.axial_project.argtypes = [vp] * 7 + [i64] + [i32] * 4 + [vp]
        lib.axial_project.restype = i32
        lib.axial_project_smem.argtypes = [i32] * 3
        lib.axial_project_smem.restype = i64
        lib.axial_line.argtypes = [vp] * 9 + [i32] * 11 + [vp]
        lib.axial_line.restype = i32
        lib.axial_line_smem.argtypes = [i32] * 6
        lib.axial_line_smem.restype = i64
        lib._typed = True
    return lib


# ---------------------------------------------------------------------------
# tiles (host side; the tests hold them on the CPU)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def project_tile(C: int, c8: int, npix: int) -> dict:
    """K1's tile for C input channels, 2*c8 q/k columns and npix pixels:
    ``rp`` pixels and ``rj`` columns a thread, so a block takes ``tp`` = 32
    * rp pixels and ``ng`` = 8 * rj columns (``ngroups`` column groups, the
    last padded with zero weights), the whole of C at once; ``smem`` the
    dynamic shared memory in bytes (the formula of ``axial_project_smem``).
    Raises ValueError where no tile fits."""
    nq = 2 * c8
    if C < 4 or C % 4 or c8 < 1 or npix < 1:
        raise ValueError(f"axial_project: C = {C} must be a positive "
                         f"multiple of 4 (16-byte staging), c8 = {c8}, "
                         f"npix = {npix}")
    rj = 1 if nq <= P_TJ else 2
    ng = P_TJ * rj
    ngroups = -(-nq // ng)
    # 64 pixels a block where C is narrow and the grid keeps a block an SM
    rp = 2 if C <= 128 and -(-npix // 64) * ngroups >= NUM_SMS else 1
    tp = THREADS // P_TJ * rp
    smem = 4 * ((tp + ng) * (C + 4) + 4 * C)
    if smem > SMEM_MAX:
        raise ValueError(f"axial_project: C = {C} needs {smem} bytes of "
                         f"shared memory")
    return {"rp": rp, "rj": rj, "tp": tp, "ng": ng, "ngroups": ngroups,
            "smem": smem}


def key_pitch(c8: int) -> int:
    """Floats a staged query / key row of the line kernel: c8 padded to
    whole float4s, plus one float4 where that count is even."""
    p = -(-c8 // 4) * 4
    return p if (p // 4) % 2 else p + 4


@functools.lru_cache(maxsize=None)
def line_tile(L: int, C: int, c8: int, mode: int = LINE_RAW) -> dict:
    """K2's tile for a line (a column or a row) of L pixels and C channels:
    ``tc`` channel float4s and ``tq`` = 256 / tc query pixels of threads,
    ``rq`` pixels a thread, so a block covers ``qt`` = tq * rq query pixels
    and ``ct`` = 4 * tc channels (``qtiles`` x ``ctiles`` blocks a line);
    keys in chunks of ``kch`` pixels, ``stages`` of them in flight (the
    whole line where it has at most 4 chunks and fits V_SMEM_BUDGET);
    ``mode`` LINE_RAW (vertical), LINE_ROW or LINE_MERGE (criss-cross's
    passes, which add the running softmax statistics); ``smem`` the dynamic
    shared memory in bytes (the formula of ``axial_line_smem``). Raises
    ValueError where no tile fits."""
    if C < 4 or C % 4 or c8 < 1 or L < 1:
        raise ValueError(f"axial_attend: C = {C} must be a positive "
                         f"multiple of 4 (16-byte staging), c8 = {c8}, "
                         f"line of {L}")
    tc = 1
    while tc < V_MAX_TC and (C // 4) % (2 * tc) == 0:
        tc *= 2
    tq = THREADS // tc
    qtiles = -(-L // min(V_MAX_RQ * tq, V_MAX_QT))
    rows = -(-L // qtiles)                       # query pixels a tile, at most
    rq = -(-rows // tq)
    qt = tq * rq
    ct = 4 * tc
    qtp = tq * -(-rq // 4) * 4                   # positions of an energy row
    kch = 32 if ct <= 128 else 16
    stats = 3 if mode != LINE_RAW else 0         # Al, Ms, Ss
    for stages in range(min(-(-L // kch), V_MAX_STAGES), 0, -1):
        floats = ((qt + stages * kch) * key_pitch(c8) + stages * kch * ct
                  + (kch + stats) * qtp)
        smem = 4 * floats
        if smem <= V_SMEM_BUDGET or stages == 1:
            break
    if smem > SMEM_MAX:
        raise ValueError(f"axial_attend: the tile of a line of {L}, C={C}, "
                         f"c8={c8} needs {smem} bytes of shared memory")
    return {"tc": tc, "tq": tq, "rq": rq, "qt": qt, "ct": ct,
            "ctiles": C // ct, "qtiles": qtiles, "kch": kch,
            "stages": stages, "smem": smem}


def vertical_tile(H: int, C: int, c8: int) -> dict:
    """K2 vertical's tile: ``line_tile`` of an H-pixel column."""
    return line_tile(H, C, c8)


def criss_cross_tile(H: int, W: int, C: int, c8: int) -> dict:
    """K2 criss-cross's tiles: ``row`` for the row pass (a W-pixel row),
    ``col`` for the merging column pass (an H-pixel column)."""
    return {"row": line_tile(W, C, c8, LINE_ROW),
            "col": line_tile(H, C, c8, LINE_MERGE)}


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
    return qk[..., :c8].contiguous(), qk[..., c8:].contiguous(), v


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


def _aligned(*ts):
    """The tensors, each copied where its data is off 16 bytes."""
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in ts]


def project(x, wqk, pq, pv):
    """K1: q, k, v from x (``rep_yolo_torch::axial_project``). CPU tensors
    take ``project_plain``."""
    return torch.ops.rep_yolo_torch.axial_project(x, wqk, pq, pv)


def launch_project(x, wqk, pq, pv):
    """K1's launch on CUDA tensors, the CUDA implementation of
    ``rep_yolo_torch::axial_project`` (called directly, it skips the
    dispatcher: the host cost of the op is measured against it)."""
    _check_cuda_f32("axial_project", x, wqk, pq, pv)
    if x.dim() != 4:
        raise ValueError(f"axial_project: x must be (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    B, H, W, C = x.shape
    c8 = wqk.shape[0] // 2
    if wqk.shape != (2 * c8, C) or pq.shape != (3, 2 * c8) \
            or pv.shape != (4, C) or c8 < 1:
        raise ValueError(f"axial_project: bad constant shapes {wqk.shape} "
                         f"{pq.shape} {pv.shape} for C={C}")
    tile = project_tile(C, c8, B * H * W)
    x, wqk, pq, pv = _aligned(*(t.contiguous() for t in (x, wqk, pq, pv)))
    q = torch.empty((B, H, W, c8), device=x.device, dtype=x.dtype)
    k = torch.empty_like(q)
    v = torch.empty_like(x)
    err = _lib().axial_project(D.ptr(x), D.ptr(wqk), D.ptr(pq), D.ptr(pv),
                               D.ptr(q), D.ptr(k), D.ptr(v), B * H * W, C,
                               c8, tile["rp"], tile["rj"],
                               D.stream_handle(x))
    D.check_launch("axial_project", err)
    LAUNCHES["axial_project"] += 1
    return q, k, v


def attend(q, k, v, x, gamma, criss_cross: bool):
    """K2: gamma * attention(q, k, v) + x (``rep_yolo_torch::axial_attend``).
    CPU tensors take ``attend_plain``. Vertical launches the line kernel on
    the columns; criss-cross launches its row pass, then its column pass,
    which merges the row pass's partials (allocated here) under the joint
    softmax."""
    return torch.ops.rep_yolo_torch.axial_attend(q, k, v, x, gamma,
                                                 criss_cross)


def launch_attend(q, k, v, x, gamma, criss_cross):
    """K2's launches on CUDA tensors, the CUDA implementation of
    ``rep_yolo_torch::axial_attend``."""
    _check_cuda_f32("axial_attend", q, k, v, x, gamma)
    if x.dim() != 4:
        raise ValueError(f"axial_attend: x must be (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    B, H, W, C = x.shape
    c8 = q.shape[-1]
    if q.shape != (B, H, W, c8) or k.shape != q.shape or v.shape != x.shape \
            or gamma.numel() != 1:
        raise ValueError("axial_attend: shape mismatch")
    if criss_cross:
        tiles = criss_cross_tile(H, W, C, c8)
        passes = ((LINE_ROW, tiles["row"]), (LINE_MERGE, tiles["col"]))
    else:
        passes = ((LINE_RAW, vertical_tile(H, C, c8)),)
    q, k, v, x, gamma = _aligned(*(t.contiguous()
                                   for t in (q, k, v, x, gamma)))
    y = torch.empty_like(x)
    if criss_cross:         # the row pass's O (unnormalised), max and sum
        part = torch.empty(B * H * W * (C + 2), device=x.device,
                           dtype=x.dtype)
        o_w, m_w, s_w = part.split([B * H * W * C, B * H * W, B * H * W])
        partials = (D.ptr(o_w), D.ptr(m_w), D.ptr(s_w))
    else:
        partials = (None, None, None)
    lib, stream = _lib(), D.stream_handle(x)
    ptrs = [D.ptr(a) for a in (q, k, v, x, gamma, y)]
    for mode, t in passes:
        err = lib.axial_line(*ptrs, *partials, B, H, W, C, c8, mode,
                             t["tc"], t["rq"], t["kch"], t["stages"],
                             t["qtiles"], stream)
        D.check_launch("axial_attend", err)
    LAUNCHES["axial_attend_criss_cross" if criss_cross
             else "axial_attend_vertical"] += 1
    return y


# the custom ops: the kernels on CUDA tensors, the plain versions on CPU
# tensors, shapes alone under torch.export's fake tensors
_project_op = torch.library.custom_op(
    "rep_yolo_torch::axial_project", launch_project, mutates_args=(),
    device_types="cuda", schema="(Tensor x, Tensor wqk, Tensor pq, "
                                "Tensor pv) -> (Tensor, Tensor, Tensor)")
_project_op.register_kernel("cpu", project_plain)


@_project_op.register_fake
def _project_fake(x, wqk, pq, pv):
    q = x.new_empty((*x.shape[:-1], wqk.shape[0] // 2))
    return q, torch.empty_like(q), torch.empty_like(x)


_attend_op = torch.library.custom_op(
    "rep_yolo_torch::axial_attend", launch_attend, mutates_args=(),
    device_types="cuda", schema="(Tensor q, Tensor k, Tensor v, Tensor x, "
                                "Tensor gamma, bool criss_cross) -> Tensor")
_attend_op.register_kernel("cpu", attend_plain)
_attend_op.register_fake(
    lambda q, k, v, x, gamma, criss_cross: torch.empty_like(x))


def axial_attention(x, wqk, pq, pv, gamma, criss_cross: bool):
    """Whole attention block from x (B,H,W,C): K1 then K2."""
    q, k, v = project(x, wqk, pq, pv)
    return attend(q, k, v, x, gamma, criss_cross)
