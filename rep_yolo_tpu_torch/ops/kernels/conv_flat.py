"""Int8 3x3 and 1x1 convolutions: CUDA kernels + plain versions.

Replaces ``rep_yolo_tpu/ops/pallas/conv_flat.py``: ``conv3x3_flat_q8`` (K4
``conv3x3_q8``, which also computes the stem's stride-2 conv that the TPU
kernel reached by space-to-depth) and ``conv1x1_flat_q8`` (K5
``conv1x1_q8``: 1-3 input sections, optional fused 2x2/s2 max pool) and
the dense case of ``conv5x5_flat_q8`` (``conv5x5_q8``: K4's stride-1
``wgmma`` core with 25 taps). Source: ``csrc/conv_flat.cu``, the ``wgmma``
core in ``csrc/conv_wgmma.cuh``.

Activations are channels-last, ``(B, H, W, C)``: int8 at a calibrated
per-tensor scale (C a multiple of 4), or float32 quantized inside the
kernel at ``s_in`` (K5: section channels multiples of 4). Weights are a
``QConv``, quantized once. K4 has two designs, chosen by ``k4_route`` from
the shapes, dtype and address alone: an implicit GEMM on the int8 tensor
cores (the nine taps as descriptor offsets) for a stride-1 3x3 on int8
input (route ``wgmma``), a stride-2 3x3 on int8 input (``wgmma_s2``, the
input staged as four parity planes) and a stride-1 3x3 on float32 input
(``wgmma_f32``, quantized while staging); dp4a for the rest (the float32
stride-2 stem, float32 maps whose C is not a multiple of 4 or whose address
is off 16 bytes). ``LAUNCHES_K4_ROUTE`` counts ``conv3x3_q8``'s launches by
route. The dense 5x5 runs the same core with 25 taps, its route from
``dense5_route`` (``wgmma`` on int8 input, ``wgmma_f32`` on float32 input
with C a multiple of 4 at a 16-byte-aligned address, else dp4a), its
launches by route in ``LAUNCHES_DENSE5_ROUTE``. K5 is an implicit GEMM on the int8
tensor cores, its tile and staging granule picked by ``k5_route``. The
output is int8 at ``out_scale`` or, without one, float32, or bfloat16 with
``out_dtype`` (the JAX kernels emit bf16 there; ``ops/kernels/conv_pm.py``
asks for it). The activation is SiLU, ReLU or none. The wrappers take the plain versions for
CPU tensors only; on a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from rep_yolo_tpu_torch import device as D
from rep_yolo_tpu_torch.ops.quant import (epilogue, quantize,
                                          quantize_weights, requant)

LAUNCHES = {"conv3x3_q8": 0, "conv1x1_q8": 0, "conv5x5_q8": 0}
# conv3x3_q8's launches by K4 route (``k4_route``) and conv5x5_q8's by its
# route (``dense5_route``); zeroed with LAUNCHES
LAUNCHES_K4_ROUTE = {"wgmma": 0, "wgmma_s2": 0, "wgmma_f32": 0, "dp4a": 0}
LAUNCHES_DENSE5_ROUTE = {"wgmma": 0, "wgmma_f32": 0, "dp4a": 0}
_TO = 32            # output channels per block of K4
# K5's tiles: output channels a block (BN) -> its 64-row tiles a warpgroup
# (MI); 256 rows a block for BN <= 48, else 128 (with 256, the epilogue's
# tile held 64 / 128 channels to one block an SM, and it ran slower)
K5_TILES = {24: 2, 48: 2, 64: 1, 128: 1, 256: 1}
# K4's wgmma tiles: up to 128 channels (four stages of 256 channels' nine
# taps of weights would not fit in shared memory), 256 positions each (with
# 128, one 64-row tile a warpgroup, ptxas serialized the nine taps' wgmmas)
K4_TILES = {24: 2, 48: 2, 64: 2, 128: 2}
# at stride 2 up to 64 (a stage holds four planes: 128 channels' weights
# beside them would not fit four stages), and a row width of at most 48
# (a wider one's planes would not fit four stages at 64)
K4_S2_TILES = {24: 2, 48: 2, 64: 2}
K4_S2_TW = 48
# the dense 5x5's: up to 64 (a stage holds 25 taps of weights, 25 BN 32
# bytes; three stages at BN 64 take 203 KB)
DENSE5_TILES = {24: 2, 48: 2, 64: 2}
SMS = 132           # the H100's SMs
_ACTS = {"silu": 1, None: 0, "relu": 2}
# the kernels' out_mode: int8 at out_scale, else float32 or bfloat16
_OUT_MODES = {torch.float32: 1, torch.bfloat16: 2}


def _lib():
    lib = D.load_kernel("conv_flat")
    if not getattr(lib, "_typed", False):
        vp, i32, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.conv3x3_q8.argtypes = [vp] * 5 + [i32] * 11 + [f] * 3 + [i32, vp]
        lib.conv3x3_q8.restype = i32
        lib.conv1x1_q8.argtypes = [vp] * 3 + [i32] * 4 + [vp] * 4 \
            + [i32] * 9 + [f] * 3 + [i32, vp]
        lib.conv1x1_q8.restype = i32
        lib.conv_q8_wgmma.argtypes = [vp] * 5 + [i32] * 12 + [f] * 3 \
            + [i32, vp]
        lib.conv_q8_wgmma.restype = i32
        lib._typed = True
    return lib


def fold_weight(weight: torch.Tensor, in_scale: torch.Tensor | None = None,
                perm: torch.Tensor | None = None) -> torch.Tensor:
    """Fold an int8 input's per-channel scales and pending channel
    permutation into float (O, C, k, k) weights (port of ``neck_flat._fold``):
    logical input channel c lives at physical channel ``perm[c]``, and
    ``in_scale`` is in physical order, so the conv runs at s_in = 1 on the
    raw physical data."""
    w = weight.detach().float()
    if perm is not None:
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(len(perm), device=perm.device)
        w = w[:, inv.to(w.device)]
    if in_scale is not None:
        w = w * in_scale.to(w.device)[None, :, None, None]
    return w


class QConv:
    """One conv's weights, quantized once when the int8 plan is built.

    ``w_q`` (O, k, k, Cp) int8, per output channel at ``s_w`` (O,) f32, with
    the input channels zero-padded to Cp, a multiple of 4 (exact); ``bias``
    (O,) f32. ``in_scale`` (C,) and ``perm`` (C,) fold an int8 input's
    per-channel scales (the concat's section scales) and pending channel
    permutation (GSConv's shuffle) into the float weights before they are
    quantized (``fold_weight``). The kernels' packed copies (``packed`` for
    K4 on dp4a, ``packed_wgmma3`` for K4 and K13 on wgmma,
    ``packed_wgmma5`` for the dense 5x5 on wgmma, ``packed_wgmma`` for K5)
    are made at the first launch and kept."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor | None,
                 in_scale: torch.Tensor | None = None,
                 perm: torch.Tensor | None = None):
        w = fold_weight(weight, in_scale, perm)
        if bias is None:
            bias = torch.zeros(w.shape[0], device=w.device)
        w_q, self.s_w = quantize_weights(w)
        O, C, k, _ = w.shape
        cp = -(-C // 4) * 4
        self.w_q = torch.zeros((O, k, k, cp), dtype=torch.int8,
                               device=w.device)
        self.w_q[..., :C] = w_q.permute(0, 2, 3, 1)
        self.bias = bias.detach().float().contiguous()
        self.c_in, self.k = C, k
        self._packed: dict[int, torch.Tensor] = {}

    @property
    def c_out(self) -> int:
        return self.w_q.shape[0]

    def packed(self, kc: int) -> torch.Tensor:
        """int32 words [O/32][Cp/kc][k*k][kc/4][32] (O zero-padded to a
        multiple of 32): one contiguous block per (output block, chunk)."""
        if kc not in self._packed:
            O, k, _, cp = self.w_q.shape
            opad = -(-O // _TO) * _TO
            w = torch.zeros((opad, k * k, cp), dtype=torch.int8,
                            device=self.w_q.device)
            w[:O] = self.w_q.reshape(O, k * k, cp)
            words = w.view(torch.int32)                # (opad, k*k, cp/4)
            self._packed[kc] = words.reshape(
                opad // _TO, _TO, k * k, cp // kc, kc // 4).permute(
                    0, 3, 2, 4, 1).contiguous()
        return self._packed[kc]

    def _packed_taps(self, k: int) -> torch.Tensor:
        """Operand B of the k x k ``wgmma`` core: int8 [chunk][tap]
        [ceil(O/8)][2][8][16]. A chunk is 32 input channels, two groups of
        16 (the channels padded to whole chunks); tap t = k u + v; each
        (chunk, tap) a k32 step of core matrices of 8 output channels x 16
        input channels. Zeros in every pad (and in the output channels past
        O)."""
        key = f"wgmma{k}"
        if key not in self._packed:
            O, kw, _, cp = self.w_q.shape
            if kw != k:
                raise ValueError(f"packed_wgmma{k}: {kw}x{kw} weights")
            og8, kc = -(-O // 8) * 8, -(-cp // 32) * 32
            w = torch.zeros((og8, k * k, kc), dtype=torch.int8,
                            device=self.w_q.device)
            w[:O, :, :cp] = self.w_q.reshape(O, k * k, cp)
            self._packed[key] = w.reshape(
                og8 // 8, 8, k * k, kc // 32, 2, 16).permute(
                    3, 2, 0, 4, 1, 5).contiguous()
        return self._packed[key]

    def packed_wgmma3(self) -> torch.Tensor:
        """K4's (and K13's) operand B on ``wgmma``: int8 [chunk][tap]
        [ceil(O/8)][2][8][16], tap t = 3 u + v (``_packed_taps``)."""
        return self._packed_taps(3)

    def packed_wgmma5(self) -> torch.Tensor:
        """The dense 5x5's operand B on ``wgmma``: int8 [chunk][tap]
        [ceil(O/8)][2][8][16], tap t = 5 u + v, 25 k32 steps a chunk
        (``_packed_taps``)."""
        return self._packed_taps(5)

    def packed_wgmma(self, cs) -> torch.Tensor:
        """K5's operand B for input sections of ``cs`` channels: int8
        [step][ceil(O/8)][2][8][16]. K is each section's channels padded to
        a multiple of 16 (a group), the groups in section order, padded to
        a multiple of 8 (four k32 steps: the kernel's chunks run whole);
        step s holds groups 2s and 2s + 1, each as a core matrix of 8
        output channels x 16 input channels. Zeros in every pad (and in the
        output channels past O)."""
        key = ("wgmma", tuple(int(c) for c in cs))
        if key not in self._packed:
            O = self.c_out
            og8 = -(-O // 8) * 8
            w = self.w_q.reshape(O, -1)
            if self.k != 1 or sum(key[1]) != w.shape[1]:
                raise ValueError(f"packed_wgmma: sections {key[1]} for 1x1 "
                                 f"weights of {w.shape[1]} input channels")
            blocks, off = [], 0
            for c in key[1]:
                blk = torch.zeros((og8, -(-c // 16) * 16), dtype=torch.int8,
                                  device=w.device)
                blk[:O, :c] = w[:, off:off + c]
                blocks.append(blk)
                off += c
            pad = -sum(b.shape[1] for b in blocks) % 128
            if pad:
                blocks.append(torch.zeros((og8, pad), dtype=torch.int8,
                                          device=w.device))
            k = torch.cat(blocks, 1)
            self._packed[key] = k.reshape(og8 // 8, 8, -1, 2, 16).permute(
                2, 0, 3, 1, 4).contiguous()
        return self._packed[key]


def _chunk(channels) -> int:
    """Input channels per chunk: the largest multiple of 4, at most 64,
    that divides every section."""
    g = 0
    for c in channels:
        g = math.gcd(g, int(c))
    for kc in range(64, 0, -4):
        if g % kc == 0:
            return kc
    raise ValueError(f"channels {list(channels)} are not multiples of 4")


def _scales(s_in: float, out_scale: float | None):
    return (float(s_in), 1.0 / float(s_in),
            0.0 if out_scale is None else 1.0 / float(out_scale))


def _check_cuda(name: str, ts, qw: QConv) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device != dev or t.dim() != 4:
            raise ValueError(f"{name}: expected 4-d CUDA tensors on one "
                             f"device, got {t.device} {tuple(t.shape)}")
    for t in (qw.w_q, qw.s_w, qw.bias):
        if t.device != dev:
            raise ValueError(f"{name}: weights on {t.device}, input on {dev}")


def _out_mode(name: str, out_scale, out_dtype) -> tuple[int, torch.dtype]:
    if out_scale is not None:
        return 0, torch.int8
    if out_dtype not in _OUT_MODES:
        raise ValueError(f"{name}: out_dtype {out_dtype} is not float32 or "
                         f"bfloat16")
    return _OUT_MODES[out_dtype], out_dtype


def _exit(y: torch.Tensor, out_scale, out_dtype) -> torch.Tensor:
    """The epilogue's float32 values as the kernels store them: int8 at
    ``out_scale``, else rounded once to ``out_dtype``."""
    return requant(y, out_scale) if out_scale is not None else y.to(out_dtype)


# ---------------------------------------------------------------------------
# K4: 3x3 (and 5x5)
# ---------------------------------------------------------------------------

def _conv_kxk_plain(x, qw: QConv, s_in, stride, act, out_scale, out_dtype):
    """x (B, H, W, C) int8 at ``s_in`` or float -> (B, Ho, Wo, O), pad k/2.
    The s32 sums are exact (float64 products of int8 values)."""
    xq = x if x.dtype == torch.int8 else quantize(x, s_in)
    C = xq.shape[-1]
    w = qw.w_q[..., :C].permute(0, 3, 1, 2).double()
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), w, stride=stride,
                   padding=qw.k // 2)
    y = epilogue(acc.permute(0, 2, 3, 1), qw.s_w, qw.bias, s_in, act)
    return _exit(y, out_scale, out_dtype).contiguous()


def k4_route(C: int, O: int, B: int, H: int, W: int, stride: int,
             dtype: torch.dtype, addr: int = 0) -> tuple:
    """K4's route for a 3x3 of ``C`` -> ``O`` channels on a (B, H, W) input
    map at ``stride``: ``(kind, BN, MI, VEC, TW)`` on the int8 tensor cores,
    kind ``"wgmma"`` for stride 1 on int8 input, ``"wgmma_s2"`` for stride 2
    on int8 input, ``"wgmma_f32"`` for stride 1 on float32 input with C a
    multiple of 4 at a 16-byte-aligned ``addr``; else ``("dp4a",)``.
    BN: the smallest of ``K4_TILES`` (stride 2: ``K4_S2_TILES``) that holds
    O (the largest above it), unless that grid is under two blocks an SM;
    then the narrower ones down to 64: the first whose grid reaches two
    blocks an SM, else 64. MI: BN's in the table. VEC: 0 for float32; for
    int8 the bytes of one staging copy, 16, 8 or 4, the largest that divides
    C and ``addr`` (x's data pointer). TW: the tile's row width over the
    output map for 128 MI positions (``k4_width``)."""
    low = int(addr) & 15
    if dtype == torch.int8 and stride in (1, 2):
        f32 = False
    elif dtype == torch.float32 and stride == 1 and C % 4 == 0 and not low:
        f32 = True
    else:
        return ("dp4a",)
    return _k4_route(int(C), int(O), int(B), int(H), int(W), int(stride),
                     f32, low)


@functools.lru_cache(maxsize=None)
def _k4_route(C, O, B, H, W, stride, f32, low, ks=3) -> tuple:
    vec = 0 if f32 else next(
        (v for v in (16, 8, 4) if low % v == 0 and C % v == 0), None)
    if vec is None:
        raise ValueError(f"conv{ks}x{ks}_q8: int8 input of {C} channels at "
                         f"an address off 4 bytes")
    table = (K4_S2_TILES if stride == 2 else K4_TILES if ks == 3
             else DENSE5_TILES)
    ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    width = functools.partial(k4_width, ho, wo, stride=stride, ks=ks)
    bn, tw = pick_tile(table, O, B, width)
    if ks == 5 and width(256)[1] * -(-O // bn) * B < SMS // 2:
        # a 5x5 grid that leaves most SMs idle is latency-bound: the
        # narrowest tile, more blocks in flight
        bn = min(table)
    kind = "wgmma_s2" if stride == 2 else "wgmma_f32" if f32 else "wgmma"
    return kind, bn, table[bn], vec, tw


def pick_tile(table: dict, O: int, B: int, width) -> tuple[int, int]:
    """(BN, TW) of a wgmma tile table {BN: MI}: BN the smallest that holds
    O (the largest above it), unless that grid is under two blocks an SM;
    then the narrower ones down to 64: the first whose grid reaches two
    blocks an SM, else 64. ``width(128 MI)`` -> (TW, tiles a map)."""
    first = next((b for b in table if O <= b), max(table))
    for bn in [b for b in sorted(table, reverse=True)
               if b == first or 64 <= b < first]:
        tw, tiles = width(128 * table[bn])
        if tiles * -(-O // bn) * B >= 2 * SMS:
            break
    return bn, tw


@functools.lru_cache(maxsize=None)
def k4_width(H: int, W: int, mb: int, stride: int = 1, ks: int = 3,
             step: int = 2) -> tuple[int, int]:
    """(TW, tiles a map) of the ``wgmma`` core over an (H, W) output map
    and ``mb`` positions a block. Stride 1: a tile is th = mb // (TW + ks -
    1) rows (at least ks - 1) of TW columns, computed over TW + ks - 1
    positions a row from a staged (th + ks - 1) x (TW + ks - 1) halo'd
    tile. Stride 2 (ks 3): th = mb // (TW + 1) rows (at least 2) over TW +
    1 positions a row, from four staged parity planes of (th + 1) x (TW +
    1), TW at most ``K4_S2_TW``. TW is a multiple of ``step`` (K4 and the
    dense 5x5 2, K13 4), at most W rounded up to one: as K10's tile, the
    one that wastes the fewest positions over the map, with a staged
    position counted as an eighth of a computed one (a computed position
    costs the epilogue of every output channel, a staged one two 16-byte
    copies a chunk); the wider on a tie."""
    halo, planes = (ks - 1, 1) if stride == 1 else (1, 4)
    rows = ks - 1 if stride == 1 else 2
    top = (mb // rows - halo) & ~1
    if stride != 1:
        top = min(top, K4_S2_TW)
    top -= top % step
    best = None
    for tw in range(min(W + (-W) % step, top), 0, -step):
        th = mb // (tw + halo)
        tiles = -(-W // tw) * -(-H // th)
        cost = tiles * (8 * mb + planes * (th + halo) * (tw + halo))
        if best is None or cost < best[2]:
            best = (tw, tiles, cost)
    return best[:2]


def dense5_route(C: int, O: int, B: int, H: int, W: int,
                 dtype: torch.dtype, addr: int = 0) -> tuple:
    """The dense 5x5's route for ``C`` -> ``O`` channels on a (B, H, W)
    input map: ``(kind, BN, MI, VEC, TW)`` on the int8 tensor cores, K4's
    stride-1 ``wgmma`` core with 25 taps, kind ``"wgmma"`` for int8 input
    and ``"wgmma_f32"`` for float32 input with C a multiple of 4 at a
    16-byte-aligned ``addr`` (quantized while staging); else ``("dp4a",)``,
    the dp4a kernel with 5x5 taps (float32 input whose C is not a multiple
    of 4 or whose address is off 16 bytes). BN from ``DENSE5_TILES`` as
    ``pick_tile`` chooses, then 24 where that grid fills under half the
    SMs (a thin grid is latency-bound); MI 2; VEC as ``k4_route``'s; TW
    ``k4_width``'s with ks 5 (at least 4 rows a tile)."""
    low = int(addr) & 15
    if dtype == torch.int8:
        f32 = False
    elif dtype == torch.float32 and C % 4 == 0 and not low:
        f32 = True
    else:
        return ("dp4a",)
    return _k4_route(int(C), int(O), int(B), int(H), int(W), 1, f32, low,
                     5)


def _conv_kxk(name, x, qw: QConv, s_in, stride, act, out_scale, out_dtype):
    _check_cuda(name, [x], qw)
    B, H, W, C = x.shape
    cp = qw.w_q.shape[-1]
    if act not in _ACTS:
        raise ValueError(f"{name}: unknown activation {act!r}")
    if x.dtype == torch.int8:
        if C != cp:
            raise ValueError(f"{name}: int8 input has {C} channels, the "
                             f"weights {cp} (a multiple of 4)")
    elif x.dtype != torch.float32 or C != qw.c_in:
        raise ValueError(f"{name}: expected int8 or float32 input with "
                         f"{qw.c_in} channels, got {x.dtype} {C}")
    mode, dt = _out_mode(name, out_scale, out_dtype)
    x = x.contiguous()
    ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    O = qw.c_out
    y = torch.empty((B, ho, wo, O), device=x.device, dtype=dt)
    s, inv_s, inv_out = _scales(s_in, out_scale)
    if name == "conv3x3_q8":
        route = k4_route(C, O, B, H, W, stride, x.dtype, x.data_ptr())
        by_route = LAUNCHES_K4_ROUTE
    else:
        route = dense5_route(C, O, B, H, W, x.dtype, x.data_ptr())
        by_route = LAUNCHES_DENSE5_ROUTE
    if route[0] != "dp4a":
        _, bn, mi, vec, tw = route
        packed = qw.packed_wgmma3() if qw.k == 3 else qw.packed_wgmma5()
        err = _lib().conv_q8_wgmma(
            D.ptr(x), D.ptr(packed), D.ptr(qw.s_w), D.ptr(qw.bias),
            D.ptr(y), B, H, W, C, O, qw.k, stride, bn, mi, vec, tw, mode, s,
            inv_s, inv_out, _ACTS[act], D.stream_handle(x))
    else:
        kc = _chunk([cp])
        err = _lib().conv3x3_q8(
            D.ptr(x), D.ptr(qw.packed(kc)), D.ptr(qw.s_w), D.ptr(qw.bias),
            D.ptr(y), B, H, W, C, cp, kc, qw.k, stride, O,
            int(x.dtype == torch.float32), mode, s, inv_s, inv_out,
            _ACTS[act], D.stream_handle(x))
    D.check_launch(name, err)
    LAUNCHES[name] += 1
    by_route[route[0]] += 1
    return y


def conv3x3_q8_plain(x: torch.Tensor, qw: QConv, s_in: float,
                     stride: int = 1, act: str | None = "silu",
                     out_scale: float | None = None,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (B, H, W, C) int8 at ``s_in`` or float -> (B, Ho, Wo, O), pad k/2
    (the weights' k: 3 here, 1 for K14's and 5 for conv5x5_q8's plain
    versions)."""
    return _conv_kxk_plain(x, qw, s_in, stride, act, out_scale, out_dtype)


def conv3x3_q8(x: torch.Tensor, qw: QConv, s_in: float, stride: int = 1,
               act: str | None = "silu", out_scale: float | None = None,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K4, on the design ``k4_route`` picks. CPU tensors take
    ``conv3x3_q8_plain``."""
    if x.device.type == "cpu":
        return conv3x3_q8_plain(x, qw, s_in, stride, act, out_scale,
                                out_dtype)
    if qw.k != 3 or stride not in (1, 2):
        raise ValueError(f"conv3x3_q8: k={qw.k} stride={stride}")
    return _conv_kxk("conv3x3_q8", x, qw, s_in, stride, act, out_scale,
                     out_dtype)


def conv5x5_q8_plain(x: torch.Tensor, qw: QConv, s_in: float,
                     act: str | None = "silu",
                     out_scale: float | None = None,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (B, H, W, C) int8 at ``s_in`` or float -> (B, H, W, O): a dense
    5x5, stride 1, pad 2."""
    return _conv_kxk_plain(x, qw, s_in, 1, act, out_scale, out_dtype)


def conv5x5_q8(x: torch.Tensor, qw: QConv, s_in: float,
               act: str | None = "silu", out_scale: float | None = None,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The dense ``conv5x5_flat_q8`` on the route ``dense5_route`` picks:
    K4's stride-1 ``wgmma`` core with 25 taps (int8 input, float32 input
    with C % 4 == 0 at a 16-byte-aligned address), else K4's dp4a kernel
    with 5x5 taps. CPU tensors take ``conv5x5_q8_plain``."""
    if x.device.type == "cpu":
        return conv5x5_q8_plain(x, qw, s_in, act, out_scale, out_dtype)
    if qw.k != 5:
        raise ValueError(f"conv5x5_q8: the weights are {qw.k}x{qw.k}")
    return _conv_kxk("conv5x5_q8", x, qw, s_in, 1, act, out_scale,
                     out_dtype)


def block_diagonal(qd) -> QConv:
    """The dense 5x5 ``QConv`` of a depthwise one (``neck_flat.QDepthwise``)
    as the JAX dw5_dense route builds it (``neck_flat.py:219-231``): output
    channel o reads input channel o alone. Its per-channel weight scale is
    the depthwise one (the maximum over 25 taps and zeros), so the int8
    weights are the depthwise ones on the diagonal."""
    C = qd.c
    qc = QConv.__new__(QConv)
    qc.w_q = torch.zeros((C, 5, 5, C), dtype=torch.int8,
                         device=qd.w_q.device)
    idx = torch.arange(C, device=qd.w_q.device)
    qc.w_q[idx, :, :, idx] = qd.w_q.reshape(C, 5, 5)
    qc.s_w, qc.bias = qd.s_w, qd.bias
    qc.c_in, qc.k, qc._packed = C, 5, {}
    return qc


# ---------------------------------------------------------------------------
# K5: 1x1 over sections, optional 2x2/s2 max pool
# ---------------------------------------------------------------------------

def _pool2(y: torch.Tensor) -> torch.Tensor:
    B, H, W, C = y.shape
    return y.reshape(B, H // 2, 2, W // 2, 2, C).amax((2, 4))


def conv1x1_q8_sums(xs, qw: QConv, s_in: float) -> torch.Tensor:
    """K5's s32 sums, exact in float64: concat(xs, -1), int8 or quantized
    at ``s_in``, times ``qw.w_q`` -> (..., O)."""
    xs = list(xs) if isinstance(xs, (list, tuple)) else [xs]
    x = torch.cat(xs, -1) if len(xs) > 1 else xs[0]
    if x.dtype != torch.int8:
        x = quantize(x, s_in)
    w = qw.w_q.reshape(qw.c_out, -1)[:, :x.shape[-1]]
    return torch.matmul(x.double(), w.double().t())


def conv1x1_q8_plain(xs, qw: QConv, s_in: float, act: str | None = "silu",
                     out_scale: float | None = None, pool: bool = False,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """conv1x1(concat(xs, -1)) for int8 sections (B, H, W, C_s) at
    ``s_in`` (a section's own scale folded into ``qw``) or float sections
    quantized at ``s_in``, then the exit (int8 at ``out_scale``, else
    ``out_dtype``), then (``pool``) the 2x2/s2 max pool."""
    acc = conv1x1_q8_sums(xs, qw, s_in)
    y = _exit(epilogue(acc, qw.s_w, qw.bias, s_in, act), out_scale,
              out_dtype)
    return (_pool2(y) if pool else y).contiguous()


def k5_route(cs, O: int, rows: int, f32_in: bool,
             addrs=None) -> tuple[int, int, int]:
    """K5's (BN, MI, VEC) for sections of ``cs`` channels, ``O`` output
    channels and ``rows`` staged rows (B * H * W, the pool's four a pooled
    pixel included). BN: the smallest of ``K5_TILES`` that holds O (256
    above it), unless that grid is under two blocks an SM; then the
    narrower ones down to 64: the first whose grid reaches two blocks an
    SM, else 64. MI: BN's in ``K5_TILES``. VEC: 0 for float32 sections;
    for int8 the bytes of one copy, 16, 8 or 4, the largest that divides
    every section's channels and (``addrs``, the data pointers) address."""
    low = 0                    # the addresses' low bits, together
    for a in addrs or ():
        low |= a & 15
    return _k5_route(tuple(int(c) for c in cs), int(O), int(rows),
                     bool(f32_in), low)


@functools.lru_cache(maxsize=None)
def _k5_route(cs, O, rows, f32_in, low) -> tuple[int, int, int]:
    first = next((b for b in K5_TILES if O <= b), 256)
    for bn in [b for b in sorted(K5_TILES, reverse=True)
               if b == first or 64 <= b < first]:
        if -(-rows // (128 * K5_TILES[bn])) * -(-O // bn) >= 2 * SMS:
            break
    mi = K5_TILES[bn]
    if f32_in:
        return bn, mi, 0
    vec = next((v for v in (16, 8, 4)
                if low % v == 0 and all(c % v == 0 for c in cs)), None)
    if vec is None:
        raise ValueError(f"conv1x1_q8: int8 sections of {list(cs)} channels "
                         f"are not all 4-byte aligned")
    return bn, mi, vec


def conv1x1_q8(xs, qw: QConv, s_in: float, act: str | None = "silu",
               out_scale: float | None = None, pool: bool = False,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K5. CPU tensors take ``conv1x1_q8_plain``. The sections are all int8
    or all float32; their channel counts are multiples of 4; float32
    sections are 16-byte aligned."""
    xs = list(xs) if isinstance(xs, (list, tuple)) else [xs]
    if xs[0].device.type == "cpu":
        return conv1x1_q8_plain(xs, qw, s_in, act, out_scale, pool,
                                out_dtype)
    _check_cuda("conv1x1_q8", xs, qw)
    B, H, W, _ = xs[0].shape
    cs = [t.shape[-1] for t in xs]
    dt_in = xs[0].dtype
    if not 1 <= len(xs) <= 3 or qw.k != 1 or act not in _ACTS:
        raise ValueError(f"conv1x1_q8: {len(xs)} sections, k={qw.k}, "
                         f"act={act}")
    if dt_in not in (torch.int8, torch.float32) \
            or any(t.dtype != dt_in or t.shape[:3] != (B, H, W) for t in xs) \
            or any(c % 4 for c in cs) or sum(cs) != qw.w_q.shape[-1]:
        raise ValueError(f"conv1x1_q8: expected int8 or float32 sections "
                         f"(B, H, W, C) of one dtype with C multiples of 4 "
                         f"summing to {qw.w_q.shape[-1]}, got "
                         f"{[(t.dtype, tuple(t.shape)) for t in xs]}")
    if pool and (H % 2 or W % 2):
        raise ValueError(f"conv1x1_q8: pool needs even H, W, got {H}x{W}")
    mode, dt = _out_mode("conv1x1_q8", out_scale, out_dtype)
    xs = [t.contiguous() for t in xs]
    f32_in = dt_in == torch.float32
    if f32_in and any(t.data_ptr() % 16 for t in xs):
        raise ValueError("conv1x1_q8: float32 sections must be 16-byte "
                         "aligned")
    O = qw.c_out
    bn, mi, vec = k5_route(cs, O, B * H * W, f32_in,
                           [t.data_ptr() for t in xs])
    shape = (B, H // 2, W // 2, O) if pool else (B, H, W, O)
    y = torch.empty(shape, device=xs[0].device, dtype=dt)
    s, inv_s, inv_out = _scales(s_in, out_scale)
    ptrs = [D.ptr(t) for t in xs] + [None] * (3 - len(xs))
    cs3 = cs + [0] * (3 - len(cs))
    err = _lib().conv1x1_q8(
        *ptrs, *cs3, len(xs), D.ptr(qw.packed_wgmma(cs)), D.ptr(qw.s_w),
        D.ptr(qw.bias), D.ptr(y), B, H, W, bn, mi, vec, O, int(pool), mode,
        s, inv_s, inv_out, _ACTS[act], D.stream_handle(xs[0]))
    D.check_launch("conv1x1_q8", err)
    LAUNCHES["conv1x1_q8"] += 1
    return y
