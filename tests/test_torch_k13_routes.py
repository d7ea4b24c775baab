"""Host code of K13 ``conv3x3_cmajor_q8`` on the int8 ``wgmma`` core
(``csrc/conv_wgmma.cuh`` with NCHW input), on the CPU: its operand
(``QConv.packed_wgmma3``, K4's) for ``CMQConv`` weights, ``k13_route`` at
every shape the kernel is called at (``kernel_bench``'s 3x3 shapes and
``chip_smoke.py``'s odd ones), what it refuses, the shared memory of every
tile it can pick, and a numpy model of the kernel's addressing against the
plain version's s32 sums: the NCHW plane rows loaded as aligned 16-byte
vectors (narrower loads, zeros outside the map), the ``__byte_perm``
transpose into (pixel, 4 channels) words stored a position at a time, the
nine taps as position offsets, and the epilogue's compacted [channel]
[pixel] tile stored 4 pixels a thread.

Every comparison is exact: the packing is a permutation with zeros, and the
sums are integers.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rep_yolo_tpu_torch.ops.kernels import conv_flat as KC
from rep_yolo_tpu_torch.ops.kernels import conv_kernel as KCM
from rep_yolo_tpu_torch.ops.quant import epilogue, quantize
from rep_yolo_tpu_torch.tools.kernel_bench import SHAPES

SMEM_MAX = 232448           # bytes of shared memory a block may use
MB = 256                    # positions a block (MI = 2)
# chip_smoke.py's kernels_q8_rest: kernel_bench's shapes at batch 2 and
# these 3x3s on 16 x 64 maps
ODD_SHAPES = [(48, 48, 16, 64), (24, 48, 16, 64), (16, 32, 16, 64)]


def _cmq(rng, c_in, c_out):
    w = rng.normal(0, 0.1, (c_out, c_in, 3, 3)).astype(np.float32)
    b = rng.normal(0, 0.5, (c_out,)).astype(np.float32)
    return KCM.CMQConv(torch.from_numpy(w), torch.from_numpy(b))


def _unpack(packed):
    """[chunk][tap][O8/8][2][8][16] -> (O8, 9, chunks * 32)."""
    chunks, taps, og = packed.shape[:3]
    return packed.permute(2, 4, 1, 0, 3, 5).reshape(og * 8, taps,
                                                    chunks * 32)


@pytest.mark.parametrize("C", [3, 20, 36, 40, 70])
@pytest.mark.parametrize("O", [8, 20, 50, 130])
def test_cmq_wgmma_operand_unpacks_to_w_q(C, O):
    """K13's weights: ``packed_wgmma3`` of the ``CMQConv`` (C padded to 4 in
    ``w_q``, to whole 32-channel chunks here; O to 8), zeros in every pad;
    ``packed_cm`` (K14's) is another copy beside it."""
    qw = _cmq(np.random.default_rng(C * O), C, O)
    packed = qw.packed_wgmma3()
    assert packed.dtype == torch.int8
    assert tuple(packed.shape) == (-(-C // 32), 9, -(-O // 8), 2, 8, 16)
    k = _unpack(packed)
    assert torch.equal(k[:O, :, :C], qw.w_q.reshape(O, 9, -1)[..., :C])
    assert int(k[O:].abs().sum()) == 0 and int(k[:, :, C:].abs().sum()) == 0
    assert qw.packed_wgmma3() is packed and qw.packed_cm() is not packed


def _pitch(sw):
    """``k4_pitch`` of csrc/conv_wgmma.cuh at stride 1, ks 3."""
    p = MB + 2 * (sw + 1)
    return p + (4 - p) % 8


def _cm_pitch(n):
    """``cm_pitch`` of csrc/conv_wgmma.cuh: the sums tile's channel pitch."""
    p = -(-n // 4) * 4
    return p + (4 - p) % 16


def _smem(bn, tw, C):
    """Shared memory of K13's launch, as ``launch_wgmma`` computes it for NCHW
    input: four stages of the halo'd tile's two planes and 9 BN 32 bytes of
    weights, or the epilogue's [BN][cm_pitch(th tw)] s32 tile."""
    sw = tw + 2
    th = MB // sw
    stage = 2 * _pitch(sw) * 16 + 9 * bn * 32
    tile = bn * _cm_pitch(th * tw) * 4
    return -(-8 * bn // 128) * 128 + max(min(4, -(-C // 32)) * stage, tile)


def _calls():
    """(C, O, B, H, W) of every K13 call: kernel_bench's 3x3 shapes at the
    benches' batch 8 and kernels_q8_rest's batch 2, and the odd shapes."""
    out = []
    for k, C, O, H in SHAPES:
        if k == 3:
            out += [(C, O, 8, H, H), (C, O, 2, H, H)]
    out += [(C, O, 2, H, W) for C, O, H, W in ODD_SHAPES]
    return out


def test_k13_route_covers_every_call():
    calls = _calls()
    assert len(calls) == 2 * 8 + 3
    seen = set()
    for C, O, B, H, W in calls:
        for dtype in (torch.int8, torch.float32, torch.bfloat16):
            kind, bn, mi, tw = KCM.k13_route(C, O, B, H, W, dtype)
            assert kind == "wgmma" and mi == KC.K4_TILES[bn] == 2
            # the smallest tile that holds O, else 128: never narrower
            assert bn == next((b for b in KC.K4_TILES if O <= b), 128)
            assert tw == KC.k4_width(H, W, MB, 1, 3, 4)[0]
            th = MB // (tw + 2)
            assert tw % 4 == 0 and th >= 2 and tw <= W + 3
            assert _smem(bn, tw, C) <= SMEM_MAX
            seen.add(bn)
    # kernel_bench's heaviest shape: 512 -> 1024 at 20 px, batch 8, stages
    # its input 8 times, once a block of 128 output channels
    assert KCM.k13_route(512, 1024, 8, 20, 20, torch.bfloat16) == (
        "wgmma", 128, 2, 20)
    assert seen == {24, 48, 128}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16, torch.int32,
                                   torch.uint8])
def test_k13_route_refuses_other_dtypes(dtype):
    with pytest.raises(ValueError):
        KCM.k13_route(48, 48, 2, 16, 16, dtype)


@pytest.mark.parametrize("shape", [(0, 8, 1, 4, 4), (8, 0, 1, 4, 4),
                                   (8, 8, 0, 4, 4), (8, 8, 1, 0, 4),
                                   (8, 8, 1, 4, 0)])
def test_k13_route_refuses_empty_shapes(shape):
    with pytest.raises(ValueError):
        KCM.k13_route(*shape, torch.int8)


def test_k13_every_tile_fits_shared_memory():
    """Every BN of K4_TILES at every row width k4_width can give K13 (a
    multiple of 4, at least two rows), every chunk count: within a block's
    shared memory, the epilogue's [BN][pixel] s32 tile included."""
    top = (MB // 2 - 2) & ~3
    for bn in KC.K4_TILES:
        for tw in range(4, top + 1, 4):
            assert MB // (tw + 2) >= 2
            for C in (4, 32, 64, 96, 128, 512):
                assert _smem(bn, tw, C) <= SMEM_MAX, (bn, tw, C)


@pytest.mark.parametrize("H,W", [(320, 320), (160, 160), (80, 80), (40, 40),
                                 (20, 20), (16, 64), (13, 21), (5, 7), (3, 1),
                                 (1, 130)])
def test_k13_width_tiles_cover_the_map(H, W):
    tw, tiles = KC.k4_width(H, W, MB, 1, 3, 4)
    th = MB // (tw + 2)
    assert tw % 4 == 0 and th >= 2 and th * (tw + 2) <= MB
    assert tiles == -(-W // tw) * -(-H // th)
    assert tw <= W + 3


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays."""
    v = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint32)
    for i in range(4):
        s = (sel >> (4 * i)) & 7
        out |= (((v >> np.uint64(8 * s)) & np.uint64(0xff)).astype(np.uint32)
                << np.uint32(8 * i))
    return out


def _transpose4(w):
    """conv_wgmma.cuh transpose4: w[c] = pixels 0..3 of channel c -> p[j] =
    channels 0..3 of pixel j."""
    t0 = _byte_perm(w[0], w[1], 0x5140)
    t1 = _byte_perm(w[0], w[1], 0x7362)
    t2 = _byte_perm(w[2], w[3], 0x5140)
    t3 = _byte_perm(w[2], w[3], 0x7362)
    return [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
            _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]


def _gin(W, es, addr):
    """The C entry's staging load: 16 bytes, or the largest of 8, 4, 2, 1
    (at least the element size) dividing W * size and x's address."""
    g = 16
    while g > es and ((W * es) % g or addr % g):
        g //= 2
    return g


def _load_vec(plane_row, col0, W, vp, gin, es):
    """load_vec: the vp pixels of a plane row from column col0 on (bytes);
    a load of gin bytes wholly outside [0, W) reads nothing (zeros)."""
    out = np.zeros(vp, dtype=np.uint8)
    per = gin // es                      # pixels a load
    for p in range(vp // per):
        c = col0 + p * per
        assert (c >= 0 and c + per <= W) or c + per <= 0 or c >= W
        if 0 <= c < W:
            out[p * per:(p + 1) * per] = plane_row[c:c + per]
    return out


def _k13_model(xq, qw, bn, tw, W_addr_es):
    """K13 modelled in numpy on the quantized map xq (B, C, H, W) int8: per
    tile and 32-channel chunk, the staged stage (two planes of pl 16-byte
    rows, garbage where nothing is staged) filled item by item as the
    kernel does (channel quad q, tile row rr, the row's v-th aligned vector:
    4 channel vectors, transpose4 a word group, a word a position); the nine
    taps through the packed weights; then wg_sums_cm's compacted tile and
    cm_store's 4-pixel groups. -> (B, O, H, W) int64 sums."""
    es, addr = W_addr_es
    B, C, H, W = xq.shape
    O = qw.c_out
    vp = 16 // es
    gin = _gin(W, es, addr)
    sw = tw + 2
    th = MB // sw
    pl = _pitch(sw)
    wk = _unpack(qw.packed_wgmma3()).numpy().astype(np.int64)
    nchunks = wk.shape[-1] // 32
    xb = xq.numpy().view(np.uint8)
    rng = np.random.default_rng(0)
    out = np.full((B, O, H, W), -(1 << 40), dtype=np.int64)
    tiles_x, pm = -(-W // tw), _cm_pitch(th * tw)
    for b in range(B):
        for y0 in range(0, H, th):
            for x0 in range(0, W, tw):
                acc = np.zeros((MB, wk.shape[0]), dtype=np.int64)
                a0 = (x0 - 1) & -vp
                nv = (((x0 + tw) & -vp) - a0) // vp + 1
                for ch in range(nchunks):
                    stage = rng.integers(0, 256, (2, pl, 16), dtype=np.uint8)
                    c0 = 32 * ch
                    for e in range(8 * (th + 2) * nv):
                        q, t = e & 7, e >> 3
                        v, rr = divmod(t, th + 2)
                        if c0 + 4 * q >= C:
                            continue
                        iy = y0 - 1 + rr
                        words = []
                        for k in range(4):
                            c = c0 + 4 * q + k
                            vec = np.zeros(vp, dtype=np.uint8)
                            if 0 <= iy < H and c < C:
                                vec = _load_vec(xb[b, c, iy], a0 + v * vp, W,
                                                vp, gin, es)
                            words.append(vec.view("<u4"))
                        cc0 = a0 + v * vp - (x0 - 1)
                        for wi in range(vp // 4):
                            p = _transpose4([np.array([wd[wi]], np.uint32)
                                             for wd in words])
                            for j in range(4):
                                cc = cc0 + 4 * wi + j
                                if 0 <= cc < sw:
                                    stage[q >> 2, rr * sw + cc,
                                          4 * (q & 3):4 * (q & 3) + 4] = \
                                        p[j].view(np.uint8)
                    a = stage.view(np.int8).astype(np.int64)  # (2, pl, 16)
                    a = np.concatenate([a[0], a[1]], axis=1)   # (pl, 32)
                    for tap in range(9):
                        u, v_ = divmod(tap, 3)
                        sh = u * sw + v_
                        acc += a[sh:sh + MB] @ wk[:, tap,
                                                  32 * ch:32 * ch + 32].T
                # wg_sums_cm: kept positions into [channel][r tw + c]
                sums = np.full((O, pm), -(1 << 50), dtype=np.int64)
                for m in range(MB):
                    r, cx = divmod(m, sw)
                    if r < th and cx < tw:
                        sums[:, r * tw + cx] = acc[m, :O]
                # cm_store: groups of 4 positions of one channel
                nr, nx = min(th, H - y0), min(tw, W - x0)
                ng = -(-nr * tw // 4)
                vec4 = W % 4 == 0 and tw % 4 == 0
                for c in range(O):
                    for g in range(ng):
                        k = 4 * g
                        r, cx = divmod(k, tw)
                        if vec4 and cx + 4 <= nx:
                            out[b, c, y0 + r, x0 + cx:x0 + cx + 4] = \
                                sums[c, k:k + 4]
                            continue
                        for j in range(4):
                            if r < nr and cx < nx:
                                out[b, c, y0 + r, x0 + cx] = sums[c, k + j]
                            cx += 1
                            if cx == tw:
                                cx, r = 0, r + 1
    assert tiles_x * tw >= W
    return out


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("B,C,H,W,O,tile,addr", [
    (2, 40, 7, 21, 20, None, 0),      # C off 32, O off 8, W off the tile
    (1, 24, 5, 64, 48, None, 0),      # kernel_q8_rest's 24 -> 48, cut down
    (1, 36, 6, 26, 50, (48, 8), 0),   # a partial quad, several tiles across
    (1, 20, 5, 7, 13, None, 0),       # H W size off 16: narrower loads
    (1, 8, 3, 10, 8, (24, 4), 2),     # x 2 bytes into its storage
    (1, 16, 9, 30, 24, (64, 12), 0),  # W off 4: stores a value at a time
])
def test_k13_addressing_equals_plain_sums(dtype, B, C, H, W, O, tile, addr):
    rng = np.random.default_rng(C + O + H + W)
    qw = _cmq(rng, C, O)
    s_in = 0.01
    if dtype == torch.int8:
        x = xq = torch.from_numpy(rng.integers(-127, 128, (B, C, H, W))
                                  .astype(np.int8))
    else:
        x = torch.from_numpy(rng.uniform(-1.2, 1.2, (B, C, H, W)).astype(
            np.float32)).to(dtype)
        xq = quantize(x.float(), s_in)
    _, bn, mi, tw = KCM.k13_route(C, O, B, H, W, dtype)
    if tile is not None:
        bn, tw = tile
    es = x.element_size()
    sums = _k13_model(xq, qw, bn, tw, (es, addr * es))
    ref = F.conv2d(xq.double(), qw.w_q[..., :C].permute(0, 3, 1, 2).double(),
                   padding=1)
    assert np.array_equal(sums, ref.numpy().astype(np.int64))
    # and the plain version is those sums through the epilogue
    y = KCM.conv3x3_cmajor_q8_plain(x, qw, s_in, None)
    acc = torch.from_numpy(sums).permute(0, 2, 3, 1).double()
    want = epilogue(acc, qw.s_w, qw.bias, s_in, None).to(torch.bfloat16)
    assert torch.equal(y, want.permute(0, 3, 1, 2))


def test_k13_staging_load_granule():
    """The staging load the C entry picks: 16 bytes where every plane row
    is 16-byte aligned, else narrower, never under the element size."""
    assert _gin(320, 2, 0) == 16 and _gin(20, 1, 0) == 4
    assert _gin(20, 2, 0) == 8 and _gin(7, 4, 0) == 4
    assert _gin(13, 1, 0) == 1 and _gin(64, 1, 2) == 2
    assert _gin(64, 2, 2) == 2 and _gin(64, 4, 4) == 4


def test_k13_wrapper_takes_plain_on_cpu_and_counts_nothing():
    from rep_yolo_tpu_torch.ops.kernels import (launch_counts,
                                                reset_launch_counts)
    rng = np.random.default_rng(3)
    qw = _cmq(rng, 20, 12)
    reset_launch_counts()
    for dtype in (torch.int8, torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.uniform(-1, 1, (2, 20, 5, 7)).astype(
            np.float32)).to(dtype) if dtype != torch.int8 else \
            torch.from_numpy(rng.integers(-127, 128, (2, 20, 5, 7)).astype(
                np.int8))
        for o in (None, 0.05):
            assert torch.equal(KCM.conv3x3_cmajor_q8(x, qw, 0.01, "silu", o),
                               KCM.conv3x3_cmajor_q8_plain(x, qw, 0.01,
                                                           "silu", o))
    assert launch_counts()["conv3x3_cmajor_q8"] == 0
