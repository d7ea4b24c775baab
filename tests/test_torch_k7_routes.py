"""Host code of K7 ``dwconv5x5_q8`` (``csrc/neck_flat.cu``), on the CPU:
its weight packing, a numpy model of the kernel's walk (the staged tile,
taps 0-3 of a kernel row as one ``__dp4a`` of packed bytes plus tap 4,
five rows of sums in flight), the tile choice it shares with K12
(``dw5_tile``) at the flagship's served K7 signatures, and the wrapper on
CPU tensors (its plain version, no launch).

Every comparison is exact: the packing is a transpose, and the sums are
integers.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rep_yolo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from rep_yolo_tpu_torch.ops.kernels import neck_flat as KNF

# (B, H, W, C), act, f32 out: the nine signatures of K7's 18 calls in a
# served int8 forward at 640 px, batch 4 (chip_smoke.py times_q8), and a
# ragged C (off 32 and off 16: byte staging)
K7_SIGNATURES = [((4, 20, 20, 64), "silu", False),
                 ((4, 40, 40, 128), "silu", False),
                 ((4, 40, 40, 64), "silu", False),
                 ((4, 40, 40, 64), None, True),
                 ((4, 80, 80, 64), "silu", False),
                 ((4, 80, 80, 32), "silu", False),
                 ((4, 80, 80, 32), None, True),
                 ((4, 20, 20, 128), "silu", False),
                 ((4, 20, 20, 128), None, True),
                 ((2, 9, 41, 40), None, False)]


def _qd(rng, c):
    wt = torch.from_numpy(rng.normal(0, 0.1, (c, 1, 5, 5)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.5, (c,)).astype(np.float32))
    return KNF.QDepthwise(wt, b, torch.from_numpy(
        rng.uniform(0.01, 0.03, c).astype(np.float32)))


@pytest.mark.parametrize("c", [4, 8, 40, 64, 128])
def test_tap_major_weights_unpack_to_w_q(c):
    qd = _qd(np.random.default_rng(c), c)
    assert qd.w_t.dtype == torch.int8 and qd.w_t.is_contiguous()
    assert tuple(qd.w_t.shape) == (25, c)
    assert torch.equal(qd.w_t.t(), qd.w_q)
    assert not hasattr(qd, "words")


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays."""
    v = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint32)
    for i in range(4):
        s = (sel >> (4 * i)) & 7
        out |= (((v >> np.uint64(8 * s)) & np.uint64(0xff)).astype(np.uint32)
                << np.uint32(8 * i))
    return out


def _funnelshift_r(lo, hi, sh):
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return (v >> np.uint64(sh)).astype(np.uint32)


def _dp4a(a, b, c):
    """CUDA's __dp4a: the four signed byte products of a and b, plus c."""
    ab = a.astype(np.uint32).view(np.int8).reshape(a.shape + (4,))
    bb = b.astype(np.uint32).view(np.int8).reshape(b.shape + (4,))
    return c + (ab.astype(np.int64) * bb.astype(np.int64)).sum(-1)


def walk_model(x, w_t, ty):
    """The kernel's s32 sums (B, H, W, C): per block (ty rows x 20 columns
    x 32 channels) the staged (ty + 4) x 24 tile, per warp 5 columns, a
    lane a channel; each staged row r packs the bytes of input columns
    q..q+3 (a byte permute, then funnel shifts), takes each kernel row u's
    sum as __dp4a(packed, w4[u], w1[u] * x[q + 4]) into slot (r - u) % 5,
    and output row r - 4 leaves from slot (r + 1) % 5."""
    B, H, W, C = x.shape
    TX, CB = KNF.DW5_TX, KNF.DW5_C
    out = np.full((B, H, W, C), np.iinfo(np.int64).min, np.int64)
    cg = -(-C // CB)
    wp = np.zeros((25, cg * CB), np.int64)
    wp[:, :C] = w_t.numpy()
    wb = wp.astype(np.int8).view(np.uint8).astype(np.uint32)
    w4 = np.stack([wb[u * 5] | wb[u * 5 + 1] << 8 | wb[u * 5 + 2] << 16
                   | wb[u * 5 + 3] << 24 for u in range(5)])  # (5, lanes)
    w1 = wp[4::5]
    xp = np.zeros((B, H + ty + 4, -(-W // TX) * TX + 4, cg * CB), np.int8)
    xp[:, 2:H + 2, 2:W + 2, :C] = x.numpy()
    for b in range(B):
        for y0 in range(0, H, ty):
            for x0 in range(0, W, TX):
                tile = xp[b, y0:y0 + ty + 4, x0:x0 + TX + 4]  # staged
                for lx0 in range(0, TX, 5):
                    acc = np.zeros((5, 5, cg * CB), np.int64)
                    for r in range(ty + 4):
                        xv = tile[r, lx0:lx0 + 9].astype(np.int64)
                        xu = xv.astype(np.uint32)
                        pk = [_byte_perm(_byte_perm(xu[0], xu[1], 0x0040),
                                         _byte_perm(xu[2], xu[3], 0x0040),
                                         0x5410)]
                        for q in range(1, 5):
                            pk.append(_funnelshift_r(pk[-1], xu[q + 3], 8))
                        for u in range(5):
                            if not 0 <= r - u < ty:
                                continue
                            sl = (r - u) % 5
                            for xo in range(5):
                                row = _dp4a(pk[xo], w4[u], w1[u] * xv[xo + 4])
                                acc[sl, xo] = row if u == 0 else \
                                    acc[sl, xo] + row
                        oy = y0 + r - 4
                        if r < 4 or r - 4 >= ty or oy >= H:
                            continue
                        for xo in range(5):
                            ox = x0 + lx0 + xo
                            if ox < W:
                                out[b, oy, ox] = acc[(r + 1) % 5, xo, :C]
    return out


@pytest.mark.parametrize("b,h,w,c,ty", [(1, 9, 23, 32, 4), (2, 13, 21, 40, 8),
                                        (1, 20, 20, 64, 16), (1, 5, 3, 8, 4),
                                        (1, 17, 41, 36, 16), (2, 7, 22, 32, 2),
                                        (1, 6, 9, 64, 1)])
def test_walk_model_equals_exact_sums(b, h, w, c, ty):
    rng = np.random.default_rng(b * h + w + c)
    qd = _qd(rng, c)
    x = torch.from_numpy(rng.integers(-128, 128, (b, h, w, c)).astype(
        np.int8))
    ref = F.conv2d(x.permute(0, 3, 1, 2).double(),
                   qd.w_q.reshape(c, 1, 5, 5).double(), padding=2, groups=c)
    got = walk_model(x, qd.w_t, ty)
    np.testing.assert_array_equal(got, ref.permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("shape,act,f32_out", K7_SIGNATURES)
def test_tile_choice_at_the_flagship_signatures(shape, act, f32_out):
    """The tallest of 16, 8, 4, 2 and 1 rows that still gives four blocks
    an SM, else 1; the staged tile fits a block's shared memory."""
    B, H, W, C = shape
    t = KNF.dw5_tile(B, H, W, C)
    assert t["ty"] in KNF.DW5_TY
    assert t["grid"] == (-(-W // 20) * -(-H // t["ty"]), -(-C // 32), B)
    assert t["blocks"] == int(np.prod(t["grid"]))
    taller = [ty for ty in KNF.DW5_TY if ty > t["ty"]]
    least = KNF.DW5_BLOCKS_PER_SM * KNF.SMS
    assert KNF.DW5_BLOCKS_PER_SM == 4
    assert all(-(-W // 20) * -(-H // ty) * -(-C // 32) * B < least
               for ty in taller)
    assert t["blocks"] >= least or t["ty"] == KNF.DW5_TY[-1]
    assert t["smem"] == (16 + 4) * (20 + 4) * 32 <= 232448


def test_tile_choice_examples():
    # 80-px maps of 64 channels at batch 4: 4 x 20 x 2 x 4 = 640 blocks
    assert KNF.dw5_tile(4, 80, 80, 64)["ty"] == 4
    assert KNF.dw5_tile(4, 80, 80, 32)["ty"] == 2
    assert KNF.dw5_tile(8, 80, 80, 64)["ty"] == 8
    assert KNF.dw5_tile(4, 40, 40, 128)["ty"] == 2
    assert KNF.dw5_tile(4, 40, 40, 64)["ty"] == 1
    t = KNF.dw5_tile(4, 20, 20, 64)                      # thin at any ty
    assert (t["ty"], t["blocks"]) == (1, 160)


@pytest.mark.parametrize("out_scale", [None, 0.03])
@pytest.mark.parametrize("act", ["silu", None])
def test_k7_wrapper_takes_plain_on_cpu_and_counts_nothing(act, out_scale):
    rng = np.random.default_rng(9)
    qd = _qd(rng, 40)
    x = torch.from_numpy(rng.integers(-127, 128, (2, 7, 9, 40)).astype(
        np.int8))
    reset_launch_counts()
    assert torch.equal(KNF.dwconv5x5_q8(x, qd, 0.5, act, out_scale),
                       KNF.dwconv5x5_q8_plain(x, qd, 0.5, act, out_scale))
    assert sum(launch_counts().values()) == 0
