"""Host code of the dense 5x5 ``conv5x5_q8`` on K4's stride-1 int8
``wgmma`` core with 25 taps (``csrc/conv_wgmma.cuh``), on the CPU: its
packed weights (``QConv.packed_wgmma5``), ``dense5_route`` at the 18
block-diagonal calls of a served int8 forward (the nine signatures of K7's
calls) and at the float32 cases, what it refuses, the shared memory of every
tile it can pick (three stages: four would not fit), the row widths, and a
torch model of the kernel's addressing (the (th + 4) x (tw + 4) halo'd tile,
the 25 taps as position offsets) against the plain version's s32 sums, and
the wrapper on CPU tensors.

Exact comparisons throughout: the packing is a permutation with zeros, and
the s32 sums are integers.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rep_yolo_tpu_torch.ops.kernels import conv_flat as KC
from rep_yolo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from rep_yolo_tpu_torch.ops.quant import epilogue, quantize

SMEM_MAX = 232448           # bytes of shared memory a block may use
STAGES = 3                  # the 5x5's ring (ring_stages(5))
# (B, H, W, C): the nine signatures of the 18 depthwise calls of a served
# int8 forward at 640 px, batch 4 (tests/test_torch_k7_routes.py), which the
# dense 5x5 computes with block-diagonal weights (C -> C)
DW5_SIGNATURES = [(4, 20, 20, 64), (4, 40, 40, 128), (4, 40, 40, 64),
                  (4, 80, 80, 64), (4, 80, 80, 32), (4, 20, 20, 128)]


def _qconv(rng, c_in, c_out, k=5):
    w = rng.normal(0, 0.1, (c_out, c_in, k, k)).astype(np.float32)
    b = rng.normal(0, 0.5, (c_out,)).astype(np.float32)
    return KC.QConv(torch.from_numpy(w), torch.from_numpy(b))


def _unpack5(packed):
    """[chunk][tap][O8/8][2][8][16] -> (O8, 25, chunks * 32)."""
    chunks, taps, og = packed.shape[:3]
    assert taps == 25
    return packed.permute(2, 4, 1, 0, 3, 5).reshape(og * 8, 25, chunks * 32)


@pytest.mark.parametrize("C", [4, 20, 32, 40, 128])
@pytest.mark.parametrize("O", [8, 20, 64, 70])
def test_packed_wgmma5_unpacks_to_w_q(O, C):
    qw = _qconv(np.random.default_rng(O + C), C, O)
    packed = qw.packed_wgmma5()
    assert packed.dtype == torch.int8
    assert tuple(packed.shape) == (-(-C // 32), 25, -(-O // 8), 2, 8, 16)
    k = _unpack5(packed)
    assert torch.equal(k[:O, :, :C], qw.w_q.reshape(O, 25, -1)[..., :C])
    assert int(k[O:].abs().sum()) == 0 and int(k[:, :, C:].abs().sum()) == 0
    assert qw.packed_wgmma5() is packed


def test_packed_wgmma5_of_block_diagonal_weights():
    """The block-diagonal QConv of a depthwise one (the JAX dw5_dense
    route's weights): only output channel o's input channel o is non-zero
    in every tap."""
    from rep_yolo_tpu_torch.ops.kernels import neck_flat as KNF
    rng = np.random.default_rng(5)
    qd = KNF.QDepthwise(
        torch.from_numpy(rng.normal(0, 0.1, (40, 1, 5, 5)).astype(
            np.float32)),
        torch.from_numpy(rng.normal(0, 0.1, (40,)).astype(np.float32)))
    k = _unpack5(KC.block_diagonal(qd).packed_wgmma5())
    eye = torch.eye(40, 64, dtype=torch.bool)
    assert int(k[:40].permute(0, 2, 1)[~eye].abs().sum()) == 0
    assert torch.equal(k[:40].permute(0, 2, 1)[eye].reshape(40, 25),
                       qd.w_q.reshape(40, 25))


def test_packings_refuse_other_taps():
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError):
        _qconv(rng, 16, 16, 3).packed_wgmma5()
    with pytest.raises(ValueError):
        _qconv(rng, 16, 16, 5).packed_wgmma3()


def _pitch(sw):
    """``k4_pitch`` of csrc/conv_wgmma.cuh at stride 1, ks 5."""
    p = 256 + 4 * (sw + 1)
    return p + (4 - p) % 8


def _smem(bn, tw, C, es, stages=STAGES):
    """Shared memory of the 5x5's launch, as ``launch_wgmma`` computes it:
    ``stages`` stages of the halo'd tile's two planes and 25 BN 32 bytes
    of weights, or the epilogue's tiles."""
    sw = tw + 4
    stage = 2 * _pitch(sw) * 16 + 25 * bn * 32
    pw = bn if bn % 32 in (8, 24) else bn + 8
    tile = 256 * pw * 4 + (0 if es == 4 else 256 * bn * es)
    return -(-8 * bn // 128) * 128 + max(min(stages, -(-C // 32)) * stage,
                                         tile)


def test_dense5_route_takes_every_block_diagonal_call_to_wgmma():
    seen = set()
    for B, H, W, C in DW5_SIGNATURES:
        kind, bn, mi, vec, tw = KC.dense5_route(C, C, B, H, W, torch.int8, 0)
        assert (kind, mi, vec) == ("wgmma", 2, 16)
        first = next((b for b in KC.DENSE5_TILES if C <= b), 64)
        _, tiles = KC.k4_width(H, W, 256, 1, 5)
        # the narrowest tile where the first one's grid fills under half
        # the SMs, else the first
        thin = tiles * -(-C // first) * B < KC.SMS // 2
        assert bn == (24 if thin else first), (B, H, W, C)
        th = 256 // (tw + 4)
        assert tw % 2 == 0 and th >= 4 and tw <= W + 1
        assert all(_smem(bn, tw, C, es) <= SMEM_MAX for es in (1, 2, 4))
        seen.add((H, bn))
    # the 20 / 40-px calls take 24 a block; at 80 px 32 channels take 48
    # and 64 take 64
    assert seen == {(20, 24), (40, 24), (80, 48), (80, 64)}


def test_dense5_route_float32_and_dp4a():
    assert KC.dense5_route(64, 64, 4, 80, 80, torch.float32, 0)[:4] == (
        "wgmma_f32", 64, 2, 0)
    # float32 with C % 4, or off 16 bytes: the dp4a kernel
    assert KC.dense5_route(30, 32, 2, 20, 20, torch.float32, 0) == ("dp4a",)
    assert KC.dense5_route(64, 64, 2, 20, 20, torch.float32, 8) == ("dp4a",)
    # int8 staging granule from C and the address
    assert KC.dense5_route(24, 24, 1, 9, 9, torch.int8, 0)[3] == 8
    assert KC.dense5_route(20, 24, 1, 9, 9, torch.int8, 4100)[3] == 4


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16,
                                   torch.int32])
def test_dense5_route_refuses_other_input(dtype):
    """Input other than int8 and float32 gets no wgmma route (the wrapper
    refuses it before any launch); an int8 map off 4 bytes none at all."""
    assert KC.dense5_route(32, 32, 1, 8, 8, dtype, 0) == ("dp4a",)
    with pytest.raises(ValueError):
        KC.dense5_route(32, 32, 1, 8, 8, torch.int8, 4098)


def test_dense5_every_tile_fits_shared_memory():
    """Every tile the route can pick, at every row width k4_width can give
    it (at least 4 rows), every chunk count and output type, fits a block's
    shared memory in three stages; at BN 64 four would not."""
    for bn, mi in KC.DENSE5_TILES.items():
        assert mi == 2
        for tw in range(2, (256 // 4 - 4) + 1, 2):
            assert 256 // (tw + 4) >= 4
            for C in (4, 32, 64, 128, 512):
                assert all(_smem(bn, tw, C, es) <= SMEM_MAX
                           for es in (1, 2, 4)), (bn, tw, C)
    assert _smem(64, 28, 128, 1, stages=4) > SMEM_MAX
    assert 128 not in KC.DENSE5_TILES


@pytest.mark.parametrize("H,W", [(80, 80), (40, 40), (20, 20), (7, 30),
                                 (12, 9), (5, 5), (1, 1), (3, 200)])
def test_dense5_width_tiles_cover_the_map(H, W):
    tw, tiles = KC.k4_width(H, W, 256, 1, 5)
    th = 256 // (tw + 4)
    assert tw % 2 == 0 and th >= 4 and th * (tw + 4) <= 256
    assert tiles == -(-W // tw) * -(-H // th) and tw <= W + 1


def _wgmma5_sums(x, qw, tw):
    """The 5x5 on the wgmma core modelled in torch: per tile, the (th + 4)
    x (tw + 4) halo'd tile (staged position rr sw + cc holding pixel (y0 -
    2 + rr, x0 - 2 + cc), zeros outside the image, sw = tw + 4) flattened to
    positions, position m of the 256 computed reads position m + u sw + v
    for tap (u, v), times the packed weights of each 32-channel chunk;
    positions c >= tw or r >= th are dropped. -> (B, H, W, O) int64."""
    B, H, W, C = x.shape
    O = qw.c_out
    sw = tw + 4
    th = 256 // sw
    pl = _pitch(sw)
    assert (th + 4) * sw <= 2 * 256 <= pl + 256
    w = _unpack5(qw.packed_wgmma5()).long()              # (O8, 25, K)
    kc = w.shape[-1]
    xp = torch.zeros((B, H + th + 4, W + tw + 4, kc), dtype=torch.long)
    xp[:, 2:H + 2, 2:W + 2, :C] = x.long()
    out = torch.zeros((B, H, W, O), dtype=torch.long)
    for y0 in range(0, H, th):
        for x0 in range(0, W, tw):
            tile = xp[:, y0:y0 + th + 4, x0:x0 + sw].reshape(B, -1, kc)
            staged = torch.full((B, pl, kc), 99, dtype=torch.long)
            staged[:, :tile.shape[1]] = tile
            acc = torch.zeros((B, 256, w.shape[0]), dtype=torch.long)
            for t in range(25):
                shift = (t // 5) * sw + t % 5
                acc += staged[:, shift:shift + 256] @ w[:, t].t()
            acc = acc[:, :th * sw].reshape(B, th, sw, -1)[:, :, :tw, :O]
            nr, nx = min(th, H - y0), min(tw, W - x0)
            out[:, y0:y0 + nr, x0:x0 + nx] = acc[:, :nr, :nx]
    return out


@pytest.mark.parametrize("B,H,W,C,O,tw", [
    (2, 9, 13, 40, 20, None),    # C off 32, O off 8, ragged map
    (1, 20, 20, 32, 32, None),   # a served 20-px signature, cut down
    (1, 7, 30, 20, 64, 12),      # several tiles across
    (1, 12, 9, 64, 70, 60),      # the widest row: 4 rows a tile
    (2, 5, 5, 4, 8, None),       # C = 4: one partial group
    (1, 6, 1, 16, 24, 2),        # a single column
])
def test_wgmma5_addressing_equals_plain_sums(B, H, W, C, O, tw):
    rng = np.random.default_rng(B * 100 + C + O + H)
    qw = _qconv(rng, C, O)
    x = torch.from_numpy(rng.integers(-127, 128, (B, H, W, C)).astype(
        np.int8))
    if tw is None:
        tw = KC.dense5_route(C, O, B, H, W, torch.int8, 0)[4]
    sums = _wgmma5_sums(x, qw, tw)
    ref = F.conv2d(x.permute(0, 3, 1, 2).double(),
                   qw.w_q[..., :C].permute(0, 3, 1, 2).double(), padding=2)
    assert torch.equal(sums, ref.permute(0, 2, 3, 1).long())
    y = epilogue(sums.double(), qw.s_w, qw.bias, 1.0, None).float()
    assert torch.equal(y, KC.conv5x5_q8_plain(x, qw, 1.0, None))


def test_wgmma5_f32_staging_equals_plain_sums():
    """The float32 route: each staged value quant1(x / s_in) (``quantize``),
    then the 25 taps' addressing; equal to the plain version."""
    rng = np.random.default_rng(9)
    qw = _qconv(rng, 24, 40)
    x = torch.from_numpy(rng.uniform(-1.5, 1.5, (2, 11, 17, 24)).astype(
        np.float32))
    s_in = 0.0125
    kind, bn, mi, vec, tw = KC.dense5_route(24, 40, 2, 11, 17,
                                            torch.float32, 0)
    assert (kind, vec) == ("wgmma_f32", 0)
    sums = _wgmma5_sums(quantize(x, s_in), qw, tw)
    y = epilogue(sums.double(), qw.s_w, qw.bias, s_in, "relu").float()
    assert torch.equal(y, KC.conv5x5_q8_plain(x, qw, s_in, "relu"))


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
def test_conv5x5_wrapper_takes_plain_on_cpu_and_counts_nothing(dtype):
    rng = np.random.default_rng(12)
    qw = _qconv(rng, 24, 16)
    x = torch.from_numpy(rng.integers(-127, 128, (2, 7, 9, 24)).astype(
        np.int8)) if dtype == torch.int8 else torch.from_numpy(
            rng.uniform(-1, 1, (2, 7, 9, 24)).astype(np.float32))
    reset_launch_counts()
    for act, o, od in (("silu", 0.05, torch.float32),
                       (None, None, torch.bfloat16)):
        assert torch.equal(KC.conv5x5_q8(x, qw, 0.01, act, o, od),
                           KC.conv5x5_q8_plain(x, qw, 0.01, act, o, od))
    assert sum(launch_counts().values()) == 0
    assert sum(KC.LAUNCHES_DENSE5_ROUTE.values()) == 0
