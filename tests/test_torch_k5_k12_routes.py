"""Host code of K5 ``conv1x1_q8`` (int8 ``wgmma``) and K12
``dwconv5x5_f32w_q8``, on the CPU: K5's packed weights, its tile and
staging route at every call of the flagship's int8 forward, the
``torch._int_mm`` yardstick that ``chip_smoke.py`` times beside it, and
the wrappers on CPU tensors (their plain versions, no launch).

Exact comparisons throughout: the packing is a permutation with zeros,
and the s32 sums are integers.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from rep_yolo_tpu_torch.ops.kernels import conv_flat as KC
from rep_yolo_tpu_torch.ops.kernels import neck_flat as KNF
from rep_yolo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMEM_MAX = 232448           # bytes of shared memory a block may use

# (sections' channels, O) of the flagship's K5 calls at 640 px outside the
# backbone's DER blocks: the SPPCSPC, the neck and the head
NECK_K5 = [((512,), 512), ((2048,), 512), ((512, 512), 512), ((512,), 64),
           ((256, 128), 128), ((128,), 64), ((128,), 128), ((128, 128), 256),
           ((256,), 64), ((128, 128), 128), ((128,), 256), ((64,), 32),
           ((64,), 64), ((64, 64), 128), ((128, 128, 256), 256),
           ((256,), 512), ((512,), 128), ((256,), 128),
           ((256, 256, 512), 512), ((512,), 1024), ((1024,), 256),
           ((256,), 256), ((256, 256), 512), ((512,), 256), ((256,), 18),
           ((512,), 18), ((1024,), 18)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _qconv(rng, c_in, c_out):
    w = rng.normal(0, 0.1, (c_out, c_in, 1, 1)).astype(np.float32)
    b = rng.normal(0, 0.5, (c_out,)).astype(np.float32)
    return KC.QConv(torch.from_numpy(w), torch.from_numpy(b))


def _unpack(packed, cs, O):
    """packed [step][O8/8][2][8][16] -> the (O, sum(cs)) weights, and the
    pads (their bytes must be zero)."""
    steps, og = packed.shape[:2]
    k = packed.permute(1, 3, 0, 2, 4).reshape(og * 8, steps * 32)
    cols, pads, off = [], [k[O:]], 0
    for c in cs:
        g = -(-c // 16) * 16
        cols.append(k[:O, off:off + c])
        pads.append(k[:O, off + c:off + g])
        off += g
    pads.append(k[:O, off:])
    return torch.cat(cols, 1), pads


@pytest.mark.parametrize("cs", [(24,), (48,), (128,), (256,), (24, 48),
                                (48, 48, 48), (128, 128, 256),
                                (256, 256, 256)])
@pytest.mark.parametrize("O", [24, 48, 128, 256, 512])
def test_packed_wgmma_unpacks_to_w_q(O, cs):
    qw = _qconv(np.random.default_rng(O + sum(cs)), sum(cs), O)
    packed = qw.packed_wgmma(cs)
    groups = sum(-(-c // 16) for c in cs)
    assert packed.dtype == torch.int8
    assert tuple(packed.shape) == (-(-groups // 8) * 4, -(-O // 8), 2, 8, 16)
    w, pads = _unpack(packed, cs, O)
    assert torch.equal(w, qw.w_q.reshape(O, -1))
    assert all(int(p.abs().sum()) == 0 for p in pads)
    assert qw.packed_wgmma(list(cs)) is packed          # made once


def test_packed_wgmma_refuses_other_sections():
    qw = _qconv(np.random.default_rng(0), 48, 24)
    with pytest.raises(ValueError):
        qw.packed_wgmma((24, 16))


def _flagship_k5_calls():
    """(cs, O, rows, pool) of every K5 call of one int8 forward at 640 px,
    batch 4: the backbone's from ``chip_smoke.backbone_q8_shapes``, the
    rest from ``NECK_K5`` at their maps' sizes."""
    calls = []
    for name, kern, cins, cout, hw, _, _, _, pool, n in \
            _chip_smoke().backbone_q8_shapes():
        if kern == "conv1x1_q8":
            calls += [(cins, cout, 4 * hw * hw, pool)] * n
    for cs, O in NECK_K5:
        for hw in (20, 40, 80):
            calls.append((cs, O, 4 * hw * hw, False))
    return calls


def _smem(bn, mi, nsteps, pool):
    """Shared memory of K5's launch, as ``launch1`` in csrc/conv_flat.cu
    computes it."""
    ks = 2 if bn <= 48 else 4
    mb = 128 * mi
    stage = 2 * ks * (mb + 1) * 16 + ks * bn * 32
    chunks = -(-nsteps // ks)
    tile = (mb // 4 if pool else mb) * (4 * bn + 16)
    return -(-8 * bn // 128) * 128 + max(min(4, chunks) * stage, tile)


def test_k5_route_covers_every_flagship_call():
    calls = _flagship_k5_calls()
    assert len(calls) >= 28 + len(NECK_K5)
    seen = set()
    for cs, O, rows, pool in calls:
        bn, mi, vec = KC.k5_route(cs, O, rows, False)
        assert mi == KC.K5_TILES[bn]
        first = next((b for b in KC.K5_TILES if O <= b), 256)
        if bn != first:
            # narrower only where the first tile's grid is thin
            grid = -(-rows // (128 * KC.K5_TILES[first])) * -(-O // first)
            assert grid < 2 * KC.SMS and 64 <= bn < first
        assert vec in (16, 8, 4) and all(c % vec == 0 for c in cs)
        assert vec == 16 or any(c % 16 for c in cs)
        nsteps = -(-sum(-(-c // 16) for c in cs) // 2)
        assert _smem(bn, mi, nsteps, pool) <= SMEM_MAX
        seen.add((bn, mi))
    # the flagship's calls take every tile, the small maps narrower ones
    assert seen == set(KC.K5_TILES.items())


def test_k5_route_float_input_and_alignment():
    assert KC.k5_route((48,), 24, 1000, True) == (24, 2, 0)
    assert KC.k5_route((24,), 48, 1000, False, [4096]) == (48, 2, 8)
    assert KC.k5_route((48,), 48, 1000, False, [4100])[2] == 4
    # 256-row tiles for 24 / 48 channels, 128-row ones above
    assert KC.k5_route((24,), 48, 4 * 320 * 320, False)[:2] == (48, 2)
    assert KC.k5_route((48,), 128, 4 * 160 * 160, False)[:2] == (128, 1)
    # a small map takes narrower tiles: l9's 512 -> 512 at 20 x 20, batch 4
    assert KC.k5_route((512,), 512, 4 * 20 * 20, False)[:2] == (64, 1)
    assert KC.k5_route((384,), 256, 4 * 80 * 80, False)[:2] == (128, 1)
    assert KC.k5_route((768,), 512, 8 * 80 * 80, False)[:2] == (256, 1)
    with pytest.raises(ValueError):
        KC.k5_route((48,), 24, 1000, False, [4098])


@pytest.mark.parametrize("cs,O", [((48,), 24), ((24,), 48), ((48, 48, 48), 48),
                                  ((48, 48, 48), 128), ((128, 128, 128), 256),
                                  ((256, 256, 256), 512), ((2048,), 512),
                                  ((512, 512), 512), ((128, 128, 256), 256),
                                  ((256, 256, 512), 512), ((512,), 1024),
                                  ((1024,), 18)])
def test_int_mm_yardstick_computes_k5_sums(cs, O):
    """``torch._int_mm`` of the materialised concat, as ``chip_smoke.py``
    times it, equals K5's exact s32 sums (``conv1x1_q8_sums``, which
    ``conv1x1_q8_plain`` runs) at the flagship's K5 signatures, on a
    small map."""
    rng = np.random.default_rng(sum(cs) + O)
    qw = _qconv(rng, sum(cs), O)
    xs = [torch.from_numpy(rng.integers(-127, 128, (1, 4, 5, c)).astype(
        np.int8)) for c in cs]
    a = torch.cat(xs, -1).reshape(-1, sum(cs))
    got = torch._int_mm(a, qw.w_q.reshape(O, -1).t())
    ref = KC.conv1x1_q8_sums(xs, qw, 1.0)
    assert torch.equal(got, ref.reshape(-1, O).to(torch.int32))
    assert float(ref.abs().max()) < 2 ** 31


@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
def test_k5_wrapper_takes_plain_on_cpu_and_counts_nothing(dtype, pool):
    rng = np.random.default_rng(7)
    qw = _qconv(rng, 24 + 48, 48)
    if dtype == torch.int8:
        xs = [torch.from_numpy(rng.integers(-127, 128, (2, 6, 8, c)).astype(
            np.int8)) for c in (24, 48)]
    else:
        xs = [torch.from_numpy(rng.uniform(-1, 1, (2, 6, 8, c)).astype(
            np.float32)) for c in (24, 48)]
    reset_launch_counts()
    for out_scale, out_dtype in ((0.05, torch.float32), (None, torch.float32),
                                 (None, torch.bfloat16)):
        args = (qw, 0.01, "silu", out_scale, pool, out_dtype)
        assert torch.equal(KC.conv1x1_q8(xs, *args),
                           KC.conv1x1_q8_plain(xs, *args))
    assert sum(launch_counts().values()) == 0


@pytest.mark.parametrize("out_scale", [None, 0.03])
def test_k12_wrapper_takes_plain_on_cpu_and_counts_nothing(out_scale):
    rng = np.random.default_rng(8)
    C = 40
    wt = torch.from_numpy(rng.normal(0, 0.1, (C, 1, 5, 5)).astype(np.float32))
    qd = KNF.QDepthwiseF32(wt, torch.zeros(C), torch.full((C,), 0.02))
    x = torch.from_numpy(rng.integers(-127, 128, (2, 7, 9, C)).astype(np.int8))
    reset_launch_counts()
    assert torch.equal(KNF.dwconv5x5_f32w_q8(x, qd, "silu", out_scale),
                       KNF.dwconv5x5_f32w_q8_plain(x, qd, "silu", out_scale))
    assert sum(launch_counts().values()) == 0
