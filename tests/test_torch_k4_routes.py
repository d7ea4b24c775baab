"""Host code of K4 ``conv3x3_q8``'s two designs, on the CPU: the packed
weights of the int8 ``wgmma`` design, ``k4_route`` at every K4 call of the
flagship's int8 and ``xla_q8`` forwards, a torch model of the ``wgmma``
kernel's addressing (the halo'd tile, the taps as position offsets, the
packed weights) against the plain version's s32 sums, and the wrappers on
CPU tensors (their plain versions, no launch).

Exact comparisons throughout: the packing is a permutation with zeros, and
the s32 sums are integers.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rep_yolo_tpu_torch.ops.kernels import conv_flat as KC
from rep_yolo_tpu_torch.ops.kernels import conv_pm as KPM
from rep_yolo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from rep_yolo_tpu_torch.ops.quant import epilogue

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMEM_MAX = 232448           # bytes of shared memory a block may use
BATCH = 4                   # the served batch

# (C, O, H = W, stride, int8 input) of the flagship's K4 calls at 640 px
# outside the backbone: the SPPCSPC, the neck and the head (recorded from
# one int8 forward of cfg/rep_yolo.yaml), in layer order
NECK_K4 = [(512, 512, 20, 1, True), (512, 512, 20, 1, True),
           (128, 64, 40, 1, True), (64, 32, 80, 1, True),
           (128, 64, 80, 2, True), (128, 64, 40, 1, True),
           (256, 128, 40, 2, True), (256, 128, 20, 1, True),
           (128, 256, 80, 1, True), (256, 512, 40, 1, True),
           (512, 1024, 20, 1, True)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _qconv(rng, c_in, c_out, k=3):
    w = rng.normal(0, 0.1, (c_out, c_in, k, k)).astype(np.float32)
    b = rng.normal(0, 0.5, (c_out,)).astype(np.float32)
    return KC.QConv(torch.from_numpy(w), torch.from_numpy(b))


def _int8(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


def _unpack3(packed, O, cp):
    """packed [chunk][tap][O8/8][2][8][16] -> (O8, 9, chunks * 32)."""
    chunks, taps, og = packed.shape[:3]
    assert taps == 9
    return packed.permute(2, 4, 1, 0, 3, 5).reshape(og * 8, 9, chunks * 32)


@pytest.mark.parametrize("C", [24, 48, 64, 128, 256])
@pytest.mark.parametrize("O", [24, 48, 64, 128, 256])
def test_packed_wgmma3_unpacks_to_w_q(O, C):
    qw = _qconv(np.random.default_rng(O + C), C, O)
    packed = qw.packed_wgmma3()
    assert packed.dtype == torch.int8
    assert tuple(packed.shape) == (-(-C // 32), 9, -(-O // 8), 2, 8, 16)
    k = _unpack3(packed, O, C)
    assert torch.equal(k[:O, :, :C], qw.w_q.reshape(O, 9, C))
    assert int(k[O:].abs().sum()) == 0 and int(k[:, :, C:].abs().sum()) == 0
    assert qw.packed_wgmma3() is packed                  # made once


def test_packed_wgmma3_refuses_other_taps():
    with pytest.raises(ValueError):
        _qconv(np.random.default_rng(0), 16, 16, 1).packed_wgmma3()


def _flagship_k4_calls():
    """{engine: [(C, O, H, stride, int8 input)]} of every K4 call of one
    forward at 640 px: the int8 engine's backbone from
    ``chip_smoke.backbone_q8_shapes`` and the rest from ``NECK_K4``; the
    ``xla_q8`` engine's DER 3x3s, whose st1 reads the float32 map."""
    int8, xla = [], []
    for name, kern, cins, cout, hw, stride, f32_in, _, _, n in \
            _chip_smoke().backbone_q8_shapes():
        if kern != "conv3x3_q8":
            continue
        int8 += [(cins[0], cout, hw, stride, not f32_in)] * n
        if name != "l0 stem":
            st1 = name.endswith("st1-st3")
            xla += [(cins[0], cout, hw, 1, not (st1 and i == 0))
                    for i in range(n)]
    return {"int8": int8 + NECK_K4, "xla_q8": xla}


def _smem(bn, mi, tw, C, es):
    """Shared memory of K4's wgmma launch, as ``launch3w`` in
    csrc/conv_flat.cu computes it."""
    mb, sw = 128 * mi, tw + 2
    p = mb + 2 * sw + 2
    pl = p + (4 - p) % 8
    stage = 2 * pl * 16 + 9 * bn * 32
    pw = bn if bn % 32 in (8, 24) else bn + 8
    tile = mb * pw * 4 + (0 if es == 4 else mb * bn * es)
    return -(-8 * bn // 128) * 128 + max(min(4, -(-C // 32)) * stage, tile)


def test_k4_route_covers_every_flagship_call():
    calls = _flagship_k4_calls()
    assert len(calls["int8"]) == 36 and len(calls["xla_q8"]) == 24
    seen = set()
    for engine, want in (("int8", 33), ("xla_q8", 20)):
        on = 0
        for C, O, hw, stride, i8 in calls[engine]:
            dtype = torch.int8 if i8 else torch.float32
            route = KC.k4_route(C, O, BATCH, hw, hw, stride, dtype, 0)
            if stride != 1 or not i8:
                assert route == ("dp4a",)
                continue
            on += 1
            kind, bn, mi, vec, tw = route
            assert kind == "wgmma" and mi == KC.K4_TILES[bn]
            first = next((b for b in KC.K4_TILES if O <= b), 128)
            if bn != first:
                # narrower only where the first tile's grid is thin
                _, tiles = KC.k4_width(hw, hw, 128 * KC.K4_TILES[first])
                assert tiles * -(-O // first) * BATCH < 2 * KC.SMS
                assert 64 <= bn < first
            assert vec == next(v for v in (16, 8, 4) if C % v == 0)
            th = 128 * mi // (tw + 2)
            assert tw % 2 == 0 and th >= 2 and tw <= hw + 1
            assert all(_smem(bn, mi, tw, C, es) <= SMEM_MAX
                       for es in (1, 2, 4))
            seen.add((bn, mi))
        assert on == want
    # at batch 4 the 40 / 20-px grids are thin: 128 channels narrow to 64
    assert seen == {(24, 2), (48, 2), (64, 2)}
    # at batch 32 (bench.py's int8 point) l5's 128 -> 128 takes 128
    assert KC.k4_route(128, 128, 32, 80, 80, 1, torch.int8)[1:3] == (128, 2)


def test_k4_route_staging_granule_and_dp4a():
    assert KC.k4_route(24, 24, 4, 7, 9, 1, torch.int8, 0)[3] == 8
    assert KC.k4_route(48, 48, 4, 7, 9, 1, torch.int8, 4100)[3] == 4
    assert KC.k4_route(4, 16, 1, 5, 5, 1, torch.int8, 0)[3] == 4
    for args in ((48, 48, 4, 80, 80, 2, torch.int8),
                 (3, 48, 4, 640, 640, 2, torch.float32),
                 (48, 48, 4, 320, 320, 1, torch.float32)):
        assert KC.k4_route(*args, 0) == ("dp4a",)
    with pytest.raises(ValueError):       # an int8 map off 4 bytes
        KC.k4_route(48, 48, 4, 7, 9, 1, torch.int8, 4098)


@pytest.mark.parametrize("H,W,mb", [(320, 320, 256), (160, 160, 256),
                                    (80, 80, 128), (40, 40, 128),
                                    (20, 20, 128), (7, 9, 256), (13, 21, 128),
                                    (1, 1, 128)])
def test_k4_width_tiles_cover_the_map(H, W, mb):
    tw, tiles = KC.k4_width(H, W, mb)
    th = mb // (tw + 2)
    assert tw % 2 == 0 and th >= 2 and th * (tw + 2) <= mb
    assert tiles == -(-W // tw) * -(-H // th)
    assert (W + tw - 1) // tw * tw >= W and tw <= W + 1


def _wgmma_sums(x, qw, mi, tw):
    """K4's wgmma kernel modelled in torch: per tile, the (th + 2) x (tw +
    2) halo'd tile gathered with zeros outside the image and flattened to
    positions (a plane of pl rows a 16-channel group), position m of the
    MB = 128 mi computed reads position m + u (tw + 2) + v for tap (u, v),
    times the packed weights of each 32-channel chunk; positions c >= tw or
    r >= th are dropped. -> (B, H, W, O) int64 sums."""
    B, H, W, C = x.shape
    O = qw.c_out
    mb, sw = 128 * mi, tw + 2
    th = mb // sw
    p = mb + 2 * sw + 2
    pl = p + (4 - p) % 8
    w = _unpack3(qw.packed_wgmma3(), O, C).long()       # (O8, 9, chunks*32)
    kc = w.shape[-1]
    xp = torch.zeros((B, H + th + 2, W + tw + 2, kc), dtype=torch.long)
    xp[:, 1:H + 1, 1:W + 1, :C] = x.long()
    out = torch.zeros((B, H, W, O), dtype=torch.long)
    for y0 in range(0, H, th):
        for x0 in range(0, W, tw):
            tile = xp[:, y0:y0 + th + 2, x0:x0 + sw].reshape(B, -1, kc)
            staged = torch.zeros((B, pl, kc), dtype=torch.long)
            staged[:, :tile.shape[1]] = tile
            acc = torch.zeros((B, mb, w.shape[0]), dtype=torch.long)
            for t in range(9):
                shift = (t // 3) * sw + t % 3
                acc += staged[:, shift:shift + mb] @ w[:, t].t()
            acc = acc[:, :th * sw].reshape(B, th, sw, -1)[:, :, :tw, :O]
            nr, nx = min(th, H - y0), min(tw, W - x0)
            out[:, y0:y0 + nr, x0:x0 + nx] = acc[:, :nr, :nx]
    return out


@pytest.mark.parametrize("B,H,W,C,O,mi", [
    (2, 7, 9, 24, 48, 2),        # a map smaller than one tile
    (1, 13, 21, 48, 24, 1),      # ragged H and W
    (1, 20, 20, 64, 128, 1),     # the neck's 20-px maps
    (1, 6, 40, 96, 200, 2),      # O off the tiles, three chunks
    (1, 5, 5, 4, 16, 1),         # C = 4: one partial group
    (2, 9, 11, 40, 64, 2),       # C = 40: a partial chunk
])
def test_wgmma_addressing_equals_plain_sums(B, H, W, C, O, mi):
    rng = np.random.default_rng(B * 100 + C + O)
    qw = _qconv(rng, C, O)
    x = _int8(rng, (B, H, W, C))
    tw, _ = KC.k4_width(H, W, 128 * mi)
    sums = _wgmma_sums(x, qw, mi, tw)
    ref = F.conv2d(x.permute(0, 3, 1, 2).double(),
                   qw.w_q.permute(0, 3, 1, 2).double(), padding=1)
    assert torch.equal(sums, ref.permute(0, 2, 3, 1).long())
    # and through the epilogue: the plain version's float32 exit
    y = epilogue(sums.double(), qw.s_w, qw.bias, 1.0, None).float()
    assert torch.equal(y, KC.conv3x3_q8_plain(x, qw, 1.0, 1, None))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
def test_k4_wrappers_take_plain_on_cpu_and_count_nothing(dtype, stride):
    rng = np.random.default_rng(11)
    qw = _qconv(rng, 24, 32)
    if dtype == torch.int8:
        x = _int8(rng, (2, 7, 9, 24))
    else:
        x = torch.from_numpy(rng.uniform(-1, 1, (2, 7, 9, 24)).astype(
            np.float32))
    reset_launch_counts()
    for act, out_scale, out_dtype in (("silu", 0.05, torch.float32),
                                      ("relu", None, torch.float32),
                                      (None, None, torch.bfloat16)):
        args = (qw, 0.01, stride, act, out_scale, out_dtype)
        assert torch.equal(KC.conv3x3_q8(x, *args),
                           KC.conv3x3_q8_plain(x, *args))
    if stride == 1:
        xp = x.reshape(2, 63, 24)
        assert torch.equal(KPM.conv3x3_pm_q8(xp, qw, 0.01, 7, 9, "relu"),
                           KPM.conv3x3_pm_q8_plain(xp, qw, 0.01, 7, 9,
                                                   "relu"))
        q5 = _qconv(rng, 24, 16, 5)
        assert torch.equal(KC.conv5x5_q8(x, q5, 0.01),
                           KC.conv5x5_q8_plain(x, q5, 0.01))
    assert sum(launch_counts().values()) == 0
    assert sum(KC.LAUNCHES_K4_ROUTE.values()) == 0

