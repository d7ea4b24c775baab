"""Host code of K4 ``conv3x3_q8``'s two designs, on the CPU: the packed
weights of the int8 ``wgmma`` design, ``k4_route`` at every K4 call of the
flagship's int8 and ``xla_q8`` forwards (routes ``wgmma``, ``wgmma_s2``,
``wgmma_f32`` and ``dp4a``), the shared memory of every route's tiles,
torch models of the ``wgmma`` kernel's addressing (stride 1: the halo'd
tile, the taps as position offsets; stride 2: four parity planes, the taps
as (plane, offset) pairs; float32 input: quantized, then stride 1's)
against the plain version's s32 sums, and the wrappers on CPU tensors
(their plain versions, no launch).

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
from rep_yolo_tpu_torch.ops.quant import epilogue, quantize

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


def _pitch(mb, sw, stride):
    """``k4_pitch`` of csrc/conv_flat.cu: a plane's 16-byte rows."""
    p = mb + 2 * sw + 2 if stride == 1 else mb + sw + 1
    return p + ((4 if stride == 1 else 2) - p) % 8


def _smem(bn, mi, tw, C, es, stride=1):
    """Shared memory of K4's wgmma launch, as ``launch3w`` in
    csrc/conv_flat.cu computes it (stride 2: four planes)."""
    mb, sw = 128 * mi, tw + 3 - stride
    stage = (2 if stride == 1 else 8) * _pitch(mb, sw, stride) * 16 \
        + 9 * bn * 32
    pw = bn if bn % 32 in (8, 24) else bn + 8
    tile = mb * pw * 4 + (0 if es == 4 else mb * bn * es)
    return -(-8 * bn // 128) * 128 + max(min(4, -(-C // 32)) * stage, tile)


# K4's launches by route of one forward at 640 px (chip_smoke.py gates the
# same counts on the card)
ROUTES_PER_FORWARD = {"int8": {"wgmma": 33, "wgmma_s2": 2, "dp4a": 1},
                      "xla_q8": {"wgmma": 20, "wgmma_f32": 4, "dp4a": 0}}


def test_k4_route_covers_every_flagship_call():
    calls = _flagship_k4_calls()
    assert len(calls["int8"]) == 36 and len(calls["xla_q8"]) == 24
    seen = set()
    for engine, want in ROUTES_PER_FORWARD.items():
        got = dict.fromkeys(KC.LAUNCHES_K4_ROUTE, 0)
        for C, O, hw, stride, i8 in calls[engine]:
            dtype = torch.int8 if i8 else torch.float32
            route = KC.k4_route(C, O, BATCH, hw, hw, stride, dtype, 0)
            got[route[0]] += 1
            if route[0] == "dp4a":
                # the stem alone: float32 input at stride 2
                assert (stride, i8, C) == (2, False, 3)
                continue
            kind, bn, mi, vec, tw = route
            assert kind == ("wgmma_s2" if stride == 2 else
                            "wgmma" if i8 else "wgmma_f32")
            table = KC.K4_TILES if stride == 1 else KC.K4_S2_TILES
            assert mi == table[bn]
            first = next((b for b in table if O <= b), max(table))
            ho = (hw - 1) // stride + 1
            if bn != first:
                # narrower only where the first tile's grid is thin
                _, tiles = KC.k4_width(ho, ho, 128 * table[first], stride)
                assert tiles * -(-O // first) * BATCH < 2 * KC.SMS
                assert 64 <= bn < first
            assert vec == (next(v for v in (16, 8, 4) if C % v == 0)
                           if i8 else 0)
            th = 128 * mi // (tw + 3 - stride)
            assert tw % 2 == 0 and th >= 2 and tw <= ho + 1
            assert all(_smem(bn, mi, tw, C, es, stride) <= SMEM_MAX
                       for es in (1, 2, 4))
            seen.add((kind, bn, mi))
        assert got == {**dict.fromkeys(got, 0), **want}
    # at batch 4 the 40 / 20-px grids are thin: 128 channels narrow to 64;
    # the PAN's two stride-2 calls (64 and 128 out) both take 64
    assert seen == {("wgmma", 24, 2), ("wgmma", 48, 2), ("wgmma", 64, 2),
                    ("wgmma_s2", 64, 2), ("wgmma_f32", 48, 2),
                    ("wgmma_f32", 64, 2)}
    # at batch 32 (bench.py's int8 point) l5's 128 -> 128 takes 128
    assert KC.k4_route(128, 128, 32, 80, 80, 1, torch.int8)[1:3] == (128, 2)


def test_k4_route_staging_granule_and_dp4a():
    assert KC.k4_route(24, 24, 4, 7, 9, 1, torch.int8, 0)[3] == 8
    assert KC.k4_route(48, 48, 4, 7, 9, 1, torch.int8, 4100)[3] == 4
    assert KC.k4_route(4, 16, 1, 5, 5, 1, torch.int8, 0)[3] == 4
    # the PAN-like stride-2 int8 call and xla_q8's float32 st1: wgmma
    assert KC.k4_route(48, 48, 4, 80, 80, 2, torch.int8, 0) == (
        "wgmma_s2", 48, 2, 16, KC.k4_width(40, 40, 256, 2)[0])
    assert KC.k4_route(48, 48, 4, 320, 320, 1, torch.float32, 0) == (
        "wgmma_f32", 48, 2, 0, KC.k4_width(320, 320, 256)[0])
    assert KC.k4_route(48, 48, 4, 7, 9, 2, torch.int8, 4100)[:4] == (
        "wgmma_s2", 48, 2, 4)
    # the stem (float32, C = 3, stride 2), float32 at stride 2, C = 3 at
    # stride 1, a float32 map off 16 bytes: dp4a
    for args in ((3, 48, 4, 640, 640, 2, torch.float32, 0),
                 (48, 48, 4, 80, 80, 2, torch.float32, 0),
                 (3, 16, 4, 40, 40, 1, torch.float32, 0),
                 (48, 48, 4, 40, 40, 1, torch.float32, 8)):
        assert KC.k4_route(*args) == ("dp4a",)
    with pytest.raises(ValueError):       # an int8 map off 4 bytes
        KC.k4_route(48, 48, 4, 7, 9, 1, torch.int8, 4098)
    with pytest.raises(ValueError):
        KC.k4_route(48, 48, 4, 7, 9, 2, torch.int8, 4098)


@pytest.mark.parametrize("stride", [1, 2])
def test_k4_every_wgmma_tile_fits_shared_memory(stride):
    """Every tile a route can pick, at every row width k4_width can give
    it, every chunk count and output type, fits a block's shared memory;
    stride 2 at BN 128, or at a row width past K4_S2_TW, would not."""
    table = KC.K4_TILES if stride == 1 else KC.K4_S2_TILES
    for bn, mi in table.items():
        mb = 128 * mi
        top = (mb // 2 - (3 - stride)) & ~1
        if stride == 2:
            top = min(top, KC.K4_S2_TW)
        for tw in range(2, top + 1, 2):
            assert mb // (tw + 3 - stride) >= 2
            for C in (4, 32, 64, 96, 128, 512):
                assert all(_smem(bn, mi, tw, C, es, stride) <= SMEM_MAX
                           for es in (1, 2, 4)), (bn, tw, C)
    if stride == 2:
        assert _smem(128, 2, 40, 256, 1, 2) > SMEM_MAX
        assert _smem(64, 2, KC.K4_S2_TW + 2, 256, 1, 2) > SMEM_MAX


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


@pytest.mark.parametrize("H,W", [(40, 40), (20, 20), (4, 5), (1, 1),
                                 (45, 130), (7, 200)])
def test_k4_width_stride2_tiles_cover_the_map(H, W):
    """k4_width over a stride-2 output map: th = 256 // (TW + 1) rows of
    an even TW <= K4_S2_TW columns, the tiles covering the map."""
    tw, tiles = KC.k4_width(H, W, 256, 2)
    th = 256 // (tw + 1)
    assert tw % 2 == 0 and tw <= KC.K4_S2_TW and th >= 2
    assert tiles == -(-W // tw) * -(-H // th) and tw <= W + 1


def _wgmma_s2_sums(x, qw, mi, tw):
    """K4's stride-2 wgmma kernel modelled in torch: per tile of th = MB //
    (tw + 1) output rows x tw columns, the input split into four planes by
    row and column parity (a, b), each (th + 1) x sw positions, sw = tw +
    1, position rr sw + cc of plane (a, b) holding input (2 (y0 - 1 + rr) +
    a, 2 (x0 - 1 + cc) + b), zeros outside the image; position m of the
    MB = 128 mi computed reads plane (u != 1, v != 1) at m + (u > 0) sw +
    (v > 0) for tap (u, v), times the packed weights; positions c >= tw or
    r >= th are dropped. -> (B, Ho, Wo, O) int64 sums."""
    B, H, W, C = x.shape
    O = qw.c_out
    mb, sw = 128 * mi, tw + 1
    th = mb // sw
    pl = _pitch(mb, sw, 2)
    ho, wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    w = _unpack3(qw.packed_wgmma3(), O, C).long()       # (O8, 9, chunks*32)
    kc = w.shape[-1]
    # input pixel (iy, ix) at xp[iy + 2, ix + 2]
    xp = torch.zeros((B, 2 * (ho + th) + 4, 2 * (wo + tw) + 4, kc),
                     dtype=torch.long)
    xp[:, 2:H + 2, 2:W + 2, :C] = x.long()
    out = torch.zeros((B, ho, wo, O), dtype=torch.long)
    for y0 in range(0, ho, th):
        for x0 in range(0, wo, tw):
            planes = torch.zeros((B, 4, pl, kc), dtype=torch.long)
            for a in (0, 1):
                for b in (0, 1):
                    rows = 2 * (y0 - 1) + a + 2 + 2 * torch.arange(th + 1)
                    cols = 2 * (x0 - 1) + b + 2 + 2 * torch.arange(sw)
                    tile = xp[:, rows][:, :, cols].reshape(B, -1, kc)
                    planes[:, 2 * a + b, :tile.shape[1]] = tile
            acc = torch.zeros((B, mb, w.shape[0]), dtype=torch.long)
            for t in range(9):
                u, v = divmod(t, 3)
                plane = 2 * (u != 1) + (v != 1)
                shift = (u > 0) * sw + (v > 0)
                acc += planes[:, plane, shift:shift + mb] @ w[:, t].t()
            acc = acc[:, :th * sw].reshape(B, th, sw, -1)[:, :, :tw, :O]
            nr, nx = min(th, ho - y0), min(tw, wo - x0)
            out[:, y0:y0 + nr, x0:x0 + nx] = acc[:, :nr, :nx]
    return out


@pytest.mark.parametrize("B,H,W,C,O", [
    (2, 7, 9, 24, 48),           # odd H and W: bottom and right pads
    (1, 6, 5, 4, 16),            # C = 4: one partial group; a tiny map
    (2, 9, 11, 40, 64),          # C = 40: a partial chunk
    (1, 1, 1, 16, 8),            # a single pixel
    (1, 30, 111, 32, 24),        # several tiles across, ragged
    (1, 40, 40, 128, 64),        # l33 (80 px at 640, 128 -> 64), cut down
    (1, 20, 20, 256, 128),       # l49 (40 px at 640, 256 -> 128), cut down
])
def test_wgmma_s2_addressing_equals_plain_sums(B, H, W, C, O):
    rng = np.random.default_rng(B * 100 + C + O + H)
    qw = _qconv(rng, C, O)
    x = _int8(rng, (B, H, W, C))
    kind, bn, mi, vec, tw = KC.k4_route(C, O, B, H, W, 2, torch.int8, 0)
    assert kind == "wgmma_s2" and bn in KC.K4_S2_TILES
    sums = _wgmma_s2_sums(x, qw, mi, tw)
    ref = F.conv2d(x.permute(0, 3, 1, 2).double(),
                   qw.w_q.permute(0, 3, 1, 2).double(), stride=2, padding=1)
    assert sums.shape[1:3] == ((H - 1) // 2 + 1, (W - 1) // 2 + 1)
    assert torch.equal(sums, ref.permute(0, 2, 3, 1).long())
    y = epilogue(sums.double(), qw.s_w, qw.bias, 1.0, None).float()
    assert torch.equal(y, KC.conv3x3_q8_plain(x, qw, 1.0, 2, None))


@pytest.mark.parametrize("B,H,W,C,O", [
    (2, 7, 9, 24, 48),           # a map smaller than one tile
    (1, 13, 21, 48, 24),         # xla_q8's st1 channels, ragged
    (1, 5, 5, 4, 16),            # C = 4
    (1, 10, 10, 128, 128),       # the 80-px st1, cut down
])
def test_wgmma_f32_staging_equals_plain_sums(B, H, W, C, O):
    """The float32 route: each staged value quant1(x / s_in) (``quantize``,
    exact as the kernel's), then stride 1's addressing; equal to the plain
    version on the float32 map."""
    rng = np.random.default_rng(B * 10 + C + O + H)
    qw = _qconv(rng, C, O)
    x = torch.from_numpy(rng.uniform(-1.5, 1.5, (B, H, W, C)).astype(
        np.float32))
    s_in = 0.0125
    kind, bn, mi, vec, tw = KC.k4_route(C, O, B, H, W, 1, torch.float32, 0)
    assert (kind, vec) == ("wgmma_f32", 0)
    sums = _wgmma_sums(quantize(x, s_in), qw, mi, tw)
    y = epilogue(sums.double(), qw.s_w, qw.bias, s_in, "relu").float()
    assert torch.equal(y, KC.conv3x3_q8_plain(x, qw, s_in, 1, "relu"))


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

