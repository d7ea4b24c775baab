"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips without a CUDA device. This file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed (``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances: attention f32 atol = rtol = 1e-4 (summation order differs; K1
and K2, vertical and criss-cross, also bit-identical on a second call);
NMS keep sets identical (K up to 8192, evaluation's max_nms); the row-3
route (the train-form attention in eval() on K2) against the einsum path
atol = rtol = 1e-4; the int8 kernels (K5 on the int8 tensor cores and
K12's float32 sums included): int8 outputs identical but for +-1 LSB on at
most 1e-4 of the elements (CUDA's expf against torch's sigmoid), float32
outputs atol = rtol = 1e-5, bfloat16 outputs within one bfloat16 ulp
(``_q8_out_close``), pools (K6, K8) identical, on maps off 16 bytes too
(the word route), and on a second call;
K9 wgrad3x3: |dW - plain| <= 1e-4 |plain| + 1e-4 max|plain| (sums of up to
51,200 products in another order, as Winograd tiles in 3xTF32), and two
calls identical; K10 / K11 (conv3x3_cmajor,
conv1x1_cmajor): float32 atol = rtol = 1e-4, bfloat16 at most one bfloat16
ulp from the plain version or within 1e-3 max|plain| where the value is near
zero (both sum in float32 in another order, then round once), two bfloat16
calls identical; K13 / K14
(conv3x3_cmajor_q8, conv1x1_cmajor_q8), conv5x5_q8 and the pixel-major
wrappers (conv_pm, on K4 / K5): int8 as the int8 kernels, bfloat16 at most
one bfloat16 ulp (the same exact s32 sums and float32 epilogue, rounded
once; only the SiLU's last bit differs); conv5x5_q8 with block-diagonal
weights equal to K7 bit for bit; K4 on its three int8 wgmma routes
(stride 1 and 2 on int8 input, stride 1 on float32 input; each tile
forced), K13 on the same core (int8, float32 and bfloat16 input, each
tile forced) and the dense 5x5 on it (int8 and float32 input, each tile
forced), and K4's dp4a calls (the float32 stem, a float32 map off 16
bytes, a float32 5x5 of C % 4): every output bit for bit its plain
version. Train-time augmentation (no kernel of its own) with mosaic-9,
paste-in and cutout forced on, on the card against the CPU: masks
identical, labels 1e-5, images 4 * 2**-10 * 1.4 on [0, 1].
"""

import numpy as np
import pytest
import torch

from rep_yolo_tpu_torch.nn.blocks import AxialAttention
from rep_yolo_tpu_torch.nn.fuse import fuse_state_dict
from rep_yolo_tpu_torch.ops import nms as TN
from rep_yolo_tpu_torch.ops.kernels import axial_attention as KA
from rep_yolo_tpu_torch.ops.kernels import conv_flat as KC
from rep_yolo_tpu_torch.ops.kernels import conv_kernel as KCM
from rep_yolo_tpu_torch.ops.kernels import conv_pm as KPM
from rep_yolo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from rep_yolo_tpu_torch.ops.kernels import neck_flat as KNF
from rep_yolo_tpu_torch.ops.kernels import nms as KN
from rep_yolo_tpu_torch.ops.kernels import pool_flat as KP
from rep_yolo_tpu_torch.ops.kernels import wgrad as KW

pytestmark = pytest.mark.cuda
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _attention_inputs(c, h, w, seed, device, batch=2):
    g = torch.Generator().manual_seed(seed)
    state = {}
    for name, t in AxialAttention(c, True).state_dict().items():
        if name.endswith("running_var") or (name.endswith("weight")
                                            and t.ndim == 1):
            state[name] = 0.5 + torch.rand(t.shape, generator=g)
        elif name.endswith("gamma"):
            state[name] = torch.full(t.shape, 0.7)
        else:
            state[name] = 0.3 * torch.randn(t.shape, generator=g)
    packed = fuse_state_dict(state)
    x = torch.randn((batch, h, w, c), generator=g)
    consts = [packed[k] for k in ("wqk", "pq", "pv", "gamma")]
    return [t.to(device) for t in (x, *consts)]


@pytest.mark.parametrize("criss_cross", [True, False])
@pytest.mark.parametrize("shape", [(64, 40, 40), (32, 13, 21), (256, 20, 20),
                                   (32, 21, 13), (8, 4, 1600)])
def test_attention_kernels_match_plain(cuda, criss_cross, shape):
    x, wqk, pq, pv, gamma = _attention_inputs(*shape, seed=shape[1], device=cuda)
    with torch.no_grad():
        q, k, v = KA.project(x, wqk, pq, pv)
        for a, b in zip((q, k, v), KA.project_plain(x, wqk, pq, pv)):
            torch.testing.assert_close(a, b, **TOL)
        got = KA.attend(q, k, v, x, gamma, criss_cross)
        torch.testing.assert_close(
            got, KA.attend_plain(q, k, v, x, gamma, criss_cross), **TOL)


def test_wrappers_count_launches_and_refuse_bad_input(cuda):
    x, wqk, pq, pv, gamma = _attention_inputs(16, 8, 8, 0, cuda)
    reset_launch_counts()
    with torch.no_grad():
        KA.axial_attention(x, wqk, pq, pv, gamma, True)
    counts = launch_counts()
    assert counts["axial_project"] == 1
    assert counts["axial_attend_criss_cross"] == 1
    with pytest.raises(ValueError):
        KA.project(x.double(), wqk, pq, pv)
    with pytest.raises(ValueError):
        KN.nms_keep(torch.zeros((1, KN.MAX_K + 1, 4), device=cuda),
                    torch.ones((1, KN.MAX_K + 1), dtype=torch.bool,
                               device=cuda), 0.5)


# (C, H, W) of the six CCVA blocks at 640 px, an odd map, and the P3 map of
# 1280 px
_K1_K2V_SHAPES = [(64, 80, 80), (32, 80, 80), (128, 40, 40), (64, 40, 40),
                  (256, 20, 20), (128, 20, 20), (32, 13, 21), (64, 160, 160)]


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("shape", _K1_K2V_SHAPES)
def test_project_and_vertical_column_kernel_match_plain(cuda, shape, batch):
    """K1 and K2's column kernel against their plain versions; a second
    call of each is bit-identical; vertical launches the column kernel
    alone."""
    x, wqk, pq, pv, gamma = _attention_inputs(*shape, seed=shape[0] + batch,
                                              device=cuda, batch=batch)
    with torch.no_grad():
        reset_launch_counts()
        q, k, v = KA.project(x, wqk, pq, pv)
        for a, b in zip((q, k, v), KA.project_plain(x, wqk, pq, pv)):
            torch.testing.assert_close(a, b, **TOL)
        y = KA.attend(q, k, v, x, gamma, False)
        torch.testing.assert_close(
            y, KA.attend_plain(q, k, v, x, gamma, False), **TOL)
        assert launch_counts()["axial_project"] == 1
        assert launch_counts()["axial_attend_vertical"] == 1
        assert launch_counts()["axial_attend_criss_cross"] == 0
        for a, b in zip((q, k, v), KA.project(x, wqk, pq, pv)):
            assert torch.equal(a, b)
        assert torch.equal(y, KA.attend(q, k, v, x, gamma, False))


@pytest.mark.parametrize("shape", [(384, 20, 20), (192, 40, 40),
                                   (8, 13, 21)])
def test_vertical_column_kernel_channel_tiles(cuda, shape):
    """The P6 widths (three channel tiles, more than 48 KB of shared
    memory at C = 384) and C = 8 (c8 = 1: 4-byte key copies)."""
    x, wqk, pq, pv, gamma = _attention_inputs(*shape, seed=7, device=cuda)
    with torch.no_grad():
        q, k, v = KA.project(x, wqk, pq, pv)
        for a, b in zip((q, k, v), KA.project_plain(x, wqk, pq, pv)):
            torch.testing.assert_close(a, b, **TOL)
        torch.testing.assert_close(
            KA.attend(q, k, v, x, gamma, False),
            KA.attend_plain(q, k, v, x, gamma, False), **TOL)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("shape", _K1_K2V_SHAPES + [(384, 20, 20),
                                                    (8, 13, 21), (8, 4, 1600),
                                                    (16, 45, 100)])
def test_criss_cross_row_and_column_passes_match_plain(cuda, shape, batch):
    """K2 criss-cross (the row pass, then the column pass that merges the
    two under the joint softmax) against its plain version at the CCVA
    shapes, the P3 map of 1280 px, a P6 width, C = 8, lines that are not a
    multiple of the chunk, and a 4 x 1600 map past the 48 KB that the
    first criss-cross kernel needed; a second call is bit-identical; one
    wrapper call counts one launch."""
    x, wqk, pq, pv, gamma = _attention_inputs(*shape, seed=shape[2] + batch,
                                              device=cuda, batch=batch)
    with torch.no_grad():
        q, k, v = KA.project_plain(x, wqk, pq, pv)
        reset_launch_counts()
        y = KA.attend(q, k, v, x, gamma, True)
        assert launch_counts()["axial_attend_criss_cross"] == 1
        assert launch_counts()["axial_attend_vertical"] == 0
        torch.testing.assert_close(
            y, KA.attend_plain(q, k, v, x, gamma, True), **TOL)
        assert torch.equal(y, KA.attend(q, k, v, x, gamma, True))


def test_project_and_vertical_refuse_bad_input(cuda):
    x, wqk, pq, pv, gamma = _attention_inputs(32, 8, 8, 0, cuda)
    q, k, v = KA.project(x, wqk, pq, pv)
    with pytest.raises(ValueError):                         # dtype
        KA.project(x, wqk.double(), pq, pv)
    with pytest.raises(ValueError):                         # device
        KA.project(x, wqk.cpu(), pq, pv)
    with pytest.raises(ValueError):                         # shape
        KA.project(x, wqk[:, :16], pq, pv)
    with pytest.raises(ValueError):                         # C % 4
        xb = torch.randn(1, 4, 4, 10, device=cuda)
        KA.project(xb, torch.zeros(2, 10, device=cuda),
                   torch.zeros(3, 2, device=cuda),
                   torch.zeros(4, 10, device=cuda))
    with pytest.raises(ValueError):
        KA.attend(q.half(), k, v, x, gamma, False)
    with pytest.raises(ValueError):
        KA.attend(q, k.cpu(), v, x, gamma, False)
    with pytest.raises(ValueError):
        KA.attend(q[:, :4], k, v, x, gamma, False)
    with pytest.raises(ValueError):
        KA.attend(q.half(), k, v, x, gamma, True)


@pytest.mark.parametrize("k", [64, 1000, 4096, 8192])
def test_nms_keep_matches_plain_and_greedy(cuda, k):
    rng = np.random.default_rng(k)
    c = rng.uniform(0, 300, (2, 8, 2))
    xy = np.take_along_axis(c, rng.integers(0, 8, (2, k))[..., None], 1) \
        + rng.normal(0, 6, (2, k, 2))
    wh = rng.uniform(10, 50, (2, k, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1)
    boxes[:, 1::7] = boxes[:, 0::7][:, : boxes[:, 1::7].shape[1]]
    boxes[:, 0::7, 2:] = boxes[:, 0::7, :2]              # zero-area dups
    b = torch.as_tensor(boxes, dtype=torch.float32, device=cuda)
    v = torch.as_tensor(rng.uniform(size=(2, k)) < 0.9, device=cuda)
    keep = KN.nms_keep(b, v, 0.45)
    assert torch.equal(keep, KN.nms_keep_plain(b, v, 0.45))
    if k <= 1000:
        assert torch.equal(keep.cpu(), TN._greedy_keep(b.cpu(), v.cpu(), 0.45))


def _nms_case(name, k, b, seed):
    """(boxes, valid, thr) of one degenerate or ragged NMS case."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 600, (b, 16, 2))
    xy = np.take_along_axis(c, rng.integers(0, 16, (b, k))[..., None], 1) \
        + rng.normal(0, 6, (b, k, 2))
    wh = rng.uniform(10, 60, (b, k, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1)
    valid = rng.uniform(size=(b, k)) < 0.9
    thr = 0.45
    if name == "identical":                  # one kept an image
        boxes = np.tile([10.0, 20.0, 50.0, 70.0], (b, k, 1))
        valid = np.ones((b, k), bool)
    elif name == "disjoint":                 # all kept
        g = np.arange(k, dtype=np.float64)[:, None] * 64.0
        boxes = np.tile(np.concatenate([g, g * 0, g + 32, g * 0 + 32], -1),
                        (b, 1, 1))
        valid = np.ones((b, k), bool)
    elif name == "no_valid":
        valid = np.zeros((b, k), bool)
    elif name == "zero_area_dups":           # NaN IoU suppresses
        boxes = boxes.copy()
        boxes[:, ::3, 2:] = boxes[:, ::3, :2]
        boxes[:, 1::3] = boxes[:, ::3][:, : boxes[:, 1::3].shape[1]]
    elif name == "iou_at_threshold":         # inter 128 / union 256 = thr
        xy = rng.integers(0, 75, (b, (k + 1) // 2, 2)) * 8.0
        boxes = np.empty((b, k, 4))
        for j, wd in ((0, 32.0), (1, 16.0)):
            boxes[:, j::2] = np.concatenate([xy, xy + [wd, 8.0]], -1)[
                :, : boxes[:, j::2].shape[1]]
        thr = 0.5
    return boxes, valid, thr


def test_nms_layout_matches_the_kernel(cuda):
    """The wrapper allocates the packed mask by ``mask_words``; the kernel
    addresses it by its own copy of the layout."""
    lib = KN._lib()
    for k in (1, 63, 64, 65, 1000, 1024, 4097, 8192):
        assert lib.nms_mask_words(k) == KN.mask_words(k)
        assert lib.nms_scan_smem(k) == KN.scan_smem(k)


@pytest.mark.parametrize("case", ["clustered", "identical", "disjoint",
                                  "no_valid", "zero_area_dups",
                                  "iou_at_threshold"])
@pytest.mark.parametrize("k,b", [(1, 8), (63, 8), (65, 3), (1000, 8),
                                 (4097, 2), (8192, 8)])
def test_nms_keep_tiles_ragged_and_degenerate(cuda, k, b, case):
    """K3's tiled scan at ragged K (a partial last tile, one tile, 129
    tiles) with up to 8 images, against the plain fixed point and, up to
    K = 1000, the greedy oracle; the mask kernel and the scan launched apart
    give the same keep set."""
    boxes, valid, thr = _nms_case(case, k, b, k + b)
    bx = torch.as_tensor(boxes, dtype=torch.float32, device=cuda)
    v = torch.as_tensor(valid, device=cuda)
    keep = KN.nms_keep(bx, v, thr)
    assert torch.equal(keep, KN.nms_keep_plain(bx, v, thr))
    if k <= 1000:
        assert torch.equal(keep.cpu(), TN._greedy_keep(bx.cpu(), v.cpu(), thr))
    if case == "identical":
        assert keep.sum(1).tolist() == [1] * b
    if case == "disjoint":
        assert bool(keep.all())
    mask_fn, scan_fn, kept = KN.nms_stages(bx, v, thr)
    mask_fn()
    scan_fn()
    assert torch.equal(kept.bool(), keep)
    assert torch.equal(KN.nms_keep(bx, v, thr), keep)


def _assert_q8_close(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if got.dtype == torch.int8:
        d = (got.int() - ref.int()).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-4
    else:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


def _qconv(rng, c_in, c_out, k, device):
    w = torch.from_numpy(rng.normal(0, 0.1, (c_out, c_in, k, k)).astype(
        np.float32))
    b = torch.from_numpy(rng.normal(0, 0.5, (c_out,)).astype(np.float32))
    return KC.QConv(w.to(device), b.to(device))


@pytest.mark.parametrize("stride,c_in,c_out,h,w,f32_in,out_scale", [
    (2, 3, 48, 64, 96, True, 0.03),        # the stem: f32 image, C 3 -> 4
    (1, 48, 48, 24, 40, False, 0.05),      # one 48-channel chunk
    (1, 24, 24, 16, 20, False, 0.05),      # O = 24 < one block of 32
    (1, 256, 256, 13, 21, False, None),    # 4 chunks, ragged tiles, f32 out
    (1, 128, 64, 16, 16, True, 0.02),      # f32 in, several chunks
    (2, 128, 64, 80, 80, False, 0.05),     # l33: int8 in, stride 2
    (2, 256, 128, 40, 40, False, None),    # l49's shape, f32 out
    (2, 24, 16, 13, 21, False, 0.05),      # odd sizes, stride 2
])
def test_conv3x3_q8_matches_plain(cuda, stride, c_in, c_out, h, w, f32_in,
                                  out_scale):
    rng = np.random.default_rng(c_in + h)
    qw = _qconv(rng, c_in, c_out, 3, cuda)
    if f32_in:
        x = torch.from_numpy(rng.uniform(-1, 1, (2, h, w, c_in)).astype(
            np.float32)).to(cuda)
    else:
        x = torch.from_numpy(rng.integers(-127, 128, (2, h, w, c_in)).astype(
            np.int8)).to(cuda)
    args = (qw, 0.01, stride, "silu", out_scale)
    got = KC.conv3x3_q8(x, *args)
    _assert_q8_close(got, KC.conv3x3_q8_plain(x, *args))


@pytest.mark.parametrize("secs,c_out,h,w,pool,out_scale", [
    ((48, 48, 48), 48, 16, 32, True, 0.04),     # DER cv1 with the MP
    ((256, 256, 256), 512, 8, 10, False, None),  # l7 cv1, the float exit
    ((48,), 24, 12, 20, False, 0.04),           # cv0_1
    ((24,), 48, 12, 20, False, 0.04),           # cv0_2: one 24 chunk
    ((128, 128, 128), 256, 10, 14, True, None),
    ((128, 128, 256), 256, 20, 20, False, 0.04),  # l50 cv: 3 sections
    ((128,), 18, 20, 20, False, None),            # the head: O = 18, f32
])
def test_conv1x1_q8_matches_plain(cuda, secs, c_out, h, w, pool, out_scale):
    rng = np.random.default_rng(sum(secs) + h)
    qw = _qconv(rng, sum(secs), c_out, 1, cuda)
    xs = [torch.from_numpy(rng.integers(-127, 128, (2, h, w, c)).astype(
        np.int8)).to(cuda) for c in secs]
    args = (qw, 1.0, "silu", out_scale, pool)
    got = KC.conv1x1_q8(xs, *args)
    _assert_q8_close(got, KC.conv1x1_q8_plain(xs, *args))
    if pool and out_scale is not None:
        unfused = KP.max_pool2_q8(KC.conv1x1_q8(xs, qw, 1.0, "silu",
                                                out_scale))
        assert torch.equal(got, unfused)


def _sections(rng, secs, b, h, w, dtype, device, offset=0):
    """int8 or float32 sections (b, h, w, c); int8 ones start ``offset``
    bytes into their storage."""
    out = []
    for c in secs:
        if dtype == torch.float32:
            out.append(torch.from_numpy(rng.uniform(-1, 1, (b, h, w, c)).astype(
                np.float32)).to(device))
            continue
        raw = torch.from_numpy(rng.integers(-127, 128, b * h * w * c + offset)
                               .astype(np.int8)).to(device)
        out.append(raw[offset:].view(b, h, w, c))
    return out


K5_TILES = list(KC.K5_TILES.items())


@pytest.mark.parametrize("tile", K5_TILES)
@pytest.mark.parametrize("out", [(0.04, torch.float32), (None, torch.float32),
                                 (None, torch.bfloat16)])
@pytest.mark.parametrize("secs,c_out,b,h,w,pool", [
    ((24,), 48, 2, 7, 9, False),          # H*W off 8, 8-byte staging
    ((48,), 24, 2, 20, 20, False),        # BN 24
    ((48, 48, 48), 48, 2, 16, 32, True),  # l1 cv1 with the MP
    ((48, 48, 48), 128, 2, 10, 14, True),  # l3 cv1 with the MP
    ((128,), 128, 1, 9, 11, False),       # BN 128, one 128-row tile
    ((128, 128, 128), 256, 4, 20, 20, False),  # l5 cv1
    ((256, 256, 256), 512, 2, 13, 7, False),   # l7 cv1: two N tiles
    ((24, 48), 256, 1, 6, 10, True),      # sections off 16 and on
    ((128, 128, 256), 512, 1, 5, 5, False),
    ((256,), 1024, 1, 3, 7, False),       # four N tiles
    ((256,), 18, 2, 9, 9, False),         # the head: O = 18
])
def test_conv1x1_q8_wgmma_tiles(cuda, monkeypatch, secs, c_out, b, h, w,
                               pool, out, tile):
    """K5 at each of its tiles (forced in place of ``k5_route``'s
    choice) over O 18 to 1024, 1-3 sections of 24-256 channels, with and
    without the pool, every exit, identical to its plain version (int8
    within the int8 kernels' rule)."""
    route = KC.k5_route
    monkeypatch.setattr(KC, "k5_route",
                        lambda *a, **k: (*tile, route(*a, **k)[2]))
    rng = np.random.default_rng(sum(secs) + c_out + h)
    qw = _qconv(rng, sum(secs), c_out, 1, cuda)
    xs = _sections(rng, secs, b, h, w, torch.int8, cuda)
    args = (qw, 1.0, "silu", out[0], pool, out[1])
    _q8_out_close(KC.conv1x1_q8(xs, *args), KC.conv1x1_q8_plain(xs, *args))


@pytest.mark.parametrize("secs,c_out,h,w,pool,out_scale", [
    ((24,), 48, 8, 8, True, 0.03),
    ((48, 16), 96, 6, 8, False, None),
    ((128, 128, 128), 256, 10, 14, False, 0.05),
    ((256,), 512, 7, 9, False, None),
])
def test_conv1x1_q8_wgmma_float_input(cuda, secs, c_out, h, w, pool,
                                      out_scale):
    """Float32 sections quantized at s_in while staged (through
    registers)."""
    rng = np.random.default_rng(sum(secs) + c_out)
    qw = _qconv(rng, sum(secs), c_out, 1, cuda)
    xs = _sections(rng, secs, 2, h, w, torch.float32, cuda)
    args = (qw, 0.01, "silu", out_scale, pool)
    _assert_q8_close(KC.conv1x1_q8(xs, *args), KC.conv1x1_q8_plain(xs, *args))


@pytest.mark.parametrize("secs,offset,vec", [((48,), 8, 8), ((64,), 4, 4),
                                             ((12, 20), 0, 4),
                                             ((24, 24), 0, 8)])
def test_conv1x1_q8_wgmma_staging_granule(cuda, secs, offset, vec):
    """Sections whose channels or addresses are off 16 bytes take 8- or
    4-byte copies."""
    rng = np.random.default_rng(offset + sum(secs))
    qw = _qconv(rng, sum(secs), 40, 1, cuda)
    xs = _sections(rng, secs, 2, 6, 7, torch.int8, cuda, offset)
    assert KC.k5_route([t.shape[-1] for t in xs], 40, 84, False,
                       [t.data_ptr() for t in xs])[2] == vec
    args = (qw, 1.0, "silu", 0.05)
    _assert_q8_close(KC.conv1x1_q8(xs, *args), KC.conv1x1_q8_plain(xs, *args))


@pytest.mark.parametrize("c_in,c_out", [(24, 48), (64, 128)])
def test_conv1x1_q8_wgmma_large_map(cuda, c_in, c_out):
    """A 160 x 160 map at batch 4 (a grid of hundreds of blocks, 256-row
    tiles at 48 channels); two calls identical."""
    rng = np.random.default_rng(c_out)
    qw = _qconv(rng, c_in, c_out, 1, cuda)
    xs = _sections(rng, (c_in,), 4, 160, 160, torch.int8, cuda)
    got = KC.conv1x1_q8(xs, qw, 1.0, "silu", 0.05)
    assert torch.equal(got, KC.conv1x1_q8(xs, qw, 1.0, "silu", 0.05))
    _assert_q8_close(got, KC.conv1x1_q8_plain(xs, qw, 1.0, "silu", 0.05))


K4_TILES = list(KC.K4_TILES.items())
# (B, H, W, C, O) of the flagship's stride-1 3x3s on int8 input at batch 4:
# the DER blocks' st1-st3 / st4-st6 at 320 / 160 / 80 / 40 px, and the
# neck's (SPPCSPC, GSConv, RepConv) at 80 / 40 / 20 px
K4_FLAGSHIP = [(4, 320, 320, 48, 48), (4, 320, 320, 24, 24),
               (4, 160, 160, 48, 48), (4, 160, 160, 24, 24),
               (4, 80, 80, 128, 128), (4, 80, 80, 64, 64),
               (4, 40, 40, 256, 256), (4, 40, 40, 128, 128),
               (4, 20, 20, 512, 512), (4, 40, 40, 128, 64),
               (4, 80, 80, 64, 32), (4, 20, 20, 256, 128),
               (4, 80, 80, 128, 256), (4, 40, 40, 256, 512),
               (4, 20, 20, 512, 1024)]
# (out_scale, out_dtype, act): the three output types and activations
K4_OUTS = [(0.05, torch.float32, "silu"), (None, torch.float32, "relu"),
           (None, torch.bfloat16, None)]


def _force_k4_tile(monkeypatch, tile):
    """``k4_route`` with the wgmma tile ``tile`` (and its row width) in
    place of the chosen one on every wgmma route; dp4a unchanged."""
    route = KC.k4_route

    def forced(C, O, B, H, W, stride, dtype, addr=0):
        r = route(C, O, B, H, W, stride, dtype, addr)
        if r[0] == "dp4a":
            return r
        ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
        return (r[0], *tile, r[3], KC.k4_width(ho, wo, 128 * tile[1],
                                               stride)[0])
    monkeypatch.setattr(KC, "k4_route", forced)


def _k4_equal(x, qw, out, stride=1, route="wgmma"):
    """One K4 call on ``route``, bit for bit its plain version."""
    out_scale, out_dtype, act = out
    before = dict(KC.LAUNCHES_K4_ROUTE)
    got = KC.conv3x3_q8(x, qw, 0.01, stride, act, out_scale, out_dtype)
    assert KC.LAUNCHES_K4_ROUTE == {**before, route: before[route] + 1}
    ref = KC.conv3x3_q8_plain(x, qw, 0.01, stride, act, out_scale, out_dtype)
    assert got.dtype == ref.dtype and torch.equal(got, ref)


@pytest.mark.parametrize("tile", K4_TILES)
@pytest.mark.parametrize("shape", K4_FLAGSHIP)
def test_conv3x3_q8_wgmma_flagship_shapes(cuda, monkeypatch, shape, tile):
    """K4 on the int8 tensor cores at each tile (forced in place of
    ``k4_route``'s choice) and every stride-1 int8 shape of the flagship's
    served forward, the three outputs: bit for bit the plain version."""
    _force_k4_tile(monkeypatch, tile)
    B, H, W, C, O = shape
    rng = np.random.default_rng(C + O + H)
    qw = _qconv(rng, C, O, 3, cuda)
    x = _sections(rng, (C,), B, H, W, torch.int8, cuda)[0]
    for out in K4_OUTS:
        _k4_equal(x, qw, out)


@pytest.mark.parametrize("tile", K4_TILES)
@pytest.mark.parametrize("shape", [
    (2, 7, 9, 24, 48),          # a map smaller than a tile, VEC 8
    (1, 13, 21, 48, 24),        # ragged H and W
    (3, 11, 30, 96, 200),       # O off the tiles, three chunks
    (1, 5, 5, 4, 16),           # C = 4: VEC 4, one partial group
    (2, 9, 11, 40, 64),         # C = 40: a partial chunk, VEC 8
    (1, 3, 1, 16, 8),           # a single column
])
@pytest.mark.parametrize("act", ["silu", "relu", None])
def test_conv3x3_q8_wgmma_ragged(cuda, monkeypatch, shape, tile, act):
    """Ragged maps and channel counts at each tile, every output type with
    each activation: bit for bit the plain version."""
    _force_k4_tile(monkeypatch, tile)
    B, H, W, C, O = shape
    rng = np.random.default_rng(C + O + H + W)
    qw = _qconv(rng, C, O, 3, cuda)
    x = _sections(rng, (C,), B, H, W, torch.int8, cuda)[0]
    for out_scale, out_dtype, _ in K4_OUTS:
        _k4_equal(x, qw, (out_scale, out_dtype, act))


def test_conv3x3_q8_wgmma_large_map_repeats(cuda):
    """A 320 x 320 map at batch 8: two calls identical, and the plain
    version."""
    rng = np.random.default_rng(21)
    qw = _qconv(rng, 48, 48, 3, cuda)
    x = _sections(rng, (48,), 8, 320, 320, torch.int8, cuda)[0]
    got = KC.conv3x3_q8(x, qw, 0.01, 1, "silu", 0.05)
    assert torch.equal(got, KC.conv3x3_q8(x, qw, 0.01, 1, "silu", 0.05))
    assert torch.equal(got, KC.conv3x3_q8_plain(x, qw, 0.01, 1, "silu",
                                                0.05))


def test_conv3x3_q8_wgmma_unaligned_input(cuda):
    """An int8 map 4 bytes into its storage stages by 4-byte copies."""
    rng = np.random.default_rng(22)
    qw = _qconv(rng, 64, 64, 3, cuda)
    x = _sections(rng, (64,), 2, 12, 17, torch.int8, cuda, offset=4)[0]
    assert KC.k4_route(64, 64, 2, 12, 17, 1, torch.int8,
                       x.data_ptr())[3] == 4
    _k4_equal(x, qw, K4_OUTS[0])


K4_S2_TILES = list(KC.K4_S2_TILES.items())
# (B, H, W, C, O) of the flagship's stride-2 3x3s on int8 input at batch 4:
# the PAN's two GSConv downsamples (l33 at 80 px, l49 at 40 px)
K4_S2_FLAGSHIP = [(4, 80, 80, 128, 64), (4, 40, 40, 256, 128)]
# (B, H, W, C, O) of xla_q8's float32 st1s at batch 4 (320 / 160 / 80 /
# 40 px)
K4_F32_FLAGSHIP = [(4, 320, 320, 48, 48), (4, 160, 160, 48, 48),
                   (4, 80, 80, 128, 128), (4, 40, 40, 256, 256)]
K4_RAGGED = [
    (2, 7, 9, 24, 48),          # odd H and W, a map smaller than a tile
    (1, 13, 21, 48, 24),        # ragged H and W
    (3, 11, 30, 96, 200),       # O off the tiles, three chunks
    (1, 5, 5, 4, 16),           # C = 4: one partial group
    (2, 9, 11, 40, 64),         # C = 40: a partial chunk
    (1, 3, 1, 16, 8),           # a single column
    (1, 30, 111, 160, 40),      # several tiles across, five chunks
]


@pytest.mark.parametrize("tile", K4_S2_TILES)
@pytest.mark.parametrize("shape", K4_S2_FLAGSHIP)
def test_conv3x3_q8_wgmma_s2_flagship_shapes(cuda, monkeypatch, shape, tile):
    """K4 at stride 2 on int8 input (route wgmma_s2) at each tile and the
    flagship's two stride-2 shapes, the three outputs: bit for bit."""
    _force_k4_tile(monkeypatch, tile)
    B, H, W, C, O = shape
    rng = np.random.default_rng(C + O + H + 2)
    qw = _qconv(rng, C, O, 3, cuda)
    x = _sections(rng, (C,), B, H, W, torch.int8, cuda)[0]
    for out in K4_OUTS:
        _k4_equal(x, qw, out, 2, "wgmma_s2")


@pytest.mark.parametrize("tile", K4_S2_TILES)
@pytest.mark.parametrize("shape", K4_RAGGED)
@pytest.mark.parametrize("act", ["silu", "relu", None])
def test_conv3x3_q8_wgmma_s2_ragged(cuda, monkeypatch, shape, tile, act):
    """Stride 2 on ragged and odd maps (the bottom / right pad) at each
    tile, every output type with each activation: bit for bit."""
    _force_k4_tile(monkeypatch, tile)
    B, H, W, C, O = shape
    rng = np.random.default_rng(C + O + H + W + 2)
    qw = _qconv(rng, C, O, 3, cuda)
    x = _sections(rng, (C,), B, H, W, torch.int8, cuda)[0]
    for out_scale, out_dtype, _ in K4_OUTS:
        _k4_equal(x, qw, (out_scale, out_dtype, act), 2, "wgmma_s2")


@pytest.mark.parametrize("tile", K4_TILES)
@pytest.mark.parametrize("shape", K4_F32_FLAGSHIP)
def test_conv3x3_q8_wgmma_f32_flagship_shapes(cuda, monkeypatch, shape, tile):
    """K4 at stride 1 on float32 input (route wgmma_f32, quantized while
    staging) at each tile and xla_q8's four st1 shapes: bit for bit."""
    _force_k4_tile(monkeypatch, tile)
    B, H, W, C, O = shape
    rng = np.random.default_rng(C + O + H + 3)
    qw = _qconv(rng, C, O, 3, cuda)
    x = _sections(rng, (C,), B, H, W, torch.float32, cuda)[0]
    for out in K4_OUTS:
        _k4_equal(x, qw, out, 1, "wgmma_f32")


@pytest.mark.parametrize("tile", K4_TILES)
@pytest.mark.parametrize("shape", K4_RAGGED)
@pytest.mark.parametrize("act", ["silu", "relu", None])
def test_conv3x3_q8_wgmma_f32_ragged(cuda, monkeypatch, shape, tile, act):
    """Float32 input on ragged maps and channel counts at each tile, every
    output type with each activation: bit for bit."""
    _force_k4_tile(monkeypatch, tile)
    B, H, W, C, O = shape
    rng = np.random.default_rng(C + O + H + W + 3)
    qw = _qconv(rng, C, O, 3, cuda)
    x = _sections(rng, (C,), B, H, W, torch.float32, cuda)[0]
    for out_scale, out_dtype, _ in K4_OUTS:
        _k4_equal(x, qw, (out_scale, out_dtype, act), 1, "wgmma_f32")


@pytest.mark.parametrize("stride,dtype", [(2, torch.int8),
                                          (1, torch.float32)])
def test_conv3x3_q8_wgmma_s2_f32_repeat(cuda, stride, dtype):
    """The new routes at the largest flagship map, batch 8: two calls
    identical, and the plain version."""
    rng = np.random.default_rng(24)
    C, O, H = (128, 64, 80) if stride == 2 else (48, 48, 320)
    qw = _qconv(rng, C, O, 3, cuda)
    x = _sections(rng, (C,), 8, H, H, dtype, cuda)[0]
    assert KC.k4_route(C, O, 8, H, H, stride, dtype, x.data_ptr())[0] == (
        "wgmma_s2" if stride == 2 else "wgmma_f32")
    got = KC.conv3x3_q8(x, qw, 0.01, stride, "silu", 0.05)
    assert torch.equal(got, KC.conv3x3_q8(x, qw, 0.01, stride, "silu", 0.05))
    assert torch.equal(got, KC.conv3x3_q8_plain(x, qw, 0.01, stride, "silu",
                                                0.05))


@pytest.mark.parametrize("case", ["stem", "float32_unaligned", "dense5x5"])
def test_k4_other_calls_stay_on_dp4a(cuda, case):
    """The float32 stem (C = 3, stride 2), a float32 map 8 bytes into its
    storage (the float32 route needs 16-byte staging loads) and a float32
    dense 5x5 whose C is not a multiple of 4 run the dp4a kernel, bit for
    bit their plain versions."""
    rng = np.random.default_rng(23)
    reset_launch_counts()
    if case == "dense5x5":
        qw = _qconv(rng, 30, 32, 5, cuda)
        x = _sections(rng, (30,), 2, 20, 20, torch.float32, cuda)[0]
        got = KC.conv5x5_q8(x, qw, 0.01, "silu", 0.05)
        ref = KC.conv5x5_q8_plain(x, qw, 0.01, "silu", 0.05)
        assert launch_counts()["conv5x5_q8"] == 1
        assert KC.LAUNCHES_DENSE5_ROUTE == {"wgmma": 0, "wgmma_f32": 0,
                                            "dp4a": 1}
    else:
        if case == "stem":
            qw = _qconv(rng, 3, 48, 3, cuda)
            x = _sections(rng, (3,), 2, 64, 96, torch.float32, cuda)[0]
            stride = 2
        else:
            qw = _qconv(rng, 48, 64, 3, cuda)
            raw = _sections(rng, (48 * 40 * 40 * 2 + 2,), 1, 1, 1,
                            torch.float32, cuda)[0].reshape(-1)
            x = raw[2:].view(2, 40, 40, 48)
            assert x.data_ptr() % 16 == 8
            stride = 1
        got = KC.conv3x3_q8(x, qw, 0.01, stride, "silu", 0.05)
        ref = KC.conv3x3_q8_plain(x, qw, 0.01, stride, "silu", 0.05)
        assert KC.LAUNCHES_K4_ROUTE == {"wgmma": 0, "wgmma_s2": 0,
                                        "wgmma_f32": 0, "dp4a": 1}
    assert torch.equal(got, ref)


def test_conv1x1_q8_refuses_unaligned_float_sections(cuda):
    rng = np.random.default_rng(5)
    qw = _qconv(rng, 8, 16, 1, cuda)
    x = torch.zeros(2 * 4 * 4 * 8 + 1, device=cuda)[1:].view(2, 4, 4, 8)
    with pytest.raises(ValueError):
        KC.conv1x1_q8([x], qw, 0.01)


def _int8_view(shape, seed, device, offset=0):
    """A seeded int8 map; ``offset`` > 0: a contiguous view that many bytes
    into a buffer (off 16 bytes: the kernels' word route)."""
    n = int(np.prod(shape))
    x = torch.from_numpy(np.random.default_rng(seed).integers(
        -128, 128, shape).astype(np.int8)).to(device)
    if not offset:
        return x
    buf = torch.zeros(n + offset, dtype=torch.int8, device=device)
    buf[offset:] = x.reshape(-1)
    return buf[offset:].view(shape)


# K6's three served calls (batch 4 at 640 px), a batch-2 l6, ragged maps,
# C off 16 (words), a map of more vectors a pixel than lanes
K6_CARD_SHAPES = [(2, 80, 80, 256), (3, 10, 14, 4), (2, 6, 8, 8),
                  (4, 80, 80, 256), (4, 80, 80, 128), (4, 40, 40, 256),
                  (1, 2, 2, 4), (2, 4, 6, 12), (1, 6, 4, 1024),
                  (1, 2, 130, 8)]


@pytest.mark.parametrize("offset", [0, 4])
@pytest.mark.parametrize("shape", K6_CARD_SHAPES)
def test_max_pool2_q8_matches_plain(cuda, shape, offset):
    x = _int8_view(shape, 0, cuda, offset)
    y = KP.max_pool2_q8(x)
    assert torch.equal(y, KP.max_pool2_q8_plain(x))
    assert torch.equal(KP.max_pool2_q8(x), y)        # a second call


def test_max_pool2_q8_launch_dims(cuda):
    """The grids the kernel picks: each served call one wave of at least a
    block an SM, whole warps, two output rows a thread; the word route on a
    map off 16 bytes."""
    want = {(4, 80, 80, 256): ((5, 20, 4), (16, 8, 1)),
            (4, 80, 80, 128): ((5, 20, 4), (8, 8, 1)),
            (4, 40, 40, 256): ((5, 10, 4), (16, 4, 1))}
    for shape, (grid, block) in want.items():
        assert KP.launch_dims(*shape) == (grid, block, 0)
    grid, block, _ = KP.launch_dims(4, 80, 80, 256, aligned16=False)
    assert block == (32, 8, 1) and grid == (5, 20, 4)
@pytest.mark.parametrize("c,h,w,act,out_scale", [
    (64, 80, 80, "silu", 0.03),     # l17's GSConv depthwise
    (128, 20, 20, None, 0.05),      # a GSBottleneck gs2, no activation
    (32, 40, 40, "silu", None),     # float exit
    (8, 13, 21, "silu", 0.02),      # fewer channels than a block, ragged
])
def test_dwconv5x5_q8_matches_plain(cuda, c, h, w, act, out_scale):
    rng = np.random.default_rng(c + h)
    wt = torch.from_numpy(rng.normal(0, 0.1, (c, 1, 5, 5)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.5, (c,)).astype(np.float32))
    qd = KNF.QDepthwise(wt.to(cuda), b.to(cuda),
                        torch.full((c,), 0.02, device=cuda))
    x = torch.from_numpy(rng.integers(-127, 128, (2, h, w, c)).astype(
        np.int8)).to(cuda)
    args = (qd, 1.0, act, out_scale)
    _assert_q8_close(KNF.dwconv5x5_q8(x, *args),
                     KNF.dwconv5x5_q8_plain(x, *args))


# (B, H, W, C), act, f32 out: the nine signatures of K7's 18 calls in a
# served int8 forward at 640 px, batch 4; then ragged H, W and C (C off 32,
# off 16: byte staging; a map smaller than the halo)
K7_SIGNATURES = [((4, 20, 20, 64), "silu", False),
                 ((4, 40, 40, 128), "silu", False),
                 ((4, 40, 40, 64), "silu", False),
                 ((4, 40, 40, 64), None, True),
                 ((4, 80, 80, 64), "silu", False),
                 ((4, 80, 80, 32), "silu", False),
                 ((4, 80, 80, 32), None, True),
                 ((4, 20, 20, 128), "silu", False),
                 ((4, 20, 20, 128), None, True),
                 ((3, 17, 23, 48), "silu", False),
                 ((2, 9, 41, 40), None, False),
                 ((2, 33, 7, 36), "silu", True),
                 ((1, 5, 3, 8), "silu", False)]


@pytest.mark.parametrize("shape,act,f32_out", K7_SIGNATURES)
def test_dwconv5x5_q8_signatures(cuda, shape, act, f32_out):
    """K7 at the flagship's served signatures and ragged ones against its
    plain version; a second call is identical."""
    b, h, w, c = shape
    rng = np.random.default_rng(b * h + w + c)
    wt = torch.from_numpy(rng.normal(0, 0.1, (c, 1, 5, 5)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.5, (c,)).astype(np.float32))
    qd = KNF.QDepthwise(wt.to(cuda), bias.to(cuda),
                        torch.full((c,), 0.02, device=cuda))
    x = torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8)).to(
        cuda)
    args = (qd, 0.7, act, None if f32_out else 0.03)
    got = KNF.dwconv5x5_q8(x, *args)
    _assert_q8_close(got, KNF.dwconv5x5_q8_plain(x, *args))
    assert torch.equal(KNF.dwconv5x5_q8(x, *args), got)


@pytest.mark.parametrize("c,h,w,act,out_scale", [
    (64, 80, 80, "silu", 0.03),     # the flagship's l17 depthwise
    (128, 20, 20, None, 0.05),      # a GSBottleneck gs2, no activation
    (32, 40, 40, "silu", None),     # float exit
    (12, 13, 21, "silu", 0.02),     # C not a multiple of 4, ragged tiles
])
def test_dwconv5x5_f32w_q8_matches_plain(cuda, c, h, w, act, out_scale):
    rng = np.random.default_rng(c + h + 1)
    wt = torch.from_numpy(rng.normal(0, 0.1, (c, 1, 5, 5)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.5, (c,)).astype(np.float32))
    qd = KNF.QDepthwiseF32(wt.to(cuda), b.to(cuda),
                           torch.full((c,), 0.02, device=cuda))
    x = torch.from_numpy(rng.integers(-127, 128, (2, h, w, c)).astype(
        np.int8)).to(cuda)
    _assert_q8_close(KNF.dwconv5x5_f32w_q8(x, qd, act, out_scale),
                     KNF.dwconv5x5_f32w_q8_plain(x, qd, act, out_scale))


@pytest.mark.parametrize("c,b,h,w,act,out_scale", [
    (64, 8, 80, 80, "silu", 0.03),     # l17, l32
    (32, 8, 80, 80, None, None),       # l24's gs2, float exit
    (128, 8, 40, 40, "silu", 0.05),    # l12, l48
    (64, 8, 40, 40, None, None),       # l14 / l40 gs2
    (128, 8, 20, 20, "silu", 0.05),    # l47, l49, l56
    (64, 8, 20, 20, "silu", 0.02),     # l10
    (48, 3, 17, 23, "silu", 0.04),     # odd H, W; C off 32, on 16
    (40, 2, 9, 41, None, 0.05),        # C off 16: byte staging
    (8, 1, 5, 3, "silu", None),        # a map smaller than the halo
])
def test_dwconv5x5_f32w_q8_shapes(cuda, c, b, h, w, act, out_scale):
    """K12 at the flagship's depthwise 5x5 shapes at evaluation's batch 8
    and at ragged ones, against its plain version; without SiLU the float
    sums are identical."""
    rng = np.random.default_rng(c + h + w)
    wt = torch.from_numpy(rng.normal(0, 0.1, (c, 1, 5, 5)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.5, (c,)).astype(np.float32))
    qd = KNF.QDepthwiseF32(wt.to(cuda), bias.to(cuda),
                           torch.full((c,), 0.02, device=cuda))
    x = torch.from_numpy(rng.integers(-127, 128, (b, h, w, c)).astype(
        np.int8)).to(cuda)
    got = KNF.dwconv5x5_f32w_q8(x, qd, act, out_scale)
    ref = KNF.dwconv5x5_f32w_q8_plain(x, qd, act, out_scale)
    _assert_q8_close(got, ref)
    if act is None and out_scale is None:
        assert torch.equal(got, ref)


def test_row3_route_on_the_card(cuda):
    """The train-form attention blocks in eval() take K2 by default on the
    card and agree with the einsum path; the train forward does not."""
    from rep_yolo_tpu_torch.nn.blocks import CCVA

    torch.manual_seed(0)
    blk = CCVA(64, 64).to(cuda).eval()
    with torch.no_grad():
        for m in blk.modules():
            if isinstance(m, AxialAttention):
                m.gamma.fill_(0.5)
        x = torch.randn(2, 64, 40, 40, device=cuda)
        reset_launch_counts()
        got = blk(x)
        counts = launch_counts()
        assert (counts["axial_attend_criss_cross"],
                counts["axial_attend_vertical"]) == (1, 1)
        for m in blk.modules():
            if isinstance(m, AxialAttention):
                m.fused = False
        torch.testing.assert_close(got, blk(x), **TOL)
    assert sum(launch_counts().values()) == 2
    blk.train()(x)
    assert sum(launch_counts().values()) == 2


# K8's served call, the tiny config's map, H or W in {1, 2, 5, 12, 13, 14},
# C off 16, a map wider than one tile's shared memory (column tiles)
K8_CARD_SHAPES = [(4, 20, 20, 512), (2, 7, 9, 8), (1, 40, 40, 64),
                  (2, 2, 2, 32), (1, 1, 5, 16), (2, 2, 13, 8), (1, 5, 1, 32),
                  (1, 12, 14, 16), (2, 13, 12, 12), (1, 14, 2, 64),
                  (8, 40, 40, 256), (1, 3, 600, 16)]


@pytest.mark.parametrize("offset", [0, 4])
@pytest.mark.parametrize("shape", K8_CARD_SHAPES)
def test_spp_pools_q8_matches_plain(cuda, shape, offset):
    x = _int8_view(shape, 1, cuda, offset)
    y = KNF.spp_pools_q8(x)
    assert torch.equal(y, KNF.spp_pools_q8_plain(x))
    assert torch.equal(KNF.spp_pools_q8(x), y)       # a second call


def test_spp_pools_q8_launch_dims(cuda):
    """The tile the kernel picks: 4 rows by 8 words at the served call, 320
    blocks (two an SM) within half an SM's shared memory; 4 words on a map
    of fewer; column tiles on a map too wide for one."""
    assert KNF.spp_launch_dims(4, 20, 20, 512) == ((16, 5, 4), (256, 1, 1),
                                                  25344)
    assert KNF.spp_launch_dims(2, 2, 2, 16)[0] == (1, 1, 2)
    grid, _, smem = KNF.spp_launch_dims(1, 3, 600, 16)
    assert grid == (1, 1, 4) and smem <= 232448 // 2


@pytest.mark.parametrize("fill", [-128, 127])
def test_spp_pools_q8_constant_and_border_maxima(cuda, fill):
    x = torch.full((2, 13, 14, 16), fill, dtype=torch.int8, device=cuda)
    assert bool((KNF.spp_pools_q8(x) == fill).all())
    for r, c in ((0, 0), (0, 13), (12, 0), (12, 13), (6, 0), (0, 7)):
        x.fill_(-128)
        x[1, r, c, 5] = 127
        assert torch.equal(KNF.spp_pools_q8(x), KNF.spp_pools_q8_plain(x))


def test_q8_wrappers_count_launches_and_refuse_bad_input(cuda):
    rng = np.random.default_rng(3)
    qw = _qconv(rng, 8, 8, 3, cuda)
    x = torch.zeros((1, 8, 8, 8), dtype=torch.int8, device=cuda)
    reset_launch_counts()
    y = KC.conv3x3_q8(x, qw, 0.01, out_scale=0.02)
    KP.max_pool2_q8(y)
    KC.conv1x1_q8([y], _qconv(rng, 8, 16, 1, cuda), 0.02)
    qd = KNF.QDepthwise(torch.zeros((8, 1, 5, 5), device=cuda),
                        torch.zeros(8, device=cuda))
    KNF.spp_pools_q8(KNF.dwconv5x5_q8(y, qd, out_scale=0.02))
    qf = KNF.QDepthwiseF32(torch.zeros((8, 1, 5, 5), device=cuda), None)
    KNF.dwconv5x5_f32w_q8(y, qf, None)
    counts = launch_counts()
    assert (counts["conv3x3_q8"], counts["conv1x1_q8"],
            counts["max_pool2_q8"], counts["dwconv5x5_q8"],
            counts["spp_pools_q8"], counts["dwconv5x5_f32w_q8"]) == \
        (1, 1, 1, 1, 1, 1)
    with pytest.raises(ValueError):                  # K12 takes int8 only
        KNF.dwconv5x5_f32w_q8(y.float(), qf)
    with pytest.raises(ValueError):                  # int8 C not 4k
        KC.conv3x3_q8(torch.zeros((1, 8, 8, 3), dtype=torch.int8,
                                  device=cuda), _qconv(rng, 3, 8, 3, cuda),
                      0.01)
    with pytest.raises(ValueError):                  # odd map for the pool
        KP.max_pool2_q8(torch.zeros((1, 5, 4, 4), dtype=torch.int8,
                                    device=cuda))


def test_pool_wrappers_refuse_maps_off_4_bytes(cuda):
    """K6 and K8 read words at least: a map that starts off a 4-byte
    boundary is refused, C % 4 too; no launch is counted."""
    reset_launch_counts()
    x = _int8_view((1, 4, 4, 8), 0, cuda, offset=1)
    with pytest.raises(ValueError):
        KP.max_pool2_q8(x)
    with pytest.raises(ValueError):
        KNF.spp_pools_q8(x)
    with pytest.raises(ValueError):
        KNF.spp_pools_q8(torch.zeros((1, 4, 4, 6), dtype=torch.int8,
                                     device=cuda))
    assert launch_counts()["max_pool2_q8"] == 0
    assert launch_counts()["spp_pools_q8"] == 0


# (B, H, W, C, O): the nine convs of a flagship train step at 640 px, batch
# 8, that the select-all route sends to K9, and odd shapes (H, W odd, so the
# 2x2 tiles of dY are padded; C and O off the 64 x 64 GEMM tiles; few tiles
# for the split-K)
WGRAD_SHAPES = [(8, 20, 20, 512, 512), (8, 40, 40, 128, 64),
                (8, 80, 80, 64, 32), (8, 20, 20, 256, 128),
                (8, 80, 80, 128, 256), (8, 40, 40, 256, 512),
                (8, 20, 20, 512, 1024), (3, 13, 21, 24, 40),
                (2, 9, 7, 70, 130), (1, 1, 3, 5, 3), (4, 33, 31, 100, 36)]


def _wgrad_close(got, ref):
    tol = 1e-4 * ref.abs() + 1e-4 * ref.abs().max()
    assert bool(((got - ref).abs() <= tol).all()), \
        float((got - ref).abs().max())


@pytest.mark.parametrize("shape", WGRAD_SHAPES)
def test_wgrad3x3_matches_plain(cuda, shape):
    B, H, W, C, O = shape
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn((B, C, H, W), generator=g).to(cuda)
    dy = torch.randn((B, O, H, W), generator=g).to(cuda)
    _wgrad_close(KW.wgrad3x3(x, dy), KW.wgrad3x3_plain(x, dy))


@pytest.mark.parametrize("shape", [(8, 80, 80, 64, 32), (3, 13, 21, 24, 40)])
def test_wgrad3x3_repeats_bit_for_bit(cuda, shape):
    """The split-K partials are added in a fixed order: two calls on the
    same inputs give the same dW."""
    B, H, W, C, O = shape
    g = torch.Generator().manual_seed(7)
    x = torch.randn((B, C, H, W), generator=g).to(cuda)
    dy = torch.randn((B, O, H, W), generator=g).to(cuda)
    assert torch.equal(KW.wgrad3x3(x, dy), KW.wgrad3x3(x, dy))


def test_conv3x3_wgrad_grads_match_autograd(cuda):
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 24, 13, 21), generator=g).to(cuda)
    w = (0.1 * torch.randn((40, 24, 3, 3), generator=g)).to(cuda)
    t = torch.randn((2, 40, 13, 21), generator=g).to(cuda)
    grads = []
    for fn in (KW.conv3x3_wgrad,
               lambda a, b: torch.nn.functional.conv2d(a, b, None, 1, 1)):
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        (fn(xa, wa) * t).sum().backward()
        grads.append((xa.grad, wa.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], **TOL)
    _wgrad_close(grads[0][1], grads[1][1])


def test_wgrad3x3_counts_launches_and_refuses_bad_input(cuda):
    reset_launch_counts()
    x = torch.zeros((1, 8, 6, 6), device=cuda)
    KW.wgrad3x3(x, torch.zeros((1, 4, 6, 6), device=cuda))
    assert launch_counts()["wgrad3x3"] == 1
    with pytest.raises(ValueError):                  # spatial mismatch
        KW.wgrad3x3(x, torch.zeros((1, 4, 5, 6), device=cuda))
    with pytest.raises(ValueError):                  # not float32
        KW.wgrad3x3(x.half(), torch.zeros((1, 4, 6, 6), device=cuda))


def bf16_close(got, ref, floor=1e-3):
    """Every element of a bfloat16 result at most one bfloat16 ulp (of the
    larger magnitude) from ``ref``, or within ``floor`` max|ref| of it."""
    g, r = got.float(), ref.float()
    _, e = torch.frexp(torch.maximum(g.abs(), r.abs()))
    ulp = torch.ldexp(torch.ones_like(g), e - 8)      # 8 significant bits
    d = (g - r).abs()
    bad = (d > ulp) & (d > floor * r.abs().max())
    assert not bool(bad.any()), \
        f"{int(bad.sum())} of {d.numel()} elements off; max {float(d.max())}"


def _cm_conv(c_in, c_out, k, seed, device):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((c_out, c_in, k, k), generator=g) / (c_in * k * k) ** 0.5
    return KCM.CMConv(w.to(device), (0.1 * torch.randn(c_out, generator=g))
                      .to(device))


def _cm_close(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if got.dtype == torch.bfloat16:
        bf16_close(got, ref)
    else:
        torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c_in,c_out,h,w,act", [
    (48, 48, 40, 40, "silu"), (24, 24, 13, 21, "silu"),
    (16, 40, 8, 16, None), (3, 8, 9, 7, "silu")])
def test_conv3x3_cmajor_matches_plain(cuda, dtype, c_in, c_out, h, w, act):
    torch.backends.cudnn.allow_tf32 = False
    cw = _cm_conv(c_in, c_out, 3, c_in + h, cuda)
    g = torch.Generator().manual_seed(w)
    x = torch.randn((2, c_in, h, w), generator=g).to(cuda, dtype)
    _cm_close(KCM.conv3x3_cmajor(x, cw, act),
              KCM.conv3x3_cmajor_plain(x, cw, act))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("secs,c_out,h,w,act", [
    ((48,), 24, 40, 40, "silu"), ((24, 24, 24), 40, 10, 14, "silu"),
    ((144,), 128, 16, 16, None), ((2, 30, 8), 520, 4, 6, "silu")])
def test_conv1x1_cmajor_matches_plain(cuda, dtype, secs, c_out, h, w, act):
    torch.backends.cudnn.allow_tf32 = False
    cw = _cm_conv(sum(secs), c_out, 1, c_out + h, cuda)
    g = torch.Generator().manual_seed(w)
    xs = [torch.randn((2, c, h, w), generator=g).to(cuda, dtype)
          for c in secs]
    _cm_close(KCM.conv1x1_cmajor(xs, cw, act),
              KCM.conv1x1_cmajor_plain(xs, cw, act))


def test_conv1x1_cmajor_odd_map_in_float32(cuda):
    torch.backends.cudnn.allow_tf32 = False
    cw = _cm_conv(5, 7, 1, 0, cuda)
    xs = [torch.randn((1, c, 5, 7), device=cuda) for c in (3, 2)]
    _cm_close(KCM.conv1x1_cmajor(xs, cw), KCM.conv1x1_cmajor_plain(xs, cw))


def test_cmajor_wrappers_count_launches_and_refuse_bad_input(cuda):
    cw3, cw1 = _cm_conv(8, 8, 3, 0, cuda), _cm_conv(8, 8, 1, 1, cuda)
    x = torch.zeros((1, 8, 6, 6), dtype=torch.bfloat16, device=cuda)
    reset_launch_counts()
    KCM.conv1x1_cmajor([KCM.conv3x3_cmajor(x, cw3)], cw1)
    counts = launch_counts()
    assert (counts["conv3x3_cmajor"], counts["conv1x1_cmajor"]) == (1, 1)
    with pytest.raises(ValueError):                  # float64
        KCM.conv3x3_cmajor(x.double(), cw3)
    with pytest.raises(ValueError):                  # not contiguous
        KCM.conv3x3_cmajor(x.transpose(2, 3), cw3)
    with pytest.raises(ValueError):                  # channels
        KCM.conv3x3_cmajor(x[:, :4].contiguous(), cw3)
    # odd bfloat16 sections (an odd H*W too) take the kernel's scalar loads
    xo = [x[:, :3, :5, :5].contiguous(), x[:, :5, :5, :5].contiguous() + 1]
    _cm_close(KCM.conv1x1_cmajor(xo, cw1), KCM.conv1x1_cmajor_plain(xo, cw1))
    with pytest.raises(ValueError):                  # 1x1 weights in K10
        KCM.conv3x3_cmajor(x, cw1)


# the wgmma kernels' tiles: output channels on and off the BN tiles (24,
# 48, 64, 128; 256 for the 1x1), input channels off the 16-channel chunks,
# maps not a multiple of the pixel tile, W not a multiple of 8 (scalar
# loads and stores), batches of 2 to 24
@pytest.mark.parametrize("c_in,c_out,h,w,batch", [
    (48, 24, 40, 40, 2), (40, 48, 20, 36, 2), (72, 130, 40, 40, 16),
    (256, 256, 40, 40, 16), (256, 256, 40, 40, 2), (24, 64, 33, 80, 24),
    (130, 256, 20, 36, 2)])
def test_conv3x3_cmajor_bf16_tiles(cuda, c_in, c_out, h, w, batch):
    cw = _cm_conv(c_in, c_out, 3, c_in + c_out, cuda)
    g = torch.Generator().manual_seed(h + w)
    x = torch.randn((batch, c_in, h, w), generator=g).to(cuda,
                                                         torch.bfloat16)
    _cm_close(KCM.conv3x3_cmajor(x, cw), KCM.conv3x3_cmajor_plain(x, cw))


@pytest.mark.parametrize("secs,c_out,h,w,batch", [
    ((24, 40, 16), 24, 40, 40, 2), ((48,), 48, 20, 36, 2),
    ((30, 2, 100), 130, 40, 40, 24), ((128, 64, 64), 256, 40, 40, 16),
    ((96, 96, 96), 512, 20, 36, 2), ((144,), 64, 17, 24, 2),
    ((144,), 64, 80, 80, 8)])
def test_conv1x1_cmajor_bf16_tiles(cuda, secs, c_out, h, w, batch):
    cw = _cm_conv(sum(secs), c_out, 1, c_out + h, cuda)
    g = torch.Generator().manual_seed(w)
    xs = [torch.randn((batch, c, h, w), generator=g).to(cuda, torch.bfloat16)
          for c in secs]
    _cm_close(KCM.conv1x1_cmajor(xs, cw), KCM.conv1x1_cmajor_plain(xs, cw))


def test_conv1x1_cmajor_bf16_l7_cv1_batch8(cuda):
    """DER l7's cv1 at 640 px: [x1, x4_1, x4_3] (3 x 256) -> 512 at 40 px,
    batch 8, two blocks of 256 output channels."""
    cw = _cm_conv(768, 512, 1, 11, cuda)
    g = torch.Generator().manual_seed(12)
    xs = [torch.randn((8, 256, 40, 40), generator=g).to(cuda, torch.bfloat16)
          for _ in range(3)]
    _cm_close(KCM.conv1x1_cmajor(xs, cw), KCM.conv1x1_cmajor_plain(xs, cw))


def test_cmajor_bf16_calls_repeat_bit_for_bit(cuda):
    """No atomics and a fixed order of sums: two calls are identical."""
    g = torch.Generator().manual_seed(13)
    cw3, cw1 = _cm_conv(48, 48, 3, 14, cuda), _cm_conv(144, 128, 1, 15, cuda)
    x = torch.randn((4, 48, 80, 80), generator=g).to(cuda, torch.bfloat16)
    xs = [x, x + 1, x - 1]
    assert torch.equal(KCM.conv3x3_cmajor(x, cw3), KCM.conv3x3_cmajor(x, cw3))
    assert torch.equal(KCM.conv1x1_cmajor(xs, cw1),
                       KCM.conv1x1_cmajor(xs, cw1))


# ---------------------------------------------------------------------------
# K13 / K14, conv5x5_q8, the pixel-major wrappers
# ---------------------------------------------------------------------------

def _q8_out_close(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if got.dtype == torch.bfloat16:
        bf16_close(got, ref, floor=0.0)
    else:
        _assert_q8_close(got, ref)


def _map(rng, shape, dtype, device):
    if dtype == torch.int8:
        a = rng.integers(-127, 128, shape).astype(np.int8)
        return torch.from_numpy(a).to(device)
    a = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
    return a.to(device=device, dtype=dtype)


def _cmq(rng, c_in, c_out, k, device):
    w = torch.from_numpy(rng.normal(0, 0.1, (c_out, c_in, k, k)).astype(
        np.float32))
    b = torch.from_numpy(rng.normal(0, 0.5, (c_out,)).astype(np.float32))
    return KCM.CMQConv(w.to(device), b.to(device))


@pytest.mark.parametrize("c_in,c_out,h,w,dtype,out_scale", [
    (48, 48, 24, 40, torch.bfloat16, None),   # l1 stages: C padded 48 -> 64
    (24, 24, 13, 21, torch.int8, 0.05),       # O = 24, ragged tiles
    (256, 256, 20, 20, torch.float32, None),  # 8 chunks
    (16, 32, 16, 64, torch.int8, None),       # int8 in, bf16 out
])
def test_conv3x3_cmajor_q8_matches_plain(cuda, c_in, c_out, h, w, dtype,
                                         out_scale):
    rng = np.random.default_rng(c_in + h)
    qw = _cmq(rng, c_in, c_out, 3, cuda)
    x = _map(rng, (2, c_in, h, w), dtype, cuda)
    args = (qw, 0.01, "silu", out_scale)
    _q8_out_close(KCM.conv3x3_cmajor_q8(x, *args),
                  KCM.conv3x3_cmajor_q8_plain(x, *args))


@pytest.mark.parametrize("secs,c_out,h,w,dtype,out_scale", [
    ((48, 48, 48), 48, 16, 32, torch.int8, 0.04),     # DER cv1, 3 sections
    ((48,), 24, 12, 20, torch.bfloat16, None),        # cv0_1
    ((768,), 512, 8, 10, torch.float32, 0.05),        # l7 cv1 width
    ((16, 8, 24), 24, 7, 9, torch.int8, None),        # odd H*W, odd splits
])
def test_conv1x1_cmajor_q8_matches_plain(cuda, secs, c_out, h, w, dtype,
                                         out_scale):
    rng = np.random.default_rng(sum(secs) + h)
    qw = _cmq(rng, sum(secs), c_out, 1, cuda)
    xs = [_map(rng, (2, c, h, w), dtype, cuda) for c in secs]
    args = (qw, 0.01, "relu" if dtype == torch.int8 else "silu", out_scale)
    _q8_out_close(KCM.conv1x1_cmajor_q8(xs, *args),
                  KCM.conv1x1_cmajor_q8_plain(xs, *args))


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("out_scale", [None, 0.05])
@pytest.mark.parametrize("secs,c_out,h,w", [
    ((20, 36, 44), 130, 16, 24),   # 2 M tiles of 128, the last 2 rows
    ((40, 12, 28), 24, 6, 6),      # 36 px: int8 / bf16 planes misaligned
    ((100,), 512, 20, 20),         # 4 M tiles, 4 chunks, the last 32 wide
    ((24, 8), 64, 17, 9),          # M tile 64, a ragged pixel tile
])
def test_conv1x1_cmajor_q8_tiles_and_staging(cuda, secs, c_out, h, w, dtype,
                                             out_scale):
    """K14's M tiles (64 / 128 output channels, rows past O masked), its
    16-byte staging (scalar where a plane is not 16-byte aligned) and its
    16-byte stores, against the plain version."""
    rng = np.random.default_rng(sum(secs) + c_out + h)
    qw = _cmq(rng, sum(secs), c_out, 1, cuda)
    xs = [_map(rng, (2, c, h, w), dtype, cuda) for c in secs]
    args = (qw, 0.01, "silu", out_scale)
    _q8_out_close(KCM.conv1x1_cmajor_q8(xs, *args),
                  KCM.conv1x1_cmajor_q8_plain(xs, *args))


def test_conv1x1_cmajor_q8_unaligned_section_start(cuda):
    """A section that starts 1 element into its storage takes the scalar
    staging; the result is the plain version's."""
    rng = np.random.default_rng(11)
    qw = _cmq(rng, 48, 40, 1, cuda)
    out = []
    for dtype in (torch.int8, torch.bfloat16, torch.float32):
        a = _map(rng, (2, 48, 8, 16), dtype, cuda)
        buf = torch.zeros(a.numel() + 1, dtype=dtype, device=cuda)
        buf[1:] = a.reshape(-1)
        xs = [buf[1:].view(a.shape)]
        assert xs[0].is_contiguous() and xs[0].data_ptr() % 16
        out.append((KCM.conv1x1_cmajor_q8(xs, qw, 0.01, "silu"),
                    KCM.conv1x1_cmajor_q8_plain(xs, qw, 0.01, "silu")))
    for got, ref in out:
        _q8_out_close(got, ref)


@pytest.mark.parametrize("c_in,c_out,h,w,out_scale,out_dtype", [
    (16, 24, 16, 16, None, torch.float32),
    (64, 64, 20, 20, 0.02, torch.float32),
    (32, 32, 8, 12, None, torch.bfloat16),
])
def test_conv5x5_q8_matches_plain(cuda, c_in, c_out, h, w, out_scale,
                                  out_dtype):
    rng = np.random.default_rng(c_in + h)
    qw = _qconv(rng, c_in, c_out, 5, cuda)
    x = _map(rng, (2, h, w, c_in), torch.int8, cuda)
    args = (qw, 0.01, "silu", out_scale, out_dtype)
    _q8_out_close(KC.conv5x5_q8(x, *args), KC.conv5x5_q8_plain(x, *args))


@pytest.mark.parametrize("c,h,w,act,out_scale", [(64, 80, 80, "silu", 0.02),
                                                 (128, 20, 20, None, None)])
def test_conv5x5_block_diagonal_equals_k7(cuda, c, h, w, act, out_scale):
    rng = np.random.default_rng(c)
    qd = KNF.QDepthwise(
        torch.from_numpy(rng.normal(0, 0.1, (c, 1, 5, 5)).astype(
            np.float32)).to(cuda),
        torch.from_numpy(rng.normal(0, 0.1, (c,)).astype(np.float32)).to(
            cuda))
    x = _map(rng, (2, h, w, c), torch.int8, cuda)
    got = KC.conv5x5_q8(x, KC.block_diagonal(qd), 1.0, act, out_scale)
    assert torch.equal(got, KNF.dwconv5x5_q8(x, qd, 1.0, act, out_scale))


# K13's tiles (BN, TW), forced in place of k13_route's choice: every BN at
# a narrow, a middle and a wide row
K13_TILES = [(24, 4), (48, 20), (64, 40), (128, 12), (128, 60)]
# (B, C, H, W, O): C off 32 (a partial chunk, a partial quad), O off 8,
# W off the tile and H * W * size off 16 bytes (4-byte or narrower staging
# loads), W off 4 (stores a value at a time), a single column
K13_AWKWARD = [(2, 40, 13, 21, 20), (1, 24, 16, 64, 48), (1, 16, 16, 64, 32),
               (1, 36, 11, 26, 50), (3, 70, 5, 7, 130), (1, 8, 3, 1, 8)]
K13_OUTS = [(None, "silu"), (0.05, "silu"), (None, None), (0.05, "relu")]


def _force_k13_tile(monkeypatch, tile):
    route = KCM.k13_route

    def forced(C, O, B, H, W, dtype):
        route(C, O, B, H, W, dtype)
        return "wgmma", tile[0], 2, tile[1]
    monkeypatch.setattr(KCM, "k13_route", forced)


@pytest.mark.parametrize("tile", K13_TILES)
@pytest.mark.parametrize("shape", K13_AWKWARD)
@pytest.mark.parametrize("dtype", [torch.int8, torch.float32,
                                   torch.bfloat16])
def test_conv3x3_cmajor_q8_wgmma_tiles(cuda, monkeypatch, shape, tile, dtype):
    """K13 on the int8 wgmma core at each tile (forced) on awkward maps and
    channel counts, int8 / float32 / bfloat16 input to bfloat16 and int8
    output: bit for bit the plain version."""
    _force_k13_tile(monkeypatch, tile)
    B, C, H, W, O = shape
    rng = np.random.default_rng(C + O + H + W)
    qw = _cmq(rng, C, O, 3, cuda)
    x = _map(rng, (B, C, H, W), dtype, cuda)
    for out_scale, act in K13_OUTS:
        args = (qw, 0.01, act, out_scale)
        got = KCM.conv3x3_cmajor_q8(x, *args)
        ref = KCM.conv3x3_cmajor_q8_plain(x, *args)
        assert got.dtype == ref.dtype and torch.equal(got, ref), \
            (out_scale, act)


@pytest.mark.parametrize("dtype,offset", [(torch.int8, 1), (torch.int8, 4),
                                          (torch.bfloat16, 1),
                                          (torch.float32, 1),
                                          (torch.float32, 2)])
def test_conv3x3_cmajor_q8_unaligned_input(cuda, dtype, offset):
    """A map ``offset`` elements into its storage stages by narrower loads;
    bit for bit the plain version, and two calls identical."""
    rng = np.random.default_rng(31 + offset)
    qw = _cmq(rng, 24, 40, 3, cuda)
    a = _map(rng, (2, 24, 9, 32), dtype, cuda)
    buf = torch.zeros(a.numel() + offset, dtype=dtype, device=cuda)
    buf[offset:] = a.reshape(-1)
    x = buf[offset:].view(a.shape)
    assert x.data_ptr() % 16
    got = KCM.conv3x3_cmajor_q8(x, qw, 0.01, "silu", 0.05)
    assert torch.equal(got, KCM.conv3x3_cmajor_q8_plain(x, qw, 0.01, "silu",
                                                        0.05))
    assert torch.equal(got, KCM.conv3x3_cmajor_q8(x, qw, 0.01, "silu", 0.05))


def test_conv3x3_cmajor_q8_kernel_bench_shapes(cuda):
    """K13 on k13_route's tiles at kernel_bench's 3x3 shapes, batch 2,
    bfloat16 in and out and int8 in and out: bit for bit the plain
    version."""
    from rep_yolo_tpu_torch.tools.kernel_bench import SHAPES
    for k, C, O, H in SHAPES:
        if k != 3:
            continue
        rng = np.random.default_rng(C + O + H)
        qw = _cmq(rng, C, O, 3, cuda)
        x = _map(rng, (2, C, H, H), torch.bfloat16, cuda)
        for xi, o in ((x, None), (x.float().mul(100).round().clamp(
                -127, 127).to(torch.int8), 0.05)):
            got = KCM.conv3x3_cmajor_q8(xi, qw, 0.01, "silu", o)
            ref = KCM.conv3x3_cmajor_q8_plain(xi, qw, 0.01, "silu", o)
            assert torch.equal(got, ref), (C, O, H, xi.dtype)


DENSE5_TILES = [(24, 4), (48, 20), (64, 12), (64, 60)]
# (B, H, W, C, O): C off 32 and off 16, O off 8, ragged maps, a map
# smaller than a tile, a single column
DENSE5_AWKWARD = [(2, 9, 13, 40, 20), (1, 20, 20, 32, 32), (1, 7, 30, 20, 64),
                  (1, 12, 9, 64, 70), (2, 5, 5, 4, 8), (1, 6, 1, 16, 24)]
DENSE5_OUTS = [(None, torch.float32, "silu"), (0.05, torch.float32, "silu"),
               (None, torch.bfloat16, None), (None, torch.float32, "relu")]


def _force_dense5_tile(monkeypatch, tile):
    route = KC.dense5_route

    def forced(C, O, B, H, W, dtype, addr=0):
        r = route(C, O, B, H, W, dtype, addr)
        return r if r[0] == "dp4a" else (r[0], tile[0], 2, r[3], tile[1])
    monkeypatch.setattr(KC, "dense5_route", forced)


@pytest.mark.parametrize("tile", DENSE5_TILES)
@pytest.mark.parametrize("shape", DENSE5_AWKWARD)
@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
def test_conv5x5_q8_wgmma_tiles(cuda, monkeypatch, shape, tile, dtype):
    """The dense 5x5 on the wgmma core with 25 taps at each tile (forced),
    int8 input (route wgmma) and float32 input (wgmma_f32), every output
    type: bit for bit the plain version."""
    _force_dense5_tile(monkeypatch, tile)
    B, H, W, C, O = shape
    rng = np.random.default_rng(C + O + H + W + 5)
    qw = _qconv(rng, C, O, 5, cuda)
    x = _sections(rng, (C,), B, H, W, dtype, cuda)[0]
    route = "wgmma" if dtype == torch.int8 else "wgmma_f32"
    for out_scale, out_dtype, act in DENSE5_OUTS:
        before = dict(KC.LAUNCHES_DENSE5_ROUTE)
        args = (qw, 0.01, act, out_scale, out_dtype)
        got = KC.conv5x5_q8(x, *args)
        assert KC.LAUNCHES_DENSE5_ROUTE == {**before,
                                            route: before[route] + 1}
        ref = KC.conv5x5_q8_plain(x, *args)
        assert got.dtype == ref.dtype and torch.equal(got, ref)


@pytest.mark.parametrize("shape,act,f32_out", [
    (s, a, f) for s, a, f in [((4, 20, 20, 64), "silu", False),
                              ((4, 40, 40, 128), "silu", False),
                              ((4, 80, 80, 64), "silu", False),
                              ((4, 80, 80, 32), None, True),
                              ((4, 20, 20, 128), None, True)]])
def test_conv5x5_block_diagonal_flagship_signatures(cuda, shape, act,
                                                    f32_out):
    """The block-diagonal dense 5x5 at the served depthwise signatures, on
    the wgmma route: identical to K7 and to its plain version."""
    B, H, W, C = shape
    rng = np.random.default_rng(C + H)
    qd = KNF.QDepthwise(
        torch.from_numpy(rng.normal(0, 0.1, (C, 1, 5, 5)).astype(
            np.float32)).to(cuda),
        torch.from_numpy(rng.normal(0, 0.1, (C,)).astype(np.float32)).to(
            cuda))
    x = _map(rng, shape, torch.int8, cuda)
    out_scale = None if f32_out else 0.05
    bd = KC.block_diagonal(qd)
    reset_launch_counts()
    got = KC.conv5x5_q8(x, bd, 0.7, act, out_scale)
    assert KC.LAUNCHES_DENSE5_ROUTE["wgmma"] == 1
    assert torch.equal(got, KNF.dwconv5x5_q8(x, qd, 0.7, act, out_scale))
    assert torch.equal(got, KC.conv5x5_q8_plain(x, bd, 0.7, act, out_scale))


@pytest.mark.parametrize("b,c,o,h,w,dtype,act,out_scale", [
    (2, 16, 24, 16, 64, torch.bfloat16, "silu", None),
    (1, 48, 48, 40, 40, torch.float32, "relu", 0.05),
    (2, 24, 24, 13, 21, torch.int8, "silu", None),
])
def test_conv3x3_pm_q8_matches_plain(cuda, b, c, o, h, w, dtype, act,
                                     out_scale):
    rng = np.random.default_rng(c + h)
    qw = _qconv(rng, c, o, 3, cuda)
    x = _map(rng, (b, h * w, c), dtype, cuda)
    args = (qw, 0.01, h, w, act, out_scale)
    got = KPM.conv3x3_pm_q8(x, *args)
    assert got.shape == (b, h * w, o)
    _q8_out_close(got, KPM.conv3x3_pm_q8_plain(x, *args))


@pytest.mark.parametrize("secs,o,hw,dtype,act,out_scale", [
    ((16, 16, 16), 24, 1024, torch.float32, "relu", None),
    ((48, 48, 48), 48, 1600, torch.int8, "silu", None),      # DER cv1
    ((24,), 48, 999, torch.bfloat16, "silu", 0.03),
])
def test_conv1x1_pm_q8_matches_plain(cuda, secs, o, hw, dtype, act,
                                     out_scale):
    rng = np.random.default_rng(sum(secs) + hw)
    qw = _qconv(rng, sum(secs), o, 1, cuda)
    xs = [_map(rng, (2, hw, c), dtype, cuda) for c in secs]
    args = (qw, 0.01, act, out_scale)
    _q8_out_close(KPM.conv1x1_pm_q8(xs, *args),
                  KPM.conv1x1_pm_q8_plain(xs, *args))


def test_q8_rest_wrappers_count_launches_and_refuse_bad_input(cuda):
    rng = np.random.default_rng(5)
    q3, q1 = _cmq(rng, 8, 8, 3, cuda), _cmq(rng, 8, 8, 1, cuda)
    x = torch.zeros((1, 8, 6, 6), dtype=torch.int8, device=cuda)
    xn = torch.zeros((1, 6, 6, 8), dtype=torch.int8, device=cuda)
    reset_launch_counts()
    KCM.conv1x1_cmajor_q8([KCM.conv3x3_cmajor_q8(x, q3, 0.01, out_scale=0.02)],
                          q1, 0.02)
    KC.conv5x5_q8(xn, _qconv(rng, 8, 8, 5, cuda), 0.01)
    y = KPM.conv3x3_pm_q8(xn.reshape(1, 36, 8), _qconv(rng, 8, 8, 3, cuda),
                          0.01, 6, 6)
    KPM.conv1x1_pm_q8([y], _qconv(rng, 8, 8, 1, cuda), 0.01)
    counts = launch_counts()
    assert (counts["conv3x3_cmajor_q8"], counts["conv1x1_cmajor_q8"],
            counts["conv5x5_q8"], counts["conv3x3_pm_q8"],
            counts["conv1x1_pm_q8"], counts["conv3x3_q8"],
            counts["conv1x1_q8"]) == (1, 1, 1, 1, 1, 1, 1)
    with pytest.raises(ValueError):                  # float64
        KCM.conv3x3_cmajor_q8(x.double(), q3, 0.01)
    with pytest.raises(ValueError):                  # not contiguous
        KCM.conv3x3_cmajor_q8(x.transpose(2, 3), q3, 0.01)
    with pytest.raises(ValueError):                  # 1x1 weights in K13
        KCM.conv3x3_cmajor_q8(x, q1, 0.01)
    with pytest.raises(ValueError):                  # mixed section dtypes
        KCM.conv1x1_cmajor_q8([x[:, :4].contiguous(),
                               x[:, 4:].float().contiguous()], q1, 0.01)
    with pytest.raises(ValueError):                  # 3x3 weights in K4-5x5
        KC.conv5x5_q8(xn, _qconv(rng, 8, 8, 3, cuda), 0.01)
    with pytest.raises(ValueError):                  # H * W mismatch
        KPM.conv3x3_pm_q8(xn.reshape(1, 36, 8), _qconv(rng, 8, 8, 3, cuda),
                          0.01, 6, 5)
    with pytest.raises(ValueError):                  # f32 sections C % 4
        KC.conv1x1_q8([torch.zeros((1, 6, 6, 6), device=cuda)],
                      _qconv(rng, 6, 8, 1, cuda), 0.01)


def test_augment_batch_a2b_cuda_matches_cpu(cuda):
    """Train-time augmentation with mosaic-9, paste-in and cutout forced on
    (0.5, 0.5, 0.3, the JAX slow test's values) on the flagship's input,
    640 px at batch 8, on the card against the CPU from one CPU
    generator's draws, at the seed ``chip_smoke.branch_draws`` picks (every
    branch taken, paste-in from a slot that holds a label): masks
    identical, labels within 1e-5, images within 4 float32 ulps of a 640-px
    mosaic-9 canvas coordinate times HSV's largest value gain."""
    import importlib.util
    import pathlib

    from rep_yolo_tpu_torch.data import augment as A
    from rep_yolo_tpu_torch.data.datasets import Loader, make_synthetic_dataset

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    size, batch = 640, 8
    ds = make_synthetic_dataset(batch, size, seed=0)
    b = next(iter(Loader(ds, batch, seed=0).epoch(0)))
    inputs = [torch.from_numpy(b[k]) for k in ("images", "hw", "labels",
                                                "mask")]
    cfg = A.AugmentConfig(img_size=size, mosaic9=0.5, paste_in=0.5,
                          cutout=0.3, max_labels=inputs[2].shape[1])
    _, d, taken = smoke.branch_draws(torch, A, cfg, inputs[3])
    assert set(taken) == {"mosaic9", "mosaic4", "paste_in", "cutout"}
    got = A.augment_batch(*(x.to(cuda) for x in inputs),
                          A.Draws(*(f.to(cuda) for f in d)), cfg)
    ref = A.augment_batch(*inputs, d, cfg)
    assert got.images.device.type == "cuda"
    assert torch.equal(got.mask.cpu(), ref.mask) and bool(ref.mask.any())
    assert float((got.labels.cpu() - ref.labels).abs().max()) <= 1e-5
    tol = 4 * 2.0 ** -10 * 1.4
    assert float((got.images.cpu() - ref.images).abs().max()) <= tol
