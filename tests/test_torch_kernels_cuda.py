"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips without a CUDA device. This file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed (``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances: attention f32 atol = rtol = 1e-4 (summation order differs);
NMS keep sets identical; the int8 kernels: int8 outputs identical but for
+-1 LSB on at most 1e-4 of the elements (CUDA's expf against torch's
sigmoid), float32 outputs atol = rtol = 1e-5, pools (K6, K8) identical;
K9 wgrad3x3: |dW - plain| <= 1e-4 |plain| + 1e-4 max|plain| (sums of up to
51,200 products in another order); K10 / K11 (conv3x3_cmajor,
conv1x1_cmajor): float32 atol = rtol = 1e-4, bfloat16 at most one bfloat16
ulp from the plain version or within 1e-3 max|plain| where the value is near
zero (both sum in float32 in another order, then round once).
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


def _attention_inputs(c, h, w, seed, device):
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
    x = torch.randn((2, h, w, c), generator=g)
    consts = [packed[k] for k in ("wqk", "pq", "pv", "gamma")]
    return [t.to(device) for t in (x, *consts)]


@pytest.mark.parametrize("criss_cross", [True, False])
@pytest.mark.parametrize("shape", [(64, 40, 40), (32, 13, 21), (256, 20, 20)])
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


@pytest.mark.parametrize("k", [64, 1000, 4096])
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


@pytest.mark.parametrize("shape", [(2, 80, 80, 256), (3, 10, 14, 4),
                                   (2, 6, 8, 8)])
def test_max_pool2_q8_matches_plain(cuda, shape):
    x = torch.from_numpy(np.random.default_rng(0).integers(
        -128, 128, shape).astype(np.int8)).to(cuda)
    assert torch.equal(KP.max_pool2_q8(x), KP.max_pool2_q8_plain(x))


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


@pytest.mark.parametrize("shape", [(4, 20, 20, 512), (2, 7, 9, 8),
                                   (1, 40, 40, 64)])
def test_spp_pools_q8_matches_plain(cuda, shape):
    x = torch.from_numpy(np.random.default_rng(1).integers(
        -128, 128, shape).astype(np.int8)).to(cuda)
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
    counts = launch_counts()
    assert (counts["conv3x3_q8"], counts["conv1x1_q8"],
            counts["max_pool2_q8"], counts["dwconv5x5_q8"],
            counts["spp_pools_q8"]) == (1, 1, 1, 1, 1)
    with pytest.raises(ValueError):                  # int8 C not 4k
        KC.conv3x3_q8(torch.zeros((1, 8, 8, 3), dtype=torch.int8,
                                  device=cuda), _qconv(rng, 3, 8, 3, cuda),
                      0.01)
    with pytest.raises(ValueError):                  # odd map for the pool
        KP.max_pool2_q8(torch.zeros((1, 5, 4, 4), dtype=torch.int8,
                                    device=cuda))


# (B, H, W, C, O): the nine convs of a flagship train step at 640 px, batch
# 8, that the select-all route sends to K9, and an odd shape (H, W not a
# multiple of anything, C = 24)
WGRAD_SHAPES = [(8, 20, 20, 512, 512), (8, 40, 40, 128, 64),
                (8, 80, 80, 64, 32), (8, 20, 20, 256, 128),
                (8, 80, 80, 128, 256), (8, 40, 40, 256, 512),
                (8, 20, 20, 512, 1024), (3, 13, 21, 24, 40)]


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
    with pytest.raises(ValueError):                  # odd bf16 section
        KCM.conv1x1_cmajor([x[:, :3].contiguous(), x[:, :5].contiguous()],
                           cw1)
    with pytest.raises(ValueError):                  # 1x1 weights in K10
        KCM.conv3x3_cmajor(x, cw1)
