"""The last five TPU kernels' plain versions against the JAX package's Pallas
kernels (interpret mode on the CPU): K13 ``conv3x3_cmajor_q8`` / K14
``conv1x1_cmajor_q8`` vs ``conv_kernel.conv3x3_cmajor_q8`` /
``conv1x1_cmajor_q8``; ``conv5x5_q8`` (K4 with 5x5 taps) vs the dense
``conv_flat.conv5x5_flat_q8``, and its block-diagonal form vs K7's plain
version; and a CPU run of each kernel bench's per-shape function (the
pixel-major rows 11 / 12 are in ``test_torch_xla_q8.py``).

Inputs are seeded numpy. Tolerances: int8 outputs equal except +-1 LSB on at
most 1e-4 of the elements (the kernels' requant of the same float32
epilogue; XLA's CPU sigmoid and torch's differ in the last bit now and
then); bfloat16 outputs within one bfloat16 ulp of the larger magnitude
(both round the float32 epilogue once), or, where the epilogue's sum
cancels to near zero, within 1e-6 max|ref| (XLA's CPU epilogue may round
acc * scale + bias once, the port twice: a float32 ulp of the terms, which
is many bfloat16 ulps of a result near 1e-6); the block-diagonal 5x5 equal
to K7 bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rep_yolo_tpu.ops.pallas import conv_kernel as JCK
from rep_yolo_tpu.ops.pallas.conv_flat import conv5x5_flat_q8
from rep_yolo_tpu_torch.ops.kernels import conv_flat as KC
from rep_yolo_tpu_torch.ops.kernels import conv_kernel as KCM
from rep_yolo_tpu_torch.ops.kernels import conv_pm as KPM
from rep_yolo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from rep_yolo_tpu_torch.ops.kernels import neck_flat as KNF
from rep_yolo_tpu_torch.ops.quant import quantize
from rep_yolo_tpu_torch.tools import kernel_bench, kernel_bench_flat
from test_torch_conv_q8 import assert_int8_close as _int8_close

LSB_FRAC = 1e-4


def assert_int8_close(got, ref):
    _int8_close(got, ref, frac=LSB_FRAC)


def assert_bf16_ulp(got, ref):
    """|got - ref| within one bfloat16 ulp of the larger magnitude, or
    within 1e-6 max|ref| (near zero)."""
    g = np.asarray(got, np.float32)
    r = np.asarray(ref, np.float32)
    assert g.shape == r.shape
    _, e = np.frexp(np.maximum(np.abs(g), np.abs(r)))
    ulp = np.ldexp(np.ones_like(g), e - 8)
    d = np.abs(g - r)
    bad = (d > ulp) & (d > 1e-6 * np.abs(r).max())
    assert not bad.any(), (int(bad.sum()), float((d / ulp).max()))


def _np(t):
    """A torch or JAX array as numpy (bfloat16 as float32)."""
    if torch.is_tensor(t):
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t.astype(jnp.float32) if t.dtype == jnp.bfloat16 else t)


def _qconv(cls, w_hwio, bias):
    return cls(torch.tensor(w_hwio.transpose(3, 2, 0, 1)),
               torch.tensor(bias))


def _inputs(rng, B, C, H, W, O, k):
    x = rng.uniform(-1, 1, (B, C, H, W)).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, (k, k, C, O)).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, (O,)).astype(np.float32)
    return x, w, bias


# ---------------------------------------------------------------------------
# K13 / K14: channel-major
# ---------------------------------------------------------------------------

# the shapes of tests/test_conv_kernel.py::test_conv3x3_q8_matches_emulated_int8
@pytest.mark.parametrize("C,O", [(48, 48), (24, 48), (16, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_conv3x3_cmajor_q8_plain_matches_jax(C, O, dtype):
    B, H, W = 2, 16, 64
    rng = np.random.default_rng(C + O)
    x, w, bias = _inputs(rng, B, C, H, W, O, 3)
    s_in = 1.0 / 127.0
    qw = _qconv(KCM.CMQConv, w, bias)
    xt = torch.from_numpy(x)
    xj = jnp.asarray(x)
    if dtype == "bfloat16":
        xt, xj = xt.bfloat16(), xj.astype(jnp.bfloat16)
    elif dtype == "int8":
        xt = quantize(xt, s_in)
        xj = jnp.asarray(xt.numpy())
    got = KCM.conv3x3_cmajor_q8_plain(xt, qw, s_in)
    ref = JCK.conv3x3_cmajor_q8(xj, jnp.asarray(w), jnp.asarray(bias), s_in,
                                row_tile=8)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert_bf16_ulp(_np(got), _np(ref))
    out_s = float(got.float().abs().max()) / 127.0
    got_q = KCM.conv3x3_cmajor_q8_plain(xt, qw, s_in, out_scale=out_s)
    ref_q = JCK.conv3x3_cmajor_q8(xj, jnp.asarray(w), jnp.asarray(bias),
                                  s_in, out_scale=out_s, row_tile=8)
    assert got_q.dtype == torch.int8
    assert_int8_close(got_q.numpy(), np.asarray(ref_q))


def test_conv3x3_cmajor_q8_int8_chain_matches_jax():
    """tests/test_conv_kernel.py::test_conv3x3_q8_int8_resident_chain: stage
    1 emits int8 at s2, stage 2 consumes it, on both sides."""
    B, C, H, W = 1, 16, 16, 64
    rng = np.random.default_rng(5)
    x, w1, b = _inputs(rng, B, C, H, W, C, 3)
    w2 = rng.uniform(-0.5, 0.5, (3, 3, C, C)).astype(np.float32)
    b = np.zeros(C, np.float32)
    s1 = 1.0 / 127.0
    q1, q2 = _qconv(KCM.CMQConv, w1, b), _qconv(KCM.CMQConv, w2, b)
    y1f = KCM.conv3x3_cmajor_q8_plain(torch.from_numpy(x), q1, s1)
    s2 = float(y1f.float().abs().max()) / 127.0
    y1 = KCM.conv3x3_cmajor_q8_plain(torch.from_numpy(x), q1, s1,
                                     out_scale=s2)
    j1 = JCK.conv3x3_cmajor_q8(jnp.asarray(x), jnp.asarray(w1),
                               jnp.asarray(b), s1, out_scale=s2, row_tile=8)
    assert_int8_close(y1.numpy(), np.asarray(j1))
    got = KCM.conv3x3_cmajor_q8_plain(y1, q2, s2)
    ref = JCK.conv3x3_cmajor_q8(jnp.asarray(y1.numpy()), jnp.asarray(w2),
                                jnp.asarray(b), s2, row_tile=8)
    assert_bf16_ulp(_np(got), _np(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("split", [(48,), (16, 8, 24)])
def test_conv1x1_cmajor_q8_plain_matches_jax(dtype, split):
    """tests/test_conv_kernel.py::test_conv1x1_q8_matches_emulated_int8's
    shape (48 -> 24, B = 2, 16 x 64), also as three sections: K14 reads
    the concat section by section."""
    B, C, O, H, W = 2, 48, 24, 16, 64
    rng = np.random.default_rng(11)
    x, w, bias = _inputs(rng, B, C, H, W, O, 1)
    s_in = 1.0 / 127.0
    qw = _qconv(KCM.CMQConv, w, bias)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    if dtype == "bfloat16":
        xt, xj = xt.bfloat16(), xj.astype(jnp.bfloat16)
    elif dtype == "int8":
        xt = quantize(xt, s_in)
        xj = jnp.asarray(xt.numpy())
    xs = list(torch.split(xt, list(split), 1))
    ref = JCK.conv1x1_cmajor_q8(xj, jnp.asarray(w), jnp.asarray(bias), s_in,
                                row_tile=8)
    assert_bf16_ulp(_np(KCM.conv1x1_cmajor_q8_plain(xs, qw, s_in)), _np(ref))
    out_s = 0.05
    ref_q = JCK.conv1x1_cmajor_q8(xj, jnp.asarray(w), jnp.asarray(bias),
                                  s_in, out_scale=out_s, row_tile=8)
    assert_int8_close(KCM.conv1x1_cmajor_q8_plain(xs, qw, s_in,
                                                  out_scale=out_s).numpy(),
                      np.asarray(ref_q))


def test_cmq_packing_holds_the_quantized_weights():
    """K13 / K14's packed copy: the int8 weights per (output channel, chunk
    of 32 input channels, tap), zeros in the padding; the scales are
    quantize_weights' per output channel (JAX's w9 order is a permutation
    of the same values)."""
    rng = np.random.default_rng(2)
    w = rng.uniform(-0.5, 0.5, (3, 3, 40, 20)).astype(np.float32)
    q = _qconv(KCM.CMQConv, w, np.zeros(20, np.float32))
    jq, js = JCK.quantize_weights(jnp.asarray(
        np.transpose(w, (3, 1, 0, 2)).reshape(20, 9 * 40)))
    np.testing.assert_array_equal(q.s_w.numpy(), np.asarray(js)[:, 0])
    pk = q.packed_cm().reshape(32, 2, 9, 32)          # Opad, chunks, tap, c
    assert pk.dtype == torch.int8
    full = pk.permute(0, 2, 1, 3).reshape(32, 9, 64)  # Opad, tap, Cpad
    np.testing.assert_array_equal(
        full[:20, :, :40].numpy(),
        np.transpose(np.asarray(jq).reshape(20, 3, 3, 40), (0, 2, 1, 3))
        .reshape(20, 9, 40))
    assert not full[20:].any() and not full[:, :, 40:].any()


# ---------------------------------------------------------------------------
# row 9, dense: conv5x5_q8 (K4 with 5x5 taps)
# ---------------------------------------------------------------------------

def _flat(a):
    """numpy NHWC -> JAX flat (B, C, H*W)."""
    B, H, W, C = a.shape
    return jnp.asarray(np.ascontiguousarray(a.transpose(0, 3, 1, 2)).reshape(
        B, C, H * W))


def _nhwc(flat, H, W):
    a = _np(flat)
    B, C, _ = a.shape
    return a.reshape(B, C, H, W).transpose(0, 2, 3, 1)


# the shapes of tests/test_neck_flat.py::test_conv5x5_flat_q8 (the tiled and
# the whole-image paths of the Pallas kernel)
@pytest.mark.parametrize("c,o,h,w", [(16, 24, 16, 16), (32, 32, 8, 12)])
def test_conv5x5_q8_plain_matches_jax(c, o, h, w):
    rng = np.random.default_rng(c + h)
    x = rng.normal(0, 1, (2, h, w, c)).astype(np.float32)
    wk = (rng.normal(0, 1, (5, 5, c, o)) * 0.1).astype(np.float32)
    bias = (rng.normal(0, 1, (o,)) * 0.1).astype(np.float32)
    s_in = float(np.abs(x).max()) / 127.0
    qw = _qconv(KC.QConv, wk, bias)
    xq = quantize(torch.from_numpy(x), s_in)
    got = KC.conv5x5_q8_plain(xq, qw, s_in, out_dtype=torch.bfloat16)
    ref = conv5x5_flat_q8(_flat(xq.numpy()), jnp.asarray(wk),
                          jnp.asarray(bias), s_in, h, w)
    assert_bf16_ulp(_np(got), _nhwc(ref, h, w))
    # the float32 exit rounds to the same bfloat16 values
    got32 = KC.conv5x5_q8_plain(xq, qw, s_in)
    assert got32.dtype == torch.float32
    assert torch.equal(got32.bfloat16(), got)
    out_s = float(got32.abs().max()) / 127.0
    got_q = KC.conv5x5_q8_plain(xq, qw, s_in, out_scale=out_s)
    ref_q = conv5x5_flat_q8(_flat(xq.numpy()), jnp.asarray(wk),
                            jnp.asarray(bias), s_in, h, w, out_scale=out_s)
    assert_int8_close(got_q.numpy(), _nhwc(ref_q, h, w))
    # a float input is quantized at s_in first, as the Pallas kernel does
    assert torch.equal(KC.conv5x5_q8_plain(torch.from_numpy(x), qw, s_in,
                                           out_scale=out_s), got_q)


@pytest.mark.parametrize("c,h,w,act,out_s", [(32, 16, 16, "silu", 0.02),
                                             (64, 8, 12, None, None)])
def test_conv5x5_block_diagonal_equals_k7(c, h, w, act, out_s):
    """The dw5_dense route's weights (neck_flat.py:219-231): the depthwise
    kernel embedded block-diagonally, the input's per-channel scales folded
    in, quantized per output channel. As a QConv built from the float
    weights its int8 weights and scales are K7's, and conv5x5_q8's plain
    version equals K7's bit for bit; ``block_diagonal`` builds the same
    QConv from K7's. The JAX dense route agrees within the int8 gate."""
    rng = np.random.default_rng(c)
    wdw = (rng.normal(0, 1, (c, 1, 5, 5)) * 0.1).astype(np.float32)
    bias = (rng.normal(0, 1, (c,)) * 0.1).astype(np.float32)
    sv = rng.uniform(0.005, 0.02, (c,)).astype(np.float32)
    xq = torch.from_numpy(rng.integers(-127, 128, (2, h, w, c)).astype(
        np.int8))
    qd = KNF.QDepthwise(torch.from_numpy(wdw), torch.from_numpy(bias),
                        torch.from_numpy(sv))
    dense = np.zeros((c, c, 5, 5), np.float32)
    dense[np.arange(c), np.arange(c)] = wdw[:, 0]
    qc = KC.QConv(torch.from_numpy(dense), torch.from_numpy(bias),
                  torch.from_numpy(sv))
    assert torch.equal(qc.s_w, qd.s_w)
    bd = KC.block_diagonal(qd)
    assert torch.equal(bd.w_q, qc.w_q) and torch.equal(bd.s_w, qc.s_w)
    ref = KNF.dwconv5x5_q8_plain(xq, qd, 1.0, act, out_s)
    for q in (qc, bd):
        got = KC.conv5x5_q8_plain(xq, q, 1.0, act, out_s)
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    # the JAX dense embedding of the same weights (bf16 exit, or int8)
    kd = np.zeros((5, 5, c, c), np.float32)
    kd[:, :, np.arange(c), np.arange(c)] = \
        (wdw[:, 0] * sv[:, None, None]).transpose(1, 2, 0)
    jref = conv5x5_flat_q8(_flat(xq.numpy()), jnp.asarray(kd),
                           jnp.asarray(bias), 1.0, h, w, act=act,
                           out_scale=out_s)
    if out_s is None:
        assert_bf16_ulp(ref.bfloat16().float().numpy(), _nhwc(jref, h, w))
    else:
        assert_int8_close(ref.numpy(), _nhwc(jref, h, w))


def test_new_wrappers_take_plain_on_cpu_and_count_nothing():
    rng = np.random.default_rng(4)
    x, w, bias = _inputs(rng, 1, 8, 8, 8, 8, 3)
    q3 = _qconv(KCM.CMQConv, w, bias)
    q1 = _qconv(KCM.CMQConv, w[1:2, 1:2], bias)
    q5 = _qconv(KC.QConv, rng.uniform(-0.5, 0.5, (5, 5, 8, 8)).astype(
        np.float32), bias)
    xt = torch.from_numpy(x)
    xn = xt.permute(0, 2, 3, 1).contiguous()
    reset_launch_counts()
    pairs = [
        (KCM.conv3x3_cmajor_q8(xt, q3, 0.01),
         KCM.conv3x3_cmajor_q8_plain(xt, q3, 0.01)),
        (KCM.conv1x1_cmajor_q8([xt[:, :4], xt[:, 4:]], q1, 0.01, "relu",
                               0.02),
         KCM.conv1x1_cmajor_q8_plain(xt, q1, 0.01, "relu", 0.02)),
        (KC.conv5x5_q8(xn, q5, 0.01, "relu"),
         KC.conv5x5_q8_plain(xn, q5, 0.01, "relu")),
        (KPM.conv3x3_pm_q8(xn.reshape(1, 64, 8), _qconv(KC.QConv, w, bias),
                           0.01, 8, 8),
         KPM.conv3x3_pm_q8_plain(xn.reshape(1, 64, 8),
                                 _qconv(KC.QConv, w, bias), 0.01, 8, 8)),
        (KPM.conv1x1_pm_q8([xn.reshape(1, 64, 8)], q1, 0.01),
         KPM.conv1x1_pm_q8_plain(xn.reshape(1, 64, 8), q1, 0.01)),
    ]
    assert sum(launch_counts().values()) == 0
    for got, ref in pairs:
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    assert pairs[3][0].dtype == torch.bfloat16
    with pytest.raises(ValueError):
        KC.conv3x3_q8_plain(xn, q3, 0.01, act="gelu")


# ---------------------------------------------------------------------------
# the kernel benches, on the CPU (the plain versions)
# ---------------------------------------------------------------------------

def test_kernel_bench_shape_on_cpu():
    cpu = torch.device("cpu")
    row = kernel_bench.bench_shape(3, 8, 16, 8, 1, cpu, iters=1)
    assert set(kernel_bench.VARIANTS) <= set(row)
    assert all(row[v] > 0 for v in kernel_bench.VARIANTS)
    fns = kernel_bench.shape_case(1, 16, 8, 8, 2, cpu)
    ys = {k: fn() for k, fn in fns.items()}
    assert ys["q8"].dtype == torch.bfloat16 and ys["q8c"].dtype == torch.int8
    assert ys["cm+T"].shape == (2, 8, 8, 8) and ys["cm"].shape == (2, 8, 8, 8)
    # the untimed calls: the plain versions (what q8 / q8c run on the CPU)
    # and cuDNN's float32 conv
    assert torch.equal(ys["q8"], ys["q8_plain"])
    assert torch.equal(ys["q8c"], ys["q8c_plain"])
    assert ys["xla_f32"].dtype == torch.float32
    assert float((ys["xla_f32"] - ys["xla"].float()).abs().max()) < 1e-2
    # the int8 variant computes what the cuDNN-style float variant does,
    # within the quantization error
    xla = ys["xla"].float()                 # NCHW, channels_last strides
    assert float((ys["q8"].float() - xla).abs().max()) < 0.05
    lines = []
    kernel_bench.run(1, cpu, 1, True, [(1, 8, 8, 4)], out=lines.append)
    assert len(lines) == 3 and lines[-1].count(",") == 6


def test_kernel_bench_flat_shape_on_cpu():
    cpu = torch.device("cpu")
    rows = kernel_bench_flat.run(1, cpu, 1, conv3=[(8, 8, 8, 8, "t")],
                                 cv1=(8, 8, 4, 4), mp=(8, 4, 4),
                                 out=lambda s: None)
    assert [r["line"].split()[0] for r in rows] == \
        ["v1", "v2", "v1", "v1", "v2", "MP", "MP"]
    assert all(r["ms"] > 0 for r in rows)
    cv1 = kernel_bench_flat.cv1_case(1, cpu, (8, 8, 4, 4))
    ys = [fn() for fn in cv1.values()]
    assert torch.equal(ys[0], ys[1])                  # concat or sections
    assert torch.equal(ys[0], ys[2].permute(0, 3, 1, 2))  # cm or NHWC
    mp = [fn() for fn in kernel_bench_flat.mp_case(1, cpu, (8, 4, 4)).values()]
    assert torch.equal(mp[0], mp[1])
