"""The int8 kernels' plain versions against the JAX package's Pallas kernels
(interpret mode on the CPU): K4 ``conv3x3_q8`` vs ``conv3x3_flat_q8`` (and the
stride-2 stem vs ``RepSBlock``'s q8 stem), K5 ``conv1x1_q8`` vs
``conv1x1_flat_q8``, K6 ``max_pool2_q8`` vs ``max_pool2_flat``.

Inputs are seeded numpy; the port is channels-last (B, H, W, C), the JAX
kernels flat (B, C, H*W). Tolerances: int8 outputs equal except +-1 LSB on
at most 0.1 % of the elements (XLA's CPU sigmoid and torch's differ in the
last bit now and then); float exits rtol = atol = 1e-2 (the JAX kernels emit
bf16 there, the port float32); pools bitwise; the fused pool bitwise equal
to conv, requant, then pool.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rep_yolo_tpu.ops.pallas.conv_flat import conv1x1_flat_q8, conv3x3_flat_q8
from rep_yolo_tpu.ops.pallas.pool_flat import max_pool2_flat
from rep_yolo_tpu_torch.ops.kernels import conv_flat as KC
from rep_yolo_tpu_torch.ops.kernels import pool_flat as KP
from rep_yolo_tpu_torch.ops.quant import quantize_weights


def assert_int8_close(got, ref, frac=1e-3):
    got = np.asarray(got).astype(np.int32)
    ref = np.asarray(ref).astype(np.int32)
    assert got.shape == ref.shape
    d = np.abs(got - ref)
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= frac, (d > 0).mean()


def _nhwc(flat, H, W):
    """JAX flat (B, C, H*W) -> numpy (B, H, W, C)."""
    a = np.asarray(flat, np.float32) if flat.dtype != jnp.int8 \
        else np.asarray(flat)
    B, C, _ = a.shape
    return a.reshape(B, C, H, W).transpose(0, 2, 3, 1)


def _qconv(w_hwio, bias):
    return KC.QConv(torch.tensor(w_hwio.transpose(3, 2, 0, 1)),
                    torch.tensor(bias))


def test_quantize_weights_matches_jax():
    from rep_yolo_tpu.ops.pallas.conv_kernel import \
        quantize_weights as jax_qw

    w = np.random.default_rng(0).normal(0, 0.2, (24, 3 * 3 * 16)).astype(
        np.float32)
    w[3] = 0.0                                   # all-zero channel: 1e-12
    wq, sw = quantize_weights(torch.from_numpy(w))
    jq, js = jax_qw(jnp.asarray(w))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(js)[:, 0])


# the shapes of tests/test_conv_flat.py::test_conv3x3_flat_q8_matches_emulated
@pytest.mark.parametrize("B,C,O,H,W,rt", [
    (1, 8, 8, 8, 320, 4),
    (2, 16, 24, 16, 64, 8),
    (1, 8, 8, 12, 96, 4),
    (1, 8, 8, 4, 320, 4),
    (1, 16, 16, 40, 40, None),
    (1, 16, 16, 80, 80, None),
])
def test_conv3x3_q8_plain_matches_jax(B, C, O, H, W, rt):
    rng = np.random.default_rng(C * H + W)
    x = rng.uniform(-1, 1, (B, C, H, W)).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, (3, 3, C, O)).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, (O,)).astype(np.float32)
    s_in = 1.0 / 127.0
    qw = _qconv(w, bias)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 3, 1)))
    xf = jnp.asarray(x.reshape(B, C, H * W))

    # float input quantized by the conv, float exit
    got = KC.conv3x3_q8_plain(xt, qw, s_in)
    ref = conv3x3_flat_q8(xf, jnp.asarray(w), jnp.asarray(bias), s_in, H, W,
                          row_tile=rt)
    np.testing.assert_allclose(got.numpy(), _nhwc(ref, H, W), rtol=1e-2,
                               atol=1e-2)
    # int8 exit at out_scale, then an int8-in conv
    out_s = float(got.abs().max()) / 127.0
    got_q = KC.conv3x3_q8_plain(xt, qw, s_in, out_scale=out_s)
    ref_q = conv3x3_flat_q8(xf, jnp.asarray(w), jnp.asarray(bias), s_in, H,
                            W, out_scale=out_s, row_tile=rt)
    assert got_q.dtype == torch.int8
    assert_int8_close(got_q.numpy(), _nhwc(ref_q, H, W))
    if C == O:
        got2 = KC.conv3x3_q8_plain(torch.from_numpy(_nhwc(ref_q, H, W).copy()),
                                   qw, out_s, out_scale=out_s)
        ref2 = conv3x3_flat_q8(ref_q, jnp.asarray(w), jnp.asarray(bias),
                               out_s, H, W, out_scale=out_s, row_tile=rt)
        assert_int8_close(got2.numpy(), _nhwc(ref2, H, W))


def test_stem_stride2_matches_jax_q8_stem():
    """K4 at stride 2 on the float image == RepSBlock's q8 stem (the s2d
    input and the 2x2-in-3x3 weight embedding of the JAX package)."""
    import rep_yolo_tpu.nn.blocks as JB

    rng = np.random.default_rng(7)
    B, H, W, C, O = 2, 32, 48, 3, 16
    x = rng.uniform(0, 1, (B, H, W, C)).astype(np.float32)
    s_in, out_s = 1.0 / 127.0, 0.021
    mod = JB.RepSBlock(C, O, 3, 2, 1, deploy=True, cm_out_scale=out_s)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kern = np.asarray(variables["params"]["reparam_conv"]["w"]["kernel"])
    bias = np.asarray(variables["params"]["reparam_conv"]["w"]["bias"])
    try:
        JB.set_cmajor_deploy("q8", {"/reparam_conv": s_in})
        ref = mod.apply(variables, jnp.asarray(x))
    finally:
        JB.set_cmajor_deploy(None)
    assert ref.dtype == jnp.int8, ref.dtype
    got = KC.conv3x3_q8_plain(torch.from_numpy(x), _qconv(kern, bias), s_in,
                              stride=2, out_scale=out_s)
    assert got.shape == (B, H // 2, W // 2, O)
    assert_int8_close(got.numpy(), _nhwc(ref, H // 2, W // 2))


def _sections(seed, B, C, H, W):
    rng = np.random.default_rng(seed)
    xs = [rng.integers(-127, 128, (B, C, H * W)).astype(np.int8)
          for _ in range(3)]
    wc = rng.uniform(-0.5, 0.5, (1, 1, 3 * C, 24)).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, (24,)).astype(np.float32)
    xt = [torch.from_numpy(np.ascontiguousarray(
        a.reshape(B, C, H, W).transpose(0, 2, 3, 1))) for a in xs]
    return xs, wc, bias, xt


# the shapes of tests/test_conv_flat.py::test_conv1x1_pool_fused_bitexact
@pytest.mark.parametrize("H,W,out_s", [
    (16, 64, 0.013),
    (16, 64, None),
    (8, 320, 0.013),
])
def test_conv1x1_q8_plain_matches_jax(H, W, out_s):
    B, C = 2, 16
    xs, wc, bias, xt = _sections(H + W, B, C, H, W)
    qw = _qconv(wc, bias)
    jxs = [jnp.asarray(a) for a in xs]
    ref = conv1x1_flat_q8(jxs, jnp.asarray(wc), jnp.asarray(bias), 1.0,
                          out_scale=out_s)
    ref_p = conv1x1_flat_q8(jxs, jnp.asarray(wc), jnp.asarray(bias), 1.0,
                            out_scale=out_s, pool_hw=(H, W))
    for pool, r, (h, w) in ((False, ref, (H, W)),
                            (True, ref_p, (H // 2, W // 2))):
        got = KC.conv1x1_q8_plain(xt, qw, 1.0, out_scale=out_s, pool=pool)
        if out_s is None:
            np.testing.assert_allclose(got.numpy(), _nhwc(r, h, w),
                                       rtol=1e-2, atol=1e-2)
        else:
            assert_int8_close(got.numpy(), _nhwc(r, h, w))
    # the fused pool is bitwise conv -> requant -> pool
    fused = KC.conv1x1_q8_plain(xt, qw, 1.0, out_scale=out_s, pool=True)
    unfused = KP.max_pool2_q8_plain(
        KC.conv1x1_q8_plain(xt, qw, 1.0, out_scale=out_s))
    assert torch.equal(fused, unfused)


def test_conv1x1_q8_one_section_equals_concat():
    B, C, H, W = 1, 8, 8, 8
    xs, wc, bias, xt = _sections(3, B, C, H, W)
    qw = _qconv(wc, bias)
    a = KC.conv1x1_q8_plain(xt, qw, 0.02, out_scale=0.05)
    b = KC.conv1x1_q8_plain([torch.cat(xt, -1)], qw, 0.02, out_scale=0.05)
    assert torch.equal(a, b)


# the int8 shapes of tests/test_conv_flat.py::test_max_pool2_flat_matches_
# reshape_max, cut to those the flagship's region pools (l6: 256 @ 80x80)
@pytest.mark.parametrize("C,H,W,dtype", [(96, 160, 160, np.int8),
                                         (256, 80, 80, np.int8),
                                         (32, 64, 64, np.float32)])
def test_max_pool2_q8_plain_matches_jax(C, H, W, dtype):
    rng = np.random.default_rng(0)
    x4 = rng.integers(-127, 128, (2, C, H, W)).astype(dtype)
    ref = max_pool2_flat(jnp.asarray(x4.reshape(2, C, H * W)), H, W,
                         interpret=True)
    got = KP.max_pool2_q8_plain(torch.from_numpy(
        np.ascontiguousarray(x4.transpose(0, 2, 3, 1))))
    np.testing.assert_array_equal(got.numpy(),
                                  _nhwc(ref, H // 2, W // 2).astype(dtype))


def test_wrappers_take_plain_on_cpu_and_count_nothing():
    from rep_yolo_tpu_torch.ops.kernels import (launch_counts,
                                                reset_launch_counts)

    rng = np.random.default_rng(1)
    qw = _qconv(rng.uniform(-0.5, 0.5, (3, 3, 8, 8)).astype(np.float32),
                np.zeros(8, np.float32))
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 8, 8, 8)).astype(np.float32))
    reset_launch_counts()
    y = KC.conv3x3_q8(x, qw, 0.01, out_scale=0.05)
    assert torch.equal(y, KC.conv3x3_q8_plain(x, qw, 0.01, out_scale=0.05))
    assert torch.equal(KP.max_pool2_q8(y), KP.max_pool2_q8_plain(y))
    assert sum(launch_counts().values()) == 0
