"""The int8 neck's kernels' plain versions and map helpers against the JAX
package (its Pallas kernels in interpret mode on the CPU):

- K7 ``dwconv5x5_q8`` (through the port's ``flat_conv``) against
  ``neck_flat.flat_conv``, which runs GSConv's depthwise 5x5 as
  ``conv5x5_flat_q8`` on block-diagonal weights: int8 outputs equal but for
  +-1 LSB on at most 0.1 % of the elements, float outputs rtol = atol = 1e-2
  (the JAX kernel emits bf16 there);
- K8 ``spp_pools_q8`` against ``spp_pools_flat``: identical;
- K4 at stride 2 on int8 input against ``conv3x3s2_flat_q8`` (space-to-depth
  and a stride-1 kernel on the TPU): +-1 LSB on at most 0.1 %;
- the weight fold with a permutation and per-channel scales against
  ``neck_flat._fold``; GSConv's shuffle as a pending permutation against
  ``gs_shuffle_flat``; the upsample against ``upsample2x_flat``.

Inputs are seeded numpy; the port is channels-last (B, H, W, C), the JAX
package flat (B, C, H*W).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from rep_yolo_tpu.ops.pallas import neck_flat as jnf
from rep_yolo_tpu_torch.ops import neck_flat as NF
from rep_yolo_tpu_torch.ops.kernels import conv_flat as KC
from rep_yolo_tpu_torch.ops.kernels import neck_flat as KN
from test_torch_conv_q8 import _nhwc, assert_int8_close


def _int8(rng, B, C, H, W):
    """Random int8 maps: (JAX flat, port channels-last)."""
    x = rng.integers(-127, 128, (B, C, H, W)).astype(np.int8)
    return (jnp.asarray(x.reshape(B, C, H * W)),
            torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 3, 1))))


def _conv(w_hwio, bias, stride=1, groups=1):
    """A deploy Conv2d holding the HWIO weights (depthwise: (k, k, 1, C))."""
    k, _, cg, o = w_hwio.shape
    conv = nn.Conv2d(cg * groups, o, k, stride, k // 2, groups=groups)
    conv.weight.data = torch.from_numpy(
        np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    conv.bias.data = torch.from_numpy(bias)
    return conv


@pytest.mark.parametrize("C,H,W,act,out_s", [
    (32, 16, 16, "silu", 0.02),
    (16, 8, 12, "silu", None),
    (32, 8, 8, None, 0.03),
])
def test_dwconv5x5_q8_plain_matches_jax_dense(C, H, W, act, out_s):
    rng = np.random.default_rng(C + H)
    xj, xt = _int8(rng, 2, C, H, W)
    w = rng.normal(0, 0.1, (5, 5, 1, C)).astype(np.float32)
    bias = rng.normal(0, 0.1, (C,)).astype(np.float32)
    s_x = 0.013
    ref = jnf.flat_conv(jnf.FlatT(xj, s_x, H, W), jnp.asarray(w),
                        jnp.asarray(bias), 5, 1, C, act, out_s)
    got = NF.flat_conv(NF.Q8Map(xt, s_x), _conv(w, bias, groups=C), {},
                       "cv2", act, out_s)
    if out_s is None:
        np.testing.assert_allclose(got.numpy(), _nhwc(ref, H, W), rtol=1e-2,
                                   atol=1e-2)
    else:
        assert ref.data.dtype == jnp.int8 and got.data.dtype == torch.int8
        assert_int8_close(got.data.numpy(), _nhwc(ref.data, H, W))


def test_depthwise_refuses_a_pending_permutation():
    rng = np.random.default_rng(0)
    _, xt = _int8(rng, 1, 8, 4, 4)
    conv = _conv(rng.normal(0, 0.1, (5, 5, 1, 8)).astype(np.float32),
                 np.zeros(8, np.float32), groups=8)
    with pytest.raises(ValueError):
        NF.flat_conv(NF.Q8Map(xt, 0.1, NF.gs_shuffle_perm(8)), conv, {},
                     "cv2", "silu", 0.1)


@pytest.mark.parametrize("B,C,H,W", [(2, 32, 8, 8), (1, 64, 20, 20),
                                     (2, 8, 5, 7)])
def test_spp_pools_q8_plain_matches_jax(B, C, H, W):
    xj, xt = _int8(np.random.default_rng(H * W), B, C, H, W)
    ref = jnf.spp_pools_flat(xj, H, W)
    got = KN.spp_pools_q8_plain(xt)
    assert got.shape == (B, H, W, 4 * C) and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), _nhwc(ref, H, W))


@pytest.mark.parametrize("C,O,H,W,out_s", [
    (16, 8, 16, 16, 0.02),        # l33's shape pattern: C -> C/2, 2x down
    (32, 16, 8, 12, 0.02),
    (16, 16, 8, 8, None),
])
def test_conv3x3_stride2_int8_matches_jax(C, O, H, W, out_s):
    rng = np.random.default_rng(C * H + O)
    xj, xt = _int8(rng, 2, C, H, W)
    w = rng.uniform(-0.5, 0.5, (3, 3, C, O)).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, (O,)).astype(np.float32)
    s_x = 1.0 / 127.0
    # the JAX dispatch folds the map's scale and runs the s2d kernel
    ref = jnf.flat_conv(jnf.FlatT(xj, s_x, H, W), jnp.asarray(w),
                        jnp.asarray(bias), 3, 2, 1, "silu", out_s)
    got = NF.flat_conv(NF.Q8Map(xt, s_x), _conv(w, bias, stride=2), {},
                       "cv1", "silu", out_s)
    if out_s is None:
        np.testing.assert_allclose(got.numpy(), _nhwc(ref, H // 2, W // 2),
                                   rtol=1e-2, atol=1e-2)
    else:
        assert_int8_close(got.data.numpy(), _nhwc(ref.data, H // 2, W // 2))
    # K4's wrapper at stride 2 on the raw int8 map: the dispatch's result
    qw = KC.QConv(_conv(w, bias).weight * s_x, torch.from_numpy(bias))
    direct = KC.conv3x3_q8_plain(xt, qw, 1.0, 2, "silu", out_s)
    assert torch.equal(direct, got if out_s is None else got.data)


def test_fold_with_permutation_and_channel_scales_matches_jax():
    rng = np.random.default_rng(4)
    C, O = 12, 8
    kern = rng.normal(0, 0.2, (3, 3, C, O)).astype(np.float32)
    perm = rng.permutation(C)
    sv = rng.uniform(0.01, 0.05, C).astype(np.float32)
    t = jnf.FlatT(jnp.zeros((1, C, 4), jnp.int8), sv, 2, 2, perm=perm)
    ref = np.asarray(jnf._fold(jnp.asarray(kern), t))
    got = KC.fold_weight(torch.from_numpy(kern.transpose(3, 2, 0, 1).copy()),
                         torch.from_numpy(sv), torch.from_numpy(perm))
    np.testing.assert_array_equal(got.numpy(), ref.transpose(3, 2, 0, 1))
    # a concat of a permuted section and a plain one folds section-wise
    m1 = NF.Q8Map(torch.zeros((1, 2, 2, C), dtype=torch.int8),
                  torch.from_numpy(sv), torch.from_numpy(perm))
    m2 = NF.Q8Map(torch.zeros((1, 2, 2, 4), dtype=torch.int8), 0.5)
    svc, pc = NF.fold_meta([m1, m2])
    kc = rng.normal(0, 0.2, (1, 1, C + 4, O)).astype(np.float32)
    t2 = jnf.FlatT(jnp.zeros((1, 4, 4), jnp.int8), 0.5, 2, 2)
    ref2 = np.concatenate([np.asarray(jnf._fold(jnp.asarray(kc[:, :, :C]), t)),
                           np.asarray(jnf._fold(jnp.asarray(kc[:, :, C:]),
                                                t2))], 2)
    got2 = KC.fold_weight(torch.from_numpy(kc.transpose(3, 2, 0, 1).copy()),
                          svc, pc)
    np.testing.assert_array_equal(got2.numpy(), ref2.transpose(3, 2, 0, 1))


def test_gs_shuffle_as_permutation_matches_jax():
    rng = np.random.default_rng(5)
    B, H, W, c_ = 2, 4, 6, 8
    xj, xt = _int8(rng, B, 2 * c_, H, W)
    sv = np.concatenate([np.full(c_, 0.02), np.full(c_, 0.05)]).astype(
        np.float32)
    deq = xj.astype(jnp.float32) * jnp.asarray(sv)[None, :, None]
    ref = _nhwc(jnf.gs_shuffle_flat(deq), H, W)
    m = NF.Q8Map(xt, torch.from_numpy(sv), NF.gs_shuffle_perm(2 * c_))
    np.testing.assert_array_equal(m.to_float().permute(0, 2, 3, 1).numpy(),
                                  ref)
    flat = NF.materialize_perm(m)
    assert flat.perm is None
    np.testing.assert_array_equal(flat.to_float().numpy(),
                                  m.to_float().numpy())
    # JAX's own FlatT exit agrees (bf16 there; these values are exact)
    jt = jnf.FlatT(xj, sv, H, W, perm=NF.gs_shuffle_perm(2 * c_).numpy())
    np.testing.assert_allclose(np.asarray(jnf.flat_to_nhwc(jt), np.float32),
                               ref, rtol=1e-2)


def test_upsample_and_entry_quantize_match_jax():
    rng = np.random.default_rng(6)
    xj, xt = _int8(rng, 2, 8, 3, 5)
    ref = jnf.upsample2x_flat(xj, 3, 5)
    got = NF.upsample2x(NF.Q8Map(xt, 0.1))
    np.testing.assert_array_equal(got.data.numpy(), _nhwc(ref, 6, 10))
    assert NF.flat_hw(got) == NF.flat_hw([got, got]) == (6, 10)
    assert NF.is_flat([got, got]) and not NF.is_flat([]) \
        and not NF.is_flat(got.data)
    xf = rng.normal(0, 1, (2, 5, 6, 8)).astype(np.float32)   # NHWC
    jq = jnf.quantize_to_flat(jnp.asarray(xf), 0.02, 5, 6)
    pq = NF.quantize_to_flat(torch.from_numpy(xf).permute(0, 3, 1, 2), 0.02)
    np.testing.assert_array_equal(pq.data.numpy(), _nhwc(jq.data, 5, 6))
