"""K10 / K11 (the channel-major float convs of the DER blocks' "bf16"
deploy path): the port's plain versions against the JAX package's Pallas
kernels ``conv3x3_cmajor`` / ``conv1x1_cmajor`` in interpret mode, on the
same inputs made from a numpy seed, on the CPU.

Tolerances: float32 rtol = atol = 1e-4, the JAX test's own
(tests/test_conv_kernel.py); bfloat16 at most one bfloat16 ulp apart, or
within 1e-3 max|JAX| near zero (both sum in float32 in another order and
round once). The packed weight layouts the CUDA kernels read are checked
against the weights they came from.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rep_yolo_tpu.ops.pallas import conv_kernel as JK
from rep_yolo_tpu_torch.ops.kernels import conv_kernel as K
from rep_yolo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from test_torch_kernels_cuda import bf16_close

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(rng, secs, c_out, k, h, w, dtype):
    """Sections (B=2, C_s, h, w), OIHW weights and bias, in numpy f32 (the
    activations and weights already rounded to ``dtype``)."""
    td, _ = DTYPES[dtype]
    xs = [rng.uniform(-1, 1, (2, c, h, w)).astype(np.float32) for c in secs]
    cin = sum(secs)
    wt = (rng.uniform(-1, 1, (c_out, cin, k, k)) / np.sqrt(cin * k * k)
          ).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, c_out).astype(np.float32)

    def rnd(a):
        return torch.from_numpy(a).to(td).float().numpy()
    return [rnd(x) for x in xs], rnd(wt), b


def _jax(fn, x, wt, b, dtype, act):
    _, jd = DTYPES[dtype]
    y = fn(jnp.asarray(x, jd), jnp.asarray(wt.transpose(2, 3, 1, 0), jd),
           jnp.asarray(b), act=act)
    return torch.from_numpy(np.array(y.astype(jnp.float32))).to(
        DTYPES[dtype][0])


def _close(got, ref, dtype):
    assert got.dtype == ref.dtype
    if dtype == "bfloat16":
        bf16_close(got, ref)
    else:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c_in,c_out,h,w,act", [
    (48, 48, 16, 32, "silu"), (24, 24, 8, 40, "silu"), (16, 32, 8, 16, None)])
def test_conv3x3_cmajor_plain_matches_jax(dtype, c_in, c_out, h, w, act):
    rng = np.random.default_rng(c_in + w)
    (x,), wt, b = _inputs(rng, (c_in,), c_out, 3, h, w, dtype)
    cw = K.CMConv(torch.from_numpy(wt), torch.from_numpy(b))
    got = K.conv3x3_cmajor_plain(torch.from_numpy(x).to(DTYPES[dtype][0]),
                                 cw, act)
    _close(got, _jax(JK.conv3x3_cmajor, x, wt, b, dtype, act), dtype)


def test_conv3x3_border_zero_padding():
    """As tests/test_conv_kernel.py:33-45: ones in, mean weights: the
    interior sees 1, an edge 6/9, a corner 4/9, in both packages."""
    C, O, H, W = 16, 16, 16, 32
    x = np.ones((1, C, H, W), np.float32)
    wt = np.full((O, C, 3, 3), 1.0 / (9 * C), np.float32)
    b = np.zeros(O, np.float32)
    cw = K.CMConv(torch.from_numpy(wt), torch.from_numpy(b))
    y = K.conv3x3_cmajor(torch.from_numpy(x), cw, act=None)[0, 0].numpy()
    ref = _jax(JK.conv3x3_cmajor, x, wt, b, "float32", None)[0, 0].numpy()
    for (i, j), v in {(5, 5): 1.0, (0, 5): 6 / 9, (5, 0): 6 / 9,
                      (0, 0): 4 / 9, (H - 1, W - 1): 4 / 9}.items():
        np.testing.assert_allclose(y[i, j], v, rtol=1e-5)
        np.testing.assert_allclose(ref[i, j], v, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("secs,c_out,act", [
    ((144,), 48, "silu"), ((48,), 24, "silu"), ((24,), 48, None)])
def test_conv1x1_cmajor_plain_matches_jax(dtype, secs, c_out, act):
    rng = np.random.default_rng(sum(secs) + c_out)
    (x,), wt, b = _inputs(rng, secs, c_out, 1, 8, 32, dtype)
    cw = K.CMConv(torch.from_numpy(wt), torch.from_numpy(b))
    got = K.conv1x1_cmajor_plain(torch.from_numpy(x).to(DTYPES[dtype][0]),
                                 cw, act)
    _close(got, _jax(JK.conv1x1_cmajor, x, wt, b, dtype, act), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1x1_three_sections_match_jax_on_the_concat(dtype):
    """DER's cv1 over [x1, x4_1, x4_3] without the concat, against the JAX
    kernel on the concatenated map (what the JAX block feeds it)."""
    rng = np.random.default_rng(7)
    xs, wt, b = _inputs(rng, (16, 16, 16), 24, 1, 8, 16, dtype)
    cw = K.CMConv(torch.from_numpy(wt), torch.from_numpy(b))
    td = DTYPES[dtype][0]
    reset_launch_counts()
    got = K.conv1x1_cmajor([torch.from_numpy(x).to(td) for x in xs], cw)
    assert sum(launch_counts().values()) == 0            # plain on the CPU
    ref = _jax(JK.conv1x1_cmajor, np.concatenate(xs, 1), wt, b, dtype,
               "silu")
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c_in,c_out,k", [(24, 40, 3), (48, 24, 3),
                                          (3, 8, 3), (144, 48, 1),
                                          (30, 520, 1)])
def test_cmconv_packed_layout(dtype, c_in, c_out, k):
    """The packed copy holds every weight where the kernels read it (the
    layouts of ``CMConv``'s docstring), zeros in the padding."""
    w = torch.randn((c_out, c_in, k, k))
    p = K.CMConv(w, None).packed(dtype).float()
    w = w.to(dtype).float().reshape(c_out, c_in, k * k)
    if dtype == torch.bfloat16:
        # (c16, tap, o8, half, o, c): wgmma B core matrices of 8 output x
        # 8 input channels, a k16 step per (chunk of 16 channels, tap)
        opad, cp = -(-c_out // 8) * 8, -(-c_in // 16) * 16
        assert p.shape == (cp // 16, k * k, opad // 8, 2, 8, 8)
        full = p.permute(2, 4, 0, 3, 5, 1).reshape(opad, cp, k * k)
    else:                    # (Opad / 32, c, tap, 32)
        opad = -(-c_out // 32) * 32
        cp = -(-c_in // (8 if k == 3 else 16)) * (8 if k == 3 else 16)
        full = p.reshape(opad // 32, cp, k * k, 32).permute(0, 3, 1, 2) \
            .reshape(opad, cp, k * k)
    assert torch.equal(full[:c_out, :c_in], w)
    pad = torch.ones_like(full, dtype=torch.bool)
    pad[:c_out, :c_in] = False
    assert not bool(full[pad].any())


def test_cmconv_bias_is_the_float32_value_of_the_parameter():
    b = torch.tensor([0.1, -1.7, 3.3]).bfloat16()
    cw = K.CMConv(torch.zeros((3, 2, 1, 1), dtype=torch.bfloat16), b)
    assert cw.bias.dtype == torch.float32
    assert torch.equal(cw.bias, b.float())
    x = torch.zeros((1, 2, 2, 2), dtype=torch.bfloat16)
    y = K.conv1x1_cmajor(x, cw, act=None)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y[0, :, 0, 0], b)
