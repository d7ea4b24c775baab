"""The DER blocks' ``"xla_q8"`` deploy mode and its kernels (rows 11 / 12 of
the kernel table) against the JAX package, on the CPU, where K4 / K5 take
their plain versions.

- The pixel-major wrappers (``ops/kernels/conv_pm.py``) vs the Pallas
  ``conv_pm.conv3x3_pm_q8`` / ``conv1x1_pm_q8`` in interpret mode, ReLU and
  the section list included: int8 outputs equal except +-1 LSB on at most
  1e-4 of the elements, bfloat16 within one bfloat16 ulp (or 1e-6 max|ref|
  near zero; ``test_torch_conv_q8_rest.assert_bf16_ulp``).
- One deploy DERBlock (c1 = 16, c2 = 24, 32 px, as
  tests/test_conv_kernel.py:144) in ``forward_xla_q8`` vs the JAX block
  under ``set_cmajor_deploy("xla_q8", scales)`` on the same weights and
  the same scales dict, in float32 and in bfloat16: the int8-resident
  chain gives the same bytes but for rare LSB flips (the int8 gate of one
  conv), so at least XLQ_EXACT of the output's elements are equal and the
  rest within DER_REL of max|ref| (about two bfloat16 ulps of the largest
  value); correlation above XLQ_CORR. (Measured: every element equal.)
- The tiny config at 64 px, fused, calibrated by the port and switched to
  ``set_der_fast("xla_q8", scales=)``, vs one jitted JAX forward in the
  "xla_q8" mode on the same weights and scales: per head level within
  NET_REL of max|ref| (the float layers around the block differ by float32
  rounding, measured 4.6e-7), correlation above XLQ_CORR; a negative
  control.
- A block whose scales are missing runs its regular deploy path; the
  mode refuses the int8 region; ``build_engine(der_fast="xla_q8")``
  serves.

The JAX global is restored in ``finally``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rep_yolo_tpu.nn.blocks as JB
from rep_yolo_tpu.models.model import RepYOLO as JaxRepYOLO
from rep_yolo_tpu.ops import quant as jax_quant
from rep_yolo_tpu.ops.pallas.conv_pm import conv1x1_pm_q8, conv3x3_pm_q8
from rep_yolo_tpu_torch.models.model import RepYOLO
from rep_yolo_tpu_torch.models.region import Q8Region
from rep_yolo_tpu_torch.nn import blocks as B
from rep_yolo_tpu_torch.ops.kernels import conv_flat as KC
from rep_yolo_tpu_torch.ops.kernels import conv_pm as KPM
from rep_yolo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from rep_yolo_tpu_torch.ops.quant import calibrate, quantize
from rep_yolo_tpu_torch.utils.weights import load_weights, state_dict_from_jax
from test_torch_bf16_slice import _bf16_tree, _numpy_variables, _rel_corr
from test_torch_conv_q8_rest import (_np, _qconv, assert_bf16_ulp,
                                     assert_int8_close)
from test_torch_int8_slice import TINY

DER_REL = 1e-2         # max |port - JAX| / max |JAX|, one DER block
NET_REL = 1e-3         # the same per head level of the tiny network
XLQ_CORR = 0.99999
XLQ_EXACT = 0.999      # share of the DER block's output elements equal


# ---------------------------------------------------------------------------
# rows 11 / 12: pixel-major on K4 / K5
# ---------------------------------------------------------------------------

# a subset of tests/test_conv_pm.py's shapes: the aligned tiled path, the
# whole-height 40x40 (deep-DER) geometry; ReLU on one
@pytest.mark.parametrize("B,C,O,H,W,rt,act", [
    (2, 16, 24, 16, 64, 8, "silu"),
    (1, 16, 16, 40, 40, None, "silu"),
    (1, 8, 8, 8, 320, 4, "relu"),
])
def test_conv3x3_pm_q8_plain_matches_jax(B, C, O, H, W, rt, act):
    rng = np.random.default_rng(H * W + C)
    x = rng.uniform(-1, 1, (B, H * W, C)).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, (3, 3, C, O)).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, (O,)).astype(np.float32)
    s_in = 1.0 / 127.0
    qw = _qconv(KC.QConv, w, bias)
    for xt in (torch.from_numpy(x), torch.from_numpy(x).bfloat16()):
        xj = jnp.asarray(_np(xt))
        if xt.dtype == torch.bfloat16:
            xj = xj.astype(jnp.bfloat16)
        got = KPM.conv3x3_pm_q8_plain(xt, qw, s_in, H, W, act)
        ref = conv3x3_pm_q8(xj, jnp.asarray(w), jnp.asarray(bias), s_in, H,
                            W, act=act, row_tile=rt)
        assert got.dtype == torch.bfloat16 and got.shape == (B, H * W, O)
        assert_bf16_ulp(_np(got), _np(ref))
    out_s = float(got.float().abs().max()) / 127.0
    got_q = KPM.conv3x3_pm_q8_plain(torch.from_numpy(x), qw, s_in, H, W, act,
                                    out_s)
    ref_q = conv3x3_pm_q8(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                          s_in, H, W, act=act, out_scale=out_s, row_tile=rt)
    assert_int8_close(got_q.numpy(), np.asarray(ref_q))
    if C == O:                       # the int8 chain, consumed at out_s
        got2 = KPM.conv3x3_pm_q8_plain(got_q, qw, out_s, H, W, act)
        ref2 = conv3x3_pm_q8(jnp.asarray(got_q.numpy()), jnp.asarray(w),
                             jnp.asarray(bias), out_s, H, W, act=act,
                             row_tile=rt)
        assert_bf16_ulp(_np(got2), _np(ref2))


@pytest.mark.parametrize("H,W,act", [(16, 64, "silu"), (40, 40, "relu")])
@pytest.mark.parametrize("int8_in", [False, True])
def test_conv1x1_pm_q8_sections_match_jax(H, W, act, int8_in):
    """tests/test_conv_pm.py::test_conv1x1_pm_q8_multi_input_equals_concat:
    three sections, one weight scale per output channel across them."""
    B, C, O = 2, 16, 24
    rng = np.random.default_rng(H + W)
    xs = [rng.uniform(-1, 1, (B, H * W, C)).astype(np.float32)
          for _ in range(3)]
    wc = rng.uniform(-0.5, 0.5, (1, 1, 3 * C, O)).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, (O,)).astype(np.float32)
    s_in = 1.0 / 127.0
    qw = _qconv(KC.QConv, wc, bias)
    xt = [torch.from_numpy(a) for a in xs]
    if int8_in:
        xt = [quantize(t, s_in) for t in xt]
    xj = [jnp.asarray(t.numpy()) for t in xt]
    got = KPM.conv1x1_pm_q8_plain(xt, qw, s_in, act)
    ref = conv1x1_pm_q8(xj, jnp.asarray(wc), jnp.asarray(bias), s_in,
                        act=act)
    assert_bf16_ulp(_np(got), _np(ref))
    got_q = KPM.conv1x1_pm_q8_plain(xt, qw, s_in, act, 0.03)
    ref_q = conv1x1_pm_q8(xj, jnp.asarray(wc), jnp.asarray(bias), s_in,
                          act=act, out_scale=0.03)
    assert_int8_close(got_q.numpy(), np.asarray(ref_q))


# ---------------------------------------------------------------------------
# the DER block and the network
# ---------------------------------------------------------------------------

class _One:
    """``jax_quant.calibrate``'s model interface over a lone flax module."""

    def __init__(self, mod):
        self.mod = mod

    def apply(self, variables, x, train=False):
        return self.mod.apply(variables, x, train=train)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_der_block_xla_q8_matches_jax(dtype):
    c1, c2, H = 16, 24, 32
    jder = JB.DERBlock(c1, c2, deploy=True, name="der")
    x = np.random.default_rng(1).uniform(-1, 1, (2, H, H, c1)).astype(
        np.float32)
    variables = _numpy_variables(jder, jnp.asarray(x), 2)
    # a top-level block's scope path is empty: _fast_deploy looks its
    # scales up under "/<conv>", calibrate reports "<conv>"
    scales = {"/" + k: v for k, v in jax_quant.calibrate(
        _One(jder), variables, [jnp.asarray(x)]).items()}
    assert len(scales) == 13, sorted(scales)
    xj = jnp.asarray(x)
    if dtype == "bfloat16":
        variables, xj = _bf16_tree(variables), xj.astype(jnp.bfloat16)
    regular = jder.apply(variables, xj, train=False)
    try:
        JB.set_cmajor_deploy("xla_q8", scales, select=lambda c, h, w: True)
        ref = jder.apply(variables, xj, train=False)
    finally:
        JB.set_cmajor_deploy(None)
    assert ref.dtype == xj.dtype
    assert not np.array_equal(_np(ref), _np(regular))    # the fast path ran

    der = B.DERBlock(c1, c2, deploy=True).eval()
    load_weights(der, state_dict_from_jax(variables))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    if dtype == "bfloat16":
        der.to(torch.bfloat16)
        xt = xt.bfloat16()
    sc = B.DERBlock.q8_scales(scales, "")
    reset_launch_counts()
    got = der.forward_xla_q8(xt, der.q8_weights(sc), sc)
    assert sum(launch_counts().values()) == 0             # plain on the CPU
    assert got.dtype == xt.dtype and got.shape == (2, c2, H, H)
    g, r = _np(got.permute(0, 2, 3, 1)), _np(ref)
    rel, corr = _rel_corr(got.permute(0, 2, 3, 1), ref)
    exact = float((g == r).mean())
    assert rel < DER_REL and corr > XLQ_CORR and exact >= XLQ_EXACT, \
        (rel, corr, exact)
    # the output is the bfloat16 rounding of the float32 epilogue
    assert torch.equal(got.bfloat16().to(got.dtype), got)


def test_der_block_without_scales_runs_the_regular_path():
    m = RepYOLO.from_config(TINY, device="cpu").init(
        torch.Generator().manual_seed(0)).fuse()
    x = torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    ref = m.apply(x)
    scales = calibrate(m, [x])
    m.net.set_der_fast("xla_q8", scales={k: v for k, v in scales.items()
                                         if "stage4" not in k})
    assert all(torch.equal(a, b) for a, b in zip(m.apply(x), ref))
    m.net.set_der_fast("xla_q8", scales=scales)
    assert not all(torch.equal(a, b) for a, b in zip(m.apply(x), ref))
    with pytest.raises(RuntimeError):                    # one mode switch
        m.net.set_q8(Q8Region(scales))
    m.net.set_der_fast(None)
    m.net.set_q8(Q8Region(scales))
    with pytest.raises(RuntimeError):
        m.net.set_der_fast("xla_q8", scales=scales)
    with pytest.raises(ValueError):
        m.net.set_der_fast("q8")


@pytest.fixture(scope="module")
def tiny_xla_q8():
    """The tiny graph at 64 px: the port fused and calibrated on the images,
    one jitted JAX forward in the "xla_q8" mode with the same scales, and
    one in the regular mode (which the "xla_q8" forward must differ from,
    or its scale keys missed and the JAX block ran its regular path)."""
    jmodel = JaxRepYOLO.from_config(TINY)
    variables = _numpy_variables(jmodel.net, jnp.zeros((1, 64, 64, 3)), 0,
                                 gain=2.0)
    jdeploy, jfused = jmodel.fuse(variables)
    x = np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    port = RepYOLO.from_config(TINY, device="cpu").load_state(
        state_dict_from_jax(variables)).fuse()
    scales = calibrate(port, [torch.from_numpy(x)])
    regular = jax.jit(lambda v, xs: jdeploy.net.apply(v, xs, train=False))(
        jfused, jnp.asarray(x))
    try:
        JB.set_cmajor_deploy("xla_q8", scales)
        ref = jax.jit(lambda v, xs: jdeploy.net.apply(v, xs, train=False))(
            jfused, jnp.asarray(x))
    finally:
        JB.set_cmajor_deploy(None)
    port.net.set_der_fast("xla_q8", scales=scales)
    return port, torch.from_numpy(x), ref, regular


def _levels(port, x, ref):
    return [_rel_corr(g, r) for g, r in zip(port.apply(x), ref)]


def test_tiny_xla_q8_matches_jax(tiny_xla_q8, monkeypatch):
    port, x, ref, regular = tiny_xla_q8
    # the JAX reference ran its int8 DER block: it differs from the regular
    # forward by more than the bound below at one level at least
    gaps = [_rel_corr(a, b)[0] for a, b in zip(ref, regular)]
    print("JAX xla_q8 vs regular per level (max err / max|ref|):", gaps)
    assert max(gaps) >= NET_REL, gaps
    calls = []
    fwd = B.DERBlock.forward_xla_q8
    monkeypatch.setattr(B.DERBlock, "forward_xla_q8",
                        lambda self, *a: calls.append(1) or fwd(self, *a))
    reset_launch_counts()
    levels = _levels(port, x, ref)
    assert sum(launch_counts().values()) == 0
    assert len(calls) == 1                                # l2, the one DER
    print("xla_q8 gap to JAX per level (max err / max|ref|, corr):", levels)
    for rel, corr in levels:
        assert rel < NET_REL and corr > XLQ_CORR, levels


def test_tiny_xla_q8_negative_control(tiny_xla_q8):
    """One DER weight perturbed (l2 cv1, output channel 0, input channel 0,
    by 1.0) fails the bound."""
    port, x, ref, _ = tiny_xla_q8
    w = port.net.model[2].cv1.conv.weight
    saved = w.detach().clone()
    scales = port.net.der_scales
    try:
        with torch.no_grad():
            w[0, 0] += 1.0
        port.net.set_der_fast("xla_q8", scales=scales)   # requantize
        levels = _levels(port, x, ref)
    finally:
        with torch.no_grad():
            w.copy_(saved)
        port.net.set_der_fast("xla_q8", scales=scales)
    assert any(rel >= NET_REL or corr <= XLQ_CORR for rel, corr in levels), \
        levels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xla_q8_serving_engine_on_cpu(dtype):
    from rep_yolo_tpu_torch.serve import build_engine

    engine = build_engine(TINY, None, 64, 2, conf=0.01, iou=0.45,
                          device="cpu", dtype=dtype, der_fast="xla_q8")
    try:
        net = engine.model.net
        assert net.der_fast == "xla_q8" and engine.dtype == dtype
        assert B.DERBlock.q8_scales(net.der_scales, "l2") is not None
        assert net.der_fast_declined() == []
        imgs = np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 3)).astype(
            np.float32)
        dets = engine(imgs)
        assert len(dets) == 2
        assert all(len(r) == 6 for d in dets for r in d)
        assert dets == engine(imgs)
    finally:
        engine.close()


def test_xla_q8_serving_engine_refuses_missing_scales(monkeypatch):
    """A DER block that finds no scales would run its regular path under a
    health report that says xla_q8: build_engine raises instead."""
    from rep_yolo_tpu_torch import serve

    def partial(model, batches):
        return {k: v for k, v in calibrate(model, batches).items()
                if "stage4" not in k}

    monkeypatch.setattr(serve, "calibrate", partial)
    with pytest.raises(ValueError, match=r"layers \[2\]"):
        serve.build_engine(TINY, None, 64, 2, conf=0.01, iou=0.45,
                           device="cpu", der_fast="xla_q8")
