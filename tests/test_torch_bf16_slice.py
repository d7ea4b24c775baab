"""Port parity for bfloat16 fused-deploy serving with the DER blocks' "bf16"
fast path (the JAX ``bench.py`` casts its fused tree to bfloat16;
``set_cmajor_deploy("bf16")`` routes the DER blocks to the channel-major
kernels), on the CPU, where K10 / K11 take their plain versions.

- A deploy DERBlock in bfloat16: the port's ``forward_cm`` against the JAX
  block under ``set_cmajor_deploy("bf16", select=all)`` (interpret mode) on
  the same weights, at the JAX test's own bound for the 13-conv chain
  (tests/test_conv_kernel.py:176-183): max error < 2e-2 max|ref|, and a
  correlation above 0.99.
- The tiny config at 64 px, fused and cast to bfloat16 with ``der_fast``,
  against one jitted JAX bfloat16 fused forward in the "bf16" DER mode on
  the same weights (numpy-random at twice the default kernel scale, so that
  the head sees the DER block; every attention gamma 0.5, so that the
  islands count): per head level, max error < 2e-2 max|ref| and a
  correlation above 0.999. The port keeps its attention islands in float32
  where the JAX package runs bfloat16 einsums; the gap with the islands
  forced to bfloat16 is measured beside it. A negative control: one DER
  weight perturbed fails the bound.
- bfloat16 raw maps decode to what their float32 upcast decodes to.
- ``build_engine(dtype=torch.bfloat16, der_fast="bf16")`` serves a batch.

The JAX global is restored in ``finally``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rep_yolo_tpu.nn.blocks as JB
from rep_yolo_tpu.models.model import RepYOLO as JaxRepYOLO
from rep_yolo_tpu_torch.models import heads
from rep_yolo_tpu_torch.models.model import RepYOLO
from rep_yolo_tpu_torch.models.region import Q8Region
from rep_yolo_tpu_torch.nn import blocks as B
from rep_yolo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from rep_yolo_tpu_torch.utils.weights import load_weights, state_dict_from_jax
from test_torch_int8_slice import TINY

REL_BOUND = 2e-2       # max |port - JAX| / max |JAX|
CORR_DER = 0.99        # the JAX test's own, for one DER block
CORR_NET = 0.999       # per head level of the tiny network


def _numpy_variables(module, x, seed, gain=1.0):
    """Variables of a flax module, shapes by ``jax.eval_shape`` (no XLA
    compile), values from numpy: kernels U(-gain, gain)/sqrt(fan_in), BN scales
    and variances U(0.5, 1.5), ``im_*`` near 1, attention gammas 0.5, the
    rest small normals."""
    shapes = jax.eval_shape(lambda r: module.init({"params": r}, x,
                                                  train=False),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        k = path[-1].key
        if k == "kernel":
            a = rng.uniform(-gain, gain, s.shape) \
                / np.sqrt(np.prod(s.shape[:-1]))
        elif k in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, s.shape)
        elif k == "gamma":
            a = np.full(s.shape, 0.5)
        elif k.startswith("im_"):
            a = 1.0 + 0.02 * rng.standard_normal(s.shape)
        else:
            a = 0.1 * rng.standard_normal(s.shape)
        return jnp.asarray(a, s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _bf16_tree(tree):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                        if a.dtype == jnp.float32 else a, tree)


def _np(t):
    if torch.is_tensor(t):
        return t.detach().float().numpy().ravel()
    return np.asarray(t.astype(jnp.float32)).ravel()


def _rel_corr(got, ref):
    g, r = _np(got), _np(ref)
    return (float(np.abs(g - r).max() / np.abs(r).max()),
            float(np.corrcoef(g, r)[0, 1]))


def test_der_block_bf16_fast_path_matches_jax():
    c1, c2, H = 16, 24, 32
    jder = JB.DERBlock(c1, c2, deploy=True, name="der")
    x = np.random.default_rng(1).uniform(-1, 1, (2, H, H, c1)).astype(
        np.float32)
    variables = _bf16_tree(_numpy_variables(jder, jnp.asarray(x), 2))
    xb = jnp.asarray(x, jnp.bfloat16)
    try:
        JB.set_cmajor_deploy("bf16", select=lambda c, h, w: True)
        ref = jder.apply(variables, xb, train=False)
    finally:
        JB.set_cmajor_deploy(None)
    assert ref.dtype == jnp.bfloat16

    der = B.DERBlock(c1, c2, deploy=True).eval()
    load_weights(der, state_dict_from_jax(variables))
    der.to(torch.bfloat16)
    xt = torch.from_numpy(x).bfloat16().permute(0, 3, 1, 2).contiguous()
    reset_launch_counts()
    got = der.forward_cm(xt, der.cm_weights())
    assert sum(launch_counts().values()) == 0             # plain on the CPU
    assert got.dtype == torch.bfloat16
    rel, corr = _rel_corr(got.permute(0, 2, 3, 1), ref)
    assert rel < REL_BOUND and corr > CORR_DER, (rel, corr)
    # and the port's own regular bf16 deploy path (cuDNN / CPU convs)
    rel, corr = _rel_corr(got, der(xt))
    assert rel < REL_BOUND and corr > CORR_DER, (rel, corr)


@pytest.fixture(scope="module")
def tiny_bf16():
    """The tiny graph at 64 px: one jitted JAX bfloat16 forward in the "bf16"
    DER mode, and the port on the same weights, fused and cast to bfloat16
    with ``der_fast``."""
    jmodel = JaxRepYOLO.from_config(TINY)
    # kernels at twice the default scale: at 1x the maps shrink layer by
    # layer and the head barely sees the DER block (the negative control
    # below moved them by under one bfloat16 ulp)
    variables = _numpy_variables(jmodel.net, jnp.zeros((1, 64, 64, 3)), 0,
                                 gain=2.0)
    jdeploy, jfused = jmodel.fuse(variables)
    x = np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    try:
        JB.set_cmajor_deploy("bf16")
        ref = jax.jit(lambda v, xs: jdeploy.net.apply(v, xs, train=False))(
            _bf16_tree(jfused), jnp.asarray(x, jnp.bfloat16))
    finally:
        JB.set_cmajor_deploy(None)
    port = RepYOLO.from_config(TINY, device="cpu").load_state(
        state_dict_from_jax(variables)).fuse().cast(torch.bfloat16)
    port.net.set_der_fast("bf16")
    return port, torch.from_numpy(x).bfloat16(), ref


def _levels(port, x, ref):
    return [_rel_corr(g, r) for g, r in zip(port.apply(x), ref)]


def test_tiny_bf16_der_fast_matches_jax(tiny_bf16, monkeypatch):
    port, x, ref = tiny_bf16
    calls = []
    forward_cm = B.DERBlock.forward_cm
    monkeypatch.setattr(B.DERBlock, "forward_cm",
                        lambda self, *a: calls.append(1) or forward_cm(
                            self, *a))
    reset_launch_counts()
    maps = port.apply(x)
    assert sum(launch_counts().values()) == 0
    assert len(calls) == 1                                # l2, the one DER
    assert all(m.dtype == torch.bfloat16 for m in maps)
    # the islands ran in float32, the layers around them in bfloat16
    assert next(port.net.model[13].parameters()).dtype == torch.float32
    assert next(port.net.model[12].parameters()).dtype == torch.bfloat16
    for rel, corr in _levels(port, x, ref):
        assert rel < REL_BOUND and corr > CORR_NET, (rel, corr)


def test_tiny_bf16_gap_with_islands_forced_to_bf16(tiny_bf16):
    """The f32 islands are a deliberate difference from the JAX package's
    bfloat16 einsums: the gap to JAX with the port's islands in float32 and
    with them forced to bfloat16 (the plain attention in bfloat16 on the
    CPU; K1 / K2 take float32 only), each within the bound."""
    port, x, ref = tiny_bf16
    gaps = {}
    try:
        for name, dt in (("islands_f32", torch.float32),
                         ("islands_bf16", torch.bfloat16)):
            port.net.cast(torch.bfloat16, island_dtype=dt)
            gaps[name] = _levels(port, x, ref)
    finally:
        port.net.cast(torch.bfloat16)
    print("bf16 gap to JAX per level (max err / max|ref|, corr):", gaps)
    for levels in gaps.values():
        for rel, corr in levels:
            assert rel < REL_BOUND and corr > CORR_NET, gaps


def test_tiny_bf16_negative_control_perturbed_der_weight(tiny_bf16):
    """One DER weight perturbed (l2 cv1, output channel 0, input channel 0,
    by 1.0) fails the bound."""
    port, x, ref = tiny_bf16
    w = port.net.model[2].cv1.conv.weight
    saved = w.detach().clone()
    try:
        with torch.no_grad():
            w[0, 0] += 1.0
        port.net.set_der_fast("bf16")             # repack the weights
        levels = _levels(port, x, ref)
    finally:
        with torch.no_grad():
            w.copy_(saved)
        port.net.set_der_fast("bf16")
    assert any(rel >= REL_BOUND or corr <= CORR_NET for rel, corr in levels), \
        levels


def test_bf16_maps_decode_as_their_float32_upcast():
    model = RepYOLO.from_config(TINY, device="cpu")
    g = torch.Generator().manual_seed(0)
    maps = [(3 * torch.randn((2, s, s, 3, 6), generator=g)).bfloat16()
            for s in (8, 4, 2)]
    up = [m.float() for m in maps]
    for fn in (lambda ps: heads.decode_predictions(ps, model.anchors_px,
                                                   model.strides),
               lambda ps: heads.decode_topk(ps, model.anchors_px,
                                            model.strides, k=64,
                                            conf_thres=0.01)):
        got, want = fn(maps), fn(up)
        assert got.dtype == torch.float32
        assert torch.equal(got, want)


def test_der_fast_and_cast_refuse_other_modes():
    train = RepYOLO.from_config(TINY, device="cpu")
    with pytest.raises(RuntimeError):
        train.net.set_der_fast("bf16")                   # train form
    with pytest.raises(RuntimeError):
        train.cast(torch.bfloat16)
    m = train.init(torch.Generator().manual_seed(0)).fuse()
    with pytest.raises(ValueError):
        m.net.set_der_fast("q8")
    m.net.set_der_fast("bf16")
    with pytest.raises(RuntimeError):                    # one mode switch
        m.net.set_q8(Q8Region({}))
    m.net.set_der_fast(None)
    m.net.set_q8(Q8Region({}))
    with pytest.raises(RuntimeError):
        m.net.set_der_fast("bf16")
    with pytest.raises(RuntimeError):
        m.cast(torch.bfloat16)


def test_bf16_der_fast_serving_engine_on_cpu():
    from rep_yolo_tpu_torch.serve import build_engine

    engine = build_engine(TINY, None, 64, 2, conf=0.01, iou=0.45,
                          device="cpu", dtype=torch.bfloat16,
                          der_fast="bf16")
    try:
        assert engine.dtype == torch.bfloat16
        assert engine.model.net.der_fast == "bf16"
        imgs = np.random.default_rng(5).uniform(0, 1, (1, 64, 64, 3)).astype(
            np.float32)
        dets = engine(imgs)
        assert len(dets) == 1
        assert all(len(r) == 6 for r in dets[0])
        assert dets == engine(imgs)
    finally:
        engine.close()
    with pytest.raises(ValueError):
        build_engine(TINY, None, 64, 2, conf=0.01, iou=0.45, device="cpu",
                     fast="int8", dtype=torch.bfloat16)
