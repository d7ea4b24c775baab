"""Kernel-table rows 3 and 13 in the port, on the CPU, where K2 and K12 take
their plain versions.

- Row 3 (``axial_attention.py:criss_cross_fused`` / ``vertical_fused``): K2
  ``attend`` on q, k, v from numpy against the JAX functions in interpret
  mode; and the route, the train-form attention blocks (and a CCVA) in
  ``eval()`` with ``fused`` on, against the JAX blocks under
  ``set_fused_attention(True)``, as ``tests/test_axial_fused.py:35-66``
  holds them (atol 2e-5, rtol 1e-4, that test's own tolerance). The train
  forward never takes the kernel.
- Row 13 (``neck_flat.py:dwconv5x5_flat_q8``): K12's plain version against
  the JAX kernel in interpret mode, as ``tests/test_neck_flat.py:45-59``
  calls it: the float output within rtol = atol = 2e-2 (JAX rounds it to
  bfloat16, the port keeps float32), the int8-resident output within
  +-1 LSB.
- The int8 tiny forward with ``Q8Region(dw5_dense=False)`` against the JAX
  one under ``set_dw5_dense(False)`` (one JAX forward in interpret mode):
  the plans agree, the depthwise 5x5 calls go to K12, and every in-region
  int8 map within +-1 LSB on the shares ``tests/test_torch_int8_neck_slice
  .py`` allows.

The JAX globals are set and restored in ``finally``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rep_yolo_tpu.nn.blocks as JB
from rep_yolo_tpu.models import network as jax_net
from rep_yolo_tpu.ops.pallas import axial_attention as JA
from rep_yolo_tpu.ops.pallas import neck_flat as JNF
from rep_yolo_tpu_torch.models.network import DetectionNet
from rep_yolo_tpu_torch.models.region import Q8Region
from rep_yolo_tpu_torch.nn import blocks as B
from rep_yolo_tpu_torch.ops import neck_flat as NF
from rep_yolo_tpu_torch.ops.kernels import axial_attention as KA
from rep_yolo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from rep_yolo_tpu_torch.ops.kernels import neck_flat as KNF
from rep_yolo_tpu_torch.ops.quant import calibrate
from rep_yolo_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_int8_neck_slice import (SHARE_AFTER_ISLAND,
                                        SHARE_BEFORE_ISLAND, _first_island,
                                        _int8_shares)
from test_torch_int8_slice import TINY, _jax_and_port

ATTN_TOL = dict(atol=2e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# row 3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("criss_cross,h,w", [(True, 12, 10), (False, 10, 12),
                                             (True, 8, 8)])
def test_attend_matches_jax_row3(criss_cross, h, w):
    rng = np.random.default_rng(h * w)
    c = 16
    q, k = (rng.uniform(0, 2, (2, h, w, c // 8)).astype(np.float32)
            for _ in range(2))
    v = rng.uniform(0, 3, (2, h, w, c)).astype(np.float32)
    x = rng.normal(0, 1, (2, h, w, c)).astype(np.float32)
    gamma = np.asarray([0.7], np.float32)
    fn = JA.criss_cross_fused if criss_cross else JA.vertical_fused
    ref = np.asarray(fn(*(jnp.asarray(a) for a in (q, k, v, x, gamma))))
    reset_launch_counts()
    got = KA.attend(*(torch.from_numpy(a) for a in (q, k, v, x, gamma)),
                    criss_cross)
    assert sum(launch_counts().values()) == 0
    np.testing.assert_allclose(got.numpy(), ref, **ATTN_TOL)


def _jax_block(module, c1, h, w, seed):
    x = jax.random.normal(jax.random.PRNGKey(seed), (2, h, w, c1),
                          jnp.float32)
    variables = dict(module.init(jax.random.PRNGKey(seed + 1), x, False))
    rng = np.random.default_rng(seed)
    variables["batch_stats"] = jax.tree.map(lambda a: jnp.asarray(
        rng.uniform(0.5, 1.5, a.shape).astype(np.float32)),
        variables["batch_stats"])
    variables["params"] = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.full_like(a, 0.7) if p[-1].key == "gamma" else a,
        variables["params"])
    try:
        JB.set_fused_attention(True)
        ref = module.apply(variables, x, False)
    finally:
        JB.set_fused_attention(False)
    return np.array(x), variables, np.array(ref)


@pytest.mark.parametrize("kind,c1,h,w", [("criss_cross", 16, 12, 10),
                                         ("vertical", 16, 10, 12),
                                         ("ccva", 32, 8, 8)])
def test_row3_route_matches_jax(kind, c1, h, w, monkeypatch):
    if kind == "ccva":
        jmod, port = JB.CCVA(c1), B.CCVA(c1, c1)
    else:
        cc = kind == "criss_cross"
        jmod = (JB.CrissCrossAttention if cc else JB.VerticalAttention)(c1)
        port = B.AxialAttention(c1, cc)
    x, variables, ref = _jax_block(jmod, c1, h, w, c1 + h)
    state = state_dict_from_jax(variables)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    blocks = [m for m in port.modules() if isinstance(m, B.AxialAttention)]
    for m in blocks:
        m.fused = True
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    calls = []
    attend = KA.attend
    monkeypatch.setattr(KA, "attend",
                        lambda *a: calls.append(a[-1]) or attend(*a))
    with torch.no_grad():
        got = port.eval()(xt).permute(0, 2, 3, 1).numpy()
        assert len(calls) == len(blocks)                 # the route ran
        np.testing.assert_allclose(got, ref, **ATTN_TOL)
        # the einsum path on the same weights agrees too
        for m in blocks:
            m.fused = False
        plain = port(xt).permute(0, 2, 3, 1).numpy()
    assert len(calls) == len(blocks)
    np.testing.assert_allclose(plain, ref, **ATTN_TOL)
    # the train forward never takes the kernel
    for m in blocks:
        m.fused = True
    port.train()(xt)
    assert len(calls) == len(blocks)


def test_set_fused_attention_is_held_per_network():
    from rep_yolo_tpu_torch.models.config import parse_config

    a, b = (DetectionNet(parse_config(TINY)) for _ in range(2))
    a.set_fused_attention(True)
    att = [m for m in a.modules() if isinstance(m, B.AxialAttention)]
    assert att and all(m.fused for m in att)
    assert all(m.fused is None for m in b.modules()
               if isinstance(m, B.AxialAttention))
    m = att[0].eval()
    assert m._use_fused(torch.zeros(1, 8, 4, 4))
    assert m._use_fused(torch.zeros(1, 8, 64, 64))        # every size
    assert not m.train()._use_fused(torch.zeros(1, 8, 4, 4))
    m.eval().fused = None           # the default: on for CUDA tensors only
    assert not m._use_fused(torch.zeros(1, 8, 4, 4))


# ---------------------------------------------------------------------------
# row 13
# ---------------------------------------------------------------------------

def _flat(x_nhwc):
    b, h, w, c = x_nhwc.shape
    return jnp.transpose(x_nhwc, (0, 3, 1, 2)).reshape(b, c, h * w)


def _nhwc(x_flat, h, w):
    b, c, _ = x_flat.shape
    return np.asarray(x_flat, np.float32).reshape(b, c, h, w).transpose(
        0, 2, 3, 1)


@pytest.mark.parametrize("c,h,w", [(32, 16, 16), (64, 8, 12), (12, 5, 7)])
@pytest.mark.parametrize("act", ["silu", None])
def test_dw5_f32w_plain_matches_jax_row13(c, h, w, act):
    rng = np.random.default_rng(c * h + w)
    x = rng.normal(0, 1, (2, h, w, c)).astype(np.float32)
    wk = (rng.normal(0, 1, (5, 5, 1, c)) * 0.1).astype(np.float32)
    bias = (rng.normal(0, 1, (c,)) * 0.1).astype(np.float32)
    s_in = float(np.abs(x).max()) / 127.0
    xq = np.clip(np.round(x / s_in), -127, 127).astype(np.int8)
    qd = KNF.QDepthwiseF32(torch.from_numpy(wk.transpose(3, 2, 0, 1).copy()),
                           torch.from_numpy(bias),
                           torch.full((c,), s_in))
    xt = torch.from_numpy(xq)
    ref = _nhwc(JNF.dwconv5x5_flat_q8(_flat(jnp.asarray(xq)), wk, bias,
                                      s_in, h, w, act=act), h, w)
    reset_launch_counts()
    got = KNF.dwconv5x5_f32w_q8(xt, qd, act)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-2, atol=2e-2)
    out_s = float(np.abs(ref).max()) / 127.0
    ref_q = _nhwc(JNF.dwconv5x5_flat_q8(_flat(jnp.asarray(xq)), wk, bias,
                                        s_in, h, w, act=act,
                                        out_scale=out_s), h, w)
    got_q = KNF.dwconv5x5_f32w_q8(xt, qd, act, out_s)
    assert got_q.dtype == torch.int8
    d = np.abs(got_q.numpy().astype(np.int32) - ref_q.astype(np.int32))
    assert d.max() <= 1, (int(d.max()), float((d > 0).mean()))
    assert sum(launch_counts().values()) == 0


@pytest.fixture(scope="module")
def tiny_dw5():
    """The tiny graph at 64 px with the neck region on and the depthwise
    5x5 on its exact-weight kernel: one JAX forward in interpret mode under
    ``set_dw5_dense(False)``, and the port on the same weights and scales."""
    jdeploy, jfused, port = _jax_and_port(TINY, 0)
    x = np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    scales = calibrate(port, [torch.from_numpy(x)])
    try:
        JB.set_cmajor_deploy("q8", scales)
        JNF.set_dw5_dense(False)
        ref, state = jdeploy.net.apply(jfused, jnp.asarray(x), train=False,
                                       capture_intermediates=True,
                                       mutable=["intermediates"])
        ref_plan = dict(jax_net.LAST_REGION_PLAN)
    finally:
        JNF.set_dw5_dense(True)
        JB.set_cmajor_deploy(None)
    inter = {int(k[1:]): v["__call__"][0]
             for k, v in state["intermediates"].items() if k[1:].isdigit()}
    return port, x, scales, ref, ref_plan, inter


def test_tiny_neck_with_exact_dw5_matches_jax(tiny_dw5, monkeypatch):
    port, x, scales, ref, ref_plan, inter = tiny_dw5
    seen, k12, k7 = {}, [], []
    run_q8 = DetectionNet._run_q8

    def record(self, spec, mod, step, inp):
        seen[spec.i] = run_q8(self, spec, mod, step, inp)
        return seen[spec.i]

    f32w, q8 = KNF.dwconv5x5_f32w_q8, KNF.dwconv5x5_q8
    monkeypatch.setattr(DetectionNet, "_run_q8", record)
    monkeypatch.setattr(KNF, "dwconv5x5_f32w_q8",
                        lambda *a, **k: k12.append(1) or f32w(*a, **k))
    monkeypatch.setattr(KNF, "dwconv5x5_q8",
                        lambda *a, **k: k7.append(1) or q8(*a, **k))
    port.net.set_q8(Q8Region(scales, dw5_dense=False))
    reset_launch_counts()
    try:
        got = port.apply(torch.from_numpy(x))
        assert port.net.region_plan == ref_plan
    finally:
        port.net.set_q8(None)
    assert sum(launch_counts().values()) == 0            # plain versions
    assert k12 and not k7, (len(k12), len(k7))
    shares = _int8_shares(seen, inter)
    assert len(shares) >= 8, shares
    island = _first_island(TINY)
    for i, (dmax, share) in shares.items():
        assert dmax <= 1, (i, shares)
        assert share <= (SHARE_BEFORE_ISLAND if i < island
                         else SHARE_AFTER_ISLAND), (i, shares)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32),
                                   atol=1e-2, rtol=1e-2)


def test_dw5_dense_switch_keeps_k7_by_default():
    """``Q8Region``'s default keeps K7, so ``--fast int8`` does not move;
    ``set_q8`` hands the switch to every depthwise 5x5 of the network."""
    from rep_yolo_tpu_torch.models.config import parse_config

    assert Q8Region({}).dw5_dense
    conv = torch.nn.Conv2d(8, 8, 5, padding=2, groups=8)
    xq = NF.Q8Map(torch.zeros((1, 4, 4, 8), dtype=torch.int8), 0.1)
    assert isinstance(NF.quantized({}, "a", conv, xq), KNF.QDepthwise)
    net = DetectionNet(parse_config(TINY), deploy=True)
    dw = [m for m in net.modules()
          if isinstance(m, torch.nn.Conv2d) and NF.is_dw5(m)]
    assert dw
    for dense, kind in ((False, KNF.QDepthwiseF32), (True, KNF.QDepthwise)):
        net.set_q8(Q8Region({}, dw5_dense=dense))
        assert all(m.dw5_dense is dense for m in dw)
        x = NF.Q8Map(torch.zeros((1, 4, 4, dw[0].in_channels),
                                 dtype=torch.int8), 0.1)
        assert isinstance(NF.quantized({}, "cv2", dw[0], x), kind)
