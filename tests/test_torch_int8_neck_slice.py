"""Port parity for the int8 neck and head (the JAX package's default
``--fast int8``: ``set_cmajor_deploy("q8", scales)`` with ``NECK_Q8`` on, and
the port's ``Q8Region(scales)``), on the CPU, where the port's kernel
wrappers take their plain versions.

- The region plan of the flagship at 640 px, traced with ``jax.eval_shape``,
  string for string over all 66 layers, with a scale for every key the
  planners read and with one neck scale missing.
- The tiny config at 64 px, one JAX forward in interpret mode on the same
  weights and scales: the plans agree; every in-region int8 map agrees
  within +-1 LSB, on at most 0.1 % of the elements up to the first float
  island (the backbone region's gate) and on at most 9 % after it (twice
  the 4.5 % measured at l18: the JAX package runs the attention islands,
  GSBottleneck's add and GSConv's float exit in bf16, the port in
  float32); the raw maps within
  atol = rtol = 1e-2 (bf16). A negative control: the same comparison with
  GSConv's shuffle left out fails.
- The int8 serving engine with the neck on the CPU.

The JAX globals are restored in ``finally``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rep_yolo_tpu.nn.blocks as JB
from rep_yolo_tpu.models import network as jax_net
from rep_yolo_tpu.models.model import RepYOLO as JaxRepYOLO
from rep_yolo_tpu.ops.pallas.neck_flat import FlatT
from rep_yolo_tpu_torch.models.config import parse_config
from rep_yolo_tpu_torch.models.network import DetectionNet
from rep_yolo_tpu_torch.models.region import Q8Region, plan_region
from rep_yolo_tpu_torch.ops import neck_flat as NF
from rep_yolo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from rep_yolo_tpu_torch.ops.quant import calibrate
from test_torch_int8_slice import FLAGSHIP, TINY, _jax_and_port

SHARE_BEFORE_ISLAND = 1e-3
SHARE_AFTER_ISLAND = 0.09


def _jax_plan(model, scales, size):
    x = jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32)

    def fwd(xs):
        v = model.net.init({"params": jax.random.PRNGKey(0)}, xs,
                           train=False)
        return model.net.apply(v, xs, train=False)

    try:
        JB.set_cmajor_deploy("q8", scales)
        jax.eval_shape(fwd, x)
        return dict(jax_net.LAST_REGION_PLAN)
    finally:
        JB.set_cmajor_deploy(None)


@pytest.fixture(scope="module")
def flagship():
    """The JAX deploy model and a scale for every conv of the flagship (the
    keys of its parameter tree, as ``calibrate`` names them)."""
    model = JaxRepYOLO.from_config(FLAGSHIP, deploy=True)
    shapes = jax.eval_shape(lambda r: model.net.init(
        {"params": r}, jnp.zeros((1, 64, 64, 3)), train=False),
        jax.random.PRNGKey(0))["params"]
    keys = []

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                p = path + [k]
                if "kernel" in v:       # a conv's scope: ".../w" or "m_i"
                    keys.append("/".join(p[:-1] if k == "w" else p))
                walk(v, p)

    walk(shapes, [])
    return model, {k: 0.01 for k in keys}


@pytest.mark.parametrize("drop", [None, "l14/gsb_0/gs1/cv1/conv"])
def test_flagship_neck_plan_matches_jax(flagship, drop):
    model, scales = flagship
    if drop is not None:
        assert drop in scales
        scales = {k: v for k, v in scales.items() if k != drop}
    ref = _jax_plan(model, scales, 640)
    got = plan_region(parse_config(FLAGSHIP), Q8Region(scales), 640,
                      640).strings
    assert got == ref
    if drop is None:
        assert got[9] == "neck entry quantize; in-region SPPCSPC -> int8"
        assert got[33] == "in-region GSConv -> int8"
        assert got[34] == "in-region concat (unmaterialized)"
        assert got[46] == "in-region flat int8 pool (neck)"
        assert [got[i] for i in (62, 63, 64)] == \
            ["in-region RepConv -> int8"] * 3
    else:
        assert 14 not in got                   # l14 leaves the region
        assert got[10] == "in-region GSConv -> NHWC exit"


@pytest.fixture(scope="module")
def tiny_run():
    """The tiny graph at 64 px: one JAX forward with the neck region on
    (interpret mode), its plan and per-layer outputs, and the port on the
    same weights and scales."""
    jdeploy, jfused, port = _jax_and_port(TINY, 0)
    x = np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    scales = calibrate(port, [torch.from_numpy(x)])
    try:
        JB.set_cmajor_deploy("q8", scales)
        ref, state = jdeploy.net.apply(jfused, jnp.asarray(x), train=False,
                                       capture_intermediates=True,
                                       mutable=["intermediates"])
        ref_plan = dict(jax_net.LAST_REGION_PLAN)
    finally:
        JB.set_cmajor_deploy(None)
    inter = {int(k[1:]): v["__call__"][0]
             for k, v in state["intermediates"].items() if k[1:].isdigit()}
    return port, x, scales, ref, ref_plan, inter


def _run_port(port, x, scales, monkeypatch):
    seen = {}
    run_q8 = DetectionNet._run_q8

    def record(self, spec, mod, step, inp):
        seen[spec.i] = run_q8(self, spec, mod, step, inp)
        return seen[spec.i]

    monkeypatch.setattr(DetectionNet, "_run_q8", record)
    port.net.set_q8(Q8Region(scales))
    got = port.apply(torch.from_numpy(x))
    monkeypatch.undo()
    return got, seen


def _int8_shares(seen, inter):
    """{layer: (max LSB difference, share of elements off)} of the int8
    maps both packages hold."""
    out = {}
    for i, m in seen.items():
        r = inter.get(i)
        if not isinstance(m, NF.Q8Map) or not isinstance(r, FlatT):
            continue
        B, h, w, C = m.data.shape
        assert (m.perm is None) == (r.perm is None), i
        rd = np.asarray(r.data).reshape(B, C, h, w).transpose(0, 2, 3, 1)
        d = np.abs(m.data.numpy().astype(np.int32) - rd.astype(np.int32))
        out[i] = (int(d.max()), float((d > 0).mean()))
    return out


def _first_island(cfg):
    return min(sp.i for sp in parse_config(cfg).layers
               if sp.name in ("CA", "CCVA", "ADD"))


def test_tiny_neck_matches_jax(tiny_run, monkeypatch):
    port, x, scales, ref, ref_plan, inter = tiny_run
    reset_launch_counts()
    got, seen = _run_port(port, x, scales, monkeypatch)
    assert sum(launch_counts().values()) == 0            # plain versions
    assert port.net.region_plan == ref_plan
    assert any("GSConv" in s for s in ref_plan.values())
    assert any("SPPCSPC" in s for s in ref_plan.values())
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


def test_tiny_neck_negative_control_without_shuffle(tiny_run, monkeypatch):
    """The comparison above, with GSConv's shuffle left out of the port
    (identity permutation), fails."""
    port, x, scales, ref, _, inter = tiny_run
    monkeypatch.setattr(NF, "gs_shuffle_perm",
                        lambda c2, device=None: torch.arange(c2).to(device))
    _, seen = _run_port(port, x, scales, monkeypatch)
    monkeypatch.undo()
    port.net.set_q8(None)
    shares = _int8_shares(seen, inter)
    assert any(dmax > 1 or share > SHARE_AFTER_ISLAND
               for dmax, share in shares.values()), shares


def test_head_with_a_float_level(tiny_run, monkeypatch):
    """Without l24/m_1's scale, l22 exits the region in float and the
    head's level 1 runs its float conv beside the int8 levels 0 and 2."""
    port, x, scales, _, _, _ = tiny_run
    scales = {k: v for k, v in scales.items() if k != "l24/m_1"}
    got, seen = _run_port(port, x, scales, monkeypatch)
    step = port.net.plan_for(64, 64).steps[24]
    port.net.set_q8(None)
    assert step.kind == "head" and step.raw == {21, 23}
    assert isinstance(seen[21], NF.Q8Map) and seen[22].dtype == torch.float32
    y = port.net.model[24].m[1](seen[22]).permute(0, 2, 3, 1)
    assert torch.equal(got[1], y.reshape(got[1].shape))


def test_int8_serving_engine_with_neck_on_cpu():
    from rep_yolo_tpu_torch.serve import build_engine

    engine = build_engine(TINY, None, 64, 2, conf=0.01, iou=0.45,
                          device="cpu", fast="int8")
    try:
        net = engine.model.net
        assert net.q8.neck
        imgs = np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 3)).astype(
            np.float32)
        dets = engine(imgs)
        assert len(dets) == 2
        kinds = {s.kind for s in net.plan_for(64, 64).steps.values()}
        assert {"flat", "concat", "upsample", "head"} <= kinds
        assert net.region_plan[8] == "in-region SPPCSPC -> int8"
        # the backbone-only mode on the same engine's scales
        net.set_q8(Q8Region(net.q8.scales, neck=False))
        engine(imgs)
        assert all(s.kind in ("stem", "der", "mp_fused", "mp_pool")
                   for s in net.plan_for(64, 64).steps.values())
    finally:
        engine.close()
