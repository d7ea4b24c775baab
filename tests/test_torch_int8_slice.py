"""Port parity for the int8 backbone region (the calibrated int8 mode with
the JAX package's neck region off, ``set_neck_q8(False)``, and the port's
``Q8Region(scales, neck=False)``), on the CPU, where the port's kernel
wrappers take their plain versions. The neck region is held against the JAX
package in tests/test_torch_int8_neck_slice.py.

- ``calibrate``: the tiny config at 64 px through both packages on the same
  weights: the same keys (JAX scope paths), values at rtol 1e-5.
- The region plan of the flagship at 640 px: the port's ``plan_region``
  against the JAX package's ``LAST_REGION_PLAN`` (through
  ``jax.eval_shape``, as tests/test_region_plan.py does it), string for
  string for l0-l8, with every scale and with l3's st1 scale missing.
- The int8 network at 64 px on the DER -> MP -> DER graph of
  tests/test_conv_flat.py::test_cm_pool_fuse_network_bitexact, with the
  same scales: the plans agree, the region's int8 maps agree (+-1 LSB on
  at most 0.1 %), and the region's float exit and the raw maps agree
  within atol = rtol = 1e-2 (the JAX region exits in bf16, the port in
  float32).
- The int8 serving engine on the CPU.

The JAX globals are restored in ``finally``.
"""

import logging
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rep_yolo_tpu.nn.blocks as JB
from rep_yolo_tpu.models import network as jax_net
from rep_yolo_tpu.models.model import RepYOLO as JaxRepYOLO
from rep_yolo_tpu.ops import quant as jax_quant
from rep_yolo_tpu_torch.models.config import parse_config
from rep_yolo_tpu_torch.models.model import RepYOLO
from rep_yolo_tpu_torch.models.region import Q8Region, Q8Map, plan_region
from rep_yolo_tpu_torch.nn.blocks import DER_CONVS
from rep_yolo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from rep_yolo_tpu_torch.ops.quant import calibrate, jax_scope
from rep_yolo_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_conv_q8 import assert_int8_close

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = str(ROOT / "cfg" / "rep_yolo_tiny_test.yaml")
FLAGSHIP = str(ROOT / "cfg" / "rep_yolo.yaml")
# tests/test_conv_flat.py::test_cm_pool_fuse_network_bitexact's graph: the
# flagship's stem -> DER -> MP -> DER backbone pattern
DER_MP_DER = {
    "nc": 1, "depth_multiple": 1.0, "width_multiple": 1.0,
    "anchors": [[10, 13, 16, 30, 33, 23]],
    "backbone": [
        [-1, 1, "RepS_Block", [8, 3, 2, 1]],   # 0 /2
        [-1, 1, "MP", []],                     # 1 /4
        [-1, 1, "DER_Block", [16, 1, 1]],      # 2
        [-1, 1, "MP", []],                     # 3 /8  <- fused
        [-1, 1, "DER_Block", [16, 1, 1]],      # 4
    ],
    "head": [
        [-1, 1, "Conv", [16, 1, 1]],           # 5
        [[-1], 1, "IDetect", ["nc", "anchors"]],  # 6
    ],
}


def _jax_and_port(cfg, seed, gain=1.0):
    """JAX init with numpy-random BN statistics (and conv kernels times
    ``gain``) -> (JAX deploy, fused variables, the port's fused model on
    the same weights)."""
    jmodel = JaxRepYOLO.from_config(cfg)
    variables = dict(jax.jit(lambda r: jmodel.net.init(
        {"params": r}, jnp.zeros((1, 64, 64, 3)), train=False))(
            jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    variables["batch_stats"] = jax.tree.map(lambda a: jnp.asarray(
        rng.uniform(0.5, 1.5, a.shape).astype(np.float32)),
        variables["batch_stats"])
    variables["params"] = jax.tree_util.tree_map_with_path(
        lambda path, a: a * gain if path[-1].key == "kernel" else a,
        variables["params"])
    jdeploy, jfused = jmodel.fuse(variables)
    port = RepYOLO.from_config(cfg, device="cpu").load_state(
        state_dict_from_jax(variables)).fuse()
    return jdeploy, jfused, port


def test_jax_scope_inverts_the_key_mapping():
    assert jax_scope("model.1.stage1.0.reparam_conv") == \
        "l1/stage1/reparam_conv"
    assert jax_scope("model.1.cv0_1.conv") == "l1/cv0_1/conv"
    assert jax_scope("model.14.gsb.0.conv_lighting.1.cv2.conv") == \
        "l14/gsb_0/gs2/cv2/conv"
    assert jax_scope("model.65.m.0") == "l65/m_0"
    assert jax_scope("model.21.m1") == "l21/m1"


def test_calibrate_matches_jax():
    jdeploy, jfused, port = _jax_and_port(TINY, 0)
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    ref = jax_quant.calibrate(jdeploy, jfused, [jnp.asarray(x)])
    got = calibrate(port, [torch.from_numpy(x)])
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def flagship_jax():
    """A scale for every conv the backbone planners read (each stem's and
    each DER's 13, under the port's key names: a wrong name makes the JAX
    planner decline where the port's does not), and a function that
    returns the JAX plan of the flagship at 640 px for a scales dict."""
    model = JaxRepYOLO.from_config(FLAGSHIP, deploy=True)
    x = jax.ShapeDtypeStruct((1, 640, 640, 3), jnp.float32)
    scales = {}
    for sp in parse_config(FLAGSHIP).layers:
        if sp.name == "RepS_Block":
            scales[f"l{sp.i}/reparam_conv"] = 0.01
        elif sp.name == "DER_Block":
            scales.update({f"l{sp.i}/{key}": 0.01 for _, _, key in DER_CONVS})

    def plan(scales):
        def fwd(xs):
            v = model.net.init({"params": jax.random.PRNGKey(0)}, xs,
                               train=False)
            return model.net.apply(v, xs, train=False)

        try:
            JB.set_neck_q8(False)
            JB.set_cmajor_deploy("q8", scales)
            jax.eval_shape(fwd, x)
            return dict(jax_net.LAST_REGION_PLAN)
        finally:
            JB.set_cmajor_deploy(None)
            JB.set_neck_q8(True)

    return scales, plan


def _port_plan(scales):
    return plan_region(parse_config(FLAGSHIP), Q8Region(scales, neck=False),
                       640, 640).strings


def test_flagship_plan_matches_jax(flagship_jax):
    scales, jax_plan = flagship_jax
    ref, got = jax_plan(scales), _port_plan(scales)
    assert set(ref) <= set(range(9)), ref
    assert got == ref
    # the decisions the int8 slice is built around
    assert got[0].startswith("region entry") and "st1(l1)" in got[0]
    assert got[2] == got[4] == "MP fused into producer cv1 epilogue"
    assert got[6] == "in-region flat int8 pool"
    assert got[7].endswith("NHWC bf16 out (no cm successor)")


def test_flagship_plan_missing_scale_matches_jax(flagship_jax, caplog):
    scales, jax_plan = flagship_jax
    scales = {k: v for k, v in scales.items()
              if not k.endswith("l3/stage1/reparam_conv")}
    ref = jax_plan(scales)
    with caplog.at_level(logging.WARNING,
                         logger="rep_yolo_tpu_torch.models.region"):
        got = _port_plan(scales)
    assert got == ref
    assert "st1(l3)" not in got[1], got[1]
    assert any("no st1 calibration scale" in r.message
               for r in caplog.records), [r.message for r in caplog.records]


def test_int8_network_matches_jax(monkeypatch):
    """The region's int8 maps (stem, pooled DER) agree with the JAX
    package's, its float exit and the raw maps within the bf16 tolerance.
    Conv kernels x2.5 keep the activations O(1) through the 13-conv DERs."""
    from rep_yolo_tpu_torch.models.network import DetectionNet

    jdeploy, jfused, port = _jax_and_port(DER_MP_DER, 2, gain=2.5)
    x = np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    scales = jax_quant.calibrate(jdeploy, jfused, [jnp.asarray(x)])
    try:
        JB.set_neck_q8(False)
        JB.set_cmajor_deploy("q8", scales)
        ref, state = jdeploy.net.apply(jfused, jnp.asarray(x), train=False,
                                       capture_intermediates=True,
                                       mutable=["intermediates"])
        ref_plan = dict(jax_net.LAST_REGION_PLAN)
    finally:
        JB.set_cmajor_deploy(None)
        JB.set_neck_q8(True)
    assert any("fused into cv1" in d for d in ref_plan.values()), ref_plan
    inter = {k: np.asarray(v["__call__"][0])
             for k, v in state["intermediates"].items() if k[1:].isdigit()}

    seen = {}
    run_q8 = DetectionNet._run_q8

    def record(self, spec, mod, step, inp):
        seen[spec.i] = run_q8(self, spec, mod, step, inp)
        return seen[spec.i]

    monkeypatch.setattr(DetectionNet, "_run_q8", record)
    port.net.set_q8(Q8Region(scales, neck=False))
    reset_launch_counts()
    got = port.apply(torch.from_numpy(x))
    assert sum(launch_counts().values()) == 0          # plain versions
    assert port.net.region_plan == ref_plan
    for i in (0, 2):                                   # int8 region maps
        m = seen[i]
        B, h, w, C = m.data.shape
        assert inter[f"l{i}"].dtype == jnp.int8
        assert_int8_close(m.data.numpy(), inter[f"l{i}"].reshape(
            B, C, h, w).transpose(0, 2, 3, 1))
    np.testing.assert_allclose(                        # the float exit
        seen[4].permute(0, 2, 3, 1).numpy(),
        inter["l4"].astype(np.float32), rtol=1e-2, atol=1e-2)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32),
                                   atol=1e-2, rtol=1e-2)


def test_region_maps_and_float_consumers():
    """Region tensors that a float layer reads are dequantized once; the
    int8 path runs again from the cached plan (the backbone region)."""
    model = RepYOLO.from_config(DER_MP_DER, device="cpu").init(
        torch.Generator().manual_seed(0)).fuse()
    x = torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    from rep_yolo_tpu_torch.ops.quant import enable_int8_fast_path

    scales = enable_int8_fast_path(model, x, neck=False)
    assert "l2/stage1/reparam_conv" in scales and "l6/m_0" in scales
    a = model.apply(x)
    plan = model.net.plan_for(64, 64)
    assert plan.steps[0].kind == "stem" and plan.steps[1].kind == "mp_pool"
    assert plan.steps[2].pool and plan.steps[4].out_scale is None
    b = model.apply(x)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    m = Q8Map(torch.full((1, 2, 2, 4), 3, dtype=torch.int8), 0.5)
    assert torch.equal(m.to_float(), torch.full((1, 4, 2, 2), 1.5))
    model.net.set_q8(None)
    assert model.net.region_plan == {}


def test_region_maps_and_float_consumers_neck_on():
    """With the neck on (the default), the same graph's l5 Conv enters the
    region on its own scale and emits int8 for the head, whose 1x1 runs in
    int8 with a float32 output; the plan is cached as before."""
    model = RepYOLO.from_config(DER_MP_DER, device="cpu").init(
        torch.Generator().manual_seed(0)).fuse()
    x = torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    from rep_yolo_tpu_torch.ops.quant import enable_int8_fast_path

    enable_int8_fast_path(model, x)
    a = model.apply(x)
    plan = model.net.plan_for(64, 64)
    assert plan.steps[4].out_scale is None                 # DER exits float
    assert plan.steps[5].kind == "flat" and plan.steps[5].s_in is not None
    assert plan.steps[6].kind == "head" and plan.steps[6].raw == {5}
    assert model.net.region_plan[5] == ("neck entry quantize; in-region Conv"
                                        " -> int8")
    b = model.apply(x)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_pool_gate_changes_only_the_plan_string(monkeypatch):
    """Where the JAX package's TPU pool gate declines, its plan string
    changes and the port still runs the int8 pool (K6 on the card)."""
    from rep_yolo_tpu_torch.models import region
    from rep_yolo_tpu_torch.ops.kernels import pool_flat as KP

    model = RepYOLO.from_config(DER_MP_DER, device="cpu").init(
        torch.Generator().manual_seed(0)).fuse()
    x = torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    from rep_yolo_tpu_torch.ops.quant import enable_int8_fast_path

    enable_int8_fast_path(model, x)
    a = model.apply(x)
    assert model.net.region_plan[1] == "in-region flat int8 pool"
    monkeypatch.setattr(region, "pool_supports", lambda c, h, w: False)
    pooled = []
    pool = KP.max_pool2_q8
    monkeypatch.setattr(KP, "max_pool2_q8",
                        lambda t: pooled.append(t.shape) or pool(t))
    model.net.set_q8(model.net.q8)
    b = model.apply(x)
    assert model.net.region_plan[1].startswith("in-region pool via "
                                               "max_pool_cm")
    assert model.net.plan_for(64, 64).steps[1].kind == "mp_pool"
    assert len(pooled) == 1
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_int8_serving_engine_on_cpu():
    from rep_yolo_tpu_torch.serve import build_engine, parse_args

    engine = build_engine(TINY, None, 64, 2, conf=0.01, iou=0.45,
                          device="cpu", fast="int8")
    try:
        imgs = np.random.default_rng(5).uniform(0, 1, (1, 64, 64, 3)).astype(
            np.float32)
        dets = engine(imgs)
        assert engine.model.net.region_plan[0].startswith("region entry")
        assert len(dets) == 1
    finally:
        engine.close()
    assert parse_args(["--fast", "int8"]).fast == "int8"
    assert parse_args([]).fast is None
