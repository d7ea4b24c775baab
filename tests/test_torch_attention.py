"""Port parity: deploy CrissCrossAttention / VerticalAttention / CCVA of
rep_yolo_tpu_torch (plain PyTorch path on the CPU) against the JAX deploy
modules on the same carried weights, with the JAX fused Pallas kernels
(interpret mode) and without them.

gamma = 0.7 and randomised BN statistics, so the attention branch and the
BN affine fold both contribute. Tolerance f32 atol = rtol = 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rep_yolo_tpu.nn.blocks as JB
from rep_yolo_tpu_torch.nn import blocks as TB
from rep_yolo_tpu_torch.nn.fuse import fuse_state_dict
from rep_yolo_tpu_torch.ops.kernels import axial_attention as KA
from rep_yolo_tpu_torch.utils.weights import load_weights, state_dict_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _restore_flag():
    yield
    JB.set_fused_attention(False)


def _randomised(variables, seed):
    """Numpy-random BN statistics and gamma 0.7 on JAX variables."""
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape).astype(
            np.float32)), variables["batch_stats"])

    def set_gamma(tree):
        return {k: (set_gamma(v) if isinstance(v, dict) else
                    (jnp.full_like(v, 0.7) if k == "gamma" else v))
                for k, v in tree.items()}

    return {"params": set_gamma(dict(variables["params"])),
            "batch_stats": stats}


_MODULES = {
    "criss_cross": (JB.CrissCrossAttention, TB.CrissCrossAttention),
    "vertical": (JB.VerticalAttention, TB.VerticalAttention),
    "ccva": (JB.CCVA, None),
}


def _port_module(kind, c1):
    if kind == "ccva":
        return TB.CCVA(c1, c1, deploy=True)
    return _MODULES[kind][1](c1, deploy=True)


@pytest.mark.parametrize("kind", list(_MODULES))
@pytest.mark.parametrize("c1", [16, 32])
@pytest.mark.parametrize("hw", [(8, 8), (12, 10)])
def test_attention_deploy_matches_jax(kind, c1, hw):
    h, w = hw
    x = np.random.default_rng(c1 + h).normal(size=(2, h, w, c1)).astype(
        np.float32)
    jmod = _MODULES[kind][0](c1, deploy=True)
    variables = _randomised(jmod.init(jax.random.PRNGKey(c1), x, False),
                            seed=h * w)

    JB.set_fused_attention(False)
    y_xla = np.asarray(jmod.apply(variables, x, False))
    JB.set_fused_attention(True)
    y_fused = np.asarray(jmod.apply(variables, x, False))

    tmod = _port_module(kind, c1)
    # the JAX deploy state has its convs folded; the port's fuse packs the
    # attention constants
    load_weights(tmod, fuse_state_dict(state_dict_from_jax(variables)))
    with torch.no_grad():
        y = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    np.testing.assert_allclose(y, y_xla, **TOL)
    np.testing.assert_allclose(y, y_fused, **TOL)


@pytest.mark.parametrize("criss_cross", [True, False])
def test_plain_attention_matches_jax_kernel(criss_cross):
    """The plain version beside the kernels vs the JAX fused_x kernels
    (interpret mode) on the same packed constants."""
    from rep_yolo_tpu.ops.pallas import axial_attention as jax_ax

    rng = np.random.default_rng(5)
    c, c8 = 32, 4
    x = rng.normal(size=(2, 10, 12, c)).astype(np.float32)
    wqk = (0.3 * rng.normal(size=(2 * c8, c))).astype(np.float32)
    pq = np.stack([0.1 * rng.normal(size=2 * c8),
                   rng.uniform(0.5, 1.5, 2 * c8),
                   0.1 * rng.normal(size=2 * c8)]).astype(np.float32)
    pv = np.stack([rng.normal(size=c), 0.1 * rng.normal(size=c),
                   rng.uniform(0.5, 1.5, c),
                   0.1 * rng.normal(size=c)]).astype(np.float32)
    gamma = np.array([0.7], np.float32)
    fn = jax_ax.criss_cross_fused_x if criss_cross else jax_ax.vertical_fused_x
    ref = np.asarray(fn(x, wqk, pv, pq, gamma))
    t = [torch.from_numpy(a) for a in (x, wqk, pq, pv, gamma)]
    got = KA.axial_attention(*t, criss_cross).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_packed_constants_densify_grouped_conv():
    """The packed wqk and q bias equal the grouped 1x1 conv + BN fold they
    replace."""
    g = torch.Generator().manual_seed(0)
    state = {k: (0.5 + torch.rand(v.shape, generator=g))
             for k, v in TB.CrissCrossAttention(32).state_dict().items()}
    packed = fuse_state_dict(state)
    x = torch.randn(3, 32, 1, 1, generator=g)
    bn = "query_conv.bn."
    a = state[bn + "weight"] / torch.sqrt(state[bn + "running_var"] + 1e-3)
    q = torch.nn.functional.conv2d(x, state["query_conv.conv.weight"],
                                   groups=4)[..., 0, 0]
    q = q * a + state[bn + "bias"] - state[bn + "running_mean"] * a
    torch.testing.assert_close(
        x[..., 0, 0] @ packed["wqk"][:4].t() + packed["pq"][0, :4], q)
