"""K9's plain version and the port's wgrad route against the JAX package.

- ``wgrad3x3_plain`` (the CPU path of K9's wrapper) against the Pallas
  ``wgrad3x3_nhwc`` in interpret mode, rtol = atol = 1e-4 (the tolerance of
  ``tests/test_wgrad_kernel.py``; the sums run in another order);
- ``Conv3x3WGrad``'s forward, dx and dW against ``conv3x3_pallas_wgrad``'s;
- the route: on the flagship (cfg/rep_yolo.yaml) with select-all, the port
  routes the same 9 convs (shapes in call order) as the JAX package, whose
  calls are recorded while ``jax.eval_shape`` traces a train-mode apply; the
  default select routes the same single conv on both sides; a routed block's
  gradients equal the unrouted block's;
- the optimizer group of every flagship parameter against JAX ``group_of``.

Inputs are made from numpy seeds and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rep_yolo_tpu.nn.blocks as JB
import rep_yolo_tpu.ops.pallas.wgrad_kernel as JW
from rep_yolo_tpu.models.model import RepYOLO as JaxRepYOLO
from rep_yolo_tpu.train.optim import group_tree
from rep_yolo_tpu_torch.models.model import RepYOLO
from rep_yolo_tpu_torch.nn import blocks as B
from rep_yolo_tpu_torch.ops.kernels import launch_counts
from rep_yolo_tpu_torch.ops.kernels import wgrad as KW
from rep_yolo_tpu_torch.train.optim import param_groups
from rep_yolo_tpu_torch.utils.weights import state_dict_from_jax

FLAGSHIP = "cfg/rep_yolo.yaml"
TOL = dict(rtol=1e-4, atol=1e-4)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("shape", [(2, 8, 16, 8, 8), (1, 12, 12, 16, 8)])
def test_plain_wgrad_matches_pallas_kernel(shape):
    B_, H, W, C, O = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=(B_, H, W, C)).astype(np.float32)
    dy = rng.normal(size=(B_, H, W, O)).astype(np.float32)
    ref = np.asarray(JW.wgrad3x3_nhwc(jnp.asarray(x), jnp.asarray(dy)))
    n0 = launch_counts()["wgrad3x3"]
    got = KW.wgrad3x3(_nchw(x), _nchw(dy))       # CPU: the plain version
    assert launch_counts()["wgrad3x3"] == n0     # no kernel launched
    np.testing.assert_allclose(got.numpy().transpose(2, 3, 1, 0), ref, **TOL)


def test_conv3x3_wgrad_function_matches_custom_vjp():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 8, 8)).astype(np.float32)
    w = (0.1 * rng.normal(size=(3, 3, 8, 8))).astype(np.float32)
    t = rng.normal(size=(2, 8, 8, 8)).astype(np.float32)

    def loss(x, w):
        return jnp.sum(JW.conv3x3_pallas_wgrad(x, w) * t)

    jy = JW.conv3x3_pallas_wgrad(jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = jax.grad(loss, (0, 1))(jnp.asarray(x), jnp.asarray(w))

    xt = _nchw(x).requires_grad_(True)
    wt = torch.from_numpy(np.ascontiguousarray(
        w.transpose(3, 2, 0, 1))).requires_grad_(True)
    y = KW.conv3x3_wgrad(xt, wt)
    (y * _nchw(t)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(jgx), **TOL)
    np.testing.assert_allclose(wt.grad.numpy().transpose(2, 3, 1, 0),
                               np.asarray(jgw), **TOL)


def test_routed_block_grads_match_unrouted():
    """ConvBnAct 3x3 in training: the routed conv's parameter grads equal
    the plain conv's (the JAX package's test_blocks_flag_routes_and_matches
    on the port)."""
    torch.manual_seed(0)
    blk = B.ConvBnAct(8, 8, 3).train()
    x = torch.randn(2, 8, 8, 8)
    grads = []
    for route in (False, True):
        blk.conv.wgrad = route
        y = blk(x)
        grads.append(torch.autograd.grad((y * y).sum(),
                                         list(blk.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **TOL)


@pytest.fixture(scope="module")
def flagship():
    """The JAX flagship traced abstractly with the select-all route: its
    parameter shapes and the (x, kernel) shapes of every
    conv3x3_pallas_wgrad call of a train-mode apply at 64 px."""
    jmodel = JaxRepYOLO.from_config(FLAGSHIP)
    calls, mark = [], []
    orig = JW.conv3x3_pallas_wgrad

    def record(x, w, precision=None):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return orig(x, w, precision=precision)

    def init_and_apply(x):
        variables = jmodel.net.init({"params": jax.random.PRNGKey(0)}, x,
                                    train=False)
        mark.append(len(calls))
        jmodel.net.apply(variables, x, train=True,
                         rngs={"dropout": jax.random.PRNGKey(1)},
                         mutable=["batch_stats"])
        return variables["params"]

    JW.conv3x3_pallas_wgrad = record
    try:
        JB.set_pallas_wgrad(True, select=lambda c1, c2: True)
        params = jax.eval_shape(init_and_apply, jax.ShapeDtypeStruct(
            (1, 64, 64, 3), jnp.float32))
    finally:
        JW.conv3x3_pallas_wgrad = orig
        JB.set_pallas_wgrad(False)
    return dict(params=params, routed_all=calls[mark[0]:],
                model=RepYOLO.from_config(FLAGSHIP, device="cpu"))


def _port_routed(model, select):
    """(x, weight) shapes, NHWC / HWIO, of the port's routed conv calls in a
    train-mode forward at 64 px."""
    calls = []
    orig = KW.conv3x3_wgrad

    def record(x, w):
        calls.append(((x.shape[0], x.shape[2], x.shape[3], x.shape[1]),
                      (3, 3, w.shape[1], w.shape[0])))
        return orig(x, w)

    model.net.set_wgrad(True, select=select)
    B.K_wgrad.conv3x3_wgrad = record
    try:
        model.net.train()
        with torch.no_grad():
            model.net(torch.zeros(1, 64, 64, 3))
    finally:
        B.K_wgrad.conv3x3_wgrad = orig
        model.net.set_wgrad(False)
        model.net.eval()
    return calls


def test_flagship_routes_the_jax_convs(flagship):
    got = _port_routed(flagship["model"], lambda a, b: True)
    assert len(got) == 9
    assert got == flagship["routed_all"]
    # the default select: the JAX package's off-TPU one
    want = [c for c in flagship["routed_all"]
            if JB._wgrad_default_select(c[1][2], c[1][3])]
    got = _port_routed(flagship["model"], None)
    assert got == want and len(got) == 1


def test_flagship_optimizer_groups_match_jax(flagship):
    p = flagship["params"]
    groups = group_tree(p)
    full = jax.tree.map(lambda s, g: np.full(s.shape, g, np.float32), p,
                        groups)
    want = {k: int(v.flat[0]) for k, v in
            state_dict_from_jax({"params": full}).items()}
    got = param_groups(flagship["model"].net)
    assert got == want
    assert sorted(set(got.values())) == [0, 1, 2, 3]
