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
- the optimizer group of every flagship parameter against JAX ``group_of``;
- K9's arithmetic (``csrc/wgrad.cu``) in plain torch: Winograd F(3x3, 2x2)
  (the transforms of dY's 2x2 tiles and X's 4x4 patches, odd H / W padded,
  the 16 products summed over the tiles, the output transform) in float64
  against ``wgrad3x3_plain`` (1e-10 relative) and the Pallas kernel (``TOL``);
  and its 3xTF32 products (``cvt.rna`` to TF32 bit for bit, float32 sums) at
  a flagship reduction length, P = 51,200: inside the card's gate (1e-4
  |dW| + 1e-4 max|dW|), where hi-only TF32 is outside it.

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
# F(3x3, 2x2) for the weight gradient, as csrc/wgrad.cu holds it: Vy = G dY_t
# G^T, Ux = B^T X_t B, dW = A^T (sum_t Vy * Ux) A
WINO_G = ((1, 0), (.5, .5), (.5, -.5), (0, -1))
WINO_BT = ((1, 0, -1, 0), (0, 1, 1, 0), (0, -1, 1, 0), (0, 1, 0, -1))
WINO_AT = ((1, 1, 1, 0), (0, 1, -1, 0), (0, 1, 1, 1))


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


def _winograd_tiles(x, dy):
    """Vy (16, O, T) and Ux (16, C, T) of x (B, C, H, W) and dY (B, O, H, W)
    in their dtype; tile t = (n * TH + ty) * TW + tx, dY zero-padded to even
    H, W, and X's patch of tile t the 4x4 window of the zero-padded x at
    (2ty, 2tx)."""
    B_, C, H, W = x.shape
    O = dy.shape[1]
    th, tw = -(-H // 2), -(-W // 2)
    d = torch.nn.functional.pad(dy, (0, 2 * tw - W, 0, 2 * th - H))
    d = d.reshape(B_, O, th, 2, tw, 2).permute(0, 1, 2, 4, 3, 5)
    xp = torch.nn.functional.pad(x, (1, 2 * tw - W + 1, 1, 2 * th - H + 1))
    p = xp.unfold(2, 4, 2).unfold(3, 4, 2)            # (B, C, th, tw, 4, 4)
    g, bt = (torch.tensor(m, dtype=x.dtype) for m in (WINO_G, WINO_BT))
    vy = g @ d @ g.T
    ux = bt @ p @ bt.T
    return (vy.permute(4, 5, 1, 0, 2, 3).reshape(16, O, -1),
            ux.permute(4, 5, 1, 0, 2, 3).reshape(16, C, -1))


def _winograd_output(m):
    """dW (O, C, 3, 3) = A^T M A of the summed products M (16, O, C)."""
    at = torch.tensor(WINO_AT, dtype=m.dtype)
    mm = m.permute(1, 2, 0).reshape(m.shape[1], m.shape[2], 4, 4)
    return at @ mm @ at.T


def _winograd_wgrad(x, dy):
    vy, ux = _winograd_tiles(x, dy)
    return _winograd_output(torch.einsum("kot,kct->koc", vy, ux))


@pytest.mark.parametrize("shape", [(2, 8, 16, 8, 8), (1, 12, 12, 16, 8),
                                   (3, 13, 21, 6, 5), (1, 1, 3, 4, 2),
                                   (2, 7, 8, 3, 9)])
def test_winograd_pipeline_matches_plain_in_float64(shape):
    B_, H, W, C, O = shape
    rng = np.random.default_rng(sum(shape) + 1)
    x = torch.from_numpy(rng.normal(size=(B_, C, H, W)))
    dy = torch.from_numpy(rng.normal(size=(B_, O, H, W)))
    vy, ux = _winograd_tiles(x, dy)
    assert vy.shape == (16, O, B_ * -(-H // 2) * -(-W // 2))
    ref = KW.wgrad3x3_plain(x, dy)
    got = _winograd_wgrad(x, dy)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, ref, rtol=1e-10,
                               atol=1e-10 * float(ref.abs().max()))


@pytest.mark.parametrize("shape", [(2, 8, 16, 8, 8), (1, 9, 11, 12, 8)])
def test_winograd_pipeline_matches_pallas_kernel(shape):
    B_, H, W, C, O = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=(B_, H, W, C)).astype(np.float32)
    dy = rng.normal(size=(B_, H, W, O)).astype(np.float32)
    ref = np.asarray(JW.wgrad3x3_nhwc(jnp.asarray(x), jnp.asarray(dy)))
    got = _winograd_wgrad(_nchw(x).double(), _nchw(dy).double())
    np.testing.assert_allclose(got.numpy().transpose(2, 3, 1, 0), ref, **TOL)


def _tf32_rna(a):
    """float32 -> TF32 (10-bit mantissa) as cvt.rna.tf32.f32 rounds: to
    nearest, ties away from zero, bit for bit."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _card_gate_excess(got, ref):
    """max over dW of |got - ref| - (1e-4 |ref| + 1e-4 max|ref|): the card's
    gate (chip_smoke.py, test_torch_kernels_cuda.py) holds where <= 0."""
    tol = 1e-4 * np.abs(ref) + 1e-4 * np.abs(ref).max()
    return float((np.abs(got - ref) - tol).max())


def test_3xtf32_winograd_holds_the_card_gate_at_flagship_length():
    """The products K9 runs on the tensor cores, emulated: Vy and Ux in
    float32, each split into hi = tf32(a), lo = tf32(a - hi); per tile
    lo*hi' + hi*lo' + hi*hi' added in float32 one after the other over all
    T = 12,800 tiles of (8, 80, 80) (P = 51,200, the l40 conv's), then the
    output transform. Against float64: inside the gate; hi*hi' alone
    (1xTF32) is far outside it."""
    B_, H, W, C, O = 8, 80, 80, 4, 4
    rng = np.random.default_rng(51200)
    x = torch.from_numpy(rng.normal(size=(B_, C, H, W)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(B_, O, H, W)).astype(np.float32))
    ref = KW.wgrad3x3_plain(x.double(), dy.double()).numpy()
    vy, ux = (t.numpy() for t in _winograd_tiles(x, dy))     # float32
    vh, uh = _tf32_rna(vy), _tf32_rna(ux)
    vl, ul = _tf32_rna(vy - vh), _tf32_rna(ux - uh)

    def prod(a, b):       # (16, O, C, T) float32; TF32 x TF32 is exact here
        return a[:, :, None, :] * b[:, None, :, :]

    def dw(terms):
        seq = np.stack(terms, -1).reshape(16, O, C, -1)   # per tile, in order
        m = np.cumsum(seq, -1, dtype=np.float32)[..., -1]
        return _winograd_output(torch.from_numpy(m)).numpy()

    three = dw([prod(vl, uh), prod(vh, ul), prod(vh, uh)])
    one = dw([prod(vh, uh)])
    assert _card_gate_excess(three, ref) <= 0
    assert _card_gate_excess(one, ref) > 0
    # and by a margin: 3xTF32's error is float32's own (its sums, ~1e-5 of
    # max|dW| here), under a quarter of the gate's 1e-4 max|dW|; 1xTF32's
    # is TF32's 2^-11 per product, over twice the gate's
    scale = np.abs(ref).max()
    assert np.abs(three - ref).max() < 0.25e-4 * scale
    assert np.abs(one - ref).max() > 2e-4 * scale
