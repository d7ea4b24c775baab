"""Port parity for the training slice, on the CPU.

- Golden blocks: every train-form block in ``eval()`` against the 17
  ``tests/golden/block_*.npz`` fixtures (the reference's outputs; the fused
  ones through ``nn.fuse`` too), at the JAX golden test's tolerance.
- Losses: ``compute_loss`` / ``compute_loss_ota`` on ``loss_io.npz`` at
  ``tests/test_loss.py``'s tolerances; simOTA's matching against the JAX
  package's on maps built to hold exactly equal costs (the tie order decides
  the match): fg masks and matched targets identical.
- One train step of cfg/rep_yolo_tiny_test.yaml at 64 px, batch 2, from a
  JAX init carried over with ``utils/weights``, the port with the select-all
  wgrad route (its plain version on the CPU), the JAX package with the route
  off (the gradient is the same). Dropout is replaced on both sides by one
  numpy mask per call (flax ``nn.intercept_methods`` there, a patch of
  ``Dropout.keep_mask`` here). Checked: the loss components, every gradient,
  the BN running statistics (the attention's shared ``bn`` moved twice), and
  the parameters, SGD momentum and EMA after 2 steps, warmup off; in float64
  against the JAX package with x64 on (tight), and in float32 against the
  port's own float64 run and the JAX package's float32 step.
- Data: the synthetic generator's labels and the loader's geometry against
  the JAX package's; ``identity_batch``; the CLI's refusals.
"""

import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from flax import linen as fnn

from rep_yolo_tpu.data.augment import identity_batch as jax_identity_batch
from rep_yolo_tpu.data.datasets import make_synthetic_dataset as jax_synth
from rep_yolo_tpu.models.model import RepYOLO as JaxRepYOLO
from rep_yolo_tpu.models.model import initialize_detect_biases
from rep_yolo_tpu.models.network import DetectionNet as JaxDetectionNet
from rep_yolo_tpu.train import loss as JL
from rep_yolo_tpu.train import optim as JO
from rep_yolo_tpu.train import trainer as JT
from rep_yolo_tpu_torch.cli import train as cli
from rep_yolo_tpu_torch.data.augment import identity_batch
from rep_yolo_tpu_torch.data.datasets import Loader, make_synthetic_dataset
from rep_yolo_tpu_torch.models.model import RepYOLO
from rep_yolo_tpu_torch.nn import blocks as B
from rep_yolo_tpu_torch.nn.fuse import fuse_state_dict
from rep_yolo_tpu_torch.train import loss as TL
from rep_yolo_tpu_torch.train import optim as TO
from rep_yolo_tpu_torch.train.hyp import load_hyp
from rep_yolo_tpu_torch.train.trainer import create_train_state, make_train_step
from rep_yolo_tpu_torch.utils.weights import (load_weights, state_dict_from_jax,
                                              train_state_from_jax)
from tests.conftest import load_golden

TINY = "cfg/rep_yolo_tiny_test.yaml"
SIZE = 64
GOLDEN_TOL = dict(rtol=2e-4, atol=2e-5)     # tests/test_golden_blocks.py

GOLDEN_BLOCKS = {
    "block_conv": lambda: B.ConvBnAct(16, 32, 3, 2),
    "block_reps_s1": lambda: B.RepSBlock(32, 32, 3, 1, 1, 1),
    "block_reps_s2": lambda: B.RepSBlock(16, 32, 3, 2, 1, 1),
    "block_der": lambda: B.DERBlock(32, 64, 1, 2),
    "block_sppcspc": lambda: B.SPPCSPC(64, 64),
    "block_gsconv": lambda: B.GSConv(32, 64, 1, 1),
    "block_gsconv_s2": lambda: B.GSConv(32, 64, 3, 2),
    "block_vovgscsp": lambda: B.VoVGSCSP(64, 64),
    "block_ca": lambda: B.CA(64),
    "block_cca": lambda: B.CrissCrossAttention(64),
    "block_va": lambda: B.VerticalAttention(64),
    "block_ccva": lambda: B.CCVA(64, 64),
    "block_repconv": lambda: B.RepConv(64, 64),
    "block_repconv_c2": lambda: B.RepConv(32, 64),
    "block_repconv_fuse": lambda: B.RepConv(64, 64),
    "block_mp": lambda: B.MP(),
    # SPPCSPC's stride-1 max pool (the reference SP block, k=3)
    "block_sp": lambda: torch.nn.MaxPool2d(3, 1, 1),
}
DEPLOY_BLOCKS = {
    "block_reps_s1": lambda: B.RepSBlock(32, 32, 3, 1, 1, 1, deploy=True),
    "block_reps_s2": lambda: B.RepSBlock(16, 32, 3, 2, 1, 1, deploy=True),
    "block_repconv_fuse": lambda: B.RepConv(64, 64, deploy=True),
}


@pytest.mark.parametrize("name", sorted(GOLDEN_BLOCKS))
def test_golden_block_eval(golden_dir, name):
    g = load_golden(name)
    block = GOLDEN_BLOCKS[name]().eval()
    state = {k: v for k, v in g.items() if k not in ("x", "y", "y_fused")}
    if state:
        load_weights(block, state)
    x = torch.from_numpy(g["x"])
    with torch.no_grad():
        y = block(x)
    np.testing.assert_allclose(y.numpy(), g["y"], **GOLDEN_TOL)
    if name in DEPLOY_BLOCKS:
        fused = fuse_state_dict({f"b.{k}": v
                                 for k, v in block.state_dict().items()})
        deploy = DEPLOY_BLOCKS[name]().eval()
        load_weights(deploy, {k[2:]: v for k, v in fused.items()})
        with torch.no_grad():
            yf = deploy(x)
        np.testing.assert_allclose(yf.numpy(), g["y_fused"], **GOLDEN_TOL)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss_io():
    g = load_golden("loss_io")
    preds = [torch.from_numpy(g[f"p{i}"].transpose(0, 2, 3, 1, 4).copy())
             for i in range(3)]
    labels = np.zeros((2, 8, 5), np.float32)
    mask = np.zeros((2, 8), bool)
    counts = [0, 0]
    for row in g["targets"]:
        b = int(row[0])
        labels[b, counts[b]] = row[1:]
        mask[b, counts[b]] = True
        counts[b] += 1
    cfg = TL.LossConfig(nc=1, box_gain=0.05, obj_gain=0.7, cls_gain=0.3,
                        anchor_t=4.0, gr=1.0)
    return (preds, torch.from_numpy(labels), torch.from_numpy(mask),
            g["anchors_norm"], tuple(float(s) for s in g["strides"]),
            int(g["img_size"]), g, cfg)


def test_classic_loss_matches_reference(golden_dir):
    preds, labels, mask, anchors, _, _, g, cfg = _loss_io()
    loss, comps = TL.compute_loss(preds, labels, mask, anchors, cfg)
    ref = g["items"]
    np.testing.assert_allclose(float(comps["box"]), ref[0], rtol=2e-4)
    np.testing.assert_allclose(float(comps["obj"]), ref[1], rtol=2e-4)
    np.testing.assert_allclose(float(comps["cls"]), ref[2], atol=1e-7)
    np.testing.assert_allclose(float(loss), float(g["loss"][0]), rtol=2e-4)


def test_ota_loss_matches_reference(golden_dir):
    preds, labels, mask, anchors, strides, size, g, cfg = _loss_io()
    loss, comps = TL.compute_loss_ota(preds, labels, mask, anchors, strides,
                                      size, cfg)
    ref = g["items_ota"]
    np.testing.assert_allclose(float(comps["box"]), ref[0], rtol=5e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(comps["obj"]), ref[1], rtol=5e-4)
    np.testing.assert_allclose(float(comps["cls"]), ref[2], atol=1e-7)
    np.testing.assert_allclose(float(loss), float(g["loss_ota"][0]),
                               rtol=5e-4)


def test_topk_iter_tie_order():
    x = np.random.default_rng(3).normal(size=(3, 7, 111)).astype(np.float32)
    x[..., :5] = 0.25
    x[0, 0, :] = 0.0
    v1, i1 = JL._topk_iter(jnp.asarray(x), 10)
    v2, i2 = TL._topk_iter(torch.from_numpy(x), 10)
    np.testing.assert_array_equal(np.asarray(v1), v2.numpy())
    np.testing.assert_array_equal(np.asarray(i1), i2.numpy())


def _tie_case():
    """Maps of the tiny graph's 3 levels at 64 px whose candidates decode to
    the same large box around each cell (xy, obj, cls logits 0, wh logit 3):
    a small target inside all of them has exactly the same IoU, hence cost,
    at every candidate cell of one anchor. Half of batch item 1's cells are
    random instead; targets overlap so that candidates conflict."""
    rng = np.random.default_rng(5)
    anchors_px = np.asarray([[10, 13, 16, 30, 33, 23],
                             [30, 61, 62, 45, 59, 119],
                             [116, 90, 156, 198, 373, 326]],
                            np.float32).reshape(3, 3, 2)
    strides = (8.0, 16.0, 32.0)
    preds = []
    for s in strides:
        n = int(SIZE // s)
        p = np.zeros((2, n, n, 3, 6), np.float32)
        p[..., 2:4] = 3.0
        noisy = rng.random((n, n, 3)) < 0.5
        p[1][noisy] = rng.normal(size=(int(noisy.sum()), 6))
        preds.append(p)
    labels = np.zeros((2, 6, 5), np.float32)
    mask = np.zeros((2, 6), bool)
    boxes = [[(0.30, 0.31, 0.10, 0.12), (0.33, 0.30, 0.12, 0.10),
              (0.70, 0.62, 0.30, 0.35), (0.20, 0.75, 0.06, 0.08)],
             [(0.50, 0.50, 0.14, 0.12), (0.52, 0.49, 0.10, 0.14),
              (0.25, 0.30, 0.45, 0.40)]]
    for b, bs in enumerate(boxes):
        for j, bx in enumerate(bs):
            labels[b, j, 1:] = bx
            mask[b, j] = True
    anchors_grid = anchors_px / np.asarray(strides, np.float32)[:, None, None]
    return preds, labels, mask, anchors_grid, strides


def test_ota_matching_identical_on_equal_costs():
    preds, labels, mask, anchors, strides = _tie_case()
    # the JAX side op by op: jitted, XLA's fused CPU code rounds some of
    # the tied costs apart (2 of 180 fg flags differ on this case)
    cands_j = [JL.find_3_positive(jnp.asarray(labels), jnp.asarray(mask),
                                  p.shape[1:3], jnp.asarray(anchors[i]), 4.0)
               for i, p in enumerate(preds)]
    ref = JL._ota_match(jnp.asarray(labels), jnp.asarray(mask), cands_j,
                        [jnp.asarray(p) for p in preds], strides, SIZE,
                        JL.LossConfig(nc=1))
    lt, mt = torch.from_numpy(labels), torch.from_numpy(mask)
    at = torch.from_numpy(anchors)
    cands_t = [TL.find_3_positive(lt, mt, p.shape[1:3], at[i], 4.0)
               for i, p in enumerate(preds)]
    got = TL._ota_match(lt, mt, cands_t, [torch.from_numpy(p) for p in preds],
                        strides, SIZE, TL.LossConfig(nc=1))
    n_fg = 0
    for (fg_j, mg_j), (fg_t, mg_t) in zip(ref, got):
        np.testing.assert_array_equal(fg_t.numpy(), np.asarray(fg_j))
        fg = np.asarray(fg_j)
        np.testing.assert_array_equal(mg_t.numpy()[fg], np.asarray(mg_j)[fg])
        n_fg += int(fg.sum())
    assert n_fg > 0
    # the case holds ties: candidates of one level, anchor and image whose
    # decoded boxes and hence costs are bit-for-bit equal
    ps = TL._gather_preds(torch.from_numpy(preds[0]), cands_t[0].gi,
                          cands_t[0].gj)
    valid = cands_t[0].valid[0, 0, 0]
    assert valid.sum() >= 2 and bool((ps[0, 0, 0][valid] ==
                                      ps[0, 0, 0][valid][0]).all())


@pytest.mark.parametrize("mode", ["classic", "ota"])
def test_losses_match_jax_multiclass(mode):
    """nc = 3, label smoothing and focal terms on random maps (no ties)."""
    rng = np.random.default_rng(8)
    preds = [rng.normal(size=(2, n, n, 3, 8)).astype(np.float32)
             for n in (8, 4, 2)]
    labels = np.zeros((2, 4, 5), np.float32)
    labels[..., 0] = rng.integers(0, 3, (2, 4))
    labels[..., 1:3] = rng.uniform(0.2, 0.8, (2, 4, 2))
    labels[..., 3:] = rng.uniform(0.05, 0.5, (2, 4, 2))
    mask = np.asarray([[1, 1, 1, 0], [1, 0, 0, 0]], bool)
    anchors = _tie_case()[3]
    kw = dict(nc=3, label_smoothing=0.1, fl_gamma=1.5, cls_pw=1.2)
    jp = [jnp.asarray(p) for p in preds]
    if mode == "classic":
        ref = jax.jit(lambda p, l, m: JL.compute_loss(
            p, l, m, anchors, JL.LossConfig(**kw)))(
                jp, jnp.asarray(labels), jnp.asarray(mask))
        got = TL.compute_loss([torch.from_numpy(p) for p in preds],
                              torch.from_numpy(labels),
                              torch.from_numpy(mask), anchors,
                              TL.LossConfig(**kw))
    else:
        args = (anchors, (8.0, 16.0, 32.0), SIZE)
        ref = jax.jit(lambda p, l, m: JL.compute_loss_ota(
            p, l, m, *args, JL.LossConfig(**kw)))(
                jp, jnp.asarray(labels), jnp.asarray(mask))
        got = TL.compute_loss_ota([torch.from_numpy(p) for p in preds],
                                  torch.from_numpy(labels),
                                  torch.from_numpy(mask), *args,
                                  TL.LossConfig(**kw))
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-5)
    for k in ("box", "obj", "cls"):
        np.testing.assert_allclose(float(got[1][k]), float(ref[1][k]),
                                   rtol=1e-5)
    assert float(got[1]["cls"]) > 0


# ---------------------------------------------------------------------------
# one train step of the tiny graph against the JAX package
# ---------------------------------------------------------------------------

M = 8
WD = 5e-4


def _batch():
    """uint8 canvases with their content at the top left, labels normalized
    to the content. The targets are far apart: no two candidates of any
    target share a (b, gj, gi, a) cell, so the objectness scatter, whose
    write order on a shared cell is unspecified on both sides, is the same
    (asserted in the test)."""
    rng = np.random.default_rng(11)
    images = np.full((2, SIZE, SIZE, 3), 114, np.uint8)
    hw = np.asarray([[48, 64], [64, 40]], np.float32)
    for b, (h, w) in enumerate(hw.astype(int)):
        images[b, :h, :w] = rng.integers(0, 255, (h, w, 3))
    labels = np.zeros((2, M, 5), np.float32)
    mask = np.zeros((2, M), bool)
    labels[0, 0] = [0, 0.27, 0.3, 0.3, 0.35]
    labels[0, 1] = [0, 0.77, 0.7, 0.35, 0.4]
    labels[1, 0] = [0, 0.5, 0.45, 0.6, 0.3]
    mask[0, :2] = True
    mask[1, 0] = True
    return images, hw, labels, mask


def _mask(i: int, shape) -> np.ndarray:
    """The dropout keep mask of call ``i`` of a forward, in the JAX layout
    (DER: NHWC; attention: (B, H, W, W))."""
    return np.random.default_rng(1000 + i).random(shape) >= 0.2


class _JaxMasks:
    """flax interceptor: each Dropout call takes ``_mask``; the count
    restarts at every DetectionNet call (one forward, or one trace)."""

    def __init__(self):
        self.n = 0
        self.calls = 0

    def __call__(self, next_fun, args, kwargs, ctx):
        if isinstance(ctx.module, JaxDetectionNet) and \
                ctx.method_name == "__call__":
            self.n = 0
        if isinstance(ctx.module, fnn.Dropout) and \
                ctx.method_name == "__call__":
            self.n += 1
            self.calls += 1
            x = args[0]
            keep = _mask(self.n, x.shape)
            return jnp.where(keep, x / (1.0 - ctx.module.rate), 0.0)
        return next_fun(*args, **kwargs)


def _jax_steps(jmodel, variables, batch, opt_kw):
    """Two JAX train steps: (states, components); ``_mask`` for dropout."""
    jstep = jax.jit(JT.make_train_step(jmodel, JL.LossConfig(nc=1),
                                       JO.OptimConfig(**opt_kw), SIZE,
                                       use_ota=True))
    states = [JT.create_train_state(variables, jax.random.PRNGKey(1))]
    comps = []
    masks = _JaxMasks()
    with fnn.intercept_methods(masks):
        for _ in range(2):
            s, c = jstep(states[-1], *batch)
            states.append(s)
            comps.append({k: float(v) for k, v in c.items()})
    assert masks.calls == 7      # 6 DER stages and the criss-cross att_w
    return states, comps


@pytest.fixture(scope="module")
def step_run():
    """The two steps on each side, in float32 and in float64 (the JAX
    package with x64 on for its float64 steps alone, the port on a float64
    copy of the model)."""
    batch = _batch()
    jmodel = JaxRepYOLO.from_config(TINY)
    variables = dict(jax.jit(lambda r: jmodel.net.init(
        {"params": r}, jnp.zeros((1, SIZE, SIZE, 3)), train=False))(
            jax.random.PRNGKey(0)))
    variables["params"] = initialize_detect_biases(
        variables["params"], jmodel.cfg, jmodel.strides)
    opt_kw = dict(epochs=30, nb=10, lr0=0.01, weight_decay=WD,
                  warmup_epochs=0, warmup_floor=0)
    jax_runs = {"f32": _jax_steps(jmodel, variables, batch, opt_kw)}
    with jax.enable_x64(True):
        images, hw, labels, mask = batch
        jax_runs["f64"] = _jax_steps(
            jmodel, jax.tree.map(lambda a: a.astype(jnp.float64), variables),
            (images, hw.astype(np.float64), labels.astype(np.float64), mask),
            opt_kw)

    model = RepYOLO.from_config(TINY, device="cpu").load_state(
        state_dict_from_jax(variables))
    model.net.set_wgrad(True, select=lambda c1, c2: True)
    m64 = copy.deepcopy(model)
    m64.net.double()
    der = {id(m.dropout) for net in (model.net, m64.net)
           for m in net.modules() if isinstance(m, B.DERBlock)}
    count = [0]

    def keep_mask(self, x):
        count[0] += 1
        if id(self) in der:
            b, c, h, w = x.shape
            return torch.from_numpy(_mask(count[0], (b, h, w, c))).permute(
                0, 3, 1, 2)
        return torch.from_numpy(_mask(count[0], tuple(x.shape)))

    sink = [None]
    apply_updates = TO.apply_updates

    def record(params, g, *a, **k):
        sink[0].append({n: t.clone() for n, t in g.items()})
        return apply_updates(params, g, *a, **k)

    hooks = [net.register_forward_pre_hook(
        lambda m, a: count.__setitem__(0, 0)) for net in (model.net, m64.net)]
    orig_mask = B.Dropout.keep_mask
    B.Dropout.keep_mask = keep_mask
    TO.apply_updates = record
    runs = {}
    try:
        inputs = [torch.from_numpy(a) for a in batch]
        for key, mdl in (("f32", model), ("f64", m64)):
            state = create_train_state(mdl, seed=1)
            step = make_train_step(mdl, TL.LossConfig(nc=1),
                                   TO.OptimConfig(**opt_kw), SIZE)
            sink[0] = []
            comps, stats = [], []
            for _ in range(2):
                comps.append({k: float(v) for k, v in
                              step(state, *inputs).items()})
                stats.append({k: v.clone() for k, v in
                              mdl.net.state_dict().items() if "running" in k})
            runs[key] = dict(state=state, comps=comps, grads=sink[0],
                             stats=stats, jstates=jax_runs[key][0],
                             jcomps=jax_runs[key][1])
    finally:
        B.Dropout.keep_mask = orig_mask
        TO.apply_updates = apply_updates
        for h in hooks:
            h.remove()
    return dict(runs, model=model, batch=batch)


def test_step_targets_share_no_cell(step_run):
    images, hw, labels, mask = step_run["batch"]
    _, lab = identity_batch(torch.from_numpy(images), torch.from_numpy(hw),
                            torch.from_numpy(labels))
    model = step_run["model"]
    anchors = torch.as_tensor(model.anchors_grid)
    for i, s in enumerate(model.strides):
        n = int(SIZE // s)
        c = TL.find_3_positive(lab, torch.from_numpy(mask), (n, n),
                               anchors[i], 4.0)
        b = torch.arange(2)[:, None, None, None].expand(c.valid.shape)
        a = torch.arange(3)[None, None, :, None].expand(c.valid.shape)
        cells = torch.stack([b, c.gj, c.gi, a], -1)[c.valid]
        assert len(torch.unique(cells, dim=0)) == len(cells)


# Tolerances. Against the JAX package the port is held in float64, the JAX
# steps with x64 on. There the two sides differ in summation order and in
# the attention's softmax exp, which both take in float32 (the JAX block's
# cast) and which XLA and torch round apart by an ulp. Step 1 (loss,
# gradients, BN statistics; the attention's gamma is still 0 in the forward)
# is held to 1e-6 of each tensor's largest element, and after step 2
# (parameters, momentum, EMA), with gamma moved and the exp's ulps in the
# forward, to 1e-5. A tensor whose gradient is zero in exact
# arithmetic (a BN bias that feeds a conv and a BN) holds rounding noise on
# both sides: a floor of 1e-12 of the largest element of all the tensors
# covers it and is below 1e-6 of every other tensor's scale. In float32 the
# port is held to its own float64 run (gradients 1e-3, momentum 1e-3 with a
# floor of 1e-4) and to the JAX package's float32 step (loss, statistics,
# parameters, EMA; 1e-3), whose CPU reductions (flax's one-pass BN variance
# among them) are further from float64 than the port's.

def test_step_losses_match_jax(step_run):
    for key, rtol in (("f32", 1e-3), ("f64", 1e-6)):
        run = step_run[key]
        for got, ref in zip(run["comps"], run["jcomps"]):
            for k in ("box", "obj", "cls", "total"):
                np.testing.assert_allclose(got[k], ref[k], rtol=rtol,
                                           atol=1e-7)


def _jax_grads(run):
    """Step 1's grads from the JAX SGD buffer: buf_1 = g + wd * p_0 for the
    conv weights, g elsewhere."""
    s0, s1 = run["jstates"][:2]
    p0 = state_dict_from_jax({"params": s0.params})
    buf = train_state_from_jax(s1)["momentum"]
    groups = run["state"].groups
    return {k: v - WD * p0[k] if groups[k] == TO.G_KERNEL else v
            for k, v in buf.items()}


def _close(got: dict, ref: dict, frac: float, floor: float):
    """Per tensor: |got - ref| <= frac max|ref| + floor max over all of
    ``ref``."""
    assert set(got) == set(ref)
    ref = {k: np.asarray(v, np.float64) for k, v in ref.items()}
    top = max(np.abs(r).max() for r in ref.values())
    for k, r in ref.items():
        g = got[k].detach().double().numpy() if torch.is_tensor(got[k]) \
            else got[k]
        err = np.abs(g - r).max()
        assert err <= frac * np.abs(r).max() + floor * top, \
            (k, float(err), float(np.abs(r).max()))


def test_step_grads_match_float64_and_jax(step_run):
    r32, r64 = step_run["f32"], step_run["f64"]
    assert r64["grads"][0]["model.0.rbr_conv.0.conv.weight"].dtype == \
        torch.float64
    _close(r32["grads"][0], r64["grads"][0], 1e-3, 1e-6)
    _close(r64["grads"][0], _jax_grads(r64), 1e-6, 1e-12)


def test_step_bn_stats_match_jax(step_run):
    """BN running statistics after step 1 (flax's biased variance; the
    attention's shared ``bn`` moved by q, then by k)."""
    for key, frac, floor in (("f32", 1e-3, 1e-6), ("f64", 1e-6, 1e-12)):
        ref = train_state_from_jax(step_run[key]["jstates"][1])["state"]
        got = step_run[key]["stats"][0]
        _close(got, {k: ref[k] for k in got}, frac, floor)
    assert any(".m.bn.running_var" in k for k in got)


def test_step_params_momentum_ema_match_jax(step_run):
    for key in ("f32", "f64"):
        ref = train_state_from_jax(step_run[key]["jstates"][2])
        state = step_run[key]["state"]
        assert state.step == ref["step"] == 2
        assert state.ema_updates == ref["ema_updates"] == 2
        params = dict(state.params)
        tol = (1e-3, 1e-4) if key == "f32" else (1e-5, 1e-12)
        _close(params, {k: ref["state"][k] for k in params}, *tol)
        _close(state.ema, ref["ema"], *tol)
    # momentum: the float64 run against the JAX package's, float32 against it
    _close(state.momentum, ref["momentum"], 1e-5, 1e-12)
    _close(step_run["f32"]["state"].momentum, state.momentum, 1e-3, 1e-4)


@pytest.mark.parametrize("adam,linear_lr", [(False, False), (True, False),
                                             (False, True)])
def test_optimizer_matches_jax(adam, linear_lr):
    """Three updates through the warmup (every group's ramp, momentum
    warmup) on random parameters and grads, one tensor per group. Adam's
    buffers round differently by an ulp (XLA contracts ``b * m + (1 - b) *
    g``), and its step divides by sqrt of a small bias-corrected v: rtol
    1e-5 on its parameters, 1e-6 for SGD."""
    rng = np.random.default_rng(7)
    shapes = {"w": (4, 3), "b": (4,), "s": (4,), "gamma": (1,)}
    gids = {"w": TO.G_KERNEL, "b": TO.G_BIAS, "s": TO.G_BN_IMPLICIT,
            "gamma": TO.G_FROZEN}
    p0 = {k: rng.normal(size=v).astype(np.float32) for k, v in shapes.items()}
    grads = [{k: rng.normal(size=v).astype(np.float32)
              for k, v in shapes.items()} for _ in range(3)]
    kw = dict(lr0=0.01, weight_decay=5e-4, epochs=10, nb=4, adam=adam,
              linear_lr=linear_lr, warmup_epochs=1.0, warmup_floor=3)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = JO.init_state(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    mom = {k: torch.zeros_like(v) for k, v in tp.items()}
    sec = {k: torch.zeros_like(v) for k, v in tp.items()}
    for i, g in enumerate(grads):
        jp, jst = JO.apply_updates(jp, {k: jnp.asarray(v) for k, v in
                                        g.items()}, jst,
                                   JO.OptimConfig(**kw), groups=gids)
        TO.apply_updates(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                         mom, sec, gids, i, TO.OptimConfig(**kw))
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5 if adam else 1e-6, atol=1e-7)
        np.testing.assert_allclose(mom[k].numpy(),
                                   np.asarray(jst.momentum[k]),
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(tp["gamma"].numpy(), p0["gamma"])


# ---------------------------------------------------------------------------
# data and the CLI
# ---------------------------------------------------------------------------

def test_synthetic_dataset_matches_jax(tmp_path):
    ref = jax_synth(3, 96, 1, 8, seed=4, root=tmp_path)
    got = make_synthetic_dataset(3, 96, 1, 8, seed=4)
    for i in range(3):
        np.testing.assert_array_equal(got.labels[i], ref.labels[i])
        c, hw, lab, m, orig = got.load_item(i)
        _, hw_r, lab_r, m_r, orig_r = ref.load_item(i)
        assert c.shape == (96, 96, 3) and c.dtype == np.uint8
        for a, b in ((hw, hw_r), (lab, lab_r), (m, m_r), (orig, orig_r)):
            np.testing.assert_array_equal(a, b)
    batches = list(Loader(got, 2, seed=4).epoch(0))
    assert len(batches) == 1 and batches[0]["images"].shape == (2, 96, 96, 3)


def test_identity_batch_matches_jax():
    images, hw, labels, _ = _batch()
    # jitted, as the JAX train step runs it
    img_j, lab_j = jax.jit(jax_identity_batch)(
        jnp.asarray(images), jnp.asarray(hw), jnp.asarray(labels))
    img_t, lab_t = identity_batch(torch.from_numpy(images),
                                  torch.from_numpy(hw),
                                  torch.from_numpy(labels))
    np.testing.assert_array_equal(img_t.numpy(), np.asarray(img_j))
    np.testing.assert_allclose(lab_t.numpy(), np.asarray(lab_j), rtol=1e-7)


@pytest.mark.parametrize("flags", [["--remat"], ["--bf16"],
                                   ["--multi-scale"], ["--aux"],
                                   ["--wandb", "p"], ["--evolve", "2"],
                                   ["--multihost"], ["--rbg"],
                                   ["--devices", "2"]])
def test_cli_refuses_unported_paths(flags):
    args = cli.parse_args(["--data", "synthetic:4", "--no-augment",
                           "--no-autoanchor", "--eval-every", "0"] + flags)
    with pytest.raises(NotImplementedError):
        cli.check_ported(args)


@pytest.mark.parametrize("hyp", [dict(mosaic9=0.2, paste_in=0.0),
                                 dict(mosaic9=0.0, paste_in=0.05),
                                 dict(mosaic9=0.0, paste_in=0.0, cutout=0.5),
                                 dict(mosaic9=0.0, paste_in=0.0)])
def test_cli_augment_hyp(tmp_path, hyp):
    """With augmentation and autoanchor on, a hyp YAML (over scratch.p5)
    with any of mosaic-9, paste-in and cutout on or off is accepted, and
    its values reach the ``AugmentConfig``."""
    path = tmp_path / "hyp.yaml"
    path.write_text("".join(f"{k}: {v}\n" for k, v in hyp.items()))
    args = cli.parse_args(["--data", "synthetic:4", "--eval-every", "0",
                           "--hyp", str(path)])
    cli.check_ported(args)
    cfg = cli.augment_config(args, load_hyp(str(path)))
    assert (cfg.mosaic9, cfg.paste_in, cfg.cutout, cfg.mixup) == (
        hyp["mosaic9"], hyp["paste_in"], hyp.get("cutout", 0.0), 0.15)


def test_cli_needs_cuda_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = cli.parse_args(["--data", "synthetic:2", "--no-augment",
                           "--no-autoanchor", "--eval-every", "0"])
    with pytest.raises(RuntimeError):
        cli.run_training(args)


def test_cli_trains_tiny_graph_on_cpu():
    """``run_training`` end to end on the CPU (the tiny graph at 64 px, one
    epoch of 2 steps, accumulation ramped as the CLI does), and
    ``build_training``'s warmup switch, which ``chip_smoke.py`` uses."""
    args = cli.parse_args(["--cfg", TINY, "--data", "synthetic:4",
                           "--epochs", "1", "--batch-size", "2",
                           "--img-size", str(SIZE), "--no-augment",
                           "--no-autoanchor", "--eval-every", "0",
                           "--device", "cpu"])
    lines = []
    records = cli.run_training(args, emit=lines.append)
    assert [r["step"] for r in records] == [1, 2] and len(lines) == 3
    assert all(np.isfinite(r[k]) for r in records
               for k in ("box", "obj", "cls", "total"))
    assert cli.build_training(args).opt_cfg.nw == 1000
    off = cli.build_training(args, warmup=False)
    assert off.opt_cfg.nw == 0 and off.accum == 32 and off.augment is None


def test_cli_trains_tiny_graph_with_augmentation_on_cpu(tmp_path):
    """``run_training`` with augmentation on (a hyp with mosaic-9 and
    paste-in off: mosaic-4, mixup, HSV and flips alone): finite losses, and
    the step's augmented batch in range."""
    hyp = tmp_path / "hyp.yaml"
    hyp.write_text("mosaic9: 0.0\npaste_in: 0.0\n")
    args = cli.parse_args(["--cfg", TINY, "--data", "synthetic:4",
                           "--epochs", "1", "--batch-size", "2",
                           "--img-size", str(SIZE), "--hyp", str(hyp),
                           "--no-autoanchor", "--eval-every", "0",
                           "--device", "cpu", "--project",
                           str(tmp_path / "runs")])
    records = cli.run_training(args, emit=lambda line: None)
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r[k]) for r in records
               for k in ("box", "obj", "cls", "total"))
    t = cli.build_training(args)
    batch = next(iter(t.loader.epoch(0)))
    out = t.augment(*[torch.from_numpy(batch[k]) for k in
                      ("images", "hw", "labels", "mask")],
                    t.state.aug_generator)
    assert out.images.shape == (2, SIZE, SIZE, 3)
    assert 0 <= float(out.images.min()) and float(out.images.max()) <= 1
    lab = out.labels[out.mask]
    assert len(lab) and 0 <= float(lab[:, 1:].min()) and \
        float(lab[:, 1:].max()) <= 1
