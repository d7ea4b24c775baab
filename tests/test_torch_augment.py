"""Port parity for train-time augmentation, on the CPU.

Every function of ``rep_yolo_tpu_torch/data/augment.py`` against its JAX
counterpart in ``rep_yolo_tpu/data/augment.py`` at S = 64, B = 4, on numpy
inputs from a seed and on draws mirrored from one JAX key (``_jax_draws``
splits the key as ``augment_batch`` does and evaluates the JAX draws), so
both sides see the same random values. The whole ``augment_batch`` is held
against the jitted JAX function, as the JAX train step runs it, and one
augmented train step of the tiny graph against the JAX step with an
``augment_fn``.

Tolerances. Both sides compute in float32 but round apart: the matrix
inverse (LU on both sides, in other orders), the 3 x 3 products and the
interpolation products. A canvas coordinate is Minv00 x + Minv02, whose
terms reach 1/0.1 x 64 and ~400 here (scale draws down to 0.1), below
1024, where a float32 ulp is 2**-14 px at most; a pixel moves by the
coordinate's error times the image's gradient, at most 255 a pixel. So
warped images (0-255) are held to 4 such ulps times 255, 0.062, and images
on [0, 1] after HSV (value gain up to 1.4) to 4e-4. Box coordinates (pixels
below 128) are held to 1e-4, normalized labels to 1e-5; masks, candidate
flags and every value derived from the draws exactly. The whole batch is
also held against the jitted JAX function, as the JAX train step runs it:
there XLA's fusion rounds some HSV inputs apart from eager JAX, and a pixel
whose largest channel then fails its comparison takes another hue sector
(62 of 49,152 elements in the gather case, where eager JAX agrees with the
port to 5e-6): such a pixel keeps its largest and smallest channel, which
are checked, and at most 0.2 % of the elements may be such.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rep_yolo_tpu.data import augment as JA
from rep_yolo_tpu_torch.data import augment as TA

S = 64
B = 4
M = 6
MAX_LABELS = 16
KEY = jax.random.PRNGKey(0)
IMG_TOL = 255 * 4 * 2.0 ** -14    # 0-255 scale
UNIT_TOL = 4e-4                    # [0, 1] scale
BOX_TOL = 1e-4          # pixels
LABEL_TOL = 1e-5        # normalized


def _inputs(seed=0):
    """uint8 canvases (content top left, 114 around), hw, content-normalized
    labels with some slots empty."""
    rng = np.random.default_rng(seed)
    images = np.full((B, S, S, 3), 114, np.uint8)
    hw = np.stack([rng.integers(S // 2, S + 1, B),
                   rng.integers(S // 2, S + 1, B)], 1).astype(np.float32)
    hw[0] = (S, S)
    labels = np.zeros((B, M, 5), np.float32)
    mask = np.zeros((B, M), bool)
    for b, (h, w) in enumerate(hw.astype(int)):
        images[b, :h, :w] = rng.integers(0, 256, (h, w, 3))
        n = int(rng.integers(1, M + 1))
        wh = rng.uniform(0.1, 0.5, (n, 2))
        c = rng.uniform(wh / 2, 1 - wh / 2)
        labels[b, :n] = np.concatenate(
            [rng.integers(0, 3, (n, 1)), c, wh], 1)
        mask[b, :n] = True
    return images, hw, labels, mask


def _cfg(**kw):
    base = dict(img_size=S, mosaic9=0.0, paste_in=0.0, cutout=0.0,
                max_labels=MAX_LABELS)
    return JA.AugmentConfig(**{**base, **kw}), \
        TA.AugmentConfig(**{**base, **kw})


def _affine_u(key, cfg):
    """The eight affine draws of JAX ``_affine_matrix``'s key split."""
    kp, ka, ks, ksh1, ksh2, ktx, kty = jax.random.split(key, 7)
    u = jax.random.uniform
    p, d, sh, t = cfg.perspective, cfg.degrees, cfg.shear, cfg.translate
    return [u(kp, (), minval=-p, maxval=p),
            u(jax.random.fold_in(kp, 1), (), minval=-p, maxval=p),
            u(ka, (), minval=-d, maxval=d),
            u(ks, (), minval=1 - cfg.scale, maxval=1.1 + cfg.scale),
            u(ksh1, (), minval=-sh, maxval=sh),
            u(ksh2, (), minval=-sh, maxval=sh),
            u(ktx, (), minval=0.5 - t, maxval=0.5 + t),
            u(kty, (), minval=0.5 - t, maxval=0.5 + t)]


def _jax_draws(key, batch, cfg, slots=M):
    """The port's ``Draws`` of JAX ``augment_batch(..., key, cfg)`` for
    labels of ``slots`` slots: its nested key splits, evaluated. Paste-in's
    and cutout's chains are evaluated only where ``cfg`` turns them on (JAX
    reads them only then); else zeros of their shapes stand in."""
    keys = jax.random.split(key, 8)
    partners = jax.random.randint(keys[0], (batch, 8), 0, batch)
    centers, affine, use9 = [], [], []
    for k in jax.random.split(keys[1], batch):
        k_center, k_aff = jax.random.split(k)
        centers.append(jnp.floor(jax.random.uniform(
            k_center, (2,), minval=S / 2, maxval=1.5 * S)))
        affine.append(jnp.stack(_affine_u(k_aff, cfg)))
        use9.append(jax.random.uniform(jax.random.fold_in(k, 99))
                    < cfg.mosaic9)
    mix = jax.random.uniform(keys[2], (batch,)) < cfg.mixup
    ratio = jax.random.beta(keys[3], 8.0, 8.0, (batch, 1, 1, 1))
    hsv = [jax.random.uniform(k, (3,), minval=-1.0, maxval=1.0)
           for k in jax.random.split(keys[4], batch)]
    kud, klr = jax.random.split(keys[5])
    t = lambda a: torch.from_numpy(np.array(a))
    n = len(TA.CUTOUT_SCALES)
    paste = (torch.zeros(batch, 8, dtype=torch.long),
             torch.zeros(batch, 8, 2), torch.zeros(batch, dtype=torch.bool))
    if cfg.paste_in > 0:
        src, dst = jax.vmap(lambda k: _paste_draws(k, slots))(
            jax.random.split(keys[6], batch))
        paste = (t(src).long(), t(dst),
                 t(jax.random.uniform(keys[7], (batch,)) < cfg.paste_in))
    cut = (torch.zeros(batch, n, 2, dtype=torch.long),
           torch.zeros(batch, n, 2, dtype=torch.long),
           torch.zeros(batch, n, 3, dtype=torch.long),
           torch.zeros(batch, dtype=torch.bool))
    if cfg.cutout > 0:
        size, center, color = jax.vmap(_cutout_draws)(jax.random.split(
            jax.random.fold_in(keys[5], 3), batch))
        cut = (t(size).long(), t(center).long(), t(color).long(),
               t(jax.random.uniform(jax.random.fold_in(keys[5], 4),
                                    (batch,)) < cfg.cutout))
    return TA.Draws(
        partners=t(partners).long(), center=t(jnp.stack(centers)),
        affine=t(jnp.stack(affine)), mix=t(mix),
        ratio=t(ratio.reshape(batch)), hsv=t(jnp.stack(hsv)),
        flipud=t(jax.random.uniform(kud, (batch,)) < cfg.flipud),
        fliplr=t(jax.random.uniform(klr, (batch,)) < cfg.fliplr),
        use9=t(jnp.stack(use9)), paste_src=paste[0], paste_dst=paste[1],
        paste_on=paste[2], cut_size=cut[0], cut_center=cut[1],
        cut_color=cut[2], cut_on=cut[3])


def _paste_draws(key, slots):
    """JAX ``paste_in``'s draws from one image's key: (src (8,), dst (8,
    2))."""
    src, dst = [], []
    for j in range(TA.PASTE_ATTEMPTS):
        k1, k2 = jax.random.split(jax.random.fold_in(key, j))
        src.append(jax.random.randint(k1, (), 0, slots))
        dst.append(jax.random.uniform(k2, (2,), minval=0.0, maxval=1.0))
    return jnp.stack(src), jnp.stack(dst)


def _cutout_draws(key):
    """JAX ``cutout``'s draws from one image's key: (size (31, 2) as (h, w),
    centre (31, 2) as (y, x), colour (31, 3)); the key re-bound each box
    and the colour's drawn from the new one."""
    size, center, color = [], [], []
    for i, (lo, hi) in enumerate(TA.cutout_ranges(S)):
        k1, k2, k3, key = jax.random.split(jax.random.fold_in(key, i), 4)
        size.append(jnp.stack([jax.random.randint(k1, (), lo, hi + 1),
                               jax.random.randint(k2, (), lo, hi + 1)]))
        center.append(jax.random.randint(k3, (2,), 0, S))
        color.append(jax.random.randint(jax.random.fold_in(key, 7 * i),
                                        (3,), 64, 191))
    return jnp.stack(size), jnp.stack(center), jnp.stack(color)


def _sel(draws):
    return torch.cat([torch.arange(B)[:, None], draws.partners[:, :3]], 1)


def _image_keys(key):
    """(k_center, k_aff) of each image, as ``augment_batch`` splits them."""
    ks = jax.random.split(jax.random.split(key, 8)[1], B)
    return [jax.random.split(k) for k in ks]


def _close(got, ref, atol, what):
    err = float(np.abs(np.asarray(got, np.float64)
                       - np.asarray(ref, np.float64)).max())
    assert err <= atol, (what, err)
    return err


AFFINE_CASES = {"default": {}, "rotate_shear_perspective": dict(
    degrees=10.0, shear=5.0, perspective=0.001, translate=0.1, scale=0.5)}


@pytest.mark.parametrize("case", sorted(AFFINE_CASES))
def test_affine_matrix_matches_jax(case):
    jcfg, tcfg = _cfg(**AFFINE_CASES[case])
    draws = _jax_draws(KEY, B, jcfg)
    got = TA.affine_matrix(draws.affine, S, 2 * S)
    ref = np.stack([JA._affine_matrix(k_aff, S, jcfg, 2 * S)
                    for _, k_aff in _image_keys(KEY)])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-5)


def test_mosaic_canvas_matches_jax():
    images, hw, _, _ = _inputs()
    jcfg, _ = _cfg()
    draws = _jax_draws(KEY, B, jcfg)
    sel = _sel(draws)
    got = TA.mosaic_canvas(torch.from_numpy(images), torch.from_numpy(hw),
                           sel, draws.center)
    for i in range(B):
        s = sel[i].numpy()
        ref = JA._mosaic_canvas(jnp.asarray(images[s], jnp.float32),
                                jnp.asarray(hw[s]),
                                jnp.asarray(draws.center[i].numpy()))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref))
    # the four tiles and the gray around them all show
    assert (got == 114).any() and (got != 114).any()


@pytest.mark.parametrize("zoom_out", [False, True])
@pytest.mark.parametrize("case", sorted(AFFINE_CASES))
def test_warps_match_jax(case, zoom_out):
    """The separable warp of the canvas where the hyp allows it, else the
    four-tap gather (perspective divide included), per image against JAX.
    ``zoom_out`` replaces the drawn scales (here 0.66-1.41, so the output
    stays on the canvas) by 0.15-1.2, so that the footprint also leaves the
    canvas."""
    images, hw, _, _ = _inputs()
    jcfg, tcfg = _cfg(**AFFINE_CASES[case])
    draws = _jax_draws(KEY, B, jcfg)
    sel = _sel(draws)
    ti, th = torch.from_numpy(images), torch.from_numpy(hw)
    u = draws.affine.clone()
    if zoom_out:
        u[:, 3] = torch.tensor([0.15, 0.3, 0.6, 1.2])
    M = TA.affine_matrix(u, S, 2 * S)
    Minv = torch.linalg.inv(M)
    cx = Minv[:, 0, 0, None] * torch.arange(S) + Minv[:, 0, 2, None]
    assert bool(((cx < 0) | (cx > 2 * S - 1)).any()) == zoom_out
    persp = tcfg.perspective != 0.0
    separable = TA._is_separable(tcfg)
    assert separable == (case == "default")
    if separable:
        got = TA.warp_separable(TA.mosaic_canvas(ti, th, sel, draws.center),
                                M, S)
    else:
        got = TA.warp(functools.partial(TA.mosaic_sample, ti, th, sel,
                                        draws.center), M, S, persp)
    for i in range(B):
        s = sel[i].numpy()
        im4 = jnp.asarray(images[s], jnp.float32)
        hw4 = jnp.asarray(hw[s])
        c = jnp.asarray(draws.center[i].numpy())
        Mi = jnp.asarray(M[i].numpy())
        ref = (JA._warp_separable(JA._mosaic_canvas(im4, hw4, c), Mi, S)
               if separable else
               JA._warp(JA._mosaic_sample_fn(im4, hw4, c), Mi, S, persp))
        _close(got[i].numpy(), ref, IMG_TOL, (case, i))


@pytest.mark.parametrize("case", sorted(AFFINE_CASES))
def test_transform_labels_matches_jax(case):
    """Boxes after the warp and clip, and the candidate flags."""
    jcfg, tcfg = _cfg(**AFFINE_CASES[case])
    draws = _jax_draws(KEY, B, jcfg)
    M = TA.affine_matrix(draws.affine, S, 2 * S)
    rng = np.random.default_rng(5)
    n = 40
    xy = rng.uniform(0, 2 * S, (B, n, 2))
    wh = rng.uniform(0, S / 2, (B, n, 2))
    xyxy = np.concatenate([xy, np.minimum(xy + wh, 2 * S)], -1).astype(
        np.float32)
    valid = rng.random((B, n)) < 0.8
    scale_s = torch.sqrt(M[:, 0, 0] ** 2 + M[:, 1, 0] ** 2)
    persp = tcfg.perspective != 0.0
    got, ok = TA.transform_labels(torch.from_numpy(xyxy),
                                  torch.from_numpy(valid), M, S, scale_s,
                                  persp)
    kept = 0
    for i in range(B):
        ref, rok = JA._transform_labels(
            jnp.asarray(xyxy[i]), jnp.asarray(valid[i]),
            jnp.asarray(M[i].numpy()), S, jnp.asarray(scale_s[i].numpy()),
            persp)
        _close(got[i].numpy(), ref, BOX_TOL, (case, i))
        np.testing.assert_array_equal(ok[i].numpy(), np.asarray(rok))
        kept += int(np.asarray(rok).sum())
    # the candidate test keeps some boxes and drops some valid ones
    assert 0 < kept < valid.sum()


def test_hsv_jitter_matches_jax():
    rng = np.random.default_rng(7)
    img = rng.random((B, S, S, 3)).astype(np.float32)
    img[:, :4] = 114 / 255        # gray: d = 0
    img[:, 4:8, :, 0] = img[:, 4:8, :, 1]   # ties of the largest channel
    jcfg, tcfg = _cfg(hsv_h=0.5, hsv_s=0.7, hsv_v=0.4)
    keys = jax.random.split(jax.random.split(KEY, 8)[4], B)
    gains = torch.stack([torch.from_numpy(np.asarray(jax.random.uniform(
        k, (3,), minval=-1.0, maxval=1.0))) for k in keys])
    got = TA.hsv_jitter(torch.from_numpy(img), gains, tcfg).numpy()
    ref = np.asarray(jax.vmap(lambda im, k: JA.hsv_jitter(im, k, jcfg))(
        jnp.asarray(img), keys))
    err = np.abs(got - ref)
    assert err.max() <= UNIT_TOL, float(err.max())
    assert got.min() >= 0 and got.max() <= 1


def test_pack_labels_matches_jax():
    rng = np.random.default_rng(9)
    n = 40
    cls = rng.integers(0, 5, (B, n)).astype(np.float32)
    xy = rng.uniform(0, S, (B, n, 2))
    xyxy = np.concatenate([xy, xy + rng.uniform(0, 8, (B, n, 2))],
                          -1).astype(np.float32)
    valid = rng.random((B, n)) < 0.3
    valid[0] = True               # more valid labels than slots
    valid[1] = False
    got, gv = TA.pack_labels(torch.from_numpy(cls), torch.from_numpy(xyxy),
                             torch.from_numpy(valid), S, MAX_LABELS)
    ref, rv = jax.vmap(lambda c, b, v: JA._pack_labels(c, b, v, S,
                                                       MAX_LABELS))(
        jnp.asarray(cls), jnp.asarray(xyxy), jnp.asarray(valid))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-7)


BATCH_CASES = {
    "separable": dict(mixup=0.5, fliplr=0.5, flipud=0.5),
    "gather": dict(mixup=0.5, fliplr=0.5, flipud=0.5, degrees=10.0,
                   shear=5.0, perspective=0.001)}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_augment_batch_matches_jax(case):
    """The whole batch against the jitted JAX ``augment_batch`` on the same
    key: masks identical, labels within 1e-5, images within ``UNIT_TOL`` but
    for at most 0.2 % of the elements, and at each pixel holding such an
    element the largest and smallest channel (HSV's value and saturation)
    within ``UNIT_TOL``: only its hue may differ (see the module's
    docstring). The separable case, the hyps' default, also against eager
    JAX, every element within ``UNIT_TOL`` (eager JAX of the gather case
    takes ~20 s here; its warp and HSV are held to eager JAX above). Both
    values of the mixup flag and of each flip are taken."""
    images, hw, labels, mask = _inputs()
    jcfg, tcfg = _cfg(**BATCH_CASES[case])
    draws = _jax_draws(KEY, B, jcfg)
    for flag in (draws.mix, draws.flipud, draws.fliplr):
        assert 0 < int(flag.sum()) < B
    args = (images, hw, labels, mask)
    ref = jax.jit(lambda im, h, lb, mk, k: JA.augment_batch(
        im, h, lb, mk, k, jcfg))(*args, KEY)
    got = TA.augment_batch(*map(torch.from_numpy, args), draws, tcfg)
    assert got.images.shape == (B, S, S, 3) and got.images.dtype == \
        torch.float32
    assert got.labels.shape == (B, MAX_LABELS, 5) and got.mask.any()
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    _close(got.labels.numpy(), ref.labels, LABEL_TOL, "labels")
    img, rimg = got.images.numpy(), np.asarray(ref.images)
    off = np.abs(img - rimg) > UNIT_TOL
    assert off.sum() <= 0.002 * off.size, int(off.sum())
    px = off.any(-1)
    if px.any():
        for f in (np.max, np.min):
            _close(f(img[px], -1), f(rimg[px], -1), UNIT_TOL, f.__name__)
    if case == "separable":
        eager = JA.augment_batch(*map(jnp.asarray, args), KEY, jcfg)
        np.testing.assert_array_equal(got.mask.numpy(),
                                      np.asarray(eager.mask))
        _close(got.labels.numpy(), eager.labels, LABEL_TOL, "labels")
        _close(img, eager.images, UNIT_TOL, "images")
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0


def test_draw_batch_shapes_ranges_and_beta():
    """``draw_batch``: the shapes and ranges of the JAX draws, and the
    Beta(8, 8) sampler's mean 0.5 and variance 1/68 over 4,096 draws."""
    _, tcfg = _cfg(degrees=10.0, shear=5.0, perspective=0.001, mixup=0.5,
                   flipud=0.5)
    jcfg, _ = _cfg(degrees=10.0, shear=5.0, perspective=0.001, mixup=0.5,
                   flipud=0.5)
    ref = _jax_draws(KEY, B, jcfg)
    got = TA.draw_batch(torch.Generator().manual_seed(1), B, tcfg, M)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
    assert int(got.partners.min()) >= 0 and int(got.partners.max()) < B
    assert torch.equal(got.center, torch.floor(got.center))
    assert S / 2 <= float(got.center.min()) <= float(got.center.max()) \
        < 1.5 * S
    lo = torch.tensor([-0.001, -0.001, -10, 0.1, -5, -5, 0.3, 0.3])
    hi = torch.tensor([0.001, 0.001, 10, 2.0, 5, 5, 0.7, 0.7])
    assert ((got.affine >= lo) & (got.affine <= hi)).all()
    assert float(got.hsv.abs().max()) <= 1.0
    big = TA.draw_batch(torch.Generator().manual_seed(2), 4096, tcfg, M)
    r = big.ratio.double()
    assert float(r.min()) > 0 and float(r.max()) < 1
    assert abs(float(r.mean()) - 0.5) < 0.01
    assert abs(float(r.var()) - 1 / 68) < 0.15 / 68
    assert 0.45 < float(big.mix.double().mean()) < 0.55


def test_train_step_with_augmentation_matches_jax():
    """One train step of the tiny graph at 64 px, batch 4, with augmentation
    (the separable case: mixup and both flips at 0.5), against the jitted
    JAX step with an ``augment_fn``. The port's draws are mirrored from the
    ``k_aug`` that the JAX step splits off ``state.rng``; dropout takes one
    numpy mask per call on both sides, as in ``test_torch_train_slice``.
    The loss components are held to 1e-3, that file's float32 tolerance
    against the JAX package."""
    from flax import linen as fnn

    from rep_yolo_tpu.models.model import RepYOLO as JaxRepYOLO
    from rep_yolo_tpu.models.model import initialize_detect_biases
    from rep_yolo_tpu.train import loss as JL
    from rep_yolo_tpu.train import optim as JO
    from rep_yolo_tpu.train import trainer as JT
    from rep_yolo_tpu_torch.models.model import RepYOLO
    from rep_yolo_tpu_torch.nn import blocks as TB
    from rep_yolo_tpu_torch.train import loss as TL
    from rep_yolo_tpu_torch.train import optim as TO
    from rep_yolo_tpu_torch.train.trainer import (create_train_state,
                                                  make_train_step)
    from rep_yolo_tpu_torch.utils.weights import state_dict_from_jax
    from tests.test_torch_bf16_slice import _numpy_variables
    from tests.test_torch_train_slice import TINY, _JaxMasks, _mask

    batch = _inputs()
    batch[2][..., 0] = 0           # the tiny graph is single-class
    jcfg, tcfg = _cfg(**BATCH_CASES["separable"])
    jmodel = JaxRepYOLO.from_config(TINY)
    variables = _numpy_variables(jmodel.net, jnp.zeros((1, S, S, 3)), 0)
    variables["params"] = initialize_detect_biases(
        variables["params"], jmodel.cfg, jmodel.strides)
    opt_kw = dict(epochs=30, nb=10, lr0=0.01, weight_decay=5e-4,
                  warmup_epochs=0, warmup_floor=0)
    jstep = jax.jit(JT.make_train_step(
        jmodel, JL.LossConfig(nc=1), JO.OptimConfig(**opt_kw), S,
        use_ota=True, augment_fn=lambda im, hw, lb, mk, k: JA.augment_batch(
            im, hw, lb, mk, k, jcfg)))
    state0 = JT.create_train_state(variables, jax.random.PRNGKey(1))
    masks = _JaxMasks()
    with fnn.intercept_methods(masks):
        _, jcomps = jstep(state0, *batch)
    assert masks.calls == 7
    k_aug = jax.random.split(state0.rng, 3)[1]
    draws = _jax_draws(k_aug, B, jcfg)

    model = RepYOLO.from_config(TINY, device="cpu").load_state(
        state_dict_from_jax(variables))
    der = {id(m.dropout) for m in model.net.modules()
           if isinstance(m, TB.DERBlock)}
    count = [0]

    def keep_mask(self, x):
        count[0] += 1
        if id(self) in der:
            b, c, h, w = x.shape
            return torch.from_numpy(_mask(count[0], (b, h, w, c))).permute(
                0, 3, 1, 2)
        return torch.from_numpy(_mask(count[0], tuple(x.shape)))

    seen = []

    def augment_fn(im, hw, lb, mk, gen):
        seen.append(gen)
        return TA.augment_batch(im, hw, lb, mk, draws, tcfg)

    step = make_train_step(model, TL.LossConfig(nc=1),
                           TO.OptimConfig(**opt_kw), S,
                           augment_fn=augment_fn)
    state = create_train_state(model, seed=1)
    orig = TB.Dropout.keep_mask
    TB.Dropout.keep_mask = keep_mask
    try:
        comps = step(state, *map(torch.from_numpy, batch))
    finally:
        TB.Dropout.keep_mask = orig
    assert count[0] == 7 and seen == [state.aug_generator]
    for k in ("box", "obj", "cls", "total"):
        np.testing.assert_allclose(float(comps[k]), float(jcomps[k]),
                                   rtol=1e-3, atol=1e-7)
    assert float(comps["cls"]) > 0 or float(comps["box"]) > 0
