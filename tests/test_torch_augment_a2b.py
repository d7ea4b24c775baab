"""Port parity for mosaic-9, paste-in and cutout, on the CPU.

``rep_yolo_tpu_torch/data/augment.py``'s ``mosaic9_canvas``,
``mosaic9_sample``, ``mosaic9``, ``paste_in``, ``cutout`` and the whole
``augment_batch`` with all three on, against ``rep_yolo_tpu/data/augment.py``
at S = 64, B = 4, on draws mirrored from one JAX key
(``tests/test_torch_augment.py``'s ``_jax_draws``, which evaluates the JAX
key chains of these three too) and with that file's tolerances. Paste-in and
cutout only copy and fill, so their images are held bit for bit. The JAX
functions run eagerly (a jit of the whole program takes ~65 s), the per-image
ones under ``jax.vmap`` as JAX ``augment_batch`` calls them.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rep_yolo_tpu.data import augment as JA
from rep_yolo_tpu_torch.data import augment as TA
from tests.test_torch_augment import (AFFINE_CASES, B, BOX_TOL, IMG_TOL,
                                      LABEL_TOL, M, S, UNIT_TOL, _cfg,
                                      _close, _inputs, _jax_draws)

# the JAX slow test's values (tests/test_augment_extra.py), which take every
# branch at batch 4; on this key both values of each of their flags show
A2B = dict(mosaic9=0.5, paste_in=0.5, cutout=0.3)
KEY = jax.random.PRNGKey(16)


def _sel9(draws):
    return torch.cat([torch.arange(B)[:, None], draws.partners], 1)


def _jax_mosaic9_canvas(imgs9, hw9):
    """The canvas JAX ``_one_mosaic9`` builds for its separable warp."""
    cy = jax.lax.broadcasted_iota(jnp.float32, (3 * S, 3 * S), 0)
    cx = jax.lax.broadcasted_iota(jnp.float32, (3 * S, 3 * S), 1)
    canvas = jnp.full((3 * S, 3 * S, 3), JA.PAD_VALUE, imgs9.dtype)
    for t in range(9):
        oy, ox = (t // 3) * S, (t % 3) * S
        tile = jnp.pad(imgs9[t], ((oy, 2 * S - oy), (ox, 2 * S - ox),
                                  (0, 0)))
        mask = (cy >= oy) & (cy < oy + hw9[t, 0]) \
            & (cx >= ox) & (cx < ox + hw9[t, 1])
        canvas = jnp.where(mask[..., None], tile, canvas)
    return canvas


def test_draw_batch_a2b_fields():
    """``draw_batch``'s mosaic-9, paste-in and cutout fields: the shapes and
    dtypes of the mirrored JAX draws, and over 4,096 images their ranges,
    both ends of every integer range, and the flags' rates."""
    jcfg, tcfg = _cfg(**A2B)
    ref = _jax_draws(KEY, B, jcfg)
    got = TA.draw_batch(torch.Generator().manual_seed(3), B, tcfg, M)
    for name in TA.Draws._fields:
        g, r = getattr(got, name), getattr(ref, name)
        assert g.shape == r.shape and g.dtype == r.dtype, name
    n = 4096
    big = TA.draw_batch(torch.Generator().manual_seed(4), n, tcfg, M)
    for flag, p in ((big.use9, 0.5), (big.paste_on, 0.5), (big.cut_on, 0.3)):
        assert abs(float(flag.double().mean()) - p) < 0.03
    assert big.paste_src.shape == (n, TA.PASTE_ATTEMPTS)
    assert set(big.paste_src.unique().tolist()) == set(range(M))
    assert 0 <= float(big.paste_dst.min()) and float(big.paste_dst.max()) < 1
    ranges = TA.cutout_ranges(S)
    assert len(ranges) == 31 and ranges[0] == (16, 32) and \
        ranges[-1] == (1, 2)
    for k, (lo, hi) in enumerate(ranges):
        v = big.cut_size[:, k]
        assert int(v.min()) == lo and int(v.max()) == hi, (k, lo, hi)
    assert int(big.cut_center.min()) == 0 and \
        int(big.cut_center.max()) == S - 1
    assert int(big.cut_color.min()) == 64 and int(big.cut_color.max()) == 190


def test_mosaic9_canvas_and_sampler_match_jax():
    """The nine-tile canvas against the one JAX builds for the separable
    warp, and the sampler against ``_mosaic9_sample_fn`` at every integer
    coordinate of the canvas and 3 px beyond it: identical."""
    images, hw, _, _ = _inputs()
    jcfg, _ = _cfg(**A2B)
    sel9 = _sel9(_jax_draws(KEY, B, jcfg))
    ti, th = torch.from_numpy(images), torch.from_numpy(hw)
    canvas = TA.mosaic9_canvas(ti, th, sel9)
    assert canvas.shape == (B, 3 * S, 3 * S, 3)
    idx = torch.arange(-3, 3 * S + 3, dtype=torch.float32)
    cy = idx[:, None].expand(-1, len(idx))
    cx = idx[None, :].expand(len(idx), -1)
    sampled = TA.mosaic9_sample(ti, th, sel9, cy[None].expand(B, -1, -1),
                                cx[None].expand(B, -1, -1))
    for i in range(B):
        s = sel9[i].numpy()
        im9 = jnp.asarray(images[s], jnp.float32)
        ref = _jax_mosaic9_canvas(im9, jnp.asarray(hw[s]))
        np.testing.assert_array_equal(canvas[i].numpy(), np.asarray(ref))
        val, _ = JA._mosaic9_sample_fn(im9, jnp.asarray(hw[s]))(
            jnp.asarray(cy.numpy()), jnp.asarray(cx.numpy()))
        np.testing.assert_array_equal(sampled[i].numpy(), np.asarray(val))
    np.testing.assert_array_equal(sampled[:, 3:-3, 3:-3].numpy(),
                                  canvas.numpy())
    assert (canvas == 114).any() and (canvas != 114).any()


@pytest.mark.parametrize("case", sorted(AFFINE_CASES))
def test_mosaic9_matches_jax(case):
    """Mosaic-9 and its warp (separable for the default hyp, else the
    four-tap gather), its boxes and candidate flags, per image against JAX
    ``_one_mosaic9`` on that image's key."""
    images, hw, labels, mask = _inputs()
    jcfg, tcfg = _cfg(**AFFINE_CASES[case], **A2B)
    draws = _jax_draws(KEY, B, jcfg)
    sel9 = _sel9(draws)
    assert TA._is_separable(tcfg) == (case == "default")
    img, cls, xyxy, valid = TA.mosaic9(
        *map(torch.from_numpy, (images, hw, labels, mask)), sel9,
        draws.affine, tcfg)
    keys = jax.random.split(jax.random.split(KEY, 8)[1], B)
    kept = 0
    for i in range(B):
        s = sel9[i].numpy()
        r_img, r_cls, r_xyxy, r_valid = JA._one_mosaic9(
            jnp.asarray(images[s], jnp.float32), jnp.asarray(hw[s]),
            jnp.asarray(labels[s]), jnp.asarray(mask[s]), keys[i], jcfg)
        _close(img[i].numpy(), r_img, IMG_TOL, (case, i))
        np.testing.assert_array_equal(cls[i].numpy(), np.asarray(r_cls))
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(r_valid))
        _close(xyxy[i].numpy(), r_xyxy, BOX_TOL, (case, i))
        kept += int(np.asarray(r_valid).sum())
    assert kept > 0 and cls.shape == (B, 9 * M)


def _labels_px(seed, n=10):
    """Pixel boxes (B, n, 4) of assorted sizes, some slots invalid."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-4, S, (B, n, 2))
    wh = rng.uniform(1, S / 2, (B, n, 2))
    wh[:, ::3] = rng.uniform(1, 6, (B, len(range(0, n, 3)), 2))
    xyxy = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = rng.random((B, n)) < 0.7
    cls = rng.integers(0, 3, (B, n)).astype(np.float32)
    img = rng.uniform(0, 255, (B, S, S, 3)).astype(np.float32)
    return img, cls, xyxy, valid


def test_paste_in_matches_jax():
    """Paste-in of the batch against JAX ``paste_in`` under ``vmap`` as
    JAX ``augment_batch`` wires it: the partner's boxes from its labels,
    its canvas as the source, its flags gated by ``active``. Images bit for
    bit, classes and flags identical, boxes within 1e-4 px. Attempts that
    paste, that are refused by the IoA test or an empty slot, and pastes
    that overlap all occur."""
    images, hw, labels, mask = _inputs()
    img, cls, xyxy, valid = _labels_px(1)
    jcfg, _ = _cfg(**A2B)
    draws = _jax_draws(KEY, B, jcfg)
    pidx = draws.partners[:, 0]
    th, tl = torch.from_numpy(hw), torch.from_numpy(labels)
    p_cls, p_xyxy = TA.partner_boxes(tl, th, pidx)
    on = torch.ones(B, dtype=torch.bool)
    on[3] = False
    p_valid = torch.from_numpy(mask)[pidx] & on[:, None]
    got = TA.paste_in(torch.from_numpy(img), torch.from_numpy(cls),
                      torch.from_numpy(xyxy), torch.from_numpy(valid),
                      torch.from_numpy(images)[pidx].float(), p_cls,
                      p_xyxy, p_valid, draws.paste_src, draws.paste_dst)

    # the partners' boxes as JAX augment_batch computes them
    jp = np.asarray(pidx)
    lp, p_h, p_w = labels[jp], hw[jp, 0][:, None], hw[jp, 1][:, None]
    ref_p = jnp.stack([(lp[..., 1] - lp[..., 3] / 2) * p_w,
                       (lp[..., 2] - lp[..., 4] / 2) * p_h,
                       (lp[..., 1] + lp[..., 3] / 2) * p_w,
                       (lp[..., 2] + lp[..., 4] / 2) * p_h], -1)
    np.testing.assert_array_equal(p_xyxy.numpy(), np.asarray(ref_p))
    kp = jax.random.split(jax.random.split(KEY, 8)[6], B)
    ref = jax.vmap(JA.paste_in)(
        jnp.asarray(img), jnp.asarray(cls), jnp.asarray(xyxy),
        jnp.asarray(valid), jnp.asarray(images[jp], jnp.float32),
        jnp.asarray(lp[..., 0]), ref_p, jnp.asarray(p_valid.numpy()), kp)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    _close(got[2].numpy(), ref[2], BOX_TOL, "boxes")
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))

    ok = got[3][:, -TA.PASTE_ATTEMPTS:]
    src_ok = p_valid.gather(1, draws.paste_src)
    assert ok.any() and (src_ok & ~ok).any() and (~src_ok).any()
    assert not ok[3].any() and torch.equal(got[0][3], torch.tensor(img[3]))
    box = got[2][:, -TA.PASTE_ATTEMPTS:]
    overlap = 0
    for b in range(B):
        for i in range(TA.PASTE_ATTEMPTS):
            for j in range(i):
                if ok[b, i] and ok[b, j]:
                    w = min(box[b, i, 2], box[b, j, 2]) \
                        - max(box[b, i, 0], box[b, j, 0])
                    h = min(box[b, i, 3], box[b, j, 3]) \
                        - max(box[b, i, 1], box[b, j, 1])
                    overlap += bool(w > 1 and h > 1)
    assert overlap > 0


def test_cutout_matches_jax():
    """Cutout of the batch against JAX ``cutout`` under ``vmap`` on the
    same draws: images bit for bit, the label flags identical; some valid
    labels are dropped and some kept."""
    img, _, xyxy, valid = _labels_px(2)
    jcfg, _ = _cfg(**A2B)
    draws = _jax_draws(KEY, B, jcfg)
    got_img, got_valid = TA.cutout(
        torch.from_numpy(img), torch.from_numpy(xyxy),
        torch.from_numpy(valid), draws.cut_size, draws.cut_center,
        draws.cut_color)
    kc = jax.random.split(jax.random.fold_in(jax.random.split(KEY, 8)[5], 3),
                          B)
    ref_img, ref_valid = jax.vmap(JA.cutout)(
        jnp.asarray(img), jnp.asarray(xyxy), jnp.asarray(valid), kc)
    np.testing.assert_array_equal(got_img.numpy(), np.asarray(ref_img))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(ref_valid))
    dropped = valid & ~got_valid.numpy()
    assert dropped.any() and got_valid.any()
    # the largest box (half the image a side) and a smallest both show
    filled = (got_img.numpy() != img).all(-1)
    assert 0.2 < filled.mean() < 0.9


def test_augment_batch_with_a2b_matches_eager_jax():
    """The whole batch with mosaic-9, paste-in and cutout on (and mixup and
    both flips), against eager JAX ``augment_batch`` on the same key: masks
    identical, labels within 1e-5, images within ``UNIT_TOL``. Both values
    of ``use9`` and of paste-in's and cutout's ``active`` are taken, and
    some image's labels reach ``max_labels``."""
    images, hw, labels, mask = _inputs()
    kw = dict(A2B, mixup=0.5, fliplr=0.5, flipud=0.5)
    jcfg, tcfg = _cfg(**kw)
    draws = _jax_draws(KEY, B, jcfg)
    for flag in (draws.use9, draws.paste_on, draws.cut_on, draws.mix):
        assert 0 < int(flag.sum()) < B
    args = (images, hw, labels, mask)
    got = TA.augment_batch(*map(torch.from_numpy, args), draws, tcfg)
    ref = JA.augment_batch(*map(jnp.asarray, args), KEY, jcfg)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    _close(got.labels.numpy(), ref.labels, LABEL_TOL, "labels")
    _close(got.images.numpy(), ref.images, UNIT_TOL, "images")
    assert int(got.mask.sum(1).max()) == tcfg.max_labels
    img = got.images.numpy()
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0
