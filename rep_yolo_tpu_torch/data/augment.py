"""Train-time augmentation on the device (port of
``rep_yolo_tpu/data/augment.py``): mosaic-4 or mosaic-9 with the random
affine or perspective warp and its label transform, paste-in, cutout, mixup,
HSV and flips, batched over the images in float32 with no host
synchronisation; and the no-augment input contract, ``identity_batch``.

Randomness is kept apart from arithmetic. ``draw_batch`` draws from a
``torch.Generator`` every value that ``augment_batch`` uses: the values the
JAX ops draw, in their shapes and ranges. Every other function is
deterministic in those draws, so each can be held against its JAX
counterpart on draws taken from a JAX key.

Inputs are the loader's: images (B, S, S, 3) uint8 or float 0-255 with the
content at the top left and 114 around it; hw (B, 2) the content's (h, w);
labels (B, M, 5) [cls, xc, yc, w, h] normalized to the content; mask (B, M)
bool. Mosaic partners come from within the batch.

Where the JAX package branches per image on a drawn value (mosaic-9 or
mosaic-4 by ``lax.cond``), both branches are computed for the whole batch and
``torch.where`` picks; where it loops over paste-in's attempts or cutout's
boxes, all are computed at once and, per pixel, the highest index that covers
it wins, as the last write does in the loop. ``cfg.mosaic`` is not read:
every image is a mosaic, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import NamedTuple

import torch

from rep_yolo_tpu_torch.data.letterbox import PAD_VALUE, _interp_matrix


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    img_size: int = 640
    degrees: float = 0.0
    translate: float = 0.2
    scale: float = 0.9
    shear: float = 0.0
    perspective: float = 0.0
    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    flipud: float = 0.0
    fliplr: float = 0.5
    mosaic: float = 1.0
    mosaic9: float = 0.2     # P(9-mosaic | mosaic)
    mixup: float = 0.15
    paste_in: float = 0.15   # copy-paste probability
    cutout: float = 0.0      # the reference defines cutout but ships it off
    max_labels: int = 120


class Batch(NamedTuple):
    images: torch.Tensor   # (B, S, S, 3) float32 in [0, 1]
    labels: torch.Tensor   # (B, max_labels, 5) [cls, xc, yc, w, h] normalized
    mask: torch.Tensor     # (B, max_labels) bool


# paste-in's attempts an image (JAX ``paste_in``'s ``attempts``)
PASTE_ATTEMPTS = 8
# cutout's box-scale schedule (reference utils/datasets.py:1140): 1x 1/2,
# 2x 1/4, 4x 1/8, 8x 1/16, 16x 1/32 of the image
CUTOUT_SCALES = (0.5,) * 1 + (0.25,) * 2 + (0.125,) * 4 + (0.0625,) * 8 \
    + (0.03125,) * 16


class Draws(NamedTuple):
    """Every random value of one ``augment_batch`` call."""
    partners: torch.Tensor  # (B, 8) int64 in [0, B); mosaic-4 takes 3
    center: torch.Tensor    # (B, 2) (yc, xc): floor of U(S/2, 1.5 S)
    affine: torch.Tensor    # (B, 8): perspective x, y; degrees; scale; shear
    #                         x, y in degrees; translate x, y as fractions of S
    mix: torch.Tensor       # (B,) bool: U < mixup
    ratio: torch.Tensor     # (B,) Beta(8, 8)
    hsv: torch.Tensor       # (B, 3) hue, saturation, value gains in U(-1, 1)
    flipud: torch.Tensor    # (B,) bool
    fliplr: torch.Tensor    # (B,) bool
    use9: torch.Tensor      # (B,) bool: U < mosaic9, mosaic-9 for mosaic-4
    paste_src: torch.Tensor  # (B, 8) int64: the partner's label slot, [0, M)
    paste_dst: torch.Tensor  # (B, 8, 2) U(0, 1): (x, y) shares of the room
    paste_on: torch.Tensor  # (B,) bool: U < paste_in
    cut_size: torch.Tensor  # (B, 31, 2) int64 (h, w): cutout_ranges, ends in
    cut_center: torch.Tensor  # (B, 31, 2) int64 (y, x) in [0, S)
    cut_color: torch.Tensor  # (B, 31, 3) int64 in [64, 191)
    cut_on: torch.Tensor    # (B,) bool: U < cutout


def cutout_ranges(size: int) -> list[tuple[int, int]]:
    """Each cutout box's (least, largest) side in pixels, both ends drawn."""
    return [(int(size * sc * 0.5), max(int(size * sc), 1))
            for sc in CUTOUT_SCALES]


def _uniform(gen: torch.Generator, shape, lo: float, hi: float):
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u * (hi - lo) + lo


def draw_batch(gen: torch.Generator, batch: int, cfg: AugmentConfig,
               slots: int) -> Draws:
    """The draws of one ``augment_batch`` call, on ``gen``'s device, for
    labels of ``slots`` slots an image (the loader's M). Beta(8, 8) is X /
    (X + Y) of two Gamma(8, 1), each a sum of eight -log U. Every field is
    drawn whatever ``cfg`` turns on."""
    S = cfg.img_size
    dev = gen.device
    partners = torch.randint(0, batch, (batch, 8), generator=gen, device=dev)
    center = torch.floor(_uniform(gen, (batch, 2), S / 2, 1.5 * S))
    p, d, t, sh = cfg.perspective, cfg.degrees, cfg.translate, cfg.shear
    ranges = ((-p, p), (-p, p), (-d, d), (1 - cfg.scale, 1.1 + cfg.scale),
              (-sh, sh), (-sh, sh), (0.5 - t, 0.5 + t), (0.5 - t, 0.5 + t))
    u = torch.rand((batch, 8), generator=gen, device=dev)
    affine = torch.stack([u[:, i] * (hi - lo) + lo
                          for i, (lo, hi) in enumerate(ranges)], 1)
    mix = torch.rand(batch, generator=gen, device=dev) < cfg.mixup
    gam = -torch.log1p(-torch.rand((2, batch, 8), generator=gen,
                                   device=dev)).sum(-1)
    ratio = gam[0] / (gam[0] + gam[1])
    hsv = _uniform(gen, (batch, 3), -1.0, 1.0)
    flips = torch.rand((2, batch), generator=gen, device=dev)
    use9 = torch.rand(batch, generator=gen, device=dev) < cfg.mosaic9
    paste_src = torch.randint(0, slots, (batch, PASTE_ATTEMPTS),
                              generator=gen, device=dev)
    paste_dst = torch.rand((batch, PASTE_ATTEMPTS, 2), generator=gen,
                           device=dev)
    paste_on = torch.rand(batch, generator=gen, device=dev) < cfg.paste_in
    n = len(CUTOUT_SCALES)
    # one draw a run of boxes of one range (the host's ints: no copy to the
    # device)
    cut_size = torch.cat([
        torch.randint(lo, hi + 1, (batch, len(list(run)), 2), generator=gen,
                      device=dev)
        for (lo, hi), run in itertools.groupby(cutout_ranges(S))], 1)
    cut_center = torch.randint(0, S, (batch, n, 2), generator=gen,
                               device=dev)
    cut_color = torch.randint(64, 191, (batch, n, 3), generator=gen,
                              device=dev)
    cut_on = torch.rand(batch, generator=gen, device=dev) < cfg.cutout
    return Draws(partners, center, affine, mix, ratio, hsv,
                 flips[0] < cfg.flipud, flips[1] < cfg.fliplr, use9,
                 paste_src, paste_dst, paste_on, cut_size, cut_center,
                 cut_color, cut_on)


def affine_matrix(u: torch.Tensor, size: int, canvas: int) -> torch.Tensor:
    """(B, 3, 3) forward transforms M = T S R P C in float32 from the affine
    draws ``u`` (B, 8), in cv2's convention (reference
    utils/datasets.py:1026-1054). ``canvas``: the input extent (2 S for a
    mosaic); the output extent is ``size``."""
    one, zero = torch.ones_like(u[:, 0]), torch.zeros_like(u[:, 0])

    def mat(*rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    c = torch.full_like(zero, -canvas / 2)
    C = mat((one, zero, c), (zero, one, c), (zero, zero, one))
    P = mat((one, zero, zero), (zero, one, zero), (u[:, 0], u[:, 1], one))
    a = u[:, 2] * math.pi / 180.0
    s = u[:, 3]
    cs, sn = torch.cos(a) * s, torch.sin(a) * s
    R = mat((cs, sn, zero), (-torch.sin(a) * s, cs, zero), (zero, zero, one))
    sh1 = torch.tan(u[:, 4] * math.pi / 180)
    sh2 = torch.tan(u[:, 5] * math.pi / 180)
    S = mat((one, sh1, zero), (sh2, one, zero), (zero, zero, one))
    T = mat((one, zero, u[:, 6] * size), (zero, one, u[:, 7] * size),
            (zero, zero, one))
    return T @ S @ R @ P @ C


def _inverse(M: torch.Tensor) -> torch.Tensor:
    # no check of the pivots: that would wait for the device
    return torch.linalg.inv_ex(M).inverse


def mosaic_sample(images, hw, sel, center, cy, cx) -> torch.Tensor:
    """Sample the virtual 2S x 2S four-tile mosaic canvas of each image at
    integer coordinates ``cy``, ``cx`` (B, ...) (reference load_mosaic
    placement, utils/datasets.py:719-736): tile t = 2 bottom + right comes
    from ``images[sel[:, t]]``, content origin at the centre ``center`` (B,
    2) less its (h, w) on the left and top. Outside the tile's content:
    ``PAD_VALUE``. Returns float32 (B, ..., 3)."""
    B, S = images.shape[0], images.shape[1]
    view = (B,) + (1,) * (cy.dim() - 1)
    yc, xc = center[:, 0].view(view), center[:, 1].view(view)
    right, bottom = cx >= xc, cy >= yc
    tile = bottom.long() * 2 + right.long()                 # (B, ...)
    flat = tile.reshape(B, -1)
    hw4 = hw[sel].float()                                   # (B, 4, 2)
    th = hw4[..., 0].gather(1, flat).view_as(tile)
    tw = hw4[..., 1].gather(1, flat).view_as(tile)
    sx = cx - torch.where(right, xc, xc - tw)
    sy = cy - torch.where(bottom, yc, yc - th)
    ok = (sx >= 0) & (sx < tw) & (sy >= 0) & (sy < th)
    src = sel.gather(1, flat).view_as(tile)
    val = images[src, sy.clamp(0, S - 1).long(), sx.clamp(0, S - 1).long()]
    return torch.where(ok[..., None], val.float(), PAD_VALUE)


def mosaic_canvas(images, hw, sel, center) -> torch.Tensor:
    """The 2S x 2S mosaic canvases (B, 2S, 2S, 3) float32 (JAX
    ``_mosaic_canvas``)."""
    S = images.shape[1]
    idx = torch.arange(2 * S, dtype=torch.float32, device=images.device)
    return mosaic_sample(images, hw, sel, center, idx[None, :, None],
                         idx[None, None, :])


def warp_separable(canvas: torch.Tensor, M: torch.Tensor,
                   size: int) -> torch.Tensor:
    """Inverse-warp the canvases (B, Hc, Wc, 3) through diagonal affine M
    (B, 3, 3): out = Ry canvas Rx^T, two batched float32 products of dense
    (size x Hc), (size x Wc) bilinear matrices, with ``PAD_VALUE`` blended
    by the share of the footprint that leaves the canvas."""
    Minv = _inverse(M)
    idx = torch.arange(size, dtype=torch.float32, device=canvas.device)
    cx = Minv[:, 0, 0, None] * idx + Minv[:, 0, 2, None]
    cy = Minv[:, 1, 1, None] * idx + Minv[:, 1, 2, None]
    ry, sy = _interp_matrix(cy, canvas.shape[1])            # (B, size, Hc)
    rx, sx = _interp_matrix(cx, canvas.shape[2])
    tmp = torch.matmul(ry[:, None], canvas.permute(0, 3, 1, 2))
    out = torch.matmul(tmp, rx[:, None].transpose(-1, -2))  # (B, 3, y, x)
    cover = sy[:, :, None] * sx[:, None, :]
    return out.permute(0, 2, 3, 1) + PAD_VALUE * (1.0 - cover)[..., None]


def mosaic9_sample(images, hw, sel9, cy, cx) -> torch.Tensor:
    """Sample the virtual 3S x 3S nine-tile mosaic canvas of each image at
    integer coordinates ``cy``, ``cx`` (B, ...) (JAX ``_mosaic9_sample_fn``):
    tile t = 3 row + col, from ``images[sel9[:, t]]``, sits in cell (row,
    col) of a uniform 3 x 3 grid of S-cells with its content at the cell's
    top left. Outside the tile's content: ``PAD_VALUE``. Returns float32 (B,
    ..., 3)."""
    B, S = images.shape[0], images.shape[1]
    row = torch.div(cy, S, rounding_mode="floor").clamp(0, 2).long()
    col = torch.div(cx, S, rounding_mode="floor").clamp(0, 2).long()
    tile = row * 3 + col
    flat = tile.reshape(B, -1)
    hw9 = hw[sel9].float()                                  # (B, 9, 2)
    th = hw9[..., 0].gather(1, flat).view_as(tile)
    tw = hw9[..., 1].gather(1, flat).view_as(tile)
    sx = cx - col * S
    sy = cy - row * S
    ok = (sx >= 0) & (sx < tw) & (sy >= 0) & (sy < th)
    src = sel9.gather(1, flat).view_as(tile)
    val = images[src, sy.clamp(0, S - 1).long(), sx.clamp(0, S - 1).long()]
    return torch.where(ok[..., None], val.float(), PAD_VALUE)


def mosaic9_canvas(images, hw, sel9) -> torch.Tensor:
    """The 3S x 3S nine-tile canvases (B, 3S, 3S, 3) float32, as the JAX
    package builds them for the separable warp: the tiles of
    ``mosaic9_sample`` laid out cell by cell, ``PAD_VALUE`` around each
    tile's content. Returned as a view of channel-first memory, the layout
    ``warp_separable``'s products read."""
    B, S = images.shape[0], images.shape[1]
    hw9 = hw[sel9].float()                                  # (B, 9, 2)
    idx = torch.arange(S, dtype=torch.float32, device=images.device)
    inside = (idx[:, None] < hw9[..., 0, None, None]) \
        & (idx[None, :] < hw9[..., 1, None, None])          # (B, 9, y, x)
    # (B, 9 = row col, y, x, 3) -> (B, 3, row, y, col, x)
    tiles = images[sel9].view(B, 3, 3, S, S, 3).permute(0, 5, 1, 3, 2, 4)
    inside = inside.view(B, 3, 3, S, S).permute(0, 1, 3, 2, 4)[:, None]
    canvas = torch.where(inside, tiles, PAD_VALUE).reshape(B, 3, 3 * S, 3 * S)
    return canvas.permute(0, 2, 3, 1)


def warp(sample, M: torch.Tensor, size: int,
         perspective: bool) -> torch.Tensor:
    """Inverse-warp the canvases that ``sample(cy, cx)`` reads (a mosaic
    sampler with its images bound) through any M (B, 3, 3) with bilinear
    filtering: each output pixel maps to the canvas through M^-1 (divided by
    its third coordinate with ``perspective``), and its four taps sample the
    canvas, each out-of-content tap taking ``PAD_VALUE`` on its own."""
    B = M.shape[0]
    Minv = _inverse(M)
    idx = torch.arange(size, dtype=torch.float32, device=M.device)
    ys, xs = idx[:, None], idx[None, :]

    def row(i):
        m = Minv[:, i].view(B, 3, 1, 1)
        return m[:, 0] * xs + m[:, 1] * ys + m[:, 2]

    cx, cy = row(0), row(1)
    if perspective:
        cz = row(2)
        cx, cy = cx / cz, cy / cz
    x0, y0 = torch.floor(cx), torch.floor(cy)
    fx, fy = cx - x0, cy - y0
    acc = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            v = sample(y0 + dy, x0 + dx)
            wgt = ((fx if dx else 1 - fx) * (fy if dy else 1 - fy))[..., None]
            acc = acc + v * wgt
    return acc


def transform_labels(xyxy, valid, M, size: int, scale_s,
                     perspective: bool):
    """Warp xyxy boxes (B, N, 4) by M (B, 3, 3), clip to the output, and
    keep the box candidates: w, h > 2 px, area over the pre-warp box scaled
    by ``scale_s`` (B,) above 0.10, aspect below 20 (reference
    utils/datasets.py:1083-1111). Returns (boxes, valid & candidate)."""
    B, N = xyxy.shape[:2]
    x1, y1, x2, y2 = xyxy.unbind(-1)
    corners = torch.stack([x1, y1, x2, y2, x1, y2, x2, y1], -1)
    corners = corners.reshape(B, N * 4, 2)
    pts = torch.cat([corners, torch.ones_like(corners[..., :1])], -1) \
        @ M.transpose(-1, -2)
    if perspective:
        pts = pts[..., :2] / pts[..., 2:3]
    else:
        pts = pts[..., :2]
    pts = pts.reshape(B, N, 4, 2)
    new = torch.cat([pts.amin(2), pts.amax(2)], -1).clamp(0.0, size)
    w1 = (x2 - x1) * scale_s[:, None]
    h1 = (y2 - y1) * scale_s[:, None]
    w2 = new[..., 2] - new[..., 0]
    h2 = new[..., 3] - new[..., 1]
    eps = 1e-16
    ar = torch.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    ok = (w2 > 2) & (h2 > 2) & (w2 * h2 / (w1 * h1 + eps) > 0.10) & (ar < 20)
    return new, valid & ok


def hsv_jitter(img: torch.Tensor, gains: torch.Tensor,
               cfg: AugmentConfig) -> torch.Tensor:
    """HSV gain jitter of [0, 1] RGB images (B, H, W, 3) by ``gains`` (B, 3)
    in U(-1, 1) (reference augment_hsv, utils/datasets.py:683-694, float-exact
    in place of uint8 tables)."""
    r = torch.stack([gains[:, 0] * cfg.hsv_h, gains[:, 1] * cfg.hsv_s,
                     gains[:, 2] * cfg.hsv_v], -1) + 1.0
    r = r[:, None, None]                                     # (B, 1, 1, 3)
    maxc = img.amax(-1)
    minc = img.amin(-1)
    v = maxc
    d = maxc - minc
    s = torch.where(maxc > 0, d / torch.clamp(maxc, min=1e-12), 0.0)
    rc, gc, bc = img.unbind(-1)
    safe_d = torch.clamp(d, min=1e-12)
    h = torch.where(maxc == rc, (gc - bc) / safe_d,
                    torch.where(maxc == gc, 2.0 + (bc - rc) / safe_d,
                                4.0 + (rc - gc) / safe_d))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(d <= 0, 0.0, h)

    h = torch.remainder(h * r[..., 0], 1.0)
    s = torch.clamp(s * r[..., 1], 0.0, 1.0)
    v = torch.clamp(v * r[..., 2], 0.0, 1.0)

    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], -1)


def pack_labels(cls, xyxy, valid, size: int, max_labels: int):
    """Valid labels first (a stable sort), truncated to ``max_labels``, as
    normalized xywh; zeros in the invalid slots. cls, valid (B, N), xyxy
    (B, N, 4)."""
    order = torch.argsort((~valid).to(torch.uint8), dim=1,
                          stable=True)[:, :max_labels]
    cls = cls.gather(1, order)
    xyxy = xyxy.gather(1, order[..., None].expand(-1, -1, 4))
    valid = valid.gather(1, order)
    x1, y1, x2, y2 = xyxy.unbind(-1)
    out = torch.stack([cls, (x1 + x2) / 2 / size, (y1 + y2) / 2 / size,
                       (x2 - x1) / size, (y2 - y1) / size], -1)
    return torch.where(valid[..., None], out, 0.0), valid


def _is_separable(cfg: AugmentConfig) -> bool:
    """degrees = shear = perspective = 0 (the hyps' default) makes every
    warp a diagonal affine: two products instead of per-pixel gathers."""
    return cfg.degrees == 0.0 and cfg.shear == 0.0 and cfg.perspective == 0.0


def _mosaic_labels(tl, hw_t, mask_t, padw, padh, extent, M,
                   cfg: AugmentConfig):
    """Labels of the tiles of a mosaic (tl (B, T, M, 5), normalized to each
    tile's content of (h, w) ``hw_t`` (B, T, 2)) -> canvas xyxy by the
    tiles' offsets ``padw``, ``padh`` (broadcast to (B, T, 1)), clipped to
    [0, extent], warped by M with the box-candidate filter. Returns (cls
    (B, T M), xyxy (B, T M, 4), valid (B, T M)), the labels in tile order."""
    B = tl.shape[0]
    h, w = hw_t[..., 0:1], hw_t[..., 1:2]
    bx, by = tl[..., 1] * w, tl[..., 2] * h
    bw, bh = tl[..., 3] * w, tl[..., 4] * h
    xyxy = torch.stack([bx - bw / 2 + padw, by - bh / 2 + padh,
                        bx + bw / 2 + padw, by + bh / 2 + padh], -1)
    xyxy = xyxy.reshape(B, -1, 4).clamp(0, extent)
    scale_s = torch.sqrt(M[:, 0, 0] ** 2 + M[:, 1, 0] ** 2)
    xyxy, valid = transform_labels(xyxy, mask_t.reshape(B, -1), M,
                                   cfg.img_size, scale_s,
                                   cfg.perspective != 0.0)
    return tl[..., 0].reshape(B, -1), xyxy, valid


def mosaic4(images, hw, labels, mask, sel, center, u, cfg: AugmentConfig):
    """Mosaic-4 and the warp of each image (JAX ``_one_mosaic``): tiles
    ``sel`` (B, 4), centre (B, 2), affine draws ``u`` (B, 8). Returns (img
    (B, S, S, 3) float32 0-255, cls (B, 4M), xyxy (B, 4M, 4), valid (B,
    4M)), the labels in tile order."""
    S = cfg.img_size
    M = affine_matrix(u, S, 2 * S)
    if _is_separable(cfg):
        img = warp_separable(mosaic_canvas(images, hw, sel, center), M, S)
    else:
        img = warp(functools.partial(mosaic_sample, images, hw, sel, center),
                   M, S, cfg.perspective != 0.0)
    hw4 = hw[sel]                                            # (B, 4, 2)
    yc, xc = center[:, 0, None, None], center[:, 1, None, None]
    tile = torch.arange(4, device=images.device)[None, :, None]
    padw = torch.where(tile % 2 == 1, xc, xc - hw4[..., 1:2])
    padh = torch.where(tile // 2 == 1, yc, yc - hw4[..., 0:1])
    return (img, *_mosaic_labels(labels[sel], hw4, mask[sel], padw, padh,
                                 2 * S, M, cfg))


def mosaic9(images, hw, labels, mask, sel9, u, cfg: AugmentConfig):
    """Mosaic-9 and the warp of each image (JAX ``_one_mosaic9``): tiles
    ``sel9`` (B, 9) on the 3S canvas, affine draws ``u`` (B, 8) (the
    mosaic-4 draws; no centre). Returns (img, cls (B, 9M), xyxy (B, 9M, 4),
    valid (B, 9M)), the labels in tile order."""
    S = cfg.img_size
    M = affine_matrix(u, S, 3 * S)
    if _is_separable(cfg):
        img = warp_separable(mosaic9_canvas(images, hw, sel9), M, S)
    else:
        img = warp(functools.partial(mosaic9_sample, images, hw, sel9), M,
                   S, cfg.perspective != 0.0)
    tile = torch.arange(9, device=images.device)
    padw = (tile % 3 * S).float()[None, :, None]
    padh = (tile // 3 * S).float()[None, :, None]
    return (img, *_mosaic_labels(labels[sel9], hw[sel9], mask[sel9], padw,
                                 padh, 3 * S, M, cfg))


def _top_bit(bits: torch.Tensor) -> torch.Tensor:
    """The index of each nonnegative integer's highest set bit, -1 for 0
    (exact: an int below 2**53 converts to float64 exactly)."""
    return torch.frexp(bits.double()).exponent.long() - 1


def _last_cover(iny: torch.Tensor, inx: torch.Tensor) -> torch.Tensor:
    """(B, H, W) index of the last of K boxes covering each pixel, -1 where
    none does, for boxes given by their rows ``iny`` (B, K, H) and columns
    ``inx`` (B, K, W) (K <= 62): a bit a box, the rows' and columns' bits
    ANDed, the highest bit taken."""
    w = 2 ** torch.arange(iny.shape[1], device=iny.device)[:, None]
    rows = (iny.long() * w).sum(1)
    cols = (inx.long() * w).sum(1)
    return _top_bit(rows[:, :, None] & cols[:, None, :])


def _ioa(xyxy, boxes):
    """(B, K, N) intersection of each box (B, K, 4) with each label xyxy
    (B, N, 4) over the label's area (reference bbox_ioa,
    utils/datasets.py:1147-1153)."""
    lab, box = xyxy[:, None], boxes[:, :, None]
    ix1 = torch.maximum(lab[..., 0], box[..., 0])
    iy1 = torch.maximum(lab[..., 1], box[..., 1])
    ix2 = torch.minimum(lab[..., 2], box[..., 2])
    iy2 = torch.minimum(lab[..., 3], box[..., 3])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    area = torch.clamp((lab[..., 2] - lab[..., 0])
                       * (lab[..., 3] - lab[..., 1]), min=1e-9)
    return inter / area


def partner_boxes(labels, hw, pidx):
    """The paste partners' (``pidx`` (B,)) class (B, M) and boxes (B, M, 4)
    in their content's pixels, as JAX ``augment_batch`` builds them for
    ``paste_in``."""
    lp = labels[pidx]
    h, w = hw[pidx, 0, None], hw[pidx, 1, None]
    return lp[..., 0], torch.stack([
        (lp[..., 1] - lp[..., 3] / 2) * w, (lp[..., 2] - lp[..., 4] / 2) * h,
        (lp[..., 1] + lp[..., 3] / 2) * w, (lp[..., 2] + lp[..., 4] / 2) * h],
        -1)


def paste_in(img, cls, xyxy, valid, partner_img, p_cls, p_xyxy, p_valid,
             src, dst):
    """Copy-paste (JAX ``paste_in``; reference ``pastein``,
    utils/datasets.py:1161-1198) of every image's ``PASTE_ATTEMPTS`` regions
    at once. img (B, S, S, 3) float 0-255; cls, valid (B, N), xyxy (B, N,
    4) its labels; partner_img (B, S, S, 3) each partner's loader canvas,
    p_cls (B, M), p_xyxy (B, M, 4) its labels in pixels, p_valid (B, M)
    which it may paste; src (B, A) the label slot an attempt copies, dst (B,
    A, 2) where its box lands, as (x, y) shares of the room left. An attempt
    pastes where its box overlaps no valid label before the pastes by an
    IoA of 0.30 or more; a later attempt's pixels overwrite an earlier one's.
    Returns (img, cls, xyxy, valid) with A label slots appended, valid where
    the attempt pasted."""
    B, S = img.shape[0], img.shape[1]
    dev = img.device
    sb = p_xyxy.gather(1, src[..., None].expand(-1, -1, 4))  # (B, A, 4)
    sw = torch.clamp(sb[..., 2] - sb[..., 0], min=1.0)
    sh = torch.clamp(sb[..., 3] - sb[..., 1], min=1.0)
    dx = dst[..., 0] * (S - sw)
    dy = dst[..., 1] * (S - sh)
    dbox = torch.stack([dx, dy, dx + sw, dy + sh], -1)

    # IoA of each paste box with the labels before any paste
    ioa = torch.where(valid[:, None], _ioa(xyxy, dbox), 0.0)
    ok = p_valid.gather(1, src) & (ioa < 0.30).all(-1)       # (B, A)

    # output (y, x) reads the partner at (y - dy + sy1, x - dx + sx1), the
    # float clipped to [0, S - 1] and truncated
    idx = torch.arange(S, dtype=torch.float32, device=dev)
    py = (idx - dy[..., None] + sb[..., 1, None]).clamp(0, S - 1).long()
    px = (idx - dx[..., None] + sb[..., 0, None]).clamp(0, S - 1).long()
    iny = (idx >= dbox[..., 1, None]) & (idx < dbox[..., 3, None]) \
        & ok[..., None]                                      # (B, A, S)
    inx = (idx >= dbox[..., 0, None]) & (idx < dbox[..., 2, None])
    last = _last_cover(iny, inx)                             # (B, S, S)
    j = last.clamp(min=0)
    b = torch.arange(B, device=dev)[:, None, None]
    i = torch.arange(S, device=dev)
    shifted = partner_img[b, py[b, j, i[:, None]], px[b, j, i[None, :]]]
    img = torch.where((last >= 0)[..., None], shifted.float(), img)
    return (img, torch.cat([cls, p_cls.gather(1, src)], 1),
            torch.cat([xyxy, dbox], 1), torch.cat([valid, ok], 1))


def cutout(img, xyxy, valid, size, center, color):
    """Random erasing (JAX ``cutout``; reference utils/datasets.py:1133-1158)
    of every image's ``CUTOUT_SCALES`` boxes at once: box k of (h, w)
    ``size`` (B, K, 2) about ``center`` (B, K, 2) as (y, x), filled with
    ``color`` (B, K, 3), a later box over an earlier one; a label (xyxy (B,
    N, 4) in pixels) whose intersection over its area with any box reaches
    0.60 is dropped. Returns (img, valid)."""
    B, S = img.shape[0], img.shape[1]
    dev = img.device
    mh, mw = size.unbind(-1)
    x1 = torch.clamp(center[..., 1] - mw // 2, 0, S)
    y1 = torch.clamp(center[..., 0] - mh // 2, 0, S)
    x2 = torch.clamp(x1 + mw, 0, S)
    y2 = torch.clamp(y1 + mh, 0, S)
    idx = torch.arange(S, device=dev)
    last = _last_cover((idx >= y1[..., None]) & (idx < y2[..., None]),
                       (idx >= x1[..., None]) & (idx < x2[..., None]))
    b = torch.arange(B, device=dev)[:, None, None]
    fill = color[b, last.clamp(min=0)].to(img.dtype)        # (B, S, S, 3)
    img = torch.where((last >= 0)[..., None], fill, img)
    boxes = torch.stack([x1, y1, x2, y2], -1).to(xyxy.dtype)
    return img, valid & (_ioa(xyxy, boxes) < 0.60).all(1)


def augment_batch(images: torch.Tensor, hw: torch.Tensor,
                  labels: torch.Tensor, mask: torch.Tensor, draws: Draws,
                  cfg: AugmentConfig) -> Batch:
    """Train-time augmentation of a batch on its device, in the JAX
    package's order: mosaic-4, or mosaic-9 where ``draws.use9``, and the
    warp of each image, its labels moved with it (9M slots, tile order;
    mosaic-4 pads its 4M); paste-in from the first partner's canvas (8 more
    slots) where ``cfg.paste_in`` > 0; cutout where ``cfg.cutout`` > 0;
    mixup against the batch rolled by one, its labels appended; the labels
    packed to ``cfg.max_labels``; / 255; HSV; flips."""
    B, S = images.shape[0], cfg.img_size
    dev = images.device
    hw = hw.float()
    labels = labels.float()
    self_ = torch.arange(B, device=dev)[:, None]
    sel = torch.cat([self_, draws.partners[:, :3]], 1)       # (B, 4)
    img, cls, xyxy, valid = mosaic4(images, hw, labels, mask, sel,
                                    draws.center, draws.affine, cfg)
    pad = 5 * labels.shape[1]                                # 4M -> 9M slots
    cls = torch.cat([cls, cls.new_zeros(B, pad)], 1)
    xyxy = torch.cat([xyxy, xyxy.new_zeros(B, pad, 4)], 1)
    valid = torch.cat([valid, valid.new_zeros(B, pad)], 1)
    if cfg.mosaic9 > 0:
        # JAX picks a branch an image (lax.cond); here both run for all
        sel9 = torch.cat([self_, draws.partners], 1)         # (B, 9)
        out9 = mosaic9(images, hw, labels, mask, sel9, draws.affine, cfg)
        u9 = draws.use9
        img = torch.where(u9.view(B, 1, 1, 1), out9[0], img)
        cls, xyxy, valid = (
            torch.where(u9.view((B,) + (1,) * (a.dim() - 1)), a9, a)
            for a9, a in zip(out9[1:], (cls, xyxy, valid)))

    if cfg.paste_in > 0:
        pidx = draws.partners[:, 0]
        p_cls, p_xyxy = partner_boxes(labels, hw, pidx)
        img, cls, xyxy, valid = paste_in(
            img, cls, xyxy, valid, images[pidx], p_cls, p_xyxy,
            mask[pidx] & draws.paste_on[:, None], draws.paste_src,
            draws.paste_dst)

    if cfg.cutout > 0:
        img2, valid2 = cutout(img, xyxy, valid, draws.cut_size,
                              draws.cut_center, draws.cut_color)
        on = draws.cut_on
        img = torch.where(on.view(B, 1, 1, 1), img2, img)
        valid = torch.where(on[:, None], valid2, valid)

    # mixup (reference utils/datasets.py:548-555) with the batch rolled by one
    mix = draws.mix
    ratio = draws.ratio.view(B, 1, 1, 1)
    img = torch.where(mix.view(B, 1, 1, 1),
                      img * ratio + torch.roll(img, 1, 0) * (1 - ratio), img)
    cls = torch.cat([cls, torch.roll(cls, 1, 0)], 1)
    xyxy = torch.cat([xyxy, torch.roll(xyxy, 1, 0)], 1)
    valid = torch.cat([valid, torch.roll(valid, 1, 0) & mix[:, None]], 1)

    out_labels, out_mask = pack_labels(cls, xyxy, valid, S, cfg.max_labels)

    # times the float32 reciprocal: what XLA compiles the JAX ``/ 255.0`` to
    img = img * (1.0 / 255.0)
    img = hsv_jitter(img, draws.hsv, cfg)

    # flips (reference utils/datasets.py:608-619) of images and labels
    ud, lr = draws.flipud, draws.fliplr
    img = torch.where(ud.view(B, 1, 1, 1), img.flip(1), img)
    img = torch.where(lr.view(B, 1, 1, 1), img.flip(2), img)
    cls_, x, y, bw_, bh_ = out_labels.unbind(-1)
    x = torch.where(out_mask, torch.where(lr[:, None], 1.0 - x, x), 0.0)
    y = torch.where(out_mask, torch.where(ud[:, None], 1.0 - y, y), 0.0)
    out_labels = torch.stack([cls_, x, y, bw_, bh_], -1)
    return Batch(images=img, labels=out_labels, mask=out_mask)


def identity_batch(images: torch.Tensor, hw: torch.Tensor,
                   labels: torch.Tensor):
    """The no-augment input contract (reference train.py:351 ``imgs/255``
    with the letterboxed collate). The loader's canvases are uint8 0-255,
    (B, H, W, 3), with the aspect-kept content at the top left occupying
    (h, w) = ``hw``; labels are xywh normalized to the content. Returns
    (images float 0-1, labels normalized to the canvas)."""
    # times the float32 reciprocal: what XLA compiles the JAX package's
    # ``/ 255.0`` to (the quotient differs by an ulp in about half the pixels)
    img = images.float() * (1.0 / 255.0)
    H, W = images.shape[1], images.shape[2]
    sy = (hw[:, 0] / H)[:, None]
    sx = (hw[:, 1] / W)[:, None]
    labels = torch.stack([labels[..., 0],
                          labels[..., 1] * sx, labels[..., 2] * sy,
                          labels[..., 3] * sx, labels[..., 4] * sy], -1)
    return img, labels
