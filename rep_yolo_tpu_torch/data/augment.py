"""Train-time augmentation on the device (port of
``rep_yolo_tpu/data/augment.py``): mosaic-4 with the random affine or
perspective warp and its label transform, mixup, HSV and flips, batched over
the images in float32 with no host synchronisation; and the no-augment input
contract, ``identity_batch``.

Randomness is kept apart from arithmetic. ``draw_batch`` draws from a
``torch.Generator`` every value that ``augment_batch`` uses: the values the
JAX ops draw, in their shapes and ranges. Every other function is
deterministic in those draws, so each can be held against its JAX
counterpart on draws taken from a JAX key.

Inputs are the loader's: images (B, S, S, 3) uint8 or float 0-255 with the
content at the top left and 114 around it; hw (B, 2) the content's (h, w);
labels (B, M, 5) [cls, xc, yc, w, h] normalized to the content; mask (B, M)
bool. Mosaic partners come from within the batch.

Not ported yet, and refused: mosaic-9, paste-in and cutout (``ROADMAP.md``
A2b). ``cfg.mosaic`` is not read: every image is a mosaic, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
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
    mosaic9: float = 0.2     # P(9-mosaic | mosaic): not ported yet
    mixup: float = 0.15
    paste_in: float = 0.15   # copy-paste probability: not ported yet
    cutout: float = 0.0      # not ported yet
    max_labels: int = 120


class Batch(NamedTuple):
    images: torch.Tensor   # (B, S, S, 3) float32 in [0, 1]
    labels: torch.Tensor   # (B, max_labels, 5) [cls, xc, yc, w, h] normalized
    mask: torch.Tensor     # (B, max_labels) bool


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


def refuse_unported(cfg: AugmentConfig) -> None:
    """Raise where ``cfg`` asks for a mixing augmentation not ported yet,
    rather than run mosaic-4 in its place."""
    on = [k for k in ("mosaic9", "paste_in", "cutout")
          if getattr(cfg, k) > 0]
    if on:
        raise NotImplementedError(
            f"{', '.join(on)} > 0: mosaic-9, paste-in and cutout "
            f"(ROADMAP.md A2b) are not ported to rep_yolo_tpu_torch yet; "
            f"set them to 0 in the hyp, or train with --no-augment")


def _uniform(gen: torch.Generator, shape, lo: float, hi: float):
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u * (hi - lo) + lo


def draw_batch(gen: torch.Generator, batch: int,
               cfg: AugmentConfig) -> Draws:
    """The draws of one ``augment_batch`` call, on ``gen``'s device. Beta(8,
    8) is X / (X + Y) of two Gamma(8, 1), each a sum of eight -log U."""
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
    return Draws(partners, center, affine, mix, ratio, hsv,
                 flips[0] < cfg.flipud, flips[1] < cfg.fliplr)


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


def warp(images, hw, sel, center, M: torch.Tensor, size: int,
         perspective: bool) -> torch.Tensor:
    """Inverse-warp the mosaics through any M (B, 3, 3) with bilinear
    filtering: each output pixel maps to the canvas through M^-1 (divided by
    its third coordinate with ``perspective``), and its four taps sample the
    mosaic, each out-of-content tap taking ``PAD_VALUE`` on its own."""
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
            v = mosaic_sample(images, hw, sel, center, y0 + dy, x0 + dx)
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


def augment_batch(images: torch.Tensor, hw: torch.Tensor,
                  labels: torch.Tensor, mask: torch.Tensor, draws: Draws,
                  cfg: AugmentConfig) -> Batch:
    """Train-time augmentation of a batch on its device, in the JAX
    package's order: mosaic-4 and the warp of each image, its labels moved
    with it (4M slots padded to 9M); mixup against the batch rolled by one,
    its labels appended; the labels packed to ``cfg.max_labels``; / 255;
    HSV; flips."""
    refuse_unported(cfg)
    B, S = images.shape[0], cfg.img_size
    dev = images.device
    hw = hw.float()
    labels = labels.float()
    sel = torch.cat([torch.arange(B, device=dev)[:, None],
                     draws.partners[:, :3]], 1)              # (B, 4)
    center = draws.center
    M = affine_matrix(draws.affine, S, 2 * S)
    persp = cfg.perspective != 0.0
    if _is_separable(cfg):
        img = warp_separable(mosaic_canvas(images, hw, sel, center), M, S)
    else:
        img = warp(images, hw, sel, center, M, S, persp)

    # labels: xywh normalized to the content -> canvas xyxy, tile offsets
    hw4 = hw[sel]                                            # (B, 4, 2)
    h, w = hw4[..., 0:1], hw4[..., 1:2]
    yc, xc = center[:, 0, None, None], center[:, 1, None, None]
    tile = torch.arange(4, device=dev)[None, :, None]
    padw = torch.where(tile % 2 == 1, xc, xc - w)
    padh = torch.where(tile // 2 == 1, yc, yc - h)
    l4 = labels[sel]                                         # (B, 4, M, 5)
    bx, by = l4[..., 1] * w, l4[..., 2] * h
    bw, bh = l4[..., 3] * w, l4[..., 4] * h
    xyxy = torch.stack([bx - bw / 2 + padw, by - bh / 2 + padh,
                        bx + bw / 2 + padw, by + bh / 2 + padh], -1)
    xyxy = xyxy.reshape(B, -1, 4).clamp(0, 2 * S)            # (B, 4M, 4)
    scale_s = torch.sqrt(M[:, 0, 0] ** 2 + M[:, 1, 0] ** 2)
    xyxy, valid = transform_labels(xyxy, mask[sel].reshape(B, -1), M, S,
                                   scale_s, persp)
    cls = l4[..., 0].reshape(B, -1)
    pad = 5 * labels.shape[1]                                # 4M -> 9M slots
    cls = torch.cat([cls, cls.new_zeros(B, pad)], 1)
    xyxy = torch.cat([xyxy, xyxy.new_zeros(B, pad, 4)], 1)
    valid = torch.cat([valid, valid.new_zeros(B, pad)], 1)

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
