"""Host code of the int8 pool kernels, on the CPU: numpy models of K6
``max_pool2_q8`` (``csrc/pool_flat.cu``) and K8 ``spp_pools_q8``
(``csrc/neck_flat.cu``) in the kernels' own tiling, the tiles the kernels
pick (their ``pool_dims`` and ``spp_dims``, modelled here as ``k6_tile``
and ``k8_tile``; ``tests/test_torch_kernels_cuda.py`` holds the kernels'
own launches to the served calls' tiles on the card), and the wrappers on
CPU tensors (their plain versions, no launch).

- K6: block (column tile, band of ``rb`` output rows, image), thread (tx
  across a pixel's channel vectors, ty across output columns), every
  address from the kernel's products (no division), each output vector
  written once, against ``max_pool2_q8_plain``.
- K8: block (channel words, band of ``th`` rows, image x column tile), on
  16-bit pairs: the column pass over the tile and its 6-pixel halo, -128
  outside the map (no max moves), with the nested vertical windows (v5,
  then v9 = v5 and rows +-3..4, then v13), the row pass's horizontal windows
  over strips of output columns, the four sections, against
  ``spp_pools_q8_plain`` and JAX ``spp_pools_flat`` (interpret mode). Other
  band heights and channel words than the kernel's are the tiles its A/B
  builds (``pool_ab.py``: ``-DSPP_TH``, ``-DSPP_LGW``).

Every comparison is exact: a max is.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rep_yolo_tpu.ops.pallas import neck_flat as jnf
from rep_yolo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from rep_yolo_tpu_torch.ops.kernels import neck_flat as KNF
from rep_yolo_tpu_torch.ops.kernels import pool_flat as KP

# K6's three calls in a served int8 forward at 640 px, batch 4 (l6's MP,
# layers 30 and 46), and ragged maps
K6_SHAPES = [(4, 80, 80, 256), (4, 80, 80, 128), (4, 40, 40, 256),
             (3, 10, 14, 4), (2, 6, 8, 8)]
SMS = 132                       # the H100's SMs
K6_THREADS, K6_RB = 256, 2      # pool_flat.cu: THREADS, RB
# neck_flat.cu: SPP_R, SPP_QS, SPP_TH, 2^SPP_LGW, SPP_THREADS, SPP_SMEM
R, SPP_QS, SPP_TH, SPP_WORDS, SPP_THREADS = 6, 5, 4, 8, 256
SPP_SMEM = 232448 // 2


def k6_tile(B: int, H: int, W: int, C: int, vec: int = 16) -> dict:
    """pool_dims: tx = min(cv, 32) lanes by ty output columns, ty the power
    of two up to K6_THREADS / tx that wastes the fewest of the W/2 columns
    (the widest of those); grid (column tiles, row bands, B)."""
    cv = C // vec
    tx, W2 = min(cv, 32), W // 2
    best, ty, t = None, 1, 1
    while tx * t <= K6_THREADS:
        waste = -(-W2 // t) * t - W2
        if best is None or waste <= best:
            best, ty = waste, t
        t *= 2
    grid = (-(-W2 // ty), -(-(H // 2) // K6_RB), B)
    return {"tx": tx, "ty": ty, "rb": K6_RB, "grid": grid,
            "blocks": grid[0] * grid[1] * grid[2]}


def spp_bytes(th: int, tw: int, cw: int) -> int:
    """A K8 block's shared memory: v5, v9, v13 of th rows over the tile's
    columns rounded up to SPP_QS and its 12 halo columns (rounded up to
    odd), cw words a pixel, each widened to two."""
    nu = -(-tw // SPP_QS) * SPP_QS + 2 * R
    return 3 * th * (nu | 1) * cw * 8


def k8_tile(B: int, H: int, W: int, C: int, th: int = SPP_TH,
            cw: int = SPP_WORDS) -> dict:
    """spp_dims: th rows by tw columns by cw words (4 where the map has
    fewer than cw), tw = W halved until the block's shared memory is at most
    SPP_SMEM; grid (word chunks, row bands, B x column tiles)."""
    words = C // 4
    cw = cw if words >= cw else 4
    tw = W
    while tw > 1 and spp_bytes(th, tw, cw) > SPP_SMEM:
        tw = -(-tw // 2)
    col_tiles = -(-W // tw)
    grid = (-(-words // cw), -(-H // th), B * col_tiles)
    return {"th": th, "tw": tw, "cw": cw, "col_tiles": col_tiles,
            "grid": grid, "blocks": grid[0] * grid[1] * grid[2],
            "smem": spp_bytes(th, tw, cw)}


def _int8(shape, seed):
    return np.random.default_rng(seed).integers(-128, 128, shape).astype(
        np.int8)


def k6_model(x: np.ndarray, vec: int, tile: dict) -> np.ndarray:
    """K6 as the kernel runs it: x (B, H, W, C) int8 as (vectors, vec)
    bytes; every block and thread of ``tile``'s grid, addresses from the
    kernel's products, each output vector written once (checked)."""
    B, H, W, C = x.shape
    H2, W2, cv = H // 2, W // 2, C // vec
    tx, ty, rb = tile["tx"], tile["ty"], tile["rb"]
    assert tx == min(cv, 32) and tx * ty <= K6_THREADS
    xs = x.reshape(-1, vec)
    ys = np.zeros((B * H2 * W2 * cv, vec), np.int8)
    written = np.zeros(len(ys), np.int64)
    row, orow = W * cv, W2 * cv
    gx, gy, gz = tile["grid"]
    for b in range(gz):
        for band in range(gy):
            qy = band * rb
            nr = min(rb, H2 - qy)
            for ct in range(gx):
                qx = ct * ty + np.arange(ty)[:, None]        # (ty, 1)
                p = np.arange(tx)[None, :]                   # (1, tx)
                live = np.broadcast_to(qx < W2, (ty, tx))
                src = (b * H + 2 * qy) * row + 2 * qx * cv
                dst = (b * H2 + qy) * orow + qx * cv
                for p0 in range(0, cv, tx):                  # the p loop
                    pp = p + p0
                    ok = live & (pp < cv)
                    for k in range(nr):
                        r = (src + 2 * k * row + pp)[ok]
                        win = [xs[r], xs[r + cv], xs[r + row],
                               xs[r + row + cv]]
                        d = (dst + k * orow + pp)[ok]
                        ys[d] = np.maximum(np.maximum(win[0], win[1]),
                                           np.maximum(win[2], win[3]))
                        np.add.at(written, d, 1)
    assert (written == 1).all()
    return ys.reshape(B, H2, W2, C)


def _widen(w: np.ndarray) -> np.ndarray:
    """int8 words (..., 4 bytes) as the kernel's sign-extended 16-bit pairs
    (channels 0, 2, then 1, 3): the exact values, in int16."""
    return w[..., [0, 2, 1, 3]].astype(np.int16)


def _narrow(v: np.ndarray) -> np.ndarray:
    return v[..., [0, 2, 1, 3]].astype(np.int8)


def k8_model(x: np.ndarray, tile: dict) -> np.ndarray:
    """K8 as the kernel runs it, block by block of ``tile``'s grid, on
    16-bit pairs: the column pass reads its band's rows with a 6-row and
    6-column halo straight from the map, -128 outside it, and takes the
    nested vertical windows (v5, then v9 = v5 and rows +-3..4, then v13) of
    every column of the tile and halo; the row pass takes the horizontal
    windows of v5, v9, v13 over strips of SPP_QS output columns and writes
    mp5, mp9, mp13; the column pass writes x. Each output byte is written
    once (checked)."""
    B, H, W, C = x.shape
    th, tw, cw = tile["th"], tile["tw"], tile["cw"]
    words, col_tiles, qs = C // 4, tile["col_tiles"], SPP_QS
    xw = x.reshape(B, H, W, words, 4)
    y = np.zeros((B, H, W, 4, words, 4), np.int8)
    written = np.zeros(y.shape[:5], np.int64)
    gx, gy, gz = tile["grid"]
    assert (gx, gy, gz) == (-(-words // cw), -(-H // th), B * col_tiles)
    strips = -(-tw // qs)
    nu = strips * qs + 2 * R
    for z in range(gz):
        b, ct = divmod(z, col_tiles)
        for band in range(gy):
            r0, q0 = band * th, ct * tw
            n, m = min(th, H - r0), min(tw, W - q0)
            for chunk in range(gx):
                c0 = chunk * cw
                ws = slice(c0, min(c0 + cw, words))
                # the column pass: th + 12 rows of nu columns, -128 outside
                raw = np.full((th + 2 * R, nu, ws.stop - c0, 4), -128, np.int8)
                rr = np.arange(r0 - R, r0 + th + R)
                qq = np.arange(q0 - R, q0 - R + nu)
                ri, qi = (rr >= 0) & (rr < H), (qq >= 0) & (qq < W)
                raw[np.ix_(ri, qi)] = xw[b][np.ix_(rr[ri], qq[qi])][:, :, ws]
                v = _widen(raw)
                win = lambda a, d0, d1: np.maximum.reduce(  # noqa: E731
                    [a[R + d: R + d + th] for d in range(d0, d1 + 1)])
                v5 = win(v, -2, 2)
                v9 = np.maximum(v5, np.maximum(win(v, -4, -3), win(v, 3, 4)))
                v13 = np.maximum(v9, np.maximum(win(v, -6, -5), win(v, 5, 6)))
                y[b, r0:r0 + n, q0:q0 + m, 0, ws] = raw[R:R + n, R:R + m]
                written[b, r0:r0 + n, q0:q0 + m, 0, ws] += 1
                # the row pass: strips of qs output columns
                for st in range(strips):
                    p0 = st * qs
                    for j in range(qs):
                        if p0 + j >= m:
                            break
                        u = R + p0 + j
                        for sec, (vk, reach) in enumerate(
                                ((v5, 2), (v9, 4), (v13, 6)), 1):
                            o = vk[:n, u - reach:u + reach + 1].max(1)
                            y[b, r0:r0 + n, q0 + p0 + j, sec, ws] = \
                                _narrow(o)
                            written[b, r0:r0 + n, q0 + p0 + j, sec, ws] += 1
    assert (written == 1).all()
    return y.reshape(B, H, W, 4 * C)


def _spp_jax(x: np.ndarray) -> np.ndarray:
    B, H, W, C = x.shape
    flat = jnp.asarray(np.ascontiguousarray(x.transpose(0, 3, 1, 2)).reshape(
        B, C, H * W))
    ref = np.asarray(jnf.spp_pools_flat(flat, H, W))
    return ref.reshape(B, 4 * C, H, W).transpose(0, 2, 3, 1)


def _routes(shapes):
    """(shape, vec): the 16-byte route where C % 16 == 0, the word route
    always (a map off 16 bytes takes it too)."""
    return [(s, v) for s in shapes for v in (16, 4) if s[-1] % v == 0]


@pytest.mark.parametrize("shape,vec", _routes(K6_SHAPES))
def test_k6_model_matches_plain(shape, vec):
    x = _int8(shape, sum(shape) + vec)
    tile = k6_tile(*shape, vec)
    want = KP.max_pool2_q8_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(k6_model(x, vec, tile), want)


@pytest.mark.parametrize("ty", [1, 2, 8, 16])
def test_k6_model_other_tiles(ty):
    """Column widths the kernel does not pick for the shape: column tiles
    past the map's last column (the kernel's qx >= W/2 exit), a band of rows
    past its last row, a pixel of more vectors than lanes (C = 1024 in
    words)."""
    for shape, vec in (((2, 10, 14, 64), 16), ((1, 6, 4, 1024), 4)):
        x = _int8(shape, ty)
        tile = k6_tile(*shape, vec)
        t = min(ty, K6_THREADS // tile["tx"])
        tile.update(ty=t, grid=(-(-(shape[2] // 2) // t), tile["grid"][1],
                                shape[0]))
        want = KP.max_pool2_q8_plain(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(k6_model(x, vec, tile), want)


def test_k6_tiles_of_the_served_calls():
    """Each served call is one wave of at least one block an SM, two or
    more output vectors a thread, whole warps."""
    for shape in K6_SHAPES[:3]:
        t = k6_tile(*shape)
        assert t["rb"] >= 2 and t["blocks"] >= SMS
        assert (t["tx"] * t["ty"]) % 32 == 0
        assert t["blocks"] * t["tx"] * t["ty"] <= SMS * 2048


SPP_SHAPES = [(4, 20, 20, 512),           # the flagship's call at 640 px
              (2, 2, 2, 32),              # the tiny config's at 64 px
              (1, 1, 5, 16), (2, 2, 13, 8), (1, 5, 1, 32), (1, 12, 14, 16),
              (2, 13, 12, 12), (1, 14, 2, 64)]


@pytest.mark.parametrize("shape", SPP_SHAPES)
def test_k8_model_matches_plain_and_jax(shape):
    x = _int8(shape, sum(shape))
    got = k8_model(x, k8_tile(*shape))
    want = KNF.spp_pools_q8_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _spp_jax(x))


@pytest.mark.parametrize("th,cw", [(2, 4), (4, 8), (5, 4), (8, 16), (2, 16),
                                   (5, 8)])
def test_k8_model_band_heights(th, cw):
    """The A/B's tiles: band heights that do not divide H, a band taller
    than the map, chunks of more words than the map has (C = 24: 6
    words)."""
    for shape in ((2, 20, 20, 64), (1, 13, 9, 24), (1, 3, 11, 16)):
        x = _int8(shape, th * 31 + cw)
        tile = k8_tile(*shape, th=th, cw=cw)
        want = KNF.spp_pools_q8_plain(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(k8_model(x, tile), want)


def test_k8_model_column_tiles():
    """A map too wide for one tile's shared memory: column tiles with
    their own halo."""
    shape = (1, 3, 300, 256)
    tile = k8_tile(*shape)
    assert tile["col_tiles"] > 1 and tile["smem"] <= SPP_SMEM
    x = _int8(shape, 5)
    want = KNF.spp_pools_q8_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(k8_model(x, tile), want)


@pytest.mark.parametrize("fill", [-128, 127])
def test_k8_model_constant_maps(fill):
    """All -128: the -128 that stands for the -inf pad must not leak as a
    larger value; all 127."""
    shape = (2, 13, 14, 16)
    x = np.full(shape, fill, np.int8)
    for th in (2, SPP_TH, 5, 8):
        got = k8_model(x, k8_tile(*shape, th=th))
        assert (got == fill).all()
        np.testing.assert_array_equal(got, _spp_jax(x))


@pytest.mark.parametrize("where", [(0, 0), (0, 13), (12, 0), (12, 13),
                                   (6, 0), (0, 7), (12, 7), (6, 13)])
def test_k8_model_single_maximum_at_the_border(where):
    shape = (1, 13, 14, 16)
    x = np.full(shape, -128, np.int8)
    x[0, where[0], where[1], 5] = 127
    want = KNF.spp_pools_q8_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(want, _spp_jax(x))
    for th in (2, SPP_TH, 5, 8):
        np.testing.assert_array_equal(k8_model(x, k8_tile(*shape, th=th)),
                                      want)


def test_k8_tiles():
    """The served call's grid gives two blocks an SM within the shared
    memory it aims at; every shape gets a tile that fits a block, however
    large the map; the 16-bit pairs narrow back to the bytes."""
    t = k8_tile(4, 20, 20, 512)
    assert t["blocks"] >= 2 * SMS
    assert t["smem"] <= SPP_SMEM and t["tw"] == 20
    for shape in [(1, 1, 1, 4), (1, 400, 400, 2048), (8, 2000, 3, 4),
                  (1, 3, 5000, 16), (2, 40, 40, 512), (2, 2, 2, 32)]:
        t = k8_tile(*shape)
        assert t["smem"] <= SPP_SMEM
        assert t["cw"] in (4, SPP_WORDS)
        assert t["grid"][1] <= 65535 and t["grid"][2] <= 65535
    w = _int8((64, 4), 3)
    np.testing.assert_array_equal(_narrow(_widen(w)), w)


def test_pool_wrappers_take_plain_on_cpu():
    x = torch.from_numpy(_int8((2, 6, 8, 16), 0))
    reset_launch_counts()
    assert torch.equal(KP.max_pool2_q8(x), KP.max_pool2_q8_plain(x))
    assert torch.equal(KNF.spp_pools_q8(x), KNF.spp_pools_q8_plain(x))
    assert launch_counts()["max_pool2_q8"] == 0
    assert launch_counts()["spp_pools_q8"] == 0
