"""K3 ``nms_keep``'s tiled design (``csrc/nms.cu``), modelled on the CPU.

A numpy model of the two kernels in their word layout: the mask kernel's
words on or right of each 64-row tile's diagonal, packed tile after tile
(``ops/kernels/nms.tile_offset``), then the rows' valid bits, with its exact
early exit for a zero intersection; and the scan, which resolves a tile as
the fixed point of kept = alive & ~OR(diagonal words of the kept rows) (held
against the serial greedy order at every tile), then ORs the kept rows'
words into the removed set.
The model's keep sets are held against the port's greedy oracle
(``ops/nms._greedy_keep``), its plain fixed point (``nms_keep_plain``), and
the JAX package's ``nms_keep_matrix_xla`` and ``nms_keep_pallas`` in
interpret mode (K <= 2048, its limit). Inputs come from numpy seeds; every
comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rep_yolo_tpu.ops.pallas.nms_kernel import (MAX_PALLAS_K,
                                                nms_keep_matrix_xla,
                                                nms_keep_pallas)
from rep_yolo_tpu_torch.ops import nms as TN
from rep_yolo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from rep_yolo_tpu_torch.ops.kernels import nms as KN

BITS = KN.BITS
F32 = np.float32
SMEM_MAX = 232448           # bytes of shared memory a block may use


def _suppresses(inter, uni, thr):
    """The mask kernel's decision !(inter / uni <= thr), with the division
    taken only where inter != 0 (float32, elementwise)."""
    thr = F32(thr)
    with np.errstate(invalid="ignore", divide="ignore"):
        zero = ~((uni != 0) & (uni == uni) & (F32(0) <= thr))
        full = ~(np.where(inter == 0, F32(1), inter)
                 / np.where(inter == 0, F32(1), uni) <= thr)
    return np.where(inter == 0, zero, full)


def _pair_terms(bi, bj):
    """(inter, union) of rows bi (..., 4) against columns bj (..., 4) in
    float32, rounded op by op as the kernel rounds them."""
    bi, bj = bi.astype(F32), bj.astype(F32)
    with np.errstate(over="ignore", invalid="ignore"):
        ai = (bi[..., 2] - bi[..., 0]) * (bi[..., 3] - bi[..., 1])
        aj = (bj[..., 2] - bj[..., 0]) * (bj[..., 3] - bj[..., 1])
        iw = np.maximum(np.minimum(bi[..., :, None, 2], bj[..., None, :, 2])
                        - np.maximum(bi[..., :, None, 0],
                                     bj[..., None, :, 0]), F32(0))
        ih = np.maximum(np.minimum(bi[..., :, None, 3], bj[..., None, :, 3])
                        - np.maximum(bi[..., :, None, 1],
                                     bj[..., None, :, 1]), F32(0))
        inter = iw * ih
        return inter, (ai[..., :, None] + aj[..., None, :]) - inter


def mask_model(boxes, valid, thr):
    """The mask kernel: (B, mask_words(K)) uint64, row tile t's words
    t..W-1 of its 64 rows at ``tile_offset(t, W)``, row-major; bit j of
    row i's word w set iff column 64 w + j > i and it suppresses; rows past
    K zero; then a word a tile of the rows' valid bits."""
    B, K, _ = boxes.shape
    W = KN.words(K)
    inter, uni = _pair_terms(boxes, boxes)
    supp = _suppresses(inter, uni, thr) & np.triu(np.ones((K, K), bool), 1)
    full = np.zeros((B, W * BITS, W * BITS), bool)
    full[:, :K, :K] = supp
    weights = np.left_shift(np.uint64(1), np.arange(BITS, dtype=np.uint64))
    words = (full.reshape(B, W * BITS, W, BITS).astype(np.uint64)
             * weights).sum(-1, dtype=np.uint64)          # (B, 64 W, W)
    packed = np.zeros((B, KN.mask_words(K)), np.uint64)
    for t in range(W):
        o = KN.tile_offset(t, W)
        packed[:, o:o + BITS * (W - t)] = words[
            :, t * BITS:(t + 1) * BITS, t:].reshape(B, -1)
    vb = np.zeros((B, W * BITS), bool)
    vb[:, :K] = valid
    o = KN.tile_offset(W, W)
    packed[:, o:o + W] = (vb.reshape(B, W, BITS).astype(np.uint64)
                          * weights).sum(-1, dtype=np.uint64)
    return packed


def resolve_model(alive, diag):
    """The warp's resolution of a tile: the fixed point of kept = alive &
    ~OR(diagonal words of the kept rows), iterated from alive (at most 65
    rounds); returns (kept, rounds)."""
    kept = alive
    for rounds in range(1, BITS + 2):
        sup = 0
        for r in range(BITS):
            if kept >> r & 1:
                sup |= int(diag[r])
        nxt = alive & ~sup
        if nxt == kept:
            return kept, rounds
        kept = nxt
    raise AssertionError("no fixed point in 65 rounds")


def serial_model(alive, diag):
    """The greedy order itself: a row alive when reached is kept and clears
    the later rows its diagonal word suppresses."""
    for r in range(BITS):
        if alive >> r & 1:
            alive &= ~int(diag[r])
    return alive


def scan_model(packed, K):
    """The scan: per image, per row tile, the alive rows (valid bits from
    the mask's tail, less the removed set) resolved from the tile's
    diagonal words, then the kept rows' words right of the diagonal ORed
    into the removed set."""
    B = packed.shape[0]
    W = KN.words(K)
    keep = np.zeros((B, W * BITS), bool)
    for b in range(B):
        removed = [0] * W
        for t in range(W):
            o = KN.tile_offset(t, W)
            tile = packed[b, o:o + BITS * (W - t)].reshape(BITS, W - t)
            alive = int(packed[b, KN.tile_offset(W, W) + t]) & ~removed[t]
            kept, _ = resolve_model(alive, tile[:, 0])
            assert kept == serial_model(alive, tile[:, 0])
            for r in range(BITS):
                if kept >> r & 1:
                    keep[b, t * BITS + r] = True
                    for w in range(t + 1, W):
                        removed[w] |= int(tile[r, w - t])
    return keep[:, :K]


def _case(name, k, b=2, seed=0):
    rng = np.random.default_rng(seed + k)
    c = rng.uniform(0, 400, (b, 12, 2))
    xy = np.take_along_axis(c, rng.integers(0, 12, (b, k))[..., None], 1) \
        + rng.normal(0, 6, (b, k, 2))
    wh = rng.uniform(10, 60, (b, k, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1)
    valid = rng.uniform(size=(b, k)) < 0.9
    thr = 0.45
    if name == "identical":
        boxes = np.tile([10.0, 20.0, 50.0, 70.0], (b, k, 1))
        valid = np.ones((b, k), bool)
    elif name == "disjoint":
        g = np.arange(k, dtype=np.float64)[:, None] * 64.0
        boxes = np.tile(np.concatenate([g, g * 0, g + 32, g * 0 + 32], -1),
                        (b, 1, 1))
        valid = np.ones((b, k), bool)
    elif name == "no_valid":
        valid = np.zeros((b, k), bool)
    elif name == "zero_area_dups":             # NaN IoU suppresses
        boxes[:, ::3, 2:] = boxes[:, ::3, :2]
        boxes[:, 1::3] = boxes[:, ::3][:, : boxes[:, 1::3].shape[1]]
    elif name == "iou_at_threshold":           # inter 128 / union 256
        xy = rng.integers(0, 50, (b, (k + 1) // 2, 2)) * 8.0
        boxes = np.empty((b, k, 4))
        for j, wd in ((0, 32.0), (1, 16.0)):
            boxes[:, j::2] = np.concatenate([xy, xy + [wd, 8.0]], -1)[
                :, : boxes[:, j::2].shape[1]]
        thr = 0.5
    return boxes.astype(F32), valid, thr


CASES = ["clustered", "identical", "disjoint", "no_valid", "zero_area_dups",
         "iou_at_threshold"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", [1, 63, 64, 65, 1000, 1024, 4097])
def test_tiled_model_matches_references(k, case):
    boxes, valid, thr = _case(case, k)
    got = scan_model(mask_model(boxes, valid, thr), k)
    bt, vt = torch.from_numpy(boxes), torch.from_numpy(valid)
    np.testing.assert_array_equal(got, KN.nms_keep_plain(bt, vt, thr).numpy())
    np.testing.assert_array_equal(got, np.asarray(nms_keep_matrix_xla(
        jnp.asarray(boxes), jnp.asarray(valid), thr)))
    if k <= 1024:
        np.testing.assert_array_equal(
            got, TN._greedy_keep(bt, vt, thr).numpy())
    if k <= MAX_PALLAS_K and case in ("clustered", "zero_area_dups",
                                      "iou_at_threshold"):
        np.testing.assert_array_equal(got, np.asarray(nms_keep_pallas(
            jnp.asarray(boxes), jnp.asarray(valid), thr, interpret=True)))
    if case == "identical":
        assert got.sum(1).tolist() == [1, 1]
    if case in ("disjoint",):
        assert got.all()


# rows (x1, y1, x2, y2) against columns: touching edges (inter 0, union >
# 0), zero-width and zero-height boxes (union 0 between two of them: NaN),
# inverted boxes (negative widths and areas; a union of 0 or below),
# overlapping pairs, exact duplicates, areas of +-inf in float32 (a union
# of inf - inf: NaN)
EDGE_BOXES = np.array([
    [0, 0, 10, 10], [10, 0, 20, 10], [0, 10, 10, 20], [10, 10, 20, 20],
    [5, 5, 5, 15], [5, 5, 15, 5], [5, 5, 5, 5], [3, 3, 3, 3],
    [10, 10, 0, 0], [20, 0, 10, 10], [0, 20, 10, 10], [-5, -5, 5, 5],
    [0, 0, 10, 10], [2, 2, 12, 12], [0, 0, 5, 10], [7.5, 0, 10, 10],
    [1e-30, 0, 2e-30, 1], [0, 0, 1e30, 1e30], [0, 0, -1e30, 1e30]], F32)


@pytest.mark.parametrize("thr", [0.45, 0.5, 0.0, -0.25, 1.0])
def test_early_exit_decides_as_box_iou(thr):
    """The mask's decision without the division where inter is 0 equals
    !(box_iou <= thr) at every pair of EDGE_BOXES."""
    inter, uni = _pair_terms(EDGE_BOXES, EDGE_BOXES)
    assert (inter == 0).any() and ((inter == 0) & (uni == 0)).any()
    assert ((inter == 0) & (uni < 0)).any() and (inter > 0).any()
    assert ((inter == 0) & np.isnan(uni)).any()
    t = torch.from_numpy(EDGE_BOXES)
    ref = ~(KN.box_iou(t, t) <= thr)
    np.testing.assert_array_equal(_suppresses(inter, uni, thr), ref.numpy())


@pytest.mark.parametrize("thr", [0.0, 0.45, 1.0, 2.0])
def test_zero_intersection_of_positive_areas_never_suppresses(thr):
    """The mask's first pass computes the intersection alone where thr >= 0
    and both areas are > 0: a zero intersection then leaves a union > 0
    (inf included) and never suppresses."""
    rng = np.random.default_rng(int(thr * 10))
    xy = rng.choice([0.0, 1e-30, 8.0, 1e30], (400, 2)) \
        + rng.integers(0, 4, (400, 2)) * 16.0
    wh = rng.choice([1e-30, 8.0, 16.0, 3e38], (400, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(F32)
    with np.errstate(over="ignore", invalid="ignore"):
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    inter, uni = _pair_terms(boxes, boxes)
    pos = (area[:, None] > 0) & (area[None, :] > 0)
    zero = (inter == 0) & pos
    assert zero.sum() > 1000 and np.isinf(uni[zero]).any()
    assert not _suppresses(inter, uni, thr)[zero].any()


def test_early_exit_through_the_model():
    """EDGE_BOXES as one image through the mask and scan models, every
    threshold: equal to the plain fixed point and the greedy oracle."""
    boxes = np.tile(EDGE_BOXES, (1, 4, 1))
    valid = np.ones(boxes.shape[:2], bool)
    bt, vt = torch.from_numpy(boxes), torch.from_numpy(valid)
    for thr in (0.45, 0.0, -0.25, 1.0):
        got = scan_model(mask_model(boxes, valid, thr), boxes.shape[1])
        np.testing.assert_array_equal(
            got, KN.nms_keep_plain(bt, vt, thr).numpy())
        np.testing.assert_array_equal(
            got, TN._greedy_keep(bt, vt, thr).numpy())


@pytest.mark.parametrize("seed", range(6))
def test_resolution_fixed_point_is_the_greedy_order(seed):
    """Random diagonal words (strictly upper triangular), the longest chain
    of suppressions (row r suppresses r + 1 alone) and none: the warp's
    fixed point equals the serial greedy order, within 65 rounds."""
    rng = np.random.default_rng(seed)
    for density in (0.0, 0.02, 0.1, 0.5, 1.0):
        bits = np.triu(rng.uniform(size=(BITS, BITS)) < density, 1)
        diag = [sum(1 << j for j in range(BITS) if bits[r, j])
                for r in range(BITS)]
        alive = int(rng.integers(0, 2 ** 63)) | 1
        kept, rounds = resolve_model(alive, diag)
        assert kept == serial_model(alive, diag) and rounds <= BITS + 1
    chain = [1 << (r + 1) if r + 1 < BITS else 0 for r in range(BITS)]
    kept, rounds = resolve_model(2 ** 64 - 1, chain)
    assert kept == int("01" * 32, 2) and rounds == BITS
    assert resolve_model(2 ** 64 - 1, [0] * BITS) == (2 ** 64 - 1, 1)


@pytest.mark.parametrize("k", [1, 63, 64, 65, 1000, 1024, 4097, 8192])
def test_layout_and_shared_memory(k):
    """The packed mask holds the upper triangle's tiles and no more; the
    scan's ring of three stages of the widest tile fits a block's shared
    memory."""
    W = KN.words(k)
    assert W == -(-k // 64)
    assert KN.valid_words(W) in (W, W + 1) and KN.valid_words(W) % 2 == 0
    assert KN.mask_words(k) == sum(BITS * (W - t) for t in range(W)) \
        + KN.valid_words(W)
    assert [KN.tile_offset(t, W) for t in range(W)] == list(np.cumsum(
        [0] + [BITS * (W - t) for t in range(W - 1)]))
    assert KN.scan_smem(k) == 8 * (KN.STAGES * BITS * W + KN.valid_words(W)
                                   + W + KN.STAGES)
    assert KN.scan_smem(k) <= SMEM_MAX
    # half the full K x K/64 mask; every bulk copy (a tile, the valid bits)
    # whole 16-byte units at 16-byte aligned offsets, image after image
    assert KN.mask_words(k) <= BITS * W * (W + 1) // 2 + W + 1
    assert KN.mask_words(k) % 2 == 0
    assert all(KN.tile_offset(t, W) % 2 == 0 and BITS * (W - t) % 2 == 0
               for t in range(W + 1))


def test_wrapper_takes_plain_on_cpu_and_counts_nothing():
    boxes, valid, thr = _case("clustered", 100)
    bt, vt = torch.from_numpy(boxes), torch.from_numpy(valid)
    reset_launch_counts()
    assert torch.equal(KN.nms_keep(bt, vt, thr),
                       KN.nms_keep_plain(bt, vt, thr))
    assert sum(launch_counts().values()) == 0
