"""Port parity: the NMS of rep_yolo_tpu_torch against the JAX package.

- The plain keep mask (the CPU side of the CUDA kernel) against
  ``nms_keep_pallas(interpret=True)``, ``nms_keep_matrix_xla`` and the JAX
  greedy oracle: identical keep sets, zero-area duplicates and boxes at
  IoU exactly the threshold included.
- ``non_max_suppression`` against the JAX version for presorted,
  single-label, multi-label, agnostic and merge inputs: same counts, and
  the valid rows agree (f32, atol 1e-4 px / 1e-5 score, rtol 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rep_yolo_tpu.ops import nms as JN
from rep_yolo_tpu.ops.pallas.nms_kernel import (nms_keep_matrix_xla,
                                                nms_keep_pallas)
from rep_yolo_tpu_torch.ops import nms as TN
from rep_yolo_tpu_torch.ops.kernels import nms as KN


def _clustered(rng, b, k, n_centers=6):
    c = rng.uniform(0, 200, (b, n_centers, 2))
    pick = rng.integers(0, n_centers, (b, k))
    xy = np.take_along_axis(c, pick[..., None], 1) + rng.normal(0, 5, (b, k, 2))
    wh = rng.uniform(10, 40, (b, k, 2))
    return np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)


def _cases():
    rng = np.random.default_rng(0)
    out = []
    boxes = _clustered(rng, 2, 256)
    valid = rng.uniform(size=(2, 256)) < 0.85
    out.append(("clustered", boxes, valid, 0.45))
    dup = boxes.copy()
    dup[:, ::4, 2:] = dup[:, ::4, :2]                    # zero area
    dup[:, 1::4] = dup[:, ::4]                           # and duplicated
    out.append(("zero_area_duplicates", dup, valid, 0.45))
    # pairs at IoU exactly 0.5 = thr (kept): inter 128, union 256
    xy = rng.integers(0, 25, (2, 128, 2)).astype(np.float32) * 8
    edge = np.empty((2, 256, 4), np.float32)
    edge[:, 0::2] = np.concatenate([xy, xy + [32, 8]], -1)
    edge[:, 1::2] = np.concatenate([xy, xy + [16, 8]], -1)
    out.append(("iou_at_threshold", edge, np.ones((2, 256), bool), 0.5))
    return out


def _greedy_mask(boxes, valid, thr):
    """JAX greedy oracle as a keep mask."""
    keeps = []
    for b in range(boxes.shape[0]):
        scores = jnp.where(jnp.asarray(valid[b]), 1.0, -jnp.inf)
        sel, keep = JN._greedy_nms(jnp.asarray(boxes[b]), scores, thr,
                                   boxes.shape[1])
        m = np.zeros(boxes.shape[1], bool)
        m[np.asarray(sel)[np.asarray(keep)]] = True
        keeps.append(m)
    return np.stack(keeps)


@pytest.mark.parametrize("case", range(3), ids=[c[0] for c in _cases()])
def test_keep_mask_matches_jax(case):
    _, boxes, valid, thr = _cases()[case]
    got = KN.nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid),
                      thr).numpy()
    pallas = np.asarray(nms_keep_pallas(jnp.asarray(boxes),
                                        jnp.asarray(valid), thr,
                                        interpret=True))
    matrix = np.asarray(nms_keep_matrix_xla(jnp.asarray(boxes),
                                            jnp.asarray(valid), thr))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, matrix)
    np.testing.assert_array_equal(got, _greedy_mask(boxes, valid, thr))


def test_port_greedy_matches_plain():
    for _, boxes, valid, thr in _cases():
        b, v = torch.from_numpy(boxes), torch.from_numpy(valid)
        assert torch.equal(TN._greedy_keep(b, v, thr),
                           KN.nms_keep_plain(b, v, thr))


def _pred(rng, b, n, nc):
    xy = rng.uniform(0, 200, (b, n, 2))
    wh = rng.uniform(8, 50, (b, n, 2))
    obj = rng.uniform(0, 1, (b, n, 1))
    cls = rng.uniform(0, 1, (b, n, nc)) if nc > 1 else np.ones((b, n, 1))
    return np.concatenate([xy, wh, obj, cls], -1).astype(np.float32)


def _compare(det_t, det_j):
    dj = JN.detections_to_numpy(det_j)
    dt = TN.detections_to_numpy(det_t)
    np.testing.assert_array_equal(np.asarray(det_j.count),
                                  det_t.count.numpy())
    for a, b in zip(dt, dj):
        # same rows; order only differs among equal scores
        ka = np.lexsort(a.T[::-1])
        kb = np.lexsort(b.T[::-1])
        np.testing.assert_allclose(a[ka], b[kb], atol=1e-4, rtol=1e-5)


_NMS_CASES = {
    "single_label": dict(nc=1, kw={}),
    "multi_label": dict(nc=3, kw=dict(multi_label=True)),
    "best_class": dict(nc=3, kw={}),
    "agnostic": dict(nc=3, kw=dict(agnostic=True)),
    "merge": dict(nc=2, kw=dict(merge=True)),
}


@pytest.mark.parametrize("name", list(_NMS_CASES))
def test_non_max_suppression_matches_jax(name):
    case = _NMS_CASES[name]
    pred = _pred(np.random.default_rng(1), 2, 300, case["nc"])
    kw = dict(max_det=100, max_nms=512, **case["kw"])
    det_j = JN.non_max_suppression(jnp.asarray(pred), 0.3, 0.45,
                                   method="matrix", **kw)
    det_t = TN.non_max_suppression(torch.from_numpy(pred), 0.3, 0.45, **kw)
    _compare(det_t, det_j)


def test_presorted_matches_jax():
    """The serving path: score-descending rows, gate applied upstream."""
    pred = _pred(np.random.default_rng(2), 2, 256, 1)
    order = np.argsort(-pred[..., 4], axis=1, kind="stable")
    pred = np.take_along_axis(pred, order[..., None], 1)
    det_j = JN.non_max_suppression(jnp.asarray(pred), 0.2, 0.45,
                                   presorted=True, method="matrix")
    for method in ("kernel", "matrix", "greedy"):
        det_t = TN.non_max_suppression(torch.from_numpy(pred), 0.2, 0.45,
                                       presorted=True, method=method)
        _compare(det_t, det_j)


def test_zero_area_duplicates_through_nms():
    pred = _pred(np.random.default_rng(3), 1, 64, 1)
    pred[0, 1::2, :4] = pred[0, 0::2, :4]
    pred[0, :, 2:4] = 0.0                      # zero-area, NaN IoU
    det_j = JN.non_max_suppression(jnp.asarray(pred), 0.1, 0.45,
                                   method="matrix")
    det_t = TN.non_max_suppression(torch.from_numpy(pred), 0.1, 0.45)
    _compare(det_t, det_j)
