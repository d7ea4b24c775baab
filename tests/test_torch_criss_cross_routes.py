"""Host code of K2 criss-cross, on the CPU: the row pass and the merging
column pass of the line kernel (``csrc/axial_attention.cu``, modes
LINE_ROW and LINE_MERGE).

- The tiles ``criss_cross_tile`` picks (a row tile and a column tile, both
  with the softmax statistics) fit the card's shared memory at the
  flagship's six CCVA shapes at 640 px and the other maps of
  ``test_torch_attention_routes`` at batch 1, 4 and 128, and match the
  formula of ``axial_line_smem``; a shape no tile fits is refused. Shared
  memory depends on the tile and the chunk, not on H * W: a 4 x 1600 map,
  which the first criss-cross kernel refused (8 (W + H) energies a block
  past 48 KB), takes a tile.
- A torch model of the two passes as the kernel runs them
  (``_criss_cross_model``: chunk order, the running max and sum with the
  rescale of what earlier chunks summed, the partials O_w, m_w, s_w, the
  merge) equals ``attend_plain`` within rtol 1e-5 (and 1e-5 of the
  output's largest magnitude: the same float32 terms summed in another
  order, exp taken against another max) at every ``ROUTE_SHAPES`` case of
  the vertical tests, at lines that are not a multiple of the chunk and at
  the 4 x 1600 map; and the JAX ``criss_cross_fused`` (the row-3 route,
  Pallas in interpret mode) within the same tolerance at an H != W map.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rep_yolo_tpu.ops.pallas import axial_attention as JA
from rep_yolo_tpu_torch.ops.kernels import axial_attention as KA
from test_torch_attention_routes import (CCVA_640, OTHER, ROUTE_SHAPES,
                                         SMEM_MAX, _close,
                                         _criss_cross_model, _inputs)

# lines that are not a multiple of the chunk (32 keys; 16 at 256 channels a
# tile), several query tiles on one row, and the map the first kernel refused
CC_SHAPES = ROUTE_SHAPES + [(16, 45, 100, 1), (256, 37, 9, 1),
                            (8, 4, 1600, 1)]


@pytest.mark.parametrize("batch", [1, 4, 128])
@pytest.mark.parametrize("C,H,W", CCVA_640 + OTHER + [(8, 4, 1600)])
def test_criss_cross_tiles_fit_shared_memory(C, H, W, batch):
    c8 = max(C // 8, 1)
    tiles = KA.criss_cross_tile(H, W, C, c8)
    kp = KA.key_pitch(c8)
    for L, t in ((W, tiles["row"]), (H, tiles["col"])):
        assert t["smem"] <= SMEM_MAX
        assert t["tq"] * t["tc"] == KA.THREADS
        assert 1 <= t["rq"] <= KA.V_MAX_RQ and t["qt"] == t["tq"] * t["rq"]
        assert t["qt"] * t["qtiles"] >= L > t["qt"] * (t["qtiles"] - 1)
        assert t["ct"] * t["ctiles"] == C and t["kch"] % 4 == 0
        ns = t["stages"]
        assert 1 <= ns <= min(KA.V_MAX_STAGES, -(-L // t["kch"]))
        # the formula of axial_line_smem (csrc/axial_attention.cu): the
        # vertical mode's, and Al, Ms, Ss of one energy row's positions
        qtp = t["tq"] * -(-t["rq"] // 4) * 4
        floats = ((t["qt"] + ns * t["kch"]) * kp + ns * t["kch"] * t["ct"]
                  + (t["kch"] + 3) * qtp)
        assert t["smem"] == 4 * floats
        # the same tiling as the vertical mode, 3 * qtp floats more
        raw = KA.line_tile(L, C, c8)
        assert {k: v for k, v in t.items() if k not in ("smem", "stages")} \
            == {k: v for k, v in raw.items() if k not in ("smem", "stages")}


def test_flagship_criss_cross_tiles():
    """At 640 px both passes stage their whole line at once and stay in the
    two-blocks-an-SM budget; the 4 x 1600 map takes several query tiles a
    row and one chunk a column."""
    for C, H, W in CCVA_640:
        for t in KA.criss_cross_tile(H, W, C, C // 8).values():
            assert t["smem"] <= KA.V_SMEM_BUDGET
            assert t["stages"] == -(-H // t["kch"]) and t["qtiles"] == 1
    t = KA.criss_cross_tile(4, 1600, 8, 1)
    assert t["row"]["qtiles"] == 7 and t["row"]["stages"] == 4
    assert t["col"]["qtiles"] == 1 and t["col"]["stages"] == 1


@pytest.mark.parametrize("C,c8", [(6, 1), (10, 1), (0, 1), (4, 0),
                                  (32768, 4096)])
def test_criss_cross_tiles_refuse_what_does_not_fit(C, c8):
    with pytest.raises(ValueError):
        KA.criss_cross_tile(8, 8, C, c8)


@pytest.mark.parametrize("C,H,W,batch", CC_SHAPES)
def test_criss_cross_model_equals_plain(C, H, W, batch):
    x, wqk, pq, pv, gamma = _inputs(C, H, W, batch, C * H + W)
    q, k, v = (a.contiguous() for a in KA.project_plain(x, wqk, pq, pv))
    got = _criss_cross_model(q, k, v, x, gamma)
    assert not torch.isnan(got).any()                # every output written
    _close(got, KA.attend_plain(q, k, v, x, gamma, True))


def test_criss_cross_model_equals_jax_row3():
    """The model against the JAX row-3 route's ``criss_cross_fused`` (its
    two ``_axis_attention`` branches and their merge, Pallas in interpret
    mode) at an H != W map."""
    rng = np.random.default_rng(7)
    h, w, c = 12, 37, 16
    q, k = (rng.uniform(0, 2, (2, h, w, c // 8)).astype(np.float32)
            for _ in range(2))
    v = rng.uniform(0, 3, (2, h, w, c)).astype(np.float32)
    x = rng.normal(0, 1, (2, h, w, c)).astype(np.float32)
    gamma = np.asarray([0.7], np.float32)
    ref = torch.from_numpy(np.array(JA.criss_cross_fused(
        *(jnp.asarray(a) for a in (q, k, v, x, gamma)))))
    got = _criss_cross_model(*(torch.from_numpy(a)
                               for a in (q, k, v, x, gamma)))
    _close(got, ref)
