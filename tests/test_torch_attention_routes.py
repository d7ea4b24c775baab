"""Host code of K1 ``axial_project`` and K2's line kernel in its vertical
mode (a column a block), on the CPU: the tiles the wrappers pick
(``project_tile``, ``vertical_tile``) and their shared memory against the
card's limit at the flagship's six CCVA shapes at 640 px, the P3 map of
1280 px (H = W = 160), the P6 config's widths and odd maps; torch models
of the two kernels' tilings against the plain versions; and the wrappers
on CPU tensors (their plain versions, no launch).

The models follow the kernels' loops: K1 takes tiles of 32 * rp pixels
and groups of 8 * rj of the 2*c8 columns (the last group padded with zero
weights), sums the whole of C in channel order into a thread's register
tile of rp pixels x rj columns, and splits v among the groups by
contiguous channel ranges; the line kernel (``_line_model``) walks
one line a block (here a column), a query tile of tq * rq pixels, a
channel tile of 4 * tc channels, the keys in chunks of kch pixels (E = Q
K_chunk^T over c8 in order, then O += E V_chunk over the chunk's keys in
order) and a thread's register tile of rq pixels x 4 channels. Its
criss-cross passes are held in ``tests/test_torch_criss_cross_routes.py``.
Tolerance: within 1e-5 of the plain
version, relative to each element and to the tensor's largest magnitude
(the same float32 products summed in another order).
"""

import numpy as np
import pytest
import torch

from rep_yolo_tpu_torch.ops.kernels import axial_attention as KA
from rep_yolo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

SMEM_MAX = 232448           # bytes of shared memory a block may use

# (C, H, W) of the six CCVA blocks at 640 px (layers 21, 27, 37, 43, 53, 59)
CCVA_640 = [(64, 80, 80), (32, 80, 80), (128, 40, 40), (64, 40, 40),
            (256, 20, 20), (128, 20, 20)]
# the P3 map of cfg/rep_yolo_p6_aux.yaml at 1280 px, the widths of its P6
# blocks, and odd maps (C = 8: the tiny config's)
OTHER = [(64, 160, 160), (8, 160, 160), (384, 20, 20), (192, 40, 40),
         (768, 10, 10), (8, 13, 21), (32, 13, 21), (16, 7, 5), (4, 3, 2)]


def _inputs(C, H, W, batch, seed):
    rng = np.random.default_rng(seed)
    c8 = max(C // 8, 1)
    f = lambda *a: torch.from_numpy(np.asarray(a[0], np.float32))  # noqa
    x = f(rng.normal(size=(batch, H, W, C)))
    wqk = f(0.3 * rng.normal(size=(2 * c8, C)))
    pq = f(np.stack([0.1 * rng.normal(size=2 * c8),
                     rng.uniform(0.5, 1.5, 2 * c8),
                     0.1 * rng.normal(size=2 * c8)]))
    pv = f(np.stack([rng.normal(size=C), 0.1 * rng.normal(size=C),
                     rng.uniform(0.5, 1.5, C), 0.1 * rng.normal(size=C)]))
    gamma = torch.tensor([0.7])
    return x, wqk, pq, pv, gamma


def _close(got, ref):
    scale = float(ref.abs().max())
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("batch", [1, 4, 128])
@pytest.mark.parametrize("C,H,W", CCVA_640 + OTHER)
def test_tiles_fit_shared_memory(C, H, W, batch):
    c8 = max(C // 8, 1)
    t = KA.project_tile(C, c8, batch * H * W)
    assert t["smem"] <= SMEM_MAX
    assert t["ng"] * t["ngroups"] >= 2 * c8 > t["ng"] * (t["ngroups"] - 1)
    assert t["tp"] == 32 * t["rp"] and t["ng"] == 8 * t["rj"]
    assert t["rp"] in (1, 2) and t["rj"] in (1, 2)
    # the formula of axial_project_smem (csrc/axial_attention.cu)
    assert t["smem"] == 4 * ((t["tp"] + t["ng"]) * (C + 4) + 4 * C)
    t = KA.vertical_tile(H, C, c8)
    assert t["smem"] <= SMEM_MAX
    assert t["tq"] * t["tc"] == KA.THREADS
    assert 1 <= t["rq"] <= KA.V_MAX_RQ and t["qt"] == t["tq"] * t["rq"]
    assert t["qt"] * t["qtiles"] >= H > t["qt"] * (t["qtiles"] - 1)
    assert t["ct"] * t["ctiles"] == C and t["kch"] % 4 == 0
    # the formula of axial_line_smem (csrc/axial_attention.cu)
    kp = KA.key_pitch(c8)
    assert kp % 4 == 0 and (kp // 4) % 2 == 1 and kp >= c8
    ns = t["stages"]
    assert 1 <= ns <= min(KA.V_MAX_STAGES, -(-H // t["kch"]))
    floats = ((t["qt"] + ns * t["kch"]) * kp + ns * t["kch"] * t["ct"]
              + t["kch"] * t["tq"] * -(-t["rq"] // 4) * 4)
    assert t["smem"] == 4 * floats


def test_flagship_tiles():
    """At 640 px and the served batch of 4 every column tile stays in the
    two-blocks-an-SM budget and stages its whole column at once; of K1's
    tiles only C = 256 opts in beyond 48 KB; K1 takes 64-pixel tiles where
    C <= 128 and that grid still has a block for every SM (the 80-px maps
    and C = 128 at 40 px), else 32; the P6 width C = 384 opts in for
    K1."""
    for C, H, W in CCVA_640:
        assert KA.vertical_tile(H, C, C // 8)["smem"] <= KA.V_SMEM_BUDGET
        t = KA.project_tile(C, C // 8, 4 * H * W)
        assert (t["smem"] > 48 * 1024) == (C == 256)
        assert t["rp"] == (2 if H == 80 or (C, H) == (128, 40) else 1)
        assert t["ngroups"] == max(C // 64, 1)
        assert KA.vertical_tile(H, C, C // 8)["stages"] == -(-H // (
            32 if C <= 128 else 16))               # the whole column
    assert KA.vertical_tile(20, 384, 48)["smem"] <= 48 * 1024
    assert KA.project_tile(384, 48, 1600)["smem"] > 48 * 1024


@pytest.mark.parametrize("C,c8", [(6, 1), (10, 1), (0, 1), (4096, 512),
                                  (4, 0)])
def test_tiles_refuse_what_does_not_fit(C, c8):
    with pytest.raises(ValueError):
        KA.project_tile(C, c8, 64)
    if C % 4 or C == 0 or c8 == 0:
        with pytest.raises(ValueError):
            KA.vertical_tile(8, C, c8)


def _project_model(x, wqk, pq, pv):
    """K1 as the kernel tiles it."""
    B, H, W, C = x.shape
    c8 = wqk.shape[0] // 2
    nq = 2 * c8
    npix = B * H * W
    t = KA.project_tile(C, c8, npix)
    tp, rp, rj, ng, ngroups = (t[n] for n in ("tp", "rp", "rj", "ng",
                                              "ngroups"))
    ntiles = -(-npix // tp)
    xf = torch.zeros(ntiles * tp, C)
    xf[:npix] = x.reshape(npix, C)
    # pixel p = pt + 32 i of a tile, a register tile of rp pixels
    tpt = KA.THREADS // KA.P_TJ
    xr = xf.reshape(ntiles, rp, tpt, C).permute(0, 2, 1, 3)  # (n, pt, i, C)
    wp = torch.zeros(ngroups * ng, C)
    wp[:nq] = wqk                                   # zero weights in the pad
    qk = torch.zeros(ntiles * tp, ngroups * ng)
    C4 = C // 4
    v_cover = torch.zeros(C4, dtype=torch.int64)
    for grp in range(ngroups):
        # column j0 + jt + 8 r of group grp, a register tile of rj columns
        wg = wp[grp * ng:(grp + 1) * ng].reshape(rj, KA.P_TJ, C)
        wr = wg.permute(1, 0, 2)                    # (jt, r, C)
        acc = torch.zeros(ntiles, tpt, KA.P_TJ, rp, rj)
        for c in range(C):                          # the whole C, in order
            acc += xr[:, :, None, :, None, c] * wr[None, None, :, None, :, c]
        qk[:, grp * ng:(grp + 1) * ng] = acc.permute(0, 3, 1, 4, 2).reshape(
            ntiles * tp, ng)
        f0, f1 = grp * C4 // ngroups, (grp + 1) * C4 // ngroups
        v_cover[f0:f1] += 1                         # the group's v share
    assert torch.equal(v_cover, torch.ones(C4, dtype=torch.int64))
    y = torch.clamp(torch.nn.functional.silu(qk[:npix, :nq] + pq[0]) * pq[1]
                    + pq[2], 0.0, 6.0)
    v = torch.clamp(torch.nn.functional.silu(x * pv[0] + pv[1]) * pv[2]
                    + pv[3], 0.0, 6.0)
    y = y.reshape(B, H, W, nq)
    return y[..., :c8], y[..., c8:], v


def _line_model(ql, kl, vl, t, softmax):
    """K2's line kernel as it tiles the work, on line-major inputs (B, N,
    L, .): every line (b, n) at once, then query tiles, channel tiles, key
    chunks and register tiles. ``softmax`` (criss-cross's passes): each
    query's running max m and sum s over the chunks so far; a chunk's
    energies become exp(e - m) and what the earlier chunks summed is
    rescaled by exp(m_before - m). Returns O (B, N, L, C) and, with the
    softmax, m and s (B, N, L); the kernel writes the statistics from its
    first channel tile."""
    B, N, L, c8 = ql.shape
    C = vl.shape[-1]
    tq, tc, rq, qt, ct, kch = (t[n] for n in ("tq", "tc", "rq", "qt", "ct",
                                              "kch"))
    out = torch.full((B, N, L, C), float("nan"))
    m_out = torch.full((B, N, L), float("nan"))
    s_out = torch.full((B, N, L), float("nan"))
    for qi in range(t["qtiles"]):
        q0 = qi * qt
        qs = torch.zeros(B, N, qt, c8)
        rows = min(qt, L - q0)
        qs[:, :, :rows] = ql[:, :, q0:q0 + rows]
        for ci in range(t["ctiles"]):
            c0 = ci * ct
            # register tiles: thread (tq_, tc_) holds query pixels tq_ + tq r
            # and channels c0 + 4 tc_ .. + 3; the statistics by (r, tq_)
            o = torch.zeros(B, N, rq, tq, tc, 4)
            m = torch.full((B, N, rq, tq), float("-inf"))
            s = torch.zeros(B, N, rq, tq)
            for g0 in range(0, L, kch):
                kn = min(kch, L - g0)
                kb = kl[:, :, g0:g0 + kn]             # (B, N, kn, c8)
                vb = vl[:, :, g0:g0 + kn, c0:c0 + ct]  # (B, N, kn, ct)
                e = torch.zeros(B, N, kn, qt)
                for d in range(c8):                 # E over c8 in order
                    e += kb[..., d, None] * qs[:, :, None, :, d]
                er = e.reshape(B, N, kn, rq, tq)
                if softmax:
                    mc = torch.maximum(m, er.amax(2))
                    er = torch.exp(er - mc[:, :, None])
                    a = torch.exp(m - mc)           # 0 at the first chunk
                    s = s * a + er.sum(2)
                    m = mc
                    o = o * a[..., None, None]
                vr = vb.reshape(B, N, kn, tc, 4)
                for g in range(kn):                 # O over the chunk's keys
                    o += er[:, :, g, :, :, None, None] * vr[:, :, g, None,
                                                            None]
            out[:, :, q0:q0 + rows, c0:c0 + ct] = \
                o.reshape(B, N, qt, ct)[:, :, :rows]
            if ci == 0:
                m_out[:, :, q0:q0 + rows] = m.reshape(B, N, qt)[:, :, :rows]
                s_out[:, :, q0:q0 + rows] = s.reshape(B, N, qt)[:, :, :rows]
    return (out, m_out, s_out) if softmax else out


def _vertical_model(q, k, v, x, gamma):
    """K2 vertical: the line model over the columns, raw energies."""
    B, H, W, C = x.shape
    t = KA.vertical_tile(H, C, q.shape[-1])
    o = _line_model(*(a.transpose(1, 2) for a in (q, k, v)), t, False)
    return gamma * o.transpose(1, 2) + x


def _criss_cross_model(q, k, v, x, gamma):
    """K2 criss-cross: the row pass (the line model over the rows, partials
    O_w, m_w, s_w), then the column pass over the columns and its merge
    under the joint softmax, as the kernel's epilogue computes it."""
    B, H, W, C = x.shape
    t = KA.criss_cross_tile(H, W, C, q.shape[-1])
    o_w, m_w, s_w = _line_model(q, k, v, t["row"], True)
    o_h, m_h, s_h = (a.transpose(1, 2) for a in _line_model(
        *(a.transpose(1, 2) for a in (q, k, v)), t["col"], True))
    mx = torch.maximum(m_w, m_h)
    a_w, a_h = torch.exp(m_w - mx), torch.exp(m_h - mx)
    den = s_w * a_w + s_h * a_h
    return gamma * ((o_w * a_w[..., None] + o_h * a_h[..., None])
                    / den[..., None]) + x


ROUTE_SHAPES = [(c, h, w, 1) for c, h, w in CCVA_640] + [
    (8, 13, 21, 2), (32, 13, 21, 2), (16, 7, 5, 3), (384, 9, 3, 1),
    (64, 70, 2, 1), (8, 300, 1, 1), (32, 80, 80, 3)]


@pytest.mark.parametrize("C,H,W,batch", ROUTE_SHAPES)
def test_project_model_equals_plain(C, H, W, batch):
    x, wqk, pq, pv, _ = _inputs(C, H, W, batch, C + H)
    for got, ref in zip(_project_model(x, wqk, pq, pv),
                        KA.project_plain(x, wqk, pq, pv)):
        _close(got, ref)


@pytest.mark.parametrize("C,H,W,batch", ROUTE_SHAPES)
def test_vertical_model_equals_plain(C, H, W, batch):
    x, wqk, pq, pv, gamma = _inputs(C, H, W, batch, C * H)
    q, k, v = (a.contiguous() for a in KA.project_plain(x, wqk, pq, pv))
    got = _vertical_model(q, k, v, x, gamma)
    assert not torch.isnan(got).any()                # every output written
    _close(got, KA.attend_plain(q, k, v, x, gamma, False))


@pytest.mark.parametrize("C,H,W", CCVA_640 + OTHER)
def test_energy_rows_of_a_thread_are_adjacent(C, H, W):
    """The column kernel keeps query row i of its tile at (i % tq) * rqp +
    i // tq of an energy row (rqp = rq rounded up to 4): one position per
    row, and thread tq's rows tq + tq * r at tq * rqp + r, read as
    float4s."""
    t = KA.vertical_tile(H, C, max(C // 8, 1))
    tq, rq, qt = t["tq"], t["rq"], t["qt"]
    rqp = -(-rq // 4) * 4
    pos = [(i % tq) * rqp + i // tq for i in range(qt)]
    assert len(set(pos)) == qt and max(pos) < tq * rqp
    for th in range(tq):
        assert [pos[th + tq * r] for r in range(rq)] == \
            list(range(th * rqp, th * rqp + rq))
    assert KA.THREADS // qt >= 1                 # threads of the energy step


def test_tall_maps_take_several_query_tiles():
    """H beyond one tile: query tiles (the keys streamed again for each)."""
    t = KA.vertical_tile(300, 8, 1)
    assert t["qtiles"] == 2 and t["qt"] == 256
    t = KA.vertical_tile(160, 256, 32)
    assert t["qtiles"] == 5 and t["qt"] == 32 and t["kch"] == 16
    assert t["stages"] == 4 and t["smem"] > 48 * 1024
    t = KA.vertical_tile(70, 64, 8)
    assert t["qtiles"] == 1 and t["qt"] == 80


@pytest.mark.parametrize("criss_cross", [True, False])
def test_wrappers_take_plain_on_cpu_and_count_nothing(criss_cross):
    x, wqk, pq, pv, gamma = _inputs(32, 13, 21, 2, 3)
    reset_launch_counts()
    q, k, v = KA.project(x, wqk, pq, pv)
    for a, b in zip((q, k, v), KA.project_plain(x, wqk, pq, pv)):
        assert torch.equal(a, b)
    y = KA.attend(q, k, v, x, gamma, criss_cross)
    assert torch.equal(y, KA.attend_plain(q, k, v, x, gamma, criss_cross))
    assert torch.equal(KA.axial_attention(x, wqk, pq, pv, gamma, criss_cross),
                       KA.axial_attention_plain(x, wqk, pq, pv, gamma,
                                                criss_cross))
    assert not any(launch_counts().values())
