"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips without a CUDA device. This file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed (``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances: attention f32 atol = rtol = 1e-4 (summation order differs);
NMS keep sets identical.
"""

import numpy as np
import pytest
import torch

from rep_yolo_tpu_torch.nn.blocks import AxialAttention
from rep_yolo_tpu_torch.nn.fuse import fuse_state_dict
from rep_yolo_tpu_torch.ops import nms as TN
from rep_yolo_tpu_torch.ops.kernels import axial_attention as KA
from rep_yolo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from rep_yolo_tpu_torch.ops.kernels import nms as KN

pytestmark = pytest.mark.cuda
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _attention_inputs(c, h, w, seed, device):
    g = torch.Generator().manual_seed(seed)
    state = {}
    for name, t in AxialAttention(c, True).state_dict().items():
        if name.endswith("running_var") or (name.endswith("weight")
                                            and t.ndim == 1):
            state[name] = 0.5 + torch.rand(t.shape, generator=g)
        elif name.endswith("gamma"):
            state[name] = torch.full(t.shape, 0.7)
        else:
            state[name] = 0.3 * torch.randn(t.shape, generator=g)
    packed = fuse_state_dict(state)
    x = torch.randn((2, h, w, c), generator=g)
    consts = [packed[k] for k in ("wqk", "pq", "pv", "gamma")]
    return [t.to(device) for t in (x, *consts)]


@pytest.mark.parametrize("criss_cross", [True, False])
@pytest.mark.parametrize("shape", [(64, 40, 40), (32, 13, 21), (256, 20, 20)])
def test_attention_kernels_match_plain(cuda, criss_cross, shape):
    x, wqk, pq, pv, gamma = _attention_inputs(*shape, seed=shape[1], device=cuda)
    with torch.no_grad():
        q, k, v = KA.project(x, wqk, pq, pv)
        for a, b in zip((q, k, v), KA.project_plain(x, wqk, pq, pv)):
            torch.testing.assert_close(a, b, **TOL)
        got = KA.attend(q, k, v, x, gamma, criss_cross)
        torch.testing.assert_close(
            got, KA.attend_plain(q, k, v, x, gamma, criss_cross), **TOL)


def test_wrappers_count_launches_and_refuse_bad_input(cuda):
    x, wqk, pq, pv, gamma = _attention_inputs(16, 8, 8, 0, cuda)
    reset_launch_counts()
    with torch.no_grad():
        KA.axial_attention(x, wqk, pq, pv, gamma, True)
    counts = launch_counts()
    assert counts["axial_project"] == 1
    assert counts["axial_attend_criss_cross"] == 1
    with pytest.raises(ValueError):
        KA.project(x.double(), wqk, pq, pv)
    with pytest.raises(ValueError):
        KN.nms_keep(torch.zeros((1, KN.MAX_K + 1, 4), device=cuda),
                    torch.ones((1, KN.MAX_K + 1), dtype=torch.bool,
                               device=cuda), 0.5)


@pytest.mark.parametrize("k", [64, 1000, 4096])
def test_nms_keep_matches_plain_and_greedy(cuda, k):
    rng = np.random.default_rng(k)
    c = rng.uniform(0, 300, (2, 8, 2))
    xy = np.take_along_axis(c, rng.integers(0, 8, (2, k))[..., None], 1) \
        + rng.normal(0, 6, (2, k, 2))
    wh = rng.uniform(10, 50, (2, k, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1)
    boxes[:, 1::7] = boxes[:, 0::7][:, : boxes[:, 1::7].shape[1]]
    boxes[:, 0::7, 2:] = boxes[:, 0::7, :2]              # zero-area dups
    b = torch.as_tensor(boxes, dtype=torch.float32, device=cuda)
    v = torch.as_tensor(rng.uniform(size=(2, k)) < 0.9, device=cuda)
    keep = KN.nms_keep(b, v, 0.45)
    assert torch.equal(keep, KN.nms_keep_plain(b, v, 0.45))
    if k <= 1000:
        assert torch.equal(keep.cpu(), TN._greedy_keep(b.cpu(), v.cpu(), 0.45))
