"""``rep_yolo_tpu_torch.cli.export`` against ``rep_yolo_tpu.cli.export``
on cfg/rep_yolo_tiny_test.yaml at 64 px, batch 2, on the CPU, both CLIs
reading one JAX ``TrainState`` ``.npz`` (``test_torch_detect``'s weights),
in float32 and ``--bf16``, each with and without ``--include-nms``:

- the ``.json`` equal to the JAX export's;
- the loaded ``.pt2`` program's output equal to the live model's
  (``predict``, then NMS with ``--include-nms``) on the same input, and
  near the JAX ``.stablehlo`` deserialized and called on it: float32
  within 1e-4 of the largest |value| (boxes and scores apart), the same
  valid count with NMS; bfloat16 within 2e-2 of it with a correlation above
  0.999 (``der_fast``'s bound; the port keeps its attention islands in
  float32), its detections checked against the live model only;
- the graph holds ``rep_yolo_torch::axial_project`` / ``axial_attend``
  (K1, K2) and, with ``--include-nms``, ``nms_keep`` (K3), so a trace on
  the card cannot take another path;
- the ``.params.npz`` holds the JAX export's flat keys and values for
  every fused leaf but the attention blocks' packed constants.

The JAX export with ``--include-nms`` cannot serialize its ``Detections``
NamedTuple output as the JAX package ships (``jax.export`` refuses the
unregistered type): this file registers it with
``jax.export.register_namedtuple_serialization`` so that the reference
runs; the JAX package is unchanged.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rep_yolo_tpu.cli import export as jax_export
from rep_yolo_tpu.models.model import RepYOLO as JaxRepYOLO
from rep_yolo_tpu.ops.nms import Detections as JaxDetections
from rep_yolo_tpu_torch.cli import export
from rep_yolo_tpu_torch.cli.detect import load_model_and_vars
from rep_yolo_tpu_torch.ops.nms import non_max_suppression
from test_torch_detect import SIZE, TINY, save_jax_train_state, \
    tiny_variables

BATCH = 2
OPS = {"rep_yolo_torch.axial_project.default",
       "rep_yolo_torch.axial_attend.default"}


@pytest.fixture(scope="module")
def variables():
    return tiny_variables()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, variables):
    try:
        jax.export.register_namedtuple_serialization(
            JaxDetections, serialized_name="rep_yolo_tpu.ops.nms.Detections")
    except ValueError:                  # registered by an earlier module
        pass
    return save_jax_train_state(tmp_path_factory.mktemp("ck") / "best",
                                variables)


def _float(a):
    """An ``.npz`` leaf as float32 (bfloat16 is stored as 2-byte void)."""
    if a.dtype.itemsize != 2:
        return a
    return (np.frombuffer(a.tobytes(), np.uint16).astype(np.uint32)
            << 16).view(np.float32).reshape(a.shape)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("nms", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_export_matches_jax(variables, ckpt, tmp_path, bf16, nms):
    flags = ["--weights", ckpt, "--cfg", TINY, "--img-size", str(SIZE),
             "--batch-size", str(BATCH), "--conf-thres", "0.1"]
    flags += (["--bf16"] if bf16 else []) + (["--include-nms"] if nms else [])
    jm, jv = JaxRepYOLO.from_config(TINY).fuse(variables)
    jax_export.export_model(jm, jv, SIZE, BATCH, nms, 0.1, 0.45, bf16,
                            tmp_path / "jax" / "model")
    out = export.main([*flags, "--device", "cpu", "--out",
                       str(tmp_path / "port" / "model")])
    jdir = tmp_path / "jax"
    assert json.loads(out.with_suffix(".json").read_text()) == \
        json.loads((jdir / "model.json").read_text())

    program = torch.export.load(str(out.with_suffix(".pt2")))
    ops = {str(n.target) for n in program.graph.nodes
           if str(n.target).startswith("rep_yolo_torch.")}
    assert ops == OPS | ({"rep_yolo_torch.nms_keep.default"} if nms
                         else set())

    dtype = torch.bfloat16 if bf16 else torch.float32
    xn = np.random.default_rng(0).uniform(0, 1, (BATCH, SIZE, SIZE, 3))
    x = torch.from_numpy(xn.astype(np.float32)).to(dtype)
    with torch.no_grad():
        got = program.module()(x)
    args = export.parse_args(flags + ["--device", "cpu"])
    args.no_fuse = False
    live = load_model_and_vars(args)
    if bf16:
        live.cast(torch.bfloat16)
    want = live.predict(x)
    if nms:
        want = tuple(non_max_suppression(want.float(), 0.1, 0.45,
                                         max_nms=1024, nc=1))
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert int(got[4].sum()) > 0
    else:
        assert torch.equal(got, want)

    call = jax.export.deserialize(
        (jdir / "model.stablehlo").read_bytes()).call
    ref = call(jnp.asarray(x.float().numpy(), jnp.bfloat16 if bf16
                           else jnp.float32))
    if nms and not bf16:
        boxes, scores, _, valid, count = (np.asarray(t) for t in ref)
        assert np.array_equal(got[4].numpy(), count)
        assert np.array_equal(got[3].numpy(), valid)
        for g, w in ((got[0], boxes), (got[1], scores)):
            assert _rel(g.numpy()[valid], w[valid]) <= 1e-4
    elif not nms:
        ref = np.asarray(ref, np.float32)
        g = got.float().numpy()
        if bf16:
            rel = _rel(g, ref)
            corr = np.corrcoef(g.ravel(), ref.ravel())[0, 1]
            assert rel < 2e-2 and corr > 0.999, (rel, corr)
        else:
            assert _rel(g[..., :4], ref[..., :4]) <= 1e-4
            assert _rel(g[..., 4:], ref[..., 4:]) <= 1e-4

    # the fused parameters under the JAX export's keys
    with np.load(out.with_suffix(".params.npz")) as z, \
            np.load(jdir / "model.params.npz") as jz:
        packed = {k for k in z.files if k.rsplit(".", 1)[-1]
                  in ("wqk", "pq", "pv")}
        assert set(z.files) - packed <= set(jz.files)
        assert len(packed) == 6 and len(set(z.files) - packed) > 90
        halves = 0
        for k in set(z.files) - packed:
            a, b = (_float(z[k]), _float(jz[k]))
            halves += z[k].dtype.itemsize == 2
            # bf16: the port's attention islands stay float32 (JAX rounds
            # them to bf16 too), so their values sit within its rounding
            np.testing.assert_allclose(a, b, rtol=1e-2 if bf16 else 1e-5,
                                       atol=1e-6, err_msg=k)
        assert (halves > 50) == bf16
