"""``cli.detect`` and ``RepYOLO.predict_tta`` of the port against the JAX
package, on cfg/rep_yolo_tiny_test.yaml at 64 px on the CPU, with one set
of weights on both sides (a JAX ``TrainState`` ``.npz`` that both CLIs
read; the port's model from ``state_dict_from_jax`` of the same tree).

The weights are numpy draws (shapes by ``jax.eval_shape``, no init
compile), with the IDetect objectness weights scaled up so that scores
spread over (0, 1) and a detection set does not hang on float noise.

- ``predict_tta`` against the JAX ``predict_tta`` on a non-square batch:
  decoded rows within 1e-4 of the largest box coordinate, scores within
  1e-5; its resize against ``jax.image.resize(..., "bilinear")``.
- ``cli.detect.main`` against the JAX ``cli.detect.main`` on 3 JPEGs of
  different sizes and a 5-frame clip, plain and ``--augment``: the same
  output files, label lines equal within 2e-6 of each normalised
  coordinate (the ``%.6f`` rounding) and 1e-4 of each conf (``%.4f``).
- ``--fast int8`` on the port alone equals ``enable_int8_fast_path`` on
  the first frame (the int8 region itself is held against JAX in
  ``tests/test_torch_int8_neck_slice.py``).
- ``_frame_source`` case for case as ``tests/test_infra.py``.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rep_yolo_tpu.cli import detect as jax_detect
from rep_yolo_tpu.models.model import RepYOLO as JaxRepYOLO
from rep_yolo_tpu.train import checkpoint as JC
from rep_yolo_tpu.train.trainer import create_train_state as jax_train_state
from rep_yolo_tpu_torch.cli import detect
from rep_yolo_tpu_torch.data.letterbox import letterbox_batch
from rep_yolo_tpu_torch.models.model import RepYOLO, resize_matrix
from rep_yolo_tpu_torch.ops.nms import detections_to_numpy, \
    non_max_suppression
from rep_yolo_tpu_torch.ops.quant import enable_int8_fast_path
from rep_yolo_tpu_torch.utils.weights import state_dict_from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = str(ROOT / "cfg" / "rep_yolo_tiny_test.yaml")
SIZE = 64
IMAGE_SHAPES = ((48, 64), (80, 56), (64, 64))     # (h, w) of the JPEGs
CLIP = (5, 40, 72)                                # frames, h, w
OBJ_GAIN, OBJ_BIAS = 6.0, -2.0


def tiny_variables(seed: int = 0) -> dict:
    """A JAX variables tree of the tiny graph from numpy draws: kernels
    N(0, 1 / fan_in), BN scale / var in [0.5, 1.5], small biases and means,
    implicit ia ~ 0 and im ~ 1, attention gamma 0.7; the IDetect convs'
    objectness columns scaled by OBJ_GAIN with bias OBJ_BIAS."""
    model = JaxRepYOLO.from_config(TINY)
    shapes = jax.eval_shape(lambda r: model.net.init(
        {"params": r}, jnp.zeros((1, SIZE, SIZE, 3)), train=False),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    no = model.cfg.nc + 5

    def draw(path, s):
        keys = [p.key for p in path]
        leaf, shape = keys[-1], s.shape
        if leaf == "kernel":
            a = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif leaf in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif leaf == "gamma":
            a = np.full(shape, 0.7)
        elif leaf.startswith("im_"):
            a = 1 + 0.02 * rng.normal(size=shape)
        else:                               # bias, mean, ia_*
            a = 0.1 * rng.normal(size=shape)
        if keys[1] == f"l{model.cfg.head_index}" and keys[2].startswith("m_"):
            obj = np.arange(shape[-1]) % no == 4
            a = a.copy()
            if leaf == "kernel":
                a[..., obj] *= OBJ_GAIN
            else:
                a[..., obj] = OBJ_BIAS
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def port_model(variables, fuse=True) -> RepYOLO:
    m = RepYOLO.from_config(TINY, device="cpu").load_state(
        state_dict_from_jax(variables))
    return m.fuse() if fuse else m


def save_jax_train_state(path, variables) -> str:
    """A JAX ``TrainState`` ``.npz`` whose EMA weights are ``variables``
    (both CLIs serve the EMA)."""
    state = jax_train_state(variables, jax.random.PRNGKey(3))
    np.savez(f"{path}.npz", **JC._flatten(state))
    return str(path)


def write_sources(root: pathlib.Path) -> tuple[pathlib.Path, pathlib.Path]:
    """3 seeded JPEGs of IMAGE_SHAPES in ``root/images`` and a CLIP-frame
    mp4v clip ``root/clip.mp4``."""
    import cv2

    rng = np.random.default_rng(5)
    images = root / "images"
    images.mkdir(parents=True)
    for i, (h, w) in enumerate(IMAGE_SHAPES):
        img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8),
                               (5, 5), 0)
        cv2.imwrite(str(images / f"im{i}.jpg"), img)
    n, h, w = CLIP
    clip = root / "clip.mp4"
    writer = cv2.VideoWriter(str(clip), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                             (w, h))
    for _ in range(n):
        writer.write(cv2.GaussianBlur(
            rng.integers(0, 256, (h, w, 3), np.uint8), (5, 5), 0))
    writer.release()
    return images, clip


@pytest.fixture(scope="module")
def variables():
    return tiny_variables()


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    return write_sources(tmp_path_factory.mktemp("detect_src"))


@pytest.fixture(scope="module")
def ckpt(variables, tmp_path_factory):
    return save_jax_train_state(tmp_path_factory.mktemp("ckpt") / "best",
                                variables)


def test_resize_matrix_is_jax_bilinear():
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 96, 3))
    x = x.astype(np.float32)
    for nh, nw in ((64, 96), (64, 96 - 16), (32, 64), (64, 128)):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, nh, nw, 3),
                                           "bilinear"))
        got = torch.einsum("bhwc,hy,wx->byxc", torch.from_numpy(x),
                           resize_matrix(64, nh), resize_matrix(96, nw))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


def test_predict_tta_matches_jax(variables):
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 96, 3))
    x = x.astype(np.float32)
    jm, jv = JaxRepYOLO.from_config(TINY).fuse(variables)
    want = np.asarray(jax.jit(jm.predict_tta)(jv, jnp.asarray(x)))
    got = port_model(variables).predict_tta(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape          # 3 scales' rows concatenated
    box_tol = 1e-4 * np.abs(want[..., :4]).max()
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0,
                               atol=box_tol)
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], rtol=0,
                               atol=1e-5)


def _labels(out_dir: pathlib.Path) -> dict[str, np.ndarray]:
    return {p.name: np.loadtxt(p, ndmin=2) for p in
            sorted(out_dir.glob("*.txt"))}


def _run(cli, argv, project, name):
    return pathlib.Path(cli.main([*argv, "--project", str(project),
                                  "--name", name]))


@pytest.mark.parametrize("augment", [False, True])
def test_cli_detect_matches_jax(ckpt, sources, tmp_path, augment):
    images, clip = sources
    flags = ["--weights", ckpt, "--cfg", TINY, "--img-size", str(SIZE),
             "--save-txt"] + (["--augment"] if augment else [])
    outs = {}
    for side, cli, extra in (("jax", jax_detect, []),
                             ("port", detect, ["--device", "cpu"])):
        dirs = [_run(cli, ["--source", str(src), *flags, *extra],
                     tmp_path / side, "exp") for src in (images, clip)]
        assert dirs[0] != dirs[1]           # increment_path: exp, exp2
        outs[side] = dirs
    n_rows = 0
    for jd, pd in zip(outs["jax"], outs["port"]):
        assert sorted(p.name for p in jd.iterdir()) == \
            sorted(p.name for p in pd.iterdir())
        want, got = _labels(jd), _labels(pd)
        assert want.keys() == got.keys()
        for k in want:
            assert want[k].shape == got[k].shape, k
            assert (got[k][:, 0] == want[k][:, 0]).all()
            np.testing.assert_allclose(got[k][:, 1:5], want[k][:, 1:5],
                                       rtol=0, atol=2e-6 + 1e-9)
            np.testing.assert_allclose(got[k][:, 5], want[k][:, 5], rtol=0,
                                       atol=1e-4 + 1e-9)
            n_rows += len(got[k])
    assert n_rows > 0                       # the comparison saw detections
    # the clip's labels are appended per frame, one video written
    assert (outs["port"][1] / "clip.mp4").stat().st_size > 0


def test_cli_detect_fast_int8_calibrates_on_the_first_frame(ckpt, sources,
                                                            tmp_path,
                                                            variables):
    _, clip = sources
    out = _run(detect, ["--source", str(clip), "--weights", ckpt, "--cfg",
                        TINY, "--img-size", str(SIZE), "--conf-thres",
                        "0.1", "--save-txt", "--fast", "int8", "--device",
                        "cpu"], tmp_path, "int8")
    got = np.loadtxt(out / "clip.txt", ndmin=2)
    got_float = np.loadtxt(_run(detect, [
        "--source", str(clip), "--weights", ckpt, "--cfg", TINY,
        "--img-size", str(SIZE), "--conf-thres", "0.1", "--save-txt",
        "--device", "cpu"], tmp_path, "float") / "clip.txt", ndmin=2)
    # the int8 region moves the scores: the run did not serve float32
    assert got_float.shape != got.shape or \
        np.abs(got_float[:, 5] - got[:, 5]).max() > 1e-3
    model = port_model(variables)
    rows = []
    with torch.inference_mode():
        for i, (_, img0, _) in enumerate(detect._frame_source(str(clip))):
            h0, w0 = img0.shape[:2]
            canvas, (h, w), r0 = detect.fit_canvas(img0, SIZE)
            x = torch.from_numpy(canvas[None])
            hw = torch.tensor([[h, w]], dtype=torch.float32)
            imgs, ratio, pad = letterbox_batch(x, hw, SIZE)
            if i == 0:
                enable_int8_fast_path(model, imgs)
            d = detections_to_numpy(non_max_suppression(
                model.predict(imgs), 0.1, 0.45, max_nms=1024, nc=1))[0]
            d[:, [0, 2]] = ((d[:, [0, 2]] - float(pad[0, 0])) / float(ratio[0])
                            / r0).clip(0, w0)
            d[:, [1, 3]] = ((d[:, [1, 3]] - float(pad[0, 1])) / float(ratio[0])
                            / r0).clip(0, h0)
            for x1, y1, x2, y2, conf, cls in d:
                rows.append([cls, (x1 + x2) / 2 / w0, (y1 + y2) / 2 / h0,
                             (x2 - x1) / w0, (y2 - y1) / h0, conf])
    assert model.net.q8 is not None and len(rows) > 0
    want = np.asarray(rows)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:, 1:5], want[:, 1:5], rtol=0,
                               atol=5e-7 + 1e-9)
    np.testing.assert_allclose(got[:, 5], want[:, 5], rtol=0,
                               atol=5e-5 + 1e-9)


def test_frame_source_video_and_images(tmp_path):
    import cv2

    vid = tmp_path / "clip.mp4"
    w = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                        (64, 48))
    for i in range(5):
        w.write(np.full((48, 64, 3), i * 40, np.uint8))
    w.release()
    img = tmp_path / "im.jpg"
    cv2.imwrite(str(img), np.zeros((32, 32, 3), np.uint8))
    for src in (vid, img, tmp_path):
        want = list(jax_detect._frame_source(str(src)))
        got = list(detect._frame_source(str(src)))
        assert len(got) == len(want)
        for (gn, gf, gfps), (wn, wf, wfps) in zip(got, want):
            assert gn == wn and gfps == wfps
            assert np.array_equal(gf, wf)
    frames = list(detect._frame_source(str(vid)))
    assert len(frames) == 5
    assert all(fps is not None and abs(fps - 10) < 0.5
               for _, _, fps in frames)
    assert all(name == "clip" for name, _, _ in frames)
    assert frames[0][1].shape == (48, 64, 3)
    assert detect.VID_EXTS == jax_detect.VID_EXTS
