"""The int8 modes' calibration on image files, port against JAX, on
cfg/rep_yolo_tiny_test.yaml at 64 px on the CPU: the synthetic val set
written as JPEG files by the JAX generator, read back by each package's
``DetectionDataset.from_path``, the first 8 images letterboxed as each
``cli.test`` does for ``--fast int8`` (the port's
``cli.test.calibration_images``), then each package's ``calibrate`` on
the same weights (``test_torch_detect.tiny_variables``): the batches
within float noise of each other and the scales at rtol 1e-5, key for
key. So the port reads and calibrates on JPEG canvases as the JAX CLI
does; the chip triage's int8 gap does not come from that chain.
"""

import jax.numpy as jnp
import numpy as np
import torch

from rep_yolo_tpu.data.augment import letterbox_batch as jax_letterbox
from rep_yolo_tpu.data.datasets import DetectionDataset as JaxDataset
from rep_yolo_tpu.data.datasets import make_synthetic_dataset as jax_synth
from rep_yolo_tpu.models.model import RepYOLO as JaxRepYOLO
from rep_yolo_tpu.ops import quant as jax_quant
from rep_yolo_tpu_torch.cli.test import calibration_images
from rep_yolo_tpu_torch.data.datasets import DetectionDataset
from rep_yolo_tpu_torch.ops.quant import calibrate
from test_torch_detect import SIZE, TINY, port_model, tiny_variables


def test_calibration_on_jpeg_files_matches_jax(tmp_path):
    jax_synth(12, SIZE, 1, 16, seed=1, root=tmp_path / "val")
    images = str(tmp_path / "val" / "images")
    jds = JaxDataset.from_path(images, SIZE, 1)
    items = [jds.load_item(i) for i in range(8)]
    jcal, _, _ = jax_letterbox(jnp.asarray(np.stack([it[0] for it in items])),
                               jnp.asarray(np.stack([it[1] for it in items])),
                               SIZE)
    cal = calibration_images(DetectionDataset.from_path(images, SIZE, 1),
                             SIZE, torch.device("cpu"))
    assert cal.shape == (8, SIZE, SIZE, 3)
    np.testing.assert_allclose(cal.numpy(), np.asarray(jcal), rtol=0,
                               atol=1e-5)

    variables = tiny_variables()
    jm, jv = JaxRepYOLO.from_config(TINY).fuse(variables)
    ref = jax_quant.calibrate(jm, jv, [jcal])
    got = calibrate(port_model(variables), [cal])
    assert sorted(got) == sorted(ref) and len(ref) > 20
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
