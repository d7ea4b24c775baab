"""rep-yolo-tpu-torch: the PyTorch / CUDA (Hopper) port of rep_yolo_tpu.

The port serves the fused float deploy path of the Rep-YOLO graph on an
NVIDIA H100: reparam fuse, letterbox, forward, top-k decode and NMS. The
two TPU kernels on that path are hand-written CUDA kernels here
(``ops/kernels``), built with ``nvcc`` at first use (``device.py``).

Public functions keep the JAX package's layouts: NHWC float images in
[0, 1], raw head maps ``(B, H, W, na, no)``, decoded predictions
``(B, N, no)``. Nothing builds or touches CUDA at import time.

Importing the package registers the custom ops ``rep_yolo_torch::
axial_project``, ``axial_attend`` (K1, K2) and ``nms_keep`` (K3), which a
program exported by ``cli.export`` calls.
"""

from rep_yolo_tpu_torch.device import have_cuda, resolve_device
from rep_yolo_tpu_torch.ops import kernels as _kernels  # noqa: F401

__all__ = ["have_cuda", "resolve_device"]
