"""rep-yolo-tpu-torch: the PyTorch / CUDA (Hopper) port of rep_yolo_tpu.

The port serves the fused float deploy path of the Rep-YOLO graph on an
NVIDIA H100: reparam fuse, letterbox, forward, top-k decode and NMS. The
two TPU kernels on that path are hand-written CUDA kernels here
(``ops/kernels``), built with ``nvcc`` at first use (``device.py``).

Public functions keep the JAX package's layouts: NHWC float images in
[0, 1], raw head maps ``(B, H, W, na, no)``, decoded predictions
``(B, N, no)``. Nothing builds or touches CUDA at import time.
"""

from rep_yolo_tpu_torch.device import have_cuda, resolve_device

__all__ = ["have_cuda", "resolve_device"]
