"""Hand-written CUDA kernels of the port, each beside its plain version.

``launch_counts()`` / ``reset_launch_counts()`` read and zero the per-wrapper
launch counters, so a run can show which kernels the main path went through.
"""

from __future__ import annotations

from rep_yolo_tpu_torch.ops.kernels import (axial_attention, conv_flat,
                                            conv_kernel, neck_flat, nms,
                                            pool_flat, wgrad)

_COUNTERS = (axial_attention.LAUNCHES, nms.LAUNCHES, conv_flat.LAUNCHES,
             pool_flat.LAUNCHES, neck_flat.LAUNCHES, wgrad.LAUNCHES,
             conv_kernel.LAUNCHES)


def launch_counts() -> dict[str, int]:
    out: dict[str, int] = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for key in c:
            c[key] = 0
