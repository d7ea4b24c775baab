"""Post-training int8 quantization: the arithmetic the int8 kernels share,
and calibration.

Port of ``rep_yolo_tpu/ops/quant.py:calibrate`` and of the quantization
helpers of ``rep_yolo_tpu/ops/pallas/conv_kernel.py`` (``quantize_weights``,
``_epilogue``, ``_q8_epilogue``) and ``conv_flat._requant``. Scheme:
symmetric int8, per-output-channel weight scales, per-tensor activation
scales from the calibration absmax, s32 accumulation.

The operation order is the JAX package's, so the int8 values agree bit for
bit: ``x * (1/s)`` (never ``x / s``), ``acc * (s_w * s_in) + b`` with the
product formed first, SiLU as ``y * sigmoid(y)`` (ReLU as ``max(y, 0)``,
the pixel-major kernels' third activation), rounding half to even.
A scale given as a Python float becomes float32 before it multiplies, as a
weakly typed scalar does in JAX.
"""

from __future__ import annotations

import re
from typing import Sequence

import torch

QMAX = 127


def f32(v: float) -> torch.Tensor:
    """A Python scalar as a float32 0-d tensor (JAX's weak-type rule)."""
    return torch.tensor(v, dtype=torch.float32)


def quantize(x: torch.Tensor, s: float) -> torch.Tensor:
    """Per-tensor symmetric int8: clip(round(x * (1/s)), -127, 127)."""
    inv = f32(1.0 / s).to(x.device)
    return torch.clamp(torch.round(x.float() * inv), -QMAX, QMAX).to(
        torch.int8)


def quantize_weights(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of (O, ...) weights: int8 of the
    same shape and the f32 scales (O,), ``max(max|w|, 1e-12) / 127``.
    Done once, when the int8 plan is built."""
    w = w.float()
    s_w = torch.clamp(w.reshape(w.shape[0], -1).abs().amax(1),
                      min=1e-12) / 127.0
    shape = (-1,) + (1,) * (w.ndim - 1)
    w_q = torch.clamp(torch.round(w / s_w.reshape(shape)), -QMAX, QMAX)
    return w_q.to(torch.int8), s_w


def epilogue(acc: torch.Tensor, s_w: torch.Tensor, bias: torch.Tensor,
             s_in: float, act: str | None) -> torch.Tensor:
    """Dequant + bias + activation of s32 sums (..., O) -> f32."""
    y = acc.float() * (s_w * f32(s_in).to(s_w.device)) + bias
    if act == "silu":
        return y * torch.sigmoid(y)
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act is None:
        return y
    raise ValueError(f"unknown activation {act!r}")


def requant(y: torch.Tensor, out_scale: float | None) -> torch.Tensor:
    """int8 at ``out_scale`` for an int8-resident successor, else f32."""
    return y if out_scale is None else quantize(y, out_scale)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def jax_scope(name: str) -> str:
    """A deploy module name of the port -> the JAX package's scope path of
    the same conv (the inverse of ``utils.weights._map_components``):
    ``model.1.stage1.0.reparam_conv`` -> ``l1/stage1/reparam_conv``,
    ``model.14.gsb.0.conv_lighting.1.cv2.conv`` ->
    ``l14/gsb_0/gs2/cv2/conv``, ``model.65.m.0`` -> ``l65/m_0``."""
    parts = name.split(".")
    out: list[str] = []
    i = 0
    while i < len(parts):
        c = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else ""
        if c == "model" and nxt.isdigit():
            out.append(f"l{nxt}")
        elif re.fullmatch(r"stage\d", c) and nxt == "0":
            out.append(c)
        elif c == "gsb" and nxt.isdigit():
            out.append(f"gsb_{nxt}")
        elif c == "conv_lighting" and nxt in ("0", "1"):
            out.append("gs1" if nxt == "0" else "gs2")
        elif c in ("m", "m1", "m2") and nxt.isdigit():
            out.append(f"{c}_{nxt}")
        else:
            out.append(c)
            i += 1
            continue
        i += 2
    return "/".join(out)


@torch.no_grad()
def calibrate(model, batches: Sequence[torch.Tensor]) -> dict[str, float]:
    """Per-conv input absmax over ``batches`` through the float deploy
    forward. Returns ``{JAX scope path: absmax / 127}``, so one scales dict
    drives both packages.

    Forward pre-hooks on every deploy ``Conv2d`` (the IDetect ``m`` convs
    included) record their input. The attention blocks hold their q/k/v
    convs packed into kernel constants; their input is recorded under the
    three conv paths the JAX package's unpacked blocks report."""
    from rep_yolo_tpu_torch.nn.blocks import AxialAttention

    net = model.net
    maxes: dict[str, float] = {}

    def hook(keys):
        def record(_mod, args):
            a = float(args[0].detach().float().abs().amax())
            for k in keys:
                maxes[k] = max(maxes.get(k, 0.0), a)
        return record

    handles = []
    for name, mod in net.named_modules():
        if isinstance(mod, torch.nn.Conv2d):
            keys = [jax_scope(name)]
        elif isinstance(mod, AxialAttention):
            p = jax_scope(name)
            keys = [f"{p}/{c}/conv" for c in ("query_conv", "key_conv",
                                              "value_conv")]
        else:
            continue
        handles.append(mod.register_forward_pre_hook(hook(keys)))
    saved, der_fast = net.q8, net.der_fast
    net.set_q8(None)
    net.der_fast = None          # the DER convs' inputs pass the hooks
    try:
        for x in batches:
            net(x)
    finally:
        net.der_fast = der_fast
        net.set_q8(saved)
        for h in handles:
            h.remove()
    return {p: a / 127.0 for p, a in maxes.items() if a > 0.0}


def enable_int8_fast_path(model, sample_inputs, neck: bool = True,
                          dw5_dense: bool = True):
    """Calibrate a fused model on ``sample_inputs`` (one batch or a list of
    them: letterboxed NHWC images in [0, 1]) and switch its network to the
    int8 region: the backbone, and with ``neck`` (the default, as the JAX
    package's ``--fast int8``) the neck and head too; ``dw5_dense=False``
    puts GSConv's depthwise 5x5 on K12 (``Q8Region.dw5_dense``). Port of
    ``cli/detect.py:enable_int8_fast_path``; the region configuration is
    held by the network, not a process global. Returns the scales."""
    from rep_yolo_tpu_torch.models.region import Q8Region

    batches = sample_inputs if isinstance(sample_inputs, (list, tuple)) \
        else [sample_inputs]
    scales = calibrate(model, batches)
    model.net.set_q8(Q8Region(scales, neck=neck, dw5_dense=dw5_dense))
    return scales
