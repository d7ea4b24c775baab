"""Micro-bench of the int8 conv kernels at the DER l1 / l3 shapes (port of
``tools/kernel_bench_flat.py``): the channel-major kernels (the JAX "v1",
K13 / K14 on NCHW) against the flat ones (the JAX "v2": K4 / K5, whose
layout in the port is NHWC), int8 in and out, and the 2x2 max pool.

Lines, each mapped from the JAX tool's:
  v1 cm q8 <shape> (chained)        -- K13, int8 in, int8 out
  v2 flat q8 <shape> (chained)      -- K4, int8 in, int8 out
  v1 concat + conv1x1 q8 144->48    -- torch.cat of three sections, then K14
  v1 3-section conv1x1 q8 144->48   -- K14 over the three sections (no cat)
  v2 3-ref conv1x1 q8 144->48       -- K5 over the three sections
  MP NHWC max_pool2d 48ch           -- F.max_pool2d on a channels_last map
  MP cm reshape-max 48ch            -- a plain reshape-amax on NCHW
The JAX tool's ``row_tile`` lines are not ported: the row tile was Mosaic's.
Times are CUDA events over back-to-back calls after a warm-up, the median
of three runs (``tools.event_ms``); ``--device cpu`` runs the plain versions
on the CPU (for the tests).

Usage: python -m rep_yolo_tpu_torch.tools.kernel_bench_flat [batch]
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from rep_yolo_tpu_torch.device import resolve_device
from rep_yolo_tpu_torch.ops.kernels import conv_flat as KC
from rep_yolo_tpu_torch.ops.kernels import conv_kernel as KCM
from rep_yolo_tpu_torch.tools import event_ms

S = 1.0 / 64.0
CONV3 = [(48, 48, 320, 320, "l1 st 3x3 48ch@320^2"),
         (24, 24, 320, 320, "l1 st 3x3 24ch@320^2"),
         (48, 48, 160, 160, "l3 st 3x3 48ch@160^2"),
         (24, 24, 160, 160, "l3 mid 3x3 24ch@160^2"),
         (16, 48, 320, 320, "stem s2d 16ch@320^2")]
CV1 = (48, 48, 320, 320)          # three 48-channel sections -> 48
MP = (48, 320, 320)


def conv3_case(C, O, H, W, batch, device, seed=0) -> dict:
    """{line: fn} of one 3x3 shape: random int8 maps, weights U - 0.5."""
    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.rand((O, C, 3, 3), generator=g, device=device) - 0.5
    bias = torch.zeros(O, device=device)
    xq = torch.randint(-127, 127, (batch, C, H, W), generator=g,
                       device=device, dtype=torch.int8)
    xf = xq.permute(0, 2, 3, 1).contiguous()
    qcm, qf = KCM.CMQConv(w, bias), KC.QConv(w, bias)
    return {"v1 cm q8 {} (chained)": lambda: KCM.conv3x3_cmajor_q8(
                xq, qcm, S, out_scale=S),
            "v2 flat q8 {} (chained)": lambda: KC.conv3x3_q8(
                xf, qf, S, out_scale=S)}


def cv1_case(batch, device, shape=CV1, seed=0) -> dict:
    """{line: fn} of the DER cv1: three int8 sections, concat or not."""
    C, O, H, W = shape
    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.rand((O, 3 * C, 1, 1), generator=g, device=device) - 0.5
    bias = torch.zeros(O, device=device)
    x3 = [torch.randint(-127, 127, (batch, C, H, W), generator=g,
                        device=device, dtype=torch.int8) for _ in range(3)]
    x3f = [t.permute(0, 2, 3, 1).contiguous() for t in x3]
    qcm, qf = KCM.CMQConv(w, bias), KC.QConv(w, bias)
    tag = f"{3 * C}->{O}@{H}^2"
    return {f"v1 concat + conv1x1 q8 {tag}": lambda: KCM.conv1x1_cmajor_q8(
                torch.cat(x3, 1), qcm, S),
            f"v1 3-section conv1x1 q8 {tag}": lambda: KCM.conv1x1_cmajor_q8(
                x3, qcm, S),
            f"v2 3-ref conv1x1 q8 {tag}": lambda: KC.conv1x1_q8(
                x3f, qf, S, out_dtype=torch.bfloat16)}


def mp_case(batch, device, shape=MP, seed=0) -> dict:
    """{line: fn} of the 2x2/s2 max pool of a bf16 map."""
    C, H, W = shape
    g = torch.Generator(device=device).manual_seed(seed)
    xn = torch.rand((batch, H, W, C), generator=g, device=device).bfloat16()
    xc = xn.permute(0, 3, 1, 2).contiguous()
    return {f"MP NHWC max_pool2d {C}ch@{H}^2": lambda: F.max_pool2d(
                xn.permute(0, 3, 1, 2), 2, 2),
            f"MP cm reshape-max {C}ch@{H}^2": lambda: xc.reshape(
                batch, C, H // 2, 2, W // 2, 2).amax((3, 5))}


def cases(batch, device, conv3=CONV3, cv1=CV1, mp=MP):
    """(label, fn) of every line, in the JAX tool's order."""
    out = []
    for C, O, H, W, tag in conv3:
        out += [(k.format(tag), fn)
                for k, fn in conv3_case(C, O, H, W, batch, device).items()]
    out += list(cv1_case(batch, device, cv1).items())
    out += list(mp_case(batch, device, mp).items())
    return out


def run(batch: int, device: torch.device, iters: int = 20, conv3=CONV3,
        cv1=CV1, mp=MP, out=print) -> list[dict]:
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu (plain versions)")
    out(f"# device {name}, batch {batch}")
    rows = []
    with torch.inference_mode():
        for label, fn in cases(batch, device, conv3, cv1, mp):
            ms = event_ms(fn, device, iters)
            rows.append({"line": label, "ms": ms})
            out(f"{label:44s} {ms:8.3f} ms")
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser("kernel_bench_flat")
    p.add_argument("batch", nargs="?", type=int, default=32)
    p.add_argument("--iters", type=int, default=20,
                   help="back-to-back calls per timed run")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (the plain versions)")
    a = p.parse_args(argv)
    run(a.batch, resolve_device(a.device), a.iters)


if __name__ == "__main__":
    main()
