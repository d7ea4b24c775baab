#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (rep_yolo_tpu_torch) on one card.

Drives the port's paths, fused float serving of cfg/rep_yolo.yaml at 640 px
and the same with the calibrated int8 region (``--fast int8``: the backbone,
neck and head in int8, the attention blocks in float; and the backbone
region alone, ``Q8Region(neck=False)``), bfloat16 serving with the DER
blocks on the channel-major kernels (``build_engine(dtype=torch.bfloat16,
der_fast="bf16")``), and training it (phases 9-14), and holds every CUDA
kernel of those paths against its plain PyTorch version on the card.
Phases, one JSON line each:

  1. device and build: the card, then nvcc of every csrc/*.cu (parallel)
  2. kernels vs plain: axial attention (K1 projection, K2 both modes) at the
     six 640-px CCVA shapes, batch 2, gamma 0.7, random BN constants,
     atol = rtol = 1e-4; NMS keep masks on clustered boxes, zero-area
     duplicates and IoU exactly at the threshold, K = 1024 and 4096, keep
     sets identical (and equal to the greedy oracle at K = 1024)
  3. golden: tests/golden/model_weights.npz -> fuse -> predict at 256 px vs
     model_io.npz zf, rtol 5e-3, atol 2e-2
  4. attention visible end to end: the same weights with every gamma 0.5, at
     640 px, batch 2, kernel path vs plain path on the card
  5. serving: serve.py's HTTP server in a thread, 3 requests (batches 1, 2,
     4) at 640 px with max_batch 4; responses equal direct engine calls;
     launch counts of that run: 12 attention blocks (6 criss-cross,
     6 vertical) and 1 NMS per forward
  6. profile: torch.profiler over 5 served batches of 4: device time by
     kernel category and the device's busy share of the wall time
  7. times: per kernel at the served shapes (batch 4), the median of 20
     CUDA-event timed runs of 10 back-to-back calls each, beside the plain
     version and the bound; end-to-end ms of one served batch

and for the int8 path:

  2b. kernels_q8_vs_plain: K4 conv3x3_q8, K5 conv1x1_q8 and K6 max_pool2_q8
     at every backbone shape of 640 px, batch 4 (random weights, random
     int8 maps): int8 outputs identical but for +-1 LSB on at most 1e-4 of
     the elements, the float exit atol = rtol = 1e-5, pools identical
  4b. int8_e2e: golden weights, calibrated on the seeded uniform batch, at
     640 px, batch 2, the backbone region alone: the int8 kernel path vs the
     int8 plain path (region maps as above, raw maps atol = rtol = 1e-3,
     decoded boxes 1e-2 px, the NMS keep set identical); the region plan;
     and, as a report with no gate, int8 against float: the backbone exit
     (l7), raw maps and detections
  4c. int8_neck_e2e: the same with the neck on (the default --fast int8),
     every in-region map of the neck and head included; the layers whose
     convs still run as f32 cuDNN convs (only the attention islands) and,
     as a report, the P3-P5 features (l29, l45, l61) against float
  5b. serving_int8: as 5 with --fast int8; launch counts of that run per
     forward: 36 K4, 76 K5, 3 K6, 18 K7, 1 K8 beside the float path's
     12 / 6 / 6 / 1; serving_int8_backbone: the backbone region alone,
     25 K4, 28 K5, 1 K6
  5c. kernels_neck_vs_plain: every int8 kernel call of layers 9-65 of one
     served int8 forward (batch 4, the real maps and weights, recorded on
     the way), K4 (stride 1 and 2), K5 (1-3 sections, int8 or f32 out), K6,
     K7 and K8, against its plain version on the same inputs, as 2b
  6b. profile of the three engines, in turns (float, int8 backbone, int8,
     and back)
  7b. times_q8: K4-K6 per backbone shape, and K4-K8 per distinct neck call
     of 5c, beside the plain version, the bound and the PyTorch yardstick
     (the f32 cuDNN conv of the same shape; for K7 the f32 depthwise conv;
     for K8 the sequence of three F.max_pool2d and a torch.cat); summed per
     forward and, for the neck, per layer
  8. served_ab: one served batch of 4, the four engines in turns (the
     three above and the bfloat16 one of 5d)

and for bfloat16 serving (the JAX bench.py's mode, with the DER blocks'
"bf16" fast path; golden weights fused, then cast, the attention islands in
float32):

  2c. kernels_cm: K10 conv3x3_cmajor and K11 conv1x1_cmajor against their
     plain versions at the 20 distinct DER conv shapes of 640 px, batch 2,
     in bfloat16 and float32 (K11 over three sections at the cv1 shapes):
     float32 atol = rtol = 1e-4, bfloat16 within one bfloat16 ulp or 1e-3
     max|plain| near zero
  4d. bf16_e2e: batch 4, der_fast against the DER blocks on cuDNN bf16: raw
     maps per level within 2e-2 max|ref| and a correlation above 0.999; 24
     K10, 28 K11, 12 K1, 6 + 6 K2 launches per forward and 1 K3; K3 against
     its plain version on the candidates; as a report, against the float32
     model and the two paths' detections
  5d. serving_bf16: as 5, the bfloat16 der_fast engine; launches per
     forward 24 K10, 28 K11 beside 12 / 6 / 6 / 1
  15. throughput_bf16 (last, after training: after its batch-128 profiler
     windows every later window loses a device event): batch 128 first
     checked (K1 / K2 against plain at the CCVA shapes, 32 copies of 4
     images against the first, K3 against plain on the engine's
     candidates); then img/s, device ms by category, busy share and peak
     memory at batch 128 and 32, bfloat16 with and without der_fast, in
     turns
  7d. times_cm: K10 / K11 per DER shape at batch 4 and 128 (profiler ms from
     a cold L2, event ms, plain, cuDNN bf16 conv + bias + SiLU, bound),
     summed per forward

and, outside inference_mode, training cfg/rep_yolo.yaml at 640 px, batch 8
as cli.train builds it (build_training: seeded init, synthetic batches from
seed 0, scratch.p5, simOTA, SGD, EMA; --no-accumulate), with the wgrad route
on with select-all: 9 convs a step on K9; cuDNN's default algorithm choice,
as cli.train runs:

  9. kernels_wgrad_vs_plain: K9 wgrad3x3 at the nine routed shapes, seeded
     x and dY, rtol 1e-4 / atol 1e-4 x max|dW| against the plain version;
     the error against cuDNN's wgrad as a report
  10. times_wgrad: K9 per shape and summed per step (profiler device time,
     CUDA events around a cold call as a check) beside the plain version,
     conv2d_weight and the bound (the least operation count)
  11. train_step: 3 warm-up and 10 timed steps, finite losses, 9 K9
     launches a step (counts zeroed before the timed steps, read after);
     one step's grads with K9 against the plain autograd path (cuDNN
     wgrad), per parameter rtol 1e-3 / atol 1e-3 x max|g|; host ms,
     device ms by category and busy share under torch.profiler, peak memory
  12. train_overfit: 20 steps on one batch, warmup off: the loss falls
  13. train_cli: python -m rep_yolo_tpu_torch.cli.train --data synthetic:16
     --epochs 1 (batch 8, 640 px, no augment, no autoanchor, no eval) exits
     0 with finite step lines
  14. profiler_after_training: the device events the profiler records in
     windows of K9 calls after the training phases (a report)

Then the kernels line {"kernels": [...]} and, last, {"ok": true, "device":
{...}}. Any failure raises and exits non-zero without the last line.

Run:  python3 chip_smoke.py [--out results.json]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = pathlib.Path(__file__).resolve().parent
CFG = str(ROOT / "cfg" / "rep_yolo.yaml")
GOLDEN = ROOT / "tests" / "golden"
SIZE = 640             # served image size of every end-to-end phase
T0 = time.perf_counter()

MEM_BW = 3.35e12       # H100 SXM HBM3 bytes/s (data sheet)
F32_PEAK = 67e12       # H100 SXM f32 non-tensor FLOP/s (data sheet)
INT8_PEAK = 1979e12    # H100 SXM dense int8 tensor-core OP/s (data sheet)
BF16_PEAK = 989e12     # H100 SXM dense bf16 tensor-core FLOP/s (data sheet)
# (c_, H, W) of the six CCVA attention blocks at 640 px (layers 21, 27, 37,
# 43, 53, 59)
ATTN_SHAPES = [(64, 80, 80), (32, 80, 80), (128, 40, 40), (64, 40, 40),
               (256, 20, 20), (128, 20, 20)]
LINES: list[dict] = []


def emit(obj: dict) -> None:
    obj["t_s"] = round(time.perf_counter() - T0, 1)
    LINES.append(obj)
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, runs: int = 20, warmup: int = 3, reps: int = 10) -> float:
    """Median over `runs` of the ms per call of `reps` back-to-back calls
    between two CUDA events (one call alone would also time the host's
    launch latency of a kernel shorter than it)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def bound(nbytes: float, flops: float,
          peak: float = F32_PEAK) -> tuple[float, str]:
    tb, tf = nbytes / MEM_BW * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------------------


def attention_inputs(c, h, w, batch, seed, gamma, device):
    """x and the packed constants (``nn.fuse``) of an attention block with
    random weights and BN constants."""
    import torch

    from rep_yolo_tpu_torch.nn.blocks import AxialAttention
    from rep_yolo_tpu_torch.nn.fuse import fuse_state_dict

    g = torch.Generator().manual_seed(seed)
    state = {}
    for name, t in AxialAttention(c, True).state_dict().items():
        if name.endswith("running_var") or (name.endswith("weight")
                                            and t.ndim == 1):
            state[name] = 0.5 + torch.rand(t.shape, generator=g)
        elif name.endswith("gamma"):
            state[name] = torch.full(t.shape, gamma)
        else:
            state[name] = 0.3 * torch.randn(t.shape, generator=g)
    packed = fuse_state_dict(state)
    x = torch.randn((batch, h, w, c), generator=g)
    consts = [packed[k] for k in ("wqk", "pq", "pv", "gamma")]
    return [t.to(device) for t in (x, *consts)]


def attention_cost(c, h, w, batch, criss_cross):
    """(bytes, flops) of K1 and of K2 for one call."""
    npix, c8 = batch * h * w, c // 8
    k1_bytes = 4 * (npix * c + 2 * c8 * c + 6 * c8 + 4 * c
                    + npix * (2 * c8 + c))
    k1_flops = npix * (4 * c8 * c + 10 * (2 * c8 + c))
    L = (w + h) if criss_cross else h
    k2_bytes = 4 * (npix * 2 * c8 + npix * 2 * c + npix * c + 1)
    k2_flops = npix * (2 * L * c8 + (3 * L if criss_cross else 0)
                       + 2 * L * c + 3 * c)
    return (k1_bytes, k1_flops), (k2_bytes, k2_flops)


def nms_cases(device):
    """(name, boxes (B,K,4), valid (B,K), thr) cases for the NMS check."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    cases = []
    for K in (1024, 4096):
        centers = rng.uniform(0, 640, (2, 24, 2))
        pick = rng.integers(0, 24, (2, K))
        c = np.take_along_axis(centers, pick[..., None], 1) \
            + rng.normal(0, 6, (2, K, 2))
        wh = rng.uniform(20, 80, (2, K, 2))
        boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
        valid = rng.uniform(size=(2, K)) < 0.9
        cases.append((f"clustered_K{K}", boxes, valid, 0.45))
        dup = boxes.copy()
        dup[:, ::3, 2:] = dup[:, ::3, :2]                # zero area
        dup[:, 1::3] = dup[:, ::3][:, : dup[:, 1::3].shape[1]]
        cases.append((f"zero_area_dups_K{K}", dup, valid, 0.45))
        # pairs at IoU exactly 0.5 (= thr: kept): [x, y, x+32, y+8] then
        # [x, y, x+16, y+8], inter 128, union 256, all exact in f32
        xy = rng.integers(0, 75, (2, K // 2, 2)) * 8.0
        edge = np.empty((2, K, 4))
        for j, wd in ((0, 32.0), (1, 16.0)):
            edge[:, j::2] = np.concatenate([xy, xy + [wd, 8.0]], -1)
        cases.append((f"iou_at_threshold_K{K}", edge, valid, 0.5))
    return [(n, torch.as_tensor(b, dtype=torch.float32, device=device),
             torch.as_tensor(v, device=device), t) for n, b, v, t in cases]


def backbone_q8_shapes():
    """The int8 region's kernel calls of one SIZE-px forward: (name,
    kernel, input channels (per section for K5), output channels, input
    size, stride, float input, float output, fused pool, calls per
    forward)."""
    rows = [("l0 stem", "conv3x3_q8", (3,), 48, SIZE, 2, True, False, False,
             1)]
    for layer, c1, c2, hw, pool, exit_ in (
            (1, 48, 48, SIZE // 2, True, False),
            (3, 48, 128, SIZE // 4, True, False),
            (5, 128, 256, SIZE // 8, False, False),
            (7, 256, 512, SIZE // 16, False, True)):
        half = c1 // 2
        rows += [
            (f"l{layer} st1-st3", "conv3x3_q8", (c1,), c1, hw, 1, False,
             False, False, 3),
            (f"l{layer} st4-st6", "conv3x3_q8", (half,), half, hw, 1, False,
             False, False, 3),
            (f"l{layer} cv*_1", "conv1x1_q8", (c1,), half, hw, 1, False,
             False, False, 3),
            (f"l{layer} cv*_2", "conv1x1_q8", (half,), c1, hw, 1, False,
             False, False, 3),
            (f"l{layer} cv1", "conv1x1_q8", (c1, c1, c1), c2, hw, 1, False,
             exit_, pool, 1)]
        if layer == 5:
            rows.append(("l6 MP", "max_pool2_q8", (c2,), c2, hw, 2, False,
                         False, False, 1))
    return rows


def q8_case(torch, row, batch, dev, seed):
    """Inputs and calls of one backbone shape: (kernel fn, plain fn,
    f32 cuDNN fn or None, out_scale, bytes, ops). Random weights at
    1/sqrt(fan_in), random int8 maps at s_in = 1/127; out_scale puts the
    plain float output's absmax at 127."""
    import torch.nn.functional as F

    from rep_yolo_tpu_torch.ops.kernels import conv_flat as KC
    from rep_yolo_tpu_torch.ops.kernels import pool_flat as KP

    name, kern, cins, cout, hw, stride, f32_in, f32_out, pool, _ = row
    g = torch.Generator(device=dev).manual_seed(seed)
    s_in = 1.0 / 127.0
    if kern == "max_pool2_q8":
        x = torch.randint(-127, 128, (batch, hw, hw, cins[0]), generator=g,
                          device=dev, dtype=torch.int8)
        nbytes = x.numel() * 1.25
        B, H, W, C = x.shape
        lib = lambda: x.reshape(B, H // 2, 2, W // 2, 2, C).amax((2, 4))  # noqa
        return (lambda: KP.max_pool2_q8(x), lambda: KP.max_pool2_q8_plain(x),
                lib, None, nbytes, 0.0)
    k = 3 if kern == "conv3x3_q8" else 1
    cin = sum(cins)
    w = torch.randn((cout, cin, k, k), generator=g, device=dev) \
        / (cin * k * k) ** 0.5
    b = 0.1 * torch.randn((cout,), generator=g, device=dev)
    qw = KC.QConv(w, b)
    if f32_in:
        xs = [torch.rand((batch, hw, hw, cins[0]), generator=g, device=dev)]
        xf = xs[0]
    else:
        xs = [torch.randint(-127, 128, (batch, hw, hw, c), generator=g,
                            device=dev, dtype=torch.int8) for c in cins]
        xf = torch.cat(xs, -1).float() * s_in
    xf = xf.permute(0, 3, 1, 2).contiguous()
    if kern == "conv3x3_q8":
        def run(fn, out):
            return fn(xs[0], qw, s_in, stride, "silu", out)
        kfn, pfn = KC.conv3x3_q8, KC.conv3x3_q8_plain
    else:
        def run(fn, out):
            return fn(xs, qw, s_in, "silu", out, pool)
        kfn, pfn = KC.conv1x1_q8, KC.conv1x1_q8_plain
    out_s = None if f32_out else \
        float(run(pfn, None).abs().max()) / 127.0
    ho = (hw - 1) // stride + 1
    npix_out = batch * ho * ho // (4 if pool else 1)
    nbytes = (sum(t.numel() * t.element_size() for t in xs) + qw.w_q.numel()
              + 8 * cout + npix_out * cout * (4 if f32_out else 1))
    ops = 2.0 * batch * ho * ho * cout * cin * k * k
    lib = lambda: F.conv2d(xf, w, b, stride=stride, padding=k // 2)  # noqa
    return (lambda: run(kfn, out_s), lambda: run(pfn, out_s), lib, out_s,
            nbytes, ops)


Q8_KERNELS = ("conv3x3_q8", "conv1x1_q8", "max_pool2_q8", "dwconv5x5_q8",
              "spp_pools_q8")
# launches of one int8 forward at 640 px, the neck on / the backbone alone
Q8_PER_FORWARD = {"conv3x3_q8": 36, "conv1x1_q8": 76, "max_pool2_q8": 3,
                  "dwconv5x5_q8": 18, "spp_pools_q8": 1}
Q8_BACKBONE_PER_FORWARD = {"conv3x3_q8": 25, "conv1x1_q8": 28,
                           "max_pool2_q8": 1, "dwconv5x5_q8": 0,
                           "spp_pools_q8": 0}
NECK_FIRST = 9          # the neck's first layer (SPPCSPC)


def q8_module(name):
    """The module that holds kernel wrapper ``name`` and its plain
    version."""
    from rep_yolo_tpu_torch.ops.kernels import conv_flat as KC
    from rep_yolo_tpu_torch.ops.kernels import neck_flat as KNF
    from rep_yolo_tpu_torch.ops.kernels import pool_flat as KP

    return {"conv3x3_q8": KC, "conv1x1_q8": KC, "max_pool2_q8": KP,
            "dwconv5x5_q8": KNF, "spp_pools_q8": KNF}[name]


def record_q8_calls(model, x):
    """One forward of ``model`` on ``x``: (raw maps, [(layer, kernel name,
    bound arguments)] of every int8 kernel call, with its real inputs)."""
    import inspect

    net = model.net
    calls, layer = [], [None]
    run = net._run_q8
    saved = {}

    def run_rec(spec, mod, step, inp):
        layer[0] = spec.i
        return run(spec, mod, step, inp)

    for name in Q8_KERNELS:
        mod = q8_module(name)
        fn = saved[name] = getattr(mod, name)
        sig = inspect.signature(getattr(mod, name + "_plain"))

        def rec(*a, _fn=fn, _n=name, _sig=sig, **k):
            b = _sig.bind(*a, **k)
            b.apply_defaults()
            calls.append((layer[0], _n, dict(b.arguments)))
            return _fn(*a, **k)
        setattr(mod, name, rec)
    net._run_q8 = run_rec
    try:
        maps = model.apply(x)
    finally:
        del net._run_q8
        for name, fn in saved.items():
            setattr(q8_module(name), name, fn)
    return maps, calls


def call_case(torch, name, args):
    """A recorded int8 kernel call: (kernel fn, plain fn, PyTorch yardstick
    fn, out_scale, bytes, int8 ops, signature). The yardstick runs the f32
    function of the same shape: the cuDNN conv, the depthwise conv, the
    amax pool, or for the SPP pyramid three F.max_pool2d and a torch.cat."""
    import torch.nn.functional as F

    mod = q8_module(name)
    kfn, pfn = getattr(mod, name), getattr(mod, name + "_plain")
    out_s = args.get("out_scale")

    def kcall():
        return kfn(**args)

    def pcall():
        return pfn(**args)

    if name in ("max_pool2_q8", "spp_pools_q8"):
        x = args["x"]
        xf = x.permute(0, 3, 1, 2).float().contiguous()
        if name == "max_pool2_q8":
            B, H, W, C = x.shape
            lib = lambda: x.reshape(B, H // 2, 2, W // 2, 2, C).amax((2, 4))  # noqa
            nbytes, ops = x.numel() * 1.25, 0.0
        else:
            def lib():
                return torch.cat([xf] + [F.max_pool2d(xf, k, 1, k // 2)
                                         for k in (5, 9, 13)], 1)
            # 3 levels x 2 separable passes x 4 byte maxima per element
            nbytes, ops = x.numel() * 5.0, 24.0 * x.numel()
        sig = (name, tuple(x.shape))
        return kcall, pcall, lib, None, nbytes, ops, sig
    if name == "dwconv5x5_q8":
        x, qd = args["x"], args["qd"]
        C = qd.c
        xf = x.permute(0, 3, 1, 2).float().contiguous()
        wf = qd.w_q.float().reshape(C, 1, 5, 5)
        lib = lambda: F.conv2d(xf, wf, qd.bias, padding=2, groups=C)  # noqa
        out_b = 4 if out_s is None else 1
        nbytes = x.numel() * (1 + out_b) + qd.w_q.numel() + 8 * C
        ops = 2.0 * 25 * x.numel()
        sig = (name, tuple(x.shape), args["act"], out_s is None)
        return kcall, pcall, lib, out_s, nbytes, ops, sig
    qw = args["qw"]
    if name == "conv3x3_q8":
        xs, stride, k = [args["x"]], args["stride"], 3
    else:
        xs = args["xs"] if isinstance(args["xs"], (list, tuple)) \
            else [args["xs"]]
        stride, k = 1, 1
    pool = bool(args.get("pool"))
    B, H, W = xs[0].shape[:3]
    cin = sum(t.shape[-1] for t in xs)
    ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    xf = torch.cat(xs, -1).float().permute(0, 3, 1, 2).contiguous()
    wf = qw.w_q.float().permute(0, 3, 1, 2)[:, :cin].contiguous()
    lib = lambda: F.conv2d(xf, wf, qw.bias, stride=stride, padding=k // 2)  # noqa
    npix = B * ho * wo // (4 if pool else 1)
    nbytes = (sum(t.numel() * t.element_size() for t in xs) + qw.w_q.numel()
              + 8 * qw.c_out + npix * qw.c_out * (4 if out_s is None else 1))
    ops = 2.0 * B * ho * wo * qw.c_out * cin * k * k
    sig = (name, tuple(tuple(t.shape) for t in xs), str(xs[0].dtype),
           qw.c_out, stride, args["act"], out_s is None, pool)
    return kcall, pcall, lib, out_s, nbytes, ops, sig


def q8_diff(torch, got, ref, out_scale):
    """(max abs err in the output's float units, elements off by one LSB,
    elements off by more) of a kernel output against its plain version."""
    if got.dtype != torch.int8:
        return float((got - ref).abs().max()), 0, 0
    d = (got.int() - ref.int()).abs()
    return (float(d.max()) * (out_scale or 1.0), int((d == 1).sum()),
            int((d > 1).sum()))


# ---------------------------------------------------------------------------


def phase_device_build(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi unavailable"
    print(card, flush=True)
    from rep_yolo_tpu_torch import device as D

    t0 = time.perf_counter()
    libs = D.build_kernels()
    emit({"phase": "device_build", "ok": True, "card": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "build_s": round(time.perf_counter() - t0, 3),
          "libs": sorted(str(p.relative_to(ROOT)) for p in libs.values())})
    return card


def phase_kernels(torch, dev, errs):
    from rep_yolo_tpu_torch.ops import nms as N
    from rep_yolo_tpu_torch.ops.kernels import axial_attention as KA
    from rep_yolo_tpu_torch.ops.kernels import nms as KN

    tol = dict(atol=1e-4, rtol=1e-4)
    rows = []
    for i, (c, h, w) in enumerate(ATTN_SHAPES):
        x, wqk, pq, pv, gamma = attention_inputs(c, h, w, 2, i, 0.7, dev)
        q, k, v = KA.project(x, wqk, pq, pv)
        qp, kp, vp = KA.project_plain(x, wqk, pq, pv)
        e1 = max(float((a - b).abs().max()) for a, b in
                 ((q, qp), (k, kp), (v, vp)))
        for a, b in ((q, qp), (k, kp), (v, vp)):
            torch.testing.assert_close(a, b, **tol)
        errs["axial_project"] = max(errs.get("axial_project", 0.0), e1)
        for cc in (True, False):
            name = "axial_attend_" + ("criss_cross" if cc else "vertical")
            y = KA.attend(qp, kp, vp, x, gamma, cc)
            yp = KA.attend_plain(qp, kp, vp, x, gamma, cc)
            torch.testing.assert_close(y, yp, **tol)
            yf = KA.axial_attention(x, wqk, pq, pv, gamma, cc)
            yfp = KA.axial_attention_plain(x, wqk, pq, pv, gamma, cc)
            torch.testing.assert_close(yf, yfp, **tol)
            e2 = float((y - yp).abs().max())
            errs[name] = max(errs.get(name, 0.0), e2)
            rows.append({"shape": [2, h, w, c], "mode": name, "k2_err": e2,
                         "k1k2_err": float((yf - yfp).abs().max()),
                         "out_absmax": float(yp.abs().max())})
    torch.cuda.synchronize()
    nms_rows = []
    for name, boxes, valid, thr in nms_cases(dev):
        keep = KN.nms_keep(boxes, valid, thr)
        ref = KN.nms_keep_plain(boxes, valid, thr)
        same = bool(torch.equal(keep, ref))
        row = {"case": name, "kept": int(keep.sum()), "identical": same}
        if boxes.shape[1] == 1024:
            oracle = N._greedy_keep(boxes.cpu(), valid.cpu(), thr)
            row["greedy_identical"] = bool(torch.equal(keep.cpu(), oracle))
            same &= row["greedy_identical"]
        nms_rows.append(row)
        if not same:
            raise AssertionError(f"NMS keep mask differs: {row}")
    errs["nms_keep"] = 0.0
    emit({"phase": "kernels_vs_plain", "ok": True, "tolerance": tol,
          "attention": rows, "nms": nms_rows})


def phase_kernels_q8(torch, dev, errs):
    """K4-K6 against their plain versions at every backbone shape."""
    rows = []
    for i, row in enumerate(backbone_q8_shapes()):
        kfn, pfn, _, out_s, _, _ = q8_case(torch, row, 4, dev, 100 + i)
        got, ref = kfn(), pfn()
        torch.cuda.synchronize()
        err, off1, off_more = q8_diff(torch, got, ref, out_s)
        n = got.numel()
        r = {"shape": row[0], "kernel": row[1], "out": list(got.shape),
             "dtype": str(got.dtype), "max_abs_err": err,
             "lsb_off_by_1": off1, "lsb_off_by_more": off_more}
        rows.append(r)
        if got.dtype == torch.int8:
            ok = off_more == 0 and off1 <= 1e-4 * n
            if row[1] == "max_pool2_q8":
                ok = off1 == 0
        else:
            ok = bool(torch.allclose(got, ref, atol=1e-5, rtol=1e-5))
        if not ok:
            raise AssertionError(f"{row[1]} differs from its plain version: "
                                 f"{r}")
        errs[row[1]] = max(errs.get(row[1], 0.0), err)
    emit({"phase": "kernels_q8_vs_plain", "ok": True, "batch": 4,
          "tolerance": "int8 identical but for +-1 LSB on <= 1e-4 of the "
                       "elements; float exit atol = rtol = 1e-5; pool "
                       "identical", "shapes": rows})


def phase_golden(torch, dev):
    import numpy as np

    from rep_yolo_tpu_torch.models.model import RepYOLO
    from rep_yolo_tpu_torch.utils.weights import load_reference_npz

    g = np.load(GOLDEN / "model_io.npz")
    model = RepYOLO.from_config(CFG, device=dev).load_state(
        load_reference_npz(GOLDEN / "model_weights.npz")).fuse()
    x = torch.from_numpy(g["x"].transpose(0, 2, 3, 1).copy()).to(dev)
    zf = model.predict(x).cpu()
    ref = torch.from_numpy(g["zf"])
    torch.testing.assert_close(zf, ref, rtol=5e-3, atol=2e-2)
    emit({"phase": "golden_zf", "ok": True, "shape": list(zf.shape),
          "max_abs_err": float((zf - ref).abs().max()),
          "tolerance": {"rtol": 5e-3, "atol": 2e-2}})


@contextlib.contextmanager
def plain_attention():
    """Run the network's attention blocks through the plain version (an
    explicit reference run of this script, on the card)."""
    from rep_yolo_tpu_torch.ops.kernels import axial_attention as KA

    kernel = KA.axial_attention
    KA.axial_attention = KA.axial_attention_plain
    try:
        yield
    finally:
        KA.axial_attention = kernel


def phase_attention_e2e(torch, dev):
    import numpy as np

    from rep_yolo_tpu_torch.models.model import RepYOLO
    from rep_yolo_tpu_torch.ops.boxes import xywh2xyxy
    from rep_yolo_tpu_torch.ops.kernels import nms as KN
    from rep_yolo_tpu_torch.ops.nms import non_max_suppression
    from rep_yolo_tpu_torch.utils.weights import load_reference_npz

    state = load_reference_npz(GOLDEN / "model_weights.npz")
    models = {}
    for gm in (0.0, 0.5):
        st = {k: (np.full_like(v, gm) if k.endswith(".gamma") else v)
              for k, v in state.items()}
        models[gm] = RepYOLO.from_config(CFG, device=dev).load_state(
            st).fuse()
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)).to(dev)
    conf, iou = 0.001, 0.45
    m = models[0.5]
    maps_k = m.apply(x)
    pred_k = m.predict(x)
    top_k = m.predict_topk(x, 1024, conf_thres=conf)
    det_k = non_max_suppression(top_k, conf, iou, presorted=True)
    with plain_attention():
        maps_p = m.apply(x)
        pred_p = m.predict(x)
        top_p = m.predict_topk(x, 1024, conf_thres=conf)
    det_p = non_max_suppression(top_p, conf, iou, presorted=True,
                                method="matrix")
    # the attention branch must move the boxes far beyond the tolerance
    visible = float((pred_k[..., :4] - models[0.0].predict(x)[..., :4])
                    .abs().max())
    map_err = max(float((a - b).abs().max()) for a, b in zip(maps_k, maps_p))
    for a, b in zip(maps_k, maps_p):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    box_err = float((pred_k[..., :4] - pred_p[..., :4]).abs().max())
    score_err = float((pred_k[..., 4] - pred_p[..., 4]).abs().max())
    n_cand = (top_k[..., 4] > conf).sum(1).tolist()
    # the kernel NMS on the kernel path's candidates == the plain fixed
    # point on the same candidates
    boxes_k = xywh2xyxy(top_k[..., :4])
    valid_k = top_k[..., 4] > conf
    keep_same = bool(torch.equal(KN.nms_keep(boxes_k, valid_k, iou),
                                 KN.nms_keep_plain(boxes_k, valid_k, iou)))
    out = {"phase": "attention_e2e", "gamma": 0.5, "batch": 2, "size": SIZE,
           "raw_map_max_abs_err": map_err,
           "gamma_effect_box_max_abs_px": visible,
           "decoded_box_max_abs_err_px": box_err,
           "decoded_score_max_abs_err": score_err,
           "valid_candidates": n_cand,
           "detections_kernel": det_k.count.tolist(),
           "detections_plain": det_p.count.tolist(),
           "nms_keep_identical": keep_same}
    ok = (box_err <= 1e-2 and score_err <= 1e-4 and min(n_cand) >= 100
          and det_k.count.tolist() == det_p.count.tolist() and keep_same
          and visible > 0.1)
    out["ok"] = ok
    emit(out)
    if not ok:
        raise AssertionError(f"attention end-to-end check failed: {out}")


@contextlib.contextmanager
def plain_q8():
    """Run the int8 region through the plain versions of K4-K8."""
    saved = {n: getattr(q8_module(n), n) for n in Q8_KERNELS}
    for n in Q8_KERNELS:
        setattr(q8_module(n), n, getattr(q8_module(n), n + "_plain"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(q8_module(n), n, fn)


def _region_outputs(model, x):
    """Raw maps of one forward and the region's per-layer outputs."""
    net = model.net
    seen = {}
    run = net._run_q8

    def record(spec, mod, step, inp):
        seen[spec.i] = run(spec, mod, step, inp)
        return seen[spec.i]

    net._run_q8 = record
    try:
        maps = model.apply(x)
    finally:
        del net._run_q8
    return maps, seen


def _region_diff(torch, a, b):
    """(max abs err, LSB off by 1, LSB off by more, elements, float) of one
    region output of the kernel path against the plain path: an int8 map
    (err in its float units), a float map, or a list of them (a concat, the
    head's levels)."""
    from rep_yolo_tpu_torch.models.region import Q8Map

    if isinstance(a, list):
        parts = [_region_diff(torch, u, v) for u, v in zip(a, b)]
        return (max(p[0] for p in parts), sum(p[1] for p in parts),
                sum(p[2] for p in parts), sum(p[3] for p in parts),
                any(p[4] for p in parts))
    if isinstance(a, Q8Map):
        if (a.perm is None) != (b.perm is None) or (
                a.perm is not None and not torch.equal(a.perm, b.perm)):
            raise AssertionError("region maps differ in their permutation")
        scale = a.scale if isinstance(a.scale, float) else 1.0
        return (*q8_diff(torch, a.data, b.data, scale), a.data.numel(),
                False)
    return float((a - b).abs().max()), 0, 0, a.numel(), True


def float_conv_layers(torch, model, x):
    """The layers whose convs run as float (cuDNN) convs in one forward."""
    layers = set()
    hooks = [m.register_forward_pre_hook(
        lambda _m, _a, i=int(name.split(".")[1]): layers.add(i))
        for name, m in model.net.named_modules()
        if isinstance(m, torch.nn.Conv2d)]
    try:
        model.apply(x)
    finally:
        for h in hooks:
            h.remove()
    return sorted(layers)


def phase_int8_e2e(torch, dev, neck=False):
    """The int8 region end to end, kernel path against plain path: the
    backbone region alone (``neck=False``) or with the neck
    and head (the default --fast int8)."""
    import numpy as np

    from rep_yolo_tpu_torch.models import heads
    from rep_yolo_tpu_torch.models.model import RepYOLO
    from rep_yolo_tpu_torch.models.region import Q8Map
    from rep_yolo_tpu_torch.ops.boxes import xywh2xyxy
    from rep_yolo_tpu_torch.ops.kernels import launch_counts, \
        reset_launch_counts
    from rep_yolo_tpu_torch.ops.kernels import nms as KN
    from rep_yolo_tpu_torch.ops.nms import non_max_suppression
    from rep_yolo_tpu_torch.ops.quant import enable_int8_fast_path
    from rep_yolo_tpu_torch.serve import calibration_batch
    from rep_yolo_tpu_torch.utils.weights import load_reference_npz

    m = RepYOLO.from_config(CFG, device=dev).load_state(
        load_reference_npz(GOLDEN / "model_weights.npz")).fuse()
    scales = enable_int8_fast_path(m, calibration_batch(SIZE, dev), neck=neck)
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)).to(dev)
    conf, iou, nl = 0.001, 0.45, m.cfg.nl

    def decode(maps):
        pred = heads.decode_predictions(maps[:nl], m.anchors_px, m.strides)
        top = heads.decode_topk(maps[:nl], m.anchors_px, m.strides, k=1024,
                                conf_thres=conf)
        return pred, top

    torch.cuda.synchronize()
    reset_launch_counts()
    maps_k, seen_k = _region_outputs(m, x)
    torch.cuda.synchronize()
    counts = launch_counts()
    with plain_q8():
        maps_p, seen_p = _region_outputs(m, x)
    plan = dict(m.net.region_plan)
    want = Q8_PER_FORWARD if neck else Q8_BACKBONE_PER_FORWARD
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"int8 forward launched {counts}, want {want}")

    region = {}
    for i in sorted(seen_k):
        a, b = seen_k[i], seen_p[i]
        err, off1, more, n, is_float = _region_diff(torch, a, b)
        region[f"l{i}"] = {"max_abs_err": err, "lsb_off_by_1": off1,
                           "lsb_off_by_more": more, "elements": n}
        if more or off1 > 1e-4 * n or (is_float and err > 1e-3):
            raise AssertionError(f"int8 region l{i} differs: {region}")
    map_err = max(float((a - b).abs().max()) for a, b in zip(maps_k, maps_p))
    for a, b in zip(maps_k, maps_p):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)
    pred_k, top_k = decode(maps_k)
    pred_p, _ = decode(maps_p)
    box_err = float((pred_k[..., :4] - pred_p[..., :4]).abs().max())
    boxes = xywh2xyxy(top_k[..., :4])
    valid = top_k[..., 4] > conf
    keep_same = bool(torch.equal(KN.nms_keep(boxes, valid, iou),
                                 KN.nms_keep_plain(boxes, valid, iou)))

    # report only: the int8 mode against the float mode, same weights; the
    # golden head squeezes the raw maps, so the backbone's exit (l7, the
    # region's float output) is compared too
    float_layers = float_conv_layers(torch, m, x) if neck else None
    q8 = m.net.q8
    m.net.set_q8(None)
    exit_f = {}
    feats = (7, 29, 45, 61) if neck else (7,)
    hooks = [m.net.model[i].register_forward_hook(
        lambda _m, _a, out, i=i: exit_f.setdefault(i, out)) for i in feats]
    try:
        maps_f = m.apply(x)
    finally:
        for h in hooks:
            h.remove()
        m.net.set_q8(q8)

    def vs(e8, ef):
        e8 = e8.to_float() if isinstance(e8, Q8Map) else e8
        return {"max_abs_diff": float((e8 - ef).abs().max()),
                "float_absmax": float(ef.abs().max()),
                "rel_l2": float((e8 - ef).norm() / ef.norm()),
                "cosine": float(torch.nn.functional.cosine_similarity(
                    e8.flatten(), ef.flatten(), dim=0))}

    pred_f, top_f = decode(maps_f)
    det = {f"{mode}_conf{c}": non_max_suppression(
        t, c, iou, presorted=True).count.tolist()
        for mode, t in (("int8", top_k), ("float", top_f))
        for c in (conf, 0.25)}
    vs_float = {
        **{("backbone_exit_l7" if i == 7 else f"feature_l{i}"):
           vs(seen_k[i], exit_f[i]) for i in feats},
        "raw_map_max_abs_diff": [float((a - b).abs().max())
                                 for a, b in zip(maps_k, maps_f)],
        "raw_map_mean_abs_diff": [float((a - b).abs().mean())
                                  for a, b in zip(maps_k, maps_f)],
        "raw_map_absmax_float": [float(b.abs().max()) for b in maps_f],
        "decoded_box_max_abs_diff_px": float(
            (pred_k[..., :4] - pred_f[..., :4]).abs().max()),
        "decoded_obj_max_abs_diff": float(
            (pred_k[..., 4] - pred_f[..., 4]).abs().max()),
        "detections": det}
    expect = {0: "region entry", 2: "MP fused", 4: "MP fused",
              6: "in-region flat int8 pool"}
    if neck:
        expect.update({9: "neck entry quantize; in-region SPPCSPC -> int8",
                       33: "in-region GSConv -> int8",
                       34: "in-region concat (unmaterialized)",
                       46: "in-region flat int8 pool (neck)",
                       64: "in-region RepConv -> int8"})
    plan_ok = all(plan.get(i, "").startswith(v) for i, v in expect.items())
    plan_ok &= "NHWC bf16 out" in plan.get(7, "")
    islands = sorted(sp.i for sp in m.cfg.layers
                     if sp.name in ("CA", "CCVA", "ADD"))
    out = {"phase": "int8_neck_e2e" if neck else "int8_e2e", "batch": 2,
           "size": SIZE, "n_scales": len(scales), "region_plan": plan,
           "launches_per_forward": {k: counts[k] for k in want},
           "region_vs_plain": region, "raw_map_max_abs_err": map_err,
           "decoded_box_max_abs_err_px": box_err,
           "nms_keep_identical": keep_same, "int8_vs_float": vs_float}
    ok = box_err <= 1e-2 and keep_same and plan_ok
    if neck:
        out["float_conv_layers"] = float_layers
        out["attention_island_layers"] = islands
        ok &= set(float_layers) <= set(islands)
    out["ok"] = ok
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"int8 end-to-end check failed: {out}")


def phase_serving(torch, dev, fast=None, neck=True, der_fast=None):
    """serve.py's HTTP server on the engine (float, or ``fast="int8"``,
    with the neck or, ``neck=False``, the backbone region alone; or, with
    ``der_fast="bf16"``, the bfloat16 model with the DER blocks on K10 /
    K11): 3 requests, the launch counts of that run, responses equal to
    direct engine calls."""
    import numpy as np

    from rep_yolo_tpu_torch.data.letterbox import letterbox_batch
    from rep_yolo_tpu_torch.models.region import Q8Region
    from rep_yolo_tpu_torch.ops.kernels import launch_counts, \
        reset_launch_counts
    from rep_yolo_tpu_torch.serve import build_engine, make_server

    size, max_batch = SIZE, 4
    t0 = time.perf_counter()
    engine = build_engine(CFG, str(GOLDEN / "model_weights.npz"), size,
                          max_batch, conf=0.001, iou=0.45, device=dev,
                          fast=fast, der_fast=der_fast,
                          dtype=torch.bfloat16 if der_fast else torch.float32)
    if fast == "int8" and not neck:
        net = engine.model.net
        net.set_q8(Q8Region(net.q8.scales, neck=False))
        engine(np.zeros((max_batch, size, size, 3), np.float32))
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(2)
    requests = []
    for b in (1, 2, 4):
        hw = rng.integers(200, 1000, (b, 2))
        canvas = np.full((b, 1000, 1000, 3), 114, np.uint8)
        for i, (h, w) in enumerate(hw):
            canvas[i, :h, :w] = rng.integers(0, 255, (h, w, 3))
        imgs, _, _ = letterbox_batch(torch.from_numpy(canvas).to(dev),
                                     torch.from_numpy(hw).to(dev), size)
        requests.append(imgs.cpu().numpy().astype(np.float32))

    srv = make_server(engine, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        health = json.loads(urllib.request.urlopen(url + "/v1/health",
                                                   timeout=60).read())
        torch.cuda.synchronize()
        reset_launch_counts()
        responses = []
        for imgs in requests:
            req = urllib.request.Request(
                url + "/v1/infer", data=imgs.tobytes(), method="POST",
                headers={"X-Shape": ",".join(map(str, imgs.shape))})
            responses.append(json.loads(urllib.request.urlopen(
                req, timeout=300).read()))
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    n_fwd = len(requests)
    q8 = {} if fast != "int8" else \
        Q8_PER_FORWARD if neck else Q8_BACKBONE_PER_FORWARD
    cm = CM_PER_FORWARD if der_fast else {}
    want = {"axial_project": 12 * n_fwd, "axial_attend_criss_cross": 6 * n_fwd,
            "axial_attend_vertical": 6 * n_fwd, "nms_keep": n_fwd,
            **{k: q8.get(k, 0) * n_fwd for k in Q8_KERNELS},
            **{k: cm.get(k, 0) * n_fwd for k in CM_PER_FORWARD},
            "wgrad3x3": 0}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    dets = []
    for imgs, resp in zip(requests, responses):
        if "detections" not in resp:
            raise AssertionError(f"server error: {resp}")
        direct = engine(imgs)
        for got, ref in zip(resp["detections"], direct):
            if len(got) != len(ref) or (len(ref) and not np.allclose(
                    np.asarray(got), np.asarray(ref), rtol=0, atol=1e-5)):
                raise AssertionError("served detections differ from the "
                                     "direct engine call")
        dets.append([len(d) for d in resp["detections"]])

    batch4 = requests[2]
    x = torch.from_numpy(batch4).to(dev)
    e2e_ms = served_ms(torch, engine, batch4)
    fwd_x = x.to(engine.dtype)
    fwd_ms = cuda_ms(lambda: engine.infer(fwd_x), runs=10)
    emit({"phase": "serving_bf16" if der_fast else "serving" if fast is None
          else f"serving_{fast}" + ("" if neck else "_backbone"),
          "ok": True, "health": health,
          "build_engine_s": round(build_s, 3), "batches": [1, 2, 4],
          "detections_per_image": dets,
          "server_ms": [r["ms"] for r in responses],
          "launch_counts": counts, "forwards": n_fwd,
          "served_batch4_host_ms_median": e2e_ms,
          "infer_batch4_cuda_ms_median": fwd_ms})
    return counts, e2e_ms, engine, x


def served_ms(torch, engine, batch) -> float:
    """Host ms of one served batch: median of 10 after 3 warm-ups."""
    e2e = []
    for _ in range(13):
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine(batch)
        torch.cuda.synchronize()
        e2e.append((time.perf_counter() - t) * 1e3)
    return statistics.median(e2e[3:])


def _category(name: str) -> str:
    low = name.lower()
    if "axial_project" in low or "axial_attend" in low:
        return "attention kernels (K1, K2)"
    if "conv3x3_q8" in low or "conv1x1_q8" in low:
        return "int8 conv kernels (K4, K5)"
    if "max_pool2_q8" in low:
        return "int8 pool kernel (K6)"
    if "dwconv5x5_q8" in low:
        return "int8 depthwise kernel (K7)"
    if "spp_pools_q8" in low:
        return "int8 SPP pyramid kernel (K8)"
    if any(s in low for s in ("conv3x3_bf16", "conv1x1_bf16",
                              "conv3x3_f32_kernel", "conv1x1_f32_kernel")):
        return "channel-major conv kernels (K10, K11)"
    if "nms_mask" in low or "nms_scan" in low:
        return "nms kernel (K3)"
    if any(s in low for s in ("conv", "xmma", "cudnn", "fprop", "winograd",
                              "implicit_gemm", "cutlass", "gemm", "sm90_")):
        return "convolutions (cuDNN)"
    if "topk" in low or "sort" in low or "radix" in low:
        return "top-k / sort"
    if "copy" in low or "memcpy" in low or "memset" in low:
        return "copies"
    return "elementwise / other"


def profiled(torch, fn, reps: int, counts: bool = False):
    """Run ``fn`` ``reps`` times under torch.profiler: (host wall ms per
    run, {kernel name: device ms per run}, device events recorded; with
    ``counts``, {kernel name: events recorded})."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / reps
    names: dict[str, float] = {}
    events, per_name = 0, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            names[e.key] = names.get(e.key, 0.0) + us / 1e3 / reps
            events += e.count
            per_name[e.key] = per_name.get(e.key, 0) + e.count
    return wall, names, per_name if counts else events


def profiled_whole(torch, fn, reps: int, tries: int = 5,
                   per_name: bool = False):
    """``profiled`` until a window holds a non-zero whole multiple of
    ``reps`` device events (``fn`` launches the same kernels each call);
    with ``per_name``, of each kernel name's events. The profiler now and
    then drops some or all of a window's events (about one window in a
    hundred on the card, a one-call window among them), so such a window is
    measured again."""
    for _ in range(tries):
        wall, names, events = profiled(torch, fn, reps, counts=per_name)
        whole = (all(n % reps == 0 for n in events.values()) if per_name
                 else events % reps == 0)
        if events and whole:
            return wall, names, events
    raise AssertionError(f"the profiler recorded {events} device events "
                         f"for {reps} calls in each of {tries} tries")


FLUSH_BYTES = 256 << 20     # > 5x the H100's 50 MB L2
_FLUSH: dict = {}


def l2_flush(torch):
    """(fn, kernel names): ``fn`` evicts the card's L2 by rewriting a
    FLUSH_BYTES buffer in place; the names are the kernels it launches,
    which ``device_ms`` leaves out of its sums."""
    if not _FLUSH:
        buf = torch.zeros(FLUSH_BYTES // 8, dtype=torch.int64, device="cuda")
        fn = buf.bitwise_not_
        fn()
        _, names, _ = profiled_whole(torch, fn, 4)
        _FLUSH.update(fn=fn, names=set(names))
    return _FLUSH["fn"], _FLUSH["names"]


def device_ms(torch, fn, reps: int = 10, warmup: int = 3,
              whole: bool = True) -> float:
    """Device ms per call of ``fn`` from a cold L2 (each call follows an
    ``l2_flush``, so its inputs come from HBM as in a served forward): the
    sum of its kernels' device times under the profiler, without the
    host's launch gaps between them or the flush, in a window where every
    kernel's events (the flush's too) are whole for all ``reps`` calls: a
    window that lost as many flush events as kernel events would still hold
    a whole multiple in all. ``whole=False`` is for a ``fn`` whose library
    calls launch a varying number of kernels: the median of three windows,
    none of them checked for dropped events."""
    flush, skip = l2_flush(torch)

    def call():
        flush()
        fn()

    for _ in range(warmup):
        call()
    if not whole:
        return statistics.median(
            sum(ms for k, ms in profiled(torch, call, reps)[1].items()
                if k not in skip) for _ in range(3))
    _, names, _ = profiled_whole(torch, call, reps, per_name=True)
    return sum(ms for k, ms in names.items() if k not in skip)


def _profile_once(torch, engine, x, reps, whole=True):
    """(wall ms, device ms by category, device ms by kernel) per served
    batch; ``whole=False`` takes the first window as it comes (at batch
    128 the windows hold a few device events more than a whole multiple of
    the calls)."""
    x = x.to(engine.dtype)
    engine.infer(x)
    wall, names, _ = (profiled_whole(torch, lambda: engine.infer(x), reps)
                      if whole else profiled(torch, lambda: engine.infer(x),
                                             reps))
    cats: dict[str, float] = {}
    for name, ms in names.items():
        c = _category(name)
        cats[c] = cats.get(c, 0.0) + ms
    return wall, cats, names


def phase_profile(torch, engines, x, reps: int = 5):
    """Device time by kernel category over `reps` served batches and the
    device's busy share of the wall time, for each engine ({mode: engine}),
    in turns: each engine, then the same in reverse."""
    modes = list(engines)
    runs = {m: [] for m in modes}
    for m in modes + modes[::-1]:
        runs[m].append(_profile_once(torch, engines[m], x, reps))
    for mode in modes:
        wall = [r[0] for r in runs[mode]]
        dev = [sum(r[1].values()) for r in runs[mode]]
        cats: dict[str, float] = {}
        names: dict[str, float] = {}
        for r in runs[mode]:
            for c, ms in r[1].items():
                cats[c] = cats.get(c, 0.0) + ms / len(runs[mode])
            for n, ms in r[2].items():
                names[n] = names.get(n, 0.0) + ms / len(runs[mode])
        measured = min(dev) > 0
        emit({"phase": "profile", "mode": mode, "ok": True,
              "batch": int(x.shape[0]), "reps": reps,
              "wall_ms_per_batch": wall,
              "device_ms_per_batch": dev if measured else "not measured",
              "device_busy_share": [d / w for d, w in zip(dev, wall)]
              if measured else "not measured",
              "by_category_ms": dict(sorted(cats.items(),
                                            key=lambda kv: -kv[1])),
              "top_kernels_ms": [[k[:90], v] for k, v in sorted(
                  names.items(), key=lambda kv: -kv[1])[:10]]})


def kernel_times(torch, kfn, pfn, lib=None) -> dict:
    """One kernel call's times at one shape: ``ms`` its device time (the
    profiler), ``event_ms`` the back-to-back CUDA-event time (which also
    holds the host's launch latency where that exceeds the kernel),
    ``plain_ms`` and ``library_ms`` device times of the plain version and
    of the library call."""
    return {"ms": device_ms(torch, kfn), "event_ms": cuda_ms(kfn),
            "plain_ms": device_ms(torch, pfn),
            "library_ms": None if lib is None else device_ms(torch, lib)}


TIME_KEYS = ("ms", "event_ms", "plain_ms", "library_ms", "bound_ms")


def add_times(agg: dict, t: dict, n: int = 1) -> None:
    """Add n calls' times (and bytes, ops) of one shape to a per-forward
    sum; a library time missing at any shape leaves the sum None."""
    for k in TIME_KEYS + ("bytes", "ops"):
        if k not in agg:
            agg[k] = 0.0
        agg[k] = None if agg[k] is None or t[k] is None else \
            agg[k] + n * t[k]


def kernel_row(name, source, replaces, launches, err, agg, peak) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": agg["ms"], "plain_ms": agg["plain_ms"],
            "bound_ms": agg["bound_ms"],
            "bound_by": bound(agg["bytes"], agg["ops"], peak)[1],
            "library_ms": agg["library_ms"], "event_ms": agg["event_ms"]}


def phase_times(torch, dev, counts, errs):
    from rep_yolo_tpu_torch.ops.kernels import axial_attention as KA
    from rep_yolo_tpu_torch.ops.kernels import nms as KN
    from rep_yolo_tpu_torch.ops.kernels import reset_launch_counts

    batch = 4
    agg = {n: {} for n in ("axial_project", "axial_attend_criss_cross",
                           "axial_attend_vertical", "nms_keep")}
    per_shape = []
    for i, (c, h, w) in enumerate(ATTN_SHAPES):
        x, wqk, pq, pv, gamma = attention_inputs(c, h, w, batch, 10 + i,
                                                 0.7, dev)
        q, k, v = KA.project(x, wqk, pq, pv)
        for cc in (True, False):
            name = "axial_attend_" + ("criss_cross" if cc else "vertical")
            (b1, f1), (b2, f2) = attention_cost(c, h, w, batch, cc)
            t = kernel_times(torch, lambda: KA.attend(q, k, v, x, gamma, cc),
                             lambda: KA.attend_plain(q, k, v, x, gamma, cc))
            t.update(zip(("bound_ms", "bound_by"), bound(b2, f2)),
                     bytes=b2, ops=f2)
            add_times(agg[name], t)
            per_shape.append({"kernel": name, "shape": [batch, h, w, c], **t})
        # the projection runs once per block, twice per CCVA
        t = kernel_times(torch, lambda: KA.project(x, wqk, pq, pv),
                         lambda: KA.project_plain(x, wqk, pq, pv))
        t.update(zip(("bound_ms", "bound_by"), bound(b1, f1)),
                 bytes=b1, ops=f1)
        add_times(agg["axial_project"], t, 2)
        per_shape.append({"kernel": "axial_project",
                          "shape": [batch, h, w, c], **t})

    import numpy as np

    rng = np.random.default_rng(3)
    K = 1024
    c = rng.uniform(0, 640, (batch, K, 2))
    wh = rng.uniform(10, 60, (batch, K, 2))
    boxes = torch.as_tensor(np.concatenate([c - wh / 2, c + wh / 2], -1),
                            dtype=torch.float32, device=dev)
    valid = torch.ones((batch, K), dtype=torch.bool, device=dev)
    t = kernel_times(torch, lambda: KN.nms_keep(boxes, valid, 0.45),
                     lambda: KN.nms_keep_plain(boxes, valid, 0.45))
    nb, nf = batch * K * (16 + 1 + 1), batch * K * (K - 1) / 2 * 12
    t.update(zip(("bound_ms", "bound_by"), bound(nb, nf)), bytes=nb, ops=nf)
    add_times(agg["nms_keep"], t)
    reset_launch_counts()

    src_attn = "rep_yolo_tpu_torch/csrc/axial_attention.cu"
    kernels = []
    for name, src, replaces in (
            ("axial_project", src_attn,
             "rep_yolo_tpu/ops/pallas/axial_attention.py:263"),
            ("axial_attend_criss_cross", src_attn,
             "rep_yolo_tpu/ops/pallas/axial_attention.py:263"),
            ("axial_attend_vertical", src_attn,
             "rep_yolo_tpu/ops/pallas/axial_attention.py:285"),
            ("nms_keep", "rep_yolo_tpu_torch/csrc/nms.cu",
             "rep_yolo_tpu/ops/pallas/nms_kernel.py:97")):
        kernels.append(kernel_row(name, src, replaces, counts[name],
                                  errs[name], agg[name], F32_PEAK))
    emit({"phase": "times", "ok": True, "batch": batch,
          "note": f"attention rows sum the six {SIZE}-px CCVA shapes of one "
                  "served batch (the projection twice per CCVA); nms_keep "
                  "at K=1024, batch 4; ms, plain_ms: device time under the "
                  "profiler from a cold L2, 10 calls after 3 warm-ups; "
                  "event_ms: CUDA events, median of 20 runs of 10 "
                  "back-to-back calls (L2-warm)",
          "per_shape": per_shape})
    return kernels


def phase_times_q8(torch, dev, counts, errs, calls):
    """K4-K6 per backbone shape (batch 4, random weights and maps) and
    K4-K8 per distinct int8 call of layers NECK_FIRST.. of one served
    forward (``calls``, its real inputs): kernel, plain version, bound and
    the PyTorch yardstick of the same shape. The kernels line's rows sum one
    forward (each shape times its calls per forward), backbone and neck."""
    from rep_yolo_tpu_torch.ops.kernels import reset_launch_counts

    agg = {n: {} for n in Q8_KERNELS}
    per_shape = []
    for i, row in enumerate(backbone_q8_shapes()):
        kfn, pfn, lib, _, nbytes, ops = q8_case(torch, row, 4, dev, 200 + i)
        t = kernel_times(torch, kfn, pfn, lib)
        t.update(zip(("bound_ms", "bound_by"), bound(nbytes, ops, INT8_PEAK)),
                 bytes=nbytes, ops=ops)
        add_times(agg[row[1]], t, row[-1])
        per_shape.append({"shape": row[0], "kernel": row[1],
                          "calls_per_forward": row[-1], **t})
    # the neck: each distinct call once, then summed per forward and layer
    timed: dict = {}
    by_layer: dict = {}
    for layer, name, args in calls:
        if layer < NECK_FIRST:
            continue
        kfn, pfn, lib, _, nbytes, ops, sig = call_case(torch, name, args)
        if sig not in timed:
            t = kernel_times(torch, kfn, pfn, lib)
            t.update(zip(("bound_ms", "bound_by"),
                         bound(nbytes, ops, INT8_PEAK)),
                     bytes=nbytes, ops=ops)
            timed[sig] = {"kernel": name, "signature": str(sig[1:]),
                          "calls_per_forward": 0, **t}
        row = timed[sig]
        row["calls_per_forward"] += 1
        add_times(agg[name], row)
        add_times(by_layer.setdefault((layer, name), {}), row)
    reset_launch_counts()
    kernels = []
    for name, src, replaces in (
            ("conv3x3_q8", "conv_flat", "conv_flat.py:353"),
            ("conv1x1_q8", "conv_flat", "conv_flat.py:719"),
            ("max_pool2_q8", "pool_flat", "pool_flat.py:80"),
            ("dwconv5x5_q8", "neck_flat", "conv_flat.py:548"),
            ("spp_pools_q8", "neck_flat", "neck_flat.py:429")):
        row = kernel_row(
            name, f"rep_yolo_tpu_torch/csrc/{src}.cu",
            f"rep_yolo_tpu/ops/pallas/{replaces}", counts[name], errs[name],
            agg[name], INT8_PEAK)
        if name == "spp_pools_q8":
            row["library_call"] = ("a sequence: three F.max_pool2d and a "
                                   "torch.cat on the f32 map")
        kernels.append(row)
    layers = [{"layer": layer, "kernel": name,
               **{k: v for k, v in t.items() if k != "bound_by"}}
              for (layer, name), t in sorted(by_layer.items())]
    emit({"phase": "times_q8", "ok": True, "batch": 4,
          "note": f"rows sum one {SIZE}-px forward (each shape times its "
                  "calls per forward): the backbone's shapes on random "
                  "weights and maps, the neck's calls on the served "
                  "forward's own; library_ms = the f32 cuDNN conv (TF32 "
                  "off) of the same shape, for K7 the f32 depthwise conv, "
                  "for K6 one amax over the (B, H/2, 2, W/2, 2, C) view, for "
                  "K8 three F.max_pool2d and a torch.cat (a sequence, not "
                  "one call); ms, plain_ms, library_ms: device time under "
                  "the profiler from a cold L2, 10 calls after 3 warm-ups; "
                  "event_ms: CUDA events, median of 20 runs of 10 "
                  "back-to-back calls (L2-warm)",
          "per_shape": per_shape, "neck_calls": list(timed.values()),
          "neck_by_layer": layers})
    return kernels


def phase_kernels_neck(torch, engine, x, errs):
    """Every int8 kernel call of layers NECK_FIRST.. in one served forward
    (the engine's real maps and weights, batch 4) against its plain version
    on the same inputs. Returns the recorded calls."""
    _, calls = record_q8_calls(engine.model, x)
    torch.cuda.synchronize()
    rows, seen = [], set()
    for layer, name, args in calls:
        if layer < NECK_FIRST:
            continue
        kfn, pfn, _, out_s, _, _, sig = call_case(torch, name, args)
        got, ref = kfn(), pfn()
        torch.cuda.synchronize()
        err, off1, off_more = q8_diff(torch, got, ref, out_s)
        n = got.numel()
        if got.dtype == torch.int8:
            ok = off_more == 0 and off1 <= 1e-4 * n
            if name in ("max_pool2_q8", "spp_pools_q8"):
                ok = off1 == 0
        else:
            ok = bool(torch.allclose(got, ref, atol=1e-5, rtol=1e-5))
        r = {"layer": layer, "kernel": name, "signature": str(sig[1:]),
             "out": list(got.shape), "dtype": str(got.dtype),
             "max_abs_err": err, "lsb_off_by_1": off1,
             "lsb_off_by_more": off_more}
        rows.append(r)
        if not ok:
            raise AssertionError(f"{name} differs from its plain version: "
                                 f"{r}")
        errs[name] = max(errs.get(name, 0.0), err)
        seen.add(name)
    # the cases this slice brings: stride 2 on int8, 3 sections, f32 out
    need = {
        "K4 stride 2 int8": any(n == "conv3x3_q8" and a["stride"] == 2
                                and a["x"].dtype == torch.int8
                                for i, n, a in calls if i >= NECK_FIRST),
        "K5 3 sections": any(n == "conv1x1_q8" and isinstance(a["xs"], list)
                             and len(a["xs"]) == 3
                             for i, n, a in calls if i >= NECK_FIRST),
        "K5 f32 out": any(n == "conv1x1_q8" and a["out_scale"] is None
                          for i, n, a in calls if i >= NECK_FIRST),
        "K7, K8": {"dwconv5x5_q8", "spp_pools_q8"} <= seen}
    if not all(need.values()):
        raise AssertionError(f"the neck's calls lack a case: {need}")
    emit({"phase": "kernels_neck_vs_plain", "ok": True, "batch": 4,
          "calls": len(rows), "cases": need,
          "tolerance": "int8 identical but for +-1 LSB on <= 1e-4 of the "
                       "elements; f32 out atol = rtol = 1e-5; pools (K6, "
                       "K8) identical", "rows": rows})
    return calls


def phase_served_ab(torch, engines, batch):
    """One served batch of 4 for each engine, in turns (each, then the
    same in reverse): host ms median of 10 after 3 warm-ups."""
    modes = list(engines)
    out = {m: [] for m in modes}
    for m in modes + modes[::-1]:
        out[m].append(served_ms(torch, engines[m], batch))
    emit({"phase": "served_ab", "ok": True, "turns": modes + modes[::-1],
          "served_batch4_host_ms": out})
    return out


# ---------------------------------------------------------------------------
# bfloat16 serving: K10 / K11 (the DER blocks' "bf16" path)
# ---------------------------------------------------------------------------

# launches of one bfloat16 forward with der_fast, at any size: the four DER
# blocks' six 3x3 stages and seven 1x1 convs each
CM_PER_FORWARD = {"conv3x3_cmajor": 24, "conv1x1_cmajor": 28}
CM_TOL = ("float32 atol = rtol = 1e-4; bfloat16 at most one bfloat16 ulp "
          "(of the larger magnitude) from the plain version, or within "
          "1e-3 max|plain| near zero")
# per head level of the bfloat16 network: max |a - b| / max |b| and the
# correlation (the JAX package's bound for its bf16 DER chain, with the
# tiny network's correlation; tests/test_torch_bf16_slice.py)
E2E_REL, E2E_CORR = 2e-2, 0.999
THROUGHPUT_BATCHES = (128, 32)     # bench.py's operating points


def der_cm_shapes():
    """The DER convs of one SIZE-px forward, one row per distinct shape:
    (name, k, input channels per section, output channels, size, calls
    per forward). DER l1 (48 -> 48 at 320), l3 (48 -> 128 at 160), l5
    (128 -> 256 at 80), l7 (256 -> 512 at 40)."""
    rows = []
    for layer, c1, c2, hw in ((1, 48, 48, SIZE // 2), (3, 48, 128, SIZE // 4),
                              (5, 128, 256, SIZE // 8),
                              (7, 256, 512, SIZE // 16)):
        half = c1 // 2
        rows += [(f"l{layer} st1-st3", 3, (c1,), c1, hw, 3),
                 (f"l{layer} st4-st6", 3, (half,), half, hw, 3),
                 (f"l{layer} cv*_1", 1, (c1,), half, hw, 3),
                 (f"l{layer} cv*_2", 1, (half,), c1, hw, 3),
                 (f"l{layer} cv1", 1, (c1, c1, c1), c2, hw, 1)]
    return rows


def cm_case(torch, row, batch, dev, seed, dtype):
    """One DER conv shape in ``dtype``: (kernel name, kernel fn, plain fn,
    library fn, bytes, FLOPs). Random weights at 1/sqrt(fan_in) and inputs
    N(0, 1); the library call is the cuDNN conv of the same dtype with the
    bias, then SiLU (for K11 after a torch.cat of the sections)."""
    import torch.nn.functional as F

    from rep_yolo_tpu_torch.ops.kernels import conv_kernel as KCM

    _, k, cins, cout, hw, _ = row
    g = torch.Generator(device=dev).manual_seed(seed)
    cin = sum(cins)
    w = (torch.randn((cout, cin, k, k), generator=g, device=dev)
         / (cin * k * k) ** 0.5).to(dtype)
    b = (0.1 * torch.randn((cout,), generator=g, device=dev)).to(dtype)
    cw = KCM.CMConv(w, b)
    xs = [torch.randn((batch, c, hw, hw), generator=g, device=dev).to(dtype)
          for c in cins]
    if k == 3:
        name, x = "conv3x3_cmajor", xs[0]
        kfn = lambda: KCM.conv3x3_cmajor(x, cw)                 # noqa: E731
        pfn = lambda: KCM.conv3x3_cmajor_plain(x, cw)           # noqa: E731
        lib = lambda: F.silu(F.conv2d(x, w, b, padding=1))      # noqa: E731
    else:
        name = "conv1x1_cmajor"
        kfn = lambda: KCM.conv1x1_cmajor(xs, cw)                # noqa: E731
        pfn = lambda: KCM.conv1x1_cmajor_plain(xs, cw)          # noqa: E731
        lib = lambda: F.silu(F.conv2d(                          # noqa: E731
            torch.cat(xs, 1) if len(xs) > 1 else xs[0], w, b))
    es = 2 if dtype == torch.bfloat16 else 4
    npix = batch * hw * hw
    nbytes = es * (npix * (cin + cout) + cout * cin * k * k) + 4 * cout
    return name, kfn, pfn, lib, nbytes, 2.0 * npix * cout * cin * k * k


def cm_diff(torch, got, ref):
    """(max abs err, elements beyond CM_TOL) of a K10 / K11 output."""
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(torch.maximum(g.abs(), r.abs()))
        ulp = torch.ldexp(torch.ones_like(g), e - 8)       # 8 significant bits
        bad = (d > ulp) & (d > 1e-3 * r.abs().max())
    else:
        bad = d > 1e-4 + 1e-4 * r.abs()
    return float(d.max()), int(bad.sum())


def phase_kernels_cm(torch, dev, errs):
    """K10 and K11 against their plain versions at the 20 distinct DER conv
    shapes of a SIZE-px forward, batch 2, in bfloat16 and float32 (the cv1
    rows are K11 calls over three sections)."""
    rows = []
    for i, row in enumerate(der_cm_shapes()):
        for dtype in (torch.bfloat16, torch.float32):
            name, kfn, pfn, *_ = cm_case(torch, row, 2, dev, 400 + i, dtype)
            got, ref = kfn(), pfn()
            torch.cuda.synchronize()
            err, bad = cm_diff(torch, got, ref)
            r = {"shape": row[0], "kernel": name, "sections": len(row[2]),
                 "out": list(got.shape), "dtype": str(dtype),
                 "max_abs_err": err, "plain_absmax": float(ref.abs().max()),
                 "beyond_tolerance": bad}
            rows.append(r)
            if bad or got.dtype != dtype:
                raise AssertionError(f"{name} differs from its plain "
                                     f"version: {r}")
            if dtype == torch.bfloat16:
                errs[name] = max(errs.get(name, 0.0), err)
    emit({"phase": "kernels_cm", "ok": True, "batch": 2, "tolerance": CM_TOL,
          "shapes": rows})


def rel_corr(a, b):
    """(max |a - b| / max |b|, correlation) of two maps, in float32."""
    import numpy as np

    u, v = a.float().flatten().cpu().numpy(), b.float().flatten().cpu().numpy()
    return (float(np.abs(u - v).max() / np.abs(v).max()),
            float(np.corrcoef(u, v)[0, 1]))


def phase_bf16_e2e(torch, dev, batch=4):
    """Golden weights, fused and cast to bfloat16, at SIZE px: the network
    with der_fast (K10 / K11) against the same with the DER blocks on
    cuDNN bfloat16 (raw maps per level within E2E_REL / E2E_CORR), the
    launches of one forward and its NMS, K3 against its plain version on the
    der_fast path's candidates, and, as a report, the bfloat16 model against
    the float32 one and the two paths' detections."""
    import numpy as np

    from rep_yolo_tpu_torch.models import heads
    from rep_yolo_tpu_torch.models.model import RepYOLO
    from rep_yolo_tpu_torch.ops.boxes import xywh2xyxy
    from rep_yolo_tpu_torch.ops.kernels import launch_counts, \
        reset_launch_counts
    from rep_yolo_tpu_torch.ops.kernels import nms as KN
    from rep_yolo_tpu_torch.ops.nms import non_max_suppression
    from rep_yolo_tpu_torch.utils.weights import load_reference_npz

    m = RepYOLO.from_config(CFG, device=dev).load_state(
        load_reference_npz(GOLDEN / "model_weights.npz")).fuse()
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (batch, SIZE, SIZE, 3)).astype(np.float32)).to(dev)
    maps_f32 = m.apply(x)
    m.cast(torch.bfloat16)
    xb = x.bfloat16()
    conf, iou, nl = 0.001, 0.45, m.cfg.nl

    def run():
        maps = m.apply(xb)
        top = heads.decode_topk(maps[:nl], m.anchors_px, m.strides, k=1024,
                                conf_thres=conf)
        return maps, top, non_max_suppression(top, conf, iou, presorted=True)

    m.net.set_der_fast("bf16")
    run()                                       # packs the DER weights
    torch.cuda.synchronize()
    reset_launch_counts()
    maps_k, top_k, det_k = run()
    torch.cuda.synchronize()
    counts = launch_counts()
    m.net.set_der_fast(None)
    maps_c, top_c, det_c = run()
    want = {**CM_PER_FORWARD, "axial_project": 12,
            "axial_attend_criss_cross": 6, "axial_attend_vertical": 6,
            "nms_keep": 1}
    seen = {k: counts[k] for k in want}
    levels = [rel_corr(a, b) for a, b in zip(maps_k, maps_c)]
    boxes = xywh2xyxy(top_k[..., :4])
    valid = top_k[..., 4] > conf
    keep_same = bool(torch.equal(KN.nms_keep(boxes, valid, iou),
                                 KN.nms_keep_plain(boxes, valid, iou)))
    same_dets = [bool(torch.equal(det_k.boxes[i][det_k.valid[i]],
                                  det_c.boxes[i][det_c.valid[i]]))
                 for i in range(batch)]
    out = {"phase": "bf16_e2e", "batch": batch, "size": SIZE,
           "launches_per_forward": seen,
           "der_fast_vs_cudnn_bf16": {
               "rel_max_err_per_level": [r for r, _ in levels],
               "corr_per_level": [c for _, c in levels],
               "tolerance": {"rel": E2E_REL, "corr": E2E_CORR},
               "detections_der_fast": det_k.count.tolist(),
               "detections_cudnn": det_c.count.tolist(),
               "detections_identical_per_image": same_dets},
           "nms_keep_identical": keep_same,
           "valid_candidates": valid.sum(1).tolist(),
           "bf16_vs_f32_rel_max_err_per_level": [
               rel_corr(a, b)[0] for a, b in zip(maps_k, maps_f32)],
           "raw_map_dtype": str(maps_k[0].dtype)}
    ok = (seen == want and keep_same and maps_k[0].dtype == torch.bfloat16
          and all(r < E2E_REL and c > E2E_CORR for r, c in levels))
    out["ok"] = ok
    emit(out)
    if not ok:
        raise AssertionError(f"bf16 end-to-end check failed: {out}")


def phase_throughput_bf16(torch, dev, reps: int = 5):
    """The bfloat16 engine at bench.py's operating points (batch 128 and
    32, SIZE px), with and without der_fast, in turns (each mode, then the
    same in reverse): img/s over ``reps`` host-timed batches, device ms by
    category and busy share under the profiler, peak memory. First, at
    batch 128 (no other phase runs it): K1 / K2 against their plain
    versions at the six CCVA shapes, the engine's raw maps on 32 copies of
    4 images (each copy against the first, E2E_REL / E2E_CORR), and K3
    against its plain version on the engine's own candidates."""
    from rep_yolo_tpu_torch.models import heads
    from rep_yolo_tpu_torch.ops.boxes import xywh2xyxy
    from rep_yolo_tpu_torch.ops.kernels import axial_attention as KA
    from rep_yolo_tpu_torch.ops.kernels import nms as KN
    from rep_yolo_tpu_torch.serve import build_engine

    big = max(THROUGHPUT_BATCHES)
    attn = []
    for i, (c, h, w) in enumerate(ATTN_SHAPES):
        x, wqk, pq, pv, gamma = attention_inputs(c, h, w, big, 20 + i, 0.7,
                                                 dev)
        for cc in (True, False):
            y = KA.axial_attention(x, wqk, pq, pv, gamma, cc)
            yp = KA.axial_attention_plain(x, wqk, pq, pv, gamma, cc)
            torch.testing.assert_close(y, yp, atol=1e-4, rtol=1e-4)
            attn.append({"shape": [big, h, w, c], "criss_cross": cc,
                         "max_abs_err": float((y - yp).abs().max())})
        del x, y, yp
    engine = build_engine(CFG, str(GOLDEN / "model_weights.npz"), SIZE, big,
                          conf=0.001, iou=0.45, device=dev,
                          dtype=torch.bfloat16, der_fast="bf16")
    m = engine.model
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.rand((4, SIZE, SIZE, 3), generator=g, device=dev).to(
        torch.bfloat16).repeat(big // 4, 1, 1, 1)
    maps = m.apply(x)
    copies = []
    for mp in maps:
        v = mp.reshape(big // 4, 4, *mp.shape[1:])
        copies.append([rel_corr(v[j], v[0]) for j in range(1, big // 4)])
    exact = all(torch.equal(mp.reshape(big // 4, 4, -1)[j],
                            mp.reshape(big // 4, 4, -1)[0])
                for mp in maps for j in range(1, big // 4))
    top = heads.decode_topk(maps[:m.cfg.nl], m.anchors_px, m.strides,
                            k=1024, conf_thres=engine.conf)
    boxes, valid = xywh2xyxy(top[..., :4]), top[..., 4] > engine.conf
    keep_same = bool(torch.equal(KN.nms_keep(boxes, valid, engine.iou),
                                 KN.nms_keep_plain(boxes, valid, engine.iou)))
    worst = max((r for lv in copies for r, _ in lv), default=0.0)
    low_corr = min((c for lv in copies for _, c in lv), default=1.0)
    check = {"attention_vs_plain": attn, "copies_rel_max_err": worst,
             "copies_min_corr": low_corr, "copies_bit_identical": exact,
             "nms_keep_identical": keep_same}
    if not (keep_same and worst < E2E_REL and low_corr > E2E_CORR):
        raise AssertionError(f"batch {big} check failed: {check}")
    del maps, top, boxes, valid

    runs: dict = {}
    modes = ("bf16", "bf16_der_fast")
    for mode in modes + modes[::-1]:
        m.net.set_der_fast("bf16" if mode == "bf16_der_fast" else None)
        for b in THROUGHPUT_BATCHES:
            xb = x[:b]
            for _ in range(2):
                engine.infer(xb)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            for _ in range(reps):
                engine.infer(xb)
            torch.cuda.synchronize()
            host = (time.perf_counter() - t) * 1e3 / reps
            peak = torch.cuda.max_memory_allocated()
            wall, cats, _ = _profile_once(torch, engine, xb, 3, whole=False)
            dev_ms = sum(cats.values())
            runs.setdefault(mode, {}).setdefault(str(b), []).append({
                "img_per_s": b / host * 1e3, "host_ms_per_batch": host,
                "device_ms_per_batch": dev_ms,
                "device_busy_share": dev_ms / wall,
                "peak_memory_allocated_gb": peak / 1e9,
                "by_category_ms": dict(sorted(cats.items(),
                                              key=lambda kv: -kv[1]))})
    engine.close()
    emit({"phase": "throughput_bf16", "ok": True, "size": SIZE,
          "turns": list(modes + modes[::-1]), "reps": reps,
          "check_batch": big, "checks": check, "runs": runs})
    return runs


def phase_times_cm(torch, dev, counts, errs, batches=(4, 128)):
    """K10 / K11 per distinct DER conv shape in bfloat16, at batch 4 (the
    served batch) and 128: device ms under the profiler from a cold L2, the
    CUDA-event ms, the plain version, the library call (the cuDNN bfloat16
    conv with the bias, then SiLU; for K11 after a torch.cat) and the bound
    over the bfloat16 tensor-core peak; summed per forward (each shape times
    its calls per forward). The kernels line's rows are batch 4's."""
    from rep_yolo_tpu_torch.ops.kernels import reset_launch_counts

    agg = {b: {n: {} for n in CM_PER_FORWARD} for b in batches}
    per_shape = []
    for b in batches:
        for i, row in enumerate(der_cm_shapes()):
            name, kfn, pfn, lib, nbytes, ops = cm_case(
                torch, row, b, dev, 500 + i, torch.bfloat16)
            t = {"ms": device_ms(torch, kfn), "event_ms": cuda_ms(kfn, runs=10),
                 "plain_ms": device_ms(torch, pfn, whole=False),
                 "library_ms": device_ms(torch, lib, whole=False)}
            t.update(zip(("bound_ms", "bound_by"),
                         bound(nbytes, ops, BF16_PEAK)), bytes=nbytes, ops=ops)
            add_times(agg[b][name], t, row[-1])
            per_shape.append({"batch": b, "shape": row[0], "kernel": name,
                              "calls_per_forward": row[-1], **t})
            del kfn, pfn, lib
    reset_launch_counts()
    kernels = []
    for name, line in (("conv3x3_cmajor", 100), ("conv1x1_cmajor", 340)):
        row = kernel_row(name, "rep_yolo_tpu_torch/csrc/conv_kernel.cu",
                         f"rep_yolo_tpu/ops/pallas/conv_kernel.py:{line}",
                         counts[name], errs[name], agg[batches[0]][name],
                         BF16_PEAK)
        row["library_call"] = ("F.conv2d (cuDNN, bf16, with the bias) then "
                               "F.silu" + (", after a torch.cat of the "
                                           "sections" if "1x1" in name else ""))
        kernels.append(row)
    emit({"phase": "times_cm", "ok": True, "dtype": "bfloat16",
          "note": f"per forward at {SIZE} px: each shape times its calls per "
                  "forward; ms, plain_ms, library_ms: device time under the "
                  "profiler from a cold L2, 10 calls after 3 warm-ups (plain "
                  "and library: median of 3 windows); event_ms: CUDA events, "
                  "median of 10 runs of 10 back-to-back calls (L2-warm); "
                  "bound_ms: bytes over 3.35 TB/s or FLOPs over 989 TFLOP/s",
          "per_forward": {str(b): {n: {k: v for k, v in agg[b][n].items()}
                                   for n in CM_PER_FORWARD}
                          for b in batches},
          "launches_per_forward": CM_PER_FORWARD, "per_shape": per_shape})
    return kernels


# ---------------------------------------------------------------------------
# training: K9 and the train step (outside inference_mode)
# ---------------------------------------------------------------------------

# (B, H, W, C, O, convs per step) of the 3x3 convs the select-all wgrad
# route sends to K9 in one train step of the flagship at 640 px, batch 8:
# l9 SPPCSPC cv3 and cv6, the GSBottleneck 3x3 GSConv cv1 of the four
# VoVGSCSP (l14, l24 at 40x40, l40 at 80x80, l56 at 20x20), the RepConv
# rbr_dense of l62-l64
WGRAD_SHAPES = [(8, 20, 20, 512, 512, 2), (8, 40, 40, 128, 64, 2),
                (8, 80, 80, 64, 32, 1), (8, 20, 20, 256, 128, 1),
                (8, 80, 80, 128, 256, 1), (8, 40, 40, 256, 512, 1),
                (8, 20, 20, 512, 1024, 1)]
WGRAD_PER_STEP = sum(s[-1] for s in WGRAD_SHAPES)
TRAIN_BATCH = 8


def wgrad_ops(B, H, W, C, O) -> tuple[float, float]:
    """(least, direct) f32 operations of the 3x3 weight gradient. Direct:
    the sum as written, 2 * O * 9C * B*H*W. Least: the multiply-adds of
    Winograd's minimal algorithm for the correlation of each (H+2, W+2)
    padded map with each (H, W) gradient map, (H+2)(W+2) products per image
    and channel pair, 2 * O * C * B * (H+2)(W+2): no algorithm of products
    of linear forms (direct, Winograd, FFT) needs fewer multiplications, and
    the transforms' additions are left out."""
    return 2.0 * O * C * B * (H + 2) * (W + 2), 2.0 * O * 9 * C * B * H * W


def wgrad_case(torch, shape, dev, seed):
    """(kernel fn, plain fn, library fn, bytes, ops) of K9 at one shape, on
    seeded x (B, C, H, W) and dY (B, O, H, W); ops: ``wgrad_ops``' least."""
    from rep_yolo_tpu_torch.ops.kernels import wgrad as KW

    B, H, W, C, O = shape[:5]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, C, H, W), generator=g).to(dev)
    dy = torch.randn((B, O, H, W), generator=g).to(dev)
    nbytes = 4 * (x.numel() + dy.numel() + O * C * 9)
    ops = wgrad_ops(B, H, W, C, O)[0]
    return (lambda: KW.wgrad3x3(x, dy), lambda: KW.wgrad3x3_plain(x, dy),
            lambda: torch.nn.grad.conv2d_weight(x, (O, C, 3, 3), dy,
                                                padding=1), nbytes, ops)


def phase_kernels_wgrad(torch, dev, errs):
    """K9 against its plain version at the nine flagship shapes: |got - ref|
    <= 1e-4 |ref| + 1e-4 max|ref|; the error against cuDNN's wgrad
    (conv2d_weight, TF32 off) as a report."""
    rows = []
    for i, shape in enumerate(WGRAD_SHAPES):
        kfn, pfn, lib, _, _ = wgrad_case(torch, shape, dev, 300 + i)
        got, ref, cud = kfn(), pfn(), lib()
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        ok = bool(((got - ref).abs() <= 1e-4 * ref.abs()
                   + 1e-4 * scale).all())
        r = {"shape": list(shape[:5]), "convs_per_step": shape[5],
             "max_abs_err": err, "ref_absmax": scale,
             "err_vs_cudnn": float((got - cud).abs().max())}
        rows.append(r)
        if not ok:
            raise AssertionError(f"wgrad3x3 differs from its plain version: "
                                 f"{r}")
        errs["wgrad3x3"] = max(errs.get("wgrad3x3", 0.0), err)
    emit({"phase": "kernels_wgrad_vs_plain", "ok": True,
          "tolerance": "rtol 1e-4, atol 1e-4 x max|dW|", "shapes": rows})


def train_setup(torch, dev, cfg=CFG, size=SIZE, batch=TRAIN_BATCH, n=16,
                warmup=True):
    """The flagship's training as ``cli.train`` builds it
    (``build_training``: seeded init, scratch.p5, simOTA, nesterov SGD, EMA)
    with ``--no-accumulate`` (the CLI's accumulation also applies the
    optimizer at every call for its first 72 iterations at batch 8), the
    select-all wgrad route, and the synthetic batches (seed 0) on
    the card."""
    from rep_yolo_tpu_torch.cli import train as cli

    args = cli.parse_args([
        "--cfg", cfg, "--data", f"synthetic:{n}", "--batch-size", str(batch),
        "--img-size", str(size), "--no-augment", "--no-autoanchor",
        "--eval-every", "0", "--no-accumulate", "--device", str(dev)])
    t = cli.build_training(args, warmup=warmup)
    t.model.net.set_wgrad(True, select=lambda c1, c2: True)
    batches = [[torch.from_numpy(b[k]).to(dev)
                for k in ("images", "hw", "labels", "mask")]
               for b in t.loader.epoch(0)]
    return t.model, t.state, t.step, batches


def _grad_check(torch, model, state, step, batch):
    """One step's grads with K9 against the same step on the plain autograd
    path (cuDNN's wgrad): the same state, batch and dropout masks, and
    cuDNN held to deterministic algorithms for both, so that the routed
    weight gradients are the only sums that differ (a non-deterministic
    cuDNN wgrad moves the near-zero grads of other tensors by ~1e-7)."""
    from rep_yolo_tpu_torch.ops.kernels import launch_counts

    net = model.net
    routed = [k for k, m in net.named_modules() if getattr(m, "wgrad", False)]
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        state.generator.manual_seed(7)
        n0 = launch_counts()["wgrad3x3"]
        g9, c9 = step.grads(state, *batch)
        torch.cuda.synchronize()
        launched = launch_counts()["wgrad3x3"] - n0
        net.set_wgrad(False)
        state.generator.manual_seed(7)
        gp, cp = step.grads(state, *batch)
    finally:
        torch.backends.cudnn.deterministic = was
        net.set_wgrad(True, select=lambda c1, c2: True)
    worst, worst_key = 0.0, None
    for k, b in gp.items():
        a = g9[k]
        tol = 1e-3 * b.abs() + 1e-3 * float(b.abs().max())
        excess = float(((a - b).abs() - tol).max())
        if excess > worst or worst_key is None:
            worst, worst_key = excess, k
        if excess > 0:
            raise AssertionError(f"grad of {k} with K9 differs from the "
                                 f"plain path by {float((a - b).abs().max())}")
    if launched != WGRAD_PER_STEP:
        raise AssertionError(f"the checked step launched K9 {launched} "
                             f"times, want {WGRAD_PER_STEP}")
    wk = [k + ".weight" for k in routed]
    return {"params": len(gp), "k9_launches": launched,
            "loss_k9": float(c9["total"]), "loss_plain": float(cp["total"]),
            "routed_max_abs_diff": max(float((g9[k] - gp[k]).abs().max())
                                       for k in wk),
            "all_max_abs_diff": max(float((g9[k] - gp[k]).abs().max())
                                    for k in gp),
            "worst_param": worst_key}


def _train_category(name: str) -> str:
    low = name.lower()
    if "wgrad3x3" in low or "wgrad_reduce" in low:
        return "K9 wgrad3x3"
    if "wgrad" in low:
        return "cuDNN wgrad"
    if "dgrad" in low:
        return "cuDNN dgrad"
    if "bn_fw" in low or "bn_bw" in low or "batch_norm" in low \
            or "welford" in low:
        return "batch norm (cuDNN)"
    if "fprop" in low or "convolve" in low or "winograd" in low \
            or "fft" in low or "conv2d" in low or "implicit_gemm" in low:
        return "cuDNN fwd"
    if "gemm" in low or "gemv" in low:
        return "GEMM (einsum, FFT convs)"
    if "foreach" in low or "multi_tensor" in low:
        return "optimizer and EMA (foreach)"
    c = _category(name)
    return "other conv" if c == "convolutions (cuDNN)" else c


TRAIN_RANGES = ("train/forward", "train/loss", "train/backward",
                "train/optimizer")


def profiled_train(torch, fn, reps: int):
    """``fn`` (one train step) ``reps`` times under torch.profiler: host
    wall ms per step, device ms per step by kernel name, and the device ms
    of the kernels launched inside each of the step's ranges (the
    backward's kernels run on autograd's thread and fall outside it), and
    the K9 launches per step the profiler saw."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / reps
    names, ranges, k9_seen = {}, {}, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if e.key in TRAIN_RANGES and \
                e.device_type == torch.autograd.DeviceType.CUDA:
            continue            # the ranges' own spans on the device
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            names[e.key] = names.get(e.key, 0.0) + us / 1e3 / reps
            k9_seen += e.count if "wgrad3x3_kernel" in e.key else 0
        elif e.key in TRAIN_RANGES:
            tot = getattr(e, "device_time_total", None)
            if tot is None:
                tot = e.cuda_time_total
            ranges[e.key] = tot / 1e3 / reps
    return wall, names, ranges, k9_seen / reps


def phase_train_step(torch, dev, size=SIZE, cfg=CFG, batch=TRAIN_BATCH,
                     warm=3, timed=10):
    """The flagship's train step on the card: warm-ups, then the timed
    steps with the launch counts zeroed just before them and read just
    after; one step's grads with K9 against the plain path; the step's time
    by category under the profiler; peak memory."""
    import numpy as np

    from rep_yolo_tpu_torch.ops.kernels import launch_counts, \
        reset_launch_counts

    model, state, step, batches = train_setup(torch, dev, cfg, size, batch)
    comps = []
    for i in range(warm):
        comps.append(step(state, *batches[i % len(batches)]))
    check = _grad_check(torch, model, state, step, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    host = []
    reset_launch_counts()
    for i in range(timed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        comps.append(step(state, *batches[i % len(batches)]))
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    vals = [{k: float(v) for k, v in c.items()} for c in comps]
    if not all(np.isfinite(v[k]) for v in vals for k in v):
        raise AssertionError(f"a loss component is not finite: {vals}")
    per_step = counts["wgrad3x3"] / timed
    if counts["wgrad3x3"] != WGRAD_PER_STEP * timed:
        raise AssertionError(f"K9 launched {counts['wgrad3x3']} times in "
                             f"{timed} steps, want {WGRAD_PER_STEP} a step")
    wall, names, ranges, k9_seen = profiled_train(
        torch, lambda: step(state, *batches[0]), 3)
    cats: dict[str, float] = {}
    for n, ms in names.items():
        c = _train_category(n)
        cats[c] = cats.get(c, 0.0) + ms
    dev_ms = sum(names.values())
    emit({"phase": "train_step", "ok": True, "batch": batch, "size": size,
          "warmups": warm, "timed_steps": timed,
          "launch_counts": counts, "k9_launches_per_step": per_step,
          "k9_launches_per_step_profiler_saw": k9_seen,
          "losses": vals, "grad_check": check,
          "grad_tolerance": "rtol 1e-3, atol 1e-3 x max|g| per parameter",
          "step_host_ms": host,
          "step_host_ms_median": statistics.median(host),
          "profiled_wall_ms_per_step": wall,
          "device_ms_per_step": dev_ms if dev_ms > 0 else "not measured",
          "device_busy_share": dev_ms / wall if dev_ms > 0
          else "not measured",
          "by_category_ms": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
          "range_device_ms": ranges,
          "top_kernels_ms": [[k[:90], v] for k, v in sorted(
              names.items(), key=lambda kv: -kv[1])[:12]],
          "max_memory_allocated_bytes": peak})
    return counts


def phase_train_overfit(torch, dev, size=SIZE, cfg=CFG, batch=TRAIN_BATCH,
                        steps=20):
    """20 optimizer steps on one repeated batch, warmup off: the loss must
    fall."""
    import numpy as np

    model, state, step, batches = train_setup(torch, dev, cfg, size, batch,
                                              n=batch, warmup=False)
    totals = [float(step(state, *batches[0])["total"]) for _ in range(steps)]
    if not (np.isfinite(totals).all() and totals[-1] < totals[0]):
        raise AssertionError(f"the loss did not fall: {totals}")
    emit({"phase": "train_overfit", "ok": True, "steps": steps,
          "total": totals})


def phase_train_cli(torch, timeout=900):
    """``python -m rep_yolo_tpu_torch.cli.train`` as a user runs it."""
    import numpy as np

    cmd = [sys.executable, "-m", "rep_yolo_tpu_torch.cli.train",
           "--data", "synthetic:16", "--epochs", "1", "--batch-size",
           str(TRAIN_BATCH), "--img-size", str(SIZE), "--no-augment",
           "--no-autoanchor", "--eval-every", "0"]
    t = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout)
    secs = time.perf_counter() - t
    lines = [json.loads(s) for s in p.stdout.splitlines()
             if s.startswith("{")]
    steps = [r for r in lines if "total" in r]
    ok = (p.returncode == 0 and len(steps) == 2 and all(
        np.isfinite([r[k] for k in ("box", "obj", "cls", "total")]).all()
        for r in steps))
    if not ok:
        raise AssertionError(f"cli.train failed (exit {p.returncode}):\n"
                             f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
    emit({"phase": "train_cli", "ok": True, "cmd": " ".join(cmd[1:]),
          "exit": p.returncode, "seconds": secs, "steps": steps})


def cold_event_ms(torch, fn, reps: int = 10, warmup: int = 3) -> float:
    """Device ms of one call of ``fn`` from a cold L2, by CUDA events around
    the call, each call after an ``l2_flush``; median of ``reps``. The host
    enqueues the call while the flush still runs, so no launch gap falls
    between the events. A check on the profiler's time of a kernel of one
    or two launches."""
    flush, _ = l2_flush(torch)
    for _ in range(warmup):
        flush()
        fn()
    ms = []
    for _ in range(reps):
        flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return statistics.median(ms)


def phase_times_wgrad(torch, dev):
    """K9 per flagship shape: device ms under the profiler from a cold L2
    (windows in which every kernel's events are whole), CUDA-event ms around
    one cold call as a check, event ms back to back, plain and library
    (conv2d_weight) ms, and the bound; summed per train step. Measured
    before the training phases: after them the profiler loses device
    events (``phase_profiler_after_training``)."""
    agg: dict = {}
    per_shape = []
    for i, shape in enumerate(WGRAD_SHAPES):
        kfn, pfn, lib, nbytes, ops = wgrad_case(torch, shape, dev, 300 + i)
        t = {"ms": device_ms(torch, kfn),
             "cold_event_ms": cold_event_ms(torch, kfn),
             "event_ms": cuda_ms(kfn),
             "plain_ms": device_ms(torch, pfn, whole=False),
             "library_ms": device_ms(torch, lib, whole=False)}
        t.update(zip(("bound_ms", "bound_by"), bound(nbytes, ops)),
                 bytes=nbytes, ops=ops,
                 bound_direct_ms=bound(nbytes, wgrad_ops(*shape[:5])[1])[0])
        add_times(agg, t, shape[5])
        per_shape.append({"shape": list(shape[:5]),
                          "convs_per_step": shape[5], **t})
    for k in ("cold_event_ms", "bound_direct_ms"):
        agg[k] = sum(r[k] * r["convs_per_step"] for r in per_shape)
    emit({"phase": "times_wgrad", "ok": True, "batch": TRAIN_BATCH,
          "note": "per step: each shape times its convs per step; ms: "
                  "device time under the profiler from a cold L2, 10 calls "
                  "after 3 warm-ups, in a window that holds every kernel's "
                  "events for all 10; cold_event_ms: CUDA events around one "
                  "call from a cold L2, median of 10; plain_ms, library_ms: "
                  "device time of all kernels of the call under the "
                  "profiler from a cold L2, median of 3 windows of 10 calls "
                  "(their library calls launch a varying number of "
                  "kernels); event_ms: CUDA events, median of 20 runs of 10 "
                  "back-to-back calls (L2-warm); bound_ms: the least "
                  "operations (wgrad_ops), bound_direct_ms: the direct sum",
          "per_shape": per_shape,
          "per_step": {k: agg[k] for k in agg if k not in ("bytes", "ops")}})
    return agg


def wgrad_row(counts, errs, agg) -> dict:
    row = kernel_row("wgrad3x3", "rep_yolo_tpu_torch/csrc/wgrad.cu",
                     "rep_yolo_tpu/ops/pallas/wgrad_kernel.py:85",
                     counts["wgrad3x3"], errs["wgrad3x3"], agg, F32_PEAK)
    row["launches_per_step"] = WGRAD_PER_STEP
    row["library_call"] = "torch.nn.grad.conv2d_weight (cuDNN, TF32 off)"
    return row


def phase_profiler_after_training(torch, dev, reps: int = 10,
                                  windows: int = 3):
    """Profiler windows of K9 (with the L2 flush's PyTorch kernel before
    each call) after the training phases: the device events recorded per
    kernel name against the launches made. A report: in such windows the
    profiler has lost the first events of a window, of every kernel alike."""
    kfn = wgrad_case(torch, WGRAD_SHAPES[0], dev, 300)[0]
    flush, _ = l2_flush(torch)

    def call():
        flush()
        kfn()

    for _ in range(3):
        call()
    seen = [profiled(torch, call, reps, counts=True)[2]
            for _ in range(windows)]
    emit({"phase": "profiler_after_training", "ok": True,
          "calls_per_window": reps, "shape": list(WGRAD_SHAPES[0][:5]),
          "events_per_window": [{k[:48]: n for k, n in w.items()}
                                for w in seen]})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None,
                   help="also write every JSON line to this file")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "rep_yolo_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the rep_yolo_tpu_torch package is missing",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    # the settings serve.build_engine serves with, for every phase
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    errs: dict[str, float] = {}

    t0 = time.perf_counter()
    with torch.inference_mode():
        card = phase_device_build(torch)
        phase_kernels(torch, dev, errs)
        phase_kernels_q8(torch, dev, errs)
        phase_kernels_cm(torch, dev, errs)
        phase_golden(torch, dev)
        phase_attention_e2e(torch, dev)
        phase_int8_e2e(torch, dev)
        phase_int8_e2e(torch, dev, neck=True)
        phase_bf16_e2e(torch, dev)
        counts, e2e_ms, engine, x = phase_serving(torch, dev)
        _, e2e_bb_ms, engine_bb, _ = phase_serving(torch, dev, "int8",
                                                   neck=False)
        counts_q8, e2e_q8_ms, engine_q8, _ = phase_serving(torch, dev,
                                                           "int8")
        counts_bf16, e2e_bf16_ms, engine_bf16, _ = phase_serving(
            torch, dev, der_fast="bf16")
        calls = phase_kernels_neck(torch, engine_q8, x, errs)
        engines = {"float32": engine, "int8_backbone": engine_bb,
                   "int8": engine_q8, "bf16_der_fast": engine_bf16}
        phase_profile(torch, engines, x)
        ab = phase_served_ab(torch, engines, x.cpu().numpy())
        for e in engines.values():
            e.close()
        kernels = phase_times(torch, dev, counts, errs)
        kernels += phase_times_q8(torch, dev, counts_q8, errs, calls)
        kernels += phase_times_cm(torch, dev, counts_bf16, errs)
    # training needs autograd: outside inference_mode; cuDNN picks its
    # algorithms as under cli.train (TF32 stays off)
    torch.backends.cudnn.deterministic = False
    phase_kernels_wgrad(torch, dev, errs)
    with torch.inference_mode():
        wgrad_times = phase_times_wgrad(torch, dev)
    counts_train = phase_train_step(torch, dev)
    phase_train_overfit(torch, dev)
    phase_train_cli(torch)
    with torch.inference_mode():
        phase_profiler_after_training(torch, dev)
        # last: after its batch-128 profiler windows the profiler loses a
        # device event in every later window, of every kernel alike
        phase_throughput_bf16(torch, dev)
    kernels.append(wgrad_row(counts_train, errs, wgrad_times))
    missing = [k["name"] for k in kernels if k["launches"] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    emit({"card": card, "served_batch4_ms": e2e_ms,
          "served_batch4_int8_backbone_ms": e2e_bb_ms,
          "served_batch4_int8_ms": e2e_q8_ms,
          "served_batch4_bf16_der_fast_ms": e2e_bf16_ms, "served_ab_ms": ab,
          "total_s": round(time.perf_counter() - t0, 3)})
    kline = {"kernels": kernels}
    print(json.dumps(kline), flush=True)
    final = {"ok": True, "device": {"platform": "gpu",
                                    "kind": torch.cuda.get_device_name(0),
                                    "count": torch.cuda.device_count()}}
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"lines": LINES, **kline, **final},
                                  indent=1))
    print(json.dumps(final), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
