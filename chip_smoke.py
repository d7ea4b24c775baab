#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (rep_yolo_tpu_torch) on one card.

Drives the port's paths, fused float serving of cfg/rep_yolo.yaml at 640 px
and the same with the calibrated int8 region (``--fast int8``: the backbone,
neck and head in int8, the attention blocks in float; and the backbone
region alone, ``Q8Region(neck=False)``), bfloat16 serving with the DER
blocks on the channel-major kernels (``build_engine(dtype=torch.bfloat16,
der_fast="bf16")``), the DER blocks' int8 "xla_q8" mode
(``build_engine(der_fast="xla_q8")``), the kernel benches
(``rep_yolo_tpu_torch.tools.kernel_bench*``), training it (phases 9-14), and
evaluating it with checkpoints (phases 16-20), and holds every CUDA kernel
of those paths against its plain PyTorch version on the card.
Phases, one JSON line each:

  1. device and build: the card, then nvcc of every csrc/*.cu (parallel)
  2. kernels vs plain: axial attention (K1 projection, K2's line kernel in
     both modes: the columns for vertical; for criss-cross a row pass, then
     a column pass that merges the two under the joint softmax) at the six
     640-px CCVA shapes, batch 2, and at ATTN_EXTRA (odd maps, C = 8, the
     160-px map, the P6 widths of 1280 px and a 4 x 1600 map past the
     48 KB of shared memory that the first criss-cross kernel needed), each
     tile's shared memory against the kernel's formula, gamma 0.7,
     random BN constants, atol = rtol = 1e-4, a second call bit-identical;
     NMS keep masks on clustered boxes, zero-area
     duplicates, IoU exactly at the threshold, identical boxes (one kept),
     disjoint boxes (all kept) and no valid slot, K = 1024 and 4096 at
     batch 2 and ragged K (1, 63, 65, 1000 at batch 8; 4097 at batch 3),
     keep sets identical (and equal to the greedy oracle up to K = 1024)
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
     version and the bound (K1 also beside torch.matmul(x, wqk.t()) alone,
     "q/k product only", a partial yardstick; K3 also its mask kernel and
     its scan apart); end-to-end ms of one served batch

and for the int8 path:

  2b. kernels_q8_vs_plain: K4 conv3x3_q8, K5 conv1x1_q8 and K6 max_pool2_q8
     at every backbone shape of 640 px, batch 4 (random weights, random
     int8 maps): int8 outputs identical but for +-1 LSB on at most 1e-4 of
     the elements, the float exit atol = rtol = 1e-5, pools identical; each
     K4 line names the route the call took (k4_route: "wgmma" for a
     stride-1 3x3 on int8 input, "wgmma_s2" for stride 2 on int8 input,
     "wgmma_f32" for stride 1 on float32 input, else "dp4a"); K6 and K8
     at POOL_EXTRA's maps besides (ragged, C off 16, H or W below the
     13-window, a map wider than one K8 tile), each also as a view 4 bytes
     into a buffer (the word route), identical to the plain version and on
     a second call
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
     12 / 6 / 6 / 1, and K4's by route, 33 on wgmma, 2 on wgmma_s2 (the
     PAN downsamples) and 1 on dp4a (the stem); serving_int8_backbone:
     the backbone region alone, 25 K4 (24 wgmma, 1 dp4a), 28 K5, 1 K6
  5c. kernels_neck_vs_plain: every int8 kernel call of layers 9-65 of one
     served int8 forward (batch 4, the real maps and weights, recorded on
     the way), K4 (stride 1 and 2), K5 (1-3 sections, int8 or f32 out), K6,
     K7 and K8, against its plain version on the same inputs, as 2b (K4
     lines naming their route)
  6b. profile of the three engines, in turns (float, int8 backbone, int8,
     and back)
  7b. times_q8: K4-K6 per backbone shape, and K4-K8 per distinct neck call
     of 5c, beside the plain version, the bound and the PyTorch yardstick
     (the f32 cuDNN conv of the same shape; for K7 the f32 depthwise conv;
     for K8 the sequence of three F.max_pool2d and a torch.cat), and the
     calls that compute the convs' sums exactly (K5: torch._int_mm of the
     materialised concat; K4: cuDNN's bf16 conv of the int8-valued map);
     summed per forward (the backbone apart too) and, for the neck, per
     layer; K4's sums also split by route (launches, ms, bound, the bf16
     yardstick over the same calls), beside the earlier designs' ms; each
     K6 / K8 call beside its launch floor (floor_ms: an empty kernel,
     csrc/launch_floor.cu, at the call's grid, block and shared memory, and
     at the previous design's); the earlier designs' ms, readings of
     earlier runs, stand in the phase line only, not in the kernels line
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

and for the last five TPU kernels (K13 conv3x3_cmajor_q8, K14
conv1x1_cmajor_q8, K4 with 5x5 taps as conv5x5_q8, the pixel-major
conv3x3_pm_q8 / conv1x1_pm_q8 on K4 / K5) and the "xla_q8" mode:

  4e. xla_q8_e2e: golden weights, calibrated on serve's calibration batch,
     640 px, batch 4, a float32 net and one cast to bfloat16, with
     der_fast="xla_q8": 24 + 28 pixel-major calls (on K4 / K5) per forward;
     raw maps against the same net on the plain versions within 1e-4
     max|ref| per level, and against the float32 net without der_fast
     within 0.15 max|ref| with a correlation above 0.99
  5e. serving_xla_q8: as 5, the float32 xla_q8 engine; launches per
     forward 24 conv3x3_pm_q8 and 28 conv1x1_pm_q8 (as many K4 and K5)
     beside 12 / 6 / 6 / 1; K4's by route 20 wgmma, 4 wgmma_f32 (each DER
     block's st1 reads the float32 map), 0 dp4a
  2d. kernels_q8_rest (after 5c): K13 / K14 at kernel_bench's 15 shapes and
     the JAX test's, batch 2, float32 / bfloat16 / int8 in, bfloat16 / int8
     out (K14 over three sections at the cv1 shapes; K13's tile from
     k13_route beside each call); the pixel-major pair at the 20 DER
     shapes, batch 2, ReLU included; int8 identical but +-1 LSB on <= 1e-4,
     bfloat16 within one ulp; conv5x5_q8 at the 18 depthwise calls of 5c's
     forward with the block-diagonal weights of the JAX dw5_dense route: 18
     launches of its 25-tap wgmma route (dense5_route, the route and tile
     beside each call), identical to K7 and within the gate of its plain
     version
  7e. kernel_bench: both benches of the port at batch 8, in process, their
     tables on one line
  7f. times_q8_rest: K13 / K14 summed over kernel_bench's 3x3 / 1x1 shapes
     at batch 8 (bf16 in and out; cuDNN bf16 and f32 conv + bias + SiLU
     beside; K13's tile per shape); the pixel-major pair over one xla_q8
     served forward at batch 4 (cuDNN f32 beside, and as in 7b
     torch._int_mm for conv1x1_pm_q8 and the bf16 conv for conv3x3_pm_q8;
     conv3x3_pm_q8 split by K4's route too); conv5x5_q8 over the 18
     block-diagonal calls (the dense F.conv2d of the same block-diagonal
     weights, f32 and bf16, cuDNN's f32 depthwise and K7 beside; the route
     and tile per call); the two rows' designs before beside

and, outside inference_mode, training cfg/rep_yolo.yaml at 640 px, batch 8
as cli.train builds it (build_training: seeded init, synthetic batches from
seed 0, scratch.p5, simOTA, SGD, EMA; --no-accumulate), with the wgrad route
on with select-all: 9 convs a step on K9; cuDNN's default algorithm choice,
as cli.train runs:

  9. kernels_wgrad_vs_plain: K9 wgrad3x3 at the nine routed shapes, seeded
     x and dY, rtol 1e-4 / atol 1e-4 x max|dW| against the plain version,
     two calls identical; the error against cuDNN's wgrad as a report
  10. times_wgrad: K9 per shape and summed per step (profiler device time,
     CUDA events around a cold call as a check) beside the plain version,
     conv2d_weight and the bound (the least operation count)
  11. train_step: 3 warm-up and 10 timed steps, finite losses, 9 K9
     launches a step (counts zeroed before the timed steps, read after);
     one step's grads with K9 against the plain autograd path (cuDNN
     wgrad), per parameter rtol 1e-3 / atol 1e-3 x max|g|; host ms,
     device ms by category and busy share under torch.profiler, peak memory
  12. train_overfit: 20 steps on one batch, warmup off, cuDNN held to
     deterministic algorithms: the loss falls
  13. train_cli: python -m rep_yolo_tpu_torch.cli.train --data synthetic:16
     --epochs 1 (batch 8, 640 px, no augment, no autoanchor, no eval) exits
     0 with finite step lines
  13a. train_augment, twice (AUG_SETTINGS: scratch.p5 as shipped, mosaic-9
     0.2, paste-in 0.15; then mosaic-9 0.5, paste-in 0.5, cutout 0.3):
     augmentation (data/augment.py) on one batch from one CPU generator's
     draws at the first seed that takes every branch the hyp turns on
     (mosaic-9 and mosaic-4, paste-in from a slot that holds a label,
     cutout, each on some image), on the card against the CPU (masks
     identical, labels 1e-5, images AUG_IMG_TOL), paste-in adding labels
     there; 5 augmented train steps: each step's batch in [0, 1],
     finite losses; host ms of a step and of the augmentation alone, device
     ms of the step and of its train/augment range, the augmentation's
     launches, with the card's name and power limit
  13b. train_cli_augment: the train CLI of 13 with --hyp scratch.p5 as
     shipped, augmentation and autoanchor on, exits 0 with finite step
     lines, prints the autoanchor line and writes anchors.json
  13c. autoanchor_demo: check_anchors on the JAX demo run's set
     (synthetic:768 at 640 px, seed 0, thr 4.0) reproduces
     runs/train/demo/anchors.json, as tests/golden/demo_anchors.json
     copies it (BPR to 1e-12, anchors unchanged and equal to the file's);
     with 2000-px anchors it evolves a set of higher BPR (the seconds it
     took)
  14. profiler_after_training: the device events the profiler records in
     windows of K9 calls after the training phases (a report)

and for evaluation (train/evaluate.py, cli.train --val-data / --eval-every,
cli.test, the checkpoints; the counts zeroed before each evaluation and read
after it):

  16. kernels_eval_vs_plain (with the kernels, before training): K3 at
     evaluation's K = 8192 on phase 2's cases (batch 2), keep sets
     identical to the plain version and, on one image of the clustered
     boxes, to the greedy oracle; K12 dwconv5x5_f32w_q8 at the 18
     depthwise 5x5 calls of one int8 forward with Q8Region(dw5_dense=False)
     (batch 8, evaluation's; recorded on the way as in 5c), as 2b; the
     row-3 route (a train-form attention block in eval(), q, k, v
     projected by cuDNN, then K2) at the six CCVA shapes against the einsum
     path, atol = rtol = 1e-4
  17. times_eval: K12 per call of that forward (profiler ms from a cold L2,
     event ms, plain, cuDNN's f32 depthwise conv, bound), summed per
     forward; K2 on the row-3 route at the six CCVA shapes at batch 8,
     summed per forward; K3 at K = 8192, batch 8, beside the plain matrix
     version
  18. eval_train_cli (after training): python -m rep_yolo_tpu_torch.cli.train
     --data synthetic:64 --val-data synthetic:32 --epochs 3 --eval-every 1
     (640 px, batch 8, no augment, no autoanchor): exit 0, an eval line every
     epoch with 6 + 6 K2 launches per forward on the row-3 route and no K1,
     one K3 per batch; best and last written
  19. eval_modes: best's EMA weights on the same val set, scored by
     rep_yolo_tpu_torch.tools.eval_modes in its seven modes: fused float32,
     unfused (row 3), bfloat16, bfloat16 der_fast, --fast int8 with K7 and
     with K12, and xla_q8 (the int8 modes calibrated on the first 8
     images): P, R, mAP@.5, mAP@.5:.95, host ms per image, launches per
     forward, the gaps to float32 and K12 - K7
  20. test_cli: python -m rep_yolo_tpu_torch.cli.test --weights best on the
     val images written as PNG files, --rect --fast int8, then with
     --dw5-exact (K12): exit 0, and mAP within 1e-6 of a direct evaluate on
     DetectionDataset.from_path of that directory with the same flags (no
     image decoder on the machine: says so and runs nothing)
  21. serving_ckpt: serve --ckpt of that best (parsed as the CLI parses it),
     float32 and bfloat16 der_fast, batch 4: raw maps against best's EMA
     loaded through read_checkpoint (float32 1e-4 max|ref|; bfloat16 2e-2
     and corr > 0.999 against the cast model on cuDNN), 24 K10 / 28 K11
     launches per der_fast forward, one served call each
  22. train_resume: python -m rep_yolo_tpu_torch.cli.train --resume of
     phase 18's last, --epochs 4: it continues at epoch 3 in the same run
     directory, its first step is 3 * 8 + 1, results.txt has 4 epoch lines
     and metrics.csv its 2 new rows, init.npz is there from the first run,
     and the generator states it restored are the ones last.json saved
  23. overfit_box: python -m rep_yolo_tpu_torch.tools.overfit_check: the
     tiny graph overfit on one box for 2000 steps, then predict and NMS:
     the top box's IoU with the drawn one >= 0.8 and its confidence >= 0.5
     (its seconds)

Then the kernels line {"kernels": [...]} (K1-K14, conv5x5_q8 and the two
pixel-major rows; K3 again at K = 8192, K2 again for the row-3 route) and,
last, {"ok": true, "device": {...}}. Any failure raises and exits non-zero
without the last line.

Run:  python3 chip_smoke.py [--out results.json]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
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
# (c_, H, W, batch) held in phase 2 beside them: odd maps (C = 8 is the
# tiny config's), the P3 map of 1280 px (cfg/rep_yolo_p6_aux.yaml), the
# P6 config's widths (192, 384: three channel tiles of the line kernel) and
# a 4 x 1600 map (rows of 50 chunks in 7 query tiles)
ATTN_EXTRA = [(32, 13, 21, 1), (32, 13, 21, 8), (8, 13, 21, 2),
              (64, 160, 160, 2), (192, 40, 40, 2), (384, 20, 20, 2),
              (8, 4, 1600, 1)]
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


# (K, batch) of the NMS check's ragged cases: one partial tile, one tile and
# a bit, a partial last tile at the served size, 65 tiles
NMS_RAGGED = ((1, 8), (63, 8), (65, 8), (1000, 8), (4097, 3))


def nms_cases(device, ks=(1024, 4096), batch=2, seed=0, ragged=NMS_RAGGED):
    """(name, boxes (B,K,4), valid (B,K), thr) cases for the NMS check: for
    each K of ``ks`` at ``batch``, then each (K, batch) of ``ragged``:
    clustered boxes, zero-area duplicates, pairs at IoU exactly the
    threshold, every box identical (one kept), all disjoint (all kept), no
    valid slot."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    cases = []
    for K, B in [(k, batch) for k in ks] + list(ragged):
        centers = rng.uniform(0, 640, (B, 24, 2))
        pick = rng.integers(0, 24, (B, K))
        c = np.take_along_axis(centers, pick[..., None], 1) \
            + rng.normal(0, 6, (B, K, 2))
        wh = rng.uniform(20, 80, (B, K, 2))
        boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
        valid = rng.uniform(size=(B, K)) < 0.9
        cases.append((f"clustered_K{K}", boxes, valid, 0.45))
        dup = boxes.copy()
        dup[:, ::3, 2:] = dup[:, ::3, :2]                # zero area
        dup[:, 1::3] = dup[:, ::3][:, : dup[:, 1::3].shape[1]]
        cases.append((f"zero_area_dups_K{K}", dup, valid, 0.45))
        # pairs at IoU exactly 0.5 (= thr: kept): [x, y, x+32, y+8] then
        # [x, y, x+16, y+8], inter 128, union 256, all exact in f32
        xy = rng.integers(0, 75, (B, (K + 1) // 2, 2)) * 8.0
        edge = np.empty((B, K, 4))
        for j, wd in ((0, 32.0), (1, 16.0)):
            edge[:, j::2] = np.concatenate([xy, xy + [wd, 8.0]], -1)[
                :, : edge[:, j::2].shape[1]]
        cases.append((f"iou_at_threshold_K{K}", edge, valid, 0.5))
        all_valid = np.ones((B, K), bool)
        cases.append((f"identical_K{K}",
                      np.tile([10.0, 20.0, 50.0, 70.0], (B, K, 1)),
                      all_valid, 0.45))
        g = np.arange(K)[:, None] * 64.0
        cases.append((f"disjoint_K{K}", np.tile(np.concatenate(
            [g, g * 0, g + 32, g * 0 + 32], -1), (B, 1, 1)), all_valid, 0.45))
        cases.append((f"no_valid_K{K}", boxes, ~all_valid, 0.45))
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


LIB_KEYS = ("library_int_mm_ms", "library_bf16_ms")


def same_function_yardsticks(torch, name, xs, qw, stride, s_in) -> dict:
    """The PyTorch calls that compute a conv kernel's sums exactly, on its
    inputs materialised before the timed window: ``library_int_mm_ms``
    (K5, row 12) ``torch._int_mm``, the int8 x int8 -> int32 GEMM of the
    concat; ``library_bf16_ms`` (K4, rows 11 and 15) cuDNN's bf16 conv of
    the int8-valued map, channels_last, without the bias (exact while
    |sum| < 2^24). {key: fn, or None where the call refuses the shape, with
    the reason under key + "_refused"}."""
    import torch.nn.functional as F

    from rep_yolo_tpu_torch.ops.quant import quantize

    xq = [t if t.dtype == torch.int8 else quantize(t.float(), s_in)
          for t in xs]
    if name in ("conv1x1_q8", "conv1x1_pm_q8"):
        a = torch.cat(xq, -1).reshape(-1, sum(t.shape[-1] for t in xq))
        wq = qw.w_q.reshape(qw.c_out, -1)
        reason = None
        for b in (wq.t(), wq.t().contiguous()):
            try:
                torch._int_mm(a, b)
                torch.cuda.synchronize()
                return {"library_int_mm_ms": lambda b=b: torch._int_mm(a, b)}
            except RuntimeError as e:
                reason = str(e).strip().splitlines()[0][:160]
        return {"library_int_mm_ms": None,
                "library_int_mm_ms_refused": reason}
    cl = torch.channels_last
    C = xq[0].shape[-1]
    xb = xq[0].permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
        memory_format=cl)
    wb = qw.w_q[..., :C].permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
        memory_format=cl)
    return {"library_bf16_ms": lambda: F.conv2d(xb, wb, None, stride=stride,
                                                padding=qw.k // 2)}


def time_yardsticks(torch, t: dict, extra: dict) -> None:
    """Adds the device ms of ``extra``'s calls (``same_function_
    yardsticks``) to the times ``t`` of one shape: one checked profiler
    window each, from a cold L2, as the kernel's own ``ms``."""
    for k, fn in extra.items():
        t[k] = fn if k.endswith("_refused") or fn is None else \
            device_ms(torch, fn)


def add_yardsticks(agg: dict, t: dict, n: int = 1, sig=None) -> None:
    """Sums the yardsticks of ``LIB_KEYS`` over the calls that took them,
    with the kernel's own ms over the same calls (key + "_kernel_ms"), and
    lists the calls a yardstick refused (key + "_refused")."""
    for k in LIB_KEYS:
        if k not in t:
            continue
        agg.setdefault(k, 0.0)
        agg.setdefault(k + "_kernel_ms", 0.0)
        if t[k] is None:
            agg.setdefault(k + "_refused", []).append(
                f"{sig}: {t.get(k + '_refused')}")
        else:
            agg[k] += n * t[k]
            agg[k + "_kernel_ms"] += n * t["ms"]


def q8_case(torch, row, batch, dev, seed):
    """Inputs and calls of one backbone shape: (kernel fn, plain fn,
    f32 cuDNN fn or None, out_scale, bytes, ops, a function that returns
    the same-function yardsticks). Random weights at
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
                lib, None, nbytes, 0.0, dict)
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
            nbytes, ops,
            lambda: same_function_yardsticks(torch, kern, xs, qw, stride,
                                             s_in))


Q8_KERNELS = ("conv3x3_q8", "conv1x1_q8", "max_pool2_q8", "dwconv5x5_q8",
              "spp_pools_q8", "dwconv5x5_f32w_q8")
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
            "dwconv5x5_q8": KNF, "spp_pools_q8": KNF,
            "dwconv5x5_f32w_q8": KNF}[name]


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
    fn, out_scale, bytes, int8 ops, signature, a function that returns the
    same-function yardsticks). The yardstick runs the f32 function of the
    same shape: the cuDNN conv, the depthwise conv, the amax pool, or for
    the SPP pyramid three F.max_pool2d and a torch.cat; the same-function
    ones (K4, K5) are ``same_function_yardsticks``."""
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
        return kcall, pcall, lib, None, nbytes, ops, sig, dict
    if name == "dwconv5x5_f32w_q8":
        # K12's float32 weights (input scales folded in) on the int8 values
        x, qd = args["x"], args["qd"]
        C = qd.c
        xf = x.permute(0, 3, 1, 2).float().contiguous()
        wf = qd.w.t().reshape(C, 1, 5, 5).contiguous()
        lib = lambda: F.conv2d(xf, wf, qd.bias, padding=2, groups=C)  # noqa
        nbytes = (x.numel() * (1 + (4 if out_s is None else 1))
                  + 4 * qd.w.numel() + 4 * C)
        ops = 2.0 * 25 * x.numel()
        sig = (name, tuple(x.shape), args["act"], out_s is None)
        return kcall, pcall, lib, out_s, nbytes, ops, sig, dict
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
        return kcall, pcall, lib, out_s, nbytes, ops, sig, dict
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
    return kcall, pcall, lib, out_s, nbytes, ops, sig, (
        lambda: same_function_yardsticks(torch, name, xs, qw, stride,
                                         args["s_in"]))


K4_ROUTES = ("wgmma", "wgmma_s2", "wgmma_f32", "dp4a")
# K4's launches by route per forward (ops/kernels/conv_flat.py:k4_route):
# on the int8 tensor cores the stride-1 3x3s on int8 input ("wgmma"), the
# PAN downsamples (stride 2 on int8 input, "wgmma_s2") and xla_q8's four
# st1s (float32 input, "wgmma_f32"); the stem (float32 input with C = 3,
# stride 2) on dp4a
K4_ROUTES_PER_FORWARD = {"int8": {"wgmma": 33, "wgmma_s2": 2, "dp4a": 1},
                         "int8_backbone": {"wgmma": 24, "dp4a": 1},
                         "xla_q8": {"wgmma": 20, "wgmma_f32": 4, "dp4a": 0}}


def k4_call(fn):
    """(fn(), the K4 route that call launched, one of K4_ROUTES, or None
    for a call that launched no K4 or more than one)."""
    from rep_yolo_tpu_torch.ops.kernels import conv_flat as KC

    before = dict(KC.LAUNCHES_K4_ROUTE)
    out = fn()
    moved = [r for r in K4_ROUTES if KC.LAUNCHES_K4_ROUTE[r] != before[r]]
    return out, moved[0] if len(moved) == 1 else None


def route_rows(by_route: dict, launches: dict) -> dict:
    """K4's (or row 11's) per-forward sums split by route: each route's
    ms, bound and yardsticks over the calls that took it (``add_times`` /
    ``add_yardsticks`` into ``by_route[route]``), beside the main path's
    launches of that route."""
    return {r: {"launches": launches.get(r, 0),
                **({"bound_by": bound(a["bytes"], a["ops"], INT8_PEAK)[1]}
                   if a else {}),
                **{k: v for k, v in a.items() if k not in ("bytes", "ops")}}
            for r, a in by_route.items()}


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
    cases = [(c, h, w, 2) for c, h, w in ATTN_SHAPES] + ATTN_EXTRA
    for i, (c, h, w, batch) in enumerate(cases):
        x, wqk, pq, pv, gamma = attention_inputs(c, h, w, batch, i, 0.7, dev)
        q, k, v = KA.project(x, wqk, pq, pv)
        qp, kp, vp = KA.project_plain(x, wqk, pq, pv)
        e1 = max(float((a - b).abs().max()) for a, b in
                 ((q, qp), (k, kp), (v, vp)))
        for a, b in ((q, qp), (k, kp), (v, vp)):
            torch.testing.assert_close(a, b, **tol)
        again = all(torch.equal(a, b) for a, b in
                    zip((q, k, v), KA.project(x, wqk, pq, pv)))
        ptile = KA.project_tile(c, c // 8, batch * h * w)
        if KA._lib().axial_project_smem(c, ptile["rp"], ptile["rj"]) \
                != ptile["smem"]:
            raise AssertionError(f"project_tile's shared memory differs "
                                 f"from the kernel's at {ptile}")
        tile = KA.vertical_tile(h, c, c // 8)
        cc_tiles = KA.criss_cross_tile(h, w, c, c // 8)
        for t, mode in ((tile, KA.LINE_RAW), (cc_tiles["row"], KA.LINE_ROW),
                        (cc_tiles["col"], KA.LINE_MERGE)):
            if KA._lib().axial_line_smem(c // 8, t["tc"], t["rq"], t["kch"],
                                         t["stages"], mode) != t["smem"]:
                raise AssertionError(f"line_tile's shared memory differs "
                                     f"from the kernel's at {t}")
        errs["axial_project"] = max(errs.get("axial_project", 0.0), e1)
        for cc in (True, False):
            name = "axial_attend_" + ("criss_cross" if cc else "vertical")
            y = KA.attend(qp, kp, vp, x, gamma, cc)
            yp = KA.attend_plain(qp, kp, vp, x, gamma, cc)
            torch.testing.assert_close(y, yp, **tol)
            same = again and torch.equal(
                y, KA.attend(qp, kp, vp, x, gamma, cc))
            yf = KA.axial_attention(x, wqk, pq, pv, gamma, cc)
            yfp = KA.axial_attention_plain(x, wqk, pq, pv, gamma, cc)
            torch.testing.assert_close(yf, yfp, **tol)
            e2 = float((y - yp).abs().max())
            errs[name] = max(errs.get(name, 0.0), e2)
            rows.append({"shape": [batch, h, w, c], "mode": name,
                         "tile": cc_tiles if cc else tile,
                         "k1_err": e1, "k2_err": e2,
                         "k1k2_err": float((yf - yfp).abs().max()),
                         "second_call_identical": bool(same),
                         "out_absmax": float(yp.abs().max())})
            if not same:
                raise AssertionError(f"a second call differs: {rows[-1]}")
    torch.cuda.synchronize()
    for k in sorted({1, 1024, KN.MAX_K} | {k for k, _ in NMS_RAGGED}):
        if (KN._lib().nms_mask_words(k), KN._lib().nms_scan_smem(k)) \
                != (KN.mask_words(k), KN.scan_smem(k)):
            raise AssertionError(f"the NMS mask layout differs from the "
                                 f"kernel's at K={k}")
    nms_rows = []
    for name, boxes, valid, thr in nms_cases(dev):
        keep = KN.nms_keep(boxes, valid, thr)
        ref = KN.nms_keep_plain(boxes, valid, thr)
        same = bool(torch.equal(keep, ref))
        row = {"case": name, "batch": boxes.shape[0], "kept": int(keep.sum()),
               "identical": same}
        if boxes.shape[1] <= 1024:
            oracle = N._greedy_keep(boxes.cpu(), valid.cpu(), thr)
            row["greedy_identical"] = bool(torch.equal(keep.cpu(), oracle))
            same &= row["greedy_identical"]
        if name.startswith("identical"):
            same &= keep.sum(1).tolist() == [1] * boxes.shape[0]
        if name.startswith("disjoint"):
            same &= bool(keep.all())
        nms_rows.append(row)
        if not same:
            raise AssertionError(f"NMS keep mask differs: {row}")
    errs["nms_keep"] = 0.0
    emit({"phase": "kernels_vs_plain", "ok": True, "tolerance": tol,
          "attention": rows, "nms": nms_rows})


# (kernel, (B, H, W, C)) held in phase 2b beside the backbone's shapes
POOL_EXTRA = [("max_pool2_q8", s) for s in (
    (4, 80, 80, 128), (4, 40, 40, 256), (3, 10, 14, 4), (2, 6, 8, 8),
    (2, 4, 6, 12), (1, 6, 4, 1024))] + [("spp_pools_q8", s) for s in (
        (4, 20, 20, 512), (2, 2, 2, 32), (1, 1, 5, 16), (2, 13, 12, 12),
        (1, 5, 1, 32), (1, 14, 2, 64), (8, 40, 40, 256), (1, 3, 600, 16))]


def pool_extra_rows(torch, dev) -> list[dict]:
    """K6 and K8 at POOL_EXTRA's maps, contiguous and as a view 4 bytes into
    a buffer: identical to the plain version, and a second call identical
    to the first."""
    rows = []
    for i, (name, shape) in enumerate(POOL_EXTRA):
        mod = q8_module(name)
        g = torch.Generator(device=dev).manual_seed(300 + i)
        x0 = torch.randint(-128, 128, shape, generator=g, device=dev,
                           dtype=torch.int8)
        for offset in (0, 4):
            x = x0
            if offset:
                buf = torch.zeros(x0.numel() + offset, dtype=torch.int8,
                                  device=dev)
                buf[offset:] = x0.reshape(-1)
                x = buf[offset:].view(shape)
            got = getattr(mod, name)(x)
            same = torch.equal(got, getattr(mod, name)(x))
            ok = torch.equal(got, getattr(mod, name + "_plain")(x)) and same
            rows.append({"kernel": name, "shape": list(shape),
                         "offset": offset, "identical": ok})
            if not ok:
                raise AssertionError(f"{name} differs from its plain version "
                                     f"or from itself: {rows[-1]}")
    return rows


def phase_kernels_q8(torch, dev, errs):
    """K4-K6 against their plain versions at every backbone shape; K6 and
    K8 at POOL_EXTRA's maps."""
    rows = []
    for i, row in enumerate(backbone_q8_shapes()):
        kfn, pfn, _, out_s, _, _, _ = q8_case(torch, row, 4, dev, 100 + i)
        (got, route), ref = k4_call(kfn), pfn()
        torch.cuda.synchronize()
        err, off1, off_more = q8_diff(torch, got, ref, out_s)
        n = got.numel()
        r = {"shape": row[0], "kernel": row[1], "out": list(got.shape),
             "dtype": str(got.dtype), "max_abs_err": err,
             "lsb_off_by_1": off1, "lsb_off_by_more": off_more}
        if row[1] == "conv3x3_q8":
            r["route"] = route
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
    pools = pool_extra_rows(torch, dev)
    emit({"phase": "kernels_q8_vs_plain", "ok": True, "batch": 4,
          "tolerance": "int8 identical but for +-1 LSB on <= 1e-4 of the "
                       "elements; float exit atol = rtol = 1e-5; pools "
                       "identical", "shapes": rows, "pools": pools})


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
    K11; or, with ``der_fast="xla_q8"``, the float32 model with the DER
    blocks int8-resident on K4 / K5): 3 requests, the launch counts of that
    run, responses equal to direct engine calls."""
    import numpy as np

    from rep_yolo_tpu_torch.data.letterbox import letterbox_batch
    from rep_yolo_tpu_torch.models.region import Q8Region
    from rep_yolo_tpu_torch.ops.kernels import conv_flat as KC
    from rep_yolo_tpu_torch.ops.kernels import launch_counts, \
        reset_launch_counts
    from rep_yolo_tpu_torch.serve import build_engine, make_server

    size, max_batch = SIZE, 4
    t0 = time.perf_counter()
    engine = build_engine(CFG, str(GOLDEN / "model_weights.npz"), size,
                          max_batch, conf=0.001, iou=0.45, device=dev,
                          fast=fast, der_fast=der_fast,
                          dtype=torch.bfloat16 if der_fast == "bf16"
                          else torch.float32)
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
        k4 = dict(KC.LAUNCHES_K4_ROUTE)
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    n_fwd = len(requests)
    q8 = {} if fast != "int8" else \
        Q8_PER_FORWARD if neck else Q8_BACKBONE_PER_FORWARD
    cm = {"bf16": CM_PER_FORWARD, "xla_q8": XLQ_PER_FORWARD}.get(der_fast, {})
    per_fwd = {"axial_project": 12, "axial_attend_criss_cross": 6,
               "axial_attend_vertical": 6, "nms_keep": 1, **q8, **cm}
    want = {k: per_fwd.get(k, 0) * n_fwd for k in launch_counts()}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    engine_key = "xla_q8" if der_fast == "xla_q8" else None if fast is None \
        else "int8" if neck else "int8_backbone"
    want_k4 = {r: K4_ROUTES_PER_FORWARD.get(engine_key, {}).get(r, 0) * n_fwd
               for r in K4_ROUTES}
    if k4 != want_k4:
        raise AssertionError(f"K4 launches by route {k4} != {want_k4}")
    counts.update({f"conv3x3_q8@{r}": v for r, v in k4.items()})
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
    emit({"phase": f"serving_{der_fast}" if der_fast else "serving"
          if fast is None else f"serving_{fast}" + ("" if neck else "_backbone"),
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
    if any(s in low for s in ("axial_project", "axial_attend",
                              "axial_vertical")):
        return "attention kernels (K1, K2)"
    if "_q8_cm_kernel" in low:
        return "channel-major int8 conv kernels (K13, K14)"
    if "conv3x3_q8" in low or "conv1x1_q8" in low:
        return "int8 conv kernels (K4, K5)"
    if "max_pool2_q8" in low:
        return "int8 pool kernel (K6)"
    if "dwconv5x5_q8" in low:
        return "int8 depthwise kernel (K7)"
    if "spp_pools_q8" in low:
        return "int8 SPP pyramid kernel (K8)"
    if any(s in low for s in ("conv3x3_wgmma", "conv1x1_wgmma",
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


# The profiler has lost a prefix of a window's device events: after the
# training phases 12-20 events of every window, and in one run one event of
# every window from the timing phases on. So every window opens with
# PROLOGUE launches of the spin kernel behind ``torch.cuda._sleep`` (no
# memory traffic), which take up such a loss and are left out of every sum
# and count; ``profiled_whole`` lengthens the prologue where none of it was
# recorded.
PROLOGUE = 32
SPIN_CYCLES = 100_000       # ~50 us a launch at the H100's clock
SPIN = "spin_kernel"


def profiled(torch, fn, reps: int, counts: bool = False,
             prologue: int = PROLOGUE):
    """Run ``fn`` ``reps`` times under torch.profiler, after ``prologue``
    spin launches: (host wall ms per run, {kernel name: device ms per run},
    device events recorded; with ``counts``, {kernel name: events
    recorded}; spin events recorded). The spin kernel is in none of the
    first three."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(prologue):
            torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / reps
    names: dict[str, float] = {}
    events, per_name, spins = 0, {}, 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if SPIN in e.key:
            spins += e.count
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            names[e.key] = names.get(e.key, 0.0) + us / 1e3 / reps
            events += e.count
            per_name[e.key] = per_name.get(e.key, 0) + e.count
    return wall, names, per_name if counts else events, spins


def profiled_whole(torch, fn, reps: int, tries: int = 5,
                   per_name: bool = False):
    """``profiled`` until a window holds a non-zero whole multiple of
    ``reps`` device events (``fn`` launches the same kernels each call);
    with ``per_name``, of each kernel name's events. The profiler now and
    then drops some or all of a window's events (about one window in a
    hundred on the card, a one-call window among them), so such a window is
    measured again: with a prologue four times as long where the loss took
    all of it, and after a window with no device event at all, a pause
    first (one chip run lost every event of five windows in a row)."""
    prologue = PROLOGUE
    for _ in range(tries):
        wall, names, events, spins = profiled(torch, fn, reps,
                                              counts=per_name,
                                              prologue=prologue)
        whole = (all(n % reps == 0 for n in events.values()) if per_name
                 else events % reps == 0)
        if events and whole:
            return wall, names, events
        if not spins:
            prologue *= 4
        if not events:
            torch.cuda.synchronize()
            time.sleep(0.5)
    raise AssertionError(f"the profiler recorded {events} device events "
                         f"for {reps} calls in each of {tries} tries (the "
                         f"last after a prologue of {prologue} launches)")


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
              whole: bool = True, windows: int = 1) -> float:
    """Device ms per call of ``fn`` from a cold L2 (each call follows an
    ``l2_flush``, so its inputs come from HBM as in a served forward): the
    sum of its kernels' device times under the profiler, without the
    host's launch gaps between them or the flush, in a window where every
    kernel's events (the flush's too) are whole for all ``reps`` calls: a
    window that lost as many flush events as kernel events would still hold
    a whole multiple in all. ``whole=False`` is for a ``fn`` whose library
    calls launch a varying number of kernels: the median of three windows,
    none of them checked for dropped events. ``windows`` > 1: the median of
    that many whole windows, for a window whose event counts are whole but
    whose time is not (a batch-128 1x1 once read half its CUDA-event
    time)."""
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
    return statistics.median(
        sum(ms for k, ms in profiled_whole(torch, call, reps,
                                           per_name=True)[1].items()
            if k not in skip) for _ in range(windows))


def _profile_once(torch, engine, x, reps, whole=True):
    """(wall ms, device ms by category, device ms by kernel) per served
    batch; ``whole=False`` takes the first window as it comes (at batch
    128 the windows hold a few device events more than a whole multiple of
    the calls)."""
    x = x.to(engine.dtype)
    engine.infer(x)
    wall, names, _ = (profiled_whole(torch, lambda: engine.infer(x), reps)
                      if whole else profiled(torch, lambda: engine.infer(x),
                                             reps)[:3])
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


def pool_launches(name, shape) -> dict:
    """The (grid, block, dynamic shared memory) of K6's or K8's launch on a
    contiguous int8 map of ``shape``: ``design`` as the kernel picks it
    (``launch_dims``, ``spp_launch_dims``), ``previous`` in the design
    before (K6: one thread a 16-byte output vector, at most 132 x 32 blocks
    of 256; K8: a block of 256 a vector slot and image, the whole map twice
    in shared memory)."""
    from rep_yolo_tpu_torch.ops.kernels import neck_flat as KNF
    from rep_yolo_tpu_torch.ops.kernels import pool_flat as KP

    B, H, W, C = shape
    vec = 16 if C % 16 == 0 else 4
    if name == "max_pool2_q8":
        n = B * (H // 2) * (W // 2) * (C // vec)
        return {"design": KP.launch_dims(B, H, W, C),
                "previous": ((min(-(-n // 256), 132 * 32),), (256,), 0)}
    return {"design": KNF.spp_launch_dims(B, H, W, C),
            "previous": ((C // vec, B), (256,), 2 * H * W * vec)}


def floor_times(torch, kfn, name, shape) -> dict:
    """The launch floor beside a K6 / K8 call: the empty kernel
    (``csrc/launch_floor.cu``) at the call's grid, block and shared memory
    (``floor_ms``) and at the previous design's (``floor_previous_design_
    ms``), each timed under the profiler in the windows that time ``kfn``:
    every call of ``kfn`` from a cold L2 is followed by one empty launch, as
    ``device_ms`` times a kernel. ``warm_ms``: the call's own device time
    back to back, its input L2-resident as in a served forward, where the
    kernel before wrote it."""
    from rep_yolo_tpu_torch.ops.kernels.launch_floor import (KERNEL_NAME,
                                                             launch_floor)

    flush, _ = l2_flush(torch)
    out = {}
    shapes = pool_launches(name, shape)
    for key, (grid, block, smem) in (("floor_ms", shapes["design"]),
                                     ("floor_previous_design_ms",
                                      shapes["previous"])):
        def call(grid=grid, block=block, smem=smem):
            flush()
            kfn()
            launch_floor(grid, block, smem)

        for _ in range(3):
            call()
        _, names, _ = profiled_whole(torch, call, 10, per_name=True)
        out[key] = sum(ms for k, ms in names.items() if KERNEL_NAME in k)
    for _ in range(3):
        kfn()
    out["warm_ms"] = sum(profiled_whole(torch, kfn, 10, per_name=True)[1]
                         .values())
    out["launch"] = {k: {"grid": list(g), "block": list(b), "smem": m}
                     for k, (g, b, m) in shapes.items()}
    return out


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


def copy_yardsticks(row: dict, agg: dict) -> None:
    """The same-function yardsticks' sums (``add_yardsticks``) into a
    kernels-line row."""
    for k, v in agg.items():
        if k.startswith(LIB_KEYS):
            row[k] = v


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
        qk_ms = device_ms(torch, lambda: torch.matmul(x, wqk.t()))
        add_times(agg["axial_project"], t, 2)
        agg["axial_project"]["qk_product_only_ms"] = \
            agg["axial_project"].get("qk_product_only_ms", 0.0) + 2 * qk_ms
        per_shape.append({"kernel": "axial_project",
                          "shape": [batch, h, w, c], **t,
                          "qk_product_only_ms": qk_ms})

    import numpy as np

    rng = np.random.default_rng(3)
    K = 1024
    c = rng.uniform(0, 640, (batch, K, 2))
    wh = rng.uniform(10, 60, (batch, K, 2))
    boxes = torch.as_tensor(np.concatenate([c - wh / 2, c + wh / 2], -1),
                            dtype=torch.float32, device=dev)
    valid = torch.ones((batch, K), dtype=torch.bool, device=dev)
    t = nms_times(torch, boxes, valid, 0.45)
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
    kernels[3].update(mask_ms=t["mask_ms"], scan_ms=t["scan_ms"])
    kernels[0]["qk_product_only_ms"] = agg["axial_project"][
        "qk_product_only_ms"]
    kernels[0]["qk_product_only"] = "torch.matmul(x, wqk.t()) alone: a " \
        "partial yardstick (no single call computes K1)"
    emit({"phase": "times", "ok": True, "batch": batch,
          "note": f"attention rows sum the six {SIZE}-px CCVA shapes of one "
                  "served batch (the projection twice per CCVA); nms_keep "
                  "at K=1024, batch 4 (mask_ms, scan_ms: its two kernels "
                  "launched apart); ms, plain_ms: device time under the "
                  "profiler from a cold L2, 10 calls after 3 warm-ups; "
                  "event_ms: CUDA events, median of 20 runs of 10 "
                  "back-to-back calls (L2-warm); qk_product_only_ms: "
                  "torch.matmul(x, wqk.t()) alone, q/k product only",
          "per_shape": per_shape,
          "previous_design_ms": {k: PREVIOUS_MS[k] for k in (
              "axial_project", "axial_attend_vertical",
              "axial_attend_criss_cross", "nms_keep")}})
    return kernels


def nms_times(torch, boxes, valid, thr) -> dict:
    """K3's times at one input (``kernel_times``), its mask kernel and scan
    timed apart (``mask_ms``, ``scan_ms``: device time under the profiler,
    as ``ms``), and its bound: the boxes read and the keep mask written once,
    K (K - 1) / 2 IoUs of 12 operations."""
    from rep_yolo_tpu_torch.ops.kernels import nms as KN

    t = kernel_times(torch, lambda: KN.nms_keep(boxes, valid, thr),
                     lambda: KN.nms_keep_plain(boxes, valid, thr))
    mask_fn, scan_fn, _ = KN.nms_stages(boxes, valid, thr)
    mask_fn()
    t["mask_ms"] = device_ms(torch, mask_fn)
    t["scan_ms"] = device_ms(torch, scan_fn)
    B, K = valid.shape
    nb, nf = B * K * (16 + 1 + 1), B * K * (K - 1) / 2 * 12
    t.update(zip(("bound_ms", "bound_by"), bound(nb, nf)), bytes=nb, ops=nf)
    return t


def phase_times_q8(torch, dev, counts, errs, calls):
    """K4-K6 per backbone shape (batch 4, random weights and maps) and
    K4-K8 per distinct int8 call of layers NECK_FIRST.. of one served
    forward (``calls``, its real inputs): kernel, plain version, bound and
    the PyTorch yardstick of the same shape. The kernels line's rows sum one
    forward (each shape times its calls per forward), backbone and neck."""
    from rep_yolo_tpu_torch.ops.kernels import reset_launch_counts

    agg = {n: {} for n in Q8_KERNELS}
    per_shape, pool_calls = [], []
    backbone = {n: {} for n in Q8_KERNELS}
    by_route = {r: {} for r in K4_ROUTES}      # K4's calls by route
    for i, row in enumerate(backbone_q8_shapes()):
        kfn, pfn, lib, _, nbytes, ops, extra = q8_case(torch, row, 4, dev,
                                                       200 + i)
        t = kernel_times(torch, kfn, pfn, lib)
        time_yardsticks(torch, t, extra())
        t.update(zip(("bound_ms", "bound_by"), bound(nbytes, ops, INT8_PEAK)),
                 bytes=nbytes, ops=ops)
        if row[1] == "max_pool2_q8":
            t.update(floor_times(torch, kfn, row[1],
                                 (4, row[4], row[4], row[2][0])))
            pool_calls.append({"call": row[0], "kernel": row[1],
                               "shape": [4, row[4], row[4], row[2][0]], **t})
        sums = [agg[row[1]], backbone[row[1]]]
        if row[1] == "conv3x3_q8":
            t["route"] = k4_call(kfn)[1]
            sums.append(by_route[t["route"]])
        for a in sums:
            add_times(a, t, row[-1])
            add_yardsticks(a, t, row[-1], row[0])
        per_shape.append({"shape": row[0], "kernel": row[1],
                          "calls_per_forward": row[-1], **t})
    # the neck: each distinct call once, then summed per forward and layer
    timed: dict = {}
    by_layer: dict = {}
    for layer, name, args in calls:
        if layer < NECK_FIRST:
            continue
        kfn, pfn, lib, _, nbytes, ops, sig, extra = call_case(torch, name,
                                                              args)
        if sig not in timed:
            t = kernel_times(torch, kfn, pfn, lib)
            time_yardsticks(torch, t, extra())
            t.update(zip(("bound_ms", "bound_by"),
                         bound(nbytes, ops, INT8_PEAK)),
                     bytes=nbytes, ops=ops)
            if name == "conv3x3_q8":
                t["route"] = k4_call(kfn)[1]
            if name in ("max_pool2_q8", "spp_pools_q8"):
                t.update(floor_times(torch, kfn, name, sig[1]))
                pool_calls.append({"call": f"layer {layer}", "kernel": name,
                                   "shape": list(sig[1]), **t})
            timed[sig] = {"kernel": name, "signature": str(sig[1:]),
                          "calls_per_forward": 0, **t}
        row = timed[sig]
        row["calls_per_forward"] += 1
        for a in [agg[name]] + ([by_route[row["route"]]]
                                if name == "conv3x3_q8" else []):
            add_times(a, row)
            add_yardsticks(a, row, 1, f"l{layer} {sig[1:]}")
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
        if name in ("max_pool2_q8", "spp_pools_q8"):
            calls_ = [c for c in pool_calls if c["kernel"] == name]
            for k in ("floor_ms", "floor_previous_design_ms"):
                row[k] = sum(c[k] for c in calls_)
            row["calls"] = [
                {"call": c["call"], "shape": c["shape"],
                 **{k: c[k] for k in ("ms", "warm_ms", "bound_ms",
                                      "floor_ms", "floor_previous_design_ms",
                                      "plain_ms", "library_ms")}}
                for c in calls_]
        if name == "conv3x3_q8":
            routes = route_rows(by_route, {
                r: counts[f"conv3x3_q8@{r}"] for r in K4_ROUTES})
            row["routes"] = routes
            row["routes_ran"] = [r for r in K4_ROUTES
                                 if routes[r]["launches"] > 0]
        copy_yardsticks(row, agg[name])
        kernels.append(row)
    layers = [{"layer": layer, "kernel": name,
               **{k: v for k, v in t.items() if k != "bound_by"}}
              for (layer, name), t in sorted(by_layer.items())]
    emit({"phase": "times_q8", "ok": True, "batch": 4,
          "note": f"rows sum one {SIZE}-px forward (each shape times its "
                  "calls per forward): the backbone's shapes on random "
                  "weights and maps, the neck's calls on the served "
                  "forward's own; library_ms = the f32 cuDNN conv (TF32 "
                  "off) of the same shape; beside it library_int_mm_ms "
                  "(K5: torch._int_mm of the materialised concat) and "
                  "library_bf16_ms (K4: cuDNN's bf16 conv of the int8-"
                  "valued map, channels_last), each over the calls it "
                  "takes, with the kernel's ms over the same calls (_kernel_"
                  "ms) and the calls it refuses (_refused); for K7 the f32 "
                  "depthwise conv, "
                  "for K6 one amax over the (B, H/2, 2, W/2, 2, C) view, for "
                  "K8 three F.max_pool2d and a torch.cat (a sequence, not "
                  "one call); pool_calls: each K6 / K8 call beside floor_ms, "
                  "the empty kernel at its grid, block and shared memory "
                  "(floor_previous_design_ms: at the previous design's), "
                  "timed in the windows that time the call, each call "
                  "followed by one empty launch, and warm_ms, the call "
                  "back to back (its input L2-resident); ms, plain_ms, "
                  "library_ms: device time under the profiler from a cold "
                  "L2, 10 calls after 3 warm-ups; "
                  "event_ms: CUDA events, median of 20 runs of 10 "
                  "back-to-back calls (L2-warm)",
          "per_shape": per_shape, "neck_calls": list(timed.values()),
          "pool_calls": [{k: v for k, v in c.items()
                          if k not in ("bytes", "ops")} for c in pool_calls],
          "neck_by_layer": layers,
          "backbone_per_forward": {
              n: {k: v for k, v in a.items() if k not in ("bytes", "ops")}
              for n, a in backbone.items() if a},
          "conv3x3_q8_by_route": kernels[0]["routes"],
          "previous_design_ms": {k: PREVIOUS_MS[k] for k in (
              "conv1x1_q8", "conv1x1_q8_backbone", "conv3x3_q8",
              "conv3x3_q8_s2_dp4a", "dwconv5x5_q8", "max_pool2_q8",
              "spp_pools_q8")},
          "previous_design_ms_per_call": PREVIOUS_MS_POOL})
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
        kfn, pfn, _, out_s, _, _, sig, _ = call_case(torch, name, args)
        (got, route), ref = k4_call(kfn), pfn()
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
        if name == "conv3x3_q8":
            r["route"] = route
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
    k7 = [r for r in rows if r["kernel"] == "dwconv5x5_q8"]
    emit({"phase": "kernels_neck_vs_plain", "ok": True, "batch": 4,
          "calls": len(rows), "cases": need,
          "dwconv5x5_q8_bit_exact": f"{sum(r['max_abs_err'] == 0 for r in k7)}"
                                    f" of {len(k7)} calls",
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
    its calls per forward). The kernels line's rows are batch 4's; the
    mma.sync design's times stand in this phase's line, not in the kernels
    line, which holds only what this run measured."""
    from rep_yolo_tpu_torch.ops.kernels import reset_launch_counts

    agg = {b: {n: {} for n in CM_PER_FORWARD} for b in batches}
    per_shape = []
    for b in batches:
        for i, row in enumerate(der_cm_shapes()):
            name, kfn, pfn, lib, nbytes, ops = cm_case(
                torch, row, b, dev, 500 + i, torch.bfloat16)
            t = {"ms": device_ms(torch, kfn, windows=3),
                 "event_ms": cuda_ms(kfn, runs=10),
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
        if len(batches) > 1:
            row[f"ms_batch{batches[1]}"] = agg[batches[1]][name]["ms"]
        kernels.append(row)
    emit({"phase": "times_cm", "ok": True, "dtype": "bfloat16",
          "note": f"per forward at {SIZE} px: each shape times its calls per "
                  "forward; ms, plain_ms, library_ms: device time under the "
                  "profiler from a cold L2, 10 calls after 3 warm-ups, "
                  "median of 3 windows; event_ms: CUDA events, median of 10 "
                  "runs of 10 back-to-back calls (L2-warm); bound_ms: bytes "
                  "over 3.35 TB/s or FLOPs over 989 TFLOP/s; "
                  "previous_design_ms: the mma.sync design's ms per forward "
                  "by batch, as this script measured it before (PERF.md)",
          "per_forward": {str(b): {n: {k: v for k, v in agg[b][n].items()}
                                   for n in CM_PER_FORWARD}
                          for b in batches},
          "launches_per_forward": CM_PER_FORWARD,
          "previous_design_ms": {n: PREVIOUS_MS_CM[n] for n in CM_PER_FORWARD},
          "per_shape": per_shape})
    return kernels


# ---------------------------------------------------------------------------
# the last five kernels: K13 / K14 (rows 5, 6), K4 with 5x5 taps (row 9,
# dense), the pixel-major wrappers on K4 / K5 (rows 11, 12); the DER blocks'
# "xla_q8" mode and the kernel benches
# ---------------------------------------------------------------------------

# launches of one forward with der_fast="xla_q8", at any size: the four DER
# blocks' six 3x3 and seven 1x1 convs, each a pixel-major call on K4 / K5
XLQ_PER_FORWARD = {"conv3x3_pm_q8": 24, "conv1x1_pm_q8": 28,
                   "conv3x3_q8": 24, "conv1x1_q8": 28}
PM_KERNELS = ("conv3x3_pm_q8", "conv1x1_pm_q8")
Q8_REST_TOL = ("int8 identical but for +-1 LSB on <= 1e-4 of the elements; "
               "bfloat16 within one bfloat16 ulp (of the larger magnitude); "
               "float32 atol = rtol = 1e-5; the dense 5x5 with block-diagonal "
               "weights identical to K7")
# the "xla_q8" network: against its plain path (max err / max|ref| per
# level), and against the float32 engine (the JAX test's gates for the
# int8 DER chain, tests/test_conv_kernel.py:179-183)
XLQ_PLAIN_REL = 1e-4
XLQ_FLOAT_REL, XLQ_FLOAT_CORR = 0.15, 0.99
# the dense 5x5's other yardsticks: the dense conv in bf16, the depthwise
# conv (the function of the calls' weights, not of the kernel) and K7
DENSE_EXTRA_KEYS = ("library_bf16_ms", "library_depthwise_ms", "k7_ms")
# the kernels line's description of the two rows redesigned on K4's int8
# wgmma core (csrc/conv_wgmma.cuh)
DESIGNS = {"conv3x3_cmajor_q8": "K4's stride-1 int8 wgmma core on NCHW "
                                "input: 16-byte plane loads quantized in "
                                "registers, __byte_perm into the K-major "
                                "operand, the nine taps as descriptor "
                                "offsets, a [channel][pixel] epilogue tile, "
                                "4 pixels a store",
           "conv5x5_q8": "K4's stride-1 int8 wgmma core with 25 taps as "
                         "descriptor offsets over a (th + 4) x (tw + 4) "
                         "halo'd tile, three stages (dense5_route: wgmma "
                         "on int8 input)"}
BENCH_BATCH = 8          # the kernel benches' batch here
BENCH_ITERS = 5          # back-to-back calls per timed run (standalone: 20)
S_IN_BENCH = 0.5 / 127.0


def q8_rest_gate(torch, got, ref, out_s):
    """(max abs err in float units, ok, detail) of one output against its
    plain version, by Q8_REST_TOL."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        return math.inf, False, {"got": [str(got.dtype), list(got.shape)],
                                 "ref": [str(ref.dtype), list(ref.shape)]}
    if got.dtype == torch.int8:
        err, off1, more = q8_diff(torch, got, ref, out_s)
        return err, more == 0 and off1 <= 1e-4 * got.numel(), {
            "lsb_off_by_1": off1, "lsb_off_by_more": more}
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(torch.maximum(g.abs(), r.abs()))
        bad = int((d > torch.ldexp(torch.ones_like(g), e - 8)).sum())
    else:
        bad = int((d > 1e-5 + 1e-5 * r.abs()).sum())
    return float(d.max()), bad == 0, {"beyond_tolerance": bad}


def _conv_weights(torch, cout, cin, k, dev, g):
    w = torch.randn((cout, cin, k, k), generator=g, device=dev) \
        / (cin * k * k) ** 0.5
    return w, 0.1 * torch.randn((cout,), generator=g, device=dev)


def phase_kernels_q8_rest(torch, dev, errs, neck_calls):
    """K13 / K14 at kernel_bench's 15 shapes and the JAX test's shapes,
    batch 2, float32, bfloat16 and int8 inputs, bfloat16 and int8 outputs
    (K14 over three sections at the cv1 shapes); the pixel-major pair at the
    flagship's DER shapes, batch 2, ReLU included; then the dense 5x5 at the
    18 depthwise calls of one int8 forward (``neck_calls``, batch 4), with
    the block-diagonal weights the JAX dw5_dense route builds: first the 18
    calls alone (their launches are the row's), then each against K7 (bit
    for bit) and against its plain version. K13 / K14 are held again at the
    kernel benches' batch, where their launches are counted, by
    ``phase_times_q8_rest``. Returns ({kernel: launches} of the 18 calls,
    [(call args, block-diagonal QConv)])."""
    from rep_yolo_tpu_torch.ops.kernels import conv_flat as KC
    from rep_yolo_tpu_torch.ops.kernels import conv_kernel as KCM
    from rep_yolo_tpu_torch.ops.kernels import conv_pm as KPM
    from rep_yolo_tpu_torch.ops.kernels import launch_counts, \
        reset_launch_counts
    from rep_yolo_tpu_torch.ops.kernels import neck_flat as KNF
    from rep_yolo_tpu_torch.ops.quant import quantize
    from rep_yolo_tpu_torch.tools.kernel_bench import SHAPES

    rows = []

    def check(name, kfn, pfn, out_s, **info):
        (got, route), ref = k4_call(kfn), pfn()
        torch.cuda.synchronize()
        err, ok, detail = q8_rest_gate(torch, got, ref, out_s)
        r = {"kernel": name, **info, "out": list(got.shape),
             "dtype": str(got.dtype), "max_abs_err": err, **detail}
        if route is not None:
            r["route"] = route
        rows.append(r)
        if not ok:
            raise AssertionError(f"{name} differs from its plain version: "
                                 f"{r}")
        errs[name] = max(errs.get(name, 0.0), err)

    s_in = 4.0 / 127.0
    shapes = [(k, C, O, H, H) for k, C, O, H in SHAPES] + [
        (3, 48, 48, 16, 64), (3, 24, 48, 16, 64), (3, 16, 32, 16, 64),
        (1, 48, 24, 16, 64)]
    for i, (k, C, O, H, W) in enumerate(shapes):
        g = torch.Generator(device=dev).manual_seed(600 + i)
        qw = KCM.CMQConv(*_conv_weights(torch, O, C, k, dev, g))
        x = torch.randn((2, C, H, W), generator=g, device=dev)
        name = "conv3x3_cmajor_q8" if k == 3 else "conv1x1_cmajor_q8"
        kf, pf = getattr(KCM, name), getattr(KCM, name + "_plain")
        out_s = float(pf(x, qw, s_in).float().abs().max()) / 127.0
        for xi in (x, x.bfloat16(), quantize(x, s_in)):
            if k == 1 and C % 3 == 0 and C >= 144 and xi.dtype == torch.int8:
                xi = [t.contiguous() for t in xi.chunk(3, 1)]
            tile = ({"tile": list(KCM.k13_route(C, O, 2, H, W, xi.dtype))}
                    if k == 3 else {})
            for o in (None, out_s):
                check(name, lambda: kf(xi, qw, s_in, "silu", o),
                      lambda: pf(xi, qw, s_in, "silu", o), o,
                      shape=[2, C, H, W, O, k],
                      sections=len(xi) if isinstance(xi, list) else 1,
                      input=str(xi[0].dtype if isinstance(xi, list)
                                else xi.dtype), **tile)
    for i, row in enumerate(der_cm_shapes()):
        label, k, cins, cout, hw, _ = row
        g = torch.Generator(device=dev).manual_seed(700 + i)
        qw = KC.QConv(*_conv_weights(torch, cout, sum(cins), k, dev, g))
        xs = [torch.randn((2, hw * hw, c), generator=g, device=dev)
              for c in cins]
        if k == 3:
            name, kf, pf = ("conv3x3_pm_q8", KPM.conv3x3_pm_q8,
                            KPM.conv3x3_pm_q8_plain)
            x = xs[0]
            out_s = float(pf(x, qw, s_in, hw, hw).float().abs().max()) / 127
            cases = [(x, "silu", None), (x.bfloat16(), "relu", None),
                     (quantize(x, s_in), "silu", out_s),
                     (quantize(x, s_in), "relu", out_s)]
            for xi, act, o in cases:
                check(name, lambda: kf(xi, qw, s_in, hw, hw, act, o),
                      lambda: pf(xi, qw, s_in, hw, hw, act, o), o,
                      shape=label, input=str(xi.dtype), act=act)
        else:
            name, kf, pf = ("conv1x1_pm_q8", KPM.conv1x1_pm_q8,
                            KPM.conv1x1_pm_q8_plain)
            out_s = float(pf(xs, qw, s_in).float().abs().max()) / 127
            q = [quantize(t, s_in) for t in xs]
            cases = [(xs, "relu", None), (q, "silu", None), (q, "silu", out_s),
                     (q, "relu", out_s)]
            for xi, act, o in cases:
                check(name, lambda: kf(xi, qw, s_in, act, o),
                      lambda: pf(xi, qw, s_in, act, o), o, shape=label,
                      sections=len(xi), input=str(xi[0].dtype), act=act)
    # row 9, dense: the depthwise calls as the dw5_dense route runs them
    dw = [(args, KC.block_diagonal(args["qd"]))
          for _, name, args in neck_calls if name == "dwconv5x5_q8"]
    torch.cuda.synchronize()
    reset_launch_counts()
    outs = [KC.conv5x5_q8(a["x"], bd, a["s_in"], a["act"], a["out_scale"])
            for a, bd in dw]
    torch.cuda.synchronize()
    bd_counts = launch_counts()
    bd_counts.update({f"conv5x5_q8@{r}": n
                      for r, n in KC.LAUNCHES_DENSE5_ROUTE.items()})
    same = []
    for (a, bd), got in zip(dw, outs):
        ref = KNF.dwconv5x5_q8(**a)
        same.append(bool(torch.equal(got, ref)))
        B, H, W, C = a["x"].shape
        check("conv5x5_q8", lambda: got,
              lambda: KC.conv5x5_q8_plain(a["x"], bd, a["s_in"], a["act"],
                                          a["out_scale"]), a["out_scale"],
              shape=list(a["x"].shape), block_diagonal=True,
              identical_to_k7=same[-1], route=list(KC.dense5_route(
                  C, bd.c_out, B, H, W, a["x"].dtype, a["x"].data_ptr())))
    if len(dw) != DW5_PER_FORWARD or not all(same):
        raise AssertionError(f"the dense 5x5 with block-diagonal weights "
                             f"differs from K7: {len(dw)} calls, {same}")
    want = {"wgmma": DW5_PER_FORWARD, "wgmma_f32": 0, "dp4a": 0}
    if KC.LAUNCHES_DENSE5_ROUTE != want:
        raise AssertionError(f"the dense 5x5's 18 calls by route: "
                             f"{KC.LAUNCHES_DENSE5_ROUTE}, want {want}")
    emit({"phase": "kernels_q8_rest", "ok": True, "tolerance": Q8_REST_TOL,
          "k13_k14_batch": 2, "pm_batch": 2, "dense5x5_batch": 4,
          "dense5x5_launches": bd_counts["conv5x5_q8"],
          "dense5x5_by_route": dict(KC.LAUNCHES_DENSE5_ROUTE), "rows": rows})
    return bd_counts, dw


@contextlib.contextmanager
def plain_pm():
    """Run the "xla_q8" DER blocks through the plain versions (of K4 / K5,
    by way of the pixel-major wrappers)."""
    from rep_yolo_tpu_torch.ops.kernels import conv_pm as KPM

    saved = {n: getattr(KPM, n) for n in PM_KERNELS}
    for n in PM_KERNELS:
        setattr(KPM, n, getattr(KPM, n + "_plain"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(KPM, n, fn)


def der_outputs(torch, m, x):
    """(raw maps, {layer: DER block output as float32}) of one forward,
    whichever path the DER blocks take."""
    from rep_yolo_tpu_torch.nn.blocks import DERBlock

    net, outs = m.net, {}
    der_cm = net._der_cm

    def rec(spec, mod, inp):
        y = der_cm(spec, mod, inp)
        if y is not None:
            outs[spec.i] = y.float()
        return y

    hooks = [mod.register_forward_hook(
        lambda _m, _a, y, i=i: outs.__setitem__(i, y.float()))
        for i, mod in enumerate(net.model) if isinstance(mod, DERBlock)]
    net._der_cm = rec
    try:
        maps = m.apply(x)
    finally:
        del net._der_cm
        for h in hooks:
            h.remove()
    return maps, outs


def phase_xla_q8_e2e(torch, dev, batch=4):
    """Golden weights, fused, calibrated on serve's calibration batch, at
    SIZE px, batch 4, with der_fast="xla_q8", in a float32 net and in one
    cast to bfloat16: the launches of one forward; the four DER blocks'
    outputs and the raw maps against the same net on the plain versions
    (XLQ_PLAIN_REL) and against the float32 net without der_fast
    (XLQ_FLOAT_REL / XLQ_FLOAT_CORR; the golden head's raw maps hardly see
    the backbone, so the DER outputs carry this gate)."""
    import numpy as np

    from rep_yolo_tpu_torch.models.model import RepYOLO
    from rep_yolo_tpu_torch.ops.kernels import launch_counts, \
        reset_launch_counts
    from rep_yolo_tpu_torch.ops.quant import calibrate
    from rep_yolo_tpu_torch.serve import calibration_batch
    from rep_yolo_tpu_torch.utils.weights import load_reference_npz

    m = RepYOLO.from_config(CFG, device=dev).load_state(
        load_reference_npz(GOLDEN / "model_weights.npz")).fuse()
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (batch, SIZE, SIZE, 3)).astype(np.float32)).to(dev)
    maps_f32, der_f32 = der_outputs(torch, m, x)
    scales = calibrate(m, [calibration_batch(SIZE, dev)])
    out, ok = {"phase": "xla_q8_e2e", "batch": batch, "size": SIZE}, True
    for dtype in (torch.float32, torch.bfloat16):
        if dtype != torch.float32:
            m.cast(dtype)
        m.net.set_der_fast("xla_q8", scales=scales)
        xi = x.to(dtype)
        m.apply(xi)                            # quantizes the DER weights
        torch.cuda.synchronize()
        reset_launch_counts()
        maps_k, der_k = der_outputs(torch, m, xi)
        torch.cuda.synchronize()
        seen = {k: launch_counts()[k] for k in XLQ_PER_FORWARD}
        with plain_pm():
            maps_p, der_p = der_outputs(torch, m, xi)
        layers = sorted(der_k)
        plain = [rel_corr(a, b)[0] for a, b in zip(maps_k, maps_p)]
        plain_der = [rel_corr(der_k[i], der_p[i])[0] for i in layers]
        flt = [rel_corr(a, b) for a, b in zip(maps_k, maps_f32)]
        flt_der = [rel_corr(der_k[i], der_f32[i]) for i in layers]
        r = {"launches_per_forward": seen, "raw_map_dtype":
             str(maps_k[0].dtype), "der_layers": layers,
             "der_vs_plain_rel_max_err": plain_der,
             "der_vs_float32_rel_max_err": [e for e, _ in flt_der],
             "der_vs_float32_corr": [c for _, c in flt_der],
             "vs_plain_rel_max_err_per_level": plain,
             "vs_float32_rel_max_err_per_level": [e for e, _ in flt],
             "vs_float32_corr_per_level": [c for _, c in flt]}
        r["ok"] = (seen == XLQ_PER_FORWARD and maps_k[0].dtype == dtype
                   and layers == sorted(der_f32) and len(layers) == 4
                   and all(e < XLQ_PLAIN_REL for e in plain + plain_der)
                   and all(e < XLQ_FLOAT_REL and c > XLQ_FLOAT_CORR
                           for e, c in flt + flt_der))
        out[str(dtype).replace("torch.", "")] = r
        ok &= r["ok"]
    out.update(ok=ok, tolerance={"vs_plain_rel": XLQ_PLAIN_REL,
                                 "vs_float32_rel": XLQ_FLOAT_REL,
                                 "vs_float32_corr": XLQ_FLOAT_CORR})
    emit(out)
    if not ok:
        raise AssertionError(f"xla_q8 end-to-end check failed: {out}")


def phase_kernel_bench(torch, dev):
    """Both kernel benches of the port at batch BENCH_BATCH (BENCH_ITERS
    calls a timed run), in process, their tables on one line. Returns the
    launch counts of that run (K13 / K14's main path)."""
    from rep_yolo_tpu_torch.ops.kernels import launch_counts, \
        reset_launch_counts
    from rep_yolo_tpu_torch.tools import kernel_bench as KB
    from rep_yolo_tpu_torch.tools import kernel_bench_flat as KF

    torch.cuda.synchronize()
    reset_launch_counts()
    lines: list[str] = []
    rows = KB.run(BENCH_BATCH, dev, BENCH_ITERS, out=lines.append)
    rows_f = KF.run(BENCH_BATCH, dev, BENCH_ITERS, out=lines.append)
    torch.cuda.synchronize()
    counts = launch_counts()
    vals = [r[v] for r in rows for v in KB.VARIANTS] + [r["ms"] for r in rows_f]
    ok = (len(rows) == len(KB.SHAPES) and len(rows_f) == 2 * len(KF.CONV3) + 5
          and all(math.isfinite(v) and v > 0 for v in vals))
    emit({"phase": "kernel_bench", "ok": ok, "batch": BENCH_BATCH,
          "iters": BENCH_ITERS,
          "note": "ms per call: CUDA events over back-to-back calls after 3 "
                  "warm-ups, median of 3 runs (L2-warm)",
          "kernel_bench": rows, "kernel_bench_flat": rows_f})
    if not ok:
        raise AssertionError("a kernel bench row is missing or not finite")
    return counts


def record_pm_calls(torch, model, x):
    """One forward of ``model`` on ``x``: [(kernel name, bound arguments)]
    of every pixel-major call, with its real inputs."""
    import inspect

    from rep_yolo_tpu_torch.ops.kernels import conv_pm as KPM

    calls, saved = [], {}
    for name in PM_KERNELS:
        fn = saved[name] = getattr(KPM, name)
        sig = inspect.signature(getattr(KPM, name + "_plain"))

        def rec(*a, _fn=fn, _n=name, _sig=sig, **k):
            b = _sig.bind(*a, **k)
            b.apply_defaults()
            calls.append((_n, dict(b.arguments)))
            return _fn(*a, **k)
        setattr(KPM, name, rec)
    try:
        model.apply(x)
    finally:
        for name, fn in saved.items():
            setattr(KPM, name, fn)
    return calls


def rest_times(torch, kfn, pfn, lib) -> dict:
    """One call's times: ``ms`` the kernel's device time (profiler, cold
    L2), ``event_ms`` back-to-back CUDA events (5 runs of 5), ``plain_ms``
    and ``library_ms`` device time of all kernels of the call (median of 3
    windows; the plain version's float64 convolutions in windows of 2)."""
    return {"ms": device_ms(torch, kfn), "event_ms": cuda_ms(kfn, runs=5,
                                                            reps=5),
            "plain_ms": device_ms(torch, pfn, reps=2, warmup=1,
                                  whole=False),
            "library_ms": device_ms(torch, lib, reps=5, whole=False)}


def phase_times_q8_rest(torch, dev, counts, errs, dw, xlq_engine, x4):
    """Times of the five new rows, each summed over its main path:

    - K13 / K14: kernel_bench's 3x3 / 1x1 shapes at batch BENCH_BATCH, on
      its inputs (``shape_case``), bf16 in and out (its "q8"), against its
      "xla" (cuDNN's bf16 conv) and cuDNN's f32 conv (TF32 off), each with
      the bias, then SiLU. First each shape's "q8" and "q8c" (int8 in and
      out) are held against their plain versions (Q8_REST_TOL), at the
      batch whose launches are the rows';
    - the pixel-major pair: every call of one "xla_q8" served forward at
      batch 4 (``xlq_engine`` on ``x4``), against the f32 cuDNN conv;
    - the dense 5x5: the 18 block-diagonal calls (``dw``), against the dense
      conv of the same weights (cuDNN f32, TF32 off), with the bf16 one, the
      depthwise conv and K7 beside.

    ``counts``: {kernel: launches of its main path}."""
    import torch.nn.functional as F

    from rep_yolo_tpu_torch.ops.kernels import conv_flat as KC
    from rep_yolo_tpu_torch.ops.kernels import conv_kernel as KCM
    from rep_yolo_tpu_torch.ops.kernels import conv_pm as KPM
    from rep_yolo_tpu_torch.ops.kernels import neck_flat as KNF
    from rep_yolo_tpu_torch.ops.kernels import reset_launch_counts
    from rep_yolo_tpu_torch.tools.kernel_bench import SHAPES, shape_case

    names = ("conv3x3_cmajor_q8", "conv1x1_cmajor_q8", "conv5x5_q8",
             "conv3x3_pm_q8", "conv1x1_pm_q8")
    agg = {n: {} for n in names}
    per_shape, checks = [], []
    B = BENCH_BATCH
    for k, C, O, H in SHAPES:
        # kernel_bench's own inputs and calls at this shape
        fns = shape_case(k, C, O, H, B, dev)
        name = "conv3x3_cmajor_q8" if k == 3 else "conv1x1_cmajor_q8"
        for v, out_s in (("q8", None), ("q8c", S_IN_BENCH)):
            got, ref = fns[v](), fns[v + "_plain"]()
            torch.cuda.synchronize()
            err, ok, detail = q8_rest_gate(torch, got, ref, out_s)
            r = {"kernel": name, "variant": v, "shape": [B, C, H, H, O, k],
                 "dtype": str(got.dtype), "max_abs_err": err, **detail}
            checks.append(r)
            if not ok:
                raise AssertionError(f"{name} differs from its plain version "
                                     f"at kernel_bench's batch: {r}")
            errs[name] = max(errs.get(name, 0.0), err)
            del got, ref
        t = rest_times(torch, fns["q8"], fns["q8_plain"], fns["xla"])
        t["library_f32_ms"] = device_ms(torch, fns["xla_f32"], reps=5,
                                        whole=False)
        npix = B * H * H
        nbytes = 2 * npix * (C + O) + O * C * k * k + 8 * O
        ops = 2.0 * npix * O * C * k * k
        t.update(zip(("bound_ms", "bound_by"), bound(nbytes, ops, INT8_PEAK)),
                 bytes=nbytes, ops=ops)
        add_times(agg[name], t)
        agg[name]["library_f32_ms"] = agg[name].get(
            "library_f32_ms", 0.0) + t["library_f32_ms"]
        if k == 3:
            t["tile"] = list(KCM.k13_route(C, O, B, H, H, torch.bfloat16))
        per_shape.append({"kernel": name, "shape": [B, C, H, H, O, k], **t})
        del fns
    # rows 11 / 12: each distinct call of one served "xla_q8" forward
    xi = x4.to(xlq_engine.dtype)
    xlq_engine.infer(xi)
    timed: dict = {}
    by_route = {r: {} for r in K4_ROUTES}      # row 11's calls by route
    for name, a in record_pm_calls(torch, xlq_engine.model, xi):
        out_s = a["out_scale"]
        if name == "conv3x3_pm_q8":
            xs, hw, k = [a["x"]], (a["H"], a["W"]), 3
        else:
            xs = a["xs"] if isinstance(a["xs"], (list, tuple)) else [a["xs"]]
            n = xs[0].shape[1]
            hw, k = (n, 1), 1
        qw = a["qw"]
        sig = (name, tuple(tuple(t.shape) for t in xs), str(xs[0].dtype),
               qw.c_out, out_s is None)
        row = timed.get(sig)
        if row is None:
            Bq = xs[0].shape[0]
            xf = torch.cat(xs, -1).float().reshape(Bq, *hw, -1).permute(
                0, 3, 1, 2).contiguous()
            cin = xf.shape[1]
            wf = qw.w_q.float().permute(0, 3, 1, 2)[:, :cin].contiguous()
            kfn = getattr(KPM, name)
            pfn = getattr(KPM, name + "_plain")
            t = rest_times(torch, lambda: kfn(**a), lambda: pfn(**a),
                           lambda: F.conv2d(xf, wf, qw.bias, padding=k // 2))
            nhwc = [u.reshape(Bq, *hw, -1) for u in xs]
            time_yardsticks(torch, t, same_function_yardsticks(
                torch, name.replace("_pm", ""), nhwc, qw, 1, a["s_in"]))
            npix = Bq * hw[0] * hw[1]
            nbytes = (sum(u.numel() * u.element_size() for u in xs)
                      + qw.w_q.numel() + 8 * qw.c_out
                      + npix * qw.c_out * (2 if out_s is None else 1))
            ops = 2.0 * npix * qw.c_out * cin * k * k
            t.update(zip(("bound_ms", "bound_by"),
                         bound(nbytes, ops, INT8_PEAK)), bytes=nbytes, ops=ops)
            if name == "conv3x3_pm_q8":
                t["route"] = k4_call(lambda: kfn(**a))[1]
            row = timed[sig] = {"kernel": name, "signature": str(sig[1:]),
                                "calls_per_forward": 0, **t}
        row["calls_per_forward"] += 1
        for s_ in [agg[name]] + ([by_route[row["route"]]]
                                 if name == "conv3x3_pm_q8" else []):
            add_times(s_, row)
            add_yardsticks(s_, row, 1, sig[1:])
    # row 9, dense: the 18 block-diagonal calls against the dense conv of the
    # same weights (f32, TF32 off; bf16 beside), the depthwise conv and K7
    dense_rows, extra = [], dict.fromkeys(DENSE_EXTRA_KEYS, 0.0)
    for a, bd in dw:
        x = a["x"]
        C = bd.c_out
        xf = x.permute(0, 3, 1, 2).float().contiguous()
        wd = bd.w_q.float().permute(0, 3, 1, 2)[:, :C].contiguous()
        wf = a["qd"].w_q.float().reshape(C, 1, 5, 5)
        xb, wdb, bb = xf.bfloat16(), wd.bfloat16(), bd.bias.bfloat16()
        t = rest_times(
            torch, lambda: KC.conv5x5_q8(x, bd, a["s_in"], a["act"],
                                         a["out_scale"]),
            lambda: KC.conv5x5_q8_plain(x, bd, a["s_in"], a["act"],
                                        a["out_scale"]),
            lambda: F.conv2d(xf, wd, bd.bias, padding=2))
        t["library_bf16_ms"] = device_ms(
            torch, lambda: F.conv2d(xb, wdb, bb, padding=2), reps=5,
            whole=False)
        t["library_depthwise_ms"] = device_ms(
            torch, lambda: F.conv2d(xf, wf, a["qd"].bias, padding=2,
                                    groups=C), reps=5, whole=False)
        t["k7_ms"] = device_ms(torch, lambda: KNF.dwconv5x5_q8(**a))
        for k in DENSE_EXTRA_KEYS:
            extra[k] += t[k]
        nbytes = (x.numel() * (1 + (4 if a["out_scale"] is None else 1))
                  + bd.w_q.numel() + 8 * C)
        ops = 2.0 * 25 * C * x.numel()          # the dense sum it computes
        t.update(zip(("bound_ms", "bound_by"), bound(nbytes, ops, INT8_PEAK)),
                 bytes=nbytes, ops=ops)
        add_times(agg["conv5x5_q8"], t)
        dense_rows.append({"shape": list(x.shape), "route": list(
            KC.dense5_route(C, C, *x.shape[:3], x.dtype, x.data_ptr())),
            **t})
    reset_launch_counts()
    kernels = []
    for name, src, replaces, lib_call in (
            ("conv3x3_cmajor_q8", "conv_cmajor_q8", "conv_kernel.py:226",
             "F.conv2d (cuDNN, bf16, channels_last, with the bias) then "
             "F.silu: kernel_bench's xla"),
            ("conv1x1_cmajor_q8", "conv_cmajor_q8", "conv_kernel.py:296",
             "F.conv2d (cuDNN, bf16, channels_last, with the bias) then "
             "F.silu: kernel_bench's xla"),
            ("conv5x5_q8", "conv_flat", "conv_flat.py:548",
             "F.conv2d, the dense 5x5 of the block-diagonal weights (cuDNN, "
             "f32, TF32 off, with the bias)"),
            ("conv3x3_pm_q8", "conv_flat", "conv_pm.py:184",
             "F.conv2d (cuDNN, f32, TF32 off, with the bias)"),
            ("conv1x1_pm_q8", "conv_flat", "conv_pm.py:260",
             "F.conv2d (cuDNN, f32, TF32 off, with the bias)")):
        row = kernel_row(name, f"rep_yolo_tpu_torch/csrc/{src}.cu",
                         f"rep_yolo_tpu/ops/pallas/{replaces}", counts[name],
                         errs[name], agg[name], INT8_PEAK)
        row["library_call"] = lib_call
        if "library_f32_ms" in agg[name]:
            row["library_f32_ms"] = agg[name]["library_f32_ms"]
        if name == "conv5x5_q8":
            row.update(extra)
            row["design"] = DESIGNS[name]
            row["routes"] = {r: counts[f"conv5x5_q8@{r}"]
                             for r in KC.LAUNCHES_DENSE5_ROUTE}
        else:
            copy_yardsticks(row, agg[name])
        if name == "conv3x3_cmajor_q8":
            row["design"] = DESIGNS[name]
        if name == "conv3x3_pm_q8":
            routes = route_rows(by_route, {
                r: counts[f"conv3x3_q8@{r}"] for r in K4_ROUTES})
            row["routes"] = routes
            row["routes_ran"] = [r for r in K4_ROUTES
                                 if routes[r]["launches"] > 0]
        kernels.append(row)
    emit({"phase": "times_q8_rest", "ok": True,
          "note": f"K13 / K14 summed over kernel_bench's 3x3 / 1x1 shapes at "
                  f"batch {BENCH_BATCH}, bf16 in and out; the pixel-major pair "
                  "over one served xla_q8 forward at batch 4 (each call times "
                  "its calls per forward); the dense 5x5 over the 18 "
                  "block-diagonal calls at batch 4. ms, library_ms: device "
                  "time under the profiler from a cold L2; event_ms: CUDA "
                  "events, median of 5 runs of 5 back-to-back calls "
                  "(L2-warm); bound_ms: bytes over 3.35 TB/s or int8 ops over "
                  "1,979 TOP/s (the dense 5x5: all 25 C^2 products a pixel); "
                  "the pixel-major pair's same-function yardsticks: "
                  "library_int_mm_ms (row 12, torch._int_mm of the "
                  "materialised concat) and library_bf16_ms (row 11, cuDNN's "
                  "bf16 conv of the int8-valued map), as in times_q8",
          "per_forward": {n: {k: v for k, v in agg[n].items()} for n in names},
          "checks_k13_k14": checks, "tolerance": Q8_REST_TOL,
          "dense5x5_yardsticks": extra,
          "conv3x3_pm_q8_by_route": kernels[3]["routes"],
          "previous_design_ms": {
              k: PREVIOUS_MS[k] for k in ("conv3x3_cmajor_q8",
                                          "conv1x1_cmajor_q8", "conv5x5_q8",
                                          "conv1x1_pm_q8", "conv3x3_q8",
                                          "conv3x3_pm_q8",
                                          "conv3x3_pm_q8_f32_dp4a")},
          "per_shape": per_shape, "pm_calls": list(timed.values()),
          "dense5x5": dense_rows})
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
# ms of the designs that K9 (direct FFMA sum), K14 (32-channel M tiles,
# staged a value at a time), K5 (dp4a, 32 output channels a block), K12
# (a byte a staging load) and K4 (dp4a for every call, before its int8
# wgmma route) had before their current ones, as this script measured them
# on one H100 80GB HBM3 at 700 W (PERF.md, kernel table): K9 per train
# step, K14 over kernel_bench's 1x1 shapes at batch 8, K5 and K4 per
# served int8 forward at batch 4 (and K5's 28 backbone calls), rows 12 and
# 11 per xla_q8 forward at batch 4, K12 per forward at batch 8; and the
# dp4a design of the calls that left it next: row 15 (the PAN's two
# stride-2 calls, now wgmma_s2) per int8 forward and row 11's four float32
# st1s (now wgmma_f32) per xla_q8 forward, both at batch 4; K1 (8 pixels a
# block, a serial dot product a thread) and K2 vertical (8 query pixels a
# block, each warp walking its own column) per served batch of 4, and K2
# vertical on the row-3 route per forward at batch 8; K2 criss-cross in its
# first design (axial_attend_kernel: 8 query pixels of one row a block, a
# warp a query walking its row and column of k and v from L2, a thread a
# channel summing W + H products) per served batch of 4 and on the row-3
# route per forward at batch 8; K3 in its first design (the full K x K/64
# mask, one warp an image scanning the rows with a global load a kept row)
# at K = 1024, batch 4, and at K = 8192, batch 8; K7 in its first design
# (16 x 16 pixels a block, a thread a pixel of 16 channels, 4-byte staging)
# per served int8 forward at batch 4; K6 (a thread a 16-byte output vector)
# and K8 (a block a vector slot of the whole map, six separable passes) in
# their first designs per served int8 forward at batch 4, and per call; K13
# (mma.sync, 32 output channels a block, staged a value at a time) over
# kernel_bench's 3x3 shapes at batch 8 and the dense 5x5 (K4's dp4a kernel
# with 25 taps) over its 18 block-diagonal calls at batch 4, both their
# first designs
PREVIOUS_MS = {"wgrad3x3": 6.166, "conv1x1_cmajor_q8": 3.312,
               "conv3x3_cmajor_q8": 2.672, "conv5x5_q8": 0.945,
               "conv1x1_q8": 3.949, "conv1x1_q8_backbone": 1.445,
               "conv1x1_pm_q8": 1.330, "dwconv5x5_f32w_q8": 0.634,
               "conv3x3_q8": 3.946, "conv3x3_pm_q8": 2.406,
               "conv3x3_q8_s2_dp4a": 0.210,
               "conv3x3_pm_q8_f32_dp4a": 0.652,
               "axial_project": 1.066, "axial_attend_vertical": 0.324,
               "axial_attend_vertical_row3": 0.571,
               "axial_attend_criss_cross": 0.449,
               "axial_attend_criss_cross_row3": 0.817,
               "nms_keep": 0.304, "nms_keep_k8192": 1.535,
               "dwconv5x5_q8": 0.213, "max_pool2_q8": 0.0121167,
               "spp_pools_q8": 0.0079487}
PREVIOUS_MS_POOL = {"max_pool2_q8": {"(4, 80, 80, 256)": 0.0052145,
                                     "(4, 80, 80, 128)": 0.0039485,
                                     "(4, 40, 40, 256)": 0.0029537},
                    "spp_pools_q8": {"(4, 20, 20, 512)": 0.0079487}}
# K10 / K11 per forward at batch 4 and 128 in their mma.sync design, before
# wgmma, as this script measured them on the same card
PREVIOUS_MS_CM = {"conv3x3_cmajor": {"4": 2.326, "128": 51.39},
                  "conv1x1_cmajor": {"4": 1.379, "128": 30.09}}
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
    <= 1e-4 |ref| + 1e-4 max|ref|, and a second call equal to the first bit
    for bit; the error against cuDNN's wgrad (conv2d_weight, TF32 off) as a
    report."""
    rows = []
    for i, shape in enumerate(WGRAD_SHAPES):
        kfn, pfn, lib, _, _ = wgrad_case(torch, shape, dev, 300 + i)
        got, again, ref, cud = kfn(), kfn(), pfn(), lib()
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        same = bool(torch.equal(got, again))
        ok = same and bool(((got - ref).abs() <= 1e-4 * ref.abs()
                            + 1e-4 * scale).all())
        r = {"shape": list(shape[:5]), "convs_per_step": shape[5],
             "max_abs_err": err, "ref_absmax": scale,
             "repeats_bit_for_bit": same,
             "err_vs_cudnn": float((got - cud).abs().max())}
        rows.append(r)
        if not ok:
            raise AssertionError(f"wgrad3x3 differs from its plain version: "
                                 f"{r}")
        errs["wgrad3x3"] = max(errs.get("wgrad3x3", 0.0), err)
    emit({"phase": "kernels_wgrad_vs_plain", "ok": True,
          "tolerance": "rtol 1e-4, atol 1e-4 x max|dW|; two calls identical",
          "shapes": rows})


def train_setup(torch, dev, cfg=CFG, size=SIZE, batch=TRAIN_BATCH, n=16,
                warmup=True, hyp=None):
    """The flagship's training as ``cli.train`` builds it
    (``build_training``: seeded init, scratch.p5, simOTA, nesterov SGD, EMA)
    with ``--no-accumulate`` (the CLI's accumulation also applies the
    optimizer at every call for its first 72 iterations at batch 8), the
    select-all wgrad route, and the synthetic batches (seed 0) on
    the card: (``cli.train.Training``, batches). ``--no-augment`` unless a
    ``hyp`` YAML is given, then augmentation with that hyp."""
    from rep_yolo_tpu_torch.cli import train as cli

    args = cli.parse_args([
        "--cfg", cfg, "--data", f"synthetic:{n}", "--batch-size", str(batch),
        "--img-size", str(size), "--no-autoanchor", "--eval-every", "0",
        "--no-accumulate", "--device", str(dev)]
        + (["--no-augment"] if hyp is None else ["--hyp", str(hyp)]))
    t = cli.build_training(args, warmup=warmup)
    t.model.net.set_wgrad(True, select=lambda c1, c2: True)
    batches = [[torch.from_numpy(b[k]).to(dev)
                for k in ("images", "hw", "labels", "mask")]
               for b in t.loader.epoch(0)]
    return t, batches


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
    if "wgrad3x3" in low:
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


TRAIN_RANGES = ("train/augment", "train/forward", "train/loss",
                "train/backward", "train/optimizer")


def profiled_train(torch, fn, reps: int):
    """``fn`` (one train step) ``reps`` times under torch.profiler: host
    wall ms per step, device ms per step by kernel name, and the device ms
    of the kernels launched inside each of the step's ranges (the
    backward's kernels run on autograd's thread and fall outside it), and
    the launches per step the profiler saw by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / reps
    names, ranges, seen = {}, {}, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if e.key in TRAIN_RANGES and \
                e.device_type == torch.autograd.DeviceType.CUDA:
            continue            # the ranges' own spans on the device
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            names[e.key] = names.get(e.key, 0.0) + us / 1e3 / reps
            seen[e.key] = seen.get(e.key, 0) + e.count / reps
        elif e.key in TRAIN_RANGES:
            tot = getattr(e, "device_time_total", None)
            if tot is None:
                tot = e.cuda_time_total
            ranges[e.key] = tot / 1e3 / reps
    return wall, names, ranges, seen


def phase_train_step(torch, dev, size=SIZE, cfg=CFG, batch=TRAIN_BATCH,
                     warm=3, timed=10):
    """The flagship's train step on the card: warm-ups, then the timed
    steps with the launch counts zeroed just before them and read just
    after; one step's grads with K9 against the plain path; the step's time
    by category under the profiler; peak memory."""
    import numpy as np

    from rep_yolo_tpu_torch.ops.kernels import launch_counts, \
        reset_launch_counts

    t, batches = train_setup(torch, dev, cfg, size, batch)
    model, state, step = t.model, t.state, t.step
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
    wall, names, ranges, seen = profiled_train(
        torch, lambda: step(state, *batches[0]), 3)
    k9_seen = sum(n for k, n in seen.items() if "wgrad3x3_gemm" in k)
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
    fall. cuDNN is held to deterministic algorithms (no autotuning) for the
    phase, so a run repeats its losses: under its nondeterministic ones the
    20th loss once ended above the first. Both settings are restored
    after."""
    import numpy as np

    was = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        t, batches = train_setup(torch, dev, cfg, size, batch, n=batch,
                                 warmup=False)
        state, step = t.state, t.step
        totals = [float(step(state, *batches[0])["total"])
                  for _ in range(steps)]
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = was
    if not (np.isfinite(totals).all() and totals[-1] < totals[0]):
        raise AssertionError(f"the loss did not fall: {totals}")
    emit({"phase": "train_overfit", "ok": True, "steps": steps,
          "cudnn_deterministic": True, "total": totals})


def phase_train_cli(torch, timeout=900, hyp=None):
    """``python -m rep_yolo_tpu_torch.cli.train`` as a user runs it:
    ``--no-augment --no-autoanchor``, or with augmentation and autoanchor on
    and ``--hyp hyp`` (a preset name or a YAML), which must print the
    autoanchor line and write ``anchors.json`` into its run directory."""
    import numpy as np

    cmd = [sys.executable, "-m", "rep_yolo_tpu_torch.cli.train",
           "--data", "synthetic:16", "--epochs", "1", "--batch-size",
           str(TRAIN_BATCH), "--img-size", str(SIZE), "--eval-every", "0"] \
        + (["--no-augment", "--no-autoanchor"] if hyp is None
           else ["--hyp", str(hyp)])
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
    anchor_line, anchors = None, None
    if ok and hyp is not None:
        anchor_line = next((s for s in p.stdout.splitlines()
                            if s.startswith("autoanchor: BPR ")), None)
        run = next((r["run_dir"] for r in lines if "run_dir" in r), None)
        path = ROOT / run / "anchors.json" if run else None
        anchors = json.loads(path.read_text()) \
            if path and path.is_file() else None
        ok = anchor_line is not None and anchors is not None and \
            np.asarray(anchors["anchors_px"]).shape == (3, 3, 2)
    if not ok:
        raise AssertionError(f"cli.train failed (exit {p.returncode}), or "
                             f"printed no autoanchor line / wrote no "
                             f"anchors.json:\n{p.stdout[-3000:]}\n"
                             f"{p.stderr[-3000:]}")
    emit({"phase": "train_cli" if hyp is None else "train_cli_augment",
          "ok": True, "cmd": " ".join(cmd[1:]), "exit": p.returncode,
          "seconds": secs, "steps": steps,
          **({} if hyp is None else {"autoanchor_line": anchor_line,
                                     "anchors_json": anchors})})


# train_augment's two settings: scratch.p5 as shipped (mosaic9 at its
# default 0.2, paste_in 0.15, cutout 0), and the JAX slow test's forcing
# values (tests/test_augment_extra.py), which take every branch at batch 8
AUG_SETTINGS = {"scratch.p5": {},
                "forced": {"mosaic9": 0.5, "paste_in": 0.5, "cutout": 0.3}}
# card against CPU, images on [0, 1]: a 640-px mosaic-9 canvas coordinate
# Minv00 x + Minv02 has terms below 16,384 (scale draws down to 0.1), where
# a float32 ulp is 2**-10 px; 4 ulps times the 255-a-pixel gradient, / 255,
# times HSV's value gain up to 1.4
AUG_IMG_TOL = 4 * 2.0 ** -10 * 1.4
AUG_LABEL_TOL = 1e-5


def augment_hyp(setting: str):
    """The ``--hyp`` of an ``AUG_SETTINGS`` entry: the preset's name, or a
    YAML over scratch.p5 under the gitignored run directory."""
    over = AUG_SETTINGS[setting]
    if not over:
        return setting
    EVAL_RUNS.mkdir(parents=True, exist_ok=True)
    path = EVAL_RUNS / f"hyp_{setting}.yaml"
    path.write_text("".join(f"{k}: {v}\n" for k, v in over.items()))
    return path


def branch_draws(torch, A, acfg, mask, tries=256):
    """Draws from a CPU generator for a batch whose label flags are
    ``mask`` (B, M), at the first seed that takes every branch ``acfg``
    turns on: mosaic-9 and mosaic-4 (where 0 < mosaic9 < 1), cutout on at
    least one image, and paste-in on at least one image with an attempt
    whose source slot holds a label (an attempt draws its slot from all M,
    as in the JAX package, so at M = 120 most draw an empty one). ->
    (seed, draws, the images taking each branch)."""
    batch, slots = mask.shape
    for seed in range(tries):
        d = A.draw_batch(torch.Generator().manual_seed(seed), batch, acfg,
                         slots)
        src = (mask[d.partners[:, 0]] & d.paste_on[:, None]).gather(
            1, d.paste_src)
        taken = {"mosaic9": d.use9, "mosaic4": ~d.use9,
                 "paste_in": src.any(1), "cutout": d.cut_on}
        need = [k for k, p in (("mosaic9", acfg.mosaic9),
                               ("mosaic4", 1 - acfg.mosaic9),
                               ("paste_in", acfg.paste_in),
                               ("cutout", acfg.cutout)) if p > 0]
        if all(bool(taken[k].any()) for k in need):
            return seed, d, {k: taken[k].nonzero().flatten().tolist()
                             for k in need}
    raise AssertionError(f"no seed below {tries} takes every branch")


def phase_train_augment(torch, dev, card, setting="scratch.p5", size=SIZE,
                        cfg=CFG, batch=TRAIN_BATCH, steps=5, reps=3):
    """Augmentation on the flagship's training at 640 px, batch 8, with the
    hyp of ``AUG_SETTINGS[setting]``: one batch's draws from a CPU generator
    (``branch_draws``: every branch the hyp turns on taken), ``augment_batch``
    on the card against the same on the CPU (masks identical, labels within
    ``AUG_LABEL_TOL``, images within ``AUG_IMG_TOL``), and paste-in adding
    labels there where the hyp turns it on; then ``steps`` augmented train
    steps (each step's batch, recomputed from the augment
    generator's state before it, in range: images and valid labels in [0,
    1]; every loss finite); host ms of a step and of the augmentation
    alone; under the profiler the device ms of the step and of its
    ``train/augment`` range."""
    import argparse

    import numpy as np

    from rep_yolo_tpu_torch.cli import train as cli
    from rep_yolo_tpu_torch.data import augment as A
    from rep_yolo_tpu_torch.train.hyp import load_hyp

    hyp = augment_hyp(setting)
    t, batches = train_setup(torch, dev, cfg, size, batch, hyp=hyp)
    acfg = cli.augment_config(argparse.Namespace(
        img_size=size, max_labels=batches[0][2].shape[1]),
        load_hyp(str(hyp)))
    seed, draws, taken = branch_draws(torch, A, acfg, batches[0][3].cpu())
    card_out = A.augment_batch(*batches[0], A.Draws(
        *(d.to(dev) for d in draws)), acfg)
    cpu_out = A.augment_batch(*(b.cpu() for b in batches[0]), draws, acfg)
    torch.cuda.synchronize()
    if card_out.images.device.type != "cuda":
        raise AssertionError("augment_batch left the card")
    img_err = float((card_out.images.cpu() - cpu_out.images).abs().max())
    lab_err = float((card_out.labels.cpu() - cpu_out.labels).abs().max())
    above = int(((card_out.images.cpu() - cpu_out.images).abs()
                 > 1e-5).sum())
    same_mask = bool(torch.equal(card_out.mask.cpu(), cpu_out.mask))
    if not (same_mask and lab_err <= AUG_LABEL_TOL
            and img_err <= AUG_IMG_TOL):
        raise AssertionError(f"augment_batch on the card differs from the "
                             f"CPU: masks equal {same_mask}, labels "
                             f"{lab_err}, images {img_err}")
    # labels that paste-in added: the same draws without it, on the CPU
    pasted = int(cpu_out.mask.sum()) - int(A.augment_batch(
        *(b.cpu() for b in batches[0]), draws,
        dataclasses.replace(acfg, paste_in=0.0)).mask.sum())
    if acfg.paste_in > 0 and pasted <= 0:
        raise AssertionError("paste-in pasted nothing on the checked batch")

    gen, state, step = t.state.aug_generator, t.state, t.step
    comps, host, ranges_ok = [], [], []
    for i in range(steps):
        b = batches[i % len(batches)]
        before = gen.get_state()
        out = t.augment(*b, gen)
        lab = out.labels[out.mask]
        ranges_ok.append(bool(
            out.images.min() >= 0 and out.images.max() <= 1
            and (lab[:, 1:].min() >= 0 if len(lab) else True)
            and (lab[:, 1:].max() <= 1 if len(lab) else True)))
        gen.set_state(before)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comps.append({k: float(v) for k, v in step(state, *b).items()})
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    if not all(ranges_ok):
        raise AssertionError(f"an augmented batch is out of [0, 1]: "
                             f"{ranges_ok}")
    if not all(np.isfinite(c[k]) for c in comps for k in c):
        raise AssertionError(f"a loss component is not finite: {comps}")
    aug_host = []
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.augment(*batches[i % len(batches)], gen)
        torch.cuda.synchronize()
        aug_host.append((time.perf_counter() - t0) * 1e3)
    aug_peak = torch.cuda.max_memory_allocated() - held
    wall, names, ranges, _ = profiled_train(
        torch, lambda: step(state, *batches[0]), reps)
    dev_ms = sum(names.values())
    aug_dev = ranges.get("train/augment", 0.0)
    # the augmentation alone: its kernels and launches
    aug_wall, aug_names, _, aug_seen = profiled_train(
        torch, lambda: t.augment(*batches[0], gen), reps)
    emit({"phase": "train_augment", "ok": True, "card": card,
          "batch": batch, "size": size, "setting": setting,
          "hyp": f"scratch.p5 with {AUG_SETTINGS[setting]}",
          "augment_config": dataclasses.asdict(acfg),
          "draws_seed": seed, "images_taking_branch": taken,
          "pasted_labels": pasted,
          "card_vs_cpu": {
              "masks_identical": same_mask, "labels_max_abs_err": lab_err,
              "images_max_abs_err": img_err,
              "images_elements_above_1e-5": above,
              "valid_labels": int(cpu_out.mask.sum()),
              "tolerance": f"masks identical, labels {AUG_LABEL_TOL}, "
                           f"images {AUG_IMG_TOL} on [0, 1]"},
          "losses": comps, "batches_in_range": ranges_ok,
          "step_host_ms": host,
          "step_host_ms_median": statistics.median(host),
          "augment_host_ms": aug_host,
          "augment_host_ms_median": statistics.median(aug_host),
          "augment_peak_bytes": aug_peak,
          "profiled_wall_ms_per_step": wall,
          "device_ms_per_step": dev_ms if dev_ms > 0 else "not measured",
          "augment_device_ms_per_step": aug_dev if aug_dev > 0
          else "not measured",
          "range_device_ms": ranges,
          "device_busy_share": dev_ms / wall if dev_ms > 0
          else "not measured",
          "augment_alone": {
              "profiled_wall_ms": aug_wall,
              "device_ms": sum(aug_names.values()),
              "launches": sum(aug_seen.values()),
              "top_kernels_ms_launches": [
                  [k[:90], v, aug_seen[k]] for k, v in sorted(
                      aug_names.items(), key=lambda kv: -kv[1])[:15]]},
          "note": "host ms: synchronised wall time, a step after its "
                  "batch's check, the augmentation alone after the steps; "
                  "device ms: torch.profiler over the profiled steps, the "
                  "kernels inside train/augment in augment_device_ms; "
                  "augment_alone: the augmentation alone under the "
                  "profiler, per call; augment_peak_bytes: the device "
                  "memory the augmentation alone takes at its peak"})


# runs/train/demo/anchors.json, the JAX demo run's figures, copied verbatim
# into tests/golden (a copy that leaves out runs/ keeps it)
DEMO_ANCHORS = GOLDEN / "demo_anchors.json"
DEMO_DATA = 768          # the JAX demo run's --data synthetic:768


def phase_autoanchor_demo(torch, dev):
    """Autoanchor as the JAX demo run met it (``runs/train/demo/opt.json``:
    synthetic:768 at 640 px, seed 0, scratch.p5's anchor_t 4.0): the port's
    ``check_anchors`` on that set with the flagship's anchors gives the
    BPR of ``runs/train/demo/anchors.json`` (to 1e-12; read from its copy
    ``DEMO_ANCHORS``) and keeps the anchors, which equal the file's; then with absurd anchors (2000 px) it
    evolves a set that recalls more (``cli.train``'s ``autoanchor``, the
    model view carrying it), and the seconds that took."""
    import numpy as np

    from rep_yolo_tpu_torch.cli import train as cli
    from rep_yolo_tpu_torch.data.datasets import make_synthetic_dataset
    from rep_yolo_tpu_torch.models.model import RepYOLO
    from rep_yolo_tpu_torch.train.hyp import load_hyp
    from rep_yolo_tpu_torch.utils.autoanchor import check_anchors

    ref = json.loads(DEMO_ANCHORS.read_text())
    hyp = load_hyp("scratch.p5")
    t0 = time.perf_counter()
    ds = make_synthetic_dataset(DEMO_DATA, SIZE, seed=0)
    data_s = time.perf_counter() - t0
    model = RepYOLO.from_config(CFG, nc=1, device=dev)
    if model.device.type != "cuda":
        raise AssertionError("the model left the card")
    t0 = time.perf_counter()
    bpr, new = check_anchors(ds, model.anchors_px, img_size=SIZE,
                             thr=hyp["anchor_t"], seed=0)
    check_s = time.perf_counter() - t0
    ref_px = np.asarray(ref["anchors_px"], np.float32)
    same = bool(np.array_equal(model.anchors_px, ref_px))
    if not (abs(bpr - ref["bpr"]) <= 1e-12 and new is None and same):
        raise AssertionError(f"autoanchor on the demo set: BPR {bpr!r} "
                             f"(file {ref['bpr']!r}), new anchors "
                             f"{new is not None}, anchors equal {same}")
    args = argparse.Namespace(img_size=SIZE, seed=0)
    absurd = model.with_anchors(np.full((9, 2), 2000.0, np.float32))
    t0 = time.perf_counter()
    evolved, bad_bpr, did = cli.autoanchor(args, ds, absurd, hyp)
    evolve_s = time.perf_counter() - t0
    new_bpr, _ = check_anchors(ds, evolved.anchors_px, img_size=SIZE,
                               thr=hyp["anchor_t"], seed=0)
    if not (did and new_bpr > bad_bpr and evolved.net is model.net):
        raise AssertionError(f"autoanchor did not evolve a better set: BPR "
                             f"{bad_bpr} -> {new_bpr}, evolved {did}")
    emit({"phase": "autoanchor_demo", "ok": True,
          "labels": int(sum(len(x) for x in ds.labels)), "bpr": bpr,
          "bpr_file": ref["bpr"], "anchors_equal_file": same,
          "absurd_bpr": bad_bpr, "evolved_bpr": new_bpr,
          "evolved_anchors_px": evolved.anchors_px.tolist(),
          "autoanchor_line": cli.autoanchor_line(bad_bpr, evolved, did),
          "data_s": data_s, "check_s": check_s, "evolve_s": evolve_s})


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
          "previous_design_ms": PREVIOUS_MS["wgrad3x3"],
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
    kernel name against the launches made, and the prologue's spin events
    recorded against its PROLOGUE launches. A report: in such windows the
    profiler has lost the first events of a window, of every kernel alike,
    which the prologue is there to take up."""
    kfn = wgrad_case(torch, WGRAD_SHAPES[0], dev, 300)[0]
    flush, _ = l2_flush(torch)

    def call():
        flush()
        kfn()

    for _ in range(3):
        call()
    seen = [profiled(torch, call, reps, counts=True)[2:]
            for _ in range(windows)]
    emit({"phase": "profiler_after_training", "ok": True,
          "calls_per_window": reps, "shape": list(WGRAD_SHAPES[0][:5]),
          "events_per_window": [{k[:48]: n for k, n in w.items()}
                                for w, _ in seen],
          "prologue_launches": PROLOGUE,
          "prologue_events_per_window": [n for _, n in seen]})


# ---------------------------------------------------------------------------
# evaluation: K3 at evaluation's K, K12, the row-3 route, the CLIs, mAP
# ---------------------------------------------------------------------------

EVAL_K = 8192            # evaluation's max_nms (train/evaluate.py)
EVAL_BATCH = 8
EVAL_TRAIN_N, EVAL_VAL_N, EVAL_EPOCHS = 64, 32, 3
EVAL_RUNS = ROOT / "runs" / "chip_smoke"        # gitignored
DW5_PER_FORWARD = 18     # the flagship's depthwise 5x5 calls per forward


def _q8_gate(torch, got, ref, out_s):
    """The int8 kernels' rule: int8 identical but for +-1 LSB on at most
    1e-4 of the elements, float32 atol = rtol = 1e-5."""
    err, off1, off_more = q8_diff(torch, got, ref, out_s)
    if got.dtype == torch.int8:
        ok = off_more == 0 and off1 <= 1e-4 * got.numel()
    else:
        ok = bool(torch.allclose(got, ref, atol=1e-5, rtol=1e-5))
    return ok, {"out": list(got.shape), "dtype": str(got.dtype),
                "max_abs_err": err, "lsb_off_by_1": off1,
                "lsb_off_by_more": off_more}


def phase_kernels_eval(torch, dev, errs, x):
    """K3 at evaluation's K = 8192, K12 at every depthwise 5x5 call of one
    int8 forward with ``Q8Region(dw5_dense=False)`` at evaluation's batch 8
    (the golden weights, the served images and their mirror images,
    recorded on the way as in 5c), and the row-3 route (the train-form
    attention in eval() on K2) at the six CCVA shapes against the einsum
    path. Returns the recorded K12 calls and the route's largest error per
    mode."""
    import numpy as np

    from rep_yolo_tpu_torch.models.region import Q8Region
    from rep_yolo_tpu_torch.nn.blocks import AxialAttention
    from rep_yolo_tpu_torch.ops import nms as N
    from rep_yolo_tpu_torch.ops.kernels import launch_counts, \
        reset_launch_counts
    from rep_yolo_tpu_torch.ops.kernels import nms as KN
    from rep_yolo_tpu_torch.serve import build_engine

    nms_rows = []
    for name, boxes, valid, thr in nms_cases(dev, ks=(EVAL_K,), seed=1,
                                             ragged=()):
        keep = KN.nms_keep(boxes, valid, thr)
        ref = KN.nms_keep_plain(boxes, valid, thr)
        same = bool(torch.equal(keep, ref))
        row = {"case": name, "kept": int(keep.sum()), "identical": same}
        if name.startswith("clustered"):
            oracle = N._greedy_keep(boxes[:1].cpu(), valid[:1].cpu(), thr)
            row["greedy_identical_image0"] = bool(
                torch.equal(keep[:1].cpu(), oracle))
            same &= row["greedy_identical_image0"]
        nms_rows.append(row)
        if not same:
            raise AssertionError(f"K3 at K={EVAL_K} differs: {row}")

    engine = build_engine(CFG, str(GOLDEN / "model_weights.npz"), SIZE,
                          EVAL_BATCH, conf=0.001, iou=0.45, device=dev,
                          fast="int8")
    net = engine.model.net
    net.set_q8(Q8Region(net.q8.scales, dw5_dense=False))
    x8 = torch.cat([x, x.flip(2)])[:EVAL_BATCH]
    _, calls = record_q8_calls(engine.model, x8)
    engine.close()
    calls = [c for c in calls if c[1] == "dwconv5x5_f32w_q8"]
    if len(calls) != DW5_PER_FORWARD:
        raise AssertionError(f"{len(calls)} K12 calls in a forward, want "
                             f"{DW5_PER_FORWARD}")
    dw_rows = []
    for layer, name, args in calls:
        kfn, pfn, _, out_s, _, _, sig, _ = call_case(torch, name, args)
        ok, r = _q8_gate(torch, kfn(), pfn(), out_s)
        dw_rows.append({"layer": layer, "signature": str(sig[1:]), **r})
        if not ok:
            raise AssertionError(f"K12 differs from its plain version: "
                                 f"{dw_rows[-1]}")
        errs[name] = max(errs.get(name, 0.0), r["max_abs_err"])

    tol = dict(atol=1e-4, rtol=1e-4)
    attn_rows, attn_err = [], {}
    for i, (c, h, w) in enumerate(ATTN_SHAPES):
        g = torch.Generator().manual_seed(400 + i)
        xa = torch.randn((2, c, h, w), generator=g).to(dev)
        for cc in (True, False):
            blk = AxialAttention(c, cc)
            state = {}
            for k, t in blk.state_dict().items():
                if k.endswith("running_var") or (k.endswith("weight")
                                                 and t.ndim == 1):
                    state[k] = 0.5 + torch.rand(t.shape, generator=g)
                elif k.endswith("gamma"):
                    state[k] = torch.full(t.shape, 0.7)
                else:
                    state[k] = 0.3 * torch.randn(t.shape, generator=g)
            blk.load_state_dict(state)
            blk = blk.to(dev).eval()
            torch.cuda.synchronize()
            reset_launch_counts()
            y = blk(xa)                    # the default on the card: K2
            torch.cuda.synchronize()
            n = launch_counts()
            blk.fused = False
            ye = blk(xa)
            torch.testing.assert_close(y, ye, **tol)
            mode = "criss_cross" if cc else "vertical"
            if n[f"axial_attend_{mode}"] != 1 or n["axial_project"]:
                raise AssertionError(f"row-3 route launched {n}")
            e = float((y - ye).abs().max())
            attn_err[mode] = max(attn_err.get(mode, 0.0), e)
            attn_rows.append({"shape": [2, h, w, c], "mode": mode,
                              "max_abs_err": e,
                              "out_absmax": float(ye.abs().max())})
    emit({"phase": "kernels_eval_vs_plain", "ok": True,
          "tolerance": {"nms": "keep sets identical",
                        "dwconv5x5_f32w_q8": "int8 identical but for +-1 "
                        "LSB on <= 1e-4 of the elements; f32 out atol = "
                        "rtol = 1e-5", "row3_route": tol},
          "nms_k": EVAL_K, "nms": nms_rows, "dwconv5x5_f32w_q8": dw_rows,
          "row3_route": attn_rows})
    return calls, attn_err


def phase_times_eval(torch, dev, calls):
    """K12 per distinct call of one int8 forward at batch 8 (profiler ms
    from a cold L2, event ms, plain, cuDNN's f32 depthwise conv, bound),
    summed per forward; K2 on the row-3 route at the six CCVA shapes at
    batch 8, summed per forward; K3 at K = 8192, batch 8; all at
    evaluation's batch, beside their plain versions. Before the training
    phases (the profiler). Returns the per-forward sums of K12 and of K2
    per mode, and K3's times."""
    from rep_yolo_tpu_torch.ops.kernels import axial_attention as KA
    from rep_yolo_tpu_torch.ops.kernels import nms as KN
    from rep_yolo_tpu_torch.ops.kernels import reset_launch_counts

    agg, timed = {}, {}
    for layer, name, args in calls:
        kfn, pfn, lib, _, nbytes, ops, sig, _ = call_case(torch, name, args)
        if sig not in timed:
            t = kernel_times(torch, kfn, pfn, lib)
            t.update(zip(("bound_ms", "bound_by"), bound(nbytes, ops)),
                     bytes=nbytes, ops=ops)
            timed[sig] = {"signature": str(sig[1:]), "calls_per_forward": 0,
                          **t}
        timed[sig]["calls_per_forward"] += 1
        add_times(agg, timed[sig])
    attn = {"criss_cross": {}, "vertical": {}}
    attn_shapes = []
    for i, (c, h, w) in enumerate(ATTN_SHAPES):
        x, wqk, pq, pv, gamma = attention_inputs(c, h, w, EVAL_BATCH, 20 + i,
                                                 0.7, dev)
        # contiguous, as the row-3 route hands them to K2 (a view of the
        # plain q/k would add its copy to K2's time)
        q, k, v = (t.contiguous() for t in KA.project_plain(x, wqk, pq, pv))
        for cc, mode in ((True, "criss_cross"), (False, "vertical")):
            _, (b2, f2) = attention_cost(c, h, w, EVAL_BATCH, cc)
            t = kernel_times(torch, lambda: KA.attend(q, k, v, x, gamma, cc),
                             lambda: KA.attend_plain(q, k, v, x, gamma, cc))
            t.update(zip(("bound_ms", "bound_by"), bound(b2, f2)),
                     bytes=b2, ops=f2)
            add_times(attn[mode], t)
            attn_shapes.append({"mode": mode,
                                "shape": [EVAL_BATCH, h, w, c], **t})
    boxes = [c for c in nms_cases(dev, ks=(EVAL_K,), batch=EVAL_BATCH,
                                  seed=2, ragged=())
             if c[0].startswith("clustered")]
    _, b, v, thr = boxes[0]
    K = EVAL_K
    nms = nms_times(torch, b, v, thr)
    reset_launch_counts()
    emit({"phase": "times_eval", "ok": True,
          "note": f"dwconv5x5_f32w_q8: the {DW5_PER_FORWARD} calls of one "
                  f"{SIZE}-px int8 forward at batch {EVAL_BATCH} with "
                  "dw5_dense=False (each shape times its calls); library = "
                  "cuDNN's f32 depthwise conv of the same shape; "
                  "axial_attend_*_row3: K2 at the six CCVA shapes at batch "
                  f"{EVAL_BATCH}, summed per forward; nms_keep at "
                  f"K={K}, batch {EVAL_BATCH}, clustered boxes (mask_ms, "
                  "scan_ms: its two kernels launched apart); ms, plain_ms, "
                  "library_ms: device time under the profiler from a cold L2, "
                  "10 calls after 3 warm-ups; event_ms: CUDA events, median of "
                  "20 runs of 10 back-to-back calls (L2-warm)",
          "dwconv5x5_f32w_q8": list(timed.values()),
          "dwconv5x5_f32w_q8_per_forward": {k: agg[k] for k in TIME_KEYS},
          "previous_design_ms": {k: PREVIOUS_MS[k] for k in (
              "dwconv5x5_f32w_q8", "axial_attend_vertical_row3",
              "axial_attend_criss_cross_row3", "nms_keep_k8192")},
          "axial_attend_row3": attn_shapes,
          "axial_attend_row3_per_forward": {
              m: {k: a[k] for k in TIME_KEYS} for m, a in attn.items()},
          "nms_keep_k8192": nms})
    return agg, attn, nms


def phase_eval_train_cli(torch, timeout=600):
    """``python -m rep_yolo_tpu_torch.cli.train`` with evaluation every
    epoch on the synthetic val set (seed + 1): eval lines with the row-3
    route's K2 launches (no K1: the train form projects with cuDNN), K3,
    and best / last written. Returns the run directory."""
    import shutil

    import numpy as np

    shutil.rmtree(EVAL_RUNS / "train", ignore_errors=True)
    cmd = [sys.executable, "-m", "rep_yolo_tpu_torch.cli.train",
           "--cfg", CFG, "--data", f"synthetic:{EVAL_TRAIN_N}", "--val-data",
           f"synthetic:{EVAL_VAL_N}", "--epochs", str(EVAL_EPOCHS),
           "--eval-every", "1", "--batch-size", str(EVAL_BATCH),
           "--img-size", str(SIZE), "--no-augment", "--no-autoanchor",
           "--project", str(EVAL_RUNS), "--name", "train"]
    t = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout)
    secs = time.perf_counter() - t
    lines = [json.loads(s) for s in p.stdout.splitlines()
             if s.startswith("{")]
    evals = [r for r in lines if "eval" in r]
    run = pathlib.Path(lines[0]["run_dir"]) if lines else None
    fwd = -(-EVAL_VAL_N // EVAL_BATCH)
    ok = (p.returncode == 0 and len(evals) == EVAL_EPOCHS and run is not None
          and all((run / f"{n}.npz").exists() for n in ("best", "last"))
          and all(r["launches"].get(f"axial_attend_{m}")
                  == len(ATTN_SHAPES) * fwd
                  and "axial_project" not in r["launches"]
                  and r["launches"].get("nms_keep") == fwd
                  for r in evals for m in ("criss_cross", "vertical"))
          and all(np.isfinite(r["total"]) for r in lines if "total" in r))
    if not ok:
        raise AssertionError(f"cli.train with evaluation failed (exit "
                             f"{p.returncode}):\n{p.stdout[-3000:]}\n"
                             f"{p.stderr[-3000:]}")
    best = json.loads((run / "best.json").read_text())
    emit({"phase": "eval_train_cli", "ok": True, "cmd": " ".join(cmd[1:]),
          "exit": p.returncode, "seconds": secs, "evals": evals,
          "best": best, "steps": sum("total" in r for r in lines),
          "checkpoint_mb": (run / "last.npz").stat().st_size / 1e6})
    return run


def phase_eval_modes(torch, dev, run):
    """The trained ``best`` scored on the synthetic val set in the seven
    modes of ``tools/eval_modes.py``, the counts zeroed before each
    evaluation and read after it: P, R, mAP@.5, mAP@.5:.95, host ms per
    image and kernel launches per forward. Returns {mode: launch counts}."""
    from rep_yolo_tpu_torch.data.datasets import make_synthetic_dataset
    from rep_yolo_tpu_torch.tools import eval_modes as EM
    from rep_yolo_tpu_torch.train.checkpoint import read_weights

    ema = read_weights(run / "best")
    val = make_synthetic_dataset(EVAL_VAL_N, SIZE, 1, 120, seed=1)
    fwd = -(-EVAL_VAL_N // EVAL_BATCH)
    ccva = len(ATTN_SHAPES)           # one criss-cross + one vertical each
    fused = {"axial_project": 2 * ccva, "axial_attend_criss_cross": ccva}
    want = {"fused_f32": fused,
            "unfused_row3": {"axial_project": 0,
                             "axial_attend_criss_cross": ccva,
                             "axial_attend_vertical": ccva},
            "bf16": {**fused, **{k: 0 for k in CM_PER_FORWARD}},
            "bf16_der_fast": CM_PER_FORWARD,
            "int8_k7": {"dwconv5x5_q8": DW5_PER_FORWARD,
                        "dwconv5x5_f32w_q8": 0},
            "int8_k12": {"dwconv5x5_f32w_q8": DW5_PER_FORWARD,
                         "dwconv5x5_q8": 0},
            "xla_q8": XLQ_PER_FORWARD}
    scored = EM.score_modes(ema, val, CFG, SIZE, EVAL_BATCH, dev)
    rows, counts = {}, {}
    for mode, row in scored.items():
        counts[mode] = row.pop("launches")
        per_fwd = row["launches_per_forward"]
        need = {**want[mode], "nms_keep": 1}
        if any(per_fwd.get(k, 0) != n for k, n in need.items()):
            raise AssertionError(f"{mode}: launches per forward {per_fwd}, "
                                 f"want {need}")
        if not all(map(math.isfinite, (row["P"], row["R"], row["map50"],
                                       row["map"]))):
            raise AssertionError(f"{mode}: {row}")
        rows[mode] = row
    gaps = EM.gaps(rows)
    gaps["int8_k12_minus_int8_k7"] = EM.gaps(rows, "int8_k7")["int8_k12"]
    emit({"phase": "eval_modes", "ok": True, "weights": str(run / "best"),
          "val": f"synthetic:{EVAL_VAL_N} (seed 1)", "batch": EVAL_BATCH,
          "forwards": fwd, "modes": rows, "gaps": gaps})
    return counts


def phase_train_resume(torch, run, timeout=600):
    """``cli.train --resume <run>/last --epochs EVAL_EPOCHS + 1`` on phase
    18's run, as a user resumes it: it continues at epoch EVAL_EPOCHS in
    the same directory from step EVAL_EPOCHS * nb + 1, with the generator
    states ``last.json`` saved; ``results.txt`` and ``metrics.csv`` gain
    the new epoch's lines; ``init.npz`` is the first run's. The run's
    ``best`` may be replaced (a resumed run starts best over at fitness 0,
    as the JAX CLI does): the phases that score it run before."""
    import hashlib

    import numpy as np

    from rep_yolo_tpu_torch.train.checkpoint import GENERATOR_KEYS

    saved = json.loads((run / "last.json").read_text())
    sha = {k: hashlib.sha256(saved[k].encode()).hexdigest()
           for k in GENERATOR_KEYS}
    csv_before = (run / "metrics.csv").read_text().splitlines()
    nb = EVAL_TRAIN_N // EVAL_BATCH
    cmd = [sys.executable, "-m", "rep_yolo_tpu_torch.cli.train",
           "--resume", str(run / "last"), "--cfg", CFG, "--data",
           f"synthetic:{EVAL_TRAIN_N}", "--val-data", f"synthetic:{EVAL_VAL_N}",
           "--epochs", str(EVAL_EPOCHS + 1), "--eval-every", "1",
           "--batch-size", str(EVAL_BATCH), "--img-size", str(SIZE),
           "--no-augment", "--no-autoanchor"]
    t = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout)
    secs = time.perf_counter() - t
    lines = [json.loads(s) for s in p.stdout.splitlines()
             if s.startswith("{")]
    head = next((r for r in lines if "run_dir" in r), {})
    resumed = next((r for r in lines if "resumed" in r), {})
    steps = [r for r in lines if "total" in r]
    results = (run / "results.txt").read_text().splitlines()
    csv_after = (run / "metrics.csv").read_text().splitlines()
    checks = {
        "exit_0": p.returncode == 0,
        "same_run_dir": head.get("run_dir") == str(run),
        "start_epoch": resumed.get("start_epoch") == EVAL_EPOCHS,
        "resumed_line": f"resumed {run / 'last'} at epoch {EVAL_EPOCHS}"
        in p.stdout.splitlines(),
        "first_step": bool(steps) and steps[0]["step"] == EVAL_EPOCHS * nb + 1
        and steps[0]["epoch"] == EVAL_EPOCHS,
        "steps": len(steps) == nb and all(np.isfinite(r["total"])
                                          for r in steps),
        "results_txt_epochs": [r.split()[1] for r in results] == [
            f"{e}/{EVAL_EPOCHS}" if e == EVAL_EPOCHS else
            f"{e}/{EVAL_EPOCHS - 1}" for e in range(EVAL_EPOCHS + 1)],
        "metrics_csv_rows": csv_after[:len(csv_before)] == csv_before
        and len(csv_after) == len(csv_before) + 2,
        "init_npz": (run / "init.npz").is_file(),
        "generators_restored": resumed.get("generators_sha256") == sha}
    out = {"phase": "train_resume", "ok": all(checks.values()),
           "cmd": " ".join(cmd[1:]), "exit": p.returncode, "seconds": secs,
           "checks": checks, "resumed": resumed,
           "results_txt": results[-2:], "metrics_csv_new": csv_after[
               len(csv_before):]}
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"cli.train --resume failed: {checks}\n"
                             f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")


def phase_overfit_box(timeout=900):
    """``python -m rep_yolo_tpu_torch.tools.overfit_check`` on the card:
    the tiny graph overfit on one box for 2000 steps (host-bound), then
    predict and NMS; the top box must overlap the drawn one at IoU >= 0.8
    with confidence >= 0.5 (the tool's gate, its exit code)."""
    from rep_yolo_tpu_torch.tools import overfit_check as OC

    cmd = [sys.executable, "-m", "rep_yolo_tpu_torch.tools.overfit_check"]
    t = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout)
    secs = time.perf_counter() - t
    lines = [json.loads(s) for s in p.stdout.splitlines()
             if s.startswith("{")]
    res = lines[-1] if lines else {}
    row = {"phase": "overfit_box", "cmd": " ".join(cmd[1:]),
           "exit": p.returncode, "wall_s": secs, **res,
           "gate": {"min_iou": OC.MIN_IOU, "min_conf": OC.MIN_CONF}}
    row["ok"] = p.returncode == 0 and bool(res.get("ok")) and \
        res.get("device") == "cuda" and res.get("steps") == OC.STEPS
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"overfit_box: the detector did not find the "
                             f"box, or the tool failed:\n{p.stdout[-3000:]}"
                             f"\n{p.stderr[-3000:]}")


def phase_test_cli(torch, dev, run, timeout=600):
    """``python -m rep_yolo_tpu_torch.cli.test`` on the val images written
    as PNG files, with --rect and --fast int8 (K7, then K12 with
    --dw5-exact): exit 0, and the same mAP, within 1e-6, as a direct
    ``evaluate`` on ``DetectionDataset.from_path`` of that directory with
    the same weights and flags. Without an image decoder the phase runs
    nothing and says so."""
    import numpy as np

    from rep_yolo_tpu_torch.cli import test as cli_test
    from rep_yolo_tpu_torch.cli.detect import load_model_and_vars
    from rep_yolo_tpu_torch.data.datasets import (DetectionDataset,
                                                  image_decoder,
                                                  make_synthetic_dataset)
    from rep_yolo_tpu_torch.train.evaluate import evaluate

    try:
        decoder = image_decoder()
    except ImportError as e:
        emit({"phase": "test_cli", "ok": True, "ran": False,
              "reason": f"no image decoder on this machine: {e}"})
        return
    root = EVAL_RUNS / "val"
    val = make_synthetic_dataset(EVAL_VAL_N, SIZE, 1, 120, seed=1)
    for sub in ("images", "labels"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for i, (img, lab) in enumerate(zip(val.images, val.labels)):
        path = root / "images" / f"{i:05d}.png"
        if decoder == "cv2":
            import cv2
            cv2.imwrite(str(path), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        else:
            from PIL import Image
            Image.fromarray(img).save(path)
        (root / "labels" / f"{i:05d}.txt").write_text("\n".join(
            f"{int(c)} {x:.6f} {y:.6f} {w:.6f} {h:.6f}"
            for c, x, y, w, h in lab))
    tol = 1e-6
    was = torch.backends.cudnn.deterministic
    rows = []
    for extra, kernel in (([], "dwconv5x5_q8"),
                          (["--dw5-exact"], "dwconv5x5_f32w_q8")):
        argv = ["--weights", str(run / "best"), "--data",
                str(root / "images"), "--cfg", CFG, "--rect", "--fast", "int8",
                "--batch-size", str(EVAL_BATCH), "--img-size",
                str(SIZE)] + extra
        t = time.perf_counter()
        p = subprocess.run([sys.executable, "-m",
                            "rep_yolo_tpu_torch.cli.test"] + argv, cwd=ROOT,
                           capture_output=True, text=True, timeout=timeout)
        secs = time.perf_counter() - t
        if p.returncode != 0:
            raise AssertionError(f"cli.test failed (exit {p.returncode}):\n"
                                 f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
        out = json.loads(p.stdout[p.stdout.rindex('{\n  "P"'):])
        # the same, in this process, as cli.test runs it
        args = cli_test.parse_args(argv)
        torch.backends.cudnn.deterministic = True
        try:
            model = load_model_and_vars(args)
            ds = DetectionDataset.from_path(str(root / "images"), SIZE)
            cli_test.calibrate_int8(model, ds, SIZE,
                                    dw5_dense=not args.dw5_exact)
            res = evaluate(model, ds, batch_size=EVAL_BATCH, img_size=SIZE,
                           rect=True, rect_stride=args.rect_stride)
        finally:
            torch.backends.cudnn.deterministic = was
        fwd = -(-EVAL_VAL_N // EVAL_BATCH)
        gap = {k: abs(out[k] - getattr(res, a)) for k, a in
               (("P", "mp"), ("R", "mr"), ("map50", "map50"),
                ("map", "map"))}
        row = {"flags": " ".join(argv[6:]), "exit": p.returncode,
               "seconds": secs, "cli": {k: out[k] for k in
                                        ("P", "R", "map50", "map",
                                         "ms_per_img_infer")},
               "direct": {"P": res.mp, "R": res.mr, "map50": res.map50,
                          "map": res.map}, "abs_gap": gap,
               "launches": out["launches"]}
        rows.append(row)
        if max(gap.values()) > tol or out["launches"].get(kernel) != \
                DW5_PER_FORWARD * fwd:
            raise AssertionError(f"cli.test disagrees: {row}")
        del model
    emit({"phase": "test_cli", "ok": True, "ran": True, "decoder": decoder,
          "data": str(root), "tolerance": tol, "runs": rows})


def phase_serving_ckpt(torch, dev, run, batch=4):
    """``serve --ckpt`` of the ``best`` that phase 18 wrote, parsed as the
    CLI parses it, in float32 and in bfloat16 with der_fast: raw maps per
    level against the same checkpoint loaded through ``read_checkpoint`` as
    ``cli.test`` loads it (float32 within 1e-4 max|ref|; bfloat16 der_fast
    against the cast reference on cuDNN within E2E_REL / E2E_CORR), 24 K10
    and 28 K11 launches in the der_fast forward, and one served call each."""
    import numpy as np

    from rep_yolo_tpu_torch.models.model import RepYOLO
    from rep_yolo_tpu_torch.ops.kernels import launch_counts, \
        reset_launch_counts
    from rep_yolo_tpu_torch.serve import build_engine, parse_args
    from rep_yolo_tpu_torch.train.checkpoint import read_checkpoint

    best = str(run / "best")
    args = parse_args(["--cfg", CFG, "--ckpt", best, "--img-size",
                       str(SIZE), "--max-batch", str(batch), "--conf",
                       "0.001"])
    ref = RepYOLO.from_config(CFG, device=dev).load_state(
        read_checkpoint(best)["ema"]).fuse()
    imgs = np.random.default_rng(3).uniform(
        0, 1, (batch, SIZE, SIZE, 3)).astype(np.float32)
    x = torch.from_numpy(imgs).to(dev)
    want = ref.apply(x)
    out = {"phase": "serving_ckpt", "ckpt": best, "batch": batch}
    ok = True
    for mode in ("float32", "bf16_der_fast"):
        bf16 = mode != "float32"
        if bf16:
            ref.cast(torch.bfloat16)
            want = ref.apply(x.bfloat16())
        engine = build_engine(args.cfg, args.weights, args.img_size,
                              args.max_batch, args.conf, args.iou, dev,
                              fast=args.fast, ckpt=args.ckpt,
                              dtype=torch.bfloat16 if bf16 else torch.float32,
                              der_fast="bf16" if bf16 else None)
        torch.cuda.synchronize()
        reset_launch_counts()
        got = engine.model.apply(x.bfloat16() if bf16 else x)
        torch.cuda.synchronize()
        counts = {k: launch_counts()[k] for k in CM_PER_FORWARD}
        dets = engine(imgs)
        engine.close()
        levels = [rel_corr(a, b) for a, b in zip(got, want)]
        if bf16:
            good = counts == CM_PER_FORWARD and all(
                r < E2E_REL and c > E2E_CORR for r, c in levels)
            tol = {"rel": E2E_REL, "corr": E2E_CORR}
        else:
            good = all(r <= 1e-4 for r, _ in levels)
            tol = {"rel": 1e-4}
        ok = ok and good
        out[mode] = {"rel_max_err_per_level": [r for r, _ in levels],
                     "corr_per_level": [c for _, c in levels],
                     "tolerance": tol, "launches_per_forward": counts,
                     "detections_per_image": [len(d) for d in dets],
                     "ok": good}
    out["ok"] = ok
    emit(out)
    if not ok:
        raise AssertionError(f"serve --ckpt check failed: {out}")


def eval_rows(counts, errs, dw_agg, attn_agg, attn_err,
              nms_t) -> list[dict]:
    """The kernels line's rows of the evaluation path, each timed at
    evaluation's batch 8: K12, K3 at K = 8192 and K2 on the row-3 route
    (its error the route's own against the einsum path)."""
    rows = [kernel_row("dwconv5x5_f32w_q8",
                       "rep_yolo_tpu_torch/csrc/neck_flat.cu",
                       "rep_yolo_tpu/ops/pallas/neck_flat.py:333",
                       counts["int8_k12"]["dwconv5x5_f32w_q8"],
                       errs["dwconv5x5_f32w_q8"], dw_agg, F32_PEAK)]
    rows[0]["launches_per_forward"] = DW5_PER_FORWARD
    rows[0]["library_call"] = "F.conv2d(groups=C), cuDNN f32 depthwise"
    rows.append(kernel_row("nms_keep_k8192", "rep_yolo_tpu_torch/csrc/nms.cu",
                           "rep_yolo_tpu/ops/pallas/nms_kernel.py:97",
                           counts["fused_f32"]["nms_keep"],
                           errs["nms_keep"], nms_t, F32_PEAK))
    rows[-1].update(mask_ms=nms_t["mask_ms"], scan_ms=nms_t["scan_ms"])
    for mode, line in (("criss_cross", 295), ("vertical", 330)):
        rows.append(kernel_row(
            f"axial_attend_{mode}_row3",
            "rep_yolo_tpu_torch/csrc/axial_attention.cu",
            f"rep_yolo_tpu/ops/pallas/axial_attention.py:{line}",
            counts["unfused_row3"][f"axial_attend_{mode}"], attn_err[mode],
            attn_agg[mode], F32_PEAK))
    return rows


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
        phase_xla_q8_e2e(torch, dev)
        counts, e2e_ms, engine, x = phase_serving(torch, dev)
        _, e2e_bb_ms, engine_bb, _ = phase_serving(torch, dev, "int8",
                                                   neck=False)
        counts_q8, e2e_q8_ms, engine_q8, _ = phase_serving(torch, dev,
                                                           "int8")
        counts_bf16, e2e_bf16_ms, engine_bf16, _ = phase_serving(
            torch, dev, der_fast="bf16")
        counts_xlq, e2e_xlq_ms, engine_xlq, _ = phase_serving(
            torch, dev, der_fast="xla_q8")
        calls = phase_kernels_neck(torch, engine_q8, x, errs)
        bd_counts, dw = phase_kernels_q8_rest(torch, dev, errs, calls)
        engines = {"float32": engine, "int8_backbone": engine_bb,
                   "int8": engine_q8, "bf16_der_fast": engine_bf16,
                   "xla_q8": engine_xlq}
        phase_profile(torch, engines, x)
        ab = phase_served_ab(torch, engines, x.cpu().numpy())
        for e in engines.values():
            e.close()
        kernels = phase_times(torch, dev, counts, errs)
        kernels += phase_times_q8(torch, dev, counts_q8, errs, calls)
        kernels += phase_times_cm(torch, dev, counts_bf16, errs)
        bench_counts = phase_kernel_bench(torch, dev)
        rest_counts = {**{k: bench_counts[k] for k in (
            "conv3x3_cmajor_q8", "conv1x1_cmajor_q8")},
            **{k: n for k, n in bd_counts.items()
               if k.startswith("conv5x5_q8")},
            **{k: counts_xlq[k] for k in PM_KERNELS},
            **{f"conv3x3_q8@{r}": counts_xlq[f"conv3x3_q8@{r}"]
               for r in K4_ROUTES}}
        kernels += phase_times_q8_rest(torch, dev, rest_counts, errs, dw,
                                       engine_xlq, x)
        del dw
        dw_calls, attn_err = phase_kernels_eval(torch, dev, errs, x)
        dw_agg, attn_agg, nms_t = phase_times_eval(torch, dev, dw_calls)
    # training needs autograd: outside inference_mode; cuDNN picks its
    # algorithms as under cli.train (TF32 stays off)
    torch.backends.cudnn.deterministic = False
    phase_kernels_wgrad(torch, dev, errs)
    with torch.inference_mode():
        wgrad_times = phase_times_wgrad(torch, dev)
    counts_train = phase_train_step(torch, dev)
    phase_train_overfit(torch, dev)
    phase_train_cli(torch)
    for setting in AUG_SETTINGS:
        phase_train_augment(torch, dev, card, setting)
    phase_train_cli(torch, hyp="scratch.p5")
    phase_autoanchor_demo(torch, dev)
    run = phase_eval_train_cli(torch)
    with torch.inference_mode():
        counts_eval = phase_eval_modes(torch, dev, run)
        phase_test_cli(torch, dev, run)
        phase_serving_ckpt(torch, dev, run)
    phase_train_resume(torch, run)
    phase_overfit_box()
    with torch.inference_mode():
        phase_profiler_after_training(torch, dev)
        # last: after its batch-128 profiler windows the profiler loses a
        # device event in every later window, of every kernel alike
        phase_throughput_bf16(torch, dev)
    kernels.append(wgrad_row(counts_train, errs, wgrad_times))
    kernels += eval_rows(counts_eval, errs, dw_agg, attn_agg, attn_err,
                         nms_t)
    missing = [k["name"] for k in kernels if k["launches"] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    emit({"card": card, "served_batch4_ms": e2e_ms,
          "served_batch4_int8_backbone_ms": e2e_bb_ms,
          "served_batch4_int8_ms": e2e_q8_ms,
          "served_batch4_bf16_der_fast_ms": e2e_bf16_ms,
          "served_batch4_xla_q8_ms": e2e_xlq_ms, "served_ab_ms": ab,
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
