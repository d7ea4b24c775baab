"""Benchmarks of the port's kernels (``python -m
rep_yolo_tpu_torch.tools.kernel_bench``, ``... kernel_bench_flat``)."""

from __future__ import annotations

import statistics
import time

import torch


def event_ms(fn, device: torch.device, iters: int = 20,
             warmup: int = 3) -> float:
    """ms per call of ``fn``: ``iters`` back-to-back calls after ``warmup``,
    between two CUDA events on the card (the host clock on the CPU, where
    the wrappers run their plain versions), the median of three such runs."""
    for _ in range(warmup):
        fn()
    runs = []
    for _ in range(3):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                fn()
            b.record()
            b.synchronize()
            runs.append(a.elapsed_time(b) / iters)
        else:
            t = time.perf_counter()
            for _ in range(iters):
                fn()
            runs.append((time.perf_counter() - t) * 1e3 / iters)
    return statistics.median(runs)
