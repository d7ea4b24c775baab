#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (rep_yolo_tpu_torch) on one card.

Drives the port's main path, fused float serving of cfg/rep_yolo.yaml at
640 px, and holds every CUDA kernel of that path against its plain PyTorch
version on the card. Phases, one JSON line each:

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

MEM_BW = 3.35e12       # H100 SXM HBM3 bytes/s (data sheet)
F32_PEAK = 67e12       # H100 SXM f32 non-tensor FLOP/s (data sheet)
# (c_, H, W) of the six CCVA attention blocks at 640 px (layers 21, 27, 37,
# 43, 53, 59)
ATTN_SHAPES = [(64, 80, 80), (32, 80, 80), (128, 40, 40), (64, 40, 40),
               (256, 20, 20), (128, 20, 20)]
LINES: list[dict] = []


def emit(obj: dict) -> None:
    LINES.append(obj)
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median over `runs` of the ms per call of 10 back-to-back calls
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
        for _ in range(10):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 10)
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / MEM_BW * 1e3, flops / F32_PEAK * 1e3
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
        0, 1, (2, 640, 640, 3)).astype(np.float32)).to(dev)
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
    out = {"phase": "attention_e2e", "gamma": 0.5, "batch": 2, "size": 640,
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


def phase_serving(torch, dev):
    import numpy as np

    from rep_yolo_tpu_torch.data.letterbox import letterbox_batch
    from rep_yolo_tpu_torch.ops.kernels import launch_counts, \
        reset_launch_counts
    from rep_yolo_tpu_torch.serve import build_engine, make_server

    size, max_batch = 640, 4
    t0 = time.perf_counter()
    engine = build_engine(CFG, str(GOLDEN / "model_weights.npz"), size,
                          max_batch, conf=0.001, iou=0.45, device=dev)
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
    want = {"axial_project": 12 * n_fwd, "axial_attend_criss_cross": 6 * n_fwd,
            "axial_attend_vertical": 6 * n_fwd, "nms_keep": n_fwd}
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
    e2e = []
    for _ in range(13):
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine(batch4)
        torch.cuda.synchronize()
        e2e.append((time.perf_counter() - t) * 1e3)
    e2e_ms = statistics.median(e2e[3:])
    fwd_ms = cuda_ms(lambda: engine.infer(x), runs=10)
    emit({"phase": "serving", "ok": True, "health": health,
          "build_engine_s": round(build_s, 3), "batches": [1, 2, 4],
          "detections_per_image": dets,
          "server_ms": [r["ms"] for r in responses],
          "launch_counts": counts, "forwards": n_fwd,
          "served_batch4_host_ms_median": e2e_ms,
          "infer_batch4_cuda_ms_median": fwd_ms})
    return counts, e2e_ms, engine, x


def _category(name: str) -> str:
    low = name.lower()
    if "axial_project" in low or "axial_attend" in low:
        return "attention kernels (K1, K2)"
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


def _profile_once(torch, engine, x, reps):
    from torch.profiler import ProfilerActivity, profile

    engine.infer(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            engine.infer(x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / reps
    cats: dict[str, float] = {}
    names: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        ms = us / 1e3 / reps
        if ms > 0:
            names[e.key] = names.get(e.key, 0.0) + ms
            c = _category(e.key)
            cats[c] = cats.get(c, 0.0) + ms
    return wall, cats, names


def phase_profile(torch, engine, x, reps: int = 5):
    """Device time by kernel category over `reps` served batches and the
    device's busy share of the wall time, in two turns."""
    runs = [_profile_once(torch, engine, x, reps) for _ in range(2)]
    wall = [r[0] for r in runs]
    dev = [sum(r[1].values()) for r in runs]
    cats: dict[str, float] = {}
    names: dict[str, float] = {}
    for r in runs:
        for c, ms in r[1].items():
            cats[c] = cats.get(c, 0.0) + ms / len(runs)
        for n, ms in r[2].items():
            names[n] = names.get(n, 0.0) + ms / len(runs)
    measured = min(dev) > 0
    emit({"phase": "profile", "ok": True, "batch": int(x.shape[0]),
          "reps": reps, "wall_ms_per_batch": wall,
          "device_ms_per_batch": dev if measured else "not measured",
          "device_busy_share": [d / w for d, w in zip(dev, wall)]
          if measured else "not measured",
          "by_category_ms": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
          "top_kernels_ms": [[k[:90], v] for k, v in sorted(
              names.items(), key=lambda kv: -kv[1])[:10]]})


def phase_times(torch, dev, counts, errs):
    from rep_yolo_tpu_torch.ops.kernels import axial_attention as KA
    from rep_yolo_tpu_torch.ops.kernels import nms as KN
    from rep_yolo_tpu_torch.ops.kernels import reset_launch_counts

    batch = 4
    agg = {n: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0.0,
               "flops": 0.0} for n in ("axial_project",
                                       "axial_attend_criss_cross",
                                       "axial_attend_vertical")}
    per_shape = []
    for i, (c, h, w) in enumerate(ATTN_SHAPES):
        x, wqk, pq, pv, gamma = attention_inputs(c, h, w, batch, 10 + i,
                                                 0.7, dev)
        q, k, v = KA.project(x, wqk, pq, pv)
        t1 = cuda_ms(lambda: KA.project(x, wqk, pq, pv))
        p1 = cuda_ms(lambda: KA.project_plain(x, wqk, pq, pv))
        for cc in (True, False):
            name = "axial_attend_" + ("criss_cross" if cc else "vertical")
            (b1, f1), (b2, f2) = attention_cost(c, h, w, batch, cc)
            t2 = cuda_ms(lambda: KA.attend(q, k, v, x, gamma, cc))
            p2 = cuda_ms(lambda: KA.attend_plain(q, k, v, x, gamma, cc))
            bd2, _ = bound(b2, f2)
            agg[name]["ms"] += t2
            agg[name]["plain_ms"] += p2
            agg[name]["bound_ms"] += bd2
            agg[name]["bytes"] += b2
            agg[name]["flops"] += f2
            per_shape.append({"kernel": name, "shape": [batch, h, w, c],
                              "ms": t2, "plain_ms": p2, "bound_ms": bd2,
                              "bound_by": bound(b2, f2)[1]})
        # the projection runs once per block, twice per CCVA
        bd1, by1 = bound(b1, f1)
        agg["axial_project"]["ms"] += 2 * t1
        agg["axial_project"]["plain_ms"] += 2 * p1
        agg["axial_project"]["bound_ms"] += 2 * bd1
        agg["axial_project"]["bytes"] += 2 * b1
        agg["axial_project"]["flops"] += 2 * f1
        per_shape.append({"kernel": "axial_project", "shape": [batch, h, w, c],
                          "ms": t1, "plain_ms": p1, "bound_ms": bd1,
                          "bound_by": by1})

    import numpy as np

    rng = np.random.default_rng(3)
    K = 1024
    c = rng.uniform(0, 640, (batch, K, 2))
    wh = rng.uniform(10, 60, (batch, K, 2))
    boxes = torch.as_tensor(np.concatenate([c - wh / 2, c + wh / 2], -1),
                            dtype=torch.float32, device=dev)
    valid = torch.ones((batch, K), dtype=torch.bool, device=dev)
    tn = cuda_ms(lambda: KN.nms_keep(boxes, valid, 0.45))
    pn = cuda_ms(lambda: KN.nms_keep_plain(boxes, valid, 0.45), runs=5)
    nb = batch * K * (16 + 1 + 1)
    nf = batch * K * (K - 1) / 2 * 12
    reset_launch_counts()

    src_attn = "rep_yolo_tpu_torch/csrc/axial_attention.cu"
    kernels = []
    for name, replaces in (
            ("axial_project", "rep_yolo_tpu/ops/pallas/axial_attention.py:263"),
            ("axial_attend_criss_cross",
             "rep_yolo_tpu/ops/pallas/axial_attention.py:263"),
            ("axial_attend_vertical",
             "rep_yolo_tpu/ops/pallas/axial_attention.py:285")):
        a = agg[name]
        kernels.append({"name": name, "route": "cuda", "source": src_attn,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": errs[name], "ms": a["ms"],
                        "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
                        "bound_by": bound(a["bytes"], a["flops"])[1],
                        "library_ms": None})
    bdn, byn = bound(nb, nf)
    kernels.append({"name": "nms_keep", "route": "cuda",
                    "source": "rep_yolo_tpu_torch/csrc/nms.cu",
                    "replaces": "rep_yolo_tpu/ops/pallas/nms_kernel.py:97",
                    "launches": counts["nms_keep"],
                    "max_abs_err": errs["nms_keep"], "ms": tn,
                    "plain_ms": pn, "bound_ms": bdn, "bound_by": byn,
                    "library_ms": None})
    emit({"phase": "times", "ok": True, "batch": batch,
          "note": "attention rows sum the six 640-px CCVA shapes of one "
                  "served batch (the projection twice per CCVA); nms_keep "
                  "at K=1024, batch 4; CUDA events, median of 20 runs of 10 "
                  "back-to-back calls",
          "per_shape": per_shape})
    return kernels


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
        phase_golden(torch, dev)
        phase_attention_e2e(torch, dev)
        counts, e2e_ms, engine, x = phase_serving(torch, dev)
        phase_profile(torch, engine, x)
        engine.close()
        kernels = phase_times(torch, dev, counts, errs)
    missing = [k["name"] for k in kernels if k["launches"] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    emit({"card": card, "served_batch4_ms": e2e_ms,
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
