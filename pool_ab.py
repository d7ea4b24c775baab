"""A/B of the int8 pool kernels' designs on the card.

Each variant is built from this checkout's ``rep_yolo_tpu_torch/csrc`` by
``nvcc`` as the port builds its kernels, with the sources' A/B switches:

- K6 ``max_pool2_q8`` at its three calls of a served int8 forward (640 px,
  batch 4): the design; ``-DPOOL_RB=4`` (four output rows a thread);
  ``-DPOOL_EVICT_FIRST`` (the loads as ``ld.global.cs``);
- K8 ``spp_pools_q8`` at its served call (4, 20, 20, 512): the design's tile
  (4 rows by 8 channel words) and others (``-DSPP_TH``, ``-DSPP_LGW``),
  each with its grid's blocks;
- with ``--previous DIR``, the design before, built from ``DIR``'s
  ``pool_flat.cu`` and ``neck_flat.cu`` (the csrc of a checkout of an
  earlier commit; the C entries are the same).

Every variant's output is first held against the plain version
(identical). Device ms under torch.profiler: ``cold`` after an L2 flush
(``chip_smoke.device_ms``), ``warm`` back to back, the input L2-resident as
in a served forward. The variants of one call run in turns, in order and
then in reverse, and both readings are kept. One JSON line per call, the
card's name and power limit first.

Usage: python3 pool_ab.py [--out FILE] [--previous DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import torch

import chip_smoke as CS
from rep_yolo_tpu_torch import device as D
from rep_yolo_tpu_torch.ops.kernels import neck_flat as KNF
from rep_yolo_tpu_torch.ops.kernels import pool_flat as KP

K6_CALLS = [("l6 MP", (4, 80, 80, 256)), ("layer 30", (4, 80, 80, 128)),
            ("layer 46", (4, 40, 40, 256))]
K6_VARIANTS = {"design": (), "4 rows a thread": ("POOL_RB=4",),
               "evict-first loads": ("POOL_EVICT_FIRST",)}
K8_CALL = (4, 20, 20, 512)
K8_TILES = [(4, 8), (5, 8), (2, 8), (8, 8), (4, 4), (4, 16)]  # rows, words
ENTRY = {"pool_flat": "max_pool2_q8", "neck_flat": "spp_pools_q8"}


def variants(previous: str | None) -> dict:
    """{(stem, label): (source, defines)}."""
    out = {("pool_flat", k): (D.CSRC_DIR / "pool_flat.cu", d)
           for k, d in K6_VARIANTS.items()}
    for th, words in K8_TILES:
        label = f"{th} rows x {words} words" + (
            " (design)" if (th, words) == K8_TILES[0] else "")
        out["neck_flat", label] = (D.CSRC_DIR / "neck_flat.cu",
                                   (f"SPP_TH={th}",
                                    f"SPP_LGW={words.bit_length() - 1}"))
    if previous:
        for stem in ENTRY:
            out[stem, "previous design"] = (
                pathlib.Path(previous) / f"{stem}.cu", ())
    return out


def build(todo: dict) -> dict:
    """{(stem, label): CDLL}, every variant compiled in parallel."""
    out_dir = D.BUILD_DIR / "pool_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (key, (src, defines)) in enumerate(todo.items()):
        lib = out_dir / f"lib{key[0]}_{i}.so"
        procs[key] = (lib, subprocess.Popen(
            D.nvcc_command(src, lib, defines), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    libs = {}
    for key, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc of {key} failed:\n{log.decode()}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def caller(lib, stem: str):
    """fn(x) -> y through ``lib``'s C entry (x, y, B, H, W, C / 4,
    stream)."""
    name = ENTRY[stem]
    entry = getattr(lib, name)
    entry.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    entry.restype = ctypes.c_int

    def fn(x):
        B, H, W, C = x.shape
        shape = ((B, H // 2, W // 2, C) if stem == "pool_flat"
                 else (B, H, W, 4 * C))
        y = torch.empty(shape, device=x.device, dtype=torch.int8)
        D.check_launch(name, entry(D.ptr(x), D.ptr(y), B, H, W, C // 4,
                                   D.stream_handle(x)))
        return y
    return fn


def blocks(lib, shape) -> int | None:
    """The blocks of K8's grid on ``shape`` (None: no dims entry, the
    design before)."""
    try:
        entry = lib.spp_pools_q8_dims
    except AttributeError:
        return None
    dims = (ctypes.c_int * 7)()
    D.check_launch("spp_pools_q8_dims",
                   entry(*shape[:3], shape[3] // 4, dims))
    return dims[0] * dims[1] * dims[2]


def turns(fns: dict) -> dict:
    """{label: {"cold": [ms, ms], "warm": [ms, ms]}}, in turns."""
    def warm_ms(fn):
        for _ in range(3):
            fn()
        return sum(CS.profiled_whole(torch, fn, 10, per_name=True)[1]
                   .values())

    res = {k: {"cold": [], "warm": []} for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            res[k]["cold"].append(CS.device_ms(torch, fns[k]))
            res[k]["warm"].append(warm_ms(fns[k]))
    return res


def run(out_path=None, previous=None) -> list[dict]:
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = [{"card": smi.stdout.strip()}]
    print(json.dumps(lines[0]), flush=True)
    libs = build(variants(previous))
    g = torch.Generator(device=dev).manual_seed(0)
    calls = [(ENTRY["pool_flat"], "pool_flat", c, s, KP.max_pool2_q8_plain)
             for c, s in K6_CALLS]
    calls.append((ENTRY["neck_flat"], "neck_flat", "SPP", K8_CALL,
                  KNF.spp_pools_q8_plain))
    for name, stem, call, shape, plain in calls:
        x = torch.randint(-128, 128, shape, generator=g, device=dev,
                          dtype=torch.int8)
        want = plain(x)
        fns = {}
        for (s, label), lib in libs.items():
            if s != stem:
                continue
            f = caller(lib, stem)
            if not torch.equal(f(x), want):
                raise AssertionError(f"{name} {label} differs at {shape}")
            fns[label] = lambda f=f: f(x)
        line = {"kernel": name, "call": call, "shape": list(shape),
                "ms": turns(fns)}
        if stem == "neck_flat":
            line["blocks"] = {label: blocks(lib, shape)
                              for (s, label), lib in libs.items() if s == stem}
        lines.append(line)
        print(json.dumps(line), flush=True)
    if out_path:
        pathlib.Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(out_path).write_text(json.dumps(lines, indent=1))
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write the lines here")
    p.add_argument("--previous", default=None,
                   help="csrc directory of the design before (its "
                        "pool_flat.cu and neck_flat.cu)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("pool_ab: no CUDA device", file=sys.stderr)
        return 2
    with torch.inference_mode():
        run(args.out, args.previous)
    return 0


if __name__ == "__main__":
    sys.exit(main())
