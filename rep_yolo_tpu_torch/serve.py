"""Model-serving HTTP server on the card (port of ``deploy/server.py``).

The engine is the fused float32 deploy forward, the top-k decode and the
CUDA NMS kernel; with ``--fast int8`` the backbone, neck and head run as the
calibrated int8 region (``models/region.py``) on the int8 kernels, with
float islands at the attention blocks. ``build_engine(dtype=torch.bfloat16,
der_fast="bf16")`` serves the bfloat16 model of the JAX ``bench.py``, with
the DER blocks on the channel-major kernels (no CLI flag, as in the JAX
server). Requests are padded to ``max_batch`` so every call runs the same
shapes.

Protocol (stdlib only):
  POST /v1/infer  body: raw float32 NHWC letterboxed images in [0, 1];
      header X-Shape: "B,H,W,3" (H = W = the served size, B <= max batch)
  -> JSON {"detections": [[[x1, y1, x2, y2, conf, cls], ...] per image],
           "ms": float}
  GET /v1/health -> {"status": "ok", "device": ..., ...}

Run:  python -m rep_yolo_tpu_torch.serve --weights tests/golden/model_weights.npz [--fast int8]
"""

from __future__ import annotations

import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from rep_yolo_tpu_torch.device import resolve_device
from rep_yolo_tpu_torch.models.model import RepYOLO
from rep_yolo_tpu_torch.ops.nms import Detections, non_max_suppression
from rep_yolo_tpu_torch.ops.quant import enable_int8_fast_path
from rep_yolo_tpu_torch.utils.weights import load_reference_npz


class Engine:
    """Fused model + fixed-shape inference at (max_batch, size, size, 3).

    Calls run on one persistent worker thread: PyTorch creates its cuDNN
    and cuBLAS handles per thread on first use, which a server spawning a
    thread per request would otherwise pay on every request."""

    def __init__(self, model: RepYOLO, img_size: int, max_batch: int,
                 conf: float, iou: float):
        self.model, self.img_size, self.max_batch = model, img_size, max_batch
        self.conf, self.iou = conf, iou
        self.device = model.device
        self.dtype = model.net.dtype or torch.float32
        self._worker = ThreadPoolExecutor(1, thread_name_prefix="engine")

    @torch.inference_mode()
    def infer(self, x: torch.Tensor) -> Detections:
        """x (max_batch, size, size, 3) on the engine's device, in its
        dtype."""
        if self.model.cfg.nc == 1:
            # exact for nc == 1: logit-level gate + top-k decode, NMS
            # takes the rows presorted
            pred = self.model.predict_topk(x, k=1024, conf_thres=self.conf)
            return non_max_suppression(pred, self.conf, self.iou,
                                       presorted=True)
        pred = self.model.predict(x)
        return non_max_suppression(pred, self.conf, self.iou, max_nms=1024,
                                   nc=self.model.cfg.nc)

    def __call__(self, images: np.ndarray) -> list[list[list[float]]]:
        """Pad a (B, S, S, 3) f32 batch to max_batch, infer, and return the
        valid rows [x1, y1, x2, y2, conf, cls] per image of the request."""
        return self._worker.submit(self._run, images).result()

    def close(self) -> None:
        """Stop the worker thread."""
        self._worker.shutdown()

    def _run(self, images: np.ndarray) -> list[list[list[float]]]:
        b = images.shape[0]
        if b > self.max_batch:
            raise ValueError(f"batch {b} > max {self.max_batch}")
        if images.shape[1:] != (self.img_size, self.img_size, 3):
            raise ValueError(f"served shape is ({self.img_size}, "
                             f"{self.img_size}, 3), got {images.shape[1:]}")
        # copied in as float32, cast on the device
        x = torch.zeros((self.max_batch, *images.shape[1:]), dtype=self.dtype,
                        device=self.device)
        x[:b] = torch.tensor(images, dtype=torch.float32).to(self.device)
        det = self.infer(x)
        rows = torch.cat([det.boxes, det.scores[..., None],
                          det.classes[..., None].float()], -1).cpu().numpy()
        valid = det.valid.cpu().numpy()
        return [rows[i][valid[i]].tolist() for i in range(b)]


def calibration_batch(img_size: int, device) -> torch.Tensor:
    """The default calibration batch: two seeded uniform images, as
    bench.py calibrates its int8 mode (numpy's generator stands in for
    JAX's)."""
    x = np.random.default_rng(2).uniform(0, 1, (2, img_size, img_size, 3))
    return torch.from_numpy(x.astype(np.float32)).to(device)


def build_engine(cfg: str, weights: str | None, img_size: int,
                 max_batch: int, conf: float, iou: float,
                 device=None, fast: str | None = None,
                 calib: torch.Tensor | None = None,
                 dtype: torch.dtype = torch.float32,
                 der_fast: str | None = None) -> Engine:
    """Build, load (a reference-keyed .npz, else a seeded init), fuse and
    warm the engine. float32 by default: TF32 is turned off for cuDNN and
    matmuls, as the JAX server runs its convs at full f32 precision; cuDNN
    keeps to deterministic algorithms, so a request repeated gives the same
    detections. ``fast="int8"`` calibrates on ``calib`` (NHWC images in
    [0, 1]; default ``calibration_batch``) and serves the int8 region as
    the JAX package's ``--fast int8`` does: the backbone, the neck and the
    IDetect convs in int8, the CA / CCVA / ADD attention blocks in float
    (``models/region.py``). ``Q8Region(scales, neck=False)`` set on the
    engine's network keeps the backbone region alone.

    ``dtype=torch.bfloat16`` casts the fused model (``RepYOLO.cast``: the
    attention islands stay float32) and serves bfloat16 images;
    ``der_fast="bf16"`` also runs the DER blocks on K10 / K11
    (``DetectionNet.set_der_fast``)."""
    if fast not in (None, "int8"):
        raise ValueError(f"unknown fast path {fast!r}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unknown serving dtype {dtype}")
    if fast == "int8" and (dtype != torch.float32 or der_fast is not None):
        raise ValueError("fast='int8' serves the float32 model without "
                         "der_fast")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    model = RepYOLO.from_config(cfg, device=dev)
    if weights:
        model.load_state(load_reference_npz(weights))
    else:
        model.init(torch.Generator().manual_seed(0))
    model = model.fuse()
    if dtype != torch.float32:
        model.cast(dtype)
    model.net.set_der_fast(der_fast)
    if fast == "int8":
        enable_int8_fast_path(model, calib if calib is not None
                              else calibration_batch(img_size, dev))
    engine = Engine(model, img_size, max_batch, conf, iou)
    engine(np.zeros((max_batch, img_size, img_size, 3), np.float32))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return engine


def make_handler(engine: Engine):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/v1/health":
                return self._json(404, {"error": "not found"})
            self._json(200, {"status": "ok", "device": str(engine.device),
                             "img_size": engine.img_size,
                             "max_batch": engine.max_batch,
                             "int8": engine.model.net.q8 is not None,
                             "dtype": str(engine.dtype).split(".")[-1],
                             "der_fast": engine.model.net.der_fast})

        def do_POST(self):
            if self.path != "/v1/infer":
                return self._json(404, {"error": "not found"})
            try:
                shape = tuple(int(v) for v in
                              self.headers.get("X-Shape", "").split(","))
                raw = self.rfile.read(int(self.headers["Content-Length"]))
                if len(raw) != int(np.prod(shape)) * 4:
                    raise ValueError(f"body {len(raw)} bytes != shape {shape}")
                x = np.frombuffer(raw, np.float32).reshape(shape)
                t0 = time.perf_counter()
                dets = engine(x)
                ms = (time.perf_counter() - t0) * 1e3
                self._json(200, {"detections": dets, "ms": ms})
            except Exception as e:  # noqa: BLE001 - reported to the client
                self._json(400, {"error": str(e)})

    return Handler


def make_server(engine: Engine, host: str = "0.0.0.0",
                port: int = 8000) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), make_handler(engine))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cfg", default="cfg/rep_yolo.yaml")
    p.add_argument("--weights", default=None,
                   help="reference-keyed .npz (default: seeded random init)")
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default=None)
    p.add_argument("--fast", default=None, choices=["int8"],
                   help="'int8': calibrate on seeded uniform images and run "
                        "the backbone, neck and head as the int8 region on "
                        "the int8 kernels, the attention blocks in float "
                        "(the JAX package's --fast int8)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    engine = build_engine(args.cfg, args.weights, args.img_size,
                          args.max_batch, args.conf, args.iou, args.device,
                          fast=args.fast)
    srv = make_server(engine, args.host, args.port)
    print(f"serving on {args.host}:{srv.server_address[1]} (size "
          f"{args.img_size}, max batch {args.max_batch}, {engine.device}, "
          f"{args.fast or 'float32'})")
    srv.serve_forever()


if __name__ == "__main__":
    main()
