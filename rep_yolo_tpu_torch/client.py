"""Serving client (port of ``deploy/client.py``, the counterpart of the
reference's Triton gRPC client, reference
deploy/triton-inference-server/client.py: image / dummy modes, CPU
letterbox pre/post). Talks to ``rep_yolo_tpu_torch.serve`` (or the JAX
``deploy/server.py``: the wire protocol is the same byte for byte) over
HTTP from the host; the card is the server's.

  python -m rep_yolo_tpu_torch.client --mode dummy --batch 4
  python -m rep_yolo_tpu_torch.client --mode image --input img.jpg
"""

from __future__ import annotations

import argparse
import json
import time
import urllib.error
import urllib.request

import numpy as np

TIMEOUT_S = 120.0   # first request pays the server's jit compile
RETRIES = 3


def _request(url: str, data: bytes | None = None,
             headers: dict | None = None,
             timeout: float = TIMEOUT_S, retries: int = RETRIES) -> bytes:
    """GET/POST with timeout + exponential-backoff retry on transient
    failures (connection refused while the server warms up, 5xx, socket
    timeouts). 4xx client errors are not retried."""
    last: Exception | None = None
    for attempt in range(retries + 1):
        try:
            req = urllib.request.Request(url, data=data,
                                         headers=headers or {})
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code < 500:
                raise
            last = e
        except (urllib.error.URLError, TimeoutError, OSError) as e:
            last = e
        if attempt < retries:
            wait = 0.5 * 2 ** attempt
            print(f"request failed ({last}); retry {attempt + 1}/{retries} "
                  f"in {wait:.1f}s")
            time.sleep(wait)
    raise RuntimeError(f"{url} failed after {retries + 1} attempts: {last}")


def infer(host: str, batch: np.ndarray,
          timeout: float = TIMEOUT_S) -> dict:
    body = _request(
        f"{host}/v1/infer", data=batch.astype(np.float32).tobytes(),
        headers={"X-Shape": ",".join(map(str, batch.shape)),
                 "Content-Type": "application/octet-stream"},
        timeout=timeout)
    return json.loads(body)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="http://127.0.0.1:8000")
    p.add_argument("--mode", default="dummy", choices=["dummy", "image"])
    p.add_argument("--input", default=None)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args(argv)

    print("health:", _request(f"{args.host}/v1/health",
                              timeout=10.0).decode())

    if args.mode == "dummy":
        x = np.random.rand(args.batch, args.img_size, args.img_size,
                           3).astype(np.float32)
        times = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            out = infer(args.host, x)
            times.append(time.perf_counter() - t0)
        lat = np.median(times) * 1e3
        print(f"median latency {lat:.1f} ms  "
              f"({args.batch / np.median(times):.1f} img/s)  "
              f"device ms {out['ms']:.1f}")
    else:
        from rep_yolo_tpu_torch.data.datasets import read_image
        from rep_yolo_tpu_torch.hub import letterbox_np

        img = read_image(args.input)
        boxed, r, (dw, dh) = letterbox_np(img, args.img_size)
        out = infer(args.host, boxed[None] / 255.0)
        det = np.asarray(out["detections"][0])
        if len(det):
            det[:, [0, 2]] = (det[:, [0, 2]] - dw) / r
            det[:, [1, 3]] = (det[:, [1, 3]] - dh) / r
        print(f"{len(det)} detections in {out['ms']:.1f} ms")
        for row in det:
            print("  ", [round(float(v), 1) for v in row])


if __name__ == "__main__":
    main()
