"""``rep_yolo_tpu_torch.client`` against ``deploy/client.py`` (loaded by
its path), on the port's server (``serve.make_server`` on a CPU engine of
cfg/rep_yolo_tiny_test.yaml at 64 px) on a localhost port.

- The port's ``infer`` and the JAX ``infer`` get the same JSON for the same
  batch, and its detections equal a direct ``Engine`` call.
- ``main --mode image`` prints the same lines as the JAX ``main`` against
  the same server; ``--mode dummy`` runs.
- ``_request`` retries a stub server's 503 with backoff and raises on its
  400 without retrying.
"""

import importlib.util
import json
import pathlib
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import cv2
import numpy as np
import pytest

from rep_yolo_tpu_torch import client, serve
from rep_yolo_tpu_torch.data.datasets import read_image
from rep_yolo_tpu_torch.hub import letterbox_np
from test_torch_detect import SIZE, TINY

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_client():
    spec = importlib.util.spec_from_file_location(
        "jax_deploy_client", ROOT / "deploy" / "client.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _serve(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def engine_host():
    engine = serve.build_engine(TINY, None, SIZE, 2, 0.01, 0.45,
                                device="cpu")
    server = serve.make_server(engine, "127.0.0.1", 0)
    host = _serve(server)
    yield engine, host
    server.shutdown()
    server.server_close()
    engine.close()


def test_infer_same_json_as_the_jax_client(engine_host):
    engine, host = engine_host
    x = np.random.default_rng(0).uniform(0, 1, (2, SIZE, SIZE, 3))
    x = x.astype(np.float32)
    got = client.infer(host, x)
    want = _jax_client().infer(host, x)
    assert got["detections"] == want["detections"]
    assert got["detections"] == engine(x)
    assert sum(len(d) for d in got["detections"]) > 0
    assert set(got) == set(want) == {"detections", "ms"}


def test_main_image_prints_as_the_jax_main(engine_host, tmp_path, capsys):
    engine, host = engine_host
    img = cv2.GaussianBlur(np.random.default_rng(1).integers(
        0, 256, (50, 80, 3), np.uint8), (5, 5), 0)
    path = tmp_path / "im.jpg"
    cv2.imwrite(str(path), img)
    argv = ["--host", host, "--mode", "image", "--input", str(path),
            "--img-size", str(SIZE)]
    lines = []
    for main in (client.main, _jax_client().main):
        main(argv)
        out = capsys.readouterr().out.splitlines()
        # the reply's "ms" is a timing: the rest must agree
        lines.append([s if " detections in " not in s else s.split(" in ")[0]
                      for s in out])
    assert lines[0] == lines[1] and len(lines[0]) > 2
    # the printed rows are a direct engine call's, de-letterboxed
    boxed, r, (dw, dh) = letterbox_np(read_image(str(path)), SIZE)
    det = np.asarray(engine(boxed[None] / 255.0)[0])
    det[:, [0, 2]] = (det[:, [0, 2]] - dw) / r
    det[:, [1, 3]] = (det[:, [1, 3]] - dh) / r
    assert lines[0][2:] == ["   " + str([round(float(v), 1) for v in row])
                            for row in det]
    client.main(["--host", host, "--mode", "dummy", "--batch", "2",
                 "--iters", "2", "--img-size", str(SIZE)])
    assert "median latency" in capsys.readouterr().out


class _Stub(BaseHTTPRequestHandler):
    codes: list = []
    seen: list = []

    def log_message(self, *a):
        pass

    def do_GET(self):
        code = self.codes.pop(0)
        self.seen.append(code)
        body = json.dumps({"status": code}).encode()
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def test_request_retries_5xx_and_raises_on_4xx(monkeypatch):
    import urllib.error

    waits = []
    monkeypatch.setattr(client.time, "sleep", waits.append)
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    host = _serve(server)
    try:
        _Stub.codes[:] = [503, 503, 200]
        _Stub.seen[:] = []
        assert json.loads(client._request(f"{host}/x")) == {"status": 200}
        assert _Stub.seen == [503, 503, 200] and waits == [0.5, 1.0]
        _Stub.codes[:] = [400, 200]
        _Stub.seen[:] = []
        with pytest.raises(urllib.error.HTTPError) as e:
            client._request(f"{host}/x")
        assert e.value.code == 400 and _Stub.seen == [400]
        _Stub.codes[:] = [503] * 4
        with pytest.raises(RuntimeError, match="after 4 attempts"):
            client._request(f"{host}/x")
    finally:
        server.shutdown()
        server.server_close()
