"""Minimal HTTP serving front-end for an exported OTPose artifact
(counterpart of ``tools/serve.py``).

    python -m otpose_tpu_torch.tools.serve --artifact OUTPUT_DIR/export
        [--host 127.0.0.1] [--port 8500] [--device cuda|cpu]

Loads an artifact written by ``python -m otpose_tpu_torch.cli.export``
(``engine/export.py::load_exported``: torch and the module that registers
the kernels' ops, no model code and no checkpoint) onto ``--device``
(``cuda`` unless ``cpu`` is asked for; without a GPU the default raises),
makes one warm-up call, then serves:

- ``GET /health`` -> the artifact's manifest (json);
- ``POST /predict`` with an ``.npz`` body holding ``inputs`` (B, H, W, 15)
  float32 and ``margin`` (B, 4) float32 -> json ``{"coords": ...,
  "maxvals": ..., "raw_coords": ...}`` (decoded artifacts) or
  ``{"heatmaps": ..., "teacher": ...}``.

A request smaller than the exported batch is zero-padded to it and the reply
sliced back; a larger one is answered 400 (the program's shapes are fixed:
export one artifact per serving batch).  Requests run in threads, one model
call at a time, so the device's stream sees one call after another.  Stdlib
``http.server`` only: a serving shim for tests and small deployments.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from otpose_tpu_torch.engine.export import load_exported


def _predict(model, arrays, lock: threading.Lock) -> dict:
    """Run one request's arrays through the loaded artifact, padding the
    batch to the exported one."""
    inputs = np.asarray(arrays["inputs"], np.float32)
    margin = np.asarray(arrays["margin"], np.float32)
    bs = model.meta["batch_size"]
    n = inputs.shape[0]
    if n > bs:
        raise ValueError(f"request batch {n} > exported batch {bs}")
    if margin.shape[0] != n:
        raise ValueError("inputs/margin batch mismatch")
    if n < bs:
        pad = bs - n
        inputs = np.concatenate([inputs, np.zeros((pad,) + inputs.shape[1:], np.float32)])
        margin = np.concatenate([margin, np.ones((pad, 4), np.float32)])
    with lock:
        outs = [o[:n].float().cpu().numpy() for o in model(inputs, margin)]
    names = ("coords", "maxvals", "raw_coords") if model.meta["decoded"] else ("heatmaps",
                                                                               "teacher")
    return {k: v.tolist() for k, v in zip(names, outs)}


def make_server(artifact_dir: str, host: str = "127.0.0.1", port: int = 8500,
                device=None) -> ThreadingHTTPServer:
    """Load the artifact, warm it up and build the server (not started;
    tests drive it on port 0)."""
    model = load_exported(artifact_dir, device=device)
    lock = threading.Lock()
    b = model.meta["batch_size"]
    w, h = model.meta["image_size"]
    model(np.zeros((b, h, w, 15), np.float32), np.ones((b, 4), np.float32))

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/health":
                self._send(200, model.meta)
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):  # noqa: N802
            if self.path != "/predict":
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                arrays = np.load(io.BytesIO(self.rfile.read(length)))
                self._send(200, _predict(model, arrays, lock))
            except Exception as e:  # noqa: BLE001 (a request's fault goes back to its client)
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):   # quiet: tests capture stdout
            pass

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8500)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    srv = make_server(args.artifact, args.host, args.port, device=args.device)
    print(f"serving {args.artifact} on http://{args.host}:{srv.server_port}", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
