"""Minimal production-style serving endpoint over an exported artifact.

Loads the artifact written by :mod:`cli.export` (weights plus manifest; the
port's own model code rebuilds the generators, see there why this is not a
self-contained program as the JAX package's StableHLO artifact is), or the
directory the JAX package's ``cli/export.py`` writes
(``predict_{A,B}.stablehlo``, lowered for any platforms: run by the port's
StableHLO interpreter, ``eval/stablehlo.py``, without JAX; both programs
are read and checked before the socket binds), and serves the two
generator directions over HTTP with stdlib-only machinery:

  POST /predict_B   body = .npz bytes with array  A (N,H,W,C) float32 in
                    [-1,1] and optionally z (N,nlatent); z is sampled from
                    the standard-normal prior when absent (the
                    many-to-many direction needs a z per sample)
  POST /predict_A   body = .npz bytes with array B (N,H,W,C)
  GET  /            the export manifest (shapes/dtypes/model), JSON

Responses are .npy bytes of the generated batch (float32).  Requests of any N
are handled by padding to the artifact's fixed serving batch and chunking
above it, so the generators only ever see one shape.  On a CUDA device every
norm site of a request to the port's own artifact runs the hand-written
instance-norm kernel; the JAX package's export runs as the library calls its
StableHLO ops map to, and no hand-written kernel.

Usage:
  python -m domain_transfer_gan_torch.cli.export --expr_dir ckpt/exp \
      --params exp_params.npz --out /srv/exp1 --serve_dtype bfloat16
  python -m domain_transfer_gan_torch.cli.serve --export_dir /srv/exp1 \
      --port 8000 --device cuda
  # a directory of the JAX package's export, e.g. written on a TPU host by
  #   python -m domain_transfer_gan_tpu.cli.export --chk_path ... --out /srv/j
  python -m domain_transfer_gan_torch.cli.serve --export_dir /srv/j \
      --port 8000 --device cuda
"""

from __future__ import annotations

import argparse
import io
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..utils.jax_export import lowering_index
from .export import artifact_kind, load_exported


class ExportedEndpoint:
    """Batch-shape-stable wrapper around one exported generator."""

    def __init__(self, export_dir: str, name: str, batch: int,
                 device="cuda"):
        self.device = torch.device(device)
        self.fn = load_exported(export_dir, name, self.device)
        self.batch = batch

    def __call__(self, *arrays: np.ndarray,
                 plain_norm: bool = False) -> np.ndarray:
        n = arrays[0].shape[0]
        outs = []
        for lo in range(0, n, self.batch):
            chunk = [a[lo:lo + self.batch] for a in arrays]
            m = chunk[0].shape[0]
            if m < self.batch:  # pad the tail to the serving batch
                chunk = [np.concatenate(
                    [c, np.zeros((self.batch - m,) + c.shape[1:], c.dtype)])
                    for c in chunk]
            # one copy in, one copy out; the final .cpu() is the only
            # synchronisation with the device
            y = self.fn(*[torch.from_numpy(np.ascontiguousarray(c))
                          for c in chunk], plain_norm=plain_norm)
            outs.append(y.cpu().numpy()[:m])
        return np.concatenate(outs) if len(outs) > 1 else outs[0]


def build_server(export_dir: str, host: str = "127.0.0.1",
                 port: int = 8000, device="cuda") -> ThreadingHTTPServer:
    with open(os.path.join(export_dir, "manifest.json")) as f:
        manifest = json.load(f)
    device = torch.device(device)
    kind = artifact_kind(export_dir)
    # fail FAST on a platform mismatch (otherwise every request 500s); the
    # JAX package's StableHLO runs on any device (see load_exported)
    plats = manifest.get("platforms")
    if kind == "pt" and plats and device.type not in plats:
        raise ValueError(
            "artifact %s was exported for platforms %s but this server runs "
            "on %r; re-export with `--device %s`, or serve with "
            "`--device %s`" % (export_dir, plats, device.type, device.type,
                               plats[0]))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serving on %s needs a CUDA device and there is "
                           "none; pass --device cpu with an artifact "
                           "exported for cpu" % device)
    batch = int(manifest["batch"])
    nlatent = int(manifest["nlatent"])
    endpoints = {
        "/predict_B": (ExportedEndpoint(export_dir, "predict_B", batch,
                                        device), ("A", "z")),
        "/predict_A": (ExportedEndpoint(export_dir, "predict_A", batch,
                                        device), ("B",)),
    }
    if kind == "stablehlo":
        i = lowering_index(plats)
        print("%s: the JAX package's export, interpreted StableHLO on %s "
              "(no hand-written kernel runs); lowered for %s, running %s"
              % (export_dir, device, ", ".join(plats),
                 "its one lowering" if i is None else
                 "lowering %d (%s)" % (i, plats[i])), flush=True)
    # the same stream of prior draws as the JAX package's server
    rng = np.random.RandomState(0)
    rng_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, msg: str):
            self._reply(code, json.dumps({"error": msg}).encode(),
                        "application/json")

        def do_GET(self):
            if self.path != "/":
                return self._error(404, "unknown path %r" % self.path)
            self._reply(200, json.dumps(manifest).encode(),
                        "application/json")

        def do_POST(self):
            if self.path not in endpoints:
                return self._error(404, "unknown path %r" % self.path)
            fn, names = endpoints[self.path]
            try:
                length = int(self.headers.get("Content-Length", "0"))
                with np.load(io.BytesIO(self.rfile.read(length))) as z:
                    payload = {k: np.asarray(z[k], np.float32) for k in
                               z.files}
            except Exception as e:
                return self._error(400, "bad npz payload: %r" % (e,))
            if names[0] not in payload:
                return self._error(400, "payload needs array %r" % names[0])
            x = payload[names[0]]
            hw = int(manifest["grid_size"])
            nc = int(manifest["input_nc" if names[0] == "A"
                              else "output_nc"])
            if x.ndim != 4 or x.shape[1:] != (hw, hw, nc):
                return self._error(400, "%s must be (N, %d, %d, %d), got %r"
                                   % (names[0], hw, hw, nc, x.shape))
            if x.shape[0] == 0:
                return self._error(400, "%s holds no sample" % names[0])
            args = [x]
            if "z" in names:
                if "z" in payload:
                    zv = payload["z"]
                    if zv.shape != (x.shape[0], nlatent):
                        return self._error(400, "z must be (%d, %d), got %r"
                                           % (x.shape[0], nlatent,
                                              zv.shape))
                else:
                    with rng_lock:
                        zv = rng.randn(x.shape[0], nlatent).astype(
                            np.float32)
                args.append(zv)
            try:
                y = fn(*args)
            except Exception as e:
                return self._error(500, "inference failed: %r" % (e,))
            buf = io.BytesIO()
            np.save(buf, y)
            self._reply(200, buf.getvalue(), "application/octet-stream")

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--export_dir", required=True,
                    help="directory written by cli.export, the port's or "
                         "the JAX package's")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    srv = build_server(args.export_dir, args.host, args.port, args.device)
    print("serving %s on http://%s:%d (POST /predict_B, /predict_A)"
          % (args.export_dir, *srv.server_address))
    srv.serve_forever()


if __name__ == "__main__":
    main()
