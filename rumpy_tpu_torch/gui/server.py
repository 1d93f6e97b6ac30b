"""GUI backend server.

Port of ``rumpy_tpu/gui/server.py``: the routes and JSON of the reference's
model server, served by the standard library's ``ThreadingHTTPServer``,
with the single browser page ``index.html`` at "/":

  POST /super_resolve          {"image": <b64 png>, "metadata": "..."}
                               -> {"output": <b64 png>, "runtime": s}
  POST /super_resolve_and_crop {..., "x","y","width","height"}
  POST /super_resolve_bicubic  {"image": <b64>} -> bicubic upsample
  POST /update_model           {"model": <name-from-models.csv>}
  GET  /test_page              -> liveness text
  GET  /models                 -> registry listing

An unknown route answers 404 with ``{"error": "unknown route"}``, a failing
request 500 with ``{"error": <message>}``. :class:`ModelServer` runs the
port's ``SISRInterface`` on the card unless the caller asks for
``device="cpu"``; the bicubic route is Pillow's resize bit for bit
(``ops/resize.py::pil_resize``) on the same device. Images go both ways as
PNGs through the standard-library codec of ``gui/png.py`` (no Pillow), and
``models_csv`` is read with the ``csv`` module.

    python -m rumpy_tpu_torch.gui.server Results --port 5000 \\
        --default_model rcan_x4 [--device cpu]
"""

from __future__ import annotations

import argparse
import base64
import csv
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np
import torch

from rumpy_tpu_torch.device import resolve_device
from rumpy_tpu_torch.gui.png import decode_png, encode_png
from rumpy_tpu_torch.ops.resize import pil_resize


class ModelServer:
    def __init__(self, model_loc: str, models_csv: Optional[str] = None,
                 default_model: Optional[str] = None, scale: int = 4, device=None):
        self.model_loc = model_loc
        self.scale = scale
        self.device = resolve_device(device)
        self.registry: Dict[str, Dict] = {}
        if models_csv and os.path.isfile(models_csv):
            with open(models_csv, newline="") as f:
                for row in csv.DictReader(f):
                    self.registry[row["name"]] = row
        self.interface = None
        # one request at a time on the model (the server answers on threads)
        self._lock = threading.Lock()
        if default_model:
            self.load_model(default_model)

    def load_model(self, name: str) -> None:
        from rumpy_tpu_torch.interface import SISRInterface
        spec = self.registry.get(name, {"experiment": name})
        epoch = spec.get("epoch") or "best"
        with self._lock:
            self.interface = SISRInterface(
                model_loc=self.model_loc, experiment=spec["experiment"], mode="eval",
                load_epoch=int(epoch) if str(epoch).isdigit() else epoch,
                no_directories=True, device=self.device)
            self.current_model = name

    # -- images as base64 PNGs ------------------------------------------

    @staticmethod
    def _decode_b64(b64_string: str) -> np.ndarray:
        """A base64 PNG (or a ``data:image/png;base64,`` URL) as (H, W, 3)
        float32 RGB in [0, 1]: grey repeated, alpha dropped."""
        raw = base64.b64decode(b64_string.split(",")[-1])
        img = decode_png(raw)
        img = np.repeat(img[..., :1], 3, axis=-1) if img.shape[-1] < 3 else img[..., :3]
        return img.astype(np.float32) / 255.0

    @staticmethod
    def _encode_b64(img) -> str:
        """(H, W, 3) float RGB in [0, 1] as a base64 RGB PNG, rounded."""
        u8 = (np.clip(np.asarray(img), 0, 1) * 255).round().astype(np.uint8)
        return base64.b64encode(encode_png(u8)).decode()

    @staticmethod
    def _parse_metadata(meta_string: Optional[str]) -> Optional[np.ndarray]:
        if not meta_string:
            return None
        vals = [float(v) for v in str(meta_string).replace(",", " ").split()]
        return np.asarray(vals, np.float32)[None]

    def bicubic(self, img: np.ndarray) -> np.ndarray:
        """Pillow's bicubic upsample by ``scale`` of the image truncated to
        uint8, on the server's device."""
        u8 = torch.from_numpy((img * 255).astype(np.uint8)).to(self.device)
        h, w = u8.shape[:2]
        out = pil_resize(u8, (h * self.scale, w * self.scale))
        return out.cpu().numpy().astype(np.float32) / 255.0

    def super_resolve(self, img: np.ndarray, metadata: Optional[np.ndarray] = None):
        if self.interface is None:
            raise RuntimeError("No model loaded; POST /update_model first")
        inp = img
        if getattr(self.interface.model, "im_input", "") == "interp":
            inp = self.bicubic(img)
        with self._lock:
            t0 = time.perf_counter()
            # zero-padded to multiples of 8 px, as the JAX server buckets
            # its compiled shapes
            rgb, _, _, _ = self.interface.net_run_and_process(
                inp[None], metadata=metadata, pad_multiple=8)
            return rgb[0], time.perf_counter() - t0


def make_handler(server: ModelServer):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, payload, code=200):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                page = os.path.join(os.path.dirname(__file__), "index.html")
                with open(page, "rb") as f:
                    body = f.read()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/test_page":
                self._json({"status": "rumpy_tpu model server alive",
                            "model": getattr(server, "current_model", None)})
            elif self.path == "/models":
                self._json({"models": list(server.registry) or ["<by experiment name>"]})
            else:
                self._json({"error": "unknown route"}, 404)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/update_model":
                    server.load_model(req["model"])
                    self._json({"status": "ok", "model": req["model"]})
                    return
                img = server._decode_b64(req["image"])
                if self.path.endswith("_and_crop"):
                    # x/y/width/height select a region of the INPUT, which
                    # is then super-resolved
                    x, y = int(req["x"]), int(req["y"])
                    w, h = int(req["width"]), int(req["height"])
                    img = img[y:y + h, x:x + w]
                if self.path.startswith("/super_resolve_bicubic"):
                    out = server.bicubic(img)
                    runtime = 0.0
                elif self.path.startswith("/super_resolve"):
                    meta = server._parse_metadata(req.get("metadata"))
                    out, runtime = server.super_resolve(img, meta)
                else:
                    self._json({"error": "unknown route"}, 404)
                    return
                self._json({"output": server._encode_b64(out), "runtime": runtime})
            except Exception as e:  # the page shows the message
                self._json({"error": str(e)}, 500)

    return Handler


def make_server(model_loc: str, port: int = 5000, host: str = "127.0.0.1",
                **kwargs) -> ThreadingHTTPServer:
    """The HTTP server of a :class:`ModelServer` (``kwargs``), bound to
    ``host:port`` (port 0: a free one) and not yet serving."""
    return ThreadingHTTPServer((host, port), make_handler(ModelServer(model_loc, **kwargs)))


def run_server(model_loc: str, port: int = 5000, **kwargs):
    httpd = make_server(model_loc, port, **kwargs)
    print(f"rumpy_tpu GUI backend on http://127.0.0.1:{httpd.server_address[1]}")
    httpd.serve_forever()


def main(argv=None):
    p = argparse.ArgumentParser(prog="rumpy_tpu_torch.gui.server",
                                description="Serve a trained model to the browser page.")
    p.add_argument("model_loc", nargs="?", default=".",
                   help="The folder holding the experiments.")
    p.add_argument("port", nargs="?", type=int, default=5000)
    p.add_argument("--models_csv", default=None,
                   help="CSV of selectable models: name, experiment[, epoch].")
    p.add_argument("--default_model", default=None, help="Experiment (or name) to load.")
    p.add_argument("--scale", type=int, default=4, help="The bicubic route's scale.")
    p.add_argument("--device", default=None, help="torch device; default cuda.")
    args = p.parse_args(argv)
    run_server(args.model_loc, port=args.port, models_csv=args.models_csv,
               default_model=args.default_model, scale=args.scale, device=args.device)


if __name__ == "__main__":
    main()
