"""Micro-batching HTTP serving daemon (the port of
``seghiero_tpu/serve/server.py``).

  model (reference .pth)  →  Predictor on the card  →  this process  →  HTTP

* ONE dispatcher thread owns the device. HTTP handler threads decode the
  request and park on an event; every torch call happens on the
  dispatcher.
* micro-batching: concurrent requests are coalesced (up to ``max_batch``,
  waiting at most ``batch_timeout_s`` after the first arrival) into one
  device call, run at the real batch size — eager PyTorch compiles nothing
  per shape, so a partial batch is not padded with repeated images.
* bounded admission: past ``max_queue`` pending requests the server sheds
  load with an immediate 503 + Retry-After.
* the response contract is the JAX serving artifact's: uint8 masks for
  levels with ≤256 classes, else int32, and the same ``/meta`` fields
  (``torch_version`` in place of ``jax_version``; ``size_artifacts`` is
  empty, since nothing is exported).

Endpoints:
  GET  /healthz   liveness + the device (``torch.cuda.get_device_name`` or cpu)
  GET  /meta      shapes, levels, class names
  GET  /stats     request/batch/shed counters + queue depth
  POST /predict   body = PNG/JPEG or a raw npy array [H,W,3] u8, any size;
                  resized to the model's input size, masks returned at the
                  request's own size.
                  ?format=json (default) → {"fine": [[...]], ...}
                  ?format=npz            → npz bytes, one array/level
                  ?format=png&level=fine → PNG of that level's mask
                  503 when the admission queue is full; 504 on timeout.

CLI:  python -m seghiero_torch.serve --config C [--checkpoint X.pth]
          [--consistent] [--max-batch 8] [--batch-timeout-ms 3]
          [--max-queue 32] [--device cuda] [--port 8765]
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from seghiero_torch.data.transforms import resize_mask_nearest
from seghiero_torch.infer.predictor import Predictor


def _mask_dtype(n_classes: int) -> torch.dtype:
    return torch.uint8 if n_classes <= 256 else torch.int32


class ServingModel:
    """A loaded predictor + the serving calling convention: one input size
    (the config's ``transform.resize``), masks at that size. Single
    consumer: call ``predict`` from one thread (the dispatcher)."""

    def __init__(self, predictor: Predictor, consistent: bool = False):
        cfg = predictor.cfg
        input_hw = tuple(cfg.transform.resize or ())
        if len(input_hw) != 2:
            raise ValueError(
                "serving needs a static input size: set transform.resize in the config"
            )
        self.predictor = predictor
        self.consistent = bool(consistent)
        self.input_hw = (int(input_hw[0]), int(input_hw[1]))
        h = cfg.hierarchy
        levels = {"fine": h.n_fine, "coarse": h.n_coarse}
        names = {
            "fine": [cfg.fine_names[i] for i in sorted(cfg.fine_names)],
            "coarse": [cfg.coarse_names[i] for i in sorted(cfg.coarse_names)],
        }
        if h.has_super:
            levels["super"] = h.n_super
            names["super"] = [cfg.super_names[i] for i in sorted(cfg.super_names)]
        self._dtypes = {lvl: _mask_dtype(n) for lvl, n in levels.items()}
        hw = list(self.input_hw)
        self.meta = {
            "input": {"shape": ["b", *hw, 3], "dtype": "uint8", "layout": "NHWC (RGB)"},
            "outputs": {
                lvl: {"shape": ["b", *hw], "dtype": str(dt).replace("torch.", "")}
                for lvl, dt in self._dtypes.items()
            },
            "levels": levels,
            "class_names": names,
            "consistent_decode": self.consistent,
            "platforms": [predictor.device.type],
            "torch_version": torch.__version__,
            "input_sizes": [hw],
            "size_artifacts": {},
        }

    def predict(self, images_u8: np.ndarray) -> Dict[str, np.ndarray]:
        """Run the batch as given (no padding) → per-level masks in the
        serving dtypes, on the host."""
        masks = self.predictor.predict_masks(
            images_u8, self.input_hw, consistent=self.consistent
        )
        return {lvl: m.to(self._dtypes[lvl]).cpu().numpy() for lvl, m in masks.items()}

    def warmup(self, max_batch: int) -> None:
        """One call at every batch size the dispatcher can form, so no
        request pays the kernels' build or cuDNN's first-call set-up. Call
        it on the thread that will serve: cuDNN keeps its execution plans
        per thread (``MicroBatcher`` does so)."""
        for b in range(1, max_batch + 1):
            self.predict(np.zeros((b, *self.input_hw, 3), np.uint8))


@dataclass
class _Pending:
    image: np.ndarray
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[Dict[str, np.ndarray]] = None
    error: Optional[str] = None


class Overloaded(RuntimeError):
    """The admission queue is full — shed the request (HTTP 503)."""


class MicroBatcher:
    """Coalesce concurrent requests into device batches.

    The dispatcher blocks for the first request, then drains the queue for
    up to ``batch_timeout_s`` or until ``max_batch`` requests are in hand,
    and issues ONE device call for the group. The admission queue holds at
    most ``max_queue`` requests (default 4×max_batch). The constructor
    returns once the dispatcher has warmed the model up at every batch
    size, and raises if that failed."""

    def __init__(self, model: ServingModel, max_batch: int = 8,
                 batch_timeout_s: float = 0.003, max_queue: int = 0):
        self.model = model
        self.max_batch = max_batch
        self.batch_timeout_s = batch_timeout_s
        self.max_queue = max_queue or 4 * max_batch
        self.q: "queue.Queue[Optional[_Pending]]" = queue.Queue(maxsize=self.max_queue)
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "batches": 0, "shed": 0, "batch_sizes": {}}
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._warmup_error: Optional[Exception] = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        self._ready.wait()
        if self._warmup_error is not None:
            raise RuntimeError("warm-up on the dispatcher thread failed") from self._warmup_error

    @property
    def stats(self) -> Dict:
        with self._stats_lock:
            snap = dict(self._stats)
            snap["batch_sizes"] = dict(self._stats["batch_sizes"])
        snap["queue_depth"] = self.q.qsize()
        snap["max_queue"] = self.max_queue
        return snap

    def submit(self, image: np.ndarray, timeout_s: float = 60.0) -> Dict[str, np.ndarray]:
        p = _Pending(image)
        try:
            self.q.put_nowait(p)
        except queue.Full:
            with self._stats_lock:
                self._stats["shed"] += 1
            raise Overloaded(f"admission queue full ({self.max_queue} pending)") from None
        if not p.done.wait(timeout_s):
            raise TimeoutError("prediction timed out")
        if p.error is not None:
            raise RuntimeError(p.error)
        return p.result

    def stop(self) -> None:
        self._stop.set()
        try:
            self.q.put_nowait(None)  # unblock the dispatcher
        except queue.Full:
            pass  # dispatcher is mid-group; it re-checks _stop next loop
        self.thread.join(timeout=5)

    def _run(self) -> None:
        # on this thread, the one that serves: cuDNN's execution plans built
        # by a warm-up on another thread would not be found here, and the
        # first request of each batch size would pay ~0.1 s to rebuild them
        try:
            self.model.warmup(self.max_batch)
        except Exception as e:  # handed to the constructor, which raises
            self._warmup_error = e
            return
        finally:
            self._ready.set()
        while not self._stop.is_set():
            first = self.q.get()
            if first is None:
                continue
            group = [first]
            deadline = time.monotonic() + self.batch_timeout_s
            while len(group) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    nxt = self.q.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                group.append(nxt)
            try:
                out = self.model.predict(np.stack([p.image for p in group], axis=0))
                for i, p in enumerate(group):
                    p.result = {k: v[i] for k, v in out.items()}
            except Exception as e:  # deliver the failure to every waiter
                for p in group:
                    p.error = f"{type(e).__name__}: {e}"
            for p in group:
                p.done.set()
            key = str(len(group))
            with self._stats_lock:
                self._stats["requests"] += len(group)
                self._stats["batches"] += 1
                self._stats["batch_sizes"][key] = self._stats["batch_sizes"].get(key, 0) + 1


def _decode_request(body: bytes, content_type: str) -> np.ndarray:
    """Request bytes → u8 [H, W, 3] at the request's native size."""
    if "octet-stream" in content_type or body[:6] == b"\x93NUMPY":
        arr = np.load(io.BytesIO(body), allow_pickle=False)
        if arr.ndim != 3 or arr.shape[-1] != 3:
            raise ValueError(f"npy must be [H,W,3] u8, got {arr.shape}")
        return arr.astype(np.uint8)
    from PIL import Image

    img = Image.open(io.BytesIO(body)).convert("RGB")
    return np.asarray(img, np.uint8)


def _route_to_bucket(arr: np.ndarray, model: ServingModel) -> Tuple[np.ndarray, tuple]:
    """(native array) → (array at the model's input size, native hw); masks
    are resized back to the native size after prediction."""
    native_hw = tuple(arr.shape[:2])
    h, w = model.input_hw
    if native_hw != (h, w):
        from PIL import Image

        arr = np.asarray(Image.fromarray(arr).resize((w, h), Image.BILINEAR), np.uint8)
    return arr, native_hw


def _encode_response(preds: Dict[str, np.ndarray], fmt: str, level: str):
    """→ (bytes, content_type)."""
    if fmt == "npz":
        buf = io.BytesIO()
        np.savez(buf, **preds)
        return buf.getvalue(), "application/octet-stream"
    if fmt == "png":
        from PIL import Image

        if level not in preds:
            raise ValueError(f"unknown level {level!r}; have {sorted(preds)}")
        arr = preds[level]
        if int(arr.max(initial=0)) > 255:
            raise ValueError("png format supports <=256 classes; use npz")
        buf = io.BytesIO()
        Image.fromarray(arr.astype(np.uint8), mode="L").save(buf, format="PNG")
        return buf.getvalue(), "image/png"
    body = json.dumps({k: v.tolist() for k, v in preds.items()})
    return body.encode(), "application/json"


class _HTTPServer(ThreadingHTTPServer):
    # The listen backlog must hold a burst of concurrent connections. At the
    # socketserver default of 5, the kernel drops the connects beyond it and
    # each of those clients retries only after its 1 s SYN timeout, which
    # becomes their latency (and they never reach the admission queue's 503).
    request_queue_size = 128


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def make_server(model: ServingModel, host: str = "127.0.0.1", port: int = 8765,
                max_batch: int = 8, batch_timeout_ms: float = 3.0,
                quiet: bool = True, max_queue: int = 0) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server, after the dispatcher has
    warmed the model up. ``server.batcher`` owns the dispatcher thread;
    call ``server.batcher.stop()`` on shutdown."""
    batcher = MicroBatcher(model, max_batch, batch_timeout_ms / 1e3, max_queue=max_queue)
    health = json.dumps({
        "status": "ok",
        "platform": model.predictor.device.type,
        "device": _device_name(model.predictor.device),
    }).encode()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            if not quiet:
                BaseHTTPRequestHandler.log_message(self, fmt, *args)

        def _send(self, code: int, body: bytes, ctype: str = "application/json",
                  headers: Optional[Dict[str, str]] = None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._send(200, health)
            elif path == "/meta":
                self._send(200, json.dumps(model.meta).encode())
            elif path == "/stats":
                self._send(200, json.dumps(batcher.stats).encode())
            else:
                self._send(404, b'{"error": "not found"}')

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path != "/predict":
                self._send(404, b'{"error": "not found"}')
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                image = _decode_request(body, self.headers.get("Content-Type", ""))
                image, native_hw = _route_to_bucket(image, model)
                preds = batcher.submit(image)
                if native_hw != tuple(preds["fine"].shape[:2]):
                    preds = {k: resize_mask_nearest(v, native_hw) for k, v in preds.items()}
                qs = parse_qs(parsed.query)
                fmt = qs.get("format", ["json"])[0]
                level = qs.get("level", ["fine"])[0]
                out, ctype = _encode_response(preds, fmt, level)
                self._send(200, out, ctype)
            except Overloaded as e:
                self._send(503, json.dumps({"error": f"Overloaded: {e}"}).encode(),
                           headers={"Retry-After": "1"})
            except TimeoutError as e:
                self._send(504, json.dumps({"error": f"TimeoutError: {e}"}).encode())
            except Exception as e:
                self._send(400, json.dumps({"error": f"{type(e).__name__}: {e}"}).encode())

    server = _HTTPServer((host, port), Handler)
    server.batcher = batcher
    return server


def main(argv=None) -> None:
    from seghiero_torch.config import load_config

    p = argparse.ArgumentParser(
        description="Serve a SegHiero model over HTTP with micro-batching (PyTorch port)"
    )
    p.add_argument("--config", type=str, required=True, help="YAML config")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="reference-layout .pth/.pt checkpoint")
    p.add_argument("--consistent", action="store_true",
                   help="derive coarse/super masks from the fine argmax")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--batch-timeout-ms", type=float, default=3.0,
                   help="how long the dispatcher waits to coalesce a batch "
                   "after the first request arrives")
    p.add_argument("--max-queue", type=int, default=0,
                   help="admission-queue bound; beyond it requests get an "
                   "immediate 503 (default 4x max-batch)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; cpu must be asked for)")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)

    cfg = load_config(args.config)
    predictor = Predictor.from_checkpoint(cfg, args.checkpoint, device=args.device)
    model = ServingModel(predictor, consistent=args.consistent)
    t0 = time.perf_counter()
    server = make_server(model, args.host, args.port, args.max_batch,
                         args.batch_timeout_ms, quiet=not args.verbose,
                         max_queue=args.max_queue)
    print(f"→ Warmed up batch sizes 1..{args.max_batch} "
          f"in {time.perf_counter() - t0:.1f}s")
    print(f"→ Serving on http://{args.host}:{args.port} on "
          f"{_device_name(predictor.device)} (input {model.input_hw}, "
          f"max_batch {args.max_batch})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.batcher.stop()
        server.server_close()


if __name__ == "__main__":
    main()
