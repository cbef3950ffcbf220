"""Micro-batching inference server (counterpart of ``MicroBatcher`` and
``make_handler`` in ``simhand_tpu/serving/server.py``).

Stdlib HTTP front end for one card: requests are queued and coalesced into
device batches (up to ``batch``, waiting at most ``max_wait_ms`` for
stragglers), run through ``call`` (any callable ``images -> {name:
tensor}``, e.g. ``ops.bottleneck_block.make_folded_encoder_bf16``'s forward
wrapped in a dict) on one executor thread with one CUDA stream, and fanned
back out:

  POST /infer?h=128&w=128   raw uint8 RGB bytes -> JSON of every output
  GET  /healthz             "ok"

Not in this module yet (ROADMAP Queue 1 item 13): ``serve`` and ``main``,
which load a serving artifact; the port has no ``torch.export`` artifact.
"""
from __future__ import annotations

import contextlib
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from simhand_tpu_torch.device import resolve_device
from simhand_tpu_torch.serving.embed import _preprocess_fn


def _nearest_resize(img: np.ndarray, side: int) -> np.ndarray:
    """Host-side nearest resample to the input side (ragged request sizes
    must land in one fixed batch tile; no cv2 dependency)."""
    if img.shape[:2] == (side, side):
        return img
    ys = (np.arange(side) * (img.shape[0] / side)).astype(np.int64)
    xs = (np.arange(side) * (img.shape[1] / side)).astype(np.int64)
    return img[ys][:, xs]


class _Request:
    __slots__ = ("image", "event", "result", "error")

    def __init__(self, image: np.ndarray):
        self.image = image
        self.event = threading.Event()
        self.result = None
        self.error: str | None = None


class MicroBatcher:
    """Coalesces queued requests into fixed-size padded device batches.

    The executor thread sets ``device`` (``cuda`` unless ``"cpu"``; the
    caller's current card when no index is given) as its own, runs every
    batch on one CUDA stream of its own, made here after the work the
    caller queued so far (the weights), and brings the results to the host
    with ``.cpu()`` before it answers."""

    def __init__(self, call, side: int, batch: int, max_wait_ms: float, device=None):
        self.call = call
        self.side = side
        self.batch = batch
        self.max_wait = max_wait_ms / 1e3
        self.device = resolve_device(device)
        self._cuda_stream = None
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            self._cuda_stream = torch.cuda.Stream(self.device)
            self._cuda_stream.wait_stream(torch.cuda.current_stream(self.device))
        self.queue: queue.Queue[_Request] = queue.Queue()
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def submit(self, image: np.ndarray, timeout: float = 30.0):
        req = _Request(image)
        self.queue.put(req)
        if not req.event.wait(timeout):
            raise TimeoutError("inference timed out")
        if req.error:
            raise RuntimeError(req.error)
        return req.result

    def close(self):
        self._stop.set()
        self.thread.join(timeout=5)

    # -- executor thread -------------------------------------------------
    def _collect(self) -> list[_Request]:
        try:
            first = self.queue.get(timeout=0.1)
        except queue.Empty:
            return []
        chunk = [first]
        t0 = time.perf_counter()
        while len(chunk) < self.batch:
            remaining = self.max_wait - (time.perf_counter() - t0)
            if remaining <= 0:
                break
            try:
                chunk.append(self.queue.get(timeout=remaining))
            except queue.Empty:
                break
        return chunk

    def _stream(self):
        if self._cuda_stream is None:
            return contextlib.nullcontext()
        torch.cuda.set_device(self.device)
        return torch.cuda.stream(self._cuda_stream)

    def _loop(self):
        preprocess = _preprocess_fn(self.side, self.device)
        with self._stream(), torch.inference_mode():
            while not self._stop.is_set():
                chunk = self._collect()
                if not chunk:
                    continue
                try:
                    k = len(chunk)
                    crops = np.zeros((self.batch, self.side, self.side, 3), np.uint8)
                    for i, r in enumerate(chunk):
                        crops[i] = _nearest_resize(r.image, self.side)
                    out = self.call(preprocess(crops))
                    host = {name: v[:k].cpu().numpy() for name, v in out.items()}
                    for i, r in enumerate(chunk):
                        r.result = {name: v[i] for name, v in host.items()}
                        r.event.set()
                except Exception as e:  # surface to the callers, keep the executor
                    for r in chunk:
                        r.error = f"{type(e).__name__}: {e}"
                        r.event.set()


def make_handler(batcher: MicroBatcher):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/infer":
                self.send_error(404)
                return
            q = parse_qs(url.query)
            try:
                h = int(q["h"][0])
                w = int(q["w"][0])
                n = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(n)
                img = np.frombuffer(raw, np.uint8).reshape(h, w, 3)
                out = batcher.submit(img)
                body = json.dumps({k: v.tolist() for k, v in out.items()}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except Exception as e:
                self.send_error(400, f"{type(e).__name__}: {e}")

        def do_GET(self):
            if urlparse(self.path).path != "/healthz":
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Length", "3")
            self.end_headers()
            self.wfile.write(b"ok\n")

    return Handler
