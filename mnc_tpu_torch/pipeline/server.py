"""HTTP serving front-end — port of ``mnc_tpu/pipeline/server.py``.

A stdlib ``ThreadingHTTPServer`` with

- ``POST /detect`` — the request body is an encoded image (jpg/png, decoded
  by cv2 where it imports) or a raw ``.npy`` array (HWC uint8 BGR;
  magic-sniffed), the response the per-image detection JSON;
- ``GET /healthz`` — liveness probe.

Two inference modes:

- single (``detect_fn``): requests serialize behind a lock;
- micro-batched (``batch_fn`` + :class:`MicroBatcher`): concurrent requests
  coalesce (up to ``max_batch`` or ``max_wait_ms``) into ONE device batch
  through ``MNCPipeline.detect_many``: a batch of 1 reads the fc weights
  from device memory for one image, so coalescing multiplies throughput at
  a bounded latency cost.

The detect function runs on a thread of the server (single mode: the
request's handler thread; micro-batched: the batcher's worker thread), so
the CUDA state it needs must not be thread-local state of the thread that
built the pipeline: PyTorch's current stream is per thread and a new thread
starts on the default stream of the current device, and grad mode is per
thread too.  ``MNCPipeline`` names its device on every tensor it makes,
enters ``torch.inference_mode`` in each call, and the kernels launch on the
calling thread's current stream, so a pipeline serves from any thread.

The machine with the card has no cv2: there a body must be ``.npy``, and
anything else gets 400.  No external dependencies; the detect function is
injected, so the server is unit-testable without a model.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

import numpy as np

_NPY_MAGIC = b"\x93NUMPY"


def decode_image(data: bytes) -> np.ndarray | None:
    """Encoded request body → BGR uint8 HWC array (None if undecodable:
    a malformed ``.npy``, one that is not (H, W, 3), or an encoded image
    where cv2 does not import or cannot decode it)."""
    if data[: len(_NPY_MAGIC)] == _NPY_MAGIC:
        try:
            arr = np.load(io.BytesIO(data), allow_pickle=False)
        except (ValueError, EOFError, OSError):
            return None
        if arr.ndim == 3 and arr.shape[2] == 3:
            return arr.astype(np.uint8)
        return None
    try:
        import cv2
    except ImportError:
        return None
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


class MicroBatcher:
    """Coalesce concurrent single-image requests into device batches.

    ``batch_fn``: list of images → list of result dicts (one per image, in
    order) — e.g. a ``MNCPipeline.detect_many`` wrapper with a FIXED
    ``batch_size`` (detect_many pads every chunk, so every device batch has
    the same shapes).  A worker thread drains the queue: it waits for
    the first request, then collects up to ``max_batch`` more for at most
    ``max_wait_ms``, and runs them as one call.
    """

    def __init__(self, batch_fn: Callable[[list], list], max_batch: int = 8,
                 max_wait_ms: float = 10.0):
        self._batch_fn = batch_fn
        self._max_batch = max_batch
        self._max_wait_s = max_wait_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._running = True
        self.batch_sizes: list[int] = []  # observability
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, img: np.ndarray) -> dict:
        """Blocking: enqueue one image, wait for its batch to run.

        Never strands the caller: a dead/closed worker raises instead of
        hanging (the wait re-checks worker liveness every second)."""
        if not self._running or not self._thread.is_alive():
            raise RuntimeError("MicroBatcher is closed")
        done = threading.Event()
        box: dict = {}
        self._q.put((img, done, box))
        while not done.wait(timeout=1.0):
            if not self._thread.is_alive():
                raise RuntimeError("MicroBatcher worker died")
        if "error" in box:
            raise box["error"]
        return box["out"]

    def _loop(self):
        try:
            while self._running:
                try:
                    items = [self._q.get(timeout=0.1)]
                except queue.Empty:
                    continue
                deadline = time.monotonic() + self._max_wait_s
                while len(items) < self._max_batch:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    try:
                        items.append(self._q.get(timeout=left))
                    except queue.Empty:
                        break
                self.batch_sizes.append(len(items))
                try:
                    outs = self._batch_fn([im for im, _, _ in items])
                    if len(outs) != len(items):
                        raise RuntimeError(
                            f"batch_fn returned {len(outs)} results for "
                            f"{len(items)} inputs")
                except BaseException as e:  # noqa: BLE001 — fail the batch,
                    for _, done, box in items:  # never strand its waiters
                        box["error"] = e
                        done.set()
                    if not isinstance(e, Exception):
                        raise  # KeyboardInterrupt/SystemExit: stop the worker
                    continue
                for (_, done, box), out in zip(items, outs):
                    box["out"] = out
                    done.set()
        finally:
            # whatever stopped the worker, don't strand queued submitters
            self._running = False
            self._drain(RuntimeError("MicroBatcher worker stopped"))

    def _drain(self, err: BaseException) -> None:
        while True:
            try:
                _, done, box = self._q.get_nowait()
            except queue.Empty:
                return
            box.setdefault("error", err)
            done.set()

    def close(self):
        self._running = False
        self._thread.join(timeout=2.0)
        self._drain(RuntimeError("MicroBatcher closed"))


def make_http_server(detect_fn: Callable[[np.ndarray], dict] | None = None,
                     host: str = "0.0.0.0",
                     port: int = 8080,
                     batch_fn: Callable[[list], list] | None = None,
                     max_batch: int = 8,
                     max_wait_ms: float = 10.0) -> ThreadingHTTPServer:
    """Build (not start) the server.

    Exactly one of ``detect_fn`` (single-image, lock-serialized) or
    ``batch_fn`` (list → list, micro-batched via :class:`MicroBatcher`)
    must be given.  Start with ``server.serve_forever()``;
    ``server.server_address[1]`` gives the bound port (pass ``port=0`` for
    an ephemeral one).  A ``batch_fn`` server exposes the batcher as
    ``server.batcher`` (``close()`` it on shutdown).
    """
    if (detect_fn is None) == (batch_fn is None):
        raise ValueError("pass exactly one of detect_fn / batch_fn")
    batcher = (MicroBatcher(batch_fn, max_batch, max_wait_ms)
               if batch_fn is not None else None)
    if batcher is not None:
        detect_fn = batcher.submit
    lock = threading.Lock() if batcher is None else None

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet by default; errors go to JSON
            pass

        def _reply(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/healthz", "/health"):
                self._reply(200, {"status": "ok"})
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/detect":
                self._reply(404, {"error": "not found"})
                return
            n = int(self.headers.get("Content-Length") or 0)
            img = decode_image(self.rfile.read(n)) if n else None
            if img is None:
                self._reply(400, {"error": "undecodable image (send jpg/png "
                                           "or a HWC uint8 .npy)"})
                return
            try:
                if lock is None:  # micro-batched: the batcher serializes
                    out = detect_fn(img)
                else:
                    with lock:
                        out = detect_fn(img)
            except Exception as e:  # surface, don't kill the server
                self._reply(500, {"error": repr(e)})
                return
            self._reply(200, out)

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.batcher = batcher
    return srv
