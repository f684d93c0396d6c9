"""Batched low-latency inference serving (counterpart of ``tpucv/serving.py``).

- One micro-batcher thread owns the device: it groups concurrent requests
  up to ``batch_size`` within ``max_wait_ms`` into one fixed-shape uint8
  canvas batch, so every batch runs the same program
  (``DetectionAlgorithm._batched_detections``: letterbox, forward, decode
  and NMS on the device), and the tail of a partial batch is zero rows.
- The host decodes images only, in the HTTP handler threads.
- Responses carry boxes in ORIGINAL image coordinates, class ids, labels
  and scores.

HTTP contract:

  POST /predict   body = encoded image (JPEG/PNG/...), or raw RGB bytes
                  with Content-Type application/x-raw-rgb and X-Height /
                  X-Width headers; response JSON
                  {"detections": [{"box": [x1,y1,x2,y2], "score": s,
                    "class_id": c, "label": name}, ...],
                   "latency_ms": total-in-server}
  GET  /healthz   {"status": "ok", "model": ..., "batch_size": ...}
  GET  /stats     request/batch counters, mean batch occupancy,
                  latency percentiles over the last window

Entry point: ``python -m tpucv_torch.serve --model yolo8_det --port 8080``.
"""

from __future__ import annotations

import collections
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

__all__ = ["MicroBatcher", "make_server", "decode_image_bytes"]


def decode_image_bytes(body: bytes) -> Optional[np.ndarray]:
    """Encoded image bytes -> RGB uint8 HWC (None when undecodable).

    Mirrors ``utils.image_process.read_image``'s RGB contract so serving
    and predict see identical pixels for identical files.
    """
    import cv2

    if not body:
        return None
    arr = np.frombuffer(body, np.uint8)
    bgr = cv2.imdecode(arr, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    if bgr is None:
        return None
    return np.ascontiguousarray(bgr[..., ::-1])


def decode_raw_rgb(body: bytes, height: int, width: int) -> Optional[np.ndarray]:
    """``application/x-raw-rgb`` body (H*W*3 uint8, RGB, row-major) ->
    HWC array, or None on a size mismatch. Lets clients that already hold
    pixels skip the encode/decode round trip entirely."""
    if height <= 0 or width <= 0 or len(body) != height * width * 3:
        return None
    return np.frombuffer(body, np.uint8).reshape(height, width, 3)


class MicroBatcher:
    """Groups concurrent requests into fixed-shape device batches.

    One worker thread owns the device: it drains the request queue up to
    ``batch_size`` items (waiting at most ``max_wait_ms`` after the first
    arrival), runs them through the algorithm's batched program, and
    wakes each caller with its per-image result. Handler threads block in
    :meth:`submit`; :meth:`warmup` pays the first call's one-time costs
    (kernel build, cuDNN algorithm choice) before traffic arrives.
    """

    def __init__(self, algo, model, batch_size: int = 8,
                 max_wait_ms: float = 10.0, conf_threshold: float = 0.25,
                 request_timeout_s: float = 60.0,
                 max_queue: Optional[int] = None):
        self.algo = algo
        self.model = model
        self.batch_size = int(batch_size)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.conf_threshold = float(conf_threshold)
        self.request_timeout_s = float(request_timeout_s)
        # Backpressure: beyond this queue depth, submit() fast-fails with
        # 503 instead of piling up blocked handler threads for a minute.
        self.max_queue = int(max_queue) if max_queue else \
            max(32, 8 * self.batch_size)
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._latencies = collections.deque(maxlen=512)  # seconds
        self.stats = {"requests": 0, "batches": 0, "images": 0,
                      "errors": 0, "rejected": 0,
                      # wall time inside the device call (H2D + program
                      # + result fetch), for separating transport/
                      # compute cost from HTTP+batcher overhead in load
                      # tests (snapshot: device_ms_per_batch)
                      "device_s": 0.0}
        self._thread: Optional[threading.Thread] = None
        self._started = False
        self._stopped = False

    # -------- lifecycle ----------------------------------------------------
    def warmup(self) -> None:
        """Run the serving program once at the serving batch shape before
        accepting traffic, so no served request pays a first call's
        one-time costs."""
        dummy = np.zeros((32, 48, 3), np.uint8)
        list(self.algo._batched_detections(
            self.model, [(dummy,)], self.batch_size,
            self.conf_threshold))

    def start(self) -> None:
        """Idempotent; safe to call concurrently. Explicit start() after
        stop() restarts with a fresh worker thread (Thread objects are
        single-use); lazy starts from submit() never restart a stopped
        batcher — those requests get 503 instead."""
        with self._lock:
            if self._started:
                return
            self._stopped = False
            self._thread = threading.Thread(
                target=self._run, name="tpucv-torch-batcher", daemon=True)
            self._started = True
            self._thread.start()

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            started, self._started = self._started, False
            thread = self._thread
        if started:
            self._q.put(None)
            thread.join(timeout=5)

    # -------- request path ---------------------------------------------
    def submit(self, img: np.ndarray) -> dict:
        """Blocking: enqueue one RGB image, wait for its detections."""
        with self._lock:
            if self._stopped:
                return {"error": "server shutting down", "_status": 503}
            need_start = not self._started
        if need_start:
            self.start()
        if self._q.qsize() >= self.max_queue:
            with self._lock:
                self.stats["rejected"] += 1
            return {"error": "server overloaded, retry later",
                    "_status": 503}
        slot = {"img": img, "ev": threading.Event(),
                "t0": time.perf_counter()}
        self._q.put(slot)
        if not slot["ev"].wait(timeout=self.request_timeout_s):
            with self._lock:
                if not slot.get("finalized"):
                    # Abandon the slot: the worker skips dead slots, so a
                    # timed-out request is counted exactly once (here).
                    slot["dead"] = True
                    self.stats["errors"] += 1
                    return {"error": "inference timed out", "_status": 503}
            # finalized between the wait timing out and us taking the
            # lock: the result is valid, fall through and use it
        if "error" in slot:
            return {"error": slot["error"], "_status": 500}
        if "result" not in slot:
            return {"error": "no result produced", "_status": 500}
        return slot["result"]

    # -------- device worker ----------------------------------------------
    def _collect_group(self, first) -> list:
        group = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(group) < self.batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:           # shutdown mid-group: finish the group
                self._q.put(None)     # re-post for the main loop to see
                break
            group.append(nxt)
        return group

    def _run(self) -> None:
        while True:
            first = self._q.get()
            if first is None:
                return
            group = self._collect_group(first)
            with self._lock:   # drop slots whose submitter already timed out
                group = [s for s in group if not s.get("dead")]
            if not group:
                continue
            index = [(slot["img"],) for slot in group]
            t_dev = time.perf_counter()
            try:
                for i, boxes, scores, classes in \
                        self.algo._batched_detections(
                            self.model, index, self.batch_size,
                            self.conf_threshold):
                    slot = group[i]
                    names = self.algo.class_names
                    dets = [
                        {"box": [float(v) for v in box],
                         "score": float(s),
                         "class_id": int(c),
                         "label": names[int(c)] if 0 <= int(c) < len(names)
                         else str(int(c))}
                        for box, s, c in zip(boxes, scores, classes)]
                    slot["result"] = {"detections": dets}
            except Exception as e:                      # noqa: BLE001
                for slot in group:
                    if "result" not in slot:
                        slot["error"] = f"{type(e).__name__}: {e}"
            now = time.perf_counter()
            with self._lock:
                self.stats["batches"] += 1
                self.stats["device_s"] += now - t_dev
                for slot in group:
                    if slot.get("dead"):   # timed out mid-compute; already
                        continue           # counted as an error in submit()
                    slot["finalized"] = True
                    self.stats["requests"] += 1
                    self.stats["images"] += 1
                    if "error" in slot or "result" not in slot:
                        self.stats["errors"] += 1
                    self._latencies.append(now - slot["t0"])
            for slot in group:
                slot["ev"].set()

    # -------- observability ------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies)
            out = dict(self.stats)
        if out["batches"]:
            out["mean_batch_occupancy"] = round(
                out["images"] / out["batches"], 2)
            out["device_ms_per_batch"] = round(
                out["device_s"] / out["batches"] * 1e3, 2)
        out["device_s"] = round(out["device_s"], 3)
        if lat:
            out["latency_ms_p50"] = round(lat[len(lat) // 2] * 1e3, 2)
            out["latency_ms_p99"] = round(
                lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3, 2)
        return out


def make_server(algo, model, host: str = "127.0.0.1", port: int = 8080,
                batch_size: int = 8, max_wait_ms: float = 10.0,
                conf_threshold: float = 0.25, warmup: bool = True,
                model_name: str = "", request_timeout_s: float = 60.0,
                max_queue: Optional[int] = None) -> ThreadingHTTPServer:
    """Build (but don't run) the HTTP server; ``server.batcher`` is the
    attached :class:`MicroBatcher`. Call ``server.serve_forever()``."""
    batcher = MicroBatcher(algo, model, batch_size=batch_size,
                           max_wait_ms=max_wait_ms,
                           conf_threshold=conf_threshold,
                           request_timeout_s=request_timeout_s,
                           max_queue=max_queue)
    if warmup:
        batcher.warmup()
    batcher.start()

    class Handler(BaseHTTPRequestHandler):
        server_version = "tpucv-torch-serve/1.0"
        protocol_version = "HTTP/1.1"

        def _json(self, status: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if self.close_connection:
                # we advertise HTTP/1.1 keep-alive; when the request body
                # could not be fully consumed, tell the client the
                # connection dies here instead of desyncing its pipeline
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def _drain_body(self) -> None:
            """Consume any unread request body before an error response.

            With keep-alive, unread body bytes would be parsed as the
            start of the NEXT request on the same connection. Chunked
            bodies (which we don't parse) force a connection close.
            """
            if self.headers.get("Transfer-Encoding", "").lower():
                self.close_connection = True
                return
            try:
                remaining = int(self.headers.get("Content-Length", 0) or 0)
            except ValueError:
                self.close_connection = True
                return
            while remaining > 0:
                chunk = self.rfile.read(min(remaining, 1 << 16))
                if not chunk:
                    self.close_connection = True
                    return
                remaining -= len(chunk)

        def log_message(self, fmt, *args):  # quiet: stats live in /stats
            pass

        def do_GET(self):
            if self.path in ("/", "/healthz"):
                self._json(200, {
                    "status": "ok", "model": model_name,
                    "batch_size": batcher.batch_size,
                    "max_wait_ms": batcher.max_wait_s * 1e3,
                    "conf_threshold": batcher.conf_threshold})
            elif self.path == "/stats":
                self._json(200, batcher.snapshot())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._drain_body()
                self._json(404, {"error": f"no route {self.path}"})
                return
            if self.headers.get("Transfer-Encoding", "").lower():
                self.close_connection = True
                self._json(411, {"error": "chunked bodies not supported; "
                                          "send Content-Length"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self.close_connection = True
                self._json(400, {"error": "invalid Content-Length"})
                return
            body = self.rfile.read(length)
            if self.headers.get("Content-Type", "") == "application/x-raw-rgb":
                try:
                    h = int(self.headers.get("X-Height", 0))
                    w = int(self.headers.get("X-Width", 0))
                except ValueError:
                    h = w = 0
                img = decode_raw_rgb(body, h, w)
                if img is None:
                    self._json(400, {
                        "error": "raw body must be X-Height*X-Width*3 "
                                 "uint8 RGB bytes"})
                    return
            else:
                img = decode_image_bytes(body)
                if img is None:
                    self._json(400, {"error": "body is not a decodable image"})
                    return
            t0 = time.perf_counter()
            result = batcher.submit(img)
            status = result.pop("_status", 200)
            if status == 200:
                result["latency_ms"] = round(
                    (time.perf_counter() - t0) * 1e3, 2)
            self._json(status, result)

    server = ThreadingHTTPServer((host, port), Handler)
    server.batcher = batcher
    return server
