"""Batched inference serving (port of ihmr_tpu/serve.py).

A micro-batching broker in front of the encoder's predict function, and an
HTTP front end on the standard library:

  * One predict function at a FIXED batch size. A broker thread collects
    requests for up to ``max_wait_ms`` or until the batch is full, pads the
    batch with its first request's sample, runs the function once and hands
    each caller its row; a request waits at most ``max_wait_ms`` plus one
    run. The broker thread is the only thread that runs the model, so only
    it touches the card.
  * Backpressure: the queue holds ``8 * batch_size`` requests; a full queue
    fails ``submit`` at once with ``ServerSaturated`` (HTTP 503).
  * POST /predict, by Content-Type:
      - application/json (default): {"images": [[H, W, 3] float lists, ...]}
        -> {"results": [{"params": ..., "joints_3d": ..., ...}, ...]};
      - application/octet-stream: raw little-endian fp32, C order,
        (N, H, W, 3) -> an uncompressed .npz (application/x-npz) of the
        stacked outputs;
      - application/x-npy: one .npy array, (N, H, W, 3) or (H, W, 3) -> the
        same .npz.
    A bad shape or length is 400. GET /healthz; GET /stats (queue depth,
    batches run, padding efficiency).

``python -m ihmr_tpu_torch.cli serve`` wires this to a trained encoder
(``build_encoder_predict_fn``).
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ihmr_tpu_torch.core.projection import orthographic_project
from ihmr_tpu_torch.device import DeviceLike, resolve_device
from ihmr_tpu_torch.mano.layer import HandParams, two_hand_decode_mirrored
from ihmr_tpu_torch.mano.model import ManoModel
from ihmr_tpu_torch.models.encoder import InterHandEncoder


class ServerSaturated(RuntimeError):
    """Raised by submit() when the bounded request queue is full (the HTTP
    layer answers 503, so callers get backpressure, not unbounded latency)."""


class MicroBatcher:
    """Collects single requests into fixed-size padded batches for a predict
    function ``fn(batch) -> dict of arrays`` (leading batch dimension on
    every output).

    The request queue holds ``max_queue`` requests (default 8 full batches);
    when it is full, submit() raises ServerSaturated at once. With
    ``input_shape``, a sample of another shape, or one that is not numeric,
    fails its own submit() call and never reaches the broker thread."""

    def __init__(
        self,
        fn: Callable,
        batch_size: int,
        max_wait_ms: float = 10.0,
        max_queue: Optional[int] = None,
        input_shape=None,
    ):
        self.fn = fn
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1000.0
        self.input_shape = tuple(input_shape) if input_shape is not None else None
        if max_queue is None:
            max_queue = 8 * batch_size
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._stats = {"requests": 0, "batches": 0, "padded_slots": 0, "rejected": 0}
        self._lock = threading.Lock()
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- client
    def submit(self, x: np.ndarray):
        """Enqueue ONE sample (no batch dimension); returns a handle for
        wait(). Raises ValueError on a malformed sample and ServerSaturated
        on a full queue, both in the caller's thread."""
        x = np.asarray(x, np.float32)  # a non-numeric payload fails here
        if self.input_shape is not None and x.shape != self.input_shape:
            raise ValueError(f"sample shape {x.shape} != expected {self.input_shape}")
        done = threading.Event()
        slot: Dict = {}
        try:
            self._q.put_nowait((x, slot, done))
        except queue.Full:
            with self._lock:
                self._stats["rejected"] += 1
            raise ServerSaturated(f"request queue full ({self._q.maxsize} pending)") from None
        return slot, done

    @staticmethod
    def wait(handle, timeout: float = 30.0) -> Dict[str, np.ndarray]:
        slot, done = handle
        if not done.wait(timeout):
            raise TimeoutError("predict timed out")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["out"]

    def predict(self, x: np.ndarray, timeout: float = 30.0) -> Dict[str, np.ndarray]:
        """Submit ONE sample (no batch dimension); blocks until its result."""
        return self.wait(self.submit(x), timeout)

    def predict_many(self, xs, timeout: float = 30.0) -> List[Dict[str, np.ndarray]]:
        """Submit ALL samples first (so that they share batches), then wait."""
        handles = [self.submit(x) for x in xs]
        return [self.wait(h, timeout) for h in handles]

    # ------------------------------------------------------------- broker
    def _loop(self):
        while self._running:
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            items = [first]
            deadline = time.monotonic() + self.max_wait
            while len(items) < self.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    items.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            n = len(items)
            pad = self.batch_size - n
            try:
                # assembled inside the try: a ragged sample that got past
                # submit() fails this batch's waiters, not the broker thread
                xs = [np.asarray(x) for x, _, _ in items]
                batch = np.stack(xs + [xs[0]] * pad, axis=0)
                out = self.fn(batch)
                out = {k: np.asarray(v) for k, v in out.items()}
                for i, (_, slot, done) in enumerate(items):
                    slot["out"] = {k: v[i] for k, v in out.items()}
                    done.set()
            except Exception as e:  # every waiter of the batch gets the error
                for _, slot, done in items:
                    slot["error"] = repr(e)
                    done.set()
            with self._lock:
                self._stats["requests"] += n
                self._stats["batches"] += 1
                self._stats["padded_slots"] += pad

    def stats(self) -> Dict:
        with self._lock:
            s = dict(self._stats)
        s["queue_depth"] = self._q.qsize()
        if s["batches"]:
            total = s["batches"] * self.batch_size
            s["batch_efficiency"] = round(1.0 - s["padded_slots"] / total, 4)
        return s

    def stop(self):
        self._running = False
        self._thread.join(timeout=2)


class InferenceServer:
    """HTTP front end over a MicroBatcher."""

    def __init__(self, batcher: MicroBatcher, input_shape):
        self.batcher = batcher
        self.input_shape = tuple(input_shape)
        self._server: Optional[ThreadingHTTPServer] = None
        self.port: Optional[int] = None

    def start(self, port: int = 0) -> int:
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code: int, payload: Dict):
                body = json.dumps(payload).encode()
                self._send_bytes(code, body, "application/json")

            def _send_bytes(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"status": "ok"})
                elif self.path == "/stats":
                    self._send(200, srv.batcher.stats())
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/predict":
                    self._send(404, {"error": "not found"})
                    return
                ctype = self.headers.get("Content-Type", "application/json")
                npy = ctype.startswith("application/x-npy")
                binary = npy or ctype.startswith("application/octet-stream")
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    body = self.rfile.read(length)
                    if npy:
                        images = np.asarray(np.load(io.BytesIO(body), allow_pickle=False), np.float32)
                    elif binary:
                        per = int(np.prod(srv.input_shape)) * 4
                        if per == 0 or len(body) % per != 0:
                            self._send(400, {
                                "error": f"octet-stream body of {len(body)} bytes is not a multiple of one "
                                         f"fp32 sample ({per} bytes, shape {srv.input_shape})"})
                            return
                        images = np.frombuffer(body, np.float32).reshape((-1,) + srv.input_shape)
                    else:
                        images = np.asarray(json.loads(body)["images"], np.float32)
                    if images.ndim == len(srv.input_shape):  # one sample
                        images = images[None]
                    if images.shape[1:] != srv.input_shape:
                        self._send(400, {"error": f"input shape {images.shape[1:]} != expected {srv.input_shape}"})
                        return
                    results = srv.batcher.predict_many(list(images))
                    if binary:
                        stacked = {k: np.stack([r[k] for r in results]) for k in results[0]}
                        buf = io.BytesIO()
                        np.savez(buf, **stacked)  # uncompressed: speed over size
                        self._send_bytes(200, buf.getvalue(), "application/x-npz")
                        return
                    self._send(200, {"results": [{k: v.tolist() for k, v in out.items()} for out in results]})
                except ServerSaturated as e:
                    self._send(503, {"error": str(e), "retry_after_ms": 100})
                except Exception as e:
                    self._send(400, {"error": repr(e)})

        self._server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        print(f"[serve] inference server at http://localhost:{self.port}/", flush=True)
        return self.port

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        self.batcher.stop()


# columns of the packed (B, 334) output: params, joints 3D, joints 2D, hand type
_PACKED = (("params", 122, ()), ("joints_3d", 126, (42, 3)), ("joints_2d", 84, (42, 2)), ("hand_type", 2, ()))


def build_encoder_predict_fn(
    encoder: InterHandEncoder,
    mean_params: torch.Tensor,
    mano_right: ManoModel,
    input_size: int,
    device: DeviceLike = None,
) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
    """images (B, S, S, 3) float in [0, 1] -> dict(params (B, 122),
    joints_3d (B, 42, 3), joints_2d (B, 42, 2), hand_type (B, 2)) as numpy:
    the IHMR-Baseline inference pipeline on ``device`` (CUDA unless "cpu" is
    asked for). Images are normalised as the reference's Normalize(.5, .5),
    the encoder runs in eval mode (in the dtype it was built with) and the
    params are decoded through the mirrored two-hand MANO model. The four
    outputs leave the device packed in one (B, 334) tensor, one copy per
    batch. Inference mode is entered inside the function, since grad mode
    is per thread and the broker thread calls it."""
    dev = resolve_device(device)
    encoder = encoder.to(dev).eval()
    mean_params = mean_params.to(dev)
    shape = (input_size, input_size, 3)

    def predict(images: np.ndarray) -> Dict[str, np.ndarray]:
        images = np.asarray(images, np.float32)
        if images.shape[1:] != shape:
            raise ValueError(f"images of shape {images.shape[1:]}, expected {shape}")
        with torch.inference_mode():
            x = (torch.from_numpy(images).to(dev) - 0.5) / 0.5
            params, hand_type = encoder(x, mean_params)
            hp = HandParams.from_flat(params)
            _, _, joints3d = two_hand_decode_mirrored(
                mano_right, hp.right_orient, hp.left_orient, hp.right_pose, hp.left_pose,
                hp.right_shape, hp.left_shape, hp.trans,
            )
            joints2d = orthographic_project(joints3d, hp.cam)
            B = params.shape[0]
            packed = torch.cat([params, joints3d.reshape(B, 126), joints2d.reshape(B, 84), hand_type], dim=1)
            packed = packed.cpu().numpy()  # one device-to-host copy
        out, col = {}, 0
        for name, width, tail in _PACKED:
            out[name] = packed[:, col : col + width].reshape((B,) + (tail or (width,)))
            col += width
        return out

    return predict
