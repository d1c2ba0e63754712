"""HTTP serving front end: micro-batched SR inference over the network.

The card wants one dispatch thread feeding it large batches of the fixed
bucket shapes (``serving.SRPredictor`` pads every request to one); HTTP
concurrency is the opposite: many small simultaneous requests.  The
``MicroBatcher`` bridges the two: handler threads enqueue their readings,
a single device thread coalesces everything queued (up to the predictor's
largest bucket, with a short linger window to let concurrent callers pile
in) into one ``SRPredictor.predict`` call, and each caller gets back its
own rows.  Weight hot-swap (``POST /reload``) rides the predictor's
atomicity contract: a mismatched checkpoint is refused with the previous
weights still serving, and every in-flight batch completes on the weights
it started with (``predict`` snapshots them once per call).

The port of ``tactilesr_tpu/server.py`` over the port's ``SRPredictor``.
Stdlib only: ``http.server`` threads for IO, and the device never sees
more than one dispatcher (``SRPredictor._forward`` keeps ``no_grad`` on
itself, since grad mode is per thread).

Endpoints
---------
- ``GET /healthz``   -- model, bucket, branch layout and checkpoint; 200
  when serving.
- ``GET /stats``     -- request/frame/batch counters, coalescing and
  latency percentiles.
- ``POST /predict``  -- body is an ``.npz`` with an ``LR`` array of shape
  (N, C, 4, 4) (``Content-Type: application/x-npz``, the default) or JSON
  ``{"lr": [...]}``; the response mirrors the request format with ``SR``.
  400 for a bad body or shape, 429 + ``Retry-After`` once
  ``max_queue_frames`` pending frames are queued (rejected before
  enqueue), 413 when a single request exceeds ``max_queue_frames`` by
  itself (never admissible: no Retry-After, split the request instead),
  504 when a request misses its ``deadline_ms`` (the queued item is
  abandoned and costs no device time), 500 when the batch fails.
- ``POST /reload``   -- JSON ``{"checkpoint": path}``; hot-swaps weights.
  409 on an architecture mismatch, 404 for a missing file, 500 otherwise;
  the previous weights keep serving in every case.

    python -m tactilesr_torch.server --checkpoint x.pth --port 8912
"""

from __future__ import annotations

import collections
import io
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from .models.inference import BRANCH_MODES
from .parallel.mesh import local_devices, resolve_mesh
from .serving import COMPUTE_DTYPES, MODEL_ARCHS, SRPredictor

__all__ = [
    "MicroBatcher",
    "SRServer",
    "create_server",
    "QueueFullError",
    "RequestTooLargeError",
    "DeadlineExceededError",
]

logger = logging.getLogger("tactilesr_torch")

_SHUTDOWN = object()


class QueueFullError(RuntimeError):
    """Backpressure: the batcher's frame backlog is at max_queue_frames.

    Raised by ``submit`` BEFORE enqueueing, so a rejected request costs the
    server nothing but the shape check.  HTTP maps this to 429 with a
    Retry-After estimate."""


class RequestTooLargeError(ValueError):
    """The single request exceeds max_queue_frames BY ITSELF.

    Distinct from :class:`QueueFullError` because retrying can never
    succeed -- even an idle server cannot admit it.  A client implementing
    honest backoff must split the request instead of waiting, so HTTP maps
    this to 413 (no Retry-After)."""


class DeadlineExceededError(RuntimeError):
    """The request's deadline expired before its rows came back.

    The caller is released immediately; the queued item is marked abandoned
    so the worker drops it without spending device time.  HTTP maps this
    to 504."""


class _Pending:
    __slots__ = ("arr", "event", "result", "error", "t0", "abandoned")

    def __init__(self, arr: np.ndarray):
        self.arr = arr
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.t0 = time.monotonic()  # enqueue time, for latency stats
        self.abandoned = False  # set by a timed-out caller; worker skips it


class MicroBatcher:
    """Coalesce concurrent predict() calls into single device dispatches.

    ``submit`` blocks the calling thread until its rows come back.  One
    worker thread owns the device: it takes the oldest queued request,
    lingers up to ``linger_ms`` for more to arrive (bounded by
    ``max_batch``, default the predictor's largest bucket), concatenates,
    runs ONE ``predict``, and slices the output back per caller.  A
    request larger than ``max_batch`` is still served in one submit (the
    predictor chunks internally over its buckets)."""

    def __init__(
        self,
        predictor: SRPredictor,
        max_batch: Optional[int] = None,
        linger_ms: float = 2.0,
        max_queue_frames: Optional[int] = None,
        deadline_ms: Optional[float] = None,
    ):
        self.predictor = predictor
        self.max_batch = int(max_batch or predictor.buckets[-1])
        self.linger_s = float(linger_ms) / 1e3
        # backpressure: frames admitted but not yet completed.  None is
        # unbounded (library use); the HTTP CLI always sets a bound.
        self.max_queue_frames = (
            int(max_queue_frames) if max_queue_frames else None
        )
        self.deadline_s = float(deadline_ms) / 1e3 if deadline_ms else None
        self._pending_frames = 0  # guarded by _close_lock, same as admission
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()
        # serializes the closed-check+enqueue in submit() against
        # shutdown() flipping _closed: an item observed open is enqueued
        # BEFORE the sentinel, so the worker (or the post-join drain)
        # always completes its event -- no caller can block forever.
        # Also guards _pending_frames, making the full-check+admit atomic.
        self._close_lock = threading.Lock()
        self.stats = {
            "requests": 0,
            "frames": 0,
            "batches": 0,
            "max_coalesced_requests": 0,
            "rejected_full": 0,
            "rejected_too_large": 0,
            "deadline_exceeded": 0,
            "abandoned_skipped": 0,
        }
        # last-N request latencies (enqueue -> rows ready), for /stats
        self._latencies = collections.deque(maxlen=512)
        # recent (timestamp, frames) per dispatch -> service-rate estimate
        # for Retry-After on 429s
        self._dispatch_log = collections.deque(maxlen=64)
        self._worker = threading.Thread(
            target=self._run, name="microbatcher", daemon=True
        )
        self._worker.start()

    def submit(self, lr: np.ndarray) -> np.ndarray:
        """(N, C, 4, 4) readings -> (N, 1, 4s, 4s) maps; thread-safe."""
        lr = np.asarray(lr, np.float32)
        c = self.predictor.in_channels
        if lr.ndim != 4 or lr.shape[1:] != (c, 4, 4) or lr.shape[0] == 0:
            raise ValueError(
                f"expected (N>=1, {c}, 4, 4) readings, got {lr.shape}"
            )
        n = lr.shape[0]
        if self.max_queue_frames is not None and n > self.max_queue_frames:
            # never admissible, even against an empty queue: a retry can't
            # succeed, so don't dress it up as backpressure
            with self._lock:
                self.stats["rejected_too_large"] += 1
            raise RequestTooLargeError(
                f"request of {n} frames exceeds max_queue_frames="
                f"{self.max_queue_frames} by itself; split it into "
                f"<= {self.max_queue_frames}-frame requests"
            )
        item = _Pending(lr)
        with self._close_lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is shut down")
            if (
                self.max_queue_frames is not None
                and self._pending_frames + n > self.max_queue_frames
            ):
                with self._lock:
                    self.stats["rejected_full"] += 1
                raise QueueFullError(
                    f"queue full: {self._pending_frames} frames pending, "
                    f"request of {n} would exceed max_queue_frames="
                    f"{self.max_queue_frames}"
                )
            self._pending_frames += n
            self._q.put(item)
        if not item.event.wait(self.deadline_s):
            # the item stays queued (memory already accounted in
            # _pending_frames, released when the worker pops it); marking
            # it abandoned lets the worker drop it without device work.
            # Benign race: the worker may complete it concurrently -- the
            # caller has already given up either way.
            item.abandoned = True
            with self._lock:
                self.stats["deadline_exceeded"] += 1
            raise DeadlineExceededError(
                f"request of {n} frames missed its "
                f"{self.deadline_s * 1e3:.0f} ms deadline"
            )
        if item.error is not None:
            # a fresh exception per caller: a coalesced batch shares one
            # failure, and re-raising the same instance from N threads
            # cross-mutates its traceback
            raise RuntimeError(
                f"batched predict failed: "
                f"{type(item.error).__name__}: {item.error}"
            )
        return item.result

    def shutdown(self, timeout_s: float = 10.0) -> None:
        with self._close_lock:
            # under the lock, any submit that saw _closed == False has
            # already enqueued, so its item sits AHEAD of the sentinel
            self._closed = True  # new submits fail fast from here on
            self._q.put(_SHUTDOWN)
        self._worker.join(timeout_s)
        if self._worker.is_alive():
            # the worker is mid-batch past the join budget.  Leave the
            # queue alone: the close lock guarantees every pending item
            # precedes the sentinel, so the live worker will complete
            # them all and exit when it pops the sentinel.  Draining
            # here would eat the sentinel and strand the worker on
            # _q.get() forever.
            return
        # worker is dead (it died on an unexpected error before reaching
        # the sentinel): fail anything it left behind so no caller waits
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is _SHUTDOWN:
                continue
            with self._close_lock:
                self._pending_frames -= item.arr.shape[0]
            item.error = RuntimeError("MicroBatcher is shut down")
            item.event.set()

    def _collect(self, first: _Pending):
        """The batching policy: linger briefly, stop at max_batch."""
        batch = [first]
        total = first.arr.shape[0]
        deadline = time.monotonic() + self.linger_s
        while total < self.max_batch:
            remaining = deadline - time.monotonic()
            try:
                nxt = (
                    self._q.get(timeout=remaining)
                    if remaining > 0
                    else self._q.get_nowait()
                )
            except queue.Empty:
                break
            if nxt is _SHUTDOWN:  # keep the sentinel for the outer loop
                self._q.put(nxt)
                break
            batch.append(nxt)
            total += nxt.arr.shape[0]
        return batch, total

    def _run(self) -> None:
        while True:
            first = self._q.get()
            if first is _SHUTDOWN:
                return
            batch, total = self._collect(first)
            # deadline-abandoned callers are gone; dropping their rows here
            # is what makes a timed-out request cost no device time
            live = [p for p in batch if not p.abandoned]
            try:
                if live:
                    out = self.predictor.predict(
                        np.concatenate([p.arr for p in live])
                        if len(live) > 1
                        else live[0].arr
                    )
                    i = 0
                    for p in live:
                        n = p.arr.shape[0]
                        p.result = out[i : i + n]
                        i += n
            except BaseException as e:  # deliver, don't kill the worker
                for p in live:
                    p.error = e
            finally:
                # popped items no longer hold queue memory: release the
                # admission budget (same lock as the full-check in submit)
                with self._close_lock:
                    self._pending_frames -= total
                # stats first, wake-ups last: a caller that has its response
                # always sees its own dispatch reflected in /stats
                now = time.monotonic()
                live_frames = sum(p.arr.shape[0] for p in live)
                with self._lock:
                    self.stats["requests"] += len(live)
                    self.stats["frames"] += live_frames
                    if live:
                        self.stats["batches"] += 1
                        self.stats["max_coalesced_requests"] = max(
                            self.stats["max_coalesced_requests"], len(live)
                        )
                    self.stats["abandoned_skipped"] += len(batch) - len(live)
                    self._latencies.extend(now - p.t0 for p in live)
                    if live:
                        self._dispatch_log.append((now, live_frames))
                for p in live:
                    p.event.set()

    def snapshot_stats(self) -> dict:
        with self._lock:
            s = dict(self.stats)
            lats = sorted(self._latencies)
        with self._close_lock:
            s["queue_depth_frames"] = self._pending_frames
        s["max_queue_frames"] = self.max_queue_frames
        s["deadline_ms"] = (
            round(self.deadline_s * 1e3, 1) if self.deadline_s else None
        )
        s["avg_frames_per_dispatch"] = (
            round(s["frames"] / s["batches"], 2) if s["batches"] else 0.0
        )
        if lats:
            pick = lambda q: round(lats[int(q * (len(lats) - 1))] * 1e3, 2)
            s["latency_ms"] = {
                "p50": pick(0.50), "p95": pick(0.95), "p99": pick(0.99),
                "window": len(lats),
            }
        return s

    def retry_after_s(self) -> int:
        """Seconds until the current backlog likely drains, from the recent
        service rate -- the Retry-After value for a 429.  Clamped [1, 30]."""
        with self._lock:
            log = list(self._dispatch_log)
        with self._close_lock:
            backlog = self._pending_frames
        if len(log) >= 2:
            span = log[-1][0] - log[0][0]
            frames = sum(n for _, n in log[1:])
            if span > 0 and frames > 0:
                est = backlog / (frames / span)
                return int(min(30, max(1, round(est))))
        return 1


class _BadRequest(Exception):
    """Client error detected before route handling -- answered with 400."""


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


class _Handler(BaseHTTPRequestHandler):
    server: "SRServer"

    # -- plumbing ---------------------------------------------------------
    def log_message(self, fmt, *args):  # route http.server chatter to DEBUG
        logger.debug("http: " + fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str, headers=()) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for name, value in headers:
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj, headers=()) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json", headers)

    def _body(self) -> bytes:
        try:
            n = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            # answer 400 instead of letting the handler thread die with an
            # unhandled exception (client would see a reset connection)
            raise _BadRequest("malformed Content-Length header")
        if n < 0:
            # rfile.read(-1) would block until client EOF, hanging this
            # handler thread with no response
            raise _BadRequest("malformed Content-Length header")
        return self.rfile.read(n)

    # -- routes -----------------------------------------------------------
    def do_GET(self):
        if self.path == "/healthz":
            self._send_json(200, self.server.health())
        elif self.path == "/stats":
            self._send_json(200, self.server.batcher.snapshot_stats())
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        try:
            if self.path == "/predict":
                self._predict()
            elif self.path == "/reload":
                self._reload()
            else:
                self._send_json(404, {"error": f"no route {self.path}"})
        except _BadRequest as e:
            self._send_json(400, {"error": str(e)})

    def _predict(self):
        body = self._body()
        as_json = (self.headers.get("Content-Type") or "").startswith(
            "application/json"
        )
        try:
            if as_json:
                lr = np.asarray(json.loads(body)["lr"], np.float32)
            else:
                with np.load(io.BytesIO(body), allow_pickle=False) as z:
                    lr = z["LR"]
        except Exception as e:
            self._send_json(400, {"error": f"unparseable request body: {e}"})
            return
        try:
            sr = self.server.batcher.submit(lr)
        except RequestTooLargeError as e:  # oversized even for an idle queue
            # 413, not 429: no Retry-After because no retry can succeed
            self._send_json(413, {"error": str(e)})
            return
        except ValueError as e:  # shape validation
            self._send_json(400, {"error": str(e)})
            return
        except QueueFullError as e:  # backpressure: bounded, fast rejection
            retry = self.server.batcher.retry_after_s()
            self._send_json(
                429,
                {"error": str(e), "retry_after_s": retry},
                headers=(("Retry-After", str(retry)),),
            )
            return
        except DeadlineExceededError as e:
            self._send_json(504, {"error": str(e)})
            return
        except Exception as e:  # device-side failure
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        if as_json:
            self._send_json(200, {"sr": sr.tolist()})
        else:
            self._send(200, _npz_bytes(SR=sr), "application/x-npz")

    def _reload(self):
        try:
            path = json.loads(self._body())["checkpoint"]
        except Exception as e:
            self._send_json(400, {"error": f"bad reload request: {e}"})
            return
        try:
            # serialize reload-vs-reload: predictor weights and the
            # reported checkpoint_path must move together (predict-vs-
            # reload needs no lock -- per-call weight snapshot)
            with self.server.reload_lock:
                self.server.predictor.reload_checkpoint(path)
                self.server.checkpoint_path = path
        except FileNotFoundError as e:
            self._send_json(404, {"error": str(e), "serving": "previous weights"})
        except (ValueError, KeyError) as e:
            # architecture mismatch: refused, previous weights keep serving
            self._send_json(409, {"error": str(e), "serving": "previous weights"})
        except Exception as e:  # unreadable path etc. -- still answer HTTP
            self._send_json(
                500,
                {"error": f"{type(e).__name__}: {e}", "serving": "previous weights"},
            )
        else:
            self._send_json(200, {"reloaded": path})


class SRServer(ThreadingHTTPServer):
    """ThreadingHTTPServer wired to one predictor + one MicroBatcher."""

    daemon_threads = True
    # the whole point of the micro-batcher is bursts of concurrent
    # clients; the socketserver default backlog of 5 resets connections
    # under exactly that load
    request_queue_size = 128

    def __init__(self, addr, predictor: SRPredictor, batcher: MicroBatcher,
                 checkpoint_path: str):
        super().__init__(addr, _Handler)
        self.predictor = predictor
        self.batcher = batcher
        self.checkpoint_path = checkpoint_path
        self.reload_lock = threading.Lock()

    def health(self) -> dict:
        p = self.predictor
        return {
            "status": "ok",
            "model_arch": p.model_arch,
            "in_channels": p.in_channels,
            "buckets": list(p.buckets),
            "fused": p.fused,
            "branch_mode": p.branch_mode,
            "checkpoint": self.checkpoint_path,
        }


def create_server(
    checkpoint_path: str,
    host: str = "127.0.0.1",
    port: int = 0,
    linger_ms: float = 2.0,
    max_batch: Optional[int] = None,
    max_queue_frames: Optional[int] = None,
    deadline_ms: Optional[float] = None,
    warmup: bool = True,
    **predictor_kw,
) -> SRServer:
    """Build (but don't start) a serving endpoint.  ``port=0`` binds an
    ephemeral port — read it back from ``server.server_address``.  Call
    ``serve_forever()`` (or run it in a thread) to accept requests;
    ``shutdown()`` + ``batcher.shutdown()`` to stop."""
    pred = SRPredictor(checkpoint_path, **predictor_kw)
    if warmup:
        pred.warmup()
    batcher = MicroBatcher(
        pred,
        max_batch=max_batch,
        linger_ms=linger_ms,
        max_queue_frames=max_queue_frames,
        deadline_ms=deadline_ms,
    )
    srv = SRServer((host, port), pred, batcher, checkpoint_path)
    logger.info(
        "SRServer ready on http://%s:%d (buckets %s, linger %.1f ms)",
        *srv.server_address, pred.buckets, linger_ms,
    )
    return srv


def _cli(argv=None):
    import argparse
    import sys

    # stdout carries exactly one JSON line (the bound address); logs -> stderr
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(
        prog="python -m tactilesr_torch.server",
        description="Micro-batched HTTP SR serving from a port checkpoint",
    )
    p.add_argument("--checkpoint", required=True, help="port .pth bundle, JAX .ckpt or reference .pth")
    p.add_argument("--allow-pickle", action="store_true",
                   help="unpickle a reference .pth that holds Python objects (only for a trusted file)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8912)
    p.add_argument("--linger-ms", type=float, default=2.0)
    p.add_argument(
        "--max-queue-frames", type=int, default=8192,
        help="backpressure bound on pending frames (429 past it); 0 = unbounded",
    )
    p.add_argument(
        "--deadline-ms", type=float, default=10_000.0,
        help="per-request deadline (504 past it); 0 = none",
    )
    p.add_argument("--seqs-cnt", type=int, default=1)
    p.add_argument("--scale-factor", type=int, default=10)
    p.add_argument("--pattern-layers", type=int, default=6)
    p.add_argument("--force-layers", type=int, default=1)
    p.add_argument("--compute-dtype", default="bfloat16", choices=sorted(COMPUTE_DTYPES))
    p.add_argument("--model-arch", default="TactileSR", choices=MODEL_ARCHS)
    p.add_argument("--no-fused", action="store_true")
    p.add_argument(
        "--branch-mode", default="auto", choices=("auto",) + BRANCH_MODES,
        help="MTSR branch layout (models/inference.py rewrite 4)",
    )
    p.add_argument("--device", default="cuda")
    p.add_argument(
        "--data-parallel", default="off",
        help="shard serving batches over this process's devices: off|auto|N",
    )
    args = p.parse_args(argv)
    srv = create_server(
        args.checkpoint,
        host=args.host,
        port=args.port,
        linger_ms=args.linger_ms,
        max_queue_frames=args.max_queue_frames or None,
        deadline_ms=args.deadline_ms or None,
        scale_factor=args.scale_factor,
        seqs_cnt=args.seqs_cnt,
        pattern_layers=args.pattern_layers,
        force_layers=args.force_layers,
        compute_dtype=args.compute_dtype,
        fused=not args.no_fused,
        model_arch=args.model_arch,
        branch_mode=args.branch_mode,
        device=args.device,
        allow_pickle=args.allow_pickle,
        mesh=resolve_mesh(args.data_parallel, devices=local_devices(args.device)),
    )
    print(json.dumps({"serving": f"http://{srv.server_address[0]}:{srv.server_address[1]}"}), flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.shutdown()


if __name__ == "__main__":
    _cli()
