"""Load study of the HTTP serving endpoint (``tactilesr_torch/server.py``;
the counterpart of the root ``scripts/bench_server.py``): what
server-side micro-batching buys under concurrent clients.

    python -m tactilesr_torch.scripts.bench_server [--clients 64] [--linger-ms 5]
        [--max-queue-frames 2048] [--deadline-ms 2000] [--skip-overload] [--sweep-linger]
        [--checkpoint x.pth] [--device cuda]

Starts the server in-process on an ephemeral loopback port with a seeded
full-width STSR (``bench.FLAGSHIP``, bf16), written with the port's
``save_checkpoint_file`` unless ``--checkpoint`` is given, then drives it
over real HTTP:

  phase A -- 1 client, 40 sequential single-frame requests (nothing to
             coalesce: every frame pays a whole dispatch)
  phase B -- N concurrent clients x 10 single-frame requests (the
             micro-batcher coalesces them into shared dispatches)
  phase C -- N/4 concurrent clients x 10 requests of 8 frames
  overload -- N clients x 8 requests of 64 frames against the bounded
             queue: accepted frames/s, accepted latency, 429/504 counts
             and the deepest queue seen (never above the bound)

``--sweep-linger`` re-runs phases B and C at linger windows of 0.5, 2, 5
and 10 ms on the hot server (the batcher's window set between phases).

Each phase reports frames/s (host clock), the dispatches and frames per
dispatch it added, and the latency p50/p99 that ``/stats`` reports after
it (over the server's last 512 requests).  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from .. import bench
from ..runtime.checkpoint import save_checkpoint_file
from ..server import create_server


def make_ckpt(path: str) -> str:
    return save_checkpoint_file(path, bench.flagship_model().state_dict())


def post_npz(url: str, lr: np.ndarray) -> np.ndarray:
    buf = io.BytesIO()
    np.savez(buf, LR=lr)
    req = urllib.request.Request(url + "/predict", data=buf.getvalue(),
                                 headers={"Content-Type": "application/x-npz"})
    with urllib.request.urlopen(req, timeout=120) as r:
        with np.load(io.BytesIO(r.read())) as z:
            return z["SR"]


def stats(url: str) -> dict:
    with urllib.request.urlopen(url + "/stats", timeout=30) as r:
        return json.loads(r.read())


def _run_clients(n_clients, client):
    threads = [threading.Thread(target=client) for _ in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    dt = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a client thread did not finish within 600 s")
    return dt


def run_phase(url, n_clients, reqs_per_client, frames_per_req, rng) -> dict:
    lr = (rng.random((frames_per_req, 3, 4, 4)) * 4).astype(np.float32)
    before = stats(url)
    errs = []

    def client():
        try:
            for _ in range(reqs_per_client):
                post_npz(url, lr)
        except Exception as e:  # reported after the join
            errs.append(e)

    dt = _run_clients(n_clients, client)
    if errs:
        raise errs[0]
    after = stats(url)
    frames = n_clients * reqs_per_client * frames_per_req
    dispatches = after["batches"] - before["batches"]
    lat = after.get("latency_ms", {})
    return {
        "clients": n_clients,
        "reqs_per_client": reqs_per_client,
        "frames_per_req": frames_per_req,
        "frames_per_sec": frames / dt,
        "dispatches": dispatches,
        "frames_per_dispatch": frames / max(dispatches, 1),
        "latency_ms_p50": lat.get("p50"),
        "latency_ms_p99": lat.get("p99"),
    }


def run_overload(url, n_clients, reqs_per_client, frames_per_req, rng) -> dict:
    """Arrivals past the service rate against the bounded queue: accepted
    frames/s and latency percentiles, status counts and the deepest queue
    observed (it must stay at or below the bound)."""
    lr = (rng.random((frames_per_req, 3, 4, 4)) * 4).astype(np.float32)
    codes, latencies, errs = [], [], []
    lock = threading.Lock()
    stop = threading.Event()
    max_depth = [0]

    def monitor():
        while not stop.is_set():
            try:
                max_depth[0] = max(max_depth[0], stats(url)["queue_depth_frames"])
            except (OSError, ValueError, KeyError):  # a busy server may drop one poll
                pass
            time.sleep(0.005)

    def client():
        for _ in range(reqs_per_client):
            t0 = time.perf_counter()
            try:
                post_npz(url, lr)
                with lock:
                    codes.append(200)
                    latencies.append(time.perf_counter() - t0)
            except urllib.error.HTTPError as e:
                e.read()
                with lock:
                    codes.append(e.code)
            except OSError as e:
                with lock:
                    errs.append(repr(e))

    mon = threading.Thread(target=monitor, daemon=True)
    mon.start()
    dt = _run_clients(n_clients, client)
    stop.set()
    mon.join(5)
    lat = sorted(latencies)

    def pick(q):
        return lat[int(q * (len(lat) - 1))] * 1e3 if lat else None

    counts = {str(c): codes.count(c) for c in sorted(set(codes))}
    return {
        "clients": n_clients,
        "frames_per_req": frames_per_req,
        "wall_s": dt,
        "status_counts": counts,
        "connection_errors": len(errs),
        "accepted_frames_per_sec": counts.get("200", 0) * frames_per_req / dt,
        "accepted_latency_ms": {"p50": pick(0.5), "p95": pick(0.95), "p99": pick(0.99)},
        "max_queue_depth_frames_observed": max_depth[0],
    }


def run(args) -> dict:
    dev = bench.require_device(args.device)
    with tempfile.TemporaryDirectory(prefix="bench_server_") as work:
        ckpt = args.checkpoint or make_ckpt(os.path.join(work, "model.pth"))
        w = bench.FLAGSHIP
        srv = create_server(
            ckpt, linger_ms=args.linger_ms, max_queue_frames=args.max_queue_frames or None,
            deadline_ms=args.deadline_ms or None, scale_factor=w["scale_factor"],
            pattern_layers=w["pattern_layers"], force_layers=w["force_layers"],
            compute_dtype="bfloat16", device=dev,
        )
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            url = "http://%s:%d" % srv.server_address
            bench.log(f"server: {url} (linger {args.linger_ms} ms)")
            rng = np.random.default_rng(0)
            post_npz(url, (rng.random((1, 3, 4, 4)) * 4).astype(np.float32))  # warm
            quarter = max(args.clients // 4, 1)
            results = {
                "device": bench.device_line(dev),
                "sequential_1client_1frame": run_phase(url, 1, 40, 1, rng),
                f"concurrent_{args.clients}clients_1frame": run_phase(url, args.clients, 10, 1, rng),
                f"concurrent_{quarter}clients_8frames": run_phase(url, quarter, 10, 8, rng),
            }
            seq = results["sequential_1client_1frame"]["frames_per_sec"]
            conc = results[f"concurrent_{args.clients}clients_1frame"]["frames_per_sec"]
            results["coalescing_speedup_1frame"] = conc / seq
            results["max_coalesced_requests_overall"] = stats(url)["max_coalesced_requests"]
            if args.sweep_linger:
                sweep = {}
                for ms in (0.5, 2.0, 5.0, 10.0):
                    srv.batcher.linger_s = ms / 1e3
                    sweep[f"{ms}ms"] = {
                        f"{args.clients}x1frame": run_phase(url, args.clients, 10, 1, rng),
                        f"{quarter}x8frames": run_phase(url, quarter, 10, 8, rng),
                    }
                srv.batcher.linger_s = args.linger_ms / 1e3
                results["linger_sweep"] = sweep
            if not args.skip_overload:
                results["overload_bounded_queue"] = run_overload(url, args.clients, 8, 64, rng)
                results["overload_bounds"] = {"max_queue_frames": args.max_queue_frames,
                                              "deadline_ms": args.deadline_ms}
        finally:
            srv.shutdown()
            srv.server_close()
            srv.batcher.shutdown()
            thread.join(10)
    return results


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m tactilesr_torch.scripts.bench_server",
                                description="Load study of the HTTP serving endpoint")
    p.add_argument("--checkpoint", default=None,
                   help="a TactileSR checkpoint at bench.FLAGSHIP widths (default: a seeded one)")
    p.add_argument("--clients", type=int, default=64)
    p.add_argument("--linger-ms", type=float, default=5.0)
    p.add_argument("--max-queue-frames", type=int, default=2048)
    p.add_argument("--deadline-ms", type=float, default=2000.0)
    p.add_argument("--skip-overload", action="store_true")
    p.add_argument("--sweep-linger", action="store_true",
                   help="re-run the concurrent phases at linger windows 0.5/2/5/10 ms on the hot server")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv)), indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
