"""The port's HTTP serving endpoint (``tactilesr_torch/server.py``):
micro-batching, routes, status codes and hot-reload semantics, the cases of
``tests/test_server.py`` against the port's ``SRPredictor`` on the CPU.

The server runs in-process (ThreadingHTTPServer on an ephemeral port);
requests go through real HTTP via urllib, so the full handler/batcher/
predictor stack is exercised.  Bundles are ``make_sr_checkpoint`` JAX
variables written in the port's ``.pth`` layout, so ``/predict`` is also
held against the JAX ``SRPredictor`` on the same weights (f32, rtol 1e-4,
atol 1e-5).
"""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from conftest import make_sr_checkpoint
from tactilesr_tpu.runtime.checkpoint import load_checkpoint_file as jax_load
from tactilesr_tpu.serving import SRPredictor as JaxSRPredictor
from tactilesr_torch.compat.from_jax import tactile_sr_state_dict
from tactilesr_torch.parallel import make_mesh
from tactilesr_torch.runtime.checkpoint import save_checkpoint_file
from tactilesr_torch.server import MicroBatcher, create_server
from tactilesr_torch.serving import SRPredictor

JAX_KW = dict(
    scale_factor=4, pattern_layers=1, force_layers=1,
    compute_dtype="float32", buckets=(4, 16),
)
PRED_KW = dict(JAX_KW, device="cpu")
JAX_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread at these toy shapes (the suite runs several
    worker processes at once)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _make_ckpt(tmp_path, name="model.pth", seed=0, pattern_layers=1):
    """A random-init TactileSR as a JAX ``.ckpt`` and, beside it, the same
    weights as a port ``.pth`` bundle; returns the ``.pth`` path."""
    stem = str(tmp_path / name)[:-len(".pth")]
    jax_path = make_sr_checkpoint(stem + ".ckpt", seed=seed, pattern_layers=pattern_layers)
    m = jax_load(jax_path)["model"]
    return save_checkpoint_file(
        stem + ".pth",
        tactile_sr_state_dict({"params": m["params"], "batch_stats": m["batch_stats"]}),
    )


def _post(url, body, ctype="application/x-npz"):
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": ctype}, method="POST"
    )
    with urllib.request.urlopen(req) as r:
        return r.status, r.read(), r.headers.get("Content-Type")


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("server")
    ckpt = _make_ckpt(tmp)
    srv = create_server(ckpt, linger_ms=2.0, **PRED_KW)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    host, port = srv.server_address
    yield srv, f"http://{host}:{port}", ckpt, tmp
    srv.shutdown()
    srv.batcher.shutdown()


def test_healthz_and_routes(server):
    _, base, ckpt, _ = server
    with urllib.request.urlopen(base + "/healthz") as r:
        health = json.loads(r.read())
    assert health["status"] == "ok"
    assert health["in_channels"] == 3
    assert health["buckets"] == [4, 16]
    assert health["checkpoint"] == ckpt
    assert health["model_arch"] == "TactileSR" and health["fused"] is True
    assert health["branch_mode"] == "per_seq"  # STSR: nothing to batch
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(base + "/nope")
    assert ei.value.code == 404


def test_predict_npz_matches_direct(server, rng):
    srv, base, ckpt, _ = server
    lr = (rng.random((5, 3, 4, 4)) * 4).astype(np.float32)
    status, body, ctype = _post(base + "/predict", _npz(LR=lr))
    assert status == 200 and ctype == "application/x-npz"
    with np.load(io.BytesIO(body)) as z:
        sr = z["SR"]
    assert sr.shape == (5, 1, 16, 16)
    direct = SRPredictor(ckpt, **PRED_KW).predict(lr)
    np.testing.assert_allclose(sr, direct, rtol=1e-5, atol=1e-6)
    # and the JAX package's predictor on the same weights
    jax_pred = JaxSRPredictor(ckpt[:-len(".pth")] + ".ckpt", **JAX_KW)
    np.testing.assert_allclose(sr, jax_pred.predict(lr), **JAX_TOL)


def test_predict_json(server, rng):
    _, base, ckpt, _ = server
    lr = (rng.random((2, 3, 4, 4)) * 4).astype(np.float32)
    status, body, ctype = _post(
        base + "/predict",
        json.dumps({"lr": lr.tolist()}).encode(),
        ctype="application/json",
    )
    assert status == 200 and ctype == "application/json"
    sr = np.asarray(json.loads(body)["sr"], np.float32)
    assert sr.shape == (2, 1, 16, 16)
    direct = SRPredictor(ckpt, **PRED_KW).predict(lr)
    np.testing.assert_allclose(sr, direct, rtol=1e-4, atol=1e-5)


def test_predict_errors(server):
    _, base, _, _ = server
    # wrong channel count -> 400 with the expected-shape message
    bad = np.zeros((2, 5, 4, 4), np.float32)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/predict", _npz(LR=bad))
    assert ei.value.code == 400
    assert "expected (N>=1, 3, 4, 4)" in json.loads(ei.value.read())["error"]
    # garbage body -> 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/predict", b"not an npz")
    assert ei.value.code == 400


def test_concurrent_requests_coalesce(server, rng):
    """8 threads fire single-frame requests into a linger window; the
    batcher must coalesce at least some of them into one dispatch and
    every caller must get exactly its own row back."""
    srv, base, ckpt, _ = server
    srv.batcher.linger_s = 0.2  # widen the window for determinism
    try:
        lrs = [(rng.random((1, 3, 4, 4)) * 4).astype(np.float32) for _ in range(8)]
        results = [None] * 8
        errors = []

        def call(i):
            try:
                _, body, _ = _post(base + "/predict", _npz(LR=lrs[i]))
                with np.load(io.BytesIO(body)) as z:
                    results[i] = z["SR"].copy()
            except Exception as e:  # pragma: no cover - surfaced by assert
                errors.append(e)

        before = srv.batcher.snapshot_stats()
        threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not errors
        after = srv.batcher.snapshot_stats()
        assert after["requests"] - before["requests"] == 8
        assert after["frames"] - before["frames"] == 8
        # coalescing happened: fewer dispatches than requests
        assert after["batches"] - before["batches"] < 8
        assert after["max_coalesced_requests"] >= 2
        direct = SRPredictor(ckpt, **PRED_KW)
        expected = direct.predict(np.concatenate(lrs))
        for i in range(8):
            np.testing.assert_allclose(
                results[i][0], expected[i], rtol=1e-5, atol=1e-6
            )
    finally:
        srv.batcher.linger_s = 0.002


def test_reload_endpoint(server, rng, tmp_path):
    srv, base, ckpt, tmp = server
    try:
        _reload_scenarios(base, ckpt, rng, tmp_path)
    finally:
        # restore the module-scoped server's original weights so the other
        # tests stay order-independent
        _post(base + "/reload", json.dumps({"checkpoint": ckpt}).encode(),
              ctype="application/json")


def _reload_scenarios(base, ckpt, rng, tmp_path):
    lr = (rng.random((3, 3, 4, 4)) * 4).astype(np.float32)
    _, body0, _ = _post(base + "/predict", _npz(LR=lr))
    # same-architecture reload: outputs change, health reports the new path
    ckpt_b = _make_ckpt(tmp_path, "b.pth", seed=7)
    status, body, _ = _post(
        base + "/reload", json.dumps({"checkpoint": ckpt_b}).encode(),
        ctype="application/json",
    )
    assert status == 200
    _, body1, _ = _post(base + "/predict", _npz(LR=lr))
    with np.load(io.BytesIO(body0)) as z0, np.load(io.BytesIO(body1)) as z1:
        assert not np.allclose(z0["SR"], z1["SR"])
    with urllib.request.urlopen(base + "/healthz") as r:
        assert json.loads(r.read())["checkpoint"] == ckpt_b
    # mismatched architecture -> 409, previous weights keep serving
    ckpt_bad = _make_ckpt(tmp_path, "bad.pth", seed=1, pattern_layers=2)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/reload", json.dumps({"checkpoint": ckpt_bad}).encode(),
              ctype="application/json")
    assert ei.value.code == 409
    _, body2, _ = _post(base + "/predict", _npz(LR=lr))
    with np.load(io.BytesIO(body1)) as z1, np.load(io.BytesIO(body2)) as z2:
        np.testing.assert_array_equal(z1["SR"], z2["SR"])
    # missing file -> 404, still serving
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/reload",
              json.dumps({"checkpoint": str(tmp_path / "nope.pth")}).encode(),
              ctype="application/json")
    assert ei.value.code == 404


def test_microbatcher_shape_validation(server):
    srv, _, _, _ = server
    with pytest.raises(ValueError, match="expected"):
        srv.batcher.submit(np.zeros((0, 3, 4, 4), np.float32))
    with pytest.raises(ValueError, match="expected"):
        srv.batcher.submit(np.zeros((2, 3, 4), np.float32))


def test_microbatcher_oversized_request(tmp_path, rng):
    """A single request larger than max_batch is served in one submit
    (the predictor chunks internally)."""
    ckpt = _make_ckpt(tmp_path)
    pred = SRPredictor(ckpt, **PRED_KW)
    mb = MicroBatcher(pred, max_batch=4, linger_ms=0.5)
    try:
        lr = (rng.random((19, 3, 4, 4)) * 4).astype(np.float32)
        out = mb.submit(lr)
        assert out.shape == (19, 1, 16, 16)
        np.testing.assert_allclose(
            out, pred.predict(lr), rtol=1e-5, atol=1e-6
        )
    finally:
        mb.shutdown()


def test_reload_unreadable_path_returns_500(server, tmp_path):
    """Failures outside the known classes (e.g. a directory path) still get
    an HTTP answer — 500 with the previous weights serving."""
    _, base, ckpt, _ = server
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/reload",
              json.dumps({"checkpoint": str(tmp_path)}).encode(),
              ctype="application/json")
    assert ei.value.code == 500
    with urllib.request.urlopen(base + "/healthz") as r:
        assert json.loads(r.read())["checkpoint"] == ckpt


def test_microbatcher_shutdown_fails_fast(tmp_path, rng):
    """After shutdown(): new submits raise immediately instead of hanging,
    and stragglers that raced behind the sentinel are failed, not leaked."""
    import threading as _threading

    ckpt = _make_ckpt(tmp_path)
    pred = SRPredictor(ckpt, **PRED_KW)
    mb = MicroBatcher(pred, linger_ms=0.5)
    lr = (rng.random((1, 3, 4, 4)) * 4).astype(np.float32)
    assert mb.submit(lr).shape == (1, 1, 16, 16)
    mb.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        mb.submit(lr)
    # simulate the race: an item enqueued after the worker exited
    straggler_err = []

    def straggler():
        item_q = mb._q
        from tactilesr_torch.server import _Pending

        item = _Pending(lr)
        item_q.put(item)
        item.event.wait(10)
        straggler_err.append(item.error)

    t = _threading.Thread(target=straggler)
    t.start()
    t.join(1)
    mb.shutdown()  # idempotent; drains and fails the straggler
    t.join(10)
    assert straggler_err and isinstance(straggler_err[0], RuntimeError)


def test_stats_latency_percentiles(server, rng):
    """/stats reports p50/p95/p99 request latency over a sliding window."""
    _, base, _, _ = server
    for _ in range(3):
        _post(base + "/predict",
              _npz(LR=(rng.random((1, 3, 4, 4)) * 4).astype(np.float32)))
    with urllib.request.urlopen(base + "/stats") as r:
        s = json.loads(r.read())
    lat = s["latency_ms"]
    assert lat["window"] >= 3
    assert 0 < lat["p50"] <= lat["p95"] <= lat["p99"]


def test_server_over_device_mesh(tmp_path, rng):
    """The endpoint composes with data-parallel serving: a server whose
    predictor shards batches over a two-device mesh (both the CPU here)
    returns the maps of the unmeshed predictor (the --data-parallel path)."""
    ckpt = _make_ckpt(tmp_path)
    srv = create_server(
        ckpt, linger_ms=2.0, warmup=False, mesh=make_mesh(["cpu", "cpu"]),
        scale_factor=4, pattern_layers=1, force_layers=1,
        compute_dtype="float32", buckets=(8,), device="cpu",
    )
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        base = "http://%s:%d" % srv.server_address
        lr = (rng.random((5, 3, 4, 4)) * 4).astype(np.float32)
        _, body, _ = _post(base + "/predict", _npz(LR=lr))
        with np.load(io.BytesIO(body)) as z:
            sr = z["SR"]
        direct = SRPredictor(ckpt, **PRED_KW).predict(lr)
        np.testing.assert_allclose(sr, direct, rtol=1e-5, atol=1e-5)
    finally:
        srv.shutdown()
        srv.batcher.shutdown()


@pytest.mark.parametrize("bad_len", ["abc", "-1"])
def test_malformed_content_length_returns_400(server, bad_len):
    """A bad Content-Length must answer 400, not kill the handler thread
    (which would reset the connection with no HTTP response).  A NEGATIVE
    length must not reach rfile.read(-1), which blocks until client EOF
    and would hang the handler thread."""
    import http.client
    from urllib.parse import urlparse

    _, base, _, _ = server
    u = urlparse(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=10)
    try:
        conn.putrequest("POST", "/predict", skip_accept_encoding=True)
        conn.putheader("Content-Type", "application/x-npz")
        conn.putheader("Content-Length", bad_len)
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400
        assert "Content-Length" in json.loads(resp.read())["error"]
    finally:
        conn.close()


# ---------------------------------------------------------------- overload


class _SlowPredictor:
    """Predictor stand-in with a controllable service time: lets the
    overload tests create a backlog deterministically without device
    timing."""

    def __init__(self, delay_s=0.2, scale=4):
        self.buckets = (16,)
        self.in_channels = 3
        self.delay_s = delay_s
        self.scale = scale
        self.calls = []  # batch sizes actually dispatched

    def predict(self, lr):
        self.calls.append(lr.shape[0])
        import time as _t

        _t.sleep(self.delay_s)
        n = lr.shape[0]
        s = 4 * self.scale
        return np.zeros((n, 1, s, s), np.float32)


def test_queue_full_backpressure():
    """With max_queue_frames set, overload rejects with QueueFullError
    BEFORE enqueueing: pending frames never exceed the bound, accepted
    requests complete, and the rejection is counted."""
    from tactilesr_torch.server import QueueFullError

    pred = _SlowPredictor(delay_s=0.15)
    mb = MicroBatcher(pred, max_batch=4, linger_ms=0.5, max_queue_frames=8)
    try:
        results, rejected, errors = [], [], []
        max_seen = [0]

        def call():
            lr = np.zeros((4, 3, 4, 4), np.float32)
            try:
                out = mb.submit(lr)
                results.append(out.shape)
            except QueueFullError as e:
                rejected.append(e)
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=call) for _ in range(8)]
        for t in threads:
            t.start()
        # watch the backpressure invariant while the backlog drains
        for _ in range(200):
            with mb._close_lock:
                max_seen[0] = max(max_seen[0], mb._pending_frames)
            if all(not t.is_alive() for t in threads):
                break
            import time as _t

            _t.sleep(0.01)
        for t in threads:
            t.join(30)
        assert not errors
        assert max_seen[0] <= 8  # the invariant: bounded memory
        assert rejected, "overload must produce rejections"
        assert len(results) + len(rejected) == 8
        assert all(shape == (4, 1, 16, 16) for shape in results)
        s = mb.snapshot_stats()
        assert s["rejected_full"] == len(rejected)
        assert s["queue_depth_frames"] == 0  # fully drained
        assert s["max_queue_frames"] == 8
    finally:
        mb.shutdown()


def test_deadline_exceeded_and_abandoned_skip():
    """A request that misses its deadline raises DeadlineExceededError for
    the caller AND is dropped by the worker without device time."""
    from tactilesr_torch.server import DeadlineExceededError

    pred = _SlowPredictor(delay_s=0.3)
    mb = MicroBatcher(pred, max_batch=2, linger_ms=0.1, deadline_ms=80)
    try:
        lr = np.zeros((2, 3, 4, 4), np.float32)
        outcomes = []

        def first():
            try:
                outcomes.append(("ok", mb.submit(lr).shape))
            except DeadlineExceededError:
                outcomes.append(("deadline", None))

        # the first submit occupies the worker for 300 ms > the 80 ms
        # deadline; the second queues behind it and must ALSO time out,
        # then be skipped (never dispatched)
        t1 = threading.Thread(target=first)
        t1.start()
        import time as _t

        _t.sleep(0.02)
        with pytest.raises(DeadlineExceededError, match="deadline"):
            mb.submit(lr)
        t1.join(10)
        assert outcomes == [("deadline", None)]
        # give the worker time to pop + skip the abandoned second item
        deadline = _t.monotonic() + 5
        while _t.monotonic() < deadline:
            if mb.snapshot_stats()["abandoned_skipped"] >= 1:
                break
            _t.sleep(0.02)
        s = mb.snapshot_stats()
        assert s["deadline_exceeded"] == 2
        assert s["abandoned_skipped"] >= 1
        # the second request never reached the device
        assert sum(pred.calls) <= 2
        assert s["queue_depth_frames"] == 0
    finally:
        mb.shutdown()


def test_http_429_and_504_overload_routes(server, rng):
    """HTTP mapping of the overload paths: 429 + Retry-After when the
    queue bound is hit, 504 on a missed deadline; /stats reports depth."""
    srv, base, _, _ = server
    b = srv.batcher
    real_predict = b.predictor.predict
    lr1 = (rng.random((1, 3, 4, 4)) * 4).astype(np.float32)

    def slow_predict(arr):
        import time as _t

        _t.sleep(0.25)
        return real_predict(arr)

    try:
        b.predictor.predict = slow_predict
        b.max_queue_frames = 2
        # occupy the worker; its admission budget is held until predict ends
        occupier = threading.Thread(
            target=lambda: _post(base + "/predict", _npz(LR=lr1))
        )
        occupier.start()
        import time as _t

        _t.sleep(0.08)  # let it be admitted and dispatched
        codes = []
        headers = []

        def poke():
            try:
                status, _, _ = _post(base + "/predict", _npz(LR=lr1))
                codes.append(status)
            except urllib.error.HTTPError as e:
                codes.append(e.code)
                headers.append(e.headers.get("Retry-After"))

        pokers = [threading.Thread(target=poke) for _ in range(3)]
        for t in pokers:
            t.start()
        for t in pokers:
            t.join(30)
        occupier.join(30)
        assert 429 in codes, codes
        assert any(h is not None and int(h) >= 1 for h in headers)
        with urllib.request.urlopen(base + "/stats") as r:
            s = json.loads(r.read())
        assert s["rejected_full"] >= 1
        assert s["max_queue_frames"] == 2

        # deadline: a fresh request against the still-slow predictor
        b.max_queue_frames = None
        b.deadline_s = 0.05
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/predict", _npz(LR=lr1))
        assert ei.value.code == 504
        assert "deadline" in json.loads(ei.value.read())["error"]
    finally:
        b.predictor.predict = real_predict
        b.max_queue_frames = None
        b.deadline_s = None
        _t.sleep(0.3)  # let abandoned stragglers drain before other tests


def test_oversized_request_on_idle_queue_is_413_not_429():
    """A single request with n > max_queue_frames can NEVER be admitted,
    even against an empty queue -- it must raise RequestTooLargeError (HTTP
    413, no Retry-After), not the retryable QueueFullError, and it must not
    consume admission budget."""
    from tactilesr_torch.server import RequestTooLargeError

    pred = _SlowPredictor(delay_s=0.01)
    mb = MicroBatcher(pred, max_batch=4, linger_ms=0.2, max_queue_frames=8)
    try:
        lr = np.zeros((9, 3, 4, 4), np.float32)  # 9 > 8, queue idle
        with pytest.raises(RequestTooLargeError, match="split it"):
            mb.submit(lr)
        s = mb.snapshot_stats()
        assert s["rejected_too_large"] == 1
        assert s["rejected_full"] == 0
        assert s["queue_depth_frames"] == 0
        # an exactly-bound-sized request IS admissible on an idle queue
        out = mb.submit(np.zeros((8, 3, 4, 4), np.float32))
        assert out.shape == (8, 1, 16, 16)
    finally:
        mb.shutdown()


def test_http_413_oversized_request_route(server, rng):
    """HTTP mapping: oversized-by-itself -> 413 with no Retry-After header,
    against an idle server."""
    srv, base, _, _ = server
    b = srv.batcher
    lr = (rng.random((3, 3, 4, 4)) * 4).astype(np.float32)
    try:
        b.max_queue_frames = 2
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/predict", _npz(LR=lr))
        assert ei.value.code == 413
        assert ei.value.headers.get("Retry-After") is None
        assert "split it" in json.loads(ei.value.read())["error"]
        with urllib.request.urlopen(base + "/stats") as r:
            assert json.loads(r.read())["rejected_too_large"] >= 1
    finally:
        b.max_queue_frames = None


def test_retry_after_estimate():
    """The 429 Retry-After derives from the recent service rate: backlog /
    (frames/sec over the dispatch log), clamped to [1, 30]; with no rate
    info yet it floors at 1."""
    pred = _SlowPredictor(delay_s=0.01)
    mb = MicroBatcher(pred, max_batch=4, linger_ms=0.2, max_queue_frames=100)
    try:
        assert mb.retry_after_s() == 1  # no dispatches yet
        # synthesize: 100 frames served over 1 s -> 100 f/s service rate
        with mb._lock:
            mb._dispatch_log.extend([(10.0, 100), (11.0, 100)])
        with mb._close_lock:
            mb._pending_frames = 500
        assert mb.retry_after_s() == 5  # 500-frame backlog / 100 f/s
        with mb._close_lock:
            mb._pending_frames = 100_000
        assert mb.retry_after_s() == 30  # clamped
    finally:
        with mb._close_lock:
            mb._pending_frames = 0
        mb.shutdown()


def test_cli_prints_its_address_and_serves(tmp_path, rng):
    """``python -m tactilesr_torch.server --device cpu``: exactly one JSON
    line with the bound address on stdout (logs go to stderr), the routes
    answer over it, and an interrupt stops it cleanly."""
    import os
    import signal
    import subprocess
    import sys

    ckpt = _make_ckpt(tmp_path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tactilesr_torch.server", "--checkpoint", ckpt, "--device", "cpu",
         "--port", "0", "--scale-factor", "4", "--pattern-layers", "1",
         "--compute-dtype", "float32", "--max-queue-frames", "4"],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        base = json.loads(proc.stdout.readline())["serving"]
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["checkpoint"] == ckpt
        lr = (rng.random((3, 3, 4, 4)) * 4).astype(np.float32)
        status, body, _ = _post(base + "/predict", _npz(LR=lr))
        assert status == 200
        with np.load(io.BytesIO(body)) as z:
            np.testing.assert_allclose(z["SR"], SRPredictor(ckpt, **PRED_KW).predict(lr),
                                       rtol=1e-5, atol=1e-6)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/predict", _npz(LR=np.zeros((5, 3, 4, 4), np.float32)))
        assert ei.value.code == 413
    finally:
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err
    assert out == "" and "SRServer ready" in err
