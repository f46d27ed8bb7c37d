"""The port's stats core and debug plane held against the JAX package.

Each test runs the same inputs, made from a seed or a fixed script of
requests, through `seaweedfs_tpu.stats` (and the JAX roles and shell) and
through `seaweedfs_tpu_torch.stats` (and the port's roles on the CPU and its
shell), and compares what comes out: exposition bytes, parsed samples,
windowed rates, quantiles, alert firings, event types and cursors, profiler
stacks, debug-route shapes, the (family, label names) set a cluster's
/metrics exposes, and the `cluster.{check,top,trace,profile,why}` output
against one stub endpoint. The port's process-wide singletons (registry,
trace ring, journal, alert engine) are apart from the JAX package's, so
every test sets the port's state it asserts on, and the module stops the
port's history loop when it is done.
"""

from __future__ import annotations

import contextlib
import gzip
import io
import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import seaweedfs_tpu.stats.alerts as ref_alerts
import seaweedfs_tpu.stats.events as ref_events
import seaweedfs_tpu.stats.history as ref_history
import seaweedfs_tpu.stats.metrics as ref_metrics
import seaweedfs_tpu.stats.profiler as ref_profiler
import seaweedfs_tpu.stats.trace as ref_trace
from seaweedfs_tpu.shell import CommandEnv as RefCommandEnv
from seaweedfs_tpu.shell import run_command as ref_run_command

import seaweedfs_tpu_torch.stats.alerts as alerts
import seaweedfs_tpu_torch.stats.events as events
import seaweedfs_tpu_torch.stats.history as history
import seaweedfs_tpu_torch.stats.metrics as metrics
import seaweedfs_tpu_torch.stats.profiler as profiler
import seaweedfs_tpu_torch.stats.trace as trace
from seaweedfs_tpu_torch.server.httpd import HTTPService, PooledHTTP, Response, http_request
from seaweedfs_tpu_torch.shell import CommandEnv, run_command
from seaweedfs_tpu_torch.storage.erasure_coding import decoder
from seaweedfs_tpu_torch.tools import check_metric_names as port_lint

PAIRS = {
    "metrics": (ref_metrics, metrics),
    "history": (ref_history, history),
    "alerts": (ref_alerts, alerts),
    "events": (ref_events, events),
    "profiler": (ref_profiler, profiler),
    "trace": (ref_trace, trace),
}


@pytest.fixture(autouse=True, scope="module")
def _stop_port_threads():
    """Stop both packages' history loops (started by any metered server)
    when this module is done, so no thread of it outlives the module."""
    yield
    history.default_history().stop()
    ref_history.default_history().stop()


@pytest.fixture()
def frozen_clock(monkeypatch):
    """One wall clock for both packages' stats modules."""
    now = [1_700_000_000.25]

    def fake():
        return now[0]

    for ref, port in PAIRS.values():
        for mod in (ref, port):
            monkeypatch.setattr(mod.time, "time", fake)
    return now


# --- metrics ------------------------------------------------------------------
def _metric_script(mod, seed: int):
    """The same counter, gauge and histogram operations on a fresh
    registry of `mod`, with a fixed exemplar source; -> the registry."""
    rng = np.random.default_rng(seed)
    reg = mod.Registry()
    c = reg.counter("SeaweedFS_test_ops_total", "ops", ("op", "code"))
    g = reg.gauge("SeaweedFS_test_level", 'a "quoted"\\ help', ("node",))
    h = reg.histogram("SeaweedFS_test_seconds", "latency", ("role",),
                      exemplars=True)
    plain = reg.histogram("SeaweedFS_test_bytes", "sizes",
                          buckets=(1.0, 10.0, 100.0))
    reg.register_collector(lambda: ["# TYPE SeaweedFS_test_coll gauge",
                                    "SeaweedFS_test_coll 7"],
                           names=("SeaweedFS_test_coll",))
    for i in range(64):
        c.labels(str(rng.choice(["get", "put"])), str(rng.choice([200, 404, 500]))) \
            .inc(float(rng.integers(1, 5)))
        g.labels(f'n{i % 3}"\\\n').set(float(rng.normal()))
        h.labels(str(rng.choice(["filer", "volume"]))).observe(float(rng.exponential(0.05)))
        plain.observe(float(rng.integers(0, 200)))
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exposition_byte_equal_reference(frozen_clock, monkeypatch, seed):
    """The same operations render the same exposition bytes and the same
    exemplars in both packages, under one frozen clock."""
    for ref, port in [PAIRS["metrics"]]:
        monkeypatch.setattr(ref, "_exemplar_source", lambda: ("00c0ffee", "5a"))
        monkeypatch.setattr(port, "_exemplar_source", lambda: ("00c0ffee", "5a"))
    a = _metric_script(ref_metrics, seed)
    b = _metric_script(metrics, seed)
    assert a.render().encode() == b.render().encode()
    assert a.exemplars() == b.exemplars()
    assert ref_metrics.parse_exposition(a.render()) == metrics.parse_exposition(b.render())


def test_parse_exposition_equal_reference():
    text = "\n".join([
        "# HELP x h", "# TYPE x counter", 'x{a="1",b="q\\"z"} 3',
        'y_bucket{le="+Inf"} 4', "z 1e-05", "w NaN", "", "garbage line here",
        'v{role="filer",method="GET"} 2.5',
    ])
    # repr: NaN equals itself only as text
    assert repr(ref_metrics.parse_exposition(text)) == repr(metrics.parse_exposition(text))


def test_port_metric_name_lint_passes():
    """The port's lint over the port's registry: every role enabled, every
    lazily-created family forced, every reason and event vocabulary."""
    total, bad = port_lint.all_violations()
    assert bad == [] and total > 50


def test_port_lint_rejects_bad_names():
    bad = port_lint.violations({"SeaweedFS_volume_Bad": "gauge",
                                "SeaweedFS_volume_x": "counter",
                                "SeaweedFS_filer_y_total": "gauge",
                                "SeaweedFS_nope_z_total": "counter"}, [])
    assert len(bad) == 4
    assert port_lint.exposition_violations(
        "# TYPE SeaweedFS_volume_ok_total counter\n") == []


def test_stream_chunk_states_feed_their_family():
    """Every streaming chunk state (forwarded, written, stalled,
    crc_failed) and resumed byte the plane counts lands in its metric
    family as well as in the in-process counters."""
    text0 = metrics.default_registry().render()
    for state in decoder.STREAM_CHUNK_STATES:
        decoder.REPAIR.inc("stream_chunks", state)
    decoder.REPAIR.add_resumed(4096)
    text1 = metrics.default_registry().render()

    def val(text, name, **labels):
        return sum(v for n, lb, v in metrics.parse_exposition(text)
                   if n == name and all(lb.get(k) == w for k, w in labels.items()))

    for state in ("forwarded", "written", "stalled", "crc_failed"):
        assert val(text1, decoder.REPAIR_STREAM_CHUNKS, state=state) \
            == val(text0, decoder.REPAIR_STREAM_CHUNKS, state=state) + 1
    assert val(text1, decoder.REPAIR_RESUMED_BYTES) \
        == val(text0, decoder.REPAIR_RESUMED_BYTES) + 4096


# --- history and alerts -------------------------------------------------------
def _series(seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.5, 3.0, n)) + 1000.0
    v = np.cumsum(rng.integers(0, 50, n)).astype(float)
    if seed % 2:  # a counter reset halfway
        v[n // 2:] -= v[n // 2] - 3.0
    return [(float(a), float(b)) for a, b in zip(t, v)]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("window", [5.0, 30.0, 1e6])
def test_counter_rate_equal_reference(seed, window):
    s = _series(seed)
    now = s[-1][0] + 0.5
    assert ref_history.counter_rate(s, window, now) == history.counter_rate(s, window, now)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("q", [0.5, 0.9, 0.99, 0.999])
def test_quantile_from_bucket_rates_equal_reference(seed, q):
    rng = np.random.default_rng(seed)
    bounds = sorted(set(float(x) for x in rng.exponential(0.1, 12))) + [float("inf")]
    cum, rates = 0.0, {}
    for b in bounds:
        cum += float(rng.integers(0, 20)) * (seed != 5)
        rates[b] = cum
    fa, fb = {}, {}
    assert ref_history.quantile_from_bucket_rates(rates, q, flags=fa) \
        == history.quantile_from_bucket_rates(rates, q, flags=fb)
    assert fa == fb


def test_default_rules_names_and_severities_equal_reference():
    assert [(r.name, r.severity) for r in ref_alerts.default_rules()] \
        == [(r.name, r.severity) for r in alerts.default_rules()]
    assert [(s.name, s.role, s.kind, s.objective) for s in ref_alerts.DEFAULT_SLOS] \
        == [(s.name, s.role, s.kind, s.objective) for s in alerts.DEFAULT_SLOS]


def _alert_story(mod_metrics, mod_history, mod_alerts, seed: int):
    """A synthetic cluster's counters through 12 scrapes at fixed times;
    -> (firing {name: (severity, detail)} after each scrape)."""
    rng = np.random.default_rng(seed)
    reg = mod_metrics.Registry()
    req = reg.counter("SeaweedFS_http_request_total", "", ("role", "method", "code"))
    lat = reg.histogram("SeaweedFS_http_request_seconds", "", ("role", "method"))
    deg = reg.counter("SeaweedFS_volume_degraded_reads_total", "", ("reason",))
    stale = reg.gauge("SeaweedFS_master_stale_heartbeats", "", ("node",))
    scrub = reg.counter("SeaweedFS_volume_scrub_findings_total", "", ("kind",))
    hist = mod_history.MetricsHistory(reg, interval=1.0, slots=64)
    eng = mod_alerts.AlertEngine(history=hist, registry=reg)
    out = []
    for step in range(12):
        for role in ("filer", "volume"):
            ok = int(rng.integers(50, 200))
            req.labels(role, "GET", "200").inc(ok)
            if step >= 4:
                req.labels(role, "GET", "500").inc(int(ok * rng.uniform(0.05, 0.3)))
            for _ in range(20):
                lat.labels(role, "GET").observe(float(rng.exponential(0.02 + step * 0.05)))
        if step >= 6:
            deg.labels("ec_reconstruct").inc(int(rng.integers(5, 30)))
            scrub.labels("corrupt_needle").inc(1)
        stale.labels("n1").set(1 if 5 <= step < 9 else 0)
        hist.scrape_once(now=2000.0 + 5.0 * step)
        eng.evaluate(now=2000.0 + 5.0 * step)
        out.append({name: (a.get("severity"), a.get("detail"))
                    for name, a in eng.firing.items()})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_rules_fire_with_same_details(frozen_clock, seed):
    a = _alert_story(ref_metrics, ref_history, ref_alerts, seed)
    b = _alert_story(metrics, history, alerts, seed)
    assert a == b
    assert any(a)  # the story fires something


# --- events -------------------------------------------------------------------
def test_event_types_equal_reference():
    assert ref_events.EVENT_TYPES == events.EVENT_TYPES
    assert ref_events.EVENT_FAMILIES == events.EVENT_FAMILIES


def _journal(mod, seed: int):
    rng = np.random.default_rng(seed)
    rec = mod.EventRecorder(capacity=32)
    rec.enable()
    types = sorted(mod.EVENT_TYPES)
    for i in range(60):
        rec.record(str(rng.choice(types)), volume=int(rng.integers(1, 5)),
                   node=f"n{int(rng.integers(0, 3))}", k=i,
                   collection=str(rng.choice(["a", "b"])))
    return rec


@pytest.mark.parametrize("seed", [0, 1])
def test_journal_cursor_semantics_equal_reference(frozen_clock, seed):
    a, b = _journal(ref_events, seed), _journal(events, seed)
    assert a.recorded_total == b.recorded_total and a.dropped_total == b.dropped_total
    def wall(evs):  # the monotonic stamp is each process clock's own
        return [{k: v for k, v in e.items() if k != "mono"} for e in evs]

    for kw in ({}, {"volume": 2}, {"collection": "a"}, {"limit": 5},
               {"type": "degraded_read"}, {"since": a.last_wall - 1.0},
               {"since": a.last_wall}):
        assert wall(a.events(**kw)) == wall(b.events(**kw)), kw
    assert wall(e.to_dict() for e in a.tail(10, limit=7)) \
        == wall(e.to_dict() for e in b.tail(10, limit=7))


def test_disabled_emit_is_one_attribute_check(monkeypatch):
    """A disabled journal's emit returns None before touching anything."""
    rec = events.EventRecorder(capacity=4)
    monkeypatch.setattr(events, "_recorder", rec)
    assert not rec.enabled
    assert events.emit("degraded_read", volume=1) is None
    assert rec.recorded_total == 0
    rec.enable()
    assert events.emit("degraded_read", volume=1) is not None


# --- profiler -----------------------------------------------------------------
def _frames():
    def leaf():
        import sys

        return sys._getframe()

    def mid():
        return leaf()

    return mid()


def test_profiler_helpers_equal_reference():
    f = _frames()
    assert ref_profiler.collapse_frame(f, "worker-1") \
        == profiler.collapse_frame(f, "worker-1")
    rng = np.random.default_rng(3)
    stacks = {";".join(f"f{int(x)}" for x in rng.integers(0, 6, int(rng.integers(1, 5)))):
              int(rng.integers(1, 50)) for _ in range(40)}
    ma, mb = {}, {}
    ref_profiler.merge_collapsed(ma, stacks, prefix="master+volume")
    profiler.merge_collapsed(mb, stacks, prefix="master+volume")
    assert ma == mb
    assert ref_profiler.render_collapsed(ma) == profiler.render_collapsed(mb)
    assert ref_profiler.top_frames(ma, 5) == profiler.top_frames(mb, 5)
    for s in (0.01, 1, "2.5", 1e9):
        assert ref_profiler.clamp_seconds(s) == profiler.clamp_seconds(s)


class _FakeProfile:
    """A torch.profiler.profile stand-in recording start/stop."""

    log: list = []

    def __init__(self, *a, **kw):
        pass

    def start(self):
        _FakeProfile.log.append("start")

    def stop(self):
        _FakeProfile.log.append("stop")

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": [{"cat": "kernel", "name": "md5_batch_kernel"}]}, f)


@pytest.fixture()
def fake_cuda_profiler(monkeypatch):
    import torch
    import torch.profiler as tp

    _FakeProfile.log = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(tp, "profile", _FakeProfile)
    return _FakeProfile


def test_device_trace_is_gzip_of_the_capture(fake_cuda_profiler):
    out = profiler.device_trace(0.05)
    doc = json.loads(gzip.decompress(out))
    assert doc["traceEvents"][0]["cat"] == "kernel"
    assert fake_cuda_profiler.log == ["start", "stop"]


def test_device_route_429_while_busy_and_off_after_failure(fake_cuda_profiler, monkeypatch):
    svc = HTTPService()
    svc.serve_debug_routes()
    svc.start()
    try:
        assert profiler._device_lock.acquire(blocking=False)
        try:
            st, _, body = http_request("GET", svc.url + "/debug/pprof/device?seconds=0.05")
            assert st == 429 and b"already running" in body
        finally:
            profiler._device_lock.release()
        st, _, _ = http_request("GET", svc.url + "/debug/pprof/device?seconds=nan")
        assert st == 400

        def boom(self, path):
            raise RuntimeError("export failed")

        monkeypatch.setattr(_FakeProfile, "export_chrome_trace", boom)
        fake_cuda_profiler.log.clear()
        st, _, body = http_request("GET", svc.url + "/debug/pprof/device?seconds=0.05")
        assert st == 500 and b"export failed" in body
        assert fake_cuda_profiler.log == ["start", "stop"]  # stopped once, not left on
        assert profiler._device_lock.acquire(blocking=False)  # released
        profiler._device_lock.release()
    finally:
        svc.stop()


def test_device_route_501_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    svc = HTTPService()
    svc.serve_debug_routes()
    svc.start()
    try:
        st, _, body = http_request("GET", svc.url + "/debug/pprof/device?seconds=0.05")
        assert st == 501 and b"CUDA" in body
    finally:
        svc.stop()


# --- tracing across the port's clients --------------------------------------
def test_span_propagation_through_http_request_and_pooled():
    """A server span's trace id and span id ride http_request and
    PooledHTTP to the next hop, whose server span is its child."""
    inner = HTTPService()
    inner.enable_tracing("volume")
    inner.route("GET", r"/leaf")(lambda req: Response({"ok": True}))
    inner.start()
    outer = HTTPService()
    outer.enable_tracing("filer")
    pool = PooledHTTP()

    def front(req):
        http_request("GET", inner.url + "/leaf")
        pool.request("GET", inner.url + "/leaf")
        return Response({"ok": True})

    outer.route("GET", r"/front")(front)
    outer.start()
    try:
        st, hdrs, _ = http_request("GET", outer.url + "/front")
        assert st == 200
        tid = hdrs[trace.TRACE_HEADER]
        spans = trace.collector().trace_spans(tid)
        root = [s for s in spans if s["name"] == "GET /front"]
        leaves = [s for s in spans if s["name"] == "GET /leaf"]
        assert len(root) == 1 and len(leaves) == 2
        assert {s["parent_id"] for s in leaves} == {root[0]["span_id"]}
        assert {s["role"] for s in spans} == {"filer", "volume"}
    finally:
        pool.close()
        outer.stop()
        inner.stop()


def test_slow_thresholds_per_role_equal_reference(monkeypatch):
    for mod in (ref_trace, trace):
        monkeypatch.setattr(mod, "_slow_threshold_s", 1.0)
        monkeypatch.setattr(mod, "_slow_threshold_roles", {})
        mod.set_slow_threshold_ms(250, role="filer")
        mod.set_slow_threshold_ms(0, role="volume")
    for role in ("filer", "volume", "master", None):
        assert ref_trace.slow_threshold_s(role) == trace.slow_threshold_s(role)


def test_kernel_spans_feed_the_port_histograms(tmp_path):
    """The port's hash service and codec on the CPU observe the kernel
    families under the port's labels: one batch, one observation."""
    from seaweedfs_tpu_torch.ops.hash_service import HashService
    from seaweedfs_tpu_torch.ops.rs_kernel import RSCodec
    from seaweedfs_tpu_torch.storage.erasure_coding import encoder

    reg = metrics.default_registry()

    def count(family, kernel):
        return sum(v for n, lb, v in metrics.parse_exposition(reg.render())
                   if n == family + "_count" and lb.get("kernel") == kernel)

    svc = HashService(device="cpu", min_batch=1)
    svc.start()
    try:
        c0, b0 = count(trace.FILER_HASH_SECONDS, "batch-cpu"), svc.batches
        futs = svc.submit_many([bytes([i]) * 4096 for i in range(6)])
        for f in futs:
            f.wait()
        assert svc.batches > b0
        assert count(trace.FILER_HASH_SECONDS, "batch-cpu") - c0 == svc.batches - b0
    finally:
        svc.stop()
    base = str(tmp_path / "1")
    with open(base + ".dat", "wb") as f:
        f.write(np.random.default_rng(1).bytes(50_000))
    e0 = count(trace.EC_ENCODE_SECONDS, "pipeline-cpu")
    encoder.write_ec_files(base, codec=RSCodec(device="cpu"),
                           large_block_size=10000, small_block_size=100)
    assert count(trace.EC_ENCODE_SECONDS, "pipeline-cpu") == e0 + 1
    os.remove(base + ".ec03")
    d0 = count(trace.EC_DECODE_SECONDS, "rebuild")
    assert encoder.rebuild_ec_files(base, codec=RSCodec(device="cpu")) == [3]
    assert count(trace.EC_DECODE_SECONDS, "rebuild") == d0 + 1


# --- the verbs against one stub endpoint --------------------------------------
class _Stub:
    """One HTTP endpoint that answers as the master, the only volume
    server and every debug route, with fixed bodies."""

    def __init__(self) -> None:
        stub = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                path, _, query = self.path.partition("?")
                body, status, ctype = stub.answer(path, query)
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.addr = f"127.0.0.1:{self.httpd.server_address[1]}"
        self.url = "http://" + self.addr
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()

    def answer(self, path, query):
        j = "application/json"
        node = {"id": self.addr, "url": self.addr, "max_volume_count": 8,
                "volume_infos": [{"id": 5, "replica_placement": 1, "size": 10}],
                "ec_shard_infos": [{"id": 9, "shards": [0, 1, 2], "collection": ""}]}
        if path == "/dir/status":
            return json.dumps({"Topology": {"data_centers": [{"name": "dc1", "racks": [
                {"name": "r1", "nodes": [node]}]}]}}).encode(), 200, j
        if path == "/cluster/ps":
            return json.dumps({"filers": [], "brokers": []}).encode(), 200, j
        if path == "/metrics":
            return "\n".join([
                "# TYPE SeaweedFS_master_volume_size_limit_bytes gauge",
                "SeaweedFS_master_volume_size_limit_bytes 100",
                f'SeaweedFS_master_heartbeat_age_seconds{{node="{self.addr}"}} 1.5',
                f'SeaweedFS_master_free_slots{{node="{self.addr}"}} 5',
                f'SeaweedFS_master_volume_size_bytes{{volume="5",node="{self.addr}"}} 95',
                f'SeaweedFS_master_volume_readonly{{volume="5",node="{self.addr}"}} 1',
                'SeaweedFS_master_ec_missing_shards{volume="9"} 2',
                f'SeaweedFS_volume_disk_used_bytes{{server="{self.addr}",dir="/d"}} 1073741824',
                f'SeaweedFS_volume_disk_free_bytes{{server="{self.addr}",dir="/d"}} 2147483648',
                'SeaweedFS_alerts_firing{alert="degraded_reads",severity="warning"} 1',
            ]).encode() + b"\n", 200, "text/plain"
        if path == "/debug/alerts":
            return json.dumps({"proc": "p1", "alerts": [
                {"name": "slo_burn_fast", "severity": "critical", "firing": True,
                 "detail": "filer_p99 burning 20x"},
                {"name": "disk_near_cap", "severity": "warning", "firing": False}],
                "slos": {"filer_p99": {"objective": 0.99, "burn_fast": 20.0,
                                       "burn_slow": 3.5}}}).encode(), 200, j
        if path == "/debug/traces":
            spans = [
                {"trace_id": "abc1", "span_id": "s1", "parent_id": None, "name": "PUT /a",
                 "role": "filer", "start": 100.0, "duration_ms": 12.5, "status": "ok",
                 "attrs": {}},
                {"trace_id": "abc1", "span_id": "s2", "parent_id": "s1",
                 "name": "GET /dir/assign", "role": "master", "start": 100.001,
                 "duration_ms": 0.5, "status": "ok", "attrs": {}},
                {"trace_id": "abc1", "span_id": "s3", "parent_id": "s1", "name": "POST /5,01",
                 "role": "volume", "start": 100.002, "duration_ms": 3.25, "status": "ok",
                 "attrs": {"volume": 5}},
                {"trace_id": "def2", "span_id": "t1", "parent_id": None, "name": "GET /b",
                 "role": "filer", "start": 90.0, "duration_ms": 1.0, "status": "error",
                 "attrs": {}},
            ]
            if query.startswith("id="):
                tid = query[3:]
                mine = [s for s in spans if s["trace_id"] == tid]
                return json.dumps({"trace_id": tid, "found": bool(mine),
                                   "spans": mine}).encode(), 200, j
            traces = [{"trace_id": t, "spans": [s for s in spans if s["trace_id"] == t]}
                      for t in ("abc1", "def2")]
            return json.dumps({"traces": traces, "capacity": 2048}).encode(), 200, j
        if path == "/debug/pprof/profile":
            return json.dumps({"proc": "p1", "role": "master", "samples": 30, "stacks": {
                "MainThread;a.py:main;b.py:work": 20, "pool;c.py:run": 10}}).encode(), 200, j
        if path == "/debug/metrics/history":
            series = [
                {"family": "SeaweedFS_http_request_total",
                 "labels": {"role": "filer", "method": "GET", "code": "200"}, "rate": 40.0},
                {"family": "SeaweedFS_http_request_total",
                 "labels": {"role": "filer", "method": "GET", "code": "500"}, "rate": 2.0},
                {"family": "SeaweedFS_http_request_seconds_bucket",
                 "labels": {"role": "filer", "method": "GET", "le": "0.01"}, "rate": 30.0},
                {"family": "SeaweedFS_http_request_seconds_bucket",
                 "labels": {"role": "filer", "method": "GET", "le": "0.1"}, "rate": 41.0},
                {"family": "SeaweedFS_http_request_seconds_bucket",
                 "labels": {"role": "filer", "method": "GET", "le": "+Inf"}, "rate": 42.0},
                {"family": "SeaweedFS_http_request_total",
                 "labels": {"role": "volume", "method": "POST", "code": "201"}, "rate": 9.5},
                {"family": "SeaweedFS_process_start_time_seconds", "labels": {},
                 "last": 1_700_000_000.0 - 3700},
                {"family": "SeaweedFS_build_info",
                 "labels": {"version": "0.1.0", "role": "filer"}, "last": 1},
                {"family": "SeaweedFS_build_info",
                 "labels": {"version": "0.1.0", "role": "master"}, "last": 1},
            ]
            ex = {"SeaweedFS_http_request_seconds": [
                {"labels": {"role": "filer", "method": "GET"}, "value": 0.09,
                 "trace_id": "abc1", "ts": 1_700_000_000.0 - 5}]}
            return json.dumps({"proc": "p1", "series": series,
                               "exemplars": ex}).encode(), 200, j
        if path == "/debug/events":
            evs = [
                {"seq": 1, "ts": 95.0, "type": "volume_state", "volume": 5, "node": None,
                 "task": None, "trace_id": None, "attrs": {"state": "created"}},
                {"seq": 2, "ts": 100.0015, "type": "fault_injected", "volume": 5,
                 "node": None, "task": None, "trace_id": "abc1",
                 "attrs": {"point": "volume.read.dat", "mode": "error"}},
                {"seq": 3, "ts": 100.003, "type": "degraded_read", "volume": 5,
                 "node": None, "task": None, "trace_id": "abc1",
                 "attrs": {"reason": "dat_read", "collection": "acme"}},
                {"seq": 4, "ts": 130.0, "type": "task_done", "volume": 5, "node": "n1",
                 "task": "ec_rebuild:5", "trace_id": None,
                 "attrs": {"collection": "acme", "state": "completed"}},
            ]
            return json.dumps({"proc": "p1", "role": "master", "events": evs}).encode(), \
                200, j
        return b'{"error": "no route"}', 404, j


@pytest.fixture(scope="module")
def stub():
    s = _Stub()
    yield s
    s.stop()


VERB_LINES = [
    "cluster.check",
    "cluster.trace -limit 5",
    "cluster.trace -limit 5 -minMs 5",
    "cluster.profile -seconds 0.1",
    "cluster.top -once",
    "cluster.top -once -window 30",
    "cluster.why abc1",
    "cluster.why 5",
    "cluster.why acme",
]


@pytest.mark.parametrize("line", VERB_LINES)
def test_verbs_byte_equal_reference_on_stub(stub, frozen_clock, monkeypatch, line):
    monkeypatch.setattr(time, "time", lambda: frozen_clock[0])
    want = ref_run_command(RefCommandEnv(stub.url), line)
    got = run_command(CommandEnv(stub.url), line)
    assert got == want
    assert got.strip()


def test_verbs_reject_spool(tmp_path):
    """A spool that holds no records, with no live endpoint: `cluster.why`
    refuses it with the JAX verb's error, and `cluster.top` renders the
    JAX verb's empty post-mortem lines."""
    from seaweedfs_tpu.shell.env import ShellError as RefShellError
    from seaweedfs_tpu_torch.shell.env import ShellError

    empty = str(tmp_path / "spool")
    env, ref_env = CommandEnv("http://127.0.0.1:1"), RefCommandEnv("http://127.0.0.1:1")
    line = f"cluster.why 5 -spool {empty}"
    with pytest.raises(RefShellError) as a:
        ref_run_command(ref_env, line)
    with pytest.raises(ShellError) as b:
        run_command(env, line)
    assert str(b.value) == str(a.value)
    assert "hold no journal records" in str(b.value)
    line = f"cluster.top -once -spool {empty}"
    got = run_command(env, line)
    assert got == ref_run_command(ref_env, line)
    assert f"post-mortem spool {empty}: raw=0B/0seg" in got


def test_cluster_check_fail_mode_equal_reference(stub):
    from seaweedfs_tpu.shell.env import ShellError as RefShellError
    from seaweedfs_tpu_torch.shell.env import ShellError

    with pytest.raises(RefShellError) as a:
        ref_run_command(RefCommandEnv(stub.url), "cluster.check -fail")
    with pytest.raises(ShellError) as b:
        run_command(CommandEnv(stub.url), "cluster.check -fail")
    assert str(a.value) == str(b.value)


# --- debug routes and roles ---------------------------------------------------
@contextlib.contextmanager
def _cluster(pkg: str, tmp, security=None):
    """master + volume server + filer (metrics port) + WebDAV + S3 + IAM of
    one package, in this process. The master, the volume server and the
    filer run behind their fastlane engines, as a deployment does; the
    others start with the front door off (the S3 gateway's engine front is
    not ported)."""
    if pkg == "ref":
        from seaweedfs_tpu.iamapi.iam_server import IamServer
        from seaweedfs_tpu.s3api.s3_server import S3Server
        from seaweedfs_tpu.server.filer import FilerServer
        from seaweedfs_tpu.server.master import MasterServer
        from seaweedfs_tpu.server.volume import VolumeServer
        from seaweedfs_tpu.server.webdav import WebDavServer
        dev = {}
    else:
        from seaweedfs_tpu_torch.iamapi.iam_server import IamServer
        from seaweedfs_tpu_torch.s3api.s3_server import S3Server
        from seaweedfs_tpu_torch.server.filer import FilerServer
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume import VolumeServer
        from seaweedfs_tpu_torch.server.webdav import WebDavServer
        dev = {"device": "cpu"}
    sec = {"security": security} if security is not None else {}
    started = []
    with pytest.MonkeyPatch.context() as mp:
        try:
            m = MasterServer(port=0, pulse_seconds=1, **sec)
            m.start()
            started.append(m)
            v = VolumeServer([str(tmp / f"{pkg}-v")], m.url, port=0, pulse_seconds=1,
                             max_volume_count=10, **dev, **sec)
            v.start()
            started.append(v)
            assert m.fastlane is not None and v.fastlane is not None
            f = FilerServer(m.url, port=0, metrics_port=-1, **dev)
            f.start()
            started.append(f)
            assert f._fl_filer_on
            mp.setenv("SEAWEEDFS_TPU_DISABLE_FASTLANE", "1")
            w = WebDavServer(f.url, port=0)
            w.start()
            started.append(w)
            s3 = S3Server(f.url, port=0)
            s3.start()
            started.append(s3)
            iam = IamServer(f.url, port=0)
            iam.start()
            started.append(iam)
            yield {"master": m, "volume": v, "filer": f, "webdav": w, "s3": s3, "iam": iam}
        finally:
            for srv in reversed(started):
                srv.stop()


def _request_script(c, request) -> None:
    """The same short script against either package's cluster."""
    for i in range(3):
        st, _, _ = request("PUT", f"{c['filer'].url}/obs/f{i}.txt", b"x" * (100 + i))
        assert st == 201
        st, _, _ = request("GET", f"{c['filer'].url}/obs/f{i}.txt")
        assert st == 200
    request("GET", f"{c['filer'].url}/obs/missing.txt")
    request("PUT", f"{c['webdav'].url}/dav.txt", b"dav")
    request("PROPFIND", f"{c['webdav'].url}/", None)
    request("GET", f"{c['s3'].url}/")
    request("POST", f"{c['iam'].url}/", b"Action=ListUsers")
    request("GET", f"{c['master'].url}/dir/status")
    request("GET", f"{c['volume'].url}/status")


# families whose presence follows process-wide state that other tests in
# the same process set (a tenant recorded, qos armed, a spool enabled, a
# forecast, a frame aggregated), so the two packages' processes need not
# agree on them here: usage, heat and days-to-full, qos, the telemetry
# spool and the cluster aggregate (their shapes are held against the JAX
# package in tests/test_torch_{usage_heat,qos,telemetry_store,
# cluster_telemetry}.py); and the S3 gateway's fastlane front, not
# ported
EXCLUDED_FAMILIES = re.compile(
    r"^SeaweedFS_(usage|heat|node_days|qos|telemetry|cluster)_"
    r"|^SeaweedFS_volume_heat_|^SeaweedFS_s3_fastlane_"
)


def _families(text: str, reg) -> dict:
    """{family: (kind, sorted label names)} of an exposition: a registry
    family's declared label names, a collector family's from its samples."""
    kinds, labels = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()[:4]
            kinds[name] = kind
    for name, lb, _ in metrics.parse_exposition(text):
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        fam = base if base in kinds else name
        labels.setdefault(fam, set()).update(k for k in lb if k != "le")
    with reg._lock:
        declared = {n: tuple(m.label_names) for n, m in reg._metrics.items()}
    return {f: (k, tuple(sorted(declared[f] if f in declared else labels.get(f, ()))))
            for f, k in kinds.items() if not EXCLUDED_FAMILIES.search(f)}


def _fresh_sample_state() -> None:
    """Both packages' process-wide state that decides whether a collector
    family has samples at all, and so which label names a scrape shows
    for it, set back to a fresh process's: the SLO burn cache
    (`SeaweedFS_slo_burn_rate{slo,window}`) and the event counts by type
    (`SeaweedFS_events_recorded_total{type}`). Another test file in the
    same worker fills one package's and not the other's, before this test
    or, through servers it left running, during it (the script records
    no event and burns no SLO in a fresh process)."""
    for alerts_mod, events_mod in ((ref_alerts, ref_events), (alerts, events)):
        eng = alerts_mod.engine()
        with eng._lock:
            eng._slo_burns = {}
        rec = events_mod.recorder()
        with rec._lock:
            rec.recorded_by_type.clear()


def test_roles_expose_the_same_families_as_reference(tmp_path):
    """The same script against a JAX and a port cluster (master, volume
    server, filer, WebDAV, S3, IAM) leaves /metrics with the same set of
    (family, label names), apart from EXCLUDED_FAMILIES. Both registries
    are forced to hold every lazily-created family first (each package's
    lint), the history ring the alert engine reads starts empty in both,
    and the state that decides whether a collector family has samples is
    a fresh process's in both before each scrape (`_fresh_sample_state`),
    so what other tests in this process touched cannot tell them apart."""
    from seaweedfs_tpu.server.httpd import http_request as ref_http_request

    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import check_metric_names as ref_lint

    ref_lint.collect()
    port_lint.collect()
    ref_history.default_history().clear()
    history.default_history().clear()
    out = {}
    for pkg, request, reg in (("ref", ref_http_request, ref_metrics.default_registry()),
                              ("port", http_request, metrics.default_registry())):
        with _cluster(pkg, tmp_path) as c:
            _request_script(c, request)
            _fresh_sample_state()
            st, _, body = request("GET", c["master"].url + "/metrics")
            assert st == 200
            out[pkg] = _families(body.decode(), reg)
            st, _, fbody = request("GET", c["filer"].metrics_service.url + "/metrics")
            assert st == 200 and _families(fbody.decode(), reg).keys() == out[pkg].keys()
    diff = set(out["port"].items()) ^ set(out["ref"].items())
    assert out["port"] == out["ref"], sorted(
        (f, kl, "port" if out["port"].get(f) == kl else "ref") for f, kl in diff)
    roles = {"master", "volume", "filer", "webdav", "s3", "iam"}
    assert out["port"]["SeaweedFS_build_info"] == ("gauge", ("role", "version"))
    text = metrics.default_registry().render()
    assert roles <= {lb.get("role") for n, lb, _ in metrics.parse_exposition(text)
                     if n == "SeaweedFS_build_info"}
    assert port_lint.exposition_violations(text) == []


def _shape(obj, depth=0):
    if isinstance(obj, dict):
        return {k: _shape(v, depth + 1) for k, v in obj.items()} if depth < 1 \
            else sorted(obj)
    return type(obj).__name__


@pytest.mark.parametrize("route", [
    "/debug/traces?limit=5", "/debug/requests", "/debug/metrics/history?samples=2",
    "/debug/alerts", "/debug/events?limit=5", "/debug/pprof/threads",
])
def test_debug_routes_answer_the_reference_shapes(tmp_path, route):
    """Each debug route answers the same top-level keys (and value types)
    in both packages."""
    from seaweedfs_tpu.server.httpd import HTTPService as RefHTTPService
    from seaweedfs_tpu.server.httpd import http_request as ref_http_request

    keys = {}
    for name, cls, request in (("ref", RefHTTPService, ref_http_request),
                               ("port", HTTPService, http_request)):
        svc = cls()
        svc.enable_tracing("master")
        svc.start()
        try:
            st, _, body = request("GET", svc.url + route)
            assert st == 200
            doc = json.loads(body)
            keys[name] = {k: type(v).__name__ for k, v in doc.items()}
        finally:
            svc.stop()
    assert keys["port"] == keys["ref"]


@pytest.mark.parametrize("route", [
    "/debug/traces?limit=x", "/debug/traces?min_ms=nan", "/debug/traces?id=XYZ",
    "/debug/requests?limit=q", "/debug/metrics/history?window=-1",
    "/debug/metrics/history?since=inf", "/debug/alerts?window=0",
    "/debug/events?since=nan", "/debug/events?type=nope", "/debug/events?volume=v",
    "/debug/pprof/profile?seconds=nan", "/debug/pprof/device?seconds=inf",
])
def test_debug_routes_bad_params_400_as_reference(route):
    from seaweedfs_tpu.server.httpd import HTTPService as RefHTTPService
    from seaweedfs_tpu.server.httpd import http_request as ref_http_request

    status = {}
    for name, cls, request in (("ref", RefHTTPService, ref_http_request),
                               ("port", HTTPService, http_request)):
        svc = cls()
        svc.enable_tracing("master")
        svc.start()
        try:
            status[name] = request("GET", svc.url + route)[0]
        finally:
            svc.stop()
    assert status["port"] == status["ref"] == 400


def test_metrics_endpoint_under_jwt(tmp_path):
    """The counterpart of the JAX security suite's metrics test: a master
    with a write key still serves /metrics with its request counters."""
    from seaweedfs_tpu_torch.security import SecurityConfig
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume import VolumeServer

    sec = SecurityConfig(write_key="cluster-secret")
    master = MasterServer(port=0, pulse_seconds=1, volume_size_limit_mb=64, security=sec)
    master.start()
    vs = VolumeServer([str(tmp_path / "v0")], master.url, port=0, pulse_seconds=1,
                      max_volume_count=10, security=sec, device="cpu")
    vs.start()
    try:
        status, _, body = http_request("GET", f"{master.url}/metrics")
        assert status == 200
        text = body.decode()
        assert "SeaweedFS_http_request_total" in text
        assert 'role="master"' in text
    finally:
        vs.stop()
        master.stop()


# --- live port clusters: each verb names every node ---------------------------
@pytest.fixture(scope="module")
def live(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("observe-live")
    from seaweedfs_tpu_torch.server.filer import FilerServer
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume import VolumeServer

    m = MasterServer(port=0, pulse_seconds=1)
    m.start()
    vols = []
    for i in range(4):
        v = VolumeServer([str(tmp / f"v{i}")], m.url, port=0, rack=f"r{i}",
                         pulse_seconds=1, max_volume_count=20, device="cpu")
        v.start()
        vols.append(v)
    f = FilerServer(m.url, port=0, metrics_port=-1, device="cpu")
    f.start()
    # a quiet alert state: what earlier tests in this process fired must
    # not colour this cluster's check
    history.default_history().clear()
    alerts.engine().evaluate()
    yield {"master": m, "vols": vols, "filer": f, "env": CommandEnv(m.url), "tmp": tmp}
    history.default_history().clear()  # leave no degraded-read alert firing
    alerts.engine().evaluate()
    f.stop()
    for v in vols:
        v.stop()
    m.stop()


def test_live_verbs_name_every_node(live):
    env, vols, f = live["env"], live["vols"], live["filer"]
    for i in range(8):
        # a query keeps the write on the filer's Python path, whose chain
        # (filer, the master's assign, the volume's upload) cluster.trace
        # must show; a native write leaves only the volume's spans (held in
        # test_torch_filer_native.py::test_native_write_trace_in_cluster_trace)
        st, _, _ = http_request("PUT", f"{f.url}/live/f{i}?replication=000", b"y" * 3000)
        assert st == 201
    tr = run_command(env, "cluster.trace -limit 20")
    assert "roles=filer,master,volume" in tr
    out = run_command(env, "cluster.check")
    assert out.endswith("cluster is healthy")
    assert all(f"node {v.node_id} " in out for v in vols)
    top = run_command(env, "cluster.top -once")
    assert {"master", "volume", "filer"} <= {ln.split()[0] for ln in top.splitlines()[2:]
                                             if ln and not ln.startswith(" ")}
    prof = run_command(env, "cluster.profile -seconds 0.2")
    assert prof.startswith(f"profiled {len(vols) + 2}/{len(vols) + 2} endpoint(s)")
    assert ";" in prof


def test_observe_ec_sequence_why_events(live):
    """The chip script's EC sequence (allocate, POSTs, ec.encode, two data
    shards deleted, degraded GETs, ec.rebuild -mode classic) at a small
    size on the CPU: `cluster.why <vid>` lists exactly the event types the
    chip script checks for (chip_smoke.OBS_WHY_EVENTS)."""
    import chip_smoke

    env, vols = live["env"], live["vols"]
    events.enable()
    res = chip_smoke.observe_ec_sequence(env, vols, 951, 12 << 20, 0)
    assert res["degraded_gets"] > 0
    why = run_command(env, "cluster.why 951")
    assert chip_smoke.why_event_types(why) == sorted(chip_smoke.OBS_WHY_EVENTS)
    assert "state=created" in why and "degraded_read volume=951" in why


def test_ui_pages(live):
    st, _, body = http_request("GET", live["master"].url + "/ui")
    assert st == 200 and b"<h1>Master" in body
    assert all(v.node_id.encode() in body for v in live["vols"])
    st, _, body = http_request("GET", live["vols"][0].url + "/ui")
    assert st == 200 and b"<h1>Volume server" in body


# --- the chain restart's whole detail -------------------------------------------
def test_chain_restart_event_keeps_the_whole_detail(monkeypatch):
    """A forced hop failure journals `chain_restart` with the hop's whole
    detail (the JAX event cuts it to 200 characters)."""
    from seaweedfs_tpu_torch.shell import commands_ec

    events.enable()
    detail = ("ConnectionRefusedError: [Errno 111] Connection refused after 3.2 ms; "
              + "z" * 400)
    resp = {"error": "hop_unreachable", "failed_hop_server": "127.0.0.1:7",
            "chunk": 3, "detail": detail}
    err = commands_ec._hop_failed(resp, "127.0.0.1:7")

    def chain(env, plan, chunk, restarts, **kw):
        if restarts == 0:
            raise err
        return [4], {"restarts": restarts}

    monkeypatch.setattr(commands_ec, "_run_chain", chain)
    monkeypatch.setattr(commands_ec, "plan_rebuild_pipelined",
                        lambda env, vid, coll, **kw: {**plan, "chain": []})
    monkeypatch.setattr(commands_ec, "_abort", lambda *a: None)
    plan = {"volume": 77, "collection": "", "rebuilder_url": "http://127.0.0.1:2",
            "rebuilder": "127.0.0.1:2", "chain": [], "missing": [4]}
    t0 = time.time() - 0.001
    assert commands_ec.apply_rebuild_pipelined(None, plan) == ([4], {"restarts": 1})
    (ev,) = events.recorder().events(type="chain_restart", volume=77, since=t0)
    assert ev["node"] == "127.0.0.1:7" and ev["attrs"]["reason"] == "hop_failed"
    assert ev["attrs"]["chunk"] == 3
    assert ev["attrs"]["detail"].startswith(detail) and len(ev["attrs"]["detail"]) > 400


# --- the push loop --------------------------------------------------------------
def test_push_loop_same_path_and_stops():
    """Both packages' push loops PUT the exposition to the same gateway
    path; the port's stops at its stop event."""
    got = []

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_PUT(self):
            n = int(self.headers.get("Content-Length") or 0)
            got.append((self.path, self.rfile.read(n)))
            self.send_response(202)
            self.send_header("Content-Length", "0")
            self.end_headers()

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    stops = [threading.Event(), threading.Event()]
    try:
        t_ref = ref_metrics.start_push_loop(url, "filer", "i:1", interval_sec=0.05,
                                            stop_event=stops[0])
        t_port = metrics.start_push_loop(url, "filer", "i:1", interval_sec=0.05,
                                         stop_event=stops[1])
        deadline = time.time() + 10
        while len(got) < 4:
            assert time.time() < deadline
            time.sleep(0.05)
        for ev in stops:
            ev.set()
        t_ref.join(5)
        t_port.join(5)
        assert not t_port.is_alive() and not t_ref.is_alive()
        assert {p for p, _ in got} == {"/metrics/job/filer/instance/i%3A1"}
        assert all(b"# TYPE" in body for _, body in got)
    finally:
        srv.shutdown()
        srv.server_close()


def test_device_probe_reports_under_the_reference_keys():
    """Without a CUDA device (and with JAX on the CPU) both probes report
    the same "down" record; the port picks no backend from it."""
    import torch

    from seaweedfs_tpu.ops import device_probe as ref_probe
    from seaweedfs_tpu_torch.ops import device_probe as probe

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert probe.probe_device_status(retries=0, timeout=5) \
        == ref_probe.probe_device_status(retries=0, timeout=5) \
        == {"status": "down", "h2d_mbps": None, "attempts": 1}
    assert probe.h2d_rate(timeout=5) is None and probe.device_platform(5) is None
    with pytest.raises(TimeoutError):
        probe.run_with_timeout(lambda: time.sleep(1), 0.05)
