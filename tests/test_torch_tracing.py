"""Tracing + kernel-profiling layer of the port (stats/trace.py, httpd
integration): the JAX package's tests/test_tracing.py over
seaweedfs_tpu_torch, with the port's kernel labels.

Covers: trace-id propagation across in-process servers, ring-buffer
bounding/eviction, /debug/traces + /debug/requests JSON shape, kernel-span
histograms appearing in /metrics, slow-request logging, push-error counter,
the cluster.trace shell verb, and the acceptance path: one S3 PUT producing
a single trace with spans from >= 3 server roles.
"""

import os
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu_torch.stats import default_registry
from seaweedfs_tpu_torch.stats import trace


class TestCollector:
    def test_ring_bounded_and_evicting(self):
        col = trace.TraceCollector(max_spans=8)
        for i in range(30):
            sp = col.start_span(f"s{i}", activate=False)
            col.finish_span(sp)
        traces = col.traces(limit=100)
        assert len(traces) == 8  # one span per trace; oldest 22 evicted
        names = {t["spans"][0]["name"] for t in traces}
        assert names == {f"s{i}" for i in range(22, 30)}

    def test_nesting_and_thread_context(self):
        with trace.span("outer") as outer:
            assert trace.current() == (outer.trace_id, outer.span_id)
            with trace.span("inner") as inner:
                assert inner.trace_id == outer.trace_id
                assert inner.parent_id == outer.span_id
                assert trace.current() == (inner.trace_id, inner.span_id)
            assert trace.current() == (outer.trace_id, outer.span_id)
        assert trace.current() is None

    def test_error_status(self):
        col = trace.collector()
        with pytest.raises(ValueError):
            with trace.span("boom"):
                raise ValueError("x")
        sp = [
            s for t in col.traces(limit=50) for s in t["spans"]
            if s["name"] == "boom"
        ][0]
        assert sp["status"] == "error"

    def test_context_does_not_leak_across_threads(self):
        seen = []

        def worker():
            seen.append(trace.current())

        with trace.span("parent"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
        assert seen == [None]

    def test_header_injection(self):
        assert trace.with_trace_headers(None) is None
        base = {"X-Other": "1"}
        with trace.span("ctx") as sp:
            out = trace.with_trace_headers(base)
            assert out[trace.TRACE_HEADER] == sp.trace_id
            assert out[trace.SPAN_HEADER] == sp.span_id
            assert out["X-Other"] == "1"
            assert trace.TRACE_HEADER not in base  # caller's dict untouched


@pytest.fixture()
def two_services():
    from seaweedfs_tpu_torch.server.httpd import (
        HTTPService, Response, get_json,
    )

    inner_svc = HTTPService("127.0.0.1", 0)
    inner_svc.enable_metrics("volume")

    @inner_svc.route("GET", r"/inner")
    def inner(req):
        return Response({"ok": True})

    inner_svc.start()

    outer_svc = HTTPService("127.0.0.1", 0)
    outer_svc.enable_metrics("s3")

    @outer_svc.route("GET", r"/outer")
    def outer(req):
        get_json(inner_svc.url + "/inner")
        return Response({"ok": True})

    yield outer_svc, inner_svc
    outer_svc.stop()
    inner_svc.stop()


class TestHTTPPropagation:
    def test_two_hop_trace(self, two_services):
        from seaweedfs_tpu_torch.server.httpd import get_json, http_request

        outer_svc, inner_svc = two_services
        outer_svc.start()
        status, headers, _ = http_request("GET", outer_svc.url + "/outer")
        assert status == 200
        trace_id = headers.get(trace.TRACE_HEADER)
        assert trace_id

        out = get_json(outer_svc.url + "/debug/traces?limit=50")
        assert "capacity" in out
        match = [t for t in out["traces"] if t["trace_id"] == trace_id]
        assert match, "trace not found in /debug/traces"
        tr = match[0]
        # JSON shape
        assert set(tr) >= {"trace_id", "start", "duration_ms", "root",
                           "roles", "spans"}
        assert tr["roles"] == ["s3", "volume"]
        spans = {s["name"]: s for s in tr["spans"]}
        assert set(spans[next(iter(spans))]) >= {
            "trace_id", "span_id", "parent_id", "name", "role", "start",
            "duration_ms", "status", "attrs",
        }
        outer_sp = spans["GET /outer"]
        inner_sp = spans["GET /inner"]
        assert inner_sp["parent_id"] == outer_sp["span_id"]
        assert outer_sp["parent_id"] is None
        assert outer_sp["attrs"]["status"] == 200

    def test_inherits_caller_supplied_headers(self, two_services):
        from seaweedfs_tpu_torch.server.httpd import get_json, http_request

        outer_svc, _ = two_services
        outer_svc.start()
        status, headers, _ = http_request(
            "GET", outer_svc.url + "/outer",
            headers={trace.TRACE_HEADER: "feedfacefeedface",
                     trace.SPAN_HEADER: "cafecafecafecafe"},
        )
        assert status == 200
        assert headers.get(trace.TRACE_HEADER) == "feedfacefeedface"
        out = get_json(
            outer_svc.url + "/debug/traces?limit=50"
        )
        tr = [t for t in out["traces"]
              if t["trace_id"] == "feedfacefeedface"][0]
        roots = [s for s in tr["spans"] if s["name"] == "GET /outer"]
        assert roots[0]["parent_id"] == "cafecafecafecafe"

    def test_debug_requests_shows_in_flight(self, two_services):
        from seaweedfs_tpu_torch.server.httpd import (
            Response, get_json,
        )

        outer_svc, _ = two_services
        gate = threading.Event()
        entered = threading.Event()

        @outer_svc.route("GET", r"/stall")
        def stall(req):
            entered.set()
            gate.wait(5)
            return Response({"ok": True})

        outer_svc.start()
        t = threading.Thread(
            target=lambda: get_json(outer_svc.url + "/stall")
        )
        t.start()
        try:
            assert entered.wait(5)
            out = get_json(outer_svc.url + "/debug/requests")
            names = [s["name"] for s in out["in_flight"]]
            assert "GET /stall" in names
            stalled = [s for s in out["in_flight"]
                       if s["name"] == "GET /stall"][0]
            assert stalled["status"] == "in_flight"
        finally:
            gate.set()
            t.join()

    def test_metrics_service_serves_debug_routes(self):
        from seaweedfs_tpu_torch.server.httpd import MetricsService, get_json

        ms = MetricsService("127.0.0.1", 0)
        ms.start()
        try:
            out = get_json(ms.url + "/debug/traces")
            assert "traces" in out
            out = get_json(ms.url + "/debug/requests")
            assert "in_flight" in out
        finally:
            ms.stop()


class TestSlowRequestLogging:
    def test_slow_server_span_logged(self, tmp_path, monkeypatch):
        from seaweedfs_tpu_torch.util import glog

        log = tmp_path / "slow.log"
        monkeypatch.setattr(glog, "_log_file", str(log))
        monkeypatch.setattr(trace, "_slow_threshold_s", 1e-9)
        sp = trace.begin_server_span("volume", "GET", "/slowpath", {})
        trace.end_server_span(sp, 200)
        assert log.exists()
        text = log.read_text()
        assert "slow request" in text and "/slowpath" in text

    def test_threshold_disables(self, tmp_path, monkeypatch):
        from seaweedfs_tpu_torch.util import glog

        log = tmp_path / "slow2.log"
        monkeypatch.setattr(glog, "_log_file", str(log))
        monkeypatch.setattr(trace, "_slow_threshold_s", 0.0)
        sp = trace.begin_server_span("volume", "GET", "/fastpath", {})
        trace.end_server_span(sp, 200)
        assert not log.exists()


def _metric_value(text: str, prefix: str) -> float:
    for line in text.splitlines():
        if line.startswith(prefix):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


class TestKernelSpans:
    def test_ec_encode_histogram_populated(self, tmp_path):
        from seaweedfs_tpu_torch.ops.rs_kernel import RSCodec
        from seaweedfs_tpu_torch.storage.erasure_coding import encoder
        from seaweedfs_tpu_torch.storage.erasure_coding.geometry import to_ext

        sum_key = (
            'SeaweedFS_volume_ec_encode_seconds_sum{kernel="pipeline-cpu"}'
        )
        bytes_key = (
            'SeaweedFS_volume_ec_encode_bytes_total{kernel="pipeline-cpu"}'
        )
        before = default_registry().render()
        rng = np.random.RandomState(5)
        base = str(tmp_path / "1")
        payload = rng.randint(0, 256, size=50_000, dtype=np.uint8).tobytes()
        with open(base + ".dat", "wb") as f:
            f.write(payload)
        encoder.write_ec_files(
            base, codec=RSCodec(device="cpu"),
            large_block_size=10000, small_block_size=100,
        )
        text = default_registry().render()
        assert _metric_value(text, sum_key) > _metric_value(before, sum_key)
        # %g exposition rounds to 6 significant digits; compare the delta
        delta = _metric_value(text, bytes_key) - _metric_value(before, bytes_key)
        assert delta == pytest.approx(len(payload), rel=0.05)
        # the encode also left an ec.encode span in the trace ring (other
        # tests' encodes may share the process-wide ring: match on bytes)
        spans = [
            s for t in trace.collector().traces(limit=100)
            for s in t["spans"] if s["name"] == "ec.encode"
        ]
        assert any(s["attrs"]["bytes"] == len(payload) for s in spans)

        # rebuild (decode family): drop a shard and regenerate
        os.unlink(base + to_ext(12))
        rebuilt = encoder.rebuild_ec_files(
            base, codec=RSCodec(device="cpu")
        )
        assert rebuilt == [12]
        text = default_registry().render()
        assert "SeaweedFS_volume_ec_decode_seconds_sum" in text
        decode_sum = [
            line for line in text.splitlines()
            if line.startswith("SeaweedFS_volume_ec_decode_seconds_sum")
            and 'kernel="rebuild"' in line
        ]
        assert decode_sum and float(decode_sum[0].rsplit(" ", 1)[1]) > 0

    def test_hash_service_feeds_histogram(self):
        from seaweedfs_tpu_torch.ops.hash_service import HashService

        svc = HashService(device="cpu")
        res = svc.hash_spans(b"abcdef" * 100, [300, 600])
        assert len(res) == 2
        text = default_registry().render()
        assert "SeaweedFS_filer_hash_seconds_sum" in text
        assert "SeaweedFS_filer_hash_bytes_total" in text

    def test_kernel_gbps_scrape(self):
        """bench.kernel_gbps_from_metrics computes per-kernel GB/s from
        exposition text alone."""
        import bench

        text = "\n".join([
            'SeaweedFS_volume_ec_encode_seconds_sum{kernel="fused"} 0.5',
            'SeaweedFS_volume_ec_encode_seconds_count{kernel="fused"} 2',
            'SeaweedFS_volume_ec_encode_bytes_total{kernel="fused"} 1e+09',
        ])
        out = bench.kernel_gbps_from_metrics(text)
        assert out == {
            "volume_ec_encode:fused": {"gbps": 2.0, "seconds": 0.5, "gb": 1.0}
        }


class TestPushErrorCounter:
    def test_push_failure_counted_and_logged(self, tmp_path, monkeypatch):
        from seaweedfs_tpu_torch.stats.metrics import start_push_loop
        from seaweedfs_tpu_torch.util import glog

        log = tmp_path / "push.log"
        monkeypatch.setattr(glog, "_log_file", str(log))
        stop = threading.Event()
        start_push_loop(
            "http://127.0.0.1:1", "pushtestrole", "i", interval_sec=0.02,
            stop_event=stop,
        )
        try:
            deadline = time.time() + 5
            while time.time() < deadline:
                text = default_registry().render()
                lines = [
                    line for line in text.splitlines()
                    if line.startswith("SeaweedFS_stats_push_errors_total")
                    and 'role="pushtestrole"' in line
                ]
                if lines and float(lines[0].rsplit(" ", 1)[1]) >= 1:
                    break
                time.sleep(0.02)
            else:
                raise AssertionError("push error counter never incremented")
        finally:
            stop.set()
        assert "metrics push" in log.read_text()


@pytest.fixture(scope="class")
def traced_cluster(tmp_path_factory):
    """master + volume + filer + s3, fastlane disabled so every hop runs
    the (traced) Python path."""
    from seaweedfs_tpu_torch.s3api import S3Client, S3Server
    from seaweedfs_tpu_torch.server.filer import FilerServer
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume import VolumeServer

    prev = os.environ.get("SEAWEEDFS_TPU_DISABLE_FASTLANE")
    os.environ["SEAWEEDFS_TPU_DISABLE_FASTLANE"] = "1"
    tmp = tmp_path_factory.mktemp("tracestack")
    config = {
        "identities": [{
            "name": "admin",
            "credentials": [
                {"accessKey": "traceKey", "secretKey": "traceSecret"}
            ],
            "actions": ["Admin"],
        }]
    }
    master = MasterServer(port=0, pulse_seconds=1)
    master.start()
    vol = VolumeServer(
        [str(tmp / "v0")], master.url, port=0, pulse_seconds=1,
        max_volume_count=10, device="cpu"
    )
    vol.start()
    filer = FilerServer(master.url, port=0, chunk_size_mb=1, device="cpu")
    filer.start()
    s3 = S3Server(filer.url, port=0, config=config)
    s3.start()
    client = S3Client(s3.url, "traceKey", "traceSecret")
    yield s3, client
    s3.stop()
    filer.stop()
    vol.stop()
    master.stop()
    if prev is None:
        os.environ.pop("SEAWEEDFS_TPU_DISABLE_FASTLANE", None)
    else:
        os.environ["SEAWEEDFS_TPU_DISABLE_FASTLANE"] = prev


class TestEndToEnd:
    def test_s3_put_spans_three_roles(self, traced_cluster):
        from seaweedfs_tpu_torch.server.httpd import get_json

        s3, client = traced_cluster
        client.create_bucket("tracebucket")
        etag = client.put_object(
            "tracebucket", "hello.bin", os.urandom(8192)
        )
        assert etag
        out = get_json(s3.service.url + "/debug/traces?limit=100")
        put_traces = [
            t for t in out["traces"]
            if any(
                s["role"] == "s3" and s["name"].startswith("PUT")
                and "hello.bin" in s["name"]
                for s in t["spans"]
            )
        ]
        assert put_traces, "no trace recorded for the S3 PUT"
        roles = set(put_traces[0]["roles"])
        assert {"s3", "filer", "volume"} <= roles, roles

    def test_cluster_trace_shell_verb(self, traced_cluster):
        from seaweedfs_tpu_torch.shell import CommandEnv, run_command

        s3, client = traced_cluster
        client.put_object("tracebucket", "shell.bin", b"y" * 512)
        # any traced endpoint works — the ring is process-wide; point the
        # shell at the s3 service as its "master" endpoint
        env = CommandEnv(s3.service.url)
        out = run_command(env, "cluster.trace -limit 5")
        assert "merged traces" in out
        assert "trace " in out
        assert "[s3]" in out or "[filer]" in out or "[volume]" in out


@pytest.fixture(autouse=True, scope="module")
def _stop_port_history_loop():
    """The port's metered servers start the process's history loop; stop it
    when this module is done, so no thread of this file outlives it."""
    yield
    from seaweedfs_tpu_torch.stats import history

    history.default_history().stop()
