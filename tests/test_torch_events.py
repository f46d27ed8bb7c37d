"""Cluster flight recorder (stats/events.py) + trace exemplars + SLO
burn-rate alerting of the port: the JAX package's tests/test_events.py over
seaweedfs_tpu_torch, less its qos-shed case (in tests/test_torch_qos.py) and
its fastlane-lease case (the native fastlane is not ported).

Covers: the closed typed-event registry and its bounded ring, the
disabled-path overhead guard (one attribute check, like the faults
registry's disarmed bar), /debug/events filters and 400s on every role,
`/debug/traces?id=` exact lookup (in-flight + finished), histogram
exemplars riding /debug/metrics/history into cluster.top's p99-trace
column, the repair-task lifecycle events (queued -> dispatched ->
done/failed/backoff), the SLO fast/slow burn rules firing and clearing
on synthetic series with alert_raised/alert_cleared journaled, the
pipelined-rebuild chain tracing as ONE cross-node trace, and the
acceptance path: a fault-degraded read whose full causal chain
`cluster.why <trace-id>` reconstructs across a 3-role cluster.
"""

import os
import time

import pytest

from seaweedfs_tpu_torch.server.httpd import get_json, http_request, post_json
from seaweedfs_tpu_torch.shell import CommandEnv, run_command
from seaweedfs_tpu_torch.shell.env import ShellError
from seaweedfs_tpu_torch.stats import alerts as alerts_mod
from seaweedfs_tpu_torch.stats import events
from seaweedfs_tpu_torch.stats import history as history_mod
from seaweedfs_tpu_torch.stats import trace
from seaweedfs_tpu_torch.stats.history import MetricsHistory
from seaweedfs_tpu_torch.stats.metrics import Registry
from seaweedfs_tpu_torch.util import faults

BLOCK = 4096  # small uniform online-EC stripe keeps the suite quick


class TestEventRegistry:
    def test_closed_registry_rejects_unknown_type(self):
        rec = events.EventRecorder(capacity=8)
        rec.enable()
        with pytest.raises(ValueError, match="undeclared event type"):
            rec.record("not_a_real_event")
        # ...and the module emit() path enforces the same closure
        events.recorder().enable()
        with pytest.raises(ValueError, match="undeclared event type"):
            events.emit("also_not_real")

    def test_types_are_snake_case_with_descriptions(self):
        import re

        for name, desc in events.EVENT_TYPES.items():
            assert re.fullmatch(r"[a-z][a-z0-9]*(_[a-z0-9]+)*", name), name
            assert desc.strip(), name

    def test_disabled_recorder_records_nothing(self):
        rec = events.EventRecorder(capacity=8)
        assert not rec.enabled

        def emit_like(type_, **kw):
            if not rec.enabled:
                return None
            return rec.record(type_, **kw)

        assert emit_like("degraded_read", volume=1) is None
        assert rec.recorded_total == 0 and len(rec._ring) == 0

    def test_ring_bounds_count_drops(self):
        rec = events.EventRecorder(capacity=4)
        rec.enable()
        for i in range(10):
            rec.record("volume_state", volume=i, state="mounted")
        assert len(rec._ring) == 4
        assert rec.recorded_total == 10
        assert rec.dropped_total == 6
        # the ring keeps the NEWEST events
        assert [e["volume"] for e in rec.events()] == [6, 7, 8, 9]

    def test_filters(self):
        rec = events.EventRecorder(capacity=64)
        rec.enable()
        t0 = time.time()
        rec.record("degraded_read", volume=3, reason="dat_read")
        rec.record("degraded_read", volume=4, reason="dat_read",
                   trace_id="abcd")
        rec.record("task_queued", volume=3, task="vacuum:3", type="vacuum")
        assert [e["volume"] for e in rec.events(type="degraded_read")] \
            == [3, 4]
        assert [e["type"] for e in rec.events(volume=3)] \
            == ["degraded_read", "task_queued"]
        assert [e["volume"] for e in rec.events(trace="abcd")] == [4]
        assert rec.events(since=t0 + 3600) == []
        assert len(rec.events(limit=2)) == 2
        # limit keeps the newest
        assert rec.events(limit=1)[0]["type"] == "task_queued"

    def test_trace_id_autocaptured_from_active_span(self):
        rec = events.EventRecorder(capacity=8)
        rec.enable()
        with trace.span("req") as sp:
            ev = rec.record("fault_injected", point="p", mode="error")
        assert ev.trace_id == sp.trace_id
        # outside a span: no trace id, not an error
        ev2 = rec.record("fault_injected", point="p", mode="error")
        assert ev2.trace_id is None

    def test_event_dict_carries_correlation_keys(self):
        rec = events.EventRecorder(capacity=8)
        rec.enable()
        ev = rec.record("task_done", volume=7, node="n1",
                        task="ec_rebuild:7", state="completed",
                        duration_ms=12.5).to_dict()
        assert ev["volume"] == 7 and ev["node"] == "n1"
        assert ev["task"] == "ec_rebuild:7"
        assert ev["attrs"]["state"] == "completed"
        assert ev["ts"] > 0 and ev["mono"] > 0 and ev["seq"] >= 1


class TestTenantHeatEvents:
    def test_new_types_record_and_collection_filter(self):
        """event types (tenant_overflow, heat_promoted,
        heat_demoted) journal through the closed registry, and the
        recorder's collection filter keys `cluster.why <collection>`."""
        rec = events.EventRecorder(capacity=16)
        rec.enable()
        rec.record("tenant_overflow", collection="acme", k=64)
        rec.record("heat_promoted", volume=7, node="n1:8080", score=12.5)
        rec.record("heat_demoted", volume=7, node="n1:8080", score=1.5)
        rec.record("degraded_read", volume=3, reason="dat_read",
                   collection="acme")
        mine = rec.events(collection="acme")
        assert [e["type"] for e in mine] \
            == ["tenant_overflow", "degraded_read"]
        assert mine[0]["attrs"]["k"] == 64
        # heat edges carry volume + node correlation keys
        hot = rec.events(type="heat_promoted")
        assert hot[0]["volume"] == 7 and hot[0]["node"] == "n1:8080"
        assert rec.events(type="heat_demoted")[0]["attrs"]["score"] == 1.5
        # the filter is exact: no collection attr -> excluded
        assert rec.events(collection="other") == []

class TestDisabledOverhead:
    def test_disabled_emit_is_one_attribute_check(self, monkeypatch):
        """The acceptance bar (the faults registry's disarmed guard,
        applied to the journal): with the recorder off, emit() allocates
        nothing and adds no measurable cost to a hot loop."""
        import tracemalloc

        monkeypatch.setattr(events, "_recorder", events.EventRecorder())
        emit = events.emit
        for _ in range(10000):  # prewarm
            emit("degraded_read")
        tracemalloc.start()
        before = tracemalloc.take_snapshot()
        for _ in range(50000):
            emit("degraded_read")
        after = tracemalloc.take_snapshot()
        tracemalloc.stop()
        grew = sum(
            s.size_diff for s in after.compare_to(before, "filename")
            if s.size_diff > 0
        )
        assert grew < 16 * 1024, f"disabled emit allocated {grew} bytes"

        def best_of_3(fn, n=200_000):
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(n):
                    fn("degraded_read")
                best = min(best, time.perf_counter() - t0)
            return best

        t = best_of_3(emit)
        # generous absolute guard (microVM): 200k disabled emits well
        # under a second means ~<5us/call worst case — no real overhead
        assert t < 1.0, f"200k disabled emits took {t:.3f}s"


class TestTaskLifecycleEvents:
    def test_scheduler_queued_dispatched_backoff(self):
        from seaweedfs_tpu_torch.maintenance.detectors import RepairTask
        from seaweedfs_tpu_torch.maintenance.scheduler import (
            RepairScheduler,
            task_key_str,
        )

        events.recorder().enable()
        rec = events.recorder()
        t0 = time.time() - 0.001
        sched = RepairScheduler()
        task = RepairTask(type="ec_rebuild", volume_id=42, node="n1")
        assert task_key_str(task) == "ec_rebuild:42"
        assert sched.offer(task, now=100.0)
        assert not sched.offer(task, now=100.0)  # dedup: no second event
        got = sched.next_task(now=100.0)
        assert got is task
        sched.complete(task, ok=False, now=100.0)
        mine = [e for e in rec.events(volume=42, since=t0)
                if e.get("task") == "ec_rebuild:42"]
        assert [e["type"] for e in mine] \
            == ["task_queued", "task_dispatched", "task_backoff"]
        assert mine[-1]["attrs"]["retry_in"] > 0

    def test_daemon_done_and_failed(self, monkeypatch):
        import types

        from seaweedfs_tpu_torch.maintenance import daemon as daemon_mod
        from seaweedfs_tpu_torch.maintenance.detectors import RepairTask

        events.recorder().enable()
        rec = events.recorder()
        master = types.SimpleNamespace(url="http://127.0.0.1:1")
        d = daemon_mod.MaintenanceDaemon(master, interval=1.0, dry_run=True)
        t0 = time.time() - 0.001
        task = RepairTask(type="vacuum", volume_id=77)
        d.scheduler.offer(task, now=1.0)
        assert d.scheduler.next_task(now=1.0) is task
        monkeypatch.setattr(
            daemon_mod.executors_mod, "execute",
            lambda *a, **k: {"planned": ["p"]})
        d._run_task(task)
        done = [e for e in rec.events(volume=77, since=t0)
                if e["type"] == "task_done"]
        assert done and done[-1]["attrs"]["state"] == "planned"

        task2 = RepairTask(type="vacuum", volume_id=78)
        d.scheduler.offer(task2, now=2.0)
        assert d.scheduler.next_task(now=2.0) is task2
        monkeypatch.setattr(
            daemon_mod.executors_mod, "execute",
            lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
        d._run_task(task2)
        failed = [e for e in rec.events(volume=78, since=t0)
                  if e["type"] == "task_failed"]
        assert failed and "boom" in failed[-1]["attrs"]["error"]
        # the scheduler's backoff event rode along
        assert [e for e in rec.events(volume=78, since=t0)
                if e["type"] == "task_backoff"]


def _availability_burst(reg, hist, role="volume"):
    c = reg.counter("SeaweedFS_http_request_total", "",
                    ("role", "method", "code"))
    c.labels(role, "GET", "200").inc(1000)
    hist.scrape_once(now=5.0)
    c.labels(role, "GET", "200").inc(50)
    c.labels(role, "GET", "500").inc(50)
    hist.scrape_once(now=15.0)
    return c


class TestSloBurn:
    def test_availability_burn_math(self):
        reg = Registry()
        hist = MetricsHistory(reg, interval=1.0, slots=200)
        _availability_burst(reg, hist)
        slo = next(s for s in alerts_mod.DEFAULT_SLOS
                   if s.name == "volume_availability")
        burn = alerts_mod.slo_burn(hist, slo, 60.0, 15.0)
        # 50% error share / 0.1% budget = 500x
        assert burn == pytest.approx(500.0, rel=0.01)
        # no traffic -> None (not 0.0): absence of data is not health
        assert alerts_mod.slo_burn(
            hist, next(s for s in alerts_mod.DEFAULT_SLOS
                       if s.name == "s3_availability"), 60.0, 15.0) is None

    def test_latency_burn_math(self):
        reg = Registry()
        h = reg.histogram("SeaweedFS_http_request_seconds", "",
                          ("role", "method"))
        hist = MetricsHistory(reg, interval=1.0, slots=200)
        for _ in range(90):
            h.labels("volume", "GET").observe(0.01)
        for _ in range(10):
            h.labels("volume", "GET").observe(0.9)
        hist.scrape_once(now=5.0)
        for _ in range(90):
            h.labels("volume", "GET").observe(0.01)
        for _ in range(10):
            h.labels("volume", "GET").observe(0.9)
        hist.scrape_once(now=15.0)
        slo = next(s for s in alerts_mod.DEFAULT_SLOS
                   if s.name == "volume_read_p99")
        # 10% of requests over the 250ms bound / 1% allowance = 10x
        burn = alerts_mod.slo_burn(hist, slo, 60.0, 15.0)
        assert burn == pytest.approx(10.0, rel=0.05)

    def test_low_traffic_latency_reads_none_not_burn(self):
        # two cold-start requests, one slow: that one request IS the
        # p99 and would read as a 100x burn — which the QoS actuator
        # would answer by shedding every write on an idle cluster. The
        # min-rate guard makes it None (can't judge), not a page.
        reg = Registry()
        h = reg.histogram("SeaweedFS_http_request_seconds", "",
                          ("role", "method"))
        hist = MetricsHistory(reg, interval=1.0, slots=200)
        h.labels("filer", "GET").observe(0.01)
        hist.scrape_once(now=0.0)
        h.labels("filer", "GET").observe(2.0)
        hist.scrape_once(now=30.0)
        slo = next(s for s in alerts_mod.DEFAULT_SLOS
                   if s.name == "filer_p99")
        assert alerts_mod.slo_burn(hist, slo, 60.0, 30.0) is None
        # with the guard lifted the same traffic reads as a huge burn —
        # the rate floor is what stands between cold start and level 3
        assert alerts_mod.slo_burn(
            hist, slo, 60.0, 30.0, min_rate=0.0) > 14.0

    def test_fast_burn_fires_then_clears_with_events(self):
        events.recorder().enable()
        rec = events.recorder()
        t0 = time.time() - 0.001
        reg = Registry()
        hist = MetricsHistory(reg, interval=1.0, slots=200)
        _availability_burst(reg, hist)
        eng = alerts_mod.AlertEngine(history=hist, registry=reg)
        try:
            snap = eng.evaluate(now=15.0)
            assert "slo_burn_fast" in snap
            assert snap["slo_burn_fast"]["severity"] == "critical"
            assert "volume_availability" in snap["slo_burn_fast"]["detail"]
            # the burn gauge exports for the history ring to self-scrape
            text = reg.render()
            assert 'SeaweedFS_slo_burn_rate{slo="volume_availability"' \
                   ',window="fast"}' in text
            # slo_status carries both windows for /debug/alerts
            ss = eng.slo_status()
            assert ss["volume_availability"]["burn_fast"] > 100
            # the burst ages out of the fast window -> clears
            hist.scrape_once(now=100.0)
            snap = eng.evaluate(now=100.0)
            assert "slo_burn_fast" not in snap
            raised = [e for e in rec.events(type="alert_raised", since=t0)
                      if e["attrs"].get("alert") == "slo_burn_fast"]
            cleared = [e for e in rec.events(type="alert_cleared", since=t0)
                       if e["attrs"].get("alert") == "slo_burn_fast"]
            assert raised and cleared
        finally:
            eng.close()

    def test_slow_burn_gated_on_fast_still_burning(self):
        """A long-resolved incident must not warn forever: the slow rule
        requires the fast window to still show burn >= 1."""
        reg = Registry()
        hist = MetricsHistory(reg, interval=1.0, slots=500)
        c = reg.counter("SeaweedFS_http_request_total", "",
                        ("role", "method", "code"))
        c.labels("volume", "GET", "200").inc(1000)
        hist.scrape_once(now=5.0)
        c.labels("volume", "GET", "500").inc(100)
        hist.scrape_once(now=15.0)
        eng = alerts_mod.AlertEngine(history=hist, registry=reg)
        try:
            snap = eng.evaluate(now=15.0)
            assert "slo_burn_slow" in snap  # burning in both windows
            # 200s later: errors linger in the slow window but the fast
            # window is clean -> the gate clears the warning
            c.labels("volume", "GET", "200").inc(10)
            hist.scrape_once(now=210.0)
            snap = eng.evaluate(now=210.0)
            assert "slo_burn_slow" not in snap
        finally:
            eng.close()

    def test_slo_params_configurable(self):
        reg = Registry()
        hist = MetricsHistory(reg, interval=1.0, slots=200)
        eng = alerts_mod.AlertEngine(history=hist, registry=reg)
        try:
            eng.configure(slo_fast_window=10.0, slo_fast_burn=2.0,
                          slos=(alerts_mod.Slo(
                              "tight", "volume", "availability", 0.9),))
            _availability_burst(reg, hist)
            snap = eng.evaluate(now=15.0)
            assert "tight" in snap["slo_burn_fast"]["detail"]
            with pytest.raises(ValueError):
                eng.configure(not_a_param=1)
        finally:
            eng.close()


class TestExemplarsUnit:
    def test_histogram_records_freshest_trace_per_bucket(self):
        reg = Registry()
        h = reg.histogram("SeaweedFS_http_request_seconds", "",
                          ("role", "method"), exemplars=True)
        with trace.span("r1") as s1:
            h.labels("volume", "GET").observe(0.07)
        with trace.span("r2") as s2:
            h.labels("volume", "GET").observe(0.08)  # same bucket: newest wins
        with trace.span("r3") as s3:
            h.labels("volume", "GET").observe(3.0)
        ex = reg.exemplars()["SeaweedFS_http_request_seconds"]
        by_le = {e["le"]: e for e in ex}
        assert by_le[0.1]["trace_id"] == s2.trace_id
        assert by_le[5.0]["trace_id"] == s3.trace_id
        assert s1.trace_id not in {e["trace_id"] for e in ex}

    def test_no_trace_no_exemplar_and_opt_in_only(self):
        reg = Registry()
        h = reg.histogram("SeaweedFS_http_request_seconds", "",
                          ("role", "method"), exemplars=True)
        h.labels("volume", "GET").observe(0.01)  # no active span
        assert reg.exemplars() == {}
        h2 = reg.histogram("SeaweedFS_volume_ec_encode_seconds", "",
                           ("kernel",))
        with trace.span("k"):
            h2.labels("fused").observe(0.5)
        assert not h2.exemplars_enabled
        assert reg.exemplars() == {}  # data-plane kernels never pay


@pytest.fixture(scope="class")
def flight_cluster(tmp_path_factory):
    """master (online-EC policy for the 'hot' collection) + two volume
    servers + filer in one process — the 3-role cluster the cross-node
    cluster.why assembly is asserted on."""
    from seaweedfs_tpu_torch.server.filer import FilerServer
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume import VolumeServer

    tmp = tmp_path_factory.mktemp("flightstack")
    faults.enable()
    faults.disarm_all()
    master = MasterServer(port=0, pulse_seconds=1, volume_size_limit_mb=64,
                          maintenance_interval=0.25,
                          ec_online="hot", ec_online_block=BLOCK)
    master.start()
    vols = []
    for i in range(2):
        vs = VolumeServer([str(tmp / f"v{i}")], master.url, port=0,
                          rack=f"r{i}", pulse_seconds=1,
                          max_volume_count=30, device="cpu")
        vs.start()
        vols.append(vs)
    filer = FilerServer(master.url, port=0, chunk_size_mb=1, device="cpu")
    filer.start()
    env = CommandEnv(master.url)
    yield {"master": master, "vols": vols, "filer": filer, "env": env}
    faults.disarm_all()
    filer.stop()
    for vs in vols:
        vs.stop()
    master.stop()


def _degraded_hot_read(cluster):
    """Write to the online-EC collection, arm a one-shot .dat fault, read
    through it -> a degraded (reconstructed) 200 whose trace id we
    return along with the volume id."""
    master, vols = cluster["master"], cluster["vols"]
    a = get_json(f"{master.url}/dir/assign?collection=hot")
    vid = int(a["fid"].split(",")[0])
    url = f"http://{a['publicUrl']}/{a['fid']}"
    payload = os.urandom(BLOCK * 10 * 2)
    st, _, _ = http_request("POST", url, payload)
    assert st == 201
    hv = next(vs for vs in vols if vs.store.get_volume(vid) is not None)
    hv.store.get_volume(vid).online_ec.pump(force=True)
    faults.arm("volume.read.dat", "error", count=1)
    st, hdrs, body = http_request("GET", url + "?why=1")
    faults.disarm_all()
    assert st == 200 and body == payload
    return hdrs["X-Sw-Trace-Id"], vid


class TestDebugEventsRoute:
    def test_served_on_every_role_with_filters(self, flight_cluster):
        master = flight_cluster["master"]
        vols = flight_cluster["vols"]
        tid, vid = _degraded_hot_read(flight_cluster)
        urls = [master.url] + [vs.service.url for vs in vols]
        for url in urls:
            out = get_json(f"{url}/debug/events?type=degraded_read")
            assert out["enabled"] and out["proc"]
            assert any(e["volume"] == vid for e in out["events"])
        # trace + volume + since filters
        out = get_json(f"{master.url}/debug/events?trace={tid}")
        types = [e["type"] for e in out["events"]]
        assert "fault_injected" in types and "degraded_read" in types
        out = get_json(f"{master.url}/debug/events?volume={vid}")
        assert all(e["volume"] == vid for e in out["events"])
        far = time.time() + 3600
        out = get_json(f"{master.url}/debug/events?since={far}")
        assert out["events"] == []

    def test_malformed_params_return_400(self, flight_cluster):
        url = flight_cluster["master"].url
        for path in (
            "/debug/events?limit=abc",
            "/debug/events?volume=banana",
            "/debug/events?since=nan",
            "/debug/events?type=not_a_type",
        ):
            status, _, body = http_request("GET", url + path)
            assert status == 400, path
            assert b"error" in body, path


class TestTraceIdLookup:
    def test_exact_lookup_and_400(self, flight_cluster):
        master = flight_cluster["master"]
        tid, _ = _degraded_hot_read(flight_cluster)
        out = get_json(f"{master.url}/debug/traces?id={tid}")
        assert out["found"] and out["trace_id"] == tid
        assert any(s["name"].startswith("GET /") for s in out["spans"])
        # well-formed but unknown: empty, not an error
        out = get_json(f"{master.url}/debug/traces?id=deadbeef00112233")
        assert not out["found"] and out["spans"] == []
        for bad in ("XYZ", "12345678-abc", "A" * 40):
            status, _, body = http_request(
                "GET", f"{master.url}/debug/traces?id={bad}")
            assert status == 400, bad
            assert b"malformed" in body

    def test_inflight_spans_resolve(self, flight_cluster):
        col = trace.collector()
        sp = col.start_span("long.op", role="volume", activate=False)
        try:
            out = get_json(
                f"{flight_cluster['master'].url}/debug/traces"
                f"?id={sp.trace_id}")
            assert out["found"]
            assert any(s["status"] == "in_flight" for s in out["spans"])
        finally:
            col.finish_span(sp)


class TestClusterWhy:
    def test_trace_chain_request_fault_degraded(self, flight_cluster):
        """The acceptance chain, trace-keyed: request span ->
        fault_injected -> degraded_read, all under one trace id, plus
        the volume's related context — assembled across the cluster."""
        env = flight_cluster["env"]
        tid, vid = _degraded_hot_read(flight_cluster)
        out = run_command(env, f"cluster.why {tid}")
        lines = out.splitlines()
        assert f"cluster.why trace {tid}" in lines[0]
        assert f"volumes [{vid}]" in lines[0]
        # causal order: the span opens, the fault fires, the read degrades
        i_span = next(i for i, ln in enumerate(lines) if "span " in ln
                      and "GET /" in ln)
        i_fault = next(i for i, ln in enumerate(lines)
                       if "fault_injected" in ln)
        i_deg = next(i for i, ln in enumerate(lines)
                     if "degraded_read" in ln)
        assert i_span < i_fault < i_deg
        assert "volume.read.dat" in lines[i_fault]
        assert f"volume={vid}" in lines[i_deg]

    def test_volume_timeline_includes_lifecycle(self, flight_cluster):
        env = flight_cluster["env"]
        tid, vid = _degraded_hot_read(flight_cluster)
        out = run_command(env, f"cluster.why {vid}")
        assert f"cluster.why volume {vid}" in out
        assert "degraded_read" in out
        assert "state=created" in out  # volume_state lifecycle event
        assert tid in out  # the degraded request's trace joined the story

    def test_heal_chain_task_events(self, flight_cluster):
        """Degraded reads trip the degraded_reads alert, which scans
        ec_rebuild/fix_replication — the journal ties alert edge and
        task lifecycle to the volume so cluster.why shows the heal."""
        master = flight_cluster["master"]
        env = flight_cluster["env"]
        rec = events.recorder()
        # a quiet alert state first: degraded reads of an earlier test in
        # this process may hold the rule firing, and then no edge is raised
        history_mod.default_history().clear()
        alerts_mod.engine().evaluate()
        t0 = time.time()
        post_json(f"{master.url}/maintenance/enable")
        try:
            # sustained degraded reads (rate rule: > 0.5/s over 60s)
            alerts_mod.engine().configure(degraded_read_rate=0.01)
            hist = history_mod.default_history()
            # baseline scrape FIRST: a brand-new counter series only
            # zero-seeds (and thus rates from its first sample) when a
            # previous scrape exists — in a live system the 5s loop
            # guarantees one, in a fresh test process it may not have
            # ticked yet
            hist.scrape_once()
            tid = vid = None
            for _ in range(3):
                tid, vid = _degraded_hot_read(flight_cluster)
            hist.scrape_once()
            time.sleep(0.3)
            hist.scrape_once()  # listener evaluates -> alert fires
            deadline = time.time() + 15
            while time.time() < deadline:
                if [e for e in rec.events(type="alert_raised", since=t0)
                        if e["attrs"].get("alert") == "degraded_reads"]:
                    break
                hist.scrape_once()
                time.sleep(0.3)
            raised = [e for e in rec.events(type="alert_raised", since=t0)
                      if e["attrs"].get("alert") == "degraded_reads"]
            assert raised, rec.events(since=t0)
            # the rising edge triggered an immediate repair scan; its
            # queued/done lifecycle is journaled (nothing may need
            # healing — parity is intact — but the scan itself ran)
            out = run_command(env, f"cluster.why {vid}")
            assert "degraded_read" in out
        finally:
            alerts_mod.engine().configure(
                degraded_read_rate=alerts_mod.DEFAULT_PARAMS[
                    "degraded_read_rate"])
            post_json(f"{master.url}/maintenance/disable")
            history_mod.default_history().clear()

    def test_usage_errors(self, flight_cluster):
        env = flight_cluster["env"]
        with pytest.raises(ShellError, match="usage"):
            run_command(env, "cluster.why")
        # non-hex, non-numeric targets are collection names now ()
        with pytest.raises(ShellError, match="no events found"):
            run_command(env, "cluster.why ZZZ-not-a-collection")
        with pytest.raises(ShellError, match="no spans or events"):
            run_command(env, "cluster.why 00000000deadbeef")


class TestExemplarsEndToEnd:
    def test_history_route_carries_exemplars(self, flight_cluster):
        master = flight_cluster["master"]
        for _ in range(5):
            get_json(f"{master.url}/dir/status")
        out = get_json(
            f"{master.url}/debug/metrics/history"
            "?family=SeaweedFS_http_request_seconds&window=600&samples=0")
        ex = out["exemplars"].get("SeaweedFS_http_request_seconds")
        assert ex, out["exemplars"]
        # the registry (and its exemplars) outlives the bounded trace
        # ring: an old bucket's exemplar may point at an evicted trace.
        # The FRESHEST exemplar is from the requests just made above —
        # that one's trace must resolve via the point lookup.
        sample = max(ex, key=lambda s: s["ts"])
        assert sample["trace_id"] and sample["labels"]["role"]
        looked = get_json(
            f"{master.url}/debug/traces?id={sample['trace_id']}")
        assert looked["found"]

    def test_cluster_top_renders_p99_trace_and_slo(self, flight_cluster):
        env = flight_cluster["env"]
        hist = history_mod.default_history()
        hist.scrape_once()
        for _ in range(15):
            get_json(f"{flight_cluster['master'].url}/dir/status")
        time.sleep(0.25)
        hist.scrape_once()
        out = run_command(env, "cluster.top -once -window 600")
        # column header sits under the title (and under the cluster-rollup
        # line when the master's telemetry aggregate is live)
        assert any("p99-trace" in ln for ln in out.splitlines()[:3])
        master_row = next(ln for ln in out.splitlines()
                          if ln.startswith("master"))
        tid = master_row.split()[-1]
        assert tid != "-" and len(tid) == 16, master_row
        # SLO burn block renders (availability slos have traffic now)
        assert "slo error-budget burn" in out
        assert "master_availability" in out


class TestPipelinedChainTrace:
    def test_rebuild_chain_is_one_trace(self, tmp_path):
        """Satellite: the /admin/ec/partial chain carries the rebuild's
        X-Sw-Trace-Id, so the whole repair — start, every hop, commit —
        renders as ONE trace instead of only the root span."""
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume import VolumeServer
        from seaweedfs_tpu_torch.shell.commands_ec import run_rebuild

        master = MasterServer(port=0, pulse_seconds=1,
                              volume_size_limit_mb=64)
        master.start()
        vols = []
        try:
            for i in range(3):
                vs = VolumeServer([str(tmp_path / f"v{i}")], master.url,
                                  port=0, rack=f"r{i}", pulse_seconds=1,
                                  max_volume_count=30, device="cpu")
                vs.start()
                vols.append(vs)
            env = CommandEnv(master.url)
            a = get_json(f"{master.url}/dir/assign")
            vid = int(a["fid"].split(",")[0])
            st, _, _ = http_request(
                "POST", f"http://{a['publicUrl']}/{a['fid']}",
                os.urandom(30000))
            assert st == 201
            run_command(env, "lock")
            run_command(env, f"ec.encode -volumeId {vid}")
            run_command(env, "unlock")
            sv = next(s for s in env.servers()
                      if 0 in s.ec_shards.get(vid, []))
            post_json(f"{sv.http}/admin/ec/delete_shards",
                      {"volume": vid, "shards": [0]})
            out = run_rebuild(env, vid, mode="pipelined")
            assert out["mode"] == "pipelined"
            col = trace.collector()
            root = next(
                s for t in col.traces(limit=200) for s in t["spans"]
                if s["name"] == "ec.rebuild"
                and s["attrs"].get("volume") == vid
            )
            spans = col.trace_spans(root["trace_id"])
            names = [s["name"] for s in spans]
            # a multi-chunk repair streams (hop-annotated stream/open
            # cascade spans); a single-chunk one runs the serial chain
            # (one hop-annotated /admin/ec/partial span per hop)
            hops = [s for s in spans
                    if s["name"] in ("POST /admin/ec/partial",
                                     "POST /admin/ec/partial/stream/open")]
            assert "POST /admin/ec/partial/start" in names
            assert "POST /admin/ec/partial/commit" in names
            # every chain hop joined the SAME trace, hop-annotated —
            # with 3 holders the chain spans at least 2 distinct nodes
            assert len(hops) >= 2, names
            hop_ids = {h["attrs"].get("hop") for h in hops}
            assert all(hop_ids) and len(hop_ids) >= 2, hops
        finally:
            for vs in vols:
                vs.stop()
            master.stop()


@pytest.fixture(autouse=True, scope="module")
def _stop_port_history_loop():
    """The port's metered servers start the process's history loop; stop it
    when this module is done, so no thread of this file outlives it."""
    yield
    from seaweedfs_tpu_torch.stats import history

    history.default_history().stop()
