"""Cluster telemetry plane of the port: the JAX package's
tests/test_cluster_telemetry.py over seaweedfs_tpu_torch (mergeable usage
sketches, the TelemetryAggregator's ingest contract and findings, cluster
SLO burn over the merged stream, the history `?since=` cursor, and the
one-fetch `/debug/cluster/telemetry` on a port master fed by heartbeats
and pushes), then parity cases and the roles' senders.

Parity (exact equality): `build_frame` under a frozen clock and
`TelemetryAggregator` over the same frames give equal payloads, snapshots
and exposition lines in both packages. Live: every port role ships frames
to a port master (volume heartbeats, the filer's registration beat, S3's
and WebDAV's pushers), and a port pusher reaches a master that listens
with mutual TLS, where the JAX pusher, which posts through plain urllib,
cannot.
"""

import random
import time

import pytest

from seaweedfs_tpu_torch.server.httpd import get_json, http_request, post_json
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.shell import CommandEnv, ShellError, run_command
from seaweedfs_tpu_torch.stats import aggregate as agg_mod
from seaweedfs_tpu_torch.stats import alerts as alerts_mod
from seaweedfs_tpu_torch.stats import history as history_mod
from seaweedfs_tpu_torch.stats import usage as usage_mod
from seaweedfs_tpu_torch.stats.history import MetricsHistory
from seaweedfs_tpu_torch.stats.metrics import Registry
from seaweedfs_tpu_torch.stats.usage import SpaceSaving


def exact_counts(stream):
    true: dict[str, float] = {}
    for key, inc in stream:
        true[key] = true.get(key, 0.0) + inc
    return true


def assert_covers(sk: SpaceSaving, true: dict) -> None:
    """The merge contract: tracked keys keep count-err <= true <= count
    with err <= the exported bound; untracked keys are covered by the
    bound alone."""
    for key, count, err in sk.top():
        t = true.get(key, 0.0)
        assert count - err <= t + 1e-9, (key, count, err, t)
        assert t <= count + 1e-9, (key, count, err, t)
        assert err <= sk.error_bound + 1e-9
    for key, t in true.items():
        if key not in sk.counts:
            assert t <= sk.error_bound + 1e-9, (key, t, sk.error_bound)


def random_stream(rng, n, keys, zipf=True):
    out = []
    for _ in range(n):
        i = min(rng.randrange(1, keys + 1),
                rng.randrange(1, keys + 1)) if zipf \
            else rng.randrange(1, keys + 1)
        out.append((f"t{i:03d}", float(rng.randrange(1, 8))))
    return out


class TestSketchMergeProperties:
    def test_merged_counts_within_composed_bound_random_streams(self):
        """Split a random stream across 2..4 observers with small k;
        after merging, every true count is bracketed per the contract."""
        for seed in (1, 7, 0xbeef, 0xc0ffee):
            rng = random.Random(seed)
            stream = random_stream(rng, 3000, keys=60)
            true = exact_counts(stream)
            for parts in (2, 3, 4):
                sketches = [SpaceSaving(8) for _ in range(parts)]
                for i, (key, inc) in enumerate(stream):
                    sketches[i % parts].offer(key, inc)
                merged = sketches[0]
                for sk in sketches[1:]:
                    merged = merged.merge(sk)
                assert_covers(merged, true)
                # the composed bound really is composed, not reset
                assert merged.error_bound >= max(
                    sk.error_bound for sk in sketches)

    def test_merge_is_exactly_commutative(self):
        rng = random.Random(42)
        stream = random_stream(rng, 2000, keys=50)
        a, b = SpaceSaving(8), SpaceSaving(12)
        for i, (key, inc) in enumerate(stream):
            (a if i % 3 else b).offer(key, inc)
        ab, ba = a.merge(b), b.merge(a)
        assert ab.counts == ba.counts
        assert ab.errs == ba.errs
        assert ab.other == ba.other
        assert ab.error_bound == ba.error_bound
        assert ab.evictions == ba.evictions

    def test_merge_associative_up_to_composed_bound(self):
        """(a+b)+c and a+(b+c) may disagree per key, but never by more
        than the two results' composed bounds — and both still cover the
        exact counts."""
        rng = random.Random(1234)
        stream = random_stream(rng, 3000, keys=40)
        true = exact_counts(stream)
        parts = [SpaceSaving(8) for _ in range(3)]
        for i, (key, inc) in enumerate(stream):
            parts[i % 3].offer(key, inc)
        a, b, c = parts
        left = a.merge(b).merge(c)
        right = a.merge(b.merge(c))
        assert_covers(left, true)
        assert_covers(right, true)
        slack = left.error_bound + right.error_bound
        for key in left.counts.keys() & right.counts.keys():
            assert abs(left.counts[key] - right.counts[key]) <= slack + 1e-9

    def test_merge_with_empty_is_identity_on_counts(self):
        sk = SpaceSaving(4)
        for key, inc in (("a", 5.0), ("b", 3.0), ("c", 2.0)):
            sk.offer(key, inc)
        merged = sk.merge(SpaceSaving(4))
        assert merged.counts == sk.counts
        assert merged.errs == sk.errs
        assert merged.error_bound == sk.error_bound
        assert merged.other == sk.other

    def test_merge_inputs_untouched(self):
        a, b = SpaceSaving(2), SpaceSaving(2)
        for k in ("x", "y", "z"):
            a.offer(k, 2.0)
            b.offer(k, 3.0)
        before = (dict(a.counts), dict(b.counts), a.other, b.other)
        a.merge(b)
        assert before == (dict(a.counts), dict(b.counts), a.other, b.other)

    def test_wire_roundtrip(self):
        sk = SpaceSaving(3)
        for key, inc in (("a", 5.0), ("b", 3.0), ("c", 2.0), ("d", 1.0)):
            sk.offer(key, inc)
        back = SpaceSaving.from_dict(sk.to_dict())
        assert back.counts == sk.counts
        assert back.errs == sk.errs
        assert back.other == sk.other
        assert back.error_bound == sk.error_bound
        assert back.evictions == sk.evictions

    def test_from_dict_truncates_malformed_frame(self):
        # a hostile frame declaring k=2 but shipping 5 keys must not
        # grow the receiver's sketch past the declared capacity
        d = {"k": 2, "counts": {f"t{i}": float(10 - i) for i in range(5)},
             "errs": {}, "other": 0.0}
        sk = SpaceSaving.from_dict(d)
        assert len(sk.counts) == 2
        assert set(sk.counts) == {"t0", "t1"}  # largest kept


def gateway_frame(node, proc, role="s3", ts=None, seq=1, interval=1.0,
                  c2xx=None, c5xx=None, usage=None):
    """A synthetic telemetry frame, shaped like aggregate.build_frame's
    output — the injection point for multi-gateway scenarios a
    single-process test cannot produce live."""
    samples = []
    if c2xx is not None:
        samples.append(
            ["SeaweedFS_http_request_total", {"role": role, "code": "200"},
             c2xx])
    if c5xx is not None:
        samples.append(
            ["SeaweedFS_http_request_total", {"role": role, "code": "500"},
             c5xx])
    return {
        "v": 1, "node": node, "role": role, "proc": proc,
        "ts": time.time() if ts is None else ts, "seq": seq,
        "interval": interval, "usage": usage or {}, "samples": samples,
        "alerts": [], "slos": {},
    }


def split_tenant_sketches():
    """Two gateways, each seeing `abuser` BELOW its local top ranks
    (rank 4 of 4 observed; sketches have headroom, as in production
    where k far exceeds the hot-tenant count), whose summed traffic
    makes it the #1 cluster tenant.
    Returns (usage_gw1, usage_gw2, true_abuser_total)."""
    gw1, gw2 = SpaceSaving(8), SpaceSaving(8)
    for key, inc in (("loud_a", 1000.0), ("loud_b", 900.0),
                     ("loud_c", 800.0), ("abuser", 750.0)):
        gw1.offer(key, inc)
    for key, inc in (("loud_d", 1000.0), ("loud_e", 900.0),
                     ("loud_f", 800.0), ("abuser", 750.0)):
        gw2.offer(key, inc)
    assert gw1.top()[0][0] != "abuser" and gw2.top()[0][0] != "abuser"
    u1 = {"requests": gw1.to_dict()}
    u2 = {"requests": gw2.to_dict()}
    return u1, u2, 1500.0


class TestAggregatorIngest:
    def test_malformed_frames_rejected(self):
        ag = agg_mod.TelemetryAggregator()
        assert not ag.ingest(None)
        assert not ag.ingest([1, 2])
        assert not ag.ingest({"role": "s3"})                  # no node
        assert not ag.ingest({"node": "n", "role": "s3",
                              "ts": float("nan")})            # non-finite
        assert ag.frames_total == 0
        assert ag.frames_rejected == 4

    def test_replay_rejected_restart_accepted(self):
        ag = agg_mod.TelemetryAggregator()
        t = time.time()
        assert ag.ingest(gateway_frame("gw", "p1", seq=5, ts=t), now=t)
        # same proc, stale seq: replay
        assert not ag.ingest(gateway_frame("gw", "p1", seq=5, ts=t), now=t)
        assert not ag.ingest(gateway_frame("gw", "p1", seq=4, ts=t), now=t)
        # NEW proc token (process restart): the seq clock reset with it
        assert ag.ingest(gateway_frame("gw", "p2", seq=1, ts=t), now=t)

    def test_sketches_dedup_by_proc(self):
        """A filer and an S3 gateway sharing one process ship the SAME
        accountant's sketches — the merge must count them once."""
        ag = agg_mod.TelemetryAggregator()
        t = time.time()
        usage, _, _ = split_tenant_sketches()
        ag.ingest(gateway_frame("gw:8333", "shared", role="s3",
                                usage=usage, ts=t), now=t)
        ag.ingest(gateway_frame("gw:8888", "shared", role="filer",
                                usage=usage, ts=t), now=t)
        merged = ag.merged_usage(now=t)
        assert merged["processes"] == 1
        row = next(r for r in merged["tenants"]
                   if r["collection"] == "loud_a")
        assert row["requests"] == pytest.approx(1000.0)

    def test_counter_series_dedup_by_proc_and_role(self):
        """Two endpoints of one process+role collapse to the newest
        frame; distinct roles in one process both count (their series
        are disjoint by the role filter)."""
        ag = agg_mod.TelemetryAggregator()
        t0 = time.time() - 30
        for i, t in enumerate((t0, t0 + 10)):
            ag.ingest(gateway_frame("ep1", "p1", role="s3", seq=i + 1,
                                    ts=t, c2xx=100.0 + i * 100), now=t)
            ag.ingest(gateway_frame("ep2", "p1", role="s3", seq=i + 1,
                                    ts=t, c2xx=100.0 + i * 100), now=t)
            ag.ingest(gateway_frame("ep3", "p1", role="filer", seq=i + 1,
                                    ts=t, c2xx=200.0 + i * 50), now=t)
        now = t0 + 10
        rates = ag.rates("SeaweedFS_http_request_total", 60, now=now)
        by_role = {}
        for labels, rate in rates:
            if rate is not None:
                by_role[labels["role"]] = \
                    by_role.get(labels["role"], 0.0) + rate
        # s3 counted ONCE (10/s), not twice; filer separately (5/s)
        assert by_role["s3"] == pytest.approx(10.0)
        assert by_role["filer"] == pytest.approx(5.0)


class TestAggregatorFindings:
    def test_multi_gateway_abusive_tenant_tops_cluster_view(self):
        """The motivating case: 1/N of the abuse budget per gateway never
        tops any per-process sketch, but one merge later the tenant is
        the cluster's #1 — with the composed bound covering the truth."""
        ag = agg_mod.TelemetryAggregator()
        t = time.time()
        u1, u2, true_total = split_tenant_sketches()
        ag.ingest(gateway_frame("gw1:8333", "p1", usage=u1, ts=t), now=t)
        ag.ingest(gateway_frame("gw2:8333", "p2", usage=u2, ts=t), now=t)
        merged = ag.merged_usage(now=t)
        top = merged["tenants"][0]
        assert top["collection"] == "abuser"
        count, err = top["requests"], top["requests_err"]
        assert count - err <= true_total <= count + 1e-9
        assert merged["error_bound"] >= err

    def test_stale_sender_detection_fires_and_clears(self):
        ag = agg_mod.TelemetryAggregator()
        t0 = time.time()
        ag.ingest(gateway_frame("gw1", "p1", interval=1.0, ts=t0), now=t0)
        ag.ingest(gateway_frame("gw2", "p2", interval=1.0, ts=t0), now=t0)
        assert ag.evaluate(now=t0) == {}  # fresh: nothing fires
        # both silent past 3x their declared interval
        firing = ag.evaluate(now=t0 + 10)
        assert "cluster_telemetry_stale" in firing
        assert firing["cluster_telemetry_stale"]["severity"] == "warning"
        assert "gw1" in firing["cluster_telemetry_stale"]["detail"]
        # the stale gauge carries per-node series and the firing gauge
        # carries the alert (lines() ages against wall-clock, so the
        # injected-now staleness shows in the alerts gauge, not per-node)
        lines = "\n".join(ag.lines())
        assert 'SeaweedFS_cluster_telemetry_stale{node="gw1"}' in lines
        assert 'alert="cluster_telemetry_stale"' in lines
        # one sender resumes: still firing, but only for the other
        ag.ingest(gateway_frame("gw1", "p1", seq=2, ts=t0 + 10),
                  now=t0 + 10)
        firing = ag.evaluate(now=t0 + 10.5)
        assert "gw1" not in firing["cluster_telemetry_stale"]["detail"]
        assert "gw2" in firing["cluster_telemetry_stale"]["detail"]
        # both resume: clears
        ag.ingest(gateway_frame("gw2", "p2", seq=2, ts=t0 + 11),
                  now=t0 + 11)
        assert ag.evaluate(now=t0 + 11.5) == {}

    def test_cluster_burn_fires_on_split_burst_then_clears(self):
        """Two gateways each burn the s3 availability budget; the merged
        stream fires cluster_slo_burn_fast, and it self-clears once the
        burst ages out of the fast window."""
        ag = agg_mod.TelemetryAggregator()
        t0 = time.time() - 200
        # healthy baseline: 10 req/s per gateway, no errors
        for i in range(5):
            t = t0 + i * 5
            ag.ingest(gateway_frame("gw1", "p1", seq=i + 1, ts=t,
                                    c2xx=1000 + i * 50), now=t)
            ag.ingest(gateway_frame("gw2", "p2", seq=i + 1, ts=t,
                                    c2xx=1000 + i * 50), now=t)
        t_base = t0 + 20
        assert "cluster_slo_burn_fast" not in ag.evaluate(now=t_base)
        # the burst: each gateway adds 5xx at ~2/s for 20s
        for i in range(5):
            t = t_base + 5 + i * 5
            ag.ingest(gateway_frame("gw1", "p1", seq=10 + i, ts=t,
                                    c2xx=1250 + i * 40,
                                    c5xx=10.0 + i * 10), now=t)
            ag.ingest(gateway_frame("gw2", "p2", seq=10 + i, ts=t,
                                    c2xx=1250 + i * 40,
                                    c5xx=10.0 + i * 10), now=t)
        t_burst = t_base + 25
        firing = ag.evaluate(now=t_burst)
        assert "cluster_slo_burn_fast" in firing, firing
        assert firing["cluster_slo_burn_fast"]["severity"] == "critical"
        assert "s3_availability" in firing["cluster_slo_burn_fast"]["detail"]
        # the burn gauge carries the merged reading
        lines = "\n".join(ag.lines())
        assert 'SeaweedFS_cluster_slo_burn_rate{slo="s3_availability"' \
            in lines
        # recovery: errors stop, clean frames push the burst out of the
        # 60s fast window
        for i in range(16):
            t = t_burst + 5 + i * 5
            ag.ingest(gateway_frame("gw1", "p1", seq=30 + i, ts=t,
                                    c2xx=1500 + i * 50, c5xx=50.0), now=t)
            ag.ingest(gateway_frame("gw2", "p2", seq=30 + i, ts=t,
                                    c2xx=1500 + i * 50, c5xx=50.0), now=t)
        firing = ag.evaluate(now=t_burst + 85)
        assert "cluster_slo_burn_fast" not in firing, firing
        assert "cluster_slo_burn_slow" not in firing, firing


class TestHistorySinceCursor:
    def test_snapshot_since_filters_and_omits_quiet_series(self):
        reg = Registry()
        c = reg.counter("SeaweedFS_http_request_total", "", ("role",))
        g = reg.gauge("SeaweedFS_master_free_slots", "", ("node",))
        g.labels("n1").set(7)
        h = MetricsHistory(reg, interval=1.0, slots=16)
        for i in range(6):
            c.labels("s3").inc(10)
            h.scrape_once(now=float(i))
        # full fetch: all six samples
        (full,) = h.snapshot(family="SeaweedFS_http_request_total",
                             window=1000, max_samples=100, now=5.0)
        assert len(full["samples"]) == 6
        # cursor at t=3: strictly-after samples only
        (inc,) = h.snapshot(family="SeaweedFS_http_request_total",
                            window=1000, max_samples=100, now=5.0,
                            since=3.0)
        assert [t for t, _ in inc["samples"]] == [4.0, 5.0]
        # rate math still uses the full window, not the cursored slice
        assert inc["rate"] == full["rate"]
        # cursor at the watermark: nothing new -> series omitted
        assert h.snapshot(window=1000, max_samples=100, now=5.0,
                          since=h.last_scrape) == []

    def test_route_since_cursor_and_watermark(self, cluster):
        master, _, _ = cluster
        first = get_json(f"{master.url}/debug/metrics/history?samples=4")
        assert "watermark" in first and first["watermark"] > 0
        assert first["series"]
        # an immediate incremental poll from the watermark ships nothing
        # (or at most the one scrape ensure_fresh may have added)
        out = get_json(f"{master.url}/debug/metrics/history?samples=4"
                       f"&since={first['watermark']}")
        assert out["watermark"] >= first["watermark"]
        for s in out["series"]:
            for t, _v in s.get("samples", []):
                assert t > first["watermark"]

    def test_route_since_non_finite_is_400(self, cluster):
        master, _, _ = cluster
        for bad in ("inf", "nan", "-inf", "bogus"):
            status, _, body = http_request(
                "GET", f"{master.url}/debug/metrics/history?since={bad}")
            assert status == 400, (bad, body)
            assert b"finite" in body or b"error" in body


@pytest.fixture()
def cluster(tmp_path, monkeypatch):
    # the master self-feeds frames from the PROCESS-global accountant;
    # isolate it so tenants recorded by earlier tests in this process
    # don't merge into (and outrank) this cluster's telemetry
    monkeypatch.setattr(usage_mod, "_accountant",
                        usage_mod.UsageAccountant())
    # the process's history ring and alert state start with this cluster,
    # as chip_smoke.py's observe phase starts them: 5xx that an earlier
    # file in this process served inside the fast window would otherwise
    # fire the master's own slo_burn_fast (and ride its frames)
    history_mod.default_history().clear()
    alerts_mod.engine().evaluate()
    master = MasterServer(port=0, pulse_seconds=1, volume_size_limit_mb=64)
    master.start()
    vs = VolumeServer([str(tmp_path / "v0")], master.url, port=0,
                      pulse_seconds=1, max_volume_count=10, device="cpu")
    vs.start()
    env = CommandEnv(master.url)
    yield master, vs, env
    vs.stop()
    master.stop()


class TestClusterTelemetryE2E:
    def _push(self, master, frame):
        out = post_json(f"{master.url}/cluster/telemetry", frame)
        assert out.get("ok"), out
        return out

    def test_heartbeat_carries_volume_frame(self, cluster):
        master, vs, _ = cluster
        vs.heartbeat_once()
        out = get_json(f"{master.url}/debug/cluster/telemetry")
        node = vs.node_id
        assert node in out["senders"], sorted(out["senders"])
        assert out["senders"][node]["role"] == "volume"
        # the master self-feeds its own frame (role master)
        assert any(s["role"] == "master" for s in out["senders"].values())

    def test_split_tenant_is_top_cluster_tenant_one_fetch(self, cluster):
        """Acceptance: the tenant is #1 in /debug/cluster/telemetry and
        cluster.top's rollup header after ONE push per gateway (one push
        interval), bound covering the true count."""
        master, _, env = cluster
        u1, u2, true_total = split_tenant_sketches()
        self._push(master, gateway_frame("gw1:8333", "proc-a", usage=u1))
        self._push(master, gateway_frame("gw2:8333", "proc-b", usage=u2))
        out = get_json(f"{master.url}/debug/cluster/telemetry")
        top = out["usage"]["tenants"][0]
        assert top["collection"] == "abuser"
        count, err = top["requests"], top.get("requests_err", 0.0)
        assert count - err <= true_total <= count + 1e-9
        # both gateways visible, neither stale
        assert {"gw1:8333", "gw2:8333"} <= set(out["senders"])
        assert not any(s["stale"] for s in out["senders"].values())
        # cluster.top renders the merged rollup header with error bars
        top_out = run_command(env, "cluster.top -once")
        assert "cluster:" in top_out
        assert "abuser" in top_out
        assert "±" in top_out
        # the merged families reach the master's own /metrics
        status, _, body = http_request("GET", f"{master.url}/metrics")
        assert status == 200
        text = body.decode()
        assert 'SeaweedFS_cluster_usage_requests_total{collection="abuser"}' \
            in text
        assert "SeaweedFS_cluster_telemetry_senders" in text

    def test_cluster_burn_fires_and_check_fail_exits_nonzero(self, cluster):
        """Acceptance: a 5xx burst split across two gateways — which no
        single process's burn rule can see — fires the cluster-scope
        fast burn, and cluster.check -fail exits nonzero on it."""
        master, _, env = cluster
        t = time.time()
        self._push(master, gateway_frame("gw1:8333", "proc-a", seq=1,
                                         ts=t, c2xx=1000.0, c5xx=0.0))
        self._push(master, gateway_frame("gw2:8333", "proc-b", seq=1,
                                         ts=t, c2xx=1000.0, c5xx=0.0))
        time.sleep(1.1)
        t = time.time()
        self._push(master, gateway_frame("gw1:8333", "proc-a", seq=2,
                                         ts=t, c2xx=1020.0, c5xx=100.0))
        self._push(master, gateway_frame("gw2:8333", "proc-b", seq=2,
                                         ts=t, c2xx=1020.0, c5xx=100.0))
        out = get_json(f"{master.url}/debug/cluster/telemetry")
        assert "cluster_slo_burn_fast" in out["alerts"], out["alerts"]
        # no per-process engine in THIS cluster saw the burst: the only
        # live processes (master, volume) are healthy
        for ep in (master.url,):
            alerts = get_json(f"{ep}/debug/alerts")
            firing = [a["name"] for a in alerts.get("alerts", [])
                      if a.get("firing")]
            assert "slo_burn_fast" not in firing
        # check prefers the one-fetch aggregate and trips on the critical
        with pytest.raises(ShellError, match="cluster_slo_burn_fast"):
            run_command(env, "cluster.check -fail")
        report = run_command(env, "cluster.check")
        assert "one-fetch master aggregate" in report

    def test_push_route_rejects_malformed(self, cluster):
        master, _, _ = cluster
        status, _, body = http_request(
            "POST", f"{master.url}/cluster/telemetry", body=b'{"role": 3}',
            headers={"Content-Type": "application/json"})
        assert status == 400, body


# --- parity with the JAX package --------------------------------------------
import numpy as np  # noqa: E402

import seaweedfs_tpu.stats.aggregate as ref_agg  # noqa: E402
import seaweedfs_tpu.stats.alerts as ref_alerts  # noqa: E402
import seaweedfs_tpu.stats.metrics as ref_metrics  # noqa: E402
import seaweedfs_tpu.stats.usage as ref_usage  # noqa: E402

from seaweedfs_tpu_torch.stats import metrics as metrics_mod  # noqa: E402

SEED = 20261018
T0 = 1_754_000_000.0


def _frame_inputs(pkg_metrics, pkg_usage):
    """A registry and an accountant holding the same seeded traffic."""
    rng = np.random.default_rng(SEED)
    reg = pkg_metrics.Registry()
    total = reg.counter("SeaweedFS_http_request_total", "requests",
                        ("role", "method", "code"))
    secs = reg.histogram("SeaweedFS_http_request_seconds", "latency",
                         ("role", "method"))
    acct = pkg_usage.UsageAccountant(k=8)
    for _ in range(500):
        role = ("filer", "s3", "volume")[int(rng.integers(0, 3))]
        method = ("GET", "PUT", "POST")[int(rng.integers(0, 3))]
        code = ("200", "201", "404", "500")[int(rng.integers(0, 4))]
        # fractional amounts: the frame's sums must add in the same order
        total.labels(role, method, code).inc(float(rng.random()) * 3)
        secs.labels(role, method).observe(float(rng.random()) * 12)
        acct.record(f"c{int(min(rng.zipf(1.4), 20))}",
                    bytes_in=float(rng.integers(0, 9000)))
    return reg, acct


def test_build_frame_equal_reference(monkeypatch):
    """The port reads a frame's samples off the metrics' own tables; the
    JAX package renders the families and parses the text back. The frames
    are equal, past the last bucket (+Inf) too."""
    monkeypatch.setattr(alerts_mod, "_engine", None)
    monkeypatch.setattr(ref_alerts, "_engine", None)
    monkeypatch.setattr(agg_mod, "_seq", 0)
    monkeypatch.setattr(ref_agg, "_seq", 0)
    ours = _frame_inputs(metrics_mod, usage_mod)
    ref = _frame_inputs(ref_metrics, ref_usage)
    for role, node in (("filer", "http://127.0.0.1:8888/"),
                       ("s3", "127.0.0.1:8333"), ("volume", "h:8080")):
        a = agg_mod.build_frame(role, node, interval=2.5, registry=ours[0],
                                acct=ours[1], now=T0)
        b = ref_agg.build_frame(role, node, interval=2.5, registry=ref[0],
                                acct=ref[1], now=T0)
        assert a.pop("proc") and b.pop("proc")
        assert a == b
        assert a["samples"] and a["usage"]["requests"]
    assert agg_mod.FRAME_SAMPLE_FAMILIES == ref_agg.FRAME_SAMPLE_FAMILIES
    assert agg_mod.CLUSTER_FAMILIES == ref_agg.CLUSTER_FAMILIES


def _frames(seed: int):
    """Seeded frames of four senders over 40 s: tenants, 2xx/5xx counters
    (one sender restarts and resets its counters), one sender goes
    silent, and one replayed and one malformed frame."""
    rng = np.random.default_rng(seed)
    senders = [("gw1:8333", "p1", "s3"), ("gw2:8333", "p2", "s3"),
               ("f1:8888", "p3", "filer"), ("v1:8080", "p4", "volume")]
    counts = {n: [0.0, 0.0] for n, _, _ in senders}
    seqs = {n: 0 for n, _, _ in senders}
    out = []
    for step in range(40):
        t = T0 + step
        for node, proc, role in senders:
            if node == "v1:8080" and step > 25:
                continue  # goes silent: stale
            if node == "gw2:8333" and step == 20:
                proc, counts[node] = "p2b", [0.0, 0.0]  # a restart
                seqs[node] = 0
            seqs[node] += 1
            counts[node][0] += float(rng.integers(50, 200))
            counts[node][1] += float(rng.integers(0, 30 if 10 < step < 20 else 2))
            sk = usage_mod.SpaceSaving(8)
            for _ in range(30):
                sk.offer(f"t{int(min(rng.zipf(1.3), 12))}",
                         float(rng.integers(1, 50)))
            frame = gateway_frame(node, proc, role=role, ts=t, seq=seqs[node],
                                  interval=1.0, c2xx=counts[node][0],
                                  c5xx=counts[node][1],
                                  usage={"requests": sk.to_dict()})
            out.append((frame, t + 0.01))
        if step == 5:
            out.append((dict(out[-1][0]), t + 0.02))  # replayed
            out.append(({"role": 3}, t + 0.02))       # malformed
    return out


def test_aggregator_equal_reference(monkeypatch):
    params = {"window": 30.0}
    ours = agg_mod.TelemetryAggregator(params=params, slots=64)
    ref = ref_agg.TelemetryAggregator(params=params, slots=64)
    clock = [T0]

    class Clock:  # both aggregators' `time`, and no other module's
        @staticmethod
        def time():
            return clock[0]

        # merge_seconds (the ingest cost) is the one measured field
        perf_counter = time

    monkeypatch.setattr(agg_mod, "time", Clock)
    monkeypatch.setattr(ref_agg, "time", Clock)
    accepted = []
    for frame, now in _frames(SEED):
        clock[0] = now
        a, b = ours.ingest(frame, now=now), ref.ingest(frame, now=now)
        assert a == b
        accepted.append(a)
        if len(accepted) % 10 == 0:
            assert ours.snapshot(n=5, now=now) == ref.snapshot(n=5, now=now)
    assert False in accepted and True in accepted
    clock[0] = T0 + 45
    snap = ours.snapshot(now=clock[0])
    assert snap == ref.snapshot(now=clock[0])
    assert ours.lines() == ref.lines()
    assert any(s["stale"] for s in snap["senders"].values())
    assert snap["usage"]["tenants"]
    assert ours.rates("SeaweedFS_http_request_total", 10.0, now=clock[0]) \
        == ref.rates("SeaweedFS_http_request_total", 10.0, now=clock[0])


# --- every port role is a sender ----------------------------------------------
def test_every_role_ships_frames_to_the_master(tmp_path):
    """A port master, a volume server (heartbeat), a filer (registration
    beat), S3 and WebDAV (pushers): the master's one fetch names them all."""
    from seaweedfs_tpu_torch.s3api.s3_server import S3Server
    from seaweedfs_tpu_torch.server.filer import FilerServer
    from seaweedfs_tpu_torch.server.webdav import WebDavServer

    master = MasterServer(port=0, pulse_seconds=1)
    master.start()
    started = [master]
    try:
        vs = VolumeServer([str(tmp_path / "v")], master.url, port=0,
                          pulse_seconds=1, device="cpu")
        vs.start()
        started.append(vs)
        filer = FilerServer(master.url, port=0, device="cpu")
        filer.start()
        started.append(filer)
        s3 = S3Server(filer.url, port=0, master_url=master.url)
        s3.start()
        started.append(s3)
        dav = WebDavServer(filer.url, port=0, master_url=master.url)
        dav.start()
        started.append(dav)
        vs.heartbeat_once()
        filer._register_once()
        assert s3._telemetry_pusher.push_once()
        assert dav._telemetry_pusher.push_once()
        out = get_json(f"{master.url}/debug/cluster/telemetry")
        roles = {s["role"]: n for n, s in out["senders"].items()}
        assert {"master", "volume", "filer", "s3", "webdav"} <= set(roles)
        assert roles["volume"] == vs.node_id
        assert roles["s3"] == s3.url.split("://", 1)[1]
        assert roles["webdav"] == dav.url.split("://", 1)[1]
    finally:
        for server in reversed(started):
            server.stop()
    assert s3._telemetry_pusher is None and dav._telemetry_pusher is None


def test_pusher_reaches_a_master_under_mtls(tmp_path):
    """Under process-wide mTLS the port's pusher presents the client
    certificate (it posts through the port's `http_request`); the JAX
    pusher posts through plain urllib, and its frame never arrives."""
    pytest.importorskip("cryptography")
    from seaweedfs_tpu.security import tls as ref_tls
    from seaweedfs_tpu.security.tls import TLSConfig as RefTLSConfig
    from seaweedfs_tpu_torch.security import tls as tls_mod
    from tests.test_torch_tls import made_pki, node_tls

    with made_pki(str(tmp_path)) as pki:
        tls_mod.configure(node_tls(pki))
        ref_tls.configure(RefTLSConfig(ca=pki["ca"], cert=pki["node"][0],
                                       key=pki["node"][1],
                                       allowed_common_names="node1"))
        master = MasterServer(port=0, pulse_seconds=1)
        master.start()
        try:
            assert master.url.startswith("https://")
            ours = agg_mod.TelemetryPusher("s3", "gw-port:8333", master.url)
            ref = ref_agg.TelemetryPusher("s3", "gw-ref:8333", master.url)
            assert ours.push_once() and ours.pushed == 1
            assert not ref.push_once() and ref.errors == 1
            out = get_json(f"{master.url}/debug/cluster/telemetry")
            assert "gw-port:8333" in out["senders"]
            assert "gw-ref:8333" not in out["senders"]
        finally:
            master.stop()


@pytest.fixture(autouse=True, scope="module")
def _stop_port_threads():
    """No history loop of the port outlives this module."""
    yield
    history_mod.default_history().stop()
