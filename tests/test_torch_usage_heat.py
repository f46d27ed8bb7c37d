"""Tenant usage and heat of the port: the JAX package's
tests/test_usage_heat.py over seaweedfs_tpu_torch, then parity cases that
feed the same seeded inputs through both packages.

Covers: the Space-Saving sketch's invariants under adversarial insert
orders, eviction/_other folding, the multi-dimension UsageAccountant
(handler-path record(), a fake fastlane engine's deltas folded, the
tenant_overflow journal deduped per tenant), the HeatEngine's EWMA scoring
with hysteresis promote/demote events, the days-to-full fit firing and
clearing the capacity_forecast alert pair, the master-side HeatRollup, the
quantile +Inf-mass clamp, /debug/usage and /debug/heat on every port role
(400 on malformed), and cluster.heat / cluster.why <collection>.

Parity (exact equality: both packages run the same Python arithmetic): a
seeded Zipf stream into SpaceSaving (to_dict() and merges), one record
sequence into UsageAccountant (snapshots and exposition lines), the same
history samples and beats into HeatEngine / HeatRollup (scores and
forecasts), linear_slope, and cluster.heat's output against the JAX shell
on one stub endpoint. The module resets the port's accountant and heat
engine, and stops the port's history loop, when it is done.
"""

import math
import random
import sys

import pytest

from seaweedfs_tpu_torch.server.httpd import get_json, http_request
from seaweedfs_tpu_torch.shell import CommandEnv, run_command
from seaweedfs_tpu_torch.shell.env import ShellError
from seaweedfs_tpu_torch.stats import alerts as alerts_mod
from seaweedfs_tpu_torch.stats import events
from seaweedfs_tpu_torch.stats import heat as heat_mod
from seaweedfs_tpu_torch.stats import usage as usage_mod
from seaweedfs_tpu_torch.stats.history import (
    MetricsHistory,
    quantile_from_bucket_rates,
)
from seaweedfs_tpu_torch.stats.metrics import Registry


class TestSpaceSaving:
    def test_k_must_be_positive(self):
        with pytest.raises(ValueError):
            usage_mod.SpaceSaving(0)

    def test_exact_below_capacity(self):
        sk = usage_mod.SpaceSaving(8)
        for key, inc in (("a", 3.0), ("b", 1.0), ("a", 2.0)):
            assert sk.offer(key, inc) is None
        assert sk.top() == [("a", 5.0, 0.0), ("b", 1.0, 0.0)]
        assert sk.other == 0 and sk.evictions == 0 and sk.error_bound == 0

    def test_eviction_folds_into_other_and_bounds_error(self):
        sk = usage_mod.SpaceSaving(2)
        sk.offer("a", 5.0)
        sk.offer("b", 2.0)
        # full: the newcomer displaces the min-count key, inherits its
        # count as both head start and error bound
        assert sk.offer("c", 1.0) == "b"
        assert sk.counts == {"a": 5.0, "c": 3.0}
        assert sk.errs["c"] == 2.0
        assert sk.other == 2.0
        assert sk.evictions == 1
        assert sk.error_bound == 2.0

    def test_property_invariants_adversarial_orders(self):
        """count - err <= true <= count for every tracked key, err never
        exceeds the exported error_bound — under sorted, reversed,
        interleaved and shuffled arrival orders."""
        rng = random.Random(0xbeef)
        base = [(f"t{i:02d}", float(1 + i * 3)) for i in range(40)]
        orders = {
            "sorted": sorted(base, key=lambda kv: kv[1]),
            "reversed": sorted(base, key=lambda kv: -kv[1]),
            "interleaved": [kv for pair in zip(base[::2], base[1::2])
                            for kv in pair],
        }
        for name in ("shuffle1", "shuffle2", "shuffle3"):
            o = list(base)
            rng.shuffle(o)
            orders[name] = o
        for name, order in orders.items():
            sk = usage_mod.SpaceSaving(8)
            true: dict[str, float] = {}
            # adversarial unit-increment stream: each weight arrives as
            # many singleton offers, interleaved round-robin
            stream = []
            for key, weight in order:
                stream.extend([key] * int(weight))
            rng.shuffle(stream)
            for key in stream:
                true[key] = true.get(key, 0.0) + 1.0
                sk.offer(key, 1.0)
            assert len(sk.counts) <= 8, name
            total = sum(true.values())
            assert sum(sk.counts.values()) == pytest.approx(total), name
            for key, count in sk.counts.items():
                err = sk.errs[key]
                t = true.get(key, 0.0)
                assert count - err <= t + 1e-9, (name, key)
                assert t <= count + 1e-9, (name, key)
                assert err <= sk.error_bound + 1e-9, (name, key)

    def test_memory_stays_o_k_under_10x_cardinality(self):
        """The acceptance bar: 10x-K distinct collections must not grow
        the sketch past K entries (that is the whole point)."""
        k = 16
        sk = usage_mod.SpaceSaving(k)
        for i in range(10 * k):
            sk.offer(f"tenant-{i}", float(1 + i % 7))
        assert len(sk.counts) <= k
        assert len(sk.errs) <= k
        assert sk.evictions == 10 * k - k
        assert sk.other > 0
        # the container footprint itself is bounded, not just len()
        assert sys.getsizeof(sk.counts) < sys.getsizeof(
            dict.fromkeys(range(4 * k)))


class TestUsageAccountant:
    def test_record_and_snapshot(self):
        acct = usage_mod.UsageAccountant(k=8)
        acct.record("acme", bytes_in=100.0)
        acct.record("acme", bytes_out=50.0)
        acct.record("globex", error=True)
        acct.record("")  # empty collection -> "default"
        snap = acct.snapshot()
        assert snap["k"] == 8
        by_coll = {r["collection"]: r for r in snap["tenants"]}
        assert by_coll["acme"]["requests"] == 2.0
        assert by_coll["acme"]["bytes_in"] == 100.0
        assert by_coll["acme"]["bytes_out"] == 50.0
        assert by_coll["globex"]["errors"] == 1.0
        assert "default" in by_coll
        assert snap["tracked"] == 3 and snap["evictions"] == 0
        # n caps the rows, highest-requests first
        snap2 = acct.snapshot(n=1)
        assert len(snap2["tenants"]) == 1
        assert snap2["tenants"][0]["collection"] == "acme"

    def test_overflow_emits_once_per_tenant(self):
        events.recorder().enable()
        rec = events.recorder()
        import time as time_mod
        t0 = time_mod.time() - 0.001
        acct = usage_mod.UsageAccountant(k=1)
        acct.record("a")
        acct.record("b")  # evicts a -> journal
        acct.record("a")  # evicts b -> journal
        acct.record("b")  # evicts a AGAIN -> deduped, no second event
        acct.record("a")  # evicts b AGAIN -> deduped
        got = [e for e in rec.events(type="tenant_overflow", since=t0)
               if e["attrs"].get("k") == 1]
        assert sorted(e["attrs"]["collection"] for e in got) == ["a", "b"]
        assert all(e["attrs"]["k"] == 1 for e in got)

    def test_engine_deltas_folded_not_cumulative(self):
        """The native feed folds counter DELTAS vs the engine's previous
        snapshot — scraping twice must not double-count."""
        class FakeEngine:
            def __init__(self):
                self.rows = {"hot": {"reads": 10, "writes": 5, "deletes": 0,
                                     "read_bytes": 1000, "write_bytes": 500}}

            def usage_metrics(self):
                return {c: dict(r) for c, r in self.rows.items()}

        acct = usage_mod.UsageAccountant(k=8)
        eng = FakeEngine()
        acct.attach_engine(eng)
        snap = acct.snapshot()
        row = next(r for r in snap["tenants"] if r["collection"] == "hot")
        assert row["requests"] == 15.0
        assert row["bytes_in"] == 500.0 and row["bytes_out"] == 1000.0
        # unchanged engine counters -> no growth
        row = next(r for r in acct.snapshot()["tenants"]
                   if r["collection"] == "hot")
        assert row["requests"] == 15.0
        # +3 reads -> +3, not +18
        eng.rows["hot"]["reads"] = 13
        row = next(r for r in acct.snapshot()["tenants"]
                   if r["collection"] == "hot")
        assert row["requests"] == 18.0
        acct.detach_engine(eng)
        eng.rows["hot"]["reads"] = 1000
        row = next(r for r in acct.snapshot()["tenants"]
                   if r["collection"] == "hot")
        assert row["requests"] == 18.0  # detached: no further folding

    def test_lines_exposition_shape(self):
        acct = usage_mod.UsageAccountant(k=2)
        acct.record("a", bytes_in=10.0)
        acct.record("a")
        acct.record("b")
        acct.record("c")  # evicts b (the unambiguous min) -> _other mass
        text = "\n".join(acct.lines())
        assert "# TYPE SeaweedFS_usage_requests_total counter" in text
        assert 'SeaweedFS_usage_requests_total{collection="a"}' in text
        assert 'collection="_other"' in text
        assert "SeaweedFS_usage_tracked_collections 2" in text
        assert "SeaweedFS_usage_error_bound" in text
        assert "SeaweedFS_usage_overflow_total 1" in text


def _heat_fixture(promote=10.0, demote=2.0):
    reg = Registry()
    hist = MetricsHistory(reg, interval=1.0, slots=200)
    c = reg.counter("SeaweedFS_volume_fastlane_volume_requests_total", "",
                    ("server", "volume", "op"))
    eng = heat_mod.HeatEngine(history=hist, alpha=0.3, window=60.0,
                              promote=promote, demote=demote)
    return reg, hist, c, eng


class TestHeatEngine:
    def test_demote_must_not_exceed_promote(self):
        with pytest.raises(ValueError):
            heat_mod.HeatEngine(history=MetricsHistory(Registry()),
                                promote=5.0, demote=6.0)

    def test_ewma_scores_separate_hot_from_cold(self):
        events.recorder().enable()
        rec = events.recorder()
        import time as time_mod
        t0 = time_mod.time() - 0.001
        _, hist, c, eng = _heat_fixture()
        # the first scrape must be at t > 0 for new counter series to
        # zero-seed (the ring treats last_scrape == 0 as "never scraped")
        hist.scrape_once(now=1.0)
        c.labels("n1:1", "7", "read").inc(1000)   # ~100 ops/s
        c.labels("n1:1", "8", "read").inc(5)      # ~0.5 ops/s
        hist.scrape_once(now=11.0)
        eng.observe(now=11.0)
        snap = eng.snapshot()
        by_vol = {v["volume"]: v for v in snap["volumes"]}
        assert by_vol["7"]["score"] > 10 * by_vol["8"]["score"]
        assert by_vol["7"]["hot"] and not by_vol["8"]["hot"]
        assert snap["volumes"][0]["volume"] == "7"  # hottest first
        promoted = [e for e in rec.events(type="heat_promoted", since=t0)
                    if e["volume"] == 7]
        assert promoted and promoted[0]["node"] == "n1:1"
        assert promoted[0]["attrs"]["score"] >= eng.promote
        text = "\n".join(eng.lines())
        assert "# TYPE SeaweedFS_volume_heat_score gauge" in text
        assert 'server="n1:1"' in text and 'volume="7"' in text

    def test_quiet_series_decays_and_demotes(self):
        events.recorder().enable()
        rec = events.recorder()
        import time as time_mod
        t0 = time_mod.time() - 0.001
        _, hist, c, eng = _heat_fixture()
        hist.scrape_once(now=1.0)
        c.labels("n2:1", "9", "write").inc(500)   # ~50 ops/s -> hot
        hist.scrape_once(now=11.0)
        eng.observe(now=11.0)
        assert eng.snapshot()["volumes"][0]["hot"]
        # traffic stops: the rate window empties, the score decays
        # through the demote threshold, the edge is journaled, and the
        # entry eventually evaporates instead of freezing stale
        now = 11.0
        for _ in range(40):
            now += 70.0  # past the rate window
            hist.scrape_once(now=now)
            eng.observe(now=now)
            if not eng.snapshot()["volumes"]:
                break
        assert eng.snapshot()["volumes"] == []
        demoted = [e for e in rec.events(type="heat_demoted", since=t0)
                   if e["volume"] == 9]
        assert demoted and demoted[0]["node"] == "n2:1"


class TestLinearSlope:
    def test_exact_fit(self):
        pts = [(0.0, 5.0), (10.0, 25.0), (20.0, 45.0)]
        assert heat_mod.linear_slope(pts) == pytest.approx(2.0)

    def test_degenerate(self):
        assert heat_mod.linear_slope([]) is None
        assert heat_mod.linear_slope([(0, 1), (1, 2)]) is None
        assert heat_mod.linear_slope([(5, 1), (5, 2), (5, 3)]) is None


class TestCapacityForecast:
    def _fill_fixture(self):
        reg = Registry()
        hist = MetricsHistory(reg, interval=1.0, slots=200)
        used = reg.gauge("SeaweedFS_volume_disk_used_bytes", "",
                         ("server", "dir"))
        free = reg.gauge("SeaweedFS_volume_disk_free_bytes", "",
                         ("server", "dir"))
        eng = heat_mod.HeatEngine(history=hist)
        reg.register_collector(eng.lines, names=heat_mod.HEAT_FAMILIES)
        return reg, hist, used, free, eng

    def test_fill_burst_fires_alert_then_deletion_clears_it(self):
        """The acceptance chain: a 1 MB/s fill with 2 days of free space
        -> SeaweedFS_node_days_to_full ~= 2 -> capacity_forecast warning
        AND critical fire; a mass deletion flattens the fit -> the gauge
        disappears -> both alerts clear."""
        reg, hist, used, free, eng = self._fill_fixture()
        free.labels("n1:1", "/data").set(2 * 86400 * 1e6)  # 2 days @ 1MB/s
        for now in (0.0, 60.0, 120.0):
            used.labels("n1:1", "/data").set(now * 1e6)
            hist.scrape_once(now=now)
        eng.observe(now=120.0)
        snap = eng.snapshot()
        assert len(snap["forecast"]) == 1
        f = snap["forecast"][0]
        assert f["node"] == "n1:1" and f["dir"] == "/data"
        assert f["days_to_full"] == pytest.approx(2.0, rel=0.05)
        text = "\n".join(eng.lines())
        assert "# TYPE SeaweedFS_node_days_to_full gauge" in text
        assert 'node="n1:1"' in text
        # the collector's gauge rides the ring into the alert pair
        hist.scrape_once(now=121.0)
        alert_eng = alerts_mod.AlertEngine(history=hist, registry=reg)
        try:
            fired = alert_eng.evaluate(now=121.0)
            assert "capacity_forecast" in fired
            assert fired["capacity_forecast"]["severity"] == "warning"
            assert "n1:1 /data full in" in fired["capacity_forecast"]["detail"]
            assert "capacity_forecast_critical" in fired  # 2d < 3d horizon
            # deletion: usage drops, the positive-slope gate empties the
            # forecast, the gauge vanishes from the next scrapes, and
            # require_current latests() lets both alerts clear
            for now in (180.0, 240.0, 300.0):
                used.labels("n1:1", "/data").set(max(0.0, 1e6 * (300 - now)))
                hist.scrape_once(now=now)
            eng.observe(now=300.0)
            assert eng.snapshot()["forecast"] == []
            hist.scrape_once(now=301.0)
            hist.scrape_once(now=302.0)
            fired = alert_eng.evaluate(now=302.0)
            assert "capacity_forecast" not in fired
            assert "capacity_forecast_critical" not in fired
        finally:
            alert_eng.close()

    def test_slow_fill_beyond_horizon_stays_quiet(self):
        reg, hist, used, free, eng = self._fill_fixture()
        free.labels("n1:1", "/data").set(400 * 86400 * 1e6)  # 400 days out
        for now in (0.0, 60.0, 120.0):
            used.labels("n1:1", "/data").set(now * 1e6)
            hist.scrape_once(now=now)
        eng.observe(now=120.0)
        assert eng.snapshot()["forecast"][0]["days_to_full"] > 300
        hist.scrape_once(now=121.0)
        alert_eng = alerts_mod.AlertEngine(history=hist, registry=reg)
        try:
            fired = alert_eng.evaluate(now=121.0)
            assert "capacity_forecast" not in fired
        finally:
            alert_eng.close()


class TestHeatRollup:
    def test_heartbeat_deltas_become_collection_rates(self):
        ru = heat_mod.HeatRollup(alpha=0.3)
        beat1 = [{"id": 1, "collection": "hot", "read_ops": 0,
                  "write_ops": 0},
                 {"id": 2, "collection": "", "read_ops": 0, "write_ops": 0}]
        ru.feed("n1:8080", beat1, now=0.0)
        assert ru.snapshot() == {"collections": [], "nodes": []}  # no delta yet
        beat2 = [{"id": 1, "collection": "hot", "read_ops": 800,
                  "write_ops": 200},
                 {"id": 2, "collection": "", "read_ops": 40, "write_ops": 10}]
        ru.feed("n1:8080", beat2, now=10.0)
        snap = ru.snapshot()
        by_coll = {c["collection"]: c["score"] for c in snap["collections"]}
        assert by_coll["hot"] == pytest.approx(100.0)
        assert by_coll["default"] == pytest.approx(5.0)  # "" -> default
        assert snap["nodes"][0]["node"] == "n1:8080"
        assert snap["nodes"][0]["score"] == pytest.approx(105.0)
        text = "\n".join(ru.lines())
        assert 'SeaweedFS_heat_collection_score{collection="hot"}' in text
        assert 'SeaweedFS_heat_node_score{node="n1:8080"}' in text

    def test_counter_reset_and_expiry(self):
        ru = heat_mod.HeatRollup(alpha=1.0, expire=60.0)
        ru.feed("n1:1", [{"id": 1, "collection": "x", "read_ops": 1000,
                          "write_ops": 0}], now=0.0)
        # restart: cumulative ops went BACKWARD -> treat as fresh count
        ru.feed("n1:1", [{"id": 1, "collection": "x", "read_ops": 50,
                          "write_ops": 0}], now=10.0)
        by_coll = {c["collection"]: c["score"]
                   for c in ru.snapshot()["collections"]}
        assert by_coll["x"] == pytest.approx(5.0)
        # a second node keeps beating; the first goes silent past expire
        ru.feed("n2:1", [{"id": 9, "collection": "y", "read_ops": 0,
                          "write_ops": 0}], now=50.0)
        ru.feed("n2:1", [{"id": 9, "collection": "y", "read_ops": 100,
                          "write_ops": 0}], now=100.0)
        names = {c["collection"] for c in ru.snapshot()["collections"]}
        assert names == {"y"}


class TestQuantileInfMass:
    def test_inf_mass_clamps_to_largest_finite_bound(self):
        """p99 mass in the overflow bucket must not render a fictitious
        finite latency: the clamp returns the largest finite bound as a
        LOWER bound and flags it."""
        rates = {0.1: 1.0, 1.0: 2.0, math.inf: 100.0}
        flags: dict = {}
        val = quantile_from_bucket_rates(rates, 0.99, flags=flags)
        assert val == 1.0
        assert flags.get("inf_mass") is True

    def test_finite_mass_not_flagged(self):
        rates = {0.1: 50.0, 1.0: 100.0, math.inf: 100.0}
        flags: dict = {}
        val = quantile_from_bucket_rates(rates, 0.5, flags=flags)
        assert 0.0 < val <= 0.1
        assert "inf_mass" not in flags

    def test_only_inf_bucket_returns_none_still_flagged(self):
        flags: dict = {}
        assert quantile_from_bucket_rates(
            {math.inf: 10.0}, 0.99, flags=flags) is None
        assert flags.get("inf_mass") is True

    def test_flags_optional(self):
        assert quantile_from_bucket_rates(
            {0.1: 1.0, math.inf: 10.0}, 0.99) == 0.1


@pytest.fixture(scope="class")
def heat_cluster(tmp_path_factory):
    """master + volume + filer in one process: the three roles the
    /debug/usage + /debug/heat routes and cluster.heat are asserted on."""
    from seaweedfs_tpu_torch.server.filer import FilerServer
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume import VolumeServer

    tmp = tmp_path_factory.mktemp("heatstack")
    master = MasterServer(port=0, pulse_seconds=1, volume_size_limit_mb=64)
    master.start()
    vs = VolumeServer([str(tmp / "v0")], master.url, port=0, rack="r0",
                      pulse_seconds=1, max_volume_count=30, device="cpu")
    vs.start()
    filer = FilerServer(master.url, port=0, chunk_size_mb=1, device="cpu")
    filer.start()
    env = CommandEnv(master.url)
    yield {"master": master, "vs": vs, "filer": filer, "env": env}
    filer.stop()
    vs.stop()
    master.stop()


class TestDebugRoutes:
    def test_usage_and_heat_served_on_every_role(self, heat_cluster):
        urls = [heat_cluster["master"].url, heat_cluster["vs"].service.url,
                heat_cluster["filer"].service.url]
        for url in urls:
            out = get_json(f"{url}/debug/usage")
            assert out["proc"] and "tenants" in out and "k" in out
            assert "error_bound" in out
            out = get_json(f"{url}/debug/heat")
            assert out["proc"] and "volumes" in out and "forecast" in out

    def test_filer_traffic_lands_in_the_accountant(self, heat_cluster):
        filer = heat_cluster["filer"]
        st, _, _ = http_request(
            "POST", f"{filer.service.url}/b/obj1?collection=acmetest",
            b"x" * 1000)
        assert st in (200, 201)
        st, _, body = http_request(
            "GET", f"{filer.service.url}/b/obj1?collection=acmetest")
        assert st == 200 and body == b"x" * 1000
        out = get_json(f"{filer.service.url}/debug/usage")
        row = next(r for r in out["tenants"]
                   if r["collection"] == "acmetest")
        assert row["requests"] >= 2
        assert row.get("bytes_in", 0) >= 1000
        assert row.get("bytes_out", 0) >= 1000

    def test_master_rollup_appears_in_debug_heat(self, heat_cluster):
        master = heat_cluster["master"]
        # the heartbeat loop has been feeding the rollup since start();
        # the per-volume counters only produce a rate once traffic flowed
        out = get_json(f"{master.url}/debug/heat")
        # rollup block present only when rates exist — but the route must
        # always answer with the engine view
        assert "volumes" in out and "forecast" in out

    def test_malformed_n_returns_400(self, heat_cluster):
        url = heat_cluster["master"].url
        for path in ("/debug/usage?n=0", "/debug/usage?n=abc",
                     "/debug/heat?n=-3", "/debug/heat?n=banana"):
            status, _, body = http_request("GET", url + path)
            assert status == 400, path
            assert b"positive integer" in body, path

    def test_n_caps_rows(self, heat_cluster):
        filer = heat_cluster["filer"]
        for i in range(3):
            http_request("POST",
                         f"{filer.service.url}/b/o{i}?collection=cap{i}",
                         b"y")
        out = get_json(f"{filer.service.url}/debug/usage?n=2")
        assert len(out["tenants"]) <= 2


class TestClusterHeatVerb:
    def test_renders_tenants_and_forecast_sections(self, heat_cluster):
        filer = heat_cluster["filer"]
        for i in range(3):
            http_request("POST",
                         f"{filer.service.url}/b/hv{i}?collection=verbt",
                         b"z" * 100)
        # the process-wide accountant carries every suite-run tenant, so
        # ask for enough rows that a 3-request tenant can't be cut off
        out = run_command(heat_cluster["env"], "cluster.heat -n 99")
        assert "cluster.heat @" in out
        assert "tenants (top" in out
        assert "verbt" in out
        assert "days-to-full" in out  # section renders even when empty

    def test_out_flag_writes_report(self, heat_cluster, tmp_path):
        dest = tmp_path / "heat.txt"
        out = run_command(heat_cluster["env"], f"cluster.heat -out {dest}")
        assert f"report written to {dest}" in out
        assert "tenants (top" in dest.read_text()

    def test_bad_n_raises_usage(self, heat_cluster):
        with pytest.raises(ShellError, match="usage"):
            run_command(heat_cluster["env"], "cluster.heat -n nope")
        with pytest.raises(ShellError, match="usage"):
            run_command(heat_cluster["env"], "cluster.heat -n 0")

    def test_cluster_why_collection_timeline(self, heat_cluster):
        events.recorder().enable()
        events.emit("tenant_overflow", collection="whytenant", k=4)
        out = run_command(heat_cluster["env"], "cluster.why whytenant")
        assert "cluster.why collection 'whytenant'" in out
        assert "tenant_overflow" in out


# --- parity with the JAX package --------------------------------------------
import json  # noqa: E402
import threading  # noqa: E402
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer  # noqa: E402

import numpy as np  # noqa: E402

import seaweedfs_tpu.stats.heat as ref_heat  # noqa: E402
import seaweedfs_tpu.stats.history as ref_history  # noqa: E402
import seaweedfs_tpu.stats.metrics as ref_metrics  # noqa: E402
import seaweedfs_tpu.stats.usage as ref_usage  # noqa: E402
from seaweedfs_tpu.shell import CommandEnv as RefCommandEnv  # noqa: E402
from seaweedfs_tpu.shell import run_command as ref_run_command  # noqa: E402
from seaweedfs_tpu.shell.env import ShellError as RefShellError  # noqa: E402

from seaweedfs_tpu_torch.stats import history as history_mod  # noqa: E402
from seaweedfs_tpu_torch.stats import metrics as metrics_mod  # noqa: E402

SEED = 20261018


def zipf_stream(seed: int, n: int = 4000, keys: int = 200):
    """(tenant, weight) pairs: Zipf-ranked tenants, weights 1-4096 bytes."""
    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(1.3, n), keys)
    weights = rng.integers(1, 4097, n)
    return [(f"tenant-{int(r):03d}", float(w)) for r, w in zip(ranks, weights)]


def test_space_saving_zipf_stream_equals_reference():
    stream = zipf_stream(SEED)
    ours, ref = usage_mod.SpaceSaving(16), ref_usage.SpaceSaving(16)
    for key, inc in stream:
        assert ours.offer(key, inc) == ref.offer(key, inc)
    assert ours.to_dict() == ref.to_dict()
    assert ours.top() == ref.top()
    # merges: two halves of a second stream, each package merging its own
    a, b = usage_mod.SpaceSaving(16), usage_mod.SpaceSaving(16)
    ra, rb = ref_usage.SpaceSaving(16), ref_usage.SpaceSaving(16)
    for i, (key, inc) in enumerate(zipf_stream(SEED + 1)):
        (a if i % 2 else b).offer(key, inc)
        (ra if i % 2 else rb).offer(key, inc)
    assert a.merge(b).to_dict() == ra.merge(rb).to_dict()
    assert ours.merge(a).to_dict() == ref.merge(ra).to_dict()
    # the wire format crosses packages both ways
    assert usage_mod.SpaceSaving.from_dict(ref.to_dict()).to_dict() \
        == ref.to_dict()
    assert ref_usage.SpaceSaving.from_dict(ours.to_dict()).to_dict() \
        == ours.to_dict()


def test_usage_accountant_records_equal_reference():
    rng = np.random.default_rng(SEED)
    ours, ref = usage_mod.UsageAccountant(k=8), ref_usage.UsageAccountant(k=8)
    for _ in range(3000):
        coll = f"c{int(min(rng.zipf(1.4), 40))}"
        kw = {"bytes_in": float(rng.integers(0, 3) * rng.integers(1, 9000)),
              "bytes_out": float(rng.integers(0, 2) * rng.integers(1, 9000)),
              "error": bool(rng.random() < 0.05)}
        ours.record(coll, **kw)
        ref.record(coll, **kw)
    ours.record("")
    ref.record("")
    assert ours.snapshot() == ref.snapshot()
    assert ours.snapshot(n=3) == ref.snapshot(n=3)
    assert ours.export_sketches() == ref.export_sketches()
    assert ours.lines() == ref.lines()


def _heat_pair(pkg_metrics, pkg_history, pkg_heat):
    reg = pkg_metrics.Registry()
    hist = pkg_history.MetricsHistory(reg, interval=1.0, slots=400)
    req = reg.counter("SeaweedFS_volume_fastlane_volume_requests_total", "",
                      ("server", "volume", "op"))
    used = reg.gauge("SeaweedFS_volume_disk_used_bytes", "", ("server", "dir"))
    free = reg.gauge("SeaweedFS_volume_disk_free_bytes", "", ("server", "dir"))
    eng = pkg_heat.HeatEngine(history=hist, alpha=0.3, window=60.0,
                              promote=10.0, demote=2.0)
    return hist, req, used, free, eng


def test_heat_engine_scores_and_forecast_equal_reference():
    sides = [_heat_pair(metrics_mod, history_mod, heat_mod),
             _heat_pair(ref_metrics, ref_history, ref_heat)]
    rng = np.random.default_rng(SEED)
    plan = [(float(10 * (i + 1)),
             [int(x) for x in rng.integers(0, 800, 6)],
             float(rng.integers(0, 4 << 20)))
            for i in range(30)]
    for hist, req, used, free, eng in sides:
        free.labels("n1:1", "/d").set(50e9)
        free.labels("n2:1", "/e").set(9e12)
        hist.scrape_once(now=1.0)
    snaps = [[], []]
    total = [0.0, 0.0]
    for now, ops, grow in plan:
        for i, (hist, req, used, free, eng) in enumerate(sides):
            for v, n in enumerate(ops):
                req.labels(f"n{v % 2 + 1}:1", str(v), "read").inc(n)
            total[i] += grow
            used.labels("n1:1", "/d").set(total[i])
            used.labels("n2:1", "/e").set(total[i] / 3)
            hist.scrape_once(now=now)
            eng.observe(now=now)
            snaps[i].append(eng.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[0][-1]["volumes"] and snaps[0][-1]["forecast"]
    assert sides[0][4].lines() == sides[1][4].lines()


def test_heat_rollup_equal_reference():
    ours, ref = heat_mod.HeatRollup(alpha=0.3), ref_heat.HeatRollup(alpha=0.3)
    rng = np.random.default_rng(SEED)
    cum = {}
    for step in range(20):
        now = 5.0 * step
        for node in ("n1:8080", "n2:8080", "n3:8080"):
            vols = []
            for vid in range(1, 5):
                key = (node, vid)
                r, w = cum.get(key, (0, 0))
                if step == 11 and vid == 2:
                    r, w = 0, 0  # a restart: the counters went backward
                r += int(rng.integers(0, 500))
                w += int(rng.integers(0, 100))
                cum[key] = (r, w)
                vols.append({"id": vid, "collection": f"col{vid % 3}",
                             "read_ops": r, "write_ops": w})
            if step < 15 or node != "n3:8080":  # n3 goes silent and expires
                ours.feed(node, vols, now=now)
                ref.feed(node, vols, now=now)
        assert ours.snapshot() == ref.snapshot()
    assert ours.lines() == ref.lines()


def test_linear_slope_equal_reference():
    rng = np.random.default_rng(SEED)
    for n in (0, 2, 3, 5, 40, 400):
        pts = [(float(t), float(v)) for t, v in zip(
            np.cumsum(rng.random(n) * 10), rng.random(n) * 1e9)]
        assert heat_mod.linear_slope(pts) == ref_heat.linear_slope(pts)
    flat = [(5.0, 1.0), (5.0, 2.0), (5.0, 3.0)]
    assert heat_mod.linear_slope(flat) is ref_heat.linear_slope(flat) is None


class JsonStub:
    """One HTTP endpoint that answers as the master, the only volume server
    and every debug route, with fixed JSON bodies (`routes`: path -> body);
    any other path is a 404. POST bodies are kept in `posts`."""

    def __init__(self, routes: dict) -> None:
        stub = self
        self.routes = routes
        self.posts: list = []

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, status, body):
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.partition("?")[0]
                if path in stub.routes:
                    self._send(200, json.dumps(stub.routes[path]).encode())
                else:
                    self._send(404, b'{"error": "no route"}')

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                stub.posts.append((self.path, json.loads(self.rfile.read(n) or b"{}")))
                self._send(200, json.dumps({"ok": True, "armed": True}).encode())

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.addr = f"127.0.0.1:{self.httpd.server_address[1]}"
        self.url = "http://" + self.addr
        self.routes.setdefault("/dir/status", {"Topology": {"data_centers": [
            {"name": "dc1", "racks": [{"name": "r1", "nodes": [
                {"id": self.addr, "url": self.addr, "max_volume_count": 8,
                 "volume_infos": [], "ec_shard_infos": []}]}]}]}})
        self.routes.setdefault("/cluster/ps", {"filers": [], "brokers": []})
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


HEAT_ROUTES = {
    "/debug/usage": {
        "proc": "p1", "role": "filer", "k": 64, "tracked": 3, "evictions": 2,
        "error_bound": 4.0,
        "tenants": [
            {"collection": "acme", "requests": 120.0, "requests_err": 4.0,
             "bytes_in": 4096.0, "bytes_out": 1.5e6, "errors": 2.0},
            {"collection": "globex", "requests": 30.0, "bytes_in": 12.0,
             "bytes_out": 0.0, "errors": 0.0},
            {"collection": "initech", "requests": 7.0}],
        "other": {"requests": 5.0, "bytes_in": 10.0, "bytes_out": 0.0,
                  "errors": 0.0}},
    "/debug/heat": {
        "proc": "p1", "role": "master",
        "volumes": [{"server": "n1:8080", "volume": "7", "score": 40.5,
                     "hot": True},
                    {"server": "n1:8080", "volume": "3", "score": 0.25}],
        "forecast": [{"node": "n1:8080", "dir": "/data", "days_to_full": 2.5,
                      "slope_bytes_per_s": 1e6}],
        "collections": [{"collection": "acme", "score": 33.0}],
        "nodes": [{"node": "n1:8080", "score": 40.75}]},
}


@pytest.fixture(scope="module")
def heat_stub():
    s = JsonStub(dict(HEAT_ROUTES))
    yield s
    s.stop()


@pytest.mark.parametrize("line", [
    "cluster.heat", "cluster.heat -n 1", "cluster.heat -n 99"])
def test_cluster_heat_equals_reference_on_stub(heat_stub, line):
    want = ref_run_command(RefCommandEnv(heat_stub.url), line)
    got = run_command(CommandEnv(heat_stub.url), line)
    assert got == want
    assert "acme" in got and "days-to-full" in got


def test_cluster_heat_errors_equal_reference(heat_stub):
    for line in ("cluster.heat -n 0", "cluster.heat -n x"):
        with pytest.raises(RefShellError) as a:
            ref_run_command(RefCommandEnv(heat_stub.url), line)
        with pytest.raises(ShellError) as b:
            run_command(CommandEnv(heat_stub.url), line)
        assert str(b.value) == str(a.value)


@pytest.fixture(autouse=True, scope="module")
def _reset_port_singletons():
    """The port's accountant and heat engine are process singletons: start
    this module from fresh ones, and on the way out detach the engine and
    stop the port's history loop, so no thread of this file outlives it."""
    usage_mod.reset()
    yield
    eng = heat_mod._engine
    if eng is not None:
        eng.close()
    history_mod.default_history().stop()
