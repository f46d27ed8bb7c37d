"""Metrics history ring + rate-based alerting + cluster.top of the port
(stats/history.py, stats/alerts.py, /debug/metrics/history, /debug/alerts,
cluster.top, cluster.check -fail on critical alerts): the JAX package's
tests/test_history_alerts.py over seaweedfs_tpu_torch, its roles on the CPU.

Covers: ring retention/eviction and the series cap, windowed counter-rate
correctness against hand-computed values (incl. the counter-reset clamp),
each alert rule on synthetic series, the live acceptance path — an
injected 5xx burst firing an alert visible in /debug/alerts, /metrics,
cluster.top, and cluster.check -fail's exit — plus a 3-role
cluster.top -once render. (bench.py's summaries belong to the JAX
package's benchmark and are not ported.)
"""

import os
import time

import pytest

from seaweedfs_tpu_torch.stats import alerts as alerts_mod
from seaweedfs_tpu_torch.stats import history as history_mod
from seaweedfs_tpu_torch.stats.history import MetricsHistory, counter_rate
from seaweedfs_tpu_torch.stats.metrics import Registry


class TestCounterRate:
    def test_hand_computed_rate(self):
        samples = [(0.0, 0.0), (10.0, 100.0), (20.0, 250.0)]
        # (100 + 150) events over 20s
        assert counter_rate(samples, window=100, now=20.0) \
            == pytest.approx(12.5)

    def test_window_excludes_old_samples(self):
        samples = [(0.0, 0.0), (10.0, 100.0), (20.0, 200.0), (30.0, 200.0)]
        # window 15 from now=30 keeps (20, 200) and (30, 200): idle
        assert counter_rate(samples, window=15, now=30.0) == 0.0
        # the full window sees 200 events over 30s
        assert counter_rate(samples, window=100, now=30.0) \
            == pytest.approx(200 / 30)

    def test_reset_yields_clamped_non_negative_rate(self):
        # a process restart drops the counter from 1000 to 40: the naive
        # delta is -960; the clamped rate counts the post-reset 40 only
        samples = [(0.0, 1000.0), (10.0, 40.0)]
        rate = counter_rate(samples, window=100, now=10.0)
        assert rate == pytest.approx(4.0)
        assert rate >= 0

    def test_reset_mid_stream(self):
        samples = [(0.0, 100.0), (10.0, 200.0), (20.0, 50.0)]
        # +100, then reset with 50 accumulated after it: 150 over 20s
        assert counter_rate(samples, window=100, now=20.0) \
            == pytest.approx(7.5)

    def test_insufficient_samples_is_none_not_zero(self):
        assert counter_rate([], window=10, now=0.0) is None
        assert counter_rate([(0.0, 5.0)], window=10, now=1.0) is None


class TestHistoryRing:
    def test_retention_evicts_oldest(self):
        reg = Registry()
        c = reg.counter("SeaweedFS_http_request_total", "", ("role",))
        h = MetricsHistory(reg, interval=1.0, slots=4)
        for i in range(8):
            c.labels("volume").inc()
            h.scrape_once(now=float(i))
        (series,) = [
            s for s in h.snapshot(family="SeaweedFS_http_request_total",
                                  window=1000, max_samples=100, now=7.0)
        ]
        ts = [t for t, _ in series["samples"]]
        assert len(ts) == 4 and ts[0] == 4.0 and ts[-1] == 7.0
        assert h.scrapes_total == 8

    def test_series_cap_counts_drops(self):
        reg = Registry()
        g = reg.gauge("SeaweedFS_volume_disk_free_bytes", "", ("dir",))
        for i in range(40):
            g.labels(f"/d{i}").set(i)
        h = MetricsHistory(reg, interval=1.0, slots=4, max_series=10)
        h.scrape_once(now=1.0)
        assert h.dropped_series_total > 0
        with h._lock:
            assert len(h._series) <= 10

    def test_cap_reclaims_vanished_series_for_live_newcomers(self):
        """At the series cap, a series that VANISHED from the registry (a
        stopped server's unregistered collector) is evicted — oldest
        first — to admit a live newcomer. A long-lived process with a
        churning fleet must not permanently lock dead series into the cap
        and refuse the series carrying a fresh alert signal (the exact
        mechanism behind the 5xx-burst acceptance flake in long suite
        runs: thousands of per-test server series filled the ring before
        the burst's new code=\"500\" series appeared)."""
        reg = Registry()
        dead = []

        def dead_lines():
            return dead

        col = reg.register_collector(
            dead_lines, names=["SeaweedFS_volume_disk_free_bytes"])
        dead = [
            f'SeaweedFS_volume_disk_free_bytes{{dir="/d{i}"}} {i}'
            for i in range(10)
        ]
        h = MetricsHistory(reg, interval=1.0, slots=8, max_series=10)
        h.scrape_once(now=100.0)
        with h._lock:
            assert len(h._series) == 10
        reg.unregister_collector(col)  # the "server" stops
        h.scrape_once(now=101.0)  # ring now knows the series vanished
        c = reg.counter("SeaweedFS_http_request_total", "", ("code",))
        c.labels("500").inc(50)
        h.scrape_once(now=102.0)
        # the newcomer was admitted by evicting a vanished series, was
        # zero-seeded (genuinely new), and rates immediately
        rates = dict(
            (labels["code"], rate)
            for labels, rate in h.rates(
                "SeaweedFS_http_request_total", 60, now=102.0)
        )
        assert rates["500"] == pytest.approx(50.0)
        # live series are never evicted: cap pressure with NO vanished
        # series still counts drops
        c.labels("200").inc()
        for code in range(10):
            c.labels(str(300 + code)).inc()
        before = h.dropped_series_total
        h.scrape_once(now=103.0)
        assert h.dropped_series_total > before
        with h._lock:
            assert ("SeaweedFS_http_request_total",
                    (("code", "500"),)) in h._series

    def test_new_counter_series_seeded_from_previous_scrape(self):
        # the first 5xx of a burst must produce a rate immediately: the
        # series was implicitly 0 at the previous scrape
        reg = Registry()
        c = reg.counter("SeaweedFS_http_request_total", "", ("code",))
        c.labels("200").inc()
        h = MetricsHistory(reg, interval=1.0, slots=8)
        h.scrape_once(now=100.0)
        c.labels("500").inc(50)
        h.scrape_once(now=110.0)
        rates = dict(
            (labels["code"], rate)
            for labels, rate in h.rates(
                "SeaweedFS_http_request_total", 60, now=110.0)
        )
        assert rates["500"] == pytest.approx(5.0)

    def test_late_admitted_series_not_zero_seeded(self):
        # a long-lived counter refused at the series cap and admitted
        # later (slots freed up) has an unknown prior value: zero-seeding
        # it would rate its whole cumulative history into one interval
        reg = Registry()
        filler = [f'SeaweedFS_volume_disk_free_bytes{{dir="/d{i}"}} 1'
                  for i in range(5)]
        big = ['SeaweedFS_volume_fastlane_bytes_total{op="read"} 1e12']
        lines = filler + big
        reg.register_collector(lambda: lines, names=())
        h = MetricsHistory(reg, interval=1.0, slots=4, max_series=5)
        h.scrape_once(now=100.0)  # fillers fill the cap; counter refused
        assert h.dropped_series_total >= 1
        lines = big  # fillers vanish; age the ring past retention
        del filler
        h.scrape_once(now=110.0)  # purges fillers (counter still refused)
        h.scrape_once(now=111.0)  # counter admitted — must NOT seed 0
        h.scrape_once(now=112.0)
        rates = [r for _, r in h.rates(
            "SeaweedFS_volume_fastlane_bytes_total", 60, now=112.0)]
        # no fabricated 1e12/s spike: the settled rate is the true delta
        assert rates == [0.0]

    def test_vanished_series_purged_and_latests_current_only(self):
        reg = Registry()
        col = reg.register_collector(
            lambda: ["SeaweedFS_master_stale_heartbeats"
                     '{node="n1"} 1'],
            names=("SeaweedFS_master_stale_heartbeats",),
        )
        h = MetricsHistory(reg, interval=1.0, slots=5)
        h.scrape_once(now=10.0)
        assert h.latests("SeaweedFS_master_stale_heartbeats")
        reg.unregister_collector(col)
        # one scrape later the series is no longer current...
        h.scrape_once(now=11.0)
        assert h.latests("SeaweedFS_master_stale_heartbeats") == []
        # ...and past the retention horizon it is gone entirely
        h.scrape_once(now=11.0 + h.retention_seconds + 1)
        assert "SeaweedFS_master_stale_heartbeats" not in h.families()

    def test_clear_wipes_samples(self):
        reg = Registry()
        reg.counter("SeaweedFS_http_request_total").inc()
        h = MetricsHistory(reg, interval=1.0, slots=4)
        h.scrape_once(now=1.0)
        h.clear()
        assert h.snapshot(window=1000, now=1.0) == []

    def test_self_metrics_on_registry(self):
        reg = Registry()
        h = MetricsHistory(reg, interval=1.0, slots=4)
        h.scrape_once(now=1.0)
        text = reg.render()
        assert "SeaweedFS_stats_history_scrapes_total 1" in text
        assert "SeaweedFS_stats_history_series" in text
        h.close()
        assert "SeaweedFS_stats_history_scrapes_total" not in reg.render()


def _engine(reg, **params):
    h = MetricsHistory(reg, interval=1.0, slots=16)
    eng = alerts_mod.AlertEngine(history=h, registry=reg, params=params)
    return h, eng


class TestAlertRules:
    def test_error_ratio_fires_and_recovers(self):
        reg = Registry()
        c = reg.counter("SeaweedFS_http_request_total", "",
                        ("role", "method", "code"))
        h, eng = _engine(reg)
        c.labels("volume", "GET", "200").inc(100)
        h.scrape_once(now=1000.0)  # listener evaluates on every scrape
        c.labels("volume", "GET", "200").inc(100)
        c.labels("volume", "GET", "500").inc(50)
        h.scrape_once(now=1010.0)
        assert "http_error_ratio" in eng.firing
        st = eng.firing["http_error_ratio"]
        assert st["severity"] == "critical" and "5xx" in st["detail"]
        # the same burst also trips the SLO burn rules (by design) —
        # edge accounting is asserted per rule via the counter metric
        edges = eng.fired_events
        assert edges >= 1
        text = reg.render()
        assert ('SeaweedFS_alerts_firing{alert="http_error_ratio",'
                'severity="critical"} 1') in text
        assert ('SeaweedFS_alerts_fired_total{alert="http_error_ratio",'
                'severity="critical"} 1') in text
        # burst ages out of the window -> clears, edge counters stay
        h.scrape_once(now=2000.0)
        h.scrape_once(now=2010.0)
        assert "http_error_ratio" not in eng.firing
        assert eng.fired_events == edges
        assert ('SeaweedFS_alerts_fired_total{alert="http_error_ratio",'
                'severity="critical"} 1') in reg.render()
        assert ('SeaweedFS_alerts_firing{alert="http_error_ratio",'
                'severity="critical"} 0') in reg.render()

    def test_few_stray_500s_below_min_rate_do_not_fire(self):
        reg = Registry()
        c = reg.counter("SeaweedFS_http_request_total", "",
                        ("role", "method", "code"))
        h, eng = _engine(reg)
        c.labels("volume", "GET", "200").inc(10)
        h.scrape_once(now=1000.0)
        c.labels("volume", "GET", "500").inc(3)  # 0.05/s over 60s
        h.scrape_once(now=1060.0)
        assert "http_error_ratio" not in eng.firing

    def test_heartbeat_stale_fires_from_master_gauge(self):
        reg = Registry()
        lines = [
            'SeaweedFS_master_stale_heartbeats{node="n1"} 1',
            'SeaweedFS_master_heartbeat_age_seconds{node="n1"} 17.5',
        ]
        reg.register_collector(lambda: lines,
                               names=("SeaweedFS_master_stale_heartbeats",))
        h, eng = _engine(reg)
        h.scrape_once(now=1000.0)
        st = eng.firing["heartbeat_stale"]
        assert st["severity"] == "critical"
        assert "n1" in st["detail"] and st["value"] == pytest.approx(17.5)
        # healthy again -> clears
        lines[:] = [
            'SeaweedFS_master_stale_heartbeats{node="n1"} 0',
            'SeaweedFS_master_heartbeat_age_seconds{node="n1"} 0.3',
        ]
        h.scrape_once(now=1010.0)
        assert "heartbeat_stale" not in eng.firing

    def test_disk_near_cap_fires(self):
        reg = Registry()
        g_used = reg.gauge("SeaweedFS_volume_disk_used_bytes", "",
                           ("server", "dir"))
        g_free = reg.gauge("SeaweedFS_volume_disk_free_bytes", "",
                           ("server", "dir"))
        g_used.labels("n1:8080", "/data").set(96e9)
        g_free.labels("n1:8080", "/data").set(4e9)
        h, eng = _engine(reg)
        h.scrape_once(now=1000.0)
        st = eng.firing["disk_near_cap"]
        assert st["severity"] == "critical" and "/data" in st["detail"]
        assert st["value"] == pytest.approx(96.0)

    def test_push_errors_climbing_fires_warning(self):
        reg = Registry()
        c = reg.counter("SeaweedFS_stats_push_errors_total", "", ("role",))
        h, eng = _engine(reg)
        c.labels("volume").inc()
        h.scrape_once(now=1000.0)
        c.labels("volume").inc(5)
        h.scrape_once(now=1010.0)
        assert eng.firing["metrics_push_errors"]["severity"] == "warning"

    def test_ec_pipeline_starvation_fires(self):
        reg = Registry()
        hist_m = reg.histogram("SeaweedFS_volume_ec_pipeline_seconds", "",
                               ("stage", "state"), buckets=(1.0,))
        h, eng = _engine(reg)
        hist_m.labels("read", "busy").observe(0.1)
        hist_m.labels("read", "wait").observe(0.1)
        h.scrape_once(now=1000.0)
        # over the next 10s the read stage waits 40s/s-equivalents vs
        # nearly no busy time: starved by its downstream neighbor
        hist_m.labels("read", "busy").observe(0.2)
        for _ in range(8):
            hist_m.labels("read", "wait").observe(5.0)
        h.scrape_once(now=1010.0)
        st = eng.firing["ec_pipeline_starved"]
        assert st["severity"] == "warning" and "read" in st["detail"]

    def test_fastlane_fallback_fires_on_pathological_reasons(self):
        """expected gate fallbacks (cache misses, auth'd requests)
        never fire; a sustained no_lease/backpressure/upstream regime —
        like r05's silently rejected filer lease — does."""
        reg = Registry()
        c = reg.counter("SeaweedFS_filer_fastlane_fallback_total", "",
                        ("server", "op", "reason"))
        h, eng = _engine(reg)
        c.labels("n1:1", "read", "cache_miss").inc(100)
        h.scrape_once(now=1000.0)
        c.labels("n1:1", "read", "cache_miss").inc(500)  # benign traffic
        c.labels("n1:1", "read", "auth").inc(500)
        h.scrape_once(now=1010.0)
        assert "fastlane_fallback" not in eng.firing
        c.labels("n1:1", "write", "no_lease").inc(200)  # 20/s > 1/s
        h.scrape_once(now=1020.0)
        st = eng.firing["fastlane_fallback"]
        assert st["severity"] == "warning"
        assert "no_lease" in st["detail"] and "filer" in st["detail"]
        # the regime ages out of the window -> clears
        h.scrape_once(now=2000.0)
        h.scrape_once(now=2010.0)
        assert "fastlane_fallback" not in eng.firing

    def test_configure_rejects_unknown_param(self):
        reg = Registry()
        _, eng = _engine(reg)
        with pytest.raises(ValueError):
            eng.configure(not_a_param=1)
        eng.configure(error_ratio=0.5)
        assert eng.params["error_ratio"] == 0.5

    def test_duplicate_rule_names_rejected(self):
        reg = Registry()
        h = MetricsHistory(reg, interval=1.0, slots=4)
        rules = alerts_mod.default_rules() + [alerts_mod.default_rules()[0]]
        with pytest.raises(ValueError):
            alerts_mod.AlertEngine(history=h, registry=reg, rules=rules)


@pytest.fixture(scope="class")
def three_role_cluster(tmp_path_factory):
    """master + volume + filer in one process, fastlane off so every
    request runs the Python (metered) path."""
    from seaweedfs_tpu_torch.server.filer import FilerServer
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume import VolumeServer

    prev = os.environ.get("SEAWEEDFS_TPU_DISABLE_FASTLANE")
    os.environ["SEAWEEDFS_TPU_DISABLE_FASTLANE"] = "1"
    tmp = tmp_path_factory.mktemp("histstack")
    master = MasterServer(port=0, pulse_seconds=1)
    master.start()
    vol = VolumeServer([str(tmp / "v0")], master.url, port=0,
                       pulse_seconds=1, max_volume_count=10, device="cpu")
    vol.start()
    filer = FilerServer(master.url, port=0, chunk_size_mb=1, device="cpu")
    filer.start()
    yield {"master": master, "volume": vol, "filer": filer}
    filer.stop()
    vol.stop()
    master.stop()
    if prev is None:
        os.environ.pop("SEAWEEDFS_TPU_DISABLE_FASTLANE", None)
    else:
        os.environ["SEAWEEDFS_TPU_DISABLE_FASTLANE"] = prev


def _wait_registered(env, want_filer=False, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            if env.servers() and (
                not want_filer
                or env.get(f"{env.master_url}/cluster/ps").get("filers")
            ):
                return
        except Exception:
            pass
        time.sleep(0.2)


class TestHistoryEndpoint:
    def test_history_route_serves_rates_and_samples(self, three_role_cluster):
        from seaweedfs_tpu_torch.server.httpd import get_json

        master = three_role_cluster["master"]
        hist = history_mod.default_history()
        hist.scrape_once()
        for _ in range(10):
            get_json(master.url + "/dir/status")
        time.sleep(0.25)
        hist.scrape_once()
        out = get_json(
            master.url + "/debug/metrics/history"
            "?family=SeaweedFS_http_request_total&window=600&samples=8"
        )
        assert out["slots"] == hist.slots and out["proc"]
        master_series = [s for s in out["series"]
                         if s["labels"].get("role") == "master"]
        assert master_series
        assert any(s["rate"] and s["rate"] > 0 for s in master_series)
        assert all(s["samples"] for s in master_series)
        # every role in the process serves the same ring (shared registry)
        vol = three_role_cluster["volume"]
        out2 = get_json(
            vol.service.url + "/debug/metrics/history"
            "?family=SeaweedFS_build_info&window=600"
        )
        roles = {s["labels"].get("role") for s in out2["series"]}
        assert {"master", "volume", "filer"} <= roles

    def test_process_identity_gauges_exported(self, three_role_cluster):
        from seaweedfs_tpu_torch.server.httpd import http_request
        from seaweedfs_tpu_torch.stats.metrics import PROCESS_START_TIME

        master = three_role_cluster["master"]
        _, _, body = http_request("GET", master.service.url + "/metrics")
        text = body.decode()
        # exact to the second: '{:g}' clipping would shift uptime by ~700s
        assert f"SeaweedFS_process_start_time_seconds " \
               f"{int(PROCESS_START_TIME)}" in text
        for role in ("master", "volume", "filer"):
            assert f'role="{role}"' in text and "SeaweedFS_build_info" in text

    def test_malformed_params_return_400(self, three_role_cluster):
        from seaweedfs_tpu_torch.server.httpd import http_request

        url = three_role_cluster["volume"].service.url
        for path in (
            "/debug/metrics/history?window=abc",
            "/debug/metrics/history?window=nan",
            "/debug/metrics/history?window=inf",
            "/debug/metrics/history?window=-5",
            "/debug/metrics/history?samples=many",
            "/debug/alerts?window=abc",
            "/debug/alerts?window=nan",
            "/debug/alerts?window=0",
        ):
            status, _, body = http_request("GET", url + path)
            assert status == 400, path
            assert b"error" in body, path


class TestClusterAcceptance:
    def test_cluster_top_once_renders_roles(self, three_role_cluster):
        from seaweedfs_tpu_torch.server.httpd import get_json
        from seaweedfs_tpu_torch.shell import CommandEnv, run_command

        master = three_role_cluster["master"]
        env = CommandEnv(master.url)
        _wait_registered(env, want_filer=True)
        hist = history_mod.default_history()
        hist.scrape_once()
        for _ in range(20):
            get_json(master.url + "/dir/status")
        time.sleep(0.25)
        hist.scrape_once()
        out = run_command(env, "cluster.top -once -window 600")
        lines = out.splitlines()
        assert "cluster.top @" in lines[0] and "process(es)" in lines[0]
        rows = {ln.split()[0]: ln.split() for ln in lines[2:]
                if ln and not ln.startswith((" ", "("))
                and ln.split()[0] in ("master", "volume", "filer")}
        assert set(rows) == {"master", "volume", "filer"}
        # per-role request rate and p99 rendered from the history ring
        assert float(rows["master"][1]) > 0
        assert rows["master"][3] != "n/a"
        import seaweedfs_tpu_torch

        assert seaweedfs_tpu_torch.__version__ in out  # build_info rode along
        assert "alert" in out  # firing list or "no alerts firing"

    def test_cluster_top_bad_flags(self, three_role_cluster):
        from seaweedfs_tpu_torch.shell import CommandEnv, run_command
        from seaweedfs_tpu_torch.shell.env import ShellError

        env = CommandEnv(three_role_cluster["master"].url)
        for line in (
            "cluster.top -once -interval banana",
            "cluster.top -once -window nan",
            "cluster.top -once -window inf",
            "cluster.top -once -interval 0",
        ):
            with pytest.raises(ShellError):
                run_command(env, line)

    def test_injected_5xx_burst_fires_everywhere(self, three_role_cluster):
        """Acceptance: an injected fault is visible in /debug/alerts, as
        SeaweedFS_alerts_firing on /metrics, in cluster.top, and flips
        cluster.check -fail to a nonzero exit."""
        import io

        from seaweedfs_tpu_torch.server.httpd import get_json, http_request
        from seaweedfs_tpu_torch.shell import CommandEnv, run_command
        from seaweedfs_tpu_torch.shell.env import ShellError
        from seaweedfs_tpu_torch.shell.shell import run_shell

        master = three_role_cluster["master"]
        vol = three_role_cluster["volume"]
        env = CommandEnv(master.url)
        _wait_registered(env)
        hist = history_mod.default_history()
        eng = alerts_mod.engine()
        # a narrow window so the burst is judged against the traffic of
        # THIS test, not whatever the rest of the suite did in the last
        # minute (in-suite, that dilutes the ratio below threshold)
        saved_window = eng.params["window"]
        eng.configure(window=10.0)
        try:
            hist.scrape_once()
            # the fault: a 5xx burst on the volume role's request counter
            vol.service._m_total.labels("volume", "GET", "500").inc(300)
            time.sleep(0.05)
            hist.scrape_once()
            # /debug/alerts (every role serves it)
            out = get_json(vol.service.url + "/debug/alerts")
            byname = {a["name"]: a for a in out["alerts"]}
            assert byname["http_error_ratio"]["firing"]
            assert byname["http_error_ratio"]["severity"] == "critical"
            assert "5xx" in byname["http_error_ratio"]["detail"]
            assert out["firing"] >= 1
            # /metrics
            _, _, body = http_request("GET", master.service.url + "/metrics")
            assert (b'SeaweedFS_alerts_firing{alert="http_error_ratio",'
                    b'severity="critical"} 1') in body
            # cluster.top shows it (same narrow window: its -window flag
            # rides into each node's /debug/alerts evaluation)
            top = run_command(env, "cluster.top -once -window 10")
            assert "http_error_ratio" in top
            # cluster.check: renders it, and -fail exits nonzero
            report = run_command(env, "cluster.check")
            assert "http_error_ratio" in report and "critical" in report
            with pytest.raises(ShellError, match="http_error_ratio"):
                run_command(env, "cluster.check -fail")
            buf = io.StringIO()
            rc = run_shell(master.url, script="cluster.check -fail", out=buf)
            assert rc == 1 and "http_error_ratio" in buf.getvalue()
        finally:
            # neutralize the injected fault: later tests (and the rest of
            # the tier-1 suite) must see a quiet window
            eng.configure(window=saved_window)
            hist.clear()
            eng.evaluate()
        assert "http_error_ratio" not in eng.firing


@pytest.fixture(autouse=True, scope="module")
def _stop_port_history_loop():
    """The port's metered servers start the process's history loop; stop it
    when this module is done, so no thread of this file outlives it."""
    yield
    from seaweedfs_tpu_torch.stats import history

    history.default_history().stop()
