"""Durable telemetry store of the port: the JAX package's
tests/test_telemetry_store.py over seaweedfs_tpu_torch (torn-tail replay,
the crash between flush and rename, rollup math, eviction order, counter
rates across a restart, the post-mortem `cluster.why` / `cluster.top`
paths that read a process that is still dead), then parity cases.

Parity (exact equality): records byte-equal to the JAX package's
(`magic | len | crc32c` then the JSON payload); the same samples and
events under one frozen clock leave byte-equal spools; a spool written by
either package reads back the same through both packages' `read_events`,
`read_series` and `spool_info`; and `cluster.top -spool` / `cluster.why
-spool` give the JAX shell's output on one stub endpoint and one spool.
"""

import json
import os

import pytest

from seaweedfs_tpu_torch.stats import store as store_mod
from seaweedfs_tpu_torch.stats.events import EventRecorder
from seaweedfs_tpu_torch.stats.history import MetricsHistory
from seaweedfs_tpu_torch.stats.metrics import Registry
from seaweedfs_tpu_torch.stats.store import (
    TelemetryStore,
    _encode_record,
    _segment_files,
    _TierWriter,
    iter_segment_records,
)

BASE = 1_754_000_400.0  # multiple of 600: rollup buckets land on edges


def make_store(tmp_path, reg=None, hist=None, rec=None, **kw):
    reg = Registry() if reg is None else reg
    hist = MetricsHistory(registry=reg) if hist is None else hist
    rec = EventRecorder() if rec is None else rec
    st = TelemetryStore(str(tmp_path), history=hist, recorder=rec,
                        registry=reg, **kw)
    return st, reg, hist, rec


class TestTornTail:
    def test_truncated_record_stops_at_valid_prefix(self, tmp_path):
        seg = tmp_path / "raw-0000000001.seg"
        recs = [_encode_record({"i": i, "pad": "x" * 64}) for i in range(3)]
        blob = b"".join(recs)
        # crash mid-append: the third record's body is half-written
        seg.write_bytes(blob[:len(recs[0]) + len(recs[1])
                             + len(recs[2]) // 2])
        got = list(iter_segment_records(str(seg)))
        assert [r["i"] for r in got] == [0, 1]

    def test_corrupt_crc_stops_not_raises(self, tmp_path):
        seg = tmp_path / "raw-0000000001.seg"
        recs = [_encode_record({"i": i}) for i in range(3)]
        blob = bytearray(b"".join(recs))
        # flip a byte inside record 1's body (12-byte header, then json)
        blob[len(recs[0]) + 12 + 2] ^= 0xFF
        seg.write_bytes(bytes(blob))
        got = list(iter_segment_records(str(seg)))
        assert [r["i"] for r in got] == [0]

    def test_torn_header_and_empty_file(self, tmp_path):
        seg = tmp_path / "raw-0000000001.seg"
        seg.write_bytes(_encode_record({"i": 0}) + b"\x00\x01\x02")
        assert [r["i"] for r in iter_segment_records(str(seg))] == [0]
        empty = tmp_path / "raw-0000000002.seg"
        empty.write_bytes(b"")
        assert list(iter_segment_records(str(empty))) == []

    def test_replay_survives_torn_tail(self, tmp_path):
        st, reg, hist, rec = make_store(tmp_path)
        g = reg.gauge("SeaweedFS_test_depth", "", ("q",)).labels("a")
        for i in range(5):
            g.set(float(i))
            hist.scrape_once(now=BASE + 5 * i)
        rec.record("task_queued", volume=3)
        st.flush_once(force=True)
        st.close()
        # tear the sealed raw segment mid-record
        raw = _segment_files(str(tmp_path / "metrics"), "raw")
        assert raw
        blob = open(raw[-1], "rb").read()
        open(raw[-1], "wb").write(blob[:-3])
        st2, _, hist2, rec2 = make_store(tmp_path)
        out = st2.replay()
        # the torn record was the only raw record -> zero samples, but
        # replay neither raises nor loses the (separate) event journal
        assert out["events"] == 1
        assert rec2.events(volume=3)


class TestKillBetweenFlushAndRename:
    def test_dead_open_segment_is_adopted_and_replayed(self, tmp_path):
        st, reg, hist, rec = make_store(tmp_path)
        g = reg.gauge("SeaweedFS_test_depth", "", ("q",)).labels("a")
        for i in range(4):
            g.set(10.0 * i)
            hist.scrape_once(now=BASE + 5 * i)
        rec.record("fault_injected", volume=9)
        st.flush_once(force=True)
        # kill -9: no close(), no roll() — the `.open` tail stays behind
        opens = [p for p in _segment_files(str(tmp_path / "metrics"), "raw")
                 if p.endswith(".open")]
        assert opens, "flush without close must leave an .open segment"
        del st

        st2, _, hist2, rec2 = make_store(tmp_path)
        out = st2.replay()
        # the registry self-scrapes its own telemetry families too, so
        # assert on OUR series, not the total
        assert out["samples"] >= 4
        assert out["events"] == 1
        # adoption sealed the dead tail and continued the seq counter
        files = _segment_files(str(tmp_path / "metrics"), "raw")
        assert files and all(p.endswith(".seg") for p in files)
        g2 = hist2.latests("SeaweedFS_test_depth", require_current=False)
        assert g2 and g2[0][1] == 30.0

    def test_new_writer_never_reuses_a_dead_seq(self, tmp_path):
        w = _TierWriter(str(tmp_path), "raw", cap_bytes=1 << 20)
        w.append(_encode_record({"i": 1}))
        # crash: leave the .open behind
        os.close(w._fd)
        w._fd = None
        w2 = _TierWriter(str(tmp_path), "raw", cap_bytes=1 << 20)
        w2.append(_encode_record({"i": 2}))
        w2.close()
        names = sorted(os.path.basename(p) for p in
                       _segment_files(str(tmp_path), "raw"))
        assert names == ["raw-0000000001.seg", "raw-0000000002.seg"]
        got = [r["i"] for p in _segment_files(str(tmp_path), "raw")
               for r in iter_segment_records(p)]
        assert got == [1, 2]


class TestRollupMath:
    def test_1m_mean_max_count_vs_hand_computed(self, tmp_path):
        st, _, _, _ = make_store(tmp_path)
        fam = "SeaweedFS_test_depth"
        samples = [(BASE + 0, fam, {"q": "a"}, 10.0),
                   (BASE + 20, fam, {"q": "a"}, 30.0),
                   (BASE + 40, fam, {"q": "a"}, 20.0),
                   # next bucket: closes [BASE, BASE+60)
                   (BASE + 61, fam, {"q": "a"}, 99.0)]
        recs = st._fold_rollups(samples)
        rolls = [json.loads(r[12:])  # skip the 12-byte record header
                 for tier, r in recs if tier == "1m"]
        assert len(rolls) == 1
        roll = rolls[0]
        assert roll["t0"] == BASE and roll["t1"] == BASE + 60
        (f, labels, mean, mx, n, last), = roll["s"]
        assert f == fam and labels == {"q": "a"}
        assert mean == pytest.approx((10.0 + 30.0 + 20.0) / 3)
        assert mx == 30.0 and n == 3 and last == 20.0

    def test_10m_folds_1m_buckets_weighted_by_count(self, tmp_path):
        st, _, _, _ = make_store(tmp_path)
        fam = "SeaweedFS_test_depth"
        samples = []
        # minute 0: values 0,60 (mean 30, n=2); minute 1: 10 (n=1) ...
        for m, vals in enumerate(([0.0, 60.0], [10.0], [20.0, 40.0])):
            for j, v in enumerate(vals):
                samples.append((BASE + 60 * m + 10 * j, fam, {}, v))
        # two samples past the 10m edge: the first opens minute 10, the
        # second closes it — only a CLOSED 1m bucket reaches the 10m
        # fold, and its midpoint past the edge closes the 10m bucket
        samples.append((BASE + 601, fam, {}, 7.0))
        samples.append((BASE + 661, fam, {}, 8.0))
        recs = st._fold_rollups(samples)
        ten = [json.loads(r[12:]) for tier, r in recs if tier == "10m"]
        assert len(ten) == 1
        (f, _labels, mean, _mx, n, _last), = ten[0]["s"]
        # weighted: (30*2 + 10*1 + 30*2) / 5
        assert n == 5
        assert mean == pytest.approx((30.0 * 2 + 10.0 + 30.0 * 2) / 5)

    def test_rollups_round_trip_through_read_series(self, tmp_path):
        st, reg, hist, _ = make_store(tmp_path)
        g = reg.gauge("SeaweedFS_test_depth", "", ()).labels()
        for i in range(13):  # 13 scrapes, 5s apart: crosses one 1m edge
            g.set(float(i))
            hist.scrape_once(now=BASE + 5 * i)
        st.flush_once(force=True)
        st.close()
        series = store_mod.read_series(str(tmp_path), "SeaweedFS_test_depth",
                                       tiers=("1m",))
        (key, pts), = series.items()
        assert key[0] == "SeaweedFS_test_depth"
        # first full minute: values 0..11, mean 5.5 at the bucket midpoint
        assert pts[0] == (pytest.approx(BASE + 30), pytest.approx(5.5))


class TestRetentionEviction:
    def test_oldest_sealed_evicted_first_active_never(self, tmp_path):
        cap = 3 * 4096  # segment_bytes clamps to 4096 minimum
        w = _TierWriter(str(tmp_path), "raw", cap_bytes=cap,
                        segment_bytes=4096)
        for i in range(50):
            w.append(_encode_record({"i": i, "pad": "x" * 500}))
        files = _segment_files(str(tmp_path), "raw")
        seqs = [int(os.path.basename(p).split("-")[1].split(".")[0])
                for p in files]
        assert seqs == sorted(seqs) and min(seqs) > 1
        assert files[-1].endswith(".open")  # the active tail survives
        assert w.evicted_total > 0
        assert w.total_bytes() <= cap
        # survivors are the NEWEST contiguous suffix of what was written
        got = [r["i"] for p in files for r in iter_segment_records(p)]
        assert got == list(range(got[0], 50))

    def test_store_export_spool_gauges(self, tmp_path):
        st, reg, hist, rec = make_store(tmp_path)
        g = reg.gauge("SeaweedFS_test_depth", "", ()).labels()
        g.set(1.0)
        hist.scrape_once(now=BASE)
        rec.record("task_queued", volume=1)
        st.flush_once(force=True)
        spool = st.spool_bytes()
        assert spool["raw"] > 0 and spool["events"] > 0
        rendered = reg.render()
        assert 'SeaweedFS_telemetry_spool_bytes{tier="raw"}' in rendered
        assert 'SeaweedFS_telemetry_spool_cap_bytes{tier="raw"}' in rendered


class TestCounterRateContinuity:
    def test_no_phantom_spike_across_restart(self, tmp_path):
        fam = "SeaweedFS_http_request_total"
        st, reg, hist, _ = make_store(tmp_path)
        c = reg.counter(fam, "", ("role", "code")).labels("volume", "200")
        for i in range(1, 11):  # counter reaches 1000 by BASE+50
            c.inc(100)
            hist.scrape_once(now=BASE + 5 * i)
        st.flush_once(force=True)
        st.close()

        # restart: fresh registry, counter starts over from zero
        reg2 = Registry()
        hist2 = MetricsHistory(registry=reg2)
        st2, _, _, _ = make_store(tmp_path, reg=reg2, hist=hist2)
        st2.replay()
        c2 = reg2.counter(fam, "", ("role", "code")).labels("volume", "200")
        c2.inc(100)
        hist2.scrape_once(now=BASE + 60)
        (labels, rate), = hist2.rates(fam, window=120.0, now=BASE + 60)
        # pre-crash 900 over 45s + reset-clamped 100 after = 1000/55s.
        # A phantom spike would double-count the replayed 1000; a phantom
        # RESET (zero-seeded fresh series) would miss the pre-crash slope.
        assert rate == pytest.approx(1000.0 / 55.0, rel=1e-6)

    def test_preload_sets_watermark_no_zero_seed(self, tmp_path):
        fam = "SeaweedFS_http_request_total"
        st, reg, hist, _ = make_store(tmp_path)
        c = reg.counter(fam, "", ("role",)).labels("volume")
        c.inc(50)
        hist.scrape_once(now=BASE + 5)
        st.flush_once(force=True)
        st.close()
        hist2 = MetricsHistory(registry=Registry())
        st2, _, _, _ = make_store(tmp_path, hist=hist2)
        st2.replay()
        assert hist2.last_scrape == pytest.approx(BASE + 5)
        snap = hist2.snapshot(fam, window=3600.0, now=BASE + 6)
        assert snap and snap[0]["samples"] == [[BASE + 5, 50.0]]


class TestEventJournal:
    def test_events_replay_merges_and_continues_seq(self, tmp_path):
        st, _, hist, rec = make_store(tmp_path)
        for i in range(5):
            rec.record("fault_injected", volume=7, n=i)
        st.flush_once(force=True)
        st.close()
        rec2 = EventRecorder()
        st2, _, _, _ = make_store(tmp_path, rec=rec2)
        out = st2.replay()
        assert out["events"] == 5
        # live events after replay never collide with replayed seqs
        ev = rec2.record("degraded_read", volume=7)
        seqs = [e["seq"] for e in rec2.events()]
        assert len(seqs) == len(set(seqs)) == 6
        assert ev.seq == max(seqs)

    def test_events_since_cursor_is_strict(self):
        rec = EventRecorder()
        rec.preload([
            {"type": "task_queued", "seq": 1, "ts": 100.0, "mono": 1.0},
            {"type": "task_done", "seq": 2, "ts": 101.0, "mono": 2.0},
        ])
        # a poller passing the watermark back must not re-receive the
        # watermark event itself (strict >, like the history cursor)
        assert [e["seq"] for e in rec.events(since=100.0)] == [2]
        assert rec.last_wall == 101.0
        assert rec.events(since=rec.last_wall) == []


class TestPostMortemClusterWhy:
    """Acceptance: a dead process's spool resolves the causal chain."""

    class DeadEnv:
        master_url = "http://127.0.0.1:1"
        filer_url = None

        def servers(self):
            raise OSError("cluster is dead")

        def get(self, url, timeout=None):
            raise OSError("cluster is dead")

    def _make_dead_spool(self, tmp_path):
        st, _, hist, rec = make_store(tmp_path)
        rec.record("fault_injected", volume=11,
                   point="volume.read", mode="io_error")
        rec.record("degraded_read", volume=11, trace_id="abc123",
                   reason="crc_mismatch")
        rec.record("task_queued", volume=11, task="ec_repair")
        st.flush_once(force=True)
        # kill -9: no close()
        del st

    def test_why_resolves_chain_from_dead_spool(self, tmp_path):
        from seaweedfs_tpu_torch.shell.commands_cluster import cmd_cluster_why

        self._make_dead_spool(tmp_path)
        out = cmd_cluster_why(self.DeadEnv(), ["11", "-spool",
                                               str(tmp_path)])
        # the pre-crash causal chain, in order, from the journal alone
        assert "fault_injected" in out
        assert "degraded_read" in out
        assert "task_queued" in out
        assert out.index("fault_injected") < out.index("degraded_read") \
            < out.index("task_queued")
        assert "1 process(es)" in out.splitlines()[0]

    def test_why_out_writes_json_timeline(self, tmp_path):
        from seaweedfs_tpu_torch.shell.commands_cluster import cmd_cluster_why

        self._make_dead_spool(tmp_path)
        dump = tmp_path / "why.json"
        out = cmd_cluster_why(
            self.DeadEnv(),
            ["11", "-spool", str(tmp_path), "-out", str(dump)])
        assert str(dump) in out
        doc = json.loads(dump.read_text())
        assert doc["kind"] == "volume" and doc["target"] == "11"
        assert [e["type"] for e in doc["events"]] == [
            "fault_injected", "degraded_read", "task_queued"]

    def test_top_spool_section_reports_dead_rates(self, tmp_path):
        from seaweedfs_tpu_torch.shell.commands_cluster import cmd_cluster_top

        st, reg, hist, _ = make_store(tmp_path)
        c = reg.counter("SeaweedFS_http_request_total", "",
                        ("role", "code")).labels("volume", "200")
        for i in range(1, 11):
            c.inc(10)
            hist.scrape_once(now=BASE + 5 * i)
        st.flush_once(force=True)
        del st  # dead
        snap_file = tmp_path / "top.json"
        out = cmd_cluster_top(
            self.DeadEnv(),
            ["-spool", str(tmp_path), "-snapshot", str(snap_file)])
        assert "post-mortem spool" in out
        snap = json.loads(snap_file.read_text())
        # 10 req / 5 s = 2/s from the dead spool's counters
        assert snap["spool"]["req_rates"]["volume"] == pytest.approx(2.0)
        assert snap["spool"]["tiers"]["raw"]["bytes"] > 0


class TestForecastTiers:
    def test_forecast_points_replayed_from_1m_tier(self, tmp_path):
        fam = "SeaweedFS_volume_disk_used_bytes"
        st, reg, hist, _ = make_store(tmp_path)
        g = reg.gauge(fam, "", ("server", "dir")).labels("v1", "/d")
        for i in range(25):  # two full minutes of 5s samples
            g.set(1000.0 + 10.0 * i)
            hist.scrape_once(now=BASE + 5 * i)
        st.flush_once(force=True)
        st.close()
        st2, _, _, _ = make_store(tmp_path)
        st2.replay()
        pts = st2.forecast_points(fam)
        key = (("dir", "/d"), ("server", "v1"))
        assert key in pts and len(pts[key]) >= 2
        ts = [t for t, _ in pts[key]]
        assert ts == sorted(ts)


# --- parity with the JAX package --------------------------------------------
import time  # noqa: E402

import numpy as np  # noqa: E402

import seaweedfs_tpu.stats.events as ref_events  # noqa: E402
import seaweedfs_tpu.stats.history as ref_history  # noqa: E402
import seaweedfs_tpu.stats.metrics as ref_metrics  # noqa: E402
import seaweedfs_tpu.stats.store as ref_store  # noqa: E402

from seaweedfs_tpu_torch.stats import events as events_mod  # noqa: E402
from seaweedfs_tpu_torch.stats import history as history_mod  # noqa: E402
from seaweedfs_tpu_torch.stats import metrics as metrics_mod  # noqa: E402

SEED = 20261018
PKGS = {
    "ref": (ref_metrics, ref_history, ref_events, ref_store),
    "port": (metrics_mod, history_mod, events_mod, store_mod),
}


def test_records_byte_equal_reference():
    rng = np.random.default_rng(SEED)
    payloads = [{"t": "s", "ts": BASE + i, "v": float(rng.random()),
                 "labels": {"role": "filer", "code": str(200 + i % 3)},
                 "pad": "x" * int(rng.integers(0, 300)), "uni": "é✓"}
                for i in range(50)]
    for p in payloads:
        assert _encode_record(p) == ref_store._encode_record(p)
    assert _encode_record(payloads[0])[:4] == ref_store._encode_record(
        payloads[0])[:4]


class FrozenClock:
    """The `time` of the event and store modules under test: wall clock,
    monotonic clock and the flush timer all read one settable instant (the
    flush and replay timers land in the records). Patched into those
    modules only, so no other thread of the process sees it."""

    def __init__(self, now: float) -> None:
        self.now = now

    def time(self) -> float:
        return self.now

    def monotonic(self) -> float:
        return self.now - BASE

    perf_counter = monotonic


def _write_spool(pkg: str, path: str, monkeypatch) -> None:
    """The same samples and events through one package's store, under a
    frozen clock; the store dies without close() (kill -9)."""
    metrics, history, events, store = PKGS[pkg]
    clock = FrozenClock(BASE + 0.5)
    monkeypatch.setattr(events, "time", clock)
    monkeypatch.setattr(store, "time", clock)
    reg = metrics.Registry()
    hist = history.MetricsHistory(registry=reg)
    rec = events.EventRecorder()
    rec.enable()
    st = store.TelemetryStore(path, history=hist, recorder=rec, registry=reg)
    rng = np.random.default_rng(SEED)
    req = reg.counter("SeaweedFS_http_request_total", "", ("role", "code"))
    used = reg.gauge("SeaweedFS_volume_disk_used_bytes", "", ("server", "dir"))
    for i in range(1, 61):
        clock.now = BASE + 5 * i
        req.labels("volume", "200").inc(int(rng.integers(1, 40)))
        req.labels("filer", "500").inc(int(rng.integers(0, 3)))
        used.labels("v1", "/d").set(1e6 + 4096.0 * i)
        hist.scrape_once(now=clock.now)
        if i % 7 == 0:
            rec.record("fault_injected", volume=11, point="volume.read",
                       mode="io_error")
            rec.record("degraded_read", volume=11, reason="crc_mismatch",
                       collection="acme")
        if i % 20 == 0:
            st.flush_once(force=True)
    st.flush_once(force=True)
    monkeypatch.undo()


def _tree(path) -> dict:
    out = {}
    for root, _, files in os.walk(path):
        for fn in files:
            full = os.path.join(root, fn)
            with open(full, "rb") as f:
                out[os.path.relpath(full, path)] = f.read()
    return out


def _reads(store, path) -> dict:
    return {
        "events": store.read_events(path),
        "events_typed": store.read_events(path, type="degraded_read"),
        "series": store.read_series(path, "SeaweedFS_http_request_total",
                                    tiers=("raw", "1m")),
        "series_all": store.read_series(path),
        "info": store.spool_info(path),
    }


def test_spools_byte_equal_and_read_across_packages(tmp_path, monkeypatch):
    dirs = {pkg: str(tmp_path / pkg) for pkg in PKGS}
    for pkg, path in dirs.items():
        _write_spool(pkg, path, monkeypatch)
    assert _tree(dirs["port"]) == _tree(dirs["ref"])
    assert any(k.startswith("events") for k in _tree(dirs["port"]))
    for path in dirs.values():
        ours, ref = _reads(store_mod, path), _reads(ref_store, path)
        assert ours == ref
        assert ours["events"] and ours["series"] and ours["info"]["raw"]["bytes"]


class _DeadStub:
    """A dead cluster's master address: every fetch fails."""

    def __init__(self) -> None:
        import socket

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        self.url = f"http://127.0.0.1:{s.getsockname()[1]}"
        s.close()


@pytest.mark.parametrize("line", [
    "cluster.why 11 -spool {spool}",
    "cluster.why acme -spool {spool}",
    "cluster.why 11 -spool {spool},{spool}",
    "cluster.top -once -spool {spool}",
])
def test_spool_verbs_equal_reference(tmp_path, monkeypatch, line):
    from seaweedfs_tpu.shell import CommandEnv as RefCommandEnv
    from seaweedfs_tpu.shell import run_command as ref_run_command
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    from tests.test_torch_usage_heat import JsonStub

    spool = str(tmp_path / "spool")
    _write_spool("ref", spool, monkeypatch)
    line = line.format(spool=spool)
    for url_of in (lambda: _DeadStub().url, None):
        stub = None
        if url_of is None:
            stub = JsonStub({})
            url = stub.url
        else:
            url = url_of()
        try:
            want = ref_run_command(RefCommandEnv(url), line)
            got = run_command(CommandEnv(url), line)
        finally:
            if stub is not None:
                stub.stop()
        assert got == want
        assert "post-mortem spool" in got or "degraded_read" in got


def test_spool_snapshot_and_out_equal_reference(tmp_path, monkeypatch):
    from seaweedfs_tpu.shell import CommandEnv as RefCommandEnv
    from seaweedfs_tpu.shell import run_command as ref_run_command
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command

    spool = str(tmp_path / "spool")
    _write_spool("port", spool, monkeypatch)
    url = _DeadStub().url
    docs = {}
    for name, env, run in (("ref", RefCommandEnv(url), ref_run_command),
                           ("port", CommandEnv(url), run_command)):
        why, top = tmp_path / f"{name}-why.json", tmp_path / f"{name}-top.json"
        run(env, f"cluster.why 11 -spool {spool} -out {why}")
        run(env, f"cluster.top -once -spool {spool} -snapshot {top}")
        docs[name] = (json.loads(why.read_text()), json.loads(top.read_text()))
    (rwhy, rtop), (pwhy, ptop) = docs["ref"], docs["port"]
    assert pwhy == rwhy
    for snap in (rtop, ptop):
        snap.pop("ts", None)
    assert ptop == rtop
    assert ptop["spool"]["req_rates"]


@pytest.fixture(autouse=True, scope="module")
def _stop_port_threads():
    """No store flusher or history loop of this module outlives it."""
    yield
    store_mod.disable()
    history_mod.default_history().stop()
