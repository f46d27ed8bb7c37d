"""Durable telemetry: on-disk downsampled metrics + crash-safe event journal.

Every other observability layer (the history ring, the flight recorder,
usage/heat, the cluster plane) is process-lifetime-only:
a crashed process loses exactly the telemetry its post-mortem needs, and
`SeaweedFS_node_days_to_full` extrapolates *days* from *ten minutes* of
in-memory slope. This module is the persistence leg:

  * **Segments.** CRC'd, append-only segment files under
    `<dir>/{metrics,events}/` — each record is a 12-byte header
    (magic u32 | payload len u32 | crc32c u32) + a JSON payload. Replay
    stops at the first torn record (bad magic, short read, CRC
    mismatch): in an append-only file a torn record is always the tail a
    crash mid-append left, so everything before it is intact — the same
    last-valid-wins discipline as the `.ecp` parity journal
    (storage/erasure_coding/online.py). The active segment is written as
    `*.open` and sealed to `*.seg` on roll; a kill -9 between flush and
    rename just leaves an `.open` tail that the next replay (or a
    post-mortem reader) consumes identically.

  * **Tiers.** Raw history samples (the 5s self-scrape) land in the
    `raw` tier; the flusher folds them into 1-minute and 10-minute
    rollup buckets (per-series mean/max/count/last), so hours-to-days of
    signal survive in a few MB. Each tier has a byte cap carved from
    `-telemetry.retention`; oldest sealed segments are evicted first, so
    the spool can never fill the disk, and
    `SeaweedFS_telemetry_spool_bytes{tier}` exports what it holds.

  * **Pull, don't push.** The hot paths are untouched: `events.emit` and
    the scrape loop never see the store. A background flusher *pulls*
    from the in-memory rings (history samples past a timestamp
    watermark, events past a seq watermark) — the rings are the buffer,
    and a deferred flush just leaves the watermarks where they were.
    Ring eviction during a long deferral is counted
    (`SeaweedFS_telemetry_events_lost_total`), never silent. Writes ride
    a token bucket (the arXiv:1207.6744 background-never-starves-
    foreground rule the repair throttle follows); bench.py bounds the
    native-write-path overhead at <3%.

  * **Replay.** On restart the store replays its tail: raw samples
    preload the history ring (so `/debug/metrics/history` serves
    pre-crash rates seamlessly — `counter_rate`'s reset clamp keeps the
    restart from manufacturing a phantom spike), events preload the
    flight recorder (seq continuity preserved), and 1m rollups of the
    forecast families rebuild the long-window cache the capacity
    forecast fits its OLS slope on (stats/heat.py).

  * **Post-mortem.** `read_events` / `read_series` / `spool_info` read a
    spool directory with no live process at all — `cluster.why -spool`
    and `cluster.top -spool` resolve causal chains and rate history for
    a process that is still dead.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time

from seaweedfs_tpu_torch.storage import crc as crc_mod

# record header: magic u32 | payload length u32 | crc32c(payload) u32
_REC_HDR = struct.Struct("<III")
_REC_MAGIC = 0x53575453  # "SWTS": SeaWeed Telemetry Segment
# refuse absurd lengths during replay: a corrupt length field must not
# make the reader allocate gigabytes before the CRC gets a say
_MAX_RECORD = 8 << 20

DEFAULT_RETENTION_MB = float(
    os.environ.get("SEAWEEDFS_TPU_TELEMETRY_RETENTION_MB", "64")
)
# flusher token bucket: sustained spool write rate + burst. Small on
# purpose — telemetry is background work and must never starve the
# foreground disk (the repair-throttle rule, arXiv:1207.6744).
DEFAULT_RATE_MB_S = 2.0
DEFAULT_BURST_MB = 1.0
DEFAULT_FLUSH_INTERVAL = 1.0
DEFAULT_SEGMENT_BYTES = 1 << 20

# (tier name, segment file prefix, share of the retention budget)
TIERS = (
    ("raw", "raw", 0.25),
    ("1m", "m1", 0.25),
    ("10m", "m10", 0.25),
    ("events", "ev", 0.25),
)
ROLLUP_SECONDS = {"1m": 60.0, "10m": 600.0}

# families whose 1m rollups feed the long-window capacity forecast
# (stats/heat.py fits days-to-full on these); the in-memory cache keeps
# up to 48h of 1m buckets per series
FORECAST_FAMILIES = ("SeaweedFS_volume_disk_used_bytes",)
FORECAST_CACHE_SLOTS = 2880

TELEMETRY_FAMILIES = (
    "SeaweedFS_telemetry_spool_bytes",
    "SeaweedFS_telemetry_spool_cap_bytes",
    "SeaweedFS_telemetry_flush_seconds",
    "SeaweedFS_telemetry_replay_seconds",
    "SeaweedFS_telemetry_segments_evicted_total",
    "SeaweedFS_telemetry_flush_deferrals_total",
    "SeaweedFS_telemetry_events_lost_total",
)

_metrics_cache = None


def ensure_metrics(registry=None):
    """Register (idempotently) the telemetry self-accounting families;
    returns (spool_bytes, spool_cap, flush_seconds, replay_seconds,
    evicted_total, deferrals_total, events_lost_total)."""
    global _metrics_cache
    if registry is None and _metrics_cache is not None:
        return _metrics_cache
    from seaweedfs_tpu_torch.stats.metrics import default_registry

    reg = registry if registry is not None else default_registry()
    out = (
        reg.gauge(
            "SeaweedFS_telemetry_spool_bytes",
            "on-disk telemetry spool size by tier",
            ("tier",),
        ),
        reg.gauge(
            "SeaweedFS_telemetry_spool_cap_bytes",
            "per-tier spool byte cap (-telemetry.retention share)",
            ("tier",),
        ),
        reg.histogram(
            "SeaweedFS_telemetry_flush_seconds",
            "per-cycle spool flush seconds (segment appends + rollups)",
        ),
        reg.histogram(
            "SeaweedFS_telemetry_replay_seconds",
            "startup spool replay seconds (tail -> rings)",
        ),
        reg.counter(
            "SeaweedFS_telemetry_segments_evicted_total",
            "oldest sealed segments evicted to hold the tier cap",
            ("tier",),
        ),
        reg.counter(
            "SeaweedFS_telemetry_flush_deferrals_total",
            "flush cycles deferred by the token bucket",
        ),
        reg.counter(
            "SeaweedFS_telemetry_events_lost_total",
            "events evicted from the ring before the flusher persisted them",
        ),
    )
    if registry is None:
        _metrics_cache = out
    return out


# --- segment encode/decode -------------------------------------------------

def _encode_record(payload: dict) -> bytes:
    body = json.dumps(payload, separators=(",", ":"),
                      allow_nan=False).encode()
    return _REC_HDR.pack(_REC_MAGIC, len(body),
                         crc_mod.crc32c(body)) + body


def iter_segment_records(path: str):
    """Yield decoded payload dicts from one segment file, stopping at the
    first torn record — in an append-only segment that is always the
    tail a crash mid-append left, so the prefix is intact."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return
    off, n = 0, len(blob)
    while off + _REC_HDR.size <= n:
        magic, length, crc = _REC_HDR.unpack_from(blob, off)
        if magic != _REC_MAGIC or length > _MAX_RECORD:
            return  # torn/corrupt header: everything before it is valid
        body = blob[off + _REC_HDR.size:off + _REC_HDR.size + length]
        if len(body) < length or crc_mod.crc32c(body) != crc:
            return  # torn tail (crash mid-append): stop
        try:
            yield json.loads(body)
        except ValueError:
            return
        off += _REC_HDR.size + length


def _segment_files(dirpath: str, prefix: str) -> list[str]:
    """Sealed + open segments of one tier, oldest first (seq order; a
    dead process's `.open` tail sorts after its sealed segments)."""
    try:
        names = os.listdir(dirpath)
    except OSError:
        return []
    segs = []
    for name in names:
        if not name.startswith(prefix + "-"):
            continue
        if not (name.endswith(".seg") or name.endswith(".open")):
            continue
        try:
            seq = int(name.split("-", 1)[1].split(".", 1)[0])
        except ValueError:
            continue
        segs.append((seq, os.path.join(dirpath, name)))
    segs.sort()
    return [p for _, p in segs]


def iter_tier_records(dirpath: str, prefix: str):
    for path in _segment_files(dirpath, prefix):
        yield from iter_segment_records(path)


class _TierWriter:
    """Append-only segment writer for one tier: rolls the active `.open`
    file to a sealed `.seg` past `segment_bytes`, evicts the oldest
    sealed segment while the tier exceeds its byte cap. Not thread-safe
    (the store's flusher is the only writer)."""

    def __init__(self, dirpath: str, prefix: str, cap_bytes: int,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES) -> None:
        self.dir = dirpath
        self.prefix = prefix
        self.cap_bytes = max(int(cap_bytes), 2 * _REC_HDR.size)
        self.segment_bytes = max(int(segment_bytes), 4096)
        self.evicted_total = 0
        os.makedirs(dirpath, exist_ok=True)
        # adopt an existing spool: seal a dead process's `.open` tail
        # (the kill -9 between flush and rename case) and continue the
        # seq counter past everything already there
        last_seq = 0
        for path in _segment_files(dirpath, prefix):
            name = os.path.basename(path)
            last_seq = max(last_seq,
                           int(name.split("-", 1)[1].split(".", 1)[0]))
            if path.endswith(".open"):
                try:
                    os.rename(path, path[:-len(".open")] + ".seg")
                except OSError:
                    pass
        self._seq = last_seq
        self._fd: int | None = None
        self._open_path: str | None = None
        self._open_bytes = 0

    def _sealed(self) -> list[str]:
        return [p for p in _segment_files(self.dir, self.prefix)
                if p.endswith(".seg")]

    def total_bytes(self) -> int:
        total = self._open_bytes
        for p in self._sealed():
            try:
                total += os.path.getsize(p)
            except OSError:
                pass
        return total

    def append(self, rec: bytes) -> None:
        if self._fd is None:
            self._seq += 1
            self._open_path = os.path.join(
                self.dir, f"{self.prefix}-{self._seq:010d}.open")
            self._fd = os.open(
                self._open_path,
                os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
            self._open_bytes = 0
        os.write(self._fd, rec)
        self._open_bytes += len(rec)
        if self._open_bytes >= self.segment_bytes:
            self.roll()
        self.evict()

    def roll(self) -> None:
        """Seal the active segment (close + rename .open -> .seg)."""
        if self._fd is None:
            return
        os.close(self._fd)
        self._fd = None
        try:
            os.rename(self._open_path,
                      self._open_path[:-len(".open")] + ".seg")
        except OSError:
            pass
        self._open_path = None
        self._open_bytes = 0

    def evict(self) -> int:
        """Delete oldest sealed segments while the tier exceeds its cap
        (never the active one: the tail is the post-mortem story)."""
        n = 0
        while self.total_bytes() > self.cap_bytes:
            sealed = self._sealed()
            if not sealed:
                break
            try:
                os.unlink(sealed[0])
            except OSError:
                break
            n += 1
        self.evicted_total += n
        return n

    def close(self) -> None:
        self.roll()


# --- the store -------------------------------------------------------------

def _lkey(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class TelemetryStore:
    """Per-process durable telemetry spool. See module docstring."""

    def __init__(self, dirpath: str,
                 retention_mb: float = DEFAULT_RETENTION_MB,
                 history=None, recorder=None, registry=None,
                 flush_interval: float = DEFAULT_FLUSH_INTERVAL,
                 rate_mb_s: float = DEFAULT_RATE_MB_S,
                 burst_mb: float = DEFAULT_BURST_MB,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES) -> None:
        from seaweedfs_tpu_torch.stats import events as events_mod
        from seaweedfs_tpu_torch.stats import history as history_mod

        self.dir = dirpath
        self.retention_bytes = int(
            max(1.0, float(retention_mb)) * 1024 * 1024)
        self.history = (history if history is not None
                        else history_mod.default_history())
        self.recorder = (recorder if recorder is not None
                         else events_mod.recorder())
        self.flush_interval = max(0.05, float(flush_interval))
        self.rate_bytes_s = max(4096.0, float(rate_mb_s) * 1024 * 1024)
        self.burst_bytes = max(65536.0, float(burst_mb) * 1024 * 1024)
        (self._m_spool, self._m_cap, self._m_flush_s, self._m_replay_s,
         self._m_evicted, self._m_deferrals, self._m_lost) = \
            ensure_metrics(registry)

        self.writers: dict[str, _TierWriter] = {}
        for tier, prefix, share in TIERS:
            sub = "events" if tier == "events" else "metrics"
            self.writers[tier] = _TierWriter(
                os.path.join(dirpath, sub), prefix,
                int(self.retention_bytes * share), segment_bytes)
            self._m_cap.labels(tier).set(
                int(self.retention_bytes * share))

        # flusher watermarks: the in-memory rings are the buffer; these
        # mark what has already reached disk
        self._flushed_ts = 0.0      # newest persisted history sample
        self._flushed_seq = 0       # newest persisted event seq
        # rollup accumulators: tier -> series key -> bucket accumulator
        self._acc: dict[str, dict] = {"1m": {}, "10m": {}}
        # long-window forecast cache: (family, labels key) -> [(t, mean)]
        self._forecast: dict[tuple, list] = {}
        self._tokens = self.burst_bytes
        self._token_ts = time.monotonic()
        self.flush_cycles = 0
        self.flush_deferrals = 0
        self.events_lost = 0
        self.replayed_samples = 0
        self.replayed_events = 0
        self.replay_seconds = 0.0
        self._lock = threading.Lock()
        self._stop: threading.Event | None = None

    # --- replay --------------------------------------------------------------
    def replay(self) -> dict:
        """Read the spool tail back into the live rings: raw samples into
        the history ring, events into the flight recorder, 1m rollups of
        the forecast families into the long-window cache. Returns counts;
        idempotent only before live traffic (call once, at startup)."""
        t0 = time.perf_counter()
        points = []
        mdir = os.path.join(self.dir, "metrics")
        for rec in iter_tier_records(mdir, "raw"):
            for t, fam, labels, v in rec.get("s", ()):
                points.append((float(t), fam, labels, float(v)))
        for rec in iter_tier_records(mdir, "m1"):
            t_mid = (float(rec.get("t0", 0)) + float(rec.get("t1", 0))) / 2
            for fam, labels, mean, _mx, _n, _last in rec.get("s", ()):
                if fam in FORECAST_FAMILIES:
                    self._forecast.setdefault(
                        (fam, _lkey(labels)), []).append(
                            (t_mid, float(mean)))
        for pts in self._forecast.values():
            pts.sort()
            del pts[:-FORECAST_CACHE_SLOTS]
        self.replayed_samples = self.history.preload(points)
        if points:
            self._flushed_ts = max(t for t, _, _, _ in points)
        evs = [rec for rec in iter_tier_records(
            os.path.join(self.dir, "events"), "ev")]
        self.replayed_events = self.recorder.preload(evs)
        if evs:
            self._flushed_seq = max(e.get("seq", 0) for e in evs)
        self.replay_seconds = time.perf_counter() - t0
        self._m_replay_s.observe(self.replay_seconds)
        self._export_spool_gauges()
        return {"samples": self.replayed_samples,
                "events": self.replayed_events,
                "seconds": self.replay_seconds}

    # --- flushing ------------------------------------------------------------
    def _take_tokens(self, need: float) -> bool:
        now = time.monotonic()
        self._tokens = min(
            self.burst_bytes,
            self._tokens + (now - self._token_ts) * self.rate_bytes_s)
        self._token_ts = now
        if need > self._tokens:
            return False
        self._tokens -= need
        return True

    def flush_once(self, force: bool = False) -> dict:
        """One flush cycle: pull new history samples and events from the
        rings, fold rollups, append records. `force` bypasses the token
        bucket (shutdown, tests). Returns what moved."""
        with self._lock:
            t0 = time.perf_counter()
            samples = self.history.samples_since(self._flushed_ts)
            events = self.recorder.tail(self._flushed_seq)
            recs: list[tuple[str, bytes]] = []
            if samples:
                recs.append(("raw", _encode_record(
                    {"k": "raw",
                     "s": [[t, fam, labels, v]
                           for t, fam, labels, v in samples]})))
            recs.extend(
                ("events", _encode_record(ev.to_dict())) for ev in events)
            recs.extend(self._fold_rollups(samples))
            need = sum(len(r) for _, r in recs)
            if recs and not force and not self._take_tokens(need):
                self.flush_deferrals += 1
                self._m_deferrals.inc()
                return {"deferred": True, "bytes": need}
            # watermarks advance only once the bytes are written: a
            # deferred cycle re-pulls the same ring tail next time
            for tier, rec in recs:
                try:
                    self.writers[tier].append(rec)
                except OSError:
                    return {"error": "spool_io", "bytes": need}
            if samples:
                self._flushed_ts = max(t for t, _, _, _ in samples)
            if events:
                # a seq gap past the watermark means the ring evicted
                # events before we got here — count the loss, never hide it
                lost = events[0].seq - self._flushed_seq - 1
                if self._flushed_seq and lost > 0:
                    self.events_lost += lost
                    self._m_lost.inc(lost)
                self._flushed_seq = events[-1].seq
            self.flush_cycles += 1
            dt = time.perf_counter() - t0
            self._m_flush_s.observe(dt)
            self._export_spool_gauges()
            return {"samples": len(samples), "events": len(events),
                    "bytes": need, "seconds": dt}

    def _fold_rollups(self, samples) -> list[tuple[str, bytes]]:
        """Fold raw samples into 1m buckets and completed 1m buckets into
        10m buckets; returns encoded records for every bucket that just
        completed. Accumulators hold one open bucket per series."""
        out = []
        done_1m = self._fold_tier("1m", (
            (t, (fam, _lkey(labels)), labels, v, 1)
            for t, fam, labels, v in samples))
        for t0, t1, series in done_1m:
            out.append(("1m", _encode_record(
                {"k": "roll", "tier": "1m", "t0": t0, "t1": t1,
                 "s": series})))
            for fam, labels, mean, mx, n, last in series:
                if fam in FORECAST_FAMILIES:
                    pts = self._forecast.setdefault(
                        (fam, _lkey(labels)), [])
                    pts.append(((t0 + t1) / 2, mean))
                    del pts[:-FORECAST_CACHE_SLOTS]
            done_10m = self._fold_tier("10m", (
                ((t0 + t1) / 2, (fam, _lkey(labels)), labels, mean, n)
                for fam, labels, mean, _mx, n, _last in series))
            for u0, u1, useries in done_10m:
                out.append(("10m", _encode_record(
                    {"k": "roll", "tier": "10m", "t0": u0, "t1": u1,
                     "s": useries})))
        return out

    def _fold_tier(self, tier: str, points) -> list[tuple]:
        """Feed (t, key, labels, value, weight) points into `tier`'s
        accumulators; return [(t0, t1, series)] for buckets that closed
        (a point landed past their end)."""
        width = ROLLUP_SECONDS[tier]
        acc = self._acc[tier]
        closed: dict[float, list] = {}
        for t, key, labels, v, w in points:
            b0 = (t // width) * width
            cur = acc.get(key)
            if cur is not None and cur["t0"] != b0:
                closed.setdefault(cur["t0"], []).append(
                    (key[0], cur["labels"],
                     cur["sum"] / cur["n"], cur["max"],
                     cur["n"], cur["last"]))
                cur = None
            if cur is None:
                cur = acc[key] = {"t0": b0, "labels": labels,
                                  "sum": 0.0, "max": v, "n": 0,
                                  "last": v}
            cur["sum"] += v * w
            cur["n"] += w
            cur["max"] = max(cur["max"], v)
            cur["last"] = v
        return [(t0, t0 + width, series)
                for t0, series in sorted(closed.items())]

    def _export_spool_gauges(self) -> None:
        for tier, w in self.writers.items():
            self._m_spool.labels(tier).set(w.total_bytes())
            if w.evicted_total:
                c = self._m_evicted.labels(tier)
                delta = w.evicted_total - getattr(w, "_exported", 0)
                if delta > 0:
                    c.inc(delta)
                    w._exported = w.evicted_total

    # --- queries -------------------------------------------------------------
    def forecast_points(self, family: str) -> dict[tuple, list]:
        """-> {sorted-labels-tuple: [(t, mean)]} 1m-rollup history of a
        forecast family (replayed + live), for the long-window OLS fit."""
        with self._lock:
            return {lk: list(pts)
                    for (fam, lk), pts in self._forecast.items()
                    if fam == family}

    def spool_bytes(self) -> dict[str, int]:
        return {tier: w.total_bytes() for tier, w in self.writers.items()}

    # --- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Replay the tail, then run the flusher loop. Idempotent."""
        if self._stop is not None:
            return
        self.replay()
        self._stop = threading.Event()
        t = threading.Thread(target=self._loop, args=(self._stop,),
                             name="sw-telemetry-store", daemon=True)
        t.start()

    def _loop(self, stop: threading.Event) -> None:  # pragma: no cover
        while not stop.wait(self.flush_interval):
            try:
                self.flush_once()
            except Exception:
                pass

    def close(self) -> None:
        """Final forced flush + seal the active segments."""
        if self._stop is not None:
            self._stop.set()
            self._stop = None
        try:
            self.flush_once(force=True)
        except Exception:
            pass
        with self._lock:
            for w in self.writers.values():
                w.close()
            self._export_spool_gauges()


# --- process singleton -----------------------------------------------------

_store: TelemetryStore | None = None
_store_lock = threading.Lock()


def enable(dirpath: str, retention_mb: float | None = None,
           **kw) -> TelemetryStore:
    """Arm the per-process store (replay + flusher). First caller wins —
    every role in one process shares one registry/history/recorder, so
    they share one spool too. Idempotent."""
    global _store
    with _store_lock:
        if _store is None:
            _store = TelemetryStore(
                dirpath,
                DEFAULT_RETENTION_MB if retention_mb is None
                else retention_mb, **kw)
            _store.start()
        return _store


def store() -> TelemetryStore | None:
    return _store


def disable() -> None:
    """Tests: close and forget the process store."""
    global _store
    with _store_lock:
        st, _store = _store, None
    if st is not None:
        st.close()


# --- post-mortem readers (no live process required) ------------------------

def read_events(dirpath: str, type: str | None = None,
                volume: int | None = None, trace: str | None = None,
                since: float | None = None, limit: int = 0) -> list[dict]:
    """Event dicts from a spool directory, oldest first — the dead
    process's flight recorder. Filters match EventRecorder.events()."""
    out = []
    for ev in iter_tier_records(os.path.join(dirpath, "events"), "ev"):
        if type is not None and ev.get("type") != type:
            continue
        if volume is not None and ev.get("volume") != volume:
            continue
        if trace is not None and ev.get("trace_id") != trace:
            continue
        if since is not None and ev.get("ts", 0.0) <= since:
            continue
        out.append(ev)
    out.sort(key=lambda e: (e.get("ts", 0.0), e.get("seq", 0)))
    if limit > 0:
        out = out[-limit:]
    return out


def read_series(dirpath: str, family: str | None = None,
                tiers: tuple = ("raw", "1m", "10m")) -> dict:
    """-> {(family, sorted-labels-tuple): [(t, value)]} from a spool's
    metrics tiers (rollups contribute their bucket means at the bucket
    midpoint). The post-mortem rate history for cluster.top -spool."""
    prefix = {"raw": "raw", "1m": "m1", "10m": "m10"}
    series: dict[tuple, dict] = {}
    mdir = os.path.join(dirpath, "metrics")
    for tier in tiers:
        for rec in iter_tier_records(mdir, prefix[tier]):
            if rec.get("k") == "raw":
                for t, fam, labels, v in rec.get("s", ()):
                    if family is not None and fam != family:
                        continue
                    series.setdefault(
                        (fam, _lkey(labels)), {})[round(float(t), 3)] = \
                        float(v)
            else:
                t_mid = (float(rec.get("t0", 0))
                         + float(rec.get("t1", 0))) / 2
                for fam, labels, mean, _mx, _n, _last in rec.get("s", ()):
                    if family is not None and fam != family:
                        continue
                    series.setdefault(
                        (fam, _lkey(labels)), {}).setdefault(
                            round(t_mid, 3), float(mean))
    return {key: sorted(pts.items()) for key, pts in series.items()}


def spool_info(dirpath: str) -> dict:
    """Spool shape without reading payloads: per-tier segment count,
    bytes, and the newest event/sample wall clock (cheap liveness probe
    for the post-mortem tooling)."""
    out = {}
    for tier, prefix, _ in TIERS:
        sub = "events" if tier == "events" else "metrics"
        files = _segment_files(os.path.join(dirpath, sub), prefix)
        total = 0
        for p in files:
            try:
                total += os.path.getsize(p)
            except OSError:
                pass
        out[tier] = {"segments": len(files), "bytes": total}
    return out
