"""Low-overhead sampling stack profiler — the third leg of the
observability stack (traces answer "which request was slow"; metrics
answer "is the cluster healthy"; this answers "where does the time go
INSIDE a process"). The port's copy of the JAX package's
`stats/profiler.py`, with a `torch.profiler` device capture.

A background thread walks `sys._current_frames()` at a configurable Hz
and aggregates every thread's stack into a collapsed-stack table
(`thread-name;root_frame;...;leaf_frame -> samples`), the flamegraph.pl
/ speedscope input format. Sampling is strictly on-demand: no thread
exists until a `/debug/pprof/profile` request (or `cluster.profile`)
starts one, so an idle server pays nothing.

The overhead guard is self-measuring: each sample's own cost is timed,
and the inter-sample wait is stretched so the sampler's duty cycle never
exceeds `max_overhead` (10% by default) of wall time — a deep 200-thread
process degrades to a lower effective Hz instead of stealing the GIL.

`device_trace` wraps a `torch.profiler` capture of the process's CUDA
activity (kernel/transfer timelines) and raises DeviceProfilerUnavailable
— HTTP 501 — when no CUDA device is there; the host-side sampler never
imports torch.

Motivation follows RapidRAID (arXiv:1207.6744 — pipelined erasure coding
lives or dies by per-stage balance) and the XOR-EC optimization work
(arXiv:2108.02692 — the wins were only found by profiling kernel phases).
"""

from __future__ import annotations

import os
import sys
import threading
import time

from seaweedfs_tpu_torch.stats.metrics import default_registry

MIN_HZ, MAX_HZ = 1, 500
MIN_SECONDS, MAX_SECONDS = 0.05, 120.0
MAX_OVERHEAD = 0.10  # sampling duty-cycle ceiling (self-measured)
MAX_DEPTH = 64  # frames kept per stack (leaf-ward truncation)
MAX_CONCURRENT = 8  # simultaneous profile() runs per process

PROFILER_FAMILIES = (
    "SeaweedFS_stats_profile_runs_total",
    "SeaweedFS_stats_profile_samples_total",
    "SeaweedFS_stats_profile_overhead_seconds_total",
)

# process-lifetime totals behind the Registry collector below
_totals_lock = threading.Lock()
_runs_total = 0
_samples_total = 0
_overhead_seconds_total = 0.0

_active = threading.BoundedSemaphore(MAX_CONCURRENT)

# process identity for cluster.profile's dedup: several roles sharing one
# interpreter (dev `server` mode, test clusters) all sample the SAME
# process, and a merge without this would multiply sample counts and
# attribute every role's threads to every role (pid alone can collide
# across hosts)
PROCESS_TOKEN = f"{os.getpid()}-{os.urandom(6).hex()}"


class ProfilerBusy(RuntimeError):
    """Too many concurrent profile() runs in this process."""


class DeviceProfilerUnavailable(RuntimeError):
    """torch's profiler or a CUDA device is not available on this host."""


def clamp_hz(hz) -> int:
    # int(float("nan")) raises on its own; float inputs route through the
    # same non-finite rejection as clamp_seconds
    return max(MIN_HZ, min(MAX_HZ, int(hz)))


def clamp_seconds(seconds) -> float:
    import math

    seconds = float(seconds)
    if not math.isfinite(seconds):
        # nan/inf slip through float() parsing and min/max would silently
        # clamp them to MAX_SECONDS — a 3-char param must not buy 120s
        raise ValueError(f"seconds must be finite, got {seconds!r}")
    return max(MIN_SECONDS, min(MAX_SECONDS, seconds))


def _frame_label(frame) -> str:
    code = frame.f_code
    return f"{os.path.basename(code.co_filename)}:{code.co_name}"


def collapse_frame(frame, thread_name: str, max_depth: int = MAX_DEPTH) -> str:
    """One thread's live stack -> `thread;root;...;leaf` collapsed form."""
    parts = []
    while frame is not None and len(parts) < max_depth:
        parts.append(_frame_label(frame))
        frame = frame.f_back
    parts.append(thread_name)
    parts.reverse()
    return ";".join(parts)


def merge_collapsed(into: dict, stacks: dict, prefix: str = "") -> dict:
    """Accumulate one collapsed-stack table into `into`, optionally
    prefixing every stack (cluster.profile prefixes each node's role so
    one merged flamegraph splits by role at the root)."""
    for stack, count in stacks.items():
        key = f"{prefix};{stack}" if prefix else stack
        into[key] = into.get(key, 0) + count
    return into


def render_collapsed(stacks: dict) -> str:
    """Flamegraph-ready text: one `stack count` line, hottest first."""
    ranked = sorted(stacks.items(), key=lambda kv: (-kv[1], kv[0]))
    return "\n".join(f"{stack} {count}" for stack, count in ranked)


def top_frames(stacks: dict, n: int = 10) -> list[dict]:
    """Hottest leaf frames across a collapsed-stack table (the "where is
    the CPU actually executing" view BENCH records)."""
    per: dict[str, int] = {}
    total = 0
    for stack, count in stacks.items():
        leaf = stack.rsplit(";", 1)[-1]
        per[leaf] = per.get(leaf, 0) + count
        total += count
    ranked = sorted(per.items(), key=lambda kv: (-kv[1], kv[0]))[:n]
    return [
        {"frame": f, "samples": c, "pct": round(100.0 * c / total, 1)}
        for f, c in ranked
    ]


class SamplingProfiler:
    """Start/stop wrapper around the sampling thread. Results accumulate
    in `stacks` (collapsed form); `stop()` joins the thread, folds this
    run into the process-lifetime counters, and returns the result dict."""

    def __init__(self, hz: int = 100, max_overhead: float = MAX_OVERHEAD):
        self.hz = clamp_hz(hz)
        self.max_overhead = max_overhead
        self.stacks: dict[str, int] = {}
        self.samples = 0
        self.overhead_seconds = 0.0
        self.wall_seconds = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._t0 = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._thread = threading.Thread(
            target=self._run, name="sw-profiler", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        interval = 1.0 / self.hz
        own = threading.get_ident()
        while not self._stop.is_set():
            t0 = time.perf_counter()
            names = {t.ident: t.name for t in threading.enumerate()}
            for tid, frame in sys._current_frames().items():
                if tid == own:  # never profile the profiler
                    continue
                key = collapse_frame(frame, names.get(tid, f"thread-{tid}"))
                self.stacks[key] = self.stacks.get(key, 0) + 1
            self.samples += 1
            now = time.perf_counter()
            cost = now - t0
            self.overhead_seconds += cost
            # overhead guard: even when one sample costs more than the
            # nominal interval (many/deep threads), the wait stretches so
            # sampling time stays under max_overhead of wall time — both
            # per-sample and CUMULATIVELY, so one expensive early sample
            # in a short run is paid down before the next one is taken
            wait = max(interval - cost, cost * (1.0 / self.max_overhead - 1.0))
            budget_deficit = (
                self.overhead_seconds / self.max_overhead - (now - self._t0)
            )
            self._stop.wait(max(wait, budget_deficit))

    def stop(self) -> dict:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.wall_seconds = time.perf_counter() - self._t0
        global _runs_total, _samples_total, _overhead_seconds_total
        with _totals_lock:
            _runs_total += 1
            _samples_total += self.samples
            _overhead_seconds_total += self.overhead_seconds
        return self.result()

    def result(self) -> dict:
        wall = self.wall_seconds
        return {
            "hz": self.hz,
            "samples": self.samples,
            "wall_seconds": round(wall, 4),
            "overhead_seconds": round(self.overhead_seconds, 6),
            "overhead_ratio": (
                round(self.overhead_seconds / wall, 6) if wall > 0 else 0.0
            ),
            "stacks": dict(self.stacks),
        }


def profile(seconds: float = 2.0, hz: int = 100) -> dict:
    """One bounded sampling run (the /debug/pprof/profile body)."""
    seconds = clamp_seconds(seconds)
    if not _active.acquire(blocking=False):
        raise ProfilerBusy(
            f"more than {MAX_CONCURRENT} concurrent profiles in this process"
        )
    try:
        p = SamplingProfiler(hz=hz)
        p.start()
        time.sleep(seconds)
        return p.stop()
    finally:
        _active.release()


def threads_dump() -> list[dict]:
    """Instant all-thread stack dump (the /debug/pprof/threads body) —
    one `sys._current_frames()` walk, no sampling thread involved."""
    by_ident = {t.ident: t for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        t = by_ident.get(tid)
        stack = []
        while frame is not None and len(stack) < MAX_DEPTH:
            code = frame.f_code
            stack.append({
                "file": code.co_filename,
                "line": frame.f_lineno,
                "func": code.co_name,
            })
            frame = frame.f_back
        stack.reverse()  # root first, like the collapsed form
        out.append({
            "thread_id": tid,
            "name": t.name if t is not None else f"thread-{tid}",
            "daemon": t.daemon if t is not None else None,
            "stack": stack,
        })
    out.sort(key=lambda d: d["name"])
    return out


_device_lock = threading.Lock()


def device_trace(seconds: float = 2.0) -> bytes:
    """Capture the process's CUDA activity (every thread's kernels and
    copies, through CUPTI) with `torch.profiler` for `seconds` and return
    the Chrome trace JSON gzipped (Perfetto / chrome://tracing load it).
    Raises DeviceProfilerUnavailable when torch has no CUDA device (the
    HTTP route turns that into a 501) and ProfilerBusy (429) while another
    capture runs. The profiler is stopped on every exit, a raise included,
    so a failed capture never leaves it on."""
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile
    except Exception as e:  # torch missing or too old
        raise DeviceProfilerUnavailable(f"torch profiler unavailable: {e}")
    if not torch.cuda.is_available():
        raise DeviceProfilerUnavailable("no CUDA device in this process")
    if not _device_lock.acquire(blocking=False):
        raise ProfilerBusy("a device trace is already running")
    import gzip
    import shutil
    import tempfile

    tmpdir = tempfile.mkdtemp(prefix="sw-torch-trace-")
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    started = False
    try:
        prof.start()
        started = True
        time.sleep(clamp_seconds(seconds))
        torch.cuda.synchronize()
        prof.stop()
        started = False
        path = os.path.join(tmpdir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path, "rb") as f:
            return gzip.compress(f.read())
    finally:
        if started:
            try:
                prof.stop()
            except Exception:  # noqa: BLE001 - already failing; stop best-effort
                pass
        _device_lock.release()
        shutil.rmtree(tmpdir, ignore_errors=True)


def _metrics_lines() -> list[str]:
    with _totals_lock:
        runs, samples, overhead = (
            _runs_total, _samples_total, _overhead_seconds_total,
        )
    return [
        "# HELP SeaweedFS_stats_profile_runs_total completed sampling"
        " profiler runs",
        "# TYPE SeaweedFS_stats_profile_runs_total counter",
        f"SeaweedFS_stats_profile_runs_total {runs:g}",
        "# HELP SeaweedFS_stats_profile_samples_total stack samples taken"
        " across all profiler runs",
        "# TYPE SeaweedFS_stats_profile_samples_total counter",
        f"SeaweedFS_stats_profile_samples_total {samples:g}",
        "# HELP SeaweedFS_stats_profile_overhead_seconds_total self-measured"
        " time spent inside the sampler (the overhead-guard input)",
        "# TYPE SeaweedFS_stats_profile_overhead_seconds_total counter",
        f"SeaweedFS_stats_profile_overhead_seconds_total {overhead:g}",
    ]


# registered once at import: static counters, zero scrape cost while idle
default_registry().register_collector(_metrics_lines, names=PROFILER_FAMILIES)
