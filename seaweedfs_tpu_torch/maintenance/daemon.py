"""MaintenanceDaemon: the loop that closes detect → plan → heal.

The port's copy of `seaweedfs_tpu/maintenance/daemon.py`. It runs inside
the port's master behind `maintenance=True` (`-maintenance`), off by
default. Every scan interval it runs the detectors over the live
topology, offers the resulting RepairTasks to the RepairScheduler, and
drains whatever the scheduler's caps/throttle admit onto a small worker
pool that executes repairs through the shared shell plan/apply helpers,
under the master's `maintenance` admin lease. `maintenance_dry_run`
(`-maintenance.dryRun`) runs the identical pipeline but executors only
plan — zero mutations — so an operator can watch /debug/maintenance and
see exactly what the daemon *would* heal.

The daemon is host code and holds no device: the kernels of a heal run
on the volume servers its executors drive.

Observability, as in the JAX package: the metric families
`SeaweedFS_maintenance_{tasks_total,task_seconds,failures_total}`
(`ensure_metrics`) and the scrape-time `SeaweedFS_maintenance_queue_depth`
gauge; a finished task journals `task_done` or `task_failed`; `start()`
registers `_on_alert` with the process's alert engine, so a firing alert
named in `ALERT_SCANS` triggers its detector subset at once. `status()`
also reports the totals as plain counts (`counts` by type and state,
`seconds` and `failures` by type, `queue_depths`, and the scheduler's
`lazy_batch` and `events`). `stop()` removes the hook and the collector,
and waits for the worker pool's running tasks and the lease thread
(bounded), so no repair outlives the master that started it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as wait_futures

from ..stats import alerts as alerts_mod
from ..stats import default_registry
from ..stats import events as events_mod
from ..stats.metrics import _fmt_labels
from . import detectors as detectors_mod
from . import executors as executors_mod
from .detectors import TASK_TYPES, RepairTask
from .scheduler import RepairScheduler, _coll_attr, task_key_str

MAINTENANCE_FAMILIES = ("SeaweedFS_maintenance_queue_depth",)

# alert name -> detector subset to scan immediately on a rising edge. The
# alert engine evaluates the daemon's process-local metrics history, so
# volume-server-side series drive these hooks only where the servers share
# the master's process; elsewhere the periodic scan is the heal path.
ALERT_SCANS = {
    "disk_near_cap": ("vacuum", "balance"),
    "heartbeat_stale": ("evacuate",),
    # reads surviving only through reconstruction: something is lost or
    # torn RIGHT NOW — race the repair scan instead of waiting a tick
    "degraded_reads": ("ec_rebuild", "fix_replication"),
    # a scrub pass proved silent damage: route the findings immediately
    "scrub_findings": ("scrub",),
}

# bound on how long stop() waits for running repairs and the lease thread
STOP_WAIT_SECONDS = 60.0


def ensure_metrics(registry=None):
    """Register the maintenance metric families on the process registry
    once; returns (tasks_total, task_seconds, failures_total)."""
    reg = registry if registry is not None else default_registry()
    return (
        reg.counter(
            "SeaweedFS_maintenance_tasks_total",
            "maintenance tasks by terminal state"
            " (completed|failed|planned)",
            ("task", "state"),
        ),
        reg.histogram(
            "SeaweedFS_maintenance_task_seconds",
            "wall time per executed maintenance task",
            ("task",),
        ),
        reg.counter(
            "SeaweedFS_maintenance_failures_total",
            "failed maintenance task executions (each arms backoff)",
            ("task",),
        ),
    )


class MaintenanceDaemon:
    def __init__(
        self,
        master,
        interval: float | None = None,
        dry_run: bool = False,
        scheduler: RepairScheduler | None = None,
        history_size: int = 128,
        rebuild_mode: str = "auto",
        lazy_window: float = 0.0,
        registry=None,
    ) -> None:
        self.master = master
        self.interval = (
            interval if interval is not None
            else float(max(master.topo.pulse_seconds, 1))
        )
        self.dry_run = bool(dry_run)
        # ec_rebuild default mode: auto (per-task choice off holder count
        # + scheduler pressure) | pipelined | classic. Runtime-settable
        # via POST /maintenance/enable {"rebuildMode": ...}.
        self.rebuild_mode = rebuild_mode
        self.enabled = True
        # -repair.lazyWindow: single-shard ec_rebuild tasks may sit
        # queued up to this many seconds so co-stripe losses coalesce
        # into one multi-target chain pass (0 = dispatch immediately).
        # Runtime-settable via POST /maintenance/enable {"lazyWindow"}.
        self.scheduler = scheduler or RepairScheduler(
            lazy_window=lazy_window)
        self.registry = registry if registry is not None else default_registry()
        self._m_tasks, self._m_seconds, self._m_failures = ensure_metrics(
            self.registry
        )
        self._collector = None
        self._alert_engine = None
        self._lock = threading.Lock()
        self._history: deque[dict] = deque(maxlen=history_size)
        # the metric families' totals, as plain counts for status()
        self._counts: dict[tuple[str, str], int] = {}
        self._seconds: dict[str, float] = {}
        self._failures: dict[str, int] = {}
        self._pending_types: set[str] = set()  # requested subset scans
        self._pending_full = False  # an explicit full-scan request
        self._wake = threading.Event()
        self._stopping = threading.Event()  # also wakes the lease thread
        self._thread: threading.Thread | None = None
        self._pool: ThreadPoolExecutor | None = None
        self._futures: set = set()
        self._env = None
        self._lease_mutex = threading.Lock()
        self._lease_count = 0
        self._renew_thread: threading.Thread | None = None
        self.scans = 0
        self.started_at: float | None = None

    # --- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self.started_at = time.time()
        self._collector = self.registry.register_collector(
            self._queue_depth_lines, names=MAINTENANCE_FAMILIES
        )
        # react to firing alerts, not only the polling scan
        self._alert_engine = alerts_mod.engine()
        self._alert_engine.add_on_fire(self._on_alert)
        self._pool = ThreadPoolExecutor(
            max_workers=self.scheduler.global_limit,
            thread_name_prefix="sw-maint",
        )
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="sw-maint-scan"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stopping.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            with self._lock:
                running = set(self._futures)
            wait_futures(running, timeout=STOP_WAIT_SECONDS)
            self._pool = None
        renew = self._renew_thread
        if renew is not None:
            renew.join(timeout=STOP_WAIT_SECONDS)
        if self._alert_engine is not None:
            self._alert_engine.remove_on_fire(self._on_alert)
            self._alert_engine = None
        if self._collector is not None:
            self.registry.unregister_collector(self._collector)
            self._collector = None

    def _command_env(self):
        if self._env is None:
            from ..shell.env import CommandEnv

            self._env = CommandEnv(self.master.url, holder="maintenance")
        return self._env

    def _acquire_lease(self, env) -> None:
        """Refcounted admin lease shared by the worker pool: every worker
        uses the one 'maintenance' holder (the master's lock is
        re-entrant per holder), so the lease is taken when the first
        concurrent repair starts and dropped when the last one ends —
        an operator's `lock` cannot slip in between two daemon tasks.
        A renewal thread re-acquires every 10s while any repair runs: a
        single long rebuild must not outlive the lease's 30s ttl and
        silently lose the mutual exclusion mid-copy. Lease POSTs carry a
        short timeout: they run under _lease_mutex, and a hung 300s call
        here would freeze every worker's task start AND finish."""
        with self._lease_mutex:
            # re-acquire also refreshes the 30s ttl
            env.acquire_lock(timeout=10)
            self._lease_count += 1
            if self._renew_thread is None or not self._renew_thread.is_alive():
                self._renew_thread = threading.Thread(
                    target=self._renew_lease_loop, args=(env,),
                    daemon=True, name="sw-maint-lease",
                )
                self._renew_thread.start()

    def _release_lease(self, env) -> None:
        with self._lease_mutex:
            self._lease_count -= 1
            if self._lease_count <= 0:
                try:
                    env.release_lock(timeout=10)
                except Exception:
                    pass  # expired lease: nothing to release

    def _renew_lease_loop(self, env) -> None:
        # well inside the 30s lease ttl; stop() wakes it at once
        while not self._stopping.wait(10.0):
            with self._lease_mutex:
                if self._lease_count <= 0:
                    return
                try:
                    env.acquire_lock(timeout=10)
                except Exception:
                    pass  # lost race after expiry: next task 409s+backs off

    # --- scanning -------------------------------------------------------------
    def _on_alert(self, name: str, info: dict) -> None:
        types = ALERT_SCANS.get(name)
        if types is None:
            return
        self.request_scan(types)

    def request_scan(self, types=None) -> None:
        """Ask the loop for an immediate scan (subset or full)."""
        with self._lock:
            if types is None:
                self._pending_full = True
            else:
                self._pending_types.update(types)
        self._wake.set()

    def scan_now(self, types=None) -> list[dict]:
        """Synchronous scan + enqueue (the `cluster.maintenance -now` verb);
        returns what was offered. Dispatch still rides the loop/caps. An
        operator-forced scan is urgent: it bypasses the lazy window."""
        offered = self._scan_and_enqueue(types, urgent=True)
        self._wake.set()
        return [t.to_dict() for t in offered]

    def _scan_and_enqueue(self, types=None,
                          urgent: bool | None = None) -> list[RepairTask]:
        # subset scans are reactions (a firing alert — degraded reads are
        # paying for the fault right now — or an operator's -now): they
        # bypass the lazy-batching window; periodic full scans do not
        if urgent is None:
            urgent = types is not None
        self.scans += 1
        now = time.time()
        offered = []
        for task in detectors_mod.scan(self.master, types):
            if self.scheduler.offer(task, now, urgent=urgent):
                offered.append(task)
        return offered

    # --- the loop -------------------------------------------------------------
    def _loop(self) -> None:
        next_scan = 0.0  # monotonic deadline for the periodic full scan
        while True:
            timeout = self.interval
            # a lazy-held task must dispatch the moment its window
            # expires, not a full interval later: shorten the wait to
            # the soonest lazy deadline
            lazy_in = self.scheduler.next_lazy_deadline()
            if lazy_in is not None:
                timeout = max(0.05, min(timeout, lazy_in))
            woke = self._wake.wait(timeout=timeout)
            if self._stopping.is_set():
                return
            with self._lock:
                # a timeout tick — or an overdue scan deadline — is a full
                # scan; an explicit wake scans the requested subset, or
                # skips straight to dispatch when a completed task only
                # woke us to drain the queue. The deadline matters: while
                # a long backlog drains, completion wakes arrive faster
                # than the interval and would otherwise postpone detection
                # of NEW faults indefinitely.
                full = (
                    (not woke) or self._pending_full
                    or time.monotonic() >= next_scan
                )
                types = None if full else (set(self._pending_types) or None)
                dispatch_only = woke and not full and types is None
                self._pending_full = False
                self._pending_types.clear()
                self._wake.clear()
            if not self.enabled or not self.master._is_leader():
                next_scan = 0.0  # scan immediately on re-enable/election
                continue
            if not dispatch_only:
                try:
                    self._scan_and_enqueue(types)
                except Exception:
                    pass
                if full:
                    next_scan = time.monotonic() + self.interval
            self._dispatch()

    def _dispatch(self) -> None:
        while not self._stopping.is_set():
            task = self.scheduler.next_task()
            if task is None:
                return
            pool = self._pool
            if pool is None:
                self.scheduler.complete(task, ok=True)
                return
            future = pool.submit(self._run_task, task)
            with self._lock:
                self._futures.add(future)
            future.add_done_callback(self._forget)

    def _forget(self, future) -> None:
        with self._lock:
            self._futures.discard(future)


    def _run_task(self, task: RepairTask) -> None:
        started = time.time()
        state, detail, error = "completed", {}, None
        env = self._command_env()
        try:
            if not self.dry_run:
                # the same exclusive admin lease the shell's repair verbs
                # demand: while an operator holds `lock`, acquisition 409s,
                # the task fails into backoff and retries after the human
                # is done — never interleaving with a manual repair.
                # Dry-run only plans (read-only): no lease needed.
                self._acquire_lease(env)
            try:
                detail = executors_mod.execute(
                    task, env, dry_run=self.dry_run,
                    scheduler=self.scheduler,
                    rebuild_mode=self.rebuild_mode,
                )
            finally:
                if not self.dry_run:
                    self._release_lease(env)
            if self.dry_run:
                state = "planned"
        except Exception as e:
            state, error = "failed", str(e)[:300]
        duration = time.time() - started
        ok = state != "failed"
        retry_in = self.scheduler.complete(task, ok=ok)
        events_mod.emit(
            "task_done" if ok else "task_failed",
            task=task_key_str(task), volume=task.volume_id,
            node=task.node, type=task.type, state=state,
            duration_ms=round(duration * 1000.0, 2),
            **({"error": error} if error is not None else {}),
            **_coll_attr(task),
        )
        # a finished task frees a cap/throttle slot: wake the loop so the
        # next queued task dispatches now, not a full scan interval later
        if not self._stopping.is_set():
            self._wake.set()
        self._m_tasks.labels(task.type, state).inc()
        if state != "planned":  # planning costs nothing worth timing
            self._m_seconds.labels(task.type).observe(duration)
        if not ok:
            self._m_failures.labels(task.type).inc()
        entry = {
            "task": task.to_dict(), "state": state,
            "started": round(started, 3),
            "duration_ms": round(duration * 1000.0, 2),
        }
        if detail.get("planned") is not None:
            entry["planned"] = detail["planned"]
        if detail.get("applied") is not None:
            entry["applied"] = detail["applied"]
        if error is not None:
            entry["error"] = error
            entry["retry_in"] = round(retry_in, 2)
        with self._lock:
            self._history.append(entry)
            k = (task.type, state)
            self._counts[k] = self._counts.get(k, 0) + 1
            if state != "planned":  # planning costs nothing worth timing
                self._seconds[task.type] = (
                    self._seconds.get(task.type, 0.0) + duration)
            if not ok:
                self._failures[task.type] = (
                    self._failures.get(task.type, 0) + 1)

    # --- views ----------------------------------------------------------------
    def _queue_depth_lines(self) -> list[str]:
        lines = ["# TYPE SeaweedFS_maintenance_queue_depth gauge"]
        depths = self.scheduler.queue_depths()
        for task_type in sorted(TASK_TYPES):
            d = depths.get(task_type, {"queued": 0, "in_flight": 0})
            for st in ("queued", "in_flight"):
                lines.append(
                    "SeaweedFS_maintenance_queue_depth"
                    + _fmt_labels(("task", "state"), (task_type, st))
                    + f" {d[st]}"
                )
        return lines

    def status(self, history_limit: int = 50) -> dict:
        with self._lock:
            history = list(self._history)[-history_limit:]
            counts: dict[str, dict[str, int]] = {}
            for (task_type, state), n in sorted(self._counts.items()):
                counts.setdefault(task_type, {})[state] = n
            seconds = dict(sorted(self._seconds.items()))
            failures = dict(sorted(self._failures.items()))
        return {
            "enabled": self.enabled,
            "dry_run": self.dry_run,
            "interval": self.interval,
            "scans": self.scans,
            "started_at": self.started_at,
            "rebuild_mode": self.rebuild_mode,
            # the live dispatch view cluster.maintenance renders: why a
            # repair is running (or deferred) RIGHT NOW — token-bucket
            # level, in-flight vs caps, and the lazy-batching hold
            "pressure": self.scheduler.pressure(),
            "task_types": {
                name: {"priority": spec.priority,
                       "concurrency": spec.concurrency,
                       "description": spec.description}
                for name, spec in TASK_TYPES.items()
            },
            "scheduler": self.scheduler.snapshot(),
            "counts": counts,
            "seconds": seconds,
            "failures": failures,
            "queue_depths": self.scheduler.queue_depths(),
            "lazy_batch": dict(self.scheduler.lazy_batch),
            "events": dict(self.scheduler.events),
            "history": history,
        }
