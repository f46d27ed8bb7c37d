"""Repair scheduler: the "plan" leg of detect → plan → heal.

The port's copy of `seaweedfs_tpu/maintenance/scheduler.py`: a bounded
priority queue with the pacing machinery that matters more than codec
speed for degraded-mode tails (RapidRAID, arXiv:1207.6744; the online-EC
study, arXiv:1709.05365):

  * per-task-type concurrency caps (TASK_TYPES[..].concurrency) — one
    runaway class of repair cannot monopolize the workers;
  * per-node in-flight limits — a node already copying a replica is not
    also handed an EC rebuild (degraded reads on that node would pay).
    The limit binds the task's PRIMARY node (the source holder /
    rebuilder / vacuum holder recorded in its key); copy TARGETS are
    picked at plan time inside the executor and are not reserved here,
    so two concurrent repairs may still land copies on one target;
  * dedup by task key — a fault detected on every scan enqueues once;
  * exponential backoff with jitter on failed repairs — a node that
    refuses a copy is retried at 2s, 4s, 8s... (+-50% jitter so a
    thundering herd of failed tasks does not re-arrive in lockstep);
  * a global token-bucket repair throttle (repair_rate/s, burst) — the
    aggregate healing rate is bounded so foreground traffic never
    starves behind a repair storm;
  * a lazy window that holds a single-shard `ec_rebuild` so a second
    loss of the same stripe folds into one multi-target pass.

Everything takes an optional `now` so tests drive time deterministically,
and the jitter draws from the `rng` passed in. Host code: no device.

A task's life journals `task_queued`, `task_dispatched` and
`task_backoff` events keyed by `task_key_str`, and the lazy window's
decisions count into `SeaweedFS_maintenance_lazy_batch_total{outcome}`,
as in the JAX package; the scheduler also keeps both as plain counters
(`events` by event name, `lazy_batch` by outcome).
"""

from __future__ import annotations

import heapq
import random
import threading
import time

from ..stats import default_registry
from ..stats import events as events_mod
from .detectors import TASK_TYPES, RepairTask

# lazy-batching window (amortize co-stripe losses): task
# types whose single-target tasks may be briefly deferred so a second
# lost shard of the SAME stripe folds into one multi-target chain pass.
LAZY_TYPES = ("ec_rebuild",)
# lazy-batching outcomes (the scheduler's `lazy_batch` counters):
#   deferred — a dispatch-eligible task held back inside its window
#   folded   — an offer widened a queued task's target set (the payoff)
#   batched  — a multi-target task dispatched (one pass, all targets)
#   bypassed — an urgent (alert/operator-driven) task skipped the window
#   expired  — a single-target task waited out the full window alone
LAZY_OUTCOMES = ("deferred", "folded", "batched", "bypassed", "expired")
# the task lifecycle events, also counted by name
EVENTS = ("task_queued", "task_dispatched", "task_backoff")

_lazy_counter_cache = None


def lazy_batch_counter():
    """Register the lazy-batching counter family once."""
    global _lazy_counter_cache
    if _lazy_counter_cache is None:
        _lazy_counter_cache = default_registry().counter(
            "SeaweedFS_maintenance_lazy_batch_total",
            "lazy-batching window decisions for amortizable repairs",
            ("outcome",),
        )
    return _lazy_counter_cache


def task_key_str(task: RepairTask) -> str:
    """The journal's `task` correlation key: the scheduler's dedup
    identity, flattened ("ec_rebuild:7", "evacuate:127.0.0.1:81"), so
    cluster.why can follow one repair queued -> dispatched -> done."""
    return ":".join(str(p) for p in task.key)


def _coll_attr(task: RepairTask) -> dict:
    """The `collection` correlation key of a task's events: "default" for
    a volume in the unnamed collection, none for a node-scoped task."""
    if task.volume_id is None:
        return {}
    return {"collection": task.collection or "default"}

class RepairScheduler:
    def __init__(
        self,
        max_queue: int = 256,
        per_node_limit: int = 1,
        global_limit: int = 4,
        type_caps: dict[str, int] | None = None,
        repair_rate: float = 2.0,
        repair_burst: float = 4.0,
        backoff_base: float = 2.0,
        backoff_max: float = 120.0,
        rng: random.Random | None = None,
        lazy_window: float = 0.0,
    ) -> None:
        self.max_queue = max_queue
        self.per_node_limit = per_node_limit
        self.global_limit = global_limit
        self.type_caps = {
            name: spec.concurrency for name, spec in TASK_TYPES.items()
        }
        if type_caps:
            self.type_caps.update(type_caps)
        self.repair_rate = repair_rate
        self.repair_burst = repair_burst
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self._heap: list[tuple[int, int, RepairTask]] = []
        self._seq = 0
        self._queued: dict[tuple, RepairTask] = {}
        self._in_flight: dict[tuple, RepairTask] = {}
        self._node_inflight: dict[str, int] = {}
        self._type_inflight: dict[str, int] = {}
        # key -> {"failures": n, "not_before": ts}
        self._backoff: dict[tuple, dict] = {}
        self._tokens = repair_burst
        self._tokens_ts: float | None = None
        # lazy-batching window: 0.0 = dispatch immediately. Positive:
        # single-target LAZY_TYPES tasks sit queued up to this many
        # seconds so a co-stripe loss detected by a later scan folds
        # into one multi-target chain pass. Urgent offers
        # (alert-driven scans — degraded reads are paying for the missing
        # shard RIGHT NOW — and operator -now scans) bypass the window.
        self.lazy_window = float(lazy_window)
        self._queued_at: dict[tuple, float] = {}
        self._urgent: set[tuple] = set()
        self._lazy_deferred: set[tuple] = set()  # count "deferred" once
        self.stats = {
            "offered": 0, "deduped": 0, "backed_off": 0, "queue_full": 0,
            "dispatched": 0, "completed": 0, "failed": 0, "folded": 0,
            "max_node_inflight": 0, "max_inflight": 0,
        }
        self.lazy_batch = {outcome: 0 for outcome in LAZY_OUTCOMES}
        self.events = {name: 0 for name in EVENTS}

    # --- intake ---------------------------------------------------------------
    def offer(self, task: RepairTask, now: float | None = None,
              urgent: bool = False) -> bool:
        """Admit a detected task. False when it is already queued/in
        flight, still backing off from a failure, or the queue is full.

        The dedup key is effectively widened to the TARGET SET for lazy
        types: re-offering a queued ec_rebuild whose `targets` grew (a
        second shard of the same stripe died inside the lazy window)
        FOLDS the queued task — its target set widens in place and one
        multi-target chain pass repairs everything — instead of being
        dropped as a duplicate. `urgent` (alert-driven or operator -now
        scans) lifts the lazy hold on a new or already-queued task."""
        now = time.time() if now is None else now
        folded = False
        with self._lock:
            self.stats["offered"] += 1
            key = task.key
            if key in self._queued or key in self._in_flight:
                queued = self._queued.get(key)
                if queued is not None and task.type in LAZY_TYPES:
                    new_t = set(task.params.get("targets") or ())
                    old_t = set(queued.params.get("targets") or ())
                    if new_t - old_t:
                        merged = sorted(old_t | new_t)
                        params = dict(queued.params)
                        params["targets"] = merged
                        params["missing"] = len(merged)
                        wider = RepairTask(
                            type=queued.type, volume_id=queued.volume_id,
                            collection=queued.collection, node=queued.node,
                            priority=queued.priority,
                            reason=f"{len(merged)} shard(s) without a"
                                   f" live holder (folded)",
                            params=params,
                        )
                        self._queued[key] = wider
                        self._seq += 1
                        heapq.heappush(
                            self._heap,
                            (wider.priority, self._seq, wider))
                        self.stats["folded"] += 1
                        folded = True
                if queued is not None and urgent:
                    self._urgent.add(key)
                if not folded:
                    self.stats["deduped"] += 1
                    return False
            else:
                bo = self._backoff.get(key)
                if bo is not None and bo["not_before"] > now:
                    self.stats["backed_off"] += 1
                    return False
                if len(self._queued) >= self.max_queue:
                    self.stats["queue_full"] += 1
                    return False
                self._seq += 1
                heapq.heappush(self._heap, (task.priority, self._seq, task))
                self._queued[key] = task
                self._queued_at[key] = now
                if urgent:
                    self._urgent.add(key)
            if folded:
                self.lazy_batch["folded"] += 1
            self.events["task_queued"] += 1
        if folded:
            lazy_batch_counter().labels("folded").inc()
        events_mod.emit("task_queued", task=task_key_str(task),
                        volume=task.volume_id, node=task.node,
                        type=task.type,
                        reason=("folded into queued task" if folded
                                else task.reason),
                        **_coll_attr(task))
        return True

    # --- dispatch -------------------------------------------------------------
    def _refill(self, now: float) -> None:
        if self._tokens_ts is None:
            self._tokens_ts = now
        self._tokens = min(
            self.repair_burst,
            self._tokens + (now - self._tokens_ts) * self.repair_rate,
        )
        self._tokens_ts = now

    def next_task(self, now: float | None = None) -> RepairTask | None:
        """Pop the most urgent runnable task, honoring every cap. Tasks
        blocked by a cap stay queued for the next call."""
        now = time.time() if now is None else now
        lazy_outcome = None
        with self._lock:
            self._refill(now)
            if self._tokens < 1.0:
                return None
            if len(self._in_flight) >= self.global_limit:
                return None
            deferred = []
            picked = None
            while self._heap:
                prio, seq, task = heapq.heappop(self._heap)
                # the queued map is authoritative: a fold may have widened
                # the task since this heap entry was pushed (stale narrow
                # entries are skipped once the key leaves the map)
                cur = self._queued.get(task.key)
                if cur is None:  # stale heap entry
                    continue
                task = cur
                if (
                    self._type_inflight.get(task.type, 0)
                    >= self.type_caps.get(task.type, 1)
                    or (task.node and self._node_inflight.get(task.node, 0)
                        >= self.per_node_limit)
                ):
                    deferred.append((prio, seq, task))
                    continue
                outcome = self._lazy_gate(task, now)
                if outcome == "deferred":
                    deferred.append((prio, seq, task))
                    continue
                picked = task
                lazy_outcome = outcome
                break
            for entry in deferred:
                heapq.heappush(self._heap, entry)
            if picked is None:
                return None
            self._tokens -= 1.0
            del self._queued[picked.key]
            self._queued_at.pop(picked.key, None)
            self._urgent.discard(picked.key)
            self._lazy_deferred.discard(picked.key)
            self._in_flight[picked.key] = picked
            self._type_inflight[picked.type] = (
                self._type_inflight.get(picked.type, 0) + 1
            )
            if picked.node:
                n = self._node_inflight.get(picked.node, 0) + 1
                self._node_inflight[picked.node] = n
                self.stats["max_node_inflight"] = max(
                    self.stats["max_node_inflight"], n
                )
            self.stats["dispatched"] += 1
            self.stats["max_inflight"] = max(
                self.stats["max_inflight"], len(self._in_flight)
            )
            if lazy_outcome is not None:
                self.lazy_batch[lazy_outcome] += 1
            self.events["task_dispatched"] += 1
        if lazy_outcome is not None:
            lazy_batch_counter().labels(lazy_outcome).inc()
        events_mod.emit("task_dispatched", task=task_key_str(picked),
                        volume=picked.volume_id, node=picked.node,
                        type=picked.type, **_coll_attr(picked))
        return picked

    def _lazy_gate(self, task: RepairTask, now: float) -> str | None:
        """Lazy-batching decision for one dispatch-eligible task (caller
        holds the lock). Returns "deferred" to hold the task, a terminal
        LAZY_OUTCOMES value to dispatch-and-count, or None when the
        window does not apply (disabled, non-lazy type, online rebuild).
        The task is NEVER delayed past queued_at + lazy_window."""
        if self.lazy_window <= 0 or task.type not in LAZY_TYPES \
                or task.params.get("online"):
            return None
        key = task.key
        targets = task.params.get("targets") or ()
        if len(targets) >= 2 or task.params.get("missing", 0) >= 2:
            return "batched"  # already multi-target: one pass, go now
        if key in self._urgent:
            return "bypassed"  # degraded reads / operator: pressure wins
        queued_at = self._queued_at.get(key, now)
        if now - queued_at < self.lazy_window:
            if key not in self._lazy_deferred:
                self._lazy_deferred.add(key)
                self.lazy_batch["deferred"] += 1
                lazy_batch_counter().labels("deferred").inc()
            return "deferred"
        return "expired"  # waited the full window alone: repair anyway

    def complete(
        self, task: RepairTask, ok: bool, now: float | None = None
    ) -> float:
        """Mark a dispatched task finished. On failure, arm exponential
        backoff with jitter and return the retry delay (0.0 on success)."""
        now = time.time() if now is None else now
        with self._lock:
            key = task.key
            self._in_flight.pop(key, None)
            t = self._type_inflight.get(task.type, 0)
            self._type_inflight[task.type] = max(0, t - 1)
            if task.node:
                n = self._node_inflight.get(task.node, 0)
                self._node_inflight[task.node] = max(0, n - 1)
            if ok:
                self.stats["completed"] += 1
                self._backoff.pop(key, None)
                return 0.0
            self.stats["failed"] += 1
            bo = self._backoff.setdefault(
                key, {"failures": 0, "not_before": 0.0}
            )
            bo["failures"] += 1
            delay = min(
                self.backoff_max,
                self.backoff_base * 2 ** (bo["failures"] - 1),
            ) * (0.5 + self._rng.random())  # +-50% jitter
            bo["not_before"] = now + delay
            self.events["task_backoff"] += 1
            failures = bo["failures"]
        events_mod.emit("task_backoff", task=task_key_str(task),
                        volume=task.volume_id, node=task.node,
                        type=task.type, retry_in=round(delay, 2),
                        failures=failures, **_coll_attr(task))
        return delay

    def next_lazy_deadline(self, now: float | None = None) -> float | None:
        """Seconds until the soonest lazy-held task's window expires, or
        None when nothing is held — the daemon shortens its wait so a
        task is never delayed past queued_at + lazy_window. Entries
        whose window ALREADY expired are excluded: they need no
        precision wakeup anymore (the next ordinary tick dispatches
        them), and returning 0.0 for a task some OTHER cap is blocking
        would spin the daemon at the 0.05s floor — a 20 Hz full-scan
        busy loop for as long as the cap holds."""
        if self.lazy_window <= 0:
            return None
        now = time.time() if now is None else now
        with self._lock:
            deadlines = [
                d for d in (
                    self._queued_at.get(k, now) + self.lazy_window - now
                    for k, t in self._queued.items()
                    if t.type in LAZY_TYPES and k not in self._urgent
                    and not t.params.get("online")
                    and len(t.params.get("targets") or ()) < 2
                ) if d > 0.0
            ]
        if not deadlines:
            return None
        return min(deadlines)

    # --- views ----------------------------------------------------------------
    def pressure(self, now: float | None = None) -> dict:
        """Live dispatch pressure for per-task policy decisions — the
        ec_rebuild executor picks pipelined vs classic partly off this
        (a drained token bucket / saturated in-flight caps mean repairs
        are contending, so spreading one rebuild's GF math and wire load
        across the chain beats concentrating it on one node)."""
        now = time.time() if now is None else now
        with self._lock:
            self._refill(now)
            return {
                "tokens": self._tokens,
                "in_flight": len(self._in_flight),
                "global_limit": self.global_limit,
                "per_node_limit": self.per_node_limit,
                "node_inflight": dict(self._node_inflight),
                "queued": len(self._queued),
                "lazy_window": self.lazy_window,
                "lazy_held": sum(
                    1 for k, t in self._queued.items()
                    if self.lazy_window > 0 and t.type in LAZY_TYPES
                    and k not in self._urgent
                    and not t.params.get("online")
                    and len(t.params.get("targets") or ()) < 2
                    and now - self._queued_at.get(k, now) < self.lazy_window
                ),
            }

    def queue_depths(self) -> dict[str, dict[str, int]]:
        """{task_type: {queued, in_flight}} for the metrics collector."""
        with self._lock:
            out: dict[str, dict[str, int]] = {}
            for t in self._queued.values():
                out.setdefault(t.type, {"queued": 0, "in_flight": 0})
                out[t.type]["queued"] += 1
            for t in self._in_flight.values():
                out.setdefault(t.type, {"queued": 0, "in_flight": 0})
                out[t.type]["in_flight"] += 1
            return out

    def _queued_dict(self, t: RepairTask, now: float) -> dict:
        """to_dict + the lazy-window view /debug/maintenance renders:
        how much longer this task may wait for co-stripe company."""
        d = t.to_dict()
        if self.lazy_window > 0 and t.type in LAZY_TYPES:
            held = (
                t.key not in self._urgent
                and not t.params.get("online")
                and len(t.params.get("targets") or ()) < 2
            )
            remaining = max(
                0.0,
                self._queued_at.get(t.key, now) + self.lazy_window - now,
            )
            d["lazy"] = {
                "held": bool(held and remaining > 0),
                "dispatch_in": round(remaining if held else 0.0, 2),
                "urgent": t.key in self._urgent,
            }
        return d

    def snapshot(self, now: float | None = None) -> dict:
        now = time.time() if now is None else now
        with self._lock:
            seen: set[tuple] = set()
            queued = []
            for _, _, t in sorted(self._heap):
                cur = self._queued.get(t.key)
                if cur is None or cur.key in seen:
                    continue  # stale (pre-fold) or duplicate heap entry
                seen.add(cur.key)
                queued.append(self._queued_dict(cur, now))
            return {
                "queued": queued,
                "in_flight": [t.to_dict() for t in self._in_flight.values()],
                "backoff": [
                    {"type": k[0], "target": k[1],
                     "failures": v["failures"],
                     "retry_in": max(0.0, round(v["not_before"] - now, 2))}
                    for k, v in self._backoff.items()
                ],
                "stats": dict(self.stats),
                "limits": {
                    "max_queue": self.max_queue,
                    "per_node_limit": self.per_node_limit,
                    "global_limit": self.global_limit,
                    "type_caps": dict(self.type_caps),
                    "repair_rate": self.repair_rate,
                    "repair_burst": self.repair_burst,
                    "lazy_window": self.lazy_window,
                },
            }
