"""SLO-burn-driven load shedding: the feedback loop over admission.

Every process has multi-window burn-rate *alerts*
(`slo_burn_fast` at 14x, `slo_burn_slow` at 3x — the classic
fast/slow-window pairing), and the leader master merges the same evaluation
cluster-wide on the leader master (`cluster_slo_burn_*` over the
telemetry aggregate). This module inverts that machinery from alerting
into actuation: when an error budget burns, the actuator tightens the
admission controller's class gates — background scans shed first, then
writes, and interactive traffic only by explicit operator floor — and
relaxes them stepwise once the budget stops burning.

Two burn sources feed the loop, and the MAX of both drives it:

  * local: this process's AlertEngine (`slo_status()` burn_fast), plus
    a rising-edge subscription (`add_on_fire`) so a firing
    `*slo_burn_fast` tightens IMMEDIATELY instead of at the next tick;
  * cluster: the leader master's one-fetch endpoint
    (`GET /debug/cluster/telemetry`), whose `slos` rows carry the burn
    of the aggregate stream a tenant pushes through ALL gateways — so
    shedding engages cluster-wide even when each single gateway's
    slice looks healthy.

The policy is a small deterministic ladder (level 0..3), one step per
tick while burning, one step back per `hold` consecutive calm ticks —
hysteresis so a flapping burn doesn't flap the gates. Tests inject a
scripted `burn_source` and drive `step()` by hand.
"""

from __future__ import annotations

import json
import threading
import time

from seaweedfs_tpu_torch.qos import admission

# gate ladder: level -> {class: factor}; missing classes are open.
# interactive's floor stays 1.0 unless the operator lowers it — the
# highest class shedding is an incident (cluster.check fails on it),
# never automatic policy.
LEVELS = (
    {},
    {"background": 0.5},
    {"background": 0.0, "write": 0.5},
    {"background": 0.0, "write": 0.0},
)


class Actuator:
    def __init__(self, controller=None, master_url: str | None = None,
                 burn_source=None, fast_burn: float | None = None,
                 interval: float = 2.0, hold: int = 3,
                 now=time.monotonic) -> None:
        self.controller = controller or admission.controller()
        self.master_url = master_url
        self._burn_source = burn_source
        self._now = now
        self.interval = interval
        self.hold = max(1, int(hold))  # calm ticks before each relax step
        if fast_burn is None:
            from seaweedfs_tpu_torch.stats import alerts as alerts_mod

            fast_burn = float(alerts_mod.DEFAULT_PARAMS["slo_fast_burn"])
        self.fast_burn = fast_burn
        self.level = 0
        self.last_burn = 0.0
        self._calm = 0
        self._stop = threading.Event()
        self._thread = None
        self._lock = threading.Lock()
        # bounded transition log (bench/debug: engage/release timeline)
        self.transitions: list[dict] = []
        self._subscribed = False
        self._last_kick = float("-inf")

    # --- burn sources ---------------------------------------------------------
    def _local_burn(self) -> float:
        from seaweedfs_tpu_torch.stats import alerts as alerts_mod

        worst = 0.0
        try:
            for row in alerts_mod.engine().slo_status().values():
                b = row.get("burn_fast")
                if b is not None:
                    worst = max(worst, float(b))
        except Exception:
            pass
        return worst

    def _cluster_burn(self) -> float:
        if not self.master_url:
            return 0.0
        try:
            from seaweedfs_tpu_torch.server.httpd import http_request

            status, _hdrs, body = http_request(
                "GET", self.master_url + "/debug/cluster/telemetry?n=1",
                timeout=3)
            if status != 200:
                return 0.0
            snap = json.loads(body)
            fast = (snap.get("windows") or {}).get("fast")
            worst = 0.0
            for row in snap.get("slos") or ():
                if fast is None or row.get("window") == fast:
                    worst = max(worst, float(row.get("burn") or 0.0))
            return worst
        except Exception:
            return 0.0

    def burn(self) -> float:
        """Worst fast-window burn across every configured source."""
        if self._burn_source is not None:
            try:
                return float(self._burn_source())
            except Exception:
                return 0.0
        return max(self._local_burn(), self._cluster_burn())

    # --- policy ---------------------------------------------------------------
    def _apply(self, level: int, why: str) -> None:
        # caller holds self._lock
        level = max(0, min(len(LEVELS) - 1, level))
        if level == self.level:
            return
        self.level = level
        self.controller.set_gates(LEVELS[level])
        self.controller.burn_retry_after = max(2.0, self.interval * 2)
        self.transitions.append({
            "mono": self._now(), "level": level, "burn": self.last_burn,
            "why": why})
        del self.transitions[:-256]

    def step(self, burn: float | None = None) -> int:
        """One control tick; returns the resulting level. Deterministic:
        tighten one step per burning tick, relax one step per `hold`
        consecutive calm ticks (burn < 1.0 = the budget is no longer
        being overspent)."""
        b = self.burn() if burn is None else float(burn)
        with self._lock:
            self.last_burn = b
            if b >= self.fast_burn:
                self._calm = 0
                self._apply(self.level + 1, "tighten")
            elif b < 1.0:
                self._calm += 1
                if self.level > 0 and self._calm >= self.hold:
                    self._calm = 0
                    self._apply(self.level - 1, "relax")
            else:
                self._calm = 0  # burning, but under the page threshold
            return self.level

    def kick(self) -> None:
        """Rising-edge fast path: a `*slo_burn_fast` alert just fired —
        tighten NOW rather than waiting out the tick. Debounced to one
        step per tick interval: several burn rules firing in the same
        evaluation pass (a cold start trips every role's p99 at once)
        are ONE burn signal, not a ladder-length stack of them — the
        per-tick loop keeps tightening if the burn actually sustains."""
        with self._lock:
            t = self._now()
            if t - self._last_kick < self.interval:
                return
            self._last_kick = t
            self._calm = 0
            self._apply(self.level + 1, "alert_edge")

    def _on_fire(self, rule_name: str, info) -> None:
        if rule_name.endswith("slo_burn_fast"):
            self.kick()

    # --- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        if not self._subscribed:
            try:
                from seaweedfs_tpu_torch.stats import alerts as alerts_mod

                alerts_mod.engine().add_on_fire(self._on_fire)
                self._subscribed = True
            except Exception:
                pass
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:  # pragma: no cover - timing loop
        while not self._stop.wait(self.interval):
            try:
                self.step()
            except Exception:
                pass

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout=2.0)


_actuator: Actuator | None = None
_actuator_lock = threading.Lock()


def start(master_url: str | None = None, **kw) -> Actuator:
    """Process-singleton start (idempotent): the first gateway that
    enables QoS brings the loop up; later callers may supply the master
    URL if the first did not have one."""
    global _actuator
    with _actuator_lock:
        if _actuator is None:
            _actuator = Actuator(master_url=master_url, **kw)
            _actuator.start()
        elif master_url and not _actuator.master_url:
            _actuator.master_url = master_url
        return _actuator


def actuator() -> Actuator | None:
    return _actuator


def reset() -> None:
    """Stop the process actuator, take it off the alert engine's fire
    hooks and forget it; the next gateway that arms QoS starts a new one."""
    global _actuator
    with _actuator_lock:
        act, _actuator = _actuator, None
    if act is None:
        return
    act.stop()
    if act._subscribed:
        from seaweedfs_tpu_torch.stats import alerts as alerts_mod

        alerts_mod.engine().remove_on_fire(act._on_fire)
        act._subscribed = False
