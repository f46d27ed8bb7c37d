"""Named fault-point registry: inject errors, latency, torn writes,
silent bit flips, full disks and network partitions at the port's seams.

The port's copy of `seaweedfs_tpu/util/faults.py`: the six modes,
`FaultSpec` (`rate`, `ms`, `frac`, `count`, `key`, `after`), `FaultPoint`'s
`draw` / `hit` / `mangle`, `act`, `register`, `point`, `arm`, `disarm`,
`disarm_all`, `armed`, `snapshot`, `arm_from_spec` and the runtime-arming
gate (`enable`, `runtime_arming_enabled`, `SEAWEEDFS_TPU_FAULTS=1`) that
`POST /debug/faults` checks.

Design constraints, in order:

  1. **Disarmed is free.** A seam check is one attribute load and a None
     test — no dict lookup, no allocation, no closure.
  2. **Points are declared, not discovered.** `ALL_POINTS` is the closed
     set of seam names; `register()` rejects anything else, so a typo'd
     seam cannot silently never fire.
  3. **Per-process arming.** Each server process arms its own registry
     (`faults=` of the server constructors, `POST /debug/faults`);
     in-process test clusters share one registry, so a spec may carry
     `key=` to scope a fault to one server's seam invocations (the seam
     passes its identity).

Seam API:

    _FP = faults.register("volume.read.dat")   # module import time
    ...
    _FP.hit()                # raise/sleep per the armed spec, or no-op
    data = _FP.mangle(data)  # torn/corrupt byte seams
    spec = _FP.draw()        # custom seams act themselves (tear a parity file)

A firing fault counts `SeaweedFS_faults_injected_total{point,mode}` and
journals a `fault_injected` event (`stats/`) with its key and the
`volume=` a seam passes, so `cluster.why <volume>` shows the injection.
"""

from __future__ import annotations

import errno
import os
import random
import threading
import time
from dataclasses import dataclass

from ..stats import default_registry
from ..stats import events as _events

ALL_POINTS = (
    "volume.read.dat",        # needle read from the .dat
    "volume.read.idx",        # needle-map lookup on the read path
    "volume.write.dat",       # needle append to the .dat
    "volume.ec.shard.read",   # sealed EC shard pread
    "volume.ec.parity.write", # online-EC parity emit (torn = tear the file)
    "volume.heartbeat.send",  # volume server -> master heartbeat POST
    "master.assign",          # /dir/assign handler
    "master.lookup",          # /dir/lookup handler
    "filer.chunk.read",       # filer -> volume chunk relay (WeedClient.fetch)
    "volume.replicate.fanout",  # a replicated write's push to the other
                                # holders: error = the write is not acked
    "volume.fastlane.drain",  # the fastlane engine's event drain
    "repair.partial_fetch",   # pipelined-rebuild partial-sum hop (/admin/ec/
                              # partial*): error = a chain hop dies mid-rebuild
)

# `corrupt` is the silent-damage mode the scrubber exists to catch:
# deterministic in-place bit flips on the payload at the .dat/shard byte
# seams (mangle()), invisible to the writer — only a CRC or parity check
# can notice.
MODES = ("error", "latency", "torn", "disk_full", "partition", "corrupt")


class FaultInjected(IOError):
    """An `error`-mode fault fired. Derives from IOError so seams that
    already treat IO failures as recoverable treat injections the same
    way."""


class FaultPartition(ConnectionError):
    """A `partition`-mode fault fired: the peer is unreachable."""


@dataclass
class FaultSpec:
    """One armed fault. `count` < 0 means unlimited; a positive count
    decrements per firing and auto-disarms at zero. `rate` in (0, 1]
    fires probabilistically. `key` scopes the fault to seam invocations
    passing the same discriminator (in-process multi-server tests)."""

    mode: str
    rate: float = 1.0
    ms: float = 0.0       # latency mode: injected delay
    frac: float = 0.5     # torn mode: fraction of the payload DROPPED
    count: int = -1       # firings remaining; <0 = unlimited
    key: str = ""         # scope discriminator ("" = every invocation)
    after: int = 0        # skip the first N would-fire draws (onset
                          # delay: "die on the 4th chunk, not the 1st")

    def to_dict(self) -> dict:
        return {"mode": self.mode, "rate": self.rate, "ms": self.ms,
                "frac": self.frac, "count": self.count, "key": self.key,
                "after": self.after}


_metric = None


def _injected_counter():
    global _metric
    if _metric is None:
        _metric = default_registry().counter(
            "SeaweedFS_faults_injected_total",
            "fault injections fired, by point and mode",
            ("point", "mode"),
        )
    return _metric


class FaultPoint:
    """One named seam. `spec` is None when disarmed."""

    __slots__ = ("name", "spec", "fired")

    def __init__(self, name: str) -> None:
        self.name = name
        self.spec: FaultSpec | None = None
        self.fired = 0

    def draw(self, key: str | None = None,
             volume: int | None = None) -> FaultSpec | None:
        """Decide whether the armed fault fires for this invocation and
        count it; returns the spec (caller acts) or None. Seams with
        custom damage (torn parity) use this directly. `volume` names the
        volume the seam damages."""
        spec = self.spec
        if spec is None:
            return None
        if spec.key and key is not None and key != spec.key:
            return None
        if spec.rate < 1.0 and random.random() >= spec.rate:
            return None
        with _lock:
            if self.spec is not spec:  # disarmed/re-armed under us
                return None
            if spec.after > 0:  # onset delay: let the first N draws pass
                spec.after -= 1
                return None
            if spec.count == 0:
                return None
            if spec.count > 0:
                spec.count -= 1
                if spec.count == 0:
                    self.spec = None
            self.fired += 1
        _injected_counter().labels(self.name, spec.mode).inc()
        # cold path: only a firing fault pays. Emitted inside the request
        # span when one is active, so cluster.why joins the injection to
        # the read it degraded
        _events.emit("fault_injected", point=self.name, mode=spec.mode,
                     key=key or "", volume=volume)
        return spec

    def hit(self, key: str | None = None, volume: int | None = None) -> None:
        """The standard seam check: no-op disarmed; armed, acts per mode
        (error/partition/disk_full raise, latency sleeps; torn and
        corrupt are no-ops here — mangle() handles them at the byte seam,
        so a seam calling both never double-counts one firing)."""
        spec = self.spec
        if spec is None or spec.mode in ("torn", "corrupt"):
            return
        spec = self.draw(key, volume)
        if spec is not None:
            act(self.name, spec)

    def mangle(self, data: bytes, key: str | None = None,
               volume: int | None = None) -> bytes:
        """Byte seams: `torn` truncates the payload by `frac`; `corrupt`
        flips every bit of ONE byte at position frac*len — deterministic
        silent damage a CRC must catch (the writer never notices). Every
        other mode is handled by hit()."""
        spec = self.spec
        if spec is None or spec.mode not in ("torn", "corrupt"):
            return data
        spec = self.draw(key, volume)
        if spec is None:
            return data
        if spec.mode == "corrupt":
            if not data:
                return data
            pos = min(len(data) - 1, int(len(data) * spec.frac))
            out = bytearray(data)
            out[pos] ^= 0xFF
            return bytes(out)
        keep = max(0, int(len(data) * (1.0 - spec.frac)))
        return data[:keep]


def act(name: str, spec: FaultSpec) -> None:
    """Perform a drawn spec's generic behavior (raise/sleep)."""
    mode = spec.mode
    if mode == "latency":
        time.sleep(spec.ms / 1000.0)
    elif mode == "error":
        raise FaultInjected(f"injected fault at {name}")
    elif mode == "disk_full":
        raise OSError(errno.ENOSPC, f"injected disk-full at {name}")
    elif mode == "partition":
        raise FaultPartition(f"injected partition at {name}")
    # torn / corrupt: byte-level, handled at the seam via mangle()/draw()


_lock = threading.Lock()
_points: dict[str, FaultPoint] = {}

# Runtime-arming gate for the HTTP surface: POST /debug/faults can tear
# writes, so it 403s unless the process opted in (a server built with
# `faults=`, or SEAWEEDFS_TPU_FAULTS=1). In-process callers use arm()
# directly and are unaffected.
_enabled = False


def enable() -> None:
    global _enabled
    _enabled = True


def runtime_arming_enabled() -> bool:
    return _enabled or os.environ.get("SEAWEEDFS_TPU_FAULTS") == "1"


def opt_in(spec: str | None) -> None:
    """The `-faults` flag's meaning for a server constructor: None leaves
    the process as it is; "" opts it into runtime arming; a spec string
    also arms it (`arm_from_spec` grammar)."""
    if spec is None:
        return
    enable()
    if spec:
        arm_from_spec(spec)


def register(name: str) -> FaultPoint:
    """Seam registration. Idempotent; the name must be in ALL_POINTS."""
    if name not in ALL_POINTS:
        raise ValueError(f"undeclared fault point {name!r}"
                         f" (add it to faults.ALL_POINTS)")
    with _lock:
        p = _points.get(name)
        if p is None:
            p = _points[name] = FaultPoint(name)
        return p


def point(name: str) -> FaultPoint:
    """Lookup-or-register — the arming side's handle."""
    return register(name)


def registered_points() -> list[str]:
    with _lock:
        return sorted(_points)


def arm(name: str, mode: str, rate: float = 1.0, ms: float = 0.0,
        frac: float = 0.5, count: int = -1, key: str = "",
        after: int = 0) -> FaultSpec:
    """Arm one point. Validates the mode and numeric ranges; replaces
    any existing spec on the point."""
    if mode not in MODES:
        raise ValueError(f"unknown fault mode {mode!r} (one of {MODES})")
    rate, ms, frac = float(rate), float(ms), float(frac)
    count, after = int(count), int(after)
    if not (0.0 < rate <= 1.0):
        raise ValueError(f"rate {rate} not in (0, 1]")
    if ms < 0 or not (0.0 < frac <= 1.0) or ms != ms:
        raise ValueError(f"bad latency/frac ({ms}, {frac})")
    if after < 0:
        raise ValueError(f"after {after} < 0")
    spec = FaultSpec(mode=mode, rate=rate, ms=ms, frac=frac, count=count,
                     key=key, after=after)
    p = point(name)
    with _lock:
        p.spec = spec
    return spec


def disarm(name: str) -> bool:
    """Disarm one point; True if it was armed."""
    p = point(name)
    with _lock:
        was = p.spec is not None
        p.spec = None
    return was


def disarm_all() -> int:
    """Back to the zero-injection steady state; returns how many points
    were armed."""
    n = 0
    with _lock:
        for p in _points.values():
            if p.spec is not None:
                p.spec = None
                n += 1
    return n


def armed() -> dict[str, FaultSpec]:
    with _lock:
        return {n: p.spec for n, p in _points.items() if p.spec is not None}


def snapshot() -> list[dict]:
    """Full state for /debug/faults and cluster.faults -list."""
    with _lock:
        return [
            {"point": n, "fired": p.fired,
             "armed": p.spec.to_dict() if p.spec is not None else None}
            for n, p in sorted(_points.items())
        ]


def arm_from_spec(text: str) -> list[str]:
    """Parse the `-faults` flag grammar and arm each entry:

        point=mode[:k=v[,k=v...]][;point=mode...]

    e.g. `"volume.read.dat=error:rate=0.5;master.assign=latency:ms=20"`.
    Returns the armed point names; raises ValueError on any bad entry."""
    out: list[str] = []
    for entry in text.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        name, _, rest = entry.partition("=")
        mode, _, opts_s = rest.partition(":")
        name, mode = name.strip(), mode.strip()
        if not mode:
            raise ValueError(f"fault spec {entry!r}: missing =mode")
        opts: dict = {}
        for kv in opts_s.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, _, v = kv.partition("=")
            if k not in ("rate", "ms", "frac", "count", "key", "after"):
                raise ValueError(f"fault spec {entry!r}: unknown option {k!r}")
            opts[k] = v if k == "key" else float(v)
        for k in ("count", "after"):
            if k in opts:
                opts[k] = int(opts[k])
        arm(name, mode, **opts)
        out.append(name)
    return out
