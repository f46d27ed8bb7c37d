"""Integrity scrubbing & anti-entropy: find silent damage before a read does.

The port's copy of `seaweedfs_tpu/maintenance/scrub.py`, whole:

  * **Needle scrub** — walk a volume's needle map in bounded batches and
    CRC-verify every live record. Equal-length data segments (groups of
    at least `MIN_BATCH`, none longer than `MAX_BATCH_BLOCK`) verify in
    bulk through the `crc32c_batch` kernel on the scrubber's device, odd
    sizes through the scalar `storage/crc.py` path; bytes and seconds are
    counted per kernel so the split is measured, not assumed.
  * **EC parity scrub** — recompute-and-compare a sampled column slice
    per stripe through the mounted codec (`gf256_matmul`); a slice
    mismatch escalates to a full-width check that LOCATES the corrupt
    shard (the erasure code's redundancy is the checksum).
  * **Anti-entropy digests** — each volume hashes its live needle map
    into an order-independent digest that rides the heartbeat, so the
    master detects replica divergence without moving a byte of data.
  * **Tmp GC** — abandoned `_ShardWriters` `.tmp` litter from aborted or
    replaced pipelined rebuilds is swept, age-gated so in-flight rebuilds
    are never touched.

Findings are typed `ScrubFinding`s. They ride the heartbeat to the
master, where `detect` folds them (and digest divergence) into per-volume
`scrub` tasks, and `plan_scrub_repairs` / `apply_scrub_repairs` route each
kind to an existing heal:

    corrupt_needle     -> re-copy the one needle from a verified-good
                          replica (or reconstruct locally from EC parity)
    corrupt_shard      -> delete the corrupt shard (silent damage becomes
                          visible loss) -> ec.rebuild re-derives it
    parity_mismatch    -> /admin/ec/online/rebuild re-arms the striper
                          and re-encodes from the durable .dat
    replica_divergence -> needle-level re-sync from the digest-majority
                          holder (size-ordered tie-break)
    tmp_litter         -> removed by the scrub pass itself (reported,
                          never routed)

Every byte the scrubber reads is paid for through a token bucket
(`now`/`sleep` injectable, so pacing is deterministic under test).

Differences from the JAX package, by design: every bulk group goes
through the device kernel (the JAX scrubber prefers a host library when
one is built); a failure of the CRC kernel or the codec raises
`ScrubCodecFailed` out of the pass instead of falling to the scalar path
or being swallowed with the volume. The JAX metric families
(`SeaweedFS_volume_scrub_{bytes_total,seconds,findings_total,
repairs_total}`, `ensure_metrics`) and `scrub_finding` events are fed as
in the JAX package; the scrubber also keeps plain counters (`counters`:
bytes and seconds by kernel, findings by kind, and repairs by kind as they
land on this holder), served by `status()`.
"""

from __future__ import annotations

import os
import re
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from ..ops.crc32c_kernel import crc32c_batch
from ..stats import default_registry
from ..stats import events as events_mod
from ..storage import crc as crc_mod
from ..storage.erasure_coding.geometry import DATA_SHARDS_COUNT, TOTAL_SHARDS_COUNT
from ..storage.erasure_coding.online import ParityCodecFailed
from ..storage.needle import get_actual_size
from ..storage.needle_map import EMPTY_NEEDLE_DIGEST, needle_set_digest  # noqa: F401
from ..storage.types import NEEDLE_HEADER_SIZE, get_u32
from ..storage.volume import NotFound

SCRUB_FINDING_KINDS = (
    "corrupt_needle",      # a live needle's data fails its CRC32C
    "corrupt_shard",       # a sealed EC shard is short, unreadable, or
                           # located as the stripe-parity mismatch
    "parity_mismatch",     # an online-EC stripe's recomputed parity
                           # disagrees with the durable parity bytes
    "replica_divergence",  # replica needle-map digests disagree
    "tmp_litter",          # abandoned .tmp shard files (aborted rebuild)
)
SCRUB_KERNELS = ("batched", "scalar", "gf")

_metrics_cache = None


def ensure_metrics(registry=None):
    """Register (idempotently) the scrub families; returns
    (bytes_total{kernel}, seconds{kernel}, findings_total{kind},
    repairs_total{kind})."""
    global _metrics_cache
    if registry is None and _metrics_cache is not None:
        return _metrics_cache
    reg = registry if registry is not None else default_registry()
    out = (
        reg.counter(
            "SeaweedFS_volume_scrub_bytes_total",
            "bytes integrity-verified by the scrubber, by kernel"
            " (batched = bulk CRC32C matmul, scalar = table CRC,"
            " gf = EC parity recompute)",
            ("kernel",),
        ),
        reg.histogram(
            "SeaweedFS_volume_scrub_seconds",
            "wall seconds per scrub verification slice, by kernel"
            " (GB/s = bytes/sum)",
            ("kernel",),
        ),
        reg.counter(
            "SeaweedFS_volume_scrub_findings_total",
            "silent-damage findings detected by scrub passes, by kind",
            ("kind",),
        ),
        reg.counter(
            "SeaweedFS_volume_scrub_repairs_total",
            "scrub findings routed into a repair, by kind",
            ("kind",),
        ),
    )
    if registry is None:
        _metrics_cache = out
    return out


# .tmp litter pattern: the _ShardWriters convention (shard file + .tmp)
_TMP_RE = re.compile(r"\.ec\d\d\.tmp$")

# batch only groups at least this big through the device kernel: smaller
# groups aren't worth a launch, the scalar path wins
MIN_BATCH = 16
# and only blocks up to this long (past this the scalar path is fine)
MAX_BATCH_BLOCK = 1 << 20
# sampled parity checks: bytes per sampled column / stripe rows per pass
SAMPLE_BYTES = 4096
SAMPLE_ROWS = 4


class ScrubCodecFailed(RuntimeError):
    """The CRC kernel or the EC codec raised during a pass. Never read as
    a clean volume, an unreadable one, or a reason to go scalar: the pass
    fails with it."""


@dataclass(frozen=True)
class ScrubFinding:
    """One piece of silent damage a scrub pass proved. `node` is the
    holder that detected it (and that the repair targets); `source_node`
    is only set for replica_divergence (the digest-majority holder to
    re-sync from)."""

    kind: str
    volume_id: int
    node: str = ""
    collection: str = ""
    needle: int | None = None
    shard: int | None = None
    source_node: str = ""
    detail: str = ""
    detected_at: float = field(default_factory=time.time)

    def __post_init__(self):
        if self.kind not in SCRUB_FINDING_KINDS:
            raise ValueError(f"unknown scrub finding kind {self.kind!r}")

    @property
    def key(self) -> tuple:
        return (self.kind, self.volume_id, self.needle, self.shard)

    def to_dict(self) -> dict:
        out = {
            "kind": self.kind, "volume_id": self.volume_id,
            "node": self.node, "collection": self.collection,
            "detail": self.detail,
            "detected_at": round(self.detected_at, 3),
        }
        if self.needle is not None:
            out["needle"] = self.needle
        if self.shard is not None:
            out["shard"] = self.shard
        if self.source_node:
            out["source_node"] = self.source_node
        return out

    @staticmethod
    def from_dict(d: dict) -> "ScrubFinding":
        return ScrubFinding(
            kind=d["kind"], volume_id=int(d["volume_id"]),
            node=d.get("node", ""), collection=d.get("collection", ""),
            needle=d.get("needle"), shard=d.get("shard"),
            source_node=d.get("source_node", ""),
            detail=d.get("detail", ""),
            detected_at=float(d.get("detected_at", 0.0)) or time.time(),
        )


class TokenBucket:
    """Byte-budget throttle: take(n) returns how long the caller must
    sleep before the n bytes are within budget. Deterministic under an
    injected clock."""

    def __init__(self, rate: float, burst: float | None = None) -> None:
        self.rate = float(rate)  # bytes per second
        self.burst = float(burst if burst is not None else rate)
        self._tokens = self.burst
        self._ts: float | None = None

    def take(self, n: int, now: float) -> float:
        """Spend n bytes; returns seconds to sleep (0.0 when within
        budget). The bucket may go negative — the debt converts into the
        returned sleep, so any window's bytes stay <= rate*window+burst."""
        if self.rate <= 0:
            return 0.0
        if self._ts is None:
            self._ts = now
        self._tokens = min(
            self.burst, self._tokens + (now - self._ts) * self.rate
        )
        self._ts = now
        self._tokens -= n
        if self._tokens >= 0:
            return 0.0
        return -self._tokens / self.rate


# --- needle record light parse ----------------------------------------------
def _light_parse(blob: bytes, size: int):
    """(data_bytes, stored_crc) from a raw v2/v3 needle record WITHOUT
    verifying — the scrubber verifies in bulk. Raises ValueError on a
    structurally torn record."""
    if size <= 0:
        return b"", 0
    if len(blob) < NEEDLE_HEADER_SIZE + size + 4:
        raise ValueError("record shorter than its declared size")
    data_size = get_u32(blob, NEEDLE_HEADER_SIZE)
    if data_size + 4 > size:
        raise ValueError("data section out of range")
    data = blob[NEEDLE_HEADER_SIZE + 4:NEEDLE_HEADER_SIZE + 4 + data_size]
    stored = get_u32(blob, NEEDLE_HEADER_SIZE + size)
    return data, stored


def _crc_batch_ok(datas: list[bytes], stored: list[int],
                  device) -> tuple[list[bool], str]:
    """Verify equal-length data blocks against their stored CRCs.
    Returns (ok flags, kernel used). The batched path accepts the legacy
    on-disk CRC transform exactly like Needle.from_bytes does; a failure
    of the kernel raises ScrubCodecFailed."""
    n = len(datas)
    length = len(datas[0])
    if n >= MIN_BATCH and 0 < length <= MAX_BATCH_BLOCK:
        blocks = np.frombuffer(b"".join(datas), dtype=np.uint8).reshape(n, length)
        try:
            actual = np.asarray(crc32c_batch(blocks, device=device)).astype(np.uint64)
        except Exception as e:
            raise ScrubCodecFailed(
                f"crc32c_batch ({n}, {length}) on {device}: {e}") from e
        stored_a = np.asarray(stored, dtype=np.uint64)
        # legacy value: rotate + magic, vectorized (crc.legacy_value)
        rotated = ((actual >> np.uint64(15)) | (actual << np.uint64(17))) \
            & np.uint64(0xFFFFFFFF)
        legacy = (rotated + np.uint64(0xA282EAD8)) & np.uint64(0xFFFFFFFF)
        ok = (stored_a == actual) | (stored_a == legacy)
        return [bool(x) for x in ok], "batched"
    out = []
    for data, want in zip(datas, stored):
        actual = crc_mod.crc32c(data)
        out.append(want == actual or want == crc_mod.legacy_value(actual))
    return out, "scalar"


class VolumeScrubber:
    """Background integrity scrubber for one volume server's Store.

    A pass walks every volume (or one, when scoped): live needles are
    CRC-verified in bulk, online-EC parity is recomputed-and-compared on
    sampled stripe rows, sealed EC shards are length- and parity-checked,
    and stale `.tmp` rebuild litter is swept. Every byte read pays the
    token bucket first, so a pass can never starve foreground reads.
    Findings persist (deduped by key) until a later pass — or a repair
    endpoint — resolves them; unresolved findings ride the heartbeat.
    The bulk CRCs run on the store's device."""

    def __init__(
        self,
        store,
        node_id: str = "",
        rate_mb: float = 8.0,
        batch_bytes: int = 4 << 20,
        tmp_max_age: float = 3600.0,
        active_tmp_paths=None,
        now=None,
        sleep=None,
    ) -> None:
        self.store = store
        self.device = store.device
        self.node_id = node_id
        self.bucket = TokenBucket(rate_mb * 1024 * 1024)
        self.batch_bytes = batch_bytes
        self.tmp_max_age = tmp_max_age
        # callback -> set of .tmp paths belonging to IN-FLIGHT rebuilds
        # (the server's _partial_rebuilds writers): never swept, any age
        self._active_tmp_paths = active_tmp_paths or (lambda: set())
        self._now = now or time.monotonic
        self._sleep = sleep or time.sleep
        self._lock = threading.Lock()
        self._findings: dict[tuple, ScrubFinding] = {}
        # the volumes scrub passes are scanning RIGHT NOW (refcounted):
        # rides heartbeats as `scrub_active` so the master's vacuum scan
        # skips them
        self._scrub_holds: dict[int, int] = {}
        self.stats = {
            "passes": 0, "bytes_scanned": 0, "seconds": 0.0,
            "needles_checked": 0, "stripes_checked": 0,
            "findings": 0, "resolved": 0, "tmp_removed": 0,
            "throttle_waits": 0, "last_pass_at": 0.0,
        }
        # the JAX metric families as plain counters: bytes and seconds by
        # kernel, findings and repairs by kind, and the codec calls of
        # the sealed-EC locator
        self.counters = {
            "bytes": dict.fromkeys(SCRUB_KERNELS, 0),
            "seconds": dict.fromkeys(SCRUB_KERNELS, 0.0),
            "findings": dict.fromkeys(SCRUB_FINDING_KINDS, 0),
            "repairs": dict.fromkeys(SCRUB_FINDING_KINDS, 0),
            "codec_calls": 0,
            "codec_failures": 0,
        }
        (self._m_bytes, self._m_seconds, self._m_findings,
         self._m_repairs) = ensure_metrics()
        # the last pass that failed on the kernel or the codec, kept (with
        # the count above) so a failure in the loop is never dropped
        self.codec_failure: dict | None = None

    # --- throttle -------------------------------------------------------------
    def _pay(self, nbytes: int) -> None:
        wait = self.bucket.take(nbytes, self._now())
        if wait > 0:
            self.stats["throttle_waits"] += 1
            self._sleep(wait)

    def _observe(self, kernel: str, nbytes: int, dt: float) -> None:
        self.stats["bytes_scanned"] += nbytes
        self.stats["seconds"] += dt
        with self._lock:
            self.counters["bytes"][kernel] += nbytes
            self.counters["seconds"][kernel] += dt
        self._m_bytes.labels(kernel).inc(nbytes)
        self._m_seconds.labels(kernel).observe(dt)

    def count_repair(self, kind: str) -> None:
        """A repair of `kind` landed on this holder (the repair endpoints
        call this)."""
        with self._lock:
            self.counters["repairs"][kind] += 1

    # --- findings -------------------------------------------------------------
    def _record(self, f: ScrubFinding) -> None:
        with self._lock:
            fresh = f.key not in self._findings
            self._findings[f.key] = f
            if fresh:
                self.counters["findings"][f.kind] += 1
        if fresh:
            self.stats["findings"] += 1
            self._m_findings.labels(f.kind).inc()
            events_mod.emit("scrub_finding", volume=f.volume_id,
                            node=f.node or None, kind=f.kind,
                            collection=f.collection or "default",
                            **({"needle": f"{f.needle:x}"}
                               if f.needle is not None else {}),
                            **({"shard": f.shard}
                               if f.shard is not None else {}),
                            detail=f.detail[:120])

    def resolve(self, kind: str | None = None, volume: int | None = None,
                needle: int | None = None) -> int:
        """Drop findings a repair just addressed (re-verification at the
        next pass is the ground truth; this keeps the heartbeat from
        re-advertising healed damage for a whole scrub interval)."""
        dropped = 0
        with self._lock:
            for key in list(self._findings):
                f = self._findings[key]
                if kind is not None and f.kind != kind:
                    continue
                if volume is not None and f.volume_id != volume:
                    continue
                if needle is not None and f.needle != needle:
                    continue
                del self._findings[key]
                dropped += 1
        self.stats["resolved"] += dropped
        return dropped

    def unresolved(self) -> list[dict]:
        with self._lock:
            return [f.to_dict() for f in self._findings.values()]

    def active_volumes(self) -> list[int]:
        """Volume ids scrub passes hold RIGHT NOW (one per concurrent
        pass)."""
        with self._lock:
            return sorted(self._scrub_holds)

    def _hold(self, vid: int | None, prev: int | None) -> int | None:
        """Move one pass's hold from `prev` to `vid` (refcounted: an
        overlapping pass on the same volume keeps it held). Returns
        `vid` so callers can thread the current hold through."""
        with self._lock:
            if prev is not None:
                n = self._scrub_holds.get(prev, 0) - 1
                if n <= 0:
                    self._scrub_holds.pop(prev, None)
                else:
                    self._scrub_holds[prev] = n
            if vid is not None:
                self._scrub_holds[vid] = self._scrub_holds.get(vid, 0) + 1
        return vid

    # --- the pass -------------------------------------------------------------
    def scrub_pass(self, volume_id: int | None = None) -> list[ScrubFinding]:
        """One bounded, throttled pass. Returns the findings of THIS
        pass; the persistent set is reconciled (damage that no longer
        reproduces is resolved). A kernel or codec failure raises
        ScrubCodecFailed and reconciles nothing; an unloadable volume is
        skipped as the JAX scrubber skips it."""
        found: list[ScrubFinding] = []
        # per-kind completed scopes: a scan that THREW mid-volume proved
        # nothing — reconciling its scope would silently resolve genuine
        # damage the repair hasn't healed yet
        scanned: dict[str, set[int]] = {
            "corrupt_needle": set(), "corrupt_shard": set(),
            "parity_mismatch": set(),
        }
        held: int | None = None
        try:
            for loc in self.store.locations:
                for v in list(loc.volumes.values()):
                    if volume_id is not None and v.id != volume_id:
                        continue
                    held = self._hold(v.id, held)
                    try:
                        found.extend(self._scrub_needles(v))
                        scanned["corrupt_needle"].add(v.id)
                    except ScrubCodecFailed:
                        raise
                    except Exception:
                        pass  # an unloadable volume must not sink the pass
                    w = getattr(v, "online_ec", None)
                    if w is not None and w.active and not w.sealed:
                        try:
                            found.extend(self._scrub_online_parity(v, w))
                            scanned["parity_mismatch"].add(v.id)
                        except ScrubCodecFailed:
                            raise
                        except Exception:
                            pass
                for ev in list(loc.ec_volumes.values()):
                    if volume_id is not None and ev.volume_id != volume_id:
                        continue
                    held = self._hold(ev.volume_id, held)
                    try:
                        found.extend(self._scrub_sealed_ec(ev))
                        scanned["corrupt_shard"].add(ev.volume_id)
                    except ScrubCodecFailed:
                        raise
                    except Exception:
                        pass
                if volume_id is None:
                    try:
                        found.extend(self._gc_tmp_litter(loc.directory))
                    except Exception:
                        pass
        except ScrubCodecFailed as e:
            with self._lock:
                self.counters["codec_failures"] += 1
                self.codec_failure = {
                    "error": "codec_failed", "node": self.node_id,
                    "detail": str(e)[:200], "at": time.time()}
            raise
        finally:
            held = self._hold(None, held)
        # reconcile: a prior finding whose scope COMPLETED this pass
        # without reproducing it was healed (or was transient)
        fresh_keys = {f.key for f in found}
        with self._lock:
            for key in list(self._findings):
                f = self._findings[key]
                if f.volume_id in scanned.get(f.kind, ()) \
                        and key not in fresh_keys:
                    del self._findings[key]
                    self.stats["resolved"] += 1
        for f in found:
            self._record(f)
        self.stats["passes"] += 1
        self.stats["last_pass_at"] = time.time()
        return found

    # --- needle scrub ---------------------------------------------------------
    @staticmethod
    def _confirm_corrupt(v, needle_id: int) -> bool:
        """Re-verify a suspected needle through the seqlock-disciplined
        direct read path before alarming: the bulk scan reads (nm, dat)
        lock-free, so a vacuum commit swapping both mid-scan can pair
        the old map's offset with the new file and fabricate damage.
        Real corruption fails here too (deliberately NOT read_needle —
        its degraded ladder would reconstruct from parity and hide the
        on-disk rot this pass exists to surface)."""
        for _ in range(3):
            gen = v._compact_gen
            if gen & 1:  # swap in flight: wait it out
                time.sleep(0.001)
                continue
            try:
                v._read_needle_once(needle_id, None)
                return False  # reads clean: a transient race, not rot
            except Exception as e:
                if isinstance(e, NotFound) and v._compact_gen == gen:
                    return False  # deleted/compacted away meanwhile
                if v._compact_gen == gen:
                    return True  # stable generation, still failing
        # the generation kept moving (a slow vacuum commit outlasted the
        # retries): UNPROVEN, not corrupt — the next pass re-checks
        return False

    def _scrub_needles(self, v) -> list[ScrubFinding]:
        """CRC-verify every live needle, reading in batch_bytes slices
        and verifying equal-length data in bulk through crc32c_batch."""
        findings: list[ScrubFinding] = []
        version = v.version()
        batch: list[tuple[int, bytes, int]] = []  # (needle_id, data, crc)
        batch_bytes = 0

        def suspect(nid: int, detail: str) -> None:
            if self._confirm_corrupt(v, nid):
                findings.append(ScrubFinding(
                    "corrupt_needle", v.id, node=self.node_id,
                    collection=v.collection, needle=nid, detail=detail,
                ))

        def flush() -> None:
            nonlocal batch, batch_bytes
            if not batch:
                return
            by_len: dict[int, list[int]] = {}
            for i, (_nid, data, _crc) in enumerate(batch):
                by_len.setdefault(len(data), []).append(i)
            for _length, idxs in by_len.items():
                datas = [batch[i][1] for i in idxs]
                stored = [batch[i][2] for i in idxs]
                nbytes = sum(len(d) for d in datas)
                t0 = time.perf_counter()
                ok, kernel = _crc_batch_ok(datas, stored, self.device)
                self._observe(kernel, nbytes, time.perf_counter() - t0)
                for flag, i in zip(ok, idxs):
                    if not flag:
                        suspect(batch[i][0], "data CRC32C mismatch")
            self.stats["needles_checked"] += len(batch)
            batch, batch_bytes = [], 0

        for key, offset, size in list(v.nm.ascending_visit()):
            total = get_actual_size(size, version)
            self._pay(total)
            try:
                blob = v._dat.read_at(total, offset)
                if len(blob) < total:
                    raise ValueError(f"short read {len(blob)} < {total}")
                data, stored = _light_parse(blob, size)
            except Exception as e:
                suspect(key, f"unreadable record: {str(e)[:80]}")
                continue
            batch.append((key, data, stored))
            batch_bytes += len(data)
            if batch_bytes >= self.batch_bytes:
                flush()
        flush()
        if self.store.get_volume(v.id) is not v:
            # the volume left this server mid-scan (moved, deleted or
            # unmounted: its files closed under the scan), so what failed
            # to read is EBADF noise, not rot
            return []
        return findings

    # --- online-EC parity scrub -----------------------------------------------
    def _scrub_online_parity(self, v, w) -> list[ScrubFinding]:
        """Recompute-and-compare sampled stripe rows of a LIVE online-EC
        volume (OnlineEcWriter.scrub_sample holds the writer lock while
        it reads/encodes, so the token bucket is paid AFTER the call)."""
        t0 = time.perf_counter()
        try:
            checked, mismatches = w.scrub_sample(
                max_rows=SAMPLE_ROWS, sample_bytes=SAMPLE_BYTES,
            )
        except ParityCodecFailed as e:
            raise ScrubCodecFailed(f"volume {v.id}: {e}") from e
        if checked:
            self._observe("gf", checked, time.perf_counter() - t0)
            self._pay(checked)
            self.stats["stripes_checked"] += SAMPLE_ROWS
        return [
            ScrubFinding(
                "parity_mismatch", v.id, node=self.node_id,
                collection=v.collection,
                detail=f"stripe row {row}: recomputed parity disagrees",
            )
            for row in mismatches
        ]

    # --- sealed EC scrub --------------------------------------------------------
    def _scrub_sealed_ec(self, ev) -> list[ScrubFinding]:
        """Length-check every local shard; when ALL 14 are local (the
        encode-in-place window, before spread), recompute-and-compare a
        sampled column per stripe and LOCATE the corrupt shard via the
        code's own redundancy. With a partial local set the deep check
        is skipped — scrub never moves shard data over the wire."""
        findings: list[ScrubFinding] = []
        shard_size = ev.shard_size
        local: dict[int, int] = dict(ev.shards)
        for sid, fd in sorted(local.items()):
            try:
                size = os.fstat(fd).st_size
            except OSError:
                size = -1
            if size < shard_size:
                findings.append(ScrubFinding(
                    "corrupt_shard", ev.volume_id, node=self.node_id,
                    collection=ev.collection, shard=sid,
                    detail=f"shard file {size} < {shard_size} bytes",
                ))
        if getattr(ev, "_closed", False):
            # an atomic remount swapped this instance out mid-scan and
            # closed its fds: what was read above is EBADF noise
            return []
        if len(local) < TOTAL_SHARDS_COUNT or shard_size <= 0 or findings:
            return findings
        # sampled columns: a slice at the head, middle and tail of the
        # shard length — GF is byte-wise, so slices verify independently
        width = min(SAMPLE_BYTES, shard_size)
        offsets = sorted({
            0, max(0, shard_size // 2 - width // 2), shard_size - width,
        })
        for off in offsets:
            self._pay(width * TOTAL_SHARDS_COUNT)
            cols: dict[int, np.ndarray] = {}
            for sid, fd in local.items():
                try:
                    data = os.pread(fd, width, off)
                except OSError:
                    data = b""  # remount race (closed fd) or real loss
                if len(data) != width:
                    if getattr(ev, "_closed", False):
                        return []  # swapped out mid-scan: EBADF noise
                    findings.append(ScrubFinding(
                        "corrupt_shard", ev.volume_id, node=self.node_id,
                        collection=ev.collection, shard=sid,
                        detail=f"short pread at {off}",
                    ))
                    return findings
                cols[sid] = np.frombuffer(data, dtype=np.uint8)
            t0 = time.perf_counter()
            suspect = self._verify_columns(cols, ev.codec, DATA_SHARDS_COUNT)
            self._observe(
                "gf", width * TOTAL_SHARDS_COUNT, time.perf_counter() - t0
            )
            self.stats["stripes_checked"] += 1
            if suspect is None:
                continue
            if suspect < 0:
                findings.append(ScrubFinding(
                    "corrupt_shard", ev.volume_id, node=self.node_id,
                    collection=ev.collection,
                    detail=f"parity mismatch at {off}, not localizable",
                ))
            else:
                findings.append(ScrubFinding(
                    "corrupt_shard", ev.volume_id, node=self.node_id,
                    collection=ev.collection, shard=suspect,
                    detail=f"located via parity recompute at {off}",
                ))
            return findings  # one located finding per volume per pass
        return findings

    def _codec(self, fn, *args, **kw):
        """One codec call of the sealed-EC check, counted; its failure is
        ScrubCodecFailed."""
        with self._lock:
            self.counters["codec_calls"] += 1
        try:
            return fn(*args, **kw)
        except Exception as e:
            raise ScrubCodecFailed(f"EC codec: {e}") from e

    def _verify_columns(self, cols: dict[int, np.ndarray], codec,
                        data_shards: int) -> int | None:
        """None = consistent; >= 0 = the located corrupt shard; -1 =
        inconsistent but not localizable (multi-shard damage). Up to one
        reconstruct and one encode a suspect, each its own launch."""
        total = len(cols)

        def verifies(full: dict[int, np.ndarray]) -> bool:
            expect = self._codec(
                codec.encode, np.stack([full[c] for c in range(data_shards)])
            )
            return all(
                np.array_equal(expect[p - data_shards], full[p])
                for p in range(data_shards, total)
            )

        if verifies(cols):
            return None
        for suspect in sorted(cols):
            present = {c: b for c, b in cols.items() if c != suspect}
            rec = self._codec(codec.reconstruct, present, targets=[suspect])
            cand = dict(cols)
            cand[suspect] = rec[suspect]
            if verifies(cand):
                return suspect
        return -1

    # --- tmp litter GC ----------------------------------------------------------
    def _gc_tmp_litter(self, directory: str) -> list[ScrubFinding]:
        """Sweep abandoned `.ecNN.tmp` files (aborted/replaced pipelined
        rebuilds, crashed seals). Age-gated AND excluded when an
        in-flight rebuild still owns the path."""
        findings: list[ScrubFinding] = []
        try:
            names = os.listdir(directory)
        except OSError:
            return findings
        active = {os.path.abspath(p) for p in self._active_tmp_paths()}
        now = time.time()
        for name in names:
            if not _TMP_RE.search(name):
                continue
            path = os.path.join(directory, name)
            if os.path.abspath(path) in active:
                continue
            try:
                age = now - os.path.getmtime(path)
            except OSError:
                continue
            if age < self.tmp_max_age:
                continue
            try:
                os.unlink(path)
            except OSError:
                continue
            self.stats["tmp_removed"] += 1
            # reported (counted) but repaired in place — never routed to
            # the master (there is nothing left to heal)
            with self._lock:
                self.counters["findings"]["tmp_litter"] += 1
                self.counters["repairs"]["tmp_litter"] += 1
            self._m_findings.labels("tmp_litter").inc()
            self._m_repairs.labels("tmp_litter").inc()
            events_mod.emit("scrub_finding", node=self.node_id or None,
                            kind="tmp_litter", path=name,
                            age_s=round(age, 1))
        return findings

    def status(self) -> dict:
        with self._lock:
            counters = {k: dict(v) if isinstance(v, dict) else v
                        for k, v in self.counters.items()}
        return {
            "node": self.node_id,
            "device": str(self.device),
            "rate_bytes_per_sec": self.bucket.rate,
            "stats": dict(self.stats),
            "counters": counters,
            "codec_failure": self.codec_failure,
            "unresolved": self.unresolved(),
        }


# --- master side: detector ----------------------------------------------------
def detect(master) -> list:
    """The `scrub` maintenance detector: fold each node's
    heartbeat-reported findings into per-volume repair tasks, and run
    the anti-entropy digest comparison across replica holders (pure
    metadata — no data moves until the executor repairs)."""
    from .detectors import _task

    by_vol: dict[int, list[dict]] = {}
    node_of: dict[int, str] = {}
    for node in master.topo.all_nodes():
        for fd in getattr(node, "scrub_findings", ()):
            kind = fd.get("kind")
            if kind not in SCRUB_FINDING_KINDS or kind == "tmp_litter":
                continue
            vid = int(fd.get("volume_id", 0))
            by_vol.setdefault(vid, []).append(dict(fd))
            node_of.setdefault(vid, fd.get("node") or node.id)

    # replica divergence off heartbeat digests. Source = the
    # digest-majority holder; ties break toward the LARGEST reported size
    # (append-only volumes grow on every operation, so the longest
    # replica has seen the most history)
    holders: dict[int, list[tuple]] = {}
    online = master.topo.ec_online_volumes()
    for node in master.topo.all_nodes():
        for vid, info in node.volumes.items():
            digest = getattr(info, "needle_digest", "")
            if not digest or vid in online or info.ec_online:
                continue
            holders.setdefault(vid, []).append((node, info, digest))
    for vid, hs in sorted(holders.items()):
        if len(hs) < 2:
            continue
        digests = {d for _, _, d in hs}
        if len(digests) <= 1:
            continue
        counts: dict[str, int] = {}
        for _, _, d in hs:
            counts[d] = counts.get(d, 0) + 1
        # the empty-set digest can never win the majority: an append-only
        # replica with no history is simply BEHIND any populated peer
        candidates = {d: c for d, c in counts.items()
                      if d != EMPTY_NEEDLE_DIGEST}
        if not candidates:
            continue
        majority = max(
            candidates.items(),
            key=lambda kv: (kv[1], max(
                info.size for _, info, d in hs if d == kv[0]
            )),
        )[0]
        source = max(
            (h for h in hs if h[2] == majority),
            key=lambda h: h[1].size,
        )[0]
        for node, info, d in hs:
            if d == majority:
                continue
            by_vol.setdefault(vid, []).append(ScrubFinding(
                "replica_divergence", vid, node=node.id,
                collection=info.collection, source_node=source.id,
                detail=f"digest {d} != majority {majority}",
            ).to_dict())
            node_of.setdefault(vid, node.id)

    tasks = []
    for vid, fs in sorted(by_vol.items()):
        kinds = sorted({f["kind"] for f in fs})
        tasks.append(_task(
            "scrub", volume_id=vid,
            collection=fs[0].get("collection", ""),
            node=node_of.get(vid, ""),
            reason=f"{len(fs)} scrub finding(s): {', '.join(kinds)}",
            params={"findings": fs},
        ))
    return tasks


# --- repair routing: plan/apply shared with the volume.scrub verb -------------
def plan_scrub_repairs(env, findings: list[dict]) -> list[dict]:
    """Route each finding to its heal."""
    servers = env.servers()
    by_id = {sv.id: sv for sv in servers}
    actions: list[dict] = []
    for fd in findings:
        f = ScrubFinding.from_dict(fd) if isinstance(fd, dict) else fd
        holder = by_id.get(f.node)
        base = {"kind": f.kind, "volume": f.volume_id, "node": f.node,
                "collection": f.collection}
        if holder is None:
            actions.append({**base, "skip": "holder no longer in topology"})
            continue
        base["node_url"] = holder.http
        if f.kind == "corrupt_needle":
            others = [sv for sv in servers
                      if f.volume_id in sv.volumes and sv.id != f.node]
            actions.append({
                **base, "needle": f.needle,
                "source": others[0].id if others else None,
                "source_url": others[0].http if others else None,
                # every other holder is a candidate — apply walks them in
                # order and falls back to local EC reconstruction
                "sources": [{"id": sv.id, "url": sv.http}
                            for sv in others],
            })
        elif f.kind == "corrupt_shard":
            if f.shard is None:
                actions.append(
                    {**base, "skip": "corrupt shard not localized"})
            else:
                actions.append({**base, "shard": f.shard})
        elif f.kind == "parity_mismatch":
            actions.append(base)
        elif f.kind == "replica_divergence":
            src = by_id.get(f.source_node)
            if src is None:
                actions.append(
                    {**base, "skip": "majority holder gone"})
            else:
                actions.append({**base, "source": src.id,
                                "source_url": src.http})
        else:  # tmp_litter never reaches the master; belt and braces
            actions.append({**base, "skip": "locally repaired"})
    return actions


def describe_scrub_repairs(actions: list[dict]) -> list[str]:
    """Display lines of a plan — the verb's dry-run output."""
    out = []
    for a in actions:
        head = f"volume {a['volume']} [{a['kind']}] on {a['node']}"
        if a.get("skip"):
            out.append(f"{head}: SKIP ({a['skip']})")
        elif a["kind"] == "corrupt_needle":
            src = a.get("source")
            out.append(
                f"{head}: re-copy needle {a['needle']:x} from "
                + (src if src else "local EC reconstruction")
            )
        elif a["kind"] == "corrupt_shard":
            out.append(
                f"{head}: delete corrupt shard {a['shard']} ->"
                f" ec_rebuild re-derives it"
            )
        elif a["kind"] == "parity_mismatch":
            out.append(f"{head}: re-arm online striper, re-encode parity"
                       f" from the durable .dat")
        elif a["kind"] == "replica_divergence":
            out.append(f"{head}: re-sync needles from digest-majority"
                       f" holder {a['source']}")
    return out


def _resolve(env, action: dict) -> None:
    """Tell the holder's scrubber its finding was just repaired, so the
    heartbeat stops re-advertising it. Best-effort: the next scheduled
    pass re-verifies regardless."""
    try:
        env.post(
            f"{action['node_url']}/admin/scrub/resolve",
            {"kind": action["kind"], "volume": action["volume"]},
            timeout=30,
        )
    except Exception:
        pass


def _repair_needle(env, a: dict) -> str:
    """Try every candidate source in order, then local EC
    reconstruction."""
    errors: list[str] = []
    for s in a.get("sources") or []:
        try:
            env.post(
                f"{a['node_url']}/admin/scrub/repair_needle",
                {"volume": a["volume"], "needle": a["needle"],
                 "source": s["url"]},
                timeout=120,
            )
            return (f"volume {a['volume']}: needle {a['needle']:x}"
                    f" re-written from {s['id']}")
        except Exception as e:
            errors.append(f"{s['id']}: {str(e)[:60]}")
    try:
        env.post(
            f"{a['node_url']}/admin/scrub/repair_needle",
            {"volume": a["volume"], "needle": a["needle"]},
            timeout=120,
        )
        return (f"volume {a['volume']}: needle {a['needle']:x}"
                f" re-written from local reconstruction")
    except Exception as e:
        errors.append(f"local reconstruction: {str(e)[:60]}")
    raise RuntimeError("; ".join(errors))


def apply_scrub_repairs(env, actions: list[dict]) -> list[str]:
    """Apply every routed repair, isolating failures per action. Raises
    only when NOTHING succeeded."""
    m_repairs = ensure_metrics()[3]
    applied: list[str] = []
    failures: list[str] = []
    for a in actions:
        if a.get("skip"):
            continue
        try:
            applied.append(_apply_one(env, a))
            m_repairs.labels(a["kind"]).inc()
        except Exception as e:
            failures.append(
                f"volume {a['volume']} [{a['kind']}] on {a['node']}:"
                f" FAILED ({str(e)[:140]})")
    if failures and not applied:
        raise RuntimeError("; ".join(failures))
    return applied + failures


def _apply_one(env, a: dict) -> str:
    kind = a["kind"]
    if kind == "corrupt_needle":
        return _repair_needle(env, a)
    elif kind == "corrupt_shard":
        # silent corruption becomes visible loss: ec.rebuild re-derives it
        env.post(
            f"{a['node_url']}/admin/ec/delete_shards",
            {"volume": a["volume"], "shards": [a["shard"]],
             "collection": a.get("collection", "")},
            timeout=60,
        )
        _resolve(env, a)
        return (f"volume {a['volume']}: corrupt shard {a['shard']} deleted"
                f" on {a['node']} (ec_rebuild will re-derive it)")
    elif kind == "parity_mismatch":
        out = env.post(
            f"{a['node_url']}/admin/ec/online/rebuild",
            {"volume": a["volume"]}, timeout=3600,
        )
        _resolve(env, a)
        return (f"volume {a['volume']}: parity re-encoded to watermark"
                f" {out.get('watermark')} on {a['node']}")
    elif kind == "replica_divergence":
        out = env.post(
            f"{a['node_url']}/admin/scrub/sync",
            {"volume": a["volume"], "source": a["source_url"]},
            timeout=3600,
        )
        return (f"volume {a['volume']}: re-synced from {a['source']}"
                f" (+{out.get('copied', 0)} needles,"
                f" -{out.get('deleted', 0)} stale)")
    raise RuntimeError(f"unroutable finding kind {kind!r}")
