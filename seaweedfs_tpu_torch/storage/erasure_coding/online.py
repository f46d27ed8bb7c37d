"""Online (write-path) erasure coding: stream-encode on ingest.

The port's copy of `seaweedfs_tpu/storage/erasure_coding/online.py`, built
around the port's `RSCodec`: the stripe rows' parity is computed by the
`gf256_matmul` kernel on the card (or by its plain PyTorch version when
the caller passes `device="cpu"`).

`OnlineEcWriter` fronts one live Volume:

  * needle appends land in the .dat exactly as before;
  * the writer keeps a stripe-aligned watermark. Once a full stripe row
    (DATA_SHARDS x block bytes of .dat) exists past it, the row streams
    read -> encode -> write through the codec and ONLY PARITY is written
    out, at the row's shard offset in the open .ec10-.ec13 shard files.
    Data shards are pure byte-rearrangements of the .dat
    (geometry.locate_data), so they are never materialized during
    ingest. Write amplification: 1.0 (dat) + 0.4 (parity) = 1.4x;
  * a fixed-record journal (`.ecp`) persists the watermark after every
    parity write, so a crash replays cleanly: re-encode from the last
    durable watermark (parity bytes are a pure function of .dat bytes at
    fixed offsets);
  * trickle writes age out to a timed flush: a partially-filled row is
    encoded zero-padded and re-encoded as it fills (the `trickle_flush`
    fallback reason — visible, not pathological);
  * when the encoder cannot keep up (the un-encoded backlog exceeds
    `max_lag_stripes`), the writer deactivates itself and the volume
    falls back to classic replicate-then-seal-EC (`backpressure`);
  * seal() finishes the tail row and materializes .ec00-.ec09 with a
    straight sequential copy from the .dat — no GF math.

Online volumes use a UNIFORM stripe geometry (large == small == block),
recorded in the volume's `.vif` (`ec_online.block_size` + the
`large_block_size` / `small_block_size` keys EcVolume and the decode path
read back), so sealed shards read identically to offline-encoded ones.

Every row batch goes through one buffered path: a positional read of the
.dat into pinned staging memory taken once from the codec, the codec's
`encode_rows_async`, and a positional write of the parity. The JAX
package's zero-copy mapped GFNI path and its threaded split probe are
host GFNI and are not ported. The raw counters (`stripes`,
`encoded_bytes`, `encode_seconds`, `parity_bytes`, `fallbacks`,
`journal_replays`) feed the JAX package's `SeaweedFS_volume_ec_online_*`
families by volume (`ensure_metrics`), and a degrade journals a
`fallback_ec_online` event. The `volume.ec.parity.write` fault point fails a pump (`error`,
`disk_full`: the writer degrades as on a real emit failure) or, in `torn`
mode, chops the tail off parity shard 0 after a pump wrote rows, which only
`parity_health()` notices and `rearm()` heals.
"""

from __future__ import annotations

import os
import struct
import threading
import time

import numpy as np

from seaweedfs_tpu_torch.ops.rs_kernel import RSCodec
from seaweedfs_tpu_torch.stats import default_registry
from seaweedfs_tpu_torch.stats import events as events_mod
from seaweedfs_tpu_torch.storage import crc as crc_mod
from seaweedfs_tpu_torch.util import faults

from . import encoder as encoder_mod
from .geometry import (
    DATA_SHARDS_COUNT,
    PARITY_SHARDS_COUNT,
    SMALL_BLOCK_SIZE,
    TOTAL_SHARDS_COUNT,
    shard_file_size,
    to_ext,
)

FALLBACK_REASONS = (
    "backpressure",     # un-encoded backlog exceeded max_lag_stripes
    "encoder_error",    # the codec/parity write raised
    "trickle_flush",    # timed flush of a partial row (expected for
                        # trickle traffic; the row re-encodes as it fills)
    "journal_io",       # .ecp journal unwritable
    "vacuum_reset",     # compaction rewrote the .dat; parity restarted
    "parity_rearm",     # lost/torn parity shard: restarted + re-encoded
                        # from the durable .dat (the heal, not the fault)
)
# reasons that mean online EC is BROKEN for the volume; trickle_flush,
# vacuum_reset and parity_rearm are expected operation
PATHOLOGICAL_REASONS = ("backpressure", "encoder_error", "journal_io")

# the parity-emit seam: error/disk_full fail a pump, torn tears shard 0
_FP_PARITY = faults.register("volume.ec.parity.write")

# .ecp journal: fixed 24-byte records, last valid record wins.
# magic u32 | watermark u64 | partial u64 | crc32c u32 (over bytes 0..19)
_JOURNAL_MAGIC = 0x53574550  # "SWEP"
_JOURNAL_REC = struct.Struct("<IQQI")


class ParityCodecFailed(RuntimeError):
    """`scrub_sample`'s parity recompute raised in the codec (the kernel
    or its copies): the scrub pass must fail, not read it as a clean or an
    unreadable volume."""


_metrics_cache = None


def ensure_metrics(registry=None):
    """Register (idempotently) the ec_online families; returns the tuple
    (stripes_total, encode_seconds, bytes_total, buffered_bytes,
    journal_replays_total, fallbacks_total)."""
    global _metrics_cache
    if registry is None and _metrics_cache is not None:
        return _metrics_cache
    reg = registry if registry is not None else default_registry()
    out = (
        reg.counter(
            "SeaweedFS_volume_ec_online_stripes_total",
            "stripe rows parity-encoded on the ingest path",
            ("volume",),
        ),
        reg.histogram(
            "SeaweedFS_volume_ec_online_encode_seconds",
            "per-batch read+encode+parity-write seconds on the ingest path",
            ("volume",),
        ),
        reg.counter(
            "SeaweedFS_volume_ec_online_bytes_total",
            ".dat bytes parity-encoded online (GB/s = bytes/sum(seconds))",
            ("volume",),
        ),
        reg.gauge(
            "SeaweedFS_volume_ec_online_buffered_bytes",
            "ingested bytes not yet covered by a durable parity watermark",
            ("volume",),
        ),
        reg.counter(
            "SeaweedFS_volume_ec_online_journal_replays_total",
            "partial-stripe journal replays (re-encode from the watermark)",
            ("volume",),
        ),
        reg.counter(
            "SeaweedFS_volume_ec_online_fallbacks_total",
            "online-EC degrade events by reason",
            ("volume", "reason"),
        ),
    )
    if registry is None:
        _metrics_cache = out
    return out


class OnlineEcWriter:
    """Streams one live Volume's appends through the RS encoder,
    emitting parity shards incrementally. See module docstring. The codec
    is `codec`, else one on `device`: cuda unless "cpu" is passed, and
    with neither nor CUDA construction raises before any file is touched."""

    def __init__(
        self,
        volume,
        block_size: int | None = None,
        codec: RSCodec | None = None,
        flush_age: float = 2.0,
        max_lag_stripes: int = 256,
        device=None,
    ) -> None:
        self.codec = codec or RSCodec(device=device)
        self.volume = volume
        info = encoder_mod.load_volume_info(volume.base_name + ".vif")
        oe = dict(info.get("ec_online") or {})
        self.block = int(block_size or oe.get("block_size") or SMALL_BLOCK_SIZE)
        self.stripe = self.block * DATA_SHARDS_COUNT
        self.flush_age = flush_age
        self.max_lag_stripes = max_lag_stripes
        self.active = True
        self.sealed = False
        self.fallback_reason: str | None = None
        self._lock = threading.Lock()
        self.stripes = 0
        self.encoded_bytes = 0
        self.encode_seconds = 0.0
        self.parity_bytes = 0
        self.journal_replays = 0
        self.fallbacks: dict[str, int] = {}
        (self._m_stripes, self._m_seconds, self._m_bytes, self._m_buffered,
         self._m_replays, self._m_fallbacks) = ensure_metrics()
        self._vol_label = str(volume.id)
        # reused stripe read buffer, pinned on cuda (codec.host_buffer):
        # the codec would otherwise stage every row through a fresh
        # page-locked copy
        self._buf: np.ndarray | None = None
        self._parity_rows_sized = 0  # rows the parity fds are truncated to

        if oe.get("block_size") != self.block:
            oe["block_size"] = self.block
            _merge_vif(volume.base_name + ".vif", {"ec_online": oe},
                       version=volume.version())

        # open parity shards (grown incrementally, readable while open)
        self._parity_fds: list[int] = []
        try:
            for p in range(PARITY_SHARDS_COUNT):
                path = volume.base_name + to_ext(DATA_SHARDS_COUNT + p)
                self._parity_fds.append(
                    os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
                )
        except OSError:
            for fd in self._parity_fds:
                os.close(fd)
            raise
        # re-attach: never shrink below what's already on disk (all of it
        # is at or ahead of the replayed watermark)
        self._parity_rows_sized = min(
            os.fstat(fd).st_size for fd in self._parity_fds
        ) // self.block

        # journal replay: resume from the last durable watermark; any
        # .dat bytes past it are simply re-encoded
        self._journal_path = volume.base_name + ".ecp"
        self.watermark, self._partial = self._load_journal()
        self._journal_fd = os.open(
            self._journal_path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644
        )
        self._pending_since: float | None = None
        behind = self._end() - self.watermark
        if behind > 0 and self._journal_existed:
            self.journal_replays += 1
            self._m_replays.labels(self._vol_label).inc()
            self.pump(force=self._partial > 0)

    # --- journal ------------------------------------------------------------
    def _load_journal(self) -> tuple[int, int]:
        self._journal_existed = os.path.exists(self._journal_path)
        watermark, partial = 0, 0
        if not self._journal_existed:
            return 0, 0
        try:
            with open(self._journal_path, "rb") as f:
                blob = f.read()
        except OSError:
            return 0, 0
        n = len(blob) // _JOURNAL_REC.size
        for i in range(n):
            rec = blob[i * _JOURNAL_REC.size:(i + 1) * _JOURNAL_REC.size]
            magic, wm, part, crc = _JOURNAL_REC.unpack(rec)
            if magic != _JOURNAL_MAGIC:
                continue
            if crc_mod.crc32c(rec[:20]) != crc:
                continue  # torn record (crash mid-append): skip
            watermark, partial = wm, part
        return watermark, partial

    def _journal_append(self) -> None:
        body = _JOURNAL_REC.pack(
            _JOURNAL_MAGIC, self.watermark, self._partial, 0
        )[:20]
        rec = body + struct.pack("<I", crc_mod.crc32c(body))
        try:
            os.write(self._journal_fd, rec)
        except OSError:
            self._degrade("journal_io")

    # --- helpers ------------------------------------------------------------
    def _end(self) -> int:
        return self.volume.size()

    def _read_dat(self, offset: int, size: int) -> bytes:
        data = self.volume._dat.read_at(size, offset)
        if len(data) < size:
            data = data + b"\0" * (size - len(data))
        return data

    def _read_dat_into(self, offset: int, size: int, out: np.ndarray) -> None:
        """Positional read into a reused buffer, zero-filled past EOF."""
        encoder_mod._pread_padded(self.volume._dat._fd, offset, size, out)

    def _size_parity(self, rows_needed: int) -> None:
        """Pre-truncate the parity fds ahead of the write watermark:
        file-extending pwrite is much slower than writes into a pre-sized
        file."""
        if rows_needed <= self._parity_rows_sized:
            return
        grow_to = max(rows_needed, self._parity_rows_sized + 64)
        for fd in self._parity_fds:
            os.ftruncate(fd, grow_to * self.block)
        self._parity_rows_sized = grow_to

    def _write_parity(self, parity: np.ndarray, row: int, nrows: int) -> None:
        width = nrows * self.block
        for p in range(PARITY_SHARDS_COUNT):
            os.pwrite(self._parity_fds[p], parity[p, :width], row * self.block)

    def _count_fallback(self, reason: str) -> None:
        self.fallbacks[reason] = self.fallbacks.get(reason, 0) + 1
        self._m_fallbacks.labels(self._vol_label, reason).inc()
        events_mod.emit("fallback_ec_online", volume=int(self._vol_label),
                        reason=reason)

    def _degrade(self, reason: str) -> None:
        """Leave online mode: the volume reverts to classic
        replicate-then-seal-EC. Idempotent — the first reason wins."""
        if not self.active:
            return
        self._count_fallback(reason)
        self.active = False
        self.fallback_reason = reason

    # --- encode -------------------------------------------------------------
    def _encode_span(self, offset: int, nrows: int, span: int) -> None:
        """Encode nrows rows starting at .dat offset `offset` (stripe
        aligned); `span` caps the real bytes (the rest zero-padded — only
        ever for the final partial row). Parity lands at the rows' shard
        offsets in the open .ec10-.ec13 fds."""
        t0 = time.perf_counter()
        need = nrows * self.stripe
        self._buf = encoder_mod._ensure_buf(self._buf, need, need, self.codec)
        buf = self._buf[:need]
        real = min(span, need)
        self._read_dat_into(offset, real, buf)
        if real < need:
            buf[real:] = 0
        parity = self.codec.encode_rows_async(buf, self.block, nrows).result()
        row = offset // self.stripe
        self._size_parity(row + nrows)
        self._write_parity(parity, row, nrows)
        dt = time.perf_counter() - t0
        self.encode_seconds += dt
        self.encoded_bytes += need
        self.parity_bytes += nrows * self.block * PARITY_SHARDS_COUNT
        self.stripes += nrows
        self._m_seconds.labels(self._vol_label).observe(dt)
        self._m_bytes.labels(self._vol_label).inc(need)
        self._m_stripes.labels(self._vol_label).inc(nrows)

    def _encode_backlog_pipelined(self, offset: int, nrows: int) -> None:
        """Catch-up path for multi-stripe backlogs (journal replay, seal):
        row batches stream through encoder._run_pipeline — reader thread
        (preadv into the shared ring of pinned buffers) -> codec -> writer
        thread (parity pwrite + journal advance) — so read, encode and
        write overlap."""
        batch_rows = max(1, encoder_mod.DEFAULT_BATCH_HOST // self.block)
        self._size_parity(offset // self.stripe + nrows)
        jobs = [
            (offset + r * self.stripe, min(batch_rows, nrows - r))
            for r in range(0, nrows, batch_rows)
        ]
        t0 = time.perf_counter()

        def read_job(job, buf):
            off, rows = job
            need = rows * self.stripe
            buf = encoder_mod._ensure_buf(
                buf, need, batch_rows * self.stripe, self.codec
            )
            self._read_dat_into(off, need, buf)
            return buf

        def encode_job(job, buf):
            _, rows = job
            return self.codec.encode_rows_async(
                buf[: rows * self.stripe], self.block, rows
            )

        def write_job(job, buf, handle):
            off, rows = job
            self._write_parity(handle.result(), off // self.stripe, rows)
            # jobs complete in order: the watermark only ever covers
            # rows whose parity is fully on disk
            self.watermark = off + rows * self.stripe
            self._partial = 0
            self._journal_append()
            self.stripes += rows
            self.parity_bytes += rows * self.block * PARITY_SHARDS_COUNT
            self._m_stripes.labels(self._vol_label).inc(rows)

        encoder_mod._run_pipeline(jobs, read_job, encode_job, write_job)
        dt = time.perf_counter() - t0
        self.encode_seconds += dt
        self.encoded_bytes += nrows * self.stripe
        self._m_seconds.labels(self._vol_label).observe(dt)
        self._m_bytes.labels(self._vol_label).inc(nrows * self.stripe)

    def pump(self, now: float | None = None, force: bool = False) -> int:
        """Encode whatever full stripe rows have accumulated past the
        watermark; with `force` (or once a partial row ages past
        flush_age) also flush the zero-padded tail row. Returns rows
        encoded. Called after each write and from the server's pulse."""
        with self._lock:
            return self._pump_locked(now, force)

    def _pump_locked(self, now: float | None, force: bool) -> int:
        if not self.active or self.sealed:
            return 0
        now = time.monotonic() if now is None else now
        end = self._end()
        behind = end - self.watermark
        self._m_buffered.labels(self._vol_label).set(max(0, behind))
        if behind <= 0:
            self._pending_since = None
            return 0
        if behind > self.max_lag_stripes * self.stripe and not force:
            self._degrade("backpressure")
            return 0
        rows_done = 0
        nrows = behind // self.stripe
        vol = int(self.volume.id)
        try:
            _FP_PARITY.hit(volume=vol)  # error/disk_full degrade like a
            # real emit failure would
            batch_rows = max(1, encoder_mod.DEFAULT_BATCH_HOST // self.block)
            if nrows > max(16, 2 * batch_rows):
                # deep backlog (journal replay, seal catch-up): overlap
                # read/encode/write stages
                self._encode_backlog_pipelined(self.watermark, nrows)
                rows_done += nrows
                nrows = 0
            while nrows > 0:
                take = min(nrows, batch_rows)
                self._encode_span(
                    self.watermark, take, take * self.stripe
                )
                self.watermark += take * self.stripe
                self._partial = 0
                self._journal_append()
                rows_done += take
                nrows -= take
            rem = end - self.watermark
            if rem > 0:
                if self._pending_since is None:
                    self._pending_since = now
                aged = now - self._pending_since >= self.flush_age
                # skip the padded flush when the same partial bytes are
                # already covered (nothing new since the last one)
                if (force or aged) and rem != self._partial:
                    self._encode_span(self.watermark, 1, rem)
                    self._partial = rem
                    self._journal_append()
                    rows_done += 1
                    if not force:
                        self._count_fallback("trickle_flush")
                    self._pending_since = now
            else:
                self._pending_since = None
        except Exception:
            # parity-write/.dat-read/codec failures are encoder errors; a
            # broken JOURNAL already degraded itself (journal_io), and
            # _degrade keeps the first reason
            self._degrade("encoder_error")
            return rows_done
        if rows_done:
            spec = _FP_PARITY.spec
            if spec is not None and spec.mode == "torn":
                spec = _FP_PARITY.draw(volume=vol)
                if spec is not None:
                    self._tear_parity(spec.frac)
        self._m_buffered.labels(self._vol_label).set(
            max(0, self._end() - self.watermark)
        )
        return rows_done

    def _tear_parity(self, frac: float) -> None:
        """Chop the tail off parity shard 0 — the on-disk state a crash
        mid-append leaves. The WRITER believes its watermark: only
        parity_health() can notice."""
        fd = self._parity_fds[0]
        # cut below the DURABLE watermark's rows: the parity files are
        # pre-sized ahead of the write cursor (_size_parity)
        need = (self.watermark // self.stripe) * self.block
        cut = max(1, int(self.block * min(max(frac, 0.0), 1.0)))
        new_size = max(0, min(os.fstat(fd).st_size, need) - cut)
        os.ftruncate(fd, new_size)
        self._parity_rows_sized = min(
            self._parity_rows_sized, new_size // self.block
        )

    def parity_health(self) -> int:
        """Missing-or-short parity shard count, audited against the
        durable watermark (full rows only). Rides the heartbeat, so a LIVE
        online volume whose parity was lost or torn surfaces as
        repairable."""
        if not self.active or self.sealed:
            return 0
        # bounded acquire: a long re-encode holding the lock must not
        # stall the heartbeat — skip the audit this beat
        if not self._lock.acquire(timeout=0.2):
            return 0
        try:
            if not self.active or self.sealed:
                return 0
            need = (self.watermark // self.stripe) * self.block
            damaged = 0
            for p in range(PARITY_SHARDS_COUNT):
                path = self.volume.base_name + to_ext(DATA_SHARDS_COUNT + p)
                try:
                    size = os.path.getsize(path)
                except OSError:
                    damaged += 1
                    continue
                if size < need:
                    damaged += 1
            return damaged
        finally:
            self._lock.release()

    def scrub_sample(self, max_rows: int = 4,
                     sample_bytes: int = 4096) -> tuple[int, list[int]]:
        """Recompute-and-compare a sampled column slice of up to
        `max_rows` durable stripe rows; a slice mismatch escalates to the
        full-width row before it is reported. Returns (bytes_verified,
        mismatching row indices); a codec failure raises
        ParityCodecFailed."""
        with self._lock:
            if not self._parity_fds or self.sealed:
                return 0, []
            rows = self.watermark // self.stripe
            if rows <= 0:
                return 0, []
            picks = sorted({
                int(i) for i in
                np.linspace(0, rows - 1, num=min(max_rows, rows))
            })
            width = min(sample_bytes, self.block)
            checked = 0
            mismatches: list[int] = []
            for row in picks:
                for off, w in ((0, width), (None, None)):
                    if off is None:  # escalation: full width
                        off, w = 0, self.block
                    cost = w * (DATA_SHARDS_COUNT + PARITY_SHARDS_COUNT)
                    data = []
                    for c in range(DATA_SHARDS_COUNT):
                        col_start = row * self.stripe + c * self.block + off
                        data.append(np.frombuffer(
                            self._read_dat(col_start, w), dtype=np.uint8
                        ))
                    parity = {}
                    for p in range(PARITY_SHARDS_COUNT):
                        blk = os.pread(
                            self._parity_fds[p], w, row * self.block + off
                        )
                        if len(blk) == w:
                            parity[p] = np.frombuffer(blk, dtype=np.uint8)
                    checked += cost
                    if not parity:
                        break  # torn/short: parity_health's finding
                    try:
                        expect = self.codec.encode(np.stack(data))
                    except Exception as e:
                        raise ParityCodecFailed(
                            f"parity recompute of row {row}: {e}") from e
                    ok = all(
                        np.array_equal(expect[p], blk)
                        for p, blk in parity.items()
                    )
                    if ok:
                        break  # slice verified: next row
                    if w == self.block:  # full width still disagrees
                        mismatches.append(row)
                        break
            return checked, mismatches

    def reconstruct_range(self, offset: int, size: int) -> bytes | None:
        """Rebuild .dat bytes [offset, offset+size) from parity + the
        other data columns — the degraded-read path for a torn/unreadable
        needle on a live online-EC volume.

        Per stripe row, two regimes:
          * narrow range (<= 4 columns overlapped): treat the overlapped
            columns as erasures and RS-decode them outright;
          * wide range: recompute parity from the .dat columns; a clean
            match means the row is intact, otherwise try each overlapped
            column as the single corrupt one and accept the candidate all
            surviving parity rows verify.

        Data columns are read as they were at encode time (zero past the
        covered watermark). Returns None whenever parity cannot prove the
        range."""
        with self._lock:
            if not self._parity_fds or not self.active:
                return None
            block, stripe = self.block, self.stripe
            covered = self.watermark + self._partial
            if size <= 0 or offset < 0 or offset + size > covered:
                return None  # parity hasn't durably covered the range
            out = bytearray()
            row0 = offset // stripe
            row1 = (offset + size - 1) // stripe
            for row in range(row0, row1 + 1):
                row_start = row * stripe
                lo = max(offset, row_start)
                hi = min(offset + size, row_start + stripe)
                targets = list(range((lo - row_start) // block,
                                     (hi - 1 - row_start) // block + 1))

                def read_col(c: int) -> np.ndarray:
                    col_start = row_start + c * block
                    if col_start >= covered:
                        return np.zeros(block, dtype=np.uint8)
                    take = min(block, covered - col_start)
                    data = self._read_dat(col_start, take)
                    if take < block:
                        data = data + b"\0" * (block - take)
                    return np.frombuffer(data, dtype=np.uint8)

                parity: dict[int, np.ndarray] = {}
                for p in range(PARITY_SHARDS_COUNT):
                    data = os.pread(self._parity_fds[p], block, row * block)
                    if len(data) == block:  # short = torn: unusable
                        parity[p] = np.frombuffer(data, dtype=np.uint8)
                if not parity:
                    return None
                row_data = self._recover_row(targets, read_col, parity)
                if row_data is None:
                    return None
                pos = lo
                while pos < hi:
                    c = (pos - row_start) // block
                    inner = (pos - row_start) % block
                    take = min(hi - pos, block - inner)
                    out += row_data[c].tobytes()[inner:inner + take]
                    pos += take
            return bytes(out)

    def _recover_row(self, targets, read_col, parity):
        """One stripe row's data columns with the damage decoded out;
        None when parity cannot prove a consistent row. See
        reconstruct_range for the two regimes."""
        present_parity = {
            DATA_SHARDS_COUNT + p: blk for p, blk in parity.items()
        }
        if len(targets) <= min(PARITY_SHARDS_COUNT, len(parity)):
            present = {
                c: read_col(c)
                for c in range(DATA_SHARDS_COUNT) if c not in targets
            }
            present.update(present_parity)
            if len(present) < DATA_SHARDS_COUNT:
                return None
            try:
                rec = self.codec.reconstruct(present, targets=targets)
            except Exception:
                return None
            return {
                c: (rec[c] if c in targets else present[c])
                for c in range(DATA_SHARDS_COUNT)
            }
        # wide range: locate the corruption via parity verification
        data = [read_col(c) for c in range(DATA_SHARDS_COUNT)]

        def verifies(cols) -> bool:
            expect = self.codec.encode(np.stack(cols))
            return all(
                np.array_equal(expect[p], blk)
                for p, blk in parity.items()
            )

        try:
            if verifies(data):
                return dict(enumerate(data))  # row is intact as-read
            for suspect in targets:
                present = {
                    c: data[c]
                    for c in range(DATA_SHARDS_COUNT) if c != suspect
                }
                present.update(present_parity)
                rec = self.codec.reconstruct(present, targets=[suspect])
                candidate = list(data)
                candidate[suspect] = rec[suspect]
                if verifies(candidate):
                    return dict(enumerate(candidate))
        except Exception:
            return None
        return None  # multi-column damage in one row: not provable here

    def rearm(self) -> int:
        """Recreate the parity shard files and re-encode everything from
        byte 0 — the heal for a LIVE volume whose parity was lost or torn.
        It also clears a degraded writer. Returns the rows re-encoded."""
        with self._lock:
            for fd in self._parity_fds:
                try:
                    os.close(fd)
                except OSError:
                    pass
            fds = []
            for p in range(PARITY_SHARDS_COUNT):
                path = self.volume.base_name + to_ext(DATA_SHARDS_COUNT + p)
                fds.append(os.open(path, os.O_RDWR | os.O_CREAT, 0o644))
            self._parity_fds = fds
            for fd in fds:
                os.ftruncate(fd, 0)
            self._parity_rows_sized = 0
            self.watermark = 0
            self._partial = 0
            self._pending_since = None
            self.active = True
            self.fallback_reason = None
            self._count_fallback("parity_rearm")
            try:
                os.ftruncate(self._journal_fd, 0)
            except OSError:
                pass
            self._journal_append()
        return self.pump(force=True)

    # --- reads from the open state -------------------------------------------
    def read_shard_range(self, shard_id: int, off: int, size: int) -> bytes | None:
        """Serve a shard byte range from the OPEN state: parity from the
        incrementally-written .ec1x files (None past the encoded
        watermark), data shards straight from the .dat — data shard c,
        row r is .dat bytes [r*stripe + c*block, +block), zero-padded past
        the .dat end exactly as seal() will materialize them."""
        if shard_id < 0 or shard_id >= TOTAL_SHARDS_COUNT:
            return None
        with self._lock:
            if not self._parity_fds:
                return None  # closed
            rows_encoded = self.watermark // self.stripe + (
                1 if self._partial else 0
            )
            if shard_id >= DATA_SHARDS_COUNT:
                if off + size > rows_encoded * self.block:
                    return None  # parity not written yet for that range
                data = os.pread(
                    self._parity_fds[shard_id - DATA_SHARDS_COUNT], size, off
                )
                return data if len(data) == size else None
            end = self._end()
            out = bytearray()
            pos = off
            remaining = size
            while remaining > 0:
                row, inner = divmod(pos, self.block)
                take = min(remaining, self.block - inner)
                dat_off = row * self.stripe + shard_id * self.block + inner
                if dat_off >= end:
                    out += b"\0" * take
                else:
                    out += self._read_dat(dat_off, take)
                pos += take
                remaining -= take
            return bytes(out)

    # --- lifecycle ------------------------------------------------------------
    def reset(self) -> None:
        """Restart parity from scratch — the .dat was rewritten under us
        (vacuum compaction). Counted as `vacuum_reset`, not pathological."""
        with self._lock:
            self.watermark = 0
            self._partial = 0
            self._pending_since = None
            self._parity_rows_sized = 0
            for fd in self._parity_fds:
                os.ftruncate(fd, 0)
            try:
                os.ftruncate(self._journal_fd, 0)
            except OSError:
                pass
            self._count_fallback("vacuum_reset")
            self._journal_append()

    def seal(self) -> None:
        """Finish the volume's shards for EC mount: flush the tail row,
        materialize .ec00-.ec09 by sequential copy from the .dat (no GF
        math — ingest already paid it), size every shard exactly, and
        record the uniform geometry in the .vif for readers."""
        with self._lock:
            if self.sealed:
                return
            self._pump_locked(None, force=True)
            if not self.active:
                raise RuntimeError(
                    f"online ec volume {self.volume.id} degraded"
                    f" ({self.fallback_reason}); seal must re-encode"
                )
            dat_size = self._end()
            rows = -(-dat_size // self.stripe)  # ceil
            shard_size = shard_file_size(dat_size, self.block, self.block)
            assert shard_size == rows * self.block
            blockbuf = np.empty(self.block, dtype=np.uint8)
            for c in range(DATA_SHARDS_COUNT):
                path = self.volume.base_name + to_ext(c)
                tmp = path + ".tmp"
                fd = os.open(tmp, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o644)
                try:
                    os.ftruncate(fd, shard_size)
                    for r in range(rows):
                        dat_off = r * self.stripe + c * self.block
                        if dat_off >= dat_size:
                            continue  # stays zero (pre-truncated)
                        take = min(self.block, dat_size - dat_off)
                        self._read_dat_into(dat_off, take, blockbuf)
                        os.pwrite(fd, blockbuf[:take], r * self.block)
                finally:
                    os.close(fd)
                os.replace(tmp, path)
            for fd in self._parity_fds:
                os.ftruncate(fd, shard_size)
                os.fsync(fd)
            _merge_vif(
                self.volume.base_name + ".vif",
                {
                    "large_block_size": self.block,
                    "small_block_size": self.block,
                    "ec_online": {"block_size": self.block, "sealed": True},
                },
                version=self.volume.version(),
            )
            self.sealed = True
            try:  # the journal's job is done: shards are complete
                os.unlink(self._journal_path)
            except OSError:
                pass
            self._m_buffered.labels(self._vol_label).set(0)

    def close(self) -> None:
        with self._lock:
            for fd in self._parity_fds:
                try:
                    os.close(fd)
                except OSError:
                    pass
            self._parity_fds = []
            try:
                os.close(self._journal_fd)
            except OSError:
                pass

    def stats(self) -> dict:
        return {
            "active": self.active,
            "sealed": self.sealed,
            "block_size": self.block,
            "watermark": self.watermark,
            "stripes": self.stripes,
            "encoded_bytes": self.encoded_bytes,
            "encode_seconds": round(self.encode_seconds, 6),
            "parity_bytes": self.parity_bytes,
            "journal_replays": self.journal_replays,
            "fallbacks": dict(self.fallbacks),
            "fallback_reason": self.fallback_reason,
        }


def _merge_vif(path: str, extra: dict, version: int = 3) -> None:
    info = encoder_mod.load_volume_info(path)
    info.setdefault("version", version)
    info.update(extra)
    encoder_mod.save_volume_info(path, **info)


def online_info(base_name: str) -> dict | None:
    """The .vif's ec_online section for a volume base name, or None."""
    info = encoder_mod.load_volume_info(base_name + ".vif")
    oe = info.get("ec_online")
    return dict(oe) if isinstance(oe, dict) else None
