"""EC encode/rebuild: .dat -> .ec00–.ec13 (+ .ecx, .vif), and shard recovery.

The port's counterpart of `seaweedfs_tpu/storage/erasure_coding/encoder.py`.
Produces byte-identical shard files to the reference's
`WriteEcFiles`/`RebuildEcFiles` (`weed/storage/erasure_coding/ec_encoder.go`)
through a three-stage pipeline:

    reader thread --(bounded queue)--> GF transform --(bounded queue)--> writer thread

* the reader pre-fetches row batches from the .dat into a small ring of
  reusable host buffers (positional preadv, zero-padded past EOF) — pinned
  memory when the codec is on cuda, so the copy to the card does not block;
* the transform stage submits each batch to the codec: on cuda the
  H2D copy, the GF(2^8) kernel and the D2H copy of the parity, queued on
  the codec's stream; only PARITY crosses back (data shards are written
  straight from the read buffer);
* the writer thread waits on each batch's parity and lays both data and
  parity bytes into the 14 shard files with positional pwrite. A buffer
  goes back to the ring only after its batch's parity has arrived.
"""

from __future__ import annotations

import json
import os
import queue
import threading

import numpy as np

from seaweedfs_tpu_torch.ops import gf256
from seaweedfs_tpu_torch.ops.rs_kernel import RSCodec
from seaweedfs_tpu_torch.storage import idx as idx_mod
from seaweedfs_tpu_torch.storage.types import size_is_valid

from .geometry import (
    DATA_SHARDS_COUNT,
    LARGE_BLOCK_SIZE,
    PARITY_SHARDS_COUNT,
    SMALL_BLOCK_SIZE,
    TOTAL_SHARDS_COUNT,
    shard_file_size,
    to_ext,
)

# Max bytes per shard per pipeline batch (= kernel columns per step). The
# host path wants the batch's working set resident in the CPU cache; the
# device path wants large batches to amortize transfers and launches.
DEFAULT_BATCH_HOST = 1024 * 1024
DEFAULT_BATCH_DEVICE = 32 * 1024 * 1024


def _default_batch(codec: RSCodec) -> int:
    return DEFAULT_BATCH_DEVICE if codec.is_cuda else DEFAULT_BATCH_HOST


_QUEUE_DEPTH = 2


def _ensure_buf(buf, need: int, cap: int, codec: RSCodec) -> np.ndarray:
    """Reuse the ring slot when it is big enough, else (re)allocate to
    max(need, cap) from the codec so the slot converges on one size."""
    if not isinstance(buf, np.ndarray) or buf.nbytes < need:
        buf = codec.host_buffer(max(need, cap))
    return buf


def _pread_padded(fd: int, offset: int, size: int, out: np.ndarray) -> None:
    """Zero-copy positional read into out[:size], zero-filling past EOF
    (reference encodeDataOneBatch:166-177 pads the last batch the same way)."""
    got = os.preadv(fd, [memoryview(out)[:size]], offset)
    if got < size:
        out[got:size] = 0


def _schedule(total: int, large: int, small: int, batch: int):
    """Yield pipeline work units covering the reference's row layout
    (`ec_encoder.go:198-235`): large rows while more than one full large row
    remains, then small rows (last one zero-padded).

    ("rows", dat_off, shard_off, block, nrows): nrows whole rows read
        contiguously from the .dat.
    ("cols", dat_off, shard_off, block, done, width): a width-column slice
        of one row whose block exceeds the batch budget; data shard c lives
        at dat_off + c*block + done.
    """
    remaining = total
    processed = 0
    shard_off = 0

    def _emit_cols(block: int):
        nonlocal processed, shard_off
        done = 0
        while done < block:
            width = min(batch, block - done)
            yield ("cols", processed, shard_off, block, done, width)
            done += width
        processed += block * DATA_SHARDS_COUNT
        shard_off += block

    large_row = large * DATA_SHARDS_COUNT
    while remaining > large_row:
        if large <= batch:
            nrows_possible = (remaining - 1) // large_row  # full large rows left
            nrows = max(1, min(nrows_possible, batch // large))
            yield ("rows", processed, shard_off, large, nrows)
            processed += nrows * large_row
            shard_off += nrows * large
            remaining -= nrows * large_row
        else:
            yield from _emit_cols(large)
            remaining -= large_row
    small_row = small * DATA_SHARDS_COUNT
    while remaining > 0:
        if small <= batch:
            rows_left = -(-remaining // small_row)  # ceil: last row is padded
            nrows = max(1, min(rows_left, batch // small))
            yield ("rows", processed, shard_off, small, nrows)
            processed += nrows * small_row
            shard_off += nrows * small
            remaining -= nrows * small_row
        else:
            yield from _emit_cols(small)
            remaining -= small_row


class _ShardWriters:
    """Positional-write fds, one per shard. Each shard is written under a
    `.tmp` name, pre-sized to the final shard size, and renamed into place
    only in close(), so a crashed or aborted encode never leaves a
    full-size shard that looks complete while holding stale bytes. A
    pre-existing final shard of the same size (re-encode) is renamed onto
    the `.tmp` name first and its pages are rewritten in place; an abort
    before any byte was written (`dirty` still False) renames those
    originals back, a dirty abort deletes the tmps."""

    def __init__(self, base: str, final_size: int, shard_ids=None) -> None:
        self.fds: dict[int, int] = {}
        self.paths: dict[int, str] = {}
        self.tmp_paths: dict[int, str] = {}
        self._recycled: set[int] = set()
        self.final_size = final_size
        self.dirty = False
        try:
            for i in (
                shard_ids if shard_ids is not None else range(TOTAL_SHARDS_COUNT)
            ):
                path = base + to_ext(i)
                self.paths[i] = path
                tmp = path + ".tmp"
                self.tmp_paths[i] = tmp
                try:
                    if os.path.getsize(path) == final_size:
                        os.replace(path, tmp)
                        self._recycled.add(i)
                except OSError:
                    pass
                self.fds[i] = os.open(tmp, os.O_RDWR | os.O_CREAT, 0o644)
                os.ftruncate(self.fds[i], final_size)
        except BaseException:
            self.abort()  # restore any renamed originals, close opened fds
            raise

    def pwrite(self, shard: int, data, offset: int) -> None:
        self.dirty = True
        os.pwrite(self.fds[shard], data, offset)

    def pwritev(self, shard: int, views, offset: int) -> None:
        """Scatter-gather write: one syscall, no host-side concat copy."""
        self.dirty = True
        os.pwritev(self.fds[shard], views, offset)

    def close(self) -> None:
        for i, fd in self.fds.items():
            os.ftruncate(fd, self.final_size)
            os.close(fd)
            os.replace(self.tmp_paths[i], self.paths[i])
        self.fds.clear()

    def abort(self) -> None:
        for fd in self.fds.values():
            os.close(fd)
        self.fds.clear()
        for i, path in self.tmp_paths.items():
            try:
                if not self.dirty and i in self._recycled:
                    os.replace(path, self.paths[i])  # original, untouched
                else:
                    os.unlink(path)
            except OSError:
                pass


def _run_pipeline(jobs, read_job, encode_job, write_job) -> None:
    """reader thread -> encode (caller thread) -> writer thread, with
    bounded queues, a shared buffer freelist for backpressure, and a stop
    flag so a failure in any stage unwinds the other two instead of
    deadlocking on a full/empty queue."""
    read_q: queue.Queue = queue.Queue(maxsize=_QUEUE_DEPTH)
    write_q: queue.Queue = queue.Queue(maxsize=_QUEUE_DEPTH)
    free: queue.Queue = queue.Queue()
    for _ in range(_QUEUE_DEPTH + 2):
        free.put(None)  # buffer slots; reader sizes/reuses lazily
    stop = threading.Event()
    errors: list[BaseException] = []

    def _put(q: queue.Queue, item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def reader():
        try:
            for job in jobs:
                if stop.is_set():
                    return
                buf = read_job(job, free.get())
                if not _put(read_q, (job, buf)):
                    return
        except BaseException as e:  # noqa: BLE001 - propagated below
            errors.append(e)
            stop.set()
        finally:
            _put(read_q, None) or read_q.put(None)

    def writer():
        try:
            while True:
                item = write_q.get()
                if item is None:
                    return
                job, buf, handle = item
                write_job(job, buf, handle)
                free.put(buf)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)
            stop.set()
            while True:  # drain + recycle buffers so reader/encode never block
                item = write_q.get()
                if item is None:
                    return
                free.put(item[1])

    rt = threading.Thread(target=reader, name="ec-reader", daemon=True)
    wt = threading.Thread(target=writer, name="ec-writer", daemon=True)
    rt.start()
    wt.start()
    try:
        while True:
            item = read_q.get()
            if item is None:
                break
            job, buf = item
            write_q.put((job, buf, encode_job(job, buf)))
    except BaseException as e:  # noqa: BLE001 - e.g. device error mid-encode
        errors.append(e)
        stop.set()
        while True:  # unwedge the reader, then stop consuming
            item = read_q.get()
            if item is None:
                break
            free.put(item[1])
    finally:
        write_q.put(None)
        rt.join()
        wt.join()
    if errors:
        raise errors[0]


def write_ec_files(
    base_file_name: str,
    codec: RSCodec | None = None,
    large_block_size: int = LARGE_BLOCK_SIZE,
    small_block_size: int = SMALL_BLOCK_SIZE,
    batch: int | None = None,
) -> None:
    """Generate .ec00–.ec13 from .dat (`ec_encoder.go:57,198-235`) through
    the three-stage pipeline (see module docstring). The codec defaults to
    one on cuda."""
    codec = codec or RSCodec()
    if batch is None:
        batch = _default_batch(codec)
    dat_path = base_file_name + ".dat"
    total = os.path.getsize(dat_path)
    shard_size = shard_file_size(total, large_block_size, small_block_size)
    writers = _ShardWriters(base_file_name, shard_size)
    try:
        dat_fd = os.open(dat_path, os.O_RDONLY)
    except BaseException:
        writers.abort()
        raise
    try:
        jobs = _schedule(total, large_block_size, small_block_size, batch)
        cap = batch * DATA_SHARDS_COUNT

        def read_job(job, buf):
            if job[0] == "rows":
                _, dat_off, _, block, nrows = job
                need = nrows * block * DATA_SHARDS_COUNT
                buf = _ensure_buf(buf, need, cap, codec)
                _pread_padded(dat_fd, dat_off, need, buf)
                return buf
            _, dat_off, _, block, done, width = job
            need = width * DATA_SHARDS_COUNT
            buf = _ensure_buf(buf, need, cap, codec)
            view = buf[:need].reshape(DATA_SHARDS_COUNT, width)
            for c in range(DATA_SHARDS_COUNT):
                _pread_padded(dat_fd, dat_off + c * block + done, width, view[c])
            return buf

        def encode_job(job, buf):
            if job[0] == "rows":
                _, _, _, block, nrows = job
                need = nrows * block * DATA_SHARDS_COUNT
                return codec.encode_rows_async(buf[:need], block, nrows)
            _, _, _, block, done, width = job
            need = width * DATA_SHARDS_COUNT
            return codec.encode2d_async(buf[:need].reshape(DATA_SHARDS_COUNT, width))

        def write_job(job, buf, handle):
            parity = handle.result()
            if job[0] == "rows":
                _, _, shard_off, block, nrows = job
                span = nrows * block
                for p in range(PARITY_SHARDS_COUNT):
                    writers.pwrite(DATA_SHARDS_COUNT + p, parity[p, :span], shard_off)
                view = buf[: span * DATA_SHARDS_COUNT].reshape(
                    nrows, DATA_SHARDS_COUNT, block
                )
                for c in range(DATA_SHARDS_COUNT):
                    if nrows == 1:
                        writers.pwrite(c, view[0, c], shard_off)
                    else:
                        writers.pwritev(
                            c, [view[r, c] for r in range(nrows)], shard_off
                        )
            else:
                _, _, shard_off, block, done, width = job
                view = buf[: width * DATA_SHARDS_COUNT].reshape(
                    DATA_SHARDS_COUNT, width
                )
                for c in range(DATA_SHARDS_COUNT):
                    writers.pwrite(c, view[c], shard_off + done)
                for p in range(PARITY_SHARDS_COUNT):
                    writers.pwrite(
                        DATA_SHARDS_COUNT + p, parity[p, :width], shard_off + done
                    )

        _run_pipeline(jobs, read_job, encode_job, write_job)
    except BaseException:
        writers.abort()
        raise
    else:
        writers.close()
    finally:
        os.close(dat_fd)


def rebuild_ec_files(
    base_file_name: str,
    codec: RSCodec | None = None,
    chunk: int | None = None,
) -> list[int]:
    """Regenerate missing .ecXX files from the surviving >= 10
    (`ec_encoder.go:61,237-291`) through the same three-stage pipeline —
    the GF transform is the inverted-submatrix product. Returns the
    rebuilt shard ids. The codec defaults to one on cuda."""
    codec = codec or RSCodec()
    if chunk is None:
        chunk = _default_batch(codec)
    present_fds: dict[int, int] = {}
    missing: list[int] = []
    try:
        for shard_id in range(TOTAL_SHARDS_COUNT):
            name = base_file_name + to_ext(shard_id)
            if os.path.exists(name):
                present_fds[shard_id] = os.open(name, os.O_RDONLY)
            else:
                missing.append(shard_id)
        if not missing:
            return []
        if len(present_fds) < DATA_SHARDS_COUNT:
            raise ValueError(f"cannot rebuild: only {len(present_fds)} shards present")
        present = sorted(present_fds)
        use = present[:DATA_SHARDS_COUNT]
        matrix = gf256.decode_matrix(
            codec.data_shards, codec.parity_shards, tuple(present), tuple(missing)
        )
        shard_size = os.path.getsize(base_file_name + to_ext(use[0]))
        writers = _ShardWriters(base_file_name, shard_size, shard_ids=missing)
        try:
            jobs = [
                (off, min(chunk, shard_size - off))
                for off in range(0, shard_size, chunk)
            ]
            cap = chunk * DATA_SHARDS_COUNT

            def read_job(job, buf):
                off, width = job
                need = width * DATA_SHARDS_COUNT
                buf = _ensure_buf(buf, need, cap, codec)
                view = buf[:need].reshape(DATA_SHARDS_COUNT, width)
                for i, sid in enumerate(use):
                    got = os.preadv(present_fds[sid], [view[i]], off)
                    if got != width:
                        raise IOError(
                            f"ec shard {sid} short read at {off}: {got} != {width}"
                        )
                return buf

            def encode_job(job, buf):
                _, width = job
                need = width * DATA_SHARDS_COUNT
                return codec.apply2d_async(
                    matrix, buf[:need].reshape(DATA_SHARDS_COUNT, width)
                )

            def write_job(job, buf, handle):
                off, width = job
                out = handle.result()
                for i, sid in enumerate(missing):
                    writers.pwrite(sid, out[i, :width], off)

            _run_pipeline(jobs, read_job, encode_job, write_job)
        except BaseException:
            writers.abort()
            raise
        else:
            writers.close()
    finally:
        for fd in present_fds.values():
            os.close(fd)
    return missing


def write_sorted_file_from_idx(base_file_name: str, ext: str = ".ecx") -> None:
    """Generate the sorted .ecx from the .idx — latest entry per key, keys
    ascending, deleted/zero entries dropped (`ec_encoder.go:27-55`)."""
    latest: dict[int, tuple[int, int]] = {}
    for key, offset, size in idx_mod.walk_index_file(base_file_name + ".idx"):
        if offset != 0 and size_is_valid(size):
            latest[key] = (offset, size)
        else:
            latest.pop(key, None)
    with open(base_file_name + ext, "wb") as f:
        for key in sorted(latest):
            offset, size = latest[key]
            f.write(idx_mod.entry_to_bytes(key, offset, size))


def save_volume_info(path: str, version: int = 3, **extra) -> None:
    """.vif — volume info JSON (`weed/storage/volume_info/volume_info.go`,
    protojson of VolumeInfo)."""
    info = {"version": version}
    info.update(extra)
    with open(path, "w") as f:
        json.dump(info, f, indent=2)


def load_volume_info(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)
