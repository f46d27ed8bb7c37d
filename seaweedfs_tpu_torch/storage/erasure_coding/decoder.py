"""EC decode: .ec00–.ec09 (+ .ecx/.ecj) back to a plain .dat/.idx volume.

The port's counterpart of `seaweedfs_tpu/storage/erasure_coding/decoder.py`
(after `weed/storage/erasure_coding/ec_decoder.go`): the .dat is
re-assembled by de-striping the 10 data shards (large rows then small rows
up to the computed dat size); the .idx is the .ecx plus tombstones for
every id in the .ecj journal.

Also home of the partial-sum repair math: reconstructing shard t from
survivors is out[t] = XOR_i m[t,i] x use[i] over GF(2^8), which is linear,
so any partition of the `use` shards can be scaled and summed where those
shards live and only the partial sums move. `repair_coefficients` builds
the matrix, `partial_contribution` runs one holder's share on the codec's
kernel, `xor_partials` folds contributions in any order. The pipelined
rebuild plane's modes, typed reasons and chunk states are the JAX
package's sets. Its counters (`REPAIR`) keep in-process totals and feed
the JAX package's metric families (`repair_metrics`, `stream_metrics`).
`write_dat_file` runs under a kernel span feeding
`SeaweedFS_volume_ec_decode_seconds` (kernel "destripe").
"""

from __future__ import annotations

import os
import threading
from typing import Iterator

import numpy as np

from seaweedfs_tpu_torch.ops import gf256
from seaweedfs_tpu_torch.ops.rs_kernel import RSCodec
from seaweedfs_tpu_torch.stats import default_registry, trace
from seaweedfs_tpu_torch.storage import idx as idx_mod
from seaweedfs_tpu_torch.storage.needle import get_actual_size
from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE, SuperBlock
from seaweedfs_tpu_torch.storage.types import (
    NEEDLE_ID_SIZE,
    NEEDLE_MAP_ENTRY_SIZE,
    TOMBSTONE_FILE_SIZE,
    get_u64,
    size_is_deleted,
)

from .geometry import (
    DATA_SHARDS_COUNT,
    LARGE_BLOCK_SIZE,
    PARITY_SHARDS_COUNT,
    SMALL_BLOCK_SIZE,
    to_ext,
)


def iterate_ecx_file(index_base_file_name: str) -> Iterator[tuple[int, int, int]]:
    with open(index_base_file_name + ".ecx", "rb") as f:
        while True:
            buf = f.read(NEEDLE_MAP_ENTRY_SIZE)
            if len(buf) != NEEDLE_MAP_ENTRY_SIZE:
                return
            yield idx_mod.entry_from_bytes(buf)


def iterate_ecj_file(index_base_file_name: str) -> Iterator[int]:
    path = index_base_file_name + ".ecj"
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        while True:
            buf = f.read(NEEDLE_ID_SIZE)
            if len(buf) != NEEDLE_ID_SIZE:
                return
            yield get_u64(buf)


def read_ec_volume_version(data_base_file_name: str) -> int:
    """Volume version from the superblock at the head of .ec00."""
    with open(data_base_file_name + to_ext(0), "rb") as f:
        sb = SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE))
    return sb.version


def find_dat_file_size(data_base_file_name: str, index_base_file_name: str) -> int:
    """Max needle stop offset over live .ecx entries (`ec_decoder.go:48-70`)."""
    version = read_ec_volume_version(data_base_file_name)
    dat_size = 0
    for key, offset, size in iterate_ecx_file(index_base_file_name):
        if size_is_deleted(size):
            continue
        dat_size = max(dat_size, offset + get_actual_size(size, version))
    return dat_size


def write_idx_file_from_ec_index(base_file_name: str) -> None:
    """.idx = .ecx contents + a tombstone entry per .ecj id
    (`ec_decoder.go:18-43`)."""
    with open(base_file_name + ".idx", "wb") as out:
        with open(base_file_name + ".ecx", "rb") as ecx:
            while True:
                chunk = ecx.read(1 << 20)
                if not chunk:
                    break
                out.write(chunk)
        for key in iterate_ecj_file(base_file_name):
            out.write(idx_mod.entry_to_bytes(key, 0, TOMBSTONE_FILE_SIZE))


def write_dat_file(
    base_file_name: str,
    dat_file_size: int,
    shard_file_names: list[str],
    large_block_size: int = LARGE_BLOCK_SIZE,
    small_block_size: int = SMALL_BLOCK_SIZE,
) -> None:
    """De-stripe the 10 data shards into .dat (`ec_decoder.go:154-201`).
    Runs under a kernel span feeding SeaweedFS_volume_ec_decode_seconds."""
    readers = [open(shard_file_names[i], "rb") for i in range(DATA_SHARDS_COUNT)]
    try:
        with trace.kernel_span(
            "ec.decode", trace.EC_DECODE_SECONDS, "destripe",
            nbytes=dat_file_size,
        ), open(base_file_name + ".dat", "wb") as out:
            remaining = dat_file_size
            while remaining >= DATA_SHARDS_COUNT * large_block_size:
                for r in readers:
                    _copy_n(r, out, large_block_size)
                    remaining -= large_block_size
            while remaining > 0:
                for r in readers:
                    to_read = min(remaining, small_block_size)
                    if to_read <= 0:
                        break
                    _copy_n(r, out, to_read)
                    remaining -= to_read
    finally:
        for r in readers:
            r.close()


def _copy_n(src, dst, n: int) -> None:
    left = n
    while left > 0:
        chunk = src.read(min(left, 1 << 20))
        if not chunk:
            raise IOError(f"short shard read: {left} bytes missing")
        dst.write(chunk)
        left -= len(chunk)


# --- partial-sum repair ------------------------------------------------------
# A "fallback" is a pipelined repair degrading to classic whole-shard pulls;
# a "restart" is the chain re-planned minus a dead hop (the retry ladder's
# cheaper rung — the repair stays pipelined).
REPAIR_MODES = ("classic", "pipelined")
REPAIR_FALLBACK_REASONS = (
    "too_few_holders",     # auto mode: a <=2-node chain spreads nothing
    "hop_failed",          # chain restarts exhausted the surviving holders
    "crc_mismatch",        # a partial arrived corrupt twice in a row
    "start_failed",        # the rebuilder refused the partial-write state
    "insufficient_shards", # survivors minus dead hops dropped below 10
    "stream_stall",        # a streaming hop's bounded window backed up past
                           # the stall budget twice (downstream wedged)
    "chunk_crc",           # a streamed chunk failed its per-chunk CRC twice
)
REPAIR_RESTART_REASONS = ("hop_failed", "crc_mismatch", "stream_stall",
                          "chunk_crc")

# per-chunk lifecycle states of the streaming session plane: a chunk is
# `forwarded` by a mid-chain hop's forwarder thread, `written` by the
# terminal writer, `stalled` when the bounded in-flight window blocked past
# the stall budget, `crc_failed` when its CRC32C did not survive the hop.
STREAM_CHUNK_STATES = ("forwarded", "written", "stalled", "crc_failed")

REPAIR_BYTES_ON_WIRE = "SeaweedFS_volume_ec_repair_bytes_on_wire_total"
REPAIR_SECONDS = "SeaweedFS_volume_ec_repair_seconds"
REPAIR_FALLBACKS = "SeaweedFS_volume_ec_repair_fallbacks_total"
REPAIR_RESTARTS = "SeaweedFS_volume_ec_repair_chain_restarts_total"
REPAIR_STREAM_CHUNKS = "SeaweedFS_volume_ec_repair_stream_chunks_total"
REPAIR_RESUMED_BYTES = "SeaweedFS_volume_ec_repair_resumed_bytes_total"

_repair_metrics_cache = None
_stream_metrics_cache = None


def repair_metrics():
    """Register the ec_repair families once; returns (bytes_on_wire{mode},
    seconds{mode,stage}, fallbacks{reason}, chain_restarts{reason}).
    bytes_on_wire counts every repair payload once, at the node that
    receives it or serves a ranged partial, so
    `rate(...{mode="classic"}) / rate(...{mode="pipelined"})` is the
    bandwidth cut, straight off /metrics."""
    global _repair_metrics_cache
    if _repair_metrics_cache is None:
        reg = default_registry()
        _repair_metrics_cache = (
            reg.counter(
                REPAIR_BYTES_ON_WIRE,
                "EC repair bytes moved over the network, by rebuild mode",
                ("mode",),
            ),
            reg.histogram(
                REPAIR_SECONDS,
                "EC repair wall time per stage and mode",
                ("mode", "stage"),
            ),
            reg.counter(
                REPAIR_FALLBACKS,
                "pipelined repairs degraded to classic, by typed reason",
                ("reason",),
            ),
            reg.counter(
                REPAIR_RESTARTS,
                "repair chains re-planned minus a dead hop, by reason",
                ("reason",),
            ),
        )
    return _repair_metrics_cache


def stream_metrics():
    """Register the streaming-session families once; returns
    (stream_chunks{state}, resumed_bytes)."""
    global _stream_metrics_cache
    if _stream_metrics_cache is None:
        reg = default_registry()
        _stream_metrics_cache = (
            reg.counter(
                REPAIR_STREAM_CHUNKS,
                "streaming-rebuild chunks by per-chunk lifecycle state",
                ("state",),
            ),
            reg.counter(
                REPAIR_RESUMED_BYTES,
                "bytes not re-sent because a restarted chain resumed from"
                " the writer's committed frontier",
            ),
        )
    return _stream_metrics_cache


class RepairCounters:
    """The plane's counters, by family and label: `bytes_on_wire` by mode
    (every repair payload once, at the node that receives it or serves a
    ranged partial), `fallbacks` and `restarts` by reason, `stream_chunks`
    by state, and `resumed_bytes` (bytes a restarted chain did not re-send
    because the writer's committed frontier survived)."""

    FAMILIES = {
        "bytes_on_wire": REPAIR_MODES,
        "fallbacks": REPAIR_FALLBACK_REASONS,
        "restarts": REPAIR_RESTART_REASONS,
        "stream_chunks": STREAM_CHUNK_STATES,
    }

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._counts = {f: dict.fromkeys(labels, 0)
                            for f, labels in self.FAMILIES.items()}
            self._resumed = 0

    def inc(self, family: str, label: str, n: int = 1) -> None:
        """Add n to one labelled counter (and its metric family); an
        unknown label raises."""
        with self._lock:
            fam = self._counts[family]
            if label not in fam:
                raise ValueError(f"{family}: unknown label {label!r}")
            fam[label] += n
        if family == "stream_chunks":
            metric = stream_metrics()[0]
        else:
            wire, _, fallbacks, restarts = repair_metrics()
            metric = {"bytes_on_wire": wire, "fallbacks": fallbacks,
                      "restarts": restarts}[family]
        metric.labels(label).inc(n)

    def add_resumed(self, n: int) -> None:
        with self._lock:
            self._resumed += n
        stream_metrics()[1].inc(n)

    def snapshot(self) -> dict:
        with self._lock:
            out = {f: dict(c) for f, c in self._counts.items()}
            out["resumed_bytes"] = self._resumed
        return out


REPAIR = RepairCounters()


def repair_coefficients(
    present, targets, data_shards: int = DATA_SHARDS_COUNT,
    parity_shards: int = PARITY_SHARDS_COUNT,
) -> tuple[list[int], np.ndarray]:
    """-> (use, matrix): `use` is the canonical 10-shard subset of
    `present` full decode would read (sorted, first 10 — the same choice
    gf256.decode_matrix makes, which keeps the partial sum byte-identical
    to `RSCodec.reconstruct`), and matrix[t][i] is the GF(2^8) coefficient
    applied to use[i] when rebuilding targets[t]."""
    present_t = tuple(sorted(present))
    if len(present_t) < data_shards:
        raise ValueError(f"need {data_shards} surviving shards, have {len(present_t)}")
    m = gf256.decode_matrix(data_shards, parity_shards, present_t, tuple(targets))
    return list(present_t[:data_shards]), m


def partial_contribution(
    coefs: np.ndarray, shards: np.ndarray, codec: RSCodec | None = None
) -> np.ndarray:
    """One holder's locally-computed share of the repair sum: coefs
    (targets, k) over its k local `use` shards, shards (k, n) the
    corresponding byte ranges -> (targets, n), on the codec's kernel (a
    codec on cuda by default)."""
    coefs = np.ascontiguousarray(coefs, dtype=np.uint8)
    shards = np.ascontiguousarray(shards, dtype=np.uint8)
    if coefs.ndim != 2 or shards.ndim != 2 or coefs.shape[1] != shards.shape[0]:
        raise ValueError(f"coefs {coefs.shape} does not apply to shards {shards.shape}")
    return (codec or RSCodec()).apply_matrix(coefs, shards)


def xor_partials(acc: np.ndarray | None, part: np.ndarray) -> np.ndarray:
    """Fold one partial into the accumulator (associative + commutative,
    so chain hops may run in any order). acc=None starts the sum."""
    if acc is None:
        return np.array(part, dtype=np.uint8, copy=True)
    np.bitwise_xor(acc, part, out=acc)
    return acc
