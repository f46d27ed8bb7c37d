"""The port's OnlineEcWriter (device="cpu", the plain PyTorch version of
`gf256_matmul`) held byte for byte against the JAX package's writer with
`RSCodec(backend="numpy")` on the same needle stream: the .dat, .idx,
open parity shards .ec10-.ec13, the .ecp journal and the .vif after every
pump, then all 14 shards and the .ecx after the seal. Tolerance 0.

Both packages stamp needles with `time.time_ns()`; each package's needle
module gets its own copy of one deterministic clock, so the two .dat files
are equal byte for byte. Both writers age a partial row on
`time.monotonic()` (the 2 s `flush_age`): each package's online module
gets the same fixed monotonic clock, so a slow run (a loaded test worker)
cannot trickle-flush one writer's tail row and not the other's; a test
that wants the flush passes `now=` itself.
"""

from __future__ import annotations

import itertools
import os
import time
import types

import numpy as np
import pytest

from seaweedfs_tpu.ops.rs_kernel import RSCodec as RefCodec
from seaweedfs_tpu.storage import needle as ref_needle_mod
from seaweedfs_tpu.storage.erasure_coding import online as ref_online_mod
from seaweedfs_tpu.storage.erasure_coding import encoder as ref_encoder
from seaweedfs_tpu.storage.erasure_coding.online import (
    PATHOLOGICAL_REASONS as REF_PATHOLOGICAL,
)
from seaweedfs_tpu.storage.erasure_coding.online import OnlineEcWriter as RefWriter
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu_torch.ops.rs_kernel import RSCodec
from seaweedfs_tpu_torch.storage import needle as needle_mod
from seaweedfs_tpu_torch.storage.erasure_coding import encoder, geometry, online
from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import EcVolume
from seaweedfs_tpu_torch.storage.erasure_coding.online import (
    PATHOLOGICAL_REASONS,
    OnlineEcWriter,
)
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume
from tests._threads import stop_history_loops  # noqa: F401

BLOCK = 4096  # 40 KiB stripe rows keep the tests quick
OPEN_FILES = (".dat", ".idx", ".ec10", ".ec11", ".ec12", ".ec13", ".ecp", ".vif")
SEALED_FILES = (".dat", ".idx", ".vif", ".ecx") + tuple(
    geometry.to_ext(s) for s in range(geometry.TOTAL_SHARDS_COUNT)
)


@pytest.fixture
def clock(monkeypatch):
    """The same deterministic time_ns sequence for each package's needles,
    and one fixed monotonic clock for each package's writers."""
    for mod in (needle_mod, ref_needle_mod):
        ticks = itertools.count(1_700_000_000_000_000_000, 1_000)
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time_ns=lambda t=ticks: next(t)))
    for mod in (online, ref_online_mod):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=lambda: 1000.0, perf_counter=time.perf_counter))


class Twin:
    """One port volume + writer and one JAX volume + writer, driven in
    lock step in two directories."""

    def __init__(self, root, block=BLOCK, **writer_kw) -> None:
        self.block = block
        self.writer_kw = writer_kw
        self.dirs = (os.path.join(root, "port"), os.path.join(root, "ref"))
        for d in self.dirs:
            os.makedirs(d, exist_ok=True)
        self.v = Volume(self.dirs[0], "", 1)
        self.rv = RefVolume(self.dirs[1], "", 1)
        self.attach()

    def attach(self) -> None:
        self.w = OnlineEcWriter(self.v, block_size=self.block, device="cpu",
                                **self.writer_kw)
        self.rw = RefWriter(self.rv, block_size=self.block,
                            codec=RefCodec(backend="numpy"), **self.writer_kw)
        self.v.online_ec, self.rv.online_ec = self.w, self.rw

    def write(self, ids, seed=0, lo=100, hi=9000, pump=True) -> None:
        rng = np.random.default_rng(seed)
        for i in ids:
            data = rng.integers(0, 256, size=int(rng.integers(lo, hi)),
                                dtype=np.uint8).tobytes()
            self.v.write_needle(Needle(cookie=0x77, id=i, data=data))
            self.rv.write_needle(RefNeedle(cookie=0x77, id=i, data=data))
            if pump:
                self.pump()

    def pump(self, **kw) -> tuple[int, int]:
        got = self.w.pump(**kw), self.rw.pump(**kw)
        self.assert_equal()
        return got

    def both(self, name, *args, **kw):
        return getattr(self.w, name)(*args, **kw), getattr(self.rw, name)(*args, **kw)

    def path(self, i: int, ext: str) -> str:
        return os.path.join(self.dirs[i], "1" + ext)

    def assert_equal(self, exts=OPEN_FILES) -> None:
        for ext in exts:
            a, b = self.path(0, ext), self.path(1, ext)
            assert os.path.exists(a) == os.path.exists(b), ext
            if os.path.exists(a):
                with open(a, "rb") as fa, open(b, "rb") as fb:
                    assert fa.read() == fb.read(), f"{ext} differs from the JAX writer's"
        for key in ("watermark", "stripes", "encoded_bytes", "parity_bytes",
                    "journal_replays", "fallbacks", "active", "sealed",
                    "fallback_reason", "block_size"):
            assert self.w.stats()[key] == self.rw.stats()[key], key

    def close(self) -> None:
        self.v.close()
        self.rv.close()


@pytest.fixture
def twin(tmp_path, clock):
    t = Twin(str(tmp_path))
    yield t
    t.close()


def test_pathological_reasons_equal_reference():
    assert PATHOLOGICAL_REASONS == REF_PATHOLOGICAL


def test_streaming_rows_equal_reference(twin):
    twin.write(range(1, 60))
    assert twin.w.stripes > 3
    assert not any(r in twin.w.fallbacks for r in PATHOLOGICAL_REASONS)


def test_trickle_flush_and_refill(twin):
    twin.write([1], lo=500, hi=501, pump=False)
    assert twin.pump(now=100.0) == (0, 0)  # the partial row starts aging
    assert twin.pump(now=100.5) == (0, 0)  # younger than flush_age
    assert twin.pump(now=103.0) == (1, 1)  # aged: the padded row is flushed
    assert twin.w.fallbacks == {"trickle_flush": 1}
    assert twin.w._partial > 0
    assert twin.pump(now=110.0) == (0, 0)  # same bytes: no second flush
    twin.write(range(2, 20), pump=False)
    twin.pump(now=111.0)  # the row fills: full rows re-encoded over the flush
    assert twin.w.watermark >= twin.w.stripe


def test_deep_backlog_takes_pipelined_path(twin, monkeypatch):
    # a smaller host batch makes a backlog of 17+ rows "deep" at 4 KiB
    # blocks; the output is the same at any batch size
    for mod in (encoder, ref_encoder):
        monkeypatch.setattr(mod, "DEFAULT_BATCH_HOST", 4 * BLOCK)
    calls = []
    real = twin.w._encode_backlog_pipelined
    monkeypatch.setattr(twin.w, "_encode_backlog_pipelined",
                        lambda off, n: (calls.append(n), real(off, n)))
    twin.write(range(1, 200), pump=False)
    rows = twin.w._end() // twin.w.stripe
    assert rows > 16
    twin.pump(force=True)
    assert calls == [rows]
    assert twin.w.watermark == rows * twin.w.stripe


def test_seal_equals_reference_and_offline_encode(twin, tmp_path):
    twin.write(range(1, 80))
    twin.both("seal")
    for i, enc in ((0, encoder), (1, ref_encoder)):
        enc.write_sorted_file_from_idx(os.path.join(twin.dirs[i], "1"))
    twin.assert_equal(SEALED_FILES)
    assert not os.path.exists(twin.path(0, ".ecp"))
    # the port's offline encoder at the .vif's uniform geometry agrees
    off = tmp_path / "offline"
    off.mkdir()
    for ext in (".dat", ".idx"):
        (off / ("1" + ext)).write_bytes(open(twin.path(0, ext), "rb").read())
    encoder.write_ec_files(str(off / "1"), codec=RSCodec(device="cpu"),
                           large_block_size=BLOCK, small_block_size=BLOCK)
    for s in range(geometry.TOTAL_SHARDS_COUNT):
        ext = geometry.to_ext(s)
        assert (off / ("1" + ext)).read_bytes() == open(twin.path(0, ext), "rb").read()
    # sealed shards read back through EcVolume at the recorded geometry,
    # one data shard lost
    os.unlink(twin.path(0, ".ec03"))
    with EcVolume(twin.dirs[0], "", 1, codec=RSCodec(device="cpu")) as ev:
        assert ev.large_block_size == ev.small_block_size == BLOCK
        for nid in (1, 17, 40, 79):
            assert ev.read_needle(nid).data == twin.rv.read_needle(nid).data


def test_backpressure_degrades(tmp_path, clock):
    t = Twin(str(tmp_path), max_lag_stripes=2)
    try:
        t.write(range(1, 40), pump=False)
        assert t.pump() == (0, 0)
        assert not t.w.active and t.w.fallback_reason == "backpressure"
        with pytest.raises(RuntimeError):
            t.w.seal()
        with pytest.raises(RuntimeError):
            t.rw.seal()
        t.assert_equal()
    finally:
        t.close()


@pytest.mark.parametrize("cut", [0, 7, 24 + 11])
def test_crash_replay_from_truncated_journal(tmp_path, clock, cut):
    t = Twin(str(tmp_path))
    try:
        t.write(range(1, 30))
        t.write(range(30, 45), seed=1, pump=False)  # appended, never encoded
        for w in (t.w, t.rw):
            w.close()
        for i in range(2):
            size = os.path.getsize(t.path(i, ".ecp"))
            with open(t.path(i, ".ecp"), "r+b") as f:
                f.truncate(size - cut)  # a torn or lost journal tail
        t.attach()  # the restart replays from the last durable record
        assert t.w.journal_replays == 1
        t.assert_equal()
        assert t.w.watermark == (t.w._end() // t.w.stripe) * t.w.stripe
        t.both("seal")
        t.assert_equal([geometry.to_ext(s) for s in range(14)])
    finally:
        t.close()


def test_read_shard_range_and_reconstruct_range(twin):
    twin.write(range(1, 50))
    twin.pump(force=True)
    end = twin.w._end()
    rows = -(-end // twin.w.stripe)
    for shard in range(geometry.TOTAL_SHARDS_COUNT):
        for off, size in ((0, BLOCK), (BLOCK - 5, 17), (BLOCK * (rows - 1), BLOCK),
                          (0, BLOCK * rows), (BLOCK * rows, BLOCK)):
            got, want = twin.both("read_shard_range", shard, off, size)
            assert got == want, (shard, off, size)
    assert twin.w.read_shard_range(99, 0, 1) is None
    # every needle's record, reconstructed from parity alone of its columns
    for nid in range(1, 50):
        off, size = twin.v.nm.get(nid)
        n = needle_mod.get_actual_size(size, 3)
        got, want = twin.both("reconstruct_range", off, n)
        assert got is not None and got == want
        assert got == twin.v.read_needle_blob(off, size)
    assert twin.both("reconstruct_range", end, 10) == (None, None)
    assert twin.both("scrub_sample") == twin.both("scrub_sample")[::-1]


def test_flipped_dat_byte_served_from_parity(twin):
    twin.write(range(1, 40))
    twin.pump(force=True)
    for nid in (3, 20, 39):  # a narrow and a wide needle, and the tail row
        off, size = twin.v.nm.get(nid)
        want = twin.rv.read_needle(nid).data
        for i in range(2):
            with open(twin.path(i, ".dat"), "r+b") as f:
                f.seek(off + 40)
                b = f.read(1)
                f.seek(off + 40)
                f.write(bytes([b[0] ^ 0xFF]))
        assert twin.v.read_needle(nid).data == want
        assert twin.rv.read_needle(nid).data == want


def test_vacuum_resets_parity(twin):
    twin.write(range(1, 40))
    for nid in range(1, 40, 3):
        twin.v.delete_needle(Needle(cookie=0x77, id=nid))
        twin.rv.delete_needle(RefNeedle(cookie=0x77, id=nid))
    twin.pump()
    for v in (twin.v, twin.rv):
        v.compact()
        v.commit_compact()  # rewrites every offset: parity restarts
    twin.assert_equal()
    assert twin.w.fallbacks.get("vacuum_reset") == 1
    assert twin.w.watermark == 0
    twin.pump(force=True)
    assert twin.w.watermark > 0


def test_rearm_after_torn_parity_tail(twin):
    twin.write(range(1, 50))
    twin.both("_tear_parity", 0.5)
    twin.assert_equal()
    assert twin.both("parity_health") == (1, 1)
    rows = twin.both("rearm")
    assert rows[0] == rows[1] > 0
    twin.assert_equal()
    assert twin.both("parity_health") == (0, 0)
    assert twin.w.fallbacks.get("parity_rearm") == 1


def test_writer_reattaches_from_vif(twin):
    twin.write(range(1, 25))
    for w in (twin.w, twin.rw):
        w.close()
    twin.block = None  # the .vif records the block size
    twin.attach()
    assert twin.w.block == BLOCK
    # the unencoded tail past the last full row replays at re-attach
    assert twin.w.journal_replays == twin.rw.journal_replays == 1
    twin.assert_equal()
    twin.write(range(25, 35), seed=2)


def test_codec_error_degrades(twin):
    """A codec that raises turns the volume classic, counted and visible."""
    class Broken(RSCodec):
        def encode_rows_async(self, *a, **k):
            raise RuntimeError("kernel launch failed")

    twin.w.codec = Broken(device="cpu")
    twin.write([1], lo=50_000, hi=50_001, pump=False)
    assert twin.w.pump() == 0
    assert not twin.w.active and twin.w.fallbacks == {"encoder_error": 1}
    assert online.online_info(twin.v.base_name) == {"block_size": BLOCK}
