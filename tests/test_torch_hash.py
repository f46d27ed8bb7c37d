"""The port's batch CRC32C, batch MD5 and hash service against the JAX
package's, on the CPU. Inputs are seeded numpy; the tolerance is exact
equality, because these are bytes and words."""

import functools
import hashlib
import sys
import threading

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import crc32c_kernel as ref_crc
from seaweedfs_tpu.ops import md5_kernel as ref_md5
from seaweedfs_tpu.storage import crc as ref_crc_cpu
from seaweedfs_tpu_torch.ops import cdc, hash_service
from seaweedfs_tpu_torch.ops import crc32c_kernel as crc_mod
from seaweedfs_tpu_torch.ops import md5_kernel as md5_mod
from seaweedfs_tpu_torch.ops.hash_service import HashService
from seaweedfs_tpu_torch.storage import crc as crc_cpu


# the CRC kernel's geometry is emulated for an H100 SXM's SM count; on the
# card the wrapper reads the device's own (rs_cuda.sm_count)
H100_SMS = 132


def _rand(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, size=shape).astype(np.uint8)


def _host_crcs(blocks):
    return np.array([crc_cpu.crc32c(b.tobytes()) for b in blocks], dtype=np.uint32)


def _fold(cols, r):
    """XOR over k of cols[:, k] where bit k of r is set, lane by lane."""
    bits = (r[:, None] >> np.arange(32, dtype=np.uint32)) & 1
    return np.bitwise_xor.reduce(np.where(bits == 1, cols, 0).astype(np.uint32), axis=1)


def emulate_crc_kernel(row, warps):
    """csrc/crc32c_batch.cu on one blob, in numpy: `warps` spans; lane j of a
    span takes pieces j, j + 32, ... (a partial last piece read with zeros
    after it) and advances by STRIDE bytes a piece with the piece tables;
    level-1 columns fold the lanes into their warp, level-2 the warps into
    the blob; ^ crc(0^L)."""
    length = len(row)
    span = crc_mod.crc_span(length, warps)
    cols = crc_mod._fold_columns(length, warps)
    assert cols.shape == (64 + warps, 32)
    t = crc_mod._piece_tables()
    padded = np.zeros(-(-length // 16) * 16, np.uint8)
    padded[:length] = row
    words = padded.view("<u4").reshape(-1, 4)
    last = (length - 1) // span
    total = 0
    for w in range(min(warps, last + 1)):
        start, end = w * span, min(w * span + span, length)
        pieces = words[start // 16 : start // 16 - (-(end - start) // 16)]
        r = np.zeros(32, np.uint32)
        for k in range(0, len(pieces), 32):
            v = pieces[k : k + 32]
            lanes = len(v)
            acc = np.zeros(lanes, np.uint32)
            for q, word in enumerate((v[:, 0] ^ r[:lanes], v[:, 1], v[:, 2], v[:, 3])):
                for b in range(4):
                    acc ^= t[4 * q + b][(word >> (8 * b)) & 0xFF]
            r[:lanes] = acc
        y = np.bitwise_xor.reduce(_fold(cols[32:64] if w == last else cols[:32], r))
        total ^= int(_fold(cols[64 + w][None, :], np.array([y], np.uint32))[0])
    return total ^ crc_mod._zero_crc(length)


class TestCRCBatch:
    @pytest.mark.parametrize("length", [1, 8, 64, 100, 4096])
    def test_equals_jax_and_host(self, length):
        blocks = _rand(length, (17, length))
        got = crc_mod.crc32c_batch(blocks, device="cpu")
        assert got.dtype == np.uint32
        assert np.array_equal(got, np.asarray(ref_crc.crc32c_batch(blocks, backend="jax")))
        assert np.array_equal(got, _host_crcs(blocks))

    def test_zero_block_constant(self):
        got = crc_mod.crc32c_batch(np.zeros((3, 256), np.uint8), device="cpu")
        assert (got == ref_crc_cpu.crc32c(b"\x00" * 256)).all()
        assert crc_mod._zero_crc(256) == ref_crc._zero_crc(256)

    @pytest.mark.parametrize("length", [1, 7, 64, 1000])
    def test_matrices_equal_jax(self, length):
        assert crc_mod._byte_step_matrix() == ref_crc._byte_step_matrix()
        assert crc_mod._block_matrix(length) == ref_crc._block_matrix(length)
        assert crc_mod._power_matrix(length) == ref_crc._power_matrix(length)

    def test_combine(self):
        rng = np.random.RandomState(1)
        a, b = rng.bytes(1000), rng.bytes(777)
        ca, cb = crc_cpu.crc32c(a), crc_cpu.crc32c(b)
        got = crc_mod.crc32c_combine(ca, cb, len(b))
        assert got == ref_crc.crc32c_combine(ca, cb, len(b)) == crc_cpu.crc32c(a + b)
        assert crc_mod.crc32c_combine(ca, 0, 0) == ref_crc.crc32c_combine(ca, 0, 0) == ca

    @pytest.mark.parametrize("length", [99, 100, 101, 250, 777])
    def test_plain_segments(self, monkeypatch, length):
        """Blobs longer than SEGMENT bytes: per-piece products carried by
        A^(bytes after the piece) and XORed."""
        monkeypatch.setattr(crc_mod, "SEGMENT", 100)
        monkeypatch.setattr(crc_mod, "PLAIN_CHUNK_BITS", 1600)  # row chunks of 2
        blocks = _rand(length + 7, (5, length))
        got = crc_mod.crc32c_batch_torch(torch.from_numpy(blocks)).numpy()
        assert np.array_equal(got, _host_crcs(blocks))

    @pytest.mark.parametrize("length", [1, 15, 16, 33, 511, 512, 513, 4097])
    def test_kernel_lane_algebra(self, length):
        """The kernel's split at the geometry a lone blob gets, run on the
        host: each lane's register-only CRC of its interleaved pieces,
        folded into its warp and the warps into the blob, ^ crc(0^L)."""
        row = _rand(length, length)
        warps = crc_mod.crc_warps(1, length, H100_SMS)
        span = crc_mod.crc_span(length, warps)
        assert span % crc_mod.STRIDE == 0 and warps * span >= length
        assert emulate_crc_kernel(row, warps) == crc_cpu.crc32c(row.tobytes())

    def test_slice8_tables(self):
        t = crc_mod._advance_tables(8)
        assert np.array_equal(t[0], crc_cpu._TABLE)
        rng = np.random.RandomState(2)
        for _ in range(20):
            c = int(rng.randint(0, 1 << 32, dtype=np.uint64))
            v = rng.randint(0, 256, 8).astype(np.uint8)
            want = c
            for b in v.tolist():
                want = int(t[0][(want ^ b) & 0xFF]) ^ (want >> 8)
            lo = int.from_bytes(v[:4].tobytes(), "little") ^ c
            hi = int.from_bytes(v[4:].tobytes(), "little")
            got = 0
            for j, w in enumerate((lo, hi)):
                for q in range(4):
                    got ^= int(t[7 - 4 * j - q][(w >> 8 * q) & 0xFF])
            assert got == want

    def test_tensor_view_in_tensor_out(self):
        big = torch.from_numpy(_rand(3, (9, 300)))
        view = big[:, 5:205]
        before = crc_mod.crc32c_batch_kernel.launches
        got = crc_mod.crc32c_batch(view, device="cpu")
        assert isinstance(got, torch.Tensor) and got.dtype == torch.uint32
        assert np.array_equal(got.numpy(), _host_crcs(view.numpy()))
        assert crc_mod.crc32c_batch_kernel.launches == before  # no kernel on the CPU

    def test_rejects(self):
        with pytest.raises(ValueError):
            crc_mod.crc32c_batch_kernel(torch.zeros(8, dtype=torch.uint8))
        with pytest.raises(ValueError):
            crc_mod.crc32c_batch_kernel(torch.zeros((2, 8), dtype=torch.int32))
        with pytest.raises(ValueError):
            crc_mod.crc32c_batch_kernel(torch.empty((2, 8), dtype=torch.uint8, device="meta"))

    def test_u32_tensor(self):
        v = torch.tensor([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1])
        assert crc_mod.u32_tensor(v).to(torch.int64).tolist() == v.tolist()


@functools.lru_cache(maxsize=None)
def _layout_row(length):
    return _rand(length + 3, length)


@functools.lru_cache(maxsize=None)
def _jax_crc(length):
    return int(np.asarray(ref_crc.crc32c_batch(_layout_row(length)[None, :], backend="jax"))[0])


class TestCRCKernelLayout:
    """The host-side layout and algebra of csrc/crc32c_batch.cu."""

    @pytest.mark.parametrize("length", [1, 15, 16, 33, 4096, 4097, 65536 + 5])
    @pytest.mark.parametrize("segments", [32, 64, 256, 1024])
    def test_two_level_fold(self, segments, length):
        """segments = 32 lanes x warps per blob: the emulated kernel equals
        the host CRC and the JAX package's crc32c_batch."""
        row = _layout_row(length)
        got = emulate_crc_kernel(row, segments // 32)
        assert got == crc_cpu.crc32c(row.tobytes()) == _jax_crc(length)

    def test_piece_tables(self):
        """One piece step: r ^ the piece's first word, 16 lookups, equals the
        byte-wise CRC over the piece and the 496 zero bytes after it."""
        t = crc_mod._piece_tables()
        assert t.shape == (16, 256) and t.dtype == np.uint32
        rng = np.random.RandomState(3)
        for _ in range(8):
            r = int(rng.randint(0, 1 << 32, dtype=np.uint64))
            piece = rng.randint(0, 256, 16).astype(np.uint8)
            want = r
            for b in piece.tolist() + [0] * (crc_mod.STRIDE - crc_mod.PIECE):
                want = int(crc_cpu._TABLE[(want ^ b) & 0xFF]) ^ (want >> 8)
            words = piece.view("<u4").astype(np.uint32)
            words[0] ^= r
            got = 0
            for k in range(16):
                got ^= int(t[k][(int(words[k // 4]) >> (8 * (k % 4))) & 0xFF])
            assert got == want

    def test_inverse_powers(self):
        eye = np.eye(32, dtype=np.uint8)
        a = np.frombuffer(crc_mod._byte_step_matrix(), dtype=np.uint8).reshape(32, 32)
        inv = np.frombuffer(crc_mod._inverse_step_matrix(), dtype=np.uint8).reshape(32, 32)
        assert np.array_equal(crc_mod._matmul2(a, inv), eye)
        for e in (1, 16, 496, 4096 + 7):
            fwd = crc_mod._signed_power_matrix(e)
            assert np.array_equal(fwd, np.frombuffer(crc_mod._power_matrix(e), np.uint8).reshape(32, 32))
            assert np.array_equal(crc_mod._matmul2(crc_mod._signed_power_matrix(-e), fwd), eye)

    @pytest.mark.parametrize("n, length, warps", [
        (16, 4096, 4),  # upload at the filer's load
        (8192, 4096, 1),  # the service's full batch
        (256, 4 << 20, 16),  # the chunked path: 4,096 warps
        (1, 4 << 20, 32),
        (3, (1 << 20) + 17, 32),
        (16, 65536, 32),
        (8193, 1, 1),
    ])
    def test_geometry(self, n, length, warps):
        assert crc_mod.crc_warps(n, length, H100_SMS) == warps
        span = crc_mod.crc_span(length, warps)
        assert span % crc_mod.STRIDE == 0 and warps * span >= length
        assert warps == 1 or span >= crc_mod.MIN_SPAN
        if warps > 1:  # one more warp would have cut a span short or been idle
            assert n * warps <= 2 * H100_SMS * crc_mod.WARPS_PER_SM

    @pytest.mark.parametrize("n, length, threads, blocks", [
        (16, 4096, 256, 8),  # 2 blobs a block
        (8192, 4096, 256, 512),  # 1,024 groups in two rounds of 512
        (256, 4 << 20, 512, 256),
        (1, 4 << 20, 1024, 1),
        (132 * 8 + 1, 4096, 256, 265),
        (8193, 1, 256, 513),
    ])
    def test_grid(self, n, length, threads, blocks):
        """Whole blobs a block; the grid within what the card holds at once
        and no larger than the fewest rounds over the groups need."""
        warps = crc_mod.crc_warps(n, length, H100_SMS)
        assert crc_mod.crc_grid(n, warps, H100_SMS) == (threads, blocks)
        assert threads % (32 * warps) == 0 and threads <= 1024
        assert blocks * threads <= H100_SMS * crc_mod.RESIDENT_THREADS
        groups = -(-n // (threads // 32 // warps))
        rounds = -(-groups // blocks)
        assert blocks == 1 or -(-groups // (blocks - 1)) > rounds  # one block fewer: a round more


class TestMD5Batch:
    @pytest.mark.parametrize("length", [0, 1, 55, 56, 63, 64, 65, 119, 120, 4096])
    def test_equals_jax_and_hashlib(self, length):
        blobs = _rand(length + 1, (9, length))
        got = md5_mod.md5_batch(blobs, device="cpu")
        assert got.shape == (9, 16) and got.dtype == np.uint8
        assert np.array_equal(got, np.asarray(ref_md5.md5_batch(blobs, backend="jax")))
        for i in range(9):
            assert got[i].tobytes() == hashlib.md5(blobs[i].tobytes()).digest()

    def test_constants_equal_jax(self):
        assert np.array_equal(md5_mod._K, ref_md5._K)
        assert np.array_equal(md5_mod._S, ref_md5._S)
        for n in (0, 55, 56, 64, 119, 120):
            assert md5_mod._pad_len(n) == ref_md5._pad_len(n)

    def test_tensor_view_in_tensor_out(self):
        big = torch.from_numpy(_rand(4, (5, 200)))
        view = big[:, 3:133]
        before = md5_mod.md5_batch_kernel.launches
        got = md5_mod.md5_batch(view, device="cpu")
        assert isinstance(got, torch.Tensor)
        for i in range(5):
            assert got[i].numpy().tobytes() == hashlib.md5(view[i].numpy().tobytes()).digest()
        assert md5_mod.md5_batch_kernel.launches == before

    def test_rejects(self):
        with pytest.raises(ValueError):
            md5_mod.md5_batch_kernel(torch.zeros(8, dtype=torch.uint8))
        with pytest.raises(ValueError):
            md5_mod.md5_batch_kernel(torch.empty((2, 8), dtype=torch.uint8, device="meta"))


def _check(blob, result):
    result.wait()
    assert result.md5 == hashlib.md5(blob).digest()
    assert result.crc == crc_cpu.crc32c(blob)
    assert result.md5_hex() == hashlib.md5(blob).hexdigest()


class TestHashService:
    def test_batch_hash_equals_jax_service(self):
        from seaweedfs_tpu.ops.hash_service import _batch_hash as ref_batch_hash

        blobs = _rand(3, (32, 4096))
        svc = HashService(device="cpu")
        digests, crcs = svc._batch_hash([(b.tobytes(), None) for b in blobs], 4096)
        want_d, want_c = ref_batch_hash("python", blobs)
        assert np.array_equal(digests, want_d)
        assert np.array_equal(crcs, want_c) and crcs.dtype == np.uint32

    def test_concurrent_submits_batch(self):
        svc = HashService(device="cpu", linger_s=0.005)
        svc.start()
        try:
            rng = np.random.RandomState(5)
            blobs = [rng.bytes(4096) for _ in range(64)]
            results = [None] * 64

            def work(i):
                results[i] = svc.submit(blobs[i])

            threads = [threading.Thread(target=work, args=(i,)) for i in range(64)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            for b, r in zip(blobs, results):
                _check(b, r)
            assert svc.batch_blobs + svc.host_blobs == 64 and svc.failed_blobs == 0
        finally:
            svc.stop()

    def test_submit_many_coalesces(self):
        svc = HashService(device="cpu", linger_s=0.001)
        svc.start()
        try:
            rng = np.random.RandomState(6)
            pieces = [rng.bytes(1000) for _ in range(20)] + [rng.bytes(17)]
            futs = svc.submit_many(pieces)
            for p, f in zip(pieces, futs):
                _check(p, f)
            assert svc.batch_blobs == 20  # the 1000-byte bucket went through the batch path
            assert svc.host_blobs == 1  # a bucket of one blob is under min_batch
        finally:
            svc.stop()

    def test_mixed_lengths_and_empty(self):
        svc = HashService(device="cpu", linger_s=0.001)
        svc.start()
        try:
            payloads = [b"", b"x", b"hello" * 100, b"z" * 10000, memoryview(b"abc" * 7)]
            for p, f in zip(payloads, [svc.submit(p) for p in payloads]):
                _check(bytes(p), f)
            for p, f in zip(payloads, svc.submit_many(payloads)):
                _check(bytes(p), f)
        finally:
            svc.stop()

    def test_not_started_hashes_on_host(self):
        svc = HashService(device="cpu")
        blobs = [b"a" * 64] * 5
        for b, f in zip(blobs, svc.submit_many(blobs)):
            _check(b, f)
        _check(b"q" * 9, svc.submit(b"q" * 9))
        assert svc.host_blobs == 6 and svc.batch_blobs == 0
        md5_hex, crc = svc.hash_now(b"hello")
        assert md5_hex == hashlib.md5(b"hello").hexdigest() and crc == crc_cpu.crc32c(b"hello")

    def test_large_bucket_split_by_max_batch(self):
        svc = HashService(device="cpu", linger_s=0.001, max_batch=8)
        calls = []
        real = svc._batch_hash

        def spy(items, length):
            calls.append(len(items))
            return real(items, length)

        svc._batch_hash = spy
        svc.start()
        try:
            blobs = [bytes([i]) * 64 for i in range(19)]
            for b, f in zip(blobs, svc.submit_many(blobs)):
                _check(b, f)
            assert calls == [8, 8]  # the last 3 are under min_batch: host
            assert svc.batch_blobs == 16 and svc.host_blobs == 3
        finally:
            svc.stop()

    def test_failing_batch_fails_its_futures(self):
        """A kernel failure reaches every future of the bucket; nothing is
        hashed again on the host."""
        svc = HashService(device="cpu", linger_s=0.001)

        def broken(items, length):
            raise RuntimeError("kernel launch failed: CUDA error 209")

        svc._batch_hash = broken
        svc.start()
        try:
            blobs = [bytes([i]) * 128 for i in range(8)]
            futs = svc.submit_many(blobs)
            for f in futs:
                with pytest.raises(RuntimeError, match="CUDA error 209"):
                    f.wait()
                with pytest.raises(RuntimeError):
                    f.md5_hex()
                assert f.md5 == b""
            assert svc.failed_blobs == 8 and svc.batch_blobs == 0 and svc.host_blobs == 0
            # the service keeps serving after a failed batch
            _check(b"k" * 3, svc.submit_many([b"k" * 3])[0])
        finally:
            svc.stop()

    def test_stress_more_threads_than_cores(self):
        """32 submitting threads, a 10 us switch interval and mixed lengths:
        every future gets its own blob's hashes and no count is lost."""
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        svc = HashService(device="cpu", linger_s=0.0002)
        svc.start()
        try:
            rng = np.random.RandomState(11)
            blobs = [rng.bytes(int(rng.choice([16, 64, 100]))) for _ in range(32 * 40)]
            results = [None] * len(blobs)

            def work(t):
                for i in range(t, len(blobs), 32):
                    results[i] = svc.submit(blobs[i])

            threads = [threading.Thread(target=work, args=(t,)) for t in range(32)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            for b, r in zip(blobs, results):
                _check(b, r)
            assert svc.batch_blobs + svc.host_blobs == len(blobs)
            assert svc.failed_blobs == 0
        finally:
            svc.stop()
            sys.setswitchinterval(old)

    def test_wait_times_out(self):
        svc = HashService(device="cpu", linger_s=0.001)  # never started: nothing flushes
        pending = hash_service.HashResult(svc._done_cv)
        with pytest.raises(TimeoutError):
            pending.wait(timeout=0.01)

    def test_constants_equal_jax(self):
        from seaweedfs_tpu.ops import hash_service as ref_service

        assert hash_service._MIN_BATCH == ref_service._MIN_BATCH == 4
        assert hash_service._MAX_BATCH == ref_service._MAX_BATCH == 8192
        assert hash_service._LINGER_S == ref_service._LINGER_S == 0.0005


def test_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(hash_service, "_SERVICE", None)
    x = _rand(0, (4, 64))
    with pytest.raises(RuntimeError):
        HashService()
    with pytest.raises(RuntimeError):
        HashService(device="cuda")
    with pytest.raises(RuntimeError):
        hash_service.get_hash_service()
    assert hash_service._SERVICE is None
    with pytest.raises(RuntimeError):
        crc_mod.crc32c_batch(x)
    with pytest.raises(RuntimeError):
        crc_mod.crc32c_batch(torch.from_numpy(x))
    with pytest.raises(RuntimeError):
        md5_mod.md5_batch(x)
    with pytest.raises(RuntimeError):
        cdc.find_boundaries(x.reshape(-1))
    with pytest.raises(RuntimeError):
        cdc.gear_hashes(x.reshape(-1))
    with pytest.raises(RuntimeError):
        list(cdc.chunk_stream(lambda n: b"", segment=64))
