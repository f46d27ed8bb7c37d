"""The port's GF(2^8) math, plain transform and RS codec against the JAX
package's, on the CPU. Inputs are seeded numpy; the tolerance is exact
equality, because these are bytes."""

import itertools

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import gf256 as ref_gf256
from seaweedfs_tpu.ops.rs_kernel import RSCodec as RefCodec
from seaweedfs_tpu.ops.rs_kernel import gf_matmul_jax
from seaweedfs_tpu_torch.compat import from_reference_matrix
from seaweedfs_tpu_torch.ops import gf256, rs_cuda
from seaweedfs_tpu_torch.ops.rs_kernel import RSCodec
from tests._threads import stop_history_loops  # noqa: F401

SHAPES = [(4, 10), (1, 10), (3, 7), (14, 14)]
LENGTHS = [1, 17, 8191, 8193]


def _rand(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, size=shape).astype(np.uint8)


class TestGF256Copy:
    def test_tables(self):
        assert np.array_equal(gf256.EXP_TABLE, ref_gf256.EXP_TABLE)
        assert np.array_equal(gf256.LOG_TABLE, ref_gf256.LOG_TABLE)
        assert np.array_equal(gf256.mul_table(), ref_gf256.mul_table())

    @pytest.mark.parametrize("data,parity", [(10, 4), (6, 3), (4, 2), (12, 2)])
    def test_rs_matrix_and_parity_rows(self, data, parity):
        assert np.array_equal(
            gf256.rs_matrix(data, parity), ref_gf256.rs_matrix(data, parity)
        )
        assert np.array_equal(
            gf256.parity_rows(data, parity), ref_gf256.parity_rows(data, parity)
        )

    @pytest.mark.parametrize("size", [1, 2, 3, 4])
    def test_decode_matrix_sampled(self, size):
        # a seeded sample of 200 missing sets over sizes 1-4 (50 each)
        sets = list(itertools.combinations(range(14), size))
        rng = np.random.RandomState(size)
        pick = rng.choice(len(sets), size=min(50, len(sets)), replace=False)
        for i in pick:
            missing = sets[i]
            present = tuple(s for s in range(14) if s not in missing)
            assert np.array_equal(
                gf256.decode_matrix(10, 4, present, missing),
                ref_gf256.decode_matrix(10, 4, present, missing),
            ), missing

    def test_bit_matrix(self):
        m = _rand(3, (4, 10))
        assert np.array_equal(gf256.bit_matrix(m), ref_gf256.bit_matrix(m))


class TestPlainTransform:
    @pytest.mark.parametrize("n", LENGTHS)
    @pytest.mark.parametrize("rows,cols", SHAPES)
    def test_equals_jax_and_oracle(self, rows, cols, n):
        m = _rand(rows * 100 + cols, (rows, cols))
        x = _rand(n, (cols, n))
        got = rs_cuda.gf_matmul_torch(m, torch.from_numpy(x)).numpy()
        assert np.array_equal(got, np.asarray(gf_matmul_jax(m, x)))
        assert np.array_equal(got, ref_gf256.gf_matmul_bytes(m, x))

    def test_chunked_equals_whole(self, monkeypatch):
        m = ref_gf256.parity_rows(10, 4)
        x = _rand(5, (10, 1000))
        whole = rs_cuda.gf_matmul_torch(m, torch.from_numpy(x)).numpy()
        monkeypatch.setattr(rs_cuda, "PLAIN_CHUNK", 96)
        assert np.array_equal(
            rs_cuda.gf_matmul_torch(m, torch.from_numpy(x)).numpy(), whole
        )

    def test_wrapper_batched_layout_on_cpu(self):
        m = ref_gf256.parity_rows(10, 4)
        buf = _rand(6, (7, 10, 300))
        before = rs_cuda.gf256_matmul.launches
        got = rs_cuda.gf256_matmul(m, torch.from_numpy(buf)).numpy()
        want = ref_gf256.gf_matmul_bytes(
            m, np.ascontiguousarray(buf.transpose(1, 0, 2)).reshape(10, -1)
        )
        assert np.array_equal(got, want)
        assert rs_cuda.gf256_matmul.launches == before  # no kernel on the CPU

    def test_wrapper_rejects_other_devices(self):
        x = torch.empty((10, 64), dtype=torch.uint8, device="meta")
        with pytest.raises(ValueError):
            rs_cuda.gf256_matmul(ref_gf256.parity_rows(10, 4), x)

    @pytest.mark.parametrize("shape", [(15, 10), (4, 15), (0, 3)])
    def test_matrix_limits(self, shape):
        with pytest.raises(ValueError):
            rs_cuda.check_matrix(np.ones(shape, dtype=np.uint8))


def byte_perm(x, y, selector):
    """CUDA's __byte_perm (prmt) on uint32 values held in int64: byte i of
    the result is byte (nibble i of selector) of the 8 bytes y:x."""
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(selector >> (4 * i)) & 7] << (8 * i) for i in range(4))


def emulate_gf_kernel(matrix, x, vec=True):
    """csrc/gf256_matmul.cu on (cols, n) bytes, in plain torch: whole
    16-byte units (when vec) take one packed lookup per input byte and
    group, XOR across columns, and the prmt transpose into rows; the tail,
    or every byte when not vec, one byte a thread. One row reads the
    tables' low bytes."""
    rows, cols = matrix.shape
    t = torch.from_numpy(rs_cuda.packed_tables(matrix).astype(np.int64))  # (G, cols, 256)
    xt = torch.from_numpy(x.astype(np.int64))
    n = xt.shape[1]
    out = torch.zeros((rows, n), dtype=torch.int64)
    units = n // 16 if vec else 0
    if units:
        # the words of each column's unit as a uint4 load gives them
        b = xt[:, : units * 16].reshape(cols, units, 4, 4)
        words = (b << (8 * torch.arange(4))).sum(-1)  # (cols, units, 4)
        for g in range(t.shape[0]):
            acc = torch.zeros((units, 16), dtype=torch.int64)
            if rows == 1:  # byte tables: acc[k] ^= table[byte j of word k] << 8j
                for c in range(cols):
                    for k in range(4):
                        for j in range(4):
                            v = (words[c, :, k] >> (8 * j)) & 0xFF
                            acc[:, k] ^= (t[0, c, v] & 0xFF) << (8 * j)
                out[0, : units * 16] = ((acc[:, :4, None] >> (8 * torch.arange(4))) & 0xFF).reshape(-1)
                break
            for c in range(cols):
                for k in range(4):
                    for j in range(4):
                        acc[:, 4 * k + j] ^= t[g, c, (words[c, :, k] >> (8 * j)) & 0xFF]
            for w in range(4):
                a0, a1, a2, a3 = (acc[:, 4 * w + j] for j in range(4))
                t0, t1 = byte_perm(a0, a1, 0x5140), byte_perm(a0, a1, 0x7362)
                t2, t3 = byte_perm(a2, a3, 0x5140), byte_perm(a2, a3, 0x7362)
                o = (byte_perm(t0, t2, 0x5410), byte_perm(t0, t2, 0x7632),
                     byte_perm(t1, t3, 0x5410), byte_perm(t1, t3, 0x7632))
                for k in range(4):
                    if 4 * g + k < rows:
                        for j in range(4):
                            out[4 * g + k, 4 * w + j : units * 16 : 16] = (o[k] >> (8 * j)) & 0xFF
    tail = xt[:, units * 16 :]
    for g in range(t.shape[0]):
        acc = torch.zeros(tail.shape[1], dtype=torch.int64)
        for c in range(cols):
            acc ^= t[g, c, tail[c]] & (0xFF if rows == 1 else 0xFFFFFFFF)
        for k in range(min(4, rows - 4 * g)):
            out[4 * g + k, units * 16 :] = (acc >> (8 * k)) & 0xFF
    return out.to(torch.uint8).numpy()


class TestPackedKernelLayout:
    """The host tables and arithmetic of csrc/gf256_matmul.cu."""

    @pytest.mark.parametrize("n", LENGTHS)
    @pytest.mark.parametrize("cols", [1, 7, 10, 14])
    @pytest.mark.parametrize("rows", range(1, 15))
    def test_emulated_kernel(self, rows, cols, n):
        """Whole units and the byte path both equal the JAX transform and
        the numpy oracle, byte for byte."""
        m = _rand(rows * 100 + cols + 7, (rows, cols))
        x = _rand(n + 5, (cols, n))
        want = ref_gf256.gf_matmul_bytes(m, x)
        assert np.array_equal(np.asarray(gf_matmul_jax(m, x)), want)
        assert np.array_equal(emulate_gf_kernel(m, x, vec=True), want)
        assert np.array_equal(emulate_gf_kernel(m, x, vec=False), want)

    @pytest.mark.parametrize("cols", [1, 10, 14])
    @pytest.mark.parametrize("rows", [1, 4, 5, 14])
    def test_packed_tables(self, rows, cols):
        """Byte k of word v of table (g, c) is matrix[4g + k, c] x v, 0 past
        the last row."""
        m = _rand(rows * 100 + cols, (rows, cols))
        t = rs_cuda.packed_tables(m)
        groups = -(-rows // 4)
        assert t.shape == (groups, cols, 256) and t.dtype == np.uint32
        assert t.flags["C_CONTIGUOUS"]
        mul = ref_gf256.mul_table()
        for g in range(groups):
            for c in range(cols):
                for k in range(4):
                    r = 4 * g + k
                    want = mul[m[r, c]] if r < rows else np.zeros(256, np.uint8)
                    assert np.array_equal((t[g, c] >> (8 * k)) & 0xFF, want)

    def test_transpose_selectors(self):
        """The four prmt selectors turn words a0..a3 into out_k = byte k of
        each, low word first: the shifts-and-masks transpose."""
        a = [int(v) for v in np.random.RandomState(11).randint(0, 1 << 32, 4, dtype=np.uint64)]
        t0, t1 = byte_perm(a[0], a[1], 0x5140), byte_perm(a[0], a[1], 0x7362)
        t2, t3 = byte_perm(a[2], a[3], 0x5140), byte_perm(a[2], a[3], 0x7362)
        got = [byte_perm(t0, t2, 0x5410), byte_perm(t0, t2, 0x7632),
               byte_perm(t1, t3, 0x5410), byte_perm(t1, t3, 0x7632)]
        want = [sum(((a[j] >> (8 * k)) & 0xFF) << (8 * j) for j in range(4)) for k in range(4)]
        assert got == want


class TestCodec:
    def setup_method(self):
        self.port = RSCodec(device="cpu")
        self.ref = RefCodec(backend="jax")

    @pytest.mark.parametrize("n", [1, 255, 4096 + 3])
    def test_encode_and_encode_all(self, n):
        data = _rand(n, (10, n))
        assert np.array_equal(self.port.encode(data), self.ref.encode(data))
        assert np.array_equal(self.port.encode_all(data), self.ref.encode_all(data))

    @pytest.mark.parametrize(
        "missing", [(0,), (13,), (2, 11), (0, 1, 2, 3), (1, 4, 7, 9), (2, 5, 11, 13)]
    )
    def test_reconstruct(self, missing):
        data = _rand(len(missing), (10, 777))
        full = self.ref.encode_all(data)
        present = {i: full[i] for i in range(14) if i not in missing}
        got = self.port.reconstruct(present)
        want = self.ref.reconstruct(present)
        assert sorted(got) == sorted(want) == list(missing)
        for t in missing:
            assert np.array_equal(got[t], want[t])
            assert np.array_equal(got[t], full[t])

    def test_verify(self):
        full = self.ref.encode_all(_rand(1, (10, 500)))
        assert self.port.verify(full) and self.ref.verify(full)
        full[12, 17] ^= 0x40
        assert not self.port.verify(full) and not self.ref.verify(full)

    @pytest.mark.parametrize("block,rows", [(100, 7), (16, 1), (1024, 3)])
    def test_encode_rows_async(self, block, rows):
        buf = _rand(block, rows * 10 * block)
        got = self.port.encode_rows_async(buf, block, rows).result()
        want = self.ref.encode_rows_async(buf, block, rows).result()
        assert np.array_equal(got, np.asarray(want))

    def test_apply2d_async_and_apply_matrix(self):
        m = from_reference_matrix(ref_gf256.decode_matrix(10, 4, tuple(range(4, 14)), (0, 1, 2)))
        x = _rand(2, (10, 3000))
        want = self.ref.apply_matrix(m, x)
        assert np.array_equal(self.port.apply2d_async(m, x).result(), want)
        assert np.array_equal(self.port.apply_matrix(m, x), want)
        assert np.array_equal(self.port.encode2d_async(x).result(), self.ref.encode(x))

    def test_read_only_input(self):
        x = np.frombuffer(_rand(4, (10, 64)).tobytes(), dtype=np.uint8).reshape(10, 64)
        assert np.array_equal(self.port.encode(x), self.ref.encode(x))
