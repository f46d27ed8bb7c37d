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

    def test_product_tables(self):
        m = _rand(9, (4, 10))
        t = rs_cuda.product_tables(m)
        assert t.shape == (10, 4, 256)
        mul = ref_gf256.mul_table()
        for r in range(4):
            for c in range(10):
                assert np.array_equal(t[c, r], mul[m[r, c]])


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
