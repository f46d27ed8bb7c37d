"""The port's gear hash and CDC cut rule against the JAX package's, on the
CPU. Inputs are seeded numpy; the tolerance is exact equality, because
these are words and cut positions."""

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import cdc as ref_cdc
from seaweedfs_tpu_torch.ops import cdc

# the cases of tests/test_hash_kernels.py::test_native_scan_bit_identical_to_numpy,
# then the filer's dedup settings (server/filer.py: avg_bits 16, 16 KiB, 512 KiB)
BOUNDARY_CASES = [
    (70, 8, 64, 1024),
    (5_000, 8, 64, 1024),
    (100_000, 13, 2048, 65536),
    (333_333, 10, 512, 8192),
    (999_999, 16, 16384, 524288),
    (4_096, 6, 8, 256),
    (4_096, 6, 16, 128),
    (4_097, 6, 40, 4096),
    (3_000_000, 16, 16 * 1024, 512 * 1024),
]


def _rand(seed, n):
    return np.random.RandomState(seed).randint(0, 256, size=n).astype(np.uint8)


def test_gear_table_equals_jax():
    assert cdc.WINDOW == ref_cdc.WINDOW == 32
    assert cdc._GEAR.dtype == np.uint32
    assert np.array_equal(cdc._GEAR, ref_cdc._GEAR)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100_000])
def test_gear_hashes_equal_jax_and_numpy(n):
    data = _rand(n, n)
    got = cdc.gear_hashes(data, device="cpu")
    assert got.dtype == np.uint32
    assert np.array_equal(got, np.asarray(ref_cdc.gear_hashes(data, backend="jax")))
    assert np.array_equal(got, ref_cdc.gear_hashes_numpy(data))
    assert np.array_equal(cdc.gear_hashes_numpy(data), ref_cdc.gear_hashes_numpy(data))


@pytest.mark.parametrize("n", [1, 40, 4095, 4096, 4097, 9000])
def test_kernel_recurrence_form(n):
    """The kernel's form, run on the host: runs of 32 positions, each
    h = (h << 1) ^ G[b] from 0 over the 31 bytes before the run."""
    data = _rand(n + 1, n)
    g = cdc._GEAR[data].astype(np.uint64)
    out = np.zeros(n, dtype=np.uint32)
    for p0 in range(0, n, 32):
        h = np.uint64(0)
        for q in range(max(0, p0 - 31), min(p0 + 32, n)):
            h = ((h << np.uint64(1)) ^ g[q]) & np.uint64(0xFFFFFFFF)
            if q >= p0:
                out[q] = h
    assert np.array_equal(out, ref_cdc.gear_hashes_numpy(data))


@pytest.mark.parametrize("n,avg_bits,min_size,max_size", BOUNDARY_CASES)
def test_find_boundaries_equal_jax(n, avg_bits, min_size, max_size):
    data = _rand(23 + n, n)
    got = cdc.find_boundaries(
        data, avg_bits=avg_bits, min_size=min_size, max_size=max_size, device="cpu"
    )
    want = ref_cdc.find_boundaries(
        data, avg_bits=avg_bits, min_size=min_size, max_size=max_size, backend="numpy"
    )
    assert got == want
    assert got[-1] == n


def test_find_boundaries_defaults_and_inputs():
    data = _rand(3, 300_000)
    want = ref_cdc.find_boundaries(data, backend="numpy")
    assert cdc.find_boundaries(data, device="cpu") == want
    assert cdc.find_boundaries(memoryview(data.tobytes()), device="cpu") == want
    assert cdc.find_boundaries(torch.from_numpy(data), device="cpu") == want
    assert cdc.find_boundaries(b"", device="cpu") == []


@pytest.mark.parametrize("segment", [200_000, 65_536, 1 << 20])
def test_chunk_stream_equals_jax_and_whole_buffer(segment):
    raw = np.random.RandomState(6).bytes(1_000_000)
    got = list(cdc.chunk_stream(_reader(raw), segment=segment, device="cpu"))
    want = list(ref_cdc.chunk_stream(_reader(raw), segment=segment, backend="numpy"))
    assert got == want
    cuts = cdc.find_boundaries(np.frombuffer(raw, np.uint8), device="cpu")
    assert [o + n for o, n in got] == cuts


def test_chunk_stream_dedup_settings():
    raw = np.random.RandomState(9).bytes(2_500_000)
    kw = dict(avg_bits=16, min_size=16 * 1024, max_size=512 * 1024, segment=600_000)
    got = list(cdc.chunk_stream(_reader(raw), device="cpu", **kw))
    assert got == list(ref_cdc.chunk_stream(_reader(raw), backend="numpy", **kw))


def _reader(raw: bytes):
    pos = 0

    def read(n):
        nonlocal pos
        piece = raw[pos : pos + n]
        pos += len(piece)
        return piece

    return read


@pytest.mark.parametrize("avg_bits", [1, 13, 30, 31, 32])
def test_candidates_mask_widths(avg_bits):
    data = _rand(avg_bits, 50_000)
    h = cdc.gear_hashes_torch(torch.from_numpy(data))
    want = np.nonzero((ref_cdc.gear_hashes_numpy(data) & np.uint32((1 << avg_bits) - 1)) == 0)[0]
    assert np.array_equal(cdc.candidates(h, avg_bits), want)


def test_cut_rule_bounds():
    cands = np.array([5, 10, 11, 500, 900], dtype=np.int64)
    assert cdc.cut_points(cands, 1000, 8, 300) == [11, 311, 501, 801, 901, 1000]
    assert cdc.cut_points(np.array([], dtype=np.int64), 10, 2, 4) == [4, 8, 10]
    assert cdc.cut_points(cands, 0, 8, 300) == []


def test_wrapper_on_cpu_and_rejects():
    data = torch.from_numpy(_rand(4, 1000))
    before = cdc.gear_hash_kernel.launches
    got = cdc.gear_hash_kernel(data)
    assert got.dtype == torch.uint32
    assert np.array_equal(got.numpy(), ref_cdc.gear_hashes_numpy(data.numpy()))
    assert cdc.gear_hash_kernel.launches == before  # no kernel on the CPU
    assert cdc.gear_hash_kernel(torch.empty(0, dtype=torch.uint8)).numel() == 0
    with pytest.raises(ValueError):
        cdc.gear_hash_kernel(torch.zeros((2, 4), dtype=torch.uint8))
    with pytest.raises(ValueError):
        cdc.gear_hash_kernel(torch.empty(8, dtype=torch.uint8, device="meta"))
    assert isinstance(cdc.gear_hashes(data, device="cpu"), torch.Tensor)
