"""GF(2^8) shard transform on the card: the CUDA kernel's wrapper and its
plain PyTorch version.

    out[r] = XOR_c matrix[r, c] x shards[c]        (field 0x11D)

`gf256_matmul` is the wrapper of the hand-written kernel
`csrc/gf256_matmul.cu` (packed-row product tables in shared memory, one
32-bit lookup per input byte for four output rows; it replaces the Pallas
kernel `seaweedfs_tpu/ops/rs_pallas.py::_compiled`). `packed_tables` builds
the host tables it reads. For a CUDA tensor it launches the kernel or
raises; for a tensor on the CPU it runs `gf_matmul_torch`, the plain
version. Nothing else is chosen.

`gf_matmul_torch` mirrors the JAX package's XLA transform
(`seaweedfs_tpu/ops/rs_kernel.py::_compiled_transform`): expand each byte
into bit-planes, one matmul against the GF(2) bit matrix, `& 1`, pack. It
derives the result differently from the kernel's tables, so the two check
each other; both are held against `gf256.gf_matmul_bytes`. PyTorch has no
integer matmul on CUDA, so the matmul runs in float32 on 0/1 values, which
is exact: each sum is at most 8 * cols <= 112 < 2^24.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from . import _build, gf256

MAX_ROWS = 14
MAX_COLS = 14
# Columns per chunk of the plain version: its bits tensor costs
# 4 * 8 * cols bytes per column (320 MiB per chunk for RS(10,4)).
PLAIN_CHUNK = 1 << 20
# The kernel's grid is at most the device's SM count times this many
# 256-thread blocks, split over the batches.
BLOCKS_PER_SM = 4


def check_matrix(matrix) -> np.ndarray:
    """A (rows, cols) uint8 C-contiguous copy of `matrix`, within the
    kernel's limits (rows <= 14, cols <= 14)."""
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    if m.ndim != 2 or not (1 <= m.shape[0] <= MAX_ROWS) or not (
        1 <= m.shape[1] <= MAX_COLS
    ):
        raise ValueError(
            f"coefficient matrix must be (rows<={MAX_ROWS}, cols<={MAX_COLS}),"
            f" got {m.shape}"
        )
    return m


@functools.lru_cache(maxsize=256)
def _packed_tables(matrix_bytes: bytes, rows: int, cols: int) -> np.ndarray:
    groups = -(-rows // 4)
    m = np.zeros((groups * 4, cols), dtype=np.uint8)  # rows past the last are 0
    m[:rows] = np.frombuffer(matrix_bytes, dtype=np.uint8).reshape(rows, cols)
    # t[g, k, c, v] = m[4g + k, c] x v, shifted into byte k
    t = gf256.mul_table()[m].astype(np.uint32).reshape(groups, 4, cols, 256)
    t <<= (8 * np.arange(4, dtype=np.uint32))[:, None, None]
    # word v of table (g, c): rows 4g..4g+3 times v, low byte first
    return np.bitwise_or.reduce(t, axis=1)


def packed_tables(matrix) -> np.ndarray:
    """(ceil(rows/4), cols, 256) uint32 host tables of the kernel, cached by
    matrix: word v of (g, c) is matrix[4g + k, c] x v in byte k, 0 past the
    last row. With one row the kernel reads only the low bytes."""
    m = check_matrix(matrix)
    return _packed_tables(m.tobytes(), *m.shape)


@functools.lru_cache(maxsize=256)
def _device_tables(matrix_bytes: bytes, rows: int, cols: int, device: str):
    t = _packed_tables(matrix_bytes, rows, cols)
    return torch.from_numpy(t.view(np.int32)).to(device)


@functools.lru_cache(maxsize=256)
def _bit_matrix(matrix_bytes: bytes, rows: int, cols: int, device: str):
    m = np.frombuffer(matrix_bytes, dtype=np.uint8).reshape(rows, cols)
    # (cols*8, rows*8), rows ordered (c, k), columns (r, j)
    return torch.from_numpy(gf256.bit_matrix(m)).to(device, torch.float32)


def gf_matmul_torch(matrix, shards: torch.Tensor) -> torch.Tensor:
    """Plain version. shards: (cols, n) uint8 on any device -> (rows, n)."""
    m = check_matrix(matrix)
    rows, cols = m.shape
    if shards.dtype != torch.uint8 or shards.dim() != 2 or shards.shape[0] != cols:
        raise ValueError(
            f"shards must be ({cols}, n) uint8, got {tuple(shards.shape)}"
            f" {shards.dtype}"
        )
    dev = shards.device
    if dev.type == "cuda":
        # exact only in full float32: never let the matmul round through TF32
        torch.backends.cuda.matmul.allow_tf32 = False
    n = shards.shape[1]
    out = torch.empty((rows, n), dtype=torch.uint8, device=dev)
    a = _bit_matrix(m.tobytes(), rows, cols, str(dev))
    k = torch.arange(8, dtype=torch.uint8, device=dev)
    j = torch.arange(8, dtype=torch.int32, device=dev)
    for s in range(0, n, PLAIN_CHUNK):
        xt = shards[:, s : s + PLAIN_CHUNK].T  # (w, cols)
        w = xt.shape[0]
        bits = ((xt.unsqueeze(-1) >> k) & 1).reshape(w, cols * 8)
        y = bits.to(torch.float32) @ a  # (w, rows*8), exact small integers
        ybits = (y.to(torch.int32) & 1).reshape(w, rows, 8)
        out[:, s : s + w] = (ybits << j).sum(-1).to(torch.uint8).T
    return out


_ARGTYPES = (
    ctypes.c_void_p,  # tables
    ctypes.c_int,  # rows
    ctypes.c_int,  # cols
    ctypes.c_void_p,  # x
    ctypes.c_longlong,  # x batch stride
    ctypes.c_longlong,  # x row stride
    ctypes.c_void_p,  # out
    ctypes.c_longlong,  # out row stride
    ctypes.c_longlong,  # n
    ctypes.c_longlong,  # batches
    ctypes.c_int,  # most blocks
    ctypes.c_void_p,  # stream
)


def _kernel():
    lib = _build.load(_build.GF256_MATMUL)
    fn = lib.gf256_matmul
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The device's streaming multiprocessors (132 on an H100 SXM), read
    once per device: the launch geometry of gf256_matmul and crc32c_batch."""
    return torch.cuda.get_device_properties(device).multi_processor_count


_count_lock = threading.Lock()


def gf256_matmul(matrix, x: torch.Tensor) -> torch.Tensor:
    """out[r] = XOR_c matrix[r,c] x x[c] through the CUDA kernel.

    x: (cols, n), or (batches, cols, n) read as the columns of its batches
    laid side by side, uint8 with unit stride along n (other strides are
    free, so a view into a larger buffer works). Returns (rows, batches*n)
    uint8 on x's device: row r holds batch 0's n outputs, then batch 1's...
    On cuda its rows are padded to 16 bytes, so it is a view when
    batches*n is not a multiple of 16.
    A CPU tensor goes through `gf_matmul_torch`."""
    m = check_matrix(matrix)
    rows, cols = m.shape
    if x.dtype != torch.uint8 or x.dim() not in (2, 3):
        raise ValueError(f"x must be 2-D or 3-D uint8, got {x.dim()}-D {x.dtype}")
    x3 = x.unsqueeze(0) if x.dim() == 2 else x
    batches, c, n = x3.shape
    if c != cols:
        raise ValueError(f"matrix has {cols} columns but x has {c} shards")
    if x.device.type == "cpu":
        return gf_matmul_torch(m, x3.permute(1, 0, 2).reshape(cols, batches * n))
    if x.device.type != "cuda":
        raise ValueError(f"gf256_matmul runs on cuda or cpu, not {x.device}")
    if n > 1 and x3.stride(2) != 1:
        raise ValueError("x needs unit stride along its last dimension")
    total = batches * n
    # rows padded to 16 bytes so every output row starts aligned for the
    # kernel's uint4 stores; the view returned is (rows, total)
    out = torch.empty((rows, -(-total // 16) * 16), dtype=torch.uint8, device=x.device)
    out = out[:, :total]
    if out.numel() == 0:
        return out
    tables = _device_tables(m.tobytes(), rows, cols, str(x.device))
    kernel = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = kernel(
            tables.data_ptr(), rows, cols,
            x3.data_ptr(), x3.stride(0), x3.stride(1),
            out.data_ptr(), out.stride(0), n, batches,
            sm_count(x.device) * BLOCKS_PER_SM, stream,
        )
    if rc != 0:
        raise RuntimeError(f"gf256_matmul kernel launch failed: CUDA error {rc}")
    with _count_lock:
        gf256_matmul.launches += 1
    return out


gf256_matmul.launches = 0  # kernel launches; tools reset it to 0 to count a run
