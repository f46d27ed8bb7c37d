"""Batched CRC32C on the card: the port's counterpart of
`seaweedfs_tpu/ops/crc32c_kernel.py`.

CRC is affine over GF(2): for a fixed block length L,
    crc(block) = pack32( bits(block) @ M  mod 2 ) ^ crc(zeros(L))
where row (k*8 + j) of M is the 32-bit state contribution of bit j of byte
k. The host algebra below (`_byte_step_matrix`, `_block_matrix`,
`_power_matrix`, `crc32c_combine`) is a copy of the JAX module's.

`crc32c_batch_kernel` is the wrapper of the hand-written kernel
`csrc/crc32c_batch.cu` (it replaces the JAX device function
`crc32c_kernel.py::_compiled_batch`, a bit-matrix product on the MXU). The
kernel keeps the affine structure but not the bit form: one warp per blob,
each lane the register-only CRC of a 1/32 segment by slice-by-8 tables,
carried to the end of the blob by `A^(bytes after it)` (`_lane_columns`),
XOR-reduced across the warp, then XOR `crc(0^L)`. For a CUDA tensor the
wrapper launches the kernel or raises; for a tensor on the CPU it runs
`crc32c_batch_torch`, the plain version. Nothing else is chosen.

`crc32c_batch_torch` mirrors the JAX form: bits(n, 8L) @ M mod 2, the matmul
in float32 on 0/1 values with TF32 off. Each product sums at most 8 * SEGMENT
ones, exact below 2^24; a longer blob is split into SEGMENT-byte pieces whose
register-only CRCs are carried to the end by A^(bytes after the piece) and
XORed, so M is never built for more than SEGMENT bytes.

`crc32c_batch(blocks, device=None)` is the entry point: numpy in, numpy
out; a tensor in, a tensor out. With no device it runs on cuda, or raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from ..storage import crc as crc_cpu
from . import _build
from .rs_kernel import _as_tensor, resolve_device

# --- GF(2) 32-bit state algebra (host-side, numpy) ------------------------
_POLY = 0x82F63B78

# Bytes per piece of the plain version: 8 * SEGMENT bits per product stays
# below 2^24, where float32 sums of ones are exact.
SEGMENT = 1 << 16
# Elements of the plain version's float32 bits tensor per row chunk (256 MiB).
PLAIN_CHUNK_BITS = 1 << 26


def _u32_to_bits(v: int) -> np.ndarray:
    return np.array([(v >> i) & 1 for i in range(32)], dtype=np.uint8)


def _bits_to_u32(bits: np.ndarray) -> int:
    return int(sum(int(b) << i for i, b in enumerate(bits)))


@functools.lru_cache(maxsize=1)
def _byte_step_matrix() -> bytes:
    """A: state after processing one zero byte, as a (32, 32) GF(2) matrix
    acting on column bit-vectors (A[:, i] = step(e_i))."""
    a = np.zeros((32, 32), dtype=np.uint8)
    for i in range(32):
        r = 1 << i
        for _ in range(8):
            r = (r >> 1) ^ (_POLY if r & 1 else 0)
        a[:, i] = _u32_to_bits(r)
    return a.tobytes()


def _matmul2(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return ((x.astype(np.uint32) @ y.astype(np.uint32)) & 1).astype(np.uint8)


@functools.lru_cache(maxsize=32)
def _block_matrix(length: int) -> bytes:
    """M: (length*8, 32) — bit i of byte k contributes A^(L-k) e_i."""
    a = np.frombuffer(_byte_step_matrix(), dtype=np.uint8).reshape(32, 32)
    m = np.zeros((length * 8, 32), dtype=np.uint8)
    power = a.copy()
    for k in range(length - 1, -1, -1):
        m[k * 8 : k * 8 + 8, :] = power[:, :8].T  # columns 0..7 = embedded byte bits
        if k > 0:
            power = _matmul2(a, power)
    return m.tobytes()


@functools.lru_cache(maxsize=32)
def _zero_crc(length: int) -> int:
    return crc_cpu.crc32c(b"\x00" * length)


@functools.lru_cache(maxsize=64)
def _power_matrix(length: int) -> bytes:
    """A^length via square-and-multiply."""
    a = np.frombuffer(_byte_step_matrix(), dtype=np.uint8).reshape(32, 32)
    result = np.eye(32, dtype=np.uint8)
    base = a.copy()
    k = length
    while k:
        if k & 1:
            result = _matmul2(result, base)
        base = _matmul2(base, base)
        k >>= 1
    return result.tobytes()


def crc32c_combine(crc_a: int, crc_b: int, len_b: int) -> int:
    """crc(A||B) from crc(A), crc(B), len(B) — GF(2) matrix power.

    Derivation: R_{A||B} = A^Lb R_A ^ S_B and R_B = A^Lb init ^ S_B, so with
    crc = R ^ F and init == F the init/final xors cancel pairwise, leaving
    crc(A||B) = A^Lb * crc(A) ^ crc(B).
    """
    p = np.frombuffer(_power_matrix(len_b), dtype=np.uint8).reshape(32, 32)
    shifted = _bits_to_u32(_matmul2(p, _u32_to_bits(crc_a)))
    return shifted ^ crc_b


def _check_blocks(blocks: torch.Tensor) -> None:
    if blocks.dtype != torch.uint8 or blocks.dim() != 2:
        raise ValueError(
            f"blocks must be (n, L) uint8, got {tuple(blocks.shape)} {blocks.dtype}"
        )


def u32_tensor(values: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as a uint32 tensor (through int32 bits:
    uint32 has no arithmetic on every device)."""
    signed = torch.where(values >= 1 << 31, values - (1 << 32), values)
    return signed.to(torch.int32).view(torch.uint32)


# --- plain version ----------------------------------------------------------
@functools.lru_cache(maxsize=8)
def _float_block_matrix(length: int, device: str) -> torch.Tensor:
    m = np.frombuffer(_block_matrix(length), dtype=np.uint8).reshape(length * 8, 32)
    return torch.from_numpy(m.copy()).to(device, torch.float32)


@functools.lru_cache(maxsize=64)
def _float_power_matrix(length: int, device: str) -> torch.Tensor:
    """(A^length)^T as float32, so that row bits @ it = A^length applied."""
    p = np.frombuffer(_power_matrix(length), dtype=np.uint8).reshape(32, 32)
    return torch.from_numpy(p.T.copy()).to(device, torch.float32)


def crc32c_batch_torch(blocks: torch.Tensor) -> torch.Tensor:
    """Plain version. blocks: (n, L) uint8 on any device -> (n,) uint32."""
    _check_blocks(blocks)
    n, length = blocks.shape
    dev = blocks.device
    if dev.type == "cuda":
        # exact only in full float32: never let the matmul round through TF32
        torch.backends.cuda.matmul.allow_tf32 = False
    k = torch.arange(8, dtype=torch.uint8, device=dev)
    acc = torch.zeros((n, 32), dtype=torch.int32, device=dev)
    for s in range(0, length, SEGMENT):
        e = min(s + SEGMENT, length)
        m = _float_block_matrix(e - s, str(dev))
        carry = _float_power_matrix(length - e, str(dev)) if e < length else None
        rows = max(1, PLAIN_CHUNK_BITS // (8 * (e - s)))
        for r in range(0, n, rows):
            x = blocks[r : r + rows, s:e]
            bits = ((x.unsqueeze(-1) >> k) & 1).reshape(x.shape[0], 8 * (e - s))
            y = (bits.to(torch.float32) @ m).to(torch.int32) & 1  # register-only CRC bits
            if carry is not None:
                y = (y.to(torch.float32) @ carry).to(torch.int32) & 1
            acc[r : r + rows] ^= y
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    crc = (acc.to(torch.int64) << shifts).sum(1) ^ _zero_crc(length)
    return u32_tensor(crc)


# --- the kernel -------------------------------------------------------------
def _slice8_tables() -> np.ndarray:
    """(8, 256) uint32: table t advances a byte through t further zero
    bytes, as the host library's slice-by-8."""
    t = np.zeros((8, 256), dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if c & 1 else 0)
        t[0, i] = c
    for j in range(1, 8):
        t[j] = (t[j - 1] >> 8) ^ t[0, t[j - 1] & 0xFF]
    return t


def lane_segment(length: int) -> int:
    """Bytes per lane: ceil(L / 32) rounded up to 16, so every lane's
    segment starts 16-byte aligned within the blob."""
    per_lane = -(-length // 32)
    return max(16, -(-per_lane // 16) * 16)


@functools.lru_cache(maxsize=64)
def _lane_columns(length: int) -> np.ndarray:
    """(32 lanes, 32) uint32: column i of A^(bytes after lane's segment),
    which carries a lane's register-only CRC to the end of the blob. Lanes
    are walked from the last: each earlier lane's power is the next one's
    times A^seg."""
    seg = lane_segment(length)
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    step = np.frombuffer(_power_matrix(seg), dtype=np.uint8).reshape(32, 32)
    cols = np.zeros((32, 32), dtype=np.uint32)
    prev = 0  # bytes after the lane walked before
    for lane in range(31, -1, -1):
        after = length - min((lane + 1) * seg, length)
        if prev == 0:  # the lane holding the blob's end, or one past it
            p = np.frombuffer(_power_matrix(after), dtype=np.uint8).reshape(32, 32)
        else:  # a full lane: seg more bytes after it than after the next
            p = _matmul2(p, step)
        prev = after
        cols[lane] = (p.astype(np.uint64) * weights[:, None]).sum(0).astype(np.uint32)
    return cols


@functools.lru_cache(maxsize=8)
def _device_tables(device: str) -> torch.Tensor:
    return torch.from_numpy(_slice8_tables().view(np.int32)).to(device)


@functools.lru_cache(maxsize=64)
def _device_columns(length: int, device: str) -> torch.Tensor:
    return torch.from_numpy(_lane_columns(length).view(np.int32)).to(device)


_ARGTYPES = (
    ctypes.c_void_p,  # x
    ctypes.c_longlong,  # row stride
    ctypes.c_longlong,  # n
    ctypes.c_longlong,  # L
    ctypes.c_longlong,  # lane segment
    ctypes.c_void_p,  # slice-by-8 tables (8, 256) u32
    ctypes.c_void_p,  # lane columns (32, 32) u32
    ctypes.c_uint32,  # crc(0^L)
    ctypes.c_void_p,  # out (n,) u32
    ctypes.c_void_p,  # stream
)


def _kernel():
    fn = _build.load(_build.CRC32C_BATCH).crc32c_batch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


_count_lock = threading.Lock()


def crc32c_batch_kernel(blocks: torch.Tensor) -> torch.Tensor:
    """(n, L) uint8 with unit stride along L (any row stride) -> (n,)
    uint32 on blocks' device, through the CUDA kernel. A CPU tensor goes
    through `crc32c_batch_torch`."""
    _check_blocks(blocks)
    if blocks.device.type == "cpu":
        return crc32c_batch_torch(blocks)
    if blocks.device.type != "cuda":
        raise ValueError(f"crc32c_batch runs on cuda or cpu, not {blocks.device}")
    n, length = blocks.shape
    if length > 1 and blocks.stride(1) != 1:
        raise ValueError("blocks need unit stride along their last dimension")
    out = torch.empty(n, dtype=torch.int32, device=blocks.device)
    if n == 0 or length == 0:
        return out.zero_().view(torch.uint32)  # crc of no bytes is 0
    dev = str(blocks.device)
    tables = _device_tables(dev)
    cols = _device_columns(length, dev)
    kernel = _kernel()
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = kernel(
            blocks.data_ptr(), blocks.stride(0), n, length, lane_segment(length),
            tables.data_ptr(), cols.data_ptr(), _zero_crc(length), out.data_ptr(),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"crc32c_batch kernel launch failed: CUDA error {rc}")
    with _count_lock:
        crc32c_batch_kernel.launches += 1
    return out.view(torch.uint32)


crc32c_batch_kernel.launches = 0  # kernel launches; tools reset it to 0 to count a run


def crc32c_batch(blocks, device=None):
    """CRC32C of N equal-length blocks: (n, L) uint8 -> (n,) uint32 on
    `device` (cuda when None; raises without CUDA). A numpy array (or
    anything numpy takes) returns numpy; a tensor returns a tensor."""
    dev = resolve_device(device)
    if isinstance(blocks, torch.Tensor):
        return crc32c_batch_kernel(blocks.to(dev))
    out = crc32c_batch_kernel(_as_tensor(np.asarray(blocks, dtype=np.uint8)).to(dev))
    return out.cpu().numpy()
