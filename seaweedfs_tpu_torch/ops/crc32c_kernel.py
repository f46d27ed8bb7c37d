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
kernel keeps the affine structure but not the bit form: a blob is cut into
`crc_warps(n, L, sms)` spans, one warp each; lane j of a warp takes the 16-byte
pieces j, j + 32, ... of its span (coalesced loads) and advances its
register-only CRC by 512 bytes a piece with 16 tables (`_piece_tables`).
Lanes fold into their warp and warps into the blob by host-built columns
of A^e (`_fold_columns`, e may be negative), then XOR `crc(0^L)`. For a CUDA tensor the
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
from .rs_cuda import sm_count
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
# The kernel's layout: a blob is cut into `warps` spans of `span` bytes (a
# multiple of STRIDE; the last span may be short or empty). In a span, lane
# j takes the 16-byte pieces j, j + 32, j + 64, ..., so a warp's load is
# STRIDE contiguous bytes. A lane's register-only CRC advances by STRIDE
# bytes a piece: its piece, then the 496 bytes of the other lanes' pieces
# as zeros (`_piece_tables`). Lanes fold into their warp with the level-1
# columns (to the end of the warp's span), warps into the blob with the
# level-2 columns (to the end of the blob): `_fold_columns`.
PIECE = 16
STRIDE = 32 * PIECE
# warps per blob grow until the batch has WARPS_PER_SM warps for each of
# the device's SMs (`sms`, read by the wrapper) or a warp's span would fall
# under MIN_SPAN bytes
WARPS_PER_SM = 16
MIN_SPAN = 1024
# a block holds max(warps, BLOCK_WARPS) warps: whole blobs, so tables and
# columns are staged once for several small blobs
BLOCK_WARPS = 8
# threads a SM holds at once, whatever the block size: __launch_bounds__(1024)
# keeps registers at 64 a thread or fewer, and four blocks' 28.8 KB of shared
# memory fit; the grid is capped at the device's SMs times this
RESIDENT_THREADS = 1024


def _advance_tables(count: int) -> np.ndarray:
    """(count, 256) uint32: row m is the register-only CRC of byte v
    followed by m zero bytes. Rows 0-7 are the host library's slice-by-8."""
    t = np.zeros((count, 256), dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if c & 1 else 0)
        t[0, i] = c
    for j in range(1, count):
        t[j] = (t[j - 1] >> 8) ^ t[0, t[j - 1] & 0xFF]
    return t


@functools.lru_cache(maxsize=1)
def _piece_tables() -> np.ndarray:
    """(16, 256) uint32: table k advances byte k of a 16-byte piece through
    the rest of the piece and the STRIDE - PIECE zero bytes after it, so
    r' = XOR_k table[k][byte k of (piece ^ r)] moves a lane by STRIDE."""
    return _advance_tables(STRIDE)[STRIDE - 1 : STRIDE - 1 - PIECE : -1].copy()


def crc_warps(n: int, length: int, sms: int) -> int:
    """Warps per blob for a batch of n blobs of `length` bytes on a device
    of `sms` SMs: one, doubled up to 32 while the batch has fewer than
    sms x WARPS_PER_SM warps and each span keeps at least MIN_SPAN bytes."""
    warps = 1
    while warps < 32 and n * warps < sms * WARPS_PER_SM and length >= 2 * warps * MIN_SPAN:
        warps *= 2
    return warps


def crc_span(length: int, warps: int) -> int:
    """Bytes of each warp's span: length / warps rounded up to STRIDE."""
    return max(STRIDE, -(-length // (warps * STRIDE)) * STRIDE)


def crc_grid(n: int, warps: int, sms: int) -> tuple[int, int]:
    """(threads a block, blocks) of a launch over n blobs of `warps` warps
    on a device of `sms` SMs. Blocks loop over groups of whole blobs; the
    grid is capped at what the card holds at once, then cut to the fewest
    blocks that take the same number of rounds over the groups."""
    threads = 32 * max(warps, BLOCK_WARPS)
    groups = -(-n // (threads // 32 // warps))
    rounds = -(-groups // (sms * RESIDENT_THREADS // threads))
    return threads, -(-groups // rounds)


@functools.lru_cache(maxsize=1)
def _inverse_step_matrix() -> bytes:
    """A^-1 over GF(2), by Gauss-Jordan elimination: it carries a state
    back over a zero byte (A is invertible: the polynomial's x^0 term is 1)."""
    a = np.frombuffer(_byte_step_matrix(), dtype=np.uint8).reshape(32, 32)
    aug = np.concatenate([a.copy(), np.eye(32, dtype=np.uint8)], axis=1)
    for col in range(32):
        pivot = col + int(np.nonzero(aug[col:, col])[0][0])
        aug[[col, pivot]] = aug[[pivot, col]]
        for row in np.nonzero(aug[:, col])[0]:
            if row != col:
                aug[row] ^= aug[col]
    return aug[:, 32:].tobytes()


def _signed_power_matrix(e: int) -> np.ndarray:
    """A^e for any integer e: a negative power undoes zero bytes that a
    lane's last piece ran past the end of its span."""
    if e >= 0:
        return np.frombuffer(_power_matrix(e), dtype=np.uint8).reshape(32, 32)
    inv = np.frombuffer(_inverse_step_matrix(), dtype=np.uint8).reshape(32, 32)
    result = np.eye(32, dtype=np.uint8)
    k = -e
    while k:
        if k & 1:
            result = _matmul2(result, inv)
        inv = _matmul2(inv, inv)
        k >>= 1
    return result


def _columns(m: np.ndarray) -> np.ndarray:
    """(32,) uint32: column k of a GF(2) matrix, bit i = m[i, k]."""
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    return (m.astype(np.uint64) * weights[:, None]).sum(0).astype(np.uint32)


@functools.lru_cache(maxsize=1)
def _full_span_columns() -> np.ndarray:
    """(32, 32) uint32: lane j of a full span, A^-16j: its last piece's
    window runs 16j bytes past the span's end."""
    back = _signed_power_matrix(-PIECE)
    cols = np.zeros((32, 32), dtype=np.uint32)
    m = np.eye(32, dtype=np.uint8)
    for lane in range(32):
        cols[lane] = _columns(m)
        m = _matmul2(m, back)
    return cols


@functools.lru_cache(maxsize=64)
def _fold_columns(length: int, warps: int) -> np.ndarray:
    """(64 + warps, 32) uint32 columns of the kernel's two-level fold.
    Rows 0-31: lane j of a full span (`_full_span_columns`). Rows 32-63:
    lane j of the blob's last span, A^(L - end of its window), its window
    ending one STRIDE past the start of its last piece (a partial last
    piece is read with zeros past the blob's end); 0 for a lane with no
    piece. Rows 64 + w: warp w, A^(L - end of its span), 0 for an empty
    span. Each run of exponents steps by a constant, so the powers are
    walked one product at a time."""
    span = crc_span(length, warps)
    last = (length - 1) // span
    start = last * span
    pieces = -(-(length - start) // PIECE)
    cols = np.zeros((64 + warps, 32), dtype=np.uint32)
    cols[:32] = _full_span_columns()
    # a lane's last piece is one of the span's last 32; walk them backwards,
    # each window ending PIECE bytes earlier than the one after it
    step = _signed_power_matrix(PIECE)
    m = _signed_power_matrix(length - (start + (pieces - 1) * PIECE + STRIDE))
    for p in range(pieces - 1, max(pieces - 32, 0) - 1, -1):
        cols[32 + p % 32] = _columns(m)
        m = _matmul2(m, step)
    # the last span ends at L (last < warps, as warps * span >= L); each
    # earlier one ends a span before the next
    cols[64 + last] = _columns(np.eye(32, dtype=np.uint8))
    step = _signed_power_matrix(span)
    m = _signed_power_matrix(length - last * span)
    for w in range(last - 1, -1, -1):
        cols[64 + w] = _columns(m)
        m = _matmul2(m, step)
    return cols


@functools.lru_cache(maxsize=8)
def _device_tables(device: str) -> torch.Tensor:
    return torch.from_numpy(_piece_tables().view(np.int32)).to(device)


@functools.lru_cache(maxsize=64)
def _device_columns(length: int, warps: int, device: str) -> torch.Tensor:
    return torch.from_numpy(_fold_columns(length, warps).view(np.int32)).to(device)


_ARGTYPES = (
    ctypes.c_void_p,  # x
    ctypes.c_longlong,  # row stride
    ctypes.c_longlong,  # n
    ctypes.c_longlong,  # L
    ctypes.c_int,  # warps per blob
    ctypes.c_longlong,  # span bytes
    ctypes.c_int,  # threads a block
    ctypes.c_longlong,  # blocks
    ctypes.c_void_p,  # piece tables (16, 256) u32
    ctypes.c_void_p,  # fold columns (64 + warps, 32) u32
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
    sms = sm_count(blocks.device)
    warps = crc_warps(n, length, sms)
    threads, grid = crc_grid(n, warps, sms)
    tables = _device_tables(dev)
    cols = _device_columns(length, warps, dev)
    kernel = _kernel()
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = kernel(
            blocks.data_ptr(), blocks.stride(0), n, length, warps, crc_span(length, warps),
            threads, grid, tables.data_ptr(), cols.data_ptr(), _zero_crc(length),
            out.data_ptr(), stream,
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
