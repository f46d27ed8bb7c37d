"""Content-defined chunking (CDC) on the card: the port's counterpart of
`seaweedfs_tpu/ops/cdc.py`.

The XOR-gear window hash

    h_i = XOR_{k=0}^{W-1} ( G[b_{i-k}] << k )      (W = 32, uint32)

depends only on a bounded window, so every position's hash is computable
independently. Boundaries are where (h & mask) == 0; min/max chunk bounds are
enforced by the host cut rule (`cut_points`, copied unchanged) over the
sparse candidate set. The mask and the candidates' `nonzero` run on the
device, so only candidate positions cross the link.

`gear_hash_kernel` is the wrapper of the hand-written kernel
`csrc/gear_hash.cu` (it replaces the JAX device function
`cdc.py::_compiled_hashes`), which runs the equal recurrence
h_i = (h_{i-1} << 1) ^ G[b_i] over runs of 32 positions with a 31-byte
warm-up. For a CUDA tensor the wrapper launches the kernel or raises; for a
tensor on the CPU it runs `gear_hashes_torch`, the plain version, which
keeps the window form (32 shifted XORs), so the two derive the result
differently and check each other. `gear_hashes_numpy` is the oracle.

Entry points `gear_hashes`, `find_boundaries` and `chunk_stream` take
`device=None`: cuda, or raise without CUDA. The JAX module's 1 MiB length
buckets only avoided recompiles; the kernel takes n and masks its tail.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from . import _build
from .crc32c_kernel import u32_tensor
from .rs_kernel import _as_tensor, resolve_device

WINDOW = 32

# deterministic gear table (fixed seed so fingerprints are stable across runs)
_GEAR = np.random.RandomState(0x5EAEED).randint(0, 1 << 32, size=256).astype(np.uint32)


def gear_hashes_numpy(data: np.ndarray) -> np.ndarray:
    """(n,) uint32 — h_i for every position i (positions < WINDOW-1 use the
    partial prefix window). The oracle."""
    g = _GEAR[data]
    acc = np.zeros(len(data), dtype=np.uint32)
    for k in range(WINDOW):
        shifted = np.zeros_like(acc)
        if k == 0:
            shifted = g
        else:
            shifted[k:] = g[:-k]
        acc ^= shifted << np.uint32(k)
    return acc


@functools.lru_cache(maxsize=8)
def _gear_tensor(device: str, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.int32:
        return torch.from_numpy(_GEAR.view(np.int32)).to(device)
    return torch.from_numpy(_GEAR.astype(np.int64)).to(device)


def _check_data(data: torch.Tensor) -> None:
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise ValueError(f"data must be (n,) uint8, got {tuple(data.shape)} {data.dtype}")


def gear_hashes_torch(data: torch.Tensor) -> torch.Tensor:
    """Plain version, the window form. data: (n,) uint8 on any device ->
    (n,) uint32."""
    _check_data(data)
    g = _gear_tensor(str(data.device), torch.int64)[data.long()]
    acc = g.clone()
    for k in range(1, WINDOW):
        acc[k:] ^= g[:-k] << k
    return u32_tensor(acc & 0xFFFFFFFF)


_ARGTYPES = (
    ctypes.c_void_p,  # data
    ctypes.c_longlong,  # n
    ctypes.c_void_p,  # gear table (256,) u32
    ctypes.c_void_p,  # out (n,) u32
    ctypes.c_void_p,  # stream
)


def _kernel():
    fn = _build.load(_build.GEAR_HASH).gear_hash
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


_count_lock = threading.Lock()


def gear_hash_kernel(data: torch.Tensor) -> torch.Tensor:
    """(n,) uint8 with unit stride -> (n,) uint32 gear hashes on data's
    device, through the CUDA kernel. A CPU tensor goes through
    `gear_hashes_torch`."""
    _check_data(data)
    if data.device.type == "cpu":
        return gear_hashes_torch(data)
    if data.device.type != "cuda":
        raise ValueError(f"gear_hash runs on cuda or cpu, not {data.device}")
    n = data.shape[0]
    if n > 1 and data.stride(0) != 1:
        raise ValueError("data needs unit stride")
    out = torch.empty(n, dtype=torch.int32, device=data.device)
    if n == 0:
        return out.view(torch.uint32)
    gear = _gear_tensor(str(data.device), torch.int32)
    kernel = _kernel()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = kernel(data.data_ptr(), n, gear.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"gear_hash kernel launch failed: CUDA error {rc}")
    with _count_lock:
        gear_hash_kernel.launches += 1
    return out.view(torch.uint32)


gear_hash_kernel.launches = 0  # kernel launches; tools reset it to 0 to count a run


def _to_device(data, device) -> torch.Tensor:
    dev = resolve_device(device)
    if isinstance(data, torch.Tensor):
        return data.to(dev)
    if isinstance(data, (bytes, bytearray, memoryview)):
        a = np.frombuffer(data, dtype=np.uint8)
    else:
        a = np.asarray(data, dtype=np.uint8).reshape(-1)
    return _as_tensor(a).to(dev)


def gear_hashes(data, device=None):
    """(n,) uint8 -> (n,) uint32 gear hashes on `device` (cuda when None;
    raises without CUDA). numpy in, numpy out; a tensor in, a tensor out."""
    h = gear_hash_kernel(_to_device(data, device))
    return h if isinstance(data, torch.Tensor) else h.cpu().numpy()


def candidates(hashes: torch.Tensor, avg_bits: int) -> np.ndarray:
    """Positions where (h & mask) == 0, computed on the hashes' device; only
    the positions come back to the host (int64 numpy, ascending)."""
    mask = (1 << avg_bits) - 1
    mask32 = mask - (1 << 32) if mask >= 1 << 31 else mask  # the same bits as int32
    hit = (hashes.view(torch.int32) & mask32) == 0
    return torch.nonzero(hit).flatten().cpu().numpy()


def cut_points(cands: np.ndarray, n: int, min_size: int, max_size: int) -> list[int]:
    """The host cut rule: the first candidate at least min_size past the
    last cut and before max_size, else a forced cut at max_size (or n).
    Cut positions are exclusive ends; the last is n."""
    cuts: list[int] = []
    cur = 0
    while cur < n:
        lo = cur + min_size
        hi = min(cur + max_size, n)
        ci = int(np.searchsorted(cands, lo))
        if ci < len(cands) and cands[ci] < hi:
            cut = int(cands[ci]) + 1  # boundary after position i
        else:
            cut = hi
        cuts.append(cut)
        cur = cut
    return cuts


def find_boundaries(
    data,
    avg_bits: int = 13,
    min_size: int = 2048,
    max_size: int = 65536,
    device=None,
) -> list[int]:
    """Cut positions (exclusive ends) for one buffer. avg_bits=13 targets ~8KB
    mean chunks. Always ends with len(data)."""
    t = _to_device(data, device)
    n = t.shape[0]
    if n == 0:
        return []
    return cut_points(candidates(gear_hash_kernel(t), avg_bits), n, min_size, max_size)


def chunk_stream(
    read_fn,
    avg_bits: int = 13,
    min_size: int = 2048,
    max_size: int = 65536,
    segment: int = 8 * 1024 * 1024,
    device=None,
):
    """Yield (offset, length) chunks from a streaming reader. The unchunked
    tail of each segment is carried into the next round (and the final,
    provisional cut of a non-EOF segment is re-chunked with more data), so
    boundaries are identical to chunking the whole stream at once."""
    device = resolve_device(device)
    buf = b""
    base = 0
    eof = False
    target = segment
    while not eof or buf:
        while not eof and len(buf) < target:
            piece = read_fn(target - len(buf))
            if not piece:
                eof = True
                break
            buf += piece
        if not buf:
            return
        data = np.frombuffer(buf, dtype=np.uint8)
        cuts = find_boundaries(
            data, avg_bits=avg_bits, min_size=min_size, max_size=max_size,
            device=device,
        )
        if not eof:
            cuts = cuts[:-1]  # last cut may move once more data arrives
            if not cuts:
                target += segment  # buffer too small for a final cut yet
                continue
        target = segment
        prev = 0
        for c in cuts:
            yield (base + prev, c - prev)
            prev = c
        base += prev
        buf = buf[prev:]
        if eof and not buf:
            return
