"""Batched MD5 on the card: the port's counterpart of
`seaweedfs_tpu/ops/md5_kernel.py`. N independent blobs of one length are
hashed at once; RFC 1321, byte-identical to hashlib.

`md5_batch_kernel` is the wrapper of the hand-written kernel
`csrc/md5_batch.cu` (it replaces the JAX device function
`md5_kernel.py::_compiled_batch`): one thread per blob, a warp's 32 blobs
fed through a cp.async ring in shared memory so that no block waits on
memory, rounds unrolled, padding built in registers, no padded copy of the
blobs. For a CUDA tensor
the wrapper launches the kernel or raises; for a tensor on the CPU it runs
`md5_batch_torch`, the plain version. Nothing else is chosen.

`md5_batch_torch` mirrors the JAX lockstep: the pad is built on the host from
the static length, the padded message is read as little-endian words, and
64 unrolled rounds advance all N states per block, a Python loop over the
blocks taking the place of `lax.scan`. PyTorch has no uint32 arithmetic on
every op, so the words live in int64 and are masked to 32 bits after every
add and before every right shift.

`md5_batch(blobs, device=None)` is the entry point: numpy in, numpy out; a
tensor in, a tensor out. With no device it runs on cuda, or raises.
"""

from __future__ import annotations

import ctypes
import math
import threading

import numpy as np
import torch

from . import _build
from .rs_kernel import _as_tensor, resolve_device

_K = np.array(
    [int(abs(math.sin(i + 1)) * (1 << 32)) & 0xFFFFFFFF for i in range(64)],
    dtype=np.uint32,
)
_S = np.array(
    [7, 12, 17, 22] * 4 + [5, 9, 14, 20] * 4 + [4, 11, 16, 23] * 4 + [6, 10, 15, 21] * 4,
    dtype=np.int32,
)
_MASK = 0xFFFFFFFF
_INIT = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476)


def _pad_len(blob_len: int) -> int:
    """Total padded length: blob + 0x80 + zeros + 8-byte bit length."""
    return ((blob_len + 8) // 64 + 1) * 64


def _check_blobs(blobs: torch.Tensor) -> None:
    if blobs.dtype != torch.uint8 or blobs.dim() != 2:
        raise ValueError(
            f"blobs must be (n, L) uint8, got {tuple(blobs.shape)} {blobs.dtype}"
        )


def _message_index(i: int) -> int:
    if i < 16:
        return i
    if i < 32:
        return (5 * i + 1) % 16
    if i < 48:
        return (3 * i + 5) % 16
    return (7 * i) % 16


def md5_batch_torch(blobs: torch.Tensor) -> torch.Tensor:
    """Plain version. blobs: (n, L) uint8 on any device -> (n, 16) uint8."""
    _check_blobs(blobs)
    n, blob_len = blobs.shape
    dev = blobs.device
    padded = _pad_len(blob_len)
    n_blocks = padded // 64
    # the length trailer is computed on the host (blob_len is static)
    pad_host = np.zeros(padded - blob_len, dtype=np.uint8)
    pad_host[0] = 0x80
    pad_host[-8:] = np.frombuffer(np.uint64(blob_len * 8).tobytes(), dtype=np.uint8)
    pad = torch.from_numpy(pad_host).to(dev).expand(n, -1)
    msg = torch.cat([blobs, pad], dim=1)
    shifts = torch.arange(4, dtype=torch.int64, device=dev) * 8
    words = (msg.reshape(n, n_blocks, 16, 4).to(torch.int64) << shifts).sum(-1)

    a, b, c, d = (torch.full((n,), v, dtype=torch.int64, device=dev) for v in _INIT)
    for blk in range(n_blocks):
        m = words[:, blk]
        aa, bb, cc, dd = a, b, c, d
        for i in range(64):
            if i < 16:
                f = (bb & cc) | (~bb & dd)
            elif i < 32:
                f = (dd & bb) | (~dd & cc)
            elif i < 48:
                f = bb ^ cc ^ dd
            else:
                f = cc ^ (bb | ~dd)  # high bits set; the add's mask drops them
            s = int(_S[i])
            v = (aa + f + int(_K[i]) + m[:, _message_index(i)]) & _MASK
            aa, dd, cc = dd, cc, bb
            bb = (bb + ((v << s) | (v >> (32 - s)))) & _MASK
        a, b, c, d = (a + aa) & _MASK, (b + bb) & _MASK, (c + cc) & _MASK, (d + dd) & _MASK
    state = torch.stack([a, b, c, d], dim=1)  # (n, 4)
    return ((state.unsqueeze(-1) >> shifts) & 0xFF).to(torch.uint8).reshape(n, 16)


_ARGTYPES = (
    ctypes.c_void_p,  # x
    ctypes.c_longlong,  # row stride
    ctypes.c_longlong,  # n
    ctypes.c_longlong,  # L
    ctypes.c_void_p,  # out (n, 16) u8
    ctypes.c_void_p,  # stream
)


def _kernel():
    fn = _build.load(_build.MD5_BATCH).md5_batch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


_count_lock = threading.Lock()


def md5_batch_kernel(blobs: torch.Tensor) -> torch.Tensor:
    """(n, L) uint8 with unit stride along L (any row stride) -> (n, 16)
    uint8 digests on blobs' device, through the CUDA kernel. A CPU tensor
    goes through `md5_batch_torch`."""
    _check_blobs(blobs)
    if blobs.device.type == "cpu":
        return md5_batch_torch(blobs)
    if blobs.device.type != "cuda":
        raise ValueError(f"md5_batch runs on cuda or cpu, not {blobs.device}")
    n, blob_len = blobs.shape
    if blob_len > 1 and blobs.stride(1) != 1:
        raise ValueError("blobs need unit stride along their last dimension")
    out = torch.empty((n, 16), dtype=torch.uint8, device=blobs.device)
    if n == 0:
        return out
    kernel = _kernel()
    with torch.cuda.device(blobs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = kernel(blobs.data_ptr(), blobs.stride(0), n, blob_len, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"md5_batch kernel launch failed: CUDA error {rc}")
    with _count_lock:
        md5_batch_kernel.launches += 1
    return out


md5_batch_kernel.launches = 0  # kernel launches; tools reset it to 0 to count a run


def md5_batch(blobs, device=None):
    """MD5 digests of N equal-length blobs: (n, L) uint8 -> (n, 16) uint8 on
    `device` (cuda when None; raises without CUDA). A numpy array (or
    anything numpy takes) returns numpy; a tensor returns a tensor."""
    dev = resolve_device(device)
    if isinstance(blobs, torch.Tensor):
        return md5_batch_kernel(blobs.to(dev))
    out = md5_batch_kernel(_as_tensor(np.asarray(blobs, dtype=np.uint8)).to(dev))
    return out.cpu().numpy()
