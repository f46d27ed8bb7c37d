"""Reed-Solomon RS(data, parity) codec on PyTorch: the port's counterpart of
`seaweedfs_tpu/ops/rs_kernel.py` (+ `rs_pallas.py`), with the same public
API.

A codec has one device, fixed at construction. On `cuda` every transform
launches the hand-written kernel (`rs_cuda.gf256_matmul`) or raises; on
`cpu` (which a caller must ask for) it runs the plain PyTorch version.
There is no backend pick, calibration or fallback. With no device given
and no CUDA present, construction raises.

The async API feeds the EC pipeline (storage/erasure_coding/encoder.py):
a batch in a pinned host buffer is copied to the card without blocking,
transformed, and its parity copied back into pinned memory, all on the
codec's own stream, followed by a CUDA event. `result()` waits on that
event and returns numpy, so it is safe from any thread.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import gf256
from .rs_cuda import check_matrix, gf256_matmul

DATA_SHARDS = 10
PARITY_SHARDS = 4
TOTAL_SHARDS = DATA_SHARDS + PARITY_SHARDS


def resolve_device(device=None) -> torch.device:
    """`cuda` when no device is given (raises if there is none), else the
    device asked for, which must be cuda or cpu."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain PyTorch path"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use cuda or cpu")
    return dev


def _as_tensor(a: np.ndarray) -> torch.Tensor:
    if not a.flags.writeable:  # torch.from_numpy wants writable memory
        a = a.copy()
    return torch.from_numpy(np.ascontiguousarray(a))


class RSCodec:
    """RS(data, parity) codec on one device (see module docstring)."""

    def __init__(
        self,
        data_shards: int = DATA_SHARDS,
        parity_shards: int = PARITY_SHARDS,
        device=None,
    ) -> None:
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self.device = resolve_device(device)
        self._stream = None
        self._stream_lock = threading.Lock()

    @property
    def is_cuda(self) -> bool:
        return self.device.type == "cuda"

    def host_buffer(self, nbytes: int) -> np.ndarray:
        """Host staging memory for this codec's batches: pinned page-locked
        memory (allocated once, viewed as numpy) on cuda, plain numpy on cpu."""
        if self.is_cuda:
            return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True).numpy()
        return np.empty(nbytes, dtype=np.uint8)

    # --- core ---------------------------------------------------------------
    def apply_matrix(self, matrix: np.ndarray, shards: np.ndarray) -> np.ndarray:
        """out[r] = XOR_c matrix[r,c] x shards[c] on this codec's device —
        the one transform encode, reconstruct and the partial-sum repair
        path all use."""
        return self._apply(check_matrix(matrix), np.ascontiguousarray(shards, dtype=np.uint8))

    def _apply(self, matrix: np.ndarray, shards: np.ndarray) -> np.ndarray:
        return self.apply2d_async(matrix, shards).result()

    def encode(self, data: np.ndarray) -> np.ndarray:
        """data: (data_shards, n) uint8 -> parity (parity_shards, n) uint8."""
        if data.shape[0] != self.data_shards:
            raise ValueError(f"expected {self.data_shards} data shards")
        m = gf256.parity_rows(self.data_shards, self.parity_shards)
        return self._apply(m, np.ascontiguousarray(data, dtype=np.uint8))

    def encode_all(self, data: np.ndarray) -> np.ndarray:
        """(data_shards, n) -> all (total, n) shards (data rows pass through)."""
        parity = self.encode(data)
        return np.concatenate([np.asarray(data, dtype=np.uint8), parity], axis=0)

    def reconstruct(
        self, shards: dict[int, np.ndarray], targets: list[int] | None = None
    ) -> dict[int, np.ndarray]:
        """Recover missing shards. shards: {shard_id: (n,) uint8} with at
        least data_shards present; targets default to all missing ids."""
        present = sorted(shards)
        if targets is None:
            targets = [i for i in range(self.total_shards) if i not in shards]
        if not targets:
            return {}
        m = gf256.decode_matrix(
            self.data_shards, self.parity_shards, tuple(present), tuple(targets)
        )
        use = present[: self.data_shards]
        stack = np.stack([np.asarray(shards[i], dtype=np.uint8) for i in use])
        out = self._apply(m, stack)
        return {t: out[i] for i, t in enumerate(targets)}

    def verify(self, shards: np.ndarray) -> bool:
        """shards: (total, n); recompute parity from data rows and compare."""
        parity = self.encode(shards[: self.data_shards])
        return bool(np.array_equal(parity, shards[self.data_shards :]))

    # --- async pipeline API --------------------------------------------------
    def apply2d_async(self, matrix: np.ndarray, data: np.ndarray):
        """data: C-contiguous (cols, n) uint8. Handle yields (rows, n)."""
        m = check_matrix(matrix)
        if not self.is_cuda:
            return _ReadyHandle(gf256_matmul(m, _as_tensor(data)).numpy())
        return self._submit(m, data, data.shape)

    def encode2d_async(self, data: np.ndarray):
        m = gf256.parity_rows(self.data_shards, self.parity_shards)
        return self.apply2d_async(m, data)

    def encode_rows_async(self, buf: np.ndarray, block: int, row_count: int):
        """buf: flat uint8 of row_count rows x (data_shards * block) bytes in
        .dat order. Handle yields parity (parity_shards, row_count*block)
        with row r's parity in columns [r*block, (r+1)*block) — exactly the
        bytes each parity shard file appends for those rows. The kernel
        reads the (row_count, data_shards, block) layout in place."""
        m = gf256.parity_rows(self.data_shards, self.parity_shards)
        shape = (row_count, self.data_shards, block)
        if not self.is_cuda:
            return _ReadyHandle(gf256_matmul(m, _as_tensor(buf).view(shape)).numpy())
        return self._submit(m, buf, shape)

    def _cuda_stream(self) -> torch.cuda.Stream:
        with self._stream_lock:
            if self._stream is None:
                self._stream = torch.cuda.Stream(device=self.device)
            return self._stream

    def _submit(self, m: np.ndarray, data: np.ndarray, shape) -> "_CudaHandle":
        """H2D (non-blocking from pinned memory) -> kernel -> D2H of the
        result into pinned memory -> event, all on the codec's stream. The
        caller must leave `data` untouched until result() returns."""
        src = _as_tensor(data)
        if not src.is_pinned():
            staged = torch.empty(src.shape, dtype=torch.uint8, pin_memory=True)
            staged.copy_(src)
            src = staged
        stream = self._cuda_stream()
        with torch.cuda.stream(stream):
            x = src.to(self.device, non_blocking=True).view(shape)
            out = gf256_matmul(m, x)
            host = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return _CudaHandle(event, host, (src, x, out))


class _ReadyHandle:
    def __init__(self, out: np.ndarray) -> None:
        self._out = out

    def result(self) -> np.ndarray:
        return self._out


class _CudaHandle:
    def __init__(self, event, host: torch.Tensor, keep) -> None:
        self._event = event
        self._host = host
        self._keep = keep  # source and device tensors live until the event

    def result(self) -> np.ndarray:
        self._event.synchronize()
        self._keep = None
        return self._host.numpy()
