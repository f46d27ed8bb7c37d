"""Multi-device storage kernels: multi-volume EC encode and batch hashing.

The port's counterpart of `seaweedfs_tpu/parallel/ec_shard_map.py`, which
maps BASELINE.json config 5 ("multi-volume ec.encode, pmap across pod")
onto `shard_map` over a mesh's `dp` axis (`_encode_fn` :59, `_crc_fn` :96,
`_md5_fn` :125). Here the batch's first dimension is split into d equal
slices, one a device of the mesh, and each device copies its slice to
itself on a CUDA stream of its own and makes one launch of the existing
kernel:

  sharded_encode   rs_cuda.gf256_matmul over its (V/d, 10, n) volumes
  sharded_crc32c   crc32c_batch_kernel over its (N/d, L) blocks
  sharded_md5      md5_batch_kernel over its (N/d, L) blobs

There is no cross-device data (parity is per volume, a hash per blob), so
there are no collectives and no process group: one process drives every
device, as the JAX version is one program with no cross-chip traffic. A
first dimension that d does not divide raises `ValueError`, as `shard_map`
does.

The result keeps one output a device, as the JAX result is a sharded
array: `Sharded.shards` (one tensor a device, on it), `.devices`,
`.shape`, and `np.asarray(result)`, which gathers the shards in order.

Each launch runs with its own device current and on its device's stream
(the kernels' table caches are keyed by the device string); nothing here
reads `torch.cuda.current_device()`. The device's current stream waits for
the side stream before the result is handed back. On a mesh of CPU slots
(`make_mesh(n, device="cpu")`) each slice runs the wrappers' plain
versions, which is how the tests hold the split against the JAX package.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..ops import gf256
from ..ops.crc32c_kernel import crc32c_batch_kernel
from ..ops.md5_kernel import md5_batch_kernel
from ..ops.rs_cuda import gf256_matmul
from ..ops.rs_kernel import DATA_SHARDS, PARITY_SHARDS, _as_tensor
from .mesh import Mesh


class Sharded:
    """A batch result kept as one tensor a device, in mesh order."""

    def __init__(self, shards: list[torch.Tensor], devices: tuple[torch.device, ...]) -> None:
        self.shards = tuple(shards)
        self.devices = tuple(devices)

    @property
    def shape(self) -> tuple[int, ...]:
        first = self.shards[0].shape
        return (sum(s.shape[0] for s in self.shards), *first[1:])

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        out = np.concatenate([s.cpu().numpy() for s in self.shards])
        return out if dtype is None else out.astype(dtype)


_streams: dict[torch.device, torch.cuda.Stream] = {}
_streams_lock = threading.Lock()


def _stream(dev: torch.device) -> torch.cuda.Stream:
    with _streams_lock:
        s = _streams.get(dev)
        if s is None:
            s = _streams[dev] = torch.cuda.Stream(device=dev)
        return s


def _uint8(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.uint8:
            raise ValueError(f"expected uint8, got {x.dtype}")
        return x
    return _as_tensor(np.asarray(x, dtype=np.uint8))


def _per_device(mesh: Mesh, x: torch.Tensor, fn, what: str) -> Sharded:
    """fn(slice on its device) once a device of the mesh, over equal slices
    of x's first dimension; on cuda each slice's copy and launch run on the
    device's own stream, with the device current."""
    d = mesh.size
    if x.shape[0] % d:
        raise ValueError(
            f"{what}: first dimension {x.shape[0]} is not divisible by the"
            f" mesh's {d} devices"
        )
    step = x.shape[0] // d
    outs = []
    for i, dev in enumerate(mesh.devices):
        part = x[i * step : (i + 1) * step]
        if dev.type == "cpu":
            outs.append(fn(part.cpu()))
            continue
        stream = _stream(dev)
        if part.device.type == "cuda":  # made on its device's current stream
            stream.wait_stream(torch.cuda.current_stream(part.device))
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            y = fn(part.to(dev, non_blocking=True))
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_stream(stream)
        y.record_stream(consumer)
        outs.append(y)
    return Sharded(outs, mesh.devices)


_PARITY = gf256.parity_rows(DATA_SHARDS, PARITY_SHARDS)


def _encode(vols: torch.Tensor) -> torch.Tensor:
    """(b, 10, n) on one device -> (b, 4, n) parity, one launch. The kernel
    returns (4, b*n), batch 0's n bytes first, then batch 1's."""
    b, _, n = vols.shape
    out = gf256_matmul(_PARITY, vols)
    return out.reshape(PARITY_SHARDS, b, n).permute(1, 0, 2).contiguous()


def sharded_encode(mesh: Mesh, volumes) -> Sharded:
    """volumes: (V, 10, n) uint8, V divisible by the mesh's size. Returns
    (V, 4, n) parity, each device encoding V/d volumes."""
    x = _uint8(volumes)
    if x.dim() != 3 or x.shape[1] != DATA_SHARDS:
        raise ValueError(f"volumes must be (V, {DATA_SHARDS}, n), got {tuple(x.shape)}")
    return _per_device(mesh, x, _encode, "sharded_encode")


def _check_2d(x: torch.Tensor, what: str) -> torch.Tensor:
    if x.dim() != 2:
        raise ValueError(f"{what} must be (N, L), got {tuple(x.shape)}")
    return x


def sharded_crc32c(mesh: Mesh, blocks) -> Sharded:
    """blocks: (N, L) uint8, N divisible by the mesh's size -> (N,) uint32."""
    x = _check_2d(_uint8(blocks), "blocks")
    return _per_device(mesh, x, crc32c_batch_kernel, "sharded_crc32c")


def sharded_md5(mesh: Mesh, blobs) -> Sharded:
    """blobs: (N, L) uint8, N divisible by the mesh's size -> (N, 16) uint8."""
    x = _check_2d(_uint8(blobs), "blobs")
    return _per_device(mesh, x, md5_batch_kernel, "sharded_md5")


def pipeline_step(mesh: Mesh, volumes, blobs) -> tuple[Sharded, Sharded, Sharded]:
    """One data-plane step over the mesh: encode a volume batch AND hash a
    blob batch (CRC32C + MD5), each split over the devices."""
    parity = sharded_encode(mesh, volumes)
    crcs = sharded_crc32c(mesh, blobs)
    digests = sharded_md5(mesh, blobs)
    return parity, crcs, digests
