"""Device mesh: the port's counterpart of `seaweedfs_tpu/parallel/mesh.py`.

A `Mesh` is an ordered tuple of `torch.device`s along one named axis. The
storage kernels shard only the batch dimension (volumes, blobs), so one
`dp` axis is enough, as in the JAX package.

On cuda the mesh takes the first n CUDA devices and raises `ValueError`
when there are fewer. With `device="cpu"` it holds n CPU slots
(`cpu:0` .. `cpu:n-1`, all the host's memory), which is how the tests
rehearse several devices on a machine with none; a cuda mesh never
stands CPU slots in for missing cards.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.rs_kernel import resolve_device


@dataclass(frozen=True)
class Mesh:
    devices: tuple[torch.device, ...]
    axis: str = "dp"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, axis: str = "dp", device=None) -> Mesh:
    """1-D mesh over the first n devices (default: all CUDA devices, or one
    CPU slot). `device` is cuda (the default; raises without CUDA) or cpu."""
    kind = resolve_device(device).type
    if kind == "cpu":
        n = 1 if n_devices is None else n_devices
        if n < 1:
            raise ValueError(f"requested {n} devices")
        return Mesh(tuple(torch.device("cpu", i) for i in range(n)), axis)
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    if n < 1:
        raise ValueError(f"requested {n} devices")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)
