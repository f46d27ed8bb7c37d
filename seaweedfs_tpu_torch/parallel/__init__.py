"""Multi-device execution: device meshes and the storage kernels split over
them. The port's counterpart of `seaweedfs_tpu/parallel/`: volume and blob
batches split along their first dimension over the mesh's devices, each
device launching the existing kernel on its own slice (no collectives;
parity is per volume, a hash per blob)."""

from .ec_shard_map import (
    pipeline_step,
    sharded_crc32c,
    sharded_encode,
    sharded_md5,
)
from .mesh import make_mesh

__all__ = [
    "make_mesh",
    "sharded_encode",
    "sharded_crc32c",
    "sharded_md5",
    "pipeline_step",
]
