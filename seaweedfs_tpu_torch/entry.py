"""Entry point of the port: the counterpart of `__graft_entry__.entry`.

entry(device=None) -> (fn, example_args): the RS(10,4) parity step
(10, n) uint8 -> (4, n) uint8 through the GF(2^8) kernel (the ec.encode hot
loop, reference `weed/storage/erasure_coding/ec_encoder.go:202`), with the
reference's example: a (10, 256 KiB) block seeded with RandomState(0).

dryrun_multichip(n, device=None) -> the counterpart of
`__graft_entry__.dryrun_multichip`: a mesh of the first n devices (cuda;
raises with fewer, or without CUDA; `device="cpu"` gives n CPU slots), one
`pipeline_step` (sharded multi-volume EC encode + batched CRC32C + batched
MD5) on the reference's seeded shapes, volume 0's parity checked against
the CPU codec.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import gf256
from .ops.rs_cuda import gf256_matmul
from .ops.rs_kernel import DATA_SHARDS, PARITY_SHARDS, RSCodec, resolve_device
from .parallel import make_mesh, pipeline_step


def entry(device=None):
    dev = resolve_device(device)
    parity = gf256.parity_rows(DATA_SHARDS, PARITY_SHARDS)

    def rs_encode_step(shards: torch.Tensor) -> torch.Tensor:
        return gf256_matmul(parity, shards)

    example = np.random.RandomState(0).randint(
        0, 256, size=(DATA_SHARDS, 256 * 1024)
    ).astype(np.uint8)
    return rs_encode_step, (torch.from_numpy(example).to(dev),)


def dryrun_multichip(n_devices: int, device=None) -> None:
    mesh = make_mesh(n_devices, device=device)
    rng = np.random.RandomState(0)
    volumes = rng.randint(0, 256, size=(n_devices * 2, 10, 512)).astype(np.uint8)
    blobs = rng.randint(0, 256, size=(n_devices * 4, 512)).astype(np.uint8)

    parity, crcs, digests = pipeline_step(mesh, volumes, blobs)
    # cross-check one volume against the CPU codec
    want = RSCodec(device="cpu").encode(volumes[0])
    got = np.asarray(parity)[0]
    if not np.array_equal(got, want):
        raise AssertionError("multichip parity mismatch vs the CPU codec")
    print(
        f"dryrun_multichip({n_devices}): parity {parity.shape} over "
        f"{len(set(parity.devices))} devices, crc {crcs.shape}, "
        f"md5 {digests.shape} — OK"
    )
