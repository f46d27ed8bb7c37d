"""Entry point of the port: the counterpart of `__graft_entry__.entry`.

entry(device=None) -> (fn, example_args): the RS(10,4) parity step
(10, n) uint8 -> (4, n) uint8 through the GF(2^8) kernel (the ec.encode hot
loop, reference `weed/storage/erasure_coding/ec_encoder.go:202`), with the
reference's example: a (10, 256 KiB) block seeded with RandomState(0).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import gf256
from .ops.rs_cuda import gf256_matmul
from .ops.rs_kernel import DATA_SHARDS, PARITY_SHARDS, resolve_device


def entry(device=None):
    dev = resolve_device(device)
    parity = gf256.parity_rows(DATA_SHARDS, PARITY_SHARDS)

    def rs_encode_step(shards: torch.Tensor) -> torch.Tensor:
        return gf256_matmul(parity, shards)

    example = np.random.RandomState(0).randint(
        0, 256, size=(DATA_SHARDS, 256 * 1024)
    ).astype(np.uint8)
    return rs_encode_step, (torch.from_numpy(example).to(dev),)
