"""Carry state across from the JAX package.

The system has no weights: what the two packages share is the GF(2^8)
coefficient matrices and the volume bytes (shared on disk as files).
"""

from __future__ import annotations

import numpy as np

from .ops.rs_cuda import check_matrix, packed_tables


def from_reference_matrix(np_matrix) -> np.ndarray:
    """A (rows, cols) uint8 matrix produced by the JAX package's `gf256`
    (or any numpy array of that shape), ready for the port's codec and
    `gf256_matmul`: validated, C-contiguous, with its kernel tables built
    and cached."""
    m = check_matrix(np_matrix)
    packed_tables(m)
    return m
