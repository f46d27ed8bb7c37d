"""GF(2^8) arithmetic and Reed-Solomon matrix construction (numpy).

Field: polynomial x^8+x^4+x^3+x^2+1 (0x11D), generator 2 — the same field the
reference's klauspost/reedsolomon library uses (Backblaze tables), so the
RS(10,4) code words here are byte-identical to the reference's shards
(`weed/storage/erasure_coding/ec_encoder.go:202` uses `reedsolomon.New(10, 4)`
whose default matrix is Vandermonde normalized by the inverse of its top
square, making the data rows the identity).

Everything here is host-side setup math (tiny matrices); the per-byte work
runs in ops.rs_cuda (the CUDA kernel, or its plain PyTorch version).
Kept as the port's own copy of `seaweedfs_tpu/ops/gf256.py`.
"""

from __future__ import annotations

import functools

import numpy as np

POLY = 0x11D

# --- tables ---------------------------------------------------------------
_exp = np.zeros(512, dtype=np.uint8)
_log = np.zeros(256, dtype=np.int32)
_x = 1
for _i in range(255):
    _exp[_i] = _x
    _log[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= POLY
_exp[255:510] = _exp[:255]
EXP_TABLE = _exp
LOG_TABLE = _log


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(EXP_TABLE[int(LOG_TABLE[a]) + int(LOG_TABLE[b])])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(2^8) division by zero")
    if a == 0:
        return 0
    return int(EXP_TABLE[(int(LOG_TABLE[a]) - int(LOG_TABLE[b])) % 255])


def gf_exp(a: int, n: int) -> int:
    """a ** n in the field (klauspost galExp semantics: 0**0 == 1)."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP_TABLE[(int(LOG_TABLE[a]) * n) % 255])


@functools.lru_cache(maxsize=None)
def _mul_table() -> np.ndarray:
    """256x256 multiplication table."""
    a = np.arange(256)
    la = LOG_TABLE[a][:, None]
    lb = LOG_TABLE[a][None, :]
    t = EXP_TABLE[(la + lb) % 255].astype(np.uint8)
    t[0, :] = 0
    t[:, 0] = 0
    return t


def mul_table() -> np.ndarray:
    return _mul_table()


# --- matrices (small, dtype uint8) ----------------------------------------
def identity(n: int) -> np.ndarray:
    return np.eye(n, dtype=np.uint8)


def vandermonde(rows: int, cols: int) -> np.ndarray:
    """vm[r][c] = r ** c in the field (klauspost `vandermonde`)."""
    m = np.zeros((rows, cols), dtype=np.uint8)
    for r in range(rows):
        for c in range(cols):
            m[r, c] = gf_exp(r, c)
    return m


def mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product for small matrices."""
    t = _mul_table()
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for i in range(a.shape[0]):
        for j in range(b.shape[1]):
            acc = 0
            for k in range(a.shape[1]):
                acc ^= int(t[a[i, k], b[k, j]])
            out[i, j] = acc
    return out


def mat_invert(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion over GF(2^8). Raises if singular."""
    n = m.shape[0]
    if m.shape[1] != n:
        raise ValueError("matrix must be square")
    t = _mul_table()
    work = np.concatenate([m.astype(np.uint8), identity(n)], axis=1)
    for col in range(n):
        pivot = None
        for r in range(col, n):
            if work[r, col] != 0:
                pivot = r
                break
        if pivot is None:
            raise np.linalg.LinAlgError("matrix is singular")
        if pivot != col:
            work[[col, pivot]] = work[[pivot, col]]
        inv_p = gf_div(1, int(work[col, col]))
        work[col] = t[inv_p, work[col]]
        for r in range(n):
            if r != col and work[r, col] != 0:
                factor = int(work[r, col])
                work[r] ^= t[factor, work[col]]
    return work[:, n:].copy()


@functools.lru_cache(maxsize=None)
def rs_matrix(data_shards: int, parity_shards: int) -> np.ndarray:
    """The (total x data) encoding matrix with identity top — klauspost
    `buildMatrix`: vandermonde(total, data) @ inverse(top square)."""
    total = data_shards + parity_shards
    vm = vandermonde(total, data_shards)
    top_inv = mat_invert(vm[:data_shards])
    m = mat_mul(vm, top_inv)
    assert np.array_equal(m[:data_shards], identity(data_shards))
    return m


def parity_rows(data_shards: int, parity_shards: int) -> np.ndarray:
    """(parity x data) coefficient matrix."""
    return rs_matrix(data_shards, parity_shards)[data_shards:].copy()


@functools.lru_cache(maxsize=256)
def decode_matrix(
    data_shards: int, parity_shards: int, present: tuple[int, ...], targets: tuple[int, ...]
) -> np.ndarray:
    """Rows that recompute `targets` shards from the first `data_shards` of
    `present` (must have >= data_shards present; uses exactly data_shards).

    Matches klauspost Reconstruct: invert the sub-matrix of encoding rows for
    the surviving shards, then for each missing data shard take the inverse
    row, and for each missing parity shard re-encode via parity row x inverse.
    """
    if len(present) < data_shards:
        raise ValueError(
            f"need at least {data_shards} shards, have {len(present)}"
        )
    use = sorted(present)[:data_shards]
    enc = rs_matrix(data_shards, parity_shards)
    sub = enc[use]  # (data x data)
    inv = mat_invert(sub)
    rows = []
    for t in targets:
        if t < data_shards:
            rows.append(inv[t])
        else:
            rows.append(mat_mul(enc[t : t + 1], inv)[0])
    return np.stack(rows).astype(np.uint8)


# --- bulk numpy codec (reference implementation for tests/fallback) --------
def gf_matmul_bytes(matrix: np.ndarray, shards: np.ndarray) -> np.ndarray:
    """out[r] = XOR_c matrix[r,c] * shards[c] over the field.

    shards: (cols, n) uint8; returns (rows, n) uint8. Pure numpy via the
    256x256 table — the bit-exact oracle for the TPU and C++ paths.
    """
    t = _mul_table()
    rows, cols = matrix.shape
    assert shards.shape[0] == cols
    out = np.zeros((rows, shards.shape[1]), dtype=np.uint8)
    for r in range(rows):
        acc = out[r]
        for c in range(cols):
            coef = int(matrix[r, c])
            if coef == 0:
                continue
            if coef == 1:
                acc ^= shards[c]
            else:
                acc ^= t[coef][shards[c]]
    return out


def bit_matrix(matrix: np.ndarray) -> np.ndarray:
    """Expand a GF(2^8) coefficient matrix (R, C) into its GF(2) bit-plane
    matrix (C*8, R*8): output bit j of row r = XOR over (c,k) of
    input bit k of shard c times bit j of (matrix[r,c] * 2^k).

    This is what turns GF(2^8) shard math into a plain mod-2 integer matmul
    that the TPU MXU can run (SURVEY.md §7 step 3).
    """
    rows, cols = matrix.shape
    a = np.zeros((cols * 8, rows * 8), dtype=np.uint8)
    for r in range(rows):
        for c in range(cols):
            coef = int(matrix[r, c])
            if coef == 0:
                continue
            for k in range(8):
                prod = gf_mul(coef, 1 << k)
                for j in range(8):
                    a[c * 8 + k, r * 8 + j] = (prod >> j) & 1
    return a
