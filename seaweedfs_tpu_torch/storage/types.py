"""Core scalar types and sizes for the volume storage engine.

Mirrors the semantics of the reference implementation's type layer
(`weed/storage/types/needle_types.go:34-41`, `offset_4bytes.go:14-17`,
`needle_id_type.go`): 4-byte cookies, 8-byte needle ids, 4-byte sizes
(signed, -1 == tombstone), and offsets counted in units of 8 bytes.

The port's copy of `seaweedfs_tpu/storage/types.py`. Offset width is the
reference's build-tag choice made a process-wide environment switch, as in
the JAX package: default 4 bytes (32GB volumes, `offset_4bytes.go:14-17`);
set SEAWEEDFS_TPU_OFFSET_BYTES=5 before import for the 5-byte variant
(`offset_5bytes.go:15`: 4 BE low bytes + 1 high byte, 8TB volumes, 17-byte
.idx entries). Like a build tag it cannot change at runtime: every module
snapshots these constants at import.
"""

from __future__ import annotations

import os as _os
import struct
from dataclasses import dataclass

# --- sizes (bytes) ---------------------------------------------------------
COOKIE_SIZE = 4
NEEDLE_ID_SIZE = 8
SIZE_SIZE = 4
OFFSET_BYTES = int(_os.environ.get("SEAWEEDFS_TPU_OFFSET_BYTES", "4"))
if OFFSET_BYTES not in (4, 5):  # pragma: no cover - config error
    raise ValueError("SEAWEEDFS_TPU_OFFSET_BYTES must be 4 or 5")
OFFSET_SIZE = OFFSET_BYTES
NEEDLE_HEADER_SIZE = COOKIE_SIZE + NEEDLE_ID_SIZE + SIZE_SIZE  # 16
NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE  # 16 or 17
TIMESTAMP_SIZE = 8
NEEDLE_PADDING_SIZE = 8
NEEDLE_CHECKSUM_SIZE = 4
DATA_SIZE_SIZE = 4

TOMBSTONE_FILE_SIZE = -1  # Size(-1): deletion marker in .idx / .ecx
NEEDLE_ID_EMPTY = 0

# offsets in units of NEEDLE_PADDING_SIZE: 4 bytes => 32GB max volume,
# 5 bytes => 8TB (reference `offset_5bytes.go:17`)
MAX_POSSIBLE_VOLUME_SIZE = (1 << (8 * OFFSET_BYTES)) * NEEDLE_PADDING_SIZE


# --- size semantics --------------------------------------------------------
def size_is_deleted(size: int) -> bool:
    return size < 0 or size == TOMBSTONE_FILE_SIZE


def size_is_valid(size: int) -> bool:
    return size > 0 and size != TOMBSTONE_FILE_SIZE


def size_to_u32(size: int) -> int:
    """Two's-complement view used when writing the signed Size as uint32."""
    return size & 0xFFFFFFFF


def u32_to_size(v: int) -> int:
    return v - (1 << 32) if v >= (1 << 31) else v


# --- big-endian helpers ----------------------------------------------------
def put_u64(v: int) -> bytes:
    return struct.pack(">Q", v & 0xFFFFFFFFFFFFFFFF)


def put_u32(v: int) -> bytes:
    return struct.pack(">I", v & 0xFFFFFFFF)


def put_u16(v: int) -> bytes:
    return struct.pack(">H", v & 0xFFFF)


def get_u64(b: bytes, off: int = 0) -> int:
    return struct.unpack_from(">Q", b, off)[0]


def get_u32(b: bytes, off: int = 0) -> int:
    return struct.unpack_from(">I", b, off)[0]


def get_u16(b: bytes, off: int = 0) -> int:
    return struct.unpack_from(">H", b, off)[0]


# --- offsets ---------------------------------------------------------------
def offset_to_bytes(actual_offset: int) -> bytes:
    """Serialize a byte offset (must be 8-byte aligned) as OFFSET_SIZE bytes
    of 8-byte units: 4 BE bytes, plus the high byte appended in 5-byte mode
    (reference `offset_5bytes.go:19-26`)."""
    units = actual_offset // NEEDLE_PADDING_SIZE
    if OFFSET_BYTES == 4:
        return put_u32(units)
    return put_u32(units & 0xFFFFFFFF) + bytes([(units >> 32) & 0xFF])


def offset_from_bytes(b: bytes, off: int = 0) -> int:
    """Parse OFFSET_SIZE bytes of 8-byte units into an actual byte offset."""
    units = get_u32(b, off)
    if OFFSET_BYTES == 5:
        units += b[off + 4] << 32
    return units * NEEDLE_PADDING_SIZE


# --- TTL -------------------------------------------------------------------
_TTL_UNITS = {  # stored byte -> (suffix, minutes multiplier)
    0: ("", 0),
    1: ("m", 1),
    2: ("h", 60),
    3: ("d", 60 * 24),
    4: ("w", 60 * 24 * 7),
    5: ("M", 60 * 24 * 30),
    6: ("y", 60 * 24 * 365),
}
_TTL_SUFFIX = {"m": 1, "h": 2, "d": 3, "w": 4, "M": 5, "y": 6}


@dataclass(frozen=True)
class TTL:
    """2-byte TTL: count + unit (`weed/storage/needle/volume_ttl.go`)."""

    count: int = 0
    unit: int = 0

    @staticmethod
    def parse(s: str) -> "TTL":
        if not s:
            return TTL()
        if s[-1].isdigit():
            return TTL(count=int(s), unit=_TTL_SUFFIX["m"])
        return TTL(count=int(s[:-1]), unit=_TTL_SUFFIX[s[-1]])

    @staticmethod
    def from_bytes(b: bytes) -> "TTL":
        if b[0] == 0 and b[1] == 0:
            return TTL()
        return TTL(count=b[0], unit=b[1])

    @staticmethod
    def from_u32(v: int) -> "TTL":
        return TTL.from_bytes(bytes([(v >> 8) & 0xFF, v & 0xFF]))

    def to_bytes(self) -> bytes:
        return bytes([self.count & 0xFF, self.unit & 0xFF])

    def to_u32(self) -> int:
        if self.count == 0:
            return 0
        return (self.count << 8) | self.unit

    def minutes(self) -> int:
        return self.count * _TTL_UNITS.get(self.unit, ("", 0))[1]

    def __str__(self) -> str:
        if self.count == 0 or self.unit == 0:
            return ""
        return f"{self.count}{_TTL_UNITS[self.unit][0]}"


EMPTY_TTL = TTL()

# --- replica placement -----------------------------------------------------
@dataclass(frozen=True)
class ReplicaPlacement:
    """xyz replica code (`weed/storage/super_block/replica_placement.go:8-56`).

    x = replicas in other data centers, y = replicas in other racks of the
    same DC, z = replicas on other servers of the same rack.
    """

    diff_data_center_count: int = 0
    diff_rack_count: int = 0
    same_rack_count: int = 0

    @staticmethod
    def parse(t: str) -> "ReplicaPlacement":
        vals = [0, 0, 0]
        for i, c in enumerate(t[:3]):
            n = ord(c) - ord("0")
            if not 0 <= n <= 2:
                raise ValueError(f"unknown replication type {t!r}")
            vals[i] = n
        return ReplicaPlacement(*vals)

    @staticmethod
    def from_byte(b: int) -> "ReplicaPlacement":
        return ReplicaPlacement.parse(f"{b:03d}")

    def to_byte(self) -> int:
        return (
            self.diff_data_center_count * 100
            + self.diff_rack_count * 10
            + self.same_rack_count
        )

    def __str__(self) -> str:
        return (
            f"{self.diff_data_center_count}"
            f"{self.diff_rack_count}{self.same_rack_count}"
        )

    def copy_count(self) -> int:
        return (
            self.diff_data_center_count + self.diff_rack_count + self.same_rack_count + 1
        )
