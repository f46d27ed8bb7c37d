"""Core scalar types and sizes for the volume storage engine.

Mirrors the semantics of the reference implementation's type layer
(`weed/storage/types/needle_types.go:34-41`, `offset_4bytes.go:14-17`,
`needle_id_type.go`): 4-byte cookies, 8-byte needle ids, 4-byte sizes
(signed, -1 == tombstone), and offsets counted in units of 8 bytes.

The port's copy of `seaweedfs_tpu/storage/types.py`, with 4-byte offsets
only (32GB volumes, `offset_4bytes.go:14-17`). Not ported: the JAX
package's 5-byte offset variant (an import-time environment switch there).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

# --- sizes (bytes) ---------------------------------------------------------
COOKIE_SIZE = 4
NEEDLE_ID_SIZE = 8
SIZE_SIZE = 4
OFFSET_SIZE = 4
NEEDLE_HEADER_SIZE = COOKIE_SIZE + NEEDLE_ID_SIZE + SIZE_SIZE  # 16
NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE  # 16
TIMESTAMP_SIZE = 8
NEEDLE_PADDING_SIZE = 8
NEEDLE_CHECKSUM_SIZE = 4
DATA_SIZE_SIZE = 4

TOMBSTONE_FILE_SIZE = -1  # Size(-1): deletion marker in .idx / .ecx


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
    """Serialize a byte offset (must be 8-byte aligned) as 4 BE bytes of
    8-byte units."""
    return put_u32(actual_offset // NEEDLE_PADDING_SIZE)


def offset_from_bytes(b: bytes, off: int = 0) -> int:
    """Parse 4 BE bytes of 8-byte units into an actual byte offset."""
    return get_u32(b, off) * NEEDLE_PADDING_SIZE


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
