"""Volume superblock: 8 bytes at the head of every .dat file
(`weed/storage/super_block/super_block.go:12-40`).

  byte 0    : needle version (1, 2 or 3)
  byte 1    : replica placement byte (xyz as decimal)
  bytes 2-3 : TTL (count, unit)
  bytes 4-5 : compaction revision (BE)
  bytes 6-7 : size of optional protobuf extra section (BE)
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .needle import CURRENT_VERSION
from .types import TTL, ReplicaPlacement, get_u16, put_u16

SUPER_BLOCK_SIZE = 8


@dataclass
class SuperBlock:
    version: int = CURRENT_VERSION
    replica_placement: ReplicaPlacement = field(default_factory=ReplicaPlacement)
    ttl: TTL = field(default_factory=TTL)
    compaction_revision: int = 0
    extra: bytes = b""

    def block_size(self) -> int:
        if self.version in (2, 3):
            return SUPER_BLOCK_SIZE + len(self.extra)
        return SUPER_BLOCK_SIZE

    def to_bytes(self) -> bytes:
        header = bytearray(SUPER_BLOCK_SIZE)
        header[0] = self.version
        header[1] = self.replica_placement.to_byte()
        header[2:4] = self.ttl.to_bytes()
        header[4:6] = put_u16(self.compaction_revision)
        if self.extra:
            if len(self.extra) > 256 * 256 - 2:
                raise ValueError("super block extra too large")
            header[6:8] = put_u16(len(self.extra))
            return bytes(header) + self.extra
        return bytes(header)

    @staticmethod
    def from_bytes(b: bytes) -> "SuperBlock":
        if len(b) < SUPER_BLOCK_SIZE:
            raise ValueError("super block truncated")
        sb = SuperBlock(
            version=b[0],
            replica_placement=ReplicaPlacement.from_byte(b[1]),
            ttl=TTL.from_bytes(b[2:4]),
            compaction_revision=get_u16(b, 4),
        )
        extra_size = get_u16(b, 6)
        if extra_size:
            sb.extra = bytes(b[SUPER_BLOCK_SIZE : SUPER_BLOCK_SIZE + extra_size])
        return sb
