"""Needle: one stored blob inside an append-only volume.

The port's copy of `seaweedfs_tpu/storage/needle.py`.

Bit-compatible with the reference's on-disk record
(`weed/storage/needle/needle.go:25-45`, `needle_write.go:14-107`,
`needle_read.go`):

  header   : cookie(4 BE) | id(8 BE) | size(4 BE)
  body v2+ : dataSize(4) | data | flags(1)
             [nameSize(1) name] [mimeSize(1) mime] [lastModified(5)]
             [ttl(2)] [pairsSize(2) pairs]
  trailer  : crc32c(4 BE raw) | appendAtNs(8 BE, v3 only) | zero padding to 8B

`size` counts only the body; the padding rule always adds 1..8 bytes so that
header+body+trailer is 8-byte aligned (`needle_read.go:PaddingLength`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from . import crc as crc32c_mod
from .types import (
    COOKIE_SIZE,
    DATA_SIZE_SIZE,
    NEEDLE_CHECKSUM_SIZE,
    NEEDLE_HEADER_SIZE,
    NEEDLE_ID_SIZE,
    NEEDLE_PADDING_SIZE,
    TIMESTAMP_SIZE,
    TTL,
    get_u16,
    get_u32,
    get_u64,
    put_u16,
    put_u32,
    put_u64,
    u32_to_size,
)

VERSION1 = 1
VERSION2 = 2
VERSION3 = 3
CURRENT_VERSION = VERSION3

FLAG_IS_COMPRESSED = 0x01
FLAG_HAS_NAME = 0x02
FLAG_HAS_MIME = 0x04
FLAG_HAS_LAST_MODIFIED = 0x08
FLAG_HAS_TTL = 0x10
FLAG_HAS_PAIRS = 0x20
FLAG_IS_CHUNK_MANIFEST = 0x80

LAST_MODIFIED_BYTES_LENGTH = 5
TTL_BYTES_LENGTH = 2

PAIR_NAME_PREFIX = "Seaweed-"


class CRCError(Exception):
    pass


class SizeMismatchError(Exception):
    pass


def padding_length(needle_size: int, version: int) -> int:
    if version == VERSION3:
        return NEEDLE_PADDING_SIZE - (
            (NEEDLE_HEADER_SIZE + needle_size + NEEDLE_CHECKSUM_SIZE + TIMESTAMP_SIZE)
            % NEEDLE_PADDING_SIZE
        )
    return NEEDLE_PADDING_SIZE - (
        (NEEDLE_HEADER_SIZE + needle_size + NEEDLE_CHECKSUM_SIZE) % NEEDLE_PADDING_SIZE
    )


def needle_body_length(needle_size: int, version: int) -> int:
    if version == VERSION3:
        return (
            needle_size
            + NEEDLE_CHECKSUM_SIZE
            + TIMESTAMP_SIZE
            + padding_length(needle_size, version)
        )
    return needle_size + NEEDLE_CHECKSUM_SIZE + padding_length(needle_size, version)


def get_actual_size(size: int, version: int) -> int:
    return NEEDLE_HEADER_SIZE + needle_body_length(size, version)


@dataclass
class Needle:
    cookie: int = 0
    id: int = 0
    size: int = 0  # body size (computed on encode)

    data: bytes = b""
    flags: int = 0
    name: bytes = b""
    mime: bytes = b""
    pairs: bytes = b""  # json-encoded extra name/value pairs
    last_modified: int = 0  # unix seconds, 5 bytes on disk
    ttl: TTL = field(default_factory=TTL)
    checksum: int = 0  # raw crc32c of data
    append_at_ns: int = 0  # v3 only

    # --- flags -------------------------------------------------------------
    def is_compressed(self) -> bool:
        return bool(self.flags & FLAG_IS_COMPRESSED)

    def set_is_compressed(self) -> None:
        self.flags |= FLAG_IS_COMPRESSED

    def has_name(self) -> bool:
        return bool(self.flags & FLAG_HAS_NAME)

    def set_has_name(self) -> None:
        self.flags |= FLAG_HAS_NAME

    def has_mime(self) -> bool:
        return bool(self.flags & FLAG_HAS_MIME)

    def set_has_mime(self) -> None:
        self.flags |= FLAG_HAS_MIME

    def has_last_modified(self) -> bool:
        return bool(self.flags & FLAG_HAS_LAST_MODIFIED)

    def set_has_last_modified(self) -> None:
        self.flags |= FLAG_HAS_LAST_MODIFIED

    def has_ttl(self) -> bool:
        return bool(self.flags & FLAG_HAS_TTL)

    def set_has_ttl(self) -> None:
        self.flags |= FLAG_HAS_TTL

    def has_pairs(self) -> bool:
        return bool(self.flags & FLAG_HAS_PAIRS)

    def set_has_pairs(self) -> None:
        self.flags |= FLAG_HAS_PAIRS

    def is_chunked_manifest(self) -> bool:
        return bool(self.flags & FLAG_IS_CHUNK_MANIFEST)

    def set_is_chunk_manifest(self) -> None:
        self.flags |= FLAG_IS_CHUNK_MANIFEST

    # --- size / layout ------------------------------------------------------
    def body_size(self, version: int) -> int:
        """The `Size` field: sum of body sections (`needle_write.go:44-62`)."""
        if version == VERSION1:
            return len(self.data)
        if not self.data:
            return 0
        size = DATA_SIZE_SIZE + len(self.data) + 1
        if self.has_name():
            size += 1 + min(len(self.name), 0xFF)
        if self.has_mime():
            size += 1 + len(self.mime)
        if self.has_last_modified():
            size += LAST_MODIFIED_BYTES_LENGTH
        if self.has_ttl():
            size += TTL_BYTES_LENGTH
        if self.has_pairs():
            size += 2 + len(self.pairs)
        return size

    def disk_size(self, version: int) -> int:
        return get_actual_size(self.body_size(version), version)

    def update_append_at_ns(self, volume_last_append_at_ns: int) -> None:
        self.append_at_ns = max(time.time_ns(), volume_last_append_at_ns + 1)

    # --- encode -------------------------------------------------------------
    def to_bytes(self, version: int = CURRENT_VERSION) -> bytes:
        """Serialize the full on-disk record (header..padding)."""
        self.checksum = crc32c_mod.crc32c(self.data)
        out = bytearray()
        if version == VERSION1:
            self.size = len(self.data)
            out += put_u32(self.cookie)
            out += put_u64(self.id)
            out += put_u32(self.size)
            out += self.data
            out += put_u32(self.checksum)
            out += bytes(padding_length(self.size, version))
            return bytes(out)
        if version not in (VERSION2, VERSION3):
            raise ValueError(f"unsupported needle version {version}")

        self.size = self.body_size(version)
        out += put_u32(self.cookie)
        out += put_u64(self.id)
        out += put_u32(self.size)
        if self.data:
            out += put_u32(len(self.data))
            out += self.data
            out += bytes([self.flags & 0xFF])
            if self.has_name():
                name = self.name[:0xFF]
                out += bytes([len(name)])
                out += name
            if self.has_mime():
                out += bytes([len(self.mime)])
                out += self.mime
            if self.has_last_modified():
                out += put_u64(self.last_modified)[8 - LAST_MODIFIED_BYTES_LENGTH :]
            if self.has_ttl():
                out += self.ttl.to_bytes()
            if self.has_pairs():
                out += put_u16(len(self.pairs))
                out += self.pairs
        out += put_u32(self.checksum)
        if version == VERSION3:
            out += put_u64(self.append_at_ns)
        out += bytes(padding_length(self.size, version))
        return bytes(out)

    # --- decode -------------------------------------------------------------
    def parse_header(self, b: bytes) -> None:
        self.cookie = get_u32(b, 0)
        self.id = get_u64(b, COOKIE_SIZE)
        self.size = u32_to_size(get_u32(b, COOKIE_SIZE + NEEDLE_ID_SIZE))

    def _read_body_v2(self, b: bytes) -> None:
        idx = 0
        n = len(b)
        if idx < n:
            data_size = get_u32(b, idx)
            idx += 4
            if data_size + idx > n:
                raise ValueError("needle data out of range")
            self.data = bytes(b[idx : idx + data_size])
            idx += data_size
        if idx < n:
            self.flags = b[idx]
            idx += 1
        if idx < n and self.has_name():
            name_size = b[idx]
            idx += 1
            if name_size + idx > n:
                raise ValueError("needle name out of range")
            self.name = bytes(b[idx : idx + name_size])
            idx += name_size
        if idx < n and self.has_mime():
            mime_size = b[idx]
            idx += 1
            if mime_size + idx > n:
                raise ValueError("needle mime out of range")
            self.mime = bytes(b[idx : idx + mime_size])
            idx += mime_size
        if idx < n and self.has_last_modified():
            if LAST_MODIFIED_BYTES_LENGTH + idx > n:
                raise ValueError("needle lastModified out of range")
            self.last_modified = int.from_bytes(
                b[idx : idx + LAST_MODIFIED_BYTES_LENGTH], "big"
            )
            idx += LAST_MODIFIED_BYTES_LENGTH
        if idx < n and self.has_ttl():
            if TTL_BYTES_LENGTH + idx > n:
                raise ValueError("needle ttl out of range")
            self.ttl = TTL.from_bytes(b[idx : idx + TTL_BYTES_LENGTH])
            idx += TTL_BYTES_LENGTH
        if idx < n and self.has_pairs():
            if 2 + idx > n:
                raise ValueError("needle pairs size out of range")
            pairs_size = get_u16(b, idx)
            idx += 2
            if pairs_size + idx > n:
                raise ValueError("needle pairs out of range")
            self.pairs = bytes(b[idx : idx + pairs_size])
            idx += pairs_size

    @staticmethod
    def from_bytes(
        blob: bytes, size: int | None = None, version: int = CURRENT_VERSION
    ) -> "Needle":
        """Hydrate from a full on-disk record, verifying size and CRC
        (`needle_read.go:ReadBytes`)."""
        n = Needle()
        n.parse_header(blob)
        if size is not None and n.size != size:
            raise SizeMismatchError(f"found size {n.size}, expected {size}")
        if version == VERSION1:
            n.data = bytes(blob[NEEDLE_HEADER_SIZE : NEEDLE_HEADER_SIZE + n.size])
        else:
            n._read_body_v2(blob[NEEDLE_HEADER_SIZE : NEEDLE_HEADER_SIZE + n.size])
        if n.size > 0:
            stored = get_u32(blob, NEEDLE_HEADER_SIZE + n.size)
            actual = crc32c_mod.crc32c(n.data)
            if stored != actual and stored != crc32c_mod.legacy_value(actual):
                raise CRCError("CRC error! Data On Disk Corrupted")
            n.checksum = actual
        if version == VERSION3:
            ts_off = NEEDLE_HEADER_SIZE + n.size + NEEDLE_CHECKSUM_SIZE
            n.append_at_ns = get_u64(blob, ts_off)
        return n

    def read_needle_body_bytes(self, body: bytes, version: int) -> None:
        """Hydrate from header-parsed state plus the body blob
        (`needle_read.go:ReadNeedleBodyBytes`)."""
        if not body:
            return
        if version == VERSION1:
            self.data = bytes(body[: self.size])
        else:
            self._read_body_v2(body[: self.size])
            if version == VERSION3:
                ts_off = self.size + NEEDLE_CHECKSUM_SIZE
                self.append_at_ns = get_u64(body, ts_off)
        self.checksum = crc32c_mod.crc32c(self.data)

    def etag(self) -> str:
        return put_u32(self.checksum).hex()

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"Needle(id={self.id:x}, cookie={self.cookie:x}, size={self.size}, "
            f"data={len(self.data)}B, name={self.name!r})"
        )
