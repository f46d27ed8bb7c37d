""".idx file entries: 16 bytes = key(8 BE) | offset(4 BE, 8B units) | size(4 BE).

The port's copy of `seaweedfs_tpu/storage/idx.py`, after
`weed/storage/idx/walk.go`. An offset of 0 with size 0 is an
unwritten slot; size == -1 (tombstone) marks deletion; in some historical
deletes the offset is kept.
"""

from __future__ import annotations

from typing import Iterator

from .types import (
    NEEDLE_ID_SIZE,
    NEEDLE_MAP_ENTRY_SIZE,
    OFFSET_SIZE,
    get_u32,
    get_u64,
    offset_from_bytes,
    offset_to_bytes,
    put_u32,
    put_u64,
    size_to_u32,
    u32_to_size,
)


def entry_to_bytes(key: int, offset: int, size: int) -> bytes:
    """offset is the actual byte offset (must be 8-aligned); size is signed."""
    return put_u64(key) + offset_to_bytes(offset) + put_u32(size_to_u32(size))


def entry_from_bytes(b: bytes, off: int = 0) -> tuple[int, int, int]:
    key = get_u64(b, off)
    offset = offset_from_bytes(b, off + NEEDLE_ID_SIZE)
    size = u32_to_size(get_u32(b, off + NEEDLE_ID_SIZE + OFFSET_SIZE))
    return key, offset, size


def walk_index_blob(data: bytes) -> Iterator[tuple[int, int, int]]:
    for off in range(0, len(data) - NEEDLE_MAP_ENTRY_SIZE + 1, NEEDLE_MAP_ENTRY_SIZE):
        yield entry_from_bytes(data, off)


def walk_index_file(path: str) -> Iterator[tuple[int, int, int]]:
    """Iterate the entries of an .idx file."""
    with open(path, "rb") as fp:
        data = fp.read()
    return walk_index_blob(data)
