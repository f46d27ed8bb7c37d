"""File ids: `<volumeId>,<needleIdHex><cookieHex8>` (`weed/storage/needle/file_id.go`).

The port's copy of `seaweedfs_tpu/storage/file_id.py`.

The needle-id hex has leading zero *bytes* stripped (pairs of hex digits, at
least the cookie's 8 hex digits always remain); an optional `_<delta>` suffix
adds to the needle id (used for chunked uploads).
"""

from __future__ import annotations

from dataclasses import dataclass

from .types import COOKIE_SIZE, NEEDLE_ID_SIZE, put_u32, put_u64


def format_needle_id_cookie(key: int, cookie: int) -> str:
    b = put_u64(key) + put_u32(cookie)
    nonzero = 0
    while nonzero < NEEDLE_ID_SIZE and b[nonzero] == 0:
        nonzero += 1
    return b[nonzero:].hex()


def parse_needle_id_cookie(key_hash: str) -> tuple[int, int]:
    if len(key_hash) <= COOKIE_SIZE * 2:
        raise ValueError("KeyHash is too short.")
    if len(key_hash) > (NEEDLE_ID_SIZE + COOKIE_SIZE) * 2:
        raise ValueError("KeyHash is too long.")
    split = len(key_hash) - COOKIE_SIZE * 2
    return int(key_hash[:split], 16), int(key_hash[split:], 16)


def parse_key_hash_with_delta(fid_part: str) -> tuple[int, int]:
    """Parse `<idhex><cookie>[_delta]` (`needle.go:ParsePath`)."""
    delta = 0
    if "_" in fid_part:
        fid_part, delta_s = fid_part.rsplit("_", 1)
        delta = int(delta_s)
    key, cookie = parse_needle_id_cookie(fid_part)
    return key + delta, cookie


@dataclass(frozen=True)
class FileId:
    volume_id: int
    key: int
    cookie: int

    @staticmethod
    def parse(fid: str) -> "FileId":
        comma = fid.find(",")
        if comma <= 0:
            raise ValueError(f"wrong fid format: {fid!r}")
        vid = int(fid[:comma])
        key, cookie = parse_key_hash_with_delta(fid[comma + 1 :])
        return FileId(vid, key, cookie)

    def __str__(self) -> str:
        return f"{self.volume_id},{format_needle_id_cookie(self.key, self.cookie)}"
