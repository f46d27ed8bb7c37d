"""Entry model (reference: `weed/filer/entry.go:32`, `weed/pb/filer.proto`).
The port's copy of `seaweedfs_tpu/filer/entry.py`."""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class FileChunk:
    """One stored chunk of a file (filer_pb.FileChunk)."""

    file_id: str  # "<vid>,<key><cookie>"
    offset: int  # logical offset in the file
    size: int
    modified_ts_ns: int = 0
    etag: str = ""
    is_chunk_manifest: bool = False
    cipher_key: str = ""  # base64 AES-256 key; empty = plaintext
    is_compressed: bool = False

    def to_dict(self) -> dict:
        d = {
            "file_id": self.file_id,
            "offset": self.offset,
            "size": self.size,
            "modified_ts_ns": self.modified_ts_ns,
            "etag": self.etag,
            "is_chunk_manifest": self.is_chunk_manifest,
        }
        if self.cipher_key:
            d["cipher_key"] = self.cipher_key
        if self.is_compressed:
            d["is_compressed"] = True
        return d

    @staticmethod
    def from_dict(d: dict) -> "FileChunk":
        return FileChunk(
            file_id=d["file_id"],
            offset=int(d["offset"]),
            size=int(d["size"]),
            modified_ts_ns=int(d.get("modified_ts_ns", 0)),
            etag=d.get("etag", ""),
            is_chunk_manifest=bool(d.get("is_chunk_manifest", False)),
            cipher_key=d.get("cipher_key", ""),
            is_compressed=bool(d.get("is_compressed", False)),
        )


@dataclass
class Attributes:
    mtime: float = field(default_factory=time.time)
    crtime: float = field(default_factory=time.time)
    mode: int = 0o644
    uid: int = 0
    gid: int = 0
    mime: str = ""
    ttl_sec: int = 0
    md5: str = ""  # hex of whole-file md5
    file_size: int = 0

    def to_dict(self) -> dict:
        return self.__dict__.copy()

    @staticmethod
    def from_dict(d: dict) -> "Attributes":
        a = Attributes()
        for k, v in d.items():
            if hasattr(a, k):
                setattr(a, k, v)
        return a


@dataclass
class Entry:
    full_path: str  # always absolute, no trailing slash (except root "/")
    is_directory: bool = False
    attributes: Attributes = field(default_factory=Attributes)
    chunks: list[FileChunk] = field(default_factory=list)
    extended: dict[str, str] = field(default_factory=dict)
    hard_link_id: str = ""  # hex id; shared metadata lives in the KV store
    hard_link_counter: int = 0  # nlink (reference entry.go HardLinkCounter)
    content: bytes = b""  # small-file inlining

    @property
    def name(self) -> str:
        return self.full_path.rsplit("/", 1)[-1] or "/"

    @property
    def parent(self) -> str:
        if self.full_path == "/":
            return "/"
        p = self.full_path.rsplit("/", 1)[0]
        return p or "/"

    def size(self) -> int:
        if self.content:
            return len(self.content)
        if self.attributes.file_size:
            return self.attributes.file_size
        return max((c.offset + c.size for c in self.chunks), default=0)

    def to_dict(self) -> dict:
        return {
            "full_path": self.full_path,
            "is_directory": self.is_directory,
            "attributes": self.attributes.to_dict(),
            "chunks": [c.to_dict() for c in self.chunks],
            "extended": self.extended,
            "hard_link_id": self.hard_link_id,
            "hard_link_counter": self.hard_link_counter,
            "content": self.content.hex() if self.content else "",
        }

    @staticmethod
    def from_dict(d: dict) -> "Entry":
        return Entry(
            full_path=d["full_path"],
            is_directory=bool(d.get("is_directory", False)),
            attributes=Attributes.from_dict(d.get("attributes", {})),
            chunks=[FileChunk.from_dict(c) for c in d.get("chunks", [])],
            extended=d.get("extended", {}) or {},
            hard_link_id=d.get("hard_link_id", ""),
            hard_link_counter=int(d.get("hard_link_counter", 0)),
            content=bytes.fromhex(d["content"]) if d.get("content") else b"",
        )
