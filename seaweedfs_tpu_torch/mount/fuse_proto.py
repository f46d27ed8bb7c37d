"""FUSE lowlevel wire protocol: kernel struct framing.

The reference rides hanwen/go-fuse's raw loop (`weed/mount/weedfs.go`,
SURVEY.md §2.2 item 7 calls for direct /dev/fuse framing in this build —
no fuse library exists in the image). This module packs/unpacks the kernel
ABI structs (v7.31 layout for the ops we serve) so the same dispatcher
drives either a real `/dev/fuse` fd or the in-memory test transport.

Struct layouts follow include/uapi/linux/fuse.h.

The port's copy of `seaweedfs_tpu/mount/fuse_proto.py`.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

# opcodes (fuse.h enum fuse_opcode)
LOOKUP = 1
FORGET = 2
GETATTR = 3
SETATTR = 4
UNLINK = 10
LINK = 13
RMDIR = 11
RENAME = 12
OPEN = 14
READ = 15
WRITE = 16
STATFS = 17
RELEASE = 18
FSYNC = 20
FLUSH = 25
INIT = 26
OPENDIR = 27
READDIR = 28
RELEASEDIR = 29
ACCESS = 34
CREATE = 35
MKDIR = 9
MKNOD = 8
RENAME2 = 45

ERRNO_NOENT = 2
ERRNO_IO = 5
ERRNO_EXIST = 17
ERRNO_NOTDIR = 20
ERRNO_ISDIR = 21
ERRNO_INVAL = 22
ERRNO_NOTEMPTY = 39
ERRNO_NOSYS = 38
ERRNO_NOSPC = 28

IN_HEADER = struct.Struct("<IIQQIIII")  # len opcode unique nodeid uid gid pid pad
OUT_HEADER = struct.Struct("<IiQ")  # len error unique

S_IFDIR = 0o040000
S_IFREG = 0o100000


@dataclass
class InHeader:
    length: int
    opcode: int
    unique: int
    nodeid: int
    uid: int
    gid: int
    pid: int


def parse_in(buf: bytes) -> tuple[InHeader, bytes]:
    length, opcode, unique, nodeid, uid, gid, pid, _ = IN_HEADER.unpack_from(buf)
    return (
        InHeader(length, opcode, unique, nodeid, uid, gid, pid),
        buf[IN_HEADER.size:length],
    )


def pack_request(opcode: int, unique: int, nodeid: int, payload: bytes = b"",
                 uid: int = 0, gid: int = 0, pid: int = 0) -> bytes:
    """Build a kernel→daemon request (used by the virtual transport/tests)."""
    total = IN_HEADER.size + len(payload)
    return IN_HEADER.pack(total, opcode, unique, nodeid, uid, gid, pid, 0) \
        + payload


def reply(unique: int, payload: bytes = b"", error: int = 0) -> bytes:
    return OUT_HEADER.pack(OUT_HEADER.size + len(payload),
                           -error, unique) + payload


def parse_reply(buf: bytes) -> tuple[int, int, bytes]:
    """(unique, -errno, payload)"""
    length, error, unique = OUT_HEADER.unpack_from(buf)
    return unique, error, buf[OUT_HEADER.size:length]


# --- attr / entry ------------------------------------------------------------
ATTR = struct.Struct("<QQQQQQIIIIIIIIII")  # 88 bytes (v7.9+)


def pack_attr(ino: int, size: int, mode: int, nlink: int = 1,
              uid: int = 0, gid: int = 0, mtime: float = 0.0,
              ctime: float = 0.0) -> bytes:
    blocks = (size + 511) // 512
    mt = int(mtime)
    mtn = int((mtime - mt) * 1e9)
    ct = int(ctime)
    ctn = int((ctime - ct) * 1e9)
    return ATTR.pack(
        ino, size, blocks,
        mt, mt, ct,  # atime mtime ctime (secs)
        mtn, mtn, ctn,  # nsecs
        mode, nlink, uid, gid, 0,  # rdev
        4096, 0,  # blksize padding
    )


def unpack_attr(buf: bytes) -> dict:
    (ino, size, blocks, atime, mtime, ctime, atn, mtn, ctn, mode, nlink,
     uid, gid, rdev, blksize, _) = ATTR.unpack_from(buf)
    return {"ino": ino, "size": size, "mode": mode, "nlink": nlink,
            "uid": uid, "gid": gid, "mtime": mtime + mtn / 1e9}


ENTRY_OUT_HEAD = struct.Struct("<QQQQII")  # nodeid gen entry_valid attr_valid + nsecs


def pack_entry_out(nodeid: int, attr: bytes, entry_valid: float = 1.0,
                   attr_valid: float = 1.0) -> bytes:
    ev, av = int(entry_valid), int(attr_valid)
    return ENTRY_OUT_HEAD.pack(
        nodeid, 0, ev, av,
        int((entry_valid - ev) * 1e9), int((attr_valid - av) * 1e9),
    ) + attr


def unpack_entry_out(buf: bytes) -> tuple[int, dict]:
    nodeid = struct.unpack_from("<Q", buf)[0]
    return nodeid, unpack_attr(buf[ENTRY_OUT_HEAD.size:])


ATTR_OUT_HEAD = struct.Struct("<QII")  # attr_valid, nsec, dummy


def pack_attr_out(attr: bytes, valid: float = 1.0) -> bytes:
    v = int(valid)
    return ATTR_OUT_HEAD.pack(v, int((valid - v) * 1e9), 0) + attr


def unpack_attr_out(buf: bytes) -> dict:
    return unpack_attr(buf[ATTR_OUT_HEAD.size:])


OPEN_OUT = struct.Struct("<QII")  # fh open_flags padding


def pack_open_out(fh: int, flags: int = 0) -> bytes:
    return OPEN_OUT.pack(fh, flags, 0)


def unpack_open_out(buf: bytes) -> int:
    return OPEN_OUT.unpack_from(buf)[0]


WRITE_OUT = struct.Struct("<II")


READ_IN = struct.Struct("<QQIIQII")  # fh offset size read_flags lock_owner flags pad
WRITE_IN = READ_IN  # same layout (write_flags in place of read_flags)
FLUSH_IN = struct.Struct("<QIIQ")  # fh unused padding lock_owner (24 bytes)
RELEASE_IN = struct.Struct("<QIIQ")  # fh flags release_flags lock_owner
FSYNC_IN = struct.Struct("<QII")  # fh fsync_flags padding (16 bytes)

INIT_IN = struct.Struct("<IIII")  # major minor max_readahead flags
INIT_OUT = struct.Struct("<IIIIHHIIHH32x")  # through map_alignment + unused

CREATE_IN = struct.Struct("<IIII")  # flags mode umask padding
MKDIR_IN = struct.Struct("<II")  # mode umask
RENAME_IN = struct.Struct("<Q")  # newdir
RENAME2_IN = struct.Struct("<QII")  # newdir flags padding
SETATTR_IN = struct.Struct("<IIQQQQQQIIIIIIII")  # 88 bytes (fuse_setattr_in)

FATTR_SIZE = 1 << 3
FATTR_MTIME = 1 << 5

DIRENT_HEAD = struct.Struct("<QQII")  # ino off namelen type


def pack_dirent(ino: int, off: int, name: bytes, dtype: int) -> bytes:
    entry = DIRENT_HEAD.pack(ino, off, len(name), dtype) + name
    pad = (8 - len(entry) % 8) % 8
    return entry + b"\0" * pad


def unpack_dirents(buf: bytes) -> list[tuple[int, str, int]]:
    """[(ino, name, dtype)]"""
    out = []
    pos = 0
    while pos + DIRENT_HEAD.size <= len(buf):
        ino, off, namelen, dtype = DIRENT_HEAD.unpack_from(buf, pos)
        name = buf[pos + DIRENT_HEAD.size: pos + DIRENT_HEAD.size + namelen]
        out.append((ino, name.decode(), dtype))
        entry_len = DIRENT_HEAD.size + namelen
        pos += entry_len + (8 - entry_len % 8) % 8
    return out


STATFS_OUT = struct.Struct("<QQQQQIIII28x")  # fuse_kstatfs


def pack_statfs(blocks=1 << 30, bfree=1 << 29, bavail=1 << 29,
                files=1 << 20, ffree=1 << 19) -> bytes:
    return STATFS_OUT.pack(blocks, bfree, bavail, files, ffree,
                           4096, 255, 4096, 0)
