"""WFS: the mount's filesystem logic over the FUSE wire protocol.

Behavioral port of `weed/mount/weedfs.go` + `weedfs_file_write.go:37` +
`weedfs_file_read.go` + `weedfs_file_sync.go`: inode↔path map, meta cache
with subscription invalidation, chunked page-writer pipeline on the write
path (sealed chunks upload asynchronously; FLUSH/FSYNC commits the entry),
visible-interval reads with a tiered chunk cache and readback of unflushed
dirty pages.

`WFS.handle(request_bytes) -> reply_bytes | None` serves one kernel
request; `serve(fd)` loops over a real /dev/fuse fd, and the test
transport calls `handle` directly with packed structs (same bytes either
way).

The port's copy of `seaweedfs_tpu/mount/weedfs.py`, over the port's
`FilerClient`, `WeedClient` and `TieredChunkCache`. `filer_url` may be a
filer's `unix_url` (its `-filer.localSocket`). Sealed chunks go straight to
the volume servers (`WeedClient.upload`), as in the JAX package, so the
mount itself launches no kernel.
"""

from __future__ import annotations

import stat as stat_mod
import threading
import time

from ..filer.entry import FileChunk
from ..filer.filechunks import read_resolved_chunks, view_from_visibles
from ..filer.filer_client import FilerClient
from ..filer.wdclient import WeedClient
from ..server.httpd import get_json
from ..util.chunk_cache import TieredChunkCache

from . import fuse_proto as fp
from .meta_cache import MetaCache
from .page_writer import UploadPipeline


def struct_unpack_fh(payload: bytes) -> tuple[int]:
    """Leading u64 fh shared by flush/release/fsync/releasedir structs."""
    import struct

    return struct.unpack_from("<Q", payload)


class FileHandle:
    def __init__(self, fh: int, path: str, wfs: "WFS") -> None:
        self.fh = fh
        self.path = path
        self.pipeline = UploadPipeline(
            wfs._upload_chunk_data, chunk_size=wfs.chunk_size
        )
        self.size_hint = 0
        self.dirty = False


class WFS:
    def __init__(self, filer_url: str, chunk_size: int | None = None,
                 read_only: bool = False,
                 chunk_cache_dir: str | None = None,
                 quota_mb: int = 0) -> None:
        self.fc = FilerClient(filer_url)
        self.meta = MetaCache(filer_url)
        info = get_json(filer_url.rstrip("/") + "/__meta__/info")
        self.weed = WeedClient(info["master"])
        self.chunk_size = chunk_size or int(info.get("chunk_size") or 4 << 20)
        self.read_only = read_only
        self.chunk_cache = TieredChunkCache(disk_dir=chunk_cache_dir)

        self._ino_to_path: dict[int, str] = {1: "/"}
        self._path_to_ino: dict[str, int] = {"/": 1}
        self._next_ino = 2
        self._handles: dict[int, FileHandle] = {}
        self._next_fh = 1
        self._resolved_memo: tuple | None = None  # (entry, visibles, chunk end)
        self._lock = threading.Lock()
        # mount quota (`weed/mount/weedfs_quota.go` semantics): writes
        # fail ENOSPC once the mounted namespace's usage exceeds it, and
        # statfs advertises it as the filesystem size. 0 = unlimited;
        # adjustable at runtime via mount.configure (set_quota). Usage is
        # refreshed by a BACKGROUND ticker, like the reference — a walk
        # inside the single-threaded FUSE dispatch would freeze the whole
        # mount for the duration of a large namespace listing.
        self.quota_bytes = quota_mb * 1024 * 1024
        self._usage_bytes = 0
        self._usage_kick = threading.Event()
        self._usage_thread: threading.Thread | None = None
        if self.quota_bytes > 0:
            self._start_usage_ticker()

    # --- quota ---------------------------------------------------------------
    def set_quota(self, quota_mb: int) -> None:
        self.quota_bytes = quota_mb * 1024 * 1024
        if self.quota_bytes > 0:
            self._start_usage_ticker()
        self._usage_kick.set()  # refresh promptly

    def _start_usage_ticker(self) -> None:
        if self._usage_thread is not None and self._usage_thread.is_alive():
            return
        self._refresh_usage()  # first number synchronously (mount start)
        t = threading.Thread(target=self._usage_loop, daemon=True,
                             name="mount-quota-usage")
        self._usage_thread = t
        t.start()

    def _usage_loop(self) -> None:  # pragma: no cover - timing loop
        while True:
            self._usage_kick.wait(15.0)
            self._usage_kick.clear()
            self._refresh_usage()

    def _refresh_usage(self) -> None:
        def du(path: str) -> int:
            total = 0
            last = ""
            while True:
                out = self.fc.list(path, limit=10000, last_file_name=last)
                entries = out.get("Entries") or []
                for e in entries:
                    if e["IsDirectory"]:
                        total += du(e["FullPath"])
                    else:
                        total += int(e.get("FileSize") or 0)
                if len(entries) < 10000:
                    return total
                last = entries[-1]["FullPath"].rsplit("/", 1)[-1]

        try:
            self._usage_bytes = du("/")
        except Exception:
            pass  # filer hiccup / non-JSON error body: keep the stale value

    def _usage(self) -> int:
        return self._usage_bytes

    def _quota_exceeded(self) -> bool:
        return self.quota_bytes > 0 and self._usage_bytes >= self.quota_bytes

    # --- inode table ----------------------------------------------------------
    def _ino_for(self, path: str, entry: dict | None = None) -> int:
        """Inode for a path. All names of one hardlink set share an inode
        (keyed by the hardlink id — reference inodeToPath.AddPath in
        `weedfs_link.go`) so st_ino-based tools (rsync -H, du) see them as
        one file; reverse lookup keeps the first name."""
        with self._lock:
            hl = (entry or {}).get("hard_link_id") or ""
            if hl:
                key = "\0hl:" + hl  # cannot collide with a real path
                ino = self._path_to_ino.get(key)
                if ino is None:
                    ino = self._next_ino
                    self._next_ino += 1
                    self._path_to_ino[key] = ino
                if ino not in self._ino_to_path:
                    self._ino_to_path[ino] = path
                self._path_to_ino[path] = ino
                return ino
            ino = self._path_to_ino.get(path)
            if ino is None:
                ino = self._next_ino
                self._next_ino += 1
                self._path_to_ino[path] = ino
                self._ino_to_path[ino] = path
            return ino

    def _path_of(self, ino: int) -> str | None:
        with self._lock:
            return self._ino_to_path.get(ino)

    def _rename_ino(self, old: str, new: str) -> None:
        with self._lock:
            ino = self._path_to_ino.pop(old, None)
            if ino is not None:
                self._path_to_ino[new] = ino
                self._ino_to_path[ino] = new

    # --- storage helpers ------------------------------------------------------
    def _upload_chunk_data(self, data: bytes) -> str:
        out = self.weed.upload(data)
        return out["fid"]

    def _attr_from_entry(self, path: str, entry: dict) -> bytes:
        attrs = entry.get("attributes") or {}
        is_dir = bool(entry.get("is_directory"))
        size = attrs.get("file_size", 0)
        if not is_dir and entry.get("chunks"):
            size = max(size, max(
                c["offset"] + c["size"] for c in entry["chunks"]
            ))
        if not is_dir and entry.get("content"):
            size = max(size, len(bytes.fromhex(entry["content"])))
        mode = attrs.get("mode", 0o755 if is_dir else 0o644) & 0o7777
        mode |= fp.S_IFDIR if is_dir else fp.S_IFREG
        return fp.pack_attr(
            self._ino_for(path, entry), size, mode,
            nlink=2 if is_dir else max(1, entry.get("hard_link_counter", 0)),
            uid=attrs.get("uid", 0), gid=attrs.get("gid", 0),
            mtime=attrs.get("mtime", 0.0), ctime=attrs.get("crtime", 0.0),
        )

    def _commit_handle(self, h: FileHandle) -> int:
        """Seal + upload dirty pages, then write the entry with the merged
        chunk list (`weedfs_file_sync.go` doFlush)."""
        if not h.dirty:
            return 0
        try:
            new_chunks = h.pipeline.flush()
        except Exception:
            return fp.ERRNO_IO
        entry = self.meta.fc.get_entry(h.path) or {
            "full_path": h.path, "is_directory": False,
            "attributes": {"mode": 0o644, "mtime": time.time()},
            "chunks": [], "extended": {}, "content": "",
        }
        chunks = [FileChunk.from_dict(c) for c in entry.get("chunks") or []]
        chunks.extend(new_chunks)
        size = max(
            [h.size_hint] + [c.offset + c.size for c in chunks] or [0]
        )
        entry["chunks"] = [c.to_dict() for c in chunks]
        attrs = entry.setdefault("attributes", {})
        attrs["file_size"] = size
        attrs["mtime"] = time.time()
        entry["content"] = ""
        try:
            self.fc.put_entry(h.path, entry)
        except OSError:
            return fp.ERRNO_IO
        self.meta.put(h.path, self.fc.get_entry(h.path))
        h.dirty = False
        return 0

    def _resolved(self, entry: dict) -> tuple[list, int]:
        """An entry's visible intervals and the end of its chunks, kept
        while READs see the same entry (the meta cache replaces an entry,
        never edits it): resolving every chunk again for each READ cost
        5.5 ms a 128 KiB READ of a 1 GiB file (256 chunks)."""
        memo = self._resolved_memo
        if memo is None or memo[0] is not entry:
            chunks = [FileChunk.from_dict(c) for c in entry.get("chunks") or []]
            memo = self._resolved_memo = (
                entry, read_resolved_chunks(chunks),
                max((c.offset + c.size for c in chunks), default=0))
        return memo[1], memo[2]

    def _read_range(self, entry: dict, offset: int, size: int,
                    handle: FileHandle | None) -> bytes:
        buf = bytearray(size)
        filled = 0
        if entry.get("content"):
            raw = bytes.fromhex(entry["content"])
            piece = raw[offset:offset + size]
            buf[:len(piece)] = piece
            filled = len(piece)
        visibles, chunk_end = self._resolved(entry)
        if visibles:
            for view in view_from_visibles(visibles, offset, size):
                data = self.chunk_cache.get_chunk(view.file_id)
                if data is None:
                    data = self.weed.fetch(view.file_id)
                    self.chunk_cache.set_chunk(view.file_id, data)
                piece = data[view.offset_in_chunk:
                             view.offset_in_chunk + view.size]
                dst = view.view_offset - offset
                buf[dst:dst + len(piece)] = piece
                filled = max(filled, dst + len(piece))
        # overlay unflushed dirty spans (readback-before-upload)
        if handle is not None:
            for abs_off, data in handle.pipeline.read_back(offset, size):
                dst = abs_off - offset
                buf[dst:dst + len(data)] = data
                filled = max(filled, dst + len(data))
        # clamp to logical EOF
        attrs = entry.get("attributes") or {}
        logical = max(attrs.get("file_size", 0), chunk_end)
        if handle is not None:
            logical = max(logical, handle.size_hint)
        end = min(size, max(filled, min(logical - offset, size)))
        return bytes(buf[:max(0, end)])

    # --- dispatcher -----------------------------------------------------------
    def handle(self, buf: bytes) -> bytes | None:
        hdr, payload = fp.parse_in(buf)
        op = hdr.opcode
        try:
            fn = {
                fp.INIT: self._op_init,
                fp.LOOKUP: self._op_lookup,
                fp.GETATTR: self._op_getattr,
                fp.SETATTR: self._op_setattr,
                fp.OPENDIR: self._op_open,
                fp.OPEN: self._op_open,
                fp.READDIR: self._op_readdir,
                fp.RELEASEDIR: self._op_releasedir,
                fp.CREATE: self._op_create,
                fp.MKDIR: self._op_mkdir,
                fp.WRITE: self._op_write,
                fp.READ: self._op_read,
                fp.FLUSH: self._op_flush,
                fp.FSYNC: self._op_flush,
                fp.RELEASE: self._op_release,
                fp.UNLINK: self._op_unlink,
                fp.LINK: self._op_link,
                fp.RMDIR: self._op_rmdir,
                fp.RENAME: self._op_rename,
                fp.RENAME2: self._op_rename2,
                fp.STATFS: self._op_statfs,
                fp.ACCESS: lambda h, p: fp.reply(h.unique),
            }.get(op)
            if op == fp.FORGET:
                return None  # no reply by protocol
            if fn is None:
                return fp.reply(hdr.unique, error=fp.ERRNO_NOSYS)
            return fn(hdr, payload)
        except Exception:
            return fp.reply(hdr.unique, error=fp.ERRNO_IO)

    MAX_WRITE = 1 << 17  # negotiated in INIT; read buffer must exceed it

    def serve(self, fd: int) -> None:  # pragma: no cover - needs /dev/fuse
        import errno
        import os

        self.meta.start_subscriber()
        bufsize = self.MAX_WRITE + (1 << 16)  # kernel demands max_write+header
        while True:
            try:
                req = os.read(fd, bufsize)
            except OSError as e:
                if e.errno in (errno.EINTR, errno.EAGAIN):
                    continue
                break  # ENODEV = unmounted
            if not req:
                break
            out = self.handle(req)
            if out is not None:
                try:
                    os.write(fd, out)
                except OSError:
                    pass  # request aborted (e.g. interrupted syscall)

    # --- ops ------------------------------------------------------------------
    def _op_init(self, hdr, payload) -> bytes:
        major, minor, max_ra, flags = fp.INIT_IN.unpack_from(payload)
        out = fp.INIT_OUT.pack(
            7, min(31, minor), max_ra, 0,  # no special flags
            12, 10,  # max_background, congestion
            self.MAX_WRITE, 1,  # max_write, time_gran
            (self.MAX_WRITE // 4096), 0,  # max_pages, map_alignment
        )
        return fp.reply(hdr.unique, out)

    def _child_path(self, parent_ino: int, name: str) -> str | None:
        parent = self._path_of(parent_ino)
        if parent is None:
            return None
        return (parent.rstrip("/") + "/" + name) if parent != "/" \
            else "/" + name

    def _op_lookup(self, hdr, payload) -> bytes:
        name = payload.split(b"\0", 1)[0].decode()
        path = self._child_path(hdr.nodeid, name)
        if path is None:
            return fp.reply(hdr.unique, error=fp.ERRNO_NOENT)
        entry = self.meta.get_entry(path)
        if entry is None:
            return fp.reply(hdr.unique, error=fp.ERRNO_NOENT)
        attr = self._attr_from_entry(path, entry)
        return fp.reply(
            hdr.unique, fp.pack_entry_out(self._ino_for(path), attr)
        )

    def _op_getattr(self, hdr, payload) -> bytes:
        path = self._path_of(hdr.nodeid)
        if path is None:
            return fp.reply(hdr.unique, error=fp.ERRNO_NOENT)
        if path == "/":
            attr = fp.pack_attr(1, 0, fp.S_IFDIR | 0o755, nlink=2)
            return fp.reply(hdr.unique, fp.pack_attr_out(attr))
        entry = self.meta.get_entry(path)
        if entry is None:
            return fp.reply(hdr.unique, error=fp.ERRNO_NOENT)
        return fp.reply(
            hdr.unique, fp.pack_attr_out(self._attr_from_entry(path, entry))
        )

    def _op_setattr(self, hdr, payload) -> bytes:
        path = self._path_of(hdr.nodeid)
        if path is None:
            return fp.reply(hdr.unique, error=fp.ERRNO_NOENT)
        fields = fp.SETATTR_IN.unpack_from(payload)
        valid, _, fh, new_size = fields[0], fields[1], fields[2], fields[3]
        entry = self.meta.fc.get_entry(path)
        if entry is None:
            return fp.reply(hdr.unique, error=fp.ERRNO_NOENT)
        if valid & fp.FATTR_SIZE:
            # truncate (`weedfs_attr.go` setAttr size change)
            chunks = [FileChunk.from_dict(c)
                      for c in entry.get("chunks") or []]
            kept = [c for c in chunks if c.offset < new_size]
            for c in kept:
                if c.offset + c.size > new_size:
                    c.size = new_size - c.offset
            entry["chunks"] = [c.to_dict() for c in kept]
            if entry.get("content"):
                entry["content"] = bytes.fromhex(
                    entry["content"])[:new_size].hex()
            entry.setdefault("attributes", {})["file_size"] = new_size
            self.fc.put_entry(path, entry)
            self.meta.invalidate(path)
            entry = self.meta.get_entry(path)
        return fp.reply(
            hdr.unique, fp.pack_attr_out(self._attr_from_entry(path, entry))
        )

    def _op_open(self, hdr, payload) -> bytes:
        path = self._path_of(hdr.nodeid)
        if path is None:
            return fp.reply(hdr.unique, error=fp.ERRNO_NOENT)
        with self._lock:
            fh = self._next_fh
            self._next_fh += 1
            self._handles[fh] = FileHandle(fh, path, self)
        return fp.reply(hdr.unique, fp.pack_open_out(fh))

    def _op_create(self, hdr, payload) -> bytes:
        if self.read_only:
            return fp.reply(hdr.unique, error=fp.ERRNO_INVAL)
        flags, mode, umask, _ = fp.CREATE_IN.unpack_from(payload)
        name = payload[fp.CREATE_IN.size:].split(b"\0", 1)[0].decode()
        path = self._child_path(hdr.nodeid, name)
        if path is None:
            return fp.reply(hdr.unique, error=fp.ERRNO_NOENT)
        entry = {
            "full_path": path, "is_directory": False,
            "attributes": {"mode": mode & 0o7777, "mtime": time.time(),
                           "crtime": time.time(), "file_size": 0,
                           "uid": hdr.uid, "gid": hdr.gid},
            "chunks": [], "extended": {}, "content": "",
        }
        try:
            self.fc.put_entry(path, entry)
        except OSError:
            return fp.reply(hdr.unique, error=fp.ERRNO_IO)
        self.meta.put(path, self.fc.get_entry(path))
        ino = self._ino_for(path)
        with self._lock:
            fh = self._next_fh
            self._next_fh += 1
            self._handles[fh] = FileHandle(fh, path, self)
        attr = self._attr_from_entry(path, self.meta.get_entry(path) or entry)
        return fp.reply(
            hdr.unique,
            fp.pack_entry_out(ino, attr) + fp.pack_open_out(fh),
        )

    def _op_mkdir(self, hdr, payload) -> bytes:
        if self.read_only:
            return fp.reply(hdr.unique, error=fp.ERRNO_INVAL)
        mode, umask = fp.MKDIR_IN.unpack_from(payload)
        name = payload[fp.MKDIR_IN.size:].split(b"\0", 1)[0].decode()
        path = self._child_path(hdr.nodeid, name)
        if path is None:
            return fp.reply(hdr.unique, error=fp.ERRNO_NOENT)
        try:
            self.fc.mkdir(path)
        except OSError:
            return fp.reply(hdr.unique, error=fp.ERRNO_EXIST)
        self.meta.invalidate(path)
        entry = self.meta.get_entry(path)
        if entry is None:
            return fp.reply(hdr.unique, error=fp.ERRNO_IO)
        return fp.reply(
            hdr.unique,
            fp.pack_entry_out(self._ino_for(path),
                              self._attr_from_entry(path, entry)),
        )

    def _op_readdir(self, hdr, payload) -> bytes:
        fields = fp.READ_IN.unpack_from(payload)
        offset, size = fields[1], fields[2]
        path = self._path_of(hdr.nodeid)
        if path is None:
            return fp.reply(hdr.unique, error=fp.ERRNO_NOENT)
        names: list[tuple[str, bool]] = [(".", True), ("..", True)]
        listing = self.fc.list(path, limit=100000)
        for e in listing.get("Entries") or []:
            names.append(
                (e["FullPath"].rsplit("/", 1)[-1], e["IsDirectory"])
            )
        out = b""
        for i, (name, is_dir) in enumerate(names):
            if i < offset:
                continue
            child = path if name in (".", "..") else (
                (path.rstrip("/") + "/" + name) if path != "/" else "/" + name
            )
            ent = fp.pack_dirent(
                self._ino_for(child), i + 1, name.encode(),
                stat_mod.S_IFDIR >> 12 if is_dir else stat_mod.S_IFREG >> 12,
            )
            if len(out) + len(ent) > size:
                break
            out += ent
        return fp.reply(hdr.unique, out)

    def _op_releasedir(self, hdr, payload) -> bytes:
        return fp.reply(hdr.unique)

    def _op_write(self, hdr, payload) -> bytes:
        if self.read_only:
            return fp.reply(hdr.unique, error=fp.ERRNO_INVAL)
        if self._quota_exceeded():
            return fp.reply(hdr.unique, error=fp.ERRNO_NOSPC)
        fields = fp.WRITE_IN.unpack_from(payload)
        fh, offset, size = fields[0], fields[1], fields[2]
        data = payload[fp.WRITE_IN.size:fp.WRITE_IN.size + size]
        h = self._handles.get(fh)
        if h is None:
            return fp.reply(hdr.unique, error=fp.ERRNO_INVAL)
        h.pipeline.write(offset, data)
        h.dirty = True
        h.size_hint = max(h.size_hint, offset + len(data))
        return fp.reply(hdr.unique, fp.WRITE_OUT.pack(len(data), 0))

    def _op_read(self, hdr, payload) -> bytes:
        fields = fp.READ_IN.unpack_from(payload)
        fh, offset, size = fields[0], fields[1], fields[2]
        h = self._handles.get(fh)
        path = h.path if h is not None else self._path_of(hdr.nodeid)
        if path is None:
            return fp.reply(hdr.unique, error=fp.ERRNO_INVAL)
        entry = self.meta.get_entry(path)
        if entry is None:
            return fp.reply(hdr.unique, error=fp.ERRNO_NOENT)
        data = self._read_range(entry, offset, size, h)
        return fp.reply(hdr.unique, data)

    def _op_flush(self, hdr, payload) -> bytes:
        # fuse_flush_in/fsync_in lead with the fh (24/16-byte structs —
        # NOT read_in; the kernel rejects daemons that misparse these)
        (fh,) = struct_unpack_fh(payload)
        h = self._handles.get(fh)
        if h is None:
            return fp.reply(hdr.unique)
        err = self._commit_handle(h)
        return fp.reply(hdr.unique, error=err)

    def _op_release(self, hdr, payload) -> bytes:
        (fh,) = struct_unpack_fh(payload)
        h = self._handles.pop(fh, None)
        if h is not None:
            self._commit_handle(h)
        return fp.reply(hdr.unique)

    def _op_unlink(self, hdr, payload) -> bytes:
        if self.read_only:
            return fp.reply(hdr.unique, error=fp.ERRNO_INVAL)
        name = payload.split(b"\0", 1)[0].decode()
        path = self._child_path(hdr.nodeid, name)
        if path is None or self.meta.get_entry(path) is None:
            return fp.reply(hdr.unique, error=fp.ERRNO_NOENT)
        self.fc.delete(path)
        self.meta.invalidate(path)
        return fp.reply(hdr.unique)

    def _op_rmdir(self, hdr, payload) -> bytes:
        if self.read_only:
            return fp.reply(hdr.unique, error=fp.ERRNO_INVAL)
        name = payload.split(b"\0", 1)[0].decode()
        path = self._child_path(hdr.nodeid, name)
        if path is None or self.meta.get_entry(path) is None:
            return fp.reply(hdr.unique, error=fp.ERRNO_NOENT)
        listing = self.fc.list(path)
        if listing.get("Entries"):
            return fp.reply(hdr.unique, error=fp.ERRNO_NOTEMPTY)
        self.fc.delete(path, recursive=True)
        self.meta.invalidate(path)
        return fp.reply(hdr.unique)

    def _rename_common(self, hdr, newdir: int, rest: bytes) -> bytes:
        old_name, new_name = rest.split(b"\0")[:2]
        old_path = self._child_path(hdr.nodeid, old_name.decode())
        new_path = self._child_path(newdir, new_name.decode())
        if old_path is None or new_path is None:
            return fp.reply(hdr.unique, error=fp.ERRNO_NOENT)
        try:
            self.fc.rename(old_path, new_path)
        except OSError:
            return fp.reply(hdr.unique, error=fp.ERRNO_IO)
        self._rename_ino(old_path, new_path)
        self.meta.invalidate(old_path)
        self.meta.invalidate(new_path)
        return fp.reply(hdr.unique)

    def _op_link(self, hdr, payload) -> bytes:
        """Hard link (`weed/mount/weedfs_link.go`): payload is
        fuse_link_in{oldnodeid u64} + name; nodeid is the new parent."""
        import struct as _struct

        (oldnodeid,) = _struct.unpack_from("<Q", payload)
        name = payload[8:].split(b"\0", 1)[0].decode()
        old_path = self._path_of(oldnodeid)
        new_path = self._child_path(hdr.nodeid, name)
        if old_path is None or new_path is None:
            return fp.reply(hdr.unique, error=fp.ERRNO_NOENT)
        try:
            self.meta.fc.link(old_path, new_path)
        except IOError:
            return fp.reply(hdr.unique, error=fp.ERRNO_IO)
        self.meta.invalidate(old_path)
        self.meta.invalidate(new_path)  # clear the cached negative lookup
        entry = self.meta.get_entry(new_path)
        if entry is None:
            return fp.reply(hdr.unique, error=fp.ERRNO_IO)
        attr = self._attr_from_entry(new_path, entry)
        return fp.reply(
            hdr.unique, fp.pack_entry_out(self._ino_for(new_path), attr)
        )

    def _op_rename(self, hdr, payload) -> bytes:
        (newdir,) = fp.RENAME_IN.unpack_from(payload)
        return self._rename_common(hdr, newdir, payload[fp.RENAME_IN.size:])

    def _op_rename2(self, hdr, payload) -> bytes:
        newdir, flags, _ = fp.RENAME2_IN.unpack_from(payload)
        return self._rename_common(hdr, newdir, payload[fp.RENAME2_IN.size:])

    def _op_statfs(self, hdr, payload) -> bytes:
        if self.quota_bytes > 0:
            blocks = max(1, self.quota_bytes // 4096)
            free = max(0, (self.quota_bytes - self._usage()) // 4096)
            return fp.reply(hdr.unique, fp.pack_statfs(
                blocks=blocks, bfree=free, bavail=free))
        return fp.reply(hdr.unique, fp.pack_statfs())
