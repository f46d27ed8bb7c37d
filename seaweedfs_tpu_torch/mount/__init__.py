"""`weed mount` subsystem: FUSE filesystem over the filer.

Layers (SURVEY.md §2 FUSE mount, reference `weed/mount/` 5.3k LoC):
  - `fuse_proto` — kernel wire-format structs (no fuse library in image;
    direct /dev/fuse framing per SURVEY.md §2.2 item 7)
  - `weedfs.WFS` — inode map, meta cache w/ subscription, page-writer
    upload pipeline, chunked reads
  - `mount_fs()` — real kernel mount via /dev/fuse + mount(2) (needs
    CAP_SYS_ADMIN; tests use the in-memory transport instead)

The port's copy of `seaweedfs_tpu/mount/__init__.py`, with
`admin_socket_path`, `start_admin_service` (the admin listener
`mount.configure` talks to), `mount_fs` and `VirtualFuseKernel`.
"""

from __future__ import annotations

import ctypes
import os

from .weedfs import WFS  # noqa: F401


def admin_socket_path(mountpoint: str) -> str:
    """Deterministic unix-socket path for a mount's admin listener — how
    `mount.configure -dir <mp>` finds a RUNNING mount (the reference uses
    the same convention with a hashed /tmp socket, `mount.go`). The port
    puts it in the process's temporary directory (TMPDIR, else /tmp)."""
    import hashlib
    import tempfile

    digest = hashlib.md5(
        os.path.abspath(mountpoint).encode()).hexdigest()[:10]
    return os.path.join(tempfile.gettempdir(), f"seaweedfs-tpu-mount-{digest}.sock")


def start_admin_service(wfs: WFS, mountpoint: str):
    """Tiny control listener on the mount's unix socket: GET /status and
    POST /configure {"quotaMB": n} (`weed/mount/weedfs_grpc_server.go` /
    command_mount_configure.go surface). Returns the HTTPService."""
    from ..server.httpd import HTTPService, Request, Response

    svc = HTTPService("127.0.0.1", 0)

    @svc.route("GET", r"/status")
    def status(req: Request) -> Response:
        return Response({
            "mountpoint": os.path.abspath(mountpoint),
            "quota_bytes": wfs.quota_bytes,
            "used_bytes": wfs._usage(),
            "read_only": wfs.read_only,
        })

    @svc.route("POST", r"/configure")
    def configure(req: Request) -> Response:
        p = req.json()
        if "quotaMB" in p:
            wfs.set_quota(int(p["quotaMB"]))
        return Response({"ok": True, "quota_bytes": wfs.quota_bytes})

    svc.plain_backend = True
    svc.start()  # enable_unix_socket needs the handler class start() builds
    svc.enable_unix_socket(admin_socket_path(mountpoint))
    # the TCP side was only scaffolding: close it so the unix socket is
    # the ONLY control surface (no stray unauthenticated loopback port)
    svc._httpd.shutdown()
    svc._httpd.server_close()
    svc._httpd = None
    return svc


def mount_fs(wfs: WFS, mountpoint: str) -> None:  # pragma: no cover
    """Open /dev/fuse, mount(2), serve. Raises PermissionError without
    CAP_SYS_ADMIN (the normal case in unprivileged containers)."""
    fd = os.open("/dev/fuse", os.O_RDWR)
    opts = f"fd={fd},rootmode=40000,user_id=0,group_id=0"
    libc = ctypes.CDLL(None, use_errno=True)
    ret = libc.mount(
        b"seaweedfs_tpu", mountpoint.encode(), b"fuse.seaweedfs_tpu",
        0, opts.encode(),
    )
    if ret != 0:
        err = ctypes.get_errno()
        os.close(fd)
        raise PermissionError(err, f"mount(2) failed: {os.strerror(err)}")
    try:
        wfs.serve(fd)
    finally:
        libc.umount2(mountpoint.encode(), 2)  # MNT_DETACH
        os.close(fd)


class VirtualFuseKernel:
    """Test-side 'kernel': speaks the same packed wire structs against
    WFS.handle — every op crosses the real protocol layer."""

    def __init__(self, wfs: WFS) -> None:
        from . import fuse_proto as fp

        self.fp = fp
        self.wfs = wfs
        self._unique = 0
        self.init()

    def call(self, opcode: int, nodeid: int, payload: bytes = b"",
             uid: int = 0, gid: int = 0):
        fp = self.fp
        self._unique += 1
        req = fp.pack_request(opcode, self._unique, nodeid, payload, uid, gid)
        out = self.wfs.handle(req)
        if out is None:
            return None, b""
        unique, error, body = fp.parse_reply(out)
        assert unique == self._unique
        return -error, body

    # convenience verbs mirroring libfuse client calls -----------------------
    def init(self):
        fp = self.fp
        err, body = self.call(fp.INIT, 0, fp.INIT_IN.pack(7, 31, 1 << 17, 0))
        assert err == 0
        return body

    def lookup(self, parent: int, name: str):
        fp = self.fp
        err, body = self.call(fp.LOOKUP, parent, name.encode() + b"\0")
        if err:
            return err, None, None
        ino, attr = fp.unpack_entry_out(body)
        return 0, ino, attr

    def getattr(self, ino: int):
        fp = self.fp
        err, body = self.call(fp.GETATTR, ino, b"\0" * 16)
        return err, (fp.unpack_attr_out(body) if not err else None)

    def mkdir(self, parent: int, name: str, mode: int = 0o755):
        fp = self.fp
        err, body = self.call(
            fp.MKDIR, parent, fp.MKDIR_IN.pack(mode, 0) + name.encode() + b"\0"
        )
        if err:
            return err, None
        ino, _ = fp.unpack_entry_out(body)
        return 0, ino

    def create(self, parent: int, name: str, mode: int = 0o644):
        fp = self.fp
        err, body = self.call(
            fp.CREATE, parent,
            fp.CREATE_IN.pack(os.O_RDWR, mode, 0, 0) + name.encode() + b"\0",
        )
        if err:
            return err, None, None
        ino, _ = fp.unpack_entry_out(body)
        fh = fp.unpack_open_out(body[128:])
        return 0, ino, fh

    def open(self, ino: int):
        fp = self.fp
        err, body = self.call(fp.OPEN, ino, b"\0" * 8)
        return err, (fp.unpack_open_out(body) if not err else None)

    def write(self, ino: int, fh: int, offset: int, data: bytes):
        fp = self.fp
        payload = fp.WRITE_IN.pack(fh, offset, len(data), 0, 0, 0, 0) + data
        err, body = self.call(fp.WRITE, ino, payload)
        if err:
            return err, 0
        return 0, fp.WRITE_OUT.unpack_from(body)[0]

    def read(self, ino: int, fh: int, offset: int, size: int):
        fp = self.fp
        payload = fp.READ_IN.pack(fh, offset, size, 0, 0, 0, 0)
        return self.call(fp.READ, ino, payload)

    def flush(self, ino: int, fh: int):
        fp = self.fp
        # kernel-accurate 24-byte fuse_flush_in
        return self.call(fp.FLUSH, ino, fp.FLUSH_IN.pack(fh, 0, 0, 0))[0]

    def release(self, ino: int, fh: int):
        fp = self.fp
        return self.call(
            fp.RELEASE, ino, fp.RELEASE_IN.pack(fh, 0, 0, 0)
        )[0]

    def readdir(self, ino: int, fh: int = 0, size: int = 1 << 16):
        fp = self.fp
        err, body = self.call(
            fp.READDIR, ino, fp.READ_IN.pack(fh, 0, size, 0, 0, 0, 0)
        )
        if err:
            return err, []
        return 0, fp.unpack_dirents(body)

    def unlink(self, parent: int, name: str):
        return self.call(self.fp.UNLINK, parent, name.encode() + b"\0")[0]

    def rmdir(self, parent: int, name: str):
        return self.call(self.fp.RMDIR, parent, name.encode() + b"\0")[0]

    def rename(self, parent: int, old: str, newparent: int, new: str):
        fp = self.fp
        payload = fp.RENAME_IN.pack(newparent) + old.encode() + b"\0" \
            + new.encode() + b"\0"
        return self.call(fp.RENAME, parent, payload)[0]

    def setattr_size(self, ino: int, size: int):
        fp = self.fp
        payload = fp.SETATTR_IN.pack(
            fp.FATTR_SIZE, 0, 0, size, 0, 0, 0, 0,
            0, 0, 0, 0, 0, 0, 0, 0,
        )
        err, body = self.call(fp.SETATTR, ino, payload)
        return err, (fp.unpack_attr_out(body) if not err else None)

    def statfs(self):
        return self.call(self.fp.STATFS, 1)
