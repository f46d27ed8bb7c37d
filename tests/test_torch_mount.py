"""The port's FUSE mount held against the JAX package's, case for case with
`tests/test_mount.py` (the wire structs, the page writer, WFS ops through
packed kernel requests, meta-cache coherence, a mount over the filer's
local socket, the quota and `mount.configure`), plus the raw `WFS.handle`
reply bytes of one request sequence, the entries a mount commits, and the
unix-socket listener with its `http+unix://` clients.

The structs and the page writer take the same seeded inputs in both
packages and must give the same bytes. The WFS cases run on
`tests/test_torch_filer_meta.py::twin` (a JAX cluster and a port cluster on
`device="cpu"`, both filers at 4 KiB chunks, each with a local socket): one
`WFS` of each package over its side's filer, driven through its package's
`VirtualFuseKernel` by the same steps, one side at a time. Results are held
equal with the attributes' times dropped; the raw reply bytes are held
equal with the attribute time fields zeroed (the filer and the mount stamp
entries with their own clocks). Stored entries are held equal through
`Norm`. Tolerance: byte equality after that.

Left out of the mirror: `test_unix_socket_exempt_from_mtls_gate`, which
needs TLS (ROADMAP 10d-4). `test_kernel_mount_e2e` is mirrored with the
JAX test's skip: it needs `/dev/fuse` and root.
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest

from seaweedfs_tpu.mount import VirtualFuseKernel as RefKernel
from seaweedfs_tpu.mount import WFS as RefWFS
from seaweedfs_tpu.mount import fuse_proto as ref_fp
from seaweedfs_tpu.mount import start_admin_service as ref_admin
from seaweedfs_tpu.mount.meta_cache import MetaCache as RefMetaCache
from seaweedfs_tpu.mount.page_writer import PageChunk as RefPageChunk
from seaweedfs_tpu.mount.page_writer import UploadPipeline as RefUploadPipeline
from seaweedfs_tpu.shell import CommandEnv as RefCommandEnv
from seaweedfs_tpu.shell import run_command as ref_run_command
from seaweedfs_tpu_torch.mount import VirtualFuseKernel, WFS, start_admin_service
from seaweedfs_tpu_torch.mount import fuse_proto as fp
from seaweedfs_tpu_torch.mount.meta_cache import MetaCache
from seaweedfs_tpu_torch.mount.page_writer import PageChunk, UploadPipeline
from seaweedfs_tpu_torch.server.httpd import (
    HTTPService,
    PooledHTTP,
    Response,
    get_json,
    http_request,
)
from seaweedfs_tpu_torch.shell import CommandEnv, run_command

from .test_torch_filer_meta import Norm, twin
from .test_torch_s3 import entries
from ._threads import stop_history_loops  # noqa: F401

MOUNT_CHUNK = 64 * 1024
PKGS = (  # (WFS, kernel, fuse_proto, MetaCache, admin service, CommandEnv, run_command)
    (RefWFS, RefKernel, ref_fp, RefMetaCache, ref_admin, RefCommandEnv, ref_run_command),
    (WFS, VirtualFuseKernel, fp, MetaCache, start_admin_service, CommandEnv, run_command),
)


# --- the wire structs --------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_proto_structs_equal_reference(seed):
    outs = []
    for m in (ref_fp, fp):
        r = np.random.default_rng([seed, 72])
        name = r.bytes(int(r.integers(1, 40)))
        req = m.pack_request(int(r.integers(1, 50)), int(r.integers(1 << 40)), int(r.integers(1 << 20)),
                             name + b"\0", uid=int(r.integers(1000)), gid=int(r.integers(1000)))
        hdr, payload = m.parse_in(req)
        attr = m.pack_attr(int(r.integers(1 << 30)), int(r.integers(1 << 40)),
                           m.S_IFREG | int(r.integers(0o7777)), nlink=int(r.integers(1, 9)),
                           mtime=float(r.uniform(0, 2e9)), ctime=float(r.uniform(0, 2e9)))
        ents = b"".join(m.pack_dirent(int(r.integers(1 << 30)), k + 1,
                                      r.bytes(int(r.integers(1, 30))).hex().encode(),
                                      int(r.integers(16)))
                        for k in range(int(r.integers(1, 6))))
        outs.append((req, vars(hdr), payload, m.reply(int(r.integers(1 << 30)), name),
                     m.reply(9, error=m.ERRNO_NOENT), attr, m.unpack_attr(attr),
                     m.pack_entry_out(5, attr), m.pack_attr_out(attr), m.pack_open_out(7),
                     ents, m.unpack_dirents(ents), m.pack_statfs(), m.ATTR.size,
                     m.SETATTR_IN.size, m.INIT_OUT.size))
    assert outs[1] == outs[0]
    assert len(outs[1][5]) == 88


def test_header_and_reply_roundtrip():
    req = fp.pack_request(fp.LOOKUP, 7, 1, b"name\0", uid=5, gid=6)
    hdr, payload = fp.parse_in(req)
    assert (hdr.opcode, hdr.unique, hdr.nodeid, hdr.uid, hdr.gid) == (fp.LOOKUP, 7, 1, 5, 6)
    assert payload == b"name\0"
    assert fp.parse_reply(fp.reply(9, b"payload")) == (9, 0, b"payload")
    assert fp.parse_reply(fp.reply(10, error=fp.ERRNO_NOENT))[:2] == (10, -fp.ERRNO_NOENT)
    a = fp.unpack_attr(fp.pack_attr(3, 1234, fp.S_IFREG | 0o600, mtime=1700000000.5))
    assert a["ino"] == 3 and a["size"] == 1234 and abs(a["mtime"] - 1700000000.5) < 1e-3
    ents = fp.pack_dirent(5, 1, b"abc", 4) + fp.pack_dirent(6, 2, b"longer-name", 8)
    assert fp.unpack_dirents(ents) == [(5, "abc", 4), (6, "longer-name", 8)]


# --- the page writer -----------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_page_chunk_spans_equal_reference(seed):
    outs = []
    for cls in (RefPageChunk, PageChunk):
        r = np.random.default_rng([seed, 73])
        pc = cls(int(r.integers(4)), 256)
        steps = []
        for _ in range(12):
            off = int(r.integers(256))
            pc.write(off, r.bytes(int(r.integers(1, 257 - off))))
            steps.append((list(pc.spans), pc.intervals()))
        outs.append(steps)
    assert outs[1] == outs[0]


@pytest.mark.parametrize("seed", range(4))
def test_upload_pipeline_equal_reference(seed):
    """Seeded writes (some sealing whole chunks): read_back before the flush,
    and the flushed chunks, equal; the uploads are the same bytes."""
    outs = []
    for cls in (RefUploadPipeline, UploadPipeline):
        r = np.random.default_rng([seed, 74])
        uploads = {}

        def up(data):
            fid = f"1,{len(uploads):02x}"
            uploads[fid] = data
            return fid

        pl = cls(up, chunk_size=100, concurrency=1)
        backs = []
        for _ in range(10):
            off = int(r.integers(500))
            pl.write(off, r.bytes(int(r.integers(1, 160))))
            lo = int(r.integers(600))
            backs.append(pl.read_back(lo, int(r.integers(1, 200))))
        chunks = pl.flush()
        outs.append((backs, sorted((c.offset, c.size, uploads[c.file_id]) for c in chunks),
                     pl.has_dirty()))
    assert outs[1] == outs[0]
    assert outs[1][2] is False


# --- WFS over a filer ------------------------------------------------------------------
@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mnt"))
    with twin(tmp, filer_kw=lambda side, i: {"local_socket": f"{tmp}/{side}{i}.sock"}) as pair:
        yield pair


class MountPair:
    """One WFS of each package; `both(fn)` runs fn(kernel, i) on each."""

    def __init__(self, sides, unix: bool = False, **kw) -> None:
        self.sides = sides
        self.kernels = []
        for side, pkg in zip(sides, PKGS):
            url = side.filer.service.unix_url if unix else side.filer.url
            self.kernels.append(pkg[1](pkg[0](url, chunk_size=MOUNT_CHUNK, **kw)))

    def both(self, fn):
        got = [drop_times(fn(k, i)) for i, k in enumerate(self.kernels)]
        assert got[1] == got[0]
        return got[1]

    def close(self) -> None:
        for k in self.kernels:
            k.wfs.meta.stop()


def drop_times(obj):
    if isinstance(obj, dict):
        return {k: drop_times(v) for k, v in obj.items() if k != "mtime"}
    if isinstance(obj, (list, tuple)):
        return [drop_times(v) for v in obj]
    return obj


def store(sides, root: str) -> list:
    trees = [Norm(s)(entries(s, root)) for s in sides]
    assert trees[1] == trees[0] and trees[1], root
    return trees[1]


@pytest.fixture()
def mnt(sides):
    pair = MountPair(sides)
    yield pair
    pair.close()


def get(side, path: str) -> tuple:
    return http_request("GET", side.filer.url + path)[::2]


def write_all(k, ino, fh, data: bytes, step: int) -> list:
    return [k.write(ino, fh, pos, data[pos:pos + step]) for pos in range(0, len(data), step)]


def read_all(k, ino, fh, size: int, step: int) -> bytes:
    out = b""
    for off in range(0, size, step):
        err, piece = k.read(ino, fh, off, step)
        assert err == 0
        out += piece
    return out


def test_create_write_read_roundtrip(mnt):
    def run(k, i):
        err, dino = k.mkdir(1, "docs")
        err2, ino, fh = k.create(dino, "hello.txt")
        out = [err, err2, k.write(ino, fh, 0, b"hello fuse world"),
               k.read(ino, fh, 0, 100), k.flush(ino, fh), k.release(ino, fh),
               get(mnt.sides[i], "/docs/hello.txt")]
        return out

    out = mnt.both(run)
    assert out[:3] == [0, 0, [0, 16]] and out[3] == [0, b"hello fuse world"]
    assert out[6] == [200, b"hello fuse world"]
    store(mnt.sides, "/docs")


def test_multi_chunk_write(mnt):
    data = np.random.default_rng(75).bytes(200 * 1024)

    def run(k, i):
        err, ino, fh = k.create(1, "big.bin")
        out = [err, write_all(k, ino, fh, data, 32 * 1024), k.release(ino, fh),
               get(mnt.sides[i], "/big.bin")[1] == data]
        err, fh2 = k.open(ino)
        out += [err, read_all(k, ino, fh2, len(data), 64 * 1024) == data, k.release(ino, fh2)]
        return out

    assert mnt.both(run)[3] is True
    assert mnt.both(lambda k, i: k.lookup(1, "big.bin"))[2]["size"] == len(data)


def test_overlapping_writes_latest_wins(mnt):
    def run(k, i):
        err, ino, fh = k.create(1, "overlap.txt")
        out = [k.write(ino, fh, 0, b"AAAAAAAAAA"), k.flush(ino, fh),
               k.write(ino, fh, 3, b"bbb"), k.flush(ino, fh), k.read(ino, fh, 0, 20)]
        k.release(ino, fh)
        return out

    assert mnt.both(run)[4] == [0, b"AAAbbbAAAA"]


def test_lookup_getattr_readdir(mnt):
    def run(k, i):
        err, dino = k.mkdir(1, "attrs")
        err, ino, fh = k.create(dino, "f.txt")
        k.write(ino, fh, 0, b"12345")
        k.release(ino, fh)
        return [k.lookup(dino, "f.txt"), k.getattr(dino), k.readdir(dino), ino]

    (err, ino2, attr), (err2, dattr), (err3, ents), ino = mnt.both(run)
    assert (err, err2, err3) == (0, 0, 0) and ino2 == ino and attr["size"] == 5
    assert attr["mode"] & fp.S_IFREG and dattr["mode"] & fp.S_IFDIR
    assert {n for _, n, _ in ents} >= {".", "..", "f.txt"}


def test_enoent_and_rename_unlink(mnt):
    def run(k, i):
        out = [k.lookup(1, "missing.txt")]
        err, ino, fh = k.create(1, "old.txt")
        k.write(ino, fh, 0, b"move me")
        k.release(ino, fh)
        out += [k.rename(1, "old.txt", 1, "new.txt"), k.lookup(1, "old.txt"),
                k.lookup(1, "new.txt"), k.unlink(1, "new.txt"), k.lookup(1, "new.txt"),
                k.unlink(1, "new.txt"), k.rename(1, "nope", 1, "x")]
        return out

    out = mnt.both(run)
    assert out[0][0] == fp.ERRNO_NOENT and out[1] == 0 and out[2][0] == fp.ERRNO_NOENT
    assert out[3][2]["size"] == 7 and out[4] == 0 and out[5][0] == fp.ERRNO_NOENT


def test_rmdir_nonempty_refused(mnt):
    def run(k, i):
        err, dino = k.mkdir(1, "full")
        err, ino, fh = k.create(dino, "x")
        k.release(ino, fh)
        out = [k.rmdir(1, "full"), k.unlink(dino, "x"), k.rmdir(1, "full"), k.rmdir(1, "full"),
               k.mkdir(1, "attrs")]
        return out

    out = mnt.both(run)
    assert out[:3] == [fp.ERRNO_NOTEMPTY, 0, 0] and out[3] == fp.ERRNO_NOENT


def test_truncate_via_setattr(mnt):
    def run(k, i):
        err, ino, fh = k.create(1, "trunc.txt")
        k.write(ino, fh, 0, b"0123456789")
        k.release(ino, fh)
        out = [k.setattr_size(ino, 4)]
        err, fh2 = k.open(ino)
        out.append(k.read(ino, fh2, 0, 100))
        k.release(ino, fh2)
        return out

    out = mnt.both(run)
    assert out[0][1]["size"] == 4 and out[1] == [0, b"0123"]


def test_statfs(mnt):
    err, body = mnt.both(lambda k, i: k.statfs())
    assert err == 0 and len(body) >= 80


def test_external_change_visible_after_invalidation(mnt):
    def run(k, i):
        err, ino, fh = k.create(1, "ext.txt")
        k.write(ino, fh, 0, b"v1")
        k.release(ino, fh)
        out = [http_request("PUT", mnt.sides[i].filer.url + "/ext.txt", b"version2!")[0]]
        k.wfs.meta.invalidate("/ext.txt")  # the subscriber would do this
        err, ino2, attr = k.lookup(1, "ext.txt")
        err, fh2 = k.open(ino2)
        out += [attr, k.read(ino2, fh2, 0, 100)]
        k.release(ino2, fh2)
        return out

    out = mnt.both(run)
    assert out[0] == 201 and out[1]["size"] == 9 and out[2] == [0, b"version2!"]


def test_subscription_invalidates(sides):
    def run(side, cls):
        mc = cls(side.filer.url)
        mc.start_subscriber()
        try:
            http_request("PUT", side.filer.url + "/sub.txt", b"one")
            first = mc.get_entry("/sub.txt")["content"]
            http_request("PUT", side.filer.url + "/sub.txt", b"two!!")
            deadline = time.time() + 10
            while time.time() < deadline:
                e = mc.get_entry("/sub.txt")
                if e and e.get("content") == b"two!!".hex():
                    return first, e["content"]
                time.sleep(0.1)
            raise AssertionError("meta cache never refreshed")
        finally:
            mc.stop()

    got = [run(side, pkg[3]) for side, pkg in zip(sides, PKGS)]
    assert got[1] == got[0] == (b"one".hex(), b"two!!".hex())


# --- raw replies -----------------------------------------------------------------------
ATTR_AT = {fp.LOOKUP: 16 + 40, fp.MKDIR: 16 + 40, fp.CREATE: 16 + 40, fp.GETATTR: 16 + 16,
           fp.SETATTR: 16 + 16}


def zero_times(op: int, out: bytes) -> bytes:
    """A reply with its attribute's atime, mtime, ctime and their nsecs zeroed."""
    at = ATTR_AT.get(op)
    if at is None or len(out) < at + 88:
        return out
    return out[:at + 24] + b"\0" * 36 + out[at + 60:]


def handle_script(wfs, m) -> list[bytes]:
    """One request sequence through WFS.handle; every reply's bytes."""
    replies, unique = [], [0]

    def call(op, nodeid, payload=b""):
        unique[0] += 1
        out = wfs.handle(m.pack_request(op, unique[0], nodeid, payload))
        replies.append(zero_times(op, out))
        _, err, body = m.parse_reply(out)
        return err, body

    call(m.INIT, 0, m.INIT_IN.pack(7, 31, 1 << 17, 0))
    call(m.LOOKUP, 1, b"absent\0")
    _, body = call(m.MKDIR, 1, m.MKDIR_IN.pack(0o755, 0) + b"raw\0")
    dino = m.unpack_entry_out(body)[0]
    _, body = call(m.CREATE, dino, m.CREATE_IN.pack(os.O_RDWR, 0o640, 0, 0) + b"f.bin\0")
    ino, fh = m.unpack_entry_out(body)[0], m.unpack_open_out(body[128:])
    data = np.random.default_rng(76).bytes(3 * MOUNT_CHUNK // 2)
    for pos in range(0, len(data), 1 << 15):
        piece = data[pos:pos + (1 << 15)]
        call(m.WRITE, ino, m.WRITE_IN.pack(fh, pos, len(piece), 0, 0, 0, 0) + piece)
    call(m.READ, ino, m.READ_IN.pack(fh, 1000, 5000, 0, 0, 0, 0))
    call(m.FLUSH, ino, m.FLUSH_IN.pack(fh, 0, 0, 0))
    call(m.READ, ino, m.READ_IN.pack(fh, MOUNT_CHUNK - 100, 300, 0, 0, 0, 0))
    call(m.GETATTR, ino, b"\0" * 16)
    call(m.OPENDIR, dino, b"\0" * 8)
    call(m.READDIR, dino, m.READ_IN.pack(0, 0, 1 << 16, 0, 0, 0, 0))
    call(m.READDIR, dino, m.READ_IN.pack(0, 1, 64, 0, 0, 0, 0))
    call(m.RENAME, dino, m.RENAME_IN.pack(1) + b"f.bin\0g.bin\0")
    call(m.LOOKUP, 1, b"g.bin\0")
    call(m.SETATTR, ino, m.SETATTR_IN.pack(m.FATTR_SIZE, 0, 0, 777, 0, 0, 0, 0,
                                           0, 0, 0, 0, 0, 0, 0, 0))
    call(m.READ, ino, m.READ_IN.pack(0, 0, 4096, 0, 0, 0, 0))
    call(m.STATFS, 1)
    call(m.ACCESS, 1, b"\0" * 8)
    call(m.RELEASE, ino, m.RELEASE_IN.pack(fh, 0, 0, 0))
    call(m.RMDIR, 1, b"raw\0")
    call(m.UNLINK, 1, b"g.bin\0")
    call(m.RMDIR, 1, b"raw\0")
    call(999, 1)  # ENOSYS
    return replies


def test_handle_reply_bytes_equal_reference(sides):
    got = []
    for side, pkg in zip(sides, PKGS):
        wfs = pkg[0](side.filer.url, chunk_size=MOUNT_CHUNK)
        got.append(handle_script(wfs, pkg[2]))
        wfs.meta.stop()
    assert len(got[1]) == len(got[0])
    for k, (want, have) in enumerate(zip(*got)):
        assert have == want, k


def test_mount_commits_equal_entries(mnt):
    """A tree written through each mount (small files, a multi-chunk file,
    an overwrite in the middle, a rename): the committed entries equal."""
    rng = np.random.default_rng(77)
    big = rng.bytes(3 * MOUNT_CHUNK + 123)
    patch = rng.bytes(5000)
    smalls = [rng.bytes(int(n)) for n in rng.integers(1, 3000, size=8)]

    def run(k, i):
        err, dino = k.mkdir(1, "commit")
        for n, body in enumerate(smalls):
            err, ino, fh = k.create(dino, f"s{n}")
            k.write(ino, fh, 0, body)
            k.flush(ino, fh)
            k.release(ino, fh)
        err, ino, fh = k.create(dino, "big")
        write_all(k, ino, fh, big, 1 << 17)
        k.flush(ino, fh)
        k.write(ino, fh, MOUNT_CHUNK + 10, patch)
        k.flush(ino, fh)
        k.release(ino, fh)
        k.rename(dino, "s0", dino, "renamed")
        return get(mnt.sides[i], "/commit/big")

    want = big[:MOUNT_CHUNK + 10] + patch + big[MOUNT_CHUNK + 10 + len(patch):]
    assert mnt.both(run) == [200, want]
    store(mnt.sides, "/commit")


# --- the filer's local socket ------------------------------------------------------------
def test_mount_e2e_over_unix_socket(sides):
    """`-filer.localSocket`: a mount session rides http+unix:// end to end,
    and the file is visible over TCP too (one namespace)."""
    pair = MountPair(sides, unix=True)
    payload = np.random.default_rng(78).bytes(200_000)
    try:
        def run(k, i):
            unix_url = sides[i].filer.service.unix_url
            out = [unix_url.startswith("http+unix://"),
                   http_request("POST", unix_url + "/probe.txt", b"hi")[0]]
            err, ino, fh = k.create(1, "unix.txt")
            out += [err, write_all(k, ino, fh, payload, 64 * 1024), k.flush(ino, fh),
                    k.release(ino, fh)]
            err, fh2 = k.open(ino)
            out += [read_all(k, ino, fh2, len(payload), 64 * 1024) == payload,
                    get(sides[i], "/unix.txt")[1] == payload]
            return out

        out = pair.both(run)
        assert out[:3] == [True, 201, 0] and out[-2:] == [True, True]
    finally:
        pair.close()
    got = [Norm(s)(get_json(s.filer.url + "/unix.txt?metadata=true")) for s in sides]
    assert got[1] == got[0] and len(got[1]["chunks"]) == 4


def test_unix_socket_listener_and_clients(tmp_path):
    """enable_unix_socket serves the TCP routes; http_request and PooledHTTP
    speak http+unix://; stop() removes the socket and unix_url."""
    svc = HTTPService("127.0.0.1", 0)

    @svc.route("POST", r"/echo/(.*)")
    def echo(req):
        return Response(req.match.group(1).encode() + b":" + req.body)

    sock = str(tmp_path / "svc.sock")
    svc.start()
    svc.enable_unix_socket(sock)
    pool = PooledHTTP()
    try:
        url = svc.unix_url
        assert url == "http+unix://" + sock.replace("/", "%2F")
        assert http_request("POST", url + "/echo/a?x=1", b"body")[::2] == (200, b"a:body")
        assert http_request("POST", svc.url + "/echo/b", b"tcp")[::2] == (200, b"b:tcp")
        for n in range(3):  # one keep-alive connection
            assert pool.request("POST", url + f"/echo/{n}", b"p")[::2] == (200, f"{n}:p".encode())
        assert len(pool._all) == 1
        assert http_request("GET", url + "/nothing")[0] == 404
    finally:
        pool.close()
        svc.stop()
    assert not os.path.exists(sock) and svc.unix_url is None


# --- the quota and mount.configure -------------------------------------------------------
def test_quota_enforced_and_configurable(tmp_path):
    """Writes ENOSPC past the quota, statfs advertises it, and a RUNNING
    mount is adjustable through `mount.configure` over its admin socket:
    the same answers from both packages."""
    tmp = str(tmp_path)
    with twin(tmp) as pair:
        got = []
        for i, (side, pkg) in enumerate(zip(pair, PKGS)):
            wfs_cls, kernel_cls, m, _, admin_fn, env_cls, run = pkg
            wfs = wfs_cls(side.filer.url, chunk_size=64 * 1024, quota_mb=1)
            k = kernel_cls(wfs)
            mp = f"{tmp}/mnt-{side.name}"
            admin = None
            try:
                err, ino, fh = k.create(1, "fill.bin")
                chunk = np.random.default_rng(79).bytes(64 * 1024)
                out = [err, [k.write(ino, fh, n * len(chunk), chunk) for n in range(20)],
                       k.flush(ino, fh), k.release(ino, fh)]
                wfs._refresh_usage()
                err, ino2, fh2 = k.create(1, "more.bin")
                out += [err, k.write(ino2, fh2, 0, b"x" * 1024), k.statfs()]
                admin = admin_fn(wfs, mp)
                env = env_cls(side.master.url, filer_url=side.filer.url)
                out += [run(env, f"mount.configure -dir {mp}").replace(mp, "MP"),
                        run(env, f"mount.configure -dir {mp} -quotaMB 100")]
                wfs._refresh_usage()
                out += [k.write(ino2, fh2, 0, b"x" * 1024), k.release(ino2, fh2), k.statfs()]
                try:
                    run(env, f"mount.configure -dir {mp}-absent")
                except Exception as e:  # each package's ShellError
                    out.append(str(e).replace(mp, "MP"))
                got.append(out)
            finally:
                if admin is not None:
                    admin.stop()
                wfs.meta.stop()
        assert got[1] == got[0]
        out = got[1]
        assert out[5] == (fp.ERRNO_NOSPC, 0)
        assert out[7] == f"mount MP: used {20 * 64 * 1024} / quota {1 << 20}"
        assert out[8] == f"quota set to {100 << 20} bytes"
        assert out[9] == (0, 1024) and "no running mount" in out[12]


@pytest.mark.skipif(
    not (os.path.exists("/dev/fuse") and os.geteuid() == 0),
    reason="real kernel mount needs /dev/fuse and root",
)
def test_kernel_mount_e2e(sides, tmp_path):
    import ctypes
    import threading

    side = sides[1]
    wfs = WFS(side.filer.url)
    mnt = str(tmp_path / "mnt")
    os.makedirs(mnt)
    fd = os.open("/dev/fuse", os.O_RDWR)
    libc = ctypes.CDLL(None, use_errno=True)
    ret = libc.mount(b"seaweedfs_tpu", mnt.encode(), b"fuse.seaweedfs_tpu", 0,
                     f"fd={fd},rootmode=40000,user_id=0,group_id=0".encode())
    if ret != 0:
        os.close(fd)
        pytest.skip("mount(2) refused (no CAP_SYS_ADMIN)")
    threading.Thread(target=wfs.serve, args=(fd,), daemon=True).start()
    try:
        os.mkdir(f"{mnt}/kdir")
        with open(f"{mnt}/kdir/f.txt", "w") as f:
            f.write("via the real kernel")
        assert open(f"{mnt}/kdir/f.txt").read() == "via the real kernel"
        os.rename(f"{mnt}/kdir/f.txt", f"{mnt}/kdir/g.txt")
        assert os.listdir(f"{mnt}/kdir") == ["g.txt"]
        assert get(side, "/kdir/g.txt") == (200, b"via the real kernel")
    finally:
        libc.umount2(mnt.encode(), 2)
