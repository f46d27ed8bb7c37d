"""The port's remote storage held against the JAX package's, case for case
with `tests/test_remote_storage.py` (the local vendor's CRUD and traversal,
the factory, `remote.mount` with read-through caching, `remote.uncache`,
`remote.cache`, `remote.meta.sync`, `remote.unmount` and the
`filer.remote.sync` write-back), plus `remote.mount.buckets`, the cached
entries' `md5` and chunks, a failed fetch's 502, and a filer store written
with a remote mount by one package and opened by the other's filer.

The filer cases run on `tests/test_torch_filer_meta.py::twin` (a JAX
cluster and a port cluster on `device="cpu"`, both filers at 4 KiB chunks).
Each side has its own `LocalRemoteStorage` root holding the same seeded
objects with the same mtimes; `RemotePair` runs each shell line through its
own package's shell (`{root}` is the side's root) and holds the answers
equal, and holds each filer answer (status and body) and each entry
(`?metadata=true` through `Norm`: addresses named, fids ranked, stamps
dropped) equal. The remote objects the write-back leaves are compared byte
for byte. Tolerance: byte equality after that normalization.

Left out of the mirror: nothing of `tests/test_remote_storage.py`.
`S3RemoteStorage` needs boto3, which neither package has; it stays gated.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import pytest

from seaweedfs_tpu.command.filer_sync import run_filer_remote_sync as ref_remote_sync
from seaweedfs_tpu.remote_storage import LocalRemoteStorage as RefLocal
from seaweedfs_tpu.remote_storage import make_remote_client as ref_make
from seaweedfs_tpu.server.filer import FilerServer as RefFilerServer
from seaweedfs_tpu.shell import CommandEnv as RefCommandEnv
from seaweedfs_tpu.shell import run_command as ref_run_command
from seaweedfs_tpu_torch.command.filer_sync import run_filer_remote_sync
from seaweedfs_tpu_torch.remote_storage import REMOTE_KEY, LocalRemoteStorage, make_remote_client
from seaweedfs_tpu_torch.server.filer import FilerServer
from seaweedfs_tpu_torch.server.httpd import get_json, http_request
from seaweedfs_tpu_torch.shell import CommandEnv, run_command

from .test_torch_filer_meta import CHUNK, Norm, twin
from ._threads import stop_history_loops  # noqa: F401

MTIME = 1_700_000_000.0
PKGS = (  # (local vendor, factory, CommandEnv, run_command, write-back, FilerServer)
    (RefLocal, ref_make, RefCommandEnv, ref_run_command, ref_remote_sync, RefFilerServer),
    (LocalRemoteStorage, make_remote_client, CommandEnv, run_command, run_filer_remote_sync,
     FilerServer),
)


# --- the vendor and the factory ---------------------------------------------------------
def test_crud_and_traverse(tmp_path):
    got = []
    for n, pkg in enumerate(PKGS):
        r = pkg[0](str(tmp_path / f"cloud{n}"))
        r.write_file("a/b.txt", b"beta")
        r.write_file("a/c/d.bin", b"delta")
        r.write_file("top.txt", b"top")
        out = [sorted((rel, size) for rel, size, _ in r.traverse("")), r.read_file("a/b.txt"),
               sorted(rel for rel, _, _ in r.traverse("a")), r.list_buckets()]
        r.delete_file("a/b.txt")
        r.delete_file("a/absent")
        out.append(sorted(rel for rel, _, _ in r.traverse("")))
        out.append(list(r.traverse("nothing")))
        got.append(out)
    assert got[1] == got[0]
    assert got[1][0] == [("a/b.txt", 4), ("a/c/d.bin", 5), ("top.txt", 3)]
    assert got[1][2] == ["b.txt", "c/d.bin"] and got[1][3] == ["a"]


def test_factory(tmp_path):
    for n, pkg in enumerate(PKGS):
        c = pkg[1]({"kind": "local", "root": str(tmp_path / f"x{n}")})
        assert c.kind == "local" and type(c).__name__ == "LocalRemoteStorage"
        with pytest.raises(ValueError, match="unknown remote storage kind 'martian'"):
            pkg[1]({"kind": "martian"})


# --- mounts on a filer -------------------------------------------------------------------
class RemotePair:
    def __init__(self, sides, tmp: str) -> None:
        self.sides = sides
        self.roots = [os.path.join(tmp, f"cloud-{s.name}") for s in sides]
        self.remotes = [pkg[0](root) for pkg, root in zip(PKGS, self.roots)]
        self.envs = [pkg[2](s.master.url, filer_url=s.filer.url) for pkg, s in zip(PKGS, sides)]
        self.norms = [Norm(s) for s in sides]

    def write(self, rel: str, data: bytes) -> None:
        for r in self.remotes:
            r.write_file(rel, data)
            os.utime(r._abs(rel), (MTIME, MTIME))

    def delete(self, rel: str) -> None:
        for r in self.remotes:
            r.delete_file(rel)

    def sh(self, line: str) -> str:
        got = []
        for pkg, env, root in zip(PKGS, self.envs, self.roots):
            try:
                got.append(pkg[3](env, line.replace("{root}", root)))
            except Exception as e:  # each package's ShellError or HTTP error
                got.append(f"error: {e}")
        got = [n.text(g.replace(root, "ROOT"))
               for n, g, root in zip(self.norms, got, self.roots)]
        assert got[1] == got[0], line
        return got[1]

    def get(self, path: str):
        got = [http_request("GET", s.filer.url + path)[::2] for s in self.sides]
        got = [(st, json.loads(b.replace(root.encode(), b"ROOT")) if st >= 400 else b)
               for (st, b), root in zip(got, self.roots)]
        assert got[1] == got[0], path
        return got[1]

    def meta(self, path: str) -> dict:
        got = [n(get_json(f"{s.filer.url}{path}?metadata=true"))
               for n, s in zip(self.norms, self.sides)]
        assert got[1] == got[0], path
        return got[1]

    def mounts(self) -> dict:
        got = [get_json(s.filer.url + "/__remote__/mounts") for s in self.sides]
        assert got[1] == got[0]
        return got[1]


@pytest.fixture(scope="module")
def rp(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("remote"))
    with twin(tmp) as sides:
        yield RemotePair(sides, tmp)


def test_mount_readthrough_uncache_cache(rp):
    big = np.random.default_rng(81).bytes(3 * CHUNK + 500)
    rp.write("photos/small.txt", b"tiny remote file")
    rp.write("photos/big.bin", big)
    rp.sh("remote.configure -name cloudy -kind local -root {root}")
    assert "2 entries synced" in rp.sh("remote.mount -dir /data -config cloudy -path photos")
    meta = rp.meta("/data/big.bin")
    assert meta["extended"][REMOTE_KEY] == "photos/big.bin" and not meta["chunks"]
    assert rp.get("/data/big.bin") == (200, big)
    meta = rp.meta("/data/big.bin")
    assert len(meta["chunks"]) == 4 and meta["attributes"]["md5"] == hashlib.md5(big).hexdigest()
    assert rp.sh("remote.uncache -dir /data") == "uncached 1 objects under /data"
    assert not rp.meta("/data/big.bin")["chunks"]
    assert rp.get("/data/big.bin") == (200, big)
    rp.sh("remote.uncache -dir /data")
    assert rp.sh("remote.cache -dir /data") == "cached 2 objects under /data"
    assert rp.meta("/data/small.txt")["content"]
    assert rp.sh("remote.cache -dir /data/big.bin") == "cached 1 objects under /data/big.bin"
    assert rp.get("/data/small.txt") == (200, b"tiny remote file")


def test_meta_sync_picks_up_new_files(rp):
    rp.write("sync/a.txt", b"first")
    rp.sh("remote.configure -name syncy -kind local -root {root}")
    rp.sh("remote.mount -dir /synced -config syncy -path sync")
    rp.write("sync/new.txt", b"appeared later")
    assert rp.sh("remote.meta.sync -dir /synced") == "synced 1 entries under /synced"
    assert rp.get("/synced/new.txt") == (200, b"appeared later")
    # a changed object drops its cache and reads anew
    rp.write("sync/a.txt", b"second version")
    for r in rp.remotes:
        os.utime(r._abs("sync/a.txt"), (MTIME + 10, MTIME + 10))
    assert rp.get("/synced/a.txt") == (200, b"second version")
    assert rp.sh("remote.meta.sync -dir /synced") == "synced 1 entries under /synced"
    assert rp.get("/synced/a.txt") == (200, b"second version")


def test_unmount(rp):
    rp.write("gone/x.txt", b"x")
    rp.sh("remote.configure -name gone -kind local -root {root}")
    rp.sh("remote.mount -dir /um -config gone -path gone")
    assert rp.sh("remote.unmount -dir /um") == "unmounted /um"
    assert rp.sh("remote.meta.sync -dir /um").startswith("error: ")
    assert rp.sh("remote.unmount -dir /um").startswith("error: ")
    assert rp.sh("remote.mount -dir /um2 -config nope").startswith("error: ")
    assert "/um" not in rp.mounts()["mounts"]


def test_remote_sync_writeback(rp):
    rp.write("wb/keep.txt", b"kept")
    rp.sh("remote.configure -name wb -kind local -root {root}")
    rp.sh("remote.mount -dir /wb -config wb -path wb")
    bodies = {f"/wb/local{n}.bin": np.random.default_rng([82, n]).bytes(int(s))
              for n, s in enumerate((10, CHUNK + 1, 3 * CHUNK))}
    for side in rp.sides:
        for path, body in bodies.items():
            assert http_request("PUT", side.filer.url + path, body)[0] == 201
    for pkg, side in zip(PKGS, rp.sides):
        assert pkg[4](["-filer", side.filer.url, "-dir", "/wb", "-once", "-timeAgo", "30"]) == 0
    for r in rp.remotes:
        for path, body in bodies.items():
            assert r.read_file("wb/" + path.rsplit("/", 1)[1]) == body
    for side in rp.sides:
        http_request("DELETE", side.filer.url + "/wb/local0.bin")
    for pkg, side in zip(PKGS, rp.sides):
        assert pkg[4](["-filer", side.filer.url, "-dir", "/wb", "-once", "-timeAgo", "5"]) == 0
    trees = [sorted((rel, r.read_file("wb/" + rel)) for rel, _, _ in r.traverse("wb"))
             for r in rp.remotes]
    assert trees[1] == trees[0]
    assert [rel for rel, _ in trees[1]] == ["keep.txt", "local1.bin", "local2.bin"]
    for pkg, side in zip(PKGS, rp.sides):
        assert pkg[4](["-filer", side.filer.url, "-dir", "/nomount", "-once"]) == 1


def test_mount_buckets(rp):
    for b in ("alpha", "beta"):
        for n in range(3):
            rp.write(f"{b}/o{n}.bin", np.random.default_rng([83, n]).bytes(100 * (n + 1)))
    rp.sh("remote.configure -name bk -kind local -root {root}")
    out = rp.sh("remote.mount.buckets -remote bk")
    assert out.startswith("mounted ") and "alpha" in out and "beta" in out
    mounts = rp.mounts()["mounts"]
    assert mounts["/buckets/alpha"] == {"config": "bk", "path": "alpha"}
    assert rp.get("/buckets/beta/o2.bin") == (200, np.random.default_rng([83, 2]).bytes(300))
    assert rp.sh("remote.mount.buckets").startswith("error: ")
    assert rp.sh("remote.mount.buckets -remote nope").startswith("error: ")


@pytest.mark.parametrize("seed", range(2))
def test_cached_entries_equal_reference(rp, seed):
    """Objects from 1 B to 6 chunks (inline ones too): the read-through
    entries and the `remote.cache` entries, md5 and chunks, equal, and
    each md5 is hashlib's."""
    rng = np.random.default_rng([seed, 84])
    sizes = [1, 2048, 2049, CHUNK, CHUNK + 1] + [int(rng.integers(1, 6 * CHUNK)) for _ in range(5)]
    bodies = {f"c{seed}/d{n % 2}/o{n}.bin": rng.bytes(s) for n, s in enumerate(sizes)}
    for rel, body in bodies.items():
        rp.write(rel, body)
    rp.sh(f"remote.configure -name ce{seed} -kind local -root {{root}}")
    rp.sh(f"remote.mount -dir /ce{seed} -config ce{seed} -path c{seed}")
    for n, (rel, body) in enumerate(bodies.items()):
        path = f"/ce{seed}" + rel[len(f"c{seed}"):]
        if n % 2:
            assert rp.get(path) == (200, body)
    rp.sh(f"remote.cache -dir /ce{seed}")
    for rel, body in bodies.items():
        meta = rp.meta(f"/ce{seed}" + rel[len(f"c{seed}"):])
        assert meta["attributes"]["md5"] == hashlib.md5(body).hexdigest()
        assert meta["attributes"]["file_size"] == len(body)
        assert bool(meta["content"]) == (len(body) <= 2048)


def test_failed_fetch_answers_502(rp):
    rp.write("lost/x.bin", b"soon gone")
    rp.sh("remote.configure -name lost -kind local -root {root}")
    rp.sh("remote.mount -dir /lost -config lost -path lost")
    rp.delete("lost/x.bin")
    status, body = rp.get("/lost/x.bin")
    assert status == 502 and body["error"].startswith("remote fetch: ")
    assert not rp.meta("/lost/x.bin")["chunks"]


@pytest.mark.parametrize("writer", [0, 1], ids=["jax_to_port", "port_to_jax"])
def test_store_written_by_other_package(rp, tmp_path, writer):
    """A filer of one package, on a sqlite store, configures a remote and
    mounts it, then stops; a filer of the other package opens that store:
    the mount is listed, a first read caches the object, and meta sync
    finds nothing new."""
    reader = 1 - writer
    root = str(tmp_path / "cloud")
    body = np.random.default_rng(85).bytes(2 * CHUNK + 7)
    LocalRemoteStorage(root).write_file("shared/obj.bin", body)
    db = str(tmp_path / "filer.db")
    side = rp.sides[writer]
    f = PKGS[writer][5](side.master.url, port=0, store_kind="sqlite", store_path=db,
                        **({"device": "cpu"} if writer else {}))
    f.start()
    try:
        env = PKGS[writer][2](side.master.url, filer_url=f.url)
        PKGS[writer][3](env, f"remote.configure -name shared -kind local -root {root}")
        assert "1 entries synced" in PKGS[writer][3](
            env, "remote.mount -dir /shared -config shared -path shared")
    finally:
        f.stop()
    side = rp.sides[reader]
    f = PKGS[reader][5](side.master.url, port=0, store_kind="sqlite", store_path=db,
                        **({"device": "cpu"} if reader else {}))
    f.chunk_size = CHUNK
    f.start()
    try:
        mounts = get_json(f.url + "/__remote__/mounts")
        assert mounts == {"mounts": {"/shared": {"config": "shared", "path": "shared"}},
                          "configs": {"shared": "local"}}
        stub = get_json(f.url + "/shared/obj.bin?metadata=true")
        assert stub["extended"][REMOTE_KEY] == "shared/obj.bin" and not stub["chunks"]
        assert http_request("GET", f.url + "/shared/obj.bin")[::2] == (200, body)
        cached = get_json(f.url + "/shared/obj.bin?metadata=true")
        assert len(cached["chunks"]) == 3
        assert cached["attributes"]["md5"] == hashlib.md5(body).hexdigest()
        env = PKGS[reader][2](side.master.url, filer_url=f.url)
        assert PKGS[reader][3](env, "remote.meta.sync -dir /shared") == \
            "synced 0 entries under /shared"
    finally:
        f.stop()
