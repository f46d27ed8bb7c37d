"""The port's concurrency stress harness: the five cases of
`tests/test_concurrency_stress.py` over `seaweedfs_tpu_torch`, each run on
the JAX package too, on the same seeded work.

Many threads hammer shared structures and live servers while invariants
are checked, so interleaving bugs surface as assertion failures instead of
silent corruption. Where the end state does not depend on the
interleaving (the LSM store's per-writer keyspaces, the filer's
per-worker directories, the needle map once its writers are done and it
is replayed in one thread) the port's is held equal to the JAX package's
(tolerance 0); elsewhere each package must keep the same invariants. The
volume servers run behind their fastlane engines (`device="cpu"` on the
port's side).
"""

from __future__ import annotations

import contextlib
import os
import random
import threading

from seaweedfs_tpu.filer.entry import Entry as RefEntry
from seaweedfs_tpu.filer.filer import Filer as RefFiler
from seaweedfs_tpu.filer.filer import FilerError as RefFilerError
from seaweedfs_tpu.filer.lsm import LsmKV as RefLsmKV
from seaweedfs_tpu.filer.lsm import LsmStore as RefLsmStore
from seaweedfs_tpu.server.master import MasterServer as RefMasterServer
from seaweedfs_tpu.server.volume import VolumeServer as RefVolumeServer
from seaweedfs_tpu.storage.needle_map import CompactNeedleMap as RefCompactNeedleMap
from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.filer.filer import Filer, FilerError
from seaweedfs_tpu_torch.filer.lsm import LsmKV, LsmStore
from seaweedfs_tpu_torch.server.httpd import PooledHTTP, get_json, http_request
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.storage.file_id import format_needle_id_cookie
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.needle_map import CompactNeedleMap
from tests._threads import stop_history_loops  # noqa: F401

PKGS = ("ref", "port")


def run_threads(n, fn):
    errs = []

    def wrap(i):
        try:
            fn(i)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=wrap, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise errs[0]


# --- the needle map ------------------------------------------------------------
def _needle_map_ops(i: int) -> list[tuple]:
    rng = random.Random(i)
    ops = []
    for j in range(4000):
        key = rng.randrange(1, 20000)
        if rng.random() < 0.2:
            ops.append(("delete", key))
        else:
            ops.append(("put", key, ((i * 4000 + j) % 100000 + 1) * 8, 100))
    return ops


def _apply(m, op) -> None:
    if op[0] == "delete":
        m.delete(op[1])
    else:
        m.put(*op[1:])


def test_needle_map_readers_vs_writers_through_merges():
    """Four writers and three readers on one map, merging every 256
    entries: every read sees an aligned offset and the written size, and
    the full visit is sorted and as long as the map. The same ops, applied
    in one thread after the writers, leave the port's map equal to the JAX
    package's."""
    work = [_needle_map_ops(i) for i in range(4)]
    for cls in (RefCompactNeedleMap, CompactNeedleMap):
        m = cls()
        m.MERGE_THRESHOLD = 256  # force frequent merges under load
        stop = threading.Event()
        reader_errs: list[BaseException] = []

        def reader(m=m, stop=stop):
            rng = random.Random(99)
            try:
                while not stop.is_set():
                    got = m.get(rng.randrange(1, 20000))
                    if got is not None:
                        off, size = got
                        assert off % 8 == 0 and size == 100
            except BaseException as e:  # noqa: BLE001
                reader_errs.append(e)

        rts = [threading.Thread(target=reader) for _ in range(3)]
        for t in rts:
            t.start()
        try:
            run_threads(4, lambda i, m=m: [_apply(m, op) for op in work[i]])
        finally:
            stop.set()
            for t in rts:
                t.join()
        assert not reader_errs, reader_errs[0]
        keys = [k for k, _, _ in m.ascending_visit()]
        assert keys == sorted(keys)
        assert len(keys) == len(m)
    replayed = []
    for cls in (RefCompactNeedleMap, CompactNeedleMap):
        m = cls()
        m.MERGE_THRESHOLD = 256
        for ops in work:
            for op in ops:
                _apply(m, op)
        replayed.append(list(m.ascending_visit()))
    assert replayed[1] == replayed[0] and replayed[0]


# --- the LSM store -------------------------------------------------------------
def _lsm_worker(kv, i: int) -> None:
    rng = random.Random(i)
    for j in range(800):
        k = f"w{i}-{rng.randrange(200):03d}".encode()
        if rng.random() < 0.25:
            kv.delete(k)
        else:
            kv.put(k, f"{i}:{j}".encode())
        if rng.random() < 0.02:
            list(kv.scan(f"w{i}".encode(), f"w{i}~".encode()))


def test_lsm_concurrent_store_ops(tmp_path):
    """Six writers with disjoint keyspaces through flushes and compactions:
    the last write per key wins, the store reopens, and the port's final
    scan equals the JAX package's."""
    scans = []
    for pkg, cls in zip(PKGS, (RefLsmKV, LsmKV)):
        path = str(tmp_path / pkg)
        kv = cls(path, memtable_bytes=4096, max_tables=3)
        run_threads(6, lambda i, kv=kv: _lsm_worker(kv, i))
        for i in range(6):
            for k, v in kv.scan(f"w{i}".encode(), f"w{i}~".encode()):
                assert v.decode().startswith(f"{i}:"), (k, v)
        scans.append(list(kv.scan(b"w", b"x")))
        kv.close()
        kv2 = cls(path)  # reopen parses what the writers left
        assert list(kv2.scan(b"w", b"x")) == scans[-1]
        kv2.close()
    assert scans[1] == scans[0] and scans[0]


# --- the volume server behind its engine ---------------------------------------
@contextlib.contextmanager
def _volume_cluster(pkg: str, root):
    m_cls, v_cls = (RefMasterServer, RefVolumeServer) if pkg == "ref" else \
        (MasterServer, VolumeServer)
    dev = {} if pkg == "ref" else {"device": "cpu"}
    m = m_cls(port=0, pulse_seconds=1)
    m.start()
    try:
        v = v_cls([str(root / pkg)], m.url, port=0, pulse_seconds=1,
                  max_volume_count=20, **dev)
        v.start()
        try:
            assert v.fastlane is not None
            yield m, v
        finally:
            v.stop()
    finally:
        m.stop()


def _register_handoff(m, v, needle_cls) -> tuple[int, int]:
    """Python-path appends and deletes (what a proxied request runs), each
    read back at once through the engine's front door, while another thread
    re-runs the volume's engine registration underneath. Returns the
    (writes, deletes) made."""
    a = get_json(f"{m.url}/dir/assign")
    pub = a["publicUrl"]
    assert http_request("POST", f"http://{pub}/{a['fid']}", b"seed")[0] == 201
    vid = int(a["fid"].split(",")[0])
    vol = v.store.get_volume(vid)
    stop = threading.Event()
    counts = [[0, 0] for _ in range(3)]

    def mutator(i):
        base = 0x10000000 * (i + 1)
        j = 0
        while not stop.is_set() and j < 400:
            key, cookie = base + j, 0x1234ABCD
            j += 1
            vol.write_needle(needle_cls(cookie=cookie, id=key, data=b"r" * 64))
            counts[i][0] += 1
            fid = f"{vid},{format_needle_id_cookie(key, cookie)}"
            st, _, got = http_request("GET", f"http://{pub}/{fid}")
            assert st == 200 and got == b"r" * 64, (st, fid, "after write")
            if j % 3 == 0:
                vol.delete_needle(needle_cls(cookie=cookie, id=key))
                counts[i][1] += 1
                st, _, _ = http_request("GET", f"http://{pub}/{fid}")
                assert st == 404, (st, fid, "after delete")

    def churner():
        while not stop.is_set():
            v._fl_unregister(vid)
            v._fl_register(vid)

    ct = threading.Thread(target=churner)
    ct.start()
    try:
        run_threads(3, mutator)
    finally:
        stop.set()
        ct.join()
    return tuple(sum(c[k] for c in counts) for k in (0, 1))


def test_register_handoff_visibility(tmp_path):
    """A Python-path append or delete racing the engine's volume
    registration must never land between the bulk map snapshot and the
    hook installation (native GETs would 404 acked writes or serve acked
    deletes): the handoff window, hammered on both packages, with the same
    work done on each."""
    from seaweedfs_tpu.storage.needle import Needle as RefNeedle

    done = []
    for pkg, needle_cls in zip(PKGS, (RefNeedle, Needle)):
        with _volume_cluster(pkg, tmp_path) as (m, v):
            done.append(_register_handoff(m, v, needle_cls))
    assert done[1] == done[0] == (1200, 399)


def _write_read_delete(m) -> dict[str, bytes]:
    pool = PooledHTTP()
    written: dict[str, bytes] = {}
    lock = threading.Lock()

    def worker(i):
        rng = random.Random(i)
        local = []
        for _ in range(60):
            data = os.urandom(rng.randrange(100, 3000))
            a = get_json(f"{m.url}/dir/assign?count=1")
            url = f"http://{a['publicUrl']}/{a['fid']}"
            st, _, _ = pool.request("POST", url, data)
            assert st < 300, st
            local.append((url, data))
            # immediate read-back must match bit-for-bit
            st, _, got = pool.request("GET", url)
            assert st == 200 and got == data
            if rng.random() < 0.2 and local:
                durl, _ = local.pop(rng.randrange(len(local)))
                pool.request("DELETE", durl)
                st, _, _ = pool.request("GET", durl)
                assert st == 404
        with lock:
            written.update(dict(local))

    run_threads(8, worker)
    # everything not deleted is still byte-identical
    for url, data in written.items():
        st, _, got = pool.request("GET", url)
        assert st == 200 and got == data
    return written


def test_concurrent_write_read_delete(tmp_path):
    """Eight clients assign, write, read back and delete through the
    engines: every read matches, every delete 404s, and both packages keep
    the same number of live blobs (the deletes follow the seeded rngs)."""
    live = []
    for pkg in PKGS:
        with _volume_cluster(pkg, tmp_path) as (m, _v):
            live.append(len(_write_read_delete(m)))
    assert live[1] == live[0] > 0


# --- the filer's namespace -----------------------------------------------------
def _namespace_ops(f, entry_cls, error_cls) -> dict[str, list[str]]:
    def worker(i):
        rng = random.Random(i)
        for j in range(150):
            p = f"/load/d{i}/f{j % 40}.txt"
            op = rng.random()
            if op < 0.5:
                f.create_entry(entry_cls(full_path=p))
            elif op < 0.7:
                try:
                    f.delete_entry(p)
                except error_cls:
                    pass
            elif op < 0.9:
                f.find_entry(p)
            else:
                try:
                    f.rename(p, p + ".moved")
                except error_cls:
                    pass

    run_threads(6, worker)
    return {f"d{i}": [e.name for e in f.list_entries(f"/load/d{i}")] for i in range(6)}


def test_concurrent_namespace_ops(tmp_path):
    """Six workers create, delete, find and rename in their own
    directories of one LSM-backed filer: every listing terminates and is
    name-sorted, and the port's listings equal the JAX package's."""
    listings = []
    for pkg, filer_cls, store_cls, entry_cls, error_cls in (
            ("ref", RefFiler, RefLsmStore, RefEntry, RefFilerError),
            ("port", Filer, LsmStore, Entry, FilerError)):
        f = filer_cls(store_cls(str(tmp_path / pkg)))
        try:
            got = _namespace_ops(f, entry_cls, error_cls)
        finally:
            f.close()
        for names in got.values():
            assert names == sorted(names)
        listings.append(got)
    assert listings[1] == listings[0]
    assert any(listings[0].values())
