"""The port's volume side held byte for byte against the JAX package on the
same seeded inputs: file ids, the three needle maps over one .idx, a
Volume's write/overwrite/duplicate/delete/vacuum sequence (.dat and .idx
equal, reads and cookie errors equal), the Store with an online-EC volume
across a restart, and the port's VolumeServer over HTTP at device="cpu"
(open-shard reads, the seal's shards equal to the JAX writer's on the same
stream, degraded GETs with four data shards gone, /admin/ec/rebuild).
Tolerance 0 throughout. With no CUDA and no device given, Store,
OnlineEcWriter and VolumeServer raise and write no shard file.
"""

from __future__ import annotations

import itertools
import os
import shutil
import time
import types

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops.rs_kernel import RSCodec as RefCodec
from seaweedfs_tpu.storage import file_id as ref_file_id
from seaweedfs_tpu.storage import idx as ref_idx
from seaweedfs_tpu.storage import needle as ref_needle_mod
from seaweedfs_tpu.storage import needle_map as ref_needle_map
from seaweedfs_tpu.storage.erasure_coding import encoder as ref_encoder
from seaweedfs_tpu.storage.erasure_coding.online import OnlineEcWriter as RefWriter
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.store import Store as RefStore
from seaweedfs_tpu.storage.types import TTL as RefTTL
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu_torch.server import volume as server_mod
from seaweedfs_tpu_torch.server.httpd import get_json, http_request, post_json
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.storage import file_id, needle_map
from seaweedfs_tpu_torch.storage import needle as needle_mod
from seaweedfs_tpu_torch.storage.erasure_coding import encoder, geometry
from seaweedfs_tpu_torch.storage.erasure_coding.online import OnlineEcWriter
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.types import TTL
from seaweedfs_tpu_torch.storage.volume import NotFound, Volume
from tests._threads import stop_history_loops  # noqa: F401

BLOCK = 4096
LAST_MODIFIED = 1_700_000_000


@pytest.fixture
def clock(monkeypatch):
    """The same deterministic time_ns sequence for each package's needles."""
    for mod in (needle_mod, ref_needle_mod):
        ticks = itertools.count(1_700_000_000_000_000_000, 1_000)
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time_ns=lambda t=ticks: next(t)))


def same_files(a: str, b: str, exts) -> None:
    for ext in exts:
        pa, pb = a + ext, b + ext
        assert os.path.exists(pa) == os.path.exists(pb), ext
        if os.path.exists(pa):
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), f"{ext} differs from the JAX package's"


# --- file ids ------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_file_id_round_trip_equals_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        key = max(1, int(rng.integers(0, 1 << 62)) >> int(rng.integers(0, 62)))
        cookie = int(rng.integers(0, 1 << 32))
        vid = int(rng.integers(1, 1 << 20))
        s = file_id.format_needle_id_cookie(key, cookie)
        assert s == ref_file_id.format_needle_id_cookie(key, cookie)
        assert file_id.parse_needle_id_cookie(s) == (key, cookie)
        fid = f"{vid},{s}_{seed}"
        assert file_id.FileId.parse(fid) == file_id.FileId(vid, key + seed, cookie)
        ref = ref_file_id.FileId.parse(fid)
        got = file_id.FileId.parse(fid)
        assert (got.volume_id, got.key, got.cookie) == (ref.volume_id, ref.key, ref.cookie)
        assert str(got) == str(ref)
    for bad in ("1234", "0" * 25):
        with pytest.raises(ValueError):
            file_id.parse_needle_id_cookie(bad)
    with pytest.raises(ValueError):
        file_id.FileId.parse("nocomma")


# --- needle maps ---------------------------------------------------------------
def _seeded_idx(path: str, seed: int, n: int = 3000) -> None:
    """Puts, overwrites, deletes (with and without a kept offset) and an
    unwritten slot, written with the JAX package's entry encoder."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 500, size=n)
    with open(path, "wb") as f:
        for i, key in enumerate(keys):
            r = rng.random()
            if r < 0.15:
                f.write(ref_idx.entry_to_bytes(int(key), 8 * i * int(r < 0.05), -1))
            elif r < 0.17:
                f.write(ref_idx.entry_to_bytes(int(key), 0, 0))
            else:
                f.write(ref_idx.entry_to_bytes(int(key), 8 * (i + 1),
                                               int(rng.integers(1, 1 << 20))))


def _map_state(m) -> dict:
    return dict(
        visit=list(m.ascending_visit()), len=len(m), content=m.content_size(),
        files=m.metrics.file_count, max_key=m.metrics.maximum_key,
        gets=[m.get(k) for k in range(0, 520)],
        has=[k in m for k in range(0, 520)])


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("cls", ["NeedleMap", "CompactNeedleMap"])
def test_in_memory_maps_equal_reference(tmp_path, seed, cls, monkeypatch):
    for mod in (needle_map, ref_needle_map):  # exercise the sorted merges
        monkeypatch.setattr(mod.CompactNeedleMap, "MERGE_THRESHOLD", 64)
    for d in ("port", "ref"):
        (tmp_path / d).mkdir()
        _seeded_idx(str(tmp_path / d / "1.idx"), seed)
    port = getattr(needle_map, cls)(str(tmp_path / "port" / "1.idx"))
    ref = getattr(ref_needle_map, cls)(str(tmp_path / "ref" / "1.idx"))
    try:
        assert _map_state(port) == _map_state(ref)
        assert (port.metrics.deleted_count, port.metrics.deleted_bytes) == (
            ref.metrics.deleted_count, ref.metrics.deleted_bytes)
        rng = np.random.default_rng(seed + 10)
        for i in range(600):  # live puts, overwrites and deletes
            key = int(rng.integers(1, 700))
            if rng.random() < 0.3:
                port.delete(key, 8 * i)
                ref.delete(key, 8 * i)
            else:
                size = int(rng.integers(1, 5000))
                port.put(key, 8 * (i + 1), size)
                ref.put(key, 8 * (i + 1), size)
        assert _map_state(port) == _map_state(ref)
        assert port.metrics == ref.metrics or vars(port.metrics) == vars(ref.metrics)
        assert needle_map.needle_set_digest(port.ascending_visit()) == \
            ref_needle_map.needle_set_digest(ref.ascending_visit())
    finally:
        port.close()
        ref.close()
    same_files(str(tmp_path / "port" / "1"), str(tmp_path / "ref" / "1"), [".idx"])


@pytest.mark.parametrize("seed", range(3))
def test_sorted_file_map_and_index_arrays_equal_reference(tmp_path, seed):
    for d in ("port", "ref"):
        (tmp_path / d).mkdir()
        _seeded_idx(str(tmp_path / d / "1.idx"), seed)
    for a, b in zip(needle_map.read_index_arrays(str(tmp_path / "port" / "1.idx")),
                    ref_needle_map.read_index_arrays(str(tmp_path / "ref" / "1.idx"))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    port = needle_map.SortedFileNeedleMap(str(tmp_path / "port" / "1"))
    ref = ref_needle_map.SortedFileNeedleMap(str(tmp_path / "ref" / "1"))
    try:
        same_files(str(tmp_path / "port" / "1"), str(tmp_path / "ref" / "1"), [".sdx"])
        assert _map_state(port) == _map_state(ref)
        for key in range(0, 520, 7):
            port.delete(key)
            ref.delete(key)
        live = [k for k, _, _ in port.ascending_visit()][:5]
        for key in live:
            port.put(key, 8 * 4242, 77)
            ref.put(key, 8 * 4242, 77)
        assert _map_state(port) == _map_state(ref)
        with pytest.raises(NotImplementedError):
            port.put(100_000, 8, 1)
    finally:
        port.close()
        ref.close()
    same_files(str(tmp_path / "port" / "1"), str(tmp_path / "ref" / "1"), [".sdx"])


def test_needle_set_digest_equals_reference():
    rng = np.random.default_rng(5)
    entries = [(int(k), 8, int(s)) for k, s in
               zip(rng.integers(0, 1 << 60, 300), rng.integers(1, 1 << 20, 300))]
    assert needle_map.needle_set_digest(entries) == ref_needle_map.needle_set_digest(entries)
    assert needle_map.needle_set_digest([]) == needle_map.EMPTY_NEEDLE_DIGEST


# --- Volume --------------------------------------------------------------------
def _needle_pair(rng, nid: int, cookie: int, last_modified: int = LAST_MODIFIED):
    data = rng.integers(0, 256, size=int(rng.integers(0, 6000)), dtype=np.uint8).tobytes()
    port, ref = Needle(cookie=cookie, id=nid, data=data), RefNeedle(cookie=cookie, id=nid, data=data)
    for n in (port, ref):
        if nid % 3 == 0:
            n.name = f"file-{nid}.bin".encode()
            n.set_has_name()
        if nid % 4 == 0:
            n.mime = b"text/plain"
            n.set_has_mime()
        n.last_modified = last_modified
        n.set_has_last_modified()
    if nid % 5 == 0:
        port.ttl, ref.ttl = TTL.parse("3d"), RefTTL.parse("3d")
        port.set_has_ttl()
        ref.set_has_ttl()
    return port, ref


def _volume_ops(v, rv, seed: int) -> list:
    """One seeded sequence on both volumes; returns what each call gave
    (offsets, sizes, freed bytes and error names), port then JAX."""
    rng = np.random.default_rng(seed)
    out = []
    cookies: dict[int, int] = {}
    last: dict[int, bytes] = {}
    now = int(time.time())  # 3-day TTLs from now stay live for the test
    for step in range(160):
        r = rng.random()
        nid = int(rng.integers(1, 60))
        if r < 0.55 or nid not in cookies:  # write, overwrite or duplicate
            cookie = cookies.get(nid, int(rng.integers(0, 1 << 32)))
            if rng.random() < 0.1:
                cookie ^= 1  # a cookie mismatch on overwrite
            p, q = _needle_pair(rng, nid, cookie, now)
            if rng.random() < 0.2 and nid in cookies:  # a duplicate write
                for n in (p, q):
                    n.data = last[nid]
            res = []
            for vol, n in ((v, p), (rv, q)):
                try:
                    res.append(vol.write_needle(n, check_cookie=True))
                except Exception as e:  # noqa: BLE001 - compared by name
                    res.append(type(e).__name__)
            if not isinstance(res[0], str):
                cookies[nid] = cookie
                last[nid] = p.data
            out.append(res)
        elif r < 0.8:
            cookie = cookies[nid] ^ int(rng.random() < 0.2)
            res = []
            for vol in (v, rv):
                try:
                    res.append(vol.read_needle(nid, cookie=cookie).data)
                except Exception as e:  # noqa: BLE001
                    res.append(type(e).__name__)
            out.append(res)
        else:
            out.append([v.delete_needle(Needle(cookie=cookies[nid], id=nid)),
                        rv.delete_needle(RefNeedle(cookie=cookies[nid], id=nid))])
            cookies.pop(nid)
        if step == 100:
            for vol in (v, rv):
                vol.compact()
        if step == 130:
            for vol in (v, rv):
                vol.commit_compact()
    return out


@pytest.mark.parametrize("seed", range(3))
def test_volume_sequence_equals_reference(tmp_path, clock, seed):
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    v = Volume(str(tmp_path / "port"), "c", 3, ttl=TTL.parse("7d"))
    rv = RefVolume(str(tmp_path / "ref"), "c", 3, ttl=RefTTL.parse("7d"))
    try:
        results = _volume_ops(v, rv, seed) + _volume_ops(v, rv, seed + 100)
        for port_res, ref_res in results:
            assert port_res == ref_res
        # reads with a wrong cookie and overwrites with one both failed
        assert {"NotFound", "VolumeError"} <= {
            r for pair in results for r in pair if isinstance(r, str)}
        for name in ("size", "file_count", "deleted_count", "deleted_bytes",
                     "max_needle_id", "garbage_level", "content_size",
                     "needle_map_digest"):
            assert getattr(v, name)() == getattr(rv, name)(), name
        assert v.super_block.compaction_revision == rv.super_block.compaction_revision == 2
        for since in (0, 1_700_000_000_000_100_000, 1 << 62):
            assert v.binary_search_by_append_at_ns(since) == rv.binary_search_by_append_at_ns(since)
        v.cleanup_compact()
        rv.cleanup_compact()
    finally:
        v.close()
        rv.close()
    same_files(str(tmp_path / "port" / "c_3"), str(tmp_path / "ref" / "c_3"),
               [".dat", ".idx", ".cpd", ".cpx"])
    # both reopen each other's files: integrity check and last append time
    v = Volume(str(tmp_path / "ref"), "c", 3)
    rv = RefVolume(str(tmp_path / "port"), "c", 3)
    try:
        assert v.last_append_at_ns == rv.last_append_at_ns > 0
        assert list(v.nm.ascending_visit()) == list(rv.nm.ascending_visit())
    finally:
        v.close()
        rv.close()


def test_flipped_byte_on_classic_volume_raises_like_reference(tmp_path, clock):
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    errors = []
    for cls, needle_cls, d in ((Volume, Needle, "port"), (RefVolume, RefNeedle, "ref")):
        with open(os.devnull, "w"):
            vol = cls(str(tmp_path / d), "", 1)
        try:
            off, _ = vol.write_needle(needle_cls(cookie=1, id=9, data=b"x" * 500))
            with open(vol.base_name + ".dat", "r+b") as f:
                f.seek(off + 100)
                f.write(b"y")
            with pytest.raises(Exception) as ei:
                vol.read_needle(9)
            errors.append(type(ei.value).__name__)
        finally:
            vol.close()
    assert errors[0] == errors[1] == "CRCError"


def test_tiered_volume_does_not_open(tmp_path):
    encoder.save_volume_info(str(tmp_path / "1.vif"), files=[
        {"backend_id": "s3.default", "key": "1.dat", "file_size": 8}])
    with pytest.raises(Exception, match="not configured"):
        Volume(str(tmp_path), "", 1)
    assert not (tmp_path / "1.dat").exists()


# --- Store -----------------------------------------------------------------------
def test_store_online_volume_reattaches_after_restart(tmp_path, clock):
    dirs = (str(tmp_path / "port"), str(tmp_path / "ref"))
    store = Store([dirs[0]], device="cpu")
    ref = RefStore([dirs[1]])
    try:
        v = store.add_volume(5, "col", ec_online=True, ec_online_block=BLOCK)
        rv = ref.add_volume(5, "col", ec_online=True, ec_online_block=BLOCK)
        ref.get_volume(5).online_ec.codec = RefCodec(backend="numpy")
        assert v.online_ec.codec.device.type == "cpu"
        rng = np.random.default_rng(3)
        for nid in range(1, 40):
            p, q = _needle_pair(rng, nid, 0x1234)
            store.write(5, p)
            ref.write(5, q)
            v.online_ec.pump()
            rv.online_ec.pump()
        for nid in (1, 7, 39):
            assert store.read(5, nid).data == ref.read(5, nid).data
        with pytest.raises(NotFound):
            store.read(6, 1)
        assert store.delete(5, Needle(id=7)) == ref.delete(5, RefNeedle(id=7))
        hb, rhb = store.collect_heartbeat(), ref.collect_heartbeat()
        assert hb == rhb
        assert hb["volumes"][0]["ec_online"] is True
    finally:
        store.close()
        ref.close()
    exts = [".dat", ".idx", ".ecp", ".vif"] + [f".ec{i}" for i in range(10, 14)]
    same_files(os.path.join(dirs[0], "col_5"), os.path.join(dirs[1], "col_5"), exts)
    # a restart finds the unsealed ec_online policy in the .vif and
    # re-attaches the writer, which replays the journal
    store = Store([dirs[0]], device="cpu")
    try:
        v = store.get_volume(5)
        assert v.online_ec is not None and v.online_ec.block == BLOCK
        assert v.online_ec.codec.device.type == "cpu"
        assert v.online_ec.active and v.online_ec.journal_replays == 1
        v.readonly = True
        assert store.collect_heartbeat()["volumes"][0]["read_only"] is True
        store.delete_volume(5)
        assert store.get_volume(5) is None
        # parity shards go with an unsealed volume; the .vif stays, as in
        # the JAX package (its shard check runs before they are removed)
        assert sorted(os.listdir(dirs[0])) == ["col_5.vif"]
    finally:
        store.close()


# --- VolumeServer over HTTP ----------------------------------------------------
@pytest.fixture
def server(tmp_path, clock, monkeypatch):
    # the server stamps last_modified with time.time(): pin it
    monkeypatch.setattr(server_mod, "time", types.SimpleNamespace(time=lambda: LAST_MODIFIED))
    d = tmp_path / "port"
    d.mkdir()
    vs = VolumeServer([str(d)], device="cpu", pulse_seconds=3600)
    vs.start()
    yield vs, str(d)
    vs.stop()


def _post(url: str, data: bytes) -> int:
    status, _, out = http_request("POST", url, data,
                                  {"Content-Type": "application/octet-stream"})
    assert status == 201, out
    return status


def test_volume_server_online_ec_flow(server, tmp_path):
    vs, d = server
    u = vs.url
    assert post_json(u + "/admin/allocate_volume",
                     {"volume": 4, "ecOnline": True, "ecOnlineBlock": BLOCK}) == {"ok": True}
    # the JAX writer on the same needle stream
    rdir = tmp_path / "ref"
    rdir.mkdir()
    rv = RefVolume(str(rdir), "", 4)
    rw = RefWriter(rv, block_size=BLOCK, codec=RefCodec(backend="numpy"))
    rv.online_ec = rw
    rng = np.random.default_rng(11)
    written = {}
    try:
        for nid in range(1, 90):
            data = rng.integers(0, 256, size=int(rng.integers(100, 9000)),
                                dtype=np.uint8).tobytes()
            cookie = int(rng.integers(0, 1 << 32))
            fid = f"4,{file_id.format_needle_id_cookie(nid, cookie)}"
            _post(f"{u}/{fid}", data)
            n = RefNeedle(cookie=cookie, id=nid, data=data)
            n.last_modified = LAST_MODIFIED
            n.set_has_last_modified()
            rv.write_needle(n)
            rw.pump()
            written[fid] = data
        # 1. reads, a wrong cookie, a range, a HEAD
        for fid, data in written.items():
            status, headers, out = http_request("GET", f"{u}/{fid}")
            assert status == 200 and out == data
        fid, data = next(iter(written.items()))
        bad = fid[:-1] + ("0" if fid[-1] != "0" else "1")
        assert http_request("GET", f"{u}/{bad}")[0] == 404
        status, headers, out = http_request("GET", f"{u}/{fid}", headers={"Range": "bytes=3-9"})
        assert status == 206 and out == data[3:10]
        assert http_request("HEAD", f"{u}/{fid}")[0] == 200
        stats = get_json(u + "/status")["ec_online"]["4"]
        assert stats["active"] and stats["stripes"] == rw.stripes and not stats["fallbacks"]
        # 2. the open shards, data and parity, as the JAX writer serves them
        for shard in (0, 5, 10, 12, 13):
            for off in (0, BLOCK * 3 + 17):
                status, _, out = http_request(
                    "GET", f"{u}/admin/ec/shard?volume=4&shard={shard}&offset={off}&size=1000")
                assert status == 200 and out == rw.read_shard_range(shard, off, 1000)
        # a delete rides the stripe too
        dfid = list(written)[5]
        assert http_request("DELETE", f"{u}/{dfid}")[0] == 202
        dead = ref_file_id.FileId.parse(dfid)
        rv.delete_needle(RefNeedle(cookie=dead.cookie, id=dead.key))
        rw.pump()
        del written[dfid]
        assert http_request("GET", f"{u}/{dfid}")[0] == 404
        # 3. the seal: online, and every file equal to the JAX writer's
        assert post_json(u + "/admin/ec/generate", {"volume": 4})["online"] is True
        rw.seal()
        ref_encoder.write_sorted_file_from_idx(str(rdir / "4"))
    finally:
        rv.close()
    exts = [".dat", ".idx", ".vif", ".ecx"] + [geometry.to_ext(s) for s in range(14)]
    same_files(os.path.join(d, "4"), str(rdir / "4"), exts)
    assert http_request("POST", f"{u}/{list(written)[0]}", b"late")[0] == 500  # read only
    # 4. drop the source volume, lose data shards 0-3, remount: degraded GETs
    assert post_json(u + "/admin/ec/delete_volume", {"volume": 4}) == {"ok": True}
    assert not os.path.exists(os.path.join(d, "4.dat"))
    saved = tmp_path / "saved"
    saved.mkdir()
    for s in range(4):
        shutil.move(os.path.join(d, "4" + geometry.to_ext(s)), saved)
    assert post_json(u + "/admin/ec/mount", {"volume": 4})["shards"] == list(range(4, 14))
    for fid, data in written.items():
        status, _, out = http_request("GET", f"{u}/{fid}")
        assert status == 200 and out == data
    # 5. rebuild: the lost shards come back equal to the originals
    assert post_json(u + "/admin/ec/rebuild", {"volume": 4})["rebuilt"] == [0, 1, 2, 3]
    same_files(os.path.join(d, "4"), str(saved / "4"),
               [geometry.to_ext(s) for s in range(4)])
    # back to a volume, through the recorded uniform geometry
    assert post_json(u + "/admin/ec/unmount", {"volume": 4}) == {"ok": True}
    for s in (1, 8):
        os.unlink(os.path.join(d, "4" + geometry.to_ext(s)))
    assert post_json(u + "/admin/ec/to_volume", {"volume": 4})["size"] > 0
    for fid, data in list(written.items())[:10]:
        status, _, out = http_request("GET", f"{u}/{fid}")
        assert status == 200 and out == data


def test_volume_server_online_rebuild_and_refusals(server):
    vs, d = server
    u = vs.url
    # a replicated volume is allocated; with no master to name its other
    # holder, a write to it fails (the fan-out is all or nothing)
    assert http_request("POST", f"{u}/admin/allocate_volume", b'{"volume": 3, "replication": "001"}',
                        {"Content-Type": "application/json"})[0] == 200
    assert str(vs.store.get_volume(3).super_block.replica_placement) == "001"
    status, _, out = http_request("POST", f"{u}/3,{file_id.format_needle_id_cookie(1, 5)}", b"x")
    assert status == 500 and b"replicate lookup failed" in out
    post_json(u + "/admin/delete_volume", {"volume": 3})
    assert vs.store.get_volume(3) is None
    post_json(u + "/admin/allocate_volume", {"volume": 2, "ecOnline": True,
                                             "ecOnlineBlock": BLOCK})
    rng = np.random.default_rng(2)
    for nid in range(1, 40):
        _post(f"{u}/2,{file_id.format_needle_id_cookie(nid, 5)}", rng.bytes(3000))
    v = vs.store.get_volume(2)
    v.online_ec._tear_parity(0.5)
    assert vs.store.collect_heartbeat()["volumes"][0]["ec_online_parity_damaged"] == 1
    out = post_json(u + "/admin/ec/online/rebuild", {"volume": 2})
    assert out["active"] and out["rows"] > 0
    assert vs.store.collect_heartbeat()["volumes"][0]["ec_online_parity_damaged"] == 0
    assert http_request("GET", f"{u}/9,0100000005")[0] == 404
    assert http_request("GET", f"{u}/2,zz")[0] == 404  # no route
    assert http_request("POST", f"{u}/admin/ec/rebuild", b'{"volume": 9}')[0] == 404
    # the pulse pumps an aged partial row: the timed trickle flush
    w = v.online_ec
    w.flush_age = 0.0
    _post(f"{u}/2,{file_id.format_needle_id_cookie(99, 5)}", b"tail" * 100)
    vs._pump_online_ec()
    assert w._partial > 0 and w.fallbacks.get("trickle_flush")


# --- no CUDA -------------------------------------------------------------------
def test_no_cuda_raises_and_writes_no_shard(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        Store([str(tmp_path / "a")])
    with pytest.raises(RuntimeError):
        VolumeServer([str(tmp_path / "a")])
    v = Volume(str(tmp_path), "", 1)
    try:
        with pytest.raises(RuntimeError):
            OnlineEcWriter(v)
    finally:
        v.close()
    assert sorted(os.listdir(tmp_path)) == ["1.dat", "1.idx"]
