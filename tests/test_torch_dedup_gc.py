"""The port filer's dedup reclaim (`FilerServer.dedup_gc`, `/__dedup__/*`)
held against the JAX package's on one write/delete history.

A JAX and a port `FilerServer(dedup=True)` (device="cpu"), each with the
same pinned SW128 seed and a test-local blob client (fids in upload order,
blobs kept, deletes recorded), take `bench.py`'s shifted-repeat stream at a
small size, then lose every upload built from segments 0 and 1. Compared:
the gc results, the surviving index records, the deleted fids, a second
gc, and the bytes reclaimed against an independent count from the
entries' metadata (the sizes of fids that only deleted files referenced).

A gc racing an upload of the same content is driven at the two points
that matter, in both packages: a hit landing after the namespace walk but
before the decision keeps its fid, and a hit arriving after its key was
condemned re-uploads. Either way the new file never holds a deleted fid.
Also: an unresolvable manifest aborts the gc with nothing dropped, an
orphaned shadow is swept, the routes answer alike, and a filer restarted on
the same leveldb store dedups a re-upload fully. Tolerance: byte equality.
"""

from __future__ import annotations

import hashlib
import json

import pytest

from seaweedfs_tpu.filer import Entry as RefEntry
from seaweedfs_tpu.filer import FileChunk as RefFileChunk
from seaweedfs_tpu_torch.filer import Entry, FileChunk, Filer
from seaweedfs_tpu_torch.filer import filerstore
from seaweedfs_tpu_torch.server.filer import FilerServer
from seaweedfs_tpu_torch.server.httpd import http_request

from .test_torch_dedup import DEDUP_KW, _pin_seed, _ref_lib, _stream

SIZE = 128 * 1024


class BlobClient:
    """The chunk store: fresh fids in upload order, blobs kept, deletes
    recorded; a fetch of a missing fid fails like a 404."""

    def __init__(self) -> None:
        self.blobs: dict[str, bytes] = {}
        self.deleted: list[str] = []
        self.n = 0

    def upload(self, payload, replication="", collection="", ttl=""):
        self.n += 1
        fid = f"3,{self.n:x}00000000"
        self.blobs[fid] = bytes(payload)
        return {"fid": fid}

    def fetch(self, file_id, range_header=None):
        if file_id not in self.blobs:
            raise IOError(f"fetch {file_id}: 404")
        return self.blobs[file_id]

    def delete(self, file_id):
        self.deleted.append(file_id)
        self.blobs.pop(file_id, None)


class Side:
    def __init__(self, name, srv, entry_cls, chunk_cls) -> None:
        self.name = name
        self.srv = srv
        self.Entry = entry_cls
        self.FileChunk = chunk_cls

    @property
    def client(self) -> BlobClient:
        return self.srv.client

    def put(self, path: str, data: bytes):
        """`_do_write`'s chunked branch: cut, upload, create the entry."""
        chunks, md5 = self.srv._upload_chunks_cdc(data, "", "", "")
        e = self.Entry(full_path=path)
        e.attributes.file_size = len(data)
        e.attributes.md5 = md5
        e.chunks = chunks
        self.srv.filer.create_entry(e)
        return chunks

    def delete(self, path: str) -> None:
        """`_do_delete`: the entry, then the reclaim of its chunks."""
        self.srv._reclaim_chunks(self.srv.filer.delete_entry(path))

    def read(self, path: str) -> bytes:
        e = self.srv.filer.find_entry(path)
        return b"".join(self.client.blobs[c.file_id] for c in e.chunks)

    def age(self) -> None:
        """Step past the gc's 1 s recently-referenced window."""
        self.srv._dedup_recent = {f: 0.0 for f in self.srv._dedup_recent}


def _ref_side(dedup: bool = True) -> Side:
    from seaweedfs_tpu.server.filer import FilerServer as RefFilerServer

    srv = RefFilerServer("http://127.0.0.1:1", port=0, dedup=dedup, **DEDUP_KW)
    srv.client = BlobClient()
    _pin_seed(srv.filer, RefEntry)
    return Side("ref", srv, RefEntry, RefFileChunk)


def _port_side(dedup: bool = True) -> Side:
    srv = FilerServer(filer=Filer(filerstore.MemoryStore()), client=BlobClient(), port=0,
                      device="cpu", dedup=dedup, **DEDUP_KW)
    _pin_seed(srv.filer, Entry)
    return Side("port", srv, Entry, FileChunk)


@pytest.fixture
def sides():
    _ref_lib()
    ref, port = _ref_side(), _port_side()
    yield ref, port
    ref.srv.filer.close()
    port.srv.filer.close()


def _segment(i: int) -> int:
    """The base segment upload i of `_stream` is built from."""
    return (i // 2) % 4 if i % 2 == 0 else (i // 3) % 4


def _history(side: Side, n: int = 12) -> tuple[dict, dict]:
    """Write the stream, then delete every upload of segments 0 and 1.
    Returns (the deleted files' chunks, the survivors' data)."""
    uploads = list(_stream(n, SIZE))
    chunks = {f"/d/{i}": side.put(f"/d/{i}", data) for i, data in enumerate(uploads)}
    gone = {p: c for p, c in chunks.items() if _segment(int(p.rsplit("/", 1)[1])) < 2}
    for p in gone:
        side.delete(p)
    kept = {f"/d/{i}": data for i, data in enumerate(uploads) if f"/d/{i}" not in gone}
    return gone, kept


def _expected(side: Side, gone: dict) -> tuple[int, int]:
    """(fids, bytes) only deleted files referenced, from their metadata."""
    live = {c.file_id for p in side.srv.filer.list_entries("/d", limit=1 << 20)
            for c in p.chunks}
    sizes = {c.file_id: c.size for cs in gone.values() for c in cs if c.file_id not in live}
    return len(sizes), sum(sizes.values())


def _records(side: Side) -> list:
    return sorted(side.srv.dedup_index.iter_records())


def test_gc_equals_reference(sides):
    got = []
    for side in sides:
        gone, kept = _history(side)
        assert side.client.deleted == []  # dedup'd blobs outlive their entries
        side.age()
        want = _expected(side, gone)
        out = side.srv.dedup_gc()
        assert (out["dropped"], out["bytes_freed"], out["errors"]) == (*want, 0)
        for p, data in kept.items():
            assert side.read(p) == data
        again = side.srv.dedup_gc()
        assert again["dropped"] == again["errors"] == 0
        got.append((out, again, _records(side), list(side.client.deleted), want))
    assert got[0] == got[1]
    out, _, records, deleted, (n_fids, n_bytes) = got[1]
    assert n_fids > 0 and n_bytes > 0 and len(deleted) == n_fids
    assert out["scanned"] > len(records)


def test_reupload_after_gc_uploads_again(sides):
    got = []
    for side in sides:
        gone, _ = _history(side, n=6)
        side.age()
        side.srv.dedup_gc()
        data = next(_stream(1, SIZE))  # upload 0: segment 0, collected
        misses, uploads = side.srv.dedup_index.misses, side.client.n
        chunks = side.put("/again", data)
        assert side.srv.dedup_index.misses > misses and side.client.n > uploads
        assert side.read("/again") == data
        assert not {c.file_id for c in chunks} & set(side.client.deleted)
        got.append(([(c.offset, c.size, c.etag) for c in chunks], _records(side)))
    assert got[0] == got[1]


@pytest.mark.parametrize("when", ["before_decision", "after_condemn"])
def test_gc_racing_an_upload_never_hands_out_a_deleted_fid(sides, when, monkeypatch):
    """The same content is uploaded again while the gc runs: between the
    walk and the decision (the hit pins its fid, the gc keeps it), or
    right after the gc condemned and removed the first key (the upload sees
    the key condemned and uploads anew)."""
    got = []
    for side in sides:
        data = next(_stream(1, SIZE))
        side.put("/first", data)
        side.delete("/first")
        side.age()
        idx = side.srv.dedup_index
        fired = []

        def race():
            if not fired:
                fired.append(side.put("/second", data))

        if when == "before_decision":
            orig = idx.iter_records

            def iter_records():
                race()
                return orig()

            monkeypatch.setattr(idx, "iter_records", iter_records)
        else:
            orig = idx.remove

            def remove(key):
                orig(key)
                race()

            monkeypatch.setattr(idx, "remove", remove)
        out = side.srv.dedup_gc()
        chunks = fired[0]
        assert side.read("/second") == data
        assert not {c.file_id for c in chunks} & set(side.client.deleted)
        monkeypatch.undo()
        side.age()
        after = side.srv.dedup_gc()  # nothing /second holds goes
        assert side.read("/second") == data
        got.append((out, after, [(c.file_id, c.size, c.etag) for c in chunks],
                    list(side.client.deleted), idx.hits, idx.misses))
    assert got[0] == got[1]
    out = got[1][0]
    if when == "before_decision":
        assert out["dropped"] == 0 and got[1][4] > 0  # every chunk a kept hit
    else:
        assert out["dropped"] > 0 and got[1][5] > len(got[1][2])  # uploaded anew


def test_unresolvable_manifest_aborts_the_gc(sides):
    got = []
    for side in sides:
        _history(side, n=4)
        side.age()
        e = side.Entry(full_path="/m/broken")
        e.chunks = [side.FileChunk(file_id="9,ffff00000000", offset=0, size=100,
                                   is_chunk_manifest=True)]
        side.srv.filer.create_entry(e)
        before = _records(side)
        out = side.srv.dedup_gc()
        assert _records(side) == before and side.client.deleted == []
        got.append(out)
    assert got[0] == got[1]
    assert got[1]["error"].startswith("namespace walk failed, gc aborted")
    assert got[1]["dropped"] == 0 and got[1]["errors"] == 1


def test_orphan_shadow_is_swept(sides):
    got = []
    for side in sides:
        side.put("/o", next(_stream(1, SIZE)))
        idx = side.srv.dedup_index
        shadow = "m" + "ab" * 16 + "-400"
        idx.insert(shadow, {"fid": "3,dead00000000", "p": "nope-400"})
        side.age()
        out = side.srv.dedup_gc()
        assert idx.lookup(shadow) is None
        got.append((out, _records(side), side.client.deleted))
    assert got[0] == got[1] and got[1][0]["dropped"] == 0 and got[1][2] == []


# --- the routes ----------------------------------------------------------------------
def test_routes_equal_reference(monkeypatch):
    """`/__dedup__/stats` and `/__dedup__/gc` over HTTP, on a dedup filer
    and on a plain one, after two PUTs of the same content and their
    DELETEs."""
    _ref_lib()
    monkeypatch.setenv("SEAWEEDFS_TPU_DISABLE_FASTLANE", "1")
    made = [(_ref_side(), _ref_side(dedup=False)), (_port_side(), _port_side(dedup=False))]
    answers = []
    try:
        for side, plain in made:
            side.srv.start()
            plain.srv.start()
            base, off = side.srv.url, plain.srv.url
            data = next(_stream(1, SIZE))
            calls = [http_request("PUT", f"{base}/r/a.bin", data),
                     http_request("PUT", f"{base}/r/b.bin", data),
                     http_request("GET", f"{base}/__dedup__/stats")]
            http_request("DELETE", f"{base}/r/a.bin")
            http_request("DELETE", f"{base}/r/b.bin")
            side.age()
            calls += [http_request("POST", f"{base}/__dedup__/gc", b""),
                      http_request("GET", f"{off}/__dedup__/stats"),
                      http_request("POST", f"{off}/__dedup__/gc", b"")]
            answers.append([(st, json.loads(b)) for st, _, b in calls])
    finally:
        for side, plain in made:
            side.srv.stop()
            plain.srv.stop()
    assert answers[0] == answers[1]
    put, put2, stats, gc, off_stats, off_gc = answers[1]
    assert put[1]["md5"] == hashlib.md5(next(_stream(1, SIZE))).hexdigest()
    assert stats[1]["enabled"] and stats[1]["hits"] > 0
    assert gc[0] == 200 and gc[1]["dropped"] > 0 and gc[1]["errors"] == 0
    assert off_stats == (200, {"enabled": False})
    assert off_gc == (400, {"error": "dedup not enabled"})


@pytest.mark.parametrize("kind", ["leveldb", "lsm"])
def test_restarted_filer_on_the_same_store_dedups_fully(tmp_path, kind):
    """A filer stopped and started again on its store directory finds every
    chunk of a re-upload in the index it persisted: no miss."""
    _ref_lib()
    client = BlobClient()
    data = list(_stream(2, SIZE))

    def start():
        return FilerServer(store_kind=kind, store_path=str(tmp_path / kind), client=client, port=0,
                           device="cpu", dedup=True, **DEDUP_KW)

    srv = start()
    side = Side("port", srv, Entry, FileChunk)
    first = [side.put(f"/k/{i}", d) for i, d in enumerate(data)]
    srv.filer.close()
    again = Side("port", start(), Entry, FileChunk)
    try:
        chunks = again.put("/k/again", data[1])
        idx = again.srv.dedup_index
        assert idx.misses == 0 and idx.hits == len(chunks)
        assert [c.file_id for c in chunks] == [c.file_id for c in first[1]]
        assert again.read("/k/again") == data[1]
    finally:
        again.srv.filer.close()
