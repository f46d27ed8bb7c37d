"""The port's dedup write path against the JAX package's, on the CPU: SW128
(goldens and the JAX native library), the span hashes of `HashService`, the
filer and its stores, `DedupIndex`, and `FilerServer._upload_chunks_cdc`
end to end over `bench.py`'s shifted-repeat stream at a small size. Inputs
are seeded numpy; the tolerance is exact bytes."""

import hashlib

import numpy as np
import pytest
import torch

from seaweedfs_tpu.filer import Entry as RefEntry
from seaweedfs_tpu.filer import FileChunk as RefFileChunk
from seaweedfs_tpu.filer import Filer as RefFiler
from seaweedfs_tpu.filer import filerstore as ref_stores
from seaweedfs_tpu.filer.dedup import DedupIndex as RefDedupIndex
from seaweedfs_tpu.ops.hash_service import HashService as RefHashService
from seaweedfs_tpu.util import compression as ref_compression
from seaweedfs_tpu_torch import native
from seaweedfs_tpu_torch.filer import Entry, FileChunk, Filer
from seaweedfs_tpu_torch.filer import filerstore
from seaweedfs_tpu_torch.filer.dedup import DEDUP_DIR, DedupIndex, copy_store
from seaweedfs_tpu_torch.filer.filer import FilerError
from seaweedfs_tpu_torch.ops.hash_service import HashService
from seaweedfs_tpu_torch.server.filer import FilerServer
from seaweedfs_tpu_torch.storage import crc as crc_cpu
from seaweedfs_tpu_torch.util import compression

# tests/test_hash_kernels.py::TestFast128.GOLDENS: the stability contract
GOLDENS = {
    b"": "33e3e03153b370ad09fc69b2f5458347",
    b"hello world": "c45b2fa4798b614d6ef52c3d1a90a788",
    b"hello worle": "d1ddba86ba4300cd658d38d5e1028a75",
}
SEED = bytes(range(7, 23))
# the small CDC geometry of tests/test_dedup.py (DEDUP_KW)
DEDUP_KW = dict(dedup_avg_bits=12, dedup_min=1024, dedup_max=16 * 1024)
# cut lists over a buffer of 300,000 bytes: none, one span, spans of 1, 63,
# 64 and 65 bytes, empty spans, a long tail
CUT_CASES = [
    [],
    [300_000],
    [1, 64, 128, 193, 258, 300_000],
    [0, 0, 5, 5, 4096, 4096, 300_000],
    [63, 64, 65, 4096, 100_001, 299_999],
]


def _rand(seed, n):
    return np.random.RandomState(seed).randint(0, 256, size=n).astype(np.uint8)


def _ref_lib():
    from seaweedfs_tpu.native import lib

    if lib is None or not hasattr(lib, "fast128_spans"):
        pytest.skip("the JAX package's native library is unavailable")
    return lib


# --- SW128 --------------------------------------------------------------------
class TestFast128:
    @pytest.mark.parametrize("data", list(GOLDENS))
    def test_golden_vectors(self, data):
        assert native.fast128(data).hex() == GOLDENS[data]
        assert native.fast128(np.frombuffer(data, np.uint8)).hex() == GOLDENS[data]

    def test_length_is_folded_in(self):
        assert native.fast128(b"\0" * 64) != native.fast128(b"\0" * 65)
        assert native.fast128(b"\0") != native.fast128(b"")
        assert native.fast128(b"\0" * 63) != native.fast128(b"\0" * 64)

    def test_seed_changes_every_key(self):
        for data in GOLDENS:
            assert native.fast128(data, SEED) != native.fast128(data)
        assert native.fast128(b"abc", SEED) != native.fast128(b"abc", SEED[::-1])
        with pytest.raises(ValueError):
            native.fast128(b"abc", b"short")

    @pytest.mark.parametrize("seed", [b"", SEED])
    @pytest.mark.parametrize("case", range(4))
    def test_spans_equal_jax(self, seed, case):
        lib = _ref_lib()
        rng = np.random.RandomState(100 + case)
        data = rng.randint(0, 256, size=int(rng.randint(1, 200_000))).astype(np.uint8)
        cuts = sorted(rng.randint(0, len(data), size=int(rng.randint(0, 40))).tolist())
        cuts.append(len(data))
        got = native.fast128_spans(data, cuts, seed)
        want = lib.fast128_spans(data, cuts, seed)
        assert got.shape == (len(cuts), 16)
        assert np.array_equal(got, want)
        assert native.fast128(data.tobytes(), seed) == lib.fast128(data.tobytes(), seed)

    def test_spans_equal_whole_buffers(self):
        data = _rand(3, 300_000)
        cuts = [63, 64, 65, 4096, 100_001, 300_000]
        spans = native.fast128_spans(data, cuts, SEED)
        prev = 0
        for i, cut in enumerate(cuts):
            assert spans[i].tobytes() == native.fast128(data[prev:cut].tobytes(), SEED)
            prev = cut

    def test_bad_cuts_raise(self):
        with pytest.raises(ValueError):
            native.fast128_spans(b"abcd", [5])
        with pytest.raises(ValueError):
            native.fast128_spans(b"abcd", [3, 2])
        with pytest.raises(ValueError):
            native.md5_spans(b"abcd", [2], [3])


# --- span hashes of the hash service --------------------------------------------
@pytest.fixture(scope="module")
def services():
    return HashService(device="cpu"), RefHashService(backend="native")


def _ranges(cuts):
    prev, out = 0, []
    for c in cuts:
        out.append((prev, c - prev))
        prev = c
    return out


class TestSpanHashes:
    @pytest.mark.parametrize("cuts", CUT_CASES)
    def test_span_keys_equal_jax(self, services, cuts):
        _ref_lib()
        svc, ref = services
        data = _rand(5, 300_000)
        for seed in (b"", SEED):
            got = svc.span_keys(memoryview(data.tobytes()), cuts, seed=seed)
            assert got == ref.span_keys(data, cuts, seed=seed)
            assert all(k[0] == "x" and len(k) == 33 for k in got)

    @pytest.mark.parametrize("cuts", CUT_CASES)
    def test_hash_spans_equal_jax_and_hashlib(self, services, cuts):
        _ref_lib()
        svc, ref = services
        data = _rand(6, 300_000)
        got = svc.hash_spans(data.tobytes(), cuts)
        assert got == ref.hash_spans(data, cuts)
        for (o, n), (md5, c) in zip(_ranges(cuts), got):
            piece = data[o : o + n].tobytes()
            assert md5 == hashlib.md5(piece).hexdigest()
            assert c == crc_cpu.crc32c(piece)

    @pytest.mark.parametrize("cuts", CUT_CASES)
    def test_md5_spans_equal_jax_and_hashlib(self, services, cuts):
        _ref_lib()
        svc, ref = services
        data = _rand(7, 300_000)
        ranges = _ranges(cuts)[::-1] + [(17, 1), (1000, 63), (2000, 64), (3000, 65)]
        got = svc.md5_spans(memoryview(data.tobytes()), ranges)
        assert got == ref.md5_spans(data, ranges)
        assert got == [hashlib.md5(data[o : o + n].tobytes()).hexdigest() for o, n in ranges]

    def test_many_spans_take_the_lockstep_lanes(self, services):
        """More than 16 spans of different lengths (the AVX-512 lanes where
        the CPU has them, the scalar core otherwise)."""
        svc, _ = services
        rng = np.random.RandomState(8)
        data = rng.randint(0, 256, size=1 << 20).astype(np.uint8)
        ranges = [(int(o), int(n)) for o, n in zip(rng.randint(0, 1 << 19, 100),
                                                   rng.randint(0, 1 << 19, 100))]
        got = svc.md5_spans(data, ranges)
        assert got == [hashlib.md5(data[o : o + n].tobytes()).hexdigest() for o, n in ranges]


# --- compression ----------------------------------------------------------------
@pytest.mark.parametrize("ext,mime", [
    ("", ""), (".txt", ""), (".gz", "text/plain"), ("", "application/json"),
    ("", "image/png"), (".PDF", ""), ("", "text/html; charset=utf-8"), (".bin", "video/mp4"),
])
def test_compressable_file_type_equals_jax(ext, mime):
    assert compression.is_compressable_file_type(ext, mime) == \
        ref_compression.is_compressable_file_type(ext, mime)
    text = b"the quick brown fox " * 100
    got, packed = compression.maybe_compress_data(text, mime, ext)
    want, ref_packed = ref_compression.maybe_compress_data(text, mime, ext)
    assert packed == ref_packed
    assert compression.decompress_data(got) == text == ref_compression.decompress_data(want)


# --- filer and stores ------------------------------------------------------------
def _stores(kind, tmp_path):
    if kind == "memory":
        return filerstore.MemoryStore(), ref_stores.MemoryStore()
    return (filerstore.SqliteStore(str(tmp_path / "port.db")),
            ref_stores.SqliteStore(str(tmp_path / "ref.db")))


def _file(cls, path, content=b"", size=0, chunks=()):
    chunk_cls = FileChunk if cls is Entry else RefFileChunk
    e = cls(full_path=path)
    e.attributes.mtime = e.attributes.crtime = 1_700_000_000.0
    e.attributes.mime = "application/octet-stream"
    e.attributes.file_size = size or len(content)
    e.content = content
    e.chunks = [chunk_cls(file_id=fid, offset=i * 100, size=100, etag=f"{i:032x}")
                for i, fid in enumerate(chunks)]
    return e


def _tree(filer) -> dict:
    """Every entry under the root, by path, without the times the filer
    stamps on the entries it makes."""
    out = {}
    pending = ["/"]
    while pending:
        d = pending.pop()
        for e in filer.list_entries(d, limit=1 << 20):
            rec = e.to_dict()
            for k in ("mtime", "crtime"):
                rec["attributes"].pop(k)
            if e.is_directory:
                pending.append(e.full_path)
            out[e.full_path] = rec
    return out


def _same_ops(filer, cls):
    filer.create_entry(_file(cls, "/a/b/one.txt", b"one"))
    filer.create_entry(_file(cls, "/a/b/two.bin", size=300, chunks=["3,01", "3,02", "4,03"]))
    filer.create_entry(_file(cls, "/a/c/three", b"3" * 40))
    filer.create_entry(_file(cls, "/top", b"t"))
    upd = filer.find_entry("/a/c/three")
    upd.content = b"updated"
    upd.attributes.file_size = 7
    filer.update_entry(upd)
    filer.rename("/a/c", "/a/d")
    freed = filer.delete_entry("/a/b", recursive=True)
    filer.create_entry(_file(cls, "/a/b/again", b"x"))
    return sorted(c.file_id for c in freed)


class TestFiler:
    @pytest.mark.parametrize("kind", ["memory", "sqlite"])
    def test_operations_equal_jax(self, kind, tmp_path):
        store, ref_store = _stores(kind, tmp_path)
        port, ref = Filer(store), RefFiler(ref_store)
        try:
            assert _same_ops(port, Entry) == _same_ops(ref, RefEntry) == ["3,01", "3,02", "4,03"]
            assert _tree(port) == _tree(ref)
            assert [e.name for e in port.list_entries("/a")] == ["b", "d"]
            assert port.find_entry("/a/d/three").content == b"updated"
            assert port.find_entry("/a/c/three") is None
            with pytest.raises(FilerError):
                port.delete_entry("/a")  # not empty, not recursive
            with pytest.raises(FilerError):
                port.create_entry(Entry(full_path="/a", is_directory=False))
        finally:
            port.close()
            ref.close()

    @pytest.mark.parametrize("kind", ["memory", "sqlite"])
    def test_events_equal_jax(self, kind, tmp_path):
        store, ref_store = _stores(kind, tmp_path)
        port, ref = Filer(store), RefFiler(ref_store)
        try:
            _same_ops(port, Entry)
            _same_ops(ref, RefEntry)

            def shape(ev):
                return (ev.directory, ev.old_entry.full_path if ev.old_entry else None,
                        ev.new_entry.full_path if ev.new_entry else None)

            got = [shape(ev) for ev in port.events_since(0)]
            assert got == [shape(ev) for ev in ref.events_since(0)]
            assert len(got) > 10
        finally:
            port.close()
            ref.close()

    def test_sqlite_store_reopens(self, tmp_path):
        path = str(tmp_path / "meta.db")
        f = Filer(filerstore.SqliteStore(path))
        f.create_entry(_file(Entry, "/x/y", b"kept"))
        f.close()
        again = Filer(filerstore.SqliteStore(path))
        try:
            assert again.find_entry("/x/y").content == b"kept"
            # the meta log's segments flushed at close live under /topics
            assert [e.name for e in again.list_entries("/")] == ["topics", "x"]
            assert again.list_entries("/topics/.system/log")
        finally:
            again.close()


# --- the dedup index ----------------------------------------------------------------
def _pin_seed(filer, cls, seed=SEED):
    e = cls(full_path=f"{DEDUP_DIR}/.seed")
    e.content = seed
    e.attributes.file_size = 16
    filer.create_entry(e)


class TestDedupIndex:
    @pytest.mark.parametrize("kind", ["memory", "sqlite"])
    def test_seed_persists_in_the_store(self, kind, tmp_path):
        store, _ = _stores(kind, tmp_path)
        f = Filer(store)
        try:
            first = DedupIndex(f).seed
            assert len(first) == 16
            assert DedupIndex(f).seed == first  # a new index on the same store
            assert f.find_entry(f"{DEDUP_DIR}/.seed").content == first
        finally:
            f.close()

    @pytest.mark.parametrize("kind", ["memory", "sqlite"])
    def test_operations_equal_jax(self, kind, tmp_path):
        store, ref_store = _stores(kind, tmp_path)
        port, ref = Filer(store), RefFiler(ref_store)
        try:
            _pin_seed(port, Entry)
            _pin_seed(ref, RefEntry)
            idx, ref_idx = DedupIndex(port), RefDedupIndex(ref)
            assert idx.seed == ref_idx.seed == SEED
            for i in (idx, ref_idx):
                i.insert("xaa01-10", {"fid": "3,01", "z": 0, "etag": "e1"})
                i.insert("mee-10", {"fid": "3,01", "p": "xaa01-10"})
                i.insert("xbb02-20", {"fid": "3,02", "z": 1, "etag": "e2"})
                i.remove("xaa01-10")
            assert idx.lookup("xbb02-20") == ref_idx.lookup("xbb02-20") == {
                "fid": "3,02", "z": 1, "etag": "e2"}
            assert idx.lookup("xaa01-10") is None and ref_idx.lookup("xaa01-10") is None
            assert sorted(idx.iter_records()) == sorted(ref_idx.iter_records())
            assert _tree(port) == _tree(ref)
        finally:
            port.close()
            ref.close()

    def test_lru_evicts_the_oldest(self):
        f = Filer()
        try:
            idx = DedupIndex(f, cache_size=2)
            for k in ("xa-1", "xb-1", "xc-1"):
                idx.insert(k, {"fid": k})
            assert list(idx._cache) == ["xb-1", "xc-1"]
            idx.lookup("xb-1")  # a hit moves to the newest end
            assert list(idx._cache) == ["xc-1", "xb-1"]
            assert idx.lookup("xa-1") == {"fid": "xa-1"}  # from the store
            assert list(idx._cache) == ["xb-1", "xa-1"]
            assert idx.stats() == {"hits": 0, "misses": 0, "bytes_saved": 0}
        finally:
            f.close()

    def test_copy_store_carries_the_jax_index(self, tmp_path):
        ref = RefFiler(ref_stores.SqliteStore(str(tmp_path / "ref.db")))
        try:
            _pin_seed(ref, RefEntry)
            ref_idx = RefDedupIndex(ref)
            ref_idx.insert("xcc03-30", {"fid": "5,03", "z": 0, "etag": "e3"})
            _same_ops(ref, RefEntry)
            port = Filer(filerstore.MemoryStore())
            copied = copy_store(ref.store, port.store)
            assert copied == len(_tree(ref)) + 1  # and the root
            assert _tree(port) == _tree(ref)
            idx = DedupIndex(port)
            assert idx.seed == SEED
            assert idx.lookup("xcc03-30") == {"fid": "5,03", "z": 0, "etag": "e3"}
            port.close()
        finally:
            ref.close()


# --- the slice as a whole ------------------------------------------------------------
class _Client:
    """The chunk uploader: fresh fids in upload order, no blob kept."""

    def __init__(self):
        self.uploads = []

    def upload(self, payload, replication="", collection="", ttl=""):
        self.uploads.append(len(payload))
        return {"fid": f"3,{len(self.uploads):x}00000000"}


def _stream(n_uploads, size, seed=9):
    """bench.py's bench_cdc_dedup stream: four base segments; upload i is
    segment (i // 2) % 4 when i is even, else segment (i // 3) % 4 rotated by
    1 + 37 * i % 4093 bytes."""
    rng = np.random.RandomState(seed)
    segs = [rng.randint(0, 256, size=size, dtype=np.uint8) for _ in range(4)]
    for i in range(n_uploads):
        if i % 2 == 0:
            yield segs[(i // 2) % 4].tobytes()
        else:
            shift = 1 + 37 * i % 4093
            src = segs[(i // 3) % 4]
            yield src[shift:].tobytes() + src[:shift].tobytes()


def _ref_server():
    from seaweedfs_tpu.server.filer import FilerServer as RefFilerServer

    srv = RefFilerServer("http://127.0.0.1:1", port=0, dedup=True, **DEDUP_KW)
    srv.client = _Client()
    _pin_seed(srv.filer, RefEntry)
    return srv


def _port_server(filer=None):
    f = filer or Filer(filerstore.MemoryStore())
    srv = FilerServer(f, _Client(), device="cpu", **DEDUP_KW)
    if filer is None:
        _pin_seed(f, Entry)
    return srv


def _chunk_rows(chunks):
    return [(c.file_id, c.offset, c.size, c.etag, c.is_compressed) for c in chunks]


class TestUploadPath:
    @pytest.mark.parametrize("mime", ["", "text/plain"])
    def test_stream_equals_jax(self, mime):
        _ref_lib()
        ref, port = _ref_server(), _port_server()
        try:
            for i, data in enumerate(_stream(12, 256 * 1024)):
                if mime:  # compressible bytes: the payloads are gzip
                    data = data.translate(bytes(b % 16 + 97 for b in range(256)))
                hits, saved = port.dedup_index.hits, port.dedup_index.bytes_saved
                got, got_md5 = port._upload_chunks_cdc(data, "", "", "", mime=mime)
                want, want_md5 = ref._upload_chunks_cdc(data, "", "", "", mime=mime)
                assert _chunk_rows(got) == _chunk_rows(want), f"upload {i}"
                assert got_md5 == want_md5 == hashlib.md5(data).hexdigest()
                assert sum(c.size for c in got) == len(data)
                if i == 0:
                    assert all(c.is_compressed == bool(mime) for c in got)
                if i >= 8 and i % 2 == 0:  # an exact repeat: every chunk a hit
                    assert port.dedup_index.hits - hits == len(got)
                if i % 2:  # a shifted repeat of a segment already seen
                    assert port.dedup_index.bytes_saved - saved >= 0.9 * len(data)
            assert port.dedup_index.stats() == ref.dedup_index.stats()
            assert port.client.uploads == ref.client.uploads
            keys = sorted(k for k, _ in port.dedup_index.iter_records())
            assert keys == sorted(k for k, _ in ref.dedup_index.iter_records())
            assert sorted(port.dedup_index.iter_records()) == \
                sorted(ref.dedup_index.iter_records())
            st = port.dedup_index.stats()
            assert st["hits"] > 0 and st["misses"] > 0 and st["bytes_saved"] > 0
        finally:
            ref.filer.close()
            port.filer.close()

    def test_repeats_within_one_upload_defer(self):
        """A chunk repeating inside one upload is uploaded once: the later
        occurrences wait for the first one's insert (the DEFER sentinel)."""
        _ref_lib()
        ref, port = _ref_server(), _port_server()
        try:
            seg = next(_stream(1, 128 * 1024))
            data = seg + seg + seg[:50_000]
            got, _ = port._upload_chunks_cdc(data, "", "", "")
            want, _ = ref._upload_chunks_cdc(data, "", "", "")
            assert _chunk_rows(got) == _chunk_rows(want)
            assert port.dedup_index.stats() == ref.dedup_index.stats()
            assert port.dedup_index.hits > 0
            assert len(port.client.uploads) == port.dedup_index.misses < len(got)
        finally:
            ref.filer.close()
            port.filer.close()

    def test_ttl_uploads_skip_the_index(self):
        _ref_lib()
        ref, port = _ref_server(), _port_server()
        try:
            data = next(_stream(1, 128 * 1024))
            for _ in range(2):
                got, _ = port._upload_chunks_cdc(data, "1d", "c", "001")
                want, _ = ref._upload_chunks_cdc(data, "1d", "c", "001")
                assert _chunk_rows(got) == _chunk_rows(want)
            assert port.dedup_index.hits == ref.dedup_index.hits == 0
            assert list(port.dedup_index.iter_records()) == []
        finally:
            ref.filer.close()
            port.filer.close()

    def test_store_copied_from_jax_dedups_the_next_upload(self, tmp_path):
        _ref_lib()
        ref = _ref_server()
        try:
            uploads = list(_stream(3, 256 * 1024))
            for data in uploads[:2]:
                ref._upload_chunks_cdc(data, "", "", "")
            target = Filer(filerstore.SqliteStore(str(tmp_path / "port.db")))
            copy_store(ref.filer.store, target.store)
            port = _port_server(target)
            try:
                assert port.dedup_index.seed == SEED
                # upload 2 is new: a miss per chunk; then upload 0 again, which
                # the JAX filer wrote: every chunk a hit on its fid and ETag
                _, _ = port._upload_chunks_cdc(uploads[2], "", "", "")
                misses = port.dedup_index.misses
                got, _ = port._upload_chunks_cdc(uploads[0], "", "", "")
                assert port.dedup_index.misses == misses
                assert port.dedup_index.hits == len(got)
                first, _ = _port_server()._upload_chunks_cdc(uploads[0], "", "", "")
                assert [c.etag for c in got] == [c.etag for c in first]
                assert {c.file_id for c in got} <= {
                    rec["fid"] for _, rec in ref.dedup_index.iter_records()}
            finally:
                target.close()
        finally:
            ref.filer.close()

    def test_empty_upload(self):
        port = _port_server()
        try:
            chunks, md5 = port._upload_chunks_cdc(b"", "", "", "")
            assert chunks == [] and md5 == hashlib.md5(b"").hexdigest()
        finally:
            port.filer.close()


def test_filer_server_needs_a_device(monkeypatch):
    """With no device and no CUDA the server raises; nothing runs on the
    CPU unless asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f = Filer()
    try:
        with pytest.raises(RuntimeError):
            FilerServer(f, _Client())
        assert FilerServer(f, _Client(), device="cpu").device.type == "cpu"
    finally:
        f.close()
