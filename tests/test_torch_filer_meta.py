"""The port filer's metadata routes held against the JAX package's, side by
side: the `/__meta__/events` feed (pages by `since_ns` and `limit`, and the
`wait` long poll), the payloads a `MetaSubscriber` and a `MetaAggregator`
receive, `/__meta__/notify` into a test-local queue, and the two metadata
rewrites, `/__meta__/change_volume_id` and `/__meta__/merge_volumes` (dry
run and apply).

`twin()` runs a JAX cluster (master, one volume server, filers; the native
front door off with SEAWEEDFS_TPU_DISABLE_FASTLANE=1, so its Python
handlers answer) and a port cluster (`device="cpu"`) in this process, each
with volume 1 allocated before any write so every chunk lands in it. Both
filers take `chunk_size = 4096`. The same requests go to both, one at a
time.

`Norm` makes the two sides comparable: addresses become names (m, v0,
f0, ...), fids become `<vid>,#<n>` by order of first appearance (keys and
cookies are the masters' own), and the stamps that differ by design are
dropped: times (`mtime`, `crtime`, `ts_ns`, `modified_ts_ns`,
`next_ts_ns`), filer signatures, and a hard link's random id (kept as its
presence). Everything else must be equal, byte for byte.
"""

from __future__ import annotations

import contextlib
import json
import re
import tempfile
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.filer import meta_aggregator as ref_meta
from seaweedfs_tpu.server.filer import FilerServer as RefFilerServer
from seaweedfs_tpu.server.master import MasterServer as RefMasterServer
from seaweedfs_tpu.server.volume import VolumeServer as RefVolumeServer
from seaweedfs_tpu_torch.filer import meta_aggregator as port_meta
from seaweedfs_tpu_torch.server.filer import FilerServer
from seaweedfs_tpu_torch.server.httpd import get_json, http_request, post_json
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from tests._threads import stop_history_loops  # noqa: F401

CHUNK = 4096
VOLATILE = {"mtime", "crtime", "ts_ns", "modified_ts_ns", "next_ts_ns",
            "signature", "signatures", "expires_at", "last_seen", "created_ts"}
FID = re.compile(r"\b(\d+),([0-9a-f]{9,}(?:_\d+)?)\b")


class Side:
    """One cluster: its package name, master, volume server and filers."""

    def __init__(self, name, master, vol, filers) -> None:
        self.name = name
        self.master = master
        self.vol = vol
        self.filers = filers

    @property
    def filer(self):
        return self.filers[0]

    def req(self, method: str, path: str, body: bytes | None = None,
            headers: dict | None = None, filer: int = 0):
        return http_request(method, self.filers[filer].url + path, body, headers)

    def allocate(self, vid: int) -> None:
        post_json(f"{self.vol.url}/admin/allocate_volume", {"volume": vid})
        self.vol.heartbeat_once()


class Norm:
    """Names a side's addresses and ranks its fids by first appearance."""

    def __init__(self, side: Side) -> None:
        self.names = {side.master.url.split("//")[-1]: "m",
                      side.vol.url.split("//")[-1]: "v0"}
        for i, f in enumerate(side.filers):
            self.names[f.url.split("//")[-1]] = f"f{i}"
        self.fids: dict[str, str] = {}

    def fid(self, vid: str, rest: str) -> str:
        key = f"{vid},{rest}"
        if key not in self.fids:
            self.fids[key] = f"{vid},#{len(self.fids)}"
        return self.fids[key]

    def text(self, s: str) -> str:
        for addr, name in self.names.items():
            s = s.replace(addr, name)
        return FID.sub(lambda m: self.fid(m.group(1), m.group(2)), s)

    def __call__(self, obj):
        if isinstance(obj, dict):
            out = {}
            for k, v in obj.items():
                if k in VOLATILE:
                    continue
                if k == "hard_link_id":
                    v = bool(v)
                out[k] = self(v)
            return out
        if isinstance(obj, (list, tuple)):
            return [self(v) for v in obj]
        if isinstance(obj, str):
            return self.text(obj)
        return obj


def _ref_servers(tmp, n_filers, filer_kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAWEEDFS_TPU_DISABLE_FASTLANE", "1")
        m = RefMasterServer(port=0, pulse_seconds=1)
        m.start()
        v = RefVolumeServer([tempfile.mkdtemp(dir=tmp)], m.url, port=0,
                            pulse_seconds=1, max_volume_count=20)
        v.start()
        side = Side("ref", m, v, [])
        side.allocate(1)
        for i in range(n_filers):
            kw = dict(filer_kw("ref", i))
            if i:
                kw["peers"] = [side.filers[0].url]
            f = RefFilerServer(m.url, port=0, **kw)
            f.chunk_size = CHUNK
            f.start()
            side.filers.append(f)
    return side


def _port_servers(tmp, n_filers, filer_kw):
    m = MasterServer(port=0, pulse_seconds=1)
    m.start()
    v = VolumeServer([tempfile.mkdtemp(dir=tmp)], m.url, port=0, pulse_seconds=1,
                     max_volume_count=20, device="cpu")
    v.start()
    side = Side("port", m, v, [])
    side.allocate(1)
    for i in range(n_filers):
        kw = dict(filer_kw("port", i))
        if i:
            kw["peers"] = [side.filers[0].url]
        f = FilerServer(m.url, port=0, device="cpu", **kw)
        f.chunk_size = CHUNK
        f.start()
        side.filers.append(f)
    return side


@contextlib.contextmanager
def twin(tmp, n_filers: int = 1, filer_kw=lambda side, i: {}):
    """(JAX side, port side). A second filer names the first as its peer,
    and the first learns of the second (static peers both ways, like
    `-peers` flags), so both lock rings hold both."""
    sides = []
    try:
        sides.append(_ref_servers(tmp, n_filers, filer_kw))
        sides.append(_port_servers(tmp, n_filers, filer_kw))
        for side in sides:
            if n_filers > 1:
                side.filers[0].lock_ring.set_servers([f.url for f in side.filers])
        yield tuple(sides)
    finally:
        for side in reversed(sides):
            for f in reversed(side.filers):
                f.stop()
            side.vol.stop()
            side.master.stop()


def seeded(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).bytes(n)


def history(side: Side, root: str) -> list:
    """The same writes, moves, links and deletes; each answer kept."""
    steps = [
        ("POST", f"{root}/dir?mkdir=true", b""),
        ("PUT", f"{root}/dir/small.txt", seeded(100, 1)),
        ("PUT", f"{root}/dir/big.bin", seeded(3 * CHUNK + 123, 2)),
        ("PUT", f"{root}/other/x.bin", seeded(5000, 3)),
        ("POST", f"{root}/dir/moved.bin?mv.from={root}/dir/big.bin", b""),
        ("POST", f"{root}/dir/link?link.from={root}/dir/small.txt", b""),
        ("DELETE", f"{root}/other?recursive=true", None),
        ("PUT", f"{root}/dir/small.txt", seeded(200, 4)),
        ("PUT", f"{root}/keep/k.bin", seeded(2 * CHUNK, 5)),
    ]
    out = []
    for method, path, body in steps:
        status, _, resp = side.req(method, path, body)
        out.append((method, status, json.loads(resp) if resp else None))
    return out


def latest(side: Side) -> int:
    return int(get_json(f"{side.filer.url}/__meta__/info")["latest_ts_ns"])


def in_root(ev: dict, root: str) -> bool:
    return ev.get("directory", "").startswith(root)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    with twin(str(tmp_path_factory.mktemp("meta"))) as sides:
        yield sides


# --- the event feed ------------------------------------------------------------------
@pytest.mark.parametrize("limit", [1, 4, 1024])
def test_event_pages_equal_reference(pair, limit):
    root = f"/ev{limit}"
    pages = []
    for side in pair:
        start = latest(side)
        answers = history(side, root)
        norm = Norm(side)
        cursor, events, n_pages = start, [], 0
        while True:
            out = get_json(f"{side.filer.url}/__meta__/events?since_ns={cursor}&limit={limit}")
            assert out["signature"] == side.filer.filer.signature
            assert len(out["events"]) <= limit
            if not out["events"]:
                assert out["next_ts_ns"] == cursor
                break
            assert out["next_ts_ns"] > cursor
            assert out["next_ts_ns"] == max(e["ts_ns"] for e in out["events"])
            cursor = out["next_ts_ns"]
            events += [e for e in out["events"] if in_root(e, root)]
            n_pages += 1
        pages.append((norm(answers), norm(events), n_pages))
    (ref_answers, ref_events, ref_pages), (answers, events, n_pages) = pages
    assert answers == ref_answers
    assert events == ref_events
    assert n_pages == ref_pages
    assert len(events) >= 10
    kinds = {(e["old_entry"] is not None, e["new_entry"] is not None) for e in events}
    assert kinds == {(False, True), (True, True), (True, False)}


def test_event_wait_long_polls(pair):
    """`wait` holds an empty poll open, and a write during it answers it."""
    for side in pair:
        cursor = latest(side)
        t0 = time.monotonic()
        out = get_json(f"{side.filer.url}/__meta__/events?since_ns={cursor}&wait=0.6")
        assert out["events"] == [] and out["next_ts_ns"] == cursor
        assert time.monotonic() - t0 >= 0.5
        timer = threading.Timer(0.3, side.req, ("PUT", f"/wait/{side.name}.txt", b"w"))
        timer.start()
        t0 = time.monotonic()
        out = get_json(f"{side.filer.url}/__meta__/events?since_ns={cursor}&wait=20")
        timer.join()
        assert time.monotonic() - t0 < 10
        paths = [e["new_entry"]["full_path"] for e in out["events"] if e["new_entry"]]
        assert f"/wait/{side.name}.txt" in paths


def test_bad_cursor_is_a_client_error(pair):
    answers = []
    for side in pair:
        status, _, body = side.req("GET", "/__meta__/events?since_ns=x")
        answers.append(status)
    assert answers[0] == answers[1] >= 400


# --- the subscription client ---------------------------------------------------------
@pytest.mark.parametrize("root,prefix", [("/suba", "/suba/dir"), ("/subb", "/subb")])
def test_meta_subscriber_payloads_equal_reference(pair, root, prefix):
    ref_side, port_side = pair
    got = {}
    for side, meta in ((ref_side, ref_meta), (port_side, port_meta)):
        start = latest(side)
        history(side, root)
        seen = []
        sub = meta.MetaSubscriber(side.filer.url, seen.append, since_ns=start,
                                  path_prefix=prefix)
        fetched, matched = sub.poll_once()
        n = sub.drain()
        assert sub.peer_signature == side.filer.filer.signature
        assert sub.since_ns > start and n + matched == len(seen)
        got[side.name] = (Norm(side)(seen), fetched)
    assert got["port"] == got["ref"]
    assert got["port"][0]


def test_port_subscriber_reads_the_jax_feed_alike(pair):
    """The port's client on the JAX filer's feed receives exactly what the
    JAX client receives there."""
    ref_side, _ = pair
    start = latest(ref_side)
    history(ref_side, "/cross")
    seen = {}
    for meta in (ref_meta, port_meta):
        out = []
        sub = meta.MetaSubscriber(ref_side.filer.url, out.append, since_ns=start,
                                  path_prefix="/cross")
        assert sub.drain() == len(out) > 0
        seen[meta] = (out, sub.since_ns, sub.peer_signature)
    assert seen[port_meta] == seen[ref_meta]


def _wait_for(fn, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return
        time.sleep(0.05)
    raise AssertionError("timed out")


def _join(subs, side) -> None:
    """Wait for stopped subscribers' threads; a write wakes a long poll."""
    side.req("PUT", "/loop/wake", b"w")
    for sub in subs:
        sub._thread.join(timeout=15)
        assert not sub._thread.is_alive()


def test_subscriber_loop_and_aggregator(pair):
    """A started subscriber follows the feed in the background; an
    aggregator subscribes to every peer but itself and drops peers that
    leave."""
    for side, meta in zip(pair, (ref_meta, port_meta)):
        seen = []
        sub = meta.MetaSubscriber(side.filer.url, seen.append, since_ns=latest(side),
                                  path_prefix="/loop", poll_wait=0.5)
        sub.start()
        try:
            side.req("PUT", "/loop/a.txt", b"a")
            _wait_for(lambda: any(e["new_entry"] and e["new_entry"]["full_path"] == "/loop/a.txt"
                                  for e in seen))
        finally:
            sub.stop()
        fanned = []
        agg = meta.MetaAggregator(side.filer.url, fanned.append)
        agg.set_peers([side.filer.url])
        assert agg.subscribers == {}
        agg.set_peers([side.filer.url, side.master.url + "/"])
        assert list(agg.subscribers) == [side.master.url]
        dropped = agg.subscribers[side.master.url]
        agg.set_peers([side.filer.url])
        assert agg.subscribers == {}
        other = meta.MetaAggregator("http://127.0.0.1:1", fanned.append)
        other.set_peers([side.filer.url])
        subs = list(other.subscribers.values())
        try:
            side.req("PUT", "/loop/b.txt", b"b")
            _wait_for(lambda: any(e["new_entry"] and e["new_entry"]["full_path"] == "/loop/b.txt"
                                  for e in fanned))
        finally:
            other.stop()
        assert other.subscribers == {}
        _join([sub, dropped, *subs], side)


# --- notify --------------------------------------------------------------------------
class Queue:
    """A test-local notification queue: the messages, in order."""

    def __init__(self) -> None:
        self.messages = []

    def send_message(self, key, message) -> None:
        self.messages.append((key, message))


def test_notify_equals_reference(tmp_path):
    queues = {}

    def kw(side, i):
        queues[side] = Queue()
        return {"notification_queue": queues[side]}

    with twin(str(tmp_path), filer_kw=kw) as sides:
        got = []
        for side in sides:
            history(side, "/nt")
            q = queues[side.name]
            on_write = len(q.messages)
            out = post_json(f"{side.filer.url}/__meta__/notify", {"directory": "/nt"})
            sent = q.messages[on_write:]
            assert out["sent"] == len(sent) > 0
            assert all(m["old_entry"] is None and m["signatures"] == [] for _, m in sent)
            out2 = post_json(f"{side.filer.url}/__meta__/notify", {"directory": "/nt/dir"})
            norm = Norm(side)
            got.append((out, out2, norm(q.messages)))
        assert got[0] == got[1]
        assert got[1][1]["sent"] < got[1][0]["sent"]


def test_notify_without_a_queue_is_refused(pair):
    answers = []
    for side in pair:
        status, _, body = side.req("POST", "/__meta__/notify", b'{"directory": "/"}')
        answers.append((status, json.loads(body)))
    assert answers[0] == answers[1] == (400, {"error": "no notification queue configured"})


# --- the rewrites --------------------------------------------------------------------
def entries(side: Side, root: str) -> list:
    """`?metadata=true` of every entry under root, depth first."""
    out = []
    listing = get_json(f"{side.filer.url}{root}?limit=1000")
    for e in listing.get("Entries") or []:
        out.append(get_json(f"{side.filer.url}{e['FullPath']}?metadata=true"))
        if e["IsDirectory"]:
            out += entries(side, e["FullPath"])
    return out


def bodies(side: Side, root: str) -> dict:
    return {e["full_path"]: side.req("GET", e["full_path"])[2]
            for e in entries(side, root) if not e["is_directory"]}


def test_change_volume_id_equals_reference(pair):
    got = []
    for side in pair:
        history(side, "/cv")
        before_bodies = bodies(side, "/cv")
        before = entries(side, "/cv")
        out = post_json(f"{side.filer.url}/__meta__/change_volume_id",
                        {"directory": "/cv/dir", "mapping": {"1": 9}})
        mid = entries(side, "/cv")
        assert all(c["file_id"].startswith("9,") for e in mid
                   if e["full_path"].startswith("/cv/dir/") for c in e["chunks"])
        assert all(c["file_id"].startswith("1,") for e in mid
                   if e["full_path"].startswith("/cv/keep/") for c in e["chunks"])
        back = post_json(f"{side.filer.url}/__meta__/change_volume_id",
                         {"directory": "/cv", "mapping": {"9": "1"}})
        assert bodies(side, "/cv") == before_bodies
        status, _, body = side.req("POST", "/__meta__/change_volume_id",
                                   b'{"directory": "/cv", "mapping": {}}')
        norm = Norm(side)
        got.append((out, back, norm(before), norm(mid), norm(entries(side, "/cv")),
                    status, json.loads(body)))
    assert got[0] == got[1]
    assert got[1][0]["changed"] > 0 and got[1][5] == 400


def test_merge_volumes_dry_run_and_apply_equal_reference(tmp_path):
    with twin(str(tmp_path)) as sides:
        got = []
        for side in sides:
            history(side, "/mv")
            # an entry whose manifest chunk sits in volume 1: counted, not moved
            side.req("POST", "/mv/manifest?meta.entry=true", json.dumps({
                "full_path": "/mv/manifest", "is_directory": False,
                "attributes": {"file_size": 10},
                "chunks": [{"file_id": "1,0fffff00000001", "offset": 0, "size": 10,
                            "is_chunk_manifest": True}],
            }).encode(), {"Content-Type": "application/json"})
            side.allocate(2)
            want = bodies(side, "/mv/dir") | bodies(side, "/mv/keep")
            before = entries(side, "/mv")
            dry = post_json(f"{side.filer.url}/__meta__/merge_volumes",
                            {"directory": "/mv", "from_vid": 1, "to_vid": 2})
            assert entries(side, "/mv") == before
            old = sorted({c["file_id"] for e in before for c in e["chunks"]
                          if not c["is_chunk_manifest"]})
            applied = post_json(f"{side.filer.url}/__meta__/merge_volumes",
                                {"directory": "/mv", "from_vid": "1", "to_vid": "2",
                                 "apply": True})
            after = entries(side, "/mv")
            assert bodies(side, "/mv/dir") | bodies(side, "/mv/keep") == want
            gone = [http_request("GET", f"{side.vol.url}/{fid}")[0] for fid in old]
            refused = [side.req("POST", "/__meta__/merge_volumes", body)[0:3:2] for body in (
                b'{"from_vid": "2", "to_vid": "2"}', b'{"from_vid": "1", "to_vid": "77"}')]
            norm = Norm(side)
            got.append((norm(before), dry, applied, norm(after), gone,
                        [(s, norm(json.loads(b))) for s, b in refused]))
        # the refusals' texts name the masters' lookups: compare the first
        assert got[0][:5] == got[1][:5]
        assert got[0][5][0] == got[1][5][0]
        assert [s for s, _ in got[1][5]] == [400, 400]
        dry, applied = got[1][1], got[1][2]
        assert dry["planned"] == applied["moved"] > 0 and dry["moved"] == 0
        assert not dry["applied"] and applied["applied"] and applied["skipped"] == []
        assert applied["manifest_entries_skipped"] == 1
        assert set(got[1][4]) == {404}
