"""The port's admin shell and its EC verbs held against the JAX package.

Pieces: `parse_flags`, `_spread_plan`, `plan_rebuild` / `describe_rebuild`,
`ec.balance`'s moves, `render_plan` and `dry_run_flag` give
the JAX package's answers over the same inputs (the same `ServerView`
lists, built from one seeded set of `/dir/status` nodes).

The flow of `tests/test_shell.py::TestEcCommands` on a port cluster: a port
master and 4 port volume servers on racks r1-r4, all at device="cpu", run
`lock`, `ec.encode`, reads through remote shards, the loss of one
holder's shards, degraded reads, `ec.rebuild` and `ec.decode`. Every
shard, `.ecx` and `.vif` after the encode and after the rebuild equals
the JAX package's `write_ec_files` (numpy codec) over a copy of the
`.dat` and `.idx` taken before the encode; the decoded `.dat` equals the
copy. Byte equality throughout (no tolerance). A codec that raises fails
the verb or the GET; `ec.encode` without the lock and `ec.rebuild -mode
pipelined` raise `ShellError`.
"""

from __future__ import annotations

import copy
import http.client
import io
import os
import shutil
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops.rs_kernel import RSCodec as RefCodec
from seaweedfs_tpu.shell import commands_ec as ref_ec
from seaweedfs_tpu.shell import registry as ref_registry
from seaweedfs_tpu.shell.env import ServerView as RefServerView
from seaweedfs_tpu.shell.env import ShellError as RefShellError
from seaweedfs_tpu.storage.erasure_coding import encoder as ref_encoder
from seaweedfs_tpu.storage.erasure_coding.ec_volume import EcVolume as RefEcVolume
from seaweedfs_tpu_torch.ops.rs_kernel import RSCodec
from seaweedfs_tpu_torch.server.httpd import get_json, http_request
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.shell import CommandEnv, ShellError, commands_ec, registry, run_command
from seaweedfs_tpu_torch.shell.env import ServerView
from seaweedfs_tpu_torch.shell.shell import run_shell
from seaweedfs_tpu_torch.storage.erasure_coding import encoder, geometry
from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import EcVolume
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume

EC_EXTS = [geometry.to_ext(s) for s in range(14)] + [".ecx", ".vif"]
BLOB = 2000


# --- pieces against the JAX package ----------------------------------------------
@pytest.mark.parametrize("argv", [
    [],
    ["-volumeId", "3", "-collection", "x", "-force"],
    ["-volumeId=7", "-mode", "classic", "-dryRun"],
    ["pos", "-a", "-b", "2", "tail"],
    ["-collection=", "-x", "-y"],
    ["--double", "v", "-e=a=b"],
])
def test_parse_flags_equals_reference(argv):
    assert registry.parse_flags(list(argv)) == ref_registry.parse_flags(list(argv))


@pytest.mark.parametrize("flags", [{}, {"dryRun": "true"}, {"apply": "true"},
                                   {"dryRun": "true", "apply": "true"}])
def test_dry_run_flag_and_render_plan_equal_reference(flags):
    try:
        want = ref_registry.dry_run_flag(flags)
    except RefShellError:
        with pytest.raises(ShellError):
            registry.dry_run_flag(flags)
    else:
        assert registry.dry_run_flag(flags) == want
    for actions in ([], ["a", "b"]):
        assert registry.render_plan("v", actions) == ref_registry.render_plan("v", actions)


def status_nodes(seed: int, n_servers: int) -> list[tuple[str, str, dict]]:
    """Seeded `/dir/status` nodes: racks and DCs, volumes, and the shards of
    EC volumes 50 and 51 (50 with shards 2 and 9 held by no one)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_servers):
        dc = f"dc{int(rng.integers(0, 2))}"
        rack = f"r{int(rng.integers(0, 3))}"
        vols = [{"id": int(v), "collection": ""} for v in
                rng.choice(20, size=int(rng.integers(0, 5)), replace=False) + 1]
        out.append((dc, rack, {
            "id": f"127.0.0.1:{9000 + i}", "url": f"127.0.0.1:{9000 + i}",
            "max_volume_count": int(rng.integers(5, 30)),
            "volume_infos": vols, "ec_shard_infos": []}))
    for vid, lost in ((50, (2, 9)), (51, ())):
        for shard in range(14):
            if shard in lost:
                continue
            node = out[int(rng.integers(0, n_servers))][2]
            for e in node["ec_shard_infos"]:
                if e["id"] == vid:
                    e["shards"].append(shard)
                    break
            else:
                node["ec_shard_infos"].append({"id": vid, "collection": "", "shards": [shard]})
    return out


def views(nodes, cls):
    return [cls(dc, rack, node) for dc, rack, node in nodes]


class StubEnv:
    """The two calls the verbs make: `servers()` over fixed nodes, and
    `post` recorded."""

    def __init__(self, nodes, cls) -> None:
        self.nodes, self.cls, self.posts = nodes, cls, []

    def servers(self):
        return views(copy.deepcopy(self.nodes), self.cls)

    def post(self, url, payload=None, timeout=300):
        self.posts.append((url, payload))
        return {"ok": True}


@pytest.mark.parametrize("seed", range(4))
def test_spread_plan_equals_reference(seed):
    nodes = status_nodes(seed, 2 + seed * 2)
    got = commands_ec._spread_plan(views(nodes, ServerView), views(nodes, ServerView)[0])
    want = ref_ec._spread_plan(views(nodes, RefServerView), views(nodes, RefServerView)[0])
    assert got == want
    assert sorted(s for shards in got.values() for s in shards) == list(range(14))


@pytest.mark.parametrize("seed", range(4))
def test_plan_rebuild_equals_reference(seed):
    nodes = status_nodes(seed, 3 + seed)
    port, ref = StubEnv(nodes, ServerView), StubEnv(nodes, RefServerView)
    plan = commands_ec.plan_rebuild(port, 50, "c")
    assert plan == ref_ec.plan_rebuild(ref, 50, "c")
    assert plan["missing"] == [2, 9]
    assert commands_ec.describe_rebuild(plan) == ref_ec.describe_rebuild(plan)
    assert commands_ec.plan_rebuild(port, 51) is None
    assert ref_ec.plan_rebuild(ref, 51) is None
    # fewer than 10 shards left: both refuse
    for _, _, node in nodes:
        for e in node["ec_shard_infos"]:
            if e["id"] == 50:
                e["shards"] = [s for s in e["shards"] if s > 5]
    with pytest.raises(ShellError, match="cannot rebuild"):
        commands_ec.plan_rebuild(port, 50)
    with pytest.raises(RefShellError, match="cannot rebuild"):
        ref_ec.plan_rebuild(ref, 50)


@pytest.mark.parametrize("seed", range(3))
def test_ec_balance_moves_equal_reference(seed):
    nodes = status_nodes(seed, 3 + seed)
    port, ref = StubEnv(nodes, ServerView), StubEnv(nodes, RefServerView)
    out = commands_ec.cmd_ec_balance(port, [])
    assert out == ref_ec.cmd_ec_balance(ref, [])
    assert port.posts == ref.posts


def test_run_command_help_unknown_and_lock():
    env = CommandEnv("http://127.0.0.1:1")
    assert run_command(env, "help").split() == sorted(
        ["ec.balance", "ec.decode", "ec.encode", "ec.rebuild", "lock", "unlock"])
    assert "rebuild" in run_command(env, "help ec.rebuild")
    assert run_command(env, "") == ""
    with pytest.raises(ShellError, match="unknown command"):
        run_command(env, "volume.list")
    for verb in ("ec.encode -collection x", "ec.decode -volumeId 1",
                 "ec.rebuild -volumeId 1", "ec.balance"):
        with pytest.raises(ShellError, match="admin lock"):
            run_command(env, verb)


# --- the EC volume's local -> remote -> reconstruct ladder -------------------------
@pytest.fixture(scope="module")
def striped(tmp_path_factory):
    """A seeded volume striped at large 10000 / small 100 bytes (recorded in
    the .vif), its shard files' bytes, and its needles {id: data}."""
    d = tmp_path_factory.mktemp("ladder")
    rng = np.random.default_rng(4)
    needles = {}
    with Volume(str(d), "", 1) as v:
        for nid in range(1, 120):
            data = rng.bytes(int(rng.integers(1, 3000)))
            v.write_needle(Needle(cookie=7, id=nid, data=data))
            needles[nid] = data
    base = str(d / "1")
    encoder.write_ec_files(base, codec=RSCodec(device="cpu"),
                           large_block_size=10000, small_block_size=100)
    encoder.write_sorted_file_from_idx(base)
    encoder.save_volume_info(base + ".vif", version=3, large_block_size=10000,
                             small_block_size=100)
    shards = {}
    for s in range(14):
        with open(base + geometry.to_ext(s), "rb") as f:
            shards[s] = f.read()
    return d, shards, needles


def holder_copy(striped, tmp_path, keep) -> str:
    """A holder's directory with only the shards in `keep` (and .ecx/.vif)."""
    src, shards, _ = striped
    d = tmp_path / "holder"
    d.mkdir(exist_ok=True)
    for ext in (".ecx", ".vif"):
        shutil.copyfile(src / f"1{ext}", d / f"1{ext}")
    for s in keep:
        (d / f"1{geometry.to_ext(s)}").write_bytes(shards[s])
    return str(d)


@pytest.mark.parametrize("case", ["remote", "remote_partial", "wrong_length",
                                  "transport", "dies_mid_response"])
def test_ec_volume_ladder_equals_reference(striped, tmp_path, monkeypatch, case):
    """Seven shards local; the fetcher serves the others (all, or all but
    shards 0-1), answers the wrong length, fails in transport, or serves
    all but shards 0-1, whose holder dies mid-response (IncompleteRead,
    BadStatusLine). Reads equal the needles and the JAX EcVolume's reads
    over the same fetcher; reconstruction runs only where no holder serves
    a shard, and a read that cannot gather 10 shards raises like the
    reference."""
    _, shards, needles = striped
    d = holder_copy(striped, tmp_path, keep=range(7, 14))
    served = {"remote": range(7), "remote_partial": range(2, 7),
              "dies_mid_response": range(2, 7)}.get(case, ())
    calls = []

    def fetch(shard, off, size):
        calls.append(shard)
        if case == "transport":
            raise ConnectionRefusedError("holder down")
        if case == "dies_mid_response" and shard == 0:
            raise http.client.IncompleteRead(shards[shard][off : off + size // 2], size)
        if case == "dies_mid_response" and shard == 1:
            raise http.client.BadStatusLine("")
        if case == "wrong_length":
            return shards[shard][off : off + size - 1]
        return shards[shard][off : off + size] if shard in served else None

    rebuilt = []
    real = RSCodec.reconstruct

    def spy(self, present, targets=None):
        rebuilt.append(list(targets))
        return real(self, present, targets=targets)

    monkeypatch.setattr(RSCodec, "reconstruct", spy)
    port = EcVolume(d, "", 1, codec=RSCodec(device="cpu"))
    ref = RefEcVolume(d, "", 1, codec=RefCodec(backend="numpy"))
    port.shard_fetcher = ref.shard_fetcher = fetch
    try:
        for nid, data in needles.items():
            if case in ("remote", "remote_partial", "dies_mid_response"):
                got = port.read_needle(nid, cookie=7).data
                assert got == data == ref.read_needle(nid, cookie=7).data
            else:
                with pytest.raises(IOError, match="cannot recover"):
                    port.read_needle(nid)
                with pytest.raises(IOError, match="cannot recover"):
                    ref.read_needle(nid)
                break
    finally:
        port.close()
        ref.close()
    assert calls
    if case == "remote":
        assert not rebuilt  # every shard came from a holder
    if case in ("remote_partial", "dies_mid_response"):
        assert rebuilt and all(t in ([0], [1]) for t in rebuilt)


def test_ec_volume_fetcher_error_other_than_transport_propagates(striped, tmp_path):
    d = holder_copy(striped, tmp_path, keep=range(7, 14))

    def fetch(shard, off, size):
        raise RuntimeError("a fault in the fetcher itself")

    ev = EcVolume(d, "", 1, codec=RSCodec(device="cpu"))
    ev.shard_fetcher = fetch
    try:
        with pytest.raises(RuntimeError, match="fetcher itself"):
            ev.read_needle(1)
    finally:
        ev.close()


# --- a port cluster on the CPU ----------------------------------------------------
@pytest.fixture
def cluster(tmp_path):
    master = MasterServer(port=0, pulse_seconds=1, volume_size_limit_mb=64)
    master.start()
    servers = []
    try:
        for i, rack in enumerate(["r1", "r2", "r3", "r4"]):
            vs = VolumeServer(
                [str(tmp_path / f"v{i}")], master.url, port=0, rack=rack,
                pulse_seconds=1, max_volume_count=30, device="cpu",
            )
            vs.start()
            servers.append(vs)
        yield master, servers, CommandEnv(master.url)
    finally:
        for vs in servers:
            vs.stop()
        master.stop()


def write_blobs(master_url: str, n: int, seed: int) -> dict:
    """n seeded blobs of BLOB bytes through /dir/assign: {url: data}."""
    rng = np.random.default_rng(seed)
    out = {}
    for _ in range(n):
        a = get_json(f"{master_url}/dir/assign")
        url = f"http://{a['publicUrl']}/{a['fid']}"
        data = rng.bytes(BLOB)
        status, _, _ = http_request("POST", url, data)
        assert status == 201
        out[url] = data
    return out


def fid_of(url: str) -> str:
    return url.rsplit("/", 1)[-1]


def encode_one(master, servers, env, tmp_path, seed=0):
    """Blobs, the oracle copy of one volume, lock and ec.encode of it.
    Returns (vid, its blobs, the oracle's base path)."""
    blobs = write_blobs(master.url, 24, seed)
    vid = int(fid_of(next(iter(blobs))).split(",")[0])
    in_vol = {u: d for u, d in blobs.items() if fid_of(u).startswith(f"{vid},")}
    holder = next(vs for vs in servers if vs.store.get_volume(vid) is not None)
    base = holder.store.get_volume(vid).base_name
    oracle = tmp_path / "oracle"
    oracle.mkdir()
    obase = str(oracle / str(vid))
    for ext in (".dat", ".idx"):
        shutil.copyfile(base + ext, obase + ext)
    with pytest.raises(ShellError, match="admin lock"):
        run_command(env, f"ec.encode -volumeId {vid}")
    assert run_command(env, "lock") == "lock acquired"
    assert "shards spread" in run_command(env, f"ec.encode -volumeId {vid}")
    return vid, in_vol, obase


def ec_files(servers, vid) -> dict:
    """{server url: {ext: path}} of every EC file of `vid` on disk."""
    out = {}
    for vs in servers:
        d = vs.store.locations[0].directory
        out[vs.url] = {ext: os.path.join(d, f"{vid}{ext}") for ext in EC_EXTS
                       if os.path.exists(os.path.join(d, f"{vid}{ext}"))}
    return out


def assert_equal_oracle(servers, vid, obase) -> list[int]:
    shards = []
    for files in ec_files(servers, vid).values():
        for ext, path in files.items():
            with open(path, "rb") as a, open(obase + ext, "rb") as b:
                assert a.read() == b.read(), f"{path} != the JAX package's {ext}"
            if ext.startswith(".ec") and ext[3:].isdigit():
                shards.append(int(ext[3:]))
    return sorted(shards)


def get(url: str) -> tuple[int, bytes]:
    status, _, body = http_request("GET", url)
    return status, body


def test_ec_encode_rebuild_decode_equal_reference(cluster, tmp_path, monkeypatch):
    master, servers, env = cluster
    vid, in_vol, obase = encode_one(master, servers, env, tmp_path)
    assert in_vol
    ref_encoder.write_ec_files(obase, codec=RefCodec(backend="numpy"))
    ref_encoder.write_sorted_file_from_idx(obase)
    ref_encoder.save_volume_info(obase + ".vif", version=3)

    # all 14 shards mounted across the 4 servers (4/4/3/3), the volume gone
    holders = [sv for sv in env.servers() if vid in sv.ec_shards]
    assert sorted(len(sv.ec_shards[vid]) for sv in holders) == [3, 3, 4, 4]
    assert sorted(s for sv in holders for s in sv.ec_shards[vid]) == list(range(14))
    assert vid not in env.volume_replicas()
    assert assert_equal_oracle(servers, vid, obase) == list(range(14))
    assert all(".ecx" in f and ".vif" in f for f in ec_files(servers, vid).values())
    assert run_command(env, "ec.balance") == "EC shards already balanced"

    # reads through every server: each lacks 10 shards, so most go remote
    for vs in servers:
        for url, data in in_vol.items():
            assert get(f"{vs.url}/{fid_of(url)}") == (200, data), (vs.url, url)

    # lose the holder of shard 0 (the small volume's needles all lie on it)
    victim = next(sv for sv in holders if 0 in sv.ec_shards[vid])
    lost = list(victim.ec_shards[vid])
    out = env.post(f"{victim.http}/admin/ec/delete_shards",
                   {"volume": vid, "shards": lost, "delete_index": False})
    assert sorted(out["removed"]) == sorted(lost)
    assert not any(vid in sv.ec_shards and sv.ec_shards[vid]
                   for sv in env.servers() if sv.id == victim.id)
    calls = []
    real = RSCodec.reconstruct

    def spy(self, *a, **kw):
        calls.append(a[1] if len(a) > 1 else kw.get("targets"))
        return real(self, *a, **kw)

    monkeypatch.setattr(RSCodec, "reconstruct", spy)
    others = [vs for vs in servers if vs.url != victim.http]
    for vs in others:
        for url, data in in_vol.items():
            assert get(f"{vs.url}/{fid_of(url)}") == (200, data), ("degraded", vs.url)
    assert calls and all(t == [0] for t in calls)
    monkeypatch.setattr(RSCodec, "reconstruct", real)

    with pytest.raises(ShellError, match="pipelined"):
        run_command(env, f"ec.rebuild -volumeId {vid} -mode pipelined")
    with pytest.raises(ShellError, match="mode must be"):
        run_command(env, f"ec.rebuild -volumeId {vid} -mode fast")
    dry = run_command(env, f"ec.rebuild -volumeId {vid} -dryRun")
    assert dry.startswith("ec.rebuild [classic] (dry run)") and f"{sorted(lost)}" in dry
    assert assert_equal_oracle(servers, vid, obase) == sorted(set(range(14)) - set(lost))
    out = run_command(env, f"ec.rebuild -volumeId {vid}")
    assert f"rebuilt shards {sorted(lost)}" in out and "(classic)" in out
    present = sorted({s for sv in env.servers() for s in sv.ec_shards.get(vid, [])})
    assert present == list(range(14))
    assert assert_equal_oracle(servers, vid, obase) == list(range(14))
    assert run_command(env, f"ec.rebuild -volumeId {vid}") == \
        f"volume {vid}: all 14 shards present"

    out = run_command(env, f"ec.decode -volumeId {vid}")
    assert "reconstructed" in out
    deadline = time.time() + 10
    while vid not in env.volume_replicas() and time.time() < deadline:
        time.sleep(0.1)
    (target,) = [vs for vs in servers if vs.store.get_volume(vid) is not None]
    with open(target.store.get_volume(vid).base_name + ".dat", "rb") as a, \
            open(obase + ".dat", "rb") as b:
        assert a.read() == b.read()
    assert not any(ec_files(servers, vid).values())
    for url, data in in_vol.items():
        (loc,) = env.locations(vid)
        assert get(f"http://{loc}/{fid_of(url)}") == (200, data)
    assert run_command(env, "unlock") == "lock released"


def test_codec_failure_fails_ec_encode(cluster, tmp_path, monkeypatch):
    """The codec raising inside /admin/ec/generate is a 500, which
    post_json raises as IOError out of the verb; no shard reaches any
    other server and the volume is still served."""
    master, servers, env = cluster

    def boom(*a, **kw):
        raise RuntimeError("codec failed")

    monkeypatch.setattr(RSCodec, "encode_rows_async", boom)
    monkeypatch.setattr(RSCodec, "encode2d_async", boom)
    blobs = write_blobs(master.url, 8, 1)
    vid = int(fid_of(next(iter(blobs))).split(",")[0])
    holder = next(vs for vs in servers if vs.store.get_volume(vid) is not None)
    run_command(env, "lock")
    with pytest.raises(IOError, match="/admin/ec/generate -> 500.*codec failed"):
        run_command(env, f"ec.encode -volumeId {vid}")
    for vs in servers:
        if vs is not holder:
            assert not ec_files([vs], vid)[vs.url]
    assert vid in env.volume_replicas() and not any(
        vid in sv.ec_shards for sv in env.servers())
    url = next(u for u in blobs if fid_of(u).startswith(f"{vid},"))
    assert get(url) == (200, blobs[url])


def test_codec_failure_fails_degraded_get_and_rebuild(cluster, tmp_path, monkeypatch):
    master, servers, env = cluster
    vid, in_vol, _ = encode_one(master, servers, env, tmp_path, seed=2)
    holders = [sv for sv in env.servers() if vid in sv.ec_shards]
    victim = next(sv for sv in holders if 0 in sv.ec_shards[vid])
    env.post(f"{victim.http}/admin/ec/delete_shards",
             {"volume": vid, "shards": victim.ec_shards[vid]})

    def boom(*a, **kw):
        raise RuntimeError("codec failed")

    monkeypatch.setattr(RSCodec, "reconstruct", boom)
    other = next(vs for vs in servers if vs.url != victim.http)
    url, data = next(iter(in_vol.items()))
    status, body = get(f"{other.url}/{fid_of(url)}")
    assert status == 500 and b"codec failed" in body
    monkeypatch.setattr(RSCodec, "apply2d_async", boom)
    with pytest.raises(IOError, match="/admin/ec/rebuild -> 500.*codec failed"):
        run_command(env, f"ec.rebuild -volumeId {vid}")
    monkeypatch.undo()
    assert get(f"{other.url}/{fid_of(url)}") == (200, data)
    assert "rebuilt" in run_command(env, f"ec.rebuild -volumeId {vid}")


def test_run_shell_script(cluster):
    master, servers, env = cluster
    blobs = write_blobs(master.url, 4, 3)
    vid = int(fid_of(next(iter(blobs))).split(",")[0])
    buf = io.StringIO()
    assert run_shell(master.url, script=f"ec.encode -volumeId {vid}", out=buf) == 1
    assert "admin lock" in buf.getvalue()
    buf = io.StringIO()
    rc = run_shell(master.url, script=f"lock; ec.encode -volumeId {vid}\n# done", out=buf)
    assert rc == 0 and "shards spread" in buf.getvalue()
    # the shell released its lock on the way out
    env.acquire_lock()
    env.release_lock()


def test_volume_server_without_device_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        VolumeServer([str(tmp_path / "v")], "http://127.0.0.1:1", port=0)
    assert not os.listdir(tmp_path)
