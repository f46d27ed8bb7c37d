"""The port's raft and master HA held against the JAX package.

Raft core: the JAX suite's in-process transport routes each RPC to a local
node object, so a group may mix nodes of both packages. Every core test
runs on a port group and on a mixed one (two JAX nodes, one port node):
election, replication, failover, compaction with InstallSnapshot (the port
node cut off when it is a follower, so it installs the snapshot; it ships
one when it leads), persistence; every node applies the same entries. A
port node restarts from a JAX node's state file, and the two packages
write equal state files for equal state.

Master HA: three port masters (their raft over HTTP) pass the JAX suite's
TestMasterHA, TestSequenceLeaseTermSync, demotion and membership tests; a
fourth master added through the port shell's `cluster.raft.add` catches up
by InstallSnapshot after the log was compacted. `cluster.raft.{ps,add,
remove}` answer as the JAX shell does over a JAX group, with each master's
url named by its role and index and the raft term and commit index blanked
(raft timing). Tolerance 0.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time

import pytest

from seaweedfs_tpu.raft import RaftNode as RefRaftNode
from seaweedfs_tpu.server.master import MasterServer as RefMasterServer
from seaweedfs_tpu.shell import CommandEnv as RefEnv
from seaweedfs_tpu.shell import run_command as ref_run
from seaweedfs_tpu_torch.raft import NotLeader, RaftNode
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.shell import CommandEnv, ShellError, run_command
from tests._threads import stop_history_loops  # noqa: F401

KINDS = {"port": ("port", "port", "port"), "mixed": ("jax", "jax", "port")}


class InProcTransport:
    """rpc(peer, method, payload) routed to local node objects of either
    package, with a togglable partition set."""

    def __init__(self) -> None:
        self.nodes: dict = {}
        self.down: set[str] = set()

    def rpc(self, peer: str, method: str, payload: dict, timeout: float = 1.0):
        if peer in self.down or payload.get("leader_id") in self.down \
                or payload.get("candidate_id") in self.down:
            raise IOError("partitioned")
        node = self.nodes[peer]
        if method == "request_vote":
            return node.handle_request_vote(payload)
        if method == "append_entries":
            return node.handle_append_entries(payload)
        if method == "install_snapshot":
            return node.handle_install_snapshot(payload)
        raise ValueError(method)


def make_cluster(kinds=("port",), state_dirs=None, compact_threshold=None):
    tr = InProcTransport()
    ids = [f"node{i}" for i in range(len(kinds))]
    applied = {i: [] for i in ids}
    restored = {i: [] for i in ids}
    nodes = []
    for i, (nid, kind) in enumerate(zip(ids, kinds)):
        def apply_fn(cmd, nid=nid):
            applied[nid].append(cmd)
            return cmd.get("value")

        kwargs = {}
        if compact_threshold is not None:
            def snapshot_fn(nid=nid):
                return {"applied_count": len(applied[nid])}

            def restore_fn(state, nid=nid):
                restored[nid].append(state)

            kwargs = dict(snapshot_fn=snapshot_fn, restore_fn=restore_fn,
                          compact_threshold=compact_threshold)
        cls = RaftNode if kind == "port" else RefRaftNode
        node = cls(nid, list(ids), apply_fn,
                   state_dir=state_dirs[i] if state_dirs else None,
                   heartbeat_interval=0.03, election_timeout=(0.1, 0.2),
                   rpc=tr.rpc, **kwargs)
        tr.nodes[nid] = node
        nodes.append(node)
    return tr, nodes, applied, restored


def wait_leader(nodes, timeout=5.0, exclude=()):
    deadline = time.time() + timeout
    while time.time() < deadline:
        leaders = [n for n in nodes if n.is_leader() and n.id not in exclude]
        if len(leaders) == 1:
            return leaders[0]
        time.sleep(0.02)
    raise AssertionError("no single leader elected")


def wait_for(cond, timeout=5.0, what="condition"):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def values(cmds) -> list:
    return [c["value"] for c in cmds]


# --- raft core -------------------------------------------------------------------
def test_single_node_self_elects_and_commits():
    tr, nodes, applied, _ = make_cluster(("port",))
    nodes[0].start()
    try:
        leader = wait_leader(nodes)
        assert leader.propose({"type": "x", "value": 42}) == 42
        assert applied["node0"] == [{"type": "x", "value": 42}]
    finally:
        nodes[0].stop()


@pytest.mark.parametrize("group", KINDS)
def test_three_node_election_and_replication(group):
    tr, nodes, applied, _ = make_cluster(KINDS[group])
    for n in nodes:
        n.start()
    try:
        leader = wait_leader(nodes)
        for i in range(5):
            leader.propose({"type": "set", "value": i})
        wait_for(lambda: all(len(c) == 5 for c in applied.values()), what="catch-up")
        for nid, cmds in applied.items():
            assert values(cmds) == [0, 1, 2, 3, 4], nid
        follower = next(n for n in nodes if not n.is_leader())
        with pytest.raises(Exception) as ei:
            follower.propose({"type": "set", "value": 9})
        assert type(ei.value).__name__ == "NotLeader" and ei.value.leader == leader.id
    finally:
        for n in nodes:
            n.stop()


@pytest.mark.parametrize("group", KINDS)
def test_leader_failover_preserves_log(group):
    tr, nodes, applied, _ = make_cluster(KINDS[group])
    for n in nodes:
        n.start()
    try:
        leader = wait_leader(nodes)
        leader.propose({"type": "set", "value": "before"})
        wait_for(lambda: all(len(c) == 1 for c in applied.values()), what="replication")
        tr.down.add(leader.id)  # partition the leader away
        new_leader = wait_leader(nodes, exclude={leader.id})
        assert new_leader.id != leader.id
        new_leader.propose({"type": "set", "value": "after"})
        survivors = [n.id for n in nodes if n.id not in tr.down]
        wait_for(lambda: all(len(applied[s]) == 2 for s in survivors), what="apply")
        for nid in survivors:
            assert values(applied[nid]) == ["before", "after"], nid
    finally:
        for n in nodes:
            n.stop()


def hold_gil(seconds: float) -> None:
    """Stand the whole process still for `seconds`, the GIL held, as a full
    collection of a big heap does: the switch interval is raised past the
    stall, so no waiting thread forces a switch."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(seconds * 10)
    try:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            pass
    finally:
        sys.setswitchinterval(old)


def test_process_stall_keeps_leader():
    """A pause of the whole process longer than the election timeout (a
    full collection over a big heap) turns no leader over: every node's
    ticker sees that it overslept, and the leader's beats sent meanwhile
    wait unread, so the stall is not counted against the leader. The
    masters' timers (0.08 s beats, 0.3-0.6 s timeout); five 0.8 s stalls."""
    tr, nodes, applied, _ = make_cluster(KINDS["port"])
    for n in nodes:
        n.heartbeat_interval, n.election_timeout = 0.08, (0.3, 0.6)
        n.start()
    try:
        leader = wait_leader(nodes)
        term = leader.term()
        for _ in range(5):
            hold_gil(0.8)
            time.sleep(0.3)
        assert [(n.id, n.term(), n.is_leader()) for n in nodes] == \
            [(n.id, term, n is leader) for n in nodes]
        assert leader.propose({"type": "set", "value": 1}) == 1
    finally:
        for n in nodes:
            n.stop()


@pytest.mark.parametrize("group", KINDS)
def test_log_compaction_and_snapshot_install(group):
    """The log stays bounded, and a follower that slept through the
    compacted prefix catches up by InstallSnapshot and restore_fn. In the
    mixed group the port node is the one cut off when it follows (it
    installs a JAX leader's snapshot), else it leads and ships one."""
    tr, nodes, applied, restored = make_cluster(KINDS[group], compact_threshold=10)
    for n in nodes:
        n.start()
    try:
        leader = wait_leader(nodes)
        followers = [n for n in nodes if not n.is_leader()]
        port_followers = [n for n in followers if isinstance(n, RaftNode)]
        follower = port_followers[0] if port_followers else followers[0]
        tr.down.add(follower.id)  # the follower misses everything
        for i in range(40):
            leader.propose({"type": "set", "value": i})
        with leader.mu:
            assert leader.snap_index > 0, "the leader never compacted"
            assert len(leader.log) <= 2 * leader.compact_threshold
        tr.down.discard(follower.id)

        def caught_up():
            with follower.mu:
                return follower.last_applied >= 40

        wait_for(caught_up, what="InstallSnapshot")
        with follower.mu:
            assert follower.snap_index > 0, "the snapshot was never installed"
        assert restored[follower.id], "restore_fn was never called"
        snap = restored[follower.id][-1]
        assert snap["applied_count"] + len(applied[follower.id]) >= 40
        with follower.mu:
            assert len(follower._apply_results) == 0
        # every node that applied an entry applied the same one at its index
        others = [n for n in nodes if n is not follower]
        wait_for(lambda: all(len(applied[n.id]) == 40 for n in others), what="apply")
        for n in others:
            assert values(applied[n.id]) == list(range(40)), n.id
        assert values(applied[follower.id]) == \
            list(range(40))[40 - len(applied[follower.id]):]
    finally:
        for n in nodes:
            n.stop()


def test_persistence_restart(tmp_path):
    dirs = [str(tmp_path / "n0")]
    tr, nodes, applied, _ = make_cluster(("port",), state_dirs=dirs)
    nodes[0].start()
    wait_leader(nodes).propose({"type": "set", "value": 7})
    nodes[0].stop()
    tr2, nodes2, applied2, _ = make_cluster(("port",), state_dirs=dirs)
    nodes2[0].start()
    try:
        wait_leader(nodes2)
        wait_for(lambda: applied2["node0"], what="replay")
        assert values(applied2["node0"]) == [7]
        assert nodes2[0].current_term >= 1
    finally:
        nodes2[0].stop()


def test_port_node_restarts_from_reference_state_file(tmp_path):
    """A JAX node's `raft_state.json` (log, term, a compacted snapshot,
    membership) restores a port node: the snapshot through restore_fn, the
    committed tail replayed in order."""
    d = str(tmp_path / "n")
    restored = []
    ref = RefRaftNode("node0", ["node0"], lambda c: c.get("value"), state_dir=d,
                      heartbeat_interval=0.03, election_timeout=(0.1, 0.2),
                      snapshot_fn=lambda: {"upto": "snap"}, restore_fn=restored.append,
                      compact_threshold=5)
    ref.start()
    wait_leader([ref])
    for i in range(8):
        ref.propose({"type": "set", "value": i})
    ref.stop()
    with open(os.path.join(d, "raft_state.json")) as f:
        on_disk = json.load(f)
    assert on_disk["snap_index"] == 5 and len(on_disk["log"]) == 3
    got = []
    port = RaftNode("node0", ["node0"], lambda c: got.append(c["value"]), state_dir=d,
                    heartbeat_interval=0.03, election_timeout=(0.1, 0.2),
                    restore_fn=restored.append)
    assert restored == [{"upto": "snap"}]
    assert (port.current_term, port.snap_index, port.commit_index) == (
        on_disk["term"], 5, 8)
    port.start()
    try:
        wait_for(lambda: got == [5, 6, 7], what="replay of the tail")
        wait_leader([port])
        assert port.propose({"type": "set", "value": 99}) is None  # got.append's result
        assert got == [5, 6, 7, 99]
    finally:
        port.stop()


def test_state_files_equal_reference(tmp_path):
    """Equal raft state persists to byte-equal files in both packages."""
    nodes = []
    for cls, name in ((RaftNode, "port"), (RefRaftNode, "ref")):
        n = cls("A", ["A", "B", "C"], lambda c: None, state_dir=str(tmp_path / name),
                rpc=lambda *a, **k: {})
        with n.mu:
            n.current_term, n.voted_for = 4, "B"
            n.log = [{"term": 3, "index": 6, "command": {"type": "set", "value": [1, "x"]}},
                     {"term": 4, "index": 7, "command": {"type": "_raft_conf", "op": "add",
                                                         "peer": "D"}}]
            n.commit_index, n.snap_index, n.snap_term = 6, 5, 3
            n.snap_state = {"max_volume_id": 9, "seq_ceiling": 123}
            n._persist()
        nodes.append(n)
    mine = (tmp_path / "port" / "raft_state.json").read_bytes()
    assert mine == (tmp_path / "ref" / "raft_state.json").read_bytes()
    assert json.loads(mine)["peers"] == ["B", "C"]


def test_demotion_fires_on_demote_hook():
    fired = []
    n = RaftNode("n1", [], lambda c: None, rpc=lambda *a, **k: {},
                 on_demote=lambda: fired.append(1))
    with n.mu:
        n.role = "leader"
        n._become_follower(5, leader="n2")
    assert fired == [1]
    with n.mu:  # follower -> follower does not re-fire
        n._become_follower(6)
    assert fired == [1]


def _pair_rpc(transport):
    def rpc(peer, method, payload, timeout=None):
        node = transport.get(peer)
        if node is None:
            raise IOError(f"{peer} down")
        return getattr(node, "handle_" + method)(payload)

    return rpc


def _leader_of_two(a, b):
    for _ in range(200):
        leader = a if a.is_leader() else b if b.is_leader() else None
        if leader is not None:
            return leader
        time.sleep(0.05)
    raise AssertionError("no leader")


def test_dynamic_membership_add_remove(tmp_path):
    transport = {}
    rpc = _pair_rpc(transport)
    a = RaftNode("A", ["B"], lambda c: {"applied": c}, rpc=rpc, state_dir=str(tmp_path / "a"))
    b = RaftNode("B", ["A"], lambda c: {"applied": c}, rpc=rpc, state_dir=str(tmp_path / "b"))
    transport["A"], transport["B"] = a, b
    a.start()
    b.start()
    c = None
    try:
        leader = _leader_of_two(a, b)
        follower = b if leader is a else a
        c = RaftNode("C", [leader.id, follower.id], lambda c_: {"applied": c_},
                     rpc=rpc, state_dir=str(tmp_path / "c"))
        transport["C"] = c
        c.start()
        assert "C" in leader.add_peer("C")["peers"]
        wait_for(lambda: "C" in follower.peers, what="the add on the follower")
        assert leader.propose({"type": "noop", "n": 1}) == {
            "applied": {"type": "noop", "n": 1}}
        assert "C" not in leader.remove_peer("C")["peers"]
        wait_for(lambda: "C" not in follower.peers, what="the remove on the follower")
        # the apply persists under the node's lock: taken, the file is written
        with follower.mu, open(tmp_path / ("a" if follower is a else "b")
                               / "raft_state.json") as f:
            assert "C" not in json.load(f)["peers"]  # membership survives restarts
    finally:
        for n in (a, b, c):
            if n is not None:
                n.stop()


def test_removed_node_never_becomes_singleton_leader(tmp_path):
    transport = {}
    rpc = _pair_rpc(transport)
    a = RaftNode("A", ["B"], lambda c: {"applied": c}, rpc=rpc, state_dir=str(tmp_path / "a"))
    b = RaftNode("B", ["A"], lambda c: {"applied": c}, rpc=rpc, state_dir=str(tmp_path / "b"))
    transport["A"], transport["B"] = a, b
    a.start()
    b.start()
    try:
        leader = _leader_of_two(a, b)
        follower = b if leader is a else a
        assert follower.id not in leader.remove_peer(follower.id)["peers"]
        wait_for(lambda: follower.removed, what="the removal")
        time.sleep(1.5)  # many election timeouts: it must stay a follower
        assert not follower.is_leader(), "a removed node elected itself (split brain)"
        assert leader.is_leader()
        follower.stop()
        f2 = RaftNode(follower.id, [leader.id], lambda c: None, rpc=rpc,
                      state_dir=str(tmp_path / ("a" if follower is a else "b")))
        assert f2.removed
    finally:
        a.stop()
        b.stop()


# --- master HA ---------------------------------------------------------------------
def start_masters(n, cls=MasterServer, **kw):
    masters = [cls(port=0, **kw) for _ in range(n)]
    for m in masters:
        m.service.start()  # listen first so urls are known
    urls = [m.url for m in masters]
    for m in masters:
        m.enable_raft([u for u in urls if u != m.url])
        # fast elections, tolerant of scheduling hiccups under load
        m.raft.heartbeat_interval = 0.05
        m.raft.election_timeout = (0.4, 0.7)
    return masters


def start_joiner(masters, cls=MasterServer):
    """A fresh master that knows the group but is not yet a member. It
    never campaigns (a long election timeout), so its term stays below the
    leader's and it follows the first append_entries once added."""
    m = cls(port=0)
    m.service.start()
    m.enable_raft([x.url for x in masters])
    m.raft.heartbeat_interval = 0.05
    m.raft.election_timeout = (30.0, 60.0)
    return m


def leader_of(masters, timeout=8.0, exclude=()):
    deadline = time.time() + timeout
    while time.time() < deadline:
        leaders = [m for m in masters if m.raft.is_leader() and m.url not in exclude]
        if len(leaders) == 1:
            return leaders[0]
        time.sleep(0.02)
    raise AssertionError("no master leader")


@pytest.fixture()
def three_masters():
    masters = start_masters(3)
    yield masters
    for m in masters:
        m.stop()


def _volume(tmp_path, masters):
    from seaweedfs_tpu_torch.server.volume import VolumeServer

    vol = VolumeServer([str(tmp_path / "v")], ",".join(m.url for m in masters), port=0,
                       device="cpu")
    vol.start()
    vol.heartbeat_once()
    return vol


class TestMasterHA:
    def test_assign_redirects_to_leader(self, three_masters, tmp_path):
        from seaweedfs_tpu_torch.filer.wdclient import WeedClient
        from seaweedfs_tpu_torch.server.httpd import http_request

        leader = leader_of(three_masters)
        follower = next(m for m in three_masters if m is not leader)
        vol = _volume(tmp_path, three_masters)
        try:
            for route in ("/dir/assign", "/dir/lookup?volumeId=1"):
                status, _, body = http_request("GET", follower.url + route)
                assert status == 409, route
                assert json.loads(body) == {"error": "raft.not.leader",
                                            "leader": leader.url}
            status, _, body = http_request("POST", follower.url + "/heartbeat", b"{}")
            assert status == 409 and json.loads(body)["leader"] == leader.url
            client = WeedClient(",".join(m.url for m in three_masters))
            try:
                assert client.assign()["fid"]
            finally:
                client.close()
        finally:
            vol.stop()

    def test_wdclient_follows_leader(self, three_masters, tmp_path):
        from seaweedfs_tpu_torch.filer.wdclient import WeedClient

        leader = leader_of(three_masters)
        vol = _volume(tmp_path, three_masters)
        try:
            follower_first = [m.url for m in three_masters if m is not leader] + [leader.url]
            client = WeedClient(",".join(follower_first))
            try:
                assert client.assign()["fid"]
                assert client.master_url == leader.url
            finally:
                client.close()
        finally:
            vol.stop()

    def test_failover_keeps_ids_unique(self, three_masters, tmp_path):
        from seaweedfs_tpu_torch.filer.wdclient import WeedClient

        leader = leader_of(three_masters)
        vol = _volume(tmp_path, three_masters)
        fids = set()
        client = WeedClient(",".join(m.url for m in three_masters))
        survivors = [m for m in three_masters if m is not leader]
        client2 = WeedClient(",".join(m.url for m in survivors))
        try:
            for _ in range(3):
                fids.add(client.assign()["fid"])
            old_vid_max = max(m.topo._max_volume_id for m in three_masters)
            leader.stop()  # a survivor takes over
            new_leader = leader_of(survivors, exclude={leader.url})
            vol.heartbeat_once()  # re-register volumes with the new leader
            assert vol.master_url == new_leader.url
            # a heartbeat that went to the dead leader leaves the new one
            # without capacity for a beat: re-send and retry briefly
            deadline = time.time() + 10
            while True:
                try:
                    fid = client2.assign()["fid"]
                    break
                except OSError:
                    assert time.time() < deadline
                    vol.heartbeat_once()
                    time.sleep(0.2)
            assert fid not in fids
            fids.add(fid)
            for _ in range(2):
                fid = client2.assign()["fid"]
                assert fid not in fids  # never reuse a file id
                fids.add(fid)
            assert new_leader.topo._max_volume_id >= old_vid_max
        finally:
            client.close()
            client2.close()
            vol.stop()


class _FakeRaft:
    """Single-node stand-in: propose applies at once, and the term is set
    by the test to stand for elections this node never saw."""

    def __init__(self, apply_fn):
        self.current_term = 1
        self.apply_fn = apply_fn

    def term(self):
        return self.current_term

    def is_leader(self):
        return True

    def propose(self, cmd, timeout=5.0):
        return self.apply_fn(cmd)

    def stop(self):
        pass


def test_reelected_leader_resyncs_without_follower_requests():
    m = MasterServer(port=0)
    m.raft = _FakeRaft(m._raft_apply)
    m._raft_apply({"type": "sequence_ceiling", "value": 0})
    m._ensure_sequence_lease(1)
    assert m._seq_ceiling > 0
    a = m.topo.sequencer.next_file_id(1)
    # leadership moves on; the other leader hands out ids far past this
    # node's counter and the replicated ceiling rises
    m._raft_apply({"type": "sequence_ceiling", "value": 500_000})
    m.raft.current_term = 3  # re-elected: the first lease check fast-forwards
    m._ensure_sequence_lease(1)
    b = m.topo.sequencer.next_file_id(1)
    assert b >= 500_000 and b > a


def test_raft_snapshot_and_apply_equal_reference():
    """The master's replicated state machine answers the same commands
    with the same results and snapshots as the JAX master's."""
    mine, ref = MasterServer(port=0), RefMasterServer(port=0)
    cmds = [{"type": "next_volume_id"}, {"type": "sequence_ceiling", "value": 70},
            {"type": "next_volume_id"}, {"type": "sequence_ceiling", "value": 5},
            {"type": "unknown"}, {"type": "sequence_ceiling", "value": 10_070}]
    assert [mine._raft_apply(c) for c in cmds] == [ref._raft_apply(c) for c in cmds]
    assert mine._raft_snapshot() == ref._raft_snapshot() == {
        "max_volume_id": 2, "seq_ceiling": 10_070}
    for m in (mine, ref):
        m._raft_restore({"max_volume_id": 40, "seq_ceiling": 7})
    assert mine._raft_snapshot() == ref._raft_snapshot() == {
        "max_volume_id": 40, "seq_ceiling": 10_070}


def test_added_master_catches_up_by_install_snapshot(three_masters, tmp_path):
    """`cluster.raft.add` of a fresh fourth master after the leader's log
    was compacted: it installs the snapshot (volume-id counter and sequence
    ceiling) and then follows; `cluster.raft.remove` of a dead master
    leaves the group able to commit."""
    leader = leader_of(three_masters)
    for m in three_masters:
        m.raft.compact_threshold = 8
    for i in range(1, 25):
        leader.raft.propose({"type": "sequence_ceiling", "value": 1000 * i})
    leader.raft.propose({"type": "next_volume_id"})
    with leader.raft.mu:
        assert leader.raft.snap_index > 0
    fourth = start_joiner(three_masters)
    try:
        env = CommandEnv(leader.url)
        out = run_command(env, f"cluster.raft.add -address {fourth.url}")
        assert out.startswith(f"added {fourth.url}; members: ")
        wait_for(lambda: fourth._seq_ceiling == 24_000 and fourth.topo._max_volume_id == 1,
                 what="the fourth's catch-up")
        with fourth.raft.mu:
            assert fourth.raft.snap_index > 0, "caught up without InstallSnapshot"
        assert leader.topo._max_volume_id == 1
        assert fourth.raft.leader() == leader.url
        dead = next(m for m in three_masters if m is not leader)
        dead.stop()
        out = run_command(env, f"cluster.raft.remove -address {dead.url}")
        assert dead.url not in out.split("members: ")[1]
        assert leader.raft.propose({"type": "sequence_ceiling", "value": 99_000}) == 99_000
        wait_for(lambda: fourth._seq_ceiling == 99_000, what="a commit after the remove")
        lines = run_command(env, "cluster.raft.ps").splitlines()
        assert lines[0].startswith(f"{leader.url}  role=leader")
        assert any(ln.startswith(f"{fourth.url}  role=follower") for ln in lines)
    finally:
        fourth.stop()


# --- the shell ----------------------------------------------------------------------
def _norm(text: str, masters, leader) -> str:
    names = {leader.url: "leader"}
    names.update({m.url: f"m{i}" for i, m in
                  enumerate(x for x in masters if x is not leader)})
    for url in sorted(names, key=len, reverse=True):
        text = text.replace(url, names[url])
    text = re.sub(r"term=\d+", "term=T", text)
    return re.sub(r"commit=\d+", "commit=C", text)


def raft_verbs(masters, fourth, env_cls, run) -> list[str]:
    """cluster.raft.ps, add, ps, remove, ps and the usage errors, through
    the leader, normalized."""
    leader = leader_of(masters)
    env = env_cls(leader.url)
    group = masters + [fourth]
    out = [run(env, "cluster.raft.ps")]
    out.append(run(env, f"cluster.raft.add -address {fourth.url}"))
    wait_for(lambda: fourth.raft.leader() == leader.url, what="the fourth to follow")
    out.append(run(env, "cluster.raft.ps"))
    victim = next(m for m in masters if m is not leader)
    out.append(run(env, f"cluster.raft.remove -id {victim.url}"))
    wait_for(lambda: victim.raft.removed, what="the victim to apply its removal")
    out.append(run(env, "cluster.raft.ps"))
    for line in ("cluster.raft.add", "cluster.raft.remove"):
        try:
            run(env, line)
        except Exception as e:
            out.append(f"{type(e).__name__}: {e}")
    return [_norm(o, group, leader) for o in out]


def test_raft_verbs_equal_reference():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAWEEDFS_TPU_DISABLE_FASTLANE", "1")
        ref_masters = start_masters(3, cls=RefMasterServer)
        ref_fourth = start_joiner(ref_masters, cls=RefMasterServer)
    masters = start_masters(3)
    fourth = start_joiner(masters)
    try:
        ref = raft_verbs(ref_masters, ref_fourth, RefEnv, ref_run)
        mine = raft_verbs(masters, fourth, CommandEnv, run_command)
        assert mine == ref
        assert mine[0].splitlines()[0] == "leader  role=leader term=T commit=C"
        assert mine[1] == "added m2; members: m0, m1, m2"
        assert mine[-1].startswith("ShellError: usage: cluster.raft.remove")
    finally:
        for m in ref_masters + [ref_fourth] + masters + [fourth]:
            m.stop()


def test_raft_ps_without_raft_equals_reference():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAWEEDFS_TPU_DISABLE_FASTLANE", "1")
        ref = RefMasterServer(port=0)
        ref.service.start()
    mine = MasterServer(port=0)
    mine.start()
    try:
        a = ref_run(RefEnv(ref.url), "cluster.raft.ps").replace(ref.url, "M")
        b = run_command(CommandEnv(mine.url), "cluster.raft.ps").replace(mine.url, "M")
        assert a == b == "raft disabled (single master at M)"
        with pytest.raises(ShellError):
            run_command(CommandEnv(mine.url), "cluster.raft.add -address http://x:1")
    finally:
        mine.stop()
        ref.stop()


def test_not_leader_is_raised_by_the_port_node():
    n = RaftNode("n1", ["n2"], lambda c: None, rpc=lambda *a, **k: {})
    with pytest.raises(NotLeader) as ei:
        n.propose({"type": "x"})
    assert ei.value.leader is None
