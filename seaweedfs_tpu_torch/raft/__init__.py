"""Raft consensus for master HA.

Behavioral port of the reference's master replication layer
(`weed/server/raft_server.go`, `raft_hashicorp.go`,
`master_grpc_server_raft.go`): masters elect a leader; the leader owns
volume-id allocation and the file-id sequence; followers redirect clients
to the leader; on failover the replicated state machine (max volume id +
sequence ceiling) carries over so ids are never reused.

This is a compact, standard Raft (election + log replication + persistence
+ commit/apply + snapshot/compaction), transported over the masters'
existing HTTP plane (`POST /raft/request_vote`, `/raft/append_entries`,
`/raft/install_snapshot`). Once the log exceeds `compact_threshold` applied
entries, the state machine is snapshotted via `snapshot_fn` and the log
prefix truncated; followers that fall behind the snapshot receive it via
InstallSnapshot and restore through `restore_fn` — so persistence cost per
write and memory stay bounded regardless of uptime.

The port's copy of `seaweedfs_tpu/raft/__init__.py`: the same RPC payloads
and the same `raft_state.json`, so a port node restarts from a JAX node's
state file and a group may mix nodes of both packages. `_default_rpc` goes
over the port's `http_request`, so raft traffic rides mTLS when
`security.tls` is configured.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Callable


class NotLeader(Exception):
    def __init__(self, leader: str | None) -> None:
        super().__init__(f"not leader; leader={leader}")
        self.leader = leader


def _default_rpc(peer: str, method: str, payload: dict,
                 timeout: float = 1.0) -> dict:
    import json as _json

    from ..server.httpd import http_request

    status, _, body = http_request(
        "POST", f"{peer}/raft/{method}", body=_json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, timeout=timeout,
    )
    if status != 200:
        raise IOError(f"raft rpc {method} -> {status}")
    return _json.loads(body)


class RaftNode:
    def __init__(
        self,
        node_id: str,
        peers: list[str],
        apply_fn: Callable[[dict], object],
        state_dir: str | None = None,
        heartbeat_interval: float = 0.08,
        election_timeout: tuple[float, float] = (0.3, 0.6),
        rpc: Callable[..., dict] | None = None,
        snapshot_fn: Callable[[], dict] | None = None,
        restore_fn: Callable[[dict], None] | None = None,
        compact_threshold: int = 256,
        on_demote: Callable[[], None] | None = None,
    ) -> None:
        self.id = node_id
        self.peers = [p for p in peers if p != node_id]
        self.apply_fn = apply_fn
        self.state_dir = state_dir
        # fired synchronously when this node stops being leader (the JAX
        # master clears its native assign profiles here; the port's master
        # has none to clear)
        self.on_demote = on_demote
        self.heartbeat_interval = heartbeat_interval
        self.election_timeout = election_timeout
        self.rpc = rpc or _default_rpc
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn
        self.compact_threshold = compact_threshold

        self.mu = threading.RLock()
        self.role = "follower"
        self.current_term = 0
        self.voted_for: str | None = None
        self.log: list[dict] = []  # entries {term, index, command}; 1-indexed
        # log compaction state: entries <= snap_index live only in the
        # snapshot; self.log[0] (if any) has index snap_index + 1
        self.snap_index = 0
        self.snap_term = 0
        self.snap_state: dict | None = None
        self.commit_index = 0
        self.last_applied = 0
        self.leader_id: str | None = None
        self.removed = False  # true after a replicated self-removal
        self.next_index: dict[str, int] = {}
        self.match_index: dict[str, int] = {}
        self._apply_results: dict[int, object] = {}
        self._commit_cv = threading.Condition(self.mu)
        self._last_heartbeat = time.monotonic()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._load()

    # --- persistence ---------------------------------------------------------
    def _state_path(self) -> str | None:
        return os.path.join(self.state_dir, "raft_state.json") \
            if self.state_dir else None

    def _load(self) -> None:
        p = self._state_path()
        if p and os.path.exists(p):
            with open(p) as f:
                st = json.load(f)
            self.current_term = st.get("term", 0)
            self.voted_for = st.get("voted_for")
            self.log = st.get("log", [])
            self.commit_index = st.get("commit_index", 0)
            self.snap_index = st.get("snap_index", 0)
            self.snap_term = st.get("snap_term", 0)
            self.snap_state = st.get("snap_state")
            if "peers" in st:  # membership changes survive restarts
                self.peers = [p for p in st["peers"] if p != self.id]
            self.removed = bool(st.get("removed", False))
            if self.snap_state is not None and self.restore_fn is not None:
                self.restore_fn(self.snap_state)
            self.last_applied = self.snap_index

    def _persist(self) -> None:
        p = self._state_path()
        if not p:
            return
        os.makedirs(self.state_dir, exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "term": self.current_term,
                "voted_for": self.voted_for,
                "log": self.log,
                "commit_index": self.commit_index,
                "snap_index": self.snap_index,
                "snap_term": self.snap_term,
                "snap_state": self.snap_state,
                "peers": self.peers,
                "removed": self.removed,
            }, f)
        os.replace(tmp, p)

    # --- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self._stop.clear()
        t = threading.Thread(target=self._ticker, daemon=True)
        t.start()
        self._threads.append(t)
        # replay committed-but-unapplied state after restart
        with self.mu:
            self._apply_committed()

    def stop(self) -> None:
        self._stop.set()

    # --- helpers (callers hold mu) --------------------------------------------
    def _last_log(self) -> tuple[int, int]:
        if not self.log:
            return self.snap_index, self.snap_term
        e = self.log[-1]
        return e["index"], e["term"]

    def _entry(self, index: int) -> dict | None:
        pos = index - self.snap_index - 1
        if 0 <= pos < len(self.log):
            return self.log[pos]
        return None

    def _term_at(self, index: int) -> int:
        if index == self.snap_index:
            return self.snap_term
        e = self._entry(index)
        return e["term"] if e else 0

    def _maybe_compact(self) -> None:
        """Snapshot the applied state machine and truncate the log prefix
        once it outgrows compact_threshold."""
        if self.snapshot_fn is None:
            return
        if self.last_applied - self.snap_index < self.compact_threshold:
            return
        cut = self.last_applied
        cut_term = self._term_at(cut)
        state = self.snapshot_fn()
        del self.log[: cut - self.snap_index]
        self.snap_index = cut
        self.snap_term = cut_term
        self.snap_state = state
        # prune stale results; keep a threshold-wide margin so an in-flight
        # propose() waiter racing this compaction can still claim its result
        stale = cut - self.compact_threshold
        for idx in [i for i in self._apply_results if i <= stale]:
            self._apply_results.pop(idx, None)
        self._persist()

    def _become_follower(self, term: int, leader: str | None = None) -> None:
        was_leader = self.role == "leader"
        self.role = "follower"
        if term > self.current_term:
            self.current_term = term
            self.voted_for = None
        if leader:
            self.leader_id = leader
        self._persist()
        if was_leader and self.on_demote is not None:
            try:
                self.on_demote()
            except Exception:
                pass  # demotion hooks must never break the raft transition

    def _apply_conf(self, cmd: dict) -> dict:
        """Replicated membership change (`cluster.raft.add/remove`,
        `weed/shell/command_cluster_raft_add.go`): applied on every node
        through the log, persisted so restarts (even after compaction)
        keep the current member set. Removing THIS node demotes it to an
        isolated follower."""
        peer = (cmd.get("peer") or "").rstrip("/")
        if cmd.get("op") == "add":
            if peer and peer != self.id and peer not in self.peers:
                self.peers.append(peer)
                last_index = self.snap_index + len(self.log)
                self.next_index[peer] = last_index + 1
                self.match_index[peer] = 0
        elif cmd.get("op") == "remove":
            if peer == self.id:
                # this node left the cluster: it must never elect itself
                # leader of a singleton again (split brain with the
                # remaining members) — `removed` pins it as a follower
                self.peers = []
                self.removed = True
                self._become_follower(self.current_term)
            elif peer in self.peers:
                self.peers.remove(peer)
                # keep replicating to the victim for a grace window (see
                # _broadcast_heartbeats) so it applies its own removal
                if not hasattr(self, "_parting"):
                    self._parting: dict[str, float] = {}
                self._parting[peer] = time.monotonic() + 3.0
        self._persist()
        return {"ok": True, "peers": list(self.peers)}

    def _apply_committed(self) -> None:
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            e = self._entry(self.last_applied)
            if e is not None:
                cmd = e["command"]
                # capture leadership BEFORE applying: a self-removal conf
                # entry demotes inside _apply_conf, and its proposer still
                # deserves the result instead of a spurious NotLeader
                was_leader = self.role == "leader"
                try:
                    if isinstance(cmd, dict) and cmd.get("type") == "_raft_conf":
                        result = self._apply_conf(cmd)
                    else:
                        result = self.apply_fn(cmd)
                except Exception as exc:  # state machine must not kill raft
                    result = exc
                # only a leader has propose() waiters that will claim the
                # result; followers storing them forever is a leak
                if was_leader:
                    self._apply_results[self.last_applied] = result
        self._maybe_compact()
        self._commit_cv.notify_all()

    # --- election ------------------------------------------------------------
    def _ticker(self) -> None:
        while not self._stop.is_set():
            timeout = random.uniform(*self.election_timeout)
            time.sleep(self.heartbeat_interval / 2)
            with self.mu:
                role = self.role
                since = time.monotonic() - self._last_heartbeat
            if role == "leader":
                self._broadcast_heartbeats()
                time.sleep(self.heartbeat_interval / 2)
            elif since > timeout:
                self._run_election()

    def _run_election(self) -> None:
        with self.mu:
            if self.removed:
                return  # a removed node never elects itself (split brain)
            self.role = "candidate"
            self.current_term += 1
            term = self.current_term
            self.voted_for = self.id
            self._last_heartbeat = time.monotonic()
            self._persist()
            last_index, last_term = self._last_log()
            peers = list(self.peers)
        votes = [1]  # self
        done = threading.Event()

        def ask(peer: str) -> None:
            try:
                out = self.rpc(peer, "request_vote", {
                    "term": term, "candidate_id": self.id,
                    "last_log_index": last_index, "last_log_term": last_term,
                })
            except Exception:
                return
            with self.mu:
                if out.get("term", 0) > self.current_term:
                    self._become_follower(out["term"])
                    done.set()
                    return
                if out.get("vote_granted") and self.role == "candidate" \
                        and self.current_term == term:
                    votes[0] += 1
                    if votes[0] * 2 > len(peers) + 1:
                        self._become_leader_locked()
                        done.set()

        threads = [threading.Thread(target=ask, args=(p,), daemon=True)
                   for p in peers]
        for t in threads:
            t.start()
        if not peers:
            with self.mu:
                self._become_leader_locked()
            return
        done.wait(self.election_timeout[0])

    def _become_leader_locked(self) -> None:
        if self.role != "candidate":
            return
        self.role = "leader"
        self.leader_id = self.id
        last_index, _ = self._last_log()
        self.next_index = {p: last_index + 1 for p in self.peers}
        self.match_index = {p: 0 for p in self.peers}
        # announce immediately — followers are near their election timeout
        threading.Thread(
            target=self._broadcast_heartbeats, daemon=True
        ).start()

    # --- replication ----------------------------------------------------------
    def _broadcast_heartbeats(self) -> None:
        targets = list(self.peers)
        # parting peers (just removed) still receive heartbeats briefly so
        # their commit index reaches the removal entry and they learn they
        # were removed (otherwise the victim never applies it)
        parting = getattr(self, "_parting", None)
        if parting:
            now = time.monotonic()
            for p in list(parting):
                if parting[p] < now:
                    parting.pop(p, None)
                    self.next_index.pop(p, None)
                    self.match_index.pop(p, None)
                elif p not in targets:
                    targets.append(p)
        for peer in targets:
            threading.Thread(
                target=self._replicate_to, args=(peer,), daemon=True
            ).start()

    def _replicate_to(self, peer: str) -> None:
        with self.mu:
            if self.role != "leader":
                return
            term = self.current_term
            ni = self.next_index.get(peer, self.snap_index + 1)
            if ni <= self.snap_index and self.snap_index > 0:
                # follower is behind the compacted prefix: ship the snapshot
                payload = {
                    "term": term, "leader_id": self.id,
                    "last_included_index": self.snap_index,
                    "last_included_term": self.snap_term,
                    "state": self.snap_state,
                }
                snap_index = self.snap_index
            else:
                payload = None
        if payload is not None:
            try:
                out = self.rpc(peer, "install_snapshot", payload)
            except Exception:
                return
            with self.mu:
                if out.get("term", 0) > self.current_term:
                    self._become_follower(out["term"])
                    return
                if self.role != "leader" or self.current_term != term:
                    return
                if out.get("success"):
                    self.match_index[peer] = max(
                        self.match_index.get(peer, 0), snap_index
                    )
                    self.next_index[peer] = snap_index + 1
            return
        with self.mu:
            if self.role != "leader" or self.current_term != term:
                return
            ni = max(self.next_index.get(peer, self.snap_index + 1), 1)
            if ni <= self.snap_index:
                return  # compacted meanwhile; next tick ships the snapshot
            prev_index = ni - 1
            prev_term = self._term_at(prev_index)
            entries = self.log[ni - self.snap_index - 1:]
            commit = self.commit_index
        try:
            out = self.rpc(peer, "append_entries", {
                "term": term, "leader_id": self.id,
                "prev_log_index": prev_index, "prev_log_term": prev_term,
                "entries": entries, "leader_commit": commit,
            })
        except Exception:
            return
        with self.mu:
            if out.get("term", 0) > self.current_term:
                self._become_follower(out["term"])
                return
            if self.role != "leader" or self.current_term != term:
                return
            if out.get("success"):
                match = prev_index + len(entries)
                self.match_index[peer] = max(
                    self.match_index.get(peer, 0), match
                )
                self.next_index[peer] = self.match_index[peer] + 1
                self._advance_commit()
            else:
                # back off; once next_index falls to the snapshot boundary
                # the next round ships InstallSnapshot instead
                self.next_index[peer] = max(
                    self.snap_index if self.snap_index > 0 else 1, ni - 1
                )

    def _advance_commit(self) -> None:
        last_index, _ = self._last_log()
        for n in range(last_index, self.commit_index, -1):
            e = self._entry(n)
            if e is None or e["term"] != self.current_term:
                continue
            count = 1 + sum(
                1 for p in self.peers if self.match_index.get(p, 0) >= n
            )
            if count * 2 > len(self.peers) + 1:
                self.commit_index = n
                self._persist()
                self._apply_committed()
                break

    # --- rpc handlers ---------------------------------------------------------
    def handle_request_vote(self, p: dict) -> dict:
        with self.mu:
            # non-members cannot be elected: a removed node that missed
            # its own removal keeps timing out, and without this gate its
            # inflated terms would repeatedly depose the real leader
            cand = p.get("candidate_id")
            if cand is not None and cand != self.id and cand not in self.peers:
                return {"term": self.current_term, "granted": False}
            # leader-lease check (hashicorp/raft CheckQuorum semantics): a
            # node that heard from a live leader recently refuses to join a
            # disruptive election — prevents term-inflation leadership flap
            if (
                p["term"] > self.current_term
                and self.role == "follower"
                and self.leader_id is not None
                and time.monotonic() - self._last_heartbeat
                < self.election_timeout[0]
            ):
                return {"term": self.current_term, "vote_granted": False}
            if p["term"] > self.current_term:
                self._become_follower(p["term"])
            granted = False
            if p["term"] == self.current_term and \
                    self.voted_for in (None, p["candidate_id"]):
                my_index, my_term = self._last_log()
                up_to_date = (
                    p["last_log_term"] > my_term
                    or (p["last_log_term"] == my_term
                        and p["last_log_index"] >= my_index)
                )
                if up_to_date:
                    granted = True
                    self.voted_for = p["candidate_id"]
                    self._last_heartbeat = time.monotonic()
                    self._persist()
            return {"term": self.current_term, "vote_granted": granted}

    def handle_append_entries(self, p: dict) -> dict:
        with self.mu:
            if p["term"] < self.current_term:
                return {"term": self.current_term, "success": False}
            self._last_heartbeat = time.monotonic()
            if p["term"] > self.current_term or self.role != "follower":
                self._become_follower(p["term"], p.get("leader_id"))
            self.leader_id = p.get("leader_id")
            prev_index = p["prev_log_index"]
            entries = p["entries"]
            if prev_index < self.snap_index:
                # our snapshot already covers part of this batch; everything
                # at or below snap_index is committed state, skip it
                entries = [e for e in entries if e["index"] > self.snap_index]
                prev_index = self.snap_index
            elif prev_index > 0 and self._term_at(prev_index) != p["prev_log_term"]:
                return {"term": self.current_term, "success": False}
            # append, truncating conflicts
            for entry in entries:
                existing = self._entry(entry["index"])
                if existing is not None and existing["term"] != entry["term"]:
                    del self.log[entry["index"] - self.snap_index - 1:]
                    existing = None
                if existing is None:
                    self.log.append(entry)
            if entries:
                self._persist()
            if p["leader_commit"] > self.commit_index:
                last_index, _ = self._last_log()
                self.commit_index = min(p["leader_commit"], last_index)
                self._apply_committed()
            return {"term": self.current_term, "success": True}

    def handle_install_snapshot(self, p: dict) -> dict:
        """Install a leader snapshot on a follower whose log is behind the
        leader's compacted prefix (raft InstallSnapshot RPC)."""
        with self.mu:
            if p["term"] < self.current_term:
                return {"term": self.current_term, "success": False}
            self._last_heartbeat = time.monotonic()
            if p["term"] > self.current_term or self.role != "follower":
                self._become_follower(p["term"], p.get("leader_id"))
            self.leader_id = p.get("leader_id")
            incl = p["last_included_index"]
            if incl <= self.last_applied:
                # already at or past this point; never rewind the state machine
                return {"term": self.current_term, "success": True}
            # retain any log suffix consistent with the snapshot, else discard
            if self._term_at(incl) == p["last_included_term"]:
                self.log = [e for e in self.log if e["index"] > incl]
            else:
                self.log = []
            self.snap_index = incl
            self.snap_term = p["last_included_term"]
            self.snap_state = p.get("state")
            if self.snap_state is not None and self.restore_fn is not None:
                self.restore_fn(self.snap_state)
            self.last_applied = incl
            self.commit_index = max(self.commit_index, incl)
            self._persist()
            self._apply_committed()
            return {"term": self.current_term, "success": True}

    # --- client API -----------------------------------------------------------
    def is_leader(self) -> bool:
        with self.mu:
            return self.role == "leader"

    def term(self) -> int:
        with self.mu:
            return self.current_term

    def leader(self) -> str | None:
        with self.mu:
            return self.leader_id if self.role != "leader" else self.id

    def add_peer(self, peer_url: str, timeout: float = 5.0):
        """Leader-side membership add, replicated through the log
        (`cluster.raft.add`)."""
        return self.propose({"type": "_raft_conf", "op": "add",
                             "peer": peer_url.rstrip("/")}, timeout)

    def remove_peer(self, peer_url: str, timeout: float = 5.0):
        return self.propose({"type": "_raft_conf", "op": "remove",
                             "peer": peer_url.rstrip("/")}, timeout)

    def propose(self, command: dict, timeout: float = 5.0):
        """Append via the leader; blocks until committed+applied; returns the
        apply_fn result. Raises NotLeader elsewhere."""
        with self.mu:
            if self.role != "leader":
                raise NotLeader(self.leader_id)
            index = self._last_log()[0] + 1
            self.log.append({
                "term": self.current_term, "index": index, "command": command,
            })
            self._persist()
            if not self.peers:  # single node: commit immediately
                self.commit_index = index
                self._persist()
                self._apply_committed()
        self._broadcast_heartbeats()
        deadline = time.monotonic() + timeout
        missing = object()
        with self.mu:
            while self.last_applied < index:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    raise TimeoutError(f"propose not committed in {timeout}s")
                # a demotion only aborts the wait if the entry can no
                # longer produce a result here — a self-removal conf entry
                # demotes while STILL applying (its result lands in
                # _apply_results because leadership is captured pre-apply)
                if self.role != "leader" and index not in self._apply_results:
                    raise NotLeader(self.leader_id)
                self._commit_cv.wait(min(remain, 0.05))
            result = self._apply_results.pop(index, missing)
        if result is missing:
            # stepped down between append and apply: the entry may have
            # committed under the new leader, but its result was discarded
            # (followers don't retain results) — surface the demotion rather
            # than returning a bogus None
            raise NotLeader(self.leader())
        if isinstance(result, Exception):
            raise result
        return result

    def status(self) -> dict:
        with self.mu:
            return {
                "id": self.id,
                "role": self.role,
                "term": self.current_term,
                "leader": self.leader_id if self.role != "leader" else self.id,
                "commit_index": self.commit_index,
                "log_length": len(self.log),
                "peers": self.peers,
            }
