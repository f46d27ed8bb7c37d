"""The port's cluster membership and distributed lock manager held against
the JAX package's, case for case with `tests/test_cluster_dlm.py`.

Pure pieces run in both packages on the same inputs under one pinned
clock: `LockRing` assignments and ranks over seeded keys, and
`DistributedLockManager` through a seeded script of locks, renewals,
unlocks, expiries and sweeps. Every answer must be equal, tokens named by
order of issue (they are random uuids).

Then two filers a cluster (`tests/test_torch_filer_meta.py::twin`, a JAX
and a port cluster side by side): the `/__dlm__/{lock,unlock,status}`
answers at the key's owner and at the other filer (200, 409 and the 307
`moved_to`), `LockClient` following the redirect, and the master's
`/cluster/register`, `/cluster/ps` and `/cluster/leader`. The JSON answers
may differ only in tokens, timestamps (`expires_at`, `last_seen`,
`created_ts`) and URLs: each side's URLs are named (m, f0, f1, and the
owner of a key is named "owner"); all else must be equal.
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

from seaweedfs_tpu import cluster as ref_cluster
from seaweedfs_tpu_torch import cluster as port_cluster
from seaweedfs_tpu_torch.server.httpd import get_json, http_request, post_json

from .test_torch_filer_meta import Norm, twin

PKGS = pytest.mark.parametrize("pkg", [ref_cluster, port_cluster], ids=["ref", "port"])
SERVERS = ["http://10.0.0.1:8888", "http://10.0.0.2:8888", "http://10.0.0.3:8888",
           "http://10.0.0.4:18888"]


def _keys(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [f"/buckets/b{int(rng.integers(1 << 30)):x}/k{i}" for i in range(n)]


# --- LockRing ------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [1, 2])
def test_ring_assignment_equals_reference(seed):
    keys = _keys(seed, 256)
    got = []
    for pkg in (ref_cluster, port_cluster):
        ring = pkg.LockRing(SERVERS[:3])
        first = [ring.server_for(k) for k in keys]
        ranked = [ring.ranked_for(k, 2) for k in keys]
        ring.set_servers(SERVERS + SERVERS[:1])
        after = [ring.server_for(k) for k in keys]
        got.append((first, ranked, after, ring.servers(), ring.ranked_for(keys[0], 9)))
    assert got[0] == got[1]
    first, ranked, after, servers, top = got[1]
    assert len(set(first)) == 3 and servers == sorted(SERVERS)
    assert all(r[0] == f for r, f in zip(ranked, first)) and len(top) == 4
    # rendezvous hashing: a new member takes only its own share
    moved = sum(a != f for a, f in zip(after, first))
    assert 0 < moved < 128 and all(a == SERVERS[3] for a, f in zip(after, first) if a != f)


@PKGS
def test_empty_ring(pkg):
    ring = pkg.LockRing()
    assert ring.server_for("x") is None and ring.ranked_for("x", 3) == []


# --- DistributedLockManager ----------------------------------------------------------
class Clock:
    def __init__(self) -> None:
        self.now = 1_700_000_000.0

    def __call__(self) -> float:
        return self.now


def _script(pkg, seed: int, clock: Clock) -> list:
    """Seeded locks, renewals, unlocks, owner reads, sweeps and clock steps;
    every answer, tokens named by order of issue."""
    rng = np.random.default_rng(seed)
    dlm = pkg.DistributedLockManager(host="h")
    tokens: dict[str, str] = {}
    held: dict[str, str] = {}
    out = []

    def name(tok):
        return tokens.setdefault(tok, f"T{len(tokens)}")

    for _ in range(400):
        op = int(rng.integers(6))
        key = f"k{int(rng.integers(5))}"
        owner = f"o{int(rng.integers(3))}"
        try:
            if op <= 1:
                tok = held.get(key, "") if rng.random() < 0.5 else ""
                t, exp = dlm.lock(key, owner, float(rng.integers(1, 6)), token=tok)
                held[key] = t
                out.append(("lock", key, owner, name(t), exp - clock.now))
            elif op == 2:
                tok = held.get(key, "") if rng.random() < 0.7 else "wrong"
                out.append(("unlock", key, dlm.unlock(key, tok)))
            elif op == 3:
                out.append(("owner", key, dlm.owner_of(key)))
            elif op == 4:
                out.append(("sweep", dlm.sweep()))
            else:
                clock.now += float(rng.integers(0, 3))
                out.append(("tick",))
        except pkg.LockedError as e:
            out.append(("locked", e.key, e.owner, str(e)))
    return out


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_lock_manager_script_equals_reference(seed, monkeypatch):
    got = []
    for pkg in (ref_cluster, port_cluster):
        clock = Clock()
        monkeypatch.setattr(time, "time", clock)
        got.append(_script(pkg, seed, clock))
    assert got[0] == got[1]
    kinds = {a[0] for a in got[1]}
    assert {"lock", "locked", "unlock", "owner", "sweep"} <= kinds


@PKGS
def test_lock_conflict_expiry_renew_and_sweep(pkg, monkeypatch):
    clock = Clock()
    monkeypatch.setattr(time, "time", clock)
    dlm = pkg.DistributedLockManager()
    token, exp = dlm.lock("job", "alice", ttl_sec=0.2)
    with pytest.raises(pkg.LockedError):
        dlm.lock("job", "bob", ttl_sec=1)
    with pytest.raises(pkg.LockedError):
        dlm.lock("job", "alice", ttl_sec=1)  # the owner without its token
    clock.now += 0.1
    again, exp2 = dlm.lock("job", "alice", ttl_sec=0.5, token=token)
    assert again == token and exp2 > exp
    with pytest.raises(pkg.LockedError):
        dlm.unlock("job", "wrong-token")
    clock.now += 0.6
    token2, _ = dlm.lock("job", "bob", ttl_sec=60)  # expired: bob takes it
    assert token2 != token and dlm.owner_of("job") == "bob"
    dlm.lock("s1", "a", ttl_sec=0.05)
    clock.now += 0.1
    assert dlm.sweep() == 1 and dlm.owner_of("s1") is None
    assert dlm.unlock("job", token2) and dlm.owner_of("job") is None
    assert dlm.unlock("never", "x")


# --- over HTTP: two filers a cluster --------------------------------------------------
@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    with twin(str(tmp_path_factory.mktemp("dlm")), n_filers=2) as sides:
        yield sides


def _roles(side, key: str) -> tuple:
    """(owner index, other index) of a key on this side's ring."""
    owner_url = side.filers[0].lock_ring.server_for(key)
    owner = next(i for i, f in enumerate(side.filers) if f.url == owner_url)
    return owner, 1 - owner


def _dlm(side, idx: int, verb: str, payload: dict, norm) -> tuple:
    status, _, body = http_request(
        "POST", f"{side.filers[idx].url}/__dlm__/{verb}", json.dumps(payload).encode(),
        {"Content-Type": "application/json"})
    return status, norm(json.loads(body))


class Tokens:
    def __init__(self) -> None:
        self.names: dict[str, str] = {}

    def __call__(self, obj):
        if isinstance(obj, dict) and "token" in obj:
            obj = dict(obj, token=self.names.setdefault(obj["token"], f"T{len(self.names)}"))
        return obj


@pytest.mark.parametrize("key", ["/buckets/demo", "renew/key", "mq/balancer"])
def test_lock_answers_equal_reference(pairs, key):
    got = []
    for side in pairs:
        owner, other = _roles(side, key)
        names = Norm(side)
        names.names[side.filers[owner].url.split("//")[-1]] = "owner"
        names.names[side.filers[other].url.split("//")[-1]] = "other"
        tok = Tokens()

        def norm(obj):
            return tok(names(obj))

        answers = [
            _dlm(side, other, "lock", {"key": key, "owner": "alice", "ttl_sec": 5}, norm),
            _dlm(side, owner, "lock", {"key": key, "owner": "alice", "ttl_sec": 5}, norm),
            _dlm(side, owner, "lock", {"key": key, "owner": "bob", "ttl_sec": 5}, norm),
        ]
        token = side.filers[owner].dlm._locks[key].token
        answers += [
            _dlm(side, owner, "lock", {"key": key, "owner": "alice", "ttl_sec": 9,
                                       "token": token}, norm),
            _dlm(side, owner, "unlock", {"key": key, "token": "wrong"}, norm),
            _dlm(side, other, "unlock", {"key": key, "token": token}, norm),
            _dlm(side, owner, "unlock", {"key": key, "token": token}, norm),
            _dlm(side, owner, "lock", {"key": key, "owner": "bob"}, norm),
        ]
        side.filers[owner].dlm.unlock(key, side.filers[owner].dlm._locks[key].token)
        status = [names(get_json(f"{f.url}/__dlm__/status")) for f in side.filers]
        got.append((answers, sorted((sorted(s["ring"]), s["host"]) for s in status)))
    assert got[0] == got[1]
    answers = got[1][0]
    assert [a[0] for a in answers] == [307, 200, 409, 200, 409, 307, 200, 200]
    assert answers[0][1] == {"moved_to": "http://owner"}
    assert answers[2][1] == {"error": f"lock {key!r} held by 'alice'", "owner": "alice"}
    assert answers[3][1]["token"] == answers[1][1]["token"] == "T0"


@pytest.mark.parametrize("client_pkg", [ref_cluster, port_cluster], ids=["ref", "port"])
def test_lock_client_follows_the_ring(pairs, client_pkg):
    """Each package's `LockClient`, on each cluster, entering through either
    filer: the redirect lands on the owner, a second owner is refused, and
    a renewal keeps the token."""
    for side in pairs:
        for key in ("/buckets/demo", "renew/key"):
            owner, other = _roles(side, key)
            alice = client_pkg.LockClient(side.filers[other].url, "alice")
            bob = client_pkg.LockClient(side.filers[owner].url, "bob")
            url, token = alice.lock(key, ttl_sec=5)
            assert url == side.filers[owner].url
            with pytest.raises(client_pkg.LockedError):
                bob.lock(key, ttl_sec=5)
            url2, token2 = alice.lock(key, ttl_sec=5, token=token)
            assert (url2, token2) == (url, token)
            with pytest.raises(client_pkg.LockedError):
                bob.unlock(key, "wrong", url=url)
            alice.unlock(key, token)  # through the other filer: redirected
            url3, token3 = bob.lock(key, ttl_sec=5)
            assert url3 == url and token3 != token
            bob.unlock(key, token3, url=url3)
            assert side.filers[owner].dlm.owner_of(key) is None


# --- cluster membership ---------------------------------------------------------------
def test_register_ps_and_leader_equal_reference(pairs):
    got = []
    for side in pairs:
        norm = Norm(side)
        m = side.master.url
        ps = get_json(f"{m}/cluster/ps")
        leader = get_json(f"{m}/cluster/leader?type=filer")
        again = get_json(f"{m}/cluster/leader")
        reg = post_json(f"{m}/cluster/register", {"type": "broker", "address": "10.9.9.9:17777"})
        reg_filer = post_json(f"{m}/cluster/register",
                              {"type": "filer", "address": side.filers[1].url})
        broker = get_json(f"{m}/cluster/leader?type=broker")
        ps2 = get_json(f"{m}/cluster/ps")
        status, _, body = http_request("GET", f"{m}/cluster/leader?type=nope")
        got.append(norm([ps, leader, again, reg, reg_filer, broker, ps2,
                         status, json.loads(body)]))
    assert got[0] == got[1]
    ps, leader, again, reg, reg_filer, broker, ps2, status, err = got[1]
    assert [f["address"] for f in ps["filers"]] == ["http://f0", "http://f1"]
    assert ps["brokers"] == [] and ps["masters"] == [{"address": "http://m", "isLeader": True}]
    assert leader == again == {"leader": "http://f0", "type": "filer"}
    assert reg == {"ok": True, "leader": "http://m", "gateways": 1, "ordinal": 0}
    assert reg_filer == {"ok": True, "leader": "http://m", "gateways": 2, "ordinal": 1}
    assert broker == {"leader": "10.9.9.9:17777", "type": "broker"}
    assert ps2["brokers"] == [{"type": "broker", "address": "10.9.9.9:17777"}]
    assert (status, err) == (404, {"error": "no live nope members"})
