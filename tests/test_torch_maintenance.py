"""The port's maintenance daemon (detect -> plan -> heal) held against the
JAX package, case for case with `tests/test_maintenance.py`.

Pure pieces run in both packages on the same inputs: `RepairTask`, the
`RepairScheduler` (dedup, priority, caps, token bucket, backoff with a
seeded `random.Random`, the lazy window) and the six detectors over the
same heartbeats fed to a JAX and a port `Topology`. Seeded streams must
give equal dispatch orders, delays, `snapshot()` and `pressure()`, and
equal task lists (type, volume, collection, node, reason, params).

Port clusters (a port master with `maintenance_interval=0.25` and three
port `VolumeServer(device="cpu")`s on racks r1-r3) heal with no shell
command after the damage: a lost replica, lost EC shards (every shard
equal to the JAX `write_ec_files` with `RSCodec(backend="numpy")` over a
copy of the `.dat`), a vacuum candidate and a corrupt needle. Dry-run
plans equal the real run's and mutate nothing; an operator's admin lock
defers the daemon; evacuation pre-copies off a stale node; a codec
failure fails the task with its reason; `cluster.maintenance` renders a
status dict as the JAX verb does. Tolerance: byte equality. Every wait
has a deadline. The replica-loss and vacuum cases allocate their volumes
evenly before any write (`allocate_evenly`), so the balance detector stays
quiet and moves no volume under them; the vacuum case also reads the
surviving needle from every holder a fresh lookup names once the daemon
is idle.
"""

from __future__ import annotations

import random
import time

import numpy as np
import pytest

from seaweedfs_tpu import maintenance as ref_maint
from seaweedfs_tpu.maintenance import detectors as ref_det
from seaweedfs_tpu.ops.rs_kernel import RSCodec as RefCodec
from seaweedfs_tpu.shell import commands_maintenance as ref_cm
from seaweedfs_tpu.storage.erasure_coding import encoder as ref_encoder
from seaweedfs_tpu.topology import Topology as RefTopology
from seaweedfs_tpu_torch import maintenance as port_maint
from seaweedfs_tpu_torch.maintenance import detectors as port_det
from seaweedfs_tpu_torch.ops.rs_kernel import RSCodec
from seaweedfs_tpu_torch.server.httpd import get_json, http_request, post_json
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.shell import CommandEnv, ShellError, run_command
from seaweedfs_tpu_torch.shell import commands_maintenance as port_cm
from seaweedfs_tpu_torch.topology import Topology as PortTopology
from tests.test_torch_shell import assert_equal_oracle, encode_one, fid_of
from tests._threads import stop_history_loops  # noqa: F401


class Pkg:
    """One package's maintenance surface, so a case runs in both."""

    def __init__(self, name, maint, det, topology, lazy_counts) -> None:
        self.name = name
        self.maint = maint
        self.det = det
        self.Topology = topology
        self._lazy_counts = lazy_counts

    def task(self, type_="fix_replication", vid=1, node="n1", priority=None,
             **params):
        return self.maint.RepairTask(
            type=type_, volume_id=vid, node=node,
            priority=(self.maint.TASK_TYPES[type_].priority
                      if priority is None else priority),
            params=params,
        )

    def sched(self, **kw):
        return self.maint.RepairScheduler(**kw)

    def lazy_counts(self, sched) -> dict:
        return self._lazy_counts(sched)


def _ref_lazy_counts(sched) -> dict:
    from seaweedfs_tpu.stats import default_registry

    out = {}
    for line in default_registry().render().splitlines():
        if line.startswith("SeaweedFS_maintenance_lazy_batch_total{"):
            outcome = line.split('outcome="')[1].split('"')[0]
            out[outcome] = float(line.rsplit(" ", 1)[1])
    return out


REF = Pkg("ref", ref_maint, ref_det, RefTopology, _ref_lazy_counts)
PORT = Pkg("port", port_maint, port_det, PortTopology,
           lambda s: {k: float(v) for k, v in s.lazy_batch.items()})
BOTH = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])


# --- RepairTask -----------------------------------------------------------------
@BOTH
def test_unknown_type_rejected(pkg):
    with pytest.raises(ValueError, match="unknown maintenance task"):
        pkg.maint.RepairTask(type="frobnicate")


@BOTH
def test_key_is_dedup_identity(pkg):
    assert pkg.task(vid=3).key == ("fix_replication", 3)
    assert pkg.task(vid=3).key == pkg.task(vid=3, node="other").key
    assert pkg.task(vid=3).key == pkg.task(vid=3, reason_differs=True).key
    t = pkg.maint.RepairTask(type="evacuate", node="n9", priority=2)
    assert t.key == ("evacuate", "n9")


def test_task_types_equal_reference():
    assert {k: (v.priority, v.concurrency) for k, v in PORT.maint.TASK_TYPES.items()} \
        == {k: (v.priority, v.concurrency) for k, v in REF.maint.TASK_TYPES.items()}
    assert sorted(PORT.maint.ALERT_SCANS.items()) == sorted(REF.maint.ALERT_SCANS.items())
    assert list(PORT.det.DETECTORS) == list(REF.det.DETECTORS)


# --- the scheduler --------------------------------------------------------------
@BOTH
def test_dedup_and_queue_bound(pkg):
    s = pkg.sched(max_queue=2)
    assert s.offer(pkg.task(vid=1), now=0)
    assert not s.offer(pkg.task(vid=1), now=0)
    assert s.offer(pkg.task(vid=2), now=0)
    assert not s.offer(pkg.task(vid=3), now=0)
    assert s.stats["deduped"] == 1 and s.stats["queue_full"] == 1


@BOTH
def test_priority_order(pkg):
    s = pkg.sched(repair_rate=100, repair_burst=100, global_limit=10,
                  per_node_limit=10)
    s.offer(pkg.task("vacuum", vid=1, node="a"), now=0)
    s.offer(pkg.task("fix_replication", vid=2, node="b"), now=0)
    assert s.next_task(now=0).type == "fix_replication"
    assert s.next_task(now=0).type == "vacuum"


@BOTH
def test_per_type_cap(pkg):
    s = pkg.sched(repair_rate=100, repair_burst=100, global_limit=10,
                  per_node_limit=10)
    s.offer(pkg.task("ec_rebuild", vid=1, node="a"), now=0)
    s.offer(pkg.task("ec_rebuild", vid=2, node="b"), now=0)
    t1 = s.next_task(now=0)
    assert t1 is not None and s.next_task(now=0) is None
    s.complete(t1, ok=True, now=0)
    assert s.next_task(now=0).volume_id == 2


@BOTH
def test_per_node_limit(pkg):
    s = pkg.sched(repair_rate=100, repair_burst=100, global_limit=10,
                  per_node_limit=1)
    s.offer(pkg.task("fix_replication", vid=1, node="a"), now=0)
    s.offer(pkg.task("vacuum", vid=2, node="a"), now=0)
    s.offer(pkg.task("vacuum", vid=3, node="b"), now=0)
    got = {s.next_task(now=0).key, s.next_task(now=0).key}
    assert got == {("fix_replication", 1), ("vacuum", 3)}
    assert s.next_task(now=0) is None
    assert s.stats["max_node_inflight"] == 1


@BOTH
def test_global_limit(pkg):
    s = pkg.sched(repair_rate=100, repair_burst=100, global_limit=2,
                  per_node_limit=10, type_caps={"fix_replication": 10})
    for i in range(4):
        s.offer(pkg.task(vid=i, node=f"n{i}"), now=0)
    assert s.next_task(now=0) and s.next_task(now=0)
    assert s.next_task(now=0) is None
    assert s.stats["max_inflight"] == 2


@BOTH
def test_token_bucket_throttle(pkg):
    s = pkg.sched(repair_rate=1.0, repair_burst=1.0, global_limit=10,
                  per_node_limit=10, type_caps={"vacuum": 10})
    for i in range(3):
        s.offer(pkg.task("vacuum", vid=i, node=f"n{i}"), now=0)
    assert s.next_task(now=0) is not None
    assert s.next_task(now=0) is None
    assert s.next_task(now=1.05) is not None
    assert s.next_task(now=1.1) is None


@BOTH
def test_backoff_with_jitter(pkg):
    s = pkg.sched(backoff_base=2.0, backoff_max=60.0, rng=random.Random(7),
                  repair_rate=100, repair_burst=100)
    t = pkg.task(vid=1)
    assert s.offer(t, now=0)
    assert s.next_task(now=0) is not None
    d1 = s.complete(t, ok=False, now=0)
    assert 1.0 <= d1 <= 3.0
    assert not s.offer(t, now=0.5)
    assert s.stats["backed_off"] == 1
    assert s.offer(t, now=d1 + 0.01)
    assert s.next_task(now=d1 + 0.01) is not None
    d2 = s.complete(t, ok=False, now=10)
    assert 2.0 <= d2 <= 6.0
    assert s.offer(t, now=10 + d2 + 0.01)
    assert s.next_task(now=10 + d2 + 0.01) is not None
    assert s.complete(t, ok=True, now=20) == 0.0
    assert s.offer(t, now=20.01)


@BOTH
def test_queue_depths_and_snapshot(pkg):
    s = pkg.sched(repair_rate=100, repair_burst=100)
    s.offer(pkg.task("vacuum", vid=1, node="a"), now=0)
    s.offer(pkg.task("vacuum", vid=2, node="a"), now=0)
    assert s.next_task(now=0) is not None
    assert s.queue_depths()["vacuum"] == {"queued": 1, "in_flight": 1}
    snap = s.snapshot(now=0)
    assert len(snap["queued"]) == 1 and len(snap["in_flight"]) == 1
    assert snap["limits"]["per_node_limit"] == 1


def _stream(seed: int, n: int = 160):
    """A seeded stream of scheduler operations: offers (with targets and
    urgency), dispatch attempts and completions, at rising times."""
    rng = np.random.default_rng(seed)
    ops, now = [], 100.0
    types = sorted(REF.maint.TASK_TYPES)
    for _ in range(n):
        now += float(rng.choice([0.0, 0.05, 0.3, 1.1, 2.5]))
        r = rng.random()
        if r < 0.5:
            type_ = str(rng.choice(types))
            node_scoped = type_ in ("evacuate", "balance")
            params = {}
            if type_ == "ec_rebuild":
                k = int(rng.integers(1, 3))
                params["targets"] = sorted(int(x) for x in rng.choice(14, k, replace=False))
                params["missing"] = k
                if rng.random() < 0.1:
                    params["online"] = True
            ops.append(("offer", now, dict(
                type_=type_, vid=None if node_scoped else int(rng.integers(1, 9)),
                node=f"n{int(rng.integers(0, 4))}", **params),
                bool(rng.random() < 0.2)))
        elif r < 0.8:
            ops.append(("next", now))
        else:
            ops.append(("complete", now, int(rng.integers(0, 1 << 30)),
                        bool(rng.random() < 0.6)))
    return ops


def _run_stream(pkg, seed: int, lazy_window: float) -> list:
    s = pkg.sched(max_queue=12, per_node_limit=2, global_limit=3,
                  repair_rate=1.5, repair_burst=3.0, backoff_base=0.5,
                  backoff_max=8.0, rng=random.Random(seed),
                  lazy_window=lazy_window)
    trace, in_flight = [], []
    for op in _stream(seed):
        if op[0] == "offer":
            _, now, kw, urgent = op
            trace.append(("offer", s.offer(pkg.task(**kw), now=now, urgent=urgent)))
        elif op[0] == "next":
            t = s.next_task(now=op[1])
            if t is not None:
                in_flight.append(t)
            trace.append(("next", None if t is None else t.to_dict()))
        elif in_flight:
            _, now, pick, ok = op
            t = in_flight.pop(pick % len(in_flight))
            trace.append(("complete", t.key, s.complete(t, ok=ok, now=now)))
        trace.append(("lazy", s.next_lazy_deadline(now=op[1])))
    end = op[1] + 0.5
    trace.append(("snapshot", s.snapshot(now=end)))
    trace.append(("pressure", s.pressure(now=end)))
    trace.append(("depths", s.queue_depths()))
    return trace


@pytest.mark.parametrize("lazy_window", [0.0, 2.0])
@pytest.mark.parametrize("seed", range(3))
def test_seeded_stream_dispatch_equals_reference(seed, lazy_window):
    want = _run_stream(REF, seed, lazy_window)
    got = _run_stream(PORT, seed, lazy_window)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, (i, a, b)
    assert any(e[0] == "next" and e[1] for e in got)  # the stream dispatched
    assert any(e[0] == "complete" and e[2] > 0 for e in got)  # and backed off


# --- the lazy window ------------------------------------------------------------
def _lazy_sched(pkg, window=2.0):
    return pkg.sched(repair_rate=100, repair_burst=100, global_limit=10,
                     per_node_limit=10, type_caps={"ec_rebuild": 10},
                     lazy_window=window)


@BOTH
def test_batches_within_window_and_folds_targets(pkg):
    s = _lazy_sched(pkg, 2.0)
    before = pkg.lazy_counts(s)
    assert s.offer(pkg.task("ec_rebuild", vid=7, targets=[3]), now=100.0)
    assert s.next_task(now=100.5) is None
    assert pkg.lazy_counts(s).get("deferred", 0) > before.get("deferred", 0)
    assert s.offer(pkg.task("ec_rebuild", vid=7, targets=[9]), now=100.8)
    assert s.stats["folded"] == 1
    t = s.next_task(now=100.9)
    assert t is not None
    assert t.params["targets"] == [3, 9]
    assert t.params["missing"] == 2
    assert pkg.lazy_counts(s).get("batched", 0) > before.get("batched", 0)


@BOTH
def test_never_delays_past_window(pkg):
    s = _lazy_sched(pkg, 2.0)
    before = pkg.lazy_counts(s)
    s.offer(pkg.task("ec_rebuild", vid=7, targets=[3]), now=100.0)
    assert s.next_task(now=101.99) is None
    t = s.next_task(now=102.01)
    assert t is not None and t.volume_id == 7
    assert pkg.lazy_counts(s).get("expired", 0) > before.get("expired", 0)
    s2 = _lazy_sched(pkg, 2.0)
    s2.offer(pkg.task("ec_rebuild", vid=8, targets=[1]), now=50.0)
    d = s2.next_lazy_deadline(now=51.0)
    assert d is not None and abs(d - 1.0) < 1e-6
    assert s2.next_lazy_deadline(now=53.0) is None


@BOTH
def test_urgent_pressure_bypasses_window(pkg):
    s = _lazy_sched(pkg, 30.0)
    before = pkg.lazy_counts(s)
    s.offer(pkg.task("ec_rebuild", vid=7, targets=[3]), now=100.0, urgent=True)
    t = s.next_task(now=100.0)
    assert t is not None and t.volume_id == 7
    assert pkg.lazy_counts(s).get("bypassed", 0) > before.get("bypassed", 0)
    s2 = _lazy_sched(pkg, 30.0)
    s2.offer(pkg.task("ec_rebuild", vid=9, targets=[2]), now=100.0)
    assert s2.next_task(now=100.1) is None
    assert not s2.offer(pkg.task("ec_rebuild", vid=9, targets=[2]),
                        now=100.2, urgent=True)
    assert s2.next_task(now=100.3) is not None


@BOTH
def test_window_zero_is_todays_behavior(pkg):
    s = _lazy_sched(pkg, 0.0)
    s.offer(pkg.task("ec_rebuild", vid=7, targets=[3]), now=100.0)
    assert s.next_task(now=100.0) is not None


@BOTH
def test_multi_target_and_online_skip_the_hold(pkg):
    s = _lazy_sched(pkg, 30.0)
    s.offer(pkg.task("ec_rebuild", vid=7, targets=[3, 9]), now=100.0)
    assert s.next_task(now=100.0) is not None
    s.offer(pkg.task("ec_rebuild", vid=8, targets=[], online=True), now=100.0)
    assert s.next_task(now=100.0) is not None


@BOTH
def test_other_types_unaffected(pkg):
    s = _lazy_sched(pkg, 30.0)
    s.offer(pkg.task("vacuum", vid=4, node="a"), now=100.0)
    assert s.next_task(now=100.0) is not None


@BOTH
def test_pressure_and_snapshot_expose_lazy_state(pkg):
    s = _lazy_sched(pkg, 5.0)
    s.offer(pkg.task("ec_rebuild", vid=7, targets=[3]), now=100.0)
    p = s.pressure(now=101.0)
    assert p["lazy_window"] == 5.0 and p["lazy_held"] == 1 and p["queued"] == 1
    snap = s.snapshot(now=101.0)
    lazy = snap["queued"][0]["lazy"]
    assert lazy["held"] is True and 0 < lazy["dispatch_in"] <= 5.0
    assert snap["limits"]["lazy_window"] == 5.0
    s.offer(pkg.task("ec_rebuild", vid=7, targets=[5]), now=101.5)
    snap = s.snapshot(now=101.5)
    assert len(snap["queued"]) == 1
    assert snap["queued"][0]["params"]["targets"] == [3, 5]


@BOTH
def test_fold_dispatches_widened_task_not_stale_heap_entry(pkg):
    s = _lazy_sched(pkg, 0.0)
    s.offer(pkg.task("ec_rebuild", vid=7, targets=[3]), now=100.0)
    s.offer(pkg.task("ec_rebuild", vid=7, targets=[9]), now=100.0)
    t = s.next_task(now=100.0)
    assert t.params["targets"] == [3, 9]
    assert s.next_task(now=100.0) is None


@BOTH
def test_in_flight_does_not_fold(pkg):
    s = _lazy_sched(pkg, 0.0)
    s.offer(pkg.task("ec_rebuild", vid=7, targets=[3]), now=100.0)
    assert s.next_task(now=100.0) is not None
    assert not s.offer(pkg.task("ec_rebuild", vid=7, targets=[9]), now=100.1)
    assert s.stats["folded"] == 0


def test_lazy_window_case_of_ec_repair_equals_reference():
    """The lazy-window case of `tests/test_ec_repair.py`: two co-stripe
    losses seen by scans 0.4 s apart inside a 1 s window dispatch as ONE
    two-target task, in both packages."""
    out = []
    for pkg in (REF, PORT):
        s = _lazy_sched(pkg, 1.0)
        s.offer(pkg.task("ec_rebuild", vid=5, targets=[2], missing=1), now=10.0)
        assert s.next_task(now=10.2) is None
        s.offer(pkg.task("ec_rebuild", vid=5, targets=[2, 11], missing=2), now=10.4)
        t = s.next_task(now=10.4)
        out.append((t.to_dict(), s.stats, s.snapshot(now=10.4), s.pressure(now=10.4)))
    assert out[0] == out[1]
    assert out[1][0]["params"]["targets"] == [2, 11]


# --- the detectors --------------------------------------------------------------
class _FakeMaster:
    def __init__(self, topo, garbage_threshold=0.3):
        self.topo = topo
        self.garbage_threshold = garbage_threshold


def _hb(port, volumes=(), ec=()):
    return {"ip": "127.0.0.1", "port": port, "public_url": f"127.0.0.1:{port}",
            "max_volume_count": 10, "volumes": list(volumes), "ec_shards": list(ec)}


def _vol(vid, size=1000, deleted=0, rp=10, read_only=False):
    return {"id": vid, "size": size, "deleted_byte_count": deleted,
            "replica_placement": rp, "read_only": read_only}


def _tasks(tasks) -> list:
    """Task dicts; a divergence finding's `detected_at` is the clock of
    its making (a dataclass default bound to `time.time` at import)."""
    out = []
    for t in tasks:
        d = t.to_dict()
        for f in d["params"].get("findings", ()):
            if f["kind"] == "replica_divergence":
                f.pop("detected_at")
        out.append(d)
    return out


def _both_topos(*hbs):
    topos = []
    for pkg in (REF, PORT):
        topo = pkg.Topology(pulse_seconds=1)
        for hb in hbs:
            topo.sync_heartbeat(dict(hb))
        topos.append(topo)
    return topos


@BOTH
def test_under_replicated(pkg):
    topo = pkg.Topology(pulse_seconds=1)
    topo.sync_heartbeat(_hb(11, [_vol(1), _vol(2)]))
    topo.sync_heartbeat(_hb(12, [_vol(1)]))
    tasks = pkg.det.detect_under_replicated(_FakeMaster(topo))
    assert [t.volume_id for t in tasks] == [2]
    assert tasks[0].type == "fix_replication" and tasks[0].node == "127.0.0.1:11"
    assert tasks[0].params == {"have": 1, "want": 2}


@BOTH
def test_ec_missing_shards_recoverable_only(pkg):
    topo = pkg.Topology(pulse_seconds=1)
    topo.sync_heartbeat(_hb(11, ec=[
        {"id": 5, "collection": "c", "ec_index_bits": sum(1 << s for s in range(10))},
        {"id": 6, "collection": "c", "ec_index_bits": sum(1 << s for s in range(4))},
    ]))
    tasks = pkg.det.detect_ec_missing_shards(_FakeMaster(topo))
    assert [t.volume_id for t in tasks] == [5]
    assert tasks[0].type == "ec_rebuild" and tasks[0].collection == "c"
    assert tasks[0].params["missing"] == 4
    assert tasks[0].params["targets"] == [10, 11, 12, 13]


@BOTH
def test_vacuum_candidates(pkg):
    topo = pkg.Topology(pulse_seconds=1)
    topo.sync_heartbeat(_hb(11, [_vol(1, size=1000, deleted=500),
                                 _vol(2, size=1000, deleted=10),
                                 _vol(3, size=1000, deleted=900, read_only=True)]))
    tasks = pkg.det.detect_vacuum_candidates(_FakeMaster(topo))
    assert [t.volume_id for t in tasks] == [1]
    assert tasks[0].type == "vacuum" and tasks[0].params["garbage_ratio"] == 0.5


@BOTH
def test_vacuum_skips_scrub_held_volume(pkg):
    topo = pkg.Topology(pulse_seconds=1)
    hb = _hb(11, [_vol(1, size=1000, deleted=500), _vol(2, size=1000, deleted=600)])
    hb["scrub_active"] = [1]
    topo.sync_heartbeat(hb)
    assert [t.volume_id for t in pkg.det.detect_vacuum_candidates(_FakeMaster(topo))] == [2]
    hb["scrub_active"] = []
    topo.sync_heartbeat(hb)
    assert sorted(t.volume_id for t in
                  pkg.det.detect_vacuum_candidates(_FakeMaster(topo))) == [1, 2]


@BOTH
def test_imbalance(pkg):
    topo = pkg.Topology(pulse_seconds=1)
    topo.sync_heartbeat(_hb(11, [_vol(i, rp=0) for i in range(1, 6)]))
    topo.sync_heartbeat(_hb(12, [_vol(9, rp=0)]))
    tasks = pkg.det.detect_imbalance(_FakeMaster(topo))
    assert len(tasks) == 1 and tasks[0].type == "balance"
    assert tasks[0].node == "127.0.0.1:11"
    assert pkg.det.detect_imbalance(_FakeMaster(topo), slack=10) == []


@BOTH
def test_stale_nodes(pkg):
    topo = pkg.Topology(pulse_seconds=1)
    topo.sync_heartbeat(_hb(11, [_vol(1)]))
    topo.sync_heartbeat(_hb(12, [_vol(1)]))
    topo.find_node("127.0.0.1:12").last_seen = time.time() - 4
    tasks = pkg.det.detect_stale_nodes(_FakeMaster(topo))
    assert [t.node for t in tasks] == ["127.0.0.1:12"]
    assert tasks[0].type == "evacuate"


@BOTH
def test_scan_runs_selected_detectors(pkg):
    topo = pkg.Topology(pulse_seconds=1)
    topo.sync_heartbeat(_hb(11, [_vol(1, deleted=900)]))
    m = _FakeMaster(topo)
    assert {"fix_replication", "vacuum"} <= {t.type for t in pkg.det.scan(m)}
    assert {t.type for t in pkg.det.scan(m, types=("vacuum",))} == {"vacuum"}


@BOTH
def test_scan_survives_a_broken_detector(pkg, monkeypatch, caplog):
    topo = pkg.Topology(pulse_seconds=1)
    topo.sync_heartbeat(_hb(11, [_vol(1, deleted=900)]))

    def boom(master):
        raise RuntimeError("detector bug")

    monkeypatch.setitem(pkg.det.DETECTORS, "fix_replication", boom)
    monkeypatch.setattr(pkg.det, "_warned_detectors", set())
    tasks = pkg.det.scan(_FakeMaster(topo))
    assert {t.type for t in tasks} == {"vacuum"}
    assert "fix_replication" in pkg.det._warned_detectors


def _seeded_heartbeats(seed: int) -> list[dict]:
    """Heartbeats of 5 nodes over 3 racks: replicated, under-replicated,
    garbage-heavy, read-only, scrub-held and online-EC volumes (some with
    damaged parity), digests that disagree, EC shard sets from lost to
    whole, and scrub findings."""
    rng = np.random.default_rng(seed)
    hbs = []
    digests = ["d0", "d1", "d2", "e3b0c44298fc1c14"]
    for i in range(5):
        vols, ec, findings = [], [], []
        for vid in range(1, 13):
            if rng.random() < 0.45:
                online = vid in (11, 12)
                vols.append({
                    "id": vid, "collection": "c" if vid % 3 == 0 else "",
                    "size": int(rng.integers(1000, 1 << 20)),
                    "file_count": int(rng.integers(1, 99)),
                    "deleted_byte_count": int(rng.integers(0, 1 << 19)),
                    "replica_placement": 0 if online else int(rng.choice([0, 1, 10, 100])),
                    "read_only": bool(rng.random() < 0.1),
                    "ec_online": online,
                    "ec_online_parity_damaged": int(rng.integers(0, 3)) if online else 0,
                    "needle_digest": str(rng.choice(digests)),
                })
        for vid in (20, 21, 22):
            bits = int(rng.integers(0, 1 << 14)) & int(rng.integers(0, 1 << 14) | 0x3FF0)
            if bits:
                ec.append({"id": vid, "collection": "e", "ec_index_bits": bits})
        for k in range(int(rng.integers(0, 3))):
            findings.append({
                "kind": str(rng.choice(["corrupt_needle", "corrupt_shard",
                                        "parity_mismatch", "tmp_litter"])),
                "volume_id": int(rng.integers(1, 13)), "node": f"127.0.0.1:{21 + i}",
                "collection": "", "needle": int(rng.integers(1, 50)),
                "detail": f"finding {k}", "detected_at": 1.0,
            })
        hb = _hb(21 + i, vols, ec)
        hb["rack"] = f"r{i % 3}"
        hb["scrub_findings"] = findings
        hb["scrub_active"] = [int(v) for v in rng.choice(12, 2) + 1]
        hbs.append(hb)
    return hbs


@pytest.mark.parametrize("seed", range(4))
def test_scan_equals_reference_on_the_same_heartbeats(seed, monkeypatch):
    frozen = 1_700_000_000.0
    monkeypatch.setattr(time, "time", lambda: frozen)
    ref_topo, port_topo = _both_topos(*_seeded_heartbeats(seed))
    for topo in (ref_topo, port_topo):
        topo.find_node("127.0.0.1:23").last_seen = frozen - 3.7
        topo.find_node("127.0.0.1:25").last_seen = frozen - 1.5
    want = _tasks(REF.det.scan(_FakeMaster(ref_topo)))
    got = _tasks(PORT.det.scan(_FakeMaster(port_topo)))
    assert got == want
    assert len({t["type"] for t in got}) >= 4
    for name in REF.det.DETECTORS:
        assert _tasks(PORT.det.scan(_FakeMaster(port_topo), types=(name,))) == \
            _tasks(REF.det.scan(_FakeMaster(ref_topo), types=(name,))), name


# --- the daemon, unit -----------------------------------------------------------
@BOTH
def test_daemon_maps_alerts_to_scans(pkg):
    d = pkg.maint.MaintenanceDaemon(_FakeMaster(pkg.Topology(pulse_seconds=1)))
    d._on_alert("disk_near_cap", {})
    assert d._pending_types == {"vacuum", "balance"}
    assert d._wake.is_set()
    d._wake.clear()
    d._on_alert("http_error_ratio", {})
    assert not d._wake.is_set()


@pytest.mark.parametrize("name", sorted(REF.maint.ALERT_SCANS))
def test_every_alert_maps_like_reference(name):
    got = []
    for pkg in (REF, PORT):
        d = pkg.maint.MaintenanceDaemon(_FakeMaster(pkg.Topology(pulse_seconds=1)))
        d._on_alert(name, {"severity": "warning"})
        got.append((set(d._pending_types), d._wake.is_set()))
    assert got[0] == got[1] and got[1][1]


# --- a port cluster heals itself -------------------------------------------------
@pytest.fixture
def cluster(tmp_path):
    master = MasterServer(port=0, pulse_seconds=1, volume_size_limit_mb=64,
                          maintenance_interval=0.25)
    master.start()
    servers = []
    try:
        for i, rack in enumerate(["r1", "r2", "r3"]):
            vs = VolumeServer([str(tmp_path / f"v{i}")], master.url, port=0,
                              rack=rack, pulse_seconds=1, max_volume_count=30,
                              scrub_rate_mb=0, device="cpu")
            vs.start()
            servers.append(vs)
        yield master, servers, CommandEnv(master.url)
    finally:
        master.stop()  # the daemon's pool and lease thread end first
        for vs in servers:
            vs.stop()


def write_blobs(master_url, n=10, size=500, seed=0, **params):
    rng = np.random.default_rng(seed)
    out = {}
    qs = "&".join(f"{k}={v}" for k, v in params.items())
    for _ in range(n):
        a = get_json(f"{master_url}/dir/assign?{qs}")
        url = f"http://{a['publicUrl']}/{a['fid']}"
        data = rng.bytes(size)
        status, _, _ = http_request("POST", url, data)
        assert status == 201
        out[url] = data
    return out


def wait_until(fn, timeout=30.0, interval=0.1, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


def history(master) -> list:
    return get_json(f"{master.url}/debug/maintenance")["history"]


def done(master, type_, state="completed") -> list:
    return [h for h in history(master)
            if h["task"]["type"] == type_ and h["state"] == state]


def allocate_evenly(master, servers, holders: dict, **params) -> None:
    """Allocate volumes `{vid: [server index, ...]}` before any assign, so
    the assigns write into them and grow none. Spread evenly, the volume
    counts stay within the balance detector's slack, and no balance task
    moves a volume while a test reads it (the chip phase's "two a server")."""
    for vid, idx in holders.items():
        for i in idx:
            post_json(f"{servers[i].url}/admin/allocate_volume",
                      {"volume": vid, **params})
    for vs in servers:
        vs.heartbeat_once()
    layout = {sv.id: sorted(sv.volumes) for sv in CommandEnv(master.url).servers()}
    assert sorted(v for vids in layout.values() for v in vids) == sorted(
        v for v, idx in holders.items() for _ in idx), layout


def daemon_idle(master) -> bool:
    """No task queued or in flight."""
    return get_json(f"{master.url}/debug/maintenance")["queue_depths"] == {}


def lose_a_replica(master, env, **params):
    write_blobs(master.url, 4, replication="010", **params)
    replicas = {vid: h for vid, h in env.volume_replicas().items() if len(h) == 2}
    vid, holders = next(iter(sorted(replicas.items())))
    env.post(f"{holders[0].http}/admin/delete_volume", {"volume": vid})
    return vid


def test_replica_loss_detected_and_healed(cluster):
    master, servers, env = cluster
    # one 010 volume on each pair of racks: two a server, so the balance
    # detector stays quiet through the loss and the heal
    allocate_evenly(master, servers, {1: [0, 1], 2: [1, 2], 3: [2, 0]},
                    replication="010")
    vid = lose_a_replica(master, env)
    assert master.topo.under_replicated_volumes()
    post_json(f"{master.url}/maintenance/enable")
    wait_until(lambda: len(env.volume_replicas().get(vid, [])) == 2,
               msg=f"volume {vid} re-replication")
    wait_until(lambda: not master.topo.under_replicated_volumes(),
               msg="no under-replicated volume")
    fixed = wait_until(lambda: done(master, "fix_replication"),
                       msg="fix_replication in history")
    assert any("replicated to" in a for h in fixed for a in h.get("applied", []))
    st = get_json(f"{master.url}/debug/maintenance")
    limits = st["scheduler"]["limits"]
    assert st["scheduler"]["stats"]["max_node_inflight"] <= limits["per_node_limit"]
    assert st["scheduler"]["stats"]["max_inflight"] <= limits["global_limit"]
    # healing is counted: tasks by type and state, seconds, no failure
    assert st["counts"]["fix_replication"]["completed"] >= 1
    assert st["seconds"]["fix_replication"] > 0
    assert "fix_replication" not in st["failures"]
    assert st["events"]["task_dispatched"] >= 1
    assert "fix_replication" in st["queue_depths"] or st["queue_depths"] == {}
    assert not done(master, "balance") and "balance" not in st["counts"]


def test_ec_shard_loss_detected_and_healed(cluster, tmp_path):
    """Lost shards come back through the daemon's ec_rebuild, every shard
    equal to the JAX writer's with the numpy codec."""
    master, servers, env = cluster
    vid, in_vol, obase = encode_one(master, servers, env, tmp_path, seed=3)
    ref_encoder.write_ec_files(obase, codec=RefCodec(backend="numpy"))
    ref_encoder.write_sorted_file_from_idx(obase)
    ref_encoder.save_volume_info(obase + ".vif", version=3)
    run_command(env, "unlock")  # the daemon's repairs take the admin lease
    holders = [sv for sv in env.servers() if vid in sv.ec_shards]
    victim = min(holders, key=lambda sv: len(sv.ec_shards[vid]))
    lost = list(victim.ec_shards[vid])
    assert len(lost) <= 4
    env.post(f"{victim.http}/admin/ec/delete_shards",
             {"volume": vid, "shards": lost, "delete_index": False})
    assert master.topo.ec_missing_shards()
    post_json(f"{master.url}/maintenance/enable")

    def all_shards_back():
        return len({s for sv in env.servers() for s in sv.ec_shards.get(vid, [])}) == 14

    wait_until(all_shards_back, msg=f"ec volume {vid} shard rebuild")
    wait_until(lambda: not master.topo.ec_missing_shards(), msg="no missing shard")
    rebuilt = wait_until(lambda: done(master, "ec_rebuild"), msg="ec_rebuild in history")
    assert any("rebuilt shards" in a for h in rebuilt for a in h["applied"])
    shards = [s for s in assert_equal_oracle(servers, vid, obase)
              if s in lost]
    assert shards == sorted(lost)
    for url, data in in_vol.items():
        status, _, body = http_request("GET", url)
        assert (status, body) == (200, data)


def test_codec_failure_fails_the_rebuild_task(cluster, tmp_path, monkeypatch):
    """A codec error on the volume servers fails the daemon's ec_rebuild
    with its reason in the history and the failure counters; no shard is
    rebuilt on the host in its place."""
    master, servers, env = cluster
    vid, _, _ = encode_one(master, servers, env, tmp_path, seed=4)
    run_command(env, "unlock")
    holders = [sv for sv in env.servers() if vid in sv.ec_shards]
    victim = min(holders, key=lambda sv: len(sv.ec_shards[vid]))
    env.post(f"{victim.http}/admin/ec/delete_shards",
             {"volume": vid, "shards": victim.ec_shards[vid], "delete_index": False})

    def boom(*a, **kw):
        raise RuntimeError("codec failed")

    monkeypatch.setattr(RSCodec, "apply2d_async", boom)
    post_json(f"{master.url}/maintenance/enable")
    failed = wait_until(lambda: done(master, "ec_rebuild", "failed"),
                        msg="failed ec_rebuild in history")
    assert "codec" in failed[0]["error"]
    st = get_json(f"{master.url}/debug/maintenance")
    assert st["failures"]["ec_rebuild"] >= 1
    assert not done(master, "ec_rebuild")
    present = {s for sv in env.servers() for s in sv.ec_shards.get(vid, [])}
    assert len(present) < 14


def test_vacuum_candidate_detected_and_compacted(cluster):
    master, servers, env = cluster
    # one volume a server: the balance detector stays quiet, so no balance
    # task moves the vacuumed volume between the lookup and the GET
    allocate_evenly(master, servers, {1: [0], 2: [1], 3: [2]})
    post_json(f"{master.url}/maintenance/enable")  # owns vacuum now
    blobs = write_blobs(master.url, 12, size=800)
    vid = int(fid_of(next(iter(blobs))).split(",")[0])
    in_vol = [u for u in blobs if f"/{vid}," in u]
    for url in in_vol[:-1]:
        status, _, _ = http_request("DELETE", url)
        assert status == 202
    for vs in servers:
        vs.heartbeat_once()

    def compacted():
        return any(v.get("garbage", 0) == 0 and v.get("size", 1) > 0
                   for sv in env.servers() for k, v in sv.volumes.items() if k == vid)

    wait_until(compacted, msg=f"volume {vid} vacuum")
    wait_until(lambda: done(master, "vacuum"), msg="vacuum in history")
    fid = fid_of(in_vol[-1])
    locs = get_json(f"{master.url}/dir/lookup?volumeId={vid}")
    status, _, body = http_request("GET", f"http://{locs['locations'][0]['url']}/{fid}")
    assert status == 200 and body == blobs[in_vol[-1]]
    # with the daemon idle, every holder a fresh lookup names serves it
    wait_until(lambda: daemon_idle(master), msg="daemon idle")
    assert not done(master, "balance")
    locs = get_json(f"{master.url}/dir/lookup?volumeId={vid}")["locations"]
    assert len(locs) == 1
    for loc in locs:
        status, _, body = http_request("GET", f"http://{loc['url']}/{fid}")
        assert status == 200 and body == blobs[in_vol[-1]], loc


def test_corrupt_needle_found_by_scrub_is_healed(cluster):
    """A flipped byte in one replica's needle, found by that server's scrub
    pass, is re-copied from the good replica by the daemon's scrub task."""
    master, servers, env = cluster
    # two volumes a server: no balance task moves one while the test reads
    allocate_evenly(master, servers, {1: [0, 1], 2: [1, 2], 3: [2, 0]},
                    replication="010")
    blobs = write_blobs(master.url, 6, size=1500, seed=5, replication="010")
    url = next(iter(blobs))
    vid = int(fid_of(url).split(",")[0])
    holders = [vs for vs in servers if vs.store.get_volume(vid) is not None]
    assert len(holders) == 2
    bad, good = holders
    key = int(fid_of(url).split(",")[1][:-8], 16)
    off, _ = bad.store.get_volume(vid).nm.get(key)
    path = bad.store.get_volume(vid).base_name + ".dat"
    with open(path, "r+b") as f:
        f.seek(off + 16 + 4 + 50)
        b = f.read(1)
        f.seek(off + 16 + 4 + 50)
        f.write(bytes([b[0] ^ 0xFF]))
    found = post_json(bad.url + "/admin/scrub/run", {})["findings"]
    assert [f["kind"] for f in found] == ["corrupt_needle"]
    post_json(f"{master.url}/maintenance/enable")
    # this volume's task: a transient digest divergence between two beats
    # can queue a scrub of another volume that completes first
    scrubbed = wait_until(
        lambda: [h for h in done(master, "scrub") if h["task"]["volume_id"] == vid],
        msg=f"scrub task of volume {vid} done")
    assert scrubbed[0]["applied"]
    assert post_json(bad.url + "/admin/scrub/run", {})["findings"] == []
    for vs in holders:
        status, _, body = http_request("GET", f"{vs.url}/{fid_of(url)}")
        assert (status, body) == (200, blobs[url])


def test_dry_run_plans_same_tasks_with_zero_mutations(cluster):
    master, servers, env = cluster
    vid = lose_a_replica(master, env)
    post_json(f"{master.url}/maintenance/enable", {"dryRun": True})
    planned = wait_until(
        lambda: [h for h in done(master, "fix_replication", "planned")
                 if h["task"]["volume_id"] == vid],
        msg="dry-run plan recorded")[0]
    assert any(f"volume {vid} (1/2 replicas): copy" in p for p in planned["planned"])
    assert "applied" not in planned
    time.sleep(1.0)  # several scan intervals: still nothing mutated
    assert len(env.volume_replicas().get(vid, [])) == 1
    assert master.topo.under_replicated_volumes()
    st = get_json(f"{master.url}/debug/maintenance")
    assert st["counts"]["fix_replication"]["planned"] >= 1
    assert "seconds" in st and "fix_replication" not in st["seconds"]
    # the real run carries out the plan the dry run showed
    post_json(f"{master.url}/maintenance/enable", {"dryRun": False})
    real = wait_until(lambda: done(master, "fix_replication"), msg="real run")[0]
    assert real["planned"] == planned["planned"]
    assert len(env.volume_replicas()[vid]) == 2


def test_cluster_maintenance_verb(cluster):
    master, servers, env = cluster
    assert "not configured" in run_command(env, "cluster.maintenance")
    out = run_command(env, "cluster.maintenance -enable -dryRun")
    assert "enabled" in out and "dry-run" in out
    out = run_command(env, "cluster.maintenance -status")
    assert "ENABLED" in out and "dry-run" in out
    assert "throttle:" in out and "fix_replication" in out and "pressure:" in out
    out = run_command(env, "cluster.maintenance -enable -lazyWindow 3")
    assert "lazy window 3s" in out
    st = get_json(f"{master.url}/debug/maintenance")
    assert st["pressure"]["lazy_window"] == 3.0 and "lazy_held" in st["pressure"]
    assert "lazy window 3s" in run_command(env, "cluster.maintenance -status")
    run_command(env, "cluster.maintenance -enable")
    assert master.maintenance.scheduler.lazy_window == 3.0
    run_command(env, "cluster.maintenance -enable -lazyWindow 0")
    assert master.maintenance.scheduler.lazy_window == 0.0
    assert "scan" in run_command(env, "cluster.maintenance -now vacuum")
    with pytest.raises(ShellError, match="unknown task type"):
        run_command(env, "cluster.maintenance -now frobnicate")
    with pytest.raises(ShellError, match="at most one"):
        run_command(env, "cluster.maintenance -enable -disable")
    with pytest.raises(ShellError, match="rebuildMode"):
        run_command(env, "cluster.maintenance -enable -rebuildMode fastest")
    assert "disabled" in run_command(env, "cluster.maintenance -disable")
    assert "DISABLED" in run_command(env, "cluster.maintenance")
    assert "dry-run" in run_command(env, "cluster.maintenance -enable")
    out = run_command(env, "cluster.maintenance -enable -apply -rebuildMode classic")
    assert "dry-run" not in out and "rebuild mode classic" in out
    assert master.maintenance.dry_run is False
    with pytest.raises(ShellError, match="only one of"):
        run_command(env, "cluster.maintenance -enable -dryRun -apply")


def test_render_status_equals_reference(cluster):
    """The port's `cluster.maintenance` renders a status dict exactly as
    the JAX verb does: live port statuses, with work queued, in flight,
    backing off and in the history, and the unconfigured reply."""
    master, servers, env = cluster
    unconfigured = get_json(f"{master.url}/debug/maintenance")
    assert port_cm._render_status(unconfigured) == ref_cm._render_status(unconfigured)
    lose_a_replica(master, env, seed=6)
    post_json(f"{master.url}/maintenance/enable", {"lazyWindow": 2.5})
    wait_until(lambda: done(master, "fix_replication"), msg="a task in history")
    d = master.maintenance
    s = d.scheduler
    now = time.time()
    s.offer(PORT.task("ec_rebuild", vid=77, node="nowhere:1", targets=[4]), now=now)
    s.offer(PORT.task("balance", vid=None, node="nowhere:2"), now=now)
    st = get_json(f"{master.url}/debug/maintenance")
    st["scheduler"]["backoff"] = [
        {"type": "vacuum", "target": 9, "failures": 2, "retry_in": 3.5}]
    st["history"].append({"task": PORT.task("vacuum", vid=9).to_dict(),
                          "state": "failed", "started": now, "duration_ms": 12.5,
                          "error": "boom", "retry_in": 3.5})
    got = port_cm._render_status(st)
    assert got == ref_cm._render_status(st)
    assert "lazy: dispatch in" in got and "backing off" in got and "boom" in got


def test_daemon_defers_to_operator_admin_lock(cluster):
    master, servers, env = cluster
    write_blobs(master.url, 4, replication="010")
    replicas = {vid: h for vid, h in env.volume_replicas().items() if len(h) == 2}
    vid, holders = next(iter(sorted(replicas.items())))
    run_command(env, "lock")
    env.post(f"{holders[0].http}/admin/delete_volume", {"volume": vid})
    post_json(f"{master.url}/maintenance/enable")
    wait_until(lambda: [h for h in done(master, "fix_replication", "failed")
                        if "locked by shell" in h.get("error", "")],
               timeout=10, msg="repair deferred while the lock is held")
    assert len(env.volume_replicas()[vid]) == 1
    run_command(env, "unlock")
    wait_until(lambda: len(env.volume_replicas().get(vid, [])) == 2,
               msg=f"volume {vid} heals after unlock")


def test_evacuate_executor_precopies_off_stale_node(cluster):
    master, servers, env = cluster
    write_blobs(master.url, 4, replication="010")
    sv = next(s for s in env.servers() if s.volumes)
    task = PORT.maint.RepairTask(type="evacuate", node=sv.id, priority=2)
    out = PORT.maint.execute(task, env, dry_run=True)
    assert out["planned"] and all("copy" in p for p in out["planned"])
    before = {vid: len(h) for vid, h in env.volume_replicas().items()}
    out = PORT.maint.execute(task, env, dry_run=False)
    assert out["applied"]
    after = env.volume_replicas()
    for vid in sv.volumes:
        assert len(after[vid]) == before[vid] + 1
        assert sum(1 for h in after[vid] if h.id != sv.id) >= before[vid]


def test_debug_maintenance_unconfigured(cluster):
    master, _, env = cluster
    assert get_json(f"{master.url}/debug/maintenance") == \
        {"configured": False, "enabled": False}
    status, _, _ = http_request("POST", f"{master.url}/maintenance/scan", b"{}")
    assert status == 400


def test_master_options_start_the_daemon_and_stop_it(tmp_path):
    """`maintenance=True` starts the daemon at boot with the master's
    options; stop() ends its scan, worker and lease threads."""
    import threading

    master = MasterServer(port=0, pulse_seconds=1, maintenance=True,
                          maintenance_dry_run=True, maintenance_interval=0.5,
                          repair_lazy_window=1.5)
    master.start()
    try:
        st = get_json(f"{master.url}/debug/maintenance")
        assert st["configured"] and st["enabled"] and st["dry_run"]
        assert st["interval"] == 0.5 and st["pressure"]["lazy_window"] == 1.5
        status, _, _ = http_request("POST", f"{master.url}/maintenance/enable",
                                    b'{"lazyWindow": -1}')
        assert status == 400
        assert get_json(f"{master.url}/vol/status") == {"Volumes": {}}
    finally:
        master.stop()
    assert master.maintenance is None
    alive = [t.name for t in threading.enumerate() if t.name.startswith("sw-maint")]
    assert alive == []


class TestDryRunApplyConvention:
    """volume.fix.replication / ec.rebuild / volume.balance / volume.vacuum
    share one -dryRun/-apply convention with the daemon's executors."""

    def test_fix_replication_dry_run(self, cluster):
        master, servers, env = cluster
        write_blobs(master.url, 4, replication="010")
        run_command(env, "lock")
        replicas = {vid: h for vid, h in env.volume_replicas().items() if len(h) == 2}
        vid, holders = next(iter(sorted(replicas.items())))
        env.post(f"{holders[0].http}/admin/delete_volume", {"volume": vid})
        out = run_command(env, "volume.fix.replication -dryRun")
        assert "dry run" in out and f"volume {vid}" in out and "copy" in out
        assert len(env.volume_replicas()[vid]) == 1
        assert "replicated to" in run_command(env, "volume.fix.replication -apply")
        assert len(env.volume_replicas()[vid]) == 2

    def test_vacuum_dry_run(self, cluster):
        master, servers, env = cluster
        post_json(f"{master.url}/vol/vacuum/disable")  # no pulse round
        blobs = write_blobs(master.url, 12, size=800)
        by_vid: dict[int, list] = {}
        for u in blobs:
            by_vid.setdefault(int(fid_of(u).split(",")[0]), []).append(u)
        vid, urls = max(by_vid.items(), key=lambda kv: len(kv[1]))
        assert len(urls) >= 2
        for url in urls[:-1]:
            http_request("DELETE", url)
        for vs in servers:
            vs.heartbeat_once()
        out = run_command(env, "volume.vacuum -dryRun")
        assert "dry run" in out and f"vacuum volume {vid}" in out
        sv = next(s for s in env.servers() if vid in s.volumes)
        assert sv.volumes[vid]["garbage"] > 0

    def test_ec_rebuild_dry_run(self, cluster, tmp_path):
        master, servers, env = cluster
        vid, _, _ = encode_one(master, servers, env, tmp_path, seed=7)
        holders = [sv for sv in env.servers() if vid in sv.ec_shards]
        victim = min(holders, key=lambda sv: len(sv.ec_shards[vid]))
        lost = list(victim.ec_shards[vid])
        env.post(f"{victim.http}/admin/ec/delete_shards",
                 {"volume": vid, "shards": lost, "delete_index": False})
        out = run_command(env, f"ec.rebuild -volumeId {vid} -dryRun")
        assert "dry run" in out and "rebuild shards" in out
        assert len({s for sv in env.servers()
                    for s in sv.ec_shards.get(vid, [])}) == 14 - len(lost)
        assert "rebuilt" in run_command(env, f"ec.rebuild -volumeId {vid}")
        assert len({s for sv in env.servers()
                    for s in sv.ec_shards.get(vid, [])}) == 14

    def test_balance_dry_run_and_conflict(self, cluster):
        master, servers, env = cluster
        write_blobs(master.url, 3)
        run_command(env, "lock")
        out = run_command(env, "volume.balance -dryRun")
        assert "dry run" in out or "nothing to balance" in out
        for verb in ("volume.vacuum", "volume.fix.replication", "volume.balance"):
            with pytest.raises(ShellError, match="only one of"):
                run_command(env, f"{verb} -dryRun -apply")
