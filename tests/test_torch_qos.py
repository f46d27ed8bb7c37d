"""QoS admission of the port: the JAX package's tests/test_qos.py over
seaweedfs_tpu_torch (token buckets, priority classes, burn-driven
shedding, the master's `?shard=` assign), then parity cases that feed the
same inputs through both packages.

Unit layers use injected clocks and sleeps; the live layers drive a port
master + volume + 2-filer cluster on the CPU through the real HTTP front
doors and assert every rejection is TYPED (429/503 + Retry-After +
machine-readable reason). Not carried: the filers' distinct gateway
ordinals (`TestLeaseShardingE2E::test_two_filers_get_distinct_ordinals`),
which the fid-lease sharding of the native fastlane reads.

Parity (exact equality): one fake clock and one admit sequence into both
packages' AdmissionController (Decisions, sleeps, status, exposition),
parse_limits_spec's results and errors, one burn sequence into both
actuators (ladder levels and transitions), the shed status codes, headers
and bodies of a JAX and a port filer and S3 gateway under one fake clock,
and `cluster.qos` against the JAX shell on one stub endpoint. Each test
resets the port's (and, where it arms it, the JAX package's) controller
and actuator.
"""

import json
import math
import threading
import time

import pytest

from seaweedfs_tpu_torch.qos import actuator as act_mod
from seaweedfs_tpu_torch.qos import admission as qos_mod
from seaweedfs_tpu_torch.qos.actuator import LEVELS, Actuator
from seaweedfs_tpu_torch.qos.admission import (
    AdmissionController,
    TokenBucket,
    classify,
    parse_limits_spec,
)
from seaweedfs_tpu_torch.server.httpd import get_json, http_request, post_json
from tests._threads import stop_history_loops  # noqa: F401


def _reset_singleton():
    """Return the process controller and actuator to their seed state (the
    suite runs in one process; qos state must not leak across tests)."""
    qos_mod.reset()
    act_mod.reset()


@pytest.fixture
def qos_clean():
    _reset_singleton()
    yield qos_mod.controller()
    _reset_singleton()


# --- token-bucket math (injected clock) --------------------------------------
class TestTokenBucket:
    def test_starts_full_and_debits(self):
        b = TokenBucket(10.0, 5.0, now=0.0)
        assert b.tokens == 5.0
        assert b.take(3.0, 0.0) == 0.0
        assert b.tokens == 2.0

    def test_refill_caps_at_burst(self):
        b = TokenBucket(10.0, 5.0, now=0.0)
        b.take(5.0, 0.0)
        assert b.take(1.0, 0.1) == 0.0  # 0.1s * 10/s = 1 token back
        b._refill(100.0)
        assert b.tokens == 5.0  # never above burst

    def test_take_does_not_debit_on_refusal(self):
        b = TokenBucket(2.0, 2.0, now=0.0)
        b.take(2.0, 0.0)
        w = b.take(1.0, 0.0)
        assert w == pytest.approx(0.5)  # 1 token at 2/s
        assert b.tokens == 0.0  # NOT driven negative

    def test_reserve_debits_unconditionally(self):
        b = TokenBucket(2.0, 2.0, now=0.0)
        b.take(2.0, 0.0)
        w = b.reserve(1.0, 0.0)
        assert w == pytest.approx(0.5)
        assert b.tokens == -1.0  # virtual scheduling: deficit owed

    def test_zero_rate_waits_forever(self):
        b = TokenBucket(0.0, 1.0, now=0.0)
        b.take(1.0, 0.0)
        assert b.wait_for(1.0) == math.inf


# --- priority classes --------------------------------------------------------
class TestClassify:
    def test_reads_interactive_writes_write(self):
        assert classify("GET") == "interactive"
        assert classify("HEAD") == "interactive"
        assert classify("PUT") == "write"
        assert classify("POST") == "write"
        assert classify("DELETE") == "write"

    def test_background_hint(self):
        # scans (S3 ListObjects) self-identify as background
        assert classify("GET", background_hint=True) == "background"

    def test_header_override_wins(self):
        h = {"X-Sw-Priority": "background"}
        assert classify("GET", h) == "background"
        assert classify("PUT", {"X-Sw-Priority": " Interactive "}) \
            == "interactive"

    def test_unknown_header_ignored(self):
        assert classify("GET", {"X-Sw-Priority": "vip"}) == "interactive"


# --- -qos.limits spec --------------------------------------------------------
class TestParseLimitsSpec:
    def test_full_spec(self):
        limits, default = parse_limits_spec("a=100,b=50:200,*=25")
        assert limits == {"a": (100.0, 200.0), "b": (50.0, 200.0)}
        assert default == (25.0, 50.0)  # burst defaults to rate * 2

    def test_empty_and_whitespace(self):
        assert parse_limits_spec("") == ({}, None)
        assert parse_limits_spec(" a=1 , ") == ({"a": (1.0, 2.0)}, None)

    @pytest.mark.parametrize("bad", ["a", "a=", "=5", "a=x", "a=1:-2",
                                     "a=-1"])
    def test_bad_pieces_raise(self, bad):
        with pytest.raises(ValueError):
            parse_limits_spec(bad)


# --- controller (injected clock + sleep) -------------------------------------
def _ctl(clock, sleeps=None):
    return AdmissionController(
        now=lambda: clock[0],
        sleep=(sleeps.append if sleeps is not None else (lambda s: None)))


class TestAdmissionController:
    def test_unlimited_collection_admits_and_counts(self):
        clock = [0.0]
        ctl = _ctl(clock)
        ctl.set_limits(limits={"a": 5})
        ctl.enable()
        assert ctl.admit("other", "interactive") is None
        # unlisted tenants fold into the bounded _other label
        from seaweedfs_tpu_torch.stats.usage import OTHER

        assert ctl.admitted_total == {("interactive", OTHER): 1}

    def test_over_limit_typed_429(self):
        clock = [0.0]
        ctl = _ctl(clock)
        ctl.set_limits(limits={"a": (1.0, 1.0)})
        ctl.enable()
        assert ctl.admit("a", "write") is None  # burst spent
        d = ctl.admit("a", "write")
        assert d.status == 429 and d.reason == "over_limit"
        assert d.retry_after == pytest.approx(1.0)
        h = d.headers()
        assert h["Retry-After"] == "1"
        assert h["X-Sw-Qos-Reason"] == "over_limit"
        assert h["X-Sw-Qos-Class"] == "write"
        assert d.to_dict()["reason"] == "over_limit"
        assert ctl.shed_total == {("write", "over_limit", "a"): 1}

    def test_queue_smooths_short_waits(self):
        clock, sleeps = [0.0], []
        ctl = _ctl(clock, sleeps)
        ctl.set_limits(limits={"a": (10.0, 1.0)})
        ctl.enable()
        assert ctl.admit("a", "write") is None
        assert sleeps == []
        # 1 token at 10/s = 0.1s wait <= queue_wait: queued, not shed
        assert ctl.admit("a", "write") is None
        assert sleeps == [pytest.approx(0.1)]
        assert ctl.queued_total[("write", "a")] == 1
        assert ctl.queued_total[("_waiting", "write")] == 0  # drained

    def test_queue_depth_bounds_waiters(self):
        clock, sleeps = [0.0], []
        ctl = _ctl(clock, sleeps)
        ctl.set_limits(limits={"a": (10.0, 1.0)}, queue_depth=0)
        ctl.enable()
        assert ctl.admit("a", "write") is None
        d = ctl.admit("a", "write")  # would queue, but depth is 0
        assert d.status == 429 and d.reason == "queue_full"
        assert sleeps == []

    def test_gate_zero_sheds_503(self):
        clock = [0.0]
        ctl = _ctl(clock)
        ctl.set_limits(limits={"a": 100})
        ctl.set_gates({"background": 0.0})
        ctl.enable()
        d = ctl.admit("a", "background")
        assert d.status == 503 and d.reason == "burn_shed"
        assert d.headers()["Retry-After"] == "2"
        # other classes still flow
        assert ctl.admit("a", "interactive") is None

    def test_fractional_gate_drains_faster(self):
        clock = [0.0]
        ctl = _ctl(clock)
        ctl.set_limits(limits={"a": (1.0, 2.0)})
        ctl.set_gates({"write": 0.5})
        ctl.enable()
        # cost 1 / gate 0.5 = 2 effective tokens: one request empties it
        assert ctl.admit("a", "write") is None
        d = ctl.admit("a", "write")
        assert d is not None and d.reason == "over_limit"

    def test_set_gates_rejects_unknown_class(self):
        ctl = _ctl([0.0])
        with pytest.raises(ValueError):
            ctl.set_gates({"vip": 0.5})

    def test_set_limits_preserves_spent_bucket(self):
        clock = [0.0]
        ctl = _ctl(clock)
        ctl.set_limits(limits={"a": (1.0, 10.0)})
        ctl.enable()
        for _ in range(10):
            assert ctl.admit("a", "write") is None
        ctl.set_limits(limits={"a": (1.0, 10.0), "b": 5})
        # the unchanged (rate, burst) kept its drained token level: a
        # no-op update must not re-grant a spent tenant a full burst
        d = ctl.admit("a", "write")
        assert d is not None and d.reason == "over_limit"
        # a CHANGED limit re-keys the bucket (fresh burst)
        ctl.set_limits(limits={"a": (2.0, 10.0)})
        assert ctl.admit("a", "write") is None

    def test_native_path_charge_and_over_limit(self):
        clock = [0.0]
        ctl = _ctl(clock)
        ctl.set_limits(limits={"a": (10.0, 10.0)})
        ctl.enable()
        assert not ctl.over_limit("a")
        ctl.charge("a", 25.0)  # native front door already served these
        assert ctl.over_limit("a")  # deficit: revoke native flags
        clock[0] += 10.0  # 100 tokens of refill, capped at burst
        assert not ctl.over_limit("a")
        # charge never sheds and unlimited tenants are never over
        ctl.charge("nolimit", 1e6)
        assert not ctl.over_limit("nolimit")

    def test_rearm_logic(self):
        ctl = _ctl([0.0])
        ctl.enable()
        assert not ctl.armed  # enabled but nothing to enforce
        ctl.set_limits(limits={"a": 1})
        assert ctl.armed
        ctl.set_limits(limits={})
        assert not ctl.armed
        ctl.set_gates({"background": 0.5})
        assert ctl.armed  # a tightened gate alone arms

    def test_metric_lines_render_all_families(self):
        clock = [0.0]
        ctl = _ctl(clock)
        ctl.set_limits(limits={"a": (1.0, 1.0)})
        ctl.enable()
        ctl.admit("a", "write")
        ctl.admit("a", "write")  # shed
        text = "\n".join(ctl._self_lines())
        for fam in qos_mod.QOS_FAMILIES:
            assert f"# TYPE {fam}" in text
        assert ('SeaweedFS_qos_shed_total{class="write",'
                'reason="over_limit",collection="a"} 1') in text
        assert 'SeaweedFS_qos_limit_rps{collection="a"} 1' in text


class TestDisarmedPath:
    def test_module_admit_is_one_attribute_check(self, monkeypatch):
        """The acceptance bar: with QoS off, the seam touches ONE
        attribute and never enters the controller (structural, like the
        faults/events disarmed guards)."""

        class Landmine:
            armed = False

            def admit(self, *a, **kw):  # pragma: no cover - must not run
                raise AssertionError("disarmed path entered the controller")

        monkeypatch.setattr(qos_mod, "_controller", Landmine())
        assert qos_mod.admit("any", "interactive") is None

    def test_disarmed_admit_cost(self, qos_clean):
        emit = qos_mod.admit
        for _ in range(1000):  # prewarm
            emit("c", "write")
        t0 = time.perf_counter()
        for _ in range(100_000):
            emit("c", "write")
        t = time.perf_counter() - t0
        # generous absolute guard (microVM): well under a second means
        # no real per-request overhead on unconfigured servers
        assert t < 1.0, f"100k disarmed admits took {t:.3f}s"


# --- burn-driven actuation (scripted burn source) ----------------------------
class TestActuator:
    def _pair(self):
        clock = [0.0]
        ctl = _ctl(clock)
        ctl.set_limits(limits={"a": 1000})
        ctl.enable()
        burn = [0.0]
        act = Actuator(controller=ctl, burn_source=lambda: burn[0],
                       fast_burn=14.0, hold=2, now=lambda: clock[0])
        return ctl, act, burn, clock

    def test_tighten_one_step_per_burning_tick(self):
        ctl, act, burn, _ = self._pair()
        burn[0] = 20.0
        assert act.step() == 1
        assert ctl.gates() == {"background": 0.5}
        assert act.step() == 2
        assert act.step() == 3
        assert act.step() == 3  # ladder is bounded
        assert ctl.gates() == {"background": 0.0, "write": 0.0}

    def test_relax_needs_hold_calm_ticks(self):
        ctl, act, burn, _ = self._pair()
        burn[0] = 20.0
        act.step()
        act.step()  # level 2
        burn[0] = 0.0
        assert act.step() == 2  # calm 1/2
        assert act.step() == 1  # calm 2/2 -> relax
        assert act.step() == 1
        assert act.step() == 0
        assert ctl.gates() == {}

    def test_moderate_burn_holds_level(self):
        ctl, act, burn, _ = self._pair()
        burn[0] = 20.0
        act.step()
        burn[0] = 5.0  # burning, but under the page threshold
        for _ in range(10):
            assert act.step() == 1  # neither tightens nor relaxes
        # and it resets the calm streak: 1 calm tick is not enough
        burn[0] = 0.0
        act.step()
        burn[0] = 5.0
        act.step()
        burn[0] = 0.0
        assert act.step() == 1

    def test_kick_is_rising_edge_fast_path(self):
        ctl, act, burn, _ = self._pair()
        act._on_fire("filer_slo_burn_fast", {})
        assert act.level == 1
        act._on_fire("some_other_rule", {})
        assert act.level == 1
        assert [t["why"] for t in act.transitions] == ["alert_edge"]

    def test_kick_debounced_to_one_step_per_interval(self):
        # a cold start trips every role's p99 rule in ONE evaluation
        # pass; those edges are one burn signal, not a ladder-length
        # stack of them (the live drive hit level 3 instantly here).
        ctl, act, burn, clock = self._pair()
        act._on_fire("filer_slo_burn_fast", {})
        act._on_fire("s3_slo_burn_fast", {})
        act._on_fire("filer_p99_slo_burn_fast", {})
        assert act.level == 1
        # a genuinely NEW edge, a full interval later, tightens again
        clock[0] += act.interval
        act._on_fire("filer_slo_burn_fast", {})
        assert act.level == 2

    def test_burn_source_exception_reads_zero(self):
        ctl = _ctl([0.0])

        def boom():
            raise RuntimeError("scripted source died")

        act = Actuator(controller=ctl, burn_source=boom)
        assert act.burn() == 0.0

    def test_burn_shed_retry_after_tracks_interval(self):
        ctl, act, burn, _ = self._pair()
        act.interval = 5.0
        burn[0] = 20.0
        act.step()
        assert ctl.burn_retry_after == 10.0

    def test_shed_alert_check_fires_on_interactive(self):
        from seaweedfs_tpu_torch.stats import alerts as alerts_mod

        class Hist:
            def __init__(self, rows):
                self.rows = rows

            def rates(self, family, window, now):
                assert family == "SeaweedFS_qos_shed_total"
                return self.rows

        p = dict(alerts_mod.DEFAULT_PARAMS)
        quiet = Hist([({"class": "background", "reason": "burn_shed"}, 9.0),
                      ({"class": "interactive", "reason": "over_limit"}, 0.2)])
        assert alerts_mod._check_qos_shed_interactive(quiet, 0.0, p) is None
        loud = Hist([({"class": "interactive", "reason": "over_limit"}, 2.0),
                     ({"class": "interactive", "reason": "queue_full"}, 0.5)])
        val, detail = alerts_mod._check_qos_shed_interactive(loud, 0.0, p)
        assert val == pytest.approx(2.5)
        assert "over_limit" in detail


# --- lease vid-space sharding ------------------------------------------------
class TestLeaseSharding:
    def test_volume_layout_shard_slice(self):
        from seaweedfs_tpu_torch.storage.types import ReplicaPlacement
        from seaweedfs_tpu_torch.topology.node import DataNode, VolumeInfo
        from seaweedfs_tpu_torch.topology.volume_layout import VolumeLayout

        lo = VolumeLayout(replica_placement=ReplicaPlacement.parse("000"),
                          ttl_u32=0)
        node = DataNode(ip="10.0.0.1", port=8080)
        for vid in range(1, 7):
            lo.register_volume(VolumeInfo(id=vid), node)
        for _ in range(20):
            vid, _locs = lo.pick_for_write(shard=(0, 2))
            assert vid % 2 == 0
            vid, _locs = lo.pick_for_write(shard=(1, 2))
            assert vid % 2 == 1
        # SOFT constraint: an empty slice falls back to the whole set
        vid, _locs = lo.pick_for_write(shard=(6, 7))
        assert vid in range(1, 7)


@pytest.fixture(scope="module")
def qos_cluster(tmp_path_factory):
    """master + volume + TWO filer gateways, QoS armed at boot via the
    -qos.limits flag path on f1 and inherited (same process singleton)
    by f2 — exactly how a 2-gateway deployment shares one policy."""
    from seaweedfs_tpu_torch.server.filer import FilerServer
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume import VolumeServer

    _reset_singleton()
    tmp = tmp_path_factory.mktemp("qos")
    master = MasterServer(port=0)
    master.start()
    vol = VolumeServer([str(tmp / "v")], master_url=master.url, port=0,
                       device="cpu")
    vol.start()
    vol.heartbeat_once()
    f1 = FilerServer(master_url=master.url, port=0, device="cpu",
                     qos_limits="abuser=1:5,victim=10000")
    f1.start()
    f2 = FilerServer(master_url=master.url, port=0, peers=[f1.url],
                     device="cpu")
    f2.start()
    f1._register_once()
    yield {"master": master, "vol": vol, "f1": f1, "f2": f2}
    _reset_singleton()
    f2.stop()
    f1.stop()
    vol.stop()
    master.stop()


class TestLeaseShardingE2E:
    def test_master_assign_filters_vid_space(self, qos_cluster):
        master = qos_cluster["master"]
        # seed the layout, then learn which vids exist
        get_json(f"{master.url}/dir/assign")
        from seaweedfs_tpu_torch.storage.types import ReplicaPlacement

        lo = master.topo.layout(
            "", ReplicaPlacement.parse(master.default_replication), 0)
        vids = lo.volume_ids()
        assert vids
        for i in (0, 1):
            slice_vids = [v for v in vids if v % 2 == i]
            for _ in range(8):
                out = get_json(f"{master.url}/dir/assign?shard={i}:2")
                vid = int(out["fid"].split(",")[0])
                if slice_vids:
                    assert vid % 2 == i, (vid, i, vids)
                else:  # soft fallback: still assigns
                    assert vid in vids

    def test_malformed_shard_is_400(self, qos_cluster):
        master = qos_cluster["master"]
        for bad in ("banana", "2:2", "-1:2", "1:0", "1"):
            status, _, body = http_request(
                "GET", f"{master.url}/dir/assign?shard={bad}")
            assert status == 400, bad
            assert "shard" in json.loads(body)["error"]


# --- runtime config + typed sheds through the live front door ----------------
class TestRuntimeLimits:
    def test_flag_path_armed_the_singleton(self, qos_cluster):
        ctl = qos_mod.controller()
        assert ctl.armed
        assert ctl._limits["abuser"] == (1.0, 5.0)

    def test_get_qos_limits_route(self, qos_cluster):
        for gw in (qos_cluster["f1"], qos_cluster["f2"]):
            out = get_json(gw.url + "/qos/limits")
            assert out["armed"] is True
            assert out["limits"]["abuser"] == [1.0, 5.0]
            assert out["role"] == "filer"
            # /debug/qos is the same payload
            assert get_json(gw.url + "/debug/qos")["armed"] is True

    def test_post_updates_limits_at_runtime(self, qos_cluster):
        f2 = qos_cluster["f2"]
        out = post_json(f2.url + "/qos/limits",
                        {"spec": "abuser=1:5,victim=10000,newcomer=7",
                         "queue_wait": 0.05})
        assert out["ok"] and out["armed"]
        ctl = qos_mod.controller()
        assert ctl._limits["newcomer"] == (7.0, 14.0)
        assert ctl.queue_wait == 0.05
        post_json(f2.url + "/qos/limits",
                  {"spec": "abuser=1:5,victim=10000",
                   "queue_wait": qos_mod.DEFAULT_QUEUE_WAIT})

    def test_post_bad_spec_is_400(self, qos_cluster):
        f1 = qos_cluster["f1"]
        status, _, body = http_request(
            "POST", f1.url + "/qos/limits",
            json.dumps({"spec": "a=banana"}).encode(),
            {"Content-Type": "application/json"})
        assert status == 400
        assert "banana" in json.loads(body)["error"]

    def test_typed_429_through_filer(self, qos_cluster):
        f1 = qos_cluster["f1"]
        statuses = []
        for i in range(8):
            status, hdrs, body = http_request(
                "PUT", f"{f1.url}/t429/f{i}.txt?collection=abuser", b"x")
            statuses.append(status)
            if status == 429:
                assert int(hdrs["Retry-After"]) >= 1
                assert hdrs["X-Sw-Qos-Reason"] == "over_limit"
                assert hdrs["X-Sw-Qos-Class"] == "write"
                out = json.loads(body)
                assert out["reason"] == "over_limit"
                assert out["collection"] == "abuser"
        assert 429 in statuses  # burst 5 cannot cover 8 instant writes
        assert set(statuses) <= {201, 429}  # never an untyped failure

    def test_typed_503_when_class_gated(self, qos_cluster):
        f2 = qos_cluster["f2"]
        ctl = qos_mod.controller()
        ctl.set_gates({"background": 0.0})
        try:
            status, hdrs, body = http_request(
                "GET", f"{f2.url}/t503/none.txt?collection=victim", None,
                {"X-Sw-Priority": "background"})
            assert status == 503
            assert hdrs["X-Sw-Qos-Reason"] == "burn_shed"
            assert int(hdrs["Retry-After"]) >= 1
            assert json.loads(body)["reason"] == "burn_shed"
            # interactive traffic is untouched by the background gate
            status, _, _ = http_request(
                "GET", f"{f2.url}/t503/none.txt?collection=victim")
            assert status == 404  # admitted; the file just isn't there
        finally:
            ctl.set_gates({})

    def test_shed_is_not_a_service_failure_in_metrics(self, qos_cluster):
        # shed 5xx counted in http_request_total would burn the very
        # availability SLO the actuator watches — a self-sustaining
        # death spiral (seen live: 9 sheds -> 500x availability burn).
        # qos_shed_total is the canonical record; the request counter
        # and latency histogram must both skip shed responses.
        from seaweedfs_tpu_torch.stats import default_registry
        from seaweedfs_tpu_torch.stats.metrics import parse_exposition

        def filer_5xx():
            return sum(
                v for name, labels, v
                in parse_exposition(default_registry().render())
                if name == "SeaweedFS_http_request_total"
                and labels.get("role") == "filer"
                and labels.get("code", "").startswith("5"))

        f1 = qos_cluster["f1"]
        ctl = qos_mod.controller()
        ctl.set_gates({"background": 0.0})
        try:
            before = filer_5xx()
            shed_before = sum(
                n for k, n in ctl.shed_total.items()
                if k[0] == "background")
            for _ in range(5):
                status, hdrs, _ = http_request(
                    "GET", f"{f1.url}/nospiral/x.txt?collection=victim",
                    None, {"X-Sw-Priority": "background"})
                assert status == 503
                assert "X-Sw-Qos-Reason" in hdrs
            assert filer_5xx() == before
            assert sum(
                n for k, n in ctl.shed_total.items()
                if k[0] == "background") == shed_before + 5
        finally:
            ctl.set_gates({})


# --- chaos: abusive tenant flood on the live 2-gateway cluster ---------------
class TestAbusiveTenantFlood:
    def test_victim_p99_and_typed_only_errors(self, qos_cluster):
        f1, f2 = qos_cluster["f1"], qos_cluster["f2"]
        gws = [f1, f2]
        # a CHANGED (rate, burst) re-keys the abuser's bucket: the flood
        # starts from a fresh burst regardless of earlier tests' drain
        post_json(f1.url + "/qos/limits",
                  {"spec": "abuser=5:10,victim=10000"})
        # seed a victim object through each gateway
        for gw in gws:
            s, _, _ = http_request(
                "PUT", f"{gw.url}/flood/v.txt?collection=victim", b"victim")
            assert s == 201
        abuser_statuses: list[tuple[int, dict]] = []
        victim_lat: list[float] = []
        errors: list[str] = []
        stop = threading.Event()

        def abuse(i):
            n = 0
            while not stop.is_set():
                gw = gws[n % 2]
                try:
                    s, h, _ = http_request(
                        "PUT",
                        f"{gw.url}/flood/a{i}_{n}.txt?collection=abuser",
                        b"junk", timeout=5)
                    abuser_statuses.append((s, dict(h)))
                except Exception as e:  # pragma: no cover - must not happen
                    errors.append(f"abuser: {e!r}")
                n += 1

        def victim():
            while not stop.is_set():
                gw = gws[len(victim_lat) % 2]
                t0 = time.perf_counter()
                try:
                    s, _, body = http_request(
                        "GET", f"{gw.url}/flood/v.txt?collection=victim",
                        timeout=5)
                    if s != 200 or body != b"victim":
                        errors.append(f"victim: {s}")
                except Exception as e:  # pragma: no cover
                    errors.append(f"victim: {e!r}")
                victim_lat.append(time.perf_counter() - t0)

        threads = [threading.Thread(target=abuse, args=(i,))
                   for i in range(4)] + [threading.Thread(target=victim)]
        for t in threads:
            t.start()
        time.sleep(2.0)
        stop.set()
        for t in threads:
            t.join(timeout=10)

        assert errors == []
        assert len(victim_lat) >= 10
        shed = [s for s, _ in abuser_statuses if s in (429, 503)]
        ok = [s for s, _ in abuser_statuses if s == 201]
        assert shed, "the flood never tripped admission"
        assert ok, "the abuser's in-limit slice still lands"
        # every rejection is typed: 429/503 with Retry-After + reason
        for s, h in abuser_statuses:
            assert s in (201, 429, 503), f"untyped status {s}"
            if s in (429, 503):
                assert "Retry-After" in h and "X-Sw-Qos-Reason" in h
        # victims keep flowing: a generous absolute p99 bound (microVM)
        lat = sorted(victim_lat)
        p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))]
        assert p99 < 2.0, f"victim p99 {p99:.3f}s under abusive flood"
        # the sheds are observable: counters + journal
        ctl = qos_mod.controller()
        assert any(k[1] == "over_limit" and k[2] == "abuser"
                   for k in ctl.shed_total)
        # re-key back to the module policy (fresh bucket for later tests)
        post_json(f1.url + "/qos/limits",
                  {"spec": "abuser=1:5,victim=10000"})

    def test_shell_surfaces_the_flood(self, qos_cluster):
        from seaweedfs_tpu_torch.shell import CommandEnv, run_command

        env = CommandEnv(qos_cluster["master"].url)
        show = run_command(env, "cluster.qos")
        assert "armed" in show and "abuser=" in show
        assert "shed:" in show  # the flood's counters render
        # cluster.why resolves the abuser's qos_shed timeline
        why = run_command(env, "cluster.why abuser")
        assert "qos_shed" in why
        # the setter fans out to every gateway
        out = run_command(
            env, "cluster.qos -limit 'abuser=1:5,victim=10000,extra=3'")
        assert "applied" in out
        assert qos_mod.controller()._limits["extra"] == (3.0, 6.0)
        run_command(env, "cluster.qos -limit 'abuser=1:5,victim=10000'")


# --- sustained interactive shedding is an incident ---------------------------
class TestInteractiveShedAlert:
    def test_cluster_check_fail_on_sustained_interactive_shed(
            self, qos_cluster):
        from seaweedfs_tpu_torch.shell import CommandEnv, run_command
        from seaweedfs_tpu_torch.shell.env import ShellError
        from seaweedfs_tpu_torch.stats import alerts as alerts_mod
        from seaweedfs_tpu_torch.stats import history as history_mod

        f1 = qos_cluster["f1"]
        hist = history_mod.default_history()
        eng = alerts_mod.engine()
        saved_window = eng.params["window"]
        eng.configure(window=10.0)
        try:
            hist.scrape_once()
            # sustained interactive-class shedding: drain the abuser's
            # burst, then hammer GETs that all shed over_limit
            for i in range(40):
                http_request(
                    "GET", f"{f1.url}/shedme/{i}.txt?collection=abuser")
            time.sleep(0.05)
            hist.scrape_once()
            eng.evaluate()
            assert "qos_shed_interactive" in eng.firing
            env = CommandEnv(qos_cluster["master"].url)
            with pytest.raises(ShellError, match="qos_shed_interactive"):
                run_command(env, "cluster.check -fail")
        finally:
            eng.configure(window=saved_window)
            hist.clear()
            eng.evaluate()
        assert "qos_shed_interactive" not in eng.firing


# --- the shed journal (tests/test_events.py's qos case) ----------------------
def test_qos_shed_journals_through_admission_seam(monkeypatch):
    """A typed admission rejection emits a `qos_shed` event carrying the
    collection correlation key, so `cluster.why <tenant>` renders the
    tenant's 429 timeline next to its degraded reads."""
    from seaweedfs_tpu_torch.stats import events

    rec = events.EventRecorder(capacity=16)
    rec.enable()
    monkeypatch.setattr(events, "_recorder", rec)
    clock = [100.0]
    ctl = qos_mod.AdmissionController(now=lambda: clock[0])
    ctl.set_limits(limits={"acme": (1.0, 1.0)})
    ctl.enable()
    assert ctl.admit("acme", "interactive") is None  # drains the bucket
    d = ctl.admit("acme", "interactive")  # 1s refill > queue_wait
    assert d is not None and d.status == 429
    evs = rec.events(type="qos_shed")
    assert len(evs) == 1
    ev = evs[0]
    assert ev["attrs"]["collection"] == "acme"
    assert ev["attrs"]["reason"] == "over_limit"
    assert ev["attrs"]["status"] == 429
    assert rec.events(collection="acme")[0]["type"] == "qos_shed"


# --- parity with the JAX package --------------------------------------------
import numpy as np  # noqa: E402

import seaweedfs_tpu.qos.actuator as ref_act  # noqa: E402
import seaweedfs_tpu.qos.admission as ref_qos  # noqa: E402

SEED = 20261018


def _ref_reset():
    """The JAX package's controller and actuator back to their seed state."""
    ctl = ref_qos.controller()
    with ctl._lock:
        ctl._limits = {}
        ctl._default = None
        ctl._buckets = {}
        ctl._gates = {}
        ctl.enabled = False
        ctl.queue_depth = ref_qos.DEFAULT_QUEUE_DEPTH
        ctl.queue_wait = ref_qos.DEFAULT_QUEUE_WAIT
        ctl.burn_retry_after = 2.0
        ctl.admitted_total = {}
        ctl.shed_total = {}
        ctl.queued_total = {}
        ctl._event_last = {}
        ctl._now = time.monotonic
        ctl._sleep = time.sleep
        ctl._rearm()
    a = ref_act._actuator
    if a is not None:
        a.stop()
        ref_act._actuator = None


def _admit_script(seed: int, n: int = 2000):
    """(clock step, collection, class, gates or None) steps."""
    rng = np.random.default_rng(seed)
    colls = ["abuser", "victim", "tenant-a", "tenant-b", "nolimit"]
    out = []
    for i in range(n):
        gates = None
        if i % 250 == 125:
            gates = [{}, {"background": 0.5}, {"background": 0.0,
                                               "write": 0.5}][int(rng.integers(0, 3))]
        out.append((float(rng.choice([0.0, 0.001, 0.01, 0.05, 0.3])),
                    colls[int(min(rng.zipf(1.5), 5)) - 1],
                    qos_mod.PRIORITY_CLASSES[int(rng.integers(0, 3))],
                    gates))
    return out


def test_admission_decisions_equal_reference():
    sides = []
    for mod in (qos_mod, ref_qos):
        clock, sleeps = [0.0], []

        def sleep(s, clock=clock, sleeps=sleeps):
            sleeps.append(s)
            clock[0] += s

        ctl = mod.AdmissionController(now=lambda clock=clock: clock[0],
                                      sleep=sleep)
        ctl.set_limits(limits={"abuser": (5.0, 10.0), "victim": 10000.0,
                               "tenant-a": [50.0, 20.0]},
                       default=(20.0, 30.0), queue_depth=4, queue_wait=0.2)
        ctl.enable()
        sides.append((ctl, clock, sleeps, []))
    for step, coll, cls, gates in _admit_script(SEED):
        for ctl, clock, sleeps, decisions in sides:
            clock[0] += step
            if gates is not None:
                ctl.set_gates(gates)
            d = ctl.admit(coll, cls)
            decisions.append(None if d is None else (d.to_dict(), d.headers()))
    (ours, _, s1, d1), (ref, _, s2, d2) = sides
    assert d1 == d2
    assert s1 == s2
    assert any(d is not None for d in d1) and any(d is None for d in d1)
    assert ours.status() == ref.status()
    assert ours._self_lines() == ref._self_lines()
    ours.charge("abuser", 25.0)
    ref.charge("abuser", 25.0)
    assert ours.over_limit("abuser") == ref.over_limit("abuser")


@pytest.mark.parametrize("spec", [
    "", " , ", "a=100", "tenant-a=100,tenant-b=50:200,*=25", "a=0:1",
    "a=1.5:2.5,b=0.25", "*=7", "a=banana", "a=", "=5", "a=-1", "a=1:0",
    "a=1:x", "a:1",
])
def test_parse_limits_spec_equal_reference(spec):
    def run(mod):
        try:
            return ("ok", mod.parse_limits_spec(spec))
        except ValueError as e:
            return ("error", str(e))

    assert run(qos_mod) == run(ref_qos)


def test_actuator_ladder_equal_reference():
    rng = np.random.default_rng(SEED)
    burns = []  # spells of one burn level: calm, moderate and paging
    while len(burns) < 400:
        level = float(rng.choice([0.0, 0.0, 0.5, 5.0, 14.0, 30.0]))
        burns.extend([level] * int(rng.integers(2, 15)))
    sides = []
    for adm, act_module in ((qos_mod, act_mod), (ref_qos, ref_act)):
        clock = [0.0]
        ctl = adm.AdmissionController(now=lambda clock=clock: clock[0])
        ctl.set_limits(limits={"a": 1000})
        ctl.enable()
        burn = [0.0]
        act = act_module.Actuator(controller=ctl, burn_source=lambda b=burn: b[0],
                                  fast_burn=14.0, hold=3,
                                  now=lambda clock=clock: clock[0])
        sides.append((ctl, act, burn, clock, []))
    for i, b in enumerate(burns):
        for ctl, act, burn, clock, levels in sides:
            clock[0] += 0.75
            burn[0] = b
            if i % 37 == 0:
                act._on_fire("filer_slo_burn_fast", {})
            levels.append((act.step(), ctl.gates(), ctl.burn_retry_after))
    (c1, a1, _, _, l1), (c2, a2, _, _, l2) = sides
    assert l1 == l2
    assert {lv for lv, _, _ in l1} == {0, 1, 2, 3}
    assert a1.transitions == a2.transitions


SHED_HEADERS = ("Retry-After", "X-Sw-Qos-Reason", "X-Sw-Qos-Class",
                "Content-Type")


def test_shed_answers_equal_reference(tmp_path):
    """A JAX and a port filer and S3 gateway, each package's controller
    armed with the same limits under one fake clock: the same requests get
    the same statuses, and every shed the same headers and body."""
    from tests.test_torch_s3 import s3_twin

    _reset_singleton()
    _ref_reset()
    try:
        with s3_twin(str(tmp_path)) as pair:
            clock = [1000.0]
            for mod in (qos_mod, ref_qos):
                ctl = mod.controller()
                ctl._now = lambda: clock[0]
                ctl._sleep = lambda s: clock.__setitem__(0, clock[0] + s)
                ctl.set_limits(limits={"abuser": (2.0, 3.0)},
                               default=(100.0, 200.0), queue_wait=0.1)
                ctl.enable()
            steps = []
            for i in range(6):
                steps.append(("filer", "PUT", f"/qos/a{i}.txt?collection=abuser",
                              b"x", {}))
            steps.append(("filer", "GET", "/qos/a0.txt?collection=abuser", None, {}))
            for i in range(6):
                steps.append(("s3", "PUT", f"/abuser/k{i}", b"y", {}))
            steps.append(("gate", {"background": 0.0}))
            steps.append(("s3", "GET", "/victim", None, {}))
            steps.append(("filer", "GET", "/qos/v.txt?collection=victim", None,
                          {"X-Sw-Priority": "background"}))
            steps.append(("gate", {}))
            steps.append(("tick", 5.0))
            steps.append(("filer", "PUT", "/qos/late.txt?collection=abuser", b"z", {}))
            answers = {"ref": [], "port": []}
            for side in pair.sides:
                name = side.side.name
                mod = ref_qos if name == "ref" else qos_mod
                for step in steps:
                    if step[0] == "gate":
                        mod.controller().set_gates(step[1])
                        continue
                    if step[0] == "tick":
                        clock[0] += step[1]
                        continue
                    where, method, path, body, hdrs = step
                    base = side.side.filer.url if where == "filer" else side.s3.url
                    st, h, out = side.http_request(method, base + path, body, hdrs)
                    if st in (429, 503):
                        answers[name].append(
                            (where, st, {k: h.get(k) for k in SHED_HEADERS}, out))
                    else:
                        answers[name].append((where, st))
                clock[0] = 1000.0
                for m in (qos_mod, ref_qos):
                    m.controller().set_limits(limits={"abuser": (2.0, 3.0)},
                                              default=(100.0, 200.0),
                                              queue_wait=0.1)
                    with m.controller()._lock:
                        m.controller()._buckets = {}
            assert answers["port"] == answers["ref"]
            sheds = [a for a in answers["port"] if len(a) == 4]
            assert {(w, st) for w, st, _, _ in sheds} >= {
                ("filer", 429), ("s3", 429), ("s3", 503), ("filer", 503)}
            s3_bodies = [b for w, _, _, b in sheds if w == "s3"]
            assert any(b"<Code>SlowDown</Code>" in b for b in s3_bodies)
            assert any(b"<Code>ServiceUnavailable</Code>" in b for b in s3_bodies)
    finally:
        _reset_singleton()
        _ref_reset()
        for mod in (qos_mod,):
            mod.controller()._now = time.monotonic
            mod.controller()._sleep = time.sleep


QOS_ROUTE = {
    "proc": "p1", "role": "filer", "armed": True,
    "limits": {"abuser": [5.0, 10.0], "victim": [10000.0, 20000.0]},
    "default": [200.0, 400.0],
    "gates": {"background": 0.0, "write": 0.5, "interactive": 1.0},
    "actuator": {"level": 2, "burn": 17.25, "fast_burn": 14.0},
    "shed": {"write": {"over_limit:abuser": 812, "burn_shed:abuser": 3},
             "background": {"burn_shed:victim": 40},
             "interactive": {"over_limit:abuser": 9, "queue_full:abuser": 1}},
}


@pytest.mark.parametrize("line", [
    "cluster.qos", "cluster.qos -show",
    "cluster.qos -limit 'abuser=5:10,*=200'",
    "cluster.qos -default 7 -queueDepth 3 -queueWait 0.5",
])
def test_cluster_qos_equals_reference_on_stub(line):
    from seaweedfs_tpu.shell import CommandEnv as RefCommandEnv
    from seaweedfs_tpu.shell import run_command as ref_run_command
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    from tests.test_torch_usage_heat import JsonStub

    stub = JsonStub({"/debug/qos": QOS_ROUTE})
    try:
        want = ref_run_command(RefCommandEnv(stub.url), line)
        ref_posts = list(stub.posts)
        stub.posts.clear()
        got = run_command(CommandEnv(stub.url), line)
        assert got == want
        assert stub.posts == ref_posts
    finally:
        stub.stop()


def test_cluster_qos_errors_equal_reference():
    from seaweedfs_tpu.shell import CommandEnv as RefCommandEnv
    from seaweedfs_tpu.shell import run_command as ref_run_command
    from seaweedfs_tpu.shell.env import ShellError as RefShellError
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    from seaweedfs_tpu_torch.shell.env import ShellError

    for line in ("cluster.qos", "cluster.qos -default x",
                 "cluster.qos -limit 'a=1'"):
        with pytest.raises(RefShellError) as a:
            ref_run_command(RefCommandEnv("http://127.0.0.1:1"), line)
        with pytest.raises(ShellError) as b:
            run_command(CommandEnv("http://127.0.0.1:1"), line)
        assert str(b.value) == str(a.value)


@pytest.fixture(autouse=True, scope="module")
def _disarm_controllers():
    """Disarm both packages' controllers and stop their actuators when this
    module is done, so no thread or armed state outlives it (the history
    loops: `stop_history_loops`)."""
    yield
    _reset_singleton()
    _ref_reset()
