"""The port's fault-injection registry and its seams held against the JAX
package's (`util/faults.py`).

The same arming and the same seeded sequence of seam calls go to both
registries: every mode's effect (what `hit` raises, what `mangle` returns),
the firing counts, `snapshot` and `arm_from_spec` must be equal. The seams
are driven through both packages on the same seeded volumes: a `corrupt`
write found by both scrubbers with equal findings, a torn `.dat` write, a
torn parity write detected by `parity_health` and healed by `rearm` to
byte-equal parity, and sealed shard reads failed or flipped. The
`/debug/faults` routes answer as the JAX ones do, POST only once the
process opted in, and `cluster.faults` arms, lists and disarms over both
clusters with equal output. The port runs on `device="cpu"`. Tolerance 0.
"""

from __future__ import annotations

import json
import os
import random
import re

import numpy as np
import pytest

from seaweedfs_tpu.server import httpd as ref_httpd
from seaweedfs_tpu.shell import run_command as ref_run
from seaweedfs_tpu.storage.erasure_coding import encoder as ref_encoder
from seaweedfs_tpu.storage.erasure_coding.ec_volume import EcVolume as RefEcVolume
from seaweedfs_tpu.storage.erasure_coding.online import OnlineEcWriter as RefWriter
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu.util import faults as ref_faults
from seaweedfs_tpu_torch.ops.rs_kernel import RSCodec
from seaweedfs_tpu_torch.server.httpd import HTTPService, get_json, http_request, post_json
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.shell import run_command
from seaweedfs_tpu_torch.storage.erasure_coding import encoder
from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import EcVolume
from seaweedfs_tpu_torch.storage.erasure_coding.online import OnlineEcWriter
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.util import faults
from tests.test_torch_scrub import assert_same_pass, clock, pair  # noqa: F401
from tests.test_torch_shell_volume import Shells
from tests.test_torch_volume_admin import allocate, fid, pinned_clock, twin, write
from tests._threads import stop_history_loops  # noqa: F401

PORT_POINTS = [p for p in ref_faults.ALL_POINTS if p != "volume.fastlane.drain"]


@pytest.fixture(autouse=True)
def _clean():
    for mod in (faults, ref_faults):
        mod.disarm_all()
    yield
    for mod in (faults, ref_faults):
        mod.disarm_all()


def outcome(fn):
    """What one seam call did: its return value, or the class and errno of
    what it raised."""
    try:
        return ("ok", fn())
    except Exception as e:
        return ("raised", type(e).__name__, getattr(e, "errno", None))


def test_points_and_modes_equal_reference():
    assert faults.MODES == ref_faults.MODES
    assert list(faults.ALL_POINTS) == PORT_POINTS
    with pytest.raises(ValueError, match="undeclared"):
        faults.register("volume.fastlane.drain")


@pytest.mark.parametrize("seed", range(6))
def test_seeded_seam_sequence_equals_reference(seed):
    """Random arming over all six modes, then seeded hit/mangle/draw calls
    with and without keys: each call's outcome, the returned bytes, the
    firing counts and the remaining spec are equal."""
    rng = np.random.default_rng(seed)
    keys = ["a:1", "b:2"]
    for _ in range(8):
        point = str(rng.choice(PORT_POINTS))
        spec = dict(mode=str(rng.choice(faults.MODES)),
                    frac=float(rng.choice([0.1, 0.25, 0.5, 1.0])),
                    count=int(rng.choice([-1, 1, 2, 4])),
                    after=int(rng.integers(0, 3)),
                    key=str(rng.choice(keys + [""])), ms=0.0)
        got = faults.arm(point, **spec)
        want = ref_faults.arm(point, **spec)
        assert got.to_dict() == want.to_dict()
        p, rp = faults.point(point), ref_faults.point(point)
        fired = (p.fired, rp.fired)
        for _ in range(10):
            key = None if rng.random() < 0.3 else str(rng.choice(keys))
            data = rng.bytes(int(rng.integers(0, 64)))
            call = str(rng.choice(["hit", "mangle", "draw"]))
            if call == "hit":
                a, b = outcome(lambda: p.hit(key=key)), outcome(lambda: rp.hit(key=key))
            elif call == "mangle":
                a = outcome(lambda: p.mangle(data, key=key, volume=3))
                b = outcome(lambda: rp.mangle(data, key=key, volume=3))
            else:
                a = outcome(lambda: (s := p.draw(key, volume=3)) and s.to_dict())
                b = outcome(lambda: (s := rp.draw(key, volume=3)) and s.to_dict())
            assert a == b, (spec, call, key)
        assert p.fired - fired[0] == rp.fired - fired[1]
        assert (p.spec and p.spec.to_dict()) == (rp.spec and rp.spec.to_dict())


@pytest.mark.parametrize("mode", ["torn", "corrupt"])
@pytest.mark.parametrize("frac", [0.01, 0.3, 0.5, 0.99, 1.0])
@pytest.mark.parametrize("length", [0, 1, 7, 4096])
def test_mangle_equals_reference(mode, frac, length):
    data = np.random.default_rng(length).bytes(length)
    faults.arm("volume.write.dat", mode, frac=frac)
    ref_faults.arm("volume.write.dat", mode, frac=frac)
    got = faults.point("volume.write.dat").mangle(data)
    want = ref_faults.point("volume.write.dat").mangle(data)
    assert got == want
    if mode == "torn":
        assert got == data[: int(length * (1 - frac))]
    elif length:
        assert sum(x != y for x, y in zip(got, data)) == 1


def test_rate_draws_equal_reference():
    """`rate` < 1 draws from `random`: the same seed fires the same calls."""
    for mod in (faults, ref_faults):
        mod.arm("master.lookup", "error", rate=0.3)
    runs = []
    for mod in (faults, ref_faults):
        random.seed(11)
        p = mod.point("master.lookup")
        runs.append([outcome(p.hit)[0] for _ in range(64)])
    assert runs[0] == runs[1] and "raised" in runs[0] and "ok" in runs[0]


SPECS = [
    "volume.read.dat=error:rate=0.5;master.assign=latency:ms=20",
    "volume.ec.parity.write=torn:frac=0.25,count=1;volume.write.dat=corrupt:key=h:1,after=2",
    "volume.heartbeat.send=partition; master.lookup=disk_full:count=3",
]
BAD_SPECS = ["volume.read.dat", "volume.read.dat=bogus", "nope.nope=error",
             "volume.read.dat=error:speed=2", "volume.read.dat=error:rate=0",
             "volume.read.dat=torn:frac=1.5", "volume.read.dat=error:after=-1"]


@pytest.mark.parametrize("text", SPECS)
def test_arm_from_spec_and_snapshot_equal_reference(text):
    assert faults.arm_from_spec(text) == ref_faults.arm_from_spec(text)
    assert faults.armed().keys() == ref_faults.armed().keys()
    mine = {p["point"]: p["armed"] for p in faults.snapshot()}
    theirs = {p["point"]: p["armed"] for p in ref_faults.snapshot()}
    assert {k: mine[k] for k in PORT_POINTS if k in mine} == \
        {k: theirs[k] for k in PORT_POINTS if k in mine}
    assert faults.disarm_all() == ref_faults.disarm_all() == len(faults.armed()) + \
        len(text.split(";"))


@pytest.mark.parametrize("text", BAD_SPECS)
def test_arm_from_spec_rejects_like_reference(text):
    with pytest.raises(ValueError):
        ref_faults.arm_from_spec(text)
    with pytest.raises(ValueError):
        faults.arm_from_spec(text)


# --- the seams ------------------------------------------------------------------------
def arm_both(point: str, mode: str, **kw) -> None:
    faults.arm(point, mode, **kw)
    ref_faults.arm(point, mode, **kw)


def test_corrupt_writes_found_by_both_scrubbers(pair):
    """`corrupt` on volume.write.dat flips one byte of 5 appends (after the
    third) in both packages; both scrubbers find the same 5 needles."""
    pair.add(1)
    rng = np.random.default_rng(5)
    arm_both("volume.write.dat", "corrupt", count=5, after=3, frac=0.6)
    blobs = {nid: rng.bytes(1500 if nid <= 20 else int(rng.integers(100, 9000)))
             for nid in range(1, 31)}
    for nid, data in blobs.items():
        pair.write(1, nid, data)
    a, b = pair.paths(1, ".dat")
    assert open(a, "rb").read() == open(b, "rb").read()
    sc, rsc = pair.scrubbers()
    got = assert_same_pass(sc, rsc)
    assert sorted(f.needle for f in got) == [4, 5, 6, 7, 8]
    assert {f.kind for f in got} == {"corrupt_needle"}
    assert sc.counters["bytes"]["batched"] > 0


def test_torn_and_failed_dat_writes_equal_reference(tmp_path, clock):
    """A torn append leaves the same short record in both .dat files and
    both reads fail alike; an `error` or `disk_full` write raises alike and
    leaves the files equal."""
    dirs = [str(tmp_path / d) for d in ("port", "ref")]
    for d in dirs:
        os.makedirs(d)
    v, rv = Volume(dirs[0], "", 3, device="cpu"), RefVolume(dirs[1], "", 3)
    rng = np.random.default_rng(8)
    for nid in range(1, 9):
        data = rng.bytes(int(rng.integers(50, 3000)))
        if nid == 4:
            arm_both("volume.write.dat", "torn", frac=0.5, count=1)
        if nid == 6:
            arm_both("volume.write.dat", "error", count=1)
        if nid == 7:
            arm_both("volume.write.dat", "disk_full", count=1)
        a = outcome(lambda: v.write_needle(Needle(cookie=9, id=nid, data=data)))
        b = outcome(lambda: rv.write_needle(RefNeedle(cookie=9, id=nid, data=data)))
        assert a == b, nid
    assert open(v.base_name + ".dat", "rb").read() == open(rv.base_name + ".dat", "rb").read()
    for nid in range(1, 9):
        assert outcome(lambda: v.read_needle(nid).data) == \
            outcome(lambda: rv.read_needle(nid).data), nid
    arm_both("volume.read.idx", "error", count=1)
    assert outcome(lambda: v.read_needle(1)) == outcome(lambda: rv.read_needle(1))
    v.close()
    rv.close()


def test_torn_parity_detected_and_rearmed_equal_reference(tmp_path, clock):
    """A torn parity write (volume.ec.parity.write, `torn`) shows in both
    writers' parity_health(); rearm() heals both to byte-equal parity, and
    a degraded read through it returns the written bytes."""
    dirs = [str(tmp_path / d) for d in ("port", "ref")]
    for d in dirs:
        os.makedirs(d)
    v, rv = Volume(dirs[0], "", 12, device="cpu"), RefVolume(dirs[1], "", 12)
    w = OnlineEcWriter(v, block_size=1024, device="cpu")
    rw = RefWriter(rv, block_size=1024)
    v.online_ec, rv.online_ec = w, rw
    rng = np.random.default_rng(12)
    blobs = {}
    for nid in range(1, 8):
        blobs[nid] = rng.bytes(2500 if nid < 6 else 4096)
        if nid == 6:
            for x in (w, rw):
                x.pump(force=True)
            assert w.parity_health() == rw.parity_health() == 0
            arm_both("volume.ec.parity.write", "torn", frac=1.0, count=1)
        v.write_needle(Needle(cookie=5, id=nid, data=blobs[nid]))
        rv.write_needle(RefNeedle(cookie=5, id=nid, data=blobs[nid]))
    for x in (w, rw):
        x.pump(force=True)
    assert w.parity_health() == rw.parity_health() >= 1
    assert w.rearm() == rw.rearm() > 0
    assert w.parity_health() == rw.parity_health() == 0
    for i in range(10, 14):
        ext = f".ec{i:02d}"
        assert open(v.base_name + ext, "rb").read() == open(rv.base_name + ext, "rb").read()
    off, _ = v.nm.get(4)
    for path in (v.base_name + ".dat", rv.base_name + ".dat"):
        with open(path, "r+b") as f:
            f.seek(off + 40)
            f.write(b"\xde\xad" * 16)
    assert v.read_needle(4).data == rv.read_needle(4).data == blobs[4]
    arm_both("volume.ec.parity.write", "error", count=1)
    for nid, x in ((20, v), (20, rv)):
        cls = Needle if x is v else RefNeedle
        x.write_needle(cls(cookie=5, id=nid, data=b"z" * 12000))
    for x in (w, rw):
        x.pump(force=True)
    assert (w.active, w.fallback_reason) == (rw.active, rw.fallback_reason) == \
        (False, "encoder_error")
    v.close()
    rv.close()


@pytest.mark.parametrize("mode,count", [("error", 1), ("error", 4), ("corrupt", 1)])
def test_shard_read_faults_equal_reference(tmp_path, clock, mode, count):
    """volume.ec.shard.read on a sealed volume: an injected error is a
    missing shard, rebuilt through the codec to the written bytes; a
    `corrupt` read fails the needle's CRC alike in both."""
    dirs = [str(tmp_path / d) for d in ("port", "ref")]
    for d in dirs:
        os.makedirs(d)
    v, rv = Volume(dirs[0], "", 9, device="cpu"), RefVolume(dirs[1], "", 9)
    rng = np.random.default_rng(9)
    blobs = {nid: rng.bytes(int(rng.integers(500, 5000))) for nid in range(1, 13)}
    for nid, data in blobs.items():
        v.write_needle(Needle(cookie=7, id=nid, data=data))
        rv.write_needle(RefNeedle(cookie=7, id=nid, data=data))
    v.close()
    rv.close()
    for base, enc, kw in ((v.base_name, encoder, {"codec": RSCodec(device="cpu")}),
                          (rv.base_name, ref_encoder, {})):
        enc.write_ec_files(base, **kw)
        enc.write_sorted_file_from_idx(base)
        enc.save_volume_info(base + ".vif", version=3)
    ev = EcVolume(dirs[0], "", 9, codec=RSCodec(device="cpu"))
    rev = RefEcVolume(dirs[1], "", 9)
    for nid, data in blobs.items():
        arm_both("volume.ec.shard.read", mode, count=count)
        a = outcome(lambda: ev.read_needle(nid, cookie=7).data)
        b = outcome(lambda: rev.read_needle(nid, cookie=7).data)
        assert a == b, nid
        if mode == "error":
            assert a == ("ok", data)
        else:
            assert a[0] == "raised"
        faults.disarm_all()
        ref_faults.disarm_all()
    ev.close()
    rev.close()


# --- /debug/faults and cluster.faults ---------------------------------------------------
def both_services():
    port = HTTPService(port=0)
    ref = ref_httpd.HTTPService(port=0)
    ref.serve_debug_routes()
    for s in (port, ref):
        s.start()
    return port, ref


def test_debug_faults_gate_equal_reference(monkeypatch):
    """POST /debug/faults answers 403 on both until the process opts in
    (enable() or SEAWEEDFS_TPU_FAULTS=1); then arm, disarm and disarm_all
    answer alike, and GET lists the armed spec alike."""
    monkeypatch.delenv("SEAWEEDFS_TPU_FAULTS", raising=False)
    monkeypatch.setattr(faults, "_enabled", False)
    monkeypatch.setattr(ref_faults, "_enabled", False)
    port, ref = both_services()
    try:
        body = {"action": "arm", "point": "master.lookup", "mode": "latency", "ms": 5}
        for s in (port, ref):
            status, _, out = http_request("POST", f"{s.url}/debug/faults",
                                          body=json.dumps(body).encode())
            assert status == 403 and b"disabled" in out
        assert faults.armed() == {} and ref_faults.armed() == {}
        monkeypatch.setenv("SEAWEEDFS_TPU_FAULTS", "1")
        answers = []
        for s in (port, ref):
            outs = [post_json(f"{s.url}/debug/faults", body)]
            state = get_json(f"{s.url}/debug/faults")
            outs.append({p["point"]: p["armed"] for p in state["points"]}["master.lookup"])
            outs.append(state["armed"])
            outs.append(post_json(f"{s.url}/debug/faults",
                                  {"action": "disarm", "point": "master.lookup"}))
            outs.append(post_json(f"{s.url}/debug/faults", {"action": "disarm_all"}))
            for bad in ({"action": "arm", "point": "nope.nope", "mode": "error"},
                        {"action": "arm", "point": "master.lookup", "mode": "bogus"},
                        {"action": "jump"}):
                status, _, out = http_request("POST", f"{s.url}/debug/faults",
                                              body=json.dumps(bad).encode())
                outs.append(status)
            answers.append(outs)
        assert answers[0] == answers[1]
        monkeypatch.delenv("SEAWEEDFS_TPU_FAULTS")
        faults.opt_in(None)
        assert not faults.runtime_arming_enabled()
        faults.opt_in("master.assign=error:count=1")
        assert faults.runtime_arming_enabled() and list(faults.armed()) == ["master.assign"]
    finally:
        for s in (port, ref):
            s.stop()


def test_server_constructors_opt_in(monkeypatch):
    """`faults_spec` is the -faults flag: "" opts the process in, a spec
    also arms it; the master's assign seam then answers 500 once."""
    monkeypatch.delenv("SEAWEEDFS_TPU_FAULTS", raising=False)
    monkeypatch.setattr(faults, "_enabled", False)
    m = MasterServer(port=0, faults_spec="master.assign=error:count=1")
    m.start()
    try:
        assert faults.runtime_arming_enabled()
        status, _, out = http_request("GET", f"{m.url}/dir/assign")
        assert status == 500 and b"injected fault at master.assign" in out
        state = get_json(f"{m.url}/debug/faults")
        assert {p["point"]: p["fired"] for p in state["points"]}["master.assign"] >= 1
    finally:
        m.stop()


def test_cluster_faults_verb_equal_reference(monkeypatch):
    """cluster.faults over a JAX and a port cluster: -arm, -list, the armed
    seams' effect (an injected /dir/assign failure, a volume's read error
    served degraded or failed alike), -disarm and -disarmAll, with equal
    output."""
    monkeypatch.setenv("SEAWEEDFS_TPU_FAULTS", "1")
    with twin(racks=("r1", "r2")) as (ref, port):
        sh = Shells(ref, port)
        for side in (ref, port):
            allocate(side, 5, [0])
        with pinned_clock():
            for side in (ref, port):
                write(side, 0, 5, 1, b"hello faults" * 50)
        out = sh.run("cluster.faults -arm master.assign -mode error -count 1")
        assert out == "armed master.assign (error) on 3/3 endpoint(s)"
        for side in (ref, port):
            assert http_request("GET", f"{side.master.url}/dir/assign")[0] == 500
            assert http_request("GET", f"{side.master.url}/dir/assign")[0] == 200
        sh.run("cluster.faults -arm volume.read.dat -mode corrupt -frac 0.9")
        # the listing: each registry's own firing history differs, the
        # armed point's state does not
        listed = []
        for env, runner in ((sh.envs[0], ref_run), (sh.envs[1], run_command)):
            out = runner(env, "cluster.faults -list")
            assert out.startswith("fault points across 3 endpoint(s):")
            (line,) = [ln for ln in out.splitlines() if "volume.read.dat" in ln]
            listed.append(re.sub(r"fired=\d+", "fired=n", line))
        assert listed[0] == listed[1] and "mode=corrupt" in listed[0], listed
        got = [http_request("GET", f"{side.url(0)}/{fid(5, 1)}")[0] for side in (ref, port)]
        assert got[0] == got[1]
        assert sh.run("cluster.faults -disarm volume.read.dat") == \
            "disarmed volume.read.dat on 3/3 endpoint(s)"
        sh.run("cluster.faults -arm volume.heartbeat.send -mode partition -key "
               + port.servers[0].node_id)
        assert sh.run("cluster.faults -disarmAll") == "disarmed all on 3/3 endpoint(s)"
        for side in (ref, port):
            status, _, body = http_request("GET", f"{side.url(0)}/{fid(5, 1)}")
            assert status == 200 and body == b"hello faults" * 50
