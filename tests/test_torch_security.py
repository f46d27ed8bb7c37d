"""The port's security layer held against the JAX package: JWT tokens,
the IP guard, security.toml, and JWT enforcement on a secured cluster.

Tokens: under one frozen clock (`time.time` pinned for both packages'
`jwt` modules) the port's tokens equal the JAX package's byte for byte,
and each package decodes and verifies the other's. `verify_file_jwt`,
`token_from_request` and the volume server's fid check decide the same
over seeded fids with `_N` and `.ext` suffixes, wildcard, expired,
wrong-key and tampered tokens; `Guard` the same over seeded IPs, CIDRs and
wildcards; `load_security_config` gives equal fields for one file.

Clusters: the same request script runs against a JAX master and volume
server (native front door off, `SEAWEEDFS_TPU_DISABLE_FASTLANE=1`, so its
Python handlers answer) and a port pair at `device="cpu"`, both secured by
the same `SecurityConfig`; the statuses must be equal. A replicated write
carries its token to the other holder, and a filer with both keys signs
its own chunk reads and deletes. A filer with a read key reads back the
chunks of a batched assign (`f_N`), whose read the JAX filer's token fails
(the defect shown beside it). Tolerance 0.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import pytest

from seaweedfs_tpu.security import Guard as RefGuard
from seaweedfs_tpu.security import SecurityConfig as RefSecurityConfig
from seaweedfs_tpu.security import jwt as ref_jwt
from seaweedfs_tpu.security import load_security_config as ref_load
from seaweedfs_tpu.server.httpd import get_json as ref_get_json
from seaweedfs_tpu.server.httpd import http_request as ref_http_request
from seaweedfs_tpu.server.master import MasterServer as RefMasterServer
from seaweedfs_tpu.server.volume import VolumeServer as RefVolumeServer
from seaweedfs_tpu_torch.security import Guard, SecurityConfig, load_security_config
from seaweedfs_tpu_torch.security.jwt import (
    JwtError,
    decode_jwt,
    encode_jwt,
    gen_read_jwt,
    gen_write_jwt,
    token_from_request,
    verify_file_jwt,
)
from seaweedfs_tpu_torch.server.httpd import get_json, http_request
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from tests._threads import stop_history_loops  # noqa: F401

FROZEN = 1_790_000_000


@pytest.fixture
def frozen_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: float(FROZEN))
    return FROZEN


def seeded_fids(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        vid = int(rng.integers(1, 1000))
        key = int(rng.integers(1, 1 << 40))
        cookie = int(rng.integers(0, 1 << 32))
        out.append(f"{vid},{key:x}{cookie:08x}")
    return out


# --- tokens -------------------------------------------------------------------
class TestJwt:
    def test_roundtrip(self):
        token = encode_jwt("secret", {"fid": "3,0101f0", "exp": int(time.time()) + 60})
        assert decode_jwt("secret", token)["fid"] == "3,0101f0"

    def test_bad_signature(self):
        token = encode_jwt("secret", {"fid": "x"})
        with pytest.raises(JwtError):
            decode_jwt("other", token)

    def test_tamper(self):
        token = encode_jwt("secret", {"fid": "x"})
        h, p, s = token.split(".")
        with pytest.raises(JwtError):
            decode_jwt("secret", f"{h}.{p}x.{s}")

    def test_expired(self):
        token = encode_jwt("secret", {"fid": "x", "exp": int(time.time()) - 1})
        with pytest.raises(JwtError):
            decode_jwt("secret", token)

    def test_verify_file_jwt_binding(self):
        token = gen_write_jwt("k", "3,ab01")
        assert verify_file_jwt("k", token, "3,ab01")
        assert not verify_file_jwt("k", token, "3,ab02")
        assert not verify_file_jwt("k", "garbage", "3,ab01")

    def test_wildcard_token(self):
        token = encode_jwt("k", {"fid": "", "exp": int(time.time()) + 10})
        assert verify_file_jwt("k", token, "anything,at_all")


@pytest.mark.parametrize("key", ["write-secret", b"\x00\xffbytes-key", "k"])
def test_tokens_byte_equal_reference(frozen_clock, key):
    fids = seeded_fids(1, 64) + [""]
    for f in fids:
        assert gen_write_jwt(key, f) == ref_jwt.gen_write_jwt(key, f)
        assert gen_write_jwt(key, f, 33) == ref_jwt.gen_write_jwt(key, f, 33)
        assert gen_read_jwt(key, f) == ref_jwt.gen_read_jwt(key, f)
        claims = {"fid": f, "exp": FROZEN + 7, "extra": [1, "a"]}
        assert encode_jwt(key, claims) == ref_jwt.encode_jwt(key, claims)
    assert gen_write_jwt("", "1,01") == ref_jwt.gen_write_jwt("", "1,01") == ""


def test_each_package_decodes_the_others_tokens(frozen_clock):
    for f in seeded_fids(2, 32):
        mine, theirs = gen_read_jwt("rk", f), ref_jwt.gen_read_jwt("rk", f)
        assert ref_jwt.decode_jwt("rk", mine) == decode_jwt("rk", theirs) == {
            "fid": f, "exp": FROZEN + 60}
        assert ref_jwt.verify_file_jwt("rk", mine, f) and verify_file_jwt("rk", theirs, f)


def _variants(f: str) -> list[str]:
    return [f, f + "_1", f + "_17", f + ".jpg", f + "_3.tar.gz", f[:-1] + "0"]


def test_verify_decisions_equal_reference(frozen_clock):
    """verify_file_jwt and the volume server's fid rule (`_N` and `.ext`
    stripped before the claim is compared) decide the same in both
    packages, across good, wildcard, wrong-key, expired and tampered
    tokens."""
    rng = np.random.default_rng(3)
    fids = seeded_fids(3, 24)
    decided = []
    for f in fids:
        other = fids[int(rng.integers(len(fids)))]
        good = gen_write_jwt("k", f)
        h, p, s = good.split(".")
        tokens = {
            "good": good, "other_fid": gen_write_jwt("k", other),
            "wildcard": encode_jwt("k", {"fid": "", "exp": FROZEN + 10}),
            "wrong_key": gen_write_jwt("not-k", f),
            "expired": encode_jwt("k", {"fid": f, "exp": FROZEN - 1}),
            "tampered": f"{h}.{p}x.{s}", "garbage": "a.b.c", "empty": "",
            "no_exp": encode_jwt("k", {"fid": f}),
        }
        for name, tok in tokens.items():
            for v in _variants(f):
                base = v.split("_")[0].split(".")[0]
                mine = verify_file_jwt("k", tok, base)
                assert mine == ref_jwt.verify_file_jwt("k", tok, base), (name, v)
                decided.append(mine)
    assert any(decided) and not all(decided)


@pytest.mark.parametrize("headers,query", [
    ({"Authorization": "BEARER abc.def.ghi"}, {}),
    ({"Authorization": "Bearer  abc.def "}, {"jwt": "q"}),
    ({"Authorization": "bearer x"}, {}),
    ({"Authorization": "Basic dXNlcg=="}, {"jwt": "from-query"}),
    ({}, {"jwt": "from-query"}),
    ({}, {}),
    (None, {"jwt": "only"}),
])
def test_token_from_request_equals_reference(headers, query):
    assert token_from_request(headers, query) == ref_jwt.token_from_request(headers, query)


# --- guard --------------------------------------------------------------------
class TestGuard:
    def test_empty_allows_all(self):
        assert Guard([]).is_allowed("1.2.3.4")

    def test_exact_ip(self):
        g = Guard(["127.0.0.1"])
        assert g.is_allowed("127.0.0.1")
        assert not g.is_allowed("10.0.0.1")

    def test_cidr(self):
        g = Guard(["10.0.0.0/8"])
        assert g.is_allowed("10.200.3.4")
        assert not g.is_allowed("192.168.0.1")

    def test_wildcard(self):
        assert Guard(["*"]).is_allowed("8.8.8.8")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_guard_decisions_equal_reference(seed):
    rng = np.random.default_rng(seed)

    def ip() -> str:
        return ".".join(str(int(x)) for x in rng.integers(0, 256, 4))

    lists = [[], ["*"], [ip() for _ in range(3)],
             [f"{ip()}/{int(rng.integers(8, 30))}" for _ in range(3)],
             [ip(), "10.0.0.0/8", "::1", "fd00::/8"]]
    probes = [ip() for _ in range(200)] + [
        "127.0.0.1", "10.1.2.3", "::1", "fd00::5", "not-an-ip", "unix", ""]
    for wl in lists:
        mine, ref = Guard(wl), RefGuard(wl)
        probes_here = probes + [x.split("/")[0] for x in wl]
        assert [mine.is_allowed(p) for p in probes_here] == \
            [ref.is_allowed(p) for p in probes_here], wl


# --- security.toml -------------------------------------------------------------
TOML = """
[jwt.signing]
key = "write-secret"
expires_after_seconds = 33

[jwt.signing.read]
key = "read-secret"

[guard]
white_list = ["127.0.0.1", "10.0.0.0/8"]

[tls]
ca = "/etc/seaweedfs/ca.pem"
cert = "/etc/seaweedfs/node.pem"
key = "/etc/seaweedfs/node.key"
allowed_commonNames = "master*,volume1"
"""


class TestSecurityToml:
    def test_load(self, tmp_path):
        p = tmp_path / "security.toml"
        p.write_text(TOML)
        cfg = load_security_config(str(p))
        assert cfg.write_key == "write-secret"
        assert cfg.write_expires_sec == 33
        assert cfg.read_key == "read-secret"
        assert cfg.white_list == ["127.0.0.1", "10.0.0.0/8"]
        assert cfg.enabled

    def test_default_empty(self):
        assert not load_security_config("/nonexistent/security.toml").enabled


@pytest.mark.parametrize("text", [TOML, "", "[jwt.signing]\nkey = \"k\"\n",
                                  "[guard]\nwhite_list = [\"*\"]\n[tls]\nca = \"a\"\n"])
def test_config_fields_equal_reference(tmp_path, text, monkeypatch):
    p = tmp_path / "security.toml"
    p.write_text(text)
    assert dataclasses.asdict(load_security_config(str(p))) == \
        dataclasses.asdict(ref_load(str(p)))
    # the discovery order: ./security.toml first
    monkeypatch.chdir(tmp_path)
    assert dataclasses.asdict(load_security_config()) == dataclasses.asdict(ref_load())


# --- secured clusters ------------------------------------------------------------
def _port_pair(tmp: str, master_sec, volume_sec):
    m = MasterServer(port=0, pulse_seconds=1, volume_size_limit_mb=64, security=master_sec)
    m.start()
    vs = VolumeServer([tmp], m.url, port=0, pulse_seconds=1, max_volume_count=10,
                      security=volume_sec, device="cpu")
    vs.start()
    return m, vs


def _ref_pair(tmp: str, master_sec, volume_sec):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAWEEDFS_TPU_DISABLE_FASTLANE", "1")
        m = RefMasterServer(port=0, pulse_seconds=1, volume_size_limit_mb=64,
                            security=master_sec)
        m.start()
        vs = RefVolumeServer([tmp], m.url, port=0, pulse_seconds=1, max_volume_count=10,
                             security=volume_sec)
        vs.start()
    return m, vs


def jwt_script(tmp, pair, sec_cls, request, get, read_jwt) -> list:
    """TestClusterJwtEnforcement's steps as a list of (step, status, body)."""
    out = []
    wsec = sec_cls(write_key="cluster-secret")
    m, vs = pair(str(tmp / "write"), wsec, wsec)
    try:
        a = get(f"{m.url}/dir/assign")
        out.append(("auth handed out", bool(a.get("auth"))))
        url = f"http://{a['publicUrl']}/{a['fid']}"
        st, _, _ = request("POST", url, b"data")
        out.append(("unsigned write", st))
        st, _, _ = request("POST", url, b"data", {"Authorization": f"BEARER {a['auth']}"})
        out.append(("signed write", st))
        st, _, body = request("GET", url)
        out.append(("open read", st, body))
        st, _, _ = request("DELETE", url)
        out.append(("unsigned delete", st))
        st, _, _ = request("DELETE", url + "?jwt=" + a["auth"] + "x")
        out.append(("tampered delete", st))
        st, _, _ = request("DELETE", f"{url}?jwt={a['auth']}")
        out.append(("signed delete by query", st))
    finally:
        vs.stop()
        m.stop()
    rsec = sec_cls(read_key="read-secret")
    m, vs = pair(str(tmp / "read"), None, rsec)
    try:
        a = get(f"{m.url}/dir/assign")
        url = f"http://{a['publicUrl']}/{a['fid']}"
        st, _, _ = request("POST", url, b"readable")
        out.append(("write, no write key", st))
        st, _, _ = request("GET", url)
        out.append(("read without token", st))
        st, _, _ = request("HEAD", url)
        out.append(("head without token", st))
        bad = read_jwt("not-the-key", a["fid"])
        st, _, _ = request("GET", url, headers={"Authorization": f"BEARER {bad}"})
        out.append(("read wrong key", st))
        tok = read_jwt("read-secret", a["fid"])
        st, _, body = request("GET", url, headers={"Authorization": f"BEARER {tok}"})
        out.append(("read with token", st, body))
        st, _, body = request("GET", url + ".txt", headers={"Authorization": f"BEARER {tok}"})
        out.append(("read .ext with token", st, body))
        wild = read_jwt("read-secret", "")
        st, _, body = request("GET", url, headers={"Authorization": f"BEARER {wild}"})
        out.append(("read wildcard", st, body))
        # another fid: the last hex digit changed (each side draws its own cookie)
        other = read_jwt("read-secret", a["fid"][:-1] + ("1" if a["fid"][-1] == "0" else "0"))
        st, _, _ = request("GET", url, headers={"Authorization": f"BEARER {other}"})
        out.append(("read other fid's token", st))
        qbody = json.dumps({"fid": a["fid"], "type": "csv"}).encode()
        st, _, _ = request("POST", f"http://{a['publicUrl']}/query", qbody)
        out.append(("query without token", st))
        st, _, _ = request("POST", f"http://{a['publicUrl']}/query", qbody,
                           {"Authorization": f"BEARER {tok}"})
        out.append(("query with token", st))
    finally:
        vs.stop()
        m.stop()
    return out


def test_cluster_jwt_enforcement_equals_reference(tmp_path):
    """TestClusterJwtEnforcement's write-token and read-token steps: the
    port answers every step as the JAX servers do."""
    mine = jwt_script(tmp_path / "port", _port_pair, SecurityConfig, http_request, get_json,
                      gen_read_jwt)
    ref = jwt_script(tmp_path / "jax", _ref_pair, RefSecurityConfig, ref_http_request,
                     ref_get_json, ref_jwt.gen_read_jwt)
    assert mine == ref
    assert dict((s[0], s[1]) for s in mine) == {
        "auth handed out": True, "unsigned write": 401, "signed write": 201,
        "open read": 200, "unsigned delete": 401, "tampered delete": 401,
        "signed delete by query": 202, "write, no write key": 201,
        "read without token": 401, "head without token": 401, "read wrong key": 401,
        "read with token": 200, "read .ext with token": 200, "read wildcard": 200,
        "read other fid's token": 401, "query without token": 401,
        "query with token": 200}


def test_replicated_write_carries_token(tmp_path):
    """A write to a volume at replication 001 reaches the other holder with
    the client's token; a replica push without one is refused there."""
    sec = SecurityConfig(write_key="cluster-secret")
    m = MasterServer(port=0, pulse_seconds=1, volume_size_limit_mb=64, security=sec,
                     garbage_threshold=0.99)
    m.start()
    servers = []
    try:
        for i in range(2):
            vs = VolumeServer([str(tmp_path / f"v{i}")], m.url, port=0, rack="r1",
                              pulse_seconds=1, max_volume_count=10, security=sec,
                              device="cpu")
            vs.start()
            servers.append(vs)
        for vs in servers:
            vs.heartbeat_once()
        a = get_json(f"{m.url}/dir/assign?replication=001")
        vid = int(a["fid"].split(",")[0])
        holders = [vs for vs in servers if vs.store.get_volume(vid) is not None]
        assert len(holders) == 2
        auth = {"Authorization": f"BEARER {a['auth']}"}
        st, _, out = http_request("POST", f"http://{a['url']}/{a['fid']}", b"both", auth)
        assert st == 201, out
        for vs in holders:
            st, _, body = http_request("GET", f"{vs.service.url}/{a['fid']}")
            assert (st, body) == (200, b"both")
        other = next(vs for vs in holders if vs.node_id != a["url"])
        st, _, _ = http_request("POST", f"{other.service.url}/{a['fid']}?type=replicate",
                                b"forged")
        assert st == 401
        st, _, _ = http_request("DELETE", f"http://{a['url']}/{a['fid']}", headers=auth)
        assert st == 202
        for vs in holders:
            assert http_request("GET", f"{vs.service.url}/{a['fid']}")[0] == 404
    finally:
        for vs in servers:
            vs.stop()
        m.stop()


def test_filer_signs_its_own_reads_and_deletes(tmp_path):
    """A filer given both keys writes with the assign's token, reads its
    chunks with read tokens it signs and deletes with a wildcard token,
    against volume servers that demand all three; the guard admits
    127.0.0.1 and refuses a list without it."""
    from seaweedfs_tpu_torch.filer.filer_client import FilerClient
    from seaweedfs_tpu_torch.server.filer import FilerServer

    sec = SecurityConfig(write_key="w", read_key="r", white_list=["127.0.0.1"])
    m, vs = _port_pair(str(tmp_path / "v"), sec, sec)
    f = FilerServer(m.url, port=0, device="cpu", security=sec)
    f.start()
    fc = FilerClient(f.url)
    try:
        payload = np.random.default_rng(5).bytes(3000)  # past the 2 KiB inline limit
        fc.put("/sec/a.bin", payload)
        assert fc.read("/sec/a.bin") == payload
        entry = f.filer.find_entry("/sec/a.bin")
        fid = entry.chunks[0].file_id
        url = f"{vs.service.url}/{fid}"
        assert http_request("GET", url)[0] == 401
        fc.delete("/sec/a.bin")
        deadline = time.time() + 10
        tok = gen_read_jwt("r", fid)
        while http_request("GET", url, headers={"Authorization": f"BEARER {tok}"})[0] != 404:
            assert time.time() < deadline, "the filer's chunk delete never landed"
            time.sleep(0.05)
    finally:
        fc.close()
        f.stop()
        vs.stop()
        m.stop()
    locked = MasterServer(port=0, security=SecurityConfig(white_list=["10.9.9.9"]))
    locked.start()
    try:
        assert http_request("GET", f"{locked.url}/dir/status")[0] == 403
    finally:
        locked.stop()


def _multi_chunk_read(pkg: str, tmp: str) -> tuple:
    """A file of three chunks (one batched assign: fids `f`, `f_1`, `f_2`)
    PUT through a filer with a read key and read back."""
    if pkg == "port":
        from seaweedfs_tpu_torch.server.filer import FilerServer as Filer
        m, vs = _port_pair(tmp, None, SecurityConfig(read_key="r"))
        f = Filer(m.url, port=0, device="cpu", security=SecurityConfig(read_key="r"))
        request = http_request
    else:
        from seaweedfs_tpu.server.filer import FilerServer as Filer
        m, vs = _ref_pair(tmp, None, RefSecurityConfig(read_key="r"))
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("SEAWEEDFS_TPU_DISABLE_FASTLANE", "1")
            f = Filer(m.url, port=0, security=RefSecurityConfig(read_key="r"))
        request = ref_http_request
    f.chunk_size = 4096
    f.start()
    try:
        data = np.random.default_rng(9).bytes(10_000)
        put = request("PUT", f.url + "/multi.bin", data, {"Content-Type": "application/octet-stream"})
        st, _, body = request("GET", f.url + "/multi.bin")
        return put[0], st, body == data, body if st != 200 else b""
    finally:
        f.stop()
        vs.stop()
        m.stop()


def test_filer_reads_batched_chunks_under_a_read_key(tmp_path):
    """A chunk of a batched assign has the fid `f_N`; the volume server
    checks a read token against the base fid `f`. The port's filer signs
    the base and reads its file back; the JAX filer signs `f_N`, and its
    read of the same file fails with the volume server's 401."""
    assert _multi_chunk_read("port", str(tmp_path / "port"))[:3] == (201, 200, True)
    put, st, _, body = _multi_chunk_read("jax", str(tmp_path / "jax"))
    assert (put, st) == (201, 500) and b"_1 -> 401" in body
