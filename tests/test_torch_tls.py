"""mTLS across the port's stack held against the JAX package (reference
`weed/security/tls.go`): every listener requires a CA-signed client
certificate, allowed-commonNames gates which certificates may talk, and a
master, a volume server and a filer of the port work together over TLS
end to end, raft included.

The PKI is made per test by the JAX test module's helpers (a CA, an allowed
`node1` and an `intruder`). TLS state is process-wide in each package: the
`pki` fixture resets both in its teardown, and `test_tls_is_off_after_the_fixture`
checks that nothing leaked, since a leaked state would turn every later
port server in the worker to https. The CN gate's decisions and patterns
are compared with the JAX module's over seeded names. Tolerance 0.
"""

from __future__ import annotations

import contextlib
import json
import os
import ssl
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("cryptography")

from seaweedfs_tpu.security import tls as ref_tls
from seaweedfs_tpu.security.tls import TLSConfig as RefTLSConfig
from seaweedfs_tpu_torch.security import SecurityConfig
from seaweedfs_tpu_torch.security import tls as tls_mod
from seaweedfs_tpu_torch.security.tls import TLSConfig
from seaweedfs_tpu_torch.server.httpd import (
    HTTPService,
    PooledHTTP,
    Response,
    get_json,
    http_request,
    peer_url,
)
from tests.test_tls import _issue, _make_ca
from tests._threads import stop_history_loops  # noqa: F401


@contextlib.contextmanager
def made_pki(tmp: str):
    ca_key, ca_cert, ca_pem = _make_ca(tmp)
    try:
        yield {
            "ca": ca_pem,
            "node": _issue(tmp, ca_key, ca_cert, "node1"),
            "evil": _issue(tmp, ca_key, ca_cert, "intruder"),
        }
    finally:
        tls_mod.reset()
        ref_tls.reset()


@pytest.fixture()
def pki(tmp_path):
    with made_pki(str(tmp_path)) as p:
        yield p


def node_tls(pki, allowed="node1") -> TLSConfig:
    return TLSConfig(ca=pki["ca"], cert=pki["node"][0], key=pki["node"][1],
                     allowed_common_names=allowed)


def _client_ctx(ca, cert, key):
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_cert_chain(cert, key)
    ctx.load_verify_locations(ca)
    ctx.check_hostname = False
    return ctx


def _status(url: str, ctx) -> int:
    try:
        return urllib.request.urlopen(url, context=ctx, timeout=5).status
    except urllib.error.HTTPError as e:
        return e.code


def test_mtls_cluster_end_to_end(pki, tmp_path):
    tls_mod.configure(node_tls(pki))
    from seaweedfs_tpu_torch.filer.filer_client import FilerClient
    from seaweedfs_tpu_torch.server.filer import FilerServer
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume import VolumeServer

    master = MasterServer(port=0, pulse_seconds=1)
    master.start()
    assert master.url.startswith("https://")
    vol = VolumeServer([str(tmp_path / "v")], master.url, port=0, pulse_seconds=1,
                       device="cpu")
    vol.start()
    filer = FilerServer(master.url, port=0, device="cpu")
    filer.start()
    fc = FilerClient(filer.url)
    try:
        assert vol.service.url.startswith("https://") and filer.url.startswith("https://")
        # the whole write/read path over mTLS (filer -> master assign -> volume)
        payload = os.urandom(3000)  # past the inline limit: a volume hop
        fc.put("/tls/a.bin", payload)
        assert fc.read("/tls/a.bin") == payload
        # no client certificate: the handshake is refused
        bare = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        bare.load_verify_locations(pki["ca"])
        bare.check_hostname = False
        with pytest.raises(Exception):
            urllib.request.urlopen(f"{master.url}/dir/assign", context=bare, timeout=5)
        # a plain-http client gets no answer
        with pytest.raises(Exception):
            urllib.request.urlopen(master.url.replace("https", "http") + "/dir/assign",
                                   timeout=5)
        # a CA-valid certificate with a CommonName not allowed: 403
        evil = _client_ctx(pki["ca"], *pki["evil"])
        assert _status(f"{master.url}/dir/assign", evil) == 403
        # the allowed CN works directly too
        good = _client_ctx(pki["ca"], *pki["node"])
        out = json.loads(urllib.request.urlopen(
            f"{master.url}/dir/assign", context=good, timeout=5).read())
        assert out["fid"]
        url = f"https://{out['publicUrl']}/{out['fid']}"
        req = urllib.request.Request(url, data=b"tls-direct", method="POST")
        assert urllib.request.urlopen(req, context=good, timeout=5).status == 201
        assert urllib.request.urlopen(url, context=good, timeout=5).read() == b"tls-direct"
        # the port's own clients: urllib and the keep-alive pool
        assert peer_url(out["publicUrl"]) == f"https://{out['publicUrl']}"
        pool = PooledHTTP()
        try:
            assert pool.request("GET", url)[2] == b"tls-direct"
            assert pool.request("GET", url)[2] == b"tls-direct"  # reused
        finally:
            pool.close()
        assert http_request("GET", url)[2] == b"tls-direct"
    finally:
        fc.close()
        filer.stop()
        vol.stop()
        master.stop()


def test_raft_masters_over_mtls(pki, tmp_path):
    """Three port masters elect a leader with their raft RPCs over mTLS,
    and a volume server's heartbeat finds it through a follower's hint."""
    tls_mod.configure(node_tls(pki))
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume import VolumeServer

    masters = [MasterServer(port=0, pulse_seconds=1) for _ in range(3)]
    for m in masters:
        m.service.start()
    urls = [m.url for m in masters]
    vol = None
    try:
        for m in masters:
            m.enable_raft([u for u in urls if u != m.url])
        deadline = time.time() + 10
        while sum(m.raft.is_leader() for m in masters) != 1:
            assert time.time() < deadline, "no leader over mTLS"
            time.sleep(0.05)
        leader = next(m for m in masters if m.raft.is_leader())
        follower_first = [u for u in urls if u != leader.url] + [leader.url]
        vol = VolumeServer([str(tmp_path / "v")], ",".join(follower_first), port=0,
                           device="cpu")
        vol.start()
        vol.heartbeat_once()
        assert vol.master_url == leader.url
        assert get_json(f"{leader.url}/dir/assign")["fid"]
    finally:
        if vol is not None:
            vol.stop()
        for m in masters:
            m.stop()


def test_guard_and_cn_gate_spare_the_unix_socket(pki, tmp_path):
    """The guard answers 403 to an IP off its list and the CN gate to a
    disallowed certificate; the unix socket is same-host-trusted: neither
    applies there."""
    from seaweedfs_tpu_torch.security import Guard

    tls_mod.configure(node_tls(pki))
    svc = HTTPService(port=0)

    @svc.route("GET", r"/ping")
    def ping(req):
        return Response({"pong": True})

    svc.guard = Guard(["10.9.9.9"])
    svc.start()
    sock = str(tmp_path / "s.sock")
    svc.enable_unix_socket(sock)
    try:
        assert http_request("GET", svc.url + "/ping")[0] == 403
        st, _, body = http_request("GET", svc.unix_url + "/ping")
        assert st == 200 and json.loads(body) == {"pong": True}
        svc.guard = Guard(["127.0.0.0/8"])
        assert http_request("GET", svc.url + "/ping")[0] == 200
        assert _status(svc.url + "/ping", _client_ctx(pki["ca"], *pki["evil"])) == 403
    finally:
        svc.stop()


def test_unix_socket_exempt_from_mtls_gate(pki, tmp_path):
    """With process mTLS on and the filer's TCP listener serving TLS, the
    unix socket still serves, and stop() stops advertising it."""
    from seaweedfs_tpu_torch.server.filer import FilerServer
    from seaweedfs_tpu_torch.server.master import MasterServer

    tls_mod.configure(TLSConfig(ca=pki["ca"], cert=pki["node"][0], key=pki["node"][1]))
    sock = str(tmp_path / "f.sock")
    master = MasterServer(port=0)
    master.start()
    filer = FilerServer(master_url=master.url, port=0, local_socket=sock, device="cpu")
    filer.start()
    try:
        assert filer.url.startswith("https://")
        st, _, _ = http_request("POST", filer.service.unix_url + "/t.txt", b"x")
        assert st == 201, "unix peer must bypass the CN gate"
    finally:
        filer.stop()
        master.stop()
    assert filer.service.unix_url is None


def test_plain_backend_stays_plain(pki):
    tls_mod.configure(node_tls(pki))
    svc = HTTPService(port=0)
    svc.plain_backend = True
    svc.start()
    try:
        assert svc.url.startswith("http://")
        assert http_request("GET", svc.url + "/debug/faults")[0] == 200
    finally:
        svc.stop()


def test_partial_tls_section_fails_closed(pki):
    for mod, cfg in ((tls_mod, TLSConfig), (ref_tls, RefTLSConfig)):
        with pytest.raises(ValueError):
            mod.configure(cfg(ca=pki["ca"]))
        with pytest.raises(ValueError):
            mod.configure(cfg(allowed_common_names="node1"))
        mod.configure(cfg())  # nothing set: TLS off
        assert mod.server_context() is None and mod.current_config() is None


def test_apply_tls_installs_and_resets(pki):
    sec = SecurityConfig(tls_ca=pki["ca"], tls_cert=pki["node"][0],
                         tls_key=pki["node"][1], tls_allowed_common_names="node*, x")
    sec.apply_tls()
    assert tls_mod.server_context() is not None and tls_mod.client_context() is not None
    assert tls_mod.current_config().cert == pki["node"][0]
    assert [p.pattern for p in tls_mod.allowed_cn_patterns()] == ["node.*", "x"]
    SecurityConfig().apply_tls()
    assert tls_mod.server_context() is None and tls_mod.allowed_cn_patterns() == []


def test_cn_wildcards():
    allowed = [tls_mod.compile_cn_pattern(p)
               for p in ("volume*", "master1", "*.trusted.example")]
    mk = lambda cn: {"subject": ((("commonName", cn),),)}  # noqa: E731
    assert tls_mod.peer_allowed(mk("volume7"), allowed)
    assert tls_mod.peer_allowed(mk("master1"), allowed)
    assert tls_mod.peer_allowed(mk("a.trusted.example"), allowed)
    assert not tls_mod.peer_allowed(mk("master2"), allowed)
    assert not tls_mod.peer_allowed(None, allowed)
    assert tls_mod.peer_allowed(None, [])  # no allow-list: the CA decides


@pytest.mark.parametrize("seed", [0, 1])
def test_cn_gate_equals_reference(seed):
    rng = np.random.default_rng(seed)
    alphabet = list("abcmv1.*-")

    def word(lo=1, hi=9) -> str:
        return "".join(rng.choice(alphabet, int(rng.integers(lo, hi))))

    patterns = ["volume*", "master1", "*.trusted.example", "*", "a.b", "x*y*z"] + \
        [word() for _ in range(20)]
    for p in patterns:
        assert tls_mod.compile_cn_pattern(p).pattern == ref_tls.compile_cn_pattern(p).pattern
    names = [word(0, 12).replace("*", "") for _ in range(300)] + [
        "volume7", "master1", "a.trusted.example", "", "master2"]
    for k in range(8):
        chosen = [patterns[int(i)] for i in rng.choice(len(patterns), k, replace=False)]
        mine = [tls_mod.compile_cn_pattern(p) for p in chosen]
        ref = [ref_tls.compile_cn_pattern(p) for p in chosen]
        for cn in names:
            cert = {"subject": ((("countryName", "XX"),), (("commonName", cn),))}
            assert tls_mod.peer_allowed(cert, mine) == ref_tls.peer_allowed(cert, ref), \
                (chosen, cn)
        assert tls_mod.peer_allowed(None, mine) == ref_tls.peer_allowed(None, ref)


def test_tls_is_off_after_the_fixture(tmp_path):
    """A test that configures TLS through the fixture's context leaves the
    port's process-wide state off, so later servers in the worker are
    plain http."""
    with made_pki(tempfile.mkdtemp(dir=tmp_path)) as p:
        tls_mod.configure(node_tls(p))
        ref_tls.configure(RefTLSConfig(ca=p["ca"], cert=p["node"][0], key=p["node"][1]))
        assert tls_mod.client_context() is not None
    for mod in (tls_mod, ref_tls):
        assert mod.current_config() is None
        assert mod.server_context() is None and mod.client_context() is None
        assert mod.allowed_cn_patterns() == []
    svc = HTTPService(port=0)
    svc.start()
    try:
        assert svc.url.startswith("http://") and peer_url("h:1") == "http://h:1"
    finally:
        svc.stop()
