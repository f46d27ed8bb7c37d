"""The port's FTP gateway held against the JAX package's, case for case with
the FTP part of `tests/test_ftp_ui.py` (login, PWD/MKD/CWD, STOR, RETR,
SIZE, LIST, NLST, DELE, fixed credentials), plus a whole control session's
replies, the refusal of logins with no credentials set, and seeded
transfers whose stored entries are compared.

`ftp_pair` starts one `FtpServer` of each package over the filers of
`tests/test_torch_filer_meta.py::twin` (a JAX cluster and a port cluster on
`device="cpu"`, both filers at 4 KiB chunks). Every step runs on both
sides, one at a time, through stdlib `ftplib` or a raw control socket,
and each reply line is held equal. A PASV reply's port, LIST's time
column and the addresses and fids in an error line (`Norm`) are the only
fields replaced. Stored entries are held equal through `Norm`. Tolerance:
byte equality after that normalization.

Left out of the mirror: `TestStatusUI` and the metrics push loop of
`tests/test_ftp_ui.py`, which test the master's and volume server's HTML
pages and telemetry (ROADMAP 10d-4), not the FTP gateway.
"""

from __future__ import annotations

import ftplib
import io
import re
import socket

import numpy as np
import pytest

from seaweedfs_tpu.ftpd import FtpServer as RefFtpServer
from seaweedfs_tpu_torch.ftpd import FtpServer

from .test_torch_filer_meta import CHUNK, Norm, twin
from .test_torch_s3 import entries
from ._threads import stop_history_loops  # noqa: F401

PASV = re.compile(r"\(127,0,0,1,\d+,\d+\)")
LIST_TIME = re.compile(r"(weed weed +\d+) \w{3} \d{2} \d{2}:\d{2} ")


class FtpPair:
    def __init__(self, sides, servers) -> None:
        self.sides = sides
        self.servers = servers
        self.norms = [Norm(s) for s in sides]

    def line(self, i: int, text: str) -> str:
        text = LIST_TIME.sub(r"\1 TIME ", PASV.sub("(PASV)", text))
        return self.norms[i].text(text)

    def each(self, fn):
        """fn(i, server) on both sides; the normalized results held equal."""
        got = []
        for i, srv in enumerate(self.servers):
            got.append(norm_deep(lambda t, i=i: self.line(i, t), fn(i, srv)))
        assert got[1] == got[0]
        return got[1]

    def store(self, root: str) -> list:
        trees = [n(entries(s, root)) for n, s in zip(self.norms, self.sides)]
        assert trees[1] == trees[0] and trees[1], root
        return trees[1]


def norm_deep(fn, obj):
    if isinstance(obj, str):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        return [norm_deep(fn, v) for v in obj]
    return obj


def client(srv, user="anonymous", password="x") -> ftplib.FTP:
    c = ftplib.FTP()
    c.connect("127.0.0.1", srv.port, timeout=10)
    c.login(user, password)
    return c


def attempt(fn, *args):
    """A call's reply, or the error line it raised."""
    try:
        return fn(*args)
    except ftplib.Error as e:
        return f"error: {e}"


@pytest.fixture(scope="module")
def ftp_pair(tmp_path_factory):
    with twin(str(tmp_path_factory.mktemp("ftp"))) as sides:
        servers = [RefFtpServer(sides[0].filer.url, port=0, anonymous=True),
                   FtpServer(sides[1].filer.url, port=0, anonymous=True)]
        for s in servers:
            s.start()
        try:
            yield FtpPair(sides, servers)
        finally:
            for s in servers:
                s.stop()


def test_login_pwd_mkd_cwd(ftp_pair):
    def run(i, srv):
        c = client(srv)
        out = [c.pwd(), c.mkd("/ftpdir"), c.cwd("/ftpdir"), c.pwd(), c.cwd(".."), c.pwd(),
               attempt(c.cwd, "/no/such"), c.quit()]
        return out

    out = ftp_pair.each(run)
    assert out[0] == "/" and out[3] == "/ftpdir" and out[5] == "/"
    assert out[6].startswith("error: 550")


def test_stor_retr_list_dele(ftp_pair):
    payload = b"ftp transfer payload " * 100

    def run(i, srv):
        c = client(srv)
        c.mkd("/xfer")
        c.cwd("/xfer")
        out = [c.storbinary("STOR data.bin", io.BytesIO(payload)), c.size("data.bin")]
        buf = io.BytesIO()
        out.append(c.retrbinary("RETR data.bin", buf.write))
        out.append(buf.getvalue())
        out.append(c.nlst())
        lines = []
        out.append(c.retrlines("LIST", lines.append))
        out.append(lines)
        out.append(c.delete("data.bin"))
        out.append(c.nlst())
        out.append(attempt(c.size, "data.bin"))
        out.append(c.quit())
        return out

    out = ftp_pair.each(run)
    assert out[1] == len(payload) and out[3] == payload
    assert out[4] == ["data.bin"] and any("data.bin" in ln for ln in out[6])
    assert "data.bin" not in out[8] and out[9].startswith("error: 550")


def test_fixed_credentials(ftp_pair):
    servers = [RefFtpServer(ftp_pair.sides[0].filer.url, port=0, user="admin", password="secret"),
               FtpServer(ftp_pair.sides[1].filer.url, port=0, user="admin", password="secret")]
    for s in servers:
        s.start()
    try:
        def run(i, srv):
            out = [attempt(client, servers[i], "admin", "wrong")]
            c = client(servers[i], "admin", "secret")
            out += [c.pwd(), c.quit()]
            return out

        out = ftp_pair.each(run)
        assert out[0].startswith("error: 530") and out[1] == "/"
    finally:
        for s in servers:
            s.stop()


def test_unconfigured_server_refuses_logins(ftp_pair):
    """No credentials and no `anonymous=True`: every login is refused, and
    a filesystem verb before a login answers 530."""
    servers = [RefFtpServer(ftp_pair.sides[0].filer.url, port=0),
               FtpServer(ftp_pair.sides[1].filer.url, port=0)]
    for s in servers:
        s.start()
    try:
        def run(i, srv):
            return session(servers[i], ["USER anyone", "PASS any", "PWD", "LIST", "QUIT"])

        out = ftp_pair.each(run)
        assert out[2] == "530 login incorrect"
        assert out[3] == out[4] == "530 please login with USER and PASS"
    finally:
        for s in servers:
            s.stop()


def session(srv, commands: list[str]) -> list[str]:
    """Raw control-session replies: the greeting, then every reply line."""
    with socket.create_connection(("127.0.0.1", srv.port), timeout=10) as sock:
        f = sock.makefile("rb")
        out = [f.readline().decode().rstrip("\r\n")]
        for cmd in commands:
            sock.sendall(cmd.encode() + b"\r\n")
            while True:
                line = f.readline().decode().rstrip("\r\n")
                out.append(line)
                if re.match(r"^\d{3} ", line) or not line:
                    break
        return out


def test_control_session_transcript(ftp_pair):
    """Every reply of one session of verbs, errors included."""
    commands = ["SYST", "NOOP", "USER anonymous", "PASS x", "FEAT", "TYPE I", "PWD",
                "MKD /sess", "MKD /sess/a/../b", "CWD /sess/b", "PWD", "CDUP", "PWD",
                "CWD ./b/./", "PWD", "SIZE nothing.bin", "RETR nothing.bin", "LIST",
                "STOR x.bin", "DELE /sess/none", "RMD /sess/b", "CWD /sess/b", "SITE CHMOD",
                "PASV", "QUIT"]
    out = ftp_pair.each(lambda i, srv: session(srv, commands))
    assert out[0] == "220 seaweedfs-tpu FTP ready"
    assert "425 use PASV first" in out and "502 SITE not implemented" in out
    assert out[-1] == "221 bye"


@pytest.mark.parametrize("seed", range(2))
def test_seeded_transfers_equal_reference(ftp_pair, seed):
    """Seeded files (1 B to 5 chunks) stored from one session and read back
    from another: replies, bodies, SIZE and LIST equal, and the stored
    entries equal."""
    rng = np.random.default_rng([seed, 61])
    sizes = [1, CHUNK - 1, CHUNK, CHUNK + 1] + [int(rng.integers(1, 5 * CHUNK)) for _ in range(4)]
    bodies = [rng.bytes(n) for n in sizes]
    root = f"/seeded{seed}"

    def run(i, srv):
        c = client(srv)
        out = [c.mkd(root)]
        for k, body in enumerate(bodies):
            out.append(c.storbinary(f"STOR {root}/f{k}.bin", io.BytesIO(body)))
        c.quit()
        c = client(srv)
        c.cwd(root)
        for k in range(len(bodies)):
            buf = io.BytesIO()
            out += [c.size(f"f{k}.bin"), c.retrbinary(f"RETR f{k}.bin", buf.write),
                    buf.getvalue()]
        lines = []
        c.retrlines("LIST", lines.append)
        out += [lines, c.rmd(root), c.nlst("/"), c.quit()]
        return out

    out = ftp_pair.each(run)
    for k, body in enumerate(bodies):
        size, reply, got = out[1 + len(bodies) + 3 * k: 1 + len(bodies) + 3 * k + 3]
        assert size == len(body) and reply == "226 transfer complete" and got == body
    assert root.lstrip("/") not in out[-2]


def test_stored_entries_equal_reference(ftp_pair):
    rng = np.random.default_rng(62)
    bodies = [rng.bytes(int(n)) for n in rng.integers(1, 4 * CHUNK, size=6)]

    def run(i, srv):
        c = client(srv)
        c.mkd("/kept")
        out = [c.storbinary(f"STOR /kept/k{k}.bin", io.BytesIO(b)) for k, b in enumerate(bodies)]
        c.quit()
        return out

    ftp_pair.each(run)
    ftp_pair.store("/kept")
