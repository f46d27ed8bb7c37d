"""The port's CLI as a user runs it: `python -m seaweedfs_tpu_torch.command.main
server -device cpu -filer -s3` in a process of its own on ephemeral ports,
driven by the other verbs, each in a process of its own too (a filer PUT
and GET, `upload` then `download`, `shell` with `volume.list`,
`benchmark`), then SIGTERM. `benchmark`'s JSON report has the keys of the
JAX verb's against a JAX `server` started the same way. A role started
without CUDA and without `-device cpu` exits non-zero with
`resolve_device`'s message. Every child runs under its own timeout: 60 s to
its last "listening" line or to its end, 15 s from SIGTERM to its exit."""

from __future__ import annotations

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
START_S = 60
EXIT_S = 15
RUN_S = 60


def child_env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", **extra)


class Server:
    """A server verb of `<pkg>.command.main`, by default `server -filer
    -s3` on ephemeral ports, up to its `last` role's "listening" line."""

    def __init__(self, pkg: str, tmp: Path, verb_args: list | None = None,
                 last: str = "s3 gateway"):
        self.pkg = pkg
        d = tmp / f"{pkg}-data"
        d.mkdir()
        if verb_args is None:
            verb_args = ["server", "-filer", "-s3", "-dir", str(d), "-master.port", "0",
                         "-volume.port", "0", "-filer.port", "0", "-s3.port", "0"]
        args = [sys.executable, "-m", f"{pkg}.command.main", *verb_args]
        if pkg == "seaweedfs_tpu_torch":
            args += ["-device", "cpu"]
        t0 = time.monotonic()
        self.proc = subprocess.Popen(
            args, cwd=str(tmp), env=child_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        self._err: list[str] = []
        threading.Thread(target=self._drain_err, daemon=True).start()
        lines: queue.Queue = queue.Queue()
        threading.Thread(target=self._read_out, args=(lines,),
                         daemon=True).start()
        self.urls: dict[str, str] = {}
        while last not in self.urls:
            left = START_S - (time.monotonic() - t0)
            try:
                line = lines.get(timeout=max(left, 0.01))
            except queue.Empty:
                self.proc.kill()
                raise AssertionError(f"{pkg} server: no {last} line in {START_S} s:"
                                     f" {self.urls} {''.join(self._err)[-2000:]}")
            if line is None:
                raise AssertionError(f"{pkg} server exited: "
                                     f"{''.join(self._err)[-2000:]}")
            if " listening at " in line:
                role, url = line.strip().split(" listening at ")
                self.urls[role] = url
        self.start_s = time.monotonic() - t0

    def _drain_err(self):
        for line in self.proc.stderr:
            self._err.append(line)

    def _read_out(self, lines):
        for line in self.proc.stdout:
            lines.put(line)
        lines.put(None)

    @property
    def master(self) -> str:
        return self.urls["master"]

    @property
    def filer(self) -> str:
        return self.urls["filer"]

    def terminate(self) -> tuple[int, float]:
        """SIGTERM; -> (exit code, seconds to exit)."""
        t0 = time.monotonic()
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(EXIT_S)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            raise AssertionError(f"{self.pkg} server still up {EXIT_S} s after"
                                 f" SIGTERM: {''.join(self._err)[-2000:]}")
        return rc, time.monotonic() - t0

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def verb(pkg: str, *args: str, cwd: Path) -> str:
    """One verb in a process of its own; -> its stdout (exit code 0)."""
    out = subprocess.run(
        [sys.executable, "-m", f"{pkg}.command.main", *args], cwd=str(cwd),
        env=child_env(), capture_output=True, text=True, timeout=RUN_S)
    assert out.returncode == 0, (args, out.stdout[-2000:], out.stderr[-2000:])
    return out.stdout


@pytest.fixture()
def servers(tmp_path):
    started: list[Server] = []

    def start(pkg: str, *args, **kw) -> Server:
        started.append(Server(pkg, tmp_path, *args, **kw))
        return started[-1]

    yield start
    for s in started:
        s.kill()


def test_server_serves_the_verbs_then_exits_on_sigterm(servers, tmp_path):
    srv = servers("seaweedfs_tpu_torch")
    assert set(srv.urls) == {"master", "volume server", "filer", "s3 gateway"}
    rng = np.random.default_rng(20)
    # a filer PUT and GET (small: chunk ETags take the plain MD5 on the CPU)
    body = rng.bytes(16_384)
    req = urllib.request.Request(srv.filer + "/cli/a.bin", data=body, method="PUT")
    with urllib.request.urlopen(req, timeout=RUN_S) as r:
        assert json.loads(r.read())["size"] == len(body)
    with urllib.request.urlopen(srv.filer + "/cli/a.bin", timeout=RUN_S) as r:
        assert r.read() == body
    # upload, then download the fid it printed
    src = tmp_path / "up.bin"
    src.write_bytes(rng.bytes(300_000))
    (rec,) = json.loads(verb("seaweedfs_tpu_torch", "upload", "-master", srv.master,
                             str(src), cwd=tmp_path))
    assert rec["fileName"] == "up.bin" and rec["size"] == 300_000
    dl = tmp_path / "dl"
    dl.mkdir()
    out = verb("seaweedfs_tpu_torch", "download", "-master", srv.master,
               "-dir", str(dl), rec["fid"], cwd=tmp_path)
    assert f"({300_000} bytes)" in out
    assert (dl / rec["fid"].replace(",", "_")).read_bytes() == src.read_bytes()
    # the shell verb lists the volume the upload went to
    vid = rec["fid"].split(",")[0]
    listing = verb("seaweedfs_tpu_torch", "shell", "-master", srv.master,
                   "volume.list", cwd=tmp_path)
    assert f"  volume {vid} collection=(default) " in listing, listing
    rc, secs = srv.terminate()
    assert rc == 0 and secs <= EXIT_S


def _keys(d) -> dict:
    return {k: _keys(v) if isinstance(v, dict) else type(v).__name__
            for k, v in d.items()}


def test_benchmark_report_keys_equal_reference(servers, tmp_path):
    reports = {}
    for pkg in ("seaweedfs_tpu_torch", "seaweedfs_tpu"):
        srv = servers(pkg)
        reports[pkg] = json.loads(verb(pkg, "benchmark", "-n", "64", "-size",
                                       "1024", "-c", "4", "-master", srv.master,
                                       cwd=tmp_path))
        rc, _ = srv.terminate()
        assert rc == 0
    port, ref = reports["seaweedfs_tpu_torch"], reports["seaweedfs_tpu"]
    assert _keys(port) == _keys(ref)
    assert port["write"]["requests"] == port["read"]["requests"] == 64


def test_volume_local_socket_equals_reference(servers, tmp_path):
    """`volume -localSocket`: the same needle written over each package's
    unix socket reads back over TCP, with the same answers."""
    from seaweedfs_tpu_torch.server.httpd import http_request

    answers = {}
    for pkg in ("seaweedfs_tpu_torch", "seaweedfs_tpu"):
        sock = tmp_path / f"{pkg}.sock"
        d = tmp_path / f"{pkg}-vol"
        d.mkdir()
        srv = servers(pkg, ["volume", "-dir", str(d), "-port", "0",
                            "-mserver", "127.0.0.1:9", "-localSocket", str(sock)],
                      last="volume server")
        unix = "http+unix://" + urllib.parse.quote(str(sock), safe="")
        st1, _, _ = http_request("POST", unix + "/admin/allocate_volume",
                                 json.dumps({"volume": 3}).encode(),
                                 {"Content-Type": "application/json"})
        st2, _, body = http_request("POST", unix + "/3,01deadbeef", b"over the socket")
        st3, _, got = http_request("GET", srv.urls["volume server"] + "/3,01deadbeef")
        answers[pkg] = (st1, st2, json.loads(body)["size"], st3, got)
        rc, _ = srv.terminate()
        assert rc == 0
    assert answers["seaweedfs_tpu_torch"] == answers["seaweedfs_tpu"] == \
        (200, 201, 15, 200, b"over the socket")


@pytest.mark.parametrize("role", ["volume", "filer", "server"])
def test_role_without_cuda_or_device_cpu_exits_nonzero(tmp_path, monkeypatch, role):
    """No CUDA (hidden from the child) and no -device cpu: the role exits
    non-zero before it listens, with resolve_device's message."""
    import torch

    from seaweedfs_tpu_torch.ops.rs_kernel import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError) as want:
        resolve_device(None)
    args = {"volume": ["-dir", str(tmp_path), "-port", "0"],
            "filer": ["-port", "0", "-master", "http://127.0.0.1:9"],
            "server": ["-dir", str(tmp_path), "-master.port", "0",
                       "-volume.port", "0"]}[role]
    out = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch.command.main", role, *args],
        cwd=str(tmp_path), env=child_env(CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=RUN_S)
    assert out.returncode != 0
    assert str(want.value) in out.stderr
    assert "listening" not in out.stdout
