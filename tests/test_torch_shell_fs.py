"""The port's `fs.*` verbs held against the JAX shell, verb for verb, over a
JAX and a port cluster side by side (`tests/test_torch_filer_meta.py::twin`,
`device="cpu"`), case for case with `tests/test_shell_extra.py`.

Each cluster's filer runs with dedup on (a small CDC geometry) and a
test-local notification queue. The same seeded namespace is written to
both; every verb then runs in both shells, each through its own
`CommandEnv(master, filer)`, and the outputs must be equal once addresses
are named and fids ranked (`Norm`); the files `fs.meta.save` writes are
compared the same way, entry by entry, without the times the filers stamp.
Errors must carry the same text. Also: the shell finds a filer through the
master's `/cluster/ps` when none is given, `cluster.ps` lists the
registered filer in both shells, and `run_shell -filer` drives the verbs.
Tolerance: byte equality.
"""

from __future__ import annotations

import io
import json

import pytest

from seaweedfs_tpu.shell import CommandEnv as RefEnv
from seaweedfs_tpu.shell import run_command as ref_run
from seaweedfs_tpu_torch.shell import CommandEnv, ShellError, run_command
from seaweedfs_tpu_torch.shell.shell import run_shell

from .test_torch_filer_meta import CHUNK, Norm, Queue, bodies, history, seeded, twin
from ._threads import stop_history_loops  # noqa: F401

DEDUP = dict(dedup=True, dedup_avg_bits=10, dedup_min=1024, dedup_max=8192)


class Shell:
    """One side's shell and its normalizer."""

    def __init__(self, side, env, run) -> None:
        self.side = side
        self.env = env
        self.run_fn = run
        self.norm = Norm(side)

    def run(self, line: str) -> str:
        try:
            out = self.run_fn(self.env, line)
        except Exception as e:  # the same refusal in both shells
            return f"{type(e).__name__.replace('HTTPStatusError', 'OSError')}:" \
                   f" {self.norm.text(str(e))}"
        if line.startswith("fs.meta.cat") and out.startswith("{"):  # one entry's JSON
            return json.dumps(self.norm(json.loads(out)), indent=2)
        return self.norm.text(out)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    queues = {}

    def kw(side, i):
        queues[side] = Queue()
        return dict(DEDUP, notification_queue=queues[side])

    with twin(str(tmp_path_factory.mktemp("fs")), filer_kw=kw) as sides:
        for side in sides:
            history(side, "/fs")
            side.req("PUT", "/fs/dir/text.txt", b"hello from the filer\n")
            side.req("PUT", "/fs/deep/a/b/c.bin", seeded(3 * CHUNK, 7))
        ref, port = sides
        yield (Shell(ref, RefEnv(ref.master.url, ref.filer.url), ref_run),
               Shell(port, CommandEnv(port.master.url, port.filer.url), run_command),
               queues)


def both(cluster, line: str) -> str:
    ref, port, _ = cluster
    want, got = ref.run(line), port.run(line)
    assert got == want, line
    return got


@pytest.mark.parametrize("line", [
    "fs.ls /fs", "fs.ls -l /fs/dir", "fs.ls /fs/nope", "fs.du /fs", "fs.du /fs/deep",
    "fs.tree /fs", "fs.tree /fs/deep/a", "fs.cat /fs/dir/text.txt", "fs.cat /fs/dir/small.txt",
    "fs.cat /fs/nope", "fs.cat", "fs.verify /fs", "fs.meta.cat /fs/dir/moved.bin",
    "fs.meta.cat", "fs.meta.cat /fs/nope", "fs.configure", "fs.pwd",
    "fs.meta.changeVolumeId -dir /fs", "fs.merge.volumes -fromVolumeId 1",
])
def test_read_verbs_equal_reference(cluster, line):
    out = both(cluster, line)
    assert out


def test_listings_name_the_namespace(cluster):
    assert both(cluster, "fs.ls /fs").splitlines() == ["deep", "dir", "keep"]
    assert both(cluster, "fs.du /fs") == (
        f"{200 + 3 * CHUNK + 123 + 100 + 21 + 2 * CHUNK + 3 * CHUNK} bytes, 6 files,"
        " 5 directories under /fs")
    assert "verified 6 files: 6 ok, 0 broken" in both(cluster, "fs.verify /fs")
    assert both(cluster, "fs.cat /fs/dir/text.txt") == "hello from the filer\n"


def test_cd_pwd_and_relative_paths(cluster):
    for line, want in [("fs.cd /fs/dir", "/fs/dir"), ("fs.pwd", "/fs/dir"),
                       ("fs.cd ..", None), ("fs.cd /fs/dir/text.txt", None),
                       ("fs.cd /fs/nope", None), ("fs.cd", "/"), ("fs.cd fs", "/fs"),
                       ("fs.cd deep/a", "/fs/deep/a"), ("fs.pwd", "/fs/deep/a")]:
        out = both(cluster, line)
        if want is not None:
            assert out == want
    meta = both(cluster, "fs.meta.cat b/c.bin")
    assert json.loads(meta)["full_path"] == "/fs/deep/a/b/c.bin"
    both(cluster, "fs.cd /")


def test_mkdir_mv_rm(cluster):
    lines = ["fs.mkdir /fs/new", "fs.ls /fs", "fs.mv /fs/new /fs/new2", "fs.mv /fs/new2",
             "fs.ls /fs", "fs.rm /fs/new2", "fs.ls /fs", "fs.mkdir /fs/t/u",
             "fs.rm /fs/t", "fs.rm /fs/t -r", "fs.rm -r /fs/t", "fs.rm", "fs.ls /fs"]
    outs = [both(cluster, line) for line in lines]
    assert outs[0] == "created /fs/new" and "new2" in outs[4].split()
    assert outs[8].startswith("ShellError: rm /fs/t: 409")
    assert outs[9] == "removed /fs/t" and outs[10] == outs[11] == \
        "ShellError: usage: fs.rm [-r] <path>"
    assert outs[-1].split() == ["deep", "dir", "keep"]


def test_meta_save_and_load(cluster, tmp_path):
    ref, port, _ = cluster
    saved = {}
    for sh in (ref, port):
        path = tmp_path / f"{sh.side.name}.jsonl"
        out = sh.run(f"fs.meta.save -o {path} /fs/keep")
        assert out == f"saved 1 entries to {sh.norm.text(str(path))}"
        saved[sh.side.name] = [sh.norm(json.loads(line)) for line in open(path)]
        want = bodies(sh.side, "/fs/keep")
        sh.run("fs.rm /fs/keep -r")
        assert sh.run(f"fs.meta.load {path}") == "loaded 1 entries"
        assert bodies(sh.side, "/fs/keep") == want
    assert saved["port"] == saved["ref"]
    assert both(cluster, "fs.meta.load") == "ShellError: usage: fs.meta.load <file.jsonl>"


def test_configure_rules(cluster):
    ref, port, _ = cluster
    outs = [both(cluster, line) for line in [
        "fs.configure -locationPrefix /fs/ro/ -readOnly",
        "fs.configure -locationPrefix /fs/ro/ -readOnly -collection c -replication 000 -apply",
        "fs.configure",
        "fs.configure -locationPrefix /fs/bad/ -ttl 9q",
    ]]
    assert outs[0].endswith("(not saved; add -apply)") and outs[1].endswith("(saved)")
    assert "/fs/ro/" in outs[2] and outs[3].startswith("ShellError: invalid -ttl")
    answers = [sh.side.req("PUT", "/fs/ro/x", b"x")[0] for sh in (ref, port)]
    assert answers == [403, 403]
    assert "(saved)" in both(cluster, "fs.configure -locationPrefix /fs/ro/ -delete -apply")
    answers = [sh.side.req("PUT", "/fs/ro/x", b"x")[0] for sh in (ref, port)]
    assert answers == [201, 201]
    both(cluster, "fs.rm /fs/ro -r")


def test_log_purge(cluster):
    for sh in cluster[:2]:
        sh.side.req("POST", "/topics/.system/log/2000-01-01?mkdir=true", b"")
        sh.side.req("POST", "/topics/.system/log/2000-01-02?mkdir=true", b"")
    assert both(cluster, "fs.log.purge -modifyDayAgo 0") == \
        "purged 2 day(s): 2000-01-01, 2000-01-02"
    assert both(cluster, "fs.log.purge") == "purged 0 day(s)"


def test_notify_and_change_volume_id(cluster):
    ref, port, queues = cluster
    before = {n: len(q.messages) for n, q in queues.items()}
    assert both(cluster, "fs.meta.notify /fs/deep") == "sent 3 entries under /fs/deep"
    sent = [Norm(sh.side)(queues[sh.side.name].messages[before[sh.side.name]:])
            for sh in (ref, port)]
    assert sent[0] == sent[1] and len(sent[1]) == 3
    assert both(cluster, "fs.meta.changeVolumeId -dir /fs/deep -fromVolumeId 1"
                         " -toVolumeId 9") == "rewrote 1 entries under /fs/deep"
    out = both(cluster, "fs.verify /fs/deep")
    assert out.splitlines()[-1] == "verified 1 files: 0 ok, 1 broken"
    assert both(cluster, "fs.meta.changeVolumeId -dir /fs/deep -fromVolumeId 9"
                         " -toVolumeId 1") == "rewrote 1 entries under /fs/deep"
    assert "1 ok, 0 broken" in both(cluster, "fs.verify /fs/deep")


def test_dedup_gc_verb(cluster):
    ref, port, _ = cluster
    for sh in (ref, port):
        sh.side.req("PUT", "/fs/gc/a.bin", seeded(6 * CHUNK, 11))
        sh.side.req("PUT", "/fs/gc/b.bin", seeded(6 * CHUNK, 11))
        sh.side.req("PUT", "/fs/gc/c.bin", seeded(5 * CHUNK, 12))
        sh.run("fs.rm /fs/gc -r")
        srv = sh.side.filer
        srv._dedup_recent = {f: 0.0 for f in srv._dedup_recent}
    out = both(cluster, "fs.dedup.gc")
    assert out.startswith("scanned ") and "(0 errors)" not in out
    assert out.endswith(", 0 errors)") and "dropped 0 " not in out
    assert both(cluster, "fs.dedup.gc").split(", dropped ")[1].startswith("0 (0 bytes")


def test_filer_found_through_the_master(cluster):
    """With no filer given, the shell takes the first filer the master's
    `/cluster/ps` lists, where the filer registered at start."""
    ref, port, _ = cluster
    outs = []
    for sh, env_cls, run in ((ref, RefEnv, ref_run), (port, CommandEnv, run_command)):
        env = env_cls(sh.side.master.url)
        outs.append((sh.norm.text(run(env, "fs.ls /fs")), sh.norm.text(env.filer_url),
                     sh.norm.text(run(env, "cluster.ps"))))
    assert outs[0] == outs[1]
    ls, filer, ps = outs[1]
    assert ls.split() == ["deep", "dir", "keep"] and filer == "http://f0"
    assert ps.splitlines()[-1] == "filer http://f0"


def test_no_filer_is_refused():
    for env, run in ((RefEnv("http://127.0.0.1:1"), ref_run),
                     (CommandEnv("http://127.0.0.1:1"), run_command)):
        with pytest.raises(Exception, match="this command needs a filer"):
            run(env, "fs.ls /")
    with pytest.raises(ShellError, match="this command needs a filer"):
        CommandEnv("http://127.0.0.1:1").require_filer()


def test_run_shell_with_filer_flag(cluster):
    _, port, _ = cluster
    buf = io.StringIO()
    rc = run_shell(port.side.master.url, port.side.filer.url,
                   script="fs.ls /fs; fs.cat /fs/nope", out=buf)
    lines = buf.getvalue().splitlines()
    assert rc == 1 and lines[:3] == ["deep", "dir", "keep"]
    assert lines[3] == "error: /fs/nope: 404"


def test_merge_volumes_verb(tmp_path):
    with twin(str(tmp_path)) as sides:
        ref, port = sides
        shells = (Shell(ref, RefEnv(ref.master.url, ref.filer.url), ref_run),
                  Shell(port, CommandEnv(port.master.url, port.filer.url), run_command))
        for sh in shells:
            history(sh.side, "/m")
            sh.side.allocate(2)
        pair = (*shells, None)
        dry = both(pair, "fs.merge.volumes -fromVolumeId 1 -toVolumeId 2 -dir /m")
        assert dry == "6 chunk(s) in volume 1 under /m (dry run; add -apply)"
        want = [bodies(sh.side, "/m") for sh in shells]
        out = both(pair, "fs.merge.volumes -fromVolumeId 1 -toVolumeId 2 -dir /m -apply")
        assert out == "6 chunk(s) in volume 1 under /m; moved 6 to volume 2"
        assert [bodies(sh.side, "/m") for sh in shells] == want
        assert both(pair, "fs.merge.volumes -fromVolumeId 1 -toVolumeId 2 -dir /m") == \
            "0 chunk(s) in volume 1 under /m (dry run; add -apply)"
        assert both(pair, "fs.merge.volumes -fromVolumeId 2 -toVolumeId 2").startswith(
            "ShellError: POST http://f0/__meta__/merge_volumes -> 400")
