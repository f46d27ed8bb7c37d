"""The port's `s3.*` verbs held against the JAX shell, verb for verb, case
for case with the `s3.*` tests of `tests/test_shell_extra.py`
(`TestS3Commands` and `TestRound5Verbs::test_quota_enforce`), over the
JAX and the port cluster of `s3_twin()` (`tests/test_torch_s3.py`), each
verb through its own side's `CommandEnv(master, filer)`. Outputs must be
equal once addresses are named (`S3Norm`), errors must carry the same
text, and the filer entries the verbs write are compared as
`tests/test_torch_filer_meta.py` compares them. The gateways on top show
the verbs' effect: an identity `s3.configure` writes is taken live, and a
bucket `s3.bucket.quota.enforce -apply` marks read-only refuses writes.
Tolerance: byte equality.
"""

from __future__ import annotations

import io
import json
import time

import pytest

from seaweedfs_tpu.filer.filer_client import FilerClient as RefFilerClient
from seaweedfs_tpu.shell import CommandEnv as RefEnv
from seaweedfs_tpu.shell import run_command as ref_run
from seaweedfs_tpu_torch.filer.filer_client import FilerClient
from seaweedfs_tpu_torch.s3api.sigv4_client import S3Error
from seaweedfs_tpu_torch.shell import CommandEnv, ShellError, run_command
from seaweedfs_tpu_torch.shell.shell import run_shell

from .test_torch_filer_meta import seeded
from .test_torch_s3 import s3_twin

ADMIN_ONLY = {"identities": [{"name": "admin",
                              "credentials": [{"accessKey": "adminKey",
                                               "secretKey": "adminSecret"}],
                              "actions": ["Admin"]}]}


class Shells:
    """Both sides' shells; each line runs in both, outputs held equal."""

    def __init__(self, pair) -> None:
        self.pair = pair
        self.envs = []
        for s, env_cls, run, fc in ((pair.ref, RefEnv, ref_run, RefFilerClient),
                                    (pair.port, CommandEnv, run_command, FilerClient)):
            env = env_cls(s.side.master.url, filer_url=s.side.filer.url)
            self.envs.append((s, env, run, fc(s.side.filer.url)))

    def run(self, line: str) -> str:
        outs = []
        for s, env, run, _ in self.envs:
            try:
                outs.append(s.norm.text(run(env, line)))
            except Exception as e:  # the same refusal in both shells
                outs.append(f"{type(e).__name__}: {s.norm.text(str(e))}")
        assert outs[1] == outs[0], line
        if outs[1].startswith("ShellError: "):
            raise ShellError(outs[1][len("ShellError: "):])
        return outs[1]

    def put(self, path: str, data: bytes) -> None:
        for _, _, _, fc in self.envs:
            fc.put(path, data)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    with s3_twin(str(tmp_path_factory.mktemp("shs3")), ADMIN_ONLY) as pair:
        shells = Shells(pair)
        shells.run("lock")
        # the gateways' admin in the filer's identity document, so the
        # documents the verbs rewrite keep it when the gateways reload them
        shells.run("s3.configure -user admin -access_key adminKey -secret_key adminSecret"
                   " -actions Admin")
        yield shells
        shells.run("unlock")


class TestS3Commands:
    def test_bucket_lifecycle(self, cluster):
        assert "created" in cluster.run("s3.bucket.create -name photos")
        assert "photos" in cluster.run("s3.bucket.list")
        assert "100MB" in cluster.run("s3.bucket.quota -name photos -sizeMB 100")
        assert "104857600" in cluster.run("s3.bucket.quota -name photos")
        cluster.pair.entry("/buckets/photos")
        assert "deleted" in cluster.run("s3.bucket.delete -name photos")
        assert "photos" not in cluster.run("s3.bucket.list")
        with pytest.raises(ShellError):
            cluster.run("s3.bucket.delete -name absent")
        with pytest.raises(ShellError):
            cluster.run("s3.bucket.quota -name absent")

    def test_s3_configure_identities(self, cluster):
        out = cluster.run("s3.configure -user alice -access_key AK1 -secret_key SK1 "
                          "-actions Read,Write")
        assert "configured" in out
        cfg = json.loads(cluster.run("s3.configure"))
        assert "alice" in [i["name"] for i in cfg["identities"]]
        cluster.run("s3.configure -user carol -access_key AK2 -secret_key SK2 "
                    "-actions Read,List -buckets b1,b2")
        cfg = json.loads(cluster.run("s3.configure"))
        assert cfg["identities"][-1]["actions"] == ["Read:b1", "Read:b2", "List:b1", "List:b2"]
        assert "removed" in cluster.run("s3.configure -user alice -delete")
        cluster.pair.entry("/etc/iam/identity.json")
        cluster.run("s3.configure -user carol -delete")

    def test_clean_uploads(self, cluster):
        cluster.run("s3.bucket.create -name stage")
        cluster.put("/buckets/stage/.uploads/upl1/00001.part", b"x" * 100)
        out = cluster.run("s3.clean.uploads -timeAgo 0s")
        assert "removed 1" in out and "/buckets/stage/.uploads/upl1" in out
        assert cluster.run("s3.clean.uploads -timeAgo 1h") == "removed 0 stale multipart uploads"
        cluster.run("s3.bucket.delete -name stage")

    def test_circuitbreaker(self, cluster):
        out = cluster.run("s3.circuitbreaker -global.readLimit 128")
        assert json.loads(out)["global"]["readLimit"] == 128
        out = cluster.run("s3.circuitbreaker -global.writeLimit 4")
        assert json.loads(out)["global"] == {"readLimit": 128, "writeLimit": 4}
        cluster.pair.entry("/etc/s3/circuit_breaker.json")


class TestRound5Verbs:
    def test_quota_enforce(self, cluster):
        """Over-quota buckets flip read-only (which the gateways' write paths
        refuse) and flip back once under quota."""
        pair = cluster.pair
        cluster.run("s3.bucket.create -name q1")
        cluster.put("/buckets/q1/a.bin", seeded(300_000, 40))
        cluster.put("/buckets/q1/.uploads/u/00001.part", seeded(5000, 41))  # not billed
        cluster.run("s3.bucket.quota -name q1 -sizeMB 1")  # 1 MB: under
        out = cluster.run("s3.bucket.quota.enforce -apply")
        assert "q1" in out and "ok" in out
        for s, _, _, fc in cluster.envs:  # shrink the quota below usage
            entry = fc.get_entry("/buckets/q1")
            entry.setdefault("extended", {})["quota.bytes"] = "1000"
            fc.put_entry("/buckets/q1", entry)
        assert "OVER" in cluster.run("s3.bucket.quota.enforce")  # a dry run flips nothing
        out = cluster.run("s3.bucket.quota.enforce -apply")
        assert "OVER" in out and "READ-ONLY" in out
        assert pair.entry("/buckets/q1")["extended"].get("s3-read-only") == "quota"
        with pytest.raises(S3Error) as ei:
            pair.api("put_object", "q1", "b.txt", b"refused")
        assert ei.value.code == "AccessDenied"
        for s, _, _, fc in cluster.envs:  # raise the quota again
            entry = fc.get_entry("/buckets/q1")
            entry["extended"]["quota.bytes"] = str(100 << 20)
            fc.put_entry("/buckets/q1", entry)
        assert "writable again" in cluster.run("s3.bucket.quota.enforce -apply")
        pair.api("put_object", "q1", "b.txt", b"accepted")
        pair.store("/buckets/q1")


def test_configure_is_taken_by_the_gateways(cluster):
    """An identity `s3.configure` writes into the filer is taken live by
    both gateways; deleting it revokes it."""
    cluster.run("s3.configure -user dave -access_key AKdave -secret_key SKdave "
                "-actions Read,List")
    dave = ("AKdave", "SKdave")
    for s in cluster.pair.sides:
        client = s.client(dave)
        for _ in range(200):
            if client.request("GET", "/")[0] == 200:
                break
            time.sleep(0.05)
    assert isinstance(cluster.pair.api("list_buckets", creds=dave), list)
    cluster.run("s3.configure -user dave -delete")
    for s in cluster.pair.sides:
        client = s.client(dave)
        for _ in range(200):
            if client.request("GET", "/")[0] == 403:
                break
            time.sleep(0.05)
    with pytest.raises(S3Error) as ei:
        cluster.pair.api("list_buckets", creds=dave)
    assert ei.value.code == "InvalidAccessKeyId"


def test_verbs_through_run_shell(cluster):
    """The verbs through the port's script runner with -filer."""
    _, env, _, _ = cluster.envs[1]
    out = io.StringIO()
    rc = run_shell(env.master_url, env.filer_url, "s3.bucket.create -name viashell;"
                   " s3.bucket.list; s3.bucket.delete -name viashell", out=out)
    assert rc == 0
    lines = out.getvalue().splitlines()
    assert lines[0] == "created bucket viashell" and "viashell" in lines[1:-1]
    assert lines[-1] == "deleted bucket viashell"
