"""The port's small cluster verbs held against the JAX shell: `cluster.ps`,
`collection.list`, `collection.delete`, `volume.list`, `volume.status`,
`cluster.scrub`, and the master's `GET /vol/status`.

A JAX cluster (fastlane off, so its Python handlers answer) and a port
cluster (`device="cpu"`) are fed the same writes and deletes under one
frozen clock; each verb runs in both shells and the outputs must be
equal once server addresses are named s0, s1, ... and the master's
address is named m. One thing is allowed to differ, and only this:
`cluster.scrub`'s wall-clock figures (the age of the last pass and its
GB/s) are compared by shape, not by value, with its servers in name order
(the verb orders them by address). Neither cluster has a filer here, so
`cluster.ps` lists none in both; `tests/test_torch_shell_fs.py` holds the
listing of registered filers.
"""

from __future__ import annotations

import re

import pytest

from seaweedfs_tpu_torch.server.httpd import get_json, post_json
from tests.test_torch_shell_volume import Shells, base, flip
from tests.test_torch_volume_admin import (
    allocate,
    delete,
    pinned_clock,
    seeded_blobs,
    twin,
    write,
)
from tests._threads import stop_history_loops  # noqa: F401


@pytest.fixture
def shells():
    with twin(racks=("r1", "r1", "r2")) as (ref, port):
        sh = Shells(ref, port)
        blobs = seeded_blobs(31, 24)
        for side in (ref, port):
            allocate(side, 1, [0, 1], replication="001")
            allocate(side, 2, [2], collection="photos")
            allocate(side, 3, [0], collection="photos")
            allocate(side, 4, [1, 2], replication="010", collection="logs")
        with pinned_clock():
            for side in (ref, port):
                for nid, data in blobs.items():
                    write(side, 0, 1, nid, data)
                    write(side, 2, 2, nid, data)
                    if nid % 3 == 0:
                        write(side, 0, 3, nid, data)
                        write(side, 1, 4, nid, data)
                for nid in range(1, 25, 4):
                    delete(side, 0, 1, nid)
        sh.beat()
        yield sh


def norm_master(side, text: str) -> str:
    return text.replace(side.master.url.split("//", 1)[1], "m")


def run_both(sh, line: str) -> tuple[str, str]:
    """(JAX output, port output) of one verb, addresses named."""
    from seaweedfs_tpu.shell import run_command as ref_run
    from seaweedfs_tpu_torch.shell import run_command

    sh.beat()
    ref_out = sh.ref.norm(norm_master(sh.ref, ref_run(sh.envs[0], line)))
    port_out = sh.port.norm(norm_master(sh.port, run_command(sh.envs[1], line)))
    return ref_out, port_out


def test_cluster_ps_equals_reference(shells):
    ref_out, port_out = run_both(shells, "cluster.ps")
    assert port_out == ref_out
    assert ref_out.splitlines()[0].startswith("master ") and ref_out.count(
        "volumeServer ") == 3


@pytest.mark.parametrize("line", [
    "collection.list", "volume.list", "volume.status -volumeId 1",
    "volume.status -volumeId 4", "volume.status 2", "volume.status -volumeId 99",
])
def test_listing_verbs_equal_reference(shells, line):
    out = shells.run(line)
    assert out


def test_collection_delete_equals_reference(shells):
    sh = shells
    assert "photos" in sh.run("collection.list")
    sh.run("lock")
    out = sh.run("collection.delete -collection photos")
    assert out == "deleted 2 volumes of collection 'photos'"
    listing = sh.run("collection.list")
    assert "photos" not in listing and "logs" in listing
    sh.run("collection.delete -collection nothing-here")
    sh.run("unlock")
    sh.run("volume.list")


def test_vol_status_equals_reference(shells):
    sh = shells
    sh.beat()
    want = sh.ref.norm(get_json(f"{sh.ref.master.url}/vol/status"))
    got = sh.port.norm(get_json(f"{sh.port.master.url}/vol/status"))
    assert got == want
    assert sorted(got["Volumes"]) == ["s0", "s1", "s2"]
    assert got["Volumes"]["s0"]["1"]["delete_count"] == 6


_TIMED = [
    (re.compile(r"\(last \d+s ago,"), "(last Ns ago,"),
    (re.compile(r"@ \d+\.\d\d GB/s"), "@ N GB/s"),
]


def _untimed(text: str) -> str:
    for pat, repl in _TIMED:
        text = pat.sub(repl, text)
    return text


def _by_server(text: str) -> list:
    """The verb's lines with each server's block (its line and its
    findings) sorted by the server's name: the verb orders servers by
    address, and the two clusters' ports order differently."""
    lines = text.splitlines()
    blocks: list[list[str]] = []
    for line in lines[1:-1]:
        if line.startswith("    "):
            blocks[-1].append(line)
        else:
            blocks.append([line])
    return [lines[0]] + sorted(blocks) + [lines[-1]]


def test_cluster_scrub_equals_reference(shells):
    sh = shells
    # before any pass: every figure is a count, compared exactly
    ref_out, port_out = run_both(sh, "cluster.scrub")
    assert _by_server(port_out) == _by_server(ref_out)
    assert port_out.endswith("cluster integrity clean")
    # a corrupt needle on s0's replica of volume 1, then a pass everywhere
    off, _ = sh.port.servers[0].store.get_volume(1).nm.get(6)
    sh.both(lambda side: flip(base(side, 0, 1) + ".dat", off + 16 + 4 + 30))
    for side in (sh.ref, sh.port):
        for vs in side.servers:
            post_json(vs.url + "/admin/scrub/run", {})
    ref_out, port_out = run_both(sh, "cluster.scrub")
    assert _by_server(_untimed(port_out)) == _by_server(_untimed(ref_out))
    assert "[corrupt_needle]" in port_out
    assert port_out.endswith("the maintenance scrub task routes each to its heal")
    assert "(last " in port_out and " GB/s," in port_out
