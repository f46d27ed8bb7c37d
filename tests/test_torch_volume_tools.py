"""The port's offline volume tools (`command/fix.py`,
`command/volume_tools.py`) held against the JAX package's.

The same volume, written under one frozen clock with overwrites and
deletes, is copied into two directories; `fix`, `compact` and `export` run
on one copy each through the port and the JAX package: the rebuilt `.idx`,
the compacted `.dat` and `.idx`, the tar, the extracted files and every
printed line must be equal. `backup` runs against a JAX and a port volume
server holding the same volume: the full pull over `/admin/volume/raw`,
then the incremental pull over `/admin/tail` after more writes, leaves
byte-equal files on both sides, equal to the servers' own. Tolerance 0.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.command import fix as ref_fix
from seaweedfs_tpu.command import volume_tools as ref_tools
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu_torch.command import fix, volume_tools
from tests.test_torch_shell_volume import base
from tests.test_torch_volume_admin import allocate, delete, pinned_clock, twin, write


def read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture
def copies(tmp_path):
    """A JAX-written volume 5 (collection "c"): 30 needles, some named,
    3 overwritten and 5 deleted; copied into port/ and ref/."""
    src = str(tmp_path / "src")
    os.makedirs(src)
    rng = np.random.default_rng(41)
    with pinned_clock(1_700_000_000):
        v = RefVolume(src, "c", 5)
        for nid in range(1, 31):
            n = RefNeedle(cookie=0x77, id=nid, data=rng.bytes(int(rng.integers(1, 6000))))
            if nid % 4 == 0:
                n.name = f"dir{nid % 3}/file{nid}.bin".encode()
                n.set_has_name()
            n.last_modified = 1_700_000_000 + nid
            n.set_has_last_modified()
            v.write_needle(n)
        for nid in (2, 9, 17):
            v.write_needle(RefNeedle(cookie=0x77, id=nid, data=rng.bytes(300)))
        for nid in (3, 8, 12, 20, 29):
            v.delete_needle(RefNeedle(cookie=0x77, id=nid))
        v.close()
    out = []
    for name in ("port", "ref"):
        d = str(tmp_path / name)
        shutil.copytree(src, d)
        out.append(d)
    return out


def both(capsys, port_fn, ref_fn, port_args, ref_args) -> list[str]:
    """Run one tool through each package; their stdout, with each side's
    paths (the arguments after -dir, -o and -outputDir) replaced by a
    name, must be equal."""
    printed = []
    for fn, args in ((port_fn, port_args), (ref_fn, ref_args)):
        assert fn(args) == 0
        out = capsys.readouterr().out
        for flag, path in zip(args, args[1:]):
            if flag in ("-dir", "-o", "-outputDir"):
                out = out.replace(path, f"<{flag[1:]}>")
        printed.append(out)
    assert printed[0] == printed[1]
    return printed[0].splitlines()


def test_fix_equals_reference(copies, capsys):
    for d in copies:
        os.remove(os.path.join(d, "c_5.idx"))
    lines = both(capsys, fix.run, ref_fix.run,
                 *[["-dir", d, "-collection", "c", "-volumeId", "5"] for d in copies])
    assert lines[0].startswith("scanned 38 needles -> ")
    assert read(os.path.join(copies[0], "c_5.idx")) == read(os.path.join(copies[1], "c_5.idx"))


def test_compact_equals_reference(copies, capsys):
    lines = both(capsys, volume_tools.run_compact, ref_tools.run_compact,
                 *[["-dir", d, "-collection", "c", "-volumeId", "5"] for d in copies])
    assert lines[0].startswith("volume 5: ")
    for ext in (".dat", ".idx"):
        assert read(os.path.join(copies[0], "c_5" + ext)) == \
            read(os.path.join(copies[1], "c_5" + ext))


@pytest.mark.parametrize("how", ["tar", "dir", "list"])
def test_export_equals_reference(copies, capsys, tmp_path, how):
    args = []
    for name, d in zip(("port", "ref"), copies):
        a = ["-dir", d, "-collection", "c", "-volumeId", "5"]
        if how == "tar":
            a += ["-o", str(tmp_path / f"{name}.tar")]
        elif how == "dir":
            a += ["-outputDir", str(tmp_path / f"{name}-out")]
        args.append(a)
    lines = both(capsys, volume_tools.run_export, ref_tools.run_export, *args)
    if how == "tar":
        assert read(str(tmp_path / "port.tar")) == read(str(tmp_path / "ref.tar"))
    elif how == "dir":
        trees = []
        for name in ("port", "ref"):
            root = tmp_path / f"{name}-out"
            trees.append(sorted((str(p.relative_to(root)), p.read_bytes())
                                for p in root.rglob("*") if p.is_file()))
        assert trees[0] == trees[1] and len(trees[0]) == 25
    else:
        assert len(lines) == 25


def test_backup_full_then_incremental_equals_reference(tmp_path, capsys):
    """backup into an empty directory pulls the whole volume; after more
    writes and a delete a second run appends the tail and rebuilds the
    .idx. Both packages' tools against their own servers leave equal
    files, and the .dat equals the server's."""
    rng = np.random.default_rng(51)
    first = {nid: rng.bytes(int(rng.integers(1, 8000))) for nid in range(1, 26)}
    more = {nid: rng.bytes(int(rng.integers(1, 8000))) for nid in range(26, 36)}
    with twin(racks=("r1",)) as (ref, port):
        sides = (port, ref)
        with pinned_clock(1_700_000_000):
            for side in sides:
                allocate(side, 3, [0])
                for nid, data in first.items():
                    write(side, 0, 3, nid, data)
        dirs = [str(tmp_path / name) for name in ("port", "ref")]
        args = [["-server", side.url(0).split("//", 1)[1], "-volumeId", "3", "-dir", d]
                for side, d in zip(sides, dirs)]
        lines = both(capsys, volume_tools.run_backup, ref_tools.run_backup, *args)
        assert lines[-1].startswith("full backup of volume 3 -> ")
        for ext in (".dat", ".idx"):
            assert read(os.path.join(dirs[0], "3" + ext)) == \
                read(os.path.join(dirs[1], "3" + ext)) == read(base(port, 0, 3) + ext)
        with pinned_clock(1_700_000_100):
            for side in sides:
                for nid, data in more.items():
                    write(side, 0, 3, nid, data)
                delete(side, 0, 3, 4)
        lines = both(capsys, volume_tools.run_backup, ref_tools.run_backup, *args)
        assert lines[-1].startswith("incremental backup of volume 3: +")
        for ext in (".dat", ".idx"):
            assert read(os.path.join(dirs[0], "3" + ext)) == read(os.path.join(dirs[1], "3" + ext))
        assert read(os.path.join(dirs[0], "3.dat")) == read(base(port, 0, 3) + ".dat")
