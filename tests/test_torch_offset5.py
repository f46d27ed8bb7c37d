"""The 5-byte offset build (SEAWEEDFS_TPU_OFFSET_BYTES=5, the reference's
`5BytesOffset` build tag) held against the JAX package's.

Offset width is fixed at import, like a build tag, so each package runs
in a subprocess with the switch set (as `tests/test_needle_map_compact.py`
does): a needle map with an offset past the 4-byte ceiling, a seeded
volume's `.idx` and `.dat`, its EC files (`.ecx` with 17-byte entries and
the 14 shards), degraded reads with four data shards gone, their rebuild
and the decode back to a `.dat`. Every file and answer must be equal
between the packages, the shards equal to a 4-byte encode of the same
`.dat` in this process, and the `.ecx` entries equal to the 4-byte ones.

Vacuum with writes after the compact snapshot: the JAX package counts 16
bytes an `.idx` entry there and in its integrity check, so in 5-byte mode
it loses the late writes (unless the snapshot held a multiple of 16
entries) and cannot reopen a volume that holds needles (ROADMAP Queue 3).
The port counts NEEDLE_MAP_ENTRY_SIZE: its late writes read back, its
`.dat` equals a 4-byte vacuum's in this process and its `.idx` holds the
same entries, and the volume reopens. Tolerance 0.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu_torch.ops.rs_kernel import RSCodec
from seaweedfs_tpu_torch.storage.erasure_coding import encoder
from tests.test_torch_volume_admin import pinned_clock
from tests._threads import stop_history_loops  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOST = (1, 4, 7, 9)
LATE = {5: False, 16: True, 21: False}  # snapshot entries -> JAX keeps the late writes

SCRIPT = r"""
import json, os, sys, time
sys.path.insert(0, REPO)
time.time_ns = lambda: 1_700_000_000 * 10**9  # append stamps count up from it
time.time = lambda: 1_700_000_000.0
import numpy as np
from importlib import import_module
P = PKG
types = import_module(P + ".storage.types")
idx_mod = import_module(P + ".storage.idx")
nm_mod = import_module(P + ".storage.needle_map")
Volume = import_module(P + ".storage.volume").Volume
Needle = import_module(P + ".storage.needle").Needle
encoder = import_module(P + ".storage.erasure_coding.encoder")
decoder = import_module(P + ".storage.erasure_coding.decoder")
EcVolume = import_module(P + ".storage.erasure_coding.ec_volume").EcVolume
port = P.endswith("torch")
kw = {"codec": import_module(P + ".ops.rs_kernel").RSCodec(device="cpu")} if port else {}
vkw = {"device": "cpu"} if port else {}
out = {"entry_size": types.NEEDLE_MAP_ENTRY_SIZE,
       "max_volume": types.MAX_POSSIBLE_VOLUME_SIZE}

# a needle map with an offset past the 4-byte ceiling
big = (40 << 30) + 8
path = os.path.join(OUT, "map.idx")
m = nm_mod.CompactNeedleMap(path)
m.put(7, big, 1234); m.put(9, 16, 99); m.put(3, big + 4096, 5); m.delete(9, big + 8192)
m.close()
m = nm_mod.CompactNeedleMap(path)
out["map"] = [m.get(k) for k in (3, 7, 9)]
m.close()
sf = nm_mod.SortedFileNeedleMap(os.path.join(OUT, "map"))
out["sorted"] = [sf.get(k) for k in (3, 7, 9)] + [list(sf.ascending_visit())]
sf.close()

# a seeded volume, its EC files, degraded reads, rebuild and decode
rng = np.random.default_rng(SEED)
v = Volume(OUT, "", 1, **vkw)
blobs = {}
for nid in range(1, 41):
    blobs[nid] = rng.bytes(int(rng.integers(1, 20000)))
    v.write_needle(Needle(cookie=0x31, id=nid, data=blobs[nid]))
v.delete_needle(Needle(cookie=0x31, id=13))
v.close()
base = os.path.join(OUT, "1")
encoder.write_ec_files(base, large_block_size=64 * 1024, small_block_size=1024, **kw)
encoder.write_sorted_file_from_idx(base)
encoder.save_volume_info(base + ".vif", version=3, large_block_size=64 * 1024,
                         small_block_size=1024)
for s in LOST:
    os.replace(base + ".ec%02d" % s, base + ".ec%02d.orig" % s)
ev = EcVolume(OUT, "", 1, **kw)
reads = {}
for nid, data in blobs.items():
    try:
        reads[nid] = ev.read_needle(nid, cookie=0x31).data == data
    except Exception as e:
        reads[nid] = type(e).__name__
ev.close()
out["degraded"] = reads
out["rebuilt"] = encoder.rebuild_ec_files(base, **kw)
size = decoder.find_dat_file_size(base, base)
decoder.write_dat_file(os.path.join(OUT, "decoded"), size,
                       [base + ".ec%02d" % i for i in range(10)],
                       large_block_size=64 * 1024, small_block_size=1024)
out["dat_size"] = size

# vacuum with writes after the compact snapshot, then a reopen
for vid, n in enumerate(LATE_N, start=2):
    v = Volume(OUT, "", vid, **vkw)
    for nid in range(1, n + 1):
        v.write_needle(Needle(cookie=0x31, id=nid, data=rng.bytes(200 + nid)))
    v.compact()
    late = {nid: rng.bytes(300 + nid) for nid in range(n + 1, n + 4)}
    for nid, data in late.items():
        v.write_needle(Needle(cookie=0x31, id=nid, data=data))
    v.commit_compact()
    got = {}
    for nid, data in late.items():
        try:
            got[nid] = v.read_needle(nid).data == data
        except Exception as e:
            got[nid] = type(e).__name__
    out["late_%d" % n] = got
    v.close()
    try:
        v = Volume(OUT, "", vid, **vkw)
        out["reopen_%d" % n] = sorted(k for k, _, _ in v.nm.ascending_visit())
        v.close()
    except Exception as e:
        out["reopen_%d" % n] = type(e).__name__
print(json.dumps(out))
"""


def run_build(pkg: str, out: str) -> dict:
    os.makedirs(out)
    code = (SCRIPT.replace("REPO", repr(REPO)).replace("PKG", repr(pkg))
            .replace("OUT", repr(out)).replace("SEED", "61")
            .replace("LOST", repr(LOST)).replace("LATE_N", repr(list(LATE))))
    env = dict(os.environ, SEAWEEDFS_TPU_OFFSET_BYTES="5", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    root = tmp_path_factory.mktemp("offset5")
    return {pkg: (run_build(pkg, str(root / pkg)), str(root / pkg))
            for pkg in ("seaweedfs_tpu_torch", "seaweedfs_tpu")}


def read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


FILES = (["map.idx", "map.sdx", "1.idx", "1.dat", "1.ecx", "1.vif", "decoded.dat"]
         + [f"1.ec{i:02d}" for i in range(14)])


@pytest.mark.parametrize("name", FILES)
def test_files_equal_reference(builds, name):
    (_, port_dir), (_, ref_dir) = builds["seaweedfs_tpu_torch"], builds["seaweedfs_tpu"]
    assert read(os.path.join(port_dir, name)) == read(os.path.join(ref_dir, name))


@pytest.mark.parametrize("key", ["entry_size", "max_volume", "map", "sorted", "degraded",
                                 "rebuilt", "dat_size"])
def test_answers_equal_reference(builds, key):
    port, ref = builds["seaweedfs_tpu_torch"][0], builds["seaweedfs_tpu"][0]
    assert port[key] == ref[key]
    if key == "entry_size":
        assert port[key] == 17
    if key == "map":
        assert port[key] == [[(40 << 30) + 8 + 4096, 5], [(40 << 30) + 8, 1234], None]
    if key == "degraded":
        assert port[key] == {**{str(n): True for n in range(1, 41)}, "13": "NeedleNotFound"}
    if key == "rebuilt":
        assert port[key] == list(LOST)


def test_shards_and_ecx_equal_four_byte_build(builds, tmp_path):
    """The same .dat encoded by the port in this (4-byte) process: the 14
    shards are equal, and the 17-byte .ecx decodes to the 16-byte one's
    (key, offset, size) entries; the decoded .dat equals the .dat."""
    _, d5 = builds["seaweedfs_tpu_torch"]
    base4 = str(tmp_path / "1")
    with open(base4 + ".dat", "wb") as f:
        f.write(read(os.path.join(d5, "1.dat")))
    encoder.write_ec_files(base4, large_block_size=64 * 1024, small_block_size=1024,
                           codec=RSCodec(device="cpu"))
    for i in range(14):
        assert read(f"{base4}.ec{i:02d}") == read(os.path.join(d5, f"1.ec{i:02d}")), i
    entries5 = list(_walk(os.path.join(d5, "1.ecx"), 17))
    latest = {}
    for key, off, size in _walk(os.path.join(d5, "1.idx"), 17):
        if off and size > 0:
            latest[key] = (key, off, size)
        else:
            latest.pop(key, None)
    assert entries5 == [latest[k] for k in sorted(latest)] and len(entries5) == 39
    size = builds["seaweedfs_tpu_torch"][0]["dat_size"]
    assert read(os.path.join(d5, "decoded.dat")) == read(os.path.join(d5, "1.dat"))[:size]


@pytest.mark.parametrize("n", list(LATE))
def test_vacuum_with_late_writes(builds, tmp_path, n):
    """The port keeps every late write across a 5-byte vacuum and reopens
    the volume; its .dat equals a 4-byte JAX vacuum of the same history
    and its .idx holds the same entries. Where the JAX snapshot held a
    multiple of 16 entries, the JAX 5-byte files are equal too."""
    port, pdir = builds["seaweedfs_tpu_torch"]
    ref, rdir = builds["seaweedfs_tpu"]
    vid = list(LATE).index(n) + 2
    assert port[f"late_{n}"] == {str(k): True for k in range(n + 1, n + 4)}
    assert port[f"reopen_{n}"] == list(range(1, n + 4))
    # the same history through the JAX package at 4-byte offsets, in process
    rng = np.random.default_rng(61)
    for nid in range(1, 41):  # the draws volume 1 took
        rng.bytes(int(rng.integers(1, 20000)))
    for m in list(LATE)[: vid - 2]:  # and the volumes before this one
        for nid in range(1, m + 1):
            rng.bytes(200 + nid)
        for nid in range(m + 1, m + 4):
            rng.bytes(300 + nid)
    d4 = str(tmp_path)
    with pinned_clock(1_700_000_000):
        rv = RefVolume(d4, "", vid)
        for nid in range(1, n + 1):
            rv.write_needle(RefNeedle(cookie=0x31, id=nid, data=rng.bytes(200 + nid)))
        rv.compact()
        for nid in range(n + 1, n + 4):
            rv.write_needle(RefNeedle(cookie=0x31, id=nid, data=rng.bytes(300 + nid)))
        rv.commit_compact()
    rv.close()
    pdat = read(os.path.join(pdir, f"{vid}.dat"))
    assert pdat[8:] == read(os.path.join(d4, f"{vid}.dat"))[8:]
    assert list(_walk(os.path.join(pdir, f"{vid}.idx"), 17)) == \
        list(_walk(os.path.join(d4, f"{vid}.idx"), 16))
    if LATE[n]:
        assert ref[f"late_{n}"] == port[f"late_{n}"]
        assert read(os.path.join(rdir, f"{vid}.dat")) == pdat


def _walk(path: str, entry: int):
    """(key, byte offset, size) of each 16- or 17-byte index entry."""
    raw = read(path)
    assert len(raw) % entry == 0
    for o in range(0, len(raw), entry):
        units = int.from_bytes(raw[o + 8:o + 12], "big")
        if entry == 17:
            units += raw[o + 12] << 32
        yield (int.from_bytes(raw[o:o + 8], "big"), units * 8,
               int.from_bytes(raw[o + entry - 4:o + entry], "big", signed=True))
