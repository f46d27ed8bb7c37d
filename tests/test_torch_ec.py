"""The port's EC slice end to end against the JAX package's, on the CPU:
encode, rebuild, degraded reads and decode of one seeded volume at scaled-
down blocks (large 10000, small 100, as tests/test_erasure_coding.py uses),
byte for byte."""

import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.ops.rs_kernel import RSCodec as RefCodec
from seaweedfs_tpu.storage.erasure_coding import decoder as ref_decoder
from seaweedfs_tpu.storage.erasure_coding import encoder as ref_encoder
from seaweedfs_tpu.storage.erasure_coding import geometry as ref_geometry
from seaweedfs_tpu.storage.erasure_coding.ec_volume import EcVolume as RefEcVolume
from seaweedfs_tpu_torch.ops.rs_kernel import RSCodec
from seaweedfs_tpu_torch.storage import crc
from seaweedfs_tpu_torch.storage.erasure_coding import decoder, encoder, geometry
from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import EcVolume, NeedleNotFound
from seaweedfs_tpu_torch.storage.needle import FLAG_HAS_NAME, Needle
from seaweedfs_tpu_torch.storage.volume import Volume

LARGE = 10000
SMALL = 100
REBUILD_LOST = (2, 5, 11, 13)
DEGRADED_LOST = (1, 4, 7, 9)


def _make_volume(d, seed: int = 0, target: int = 2 * 1024 * 1024) -> dict:
    """A seeded volume of about `target` bytes; returns {id: (cookie, data)}."""
    rng = np.random.RandomState(seed)
    needles = {}
    with Volume(str(d), "", 1) as v:
        nid = 0
        while v.size() < target:
            nid += int(rng.randint(1, 1000))
            size = int(np.exp(rng.uniform(0, np.log(40000))))
            n = Needle(cookie=int(rng.randint(0, 2**31)), id=nid, data=rng.bytes(size))
            if nid % 3 == 0:
                n.name = b"n%d" % nid
                n.flags |= FLAG_HAS_NAME
            v.write_needle(n)
            needles[nid] = (n.cookie, n.data)
    return needles


def _seal(base: str) -> None:
    encoder.write_sorted_file_from_idx(base)
    encoder.save_volume_info(base + ".vif", version=3)


@pytest.fixture(scope="module")
def vol(tmp_path_factory):
    """One volume encoded twice: by the port (cpu) and by the JAX package."""
    root = tmp_path_factory.mktemp("ec")
    src = root / "src"
    src.mkdir()
    needles = _make_volume(src)
    dirs = {}
    for name in ("port", "ref"):
        d = root / name
        d.mkdir()
        shutil.copy(src / "1.dat", d / "1.dat")
        shutil.copy(src / "1.idx", d / "1.idx")
        dirs[name] = d
    encoder.write_ec_files(
        str(dirs["port"] / "1"), codec=RSCodec(device="cpu"),
        large_block_size=LARGE, small_block_size=SMALL,
    )
    _seal(str(dirs["port"] / "1"))
    ref_encoder.write_ec_files(
        str(dirs["ref"] / "1"), codec=RefCodec(backend="jax"),
        large_block_size=LARGE, small_block_size=SMALL,
    )
    ref_encoder.write_sorted_file_from_idx(str(dirs["ref"] / "1"))
    ref_encoder.save_volume_info(str(dirs["ref"] / "1.vif"), version=3)
    return dict(root=root, needles=needles, **dirs)


def _copy_sealed(src, dst, skip=()):
    dst.mkdir()
    for f in os.listdir(src):
        if f.endswith(".dat") or any(f.endswith(geometry.to_ext(s)) for s in skip):
            continue
        shutil.copy(src / f, dst / f)
    return str(dst / "1")


@pytest.mark.parametrize("shard", range(14))
def test_encode_shard_identical(vol, shard):
    ext = geometry.to_ext(shard)
    port = (vol["port"] / f"1{ext}").read_bytes()
    assert port == (vol["ref"] / f"1{ext}").read_bytes()
    dat_size = os.path.getsize(vol["port"] / "1.dat")
    assert len(port) == geometry.shard_file_size(dat_size, LARGE, SMALL)


def test_ecx_identical(vol):
    assert (vol["port"] / "1.ecx").read_bytes() == (vol["ref"] / "1.ecx").read_bytes()


def test_rebuild_identical(vol, tmp_path):
    base = _copy_sealed(vol["port"], tmp_path / "port", skip=REBUILD_LOST)
    ref_base = _copy_sealed(vol["port"], tmp_path / "ref", skip=REBUILD_LOST)
    rebuilt = encoder.rebuild_ec_files(base, codec=RSCodec(device="cpu"), chunk=777)
    assert rebuilt == list(REBUILD_LOST)
    assert ref_encoder.rebuild_ec_files(ref_base, codec=RefCodec(backend="jax")) == rebuilt
    for s in REBUILD_LOST:
        ext = geometry.to_ext(s)
        got = (tmp_path / "port" / f"1{ext}").read_bytes()
        assert got == (vol["port"] / f"1{ext}").read_bytes()
        assert got == (tmp_path / "ref" / f"1{ext}").read_bytes()
    assert encoder.rebuild_ec_files(base, codec=RSCodec(device="cpu")) == []


def test_rebuild_needs_ten(vol, tmp_path):
    base = _copy_sealed(vol["port"], tmp_path / "few", skip=(0, 1, 2, 3, 4))
    with pytest.raises(ValueError):
        encoder.rebuild_ec_files(base, codec=RSCodec(device="cpu"))


def test_degraded_read_every_needle(vol, tmp_path):
    d = tmp_path / "degraded"
    _copy_sealed(vol["port"], d, skip=DEGRADED_LOST)
    ev = EcVolume(str(d), "", 1, codec=RSCodec(device="cpu"),
                  large_block_size=LARGE, small_block_size=SMALL)
    ref = RefEcVolume(str(d), "", 1, codec=RefCodec(backend="numpy"),
                      large_block_size=LARGE, small_block_size=SMALL)
    try:
        assert ev.shard_ids() == [s for s in range(14) if s not in DEGRADED_LOST]
        for nid, (cookie, data) in vol["needles"].items():
            n = ev.read_needle(nid, cookie=cookie)
            assert n.data == data
            assert n.checksum == crc.crc32c(data)
            r = ref.read_needle(nid, cookie=cookie)
            assert (n.data, n.name, n.append_at_ns) == (r.data, r.name, r.append_at_ns)
        with pytest.raises(NeedleNotFound):
            ev.read_needle(10**12)
        nid, (cookie, _) = next(iter(vol["needles"].items()))
        with pytest.raises(NeedleNotFound):
            ev.read_needle(nid, cookie=cookie ^ 1)
    finally:
        ev.close()
        ref.close()


def test_decode_identical(vol, tmp_path):
    base = str(vol["port"] / "1")
    size = decoder.find_dat_file_size(base, base)
    assert size == ref_decoder.find_dat_file_size(base, base)
    assert size == os.path.getsize(base + ".dat")
    shards = [base + geometry.to_ext(i) for i in range(10)]
    out = str(tmp_path / "port")
    ref_out = str(tmp_path / "ref")
    decoder.write_dat_file(out, size, shards, LARGE, SMALL)
    ref_decoder.write_dat_file(ref_out, size, shards, LARGE, SMALL)
    dat = (vol["port"] / "1.dat").read_bytes()
    assert open(out + ".dat", "rb").read() == dat
    assert open(ref_out + ".dat", "rb").read() == dat


def test_idx_from_ec_index(vol, tmp_path):
    for name, mod in (("port", decoder), ("ref", ref_decoder)):
        d = tmp_path / name
        d.mkdir()
        shutil.copy(vol["port"] / "1.ecx", d / "1.ecx")
        (d / "1.ecj").write_bytes((123).to_bytes(8, "big"))
        mod.write_idx_file_from_ec_index(str(d / "1"))
    assert (tmp_path / "port" / "1.idx").read_bytes() == (tmp_path / "ref" / "1.idx").read_bytes()


def test_column_split_path_identical(vol, tmp_path):
    """large > batch: the "cols" jobs of the schedule."""
    outs = []
    for name, enc, codec in (
        ("port", encoder, RSCodec(device="cpu")),
        ("ref", ref_encoder, RefCodec(backend="numpy")),
    ):
        d = tmp_path / name
        d.mkdir()
        shutil.copy(vol["port"] / "1.dat", d / "1.dat")
        enc.write_ec_files(str(d / "1"), codec=codec, large_block_size=50_000,
                           small_block_size=1000, batch=7000)
        outs.append([(d / f"1{geometry.to_ext(i)}").read_bytes() for i in range(14)])
    assert outs[0] == outs[1]


@pytest.mark.parametrize(
    "total,large,small,batch",
    [(2_000_000, LARGE, SMALL, 1 << 20), (2_000_000, LARGE, SMALL, 7 * 1024),
     (1_234_567, 50_000, 1000, 7000), (10, 64, 8, 16), (0, 64, 8, 16)],
)
def test_schedule_equals_reference(total, large, small, batch):
    assert list(encoder._schedule(total, large, small, batch)) == list(
        ref_encoder._schedule(total, large, small, batch)
    )


def test_locate_data_equals_reference():
    rng = np.random.RandomState(7)
    for _ in range(200):
        dat = int(rng.randint(1, 3_000_000))
        off = int(rng.randint(0, dat))
        size = int(rng.randint(1, 100_000))
        got = geometry.locate_data(LARGE, SMALL, dat, off, size)
        want = ref_geometry.locate_data(LARGE, SMALL, dat, off, size)
        assert [vars(i) for i in got] == [vars(i) for i in want]
        assert geometry.shard_file_size(dat, LARGE, SMALL) == ref_geometry.shard_file_size(dat, LARGE, SMALL)


def test_partial_sums_equal_reconstruct():
    rng = np.random.RandomState(3)
    codec = RSCodec(device="cpu")
    full = codec.encode_all(rng.randint(0, 256, (10, 999)).astype(np.uint8))
    present = [s for s in range(14) if s not in (0, 6)]
    use, m = decoder.repair_coefficients(present, [0, 6])
    ref_use, ref_m = ref_decoder.repair_coefficients(present, [0, 6])
    assert use == ref_use and np.array_equal(m, ref_m)
    acc = None
    for part in (use[:3], use[3:7], use[7:]):
        cols = [use.index(s) for s in part]
        acc = decoder.xor_partials(
            acc, decoder.partial_contribution(m[:, cols], full[part], codec=codec)
        )
    assert np.array_equal(acc, full[[0, 6]])
