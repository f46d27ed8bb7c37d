"""The port's storage formats against the JAX package's, on the CPU: CRC32C,
needle records, superblock, .idx entries, and the volume append path."""

import numpy as np
import pytest

from seaweedfs_tpu.storage import crc as ref_crc
from seaweedfs_tpu.storage import idx as ref_idx
from seaweedfs_tpu.storage import needle as ref_needle
from seaweedfs_tpu.storage.super_block import SuperBlock as RefSuperBlock
from seaweedfs_tpu.storage.types import TTL as RefTTL
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu_torch.storage import crc, idx, needle
from seaweedfs_tpu_torch.storage.super_block import SuperBlock
from seaweedfs_tpu_torch.storage.types import TTL, ReplicaPlacement
from seaweedfs_tpu_torch.storage.volume import Volume


def _needle_fields(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    n = int(rng.choice([0, 1, 7, 100, 4096, 70000]))
    fields = dict(
        cookie=int(rng.randint(0, 2**32, dtype=np.uint64)),
        id=int(rng.randint(1, 2**62, dtype=np.uint64)),
        data=rng.bytes(n),
        append_at_ns=int(rng.randint(1, 2**62, dtype=np.uint64)),
    )
    flags = 0
    if seed % 2:
        fields["name"] = b"file-%d.bin" % seed
        flags |= needle.FLAG_HAS_NAME
    if seed % 3:
        fields["mime"] = b"application/octet-stream"
        flags |= needle.FLAG_HAS_MIME
    if seed % 4:
        fields["last_modified"] = 1_700_000_000 + seed
        flags |= needle.FLAG_HAS_LAST_MODIFIED
    if seed % 5 == 0:
        flags |= needle.FLAG_HAS_TTL
    if seed % 6 == 0:
        fields["pairs"] = b'{"Seaweed-k":"v%d"}' % seed
        flags |= needle.FLAG_HAS_PAIRS
    fields["flags"] = flags
    return fields


def _pair(seed: int):
    f = _needle_fields(seed)
    port = needle.Needle(**f, ttl=TTL.parse("3d") if seed % 5 == 0 else TTL())
    ref = ref_needle.Needle(**f, ttl=RefTTL.parse("3d") if seed % 5 == 0 else RefTTL())
    return port, ref


class TestCRC:
    @pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 4095, 65537, 1 << 20])
    def test_crc32c_equals_reference(self, n):
        data = np.random.RandomState(n).bytes(n)
        assert crc.crc32c(data) == ref_crc.crc32c(data)

    @pytest.mark.parametrize("n", [0, 1, 5, 8, 17, 300])
    def test_library_equals_plain_tables(self, n):
        data = np.random.RandomState(n + 1).bytes(n)
        assert crc.crc32c(data) == crc.update_numpy(0, data)

    def test_streaming_and_buffer_types(self):
        data = np.random.RandomState(2).bytes(10_000)
        whole = crc.crc32c(data)
        assert crc.update(crc.update(0, data[:3333]), data[3333:]) == whole
        arr = np.frombuffer(data, dtype=np.uint8)
        assert crc.crc32c(arr) == whole
        assert crc.crc32c(memoryview(data)) == whole
        assert crc.crc32c(bytearray(data)) == whole

    def test_legacy_value(self):
        for v in (0, 1, 0xDEADBEEF, 0xFFFFFFFF):
            assert crc.legacy_value(v) == ref_crc.legacy_value(v)


class TestNeedle:
    @pytest.mark.parametrize("version", [1, 2, 3])
    @pytest.mark.parametrize("seed", range(8))
    def test_to_bytes_equals_reference(self, seed, version):
        port, ref = _pair(seed)
        blob = port.to_bytes(version)
        assert blob == ref.to_bytes(version)
        assert port.size == ref.size and port.checksum == ref.checksum
        back = needle.Needle.from_bytes(blob, size=port.size, version=version)
        ref_back = ref_needle.Needle.from_bytes(blob, size=ref.size, version=version)
        for attr in ("cookie", "id", "size", "data", "flags", "name", "mime",
                     "pairs", "last_modified", "checksum", "append_at_ns"):
            assert getattr(back, attr) == getattr(ref_back, attr), attr

    def test_crc_mismatch_and_legacy_crc(self):
        port, _ = _pair(1)
        blob = bytearray(port.to_bytes(3))
        crc_off = needle.NEEDLE_HEADER_SIZE + port.size
        legacy = crc.legacy_value(port.checksum)
        blob[crc_off:crc_off + 4] = legacy.to_bytes(4, "big")
        assert needle.Needle.from_bytes(bytes(blob), version=3).data == port.data
        blob[crc_off] ^= 0xFF
        with pytest.raises(needle.CRCError):
            needle.Needle.from_bytes(bytes(blob), version=3)
        with pytest.raises(needle.SizeMismatchError):
            needle.Needle.from_bytes(bytes(blob), size=port.size + 1, version=3)

    @pytest.mark.parametrize("version", [1, 2, 3])
    def test_sizes_and_padding(self, version):
        for size in range(0, 200):
            assert needle.padding_length(size, version) == ref_needle.padding_length(size, version)
            assert needle.get_actual_size(size, version) == ref_needle.get_actual_size(size, version)


class TestFormats:
    def test_super_block(self):
        sb = SuperBlock(version=3, replica_placement=ReplicaPlacement.parse("012"),
                        ttl=TTL.parse("5h"), compaction_revision=7, extra=b"xyz")
        ref = RefSuperBlock.from_bytes(sb.to_bytes())
        assert ref.to_bytes() == sb.to_bytes()
        assert SuperBlock.from_bytes(ref.to_bytes()) == sb

    def test_idx_entries(self):
        rng = np.random.RandomState(4)
        for _ in range(50):
            key = int(rng.randint(0, 2**63, dtype=np.uint64))
            off = int(rng.randint(0, 2**31)) * 8
            size = int(rng.randint(-1, 2**31))
            b = idx.entry_to_bytes(key, off, size)
            assert b == ref_idx.entry_to_bytes(key, off, size)
            assert idx.entry_from_bytes(b) == ref_idx.entry_from_bytes(b) == (key, off, size)


class TestVolumeAppend:
    def test_port_volume_opens_in_reference(self, tmp_path):
        written = {}
        with Volume(str(tmp_path), "col", 7) as v:
            for seed in range(12):
                port, _ = _pair(seed)
                if not port.data or port.has_ttl():  # a TTL from 2023 has expired
                    continue
                off, size = v.write_needle(port)
                assert off % 8 == 0
                written[port.id] = (off, size, port.data)
            assert v.size() == (tmp_path / "col_7.dat").stat().st_size
        entries = list(ref_idx.walk_index_file(str(tmp_path / "col_7.idx")))
        assert [(k, o, s) for k, o, s in entries] == [
            (k, o, s) for k, (o, s, _) in written.items()
        ]
        ref = RefVolume(str(tmp_path), "col", 7)
        try:
            for key, (_, _, data) in written.items():
                assert ref.read_needle(key).data == data
        finally:
            ref.close()

    def test_reopen_appends(self, tmp_path):
        port, _ = _pair(3)
        with Volume(str(tmp_path), "", 1, ttl=TTL.parse("2d")) as v:
            off1, _ = v.write_needle(port)
        with Volume(str(tmp_path), "", 1) as v:
            assert str(v.super_block.ttl) == "2d"
            port2, _ = _pair(5)
            off2, _ = v.write_needle(port2)
        assert off2 > off1
        assert len(list(ref_idx.walk_index_file(str(tmp_path / "1.idx")))) == 2
