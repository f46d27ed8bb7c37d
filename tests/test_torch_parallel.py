"""The port's multi-device split held against the JAX package's shard_maps.

The JAX side runs over its 8-device virtual CPU mesh (conftest forces
`xla_force_host_platform_device_count=8`); the port's over a mesh of 8 CPU
slots (`make_mesh(8, device="cpu")`), each slot running the kernels'
plain versions on its slice. Seeds and shapes are
`tests/test_parallel.py`'s. Parity, CRCs and digests must be byte-equal
(no tolerance), and each of the 8 shards must hold 1/8 of the rows.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from seaweedfs_tpu import parallel as ref
from seaweedfs_tpu.ops.rs_kernel import RSCodec as RefCodec
from seaweedfs_tpu_torch import entry as port_entry
from seaweedfs_tpu_torch.parallel import (
    make_mesh,
    pipeline_step,
    sharded_crc32c,
    sharded_encode,
    sharded_md5,
)
from seaweedfs_tpu_torch.storage import crc as crc_port
from tests._threads import stop_history_loops  # noqa: F401

D = 8


@pytest.fixture(scope="module")
def ref_mesh():
    import jax

    if len(jax.devices()) < D:
        pytest.skip("needs 8 virtual devices")
    return ref.make_mesh(D)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(D, device="cpu")


def _rand(seed: int, shape) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, size=shape).astype(np.uint8)


def _check_split(result, rows: int) -> None:
    assert len(result.shards) == D and len(set(result.devices)) == D
    assert [s.shape[0] for s in result.shards] == [rows // D] * D
    assert result.shape[0] == rows


@pytest.mark.parametrize("seed,shape", [(0, (16, 10, 512)), (1, (8, 10, 256))])
def test_sharded_encode_equals_reference(ref_mesh, mesh, seed, shape):
    volumes = _rand(seed, shape)
    got = sharded_encode(mesh, volumes)
    want = np.asarray(ref.sharded_encode(ref_mesh, volumes))
    _check_split(got, shape[0])
    assert got.shape == want.shape == (shape[0], 4, shape[2])
    assert np.array_equal(np.asarray(got), want)
    codec = RefCodec(backend="numpy")
    for v in range(shape[0]):
        assert np.array_equal(np.asarray(got)[v], codec.encode(volumes[v])), f"volume {v}"


@pytest.mark.parametrize("seed,shape", [(2, (32, 1024)), (3, (16, 512))])
def test_sharded_hashes_equal_reference(ref_mesh, mesh, seed, shape):
    blobs = _rand(seed, shape)
    crcs = sharded_crc32c(mesh, blobs)
    digests = sharded_md5(mesh, blobs)
    _check_split(crcs, shape[0])
    _check_split(digests, shape[0])
    assert np.array_equal(np.asarray(crcs), np.asarray(ref.sharded_crc32c(ref_mesh, blobs)))
    assert np.array_equal(np.asarray(digests), np.asarray(ref.sharded_md5(ref_mesh, blobs)))
    for i in range(shape[0]):
        blob = blobs[i].tobytes()
        assert int(np.asarray(crcs)[i]) == crc_port.crc32c(blob)
        assert np.asarray(digests)[i].tobytes() == hashlib.md5(blob).digest()


def test_pipeline_step_equals_reference(ref_mesh, mesh):
    rng = np.random.RandomState(3)
    volumes = rng.randint(0, 256, size=(8, 10, 256)).astype(np.uint8)
    blobs = rng.randint(0, 256, size=(16, 512)).astype(np.uint8)
    parity, crcs, digests = pipeline_step(mesh, volumes, blobs)
    r_parity, r_crcs, r_digests = ref.pipeline_step(ref_mesh, volumes, blobs)
    assert parity.shape == (8, 4, 256) and crcs.shape == (16,) and digests.shape == (16, 16)
    assert np.array_equal(np.asarray(parity), np.asarray(r_parity))
    assert np.array_equal(np.asarray(crcs), np.asarray(r_crcs))
    assert np.array_equal(np.asarray(digests), np.asarray(r_digests))


def test_tensor_input_and_smaller_mesh():
    """A uint8 tensor splits as numpy does, over any mesh size."""
    volumes = _rand(4, (6, 10, 100))
    got = sharded_encode(make_mesh(3, device="cpu"), torch.from_numpy(volumes))
    assert [s.shape for s in got.shards] == [(2, 4, 100)] * 3
    want = np.stack([RefCodec(backend="numpy").encode(v) for v in volumes])
    assert np.array_equal(np.asarray(got), want)


@pytest.mark.parametrize("fn,shape", [
    (sharded_encode, (12, 10, 64)),
    (sharded_crc32c, (20, 64)),
    (sharded_md5, (9, 64)),
])
def test_indivisible_first_dimension_raises(ref_mesh, mesh, fn, shape):
    x = _rand(5, shape)
    with pytest.raises(ValueError):
        fn(mesh, x)
    ref_fn = getattr(ref, fn.__name__)
    with pytest.raises(ValueError):
        ref_fn(ref_mesh, x)


def test_make_mesh_sizes(monkeypatch):
    assert make_mesh(device="cpu").size == 1
    assert make_mesh(5, device="cpu").axis == "dp"
    # a cuda mesh never stands CPU slots in for missing cards
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: D)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError) as port_err:
        make_mesh(D + 1)
    with pytest.raises(ValueError) as ref_err:
        ref.make_mesh(D + 1)
    assert str(port_err.value) == str(ref_err.value)
    assert [str(d) for d in make_mesh().devices] == [f"cuda:{i}" for i in range(D)]


def test_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        make_mesh()
    with pytest.raises(RuntimeError):
        make_mesh(2, device="cuda")
    with pytest.raises(RuntimeError):
        port_entry.dryrun_multichip(2)


def test_dryrun_multichip_on_cpu_slots(capsys):
    port_entry.dryrun_multichip(D, device="cpu")
    out = capsys.readouterr().out
    assert f"dryrun_multichip({D}): parity (16, 4, 512) over {D} devices" in out
    assert out.rstrip().endswith("OK")
