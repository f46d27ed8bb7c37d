"""The port's entry point against the JAX package's, and the port's hygiene:
no JAX or seaweedfs_tpu import, and no quiet CPU run without CUDA."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import __graft_entry__
from seaweedfs_tpu_torch import entry as port_entry
from seaweedfs_tpu_torch.ops import _build
from seaweedfs_tpu_torch.ops.rs_kernel import RSCodec, resolve_device
from seaweedfs_tpu_torch.storage.erasure_coding import decoder, encoder
from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import EcVolume

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "seaweedfs_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "kernel_turns.py"]


def test_entry_equals_reference():
    fn, (example,) = port_entry.entry(device="cpu")
    ref_fn, (ref_example,) = __graft_entry__.entry()
    assert np.array_equal(example.numpy(), ref_example)
    got = fn(example)
    assert got.shape == (4, 256 * 1024) and got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), np.asarray(ref_fn(ref_example)))
    assert np.array_equal(got.numpy(), RSCodec(device="cpu").encode(ref_example))


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "seaweedfs_tpu"), f"{path}: imports {name}"


def test_no_device_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        RSCodec()
    with pytest.raises(RuntimeError):
        RSCodec(device="cuda")
    with pytest.raises(RuntimeError):
        port_entry.entry()
    with pytest.raises(RuntimeError):
        decoder.partial_contribution(np.ones((1, 10), np.uint8), np.zeros((10, 4), np.uint8))
    (tmp_path / "1.dat").write_bytes(b"\0" * 64)
    with pytest.raises(RuntimeError):
        encoder.write_ec_files(str(tmp_path / "1"))
    assert not list(tmp_path.glob("1.ec*"))  # nothing ran on the CPU
    (tmp_path / "1.ecx").write_bytes(b"")
    with pytest.raises(RuntimeError):
        EcVolume(str(tmp_path), "", 1)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_library_names_follow_sources():
    a = _build.library_path(_build.GF256_MATMUL)
    b = _build.library_path(_build.CRC32C_HOST)
    assert a != b and a.parent == b.parent == _build.BUILD_DIR
    assert a == _build.library_path(_build.GF256_MATMUL)
    cuda = (_build.GF256_MATMUL, _build.CRC32C_BATCH, _build.MD5_BATCH, _build.GEAR_HASH)
    assert set(cuda) < set(_build.SOURCES)
    assert len({_build.library_path(s) for s in _build.SOURCES}) == len(_build.SOURCES)
    for src in cuda:
        assert src.compiler == "nvcc" and src.file.endswith(".cu")
        assert (_build.CSRC_DIR / src.file).is_file()
        assert "-gencode" in src.flags
        assert "arch=compute_90a,code=sm_90a" in src.flags
