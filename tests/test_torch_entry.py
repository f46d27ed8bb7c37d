"""The port's entry point against the JAX package's, and the port's hygiene:
no JAX or seaweedfs_tpu import, and no quiet CPU run without CUDA."""

import ast
import pathlib
import re

import numpy as np
import pytest
import torch

import __graft_entry__
from seaweedfs_tpu_torch import entry as port_entry
from seaweedfs_tpu_torch.ops import _build
from seaweedfs_tpu_torch.ops.rs_kernel import RSCodec, resolve_device
from seaweedfs_tpu_torch.storage.erasure_coding import decoder, encoder
from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import EcVolume
from tests._threads import stop_history_loops  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "seaweedfs_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "kernel_turns.py", REPO / "s3_stall_probe.py",
    REPO / "metering_cost.py", REPO / "gc_pauses.py", REPO / "depth_turns.py"]


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


CSRC_FILES = sorted(p for p in (REPO / "seaweedfs_tpu_torch" / "csrc").rglob("*")
                    if p.is_file())


@pytest.mark.parametrize("path", PORT_FILES + CSRC_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_reference_native_path(path):
    """No port module or source reads or names the JAX package's native
    sources: the port builds its own copies."""
    assert "seaweedfs_tpu/native" not in path.read_text(errors="replace")


def test_loaded_build_sources_live_in_csrc():
    """Every library a port module loads through `_build` is one of its
    SOURCES, built from files under seaweedfs_tpu_torch/csrc/ alone."""
    csrc = (REPO / "seaweedfs_tpu_torch" / "csrc").resolve()
    assert _build.CSRC_DIR.resolve() == csrc
    named = set()
    for path in PORT_FILES:
        named.update(re.findall(r"_build\.([A-Z][A-Z0-9_]+)\b", path.read_text()))
    loaded = {n for n in named if isinstance(getattr(_build, n), _build.Source)}
    assert {"FASTLANE", "LOADGEN", "CRC32C_HOST"} <= loaded
    for name in loaded:
        assert getattr(_build, name) in _build.SOURCES, name
    for src in _build.SOURCES:
        for f in src.files:
            path = (_build.CSRC_DIR / f).resolve()
            assert path.is_file() and path.parent == csrc, (src.name, f)


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


NEW_IN_FILER_SLICE = [
    "seaweedfs_tpu_torch/cluster/__init__.py",
    "seaweedfs_tpu_torch/filer/kvstore.py",
    "seaweedfs_tpu_torch/filer/lsm.py",
    "seaweedfs_tpu_torch/filer/etcd.py",
    "seaweedfs_tpu_torch/filer/stores_gated.py",
    "seaweedfs_tpu_torch/filer/filer_client.py",
    "seaweedfs_tpu_torch/filer/meta_aggregator.py",
    "seaweedfs_tpu_torch/shell/commands_fs.py",
]


@pytest.mark.parametrize("rel", NEW_IN_FILER_SLICE)
def test_filer_slice_modules_are_scanned_and_import_alone(rel):
    """Each module of the filer slice is in the import scan above and
    imports with neither `jax` nor `seaweedfs_tpu` loaded by it."""
    import importlib
    import subprocess
    import sys

    assert REPO / rel in PORT_FILES
    mod = rel[:-3].replace("/", ".").removesuffix(".__init__")
    code = (f"import sys, importlib; importlib.import_module({mod!r}); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'seaweedfs_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    importlib.import_module(mod)


NEW_IN_VOLUME_SLICE = [
    "seaweedfs_tpu_torch/command/__init__.py",
    "seaweedfs_tpu_torch/command/fix.py",
    "seaweedfs_tpu_torch/command/volume_tools.py",
    "seaweedfs_tpu_torch/query/__init__.py",
    "seaweedfs_tpu_torch/storage/backend.py",
    "seaweedfs_tpu_torch/storage/types.py",
    "seaweedfs_tpu_torch/storage/needle_map.py",
    "seaweedfs_tpu_torch/storage/volume.py",
    "seaweedfs_tpu_torch/util/faults.py",
]


@pytest.mark.parametrize("rel", NEW_IN_VOLUME_SLICE)
def test_volume_slice_modules_are_scanned(rel):
    """Each new or rewritten module of the volume slice is in the import
    scan above and imports here."""
    import importlib

    assert REPO / rel in PORT_FILES
    assert not [n for n in _imports(REPO / rel)
                if n.split(".")[0] in ("jax", "jaxlib", "seaweedfs_tpu")]
    importlib.import_module(rel[:-3].replace("/", ".").removesuffix(".__init__"))


def test_volume_slice_modules_import_alone():
    """The volume slice's modules together import with neither `jax` nor
    `seaweedfs_tpu` loaded by them, at both offset widths."""
    import os
    import subprocess
    import sys

    mods = [rel[:-3].replace("/", ".").removesuffix(".__init__")
            for rel in NEW_IN_VOLUME_SLICE]
    code = (f"import sys, importlib; [importlib.import_module(m) for m in {mods!r}]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'seaweedfs_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    for width in ("4", "5"):
        env = {**os.environ, "SEAWEEDFS_TPU_OFFSET_BYTES": width}
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                             text=True, timeout=120, env=env)
        assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("kind", ["memory", "leveldb", "lsm"])
def test_filer_server_without_device_raises(kind, monkeypatch, tmp_path):
    """The filer and its new routes run on the device they were given; with
    none and no CUDA the server refuses, whatever its store."""
    from seaweedfs_tpu_torch.server.filer import FilerServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / kind) if kind != "memory" else None
    with pytest.raises(RuntimeError):
        FilerServer("http://127.0.0.1:1", store_kind=kind, store_path=path, dedup=True)
    srv = FilerServer("http://127.0.0.1:1", store_kind=kind, store_path=path,
                      dedup=True, device="cpu")
    try:
        assert srv.device.type == "cpu" and srv.dedup_index is not None
    finally:
        srv.filer.close()


NEW_IN_GATEWAYS_SLICE = [
    "seaweedfs_tpu_torch/util/concurrency.py",
    "seaweedfs_tpu_torch/server/webdav.py",
    "seaweedfs_tpu_torch/ftpd/__init__.py",
    "seaweedfs_tpu_torch/mount/__init__.py",
    "seaweedfs_tpu_torch/mount/fuse_proto.py",
    "seaweedfs_tpu_torch/mount/meta_cache.py",
    "seaweedfs_tpu_torch/mount/page_writer.py",
    "seaweedfs_tpu_torch/mount/weedfs.py",
    "seaweedfs_tpu_torch/remote_storage/__init__.py",
    "seaweedfs_tpu_torch/shell/commands_remote.py",
    "seaweedfs_tpu_torch/command/filer_sync.py",
]


@pytest.mark.parametrize("rel", NEW_IN_GATEWAYS_SLICE)
def test_gateways_slice_modules_are_scanned(rel):
    """Each new module of the gateways slice is in the import scan above
    and imports here."""
    import importlib

    assert REPO / rel in PORT_FILES
    assert not [n for n in _imports(REPO / rel)
                if n.split(".")[0] in ("jax", "jaxlib", "seaweedfs_tpu")]
    importlib.import_module(rel[:-3].replace("/", ".").removesuffix(".__init__"))


def test_gateways_slice_modules_import_alone():
    """The gateways slice's modules together import with neither `jax` nor
    `seaweedfs_tpu` loaded by them."""
    import subprocess
    import sys

    mods = [rel[:-3].replace("/", ".").removesuffix(".__init__")
            for rel in NEW_IN_GATEWAYS_SLICE]
    code = (f"import sys, importlib; [importlib.import_module(m) for m in {mods!r}]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'seaweedfs_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_gateways_reach_a_filer_that_raises_without_cuda(monkeypatch, tmp_path):
    """With no CUDA, the filer under every gateway refuses to start unless
    it was built with device="cpu"; built so, WebDAV, FTP, a mount over its
    local socket and its remote routes all reach it."""
    import ftplib
    import json

    from seaweedfs_tpu_torch.ftpd import FtpServer
    from seaweedfs_tpu_torch.mount import WFS, VirtualFuseKernel
    from seaweedfs_tpu_torch.server.filer import FilerServer
    from seaweedfs_tpu_torch.server.httpd import http_request
    from seaweedfs_tpu_torch.server.webdav import WebDavServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sock = str(tmp_path / "filer.sock")
    with pytest.raises(RuntimeError):
        FilerServer("http://127.0.0.1:1", port=0, local_socket=sock)
    filer = FilerServer("http://127.0.0.1:1", port=0, local_socket=sock, device="cpu")
    filer.start()
    dav = WebDavServer(filer.url, port=0)
    ftp = FtpServer(filer.url, port=0, user="u", password="p")
    wfs = None
    try:
        assert filer.device.type == "cpu" and filer.hash_service.device.type == "cpu"
        dav.start()
        ftp.start()
        assert http_request("MKCOL", dav.url + "/g")[0] == 201
        assert http_request("PROPFIND", dav.url + "/g", headers={"Depth": "0"})[0] == 207
        c = ftplib.FTP()
        c.connect("127.0.0.1", ftp.port, timeout=10)
        c.login("u", "p")
        assert c.cwd("/g") == "250 cwd ok"
        c.quit()
        wfs = WFS(filer.service.unix_url)
        err, ino, _ = VirtualFuseKernel(wfs).lookup(1, "g")
        assert err == 0 and ino > 1
        conf = {"name": "c", "conf": {"kind": "local", "root": str(tmp_path / "r")}}
        assert http_request("POST", filer.url + "/__remote__/configure",
                            json.dumps(conf).encode())[0] == 200
        status, _, body = http_request("GET", filer.service.unix_url + "/__remote__/mounts")
        assert status == 200 and json.loads(body)["configs"] == {"c": "local"}
    finally:
        if wfs is not None:
            wfs.meta.stop()
        ftp.stop()
        dav.stop()
        filer.stop()


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
        assert src.compiler == "nvcc" and src.files == (src.name + ".cu",)
        assert (_build.CSRC_DIR / src.files[0]).is_file()
        assert "-gencode" in src.flags
        assert "arch=compute_90a,code=sm_90a" in src.flags


NEW_IN_SYNC_SLICE = [
    "seaweedfs_tpu_torch/notification/__init__.py",
    "seaweedfs_tpu_torch/notification/cloud.py",
    "seaweedfs_tpu_torch/replication/__init__.py",
    "seaweedfs_tpu_torch/replication/cloud_sinks.py",
    "seaweedfs_tpu_torch/mq/__init__.py",
    "seaweedfs_tpu_torch/mq/schema.py",
    "seaweedfs_tpu_torch/mq/broker.py",
    "seaweedfs_tpu_torch/mq/client.py",
    "seaweedfs_tpu_torch/command/filer_sync.py",
    "seaweedfs_tpu_torch/shell/commands_cluster.py",
]


@pytest.mark.parametrize("rel", NEW_IN_SYNC_SLICE)
def test_sync_slice_modules_are_scanned(rel):
    """Each module of the sync and messaging slice is in the import scan
    above and imports here."""
    import importlib

    assert REPO / rel in PORT_FILES
    assert not [n for n in _imports(REPO / rel)
                if n.split(".")[0] in ("jax", "jaxlib", "seaweedfs_tpu")]
    importlib.import_module(rel[:-3].replace("/", ".").removesuffix(".__init__"))


def test_sync_slice_modules_import_alone():
    """The sync and messaging slice's modules together import with neither
    `jax` nor `seaweedfs_tpu` loaded by them, nor `cryptography`, which
    only a GCS token provider loads."""
    import subprocess
    import sys

    mods = [rel[:-3].replace("/", ".").removesuffix(".__init__")
            for rel in NEW_IN_SYNC_SLICE]
    code = (f"import sys, importlib; [importlib.import_module(m) for m in {mods!r}]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'seaweedfs_tpu', 'cryptography')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


NEW_IN_SECURITY_SLICE = [
    "seaweedfs_tpu_torch/security/__init__.py",
    "seaweedfs_tpu_torch/security/config.py",
    "seaweedfs_tpu_torch/security/guard.py",
    "seaweedfs_tpu_torch/security/jwt.py",
    "seaweedfs_tpu_torch/security/tls.py",
    "seaweedfs_tpu_torch/raft/__init__.py",
]


@pytest.mark.parametrize("rel", NEW_IN_SECURITY_SLICE)
def test_security_slice_modules_are_scanned(rel):
    """Each module of `security/` and `raft/` is in the import scan above
    and imports here."""
    import importlib

    assert REPO / rel in PORT_FILES
    assert not [n for n in _imports(REPO / rel)
                if n.split(".")[0] in ("jax", "jaxlib", "seaweedfs_tpu")]
    importlib.import_module(rel[:-3].replace("/", ".").removesuffix(".__init__"))


def test_security_slice_modules_import_alone():
    """`security/`, `raft/` and the servers that use them import with
    neither `jax` nor `seaweedfs_tpu` loaded by them."""
    import subprocess
    import sys

    mods = [rel[:-3].replace("/", ".").removesuffix(".__init__")
            for rel in NEW_IN_SECURITY_SLICE] + [
        "seaweedfs_tpu_torch.server.master", "seaweedfs_tpu_torch.server.volume",
        "seaweedfs_tpu_torch.server.filer", "seaweedfs_tpu_torch.shell"]
    code = (f"import sys, importlib; [importlib.import_module(m) for m in {mods!r}]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'seaweedfs_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


NEW_IN_TELEMETRY_SLICE = [
    "seaweedfs_tpu_torch/stats/usage.py",
    "seaweedfs_tpu_torch/stats/heat.py",
    "seaweedfs_tpu_torch/stats/aggregate.py",
    "seaweedfs_tpu_torch/stats/store.py",
    "seaweedfs_tpu_torch/qos/__init__.py",
    "seaweedfs_tpu_torch/qos/admission.py",
    "seaweedfs_tpu_torch/qos/actuator.py",
]


@pytest.mark.parametrize("rel", NEW_IN_TELEMETRY_SLICE)
def test_telemetry_slice_modules_are_scanned(rel):
    """Each new module of `stats/` and `qos/` is in the import scan above
    and imports here."""
    import importlib

    assert REPO / rel in PORT_FILES
    assert not [n for n in _imports(REPO / rel)
                if n.split(".")[0] in ("jax", "jaxlib", "seaweedfs_tpu")]
    importlib.import_module(rel[:-3].replace("/", ".").removesuffix(".__init__"))


def test_telemetry_slice_modules_import_alone():
    """The usage, heat, telemetry and qos modules, and the roles and shell
    that use them, import with neither `jax` nor `seaweedfs_tpu` loaded by
    them; the spool's CRC is the port's own `storage/crc.py`."""
    import subprocess
    import sys

    mods = [rel[:-3].replace("/", ".").removesuffix(".__init__")
            for rel in NEW_IN_TELEMETRY_SLICE] + [
        "seaweedfs_tpu_torch.server.httpd", "seaweedfs_tpu_torch.server.master",
        "seaweedfs_tpu_torch.server.volume", "seaweedfs_tpu_torch.server.filer",
        "seaweedfs_tpu_torch.server.webdav", "seaweedfs_tpu_torch.s3api.s3_server",
        "seaweedfs_tpu_torch.shell"]
    code = (f"import sys, importlib; [importlib.import_module(m) for m in {mods!r}]; "
            "from seaweedfs_tpu_torch.stats import store; "
            "assert store.crc_mod.__name__ == 'seaweedfs_tpu_torch.storage.crc'; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'seaweedfs_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


NEW_IN_CLI_SLICE = [
    "seaweedfs_tpu_torch/command/main.py",
    "seaweedfs_tpu_torch/command/server_cmds.py",
    "seaweedfs_tpu_torch/command/benchmark.py",
    "seaweedfs_tpu_torch/command/upload.py",
    "seaweedfs_tpu_torch/command/scaffold.py",
    "seaweedfs_tpu_torch/command/version.py",
    "seaweedfs_tpu_torch/util/config.py",
    "seaweedfs_tpu_torch/util/grace.py",
    "seaweedfs_tpu_torch/util/sentry.py",
]


@pytest.mark.parametrize("rel", NEW_IN_CLI_SLICE)
def test_cli_slice_modules_are_scanned(rel):
    """Each module of the CLI slice is in the import scan above and imports
    here."""
    import importlib

    assert REPO / rel in PORT_FILES
    assert not [n for n in _imports(REPO / rel)
                if n.split(".")[0] in ("jax", "jaxlib", "seaweedfs_tpu")]
    importlib.import_module(rel[:-3].replace("/", ".").removesuffix(".__init__"))


def test_cli_verbs_import_alone():
    """Every module a verb of the port's `main.COMMANDS` names, with the
    CLI slice's own, imports with neither `jax` nor `seaweedfs_tpu` loaded
    by it."""
    import subprocess
    import sys

    from seaweedfs_tpu_torch.command.main import COMMANDS

    mods = sorted({m for m, _, _ in COMMANDS.values()} | {
        rel[:-3].replace("/", ".") for rel in NEW_IN_CLI_SLICE})
    assert all(m.startswith("seaweedfs_tpu_torch.") for m in mods)
    code = (f"import sys, importlib; [importlib.import_module(m) for m in {mods!r}]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'seaweedfs_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
