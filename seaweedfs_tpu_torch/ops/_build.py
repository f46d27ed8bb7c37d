"""Build the port's native sources at first use and load them with ctypes.

Each library is compiled from sources under `seaweedfs_tpu_torch/csrc/`
into a shared library with a plain C interface (no PyTorch headers), named
by a hash of its sources and flags, in `seaweedfs_tpu_torch/build/`
(git-ignored):

  gf256_matmul.cu   nvcc, sm_90a  -> the GF(2^8) shard-matmul CUDA kernel
  crc32c_batch.cu   nvcc, sm_90a  -> CRC32C of N equal-length blobs
  md5_batch.cu      nvcc, sm_90a  -> MD5 of N equal-length blobs
  gear_hash.cu      nvcc, sm_90a  -> gear window hash of every position (CDC)
  crc32c_host.cpp   g++           -> host CRC32C for needle checksums and CDC spans
  fast128.cpp       g++           -> SW128, the dedup index's identity hash
  md5_host.cpp      g++           -> host MD5 of CDC spans (dedup ETags)
  fastlane.cpp      g++           -> the native epoll front door of the volume
    + sha256.cpp                     server and the master (storage/fastlane.py),
    + crc32c_host.cpp                with its HMAC (native JWT checks), needle
    + md5_host.cpp                   CRC and MD5; links -ldl -lpthread (it
                                     dlopens OpenSSL for mTLS)
  loadgen.cpp       g++           -> the native HTTP load generator

`build()` starts every missing compile at once (one compiler process per
source) and waits for all of them; a failed compile raises with the
compiler's output. Builds from several processes at once are safe: each
compiles to a private temporary name and renames it into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"


@dataclass(frozen=True)
class Source:
    name: str
    files: tuple[str, ...]
    compiler: str  # "nvcc" or "g++"
    flags: tuple[str, ...]
    libs: tuple[str, ...] = ()  # link flags, after the sources


_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GF256_MATMUL = Source("gf256_matmul", ("gf256_matmul.cu",), "nvcc", _NVCC_FLAGS)
CRC32C_BATCH = Source("crc32c_batch", ("crc32c_batch.cu",), "nvcc", _NVCC_FLAGS)
MD5_BATCH = Source("md5_batch", ("md5_batch.cu",), "nvcc", _NVCC_FLAGS)
GEAR_HASH = Source("gear_hash", ("gear_hash.cu",), "nvcc", _NVCC_FLAGS)
_HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC") + (
    ("-march=native",) if platform.machine() in ("x86_64", "AMD64") else ()
)
CRC32C_HOST = Source("crc32c_host", ("crc32c_host.cpp",), "g++", _HOST_FLAGS)
FAST128 = Source("fast128", ("fast128.cpp",), "g++", _HOST_FLAGS)
MD5_HOST = Source("md5_host", ("md5_host.cpp",), "g++", _HOST_FLAGS)
FASTLANE = Source(
    "fastlane", ("fastlane.cpp", "sha256.cpp", "crc32c_host.cpp", "md5_host.cpp"),
    "g++", _HOST_FLAGS, libs=("-ldl", "-lpthread"),
)
LOADGEN = Source("loadgen", ("loadgen.cpp",), "g++", _HOST_FLAGS)
SOURCES = (GF256_MATMUL, CRC32C_BATCH, MD5_BATCH, GEAR_HASH, CRC32C_HOST, FAST128, MD5_HOST,
           FASTLANE, LOADGEN)


def _compiler(src: Source) -> str:
    if src.compiler == "nvcc":
        path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    else:
        path = shutil.which(src.compiler)
    if not path or not os.path.exists(path):
        raise RuntimeError(f"{src.compiler} not found: cannot build {src.name}")
    return path


def library_path(src: Source) -> Path:
    h = hashlib.sha256()
    for f in src.files:
        h.update((CSRC_DIR / f).read_bytes())
    h.update("\0".join((src.compiler,) + src.flags + src.libs).encode())
    return BUILD_DIR / f"lib{src.name}-{h.hexdigest()[:16]}.so"


def build(sources=SOURCES) -> dict[str, str]:
    """Compile every source whose library is missing, all at once.
    Returns the compiler output per name (empty dict if nothing was built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for src in sources:
        target = library_path(src)
        if target.exists():
            continue
        tmp = target.with_name(
            f".{target.stem}.{os.getpid()}.{threading.get_ident()}.tmp"
        )
        cmd = [_compiler(src), *src.flags, "-o", str(tmp),
               *(str(CSRC_DIR / f) for f in src.files), *src.libs]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((src, target, tmp, proc))
    logs: dict[str, str] = {}
    failed = []
    for src, target, tmp, proc in running:
        out, _ = proc.communicate()
        logs[src.name] = out
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{src.name} (exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("build failed: " + "\n".join(failed))
    return logs


_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def load(src: Source) -> ctypes.CDLL:
    """The loaded library for `src`, built first if it is missing."""
    with _load_lock:
        lib = _loaded.get(src.name)
        if lib is None:
            build([src])
            lib = ctypes.CDLL(str(library_path(src)))
            _loaded[src.name] = lib
        return lib
