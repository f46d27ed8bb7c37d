#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (seaweedfs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--volume-mib MIB] [--upload-blobs N]
                          [--chunked-mib MIB] [--cdc-uploads N] [--stream-mib MIB]
                          [--dedup-gib GIB] [--online-mib MIB] [--cluster-mib MIB]

Phases, one JSON line each; any failure raises and the exit code is not 0:
  1. device   nvidia-smi name and power limit, torch's device name
  2. build    every native source of the port compiled at once (nvcc, g++);
              the integer operations of one block in md5_batch_kernel's
              SASS (cuobjdump), which the MD5 bound counts, and the
              shared-memory loads of one 16-byte unit of
              gf256_matmul_kernel<4, 10> (160: one a byte for four rows)
  3. kernel   gf256_matmul held byte for byte against its plain PyTorch
              version on the card (parity, decode and random matrices up to
              14x14, every row count at 10 columns, ragged and unaligned
              lengths, the 32 MiB pipeline batch), against the numpy oracle
              on a 64 KiB slice, and timed by device time at the EC path's
              shapes (encode (32, 10, 1 MiB), rebuild (10, 32 MiB), degraded
              reads (10, 64 KiB) and (10, 1 MiB)) beside its bound, and
              again on zero bytes (no bank conflicts)
     hash_kernels  crc32c_batch, md5_batch and gear_hash held word for word
              against their plain versions on the card (lengths 0-65536,
              n = 1 to 8193, strided row views; gear over 1 B to 64 MiB),
              MD5 against hashlib at 1 MiB + 17, 4 MiB and an unaligned
              4 MiB + 3 view, a sample against hashlib, the host CRC and
              the numpy gear oracle; each timed at its paths' shapes
              (16 x 4 KiB, 8192 x 4 KiB, 256 x 4 MiB; gear 64 MiB) by device
              time (a CUDA graph of 20 or more launches replayed between events),
              beside one call's event time, its bound and, for MD5, its
              dependent chain
  4. main     the EC main path on a volume of --volume-mib (1 GiB) written
              from --seed, at the reference geometry: write_ec_files, parity
              spot checks, rebuild of shards {2,5,11,13}, 256 degraded
              read_needle calls with data shards {1,4,7,9} missing, rebuild
              of those, write_dat_file back to a byte-identical .dat
     profile  a warm re-encode of that volume, then one under torch.profiler:
              device time of kernel and copies, the device's idle share
  5. cols     a small volume at 1 MiB / 64 KiB blocks through the schedule's
              column-split jobs, byte-identical to a CPU plain encode
  6. upload   --upload-blobs (1,048,576) seeded 4096-byte blobs submitted to
              HashService(device=cuda) from 16 threads, each waiting for its
              blob's result before the next, as the filer does (BASELINE.md
              config 3); every MD5 and CRC equal to hashlib and the host CRC
     chunked  one --chunked-mib (1 GiB) + 12,345-byte upload cut into the
              filer's 4 MiB chunks through submit_many; ETags equal hashlib;
              the full chunks on the card through both kernels, CRC equal to
              its plain version, MD5 to hashlib
  7. cdc      find_boundaries at the filer's dedup settings over
              --cdc-uploads (64) seeded 64 MiB uploads, and chunk_stream at
              its defaults over --stream-mib (1 GiB); cuts equal the plain
              version's on the card, the first upload's the numpy oracle's
  8. dedup    the filer's CDC dedup write path (BASELINE config 4):
              --dedup-gib (8) GiB of 64 MiB uploads, four seeded segments
              alternating with byte-shifted repeats (bench.py's stream),
              through FilerServer._upload_chunks_cdc on the card over a
              Filer(MemoryStore()); wall and p75-window GB/s, dedup shares,
              the time split per upload, gear_hash launches, peak device
              bytes, a profiled window's device idle share; SW128 goldens,
              cuts against the plain CPU cut rule, every miss's ETag against
              hashlib, sampled span keys against SW128 alone, exact repeats
              fully deduped, shifted repeats at 90 % of their bytes or more
  9. online   the volume server's online-EC path (BASELINE config 1's volume
              at 1 GiB): a port VolumeServer on the card with no master,
              one ecOnline volume at the default 1 MiB block, --online-mib
              (1024) MiB of seeded needles (log-uniform 1 KiB to 4 MiB)
              POSTed from 4 threads, each write pumping the stripe writer
              through gf256_matmul, the pulse flushing the aged tail row;
              256 sampled GETs equal; /admin/ec/shard of shards 12 and 0 on
              the open volume equal to the files; every parity row on disk
              equal to the plain version on the card over the .dat's rows;
              /admin/ec/generate answering "online": true with at most the
              tail row encoded; the source volume dropped, data shards 0-3
              lost and 256 needles lying on them read degraded through
              /admin/ec/mount; /admin/ec/rebuild's shards equal to the lost
              ones; no pathological fallback; ingest and encode GB/s, write
              amplification, seal ms, degraded p50/p99, rebuild GB/s, the
              phase's launches and the kernel at a drain tick's (1, 10, 1 MiB)
 10. cluster  BASELINE configs 1 and 2 as shell verbs over a port cluster: one
              MasterServer and four VolumeServers on the card (racks r1-r4,
              pulse 1 s, one process); --cluster-mib (1024) MiB of seeded
              needles (log-uniform 1 KiB to 4 MiB) through /dir/assign and
              POSTs from 4 threads into the 7 volumes the master grows; lock,
              ec.encode -collection ec (14 shards a volume spread 4/4/3/3, no
              replica left, every parity row equal to the plain version on the
              card over the saved .dat); 256 sampled GETs at the assigned urls
              (mostly remote shard reads); one server's shards of every volume
              deleted and 256 GETs of needles on them read degraded from the
              others (remote fan-in, reconstruct on the card); ec.rebuild of
              each volume, its shards equal to the lost ones; ec.decode of each,
              its .dat equal to the copy taken before the encode, 256 needles
              read back at /dir/lookup's location; ingest GB/s, ec.encode wall
              and GB/s split by admin route, remote and degraded p50/p99,
              ec.rebuild wall and GB/s, ec.decode wall, the phase's launches
 11. entry    entry() on the card equal to the CPU codec
Then the {"kernels": [...]} line, the card's name and power limit, and the
last line {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when CUDA is not available.
"""

from __future__ import annotations

import argparse
import hashlib
import http.client
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from seaweedfs_tpu_torch import native
from seaweedfs_tpu_torch.entry import entry
from seaweedfs_tpu_torch.filer import Filer
from seaweedfs_tpu_torch.filer.filerstore import MemoryStore
from seaweedfs_tpu_torch.ops import _build, cdc, gf256
from seaweedfs_tpu_torch.ops.crc32c_kernel import crc32c_batch_kernel, crc32c_batch_torch
from seaweedfs_tpu_torch.ops.hash_service import HashService
from seaweedfs_tpu_torch.ops.md5_kernel import _pad_len, md5_batch_kernel, md5_batch_torch
from seaweedfs_tpu_torch.ops.rs_cuda import gf256_matmul, gf_matmul_torch
from seaweedfs_tpu_torch.ops.rs_kernel import RSCodec
from seaweedfs_tpu_torch.server.filer import FilerServer
from seaweedfs_tpu_torch.server.httpd import http_request
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.shell import CommandEnv, run_command
from seaweedfs_tpu_torch.storage import crc, file_id
from seaweedfs_tpu_torch.storage.erasure_coding import decoder, encoder, geometry
from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import EcVolume
from seaweedfs_tpu_torch.storage.erasure_coding.online import PATHOLOGICAL_REASONS
from seaweedfs_tpu_torch.storage.needle import Needle, get_actual_size
from seaweedfs_tpu_torch.storage.volume import Volume

REPO = Path(__file__).resolve().parent
MIB = 1024 * 1024
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM scalar float32 peak, the table's non-tensor rate
# H100 SXM 32-bit integer peak: 64 operations per clock per SM (CUDA C++
# programming guide, arithmetic throughput, compute capability 9.0) x 132
# SMs x 1.98 GHz boost clock, at the 700 W limit
INT32_OPS_PER_S = 64 * 132 * 1.98e9
TABLE_OPS_PER_BYTE = 3  # a table CRC or gear step: lookup, shift, XOR
REBUILD_LOST = (2, 5, 11, 13)
DEGRADED_LOST = (1, 4, 7, 9)
DEGRADED_READS = 256
# gf256_matmul's shapes on the EC path (encoder.py, ec_volume.py): (path,
# x); encode reads the (row_count, 10, block) .dat layout in place
GF_SHAPES = (
    ("encode", (32, 10, MIB)),
    ("rebuild", (10, 32 * MIB)),
    ("degraded", (10, 64 * 1024)),
    ("degraded", (10, MIB)),
)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


# not arithmetic: memory, branches, barriers, special registers, the uniform datapath
_NOT_COUNTED = ("LD", "ST", "BRA", "EXIT", "NOP", "U", "S2", "CS2", "BAR", "BSSY", "BSYNC",
                "DEPBAR", "WARPSYNC", "MEMBAR")
_MOVES = ("MOV", "IMAD.MOV")  # register copies (IMAD.MOV is a move on the integer pipe)
# one 64-byte MD5 block: 64 rounds of about 4 integer instructions, the
# state update and the loop (273 on sm_90a)
MD5_BLOCK_OPS = (200, 400)
# one 16-byte unit of gf256_matmul_kernel<4, 10> (RS(10,4) parity and the
# 4-shard rebuild): ceil(4 / 4) packed lookups per input byte, 10 columns
# x 16 bytes
GF_UNIT_INSTANCE = "gf256_matmul_kernelILi4ELi10EE"
GF_UNIT_LDS = 1 * 10 * 16


def sass_loop_ops(src: _build.Source, kernel: str, pick: str = "first") -> dict:
    """Instructions per iteration of one loop of one kernel, read from the
    SASS of its built library (cuobjdump): from the target of a backward
    branch to that branch, along the path that takes every forward branch
    inside it. `pick` chooses the loop: "first", the first backward branch
    (for md5_batch_kernel, the aligned path, one 64-byte block read from the
    shared-memory ring; its byte path is md5_batch_bytes_kernel), or
    "most_lds", the loop with the most shared-memory loads, the innermost of
    equals (for gf256_matmul_kernel, one 16-byte unit, not the table
    staging). `ops` counts arithmetic: memory, branch, barrier,
    special-register, uniform-datapath, move and NOP instructions are not
    counted; `lds` counts the shared-memory loads."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.library_path(src))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    insts = {}  # address -> (opcode, branch target or None), first listing only
    inside = False
    for ln in sass.splitlines():
        if "Function :" in ln:
            if insts:
                break
            inside = kernel in ln
            continue
        s = ln.strip()
        if not inside or not s.startswith("/*") or "*/" not in s:
            continue
        addr, rest = s[2:].split("*/", 1)
        words = rest.split(";")[0].split()
        if not words or words[0].startswith("/*"):
            continue  # an encoding line
        if words[0].startswith("@"):  # a predicate
            words = words[1:]
        op = words[0].split(".")[0]
        target = int(words[1], 16) if op == "BRA" and words[1:2] and words[1].startswith("0x") else None
        insts[int(addr, 16)] = (op, words[0], target)
    addrs = sorted(insts)
    nxt = dict(zip(addrs, addrs[1:] + [None]))

    def walk(start: int, end: int) -> dict:
        hist = {}
        pc = start
        while pc is not None and pc < end:
            op, full, target = insts[pc]
            if op == "BRA" and target is not None and pc < target <= end:
                pc = target
                continue
            key = op if op == "LDS" or not (op.startswith(_NOT_COUNTED) or full.startswith(_MOVES)) else None
            if key:
                hist[key] = hist.get(key, 0) + 1
            pc = nxt[pc]
        return hist

    loops = [(insts[a][2], a) for a in addrs if insts[a][2] is not None and insts[a][2] < a]
    check(bool(loops), f"no loop found in the SASS of {kernel}")
    walked = [(start, end, walk(start, end)) for start, end in loops]
    if pick == "first":
        start, end, hist = walked[0]
    else:
        start, end, hist = max(walked, key=lambda w: (w[2].get("LDS", 0), w[0] - w[1]))
    lds = hist.pop("LDS", 0)
    return {"ops": sum(hist.values()), "lds": lds,
            "opcodes": dict(sorted(hist.items(), key=lambda kv: -kv[1])),
            "loop": [hex(start), hex(end)]}


def same_file(a: str, b: str, chunk: int = 64 * MIB) -> bool:
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(chunk), fb.read(chunk)
            if x != y:
                return False
            if not x:
                return True


def bound_ms(rows: int, cols: int, columns: int) -> tuple[float, str]:
    """Least time for out = M x over `columns` byte columns: each input
    byte read once, each output byte written once, and one table product
    plus one XOR per coefficient per column."""
    t_bytes = (rows + cols) * columns / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * rows * cols * columns / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def call_ms(fn, warmup: int = 5, reps: int = 20) -> float:
    """Median milliseconds of one fn() call between two CUDA events: what a
    caller pays, the wrapper's host work included when it outlasts the
    device's."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, reps: int = 20, warmup: int = 3, replays: int = 3) -> float:
    """Device milliseconds of one launch: fn() captured reps times into one
    CUDA graph, the graph replayed between two CUDA events, the median
    replay over reps. The wrapper's host work runs once, at capture, so
    the launches run back to back on the device: what is timed is the
    kernels and the graph's gaps between them. (torch.profiler's kernel
    times missed every launch of whole sessions on the H100 host.)"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm caches and builds off the capture
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


# --- phase 3: kernel vs plain ---------------------------------------------------
def kernel_phase(dev: torch.device, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(shape) -> torch.Tensor:
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)

    matrices = [("parity", gf256.parity_rows(10, 4))]
    for missing in [(0,), (13,), (3, 12), (0, 9), (1, 4, 7), (10, 11, 12),
                    (2, 5, 11, 13), (1, 4, 7, 9)]:
        present = tuple(s for s in range(14) if s not in missing)
        matrices.append((f"decode{list(missing)}", gf256.decode_matrix(10, 4, present, missing)))
    for rows, cols in [(1, 1), (2, 14), (14, 14), (7, 3), (14, 1), (5, 9)]:
        matrices.append((f"random{rows}x{cols}",
                         rng.randint(0, 256, (rows, cols)).astype(np.uint8)))

    cases = 0
    max_err = 0

    def compare(m: np.ndarray, x: torch.Tensor, name: str) -> None:
        nonlocal cases, max_err
        got = gf256_matmul(m, x)
        x2 = x if x.dim() == 2 else x.permute(1, 0, 2).reshape(x.shape[1], -1)
        want = gf_matmul_torch(m, x2)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
        max_err = max(max_err, err)
        cases += 1
        check(err == 0 and got.shape == want.shape, f"kernel != plain for {name}")

    for name, m in matrices:
        cols = m.shape[1]
        for n in (1, 15, 16, 8191, 8193, MIB + 3):
            compare(m, rand((cols, n)), f"{name} n={n}")
        n = 8193
        big = rand((cols, n + 47))  # rows of 8240 bytes: 16-byte aligned
        compare(m, big[:, 1 : n + 1], f"{name} unaligned view")
        compare(m, big[:, 16 : 16 + n], f"{name} aligned view of a wider buffer")

    # every row count at the EC path's 10 columns, each template instance:
    # whole units and a tail, then an unaligned view (the byte path)
    for rows in range(1, 15):
        m = rng.randint(0, 256, (rows, 10)).astype(np.uint8)
        compare(m, rand((10, 64 * 1024 + 5)), f"random{rows}x10 n=64 KiB + 5")
        compare(m, rand((10, 8240))[:, 3 : 3 + 8193], f"random{rows}x10 unaligned view")

    # the main path's shapes: an encode batch (32 rows of 10 x 1 MiB blocks,
    # read in place) and a 32 MiB-per-shard rebuild batch
    parity = gf256.parity_rows(10, 4)
    batch = rand((32 * 10 * MIB,)).view(32, 10, MIB)
    compare(parity, batch, "encode batch (32, 10, 1 MiB)")
    rebuild_m = gf256.decode_matrix(10, 4, tuple(s for s in range(14) if s not in REBUILD_LOST),
                                    REBUILD_LOST)
    flat = rand((10, 32 * MIB))
    compare(rebuild_m, flat, "rebuild batch (10, 32 MiB)")
    compare(parity, flat[:, 3 : 3 + 16 * MIB + 5], "unaligned 16 MiB view")
    del batch, flat

    # a 64 KiB slice against the numpy oracle
    for name, m in (matrices[0], matrices[7], matrices[11]):
        x = rand((m.shape[1], 64 * 1024))
        got = gf256_matmul(m, x).cpu().numpy()
        check(np.array_equal(got, gf256.gf_matmul_bytes(m, x.cpu().numpy())),
              f"kernel != gf_matmul_bytes for {name}")
        cases += 1

    shapes = gf256_shape_times(dev, seed, gf256_matmul)
    cases += len(shapes)
    # the phase line adds what the kernels line leaves out: each path's
    # matrix, each shape's bound share and its device time on zero bytes
    keys = [f"{r['path']} {'x'.join(map(str, r['shape']))}" for r in shapes]
    emit("kernel", cases=cases, max_abs_err=max_err, shapes=shapes,
         matrices={path: list(m.shape) for path, m in gf_path_matrices().items()},
         bound_share={k: r["bound_ms"] / r["ms"] for k, r in zip(keys, shapes)},
         zero_bytes_ms={k: r.pop("zero_bytes_ms") for k, r in zip(keys, shapes)},
         library_ms=None, library="no single PyTorch call computes a GF(2^8) matmul")
    # the row carries the encode batch (the most bytes a launch) and every shape
    return dict(shapes[0], max_abs_err=max_err, shapes=shapes)


def gf_path_matrices() -> dict:
    """gf256_matmul's matrix on each EC path: the parity rows (encode), the
    decode matrix of the 4-shard rebuild, and a degraded read's one row,
    which reconstructs one missing data shard from 10 survivors."""
    def decode(lost):
        return gf256.decode_matrix(10, 4, tuple(s for s in range(14) if s not in lost), lost)
    return {"encode": gf256.parity_rows(10, 4), "rebuild": decode(REBUILD_LOST),
            "degraded": decode(DEGRADED_LOST[:1]), "online": gf256.parity_rows(10, 4)}


def gf256_shape_times(dev: torch.device, seed: int, wrapper, shapes=GF_SHAPES) -> list:
    """`wrapper` (gf256_matmul, or another checkout's) at each of `shapes`
    (the EC path's by default): equal to the plain version on one input, then timed by
    device time (`ms`) beside one call's event time, the plain version's
    and the bound. Inputs smaller than the 50 MB L2 rotate over more than
    it, so every launch reads device memory, as a fresh H2D copy's would.
    `zero_bytes_ms` is the device time on all-zero input, where a warp's
    lookups all hit one word and meet no bank conflict: what the conflicts
    cost shows as the difference from `ms`."""
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    matrices = gf_path_matrices()
    rows = []
    for path, shape in shapes:
        m = matrices[path]
        per = int(np.prod(shape))
        views = 1 if per >= ROTATE_BYTES else -(-ROTATE_BYTES // per) + 1
        pool = torch.randint(0, 256, (views * per,), dtype=torch.uint8, device=dev,
                             generator=gen).view(views, *shape)
        cyc = itertools.cycle(list(pool))
        x0 = pool[0]
        x2 = x0 if x0.dim() == 2 else x0.permute(1, 0, 2).reshape(x0.shape[1], -1)
        want = gf_matmul_torch(m, x2)
        check(torch.equal(wrapper(m, x0), want), f"kernel != plain at the {path} shape {shape}")
        del want
        b_ms, b_by = bound_ms(*m.shape, per // m.shape[1])
        rows.append(dict(
            path=path, shape=list(shape),
            ms=device_ms(lambda: wrapper(m, next(cyc)), reps=max(20, views)),
            call_ms=call_ms(lambda: wrapper(m, next(cyc))),
            plain_ms=call_ms(lambda: gf_matmul_torch(m, x2), warmup=1, reps=3),
            bound_ms=b_ms, bound_by=b_by))
        pool.zero_()
        check(not wrapper(m, x0).any(), f"kernel of zero bytes is not zero at the {path} shape")
        rows[-1]["zero_bytes_ms"] = device_ms(lambda: wrapper(m, next(cyc)), reps=max(20, views))
        del pool, cyc, x0, x2
    return rows


# --- hash kernels vs plain ------------------------------------------------------
HASH_LENGTHS = (0, 1, 7, 55, 56, 63, 64, 65, 191, 193, 4096, 4097, 65536)
# 16 and 8193 are not multiples of a block's blobs; 1057 = 132 x 8 + 1
HASH_NS = (1, 3, 16, 33, 1057, 8192, 8193)
# lengths whose plain MD5 (a Python loop over 64-byte blocks) would take
# minutes: hashlib stands in for it there
LONG_LENGTHS = (MIB + 17, 4 * MIB)
LONG_NS = (1, 3, 33)
GEAR_NS = (1, 31, 32, 33, MIB + 3, 64 * MIB)
# the hash paths' shapes: upload at the filer's load (16 submitters), the
# service's full batch (_MAX_BATCH), the chunked path's 4 MiB chunks
HASH_SHAPES = ((16, 4096), (8192, 4096), (256, 4 * MIB))
GEAR_PATH = 64 * MIB  # one upload of the cdc phase
ROTATE_BYTES = 64 * MIB  # timed inputs rotate over more than the 50 MB L2
# MD5's dependent chain: a round is 4 dependent instructions on sm_90 (LOP3
# -> IADD3 -> IMAD.IADD -> LEA.HI, read from the kernel's SASS), each
# assumed to take 4 cycles before the next can issue (not published), at
# the 1.98 GHz boost clock
MD5_CHAIN_DEPS, MD5_CHAIN_CYCLES, SM_CLOCK_HZ = 4, 4, 1.98e9
MD5_CHAIN_ASSUMPTION = ("padded blocks x 64 rounds x 4 dependent instructions (SASS) x 4 cycles "
                        "each (assumed, not published) / 1.98 GHz")


def u32(t: torch.Tensor) -> torch.Tensor:
    """uint32 words as int64, for arithmetic on any device."""
    return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def hash_bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    """Least time: bytes moved over the memory rate, or integer operations
    over the integer rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hash_kernel_phase(dev: torch.device, seed: int, md5_ops_per_block: int) -> dict:
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    rng = np.random.RandomState(seed + 1)

    def rand(shape) -> torch.Tensor:
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)

    stats = {k: {"cases": 0, "max_abs_err": 0} for k in ("crc32c_batch", "md5_batch", "gear_hash")}

    def agree(name: str, got: torch.Tensor, want: torch.Tensor, what: str) -> None:
        torch.cuda.synchronize()
        if name == "md5_batch":
            a, b = got.to(torch.int64), want.to(torch.int64)
        else:
            a, b = u32(got), u32(want)
        err = int((a - b).abs().max()) if a.numel() else 0
        st = stats[name]
        st["cases"] += 1
        st["max_abs_err"] = max(st["max_abs_err"], err)
        check(err == 0 and got.shape == want.shape, f"{name} kernel != plain for {what}")

    sampled = 0
    for length in HASH_LENGTHS:
        # one buffer per length; the n cases are row ranges of it, so one
        # plain pass (whose cost is per block, not per blob) covers them all
        whole = rand((sum(HASH_NS), length))
        plain_md5 = md5_batch_torch(whole)
        plain_crc = crc32c_batch_torch(whole) if length else None
        r0 = 0
        for n in HASH_NS:
            x = whole[r0 : r0 + n]
            agree("md5_batch", md5_batch_kernel(x), plain_md5[r0 : r0 + n], f"L={length} n={n}")
            if length:
                agree("crc32c_batch", crc32c_batch_kernel(x), plain_crc[r0 : r0 + n],
                      f"L={length} n={n}")
            r0 += n
        # a sample against hashlib and the host CRC
        host = whole.cpu().numpy()
        for i in rng.choice(len(host), size=16, replace=False):
            blob = host[i].tobytes()
            check(plain_md5[i].cpu().numpy().tobytes() == hashlib.md5(blob).digest(),
                  f"md5 plain != hashlib at L={length}")
            if length:
                check(int(u32(plain_crc[i])) == crc.crc32c(blob),
                      f"crc plain != host CRC at L={length}")
            sampled += 1
    # strided row views: unaligned (the byte path) and 16-byte aligned rows
    for length, lead, extra in ((65, 3, 19), (4097, 1, 30), (4096, 16, 16), (63, 0, 1)):
        wide = rand((33, length + extra))
        view = wide[:, lead : lead + length]
        agree("md5_batch", md5_batch_kernel(view), md5_batch_torch(view),
              f"view L={length} stride={wide.stride(0)}")
        agree("crc32c_batch", crc32c_batch_kernel(view), crc32c_batch_torch(view),
              f"view L={length} stride={wide.stride(0)}")

    def against_hashlib(x: torch.Tensor, what: str) -> None:
        got = md5_batch_kernel(x).cpu().numpy()
        host = x.cpu().numpy()
        st = stats["md5_batch"]
        st["cases"] += 1
        check(all(got[i].tobytes() == hashlib.md5(host[i].tobytes()).digest()
                  for i in range(len(host))), f"md5_batch kernel != hashlib for {what}")
        agree("crc32c_batch", crc32c_batch_kernel(x), crc32c_batch_torch(x), what)

    # lengths past the staging rings, and an unaligned view of 4 MiB + 3
    for length in LONG_LENGTHS:
        whole = rand((sum(LONG_NS), length))
        r0 = 0
        for n in LONG_NS:
            against_hashlib(whole[r0 : r0 + n], f"L={length} n={n}")
            r0 += n
    wide = rand((3, 4 * MIB + 3 + 13))
    against_hashlib(wide[:, 5 : 5 + 4 * MIB + 3], "view L=4 MiB + 3 at offset 5")

    for n in GEAR_NS:
        x = rand((n,))
        agree("gear_hash", cdc.gear_hash_kernel(x), cdc.gear_hashes_torch(x), f"n={n}")
        if n == MIB + 3:
            check(np.array_equal(cdc.gear_hash_kernel(x).cpu().numpy(),
                                 cdc.gear_hashes_numpy(x.cpu().numpy())),
                  "gear kernel != numpy oracle at 1 MiB + 3")
            y = x[1:]  # an odd start: the kernel's byte path for every tile
            agree("gear_hash", cdc.gear_hash_kernel(y), cdc.gear_hashes_torch(y), "offset 1")

    out = hash_shape_times(dev, seed, HASH_WRAPPERS, md5_ops_per_block)
    chain_ms = {f"{n}x{length}": _pad_len(length) // 64 * 64 * MD5_CHAIN_DEPS
                * MD5_CHAIN_CYCLES / SM_CLOCK_HZ * 1e3 for n, length in HASH_SHAPES}
    # a hash kernel's row carries the upload path's shape (its launches are
    # nearly all there) and every shape under "shapes"
    for name, rows in out.items():
        out[name] = dict(rows[0], shapes=rows) if len(rows) > 1 else rows[0]
        out[name].update(stats[name])
    # the phase line adds what the kernels line leaves out: each shape's
    # bound share and MD5's chain model
    shares = {name: {"x".join(map(str, r["shape"])): r["bound_ms"] / r["ms"]
                     for r in o.get("shapes", [o])} for name, o in out.items()}
    emit("hash_kernels", sampled_vs_hashlib=sampled, int32_ops_per_s=INT32_OPS_PER_S,
         bound_share=shares, md5_chain_ms=chain_ms, md5_chain=MD5_CHAIN_ASSUMPTION,
         library_ms=None, library="no single PyTorch call computes CRC32C, MD5 or a gear hash",
         **out)
    return out


def hash_shape_times(dev: torch.device, seed: int, wrappers: dict,
                     md5_ops_per_block: int) -> dict:
    """The hash kernels (`wrappers`: crc32c_batch, md5_batch and gear_hash,
    this checkout's or another's) at their paths' shapes: each equal to
    its plain version (MD5 past 4096 bytes: to hashlib on two blobs), then
    timed by device time (`ms`: a CUDA graph of launches) beside one
    call's event time, the plain version's and the bound. Inputs rotate
    over more than the 50 MB L2, so every launch reads device memory."""
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    crc_k, md5_k, gear_k = (wrappers[k] for k in ("crc32c_batch", "md5_batch", "gear_hash"))
    out = {"crc32c_batch": [], "md5_batch": []}
    for n, length in HASH_SHAPES:
        per = n * length
        views = max(2, -(-ROTATE_BYTES // per) + 1)
        pool = torch.randint(0, 256, (views * n, length), dtype=torch.uint8, device=dev,
                             generator=gen)
        cyc = itertools.cycle([pool[i * n : (i + 1) * n] for i in range(views)])
        x0 = pool[:n]
        blocks = _pad_len(length) // 64
        # the graph holds a launch per input, so that its replay reads them all
        reps = max(20, views)
        check(torch.equal(u32(crc_k(x0)), u32(crc32c_batch_torch(x0))),
              f"crc32c_batch kernel != plain at ({n}, {length})")
        b_ms, b_by = hash_bound_ms(per + 4 * n, TABLE_OPS_PER_BYTE * per)
        out["crc32c_batch"].append(dict(
            shape=[n, length], ms=device_ms(lambda: crc_k(next(cyc)), reps=reps),
            call_ms=call_ms(lambda: crc_k(next(cyc))),
            plain_ms=call_ms(lambda: crc32c_batch_torch(x0), warmup=1, reps=3),
            bound_ms=b_ms, bound_by=b_by))
        got = md5_k(x0)
        if length <= 4096:
            check(torch.equal(got, md5_batch_torch(x0)),
                  f"md5_batch kernel != plain at ({n}, {length})")
        else:  # the plain MD5 loops over blocks in Python: minutes at 4 MiB
            host = x0[:2].cpu().numpy()
            check(all(got[i].cpu().numpy().tobytes() == hashlib.md5(host[i].tobytes()).digest()
                      for i in range(2)), f"md5_batch kernel != hashlib at ({n}, {length})")
        b_ms, b_by = hash_bound_ms(per + 16 * n, md5_ops_per_block * n * blocks)
        out["md5_batch"].append(dict(
            shape=[n, length],
            ms=device_ms(lambda: md5_k(next(cyc)), reps=reps, warmup=1),
            call_ms=call_ms(lambda: md5_k(next(cyc)), warmup=1),
            plain_ms=(call_ms(lambda: md5_batch_torch(x0), warmup=0, reps=1)
                      if length <= 4096 else None),
            bound_ms=b_ms, bound_by=b_by))
        del pool, cyc, x0, got
    data = torch.randint(0, 256, (GEAR_PATH,), dtype=torch.uint8, device=dev, generator=gen)
    check(torch.equal(u32(gear_k(data)), u32(cdc.gear_hashes_torch(data))),
          "gear_hash kernel != plain")
    b_ms, b_by = hash_bound_ms(5 * GEAR_PATH, TABLE_OPS_PER_BYTE * GEAR_PATH)
    out["gear_hash"] = [dict(
        shape=[GEAR_PATH], ms=device_ms(lambda: gear_k(data)),
        call_ms=call_ms(lambda: gear_k(data)),
        plain_ms=call_ms(lambda: cdc.gear_hashes_torch(data), warmup=1, reps=3),
        bound_ms=b_ms, bound_by=b_by)]
    return out


# --- phase 4: the main path -------------------------------------------------------
def write_volume(d: str, vid: int, target: int, seed: int,
                 lo: int = 1024, hi: int = 4 * MIB) -> dict:
    """A volume of exactly `target` bytes (when the last gap allows) of
    needles with log-uniform sizes in [lo, hi], data from `seed`.
    Returns {needle_id: (cookie, data_offset, size)} into the data pool."""
    rng = np.random.default_rng(seed)
    pool = memoryview(rng.bytes(target))
    needles = {}
    used = 0
    with Volume(d, "", vid) as v:
        nid = 0
        while True:
            size = int(np.exp(rng.uniform(np.log(lo), np.log(hi))))
            room = target - v.size()
            if get_actual_size(size + 5, 3) > room:  # body: dataSize 4 + data + flags 1
                # fill the rest exactly: header 16 + dataSize 4 + flags 1
                # + crc 4 + timestamp 8 + 8 bytes of padding = size + 41
                size = room - 41
                if size < 1:
                    break
            if used + size > len(pool):
                break
            nid += int(rng.integers(1, 1 << 20))
            cookie = int(rng.integers(0, 1 << 32))
            v.write_needle(Needle(cookie=cookie, id=nid, data=pool[used : used + size]))
            needles[nid] = (cookie, used, size)
            used += size
            if v.size() >= target:
                break
    base = os.path.join(d, str(vid))
    encoder.write_sorted_file_from_idx(base)
    encoder.save_volume_info(base + ".vif", version=3)
    return {"needles": needles, "pool": pool, "base": base}


def main_path(work: str, codec: RSCodec, volume_bytes: int, seed: int) -> dict:
    t0 = time.perf_counter()
    vol = write_volume(work, 1, volume_bytes, seed)
    base = vol["base"]
    dat = base + ".dat"
    dat_size = os.path.getsize(dat)
    emit("volume", bytes=dat_size, needles=len(vol["needles"]),
         seconds=time.perf_counter() - t0)
    check(dat_size == volume_bytes, f".dat is {dat_size} bytes, want {volume_bytes}")

    launches = {}
    # 4.1 encode
    n0 = gf256_matmul.launches
    t0 = time.perf_counter()
    encoder.write_ec_files(base, codec=codec)
    enc_s = time.perf_counter() - t0
    launches["encode"] = gf256_matmul.launches - n0
    shard_size = geometry.shard_file_size(dat_size)
    for i in range(14):
        check(os.path.getsize(base + geometry.to_ext(i)) == shard_size, f"shard {i} size")

    # 4.2 sampled parity columns against the numpy oracle
    rng = np.random.RandomState(seed)
    parity = gf256.parity_rows(10, 4)
    fds = [os.open(base + geometry.to_ext(i), os.O_RDONLY) for i in range(14)]
    try:
        for off in rng.randint(0, shard_size - 4096, size=64):
            cols = np.stack([np.frombuffer(os.pread(fds[i], 4096, int(off)), np.uint8)
                             for i in range(14)])
            check(np.array_equal(gf256.gf_matmul_bytes(parity, cols[:10]), cols[10:]),
                  f"parity columns at {off}")
    finally:
        for fd in fds:
            os.close(fd)

    def lose(shards) -> None:
        for s in shards:
            os.replace(base + geometry.to_ext(s), base + geometry.to_ext(s) + ".orig")

    def rebuild(shards) -> float:
        lose(shards)
        n0 = gf256_matmul.launches
        t0 = time.perf_counter()
        rebuilt = encoder.rebuild_ec_files(base, codec=codec)
        dt = time.perf_counter() - t0
        launches[f"rebuild{list(shards)}"] = gf256_matmul.launches - n0
        check(rebuilt == list(shards), f"rebuilt {rebuilt}")
        for s in shards:
            p = base + geometry.to_ext(s)
            check(same_file(p, p + ".orig"), f"rebuilt shard {s} differs")
            os.unlink(p + ".orig")
        return dt

    # 4.3 rebuild two data + two parity shards
    reb_s = rebuild(REBUILD_LOST)

    # 4.4 degraded reads with four data shards missing
    lose(DEGRADED_LOST)
    ids = sorted(vol["needles"])
    pick = rng.choice(len(ids), size=min(DEGRADED_READS, len(ids)), replace=False)
    lat = []
    n0 = gf256_matmul.launches
    with EcVolume(work, "", 1, codec=codec) as ev:
        check(ev.shard_ids() == [s for s in range(14) if s not in DEGRADED_LOST], "shards")
        for i in pick:
            nid = ids[i]
            cookie, off, size = vol["needles"][nid]
            t0 = time.perf_counter()
            n = ev.read_needle(nid, cookie=cookie)
            lat.append(time.perf_counter() - t0)
            want = vol["pool"][off : off + size]
            check(n.data == want, f"needle {nid:x} bytes")
            check(n.checksum == crc.crc32c(want), f"needle {nid:x} crc")
    launches["degraded_reads"] = gf256_matmul.launches - n0
    for s in DEGRADED_LOST:
        os.replace(base + geometry.to_ext(s) + ".orig", base + geometry.to_ext(s))
    # the same four data shards, now rebuilt
    reb2_s = rebuild(DEGRADED_LOST)

    # 4.5 decode back to .dat
    size = decoder.find_dat_file_size(base, base)
    check(size == dat_size, f"find_dat_file_size {size} != {dat_size}")
    out = os.path.join(work, "decoded")
    t0 = time.perf_counter()
    decoder.write_dat_file(out, size, [base + geometry.to_ext(i) for i in range(10)])
    dec_s = time.perf_counter() - t0
    check(same_file(out + ".dat", dat), "decoded .dat differs")

    lat_ms = np.array(lat) * 1e3
    survivors = 10 * shard_size
    result = dict(
        volume_bytes=dat_size, shard_bytes=shard_size,
        encode_s=enc_s, encode_gbps=dat_size / enc_s / 1e9,
        rebuild_s=reb_s, rebuild_gbps=survivors / reb_s / 1e9,
        rebuild_data_s=reb2_s, rebuild_data_gbps=survivors / reb2_s / 1e9,
        degraded_reads=len(lat), degraded_p50_ms=float(np.percentile(lat_ms, 50)),
        degraded_p99_ms=float(np.percentile(lat_ms, 99)),
        decode_s=dec_s, decode_gbps=dat_size / dec_s / 1e9,
        launches=launches,
    )
    return result


def profile_phase(work: str, codec: RSCodec) -> dict:
    """Where an encode's time goes: re-encode the main path's volume once
    more with warm pinned buffers, then once under torch.profiler, summing
    the device time of the kernel and of the copies."""
    from torch.profiler import ProfilerActivity, profile

    base = os.path.join(work, "1")
    size = os.path.getsize(base + ".dat")
    t0 = time.perf_counter()
    encoder.write_ec_files(base, codec=codec)
    warm_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        encoder.write_ec_files(base, codec=codec)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    us = {"kernel": 0.0, "h2d": 0.0, "d2h": 0.0}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        if "gf256_matmul_kernel" in e.key:
            us["kernel"] += t
        elif "HtoD" in e.key:
            us["h2d"] += t
        elif "DtoH" in e.key:
            us["d2h"] += t
    check(us["kernel"] > 0, "the profiler saw no kernel time")
    busy_s = sum(us.values()) / 1e6
    return dict(warm_encode_s=warm_s, warm_encode_gbps=size / warm_s / 1e9,
                profiled_encode_s=wall_s, kernel_ms=us["kernel"] / 1e3,
                h2d_ms=us["h2d"] / 1e3, d2h_ms=us["d2h"] / 1e3,
                device_busy_share=busy_s / wall_s,
                device_idle_share=1 - busy_s / wall_s)


# --- phase 5: the column-split schedule ------------------------------------------
def cols_phase(work: str, codec: RSCodec, seed: int) -> dict:
    large, small, batch = MIB, 64 * 1024, 256 * 1024
    vol = write_volume(work, 2, 24 * MIB + 4096, seed + 1, lo=1024, hi=256 * 1024)
    base = vol["base"]
    kinds = [j[0] for j in encoder._schedule(os.path.getsize(base + ".dat"), large, small, batch)]
    check("cols" in kinds and "rows" in kinds, f"schedule kinds {set(kinds)}")
    n0 = gf256_matmul.launches
    encoder.write_ec_files(base, codec=codec, large_block_size=large,
                           small_block_size=small, batch=batch)
    launches = gf256_matmul.launches - n0
    plain = os.path.join(work, "plain")
    os.makedirs(plain)
    shutil.copy(base + ".dat", os.path.join(plain, "2.dat"))
    encoder.write_ec_files(os.path.join(plain, "2"), codec=RSCodec(device="cpu"),
                           large_block_size=large, small_block_size=small)
    for i in range(14):
        ext = geometry.to_ext(i)
        check(same_file(base + ext, os.path.join(plain, "2" + ext)), f"cols shard {i}")
    return dict(jobs_cols=kinds.count("cols"), jobs_rows=kinds.count("rows"),
                launches=launches, identical_shards=14)


# --- phase 6: the upload path -------------------------------------------------------
UPLOAD_THREADS = 16  # the concurrency of the reference's `weed benchmark` (BASELINE.md)
UPLOAD_PROFILED = 65536  # blobs of the profiled window
BLOB = 4096
FILER_CHUNK = 4 * MIB  # server/filer.py: chunk_size_mb=4


def drive_upload(svc: HashService, blobs: list) -> dict:
    """Submit blobs[t] from thread t as the filer's upload handler does
    (server/filer.py: `submit(data).md5_hex()`): one blob, then wait for its
    result before the next, so at most one blob per thread is in flight.
    Returns the wall time, each blob's (md5, crc), its submit-to-result
    latency (HashResult.done_at) and the (blobs, seconds) of every batch
    the flusher hashed."""
    results = [[None] * len(b) for b in blobs]
    lat = [np.zeros(len(b)) for b in blobs]
    batches = []
    errors = []
    real_batch_hash = svc._batch_hash

    def timed_batch_hash(items, length):
        t0 = time.perf_counter()
        out = real_batch_hash(items, length)
        batches.append((len(items), time.perf_counter() - t0))
        return out

    def work(t: int) -> None:
        try:
            for i, blob in enumerate(blobs[t]):
                ts = time.perf_counter()
                fut = svc.submit(blob).wait(120)
                results[t][i] = (fut.md5, fut.crc)
                lat[t][i] = fut.done_at - ts
        except BaseException as e:  # re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(len(blobs))]
    svc._batch_hash = timed_batch_hash
    try:
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
    finally:
        del svc._batch_hash
    if errors:
        raise errors[0]
    return dict(wall=wall, results=results, lat=lat, batches=batches)


def upload_phase(svc: HashService, n_blobs: int, seed: int) -> dict:
    """n_blobs seeded 4 KiB blobs through the service from 16 synchronous
    threads, the kernels' launches counted over that run alone; every result
    held against hashlib and the host CRC. After the count is read: one
    batch of the mean size timed alone, then the first UPLOAD_PROFILED blobs
    again under torch.profiler, for the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    per = [n_blobs // UPLOAD_THREADS + (t < n_blobs % UPLOAD_THREADS)
           for t in range(UPLOAD_THREADS)]
    blobs = []
    for t, count in enumerate(per):
        raw = np.random.default_rng([seed, 3, t]).bytes(count * BLOB)
        blobs.append([raw[i * BLOB : (i + 1) * BLOB] for i in range(count)])
        del raw
    gen_s = time.perf_counter() - t0
    # yardstick: the host alone, one thread, hashlib + the host CRC per blob
    sample = blobs[0][:16384]
    t0 = time.perf_counter()
    for blob in sample:
        hashlib.md5(blob).digest()
        crc.crc32c(blob)
    host_rate = len(sample) / (time.perf_counter() - t0)

    b0 = svc.batch_blobs, svc.host_blobs
    zero_launches()
    run = drive_upload(svc, blobs)
    launches = read_launches()
    wall, batches = run["wall"], run["batches"]
    kernel_blobs = svc.batch_blobs - b0[0]
    host_blobs = svc.host_blobs - b0[1]
    check(kernel_blobs > 0, "the kernels hashed no upload blob")
    check(kernel_blobs + host_blobs == n_blobs, "blobs unaccounted for")
    t0 = time.perf_counter()
    for bl, res in zip(blobs, run["results"]):  # one thread: the GIL makes more slower
        for blob, (md5, c) in zip(bl, res):
            check(md5 == hashlib.md5(blob).digest() and c == crc.crc32c(blob),
                  "an upload MD5 or CRC differs from hashlib / the host CRC")
    verify_s = time.perf_counter() - t0
    lat_ms = np.concatenate(run["lat"]) * 1e3
    # the same batch with no submitter running: its cost without GIL contention
    mean_batch = float(np.mean([b for b, _ in batches]))
    items = [(blob, None) for blob in blobs[0][: max(1, round(mean_batch))]]
    svc._batch_hash(items, BLOB)
    t0 = time.perf_counter()
    for _ in range(50):
        svc._batch_hash(items, BLOB)
    alone_ms = (time.perf_counter() - t0) / 50 * 1e3

    # a profiled window: device time of the kernels and copies over its wall
    head = [bl[: UPLOAD_PROFILED // UPLOAD_THREADS] for bl in blobs]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = drive_upload(svc, head)
        torch.cuda.synchronize()
    for res, ref in zip(again["results"], run["results"]):
        check(res == ref[: len(res)], "the profiled upload's hashes differ")
    # a batch is one pinned copy in, one launch of each kernel and two copies
    # out. The profiler may drop events on the card's host, so each kind's
    # time is its mean over the events seen times the events the window made
    nb = len(again["batches"])
    made = {"md5": nb, "crc": nb, "h2d": nb, "d2h": 2 * nb}
    us = dict.fromkeys(made, 0.0)
    seen = dict.fromkeys(made, 0)
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        kind = next((k for k, key in (("md5", "md5_batch_kernel"), ("crc", "crc32c_batch_kernel"),
                                      ("h2d", "HtoD"), ("d2h", "DtoH")) if key in e.key), None)
        if kind:
            us[kind] += t
            seen[kind] += e.count
    check(all(0 < seen[k] <= made[k] for k in made),
          f"the profiler saw {seen} of the window's {made} events")
    per = {k: us[k] / seen[k] for k in made}
    busy = sum(per[k] * made[k] for k in made) / 1e6 / again["wall"]
    profiled = dict(blobs=sum(len(h) for h in head), seconds=again["wall"],
                    blobs_per_s=sum(len(h) for h in head) / again["wall"],
                    batches=nb, profiler_events=seen, window_events=made,
                    md5_us_per_batch=per["md5"], crc_us_per_batch=per["crc"],
                    **{f"{k}_ms": per[k] * made[k] / 1e3 for k in made},
                    device_busy_share=busy, device_idle_share=1 - busy)
    sizes = np.array([b for b, _ in batches])
    return dict(blobs=n_blobs, blob_bytes=BLOB, threads=UPLOAD_THREADS, in_flight_per_thread=1,
                launches=launches,
                seconds=wall, blobs_per_s=n_blobs / wall, gbps=n_blobs * BLOB / wall / 1e9,
                p50_ms=float(np.percentile(lat_ms, 50)), p99_ms=float(np.percentile(lat_ms, 99)),
                kernel_blobs=kernel_blobs, host_blobs=host_blobs,
                kernel_share=kernel_blobs / n_blobs,
                batches=len(batches), mean_batch=mean_batch,
                batch_p50=float(np.percentile(sizes, 50)), batch_max=int(sizes.max()),
                batch_hash_s=sum(t for _, t in batches),
                batch_hash_mean_ms=sum(t for _, t in batches) / len(batches) * 1e3,
                batch_hash_alone_ms=alone_ms,
                flusher_busy_share=sum(t for _, t in batches) / wall,
                host_one_thread_blobs_per_s=host_rate,
                generate_s=gen_s, verify_s=verify_s, all_equal_hashlib=True,
                profiled=profiled)


def chunked_phase(dev: torch.device, svc: HashService, nbytes: int, seed: int) -> dict:
    """One upload cut into the filer's 4 MiB chunks, hashed through
    submit_many as the filer's chunked upload does; twice, the first with
    the staging buffer still to be pinned, the kernels' launches counted
    over those two runs alone. Then the full chunks, staged on the card,
    through both kernels directly: CRC against its plain version, MD5
    against hashlib (the plain MD5 takes minutes at 65,537 blocks a row)."""
    data = np.random.default_rng([seed, 4]).bytes(nbytes)
    pieces = [data[o : o + FILER_CHUNK] for o in range(0, len(data), FILER_CHUNK)]
    runs = []
    zero_launches()
    for _ in range(2):
        b0 = svc.batch_blobs, svc.host_blobs
        t0 = time.perf_counter()
        futs = svc.submit_many(pieces)
        for f in futs:
            f.wait(300)
        runs.append((time.perf_counter() - t0, svc.batch_blobs - b0[0], svc.host_blobs - b0[1]))
        for p, f in zip(pieces, futs):
            check(f.md5_hex() == hashlib.md5(p).hexdigest(), "chunk ETag != hashlib")
            check(f.crc == crc.crc32c(p), "chunk CRC != host CRC")
    launches = read_launches()
    (cold_s, kernel_chunks, host_chunks), (warm_s, _, _) = runs
    ragged = len(data) % FILER_CHUNK
    full = len(data) // FILER_CHUNK
    check(kernel_chunks == full, "full chunks not hashed by the kernels")
    check(host_chunks == (1 if ragged else 0), "the ragged last chunk did not take the host")

    x = torch.frombuffer(bytearray(data[: full * FILER_CHUNK]), dtype=torch.uint8)
    x = x.view(full, FILER_CHUNK).to(dev)
    got_crc, want_crc = crc32c_batch_kernel(x), crc32c_batch_torch(x)
    torch.cuda.synchronize()
    crc_err = int((u32(got_crc) - u32(want_crc)).abs().max())
    check(crc_err == 0, "crc32c_batch kernel != plain at the chunked shape")
    got_md5 = md5_batch_kernel(x).cpu().numpy()
    check(all(got_md5[i].tobytes() == hashlib.md5(pieces[i]).digest() for i in range(full)),
          "md5_batch kernel != hashlib at the chunked shape")
    return dict(bytes=len(data), chunks=len(pieces), ragged_bytes=ragged, launches=launches,
                kernel_chunks=kernel_chunks, host_chunks=host_chunks,
                cold_s=cold_s, cold_gbps=len(data) / cold_s / 1e9,
                warm_s=warm_s, warm_gbps=len(data) / warm_s / 1e9, etags_equal_hashlib=True,
                staged_shape=[full, FILER_CHUNK], crc_kernel_vs_plain_max_abs_err=crc_err,
                md5_kernel_equal_hashlib=True)


# --- phase 7: content-defined chunking ---------------------------------------------
DEDUP = dict(avg_bits=16, min_size=16 * 1024, max_size=512 * 1024)  # server/filer.py:66-68
CDC_UPLOAD = 64 * MIB


def plain_candidates(dev: torch.device, data: np.ndarray, avg_bits: int,
                     window: int = 64 * MIB) -> np.ndarray:
    """Cut candidates of a buffer from the plain gear hashes on the card,
    computed over windows that carry the 31 bytes before them."""
    out = []
    for s in range(0, len(data), window):
        lo = max(0, s - (cdc.WINDOW - 1))
        h = cdc.gear_hashes_torch(torch.from_numpy(data[lo : s + window]).to(dev))
        out.append(cdc.candidates(h[s - lo :], avg_bits) + s)
    return np.concatenate(out) if out else np.zeros(0, dtype=np.int64)


def cdc_phase(dev: torch.device, uploads: int, stream_bytes: int, seed: int) -> dict:
    rng = np.random.default_rng([seed, 5])
    kernel_s = 0.0
    n_cuts = 0
    for u in range(uploads):
        data = np.frombuffer(bytearray(rng.bytes(CDC_UPLOAD)), dtype=np.uint8)
        t0 = time.perf_counter()
        cuts = cdc.find_boundaries(data, device=dev, **DEDUP)
        kernel_s += time.perf_counter() - t0
        plain = cdc.cut_points(plain_candidates(dev, data, DEDUP["avg_bits"]), len(data),
                               DEDUP["min_size"], DEDUP["max_size"])
        check(cuts == plain, f"find_boundaries != plain on upload {u}")
        if u == 0:
            h = cdc.gear_hashes_numpy(data)
            mask = np.uint32((1 << DEDUP["avg_bits"]) - 1)
            oracle = cdc.cut_points(np.nonzero((h & mask) == 0)[0], len(data),
                                    DEDUP["min_size"], DEDUP["max_size"])
            check(cuts == oracle, "find_boundaries != the numpy cut rule on upload 0")
        n_cuts += len(cuts)

    raw = np.random.default_rng([seed, 6]).integers(0, 256, stream_bytes, dtype=np.uint8)
    pos = 0

    def read(n: int) -> bytes:
        nonlocal pos
        piece = raw[pos : pos + n].tobytes()
        pos += len(piece)
        return piece

    t0 = time.perf_counter()
    chunks = list(cdc.chunk_stream(read, device=dev))
    stream_s = time.perf_counter() - t0
    ends = [o + n for o, n in chunks]
    plain = cdc.cut_points(plain_candidates(dev, raw, 13), len(raw), 2048, 65536)
    check(ends == plain, "chunk_stream != the plain cut rule over the whole stream")
    total = uploads * CDC_UPLOAD
    return dict(uploads=uploads, upload_bytes=CDC_UPLOAD, **DEDUP,
                find_boundaries_s=kernel_s, find_boundaries_gbps=total / kernel_s / 1e9,
                cuts=n_cuts, mean_chunk=total / n_cuts,
                stream_bytes=stream_bytes, stream_s=stream_s,
                stream_gbps=stream_bytes / stream_s / 1e9, stream_chunks=len(chunks),
                cuts_equal_plain=True, first_upload_equal_numpy=True)


# --- phase 8: the filer's CDC dedup write path -------------------------------------
DEDUP_SEGMENT = 64 * MIB  # bench.py bench_cdc_dedup: 64 MiB uploads
# tests/test_hash_kernels.py TestFast128.GOLDENS: SW128's stability contract
SW128_GOLDENS = {
    b"": "33e3e03153b370ad09fc69b2f5458347",
    b"hello world": "c45b2fa4798b614d6ef52c3d1a90a788",
    b"hello worle": "d1ddba86ba4300cd658d38d5e1028a75",
}
DEDUP_PROFILED = 8  # uploads of the profiled window
DEDUP_KEY_SAMPLES = 8  # spans per upload whose key is recomputed alone


class FreshFids:
    """The dedup phase's chunk uploader: a fresh fid per chunk and no blob
    kept (the blob upload is what configs 1-3 measure)."""

    def __init__(self) -> None:
        self.issued = 0

    def upload(self, payload, replication="", collection="", ttl="") -> dict:
        self.issued += 1
        return {"fid": f"3,{self.issued:x}00000000"}


def dedup_upload(segs: list, i: int) -> bytes:
    """Upload i of bench.py's stream: segment (i // 2) % 4 when i is even,
    else segment (i // 3) % 4 rotated by 1 + 37 * i % 4093 bytes; as bytes,
    as the filer receives an HTTP body."""
    if i % 2 == 0:
        return segs[(i // 2) % 4].tobytes()
    shift = 1 + 37 * i % 4093
    src = segs[(i // 3) % 4]
    return src[shift:].tobytes() + src[:shift].tobytes()


def dedup_phase(dev: torch.device, n_uploads: int, seed: int) -> dict:
    """BASELINE config 4 through the port's FilerServer._upload_chunks_cdc
    on the card: n_uploads uploads of 64 MiB that alternate four seeded
    segments with byte-shifted repeats (bench.py bench_cdc_dedup), a
    Filer(MemoryStore()), the filer's dedup geometry. Each upload is built
    before its timed window. The gear_hash launches are counted over the
    timed run alone; then a profiled window of exact repeats for the
    device's idle share. Checks: SW128's goldens, the cuts of the first
    upload and of a shifted repeat against the plain CPU cut rule, every
    miss's ETag against hashlib, sampled span keys against SW128 of the span
    alone, every exact repeat fully deduped, every shifted repeat at least
    90 % of its bytes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for data, want in SW128_GOLDENS.items():
        check(native.fast128(data).hex() == want, f"SW128 golden of {data!r}")
    t0 = time.perf_counter()
    rng = np.random.default_rng([seed, 7])
    segs = [rng.integers(0, 256, DEDUP_SEGMENT, dtype=np.uint8) for _ in range(4)]
    gen_s = time.perf_counter() - t0
    client = FreshFids()
    filer = Filer(MemoryStore())
    server = FilerServer(filer, client, device=dev, dedup_avg_bits=DEDUP["avg_bits"],
                         dedup_min=DEDUP["min_size"], dedup_max=DEDUP["max_size"])
    idx = server.dedup_index
    svc = server.hash_service
    # the time split: the path's calls timed where the server makes them
    # (the index: every lookup and insert; the rest is the whole-upload MD5,
    # the loops and chunk records); what each returned is kept for the checks
    split = {"find_boundaries": 0.0, "span_keys": 0.0, "index": 0.0, "md5_spans": 0.0}
    last = {}

    def timed(name, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            split[name] += time.perf_counter() - t
            last[name] = out
            return out
        return run

    real_fb = cdc.find_boundaries
    cdc.find_boundaries = timed("find_boundaries", real_fb)
    svc.span_keys = timed("span_keys", svc.span_keys)
    svc.md5_spans = timed("md5_spans", svc.md5_spans)
    idx.lookup = timed("index", idx.lookup)
    idx.insert = timed("index", idx.insert)
    seen_segments = set()
    rows = []
    stream_md5 = []
    torch.cuda.reset_peak_memory_stats()
    try:
        zero_launches()
        for i in range(n_uploads):
            kind = ("exact" if (i // 2) % 4 in seen_segments else "fresh") if i % 2 == 0 \
                else "shifted"
            data = dedup_upload(segs, i)
            before = dict(split, hits=idx.hits, saved=idx.bytes_saved, issued=client.issued)
            t = time.perf_counter()
            chunks, etag = server._upload_chunks_cdc(data, "", "", "")
            window = time.perf_counter() - t
            row = dict(kind=kind, bytes=len(data), window_s=window, chunks=len(chunks),
                       hits=idx.hits - before["hits"], saved=idx.bytes_saved - before["saved"],
                       **{k: split[k] - before[k] for k in split})
            rows.append(row)
            # checks, outside the window
            check(sum(c.size for c in chunks) == len(data), f"upload {i}: chunks cover the upload")
            if i < 2:  # the first upload and a shifted repeat: the plain CPU cut rule
                arr = np.frombuffer(data, dtype=np.uint8)
                h = cdc.gear_hashes_numpy(arr)
                plain = cdc.cut_points(np.nonzero((h & np.uint32((1 << DEDUP["avg_bits"]) - 1))
                                                  == 0)[0], len(arr), DEDUP["min_size"],
                                       DEDUP["max_size"])
                check(last["find_boundaries"] == plain, f"upload {i}: cuts != the plain CPU cuts")
                del arr, h
            for c in chunks:  # a miss's fid was issued by this upload
                if int(c.file_id.split(",")[1][:-8], 16) > before["issued"]:
                    check(c.etag == hashlib.md5(data[c.offset : c.offset + c.size]).hexdigest(),
                          f"upload {i}: a miss's ETag != hashlib at {c.offset}")
            keys = last["span_keys"]
            for j in np.random.default_rng([seed, 8, i]).choice(len(chunks),
                                                                 min(DEDUP_KEY_SAMPLES, len(chunks)),
                                                                 replace=False):
                c = chunks[j]
                alone = native.fast128(memoryview(data)[c.offset : c.offset + c.size], idx.seed)
                check(keys[j] == "x" + alone.hex(), f"upload {i}: span key {j} != SW128 alone")
            if kind == "exact":
                check(row["hits"] == len(chunks), f"upload {i}: an exact repeat not fully deduped")
            if kind == "shifted":
                check((i // 3) % 4 in seen_segments, f"upload {i}: a shift of an unseen segment")
                check(row["saved"] >= 0.9 * len(data),
                      f"upload {i}: a shifted repeat deduped {row['saved'] / len(data):.3f}")
            if i % 2 == 0:
                seen_segments.add((i // 2) % 4)
            if i < 8:  # the whole-upload MD5 alone, which the window holds
                t = time.perf_counter()
                hashlib.md5(data).digest()
                stream_md5.append(time.perf_counter() - t)
        launches = read_launches()["gear_hash"]
        peak = torch.cuda.max_memory_allocated()
        stats, uploaded = idx.stats(), client.issued
        hits_misses = idx.hits + idx.misses
        check(launches > 0, "the dedup path launched no gear_hash kernel")
        check(launches == n_uploads, f"{launches} gear_hash launches for {n_uploads} uploads")

        # a profiled window of exact repeats: the device's share of an upload
        window = [dedup_upload(segs, 2 * k) for k in range(DEDUP_PROFILED)]
        for attempt in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                for data in window:
                    server._upload_chunks_cdc(data, "", "", "")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            device_us, events = {}, {}
            for e in prof.key_averages():
                if getattr(e, "device_type", None) == DeviceType.CUDA:
                    t_us = getattr(e, "self_device_time_total", None)
                    if t_us is None:
                        t_us = e.self_cuda_time_total
                    name = e.key[:60]  # kernels' full names run to hundreds of characters
                    device_us[name] = device_us.get(name, 0.0) + t_us
                    events[name] = events.get(name, 0) + e.count
            gear_seen = sum(n for k, n in events.items() if "gear_hash_kernel" in k)
            if gear_seen:
                break
        check(gear_seen > 0, "the profiler saw no gear_hash kernel in three windows")
    finally:
        cdc.find_boundaries = real_fb
        filer.close()
    busy_s = sum(device_us.values()) / 1e6
    # the profiler drops events on the card's host: each upload launches
    # gear_hash once, so the device time seen is scaled by the window's
    # uploads over the gear events seen
    busy_scaled_s = busy_s * len(window) / gear_seen
    total = sum(r["bytes"] for r in rows)
    wall_s = sum(r["window_s"] for r in rows)
    rates = sorted(r["bytes"] / r["window_s"] for r in rows)

    # per upload of each kind, mean ms: the timed calls, and the rest of the
    # window (whole-upload MD5, loops, chunk records)
    by_kind = {}
    for kind in ("fresh", "exact", "shifted"):
        mine = [r for r in rows if r["kind"] == kind]
        if not mine:
            continue
        ms = {k: float(np.mean([r[k] for r in mine])) * 1e3 for k in (*split, "window_s")}
        window_ms = ms.pop("window_s")
        by_kind[kind] = dict(uploads=len(mine), window_ms=window_ms,
                             **{f"{k}_ms": v for k, v in ms.items()},
                             rest_ms=window_ms - sum(ms.values()),
                             chunks=float(np.mean([r["chunks"] for r in mine])),
                             hits=float(np.mean([r["hits"] for r in mine])))
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:6]
    return dict(
        gib=n_uploads * DEDUP_SEGMENT / (1024 * MIB), uploads=n_uploads, upload_bytes=DEDUP_SEGMENT, **DEDUP,
        bytes=total, wall_s=wall_s, gbps=total / wall_s / 1e9,
        gbps_p75_window=rates[3 * len(rates) // 4] / 1e9,
        chunks=sum(r["chunks"] for r in rows),
        dedup_chunk_pct=100.0 * stats["hits"] / hits_misses,
        dedup_byte_pct=100.0 * stats["bytes_saved"] / total,
        **stats, uploaded_chunks=uploaded,
        split_total_s={k: sum(r[k] for r in rows) for k in split}, split_ms_per_upload=by_kind,
        stream_md5_ms=float(np.mean(stream_md5)) * 1e3,
        gear_hash_launches=launches, peak_device_bytes=peak,
        profiled=dict(uploads=len(window), seconds=wall, device_busy_s=busy_s,
                      device_busy_scaled_s=busy_scaled_s,
                      device_idle_share_scaled=1 - busy_scaled_s / wall,
                      device_busy_share=busy_s / wall, device_idle_share=1 - busy_s / wall,
                      profiler_windows=attempt + 1, gear_events=gear_seen,
                      device_ms_by_event={k: v / 1e3 for k, v in top},
                      events_by_event={k: events[k] for k, _ in top}),
        generate_segments_s=gen_s, sw128_goldens=True, cuts_equal_plain_cpu=True,
        miss_etags_equal_hashlib=True, sampled_keys_equal_sw128=True,
        nvidia_smi=nvidia_smi())


# --- phase 9: the volume server's online-EC write path -----------------------------
ONLINE_THREADS = 4  # client threads POSTing needles
ONLINE_SAMPLE = 256  # needles read back, and needles read degraded
ONLINE_VID = 7
ONLINE_LOST = (0, 1, 2, 3)  # data shards lost before the degraded reads
ONLINE_SHAPE = ("online", (1, 10, MIB))  # one drain tick at the default block
PULSE_S = 1.0  # the server's pulse: pumps age the tail row out (flush_age 2 s)


class Client:
    """One keep-alive HTTP connection to the volume server."""

    def __init__(self, url: str) -> None:
        host, port = url.split("//", 1)[1].split(":")
        self.conn = http.client.HTTPConnection(host, int(port), timeout=120)

    def request(self, method: str, path: str, body=None, headers=None) -> tuple[int, bytes]:
        self.conn.request(method, path, body=body, headers=headers or {})
        resp = self.conn.getresponse()
        return resp.status, resp.read()

    def json(self, path: str, payload: dict) -> dict:
        status, out = self.request("POST", path, json.dumps(payload).encode(),
                                   {"Content-Type": "application/json"})
        check(status == 200, f"POST {path} -> {status}: {out[:200]!r}")
        return json.loads(out)

    def close(self) -> None:
        self.conn.close()


def online_plan(nbytes: int, seed: int) -> tuple[list, memoryview]:
    """Needles of log-uniform sizes in [1 KiB, 4 MiB] (write_volume's rule)
    whose payloads add up to `nbytes`: [(fid, needle_id, offset, size)]
    into one seeded pool."""
    rng = np.random.default_rng([seed, 9])
    pool = memoryview(rng.bytes(nbytes))
    plan = []
    used = 0
    nid = 0
    while used < nbytes:
        size = min(int(np.exp(rng.uniform(np.log(1024), np.log(4 * MIB)))), nbytes - used)
        nid += int(rng.integers(1, 1 << 20))
        cookie = int(rng.integers(0, 1 << 32))
        plan.append((f"{ONLINE_VID},{file_id.format_needle_id_cookie(nid, cookie)}",
                     nid, used, size))
        used += size
    return plan, pool


def check_parity_rows(dev: torch.device, dat: str, parity: list, block: int, rows: int,
                      what: str) -> None:
    """Every one of `rows` parity rows in the four files `parity` equal to the
    plain version on the card over the .dat's rows of 10 `block`s (the
    tail zero-padded), 16 rows at a time."""
    stripe = 10 * block
    parity_m = gf256.parity_rows(10, 4)
    fds = [os.open(p, os.O_RDONLY) for p in parity]
    try:
        with open(dat, "rb") as f:
            for r0 in range(0, rows, 16):
                r1 = min(rows, r0 + 16)
                raw = f.read((r1 - r0) * stripe)
                x = np.zeros((r1 - r0) * stripe, np.uint8)
                x[: len(raw)] = np.frombuffer(raw, np.uint8)
                xd = torch.from_numpy(x).to(dev).view(r1 - r0, 10, block)
                want = gf_matmul_torch(parity_m, xd.permute(1, 0, 2).reshape(10, -1))
                for p in range(4):
                    got = os.pread(fds[p], (r1 - r0) * block, r0 * block)
                    check(np.array_equal(np.frombuffer(got, np.uint8), want[p].cpu().numpy()),
                          f"{what}: parity shard {10 + p}, rows {r0}-{r1} != plain")
    finally:
        for fd in fds:
            os.close(fd)


def online_phase(dev: torch.device, nbytes: int, seed: int) -> dict:
    """The volume server's online-EC path on the card: a port VolumeServer
    (no master) allocates one ecOnline volume at the default 1 MiB block;
    4 client threads POST `nbytes` of seeded needles, each write pumping
    the stripe writer (parity through gf256_matmul); a seeded sample reads
    back equal; the open shards served over /admin/ec/shard equal the files,
    and every parity row on disk equals the plain version run on the card
    over the same .dat rows; /admin/ec/generate seals without re-encoding
    ("online": true, at most the tail row); after the source volume is
    dropped, data shards 0-3 go and 256 needles that lie on them are read
    degraded through the mount; /admin/ec/rebuild restores the four shards
    byte for byte. The gf256_matmul launches are counted over the whole
    phase; its time at the drain tick's shape (1, 10, 1 MiB) comes after."""
    t_phase = time.perf_counter()
    (REPO / "build").mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke-online-", dir=REPO / "build")
    plan, pool = online_plan(nbytes, seed)
    vs = VolumeServer([work], device=dev, pulse_seconds=PULSE_S)
    vs.start()
    res = {}
    try:
        zero_launches()
        admin = Client(vs.url)
        check(admin.json("/admin/allocate_volume", {"volume": ONLINE_VID, "ecOnline": True})
              == {"ok": True}, "allocate_volume")
        v = vs.store.get_volume(ONLINE_VID)
        w = v.online_ec
        check(w is not None and w.block == geometry.SMALL_BLOCK_SIZE
              and w.codec.device == dev, "the online writer, its block and device")
        # 1. ingest over HTTP from 4 threads, each write pumping the writer
        errors = []

        def post(part) -> None:
            c = Client(vs.url)
            try:
                for fid, _, off, size in part:
                    status, out = c.request("POST", f"/{fid}", pool[off : off + size],
                                            {"Content-Type": "application/octet-stream"})
                    if status != 201:
                        errors.append(f"POST {fid} -> {status}: {out[:200]!r}")
                        return
            finally:
                c.close()

        threads = [threading.Thread(target=post, args=(plan[i::ONLINE_THREADS],))
                   for i in range(ONLINE_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        ingest_s = time.perf_counter() - t0
        check(not errors, f"ingest: {errors[:3]}")
        check(w.active, f"the writer degraded during ingest ({w.fallback_reason})")
        dat_size = v.size()
        # the pulse flushes the aged tail row (trickle_flush); nothing after
        time.sleep(2.0 + 2 * PULSE_S)
        stats = dict(w.stats())
        check(w._partial == dat_size % w.stripe and w.watermark + w._partial == dat_size,
              "the pulse's timed flush covered the tail row")
        # 2. a seeded sample read back
        rng = np.random.default_rng([seed, 10])
        for i in rng.choice(len(plan), size=min(ONLINE_SAMPLE, len(plan)), replace=False):
            fid, _, off, size = plan[i]
            status, out = admin.request("GET", f"/{fid}")
            check(status == 200 and out == pool[off : off + size], f"GET {fid}")
        # 3. the open shards over HTTP, and every parity row against the plain version
        rows = -(-dat_size // w.stripe)
        shard_bytes = rows * w.block
        base = v.base_name
        for shard in (12, 0):
            status, out = admin.request(
                "GET", f"/admin/ec/shard?volume={ONLINE_VID}&shard={shard}&offset=0"
                       f"&size={shard_bytes}")
            check(status == 200 and len(out) == shard_bytes, f"open shard {shard}")
            if shard >= 10:
                with open(base + geometry.to_ext(shard), "rb") as f:
                    check(out == f.read(shard_bytes), f"open shard {shard} != its file")
            else:
                dat = np.fromfile(base + ".dat", dtype=np.uint8)
                dat = np.concatenate([dat, np.zeros(rows * w.stripe - dat.size, np.uint8)])
                want = dat.reshape(rows, 10, w.block)[:, shard].tobytes()
                check(out == want, f"open shard {shard} != the .dat's column {shard}")
                del dat, want
        check_parity_rows(dev, base + ".dat", [base + geometry.to_ext(10 + p) for p in range(4)],
                          w.block, rows, "online")
        needles = {nid: v.nm.get(nid) for _, nid, _, _ in plan}
        # 4. the seal
        check(w.active and not w.sealed, "the writer is active before the seal")
        t0 = time.perf_counter()
        gen = admin.json("/admin/ec/generate", {"volume": ONLINE_VID})
        seal_s = time.perf_counter() - t0
        check(gen.get("online") is True, f"/admin/ec/generate answered {gen}")
        seal_rows = w.stripes - stats["stripes"]
        check(seal_rows <= 1, f"the seal encoded {seal_rows} rows, not at most the tail")
        shard_size = geometry.shard_file_size(dat_size, w.block, w.block)
        for s in range(14):
            check(os.path.getsize(base + geometry.to_ext(s)) == shard_size, f"sealed shard {s}")
        final = dict(w.stats())
        bad = {r: n for r, n in final["fallbacks"].items() if r in PATHOLOGICAL_REASONS}
        check(not bad, f"pathological fallbacks {bad}")
        # 5. drop the source volume, lose data shards 0-3, remount, read degraded
        check(admin.json("/admin/ec/delete_volume", {"volume": ONLINE_VID}) == {"ok": True},
              "delete_volume")
        admin.json("/admin/ec/mount", {"volume": ONLINE_VID})
        for s in ONLINE_LOST:
            p = base + geometry.to_ext(s)
            os.replace(p, p + ".orig")
        mounted = admin.json("/admin/ec/mount", {"volume": ONLINE_VID})
        check(mounted["shards"] == [s for s in range(14) if s not in ONLINE_LOST],
              f"remounted shards {mounted}")
        on_lost = []
        for fid, nid, off, size in plan:
            noff, nsize = needles[nid]
            ivs = geometry.locate_data(w.block, w.block, 10 * shard_size, noff,
                                       get_actual_size(nsize, 3))
            if any(iv.to_shard_id_and_offset(w.block, w.block)[0] in ONLINE_LOST for iv in ivs):
                on_lost.append((fid, off, size))
        pick = rng.choice(len(on_lost), size=min(ONLINE_SAMPLE, len(on_lost)), replace=False)
        n0 = gf256_matmul.launches
        lat = []
        for i in pick:
            fid, off, size = on_lost[i]
            t0 = time.perf_counter()
            status, out = admin.request("GET", f"/{fid}")
            lat.append(time.perf_counter() - t0)
            check(status == 200 and out == pool[off : off + size], f"degraded GET {fid}")
        degraded_launches = gf256_matmul.launches - n0
        check(degraded_launches >= len(pick), "every degraded read reconstructed on the card")
        # 6. rebuild the lost shards
        t0 = time.perf_counter()
        reb = admin.json("/admin/ec/rebuild", {"volume": ONLINE_VID})
        rebuild_s = time.perf_counter() - t0
        check(reb["rebuilt"] == list(ONLINE_LOST), f"rebuilt {reb}")
        for s in ONLINE_LOST:
            p = base + geometry.to_ext(s)
            check(same_file(p, p + ".orig"), f"rebuilt shard {s} differs")
        admin.close()
        launches = gf256_matmul.launches
        lat_ms = np.array(lat) * 1e3
        res = dict(
            needles=len(plan), payload_bytes=nbytes, dat_bytes=dat_size, threads=ONLINE_THREADS,
            ingest_s=ingest_s, ingest_gbps=nbytes / ingest_s / 1e9,
            ec_online_encode_gbps=final["encoded_bytes"] / final["encode_seconds"] / 1e9,
            encoded_bytes=final["encoded_bytes"], encode_seconds=final["encode_seconds"],
            write_amplification=(dat_size + final["parity_bytes"]) / dat_size,
            stripes=final["stripes"], block=w.block, fallbacks=final["fallbacks"],
            pathological_fallbacks=0, seal_ms=seal_s * 1e3, seal_rows=seal_rows,
            degraded_reads=len(lat), degraded_p50_ms=float(np.percentile(lat_ms, 50)),
            degraded_p99_ms=float(np.percentile(lat_ms, 99)),
            degraded_launches=degraded_launches,
            rebuild_s=rebuild_s, rebuild_gbps=10 * shard_size / rebuild_s / 1e9,
            launches=launches, sampled_reads_equal=True, parity_rows_equal_plain=rows,
            online_at_seal=True, rebuilt_shards_equal=True)
    finally:
        vs.stop()
        shutil.rmtree(work, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    check(res["launches"] > 0, "the online path launched no gf256_matmul kernel")
    # the kernel at one drain tick's shape, after the count
    (row,) = gf256_shape_times(dev, seed, gf256_matmul, shapes=(ONLINE_SHAPE,))
    res["kernel"] = row
    res["nvidia_smi"] = nvidia_smi()
    return res


CLUSTER_RACKS = ("r1", "r2", "r3", "r4")  # one port volume server a rack
CLUSTER_COLLECTION = "ec"
CLUSTER_THREADS = 4  # client threads assigning and POSTing needles
CLUSTER_SAMPLE = 256  # needles read through remote shards, and read degraded


class TimedEnv(CommandEnv):
    """The shell's command environment, summing the wall time of each admin
    POST by route: the split of a verb's wall."""

    def __init__(self, master_url: str) -> None:
        super().__init__(master_url)
        self.seconds: dict[str, float] = {}

    def post(self, url, payload=None, timeout=300):
        route = url.split("/admin/", 1)[-1]
        t0 = time.perf_counter()
        try:
            return super().post(url, payload, timeout)
        finally:
            self.seconds[route] = self.seconds.get(route, 0.0) + time.perf_counter() - t0


def cluster_phase(dev: torch.device, nbytes: int, seed: int) -> dict:
    """BASELINE configs 1 and 2 as shell verbs over a port cluster on the
    card: one MasterServer (pulse 1 s) and four VolumeServers on cuda, racks
    r1-r4, in this process. `nbytes` of seeded needles (online_plan's sizes)
    go through /dir/assign?collection=ec and POSTs from 4 threads; every
    .dat is copied aside; `lock` and `ec.encode -collection ec` spread each
    volume's 14 shards 4/4/3/3 and drop the volume; every parity row equals
    the plain version on the card over the saved .dat; 256 sampled GETs to
    the assigned urls read equal (mostly through /admin/ec/shard); one
    server that holds a data shard of every volume loses its shards, and
    256 GETs of needles on them read equal from the others (remote fan-in
    and reconstruct on the card); `ec.rebuild` restores the lost shards
    byte for byte; `ec.decode` restores every .dat byte for byte, and the
    sampled needles read back from /dir/lookup's location. The
    gf256_matmul launches are counted over the whole phase."""
    t_phase = time.perf_counter()
    (REPO / "build").mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke-cluster-", dir=REPO / "build")
    plan, pool = online_plan(nbytes, seed)
    master = MasterServer(port=0, pulse_seconds=1)
    master.start()
    servers = []
    res = {}
    try:
        for i, rack in enumerate(CLUSTER_RACKS):
            vs = VolumeServer([os.path.join(root, f"v{i}")], master.url, rack=rack,
                              pulse_seconds=PULSE_S, device=dev)
            vs.start()
            servers.append(vs)
            check(vs.device.type == "cuda" and vs.store.device.type == "cuda",
                  f"volume server {i} runs on {vs.device}, not cuda")
        by_url = {vs.url.split("//", 1)[1]: vs for vs in servers}
        env = TimedEnv(master.url)
        zero_launches()
        # 1. ingest: assign from the master, POST to the volume server it names
        written = [None] * len(plan)
        errors = []

        def ingest(idx) -> None:
            m = Client(master.url)
            conns = {}
            try:
                for i in idx:
                    _, _, off, size = plan[i]
                    status, out = m.request("GET", f"/dir/assign?collection={CLUSTER_COLLECTION}")
                    if status != 200:
                        errors.append(f"assign -> {status}: {out[:200]!r}")
                        return
                    a = json.loads(out)
                    c = conns.get(a["url"]) or conns.setdefault(a["url"], Client(f"http://{a['url']}"))
                    status, out = c.request("POST", f"/{a['fid']}", pool[off : off + size],
                                            {"Content-Type": "application/octet-stream"})
                    if status != 201:
                        errors.append(f"POST {a['fid']} -> {status}: {out[:200]!r}")
                        return
                    written[i] = (a["fid"], a["url"], off, size)
            finally:
                m.close()
                for c in conns.values():
                    c.close()

        threads = [threading.Thread(target=ingest, args=(range(i, len(plan), CLUSTER_THREADS),))
                   for i in range(CLUSTER_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        ingest_s = time.perf_counter() - t0
        check(not errors and all(written), f"cluster ingest: {errors[:3]}")
        # 2. every .dat aside (the oracle of the decode), and each needle's place
        oracle = os.path.join(root, "oracle")
        os.mkdir(oracle)
        vols = {}  # vid -> (.dat bytes, saved copy)
        needles = []  # (fid, url, off, size, vid, .dat offset, stored size)
        for vs in servers:
            for vid in vs.store.volume_ids():
                v = vs.store.get_volume(vid)
                check(v.collection == CLUSTER_COLLECTION, f"volume {vid} in {v.collection!r}")
                copy = os.path.join(oracle, f"{vid}.dat")
                shutil.copyfile(v.base_name + ".dat", copy)
                vols[vid] = (os.path.getsize(copy), copy)
        for fid, url, off, size in written:
            vid = int(fid.split(",")[0])
            nid, _ = file_id.parse_needle_id_cookie(fid.split(",")[1])
            noff, nsize = by_url[url].store.get_volume(vid).nm.get(nid)
            needles.append((fid, url, off, size, vid, noff, nsize))
        dat_bytes = sum(n for n, _ in vols.values())
        # 3. lock, ec.encode of the collection; 14 shards a volume, no replica left
        check(run_command(env, "lock") == "lock acquired", "lock")
        env.seconds.clear()
        n0 = gf256_matmul.launches
        t0 = time.perf_counter()
        out = run_command(env, f"ec.encode -collection {CLUSTER_COLLECTION}")
        encode_s = time.perf_counter() - t0
        encode_launches = gf256_matmul.launches - n0
        sec = env.seconds
        encode_split = {
            "readonly": sec.get("volume/readonly", 0.0),
            "generate": sec.get("ec/generate", 0.0), "copy": sec.get("ec/copy", 0.0),
            "delete": sec.get("ec/delete_shards", 0.0) + sec.get("ec/delete_volume", 0.0),
            "mount": sec.get("ec/mount", 0.0)}
        check(out.count("shards spread") == len(vols), f"ec.encode: {out[:300]}")
        check(encode_launches > 0, "ec.encode launched no gf256_matmul kernel")
        views = env.servers()
        check(not any(sv.volumes for sv in views), "a replica of an encoded volume is left")
        placement = {}
        for vid in vols:
            held = {sv.url: sorted(sv.ec_shards.get(vid, [])) for sv in views}
            check(sorted(s for shards in held.values() for s in shards) == list(range(14)),
                  f"volume {vid}: shards mounted {held}")
            check(sorted(len(x) for x in held.values()) == [3, 3, 4, 4],
                  f"volume {vid}: not spread 4/4/3/3: {held}")
            placement[vid] = held

        def shard_path(vid: int, shard: int) -> str:
            (url,) = [u for u, shards in placement[vid].items() if shard in shards]
            d = by_url[url].store.locations[0].directory
            return os.path.join(d, f"{CLUSTER_COLLECTION}_{vid}{geometry.to_ext(shard)}")

        parity_rows = 0
        for vid, (size, copy) in vols.items():
            rows = -(-size // (10 * geometry.SMALL_BLOCK_SIZE))
            check(size < 10 * geometry.LARGE_BLOCK_SIZE, "a volume reached a large row")
            check_parity_rows(dev, copy, [shard_path(vid, 10 + p) for p in range(4)],
                              geometry.SMALL_BLOCK_SIZE, rows, f"cluster volume {vid}")
            parity_rows += rows
        # 4. sampled GETs at the assigned urls, mostly through remote shards
        rng = np.random.default_rng([seed, 11])
        clients = {url: Client(f"http://{url}") for url in by_url}
        try:
            remote_lat = []
            for i in rng.choice(len(needles), size=min(CLUSTER_SAMPLE, len(needles)),
                                replace=False):
                fid, url, off, size = needles[i][:4]
                t0 = time.perf_counter()
                status, got = clients[url].request("GET", f"/{fid}")
                remote_lat.append(time.perf_counter() - t0)
                check(status == 200 and got == pool[off : off + size], f"remote GET {fid}")
            # 5. lose one server's shards of every volume; GETs on them read degraded
            victim = next(
                url for url in by_url
                if all(any(s < 10 for s in placement[vid][url]) for vid in vols))
            lost_dir = os.path.join(root, "lost")
            os.mkdir(lost_dir)
            lost = {vid: placement[vid][victim] for vid in vols}
            for vid, shards in lost.items():
                for s in shards:
                    shutil.copyfile(shard_path(vid, s),
                                    os.path.join(lost_dir, f"{vid}{geometry.to_ext(s)}"))
                out = env.post(f"http://{victim}/admin/ec/delete_shards",
                               {"volume": vid, "collection": CLUSTER_COLLECTION,
                                "shards": shards, "delete_index": False})
                check(sorted(out["removed"]) == shards, f"delete_shards {vid}: {out}")
            others = [u for u in by_url if u != victim]
            on_lost = []
            for fid, url, off, size, vid, noff, nsize in needles:
                shard_size = geometry.shard_file_size(
                    vols[vid][0], geometry.LARGE_BLOCK_SIZE, geometry.SMALL_BLOCK_SIZE)
                ivs = geometry.locate_data(geometry.LARGE_BLOCK_SIZE, geometry.SMALL_BLOCK_SIZE,
                                           10 * shard_size, noff, get_actual_size(nsize, 3))
                if any(iv.to_shard_id_and_offset(geometry.LARGE_BLOCK_SIZE,
                                                 geometry.SMALL_BLOCK_SIZE)[0] in lost[vid]
                       for iv in ivs):
                    on_lost.append((fid, off, size))
            pick = rng.choice(len(on_lost), size=min(CLUSTER_SAMPLE, len(on_lost)),
                              replace=False)
            n0 = gf256_matmul.launches
            degraded_lat = []
            for j, i in enumerate(pick):
                fid, off, size = on_lost[i]
                t0 = time.perf_counter()
                status, got = clients[others[j % len(others)]].request("GET", f"/{fid}")
                degraded_lat.append(time.perf_counter() - t0)
                check(status == 200 and got == pool[off : off + size], f"degraded GET {fid}")
            degraded_launches = gf256_matmul.launches - n0
            check(degraded_launches >= len(pick),
                  "every degraded GET reconstructed on the card")
        finally:
            for c in clients.values():
                c.close()
        # 6. ec.rebuild of every volume; the rebuilt shards equal the lost ones
        n0 = gf256_matmul.launches
        t0 = time.perf_counter()
        for vid in vols:
            out = run_command(env, f"ec.rebuild -volumeId {vid} -collection {CLUSTER_COLLECTION}")
            check(f"rebuilt shards {lost[vid]}" in out, f"ec.rebuild {vid}: {out}")
        rebuild_s = time.perf_counter() - t0
        rebuild_launches = gf256_matmul.launches - n0
        check(rebuild_launches > 0, "ec.rebuild launched no gf256_matmul kernel")
        views = env.servers()
        for vid, shards in lost.items():
            placement[vid] = {sv.url: sorted(sv.ec_shards.get(vid, [])) for sv in views}
            for s in shards:
                check(same_file(shard_path(vid, s),
                                os.path.join(lost_dir, f"{vid}{geometry.to_ext(s)}")),
                      f"volume {vid}: rebuilt shard {s} differs from the lost one")
        rebuild_read = sum(10 * geometry.shard_file_size(
            n, geometry.LARGE_BLOCK_SIZE, geometry.SMALL_BLOCK_SIZE) for n, _ in vols.values())
        # 7. ec.decode of every volume; each .dat equals its copy, needles read back
        t0 = time.perf_counter()
        for vid in vols:
            out = run_command(env, f"ec.decode -volumeId {vid} -collection {CLUSTER_COLLECTION}")
            check("reconstructed" in out, f"ec.decode {vid}: {out}")
        decode_s = time.perf_counter() - t0
        for vid, (_, copy) in vols.items():
            (holder,) = [vs for vs in servers if vs.store.get_volume(vid) is not None]
            check(same_file(holder.store.get_volume(vid).base_name + ".dat", copy),
                  f"decoded volume {vid} differs from its .dat")
        for i in rng.choice(len(needles), size=min(CLUSTER_SAMPLE, len(needles)), replace=False):
            fid, _, off, size, vid = needles[i][:5]
            locs = env.locations(vid)
            check(len(locs) == 1, f"volume {vid} at {locs}")
            status, _, got = http_request("GET", f"http://{locs[0]}/{fid}")
            check(status == 200 and got == pool[off : off + size], f"decoded GET {fid}")
        check(run_command(env, "unlock") == "lock released", "unlock")
        launches = gf256_matmul.launches
        rl, dl = np.array(remote_lat) * 1e3, np.array(degraded_lat) * 1e3
        res = dict(
            servers=len(servers), racks=list(CLUSTER_RACKS), volumes=len(vols),
            needles=len(plan), payload_bytes=nbytes, dat_bytes=dat_bytes,
            threads=CLUSTER_THREADS, ingest_s=ingest_s, ingest_gbps=nbytes / ingest_s / 1e9,
            encode_s=encode_s, encode_gbps=dat_bytes / encode_s / 1e9,
            encode_split_s=encode_split, encode_launches=encode_launches,
            parity_rows_equal_plain=parity_rows,
            remote_reads=len(remote_lat), remote_p50_ms=float(np.percentile(rl, 50)),
            remote_p99_ms=float(np.percentile(rl, 99)),
            victim=victim, lost_shards={str(k): v for k, v in lost.items()},
            degraded_reads=len(degraded_lat), degraded_p50_ms=float(np.percentile(dl, 50)),
            degraded_p99_ms=float(np.percentile(dl, 99)), degraded_launches=degraded_launches,
            rebuild_s=rebuild_s, rebuild_read_bytes=rebuild_read,
            rebuild_gbps=rebuild_read / rebuild_s / 1e9, rebuild_launches=rebuild_launches,
            decode_s=decode_s, launches=launches, rebuilt_shards_equal=True,
            decoded_dats_equal=True, reads_equal=True)
    finally:
        for vs in servers:
            vs.stop()
        master.stop()
        shutil.rmtree(root, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    check(res["launches"] > 0, "the cluster path launched no gf256_matmul kernel")
    res["nvidia_smi"] = nvidia_smi()
    return res


HASH_WRAPPERS = {
    "crc32c_batch": crc32c_batch_kernel,
    "md5_batch": md5_batch_kernel,
    "gear_hash": cdc.gear_hash_kernel,
}
WRAPPERS = {"gf256_matmul": gf256_matmul, **HASH_WRAPPERS}
KERNEL_ROWS = {  # name -> (source, the JAX device function it replaces, what it computes)
    "gf256_matmul": ("gf256_matmul.cu", "seaweedfs_tpu/ops/rs_pallas.py:74", "a GF(2^8) matmul"),
    "crc32c_batch": ("crc32c_batch.cu", "seaweedfs_tpu/ops/crc32c_kernel.py:75", "CRC32C"),
    "md5_batch": ("md5_batch.cu", "seaweedfs_tpu/ops/md5_kernel.py:36", "MD5"),
    "gear_hash": ("gear_hash.cu", "seaweedfs_tpu/ops/cdc.py:51", "a gear hash"),
}


def zero_launches() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def read_launches() -> dict:
    return {name: w.launches for name, w in WRAPPERS.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--volume-mib", type=int, default=1024)
    ap.add_argument("--upload-blobs", type=int, default=1 << 20)
    ap.add_argument("--chunked-mib", type=int, default=1024)
    ap.add_argument("--cdc-uploads", type=int, default=64)
    ap.add_argument("--stream-mib", type=int, default=1024)
    ap.add_argument("--dedup-gib", type=int, default=8)
    ap.add_argument("--online-mib", type=int, default=1024)
    ap.add_argument("--cluster-mib", type=int, default=1024)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    # the MD5 chain model assumes a 1.98 GHz SM clock; the card's maximum is
    # printed beside the name
    emit("device", nvidia_smi=smi, name=kind, count=torch.cuda.device_count(),
         sm_clock_max=nvidia_smi("clocks.max.sm"), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    logs = _build.build()
    for src in _build.SOURCES:
        _build.load(src)
    # the MD5 bound counts the integer operations of one block as the card
    # runs them (about 4 a round: LOP3, IADD3, IMAD.IADD, LEA.HI)
    md5_block = sass_loop_ops(_build.MD5_BATCH, "md5_batch_kernel")
    # a pipelined loop may move the first backward branch: it must still
    # span one 64-byte block (64 rounds), or the bound would change meaning
    check(MD5_BLOCK_OPS[0] <= md5_block["ops"] <= MD5_BLOCK_OPS[1],
          f"md5_batch_kernel's first loop holds {md5_block['ops']} integer instructions, "
          f"not one 64-byte block ({MD5_BLOCK_OPS[0]}-{MD5_BLOCK_OPS[1]})")
    # gf256_matmul's lookups: one packed LDS per input byte for four rows
    gf_unit = sass_loop_ops(_build.GF256_MATMUL, GF_UNIT_INSTANCE, pick="most_lds")
    check(gf_unit["lds"] == GF_UNIT_LDS,
          f"gf256_matmul_kernel<4, 10>'s unit loop holds {gf_unit['lds']} shared-memory loads, "
          f"not {GF_UNIT_LDS} (one a byte for 10 columns x 16 bytes)")
    emit("build", seconds=time.perf_counter() - t0,
         sources=[s.file for s in _build.SOURCES],
         ptxas={k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln]
                for k, v in logs.items()},
         md5_block_sass=md5_block, gf256_unit_sass=gf_unit)

    timed = {"gf256_matmul": kernel_phase(dev, args.seed)}
    timed.update(hash_kernel_phase(dev, args.seed, md5_block["ops"]))

    launches = {}
    (REPO / "build").mkdir(exist_ok=True)  # git-ignored scratch beside the checkout
    work = tempfile.mkdtemp(prefix="chip_smoke-", dir=REPO / "build")
    try:
        codec = RSCodec(device=dev)
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        res = main_path(work, codec, args.volume_mib * MIB, args.seed)
        ec = read_launches()
        launches["gf256_matmul"] = ec["gf256_matmul"]
        res["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        emit("main", launches_total=ec["gf256_matmul"], **res)
        check(ec["gf256_matmul"] > 0, "the main path launched no kernel")
        emit("profile", **profile_phase(work, codec))
        emit("cols", **cols_phase(work, codec, args.seed))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # the upload hashing paths, each counted over its own run: per-blob
    # submits, then a chunked upload
    svc = HashService(device=dev)
    svc.start()
    try:
        up = upload_phase(svc, args.upload_blobs, args.seed)
        emit("upload", **up)
        ch = chunked_phase(dev, svc, args.chunked_mib * MIB + 12345, args.seed)
        emit("chunked", **ch)
    finally:
        svc.stop()
    for name in ("crc32c_batch", "md5_batch"):
        launches[name] = up["launches"][name] + ch["launches"][name]
        check(up["launches"][name] > 0, f"the upload path launched no {name} kernel")
        check(ch["launches"][name] > 0, f"the chunked path launched no {name} kernel")
    timed["crc32c_batch"]["max_abs_err"] = max(timed["crc32c_batch"]["max_abs_err"],
                                               ch["crc_kernel_vs_plain_max_abs_err"])
    check(svc.failed_blobs == 0, "the hash service failed a batch")

    zero_launches()
    cd = cdc_phase(dev, args.cdc_uploads, args.stream_mib * MIB, args.seed)
    launches["gear_hash"] = read_launches()["gear_hash"]
    emit("cdc", launches=launches["gear_hash"], **cd)
    check(launches["gear_hash"] > 0, "the cdc path launched no gear_hash kernel")

    # the filer's dedup write path (BASELINE config 4); its own count
    dd = dedup_phase(dev, args.dedup_gib * 1024 * MIB // DEDUP_SEGMENT, args.seed)
    emit("dedup", **dd)
    launches["gear_hash"] += dd["gear_hash_launches"]

    # the volume server's online-EC write path; its own count
    on = online_phase(dev, args.online_mib * MIB, args.seed)
    emit("online", **on)
    launches["gf256_matmul"] += on["launches"]
    timed["gf256_matmul"]["shapes"].append(on["kernel"])

    # the shell's ec.* verbs over a master and four volume servers; its own count
    cl = cluster_phase(dev, args.cluster_mib * MIB, args.seed)
    emit("cluster", **cl)
    launches["gf256_matmul"] += cl["launches"]

    fn, (example,) = entry()
    got = fn(example).cpu().numpy()
    want = RSCodec(device="cpu").encode(example.cpu().numpy())
    check(got.shape == (4, 256 * 1024) and np.array_equal(got, want), "entry()")
    emit("entry", shape=list(got.shape), matches_cpu=True)

    kernels = []
    for name, (src, replaces, computes) in KERNEL_ROWS.items():
        k = timed[name]
        kernels.append(dict(
            name=name, route="cuda", source=f"seaweedfs_tpu_torch/csrc/{src}",
            replaces=replaces, launches=launches[name], max_abs_err=k["max_abs_err"],
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=None,
            library=f"no single PyTorch call computes {computes}", matches_plain=True,
            shape=k["shape"], call_ms=k["call_ms"],
            **({"shapes": k["shapes"]} if "shapes" in k else {}),
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
