#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (seaweedfs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--volume-mib MIB]

Phases, one JSON line each; any failure raises and the exit code is not 0:
  1. device   nvidia-smi name and power limit, torch's device name
  2. build    every native source of the port compiled at once (nvcc, g++)
  3. kernel   gf256_matmul held byte for byte against its plain PyTorch
              version on the card (parity, decode and random matrices up to
              14x14, ragged and unaligned lengths, the 32 MiB pipeline
              batch), against the numpy oracle on a 64 KiB slice, and timed
              at the main path's batch beside its bound
  4. main     the EC main path on a volume of --volume-mib (1 GiB) written
              from --seed, at the reference geometry: write_ec_files, parity
              spot checks, rebuild of shards {2,5,11,13}, 256 degraded
              read_needle calls with data shards {1,4,7,9} missing, rebuild
              of those, write_dat_file back to a byte-identical .dat
     profile  a warm re-encode of that volume, then one under torch.profiler:
              device time of kernel and copies, the device's idle share
  5. cols     a small volume at 1 MiB / 64 KiB blocks through the schedule's
              column-split jobs, byte-identical to a CPU plain encode
  6. entry    entry() on the card equal to the CPU codec
Then the {"kernels": [...]} line, the card's name and power limit, and the
last line {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when CUDA is not available.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from seaweedfs_tpu_torch.entry import entry
from seaweedfs_tpu_torch.ops import _build, gf256
from seaweedfs_tpu_torch.ops.rs_cuda import gf256_matmul, gf_matmul_torch
from seaweedfs_tpu_torch.ops.rs_kernel import RSCodec
from seaweedfs_tpu_torch.storage import crc
from seaweedfs_tpu_torch.storage.erasure_coding import decoder, encoder, geometry
from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import EcVolume
from seaweedfs_tpu_torch.storage.needle import Needle, get_actual_size
from seaweedfs_tpu_torch.storage.volume import Volume

REPO = Path(__file__).resolve().parent
MIB = 1024 * 1024
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM scalar float32 peak, the table's non-tensor rate
REBUILD_LOST = (2, 5, 11, 13)
DEGRADED_LOST = (1, 4, 7, 9)
DEGRADED_READS = 256


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


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


def time_cuda(fn, warmup: int = 5, reps: int = 20) -> float:
    """Median milliseconds of fn() over reps launches, by CUDA events."""
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

    # a 64 KiB slice against the numpy oracle
    for name, m in (matrices[0], matrices[7], matrices[11]):
        x = rand((m.shape[1], 64 * 1024))
        got = gf256_matmul(m, x).cpu().numpy()
        check(np.array_equal(got, gf256.gf_matmul_bytes(m, x.cpu().numpy())),
              f"kernel != gf_matmul_bytes for {name}")
        cases += 1

    # time at the encode batch: 320 MiB in, 128 MiB out, cold in L2 (50 MB)
    ms = time_cuda(lambda: gf256_matmul(parity, batch))
    x2 = batch.permute(1, 0, 2).reshape(10, -1)
    plain_ms = time_cuda(lambda: gf_matmul_torch(parity, x2), warmup=1, reps=3)
    b_ms, b_by = bound_ms(4, 10, 32 * MIB)
    emit("kernel", cases=cases, max_abs_err=max_err, shape=[32, 10, MIB],
         ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
         kernel_gbps=(14 * 32 * MIB) / ms / 1e6, bound_share=b_ms / ms,
         library_ms=None, library="no single PyTorch call computes a GF(2^8) matmul")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--volume-mib", type=int, default=1024)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, name=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    logs = _build.build()
    for src in _build.SOURCES:
        _build.load(src)
    emit("build", seconds=time.perf_counter() - t0,
         sources=[s.file for s in _build.SOURCES],
         ptxas={k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln]
                for k, v in logs.items()})

    kern = kernel_phase(dev, args.seed)

    (REPO / "build").mkdir(exist_ok=True)  # git-ignored scratch beside the checkout
    work = tempfile.mkdtemp(prefix="chip_smoke-", dir=REPO / "build")
    try:
        codec = RSCodec(device=dev)
        gf256_matmul.launches = 0
        torch.cuda.reset_peak_memory_stats()
        res = main_path(work, codec, args.volume_mib * MIB, args.seed)
        main_launches = gf256_matmul.launches
        res["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        emit("main", launches_total=main_launches, **res)
        check(main_launches > 0, "the main path launched no kernel")
        emit("profile", **profile_phase(work, codec))
        emit("cols", **cols_phase(work, codec, args.seed))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    fn, (example,) = entry()
    got = fn(example).cpu().numpy()
    want = RSCodec(device="cpu").encode(example.cpu().numpy())
    check(got.shape == (4, 256 * 1024) and np.array_equal(got, want), "entry()")
    emit("entry", shape=list(got.shape), matches_cpu=True)

    print(json.dumps({"kernels": [dict(
        name="gf256_matmul", route="cuda",
        source="seaweedfs_tpu_torch/csrc/gf256_matmul.cu",
        replaces="seaweedfs_tpu/ops/rs_pallas.py:74",
        launches=main_launches, max_abs_err=kern["max_abs_err"],
        ms=kern["ms"], plain_ms=kern["plain_ms"], bound_ms=kern["bound_ms"],
        bound_by=kern["bound_by"], library_ms=None, matches_plain=True,
    )]}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
