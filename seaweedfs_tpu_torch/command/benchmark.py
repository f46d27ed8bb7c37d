"""`weed-tpu benchmark`: self-contained write/read load generator with
latency percentiles (reference: `weed/command/benchmark.go:113-260`). The
port's copy of `seaweedfs_tpu/command/benchmark.py`, over the port's
`PooledHTTP`, with the same JSON report. It is the user's verb, not a
benchmark of the port."""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import random
import time


def _percentiles(samples: list[float]) -> dict:
    if not samples:
        return {}
    s = sorted(samples)

    def pct(p: float) -> float:
        return s[min(len(s) - 1, int(p * len(s)))]

    return {
        "p50_ms": round(pct(0.50) * 1000, 2),
        "p90_ms": round(pct(0.90) * 1000, 2),
        "p99_ms": round(pct(0.99) * 1000, 2),
        "max_ms": round(s[-1] * 1000, 2),
    }


def run(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="weed-tpu benchmark")
    p.add_argument("-master", default="http://127.0.0.1:9333")
    p.add_argument("-n", type=int, default=1000, help="number of files")
    p.add_argument("-size", type=int, default=1024, help="file size bytes")
    p.add_argument("-c", type=int, default=16, help="concurrency")
    p.add_argument("-collection", default="benchmark")
    p.add_argument("-seed", type=int, default=0)
    p.add_argument(
        "-assignBatch", type=int, default=64,
        help="fids minted per master assign (count=N + fid_delta sub-fids); "
        "1 = one assign RPC per file",
    )
    opts = p.parse_args(args)
    report = run_benchmark(
        opts.master, n=opts.n, size=opts.size, c=opts.c,
        collection=opts.collection, seed=opts.seed,
        assign_batch=opts.assignBatch,
    )
    print(json.dumps(report, indent=2))
    return 0


def run_benchmark(
    master: str,
    n: int = 1000,
    size: int = 1024,
    c: int = 16,
    collection: str = "benchmark",
    seed: int = 0,
    assign_batch: int = 64,
) -> dict:
    """Write n files of `size` bytes at concurrency c, then read them back
    shuffled; returns the req/s + latency-percentile report (the reference's
    `weed benchmark` loop, `benchmark.go:113-260`).

    Assigns are batched: one `/dir/assign?count=N` mints N sequential fids
    (`fid`, `fid_1`, ... — the volume server resolves the `_delta` suffix,
    `needle.go:ParsePath`), so the allocation RPC amortizes across
    `assign_batch` uploads instead of doubling every write's round trips.
    Falls back to per-file assigns when the master mints per-fid write JWTs
    (a batch token would only cover the base fid)."""
    import types

    from seaweedfs_tpu_torch.server.httpd import PooledHTTP, peer_url

    opts = types.SimpleNamespace(
        master=master, n=n, size=size, c=c, collection=collection, seed=seed
    )
    assign_batch = max(1, assign_batch)
    masters = [peer_url(u).rstrip("/") for u in opts.master.split(",") if u]
    state = {"master": masters[0]}
    pool = PooledHTTP()  # keep-alive per worker thread, like the Go client
    rng = random.Random(opts.seed)
    payload = bytes(rng.randrange(256) for _ in range(opts.size))

    def assign(count: int = 1) -> dict:
        for _ in range(len(masters) + 2):  # follow raft leader hints
            status, _, body = pool.request(
                "GET",
                f"{state['master']}/dir/assign?count={count}"
                f"&collection={opts.collection}",
            )
            if status >= 400:
                try:
                    out = json.loads(body)
                except ValueError:
                    raise IOError(f"assign -> {status}: {body[:120]!r}")
                leader = out.get("leader")
                if out.get("error") == "raft.not.leader" and leader:
                    state["master"] = peer_url(leader).rstrip("/")
                    continue
                raise IOError(f"assign -> {status}: {out}")
            out = json.loads(body)
            if out.get("error"):
                raise IOError(f"assign: {out['error']}")
            return out
        raise IOError("assign: no leader found")

    write_lat: list[float] = []
    fids: list[str] = []

    import collections
    import threading

    fid_pool: collections.deque = collections.deque()
    fid_lock = threading.Lock()
    batching = {"on": assign_batch > 1}

    def next_fid() -> tuple[str, str, str | None]:
        """One pre-minted (fid, location, auth) — refills with a single
        count=assign_batch RPC when the pool runs dry. Once batching is
        OFF, assigns run per-call OUTSIDE the lock: holding it across the
        RPC would serialize all c workers behind one master round-trip
        (worse than the unbatched client this replaces)."""
        if not batching["on"]:
            a = assign(count=1)
            return a["fid"], a["publicUrl"], a.get("auth")
        with fid_lock:
            if batching["on"] and not fid_pool:
                a = assign(count=assign_batch)
                base, loc = a["fid"], a["publicUrl"]
                got = int(a.get("count", 1))
                if a.get("auth") or got < 2:
                    # per-fid JWT (or a master that ignored count): the
                    # delta sub-fids would be unauthorized/unminted
                    batching["on"] = False
                    fid_pool.append((base, loc, a.get("auth")))
                else:
                    fid_pool.extend(
                        (base if i == 0 else f"{base}_{i}", loc, None)
                        for i in range(got)
                    )
            if fid_pool:
                return fid_pool.popleft()
        a = assign(count=1)  # batching just disabled and the pool drained
        return a["fid"], a["publicUrl"], a.get("auth")

    def do_write(i: int):
        t0 = time.perf_counter()
        fid, loc, auth = next_fid()
        url = f"{peer_url(loc)}/{fid}"
        headers = {}
        if auth:
            headers["Authorization"] = f"BEARER {auth}"
        status, _, body = pool.request("POST", url, payload, headers)
        if status >= 300:
            raise IOError(f"upload -> {status}: {body[:120]!r}")
        # remember the volume location: the reader reuses it instead of
        # paying a lookup per read (the Go benchmark caches locations too)
        return fid, loc, time.perf_counter() - t0

    t_start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(opts.c) as ex:
        for fid, loc, dt in ex.map(do_write, range(opts.n)):
            fids.append((fid, loc))
            write_lat.append(dt)
    write_wall = time.perf_counter() - t_start

    read_lat: list[float] = []

    def do_read(item):
        fid, loc = item
        t0 = time.perf_counter()
        status, _, data = pool.request("GET", f"{peer_url(loc)}/{fid}")
        assert status == 200 and len(data) == opts.size, (status, len(data))
        return time.perf_counter() - t0

    order = fids[:]
    rng.shuffle(order)
    t_start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(opts.c) as ex:
        read_lat = list(ex.map(do_read, order))
    read_wall = time.perf_counter() - t_start

    return {
        "write": {
            "requests": opts.n,
            "req_per_sec": round(opts.n / write_wall, 1),
            "mb_per_sec": round(opts.n * opts.size / write_wall / 1e6, 2),
            **_percentiles(write_lat),
        },
        "read": {
            "requests": len(order),
            "req_per_sec": round(len(order) / read_wall, 1),
            "mb_per_sec": round(len(order) * opts.size / read_wall / 1e6, 2),
            **_percentiles(read_lat),
        },
    }
