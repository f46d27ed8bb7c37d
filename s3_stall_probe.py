#!/usr/bin/env python3
"""Look for the S3 stall of ROADMAP Queue 3 on one GPU.

    python3 s3_stall_probe.py [--old-seconds 120] [--seconds 60] [--seeds 1,2,3]

Runs chip_smoke.py's s3 phase (warp's mix, 256 x 10 MiB objects, 20
clients) first once in the configuration whose full runs each stalled one
GET past 30 s: a new client connection a request and urllib (a new
connection a call) at the gateway's filer hop. Then once a seed as the
port stands. The phase's watchdog prints every thread's stack to stderr
once an op is in flight past 12 s, and the phase fails on such an op;
here the dump also holds the TCP sockets' states from /proc/net/tcp
(counts by state, the accept queues, and for each connect still in
SYN_SENT the state of the socket that holds the same port pair, if any)
and the TcpExt counters, which are printed at each run's start too.
Prints one JSON line a run (throughput, latency by operation, the
slowest prepopulation PUT, the device's idle share, the MD5 kernel beside
its chain model and hashlib on the host), or the run's failure, then the
card's name and power limit. Exits non-zero when CUDA is not available.
"""

from __future__ import annotations

import argparse
import collections
import http.client
import json
import sys
import traceback

import torch

import chip_smoke as cs
from seaweedfs_tpu_torch.filer.filer_client import FilerClient
from seaweedfs_tpu_torch.ops import _build
from seaweedfs_tpu_torch.server.httpd import http_request


def summary(res: dict) -> dict:
    keep = {k: res.get(k) for k in ("obj_per_s", "mib_per_s", "ops", "errors", "statuses",
                                     "stalled_ops", "prepopulate_gbps", "prepopulate_max_ms",
                                     "multipart_gbps", "iam_reload_ms", "wall_s",
                                     "window_launches")}
    keep["per_op"] = res["per_op"]
    keep["device_idle_share"] = res["profiled"]["device_idle_share"]
    keep["md5_batch"] = [{k: r.get(k) for k in ("shape", "ms", "chain_ms", "host_ms")}
                         for r in res["hash_kernels"]["md5_batch"]]
    return keep


TCP_STATES = {"01": "ESTABLISHED", "02": "SYN_SENT", "03": "SYN_RECV", "04": "FIN_WAIT1",
              "05": "FIN_WAIT2", "06": "TIME_WAIT", "07": "CLOSE", "08": "CLOSE_WAIT",
              "09": "LAST_ACK", "0A": "LISTEN", "0B": "CLOSING"}
SYSCTLS = ("net/ipv4/tcp_tw_reuse", "net/ipv4/ip_local_port_range", "net/core/somaxconn",
           "net/ipv4/tcp_max_syn_backlog", "net/ipv4/tcp_syncookies",
           "net/ipv4/tcp_timestamps", "net/ipv4/tcp_fin_timeout")


def read(path: str) -> str | None:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


def tcp_ext() -> dict:
    """/proc/net/netstat's TcpExt counters that are not zero."""
    lines = (read("/proc/net/netstat") or "").splitlines()
    rows = [ln.split()[1:] for ln in lines if ln.startswith("TcpExt:")]
    if len(rows) < 2:
        return {}
    return {k: int(v) for k, v in zip(*rows[:2]) if v != "0"}


def tcp_sockets() -> dict:
    """Loopback sockets by state, the listeners' accept queues (length and
    limit), and each SYN_SENT port pair beside its reverse's state."""
    socks = []  # (local port, remote port, state, tx_queue, rx_queue)
    for path in ("/proc/net/tcp", "/proc/net/tcp6"):
        for ln in (read(path) or "").splitlines()[1:]:
            f = ln.split()
            if len(f) < 5:
                continue
            tx, rx = (int(x, 16) for x in f[4].split(":"))
            socks.append((int(f[1].rsplit(":", 1)[1], 16), int(f[2].rsplit(":", 1)[1], 16),
                          TCP_STATES.get(f[3], f[3]), tx, rx))
    by_pair = {(lp, rp): st for lp, rp, st, _, _ in socks}
    return {
        "by_state": dict(collections.Counter(st for _, _, st, _, _ in socks)),
        "listen_queues": {lp: [rx, tx] for lp, _, st, tx, rx in socks if st == "LISTEN"},
        "syn_sent": [[lp, rp, by_pair.get((rp, lp))] for lp, rp, st, _, _ in socks
                     if st == "SYN_SENT"],
    }


def tcp_report() -> str:
    return json.dumps({"tcp_sockets": tcp_sockets(), "tcp_ext": tcp_ext()})


def urllib_send(self, method, url, data=None, headers=None):
    """The JAX FilerClient's hop: urllib, a new connection a call."""
    return http_request(method, url, data, headers or {})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-seconds", type=float, default=120.0)  # 0: not run
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--seeds", default="1,2,3")  # empty: none
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("s3_stall_probe: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    _build.build()
    for src in _build.SOURCES:
        _build.load(src)
    md5_ops = cs.sass_loop_ops(_build.MD5_BATCH, "md5_batch_kernel")["ops"]
    pooled_send, keep_alive = FilerClient._send, cs.SignedConn.request
    print(json.dumps({"sysctl": {k: (read(f"/proc/sys/{k}") or "").strip() or None
                                 for k in SYSCTLS}}), flush=True)
    stacks = cs.thread_stacks
    cs.thread_stacks = lambda: stacks() + "--- tcp\n" + tcp_report() + "\n"

    def fresh_request(self, method, path, body=b""):
        self.conn.close()
        self.conn = http.client.HTTPConnection(self.conn.host, self.conn.port,
                                               timeout=cs.S3_CLIENT_TIMEOUT_S)
        return keep_alive(self, method, path, body)

    runs = [("connection a request", 100, args.old_seconds)] if args.old_seconds else []
    runs += [("as the port stands", int(seed), args.seconds)
             for seed in args.seeds.split(",") if seed]
    failed = False
    for config, seed, seconds in runs:
        old = config == "connection a request"
        FilerClient._send = urllib_send if old else pooled_send
        cs.SignedConn.request = fresh_request if old else keep_alive
        print(f"=== {config}, seed {seed}: {tcp_report()}", file=sys.stderr, flush=True)
        try:
            res = summary(cs.s3_phase(dev, 256, seconds, 20, 64 * cs.MIB, md5_ops, seed))
        except Exception:
            failed = True
            res = {"failed": traceback.format_exc()[-2000:]}
        print(json.dumps({"config": config, "seed": seed, "seconds": seconds, **res}),
              flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
