"""Server subcommands: master / volume / filer / combined server
(reference: `weed/command/master.go`, `volume.go`, `filer.go`, `server.go`).

The port's copy of `seaweedfs_tpu/command/server_cmds.py`, over the port's
servers, with every flag of the JAX verbs. `volume`, `filer` and `server`
take one flag of the port's own, `-device`: a role runs on the CUDA card
unless `-device cpu` asks for the CPU, and without CUDA and without that
flag it exits non-zero with `resolve_device`'s message (there is no
fallback). On SIGINT or SIGTERM every verb stops the servers it started,
newest first, and exits 0.
"""

from __future__ import annotations

import argparse
import signal
import threading

from seaweedfs_tpu_torch.server.httpd import peer_url


def _load_security():
    """security.toml discovery once per process: JWT keys + IP guard for
    the servers, and the [tls] section installed process-wide (mTLS on
    every listener and outbound client, `weed/security/tls.go`)."""
    from seaweedfs_tpu_torch.security import load_security_config

    cfg = load_security_config()
    cfg.apply_tls()
    return cfg


def _wait_forever(*servers) -> int:
    """Block until SIGINT or SIGTERM, then stop `servers` newest first: a
    stopped server joins its own threads, so the interpreter exits with
    nothing left running."""
    stop = threading.Event()

    def handler(signum, frame):
        stop.set()

    signal.signal(signal.SIGINT, handler)
    signal.signal(signal.SIGTERM, handler)
    stop.wait()
    for srv in reversed(servers):
        srv.stop()
    return 0


def _add_device_flag(p) -> None:
    p.add_argument(
        "-device", default=None, choices=["cuda", "cpu"],
        help="device of the role's kernels: cuda (the default) or cpu."
             " Without a CUDA device and without -device cpu the role exits"
             " non-zero: there is no CPU fallback",
    )


def _resolve_device(opts):
    """The role's torch device; without one (no CUDA and no `-device cpu`)
    the process exits 1 with `resolve_device`'s message."""
    from seaweedfs_tpu_torch.ops.rs_kernel import resolve_device

    try:
        return resolve_device(opts.device)
    except RuntimeError as e:
        raise SystemExit(f"weed-tpu: {e} (-device cpu runs the role on the CPU)")


def _add_faults_flag(p) -> None:
    p.add_argument(
        "-faults", nargs="?", const="", default=None,
        help="enable fault injection for this process and optionally arm"
             " points at boot: point=mode[:k=v,...][;point=mode...] — e.g."
             " 'volume.read.dat=error:rate=0.5;master.assign=latency:ms=20'."
             " A bare -faults enables runtime control only"
             " (POST /debug/faults / cluster.faults); without the flag the"
             " runtime route 403s.",
    )


def _add_telemetry_flags(p) -> None:
    p.add_argument(
        "-telemetry.dir", dest="telemetry_dir", default=None,
        help="durable telemetry spool directory (stats/store.py):"
             " history samples + flight-recorder events persist in CRC'd"
             " segment files (5s raw -> 1m -> 10m rollups) and replay on"
             " restart, so /debug/metrics/history, /debug/events and"
             " cluster.why survive a crash; unset = in-memory only",
    )
    p.add_argument(
        "-telemetry.retention", dest="telemetry_retention", type=float,
        default=None,
        help="telemetry spool byte budget in MB (default 64), carved"
             " across the raw/1m/10m/event tiers; oldest segments evict"
             " first so the spool never fills the disk",
    )


def _add_qos_flag(p) -> None:
    p.add_argument(
        "-qos.limits", dest="qos_limits", default=None,
        help="arm QoS admission control (qos/admission.py) with"
             " per-collection token-bucket limits:"
             " 'tenant-a=100,tenant-b=50:200,*=25' (rps[:burst], '*' ="
             " default for unlisted tenants). Also starts the SLO-burn"
             " actuator; limits stay adjustable at runtime via"
             " POST /qos/limits and the cluster.qos shell verb. Unset ="
             " admission disarmed (one attribute check per request)",
    )


def _arm_faults(opts) -> None:
    if getattr(opts, "faults", None) is None:
        return
    from seaweedfs_tpu_torch.util import faults

    faults.enable()  # opt the process into runtime POST /debug/faults
    if opts.faults:
        armed = faults.arm_from_spec(opts.faults)
        print(f"fault injection armed: {', '.join(armed)}")


def run_master(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="weed-tpu master")
    p.add_argument("-port", type=int, default=9333)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-mdir", default=None, help="metadata dir (sequence state)")
    p.add_argument("-volumeSizeLimitMB", type=int, default=30 * 1024)
    p.add_argument("-defaultReplication", default="000")
    p.add_argument("-garbageThreshold", type=float, default=0.3)
    p.add_argument("-pulseSeconds", type=int, default=5)
    p.add_argument("-peers", default="",
                   help="comma-separated master urls (raft HA; include self)")
    p.add_argument("-slowMs", dest="slow_ms", type=float, default=None,
                   help="log requests slower than this many ms for this "
                        "server's role (overrides SEAWEEDFS_TPU_SLOW_MS)")
    p.add_argument("-maintenance", action="store_true",
                   help="run the autonomous maintenance daemon "
                        "(detect -> plan -> heal; off by default)")
    p.add_argument("-maintenance.dryRun", dest="maintenance_dry_run",
                   action="store_true",
                   help="maintenance plans repairs without executing them")
    p.add_argument("-maintenance.interval", dest="maintenance_interval",
                   type=float, default=None,
                   help="maintenance scan interval seconds "
                        "(default: pulseSeconds)")
    p.add_argument("-repair.lazyWindow", dest="repair_lazy_window",
                   type=float, default=0.0,
                   help="defer single-shard ec_rebuild dispatch up to this "
                        "many seconds so co-stripe losses coalesce into "
                        "one multi-target chain pass (0 = immediate)")
    p.add_argument("-ec.online", dest="ec_online", default="",
                   help="comma-separated collections whose volumes stream-"
                        "encode RS(10,4) parity on ingest ('*' = all); "
                        "replication degrades to parity-only for them")
    p.add_argument("-ec.online.block", dest="ec_online_block", type=int,
                   default=None,
                   help="online-EC stripe block bytes per shard "
                        "(default 1MB)")
    _add_telemetry_flags(p)
    _add_faults_flag(p)
    opts = p.parse_args(args)
    _arm_faults(opts)
    from seaweedfs_tpu_torch.server.master import MasterServer

    sec = _load_security()
    m = MasterServer(
        host=opts.ip,
        port=opts.port,
        volume_size_limit_mb=opts.volumeSizeLimitMB,
        pulse_seconds=opts.pulseSeconds,
        default_replication=opts.defaultReplication,
        meta_dir=opts.mdir,
        garbage_threshold=opts.garbageThreshold,
        security=sec,
        peers=[peer_url(u)
               for u in opts.peers.split(",") if u],
        raft_dir=opts.mdir,
        slow_ms=opts.slow_ms,
        maintenance=opts.maintenance or opts.maintenance_dry_run,
        maintenance_dry_run=opts.maintenance_dry_run,
        maintenance_interval=opts.maintenance_interval,
        repair_lazy_window=opts.repair_lazy_window,
        ec_online=opts.ec_online,
        ec_online_block=opts.ec_online_block,
        telemetry_dir=opts.telemetry_dir,
        telemetry_retention_mb=opts.telemetry_retention,
    )
    m.start()
    print(f"master listening at {m.url}", flush=True)
    return _wait_forever(m)


def run_volume(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="weed-tpu volume")
    p.add_argument("-port", type=int, default=8080)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-dir", default="./data", help="comma-separated data dirs")
    p.add_argument("-mserver", default="http://127.0.0.1:9333")
    p.add_argument("-dataCenter", default="")
    p.add_argument("-rack", default="")
    p.add_argument("-max", type=int, default=100)
    p.add_argument("-publicUrl", default="")
    p.add_argument("-pulseSeconds", type=int, default=5)
    p.add_argument("-localSocket", default=None,
                   help="also serve on this unix domain socket")
    p.add_argument("-slowMs", dest="slow_ms", type=float, default=None,
                   help="log requests slower than this many ms for this "
                        "server's role (overrides SEAWEEDFS_TPU_SLOW_MS)")
    p.add_argument("-scrub.interval", dest="scrub_interval", type=float,
                   default=0.0,
                   help="seconds between background integrity-scrub passes"
                        " (CRC every needle, parity-check EC stripes, sweep"
                        " rebuild tmp litter); 0 disables the loop —"
                        " /admin/scrub/run and volume.scrub still work")
    p.add_argument("-scrub.rate", dest="scrub_rate", type=float,
                   default=8.0,
                   help="scrub read-budget in MB/s (token bucket; scrubbing"
                        " never starves foreground traffic)")
    _add_telemetry_flags(p)
    _add_faults_flag(p)
    _add_device_flag(p)
    opts = p.parse_args(args)
    device = _resolve_device(opts)
    _arm_faults(opts)
    from seaweedfs_tpu_torch.server.volume import VolumeServer

    sec = _load_security()
    vs = VolumeServer(
        opts.dir.split(","),
        opts.mserver,
        security=sec,
        host=opts.ip,
        port=opts.port,
        public_url=opts.publicUrl,
        data_center=opts.dataCenter,
        rack=opts.rack,
        pulse_seconds=opts.pulseSeconds,
        max_volume_count=opts.max,
        local_socket=opts.localSocket,
        slow_ms=opts.slow_ms,
        scrub_interval=opts.scrub_interval,
        scrub_rate_mb=opts.scrub_rate,
        telemetry_dir=opts.telemetry_dir,
        telemetry_retention_mb=opts.telemetry_retention,
        device=device,
    )
    vs.start()
    print(f"volume server listening at {vs.url}", flush=True)
    return _wait_forever(vs)


def run_filer(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="weed-tpu filer")
    p.add_argument("-port", type=int, default=8888)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-master", default="http://127.0.0.1:9333")
    p.add_argument(
        "-store", default="memory", choices=["memory", "sqlite", "leveldb", "lsm", "redis", "etcd", "mysql", "postgres"]
    )
    p.add_argument("-storePath", default=None)
    p.add_argument("-maxMB", type=int, default=4, help="chunk size")
    p.add_argument("-collection", default="")
    p.add_argument("-defaultReplicaPlacement", default="")
    p.add_argument("-encryptVolumeData", action="store_true",
                   help="AES-GCM encrypt chunk data on volume servers")
    p.add_argument("-compressData", default="true", choices=["true", "false"],
                   help="gzip-compress compressible chunks")
    p.add_argument("-chunkCacheDir", default=None,
                   help="on-disk tiered chunk cache directory")
    p.add_argument("-notification.spool", dest="notification_spool",
                   default=None,
                   help="publish metadata events to this file-queue spool dir")
    p.add_argument("-peers", default="",
                   help="comma-separated peer filer urls (lock ring + meta sync)")
    p.add_argument("-dedup", action="store_true",
                   help="content-defined-chunking dedup on uploads "
                        "(filer/dedup.py; incompatible with cipher)")
    p.add_argument("-localSocket", default=None,
                   help="also serve on this unix domain socket "
                        "(same-host mounts skip TCP; -filer.localSocket)")
    p.add_argument("-slowMs", dest="slow_ms", type=float, default=None,
                   help="log requests slower than this many ms for this "
                        "server's role (overrides SEAWEEDFS_TPU_SLOW_MS)")
    _add_telemetry_flags(p)
    _add_faults_flag(p)
    _add_qos_flag(p)
    _add_device_flag(p)
    opts = p.parse_args(args)
    device = _resolve_device(opts)
    _arm_faults(opts)
    from seaweedfs_tpu_torch.server.filer import FilerServer

    sec = _load_security()
    queue = None
    if opts.notification_spool:
        from seaweedfs_tpu_torch.notification import FileQueue

        queue = FileQueue(opts.notification_spool)

    f = FilerServer(
        opts.master,
        host=opts.ip,
        port=opts.port,
        store_kind=opts.store,
        store_path=opts.storePath,
        local_socket=opts.localSocket,
        chunk_size_mb=opts.maxMB,
        default_replication=opts.defaultReplicaPlacement,
        collection=opts.collection,
        cipher=opts.encryptVolumeData,
        compress=opts.compressData == "true",
        chunk_cache_dir=opts.chunkCacheDir,
        notification_queue=queue,
        peers=[peer_url(u)
               for u in opts.peers.split(",") if u],
        dedup=opts.dedup,
        security=sec,
        slow_ms=opts.slow_ms,
        telemetry_dir=opts.telemetry_dir,
        telemetry_retention_mb=opts.telemetry_retention,
        qos_limits=opts.qos_limits,
        device=device,
    )
    f.start()
    print(f"filer listening at {f.url}", flush=True)
    return _wait_forever(f)


def run_server(args: list[str]) -> int:
    """Combined master + volume + filer (+S3) in one process
    (`weed/command/server.go`)."""
    p = argparse.ArgumentParser(prog="weed-tpu server")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-master.port", dest="master_port", type=int, default=9333)
    p.add_argument("-volume.port", dest="volume_port", type=int, default=8080)
    p.add_argument("-filer.port", dest="filer_port", type=int, default=8888)
    p.add_argument("-s3.port", dest="s3_port", type=int, default=8333)
    p.add_argument("-dir", default="./data")
    p.add_argument("-filer", action="store_true", help="also run filer")
    p.add_argument("-s3", action="store_true", help="also run S3 gateway")
    p.add_argument("-volumeSizeLimitMB", type=int, default=30 * 1024)
    p.add_argument("-defaultReplication", default="000")
    p.add_argument("-filer.store", dest="filer_store", default="memory")
    p.add_argument("-filer.storePath", dest="filer_store_path", default=None)
    p.add_argument("-filer.encryptVolumeData", dest="filer_cipher",
                   action="store_true")
    p.add_argument("-filer.compressData", dest="filer_compress",
                   default="true", choices=["true", "false"])
    p.add_argument("-filer.dedup", dest="filer_dedup", action="store_true",
                   help="content-defined-chunking dedup on filer uploads")
    p.add_argument("-s3.config", dest="s3_config", default=None,
                   help="identities json (s3.json)")
    p.add_argument("-maintenance", action="store_true",
                   help="run the autonomous maintenance daemon "
                        "(detect -> plan -> heal; off by default)")
    p.add_argument("-maintenance.dryRun", dest="maintenance_dry_run",
                   action="store_true",
                   help="maintenance plans repairs without executing them")
    p.add_argument("-maintenance.interval", dest="maintenance_interval",
                   type=float, default=None,
                   help="maintenance scan interval seconds "
                        "(default: pulseSeconds)")
    p.add_argument("-repair.lazyWindow", dest="repair_lazy_window",
                   type=float, default=0.0,
                   help="defer single-shard ec_rebuild dispatch up to this "
                        "many seconds so co-stripe losses coalesce into "
                        "one multi-target chain pass (0 = immediate)")
    p.add_argument("-ec.online", dest="ec_online", default="",
                   help="comma-separated collections whose volumes stream-"
                        "encode RS(10,4) parity on ingest ('*' = all)")
    p.add_argument("-ec.online.block", dest="ec_online_block", type=int,
                   default=None,
                   help="online-EC stripe block bytes per shard "
                        "(default 1MB)")
    p.add_argument("-scrub.interval", dest="scrub_interval", type=float,
                   default=0.0,
                   help="seconds between background integrity-scrub passes"
                        " on the volume server; 0 disables the loop")
    p.add_argument("-scrub.rate", dest="scrub_rate", type=float,
                   default=8.0,
                   help="scrub read-budget in MB/s (token bucket)")
    _add_telemetry_flags(p)
    _add_faults_flag(p)
    _add_qos_flag(p)
    _add_device_flag(p)
    opts = p.parse_args(args)
    device = _resolve_device(opts)
    _arm_faults(opts)

    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume import VolumeServer

    sec = _load_security()
    m = MasterServer(
        host=opts.ip,
        port=opts.master_port,
        volume_size_limit_mb=opts.volumeSizeLimitMB,
        default_replication=opts.defaultReplication,
        security=sec,
        maintenance=opts.maintenance or opts.maintenance_dry_run,
        maintenance_dry_run=opts.maintenance_dry_run,
        maintenance_interval=opts.maintenance_interval,
        repair_lazy_window=opts.repair_lazy_window,
        ec_online=opts.ec_online,
        ec_online_block=opts.ec_online_block,
        telemetry_dir=opts.telemetry_dir,
        telemetry_retention_mb=opts.telemetry_retention,
    )
    m.start()
    print(f"master listening at {m.url}", flush=True)
    started = [m]
    vs = VolumeServer(
        opts.dir.split(","), m.url, host=opts.ip, port=opts.volume_port,
        security=sec,
        scrub_interval=opts.scrub_interval,
        scrub_rate_mb=opts.scrub_rate,
        device=device,
    )
    vs.start()
    started.append(vs)
    print(f"volume server listening at {vs.url}", flush=True)
    if opts.filer or opts.s3:
        from seaweedfs_tpu_torch.server.filer import FilerServer

        f = FilerServer(
            m.url,
            host=opts.ip,
            port=opts.filer_port,
            store_kind=opts.filer_store,
            store_path=opts.filer_store_path,
            cipher=opts.filer_cipher,
            compress=opts.filer_compress == "true",
            dedup=opts.filer_dedup,
            security=sec,
            qos_limits=opts.qos_limits,
            device=device,
        )
        f.start()
        started.append(f)
        print(f"filer listening at {f.url}", flush=True)
        if opts.s3:
            import json as _json

            from seaweedfs_tpu_torch.s3api import S3Server

            config = None
            if opts.s3_config:
                with open(opts.s3_config) as fh:
                    config = _json.load(fh)
            s3 = S3Server(f.url, host=opts.ip, port=opts.s3_port,
                          config=config, master_url=m.url,
                          qos_limits=opts.qos_limits)
            s3.start()
            started.append(s3)
            print(f"s3 gateway listening at {s3.url}", flush=True)
    return _wait_forever(*started)


def run_iam(args: list[str]) -> int:
    """Standalone IAM API against a running filer (`weed/command/iam.go`)."""
    p = argparse.ArgumentParser(prog="weed-tpu iam")
    p.add_argument("-port", type=int, default=8111)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-filer", default="http://127.0.0.1:8888")
    opts = p.parse_args(args)
    from seaweedfs_tpu_torch.iamapi import IamServer

    _load_security()

    filer = opts.filer
    if not filer.startswith("http"):
        filer = peer_url(filer)
    srv = IamServer(filer, host=opts.ip, port=opts.port)
    srv.start()
    print(f"iam api listening at {srv.url}", flush=True)
    return _wait_forever(srv)


def run_s3(args: list[str]) -> int:
    """Standalone S3 gateway against a running filer
    (`weed/command/s3.go`)."""
    p = argparse.ArgumentParser(prog="weed-tpu s3")
    p.add_argument("-port", type=int, default=8333)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-filer", default="http://127.0.0.1:8888")
    p.add_argument("-master", default="",
                   help="master url: ship telemetry frames (usage sketch +"
                        " SLO counters) to the cluster aggregator")
    p.add_argument("-config", default=None, help="identities json (s3.json)")
    p.add_argument("-slowMs", dest="slow_ms", type=float, default=None,
                   help="log requests slower than this many ms for this "
                        "server's role (overrides SEAWEEDFS_TPU_SLOW_MS)")
    _add_telemetry_flags(p)
    _add_faults_flag(p)
    _add_qos_flag(p)
    opts = p.parse_args(args)
    _arm_faults(opts)
    _load_security()
    import json as _json

    from seaweedfs_tpu_torch.s3api import S3Server

    config = None
    if opts.config:
        with open(opts.config) as fh:
            config = _json.load(fh)
    filer = opts.filer
    if not filer.startswith("http"):
        filer = peer_url(filer)
    master = opts.master
    if master and not master.startswith("http"):
        master = peer_url(master)
    s3 = S3Server(filer, host=opts.ip, port=opts.port, config=config,
                  slow_ms=opts.slow_ms, master_url=master or None,
                  telemetry_dir=opts.telemetry_dir,
                  telemetry_retention_mb=opts.telemetry_retention,
                  qos_limits=opts.qos_limits)
    s3.start()
    print(f"s3 gateway listening at {s3.url}", flush=True)
    return _wait_forever(s3)


def run_webdav(args: list[str]) -> int:
    """WebDAV gateway against a running filer (`weed/command/webdav.go`)."""
    p = argparse.ArgumentParser(prog="weed-tpu webdav")
    p.add_argument("-port", type=int, default=7333)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-filer", default="http://127.0.0.1:8888")
    p.add_argument("-master", default="",
                   help="master url: ship telemetry frames (usage sketch +"
                        " SLO counters) to the cluster aggregator")
    p.add_argument("-readOnly", action="store_true")
    p.add_argument("-slowMs", dest="slow_ms", type=float, default=None,
                   help="log requests slower than this many ms for this "
                        "server's role (overrides SEAWEEDFS_TPU_SLOW_MS)")
    opts = p.parse_args(args)
    _load_security()
    from seaweedfs_tpu_torch.server.webdav import WebDavServer

    filer = opts.filer
    if not filer.startswith("http"):
        filer = peer_url(filer)
    master = opts.master
    if master and not master.startswith("http"):
        master = peer_url(master)
    srv = WebDavServer(filer, host=opts.ip, port=opts.port,
                       read_only=opts.readOnly, slow_ms=opts.slow_ms,
                       master_url=master or None)
    srv.start()
    print(f"webdav listening at {srv.url}", flush=True)
    return _wait_forever(srv)


def run_mq_broker(args: list[str]) -> int:
    """MQ broker against a running filer (`weed/command/mq_broker.go`)."""
    p = argparse.ArgumentParser(prog="weed-tpu mq.broker")
    p.add_argument("-port", type=int, default=17777)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-filer", default="http://127.0.0.1:8888")
    p.add_argument("-master", default="http://127.0.0.1:9333")
    p.add_argument("-peers", default="", help="comma-separated peer broker urls")
    opts = p.parse_args(args)
    _load_security()
    from seaweedfs_tpu_torch.mq import BrokerServer

    filer = opts.filer
    if not filer.startswith("http"):
        filer = peer_url(filer)
    srv = BrokerServer(
        filer, master_url=opts.master, host=opts.ip, port=opts.port,
        peers=[peer_url(u)
               for u in opts.peers.split(",") if u],
    )
    srv.start()
    print(f"mq broker listening at {srv.url}", flush=True)
    return _wait_forever(srv)


def run_mount(args: list[str]) -> int:
    """FUSE-mount a filer path (`weed/command/mount.go`). Needs /dev/fuse +
    CAP_SYS_ADMIN; otherwise explains and exits."""
    p = argparse.ArgumentParser(prog="weed-tpu mount")
    p.add_argument("-filer", default="http://127.0.0.1:8888")
    p.add_argument("-dir", required=True, help="mountpoint")
    p.add_argument("-readOnly", action="store_true")
    p.add_argument("-chunkCacheDir", default=None)
    p.add_argument("-quotaMB", type=int, default=0,
                   help="limit mounted usage; writes past it fail ENOSPC"
                        " (adjustable at runtime via mount.configure)")
    opts = p.parse_args(args)
    _load_security()
    from seaweedfs_tpu_torch.mount import WFS, mount_fs, start_admin_service

    filer = opts.filer
    if not filer.startswith("http"):
        filer = peer_url(filer)
    wfs = WFS(filer, read_only=opts.readOnly,
              chunk_cache_dir=opts.chunkCacheDir, quota_mb=opts.quotaMB)
    try:
        start_admin_service(wfs, opts.dir)  # mount.configure control point
        print(f"mounting {filer} at {opts.dir}")
        mount_fs(wfs, opts.dir)
    except (PermissionError, FileNotFoundError) as e:
        print(f"cannot mount: {e} (needs /dev/fuse and CAP_SYS_ADMIN)")
        return 1
    return 0


def run_ftp(args: list[str]) -> int:
    """FTP gateway against a running filer (reference ships only a stub —
    `weed/ftpd/ftp_server.go`; this one is wired)."""
    p = argparse.ArgumentParser(prog="weed-tpu ftp")
    p.add_argument("-port", type=int, default=2121)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-filer", default="http://127.0.0.1:8888")
    p.add_argument("-user", default="")
    p.add_argument("-password", default="")
    p.add_argument("-anonymous", action="store_true",
                   help="explicitly allow login without credentials")
    opts = p.parse_args(args)
    _load_security()
    from seaweedfs_tpu_torch.ftpd import FtpServer

    filer = opts.filer
    if not filer.startswith("http"):
        filer = peer_url(filer)
    srv = FtpServer(filer, host=opts.ip, port=opts.port,
                    user=opts.user, password=opts.password,
                    anonymous=opts.anonymous)
    srv.start()
    print(f"ftp gateway listening at {opts.ip}:{srv.port}", flush=True)
    return _wait_forever(srv)
