#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (seaweedfs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--volume-mib MIB] [--upload-blobs N]
                          [--chunked-mib MIB] [--cdc-uploads N] [--stream-mib MIB]
                          [--dedup-gib GIB] [--online-mib MIB] [--cluster-mib MIB]
                          [--mesh-volumes N] [--mesh-mib MIB] [--filer-files N]
                          [--filer-large-mib MIB] [--scrub-files N] [--scrub-mib MIB]
                          [--maint-mib MIB] [--maint-files N] [--filer-dedup-uploads N]
                          [--s3-objects N] [--s3-seconds S] [--s3-clients N]
                          [--s3-multipart-mib MIB] [--tier-mib MIB]
                          [--gw-dav-files N] [--gw-ftp-files N] [--gw-ftp-large-mib MIB]
                          [--gw-mount-mib MIB] [--gw-small-files N] [--gw-remote-mib MIB]
                          [--sync-files N] [--mq-messages N] [--ha-files N]
                          [--ha-large-mib MIB] [--ha-ec-mib MIB] [--obs-files N]
                          [--obs-large N] [--obs-ec-mib MIB] [--qt-files N]
                          [--qt-large N] [--qt-flood-s S]

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
  6. upload   --upload-blobs (32,768) seeded 4096-byte blobs submitted to
              HashService(device=cuda) from 16 threads, each waiting for its
              blob's result before the next, as the filer does (BASELINE.md
              config 3); every MD5 and CRC equal to hashlib and the host CRC
     chunked  one --chunked-mib (1 GiB) + 12,345-byte upload cut into the
              filer's 4 MiB chunks through submit_many; ETags equal hashlib;
              the full chunks on the card through both kernels, CRC equal to
              its plain version, MD5 to hashlib
  7. cdc      find_boundaries at the filer's dedup settings over
              --cdc-uploads (32) seeded 64 MiB uploads, and chunk_stream at
              its defaults over --stream-mib (1 GiB); cuts equal the plain
              version's on the card, the first upload's the numpy oracle's
  8. dedup    the filer's CDC dedup write path (BASELINE config 4):
              --dedup-gib (2) GiB of 64 MiB uploads, four seeded segments
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
              deleted, a 10.5 s wait for the readers' shard maps, and 256 GETs
              of needles on them read degraded from the others through the
              partial fan-in (one GF-scaled partial a holder, on the card), which
              must serve every lost interval with no fallback; ec.rebuild -mode
              classic of each volume, its shards equal to the lost ones; the
              same loss again through ec.rebuild -mode pipelined -stream true
              (3 hops, 3-4 targets), then one data shard a volume through the
              default auto (which must pick pipelined): shards equal, no chain
              restart or fallback, one stacked partial a hop link, launches in
              each; ec.decode of each, its .dat equal to the copy taken before
              the encode, 256 needles read back at /dir/lookup's location;
              ingest GB/s, ec.encode wall and GB/s split by admin route, remote
              and degraded p50/p99 with launches a lost interval, each
              ec.rebuild round's wall, GB/s and bytes on wire beside classic's,
              ec.decode wall, the phase's launches, and the kernel at a
              pipelined hop's (1, 4, 983,040) and (4, 4, 983,040); a pipelined
              round that restarts or falls back prints the journal's
              chain_restart events, each hop's whole detail
 11. mesh     BASELINE config 5 on this host's CUDA devices (one here):
              dryrun_multichip(1); sharded_encode over make_mesh() of
              --mesh-volumes (32) seeded host volumes of 10 x --mesh-mib (4)
              MiB (1.25 GiB in, 0.5 GiB out: config 5's 256 volumes over 8
              chips is 32 a device), each device copying its slice on its
              own stream and launching gf256_matmul once, cold and warm;
              sharded_crc32c and sharded_md5 at (8192, 4096); the whole
              parity equal to the plain version on the card, the first and
              last volume to the CPU codec, every CRC and digest to the host
              CRC and hashlib; wall and GB/s with the copies, the phase's
              launches, and each device's launch timed beside its byte bound
 12. filer    BASELINE config 3 as the filer takes it: a port master (pulse
              1 s), two volume servers and a FilerServer on the card, one
              process; --filer-files (2,048) seeded 4 KiB files PUT from 16
              threads, each waiting for its response (one chunk, one assign,
              one needle POST, one ETag through the filer's hash service);
              4 uploads of --filer-large-mib (256) MiB from 4 threads (64
              chunks of 4 MiB, one batched assign); one overwritten, one
              deleted; every large file read whole, 256 ranged GETs across
              chunk boundaries, 1,024 small-file GETs, a conditional GET
              (304), the freed fids 404; every body, response md5 and chunk
              ETag equal to hashlib; batch_blobs equal to the chunk ETags
              made, no blob hashed on the host or failed, no per-chunk
              assign fallback; files/s, PUT and GET p50/p99, large-upload
              GB/s, hash batches by length, launches, the wall (limit 240 s)
 13. scrub    the volume integrity plane: a port master and three volume
              servers (racks r1, r1, r2) on the card, one process; --scrub-files
              (1,024) seeded 4 KiB files through /dir/assign?replication=001
              and POSTs from 8 waiting threads (each write fans out to the other
              r1 server before it is acked), both replicas holding the same
              needles; in process on the r2 server: --scrub-mib (256) MiB of
              4 KiB needles in one volume, 256 MiB of log-uniform needles
              encoded in place (all 14 shards local), a 64 MiB ecOnline volume;
              a clean `volume.scrub -dryRun` checking every live needle, with
              crc32c_batch and gf256_matmul launched and 99 % of the 4 KiB
              volumes' bytes through the batched kernel, then the same pass
              under torch.profiler for the device's idle share; 16 needle flips on one
              replica, a sealed shard flip, an online parity-row flip, a stale
              .ec03.tmp and a needle on one replica only, found exactly (the
              divergence by `detect`); `volume.scrub -apply`, the divergence
              healed through /admin/scrub/sync, `ec.rebuild` of the deleted
              shard equal to the original; the repaired needles, the synced one
              and samples read back equal, digests equal, a second pass clean;
              30 % of one replicated volume deleted, `volume.vacuum
              -garbageThreshold 0.2`, both replicas down to their live records,
              256 sampled GETs equal, a pass clean; one flush's CRCs against the
              plain version and the host CRC; pass GB/s and needles/s by
              kernel, launches, repair walls, vacuum wall and bytes reclaimed,
              the kernels at (1024, 4096) and (10, 4096), the wall (limit 150 s)
 14. maintenance  the maintenance daemon healing with no shell command: a
              port master (`maintenance=True`, scans every 1 s, garbage
              threshold 0.3) and four volume servers (racks r1, r1, r2, r2;
              scrub loop every 3 s) on the card, one process; with the daemon
              paused while the shell holds the lock, --maint-mib (256) MiB of
              log-uniform needles in one volume `ec.encode`d over the four,
              and --maint-files (1,024) seeded 4 KiB files through
              /dir/assign?replication=001 from 8 waiting threads; then at
              once 40 % of the files deleted, one needle byte flipped on one
              replica, data shard 3 lost (unmounted, removed, the rest
              remounted), and the daemon enabled: within 90 s a completed
              ec_rebuild, scrub and vacuum of every replicated volume and no
              failed task; the rebuilt shard equal to the lost one and to the
              plain version on the card, the re-copied needle equal to the
              good replica's, every replica shrunk, gf256_matmul and
              crc32c_batch launched in the heal window, a clean
              `volume.scrub -dryRun`, every file read back, one flush's CRCs
              equal to the plain version's; the time to heal of each kind,
              scans, tasks by type and state, the rebuild mode `auto` chose,
              launches, the card's name and power limit, the wall (limit 150 s)
 15. filer_dedup  BASELINE config 4 as an operator runs it: a port master
              (pulse 1 s), two volume servers and a FilerServer(dedup=True)
              on a leveldb store on the card, one process;
              --filer-dedup-uploads (6) PUTs of 64 MiB of bench.py's stream
              (0.375 GiB) from 4 threads each waiting for its 201, every md5
              against hashlib, gear_hash launched over them; every file's
              ?metadata=true, the uploads of segments 0 and 1 deleted, and the
              bytes to reclaim counted from that metadata; `fs.dedup.gc`
              through the shell's filer handle dropping exactly those fids
              and bytes with no error, each fid then 404, every survivor read
              back equal, a second gc dropping none, a deleted upload PUT again
              uploading anew; a MetaSubscriber on /__meta__/events seeing a
              create a PUT and a delete a DELETE; `cluster.ps` listing the
              filer; the filer restarted on its store dedup'ing a survivor's
              re-PUT with no miss; `fs.verify /`; PUT GB/s and p50/p99, the gc
              wall split, the restart wall, launches, the wall (limit 150 s)
 16. s3       warp's mixed S3 benchmark (`make benchmark` against `weed server
              -s3`) against the port: a port master (pulse 1 s), two volume
              servers and a FilerServer (4 MiB chunks) on the card, the admin
              identity written by the shell's `s3.configure`, an S3Server and an
              IamServer, one process; --s3-objects (256) seeded 10 MiB objects
              PUT from --s3-clients (20) signed clients, then --s3-seconds (10)
              of GET 45 % / STAT 30 % / PUT 15 % / DELETE 10 % drawn from the
              seed (a DELETE takes its key out of the live set first, a PUT adds
              a fresh key) under torch.profiler's CUDA activity for the device's
              idle share; the deleted keys 404 NoSuchKey; one --s3-multipart-mib
              (64) MiB upload in 8 parts, read back whole and by a Range across a
              part edge; IAM CreateUser, CreateAccessKey and PutUserPolicy, the
              new key answering once the gateway reloads (within 5 s), an unknown
              key 403 InvalidAccessKeyId; every ETag against hashlib, every GET
              body and HEAD against its PUT, no 5xx, md5_batch and crc32c_batch
              launched; obj/s, MiB/s and p50/p99 by operation, prepopulation and
              multipart GB/s, the reload time, launches, the wall (limit 150 s)
 17. volume_side  the volume side: a port master and two volume servers (racks r1,
              r2; runtime fault arming on) on the card, one process, and a child
              process at 5-byte offsets (SEAWEEDFS_TPU_OFFSET_BYTES=5, fixed at its
              import). (a) --tier-mib (256) MiB of seeded needles in one volume
              (log-uniform 1 KiB-4 MiB, then a quarter of 4 KiB needles, which the
              scrubber checks through crc32c_batch), `volume.tier.configure -kind
              local` and `volume.tier.upload` (the .dat gone), 256 GETs equal, a
              scrub pass through the backend verifying every live byte with no
              finding, one flush's CRCs against the plain version and the host,
              `/admin/tail` at the middle needle equal to the .dat from its offset,
              `volume.tier.download` (SHA-256 as before, a clean pass), `backup`
              into a fresh directory (full, then cut at the middle needle and
              caught up over `/admin/tail`) with the source's .dat and .idx SHA-256;
              (b) through `cluster.faults`: `corrupt` on volume.write.dat for 16
              firings keyed to server A under 2,048 4 KiB files at replication 010
              from 8 waiting threads, exactly those 16 found by a pass on A,
              `volume.scrub -apply` healing them, every file equal from both
              holders; a 64 MiB online volume's parity torn once, parity_health()
              >= 1, `/admin/ec/online/rebuild` (rearm through gf256_matmul) to 0
              with every parity row equal to the plain version, sealed, 4 data
              shards lost, 64 degraded GETs equal, rebuilt; shard reads failing at
              rate 0.25 (4 firings, within what RS(10,4) rebuilds), 256 GETs equal
              and rebuilt through the codec; (c) the child's encode, rebuild of 4
              shards, 256 degraded reads and decode, its 14 shards equal to a
              4-byte encode of the same .dat here and its 17-byte .ecx to the
              4-byte entries; tier upload, remote scrub, tail and download GB/s,
              the phase's launches, the kernels at (1024, 4096) and (1, 10, 1 MiB),
              the wall (limit 120 s)
 18. gateways the filer's other front doors and remote storage: a port master, two
              volume servers and a FilerServer (4 MiB chunks, a local socket under
              build/) on the card, a WebDavServer, an FtpServer and a WFS over the
              filer's unix socket through VirtualFuseKernel, one process. (a) WebDAV:
              --gw-dav-files (256) files (log-uniform 1 KiB-8 MiB, about 0.23 GB) PUT
              from 8 keep-alive clients into 8 collections, PROPFIND Depth 1 listing
              each with its size and a getetag equal to hashlib's MD5, every GET
              equal, COPY then MOVE of a collection, a LOCK enforced (423 without the
              token, 201 with it); (b) FTP: --gw-ftp-files (256) files of 1 MiB from
              4 sessions and one of --gw-ftp-large-mib (256) MiB, RETR equal, SIZE and
              LIST agreeing; (c) the mount: --gw-mount-mib (512) MiB in 128 KiB
              WRITEs, read back in 128 KiB READs and over HTTP with the same SHA-256,
              1 MiB overwritten across the middle chunk edge, --gw-small-files (256)
              files of 4 KiB, READDIR, a directory rename, an HTTP write seen through
              the meta cache, `mount.configure -quotaMB 1` then ENOSPC; (d) remote:
              --gw-remote-mib (256) MiB of objects (log-uniform 1 KiB-4 MiB) in two
              buckets of a local remote, `remote.configure`, `remote.mount.buckets`
              (stubs, no chunks), 64 read-through GETs, `remote.cache` (every md5
              hashlib's), `remote.uncache` then a GET, 16 new objects through
              `remote.meta.sync`, 64 WebDAV PUTs and a DELETE in a mounted bucket
              written back by `filer.remote.sync -once`; no op past 12 s, md5_batch
              and crc32c_batch launched; the rates, the phase's launches, the kernels
              at its commonest chunk lengths, the wall (limit 150 s)
 19. sync_mq  sync and messaging as upstream's compose deployments run them
              (local-clusters and local-sync-mount: two clusters under
              filer.sync; local-replicate: a notification queue and
              filer.replicate): clusters A and B, each a port master, a volume
              server and a FilerServer (4 MiB chunks) on the card, A's with a
              FileQueue spool, one process. (a) a FilerSyncer each way on
              threads (-interval 1); --sync-files (128) files a side
              (log-uniform 1 KiB-8 MiB) from 4 keep-alive clients a side, each
              file's first GET on the other side after its create event there
              (its SHA-256 the body's); 32 renames and 32 deletes a side; both
              trees converge and are equal by SHA-256, every chunk MD5 hashlib's,
              each event log quiet within 5 s of the last write; sync GB/s a
              direction, lag p50/p99, events applied and skipped by signature.
              (b) filer.replicate -once -sink.local over the spool and
              filer.backup -once of A, each equal to A's /sync by SHA-256.
              (c) two BrokerServers over A's filer, topic of 4 partitions at
              replication 1, 4 Publishers sending --mq-messages (4,096) keyed 1
              KiB messages while a group of 2 Consumers polls and commits; the
              second broker crashed halfway with no flush, the ring healed; no
              acked message lost, every value its key's, offsets in order a
              consumer and partition, committed offsets at the high-water marks,
              every segment's MD5 hashlib's and the segments the committed
              messages; mq.topic.list, mq.topic.describe and mq.balance; publish
              msgs/s, MiB/s, ack and publish-to-consume p50/p99, consume msgs/s,
              failover ms; md5_batch and crc32c_batch launched, no op past 12 s,
              the wall (limit 150 s)
 20. secure_ha  security and raft HA as upstream lays them out (compose's
              three masters under raft with -peers; `weed scaffold
              -config=security`'s jwt.signing, jwt.signing.read, guard and
              tls): three port masters with their own raft directories, three
              volume servers (racks r1, r1, r2) given all three and a
              FilerServer (4 MiB chunks), on the card, one process, on one
              SecurityConfig (a write key, a read key, white list 127.0.0.1)
              with mTLS process-wide from a PKI made on the host
              (cryptography, else openssl: a CA, an allowed node and an
              intruder). (a) --ha-files (1,024) 4 KiB files and 8 of
              --ha-large-mib (64) MiB PUT through the filer over https from 8
              waiting threads and read back, md5 equal to hashlib; (b)
              --ha-ec-mib (256) MiB of log-uniform needles in one volume with
              signed POSTs, ec.encode through the leader, a data shard deleted
              and needles on it read degraded with read tokens; (c) the leader
              crashed (its raft cut, its connections reset) while 8 threads
              call /dir/assign: ms to a new leader and to its first assign,
              assign p50/p99 before and after, no fid handed out twice, every
              server's heartbeat on the new leader; (d) a second data shard
              deleted, ec.rebuild through the new leader, both shards equal
              to the lost ones, every needle read back; (e) cluster.raft.ps,
              .remove of the dead master, .add of a fresh fourth that catches
              up by InstallSnapshot (the logs compact past 8 entries); (f)
              unsigned POST and DELETE, a wrong-key read and a token-less
              /query 401, the intruder's certificate 403 at the CN gate, no
              client certificate a failed handshake, plain http no answer,
              every url https; TLS reset on the way out; md5_batch,
              crc32c_batch and gf256_matmul launched, the wall (limit 90 s)
 21. observe  the stats core and the debug plane on a loaded cluster: a
              master (pulse 1 s), four volume servers and a FilerServer with
              its metrics port, every role metered, the process's history and
              alert state cleared first. (a) --obs-files (1,024) 4 KiB and
              --obs-large (16) 4 MiB files through the filer from 8 waiting
              threads; (b) --obs-ec-mib (256) MiB of 1 MiB needles POSTed into
              one volume, ec.encode, data shards 2 and 7 deleted, 64 degraded
              GETs, ec.rebuild -mode classic; (c) during the 4 MiB PUTs,
              GET /debug/pprof/device?seconds=2 on the metrics port (after one
              warm-up capture). Checks: SeaweedFS_filer_hash_seconds
              {kernel="batch-cuda"} grew by the hash service's batches; the EC
              encode and decode histograms by one each; the last PUT's
              X-Sw-Trace-Id is a cluster.trace tree of the filer, master and
              volume roles; cluster.why <vid> lists OBS_WHY_EVENTS;
              cluster.check lists every node healthy before the loss and
              cluster.top -once has a row a role; the device trace is a gzip
              of a Chrome trace holding CUDA kernel events of the port's
              kernels; cluster.profile returns stacks; every role's /metrics
              passes the port's name lint. Files/s, PUT p50/p99, the trace's
              kernel events against the launches counted in its window, one
              history self-scrape's ms, the wall (limit 45 s)
 22. qos_telemetry  tenant usage, heat, the cluster telemetry plane, its
              durable spool and QoS admission on two filer gateways that share
              one -qos.limits policy ("abuser=20:40,victim=10000,*=200"): a
              master with a telemetry_dir, two volume servers, two filers on
              the card (each with its own telemetry_dir; one process keeps one
              spool, the first given), an S3 and a WebDAV gateway given the
              master; the process's history and usage state cleared first. (a)
              a victim tenant writes --qt-files (512) 4 KiB and --qt-large
              (8) 4 MiB files from 8 waiting threads (a quarter of the small
              ones through S3 bucket victim) and reads them back, alone, then
              under (b) an abuser flood of --qt-flood-s (8) s from 8 threads,
              half through each filer, a quarter through S3; (c) cluster.qos
              -limit 'abuser=5:10' live and 3 s more of flood; (d) one filer
              stopped, the spool closed and read post-mortem by cluster.top
              -once -spool and cluster.why abuser -spool; (e) cluster.heat -n 8
              and cluster.qos. Checks: no victim request shed; the abuser
              refused only with typed 429/503 (S3 SlowDown/ServiceUnavailable)
              and admitted at most rate x (T + queue_wait) + burst a stage;
              the master's /debug/cluster/telemetry holds every sender (two
              volume servers, two filers, S3, WebDAV, the master) and the
              abuser's merged count within the sketch's error bound of the
              gateways' /debug/usage; the spool reads back events and series;
              md5_batch and crc32c_batch launched. Victim files/s and PUT
              p50/p99 alone and under the flood, the abuser's admitted and shed
              by reason, frames and bytes by sender, spool bytes by tier, the
              wall (limit 30 s)
 23. entry    entry() on the card equal to the CPU codec
Then the {"kernels": [...]} line, the card's name and power limit, and the
last line {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when CUDA is not available.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ftplib
import gc
import gzip
import hashlib
import http.client
import io
import itertools
import json
import logging
import os
import re
import shutil
import socket
import ssl
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path
from xml.etree import ElementTree as ET

import numpy as np
import torch

from seaweedfs_tpu_torch import native
from seaweedfs_tpu_torch.command import fix, volume_tools
from seaweedfs_tpu_torch.command.filer_sync import (
    run_filer_backup,
    run_filer_remote_sync,
    run_filer_replicate,
)
from seaweedfs_tpu_torch.entry import dryrun_multichip, entry
from seaweedfs_tpu_torch.filer import Filer
from seaweedfs_tpu_torch.filer.filerstore import MemoryStore
from seaweedfs_tpu_torch.filer.wdclient import WeedClient
from seaweedfs_tpu_torch.ftpd import FtpServer
from seaweedfs_tpu_torch.maintenance import scrub
from seaweedfs_tpu_torch.mount import WFS, VirtualFuseKernel, start_admin_service
from seaweedfs_tpu_torch.mount import fuse_proto as fp
from seaweedfs_tpu_torch.mq import BrokerServer, Consumer, MQError, Publisher
from seaweedfs_tpu_torch.notification import FileQueue
from seaweedfs_tpu_torch.ops import _build, cdc, gf256
from seaweedfs_tpu_torch.ops.crc32c_kernel import crc32c_batch_kernel, crc32c_batch_torch
from seaweedfs_tpu_torch.ops.hash_service import HashService
from seaweedfs_tpu_torch.ops.md5_kernel import _pad_len, md5_batch_kernel, md5_batch_torch
from seaweedfs_tpu_torch.ops.rs_cuda import gf256_matmul, gf_matmul_torch
from seaweedfs_tpu_torch.ops.rs_kernel import RSCodec
from seaweedfs_tpu_torch.parallel import make_mesh, sharded_crc32c, sharded_encode, sharded_md5
from seaweedfs_tpu_torch.remote_storage import LocalRemoteStorage
from seaweedfs_tpu_torch.replication import FilerSyncer
from seaweedfs_tpu_torch.security import SecurityConfig, tls
from seaweedfs_tpu_torch.security.jwt import gen_read_jwt, gen_write_jwt
from seaweedfs_tpu_torch.security.tls import TLSConfig
from seaweedfs_tpu_torch.server.filer import FilerServer
from seaweedfs_tpu_torch.server.httpd import get_json, http_request, peer_url, post_json
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.server.webdav import WebDavServer
from seaweedfs_tpu_torch.shell import CommandEnv, commands_ec, run_command
from seaweedfs_tpu_torch.qos import actuator as act_mod
from seaweedfs_tpu_torch.qos import admission as qos_mod
from seaweedfs_tpu_torch.stats import alerts as alerts_mod
from seaweedfs_tpu_torch.stats import events as events_mod
from seaweedfs_tpu_torch.stats import history as history_mod
from seaweedfs_tpu_torch.stats import parse_exposition
from seaweedfs_tpu_torch.stats import store as store_mod
from seaweedfs_tpu_torch.stats import usage as usage_mod
from seaweedfs_tpu_torch.stats import trace as trace_mod
from seaweedfs_tpu_torch.storage import crc, file_id
from seaweedfs_tpu_torch.storage.erasure_coding import decoder, encoder, geometry
from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import EcVolume
from seaweedfs_tpu_torch.storage.erasure_coding.online import PATHOLOGICAL_REASONS
from seaweedfs_tpu_torch.storage.needle import Needle, get_actual_size
from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.tools.check_metric_names import exposition_violations
from seaweedfs_tpu_torch.util import cipher as cipher_util
from seaweedfs_tpu_torch.util import faults

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


_T0 = time.perf_counter()


class GcPauses:
    """The cyclic collector's pauses since the last `take()`, by generation.
    A full (generation 2) collection holds the GIL through its whole pass
    over the heap that every role of the script shares: 0.3-0.5 s on the
    card's host once earlier phases' survivors are in it, as long as the
    raft masters' election timeout (0.3-0.6 s). A failed check of the
    secure_ha phase prints the pauses so far."""

    def __init__(self) -> None:
        self._start = 0.0
        self._pauses: list = []
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start = time.perf_counter()
        else:
            self._pauses.append((info["generation"], time.perf_counter() - self._start))

    def take(self, reset: bool = True) -> dict:
        pauses = self._pauses
        if reset:
            self._pauses = []
        full = [d for g, d in pauses if g == 2]
        return dict(collections=[sum(1 for g, _ in pauses if g == k) for k in range(3)],
                    full_max_ms=max(full, default=0.0) * 1e3,
                    full_total_ms=sum(full) * 1e3, objects=len(gc.get_objects()))


GC_PAUSES = GcPauses()


def emit(phase: str, **fields) -> None:
    """One JSON line for a phase; `at_s` is the seconds since the script
    started, so each phase's share of the run reads off the log, and `gc`
    the collector's pauses since the previous line."""
    print(json.dumps({"phase": phase, "at_s": time.perf_counter() - _T0,
                      "gc": GC_PAUSES.take(), **fields}), flush=True)


class RecordLog(logging.Handler):
    """Keeps the messages a logger emits at WARNING or above while the
    `with` block runs (a failed check names them)."""

    def __init__(self, logger: logging.Logger) -> None:
        super().__init__(logging.WARNING)
        self.logger = logger
        self.records: list[str] = []

    def emit(self, record: logging.LogRecord) -> None:
        self.records.append(record.getMessage())

    def __enter__(self) -> "RecordLog":
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc) -> None:
        self.logger.removeHandler(self)


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
    decode matrix of the 4-shard rebuild, a degraded read's one row, which
    reconstructs one missing data shard from 10 survivors, and a pipelined
    rebuild hop's coefficient columns for its 4 own shards, one target
    (hop1) or four (hop4)."""
    def decode(lost):
        return gf256.decode_matrix(10, 4, tuple(s for s in range(14) if s not in lost), lost)
    return {"encode": gf256.parity_rows(10, 4), "rebuild": decode(REBUILD_LOST),
            "degraded": decode(DEGRADED_LOST[:1]), "online": gf256.parity_rows(10, 4),
            "mesh": gf256.parity_rows(10, 4), "scrub": gf256.parity_rows(10, 4),
            "hop1": np.ascontiguousarray(decode((0,))[:, :4]),
            "hop4": np.ascontiguousarray(decode((0, 4, 8, 12))[:, :4])}


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
    chain_ms = {f"{n}x{length}": md5_chain_ms(length) for n, length in HASH_SHAPES}
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
                     md5_ops_per_block: int, shapes=HASH_SHAPES, gear: bool = True) -> dict:
    """The hash kernels (`wrappers`: crc32c_batch, md5_batch and gear_hash,
    this checkout's or another's) at their paths' shapes (`shapes`, and the
    gear hash's unless `gear` is false): each equal to
    its plain version (MD5 past 4096 bytes: to hashlib on two blobs), then
    timed by device time (`ms`: a CUDA graph of launches) beside one
    call's event time, the plain version's and the bound. Inputs rotate
    over more than the 50 MB L2, so every launch reads device memory."""
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    crc_k, md5_k, gear_k = (wrappers[k] for k in ("crc32c_batch", "md5_batch", "gear_hash"))
    out = {"crc32c_batch": [], "md5_batch": []}
    for n, length in shapes:
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
                      for i in range(len(host))), f"md5_batch kernel != hashlib at ({n}, {length})")
        b_ms, b_by = hash_bound_ms(per + 16 * n, md5_ops_per_block * n * blocks)
        out["md5_batch"].append(dict(
            shape=[n, length],
            ms=device_ms(lambda: md5_k(next(cyc)), reps=reps, warmup=1),
            call_ms=call_ms(lambda: md5_k(next(cyc)), warmup=1),
            plain_ms=(call_ms(lambda: md5_batch_torch(x0), warmup=0, reps=1)
                      if length <= 4096 else None),
            bound_ms=b_ms, bound_by=b_by))
        del pool, cyc, x0, got
    if not gear:
        return out
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


def device_time_by_event(prof) -> tuple[dict, dict]:
    """A torch.profiler window's device events: microseconds and counts by
    the event's name, cut to 60 characters (kernels' full names run to
    hundreds)."""
    from torch.autograd import DeviceType

    device_us, events = {}, {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            t_us = getattr(e, "self_device_time_total", None)
            if t_us is None:
                t_us = e.self_cuda_time_total
            name = e.key[:60]
            device_us[name] = device_us.get(name, 0.0) + t_us
            events[name] = events.get(name, 0) + e.count
    return device_us, events


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
    from torch.profiler import ProfilerActivity, profile

    for data, want in SW128_GOLDENS.items():
        check(native.fast128(data).hex() == want, f"SW128 golden of {data!r}")
    t0 = time.perf_counter()
    rng = np.random.default_rng([seed, 7])
    segs = [rng.integers(0, 256, DEDUP_SEGMENT, dtype=np.uint8) for _ in range(4)]
    gen_s = time.perf_counter() - t0
    client = FreshFids()
    filer = Filer(MemoryStore())
    server = FilerServer(filer=filer, client=client, device=dev, dedup=True,
                         dedup_avg_bits=DEDUP["avg_bits"], dedup_min=DEDUP["min_size"],
                         dedup_max=DEDUP["max_size"])
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
            device_us, events = device_time_by_event(prof)
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
    """One keep-alive HTTP connection to a server; an `https` url presents
    the process's mTLS client certificate."""

    def __init__(self, url: str) -> None:
        scheme, rest = url.split("//", 1)
        host, port = rest.split(":")
        if scheme == "https:":
            self.conn = http.client.HTTPSConnection(host, int(port), timeout=120,
                                                    context=tls.client_context())
        else:
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


def online_plan(nbytes: int, seed: int, vid: int = ONLINE_VID) -> tuple[list, memoryview]:
    """Needles of log-uniform sizes in [1 KiB, 4 MiB] (write_volume's rule)
    whose payloads add up to `nbytes`: [(fid, needle_id, offset, size)] in
    volume `vid`, into one seeded pool."""
    rng = np.random.default_rng([seed, 9])
    pool = memoryview(rng.bytes(nbytes))
    plan = []
    used = 0
    nid = 0
    while used < nbytes:
        size = min(int(np.exp(rng.uniform(np.log(1024), np.log(4 * MIB)))), nbytes - used)
        nid += int(rng.integers(1, 1 << 20))
        cookie = int(rng.integers(0, 1 << 32))
        plan.append((f"{vid},{file_id.format_needle_id_cookie(nid, cookie)}",
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
# a holder's shard map from the master's /dir/ec_lookup lives 10 s
# (server/volume.py _attach_shard_fetcher); degraded GETs start after it
SHARD_MAP_WAIT_S = 10.5
# a pipelined hop's launch at the phase's ~146 MiB volumes: its 4 own
# shards at auto_chunk(15 MiB) = 983,040 bytes, one target or four
HOP_CHUNK = commands_ec.auto_chunk(15 * MIB)
HOP_SHAPES = (("hop1", (4, HOP_CHUNK)), ("hop4", (4, HOP_CHUNK)))
PIPELINED_LINE = re.compile(r"\(pipelined(, streamed)?, (\d+) hops, (\d+) B at rebuilder,"
                            r" (\d+) B total on wire\)")


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
                n_lost = sum(iv.to_shard_id_and_offset(geometry.LARGE_BLOCK_SIZE,
                                                       geometry.SMALL_BLOCK_SIZE)[0] in lost[vid]
                             for iv in ivs)
                if n_lost:
                    on_lost.append((fid, off, size, n_lost))
            pick = rng.choice(len(on_lost), size=min(CLUSTER_SAMPLE, len(on_lost)),
                              replace=False)
            # the readers' shard maps were fetched before the loss: past
            # their life the fan-in asks only live holders
            time.sleep(SHARD_MAP_WAIT_S)
            partial0 = partial_counts(servers, vols)
            n0 = gf256_matmul.launches
            degraded_lat = []
            lost_intervals = 0
            for j, i in enumerate(pick):
                fid, off, size, n_lost = on_lost[i]
                lost_intervals += n_lost
                t0 = time.perf_counter()
                status, got = clients[others[j % len(others)]].request("GET", f"/{fid}")
                degraded_lat.append(time.perf_counter() - t0)
                check(status == 200 and got == pool[off : off + size], f"degraded GET {fid}")
            degraded_launches = gf256_matmul.launches - n0
            served, fallbacks = (a - b for a, b in zip(partial_counts(servers, vols), partial0))
            check(served == lost_intervals and fallbacks == 0,
                  f"degraded GETs: {served} of {lost_intervals} lost intervals served by the"
                  f" partial fan-in, {fallbacks} fallbacks")
            check(degraded_launches >= lost_intervals,
                  "every lost interval reconstructed on the card")
        finally:
            for c in clients.values():
                c.close()
        # 6a. ec.rebuild -mode classic of every volume; the rebuilt shards equal the lost ones
        repair0 = decoder.REPAIR.snapshot()
        n0 = gf256_matmul.launches
        t0 = time.perf_counter()
        for vid in vols:
            out = run_command(env, f"ec.rebuild -volumeId {vid} -collection {CLUSTER_COLLECTION}"
                                   " -mode classic")
            check(f"rebuilt shards {lost[vid]}" in out and "(classic)" in out,
                  f"ec.rebuild {vid}: {out}")
        rebuild_s = time.perf_counter() - t0
        rebuild_launches = gf256_matmul.launches - n0
        classic_bytes = (decoder.REPAIR.snapshot()["bytes_on_wire"]["classic"]
                         - repair0["bytes_on_wire"]["classic"])
        check(rebuild_launches > 0, "ec.rebuild launched no gf256_matmul kernel")

        def check_rebuilt(shards_of: dict, what: str) -> None:
            views = env.servers()
            for vid, shards in shards_of.items():
                placement[vid] = {sv.url: sorted(sv.ec_shards.get(vid, [])) for sv in views}
                check(sorted(s for held in placement[vid].values() for s in held)
                      == list(range(14)), f"{what}: volume {vid} mounts {placement[vid]}")
                for s in shards:
                    check(same_file(shard_path(vid, s),
                                    os.path.join(lost_dir, f"{vid}{geometry.to_ext(s)}")),
                          f"{what}: volume {vid}: rebuilt shard {s} differs from the lost one")

        check_rebuilt(lost, "ec.rebuild -mode classic")
        shard_sizes = {vid: geometry.shard_file_size(
            n, geometry.LARGE_BLOCK_SIZE, geometry.SMALL_BLOCK_SIZE) for vid, (n, _) in vols.items()}
        rebuild_read = sum(10 * n for n in shard_sizes.values())

        def pipelined_round(shards_of: dict, flags: str, what: str) -> dict:
            """Delete `shards_of` from their holders, run `ec.rebuild` with
            `flags` on every volume, and hold the result: byte-equal shards,
            the streamed pipelined line, no restart or fallback, the wire
            bytes of one stacked partial a hop link."""
            for vid, shards in shards_of.items():
                for url, held in placement[vid].items():
                    drop = [s for s in held if s in shards]
                    if drop:
                        env.post(f"http://{url}/admin/ec/delete_shards",
                                 {"volume": vid, "collection": CLUSTER_COLLECTION,
                                  "shards": drop})
            classic_plan = sum(
                len(p["shards"]) * shard_sizes[vid] for vid in shards_of
                for p in commands_ec.plan_rebuild(env, vid, CLUSTER_COLLECTION)["pulls"])
            before = decoder.REPAIR.snapshot()
            n0 = gf256_matmul.launches
            t0 = time.perf_counter()
            total = at_rebuilder = 0
            hops = []

            wall0 = time.time()

            def since_round() -> str:
                now = decoder.REPAIR.snapshot()
                return "; since the round began: " + str(
                    {k: {r: n - before[k].get(r, 0) for r, n in now[k].items()
                         if n != before[k].get(r, 0)}
                     for k in ("restarts", "fallbacks", "stream_chunks")}
                ) + f"; chain restarts logged: {restart_log.records}" + (
                    "; the journal's chain_restart events (whole detail): "
                    + json.dumps(events_mod.recorder().events(type="chain_restart",
                                                              since=wall0)))

            restart_log = RecordLog(commands_ec.log)
            with restart_log:
                for vid, shards in shards_of.items():
                    restart_log.records.clear()
                    out = run_command(env, f"ec.rebuild -volumeId {vid}"
                                           f" -collection {CLUSTER_COLLECTION}{flags}")
                    m = PIPELINED_LINE.search(out)
                    check(f"rebuilt shards {shards}" in out and m is not None and m.group(1),
                          f"{what} {vid}: {out}" + since_round())
                    n_hops, rb, tot = int(m.group(2)), int(m.group(3)), int(m.group(4))
                    check(tot == (n_hops - 1) * len(shards) * shard_sizes[vid]
                          and rb == len(shards) * shard_sizes[vid],
                          f"{what} {vid}: {tot} B on wire, {rb} at the rebuilder, {n_hops} hops"
                          + since_round())
                    hops.append(n_hops)
                    total += tot
                    at_rebuilder += rb
            wall = time.perf_counter() - t0
            launches = gf256_matmul.launches - n0
            after = decoder.REPAIR.snapshot()
            restarts = sum(after["restarts"].values()) - sum(before["restarts"].values())
            fallbacks = sum(after["fallbacks"].values()) - sum(before["fallbacks"].values())
            check(restarts == 0 and fallbacks == 0,
                  f"{what}: {restarts} chain restarts, {fallbacks} fallbacks" + since_round())
            check(launches > 0, f"{what} launched no gf256_matmul kernel")
            check_rebuilt(shards_of, what)
            return dict(
                wall_s=wall, gbps=sum(10 * shard_sizes[v] for v in shards_of) / wall / 1e9,
                targets=sum(len(x) for x in shards_of.values()),
                bytes_on_wire_total=total, bytes_on_wire_rebuilder=at_rebuilder,
                classic_bytes_same_loss=classic_plan, hops=hops,
                chunk_bytes=sorted({commands_ec.auto_chunk(shard_sizes[v]) for v in shards_of}),
                chunks=sum(len(list(commands_ec._chunk_spans(
                    shard_sizes[v], 0, commands_ec.auto_chunk(shard_sizes[v]))))
                    for v in shards_of),
                launches=launches, restarts=restarts, fallbacks=fallbacks)

        # 6b. the same loss again, every volume through the streamed
        # multi-target chain
        multi = pipelined_round(lost, " -mode pipelined -stream true",
                                "ec.rebuild -mode pipelined")
        # 6c. BASELINE config 2: one data shard a volume, the default mode
        # (auto picks the pipelined chain); the round's check holds each
        # rebuilder to one shard's bytes, within config 2's 2 x shard size
        single = pipelined_round({vid: [min(s for s in lost[vid] if s < 10)] for vid in vols},
                                 "", "ec.rebuild (auto), one shard")
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
            shard_map_wait_s=SHARD_MAP_WAIT_S,
            degraded_reads=len(degraded_lat), degraded_p50_ms=float(np.percentile(dl, 50)),
            degraded_p99_ms=float(np.percentile(dl, 99)), degraded_launches=degraded_launches,
            degraded_lost_intervals=lost_intervals, degraded_partial_served=served,
            degraded_partial_fallbacks=fallbacks,
            degraded_launches_per_interval=degraded_launches / lost_intervals,
            rebuild_s=rebuild_s, rebuild_read_bytes=rebuild_read,
            rebuild_gbps=rebuild_read / rebuild_s / 1e9, rebuild_launches=rebuild_launches,
            rebuild_classic_bytes_on_wire=classic_bytes,
            rebuild_pipelined_multi=multi, rebuild_pipelined_single=single,
            decode_s=decode_s, launches=launches, rebuilt_shards_equal=True,
            decoded_dats_equal=True, reads_equal=True)
    finally:
        for vs in servers:
            vs.stop()
        master.stop()
        shutil.rmtree(root, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    check(res["launches"] > 0, "the cluster path launched no gf256_matmul kernel")
    # the kernel at a pipelined hop's two shapes, after the count
    res["kernel"] = gf256_shape_times(dev, seed, gf256_matmul, shapes=HOP_SHAPES)
    res["nvidia_smi"] = nvidia_smi()
    return res


def partial_counts(servers: list, vols: dict) -> tuple[int, int]:
    """Intervals served by the partial fan-in, and its fallbacks, summed over
    every server's mounted EC volumes."""
    evs = [ev for vs in servers for vid in vols
           if (ev := vs.store.get_ec_volume(vid)) is not None]
    return (sum(ev.partial_served for ev in evs),
            sum(sum(ev.partial_fallbacks.values()) for ev in evs))


# --- phase 12: the multi-device split ---------------------------------------------
MESH_HASH = (8192, 4096)  # sharded_crc32c / sharded_md5: the hash service's full batch


def mesh_phase(dev: torch.device, n_volumes: int, shard_bytes: int, md5_ops_per_block: int,
               seed: int) -> dict:
    """BASELINE config 5 (multi-volume ec.encode across chips) on this host's
    CUDA devices: dryrun_multichip(1); sharded_encode over make_mesh() of
    seeded host volumes (n_volumes, 10, shard_bytes), twice (cold, warm),
    each device copying its slice on its own stream and launching
    gf256_matmul once; sharded_crc32c and sharded_md5 at (8192, 4096). The
    launches are counted over those calls. Checks: the whole parity equal
    to the plain version on the card, the first and last volume to the CPU
    codec, every CRC to the host CRC and every digest to hashlib. Then each
    device's launch timed at its shape beside its byte bound."""
    t_phase = time.perf_counter()
    zero_launches()
    dryrun_multichip(1)
    mesh = make_mesh()
    check(mesh.size == torch.cuda.device_count() and all(d.type == "cuda" for d in mesh.devices),
          f"make_mesh() holds {mesh.devices}")
    rng = np.random.default_rng([seed, 12])
    t0 = time.perf_counter()
    volumes = np.empty((n_volumes, 10, shard_bytes), np.uint8)
    for v in range(n_volumes):
        volumes[v] = np.frombuffer(rng.bytes(10 * shard_bytes), np.uint8).reshape(10, shard_bytes)
    n_blobs, blob_len = MESH_HASH
    blobs = np.frombuffer(bytearray(rng.bytes(n_blobs * blob_len)), np.uint8).reshape(
        n_blobs, blob_len)
    gen_s = time.perf_counter() - t0
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        parity = sharded_encode(mesh, volumes)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    crcs = sharded_crc32c(mesh, blobs)
    digests = sharded_md5(mesh, blobs)
    torch.cuda.synchronize()
    hash_s = time.perf_counter() - t0
    launches = read_launches()
    for name in ("gf256_matmul", "crc32c_batch", "md5_batch"):
        check(launches[name] > 0, f"the mesh path launched no {name} kernel")
    check(parity.shape == (n_volumes, 4, shard_bytes)
          and len(parity.shards) == mesh.size, f"sharded parity {parity.shape}")
    # the whole parity against the plain version on the card
    in_bytes = volumes.nbytes
    x = torch.from_numpy(volumes).to(dev)
    want = gf_matmul_torch(gf256.parity_rows(10, 4), x.permute(1, 0, 2).reshape(10, -1))
    del x
    got = torch.cat([s.to(dev) for s in parity.shards]).permute(1, 0, 2).reshape(4, -1)
    err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
    check(err == 0, "sharded_encode != the plain version on the card")
    del got, want
    cpu = RSCodec(device="cpu")
    host_parity = np.asarray(parity)
    for v in (0, n_volumes - 1):
        check(np.array_equal(host_parity[v], cpu.encode(volumes[v])),
              f"sharded_encode volume {v} != the CPU codec")
    host_crcs, host_digests = np.asarray(crcs), np.asarray(digests)
    for i in range(n_blobs):
        blob = blobs[i].tobytes()
        check(int(host_crcs[i]) == crc.crc32c(blob), f"sharded_crc32c blob {i} != host CRC")
        check(host_digests[i].tobytes() == hashlib.md5(blob).digest(),
              f"sharded_md5 blob {i} != hashlib")
    # each device's launch at its slice's shape (one device here: the whole batch)
    per_dev = (n_volumes // mesh.size, 10, shard_bytes)
    (gf_row,) = gf256_shape_times(dev, seed, gf256_matmul, shapes=(("mesh", per_dev),))
    hash_rows = hash_shape_times(dev, seed, HASH_WRAPPERS, md5_ops_per_block,
                                 shapes=((n_blobs // mesh.size, blob_len),), gear=False)
    for rows in hash_rows.values():
        for r in rows:
            r["path"] = "mesh"
    return dict(
        devices=[str(d) for d in mesh.devices], volumes=n_volumes, shard_bytes=shard_bytes,
        in_bytes=in_bytes, out_bytes=n_volumes * 4 * shard_bytes,
        encode_cold_s=walls[0], encode_warm_s=walls[1],
        encode_cold_gbps=in_bytes / walls[0] / 1e9, encode_warm_gbps=in_bytes / walls[1] / 1e9,
        hash_shape=[n_blobs, blob_len], hash_s=hash_s,
        hash_gbps=blobs.nbytes / hash_s / 1e9, launches=launches,
        parity_vs_plain_max_abs_err=err, cpu_codec_volumes=[0, n_volumes - 1],
        crc_equal_host=True, md5_equal_hashlib=True, generate_s=gen_s,
        kernel=gf_row, hash_kernels=hash_rows,
        device_ms={"gf256_matmul": gf_row["ms"], **{k: v[0]["ms"] for k, v in hash_rows.items()}},
        bound_ms={"gf256_matmul": gf_row["bound_ms"],
                  **{k: v[0]["bound_ms"] for k, v in hash_rows.items()}},
        multi_device_path="unrun: this host has one device" if mesh.size == 1 else "run",
        seconds=time.perf_counter() - t_phase)


# --- phase 13: the filer's HTTP write/read path --------------------------------------
FILER_THREADS = 16  # `weed benchmark -c 16` (BASELINE.md config 3)
FILER_SMALL = 4096  # above the filer's 2 KiB inline limit: one chunk, one ETag
FILER_LARGE = 4  # large uploads, one a thread
FILER_RANGED = 256
FILER_SMALL_GETS = 1024
FILER_WALL_LIMIT_S = 240
OCTET = {"Content-Type": "application/octet-stream"}  # never compressed
FILER_CUTS = ("2,048 of config 3's 1M blobs: five roles and the clients share one process"
              " and one GIL (65,536 took the phase past its 240 s limit; 32,768 was cut to"
              " make room for the filer_dedup phase, 16,384 for the gateways phase, 8,192"
              " for the sync_mq phase, 4,096 for the secure_ha phase)", "no manifest: 1,000 chunks of 4 MiB is 4 GiB (manifests are"
              " held on the CPU)", "no compression or cipher: seeded random bytes")


def _pcts(lat: list) -> dict:
    ms = np.array(lat) * 1e3
    return dict(p50_ms=float(np.percentile(ms, 50)), p99_ms=float(np.percentile(ms, 99)))


def timed_batches(svc: HashService, batches: list) -> None:
    """Record (blobs, length, seconds) of every batch svc's flusher hashes;
    `del svc._batch_hash` undoes it."""
    real = svc._batch_hash

    def timed(items, length):
        t0 = time.perf_counter()
        out = real(items, length)
        batches.append((len(items), length, time.perf_counter() - t0))
        return out

    svc._batch_hash = timed


def batch_buckets(batches: list) -> dict:
    """The hash batches by blob length: count, blobs, sizes, mean time."""
    buckets = {}
    for length in sorted({b[1] for b in batches}):
        sizes = np.array([n for n, ln, _ in batches if ln == length])
        secs = np.array([s for _, ln, s in batches if ln == length])
        buckets[str(length)] = dict(batches=len(sizes), blobs=int(sizes.sum()),
                                    mean_batch=float(sizes.mean()),
                                    batch_p50=float(np.percentile(sizes, 50)),
                                    batch_max=int(sizes.max()),
                                    batch_hash_mean_ms=float(secs.mean() * 1e3))
    return buckets


def md5_chain_ms(length: int) -> float:
    """MD5's chain model: the least time of one blob of `length` bytes,
    whose blocks the card must hash one after another."""
    return _pad_len(length) // 64 * 64 * MD5_CHAIN_DEPS * MD5_CHAIN_CYCLES / SM_CLOCK_HZ * 1e3


def path_hash_times(dev: torch.device, seed: int, md5_ops_per_block: int, batches: list,
                    lengths, path: str) -> dict:
    """The hash kernels timed at a path's commonest batch of each length,
    after its launches were counted. Each MD5 row past 4096 bytes also
    carries `chain_ms`, MD5's chain model for one blob (its byte bound is
    no yardstick for a long serial chain), and `host_ms`, hashlib's MD5 of
    the same number of blobs of that length one after another on one host
    core (the median of 3)."""
    shapes = []
    for length in sorted(set(lengths)):
        sizes = [n for n, ln, _ in batches if ln == length]
        if sizes:
            shapes.append((int(np.bincount(sizes).argmax()), length))
    rows = hash_shape_times(dev, seed, HASH_WRAPPERS, md5_ops_per_block,
                            shapes=tuple(shapes), gear=False)
    for shape_rows in rows.values():
        for r in shape_rows:
            r["path"] = path
    rng = np.random.default_rng([seed, 23])
    for r in rows["md5_batch"]:
        n, length = r["shape"]
        if length > 4096:
            blobs = [rng.bytes(length) for _ in range(n)]
            host = []
            for _ in range(3):
                t0 = time.perf_counter()
                for b in blobs:
                    hashlib.md5(b).digest()
                host.append((time.perf_counter() - t0) * 1e3)
            r.update(chain_ms=md5_chain_ms(length), host_ms=float(np.median(host)))
    return rows


def filer_phase(dev: torch.device, n_files: int, large_bytes: int, md5_ops_per_block: int,
                seed: int) -> dict:
    """BASELINE config 3 as the filer takes it: a port MasterServer (pulse
    1 s), two VolumeServers and a FilerServer, all on the card, in this
    process. n_files seeded 4 KiB files PUT from 16 threads, each waiting
    for its response (one chunk, one assign, one needle POST and one ETag
    through the filer's hash service each); 4 uploads of large_bytes from 4
    threads (4 MiB chunks, one batched assign each); one overwritten, one
    deleted. The hash launches are counted over those writes. Reads: every
    large file whole, 256 ranged GETs across chunk boundaries, 1,024 small
    files, one conditional GET (304); the freed fids answer 404. Checks:
    every body equal, every response md5 and chunk ETag equal to hashlib,
    batch_blobs equal to the chunk ETags made, no host-hashed or failed
    blob, no per-chunk assign fallback. Then the hash kernels timed at the
    phase's commonest batch shapes."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke-filer-", dir=REPO / "build")
    master = MasterServer(port=0, pulse_seconds=1)
    master.start()
    servers, filer, svc = [], None, None
    batches = []  # (blobs, length, seconds) of every batch the flusher hashed
    try:
        for i in range(2):
            vs = VolumeServer([os.path.join(root, f"v{i}")], master.url,
                              pulse_seconds=PULSE_S, device=dev)
            vs.start()
            servers.append(vs)
        filer = FilerServer(master.url, port=0, device=dev)
        filer.start()
        svc = filer.hash_service
        check(filer.device.type == "cuda" and svc.device.type == "cuda"
              and all(vs.device.type == "cuda" for vs in servers), "a filer role is not on cuda")
        timed_batches(svc, batches)
        t0 = time.perf_counter()
        per = [n_files // FILER_THREADS + (t < n_files % FILER_THREADS)
               for t in range(FILER_THREADS)]
        small = []
        for t, count in enumerate(per):
            raw = np.random.default_rng([seed, 13, t]).bytes(count * FILER_SMALL)
            small.append([raw[i * FILER_SMALL : (i + 1) * FILER_SMALL] for i in range(count)])
            del raw
        # the last one overwrites file 0
        large = [np.random.default_rng([seed, 14, k]).bytes(large_bytes)
                 for k in range(FILER_LARGE + 1)]
        gen_s = time.perf_counter() - t0
        errors = []

        def small_path(t: int, i: int) -> str:
            return f"/small/t{t:02d}/f{i:06d}"

        zero_launches()
        # 1. small files from 16 waiting threads
        put_lat = [[] for _ in range(FILER_THREADS)]

        def put_small(t: int) -> None:
            c = Client(filer.url)
            try:
                for i, data in enumerate(small[t]):
                    t0 = time.perf_counter()
                    status, out = c.request("PUT", small_path(t, i), data, OCTET)
                    put_lat[t].append(time.perf_counter() - t0)
                    if status != 201 or json.loads(out)["md5"] != hashlib.md5(data).hexdigest():
                        errors.append(f"PUT {small_path(t, i)} -> {status}: {out[:200]!r}")
                        return
            except BaseException as e:  # re-raised on the main thread
                errors.append(repr(e))
            finally:
                c.close()

        small_s = run_threads(put_small, FILER_THREADS)
        check(not errors, f"filer phase: {errors[:3]}")
        # 2. large uploads from 4 threads, then one overwritten and one deleted
        large_s = [0.0] * FILER_LARGE

        def put_large(k: int, path: str = "", data: bytes = b"") -> None:
            path, data = path or f"/large/{k}", data or large[k]
            c = Client(filer.url)
            try:
                t0 = time.perf_counter()
                status, out = c.request("PUT", path, data, OCTET)
                if k < FILER_LARGE:
                    large_s[k] = time.perf_counter() - t0
                if status != 201 or json.loads(out)["md5"] != hashlib.md5(data).hexdigest():
                    errors.append(f"PUT {path} -> {status}: {out[:200]!r}")
            except BaseException as e:
                errors.append(repr(e))
            finally:
                c.close()

        large_wall = run_threads(put_large, FILER_LARGE)
        check(not errors, f"filer phase: {errors[:3]}")
        freed = [c.file_id for k in (0, 1) for c in filer.filer.find_entry(f"/large/{k}").chunks]
        t0 = time.perf_counter()
        put_large(FILER_LARGE, "/large/0", large[FILER_LARGE])
        overwrite_s = time.perf_counter() - t0
        check(not errors, f"filer overwrite: {errors[:3]}")
        status, _, _ = http_request("DELETE", filer.url + "/large/1")
        check(status == 204, f"DELETE /large/1 -> {status}")
        launches = read_launches()
        del svc._batch_hash
        chunks_per_large = -(-large_bytes // filer.chunk_size)
        etags = n_files + (FILER_LARGE + 1) * chunks_per_large
        check(svc.batch_blobs == etags,
              f"batch_blobs {svc.batch_blobs} != the {etags} chunk ETags the uploads made")
        check(svc.host_blobs == 0, f"{svc.host_blobs} blobs hashed on the host")
        check(svc.failed_blobs == 0, "the hash service failed a batch")
        check(filer.assign_batch_fallbacks == 0,
              f"{filer.assign_batch_fallbacks} multi-chunk uploads fell back to per-chunk assigns")
        for name in ("crc32c_batch", "md5_batch"):
            check(launches[name] > 0, f"the filer path launched no {name} kernel")
        # 3. reads
        content = {0: large[FILER_LARGE], 2: large[2], 3: large[3]}
        c = Client(filer.url)
        try:
            t0 = time.perf_counter()
            for k, data in content.items():
                status, got = c.request("GET", f"/large/{k}")
                check(status == 200 and got == data, f"GET /large/{k}")
            whole_s = time.perf_counter() - t0
            status, _ = c.request("GET", "/large/1")
            check(status == 404, f"GET of the deleted /large/1 -> {status}")
            rng = np.random.default_rng([seed, 15])
            chunk = filer.chunk_size
            ranged_lat = []
            for _ in range(FILER_RANGED):
                k = int(rng.choice(list(content)))
                edge = int(rng.integers(1, chunks_per_large)) * chunk
                start = edge - int(rng.integers(1, chunk // 2))
                end = min(edge + int(rng.integers(0, chunk // 2)), large_bytes - 1)
                t0 = time.perf_counter()
                status, got = c.request("GET", f"/large/{k}", headers={"Range": f"bytes={start}-{end}"})
                ranged_lat.append(time.perf_counter() - t0)
                check(status == 206 and got == content[k][start : end + 1],
                      f"ranged GET /large/{k} {start}-{end}")
            get_lat = []
            for j in rng.choice(n_files, size=min(FILER_SMALL_GETS, n_files), replace=False):
                t, i = int(j) % FILER_THREADS, int(j) // FILER_THREADS
                t0 = time.perf_counter()
                status, got = c.request("GET", small_path(t, i))
                get_lat.append(time.perf_counter() - t0)
                check(status == 200 and got == small[t][i], f"GET {small_path(t, i)}")
            c.conn.request("GET", small_path(0, 0))
            resp = c.conn.getresponse()
            resp.read()
            etag = resp.getheader("ETag")
            status, got = c.request("GET", small_path(0, 0), headers={"If-None-Match": etag})
            check(status == 304 and got == b"", f"conditional GET -> {status}")
        finally:
            c.close()
        for fid in freed:
            (url,) = filer.client.lookup_file_id(fid)
            check(http_request("GET", url)[0] == 404, f"freed fid {fid} still answers")
        # 4. every chunk ETag against hashlib (the store, in process)
        for t in range(FILER_THREADS):
            for i, data in enumerate(small[t]):
                e = filer.filer.find_entry(small_path(t, i))
                check(len(e.chunks) == 1 and e.chunks[0].etag == hashlib.md5(data).hexdigest(),
                      f"{small_path(t, i)}: chunk ETag != hashlib")
        for k, data in content.items():
            e = filer.filer.find_entry(f"/large/{k}")
            check([ch.etag for ch in e.chunks]
                  == [hashlib.md5(data[o : o + chunk]).hexdigest()
                      for o in range(0, len(data), chunk)], f"/large/{k}: a chunk ETag != hashlib")
    finally:
        if filer is not None:
            filer.stop()
        for vs in servers:
            vs.stop()
        master.stop()
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    buckets = batch_buckets(batches)
    hash_rows = path_hash_times(dev, seed, md5_ops_per_block, batches,
                                (FILER_SMALL, filer.chunk_size), "filer")
    small_lat = [x for lat in put_lat for x in lat]
    return dict(
        files=n_files, file_bytes=FILER_SMALL, threads=FILER_THREADS, in_flight_per_thread=1,
        small_s=small_s, files_per_s=n_files / small_s,
        **{f"put_{k}": v for k, v in _pcts(small_lat).items()},
        large_uploads=FILER_LARGE, large_bytes=large_bytes, chunks_per_large=chunks_per_large,
        large_wall_s=large_wall, large_gbps=FILER_LARGE * large_bytes / large_wall / 1e9,
        large_gbps_each=[large_bytes / s / 1e9 for s in large_s],
        overwrite_s=overwrite_s, overwrite_gbps=large_bytes / overwrite_s / 1e9,
        get_whole_gbps=sum(len(d) for d in content.values()) / whole_s / 1e9,
        ranged_gets=FILER_RANGED, **{f"ranged_{k}": v for k, v in _pcts(ranged_lat).items()},
        small_gets=len(get_lat), **{f"get_{k}": v for k, v in _pcts(get_lat).items()},
        conditional_get=304,
        freed_fids_404=len(freed), chunk_etags=etags, batch_blobs=svc.batch_blobs,
        host_blobs=svc.host_blobs, failed_blobs=svc.failed_blobs,
        assign_batch_fallbacks=filer.assign_batch_fallbacks,
        hash_batches=len(batches), hash_buckets=buckets, launches=launches,
        all_equal_hashlib=True, hash_kernels=hash_rows, generate_s=gen_s,
        wall_s=wall, wall_limit_s=FILER_WALL_LIMIT_S, over_wall_limit=wall > FILER_WALL_LIMIT_S,
        cuts=FILER_CUTS, cryptography_installed=cipher_util.available())


# --- phase 14: the volume integrity plane -------------------------------------------
SCRUB_RACKS = ("r1", "r1", "r2")  # replication 001 pairs the two r1 servers
SCRUB_THREADS = 8  # client threads assigning and POSTing replicated files
SCRUB_FILE = 4096
SCRUB_FLIPS = 16  # needle byte flips on one replica
SCRUB_SEALED_BYTES = 256 * MIB  # log-uniform needles, all 14 shards local
SCRUB_ONLINE_BYTES = 64 * MIB
SCRUB_VIDS = {"bulk": 101, "sealed": 102, "online": 103}
SCRUB_SHARD = 5  # the sealed volume's flipped shard
SCRUB_SAMPLE = 1024  # replicated files read back after the repairs
SCRUB_VACUUM_SHARE = 0.3  # needles of one replicated volume deleted before the vacuum
SCRUB_WALL_LIMIT_S = 150
SCRUB_SHAPES = {"crc32c_batch": (1024, SCRUB_FILE), "gf256_matmul": ("scrub", (10, 4096))}
SCRUB_CUTS = ("256 MiB of 4 KiB needles in one volume of the 30 GB volume limit (1 GiB until"
              " the sync_mq phase took room in the run, 512 MiB until the secure_ha phase did)",
              "1,024 replicated 4 KiB files of config 3's 1M blobs: three servers, the master"
              " and 8 clients share one process and one GIL (32,768 took the phase 294-310 s"
              " and 8,192 165 s, past its 150 s limit; 4,096 until the gateways phase took"
              " room in the run, 2,048 until the observe phase did)",
              "one sealed volume of 256 MiB and one online volume of 64 MiB")


def flip_byte(path: str, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def scrub_counters(servers: list) -> dict:
    """The servers' scrub counters summed: bytes and seconds by kernel."""
    out = {"bytes": {}, "seconds": {}}
    for vs in servers:
        for key in out:
            for k, v in vs.scrubber.counters[key].items():
                out[key][k] = out[key].get(k, 0) + v
    return out


def scrub_needle_equal(a, b, nid: int) -> bool:
    """Two replicas hold the same needle: every field but the append stamp
    and last_modified, which come from each server's own clock."""
    x, y = a.read_needle(nid), b.read_needle(nid)
    return (x.cookie, x.id, x.size, x.data, x.flags, x.name, x.mime, x.checksum) == \
        (y.cookie, y.id, y.size, y.data, y.flags, y.name, y.mime, y.checksum)


def run_threads(fn, n: int) -> float:
    """fn(t) on n threads at once; the wall until the last one ends."""
    threads = [threading.Thread(target=fn, args=(t,)) for t in range(n)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return time.perf_counter() - t0


def replicated_ingest(master_url: str, raw: bytes, file_bytes: int, threads: int,
                      replication: str = "001") -> dict:
    """len(raw) // file_bytes files through /dir/assign?replication= and a
    POST each, from `threads` threads that each wait for their 201 (each
    write fans out to its replica before it is acked). Returns the files
    [(fid, url)], the wall and the PUT latency percentiles."""
    n_files = len(raw) // file_bytes
    files = [None] * n_files
    lat = [[] for _ in range(threads)]
    errors = []

    def ingest(t: int) -> None:
        m = Client(master_url)
        conns = {}
        try:
            for i in range(t, n_files, threads):
                t0 = time.perf_counter()
                status, out = m.request("GET", f"/dir/assign?replication={replication}")
                if status != 200:
                    errors.append(f"assign -> {status}: {out[:200]!r}")
                    return
                a = json.loads(out)
                c = conns.get(a["url"]) or conns.setdefault(
                    a["url"], Client(f"http://{a['url']}"))
                status, out = c.request("POST", f"/{a['fid']}",
                                        raw[i * file_bytes : (i + 1) * file_bytes], OCTET)
                if status != 201:
                    errors.append(f"POST {a['fid']} -> {status}: {out[:200]!r}")
                    return
                lat[t].append(time.perf_counter() - t0)
                files[i] = (a["fid"], a["url"])
        finally:
            m.close()
            for c in conns.values():
                c.close()

    ingest_s = run_threads(ingest, threads)
    check(not errors and all(files), f"replicated ingest: {errors[:3]}")
    return dict(files=files, ingest_s=ingest_s,
                **{f"put_{k}": v for k, v in _pcts([x for t in lat for x in t]).items()})


def scrub_phase(dev: torch.device, n_files: int, bulk_bytes: int, md5_ops_per_block: int,
                seed: int) -> dict:
    """The volume integrity plane on the card: a port MasterServer (pulse
    1 s) and three VolumeServers (racks r1, r1, r2; scrubbers unthrottled,
    no scrub loop) on cuda, one process. n_files seeded 4 KiB files go
    through /dir/assign?replication=001 and POSTs from 8 waiting threads
    (each write fans out to the other r1 server before it is acked); the
    replicas hold the same needles. In process, on r2's server: bulk_bytes
    of 4 KiB needles in one volume, 256 MiB of log-uniform needles encoded
    in place (all 14 shards local) and a 64 MiB ecOnline volume. A clean
    `volume.scrub -dryRun` (counted: crc32c_batch and gf256_matmul must
    launch, 99 % of the 4 KiB volumes' bytes batched), then once more
    under torch.profiler for the device's idle share; seeded damage (16
    needle flips on one replica, a sealed shard flip, an online parity-row
    flip, a stale .ec03.tmp, a needle on one replica only) found exactly;
    `volume.scrub -apply`, `detect` with plan and apply for the
    divergence, `ec.rebuild` of the deleted shard; every read, the shard
    and the digests checked, a second pass clean. Then 30 % of one
    replicated volume deleted over HTTP, `volume.vacuum -garbageThreshold
    0.2`, both replicas shrunk to their live records, a pass clean."""
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke-scrub-", dir=REPO / "build")
    master = MasterServer(port=0, pulse_seconds=1)
    master.start()
    servers = []
    res = {}
    try:
        for i, rack in enumerate(SCRUB_RACKS):
            vs = VolumeServer([os.path.join(root, f"v{i}")], master.url, rack=rack,
                              pulse_seconds=PULSE_S, scrub_rate_mb=0, device=dev)
            vs.start()
            servers.append(vs)
        check(all(vs.device.type == "cuda" and vs.scrubber.device.type == "cuda"
                  for vs in servers), "a scrub-phase server or scrubber is not on cuda")
        ids = [vs.node_id for vs in servers]
        env = TimedEnv(master.url)
        check(run_command(env, "lock") == "lock acquired", "lock")
        run_command(env, "volume.vacuum.disable")  # the shell's vacuum below, not the pulse's
        zero_launches()

        # 1. replicated ingest from 8 waiting threads
        raw = np.random.default_rng([seed, 16]).bytes(n_files * SCRUB_FILE)
        ing = replicated_ingest(master.url, raw, SCRUB_FILE, SCRUB_THREADS)
        files = ing.pop("files")  # (fid, url)
        rvids = sorted({int(f.split(",")[0]) for f, _ in files})
        for vid in rvids:
            a, b = (vs.store.get_volume(vid) for vs in servers[:2])
            check(a is not None and b is not None, f"volume {vid} is not on both r1 servers")
            keys = [k for k, _, _ in a.nm.ascending_visit()]
            check(keys == [k for k, _, _ in b.nm.ascending_visit()]
                  and a.needle_map_digest() == b.needle_map_digest()
                  and all(scrub_needle_equal(a, b, k) for k in keys),
                  f"replicas of volume {vid} differ")
        res.update(files=n_files, file_bytes=SCRUB_FILE, threads=SCRUB_THREADS,
                   replicated_volumes=len(rvids), files_per_s=n_files / ing["ingest_s"],
                   **ing)

        # 2. in process on r2's server: the 4 KiB volume, the sealed volume
        # and the online volume
        s2 = servers[2]
        admin = Client(s2.url)
        for name, vid in SCRUB_VIDS.items():
            admin.json("/admin/allocate_volume",
                       {"volume": vid, **({"ecOnline": True} if name == "online" else {})})
        t0 = time.perf_counter()
        bulk = np.random.default_rng([seed, 17]).bytes(bulk_bytes)
        n_bulk = bulk_bytes // SCRUB_FILE
        cookie = 0x5C5C5C5C
        for i in range(n_bulk):
            s2.store.write(SCRUB_VIDS["bulk"], Needle(
                cookie=cookie, id=i + 1, data=bulk[i * SCRUB_FILE : (i + 1) * SCRUB_FILE]))
        bulk_write_s = time.perf_counter() - t0
        rng = np.random.default_rng([seed, 18])
        logu = {}
        for vid_name, nbytes in (("sealed", SCRUB_SEALED_BYTES), ("online", SCRUB_ONLINE_BYTES)):
            pool, used, nid = rng.bytes(nbytes), 0, 0
            v = s2.store.get_volume(SCRUB_VIDS[vid_name])
            while used < nbytes:
                size = min(int(np.exp(rng.uniform(np.log(1024), np.log(4 * MIB)))),
                           nbytes - used)
                nid += 1
                s2.store.write(SCRUB_VIDS[vid_name],
                               Needle(cookie=cookie, id=nid, data=pool[used : used + size]))
                logu[(vid_name, nid)] = (used, size)
                used += size
                if v.online_ec is not None:
                    v.online_ec.pump()
            logu[vid_name] = pool
        won = s2.store.get_volume(SCRUB_VIDS["online"]).online_ec
        won.pump(force=True)
        check(won.active and won.watermark >= 4 * won.stripe,
              f"the online volume's writer: active {won.active}, watermark {won.watermark}")
        admin.json("/admin/ec/generate", {"volume": SCRUB_VIDS["sealed"]})
        admin.json("/admin/ec/mount", {"volume": SCRUB_VIDS["sealed"]})
        ev = s2.store.get_ec_volume(SCRUB_VIDS["sealed"])
        check(ev is not None and ev.shard_ids() == list(range(14)), "the sealed volume's shards")
        shard_path = ev.data_base + geometry.to_ext(SCRUB_SHARD)
        shard_copy = os.path.join(root, "shard.orig")
        shutil.copyfile(shard_path, shard_copy)
        live = sum(1 for vs in servers for loc in vs.store.locations
                   for v in loc.volumes.values() for _ in v.nm.ascending_visit())
        # the 4 KiB needles: bulk and the replicated files on both replicas
        bytes_4k = SCRUB_FILE * (n_bulk + 2 * n_files)
        res.update(bulk_needles=n_bulk, bulk_bytes=bulk_bytes, bulk_write_s=bulk_write_s,
                   sealed_bytes=SCRUB_SEALED_BYTES, online_bytes=SCRUB_ONLINE_BYTES,
                   live_needles=live)

        # 3. the clean pass, counted
        before = read_launches()
        base = scrub_counters(servers)
        t0 = time.perf_counter()
        out = run_command(env, "volume.scrub -dryRun")
        pass_s = time.perf_counter() - t0
        after = read_launches()
        pass_launches = {k: after[k] - before[k] for k in ("crc32c_batch", "gf256_matmul")}
        check(out.endswith("scrub: clean — no silent damage found"),
              f"the clean pass found damage: {out[-400:]}")
        checked = sum(vs.scrubber.stats["needles_checked"] for vs in servers)
        check(checked == live, f"the clean pass checked {checked} needles, not {live}")
        counters = scrub_counters(servers)
        by_kernel = {k: counters["bytes"][k] - base["bytes"].get(k, 0) for k in counters["bytes"]}
        secs = {k: counters["seconds"][k] - base["seconds"].get(k, 0.0)
                for k in counters["seconds"]}
        check(by_kernel["batched"] >= 0.99 * bytes_4k,
              f"{by_kernel['batched']} of the 4 KiB volumes' {bytes_4k} bytes batched")
        for name, n in pass_launches.items():
            check(n > 0, f"the clean scrub pass launched no {name} kernel")
        pass_bytes = sum(by_kernel.values())
        res.update(
            pass_s=pass_s, pass_bytes=pass_bytes, pass_gbps=pass_bytes / pass_s / 1e9,
            pass_needles_per_s=checked / pass_s, pass_launches=pass_launches,
            pass_bytes_by_kernel=by_kernel, pass_seconds_by_kernel=secs,
            pass_gbps_by_kernel={k: by_kernel[k] / secs[k] / 1e9 if secs[k] else None
                                 for k in by_kernel},
            batched_share_of_4k=by_kernel["batched"] / bytes_4k,
            stripes_checked=sum(vs.scrubber.stats["stripes_checked"] for vs in servers),
            codec_calls=sum(vs.scrubber.counters["codec_calls"] for vs in servers))

        # the same clean pass again under torch.profiler, for the device's
        # busy share (the counted pass above runs unprofiled). The profiler
        # may drop events on the card's host: the busy time seen is also
        # scaled by the window's crc32c_batch launches over the events seen
        before = read_launches()["crc32c_batch"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = run_command(env, "volume.scrub -dryRun")
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
        check(out.endswith("no silent damage found"), f"the profiled pass: {out[-400:]}")
        made = read_launches()["crc32c_batch"] - before
        device_us, events = device_time_by_event(prof)
        seen = sum(n for k, n in events.items() if "crc32c_batch_kernel" in k)
        busy_s = sum(device_us.values()) / 1e6
        busy_scaled_s = busy_s * made / seen if seen else None
        top = sorted(device_us.items(), key=lambda kv: -kv[1])[:6]
        res["profiled_pass"] = dict(
            seconds=prof_s, device_busy_s=busy_s, device_idle_share=1 - busy_s / prof_s,
            device_busy_scaled_s=busy_scaled_s,
            device_idle_share_scaled=1 - busy_scaled_s / prof_s if seen else None,
            crc_launches=made, crc_events=seen,
            device_ms_by_event={k: v / 1e3 for k, v in top},
            events_by_event={k: events[k] for k, _ in top})

        # 4. seeded damage, found exactly, repaired
        s0v = {vid: servers[0].store.get_volume(vid) for vid in rvids}
        pick = np.random.default_rng([seed, 19])
        flips = []
        for i in sorted(pick.choice(n_files, SCRUB_FLIPS, replace=False).tolist()):
            vid = int(files[i][0].split(",")[0])
            nid, _ = file_id.parse_key_hash_with_delta(files[i][0].split(",")[1])
            off, _ = s0v[vid].nm.get(nid)
            flip_byte(s0v[vid].base_name + ".dat", off + 16 + 4 + int(pick.integers(0, SCRUB_FILE)))
            flips.append((i, vid, nid))
        flip_byte(shard_path, 100)
        flip_byte(won.volume.base_name + geometry.to_ext(10), 10)  # parity row 0
        tmp = os.path.join(s2.store.locations[0].directory, "999.ec03.tmp")
        with open(tmp, "wb") as f:
            f.write(b"\0" * 4096)
        os.utime(tmp, (time.time() - 7200,) * 2)
        lonely_vid = flips[0][1]
        lonely = np.random.default_rng([seed, 20]).bytes(SCRUB_FILE)
        lonely_fid = f"{lonely_vid},{file_id.format_needle_id_cookie(1 << 40, 77)}"
        c0 = Client(servers[0].url)
        status, out = c0.request("POST", f"/{lonely_fid}?type=replicate", lonely, OCTET)
        check(status == 201, f"the one-replica write -> {status}: {out[:200]!r}")
        found = []
        for vs in servers:
            c = Client(vs.url)
            found += [(f["kind"], f["volume_id"], f["node"], f.get("needle"), f.get("shard"))
                      for f in c.json("/admin/scrub/run", {})["findings"]]
            c.close()
        want = sorted([("corrupt_needle", vid, ids[0], nid, None) for _, vid, nid in flips]
                      + [("corrupt_shard", SCRUB_VIDS["sealed"], ids[2], None, SCRUB_SHARD),
                         ("parity_mismatch", SCRUB_VIDS["online"], ids[2], None, None)])
        check(sorted(found, key=str) == sorted(want, key=str),
              f"scrub findings {sorted(found, key=str)[:20]} != the injected {want[:20]}")
        check(not os.path.exists(tmp) and s2.scrubber.stats["tmp_removed"] == 1,
              "the stale .ec03.tmp was not swept")
        for vs in servers:
            vs.heartbeat_once()
        tasks = scrub.detect(master)
        div = [f for t in tasks for f in t.params["findings"] if f["kind"] == "replica_divergence"]
        check([(f["volume_id"], f["node"], f["source_node"]) for f in div]
              == [(lonely_vid, ids[1], ids[0])], f"detect's divergence: {div}")
        env.seconds.clear()
        t0 = time.perf_counter()
        out = run_command(env, "volume.scrub -apply")
        apply_s = time.perf_counter() - t0
        check(f"repaired {SCRUB_FLIPS + 2} finding(s):" in out and "FAILED" not in out,
              f"volume.scrub -apply: {out[-600:]}")
        for vs in servers:
            vs.heartbeat_once()
        tasks = scrub.detect(master)
        fs = [f for t in tasks for f in t.params["findings"]]
        check([f["kind"] for f in fs] == ["replica_divergence"], f"detect after the repairs: {fs}")
        t0 = time.perf_counter()
        synced = scrub.apply_scrub_repairs(env, scrub.plan_scrub_repairs(env, fs))
        sync_s = time.perf_counter() - t0
        check(synced == [f"volume {lonely_vid}: re-synced from {ids[0]} (+1 needles, -0 stale)"],
              f"the divergence heal: {synced}")
        t0 = time.perf_counter()
        out = run_command(env, f"ec.rebuild -volumeId {SCRUB_VIDS['sealed']}")
        rebuild_s = time.perf_counter() - t0
        check(same_file(shard_path, shard_copy), f"the rebuilt shard {SCRUB_SHARD} != the original")
        c1 = Client(servers[1].url)
        for c in (c0, c1):
            for i, vid, nid in flips:
                status, body = c.request("GET", f"/{files[i][0]}")
                check(status == 200 and body == raw[i * SCRUB_FILE : (i + 1) * SCRUB_FILE],
                      f"repaired needle {files[i][0]} reads wrong")
            status, body = c.request("GET", f"/{lonely_fid}")
            check(status == 200 and body == lonely, "the one-replica needle after the sync")
        for i in sorted(pick.choice(n_files, SCRUB_SAMPLE, replace=False).tolist()):
            status, _, body = http_request("GET", f"http://{files[i][1]}/{files[i][0]}")
            check(status == 200 and body == raw[i * SCRUB_FILE : (i + 1) * SCRUB_FILE],
                  f"GET {files[i][0]} reads wrong")
        s2c = Client(s2.url)
        for i in pick.choice(n_bulk, 256, replace=False).tolist():
            status, body = s2c.request(
                "GET", f"/{SCRUB_VIDS['bulk']},{file_id.format_needle_id_cookie(i + 1, cookie)}")
            check(status == 200 and body == bulk[i * SCRUB_FILE : (i + 1) * SCRUB_FILE],
                  f"bulk needle {i + 1} reads wrong")
        for (name, nid), (off, size) in list((k, v) for k, v in logu.items()
                                              if isinstance(k, tuple))[:: 8]:
            status, body = s2c.request(
                "GET", f"/{SCRUB_VIDS[name]},{file_id.format_needle_id_cookie(nid, cookie)}")
            check(status == 200 and body == logu[name][off : off + size],
                  f"{name} needle {nid} reads wrong")
        for c in (admin, c0, c1, s2c):
            c.close()
        for vid in rvids:
            check(servers[0].store.get_volume(vid).needle_map_digest()
                  == servers[1].store.get_volume(vid).needle_map_digest(),
                  f"volume {vid}: the replicas' digests differ after the repairs")
        out = run_command(env, "volume.scrub -dryRun")
        check(out.endswith("no silent damage found"), f"the pass after the repairs: {out[-400:]}")
        res.update(
            flips=SCRUB_FLIPS, findings=len(found), findings_exact=True, tmp_swept=True,
            apply_s=apply_s, sync_s=sync_s, ec_rebuild_s=rebuild_s,
            repair_walls_s={"corrupt_needle": env.seconds.get("scrub/repair_needle", 0.0),
                            "corrupt_shard": env.seconds.get("ec/delete_shards", 0.0),
                            "parity_mismatch": env.seconds.get("ec/online/rebuild", 0.0),
                            "replica_divergence": sync_s},
            shard_restored=True, digests_agree=True, clean_after_repairs=True)

        # 5. vacuum: 30 % of one replicated volume deleted over HTTP
        vvid = max(rvids, key=lambda v: servers[0].store.get_volume(v).file_count())
        mine = [(i, f, u) for i, (f, u) in enumerate(files) if int(f.split(",")[0]) == vvid]
        gone = sorted(pick.choice(len(mine), int(SCRUB_VACUUM_SHARE * len(mine)),
                                  replace=False).tolist())
        for j in gone:
            _, f, u = mine[j]
            status, _, out = http_request("DELETE", f"http://{u}/{f}")
            check(status == 202, f"DELETE {f} -> {status}: {out[:200]!r}")
        vols = [vs.store.get_volume(vvid) for vs in servers[:2]]
        pre = [v.size() for v in vols]
        for vs in servers:
            vs.heartbeat_once()
        t0 = time.perf_counter()
        out = run_command(env, "volume.vacuum -garbageThreshold 0.2")
        vacuum_s = time.perf_counter() - t0
        check(out == f"vacuumed: {vvid}@{ids[0]}, {vvid}@{ids[1]}", f"volume.vacuum: {out}")
        for v in vols:
            want_size = SUPER_BLOCK_SIZE + sum(get_actual_size(sz, v.version())
                                               for _, _, sz in v.nm.ascending_visit())
            check(v.size() == want_size and v.deleted_count() == 0,
                  f"volume {vvid} after the vacuum: {v.size()} bytes, not {want_size}")
        check(vols[0].needle_map_digest() == vols[1].needle_map_digest(),
              "the replicas' digests differ after the vacuum")
        gone_set = set(gone)
        kept = [j for j in range(len(mine)) if j not in gone_set]
        for j in pick.choice(len(kept), min(256, len(kept)), replace=False).tolist():
            i, f, u = mine[kept[j]]
            status, _, body = http_request("GET", f"http://{u}/{f}")
            check(status == 200 and body == raw[i * SCRUB_FILE : (i + 1) * SCRUB_FILE],
                  f"GET {f} after the vacuum reads wrong")
        for j in gone[:16]:
            check(http_request("GET", f"http://{mine[j][2]}/{mine[j][1]}")[0] == 404,
                  "a deleted needle reads after the vacuum")
        out = run_command(env, "volume.scrub -dryRun")
        check(out.endswith("no silent damage found"), f"the pass after the vacuum: {out[-400:]}")
        run_command(env, "volume.vacuum.enable")
        res.update(vacuum_volume=vvid, vacuum_deleted=len(gone), vacuum_s=vacuum_s,
                   vacuum_reclaimed_bytes=[p - v.size() for p, v in zip(pre, vols)],
                   clean_after_vacuum=True)
        launches = read_launches()
        res["launches"] = {k: launches[k] for k in ("crc32c_batch", "gf256_matmul")}

        # one flush of the 4 KiB volume on the card: kernel, plain, host CRC
        blocks = torch.from_numpy(np.frombuffer(bulk[: 1024 * SCRUB_FILE], np.uint8)
                                  .reshape(1024, SCRUB_FILE).copy()).to(dev)
        got = u32(crc32c_batch_kernel(blocks)).cpu().numpy()
        plain = u32(crc32c_batch_torch(blocks)).cpu().numpy()
        host = np.array([crc.crc32c(bulk[i * SCRUB_FILE : (i + 1) * SCRUB_FILE])
                         for i in range(1024)])
        check(np.array_equal(got, plain) and np.array_equal(got, host),
              "one scrub flush's CRCs: kernel, plain version and host CRC disagree")
        res["flush_crc_max_abs_err"] = int(np.abs(got.astype(np.int64) - plain).max())
    finally:
        for vs in servers:
            vs.stop()
        master.stop()
        shutil.rmtree(root, ignore_errors=True)
    n, length = SCRUB_SHAPES["crc32c_batch"]
    res["crc_kernel"] = hash_shape_times(dev, seed, HASH_WRAPPERS, md5_ops_per_block,
                                         shapes=((n, length),), gear=False)["crc32c_batch"]
    res["gf_kernel"] = gf256_shape_times(dev, seed, gf256_matmul,
                                         shapes=(SCRUB_SHAPES["gf256_matmul"],))
    for row in res["crc_kernel"] + res["gf_kernel"]:
        row["path"] = "scrub"
    wall = time.perf_counter() - t_phase
    res.update(wall_s=wall, wall_limit_s=SCRUB_WALL_LIMIT_S,
               over_wall_limit=wall > SCRUB_WALL_LIMIT_S, cuts=SCRUB_CUTS)
    return res


MAINT_RACKS = ("r1", "r1", "r2", "r2")  # replication 001 pairs servers of a rack
MAINT_THREADS = 8  # client threads assigning and POSTing replicated files
MAINT_FILE = 4096
# the replicated volumes, allocated before the ingest so each server holds
# two and the daemon's balance detector (spread > 2) stays quiet
MAINT_REPLICATED = {1: (0, 1), 2: (0, 1), 3: (2, 3), 4: (2, 3)}
MAINT_EC_VID = 9  # the log-uniform volume, written in process on server 0
MAINT_SHARD = 3  # the data shard lost
MAINT_GARBAGE_THRESHOLD = 0.3  # the master's (`-garbageThreshold`, the reference default)
MAINT_DELETE_SHARE = 0.4  # of the replicated files: past the garbage threshold
MAINT_SCRUB_S = 3.0  # each server's scrub loop
MAINT_SCAN_S = 1.0  # the daemon's scan interval
MAINT_DEADLINE_S = 90
MAINT_WALL_LIMIT_S = 150
MAINT_CUTS = ("256 MiB of log-uniform needles in one EC volume of the 30 GB volume limit",
              "1,024 replicated 4 KiB files in 4 volumes: four servers, the master, the"
              " daemon and 8 clients share one process and one GIL, inside the phase's"
              " 150 s (2,048 until the sync_mq phase took room in the run)")


def maintenance_phase(dev: torch.device, ec_bytes: int, n_files: int, seed: int) -> dict:
    """The maintenance daemon heals with no shell command: a port master
    (pulse 1 s, `maintenance=True`, scan interval 1 s, garbage threshold
    0.3) and four VolumeServers on cuda (racks r1, r1, r2, r2; scrub loop
    every 3 s, unthrottled), one process. Set-up, with the daemon paused
    (POST /maintenance/disable: the shell holds the admin lock) and the
    pulse's own vacuum round off (/vol/vacuum/disable): `ec_bytes`
    of log-uniform needles written in process into one volume on server 0,
    `lock`, `ec.encode` (14 shards over the four servers), `unlock`;
    `n_files` seeded 4 KiB files through /dir/assign?replication=001 from 8
    waiting threads into four volumes allocated two a server. Damage at
    once: 40 % of the files deleted, one byte flipped in one needle body of
    one replica's .dat, data shard 3 unmounted, its file removed and the
    rest remounted. Then POST /maintenance/enable, and nothing else acts:
    within 90 s /debug/maintenance must show a completed ec_rebuild,
    scrub and vacuum (every replicated volume) and no failed task. Checks:
    the rebuilt shard equal to the removed one and to gf_matmul_torch on
    the card over 10 survivors, the re-copied needle equal to the good
    replica's, every replica's .dat shrunk, gf256_matmul and crc32c_batch
    launched in the heal window, a clean `volume.scrub -dryRun` after the
    heal, every file read back (the deleted ones 404), one flush's CRCs
    equal to the plain version's. Reports the time to heal of each kind
    from its damage, the scans, the tasks by type and state, the mode
    `auto` chose, the launches and the card's name and power limit."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke-maint-", dir=REPO / "build")
    master = MasterServer(port=0, pulse_seconds=1, maintenance=True,
                          maintenance_interval=MAINT_SCAN_S,
                          garbage_threshold=MAINT_GARBAGE_THRESHOLD)
    master.start()
    servers = []
    res = {}
    try:
        mc = Client(master.url)
        mc.json("/maintenance/disable", {})  # paused while the shell sets up
        # a paused daemon hands vacuum back to the pulse: keep the pulse out,
        # so every vacuum below is the daemon's
        mc.json("/vol/vacuum/disable", {})
        for i, rack in enumerate(MAINT_RACKS):
            vs = VolumeServer([os.path.join(root, f"v{i}")], master.url, port=0, rack=rack,
                              pulse_seconds=PULSE_S, scrub_interval=MAINT_SCRUB_S,
                              scrub_rate_mb=0, device=dev)
            vs.start()
            servers.append(vs)
        check(all(vs.device.type == dev.type and vs.scrubber.device.type == dev.type
                  for vs in servers), "a maintenance-phase server or scrubber is off the card")
        ids = [vs.node_id for vs in servers]

        # 1. the EC volume: log-uniform needles in process, then ec.encode
        s0 = servers[0]
        Client(s0.url).json("/admin/allocate_volume", {"volume": MAINT_EC_VID})
        rng = np.random.default_rng([seed, 21])
        pool, used, nid, cookie = rng.bytes(ec_bytes), 0, 0, 0x6D61696E
        ec_needles = []
        while used < ec_bytes:
            size = min(int(np.exp(rng.uniform(np.log(1024), np.log(4 * MIB)))), ec_bytes - used)
            nid += 1
            s0.store.write(MAINT_EC_VID, Needle(cookie=cookie, id=nid,
                                                data=pool[used : used + size]))
            ec_needles.append((nid, used, size))
            used += size
        s0.heartbeat_once()
        env = CommandEnv(master.url)
        check(run_command(env, "lock") == "lock acquired", "lock")
        out = run_command(env, f"ec.encode -volumeId {MAINT_EC_VID}")
        check("shards spread" in out, f"ec.encode: {out[-300:]}")
        check(run_command(env, "unlock") == "lock released", "unlock")  # the last shell command

        # 2. replicated ingest into volumes allocated two a server
        for vid, pair in MAINT_REPLICATED.items():
            for i in pair:
                Client(servers[i].url).json("/admin/allocate_volume",
                                            {"volume": vid, "replication": "001"})
        for vs in servers:
            vs.heartbeat_once()
        raw = np.random.default_rng([seed, 22]).bytes(n_files * MAINT_FILE)
        ing = replicated_ingest(master.url, raw, MAINT_FILE, MAINT_THREADS)
        files = ing.pop("files")  # (fid, url)
        check({int(f.split(",")[0]) for f, _ in files} <= set(MAINT_REPLICATED),
              "an assign grew a volume past the four allocated")
        res.update(ec_bytes=ec_bytes, ec_needles=len(ec_needles), files=n_files,
                   files_per_s=n_files / ing["ingest_s"], **ing)
        for vs in servers:
            vs.heartbeat_once()
        st = json.loads(mc.request("GET", "/debug/maintenance")[1])
        check(st["configured"] and not st["enabled"] and not st["history"],
              f"the daemon acted while paused: {st.get('history')}")

        # 3. damage, all at once
        pick = np.random.default_rng([seed, 23])
        gone = set(pick.choice(n_files, int(MAINT_DELETE_SHARE * n_files),
                               replace=False).tolist())
        gone_list = sorted(gone)

        def delete(t: int) -> None:
            conns = {}
            try:
                for j in gone_list[t::MAINT_THREADS]:
                    f, u = files[j]
                    c = conns.get(u) or conns.setdefault(u, Client(f"http://{u}"))
                    status, out = c.request("DELETE", f"/{f}")
                    if status != 202:
                        errors.append(f"DELETE {f} -> {status}: {out[:200]!r}")
                        return
            finally:
                for c in conns.values():
                    c.close()

        errors = []
        delete_s = run_threads(delete, MAINT_THREADS)
        check(not errors, f"maintenance deletes: {errors[:3]}")
        t_deleted = time.time()
        pre_size = {(vid, i): servers[i].store.get_volume(vid).size()
                    for vid, pair in MAINT_REPLICATED.items() for i in pair}
        kept = [i for i in range(n_files) if i not in gone]
        victim_file = kept[int(pick.integers(0, len(kept)))]
        fid, url = files[victim_file]
        fvid = int(fid.split(",")[0])
        fnid, _ = file_id.parse_key_hash_with_delta(fid.split(",")[1])
        bad_i, good_i = MAINT_REPLICATED[fvid]
        bad_v = servers[bad_i].store.get_volume(fvid)
        off, _ = bad_v.nm.get(fnid)
        flip_byte(bad_v.base_name + ".dat", off + 16 + 4 + int(pick.integers(0, MAINT_FILE)))
        t_flipped = time.time()
        holder = next(vs for vs in servers if vs.store.get_ec_volume(MAINT_EC_VID) is not None
                      and MAINT_SHARD in vs.store.get_ec_volume(MAINT_EC_VID).shard_ids())
        shard_path = holder.store.get_ec_volume(MAINT_EC_VID).data_base + \
            geometry.to_ext(MAINT_SHARD)
        shard_copy = os.path.join(root, "shard.orig")
        shutil.copyfile(shard_path, shard_copy)
        hc = Client(holder.url)
        hc.json("/admin/ec/unmount", {"volume": MAINT_EC_VID})
        os.remove(shard_path)
        hc.json("/admin/ec/mount", {"volume": MAINT_EC_VID})  # the other shards; it heartbeats
        t_lost = time.time()
        res.update(deleted=len(gone), delete_s=delete_s, corrupt_volume=fvid,
                   corrupt_node=ids[bad_i], lost_shard=MAINT_SHARD, shard_holder=holder.node_id)

        # 4. the daemon alone heals
        repair0 = decoder.REPAIR.snapshot()
        zero_launches()
        t_enabled = time.time()
        mc.json("/maintenance/enable", {"dryRun": False})
        # the volumes past the threshold (each, at full size): the vacuum's work
        want_vacuum = {vid for vid, pair in MAINT_REPLICATED.items()
                       if servers[pair[0]].store.get_volume(vid).garbage_level()
                       > MAINT_GARBAGE_THRESHOLD}
        check(want_vacuum, "no replicated volume crossed the garbage threshold")

        def heals(h: dict) -> bool:
            """A completed task that repaired this phase's damage: the
            rebuild that wrote the lost shard, the scrub task that carried
            the corrupt needle's finding, a vacuum (other scrub tasks, such
            as a divergence seen while replicas compact, do not count)."""
            t = h["task"]
            if t["type"] == "ec_rebuild":
                return any("rebuilt shards" in a for a in h.get("applied", []))
            if t["type"] == "scrub":
                return any(f["kind"] == "corrupt_needle" and f.get("needle") == fnid
                           for f in t["params"].get("findings", []))
            return t["type"] == "vacuum"

        def heal_state(st: dict) -> tuple[dict, list]:
            ended = {}
            for h in st["history"]:
                if h["state"] == "completed" and heals(h):
                    t = h["task"]
                    ended.setdefault((t["type"], t["volume_id"]),
                                     (h["started"] + h["duration_ms"] / 1e3, h))
            failed = [h for h in st["history"] if h["state"] == "failed"]
            return ended, failed

        deadline = t_enabled + MAINT_DEADLINE_S
        while True:
            st = json.loads(mc.request("GET", "/debug/maintenance")[1])
            ended, failed = heal_state(st)
            check(not failed, f"a maintenance task failed: {failed[:3]}")
            present = {s for vs in servers
                       for s in (vs.store.get_ec_volume(MAINT_EC_VID).shard_ids()
                                 if vs.store.get_ec_volume(MAINT_EC_VID) else [])}
            healed = (("ec_rebuild", MAINT_EC_VID) in ended and len(present) == 14
                      and ("scrub", fvid) in ended
                      and all(("vacuum", v) in ended for v in want_vacuum))
            if healed:
                break
            check(time.time() < deadline,
                  f"not healed within {MAINT_DEADLINE_S} s: completed {sorted(ended)},"
                  f" shards {sorted(present)}, counts {st['counts']},"
                  f" queued {st['scheduler']['queued'][:5]}")
            time.sleep(0.25)
        heal_window_s = time.time() - t_enabled
        window = read_launches()
        repair1 = decoder.REPAIR.snapshot()
        st = json.loads(mc.request("GET", "/debug/maintenance")[1])
        ended, failed = heal_state(st)
        check(not failed, f"a maintenance task failed: {failed[:3]}")
        mc.json("/maintenance/disable", {})  # the checks below take the admin lock
        rebuild_entry = ended[("ec_rebuild", MAINT_EC_VID)][1]
        applied = " ".join(rebuild_entry.get("applied", []))
        mode = ("pipelined" if "(pipelined" in applied
                else "classic" if "(classic)" in applied else None)
        check(mode is not None, f"the ec_rebuild task applied nothing: {rebuild_entry}")
        scrub_entry = ended[("scrub", fvid)][1]
        check(scrub_entry.get("applied"), f"the scrub task applied nothing: {scrub_entry}")
        for name in ("gf256_matmul", "crc32c_batch"):
            check(window[name] > 0, f"the heal window launched no {name} kernel")
        res.update(
            heal_window_s=heal_window_s,
            time_to_heal_s={
                "ec_rebuild": ended[("ec_rebuild", MAINT_EC_VID)][0] - t_lost,
                "scrub": ended[("scrub", fvid)][0] - t_flipped,
                "vacuum_first": min(ended[("vacuum", v)][0] for v in want_vacuum) - t_deleted,
                "vacuum_all": max(ended[("vacuum", v)][0] for v in want_vacuum) - t_deleted},
            time_from_enable_s={
                "ec_rebuild": ended[("ec_rebuild", MAINT_EC_VID)][0] - t_enabled,
                "scrub": ended[("scrub", fvid)][0] - t_enabled,
                "vacuum_all": max(ended[("vacuum", v)][0] for v in want_vacuum) - t_enabled},
            task_ms={f"{k[0]}:{k[1]}": e[1]["duration_ms"] for k, e in sorted(ended.items())},
            scans=st["scans"], tasks=st["counts"], seconds_by_type=st["seconds"],
            failures=st["failures"], lazy_batch=st["lazy_batch"], events=st["events"],
            rebuild_mode_auto_chose=mode, rebuild_applied=rebuild_entry.get("applied"),
            repair_counters={k: {kk: repair1[k][kk] - repair0[k].get(kk, 0) for kk in repair1[k]}
                             if isinstance(repair1[k], dict) else repair1[k] - repair0[k]
                             for k in repair1},
            launches={k: window[k] for k in ("gf256_matmul", "crc32c_batch")},
            nvidia_smi=nvidia_smi())

        # 5. what the heal left
        ev = next(vs.store.get_ec_volume(MAINT_EC_VID) for vs in servers
                  if vs.store.get_ec_volume(MAINT_EC_VID) is not None
                  and MAINT_SHARD in vs.store.get_ec_volume(MAINT_EC_VID).shard_ids())
        rebuilt = ev.data_base + geometry.to_ext(MAINT_SHARD)
        check(same_file(rebuilt, shard_copy), "the rebuilt shard != the removed one")
        paths = {}
        for vs in servers:
            e = vs.store.get_ec_volume(MAINT_EC_VID)
            for s in (e.shard_ids() if e else []):
                paths.setdefault(s, e.data_base + geometry.to_ext(s))
        survivors = tuple(sorted(s for s in paths if s != MAINT_SHARD))[:10]
        x = torch.stack([torch.from_numpy(np.fromfile(paths[s], np.uint8)) for s in survivors])
        m = gf256.decode_matrix(10, 4, survivors, (MAINT_SHARD,))
        plain = gf_matmul_torch(m, x.to(dev))[0].cpu().numpy()
        del x
        check(np.array_equal(plain, np.fromfile(rebuilt, np.uint8)),
              "the rebuilt shard != gf_matmul_torch over 10 survivors on the card")
        good_v = servers[good_i].store.get_volume(fvid)
        bad_v = servers[bad_i].store.get_volume(fvid)
        check(scrub_needle_equal(bad_v, good_v, fnid),
              "the re-copied needle != the good replica's")
        for vid in sorted(want_vacuum):
            for i in MAINT_REPLICATED[vid]:
                v = servers[i].store.get_volume(vid)
                check(v.size() < pre_size[(vid, i)],
                      f"volume {vid} on {ids[i]}: {v.size()} bytes, not below"
                      f" {pre_size[(vid, i)]} after the vacuum")
        res["reclaimed_bytes"] = {f"{vid}@s{i}": pre_size[(vid, i)]
                                  - servers[i].store.get_volume(vid).size()
                                  for vid in sorted(want_vacuum)
                                  for i in MAINT_REPLICATED[vid]}
        check(run_command(env, "lock") == "lock acquired", "lock after the heal")
        out = run_command(env, "volume.scrub -dryRun")
        check(out.endswith("scrub: clean — no silent damage found"),
              f"the pass after the heal: {out[-400:]}")
        run_command(env, "unlock")
        conns = {}
        for i, (f, u) in enumerate(files):
            c = conns.get(u) or conns.setdefault(u, Client(f"http://{u}"))
            status, body = c.request("GET", f"/{f}")
            if i in gone:
                check(status == 404, f"deleted {f} reads {status}")
            else:
                check(status == 200 and body == raw[i * MAINT_FILE : (i + 1) * MAINT_FILE],
                      f"GET {f} after the heal reads wrong")
        for c in conns.values():
            c.close()
        for nid, o, size in ec_needles[:: max(1, len(ec_needles) // 64)]:
            status, _, body = http_request(
                "GET", f"{servers[1].url}/{MAINT_EC_VID},"
                       f"{file_id.format_needle_id_cookie(nid, cookie)}")
            check(status == 200 and body == pool[o : o + size],
                  f"EC needle {nid} after the heal reads wrong")
        res.update(shard_restored=True, needle_restored=True, replicas_shrunk=True,
                   clean_after_heal=True, files_read_back=n_files)

        # one scrub flush of the files (1,024 of them) on the card: kernel
        # against plain
        n_flush = min(1024, n_files)
        blocks = torch.from_numpy(np.frombuffer(raw[: n_flush * MAINT_FILE], np.uint8)
                                  .reshape(n_flush, MAINT_FILE).copy()).to(dev)
        got = u32(crc32c_batch_kernel(blocks)).cpu().numpy()
        want = u32(crc32c_batch_torch(blocks)).cpu().numpy()
        check(np.array_equal(got, want), "one flush's CRCs: kernel != plain version")
        res["flush_crc_max_abs_err"] = int(np.abs(got.astype(np.int64) - want).max())
    finally:
        master.stop()  # the daemon's scan, worker and lease threads end first
        for vs in servers:
            vs.stop()
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    res.update(wall_s=wall, wall_limit_s=MAINT_WALL_LIMIT_S,
               over_wall_limit=wall > MAINT_WALL_LIMIT_S, cuts=MAINT_CUTS)
    return res


# --- phase 15: the filer's dedup over HTTP, its reclaim and its client ------------------
FD_THREADS = 4  # client threads; thread t PUTs the uploads built from segment t
FD_GONE = (0, 1)  # uploads built from these segments are deleted before the gc
FD_RECENT_S = 1.1  # past dedup_gc's 1 s recently-referenced window
FD_WALL_LIMIT_S = 150
FD_GC_LINE = re.compile(r"scanned (\d+) index entries, dropped (\d+) \((\d+) bytes freed,"
                        r" (\d+) errors\)")
FD_CUTS = ("--filer-dedup-uploads (6) uploads of 64 MiB (0.375 GiB) of bench.py's 100 GB"
           " shifted-repeat stream, to fit the phase's 150 s (32 until the gateways phase"
           " took room in the run, 16 until the sync_mq phase did, 8 until the observe"
           " phase did)",
           "a master, two volume servers, the filer on one leveldb store and 4 clients in"
           " one process")


def dedup_segment(i: int) -> int:
    """The base segment of upload i of bench.py's stream (dedup_upload)."""
    return (i // 2) % 4 if i % 2 == 0 else (i // 3) % 4


def filer_dedup_phase(dev: torch.device, n_uploads: int, seed: int) -> dict:
    """BASELINE config 4 as an operator runs it, in this process: a port
    MasterServer (pulse 1 s), two VolumeServers and a FilerServer(dedup=True)
    on a leveldb store (the upstream filer's default embedded store), all on
    the card. n_uploads PUTs of 64 MiB built by dedup_upload from four seeded
    segments, from 4 threads that each wait for their 201 (thread t PUTs the
    uploads of segment t, so no two uploads of one content race), every
    body cut by gear_hash on the card; a MetaSubscriber on /__meta__/events
    counts the creates and deletes. Then every file's ?metadata=true, the
    uploads of segments 0 and 1 deleted, and the bytes to reclaim counted
    from that metadata alone: the fids only deleted files referenced.
    `fs.dedup.gc` through the port shell's filer handle must drop exactly
    those, each then 404 on its volume server, with no error; every
    survivor reads back equal; a second gc drops nothing; a deleted upload
    PUT again uploads chunks anew; a filer restarted on the same store dedups
    a survivor PUT again with no miss; `fs.verify /` passes and `cluster.ps`
    lists the filer. Checks also: every PUT's md5 against hashlib, the first
    upload's chunks at the plain cut rule's boundaries, gear_hash launched
    over the PUTs and equal to its plain version on the first segment."""
    from seaweedfs_tpu_torch.filer.meta_aggregator import MetaSubscriber

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke-filer-dedup-", dir=REPO / "build")
    store = os.path.join(root, "filer.leveldb")
    master = MasterServer(port=0, pulse_seconds=1)
    master.start()
    servers, filer, sub = [], None, None
    res = {}

    def start_filer() -> FilerServer:
        f = FilerServer(master.url, port=0, device=dev, dedup=True, store_kind="leveldb",
                        store_path=store)
        f.start()
        return f

    try:
        for i in range(2):
            vs = VolumeServer([os.path.join(root, f"v{i}")], master.url,
                              pulse_seconds=PULSE_S, device=dev)
            vs.start()
            servers.append(vs)
        filer = start_filer()
        check(filer.device.type == "cuda" and filer.dedup
              and all(vs.device.type == "cuda" for vs in servers), "a filer role is not on cuda")
        rng = np.random.default_rng([seed, 7])  # the dedup phase's segments
        segs = [rng.integers(0, 256, DEDUP_SEGMENT, dtype=np.uint8) for _ in range(4)]
        paths = [f"/dedup/u{i:03d}" for i in range(n_uploads)]
        events = []
        sub = MetaSubscriber(filer.url, events.append, path_prefix="/dedup/", poll_wait=1.0)
        sub.start()

        # 1. the PUTs, gear_hash counted over them alone
        errors = []
        put_lat = []
        idx = filer.dedup_index

        def put(t: int) -> None:
            c = Client(filer.url)
            try:
                for i in [j for j in range(n_uploads) if dedup_segment(j) == t]:
                    data = dedup_upload(segs, i)
                    t0 = time.perf_counter()
                    status, out = c.request("PUT", paths[i], data, OCTET)
                    put_lat.append(time.perf_counter() - t0)
                    if status != 201 or json.loads(out)["md5"] != hashlib.md5(data).hexdigest():
                        errors.append(f"PUT {paths[i]} -> {status}: {out[:200]!r}")
                        return
            except BaseException as e:  # re-raised on the main thread
                errors.append(repr(e))
            finally:
                c.close()

        zero_launches()
        put_wall = run_threads(put, FD_THREADS)
        t_last_put = time.monotonic()
        launches = read_launches()
        check(not errors, f"filer_dedup PUTs: {errors[:3]}")
        check(launches["gear_hash"] > 0, "the filer's dedup PUTs launched no gear_hash kernel")
        stored = n_uploads * DEDUP_SEGMENT
        res.update(uploads=n_uploads, upload_bytes=DEDUP_SEGMENT, threads=FD_THREADS,
                   put_wall_s=put_wall, put_gbps=stored / put_wall / 1e9,
                   **{f"put_{k}": v for k, v in _pcts(put_lat).items()},
                   index_hits=idx.hits, index_misses=idx.misses,
                   bytes_saved=idx.bytes_saved, byte_share_saved=idx.bytes_saved / stored,
                   launches=launches)

        # 2. every file's metadata, then the deletes
        c = Client(filer.url)
        meta = {}
        for p in paths:
            status, out = c.request("GET", f"{p}?metadata=true")
            check(status == 200, f"{p}?metadata=true -> {status}")
            meta[p] = json.loads(out)
        ends = [ch["offset"] + ch["size"] for ch in meta[paths[0]]["chunks"]]
        plain = cdc.cut_points(plain_candidates(dev, segs[0], DEDUP["avg_bits"]),
                               DEDUP_SEGMENT, DEDUP["min_size"], DEDUP["max_size"])
        check(ends == plain, "the first upload's chunks are not at the plain cut rule's cuts")
        gone = [p for i, p in enumerate(paths) if dedup_segment(i) in FD_GONE]
        kept = [i for i, p in enumerate(paths) if p not in gone]
        t0 = time.perf_counter()
        for p in gone:
            status, _ = c.request("DELETE", p)
            check(status == 204, f"DELETE {p} -> {status}")
        delete_s = time.perf_counter() - t0
        c.close()

        # 3. the reclaim expected, from the metadata alone
        live = {ch["file_id"] for p in paths if p not in gone for ch in meta[p]["chunks"]}
        expect = {ch["file_id"]: ch["size"] for p in gone for ch in meta[p]["chunks"]
                  if ch["file_id"] not in live}
        check(bool(expect), "the deletes left nothing to reclaim")

        # 4. fs.dedup.gc through the shell's filer handle, its calls timed
        split = {"index_remove": 0.0, "blob_delete": 0.0}

        def timed(name, fn):
            def run(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    split[name] += time.perf_counter() - t
            return run

        time.sleep(max(0.0, FD_RECENT_S - (time.monotonic() - t_last_put)))
        env = CommandEnv(master.url, filer.url)
        idx.remove = timed("index_remove", idx.remove)
        filer.client.delete = timed("blob_delete", filer.client.delete)
        t0 = time.perf_counter()
        out = run_command(env, "fs.dedup.gc")
        gc_s = time.perf_counter() - t0
        del idx.remove, filer.client.delete
        m = FD_GC_LINE.fullmatch(out)
        check(m is not None, f"fs.dedup.gc answered {out!r}")
        scanned, dropped, freed, gc_errors = map(int, m.groups())
        check((dropped, freed, gc_errors) == (len(expect), sum(expect.values()), 0),
              f"gc dropped {dropped} fids, {freed} bytes, {gc_errors} errors; expected"
              f" {len(expect)} fids, {sum(expect.values())} bytes, 0 errors")
        res.update(deleted=len(gone), delete_s=delete_s, gc_s=gc_s, gc_scanned=scanned,
                   gc_dropped=dropped, gc_bytes_freed=freed, gc_errors=gc_errors,
                   gc_split_s=dict(split, walk_and_rest=gc_s - sum(split.values())),
                   expected_fids=len(expect), expected_bytes=sum(expect.values()))

        # every dropped fid 404 on its volume server; every survivor equal
        urls, conns = {}, {}
        for fid in expect:
            vid = fid.split(",")[0]
            if vid not in urls:
                urls[vid] = get_json(f"{master.url}/dir/lookup?volumeId={vid}")[
                    "locations"][0]["url"]
            u = urls[vid]
            conn = conns.get(u) or conns.setdefault(u, Client(f"http://{u}"))
            status, _ = conn.request("GET", f"/{fid}")
            check(status == 404, f"dropped fid {fid} reads {status}")
        for conn in conns.values():
            conn.close()
        bad = []

        def read_back(t: int) -> None:
            conn = Client(filer.url)
            try:
                for i in kept[t::FD_THREADS]:
                    status, body = conn.request("GET", paths[i])
                    if status != 200 or body != dedup_upload(segs, i):
                        bad.append(f"{paths[i]} -> {status}")
            except BaseException as e:
                bad.append(repr(e))
            finally:
                conn.close()

        res["survivors_read_s"] = run_threads(read_back, FD_THREADS)
        check(not bad, f"survivors read back wrong: {bad[:3]}")
        out = run_command(env, "fs.dedup.gc")
        m = FD_GC_LINE.fullmatch(out)
        check(m is not None and int(m.group(2)) == 0 and int(m.group(4)) == 0,
              f"the second gc: {out!r}")

        # a deleted upload PUT again uploads anew
        c = Client(filer.url)
        i = paths.index(gone[0])
        misses = idx.misses
        status, _ = c.request("PUT", gone[0], dedup_upload(segs, i), OCTET)
        check(status == 201 and idx.misses > misses, "the deleted upload PUT again did not miss")
        status, body = c.request("GET", gone[0])
        check(status == 200 and body == dedup_upload(segs, i), "the re-PUT reads back wrong")
        c.close()
        res["reput_misses"] = idx.misses - misses

        # the subscriber: a create a PUT, a delete a DELETE
        sub.stop()
        sub._thread.join(timeout=15)
        sub.drain()
        files = set(paths)

        def path(ev, side):
            return (ev.get(side) or {}).get("full_path")

        creates = sum(1 for e in events if path(e, "new_entry") in files and not e["old_entry"])
        deletes = sum(1 for e in events if path(e, "old_entry") in files and not e["new_entry"])
        check((creates, deletes) == (n_uploads + 1, len(gone)),
              f"the subscriber saw {creates} creates and {deletes} deletes")
        ps = run_command(env, "cluster.ps")
        check(f"filer {filer.url}" in ps.splitlines(), f"cluster.ps lists no filer: {ps!r}")
        res.update(events=len(events), creates_seen=creates, deletes_seen=deletes,
                   cluster_ps_lists_filer=True)

        # 5. the filer restarted on its store: a survivor PUT again dedups fully
        t0 = time.perf_counter()
        filer.stop()
        filer = start_filer()
        restart_s = time.perf_counter() - t0
        i = kept[0]
        c = Client(filer.url)
        status, _ = c.request("PUT", "/dedup/again", dedup_upload(segs, i), OCTET)
        check(status == 201, f"PUT after the restart -> {status}")
        check(filer.dedup_index.misses == 0 and filer.dedup_index.hits > 0,
              f"the restarted filer missed {filer.dedup_index.misses} chunks of a stored upload")
        status, body = c.request("GET", "/dedup/again")
        check(status == 200 and body == dedup_upload(segs, i), "the restarted PUT reads back wrong")
        c.close()
        env = CommandEnv(master.url, filer.url)
        t0 = time.perf_counter()
        verify = run_command(env, "fs.verify /").splitlines()
        verify_s = time.perf_counter() - t0
        check(verify[-1].endswith(" ok, 0 broken") and len(verify) == 1,
              f"fs.verify /: {verify[-3:]}")
        res.update(restart_s=restart_s, restart_hits=filer.dedup_index.hits, restart_misses=0,
                   verify=verify[-1], verify_s=verify_s)

        # gear_hash on the card against its plain version, after the count
        x = torch.from_numpy(segs[0]).to(dev)
        got = cdc.gear_hash_kernel(x)
        want = cdc.gear_hashes_torch(x)
        check(torch.equal(got, want), "gear_hash != plain on the first segment")
        res["gear_max_abs_err"] = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    finally:
        if sub is not None:
            sub.stop()
        if filer is not None:
            filer.stop()
        master.stop()
        for vs in servers:
            vs.stop()
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    res.update(wall_s=wall, wall_limit_s=FD_WALL_LIMIT_S, over_wall_limit=wall > FD_WALL_LIMIT_S,
               cuts=FD_CUTS)
    return res


# --- phase 16: the S3 gateway and IAM over the port's filer ------------------------------
S3_BUCKET = "warp-benchmark-bucket"  # warp's default bucket
S3_OBJECT = 10 * MIB  # warp mixed's object size (BASELINE.md: 279.85 MiB/s GET at 27.99 obj/s)
S3_MIX = (("GET", 0.45), ("STAT", 0.30), ("PUT", 0.15), ("DELETE", 0.10))  # warp mixed
S3_POOL = 32  # distinct seeded bodies the PUTs draw from
S3_PARTS = 8  # multipart parts
S3_DELETED_GETS = 32  # GETs of deleted keys after the mixed window
S3_RELOAD_LIMIT_S = 5.0
S3_WALL_LIMIT_S = 150
S3_ADMIN = ("warpAdminKey", "warpAdminSecret")
S3_CLIENT_TIMEOUT_S = 30  # the gateway's own filer hop's timeout
# an op in flight this long prints every thread's stack, once, and fails
# the phase, as does any op that took longer (no op of a passing run on
# the card has taken 2 s)
S3_STALL_S = 12
S3_CUTS = ("--s3-objects (256) prepopulated objects (2.5 GiB) of warp mixed's 10 MiB: the"
           " stored set two volume servers hold in one process",
           "--s3-seconds (10) of mixed traffic in place of warp's 5 minutes (60 until the"
           " sync_mq phase took room in the run, 30 until the secure_ha phase did, 15"
           " until the observe phase did)",
           "object bodies drawn from 32 seeded 10 MiB bodies (the filer does not dedup, so"
           " every PUT writes and hashes all its bytes)",
           "the 20 clients, the gateway, IAM, filer, master and two volume servers share one"
           " process and one GIL: the figures are a floor for the gateway")


class SignedConn:
    """One warp client: a keep-alive connection to the gateway (warp's Go
    client reuses its connections), each request signed by the port's
    S3Client. Nothing is re-sent: a failed request is a failed op."""

    def __init__(self, url: str, creds: tuple[str, str]) -> None:
        from seaweedfs_tpu_torch.s3api import S3Client

        self.signer = S3Client(url, *creds)
        host, port = url.split("//", 1)[1].split(":")
        self.conn = http.client.HTTPConnection(host, int(port), timeout=S3_CLIENT_TIMEOUT_S)

    def request(self, method: str, path: str, body: bytes = b"") -> tuple[int, dict, bytes]:
        path = urllib.parse.quote(path, safe="/-_.~")
        headers = self.signer._signed_headers(method, path, [], body)
        self.conn.request(method, path, body=body or None, headers=headers)
        resp = self.conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()

    def close(self) -> None:
        self.conn.close()


def thread_stacks() -> str:
    """Every thread's Python stack, by name."""
    names = {t.ident: t.name for t in threading.enumerate()}
    return "".join(f"--- {names.get(ident)}\n" + "".join(traceback.format_stack(frame))
                   for ident, frame in sys._current_frames().items())


def s3_phase(dev: torch.device, n_objects: int, seconds: float, clients: int,
             multipart_bytes: int, md5_ops_per_block: int, seed: int) -> dict:
    """warp's mixed S3 benchmark (`make benchmark` against `weed server -s3`,
    BASELINE.md) against the port, in this process: a port MasterServer
    (pulse 1 s), two VolumeServers and a FilerServer (4 MiB chunks) on the
    card, the admin identity written into the filer by the port shell's
    `s3.configure`, a port S3Server that loads it and a port IamServer.
    n_objects seeded 10 MiB objects PUT from `clients` signed clients; then
    `seconds` of GET 45 % / STAT 30 % / PUT 15 % / DELETE 10 % drawn from
    the seed by the same clients, a DELETE taking its key out of the shared
    live set first and a PUT adding a fresh key after its answer, so no
    client asks for a key it knows to be gone, with the device's busy time
    under torch.profiler. Then the deleted keys GET 404 NoSuchKey; one
    multipart upload of multipart_bytes in 8 parts, completed, read back
    whole and by a Range across a part edge; IAM: CreateUser,
    CreateAccessKey and PutUserPolicy signed by the admin, the new key
    answering 200 once the gateway has reloaded /etc/iam/identity.json
    (within 5 s), an unknown key 403 InvalidAccessKeyId. Checks: every PUT's
    ETag is hashlib's MD5 of its body, every GET's body is that body byte
    for byte (so has that MD5) with that ETag, every HEAD's ETag and
    Content-Length match, the multipart ETag is the MD5 of the part digests
    with -8, no 5xx or unexpected status and no retry (one request an op),
    no op in flight past 12 s (every thread's stack is printed first),
    md5_batch and crc32c_batch launched in the phase."""
    from torch.profiler import ProfilerActivity, profile

    from seaweedfs_tpu_torch.iamapi import IamServer
    from seaweedfs_tpu_torch.s3api import S3Client, S3Server

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke-s3-", dir=REPO / "build")
    master = MasterServer(port=0, pulse_seconds=1)
    master.start()
    servers, filer, s3, iam = [], None, None, None
    batches = []  # (blobs, length, seconds) of every batch the filer's flusher hashed
    res = {}
    try:
        for i in range(2):
            vs = VolumeServer([os.path.join(root, f"v{i}")], master.url,
                              pulse_seconds=PULSE_S, device=dev)
            vs.start()
            servers.append(vs)
        filer = FilerServer(master.url, port=0, device=dev)
        filer.start()
        svc = filer.hash_service
        check(filer.device.type == "cuda" and svc.device.type == "cuda"
              and all(vs.device.type == "cuda" for vs in servers), "an s3 role is not on cuda")
        timed_batches(svc, batches)
        env = CommandEnv(master.url, filer.url)
        out = run_command(env, f"s3.configure -user warp-admin -access_key {S3_ADMIN[0]}"
                               f" -secret_key {S3_ADMIN[1]} -actions Admin")
        check(out.startswith("configured identity 'warp-admin'"), f"s3.configure: {out}")
        s3 = S3Server(filer.url, port=0)
        s3.start()
        iam = IamServer(filer.url, port=0)
        iam.start()
        admin = S3Client(s3.url, *S3_ADMIN)
        admin.create_bucket(S3_BUCKET)

        t0 = time.perf_counter()
        pool = [np.random.default_rng([seed, 17, i]).bytes(S3_OBJECT) for i in range(S3_POOL)]
        pool_md5 = [hashlib.md5(b).hexdigest() for b in pool]
        gen_s = time.perf_counter() - t0
        live_keys, live_pos, live = [], {}, {}  # key -> pool index
        in_use: dict[str, int] = {}
        lock = threading.Lock()
        errors = []

        def add_live(key: str, idx: int) -> None:
            with lock:
                live[key] = idx
                live_pos[key] = len(live_keys)
                live_keys.append(key)

        def take(rng, for_delete: bool) -> str | None:
            """A random live key: leased for a read, or taken out of the
            live set for a delete (never one a reader holds)."""
            with lock:
                for _ in range(8):
                    if not live_keys:
                        return None
                    key = live_keys[int(rng.integers(len(live_keys)))]
                    if not for_delete:
                        in_use[key] = in_use.get(key, 0) + 1
                        return key
                    if not in_use.get(key):
                        last = live_keys.pop()
                        if last != key:
                            live_keys[live_pos[key]] = last
                            live_pos[last] = live_pos[key]
                        del live_pos[key]
                        return key
                return None

        def release(key: str) -> None:
            with lock:
                in_use[key] -= 1

        def put(c, key: str, idx: int) -> tuple[int, float]:
            t0 = time.perf_counter()
            status, headers, body = c.request("PUT", f"/{S3_BUCKET}/{key}", body=pool[idx])
            lat = time.perf_counter() - t0
            if status != 200 or headers.get("ETag") != f'"{pool_md5[idx]}"':
                errors.append(f"PUT {key} -> {status} {headers.get('ETag')}: {body[:200]!r}")
            return status, lat

        # 1. prepopulation
        statuses: dict[int, int] = {}

        def count(status: int) -> None:
            with lock:
                statuses[status] = statuses.get(status, 0) + 1

        prepop_lat = []

        def prepopulate(t: int) -> None:
            c = SignedConn(s3.url, S3_ADMIN)
            try:
                for i in range(t, n_objects, clients):
                    status, dt = put(c, f"obj/{i:06d}", i % S3_POOL)
                    prepop_lat.append(dt)
                    count(status)
                    if status == 200:
                        add_live(f"obj/{i:06d}", i % S3_POOL)
            except BaseException as e:  # re-raised on the main thread
                errors.append(repr(e))
            finally:
                c.close()

        zero_launches()
        prepop_s = run_threads(prepopulate, clients)
        check(not errors, f"s3 prepopulation: {errors[:3]}")
        check(max(prepop_lat) <= S3_STALL_S,
              f"s3 prepopulation: a PUT took {max(prepop_lat):.3f} s, past {S3_STALL_S} s")
        prepop_launches = read_launches()

        # 2. warp mixed
        ops = [name for name, _ in S3_MIX]
        probs = [p for _, p in S3_MIX]
        lat = {op: [] for op in ops}
        moved = [dict.fromkeys(ops, 0) for _ in range(clients)]  # bytes by client and op
        deleted = []
        counter = itertools.count()
        deadline = [0.0]
        inflight: dict[int, tuple[float, str]] = {}  # client -> (start, op)
        stall = []
        window_done = threading.Event()

        def watchdog() -> None:
            while not window_done.wait(1.0) and not stall:
                now = time.perf_counter()
                slow = [(op, now - t0) for t0, op in list(inflight.values())
                        if now - t0 > S3_STALL_S]
                if slow:
                    stall.append(slow)
                    print(f"s3: ops in flight past {S3_STALL_S} s {slow}; every thread:\n"
                          + thread_stacks(), file=sys.stderr, flush=True)

        def mixed(t: int) -> None:
            rng = np.random.default_rng([seed, 18, t])
            c = SignedConn(s3.url, S3_ADMIN)
            op, t_op = "", 0.0
            try:
                while time.perf_counter() < deadline[0]:
                    op = ops[int(rng.choice(len(ops), p=probs))]
                    t_op = time.perf_counter()
                    inflight[t] = (t_op, op)
                    if op == "PUT":
                        n = next(counter)
                        key, idx = f"new/{t:02d}/{n:06d}", int(rng.integers(S3_POOL))
                        status, dt = put(c, key, idx)
                        if status == 200:
                            add_live(key, idx)
                            moved[t][op] += S3_OBJECT
                    else:
                        key = take(rng, for_delete=op == "DELETE")
                        if key is None:
                            continue
                        idx = live.get(key)
                        t0 = time.perf_counter()
                        if op == "GET":
                            status, headers, body = c.request("GET", f"/{S3_BUCKET}/{key}")
                            dt = time.perf_counter() - t0
                            ok = (status == 200 and headers.get("ETag") == f'"{pool_md5[idx]}"'
                                  and body == pool[idx])
                            moved[t][op] += len(body)
                        elif op == "STAT":
                            status, headers, body = c.request("HEAD", f"/{S3_BUCKET}/{key}")
                            dt = time.perf_counter() - t0
                            ok = (status == 200 and headers.get("ETag") == f'"{pool_md5[idx]}"'
                                  and headers.get("Content-Length") == str(S3_OBJECT))
                        else:
                            status, headers, body = c.request("DELETE", f"/{S3_BUCKET}/{key}")
                            dt = time.perf_counter() - t0
                            ok = status == 204
                            if ok:
                                deleted.append(key)
                        if op != "DELETE":
                            release(key)
                        if not ok:
                            errors.append(f"{op} {key} -> {status} {headers.get('ETag')}"
                                          f" {headers.get('Content-Length')}: {body[:200]!r}")
                    count(status)
                    lat[op].append(dt)
            except BaseException as e:
                errors.append(f"{op} after {time.perf_counter() - t_op:.3f} s: {e!r}")
            finally:
                inflight.pop(t, None)
                c.close()

        before = read_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            deadline[0] = time.perf_counter() + seconds
            dog = threading.Thread(target=watchdog, daemon=True)
            dog.start()
            window = run_threads(mixed, clients)
            window_done.set()
            torch.cuda.synchronize()
        made = {k: v - before[k] for k, v in read_launches().items()}
        check(not errors, f"s3 mixed: {len(errors)} failed ops: {errors[:3]}"
                          + (" (the threads' stacks are on stderr)" if stall else ""))
        check(not [s for s in statuses if s >= 500], f"s3 answered 5xx: {statuses}")
        slowest = max((max(v) for v in lat.values() if v), default=0.0)
        check(not stall and slowest <= S3_STALL_S,
              f"s3 mixed: an op took {slowest:.3f} s or was in flight past {S3_STALL_S} s:"
              f" {stall} (the threads' stacks are on stderr)")
        device_us, events = device_time_by_event(prof)
        seen = {name: sum(n for k, n in events.items() if f"{name}_kernel" in k)
                for name in ("md5_batch", "crc32c_batch")}
        busy_s = sum(device_us.values()) / 1e6
        kernel_us = {name: sum(v for k, v in device_us.items() if f"{name}_kernel" in k)
                     for name in seen}
        # the profiler may drop events on the card's host: each kernel's
        # time seen is also scaled by its launches over the events seen
        scaled_s = busy_s + sum(kernel_us[n] / 1e6 * (made[n] / seen[n] - 1)
                                for n in seen if seen[n])
        total_ops = sum(len(v) for v in lat.values())
        moved = {op: sum(m[op] for m in moved) for op in ops}
        per_op = {op: dict(ops=len(lat[op]), obj_per_s=len(lat[op]) / window,
                           mib_per_s=moved[op] / window / MIB,
                           **(_pcts(lat[op]) if lat[op] else {}),
                           max_ms=max(lat[op], default=0.0) * 1e3)
                  for op in ops}
        top = sorted(device_us.items(), key=lambda kv: -kv[1])[:6]
        res.update(
            objects=n_objects, object_bytes=S3_OBJECT, clients=clients, mix=dict(S3_MIX),
            generate_s=gen_s, prepopulate_s=prepop_s,
            prepopulate_gbps=n_objects * S3_OBJECT / prepop_s / 1e9,
            prepopulate_launches=prepop_launches,
            window_s=window, seconds_asked=seconds, ops=total_ops,
            obj_per_s=total_ops / window, mib_per_s=sum(moved.values()) / window / MIB,
            errors=len(errors), statuses={str(k): v for k, v in sorted(statuses.items())},
            stalled_ops=stall[0] if stall else [], stall_limit_s=S3_STALL_S,
            prepopulate_max_ms=max(prepop_lat) * 1e3,
            per_op=per_op, live_after=len(live_keys), window_launches=made,
            profiled=dict(device_busy_s=busy_s, device_idle_share=1 - busy_s / window,
                          device_busy_scaled_s=scaled_s,
                          device_idle_share_scaled=1 - scaled_s / window,
                          kernel_events=seen, kernel_launches=made,
                          kernel_ms={k: v / 1e3 for k, v in kernel_us.items()},
                          device_ms_by_event={k: v / 1e3 for k, v in top},
                          events_by_event={k: events[k] for k, _ in top}))

        # 3. deleted keys answer 404 NoSuchKey
        check(deleted, "the mixed window deleted nothing")
        for key in deleted[:S3_DELETED_GETS]:
            status, _, body = admin.request("GET", f"/{S3_BUCKET}/{key}")
            check(status == 404 and b"<Code>NoSuchKey</Code>" in body,
                  f"GET of the deleted {key} -> {status}: {body[:200]!r}")

        # 4. one multipart upload: 8 parts, completed, read back
        part = multipart_bytes // S3_PARTS
        data = np.random.default_rng([seed, 19]).bytes(part * S3_PARTS)
        pieces = [data[i * part : (i + 1) * part] for i in range(S3_PARTS)]
        key = "multipart/object.bin"
        t0 = time.perf_counter()
        upload_id = admin.create_multipart(S3_BUCKET, key)
        etags = [admin.upload_part(S3_BUCKET, key, upload_id, i + 1, p)
                 for i, p in enumerate(pieces)]
        etag = admin.complete_multipart(S3_BUCKET, key, upload_id,
                                        [(i + 1, e) for i, e in enumerate(etags)])
        mp_s = time.perf_counter() - t0
        check(etags == [hashlib.md5(p).hexdigest() for p in pieces],
              "a part's ETag is not hashlib's MD5 of the part")
        want = hashlib.md5(b"".join(hashlib.md5(p).digest() for p in pieces)).hexdigest()
        check(etag == f"{want}-{S3_PARTS}", f"multipart ETag {etag} != {want}-{S3_PARTS}")
        t0 = time.perf_counter()
        got = admin.get_object(S3_BUCKET, key)
        mp_get_s = time.perf_counter() - t0
        check(got == data, "the multipart object read back differs")
        lo, hi = part - 4096, part + 4095
        status, headers, body = admin.request("GET", f"/{S3_BUCKET}/{key}",
                                              headers={"Range": f"bytes={lo}-{hi}"})
        check(status == 206 and body == data[lo : hi + 1]
              and headers.get("Content-Range") == f"bytes {lo}-{hi}/{len(data)}",
              f"ranged GET across the part edge -> {status} {headers.get('Content-Range')}")
        res.update(multipart_bytes=len(data), multipart_parts=S3_PARTS, multipart_s=mp_s,
                   multipart_gbps=len(data) / mp_s / 1e9,
                   multipart_get_gbps=len(data) / mp_get_s / 1e9,
                   multipart_etag=etag, part_etags=etags)

        # 5. IAM: a user and key made through the IamServer, taken live
        def iam_call(action: str, **params) -> str:
            body = urllib.parse.urlencode({"Action": action, **params}).encode()
            client = S3Client(iam.url, *S3_ADMIN, service="iam")
            status, _, out = client.request(
                "POST", "/", body=body,
                headers={"Content-Type": "application/x-www-form-urlencoded"})
            check(status == 200, f"IAM {action} -> {status}: {out[:300]!r}")
            return out.decode()

        iam_call("CreateUser", UserName="warp-reader")
        out = iam_call("CreateAccessKey", UserName="warp-reader")
        new_key = (re.search(r"<AccessKeyId>([^<]+)</AccessKeyId>", out).group(1),
                   re.search(r"<SecretAccessKey>([^<]+)</SecretAccessKey>", out).group(1))
        iam_call("PutUserPolicy", UserName="warp-reader", PolicyName="read",
                 PolicyDocument=json.dumps({"Version": "2012-10-17", "Statement": [{
                     "Effect": "Allow", "Action": ["s3:GetObject"],
                     "Resource": [f"arn:aws:s3:::{S3_BUCKET}/*"]}]}))
        t0 = time.perf_counter()
        reader = S3Client(s3.url, *new_key)
        while True:
            status, _, body = reader.request("GET", f"/{S3_BUCKET}/{key}")
            reload_s = time.perf_counter() - t0
            if status == 200 or reload_s > S3_RELOAD_LIMIT_S:
                break
            time.sleep(0.005)
        check(status == 200 and body == data,
              f"the new key -> {status} after {reload_s:.3f} s (limit {S3_RELOAD_LIMIT_S} s)")
        status, _, body = S3Client(s3.url, "AKIDUNKNOWN0000000000", "x").request(
            "GET", f"/{S3_BUCKET}/{key}")
        check(status == 403 and b"<Code>InvalidAccessKeyId</Code>" in body,
              f"an unknown key -> {status}: {body[:200]!r}")
        launches = read_launches()
        for name in ("crc32c_batch", "md5_batch"):
            check(launches[name] > 0, f"the s3 phase launched no {name} kernel")
        check(svc.failed_blobs == 0, "the hash service failed a batch")
        del svc._batch_hash
        res.update(iam_reload_ms=reload_s * 1e3, iam_reload_limit_s=S3_RELOAD_LIMIT_S,
                   unknown_key=403, launches=launches, batch_blobs=svc.batch_blobs,
                   host_blobs=svc.host_blobs, hash_buckets=batch_buckets(batches))
    finally:
        for server in (iam, s3, filer):
            if server is not None:
                server.stop()
        for vs in servers:
            vs.stop()
        master.stop()
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    # the kernels at the commonest batch of the chunk lengths an object makes
    res["hash_kernels"] = path_hash_times(
        dev, seed, md5_ops_per_block, batches,
        (FILER_CHUNK, S3_OBJECT % FILER_CHUNK or FILER_CHUNK), "s3")
    res.update(wall_s=wall, wall_limit_s=S3_WALL_LIMIT_S, over_wall_limit=wall > S3_WALL_LIMIT_S,
               cuts=S3_CUTS, reference="BASELINE.md warp mixed: 61.79 obj/s, 369.74 MiB/s over"
               " 5 min, upstream Go on an unspecified host",
               note="clients and servers share one process and one GIL: a floor for the gateway")
    return res


# --- phase 17: the volume side (tiering, faults, 5-byte offsets) ------------------------
VS_RACKS = ("r1", "r2")  # server A, server B
VS_TIER_VID = 301
VS_ONLINE_VID = 999  # past the ids the master grows
VS_SMALL = 4096  # the tiered volume's last quarter: 4 KiB needles
VS_SAMPLE = 256  # GETs of the tiered volume, and of the sealed volume under shard faults
VS_FILES = 2048  # replicated 4 KiB files written under the corrupt fault
VS_THREADS = 8
VS_CORRUPT = 16  # corrupt-mode firings on server A's .dat writes
VS_ONLINE_BYTES = 64 * MIB
VS_TORN_TAIL = 2 * MIB  # the online volume's last needle, written with the tear armed
VS_ONLINE_LOST = (0, 1, 2, 3)  # data shards lost before the degraded reads
VS_DEGRADED = 64  # needles read degraded after the torn-parity heal
VS_SHARD_FAULTS = 4  # shard-read errors at rate 0.25: one interval never loses more than RS(10,4) rebuilds
VS_OFFSET5_BYTES = 256 * MIB
VS_WALL_LIMIT_S = 120
VS_SHAPES = {"crc32c_batch": (1024, VS_SMALL), "gf256_matmul": ("online", (1, 10, MIB))}
VS_CUTS = ("the tiered volume: --tier-mib (256) MiB (1024 until the sync_mq phase took room in"
           " the run, 512 until the secure_ha phase did) of the 30 GB volume limit, its last quarter"
           " 4 KiB needles: log-uniform needles differ in length and verify on the host, so"
           " the 4 KiB quarter is what crc32c_batch checks",
           "2,048 replicated 4 KiB files (replication 010 over racks r1 and r2): servers, master"
           " and 8 clients share one process",
           "one 64 MiB online volume; a 256 MiB volume at 5-byte offsets")


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for piece in iter(lambda: f.read(64 * MIB), b""):
            h.update(piece)
    return h.hexdigest()


def idx_entries(path: str, entry: int) -> list:
    """(key, byte offset, size) of each 16- or 17-byte index entry."""
    raw = np.fromfile(path, dtype=np.uint8).reshape(-1, entry)
    units = raw[:, 8:12].copy().view(">u4").ravel().astype(np.uint64)
    if entry == 17:
        units += raw[:, 12].astype(np.uint64) << np.uint64(32)
    keys = raw[:, :8].copy().view(">u8").ravel()
    sizes = raw[:, entry - 4 :].copy().view(">i4").ravel()
    return list(zip(keys.tolist(), (units * np.uint64(8)).tolist(), sizes.tolist()))


def offset5_child(dev: torch.device, work: str, nbytes: int, seed: int) -> int:
    """The EC main path at 5-byte offsets, in a process started with
    SEAWEEDFS_TPU_OFFSET_BYTES=5 (fixed at import, as a build tag is): a
    volume of `nbytes` from the seed, encode on the card, the rebuild of 4
    lost shards, 256 degraded reads with 4 data shards gone and the decode.
    Prints one JSON line with its launches and walls."""
    from seaweedfs_tpu_torch.storage import types as types_mod

    check(types_mod.NEEDLE_MAP_ENTRY_SIZE == 17, "the child is not at 5-byte offsets")
    codec = RSCodec(device=dev)
    zero_launches()
    t0 = time.perf_counter()
    vol = write_volume(work, 1, nbytes, seed)
    write_s = time.perf_counter() - t0
    base = vol["base"]
    t0 = time.perf_counter()
    encoder.write_ec_files(base, codec=codec)
    encode_s = time.perf_counter() - t0
    for s in REBUILD_LOST:
        os.replace(base + geometry.to_ext(s), base + geometry.to_ext(s) + ".orig")
    t0 = time.perf_counter()
    rebuilt = encoder.rebuild_ec_files(base, codec=codec)
    rebuild_s = time.perf_counter() - t0
    check(rebuilt == list(REBUILD_LOST), f"5-byte rebuild: {rebuilt}")
    for s in REBUILD_LOST:
        p = base + geometry.to_ext(s)
        check(same_file(p, p + ".orig"), f"5-byte rebuilt shard {s} differs")
        os.unlink(p + ".orig")
    for s in DEGRADED_LOST:
        os.replace(base + geometry.to_ext(s), base + geometry.to_ext(s) + ".orig")
    ids = sorted(vol["needles"])
    pick = np.random.default_rng([seed, 40]).choice(len(ids), min(DEGRADED_READS, len(ids)),
                                                   replace=False)
    n0 = gf256_matmul.launches
    t0 = time.perf_counter()
    with EcVolume(work, "", 1, codec=codec) as ev:
        for i in pick:
            cookie, off, size = vol["needles"][ids[i]]
            check(ev.read_needle(ids[i], cookie=cookie).data == vol["pool"][off : off + size],
                  f"5-byte degraded read of {ids[i]:x}")
    degraded_s = time.perf_counter() - t0
    degraded_launches = gf256_matmul.launches - n0
    for s in DEGRADED_LOST:
        os.replace(base + geometry.to_ext(s) + ".orig", base + geometry.to_ext(s))
    size = decoder.find_dat_file_size(base, base)
    t0 = time.perf_counter()
    decoder.write_dat_file(os.path.join(work, "decoded"), size,
                           [base + geometry.to_ext(i) for i in range(10)])
    decode_s = time.perf_counter() - t0
    launches = read_launches()["gf256_matmul"]
    # the encode's batch against the plain version on the card
    width = min(MIB, nbytes // 10)  # one encode batch row, 1 MiB at the real size
    with open(base + ".dat", "rb") as f:
        x = np.frombuffer(f.read(10 * width), np.uint8).reshape(1, 10, width)
    xd = torch.from_numpy(x.copy()).to(dev)
    parity = gf256.parity_rows(10, 4)
    got, want = gf256_matmul(parity, xd), gf_matmul_torch(parity, xd[0])
    check(torch.equal(got, want), "5-byte encode batch: kernel != plain")
    print(json.dumps(dict(
        launches=launches, degraded_launches=degraded_launches,
        needles=len(ids), degraded_reads=len(pick), dat_bytes=os.path.getsize(base + ".dat"),
        decoded_bytes=size, write_s=write_s, encode_s=encode_s, rebuild_s=rebuild_s,
        degraded_s=degraded_s, decode_s=decode_s,
        max_abs_err=int((got.int() - want.int()).abs().max()))), flush=True)
    return 0


def volume_side_phase(dev: torch.device, tier_bytes: int, md5_ops_per_block: int,
                      seed: int) -> dict:
    """The volume side on the card: a port MasterServer (pulse 1 s) and two
    VolumeServers (racks r1 and r2, runtime fault arming on, scrubbers
    unthrottled, no scrub loop) on cuda, one process, with a 5-byte-offset
    child process alongside.
    (a) tiering: `tier_bytes` of seeded needles in one volume on server A
    (log-uniform 1 KiB-4 MiB, the main path's rule, then a quarter of 4 KiB
    needles), marked readonly; `volume.tier.configure -kind local` and
    `volume.tier.upload` move its .dat into a backend under build/; 256 GETs
    equal; a scrub pass over the tiered volume verifies every live byte
    through the backend with no finding and crc32c_batch launched;
    `/admin/tail` at the middle needle returns the .dat from its offset;
    `volume.tier.download` restores the .dat (SHA-256 as before) and a
    second pass is clean; `backup` into a fresh directory (full over
    /admin/volume/raw, then cut at the middle needle and caught up over
    /admin/tail) leaves a .dat and .idx with the source's SHA-256.
    (b) faults through `cluster.faults`: `corrupt` on volume.write.dat
    for 16 firings keyed to server A; 2,048 4 KiB files with replication
    010 from 8 waiting threads; a scrub pass on A finds exactly those 16
    needles through crc32c_batch, `volume.scrub -apply` heals them from B,
    a second pass is clean and every file reads equal from both holders.
    A 64 MiB online volume's parity torn once (volume.ec.parity.write,
    `torn`, count 1): parity_health() >= 1, the heal (`rearm` through
    gf256_matmul) brings it to 0 with every parity row equal to the plain
    version; sealed, its 4 data shards lost, 64 needles read degraded equal.
    Those shards rebuilt, volume.ec.shard.read `error` at rate 0.25 for 4
    firings: 256 GETs equal, the codec launched.
    (c) the child's 5-byte EC path: its 14 shards equal a 4-byte encode of
    the same .dat here, its 17-byte .ecx the 4-byte entries, its decoded
    .dat the .dat."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke-volume-side-", dir=REPO / "build")
    # (c) starts first: the child reaches the card while (a) and (b) run
    child_dir = os.path.join(root, "offset5")
    os.makedirs(child_dir)
    child = subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--offset5-child", child_dir,
         "--seed", str(seed)],
        env={**os.environ, "SEAWEEDFS_TPU_OFFSET_BYTES": "5"}, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    master = MasterServer(port=0, pulse_seconds=1, faults_spec="")
    master.start()
    servers = []
    res = {}
    try:
        for i, rack in enumerate(VS_RACKS):
            vs = VolumeServer([os.path.join(root, f"v{i}")], master.url, rack=rack,
                              pulse_seconds=PULSE_S, scrub_rate_mb=0, device=dev,
                              faults_spec="")
            vs.start()
            servers.append(vs)
        check(all(vs.device.type == dev.type and vs.scrubber.device.type == dev.type
                  for vs in servers), "a volume-side server or scrubber is off the card")
        a, b = servers
        ids = [vs.node_id for vs in servers]
        env = TimedEnv(master.url)
        check(run_command(env, "lock") == "lock acquired", "lock")
        run_command(env, "volume.vacuum.disable")
        ca = Client(a.url)
        zero_launches()

        # (a) 1. the tiered volume, written in process on A, then mounted
        t0 = time.perf_counter()
        rng = np.random.default_rng([seed, 30])
        pool = memoryview(rng.bytes(tier_bytes))
        plan = []  # (needle id, cookie, pool offset, size)
        tdir = a.store.locations[0].directory
        with Volume(tdir, "", VS_TIER_VID, device=dev) as v:
            used, nid = 0, 0
            while used < tier_bytes:
                if used < tier_bytes * 3 // 4:
                    size = min(int(np.exp(rng.uniform(np.log(1024), np.log(4 * MIB)))),
                               tier_bytes * 3 // 4 - used)
                else:
                    size = min(VS_SMALL, tier_bytes - used)
                nid += 1
                cookie = int(rng.integers(0, 1 << 32))
                v.write_needle(Needle(cookie=cookie, id=nid, data=pool[used : used + size]))
                plan.append((nid, cookie, used, size))
                used += size
            mid = len(plan) // 2  # /admin/tail's and the backup's cut
            mid_stamp = v.read_needle(plan[mid][0]).append_at_ns
            mid_offset = v.nm.get(plan[mid][0])[0]
        write_s = time.perf_counter() - t0
        ca.json("/admin/volume/mount", {"volume": VS_TIER_VID})
        tbase = os.path.join(tdir, str(VS_TIER_VID))
        dat_bytes = os.path.getsize(tbase + ".dat")
        dat_sha = sha256_file(tbase + ".dat")
        idx_sha = sha256_file(tbase + ".idx")
        run_command(env, f"volume.mark -volumeId {VS_TIER_VID} -node {ids[0]} -readonly")
        check(a.store.get_volume(VS_TIER_VID).readonly, "the tiered volume is not readonly")
        # 2. configure a local backend and tier the .dat into it
        backend_root = os.path.join(root, "backend")
        out = run_command(env, f"volume.tier.configure -backend cold -kind local "
                               f"-root {backend_root}")
        check(out.startswith("backend 'cold' (local) configured on: ")
              and all(i in out for i in ids), out)
        t0 = time.perf_counter()
        out = run_command(env, f"volume.tier.upload -volumeId {VS_TIER_VID} -dest cold")
        upload_s = time.perf_counter() - t0
        check(out == f"volume {VS_TIER_VID} tiered to cold ({dat_bytes} bytes)", out)
        check(not os.path.exists(tbase + ".dat"), "the tiered .dat is still local")
        obj = os.path.join(backend_root, f"default_{VS_TIER_VID}.dat")
        info = json.loads(run_command(env, f"volume.tier.info -volumeId {VS_TIER_VID}"))
        check(info["remote"]["key"] == f"default_{VS_TIER_VID}.dat"
              and info["remote"]["file_size"] == dat_bytes, f"tier info {info}")
        # 3. 256 GETs over HTTP through the backend
        pick = np.random.default_rng([seed, 31]).choice(len(plan), min(VS_SAMPLE, len(plan)),
                                                        replace=False)
        t0 = time.perf_counter()
        for i in pick:
            nid, cookie, off, size = plan[i]
            status, body = ca.request(
                "GET", f"/{VS_TIER_VID},{file_id.format_needle_id_cookie(nid, cookie)}")
            check(status == 200 and body == pool[off : off + size],
                  f"tiered GET of needle {nid} reads wrong")
        tiered_get_s = time.perf_counter() - t0
        # 4. a scrub pass over the tiered volume, through the backend
        live_bytes = sum(p[3] for p in plan)

        def scrub_pass(what: str) -> tuple[float, int, int]:
            before = read_launches()["crc32c_batch"]
            base_c = scrub_counters([a])
            t0 = time.perf_counter()
            out = ca.json("/admin/scrub/run", {"volume": VS_TIER_VID})
            dt = time.perf_counter() - t0
            check(out["findings"] == [], f"{what}: findings {out['findings'][:4]}")
            c = scrub_counters([a])
            verified = sum(c["bytes"].get(k, 0) - base_c["bytes"].get(k, 0)
                           for k in ("batched", "scalar"))
            check(verified == live_bytes, f"{what}: verified {verified} of {live_bytes} bytes")
            made = read_launches()["crc32c_batch"] - before
            check(made > 0, f"{what} launched no crc32c_batch kernel")
            return dt, made, c["bytes"].get("batched", 0) - base_c["bytes"].get("batched", 0)

        remote_scrub_s, remote_scrub_launches, remote_batched = scrub_pass("the tiered scrub")
        # one flush of the 4 KiB quarter on the card: kernel, plain, host CRC
        first_small = next(i for i, p in enumerate(plan) if p[2] >= tier_bytes * 3 // 4)
        blobs = [pool[p[2] : p[2] + p[3]] for p in plan[first_small : first_small + 1024]]
        check(len(blobs) == 1024 and all(len(x) == VS_SMALL for x in blobs), "the 4 KiB flush")
        blocks = torch.from_numpy(np.frombuffer(b"".join(blobs), np.uint8)
                                  .reshape(1024, VS_SMALL).copy()).to(dev)
        got = u32(crc32c_batch_kernel(blocks)).cpu().numpy()
        plain = u32(crc32c_batch_torch(blocks)).cpu().numpy()
        host = np.array([crc.crc32c(x) for x in blobs])
        check(np.array_equal(got, plain) and np.array_equal(got, host),
              "the tiered flush's CRCs: kernel, plain version and host CRC disagree")
        res["flush_crc_max_abs_err"] = int(np.abs(got.astype(np.int64) - plain).max())
        # 5. /admin/tail at the middle needle
        t0 = time.perf_counter()
        status, tail = ca.request("GET", f"/admin/tail?volume={VS_TIER_VID}"
                                         f"&since_ns={mid_stamp - 1}")
        tail_s = time.perf_counter() - t0
        with open(obj, "rb") as f:
            f.seek(mid_offset)
            want = f.read()
        check(status == 200 and len(tail) == dat_bytes - mid_offset and tail == want,
              f"/admin/tail from needle {mid}: {status}, {len(tail)} bytes")
        del want
        # 7. back to local disk: the same .dat, and a clean pass
        t0 = time.perf_counter()
        out = run_command(env, f"volume.tier.download -volumeId {VS_TIER_VID}")
        download_s = time.perf_counter() - t0
        check(out == f"volume {VS_TIER_VID} downloaded back to {ids[0]}", out)
        check(sha256_file(tbase + ".dat") == dat_sha and not os.path.exists(obj),
              "the downloaded .dat differs, or the object stayed")
        local_scrub_s, _, _ = scrub_pass("the scrub after the download")
        # 6. backup into a fresh directory, then caught up over /admin/tail
        bdir = os.path.join(root, "backup")
        bargs = ["-server", ids[0], "-volumeId", str(VS_TIER_VID), "-dir", bdir]
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            t0 = time.perf_counter()
            volume_tools.run_backup(bargs)
            backup_full_s = time.perf_counter() - t0
        bbase = os.path.join(bdir, str(VS_TIER_VID))
        os.truncate(bbase + ".dat", mid_offset)
        with contextlib.redirect_stdout(printed):
            fix.run(["-dir", bdir, "-volumeId", str(VS_TIER_VID)])
            t0 = time.perf_counter()
            volume_tools.run_backup(bargs)
            backup_tail_s = time.perf_counter() - t0
        check(f"+{dat_bytes - mid_offset} bytes" in printed.getvalue(),
              f"the incremental backup: {printed.getvalue()[-300:]}")
        check(sha256_file(bbase + ".dat") == dat_sha and sha256_file(bbase + ".idx") == idx_sha,
              "the backup's .dat or .idx differs from the source's")
        ca.json("/admin/delete_volume", {"volume": VS_TIER_VID})
        shutil.rmtree(bdir)
        gb = dat_bytes / 1e9
        res.update(
            tier_volume_bytes=dat_bytes, tier_needles=len(plan), tier_live_bytes=live_bytes,
            tier_write_s=write_s, tier_upload_s=upload_s, tier_upload_gbps=gb / upload_s,
            tiered_gets=len(pick), tiered_get_s=tiered_get_s,
            remote_scrub_s=remote_scrub_s, remote_scrub_gbps=live_bytes / remote_scrub_s / 1e9,
            remote_scrub_crc_launches=remote_scrub_launches,
            remote_scrub_batched_bytes=remote_batched,
            local_scrub_s=local_scrub_s, local_scrub_gbps=live_bytes / local_scrub_s / 1e9,
            tail_bytes=len(tail), tail_s=tail_s, tail_gbps=len(tail) / tail_s / 1e9,
            download_s=download_s, download_gbps=gb / download_s,
            backup_full_s=backup_full_s, backup_full_gbps=gb / backup_full_s,
            backup_tail_s=backup_tail_s, backup_sha256_equal=True)
        del tail

        # (b) 1-2. corrupt writes on A under replicated ingest
        out = run_command(env, f"cluster.faults -arm volume.write.dat -mode corrupt "
                               f"-count {VS_CORRUPT} -key {ids[0]}")
        check(out == "armed volume.write.dat (corrupt) on 3/3 endpoint(s)", out)
        raw = np.random.default_rng([seed, 32]).bytes(VS_FILES * VS_SMALL)
        ing = replicated_ingest(master.url, raw, VS_SMALL, VS_THREADS, replication="010")
        files = ing.pop("files")
        fired = {p["point"]: p for p in get_json(f"{a.url}/debug/faults")["points"]}
        check(fired["volume.write.dat"]["armed"] is None, "the corrupt fault is still armed")
        out = run_command(env, "cluster.faults -disarmAll")
        check(out == "disarmed all on 3/3 endpoint(s)", out)
        rvids = sorted({int(f.split(",")[0]) for f, _ in files})
        for vid in rvids:
            check(all(vs.store.get_volume(vid) is not None for vs in servers),
                  f"volume {vid} is not on both servers")
        # 3. a pass on A finds exactly the 16
        before = read_launches()["crc32c_batch"]
        found = []
        t0 = time.perf_counter()
        for vid in rvids:
            found += ca.json("/admin/scrub/run", {"volume": vid})["findings"]
        corrupt_scrub_s = time.perf_counter() - t0
        corrupt_launches = read_launches()["crc32c_batch"] - before
        check(len(found) == VS_CORRUPT and {f["kind"] for f in found} == {"corrupt_needle"}
              and {f["node"] for f in found} == {ids[0]},
              f"the pass on A found {[(f['kind'], f['node']) for f in found][:20]}")
        check(corrupt_launches > 0, "the corrupt-write pass launched no crc32c_batch kernel")
        # 4. healed from B, a clean pass, every file equal from both holders
        t0 = time.perf_counter()
        out = run_command(env, "volume.scrub -apply")
        heal_s = time.perf_counter() - t0
        check(f"repaired {VS_CORRUPT} finding(s):" in out and "FAILED" not in out,
              f"volume.scrub -apply: {out[-600:]}")
        out = run_command(env, "volume.scrub -dryRun")
        check(out.endswith("no silent damage found"), f"the pass after the heal: {out[-400:]}")
        cb = Client(b.url)
        for i, (f, _) in enumerate(files):
            for c in (ca, cb):
                status, body = c.request("GET", f"/{f}")
                check(status == 200 and body == raw[i * VS_SMALL : (i + 1) * VS_SMALL],
                      f"GET {f} reads wrong after the heal")
        res.update(files=VS_FILES, file_bytes=VS_SMALL, threads=VS_THREADS,
                   replicated_volumes=len(rvids), corrupt_fired=VS_CORRUPT,
                   corrupt_found=len(found), corrupt_scrub_s=corrupt_scrub_s,
                   corrupt_scrub_crc_launches=corrupt_launches, corrupt_heal_s=heal_s,
                   **{f"ingest_{k}": v for k, v in ing.items()})

        # 5. the online volume: a torn parity write, detected and healed
        ca.json("/admin/allocate_volume", {"volume": VS_ONLINE_VID, "ecOnline": True})
        ov = a.store.get_volume(VS_ONLINE_VID)
        w = ov.online_ec
        rng = np.random.default_rng([seed, 33])
        opool = rng.bytes(VS_ONLINE_BYTES)
        oplan, used, nid = [], 0, 0
        while used < VS_ONLINE_BYTES:
            if used < VS_ONLINE_BYTES - VS_TORN_TAIL:
                size = min(int(np.exp(rng.uniform(np.log(1024), np.log(4 * MIB)))),
                           VS_ONLINE_BYTES - VS_TORN_TAIL - used)
            else:
                # the last needle: its pump's parity write is torn, and no
                # later write grows the shard back over the cut
                size = VS_ONLINE_BYTES - used
                w.pump(force=True)
                out = run_command(env, "cluster.faults -arm volume.ec.parity.write -mode torn "
                                       "-count 1")
                check(out.startswith("armed volume.ec.parity.write (torn)"), out)
            nid += 1
            a.store.write(VS_ONLINE_VID, Needle(cookie=0x0E, id=nid, data=opool[used : used + size]))
            w.pump()
            oplan.append((nid, used, size))
            used += size
        w.pump(force=True)
        check(faults.point("volume.ec.parity.write").spec is None, "the tear did not fire")
        health = w.parity_health()
        check(health >= 1, f"the torn parity write went unseen: parity_health {health}")
        n0 = gf256_matmul.launches
        t0 = time.perf_counter()
        out = ca.json("/admin/ec/online/rebuild", {"volume": VS_ONLINE_VID})
        rearm_s = time.perf_counter() - t0
        rearm_launches = gf256_matmul.launches - n0
        check(out["active"] and w.parity_health() == 0 and rearm_launches > 0,
              f"the rearm: {out}, parity_health {w.parity_health()}, {rearm_launches} launches")
        obase = ov.base_name
        rows = w.watermark // w.stripe
        check_parity_rows(dev, obase + ".dat", [obase + geometry.to_ext(10 + p) for p in range(4)],
                          w.block, rows, "the rearmed online volume")
        onedles = {n: ov.nm.get(n) for n, _, _ in oplan}
        gen = ca.json("/admin/ec/generate", {"volume": VS_ONLINE_VID})
        check(gen.get("online") is True, f"/admin/ec/generate answered {gen}")
        odat = os.path.getsize(obase + ".dat")
        shard_size = geometry.shard_file_size(odat, w.block, w.block)
        ca.json("/admin/ec/delete_volume", {"volume": VS_ONLINE_VID})
        for s in VS_ONLINE_LOST:
            os.replace(obase + geometry.to_ext(s), obase + geometry.to_ext(s) + ".orig")
        mounted = ca.json("/admin/ec/mount", {"volume": VS_ONLINE_VID})
        check(mounted["shards"] == [s for s in range(14) if s not in VS_ONLINE_LOST],
              f"remounted shards {mounted}")
        on_lost = []
        for n, off, size in oplan:
            noff, nsize = onedles[n]
            ivs = geometry.locate_data(w.block, w.block, 10 * shard_size, noff,
                                       get_actual_size(nsize, 3))
            if any(iv.to_shard_id_and_offset(w.block, w.block)[0] in VS_ONLINE_LOST
                   for iv in ivs):
                on_lost.append((n, off, size))
        pick = rng.choice(len(on_lost), min(VS_DEGRADED, len(on_lost)), replace=False)
        n0 = gf256_matmul.launches
        for i in pick:
            n, off, size = on_lost[i]
            status, body = ca.request(
                "GET", f"/{VS_ONLINE_VID},{file_id.format_needle_id_cookie(n, 0x0E)}")
            check(status == 200 and body == opool[off : off + size],
                  f"degraded GET of online needle {n} reads wrong")
        degraded_launches = gf256_matmul.launches - n0
        check(degraded_launches >= len(pick), "a degraded read did not reconstruct on the card")
        reb = ca.json("/admin/ec/rebuild", {"volume": VS_ONLINE_VID})
        check(reb["rebuilt"] == list(VS_ONLINE_LOST), f"rebuilt {reb}")
        for s in VS_ONLINE_LOST:
            p = obase + geometry.to_ext(s)
            check(same_file(p, p + ".orig"), f"rebuilt shard {s} differs")
        mounted = ca.json("/admin/ec/mount", {"volume": VS_ONLINE_VID})
        check(mounted["shards"] == list(range(14)), f"remounted shards {mounted}")
        res.update(online_bytes=VS_ONLINE_BYTES, online_needles=len(oplan),
                   parity_health_after_tear=health, rearm_s=rearm_s, rearm_rows=out["rows"],
                   rearm_launches=rearm_launches, parity_rows_equal_plain=rows,
                   online_degraded_reads=len(pick), online_degraded_launches=degraded_launches)
        # 6. shard-read errors on the sealed volume: reads rebuilt through the codec
        out = run_command(env, f"cluster.faults -arm volume.ec.shard.read -mode error "
                               f"-rate 0.25 -count {VS_SHARD_FAULTS}")
        check(out.startswith("armed volume.ec.shard.read (error)"), out)
        pick = rng.choice(len(oplan), VS_SAMPLE)  # the volume holds fewer needles
        n0 = gf256_matmul.launches
        t0 = time.perf_counter()
        for i in pick:
            n, off, size = oplan[i]
            status, body = ca.request(
                "GET", f"/{VS_ONLINE_VID},{file_id.format_needle_id_cookie(n, 0x0E)}")
            check(status == 200 and body == opool[off : off + size],
                  f"GET of sealed needle {n} under shard-read errors reads wrong")
        shard_fault_s = time.perf_counter() - t0
        shard_fault_launches = gf256_matmul.launches - n0
        state = {p["point"]: p for p in get_json(f"{a.url}/debug/faults")["points"]}
        run_command(env, "cluster.faults -disarmAll")
        check(state["volume.ec.shard.read"]["armed"] is None,
              "the shard-read fault did not fire all its count")
        check(shard_fault_launches > 0, "no read under shard-read errors went through the codec")
        res.update(shard_fault_gets=len(pick), shard_fault_s=shard_fault_s,
                   shard_fault_firings=VS_SHARD_FAULTS,
                   shard_fault_codec_launches=shard_fault_launches)
        for c in (ca, cb):
            c.close()
        run_command(env, "volume.vacuum.enable")
        run_command(env, "unlock")
        launches = read_launches()

        # (c) the child's 5-byte EC path against a 4-byte encode here
        try:
            stdout, stderr = child.communicate(timeout=max(1.0, VS_WALL_LIMIT_S
                                                           - (time.perf_counter() - t_phase)))
        except subprocess.TimeoutExpired:
            child.kill()
            stdout, stderr = child.communicate()
        check(child.returncode == 0, f"the 5-byte child failed: {stderr[-2000:]}")
        c5 = json.loads(stdout.strip().splitlines()[-1])
        base5 = os.path.join(child_dir, "1")
        d4 = os.path.join(root, "offset4")
        os.makedirs(d4)
        base4 = os.path.join(d4, "1")
        shutil.copyfile(base5 + ".dat", base4 + ".dat")
        with open(base4 + ".idx", "wb") as f:
            for key, off, size in idx_entries(base5 + ".idx", 17):
                f.write(key.to_bytes(8, "big") + (off // 8).to_bytes(4, "big")
                        + (size & 0xFFFFFFFF).to_bytes(4, "big"))
        encoder.write_sorted_file_from_idx(base4)
        n0 = gf256_matmul.launches
        encoder.write_ec_files(base4, codec=RSCodec(device=dev))
        launches["gf256_matmul"] += gf256_matmul.launches - n0
        for i in range(14):
            check(sha256_file(base4 + geometry.to_ext(i)) == sha256_file(base5 + geometry.to_ext(i)),
                  f"5-byte shard {i} != the 4-byte encode's")
        e5, e4 = idx_entries(base5 + ".ecx", 17), idx_entries(base4 + ".ecx", 16)
        check(os.path.getsize(base5 + ".ecx") == 17 * len(e5) and e5 == e4 and e5,
              "the 17-byte .ecx entries != the 4-byte ones")
        check(sha256_file(os.path.join(child_dir, "decoded.dat")) == sha256_file(base5 + ".dat"),
              "the 5-byte decode differs from the .dat")
        launches["gf256_matmul"] += c5["launches"]
        check(c5["launches"] > 0 and c5["degraded_launches"] > 0,
              f"the 5-byte path launched no gf256_matmul kernel: {c5}")
        res["offset5"] = {**c5, "shards_equal_4byte": True, "ecx_entries": len(e5),
                          "decoded_equal": True}
        res["launches"] = {k: launches[k] for k in ("crc32c_batch", "gf256_matmul")}
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        for vs in servers:
            vs.stop()
        master.stop()
        shutil.rmtree(root, ignore_errors=True)
    n, length = VS_SHAPES["crc32c_batch"]
    res["crc_kernel"] = hash_shape_times(dev, seed, HASH_WRAPPERS, md5_ops_per_block,
                                         shapes=((n, length),), gear=False)["crc32c_batch"]
    res["gf_kernel"] = gf256_shape_times(dev, seed, gf256_matmul,
                                         shapes=(VS_SHAPES["gf256_matmul"],))
    for row in res["crc_kernel"] + res["gf_kernel"]:
        row["path"] = "volume_side"
    wall = time.perf_counter() - t_phase
    res.update(wall_s=wall, wall_limit_s=VS_WALL_LIMIT_S, over_wall_limit=wall > VS_WALL_LIMIT_S,
               cuts=VS_CUTS, racks=list(VS_RACKS))
    return res


# --- phase 18: the filer's other front doors and remote storage --------------------------
GW_DAV_DIRS = 8  # the shared drive's tree: the files spread over 8 collections
GW_DAV_CLIENTS = 8
GW_DAV_SIZES = (1024, 8 * MIB)  # log-uniform: some files span two 4 MiB chunks
GW_FTP_SESSIONS = 4
GW_FTP_FILE = MIB
GW_FTP_CREDS = ("gateways", "gateways-secret")
GW_MOUNT_IO = 128 * 1024  # the kernel's usual max_write, and the READ size
GW_SMALL = 4096  # the untar's files
GW_REMOTE_SIZES = (1024, 4 * MIB)  # log-uniform: a share of them 2 KiB or less (inline)
GW_REMOTE_PER_DIR = 128  # remote.cache walks up to 1,024 entries a directory
GW_READ_THROUGH = 64
GW_REMOTE_NEW = 16
GW_WRITE_BACK = 64
GW_STALL_S = 12  # the s3 phase's per-op limit: a stall prints every stack and fails
DAV_NS = {"D": "DAV:"}
LOCK_INFO = (b'<?xml version="1.0"?><D:lockinfo xmlns:D="DAV:"><D:lockscope><D:exclusive/>'
             b"</D:lockscope><D:locktype><D:write/></D:locktype></D:lockinfo>")
GW_WALL_LIMIT_S = 150
GW_CUTS = ("(a) --gw-dav-files (256) files, about 0.23 GB, and (d) --gw-remote-mib (256) MiB of"
           " remote objects (512 each until the sync_mq phase took room), a quarter of 1,024"
           " and of 1 GiB; at half of each the phase took 117.5 s and the run"
           " 922 s on an H100 80GB HBM3 at 700 W, past the run's 900 s (WebDAV PUTs and"
           " remote.cache wait on one serial md5_batch chain a chunk, each of its own length)",
           "(b) --gw-ftp-files (256) files of 1 MiB and one of --gw-ftp-large-mib (256) MiB",
           "(c) one --gw-mount-mib (512) MiB file (1024 until the sync_mq phase) and 256 files"
           " of 4 KiB through the mount",
           "every server, gateway and client shares one process and one GIL")


def log_uniform(rng: np.random.Generator, lo: int, hi: int, n: int) -> list[int]:
    return [int(np.exp(rng.uniform(np.log(lo), np.log(hi)))) for _ in range(n)]


class Watch:
    """Every op of a phase timed; an op in flight past GW_STALL_S prints every
    thread's stack to stderr, once, and `close()` fails the phase on it or
    on any op that took longer."""

    def __init__(self, phase: str) -> None:
        self.phase = phase
        self.inflight: dict[int, tuple[float, str]] = {}
        self.stalled: list = []
        self.slowest = (0.0, "")
        self._mu = threading.Lock()  # slowest is read, compared and set by every client
        self._done = threading.Event()
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self) -> None:
        while not self._done.wait(1.0) and not self.stalled:
            now = time.perf_counter()
            slow = [(what, now - t0) for t0, what in list(self.inflight.values())
                    if now - t0 > GW_STALL_S]
            if slow:
                self.stalled.append(slow)
                print(f"{self.phase}: ops in flight past {GW_STALL_S} s {slow}; every thread:\n"
                      + thread_stacks(), file=sys.stderr, flush=True)

    def __call__(self, what: str, fn, *args):
        """(fn(*args), seconds)."""
        key = threading.get_ident()
        t0 = time.perf_counter()
        self.inflight[key] = (t0, what)
        try:
            out = fn(*args)
        finally:
            del self.inflight[key]
        dt = time.perf_counter() - t0
        with self._mu:
            if dt > self.slowest[0]:
                self.slowest = (dt, what)
        return out, dt

    def stop(self) -> None:
        self._done.set()

    def close(self) -> None:
        self.stop()
        check(not self.stalled and self.slowest[0] <= GW_STALL_S,
              f"{self.phase}: {self.slowest[1]} took {self.slowest[0]:.3f} s, or ops were in"
              f" flight past {GW_STALL_S} s: {self.stalled} (the threads' stacks are on stderr)")


def fan_out(fn, items: list, clients: int, errors: list) -> float:
    """fn(client_index, item) over items from `clients` threads, each taking
    every clients-th item and waiting for each answer; the wall."""
    def work(t: int) -> None:
        try:
            for item in items[t::clients]:
                fn(t, item)
        except BaseException as e:  # re-raised on the main thread through check
            errors.append(f"{type(e).__name__}: {e}")

    return run_threads(work, clients)


def gateways_phase(dev: torch.device, dav_files: int, ftp_files: int, ftp_large: int,
                   mount_bytes: int, small_files: int, remote_bytes: int,
                   md5_ops_per_block: int, seed: int) -> dict:
    """The filer's other front doors and remote storage, in one process: a
    port master (pulse 1 s), two volume servers and a FilerServer (4 MiB
    chunks, dedup off, a local socket under build/) on the card; a
    WebDavServer, an FtpServer with fixed credentials, and a WFS over the
    filer's unix_url driven through VirtualFuseKernel. Bodies from `seed`.
    (a) WebDAV as a shared drive or an rclone remote sees it: MKCOL a tree of
    8 collections, PUT `dav_files` files (log-uniform 1 KiB-8 MiB) from 8
    keep-alive clients, each waiting for its answer; PROPFIND Depth 1 lists
    every file with its size and a getetag equal to hashlib's MD5; every GET
    equal; COPY then MOVE a collection (equal at the new paths, gone from the
    copy's); LOCK a file: a PUT without the token 423, with it 201, UNLOCK.
    (b) FTP: `ftp_files` files of 1 MiB STORed from 4 sessions and one of
    `ftp_large` bytes; RETR of each equal; SIZE and LIST agree.
    (c) the mount as a backup job through `weed mount` sees it: one file of
    `mount_bytes` in 128 KiB WRITEs, flushed and released; read back in 128
    KiB READs and once over the filer's HTTP GET, both with the SHA-256 of
    the bytes written; 1 MiB overwritten across the middle chunk edge and
    flushed, read back latest; `small_files` files of 4 KiB created,
    written, flushed and released, listed by READDIR; the directory
    renamed; a file PUT over HTTP visible through the mount once the meta
    cache sees its event; `mount.configure -quotaMB 1` over the admin socket
    (below the usage), then a WRITE answers ENOSPC.
    (d) remote storage as `remote.mount` of existing buckets sees it:
    `remote_bytes` of objects (log-uniform 1 KiB-4 MiB) in two buckets of a
    LocalRemoteStorage under build/; `remote.configure`,
    `remote.mount.buckets`: a stub a object, no chunks; 64 read-through GETs
    equal; `remote.cache` of the rest: every entry's md5 hashlib's; one
    directory uncached, a GET caching it again, equal; 16 new objects
    appearing after `remote.meta.sync`; 64 files PUT through WebDAV into a
    mounted bucket and one object DELETEd, then `filer.remote.sync -once`
    over a window from just before those writes: the remote holds the 64
    equal and lacks the deleted one.
    md5_batch and crc32c_batch launch in the phase; no op takes or stays in
    flight past 12 s."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke-gateways-", dir=REPO / "build")
    sock = str(REPO / "build" / f"gateways-{os.getpid()}.sock")  # well under 108 bytes
    master = MasterServer(port=0, pulse_seconds=1)
    master.start()
    servers, stops = [], []
    batches = []  # (blobs, length, seconds) of every batch the filer's flusher hashed
    res = {}
    try:
        for i in range(2):
            vs = VolumeServer([os.path.join(root, f"v{i}")], master.url,
                              pulse_seconds=PULSE_S, device=dev)
            vs.start()
            servers.append(vs)
        filer = FilerServer(master.url, port=0, device=dev, local_socket=sock)
        filer.start()
        stops.append(filer.stop)
        svc = filer.hash_service
        check(filer.device.type == dev.type and svc.device.type == dev.type
              and all(vs.device.type == dev.type for vs in servers),
              "a gateways role is not on the card")
        timed_batches(svc, batches)
        dav = WebDavServer(filer.url, port=0)
        dav.start()
        stops.append(dav.stop)
        ftp = FtpServer(filer.url, port=0, user=GW_FTP_CREDS[0], password=GW_FTP_CREDS[1])
        ftp.start()
        stops.append(ftp.stop)
        env = CommandEnv(master.url, filer.url)
        zero_launches()
        watch = Watch("gateways")
        stops.append(watch.stop)
        errors: list = []

        # (a) WebDAV
        t0 = time.perf_counter()
        rng = np.random.default_rng([seed, 31])
        sizes = log_uniform(rng, *GW_DAV_SIZES, dav_files)
        files = [(f"/dav/d{i % GW_DAV_DIRS}/f{i:05d}.bin", rng.bytes(n))
                 for i, n in enumerate(sizes)]
        bodies = dict(files)
        md5s = {p: hashlib.md5(b).hexdigest() for p, b in files}
        gen_s = time.perf_counter() - t0
        c = Client(dav.url)
        for d in ["/dav"] + [f"/dav/d{k}" for k in range(GW_DAV_DIRS)]:
            check(c.request("MKCOL", d)[0] == 201, f"MKCOL {d}")
        conns = [Client(dav.url) for _ in range(GW_DAV_CLIENTS)]
        put_lat, get_lat = [], []

        def put(t: int, item) -> None:
            path, body = item
            (status, out), dt = watch(f"PUT {path}", conns[t].request, "PUT", path, body)
            put_lat.append(dt)
            if status != 201:
                errors.append(f"PUT {path} -> {status}: {out[:200]!r}")

        put_s = fan_out(put, files, GW_DAV_CLIENTS, errors)
        check(not errors, f"WebDAV PUTs: {errors[:3]}")
        listed = {}
        t0 = time.perf_counter()
        for k in range(GW_DAV_DIRS):
            status, xml = c.request("PROPFIND", f"/dav/d{k}", headers={"Depth": "1"})
            check(status == 207, f"PROPFIND /dav/d{k} -> {status}")
            for r in ET.fromstring(xml).findall("D:response", DAV_NS):
                length = r.find(".//D:getcontentlength", DAV_NS)
                if length is not None:
                    listed[r.find("D:href", DAV_NS).text] = (
                        int(length.text), r.find(".//D:getetag", DAV_NS).text)
        propfind_s = time.perf_counter() - t0
        check(listed == {p: (len(b), f'"{md5s[p]}"') for p, b in files},
              "PROPFIND's sizes or getetags differ from the files PUT and hashlib's MD5")

        def get(t: int, item) -> None:
            path, body = item
            (status, out), dt = watch(f"GET {path}", conns[t].request, "GET", path)
            get_lat.append(dt)
            if status != 200 or out != body:
                errors.append(f"GET {path} -> {status}, {len(out)} bytes")

        get_s = fan_out(get, files, GW_DAV_CLIENTS, errors)
        check(not errors, f"WebDAV GETs: {errors[:3]}")
        t0 = time.perf_counter()
        dest = dav.url + "/dav/copy0"
        check(c.request("COPY", "/dav/d0", headers={"Destination": dest})[0] == 201, "COPY")
        check(c.request("MOVE", "/dav/copy0",
                        headers={"Destination": dav.url + "/dav/moved0"})[0] == 201, "MOVE")
        copy_move_s = time.perf_counter() - t0
        subtree = [(p, b) for p, b in files if p.startswith("/dav/d0/")]
        for path, body in subtree:
            check(c.request("GET", path.replace("/d0/", "/moved0/"))[1] == body,
                  f"{path} differs after COPY and MOVE")
            check(c.request("GET", path.replace("/d0/", "/copy0/"))[0] == 404,
                  f"{path} is still at the MOVE's source")
            check(c.request("GET", path)[1] == body, f"{path} changed under COPY")
        locked = files[1][0]
        status, headers, _ = http_request("LOCK", dav.url + locked, LOCK_INFO)
        token = headers.get("Lock-Token", "").strip("<>")
        check(status == 200 and token.startswith("opaquelocktoken:"), f"LOCK -> {status}")
        check(c.request("PUT", locked, b"no token")[0] == 423, "a PUT without the lock token")
        check(c.request("PUT", locked, bodies[locked], {"If": f"(<{token}>)"})[0] == 201,
              "a PUT with the lock token")
        check(c.request("UNLOCK", locked, headers={"Lock-Token": f"<{token}>"})[0] == 204,
              "UNLOCK")
        for cl in conns + [c]:
            cl.close()
        dav_bytes = sum(sizes)
        res["webdav"] = dict(
            files=dav_files, bytes=dav_bytes, clients=GW_DAV_CLIENTS, generate_s=gen_s,
            put_s=put_s, put_files_per_s=dav_files / put_s, put_gbps=dav_bytes / put_s / 1e9,
            put=_pcts(put_lat), get_s=get_s, get_files_per_s=dav_files / get_s,
            get_gbps=dav_bytes / get_s / 1e9, get=_pcts(get_lat), propfind_s=propfind_s,
            copy_move_s=copy_move_s, copied_files=len(subtree), lock=[200, 423, 201, 204],
            getetag_equals_md5=dav_files)

        # (b) FTP
        def session():
            s = ftplib.FTP()
            s.connect("127.0.0.1", ftp.port, timeout=30)
            s.login(*GW_FTP_CREDS)
            return s

        rng = np.random.default_rng([seed, 32])
        ftp_set = [(f"/ftp/f{i:04d}.bin", rng.bytes(GW_FTP_FILE)) for i in range(ftp_files)]
        large = ("/ftp/large.bin", rng.bytes(ftp_large))
        sessions = [session() for _ in range(GW_FTP_SESSIONS)]
        sessions[0].mkd("/ftp")

        def stor(t: int, item) -> None:
            path, body = item
            reply, _ = watch(f"STOR {path}", sessions[t].storbinary, f"STOR {path}",
                             io.BytesIO(body), 1 << 20)
            if not reply.startswith("226"):
                errors.append(f"STOR {path}: {reply}")

        stor_s = fan_out(stor, ftp_set, GW_FTP_SESSIONS, errors)
        (reply, large_stor_s) = watch("STOR large", sessions[0].storbinary, f"STOR {large[0]}",
                                      io.BytesIO(large[1]), 1 << 20)
        check(not errors and reply.startswith("226"), f"FTP STOR: {errors[:3]} {reply}")

        def retr(t: int, item) -> None:
            path, body = item
            buf = io.BytesIO()
            watch(f"RETR {path}", sessions[t].retrbinary, f"RETR {path}", buf.write, 1 << 20)
            size = sessions[t].size(path)
            if buf.getvalue() != body or size != len(body):
                errors.append(f"RETR {path}: {len(buf.getvalue())} bytes, SIZE {size}")

        retr_s = fan_out(retr, ftp_set, GW_FTP_SESSIONS, errors)
        t0 = time.perf_counter()
        retr(0, large)
        large_retr_s = time.perf_counter() - t0
        check(not errors, f"FTP RETR: {errors[:3]}")
        lines = []
        sessions[0].retrlines("LIST /ftp", lines.append)
        listing = {ln.split()[-1]: int(ln.split()[4]) for ln in lines}
        check(listing == {p.rsplit("/", 1)[1]: len(b) for p, b in ftp_set + [large]},
              "FTP LIST disagrees with the files STORed")
        for s in sessions:
            s.quit()
        ftp_bytes = ftp_files * GW_FTP_FILE
        res["ftp"] = dict(
            files=ftp_files, file_bytes=GW_FTP_FILE, sessions=GW_FTP_SESSIONS,
            stor_s=stor_s, stor_gbps=ftp_bytes / stor_s / 1e9, retr_s=retr_s,
            retr_gbps=ftp_bytes / retr_s / 1e9, large_bytes=ftp_large,
            large_stor_gbps=ftp_large / large_stor_s / 1e9,
            large_retr_gbps=ftp_large / large_retr_s / 1e9, list_entries=len(listing))

        # (c) the FUSE mount over the filer's local socket
        check(filer.service.unix_url.startswith("http+unix://"), "the filer has no local socket")
        wfs = WFS(filer.service.unix_url)
        stops.append(wfs.meta.stop)
        wfs.meta.start_subscriber()
        k = VirtualFuseKernel(wfs)
        err, mdir = k.mkdir(1, "mnt")
        check(err == 0, f"MKDIR /mnt -> {err}")
        data = np.random.default_rng([seed, 33]).bytes(mount_bytes)
        want = hashlib.sha256(data).hexdigest()
        err, ino, fh = k.create(mdir, "backup.bin")
        check(err == 0, f"CREATE -> {err}")
        t0 = time.perf_counter()
        for off in range(0, mount_bytes, GW_MOUNT_IO):
            piece = data[off:off + GW_MOUNT_IO]
            (err, n), _ = watch(f"WRITE {off}", k.write, ino, fh, off, piece)
            if err or n != len(piece):
                check(False, f"WRITE at {off} -> {err}, {n}")
        write_calls_s = time.perf_counter() - t0
        check(watch("FLUSH", k.flush, ino, fh)[0] == 0, "FLUSH")
        check(k.release(ino, fh) == 0, "RELEASE")
        write_s = time.perf_counter() - t0

        def read_through_mount(lo: int, hi: int) -> bytes:
            err, rfh = k.open(ino)
            check(err == 0, f"OPEN -> {err}")
            out = []
            for off in range(lo, hi, GW_MOUNT_IO):
                (err, piece), _ = watch(f"READ {off}", k.read, ino, rfh, off,
                                        min(GW_MOUNT_IO, hi - off))
                if err or len(piece) != min(GW_MOUNT_IO, hi - off):
                    check(False, f"READ at {off} -> {err}, {len(piece)} bytes")
                out.append(piece)
            k.release(ino, rfh)
            return b"".join(out)

        t0 = time.perf_counter()
        got = read_through_mount(0, mount_bytes)
        read_s = time.perf_counter() - t0
        check(hashlib.sha256(got).hexdigest() == want, "the mount's READs differ from the WRITEs")
        del got
        # what each READ would pay without WFS._resolved's memo: resolving
        # the visible intervals of every chunk of the file again
        entry = wfs.meta.get_entry("/mnt/backup.bin")
        resolve = []
        for _ in range(5):
            wfs._resolved_memo = None
            t0 = time.perf_counter()
            wfs._resolved(entry)
            resolve.append(time.perf_counter() - t0)
        fc = Client(filer.url)
        (status, got), http_s = watch("GET /mnt/backup.bin", fc.request, "GET", "/mnt/backup.bin")
        check(status == 200 and hashlib.sha256(got).hexdigest() == want,
              f"the filer's GET of the mount's file -> {status}, differs")
        del got
        mid = mount_bytes // 2 - MIB // 2  # across the middle chunk edge
        patch = np.random.default_rng([seed, 34]).bytes(MIB)
        err, pfh = k.open(ino)
        for off in range(0, MIB, GW_MOUNT_IO):
            check(k.write(ino, pfh, mid + off, patch[off:off + GW_MOUNT_IO]) ==
                  (0, GW_MOUNT_IO), "the overwrite's WRITE")
        check(k.flush(ino, pfh) == 0 and k.release(ino, pfh) == 0, "the overwrite's FLUSH")
        lo, hi = mid - 4 * GW_MOUNT_IO, mid + MIB + 4 * GW_MOUNT_IO
        check(read_through_mount(lo, hi) == data[lo:mid] + patch + data[mid + MIB:hi],
              "the mount reads stale bytes after the overwrite")
        status, got = fc.request("GET", "/mnt/backup.bin",
                                 headers={"Range": f"bytes={mid}-{mid + MIB - 1}"})
        check(status == 206 and got == patch, "the filer reads stale bytes after the overwrite")
        del data
        err, sdir = k.mkdir(mdir, "small")
        small = np.random.default_rng([seed, 35]).bytes(GW_SMALL * small_files)
        t0 = time.perf_counter()
        for j in range(small_files):
            (err, sino, sfh), _ = watch("CREATE small", k.create, sdir, f"f{j:04d}")
            body = small[j * GW_SMALL:(j + 1) * GW_SMALL]
            ok = (err == 0 and k.write(sino, sfh, 0, body) == (0, GW_SMALL)
                  and k.flush(sino, sfh) == 0 and k.release(sino, sfh) == 0)
            check(ok, f"small file {j}")
        small_s = time.perf_counter() - t0
        err, ents = k.readdir(sdir)
        check(err == 0 and sorted(n for _, n, _ in ents) ==
              sorted([".", ".."] + [f"f{j:04d}" for j in range(small_files)]),
              "READDIR disagrees with the files created")
        check(k.rename(mdir, "small", mdir, "renamed") == 0, "RENAME of the directory")
        err, rino, _ = k.lookup(mdir, "renamed")
        check(err == 0 and rino == sdir and k.lookup(mdir, "small")[0] == fp.ERRNO_NOENT,
              "the renamed directory")
        check(k.lookup(sdir, "f0000")[2]["size"] == GW_SMALL, "a file under the renamed directory")
        check(k.lookup(sdir, "from-http.txt")[0] == fp.ERRNO_NOENT, "from-http.txt exists early")
        t0 = time.perf_counter()
        check(fc.request("PUT", "/mnt/renamed/from-http.txt", b"written over HTTP")[0] == 201,
              "the HTTP PUT under the mount")
        while k.lookup(sdir, "from-http.txt")[0] != 0:
            check(time.perf_counter() - t0 < GW_STALL_S, "the meta cache never saw the PUT")
            time.sleep(0.01)
        event_s = time.perf_counter() - t0
        err, hino, attr = k.lookup(sdir, "from-http.txt")
        err, hfh = k.open(hino)
        check(k.read(hino, hfh, 0, 100) == (0, b"written over HTTP"), "the HTTP file's READ")
        k.release(hino, hfh)
        fc.close()
        mountpoint = os.path.join(root, "mountpoint")
        admin = start_admin_service(wfs, mountpoint)
        stops.append(admin.stop)
        out = run_command(env, f"mount.configure -dir {mountpoint} -quotaMB 1")
        check(out == "quota set to 1048576 bytes", f"mount.configure: {out}")
        status_line = run_command(env, f"mount.configure -dir {mountpoint}")
        err, qino, qfh = k.create(sdir, "over-quota.bin")
        check(err == 0 and k.write(qino, qfh, 0, b"x" * GW_SMALL)[0] == fp.ERRNO_NOSPC,
              "a WRITE past the quota did not answer ENOSPC")
        k.release(qino, qfh)
        res["mount"] = dict(
            bytes=mount_bytes, io_bytes=GW_MOUNT_IO, writes=mount_bytes // GW_MOUNT_IO,
            write_calls_s=write_calls_s, write_s=write_s, write_gbps=mount_bytes / write_s / 1e9,
            read_s=read_s, read_gbps=mount_bytes / read_s / 1e9,
            chunks=len(entry["chunks"]), resolve_ms=float(np.median(resolve)) * 1e3,
            http_get_s=http_s,
            http_get_gbps=mount_bytes / http_s / 1e9, sha256=want,
            small_files=small_files, small_s=small_s,
            small_ops_per_s=4 * small_files / small_s, small_files_per_s=small_files / small_s,
            event_visible_ms=event_s * 1e3, quota=status_line, enospc=True)

        # (d) remote storage
        t0 = time.perf_counter()
        rng = np.random.default_rng([seed, 36])
        cloud_root = os.path.join(root, "cloud")
        cloud = LocalRemoteStorage(cloud_root)
        objects, total = {}, 0
        while total < remote_bytes:
            j = len(objects)
            n = min(log_uniform(rng, *GW_REMOTE_SIZES, 1)[0], remote_bytes - total)
            key = f"bucket-{'ab'[j % 2]}/p{j // 2 // GW_REMOTE_PER_DIR:03d}/o{j:05d}.bin"
            objects[key] = rng.bytes(n)
            cloud.write_file(key, objects[key])
            total += n
        fill_s = time.perf_counter() - t0
        out = run_command(env, f"remote.configure -name cloud -kind local -root {cloud_root}")
        check(out == "remote config 'cloud' saved (configs: ['cloud'])", f"remote.configure: {out}")
        t0 = time.perf_counter()
        out = run_command(env, "remote.mount.buckets -remote cloud")
        mount_s = time.perf_counter() - t0
        check(out == "mounted 2 buckets: bucket-a, bucket-b", f"remote.mount.buckets: {out}")

        def stubs() -> dict:
            found = {}

            def walk(d: str) -> None:
                for e in filer.filer.list_entries(d, limit=1 << 31):
                    if e.is_directory:
                        walk(e.full_path)
                    else:
                        found[e.full_path[len("/buckets/"):]] = e
            walk("/buckets")
            return found

        entries = stubs()
        check(sorted(entries) == sorted(objects)
              and not any(e.chunks or e.content for e in entries.values()),
              "the stubs differ from the remote's objects, or carry chunks")
        keys = sorted(objects)
        picks = [keys[i] for i in np.random.default_rng([seed, 37]).choice(
            len(keys), GW_READ_THROUGH, replace=False)]
        fc = Client(filer.url)
        rt_lat = []
        for key in picks:
            (status, got), dt = watch(f"GET {key}", fc.request, "GET", f"/buckets/{key}")
            rt_lat.append(dt)
            check(status == 200 and got == objects[key], f"read-through GET of {key}")
        t0 = time.perf_counter()  # one bulk verb, not a client's op: no 12 s limit
        out = run_command(env, "remote.cache -dir /buckets")
        cache_s = time.perf_counter() - t0
        rest = len(objects) - GW_READ_THROUGH
        check(out == f"cached {rest} objects under /buckets", f"remote.cache: {out}")
        entries = stubs()
        bad = [k for k, e in entries.items()
               if e.attributes.md5 != hashlib.md5(objects[k]).hexdigest()
               or not (e.chunks or e.content)]
        check(not bad, f"cached entries whose md5 is not hashlib's: {bad[:3]}")
        inline = sum(1 for e in entries.values() if e.content)
        cached_bytes = total - sum(len(objects[k]) for k in picks)
        out = run_command(env, "remote.uncache -dir /buckets/bucket-a/p000")
        dropped = [k for k in keys if k.startswith("bucket-a/p000/")]
        check(out == f"uncached {len(dropped)} objects under /buckets/bucket-a/p000",
              f"remote.uncache: {out}")
        check(not stubs()[dropped[-1]].chunks, "an uncached entry keeps its chunks")
        check(fc.request("GET", f"/buckets/{dropped[-1]}") == (200, objects[dropped[-1]]),
              "a GET after remote.uncache")
        check(stubs()[dropped[-1]].attributes.md5 == hashlib.md5(objects[dropped[-1]]).hexdigest(),
              "the re-cached entry's md5")
        rng = np.random.default_rng([seed, 38])
        new = {f"bucket-b/new/n{j:02d}.bin": rng.bytes(log_uniform(rng, *GW_REMOTE_SIZES, 1)[0])
               for j in range(GW_REMOTE_NEW)}
        for key, body in new.items():
            cloud.write_file(key, body)
        out = run_command(env, "remote.meta.sync -dir /buckets/bucket-b")
        check(out == f"synced {GW_REMOTE_NEW} entries under /buckets/bucket-b",
              f"remote.meta.sync: {out}")
        for key, body in new.items():
            check(fc.request("GET", f"/buckets/{key}") == (200, body), f"GET of the new {key}")
        fc.close()
        t_wb = time.time()
        c = Client(dav.url)
        check(c.request("MKCOL", "/buckets/bucket-a/wb")[0] == 201, "MKCOL in the mounted bucket")
        rng = np.random.default_rng([seed, 39])
        written = {f"wb/w{j:02d}.bin": rng.bytes(log_uniform(rng, *GW_REMOTE_SIZES, 1)[0])
                   for j in range(GW_WRITE_BACK)}
        for rel, body in written.items():
            check(c.request("PUT", f"/buckets/bucket-a/{rel}", body)[0] == 201, f"PUT {rel}")
        gone = dropped[0]
        check(c.request("DELETE", f"/buckets/{gone}")[0] == 204, f"DELETE {gone}")
        c.close()
        t0 = time.perf_counter()
        rc = run_filer_remote_sync(["-filer", filer.url, "-dir", "/buckets/bucket-a", "-once",
                                    "-timeAgo", str(time.time() - t_wb + 2.0)])
        sync_s = time.perf_counter() - t0
        check(rc == 0, f"filer.remote.sync -> {rc}")
        for rel, body in written.items():
            check(cloud.read_file(f"bucket-a/{rel}") == body, f"the remote's {rel} differs")
        check(not os.path.exists(cloud._abs(gone)), f"the remote still holds the deleted {gone}")
        res["remote"] = dict(
            objects=len(objects), bytes=total, inline_objects=inline, fill_s=fill_s,
            mount_buckets_s=mount_s, read_through=GW_READ_THROUGH, read_through_get=_pcts(rt_lat),
            cache_objects=rest, cache_s=cache_s, cache_gbps=cached_bytes / cache_s / 1e9,
            uncached=len(dropped), meta_sync_new=GW_REMOTE_NEW, write_back=len(written),
            write_back_deleted=1, write_back_s=sync_s)
        watch.close()
        launches = read_launches()
        for name in ("crc32c_batch", "md5_batch"):
            check(launches[name] > 0, f"the gateways phase launched no {name} kernel")
        check(svc.failed_blobs == 0, "the hash service failed a batch")
        del svc._batch_hash
        # nearly every chunk has a length of its own: the 8 lengths with the most blobs
        buckets = batch_buckets(batches)
        top = sorted(buckets, key=lambda ln: -buckets[ln]["blobs"])[:8]
        res.update(launches=launches, batch_blobs=svc.batch_blobs, host_blobs=svc.host_blobs,
                   hash_lengths=len(buckets), hash_batches=len(batches),
                   hash_buckets={ln: buckets[ln] for ln in top})
    finally:
        for stop in reversed(stops):
            stop()
        for vs in servers:
            vs.stop()
        master.stop()
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    # the kernels at the commonest batch of the phase's commonest chunk lengths
    res["hash_kernels"] = path_hash_times(dev, seed, md5_ops_per_block, batches,
                                          (FILER_CHUNK, GW_FTP_FILE), "gateways")
    res.update(wall_s=wall, wall_limit_s=GW_WALL_LIMIT_S, over_wall_limit=wall > GW_WALL_LIMIT_S,
               cuts=GW_CUTS, note="clients and servers share one process and one GIL")
    return res


SYNC_CLIENTS = 4  # keep-alive writers a side
SYNC_DIRS = 8
SYNC_SIZES = (1024, 8 * MIB)  # the gateways phase's log-uniform sizes
SYNC_MOVES = 32  # files renamed, and files deleted, on each side
SYNC_QUIET_S = 5.0  # each filer's event log stops growing this soon after the last write
SYNC_QUIET_WINDOW_S = 2.0
SYNC_INTERVAL_S = 1.0  # run_filer_sync's -interval default: each syncer's long poll
SYNC_DEADLINE_S = 60.0  # to the last file visible, and to convergence after the moves
MQ_TOPIC = "events"
MQ_PARTITIONS = 4
MQ_PUBLISHERS = 4
MQ_CONSUMERS = 2
MQ_VALUE = 1024  # bytes a value: 512 seeded bytes as hex
MQ_RETRY_S = 10.0  # a publish retries through the failover for this long, then fails
SYNC_MQ_WALL_LIMIT_S = 150
SYNC_MQ_CUTS = ("(a) --sync-files (128) files a side, log-uniform 1 KiB-8 MiB (about 0.22 GiB in"
                " all; 256 until the secure_ha phase took room in the run), of the compose"
                " deployments' unbounded trees",
                "(c) --mq-messages (4,096) of 1 KiB over 4 partitions, 8 segments of 512: a"
                " quarter of 16,384, at which the phase took 165 s of its 150 on an H100 80GB"
                " HBM3 at 700 W (178 msgs/s: every publish a few Python HTTP hops in one"
                " process); 8,192 until the secure_ha phase took room in the run",
                "both clusters, the syncers, both brokers and every client share one process"
                " and one GIL")


class _Refused:
    """A dead process's connection pool: every request is refused."""

    def request(self, *args, **kwargs):
        raise ConnectionRefusedError(111, "the broker crashed")

    def close(self) -> None:
        pass


def record_accepts(service) -> list:
    """The connections `service`'s listener accepts from now on, so that a
    crash can reset them (`HTTPService.stop()` closes only the listener)."""
    socks = []
    srv = service._httpd
    accept = srv.process_request

    def process_request(request, client_address):
        socks.append(request)
        return accept(request, client_address)

    srv.process_request = process_request
    return socks


def reset_all(socks: list) -> None:
    for s in socks:
        try:
            s.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass


class Crashable:
    """A broker that can crash as its process would. `HTTPService.stop()`
    closes only the listener: handler threads go on serving kept-alive
    connections, and in one process the broker's threads live on. So the
    accepted connections are recorded and reset, the broker's filer client
    and follower pool are cut, and its registration stops. The crash lands
    between two segment writes (every partition's flush lock held across
    it): a write already on the wire would land after it, which one process
    cannot undo."""

    def __init__(self, broker) -> None:
        self.broker = broker
        self.socks = record_accepts(broker.service)
        self.crashed = False

    def crash(self) -> None:
        b = self.broker
        with contextlib.ExitStack() as held:
            for tp in list(b._partitions.values()):
                held.enter_context(tp._flush_mu)
            b.service.stop()
            reset_all(self.socks)
            b._stop.set()
            b._repl_pool.shutdown(wait=False, cancel_futures=True)
            b.fc.close()
            b._follow_http.close()
            b.fc._pool = b._follow_http = _Refused()
            self.crashed = True

    def stop(self) -> None:
        """Tear down: a crashed broker's memory is never flushed."""
        if self.crashed:
            self.broker._repl_pool.shutdown(wait=True, cancel_futures=True)
        else:
            self.broker.stop()
            self.broker._repl_pool.shutdown(wait=True)


def sockstat() -> str | None:
    """The host's TCP socket counts (in use, orphaned, TIME_WAIT), or None."""
    try:
        with open("/proc/net/sockstat") as f:
            return next((ln.strip() for ln in f if ln.startswith("TCP:")), None)
    except OSError:
        return None


def walk_files(filer) -> dict:
    """{path: Entry} of every file under /sync of an in-process filer."""
    found = {}

    def walk(d: str) -> None:
        for e in filer.filer.list_entries(d, limit=1 << 31):
            if e.is_directory:
                walk(e.full_path)
            else:
                found[e.full_path] = e
    walk("/sync")
    return found


def disk_sha256(root: str) -> dict:
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            p = os.path.join(d, name)
            out["/" + os.path.relpath(p, root)] = sha256_file(p)
    return out


def events_since(url: str, since_ns: int) -> list:
    out, cursor = [], since_ns
    while True:
        page = get_json(f"{url}/__meta__/events?since_ns={cursor}&limit=1024")
        if not page["events"]:
            return out
        out += page["events"]
        cursor = page["next_ts_ns"]


def sync_mq_phase(dev: torch.device, sync_files: int, mq_messages: int, md5_ops_per_block: int,
                  seed: int) -> dict:
    """Sync and messaging as upstream's compose deployments run them
    (`docker/compose/local-clusters-compose.yml`, `local-sync-mount-compose.yml`:
    two clusters under `filer.sync`; `local-replicate-compose.yml`: a
    notification queue and `filer.replicate`), in one process: clusters A and
    B, each a port master (pulse 1 s), a volume server and a FilerServer (4
    MiB chunks) on the card, A's with a FileQueue spool as its notification
    queue. (a) one FilerSyncer each way on threads with a stop event, as
    `run_filer_sync` builds them (-interval 1); `sync_files` files written to
    A and as many to B (log-uniform 1 KiB-8 MiB from the seed) from 4
    keep-alive clients a side, each waiting for its 201; a watcher a
    direction long-polls the other filer's events and GETs each file as its
    create lands there (the lag: the 201 on one side to that first GET, whose
    SHA-256 must be the body's); then 32 files renamed and 32 deleted on each
    side; both trees converge to the expected one and are equal by SHA-256,
    every chunk's stored MD5 (and each file's) is hashlib's, and each filer's
    event log stops growing within 5 s of the last write (no event loops);
    events applied and skipped by signature a direction, from the source's
    log. (b) `filer.replicate -once -sink.local` over A's spool and
    `filer.backup -once` of A: both directories hold A's /sync tree by
    SHA-256. (c) two BrokerServers over A's filer, registered with A's
    master; topic `events`, 4 partitions, replication 1 (the first name of
    events, events-1, ... whose partitions both brokers own some of); 4
    Publishers (discovery through the master) send `mq_messages` keyed 1 KiB
    messages from the seed while a group of 2 Consumers polls and commits;
    halfway, the broker that registered second is crashed with no flush
    (`service.stop()`, its kept-alive connections reset, its registration
    stopped) and the survivor's ring heals, as the JAX test does; every
    acked message is consumed by the group with its seeded value, in offset
    order a consumer and partition, none lost; the group's committed offsets
    equal the high-water marks; every segment file's chunk MD5 is hashlib's
    and the segments hold exactly the committed messages; `mq.topic.list`,
    `mq.topic.describe` and `mq.balance` through the port's shell. No op
    stays in flight past 12 s; md5_batch and crc32c_batch launch."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke-sync_mq-", dir=REPO / "build")
    spool = os.path.join(root, "spool")
    stops, batches, res = [], [], {}
    svcs = []
    # set on the way out, pass or fail: every loop of the phase's threads ends
    done, stop_sync = threading.Event(), threading.Event()
    try:
        stops.append(done.set)
        stops.append(stop_sync.set)
        clusters = {}
        for name in ("a", "b"):
            master = MasterServer(port=0, pulse_seconds=1)
            master.start()
            stops.append(master.stop)
            vs = VolumeServer([os.path.join(root, f"{name}-v")], master.url,
                              pulse_seconds=PULSE_S, device=dev)
            vs.start()
            stops.append(vs.stop)
            filer = FilerServer(master.url, port=0, device=dev,
                                notification_queue=FileQueue(spool) if name == "a" else None)
            filer.start()
            stops.append(filer.stop)
            check(filer.device.type == dev.type and filer.hash_service.device.type == dev.type
                  and vs.device.type == dev.type, f"a role of cluster {name} is not on the card")
            timed_batches(filer.hash_service, batches)
            svcs.append(filer.hash_service)
            clusters[name] = (master, vs, filer)
        fa, fb = clusters["a"][2], clusters["b"][2]
        zero_launches()
        watch = Watch("sync_mq")
        stops.append(watch.stop)
        errors: list = []

        # (a) active-active filer.sync
        t0 = time.perf_counter()
        files = {}
        for name, stream in (("a", 41), ("b", 42)):
            rng = np.random.default_rng([seed, stream])
            for i, n in enumerate(log_uniform(rng, *SYNC_SIZES, sync_files)):
                files[f"/sync/{name}/d{i % SYNC_DIRS}/f{i:04d}.bin"] = rng.bytes(n)
        want_sha = {p: hashlib.sha256(b).hexdigest() for p, b in files.items()}
        gen_s = time.perf_counter() - t0
        ab, ba = FilerSyncer(fa.url, fb.url), FilerSyncer(fb.url, fa.url)
        sync_threads = [threading.Thread(target=s.run_forever, args=(SYNC_INTERVAL_S, stop_sync),
                                         daemon=True) for s in (ab, ba)]
        for t in sync_threads:
            t.start()

        def stop_syncers() -> None:
            stop_sync.set()
            for t in sync_threads:
                t.join(timeout=2 * SYNC_INTERVAL_S + 30)
            ab.close()
            ba.close()
        stops.append(stop_syncers)
        since_ns = min(ab.cursor_ns, ba.cursor_ns)
        acked_ns, visible_ns = {}, {}
        directions = {"a": (fa, fb), "b": (fb, fa)}

        def watcher(src: str) -> None:
            """Long-polls the target's events; GETs each of src's files as
            its create lands there."""
            _, target = directions[src]
            pending = {p for p in files if p.startswith(f"/sync/{src}/")}
            c = Client(target.url)
            cursor = since_ns
            deadline = time.time() + SYNC_DEADLINE_S + 60
            try:
                while pending and time.time() < deadline and not done.is_set():
                    page = get_json(f"{target.url}/__meta__/events?since_ns={cursor}&wait=1")
                    cursor = page["next_ts_ns"]
                    for ev in page["events"]:
                        path = (ev.get("new_entry") or {}).get("full_path")
                        if path not in pending:
                            continue
                        (status, body), _ = watch(f"GET {path} at the target", c.request,
                                                  "GET", path)
                        visible_ns[path] = time.time_ns()
                        pending.discard(path)
                        if status != 200 or hashlib.sha256(body).hexdigest() != want_sha[path]:
                            errors.append(f"first GET of {path} on the target -> {status},"
                                          f" {len(body)} bytes")
                if pending:
                    errors.append(f"{len(pending)} of {src}'s files never reached the other side")
            except BaseException as e:
                errors.append(f"watcher {src}: {type(e).__name__}: {e}")
            finally:
                c.close()

        watchers = [threading.Thread(target=watcher, args=(s,), daemon=True) for s in ("a", "b")]
        for t in watchers:
            t.start()
        writers = {s: [Client(directions[s][0].url) for _ in range(SYNC_CLIENTS)] for s in "ab"}
        put_lat = []

        def put(t: int, item) -> None:
            path, body = item
            side = path.split("/")[2]
            # items alternate a, b: client t writes side a when t is even
            (status, out), dt = watch(f"PUT {path}", writers[side][t // 2].request,
                                      "PUT", path, body, OCTET)
            acked_ns[path] = time.time_ns()
            put_lat.append(dt)
            if status != 201:
                errors.append(f"PUT {path} -> {status}: {out[:200]!r}")

        # the two sides at once: client t writes side a if t < 4, else side b
        order = ([p for p in files if p.startswith("/sync/a/")],
                 [p for p in files if p.startswith("/sync/b/")])
        items = [(p, files[p]) for pair in itertools.zip_longest(*order) for p in pair if p]
        t_first_ns = time.time_ns()
        write_s = fan_out(put, items, 2 * SYNC_CLIENTS, errors)
        for t in watchers:
            t.join()
        check(not errors, f"sync writes: {errors[:3]}")
        lag_ms = {s: [(visible_ns[p] - acked_ns[p]) / 1e6 for p in files
                      if p.startswith(f"/sync/{s}/")] for s in "ab"}
        sync_gbps = {}
        for s in "ab":
            mine = [p for p in files if p.startswith(f"/sync/{s}/")]
            wall = (max(visible_ns[p] for p in mine) - t_first_ns) / 1e9
            sync_gbps[f"{s}_to_{'ba'[s == 'b']}"] = dict(
                files=len(mine), bytes=sum(len(files[p]) for p in mine), wall_s=wall,
                gbps=sum(len(files[p]) for p in mine) / wall / 1e9,
                lag=_pcts([x / 1e3 for x in lag_ms[s]]))
        for c in itertools.chain(*writers.values()):
            c.close()

        # renames and deletes on each side, then convergence
        expected = dict(files)
        t0 = time.perf_counter()
        for s, (src, _) in directions.items():
            c = Client(src.url)
            mine = sorted(p for p in files if p.startswith(f"/sync/{s}/"))
            for p in mine[:SYNC_MOVES]:
                new = p.replace(f"/sync/{s}/", f"/sync/{s}/moved/")
                status, out = c.request("POST", f"{new}?mv.from={urllib.parse.quote(p)}", b"")
                check(status < 300, f"rename {p} -> {status}: {out[:200]!r}")
                expected[new] = expected.pop(p)
            for p in mine[SYNC_MOVES:2 * SYNC_MOVES]:
                status, _ = c.request("DELETE", p)
                check(status == 204, f"DELETE {p} -> {status}")
                expected.pop(p)
            c.close()
        t_last_ns = time.time_ns()
        moves_s = time.perf_counter() - t0
        want_md5 = {p: hashlib.md5(b).hexdigest() for p, b in expected.items()}
        deadline = time.time() + SYNC_DEADLINE_S
        while True:
            trees = [walk_files(f) for f in (fa, fb)]
            if all({p: e.attributes.md5 for p, e in t.items()} == want_md5 for t in trees):
                break
            check(time.time() < deadline,
                  f"the trees did not converge in {SYNC_DEADLINE_S} s after the moves: "
                  f"{[len(t) for t in trees]} files of {len(expected)}")
            time.sleep(0.2)
        converge_s = time.perf_counter() - t0
        # every chunk's stored MD5 against hashlib, on both sides
        chunks = inline = 0
        for tree in trees:
            for p, e in tree.items():
                body = expected[p]
                if e.content:
                    inline += 1
                for ch in e.chunks:
                    chunks += 1
                    check(ch.etag == hashlib.md5(body[ch.offset:ch.offset + ch.size]).hexdigest(),
                          f"{p}: chunk {ch.file_id}'s stored MD5 is not hashlib's")
        # both trees by SHA-256, over HTTP
        t0 = time.perf_counter()
        want_tree = {p: want_sha[p.replace("/moved/", "/")] for p in expected}
        for name, f in (("a", fa), ("b", fb)):
            readers = [Client(f.url) for _ in range(SYNC_CLIENTS)]

            def verify(t: int, path: str) -> None:
                (status, body), _ = watch(f"GET {path}", readers[t].request, "GET", path)
                if status != 200 or hashlib.sha256(body).hexdigest() != want_tree[path]:
                    errors.append(f"GET {path} from filer {name} -> {status}")

            fan_out(verify, sorted(expected), SYNC_CLIENTS, errors)
            for c in readers:
                c.close()
        verify_s = time.perf_counter() - t0
        check(not errors, f"the trees differ by SHA-256: {errors[:3]}")
        # no loop: each event log quiet within 5 s of the last write
        time.sleep(max(0.0, t_last_ns / 1e9 + SYNC_QUIET_S - time.time()))
        latest = [get_json(f"{f.url}/__meta__/info")["latest_ts_ns"] for f in (fa, fb)]
        time.sleep(SYNC_QUIET_WINDOW_S)
        later = [get_json(f"{f.url}/__meta__/info")["latest_ts_ns"] for f in (fa, fb)]
        check(later == latest, f"an event log still grows {SYNC_QUIET_S} s after the last write:"
                               f" {latest} -> {later}")
        quiet_after_ms = [(ts - t_last_ns) / 1e6 for ts in latest]
        check(max(quiet_after_ms) <= SYNC_QUIET_S * 1e3,
              f"events up to {max(quiet_after_ms):.0f} ms after the last write")
        stop_syncers()
        counts = {}
        for s, (src, dst) in directions.items():
            evs = events_since(src.url, since_ns)
            skipped = sum(1 for ev in evs if dst.filer.signature in ev.get("signatures", []))
            counts[f"{s}_to_{'ba'[s == 'b']}"] = dict(applied=len(evs) - skipped,
                                                      skipped_by_signature=skipped)
        la = read_launches()
        res["sync"] = dict(
            files_a_side=sync_files, bytes=sum(len(b) for b in files.values()), generate_s=gen_s,
            write_s=write_s, put=_pcts(put_lat), directions=sync_gbps,
            lag=_pcts([x / 1e3 for s in "ab" for x in lag_ms[s]]),
            renamed_a_side=SYNC_MOVES, deleted_a_side=SYNC_MOVES, moves_s=moves_s,
            converge_s=converge_s, files_after=len(expected), chunks_checked=chunks,
            inline_files_checked=inline, sha256_verify_s=verify_s,
            quiet_after_last_write_ms=quiet_after_ms, events=counts,
            launches={k: la[k] for k in ("crc32c_batch", "md5_batch")})

        # (b) filer.replicate -once and filer.backup -once
        tree_bytes = sum(len(b) for b in expected.values())
        out = io.StringIO()
        runs = {}
        for name, fn, argv in (
                ("replicate", run_filer_replicate,
                 ["-notification.spool", spool, "-source", fa.url, "-sink.local",
                  os.path.join(root, "replicate"), "-once"]),
                ("backup", run_filer_backup,
                 ["-filer", fa.url, "-output", os.path.join(root, "backup"), "-once"])):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = fn(argv)
            wall = time.perf_counter() - t0
            check(rc == 0, f"filer.{name} -once -> {rc}")
            got = {p: h for p, h in disk_sha256(os.path.join(root, name)).items()
                   if p.startswith("/sync/")}
            check(got == want_tree, f"filer.{name}'s tree differs from A's /sync by SHA-256:"
                                    f" {len(got)} files of {len(want_tree)}")
            runs[name] = dict(wall_s=wall, gbps=tree_bytes / wall / 1e9)
        check("replicate error" not in out.getvalue(), f"filer.replicate: {out.getvalue()[:300]}")
        runs["spool_messages"] = len(FileQueue(spool).read_all())
        runs["bytes"] = tree_bytes
        res["replicate_backup"] = runs

        # (c) the mq broker
        tcp = {"before": sockstat()}
        ma = clusters["a"][0]
        b1 = BrokerServer(fa.url, master_url=ma.url, port=0)
        b1.start()
        stops.append(lambda: (b1.stop(), b1._repl_pool.shutdown(wait=True)))
        b2 = BrokerServer(fa.url, master_url=ma.url, port=0, peers=[b1.url])
        b2.start()
        crash = Crashable(b2)
        stops.append(crash.stop)
        b1.ring.set_servers([b1.url, b2.url])
        check([b["address"] for b in get_json(f"{ma.url}/cluster/ps")["brokers"]]
              == [b1.url, b2.url], "the brokers are not registered in order")
        topic = next(t for t in [MQ_TOPIC] + [f"{MQ_TOPIC}-{i}" for i in range(1, 64)]
                     if len({b1.ring.server_for(f"default/{t}/p{k}")
                             for k in range(MQ_PARTITIONS)}) == 2)
        env = CommandEnv(ma.url)
        rng = np.random.default_rng([seed, 45])
        keys = [f"k{i:05d}-{int(rng.integers(1 << 30)):09d}" for i in range(mq_messages)]
        values = [rng.bytes(MQ_VALUE // 2).hex() for _ in range(mq_messages)]
        by_key = dict(zip(keys, values))
        pubs = [Publisher(master_url=ma.url) for _ in range(MQ_PUBLISHERS)]
        check(pubs[0].create_topic(topic, partition_count=MQ_PARTITIONS, replication=1)["ok"],
              "create_topic")
        owners = {k: b1._owner_of("default", topic, k) for k in range(MQ_PARTITIONS)}
        b2_parts = sorted(k for k, o in owners.items() if o == b2.url)
        consumers = [Consumer(topic, "readers", master_url=ma.url, instance_id=f"c{i}")
                     for i in range(MQ_CONSUMERS)]
        consumers[0]._heartbeat()  # the rebalance after the second join, as the JAX test does
        check(sorted(k for c in consumers for k in c.partitions) == list(range(MQ_PARTITIONS)),
              f"the group's assignment: {[c.partitions for c in consumers]}")
        mu = threading.Lock()
        half = threading.Event()
        acks, ack_lat, retried = {}, [], [0]
        received, got_lat, order_breaks = [], [], []
        def publish(t: int, i: int) -> None:
            t0 = time.perf_counter()
            while True:
                try:
                    out, _ = watch(f"publish {i}", pubs[t].publish, topic, values[i], keys[i])
                    break
                except MQError as e:
                    check(time.perf_counter() - t0 < MQ_RETRY_S and not done.is_set(),
                          f"publish {i} failed past {MQ_RETRY_S} s: {e}; brokers"
                          f" {pubs[t]._brokers()}, b1 {b1.url} ring {b1.ring.servers()},"
                          f" crashed {crash.crashed}")
                    with mu:
                        retried[0] += 1
                    time.sleep(0.02)
            with mu:
                acks[(out["partition"], out["offset"])] = (i, time.perf_counter())
                ack_lat.append(time.perf_counter() - t0)
                if len(acks) >= mq_messages // 2:
                    half.set()

        def consume(c: int) -> None:
            con, last = consumers[c], {}
            version = con.version
            try:
                while not done.is_set():
                    try:
                        msgs, _ = watch(f"poll {c}", con.poll, 512, 0.2)
                    except MQError:
                        time.sleep(0.02)
                        continue
                    now = time.time_ns()
                    if con.version != version:
                        version, last = con.version, {}  # a rebalance: offsets restart
                    for m in msgs:
                        k = m["partition"]
                        if m["offset"] <= last.get(k, -1):
                            order_breaks.append((c, k, last[k], m["offset"]))
                        last[k] = m["offset"]
                        got_lat.append((now - m["ts_ns"]) / 1e9)
                    with mu:
                        received.extend((m["partition"], m["offset"], m["key"], m["value"], c)
                                        for m in msgs)
                    if msgs:
                        try:
                            con.commit()
                        except MQError:
                            pass
            except BaseException as e:
                errors.append(f"consumer {c}: {type(e).__name__}: {e}")

        cthreads = [threading.Thread(target=consume, args=(c,), daemon=True)
                    for c in range(MQ_CONSUMERS)]
        for th in cthreads:
            th.start()
        t_pub = time.perf_counter()
        pub_errors: list = []
        pub_wall = {}
        pthread = threading.Thread(target=lambda: pub_wall.setdefault(
            "s", fan_out(publish, list(range(mq_messages)), MQ_PUBLISHERS, pub_errors)),
            daemon=True)
        pthread.start()
        check(half.wait(120), f"half of the messages were not acked within 120 s:"
                              f" {len(acks)} acked; {pub_errors[:3]}")
        t_kill = time.perf_counter()
        tcp["at_crash"] = sockstat()
        acked_at_crash = len(acks)
        crash.crash()  # no flush
        b1.ring.set_servers([b1.url])  # the ring heals around the survivor
        pthread.join()
        check(not pub_errors, f"publishers: {pub_errors[:3]}")
        publish_wall = pub_wall["s"]
        # every committed offset, acked or not, is consumed before the group stops
        hwm = {p["partition"]: p["high_water_mark"] for p in get_json(
            f"{b1.url}/topics/describe?topic={topic}")["partitions"]}
        committed_msgs = {(k, o) for k, n in hwm.items() for o in range(n)}
        deadline = time.time() + 60
        while time.time() < deadline:
            with mu:
                seen = {(p, o) for p, o, *_ in received}
            if committed_msgs <= seen:
                break
            time.sleep(0.1)
        t_consumed = time.perf_counter()
        done.set()
        for th in cthreads:
            th.join(timeout=30)
        check(not errors, f"consumers: {errors[:3]}")
        for con in consumers:
            con.commit()
        first = {}
        for (p, o), (i, t) in acks.items():
            if p in b2_parts and t > t_kill:
                first[p] = min(first.get(p, t), t)
        check(len(first) == len(b2_parts), "no publish was acked to a failed-over partition")
        consumed = {}
        for p, o, k, v, _ in received:
            consumed.setdefault((p, o), (k, v))
        lost = set(acks) - set(consumed)
        check(not lost, f"{len(lost)} acked messages were never consumed: {sorted(lost)[:5]};"
                        f" high-water marks {hwm}, failed over {b2_parts}, consumed a partition"
                        f" {collections.Counter(p for p, _ in consumed)}, assignments"
                        f" {[(c.partitions, c.version) for c in consumers]}, segments of"
                        f" p{sorted(lost)[0][0] if lost else 0}: "
                        f"{[e.name for e in fa.filer.list_entries(f'/topics/default/{topic}/p{(sorted(lost)[0][0] if lost else 0):04d}', limit=1 << 31)]}")
        check(set(consumed) == committed_msgs,
              f"consumed {len(consumed)} offsets, the partitions hold {len(committed_msgs)}")
        bad = [(p, o) for (p, o), (i, _) in acks.items() if consumed[(p, o)][0] != keys[i]]
        bad += [(p, o, c) for p, o, k, v, c in received if by_key.get(k) != v]
        check(not bad, f"consumed messages not as published: {bad[:5]}")
        check(not order_breaks, f"offsets out of order within a partition: {order_breaks[:5]}")
        dup = len(received) - len(consumed)
        desc = json.loads(run_command(env, f"mq.topic.describe -topic {topic}"))
        check(desc["partition_count"] == MQ_PARTITIONS and desc["replication"] == 1
              and all(p["owner"] == b1.url for p in desc["partitions"])
              and {p["partition"]: p["high_water_mark"] for p in desc["partitions"]} == hwm,
              f"mq.topic.describe: {desc}")
        offsets = get_json(f"{b1.url}/offsets?topic={topic}&group=readers")["offsets"]
        check({int(k): v for k, v in offsets.items()} == hwm,
              f"the group's committed offsets {offsets} != the high-water marks {hwm}")
        listed = json.loads(run_command(env, "mq.topic.list"))
        check({"namespace": "default", "topic": topic} in listed, f"mq.topic.list: {listed}")
        balanced = run_command(env, "mq.balance")
        check(balanced == "already balanced", f"mq.balance: {balanced}")
        # the segments: every chunk MD5 hashlib's, the contents the committed messages
        post_json(f"{b1.url}/flush", {})
        segs, seg_bytes, in_segs = 0, 0, set()
        seg_client = Client(fa.url)
        for k in range(MQ_PARTITIONS):
            d = f"/topics/default/{topic}/p{k:04d}"
            for e in fa.filer.list_entries(d, limit=1 << 31):
                if not e.name.endswith(".log"):
                    continue
                status, body = seg_client.request("GET", e.full_path)
                check(status == 200, f"GET {e.full_path} -> {status}")
                check(e.attributes.md5 == hashlib.md5(body).hexdigest()
                      and all(ch.etag == hashlib.md5(body[ch.offset:ch.offset + ch.size])
                              .hexdigest() for ch in e.chunks),
                      f"{e.full_path}: a stored MD5 is not hashlib's")
                for line in body.decode().splitlines():
                    m = json.loads(line)
                    check((k, m["offset"]) not in in_segs, f"offset {m['offset']} of p{k} twice")
                    in_segs.add((k, m["offset"]))
                segs += 1
                seg_bytes += len(body)
        seg_client.close()
        check(in_segs == committed_msgs, f"the segments hold {len(in_segs)} messages, the group"
                                         f" consumed {len(committed_msgs)}")
        for con in consumers:
            con.close()
        for pub in pubs:
            pub.close()
        value_bytes = sum(len(v) for v in values)
        res["mq"] = dict(
            topic=topic, partitions=MQ_PARTITIONS, replication=1, publishers=MQ_PUBLISHERS,
            consumers=MQ_CONSUMERS, messages=mq_messages, acked=len(acks),
            committed_unacked=len(committed_msgs) - len(acks), redelivered=dup,
            publish_retries=retried[0], publish_wall_s=publish_wall,
            publish_msgs_per_s=len(acks) / publish_wall,
            publish_mib_per_s=value_bytes / publish_wall / MIB, publish_ack=_pcts(ack_lat),
            publish_to_consume=_pcts(got_lat),
            consume_msgs_per_s=len(received) / (t_consumed - t_pub),
            failover_ms=(min(first.values()) - t_kill) * 1e3, failed_over_partitions=b2_parts,
            segments=segs, segment_bytes=seg_bytes, committed=hwm,
            acked_at_crash=acked_at_crash, crash_after_s=t_kill - t_pub,
            tcp_sockstat={**tcp, "after": sockstat()})
        watch.close()
        launches = read_launches()
        for name in ("crc32c_batch", "md5_batch"):
            check(launches[name] > 0, f"the sync_mq phase launched no {name} kernel")
        check(all(s.failed_blobs == 0 for s in svcs), "a hash service failed a batch")
        buckets = batch_buckets(batches)
        top = sorted(buckets, key=lambda ln: -buckets[ln]["blobs"])[:8]
        res.update(launches=launches, hash_lengths=len(buckets), hash_batches=len(batches),
                   hash_buckets={ln: buckets[ln] for ln in top})
    finally:
        for svc in svcs:
            svc.__dict__.pop("_batch_hash", None)
        for stop in reversed(stops):
            stop()
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    res["hash_kernels"] = path_hash_times(dev, seed, md5_ops_per_block, batches, (FILER_CHUNK,),
                                          "sync_mq")
    res.update(wall_s=wall, wall_limit_s=SYNC_MQ_WALL_LIMIT_S,
               over_wall_limit=wall > SYNC_MQ_WALL_LIMIT_S, cuts=SYNC_MQ_CUTS,
               note="clients and servers share one process and one GIL")
    return res

# --- phase 20: security and raft HA -------------------------------------------------
HA_RACKS = ("r1", "r1", "r2")
HA_THREADS = 8  # filer clients, each waiting for its answer; and assign threads
HA_FILE = 4096
HA_LARGE = 8  # large files, one a thread
HA_EC_VID = 901  # past the ids the masters grow
HA_EC_COLLECTION = "ha"
HA_WRITERS = 4  # threads POSTing the EC volume's needles
HA_DEGRADED = 64  # needles read back while a data shard is gone
HA_ASSIGN_BEFORE_S = 1.5  # assigns before the leader stops
HA_ASSIGN_AFTER_S = 1.5  # and after the new leader's first answer
HA_FAILOVER_LIMIT_S = 15.0
HA_COMPACT = 8  # each master's raft log compacts past this many applied entries
HA_CN = "seaweedfs-node"  # the common name the allow-list admits
HA_INTRUDER = "intruder"  # signed by the same CA, not admitted
HA_WALL_LIMIT_S = 90
HA_CUTS = ("(a) --ha-files (1,024; 2,048 until the qos_telemetry phase took room in the"
           " run) 4 KiB files and 8 x --ha-large-mib (64) MiB through the filer: the filer"
           " phase's shapes", "(b) --ha-ec-mib (256) MiB"
           " in one volume of the 30 GB limit", "each master's raft log compacts past 8"
           " applied entries (256 by default) so that (e) crosses a compaction")


def free_ports(n: int) -> list[int]:
    """n ports the kernel calls free now (bound together, then closed): the
    masters' `-peers` list is known before they start."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
        return [sk.getsockname()[1] for sk in socks]
    finally:
        for sk in socks:
            sk.close()


def _pki_cryptography(d: str) -> tuple[dict, str]:
    import datetime

    import cryptography
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    now = datetime.datetime.now(datetime.timezone.utc)

    def cert(cn: str, key, issuer, issuer_key, ca: bool):
        b = (x509.CertificateBuilder()
             .subject_name(x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)]))
             .issuer_name(issuer).public_key(key.public_key())
             .serial_number(x509.random_serial_number())
             .not_valid_before(now - datetime.timedelta(minutes=5))
             .not_valid_after(now + datetime.timedelta(days=1)))
        if ca:
            b = b.add_extension(x509.BasicConstraints(ca=True, path_length=None), critical=True)
        return b.sign(issuer_key, hashes.SHA256())

    def write(name: str, data: bytes) -> str:
        path = os.path.join(d, name)
        with open(path, "wb") as f:
            f.write(data)
        return path

    ca_key = ec.generate_private_key(ec.SECP256R1())
    ca_name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "chip-smoke-ca")])
    ca = cert("chip-smoke-ca", ca_key, ca_name, ca_key, True)
    out = {"ca": write("ca.pem", ca.public_bytes(serialization.Encoding.PEM))}
    for role, cn in (("node", HA_CN), ("evil", HA_INTRUDER)):
        key = ec.generate_private_key(ec.SECP256R1())
        out[role] = (
            write(f"{cn}.pem", cert(cn, key, ca_name, ca_key, False)
                  .public_bytes(serialization.Encoding.PEM)),
            write(f"{cn}.key", key.private_bytes(serialization.Encoding.PEM,
                                                 serialization.PrivateFormat.PKCS8,
                                                 serialization.NoEncryption())))
    return out, f"cryptography {cryptography.__version__}"


def _pki_openssl(d: str, openssl: str) -> tuple[dict, str]:
    def run(*args: str) -> str:
        return subprocess.run([openssl, *args], cwd=d, check=True, capture_output=True,
                              text=True, timeout=60).stdout

    run("ecparam", "-name", "prime256v1", "-genkey", "-noout", "-out", "ca.key")
    run("req", "-x509", "-new", "-key", "ca.key", "-subj", "/CN=chip-smoke-ca", "-days", "1",
        "-addext", "basicConstraints=critical,CA:TRUE", "-out", "ca.pem")
    out = {"ca": os.path.join(d, "ca.pem")}
    for role, cn in (("node", HA_CN), ("evil", HA_INTRUDER)):
        run("ecparam", "-name", "prime256v1", "-genkey", "-noout", "-out", f"{cn}.key")
        run("req", "-new", "-key", f"{cn}.key", "-subj", f"/CN={cn}", "-out", f"{cn}.csr")
        run("x509", "-req", "-in", f"{cn}.csr", "-CA", "ca.pem", "-CAkey", "ca.key",
            "-set_serial", str(int.from_bytes(os.urandom(8), "big")), "-days", "1",
            "-out", f"{cn}.pem")
        out[role] = (os.path.join(d, f"{cn}.pem"), os.path.join(d, f"{cn}.key"))
    return out, run("version").strip()


def make_pki(d: str) -> tuple[dict | None, str]:
    """A throw-away PKI in `d`: a CA, a certificate for HA_CN and one for
    HA_INTRUDER, EC P-256, valid for a day, made by the host's
    `cryptography` package, else its `openssl` binary; (None, why) when it
    has neither."""
    os.makedirs(d, exist_ok=True)
    try:
        return _pki_cryptography(d)
    except ImportError:
        pass
    openssl = shutil.which("openssl")
    if openssl is None:
        return None, "neither the cryptography package nor an openssl binary"
    return _pki_openssl(d, openssl)


def _ctx(pki: dict, role: str | None) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(pki["ca"])
    ctx.check_hostname = False
    if role is not None:
        ctx.load_cert_chain(*pki[role])
    return ctx


def _urlopen_status(url: str, ctx=None) -> int | str:
    """The status a urllib GET gets, or the name of what it raised."""
    try:
        with urllib.request.urlopen(url, context=ctx, timeout=10) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code
    except (OSError, http.client.HTTPException) as e:
        return type(e).__name__


def wait_leader(masters: list, timeout: float = HA_FAILOVER_LIMIT_S):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        leaders = [m for m in masters if m.raft.is_leader()]
        if len(leaders) == 1:
            return leaders[0]
        time.sleep(0.002)
    raise AssertionError(f"no single raft leader among {[m.url for m in masters]}")


def secure_ha_phase(dev: torch.device, n_files: int, large_bytes: int, ec_bytes: int,
                    md5_ops_per_block: int, seed: int) -> dict:
    """Security and raft HA as upstream's docs lay them out
    (`docker/compose/local-cluster-compose.yml`: three masters under raft
    with `-peers`; the `security.toml` of `weed scaffold -config=security`:
    `[jwt.signing]`, `[jwt.signing.read]`, `[guard] white_list` and `[tls]`
    with `allowed_commonNames`), in one process: three port masters with
    their own raft directories, three volume servers (racks r1, r1, r2)
    given all three and a FilerServer (4 MiB chunks), on the card, all on
    one SecurityConfig (a write key, a read key, white list 127.0.0.1) with
    mTLS configured process-wide from a PKI made now (the host's
    cryptography package, else openssl). (a) `n_files` 4 KiB files and 8 of
    `large_bytes` PUT through the filer over https from 8 waiting threads
    and read back (the filer signs its own write and read tokens); md5_batch
    and crc32c_batch launch. (b) `ec_bytes` of log-uniform needles in one
    volume with signed POSTs, `ec.encode` through the leader (gf256_matmul),
    a data shard deleted and needles on it read degraded with read tokens.
    (c) the leader stopped while 8 threads call /dir/assign: the time until
    a survivor leads and until it answers an assign, assign p50/p99 before
    and after, no fid handed out twice, every volume server's heartbeat on
    the new leader. (d) a second data shard deleted, `ec.rebuild` through
    the new leader, both shards equal to the lost ones, every needle read
    back byte for byte. (e) `cluster.raft.ps`, `cluster.raft.remove` of the
    dead master, `cluster.raft.add` of a fresh fourth, which catches up by
    InstallSnapshot (the log was compacted). (f) unsigned POST and DELETE,
    a wrong-key read and a token-less /query answer 401; the intruder's
    certificate is refused by the CN gate (403) and a client without one
    fails the handshake; a plain-http client gets no answer; every url is
    https. TLS is reset on the way out, pass or fail."""
    t_phase = time.perf_counter()
    (REPO / "build").mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke-secure_ha-", dir=REPO / "build")
    stops, batches, res = [], [], {}
    try:
        pki, pki_source = make_pki(os.path.join(root, "pki"))
        check(pki is not None, f"secure_ha: no PKI ({pki_source}): the phase never runs without TLS")
        tls.configure(TLSConfig(ca=pki["ca"], cert=pki["node"][0], key=pki["node"][1],
                                allowed_common_names=HA_CN))
        rng = np.random.default_rng([seed, 31])
        sec = SecurityConfig(write_key=rng.bytes(16).hex(), read_key=rng.bytes(16).hex(),
                             white_list=["127.0.0.1"])
        peers = [f"https://127.0.0.1:{p}" for p in free_ports(3)]
        masters, accepted = [], []
        t0 = time.perf_counter()
        for i, url in enumerate(peers):
            m = MasterServer(port=int(url.rsplit(":", 1)[1]), pulse_seconds=1, security=sec,
                             peers=peers, raft_dir=os.path.join(root, f"raft{i}"))
            m.start()
            stops.append(m.stop)
            masters.append(m)
            accepted.append(record_accepts(m.service))
            m.raft.compact_threshold = HA_COMPACT
            check(m.url == url and m.raft is not None, f"master {i} at {m.url}, raft {m.raft}")
        leader = wait_leader(masters)
        election_ms = (time.perf_counter() - t0) * 1e3
        servers = []
        for i, rack in enumerate(HA_RACKS):
            vs = VolumeServer([os.path.join(root, f"v{i}")], ",".join(peers), rack=rack,
                              pulse_seconds=PULSE_S, device=dev, security=sec)
            vs.start()
            stops.append(vs.stop)
            servers.append(vs)
        deadline = time.perf_counter() + HA_FAILOVER_LIMIT_S
        while True:  # every server's beat on the leader (an early term may still turn over)
            for vs in servers:
                vs.heartbeat_once()
            leader = wait_leader(masters)
            if all(vs.master_url == leader.url for vs in servers):
                break
            check(time.perf_counter() < deadline,
                  f"heartbeats on {[vs.master_url for vs in servers]}, not {leader.url}")
        filer = FilerServer(",".join(peers), port=0, device=dev, security=sec)
        filer.start()
        stops.append(filer.stop)
        svc = filer.hash_service
        check(svc.device.type == "cuda" and all(vs.device.type == "cuda" for vs in servers),
              "a secure_ha role is not on cuda")
        timed_batches(svc, batches)
        stops.append(lambda: svc.__dict__.pop("_batch_hash", None))
        urls = [m.url for m in masters] + [vs.url for vs in servers] + [filer.url]
        check(all(u.startswith("https://") for u in urls), f"a plain url: {urls}")
        by_url = {vs.url.split("//", 1)[1]: vs for vs in servers}
        errors = []

        steps = {"setup": time.perf_counter() - t_phase}  # seconds of each step

        def step(name: str) -> None:
            steps[name] = time.perf_counter() - t_phase - sum(steps.values())

        # (a) the filer over mTLS and JWT
        small = np.random.default_rng([seed, 32]).bytes(n_files * HA_FILE)
        large = [np.random.default_rng([seed, 33, k]).bytes(large_bytes) for k in range(HA_LARGE)]
        zero_launches()
        put_lat = [[] for _ in range(HA_THREADS)]

        def put_small(t: int) -> None:
            c = Client(filer.url)
            try:
                for i in range(t, n_files, HA_THREADS):
                    data = small[i * HA_FILE : (i + 1) * HA_FILE]
                    t0 = time.perf_counter()
                    status, out = c.request("PUT", f"/ha/small/{i:05d}", data, OCTET)
                    put_lat[t].append(time.perf_counter() - t0)
                    if status != 201 or json.loads(out)["md5"] != hashlib.md5(data).hexdigest():
                        errors.append(f"PUT /ha/small/{i:05d} -> {status}: {out[:200]!r}")
                        return
            except BaseException as e:  # re-raised on the main thread
                errors.append(repr(e))
            finally:
                c.close()

        def put_large(k: int) -> None:
            c = Client(filer.url)
            try:
                status, out = c.request("PUT", f"/ha/large/{k}", large[k], OCTET)
                if status != 201 or json.loads(out)["md5"] != hashlib.md5(large[k]).hexdigest():
                    errors.append(f"PUT /ha/large/{k} -> {status}: {out[:200]!r}")
            except BaseException as e:
                errors.append(repr(e))
            finally:
                c.close()

        terms_a = [m.raft.status()["term"] for m in masters]
        small_s = run_threads(put_small, HA_THREADS)
        check(not errors, f"secure_ha (a) small PUTs: {errors[:3]}; raft terms at (a)'s start"
                          f" {terms_a}, now {[m.raft.status() for m in masters]}; the"
                          f" collector's pauses since the phase began {GC_PAUSES.take(reset=False)}")
        large_s = run_threads(put_large, HA_LARGE)
        check(not errors, f"secure_ha (a) large PUTs: {errors[:3]}")
        launches_a = read_launches()
        for name in ("crc32c_batch", "md5_batch"):
            check(launches_a[name] > 0, f"the secure filer path launched no {name} kernel")
        check(svc.failed_blobs == 0 and svc.host_blobs == 0, "the hash service failed a batch")

        def get_back(t: int) -> None:
            c = Client(filer.url)
            try:
                for i in range(t, n_files, HA_THREADS):
                    status, got = c.request("GET", f"/ha/small/{i:05d}")
                    if status != 200 or got != small[i * HA_FILE : (i + 1) * HA_FILE]:
                        errors.append(f"GET /ha/small/{i:05d} -> {status}")
                        return
                if t < HA_LARGE:
                    status, got = c.request("GET", f"/ha/large/{t}")
                    if status != 200 or got != large[t]:
                        errors.append(f"GET /ha/large/{t} -> {status}, {len(got)} bytes")
            except BaseException as e:
                errors.append(repr(e))
            finally:
                c.close()

        get_s = run_threads(get_back, HA_THREADS)
        check(not errors, f"secure_ha (a) GETs: {errors[:3]}")
        small_lat = [x for lat in put_lat for x in lat]
        res["filer"] = dict(
            files=n_files, file_bytes=HA_FILE, threads=HA_THREADS, small_s=small_s,
            files_per_s=n_files / small_s, **{f"put_{k}": v for k, v in _pcts(small_lat).items()},
            large_files=HA_LARGE, large_bytes=large_bytes, large_wall_s=large_s,
            large_gbps=HA_LARGE * large_bytes / large_s / 1e9, get_all_s=get_s,
            get_gbps=(len(small) + HA_LARGE * large_bytes) / get_s / 1e9, launches=launches_a,
            batch_blobs=svc.batch_blobs)
        del small, large

        step("a_filer")

        # (b) one volume of signed POSTs, ec.encode through the leader, degraded GETs
        s0 = servers[0]
        post_json(f"{s0.url}/admin/allocate_volume",
                  {"volume": HA_EC_VID, "collection": HA_EC_COLLECTION, "replication": "000"})
        plan, pool = online_plan(ec_bytes, seed, vid=HA_EC_VID)

        def signed(fid: str, key: str, gen) -> dict:
            return {"Authorization": f"BEARER {gen(key, fid)}"}

        def write_ec(t: int) -> None:
            c = Client(s0.url)
            try:
                for fid, _, off, size in plan[t::HA_WRITERS]:
                    status, out = c.request("POST", f"/{fid}", pool[off : off + size],
                                            {**OCTET, **signed(fid, sec.write_key, gen_write_jwt)})
                    if status != 201:
                        errors.append(f"signed POST {fid} -> {status}: {out[:200]!r}")
                        return
            except BaseException as e:
                errors.append(repr(e))
            finally:
                c.close()

        write_s = run_threads(write_ec, HA_WRITERS)
        check(not errors, f"secure_ha (b) signed POSTs: {errors[:3]}")
        v = s0.store.get_volume(HA_EC_VID)
        dat_size = v.size()
        places = {fid: v.nm.get(nid) for fid, nid, _, _ in plan}
        for vs in servers:
            vs.heartbeat_once()
        env = CommandEnv(leader.url)
        check(run_command(env, "lock") == "lock acquired", "lock through the leader")
        n0 = gf256_matmul.launches
        t0 = time.perf_counter()
        out = run_command(env, f"ec.encode -volumeId {HA_EC_VID} -collection {HA_EC_COLLECTION}")
        encode_s = time.perf_counter() - t0
        encode_launches = gf256_matmul.launches - n0
        check("shards spread" in out, f"ec.encode: {out[:300]}")
        check(encode_launches > 0, "ec.encode launched no gf256_matmul kernel")

        def placement() -> dict:
            return {sv.url: sorted(sv.ec_shards.get(HA_EC_VID, [])) for sv in env.servers()}

        def shard_path(url: str, shard: int) -> str:
            d = by_url[url].store.locations[0].directory
            return os.path.join(d, f"{HA_EC_COLLECTION}_{HA_EC_VID}{geometry.to_ext(shard)}")

        held = placement()
        check(sorted(s for x in held.values() for s in x) == list(range(14)),
              f"ec.encode mounted {held}")
        s0_addr = s0.url.split("//", 1)[1]
        # two data shards off the reader, one lost now and one in (d)
        lose = [(u, s) for u, shards in held.items() if u != s0_addr for s in shards if s < 10][:2]
        check(len(lose) == 2, f"no two data shards off {s0_addr}: {held}")
        lost_dir = os.path.join(root, "lost")
        os.mkdir(lost_dir)

        def drop(url: str, shard: int) -> None:
            shutil.copyfile(shard_path(url, shard), os.path.join(lost_dir, f"{shard}"))
            out = env.post(f"{peer_url(url)}/admin/ec/delete_shards",
                           {"volume": HA_EC_VID, "collection": HA_EC_COLLECTION,
                            "shards": [shard], "delete_index": False})
            check(out["removed"] == [shard], f"delete_shards {shard}: {out}")

        drop(*lose[0])
        shard_size = geometry.shard_file_size(dat_size, geometry.LARGE_BLOCK_SIZE,
                                              geometry.SMALL_BLOCK_SIZE)
        on_lost = []
        for fid, _, off, size in plan:
            noff, nsize = places[fid]
            ivs = geometry.locate_data(geometry.LARGE_BLOCK_SIZE, geometry.SMALL_BLOCK_SIZE,
                                       10 * shard_size, noff, get_actual_size(nsize, 3))
            if any(iv.to_shard_id_and_offset(geometry.LARGE_BLOCK_SIZE,
                                             geometry.SMALL_BLOCK_SIZE)[0] == lose[0][1]
                   for iv in ivs):
                on_lost.append((fid, off, size))
        check(on_lost, f"no needle on data shard {lose[0][1]}")
        c = Client(s0.url)
        degraded_lat = []
        n0 = gf256_matmul.launches
        try:
            for fid, off, size in on_lost[:HA_DEGRADED]:
                t0 = time.perf_counter()
                status, got = c.request("GET", f"/{fid}",
                                        headers=signed(fid, sec.read_key, gen_read_jwt))
                degraded_lat.append(time.perf_counter() - t0)
                check(status == 200 and got == pool[off : off + size], f"degraded GET {fid}")
        finally:
            c.close()
        degraded_launches = gf256_matmul.launches - n0
        check(degraded_launches > 0, "the degraded GETs launched no gf256_matmul kernel")
        res["ec"] = dict(
            volume_bytes=dat_size, needles=len(plan), write_s=write_s,
            write_gbps=ec_bytes / write_s / 1e9, encode_s=encode_s,
            encode_gbps=dat_size / encode_s / 1e9, encode_launches=encode_launches,
            lost_shard=lose[0][1], degraded_gets=len(degraded_lat),
            **{f"degraded_{k}": v for k, v in _pcts(degraded_lat).items()},
            degraded_launches=degraded_launches)

        step("b_ec_encode_degraded")

        # (c) the leader stops while 8 threads assign
        events = [[] for _ in range(HA_THREADS)]  # (end, seconds, fid, the master that answered)
        refused = [0] * HA_THREADS
        last_refusal = [""]
        stop_assign = threading.Event()

        def assigner(t: int) -> None:
            wc = WeedClient(",".join(peers))
            try:
                while not stop_assign.is_set():
                    t0 = time.perf_counter()
                    try:
                        a = wc.assign()
                    except (OSError, ValueError) as e:  # no leader, or no topology yet
                        refused[t] += 1
                        last_refusal[0] = repr(e)[:300]
                        time.sleep(0.01)
                        continue
                    t1 = time.perf_counter()
                    events[t].append((t1, t1 - t0, a["fid"], wc.master_url))
            except BaseException as e:
                errors.append(repr(e))
            finally:
                wc.close()

        timeline = []  # (ms from the stop, each server's master, each master's raft role)
        t_stop = None

        def watch_roles() -> None:
            last = None
            while not stop_assign.is_set():
                now = (tuple(peers.index(vs.master_url) if vs.master_url in peers else -1
                             for vs in servers),
                       tuple(m.raft.role[0] for m in masters))
                if now != last and t_stop is not None:
                    timeline.append(((time.perf_counter() - t_stop) * 1e3, *now))
                    last = now
                time.sleep(0.002)

        threads = [threading.Thread(target=assigner, args=(t,)) for t in range(HA_THREADS)]
        threads.append(threading.Thread(target=watch_roles))
        for th in threads:
            th.start()
        try:
            time.sleep(HA_ASSIGN_BEFORE_S)
            old = leader
            t_stop = time.perf_counter()
            # a crash as its process would see one: its raft sends nothing
            # more, and its kept-alive connections are reset
            old.raft.rpc = _Refused().request
            old.stop()
            reset_all(accepted[masters.index(old)])
            stop_wall = time.perf_counter() - t_stop
            survivors = [m for m in masters if m is not old]
            leader = wait_leader(survivors)
            t_elected = time.perf_counter()

            def first_answer() -> float | None:
                done = [e[0] for ev in events for e in ev if e[3] == leader.url and e[0] > t_stop]
                return min(done) if done else None

            deadline = t_stop + HA_FAILOVER_LIMIT_S
            while first_answer() is None:
                check(time.perf_counter() < deadline and not errors,
                      f"no assign answered by the new leader {leader.url}: {errors[:3]}"
                      f" (last refusal: {last_refusal[0]})")
                time.sleep(0.002)
            t_first = first_answer()
            time.sleep(HA_ASSIGN_AFTER_S)
            deadline = time.perf_counter() + HA_FAILOVER_LIMIT_S
            while not all(vs.master_url == leader.url for vs in servers):
                check(time.perf_counter() < deadline,
                      f"heartbeats on {[vs.master_url for vs in servers]}, not {leader.url};"
                      f" timeline {timeline[:40]}")
                time.sleep(0.01)
        finally:
            stop_assign.set()
            for th in threads:
                th.join()
        check(not errors, f"secure_ha (c) assigns: {errors[:3]}")
        all_events = [e for ev in events for e in ev]
        fids = [e[2] for e in all_events]
        keys = [f.split(",")[1][:-8] for f in fids]
        check(len(set(fids)) == len(fids) and len(set(keys)) == len(keys),
              f"a fid handed out twice across the failover ({len(fids) - len(set(keys))})")
        before = [e[1] for e in all_events if e[0] < t_stop]
        after = [e[1] for e in all_events if e[0] > t_first and e[3] == leader.url]
        check(before and after, "no assign before or after the failover")
        # the first moment every server's heartbeat went to the new leader
        on_new = tuple([masters.index(leader)] * len(servers))
        beats_ms = next(t for t, targets, _ in timeline if targets == on_new)
        res["failover"] = dict(
            masters=3, old_leader=masters.index(old), new_leader=masters.index(leader),
            election_ms_at_start=election_ms, stop_call_ms=stop_wall * 1e3,
            new_leader_ms=(t_elected - t_stop) * 1e3, first_assign_ms=(t_first - t_stop) * 1e3,
            heartbeats_on_new_leader_ms=beats_ms, assigns=len(fids),
            unique_fids=len(set(fids)), refused_calls=sum(refused),
            last_refusal=last_refusal[0],
            assign_before=_pcts(before), assign_after=_pcts(after),
            assigns_before=len(before), assigns_after=len(after), threads=HA_THREADS,
            timeline=timeline[:40])

        step("c_failover")

        # (d) a second data shard lost, ec.rebuild through the new leader
        for vs in servers:
            vs.heartbeat_once()
        drop(*lose[1])
        env = CommandEnv(leader.url)
        check(run_command(env, "lock") == "lock acquired", "lock through the new leader")
        n0 = gf256_matmul.launches
        t0 = time.perf_counter()
        out = run_command(env, f"ec.rebuild -volumeId {HA_EC_VID} -collection {HA_EC_COLLECTION}")
        rebuild_s = time.perf_counter() - t0
        rebuild_launches = gf256_matmul.launches - n0
        lost = sorted(s for _, s in lose)
        check(f"rebuilt shards {lost}" in out, f"ec.rebuild: {out}")
        check(rebuild_launches > 0, "ec.rebuild launched no gf256_matmul kernel")
        held = placement()
        check(sorted(s for x in held.values() for s in x) == list(range(14)),
              f"ec.rebuild mounted {held}")
        for s in lost:
            (url,) = [u for u, x in held.items() if s in x]
            check(same_file(shard_path(url, s), os.path.join(lost_dir, f"{s}")),
                  f"rebuilt shard {s} differs from the lost one")
        def read_back(t: int) -> None:
            c = Client(s0.url)
            try:
                for fid, _, off, size in plan[t::HA_WRITERS]:
                    status, got = c.request("GET", f"/{fid}",
                                            headers=signed(fid, sec.read_key, gen_read_jwt))
                    if status != 200 or got != pool[off : off + size]:
                        errors.append(f"GET {fid} after rebuild -> {status}")
                        return
            except BaseException as e:
                errors.append(repr(e))
            finally:
                c.close()

        run_threads(read_back, HA_WRITERS)
        check(not errors, f"secure_ha (d) read-back: {errors[:3]}")
        res["ec"].update(rebuild_s=rebuild_s, rebuilt=lost, rebuild_line=out.splitlines()[-1],
                         rebuild_gbps=10 * shard_size / rebuild_s / 1e9,
                         rebuild_launches=rebuild_launches, read_back=len(plan))

        step("d_rebuild_read_back")

        # (e) cluster.raft.ps, remove the dead master, add a fresh fourth
        ps = run_command(env, "cluster.raft.ps").splitlines()
        check(ps[0].startswith(f"{leader.url}  role=leader")
              and any(ln.startswith(f"{old.url}  unreachable") for ln in ps),
              f"raft.ps: {ps}; the collector's pauses since the phase began"
              f" {GC_PAUSES.take(reset=False)}")
        out = run_command(env, f"cluster.raft.remove -address {old.url}")
        check(old.url not in out.split("members: ", 1)[1], f"cluster.raft.remove: {out}")
        with leader.raft.mu:
            snap_at_add = leader.raft.snap_index
        check(snap_at_add > 0, f"the leader's log never compacted ({HA_COMPACT} entries)")
        (port4,) = free_ports(1)
        url4 = f"https://127.0.0.1:{port4}"
        fourth = MasterServer(port=port4, pulse_seconds=1, security=sec,
                              peers=[m.url for m in survivors] + [url4],
                              raft_dir=os.path.join(root, "raft3"))
        t0 = time.perf_counter()
        fourth.start()
        stops.append(fourth.stop)
        out = run_command(env, f"cluster.raft.add -address {url4}")
        check(url4 in out.split("members: ", 1)[1], f"cluster.raft.add: {out}")
        deadline = time.perf_counter() + HA_FAILOVER_LIMIT_S
        while not (fourth.raft.leader() == leader.url
                   and fourth._seq_ceiling == leader._seq_ceiling
                   and fourth.topo._max_volume_id == leader.topo._max_volume_id):
            check(time.perf_counter() < deadline, "the fourth master never caught up")
            time.sleep(0.005)
        catch_up_ms = (time.perf_counter() - t0) * 1e3
        with fourth.raft.mu:
            check(fourth.raft.snap_index >= snap_at_add and fourth.raft.snap_state is not None,
                  "the fourth master caught up without InstallSnapshot")
        ps_after = run_command(env, "cluster.raft.ps").splitlines()
        check(any(ln.startswith(f"{url4}  role=follower") for ln in ps_after),
              f"raft.ps after the add: {ps_after}")
        res["raft"] = dict(ps=len(ps), removed=masters.index(old), snapshot_index=snap_at_add,
                           compact_threshold=HA_COMPACT, fourth_catch_up_ms=catch_up_ms,
                           fourth_installed_snapshot=True, members_after=len(ps_after),
                           max_volume_id=leader.topo._max_volume_id,
                           seq_ceiling=leader._seq_ceiling)

        step("e_raft_membership")

        # (f) what must be refused
        a = get_json(f"{leader.url}/dir/assign")
        check(bool(a.get("auth")), "the leader handed out no write token")
        target = f"{peer_url(a['url'])}/{a['fid']}"
        fid0 = plan[0][0]
        refusals = {
            "unsigned_post": http_request("POST", target, b"x", OCTET)[0],
            "unsigned_delete": http_request("DELETE", f"{s0.url}/{fid0}")[0],
            "wrong_key_read": http_request("GET", f"{s0.url}/{fid0}",
                                           headers=signed(fid0, "not-the-key", gen_read_jwt))[0],
            "query_without_token": http_request(
                "POST", f"{s0.url}/query", json.dumps({"fid": fid0}).encode(),
                {"Content-Type": "application/json"})[0],
            "intruder_certificate": _urlopen_status(f"{s0.url}/status", _ctx(pki, "evil")),
            "no_client_certificate": _urlopen_status(f"{leader.url}/cluster/status",
                                                     _ctx(pki, None)),
            "plain_http": _urlopen_status(filer.url.replace("https://", "http://") + "/"),
            "node_certificate": _urlopen_status(f"{s0.url}/status", _ctx(pki, "node")),
        }
        check(refusals["unsigned_post"] == refusals["unsigned_delete"] == 401
              and refusals["wrong_key_read"] == refusals["query_without_token"] == 401
              and refusals["intruder_certificate"] == 403
              and isinstance(refusals["no_client_certificate"], str)
              and isinstance(refusals["plain_http"], str)
              and refusals["node_certificate"] == 200, f"refusals: {refusals}")
        urls += [fourth.url]
        check(all(u.startswith("https://") for u in urls), f"a plain url: {urls}")
        step("f_refusals")
        res.update(refusals=refusals, https_urls=len(urls), pki=pki_source, steps_s=steps,
                   tls_allowed_common_names=HA_CN, white_list=sec.white_list)
        launches = read_launches()
        for name in ("crc32c_batch", "md5_batch", "gf256_matmul"):
            check(launches[name] > 0, f"the secure_ha phase launched no {name} kernel")
        res["launches"] = launches
    finally:
        for stop in reversed(stops):
            stop()
        tls.reset()  # nothing after this phase runs under TLS
        shutil.rmtree(root, ignore_errors=True)
    check(tls.client_context() is None and tls.server_context() is None, "TLS left on")
    wall = time.perf_counter() - t_phase
    res["hash_kernels"] = path_hash_times(dev, seed, md5_ops_per_block, batches,
                                          (HA_FILE, FILER_CHUNK), "secure_ha")
    res.update(wall_s=wall, wall_limit_s=HA_WALL_LIMIT_S, over_wall_limit=wall > HA_WALL_LIMIT_S,
               cuts=HA_CUTS, note="clients and servers share one process and one GIL")
    return res


# --- phase 22: the stats core and the debug plane -----------------------------------
OBS_RACKS = ("r1", "r2", "r3", "r4")
OBS_THREADS = 8  # filer clients, each waiting for its answer
OBS_SMALL = 4096
OBS_LARGE = 4 * MIB
OBS_EC_VID = 951  # past the ids the master grows
OBS_EC_NEEDLE = MIB  # the EC volume's needles, POSTed to one server
OBS_EC_WRITERS = 4
OBS_LOST = (2, 7)  # the data shards deleted before the degraded reads
OBS_DEGRADED = 64
OBS_DEVICE_S = 2.0  # the device trace's window, during the 4 MiB PUTs
OBS_PROFILE_S = 1.0  # cluster.profile's window
# the event types `cluster.why <vid>` lists for the EC sequence (allocate,
# POSTs, ec.encode, two data shards deleted, degraded GETs, ec.rebuild
# -mode classic), as tests/test_torch_observe.py establishes on the CPU for
# both packages
OBS_WHY_EVENTS = ("degraded_read", "remount_swap", "volume_state")
OBS_ROLES = ("filer", "master", "volume")
OBS_KERNEL_NAMES = ("gf256_matmul", "md5_batch", "crc32c_batch", "gear_hash")
OBS_WALL_LIMIT_S = 45
OBS_CUTS = ("(a) --obs-files (1,024) 4 KiB files and --obs-large (16) 4 MiB files through"
            " one filer from 8 waiting threads, beside the filer phase's 1,024 from 16; (b)"
            " --obs-ec-mib (256) MiB in one volume of the 30 GB volume limit; every role"
            " in one process, so they share one registry, trace ring and journal")


def metric_value(text: str, family: str, **labels) -> float:
    """The sum of a family's samples whose labels include `labels`."""
    return sum(v for name, lb, v in parse_exposition(text)
               if name == family and all(lb.get(k) == w for k, w in labels.items()))


def observe_ec_sequence(env: CommandEnv, servers: list, vid: int, nbytes: int,
                        seed: int) -> dict:
    """The EC half of the observe phase, on a cluster of four volume servers:
    `vid` allocated on servers[0], `nbytes` of seeded 1 MiB needles POSTed to
    it from 4 threads, `ec.encode -volumeId vid`, data shards OBS_LOST deleted
    from their holders, OBS_DEGRADED GETs of needles with an interval on a
    lost shard (every body equal), then `ec.rebuild -mode classic`. Returns
    the encode and rebuild outputs, the GET latencies and the needles."""
    s0 = servers[0]
    Client(s0.url).json("/admin/allocate_volume", {"volume": vid})
    rng = np.random.default_rng([seed, 41])
    n = max(1, nbytes // OBS_EC_NEEDLE)
    pool = memoryview(rng.bytes(n * OBS_EC_NEEDLE))
    cookie = 0x0B5E7A11
    fids = [f"{vid},{i + 1:x}{cookie:08x}" for i in range(n)]
    errors = []

    def post(t: int) -> None:
        c = Client(s0.url)
        try:
            for i in range(t, n, OBS_EC_WRITERS):
                status, out = c.request("POST", f"/{fids[i]}",
                                        pool[i * OBS_EC_NEEDLE : (i + 1) * OBS_EC_NEEDLE], OCTET)
                if status != 201:
                    errors.append(f"POST {fids[i]} -> {status}: {out[:200]!r}")
                    return
        finally:
            c.close()

    ingest_s = run_threads(post, OBS_EC_WRITERS)
    check(not errors, f"observe ingest: {errors[:3]}")
    s0.heartbeat_once()
    v = s0.store.get_volume(vid)
    spots = {i: v.nm.get(i + 1) for i in range(n)}  # needle -> (.dat offset, size)
    dat_size = v.size()
    check(run_command(env, "lock") == "lock acquired", "lock")
    t0 = time.perf_counter()
    enc = run_command(env, f"ec.encode -volumeId {vid}")
    encode_s = time.perf_counter() - t0
    check("shards spread" in enc, f"ec.encode: {enc[-300:]}")
    held = {sv.url: sorted(sv.ec_shards.get(vid, [])) for sv in env.servers()}
    for url, shards in held.items():
        drop = [s for s in shards if s in OBS_LOST]
        if drop:
            out = env.post(f"http://{url}/admin/ec/delete_shards",
                           {"volume": vid, "shards": drop, "delete_index": False})
            check(sorted(out["removed"]) == drop, f"delete_shards {vid}: {out}")
    shard_size = geometry.shard_file_size(dat_size, geometry.LARGE_BLOCK_SIZE,
                                          geometry.SMALL_BLOCK_SIZE)
    on_lost = []
    for i, (noff, nsize) in spots.items():
        ivs = geometry.locate_data(geometry.LARGE_BLOCK_SIZE, geometry.SMALL_BLOCK_SIZE,
                                   10 * shard_size, noff, get_actual_size(nsize, 3))
        if any(iv.to_shard_id_and_offset(geometry.LARGE_BLOCK_SIZE,
                                         geometry.SMALL_BLOCK_SIZE)[0] in OBS_LOST
               for iv in ivs):
            on_lost.append(i)
    pick = rng.choice(len(on_lost), size=min(OBS_DEGRADED, len(on_lost)), replace=False)
    urls = sorted(u for u, shards in held.items() if shards)
    clients = {u: Client(f"http://{u}") for u in urls}
    degraded_lat = []
    try:
        for j, k in enumerate(pick):
            i = on_lost[int(k)]
            t0 = time.perf_counter()
            status, got = clients[urls[j % len(urls)]].request("GET", f"/{fids[i]}")
            degraded_lat.append(time.perf_counter() - t0)
            check(status == 200 and got == pool[i * OBS_EC_NEEDLE : (i + 1) * OBS_EC_NEEDLE],
                  f"degraded GET {fids[i]} -> {status}")
    finally:
        for c in clients.values():
            c.close()
    t0 = time.perf_counter()
    reb = run_command(env, f"ec.rebuild -volumeId {vid} -mode classic")
    rebuild_s = time.perf_counter() - t0
    check(f"rebuilt shards {list(OBS_LOST)}" in reb and "(classic)" in reb,
          f"ec.rebuild {vid}: {reb}")
    check(run_command(env, "unlock") == "lock released", "unlock")
    return dict(ingest_s=ingest_s, needles=n, dat_bytes=dat_size, encode_s=encode_s,
                rebuild_s=rebuild_s, degraded_gets=len(degraded_lat),
                **{f"degraded_{k}": v for k, v in _pcts(degraded_lat).items()},
                encode_out=enc, rebuild_out=reb)


def why_event_types(out: str) -> list:
    """The event types of `cluster.why` rows (spans excluded)."""
    types = set()
    for line in out.splitlines()[1:]:
        body = line.split("s  ", 1)[-1]
        if body and not body.startswith("span "):
            types.add(body.split()[0])
    return sorted(types)


def observe_phase(dev: torch.device, n_files: int, n_large: int, ec_bytes: int,
                  seed: int) -> dict:
    """The stats core and the debug plane on a loaded cluster: a port master
    (pulse 1 s, maintenance off), four volume servers and a filer with its
    metrics port, every role metered as constructed. (a) n_files seeded
    4 KiB and n_large 4 MiB files through the filer from 8 waiting threads,
    the 4 MiB PUTs going on until (c) returns; (b) observe_ec_sequence over
    ec_bytes; (c) during the 4 MiB PUTs, `GET /debug/pprof/device` on the
    filer's metrics port. Checks: (1) the
    filer's `SeaweedFS_filer_hash_seconds{kernel="batch-cuda"}` observations
    grew by its hash service's batches over (a); (2) the EC encode and
    decode histograms grew by the one encode and the one rebuild of (b);
    (3) the last PUT's X-Sw-Trace-Id names a `cluster.trace` tree with the
    filer, master and volume roles; (4) `cluster.why <vid>` lists
    OBS_WHY_EVENTS; (5) `cluster.check` lists every node healthy before the
    loss and `cluster.top -once` has a row for every role; (6) the device
    trace is a gzip of a Chrome trace with CUDA kernel events of the port's
    kernels, and `cluster.profile` returns stacks; (7) every role's
    /metrics passes the port's name lint. Prints files/s and PUT p50/p99,
    the trace's kernel events against the launches counted in its window,
    one history self-scrape's ms, and the phase's span."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke-observe-", dir=REPO / "build")
    # the process's history ring and alert state start with this phase:
    # earlier phases' latencies and injected faults must not fire here, nor
    # ride the first telemetry frames into the master's one-fetch aggregate
    # that cluster.check reads
    hist = history_mod.default_history()
    hist.clear()
    alerts_mod.engine().evaluate()
    master = MasterServer(port=0, pulse_seconds=1)
    master.start()
    servers, filer = [], None
    res = {}
    try:
        for i, rack in enumerate(OBS_RACKS):
            vs = VolumeServer([os.path.join(root, f"v{i}")], master.url, rack=rack,
                              pulse_seconds=PULSE_S, device=dev)
            vs.start()
            servers.append(vs)
        filer = FilerServer(master.url, port=0, device=dev, metrics_port=-1)
        filer.start()
        svc = filer.hash_service
        check(filer.device.type == dev.type and svc.device.type == dev.type
              and all(vs.device.type == dev.type for vs in servers),
              "an observe-phase role is off the card")
        env = CommandEnv(master.url)
        metrics_url = filer.metrics_url
        label = "batch-" + dev.type

        def filer_metrics() -> str:
            status, _, body = http_request("GET", metrics_url + "/metrics")
            check(status == 200, f"GET the filer's /metrics -> {status}")
            return body.decode()

        # 5a. every node healthy before the loss
        out = run_command(env, "cluster.check")
        check(out.endswith("cluster is healthy")
              and all(f"node {vs.node_id} " in out for vs in servers),
              f"cluster.check before the loss: {out}")
        res["check_before"] = out.splitlines()
        # (a) small files from 8 waiting threads
        h0, b0 = metric_value(filer_metrics(), "SeaweedFS_filer_hash_seconds_count",
                              kernel=label), svc.batches
        per = [n_files // OBS_THREADS + (t < n_files % OBS_THREADS) for t in range(OBS_THREADS)]
        rngs = [np.random.default_rng([seed, 42, t]) for t in range(OBS_THREADS)]
        errors = []
        put_lat = [[] for _ in range(OBS_THREADS)]

        def put_small(t: int) -> None:
            c = Client(filer.url)
            try:
                for i in range(per[t]):
                    data = rngs[t].bytes(OBS_SMALL)
                    t0 = time.perf_counter()
                    status, out = c.request("PUT", f"/obs/t{t}/f{i:05d}", data, OCTET)
                    put_lat[t].append(time.perf_counter() - t0)
                    if status != 201 or json.loads(out)["md5"] != hashlib.md5(data).hexdigest():
                        errors.append(f"PUT /obs/t{t}/f{i:05d} -> {status}: {out[:200]!r}")
                        return
            finally:
                c.close()

        small_s = run_threads(put_small, OBS_THREADS)
        check(not errors, f"observe small PUTs: {errors[:3]}")
        # (c) the profiler's first capture pays its set-up; then the 4 MiB
        # PUTs run inside the timed capture
        t0 = time.perf_counter()
        status, _, _ = http_request("GET", metrics_url + "/debug/pprof/device?seconds=0.05",
                                    timeout=120)
        warm_s = time.perf_counter() - t0
        check(status == 200, f"the first device capture -> {status}")
        large = [np.random.default_rng([seed, 43, k]).bytes(OBS_LARGE) for k in range(n_large)]
        cap = {}

        def capture() -> None:
            l0, t0 = read_launches(), time.perf_counter()
            status, _, body = http_request(
                "GET", f"{metrics_url}/debug/pprof/device?seconds={OBS_DEVICE_S:g}",
                timeout=120)
            l1 = read_launches()
            cap.update(status=status, body=body, s=time.perf_counter() - t0,
                       launches={k: l1[k] - l0[k] for k in l1})

        th = threading.Thread(target=capture)
        th.start()
        time.sleep(0.2)
        large_put = [0] * OBS_THREADS

        def put_large(t: int) -> None:
            # n_large files at least, and on until the capture returns, so
            # the window holds launches however late the profiler starts
            c = Client(filer.url)
            try:
                k = t
                while k < n_large or th.is_alive():
                    data = large[k % n_large]
                    status, out = c.request("PUT", f"/obs/large/{k}", data, OCTET)
                    if status != 201 or \
                            json.loads(out)["md5"] != hashlib.md5(data).hexdigest():
                        errors.append(f"PUT /obs/large/{k} -> {status}: {out[:200]!r}")
                        return
                    large_put[t] += 1
                    k += OBS_THREADS
            finally:
                c.close()

        large_s = run_threads(put_large, OBS_THREADS)
        th.join()
        check(not errors, f"observe large PUTs: {errors[:3]}")
        # the marker PUT: its trace id, for cluster.trace
        c = Client(filer.url)
        try:
            c.conn.request("PUT", "/obs/marker", b"m" * OBS_SMALL, OCTET)
            resp = c.conn.getresponse()
            resp.read()
            check(resp.status == 201, f"marker PUT -> {resp.status}")
            marker = resp.getheader(trace_mod.TRACE_HEADER)
        finally:
            c.close()
        h1, b1 = metric_value(filer_metrics(), "SeaweedFS_filer_hash_seconds_count",
                              kernel=label), svc.batches
        # 1. one observation a batch
        check(b1 > b0 and h1 - h0 == b1 - b0,
              f"{h1 - h0:g} {label} observations of SeaweedFS_filer_hash_seconds against"
              f" {b1 - b0} hash-service batches")
        # 6. the device trace
        check(cap.get("status") == 200, f"the device capture -> {cap.get('status')}")
        trace_doc = json.loads(gzip.decompress(cap["body"]))
        kernel_events = collections.Counter()
        for ev in trace_doc.get("traceEvents", []):
            if ev.get("cat") == "kernel":
                for name in OBS_KERNEL_NAMES:
                    if name in ev.get("name", ""):
                        kernel_events[name] += 1
        check(sum(kernel_events.values()) > 0,
              f"the device trace holds no port kernel event ({len(trace_doc.get('traceEvents', []))}"
              f" events; launches counted in its window: {cap['launches']})")
        # 3. the marker's trace spans three roles
        out = run_command(env, "cluster.trace -limit 50")
        line = next((ln for ln in out.splitlines() if ln.startswith(f"trace {marker} ")), None)
        check(line is not None and line.split("roles=")[1].split(",") == list(OBS_ROLES),
              f"cluster.trace of the marker {marker}: {line!r}")
        res["marker_trace"] = out[out.index(line):].split("\ntrace ")[0].splitlines()
        # (b) the EC sequence, with the kernel histograms around it
        text = filer_metrics()
        e0 = metric_value(text, "SeaweedFS_volume_ec_encode_seconds_count")
        d0 = metric_value(text, "SeaweedFS_volume_ec_decode_seconds_count")
        ec = observe_ec_sequence(env, servers, OBS_EC_VID, ec_bytes, seed)
        text = filer_metrics()
        e1 = metric_value(text, "SeaweedFS_volume_ec_encode_seconds_count")
        d1 = metric_value(text, "SeaweedFS_volume_ec_decode_seconds_count")
        # 2. one encode and one rebuild
        check(e1 - e0 == 1 and d1 - d0 == 1,
              f"ec histograms grew by {e1 - e0:g} encodes and {d1 - d0:g} decodes, not 1 and 1")
        # 4. the journal's story of the volume
        why = run_command(env, f"cluster.why {OBS_EC_VID}")
        check(why_event_types(why) == sorted(OBS_WHY_EVENTS),
              f"cluster.why {OBS_EC_VID} lists {why_event_types(why)}: {why[:2000]}")
        # 5b. a row for every role
        top = run_command(env, "cluster.top -once")
        rows = {ln.split()[0] for ln in top.splitlines()[2:] if ln and not ln.startswith(" ")}
        check(set(OBS_ROLES) <= rows, f"cluster.top -once rows {sorted(rows)}: {top}")
        # 6b. stacks from every process
        prof = run_command(env, f"cluster.profile -seconds {OBS_PROFILE_S:g}")
        stacks = [ln for ln in prof.splitlines()[1:] if ";" in ln]
        check(len(stacks) > 0, f"cluster.profile returned no stacks: {prof[:500]}")
        # 7. every role's exposition passes the port's name lint
        bad = []
        for url in [master.url] + [vs.url for vs in servers] + [metrics_url]:
            status, _, body = http_request("GET", url + "/metrics")
            check(status == 200, f"GET {url}/metrics -> {status}")
            bad += exposition_violations(body.decode())
        check(not bad, f"metric-name lint: {bad[:5]}")
        t0 = time.perf_counter()
        hist.scrape_once()
        scrape_ms = (time.perf_counter() - t0) * 1e3
        small_lat = [x for lat in put_lat for x in lat]
        res.update(
            files=n_files, file_bytes=OBS_SMALL, threads=OBS_THREADS, small_s=small_s,
            files_per_s=n_files / small_s,
            **{f"put_{k}": v for k, v in _pcts(small_lat).items()},
            large_files=sum(large_put), large_s=large_s,
            large_gbps=sum(large_put) * OBS_LARGE / large_s / 1e9,
            hash_batches=b1 - b0, hash_observations=h1 - h0,
            ec={k: v for k, v in ec.items() if not k.endswith("_out")},
            ec_encodes=e1 - e0, ec_decodes=d1 - d0, why_events=why_event_types(why),
            why_rows=len(why.splitlines()) - 1, top=top.splitlines(),
            profile_stacks=len(stacks), profile_head=prof.splitlines()[0],
            device_trace=dict(
                warm_capture_s=warm_s, window_s=OBS_DEVICE_S, request_s=cap["s"],
                gzip_bytes=len(cap["body"]), events=len(trace_doc.get("traceEvents", [])),
                kernel_events=dict(kernel_events),
                launches_in_window={k: v for k, v in cap["launches"].items() if v}),
            history_scrape_ms=scrape_ms, history_series=len(hist.families()),
            lint_violations=0)
    finally:
        if filer is not None:
            filer.stop()
        for vs in servers:
            vs.stop()
        master.stop()
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    res.update(wall_s=wall, wall_limit_s=OBS_WALL_LIMIT_S, over_wall_limit=wall > OBS_WALL_LIMIT_S,
               cuts=OBS_CUTS, note="every role in one process: one registry, ring and journal")
    return res


QT_THREADS = 8  # victim clients, each waiting for its answer; and abuser threads
QT_SMALL = 4096
QT_LARGE = 4 * MIB
QT_LIMITS = "abuser=20:40,victim=10000,*=200"  # tests/test_qos.py's two-gateway policy
QT_ABUSER = (20.0, 40.0)  # the abuser's (rate, burst) in QT_LIMITS
QT_LIVE_LIMIT = "abuser=5:10"  # set live through cluster.qos
QT_LIVE = (5.0, 10.0)
QT_AFTER_S = 3.0  # flood seconds after the live change
QT_S3_EVERY = 4  # every 4th victim file and abuser op goes through S3
QT_SENDER_ROLES = ("master", "volume", "filer", "s3", "webdav")
QT_SENDER_WAIT_S = 12.0  # the pushers' and registrations' 5 s cadence, twice, and some
QT_WALL_LIMIT_S = 30
QT_CUTS = ("(a) --qt-files (512; 1,024 took the phase past its 30 s) 4 KiB and --qt-large (8) 4 MiB victim"
           " files from 8 waiting"
           " threads, twice; (b) an abuser flood of --qt-flood-s (8) s from 8 threads, then"
           " 3 s more; every role in one process, so the gateways share one admission"
           " controller, one usage accountant and one telemetry spool (the first"
           " telemetry_dir given: the master's)")


def request_full(c: "Client", method: str, path: str, body=None,
                 headers=None) -> tuple[int, dict, bytes]:
    """One request on a keep-alive Client: status, headers, body."""
    c.conn.request(method, path, body=body, headers=headers or {})
    resp = c.conn.getresponse()
    out = resp.read()
    return resp.status, dict(resp.getheaders()), out


def typed_shed(where: str, status: int, headers: dict, body: bytes) -> str | None:
    """The shed reason of a typed QoS refusal, else None: a filer 429/503
    with Retry-After and a JSON reason, an S3 SlowDown (429) or
    ServiceUnavailable (503) with Retry-After."""
    reason = headers.get("X-Sw-Qos-Reason")
    if status not in (429, 503) or not reason or "Retry-After" not in headers:
        return None
    if where == "s3":
        code = "SlowDown" if status == 429 else "ServiceUnavailable"
        return reason if f"<Code>{code}</Code>".encode() in body else None
    try:
        return reason if json.loads(body).get("reason") == reason else None
    except ValueError:
        return None


def qos_telemetry_phase(dev: torch.device, n_files: int, n_large: int, flood_s: float,
                        seed: int) -> dict:
    """Telemetry, usage and QoS on two filer gateways that share one
    `-qos.limits` policy (QT_LIMITS): a master with a telemetry_dir (pulse
    1 s), two volume servers and two filers on the card, each filer with
    its own telemetry_dir, an S3 and a WebDAV gateway given the master (so
    their pushers run). (a) a victim tenant (?collection=victim, S3 bucket
    victim) writes n_files 4 KiB and n_large 4 MiB files from 8 waiting
    threads, every QT_S3_EVERY-th small file through S3, and reads them
    back, once alone, then again under (b) an abuser flood of flood_s s
    from 8 threads, half through each filer and a quarter of its ops
    through S3; (c) `cluster.qos -limit QT_LIVE_LIMIT` live, then QT_AFTER_S
    s more of flood; (d) one filer stopped and the process's spool closed,
    then `cluster.top -once -spool` and `cluster.why -spool abuser` read it
    post-mortem; (e) `cluster.heat -n 8` and `cluster.qos` rendered.
    Checks: no victim request shed; the abuser refused only with typed
    sheds, admitted at most rate x (T + queue_wait) + burst in each stage
    (the bucket may run queue_wait into deficit, and a changed limit
    starts a fresh burst); the master's one fetch holds frames from every
    sender, and the abuser's merged count lies within the sketch's error
    bound of the gateways' /debug/usage count (one process: one
    accountant); the spool reads back events and series. Prints victim
    files/s and PUT p50/p99 alone and under the flood, the abuser's
    admitted and shed by reason, frames and bytes by sender, spool bytes
    by tier and the phase's span."""
    from seaweedfs_tpu_torch.s3api import S3Server

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke-qos-", dir=REPO / "build")
    spools = {name: os.path.join(root, f"spool-{name}") for name in ("master", "f1", "f2")}
    check(store_mod.store() is None, "a telemetry spool is on before the qos_telemetry phase")
    # earlier phases' latencies must not burn an SLO the actuator acts on,
    # and the process's usage accountant counts this phase's tenants only
    history_mod.default_history().clear()
    alerts_mod.engine().evaluate()
    usage_mod.reset()
    master = MasterServer(port=0, pulse_seconds=1, telemetry_dir=spools["master"])
    master.start()
    servers, filers, s3, dav = [], [], None, None
    ctl = qos_mod.controller()
    res = {}
    try:
        for i, rack in enumerate(("r1", "r2")):
            vs = VolumeServer([os.path.join(root, f"v{i}")], master.url, rack=rack,
                              pulse_seconds=PULSE_S, device=dev)
            vs.start()
            servers.append(vs)
        for name in ("f1", "f2"):
            f = FilerServer(master.url, port=0, device=dev, qos_limits=QT_LIMITS,
                            telemetry_dir=spools[name],
                            peers=[filers[0].url] if filers else None)
            f.start()
            filers.append(f)
        s3 = S3Server(filers[0].url, port=0, master_url=master.url)
        s3.start()
        dav = WebDavServer(filers[1].url, port=0, master_url=master.url)
        dav.start()
        check(all(f.device.type == dev.type for f in filers)
              and all(vs.device.type == dev.type for vs in servers),
              "a qos_telemetry role is off the card")
        check(ctl.armed and list(ctl.status()["limits"]["abuser"]) == list(QT_ABUSER),
              f"-qos.limits did not arm the controller: {ctl.status()}")
        spool = store_mod.store()
        check(spool is not None and spool.dir == spools["master"],
              "the process's spool is not the first telemetry_dir given (the master's)")
        env = CommandEnv(master.url)
        for bucket in ("victim", "abuser"):
            status, _, out = http_request("PUT", f"{s3.url}/{bucket}")
            check(status == 200, f"S3 create bucket {bucket} -> {status}: {out[:200]!r}")
        urls = {"s3": s3.url, "f1": filers[0].url, "f2": filers[1].url}

        def victim_run(tag: str) -> dict:
            rngs = [np.random.default_rng([seed, 71, t]) for t in range(QT_THREADS)]
            per = [n_files // QT_THREADS + (t < n_files % QT_THREADS)
                   for t in range(QT_THREADS)]
            written = [[] for _ in range(QT_THREADS)]
            lat = [[] for _ in range(QT_THREADS)]
            errors, shed = [], []

            def write(t: int) -> None:
                conns = {k: Client(u) for k, u in urls.items()}
                try:
                    for i in range(per[t]):
                        data = rngs[t].bytes(QT_SMALL)
                        if (i + t) % QT_S3_EVERY == QT_S3_EVERY - 1:
                            where, path = "s3", f"/victim/{tag}/t{t}/f{i:05d}"
                        else:
                            where = "f1" if t % 2 == 0 else "f2"
                            path = f"/qt/{tag}/t{t}/f{i:05d}?collection=victim"
                        t0 = time.perf_counter()
                        status, hdrs, out = request_full(conns[where], "PUT", path, data, OCTET)
                        lat[t].append(time.perf_counter() - t0)
                        ok = 200 if where == "s3" else 201
                        if status in (429, 503):
                            shed.append(f"{where} PUT {path} -> {status} {out[:200]!r}")
                            continue
                        if status != ok:
                            errors.append(f"{where} PUT {path} -> {status}: {out[:200]!r}")
                            return
                        written[t].append((where, path, data))
                    if t < n_large:
                        data = np.random.default_rng([seed, 72, t]).bytes(QT_LARGE)
                        where = "f1" if t % 2 == 0 else "f2"
                        path = f"/qt/{tag}/large{t}?collection=victim"
                        status, hdrs, out = request_full(conns[where], "PUT", path, data, OCTET)
                        if status in (429, 503):
                            shed.append(f"{where} PUT {path} -> {status}")
                            return
                        if status != 201 or \
                                json.loads(out)["md5"] != hashlib.md5(data).hexdigest():
                            errors.append(f"{where} PUT {path} -> {status}: {out[:200]!r}")
                            return
                        written[t].append((where, path, data))
                finally:
                    for c in conns.values():
                        c.close()

            def read(t: int) -> None:
                conns = {k: Client(u) for k, u in urls.items()}
                try:
                    for where, path, data in written[t]:
                        status, _, out = request_full(conns[where], "GET", path)
                        if status in (429, 503):
                            shed.append(f"{where} GET {path} -> {status}")
                        elif status != 200 or out != data:
                            errors.append(f"{where} GET {path} -> {status}, {len(out)} B")
                            return
                finally:
                    for c in conns.values():
                        c.close()

            write_s = run_threads(write, QT_THREADS)
            check(not errors, f"victim {tag} writes: {errors[:3]}")
            check(not shed, f"victim {tag}: {len(shed)} write(s) shed: {shed[:3]}")
            read_s = run_threads(read, QT_THREADS)
            check(not errors, f"victim {tag} reads: {errors[:3]}")
            check(not shed, f"victim {tag}: {len(shed)} read(s) shed: {shed[:3]}")
            small = [x for ls in lat for x in ls]
            return dict(files=n_files, large=min(n_large, QT_THREADS), write_s=write_s,
                        read_s=read_s, files_per_s=n_files / write_s,
                        reads=sum(len(w) for w in written),
                        **{f"put_{k}": v for k, v in _pcts(small).items()})

        # (a) the victim alone
        l0 = read_launches()
        res["victim_alone"] = victim_run("alone")

        def flood(stage: str, seconds: float) -> dict:
            outcomes, errors, ends = [], [], []
            deadline = time.perf_counter() + seconds

            def abuse(t: int) -> None:
                conns = {k: Client(u) for k, u in urls.items()}
                data = np.random.default_rng([seed, 73, t]).bytes(QT_SMALL)
                n = 0
                try:
                    while time.perf_counter() < deadline:
                        if n % QT_S3_EVERY == QT_S3_EVERY - 1:
                            where, path = "s3", f"/abuser/{stage}/t{t}/{n}"
                        else:
                            where = "f1" if (t + n) % 2 == 0 else "f2"
                            path = f"/qt/abuse/{stage}/t{t}/{n}?collection=abuser"
                        status, hdrs, out = request_full(conns[where], "PUT", path, data, OCTET)
                        n += 1
                        if status == (200 if where == "s3" else 201):
                            outcomes.append((where, "admitted"))
                            continue
                        reason = typed_shed("s3" if where == "s3" else "filer", status,
                                            hdrs, out)
                        if reason is None:
                            errors.append(f"{where} PUT {path} -> {status} {hdrs}"
                                          f" {out[:200]!r}")
                            return
                        outcomes.append((where, reason))
                finally:
                    ends.append(time.perf_counter())
                    for c in conns.values():
                        c.close()

            threads = [threading.Thread(target=abuse, args=(t,)) for t in range(QT_THREADS)]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            return {"threads": threads, "t0": t0, "outcomes": outcomes, "errors": errors,
                    "ends": ends}

        def flood_done(fl: dict, limit: tuple) -> dict:
            for th in fl["threads"]:
                th.join()
            # from the first request to the last answer: every admission lies inside
            span = max(fl["ends"]) - fl["t0"]
            check(not fl["errors"], f"abuser: untyped answers {fl['errors'][:3]}")
            admitted = sum(1 for _, o in fl["outcomes"] if o == "admitted")
            bound = limit[0] * (span + ctl.queue_wait) + limit[1]
            by = collections.Counter(f"{w}:{o}" for w, o in fl["outcomes"])
            check(admitted <= bound,
                  f"abuser admitted {admitted} in {span:.2f} s, past rate x (T + queue_wait)"
                  f" + burst = {bound:.1f}")
            check(admitted < len(fl["outcomes"]), "the abuser's flood was never shed")
            return dict(span_s=span, ops=len(fl["outcomes"]), admitted=admitted,
                        admitted_bound=bound, by_gateway_and_outcome=dict(sorted(by.items())),
                        shed_by_reason=dict(collections.Counter(
                            o for _, o in fl["outcomes"] if o != "admitted")))

        # (b) the flood, and the victim again under it
        fl = flood("one", flood_s)
        res["victim_under_flood"] = victim_run("flood")
        res["abuser_before"] = flood_done(fl, QT_ABUSER)
        res["victim_under_flood"]["flood_s"] = res["abuser_before"]["span_s"]
        # (c) the live limit through the shell, then more flood
        out = run_command(env, f"cluster.qos -limit '{QT_LIVE_LIMIT}' -include {s3.url}")
        check("applied" in out
              and list(ctl.status()["limits"].get("abuser", ())) == list(QT_LIVE),
              f"cluster.qos -limit: {out}; limits {ctl.status()['limits']}")
        res["qos_set"] = out.splitlines()
        res["abuser_after"] = flood_done(flood("two", QT_AFTER_S), QT_LIVE)
        launches = {k: v - l0[k] for k, v in read_launches().items()}
        # every sender's frames at the master, and the merged abuser count
        deadline = time.perf_counter() + QT_SENDER_WAIT_S
        while True:
            tele = get_json(f"{master.url}/debug/cluster/telemetry")
            roles = collections.Counter(s["role"] for s in tele["senders"].values())
            if all(roles[r] >= (2 if r in ("volume", "filer") else 1)
                   for r in QT_SENDER_ROLES) or time.perf_counter() > deadline:
                break
            time.sleep(0.25)
        check(all(roles[r] >= (2 if r in ("volume", "filer") else 1) for r in QT_SENDER_ROLES),
              f"senders at the master by role: {dict(roles)}")
        check(s3._telemetry_pusher.push_once(), "the S3 pusher's last frame was refused")
        tele = get_json(f"{master.url}/debug/cluster/telemetry")
        local, procs = 0.0, set()
        for gw in (filers[0].url, filers[1].url, s3.url):
            u = get_json(f"{gw}/debug/usage")
            if u["proc"] in procs:
                continue  # one process, one accountant: counted once
            procs.add(u["proc"])
            local += next((r["requests"] for r in u["tenants"]
                           if r["collection"] == "abuser"), 0.0)
        merged = next((r for r in tele["usage"]["tenants"] if r["collection"] == "abuser"), None)
        check(merged is not None, f"the abuser is not in the merged tenants: {tele['usage']}")
        bound = max(float(merged.get("requests_err", 0.0)),
                    float(tele["usage"].get("error_bound", 0.0)))
        check(abs(merged["requests"] - local) <= bound,
              f"merged abuser count {merged['requests']:g} against {local:g} at the gateways,"
              f" error bound {bound:g}")
        res["telemetry"] = dict(
            senders={n: dict(role=s["role"], frames=s["frames"], frame_bytes=s["frame_bytes"],
                             stale=s["stale"]) for n, s in sorted(tele["senders"].items())},
            frames_total=tele["frames_total"], frames_rejected=tele["frames_rejected"],
            bytes_total=tele["bytes_total"], merge_seconds=tele["merge_seconds"],
            abuser_merged=merged["requests"], abuser_local=local, error_bound=bound,
            rates=tele["rates"])
        # (e) the operator's views
        heat = run_command(env, "cluster.heat -n 8")
        check("abuser" in heat and "victim" in heat, f"cluster.heat -n 8: {heat}")
        qos_show = run_command(env, f"cluster.qos -include {s3.url}")
        live = f"abuser={QT_LIVE[0]:g}:{QT_LIVE[1]:g}"
        check("armed" in qos_show and live in qos_show and "shed:" in qos_show,
              f"cluster.qos: {qos_show}")
        res.update(heat=heat.splitlines(), qos=qos_show.splitlines(),
                   controller=dict(admitted={f"{c}/{k}": n for (c, k), n
                                             in sorted(ctl.admitted_total.items())},
                                   shed={"/".join(k): n for k, n
                                         in sorted(ctl.shed_total.items())}))
        # (d) one filer stopped, the process's spool closed: the post-mortem
        filers[1].stop()
        filers.pop()
        store_mod.disable()
        info = store_mod.spool_info(spools["master"])
        evs = store_mod.read_events(spools["master"])
        series = store_mod.read_series(spools["master"], "SeaweedFS_http_request_total")
        check(evs and series, f"the spool read back {len(evs)} events and {len(series)} series")
        check(all(not os.listdir(spools[n]) if os.path.isdir(spools[n]) else True
                  for n in ("f1", "f2")),
              "a filer's own telemetry_dir holds a spool beside the process's")
        top = run_command(env, f"cluster.top -once -spool {spools['master']}")
        check("post-mortem spool" in top and "filer=" in top, f"cluster.top -spool: {top}")
        why = run_command(env, f"cluster.why abuser -spool {spools['master']}")
        check("qos_shed" in why, f"cluster.why abuser -spool: {why[:2000]}")
        res.update(spool=dict(dir="the master's", tiers=info,
                              total_bytes=sum(t["bytes"] for t in info.values()),
                              events=len(evs), request_series=len(series),
                              event_types=dict(collections.Counter(e["type"] for e in evs))),
                   top_spool=[ln for ln in top.splitlines() if "spool" in ln or "req/s" in ln],
                   why_rows=len(why.splitlines()) - 1, launches=launches)
    finally:
        store_mod.disable()
        for server in ([dav, s3] + filers[::-1] + servers):
            if server is not None:
                server.stop()
        master.stop()
        act_mod.reset()
        qos_mod.reset()
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    res.update(wall_s=wall, wall_limit_s=QT_WALL_LIMIT_S, over_wall_limit=wall > QT_WALL_LIMIT_S,
               cuts=QT_CUTS, note="every role in one process: one controller, accountant, spool")
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
    ap.add_argument("--upload-blobs", type=int, default=1 << 15)
    ap.add_argument("--chunked-mib", type=int, default=1024)
    ap.add_argument("--cdc-uploads", type=int, default=32)
    ap.add_argument("--stream-mib", type=int, default=1024)
    ap.add_argument("--dedup-gib", type=int, default=2)
    ap.add_argument("--online-mib", type=int, default=1024)
    ap.add_argument("--cluster-mib", type=int, default=1024)
    ap.add_argument("--mesh-volumes", type=int, default=32)
    ap.add_argument("--mesh-mib", type=int, default=4)
    ap.add_argument("--filer-files", type=int, default=2048)
    ap.add_argument("--filer-large-mib", type=int, default=256)
    ap.add_argument("--scrub-files", type=int, default=1024)
    ap.add_argument("--scrub-mib", type=int, default=256)
    ap.add_argument("--maint-mib", type=int, default=256)
    ap.add_argument("--maint-files", type=int, default=1024)
    ap.add_argument("--filer-dedup-uploads", type=int, default=6)
    ap.add_argument("--s3-objects", type=int, default=256)
    ap.add_argument("--s3-seconds", type=float, default=10.0)
    ap.add_argument("--s3-clients", type=int, default=20)
    ap.add_argument("--s3-multipart-mib", type=int, default=64)
    ap.add_argument("--tier-mib", type=int, default=256)
    ap.add_argument("--gw-dav-files", type=int, default=256)
    ap.add_argument("--gw-ftp-files", type=int, default=256)
    ap.add_argument("--gw-ftp-large-mib", type=int, default=256)
    ap.add_argument("--gw-mount-mib", type=int, default=512)
    ap.add_argument("--gw-small-files", type=int, default=256)
    ap.add_argument("--gw-remote-mib", type=int, default=256)
    ap.add_argument("--sync-files", type=int, default=128)
    ap.add_argument("--mq-messages", type=int, default=4096)
    ap.add_argument("--ha-files", type=int, default=1024)
    ap.add_argument("--ha-large-mib", type=int, default=64)
    ap.add_argument("--ha-ec-mib", type=int, default=256)
    ap.add_argument("--obs-files", type=int, default=1024)
    ap.add_argument("--obs-large", type=int, default=16)
    ap.add_argument("--obs-ec-mib", type=int, default=256)
    ap.add_argument("--qt-files", type=int, default=512)
    ap.add_argument("--qt-large", type=int, default=8)
    ap.add_argument("--qt-flood-s", type=float, default=8.0)
    ap.add_argument("--offset5-child", metavar="DIR",
                    help="run only the volume_side phase's 5-byte-offset EC path in DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if args.offset5_child:
        return offset5_child(torch.device("cuda", 0), args.offset5_child, VS_OFFSET5_BYTES,
                             args.seed)
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
    timed["gf256_matmul"]["shapes"].extend(cl["kernel"])

    # the multi-device split (BASELINE config 5 on this host's devices); its own count
    ms = mesh_phase(dev, args.mesh_volumes, args.mesh_mib * MIB, md5_block["ops"], args.seed)
    emit("mesh", **ms)
    # the filer's HTTP path (BASELINE config 3 as the filer takes it); its own count
    fl = filer_phase(dev, args.filer_files, args.filer_large_mib * MIB, md5_block["ops"],
                     args.seed)
    emit("filer", switch_interval_s=sys.getswitchinterval(), **fl)
    for name in ("gf256_matmul", "crc32c_batch", "md5_batch"):
        launches[name] += ms["launches"][name] + fl["launches"][name]
    timed["gf256_matmul"]["shapes"].append(ms["kernel"])
    for name in ("crc32c_batch", "md5_batch"):
        timed[name]["shapes"].extend(ms["hash_kernels"][name] + fl["hash_kernels"][name])

    # the volume integrity plane (replication, scrub, repairs, vacuum); its own count
    sc = scrub_phase(dev, args.scrub_files, args.scrub_mib * MIB, md5_block["ops"], args.seed)
    emit("scrub", switch_interval_s=sys.getswitchinterval(), **sc)
    for name in ("gf256_matmul", "crc32c_batch"):
        launches[name] += sc["launches"][name]
    timed["gf256_matmul"]["shapes"].extend(sc["gf_kernel"])
    timed["crc32c_batch"]["shapes"].extend(sc["crc_kernel"])
    timed["crc32c_batch"]["max_abs_err"] = max(timed["crc32c_batch"]["max_abs_err"],
                                               sc["flush_crc_max_abs_err"])

    # the maintenance daemon's heals, no shell command after the damage; its own count
    mt = maintenance_phase(dev, args.maint_mib * MIB, args.maint_files, args.seed)
    emit("maintenance", switch_interval_s=sys.getswitchinterval(), **mt)
    for name in ("gf256_matmul", "crc32c_batch"):
        launches[name] += mt["launches"][name]
    timed["crc32c_batch"]["max_abs_err"] = max(timed["crc32c_batch"]["max_abs_err"],
                                               mt["flush_crc_max_abs_err"])

    # the filer's dedup over HTTP with its reclaim (config 4 as operated); its own count
    fd = filer_dedup_phase(dev, args.filer_dedup_uploads, args.seed)
    emit("filer_dedup", nvidia_smi=nvidia_smi(), **fd)
    launches["gear_hash"] += fd["launches"]["gear_hash"]
    timed["gear_hash"]["max_abs_err"] = max(timed["gear_hash"]["max_abs_err"],
                                            fd["gear_max_abs_err"])

    # the S3 gateway, IAM and warp's mixed load over the filer; its own count
    s3 = s3_phase(dev, args.s3_objects, args.s3_seconds, args.s3_clients,
                  args.s3_multipart_mib * MIB, md5_block["ops"], args.seed)
    emit("s3", nvidia_smi=nvidia_smi(), switch_interval_s=sys.getswitchinterval(), **s3)
    for name in ("crc32c_batch", "md5_batch"):
        launches[name] += s3["launches"][name]
        timed[name]["shapes"].extend(s3["hash_kernels"][name])

    # the volume side: tiering, every fault mode, 5-byte offsets; its own count
    vsd = volume_side_phase(dev, args.tier_mib * MIB, md5_block["ops"], args.seed)
    emit("volume_side", nvidia_smi=nvidia_smi(), **vsd)
    for name in ("gf256_matmul", "crc32c_batch"):
        launches[name] += vsd["launches"][name]
    timed["gf256_matmul"]["shapes"].extend(vsd["gf_kernel"])
    timed["crc32c_batch"]["shapes"].extend(vsd["crc_kernel"])
    timed["crc32c_batch"]["max_abs_err"] = max(timed["crc32c_batch"]["max_abs_err"],
                                               vsd["flush_crc_max_abs_err"])
    timed["gf256_matmul"]["max_abs_err"] = max(timed["gf256_matmul"]["max_abs_err"],
                                               vsd["offset5"]["max_abs_err"])

    # the filer's other front doors and remote storage; its own count
    gw = gateways_phase(dev, args.gw_dav_files, args.gw_ftp_files, args.gw_ftp_large_mib * MIB,
                        args.gw_mount_mib * MIB, args.gw_small_files, args.gw_remote_mib * MIB,
                        md5_block["ops"], args.seed)
    emit("gateways", nvidia_smi=nvidia_smi(), switch_interval_s=sys.getswitchinterval(), **gw)
    for name in ("crc32c_batch", "md5_batch"):
        launches[name] += gw["launches"][name]
        timed[name]["shapes"].extend(gw["hash_kernels"][name])

    # filer.sync both ways, filer.replicate and filer.backup, the mq broker; its own count
    sm = sync_mq_phase(dev, args.sync_files, args.mq_messages, md5_block["ops"], args.seed)
    emit("sync_mq", nvidia_smi=nvidia_smi(), switch_interval_s=sys.getswitchinterval(), **sm)
    for name in ("crc32c_batch", "md5_batch"):
        launches[name] += sm["launches"][name]
        timed[name]["shapes"].extend(sm["hash_kernels"][name])

    # security and raft HA: mTLS and JWT on every path, a leader failover; its own count
    ha = secure_ha_phase(dev, args.ha_files, args.ha_large_mib * MIB, args.ha_ec_mib * MIB,
                         md5_block["ops"], args.seed)
    emit("secure_ha", nvidia_smi=nvidia_smi(), switch_interval_s=sys.getswitchinterval(), **ha)
    for name in ("gf256_matmul", "crc32c_batch", "md5_batch"):
        launches[name] += ha["launches"][name]
    for name in ("crc32c_batch", "md5_batch"):
        timed[name]["shapes"].extend(ha["hash_kernels"][name])

    # the stats core and the debug plane on a loaded cluster; its own count
    l0 = read_launches()
    ob = observe_phase(dev, args.obs_files, args.obs_large, args.obs_ec_mib * MIB, args.seed)
    ob["launches"] = {k: v - l0[k] for k, v in read_launches().items()}
    emit("observe", nvidia_smi=nvidia_smi(), switch_interval_s=sys.getswitchinterval(), **ob)
    for name in ("gf256_matmul", "crc32c_batch", "md5_batch"):
        check(ob["launches"][name] > 0, f"the observe phase launched no {name} kernel")
        launches[name] += ob["launches"][name]

    # telemetry, usage and QoS on two filer gateways under a tenant's flood; its own count
    qt = qos_telemetry_phase(dev, args.qt_files, args.qt_large, args.qt_flood_s, args.seed)
    emit("qos_telemetry", nvidia_smi=nvidia_smi(), switch_interval_s=sys.getswitchinterval(),
         **qt)
    for name in ("crc32c_batch", "md5_batch"):
        check(qt["launches"][name] > 0, f"the qos_telemetry phase launched no {name} kernel")
    for name in ("gf256_matmul", "crc32c_batch", "md5_batch"):
        launches[name] += qt["launches"][name]

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
