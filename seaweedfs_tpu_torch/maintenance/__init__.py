"""Autonomous maintenance: detect → plan → heal, and the integrity scrub
plane.

The port's copy of `seaweedfs_tpu/maintenance/`: detectors
(detectors.py) scan the master's live topology and emit typed
RepairTasks, a bounded scheduler (scheduler.py) dedups, prioritizes and
throttles them, and executors (executors.py) heal through the same
plan/apply helpers the admin-shell repair verbs use. MaintenanceDaemon
(daemon.py) runs the loop inside the port's master behind
`maintenance=True` (off by default; `maintenance_dry_run=True` plans
without executing) and serves /debug/maintenance. scrub.py holds the
volume-side scrubber, the master-side `detect` of findings and replica
divergence, and the repair routing shared by the `scrub` task and the
`volume.scrub` verb.

The daemon is host code; the heals it starts run `gf256_matmul` and
`crc32c_batch` on the volume servers' devices. The metric families,
alert hook, events journal and trace spans are the JAX package's
(`stats/`); `MaintenanceDaemon.status()` also reports plain counts.
"""

from .daemon import ALERT_SCANS, MAINTENANCE_FAMILIES, MaintenanceDaemon, \
    ensure_metrics
from .detectors import DETECTORS, TASK_TYPES, RepairTask, TaskSpec, scan
from .executors import EXECUTORS, execute
from .scheduler import RepairScheduler
from .scrub import (
    EMPTY_NEEDLE_DIGEST,
    SCRUB_FINDING_KINDS,
    ScrubCodecFailed,
    ScrubFinding,
    TokenBucket,
    VolumeScrubber,
    apply_scrub_repairs,
    describe_scrub_repairs,
    detect,
    needle_set_digest,
    plan_scrub_repairs,
)

__all__ = [
    "ALERT_SCANS", "DETECTORS", "EMPTY_NEEDLE_DIGEST", "EXECUTORS",
    "MAINTENANCE_FAMILIES", "MaintenanceDaemon", "RepairScheduler", "RepairTask",
    "SCRUB_FINDING_KINDS", "ScrubCodecFailed", "ScrubFinding", "TASK_TYPES",
    "TaskSpec", "TokenBucket", "VolumeScrubber", "apply_scrub_repairs",
    "describe_scrub_repairs", "detect", "ensure_metrics", "execute",
    "needle_set_digest",
    "plan_scrub_repairs", "scan",
]
