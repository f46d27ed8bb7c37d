"""Maintenance: the integrity scrub plane.

The port's copy of `seaweedfs_tpu/maintenance/`, `scrub.py` only: the
volume-side scrubber, the master-side `detect` of findings and replica
divergence, and the repair routing the `volume.scrub` verb applies. Not
ported yet: the maintenance daemon and its detectors, scheduler and
executors (`daemon.py`, `detectors.py`, `scheduler.py`, `executors.py`).
"""

from .scrub import (
    EMPTY_NEEDLE_DIGEST,
    SCRUB_FINDING_KINDS,
    RepairTask,
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
    "EMPTY_NEEDLE_DIGEST", "SCRUB_FINDING_KINDS", "RepairTask",
    "ScrubCodecFailed", "ScrubFinding", "TokenBucket", "VolumeScrubber",
    "apply_scrub_repairs", "describe_scrub_repairs", "detect",
    "needle_set_digest", "plan_scrub_repairs",
]
