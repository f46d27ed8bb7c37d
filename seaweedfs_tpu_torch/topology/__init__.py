"""Master-side cluster state (reference: `weed/topology/`).

Tree DataCenter -> Rack -> DataNode with free-slot accounting, per-
(collection, replica placement, ttl) volume layouts with writable tracking,
replica-placement-aware volume growth, and heartbeat-driven sync. Pure state
machine — proven by synthetic heartbeats exactly like the reference's
topology tests (SURVEY.md §4 "in-process cluster simulation").

The port's copy of `seaweedfs_tpu/topology/`: host code, no device.
"""

from .node import DataCenter, DataNode, Rack
from .topology import Topology
from .volume_layout import VolumeLayout

__all__ = ["DataCenter", "DataNode", "Rack", "Topology", "VolumeLayout"]
