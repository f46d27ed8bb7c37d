"""Filer: POSIX-ish namespace over pluggable metadata stores, files as chunk
lists on volume servers (reference: `weed/filer/`). The port's copy of
`seaweedfs_tpu/filer/`, with the modules the dedup write path needs."""

from .entry import Attributes, Entry, FileChunk
from .filer import Filer

__all__ = ["Attributes", "Entry", "FileChunk", "Filer"]
