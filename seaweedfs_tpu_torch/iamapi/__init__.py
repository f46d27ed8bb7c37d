"""AWS IAM-compatible management API (reference: `weed/iamapi/`).

The port's copy of `seaweedfs_tpu/iamapi/`, over the port's filer."""

from .iam_server import IamServer

__all__ = ["IamServer"]
