"""S3-compatible gateway over the filer.

Reference: `weed/s3api/` (~14k LoC): REST router, AWS SigV4 auth, bucket and
object handlers, multipart assembly via filer chunk concatenation, tagging,
identity/action authorization, circuit breaker.

The port's copy of `seaweedfs_tpu/s3api/`, over the port's filer.
"""

from .auth import Identity, IdentityAccessManagement, S3ApiError
from .s3_server import S3Server
from .sigv4_client import S3Client

__all__ = [
    "Identity",
    "IdentityAccessManagement",
    "S3ApiError",
    "S3Server",
    "S3Client",
]
