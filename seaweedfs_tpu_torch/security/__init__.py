"""Security layer: JWT write/read tokens, IP guard, security.toml loading,
process-wide mTLS.

The port's copy of `seaweedfs_tpu/security/` (reference
`weed/security/jwt.go:17-28`, SeaweedFileIdClaims: the master signs a
per-fileId HS256 token and the volume server verifies it before accepting
a write; `weed/security/guard.go:42-50`, the IP whitelist;
`weed/util/config.go`, security.toml discovery; `weed/security/tls.go`,
mutual TLS with an allowed-commonNames gate). Framework-free: hmac,
hashlib, ipaddress and ssl.
"""

from .config import SecurityConfig, load_security_config
from .guard import Guard
from .jwt import (
    decode_jwt,
    encode_jwt,
    gen_read_jwt,
    gen_write_jwt,
    token_from_request,
    verify_file_jwt,
)

__all__ = [
    "decode_jwt",
    "encode_jwt",
    "gen_read_jwt",
    "gen_write_jwt",
    "token_from_request",
    "verify_file_jwt",
    "Guard",
    "SecurityConfig",
    "load_security_config",
]
