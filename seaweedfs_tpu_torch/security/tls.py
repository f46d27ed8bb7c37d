"""Process-wide TLS/mTLS for every HTTP listener and client.

Reference: `weed/security/tls.go` — mutual TLS on all gRPC planes with an
allowed-commonNames authenticator, configured once from security.toml and
applied to every server/client in the process. The rebuild's control and
data planes are HTTP, so the equivalent is: one server SSLContext wrapped
around every HTTPService listener (client certs REQUIRED), one client
SSLContext presented by every outbound http_request, and a post-handshake
CommonName check per request.

    [tls]
    ca = "/etc/seaweedfs/ca.pem"
    cert = "/etc/seaweedfs/server.pem"
    key = "/etc/seaweedfs/server.key"
    allowed_commonNames = "master1,volume*,filer1"   # "" = any valid cert

Certificates must chain to `ca`. allowed_commonNames entries match exactly
or by '*' wildcard (the reference additionally has a wildcard-domain knob;
'*.domain' entries cover it here).

The port's copy of `seaweedfs_tpu/security/tls.py`. The state is
process-wide, as there: `configure` turns every `HTTPService` started
afterwards into an mTLS listener and every outbound `http_request` and
`PooledHTTP` connection to an `https` URL into an mTLS client, until
`reset()`.
"""

from __future__ import annotations

import re
import ssl
from dataclasses import dataclass


@dataclass
class TLSConfig:
    ca: str = ""
    cert: str = ""
    key: str = ""
    allowed_common_names: str = ""  # comma-separated; "" accepts any valid cert

    @property
    def enabled(self) -> bool:
        return bool(self.ca and self.cert and self.key)

    @property
    def partially_set(self) -> bool:
        some = bool(self.ca or self.cert or self.key or
                    self.allowed_common_names)
        return some and not self.enabled


_SERVER_CTX: ssl.SSLContext | None = None
_CLIENT_CTX: ssl.SSLContext | None = None
_ALLOWED_CNS: list[str] = []
_CFG: TLSConfig | None = None  # the installed config, file paths included


def configure(cfg: TLSConfig) -> None:
    """Install mutual TLS process-wide (like the reference's security.toml:
    every listener and every outbound client in the process)."""
    global _SERVER_CTX, _CLIENT_CTX, _ALLOWED_CNS, _CFG
    if cfg.partially_set:
        # fail CLOSED: a typo'd [tls] section must not silently run the
        # cluster as plaintext HTTP (the reference errors on cert-load
        # failure too, tls.go)
        raise ValueError(
            "[tls] needs all of ca, cert and key (allowed_commonNames"
            " alone has nothing to gate); refusing to start without TLS"
        )
    if not cfg.enabled:
        reset()
        return
    server = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    server.load_cert_chain(cfg.cert, cfg.key)
    server.load_verify_locations(cfg.ca)
    server.verify_mode = ssl.CERT_REQUIRED  # mTLS: client must present a cert
    client = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    client.load_cert_chain(cfg.cert, cfg.key)
    client.load_verify_locations(cfg.ca)
    client.check_hostname = False  # identity is the CA + CN, not the address
    client.verify_mode = ssl.CERT_REQUIRED
    _SERVER_CTX = server
    _CLIENT_CTX = client
    _CFG = cfg
    _ALLOWED_CNS = [
        compile_cn_pattern(s.strip())
        for s in cfg.allowed_common_names.split(",")
        if s.strip()
    ]


def reset() -> None:
    global _SERVER_CTX, _CLIENT_CTX, _ALLOWED_CNS, _CFG
    _SERVER_CTX = None
    _CLIENT_CTX = None
    _ALLOWED_CNS = []
    _CFG = None


def current_config() -> TLSConfig | None:
    """The installed TLSConfig (file paths included), or None."""
    return _CFG


def server_context() -> ssl.SSLContext | None:
    return _SERVER_CTX


def client_context() -> ssl.SSLContext | None:
    return _CLIENT_CTX


def compile_cn_pattern(pattern: str) -> re.Pattern:
    """'*' wildcards anywhere: "volume*", "*.trusted.example", "*"."""
    return re.compile(
        "".join(".*" if c == "*" else re.escape(c) for c in pattern)
    )


def allowed_cn_patterns() -> list[re.Pattern]:
    return list(_ALLOWED_CNS)


def peer_allowed(
    peercert: dict | None, allowed: list[re.Pattern] | None = None
) -> bool:
    """Post-handshake authenticator (reference Authenticator.Authenticate,
    `tls.go`): with no allow-list any CA-valid cert passes; otherwise the
    leaf's CommonName must match an entry. Pass `allowed` to pin a listener
    to the allow-list captured at its start (runtime reconfiguration must
    not silently relax a running server)."""
    patterns = _ALLOWED_CNS if allowed is None else allowed
    if not patterns:
        return True
    if not peercert:
        return False
    cn = ""
    for rdn in peercert.get("subject", ()):  # ((('commonName','x'),), ...)
        for key, value in rdn:
            if key == "commonName":
                cn = value
    return any(p.fullmatch(cn) for p in patterns)
