"""security.toml discovery + parsing (`weed/util/config.go:40-60`).

The port's copy of `seaweedfs_tpu/security/config.py`: the same discovery
order, keys and fields as `weed scaffold -config=security`.

Search order mirrors the reference: ./, ~/.seaweedfs, /etc/seaweedfs.
Schema subset:

    [jwt.signing]        # write tokens (master -> volume)
    key = "..."
    expires_after_seconds = 10

    [jwt.signing.read]   # read tokens
    key = "..."
    expires_after_seconds = 60

    [guard]
    white_list = ["127.0.0.1", "10.0.0.0/8"]

    [tls]                # mutual TLS on every listener + outbound client
    ca = "ca.pem"
    cert = "server.pem"
    key = "server.key"
    allowed_commonNames = "master1,volume*"   # "" = any cert the CA signed
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class SecurityConfig:
    write_key: str = ""
    write_expires_sec: int = 10
    read_key: str = ""
    read_expires_sec: int = 60
    white_list: list[str] = field(default_factory=list)
    # [tls] — mutual TLS for every listener + client (`weed/security/tls.go`)
    tls_ca: str = ""
    tls_cert: str = ""
    tls_key: str = ""
    tls_allowed_common_names: str = ""

    @property
    def enabled(self) -> bool:
        return bool(self.write_key or self.read_key or self.white_list)

    def apply_tls(self) -> None:
        """Install the [tls] section process-wide (no-op when unset)."""
        from . import tls as tls_mod

        tls_mod.configure(
            tls_mod.TLSConfig(
                ca=self.tls_ca,
                cert=self.tls_cert,
                key=self.tls_key,
                allowed_common_names=self.tls_allowed_common_names,
            )
        )


def load_security_config(path: str | None = None) -> SecurityConfig:
    candidates = (
        [path]
        if path
        else [
            "./security.toml",
            os.path.expanduser("~/.seaweedfs/security.toml"),
            "/etc/seaweedfs/security.toml",
        ]
    )
    try:
        import tomllib
    except ModuleNotFoundError:  # py<3.11: same-format tomli fallback
        try:
            import tomli as tomllib
        except ModuleNotFoundError:
            # a security.toml that EXISTS but cannot be parsed must fail
            # loudly — silently booting with no auth/whitelist is worse
            found = [c for c in candidates if c and os.path.exists(c)]
            if found:
                raise RuntimeError(
                    f"cannot parse {found[0]}: needs tomllib (python >="
                    " 3.11) or the tomli package; this interpreter has"
                    " neither"
                )
            return SecurityConfig()
    for cand in candidates:
        if cand and os.path.exists(cand):
            with open(cand, "rb") as f:
                data = tomllib.load(f)
            jwt_sign = data.get("jwt", {}).get("signing", {})
            read = jwt_sign.get("read", {})
            tls_sec = data.get("tls", {})
            return SecurityConfig(
                write_key=jwt_sign.get("key", ""),
                write_expires_sec=int(jwt_sign.get("expires_after_seconds", 10)),
                read_key=read.get("key", ""),
                read_expires_sec=int(read.get("expires_after_seconds", 60)),
                white_list=list(data.get("guard", {}).get("white_list", [])),
                tls_ca=tls_sec.get("ca", ""),
                tls_cert=tls_sec.get("cert", ""),
                tls_key=tls_sec.get("key", ""),
                tls_allowed_common_names=tls_sec.get("allowed_commonNames", ""),
            )
    return SecurityConfig()
