"""HS256 JWT, stdlib-only (hmac + sha256 + base64url).

The port's copy of `seaweedfs_tpu/security/jwt.py`: the same header, claim
layout and JSON separators, so a token minted by either package verifies
in the other, byte for byte under one clock.

Token shape mirrors the reference's SeaweedFileIdClaims
(`weed/security/jwt.go:17-28`): registered claim `exp` plus a private `fid`
claim binding the token to one file id, so a leaked token cannot be replayed
against other needles.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time


class JwtError(Exception):
    pass


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64url(s: str) -> bytes:
    pad = -len(s) % 4
    return base64.urlsafe_b64decode(s + "=" * pad)


def encode_jwt(key: bytes | str, claims: dict) -> str:
    if isinstance(key, str):
        key = key.encode()
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64url(json.dumps(claims, separators=(",", ":")).encode())
    signing_input = f"{header}.{payload}".encode()
    sig = hmac.new(key, signing_input, hashlib.sha256).digest()
    return f"{header}.{payload}.{_b64url(sig)}"


def decode_jwt(key: bytes | str, token: str) -> dict:
    """Verify signature + expiry, return the claims dict."""
    if isinstance(key, str):
        key = key.encode()
    try:
        header_s, payload_s, sig_s = token.split(".")
    except ValueError:
        raise JwtError("malformed token")
    header = json.loads(_unb64url(header_s))
    if header.get("alg") != "HS256":
        raise JwtError(f"unsupported alg {header.get('alg')}")
    signing_input = f"{header_s}.{payload_s}".encode()
    want = hmac.new(key, signing_input, hashlib.sha256).digest()
    if not hmac.compare_digest(want, _unb64url(sig_s)):
        raise JwtError("bad signature")
    claims = json.loads(_unb64url(payload_s))
    exp = claims.get("exp")
    if exp is not None and time.time() > exp:
        raise JwtError("token expired")
    return claims


def gen_write_jwt(key: bytes | str, fid: str, expires_sec: int = 10) -> str:
    """Master-side: sign a write token for one file id
    (`weed/security/jwt.go GenJwtForVolumeServer`)."""
    if not key:
        return ""
    return encode_jwt(key, {"fid": fid, "exp": int(time.time()) + expires_sec})


def gen_read_jwt(key: bytes | str, fid: str, expires_sec: int = 60) -> str:
    if not key:
        return ""
    return encode_jwt(key, {"fid": fid, "exp": int(time.time()) + expires_sec})


def verify_file_jwt(key: bytes | str, token: str, fid: str) -> bool:
    """Volume-server-side check (`weed/server/volume_server_handlers.go:33-75`):
    signature valid, not expired, and the fid claim matches this request
    (an empty fid claim is a wildcard token, as in the reference's filer JWT)."""
    try:
        claims = decode_jwt(key, token)
    except Exception:
        # malformed base64/JSON from a hostile token must read as
        # unauthorized, not a 500
        return False
    claimed = claims.get("fid", "")
    return claimed == "" or claimed == fid


def token_from_request(headers, query: dict) -> str:
    """Authorization: BEARER <jwt> header, else ?jwt= query param."""
    auth = headers.get("Authorization", "") if headers else ""
    if auth.lower().startswith("bearer "):
        return auth[7:].strip()
    return query.get("jwt", "")
