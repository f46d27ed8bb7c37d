"""AES-256-GCM chunk encryption (`weed/util/cipher.go`).

The reference encrypts each chunk with a fresh random key when the filer
runs with `-encryptVolumeData`; the per-chunk key lives only in filer
metadata (FileChunk.cipher_key), so volume servers store ciphertext they
cannot read. Same layout here: 12-byte nonce || ciphertext || 16-byte tag,
key is 32 random bytes. AES runs on the host (the CPU's AES
instructions), never on the card.

The port's copy of `seaweedfs_tpu/util/cipher.py`, gated on the
`cryptography` package as the original is.
"""

from __future__ import annotations

import os

try:  # gated: ciphered filers need it, plain filers must import fine
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:  # pragma: no cover - environment-dependent
    AESGCM = None

KEY_SIZE = 32
NONCE_SIZE = 12


def available() -> bool:
    return AESGCM is not None


def _require() -> None:
    if AESGCM is None:
        raise RuntimeError(
            "chunk encryption needs the 'cryptography' package, which is"
            " not installed; run the filer without -encryptVolumeData"
        )


def gen_cipher_key() -> bytes:
    return os.urandom(KEY_SIZE)


def encrypt(data: bytes, key: bytes | None = None) -> tuple[bytes, bytes]:
    """Returns (nonce||ciphertext||tag, key). Fresh key per chunk when none
    given (`Encrypt` cipher.go)."""
    _require()
    if key is None:
        key = gen_cipher_key()
    nonce = os.urandom(NONCE_SIZE)
    ct = AESGCM(key).encrypt(nonce, data, None)
    return nonce + ct, key


def decrypt(payload: bytes, key: bytes) -> bytes:
    _require()
    if len(payload) < NONCE_SIZE:
        raise ValueError("cipher payload too short")
    nonce, ct = payload[:NONCE_SIZE], payload[NONCE_SIZE:]
    return AESGCM(key).decrypt(nonce, ct, None)
