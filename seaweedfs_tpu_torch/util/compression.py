"""Chunk compression: gzip + zstd with compressability heuristics.

Behavioral port of `weed/util/compression.go`: uploads compress chunk data
when the mime/extension says it is worth it (`IsCompressableFileType`
compression.go:60-90) and the compressed form actually shrinks; reads
auto-detect by magic bytes (`IsGzippedData`, `IsZstdData`) and decompress.
zstd rides the `zstandard` package (the reference vendors klauspost/compress).
The port's copy of `seaweedfs_tpu/util/compression.py`.
"""

from __future__ import annotations

import gzip

try:
    import zstandard as _zstd

    _ZSTD_C = _zstd.ZstdCompressor(level=3)
    _ZSTD_D = _zstd.ZstdDecompressor()
except Exception:  # pragma: no cover - zstd is baked into the image
    _zstd = None

GZIP_MAGIC = b"\x1f\x8b"
ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

# mirror of compression.go:60-90's switch tables; .pdf counts as
# compressable both by extension and by mime, matching the reference's
# IsCompressableFileType (compression.go:121)
_UNCOMPRESSABLE_EXT = {
    ".zip", ".rar", ".gz", ".bz2", ".xz", ".zst", ".br",  # already compressed
}
_TEXT_EXT = {
    ".csv", ".txt", ".json", ".xml", ".html", ".htm", ".css", ".js", ".log",
    ".md", ".yaml", ".yml", ".toml", ".svg", ".conf", ".ini", ".py", ".go",
    ".java", ".c", ".cpp", ".h", ".rs", ".ts", ".sql", ".sh", ".pdf",
}
_UNCOMPRESSABLE_MIME_PREFIX = ("video/", "audio/", "image/")
_UNCOMPRESSABLE_MIME = {
    "application/zip", "application/gzip", "application/x-gzip",
    "application/zstd", "application/x-rar-compressed",
    "application/x-7z-compressed", "application/x-xz",
}
_COMPRESSABLE_MIME = {
    "application/json", "application/xml", "application/javascript",
    "application/x-javascript", "application/toml", "application/pdf",
}


def is_gzipped_data(data: bytes) -> bool:
    return data[:2] == GZIP_MAGIC


def is_zstd_data(data: bytes) -> bool:
    return data[:4] == ZSTD_MAGIC


def is_compressed(data: bytes) -> bool:
    return is_gzipped_data(data) or is_zstd_data(data)


def is_compressable_file_type(ext: str, mime: str) -> bool:
    """Heuristic from `compression.go:60-90`: compress text-ish content,
    skip media and archive formats."""
    ext = ext.lower()
    mime = mime.split(";")[0].strip().lower()
    if ext in _UNCOMPRESSABLE_EXT:
        return False
    if mime in _UNCOMPRESSABLE_MIME:
        return False
    if mime.startswith(_UNCOMPRESSABLE_MIME_PREFIX):
        return False
    if ext in _TEXT_EXT:
        return True
    if mime.startswith("text/"):
        return True
    return mime in _COMPRESSABLE_MIME


def gzip_data(data: bytes) -> bytes:
    return gzip.compress(data, compresslevel=3)


def zstd_data(data: bytes) -> bytes:
    if _zstd is None:  # pragma: no cover
        return gzip_data(data)
    return _ZSTD_C.compress(data)


def maybe_compress_data(data: bytes, mime: str = "", ext: str = "",
                        method: str = "gzip") -> tuple[bytes, bool]:
    """Compress when the type heuristic says yes AND it actually shrinks
    (`MaybeGzipData` semantics). Returns (payload, is_compressed)."""
    if len(data) < 128:
        return data, False
    if not is_compressable_file_type(ext, mime):
        return data, False
    packed = zstd_data(data) if method == "zstd" else gzip_data(data)
    if len(packed) >= len(data) * 9 // 10:
        return data, False
    return packed, True


def decompress_data(data: bytes) -> bytes:
    """Auto-detect gzip/zstd by magic; pass through raw data unchanged
    (`DecompressData`)."""
    if is_gzipped_data(data):
        return gzip.decompress(data)
    if is_zstd_data(data):
        if _zstd is None:  # pragma: no cover
            raise ValueError("zstd data but zstandard unavailable")
        return _ZSTD_D.decompress(data)
    return data
