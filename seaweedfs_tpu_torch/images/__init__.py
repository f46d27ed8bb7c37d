"""Image resize/crop on read + EXIF orientation fix on upload.

The port's copy of `seaweedfs_tpu/images/__init__.py`: a behavioral port
of `weed/images/resizing.go` (GET `?width=&height=&mode=`: "" = fit
preserving aspect, "fit" = letterbox pad, "fill" = cover+crop) and
`weed/images/orientation.go` (JPEG uploads are rewritten upright when EXIF
says the camera was rotated), hooked where the reference hooks them
(`volume_server_handlers_read.go:310-370`, `needle.go:101-106`).

Host code: Pillow, imported lazily; every function returns the original
bytes on any error, `ImportError` included, like the reference.
"""

from __future__ import annotations

import io

RESIZABLE_MIME = {"image/jpeg", "image/png", "image/gif", "image/webp"}

_FORMAT_BY_MIME = {
    "image/jpeg": "JPEG",
    "image/png": "PNG",
    "image/gif": "GIF",
    "image/webp": "WEBP",
}

# EXIF 274 = Orientation; PIL transpose ops per value
_ORIENT_OPS = {
    2: ["FLIP_LEFT_RIGHT"],
    3: ["ROTATE_180"],
    4: ["FLIP_TOP_BOTTOM"],
    5: ["FLIP_LEFT_RIGHT", "ROTATE_270"],
    6: ["ROTATE_270"],
    7: ["FLIP_LEFT_RIGHT", "ROTATE_90"],
    8: ["ROTATE_90"],
}


def resized(data: bytes, mime: str, width: int | None, height: int | None,
            mode: str = "") -> bytes:
    """`resizing.go Resized`: scale to width/height; one dimension given →
    preserve aspect; mode "fit" letterboxes, "fill" covers and center-crops."""
    if mime not in RESIZABLE_MIME or (not width and not height):
        return data
    try:
        from PIL import Image

        img = Image.open(io.BytesIO(data))
        ow, oh = img.size
        w, h = width or 0, height or 0
        if w <= 0 and h <= 0:
            return data
        if w <= 0:
            w = max(1, ow * h // oh)
        if h <= 0:
            h = max(1, oh * w // ow)
        fmt = _FORMAT_BY_MIME.get(mime, img.format or "PNG")
        if mode == "fill":
            # cover: scale so both dims >= target, center-crop
            scale = max(w / ow, h / oh)
            nw, nh = max(1, round(ow * scale)), max(1, round(oh * scale))
            img = img.resize((nw, nh), Image.LANCZOS)
            left, top = (nw - w) // 2, (nh - h) // 2
            img = img.crop((left, top, left + w, top + h))
        elif mode == "fit":
            # letterbox inside w×h
            scale = min(w / ow, h / oh)
            nw, nh = max(1, round(ow * scale)), max(1, round(oh * scale))
            img = img.resize((nw, nh), Image.LANCZOS)
            canvas = Image.new(
                "RGBA" if fmt == "PNG" else "RGB", (w, h),
                (255, 255, 255, 0) if fmt == "PNG" else (255, 255, 255),
            )
            canvas.paste(img, ((w - nw) // 2, (h - nh) // 2))
            img = canvas
        else:
            # plain proportional scale (both given: use them as-is — the
            # reference resizes to the exact wxh when both are set)
            if width and height:
                img = img.resize((w, h), Image.LANCZOS)
            else:
                scale = w / ow if width else h / oh
                img = img.resize(
                    (max(1, round(ow * scale)), max(1, round(oh * scale))),
                    Image.LANCZOS,
                )
        if fmt == "JPEG" and img.mode not in ("RGB", "L"):
            img = img.convert("RGB")
        buf = io.BytesIO()
        img.save(buf, fmt)
        return buf.getvalue()
    except Exception:
        return data


def fix_jpg_orientation(data: bytes) -> bytes:
    """`orientation.go FixJpgOrientation`: bake the EXIF rotation into the
    pixels so downstream consumers need no EXIF support."""
    try:
        from PIL import Image

        img = Image.open(io.BytesIO(data))
        if (img.format or "").upper() != "JPEG":
            return data
        exif = img.getexif()
        orientation = exif.get(274, 1)
        if orientation in (0, 1):
            return data
        for opname in _ORIENT_OPS.get(orientation, []):
            img = img.transpose(getattr(Image.Transpose, opname))
        exif[274] = 1
        buf = io.BytesIO()
        img.save(buf, "JPEG", quality=95, exif=exif.tobytes())
        return buf.getvalue()
    except Exception:
        return data
