"""JPEG EXIF orientation on upload, `?width=`/`?height=` resize on read, and
the GIL switch interval a started HTTP service leaves, the port against
the JAX package.

A seeded 16x8 RGB JPEG carrying EXIF Orientation 6 goes to a JAX and a
port volume server (the JAX one with `SEAWEEDFS_TPU_DISABLE_FASTLANE=1`,
so its Python handlers answer); the stored `.dat`/`.idx`, the plain GET
and the resized GETs must be equal byte for byte, and a `type=replicate`
write must be stored as sent. The image helpers themselves are held equal
on every orientation and resize mode. Tolerance 0 throughout.
"""

from __future__ import annotations

import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from seaweedfs_tpu import images as ref_images
from seaweedfs_tpu_torch import images
from seaweedfs_tpu_torch.server.httpd import http_request
from tests.test_torch_volume_admin import (
    allocate,
    fid,
    pinned_clock,
    same_bytes,
    twin,
)

Image = pytest.importorskip("PIL.Image")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def exif_jpeg(seed: int, orientation: int = 6, size=(16, 8)) -> bytes:
    """A seeded RGB JPEG with EXIF tag 274 (Orientation) set."""
    rng = np.random.default_rng(seed)
    pixels = rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
    img = Image.fromarray(pixels, "RGB")
    exif = Image.Exif()
    exif[274] = orientation
    buf = io.BytesIO()
    img.save(buf, "JPEG", exif=exif.tobytes())
    return buf.getvalue()


def png(seed: int, size=(12, 10)) -> bytes:
    rng = np.random.default_rng(seed)
    pixels = rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(pixels, "RGB").save(buf, "PNG")
    return buf.getvalue()


# --- the helpers ---------------------------------------------------------------
@pytest.mark.parametrize("orientation", range(0, 9))
def test_fix_jpg_orientation_equals_reference(orientation):
    data = exif_jpeg(orientation, orientation)
    out = images.fix_jpg_orientation(data)
    assert out == ref_images.fix_jpg_orientation(data)
    if orientation in (0, 1):
        assert out == data
    else:
        got = Image.open(io.BytesIO(out))
        assert got.getexif().get(274) == 1
        want = (8, 16) if orientation >= 5 else (16, 8)
        assert got.size == want


@pytest.mark.parametrize("mime,make", [
    ("image/jpeg", lambda s: exif_jpeg(s, 1)),
    ("image/png", png),
])
@pytest.mark.parametrize("width,height,mode", [
    (4, None, ""), (None, 5, ""), (6, 3, ""), (6, 3, "fit"), (6, 3, "fill"),
    (None, None, ""),
])
def test_resized_equals_reference(mime, make, width, height, mode):
    data = make(3)
    out = images.resized(data, mime, width, height, mode)
    assert out == ref_images.resized(data, mime, width, height, mode)
    if width or height:
        got = Image.open(io.BytesIO(out))
        if width and height:
            assert got.size == (width, height)
        elif width:
            assert got.size[0] == width
        else:
            assert got.size[1] == height
    else:
        assert out == data


def test_helpers_return_input_on_bad_bytes():
    junk = b"\xff\xd8 not really a jpeg"
    assert images.fix_jpg_orientation(junk) == junk
    assert images.resized(junk, "image/jpeg", 4, None) == junk
    assert images.resized(junk, "text/plain", 4, None) == junk


# --- through the volume servers -----------------------------------------------
def _post(url: str, data: bytes, mime: str, query: str = "") -> dict:
    import json

    status, _, body = http_request(
        "POST", url + query, data, {"Content-Type": mime})
    assert status == 201, body
    return json.loads(body)


def _get(url: str) -> tuple[int, dict, bytes]:
    status, headers, body = http_request("GET", url)
    return status, {k.lower(): v for k, v in headers.items()}, body


def test_exif_jpeg_upload_and_resized_reads_equal_reference():
    data = exif_jpeg(0)
    with twin(racks=("r1",)) as (ref, port):
        for side in (ref, port):
            allocate(side, 1, [0])
        answers = {}
        with pinned_clock():
            for name, side in (("ref", ref), ("port", port)):
                answers[name] = _post(f"{side.url(0)}/{fid(1, 5)}", data,
                                      "image/jpeg")
        assert answers["port"] == answers["ref"]
        assert answers["port"]["size"] != len(data)  # rewritten upright
        v_ref = ref.servers[0].store.get_volume(1)
        v_port = port.servers[0].store.get_volume(1)
        for ext in (".dat", ".idx"):
            assert same_bytes(v_port.base_name + ext, v_ref.base_name + ext), ext
        for query in ("", "?width=4", "?height=4", "?width=6&height=3&mode=fill",
                      "?width=6&height=3&mode=fit", "?width=bad"):
            got_ref = _get(f"{ref.url(0)}/{fid(1, 5)}{query}")
            got_port = _get(f"{port.url(0)}/{fid(1, 5)}{query}")
            assert got_port[0] == got_ref[0] == 200, query
            assert got_port[2] == got_ref[2], query
            assert got_port[1].get("content-type") == \
                got_ref[1].get("content-type"), query
        img = Image.open(io.BytesIO(_get(f"{port.url(0)}/{fid(1, 5)}")[2]))
        assert img.size == (8, 16) and img.getexif().get(274) == 1
        small = Image.open(io.BytesIO(
            _get(f"{port.url(0)}/{fid(1, 5)}?width=4")[2]))
        assert small.size == (4, 8)


def test_replicate_write_is_stored_as_sent():
    data = exif_jpeg(1)
    with twin(racks=("r1",)) as (ref, port):
        for side in (ref, port):
            allocate(side, 2, [0])
        with pinned_clock():
            for side in (ref, port):
                out = _post(f"{side.url(0)}/{fid(2, 7)}", data, "image/jpeg",
                            "?type=replicate")
                assert out["size"] == len(data)
        for side in (ref, port):
            assert _get(f"{side.url(0)}/{fid(2, 7)}")[2] == data
        for ext in (".dat", ".idx"):
            assert same_bytes(port.servers[0].store.get_volume(2).base_name + ext,
                              ref.servers[0].store.get_volume(2).base_name + ext)


def test_non_image_is_not_resized():
    body = b"plain bytes " * 20
    with twin(racks=("r1",)) as (ref, port):
        for side in (ref, port):
            allocate(side, 3, [0])
            _post(f"{side.url(0)}/{fid(3, 9)}", body, "text/plain")
            assert _get(f"{side.url(0)}/{fid(3, 9)}?width=4")[2] == body


# --- the GIL switch interval ---------------------------------------------------
_SWITCH_PROBE = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    from {pkg}.server.httpd import HTTPService
    before = sys.getswitchinterval()
    a = HTTPService("127.0.0.1", 0)
    a.start()
    first = sys.getswitchinterval()
    sys.setswitchinterval(0.002)
    b = HTTPService("127.0.0.1", 0)
    b.start()  # once per process: a second start leaves it alone
    second = sys.getswitchinterval()
    a.stop(); b.stop()
    print(before, first, second)
""")


def _probe(pkg: str, env_value: str | None) -> tuple[float, float, float]:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               SEAWEEDFS_TPU_DISABLE_FASTLANE="1")
    env.pop("SEAWEEDFS_TPU_SWITCH_INTERVAL", None)
    if env_value is not None:
        env["SEAWEEDFS_TPU_SWITCH_INTERVAL"] = env_value
    out = subprocess.run(
        [sys.executable, "-c", _SWITCH_PROBE.format(repo=REPO, pkg=pkg)],
        env=env, capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    return tuple(float(x) for x in out.stdout.split()[-3:])


@pytest.mark.parametrize("env_value,want", [
    (None, 0.0005), ("0.001", 0.001), ("0", 0.005), ("nonsense", 0.005),
])
def test_started_service_sets_switch_interval_like_reference(env_value, want):
    before = sys.getswitchinterval()
    port = _probe("seaweedfs_tpu_torch", env_value)
    ref = _probe("seaweedfs_tpu", env_value)
    assert port == ref
    assert port[0] == 0.005
    assert port[1] == pytest.approx(want, rel=0, abs=1e-9)
    assert port[2] == 0.002
    assert sys.getswitchinterval() == before  # this process untouched
