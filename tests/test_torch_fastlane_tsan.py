"""Sanitizer builds of the port's fastlane engine: the native-code arm of
the race detection (the reference leans on Go's -race).

Builds the port's `csrc/fastlane_sanity.cpp` (a standalone harness that
stands up a real engine and a backend and hammers it from concurrent
threads) with the engine's own sources, as `ops/_build.FASTLANE` lists
them, under ThreadSanitizer and AddressSanitizer, and requires a clean
exit: a data race, use-after-free or leak in the engine fails the run.
Skips only where g++ or the sanitizer's runtime is missing.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import pytest

from seaweedfs_tpu_torch.ops import _build

SOURCES = ["fastlane_sanity.cpp", *_build.FASTLANE.files]


@pytest.mark.parametrize("sanitizer", ["thread", "address,undefined"])
def test_sanitizer_run_is_clean(tmp_path, sanitizer):
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    out = str(tmp_path / f"fl_{sanitizer.replace(',', '_')}")
    cmd = [
        "g++", "-O1", "-g", "-std=c++17", f"-fsanitize={sanitizer}",
        "-DSW_FASTLANE_SANITY_MAIN",
        *[str(_build.CSRC_DIR / f) for f in SOURCES],
        "-o", out, *_build.FASTLANE.libs,
    ]
    build = subprocess.run(cmd, capture_output=True, timeout=300)
    if build.returncode != 0:
        err = build.stderr.decode(errors="replace")
        if "cannot find" in err and "san" in err:  # no sanitizer runtime
            pytest.skip(f"{sanitizer} runtime unavailable: {err[:200]}")
        raise AssertionError(f"sanitizer build failed:\n{err[-3000:]}")
    env = dict(os.environ, TSAN_OPTIONS="halt_on_error=1 exitcode=66",
               ASAN_OPTIONS="detect_leaks=1 exitcode=66")
    scratch = tmp_path / "scratch"  # the harness's .dat, .idx and journal
    scratch.mkdir()
    run = subprocess.run([out, str(scratch)], capture_output=True, timeout=300, env=env)
    tail = run.stderr.decode(errors="replace")[-3000:]
    assert run.returncode == 0, f"{sanitizer} run rc={run.returncode}:\n{tail}"
    assert "fastlane sanity OK" in tail
    assert list(scratch.iterdir()) == []  # every scratch file unlinked
