"""The port's `util/config.py` and `util/grace.py` against the JAX package's:
TOML discovery over the same search directories, an `on_interrupt` hook on
SIGTERM in a child process of each package (same exit code, hook ran), and
`setup_profiling`'s CPU and memory dumps at exit."""

from __future__ import annotations

import os
import pstats
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import seaweedfs_tpu.util.config as ref_cfg
from seaweedfs_tpu_torch.util import config as cfg

REPO = Path(__file__).resolve().parents[1]
PACKAGES = ("seaweedfs_tpu", "seaweedfs_tpu_torch")


def test_search_dirs_equal_reference():
    assert cfg.SEARCH_DIRS == ref_cfg.SEARCH_DIRS


@pytest.mark.parametrize("name", ["demo", "demo.toml", "only_late", "absent"])
def test_search_order_equal_reference(tmp_path, monkeypatch, name):
    """The first directory holding the file wins, in both packages."""
    dirs = [tmp_path / d for d in ("cwd", "home", "etc")]
    for d in dirs:
        d.mkdir()
    (dirs[1] / "demo.toml").write_text("[top]\nkey = 'home'\nn = 2\n")
    (dirs[2] / "demo.toml").write_text("[top]\nkey = 'etc'\n")
    (dirs[2] / "only_late.toml").write_text("[a.b]\nlist = [1, 2]\n")
    for mod in (cfg, ref_cfg):
        monkeypatch.setattr(mod, "SEARCH_DIRS", [str(d) for d in dirs])
    assert cfg.resolve_config_path(name) == ref_cfg.resolve_config_path(name)
    assert cfg.load_configuration(name) == ref_cfg.load_configuration(name)
    if name == "absent":
        for mod in (cfg, ref_cfg):
            with pytest.raises(FileNotFoundError):
                mod.load_configuration(name, required=True)
    else:
        assert cfg.load_configuration(name, required=True)


def _child(code: str, tmp_path: Path) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=str(tmp_path),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGINT])
def test_on_interrupt_hook_runs_with_reference_exit_code(tmp_path, sig):
    """A child of each package registers two hooks and blocks; the signal
    runs both, newest first, and both children exit with one code."""
    results = {}
    for pkg in PACKAGES:
        out = tmp_path / f"{pkg}.txt"
        p = _child(f"""
            import time
            from {pkg}.util import grace
            def hook(tag):
                with open({str(out)!r}, "a") as f:
                    f.write(tag + "\\n")
            grace.on_interrupt(lambda: hook("first"))
            grace.on_interrupt(lambda: hook("second"))
            print("ready", flush=True)
            time.sleep(60)
        """, tmp_path)
        try:
            assert p.stdout.readline().strip() == "ready", p.stderr.read()
            p.send_signal(sig)
            rc = p.wait(15)
        finally:
            p.kill()
            p.communicate()
        results[pkg] = (rc, out.read_text().split())
    assert results["seaweedfs_tpu_torch"] == results["seaweedfs_tpu"]
    rc, order = results["seaweedfs_tpu_torch"]
    assert order == ["second", "first"]
    assert rc != 0


def test_setup_profiling_dumps_at_exit(tmp_path):
    """`setup_profiling` writes a cProfile dump that `pstats` loads and a
    tracemalloc top list of at most 100 lines when the process exits."""
    cpu, mem = tmp_path / "cpu.prof", tmp_path / "mem.txt"
    p = _child(f"""
        from seaweedfs_tpu_torch.util import grace
        grace.setup_profiling({str(cpu)!r}, {str(mem)!r})
        def work():
            return [bytes(64) * (i % 7) for i in range(20000)]
        keep = [work() for _ in range(5)]
        print(sum(len(k) for k in keep))
    """, tmp_path)
    out, err = p.communicate(timeout=60)
    assert p.returncode == 0, err
    stats = pstats.Stats(str(cpu))
    assert any(fn[2] == "work" for fn in stats.stats), "work() not profiled"
    lines = mem.read_text().splitlines()
    assert 0 < len(lines) <= 100
    assert all("size=" in ln for ln in lines)
