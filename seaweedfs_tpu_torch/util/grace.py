"""Graceful shutdown hooks + profiling (`weed/util/grace/`): the port's copy
of `seaweedfs_tpu/util/grace.py`.

`on_interrupt` registers cleanup callbacks fired on SIGINT/SIGTERM (and at
interpreter exit); `setup_profiling` mirrors `pprof.go:11` — start a CPU
profile (cProfile) and dump stats + a heap snapshot (tracemalloc) on exit.
"""

from __future__ import annotations

import atexit
import cProfile
import signal
import threading
from typing import Callable

_hooks: list[Callable[[], None]] = []
_lock = threading.Lock()
_installed = False


def _run_hooks(*_args) -> None:
    with _lock:
        hooks, _hooks[:] = _hooks[:], []
    for h in reversed(hooks):
        try:
            h()
        except Exception:
            pass


def _install() -> None:
    global _installed
    if _installed:
        return
    _installed = True
    atexit.register(_run_hooks)
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGINT, signal.SIGTERM):
            prev = signal.getsignal(sig)

            def handler(signum, frame, prev=prev):
                _run_hooks()
                if callable(prev):
                    prev(signum, frame)
                else:
                    raise SystemExit(128 + signum)

            signal.signal(sig, handler)


def on_interrupt(fn: Callable[[], None]) -> None:
    _install()
    with _lock:
        _hooks.append(fn)


def setup_profiling(cpu_profile: str | None = None,
                    mem_profile: str | None = None) -> None:
    """`grace.SetupProfiling`: cpu → cProfile dump at exit; mem →
    tracemalloc snapshot at exit."""
    if cpu_profile:
        prof = cProfile.Profile()
        prof.enable()

        def dump_cpu():
            prof.disable()
            prof.dump_stats(cpu_profile)

        on_interrupt(dump_cpu)
    if mem_profile:
        import tracemalloc

        tracemalloc.start()

        def dump_mem():
            snap = tracemalloc.take_snapshot()
            with open(mem_profile, "w") as f:
                for stat in snap.statistics("lineno")[:100]:
                    f.write(str(stat) + "\n")

        on_interrupt(dump_mem)
