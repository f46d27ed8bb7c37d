"""Leveled logging in the glog style (`weed/glog/glog.go`).

`v(2).info(...)` logs only when the process verbosity is >= 2; errors and
warnings always log. Optional file output with size-based rotation
(MaxSize/MaxFileCount, `weed/weed.go:51-52`).
"""

from __future__ import annotations

import os
import sys
import threading
import time

_lock = threading.Lock()
_verbosity = int(os.environ.get("SEAWEEDFS_TPU_V", "0"))
_out = sys.stderr
_log_file: str | None = None
_max_size = 100 * 1024 * 1024
_max_files = 5


def set_verbosity(v: int) -> None:
    global _verbosity
    _verbosity = v


def set_output_file(path: str, max_size: int = _max_size, max_files: int = 5) -> None:
    global _log_file, _max_size, _max_files
    _log_file = path
    _max_size = max_size
    _max_files = max_files


def _rotate() -> None:
    if _log_file is None:
        return
    try:
        if os.path.getsize(_log_file) < _max_size:
            return
    except OSError:
        return
    for i in range(_max_files - 1, 0, -1):
        src = f"{_log_file}.{i}" if i > 1 else _log_file
        dst = f"{_log_file}.{i + 1}" if i > 1 else f"{_log_file}.1"
        if os.path.exists(src):
            os.replace(src, dst)


def _emit(level: str, msg: str, args: tuple) -> None:
    if args:
        msg = msg % args
    line = (
        f"{level}{time.strftime('%m%d %H:%M:%S')} "
        f"{threading.get_ident() % 100000:05d} {msg}\n"
    )
    with _lock:
        if _log_file is not None:
            _rotate()
            with open(_log_file, "a") as f:
                f.write(line)
        else:
            _out.write(line)


def info(msg: str, *args) -> None:
    _emit("I", msg, args)


def warning(msg: str, *args) -> None:
    _emit("W", msg, args)


def error(msg: str, *args) -> None:
    _emit("E", msg, args)


class _V:
    def __init__(self, level: int) -> None:
        self.enabled = level <= _verbosity

    def info(self, msg: str, *args) -> None:
        if self.enabled:
            _emit("I", msg, args)


def v(level: int) -> _V:
    return _V(level)
