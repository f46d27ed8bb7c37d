"""Watchdogged device probes.

A device call can wedge (a lost card, a device stuck in a reset), so the
status report goes through these helpers with a watchdog: a dead device is
a reported fact, not a hung server thread. The stuck worker thread is a
daemon: it parks on the device call and never holds a lock the rest of the
process needs.

The JAX package's copy also gates its auto-tuners' backend choice on the
measured link rate (`link_fast_enough`). The port makes no backend choice
from it: a path that asked for the card runs there or raises, so these only
report `torch.cuda` status and the host-to-device rate, under the same keys.
"""

from __future__ import annotations

import threading
import time

def run_with_timeout(fn, seconds: float):
    """Run fn() on a daemon thread; raise TimeoutError if it outlives
    `seconds`. The abandoned thread keeps running (device calls are not
    cancellable) but owns no shared state."""
    out: dict = {}
    done = threading.Event()

    def target():  # pragma: no cover - trivial wrapper
        try:
            out["v"] = fn()
        except BaseException as e:  # noqa: BLE001 - reraised below
            out["e"] = e
        finally:
            done.set()

    t = threading.Thread(target=target, daemon=True, name="device-probe")
    t.start()
    if not done.wait(seconds):
        raise TimeoutError(f"device probe exceeded {seconds}s")
    if "e" in out:
        raise out["e"]
    return out["v"]


def device_platform(timeout: float = 20.0) -> str | None:
    """"cuda" when torch sees a CUDA device (checked under a watchdog);
    None if torch is missing, no device is there, or the probe wedged."""
    try:
        import torch

        up = run_with_timeout(torch.cuda.is_available, timeout)
        return "cuda" if up else None
    except Exception:
        return None


def probe_device_status(
    retries: int = 2, timeout: float = 20.0, min_rate: float = 1e9
) -> dict:
    """Structured device-status report: a down device must be a reported
    fact, not a missing key.

    Returns {"status": "up"|"relay-degraded"|"down", "h2d_mbps": float|None,
    "attempts": n}. Each attempt re-probes from scratch; an attempt that
    finds no CUDA device short-circuits to "down". "relay-degraded" keeps
    the JAX key for a device that answers with host->device bandwidth below
    `min_rate` bytes/s.
    """
    attempts = 0
    for i in range(1 + max(0, retries)):
        attempts += 1
        if device_platform(timeout=timeout) is None:
            return {"status": "down", "h2d_mbps": None, "attempts": attempts}
        rate = h2d_rate(timeout=timeout)
        if rate is not None:
            status = "up" if rate >= min_rate else "relay-degraded"
            return {
                "status": status,
                "h2d_mbps": round(rate / 1e6, 1),
                "attempts": attempts,
            }
        time.sleep(2.0 * (i + 1))  # platform up but transfer wedged: retry
    return {"status": "down", "h2d_mbps": None, "attempts": attempts}


def h2d_rate(timeout: float = 20.0, probe_bytes: int = 4 * 1024 * 1024):
    """Measured host->device bandwidth in bytes/s (pageable source, the
    median of three copies), or None when torch/CUDA is unavailable or the
    copy wedged beyond `timeout`."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None

        def measure() -> float:
            torch.zeros(65536, dtype=torch.uint8).to("cuda")
            torch.cuda.synchronize()
            probe = torch.zeros(probe_bytes, dtype=torch.uint8)
            rates = []
            for _ in range(3):
                t0 = time.perf_counter()
                probe.to("cuda")
                torch.cuda.synchronize()
                rates.append(probe_bytes / (time.perf_counter() - t0))
            return sorted(rates)[1]

        return run_with_timeout(measure, timeout)
    except Exception:
        return None
