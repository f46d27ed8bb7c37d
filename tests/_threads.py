"""Teardown shared by the port's test files.

A module's servers start the process's metrics-history loop
(`HTTPService.enable_metrics`), and a JAX twin starts the JAX package's; each
scrapes every few seconds on a thread of its own. The JAX package's
allocation guards (`tests/test_faults.py`, `tests/test_events.py`) count every
thread's allocations, so no loop may outlive the module that started it:
import `stop_history_loops` into a test module to stop both when it is done.
"""

from __future__ import annotations

import pytest


@pytest.fixture(autouse=True, scope="module")
def stop_history_loops():
    yield
    from seaweedfs_tpu.stats import history as ref_history
    from seaweedfs_tpu_torch.stats import history

    history.default_history().stop()
    ref_history.default_history().stop()
