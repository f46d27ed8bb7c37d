"""RetryPolicy: one exponential-backoff-with-jitter + deadline-budget
policy shared by outbound HTTP hops. The port's copy of
`seaweedfs_tpu/util/retry.py`; in the port the pipelined rebuild plane's
hop forwarders retry under `READ_POLICY`, and its ranged partial fan-in
takes `READ_POLICY.deadline` as its timeout.

One policy, deterministic math (`now=`/`sleep=`/`rng=` injectable),
deadline as a hard budget so no worker can hang forever regardless of how
many attempts remain.

    policy = RetryPolicy(attempts=4, deadline=10.0)
    result = policy.call(do_request, retry_on=(IOError, OSError))

or drive the schedule by hand:

    start = now()
    for attempt in itertools.count():
        try: return fn()
        except IOError:
            delay = policy.delay(attempt)
            if not policy.should_retry(attempt + 1, start, now(), delay):
                raise
            sleep(delay)
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass

# the shared outbound-HTTP timeout default: generous enough for a slow
# admin verb, finite so no call can hang a worker forever (the audit
# rule: every outbound call either passes its own timeout or this one)
DEFAULT_TIMEOUT = 30.0


@dataclass(frozen=True)
class RetryPolicy:
    """attempts: total tries (1 = no retry). base/multiplier/max_delay:
    exponential backoff schedule. jitter: +/- fraction of each delay.
    deadline: wall-clock budget across ALL attempts including their
    backoff sleeps — the hard bound."""

    attempts: int = 3
    base_delay: float = 0.05
    multiplier: float = 2.0
    max_delay: float = 2.0
    jitter: float = 0.5
    deadline: float = DEFAULT_TIMEOUT

    def delay(self, attempt: int, rng: random.Random | None = None) -> float:
        """Backoff before retry number `attempt` (0-based: the delay
        after the first failure is delay(0))."""
        d = min(self.max_delay, self.base_delay * (self.multiplier ** attempt))
        if self.jitter > 0:
            r = (rng or random).random()
            d *= 1.0 + self.jitter * (2.0 * r - 1.0)
        return max(0.0, d)

    def remaining(self, start: float, now: float) -> float:
        """Deadline budget left; clamped at 0."""
        return max(0.0, self.deadline - (now - start))

    def should_retry(self, tried: int, start: float, now: float,
                     next_delay: float = 0.0) -> bool:
        """True when another attempt fits: tries left AND the budget
        still covers the backoff (an attempt that would start past the
        deadline is a hang with extra steps)."""
        if tried >= self.attempts:
            return False
        return self.remaining(start, now) > next_delay

    def call(self, fn, retry_on=(IOError, OSError), now=time.monotonic,
             sleep=time.sleep, rng: random.Random | None = None):
        """Run fn() under this policy. fn gets no args (close over what
        you need); only `retry_on` exceptions retry, everything else —
        and the final failure — propagates."""
        start = now()
        attempt = 0
        while True:
            try:
                return fn()
            except retry_on:
                d = self.delay(attempt, rng)
                attempt += 1
                if not self.should_retry(attempt, start, now(), d):
                    raise
                sleep(d)


# data-plane reads retry fast and give up inside a request budget
READ_POLICY = RetryPolicy(attempts=4, base_delay=0.05, max_delay=1.0,
                          deadline=15.0)
