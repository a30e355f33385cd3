"""Jittered exponential backoff, shared by every retry/poll loop (a copy
of ``nomad_tpu/utils/backoff.py``).

Fixed-interval sleeps synchronize retries into thundering herds: every
worker that lost the broker wakes on the same 50ms boundary, every
client whose server died re-registers on the same 15s boundary.  This
module is the one place retry cadence lives:

- ``Backoff``    — stateful delay generator (full jitter, capped).
- ``retry``      — call a function with bounded, backed-off retries.
- ``wait_until`` — poll a predicate with a ramping interval (replaces
                   fixed ``time.sleep(0.005)`` spin loops: first checks
                   are fast for latency, later ones coarse for CPU).

Determinism: pass ``rng=random.Random(seed)`` and a fake ``sleep`` to
make schedules reproducible in tests.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

__all__ = ["Backoff", "retry", "wait_until"]


class Backoff:
    """Exponential backoff with full jitter (the AWS-style scheme: each
    delay is uniform in ``[floor_n, cap_n]`` where ``cap_n`` doubles per
    attempt and ``floor_n`` never drops below ``base/10`` — a jittered
    near-zero draw must not turn a backoff loop into a spin loop).
    ``jitter=0`` degrades to plain exponential for tests that want exact
    schedules."""

    def __init__(self, base: float = 0.05, factor: float = 2.0,
                 max_delay: float = 5.0, jitter: float = 1.0,
                 rng: Optional[random.Random] = None):
        if base <= 0:
            raise ValueError("base must be positive")
        self.base = base
        self.factor = factor
        self.max_delay = max_delay
        self.jitter = jitter
        self.rng = rng or random.Random()
        self.attempt = 0

    def next_delay(self) -> float:
        """The delay to sleep before the next retry; advances state.
        The exponent is clamped: a long-idle loop that calls this for
        hours must keep getting the cap, not an OverflowError once
        ``factor ** attempt`` leaves float range (found by the chaos
        soak — the overflow silently killed idle worker threads
        mid-run)."""
        ceiling = min(self.max_delay,
                      self.base * (self.factor ** min(self.attempt, 64)))
        self.attempt += 1
        if self.jitter <= 0:
            return ceiling
        # Full jitter over [floor, ceiling].  The floor is clamped to
        # base/10 even at jitter=1.0 so a near-zero draw can't hot-spin
        # a retry loop against a persistently failing dependency.
        floor = min(ceiling, self.base * max(0.1, 1.0 - self.jitter))
        return floor + self.rng.random() * (ceiling - floor)

    def reset(self) -> None:
        self.attempt = 0


def retry(fn: Callable, retries: int = 3,
          retry_on: Tuple[Type[BaseException], ...] = (Exception,),
          backoff: Optional[Backoff] = None,
          sleep: Callable[[float], None] = time.sleep,
          on_retry: Optional[Callable[[BaseException, int], None]] = None):
    """Call ``fn()`` with up to ``retries`` retried failures (so at most
    ``retries + 1`` calls).  ``on_retry(exc, attempt)`` observes each
    failure before the backed-off sleep; the final failure re-raises."""
    bo = backoff or Backoff()
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            if attempt >= retries:
                raise
            if on_retry is not None:
                on_retry(e, attempt)
            sleep(bo.next_delay())
            attempt += 1


def wait_until(predicate: Callable[[], bool], timeout: float,
               initial: float = 0.0005, max_interval: float = 0.02,
               factor: float = 1.5,
               sleep: Callable[[float], None] = time.sleep,
               clock: Callable[[], float] = time.monotonic) -> bool:
    """Poll ``predicate`` until true or ``timeout`` elapses; returns the
    final predicate value.  The interval ramps ``initial → max_interval``
    so hot waits (raft catch-up is usually sub-millisecond away) stay
    low-latency without pinning a core when the wait drags."""
    if predicate():
        return True
    deadline = clock() + timeout
    interval = initial
    while clock() < deadline:
        sleep(min(interval, max(0.0, deadline - clock())))
        if predicate():
            return True
        interval = min(interval * factor, max_interval)
    return predicate()
