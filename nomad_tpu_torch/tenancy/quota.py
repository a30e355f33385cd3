"""Tenant quota ledger and API token buckets (a copy of
``nomad_tpu/tenancy/quota.py``): admission-side enforcement.

The quota on live allocations is enforced before the log write, at the
same front door as the broker's admission cap, and a refusal is the
broker's ``BrokerLimitError`` with its ``retry_after``: a tenant over
quota is told to back off, never silently dropped.

The ledger is leader-side instead of trimming placements in the plan
applier, since trimming would livelock (the nodes fit, the quota trims
the placement, the scheduler replans the same job forever).  It does an
atomic check and reserve per job at admission: a job's task-group count
is reserved against the tenant's quota when its eval is accepted, and
released when the driving eval reaches a terminal status (the FSM
``on_eval_update`` leader hook) or the job is deregistered.  Between
placement and release a placed alloc is counted twice (the live fold
and the reservation), which is conservative only: the tenant may see
extra refusals near its limit, but committed state never exceeds the
quota, since the scheduler never places more than the admitted job's
count.  The ledger is leader-local; a new leader rebuilds it
conservatively from the non-terminal evals in its restored state.

The ``RateLimiter`` is configured from the namespace rows; nothing
consults it until the HTTP front door is ported.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, Optional, Tuple


class QuotaLedger:
    """Per-tenant reservation book: job_id -> (namespace, count)."""

    def __init__(self) -> None:
        self._l = threading.Lock()
        self._res: Dict[str, Tuple[str, int]] = {}
        self._ns_reserved: Dict[str, int] = {}

    def check_and_reserve(self, ns: str, job_id: str, count: int,
                          live: int, quota: int) -> bool:
        """Atomically admit-or-reject ``count`` asks for ``job_id``.

        ``live`` is the tenant's committed live-alloc count (the state
        store's per-ns fold), ``quota`` its max_live_allocs (0 =
        unlimited).  Re-registering a job REPLACES its reservation, so
        resubmits at steady state don't ratchet the reserved sum."""
        with self._l:
            prev_ns, prev = self._res.get(job_id, (ns, 0))
            reserved = self._ns_reserved.get(ns, 0)
            if prev_ns == ns:
                reserved -= prev
            if quota > 0 and live + reserved + count > quota:
                return False
            self._set_locked(job_id, ns, count)
            return True

    def _set_locked(self, job_id: str, ns: str, count: int) -> None:
        prev_ns, prev = self._res.get(job_id, ("", 0))
        if prev:
            left = self._ns_reserved.get(prev_ns, 0) - prev
            if left > 0:
                self._ns_reserved[prev_ns] = left
            else:
                self._ns_reserved.pop(prev_ns, None)
        if count > 0:
            self._res[job_id] = (ns, count)
            self._ns_reserved[ns] = self._ns_reserved.get(ns, 0) + count
        else:
            self._res.pop(job_id, None)

    def release(self, job_id: str) -> None:
        """Drop a job's reservation (its driving eval went terminal:
        the placements are live in the fold, or failed and never will
        be — either way the reservation's job is done)."""
        with self._l:
            self._set_locked(job_id, "", 0)

    def reserved(self, ns: str) -> int:
        with self._l:
            return self._ns_reserved.get(ns, 0)

    def rebuild(self, entries: Iterable[Tuple[str, str, int]]) -> None:
        """Conservative reseed after leadership acquisition:
        ``(job_id, ns, count)`` for every non-terminal eval's job in the
        restored state.  Over-reserving is safe (extra 429s near the
        limit); under-reserving is not."""
        with self._l:
            self._res.clear()
            self._ns_reserved.clear()
            for job_id, ns, count in entries:
                self._set_locked(job_id, ns, count)


class TokenBucket:
    """Classic token bucket; ``take`` returns 0.0 on admit or the
    seconds until a token will exist (the Retry-After hint)."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate: float, burst: float):
        self.rate = rate
        self.burst = burst if burst > 0 else max(1.0, 2.0 * rate)
        self.tokens = self.burst
        self.stamp = 0.0

    def take(self, now: float) -> float:
        if self.stamp:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.stamp) * self.rate)
        self.stamp = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        return (1.0 - self.tokens) / self.rate if self.rate > 0 else 1.0


class RateLimiter:
    """Per-tenant API submit limiter (agent/http front door).  Tenants
    without a configured rate (including the implicit "default") are
    never throttled."""

    def __init__(self) -> None:
        self._l = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}
        self._config: Dict[str, Tuple[float, float]] = {}

    def configure(self, ns: str, rate: float, burst: float = 0.0) -> None:
        with self._l:
            if rate <= 0:
                self._config.pop(ns, None)
                self._buckets.pop(ns, None)
                return
            cfg = (rate, burst)
            if self._config.get(ns) != cfg:
                self._config[ns] = cfg
                self._buckets[ns] = TokenBucket(rate, burst)

    def drop(self, ns: str) -> None:
        with self._l:
            self._config.pop(ns, None)
            self._buckets.pop(ns, None)

    def check(self, ns: str, now: Optional[float] = None) -> float:
        """0.0 = admitted; otherwise the Retry-After seconds."""
        with self._l:
            bucket = self._buckets.get(ns)
            if bucket is None:
                return 0.0
            return bucket.take(now if now is not None else time.monotonic())
