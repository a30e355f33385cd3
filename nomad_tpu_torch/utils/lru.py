"""Small LRU cache (a copy of ``nomad_tpu/utils/lru.py``) for the batch
scheduler's two caches: the finalized static cluster tensors and the
device copies of the packed static buffer.  Touch-on-hit recency; every
eviction counts in the module counter ``EVICTIONS``.
"""
from __future__ import annotations

from collections import OrderedDict

# Process-lifetime eviction count across every LRU instance.
EVICTIONS = 0


class LRU:
    """Bounded mapping with touch-on-hit recency and eviction counting.

    Not thread-safe by itself: callers that race rely on the GIL for the
    individual OrderedDict operations."""

    __slots__ = ("cap", "_d")

    def __init__(self, cap: int) -> None:
        assert cap > 0
        self.cap = cap
        self._d: OrderedDict = OrderedDict()

    def get(self, key, default=None):
        # Single read first: a concurrent put() may evict key between
        # any two steps here, so the lookup must be the one op that
        # decides hit-vs-miss (the recency touch tolerates the race).
        try:
            v = self._d[key]
        except KeyError:
            return default
        try:
            self._d.move_to_end(key)
        except KeyError:
            pass
        return v

    def put(self, key, value) -> None:
        global EVICTIONS
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.cap:
            self._d.popitem(last=False)
            EVICTIONS += 1

    def clear(self) -> None:
        self._d.clear()
