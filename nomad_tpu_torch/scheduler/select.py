"""Selection iterators: candidate limiting and max-score pick (a copy of
``nomad_tpu/scheduler/select.py``; reference scheduler/select.go).  The
limit is the power-of-two-choices bound of the CPU oracle.
"""
from __future__ import annotations

from typing import Optional

from .rank import RankedNode


class LimitIterator:
    """Stops after yielding N options (select.go:5-44)."""

    def __init__(self, ctx, source, limit: int):
        self.ctx = ctx
        self.source = source
        self.limit = limit
        self.seen = 0

    def set_limit(self, limit: int) -> None:
        self.limit = limit

    def next_option(self) -> Optional[RankedNode]:
        if self.seen == self.limit:
            return None
        option = self.source.next_option()
        if option is None:
            return None
        self.seen += 1
        return option

    def reset(self) -> None:
        self.source.reset()
        self.seen = 0


class MaxScoreIterator:
    """Consumes the source and returns only the top-scoring option
    (select.go:46-85)."""

    def __init__(self, ctx, source):
        self.ctx = ctx
        self.source = source
        self.max: Optional[RankedNode] = None

    def next_option(self) -> Optional[RankedNode]:
        if self.max is not None:
            return None
        while True:
            option = self.source.next_option()
            if option is None:
                return self.max
            if self.max is None or option.score > self.max.score:
                self.max = option

    def reset(self) -> None:
        self.source.reset()
        self.max = None
