"""The federation plane: the global event-stream aggregator (a copy of
``nomad_tpu/server/federation.py``).

One raft cluster's event broker sees one region.  A federated operator
wants a single tail over all of them — "what is happening on the
planet" — without any cross-region raft (regions stay independent fault
domains).  The aggregator is the deliberately-boring answer: a
poll-based fan-in over each region's existing ``Event.Since`` RPC with
one cursor per region.

Ordering contract: events from ONE region arrive in that region's
raft-index order (the cursor guarantees no gaps and no duplicates, even
across partitions — a dark region simply pauses, and the cursor resumes
exactly where it left off after heal).  Events from DIFFERENT regions
interleave in poll-arrival order; there is no global clock, and
inventing one here would be a lie (each event carries its ``Region``
and region-local ``Index``, so consumers needing a total order per
region still have it).

Partition tolerance: a poll round never hangs on a dark region — each
region gets one bounded RPC, unreachable regions are counted and
skipped, and their cursors stay put so nothing is lost.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

# How long one region's poll waits (the reference's
# NOMAD_TPU_REGION_PROBE_TIMEOUT default).
PROBE_TIMEOUT = 1.0


class RegionEventAggregator:
    """Fan-in tail over every region's event stream.

    ``region_addrs`` maps region name → the RPC address of any server in
    that region (the event ring is replicated per-server state derived
    from raft apply, so any member's tail is the region's tail).  Call
    :meth:`poll` on whatever cadence suits the consumer; each call
    returns the newly-seen events, every one tagged with ``Region``.
    ``timeout`` bounds each region's poll (default ``PROBE_TIMEOUT``).
    """

    def __init__(self, region_addrs: Dict[str, str], pool=None,
                 max_batch: int = 512, timeout: Optional[float] = None):
        if pool is None:
            from .rpc import ConnPool

            pool = ConnPool()
        self.pool = pool
        self.max_batch = max_batch
        self.timeout = timeout if timeout is not None else PROBE_TIMEOUT
        self._l = threading.Lock()
        # region -> [addr, cursor_index]
        self._regions: Dict[str, List[Any]] = {
            r: [addr, 0] for r, addr in region_addrs.items()}
        self.polls = 0
        self.events_total = 0
        self.unreachable_total = 0
        self._last_unreachable: List[str] = []

    def add_region(self, region: str, addr: str) -> None:
        with self._l:
            self._regions.setdefault(region, [addr, 0])

    def cursors(self) -> Dict[str, int]:
        with self._l:
            return {r: int(c[1]) for r, c in self._regions.items()}

    def unreachable(self) -> List[str]:
        """Regions that failed their poll in the most recent round."""
        with self._l:
            return list(self._last_unreachable)

    def poll(self) -> List[Dict]:
        """One fan-in round: tail each region past its cursor.  Returns
        the new events (per-region order preserved; regions concatenated
        in sorted-name order within the round).  Never raises on a dark
        region and never hangs — unreachable regions are skipped with
        their cursors intact."""
        out: List[Dict] = []
        dark: List[str] = []
        with self._l:
            snapshot = [(r, c[0], int(c[1]))
                        for r, c in sorted(self._regions.items())]
        for region, addr, cursor in snapshot:
            try:
                reply = self.pool.call(
                    addr, "Event.Since",
                    {"MinIndex": cursor, "Max": self.max_batch},
                    timeout=self.timeout)
            except Exception:
                dark.append(region)
                continue
            events = reply.get("Events") or []
            # Event.Since is EXCLUSIVE (index > cursor) and one raft
            # apply can emit several events at the same index.  If the
            # batch cap landed mid-group, advancing the cursor to the
            # split index would silently drop the group's tail — trim
            # the partial group and pick it up whole next round.
            if len(events) >= self.max_batch:
                last = events[-1]["Index"]
                whole = [ev for ev in events if ev["Index"] < last]
                if whole:
                    events = whole
            for ev in events:
                ev = dict(ev)
                ev["Region"] = region
                out.append(ev)
            if events:
                with self._l:
                    cur = self._regions.get(region)
                    if cur is not None:
                        cur[1] = max(cur[1], events[-1]["Index"])
        with self._l:
            self.polls += 1
            self.events_total += len(out)
            self.unreachable_total += len(dark)
            self._last_unreachable = dark
        return out

    def stats(self) -> Dict:
        with self._l:
            return {"Polls": self.polls,
                    "Events": self.events_total,
                    "Unreachable": self.unreachable_total,
                    "Cursors": {r: int(c[1])
                                for r, c in self._regions.items()},
                    "Dark": list(self._last_unreachable)}
