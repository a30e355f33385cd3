"""Cluster event stream broker (a copy of
``nomad_tpu/server/event_broker.py``; reference: nomad/stream/event_broker.go,
the 1.0 ``/v1/event/stream`` plane).

The state store's WatchSet machinery wakes blocking queries per table and
throws the change away; this broker keeps it: every write-path mutation
publishes a structured, raft-index-stamped :class:`structs.Event` into a
bounded ring, and subscribers consume an ordered feed with topic filters
and ``index=`` resume semantics:

- events arrive in monotonic raft-index order (publishes happen on the
  apply path, which is serialized by the log lock);
- a subscriber that reconnects with ``index=N`` replays every buffered
  event with ``index >= N`` before going live — no gaps while the ring
  still buffers ``N`` (the boundary index may redeliver; consumers key
  on (index, topic, key));
- when ``N`` has already been evicted from the ring the subscribe fails
  with :class:`EventIndexError` carrying the oldest buffered index, so
  the consumer knows to resnapshot instead of silently missing changes.

Cost discipline (the fault.py / tracing.py contract): the broker exists
per server but is **disarmed by default** — nothing is attached to the
state store, so every write pays exactly one attribute load + ``None``
branch.  Arming happens with ``ServerConfig(events=True)`` at server
construction (the reference's ``NOMAD_TPU_EVENTS=1``) or lazily on the
first subscriber (``Server.enable_event_stream``).  Ring size:
``ServerConfig.events_ring`` (default 4096; ``NOMAD_TPU_EVENTS_RING``).

Cross-cutting publishers that hold no server handle (the process-wide
breaker, the fault plane, the resident mirror) go through the
module-level :func:`note_external` hook, which is one truthiness check
while no broker is armed and stamps events with the server's latest
applied index.  Armed brokers also mirror every event into a
process-global recency ring (:func:`recent`), so a failing test can dump
"what happened" next to the trace timeline.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ..structs import structs as s
from ..utils import tracing
from ..utils.telemetry import NULL_TELEMETRY

DEFAULT_RING_SIZE = 4096
DEFAULT_MAX_PENDING = 8192
# Process-global forensic tail, independent of any one broker's lifetime
# — servers shut down inside the test body, before a failure is
# reported.
RECENT_CAPACITY = 2048


class EventIndexError(Exception):
    """``index=`` resume pointing below the ring's buffered horizon: the
    requested events were already evicted, so a resumed stream would
    have a silent gap.  Carries the oldest index still buffered so the
    consumer can resnapshot and resubscribe."""

    def __init__(self, requested: int, oldest: int):
        self.requested = requested
        self.oldest = oldest
        super().__init__(
            f"requested index {requested} is no longer buffered; "
            f"oldest buffered index is {oldest}")


class Subscription:
    """One consumer's ordered event queue.  Filled by the broker under
    its publish path; drained by the consumer
    (``Server.event_stream_subscribe``).  A consumer that stops draining
    past ``max_pending`` is closed with a lag error rather than wedging
    publishers or growing unboundedly (stream/subscription.go closes
    slow subscribers the same way)."""

    def __init__(self, broker: "EventBroker",
                 topics: Optional[Dict[str, set]],
                 max_pending: int = DEFAULT_MAX_PENDING):
        self._broker = broker
        # topic -> set of keys ("" / empty set = every key); None = all.
        self.topics = topics
        self.max_pending = max_pending
        self._q: deque = deque()
        self._cond = threading.Condition()
        self.closed = False
        self.close_error: Optional[str] = None

    def matches(self, ev: s.Event) -> bool:
        if self.topics is None:
            return True
        keys = self.topics.get(ev.topic)
        if keys is None:
            keys = self.topics.get("*")
            if keys is None:
                return False
        return not keys or ev.key in keys

    def offer(self, ev: s.Event, replay: bool = False) -> None:
        """``replay=True`` is the subscribe-time ring replay: it bypasses
        the lag shed (the backlog is bounded by the ring size the
        operator chose — shedding a brand-new subscriber for reading the
        buffer it asked for would make resume impossible on large
        rings)."""
        with self._cond:
            if self.closed:
                return
            if not replay and len(self._q) >= self.max_pending:
                self.closed = True
                self.close_error = (
                    f"subscriber lagging: {len(self._q)} undelivered "
                    "events; reconnect with index= to resume")
                self._cond.notify_all()
                return
            self._q.append(ev)
            self._cond.notify_all()

    def next(self, timeout: Optional[float] = None) -> Optional[s.Event]:
        """Next event, or None on timeout / after close once drained."""
        with self._cond:
            if not self._q and not self.closed:
                self._cond.wait(timeout)
            if self._q:
                return self._q.popleft()
            return None

    def pending(self) -> int:
        with self._cond:
            return len(self._q)

    def close(self) -> None:
        with self._cond:
            self.closed = True
            self._cond.notify_all()
        self._broker._remove(self)


class EventBroker:
    """Bounded ring + fan-out.  All ring mutation happens under one lock;
    subscriber queues have their own locks, always acquired after the
    broker's (publish: broker → sub; subscribe replay: broker → sub) so
    ordering is consistent and deadlock-free."""

    def __init__(self, ring_size: Optional[int] = None, metrics=None,
                 index_source: Optional[Callable[[], int]] = None):
        if ring_size is None:
            ring_size = DEFAULT_RING_SIZE
        self.ring_size = max(8, ring_size)
        self.metrics = metrics if metrics is not None else NULL_TELEMETRY
        # Applied-index source for externally-originated events (breaker,
        # fault plane, heartbeat expiry) that carry no raft entry.
        self.index_source = index_source
        self._l = threading.Lock()
        self._ring: deque = deque()
        self._subs: List[Subscription] = []
        # Subscriber index (the 10k-filtered-subscriber fan-out fix):
        # publish used to walk EVERY subscription's filter per event
        # under the ring lock — O(K) per write with K alloc-watchers
        # attached.  Bucketing by topic and (topic, key) makes delivery
        # O(matching): an event touches the follow-all list, its topic's
        # every-key list, and its exact (topic, key) list.  Exotic
        # filters ("*" with key sets) fall back to a per-event match in
        # _subs_unindexed.
        self._subs_all: List[Subscription] = []
        self._subs_unindexed: List[Subscription] = []
        self._subs_topic_all: Dict[str, List[Subscription]] = {}
        self._subs_topic_key: Dict[Tuple[str, str],
                                   List[Subscription]] = {}
        # Highest index ever evicted from the ring: a resume at or below
        # it has a gap and must error instead of silently skipping.
        self._evicted_through = 0
        self.published = 0
        self.evicted = 0

    def _index_sub(self, sub: Subscription) -> None:
        if sub.topics is None:
            self._subs_all.append(sub)
        elif "*" in sub.topics:
            self._subs_unindexed.append(sub)
        else:
            for topic, keys in sub.topics.items():
                if not keys:
                    self._subs_topic_all.setdefault(topic, []).append(sub)
                else:
                    for key in keys:
                        self._subs_topic_key.setdefault(
                            (topic, key), []).append(sub)

    def _deindex_sub(self, sub: Subscription) -> None:
        """Mirror of _index_sub.  Emptied buckets are POPPED — churning
        per-alloc watchers mint unique (topic, key) entries, and leaving
        empty lists behind would grow the index without bound."""

        def drop(table, key):
            bucket = table.get(key)
            if bucket is None:
                return
            try:
                bucket.remove(sub)
            except ValueError:
                pass
            if not bucket:
                del table[key]

        if sub.topics is None:
            try:
                self._subs_all.remove(sub)
            except ValueError:
                pass
        elif "*" in sub.topics:
            try:
                self._subs_unindexed.remove(sub)
            except ValueError:
                pass
        else:
            for topic, keys in sub.topics.items():
                if not keys:
                    drop(self._subs_topic_all, topic)
                else:
                    for key in keys:
                        drop(self._subs_topic_key, (topic, key))

    # -- publish -----------------------------------------------------------

    def make_event(self, topic: str, etype: str, key: str, index: int,
                   payload: Optional[Dict] = None,
                   eval_id: str = "") -> s.Event:
        """Build an event, inheriting eval/span correlation from the
        current tracing span when one is active."""
        span_id = 0
        tr = tracing.TRACER
        if tr is not None:
            sp = tr.current()
            if sp is not None:
                span_id = sp.span_id
                if not eval_id:
                    eval_id = sp.attrs.get("eval_id", "") or ""
        return s.Event(topic=topic, type=etype, key=key, index=index,
                       payload=payload or {}, eval_id=eval_id,
                       span_id=span_id, wall=time.time())

    def publish(self, events: List[s.Event], clamp: bool = False) -> None:
        """Append + fan out.  ``clamp=True`` (externally-originated
        events) raises each event's index to the ring tail's if it would
        otherwise step backwards: raft-index-stamped state events are
        serialized by the log lock, but an external stamp read from
        applied_index races with an in-flight apply, and the stream's
        monotonic-order contract must hold for resume dedupe."""
        if not events:
            return
        with self._l:
            ring = self._ring
            for ev in events:
                if clamp and ring and ev.index < ring[-1].index:
                    ev.index = ring[-1].index
                if len(ring) >= self.ring_size:
                    old = ring.popleft()
                    if old.index > self._evicted_through:
                        self._evicted_through = old.index
                    self.evicted += 1
                ring.append(ev)
            self.published += len(events)
            # Fan out while still holding the ring lock: two concurrent
            # publishers (raft apply vs. an external stamp) append in
            # order, but offering outside the lock could deliver those
            # events to a live subscriber inverted, breaking the
            # monotonic-order contract resume dedupe relies on.  offer()
            # is a deque append under the sub's own lock (broker → sub,
            # the documented order).  Delivery walks the subscriber
            # INDEX, not every subscription — O(matching) per event.
            for ev in events:
                for sub in self._subs_all:
                    sub.offer(ev)
                for sub in self._subs_topic_all.get(ev.topic, ()):
                    sub.offer(ev)
                for sub in self._subs_topic_key.get((ev.topic, ev.key),
                                                    ()):
                    sub.offer(ev)
                for sub in self._subs_unindexed:
                    if sub.matches(ev):
                        sub.offer(ev)
        _note_recent(events)

    def publish_one(self, topic: str, etype: str, key: str, index: int,
                    payload: Optional[Dict] = None,
                    eval_id: str = "", clamp: bool = False) -> None:
        self.publish([self.make_event(topic, etype, key, index, payload,
                                      eval_id)], clamp=clamp)

    def publish_external(self, topic: str, etype: str, key: str,
                         payload: Optional[Dict] = None,
                         eval_id: str = "") -> None:
        """An event with no raft entry of its own (breaker transition,
        fault fire, heartbeat expiry): stamped with the latest applied
        index (clamped to the ring tail so the stream stays monotonic —
        the stamp races with in-flight applies)."""
        index = self.index_source() if self.index_source is not None else 0
        self.publish([self.make_event(topic, etype, key, index, payload,
                                      eval_id)], clamp=True)

    # -- subscribe ---------------------------------------------------------

    def subscribe(self, topics: Optional[Dict[str, set]] = None,
                  from_index: int = 0,
                  max_pending: int = DEFAULT_MAX_PENDING,
                  replay_all: bool = False) -> Subscription:
        """New subscription.  ``from_index > 0`` replays every buffered
        event with ``index >= from_index`` (in order, before any live
        event), raising EventIndexError when that range has already
        been partially evicted.  ``replay_all`` replays whatever the
        ring currently holds with no gap check — the backlog-dump mode,
        which must work on a ring that has already evicted (the consumer
        asked for "what you still have", not "everything since N")."""
        sub = Subscription(self, topics, max_pending=max_pending)
        with self._l:
            if replay_all:
                for ev in self._ring:
                    if sub.matches(ev):
                        sub.offer(ev, replay=True)
            elif from_index > 0:
                if from_index <= self._evicted_through:
                    oldest = (self._ring[0].index if self._ring
                              else self._evicted_through + 1)
                    raise EventIndexError(from_index, oldest)
                for ev in self._ring:
                    if ev.index >= from_index and sub.matches(ev):
                        sub.offer(ev, replay=True)
            self._subs.append(sub)
            self._index_sub(sub)
        return sub

    def mark_armed(self, applied_index: int) -> None:
        """Record the raft index already applied when the broker is
        attached to the write path: events at or below it were never
        buffered (lazy arming, server restart), so a resume below that
        horizon must fail the gap check instead of silently replaying
        nothing.  Reuses the eviction horizon — "never buffered" and
        "buffered then evicted" are the same gap to a subscriber."""
        with self._l:
            if applied_index > self._evicted_through:
                self._evicted_through = applied_index

    def _remove(self, sub: Subscription) -> None:
        with self._l:
            try:
                self._subs.remove(sub)
            except ValueError:
                return  # already removed; index buckets were cleaned then
            self._deindex_sub(sub)

    # -- introspection -----------------------------------------------------

    def oldest_buffered_index(self) -> int:
        with self._l:
            return self._ring[0].index if self._ring else 0

    def latest_index(self) -> int:
        with self._l:
            return self._ring[-1].index if self._ring else 0

    def buffered(self, n: Optional[int] = None) -> List[s.Event]:
        with self._l:
            events = list(self._ring)
        return events[-n:] if n else events

    def stats(self) -> Dict[str, int]:
        with self._l:
            subs = list(self._subs)
            depth = len(self._ring)
        lag = max((sub.pending() for sub in subs), default=0)
        return {"depth": depth, "subscribers": len(subs),
                "published": self.published, "evicted": self.evicted,
                "max_subscriber_lag": lag}

    def close(self) -> None:
        with self._l:
            subs = list(self._subs)
            self._subs = []
            self._subs_all = []
            self._subs_unindexed = []
            self._subs_topic_all = {}
            self._subs_topic_key = {}
        for sub in subs:
            with sub._cond:
                sub.closed = True
                sub._cond.notify_all()


# -- process-wide hooks -------------------------------------------------------

# Armed brokers (servers register on enable_event_stream).  The hot
# disarmed path in external publishers is one truthiness check.
_ARMED: List[EventBroker] = []
_ARMED_L = threading.Lock()
# Forensic tail mirrored from every armed broker's publishes; survives
# server shutdown so a failing test can still dump it.
_RECENT: deque = deque(maxlen=RECENT_CAPACITY)


def register(broker: EventBroker) -> None:
    with _ARMED_L:
        if broker not in _ARMED:
            _ARMED.append(broker)


def unregister(broker: EventBroker) -> None:
    with _ARMED_L:
        try:
            _ARMED.remove(broker)
        except ValueError:
            pass


def armed() -> bool:
    return bool(_ARMED)


def note_external(topic: str, etype: str, key: str,
                  payload: Optional[Dict] = None, eval_id: str = "") -> None:
    """Cross-cutting publish hook for sites with no broker handle (the
    process-wide breaker, the fault plane).  One branch while disarmed."""
    if not _ARMED:
        return
    with _ARMED_L:
        brokers = list(_ARMED)
    for broker in brokers:
        broker.publish_external(topic, etype, key, payload, eval_id)


def _note_recent(events: List[s.Event]) -> None:
    _RECENT.extend(events)


def recent(n: int = 100) -> List[s.Event]:
    """Last ``n`` events published by any armed broker this process
    (oldest first) — a failing test's dump."""
    events = list(_RECENT)
    return events[-n:] if n else events


def clear_recent() -> None:
    _RECENT.clear()


def parse_topic_filter(spec: str) -> Optional[Dict[str, set]]:
    """``topic=`` query value → subscription filter.  Comma-separated
    entries, each ``Topic`` (all keys) or ``Topic:key``; ``*`` matches
    every topic.  Empty/absent → all events (None)."""
    spec = (spec or "").strip()
    if not spec or spec == "*":
        return None
    out: Dict[str, set] = {}
    bare: set = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        topic, _, key = part.partition(":")
        if not key:
            # A bare topic wants every key, regardless of any entry
            # that named a specific one.
            bare.add(topic)
            out[topic] = set()
        elif topic not in bare:
            out.setdefault(topic, set()).add(key)
    return out or None
