"""Eval-lifecycle tracing plane (a copy of ``nomad_tpu/utils/tracing.py``):
cheap structured spans threaded through the scheduling pipeline (broker
→ worker → batch scheduler → plan applier → raft), queryable per eval.

Why not logs: at batch scale, "where did eval X spend its time" is a
join across six subsystems on four threads.  Spans carry ids, parents,
``perf_counter`` timestamps, and attrs; everything touching one evaluation
tags ``eval_id`` (batch spans tag ``eval_ids``), so the whole lifecycle
— enqueue → dequeue → batch phases → plan submit → apply — comes back
from one index lookup (``trace_for_eval``; ``Server.trace_for_eval``).

Cost discipline (the ``fault.py`` contract): the plane is **off by
default**.  Every instrumented site reads one module global (``TRACER``)
and branches; disarmed there are no locks, no allocations, no
timestamps.  Arm process-wide with ``tracing.enable()`` (tests, the
selfcheck drill) or ``ServerConfig(trace=True)`` (read at server
construction; the reference's ``NOMAD_TPU_TRACE=1``).

Device time: spans run on the host clock.  A span closed after a CUDA
launch and before a sync measures the launch, not the device, so the
batch scheduler records ``batch.device`` from the CUDA-event interval it
already takes (``ops/batch_sched._DeviceTimer``), and no span adds a
synchronization of its own.

Threading model: spans nest via a thread-local stack (parent linkage
within a thread); an eval's lifecycle *crosses* threads (the caller's
``job_register`` → worker → plan applier), so cross-thread correlation
is by ``eval_id`` attr, not parent pointers.  ``trace_for_eval`` returns
every span tagged with the eval, sorted by start time — the timeline.

Correlation with the chaos plane: ``fault.py`` reports every rule fire
here (``note_fault`` → a ``fault.fire`` span carrying the same
(point, rule, action) triple that ``fault.trace()`` records), and
``ops/breaker.py`` reports state transitions (``breaker.transition``
spans) — so a trace of a chaos-injected eval shows *which* injected
fault and breaker movement shaped its path.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

__all__ = [
    "Span", "Tracer", "TRACER", "NOOP", "now",
    "enable", "disable", "enabled", "span", "event", "record",
    "trace_for_eval", "recent", "note_fault", "mark", "close_mark",
]

#: The span clock.  ``time.perf_counter()``: monotonic like
#: ``time.monotonic()`` (immune to NTP steps) but highest-resolution,
#: so sub-millisecond phase spans don't quantize.  Callers feeding
#: already-measured timestamps into :func:`record` must use THIS clock
#: (``tracing.now()``) — mixing bases corrupts span ordering and the
#: wall-clock backdating.
now = time.perf_counter

# Bounded-store defaults: the recency ring holds ~4k completed spans;
# independently, the eval index (LRU over the last ~1k distinct eval
# ids) pins ≤256 spans per indexed eval even after they leave the ring,
# so the armed-plane worst case is ~256k retained spans, not 4k.
DEFAULT_CAPACITY = 4096
DEFAULT_MAX_EVALS = 1024
MAX_SPANS_PER_EVAL = 256
# A batch span tags every member eval; at bench scale a batch can carry
# 1k+ evals, and indexing/serializing millions of ids per phase span
# under the tracer lock would swamp the armed plane.  Beyond this cap
# the span keeps the first N ids (indexed + serialized) plus an
# `eval_ids_elided` count.
MAX_EVAL_IDS_PER_SPAN = 128
# Cross-thread umbrella marks (eval.e2e: RPC submit → broker ack): an
# eval whose ack never comes (leadership churn) must not pin its mark
# forever, so the mark table is a bounded LRU.
MAX_MARKS = 4096


class Span:
    """One completed (or in-flight) operation.  ``start``/``end`` are
    ``tracing.now()`` (``time.perf_counter()``) — comparable across
    threads, immune to wall clock steps; ``wall`` is the wall-clock
    start kept only as the epoch anchor for humans."""

    __slots__ = ("span_id", "parent_id", "name", "start", "end", "wall",
                 "attrs")

    def __init__(self, span_id: int, parent_id: int, name: str,
                 start: float, attrs: Dict[str, Any]):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start = start
        self.end = start
        self.wall = time.time()
        self.attrs = attrs

    def set(self, **attrs: Any) -> None:
        """Attach attrs mid-span (e.g. the nack reason on failure)."""
        self.attrs.update(attrs)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "SpanID": self.span_id,
            "ParentID": self.parent_id,
            "Name": self.name,
            "Start": self.start,
            "End": self.end,
            "DurationMs": round((self.end - self.start) * 1000.0, 4),
            "Wall": self.wall,
            "Attrs": self.attrs,
        }


class _EvalBucket:
    """Per-eval span index entry: the retained spans plus how many were
    evicted once the MAX_SPANS_PER_EVAL cap was hit."""

    __slots__ = ("spans", "dropped")

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self.dropped = 0


class _NoopSpan:
    """Shared do-nothing span/context-manager handed out while tracing is
    disabled — call sites keep one code path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass


#: Shared disabled-plane singleton; call sites that must not even build
#: the attrs dict while disarmed branch on TRACER and use this directly.
NOOP = _NOOP = _NoopSpan()


class _ActiveSpan:
    """Context manager pushing/popping one span on the thread-local
    stack; an exception escaping the block is recorded on the span."""

    __slots__ = ("tracer", "sp")

    def __init__(self, tracer: "Tracer", sp: Span):
        self.tracer = tracer
        self.sp = sp

    def __enter__(self) -> Span:
        self.tracer._push(self.sp)
        return self.sp

    def __exit__(self, etype, evalue, tb) -> bool:
        if etype is not None:
            self.sp.attrs.setdefault("error", etype.__name__)
            self.sp.attrs.setdefault("error_detail", str(evalue))
        self.tracer._pop(self.sp)
        return False


class Tracer:
    """The armed state: a bounded ring of completed spans plus an LRU
    index eval_id → spans.  All mutation under one lock; span creation
    itself (the common case) takes the lock once at finish."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 max_evals: int = DEFAULT_MAX_EVALS):
        self._l = threading.Lock()
        self._seq = itertools.count(1)
        self._spans: deque = deque(maxlen=max(16, capacity))
        self._by_eval: "OrderedDict[str, _EvalBucket]" = OrderedDict()
        self.max_evals = max(1, max_evals)
        self._local = threading.local()
        # eval_id → (tracing.now() submit time, attrs): the open end of
        # a cross-thread umbrella span (mark/close_mark).
        self._marks: "OrderedDict[str, tuple]" = OrderedDict()

    # -- thread-local span stack ------------------------------------------

    def _stack(self) -> List[Span]:
        stk = getattr(self._local, "stack", None)
        if stk is None:
            stk = self._local.stack = []
        return stk

    def _push(self, sp: Span) -> None:
        self._stack().append(sp)

    def _pop(self, sp: Span) -> None:
        stk = self._stack()
        if stk and stk[-1] is sp:
            stk.pop()
        elif sp in stk:  # defensive: mis-nested exit
            stk.remove(sp)
        sp.end = now()
        self._record(sp)

    def current(self) -> Optional[Span]:
        stk = getattr(self._local, "stack", None)
        return stk[-1] if stk else None

    # -- span creation -----------------------------------------------------

    def _new_span(self, name: str, attrs: Dict[str, Any]) -> Span:
        evs = attrs.get("eval_ids")
        if evs is not None and len(evs) > MAX_EVAL_IDS_PER_SPAN:
            attrs["eval_ids"] = list(evs[:MAX_EVAL_IDS_PER_SPAN])
            attrs["eval_ids_elided"] = len(evs) - MAX_EVAL_IDS_PER_SPAN
        parent = self.current()
        parent_id = parent.span_id if parent is not None else 0
        # Inherit the eval correlation key from the enclosing span so
        # inner spans (wait_for_index, phases) need not repeat it.
        if parent is not None and "eval_id" not in attrs \
                and "eval_ids" not in attrs:
            pev = parent.attrs.get("eval_id")
            if pev is not None:
                attrs["eval_id"] = pev
            else:
                pevs = parent.attrs.get("eval_ids")
                if pevs is not None:
                    attrs["eval_ids"] = pevs
        return Span(next(self._seq), parent_id, name, now(), attrs)

    def span(self, name: str, **attrs: Any) -> _ActiveSpan:
        return _ActiveSpan(self, self._new_span(name, attrs))

    def event(self, name: str, **attrs: Any) -> Span:
        """Zero-duration span (a point-in-time lifecycle marker:
        broker enqueue/ack, a breaker transition, a fault fire)."""
        sp = self._new_span(name, attrs)
        self._record(sp)
        return sp

    def record(self, name: str, start: float, end: float,
               **attrs: Any) -> Span:
        """Retroactively record a completed span from already-measured
        ``tracing.now()`` timestamps (the batch scheduler's phase
        timers)."""
        sp = self._new_span(name, attrs)
        # Backdate the wall clock along with the monotonic start — it was
        # stamped at creation (i.e. the phase's END), not at `start`.
        sp.wall -= sp.start - start
        sp.start = start
        sp.end = end
        self._record(sp)
        return sp

    # -- cross-thread umbrella marks ---------------------------------------

    def mark(self, eval_id: str, **attrs: Any) -> None:
        """Open an umbrella: remember WHEN (``tracing.now()``) this eval
        was submitted, so whichever thread later closes it can record
        one span covering the whole client-visible lifecycle."""
        with self._l:
            self._marks[eval_id] = (now(), attrs)
            self._marks.move_to_end(eval_id)
            while len(self._marks) > MAX_MARKS:
                self._marks.popitem(last=False)

    def close_mark(self, eval_id: str, name: str = "eval.e2e",
                   **attrs: Any) -> None:
        """Close the umbrella opened by :meth:`mark` — records one
        retroactive ``eval.e2e`` span (submit → now) stitching client
        RPC → broker → worker → plan-apply across threads.  No-op when
        no mark exists (evals born inside the scheduler)."""
        with self._l:
            entry = self._marks.pop(eval_id, None)
        if entry is None:
            return
        start, mark_attrs = entry
        merged = dict(mark_attrs)
        merged.update(attrs)
        merged["eval_id"] = eval_id
        self.record(name, start, now(), **merged)

    # -- storage / query ---------------------------------------------------

    def _record(self, sp: Span) -> None:
        keys = []
        ev = sp.attrs.get("eval_id")
        if ev is not None:
            keys.append(ev)
        evs = sp.attrs.get("eval_ids")
        if evs:
            keys.extend(evs)
        with self._l:
            self._spans.append(sp)
            for key in keys:
                bucket = self._by_eval.get(key)
                if bucket is None:
                    bucket = self._by_eval[key] = _EvalBucket()
                    while len(self._by_eval) > self.max_evals:
                        self._by_eval.popitem(last=False)
                else:
                    self._by_eval.move_to_end(key)
                bucket.spans.append(sp)
                if len(bucket.spans) > MAX_SPANS_PER_EVAL:
                    # Drop the OLDEST span: the terminal spans (ack/nack,
                    # final attempt) answer "how did this eval end" and
                    # must survive.
                    del bucket.spans[0]
                    bucket.dropped += 1

    def trace_for_eval(self, eval_id: str) -> List[Dict[str, Any]]:
        with self._l:
            bucket = self._by_eval.get(eval_id)
            spans = list(bucket.spans) if bucket is not None else []
            dropped = bucket.dropped if bucket is not None else 0
        spans.sort(key=lambda sp: sp.start)
        out = [sp.to_dict() for sp in spans]
        if dropped and out:
            # Flag the (new) head of a truncated timeline on the rendered
            # copy only — the Span's attrs dict is shared across the
            # buckets of every eval in the batch.
            out[0] = dict(out[0], Attrs=dict(out[0]["Attrs"],
                                             trace_truncated=dropped))
        return out

    def recent(self, n: int = 100) -> List[Dict[str, Any]]:
        """The last ``n`` completed spans, oldest first."""
        if n <= 0:  # spans[-0:] would return everything
            return []
        with self._l:
            spans = list(self._spans)
        return [sp.to_dict() for sp in spans[-n:]]


# -- process-wide arming ------------------------------------------------------

# The single global every instrumented site reads.  ``None`` ⇒ disabled
# ⇒ one load + one comparison per site (the fault.py discipline).
TRACER: Optional[Tracer] = None


def enable(capacity: int = DEFAULT_CAPACITY,
           max_evals: int = DEFAULT_MAX_EVALS) -> Tracer:
    global TRACER
    TRACER = Tracer(capacity=capacity, max_evals=max_evals)
    return TRACER


def disable() -> None:
    global TRACER
    TRACER = None


def enabled() -> bool:
    return TRACER is not None


def span(name: str, **attrs: Any):
    """``with tracing.span("worker.attempt", eval_id=...) as sp:`` —
    the no-op singleton when disabled."""
    tr = TRACER
    if tr is None:
        return _NOOP
    return tr.span(name, **attrs)


def eval_id_attrs(evals, total: int) -> Dict[str, Any]:
    """Correlation attrs for a batch span without materializing more ids
    than the span retains — callers may hold million-eval batches.
    ``evals`` is any iterable of objects with ``.id``; ``total`` is the
    full batch size."""
    ids = [ev.id for ev, _ in zip(evals, range(MAX_EVAL_IDS_PER_SPAN))]
    out: Dict[str, Any] = {"eval_ids": ids}
    if total > len(ids):
        out["eval_ids_elided"] = total - len(ids)
    return out


def event(name: str, **attrs: Any) -> None:
    tr = TRACER
    if tr is not None:
        tr.event(name, **attrs)


def record(name: str, start: float, end: float, **attrs: Any) -> None:
    tr = TRACER
    if tr is not None:
        tr.record(name, start, end, **attrs)


def trace_for_eval(eval_id: str) -> List[Dict[str, Any]]:
    tr = TRACER
    return tr.trace_for_eval(eval_id) if tr is not None else []


def recent(n: int = 100) -> List[Dict[str, Any]]:
    tr = TRACER
    return tr.recent(n) if tr is not None else []


def mark(eval_id: str, **attrs: Any) -> None:
    tr = TRACER
    if tr is not None:
        tr.mark(eval_id, **attrs)


def close_mark(eval_id: str, name: str = "eval.e2e", **attrs: Any) -> None:
    tr = TRACER
    if tr is not None:
        tr.close_mark(eval_id, name, **attrs)


def note_fault(point: str, rule_index: int, action: str) -> None:
    """Called by fault.FaultPlane.fire on every rule fire: the tracing
    twin of the plane's own trace(), attached to the current span so a
    chaos-shaped eval's timeline shows which injection hit it."""
    tr = TRACER
    if tr is not None:
        tr.event("fault.fire", point=point, rule=rule_index,
                 action=action)
