"""PlanQueue: leader-only priority queue of submitted plans with futures
(a copy of ``nomad_tpu/server/plan_queue.py``; reference
nomad/plan_queue.go:29-180)."""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..structs import structs as s

# Bound on the per-job last-apply fence table: evictions fold into the
# global floor, so the map cannot grow with job cardinality (dispatch
# workloads mint a unique child job id per dispatch).
JOB_APPLY_CAP = 16384


class PlanFuture:
    """Future for a submitted plan's result.

    claim()/cancel() close the abandoned-plan race: a submitter whose
    wait timed out cancels the future, and the applier claims it before
    evaluating — so a plan is either cancelled (never applied; the
    submitter may safely replan without double-committing placements) or
    claimed (the applier owns it; the submitter must keep waiting)."""

    def __init__(self):
        self._event = threading.Event()
        self._result: Optional[s.PlanResult] = None
        self._error: Optional[Exception] = None
        self._state_l = threading.Lock()
        self._claimed = False
        self._cancelled = False
        # Host clock at enqueue (the port's addition): the applier samples
        # the plan's wait in the queue from it.
        self.enqueued_at = 0.0

    def claim(self) -> bool:
        """Applier-side: take ownership; False if already cancelled."""
        with self._state_l:
            if self._cancelled:
                return False
            self._claimed = True
            return True

    def cancel(self) -> bool:
        """Submitter-side: abandon; False if the applier already owns it
        (the plan may still commit — keep waiting)."""
        with self._state_l:
            if self._claimed:
                return False
            self._cancelled = True
            return True

    def respond(self, result: Optional[s.PlanResult], error: Optional[Exception]):
        self._result = result
        self._error = error
        self._event.set()
        return self

    def wait(self, timeout: Optional[float] = None) -> s.PlanResult:
        if not self._event.wait(timeout):
            raise TimeoutError("plan future timed out")
        if self._error is not None:
            raise self._error
        return self._result


@dataclass(order=True)
class _PendingPlan:
    sort_key: Tuple[int, int, int]
    plan: s.Plan = field(compare=False)
    future: PlanFuture = field(compare=False)


class PlanQueue:
    def __init__(self):
        self._l = threading.Lock()
        self._cond = threading.Condition(self._l)
        self._enabled = False
        self._heap: List[_PendingPlan] = []
        self._seq = itertools.count()
        # Per-job last plan-apply index (stale-snapshot fence): a worker
        # may reuse a cached snapshot for job J only if it covers J's
        # newest committed plan — the broker serializes evals per job,
        # but an eval CREATED before J's previous plan applied can be
        # DEQUEUED after it, and scheduling J from a snapshot that
        # misses J's own placements would double-place them (capacity
        # re-checks can't catch same-job duplication).  Plans with no
        # attributable job bump the global floor instead; so do LRU
        # evictions past JOB_APPLY_CAP (conservative: unknown jobs then
        # require a snapshot past the evicted apply, never an older
        # one).
        self._job_apply: "OrderedDict[str, int]" = OrderedDict()
        self._apply_floor = 0

    def note_applied(self, job_id: str, index: int) -> None:
        with self._l:
            if job_id:
                if index > self._job_apply.get(job_id, 0):
                    self._job_apply[job_id] = index
                self._job_apply.move_to_end(job_id)
                while len(self._job_apply) > JOB_APPLY_CAP:
                    _, evicted = self._job_apply.popitem(last=False)
                    if evicted > self._apply_floor:
                        self._apply_floor = evicted
            elif index > self._apply_floor:
                self._apply_floor = index

    def applied_index_for(self, job_id: str) -> int:
        with self._l:
            return max(self._job_apply.get(job_id, 0), self._apply_floor)

    def enabled(self) -> bool:
        with self._l:
            return self._enabled

    def set_enabled(self, enabled: bool) -> None:
        with self._l:
            self._enabled = enabled
            if not enabled:
                # Pending submitters must hear about the discard — a
                # silent drop would hang their future.wait() forever
                # (plan_queue.go Flush responds with an error).
                for item in self._heap:
                    item.future.respond(None, RuntimeError(
                        "plan queue is disabled (leadership lost)"))
                self._heap = []
            self._cond.notify_all()

    def enqueue(self, plan: s.Plan) -> PlanFuture:
        """(plan_queue.go:95)."""
        future = PlanFuture()
        future.enqueued_at = time.perf_counter()
        with self._l:
            if not self._enabled:
                raise RuntimeError("plan queue is disabled")
            heapq.heappush(
                self._heap,
                _PendingPlan((-plan.priority, 0, next(self._seq)), plan, future))
            self._cond.notify_all()
        return future

    def dequeue(self, timeout: Optional[float] = None) -> Optional[Tuple[s.Plan, PlanFuture]]:
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        with self._l:
            while True:
                if not self._enabled:
                    return None
                if self._heap:
                    pending = heapq.heappop(self._heap)
                    return pending.plan, pending.future
                remaining = None if deadline is None else deadline - _time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(remaining if remaining is not None else 1.0)

    def depth(self) -> int:
        with self._l:
            return len(self._heap)
