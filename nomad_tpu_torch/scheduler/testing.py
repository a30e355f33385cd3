"""Scheduler harness: the port's state store plus a planner that records
plans and evals and commits each plan at the next synthetic index (a copy
of ``nomad_tpu/scheduler/testing.py``; reference
scheduler/testing.go:41-218).  The tests and ``chip_smoke.py`` drive the
batch scheduler through it."""
from __future__ import annotations

import logging
import threading
from typing import List, Optional, Tuple

from ..state import StateStore
from ..structs import structs as s


class RejectPlan:
    """A planner that rejects every plan and forces a state refresh,
    exercising the refresh/retry path (testing.go:16)."""

    def __init__(self, harness: "Harness"):
        self.harness = harness

    def submit_plan(self, plan: s.Plan):
        result = s.PlanResult()
        result.refresh_index = self.harness.next_index()
        return result, self.harness.state

    def update_eval(self, ev: s.Evaluation) -> None:
        pass

    def create_eval(self, ev: s.Evaluation) -> None:
        pass

    def reblock_eval(self, ev: s.Evaluation) -> None:
        pass


class Harness:
    """Lightweight harness implementing the Planner interface."""

    def __init__(self, state: Optional[StateStore] = None):
        self.state = state or StateStore()
        self.planner = None  # optional custom planner
        self._plan_lock = threading.Lock()
        self.plans: List[s.Plan] = []
        self.evals: List[s.Evaluation] = []
        self.create_evals: List[s.Evaluation] = []
        self.reblock_evals: List[s.Evaluation] = []
        self._next_index = 1
        self._index_lock = threading.Lock()
        self.logger = logging.getLogger("nomad_tpu_torch.scheduler.harness")

    # -- Planner interface -------------------------------------------------

    def submit_plan(self, plan: s.Plan) -> Tuple[s.PlanResult, Optional[StateStore]]:
        with self._plan_lock:
            self.plans.append(plan)
            if self.planner is not None:
                return self.planner.submit_plan(plan)

            index = self.next_index()
            result = s.PlanResult(
                node_update=plan.node_update,
                node_allocation=plan.node_allocation,
                alloc_slabs=plan.alloc_slabs,
                node_preemptions=plan.node_preemptions,
                alloc_index=index,
            )

            allocs: List[s.Allocation] = []
            for update_list in plan.node_update.values():
                allocs.extend(update_list)
            for alloc_list in plan.node_allocation.values():
                allocs.extend(alloc_list)
            preempted: List[s.Allocation] = []
            for evicted_list in plan.node_preemptions.values():
                allocs.extend(evicted_list)
                preempted.extend(evicted_list)

            if plan.job is not None:
                # Same guard as upsert_plan_results: never stamp the
                # plan's job onto terminal allocs — an evicted victim
                # belongs to its OWN (lower-priority) job.
                for alloc in allocs:
                    if alloc.job is None and not alloc.terminal_status():
                        alloc.job = plan.job
                for slab in plan.alloc_slabs:
                    if slab.proto.job is None:
                        slab.proto.job = plan.job

            self.state.upsert_allocs(index, allocs, owned=True)
            if plan.alloc_slabs:
                self.state.upsert_slabs(index, plan.alloc_slabs)
            if preempted:
                # Mirror the real plan applier: every evicted alloc's job
                # gets ONE blocked follow-up eval so the displaced work
                # reschedules (plan_apply.py / blocked_evals.py).
                for ev in s.preemption_follow_up_evals(
                        preempted, index,
                        job_lookup=lambda jid: self.state.job_by_id(None, jid)):
                    self.state.upsert_evals(self.next_index(), [ev])
                    self.create_evals.append(ev)
            return result, None

    def update_eval(self, ev: s.Evaluation) -> None:
        with self._plan_lock:
            self.evals.append(ev)
            if self.planner is not None:
                self.planner.update_eval(ev)

    def create_eval(self, ev: s.Evaluation) -> None:
        with self._plan_lock:
            self.create_evals.append(ev)
            if self.planner is not None:
                self.planner.create_eval(ev)

    def reblock_eval(self, ev: s.Evaluation) -> None:
        with self._plan_lock:
            old = self.state.eval_by_id(None, ev.id)
            if old is None:
                raise ValueError("evaluation does not exist to be reblocked")
            if old.status != s.EVAL_STATUS_BLOCKED:
                raise ValueError(
                    f"evaluation {old.id!r} is not already in a blocked state")
            self.reblock_evals.append(ev)

    # -- helpers -----------------------------------------------------------

    def next_index(self) -> int:
        with self._index_lock:
            idx = self._next_index
            self._next_index += 1
            return idx

    def snapshot(self):
        return self.state.snapshot()
