"""SystemScheduler: one alloc per feasible node (a copy of
``nomad_tpu/scheduler/system.py``; reference scheduler/system_sched.go).
Registered as ``system`` (what ``Server.job_plan`` runs for a system
job); the server's workers route system evals to its vectorized
subclass, ``ops/system_batch.py`` (``torch-system``)."""
from __future__ import annotations

import logging
import random
from typing import Dict, List, Optional

from ..structs import structs as s
from ..structs.funcs import filter_terminal_allocs
from .context import EvalContext
from .scheduler import register_scheduler
from .stack import SystemStack
from .util import (
    ALLOC_LOST,
    ALLOC_NOT_NEEDED,
    ALLOC_UPDATING,
    AllocTuple,
    SetStatusError,
    adjust_queued_allocations,
    desired_updates,
    diff_system_allocs,
    evict_and_place,
    inplace_update,
    progress_made,
    ready_nodes_in_dcs,
    retry_max,
    set_status,
    tainted_nodes,
    update_non_terminal_allocs_to_lost,
)

MAX_SYSTEM_SCHEDULE_ATTEMPTS = 5  # system_sched.go:12-15


class SystemScheduler:
    def __init__(self, logger: logging.Logger, state, planner,
                 rng: Optional[random.Random] = None):
        self.logger = logger
        self.state = state
        self.planner = planner
        self.rng = rng

        self.eval: Optional[s.Evaluation] = None
        self.job: Optional[s.Job] = None
        self.plan: Optional[s.Plan] = None
        self.plan_result: Optional[s.PlanResult] = None
        self.ctx: Optional[EvalContext] = None
        self.stack: Optional[SystemStack] = None
        self.nodes: List[s.Node] = []
        self.nodes_by_dc: Dict[str, int] = {}

        self.limit_reached = False
        self.next_eval: Optional[s.Evaluation] = None
        self.failed_tg_allocs: Optional[Dict[str, s.AllocMetric]] = None
        self.queued_allocs: Dict[str, int] = {}

    def process(self, ev: s.Evaluation) -> None:
        """(system_sched.go:56)."""
        self.eval = ev
        if ev.triggered_by not in (
            s.EVAL_TRIGGER_JOB_REGISTER,
            s.EVAL_TRIGGER_NODE_UPDATE,
            s.EVAL_TRIGGER_JOB_DEREGISTER,
            s.EVAL_TRIGGER_ROLLING_UPDATE,
        ):
            desc = f"scheduler cannot handle '{ev.triggered_by}' evaluation reason"
            set_status(self.logger, self.planner, ev, self.next_eval, None,
                       self.failed_tg_allocs, s.EVAL_STATUS_FAILED, desc, self.queued_allocs)
            return

        try:
            retry_max(MAX_SYSTEM_SCHEDULE_ATTEMPTS, self._process,
                      lambda: progress_made(self.plan_result))
        except SetStatusError as err:
            set_status(self.logger, self.planner, ev, self.next_eval, None,
                       self.failed_tg_allocs, err.eval_status, str(err), self.queued_allocs)
            return

        set_status(self.logger, self.planner, ev, self.next_eval, None,
                   self.failed_tg_allocs, s.EVAL_STATUS_COMPLETE, "", self.queued_allocs)

    def _process(self) -> bool:
        """(system_sched.go:88)."""
        self.job = self.state.job_by_id(None, self.eval.job_id)
        self.queued_allocs = {}

        if self.job is not None and not self.job.stopped():
            self.nodes, self.nodes_by_dc = ready_nodes_in_dcs(
                self.state, self.job.datacenters)

        self.plan = self.eval.make_plan(self.job)
        self.failed_tg_allocs = None
        self.ctx = EvalContext(self.state, self.plan, self.logger, rng=self.rng)
        self.stack = SystemStack(self.ctx)
        if self.job is not None and not self.job.stopped():
            self.stack.set_job(self.job)

        self._compute_job_allocs()

        if self.plan.is_no_op() and not self.eval.annotate_plan:
            return True

        if self.limit_reached and self.next_eval is None:
            self.next_eval = self.eval.next_rolling_eval(self.job.update.stagger)
            self.planner.create_eval(self.next_eval)

        result, new_state = self.planner.submit_plan(self.plan)
        self.plan_result = result

        adjust_queued_allocations(self.logger, result, self.queued_allocs)

        if new_state is not None:
            self.state = new_state
            return False

        full_commit, expected, actual = result.full_commit(self.plan)
        if not full_commit:
            self.logger.debug("attempted %d placements, %d placed", expected, actual)
            return False
        return True

    def _compute_job_allocs(self) -> None:
        """(system_sched.go:181)."""
        allocs = self.state.allocs_by_job(None, self.eval.job_id, True)
        tainted = tainted_nodes(self.state, allocs)
        update_non_terminal_allocs_to_lost(self.plan, tainted, allocs)
        allocs, terminal_allocs = filter_terminal_allocs(allocs)

        diff = diff_system_allocs(self.job, self.nodes, tainted, allocs, terminal_allocs)
        self.logger.debug("eval %s job %s: %s", self.eval.id, self.eval.job_id, diff)

        for e in diff.stop:
            self.plan.append_update(e.alloc, s.ALLOC_DESIRED_STATUS_STOP, ALLOC_NOT_NEEDED)
        for e in diff.lost:
            self.plan.append_update(e.alloc, s.ALLOC_DESIRED_STATUS_STOP, ALLOC_LOST,
                                    s.ALLOC_CLIENT_STATUS_LOST)

        destructive, inplace = inplace_update(self.ctx, self.eval, self.job,
                                              self.stack, diff.update)
        diff.update = destructive

        if self.eval.annotate_plan:
            self.plan.annotations = s.PlanAnnotations(
                desired_tg_updates=desired_updates(diff, inplace, destructive))

        limit_box = [len(diff.update)]
        if self.job is not None and not self.job.stopped() and self.job.update.rolling():
            limit_box[0] = self.job.update.max_parallel

        self.limit_reached = evict_and_place(
            self.ctx, diff, diff.update, ALLOC_UPDATING, limit_box)

        if not diff.place:
            if self.job is not None and not self.job.stopped():
                for tg in self.job.task_groups:
                    self.queued_allocs[tg.name] = 0
            return

        for tup in diff.place:
            self.queued_allocs[tup.task_group.name] = (
                self.queued_allocs.get(tup.task_group.name, 0) + 1)

        self._compute_placements(diff.place)

    def _compute_placements(self, place: List[AllocTuple]) -> None:
        """Per-node Select loop (system_sched.go:258)."""
        node_by_id = {n.id: n for n in self.nodes}
        for missing in place:
            node = node_by_id.get(missing.alloc.node_id)
            if node is None:
                raise KeyError(f"could not find node {missing.alloc.node_id!r}")

            self.stack.set_nodes([node])
            option, _ = self.stack.select(missing.task_group)

            if option is None:
                # Constraint-filtered nodes are not 'queued' failures for
                # system jobs (system_sched.go:276-292).
                if self.ctx.metrics.nodes_filtered > 0:
                    self.queued_allocs[missing.task_group.name] -= 1
                    if (self.eval.annotate_plan and self.plan.annotations is not None
                            and self.plan.annotations.desired_tg_updates):
                        desired = self.plan.annotations.desired_tg_updates.get(
                            missing.task_group.name)
                        if desired is not None:
                            desired.place -= 1
                existing_metric = (self.failed_tg_allocs or {}).get(missing.task_group.name)
                if existing_metric is not None:
                    existing_metric.coalesced_failures += 1
                    continue

            self.ctx.metrics.nodes_available = self.nodes_by_dc

            if option is not None:
                alloc = s.Allocation(
                    id=s.generate_uuid(),
                    eval_id=self.eval.id,
                    namespace=self.job.namespace,
                    name=missing.name,
                    job_id=self.job.id,
                    task_group=missing.task_group.name,
                    metrics=self.ctx.metrics,
                    node_id=option.node.id,
                    task_resources=option.task_resources,
                    desired_status=s.ALLOC_DESIRED_STATUS_RUN,
                    client_status=s.ALLOC_CLIENT_STATUS_PENDING,
                    shared_resources=s.Resources(
                        disk_mb=missing.task_group.ephemeral_disk.size_mb),
                )
                if missing.alloc is not None and missing.alloc.id:
                    alloc.previous_allocation = missing.alloc.id
                self.plan.append_alloc(alloc)
            else:
                if self.failed_tg_allocs is None:
                    self.failed_tg_allocs = {}
                self.failed_tg_allocs[missing.task_group.name] = self.ctx.metrics


def new_system_scheduler(logger, state, planner) -> SystemScheduler:
    return SystemScheduler(logger, state, planner)


register_scheduler(s.JOB_TYPE_SYSTEM, new_system_scheduler)
