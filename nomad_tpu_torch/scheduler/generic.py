"""GenericScheduler: service and batch jobs, the CPU oracle (a copy of
``nomad_tpu/scheduler/generic.py``; reference
scheduler/generic_sched.go).  The batch scheduler
(``ops/batch_sched.py``) reconciles through a subclass of it, and routes
to it the evals whose specs the device pass cannot express, the evals
of a batch whose device result was rejected, and a plan that conflicted.
"""
from __future__ import annotations

import logging
import random
from typing import Dict, List, Optional, Tuple

from ..structs import structs as s
from .context import EvalContext
from .scheduler import register_scheduler
from .stack import GenericStack
from .util import (
    ALLOC_LOST,
    ALLOC_MIGRATING,
    ALLOC_NOT_NEEDED,
    ALLOC_UPDATING,
    AllocTuple,
    SetStatusError,
    adjust_queued_allocations,
    desired_updates,
    diff_allocs,
    evict_and_place,
    inplace_update,
    mark_lost_and_place,
    materialize_task_groups,
    progress_made,
    ready_nodes_in_dcs,
    retry_max,
    set_status,
    tainted_nodes,
    update_non_terminal_allocs_to_lost,
)

# Retry budgets (generic_sched.go:14-19).
MAX_SERVICE_SCHEDULE_ATTEMPTS = 5
MAX_BATCH_SCHEDULE_ATTEMPTS = 2

BLOCKED_EVAL_MAX_PLAN_DESC = "created due to placement conflicts"
BLOCKED_EVAL_FAILED_PLACEMENTS = "created to place remaining allocations"


class GenericScheduler:
    """Optimizes placement quality for services; fast mode for batch
    (generic_sched.go:57)."""

    def __init__(self, logger: logging.Logger, state, planner, batch: bool,
                 rng: Optional[random.Random] = None,
                 preemption_enabled: bool = False):
        self.logger = logger
        self.state = state
        self.planner = planner
        self.batch = batch
        self.rng = rng
        self.preemption_enabled = preemption_enabled

        self.eval: Optional[s.Evaluation] = None
        self.job: Optional[s.Job] = None
        self.plan: Optional[s.Plan] = None
        self.plan_result: Optional[s.PlanResult] = None
        self.ctx: Optional[EvalContext] = None
        self.stack: Optional[GenericStack] = None

        self.limit_reached = False
        self.next_eval: Optional[s.Evaluation] = None
        self.blocked: Optional[s.Evaluation] = None
        self.failed_tg_allocs: Optional[Dict[str, s.AllocMetric]] = None
        self.queued_allocs: Dict[str, int] = {}

    # -- entry -------------------------------------------------------------

    def process(self, ev: s.Evaluation) -> None:
        """Handle one evaluation end-to-end (generic_sched.go:104)."""
        self.eval = ev

        if ev.triggered_by not in (
            s.EVAL_TRIGGER_JOB_REGISTER,
            s.EVAL_TRIGGER_NODE_UPDATE,
            s.EVAL_TRIGGER_JOB_DEREGISTER,
            s.EVAL_TRIGGER_ROLLING_UPDATE,
            s.EVAL_TRIGGER_PERIODIC_JOB,
            s.EVAL_TRIGGER_MAX_PLANS,
        ):
            desc = f"scheduler cannot handle '{ev.triggered_by}' evaluation reason"
            set_status(self.logger, self.planner, ev, self.next_eval, self.blocked,
                       self.failed_tg_allocs, s.EVAL_STATUS_FAILED, desc, self.queued_allocs)
            return

        limit = MAX_BATCH_SCHEDULE_ATTEMPTS if self.batch else MAX_SERVICE_SCHEDULE_ATTEMPTS
        try:
            retry_max(limit, self._process, lambda: progress_made(self.plan_result))
        except SetStatusError as err:
            # No forward progress: leave a blocked eval to retry when
            # resources free up (generic_sched.go:130-147).
            self._create_blocked_eval(plan_failure=True)
            set_status(self.logger, self.planner, ev, self.next_eval, self.blocked,
                       self.failed_tg_allocs, err.eval_status, str(err), self.queued_allocs)
            return

        # A blocked eval that still couldn't place everything reblocks
        # itself with refreshed eligibility (generic_sched.go:150-159).
        if self.eval.status == s.EVAL_STATUS_BLOCKED and self.failed_tg_allocs:
            e = self.ctx.eligibility()
            new_eval = self.eval.copy()
            new_eval.escaped_computed_class = e.has_escaped()
            new_eval.class_eligibility = e.get_classes()
            self.planner.reblock_eval(new_eval)
            return

        set_status(self.logger, self.planner, ev, self.next_eval, self.blocked,
                   self.failed_tg_allocs, s.EVAL_STATUS_COMPLETE, "", self.queued_allocs)

    def _create_blocked_eval(self, plan_failure: bool) -> None:
        """(generic_sched.go:163)."""
        e = self.ctx.eligibility()
        escaped = e.has_escaped()
        class_eligibility = {} if escaped else e.get_classes()
        self.blocked = self.eval.create_blocked_eval(class_eligibility, escaped)
        if plan_failure:
            self.blocked.triggered_by = s.EVAL_TRIGGER_MAX_PLANS
            self.blocked.status_description = BLOCKED_EVAL_MAX_PLAN_DESC
        else:
            self.blocked.status_description = BLOCKED_EVAL_FAILED_PLACEMENTS
        self.planner.create_eval(self.blocked)

    # -- one attempt -------------------------------------------------------

    def _process(self) -> bool:
        """(generic_sched.go:184)."""
        self.job = self.state.job_by_id(None, self.eval.job_id)
        self.queued_allocs = {}

        self.plan = self.eval.make_plan(self.job)
        self.failed_tg_allocs = None
        self.ctx = EvalContext(self.state, self.plan, self.logger, rng=self.rng)
        self.stack = GenericStack(self.batch, self.ctx,
                                  preemption_enabled=self.preemption_enabled)
        if self.job is not None and not self.job.stopped():
            self.stack.set_job(self.job)

        self._compute_job_allocs()

        if (self.eval.status != s.EVAL_STATUS_BLOCKED and self.failed_tg_allocs
                and self.blocked is None):
            self._create_blocked_eval(plan_failure=False)

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
            raise RuntimeError("missing state refresh after partial commit")
        return True

    # -- reconciliation ----------------------------------------------------

    def _filter_complete_allocs(
        self, allocs: List[s.Allocation]
    ) -> Tuple[List[s.Allocation], Dict[str, s.Allocation]]:
        """(generic_sched.go:283): batch keeps successfully-finished allocs
        and dedupes re-placed names to the newest incarnation."""

        def should_filter(a: s.Allocation) -> bool:
            if self.batch:
                if a.desired_status in (s.ALLOC_DESIRED_STATUS_STOP,
                                        s.ALLOC_DESIRED_STATUS_EVICT):
                    return not a.ran_successfully()
                return a.client_status == s.ALLOC_CLIENT_STATUS_FAILED
            return a.terminal_status()

        terminal: Dict[str, s.Allocation] = {}
        live: List[s.Allocation] = []
        for a in allocs:
            if should_filter(a):
                prev = terminal.get(a.name)
                if prev is None or prev.create_index < a.create_index:
                    terminal[a.name] = a
            else:
                live.append(a)

        if self.batch:
            by_name: Dict[str, s.Allocation] = {}
            for a in live:
                prev = by_name.get(a.name)
                if prev is None or prev.create_index < a.create_index:
                    by_name[a.name] = a
            live = list(by_name.values())
        return live, terminal

    def _compute_job_allocs(self) -> None:
        """(generic_sched.go:350)."""
        groups: Dict[str, s.TaskGroup] = {}
        if self.job is not None and not self.job.stopped():
            groups = materialize_task_groups(self.job)

        allocs = self.state.allocs_by_job(None, self.eval.job_id, True)
        tainted = tainted_nodes(self.state, allocs)
        update_non_terminal_allocs_to_lost(self.plan, tainted, allocs)
        allocs, terminal_allocs = self._filter_complete_allocs(allocs)

        diff = diff_allocs(self.job, tainted, groups, allocs, terminal_allocs)
        self.logger.debug("eval %s job %s: %s", self.eval.id, self.eval.job_id, diff)

        for e in diff.stop:
            self.plan.append_update(e.alloc, s.ALLOC_DESIRED_STATUS_STOP, ALLOC_NOT_NEEDED)

        destructive, inplace = inplace_update(self.ctx, self.eval, self.job,
                                              self.stack, diff.update)
        diff.update = destructive

        if self.eval.annotate_plan:
            self.plan.annotations = s.PlanAnnotations(
                desired_tg_updates=desired_updates(diff, inplace, destructive))

        limit_box = [len(diff.update) + len(diff.migrate) + len(diff.lost)]
        if self.job is not None and not self.job.stopped() and self.job.update.rolling():
            limit_box[0] = self.job.update.max_parallel

        self.limit_reached = evict_and_place(
            self.ctx, diff, diff.migrate, ALLOC_MIGRATING, limit_box)
        self.limit_reached = self.limit_reached or evict_and_place(
            self.ctx, diff, diff.update, ALLOC_UPDATING, limit_box)
        self.limit_reached = self.limit_reached or mark_lost_and_place(
            self.ctx, diff, diff.lost, ALLOC_LOST, limit_box)

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
        """The inner hot loop (generic_sched.go:434); the batch scheduler
        replaces it with one device pass for the whole batch."""
        nodes, by_dc = ready_nodes_in_dcs(self.state, self.job.datacenters)
        self.stack.set_nodes(nodes)

        for missing in place:
            existing_metric = (self.failed_tg_allocs or {}).get(missing.task_group.name)
            if existing_metric is not None:
                existing_metric.coalesced_failures += 1
                continue

            preferred = self._find_preferred_node(missing)
            if preferred is not None:
                option, _ = self.stack.select_preferring_nodes(
                    missing.task_group, [preferred])
            else:
                option, _ = self.stack.select(missing.task_group)

            self.ctx.metrics.nodes_available = by_dc

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
                if missing.alloc is not None:
                    alloc.previous_allocation = missing.alloc.id
                if option.preempted_allocs:
                    # Evictions the fit depends on commit with (and
                    # gate) the placement; clear the marker so a reused
                    # RankedNode cannot leak victims into later picks.
                    for victim in option.preempted_allocs:
                        self.plan.append_preempted_alloc(victim)
                    option.preempted_allocs = None
                self.plan.append_alloc(alloc)
            else:
                if self.failed_tg_allocs is None:
                    self.failed_tg_allocs = {}
                self.failed_tg_allocs[missing.task_group.name] = self.ctx.metrics

    def _find_preferred_node(self, missing: AllocTuple) -> Optional[s.Node]:
        """Sticky-disk allocs prefer their previous node
        (generic_sched.go:510)."""
        if missing.alloc is None or missing.alloc.job is None:
            return None
        tg = missing.alloc.job.lookup_task_group(missing.alloc.task_group)
        if tg is None or not tg.ephemeral_disk.sticky:
            return None
        node = self.state.node_by_id(None, missing.alloc.node_id)
        if node is not None and node.ready():
            return node
        return None


def new_service_scheduler(logger, state, planner, **kwargs
                          ) -> GenericScheduler:
    return GenericScheduler(logger, state, planner, batch=False, **kwargs)


def new_batch_scheduler(logger, state, planner, **kwargs) -> GenericScheduler:
    return GenericScheduler(logger, state, planner, batch=True, **kwargs)


register_scheduler(s.JOB_TYPE_SERVICE, new_service_scheduler)
register_scheduler(s.JOB_TYPE_BATCH, new_batch_scheduler)
