"""The placement stacks, the composed iterator chains of the CPU oracle
(a copy of ``nomad_tpu/scheduler/stack.py``; reference
scheduler/stack.go).

GenericStack:  Random → FeasibilityWrapper(job; tg-drivers, tg-constraints)
               → DistinctHosts → DistinctProperty → FeasibleRank → BinPack
               → JobAntiAffinity → Limit(max(2, ⌈log₂N⌉) service / 2 batch)
               → MaxScore
SystemStack:   Static → FeasibilityWrapper → DistinctProperty
               → FeasibleRank → BinPack

The batch scheduler (``ops/batch_sched.py``) computes this chain as
masked tensor ops on the device; this is the per-placement oracle.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

from ..structs import structs as s
from .context import EvalContext
from .feasible import (
    ConstraintChecker,
    DistinctHostsIterator,
    DistinctPropertyIterator,
    DriverChecker,
    FeasibilityWrapper,
    StaticIterator,
)
from .rank import BinPackIterator, FeasibleRankIterator, JobAntiAffinityIterator, RankedNode
from .select import LimitIterator, MaxScoreIterator
from .util import task_group_constraints

# Anti-affinity penalty for co-placing allocs of one job (stack.go:10-19).
SERVICE_JOB_ANTI_AFFINITY_PENALTY = 20.0
BATCH_JOB_ANTI_AFFINITY_PENALTY = 10.0


class GenericStack:
    """Service/batch placement stack (stack.go:37-115)."""

    def __init__(self, batch: bool, ctx: EvalContext,
                 preemption_enabled: bool = False):
        self.batch = batch
        self.ctx = ctx

        self.source = StaticIterator(ctx, [])

        self.job_constraint = ConstraintChecker(ctx)
        self.task_group_drivers = DriverChecker(ctx)
        self.task_group_constraint = ConstraintChecker(ctx)
        self.wrapped_checks = FeasibilityWrapper(
            ctx, self.source, [self.job_constraint],
            [self.task_group_drivers, self.task_group_constraint],
        )
        self.distinct_hosts_constraint = DistinctHostsIterator(ctx, self.wrapped_checks)
        self.distinct_property_constraint = DistinctPropertyIterator(
            ctx, self.distinct_hosts_constraint)
        rank_source = FeasibleRankIterator(ctx, self.distinct_property_constraint)
        # Eviction is only offered to service jobs; it only actually
        # preempts when the operator enables preemption (rank.py).
        self.bin_pack = BinPackIterator(ctx, rank_source, evict=not batch,
                                        priority=0,
                                        preemption_enabled=preemption_enabled)
        penalty = BATCH_JOB_ANTI_AFFINITY_PENALTY if batch else SERVICE_JOB_ANTI_AFFINITY_PENALTY
        self.job_anti_aff = JobAntiAffinityIterator(ctx, self.bin_pack, penalty, "")
        self.limit = LimitIterator(ctx, self.job_anti_aff, 2)
        self.max_score = MaxScoreIterator(ctx, self.limit)

    def set_nodes(self, base_nodes: List[s.Node]) -> None:
        """Random order (finalized lazily as consumed — the limit below
        bounds the scan, so an eager O(N) shuffle pays for positions no
        iterator ever reads), then bound candidate scans: 2 for batch
        (power-of-two-choices), max(2, ⌈log₂ N⌉) for service
        (stack.go:118-137)."""
        self.source.set_nodes(base_nodes)
        self.source.lazy_shuffle(self.ctx.rng)

        limit = 2
        n = len(base_nodes)
        if not self.batch and n > 0:
            log_limit = int(math.ceil(math.log2(n))) if n > 1 else 1
            limit = max(limit, log_limit)
        self.limit.set_limit(limit)

    def set_job(self, job: s.Job) -> None:
        self.job_constraint.set_constraints(job.constraints)
        self.distinct_hosts_constraint.set_job(job)
        self.distinct_property_constraint.set_job(job)
        self.bin_pack.set_priority(job.priority)
        self.job_anti_aff.set_job(job.id)
        self.ctx.eligibility().set_job(job)

    def select(self, tg: s.TaskGroup) -> Tuple[Optional[RankedNode], s.Resources]:
        """Pick the best node for one task group (stack.go:148-178)."""
        self.max_score.reset()
        self.ctx.reset()

        tg_constr = task_group_constraints(tg)
        self.task_group_drivers.set_drivers(tg_constr.drivers)
        self.task_group_constraint.set_constraints(tg_constr.constraints)
        self.distinct_hosts_constraint.set_task_group(tg)
        self.distinct_property_constraint.set_task_group(tg)
        self.wrapped_checks.set_task_group(tg.name)
        self.bin_pack.set_task_group(tg)

        option = self.max_score.next_option()
        if (option is None and self.bin_pack.preemption_enabled
                and self.bin_pack.evict and self.bin_pack.priority > 0):
            # Preemption is strictly a last resort: only when NO node
            # fits without eviction does a second pass rank preempting
            # options (rank.py allow_preempt) — so a preemptible-but-
            # full node can never beat free capacity inside the
            # LimitIterator's small candidate sample.
            self.max_score.reset()
            self.bin_pack.allow_preempt = True
            try:
                option = self.max_score.next_option()
            finally:
                self.bin_pack.allow_preempt = False

        if option is not None and len(option.task_resources) != len(tg.tasks):
            for task in tg.tasks:
                option.set_task_resources(task, task.resources)
        return option, tg_constr.size

    def select_preferring_nodes(
        self, tg: s.TaskGroup, nodes: List[s.Node]
    ) -> Tuple[Optional[RankedNode], s.Resources]:
        """Try the preferred nodes first (sticky disk), then fall back
        (stack.go:182)."""
        original = self.source.nodes
        self.source.set_nodes(nodes)
        option, resources = self.select(tg)
        self.source.set_nodes(original)
        if option is not None:
            return option, resources
        return self.select(tg)


class SystemStack:
    """System placement stack: evaluates every node (stack.go:195-286)."""

    def __init__(self, ctx: EvalContext, preemption_enabled: bool = False):
        self.ctx = ctx
        self.source = StaticIterator(ctx, [])
        self.job_constraint = ConstraintChecker(ctx)
        self.task_group_drivers = DriverChecker(ctx)
        self.task_group_constraint = ConstraintChecker(ctx)
        self.wrapped_checks = FeasibilityWrapper(
            ctx, self.source, [self.job_constraint],
            [self.task_group_drivers, self.task_group_constraint],
        )
        self.distinct_property_constraint = DistinctPropertyIterator(ctx, self.wrapped_checks)
        rank_source = FeasibleRankIterator(ctx, self.distinct_property_constraint)
        self.bin_pack = BinPackIterator(ctx, rank_source, evict=True,
                                        priority=0,
                                        preemption_enabled=preemption_enabled)

    def set_nodes(self, base_nodes: List[s.Node]) -> None:
        self.source.set_nodes(base_nodes)

    def set_job(self, job: s.Job) -> None:
        self.job_constraint.set_constraints(job.constraints)
        self.distinct_property_constraint.set_job(job)
        self.bin_pack.set_priority(job.priority)
        self.ctx.eligibility().set_job(job)

    def select(self, tg: s.TaskGroup) -> Tuple[Optional[RankedNode], s.Resources]:
        self.bin_pack.reset()
        self.ctx.reset()

        tg_constr = task_group_constraints(tg)
        self.task_group_drivers.set_drivers(tg_constr.drivers)
        self.task_group_constraint.set_constraints(tg_constr.constraints)
        self.wrapped_checks.set_task_group(tg.name)
        self.distinct_property_constraint.set_task_group(tg)
        self.bin_pack.set_task_group(tg)

        option = self.bin_pack.next_option()
        if (option is None and self.bin_pack.preemption_enabled
                and self.bin_pack.evict and self.bin_pack.priority > 0):
            # Same last-resort second pass as GenericStack.select.
            self.bin_pack.reset()
            self.bin_pack.allow_preempt = True
            try:
                option = self.bin_pack.next_option()
            finally:
                self.bin_pack.allow_preempt = False

        if option is not None and len(option.task_resources) != len(tg.tasks):
            for task in tg.tasks:
                option.set_task_resources(task, task.resources)
        return option, tg_constr.size
