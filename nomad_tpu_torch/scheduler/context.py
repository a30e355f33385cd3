"""Evaluation context: plan-aware state view, caches, and the computed-class
eligibility lattice (a copy of ``nomad_tpu/scheduler/context.py``;
reference scheduler/context.go).  The batch encoder also makes one, with
no state or plan, for its per-batch constraint caches."""
from __future__ import annotations

import logging
import random
import re
from enum import IntEnum
from typing import Dict, List, Optional

from ..structs import structs as s
from ..structs.funcs import remove_allocs
from ..structs.node_class import escaped_constraints
from ..utils import version as goversion

# Shared seed source for per-eval PRNGs (EvalContext.rng): seeded once
# from the OS, then each eval draws 64 bits instead of paying its own
# urandom read.
_SEED_SOURCE = random.Random()


class EvalCache:
    """Regex + version-constraint caches, matching the per-eval caches in
    context.go:46-62."""

    def __init__(self) -> None:
        self.re_cache: Dict[str, Optional[re.Pattern]] = {}
        self.constraint_cache: Dict[str, Optional[goversion.Constraints]] = {}


class EvalContext:
    """Tracks contextual info for one evaluation (context.go:66-149)."""

    def __init__(
        self,
        state=None,
        plan: Optional[s.Plan] = None,
        logger: Optional[logging.Logger] = None,
        rng: Optional[random.Random] = None,
    ) -> None:
        self.state = state
        self.plan = plan
        self.logger = logger or logging.getLogger("nomad_tpu_torch.scheduler")
        self.metrics = s.AllocMetric()
        self.cache = EvalCache()
        self._eligibility: Optional[EvalEligibility] = None
        # Per-eval PRNG (the reference's global math/rand); pass one for
        # runs that repeat.  Made lazily: the batch path never draws from
        # it unless the reconciler ranks a node (in-place updates).
        self._rng = rng

    @property
    def rng(self) -> random.Random:
        if self._rng is None:
            # Seeded from the module's source, not the OS: one C call
            # instead of an entropy read per eval.
            self._rng = random.Random(_SEED_SOURCE.getrandbits(64))
        return self._rng

    @rng.setter
    def rng(self, value) -> None:
        self._rng = value

    def reset(self) -> None:
        """Invoked after each placement (context.go:107)."""
        self.metrics = s.AllocMetric()

    def proposed_allocs(self, node_id: str) -> List[s.Allocation]:
        """Existing non-terminal allocs − planned evictions + planned
        placements, deduped by alloc ID (context.go:109)."""
        existing = self.state.allocs_by_node_terminal(None, node_id, False)
        proposed = existing
        update = (self.plan.node_update.get(node_id, [])
                  + self.plan.node_preemptions.get(node_id, []))
        if update:
            proposed = remove_allocs(existing, update)
        by_id = {a.id: a for a in proposed}
        for alloc in self.plan.node_allocation.get(node_id, []):
            by_id[alloc.id] = alloc
        return list(by_id.values())

    def eligibility(self) -> "EvalEligibility":
        if self._eligibility is None:
            self._eligibility = EvalEligibility()
        return self._eligibility


class ComputedClassFeasibility(IntEnum):
    """4-state eligibility lattice (context.go:151-170)."""

    UNKNOWN = 0
    INELIGIBLE = 1
    ELIGIBLE = 2
    ESCAPED = 3


class EvalEligibility:
    """Per-eval cache of node-class eligibility at job and task-group level
    (context.go:174-331); blocked evals carry it."""

    def __init__(self) -> None:
        self.job: Dict[str, ComputedClassFeasibility] = {}
        self.job_escaped = False
        self.task_groups: Dict[str, Dict[str, ComputedClassFeasibility]] = {}
        self.tg_escaped: Dict[str, bool] = {}

    def set_job(self, job: s.Job) -> None:
        self.job_escaped = bool(escaped_constraints(job.constraints))
        for tg in job.task_groups:
            constraints = list(tg.constraints)
            for task in tg.tasks:
                constraints.extend(task.constraints)
            self.tg_escaped[tg.name] = bool(escaped_constraints(constraints))

    def has_escaped(self) -> bool:
        return self.job_escaped or any(self.tg_escaped.values())

    def get_classes(self) -> Dict[str, bool]:
        """Class → eligible map fed into blocked evals (context.go:231)."""
        elig: Dict[str, bool] = {}
        for klass, feas in self.job.items():
            if feas == ComputedClassFeasibility.ELIGIBLE:
                elig[klass] = True
            elif feas == ComputedClassFeasibility.INELIGIBLE:
                elig[klass] = False
        for classes in self.task_groups.values():
            for klass, feas in classes.items():
                if feas == ComputedClassFeasibility.ELIGIBLE:
                    elig[klass] = True
                elif feas == ComputedClassFeasibility.INELIGIBLE:
                    # Don't overwrite an eligibility granted by another TG.
                    elig.setdefault(klass, False)
        return elig

    def job_status(self, klass: str) -> ComputedClassFeasibility:
        if self.job_escaped or not klass:
            return ComputedClassFeasibility.ESCAPED
        return self.job.get(klass, ComputedClassFeasibility.UNKNOWN)

    def set_job_eligibility(self, eligible: bool, klass: str) -> None:
        self.job[klass] = (
            ComputedClassFeasibility.ELIGIBLE if eligible else ComputedClassFeasibility.INELIGIBLE
        )

    def task_group_status(self, tg: str, klass: str) -> ComputedClassFeasibility:
        if not klass:
            return ComputedClassFeasibility.ESCAPED
        if self.tg_escaped.get(tg, False):
            return ComputedClassFeasibility.ESCAPED
        return self.task_groups.get(tg, {}).get(klass, ComputedClassFeasibility.UNKNOWN)

    def set_task_group_eligibility(self, eligible: bool, tg: str, klass: str) -> None:
        value = (
            ComputedClassFeasibility.ELIGIBLE if eligible else ComputedClassFeasibility.INELIGIBLE
        )
        self.task_groups.setdefault(tg, {})[klass] = value
