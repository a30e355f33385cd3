"""Feasibility checking: source iterators, constraint checkers and the
computed-class caching wrapper (a copy of
``nomad_tpu/scheduler/feasible.py``; reference scheduler/feasible.go).

The CPU oracle's per-(task group, node) predicates.  The device pass
evaluates the vectorizable ones as compares over attribute codes
(``ops/kernels.feasibility_matrix``); the batch encoder calls
``check_constraint`` for the rows it precomputes on the host, and the
failure forensics replay the checkers over the filtered nodes.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Set

from ..structs import structs as s
from ..utils import version as goversion
from .context import ComputedClassFeasibility, EvalContext


class StaticIterator:
    """Yields nodes in fixed order; base of the iterator chain
    (feasible.go:34-78).

    With ``lazy_shuffle`` armed it yields an incremental Fisher-Yates
    order instead: position i is finalized (one rng draw + swap) only
    when first consumed.  The LimitIterator at the top of the stack
    consumes O(log N) candidates of an N-node shuffle, and the eager
    O(N) shuffle was the single largest scheduler cost in the
    control-plane load-harness profile.  The finalized prefix is stable
    across reset()/wrap-around, so within one arming the order is
    exactly one fixed shuffle, same as the eager version."""

    def __init__(self, ctx: EvalContext, nodes: Optional[List[s.Node]],
                 rng=None):
        self.ctx = ctx
        self.nodes: List[s.Node] = nodes or []
        self.offset = 0
        self.seen = 0
        self.rng = rng
        self._finalized = 0

    def lazy_shuffle(self, rng) -> None:
        """Arm (or re-arm) incremental shuffling of the current node
        list; already-finalized positions are forgotten."""
        self.rng = rng
        self._finalized = 0

    def next_option(self) -> Optional[s.Node]:
        n = len(self.nodes)
        if self.offset == n or self.seen == n:
            if self.seen != n:
                self.offset = 0
            else:
                return None
        if self.rng is not None and self.offset >= self._finalized:
            j = self.offset + self.rng.randrange(n - self.offset)
            nodes = self.nodes
            nodes[self.offset], nodes[j] = nodes[j], nodes[self.offset]
            self._finalized = self.offset + 1
        option = self.nodes[self.offset]
        self.offset += 1
        self.seen += 1
        self.ctx.metrics.evaluate_node()
        return option

    def reset(self) -> None:
        self.seen = 0

    def set_nodes(self, nodes: List[s.Node]) -> None:
        self.nodes = nodes
        self.offset = 0
        self.seen = 0
        self._finalized = 0


class DriverChecker:
    """Node must advertise every required driver as a truthy
    ``driver.<name>`` attribute (feasible.go:92-143)."""

    def __init__(self, ctx: EvalContext, drivers: Optional[Set[str]] = None):
        self.ctx = ctx
        self.drivers = drivers or set()

    def set_drivers(self, drivers: Set[str]) -> None:
        self.drivers = drivers

    def feasible(self, option: s.Node) -> bool:
        if self._has_drivers(option):
            return True
        self.ctx.metrics.filter_node(option, "missing drivers")
        return False

    def _has_drivers(self, option: s.Node) -> bool:
        for driver in self.drivers:
            value = option.attributes.get(f"driver.{driver}")
            if value is None:
                return False
            enabled = parse_bool(value)
            if enabled is None:
                self.ctx.logger.warning(
                    "node %s has invalid driver setting driver.%s=%s",
                    option.id, driver, value)
                return False
            if not enabled:
                return False
        return True


def parse_bool(value: str) -> Optional[bool]:
    """Go ``strconv.ParseBool``."""
    if value in ("1", "t", "T", "true", "TRUE", "True"):
        return True
    if value in ("0", "f", "F", "false", "FALSE", "False"):
        return False
    return None


class ConstraintChecker:
    """Evaluates a set of constraints against one node
    (feasible.go:355-396)."""

    def __init__(self, ctx: EvalContext, constraints: Optional[List[s.Constraint]] = None):
        self.ctx = ctx
        self.constraints = constraints or []

    def set_constraints(self, constraints: List[s.Constraint]) -> None:
        self.constraints = constraints

    def feasible(self, option: s.Node) -> bool:
        for constraint in self.constraints:
            if not self._meets_constraint(constraint, option):
                self.ctx.metrics.filter_node(option, str(constraint))
                return False
        return True

    def _meets_constraint(self, constraint: s.Constraint, option: s.Node) -> bool:
        lval, lok = resolve_constraint_target(constraint.ltarget, option)
        if not lok:
            return False
        rval, rok = resolve_constraint_target(constraint.rtarget, option)
        if not rok:
            return False
        return check_constraint(self.ctx, constraint.operand, lval, rval)


def resolve_constraint_target(target: str, node: s.Node):
    """Interpolate ``${node.*}/${attr.*}/${meta.*}`` targets
    (feasible.go:397-430); non-interpolated targets are literals."""
    if not target.startswith("${"):
        return target, True
    if target == "${node.unique.id}":
        return node.id, True
    if target == "${node.datacenter}":
        return node.datacenter, True
    if target == "${node.unique.name}":
        return node.name, True
    if target == "${node.class}":
        return node.node_class, True
    if target.startswith("${attr."):
        attr = target[len("${attr."):].rstrip("}")
        if attr in node.attributes:
            return node.attributes[attr], True
        return None, False
    if target.startswith("${meta."):
        key = target[len("${meta."):].rstrip("}")
        if key in node.meta:
            return node.meta[key], True
        return None, False
    return None, False


def check_constraint(ctx: EvalContext, operand: str, lval, rval) -> bool:
    """Dispatch one constraint operand (feasible.go:433-458)."""
    if operand in (s.CONSTRAINT_DISTINCT_HOSTS, s.CONSTRAINT_DISTINCT_PROPERTY):
        # Handled by dedicated iterators, pass here.
        return True
    if operand in ("=", "==", "is"):
        return lval == rval
    if operand in ("!=", "not"):
        return lval != rval
    if operand in ("<", "<=", ">", ">="):
        return _check_lexical_order(operand, lval, rval)
    if operand == s.CONSTRAINT_VERSION:
        return _check_version_constraint(ctx, lval, rval)
    if operand == s.CONSTRAINT_REGEX:
        return _check_regexp_constraint(ctx, lval, rval)
    if operand == s.CONSTRAINT_SET_CONTAINS:
        return _check_set_contains(lval, rval)
    return False


def _check_lexical_order(op: str, lval, rval) -> bool:
    if not isinstance(lval, str) or not isinstance(rval, str):
        return False
    if op == "<":
        return lval < rval
    if op == "<=":
        return lval <= rval
    if op == ">":
        return lval > rval
    if op == ">=":
        return lval >= rval
    return False


def _check_version_constraint(ctx: EvalContext, lval, rval) -> bool:
    """(feasible.go:487) with the per-eval constraint cache."""
    if isinstance(lval, int):
        lval = str(lval)
    if not isinstance(lval, str) or not isinstance(rval, str):
        return False
    vers = goversion.parse_version(lval)
    if vers is None:
        return False
    cache = ctx.cache.constraint_cache
    if rval in cache:
        constraints = cache[rval]
    else:
        constraints = goversion.parse_constraints(rval)
        cache[rval] = constraints
    if constraints is None:
        return False
    return constraints.check(vers)


def _check_regexp_constraint(ctx: EvalContext, lval, rval) -> bool:
    """(feasible.go:530) with the per-eval regex cache."""
    if not isinstance(lval, str) or not isinstance(rval, str):
        return False
    cache = ctx.cache.re_cache
    if rval in cache:
        pattern = cache[rval]
    else:
        try:
            pattern = re.compile(rval)
        except re.error:
            pattern = None
        cache[rval] = pattern
    if pattern is None:
        return False
    return pattern.search(lval) is not None


def _check_set_contains(lval, rval) -> bool:
    """Left comma-set must contain every right comma-element
    (feasible.go:563)."""
    if not isinstance(lval, str) or not isinstance(rval, str):
        return False
    have = {part.strip() for part in lval.split(",")}
    return all(part.strip() in have for part in rval.split(","))


class DistinctHostsIterator:
    """Filters nodes that already host an alloc of this job/TG when a
    distinct_hosts constraint is present (feasible.go:148-243)."""

    def __init__(self, ctx: EvalContext, source):
        self.ctx = ctx
        self.source = source
        self.tg: Optional[s.TaskGroup] = None
        self.job: Optional[s.Job] = None
        self.tg_distinct = False
        self.job_distinct = False

    def set_task_group(self, tg: s.TaskGroup) -> None:
        self.tg = tg
        self.tg_distinct = self._has_distinct_hosts(tg.constraints)

    def set_job(self, job: s.Job) -> None:
        self.job = job
        self.job_distinct = self._has_distinct_hosts(job.constraints)

    @staticmethod
    def _has_distinct_hosts(constraints: List[s.Constraint]) -> bool:
        return any(c.operand == s.CONSTRAINT_DISTINCT_HOSTS for c in constraints)

    def next_option(self) -> Optional[s.Node]:
        while True:
            option = self.source.next_option()
            if option is None or not (self.job_distinct or self.tg_distinct):
                return option
            if not self._satisfies(option):
                self.ctx.metrics.filter_node(option, s.CONSTRAINT_DISTINCT_HOSTS)
                continue
            return option

    def _satisfies(self, option: s.Node) -> bool:
        proposed = self.ctx.proposed_allocs(option.id)
        for alloc in proposed:
            job_collision = alloc.job_id == self.job.id
            task_collision = alloc.task_group == self.tg.name
            if (self.job_distinct and job_collision) or (job_collision and task_collision):
                return False
        return True

    def reset(self) -> None:
        self.source.reset()


class DistinctPropertyIterator:
    """Filters nodes whose property value is already used by the job's
    allocs when a distinct_property constraint exists
    (feasible.go:248-352)."""

    def __init__(self, ctx: EvalContext, source):
        self.ctx = ctx
        self.source = source
        self.tg: Optional[s.TaskGroup] = None
        self.job: Optional[s.Job] = None
        self.has_distinct_property = False
        self.job_property_sets: List = []
        self.group_property_sets: Dict[str, List] = {}

    def set_task_group(self, tg: s.TaskGroup) -> None:
        from .propertyset import PropertySet

        self.tg = tg
        if tg.name not in self.group_property_sets:
            sets = []
            for c in tg.constraints:
                if c.operand != s.CONSTRAINT_DISTINCT_PROPERTY:
                    continue
                pset = PropertySet(self.ctx, self.job)
                pset.set_tg_constraint(c, tg.name)
                sets.append(pset)
            self.group_property_sets[tg.name] = sets
        self.has_distinct_property = bool(
            self.job_property_sets or self.group_property_sets[tg.name]
        )

    def set_job(self, job: s.Job) -> None:
        from .propertyset import PropertySet

        self.job = job
        for c in job.constraints:
            if c.operand != s.CONSTRAINT_DISTINCT_PROPERTY:
                continue
            pset = PropertySet(self.ctx, job)
            pset.set_job_constraint(c)
            self.job_property_sets.append(pset)

    def next_option(self) -> Optional[s.Node]:
        while True:
            option = self.source.next_option()
            if option is None or not self.has_distinct_property:
                return option
            if not self._satisfies(option, self.job_property_sets):
                continue
            if not self._satisfies(option, self.group_property_sets.get(self.tg.name, [])):
                continue
            return option

    def _satisfies(self, option: s.Node, psets) -> bool:
        for pset in psets:
            ok, reason = pset.satisfies_distinct_properties(option, self.tg.name)
            if not ok:
                self.ctx.metrics.filter_node(option, reason)
                return False
        return True

    def reset(self) -> None:
        self.source.reset()
        for pset in self.job_property_sets:
            pset.populate_proposed()
        for sets in self.group_property_sets.values():
            for pset in sets:
                pset.populate_proposed()


class FeasibilityWrapper:
    """Runs job/TG feasibility checks with per-computed-class caching and
    escape semantics (feasible.go:597-708)."""

    def __init__(self, ctx: EvalContext, source, job_checkers, tg_checkers):
        self.ctx = ctx
        self.source = source
        self.job_checkers = job_checkers
        self.tg_checkers = tg_checkers
        self.tg = ""

    def set_task_group(self, tg: str) -> None:
        self.tg = tg

    def reset(self) -> None:
        self.source.reset()

    def next_option(self) -> Optional[s.Node]:
        elig = self.ctx.eligibility()
        metrics = self.ctx.metrics
        while True:
            option = self.source.next_option()
            if option is None:
                return None

            job_escaped = job_unknown = False
            status = elig.job_status(option.computed_class)
            if status == ComputedClassFeasibility.INELIGIBLE:
                metrics.filter_node(option, "computed class ineligible")
                continue
            elif status == ComputedClassFeasibility.ESCAPED:
                job_escaped = True
            elif status == ComputedClassFeasibility.UNKNOWN:
                job_unknown = True

            if not self._run_checks(self.job_checkers, option, job_escaped,
                                    lambda ok: elig.set_job_eligibility(ok, option.computed_class)):
                continue
            if not job_escaped and job_unknown:
                elig.set_job_eligibility(True, option.computed_class)

            tg_escaped = tg_unknown = False
            status = elig.task_group_status(self.tg, option.computed_class)
            if status == ComputedClassFeasibility.INELIGIBLE:
                metrics.filter_node(option, "computed class ineligible")
                continue
            elif status == ComputedClassFeasibility.ELIGIBLE:
                return option
            elif status == ComputedClassFeasibility.ESCAPED:
                tg_escaped = True
            elif status == ComputedClassFeasibility.UNKNOWN:
                tg_unknown = True

            if not self._run_checks(
                self.tg_checkers, option, tg_escaped,
                lambda ok: elig.set_task_group_eligibility(ok, self.tg, option.computed_class),
            ):
                continue
            if not tg_escaped and tg_unknown:
                elig.set_task_group_eligibility(True, self.tg, option.computed_class)
            return option

    @staticmethod
    def _run_checks(checkers, option, escaped, mark) -> bool:
        for checker in checkers:
            if not checker.feasible(option):
                if not escaped:
                    mark(False)
                return False
        return True
