"""distinct_property bookkeeping: the existing, proposed and cleared values
of a node property across a job's allocations (a copy of
``nomad_tpu/scheduler/propertyset.py``; reference
scheduler/propertyset.go:11-265).

A value is used when it is existing (the job's live allocations in the
state store) or proposed (the eval's plan places on it) and not cleared
(the plan stops the alloc that held it).  The batch scheduler reads the
three sets from the eval's plan after reconciliation.  The list entry
``ops.batch_sched.schedule_batch`` has no state store and no plan: it
calls :func:`dp_used_values` over the live allocations it is given.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..structs import structs as s
from .feasible import resolve_constraint_target


class PropertySet:
    def __init__(self, ctx, job: Optional[s.Job]):
        self.ctx = ctx
        self.job_id = job.id if job is not None else ""
        self.task_group = ""
        self.constraint: Optional[s.Constraint] = None
        self.error_building: Optional[str] = None
        self.existing_values: Set[str] = set()
        self.proposed_values: Set[str] = set()
        self.cleared_values: Set[str] = set()

    def set_job_constraint(self, constraint: s.Constraint) -> None:
        self.constraint = constraint
        self._populate_existing()

    def set_tg_constraint(self, constraint: s.Constraint, task_group: str) -> None:
        self.task_group = task_group
        self.constraint = constraint
        self._populate_existing()

    def _populate_existing(self) -> None:
        allocs = self.ctx.state.allocs_by_job(None, self.job_id, False)
        allocs = self._filter_allocs(allocs, filter_terminal=True)
        nodes = self._build_node_map(allocs)
        self._populate_properties(allocs, nodes, self.existing_values)

    def populate_proposed(self) -> None:
        """Recompute proposed/cleared from the current plan; called whenever
        the plan changes (propertyset.go:103)."""
        self.proposed_values = set()
        self.cleared_values = set()

        stopping: List[s.Allocation] = []
        for updates in self.ctx.plan.node_update.values():
            stopping.extend(updates)
        stopping = self._filter_allocs(stopping, filter_terminal=False)

        proposed: List[s.Allocation] = []
        for pallocs in self.ctx.plan.node_allocation.values():
            proposed.extend(pallocs)
        proposed = self._filter_allocs(proposed, filter_terminal=True)

        nodes = self._build_node_map(stopping + proposed)
        self._populate_properties(stopping, nodes, self.cleared_values)
        self._populate_properties(proposed, nodes, self.proposed_values)
        self.cleared_values -= self.proposed_values

    def satisfies_distinct_properties(self, option: s.Node, tg: str) -> Tuple[bool, str]:
        """(propertyset.go:150)."""
        if self.error_building:
            return False, self.error_building
        value, ok = _get_property(option, self.constraint.ltarget)
        if not ok:
            return False, f"missing property {self.constraint.ltarget!r}"
        for used in (self.existing_values, self.proposed_values):
            if value in used and value not in self.cleared_values:
                return False, (
                    f"distinct_property: {self.constraint.ltarget}={value} already used"
                )
        return True, ""

    def _filter_allocs(self, allocs: List[s.Allocation], filter_terminal: bool) -> List[s.Allocation]:
        out = []
        for alloc in allocs:
            if filter_terminal and alloc.terminal_status():
                continue
            if self.task_group and alloc.task_group != self.task_group:
                continue
            out.append(alloc)
        return out

    def _build_node_map(self, allocs: List[s.Allocation]) -> Dict[str, Optional[s.Node]]:
        nodes: Dict[str, Optional[s.Node]] = {}
        for alloc in allocs:
            if alloc.node_id not in nodes:
                nodes[alloc.node_id] = self.ctx.state.node_by_id(None, alloc.node_id)
        return nodes

    def _populate_properties(self, allocs, nodes, properties: Set[str]) -> None:
        for alloc in allocs:
            value, ok = _get_property(nodes.get(alloc.node_id), self.constraint.ltarget)
            if ok:
                properties.add(value)


def dp_used_values(job: s.Job, tg: s.TaskGroup, constraint: s.Constraint,
                   live_allocs: Iterable[s.Allocation],
                   nodes_by_id: Dict[str, s.Node]) -> Set[str]:
    """The values of ``constraint`` (a distinct_property on the spec
    ``job``/``tg``) that live allocs already hold, as
    ``TPUBatchScheduler._dp_used_values`` (batch_sched.py:840) computes
    them without a plan.  A job-level constraint counts every live alloc
    of the job, a group-level one only that group's
    (``set_job_constraint``/``set_tg_constraint``); terminal allocs, and
    allocs whose node is unknown or lacks the property, add nothing."""
    group = "" if constraint in job.constraints else tg.name
    values: Set[str] = set()
    for alloc in live_allocs:
        if (alloc.job_id != job.id or alloc.terminal_status()
                or (group and alloc.task_group != group)):
            continue
        value, ok = _get_property(nodes_by_id.get(alloc.node_id),
                                  constraint.ltarget)
        if ok:
            values.add(value)
    return values


def _get_property(node: Optional[s.Node], prop: str) -> Tuple[str, bool]:
    if node is None or not prop:
        return "", False
    value, ok = resolve_constraint_target(prop, node)
    if not ok or not isinstance(value, str):
        return "", False
    return value, True
