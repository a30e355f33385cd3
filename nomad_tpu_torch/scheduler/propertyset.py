"""distinct_property bookkeeping: the values of a node property that a
job's allocations already use (``nomad_tpu/scheduler/propertyset.py``;
reference scheduler/propertyset.go:11-265).

The reference reads three sets from its state store and the evaluation's
plan: the values of the live allocations ("existing"), of the plan's
placements ("proposed") and of the plan's stops ("cleared"), and a value
is used when it is existing or proposed and not cleared.  The port's
``schedule_batch`` takes its cluster as plain lists and evaluates each
job as a registration, with no plan, so only "existing" is filled, from
the live allocations it is given; "proposed" and "cleared" are empty.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Set, Tuple

from ..structs import structs as s
from .feasible import resolve_constraint_target


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
