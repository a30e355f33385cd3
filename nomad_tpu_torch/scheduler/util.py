"""Task-group aggregation (``nomad_tpu/scheduler/util.py:409-427``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Set

from ..structs import structs as s


@dataclass
class TGConstraintTuple:
    """Aggregated constraints, drivers and resource size of a task group
    (util.go:590)."""

    constraints: List[s.Constraint]
    drivers: Set[str]
    size: s.Resources


def task_group_constraints(tg: s.TaskGroup) -> TGConstraintTuple:
    """(util.go:606)."""
    size = s.Resources(disk_mb=tg.ephemeral_disk.size_mb)
    constraints = list(tg.constraints)
    drivers: Set[str] = set()
    for task in tg.tasks:
        drivers.add(task.driver)
        constraints.extend(task.constraints)
        size.add(task.resources)
    return TGConstraintTuple(constraints, drivers, size)
