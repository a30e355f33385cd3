"""Human-readable plan-diff annotations for the ``job plan`` dry run (a
copy of ``nomad_tpu/scheduler/annotate.py``; reference
scheduler/annotate.go:37-214): decorate a JobDiff with the scheduler's
DesiredUpdates counts, flag count changes as forces-create/destroy, and
classify each task change as in-place or destructive with the rules of
tasksUpdated (scheduler/util.go:336).
"""

from __future__ import annotations

from typing import Optional

from ..structs import structs as s
from ..structs.diff import (DIFF_TYPE_ADDED, DIFF_TYPE_DELETED, DIFF_TYPE_NONE,
                            JobDiff, TaskDiff, TaskGroupDiff)

ANNOTATION_FORCES_CREATE = "forces create"
ANNOTATION_FORCES_DESTROY = "forces destroy"
ANNOTATION_FORCES_INPLACE_UPDATE = "forces in-place update"
ANNOTATION_FORCES_DESTRUCTIVE_UPDATE = "forces create/destroy update"

UPDATE_TYPE_IGNORE = "ignore"
UPDATE_TYPE_CREATE = "create"
UPDATE_TYPE_DESTROY = "destroy"
UPDATE_TYPE_MIGRATE = "migrate"
UPDATE_TYPE_INPLACE_UPDATE = "in-place update"
UPDATE_TYPE_DESTRUCTIVE_UPDATE = "create/destroy update"

# Object changes that can be applied without restarting the task
# (annotate.go:180-190).  The port's tasks carry no log config or
# services (nor a kill timeout, below); the rules stay the reference's.
_INPLACE_OBJECTS = {"LogConfig", "Service", "Constraint"}


def annotate(diff: JobDiff, annotations: Optional[s.PlanAnnotations]) -> None:
    """annotate.go:37 Annotate."""
    for tg_diff in diff.task_groups:
        _annotate_task_group(tg_diff, annotations)


def _annotate_task_group(diff: TaskGroupDiff,
                         annotations: Optional[s.PlanAnnotations]) -> None:
    if annotations is not None:
        tg = annotations.desired_tg_updates.get(diff.name)
        if tg is not None:
            for label, count in (
                    (UPDATE_TYPE_IGNORE, tg.ignore),
                    (UPDATE_TYPE_CREATE, tg.place),
                    (UPDATE_TYPE_MIGRATE, tg.migrate),
                    (UPDATE_TYPE_DESTROY, tg.stop),
                    (UPDATE_TYPE_INPLACE_UPDATE, tg.in_place_update),
                    (UPDATE_TYPE_DESTRUCTIVE_UPDATE, tg.destructive_update)):
                if count:
                    diff.updates[label] = count

    _annotate_count_change(diff)
    for task_diff in diff.tasks:
        _annotate_task(task_diff, diff)


def _annotate_count_change(diff: TaskGroupDiff) -> None:
    """annotate.go:122 -- flag Count field edits as scale up/down."""
    count_diff = next((f for f in diff.fields if f.name == "Count"), None)
    if count_diff is None:
        return
    old = int(count_diff.old) if count_diff.old else 0
    new = int(count_diff.new) if count_diff.new else 0
    if old < new:
        count_diff.annotations.append(ANNOTATION_FORCES_CREATE)
    elif new < old:
        count_diff.annotations.append(ANNOTATION_FORCES_DESTROY)


def _annotate_task(diff: TaskDiff, parent: TaskGroupDiff) -> None:
    """annotate.go:146 -- classify each task change."""
    if diff.type == DIFF_TYPE_NONE:
        return

    # The whole task group is coming or going.
    if parent.type in (DIFF_TYPE_ADDED, DIFF_TYPE_DELETED):
        if diff.type == DIFF_TYPE_ADDED:
            diff.annotations.append(ANNOTATION_FORCES_CREATE)
            return
        if diff.type == DIFF_TYPE_DELETED:
            diff.annotations.append(ANNOTATION_FORCES_DESTROY)
            return

    # Any primitive field change except KillTimeout forces a destructive
    # update; only a small set of object changes are in-place.
    destructive = any(f.name != "KillTimeout" and f.type != DIFF_TYPE_NONE
                      for f in diff.fields)
    if not destructive:
        destructive = any(o.type != DIFF_TYPE_NONE
                          and o.name not in _INPLACE_OBJECTS
                          for o in diff.objects)

    diff.annotations.append(
        ANNOTATION_FORCES_DESTRUCTIVE_UPDATE if destructive
        else ANNOTATION_FORCES_INPLACE_UPDATE)
