"""Structural job diff for the ``job plan`` dry run (a copy of
``nomad_tpu/structs/diff.py``).

Reference behavior: nomad/structs/diff.go (JobDiff / TaskGroupDiff / TaskDiff /
ObjectDiff / FieldDiff, diff.go:14-1205).  The reference hand-writes a diff
function per struct; here a single reflection engine walks the dataclasses and
produces the same shape of output: a tree of typed diffs (None / Added /
Deleted / Edited) with Go-style CamelCase field names so the annotation rules
(scheduler/annotate.go:165-190 matches on "KillTimeout", "LogConfig",
"Service", "Constraint", "Count") carry over unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from . import structs as s
from .structs import (DIFF_TYPE_ADDED, DIFF_TYPE_DELETED, DIFF_TYPE_EDITED,
                      DIFF_TYPE_NONE, FieldDiff, JobDiff, ObjectDiff,
                      TaskDiff, TaskGroupDiff)

# Diff types ordered for sorting (diff.go:14-45).
_TYPE_ORDER = {DIFF_TYPE_EDITED: 0, DIFF_TYPE_ADDED: 1,
               DIFF_TYPE_DELETED: 2, DIFF_TYPE_NONE: 3}


# ---------------------------------------------------------------------------
# Name rendering: snake_case dataclass fields -> Go-style CamelCase, matching
# the names the reference emits (and that annotate.go keys on).
# ---------------------------------------------------------------------------

from ..utils.names import go_name  # noqa: E402  (shared with the wire codec)


# Struct-type -> ObjectDiff name, as the reference names them.
_OBJECT_NAMES = {
    s.Constraint: "Constraint",
    s.RestartPolicy: "RestartPolicy",
    s.EphemeralDisk: "EphemeralDisk",
    s.UpdateStrategy: "Update",
    s.PeriodicConfig: "Periodic",
    s.ParameterizedJobConfig: "ParameterizedJob",
    s.LogConfig: "LogConfig",
    s.Service: "Service",
    s.ServiceCheck: "Check",
    s.TaskArtifact: "Artifact",
    s.Template: "Template",
    s.Vault: "Vault",
    s.Resources: "Resources",
    s.NetworkResource: "Network",
    s.DispatchPayloadConfig: "DispatchPayload",
    s.Port: "Port",
}

# Keyed list element types: matched old<->new by this attribute; everything
# else in a list of objects is matched set-wise (equal pairs drop out,
# remainder becomes Added/Deleted) exactly as the reference treats
# constraints/artifacts/templates (diff.go:540-571 uses name keys for
# services; set semantics for the rest).
_LIST_KEYS = {s.Service: "name", s.ServiceCheck: "name", s.Task: "name",
              s.TaskGroup: "name"}

_SCALARS = (str, int, float, bool, bytes)


def _render(v: Any) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v == int(v):
        return str(int(v))
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    return str(v)


def _field_diff(name: str, old: Any, new: Any, contextual: bool) -> Optional[FieldDiff]:
    if old == new:
        if contextual:
            return FieldDiff(DIFF_TYPE_NONE, name, _render(old), _render(new))
        return None
    if old is None:
        return FieldDiff(DIFF_TYPE_ADDED, name, "", _render(new))
    if new is None:
        return FieldDiff(DIFF_TYPE_DELETED, name, _render(old), "")
    return FieldDiff(DIFF_TYPE_EDITED, name, _render(old), _render(new))


def _dict_field_diffs(name: str, old: Optional[Dict], new: Optional[Dict],
                      contextual: bool) -> List[FieldDiff]:
    """Flattened map diffs, rendered as ``Name[key]`` fields (the reference
    flattens maps via flatmap.Flatten, diff.go:870-888)."""
    old = old or {}
    new = new or {}
    out: List[FieldDiff] = []
    for k in sorted(set(old) | set(new)):
        fname = f"{name}[{k}]"
        if k not in old:
            out.append(FieldDiff(DIFF_TYPE_ADDED, fname, "", _render(new[k])))
        elif k not in new:
            out.append(FieldDiff(DIFF_TYPE_DELETED, fname, _render(old[k]), ""))
        elif old[k] != new[k]:
            out.append(FieldDiff(DIFF_TYPE_EDITED, fname, _render(old[k]),
                                 _render(new[k])))
        elif contextual:
            out.append(FieldDiff(DIFF_TYPE_NONE, fname, _render(old[k]),
                                 _render(new[k])))
    return out


def _scalar_list_diffs(name: str, old: Optional[List], new: Optional[List],
                       contextual: bool) -> List[FieldDiff]:
    """Set-semantics diff of scalar lists (e.g. Datacenters, Args)."""
    old_l = list(old or [])
    new_l = list(new or [])
    out: List[FieldDiff] = []
    remaining = list(new_l)
    for v in old_l:
        if v in remaining:
            remaining.remove(v)
            if contextual:
                out.append(FieldDiff(DIFF_TYPE_NONE, name, _render(v), _render(v)))
        else:
            out.append(FieldDiff(DIFF_TYPE_DELETED, name, _render(v), ""))
    for v in remaining:
        out.append(FieldDiff(DIFF_TYPE_ADDED, name, "", _render(v)))
    return out


def _object_list_diffs(old: Optional[List], new: Optional[List],
                       contextual: bool) -> List[ObjectDiff]:
    old_l = list(old or [])
    new_l = list(new or [])
    elem = (old_l + new_l)[0] if (old_l or new_l) else None
    if elem is None:
        return []
    key = _LIST_KEYS.get(type(elem))
    out: List[ObjectDiff] = []
    if key:
        olds = {getattr(o, key): o for o in old_l}
        news = {getattr(n, key): n for n in new_l}
        for k in sorted(set(olds) | set(news)):
            d = object_diff(olds.get(k), news.get(k), contextual)
            if d is not None:
                out.append(d)
    else:
        remaining = list(new_l)
        for o in old_l:
            matched = None
            for n in remaining:
                if o == n:
                    matched = n
                    break
            if matched is not None:
                remaining.remove(matched)
                if contextual:
                    d = object_diff(o, matched, contextual)
                    if d is not None:
                        out.append(d)
            else:
                d = object_diff(o, None, contextual)
                if d is not None:
                    out.append(d)
        for n in remaining:
            d = object_diff(None, n, contextual)
            if d is not None:
                out.append(d)
    return out


def _walk(old: Any, new: Any, contextual: bool, exclude: frozenset = frozenset(),
          ) -> tuple:
    """Diff all dataclass fields of two same-typed objects (either may be
    None). Returns (field_diffs, object_diffs)."""
    proto = old if old is not None else new
    fields: List[FieldDiff] = []
    objects: List[ObjectDiff] = []
    for f in dataclasses.fields(proto):
        if f.name in exclude:
            continue
        name = go_name(f.name)
        ov = getattr(old, f.name, None) if old is not None else None
        nv = getattr(new, f.name, None) if new is not None else None
        sample = ov if ov is not None else nv
        if sample is None or isinstance(sample, _SCALARS):
            d = _field_diff(name, ov, nv, contextual)
            if d is not None:
                fields.append(d)
        elif isinstance(sample, dict):
            vals = list((sample or {}).values())
            if vals and dataclasses.is_dataclass(vals[0]):
                continue  # keyed object maps handled by callers
            fields.extend(_dict_field_diffs(name, ov, nv, contextual))
        elif isinstance(sample, list):
            if sample and dataclasses.is_dataclass(sample[0]):
                objects.extend(_object_list_diffs(ov, nv, contextual))
            else:
                fields.extend(_scalar_list_diffs(name, ov, nv, contextual))
        elif dataclasses.is_dataclass(sample):
            d = object_diff(ov, nv, contextual)
            if d is not None:
                objects.append(d)
    fields.sort(key=lambda d: (d.name, d.old))
    objects.sort(key=lambda d: (d.name, _TYPE_ORDER[d.type]))
    return fields, objects


def _overall(old: Any, new: Any, children_changed: bool) -> str:
    if old is None and new is not None:
        return DIFF_TYPE_ADDED
    if old is not None and new is None:
        return DIFF_TYPE_DELETED
    if children_changed:
        return DIFF_TYPE_EDITED
    return DIFF_TYPE_NONE


def _changed(fields: List[FieldDiff], objects: List[ObjectDiff]) -> bool:
    return (any(f.type != DIFF_TYPE_NONE for f in fields)
            or any(o.type != DIFF_TYPE_NONE for o in objects))


def object_diff(old: Any, new: Any, contextual: bool = False) -> Optional[ObjectDiff]:
    """Diff two nested objects of the same dataclass type (diff.go:507-888)."""
    if old is None and new is None:
        return None
    proto = old if old is not None else new
    name = _OBJECT_NAMES.get(type(proto), type(proto).__name__)
    fields, objects = _walk(old, new, contextual)
    typ = _overall(old, new, _changed(fields, objects))
    if typ == DIFF_TYPE_NONE and not contextual:
        return None
    return ObjectDiff(typ, name, fields, objects)


# Fields that are bookkeeping, not part of the user-visible spec
# (diff.go:69-80 filters these from the job diff).
_JOB_EXCLUDE = frozenset({
    "id", "status", "status_description", "version", "stable", "submit_time",
    "create_index", "modify_index", "job_modify_index", "payload",
    "vault_token", "task_groups",
})
_TG_EXCLUDE = frozenset({"name", "tasks"})
_TASK_EXCLUDE = frozenset({"name"})


def task_diff(old: Optional[s.Task], new: Optional[s.Task],
              contextual: bool = False) -> Optional[TaskDiff]:
    """diff.go:341-440 Task.Diff."""
    if old is None and new is None:
        return None
    proto = old if old is not None else new
    fields, objects = _walk(old, new, contextual, _TASK_EXCLUDE)
    # Driver config is a free-form map -> ObjectDiff named Config
    oc = old.config if old is not None else None
    nc = new.config if new is not None else None
    cfields = _dict_field_diffs("Config", oc, nc, contextual)
    # _walk already flattened config as fields; strip and re-home them.
    fields = [f for f in fields if not f.name.startswith("Config[")]
    if any(f.type != DIFF_TYPE_NONE for f in cfields) or (contextual and cfields):
        ctype = DIFF_TYPE_EDITED if (old is not None and new is not None) else \
            _overall(oc, nc, True)
        objects.append(ObjectDiff(ctype, "Config", cfields, []))
        objects.sort(key=lambda d: (d.name, _TYPE_ORDER[d.type]))
    typ = _overall(old, new, _changed(fields, objects))
    if typ == DIFF_TYPE_NONE and not contextual:
        return None
    return TaskDiff(typ, proto.name, fields, objects)


def task_group_diff(old: Optional[s.TaskGroup], new: Optional[s.TaskGroup],
                    contextual: bool = False) -> Optional[TaskGroupDiff]:
    """diff.go:188-258 TaskGroup.Diff."""
    if old is None and new is None:
        return None
    proto = old if old is not None else new
    fields, objects = _walk(old, new, contextual, _TG_EXCLUDE)
    tasks: List[TaskDiff] = []
    olds = {t.name: t for t in (old.tasks if old else [])}
    news = {t.name: t for t in (new.tasks if new else [])}
    for k in sorted(set(olds) | set(news)):
        d = task_diff(olds.get(k), news.get(k), contextual)
        if d is not None:
            tasks.append(d)
    changed = _changed(fields, objects) or any(
        t.type != DIFF_TYPE_NONE for t in tasks)
    typ = _overall(old, new, changed)
    if typ == DIFF_TYPE_NONE and not contextual:
        return None
    return TaskGroupDiff(typ, proto.name, fields, objects, tasks)


def job_diff(old: Optional[s.Job], new: Optional[s.Job],
             contextual: bool = False) -> JobDiff:
    """diff.go:59-155 Job.Diff.  Raises ValueError when both jobs exist but
    have different IDs (not diffable)."""
    if old is not None and new is not None and old.id != new.id:
        raise ValueError(f"can not diff jobs with different IDs: {old.id!r} vs {new.id!r}")
    proto = old if old is not None else new
    if proto is None:
        return JobDiff(DIFF_TYPE_NONE, "")
    fields, objects = _walk(old, new, contextual, _JOB_EXCLUDE)
    tgs: List[TaskGroupDiff] = []
    olds = {tg.name: tg for tg in (old.task_groups if old else [])}
    news = {tg.name: tg for tg in (new.task_groups if new else [])}
    for k in sorted(set(olds) | set(news)):
        d = task_group_diff(olds.get(k), news.get(k), contextual)
        if d is not None:
            tgs.append(d)
    changed = _changed(fields, objects) or any(
        t.type != DIFF_TYPE_NONE for t in tgs)
    return JobDiff(_overall(old, new, changed), proto.id, fields, objects, tgs)
