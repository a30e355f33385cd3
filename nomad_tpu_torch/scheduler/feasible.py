"""Constraint-target resolution (``nomad_tpu/scheduler/feasible.py:157``)."""
from __future__ import annotations

from typing import Optional

from ..structs.structs import Node


def resolve_constraint_target(target: str, node: Node):
    """Interpolate ``${node.*}``/``${attr.*}``/``${meta.*}`` targets
    (feasible.go:397-430); a target that is not interpolated is a
    literal.  Returns ``(value, ok)``."""
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


def parse_bool(value: str) -> Optional[bool]:
    """Go ``strconv.ParseBool``."""
    if value in ("1", "t", "T", "true", "TRUE", "True"):
        return True
    if value in ("0", "f", "F", "false", "FALSE", "False"):
        return False
    return None
