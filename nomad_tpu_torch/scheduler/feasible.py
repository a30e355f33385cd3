"""Constraint-target resolution and the host constraint checks
(``nomad_tpu/scheduler/feasible.py:157-265``)."""
from __future__ import annotations

import re
from typing import Optional

from ..structs import structs as s
from ..structs.structs import Node
from ..utils import version as goversion
from .context import EvalContext


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


def check_constraint(ctx: EvalContext, operand: str, lval, rval) -> bool:
    """Dispatch one constraint operand (feasible.go:433-458)."""
    if operand in (s.CONSTRAINT_DISTINCT_HOSTS, s.CONSTRAINT_DISTINCT_PROPERTY):
        # Handled by their own iterators; they pass here.
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
    """(feasible.go:487) with the per-evaluation constraint cache."""
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
    """(feasible.go:530) with the per-evaluation regex cache."""
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
    """The left comma-set must hold every right comma-element
    (feasible.go:563)."""
    if not isinstance(lval, str) or not isinstance(rval, str):
        return False
    have = {part.strip() for part in lval.split(",")}
    return all(part.strip() in have for part in rval.split(","))
