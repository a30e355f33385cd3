"""Computed node class (a copy of ``nomad_tpu/structs/node_class.py``;
reference nomad/structs/node_class.go:31-94): a stable hash over a node's
non-unique attributes.  Nodes of one computed class are interchangeable
for feasibility, so eligibility is cached per class."""
from __future__ import annotations

import hashlib
from typing import TYPE_CHECKING, List

if TYPE_CHECKING:
    from .structs import Constraint, Node

# Prefix marking node meta/attribute keys excluded from the computed class.
NODE_UNIQUE_NAMESPACE = "unique."


def is_unique_namespace(key: str) -> bool:
    return key.startswith(NODE_UNIQUE_NAMESPACE)


def compute_node_class(node: "Node") -> str:
    """The computed class from the datacenter, the node class and the
    non-unique attributes and meta (node_class.go:31)."""
    h = hashlib.sha1()
    h.update(node.datacenter.encode())
    h.update(b"\x00")
    h.update(node.node_class.encode())
    h.update(b"\x00")
    for source in (node.attributes, node.meta):
        for key in sorted(source):
            if is_unique_namespace(key):
                continue
            h.update(key.encode())
            h.update(b"\x01")
            h.update(str(source[key]).encode())
            h.update(b"\x02")
        h.update(b"\x03")
    return f"v1:{int.from_bytes(h.digest()[:8], 'big')}"


def escaped_constraints(constraints: List["Constraint"]) -> List["Constraint"]:
    """Constraints whose targets read unique per-node identity and so
    escape computed-class caching (node_class.go:70)."""
    return [c for c in constraints
            if _target_escapes(c.ltarget) or _target_escapes(c.rtarget)]


def _target_escapes(target: str) -> bool:
    return (target.startswith("${node.unique.")
            or target.startswith("${attr.unique.")
            or target.startswith("${meta.unique."))
