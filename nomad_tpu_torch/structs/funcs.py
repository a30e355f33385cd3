"""Fit and scoring functions (a copy of ``nomad_tpu/structs/funcs.py``;
reference nomad/structs/funcs.go): ``allocs_fit`` (:60) and ``score_fit``
(:123, Google best-fit-v3), the CPU oracle's scalar versions of what the
device pass computes over the whole [U, N] matrix."""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from .network import NetworkIndex
from .structs import Allocation, Node, Resources


def remove_allocs(allocs: List[Allocation],
                  remove: List[Allocation]) -> List[Allocation]:
    """Drop the allocs whose ids appear in ``remove`` (funcs.go:11)."""
    remove_ids = {a.id for a in remove}
    return [a for a in allocs if a.id not in remove_ids]


def filter_terminal_allocs(
    allocs: List[Allocation],
) -> Tuple[List[Allocation], Dict[str, Allocation]]:
    """Split out terminal allocs, keeping the latest terminal alloc per
    name (funcs.go:33)."""
    terminal: Dict[str, Allocation] = {}
    live: List[Allocation] = []
    for alloc in allocs:
        if alloc.terminal_status():
            prev = terminal.get(alloc.name)
            if prev is None or prev.create_index < alloc.create_index:
                terminal[alloc.name] = alloc
        else:
            live.append(alloc)
    return live, terminal


def allocs_fit(
    node: Node,
    allocs: List[Allocation],
    net_idx: Optional[NetworkIndex] = None,
) -> Tuple[bool, str, Resources]:
    """Whether the allocs all fit on the node: ``(fit, exhausted
    dimension, used resources)`` (funcs.go:60).  With ``net_idx`` the
    caller has already checked the ports; otherwise one is built here."""
    used = Resources()
    if node.reserved is not None:
        used.add(node.reserved)

    for alloc in allocs:
        if alloc.resources is not None:
            used.add(alloc.resources)
        elif alloc.task_resources:
            # Plan-internal allocs carry per-task resources with the
            # combined ask stripped: shared + per-task.
            used.add(alloc.shared_resources)
            for task_res in alloc.task_resources.values():
                used.add(task_res)
        else:
            raise ValueError(f"allocation {alloc.id!r} has no resources set")

    ok, dimension = node.resources.superset(used)
    if not ok:
        return False, dimension, used

    if net_idx is None:
        net_idx = NetworkIndex()
        if net_idx.set_node(node) or net_idx.add_allocs(allocs):
            return False, "reserved port collision", used

    if net_idx.overcommitted():
        return False, "bandwidth exceeded", used

    return True, "", used


def score_fit(node: Node, util: Resources) -> float:
    """Google best-fit-v3 bin-packing score in [0, 18] (funcs.go:123):
    ``20 - (10^freeCpuFrac + 10^freeMemFrac)``, clamped."""
    node_cpu = float(node.resources.cpu)
    node_mem = float(node.resources.memory_mb)
    if node.reserved is not None:
        node_cpu -= float(node.reserved.cpu)
        node_mem -= float(node.reserved.memory_mb)
    free_pct_cpu = 1.0 - _safe_div(float(util.cpu), node_cpu)
    free_pct_mem = 1.0 - _safe_div(float(util.memory_mb), node_mem)
    try:
        total = math.pow(10.0, free_pct_cpu) + math.pow(10.0, free_pct_mem)
    except OverflowError:
        total = math.inf
    score = 20.0 - total
    if math.isnan(score):
        return 0.0
    return max(0.0, min(18.0, score))


def _safe_div(num: float, den: float) -> float:
    # Go float division by zero yields +-Inf (NaN for 0/0); the clamp
    # absorbs it.
    if den == 0.0:
        return math.nan if num == 0.0 else math.copysign(math.inf, num)
    return num / den
