"""Scalar scoring helper (``nomad_tpu/structs/funcs.py:82``)."""
from __future__ import annotations

import math

from .structs import Node, Resources


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
