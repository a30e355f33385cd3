"""Deterministic, seeded fault injection (a minimal copy of
``nomad_tpu/fault.py``).

The port has one fault point, ``ops.kernel_result`` (the device→host
placement outputs, ops/batch_sched.py), and one action, ``corrupt``,
which hands the site a seeded RNG to damage the result with::

    with fault.scenario({"seed": 5, "faults": [
            {"point": "ops.kernel_result", "action": "corrupt",
             "times": 1}]}):
        ...
        fault.trace()   # [("ops.kernel_result", 0, "corrupt")]

Disarmed (the default) a fault point costs one module-global load.
"""
from __future__ import annotations

import random
from types import SimpleNamespace
from typing import List, Optional, Tuple

# The armed scenario's rules and fire trace; None: disarmed.
_PLANE: Optional[SimpleNamespace] = None


def faultpoint(name: str) -> Optional[SimpleNamespace]:
    """None when disarmed or when no rule fires; else the action
    (``kind``, and the rule's private ``rng``)."""
    plane = _PLANE
    if plane is None:
        return None
    for i, rule in enumerate(plane.rules):
        if rule.point == name and (rule.times is None
                                   or rule.fired < rule.times):
            rule.fired += 1
            plane.trace.append((name, i, rule.action))
            return SimpleNamespace(kind=rule.action, rng=rule.rng)
    return None


def trace() -> List[Tuple[str, int, str]]:
    plane = _PLANE
    return list(plane.trace) if plane is not None else []


class scenario:
    """``with fault.scenario({"seed": s, "faults": [rules]}): ...``; each
    rule is ``{"point", "action": "corrupt", "times"}``; always disarms
    on exit."""

    def __init__(self, cfg):
        seed = int(cfg.get("seed", 0))
        rules = []
        for i, spec in enumerate(cfg.get("faults") or []):
            if spec["action"] != "corrupt":
                raise ValueError(f"unknown fault action {spec['action']!r}")
            rules.append(SimpleNamespace(
                point=spec["point"], action=spec["action"],
                times=spec.get("times"), fired=0,
                rng=random.Random(f"{seed}/{i}/{spec['point']}")))
        self.plane = SimpleNamespace(rules=rules, trace=[])

    def __enter__(self):
        global _PLANE
        _PLANE = self.plane
        return self.plane

    def __exit__(self, *exc) -> None:
        global _PLANE
        _PLANE = None
