"""Deterministic, seeded fault injection (a minimal copy of
``nomad_tpu/fault.py``).

The port's fault points:

- ``ops.kernel_result`` (the device→host placement outputs,
  ops/batch_sched.py), ``ops.resident_state`` (one row of the resident
  usage mirror, ops/resident.py) and ``state.columns`` (one cell of a
  static encode sliced from the columnar mirror, ops/encode.py), each
  with ``corrupt``, which hands the site a seeded RNG to do its damage
  with;
- ``plan.apply`` (server/plan_apply.py, before the commit), with
  ``error`` (raise :class:`InjectedFault`);
- ``raft.apply`` (server/raft.py, before an entry is given its index;
  fault.py:46, raft.py:40-58), with ``crash`` and ``error`` (raise: the
  entry never reaches the log), ``delay`` (sleep the rule's ``delay``
  seconds) and ``step_down`` (the log refuses the entry as a demoted
  leader would);
- ``wal.fsync`` (server/raft.py ``FileLog._persist``, raft.py:551), with
  ``crash``: a torn half frame is left at the tail of the WAL, the log
  is dead for this process, and recovery must truncate the frame; and
  ``delay``.

A rule is ``{"point", "action", "times", "delay", "match"}``: ``match``
holds context values the site passes (``raft.apply`` and ``wal.fsync``
pass ``index`` and ``msg_type``, the message type's name) that must all
be equal for the rule to fire::

    with fault.scenario({"seed": 5, "faults": [
            {"point": "ops.kernel_result", "action": "corrupt",
             "times": 1}]}):
        ...
        fault.trace()   # [("ops.kernel_result", 0, "corrupt")]

Disarmed (the default) a fault point costs one module-global load.
Every fire is mirrored into the tracing plane (a ``fault.fire`` span) and
the cluster event stream (``Fault``/``FaultFired``), as the reference's
``FaultPlane.fire`` does (``fault.py:185-230``).
"""
from __future__ import annotations

import random
import sys
import threading
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

ACTIONS = ("corrupt", "error", "crash", "delay", "step_down")

# The armed scenario's rules and fire trace; None: disarmed.
_PLANE: Optional[SimpleNamespace] = None


class InjectedFault(Exception):
    """An error raised on purpose by a fault point (action ``error``)."""


def _raise_injected(message: str):
    def raise_injected() -> None:
        raise InjectedFault(message)
    return raise_injected


def faultpoint(name: str, **ctx: Any) -> Optional[SimpleNamespace]:
    """None when disarmed or when no rule fires; else the action
    (``kind``, ``delay``, the rule's private ``rng`` and
    ``raise_injected()``)."""
    plane = _PLANE
    if plane is None:
        return None
    for i, rule in enumerate(plane.rules):
        if rule.point != name or any(ctx.get(k) != v
                                     for k, v in rule.match.items()):
            continue
        # Counted under the plane's lock: concurrent sites (the log's
        # appliers) never fire a rule past its ``times``.
        with plane.lock:
            if rule.times is not None and rule.fired >= rule.times:
                continue
            rule.fired += 1
            plane.trace.append((name, i, rule.action))
        # Import here: fires are rare, and the disarmed path must not
        # pay it.
        from .utils import tracing
        tracing.note_fault(name, i, rule.action)
        note_event_stream("Fault", "FaultFired", name,
                          {"Rule": i, "Action": rule.action})
        return SimpleNamespace(
            kind=rule.action, rng=rule.rng, delay=rule.delay,
            raise_injected=_raise_injected(
                f"injected {rule.action} at {name}"))
    return None


def note_event_stream(topic: str, etype: str, key: str,
                      payload: Optional[Dict[str, Any]] = None,
                      eval_id: str = "") -> None:
    """Mirror a cross-cutting occurrence (fault fire, breaker transition,
    resident mirror delta) into the cluster event stream without
    importing the server package: if ``server.event_broker`` was never
    loaded, no broker can be armed anyway."""
    mod = sys.modules.get("nomad_tpu_torch.server.event_broker")
    if mod is not None:
        mod.note_external(topic, etype, key, payload, eval_id)


def trace() -> List[Tuple[str, int, str]]:
    plane = _PLANE
    return list(plane.trace) if plane is not None else []


class scenario:
    """``with fault.scenario({"seed": s, "faults": [rules]}): ...``; each
    rule is ``{"point", "action", "times", "delay", "match"}``; always
    disarms on exit."""

    def __init__(self, cfg):
        seed = int(cfg.get("seed", 0))
        rules = []
        for i, spec in enumerate(cfg.get("faults") or []):
            if spec["action"] not in ACTIONS:
                raise ValueError(f"unknown fault action {spec['action']!r}")
            rules.append(SimpleNamespace(
                point=spec["point"], action=spec["action"],
                times=spec.get("times"), fired=0,
                delay=float(spec.get("delay", 0.05)),
                match=dict(spec.get("match") or {}),
                rng=random.Random(f"{seed}/{i}/{spec['point']}")))
        self.plane = SimpleNamespace(rules=rules, trace=[],
                                     lock=threading.Lock())

    def __enter__(self):
        global _PLANE
        _PLANE = self.plane
        return self.plane

    def __exit__(self, *exc) -> None:
        global _PLANE
        _PLANE = None
