"""Deterministic, seeded fault injection (a copy of ``nomad_tpu/fault.py``).

The port's fault points:

- ``ops.kernel_result`` (the device→host placement outputs,
  ops/batch_sched.py), ``ops.resident_state`` (one row of the resident
  usage mirror, ops/resident.py) and ``state.columns`` (one cell of a
  static encode sliced from the columnar mirror, ops/encode.py), each
  with ``corrupt``, which hands the site a seeded RNG to do its damage
  with;
- ``plan.apply`` (server/plan_apply.py, before the commit), with
  ``error``, ``crash`` and ``step_down`` (raise :class:`InjectedFault`)
  and ``delay``;
- ``raft.apply`` (server/raft.py, before an entry is given its index;
  fault.py:46, raft.py:40-58), with ``crash`` and ``error`` (raise: the
  entry never reaches the log), ``delay`` (sleep the rule's ``delay``
  seconds) and ``step_down`` (the log refuses the entry as a demoted
  leader would);
- ``wal.fsync`` (server/raft.py ``FileLog._persist``, raft.py:551), with
  ``crash``: a torn half frame is left at the tail of the WAL, the log
  is dead for this process, and recovery must truncate the frame; and
  ``delay``;
- ``rpc.send`` (every wire frame, server/rpc.py; and the client's
  logical server calls, client/client.py), with ``drop`` (the frame is
  lost), ``delay``, ``dup`` (sent twice), ``truncate`` (half a frame,
  then the connection severed) and ``error``/``crash`` (the transport
  failure a broken wire raises).

A rule is ``{"point", "action", "prob", "after", "times", "delay",
"match", "error"}`` (fault.py:104-141): ``point`` an exact name or an
``fnmatch`` glob; ``match`` holds context values the site passes
(``raft.apply`` and ``wal.fsync`` pass ``index`` and ``msg_type``, the
message type's name) that must all be equal; the first ``after``
matching calls are skipped, at most ``times`` fire, each with
probability ``prob`` drawn from the rule's private RNG (seeded by the
scenario's seed, the rule's index and its point); ``error`` is the
injected exception's message::

    with fault.scenario({"seed": 5, "faults": [
            {"point": "ops.kernel_result", "action": "corrupt",
             "times": 1}]}):
        ...
        fault.trace()   # [("ops.kernel_result", 0, "corrupt")]

Disarmed (the default) a fault point costs one module-global load.

The network chaos plane (``NetPlane``, fault.py:288-582) is a separate
process-wide global, so partitions compose with a rule scenario and are
driven while a run goes on: ``net_partition(name, groups)`` severs the
traffic between addresses matched into different groups (fnmatch
patterns, the most specific pattern wins), ``net_heal(name)`` ends it,
and seeded net rules (``drop``, ``delay``, ``reorder`` on ``dial`` or
``send`` between ``src`` and ``dst`` patterns) shape the rest;
``flap_windows`` derives a split/heal schedule from a seed,
``net_sever_regions`` and ``net_dcn_delay`` build region partitions and
cross-region delays.  ``server/rpc.py``'s ``ConnPool`` asks
:func:`netpoint` at every dial and call with its owner's address.
Every fire is mirrored into the tracing plane (a ``fault.fire`` span) and
the cluster event stream (``Fault``/``FaultFired``), as the reference's
``FaultPlane.fire`` does (``fault.py:185-230``).
"""
from __future__ import annotations

import fnmatch
import random
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

ACTIONS = ("drop", "delay", "dup", "truncate", "error", "crash",
           "step_down", "corrupt")


class InjectedFault(Exception):
    """An error deliberately raised by a fault point (``error`` / ``crash``
    actions).  Distinct type so tests can tell injected failures from real
    bugs surfacing mid-scenario."""


class FaultRule:
    """One scenario rule; see module docstring for field semantics."""

    __slots__ = ("point", "action", "prob", "after", "times", "delay",
                 "match", "message", "seen", "fired", "rng", "index")

    def __init__(self, spec: Dict[str, Any], index: int, seed: int):
        self.point: str = spec["point"]
        self.action: str = spec["action"]
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}")
        self.prob: float = float(spec.get("prob", 1.0))
        self.after: int = int(spec.get("after", 0))
        times = spec.get("times")
        self.times: Optional[int] = None if times is None else int(times)
        self.delay: float = float(spec.get("delay", 0.05))
        self.match: Dict[str, Any] = dict(spec.get("match") or {})
        self.message: str = spec.get(
            "error", f"injected {self.action} at {self.point}")
        self.index = index
        # Private, reproducible stream: str seeding hashes via sha512
        # (CPython seeding version 2), immune to PYTHONHASHSEED.
        self.rng = random.Random(f"{seed}/{index}/{self.point}")
        self.seen = 0    # matching calls observed
        self.fired = 0   # times the action actually fired

    def matches(self, name: str, ctx: Dict[str, Any]) -> bool:
        if name != self.point and not fnmatch.fnmatchcase(name, self.point):
            return False
        for key, want in self.match.items():
            if ctx.get(key) != want:
                return False
        return True


class FaultAction:
    """What a fault point should do right now.  ``rng`` is the owning
    rule's private stream — ``corrupt`` sites draw from it so the damage
    is a pure function of the scenario seed."""

    __slots__ = ("kind", "delay", "message", "rng", "rule")

    def __init__(self, rule: FaultRule):
        self.kind = rule.action
        self.delay = rule.delay
        self.message = rule.message
        self.rng = rule.rng
        self.rule = rule

    def raise_injected(self) -> None:
        raise InjectedFault(self.message)

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"FaultAction({self.kind!r} from rule {self.rule.index})"


class FaultPlane:
    """One armed scenario: rules + counters + the fire trace."""

    def __init__(self, rules: List[Dict[str, Any]], seed: int = 0):
        self.seed = seed
        self.rules = [FaultRule(spec, i, seed)
                      for i, spec in enumerate(rules)]
        self._l = threading.Lock()
        self._trace: List[Tuple[str, int, str]] = []

    def fire(self, name: str, ctx: Dict[str, Any]) -> Optional[FaultAction]:
        """First matching rule that decides to fire wins; counters and the
        probability draw happen under the lock so the per-rule decision
        sequence is deterministic in call order."""
        for rule in self.rules:
            if not rule.matches(name, ctx):
                continue
            with self._l:
                rule.seen += 1
                if rule.seen <= rule.after:
                    continue
                if rule.times is not None and rule.fired >= rule.times:
                    continue
                if rule.prob < 1.0 and rule.rng.random() >= rule.prob:
                    continue
                rule.fired += 1
                self._trace.append((name, rule.index, rule.action))
            # Mirror the fire into the tracing plane (a `fault.fire` span
            # under whatever the current thread is doing) so an eval's
            # timeline names the injection that shaped it.  Import here:
            # fires are rare, and the hot disarmed path must not pay it.
            from .utils import tracing
            tracing.note_fault(name, rule.index, rule.action)
            # ...and into the cluster event stream, so chaos forensics
            # can interleave injections with the state changes they
            # caused.
            note_event_stream("Fault", "FaultFired", name,
                              {"Rule": rule.index, "Action": rule.action})
            return FaultAction(rule)
        return None

    def trace(self) -> List[Tuple[str, int, str]]:
        with self._l:
            return list(self._trace)


# -- process-wide arming -----------------------------------------------------

# The single global the hot path reads.  ``None`` ⇒ disarmed ⇒ every
# faultpoint() call is one load + one comparison.
_PLANE: Optional[FaultPlane] = None


def note_event_stream(topic: str, etype: str, key: str,
                      payload: Optional[Dict[str, Any]] = None,
                      eval_id: str = "") -> None:
    """Mirror a cross-cutting occurrence (fault fire, breaker
    transition) into the cluster event stream without importing the
    server package: if ``server.event_broker`` was never loaded, no
    broker can be armed anyway."""
    mod = sys.modules.get("nomad_tpu_torch.server.event_broker")
    if mod is not None:
        mod.note_external(topic, etype, key, payload, eval_id)


def faultpoint(name: str, **ctx: Any) -> Optional[FaultAction]:
    """The hook threaded through production code.  Returns ``None`` when
    disarmed or when no armed rule fires."""
    plane = _PLANE
    if plane is None:
        return None
    return plane.fire(name, ctx)


def arm(scenario_cfg, seed: Optional[int] = None) -> FaultPlane:
    """Arm a scenario.  ``scenario_cfg`` is either a list of rule dicts or
    a dict ``{"seed": int, "faults": [rules...]}``; an explicit ``seed``
    argument overrides the config's."""
    global _PLANE
    if isinstance(scenario_cfg, dict):
        rules = scenario_cfg.get("faults") or []
        cfg_seed = int(scenario_cfg.get("seed", 0))
    else:
        rules = list(scenario_cfg)
        cfg_seed = 0
    plane = FaultPlane(rules, seed=cfg_seed if seed is None else int(seed))
    _PLANE = plane
    return plane


def disarm() -> None:
    global _PLANE
    _PLANE = None


def armed() -> bool:
    return _PLANE is not None


def trace() -> List[Tuple[str, int, str]]:
    plane = _PLANE
    return plane.trace() if plane is not None else []


class scenario:
    """Context manager: ``with fault.scenario(cfg, seed=7) as plane: ...``
    — always disarms on exit, even when the chaos leaks an exception."""

    def __init__(self, scenario_cfg, seed: Optional[int] = None):
        self.cfg = scenario_cfg
        self.seed = seed
        self.plane: Optional[FaultPlane] = None

    def __enter__(self) -> FaultPlane:
        self.plane = arm(self.cfg, seed=self.seed)
        return self.plane

    def __exit__(self, *exc) -> None:
        disarm()


# ---------------------------------------------------------------------------
# the network chaos plane (fault.py:288-582)
# ---------------------------------------------------------------------------

NET_ACTIONS = ("drop", "delay", "reorder")


class NetRule:
    """One connection-level rule: ``src``/``dst`` fnmatch patterns, a
    ``kind`` (``dial``/``send``/``*``), and an action:

    - ``drop``    — the dial/call fails as an unreachable peer
    - ``delay``   — sleep ``delay`` seconds before proceeding
    - ``reorder`` — seeded bounded extra delay in ``[0, max_delay]``;
      on this strictly-sequential per-connection RPC, reordering
      manifests across *parallel* connections (a delayed call lands
      after its younger siblings), which is the observable that matters

    ``prob``/``times`` gate firing exactly like :class:`FaultRule`, with
    the same private-RNG determinism contract."""

    __slots__ = ("kind", "src", "dst", "action", "prob", "times", "delay",
                 "max_delay", "fired", "rng", "index")

    def __init__(self, spec: Dict[str, Any], index: int, seed: int):
        self.kind: str = spec.get("kind", "*")
        self.src: str = spec.get("src", "*")
        self.dst: str = spec.get("dst", "*")
        self.action: str = spec["action"]
        if self.action not in NET_ACTIONS:
            raise ValueError(f"unknown net action {self.action!r}")
        self.prob: float = float(spec.get("prob", 1.0))
        times = spec.get("times")
        self.times: Optional[int] = None if times is None else int(times)
        self.delay: float = float(spec.get("delay", 0.02))
        self.max_delay: float = float(spec.get("max_delay", 0.1))
        self.index = index
        self.rng = random.Random(f"net/{seed}/{index}")
        self.fired = 0

    def matches(self, kind: str, src: str, dst: str) -> bool:
        return ((self.kind == "*" or self.kind == kind)
                and fnmatch.fnmatchcase(src, self.src)
                and fnmatch.fnmatchcase(dst, self.dst))


class _Partition:
    """One named partition: traffic between addresses matched into
    DIFFERENT groups is severed.  Group entries are fnmatch patterns;
    an address matching no group is unaffected.  Optional ``windows``
    (offsets from the plane's arm anchor, see :func:`flap_windows`)
    make the split flap on a deterministic schedule."""

    __slots__ = ("name", "groups", "windows", "blocked_count")

    def __init__(self, name: str, groups: List[List[str]],
                 windows: Optional[List[Tuple[float, float]]] = None):
        self.name = name
        self.groups = [list(g) for g in groups]
        self.windows = ([(float(a), float(b)) for a, b in windows]
                        if windows else None)
        self.blocked_count = 0

    def active(self, elapsed: float) -> bool:
        if self.windows is None:
            return True
        return any(a <= elapsed < b for a, b in self.windows)

    def separates(self, src: str, dst: str) -> bool:
        def group_of(addr: str) -> int:
            # Most-specific pattern wins, so a ["*"] catch-all group
            # composes with a named group: an address listed literally
            # belongs to ITS group, everything else to the wildcard.
            best, best_spec = -1, -1
            for i, pats in enumerate(self.groups):
                for p in pats:
                    if fnmatch.fnmatchcase(addr, p):
                        spec = sum(c not in "*?[]" for c in p)
                        if spec > best_spec:
                            best, best_spec = i, spec
            return best

        gs, gd = group_of(src), group_of(dst)
        return gs >= 0 and gd >= 0 and gs != gd


class NetPlane:
    """Process-wide network chaos state: named partitions (imperative
    split/heal + deterministic flap windows) and seeded loss/delay
    rules.  The hot disarmed path never reaches this class — see
    :func:`netpoint`."""

    def __init__(self, spec: Optional[Dict[str, Any]] = None,
                 seed: Optional[int] = None):
        spec = dict(spec or {})
        self.seed = int(spec.get("seed", 0) if seed is None else seed)
        self._l = threading.Lock()
        self._anchor = time.monotonic()
        self._partitions: Dict[str, _Partition] = {}
        self.rules = [NetRule(r, i, self.seed)
                      for i, r in enumerate(spec.get("rules") or [])]
        self._trace: List[Tuple[str, str, str]] = []
        for p in spec.get("partitions") or []:
            self.partition(p["name"], p["groups"], windows=p.get("windows"))

    # -- partitions --------------------------------------------------------

    def partition(self, name: str, groups: List[List[str]],
                  windows: Optional[List[Tuple[float, float]]] = None,
                  ) -> None:
        with self._l:
            self._partitions[name] = _Partition(name, groups, windows)
            self._trace.append(("net.partition", name,
                                "flap" if windows else "split"))
        note_event_stream("Chaos", "Partition", name,
                          {"Groups": [list(g) for g in groups],
                           "Flap": bool(windows)})

    def heal(self, name: Optional[str] = None) -> None:
        with self._l:
            names = ([name] if name is not None
                     else list(self._partitions))
            for n in names:
                if self._partitions.pop(n, None) is not None:
                    self._trace.append(("net.partition", n, "heal"))
        for n in names:
            note_event_stream("Chaos", "Heal", n, {})

    def active_partitions(self) -> List[str]:
        elapsed = time.monotonic() - self._anchor
        with self._l:
            return sorted(n for n, p in self._partitions.items()
                          if p.active(elapsed))

    def blocked(self, src: str, dst: str) -> bool:
        elapsed = time.monotonic() - self._anchor
        with self._l:
            for p in self._partitions.values():
                if p.active(elapsed) and p.separates(src, dst):
                    p.blocked_count += 1
                    return True
        return False

    # -- the hook ----------------------------------------------------------

    def check(self, kind: str, src: str, dst: str
              ) -> Optional[Tuple[str, float]]:
        """Partition verdict first (deterministic), then the first
        firing rule.  Returns ``(action, delay_seconds)`` or None."""
        if self.blocked(src, dst):
            return ("drop", 0.0)
        for rule in self.rules:
            if not rule.matches(kind, src, dst):
                continue
            with self._l:
                if rule.times is not None and rule.fired >= rule.times:
                    continue
                if rule.prob < 1.0 and rule.rng.random() >= rule.prob:
                    continue
                rule.fired += 1
                delay = (rule.rng.random() * rule.max_delay
                         if rule.action == "reorder" else rule.delay)
                self._trace.append((f"net.{kind}", f"rule-{rule.index}",
                                    rule.action))
            return (rule.action, delay)
        return None

    def add_rules(self, specs: List[Dict[str, Any]]) -> None:
        """Append loss/delay rules to an armed plane (region-federation
        DCN shaping composes with partitions armed earlier).  Indexes
        continue from the existing rules so every rule keeps a private,
        seed-deterministic RNG stream."""
        with self._l:
            base = len(self.rules)
            self.rules.extend(NetRule(r, base + i, self.seed)
                              for i, r in enumerate(specs))

    def trace(self) -> List[Tuple[str, str, str]]:
        with self._l:
            return list(self._trace)


_NET: Optional[NetPlane] = None


def net_arm(spec: Optional[Dict[str, Any]] = None,
            seed: Optional[int] = None) -> NetPlane:
    global _NET
    _NET = NetPlane(spec, seed=seed)
    return _NET


def net_disarm() -> None:
    global _NET
    _NET = None


def net_armed() -> bool:
    return _NET is not None


def net() -> NetPlane:
    """The process net plane, arming an empty one on first use (the
    imperative partition/heal path needs no scenario)."""
    global _NET
    if _NET is None:
        _NET = NetPlane()
    return _NET


def netpoint(kind: str, src: str, dst: str
             ) -> Optional[Tuple[str, float]]:
    """The hook threaded through ConnPool dial/send.  Disarmed cost:
    one module-global load + a ``None`` check."""
    plane = _NET
    if plane is None:
        return None
    return plane.check(kind, src, dst)


def net_partition(name: str, groups: List[List[str]],
                  windows: Optional[List[Tuple[float, float]]] = None,
                  ) -> NetPlane:
    plane = net()
    plane.partition(name, groups, windows=windows)
    return plane


def net_heal(name: Optional[str] = None) -> None:
    plane = _NET
    if plane is not None:
        plane.heal(name)


def net_sever_regions(region_addrs: Dict[str, List[str]],
                      isolate: Optional[str] = None,
                      name: str = "region-sever",
                      windows: Optional[List[Tuple[float, float]]] = None,
                      ) -> NetPlane:
    """Region-severing partition groups between regions.

    ``region_addrs`` maps region name → that region's server addresses.
    Default: one partition group per region, severing ALL inter-region
    traffic while leaving intra-region (ICI) traffic — and identity-less
    client pools, which match no literal group — untouched.  With
    ``isolate=<region>``, that one region is blacked out from everything
    else (its addresses in one group, ``"*"`` in the other), modeling a
    full region blackout including its clients.  Pass ``windows`` (e.g.
    :func:`flap_windows`) for a deterministic DCN flap schedule; heal
    with ``net_heal(name)``."""
    if isolate is not None:
        if isolate not in region_addrs:
            raise ValueError(f"unknown region {isolate!r}")
        groups = [list(region_addrs[isolate]), ["*"]]
    else:
        groups = [list(addrs) for _, addrs in sorted(region_addrs.items())]
    return net_partition(name, groups, windows=windows)


def net_dcn_delay(region_addrs: Dict[str, List[str]], delay: float = 0.02,
                  prob: float = 1.0, kind: str = "send") -> NetPlane:
    """Deterministic DCN latency: one ``delay`` rule per cross-region
    (src, dst) server pair, leaving intra-region traffic at ICI speed.
    Composes with :func:`net_sever_regions` on the same plane."""
    specs: List[Dict[str, Any]] = []
    regions = sorted(region_addrs.items())
    for r_src, srcs in regions:
        for r_dst, dsts in regions:
            if r_src == r_dst:
                continue
            specs.extend({"kind": kind, "src": s, "dst": d,
                          "action": "delay", "prob": prob, "delay": delay}
                         for s in srcs for d in dsts)
    plane = net()
    plane.add_rules(specs)
    return plane


def flap_windows(seed: int, count: int = 4, period: float = 2.0,
                 duty: float = 0.5, jitter: float = 0.5,
                 start: float = 0.0) -> List[Tuple[float, float]]:
    """A deterministic split/heal schedule: ``count`` blocked windows,
    each roughly ``duty``·``period`` long, spaced ~``period`` apart with
    seeded jitter.  Same seed → same windows; anchored at the plane's
    arm time, so two processes arming the same spec at the same moment
    flap together."""
    rng = random.Random(f"flap/{seed}")
    out: List[Tuple[float, float]] = []
    t = start
    for _ in range(count):
        gap = period * (1.0 - duty) * (1.0 + jitter * (rng.random() - 0.5))
        dur = period * duty * (1.0 + jitter * (rng.random() - 0.5))
        t += gap
        out.append((round(t, 4), round(t + dur, 4)))
        t += dur
    return out
