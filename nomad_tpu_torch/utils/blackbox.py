"""Incident flight recorder (a copy of ``nomad_tpu/utils/blackbox.py``).

When an incident fires — the kernel circuit breaker opens or re-opens,
the safety auditor records a violation, the lock-order sanitizer finds a
cycle, or the plan-apply p99 breaches its SLO — the forensic window is
*now*: the span ring, the event tail and the profiler window all age out
within minutes.  The flight recorder freezes that window to disk as one
JSON bundle:

- the recent span timeline (``tracing.recent``) and the event tail
  (``event_broker.recent``);
- every registered server's stats, broker stats and metrics, and its
  ``ServerConfig`` (``Config``; the reference's ``Knobs``);
- the continuous-profile window and the contention ledger
  (``contprof.window``), and an all-thread stack dump
  (``profiling.thread_dump``);
- the breakers (``Breaker``): the process-wide ``ops.breaker.BREAKER``,
  each registered server's own (``Server.breaker()``) and, for a breaker
  trigger, the breaker that fired it (``Trigger``), which may be a
  private one no server holds.

Auto-captures are **bounded and deduplicated**: a per-reason minimum
interval, a global floor of ``GLOBAL_FLOOR_S`` and a lifetime cap keep a
crash-looping trigger from filling the disk.  Operator captures
(``capture(force=True)``) bypass the limits, and :func:`assemble_bundle`
works disarmed.  A capture that fails is logged and counted
(``FlightRecorder.failures``), never raised into the trigger's caller.

Capture runs on a daemon thread: triggers fire inside the breaker's and
the auditor's critical sections, and assembling a bundle takes broker
and sink locks, so running it inline would deadlock or add lock-order
edges.  The synchronous part of :func:`note_trigger` is the admission
check under a raw (untracked) lock.  Each bundle written is published on
the event stream as ``Blackbox``/``BundleCaptured``.

Disarmed (the default) the module global ``_STATE`` is ``None`` and every
trigger site costs one global load and a branch.  Arm with
:func:`enable` (``ServerConfig.blackbox_dir`` does at server
construction); there is no environment knob.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from . import lockcheck, tracing
from .lockcheck import _REAL_LOCK as _RAW_LOCK

__all__ = [
    "FlightRecorder", "enable", "disable", "enabled", "note_trigger",
    "capture", "assemble_bundle", "register_server", "unregister_server",
    "bundles",
]

logger = logging.getLogger("nomad_tpu_torch.blackbox")

GLOBAL_FLOOR_S = 1.0      # min seconds between ANY two auto-captures
SPAN_TAIL = 400           # spans bundled from the tracing ring
EVENT_TAIL = 200          # events bundled from the process event tail
PROFILE_WINDOW_S = 60.0   # continuous-profile window per bundle
# The reference's NOMAD_TPU_BLACKBOX_MIN_INTERVAL_S and _MAX_BUNDLES
# defaults.
DEFAULT_MIN_INTERVAL_S = 30.0
DEFAULT_MAX_BUNDLES = 32

# Servers registered for state capture (server __init__/shutdown).
_SERVERS: List[Any] = []
_SERVERS_L = _RAW_LOCK()


def register_server(server: Any) -> None:
    with _SERVERS_L:
        if server not in _SERVERS:
            _SERVERS.append(server)


def unregister_server(server: Any) -> None:
    with _SERVERS_L:
        try:
            _SERVERS.remove(server)
        except ValueError:
            pass


def _jsonable(obj: Any) -> Any:
    """Best-effort conversion to JSON-serializable data; the recorder
    must never lose a bundle to one odd payload value."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [_jsonable(v) for v in obj]
    return repr(obj)


def _config_dict(config: Any) -> Dict[str, Any]:
    """A server's ``ServerConfig``, field by field, JSON-safe (a mesh, a
    breaker or a TLS config becomes its repr)."""
    if not dataclasses.is_dataclass(config):
        return {}
    return {f.name: _jsonable(getattr(config, f.name, None))
            for f in dataclasses.fields(config)}


def _event_dicts(events: List[Any]) -> List[Dict[str, Any]]:
    out = []
    for ev in events:
        out.append({
            "Topic": getattr(ev, "topic", ""),
            "Type": getattr(ev, "type", ""),
            "Key": getattr(ev, "key", ""),
            "Index": getattr(ev, "index", 0),
            "Payload": _jsonable(getattr(ev, "payload", {})),
            "EvalID": getattr(ev, "eval_id", ""),
            "SpanID": getattr(ev, "span_id", 0),
        })
    return out


def _breaker_row(brk: Any) -> Dict[str, Any]:
    return {"State": brk.state, "Trips": brk.trips}


def assemble_bundle(reason: str, detail: Optional[Dict] = None,
                    breaker: Any = None) -> Dict[str, Any]:
    """Build the in-memory bundle.  Works disarmed; the armed recorder
    adds the rate limiting and the write to disk around it.  ``breaker``
    is the breaker that fired a breaker trigger (its ``Trigger`` row)."""
    with _SERVERS_L:
        servers = list(_SERVERS)
    bundle: Dict[str, Any] = {
        "Reason": reason,
        "Detail": _jsonable(detail or {}),
        "Wall": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "UnixTime": round(time.time(), 3),
        "Pid": os.getpid(),
        "Config": {getattr(getattr(srv, "config", None), "node_name",
                           "?"): _config_dict(getattr(srv, "config", None))
                   for srv in servers},
    }
    bundle["Spans"] = tracing.recent(SPAN_TAIL)
    # The server and ops packages are read through sys.modules: the
    # utils layer must not import them (a cycle), and a process that
    # never loaded them has nothing of theirs to capture.
    ebm = sys.modules.get("nomad_tpu_torch.server.event_broker")
    bundle["Events"] = _event_dicts(ebm.recent(EVENT_TAIL)) \
        if ebm is not None else []
    from . import contprof, profiling
    bundle["Profile"] = contprof.window(PROFILE_WINDOW_S)
    bundle["Locks"] = {
        "Waits": lockcheck.wait_stats(top=10),
        "Edges": len(lockcheck.edges()),
        "BlockingCalls": len(lockcheck.blocking_calls()),
    }
    bundle["Threads"] = profiling.thread_dump()
    brk = sys.modules.get("nomad_tpu_torch.ops.breaker")
    section: Dict[str, Any] = {}
    if brk is not None:
        section.update(_breaker_row(brk.BREAKER))
    section["Servers"] = []
    for srv in servers:
        try:
            row = _breaker_row(srv.breaker())
        except Exception:  # a server without one, or shutting down
            continue
        row["Name"] = getattr(getattr(srv, "config", None), "node_name",
                              "?")
        section["Servers"].append(row)
    if breaker is not None:
        section["Trigger"] = _breaker_row(breaker)
    bundle["Breaker"] = section
    out_servers = []
    for srv in servers:
        try:
            out_servers.append({
                "Name": getattr(getattr(srv, "config", None),
                                "node_name", "?"),
                "Stats": _jsonable(srv.stats()),
                "BrokerStats": _jsonable(srv.broker_stats()),
                "Metrics": _jsonable(srv.metrics.sink.latest()),
            })
        except Exception:  # a shutting-down server must not kill capture
            continue
    bundle["Servers"] = out_servers
    return bundle


class FlightRecorder:
    """Rate-limited incident capture to a bundle directory.  ``clock`` is
    the limiter's clock (seconds; ``time.perf_counter`` by default)."""

    def __init__(self, directory: str,
                 min_interval_s: float = DEFAULT_MIN_INTERVAL_S,
                 max_bundles: int = DEFAULT_MAX_BUNDLES,
                 clock: Callable[[], float] = time.perf_counter):
        if not directory:
            raise ValueError("the flight recorder needs a bundle directory")
        self.directory = directory
        self.min_interval_s = max(0.0, float(min_interval_s or 0.0))
        self.max_bundles = max(1, int(max_bundles or DEFAULT_MAX_BUNDLES))
        self.clock = clock
        self._l = _RAW_LOCK()  # admission only — never held in capture
        self._last_by_reason: Dict[str, float] = {}
        self._last_any = 0.0
        self._auto_count = 0
        self._seq = 0
        self.captured: List[str] = []  # bundle paths, oldest first
        self.suppressed = 0  # auto triggers the limiter refused
        self.failures = 0    # captures that raised (logged)

    def _admit(self, reason: str) -> bool:
        """Auto-capture admission: per-reason min interval, global
        floor, lifetime cap.  Cheap and synchronous — this is the only
        part that runs on the trigger's thread."""
        now = self.clock()
        with self._l:
            last = self._last_by_reason.get(reason)
            if (self._auto_count >= self.max_bundles
                    or (last is not None
                        and now - last < self.min_interval_s)
                    or (self._last_any
                        and now - self._last_any < GLOBAL_FLOOR_S)):
                self.suppressed += 1
                return False
            self._last_by_reason[reason] = now
            self._last_any = now
            self._auto_count += 1
            return True

    def _bundle_path(self, reason: str) -> str:
        with self._l:
            self._seq += 1
            seq = self._seq
        safe = "".join(c if c.isalnum() or c in "._-" else "_"
                       for c in reason)
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        return os.path.join(self.directory,
                            f"blackbox_{stamp}_{seq:03d}_{safe}.json")

    def capture(self, reason: str, detail: Optional[Dict] = None,
                force: bool = False, breaker: Any = None) -> Optional[str]:
        """Assemble and write one bundle; returns its path, or None when
        the limiter refused it or the capture failed.  ``force``
        (operator-initiated) bypasses rate limiting and the cap."""
        if not force and not self._admit(reason):
            return None
        try:
            bundle = assemble_bundle(reason, detail, breaker=breaker)
            os.makedirs(self.directory, exist_ok=True)
            path = self._bundle_path(reason)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(bundle, fh, indent=1, default=repr)
            os.replace(tmp, path)
        except Exception:
            with self._l:
                self.failures += 1
            logger.exception("flight recorder: capture of %r failed",
                             reason)
            return None
        with self._l:
            self.captured.append(path)
        ebm = sys.modules.get("nomad_tpu_torch.server.event_broker")
        if ebm is not None:
            ebm.note_external("Blackbox", "BundleCaptured", reason,
                              {"Path": path})
        return path


# ---------------------------------------------------------------------------
# process-wide arming (fault.py discipline: None ⇒ disarmed)
# ---------------------------------------------------------------------------

_STATE: Optional[FlightRecorder] = None


def enable(directory: str,
           min_interval_s: float = DEFAULT_MIN_INTERVAL_S,
           max_bundles: int = DEFAULT_MAX_BUNDLES) -> FlightRecorder:
    """Arm the process-wide recorder (idempotent: an armed recorder is
    kept as it is)."""
    global _STATE
    if _STATE is None:
        _STATE = FlightRecorder(directory, min_interval_s, max_bundles)
    return _STATE


def disable() -> None:
    global _STATE
    _STATE = None


def enabled() -> bool:
    return _STATE is not None


def recorder() -> Optional[FlightRecorder]:
    """The armed recorder, or None."""
    return _STATE


def bundles() -> List[str]:
    st = _STATE
    return list(st.captured) if st is not None else []


def note_trigger(reason: str, detail: Optional[Dict] = None,
                 breaker: Any = None) -> None:
    """Incident hook for the breaker, the auditor, the sanitizer and the
    SLO watch.  One global load and a branch while disarmed; armed, the
    admission check runs synchronously and the capture on a daemon
    thread (trigger sites hold their subsystem's locks).  ``breaker``:
    the breaker that fired the trigger, read by the capture thread."""
    st = _STATE
    if st is None:
        return
    if not st._admit(reason):
        return
    snap = _jsonable(detail or {})
    t = threading.Thread(
        target=lambda: st.capture(reason, snap, force=True,
                                  breaker=breaker),
        name="blackbox-capture", daemon=True)
    t.start()


def capture(reason: str, detail: Optional[Dict] = None,
            force: bool = True) -> Optional[str]:
    """Synchronous capture through the armed recorder; returns the
    bundle path, or None when disarmed, suppressed or failed."""
    st = _STATE
    if st is None:
        return None
    return st.capture(reason, detail, force=force)
