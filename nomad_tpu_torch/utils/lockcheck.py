"""Runtime lock-order sanitizer (a copy of
``nomad_tpu/utils/lockcheck.py``).

The shape of the bugs it catches: a lock held across a blocking call (an
fsync under the log lock) or two locks taken in opposite orders by two
threads in different modules.  Disarmed is the default and the only
production state: nothing is patched and nothing is tracked, and a
tracked lock made while armed costs one module-global load and a ``None``
check per operation afterwards.

- **Armed** (:func:`arm`; there is no environment knob)
  ``threading.Lock``/``threading.RLock`` construction from
  ``nomad_tpu_torch`` code returns a :class:`TrackedLock` named by its
  creation site.  Every acquisition records ``held -> acquired`` edges
  into a process-wide lock-order graph, and ``time.sleep``/``os.fsync``
  under a tracked lock is recorded as a held-lock blocking call.
- **Teardown** (:func:`assert_acyclic`) raises :class:`LockOrderError`
  with the witness chain (which thread took which edge at which source
  line) when the graph has a cycle, after a flight-recorder trigger
  (``lockcheck.cycle``, ``utils/blackbox.py``).

Only locks made by this package are wrapped: the constructor patch walks
the caller's frames and wraps construction reached from a file under
``nomad_tpu_torch/`` (the directory followed by a separator, so no other
package that shares the prefix, the JAX reference's included, is
caught).  The real primitives are taken from ``_thread`` and a fresh
instance of the builtin ``time`` module, never from ``threading`` or
``time`` as they stand at import: another sanitizer armed in the same
process (the reference's) patches those names, and this module must not
take its wrappers for the real thing.

Contention ledger: while armed, every tracked acquisition also measures
how long the acquire blocked into a per-name wait ledger;
:func:`wait_stats` ranks the contended locks, the continuous profiler
(``utils/contprof.py``) exports them as ``nomad.lock.<name>.wait_seconds``
and the load harness's ``host_attribution`` names the top five.
"""
from __future__ import annotations

import _imp
import _thread
import importlib.machinery
import os
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "LockOrderError", "arm", "disarm", "armed", "PKG_DIR",
    "assert_acyclic", "find_cycle", "cycle_in_edges", "edges",
    "blocking_calls", "reset", "wait_stats", "reset_waits",
    "held_tracked", "TrackedLock", "make_tracked",
]


class LockOrderError(AssertionError):
    """The lock-order graph acquired a cycle; the message carries the
    witness chain (edge, thread, acquire sites)."""


class _State:
    """Everything the armed sanitizer tracks.  One instance per arm();
    the module global being ``None`` IS the disarmed fast path."""

    def __init__(self) -> None:
        self.lock = _REAL_LOCK()
        # (src_name, dst_name) -> witness: (thread, src_site, dst_site)
        self.edges: Dict[Tuple[str, str], Tuple[str, str, str]] = {}
        # (lock_name, blocking_kind, site) records, bounded.
        self.blocking: List[Tuple[str, str, str]] = []
        self.local = threading.local()

    def held(self) -> List["TrackedLock"]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_STATE: Optional[_State] = None

# The real primitives, whatever ``threading``, ``time`` and ``os`` hold
# at import (see the module docstring).
_REAL_LOCK = _thread.allocate_lock
_REAL_RLOCK = _thread.RLock
_REAL_SLEEP = _imp.create_builtin(
    importlib.machinery.BuiltinImporter.find_spec("time")).sleep
_REAL_FSYNC = getattr(sys.modules.get("posix") or sys.modules.get("nt"),
                      "fsync", os.fsync)

#: The package's directory; a lock is wrapped only when it is made by a
#: file under ``PKG_DIR + os.sep``.
PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG_PREFIX = PKG_DIR + os.sep

MAX_BLOCKING_RECORDS = 1024

# -- contention ledger --------------------------------------------------------
# Per-name wait aggregates shared by every TrackedLock instance created
# at the same source line (two servers in one process contend the same
# code path).  The registry and each aggregate use RAW locks so the
# ledger itself never grows graph edges.

WAIT_RING = 512
MAX_WAIT_NAMES = 4096


class _WaitStats:
    """Wait-time aggregate for one lock name: count/sum/max plus a
    bounded ring of raw waits for exact small-N percentiles."""

    __slots__ = ("name", "count", "total_s", "max_s", "ring", "_l")

    def __init__(self, name: str) -> None:
        self.name = name
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self.ring: deque = deque(maxlen=WAIT_RING)
        self._l = _REAL_LOCK()

    def add(self, wait_s: float) -> None:
        with self._l:
            self.count += 1
            self.total_s += wait_s
            if wait_s > self.max_s:
                self.max_s = wait_s
            self.ring.append(wait_s)

    def clear(self) -> None:
        with self._l:
            self.count = 0
            self.total_s = 0.0
            self.max_s = 0.0
            self.ring.clear()

    def summary(self) -> Dict:
        with self._l:
            vals = sorted(self.ring)
            count, total, mx = self.count, self.total_s, self.max_s

        def pct(q: float) -> float:
            if not vals:
                return 0.0
            return vals[min(len(vals) - 1, int(q * len(vals)))]

        return {
            "name": self.name,
            "count": count,
            "wait_s_sum": round(total, 6),
            "wait_s_max": round(mx, 6),
            "p50_ms": round(pct(0.50) * 1000.0, 4),
            "p95_ms": round(pct(0.95) * 1000.0, 4),
            "p99_ms": round(pct(0.99) * 1000.0, 4),
        }


_WAITS: Dict[str, _WaitStats] = {}
_WAITS_L = _REAL_LOCK()


def _wait_stats_for(name: str) -> _WaitStats:
    with _WAITS_L:
        ws = _WAITS.get(name)
        if ws is None:
            if len(_WAITS) >= MAX_WAIT_NAMES:
                name = "<overflow>"
                ws = _WAITS.get(name)
                if ws is None:
                    ws = _WAITS[name] = _WaitStats(name)
            else:
                ws = _WAITS[name] = _WaitStats(name)
        return ws


def wait_stats(top: Optional[int] = None) -> List[Dict]:
    """Contended-lock ranking: per-name wait summaries sorted by total
    blocked seconds, the names with zero recorded waits elided."""
    with _WAITS_L:
        stats = list(_WAITS.values())
    out = [ws.summary() for ws in stats]
    out = [o for o in out if o["count"]]
    out.sort(key=lambda o: (-o["wait_s_sum"], o["name"]))
    return out[:top] if top else out


def reset_waits() -> None:
    """Zero the ledger in place (per-leg snapshots).  Aggregates are
    cleared, not dropped: live TrackedLocks hold direct references."""
    with _WAITS_L:
        stats = list(_WAITS.values())
    for ws in stats:
        ws.clear()


_SELF_FILE = os.path.abspath(__file__).rstrip("co")  # .py for .pyc


def _caller_site(depth: int = 2) -> str:
    """First frame outside this module (the with-statement protocol
    routes __enter__ → acquire, which would otherwise be the site)."""
    d = depth
    while True:
        try:
            frame = sys._getframe(d)
        except ValueError:
            frame = sys._getframe(d - 1)
            break
        if not frame.f_code.co_filename.startswith(_SELF_FILE):
            break
        d += 1
    return f"{frame.f_code.co_filename}:{frame.f_lineno}"


def _from_package(depth: int = 2, limit: int = 4) -> Optional[str]:
    """Walk up to ``limit`` frames looking for a source file of this
    package; returns its site string (the lock's name) or None.  The
    walk covers one level of stdlib indirection (``threading.Condition()``
    creating its RLock) without adopting library-internal locks."""
    for d in range(depth, depth + limit):
        try:
            frame = sys._getframe(d)
        except ValueError:
            return None
        fn = frame.f_code.co_filename
        if fn.startswith(_PKG_PREFIX):
            if os.sep + "utils" + os.sep + "lockcheck" in fn:
                continue
            return f"{os.path.relpath(fn, PKG_DIR)}:{frame.f_lineno}"
        # threading.py internals are transparent; anything else foreign
        # (site-packages, stdlib beyond threading) means a foreign lock.
        if not fn.endswith("threading.py"):
            return None
    return None


class TrackedLock:
    """Wrapper over a real Lock/RLock recording acquisition order.
    After :func:`disarm`, live wrappers keep working at one global load
    per operation (``_STATE is None`` short-circuit)."""

    __slots__ = ("_inner", "name", "_rlock", "_count", "_owner_stack",
                 "_wait")

    def __init__(self, inner, name: str, rlock: bool):
        self._inner = inner
        self.name = name
        self._rlock = rlock
        self._count = 0  # recursion depth, tracking thread only
        self._owner_stack = None  # held-stack list the entry lives on
        self._wait = None  # per-name _WaitStats, resolved lazily

    # -- tracking ----------------------------------------------------------

    def _note_acquired(self, site: str) -> None:
        st = _STATE
        if st is None:
            return
        stack = st.held()
        if self._rlock and any(t is self for t in stack):
            self._count += 1
            return
        for held in stack:
            if held is self:
                continue
            if held.name == self.name:
                # Distinct instances created at the same source line
                # (two servers in one process) share a name; an edge
                # name→name would be a guaranteed-false 1-cycle.
                continue
            key = (held.name, self.name)
            if key not in st.edges:
                with st.lock:
                    if key not in st.edges:
                        st.edges[key] = (
                            threading.current_thread().name,
                            held.name, site)
        self._count = 1
        stack.append(self)
        self._owner_stack = stack

    def _note_released(self, full: bool = False) -> None:
        st = _STATE
        if st is None:
            return
        stack = st.held()
        if (not full and self._rlock and self in stack
                and self._count > 1):
            self._count -= 1
            return
        self._count = 0
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                self._owner_stack = None
                return
        # Released by a thread that didn't acquire it (legal for plain
        # Locks used as signals): clear the entry from the acquiring
        # thread's stack so it doesn't poison that thread's edges
        # forever.  list.remove is GIL-atomic, good enough for a
        # sanitizer's bookkeeping.
        owner = self._owner_stack
        if owner is not None:
            try:
                owner.remove(self)
            except ValueError:
                pass
            self._owner_stack = None

    # -- the lock protocol -------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if _STATE is None:
            return self._inner.acquire(blocking, timeout)
        t0 = time.perf_counter()
        got = self._inner.acquire(blocking, timeout)
        if got:
            wait = time.perf_counter() - t0
            ws = self._wait
            if ws is None:
                ws = self._wait = _wait_stats_for(self.name)
            ws.add(wait)
            self._note_acquired(_caller_site())
        return got

    def release(self) -> None:
        if _STATE is not None:
            self._note_released()
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # -- Condition integration ---------------------------------------------
    # Condition snapshots these at construction; wait() releases the
    # lock through _release_save and reacquires through
    # _acquire_restore, so the held stack must follow.

    def _release_save(self):
        # Condition.wait fully releases the lock whatever its recursion
        # depth — drop the whole stack entry, not one level.  The
        # wrapper's depth rides the saved state so _acquire_restore can
        # resync it with the inner lock's restored recursion count
        # (otherwise a wait at depth >1 leaves the wrapper one level
        # shallow and the first release() silently empties the stack
        # while the inner lock is still held).
        depth = self._count
        if _STATE is not None:
            self._note_released(full=True)
        if hasattr(self._inner, "_release_save"):
            return (depth, self._inner._release_save())
        self._inner.release()
        return (depth, None)

    def _acquire_restore(self, state) -> None:
        depth, inner_state = state
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        if _STATE is not None:
            self._note_acquired(_caller_site())
            if self._rlock and depth > 1:
                self._count = depth

    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _at_fork_reinit(self) -> None:  # pragma: no cover — fork safety
        self._inner._at_fork_reinit()

    def __repr__(self) -> str:
        return f"<TrackedLock {self.name} rlock={self._rlock}>"


def make_tracked(name: str, rlock: bool = False) -> "TrackedLock":
    """Explicitly instrumented lock regardless of caller location —
    for tests and drills that exercise the sanitizer from outside the
    package.  Works disarmed too (one global load
    per op, nothing recorded)."""
    return TrackedLock(_REAL_RLOCK() if rlock else _REAL_LOCK(),
                       name, rlock=rlock)


def _make_lock():
    inner = _REAL_LOCK()
    if _STATE is None:
        return inner
    site = _from_package()
    if site is None:
        return inner
    return TrackedLock(inner, site, rlock=False)


def _make_rlock():
    inner = _REAL_RLOCK()
    if _STATE is None:
        return inner
    site = _from_package()
    if site is None:
        return inner
    return TrackedLock(inner, site, rlock=True)


def _checked_sleep(secs):
    st = _STATE
    if st is not None:
        held = st.held()
        if held and len(st.blocking) < MAX_BLOCKING_RECORDS:
            site = _caller_site()
            with st.lock:
                st.blocking.append((held[-1].name, "time.sleep", site))
    return _REAL_SLEEP(secs)


def _checked_fsync(fd):
    st = _STATE
    if st is not None:
        held = st.held()
        if held and len(st.blocking) < MAX_BLOCKING_RECORDS:
            site = _caller_site()
            with st.lock:
                st.blocking.append((held[-1].name, "os.fsync", site))
    return _REAL_FSYNC(fd)


# ---------------------------------------------------------------------------
# arming
# ---------------------------------------------------------------------------


# What arm() replaced, put back by disarm() as it was (another
# sanitizer's wrappers included, when one was armed first).
_SAVED: Optional[Tuple] = None


def arm() -> None:
    """Patch lock construction + the blocking primitives.  Idempotent."""
    global _STATE, _SAVED
    if _STATE is not None:
        return
    _SAVED = (threading.Lock, threading.RLock, time.sleep, os.fsync)
    _STATE = _State()
    threading.Lock = _make_lock
    threading.RLock = _make_rlock
    time.sleep = _checked_sleep
    os.fsync = _checked_fsync


def disarm() -> None:
    """Put back what :func:`arm` replaced.  Live TrackedLocks keep
    delegating (one global load per op) so locks created while armed
    stay valid."""
    global _STATE, _SAVED
    if _SAVED is not None:
        threading.Lock, threading.RLock, time.sleep, os.fsync = _SAVED
        _SAVED = None
    _STATE = None


def armed() -> bool:
    return _STATE is not None


def reset() -> None:
    """Clear accumulated edges/records without disarming (per-test)."""
    st = _STATE
    if st is not None:
        with st.lock:
            st.edges.clear()
            del st.blocking[:]


# ---------------------------------------------------------------------------
# inspection / teardown assertions
# ---------------------------------------------------------------------------


def edges() -> Dict[Tuple[str, str], Tuple[str, str, str]]:
    st = _STATE
    if st is None:
        return {}
    with st.lock:
        return dict(st.edges)


def blocking_calls() -> List[Tuple[str, str, str]]:
    st = _STATE
    if st is None:
        return []
    with st.lock:
        return list(st.blocking)


def held_tracked() -> List[str]:
    """Names of tracked locks held by the calling thread (tests)."""
    st = _STATE
    if st is None:
        return []
    return [t.name for t in st.held()]


def cycle_in_edges(edge_keys) -> Optional[List[Tuple[str, str]]]:
    """First cycle in a set of ``(src, dst)`` edges as the list of
    edges along it, or None.  Iterative DFS with an explicit stack (no
    recursion limit on long chains); neighbors visited in sorted order
    for a deterministic witness.  Shared by the runtime sanitizer and
    the reference's static lock-order rule (``analysis/lockrules``, not
    ported yet)."""
    graph: Dict[str, List[str]] = {}
    for (a, b) in edge_keys:
        graph.setdefault(a, []).append(b)
    for adj in graph.values():
        adj.sort()
    visited: Set[str] = set()
    for root in sorted(graph):
        if root in visited:
            continue
        visited.add(root)
        stack = [(root, iter(graph.get(root, ())))]
        on_path: List[str] = [root]
        on_path_set: Set[str] = {root}
        while stack:
            _node, it = stack[-1]
            descended = False
            for nxt in it:
                if nxt in on_path_set:
                    start = on_path.index(nxt)
                    chain = on_path[start:] + [nxt]
                    return list(zip(chain, chain[1:]))
                if nxt not in visited:
                    visited.add(nxt)
                    stack.append((nxt, iter(graph.get(nxt, ()))))
                    on_path.append(nxt)
                    on_path_set.add(nxt)
                    descended = True
                    break
            if not descended:
                stack.pop()
                on_path_set.discard(on_path.pop())
    return None


def find_cycle() -> Optional[List[Tuple[str, str]]]:
    """First cycle in the accumulated lock-order graph, or None."""
    return cycle_in_edges(edges())


def witness(cycle: List[Tuple[str, str]]) -> str:
    """Human-readable witness chain for a cycle from find_cycle()."""
    all_edges = edges()
    lines = ["lock-order cycle:"]
    for (a, b) in cycle:
        thread, _src, dst_site = all_edges.get(
            (a, b), ("?", a, "?"))
        lines.append(f"  {a} -> {b}  (thread {thread}, "
                     f"acquired at {dst_site})")
    return "\n".join(lines)


def assert_acyclic() -> None:
    """Raise LockOrderError (with the witness chain) if the graph has a
    cycle, after a ``lockcheck.cycle`` flight-recorder trigger."""
    cycle = find_cycle()
    if cycle is not None:
        msg = witness(cycle)
        print(msg, file=sys.stderr)
        # A runtime lock-order cycle is a flight-recorder incident:
        # capture the forensic bundle before the assertion unwinds the
        # process state.  Late import — blackbox reads this module's
        # ledger back.
        from . import blackbox
        blackbox.note_trigger("lockcheck.cycle", {"witness": msg})
        raise LockOrderError(msg)
