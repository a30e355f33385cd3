"""Continuous host-attribution profiler (a copy of
``nomad_tpu/utils/contprof.py``).

The control plane's time goes on the host: the card sits idle most of a
server batch while the applier and the reconciler run Python.  This
module says where host time goes under load: a background sampler at a
low rate walks ``sys._current_frames()`` and files every thread's stack
under a fixed subsystem taxonomy by the port's module paths, keeping
rolling per-subsystem shares (``nomad.cpu.<subsystem>``).  Consumers:

- the server's metrics tick exports the shares and the GIL delay
  through its telemetry sink (``Status.Metrics`` carries them);
- :func:`window` serves a bounded recent window (the flight recorder's
  ``Profile`` section);
- the load harness snapshots a per-run ``host_attribution`` section
  (:func:`host_attribution`): at least 80 % of the non-idle samples
  attributed outside ``other`` is the contract.

A frame that waits on the card (a CUDA synchronize under ``.item()`` or
``.cpu()``, a kernel launch) has a port frame as its innermost Python
frame: the rules file ``ops/kernels.py``, ``ops/fused_score.py``,
``ops/xfer.py``, ``ops/resident.py``, the kernel build and launch of
``device.py`` (the ``csrc`` kernels) and the mesh (``parallel/``) under
``ops.dispatch``, or ``ops.fetch`` for the fetch and unpack functions
(``batch_sched._fetch``, ``_fetch_together``, ``_fetch_device``,
``xfer.unpack_*``) and the device timer's event reads.

Two riders share the arming: the GIL-pressure probe (a sentinel thread
asks for a short sleep and measures the delay beyond it) and the
contention ledger of ``utils/lockcheck.py`` (``nomad.lock.<name>.
wait_seconds``).

Disarmed (the default and the only production state) the module global
``PROFILER`` is ``None`` and nothing samples; no call site is
instrumented.  Arm with :func:`enable` (``ServerConfig.contprof_hz``
does at server construction); there is no environment knob.
"""
from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import lockcheck
from .lockcheck import _REAL_LOCK as _RAW_LOCK

__all__ = [
    "SUBSYSTEMS", "classify_frames", "ContinuousProfiler", "PROFILER",
    "enable", "disable", "enabled", "window",
    "shares", "host_attribution", "merge_metrics", "reset",
]

# ---------------------------------------------------------------------------
# taxonomy
# ---------------------------------------------------------------------------

#: The fixed subsystem taxonomy.  Every sampled stack maps to exactly
#: one of these; ``other`` is the attribution failure bucket the
#: coverage gate (≥80% of non-idle samples NOT other) watches.
SUBSYSTEMS = (
    "codec.encode", "codec.decode", "raft.apply", "plan.evaluate",
    "plan.apply", "broker", "worker.snapshot", "ops.dispatch",
    "ops.fetch", "http", "federation", "loadgen", "idle", "other",
)

# Leaf-frame idle markers: a thread whose leaf frame is a stdlib
# blocking wrapper is waiting, not burning CPU.  (C-level waits —
# lock.acquire, socket.recv — sample as their innermost *Python*
# caller, which for the common paths below is a stdlib wrapper.)
_IDLE_FILES = ("/selectors.py", "/socketserver.py", "/socket.py",
               "/ssl.py", "/subprocess.py")
_IDLE_THREADING_FUNCS = frozenset((
    "wait", "_wait_for_tstate_lock", "join"))


def _is_idle_leaf(path: str, func: str) -> bool:
    if path.endswith("/threading.py"):
        return func in _IDLE_THREADING_FUNCS
    for frag in _IDLE_FILES:
        if path.endswith(frag):
            return True
    # The sanitizer's patched time.sleep: the sleeping caller's leaf
    # frame while lockcheck is armed.
    if path.endswith("/lockcheck.py") and func == "_checked_sleep":
        return True
    # time.sleep leaves the CALLER as the leaf frame; known poll loops
    # that pace with a bare sleep would otherwise bill their sleep as
    # CPU.  The heartbeat sweeper is the big one (wakes up to 100×/s).
    if path.endswith("/server/heartbeat.py") and func == "_sweep":
        return True
    # Our own GIL probe spends its life inside its sleep loop.
    if path.endswith("/contprof.py"):
        return True
    return False


def _frame_subsystem(path: str, func: str) -> Optional[str]:
    """Map ONE port frame to a subsystem, or None when the frame is
    transparent (helper layers: state/structs/utils, the server's own
    module) or foreign.  ``path`` is '/'-normalized, ``func`` the code
    object name."""
    if "nomad_tpu_torch/" not in path:
        return None
    fl = func.lower()
    if "/codec/" in path:
        if "unpack" in fl or "decode" in fl or "sniff" in fl \
                or "from_wire" in fl:
            return "codec.decode"
        return "codec.encode"
    if path.endswith("/ops/decode.py"):
        return "codec.decode"
    if path.endswith("/ops/encode.py"):
        return "ops.dispatch"
    if path.endswith("/ops/batch_sched.py"):
        if "fetch" in fl or func == "seconds":
            # _fetch, _fetch_together, _fetch_device, and the device
            # timer's event read (_DeviceTimer.seconds), which waits on
            # the card.
            return "ops.fetch"
        if "dispatch" in fl or func == "_upload_static":
            return "ops.dispatch"
        return "plan.evaluate"
    if path.endswith(("/ops/kernels.py", "/ops/xfer.py",
                      "/ops/resident.py", "/ops/fused_score.py",
                      "/ops/preempt.py", "/nomad_tpu_torch/device.py")) \
            or "/csrc/" in path or "/parallel/" in path:
        return "ops.fetch" if "fetch" in fl or "unpack" in fl \
            else "ops.dispatch"
    if "/ops/" in path:
        return "plan.evaluate"
    if path.endswith(("/server/raft.py", "/server/fsm.py",
                      "/server/log_codec.py")):
        return "raft.apply"
    if path.endswith("/server/plan_apply.py"):
        return "plan.evaluate" if "evaluate" in fl else "plan.apply"
    if path.endswith(("/server/plan_queue.py",
                      "/server/follower_sched.py")):
        return "plan.apply"
    if path.endswith(("/server/eval_broker.py",
                      "/server/blocked_evals.py",
                      "/server/event_broker.py",
                      "/server/heartbeat.py")) or "/tenancy/" in path:
        return "broker"
    if path.endswith("/server/worker.py"):
        return "worker.snapshot" if "snapshot" in fl \
            else "plan.evaluate"
    if "/scheduler/" in path:
        return "plan.evaluate"
    if "federation" in path and ("/server/" in path
                                 or "/loadgen/" in path):
        return "federation"
    if path.endswith(("/server/rpc.py", "/server/endpoints.py")) \
            or "/agent/" in path or "/api/" in path:
        return "http"
    if "/loadgen/" in path:
        return "loadgen"
    return None


def classify_frames(frames: Sequence[Tuple[str, str]]) -> str:
    """Classify one thread's stack — ``frames`` is leaf-first
    ``(filename, funcname)`` pairs — into a subsystem.  The leaf is
    checked for stdlib idle markers first; otherwise the leaf-most
    frame with a subsystem mapping wins (that is where CPU burns);
    stacks mapping nowhere are ``other``."""
    if not frames:
        return "other"
    path0 = frames[0][0].replace("\\", "/")
    if _is_idle_leaf(path0, frames[0][1]):
        return "idle"
    for fname, func in frames:
        sub = _frame_subsystem(fname.replace("\\", "/"), func)
        if sub is not None:
            return sub
    return "other"


def _pct(ordered: List[float], q: float) -> float:
    if not ordered:
        return 0.0
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------

WINDOW_S = 5.0
MAX_STACK_DEPTH = 48
GIL_RING = 65536
# The reference's NOMAD_TPU_CONTPROF_HZ, _RING and _GIL_MS defaults.
DEFAULT_HZ = 10.0
DEFAULT_RING = 120
DEFAULT_GIL_MS = 5.0


class ContinuousProfiler:
    """Background low-Hz stack sampler + GIL-pressure probe over a
    bounded ring of aggregation windows."""

    def __init__(self, hz: float = DEFAULT_HZ,
                 window_s: float = WINDOW_S,
                 retain: int = DEFAULT_RING,
                 gil_ms: float = DEFAULT_GIL_MS):
        self.hz = max(1.0, min(float(hz or DEFAULT_HZ), 100.0))
        self.window_s = max(1.0, float(window_s))
        self.gil_ms = max(0.0, float(gil_ms or 0.0))
        # A RAW lock: the profiler must not feed its own bookkeeping
        # into the lock-order graph or the contention ledger.
        self._l = _RAW_LOCK()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._own_idents: set = set()
        # Ring of closed windows: (wall_start, duration_s, counts).
        self._windows: deque = deque(
            maxlen=max(2, int(retain or DEFAULT_RING)))
        self._cur: Dict[str, int] = {}
        self._cur_start = time.time()
        self._cur_mono = time.perf_counter()
        # Process-lifetime (since last reset) cumulative counts — the
        # loadgen per-leg attribution basis.
        self._cum: Dict[str, int] = {}
        self._cum_total = 0
        # GIL probe: scheduling-delay samples in ms, bounded.
        self._gil: deque = deque(maxlen=GIL_RING)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        t = threading.Thread(target=self._sample_loop,
                             name="contprof-sampler", daemon=True)
        self._threads.append(t)
        if self.gil_ms > 0:
            g = threading.Thread(target=self._gil_loop,
                                 name="contprof-gil", daemon=True)
            self._threads.append(g)
        for th in self._threads:
            th.start()

    def stop(self) -> None:
        self._stop.set()
        for th in self._threads:
            th.join(timeout=2.0)

    # -- sampling ----------------------------------------------------------

    def _sample_once(self) -> None:
        frames = sys._current_frames()
        ticked: List[str] = []
        for tid, frame in frames.items():
            if tid in self._own_idents:
                continue
            stack: List[Tuple[str, str]] = []
            f = frame
            depth = 0
            while f is not None and depth < MAX_STACK_DEPTH:
                code = f.f_code
                stack.append((code.co_filename, code.co_name))
                f = f.f_back
                depth += 1
            ticked.append(classify_frames(stack))
        now_wall = time.time()
        now_mono = time.perf_counter()
        with self._l:
            for sub in ticked:
                self._cur[sub] = self._cur.get(sub, 0) + 1
                self._cum[sub] = self._cum.get(sub, 0) + 1
            self._cum_total += len(ticked)
            if now_mono - self._cur_mono >= self.window_s:
                self._windows.append(
                    (self._cur_start, now_mono - self._cur_mono,
                     self._cur))
                self._cur = {}
                self._cur_start = now_wall
                self._cur_mono = now_mono

    def _sample_loop(self) -> None:
        self._own_idents.add(threading.get_ident())
        interval = 1.0 / self.hz
        while not self._stop.wait(interval):
            try:
                self._sample_once()
            except Exception:  # pragma: no cover — never kill sampling
                pass

    def _gil_loop(self) -> None:
        self._own_idents.add(threading.get_ident())
        req_s = self.gil_ms / 1000.0
        while not self._stop.is_set():
            t0 = time.perf_counter()
            time.sleep(req_s)
            delay_ms = (time.perf_counter() - t0 - req_s) * 1000.0
            # deque.append is atomic under the GIL; no lock on the
            # probe's hot path.
            self._gil.append(max(0.0, delay_ms))

    # -- read side ---------------------------------------------------------

    def gil_pressure_ms(self, tail: Optional[int] = None) -> Dict:
        vals = list(self._gil)
        if tail is not None:
            vals = vals[-tail:] if tail > 0 else []
        ordered = sorted(vals)
        return {
            "count": len(ordered),
            "p50": round(_pct(ordered, 0.50), 4),
            "p95": round(_pct(ordered, 0.95), 4),
            "p99": round(_pct(ordered, 0.99), 4),
            "max": round(ordered[-1], 4) if ordered else 0.0,
        }

    def _recent_counts(self, seconds: float) -> Tuple[Dict[str, int],
                                                      float]:
        """Aggregate counts over the windows covering the last
        ``seconds``, plus the open window."""
        now_mono = time.perf_counter()
        with self._l:
            counts = dict(self._cur)
            covered = now_mono - self._cur_mono
            for _start, dur, wcounts in reversed(self._windows):
                if covered >= seconds:
                    break
                for k, v in wcounts.items():
                    counts[k] = counts.get(k, 0) + v
                covered += dur
        return counts, covered

    @staticmethod
    def _shares(counts: Dict[str, int]) -> Dict[str, float]:
        total = sum(counts.values())
        if not total:
            return {}
        return {k: round(v / total, 4)
                for k, v in sorted(counts.items(), key=lambda kv: -kv[1])}

    @staticmethod
    def _coverage(counts: Dict[str, int]) -> float:
        """Fraction of non-idle samples attributed to a real subsystem
        (1 - other/non_idle); 1.0 when nothing non-idle was sampled."""
        total = sum(counts.values())
        non_idle = total - counts.get("idle", 0)
        if non_idle <= 0:
            return 1.0
        return round(1.0 - counts.get("other", 0) / non_idle, 4)

    def shares(self, seconds: float = 30.0) -> Dict[str, float]:
        counts, _ = self._recent_counts(seconds)
        return self._shares(counts)

    def window(self, seconds: float = 60.0) -> Dict[str, Any]:
        """The /v1/profile/continuous payload: counts/shares/coverage
        over the recent window plus the GIL and lock riders."""
        seconds = max(1.0, min(float(seconds), 3600.0))
        counts, covered = self._recent_counts(seconds)
        return {
            "Enabled": True,
            "Hz": self.hz,
            "WindowS": self.window_s,
            "RequestedS": seconds,
            "CoveredS": round(min(covered, seconds), 2),
            "ThreadSamples": sum(counts.values()),
            "Counts": dict(counts),
            "Shares": self._shares(counts),
            "NonIdleCoverage": self._coverage(counts),
            "GilDelayMs": self.gil_pressure_ms(),
            "Locks": lockcheck.wait_stats(top=10),
        }

    def host_attribution(self, top_locks: int = 5,
                         top_subsystems: int = 5) -> Dict[str, Any]:
        """The loadgen report section: attribution since the last
        :meth:`reset` (the harness resets at leg start)."""
        with self._l:
            counts = dict(self._cum)
            for k, v in self._cur.items():
                counts[k] = counts.get(k, 0) + v
        shares_ = self._shares(counts)
        top = [[k, v] for k, v in shares_.items()
               if k not in ("idle",)][:top_subsystems]
        return {
            "enabled": True,
            "hz": self.hz,
            "thread_samples": sum(counts.values()),
            "shares": shares_,
            "non_idle_coverage": self._coverage(counts),
            "top_subsystems": top,
            "top_locks": lockcheck.wait_stats(top=top_locks),
            "gil_pressure_ms": self.gil_pressure_ms(),
        }

    def reset(self) -> None:
        """Zero the cumulative attribution + GIL samples (per-leg
        snapshots).  The open window restarts too — its counts feed
        host_attribution() — but the closed-window ring is left alone;
        it is the operator surface, not the leg accounting."""
        with self._l:
            self._cum = {}
            self._cum_total = 0
            self._cur = {}
            self._cur_start = time.time()
            self._cur_mono = time.perf_counter()
        self._gil.clear()


# ---------------------------------------------------------------------------
# process-wide arming (fault.py discipline: None ⇒ disarmed)
# ---------------------------------------------------------------------------

PROFILER: Optional[ContinuousProfiler] = None


def enable(hz: float = DEFAULT_HZ,
           gil_ms: float = DEFAULT_GIL_MS) -> ContinuousProfiler:
    global PROFILER
    if PROFILER is not None:
        return PROFILER
    p = ContinuousProfiler(hz=hz, gil_ms=gil_ms)
    p.start()
    PROFILER = p
    return p


def disable() -> None:
    global PROFILER
    p, PROFILER = PROFILER, None
    if p is not None:
        p.stop()


def enabled() -> bool:
    return PROFILER is not None


def window(seconds: float = 60.0) -> Dict[str, Any]:
    p = PROFILER
    if p is None:
        return {"Enabled": False}
    return p.window(seconds)


def shares(seconds: float = 30.0) -> Dict[str, float]:
    p = PROFILER
    return p.shares(seconds) if p is not None else {}


def host_attribution(top_locks: int = 5) -> Optional[Dict[str, Any]]:
    p = PROFILER
    return p.host_attribution(top_locks=top_locks) \
        if p is not None else None


def reset() -> None:
    p = PROFILER
    if p is not None:
        p.reset()


# ---------------------------------------------------------------------------
# metrics bridge (the codec.merge_metrics pattern)
# ---------------------------------------------------------------------------

MERGE_TOP_LOCKS = 8


def merge_metrics(latest: Dict) -> Dict:
    """Merge the profiler gauges and the contention-ledger histograms
    into a server sink's ``latest()`` summary — the bridge that puts
    ``nomad.cpu.<subsystem>`` and ``nomad.lock.<name>.wait_seconds`` on
    ``Status.Metrics``.  Each rider
    merges independently: lock waits appear whenever the sanitizer is
    armed, CPU shares whenever the profiler is."""
    p = PROFILER
    if p is not None:
        gauges = latest.setdefault("Gauges", {})
        for sub, share in p.shares(30.0).items():
            gauges[f"nomad.cpu.{sub}"] = share
        gil = p.gil_pressure_ms()
        gauges["nomad.runtime.gil_delay_p50_ms"] = gil["p50"]
        gauges["nomad.runtime.gil_delay_p99_ms"] = gil["p99"]
    waits = lockcheck.wait_stats(top=MERGE_TOP_LOCKS)
    if waits:
        samples = latest.setdefault("Samples", {})
        totals = latest.setdefault("SampleTotals", {})
        for w in waits:
            key = f"nomad.lock.{w['name']}.wait_seconds"
            count = w["count"]
            total_s = w["wait_s_sum"]
            samples[key] = {
                "count": count,
                "sum": total_s,
                "min": 0.0,
                "max": w["wait_s_max"],
                "mean": round(total_s / count, 9) if count else 0.0,
                "p50": round(w["p50_ms"] / 1000.0, 9),
                "p95": round(w["p95_ms"] / 1000.0, 9),
                "p99": round(w["p99_ms"] / 1000.0, 9),
            }
            totals[key] = (count, total_s)
    return latest
