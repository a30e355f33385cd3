"""Runtime profiling: the pprof-equivalent debug surface plus device
tracing (a copy of ``nomad_tpu/utils/profiling.py``, its ``jax.profiler``
sessions become ``torch.profiler`` sessions).

The reference mounts net/http/pprof under /debug/pprof when enableDebug
is set (command/agent/http.go:173-178): CPU profiles, heap profiles and
goroutine stacks.  The equivalents here:

- profile:   sampling profiler over a bounded window -- stacks of every
             live thread sampled at ~200Hz and aggregated (pprof's CPU
             profile is also a sampler; a cProfile hook would only see
             the handler's own thread).
- heap:      tracemalloc top allocation sites (started lazily on first
             request; subsequent requests diff against a live tracer).
- threads:   stack dump of every live thread (goroutine-dump analogue).
- trace:     a ``torch.profiler`` session over the host and the card (CPU
             and CUDA activity), written as a chrome trace
             (``trace.json``) into a directory per session.

All captures are bounded and lock-free with respect to the runtime: the
CPU profiler samples the interpreter's frames for its window; heap and
threads are point-in-time snapshots.
"""
from __future__ import annotations

import io
import os
import sys
import tempfile
import threading
import time
import traceback
from typing import Dict, Optional

import torch

from ..device import resolve_device
from .platform import is_cuda_platform

_profile_lock = threading.Lock()


def cpu_profile(seconds: float = 1.0, sort: str = "cumulative",
                top: int = 60, hz: float = 200.0) -> str:
    """Sample every live thread's stack for ``seconds`` and render an
    aggregated report: per-frame inclusive/leaf sample counts across ALL
    threads (cProfile's hook is per-thread — it would only ever see this
    handler sleeping).  Serialized by a module lock so concurrent profile
    requests don't double the sampling load."""
    seconds = max(0.05, min(float(seconds), 30.0))
    interval = 1.0 / max(1.0, min(hz, 1000.0))
    if not _profile_lock.acquire(timeout=0.1):
        raise RuntimeError("another cpu profile is in progress")
    try:
        me = threading.get_ident()
        inclusive: dict = {}
        leaf: dict = {}
        samples = 0
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue
                depth = 0
                f = frame
                first = True
                while f is not None and depth < 64:
                    code = f.f_code
                    # co_qualname is 3.11+; co_name on older runtimes
                    key = (code.co_filename, code.co_firstlineno,
                           getattr(code, "co_qualname", code.co_name))
                    inclusive[key] = inclusive.get(key, 0) + 1
                    if first:
                        leaf[key] = leaf.get(key, 0) + 1
                        first = False
                    f = f.f_back
                    depth += 1
            samples += 1
            time.sleep(interval)
        out = io.StringIO()
        out.write(f"{samples} samples over {seconds:.2f}s "
                  f"({len(inclusive)} function calls observed)\n\n")
        out.write(f"{'incl':>8} {'leaf':>8}  function\n")
        ranked = sorted(inclusive.items(),
                        key=lambda kv: -(leaf.get(kv[0], 0) if sort == "leaf"
                                         else kv[1]))
        for key, n in ranked[:top]:
            fname, lineno, qual = key
            out.write(f"{n:>8} {leaf.get(key, 0):>8}  "
                      f"{qual} ({fname}:{lineno})\n")
        return out.getvalue()
    finally:
        _profile_lock.release()


_heap_started = False


def heap_profile(top: int = 40) -> Dict:
    """tracemalloc snapshot of the top allocation sites.

    The tracer is started on the first request (like pprof's heap
    profile, which is always-on in Go; Python's tracer costs ~2x alloc
    overhead, so it's opt-in via first use of this endpoint)."""
    global _heap_started
    import tracemalloc

    if not _heap_started:
        tracemalloc.start(10)
        _heap_started = True
        return {"status": "tracer started; re-request for data"}
    snap = tracemalloc.take_snapshot()
    stats = snap.statistics("lineno")[:top]
    current, peak = tracemalloc.get_traced_memory()
    return {
        "current_bytes": current,
        "peak_bytes": peak,
        "top": [
            {
                "site": str(st.traceback[0]) if st.traceback else "?",
                "size_bytes": st.size,
                "count": st.count,
            }
            for st in stats
        ],
    }


def thread_dump() -> str:
    """Stack trace of every live thread — the goroutine-dump analogue
    (pprof /debug/pprof/goroutine?debug=2)."""
    frames = sys._current_frames()
    by_id = {t.ident: t for t in threading.enumerate()}
    out = io.StringIO()
    for tid, frame in sorted(frames.items()):
        t = by_id.get(tid)
        name = t.name if t is not None else "?"
        daemon = " daemon" if (t is not None and t.daemon) else ""
        out.write(f"thread {tid} [{name}]{daemon}:\n")
        traceback.print_stack(frame, file=out)
        out.write("\n")
    return out.getvalue()


class DeviceTracer:
    """Bounded ``torch.profiler`` trace sessions (device-side profiling).

    ``device`` is the card by default and raises without one
    (``resolve_device``); ``device="cpu"`` records CPU activity only.  One
    active session at a time; :meth:`stop` writes the session's chrome
    trace (``trace.json``) into its directory and returns the directory,
    for the operator to open in a trace viewer."""

    TRACE_FILE = "trace.json"

    def __init__(self, base_dir: Optional[str] = None, device=None):
        self.base_dir = base_dir or os.path.join(
            tempfile.gettempdir(), "nomad_tpu_torch_traces")
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._active_dir: Optional[str] = None
        self._profiler: Optional[torch.profiler.profile] = None
        self._started_at = 0.0

    def start(self) -> str:
        with self._lock:
            if self._active_dir is not None:
                raise RuntimeError(
                    f"trace already active in {self._active_dir}")
            d = os.path.join(self.base_dir, time.strftime("%Y%m%d-%H%M%S"))
            os.makedirs(d, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if is_cuda_platform(self.device):
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()
            self._profiler = profiler
            self._active_dir = d
            self._started_at = time.monotonic()
            return d

    def stop(self) -> Dict:
        if is_cuda_platform(self.device):
            # Kernels still queued belong to the session.  Synchronized
            # before the lock: no device sync is held under it.
            torch.cuda.synchronize(self.device)
        with self._lock:
            if self._active_dir is None:
                raise RuntimeError("no active trace")
            profiler, self._profiler = self._profiler, None
            d, self._active_dir = self._active_dir, None
            profiler.stop()
            profiler.export_chrome_trace(os.path.join(d, self.TRACE_FILE))
            return {"dir": d,
                    "duration_s": round(time.monotonic() - self._started_at,
                                        3)}

    def capture(self, seconds: float = 1.0) -> Dict:
        """start -> sleep -> stop in one bounded call (the /trace?seconds=N
        endpoint shape)."""
        seconds = max(0.05, min(float(seconds), 30.0))
        d = self.start()
        try:
            time.sleep(seconds)
        finally:
            info = self.stop()
        info["dir"] = d
        return info


_tracer_lock = threading.Lock()
_tracer: Optional[DeviceTracer] = None


def get_tracer() -> DeviceTracer:
    """Process-wide tracer singleton, on the card: the torch profiler is
    process-global, so two DeviceTracer instances started concurrently
    would corrupt each other's sessions."""
    global _tracer
    with _tracer_lock:
        if _tracer is None:
            _tracer = DeviceTracer()
        return _tracer
