"""Leader-only periodic job dispatcher (a copy of
``nomad_tpu/server/periodic.py``; reference nomad/periodic.go:19-586).

Tracks periodic jobs in a launch-time heap; at fire time derives a child
job ``<id>/periodic-<epoch>`` and submits it through the normal register
path.  The periodic_launch state table provides catch-up after failover
(restored by the leader loop, leader.go:150)."""
from __future__ import annotations

import heapq
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..structs import structs as s

PERIODIC_LAUNCH_SUFFIX = "/periodic-"


class PeriodicDispatch:
    def __init__(self, dispatch_callback, logger: Optional[logging.Logger] = None):
        """dispatch_callback(parent_job, launch_time) registers the derived
        job + eval and records the launch."""
        self.dispatch = dispatch_callback
        self.logger = logger or logging.getLogger("nomad_tpu_torch.periodic")
        self._l = threading.RLock()
        self._cond = threading.Condition(self._l)
        self._enabled = False
        self.tracked: Dict[str, s.Job] = {}
        # Heap entries carry the tracking generation at push time; a stale
        # generation means the job was re-added/removed since, and the entry
        # is a tombstone — prevents duplicate dispatch chains on job update.
        self._generation: Dict[str, int] = {}
        self._heap: List[Tuple[float, str, int]] = []
        self._thread: Optional[threading.Thread] = None

    def set_enabled(self, enabled: bool) -> None:
        with self._l:
            if enabled == self._enabled:
                return
            self._enabled = enabled
            if enabled:
                self._thread = threading.Thread(target=self._run, daemon=True,
                                                name="periodic-dispatch")
                self._thread.start()
            else:
                self.tracked = {}
                self._heap = []
            self._cond.notify_all()

    def add(self, job: s.Job) -> None:
        """(periodic.go:147 Add) — track or update a periodic job."""
        with self._l:
            if not self._enabled:
                return
            if not job.is_periodic():
                self.remove(job.id)
                return
            self.tracked[job.id] = job
            gen = self._generation.get(job.id, 0) + 1
            self._generation[job.id] = gen
            nxt = job.periodic.next(time.time())
            if nxt > 0:
                heapq.heappush(self._heap, (nxt, job.id, gen))
            self._cond.notify_all()

    def remove(self, job_id: str) -> None:
        with self._l:
            self.tracked.pop(job_id, None)
            # Bump the generation so in-flight heap entries tombstone.
            self._generation[job_id] = self._generation.get(job_id, 0) + 1
            self._cond.notify_all()

    def force_run(self, job_id: str) -> Optional[s.Job]:
        """(periodic.go:252 ForceRun)."""
        with self._l:
            job = self.tracked.get(job_id)
        if job is None:
            return None
        return self._dispatch_launch(job, time.time())

    def _run(self) -> None:
        while True:
            with self._l:
                if not self._enabled:
                    return
                now = time.time()
                while self._heap and self._heap[0][0] <= now:
                    launch_time, job_id, gen = heapq.heappop(self._heap)
                    job = self.tracked.get(job_id)
                    if job is None or gen != self._generation.get(job_id):
                        continue  # tombstoned by a re-add/remove
                    # re-arm before dispatch so a slow dispatch can't skip
                    nxt = job.periodic.next(launch_time)
                    if nxt > 0:
                        heapq.heappush(self._heap, (nxt, job_id, gen))
                    self._do_dispatch(job, launch_time)
                wait = 0.5
                if self._heap:
                    wait = min(max(self._heap[0][0] - time.time(), 0.01), 5.0)
                self._cond.wait(wait)

    def _do_dispatch(self, job: s.Job, launch_time: float) -> None:
        try:
            self._dispatch_launch(job, launch_time)
        except Exception:
            self.logger.exception("periodic launch of %s failed", job.id)

    def _dispatch_launch(self, job: s.Job, launch_time: float) -> s.Job:
        derived = derive_job(job, launch_time)
        self.dispatch(job, derived, launch_time)
        return derived

    def tracked_jobs(self) -> List[s.Job]:
        with self._l:
            return list(self.tracked.values())


def derive_job(parent: s.Job, launch_time: float) -> s.Job:
    """Child job named '<id>/periodic-<epoch>' (periodic.go:408
    deriveJob)."""
    child = parent.copy()
    child.id = f"{parent.id}{PERIODIC_LAUNCH_SUFFIX}{int(launch_time)}"
    child.name = child.id
    child.parent_id = parent.id
    child.periodic = None
    child.status = ""
    return child
