"""CoreScheduler: internal GC jobs run through the normal eval pipeline (a
copy of ``nomad_tpu/server/core_sched.py``; reference
nomad/core_sched.go:24-439).

Eval type is '_core' and the eval's JobID selects the GC pass:
eval-gc, job-gc, node-gc, or force-gc (structs.go CoreJob* constants).
Thresholds are index-based via the TimeTable: a normal pass reaps what
was last written before the index the table witnessed at now minus the
threshold; force-gc reaps up to the applied index."""
from __future__ import annotations

import logging
import time
from typing import List, Optional

from ..structs import structs as s
from .fsm import MessageType

# GC thresholds (reference: nomad/config.go defaults).
EVAL_GC_THRESHOLD = 3600.0        # 1h
JOB_GC_THRESHOLD = 4 * 3600.0     # 4h
NODE_GC_THRESHOLD = 24 * 3600.0   # 24h


class CoreScheduler:
    def __init__(self, logger: logging.Logger, snap, planner, raft,
                 time_table=None):
        self.logger = logger
        self.snap = snap
        self.planner = planner
        self.raft = raft
        self.time_table = time_table

    def process(self, ev: s.Evaluation) -> None:
        """(core_sched.go:43 Process)."""
        job_id = ev.job_id
        force = job_id == s.CORE_JOB_FORCE_GC
        if job_id in (s.CORE_JOB_EVAL_GC,) or force:
            self._eval_gc(ev, force)
        if job_id in (s.CORE_JOB_JOB_GC,) or force:
            self._job_gc(ev, force)
        if job_id in (s.CORE_JOB_NODE_GC,) or force:
            self._node_gc(ev, force)
        ev2 = ev.copy()
        ev2.status = s.EVAL_STATUS_COMPLETE
        self.planner.update_eval(ev2)

    # -- helpers -----------------------------------------------------------

    def _threshold_index(self, threshold: float, force: bool) -> int:
        if force:
            return self.raft.applied_index()
        if self.time_table is None:
            return 0
        return self.time_table.nearest_index(time.time() - threshold)

    # -- passes ------------------------------------------------------------

    def _eval_gc(self, ev: s.Evaluation, force: bool) -> None:
        """Terminal evals older than the threshold, plus their allocs if
        every alloc is terminal (core_sched.go:64 evalGC)."""
        threshold = self._threshold_index(EVAL_GC_THRESHOLD, force)
        gc_evals: List[str] = []
        gc_allocs: List[str] = []
        for evaluation in self.snap.evals(None):
            if evaluation.modify_index >= threshold:
                continue
            if not evaluation.terminal_status():
                continue
            allocs = self.snap.allocs_by_eval(None, evaluation.id)
            if any(not a.terminal_status() or a.modify_index >= threshold
                   for a in allocs):
                continue
            gc_evals.append(evaluation.id)
            gc_allocs.extend(a.id for a in allocs)
        if gc_evals or gc_allocs:
            self.logger.info("eval GC: %d evals, %d allocs",
                             len(gc_evals), len(gc_allocs))
            self.raft.apply(MessageType.EVAL_DELETE,
                            {"evals": gc_evals, "allocs": gc_allocs})

    def _job_gc(self, ev: s.Evaluation, force: bool) -> None:
        """Dead GC-able jobs with only terminal allocs/evals
        (core_sched.go:170 jobGC)."""
        threshold = self._threshold_index(JOB_GC_THRESHOLD, force)
        for job in self.snap.jobs_by_gc(None, True):
            if job.modify_index >= threshold or job.status != s.JOB_STATUS_DEAD:
                continue
            if job.is_periodic():
                continue
            evals = self.snap.evals_by_job(None, job.id)
            if any(not e.terminal_status() for e in evals):
                continue
            allocs = self.snap.allocs_by_job(None, job.id, True)
            if any(not a.terminal_status() for a in allocs):
                continue
            self.logger.info("job GC: %s", job.id)
            self.raft.apply(MessageType.EVAL_DELETE, {
                "evals": [e.id for e in evals],
                "allocs": [a.id for a in allocs]})
            self.raft.apply(MessageType.JOB_DEREGISTER,
                            {"job_id": job.id, "purge": True})

    def _node_gc(self, ev: s.Evaluation, force: bool) -> None:
        """Down nodes with no allocs (core_sched.go:300 nodeGC)."""
        threshold = self._threshold_index(NODE_GC_THRESHOLD, force)
        for node in self.snap.nodes(None):
            if node.modify_index >= threshold:
                continue
            if node.status != s.NODE_STATUS_DOWN:
                continue
            if self.snap.allocs_by_node(None, node.id):
                continue
            self.logger.info("node GC: %s", node.id)
            self.raft.apply(MessageType.NODE_DEREGISTER, {"node_id": node.id})
