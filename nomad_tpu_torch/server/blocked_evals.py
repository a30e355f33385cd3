"""BlockedEvals: tracks evals that failed placement, keyed by computed node
class, and re-admits them when capacity appears (a copy of
``nomad_tpu/server/blocked_evals.py``; reference
nomad/blocked_evals.go:24-480).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..structs import structs as s
from .eval_broker import EvalBroker

UNBLOCK_BUFFER = 8096


@dataclass
class _Wrapped:
    eval: s.Evaluation
    token: str


class BlockedEvals:
    def __init__(self, eval_broker: EvalBroker):
        self.eval_broker = eval_broker
        self._l = threading.RLock()
        self._enabled = False
        self.captured: Dict[str, _Wrapped] = {}
        self.escaped: Dict[str, _Wrapped] = {}
        self.jobs: Dict[str, str] = {}
        self.unblock_indexes: Dict[str, int] = {}
        self.duplicates: List[s.Evaluation] = []
        self._dup_cond = threading.Condition(self._l)
        self._capacity_q: "queue.Queue[Optional[Tuple[str, int]]]" = queue.Queue(
            maxsize=UNBLOCK_BUFFER)
        self._watcher: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def enabled(self) -> bool:
        with self._l:
            return self._enabled

    def set_enabled(self, enabled: bool) -> None:
        with self._l:
            if self._enabled == enabled:
                return
            self._enabled = enabled
            if enabled:
                self._watcher = threading.Thread(
                    target=self._watch_capacity, daemon=True,
                    name="blocked-evals-watcher")
                self._watcher.start()
            else:
                self._capacity_q.put(None)  # stop sentinel
        if not enabled:
            self.flush()

    # -- block / unblock ---------------------------------------------------

    def block(self, ev: s.Evaluation) -> None:
        self._process_block(ev, "")

    def reblock(self, ev: s.Evaluation, token: str) -> None:
        self._process_block(ev, token)

    def _process_block(self, ev: s.Evaluation, token: str) -> None:
        with self._l:
            if not self._enabled:
                return
            if ev.job_id in self.jobs:
                # Only one blocked eval per job (blocked_evals.go:160).
                self.duplicates.append(ev)
                self._dup_cond.notify_all()
                return
            if self._missed_unblock(ev):
                # Capacity changed while the eval was in the scheduler; just
                # re-enqueue (blocked_evals.go:175).
                self.eval_broker.enqueue_all([(ev, token)])
                return
            self.jobs[ev.job_id] = ev.id
            wrapped = _Wrapped(ev, token)
            if ev.escaped_computed_class:
                self.escaped[ev.id] = wrapped
            else:
                self.captured[ev.id] = wrapped

    def _missed_unblock(self, ev: s.Evaluation) -> bool:
        """(blocked_evals.go:209)."""
        max_index = 0
        for klass, index in self.unblock_indexes.items():
            max_index = max(max_index, index)
            if klass not in ev.class_eligibility and ev.snapshot_index < index:
                return True
            if ev.class_eligibility.get(klass) and ev.snapshot_index < index:
                return True
        if ev.escaped_computed_class and ev.snapshot_index < max_index:
            return True
        return False

    def block_preempted(self, evals: List[s.Evaluation]) -> None:
        """Track the follow-up evals of preempted jobs (the plan applier
        calls this right after committing a preemption plan).  The
        standard block path applies unchanged: the evals carry no class
        eligibility, so any capacity change re-admits them, and the
        missed-unblock check covers capacity that arrived between the
        plan's raft apply (their snapshot_index) and this registration."""
        for ev in evals:
            self._process_block(ev, "")

    def untrack(self, job_id: str) -> None:
        """Stop tracking after a successful eval (blocked_evals.go:247)."""
        with self._l:
            if not self._enabled:
                return
            eval_id = self.jobs.get(job_id)
            if eval_id is None:
                return
            for table in (self.captured, self.escaped):
                wrapped = table.pop(eval_id, None)
                if wrapped is not None:
                    self.jobs.pop(wrapped.eval.job_id, None)

    def unblock(self, computed_class: str, index: int) -> None:
        """Called from the FSM on node/alloc capacity changes
        (blocked_evals.go:284) — buffered to avoid back-pressuring the log
        apply path."""
        with self._l:
            if not self._enabled:
                return
            self.unblock_indexes[computed_class] = index
        self._capacity_q.put((computed_class, index))

    def _watch_capacity(self) -> None:
        while True:
            update = self._capacity_q.get()
            if update is None:
                return
            self._unblock(*update)

    def _unblock(self, computed_class: str, index: int) -> None:
        with self._l:
            if not self._enabled:
                return
            unblocked: List[Tuple[s.Evaluation, str]] = []

            def admit(wrapped: _Wrapped) -> None:
                # Carry the unblock index on a copy: the stale-snapshot
                # worker pool (worker.py _required_index) must schedule
                # this eval from a snapshot that CONTAINS the capacity
                # change that woke it — a cached view from before the
                # unblock would re-fail the placement and re-block the
                # eval in a wake/re-block spin until the cache rolls.
                ev = wrapped.eval.copy()
                ev.snapshot_index = max(ev.snapshot_index, index)
                unblocked.append((ev, wrapped.token))

            # Escaped evals always unblock — any node could be feasible.
            for eid in list(self.escaped):
                wrapped = self.escaped.pop(eid)
                self.jobs.pop(wrapped.eval.job_id, None)
                admit(wrapped)
            # Captured evals unblock unless explicitly ineligible for this
            # class (unknown classes unblock for correctness).
            for eid in list(self.captured):
                wrapped = self.captured[eid]
                elig = wrapped.eval.class_eligibility.get(computed_class)
                if elig is False:
                    continue
                del self.captured[eid]
                self.jobs.pop(wrapped.eval.job_id, None)
                admit(wrapped)
            if unblocked:
                self.eval_broker.enqueue_all(unblocked)

    def unblock_failed(self) -> None:
        """Periodic retry of evals blocked by max-plan failures
        (blocked_evals.go:372)."""
        with self._l:
            if not self._enabled:
                return
            unblocked: List[Tuple[s.Evaluation, str]] = []
            for table in (self.captured, self.escaped):
                for eid in list(table):
                    wrapped = table[eid]
                    if wrapped.eval.triggered_by == s.EVAL_TRIGGER_MAX_PLANS:
                        del table[eid]
                        self.jobs.pop(wrapped.eval.job_id, None)
                        unblocked.append((wrapped.eval, wrapped.token))
            if unblocked:
                self.eval_broker.enqueue_all(unblocked)

    def get_duplicates(self, timeout: Optional[float]) -> List[s.Evaluation]:
        """Blocking fetch of duplicate blocked evals for cancellation
        (blocked_evals.go:407)."""
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        with self._l:
            while True:
                if self.duplicates:
                    dups = self.duplicates
                    self.duplicates = []
                    return dups
                remaining = None if deadline is None else deadline - _time.monotonic()
                if remaining is not None and remaining <= 0:
                    return []
                self._dup_cond.wait(remaining)

    def flush(self) -> None:
        with self._l:
            self.captured = {}
            self.escaped = {}
            self.jobs = {}
            self.duplicates = []

    def stats(self) -> Dict[str, int]:
        with self._l:
            return {
                "total_blocked": len(self.captured) + len(self.escaped),
                "total_escaped": len(self.escaped),
            }
