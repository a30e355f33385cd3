"""The replicated log under the FSM (a subset of
``nomad_tpu/server/raft.py:91-266``; reference hashicorp/raft with the
in-memory store of nomad/server.go:91-95).

- ``RaftLog`` — the interface the server applies through: ``apply``
  assigns the next index and applies the entry to the FSM in strict index
  order, ``applied_index`` (locked), ``applied_index_relaxed`` (lock-free
  lower bound), ``fence_index``, and leadership notification.
- ``InmemLog`` — the single-voter in-memory log (raftInmem): always the
  leader.

Each apply is traced as a ``raft.apply`` span (raft.py:241-245), which
inherits the eval of the span it runs under (``plan.apply``).

Left out, for later slices: the durable ``FileLog`` (WAL, fsync group
commit, snapshots; ROADMAP queue 1 item 16), ``MultiRaft`` (item 17), and
the ``raft.apply`` fault point.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List

from ..utils import tracing
from ..utils.telemetry import NULL_TELEMETRY
from .fsm import FSM, MessageType


class NotLeaderError(Exception):
    pass


class RaftLog:
    """Single-voter commit path: append → apply."""

    # Telemetry handle, assigned by the owning Server after construction.
    metrics = NULL_TELEMETRY

    def __init__(self, fsm: FSM):
        self.fsm = fsm
        # RLock: FSM-apply hooks may read applied_index() on the applying
        # thread.
        self._l = threading.RLock()
        self._last_index = 0
        self._applied = 0
        self._leader = True  # single voter: always the leader
        self._leader_listeners: List[Callable[[bool], None]] = []
        # Apply sequencer: entries apply to the FSM in strict index order.
        self._apply_cv = threading.Condition()
        self._apply_next = 1

    # -- leadership --------------------------------------------------------

    def is_leader(self) -> bool:
        return self._leader

    def notify_leadership(self, cb: Callable[[bool], None]) -> None:
        self._leader_listeners.append(cb)
        cb(self._leader)

    def _set_leader(self, leader: bool) -> None:
        if leader == self._leader:
            return
        self._leader = leader
        for cb in self._leader_listeners:
            cb(leader)

    # -- log ---------------------------------------------------------------

    def applied_index(self) -> int:
        with self._l:
            return self._applied

    def fence_index(self) -> int:
        """Upper bound on every committed entry's index (the follower-read
        fence floor at leadership).  Applied equals last here."""
        return self.applied_index()

    def applied_index_relaxed(self) -> int:
        """Lock-free lower bound on :meth:`applied_index`: ``_applied`` is
        stamped after each FSM apply, so this never reports an entry whose
        state is not yet visible; it may lag an in-flight apply by one.
        For hot polls (wait-for-index)."""
        return self._applied

    def apply(self, msg_type: MessageType, payload: dict):
        """Append + commit + apply one entry; returns (result, index).
        The index is assigned under the log lock, then the FSM applies in
        strict index order; an FSM apply that raises propagates to its
        caller, and the sequencer still advances past its index."""
        t0 = time.perf_counter()
        with self._l:
            if not self._leader:
                raise NotLeaderError("not the leader")
            self._last_index += 1
            index = self._last_index
        with self._apply_cv:
            while self._apply_next != index:
                self._apply_cv.wait()
            try:
                result = self.fsm.apply(index, msg_type, payload)
            finally:
                self._applied = index
                self._apply_next = index + 1
                self._apply_cv.notify_all()
        self.metrics.measure_since("raft.apply", t0)
        # Branch before building attrs: disarmed, a commit pays one load
        # and a comparison.
        tr = tracing.TRACER
        if tr is not None:
            tr.record("raft.apply", t0, time.perf_counter(), index=index,
                      msg_type=getattr(msg_type, "name", str(msg_type)))
        return result, index

    def close(self) -> None:
        pass


class InmemLog(RaftLog):
    """In-memory log for dev and tests (the raftInmem analogue)."""
