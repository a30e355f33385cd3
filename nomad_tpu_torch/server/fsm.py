"""Replicated-log state machine (a subset of ``nomad_tpu/server/fsm.py``;
reference nomad/fsm.go:115-600).

Decodes log entries and dispatches them to the port's ``StateStore``;
emits blocked-eval unblocks on capacity changes and feeds the eval broker
on the leader, the side-channel hooks nomadFSM.Apply performs.

The handlers kept are the ones the server path applies: node register,
deregister, status and drain; job register and deregister; eval update
and delete (the GC path); alloc update and client update; plan results;
job summary reconcile; the vault accessors, the periodic launches and
the namespaces.  :meth:`FSM.snapshot` and
:meth:`FSM.restore` (fsm.py:239-257) persist and replace the store; a
restore hands the cluster event broker (``event_broker``, which
``Server.enable_event_stream`` remembers here) to the restored store and
raises its gap horizon to the restored index.  The leader-side hooks
(fsm.py:43-67) are ``on_eval_update``, ``on_unblock``,
``on_job_register``, ``on_job_deregister`` (the periodic dispatcher and
the quota ledger), ``on_alloc_terminal`` (the vault revocation of a
terminal alloc's tokens) and ``on_namespace_update`` (the tenancy
policies).
"""
from __future__ import annotations

import logging
import time
from enum import IntEnum
from typing import Callable, Dict, List, Optional

from ..state.state_store import PeriodicLaunch, StateStore, VaultAccessor
from ..structs import structs as s


class MessageType(IntEnum):
    """Log message types (reference: structs.go:43-56); the numbers are
    the reference's."""

    NODE_REGISTER = 0
    NODE_DEREGISTER = 1
    NODE_UPDATE_STATUS = 2
    NODE_UPDATE_DRAIN = 3
    JOB_REGISTER = 4
    JOB_DEREGISTER = 5
    EVAL_UPDATE = 6
    EVAL_DELETE = 7
    ALLOC_UPDATE = 8
    ALLOC_CLIENT_UPDATE = 9
    RECONCILE_JOB_SUMMARIES = 10
    VAULT_ACCESSOR_REGISTER = 11
    VAULT_ACCESSOR_DEREGISTER = 12
    APPLY_PLAN_RESULTS = 13
    PERIODIC_LAUNCH_UPSERT = 14
    PERIODIC_LAUNCH_DELETE = 15
    NAMESPACE_UPSERT = 16
    NAMESPACE_DELETE = 17


class FSM:
    """Applies committed log entries to the state store."""

    def __init__(
        self,
        state: Optional[StateStore] = None,
        logger: Optional[logging.Logger] = None,
        on_eval_update: Optional[Callable[[s.Evaluation], None]] = None,
        on_unblock: Optional[Callable[[str, int], None]] = None,
        on_job_register: Optional[Callable[[s.Job], None]] = None,
        on_job_deregister: Optional[Callable[[str], None]] = None,
        on_alloc_terminal: Optional[Callable[[str], None]] = None,
        on_namespace_update: Optional[
            Callable[[str, Optional[s.Namespace]], None]] = None,
    ):
        self.state = state if state is not None else StateStore()
        self.logger = logger or logging.getLogger("nomad_tpu_torch.fsm")
        # Leader-side hooks (fsm.go:58-66).
        self.on_eval_update = on_eval_update
        self.on_unblock = on_unblock
        self.on_job_register = on_job_register
        self.on_job_deregister = on_job_deregister
        # A client's terminal alloc update (the vault revocation).
        self.on_alloc_terminal = on_alloc_terminal
        # The tenancy push: (name, ns) on upsert and (name, None) on
        # delete, so the broker's fairness weights and the rate buckets
        # track the committed rows.
        self.on_namespace_update = on_namespace_update
        # The cluster event broker (server/event_broker.py), remembered
        # here for a restore to hand to its new store (fsm.py:71-74).
        self.event_broker = None

    def apply(self, index: int, msg_type: MessageType, payload: dict):
        """(fsm.go:115 Apply / :132-158 dispatch)."""
        handler = self._DISPATCH.get(MessageType(msg_type))
        if handler is None:
            raise ValueError(
                f"failed to apply request: unknown type {msg_type}")
        return handler(self, index, payload)

    # -- node --------------------------------------------------------------

    def _apply_node_register(self, index: int, req: dict):
        node: s.Node = req["node"]
        if not node.computed_class:
            node.compute_class()
        self.state.upsert_node(index, node)
        # Re-registration of a down node restores capacity
        # (fsm.go:182-188).
        if self.on_unblock and node.computed_class:
            self.on_unblock(node.computed_class, index)

    def _apply_node_deregister(self, index: int, req: dict):
        self.state.delete_node(index, req["node_id"])

    def _apply_node_update_status(self, index: int, req: dict):
        self.state.update_node_status(index, req["node_id"], req["status"])
        if req["status"] == s.NODE_STATUS_READY and self.on_unblock:
            node = self.state.node_by_id(None, req["node_id"])
            if node is not None and node.computed_class:
                self.on_unblock(node.computed_class, index)

    def _apply_node_update_drain(self, index: int, req: dict):
        self.state.update_node_drain(index, req["node_id"], req["drain"])

    # -- job ---------------------------------------------------------------

    def _apply_job_register(self, index: int, req: dict):
        job: s.Job = req["job"]
        self.state.upsert_job(index, job)
        if self.on_job_register is not None:
            self.on_job_register(job)

    def _apply_job_deregister(self, index: int, req: dict):
        job_id = req["job_id"]
        if req.get("purge", True):
            try:
                self.state.delete_job(index, job_id)
            except KeyError:
                pass
        else:
            job = self.state.job_by_id(None, job_id)
            if job is not None:
                stopped = job.copy()
                stopped.stop = True
                self.state.upsert_job(index, stopped)
        if self.on_job_deregister is not None:
            self.on_job_deregister(job_id)

    # -- evals -------------------------------------------------------------

    def _apply_eval_update(self, index: int, req: dict):
        evals: List[s.Evaluation] = req["evals"]
        self.state.upsert_evals(index, evals)
        if self.on_eval_update is not None:
            for ev in evals:
                # Hand the hook a copy of the STORED eval: the store stamps
                # create/modify_index on its own copy (the worker's
                # snapshot fence keys on them), and the broker mutates its
                # evals (the nack re-enqueue delay), while store rows are
                # shared with snapshots.
                stored = self.state.eval_by_id(None, ev.id)
                self.on_eval_update(stored.copy() if stored is not None
                                    else ev)

    def _apply_eval_delete(self, index: int, req: dict):
        self.state.delete_eval(index, req.get("evals", []),
                               req.get("allocs", []))

    # -- allocs ------------------------------------------------------------

    def _apply_alloc_update(self, index: int, req: dict):
        allocs: List[s.Allocation] = req["allocs"]
        job = req.get("job")
        for alloc in allocs:
            if alloc.job is None and not alloc.terminal_status():
                alloc.job = job
            if alloc.resources is None and alloc.task_resources:
                total = s.Resources()
                for tr in alloc.task_resources.values():
                    total.add(tr)
                total.add(alloc.shared_resources)
                alloc.resources = total
        self.state.upsert_allocs(index, allocs)

    def _apply_alloc_client_update(self, index: int, req: dict):
        allocs: List[s.Allocation] = req["allocs"]
        self.state.update_allocs_from_client(index, allocs)
        # Unblock on terminal client updates: capacity freed.
        for alloc in allocs:
            if not alloc.client_terminal_status():
                continue
            if self.on_alloc_terminal is not None:
                self.on_alloc_terminal(alloc.id)
            if not self.on_unblock:
                continue
            existing = self.state.alloc_by_id(None, alloc.id)
            if existing is None:
                continue
            node = self.state.node_by_id(None, existing.node_id)
            if node is not None and node.computed_class:
                self.on_unblock(node.computed_class, index)

    # -- plan results ------------------------------------------------------

    def _apply_plan_results(self, index: int, req: dict):
        self.state.upsert_plan_results(index, req.get("job"), req["allocs"],
                                       req.get("slabs"),
                                       eval_id=req.get("eval_id", ""))
        # Preemption follow-up evals commit with the evict and place they
        # belong to (plan_apply.py builds them); the applier hands them to
        # BlockedEvals after this apply returns.
        evals = req.get("preemption_evals")
        if evals:
            self.state.upsert_evals(index, evals)

    # -- summaries / vault / periodic --------------------------------------

    def _apply_reconcile_summaries(self, index: int, req: dict):
        self.state.reconcile_job_summaries(index)

    def _apply_vault_register(self, index: int, req: dict):
        accessors: List[VaultAccessor] = req["accessors"]
        self.state.upsert_vault_accessors(index, accessors)

    def _apply_vault_deregister(self, index: int, req: dict):
        self.state.delete_vault_accessors(index, req["accessors"])

    def _apply_periodic_launch_upsert(self, index: int, req: dict):
        self.state.upsert_periodic_launch(
            index, PeriodicLaunch(id=req["job_id"], launch=req["launch"]))

    def _apply_periodic_launch_delete(self, index: int, req: dict):
        self.state.delete_periodic_launch(index, req["job_id"])

    # -- namespaces --------------------------------------------------------

    def _apply_namespace_upsert(self, index: int, req: dict):
        ns: s.Namespace = req["namespace"]
        self.state.upsert_namespace(index, ns)
        if self.on_namespace_update is not None:
            self.on_namespace_update(ns.name, ns)

    def _apply_namespace_delete(self, index: int, req: dict):
        self.state.delete_namespace(index, req["name"])
        if self.on_namespace_update is not None:
            self.on_namespace_update(req["name"], None)

    # -- snapshot / restore ------------------------------------------------

    def snapshot(self) -> bytes:
        """(fsm.go:568): the store's v2 blob when it keeps the columnar
        mirror, its per-object blob otherwise."""
        return self.state.persist()

    def restore(self, blob: bytes) -> None:
        """(fsm.go:582): the state store replaced wholesale by the one the
        blob holds (either format), with this store's columnar setting and
        delta-log cap.  The restored store is a new lineage; the event
        broker moves to it, and its gap horizon rises to the restored
        index: the snapshot's writes were never published, so a resume
        inside that range errors instead of replaying nothing.  The old
        store is retired, which wakes the blocking queries on it."""
        old = self.state
        self.state = StateStore.restore(
            blob, alloc_log_cap=old.alloc_log_cap, columnar=old.columnar)
        if self.event_broker is not None:
            self.state.event_broker = self.event_broker
            self.event_broker.mark_armed(self.state.latest_index())
        # Blocking queries waiting on the replaced store re-run on this one.
        old.retire()

    _DISPATCH: Dict[MessageType, Callable] = {
        MessageType.NODE_REGISTER: _apply_node_register,
        MessageType.NODE_DEREGISTER: _apply_node_deregister,
        MessageType.NODE_UPDATE_STATUS: _apply_node_update_status,
        MessageType.NODE_UPDATE_DRAIN: _apply_node_update_drain,
        MessageType.JOB_REGISTER: _apply_job_register,
        MessageType.JOB_DEREGISTER: _apply_job_deregister,
        MessageType.EVAL_UPDATE: _apply_eval_update,
        MessageType.EVAL_DELETE: _apply_eval_delete,
        MessageType.ALLOC_UPDATE: _apply_alloc_update,
        MessageType.ALLOC_CLIENT_UPDATE: _apply_alloc_client_update,
        MessageType.RECONCILE_JOB_SUMMARIES: _apply_reconcile_summaries,
        MessageType.VAULT_ACCESSOR_REGISTER: _apply_vault_register,
        MessageType.VAULT_ACCESSOR_DEREGISTER: _apply_vault_deregister,
        MessageType.APPLY_PLAN_RESULTS: _apply_plan_results,
        MessageType.PERIODIC_LAUNCH_UPSERT: _apply_periodic_launch_upsert,
        MessageType.PERIODIC_LAUNCH_DELETE: _apply_periodic_launch_delete,
        MessageType.NAMESPACE_UPSERT: _apply_namespace_upsert,
        MessageType.NAMESPACE_DELETE: _apply_namespace_delete,
    }


class TimeTable:
    """Index ↔ wall-clock mapping used by GC thresholds
    (reference: nomad/timetable.go:14-109)."""

    def __init__(self, granularity: float = 1.0,
                 limit: float = 72 * 3600.0):
        self.granularity = granularity
        self.limit = limit
        self._table: List[tuple] = []  # (index, unix_time), newest first

    def witness(self, index: int, when: Optional[float] = None) -> None:
        when = when if when is not None else time.time()
        if self._table and when - self._table[0][1] < self.granularity:
            return
        self._table.insert(0, (index, when))
        # Trim entries beyond the horizon.
        cutoff = when - self.limit
        while self._table and self._table[-1][1] < cutoff:
            self._table.pop()

    def nearest_index(self, when: float) -> int:
        """Largest index with time <= when."""
        for index, t in self._table:
            if t <= when:
                return index
        return 0

    def nearest_time(self, index: int) -> float:
        for idx, t in self._table:
            if idx <= index:
                return t
        return 0.0
