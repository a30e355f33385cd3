"""The plan applier: the serialization point of the optimistic scheduler
(a subset of ``nomad_tpu/server/plan_apply.py``; reference
nomad/plan_apply.go:27-371).

A plan is re-checked against a snapshot of the port's state store: every
node it touches must still be ready and not draining, every alloc it
preempts must be unchanged, and the node's proposed allocs must still fit
(``allocs_fit``).  A plan that fails on some nodes commits on the others
(a partial commit, with ``refresh_index``), an ``all_at_once`` plan
commits nothing; the committed part goes into the store at the next
index through ``StateStore.upsert_plan_results``, and the resident usage
mirror (``ops/resident.py``) is told the index.

At :data:`VECTORIZE_THRESHOLD` touched nodes or more, the fit math of the
re-check is one call of ``ops.kernels.batch_allocs_fit`` on the
applier's device (``cuda`` unless ``device="cpu"``); nodes whose proposed
allocs reserve networks keep the scalar ``allocs_fit``, which owns the
port and bandwidth math.  A device error there propagates.

:meth:`PlanApplier.submit_plan` runs the reference's serial
``_process_plan`` → ``_commit`` (plan_apply.py:174, :227) for one plan,
so the applier is a planner: ``Harness.planner = PlanApplier(...)``.

Left out: the columnar fit route (plan_apply.py:361, which needs the
store's columnar mirror), the plan queue, the commit-thread pool and its
pipeline depth (the in-flight overlay is kept and read, but only a test
fills it), the raft log, telemetry and tracing spans, the event-broker
``PlanApplied`` summary, blocked-eval hand-off of preemption follow-ups
(they are written to the store with the commit), and allocs'
``create_time`` (the port's Allocation has no such field).
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import fault
from ..device import resolve_device
from ..ops import resident
from ..ops.kernels import batch_allocs_fit
from ..structs import structs as s
from ..structs.funcs import allocs_fit, remove_allocs

# At or above this many touched nodes the vectorized fit re-check is used.
VECTORIZE_THRESHOLD = 64


class _InflightOverlay:
    """Placements of plans whose commit is still in flight, keyed by
    plan: the fit re-check adds them to each touched node's proposed set
    so pipelined plans cannot jointly over-commit a node."""

    def __init__(self):
        self._l = threading.Lock()
        self._plans: Dict[int, Dict[str, List[Tuple[s.Allocation, int]]]] = {}

    def add(self, token: int, result: s.PlanResult) -> None:
        by_node: Dict[str, List[Tuple[s.Allocation, int]]] = {}
        for node_id, allocs in result.node_allocation.items():
            for alloc in allocs:
                by_node.setdefault(node_id, []).append((alloc, 1))
        for slab in result.alloc_slabs:
            for node_id, cnt in slab.node_counts().items():
                by_node.setdefault(node_id, []).append((slab.proto, cnt))
        with self._l:
            self._plans[token] = by_node

    def remove(self, token: int) -> None:
        with self._l:
            self._plans.pop(token, None)

    def pending_for(self, node_id: str) -> List[Tuple[s.Allocation, int]]:
        with self._l:
            out: List[Tuple[s.Allocation, int]] = []
            for by_node in self._plans.values():
                out.extend(by_node.get(node_id, ()))
            return out


def _res_vec(r: Optional[s.Resources]) -> np.ndarray:
    if r is None:
        return np.zeros(4, dtype=np.int64)
    return np.array([r.cpu, r.memory_mb, r.disk_mb, r.iops], dtype=np.int64)


class PlanApplier:
    """Re-checks and commits plans into ``state`` (a ``StateStore``).

    ``next_index`` gives the commit index (default: the store's latest
    index plus one; a ``Harness`` passes its own ``next_index``).
    ``device`` is where the vectorized re-check runs.  ``stats`` sums,
    since the last :meth:`reset_stats`, the plans seen, the seconds of
    evaluate and apply, the touched nodes, the plans per route
    (``vectorized``, ``scalar``), the nodes the vectorized route left to
    the scalar check, and the devices ``batch_allocs_fit`` ran on."""

    def __init__(self, state, device=None,
                 next_index: Optional[Callable[[], int]] = None,
                 logger: Optional[logging.Logger] = None):
        self.state = state
        self.device = resolve_device(device)
        self._next_index = (next_index if next_index is not None
                            else lambda: self.state.latest_index() + 1)
        self.logger = logger or logging.getLogger(
            "nomad_tpu_torch.server.plan_apply")
        self._overlay = _InflightOverlay()
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats = {"plans": 0, "evaluate_seconds": 0.0,
                      "apply_seconds": 0.0, "touched_nodes": 0,
                      "vectorized": 0, "scalar": 0, "scalar_fallback": 0,
                      "partial": 0, "fit_devices": set()}

    # -- the planner interface ---------------------------------------------

    def submit_plan(self, plan: s.Plan
                    ) -> Tuple[s.PlanResult, Optional[object]]:
        """Evaluate ``plan`` and commit what is left (plan_apply.py:174
        ``_process_plan``, :227 ``_commit``).  As in the reference, the
        re-check reads the live store: the applier is its only plan
        writer.  Returns the result and, when it has a ``refresh_index``
        (a partial commit), a fresh snapshot for the scheduler to retry
        on; None otherwise."""
        snap = self.state
        t0 = time.perf_counter()
        result = self.evaluate_plan(snap, plan)
        self.stats["plans"] += 1
        self.stats["evaluate_seconds"] += time.perf_counter() - t0
        if result.node_update or result.node_allocation \
                or result.alloc_slabs:
            t1 = time.perf_counter()
            index = self.apply_plan(plan, result, snap)
            self.stats["apply_seconds"] += time.perf_counter() - t1
            result.alloc_index = index
            if result.refresh_index:
                # A partial commit: the scheduler must see at least its
                # own placements (plan_apply.go:187-193).
                result.refresh_index = max(result.refresh_index, index)
        if result.refresh_index:
            self.stats["partial"] += 1
            return result, self.state.snapshot()
        return result, None

    def update_eval(self, ev: s.Evaluation) -> None:
        """Eval writes belong to the server, which the port does not have
        yet; the ``Harness`` records them."""

    def create_eval(self, ev: s.Evaluation) -> None:
        """See :meth:`update_eval`."""

    def reblock_eval(self, ev: s.Evaluation) -> None:
        """See :meth:`update_eval`."""

    # -- evaluation --------------------------------------------------------

    def evaluate_plan(self, snap, plan: s.Plan) -> s.PlanResult:
        """The committable part of ``plan`` (plan_apply.go:202
        evaluatePlan): the per-node re-check, then a partial or an
        all-or-nothing commit.  Alloc slabs stay whole on a full commit
        and are cut to the nodes that passed on a partial one."""
        result = s.PlanResult(node_update={}, node_allocation={})
        touched = {*plan.node_update, *plan.node_allocation,
                   *plan.node_preemptions}
        for slab in plan.alloc_slabs:
            touched.update(slab.node_ids)
        node_ids = list(touched)
        self.stats["touched_nodes"] += len(node_ids)

        slab_adds = self._slab_node_adds(plan)
        fits = self._evaluate_nodes(snap, plan, node_ids, slab_adds)

        partial = False
        gang_failed = False
        ok_nodes = set()
        for node_id, fit in fits.items():
            if not fit:
                partial = True
                if plan.all_at_once:
                    result.node_update = {}
                    result.node_allocation = {}
                    gang_failed = True
                    break
                continue
            ok_nodes.add(node_id)
            if plan.node_update.get(node_id):
                result.node_update[node_id] = plan.node_update[node_id]
            if plan.node_allocation.get(node_id):
                result.node_allocation[node_id] = plan.node_allocation[node_id]
            if plan.node_preemptions.get(node_id):
                result.node_preemptions[node_id] = plan.node_preemptions[node_id]

        if gang_failed:
            result.node_preemptions = {}
        else:
            for slab in plan.alloc_slabs:
                if not partial:
                    result.alloc_slabs.append(slab)
                else:
                    filtered = slab.filter_nodes(ok_nodes)
                    if len(filtered):
                        result.alloc_slabs.append(filtered)

        if partial:
            result.refresh_index = max(
                snap.table_index("nodes"), snap.table_index("allocs"))
        return result

    @staticmethod
    def _slab_node_adds(plan: s.Plan
                        ) -> Dict[str, List[Tuple[s.Allocation, int]]]:
        """Per node, the (prototype, count) additions of the plan's
        slabs."""
        out: Dict[str, List[Tuple[s.Allocation, int]]] = {}
        for slab in plan.alloc_slabs:
            for nid, cnt in slab.node_counts().items():
                out.setdefault(nid, []).append((slab.proto, cnt))
        return out

    def _evaluate_nodes(self, snap, plan: s.Plan, node_ids: List[str],
                        slab_adds: Optional[Dict] = None) -> Dict[str, bool]:
        slab_adds = slab_adds or {}
        # The overlay first, the store second: a commit landing between
        # the two reads is counted twice (conservative), never in neither.
        overlay = {nid: self._overlay.pending_for(nid) for nid in node_ids}
        return self._evaluate_nodes_walk(snap, plan, node_ids, slab_adds,
                                         overlay)

    def _evaluate_nodes_walk(self, snap, plan: s.Plan,
                             node_ids: List[str], slab_adds: Dict,
                             overlay: Dict[str, list]) -> Dict[str, bool]:
        if len(node_ids) >= VECTORIZE_THRESHOLD:
            self.stats["vectorized"] += 1
            return self._evaluate_nodes_vectorized(snap, plan, node_ids,
                                                   slab_adds, overlay)
        self.stats["scalar"] += 1
        return {nid: self._evaluate_node_plan(snap, plan, nid, slab_adds,
                                              overlay=overlay)
                for nid in node_ids}

    def _preemptions_fresh(self, snap, plan: s.Plan, node_id: str) -> bool:
        """The preemption fence: every alloc the plan evicts must still
        exist, be live and be unchanged (modify_index) since the
        scheduler's snapshot."""
        for preempted in plan.node_preemptions.get(node_id, []):
            existing = snap.alloc_by_id(None, preempted.id)
            if (existing is None or existing.terminal_status()
                    or existing.modify_index != preempted.modify_index):
                return False
        return True

    def _evaluate_node_plan(self, snap, plan: s.Plan, node_id: str,
                            slab_adds: Optional[Dict] = None,
                            overlay: Optional[Dict[str, list]] = None,
                            ) -> bool:
        """One node's scalar re-check (plan_apply.go:327
        evaluateNodePlan).  ``overlay`` is the in-flight placements,
        read before the store."""
        if not self._preemptions_fresh(snap, plan, node_id):
            return False
        slab_here = (slab_adds or {}).get(node_id, [])
        if not plan.node_allocation.get(node_id) and not slab_here:
            return True  # evict-only always fits
        node = snap.node_by_id(None, node_id)
        if node is None or node.status != s.NODE_STATUS_READY or node.drain:
            return False
        existing = snap.allocs_by_node_terminal(None, node_id, False)
        remove = list(plan.node_update.get(node_id, []))
        remove.extend(plan.node_preemptions.get(node_id, []))
        remove.extend(plan.node_allocation.get(node_id, []))
        proposed = remove_allocs(existing, remove)
        proposed = proposed + list(plan.node_allocation.get(node_id, []))
        for proto, cnt in slab_here:
            proposed.extend([proto] * cnt)
        pending = (overlay.get(node_id, ()) if overlay is not None
                   else self._overlay.pending_for(node_id))
        for proto, cnt in pending:
            proposed.extend([proto] * cnt)
        try:
            fit, _, _ = allocs_fit(node, proposed)
        except ValueError:
            return False
        return fit

    def _evaluate_nodes_vectorized(
        self, snap, plan: s.Plan, node_ids: List[str],
        slab_adds: Optional[Dict] = None,
        overlay: Optional[Dict[str, list]] = None,
    ) -> Dict[str, bool]:
        """The batched re-check: the proposed usage of every touched node
        on the host, then one ``batch_allocs_fit`` on the applier's device
        (the reference's verification pool).  Nodes with network
        reservations keep the scalar check."""
        n = len(node_ids)
        capacity = np.zeros((n, 4), dtype=np.int64)
        used = np.zeros((n, 4), dtype=np.int64)
        ok_static = np.ones(n, dtype=bool)
        slab_adds = slab_adds or {}
        alloc_only: List[bool] = []
        scalar_fallback: Dict[str, bool] = {}
        for i, node_id in enumerate(node_ids):
            if not self._preemptions_fresh(snap, plan, node_id):
                alloc_only.append(False)
                ok_static[i] = False
                continue
            slab_here = slab_adds.get(node_id, [])
            if not plan.node_allocation.get(node_id) and not slab_here:
                alloc_only.append(True)
                continue
            alloc_only.append(False)
            node = snap.node_by_id(None, node_id)
            if node is None or node.status != s.NODE_STATUS_READY or node.drain:
                ok_static[i] = False
                continue
            capacity[i] = _res_vec(node.resources)
            if node.reserved is not None:
                used[i] += _res_vec(node.reserved)
            existing = snap.allocs_by_node_terminal(None, node_id, False)
            remove = list(plan.node_update.get(node_id, []))
            remove.extend(plan.node_preemptions.get(node_id, []))
            remove.extend(plan.node_allocation.get(node_id, []))
            proposed = remove_allocs(existing, remove)
            proposed = proposed + list(plan.node_allocation.get(node_id, []))
            has_networks = False
            for alloc in proposed:
                if alloc.resources is not None:
                    used[i] += _res_vec(alloc.resources)
                    has_networks = has_networks or bool(
                        alloc.resources.networks)
                else:
                    used[i] += _res_vec(alloc.shared_resources)
                    for tr in alloc.task_resources.values():
                        used[i] += _res_vec(tr)
                        has_networks = has_networks or bool(tr.networks)
            for proto, cnt in slab_here:
                used[i] += cnt * _res_vec(proto.resources)
                has_networks = has_networks or bool(
                    proto.resources is not None and proto.resources.networks)
            pending = (overlay.get(node_id, ()) if overlay is not None
                       else self._overlay.pending_for(node_id))
            for proto, cnt in pending:
                used[i] += cnt * _res_vec(proto.resources)
                has_networks = has_networks or bool(
                    proto.resources is not None and proto.resources.networks)
            if has_networks:
                # Ports and bandwidth: the scalar check for this node.
                scalar_fallback[node_id] = self._evaluate_node_plan(
                    snap, plan, node_id, slab_adds, overlay=overlay)

        self.stats["scalar_fallback"] += len(scalar_fallback)
        fit_t, _ = batch_allocs_fit(
            torch.as_tensor(capacity, dtype=torch.int32, device=self.device),
            torch.as_tensor(used, dtype=torch.int32, device=self.device))
        self.stats["fit_devices"].add(str(fit_t.device))
        fit = fit_t.cpu().numpy()
        out: Dict[str, bool] = {}
        for i, node_id in enumerate(node_ids):
            if alloc_only[i]:
                out[node_id] = True
            elif node_id in scalar_fallback:
                out[node_id] = scalar_fallback[node_id]
            else:
                out[node_id] = bool(ok_static[i] and fit[i])
        return out

    # -- apply -------------------------------------------------------------

    def apply_plan(self, plan: s.Plan, result: s.PlanResult, snap) -> int:
        """Commit ``result`` at the next index (plan_apply.go:123-175
        applyPlan) and return the index.  Fault point ``plan.apply``
        (action ``error``) fires before anything is written: an error
        there commits nothing."""
        act = fault.faultpoint("plan.apply")
        if act is not None and act.kind == "error":
            act.raise_injected()

        allocs: List[s.Allocation] = []
        for update_list in result.node_update.values():
            allocs.extend(update_list)
        for alloc_list in result.node_allocation.values():
            for alloc in alloc_list:
                # As in the reference's log entry: a same-job live
                # placement goes in without its job, on a copy, and
                # upsert_plan_results puts the plan's job back.
                if (alloc.job is not None and plan.job is not None
                        and alloc.job_id == plan.job.id
                        and not alloc.terminal_status()):
                    alloc = alloc.copy()
                    alloc.job = None
                allocs.append(alloc)
        preempted: List[s.Allocation] = []
        for evicted_list in result.node_preemptions.values():
            allocs.extend(evicted_list)
            preempted.extend(evicted_list)
        preemption_evals: List[s.Evaluation] = []
        if preempted:
            # The evictions, the placements and the evicted jobs'
            # follow-up evals commit together.
            preemption_evals = s.preemption_follow_up_evals(
                preempted, snap.latest_index(),
                job_lookup=lambda jid: snap.job_by_id(None, jid))

        index = self._next_index()
        self.state.upsert_plan_results(index, plan.job, allocs,
                                       result.alloc_slabs or None)
        if preemption_evals:
            self.state.upsert_evals(index, preemption_evals)
            for ev in preemption_evals:
                ev.snapshot_index = index
        resident.note_plan_applied(index)
        return index
