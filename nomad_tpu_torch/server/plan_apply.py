"""The plan applier: the serialization point of the optimistic scheduler
(a copy of ``nomad_tpu/server/plan_apply.py``; reference
nomad/plan_apply.go:27-371).

A plan is re-checked against the port's state store: every node it
touches must still be ready and not draining, every alloc it preempts
must be unchanged, and the node's proposed allocs must still fit
(``allocs_fit``).  A plan that fails on some nodes commits on the others
(a partial commit, with ``refresh_index``), an ``all_at_once`` plan
commits nothing; the committed part goes into the store at the next
index, and the resident usage mirror (``ops/resident.py``) is told the
index.

Without the columnar route, at :data:`VECTORIZE_THRESHOLD` touched nodes
or more, the fit math of the re-check is one call of
``ops.kernels.batch_allocs_fit`` on the applier's device (``cuda`` unless
``device="cpu"``); nodes whose proposed allocs reserve networks keep the
scalar ``allocs_fit``, which owns the port and bandwidth math.  A device
error there propagates.

Two forms share one :meth:`PlanApplier.evaluate_plan` and
:meth:`PlanApplier.apply_plan`:

- ``PlanApplier(state, device=..., next_index=...)`` applies into a
  ``StateStore`` directly; :meth:`PlanApplier.submit_plan` runs the serial
  ``_process_plan`` → ``_commit`` for one plan, so the applier is a
  planner (``Harness.planner = PlanApplier(...)``), and the preemption
  follow-up evals are written to the store with the commit.
- ``PlanApplier(plan_queue, raft, logger, metrics, blocked_evals)`` is
  the server's (plan_apply.py:92-269): :meth:`PlanApplier.start` runs the
  hot loop that dequeues plans, re-checks each against the live store and
  the in-flight overlay, and hands the commit to a pool of
  ``pipeline_depth`` commit threads (a plan that preempts waits for the
  pool to drain and commits inline).  The commit goes through the log
  (``APPLY_PLAN_RESULTS``), the plan queue notes the job's apply index,
  and the preemption follow-up evals go to ``BlockedEvals``.  The
  telemetry is the reference's: ``plan.evaluate`` and ``plan.apply``
  timings, the ``plan.staleness`` sample and the ``plan.conflict``
  counter; the port adds ``plan.queue_wait``, each plan's time in the
  queue.

The columnar fit route is tried first (plan_apply.py:361): capacity,
reserved, eligibility and live usage come from the store's columnar
mirror (``state/columnar.py``) instead of each touched node's alloc
objects; nodes whose proposed allocs reserve networks, and rows the
mirror dropped, take the scalar check.  Every ``columnar_guard_every``
evaluations (0: never) the walk (and with it ``batch_allocs_fit`` at 64
touched nodes or more) runs anyway and must agree; a disagreement that a
second columnar pass does not explain is counted as a guard mismatch,
and the walk's verdicts win.  A store made with ``columnar=False`` takes
the walk.

Each plan is traced (``plan.evaluate``, ``plan.conflict``, ``plan.apply``
spans under its eval) and, with the event stream armed, summarized as one
``Plan``/``PlanApplied`` event after its commit (plan_apply.py:705-726).

Left out: the ``plan.apply`` fault's ``delay`` action, and allocs'
``create_time`` (the port's Allocation has no such field).
"""
from __future__ import annotations

import logging
import queue as _queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import fault
from ..device import resolve_device
from ..ops import resident
from ..ops.kernels import batch_allocs_fit
from ..state import columnar
from ..structs import structs as s
from ..structs.funcs import allocs_fit, remove_allocs
from ..utils import tracing
from ..utils.telemetry import NULL_TELEMETRY
from .fsm import MessageType
from .plan_queue import PlanFuture, PlanQueue

# At or above this many touched nodes the vectorized fit re-check is used.
VECTORIZE_THRESHOLD = 64

# Concurrent in-flight plan commits of the server's applier (the
# reference's NOMAD_TPU_PLAN_PIPELINE default; 1 is strictly serial).
PIPELINE_DEPTH = 8


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
    """Re-checks and commits plans.

    ``PlanApplier(state, device=..., next_index=...)`` commits into
    ``state`` (a ``StateStore``) at ``next_index()`` (default: the
    store's latest index plus one; a ``Harness`` passes its own).
    ``PlanApplier(plan_queue, raft, logger, metrics, blocked_evals)``
    commits through ``raft`` and re-checks against its FSM's store.
    ``device`` is where the vectorized re-check runs.
    ``columnar_guard_every`` is the cadence of the columnar route's guard
    (the reference's ``NOMAD_TPU_COLUMNAR_GUARD_EVERY``).  ``stats`` sums,
    since the last :meth:`reset_stats`, the plans seen, the seconds of
    evaluate and apply, the touched nodes, the plans per route
    (``columnar``, ``vectorized``, ``scalar``; a guard's walk counts
    under its own route too), the columnar guard's runs
    (``columnar_guards``), the nodes the columnar and vectorized routes
    left to the scalar check (``scalar_fallback``), partial commits, and
    the devices ``batch_allocs_fit`` ran on."""

    def __init__(self, source, raft=None,
                 logger: Optional[logging.Logger] = None, metrics=None,
                 blocked_evals=None, device=None,
                 next_index: Optional[Callable[[], int]] = None,
                 columnar_guard_every: int = columnar.GUARD_EVERY):
        if isinstance(source, PlanQueue):
            if raft is None:
                raise ValueError("the plan-queue form needs the raft log")
            self.plan_queue: Optional[PlanQueue] = source
            self.raft = raft
            self._state = None
        else:
            if raft is not None or blocked_evals is not None:
                raise ValueError("a store-backed applier commits into its "
                                 "store; pass a PlanQueue for the log")
            self.plan_queue = None
            self.raft = None
            self._state = source
        self.device = resolve_device(device)
        self._next_index = (next_index if next_index is not None
                            else lambda: self.state.latest_index() + 1)
        self.logger = logger or logging.getLogger(
            "nomad_tpu_torch.server.plan_apply")
        self.metrics = metrics if metrics is not None else NULL_TELEMETRY
        # Preempted jobs' follow-up evals are handed here after a
        # preemption plan commits, so displaced work reschedules.
        self.blocked_evals = blocked_evals
        self._overlay = _InflightOverlay()
        self.columnar_guard_every = columnar_guard_every
        self._fit_guard_reads = 0
        self._stats_l = threading.Lock()
        self.reset_stats()
        # The server form's threads: the hot loop and a bounded pool of
        # commit waiters, with the count of commits in flight.
        self.pipeline_depth = PIPELINE_DEPTH
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._commit_q: "_queue.Queue" = _queue.Queue()
        self._commit_threads: List[threading.Thread] = []
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        self._token_seq = 0

    @property
    def state(self):
        """The store the re-check reads and, in the store form, the
        commit writes (the log's FSM store in the server form)."""
        return self._state if self.raft is None else self.raft.fsm.state

    def reset_stats(self) -> None:
        with self._stats_l:
            self.stats = {"plans": 0, "evaluate_seconds": 0.0,
                          "apply_seconds": 0.0, "touched_nodes": 0,
                          "columnar": 0, "columnar_guards": 0,
                          "vectorized": 0, "scalar": 0,
                          "scalar_fallback": 0, "partial": 0,
                          "fit_devices": set()}

    def _count(self, key: str, value=1) -> None:
        with self._stats_l:
            if key == "fit_devices":
                self.stats[key].add(value)
            else:
                self.stats[key] += value

    # -- the server form: lifecycle ---------------------------------------

    def start(self) -> None:
        if self.plan_queue is None:
            raise RuntimeError("start() needs the plan-queue form")
        self._stop.clear()
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name="plan-applier")
        self._thread.start()
        for i in range(self.pipeline_depth):
            t = threading.Thread(target=self._commit_loop, daemon=True,
                                 name=f"plan-commit-{i}")
            t.start()
            self._commit_threads.append(t)

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the loop and the commit pool, each join bounded by
        ``timeout``."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        for _ in self._commit_threads:
            self._commit_q.put(None)
        for t in self._commit_threads:
            t.join(timeout=timeout)
        self._commit_threads = []

    def threads(self) -> List[threading.Thread]:
        """The live loop and commit threads (empty once stopped)."""
        out = [] if self._thread is None else [self._thread]
        return out + list(self._commit_threads)

    def run(self) -> None:
        """The planApply hot loop (plan_apply.go:42-120).  The fit
        re-check reads the live store plus the in-flight overlay: every
        alloc an earlier plan added is either applied (visible in the
        store: overlay entries are removed only after their log apply
        returns) or still in the overlay.  Commit waits run on the pool,
        so the evaluation of plan N+1 overlaps the commit of plan N."""
        while not self._stop.is_set():
            item = self.plan_queue.dequeue(timeout=0.2)
            if item is None:
                continue
            plan, future = item
            # The port's addition: how long the plan waited in the queue.
            self.metrics.add_sample(
                "plan.queue_wait",
                (time.perf_counter() - future.enqueued_at) * 1000.0)
            if not future.claim():
                # The submitter gave up before we started: skipping here
                # is what makes its replan safe.
                self.logger.warning("plan for eval %s was cancelled before "
                                    "apply; dropping", plan.eval_id)
                continue
            if plan.node_preemptions:
                # The preemption fence reads live alloc rows
                # (modify_index equality) that an in-flight plan could
                # still change: such plans run strictly serial against a
                # drained pipeline.
                self._drain_inflight()
                self._process_plan(plan, future, pipelined=False)
            else:
                self._process_plan(plan, future, pipelined=True)

    def _process_plan(self, plan: s.Plan, future: PlanFuture,
                      pipelined: bool) -> None:
        snap = self.state
        # Branch before building span attrs: disarmed, a plan pays one
        # load and a comparison.
        tr = tracing.TRACER
        try:
            ev_span = tracing.NOOP if tr is None else tr.span(
                "plan.evaluate", eval_id=plan.eval_id)
            with self.metrics.measure("plan.evaluate"), ev_span:
                result = self._timed_evaluate(snap, plan)
        except Exception as exc:
            self.logger.exception("plan evaluation failed")
            future.respond(None, exc)
            return

        # Staleness and conflict telemetry: how far behind the log this
        # plan's snapshot was, and whether the re-check rejected part of
        # it (the submitter replans the rest on refreshed state).
        if plan.snapshot_index:
            self.metrics.add_sample(
                "plan.staleness",
                max(0, self.raft.applied_index() - plan.snapshot_index))
        if result.refresh_index:
            self.metrics.incr_counter("plan.conflict")
            if tr is not None:
                tr.event("plan.conflict", eval_id=plan.eval_id,
                         snapshot_index=plan.snapshot_index,
                         refresh_index=result.refresh_index)

        if not (result.node_update or result.node_allocation
                or result.alloc_slabs):
            future.respond(result, None)
            return
        if not pipelined or self.pipeline_depth <= 1 \
                or not self._commit_threads:
            self._commit(plan, result, future, snap)
            return
        # Hand the commit to the pool: the overlay entry makes the
        # not-yet-visible placements count against every later re-check
        # until the log apply lands.
        with self._inflight_cv:
            while self._inflight >= self.pipeline_depth \
                    and not self._stop.is_set():
                self._inflight_cv.wait(0.2)
            self._inflight += 1
            self._token_seq += 1
            token = self._token_seq
        self._overlay.add(token, result)
        self._commit_q.put((token, plan, result, future, snap))

    def _commit(self, plan, result, future, snap,
                token: Optional[int] = None) -> None:
        tr = tracing.TRACER
        try:
            ap_span = tracing.NOOP if tr is None else tr.span(
                "plan.apply", eval_id=plan.eval_id)
            with self.metrics.measure("plan.apply"), ap_span:
                index = self._timed_apply(plan, result, snap)
            result.alloc_index = index
            if result.refresh_index:
                # A partial commit: the scheduler must see at least its
                # own placements (plan_apply.go:187-193).
                result.refresh_index = max(result.refresh_index, index)
        except Exception as exc:
            self.logger.exception("failed to apply plan")
            future.respond(None, exc)
            return
        finally:
            if token is not None:
                # Removed only now: the apply is visible in the live
                # store (or failed and never will be).
                self._overlay.remove(token)
        future.respond(result, None)

    def _commit_loop(self) -> None:
        while True:
            item = self._commit_q.get()
            if item is None:
                return
            token, plan, result, future, snap = item
            try:
                self._commit(plan, result, future, snap, token=token)
            finally:
                with self._inflight_cv:
                    self._inflight -= 1
                    self._inflight_cv.notify_all()

    def _drain_inflight(self) -> None:
        with self._inflight_cv:
            while self._inflight and not self._stop.is_set():
                self._inflight_cv.wait(0.2)

    def _timed_evaluate(self, snap, plan: s.Plan) -> s.PlanResult:
        t0 = time.perf_counter()
        result = self.evaluate_plan(snap, plan)
        self._count("plans")
        self._count("evaluate_seconds", time.perf_counter() - t0)
        if result.refresh_index:
            self._count("partial")
        return result

    def _timed_apply(self, plan: s.Plan, result: s.PlanResult,
                     snap) -> int:
        t0 = time.perf_counter()
        index = self.apply_plan(plan, result, snap)
        self._count("apply_seconds", time.perf_counter() - t0)
        return index

    # -- the store form: the planner interface -----------------------------

    def submit_plan(self, plan: s.Plan
                    ) -> Tuple[s.PlanResult, Optional[object]]:
        """Evaluate ``plan`` and commit what is left (plan_apply.py:174
        ``_process_plan``, :227 ``_commit``), inline.  As in the
        reference, the re-check reads the live store: the applier is its
        only plan writer.  Returns the result and, when it has a
        ``refresh_index`` (a partial commit), a fresh snapshot for the
        scheduler to retry on; None otherwise."""
        snap = self.state
        result = self._timed_evaluate(snap, plan)
        if result.node_update or result.node_allocation \
                or result.alloc_slabs:
            index = self._timed_apply(plan, result, snap)
            result.alloc_index = index
            if result.refresh_index:
                result.refresh_index = max(result.refresh_index, index)
        if result.refresh_index:
            return result, self.state.snapshot()
        return result, None

    def update_eval(self, ev: s.Evaluation) -> None:
        """Eval writes belong to the server (its worker's planner); the
        ``Harness`` records them."""

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
        self._count("touched_nodes", len(node_ids))

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
        out = self._evaluate_nodes_columnar(snap, plan, node_ids, slab_adds,
                                            overlay)
        if out is not None:
            self._count("columnar")
            return out
        return self._evaluate_nodes_walk(snap, plan, node_ids, slab_adds,
                                         overlay)

    def _evaluate_nodes_columnar(self, snap, plan: s.Plan,
                                 node_ids: List[str], slab_adds: Dict,
                                 overlay_map: Dict[str, list],
                                 guard: bool = True
                                 ) -> Optional[Dict[str, bool]]:
        """The fit re-check off the store's columnar mirror
        (plan_apply.py:361): capacity, reserved, eligibility and live
        usage are int64 rows of the mirror, and the plan's own removals
        and adds and the in-flight overlay are added on the host.  A node
        whose proposed allocs reserve networks, or whose row the mirror
        does not have, takes the scalar check.  None when the store has
        no mirror (the caller walks).  Every ``columnar_guard_every``
        calls the walk runs anyway and must agree (see the module
        docstring)."""
        columns_fn = getattr(snap, "columns", None)
        if columns_fn is None:
            return None
        cols = columns_fn()
        if cols is None:
            return None
        usage = snap.column_usage(cols)

        def combined(alloc: s.Allocation) -> np.ndarray:
            return np.array(s.alloc_usage_vec(alloc), dtype=np.int64)

        def has_ports(alloc: s.Allocation) -> bool:
            if alloc.resources is not None and alloc.resources.networks:
                return True
            return any(tr.networks for tr in alloc.task_resources.values())

        def proto_ports(pairs) -> bool:
            return any(p.resources is not None and p.resources.networks
                       for p, _ in pairs)

        out: Dict[str, bool] = {}
        n_scalar = 0
        for node_id in node_ids:
            if not self._preemptions_fresh(snap, plan, node_id):
                out[node_id] = False
                continue
            adds = plan.node_allocation.get(node_id, [])
            slab_here = slab_adds.get(node_id, [])
            overlay = overlay_map.get(node_id, ())
            if not adds and not slab_here:
                out[node_id] = True  # evict-only always fits
                continue
            row = cols.row_of.get(node_id)
            if (row is None or row >= cols.n
                    or any(has_ports(a) for a in adds)
                    or proto_ports(slab_here) or proto_ports(overlay)):
                # Port accounting, or a row the mirror does not have:
                # the scalar check for this node only.
                n_scalar += 1
                out[node_id] = self._evaluate_node_plan(
                    snap, plan, node_id, slab_adds, overlay=overlay_map)
                continue
            if not cols.eligible[row]:
                out[node_id] = False
                continue
            need = cols.res[row] + usage[row]
            for removal in (list(plan.node_update.get(node_id, ()))
                            + list(plan.node_preemptions.get(node_id, ()))):
                live = snap.alloc_by_id(None, removal.id)
                if (live is not None and not live.terminal_status()
                        and live.node_id == node_id):
                    need = need - combined(live)
            for alloc in adds:
                need = need + combined(alloc)
            for proto, cnt in slab_here:
                need = need + cnt * _res_vec(proto.resources)
            for proto, cnt in overlay:
                need = need + cnt * _res_vec(proto.resources)
            out[node_id] = bool(np.all(need <= cols.cap[row]))
        if guard:
            self._count("scalar_fallback", n_scalar)

        every = self.columnar_guard_every
        if guard and every > 0:
            with self._stats_l:
                self._fit_guard_reads += 1
                due = self._fit_guard_reads % every == 0
            if due:
                self._count("columnar_guards")
                ref = self._evaluate_nodes_walk(snap, plan, node_ids,
                                                slab_adds, overlay_map)
                if ref != out:
                    # Both passes read the live store: a write between
                    # them (a pipelined commit, a client update) gives a
                    # benign difference that a second columnar pass,
                    # against the walk's newer view, does not repeat; a
                    # fault of the mirror does.
                    out2 = self._evaluate_nodes_columnar(
                        snap, plan, node_ids, slab_adds, overlay_map,
                        guard=False)
                    if out2 == ref:
                        return ref
                    bad = [nid for nid in node_ids
                           if ref.get(nid) != out.get(nid)]
                    columnar.note_guard_mismatch(
                        "plan_fit", f"{len(bad)} node verdicts",
                        Nodes=len(bad))
                    self.logger.error(
                        "columnar plan-fit guard mismatch on %d nodes "
                        "(first: %s); using the walk's verdicts",
                        len(bad), bad[:3])
                    return ref
        return out

    def _evaluate_nodes_walk(self, snap, plan: s.Plan,
                             node_ids: List[str], slab_adds: Dict,
                             overlay: Dict[str, list]) -> Dict[str, bool]:
        if len(node_ids) >= VECTORIZE_THRESHOLD:
            self._count("vectorized")
            return self._evaluate_nodes_vectorized(snap, plan, node_ids,
                                                   slab_adds, overlay)
        self._count("scalar")
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

        self._count("scalar_fallback", len(scalar_fallback))
        fit_t, _ = batch_allocs_fit(
            torch.as_tensor(capacity, dtype=torch.int32, device=self.device),
            torch.as_tensor(used, dtype=torch.int32, device=self.device))
        self._count("fit_devices", str(fit_t.device))
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
        """Commit ``result`` (plan_apply.go:123-175 applyPlan) and return
        its index: through the log in the server form, into the store at
        the next index otherwise.  Fault point ``plan.apply`` (``error``,
        ``crash``, ``step_down``, ``delay``) fires before anything is
        written: an injected failure commits nothing."""
        act = fault.faultpoint("plan.apply", eval_id=plan.eval_id)
        if act is not None:
            if act.kind == "delay":
                time.sleep(act.delay)
            elif act.kind in ("error", "crash", "step_down"):
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
        now = time.time()
        for alloc in allocs:
            if alloc.create_time == 0:
                alloc.create_time = now
        for slab in result.alloc_slabs:
            if slab.proto.create_time == 0:
                slab.proto.create_time = now
        preemption_evals: List[s.Evaluation] = []
        if preempted:
            # The evictions, the placements and the evicted jobs'
            # follow-up evals commit together.
            preemption_evals = s.preemption_follow_up_evals(
                preempted, snap.latest_index(),
                job_lookup=lambda jid: snap.job_by_id(None, jid))

        if self.raft is None:
            index = self._next_index()
            self.state.upsert_plan_results(index, plan.job, allocs,
                                           result.alloc_slabs or None,
                                           eval_id=plan.eval_id)
            if preemption_evals:
                self.state.upsert_evals(index, preemption_evals)
        else:
            # The driving eval rides the payload for the event stream: a
            # stop or eviction keeps its placement eval on the alloc row.
            payload = {"job": plan.job, "allocs": allocs,
                       "eval_id": plan.eval_id}
            if result.alloc_slabs:
                payload["slabs"] = result.alloc_slabs
            if preemption_evals:
                payload["preemption_evals"] = preemption_evals
            _, index = self.raft.apply(MessageType.APPLY_PLAN_RESULTS,
                                       payload)
            # The worker's snapshot fence: no snapshot below this index
            # may schedule this job again.
            self.plan_queue.note_applied(
                plan.job.id if plan.job is not None else "", index)
        resident.note_plan_applied(index)
        eb = self.state.event_broker
        if eb is not None:
            # One plan-level summary on top of the store's per-alloc and
            # per-slab events.  It is published after the log apply
            # returned, outside its serialization, so a concurrent apply
            # may already have published a higher index: clamp keeps the
            # stream monotone, and PlanIndex keeps the true index.
            placed = (sum(len(v) for v in result.node_allocation.values())
                      + sum(len(sl.ids) for sl in result.alloc_slabs))
            eb.publish_one(
                s.TOPIC_PLAN, "PlanApplied", plan.eval_id, index,
                {"Placed": placed,
                 "Updated": sum(len(v) for v in result.node_update.values()),
                 "Preempted": len(preempted),
                 "Partial": bool(result.refresh_index),
                 "PlanIndex": index},
                eval_id=plan.eval_id, clamp=True)
        if preemption_evals:
            for ev in preemption_evals:
                ev.snapshot_index = index
            if self.blocked_evals is not None:
                self.blocked_evals.block_preempted(preemption_evals)
        return index
