"""Scheduling workers (a copy of ``nomad_tpu/server/worker.py``; reference
nomad/worker.go:55-538).

Worker        — per-eval loop (worker.py:209-262): a greedy dequeue of
                up to ``GREEDY_BATCH`` ready evals with their nack
                deadlines paused, then for each: wait for the log →
                snapshot → scheduler.process → ack/nack; implements the
                scheduler's Planner interface by submitting to the plan
                queue and writing evals through the log.  The follower
                workers (``server/follower_sched.py``) run this loop.
BatchWorker   — drains the broker into batches of up to ``max_batch``
                service and batch evals and runs one
                ``TorchBatchScheduler`` per batch over a fresh snapshot
                (serially, or in the reference's pipelined order); system
                evals go through ``torch-system`` and core (GC) evals
                through ``CoreScheduler`` one at a time.

The reference reads the stale-snapshot and pipeline switches from its
environment (worker.py:36, :471); here they are constructor arguments
(``stale_snapshot``, ``pipeline``), and the server's config carries them.
A core eval needs a snapshot that covers the applied index
(worker.py:370-374), so a GC sweep sees every terminal row; the follower
workers do not take core evals.
Both drains are traced as the reference's are: ``worker.process_batch``
(a retroactive span in the pipelined drain, whose phases interleave
batches on one thread), ``worker.wait_for_index``, one ``worker.attempt``
marker a delivery, and ``worker.submit_plan`` around each plan's queue
wait; the per-eval path has its ``worker.attempt`` and
``worker.invoke_scheduler`` spans.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional, Tuple

from ..scheduler.scheduler import new_scheduler
from ..structs import structs as s
from ..utils import tracing
from ..utils.backoff import Backoff, wait_until
from ..utils.telemetry import NULL_TELEMETRY
from .eval_broker import EvalBroker, EvalBrokerError
from .fsm import MessageType
from .plan_queue import PlanQueue
from .raft import RaftLog

# How long one dequeue waits, and how long to wait for the log to catch
# up to an eval's index (worker.go:229 waitForIndex).
DEQUEUE_TIMEOUT = 0.5
RAFT_SYNC_LIMIT = 5.0

# How many log entries a reused snapshot may lag the applied index (the
# reference's NOMAD_TPU_STALE_SNAPSHOT_LAG default).
STALE_SNAPSHOT_MAX_LAG = 512


class WorkerPlanner:
    """The scheduler.Planner a worker hands its scheduler
    (worker.go:300-499)."""

    def __init__(self, worker: "Worker", ev: s.Evaluation, token: str,
                 snapshot_index: Optional[int] = None):
        self.worker = worker
        self.eval = ev
        self.token = token
        # The applied index when the scheduler's snapshot was taken
        # (worker.go:262): blocked evals carry it, so a capacity change
        # landing while the eval is in the scheduler is not mistaken for
        # one already seen by BlockedEvals._missed_unblock.
        self.snapshot_index = snapshot_index

    def submit_plan(self, plan: s.Plan):
        """(worker.go:300 SubmitPlan): pause the nack timer while in the
        plan queue, attach the eval token for fencing."""
        w = self.worker
        plan.eval_token = self.token
        if self.snapshot_index is not None:
            plan.snapshot_index = self.snapshot_index
        try:
            w.broker.pause_nack_timeout(self.eval.id, self.token)
        except EvalBrokerError:
            pass
        try:
            tr = tracing.TRACER
            submit_span = tracing.NOOP if tr is None else tr.span(
                "worker.submit_plan", eval_id=self.eval.id)
            with submit_span:
                future = w.plan_queue.enqueue(plan)
                result = future.wait()
        finally:
            try:
                w.broker.resume_nack_timeout(self.eval.id, self.token)
            except EvalBrokerError:
                pass

        state = None
        if result is not None and result.refresh_index:
            # Wait for our state to catch up, then hand a refreshed
            # snapshot to the scheduler (worker.go:335-350); it replaces
            # the worker's stale-snapshot cache.
            w.wait_for_index(result.refresh_index, RAFT_SYNC_LIMIT)
            idx = w.raft.applied_index()
            state = w.raft.fsm.state.snapshot()
            if w.stale_snapshot:
                w._snap_cache = (idx, state)
            self.snapshot_index = idx
        return result, state

    def update_eval(self, ev: s.Evaluation) -> None:
        self.worker.apply_eval_updates([ev])

    def _snapshot_index(self) -> int:
        if self.snapshot_index is not None:
            return self.snapshot_index
        return self.worker.raft.applied_index()

    def create_eval(self, ev: s.Evaluation) -> None:
        ev.snapshot_index = self._snapshot_index()
        self.worker.apply_eval_updates([ev])

    def reblock_eval(self, ev: s.Evaluation) -> None:
        """(worker.go:470 ReblockEval): update the snapshot index and hand
        the eval to the blocked tracker through the broker's requeue."""
        ev.snapshot_index = self._snapshot_index()
        self.worker.reblock_eval_update(ev, self.token)


class Worker:
    """One scheduling worker (count = num_schedulers, config.go:250): the
    per-eval loop over ``schedulers`` (the CPU schedulers of each eval's
    type, and ``CoreScheduler`` for core evals over ``time_table``'s GC
    thresholds) and the planner plumbing the batch worker builds on."""

    def __init__(
        self,
        broker: EvalBroker,
        plan_queue: PlanQueue,
        raft: RaftLog,
        blocked_evals=None,
        logger: Optional[logging.Logger] = None,
        metrics=None,
        stale_snapshot: bool = True,
        scheduler_kwargs: Optional[dict] = None,
        schedulers: Optional[List[str]] = None,
        time_table=None,
    ):
        self.broker = broker
        self.schedulers = list(schedulers or [
            s.JOB_TYPE_SERVICE, s.JOB_TYPE_BATCH, s.JOB_TYPE_SYSTEM,
            s.JOB_TYPE_CORE])
        self.time_table = time_table
        self.plan_queue = plan_queue
        self.raft = raft
        self.metrics = metrics if metrics is not None else NULL_TELEMETRY
        self.blocked_evals = blocked_evals
        self.logger = logger or logging.getLogger("nomad_tpu_torch.worker")
        # Extra arguments for the schedulers this worker builds.
        self.scheduler_kwargs = dict(scheduler_kwargs or {})
        self._stop = threading.Event()
        self._paused = False
        self._parked = threading.Event()
        self._pause_cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        # Jittered idle backoff for a disabled broker.
        self._idle_backoff = Backoff(base=0.02, max_delay=0.5)
        # Stale-snapshot cache: (applied index at snapshot time, the
        # snapshot), reused across evals while it covers the eval's
        # trigger indexes and lags the log by at most
        # STALE_SNAPSHOT_MAX_LAG; the plan applier's re-check owns
        # correctness.  Per worker.
        self.stale_snapshot = stale_snapshot
        self._snap_cache: Optional[Tuple[int, object]] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name="worker")
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the loop; the join is bounded by ``timeout``."""
        self._stop.set()
        self.set_pause(False)
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def set_pause(self, paused: bool) -> None:
        """The leader pauses workers (leader.go:114-120).  A worker in
        the middle of a batch finishes it first; :meth:`wait_parked`
        waits for that."""
        with self._pause_cond:
            self._paused = paused
            if not paused:
                self._parked.clear()
            self._pause_cond.notify_all()

    def wait_parked(self, timeout: float) -> bool:
        """True once a paused worker is parked at its loop's head (no
        batch in hand, none being dequeued), within ``timeout``."""
        return self._parked.wait(timeout)

    def _check_paused(self) -> None:
        with self._pause_cond:
            while self._paused and not self._stop.is_set():
                self._parked.set()
                self._pause_cond.wait(0.5)
            self._parked.clear()

    # How many ready evals one dequeue takes (worker.py:207).  Each is
    # still scheduled and acked on its own, but the first one's fresh
    # snapshot covers its batch-mates' trigger indexes (all written before
    # the dequeue), so under a backlog the stale-snapshot cache serves
    # them all.
    GREEDY_BATCH = 8

    def run(self) -> None:
        while not self._stop.is_set():
            self._check_paused()
            for ev, token in self._dequeue_batch():
                if self._stop.is_set():
                    # Shutting down mid-batch: the undone evals go back
                    # for redelivery.
                    try:
                        self.broker.nack(ev.id, token)
                    except EvalBrokerError:
                        pass
                    continue
                # The nack deadline guards processing, not the wait in
                # this worker's hand: resume it as this eval's turn
                # starts.  A failed resume means the delivery already
                # burned (the broker flushed on a leadership loss): skip.
                try:
                    self.broker.resume_nack_timeout(ev.id, token)
                except EvalBrokerError:
                    continue
                self.process_eval(ev, token)

    def _dequeue_batch(self) -> List[Tuple[s.Evaluation, str]]:
        try:
            batch = self.broker.dequeue_batch(
                self.schedulers, self.GREEDY_BATCH, DEQUEUE_TIMEOUT)
        except EvalBrokerError:
            time.sleep(self._idle_backoff.next_delay())
            return []
        self._idle_backoff.reset()
        # Pause every batch-mate's nack deadline: it must cover one eval's
        # processing, not its wait behind its predecessors (an expiry
        # mid-batch would redeliver an eval this worker will still
        # schedule: a same-job double placement).
        for ev, token in batch:
            try:
                self.broker.pause_nack_timeout(ev.id, token)
            except EvalBrokerError:
                pass
        return batch

    def process_eval(self, ev: s.Evaluation, token: str) -> None:
        """Dequeue→schedule→ack cycle (worker.go:106-227).  The unsuffixed
        ``worker.invoke_scheduler`` sample belongs to the batch
        scheduler's batches; one eval here is sampled by its type."""
        # Branch on the tracer before building attrs: delivery_attempts
        # takes the broker lock, which the disarmed path must not pay.
        tr = tracing.TRACER
        attempt_span = tracing.NOOP if tr is None else tr.span(
            "worker.attempt", eval_id=ev.id, eval_type=ev.type,
            attempt=self.broker.delivery_attempts(ev.id))
        with attempt_span as sp:
            try:
                with self.metrics.measure("worker.wait_for_index"), \
                        tracing.span("worker.wait_for_index"):
                    self.wait_for_index(ev.modify_index, RAFT_SYNC_LIMIT)
                with self.metrics.measure(
                        f"worker.invoke_scheduler.{ev.type}"), \
                        tracing.span("worker.invoke_scheduler"):
                    self.invoke_scheduler(ev, token)
                self.broker.ack(ev.id, token)
            except Exception as exc:
                self.logger.exception("eval %s failed; nacking", ev.id)
                sp.set(nack_reason=f"{type(exc).__name__}: {exc}")
                self.record_eval_failure(ev, exc)
                try:
                    self.broker.nack(ev.id, token)
                except EvalBrokerError:
                    pass

    def record_eval_failure(self, ev: s.Evaluation, exc: Exception) -> None:
        self.record_eval_failures([ev], exc)

    def record_eval_failures(self, evs: List[s.Evaluation],
                             exc: Exception) -> None:
        """Write why these delivery attempts burned onto the evals, in one
        log apply, before the nacks (while an eval is outstanding the
        broker's enqueue dedup ignores the write's enqueue hook)."""
        failed = []
        for ev in evs:
            attempt = self.broker.delivery_attempts(ev.id)
            f = ev.copy()
            f.status_description = (
                f"scheduler error on delivery attempt {attempt}: "
                f"{type(exc).__name__}: {exc}")
            failed.append(f)
        try:
            self.apply_eval_updates(failed)
        except Exception:
            # Recording forensics must never mask the nack itself.
            self.logger.debug("could not record failure reason for %d "
                              "evals", len(failed), exc_info=True)

    # -- writes ------------------------------------------------------------

    def apply_eval_updates(self, evals: List[s.Evaluation]) -> None:
        self.raft.apply(MessageType.EVAL_UPDATE, {"evals": evals})

    def reblock_eval_update(self, ev: s.Evaluation, token: str) -> None:
        self.apply_eval_updates([ev])
        if self.blocked_evals is not None:
            self.blocked_evals.reblock(ev, token)

    def wait_for_index(self, index: int, timeout: float) -> bool:
        """Wait for the log to catch up (worker.go:229): backed-off
        polling of the relaxed applied index."""
        return wait_until(
            lambda: self.raft.applied_index_relaxed() >= index,
            timeout, initial=0.0005, max_interval=0.005)

    def sched_name(self, ev: s.Evaluation) -> str:
        """The scheduler-registry name for an eval."""
        return ev.type

    def _required_index(self, ev: s.Evaluation) -> int:
        """The lowest applied index a snapshot must cover to schedule
        ``ev``: its trigger indexes (job write, node transition, the
        unblock index or last attempt) and the job's newest committed
        plan (plan_queue.applied_index_for), since an eval created
        before the job's previous plan applied can be dequeued after
        it.  A core eval needs the applied index itself: a GC sweep off
        a cached snapshot would not see the newest terminal rows."""
        if ev.type == s.JOB_TYPE_CORE:
            return self.raft.applied_index()
        return max(ev.trigger_index(),
                   self.plan_queue.applied_index_for(ev.job_id))

    def _snapshot_covering(self, required: int) -> Tuple[int, object]:
        """(index, snapshot) with index >= required.  With stale
        snapshots on, the cached one is reused while it covers
        ``required`` and lags the log by at most the bound.  The index is
        read before the snapshot is taken, so it never overstates what
        the scheduler saw."""
        if self.stale_snapshot:
            cached = self._snap_cache
            if cached is not None and cached[0] >= required \
                    and self.raft.applied_index_relaxed() - cached[0] \
                    <= STALE_SNAPSHOT_MAX_LAG:
                self.metrics.incr_counter("worker.snapshot_reuse")
                return cached
        snapshot_index = self.raft.applied_index()
        snap = self.raft.fsm.state.snapshot()
        if self.stale_snapshot:
            self._snap_cache = (snapshot_index, snap)
            self.metrics.incr_counter("worker.snapshot_fresh")
        return snapshot_index, snap

    def invoke_scheduler(self, ev: s.Evaluation, token: str) -> None:
        """(worker.go:262): snapshot the state, build the scheduler by the
        eval's type."""
        required = self._required_index(ev)
        if not self.wait_for_index(required, RAFT_SYNC_LIMIT):
            raise RuntimeError(
                f"state did not reach fence {required} within "
                f"{RAFT_SYNC_LIMIT}s for eval {ev.id}")
        snapshot_index, snap = self._snapshot_covering(required)
        planner = WorkerPlanner(self, ev, token,
                                snapshot_index=snapshot_index)
        if ev.type == s.JOB_TYPE_CORE:
            from .core_sched import CoreScheduler

            CoreScheduler(self.logger, snap, planner, self.raft,
                          time_table=self.time_table).process(ev)
            return
        sched = new_scheduler(self.sched_name(ev), self.logger, snap,
                              planner)
        sched.process(ev)


class _MuxPlanner:
    """Routes planner calls to the owning eval's WorkerPlanner."""

    def __init__(self, worker: "Worker", batch, snapshot_index: int):
        self.planners = {
            ev.id: WorkerPlanner(worker, ev, token,
                                 snapshot_index=snapshot_index)
            for ev, token in batch}

    def submit_plan(self, plan):
        return self.planners[plan.eval_id].submit_plan(plan)

    def update_eval(self, ev):
        p = self.planners.get(ev.id) or next(iter(self.planners.values()))
        p.update_eval(ev)

    def create_eval(self, ev):
        p = (self.planners.get(ev.previous_eval)
             or next(iter(self.planners.values())))
        p.create_eval(ev)

    def reblock_eval(self, ev):
        p = self.planners.get(ev.id) or next(iter(self.planners.values()))
        p.reblock_eval(ev)


class _BatchCtx:
    """One in-flight batch of the pipelined drain: broker tokens, the
    scheduler and its prepared batch, and when its processing began."""

    __slots__ = ("batch", "sched", "prep", "attempts", "t0")

    def __init__(self, batch, sched, prep, attempts, t0):
        self.batch = batch
        self.sched = sched
        self.prep = prep
        self.attempts = attempts
        self.t0 = t0


class BatchWorker(Worker):
    """Drains evals in batches into the port's batch scheduler.

    Service and batch evals are batched; system evals run through the
    vectorized ``torch-system`` pass.  ``scheduler_kwargs`` go to every
    ``TorchBatchScheduler`` (``device`` or ``mesh``, ``rng_seed``,
    ``preemption_enabled``, ``breaker``, ``columnar_guard_every``);
    ``pipeline`` turns on the double-buffered drain (the reference's
    ``NOMAD_TPU_PIPELINE``, default off)."""

    def __init__(self, *args, max_batch: int = 64, pipeline: bool = False,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.max_batch = max_batch
        self.pipeline = pipeline
        self.batch_schedulers = [s.JOB_TYPE_SERVICE, s.JOB_TYPE_BATCH]

    def sched_name(self, ev: s.Evaluation) -> str:
        if ev.type == s.JOB_TYPE_SYSTEM:
            return "torch-system"
        return super().sched_name(ev)

    def run(self) -> None:
        while not self._stop.is_set():
            self._check_paused()
            try:
                batch = self.broker.dequeue_batch(
                    self.batch_schedulers, self.max_batch, DEQUEUE_TIMEOUT)
            except EvalBrokerError:
                time.sleep(self._idle_backoff.next_delay())
                continue
            self._idle_backoff.reset()
            if batch:
                if self.pipeline:
                    # Latency samples are taken at each batch's finish.
                    self._process_batches_pipelined(batch)
                else:
                    with self.metrics.measure(
                            "worker.invoke_scheduler.batch"):
                        self.process_batch(batch)
            # Always also poll system and core evals (zero timeout), so
            # a sustained service/batch stream cannot starve them.
            self._poll_system_core()

    def _poll_system_core(self) -> None:
        try:
            ev, token = self.broker.dequeue(
                [s.JOB_TYPE_SYSTEM, s.JOB_TYPE_CORE], 0)
        except EvalBrokerError:
            return
        if ev is not None:
            self.process_eval(ev, token)

    def _new_batch_scheduler(self, snap, mux):
        from ..ops.batch_sched import TorchBatchScheduler

        return TorchBatchScheduler(self.logger, snap, mux,
                                   metrics=self.metrics,
                                   **self.scheduler_kwargs)

    def process_batch(self, batch: List[Tuple[s.Evaluation, str]]):
        """One batch under a ``worker.process_batch`` span: the batch's
        BatchStats, or None when the batch was nacked."""
        tr = tracing.TRACER
        if tr is None:
            return self._process_batch(batch)
        with tr.span("worker.process_batch",
                     num_evals=len(batch),
                     **tracing.eval_id_attrs(
                         (ev for ev, _ in batch), len(batch))) as sp:
            stats = self._process_batch(batch)
            if stats is not None and stats.device_ran:
                # What the batch cost on the link, auditable per batch
                # from the span tree alone (the port's pass is always
                # fused: one result fetch).
                sp.set(fused=1, fetch_bytes=stats.fetch_bytes,
                       commit_steps=stats.commit_steps)
        return stats

    def _attempts(self, batch) -> dict:
        """Each eval's delivery number, read before scheduling: a nack
        timeout firing mid-batch would bump it for the next delivery."""
        if tracing.TRACER is None:
            return {}
        return {ev.id: self.broker.delivery_attempts(ev.id)
                for ev, _ in batch}

    def _process_batch(self, batch: List[Tuple[s.Evaluation, str]]):
        """The batch's BatchStats, or None when the batch was nacked."""
        max_index = max(ev.modify_index for ev, _ in batch)
        with tracing.span("worker.wait_for_index"):
            self.wait_for_index(max_index, RAFT_SYNC_LIMIT)
        # Always a fresh snapshot on the batch path: the resident usage
        # mirror advances by inter-snapshot deltas, and a reused
        # snapshot would hide the previous batch's own placements.
        snapshot_index = self.raft.applied_index()
        snap = self.raft.fsm.state.snapshot()
        # One scheduler per batch; per-eval planners for token fencing.
        mux = _MuxPlanner(self, batch, snapshot_index)
        attempts = self._attempts(batch)
        try:
            sched = self._new_batch_scheduler(snap, mux)
            stats = sched.schedule_batch([ev for ev, _ in batch])
        except Exception as exc:
            self._nack_batch(batch, attempts, exc)
            return None
        self._ack_batch(batch, attempts)
        return stats

    def _ack_batch(self, batch, attempts) -> None:
        """Ack every eval, with one ``worker.attempt`` marker a delivery
        (the batch path's twin of the per-eval worker's span)."""
        tr = tracing.TRACER
        for ev, token in batch:
            try:
                self.broker.ack(ev.id, token)
            except EvalBrokerError as exc:
                # The delivery burned anyway (a nack timeout redelivered
                # the eval mid-batch): the marker says so.
                self.logger.warning("ack of eval %s failed", ev.id,
                                    exc_info=True)
                if tr is not None:
                    tr.event("worker.attempt", eval_id=ev.id,
                             attempt=attempts.get(ev.id, 0),
                             nack_reason=f"ack failed: {exc}")
            else:
                if tr is not None:
                    tr.event("worker.attempt", eval_id=ev.id,
                             attempt=attempts.get(ev.id, 0))

    # -- pipelined drain ---------------------------------------------------
    #
    # The double-buffered twin of _process_batch on the scheduler's
    # split-phase API: while batch k is dispatched, batch k+1 is dequeued
    # and its host phases (wait for the log, snapshot, reconcile, spec
    # dedup) run; then k is completed and acked before k+1's usage is read
    # from a fresh snapshot, so the delta feed always holds k's applied
    # plans.  A failing batch nacks that batch only.  (The port's dispatch
    # runs the placement loop to its end, so the overlap is nil; the
    # order and the results are the reference's.)

    def _process_batches_pipelined(
            self, batch: List[Tuple[s.Evaluation, str]]) -> None:
        pending = self._pipeline_start(batch)
        while pending is not None and not self._stop.is_set():
            if self._paused:
                # Honour a pause mid-stream: settle the batch in flight
                # and return to run()'s pause wait.
                break
            try:
                nxt = self.broker.dequeue_batch(
                    self.batch_schedulers, self.max_batch, 0)
            except EvalBrokerError:
                nxt = None
            if not nxt:
                break
            ctx = self._pipeline_prepare(nxt)
            self._pipeline_finish(pending)
            self._poll_system_core()
            pending = (self._pipeline_dispatch(ctx)
                       if ctx is not None else None)
        if pending is not None:
            self._pipeline_finish(pending)

    def _pipeline_start(self, batch) -> Optional[_BatchCtx]:
        ctx = self._pipeline_prepare(batch)
        if ctx is None:
            return None
        return self._pipeline_dispatch(ctx)

    def _pipeline_prepare(self, batch) -> Optional[_BatchCtx]:
        t0 = tracing.now()
        attempts = self._attempts(batch)
        try:
            max_index = max(ev.modify_index for ev, _ in batch)
            self.wait_for_index(max_index, RAFT_SYNC_LIMIT)
            snapshot_index = self.raft.applied_index()
            snap = self.raft.fsm.state.snapshot()
            mux = _MuxPlanner(self, batch, snapshot_index)
            sched = self._new_batch_scheduler(snap, mux)
            prep = sched._prepare_batch([ev for ev, _ in batch])
            return _BatchCtx(batch, sched, prep, attempts, t0)
        except Exception as exc:
            self._nack_batch(batch, attempts, exc)
            return None

    def _pipeline_dispatch(self, ctx: _BatchCtx) -> Optional[_BatchCtx]:
        try:
            # A fresh snapshot for the usage: the previous batch's plans
            # are applied by now (its _pipeline_finish ran first).
            ctx.sched.state = self.raft.fsm.state.snapshot()
            ctx.sched._dispatch_prepared(ctx.prep)
            return ctx
        except Exception as exc:
            self._nack_batch(ctx.batch, ctx.attempts, exc)
            return None

    def _pipeline_finish(self, ctx: _BatchCtx) -> None:
        try:
            stats = ctx.sched._complete_prepared(ctx.prep)
        except Exception as exc:
            self._nack_batch(ctx.batch, ctx.attempts, exc)
            return
        ctx.sched._emit_batch_stats(stats)
        # This batch's wall time from its dequeue to its ack, neighbour
        # batches' host phases included.
        self.metrics.add_sample("worker.invoke_scheduler.batch",
                                (tracing.now() - ctx.t0) * 1000.0)
        tr = tracing.TRACER
        if tr is not None:
            # Retroactive: the pipelined phases interleave batches on
            # this thread, so a context-managed span would mis-stack.
            tr.record("worker.process_batch", ctx.t0, tracing.now(),
                      num_evals=len(ctx.batch), pipelined=True, fused=1,
                      fetch_bytes=stats.fetch_bytes,
                      **tracing.eval_id_attrs(
                          (ev for ev, _ in ctx.batch), len(ctx.batch)))
        self._ack_batch(ctx.batch, ctx.attempts)

    def _nack_batch(self, batch, attempts, exc: Exception) -> None:
        """A failed batch (worker.py:605-620): the reason written onto
        every eval, then every eval nacked for redelivery, each with its
        ``worker.attempt`` marker."""
        tr = tracing.TRACER
        self.logger.exception("batch scheduling failed; nacking batch")
        self.record_eval_failures([ev for ev, _ in batch], exc)
        for ev, token in batch:
            if tr is not None:
                tr.event("worker.attempt", eval_id=ev.id,
                         attempt=attempts.get(ev.id, 0),
                         nack_reason=f"{type(exc).__name__}: {exc}")
            try:
                self.broker.nack(ev.id, token)
            except EvalBrokerError:
                pass
