"""EvalBroker: leader-only priority queue of evaluations with
at-least-once delivery (a copy of ``nomad_tpu/server/eval_broker.py``;
reference nomad/eval_broker.go:43-769).

Semantics kept: per-scheduler-type ready queues, per-JobID serialization
(jobEvals + blocked), the unack map with its nack deadlines, delivery
limit → failed queue, wait/delay timers, the compounding nack re-enqueue
delay, requeue-on-ack for reblocked evals.

This is also where batching happens: :meth:`EvalBroker.dequeue_batch`
drains up to B ready evals of one scheduler type in one call, which keeps
the per-job invariant because the ready queues never hold two evals of
one job.

Admission control: per-job coalescing of deferred duplicates (the shed
eval is cancelled through the log by the server's shed reaper), a bounded
pending queue (``max_pending``; :meth:`EvalBroker.check_admission` raises
:class:`BrokerLimitError` before the eval is persisted), and a bypass
priority that is always admitted.

Each admission, coalesce, dequeue, ack and nack is traced
(``broker.enqueue``, ``broker.coalesce``, ``broker.dequeue``,
``broker.ack``, ``broker.nack``); the ack closes the eval's ``eval.e2e``
umbrella, and with the stream armed the ack and nack are published as
``Eval``/``EvalAcked`` and ``EvalNacked``.

Left out: the per-namespace quota hooks (namespace policies, the
per-tenant pending quota and its stats) with their
``broker.admission_reject`` and ``broker.quota_reject`` events, which
come with the tenancy slice (ROADMAP queue 1 item 19).  The ready
queues keep the reference's :class:`TenantQueue`, so the dequeue order
is the reference's.
"""
from __future__ import annotations

import heapq
import itertools
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..structs import structs as s
from ..tenancy.fairness import FairnessState, TenantQueue
from ..utils import tracing
from ..utils.telemetry import NULL_TELEMETRY

FAILED_QUEUE = "_failed"


class EvalBrokerError(Exception):
    pass


class BrokerLimitError(EvalBrokerError):
    """Admission NACK: the pending-eval queue is at capacity.  Carries
    ``retry_after`` (seconds) so clients back off instead of hammering."""

    def __init__(self, retry_after: float, pending: int, limit: int):
        self.retry_after = retry_after
        self.pending = pending
        self.limit = limit
        super().__init__(
            f"eval broker at capacity ({pending}/{limit} pending); "
            f"retry_after={retry_after:.2f}")


ERR_NOT_OUTSTANDING = "evaluation is not outstanding"
ERR_TOKEN_MISMATCH = "evaluation token does not match"
ERR_NACK_TIMEOUT_REACHED = "evaluation nack timeout reached"


@dataclass(order=True)
class _HeapEntry:
    # min-heap: higher priority first, then older create index, then seq.
    sort_key: Tuple[int, int, int]
    eval: s.Evaluation = field(compare=False)


class _Unack:
    """One outstanding delivery.  ``deadline`` (monotonic) replaces the
    reference's per-eval time.AfterFunc: one sweeper thread walks the
    deadlines instead of a timer thread per dequeue."""

    __slots__ = ("eval", "token", "deadline", "fired", "paused")

    def __init__(self, ev: s.Evaluation, token: str,
                 deadline: Optional[float]):
        self.eval = ev
        self.token = token
        self.deadline = deadline
        self.fired = False
        self.paused = False


class EvalBroker:
    # The owning server's event broker, attached by
    # Server.enable_event_stream.  Per server, so ack and nack events do
    # not go through the global note_external hook, which would stamp
    # them onto every armed stream.  Disarmed: one load and a branch.
    event_broker = None

    def __init__(
        self,
        nack_timeout: float = 60.0,
        initial_nack_delay: float = 1.0,
        subsequent_nack_delay: float = 20.0,
        delivery_limit: int = 3,
        metrics=None,
        max_pending: int = 0,
        coalesce: bool = True,
        bypass_priority: int = s.JOB_MAX_PRIORITY,
    ):
        self.metrics = metrics if metrics is not None else NULL_TELEMETRY
        if nack_timeout < 0:
            raise ValueError("timeout cannot be negative")
        self.nack_timeout = nack_timeout
        self.initial_nack_delay = initial_nack_delay
        self.subsequent_nack_delay = subsequent_nack_delay
        self.delivery_limit = delivery_limit
        # Admission control: 0 = unbounded.
        self.max_pending = max_pending
        self.coalesce = coalesce
        self.bypass_priority = bypass_priority

        self._l = threading.RLock()
        self._cond = threading.Condition(self._l)
        self._enabled = False
        self._seq = itertools.count()

        self.evals: Dict[str, int] = {}            # id → delivery attempts
        self.job_evals: Dict[str, str] = {}        # job id → queued eval id
        self.blocked: Dict[str, List[_HeapEntry]] = {}
        self.ready: Dict[str, TenantQueue] = {}
        self.unack: Dict[str, _Unack] = {}
        self.requeue: Dict[str, s.Evaluation] = {}  # token → eval
        self.time_wait: Dict[str, threading.Timer] = {}

        # Fairness state shared by every ready queue (one tenant until
        # namespaces are ported: the order is by priority, then arrival).
        self.fairness = FairnessState()

        # Saturation counters + the shed hand-off (evals coalesced away;
        # the server's shed reaper cancels them through the log — the
        # broker cannot apply to the log itself without inverting the
        # log-lock → broker-lock order the FSM enqueue hook takes).
        self.shed_total = 0
        self.coalesced_total = 0
        self.admission_rejects = 0
        self.nacks_total = 0
        self._shed: List[s.Evaluation] = []
        self._shed_cond = threading.Condition(self._l)
        self._sweeper: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def set_enabled(self, enabled: bool) -> None:
        sweeper = None
        with self._l:
            self._enabled = enabled
            if enabled and self.nack_timeout > 0:
                # Always spawn on enable: an is_alive() check races a
                # disable→enable flap.  The old sweeper exits when
                # superseded.
                sweeper = self._sweeper = threading.Thread(
                    target=self._sweep_nack_timeouts, daemon=True,
                    name="broker-nack-sweeper")
        if sweeper is not None:
            sweeper.start()
        if not enabled:
            self.flush()

    def sweeper(self) -> Optional[threading.Thread]:
        """The live nack sweeper thread (it exits once the broker is
        disabled), for a bounded join at shutdown."""
        return self._sweeper

    def _sweep_nack_timeouts(self) -> None:
        """The single owner of every unack deadline: scan, mark fired,
        nack outside the lock.  Granularity scales with the timeout."""
        interval = max(0.005, min(0.25, self.nack_timeout / 5.0))
        me = threading.current_thread()
        while True:
            with self._l:
                if not self._enabled or self._sweeper is not me:
                    return
                now = time.monotonic()
                due = []
                for eid, unack in self.unack.items():
                    if (not unack.paused and not unack.fired
                            and unack.deadline is not None
                            and unack.deadline <= now):
                        unack.fired = True
                        due.append((eid, unack.token))
            for eid, token in due:
                try:
                    self.nack(eid, token)
                except EvalBrokerError:
                    pass
            time.sleep(interval)

    # -- enqueue -----------------------------------------------------------

    def enqueue(self, ev: s.Evaluation) -> None:
        with self._l:
            self._process_enqueue(ev, "")

    def enqueue_all(self, evals) -> None:
        """Enqueue many evals; each may carry a token from a reblock
        (eval_broker.go:169 EnqueueAll).  ``evals`` is a list of evals
        or of (eval, token) pairs, or a dict of such pairs."""
        with self._l:
            if isinstance(evals, dict):
                items = list(evals.values())
            else:
                items = [(e, "") if not isinstance(e, tuple) else e
                         for e in evals]
            for ev, token in items:
                self._process_enqueue(ev, token)

    def _process_enqueue(self, ev: s.Evaluation, token: str) -> None:
        if ev.id in self.evals:
            if token == "":
                return
            # Reblock from the owning scheduler: requeue once acked.
            unack = self.unack.get(ev.id)
            if unack is not None and unack.token == token:
                self.requeue[token] = ev
            return
        elif self._enabled:
            self.evals[ev.id] = 0
            # The one choke point of every admission (enqueue, an
            # unblock's enqueue_all, a post-ack requeue): exactly one
            # broker.enqueue each; duplicates and a disabled broker's
            # drops record none.
            tr = tracing.TRACER
            if tr is not None:
                tr.event("broker.enqueue", eval_id=ev.id, job_id=ev.job_id,
                         eval_type=ev.type, priority=ev.priority)
            self.metrics.incr_counter("broker.enqueue")

        if ev.wait > 0:
            self._process_waiting_enqueue(ev)
            return
        self._enqueue_locked(ev, ev.type)

    def _process_waiting_enqueue(self, ev: s.Evaluation) -> None:
        timer = threading.Timer(ev.wait, self._enqueue_waiting, args=(ev,))
        timer.daemon = True
        self.time_wait[ev.id] = timer
        timer.start()

    def _enqueue_waiting(self, ev: s.Evaluation) -> None:
        with self._l:
            self.time_wait.pop(ev.id, None)
            self._enqueue_locked(ev, ev.type)

    def _enqueue_locked(self, ev: s.Evaluation, queue: str) -> None:
        if not self._enabled:
            return
        pending_eval = self.job_evals.get(ev.job_id, "")
        if not pending_eval:
            self.job_evals[ev.job_id] = ev.id
        elif pending_eval != ev.id:
            if self.coalesce and self._coalesce_deferred(ev):
                return
            heapq.heappush(self.blocked.setdefault(ev.job_id, []),
                           self._entry(ev))
            return

        q = self.ready.get(queue)
        if q is None:
            q = self.ready[queue] = TenantQueue(self.fairness)
        q.push(self._entry(ev))
        self._cond.notify_all()

    def _coalesce_deferred(self, ev: s.Evaluation) -> bool:
        """Per-job dedup of deferred duplicates (the job already has a
        queued eval; ``ev`` would be second or later in line).  Every
        eval is a full-job reconcile, so one deferred eval whose trigger
        index covers both subsumes the other: keep the higher-priority
        one, shed the loser for the reaper to cancel.  Skipped when the
        keeper's trigger index is lower than the loser's (the trigger
        would be lost).  True when ``ev`` was absorbed."""
        deferred = self.blocked.get(ev.job_id)
        if not deferred:
            return False
        if len(deferred) > 1:  # pile-up from before coalescing was on
            return False
        other = deferred[0].eval
        keeper, loser = ((other, ev)
                         if (other.priority, other.trigger_index())
                         >= (ev.priority, ev.trigger_index())
                         else (ev, other))
        if keeper.trigger_index() < loser.trigger_index():
            return False
        if keeper is ev:
            deferred[0] = self._entry(ev)
        self._shed_locked(loser)
        self.coalesced_total += 1
        self.metrics.incr_counter("broker.coalesce")
        tr = tracing.TRACER
        if tr is not None:
            tr.event("broker.coalesce", eval_id=loser.id,
                     job_id=loser.job_id, kept_eval=keeper.id)
        return True

    def _shed_locked(self, ev: s.Evaluation) -> None:
        self.evals.pop(ev.id, None)
        self.shed_total += 1
        self.metrics.incr_counter("broker.shed")
        self._shed.append(ev)
        self._shed_cond.notify_all()

    def get_shed(self, timeout: Optional[float]) -> List[s.Evaluation]:
        """Blocking drain of coalesced-away evals (the server's shed
        reaper cancels them through the log)."""
        with self._l:
            if not self._shed:
                self._shed_cond.wait(timeout)
            out, self._shed = self._shed, []
            return out

    # -- admission ---------------------------------------------------------

    def pending_count(self) -> int:
        with self._l:
            return len(self.evals)

    def check_admission(self, priority: int = 0) -> None:
        """Front-door admission check, before the eval-creating log
        apply: raises :class:`BrokerLimitError` while the broker tracks
        ``max_pending`` or more evals, unless ``priority`` is at or above
        ``bypass_priority``.  ``retry_after`` grows with the overload."""
        if self.max_pending <= 0:
            return
        with self._l:
            if not self._enabled or priority >= self.bypass_priority:
                return
            pending = len(self.evals)
            if pending < self.max_pending:
                return
            self.admission_rejects += 1
        self.metrics.incr_counter("broker.admission_reject")
        retry_after = min(5.0, 0.2 + 0.3 * (pending / self.max_pending))
        raise BrokerLimitError(retry_after, pending, self.max_pending)

    def _entry(self, ev: s.Evaluation) -> _HeapEntry:
        return _HeapEntry((-ev.priority, ev.create_index, next(self._seq)),
                          ev)

    # -- dequeue -----------------------------------------------------------

    def dequeue(
        self, schedulers: List[str], timeout: Optional[float] = None
    ) -> Tuple[Optional[s.Evaluation], str]:
        """Blocking dequeue of the highest-priority ready eval
        (eval_broker.go:279).  ``timeout`` 0 polls once."""
        deadline = (None if timeout is None or timeout == 0
                    else time.monotonic() + timeout)
        with self._l:
            while True:
                ev, token = self._scan(schedulers)
                if ev is not None:
                    return ev, token
                if timeout == 0:
                    return None, ""
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return None, ""
                self._cond.wait(remaining if remaining is not None else 1.0)

    def dequeue_batch(
        self, schedulers: List[str], max_batch: int,
        timeout: Optional[float] = None,
    ) -> List[Tuple[s.Evaluation, str]]:
        """Drain up to ``max_batch`` ready evals in one call: the batch
        assembler feeding the device pass."""
        out: List[Tuple[s.Evaluation, str]] = []
        ev, token = self.dequeue(schedulers, timeout)
        if ev is None:
            return out
        out.append((ev, token))
        with self._l:
            while len(out) < max_batch:
                ev, token = self._scan(schedulers)
                if ev is None:
                    break
                out.append((ev, token))
        return out

    def _scan(self, schedulers: List[str]
              ) -> Tuple[Optional[s.Evaluation], str]:
        if not self._enabled:
            raise EvalBrokerError("eval broker disabled")
        eligible: List[str] = []
        eligible_priority = 0
        for sched in schedulers:
            heap = self.ready.get(sched)
            if not heap:
                continue
            priority = heap.peek_priority()
            if not eligible or priority > eligible_priority:
                eligible = [sched]
                eligible_priority = priority
            elif priority == eligible_priority:
                eligible.append(sched)
        if not eligible:
            return None, ""
        sched = (eligible[0] if len(eligible) == 1
                 else random.choice(eligible))
        return self._dequeue_for_sched(sched)

    def _dequeue_for_sched(self, sched: str) -> Tuple[s.Evaluation, str]:
        ev = self.ready[sched].pop().eval
        token = s.generate_uuid()
        deadline = (time.monotonic() + self.nack_timeout
                    if self.nack_timeout > 0 else None)
        self.unack[ev.id] = _Unack(ev, token, deadline)
        self.evals[ev.id] = self.evals.get(ev.id, 0) + 1
        tr = tracing.TRACER
        if tr is not None:
            tr.event("broker.dequeue", eval_id=ev.id, job_id=ev.job_id,
                     eval_type=ev.type, attempt=self.evals[ev.id])
        self.metrics.incr_counter("broker.dequeue")
        return ev, token

    # -- outstanding / ack / nack -----------------------------------------

    def delivery_attempts(self, eval_id: str) -> int:
        """How many times this eval has been dequeued (the delivery-limit
        counter); 0 for evals the broker is not tracking."""
        with self._l:
            return self.evals.get(eval_id, 0)

    def outstanding(self, eval_id: str) -> Tuple[str, bool]:
        with self._l:
            unack = self.unack.get(eval_id)
            if unack is None:
                return "", False
            return unack.token, True

    def _get_unack(self, eval_id: str, token: str) -> _Unack:
        unack = self.unack.get(eval_id)
        if unack is None:
            raise EvalBrokerError(ERR_NOT_OUTSTANDING)
        if unack.token != token:
            raise EvalBrokerError(ERR_TOKEN_MISMATCH)
        return unack

    def ack(self, eval_id: str, token: str) -> None:
        """(eval_broker.go:481): release the job's serialization slot,
        promote a blocked same-job eval, and process any requeue."""
        with self._l:
            try:
                unack = self._get_unack(eval_id, token)
                if unack.fired:
                    raise EvalBrokerError(
                        "Evaluation ID Ack'd after Nack timer expiration")
                job_id = unack.eval.job_id
                tr = tracing.TRACER
                if tr is not None:
                    tr.event("broker.ack", eval_id=eval_id, job_id=job_id,
                             attempts=self.evals.get(eval_id, 0))
                    # Close the submit-to-scheduled umbrella (eval.e2e):
                    # at the ack the eval's plan has applied.
                    tr.close_mark(eval_id, job_id=job_id,
                                  outcome="acked",
                                  attempts=self.evals.get(eval_id, 0))
                self.metrics.incr_counter("broker.ack")
                eb = self.event_broker
                if eb is not None:
                    eb.publish_external(
                        "Eval", "EvalAcked", eval_id,
                        {"JobID": job_id,
                         "Attempts": self.evals.get(eval_id, 0)},
                        eval_id=eval_id)
                del self.unack[eval_id]
                self.evals.pop(eval_id, None)
                self.job_evals.pop(job_id, None)

                blocked = self.blocked.get(job_id)
                if blocked:
                    ev = heapq.heappop(blocked).eval
                    if not blocked:
                        del self.blocked[job_id]
                    self._enqueue_locked(ev, ev.type)

                requeued = self.requeue.pop(token, None)
                if requeued is not None:
                    self._process_enqueue(requeued, "")
            finally:
                self.requeue.pop(token, None)

    def nack(self, eval_id: str, token: str) -> None:
        """(eval_broker.go:540): redeliver with a compounding delay, or
        shunt to the failed queue at the delivery limit."""
        with self._l:
            self.requeue.pop(token, None)
            unack = self._get_unack(eval_id, token)
            del self.unack[eval_id]
            self.nacks_total += 1

            dequeues = self.evals.get(eval_id, 0)
            if dequeues >= self.delivery_limit:
                outcome, wait = "failed", 0.0
                self._enqueue_locked(unack.eval, FAILED_QUEUE)
            else:
                ev = unack.eval
                ev.wait = self._nack_reenqueue_delay(dequeues)
                outcome, wait = "requeue", ev.wait
                if ev.wait > 0:
                    self._process_waiting_enqueue(ev)
                else:
                    self._enqueue_locked(ev, ev.type)
            tr = tracing.TRACER
            if tr is not None:
                tr.event("broker.nack", eval_id=eval_id,
                         job_id=unack.eval.job_id, attempts=dequeues,
                         outcome=outcome, wait=wait)
                if outcome == "failed":
                    # A terminal nack closes the umbrella with the
                    # attempts it burnt.
                    tr.close_mark(eval_id, job_id=unack.eval.job_id,
                                  outcome="failed", attempts=dequeues)
            self.metrics.incr_counter("broker.nack")
            eb = self.event_broker
            if eb is not None:
                eb.publish_external(
                    "Eval", "EvalNacked", eval_id,
                    {"JobID": unack.eval.job_id, "Attempts": dequeues,
                     "Outcome": outcome}, eval_id=eval_id)

    def _nack_reenqueue_delay(self, prev_dequeues: int) -> float:
        if prev_dequeues <= 0:
            return 0.0
        if prev_dequeues == 1:
            return self.initial_nack_delay
        return (prev_dequeues - 1) * self.subsequent_nack_delay

    def pause_nack_timeout(self, eval_id: str, token: str) -> None:
        with self._l:
            unack = self._get_unack(eval_id, token)
            if unack.fired:
                raise EvalBrokerError(ERR_NACK_TIMEOUT_REACHED)
            unack.paused = True

    def resume_nack_timeout(self, eval_id: str, token: str) -> None:
        with self._l:
            unack = self._get_unack(eval_id, token)
            unack.paused = False
            if self.nack_timeout > 0:
                unack.deadline = time.monotonic() + self.nack_timeout

    # -- maintenance -------------------------------------------------------

    def flush(self) -> None:
        with self._l:
            # Unack deadlines die with the map (the sweeper re-reads it
            # under the lock); only the wait timers are real threads.
            for timer in self.time_wait.values():
                timer.cancel()
            self.evals = {}
            self.job_evals = {}
            self.blocked = {}
            self.ready = {}
            self.unack = {}
            self.requeue = {}
            self.time_wait = {}
            # Shed evals not yet reaped die with the leadership that shed
            # them; the next leader's restore pass re-evaluates.
            self._shed = []
            self._cond.notify_all()

    def stats(self) -> Dict:
        with self._l:
            return {
                "total_ready": sum(len(h) for h in self.ready.values()),
                "total_unacked": len(self.unack),
                "total_blocked": sum(len(h) for h in self.blocked.values()),
                "total_waiting": len(self.time_wait),
                # The port's additions: evals parked at the delivery
                # limit, and nacks since construction.
                "total_failed": len(self.ready.get(FAILED_QUEUE, ())),
                "total_nacks": self.nacks_total,
                "by_scheduler": {k: len(h) for k, h in self.ready.items()},
            }
