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
:class:`BrokerLimitError` before the eval is persisted), a per-namespace
pending quota (``ns_max_pending``), and a bypass priority that is always
admitted.  The server admits through :meth:`EvalBroker.reserve_admission`,
which holds a slot for the admitted registration until its eval is
written (:meth:`EvalBroker.release_admission`): concurrent registrations
that all pass the front door then cannot push the pending count past the
bound, which a check alone lets them do by one each while their writes
are in flight.  Refusals decided outside the broker (the server's quota
ledger) are counted through :meth:`EvalBroker.note_quota_reject`.

Each admission, coalesce, dequeue, ack and nack is traced
(``broker.enqueue``, ``broker.coalesce``, ``broker.dequeue``,
``broker.ack``, ``broker.nack``), and so is each refusal
(``broker.admission_reject``, with the namespace when a tenant's quota
refused it, and ``broker.quota_reject``); the ack closes the eval's
``eval.e2e`` umbrella, and with the stream armed the ack and nack are
published as ``Eval``/``EvalAcked`` and ``EvalNacked``.

The tenancy hooks (eval_broker.py:369-478, :727-797): the ready queues
are the reference's :class:`TenantQueue`, fed each namespace's weight and
objective (:meth:`EvalBroker.set_namespace_policy`), the cluster-wide
objective, the cluster capacity and the per-namespace usage
(:meth:`EvalBroker.note_usage_changed`), which order the DRF dequeue;
:meth:`EvalBroker.extended_stats` and :meth:`EvalBroker.tenant_counters`
give the per-tenant pending, dequeued, shed and refused counts.
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

#: Cap on the per-tenant rows extended_stats() returns: the busiest rows
#: ship and the rest are counted as elided.
STATS_MAX_TENANTS = 256


class EvalBrokerError(Exception):
    pass


class BrokerLimitError(EvalBrokerError):
    """Admission NACK: the pending-eval queue is at capacity.  Carries
    ``retry_after`` (seconds) so clients back off instead of hammering."""

    def __init__(self, retry_after: float, pending: int, limit: int,
                 namespace: str = ""):
        self.retry_after = retry_after
        self.pending = pending
        self.limit = limit
        self.namespace = namespace
        what = (f"tenant {namespace!r} at quota" if namespace
                else "eval broker at capacity")
        super().__init__(
            f"{what} ({pending}/{limit} pending); "
            f"retry_after={retry_after:.2f}")

    @staticmethod
    def from_message(msg: str) -> "BrokerLimitError":
        """Rebuilt from the wire's error string (eval_broker.py:75; the
        RPC layer sends errors as '<TypeName>: <message>')."""
        import re

        m = re.search(r"retry_after=([0-9.]+)", msg)
        retry = float(m.group(1)) if m else 1.0
        m = re.search(r"\((\d+)/(\d+) pending\)", msg)
        pending, limit = (int(m.group(1)), int(m.group(2))) if m else (0, 0)
        m = re.search(r"tenant '([^']*)' at quota", msg)
        ns = m.group(1) if m else ""
        return BrokerLimitError(retry, pending, limit, namespace=ns)


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
        rng: Optional[random.Random] = None,
    ):
        self.metrics = metrics if metrics is not None else NULL_TELEMETRY
        # The draw among ready schedulers of equal priority: ``rng`` when
        # given (seeded, so that two brokers fed alike dequeue alike),
        # else the module's ``random``.
        self.rng = rng
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

        # The tenancy plane: the fairness state (policies, usage, virtual
        # time) every ready queue shares, and the per-tenant pending, shed
        # and refusal counts.  All under self._l.
        self.fairness = FairnessState()
        self._ns_pending: Dict[str, int] = {}
        # Admitted registrations whose eval is not written yet (the
        # reserve_admission slots), in all and per namespace.
        self._admitting = 0
        self._ns_admitting: Dict[str, int] = {}
        self._ns_shed: Dict[str, int] = {}
        self._ns_rejects: Dict[str, int] = {}

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
            ns = ev.namespace or s.DEFAULT_NAMESPACE
            self._ns_pending[ns] = self._ns_pending.get(ns, 0) + 1
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
        ns = ev.namespace or s.DEFAULT_NAMESPACE
        if self.evals.pop(ev.id, None) is not None:
            self._ns_pending_dec(ns)
        self._ns_shed[ns] = self._ns_shed.get(ns, 0) + 1
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

    def ns_pending_count(self, namespace: str) -> int:
        with self._l:
            return self._ns_pending.get(namespace or s.DEFAULT_NAMESPACE, 0)

    def _ns_pending_dec(self, ns: str) -> None:
        """The caller holds the lock."""
        left = self._ns_pending.get(ns, 0) - 1
        if left > 0:
            self._ns_pending[ns] = left
        else:
            self._ns_pending.pop(ns, None)

    def check_admission(self, priority: int = 0, namespace: str = "",
                        ns_max_pending: int = 0) -> None:
        """Front-door admission check, before the eval-creating log
        apply: raises :class:`BrokerLimitError` while the broker tracks
        ``max_pending`` or more evals, or, with a per-tenant quota
        (``ns_max_pending`` > 0), while ``namespace`` alone has that many
        pending; unless ``priority`` is at or above ``bypass_priority``.
        ``retry_after`` grows with the overload.  The slots held by
        :meth:`reserve_admission` count as pending."""
        self._admit(priority, namespace, ns_max_pending, reserve=False)

    def reserve_admission(self, priority: int = 0, namespace: str = "",
                          ns_max_pending: int = 0) -> bool:
        """:meth:`check_admission`, and on admission hold a slot until
        the caller's :meth:`release_admission`, once the eval is written
        or its write failed.  Returns whether a slot is held (none while
        nothing is bounded, disabled or for a bypass priority)."""
        return self._admit(priority, namespace, ns_max_pending,
                           reserve=True)

    def release_admission(self, namespace: str = "") -> None:
        ns = namespace or s.DEFAULT_NAMESPACE
        with self._l:
            self._admitting = max(0, self._admitting - 1)
            left = self._ns_admitting.get(ns, 0) - 1
            if left > 0:
                self._ns_admitting[ns] = left
            else:
                self._ns_admitting.pop(ns, None)

    def _admit(self, priority: int, namespace: str, ns_max_pending: int,
               reserve: bool) -> bool:
        if self.max_pending <= 0 and ns_max_pending <= 0:
            return False
        ns = namespace or s.DEFAULT_NAMESPACE
        with self._l:
            if not self._enabled or priority >= self.bypass_priority:
                return False
            ns_pending = (self._ns_pending.get(ns, 0)
                          + self._ns_admitting.get(ns, 0))
            if ns_max_pending > 0 and ns_pending >= ns_max_pending:
                self.admission_rejects += 1
                self._ns_rejects[ns] = self._ns_rejects.get(ns, 0) + 1
                self.metrics.incr_counter("broker.admission_reject")
                tr = tracing.TRACER
                if tr is not None:
                    tr.event("broker.admission_reject", namespace=ns,
                             pending=ns_pending, limit=ns_max_pending)
                retry_after = min(
                    5.0, 0.2 + 0.3 * (ns_pending / ns_max_pending))
                raise BrokerLimitError(retry_after, ns_pending,
                                       ns_max_pending, namespace=ns)
            pending = len(self.evals) + self._admitting
            if self.max_pending <= 0 or pending < self.max_pending:
                if reserve:
                    self._admitting += 1
                    self._ns_admitting[ns] = \
                        self._ns_admitting.get(ns, 0) + 1
                return reserve
            self.admission_rejects += 1
            self._ns_rejects[ns] = self._ns_rejects.get(ns, 0) + 1
        self.metrics.incr_counter("broker.admission_reject")
        tr = tracing.TRACER
        if tr is not None:
            tr.event("broker.admission_reject", pending=pending,
                     limit=self.max_pending)
        retry_after = min(5.0, 0.2 + 0.3 * (pending / self.max_pending))
        raise BrokerLimitError(retry_after, pending, self.max_pending)

    def note_quota_reject(self, namespace: str) -> None:
        """Count a refusal decided outside the broker (the server's quota
        ledger), so the per-tenant refusal counts tell one story."""
        ns = namespace or s.DEFAULT_NAMESPACE
        with self._l:
            self.admission_rejects += 1
            self._ns_rejects[ns] = self._ns_rejects.get(ns, 0) + 1
        self.metrics.incr_counter("broker.admission_reject")
        tr = tracing.TRACER
        if tr is not None:
            tr.event("broker.quota_reject", namespace=ns)

    # -- tenancy wiring ----------------------------------------------------

    def set_namespace_policy(self, name: str, weight: float,
                             objective: str) -> None:
        """Install or refresh a tenant's fairness policy (on a namespace
        upsert) and rescore its queued entries."""
        with self._l:
            self.fairness.set_policy(name, weight, objective)
            for q in self.ready.values():
                q.note_usage_changed((name,))

    def drop_namespace_policy(self, name: str) -> None:
        with self._l:
            self.fairness.drop_policy(name)

    def set_objective(self, objective: str) -> None:
        """The cluster-wide default fairness objective."""
        with self._l:
            self.fairness.objective = objective

    def set_cluster_capacity(self, cap: Tuple[int, int, int, int]) -> None:
        with self._l:
            self.fairness.set_capacity(cap)

    def note_usage_changed(self, usage: Dict[str, Tuple]) -> None:
        """Fold the store's changed per-tenant usage rows into the
        fairness scorer (O(changed tenants))."""
        if not usage:
            return
        with self._l:
            for ns, vec in usage.items():
                self.fairness.set_usage(ns, vec)
            for q in self.ready.values():
                q.note_usage_changed(usage)

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
                 else (self.rng or random).choice(eligible))
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
                if self.evals.pop(eval_id, None) is not None:
                    self._ns_pending_dec(unack.eval.namespace
                                         or s.DEFAULT_NAMESPACE)
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
            # The pending counts die with the queues; the shed, refusal
            # and dequeue counts are lifetime totals.
            self._ns_pending = {}
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

    def extended_stats(self) -> Dict:
        """The broker's saturation surface (eval_broker.py:727): pending
        by state and priority, the delivery-attempts histogram, the
        admission, coalesce and shed counters and the per-tenant rows."""
        with self._l:
            failed = len(self.ready.get(FAILED_QUEUE, ()))
            by_state = {
                "ready": sum(len(h) for k, h in self.ready.items()
                             if k != FAILED_QUEUE),
                "unacked": len(self.unack),
                "deferred": sum(len(h) for h in self.blocked.values()),
                "waiting": len(self.time_wait),
                "failed": failed,
            }
            by_priority: Dict[int, int] = {}
            for heaps in (self.ready.values(), self.blocked.values()):
                for heap in heaps:
                    for entry in heap:
                        prio = entry.eval.priority
                        by_priority[prio] = by_priority.get(prio, 0) + 1
            attempts_hist: Dict[int, int] = {}
            for attempts in self.evals.values():
                attempts_hist[attempts] = attempts_hist.get(attempts, 0) + 1
            tenants, elided = self._tenant_stats_locked()
            return {
                "Enabled": self._enabled,
                "Pending": len(self.evals),
                "MaxPending": self.max_pending,
                "Coalesce": self.coalesce,
                "BypassPriority": self.bypass_priority,
                "ByState": by_state,
                "ByPriority": {str(k): v
                               for k, v in sorted(by_priority.items())},
                "DeliveryAttempts": {str(k): v for k, v
                                     in sorted(attempts_hist.items())},
                "ShedTotal": self.shed_total,
                "CoalescedTotal": self.coalesced_total,
                "AdmissionRejects": self.admission_rejects,
                "ShedUnreaped": len(self._shed),
                "Objective": self.fairness.objective,
                "Tenants": tenants,
                "TenantsElided": elided,
            }

    def _tenant_stats_locked(self) -> Tuple[Dict[str, Dict], int]:
        """The per-tenant rows, busiest (most pending) first, capped at
        ``STATS_MAX_TENANTS``.  The caller holds the lock."""
        fs = self.fairness
        names = set(self._ns_pending)
        names.update(fs.dequeued)
        names.update(self._ns_shed)
        names.update(self._ns_rejects)
        ranked = sorted(names,
                        key=lambda n: (-self._ns_pending.get(n, 0), n))
        elided = max(0, len(ranked) - STATS_MAX_TENANTS)
        tenants: Dict[str, Dict] = {}
        for ns in ranked[:STATS_MAX_TENANTS]:
            tenants[ns] = {
                "Pending": self._ns_pending.get(ns, 0),
                "Dequeued": fs.dequeued.get(ns, 0),
                "Shed": self._ns_shed.get(ns, 0),
                "Rejects": self._ns_rejects.get(ns, 0),
                "Weight": fs.weight(ns),
                "DominantShare": round(fs.dominant_share(ns), 6),
                "VirtualTime": round(fs.vt.get(ns, 0.0), 6),
            }
        return tenants, elided

    def tenant_counters(self) -> Dict[str, Tuple[int, int, int, int]]:
        """(pending, dequeued, shed, rejects) per tenant: the metrics
        tick's cheap read (no score computed)."""
        with self._l:
            fs = self.fairness
            names = set(self._ns_pending)
            names.update(fs.dequeued)
            names.update(self._ns_rejects)
            return {ns: (self._ns_pending.get(ns, 0),
                         fs.dequeued.get(ns, 0),
                         self._ns_shed.get(ns, 0),
                         self._ns_rejects.get(ns, 0))
                    for ns in names}
