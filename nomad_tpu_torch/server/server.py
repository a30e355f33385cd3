"""The port's in-process server: jobs in, running allocations out (a slim
copy of ``nomad_tpu/server/server.py:141-420``; reference
nomad/server.go:78-305, nomad/leader.go:28-641).

It wires the control plane of one single-voter server: the eval broker,
blocked evals, the plan queue, the FSM and its leader-side hooks over the
log (``FileLog`` in ``ServerConfig.data_dir``, or an ``InmemLog`` when
it is empty), the queue-driven ``PlanApplier``, the heartbeat timers, and
``num_schedulers`` ``BatchWorker``\\ s that run ``TorchBatchScheduler`` on
the card (``device="cuda"``, the default), on the CPU (``device="cpu"``)
or node-sharded over a ``NodeMesh`` (``mesh``).

Durability (server.py:47, :270-278): with a ``data_dir`` every
acknowledged write is in the log's WAL before it applies; a server built
on the same directory after a crash recovers the newest FSM snapshot and
the WAL past it before it starts (the torn last frame of a crash is
truncated, never applied), and its leadership then re-enqueues the
pending evals and re-blocks the blocked ones it finds in the restored
store.  The snapshot thresholds are ``snapshot_entries``,
``snapshot_bytes`` and ``snapshot_interval``.

The single voter leads from :meth:`Server.start`.  Leadership enables the
broker, the plan queue, blocked evals and the heartbeats, starts the
applier, re-enqueues pending and re-blocks blocked evals from the store,
and starts the reapers (duplicate blocked evals, coalesced evals, the
periodic unblock of max-plan failures).  On ``cuda``, :meth:`start`
builds the kernels in the calling thread first: a card that is missing
or a build that fails raises there, instead of nacking every eval in a
worker thread.

Entry points: :meth:`Server.node_register`,
:meth:`Server.node_deregister`, :meth:`Server.node_update_status`,
:meth:`Server.node_update_drain`, :meth:`Server.job_register`,
:meth:`Server.job_evaluate`, :meth:`Server.job_deregister`,
:meth:`Server.job_plan` (the ``job plan`` dry run: the annotated diff,
nothing committed), :meth:`Server.shutdown`.  The metrics emitter publishes the broker,
blocked-eval, plan-queue, heartbeat and log gauges and the kernel
breaker's ``breaker.state``/``breaker.trips`` each second.

Observability (server.py:150-157, :289-315, :392-440): ``ServerConfig(
trace=True)`` arms the process-wide tracing plane at construction (the
reference's ``NOMAD_TPU_TRACE``); an eval's ``eval.e2e`` umbrella opens
at :meth:`Server.job_register` or :meth:`Server.job_evaluate` and closes
at its broker ack; :meth:`Server.trace_for_eval` returns its timeline.
``ServerConfig(events=True)`` (``NOMAD_TPU_EVENTS``) arms this server's
cluster event stream at construction, and the first
:meth:`Server.event_stream_subscribe` arms it lazily; the ring holds
``events_ring`` events (``NOMAD_TPU_EVENTS_RING``).

Left out, for later slices: RPC, endpoints, membership and forwarding,
with the ``rpc.request`` span, the ``/v1/trace/*`` and
``/v1/event/stream`` endpoints and the trace fanout over peers (ROADMAP
queue 1 item 20); multi-voter raft and follower scheduling (item 17); core (GC) and periodic jobs; vault; the tenancy
quotas and namespaces; the blackbox hooks (item 21).
"""
from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

from .. import device as device_mod
from ..ops import breaker as breaker_mod
from ..scheduler.annotate import annotate
from ..scheduler.scheduler import new_scheduler
from ..scheduler.testing import Harness
from ..state import columnar as columnar_mod
from ..state.state_store import StateStore
from ..structs import structs as s
from ..structs.diff import job_diff
from ..utils import tracing
from ..utils.telemetry import Telemetry
from . import event_broker as event_stream
from .blocked_evals import BlockedEvals
from .eval_broker import EvalBroker
from .event_broker import EventBroker, Subscription
from .fsm import FSM, MessageType, TimeTable
from .heartbeat import HeartbeatTimers
from .plan_apply import PlanApplier
from .plan_queue import PlanQueue
from .raft import FileLog, InmemLog, NotLeaderError
from .worker import BatchWorker

# Bound on every join at shutdown, per thread.
JOIN_TIMEOUT = 5.0
# The reference's defaults: how often evals blocked by max-plan failures
# are retried, and how often the gauges are published.
FAILED_EVAL_UNBLOCK_INTERVAL = 60.0
METRICS_INTERVAL = 1.0


@dataclass
class ServerConfig:
    """(reference: nomad/config.go, the fields this server reads).

    ``device`` is where the batch scheduler and the applier's fit
    re-check run (``cuda``, or ``cpu`` for the plain versions); ``mesh``
    (a ``parallel.NodeMesh``) shards the placement pass instead.
    ``rng_seed`` pins the tie-break seed of every batch (the reference's
    ``NOMAD_TPU_RNG_SEED``); ``preemption_enabled``, ``pipeline`` and
    ``stale_snapshot`` are the reference's ``NOMAD_TPU_PREEMPTION``,
    ``NOMAD_TPU_PIPELINE`` and ``NOMAD_TPU_STALE_SNAPSHOT``.  ``breaker``
    is the kernel breaker every batch scheduler uses (default: the
    process-wide ``ops.breaker.BREAKER``, read at each batch).
    ``min_heartbeat_ttl`` is the shortest node TTL granted (it grows with
    the fleet, at 50 heartbeats a second).  ``columnar`` keeps the state
    store's columnar mirror (``state/columnar.py``), which the batch
    scheduler's encode and usage read and the applier's fit route slice,
    and ``columnar_guard_every`` is the cadence of their guards (the
    reference's ``NOMAD_TPU_COLUMNAR`` and
    ``NOMAD_TPU_COLUMNAR_GUARD_EVERY``).  ``trace`` arms the process-wide
    tracing plane at construction, ``events`` this server's event stream,
    whose ring holds ``events_ring`` events (``NOMAD_TPU_TRACE``,
    ``NOMAD_TPU_EVENTS``, ``NOMAD_TPU_EVENTS_RING``); both are off by
    default.  ``data_dir`` holds the durable log (empty: the in-memory
    log), and ``snapshot_entries``, ``snapshot_bytes`` and
    ``snapshot_interval`` are its automatic snapshot's thresholds (the
    reference's ``NOMAD_TPU_FILELOG_SNAPSHOT_*``; 0 entries and 0 bytes
    turn it off)."""

    num_schedulers: int = 1
    batch_size: int = 64
    device: str = "cuda"
    mesh: object = None
    rng_seed: Optional[int] = None
    preemption_enabled: bool = False
    pipeline: bool = False
    stale_snapshot: bool = True
    breaker: object = None
    eval_nack_timeout: float = 60.0
    eval_delivery_limit: int = 3
    min_heartbeat_ttl: float = 10.0
    columnar: bool = True
    columnar_guard_every: int = columnar_mod.GUARD_EVERY
    trace: bool = False
    events: bool = False
    events_ring: int = 4096
    data_dir: str = ""
    snapshot_entries: int = 8192
    snapshot_bytes: int = 64 << 20
    snapshot_interval: float = 1.0


class Server:
    """A single control-plane server (nomad/server.go:78 Server)."""

    def __init__(self, config: Optional[ServerConfig] = None,
                 logger: Optional[logging.Logger] = None):
        self.config = config or ServerConfig()
        cfg = self.config
        if cfg.mesh is not None:
            self.device = cfg.mesh.root
        else:
            self.device = device_mod.resolve_device(cfg.device)
        self.logger = logger or logging.getLogger("nomad_tpu_torch.server")
        self.metrics = Telemetry()
        # The tracing plane is process-wide and off by default.
        if cfg.trace and not tracing.enabled():
            tracing.enable()
        self._leader = False
        self._shutdown = threading.Event()

        self.eval_broker = EvalBroker(
            nack_timeout=cfg.eval_nack_timeout,
            delivery_limit=cfg.eval_delivery_limit,
            metrics=self.metrics)
        self.blocked_evals = BlockedEvals(self.eval_broker)
        self.plan_queue = PlanQueue()
        self.time_table = TimeTable()
        self.fsm = FSM(state=StateStore(columnar=cfg.columnar),
                       logger=self.logger,
                       on_eval_update=self._fsm_eval_updated,
                       on_unblock=self._fsm_unblock)
        # The log (server.go:257 setupRaft): the durable single voter
        # when a data dir is given, which recovers the store here.
        if cfg.data_dir:
            self.raft = FileLog(
                self.fsm, cfg.data_dir,
                snapshot_entries=cfg.snapshot_entries,
                snapshot_bytes=cfg.snapshot_bytes,
                snapshot_interval=cfg.snapshot_interval)
        else:
            self.raft = InmemLog(self.fsm)
        self.raft.metrics = self.metrics
        self.plan_applier = PlanApplier(
            self.plan_queue, self.raft, self.logger, metrics=self.metrics,
            blocked_evals=self.blocked_evals, device=self.device,
            columnar_guard_every=cfg.columnar_guard_every)
        self.heartbeat = HeartbeatTimers(
            on_expire=self._heartbeat_expired,
            min_ttl=cfg.min_heartbeat_ttl, logger=self.logger,
            metrics=self.metrics)
        # The cluster event stream: built always, armed (attached to the
        # store and the process-wide registry) only by ``events`` or the
        # first subscriber; disarmed, a state write pays one attribute
        # load and a branch.  The relaxed index source: external events
        # are clamped monotone by the broker anyway, and must not queue
        # on the log lock behind the apply stream.
        self.event_broker = EventBroker(
            ring_size=cfg.events_ring, metrics=self.metrics,
            index_source=self.raft.applied_index_relaxed)
        self._events_enabled = False
        self._events_lock = threading.Lock()
        if cfg.events:
            self.enable_event_stream()
        self.workers: List[BatchWorker] = []
        self._threads: List[threading.Thread] = []

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Build the kernels (on a card), start the workers and the
        metrics emitter, and take leadership (server.go:250-284,
        leader.go:28)."""
        if self.device.type == "cuda":
            device_mod.build_kernels()
        t = threading.Thread(target=self._emit_metrics_loop, daemon=True,
                             name="metrics-emitter")
        t.start()
        self._threads.append(t)
        cfg = self.config
        sched_kwargs = {"rng_seed": cfg.rng_seed,
                        "preemption_enabled": cfg.preemption_enabled,
                        "columnar_guard_every": cfg.columnar_guard_every}
        if cfg.mesh is not None:
            sched_kwargs["mesh"] = cfg.mesh
        else:
            sched_kwargs["device"] = self.device
        if cfg.breaker is not None:
            sched_kwargs["breaker"] = cfg.breaker
        for _ in range(cfg.num_schedulers):
            self.workers.append(BatchWorker(
                self.eval_broker, self.plan_queue, self.raft,
                blocked_evals=self.blocked_evals, logger=self.logger,
                metrics=self.metrics,
                stale_snapshot=cfg.stale_snapshot,
                scheduler_kwargs=sched_kwargs,
                max_batch=cfg.batch_size, pipeline=cfg.pipeline))
        self.raft.notify_leadership(self._leadership_changed)
        for worker in self.workers:
            worker.start()

    def shutdown(self) -> None:
        """Stop everything this server started; every join is bounded
        (``JOIN_TIMEOUT`` a thread)."""
        self._shutdown.set()
        self._leader = False
        event_stream.unregister(self.event_broker)
        self.event_broker.close()
        for worker in self.workers:
            worker.stop(timeout=JOIN_TIMEOUT)
        self.plan_applier.stop(timeout=JOIN_TIMEOUT)
        self.eval_broker.set_enabled(False)
        self.blocked_evals.set_enabled(False)
        self.plan_queue.set_enabled(False)
        self.heartbeat.set_enabled(False)
        for t in self._threads:
            t.join(timeout=JOIN_TIMEOUT)
        self.raft.close()

    def threads(self) -> List[threading.Thread]:
        """Every thread this server started that is still alive (empty
        after a clean :meth:`shutdown`)."""
        out = [w._thread for w in self.workers if w._thread is not None]
        out += self.plan_applier.threads() + list(self._threads)
        if isinstance(self.raft, FileLog):
            out += self.raft.threads()
        for extra in (self.eval_broker.sweeper(), self.heartbeat.sweeper(),
                      self.blocked_evals._watcher):
            if extra is not None:
                out.append(extra)
        return [t for t in out if t.is_alive()]

    def set_workers_paused(self, paused: bool,
                           timeout: float = 60.0) -> bool:
        """Pause or release every worker.  Pausing waits (up to
        ``timeout``) until each is parked with no batch in hand, so evals
        registered meanwhile are dequeued together on release; True when
        all parked (always True on release)."""
        for w in self.workers:
            w.set_pause(paused)
        if not paused:
            return True
        return all(w.wait_parked(timeout) for w in self.workers)

    @property
    def state(self):
        return self.fsm.state

    # -- observability -----------------------------------------------------

    def enable_event_stream(self) -> None:
        """Arm the event broker (server.py:392): attach it to the state
        store's write path, the eval broker and the heartbeats, and to
        the process-wide registry of external publishers.  Idempotent;
        it stays armed for the server's lifetime, so a subscriber that
        disconnects can resume against a ring that kept buffering."""
        with self._events_lock:
            if self._events_enabled:
                return
            self._events_enabled = True
            self.fsm.event_broker = self.event_broker
            self.fsm.state.event_broker = self.event_broker
            # Writes applied before arming were never buffered: the gap
            # horizon goes up to the applied index, read after the
            # attach, so a stale resume errors instead of replaying
            # nothing.
            self.event_broker.mark_armed(self.raft.applied_index())
            self.eval_broker.event_broker = self.event_broker
            self.heartbeat.event_broker = self.event_broker
            event_stream.register(self.event_broker)

    def event_stream_subscribe(self, topics=None, from_index: int = 0,
                               replay_all: bool = False) -> Subscription:
        """Subscribe to the cluster event stream (server.py:423), arming
        it on first use.  ``topics``: ``{topic: {keys}}`` (an empty set
        for every key; see ``event_broker.parse_topic_filter``), None
        for all.  Raises ``event_broker.EventIndexError`` when
        ``from_index`` is below the ring's buffered horizon;
        ``replay_all`` dumps whatever the ring still holds."""
        self.enable_event_stream()
        return self.event_broker.subscribe(topics=topics,
                                           from_index=from_index,
                                           replay_all=replay_all)

    def trace_for_eval(self, eval_id: str) -> List[dict]:
        """The eval's spans from this process's tracer, by start time
        (empty while tracing is off).  The reference's fanout over peer
        servers waits for RPC."""
        return tracing.trace_for_eval(eval_id)

    def is_leader(self) -> bool:
        return self._leader

    # -- leadership --------------------------------------------------------

    def _leadership_changed(self, leader: bool) -> None:
        if leader:
            self._establish_leadership()
        else:
            self._revoke_leadership()

    def _establish_leadership(self) -> None:
        """(leader.go:110 establishLeadership), the parts these modules
        have."""
        self._leader = True
        self.eval_broker.set_enabled(True)
        self.plan_queue.set_enabled(True)
        # Every committed plan is at or below the log's last index: the
        # fence floor for the workers' snapshots.
        self.plan_queue.note_applied("", self.raft.fence_index())
        self.blocked_evals.set_enabled(True)
        self.heartbeat.set_enabled(True)
        self.plan_applier.start()
        self._restore_evals()
        self._start_reapers()

    def _revoke_leadership(self) -> None:
        self._leader = False
        self.eval_broker.set_enabled(False)
        self.plan_queue.set_enabled(False)
        self.blocked_evals.set_enabled(False)
        self.heartbeat.set_enabled(False)
        self.plan_applier.stop(timeout=JOIN_TIMEOUT)

    def _restore_evals(self) -> None:
        """Re-enqueue pending and re-block blocked evals from the store
        (leader.go:195 restoreEvals)."""
        for ev in self.state.evals(None):
            if ev.should_enqueue():
                self.eval_broker.enqueue(ev)
            elif ev.should_block():
                self.blocked_evals.block(ev)

    def _start_reapers(self) -> None:
        """The duplicate-blocked-eval reaper, the coalesced-eval reaper
        and the failed-eval unblock (leader.go:157-193)."""

        def cancel(evals: List[s.Evaluation], why: str) -> None:
            cancelled = []
            for dup in evals:
                ev = dup.copy()
                ev.status = s.EVAL_STATUS_CANCELLED
                ev.status_description = why.format(job=ev.job_id)
                cancelled.append(ev)
            self.raft.apply(MessageType.EVAL_UPDATE, {"evals": cancelled})

        def dup_reaper():
            while self._leader and not self._shutdown.is_set():
                dups = self.blocked_evals.get_duplicates(timeout=0.5)
                if dups:
                    cancel(dups, "existing blocked evaluation exists for "
                                 "job {job!r}")

        def shed_reaper():
            while self._leader and not self._shutdown.is_set():
                shed = self.eval_broker.get_shed(timeout=0.5)
                if not shed:
                    continue
                try:
                    cancel(shed, "coalesced with a pending evaluation for "
                                 "job {job!r} (broker admission control)")
                except NotLeaderError:
                    return

        def failed_unblocker():
            while self._leader and not self._shutdown.is_set():
                self._shutdown.wait(FAILED_EVAL_UNBLOCK_INTERVAL)
                if self._leader and not self._shutdown.is_set():
                    self.blocked_evals.unblock_failed()

        for target in (dup_reaper, shed_reaper, failed_unblocker):
            t = threading.Thread(target=target, daemon=True,
                                 name=target.__name__)
            t.start()
            self._threads.append(t)

    def _emit_metrics_loop(self) -> None:
        """Periodic gauges (server.go:292-305): the broker, blocked evals,
        the plan queue, heartbeats, the log, and the kernel breaker."""
        while not self._shutdown.is_set():
            try:
                self.emit_gauges()
            except Exception:  # never kill the emitter
                self.logger.exception("metrics emit failed")
            self._shutdown.wait(METRICS_INTERVAL)

    def emit_gauges(self) -> None:
        m = self.metrics
        b = self.eval_broker.stats()
        m.set_gauge("broker.total_ready", b["total_ready"])
        m.set_gauge("broker.total_unacked", b["total_unacked"])
        m.set_gauge("broker.total_waiting", b["total_waiting"])
        m.set_gauge("broker.pending", self.eval_broker.pending_count())
        bl = self.blocked_evals.stats()
        m.set_gauge("blocked_evals.total_blocked", bl["total_blocked"])
        m.set_gauge("blocked_evals.total_escaped", bl["total_escaped"])
        m.set_gauge("plan.queue_depth", self.plan_queue.depth())
        m.set_gauge("heartbeat.active", self.heartbeat.active())
        m.set_gauge("raft.applied_index", self.raft.applied_index())
        # The breaker's state survives interval rolls while evals are
        # quiet: the open-and-idle window is the one worth seeing.
        brk = self.breaker()
        m.set_gauge("breaker.state",
                    breaker_mod.STATE_CODE.get(brk.state, 0))
        m.set_gauge("breaker.trips", brk.trips)

    def breaker(self):
        """The kernel breaker the batch schedulers use."""
        return (self.config.breaker if self.config.breaker is not None
                else breaker_mod.BREAKER)

    # -- FSM hooks (leader side) -------------------------------------------

    def _fsm_eval_updated(self, ev: s.Evaluation) -> None:
        if not self._leader:
            return
        self.time_table.witness(self.raft.applied_index())
        if ev.should_enqueue():
            self.eval_broker.enqueue(ev)
        elif ev.should_block():
            self.blocked_evals.block(ev)
        elif (ev.status == s.EVAL_STATUS_COMPLETE
              and not ev.failed_tg_allocs):
            # A successful eval untracks any blocked eval of its job
            # (fsm.go applyUpdateEval).
            self.blocked_evals.untrack(ev.job_id)

    def _fsm_unblock(self, computed_class: str, index: int) -> None:
        if self._leader:
            self.blocked_evals.unblock(computed_class, index)

    def _heartbeat_expired(self, node_id: str) -> None:
        """A missed heartbeat marks the node down, which makes node evals
        (heartbeat.go:86)."""
        try:
            self.node_update_status(node_id, s.NODE_STATUS_DOWN)
        except KeyError:
            pass

    # -- jobs --------------------------------------------------------------

    def job_register(self, job: s.Job) -> Tuple[int, str]:
        """(job_endpoint.go:47 Register): validate, then the job and its
        registration eval through the log.  Returns (modify_index,
        eval_id)."""
        job = job.copy()
        job.canonicalize()
        problems = job.validate()
        if problems:
            raise ValueError("job validation failed: " + "; ".join(problems))
        # Admission at the front door, before anything is written.
        if self._leader:
            self.eval_broker.check_admission(job.priority)
        _, index = self.raft.apply(MessageType.JOB_REGISTER, {"job": job})
        ev = s.Evaluation(
            id=s.generate_uuid(), priority=job.priority, type=job.type,
            namespace=job.namespace,
            triggered_by=s.EVAL_TRIGGER_JOB_REGISTER, job_id=job.id,
            job_modify_index=index, status=s.EVAL_STATUS_PENDING)
        # Open the eval.e2e umbrella (submit to broker ack) before the
        # eval write, so it covers the enqueue and the queue wait.
        tr = tracing.TRACER
        if tr is not None:
            tr.mark(ev.id, job_id=job.id, submit="job_register",
                    priority=job.priority, namespace=job.namespace)
        self.raft.apply(MessageType.EVAL_UPDATE, {"evals": [ev]})
        return index, ev.id

    def job_evaluate(self, job_id: str) -> Tuple[int, str]:
        """Force a new evaluation of an existing job (job_endpoint.go
        Evaluate): returns (index, eval_id)."""
        job = self.state.job_by_id(None, job_id)
        if job is None:
            raise KeyError(f"job not found: {job_id}")
        if self._leader:
            self.eval_broker.check_admission(job.priority)
        ev = s.Evaluation(
            id=s.generate_uuid(), priority=job.priority, type=job.type,
            namespace=job.namespace,
            triggered_by=s.EVAL_TRIGGER_JOB_REGISTER, job_id=job.id,
            job_modify_index=job.modify_index, status=s.EVAL_STATUS_PENDING)
        tr = tracing.TRACER
        if tr is not None:
            tr.mark(ev.id, job_id=job.id, submit="job_evaluate",
                    priority=job.priority, namespace=job.namespace)
        _, index = self.raft.apply(MessageType.EVAL_UPDATE, {"evals": [ev]})
        return index, ev.id

    def job_deregister(self, job_id: str,
                       purge: bool = True) -> Tuple[int, str]:
        """(job_endpoint.go Deregister): the job stopped (or purged) and
        a deregistration eval."""
        job = self.state.job_by_id(None, job_id)
        if job is None:
            raise KeyError(f"job not found: {job_id}")
        _, index = self.raft.apply(MessageType.JOB_DEREGISTER,
                                   {"job_id": job_id, "purge": purge})
        ev = s.Evaluation(
            id=s.generate_uuid(), priority=job.priority, type=job.type,
            namespace=job.namespace,
            triggered_by=s.EVAL_TRIGGER_JOB_DEREGISTER, job_id=job_id,
            job_modify_index=index, status=s.EVAL_STATUS_PENDING)
        self.raft.apply(MessageType.EVAL_UPDATE, {"evals": [ev]})
        return index, ev.id

    def job_plan(self, job: s.Job, diff: bool = True) -> s.JobPlanResponse:
        """Dry-run scheduling (job_endpoint.go:~490 Plan): the job's
        scheduler (the CPU oracle of ``job.type``, as in the reference, not
        the batch worker) runs synchronously over a snapshot holding the
        job, into a ``Harness``; returns the annotated job diff and the
        placement forensics.  Nothing is committed to the store.  The port
        has no periodic jobs, so ``next_periodic_launch`` stays 0."""
        old_job = self.state.job_by_id(None, job.id)
        job = job.copy()
        job.canonicalize()
        snap = self.state.snapshot()
        index = self.raft.applied_index() + 1
        snap.upsert_job(index, job)

        harness = Harness(snap)
        harness._next_index = index + 1
        ev = s.Evaluation(
            id=s.generate_uuid(), priority=job.priority, type=job.type,
            triggered_by=s.EVAL_TRIGGER_JOB_REGISTER, job_id=job.id,
            job_modify_index=index, status=s.EVAL_STATUS_PENDING,
            annotate_plan=True)
        sched = new_scheduler(job.type, self.logger, snap.snapshot(), harness)
        sched.process(ev)
        plan = harness.plans[0] if harness.plans else ev.make_plan(job)

        # The scheduler records placement forensics on a copy of the eval
        # handed to Planner.UpdateEval (scheduler/util.go setStatus): read
        # the updated eval from the harness, as job_endpoint.go Plan does.
        updated = next((e for e in reversed(harness.evals) if e.id == ev.id), ev)
        resp = s.JobPlanResponse(
            annotations=plan.annotations,
            failed_tg_allocs=dict(updated.failed_tg_allocs),
            job_modify_index=old_job.job_modify_index if old_job else 0,
            created_evals=list(harness.create_evals))
        if diff:
            resp.diff = job_diff(old_job, job)
            annotate(resp.diff, plan.annotations)
        return resp

    # -- nodes -------------------------------------------------------------

    def node_register(self, node: s.Node) -> Tuple[int, float]:
        """(node_endpoint.go Register): returns (index, heartbeat_ttl)."""
        node = node.copy()
        if not node.id:
            raise ValueError("missing node ID for client registration")
        existed = self.state.node_by_id(None, node.id)
        if not node.status:
            node.status = s.NODE_STATUS_INIT
        _, index = self.raft.apply(MessageType.NODE_REGISTER,
                                   {"node": node})
        ttl = self.heartbeat.reset_heartbeat_timer(node.id)
        # Transitions create node evals (node_endpoint.go:165).
        if existed is not None and existed.status != node.status:
            self._create_node_evals(node.id, index)
        return index, ttl

    def node_deregister(self, node_id: str) -> int:
        """(node_endpoint.go Deregister): the node out of the store
        through the log, its heartbeat timer cleared, and evals for the
        jobs with allocs on it."""
        _, index = self.raft.apply(MessageType.NODE_DEREGISTER,
                                   {"node_id": node_id})
        self.heartbeat.clear_heartbeat_timer(node_id)
        self._create_node_evals(node_id, index)
        return index

    def node_update_status(self, node_id: str,
                           status: str) -> Tuple[int, float]:
        """(node_endpoint.go:277 UpdateStatus): a heartbeat, and on a
        transition the status through the log and node evals."""
        node = self.state.node_by_id(None, node_id)
        if node is None:
            raise KeyError(f"node not found: {node_id}")
        index = self.raft.applied_index_relaxed()
        if node.status != status:
            _, index = self.raft.apply(
                MessageType.NODE_UPDATE_STATUS,
                {"node_id": node_id, "status": status})
            if self._should_create_node_evals(node.status, status):
                self._create_node_evals(node_id, index)
        ttl = 0.0
        if status != s.NODE_STATUS_DOWN:
            ttl = self.heartbeat.reset_heartbeat_timer(node_id)
        else:
            self.heartbeat.clear_heartbeat_timer(node_id)
        return index, ttl

    @staticmethod
    def _should_create_node_evals(old: str, new: str) -> bool:
        """(structs.go ShouldDrainNode / the transition table)."""
        if old == new:
            return False
        if new == s.NODE_STATUS_DOWN:
            return True
        return new == s.NODE_STATUS_READY and old in (
            s.NODE_STATUS_DOWN, s.NODE_STATUS_INIT)

    def node_update_drain(self, node_id: str, drain: bool) -> int:
        node = self.state.node_by_id(None, node_id)
        if node is None:
            raise KeyError(f"node not found: {node_id}")
        _, index = self.raft.apply(MessageType.NODE_UPDATE_DRAIN,
                                   {"node_id": node_id, "drain": drain})
        if drain:
            self._create_node_evals(node_id, index)
        return index

    def _create_node_evals(self, node_id: str,
                           node_index: int) -> List[str]:
        """One eval per job with allocs on the node, plus every system
        job (node_endpoint.go:803 createNodeEvals)."""
        allocs = self.state.allocs_by_node(None, node_id)
        job_ids = {a.job_id for a in allocs}
        evals: List[s.Evaluation] = []
        for job_id in job_ids:
            job = self.state.job_by_id(None, job_id)
            if job is None:
                continue
            evals.append(s.Evaluation(
                id=s.generate_uuid(), priority=job.priority, type=job.type,
                namespace=job.namespace,
                triggered_by=s.EVAL_TRIGGER_NODE_UPDATE, job_id=job_id,
                node_id=node_id, node_modify_index=node_index,
                status=s.EVAL_STATUS_PENDING))
        for job in self.state.jobs_by_scheduler(None, s.JOB_TYPE_SYSTEM):
            if job.id in job_ids or job.stopped():
                continue
            evals.append(s.Evaluation(
                id=s.generate_uuid(), priority=job.priority, type=job.type,
                namespace=job.namespace,
                triggered_by=s.EVAL_TRIGGER_NODE_UPDATE, job_id=job.id,
                node_id=node_id, node_modify_index=node_index,
                status=s.EVAL_STATUS_PENDING))
        if evals:
            self.raft.apply(MessageType.EVAL_UPDATE, {"evals": evals})
        return [e.id for e in evals]

    # -- reads -------------------------------------------------------------

    def stats(self) -> dict:
        out = {
            "leader": self._leader,
            "applied_index": self.raft.applied_index(),
            "broker": self.eval_broker.stats(),
            "blocked": self.blocked_evals.stats(),
            "plan_queue_depth": self.plan_queue.depth(),
            "heartbeat_active": self.heartbeat.active(),
        }
        if self._events_enabled:
            out["events"] = self.event_broker.stats()
        return out
