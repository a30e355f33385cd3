"""The port's in-process server: jobs in, running allocations out (a slim
copy of ``nomad_tpu/server/server.py``; reference nomad/server.go:78-305,
nomad/leader.go:28-641).

It wires the control plane of one server: the eval broker, blocked
evals, the plan queue, the FSM and its leader-side hooks over the log,
the queue-driven ``PlanApplier``, the heartbeat timers, and
``num_schedulers`` ``BatchWorker``\\ s that run ``TorchBatchScheduler`` on
the card (``device="cuda"``, the default), on the CPU (``device="cpu"``)
or node-sharded over a ``NodeMesh`` (``mesh``).

The log (server.py:263-278): ``MultiRaft`` when the server is clustered
(``enable_rpc`` with ``bootstrap_expect > 1``, a ``start_join`` or
``force_multi_raft``; its state in ``data_dir/raft`` when a data dir is
given), else ``FileLog`` in ``data_dir``, else an ``InmemLog``.  A server
without ``enable_rpc`` is the single voter it always was.

The cluster (server.py:210-287, :460-735, :1288, :1655-1666): with
``enable_rpc`` the server binds an ``RPCServer`` (``server/rpc.py``,
struct-codec frames, the endpoints of ``server/endpoints.py`` and the
raft channel) and advertises ``rpc_advertise``'s host with the bound
port.  Membership is serf-lite over that port (:meth:`Server.join`,
:meth:`Server.members`, :meth:`Server.force_leave`; ``start_join``
retries in the background): the seed server (no ``start_join``)
bootstraps the voter set once ``bootstrap_expect`` members are alive, and
the leader adds later members through a replicated configuration
change; ``non_voting`` members replicate as learners.  Every write method
forwards to the leader on ``NotLeaderError`` (one hop).  The leader's
batch workers stay on ``device``; with ``follower_scheduling`` each
clustered server also runs ``follower_schedulers`` (0: as many as
``num_schedulers``) ``FollowerWorker``\\ s that, while it follows, pull
evals from the leader's broker, schedule them on the CPU schedulers
against the local replica and forward the plans (``Plan.Submit``).
A new leader first applies the entries of earlier terms (a barrier
retried every ``LEADER_BARRIER_TIMEOUT``, as Go Nomad's leaderLoop does;
leadership lost first establishes nothing), so its restores see every
write its predecessor acknowledged.
Leadership raises the plan queue's fence floor to the log's last index,
so no follower schedules off a replica missing a pre-failover plan.
:meth:`Server.fsm_fingerprint` digests the committed store at an entry
boundary, for cross-server checks.  The raft timing and the snapshot
chunk are ``raft_heartbeat``, ``raft_election_min``/``max`` and
``snapshot_chunk`` (the reference's ``NOMAD_TPU_RAFT_*`` and
``NOMAD_TPU_SNAPSHOT_CHUNK``).

Durability (server.py:47, :270-278): with a ``data_dir`` every
acknowledged write is in the log's WAL before it applies; a server built
on the same directory after a crash recovers the newest FSM snapshot and
the WAL past it before it starts (the torn last frame of a crash is
truncated, never applied), and its leadership then re-enqueues the
pending evals and re-blocks the blocked ones it finds in the restored
store.  The snapshot thresholds are ``snapshot_entries``,
``snapshot_bytes`` and ``snapshot_interval``.

The single voter leads from :meth:`Server.start`.  Leadership enables the
broker, the plan queue, blocked evals, the periodic dispatcher and the
heartbeats, starts the applier, reseeds the tenancy plane (the namespace
policies and a conservative rebuild of the quota ledgers), re-enqueues
pending and re-blocks blocked evals from the store, tracks the periodic
jobs (launching the ones whose launch was missed), and starts the
reapers (duplicate blocked evals, coalesced evals, the periodic unblock
of max-plan failures, and the GC core evals every
``eval_gc_interval``).  On ``cuda``, :meth:`start`
builds the kernels in the calling thread first: a card that is missing
or a build that fails raises there, instead of nacking every eval in a
worker thread.

Entry points: :meth:`Server.node_register`,
:meth:`Server.node_deregister`, :meth:`Server.node_update_status`,
:meth:`Server.node_update_drain`, :meth:`Server.node_update_allocs` (the
client's alloc status sync), :meth:`Server.job_register`,
:meth:`Server.job_evaluate`, :meth:`Server.job_deregister`,
:meth:`Server.job_plan` (the ``job plan`` dry run: the annotated diff
and a periodic job's next launch, nothing committed),
:meth:`Server.job_dispatch`, :meth:`Server.periodic_force`,
:meth:`Server.system_gc`, :meth:`Server.system_reconcile_summaries`,
:meth:`Server.namespace_upsert`, :meth:`Server.namespace_delete`,
:meth:`Server.namespace_list`, :meth:`Server.namespace_status`,
:meth:`Server.broker_stats`, :meth:`Server.shutdown`.  The metrics
emitter publishes the broker, blocked-eval, plan-queue, heartbeat and
log gauges and the kernel breaker's ``breaker.state``/``breaker.trips``
each second, and on the same tick feeds the tenancy plane: the store's
changed per-namespace usage into the broker's DRF order, the cluster
capacity, and the ``tenant.*`` gauges of the ``tenancy_metrics_top``
busiest tenants.

The job lifecycle (server.py:1160-1185, :1306-1355, :1383-1445,
:1583-1640): a periodic or parameterized registration makes no eval; the
leader's ``PeriodicDispatch`` launches a periodic job's children
(``<id>/periodic-<launch>``, skipped under ``prohibit_overlap`` while a
child is live) and records each launch; :meth:`Server.job_dispatch`
registers a parameterized job's child (``<id>/dispatch-<now>-<uuid8>``)
with its payload and meta.  Each job that makes an eval is first
admitted against its namespace: the pending-eval quota in the broker,
then the live-alloc and node-units quotas in the leader's ledgers (a
refusal raises ``BrokerLimitError`` naming the namespace; nothing is
written).  A reservation is released when the job's eval goes terminal
or the job is deregistered.  GC runs as core evals through the
leader's worker (``CoreScheduler``).

Observability (server.py:150-157, :289-315, :392-440): ``ServerConfig(
trace=True)`` arms the process-wide tracing plane at construction (the
reference's ``NOMAD_TPU_TRACE``); an eval's ``eval.e2e`` umbrella opens
at :meth:`Server.job_register` or :meth:`Server.job_evaluate` and closes
at its broker ack; :meth:`Server.trace_for_eval` returns its timeline.
``ServerConfig(events=True)`` (``NOMAD_TPU_EVENTS``) arms this server's
cluster event stream at construction, and the first
:meth:`Server.event_stream_subscribe` arms it lazily; the ring holds
``events_ring`` events (``NOMAD_TPU_EVENTS_RING``).

The flight-recorder plane (server.py:158-163, :438, :953-985): a
non-empty ``blackbox_dir`` arms the process-wide flight recorder
(``utils/blackbox.py``) at construction and ``contprof_hz`` > 0 the
continuous profiler (``utils/contprof.py``), as ``trace`` arms the
tracer; every server registers with the recorder at construction and
unregisters at :meth:`shutdown`, so a bundle holds its stats, metrics,
breaker and config.  The metrics tick adds the ``cpu.<subsystem>`` shares
and ``runtime.gil_delay_p50_ms``/``p99_ms`` while the profiler is armed,
and with ``slo_plan_p99_ms`` > 0 the plan-apply SLO watch: a tick whose
``plan.apply`` p99 is over it triggers a ``slo.plan_apply_p99`` bundle.

Vault (server.py:164-168, :332-335, :724-753, :867-884, :1112-1146,
:1822, :1896): ``ServerConfig.vault`` (a ``server.vault.VaultConfig``)
enables the vault client, and ``Server(vault_api=)`` injects its
transport (``FakeVault`` in tests; ``HTTPVault`` at the config's address
otherwise).  Every server renews its own token; the leader activates the
client, revokes the accessors of terminal allocs, of down or
deregistered nodes and the stale ones it finds at leadership, and
retries failed revocations every ``VAULT_REVOKE_INTERVAL`` s until the
token's TTL.  :meth:`Server.derive_vault_token` (``Node.DeriveVaultToken``)
mints a task's tokens, response-wrapped unless
``VaultConfig.wrap_derived_tokens`` is off, and registers their accessors
through the log before it answers.

The federation (server.py:54-56, :340, :636, :1187-1286): ``wan_join``
lists servers of other regions to join (membership only, never this
region's raft quorum).  A request for another region (an explicit
``region``, or a job whose region membership knows) goes to an alive
server of that region (:meth:`Server._forward_region`): a bounded number
of rounds (``REGION_DIAL_ROUNDS``) over its servers with a shared
jittered backoff between them, only dial failures rotating, and a
``NoPathToRegion`` with a ``retry_after`` hint (at most
``REGION_RETRY_AFTER_CAP`` s) when every dial failed.  A request that
already took its region hop is never forwarded again.
"""
from __future__ import annotations

import logging
import math
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .. import device as device_mod
from ..ops import batch_sched
from ..ops import breaker as breaker_mod
from ..scheduler.annotate import annotate
from ..scheduler.scheduler import new_scheduler
from ..scheduler.testing import Harness
from ..state import columnar as columnar_mod
from ..state.state_store import StateStore, VaultAccessor, WatchSet
from ..structs import structs as s
from ..structs.diff import job_diff
from ..tenancy import QuotaLedger, RateLimiter
from ..utils import blackbox, contprof, tracing
from ..utils.telemetry import Telemetry
from ..utils.tlsutil import TLSConfig, client_context, server_context
from . import event_broker as event_stream
from .blocked_evals import BlockedEvals
from .eval_broker import BrokerLimitError, EvalBroker
from .event_broker import EventBroker, Subscription
from .fsm import FSM, MessageType, TimeTable
from .heartbeat import HeartbeatTimers
from .periodic import PERIODIC_LAUNCH_SUFFIX, PeriodicDispatch
from .plan_apply import PlanApplier
from .plan_queue import PlanQueue
from .raft import FileLog, InmemLog, MultiRaft, NotLeaderError
from .rpc import DialError, NoPathToRegion
from .vault import ServerVaultClient, VaultConfig, VaultError
from .worker import BatchWorker, Worker

# Bound on every join at shutdown, per thread.
JOIN_TIMEOUT = 5.0
# How long one round of a new leader's wait for the entries of earlier
# terms to apply lasts before it is logged and retried (the barrier of
# _establish_leadership).
LEADER_BARRIER_TIMEOUT = 10.0
# The reference's defaults: a region forward's dial rounds and the cap on
# its NoPathToRegion retry hint (NOMAD_TPU_REGION_DIAL_ROUNDS,
# NOMAD_TPU_REGION_RETRY_AFTER_CAP), and the vault revoke daemon's retry
# cadence (ServerConfig.vault_revoke_interval there).
REGION_DIAL_ROUNDS = 3
REGION_RETRY_AFTER_CAP = 5.0
VAULT_REVOKE_INTERVAL = 5.0
# The reference's defaults: how often evals blocked by max-plan failures
# are retried, and how often the gauges are published.
FAILED_EVAL_UNBLOCK_INTERVAL = 60.0
METRICS_INTERVAL = 1.0
# A dispatched payload's largest size (job_endpoint.go Dispatch).
DISPATCH_PAYLOAD_MAX = 16 * 1024


def _job_usage_vec(job: s.Job) -> Tuple[int, int, int, int]:
    """A job's whole ask on the alloc_usage_vec basis (cpu, memory_mb,
    disk_mb, iops): each group's task sums times its count.  The
    node-units gate prices a submission with it before any alloc exists
    (server.py:118)."""
    cpu = mem = disk = iops = 0
    for tg in job.task_groups:
        c = m = d = i = 0
        for task in tg.tasks:
            r = task.resources
            if r is None:
                continue
            c += r.cpu
            m += r.memory_mb
            d += r.disk_mb
            i += r.iops
        cpu += c * tg.count
        mem += m * tg.count
        disk += d * tg.count
        iops += i * tg.count
    return (cpu, mem, disk, iops)


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
    ``dispatch`` is the batch scheduler's single-card device program
    (``"fused"``, ``"two_pass"`` or ``"staged"``; the reference's
    ``NOMAD_TPU_FUSED`` and ``NOMAD_TPU_TIMING=2``).
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
    turn it off).

    The cluster (nomad/config.go RPCAddr, BootstrapExpect, serf join):
    ``enable_rpc`` binds the listener on ``rpc_bind``:``rpc_port`` (0:
    ephemeral), ``rpc_advertise``'s host is advertised with the bound
    port, ``node_name`` and ``region`` name the member, and
    ``bootstrap_expect``, ``start_join``, ``non_voting`` and
    ``force_multi_raft`` shape the raft (see the module docstring).
    ``follower_scheduling`` (the reference's ``NOMAD_TPU_FOLLOWER_SCHED``,
    default on) and ``follower_schedulers`` size the follower workers.
    ``raft_heartbeat``, ``raft_election_min``, ``raft_election_max`` and
    ``snapshot_chunk`` are ``MultiRaft``'s timing and InstallSnapshot
    chunk (the reference's ``NOMAD_TPU_RAFT_HEARTBEAT_S``,
    ``NOMAD_TPU_RAFT_ELECTION_MIN_S``/``MAX_S``,
    ``NOMAD_TPU_SNAPSHOT_CHUNK``).  ``tls`` (a ``utils.tlsutil.TLSConfig``)
    puts the listener and every dial of the pool on mutual TLS against
    the cluster CA (the reference's tls{} block).

    The lifecycle: ``eval_gc_interval`` is how often the leader makes
    the eval, job and node GC core evals; ``tenancy_objective`` is the
    cluster-wide fair-dequeue objective a namespace row's ``objective``
    overrides (the reference's ``NOMAD_TPU_TENANCY_OBJECTIVE``), and
    ``tenancy_metrics_top`` how many of the busiest tenants get
    ``tenant.*`` gauges each tick (``NOMAD_TPU_TENANCY_METRICS_TOP``).
    ``broker_max_pending`` bounds the eval broker's pending evals (0:
    unbounded) and ``broker_coalesce`` turns its per-job coalescing on
    (the reference's ``NOMAD_TPU_BROKER_MAX_PENDING`` and
    ``NOMAD_TPU_BROKER_COALESCE``).  ``broker_seed`` seeds the broker's
    draw among ready schedulers of equal priority (None: the ``random``
    module's), so two servers fed alike form the same batches.

    The flight-recorder plane (the module docstring): ``blackbox_dir``
    (empty: disarmed), ``blackbox_min_interval_s`` and
    ``blackbox_max_bundles`` arm the recorder (the reference's
    ``NOMAD_TPU_BLACKBOX``, ``NOMAD_TPU_BLACKBOX_DIR``,
    ``NOMAD_TPU_BLACKBOX_MIN_INTERVAL_S`` and ``_MAX_BUNDLES``);
    ``slo_plan_p99_ms`` (0: off) is the plan-apply SLO watch's bound
    (``NOMAD_TPU_BLACKBOX_SLO_PLAN_P99_MS``); ``contprof_hz`` (0: off)
    arms the continuous profiler at that rate (``NOMAD_TPU_CONTPROF`` and
    ``NOMAD_TPU_CONTPROF_HZ``).  All are process-wide: a later server's
    values do not re-arm a plane that is already armed.

    Vault and the federation (the module docstring): ``vault`` (None:
    disabled) and ``wan_join``.  ``chaos_endpoints`` registers
    ``Chaos.SetNet``/``Chaos.Status`` on the listener (the reference's
    ``NOMAD_TPU_CHAOS``): a load harness drives a child server's side of
    a partition with them."""

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
    dispatch: str = "fused"
    trace: bool = False
    events: bool = False
    events_ring: int = 4096
    data_dir: str = ""
    snapshot_entries: int = 8192
    snapshot_bytes: int = 64 << 20
    snapshot_interval: float = 1.0
    region: str = "global"
    node_name: str = "server-1"
    enable_rpc: bool = False
    rpc_bind: str = "127.0.0.1"
    rpc_port: int = 0
    rpc_advertise: str = "127.0.0.1:4647"
    bootstrap_expect: int = 1
    start_join: List[str] = field(default_factory=list)
    non_voting: bool = False
    force_multi_raft: bool = False
    follower_scheduling: bool = True
    follower_schedulers: int = 0
    raft_heartbeat: float = MultiRaft.HEARTBEAT_INTERVAL
    raft_election_min: float = MultiRaft.ELECTION_TIMEOUT[0]
    raft_election_max: float = MultiRaft.ELECTION_TIMEOUT[1]
    snapshot_chunk: int = MultiRaft.SNAPSHOT_CHUNK
    tls: Optional[TLSConfig] = None
    eval_gc_interval: float = 300.0
    tenancy_objective: str = s.TENANCY_OBJECTIVE_DRF
    tenancy_metrics_top: int = 10
    broker_max_pending: int = 0
    broker_coalesce: bool = True
    broker_seed: Optional[int] = None
    blackbox_dir: str = ""
    blackbox_min_interval_s: float = blackbox.DEFAULT_MIN_INTERVAL_S
    blackbox_max_bundles: int = blackbox.DEFAULT_MAX_BUNDLES
    slo_plan_p99_ms: float = 0.0
    contprof_hz: float = 0.0
    vault: Optional[VaultConfig] = None
    wan_join: List[str] = field(default_factory=list)
    chaos_endpoints: bool = False


class Server:
    """A single control-plane server (nomad/server.go:78 Server)."""

    def __init__(self, config: Optional[ServerConfig] = None,
                 logger: Optional[logging.Logger] = None,
                 vault_api=None):
        self.config = config or ServerConfig()
        cfg = self.config
        batch_sched.check_dispatch(cfg.dispatch)
        if cfg.mesh is not None:
            self.device = cfg.mesh.root
        else:
            self.device = device_mod.resolve_device(cfg.device)
        self.logger = logger or logging.getLogger("nomad_tpu_torch.server")
        self.metrics = Telemetry()
        # The tracing plane, the continuous profiler and the flight
        # recorder are process-wide and off by default.
        if cfg.trace and not tracing.enabled():
            tracing.enable()
        if cfg.contprof_hz > 0:
            contprof.enable(hz=cfg.contprof_hz)
        if cfg.blackbox_dir:
            blackbox.enable(cfg.blackbox_dir,
                            min_interval_s=cfg.blackbox_min_interval_s,
                            max_bundles=cfg.blackbox_max_bundles)
        blackbox.register_server(self)
        # The vault client (vault.go:234); ``vault_api`` injects the
        # transport (the fake in tests, vault_testing.go's role).
        self.vault = ServerVaultClient(cfg.vault or VaultConfig(),
                                       api=vault_api,
                                       logger=self.logger.getChild("vault"))
        self._leader = False
        # Set once the leadership callbacks below have run; is_leader()
        # turns true before them.
        self._leadership_ready = threading.Event()
        self._shutdown = threading.Event()

        self.eval_broker = EvalBroker(
            nack_timeout=cfg.eval_nack_timeout,
            delivery_limit=cfg.eval_delivery_limit,
            metrics=self.metrics,
            max_pending=cfg.broker_max_pending,
            coalesce=cfg.broker_coalesce,
            rng=(random.Random(cfg.broker_seed)
                 if cfg.broker_seed is not None else None))
        self.eval_broker.set_objective(cfg.tenancy_objective)
        # The tenancy plane (server.py:182-195): the leader-side
        # reservation books of the live-alloc and node-units quotas, and
        # the per-tenant API token buckets, mirrors of the committed
        # namespace rows pushed through the FSM hook.
        self.quota_ledger = QuotaLedger()
        self.node_units_ledger = QuotaLedger()
        self.api_limiter = RateLimiter()
        # The cluster capacity the DRF shares and the node-units gate
        # divide by, recomputed only when the nodes table moves.
        self._capacity_node_index = -1
        self._cluster_capacity: Tuple[int, int, int, int] = (0, 0, 0, 0)
        self._cluster_nodes = 0
        self.blocked_evals = BlockedEvals(self.eval_broker)
        self.plan_queue = PlanQueue()
        self.time_table = TimeTable()
        self.fsm = FSM(state=StateStore(columnar=cfg.columnar),
                       logger=self.logger,
                       on_eval_update=self._fsm_eval_updated,
                       on_unblock=self._fsm_unblock,
                       on_job_register=self._fsm_job_registered,
                       on_job_deregister=self._fsm_job_deregistered,
                       on_alloc_terminal=self._fsm_alloc_terminal,
                       on_namespace_update=self._fsm_namespace_updated)
        # The RPC listener and the connection pool (server.go:250
        # setupRPC), bound here so the advertised address is known before
        # the raft is built; served from start().
        self.rpc = None
        self.pool = None
        self._members: Dict[tuple, Dict] = {}
        self._members_lock = threading.Lock()
        # The incarnation of this server's own member record (serf's
        # refutation counter): bumped past any gossiped 'left' about us.
        self._status_time = 1
        # Set on a thread serving a request that was already forwarded
        # once (endpoints.py): it blocks a second hop.
        self._fwd_ctx = threading.local()
        if cfg.enable_rpc:
            from .rpc import ConnPool, RPCServer

            tls_cfg = cfg.tls or TLSConfig()
            self.pool = ConnPool(tls_context=client_context(tls_cfg))
            self.rpc = RPCServer(host=cfg.rpc_bind, port=cfg.rpc_port,
                                 logger=self.logger.getChild("rpc"),
                                 tls_context=server_context(tls_cfg),
                                 metrics=self.metrics)
            # Advertise the configured host (never a wildcard bind) with
            # the port actually bound (config.go AdvertiseAddrs).
            adv_host = cfg.rpc_advertise.rsplit(":", 1)[0] \
                if cfg.rpc_advertise else ""
            if not adv_host or adv_host == "0.0.0.0":
                adv_host = (cfg.rpc_bind if cfg.rpc_bind != "0.0.0.0"
                            else "127.0.0.1")
            cfg.rpc_advertise = f"{adv_host}:{self.rpc.port}"
            # The chaos identity: the pool carries this server's address,
            # so partition groups and asymmetric net rules tell its
            # traffic apart (one process hosting several servers enforces
            # a partition on every side it owns).
            self.pool.local_addr = cfg.rpc_advertise
        # The log (server.go:257 setupRaft): the replicated log when
        # clustered, else the durable single voter when a data dir is
        # given (which recovers the store here), else the in-memory one.
        multi = cfg.enable_rpc and (cfg.bootstrap_expect > 1
                                    or bool(cfg.start_join)
                                    or cfg.force_multi_raft)
        if multi:
            self.raft = MultiRaft(
                self.fsm, cfg.rpc_advertise, self.pool,
                data_dir=(os.path.join(cfg.data_dir, "raft")
                          if cfg.data_dir else None),
                logger=self.logger.getChild("raft"),
                heartbeat_interval=cfg.raft_heartbeat,
                election_timeout=(cfg.raft_election_min,
                                  cfg.raft_election_max),
                snapshot_chunk=cfg.snapshot_chunk)
        elif cfg.data_dir:
            self.raft = FileLog(
                self.fsm, cfg.data_dir,
                snapshot_entries=cfg.snapshot_entries,
                snapshot_bytes=cfg.snapshot_bytes,
                snapshot_interval=cfg.snapshot_interval)
        else:
            self.raft = InmemLog(self.fsm)
        self.raft.metrics = self.metrics
        if self.rpc is not None:
            from .endpoints import register_endpoints

            register_endpoints(self, self.rpc)
            if isinstance(self.raft, MultiRaft):
                self.rpc.raft_handler = self.raft.handle_message
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
        self.periodic = PeriodicDispatch(self._periodic_dispatch,
                                         self.logger.getChild("periodic"))
        self.workers: List[BatchWorker] = []
        self.follower_workers: List[Worker] = []
        self.leader_channel = None
        self._threads: List[threading.Thread] = []

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Build the kernels (on a card), serve RPC, start the raft and
        membership, start the workers and the metrics emitter, and follow
        leadership (server.go:250-284, leader.go:28)."""
        if self.device.type == "cuda":
            device_mod.build_kernels()
        if self.rpc is not None:
            self.rpc.start()
            self._merge_members([self._self_member()])
        # Every server keeps its own vault token alive, leader or not
        # (vault.go:467: the renewal starts at construction).
        if self.vault.enabled and self.vault.config.token:
            self.vault.start_renewal()
        if isinstance(self.raft, MultiRaft):
            self.raft.start()
            self._maybe_bootstrap()
        if self.rpc is not None and (self.config.start_join
                                     or self.config.wan_join):
            t = threading.Thread(target=self._join_loop, daemon=True,
                                 name="serf-join")
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._emit_metrics_loop, daemon=True,
                             name="metrics-emitter")
        t.start()
        self._threads.append(t)
        cfg = self.config
        sched_kwargs = {"rng_seed": cfg.rng_seed,
                        "preemption_enabled": cfg.preemption_enabled,
                        "columnar_guard_every": cfg.columnar_guard_every,
                        "dispatch": cfg.dispatch}
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
                scheduler_kwargs=sched_kwargs, time_table=self.time_table,
                max_batch=cfg.batch_size, pipeline=cfg.pipeline))
        # Follower-read scheduling (server.py:364-389): a pool per
        # clustered server.  Its workers park while this server leads (the
        # batch workers above own the broker there) and pull from the
        # leader otherwise: both pools exist, one is active.
        n_follow = cfg.follower_schedulers or cfg.num_schedulers
        if (cfg.follower_scheduling and self.pool is not None
                and isinstance(self.raft, MultiRaft) and n_follow > 0):
            from .follower_sched import FollowerWorker, LeaderChannel

            self.leader_channel = LeaderChannel(
                self.pool, self.leader_address,
                my_addr=cfg.rpc_advertise, metrics=self.metrics)
            for _ in range(n_follow):
                self.follower_workers.append(FollowerWorker(
                    self.raft, self.leader_channel, self.is_leader,
                    logger=self.logger, metrics=self.metrics))
        self.raft.notify_leadership(self._leadership_changed)
        for worker in self.workers + self.follower_workers:
            worker.start()

    def shutdown(self) -> None:
        """Stop everything this server started; every join is bounded
        (``JOIN_TIMEOUT`` a thread)."""
        self._shutdown.set()
        self._leader = False
        blackbox.unregister_server(self)
        event_stream.unregister(self.event_broker)
        self.event_broker.close()
        for worker in self.workers + self.follower_workers:
            worker.stop(timeout=JOIN_TIMEOUT)
        self.plan_applier.stop(timeout=JOIN_TIMEOUT)
        self.eval_broker.set_enabled(False)
        self.blocked_evals.set_enabled(False)
        self.plan_queue.set_enabled(False)
        self.periodic.set_enabled(False)
        self.heartbeat.set_enabled(False)
        if self.periodic._thread is not None:
            self.periodic._thread.join(timeout=JOIN_TIMEOUT)
        self.vault.stop()
        if self.vault._renew_thread is not None:
            self.vault._renew_thread.join(timeout=JOIN_TIMEOUT)
        for t in self._threads:
            t.join(timeout=JOIN_TIMEOUT)
        self.raft.close()
        if self.rpc is not None:
            self.rpc.shutdown()
        if self.pool is not None:
            self.pool.close()

    def threads(self) -> List[threading.Thread]:
        """Every thread this server started that is still alive (empty
        after a clean :meth:`shutdown`)."""
        out = [w._thread for w in self.workers + self.follower_workers
               if w._thread is not None]
        out += self.plan_applier.threads() + list(self._threads)
        if self.vault._renew_thread is not None:
            out.append(self.vault._renew_thread)
        if isinstance(self.raft, (FileLog, MultiRaft)):
            out += self.raft.threads()
        if self.rpc is not None:
            out += self.rpc.threads()
        for extra in (self.eval_broker.sweeper(), self.heartbeat.sweeper(),
                      self.blocked_evals._watcher, self.periodic._thread):
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
        (empty while tracing is off)."""
        return tracing.trace_for_eval(eval_id)

    def trace_for_eval_fanout(self, eval_id: str,
                              timeout: float = 1.0) -> Tuple[List, str]:
        """The eval's spans from this process's tracer, else from the
        first peer server that has them over ``Status.TraceEval``
        (server.py:1667): a follower-scheduled eval's spans live on the
        follower.  A peer that does not answer is skipped.  Returns
        ``(spans, source address)``, ``([], "")`` when no one has them."""
        spans = tracing.trace_for_eval(eval_id)
        if spans:
            return spans, self.config.rpc_advertise
        if self.pool is None:
            return [], ""
        me = self.config.rpc_advertise
        for addr in self.peer_addresses():
            if addr == me:
                continue
            try:
                reply = self.pool.call(addr, "Status.TraceEval",
                                       {"EvalID": eval_id}, timeout=timeout)
            except Exception:
                continue
            got = (reply or {}).get("Spans") or []
            if got:
                return got, addr
        return [], ""

    def is_leader(self) -> bool:
        return self._leader

    def leadership_established(self) -> bool:
        """This server leads and its establishment has run: the broker
        holds the restored evals, the blocked tracker the blocked ones,
        and the reapers run."""
        return self._leader and self._leadership_ready.is_set()

    # -- membership (serf-lite over the RPC port; nomad/serf.go) -----------

    def _self_member(self) -> Dict:
        return {"Name": self.config.node_name,
                "Addr": self.config.rpc_advertise,
                "Region": self.config.region,
                "Status": "alive",
                "StatusTime": self._status_time,
                "NonVoter": self.config.non_voting}

    def members(self) -> List[Dict]:
        """(serf.Members, the peer table of nomad/serf.go)."""
        with self._members_lock:
            return sorted(self._members.values(),
                          key=lambda m: (m.get("Region", ""), m["Name"]))

    def join(self, addresses: List[str]) -> int:
        """An operator's join (agent_endpoint.go Join → serf.Join): each
        address's ``Serf.Join`` dialled (two backed-off retries: the join
        is an idempotent merge) and the replies merged; returns how many
        answered."""
        from ..utils.backoff import Backoff, retry

        if self.pool is None:
            raise ValueError("RPC is not enabled")
        me = self._self_member()
        joined = 0
        for addr in addresses:
            try:
                reply = retry(
                    lambda a=addr: self.pool.call(a, "Serf.Join",
                                                  {"Member": me},
                                                  timeout=2.0),
                    retries=2, backoff=Backoff(base=0.1, max_delay=0.5))
                self._merge_members(reply.get("Members") or [])
                joined += 1
            except Exception as e:
                self.logger.warning("server: join %s failed: %s", addr, e)
        return joined

    def force_leave(self, name: str) -> bool:
        """Mark a member as left (serf.RemoveFailedNode) and gossip it,
        with a bumped StatusTime so peers keep 'left' over a stale
        'alive'.  The raft voter set is untouched (removing a voter is a
        configuration change)."""
        changed = False
        with self._members_lock:
            for m in self._members.values():
                if m["Name"] == name:
                    m["Status"] = "left"
                    m["StatusTime"] = int(m.get("StatusTime", 1)) + 1
                    changed = True
            view = list(self._members.values())
        if changed and self.pool is not None:
            self._spawn(self._push_members, view)
        return changed

    def membership_join(self, member: Dict) -> Dict:
        """A peer's ``Serf.Join``: merge, gossip the change, and answer
        with the whole member list (serf.go:51 nodeJoin)."""
        self._merge_members([member])
        return {"Members": self.members()}

    def _merge_members(self, incoming: List[Dict]) -> None:
        """Merge member records; on a change, push our view to the peers
        (the gossip step) and check the bootstrap again (serf.go:91)."""
        added = []
        with self._members_lock:
            for m in incoming:
                name = m.get("Name")
                if not name or not m.get("Addr"):
                    continue
                key = (name, m.get("Region", ""))
                old = self._members.get(key)
                if old is None:
                    added.append(m)
                    self._members[key] = dict(m)
                    continue
                # Refutation: a 'left' about ourselves while we are alive
                # is out-bid by an incarnation past it, gossiped again.
                if (name == self.config.node_name
                        and m.get("Region", "") == self.config.region
                        and m.get("Status") != "alive"
                        and int(m.get("StatusTime", 1)) >= self._status_time):
                    self._status_time = int(m.get("StatusTime", 1)) + 1
                    refreshed = self._self_member()
                    self._members[key] = refreshed
                    added.append(refreshed)
                    continue
                # The newer StatusTime wins, so a gossiped 'left' is not
                # resurrected by a peer's stale 'alive'.
                if int(m.get("StatusTime", 1)) >= \
                        int(old.get("StatusTime", 1)):
                    if m.get("Status") != old.get("Status"):
                        added.append(m)
                    self._members[key] = dict(m)
            view = list(self._members.values())
        if not added:
            return
        self.logger.info("server: membership now %d members (+%s)",
                         len(view), ",".join(m["Name"] for m in added))
        self._maybe_bootstrap()
        if self.pool is not None:
            self._spawn(self._push_members, view)

    def _spawn(self, target, *args) -> None:
        """A short-lived daemon thread (gossip pushes, config proposals);
        skipped once the server is shutting down."""
        if self._shutdown.is_set():
            return
        threading.Thread(target=target, args=args, daemon=True,
                         name=target.__name__).start()

    def _push_members(self, view: List[Dict]) -> None:
        """Anti-entropy: every member we know, sent to every peer.  A
        receiver that learns nothing new does not push again, so this
        ends."""
        me = self.config.rpc_advertise
        for m in view:
            addr = m["Addr"]
            if addr == me:
                continue
            for peer in view:
                if self._shutdown.is_set():
                    return
                try:
                    self.pool.call(addr, "Serf.Join", {"Member": peer},
                                   timeout=1.0)
                except Exception:
                    break  # unreachable: a later join or push recovers

    def _maybe_bootstrap(self) -> None:
        """Initial formation and growth of the voter set (serf.go:91
        maybeBootstrap).  Only a seed server (no ``start_join``) adopts the
        initial set from its view, once ``bootstrap_expect`` members are
        alive; a joiner waits for the leader's CONFIG entry (a quorum
        assembled from a private view could be a second, disjoint one).
        After bootstrap the leader proposes a configuration change when
        membership shows voters it does not have (raft AddVoter)."""
        if not isinstance(self.raft, MultiRaft):
            return
        with self._members_lock:
            local = [m for m in self._members.values()
                     if m.get("Region", self.config.region)
                     == self.config.region]
            addrs = [m["Addr"] for m in local if not m.get("NonVoter")]
            learner_addrs = [m["Addr"] for m in local if m.get("NonVoter")]
        if not self.raft._bootstrapped:
            if self.config.start_join or self.config.non_voting:
                return
            if len(addrs) >= self.config.bootstrap_expect:
                self.raft.bootstrap(addrs)
            return
        if self.raft.is_raft_leader():
            for addr in learner_addrs:
                self.raft.add_learner(addr)
            new = sorted(set(self.raft.peers) | set(addrs))
            if new != sorted(self.raft.peers):
                def propose_config():
                    try:
                        self.raft.propose_config(new)
                    except Exception as e:
                        self.logger.warning(
                            "server: config change failed: %s", e)
                self._spawn(propose_config)

    def _join_loop(self) -> None:
        """Retry the ``start_join`` and ``wan_join`` addresses until each
        answers, with a capped backoff (the agent's retry_join)."""
        pending = list(self.config.start_join) + list(self.config.wan_join)
        me = self._self_member()
        delay = 0.25
        attempts = 0
        while not self._shutdown.is_set() and pending:
            still = []
            for addr in pending:
                try:
                    reply = self.pool.call(addr, "Serf.Join", {"Member": me},
                                           timeout=1.0)
                    self._merge_members(reply.get("Members") or [])
                except Exception:
                    still.append(addr)
            pending = still
            if pending:
                attempts += 1
                if attempts % 20 == 0:
                    self.logger.warning(
                        "server: still unable to join %s after %d attempts",
                        ",".join(pending), attempts)
                self._shutdown.wait(delay)
                delay = min(delay * 1.5, 5.0)

    def consistent_snapshot(self):
        """A copy-on-write store snapshot taken at a log entry boundary:
        the log lock serializes with the applier, so a multi-write apply
        is never seen half landed (server.py:668)."""
        with self.raft._l:
            return self.state.snapshot()

    def fsm_fingerprint(self) -> Tuple[int, str]:
        """(the snapshot's latest write index, the store's digest): equal
        across servers that applied the same committed prefix (entries
        that touch no table bump the index on none of them)."""
        snap = self.consistent_snapshot()
        return snap.latest_index(), snap.fingerprint()

    # -- leadership --------------------------------------------------------

    def _leadership_changed(self, leader: bool) -> None:
        if leader:
            self._establish_leadership()
        else:
            self._revoke_leadership()

    def _leader_barrier(self) -> bool:
        """The barrier of Go Nomad's leaderLoop: the entries of earlier
        terms commit with this term's first entry, and must be applied
        before anything is restored from the store, so the restore sees
        every write the old leader acknowledged.  (The JAX package
        restores at once, and can miss the last one.)  Each round waits
        ``LEADER_BARRIER_TIMEOUT``; a round that runs out is logged and
        retried.  True once applied; False, with nothing established, if
        raft leadership is lost or the server shuts down first."""
        from ..utils.backoff import wait_until

        target = self.raft.fence_index()
        rounds = 0
        while True:
            wait_until(lambda: (self.raft.applied_index() >= target
                                or not self.raft.is_raft_leader()
                                or self._shutdown.is_set()),
                       LEADER_BARRIER_TIMEOUT)
            if self._shutdown.is_set() or not self.raft.is_raft_leader():
                self.logger.warning(
                    "server: leadership lost before the barrier at %d "
                    "applied; not establishing leadership", target)
                return False
            if self.raft.applied_index() >= target:
                return True
            rounds += 1
            self.logger.error(
                "server: barrier at %d not applied after %.1fs (applied "
                "%d, round %d); retrying", target,
                rounds * LEADER_BARRIER_TIMEOUT, self.raft.applied_index(),
                rounds)

    def _establish_leadership(self) -> None:
        """(leader.go:110 establishLeadership), the parts these modules
        have, after :meth:`_leader_barrier` on the replicated log."""
        if isinstance(self.raft, MultiRaft) and not self._leader_barrier():
            return
        self._leader = True
        self.eval_broker.set_enabled(True)
        self.plan_queue.set_enabled(True)
        # Every committed plan is at or below the log's last index: the
        # fence floor for the workers' snapshots.
        self.plan_queue.note_applied("", self.raft.fence_index())
        self.blocked_evals.set_enabled(True)
        self.periodic.set_enabled(True)
        self.heartbeat.set_enabled(True)
        self.plan_applier.start()
        self._restore_tenancy()
        self._restore_evals()
        self._restore_periodic_dispatcher()
        self._start_reapers()
        # Vault activates with leadership (vault.go:290 SetActive): the
        # revocation queue is this server's to drain now.
        self.vault.set_active(True)
        self._restore_revoking_accessors()
        # Reconcile the voters with the members found while following.
        self._maybe_bootstrap()
        self._leadership_ready.set()

    def _restore_revoking_accessors(self) -> None:
        """Revoke the accessors whose alloc or node is terminal or gone:
        the previous leader may have died mid-revocation
        (leader.go:221-260 restoreRevokingAccessors)."""
        if not self.vault.enabled:
            return
        stale = []
        for acc in self.state.vault_accessors(None):
            alloc = self.state.alloc_by_id(None, acc.alloc_id)
            if alloc is None or alloc.terminal_status():
                stale.append(acc)
                continue
            node = self.state.node_by_id(None, acc.node_id)
            if node is None or node.terminal_status():
                stale.append(acc)
        if stale:
            self._spawn(self._revoke_accessors, stale)

    def _revoke_leadership(self) -> None:
        self._leadership_ready.clear()
        self._leader = False
        self.vault.set_active(False)
        self.eval_broker.set_enabled(False)
        self.plan_queue.set_enabled(False)
        self.blocked_evals.set_enabled(False)
        self.periodic.set_enabled(False)
        self.heartbeat.set_enabled(False)
        self.plan_applier.stop(timeout=JOIN_TIMEOUT)

    def _restore_tenancy(self) -> None:
        """Reseed the tenancy plane at leadership (server.py:761-790): the
        fairness and rate policies from the namespace rows, and the quota
        ledgers rebuilt conservatively from every non-terminal eval's job
        (over-reserving only costs refusals near the limit;
        under-reserving could let a failover breach a quota)."""
        for ns in self.state.namespaces(None):
            self._fsm_namespace_updated(ns.name, ns)
        entries = []
        unit_entries = []
        seen = set()
        self._refresh_capacity()
        cap, nodes = self._cluster_capacity, self._cluster_nodes
        for ev in self.state.evals(None):
            if ev.terminal_status() or ev.job_id in seen:
                continue
            seen.add(ev.job_id)
            job = self.state.job_by_id(None, ev.job_id)
            if job is None:
                continue
            ns = job.namespace or s.DEFAULT_NAMESPACE
            entries.append((job.id, ns,
                            sum(tg.count for tg in job.task_groups)))
            if nodes > 0:
                unit_entries.append(
                    (job.id, ns,
                     self._node_units(_job_usage_vec(job), cap, nodes)))
        self.quota_ledger.rebuild(entries)
        self.node_units_ledger.rebuild(unit_entries)
        self.eval_broker.note_usage_changed(self.state.namespace_usage())

    def _restore_periodic_dispatcher(self) -> None:
        """Track the periodic jobs and launch the ones whose next launch
        after the recorded one has passed (leader.go:150)."""
        now = time.time()
        for job in self.state.jobs_by_periodic(None, True):
            self.periodic.add(job)
            launch = self.state.periodic_launch_by_id(None, job.id)
            last = launch.launch if launch else 0.0
            nxt = job.periodic.next(last)
            if last and 0 < nxt <= now:
                self.periodic.force_run(job.id)

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

        def gc_scheduler():
            while self._leader and not self._shutdown.is_set():
                self._shutdown.wait(self.config.eval_gc_interval)
                if not self._leader or self._shutdown.is_set():
                    return
                try:
                    for core_job in (s.CORE_JOB_EVAL_GC, s.CORE_JOB_JOB_GC,
                                     s.CORE_JOB_NODE_GC):
                        self._create_core_eval(core_job)
                except NotLeaderError:
                    return

        def vault_revoke_daemon():
            # Retry the failed revocations until their tokens' TTL
            # (vault.go:1104 revokeDaemon).
            while self._leader and not self._shutdown.is_set():
                self._shutdown.wait(VAULT_REVOKE_INTERVAL)
                if not self._leader or self._shutdown.is_set():
                    return
                try:
                    done = self.vault.tick_revocations()
                except Exception:
                    self.logger.exception("vault revoke daemon")
                    continue
                if done:
                    self._deregister_accessor_rows(done)

        for target in (dup_reaper, shed_reaper, failed_unblocker,
                       gc_scheduler, vault_revoke_daemon):
            t = threading.Thread(target=target, daemon=True,
                                 name=target.__name__)
            t.start()
            self._threads.append(t)

    def _emit_metrics_loop(self) -> None:
        """Periodic gauges (server.go:292-305): the broker, blocked evals,
        the plan queue, heartbeats, the log, the kernel breaker and, while
        armed, the profiler's shares; then the plan-apply SLO watch."""
        while not self._shutdown.is_set():
            try:
                self._feed_tenancy(self.config.tenancy_metrics_top)
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
        prof = contprof.PROFILER
        if prof is not None:
            for sub, share in prof.shares(30.0).items():
                m.set_gauge(f"cpu.{sub}", share)
            gil = prof.gil_pressure_ms()
            m.set_gauge("runtime.gil_delay_p50_ms", gil["p50"])
            m.set_gauge("runtime.gil_delay_p99_ms", gil["p99"])
        self._watch_plan_slo()

    def _watch_plan_slo(self) -> None:
        """The plan-apply p99 SLO watch (server.py:967-985): with
        ``slo_plan_p99_ms`` > 0 and the recorder armed, a current interval
        whose ``plan.apply`` p99 (ms) is over it triggers a
        ``slo.plan_apply_p99`` bundle; the recorder's per-reason interval
        keeps a sustained breach from flooding."""
        slo_ms = self.config.slo_plan_p99_ms
        if not slo_ms or slo_ms <= 0 or not blackbox.enabled():
            return
        summ = self.metrics.sink.latest().get("Samples", {}).get(
            "nomad.plan.apply")
        if not summ or not summ.get("count"):
            return
        p99 = summ.get("p99", 0.0)
        if p99 > slo_ms:
            blackbox.note_trigger(
                "slo.plan_apply_p99",
                {"P99Ms": round(p99, 3), "SloMs": slo_ms,
                 "Count": summ.get("count", 0),
                 "Node": self.config.node_name})

    def _feed_tenancy(self, tenant_top: int) -> None:
        """The tenancy plane's upkeep on the metrics tick
        (server.py:987-1015): the store's changed per-namespace usage
        into the broker's DRF scorer, the cluster capacity refreshed when
        the nodes moved, and the ``tenant.*`` gauges of the
        ``tenant_top`` busiest tenants."""
        dirty = self.state.drain_ns_dirty()
        if dirty:
            usage = self.state.namespace_usage()
            self.eval_broker.note_usage_changed(
                {ns: usage.get(ns, (0, 0, 0, 0, 0)) for ns in dirty})
        self._refresh_capacity()
        if tenant_top <= 0:
            return
        counters = self.eval_broker.tenant_counters()
        busiest = sorted(counters.items(),
                         key=lambda kv: (-kv[1][0], kv[0]))[:tenant_top]
        cap, nodes = self._cluster_capacity, self._cluster_nodes
        for ns, (pending, dequeued, shed, rejects) in busiest:
            self.metrics.set_gauge(f"tenant.pending.{ns}", pending)
            self.metrics.set_gauge(f"tenant.dequeued.{ns}", dequeued)
            self.metrics.set_gauge(f"tenant.shed.{ns}", shed)
            self.metrics.set_gauge(f"tenant.rejects.{ns}", rejects)
            if nodes > 0:
                self.metrics.set_gauge(
                    f"tenant.node_units.{ns}",
                    self._node_units(
                        self.state.namespace_usage_one(ns)[:4], cap, nodes))

    def _refresh_capacity(self) -> None:
        """The cluster capacity (the non-terminal nodes' summed resources
        and their count), recomputed only when the nodes table's index
        moved, and pushed into the broker's DRF scorer."""
        node_index = self.state.table_index("nodes")
        if node_index == self._capacity_node_index:
            return
        self._capacity_node_index = node_index
        cap = [0, 0, 0, 0]
        nodes = 0
        for node in self.state.nodes(None):
            if node.terminal_status():
                continue
            nodes += 1
            res = node.resources
            if res is None:
                continue
            cap[0] += res.cpu
            cap[1] += res.memory_mb
            cap[2] += res.disk_mb
            cap[3] += res.iops
        self._cluster_capacity = tuple(cap)
        self._cluster_nodes = nodes
        self.eval_broker.set_cluster_capacity(self._cluster_capacity)

    @staticmethod
    def _node_units(usage: Tuple[int, int, int, int],
                    cap: Tuple[int, int, int, int], nodes: int) -> float:
        """Nodes-worth of dominant-resource usage (the quota_node_units
        basis): the largest usage/capacity share, times the node count."""
        share = max((u / c) for u, c in zip(usage, cap) if c > 0) \
            if any(cap) else 0.0
        return share * nodes

    def _create_core_eval(self, core_job: str) -> None:
        ev = s.Evaluation(
            id=s.generate_uuid(), priority=s.JOB_MAX_PRIORITY,
            type=s.JOB_TYPE_CORE, triggered_by=s.EVAL_TRIGGER_SCHEDULED,
            job_id=core_job, status=s.EVAL_STATUS_PENDING)
        self.raft.apply(MessageType.EVAL_UPDATE, {"evals": [ev]})

    def breaker(self):
        """The kernel breaker the batch schedulers use."""
        return (self.config.breaker if self.config.breaker is not None
                else breaker_mod.BREAKER)

    # -- FSM hooks (leader side) -------------------------------------------

    def _fsm_eval_updated(self, ev: s.Evaluation) -> None:
        if not self._leader:
            return
        self.time_table.witness(self.raft.applied_index())
        if ev.terminal_status():
            # The job's driving eval is done: its placements are in the
            # usage fold (or never will be), so its admission
            # reservations have served.
            self.quota_ledger.release(ev.job_id)
            self.node_units_ledger.release(ev.job_id)
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

    def _fsm_job_registered(self, job: s.Job) -> None:
        if self._leader and job.is_periodic() and not job.stopped():
            self.periodic.add(job)

    def _fsm_job_deregistered(self, job_id: str) -> None:
        if self._leader:
            self.periodic.remove(job_id)
            self.quota_ledger.release(job_id)
            self.node_units_ledger.release(job_id)

    def _fsm_namespace_updated(self, name: str,
                               ns: Optional[s.Namespace]) -> None:
        """A namespace row changed: refresh the policy mirrors (on every
        server; the fairness weights matter only while leading but are
        cheap to keep warm)."""
        if ns is None:
            self.eval_broker.drop_namespace_policy(name)
            self.api_limiter.drop(name)
            return
        self.eval_broker.set_namespace_policy(
            name, ns.dequeue_weight, ns.objective)
        self.api_limiter.configure(name, ns.api_rate, float(ns.api_burst))

    def _fsm_alloc_terminal(self, alloc_id: str) -> None:
        """A terminal alloc's vault tokens are revoked (vault.go
        RevokeTokens)."""
        if not self._leader or not self.vault.enabled:
            return
        accessors = self.state.vault_accessors_by_alloc(None, alloc_id)
        if accessors:
            self._spawn(self._revoke_accessors, accessors)

    def _revoke_accessors(self, accessors) -> None:
        done = self.vault.revoke_accessors([a.accessor for a in accessors])
        # The failed ones queue for a retry until their TTL (vault.go
        # storeForRevocation; the revoke daemon drains it).
        failed = [a.accessor for a in accessors if a.accessor not in done]
        if failed:
            self.vault.store_for_revocation(failed)
        if not done:
            return
        try:
            self.raft.apply(MessageType.VAULT_ACCESSOR_DEREGISTER,
                            {"accessors": [a for a in accessors
                                           if a.accessor in done]})
        except NotLeaderError:
            pass  # the next leader's restore revokes again (idempotent)

    def _deregister_accessor_rows(self, accessor_ids) -> None:
        """Drop the rows of the accessors the revoke daemon revoked."""
        wanted = set(accessor_ids)
        rows = [a for a in self.state.vault_accessors(None)
                if a.accessor in wanted]
        if not rows:
            return
        try:
            self.raft.apply(MessageType.VAULT_ACCESSOR_DEREGISTER,
                            {"accessors": rows})
        except NotLeaderError:
            pass

    def _periodic_dispatch(self, parent: s.Job, derived: s.Job,
                           launch_time: float) -> None:
        """Register a periodic job's child and record the launch
        (periodic.go:435 createEval).  Under ``prohibit_overlap`` a launch
        is skipped while any earlier child has a live eval or alloc."""
        if parent.periodic and parent.periodic.prohibit_overlap:
            prefix = parent.id + PERIODIC_LAUNCH_SUFFIX
            for child in self.state.jobs_by_id_prefix(None, prefix):
                if any(not ev.terminal_status()
                       for ev in self.state.evals_by_job(None, child.id)):
                    return
                if any(not a.terminal_status()
                       for a in self.state.allocs_by_job(None, child.id)):
                    return
        self.job_register(derived)
        self.raft.apply(MessageType.PERIODIC_LAUNCH_UPSERT,
                        {"job_id": parent.id, "launch": launch_time})

    def _heartbeat_expired(self, node_id: str) -> None:
        """A missed heartbeat marks the node down, which makes node evals
        (heartbeat.go:86)."""
        try:
            self.node_update_status(node_id, s.NODE_STATUS_DOWN)
        except KeyError:
            pass

    # -- jobs --------------------------------------------------------------

    def _check_tenant_admission(self, job: s.Job) -> bool:
        """The per-tenant front door, on the leader, before the log write
        (server.py:1306-1355): the namespace's pending-eval quota (with
        the broker's global cap), then an atomic check and reserve of its
        live-alloc quota, then of its node-units quota.  A refusal raises
        ``BrokerLimitError`` naming the namespace; a bypass-priority
        submission skips the quotas.  Returns whether the broker holds a
        pending slot for the job's eval, which the caller releases once
        the eval is written (``EvalBroker.reserve_admission``)."""
        ns = job.namespace or s.DEFAULT_NAMESPACE
        row = self.state.namespace_by_name(None, ns)
        reserved = self.eval_broker.reserve_admission(
            job.priority, namespace=ns,
            ns_max_pending=row.max_pending_evals if row is not None else 0)
        try:
            self._check_tenant_quotas(job, ns, row)
        except BaseException:
            if reserved:
                self.eval_broker.release_admission(ns)
            raise
        return reserved

    def _check_tenant_quotas(self, job: s.Job, ns: str, row) -> None:
        if row is None or job.priority >= self.eval_broker.bypass_priority:
            return
        count = sum(tg.count for tg in job.task_groups)
        quota = row.max_live_allocs
        if quota > 0:
            live = self.state.namespace_usage_one(ns)[4]
            if not self.quota_ledger.check_and_reserve(
                    ns, job.id, count, live, quota):
                self.eval_broker.note_quota_reject(ns)
                asked = live + self.quota_ledger.reserved(ns) + count
                retry_after = min(5.0, 0.2 + 0.3 * (asked / quota))
                raise BrokerLimitError(retry_after, asked, quota,
                                       namespace=ns)
        units_quota = row.quota_node_units
        if units_quota > 0:
            self._refresh_capacity()
            cap, nodes = self._cluster_capacity, self._cluster_nodes
            if nodes > 0:
                used = self._node_units(
                    self.state.namespace_usage_one(ns)[:4], cap, nodes)
                ask = self._node_units(_job_usage_vec(job), cap, nodes)
                if not self.node_units_ledger.check_and_reserve(
                        ns, job.id, ask, used, units_quota):
                    # The registration is refused: roll back the
                    # live-alloc reservation made above.
                    self.quota_ledger.release(job.id)
                    self.eval_broker.note_quota_reject(ns)
                    asked = used + self.node_units_ledger.reserved(ns) + ask
                    retry_after = min(
                        5.0, 0.2 + 0.3 * (asked / units_quota))
                    raise BrokerLimitError(
                        retry_after, math.ceil(asked),
                        math.ceil(units_quota), namespace=ns)

    # -- regions (region_endpoint.go) -------------------------------------

    # How long /v1/regions?detail waits for a remote region's leader
    # (the reference's NOMAD_TPU_REGION_PROBE_TIMEOUT default).
    REGION_PROBE_TIMEOUT = 1.0

    def regions(self) -> List[str]:
        """The regions known through membership (region_endpoint.go
        List over the WAN members)."""
        out = {self.config.region}
        for m in self.members():
            r = m.get("Region")
            if r:
                out.add(r)
        return sorted(out)

    def region_info(self) -> List[Dict]:
        """Per region: name, alive servers and the best-known leader
        (server.py:1197).  The home region answers from its raft; another
        region's leader is a bounded ``Status.Leader`` probe of one of its
        alive members ("" when none answers)."""
        by_region: Dict[str, List[Dict]] = {}
        for m in list(self.members()) + [self._self_member()]:
            r = m.get("Region", "")
            if r and m.get("Status", "alive") == "alive":
                rows = by_region.setdefault(r, [])
                if not any(x.get("Name") == m.get("Name") for x in rows):
                    rows.append(m)
        out = []
        for region in sorted(by_region):
            members = by_region[region]
            leader = ""
            if region == self.config.region:
                leader = self.leader_address()
            elif self.pool is not None:
                for m in members:
                    try:
                        reply = self.pool.call(
                            m["Addr"], "Status.Leader", {},
                            timeout=self.REGION_PROBE_TIMEOUT)
                        leader = (reply if isinstance(reply, str)
                                  else (reply or {}).get("Leader", ""))
                        break
                    except Exception:
                        continue
            out.append({"Name": region, "Servers": len(members),
                        "Leader": leader})
        return out

    def _forward_region(self, region: str, wire_method: str, body: Dict):
        """A request for another region, sent to an alive server of it
        (nomad/rpc.go:263 forwardRegion over the WAN members; server.py:
        1235).  It does not take the one leader-forward hop: the remote
        server may still forward to its own leader.

        A dark region is a ``NoPathToRegion`` with a ``retry_after`` hint,
        never a hang: ``REGION_DIAL_ROUNDS`` rounds over the region's
        known servers with the shared jittered ``Backoff`` between them;
        within a round only dial failures rotate (the request was never
        sent, so the next server cannot apply it twice).  The dials ride
        ``self.pool``, whose per-address dial gate the raft and leader
        forwards share, so a region that just went dark fails fast."""
        from ..utils.backoff import Backoff

        if getattr(self._fwd_ctx, "region_hop", False):
            # Already took its region hop: stale member records must not
            # bounce it between regions.
            raise ValueError(
                f"request for region {region!r} arrived at "
                f"{self.config.region!r} after a region forward")
        candidates = [m for m in self.members()
                      if m.get("Region") == region
                      and m.get("Status", "alive") == "alive"]
        if not candidates or self.pool is None:
            raise ValueError(f"no servers known in region {region!r}")
        body = dict(body)
        body["Region"] = region
        body["__region_hop__"] = True
        rounds = REGION_DIAL_ROUNDS
        bo = Backoff(base=0.05, max_delay=2.0)
        last: Optional[Exception] = None
        for round_no in range(rounds):
            if round_no and self._shutdown.wait(bo.next_delay()):
                break
            for m in candidates:
                # A server of the region stopped since the last forward
                # left its pooled connections dead: dropped before the
                # send, so it fails as a dial and rotates.
                self.pool.drop_stale(m["Addr"])
                try:
                    return self.pool.call(m["Addr"], wire_method, body)
                except DialError as e:
                    # Only a dial failure rotates: after a send the
                    # request may have applied remotely, and application
                    # errors propagate as they are.
                    last = e
        retry_after = min(REGION_RETRY_AFTER_CAP,
                          0.5 + 0.5 * rounds)
        raise NoPathToRegion(region, retry_after, rounds=rounds,
                             detail=str(last) if last else "")

    def job_register(self, job: s.Job, region: str = "") -> Tuple[int, str]:
        """(job_endpoint.go:47 Register): validate, then the job and, unless
        it is periodic or parameterized, its registration eval through
        the log.  Returns (modify_index, eval_id); the eval id is empty
        when no eval was made.  An explicit ``region`` other than this
        server's, or a job's region that membership knows, routes there
        (:meth:`_forward_region`)."""
        target = region or job.region
        if target and target != self.config.region and (
                region or target in self.regions()):
            reply = self._forward_region(target, "Job.Register",
                                         {"Job": job})
            return reply["Index"], reply["EvalID"]
        job = job.copy()
        job.canonicalize()
        problems = job.validate()
        if problems:
            raise ValueError("job validation failed: " + "; ".join(problems))
        # Admission at the front door, before anything is written; only
        # evals-to-be are gated.
        makes_eval = not job.is_periodic() and not job.is_parameterized()
        reserved = (self._check_tenant_admission(job)
                    if self._leader and makes_eval else False)
        try:
            return self._register_job(job, makes_eval)
        finally:
            if reserved:
                self.eval_broker.release_admission(job.namespace)

    def _register_job(self, job: s.Job, makes_eval: bool) -> Tuple[int, str]:
        try:
            _, index = self.raft.apply(MessageType.JOB_REGISTER,
                                       {"job": job})
        except NotLeaderError as e:
            reply = self._forward("Job.Register", {"Job": job}, e)
            return reply["Index"], reply["EvalID"]
        if not makes_eval:
            return index, ""
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
        if job.is_periodic():
            raise ValueError("can't evaluate periodic job")
        if job.is_parameterized():
            raise ValueError("can't evaluate parameterized job")
        reserved = (self._check_tenant_admission(job) if self._leader
                    else False)
        try:
            return self._evaluate_job(job_id, job)
        finally:
            if reserved:
                self.eval_broker.release_admission(job.namespace)

    def _evaluate_job(self, job_id: str, job: s.Job) -> Tuple[int, str]:
        ev = s.Evaluation(
            id=s.generate_uuid(), priority=job.priority, type=job.type,
            namespace=job.namespace,
            triggered_by=s.EVAL_TRIGGER_JOB_REGISTER, job_id=job.id,
            job_modify_index=job.modify_index, status=s.EVAL_STATUS_PENDING)
        tr = tracing.TRACER
        if tr is not None:
            tr.mark(ev.id, job_id=job.id, submit="job_evaluate",
                    priority=job.priority, namespace=job.namespace)
        try:
            _, index = self.raft.apply(MessageType.EVAL_UPDATE,
                                       {"evals": [ev]})
        except NotLeaderError as e:
            reply = self._forward("Job.Evaluate", {"JobID": job_id}, e)
            return reply["Index"], reply["EvalID"]
        return index, ev.id

    def job_deregister(self, job_id: str, purge: bool = True,
                       region: str = "") -> Tuple[int, str]:
        """(job_endpoint.go Deregister): the job stopped (or purged) and,
        unless it is periodic or parameterized, a deregistration eval
        (the eval id is empty then)."""
        if region and region != self.config.region:
            reply = self._forward_region(region, "Job.Deregister",
                                         {"JobID": job_id, "Purge": purge})
            return reply["Index"], reply["EvalID"]
        job = self.state.job_by_id(None, job_id)
        if job is None:
            raise KeyError(f"job not found: {job_id}")
        try:
            _, index = self.raft.apply(MessageType.JOB_DEREGISTER,
                                       {"job_id": job_id, "purge": purge})
        except NotLeaderError as e:
            reply = self._forward("Job.Deregister",
                                  {"JobID": job_id, "Purge": purge}, e)
            return reply["Index"], reply["EvalID"]
        if job.is_periodic() or job.is_parameterized():
            return index, ""
        ev = s.Evaluation(
            id=s.generate_uuid(), priority=job.priority, type=job.type,
            namespace=job.namespace,
            triggered_by=s.EVAL_TRIGGER_JOB_DEREGISTER, job_id=job_id,
            job_modify_index=index, status=s.EVAL_STATUS_PENDING)
        self.raft.apply(MessageType.EVAL_UPDATE, {"evals": [ev]})
        return index, ev.id

    def job_list(self, prefix: str = "", region: str = "",
                 min_index: int = 0,
                 max_wait: float = 0.0) -> Tuple[List[s.Job], int]:
        """The jobs (by id prefix) and the jobs table's index; with
        ``min_index`` a blocking query of at most ``max_wait`` s
        (server.py:1443)."""
        if region and region != self.config.region:
            # The blocking query runs at the owning region (rpc.go:340).
            reply = self._forward_region(
                region, "Job.List",
                {"Prefix": prefix, "MinQueryIndex": min_index,
                 "MaxQueryTime": max_wait})
            return list(reply["Jobs"] or []), int(reply.get("Index", 0))
        self._block_on_table("jobs", min_index, max_wait)
        jobs = (self.state.jobs_by_id_prefix(None, prefix) if prefix
                else self.state.jobs(None))
        return jobs, self.state.table_index("jobs")

    def _block_on_table(self, table: str, min_index: int,
                        max_wait: float) -> None:
        """Wait until ``table``'s index passes ``min_index``, at most
        ``max_wait`` s (capped at 300; rpc.go:340 blockingRPC)."""
        if min_index <= 0 or max_wait <= 0:
            return
        deadline = time.time() + min(max_wait, 300.0)
        while self.state.table_index(table) <= min_index:
            remaining = deadline - time.time()
            if remaining <= 0:
                return
            ws = WatchSet()
            ws.add(self.state, table)
            ws.watch(timeout=min(remaining, 1.0))

    def job_get(self, job_id: str, region: str = "", min_index: int = 0,
                max_wait: float = 0.0) -> Optional[s.Job]:
        if region and region != self.config.region:
            reply = self._forward_region(
                region, "Job.Get",
                {"JobID": job_id, "MinQueryIndex": min_index,
                 "MaxQueryTime": max_wait})
            return reply.get("Job")
        self._block_on_table("jobs", min_index, max_wait)
        return self.state.job_by_id(None, job_id)

    def job_summary(self, job_id: str) -> Optional[s.JobSummary]:
        return self.state.job_summary_by_id(None, job_id)

    def job_allocations(self, job_id: str,
                        all_allocs: bool = False) -> List[s.Allocation]:
        return self.state.allocs_by_job(None, job_id, all_allocs)

    def job_evaluations(self, job_id: str) -> List[s.Evaluation]:
        return self.state.evals_by_job(None, job_id)

    def job_plan(self, job: s.Job, diff: bool = True) -> s.JobPlanResponse:
        """Dry-run scheduling (job_endpoint.go:~490 Plan): the job's
        scheduler (the CPU oracle of ``job.type``, as in the reference, not
        the batch worker) runs synchronously over a snapshot holding the
        job, into a ``Harness``; returns the annotated job diff, the
        placement forensics and, for a periodic job, its next launch
        after now.  Nothing is committed to the store."""
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
        if job.is_periodic():
            resp.next_periodic_launch = job.periodic.next(s.now())
        return resp

    def periodic_force(self, job_id: str) -> Optional[s.Job]:
        """Launch a periodic job's child now (periodic_endpoint.go Force):
        the child job, or None when the job is not tracked."""
        if not self._leader:
            reply = self._forward("Periodic.Force", {"JobID": job_id})
            child_id = reply.get("ChildJobID", "")
            if not child_id:
                return None
            child = self.state.job_by_id(None, child_id)
            return child or s.Job(id=child_id, name=child_id)
        return self.periodic.force_run(job_id)

    def job_dispatch(self, job_id: str, payload: bytes,
                     meta: Dict[str, str]) -> Tuple[int, str, str]:
        """An instance of a parameterized job (job_endpoint.go Dispatch):
        the meta keys and the payload checked against the job's config,
        then a child carrying them admitted, registered and given its
        eval.  Returns (index, dispatched job id, eval id)."""
        parent = self.state.job_by_id(None, job_id)
        if parent is None:
            raise KeyError(f"job not found: {job_id}")
        if not parent.is_parameterized():
            raise ValueError(f"job {job_id!r} is not parameterized")
        cfg = parent.parameterized_job
        if cfg.payload == "required" and not payload:
            raise ValueError("payload is required by this parameterized job")
        if cfg.payload == "forbidden" and payload:
            raise ValueError("payload is forbidden by this parameterized job")
        if len(payload) > DISPATCH_PAYLOAD_MAX:
            raise ValueError("payload exceeds maximum size of 16KiB")
        keys = set(meta)
        required = set(cfg.meta_required)
        allowed = required | set(cfg.meta_optional)
        if required - keys:
            raise ValueError("missing required dispatch metadata: "
                             + ", ".join(sorted(required - keys)))
        if keys - allowed:
            raise ValueError("dispatch metadata not allowed: "
                             + ", ".join(sorted(keys - allowed)))

        child = parent.copy()
        child.parent_id = parent.id
        child.id = (f"{parent.id}/dispatch-{int(s.now())}-"
                    f"{s.generate_uuid()[:8]}")
        child.name = child.id
        child.parameterized_job = None
        child.payload = payload
        child.meta = dict(parent.meta)
        child.meta.update(meta)
        child.status = s.JOB_STATUS_PENDING
        reserved = (self._check_tenant_admission(child) if self._leader
                    else False)
        try:
            return self._dispatch_child(job_id, payload, meta, child)
        finally:
            if reserved:
                self.eval_broker.release_admission(child.namespace)

    def _dispatch_child(self, job_id: str, payload: bytes, meta: Dict,
                        child: s.Job) -> Tuple[int, str, str]:
        try:
            _, index = self.raft.apply(MessageType.JOB_REGISTER,
                                       {"job": child})
        except NotLeaderError as e:
            reply = self._forward("Job.Dispatch",
                                  {"JobID": job_id, "Payload": payload,
                                   "Meta": meta}, e)
            return (reply["Index"], reply["DispatchedJobID"],
                    reply["EvalID"])
        ev = s.Evaluation(
            id=s.generate_uuid(), priority=child.priority, type=child.type,
            namespace=child.namespace,
            triggered_by=s.EVAL_TRIGGER_JOB_REGISTER, job_id=child.id,
            job_modify_index=index, status=s.EVAL_STATUS_PENDING)
        self.raft.apply(MessageType.EVAL_UPDATE, {"evals": [ev]})
        return index, child.id, ev.id

    # -- nodes -------------------------------------------------------------

    def node_register(self, node: s.Node) -> Tuple[int, float]:
        """(node_endpoint.go Register): returns (index, heartbeat_ttl)."""
        node = node.copy()
        if not node.id:
            raise ValueError("missing node ID for client registration")
        existed = self.state.node_by_id(None, node.id)
        if not node.status:
            node.status = s.NODE_STATUS_INIT
        try:
            _, index = self.raft.apply(MessageType.NODE_REGISTER,
                                       {"node": node})
        except NotLeaderError as e:
            reply = self._forward("Node.Register", {"Node": node}, e)
            return reply["Index"], reply["HeartbeatTTL"]
        ttl = self.heartbeat.reset_heartbeat_timer(node.id)
        # Transitions create node evals (node_endpoint.go:165).
        if existed is not None and existed.status != node.status:
            self._create_node_evals(node.id, index)
        return index, ttl

    def node_deregister(self, node_id: str) -> int:
        """(node_endpoint.go Deregister): the node out of the store
        through the log, its heartbeat timer cleared, and evals for the
        jobs with allocs on it."""
        try:
            _, index = self.raft.apply(MessageType.NODE_DEREGISTER,
                                       {"node_id": node_id})
        except NotLeaderError as e:
            return self._forward("Node.Deregister", {"NodeID": node_id},
                                 e)["Index"]
        self.heartbeat.clear_heartbeat_timer(node_id)
        self._create_node_evals(node_id, index)
        # The same revocation sweep as a node going down
        # (node_endpoint.go:254-264).
        self._revoke_node_accessors(node_id)
        return index

    def node_update_status(self, node_id: str,
                           status: str) -> Tuple[int, float]:
        """(node_endpoint.go:277 UpdateStatus): a heartbeat, and on a
        transition the status through the log and node evals."""
        node = self.state.node_by_id(None, node_id)
        if node is None:
            raise KeyError(f"node not found: {node_id}")
        if self.pool is not None and not self._leader:
            # A follower forwards even an unchanged status: the heartbeat
            # timer lives on the leader (node_endpoint.go:277).
            reply = self._forward("Node.UpdateStatus",
                                  {"NodeID": node_id, "Status": status})
            return reply["Index"], reply["HeartbeatTTL"]
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
            # A down node's tasks can no longer guard their secrets: its
            # allocs' accessors are revoked (node_endpoint.go:339-351).
            self._revoke_node_accessors(node_id)
        return index, ttl

    def _revoke_node_accessors(self, node_id: str) -> None:
        if not self.vault.enabled:
            return
        accessors = self.state.vault_accessors_by_node(None, node_id)
        if accessors:
            self._spawn(self._revoke_accessors, accessors)

    def derive_vault_token(self, alloc_id: str, task_names: List[str]
                           ) -> Dict[str, Dict]:
        """A client's per-task vault tokens (node_endpoint.go
        DeriveVaultToken, vault.go DeriveToken): the alloc checked, the
        tokens minted, and their accessors registered through the log
        before the answer, so a failover can still revoke them.  A
        follower forwards before minting."""
        if not self._leader:
            reply = self._forward(
                "Node.DeriveVaultToken",
                {"AllocID": alloc_id, "Tasks": list(task_names)})
            return reply["Tasks"]
        alloc = self.state.alloc_by_id(None, alloc_id)
        if alloc is None:
            raise KeyError(f"allocation {alloc_id!r} not found")
        if alloc.terminal_status():
            raise VaultError("cannot derive token for terminal allocation")
        if alloc.job is None:
            alloc = alloc.copy()
            alloc.job = self.state.job_by_id(None, alloc.job_id)
        # Response-wrapped by default (vault.go getWrappingFn): the client
        # gets a single-use wrapping token, never the secret on the wire;
        # the accessor registers here before distribution either way.
        tokens = self.vault.derive_token(
            alloc, task_names, wrapped=self.vault.config.wrap_derived_tokens)
        accessors = [VaultAccessor(
            accessor=info["accessor"], alloc_id=alloc_id,
            node_id=alloc.node_id, task=task,
            creation_ttl=int(info.get("ttl", 0)),
        ) for task, info in tokens.items()]
        try:
            self.raft.apply(MessageType.VAULT_ACCESSOR_REGISTER,
                            {"accessors": accessors})
        except NotLeaderError:
            # Leadership lost between the mint and the registration: no
            # replica knows these tokens, so revoke them now rather than
            # leak them for their whole TTL.
            self.vault.revoke_accessors([a.accessor for a in accessors])
            raise
        return tokens

    @staticmethod
    def _should_create_node_evals(old: str, new: str) -> bool:
        """(structs.go ShouldDrainNode / the transition table)."""
        if old == new:
            return False
        if new == s.NODE_STATUS_DOWN:
            return True
        return new == s.NODE_STATUS_READY and old in (
            s.NODE_STATUS_DOWN, s.NODE_STATUS_INIT)

    def node_get(self, node_id: str) -> Optional[s.Node]:
        return self.state.node_by_id(None, node_id)

    def node_list(self) -> List[s.Node]:
        return self.state.nodes(None)

    def node_get_allocs(self, node_id: str) -> List[s.Allocation]:
        return self.state.allocs_by_node(None, node_id)

    def node_get_client_allocs(self, node_id: str, min_index: int = 0,
                               max_wait: float = 0.0
                               ) -> Tuple[List[s.Allocation], int]:
        """The node's allocs, as a client long-polls them
        (node_endpoint.go:585 GetClientAllocs): waits until the allocs
        table passes ``min_index`` or ``max_wait`` s pass, then returns
        ``(allocs, index)``.  The JAX package's poll watches the nodes
        table too, so every node's registration or heartbeat answers every
        client's poll; node writes do not change a node's allocs."""
        deadline = time.time() + max_wait
        while True:
            ws = WatchSet()
            allocs = self.state.allocs_by_node(ws, node_id)
            index = self.state.table_index("allocs")
            remaining = deadline - time.time()
            if index > min_index or max_wait <= 0 or remaining <= 0:
                ws.close()
                return allocs, index
            ws.watch(timeout=min(remaining, 1.0))

    def node_evaluate(self, node_id: str) -> List[str]:
        """Re-evaluate every job with allocs on the node, and the system
        jobs (node_endpoint.go Evaluate)."""
        node = self.state.node_by_id(None, node_id)
        if node is None:
            raise KeyError(f"node not found: {node_id}")
        try:
            return self._create_node_evals(node_id, node.modify_index)
        except NotLeaderError as e:
            return self._forward("Node.Evaluate", {"NodeID": node_id},
                                 e)["EvalIDs"]

    def node_update_allocs(self, allocs: List[s.Allocation]) -> int:
        """The client's alloc status sync (node_endpoint.go:657
        UpdateAlloc): the client-authoritative fields through the log."""
        try:
            _, index = self.raft.apply(MessageType.ALLOC_CLIENT_UPDATE,
                                       {"allocs": allocs})
        except NotLeaderError as e:
            return self._forward("Node.UpdateAlloc",
                                 {"Allocs": list(allocs)}, e)["Index"]
        return index

    def node_update_drain(self, node_id: str, drain: bool) -> int:
        node = self.state.node_by_id(None, node_id)
        if node is None:
            raise KeyError(f"node not found: {node_id}")
        try:
            _, index = self.raft.apply(MessageType.NODE_UPDATE_DRAIN,
                                       {"node_id": node_id, "drain": drain})
        except NotLeaderError as e:
            return self._forward("Node.UpdateDrain",
                                 {"NodeID": node_id, "Drain": drain},
                                 e)["Index"]
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

    # -- forwarding, status and the operator ------------------------------

    def _forward(self, wire_method: str, body: Dict,
                 err: Optional[NotLeaderError] = None):
        """A write that hit ``NotLeaderError``, re-issued as an RPC to the
        leader (nomad/rpc.go:178 forward).  Unforwardable (no RPC, no
        known leader, the leader is us, or the request already took its
        one hop): ``err`` is raised again, or a ``NotLeaderError`` naming
        the best-known leader."""
        leader = self.leader_address()
        if (self.pool is None or not leader
                or leader == self.config.rpc_advertise
                or getattr(self._fwd_ctx, "active", False)):
            raise err if err is not None else NotLeaderError(leader)
        body = dict(body)
        body["__forwarded__"] = True
        self.metrics.incr_counter("rpc.forward")
        return self.pool.call(leader, wire_method, body)

    def leader_address(self) -> str:
        """The best-known leader's RPC address (Status.Leader)."""
        if isinstance(self.raft, MultiRaft):
            return self.raft.leader_addr or ""
        return self.config.rpc_advertise if self.is_leader() else ""

    def peer_addresses(self) -> List[str]:
        if isinstance(self.raft, MultiRaft):
            return list(self.raft.peers)
        return [self.config.rpc_advertise]

    def operator_raft_remove_peer(self, address: str) -> None:
        """Remove a (possibly dead) server from the voter set
        (operator_endpoint.go RaftRemovePeerByAddress): the leader
        replicates a configuration without it; a follower forwards."""
        if not address:
            raise ValueError("missing peer address")
        if self._leader:
            try:
                self._remove_peer_as_leader(address)
                return
            except NotLeaderError:
                pass  # stepped down mid-flight: forward
        try:
            self._forward("Operator.RaftRemovePeerByAddress",
                          {"Address": address})
        except Exception as e:
            # The wire sends errors as '<TypeName>: <message>': the
            # leader's typed errors are raised again by type.
            msg = str(e)
            if msg.startswith("KeyError"):
                raise KeyError(msg.split(": ", 1)[-1].strip("'")) from e
            if msg.startswith("ValueError"):
                raise ValueError(msg.split(": ", 1)[-1]) from e
            raise

    def _remove_peer_as_leader(self, address: str) -> None:
        if address == self.config.rpc_advertise:
            raise ValueError(
                "refusing to remove the current leader; remove it from "
                "another server after leadership moves")
        if not isinstance(self.raft, MultiRaft):
            raise KeyError(f"peer not found: {address}")
        peers = [p for p in self.raft.peers if p != address]
        if len(peers) == len(self.raft.peers):
            raise KeyError(f"peer not found: {address}")
        self.raft.propose_config(peers)

    def raft_configuration(self) -> Dict:
        leader = self.leader_address()
        servers = []
        for m in self.members() or [self._self_member()]:
            servers.append({
                "ID": m["Name"], "Node": m["Name"], "Address": m["Addr"],
                "Leader": m["Addr"] == leader if leader else (
                    m["Name"] == self.config.node_name and self.is_leader()),
                "Voter": not m.get("NonVoter", False)})
        return {"Servers": servers, "Index": self.raft.applied_index()}

    # -- the worker surface over the wire (eval_endpoint.go) --------------

    def _require_leader(self) -> None:
        """The broker and the plan queue live on the leader: a follower
        refuses with the leader's address (these calls do not forward)."""
        if not self._leader:
            raise NotLeaderError(self.leader_address())

    def eval_dequeue(self, schedulers: List[str], timeout: float = 0.0
                     ) -> Tuple[Optional[s.Evaluation], str]:
        self._require_leader()
        return self.eval_broker.dequeue(schedulers, timeout)

    def eval_dequeue_batch(self, schedulers: List[str], max_batch: int,
                           timeout: float = 0.0) -> Dict:
        """A remote worker's dequeue (Eval.DequeueBatch): up to
        ``max_batch`` (at most 32) ready evals, each with its delivery
        count and its job's plan fence (the index of its newest committed
        plan, which a follower's replica must reach before it schedules),
        and the leader's applied index."""
        self._require_leader()
        batch = self.eval_broker.dequeue_batch(
            schedulers, max(1, min(int(max_batch), 32)), timeout)
        items = [{"eval": ev, "token": token,
                  "attempts": self.eval_broker.delivery_attempts(ev.id),
                  "fence": self.plan_queue.applied_index_for(ev.job_id)}
                 for ev, token in batch]
        return {"items": items,
                "applied_index": self.raft.applied_index_relaxed()}

    def eval_update(self, evals: List[s.Evaluation]) -> int:
        """An EVAL_UPDATE for a remote worker (Eval.Update)."""
        _, index = self.raft.apply(MessageType.EVAL_UPDATE,
                                   {"evals": evals})
        return index

    def eval_reblock(self, ev: s.Evaluation, token: str) -> int:
        """The update and the reblock for a remote worker (Eval.Reblock):
        the blocked-eval tracker is the leader's."""
        self._require_leader()
        _, index = self.raft.apply(MessageType.EVAL_UPDATE, {"evals": [ev]})
        self.blocked_evals.reblock(ev, token)
        return index

    def eval_pause_nack(self, eval_id: str, token: str) -> None:
        self._require_leader()
        self.eval_broker.pause_nack_timeout(eval_id, token)

    def eval_resume_nack(self, eval_id: str, token: str) -> None:
        self._require_leader()
        self.eval_broker.resume_nack_timeout(eval_id, token)

    def eval_ack(self, eval_id: str, token: str) -> None:
        if not self._leader:
            self._forward("Eval.Ack", {"EvalID": eval_id, "Token": token})
            return
        self.eval_broker.ack(eval_id, token)

    def eval_nack(self, eval_id: str, token: str) -> None:
        if not self._leader:
            self._forward("Eval.Nack", {"EvalID": eval_id, "Token": token})
            return
        self.eval_broker.nack(eval_id, token)

    def eval_get(self, eval_id: str) -> Optional[s.Evaluation]:
        return self.state.eval_by_id(None, eval_id)

    def eval_list(self) -> List[s.Evaluation]:
        return self.state.evals(None)

    def eval_allocations(self, eval_id: str) -> List[s.Allocation]:
        return self.state.allocs_by_eval(None, eval_id)

    def alloc_get(self, alloc_id: str) -> Optional[s.Allocation]:
        return self.state.alloc_by_id(None, alloc_id)

    def alloc_list(self) -> List[s.Allocation]:
        return self.state.allocs(None)

    def plan_submit(self, plan: s.Plan):
        """(Plan.Submit → the plan queue, plan_endpoint.go).  A plan whose
        eval token is not the broker's outstanding delivery's is a stale
        worker's (the eval was redelivered): refused, since a same-job
        double placement is the one staleness the applier's re-check
        cannot catch.  A plan without a token passes."""
        self._require_leader()
        if plan.eval_id and plan.eval_token:
            token, outstanding = self.eval_broker.outstanding(plan.eval_id)
            if outstanding and token != plan.eval_token:
                raise RuntimeError(
                    f"plan token fence: eval {plan.eval_id} was "
                    "redelivered; stale delivery's plan rejected")
        return self.plan_queue.enqueue(plan)

    # -- system and namespaces (system_endpoint.go, the tenancy plane) ----

    def system_gc(self) -> None:
        """A force-gc core eval (system_endpoint.go GarbageCollect)."""
        try:
            self._create_core_eval(s.CORE_JOB_FORCE_GC)
        except NotLeaderError as e:
            self._forward("System.GarbageCollect", {}, e)

    def system_reconcile_summaries(self) -> None:
        try:
            self.raft.apply(MessageType.RECONCILE_JOB_SUMMARIES, {})
        except NotLeaderError as e:
            self._forward("System.ReconcileJobSummaries", {}, e)

    def namespace_upsert(self, ns: s.Namespace, region: str = "") -> int:
        """Register or update a tenant through the log, like a job; the
        FSM hook refreshes the policy mirrors.  Namespaces are a region's:
        an explicit other ``region`` routes there."""
        if region and region != self.config.region:
            return self._forward_region(region, "Namespace.Upsert",
                                        {"Namespace": ns})["Index"]
        ns = ns.copy()
        problems = ns.validate()
        if problems:
            raise ValueError(
                "namespace validation failed: " + "; ".join(problems))
        try:
            _, index = self.raft.apply(MessageType.NAMESPACE_UPSERT,
                                       {"namespace": ns})
        except NotLeaderError as e:
            return self._forward("Namespace.Upsert", {"Namespace": ns},
                                 e)["Index"]
        return index

    def namespace_delete(self, name: str, region: str = "") -> int:
        if region and region != self.config.region:
            return self._forward_region(region, "Namespace.Delete",
                                        {"Name": name})["Index"]
        if name == s.DEFAULT_NAMESPACE:
            raise ValueError("cannot delete the default namespace")
        if self.state.namespace_by_name(None, name) is None:
            raise KeyError(f"namespace not found: {name}")
        try:
            _, index = self.raft.apply(MessageType.NAMESPACE_DELETE,
                                       {"name": name})
        except NotLeaderError as e:
            return self._forward("Namespace.Delete", {"Name": name},
                                 e)["Index"]
        return index

    def namespace_list(self, region: str = "") -> List[s.Namespace]:
        if region and region != self.config.region:
            return self._forward_region(region, "Namespace.List",
                                        {})["Namespaces"]
        return self.state.namespaces(None)

    def namespace_status(self, name: str, region: str = "") -> Dict:
        """One tenant's row, its live usage and its reservations and
        pending evals (the namespace-status read)."""
        if region and region != self.config.region:
            return self._forward_region(region, "Namespace.Status",
                                        {"Name": name})
        row = self.state.namespace_by_name(None, name)
        if row is None:
            raise KeyError(f"namespace not found: {name}")
        cpu, mem, disk, iops, live = self.state.namespace_usage_one(name)
        self._refresh_capacity()
        cap, nodes = self._cluster_capacity, self._cluster_nodes
        return {
            "Namespace": row,
            "Usage": {"CPU": cpu, "MemoryMB": mem, "DiskMB": disk,
                      "IOPS": iops, "LiveAllocs": live,
                      "NodeUnits": self._node_units(
                          (cpu, mem, disk, iops), cap, nodes)},
            "ReservedAllocs": self.quota_ledger.reserved(name),
            "ReservedNodeUnits": self.node_units_ledger.reserved(name),
            "PendingEvals": self.eval_broker.ns_pending_count(name),
        }

    # -- reads -------------------------------------------------------------

    def broker_stats(self) -> Dict:
        """The broker's saturation surface (server.py:2175): its
        admission and coalesce state and tenant rows, the plan queue's
        depth, blocked evals and the follower-scheduling view."""
        out = self.eval_broker.extended_stats()
        out["PlanQueueDepth"] = self.plan_queue.depth()
        out["BlockedEvals"] = self.blocked_evals.stats()
        out["FollowerSched"] = self._follower_sched_stats()
        return out

    def _follower_sched_stats(self) -> Dict:
        """What this server forwards to the leader, and how far its
        replica lags the commit horizon it knows (server.py:2182-2193)."""
        fs: Dict = {"Enabled": bool(self.follower_workers),
                    "IsLeader": self._leader}
        if self.leader_channel is not None:
            fs.update(self.leader_channel.stats())
        if isinstance(self.raft, MultiRaft):
            fs["SnapshotLag"] = max(0, self.raft.commit_index
                                    - self.raft.applied_index_relaxed())
        return fs

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
        out["FollowerSched"] = self._follower_sched_stats()
        return out
