"""Scenario specs for the control-plane load harness (a copy of
``nomad_tpu/loadgen/scenario.py``; every builtin and every JSON field the
reference parses parses here, and ``Scenario.to_dict()`` equals the
reference's, field for field, so one spec file runs in both packages).

A scenario is a small, serializable description of offered load: how many
simulated nodes and clients, the open-loop job arrival rate, the job mix
(sizes × priorities, weighted), the warmup/measure/drain phase durations,
and the server shape under test (worker count, admission knobs).
Builtins cover the regression tiers; ``Scenario.from_dict`` /
``load_scenario`` accept the same shape as JSON for custom runs::

    {
      "name": "my-load",
      "num_nodes": 200, "num_clients": 8, "arrival_rate": 120,
      "warmup_s": 2, "measure_s": 10, "drain_s": 20,
      "job_mix": [
        {"weight": 8, "count": 1, "cpu": 100, "memory_mb": 128,
         "priority": 50},
        {"weight": 1, "count": 4, "cpu": 500, "memory_mb": 512,
         "priority": 80}
      ],
      "num_workers": 4, "subscribers": 64, "broker_max_pending": 0,
      "seed": 42
    }

The port's harnesses run every field; ``use_tpu_batch_worker`` parses
but changes nothing: the port's server has only the batch worker
(``torch-batch``), on the device the harness is given.  A scenario with
``num_regions`` > 1 runs through ``loadgen/federation.py``.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional


@dataclass
class JobShape:
    """One entry of the weighted job mix."""

    weight: float = 1.0
    count: int = 1          # task-group count (allocs per job)
    cpu: int = 100
    memory_mb: int = 128
    priority: int = 50


@dataclass
class Scenario:
    name: str = "custom"
    # Cluster shape.
    num_nodes: int = 100
    node_cpu: int = 4000
    node_memory_mb: int = 8192
    # Offered load.
    num_clients: int = 4          # concurrent submitter threads
    arrival_rate: float = 50.0    # open-loop submissions/s (aggregate)
    max_submissions: int = 0      # 0 = bounded by time only
    job_mix: List[JobShape] = field(default_factory=lambda: [JobShape()])
    # Phase protocol.
    warmup_s: float = 1.0
    measure_s: float = 5.0
    drain_s: float = 15.0
    # Fraction of submissions that RE-register a recent job (a job
    # update) instead of a new one — duplicate-eval pressure, the
    # traffic the broker's per-job coalescing exists for.
    update_fraction: float = 0.0
    # Simulated client behaviors.
    heartbeat: bool = True
    min_heartbeat_ttl: float = 2.0
    subscribers: int = 16         # event-stream followers w/ topic filters
    submit_retries: int = 4       # retries after a 429 admission NACK
    # Server under test.
    num_workers: int = 1
    use_tpu_batch_worker: bool = False
    batch_size: int = 16
    broker_max_pending: int = 0
    broker_coalesce: bool = True
    # Stale-snapshot worker pool (worker.py): off = the older
    # serial discipline of one fresh O(cluster) snapshot per eval — the
    # regression baseline the speedup gate compares against.
    stale_snapshot: bool = True
    # Durable raft log (FileLog + the native group-commit WAL):
    # every apply pays a real fsync; the report's plan_apply_fsync
    # percentiles and the --compare-wal gate measure it.
    wal: bool = False
    # Multi-server cluster (follower-read scheduling): 1
    # leader (in-process, MultiRaft) + num_servers-1 follower-scheduler
    # servers spawned as SUBPROCESSES joined over real TCP RPC — each
    # follower schedules off its own replicated FSM on its own
    # interpreter (real parallelism, not GIL-shared threads) and
    # forwards plans to the leader's serialized plan-apply.
    num_servers: int = 1
    # Follower workers per follower server; 0 → num_workers.
    follower_workers: int = 0
    # Leader-local workers in the multi-server shape; -1 → num_workers.
    # The scale-out sweet spot is 0: the leader spends its interpreter
    # on plan-apply + RPC + replication and the followers own ALL
    # scheduling CPU (the scale-out deployment shape).
    leader_workers: int = -1
    # Follower-scheduler servers join as VOTERS (True) or as NON-VOTING
    # members (False, the reference's non_voting_server): non-voting is
    # the scheduler-scale-out shape — replication reaches them (so
    # follower reads work) but quorum, and therefore plan-commit
    # latency, stays pinned to the voter set.
    follower_voting: bool = False
    # Continuous safety auditor: leader event-stream +
    # per-server fingerprint/event polls asserting no double placement,
    # no dup names, no overcommit, no lost acked eval, monotonic
    # indexes, and identical committed-prefix FSM digests.  Auto-armed
    # whenever a chaos spec is present.
    audit: bool = False
    # Cluster chaos plane: a seeded scheduler interleaves
    # SIGKILL+restart of follower subprocesses and split/heal network
    # partitions with the offered load.  Keys (all optional):
    #   seed              — chaos timeline RNG seed (default: scenario
    #                       seed)
    #   kills             — follower crash-restarts (default 1)
    #   partitions        — split/heal cycles (default 2)
    #   partition_s       — seconds a split holds (default 4.0)
    #   restart_delay_s   — crash → respawn gap (default 1.0)
    #   start_offset_s    — first event offset into the run (default 6)
    #   spacing_s         — gap between events (default 9.0)
    #   recovery_bound_s  — placed/s must return to ≥80% of the
    #                       pre-fault rate within this window (30.0)
    #   audit_interval_s  — auditor sweep/fingerprint cadence (1.0)
    chaos: Optional[Dict] = None
    # Multi-tenant serving plane.  num_tenants > 0 arms
    # tenancy: that many namespaces are pre-registered through raft and
    # every offered job is stamped with one of them.  The first
    # ``abusive_tenants`` namespaces soak up ``abusive_share`` of ALL
    # offered submissions (the noisy-neighbor leg); the compliant rest
    # split the remainder by a zipf draw (``tenant_zipf`` = 0 uniform,
    # else the skew exponent), so the tenant population looks like a
    # real fleet: a few busy teams, a long quiet tail.
    num_tenants: int = 0
    tenant_zipf: float = 0.0
    abusive_tenants: int = 0
    abusive_share: float = 0.0
    # Quota knobs stamped on every registered namespace (0 = unlimited,
    # matching the Namespace zero value).
    tenant_max_live_allocs: int = 0
    tenant_max_pending_evals: int = 0
    tenant_dequeue_weight: float = 1.0
    tenant_objective: str = ""    # "" inherits NOMAD_TPU_TENANCY_OBJECTIVE
    # Region federation.  num_regions > 1 arms the federated
    # harness (loadgen/federation.py): that many in-process single-voter
    # regions WAN-joined into one federation, clients spread round-robin
    # across home regions, and ``cross_region_fraction`` of submissions
    # targeting a FOREIGN region (the rpc.go:263 forwardRegion path —
    # each one's wall time feeds the cross-region forward-tax
    # percentiles).  ``num_nodes`` is the TOTAL fleet, split evenly.
    num_regions: int = 1
    cross_region_fraction: float = 0.0
    # Full region blackout + heal leg.  Keys (all optional):
    #   region            — blacked-out region name (default: the last)
    #   at_s              — offset into the run (default 4.0)
    #   duration_s        — how long the region stays dark (default 3.0)
    #   recovery_bound_s  — after heal, a cross-region probe into the
    #                       region must register AND place within this
    #                       bound or the run reports unrecovered (30.0)
    region_blackout: Optional[Dict] = None
    # Determinism.
    seed: int = 42

    def to_dict(self) -> Dict:
        return asdict(self)

    @staticmethod
    def from_dict(data: Dict) -> "Scenario":
        data = dict(data)
        mix = [JobShape(**m) if isinstance(m, dict) else m
               for m in data.pop("job_mix", [])] or [JobShape()]
        known = {f for f in Scenario.__dataclass_fields__}  # noqa: C416
        unknown = set(data) - known
        if unknown:
            raise ValueError(
                f"unknown scenario fields: {', '.join(sorted(unknown))}")
        return Scenario(job_mix=mix, **data)


def load_scenario(path: str) -> Scenario:
    with open(path) as fh:
        return Scenario.from_dict(json.load(fh))


# -- builtins ---------------------------------------------------------------

#: Fast, deterministic tier-1 gate: a fixed submission count at a rate the
#: single serial worker sustains, so the run is bounded by work, not time
#: (seconds on a cold CPU machine, including the first-eval warmups).
SMOKE = Scenario(
    name="smoke",
    num_nodes=20, num_clients=2, arrival_rate=200.0, max_submissions=30,
    job_mix=[JobShape(weight=3, count=1, cpu=50, memory_mb=64, priority=50),
             JobShape(weight=1, count=2, cpu=100, memory_mb=128,
                      priority=70)],
    warmup_s=0.0, measure_s=8.0, drain_s=20.0,
    subscribers=8, min_heartbeat_ttl=1.0, num_workers=1, seed=7)

#: The sustained-throughput scenario the bench guard and the scaling
#: gate run: a bounded burst (work-bounded, so runs terminate even when
#: a config is slow) offered faster than any single serial worker
#: drains it, on a cluster with ample capacity (saturation must come
#: from the CONTROL PLANE, not from placement failures — blocked evals
#: never complete and would poison the completion-rate metric).
#: Heartbeat TTLs in the throughput scenarios are LONG (30s): renewals
#: still flow (TTL-jitter dispersal shows in the report) but a GIL-
#: starved renewal thread can never slip past ttl+grace — a missed
#: heartbeat marks the node down and fans out one eval per job with
#: allocs on it, an eval storm that turns a throughput run into a
#: different experiment.  Short-TTL pressure is the smoke/fanout
#: scenarios' job, where scheduling load is light.
BASELINE = Scenario(
    name="baseline",
    num_nodes=5000, node_cpu=64_000, node_memory_mb=262_144,
    num_clients=8, arrival_rate=1500.0, max_submissions=2000,
    job_mix=[JobShape(weight=8, count=1, cpu=100, memory_mb=128,
                      priority=50),
             JobShape(weight=2, count=2, cpu=200, memory_mb=256,
                      priority=60),
             JobShape(weight=1, count=4, cpu=400, memory_mb=512,
                      priority=80)],
    warmup_s=0.0, measure_s=30.0, drain_s=60.0,
    subscribers=64, min_heartbeat_ttl=30.0, num_workers=1, seed=42)

#: 10× overload against a bounded broker: proves admission control keeps
#: memory bounded (shed/coalesce/reject counters move, pending stays at
#: the cap) instead of OOM-shaped queue growth.
OVERLOAD_10X = Scenario(
    name="overload_10x",
    num_nodes=100, node_cpu=64_000, node_memory_mb=262_144,
    num_clients=16, arrival_rate=2000.0, max_submissions=6000,
    job_mix=[JobShape(weight=1, count=1, cpu=50, memory_mb=64,
                      priority=50)],
    update_fraction=0.5,
    warmup_s=0.0, measure_s=30.0, drain_s=45.0,
    subscribers=32, min_heartbeat_ttl=30.0, num_workers=2,
    broker_max_pending=256, submit_retries=1, seed=99)

#: Event fan-out stress: ~10k filtered subscribers on a modest event
#: stream — the publish-side cost (filter walk per event) is the number
#: under test.
FANOUT_10K = Scenario(
    name="fanout_10k",
    num_nodes=50, num_clients=4, arrival_rate=100.0,
    max_submissions=200,
    warmup_s=0.0, measure_s=20.0, drain_s=30.0,
    subscribers=10_000, min_heartbeat_ttl=5.0, num_workers=2, seed=11)

#: Horizontal scale-out: a gang-scale ML-fleet job mix
#: (50-120 allocs per job — the workload class whose SCHEDULING cost
#: dominates the control plane) offered to 1 leader + 2 NON-VOTING
#: follower-scheduler servers (the reference's non_voting_server read-
#: scaling shape).  ``compare_servers`` runs the same offered load
#: against (a) one server with M workers and (b) the same cluster with
#: leader-local scheduling, so the report separates the replication tax
#: from the follower-read win.  Zero double placements is the hard bar.
MULTI_SERVER = Scenario(
    name="multi_server",
    num_nodes=5000, node_cpu=64_000, node_memory_mb=262_144,
    num_clients=8, arrival_rate=240.0, max_submissions=600,
    job_mix=[JobShape(weight=5, count=50, cpu=200, memory_mb=256,
                      priority=50),
             JobShape(weight=3, count=80, cpu=200, memory_mb=256,
                      priority=60),
             JobShape(weight=2, count=120, cpu=400, memory_mb=512,
                      priority=80)],
    warmup_s=0.0, measure_s=30.0, drain_s=120.0,
    subscribers=32, min_heartbeat_ttl=30.0, num_workers=4,
    num_servers=3, leader_workers=2, follower_workers=8,
    follower_voting=False, seed=42)

#: Cluster chaos soak: 1 leader + 2 follower-scheduler
#: subprocesses (each with a persistent raft data dir) under sustained
#: offered load while the seeded chaos scheduler SIGKILLs-and-restarts
#: a follower and splits/heals leader↔follower partitions.  The
#: continuous safety auditor runs throughout; the acceptance bar is
#: ZERO violations — no double placement, no dup names, no overcommit,
#: no lost acked eval, no FSM-prefix divergence — with recovery-time
#: percentiles (placed/s back to ≥80% of pre-fault inside the bound)
#: recorded in LOADGEN_r05.json.  Job mix stays small (count 1-2) so
#: the auditor's fingerprint sweeps stay cheap against the state size.
CHAOS_SOAK = Scenario(
    name="chaos_soak",
    num_nodes=400, node_cpu=64_000, node_memory_mb=262_144,
    # Offered load spans the WHOLE measure window (3600 = 60/s × 60s):
    # recovery is judged against a sustained rate, so load ending
    # before a fault's bound would censor its recovery measurement.
    num_clients=4, arrival_rate=60.0, max_submissions=3600,
    job_mix=[JobShape(weight=6, count=1, cpu=100, memory_mb=128,
                      priority=50),
             JobShape(weight=3, count=2, cpu=200, memory_mb=256,
                      priority=60),
             JobShape(weight=1, count=4, cpu=200, memory_mb=256,
                      priority=70)],
    update_fraction=0.1,
    warmup_s=2.0, measure_s=60.0, drain_s=120.0,
    subscribers=16, min_heartbeat_ttl=30.0,
    num_workers=4, num_servers=3, leader_workers=1, follower_workers=4,
    follower_voting=False, audit=True,
    chaos={"seed": 7, "kills": 1, "partitions": 2, "partition_s": 4.0,
           "restart_delay_s": 1.0, "start_offset_s": 6.0,
           "spacing_s": 9.0, "recovery_bound_s": 30.0,
           "audit_interval_s": 2.0},
    seed=42)

#: Fixed-seed tier-1 chaos gate: one partition cycle + one real
#: subprocess kill/restart against a 2-server cluster under light
#: bounded load — small enough for the fast tier, real enough to drive
#: the whole kill→recover→audit machinery end to end.
CHAOS_SMOKE = Scenario(
    name="chaos_smoke",
    num_nodes=60, node_cpu=64_000, node_memory_mb=262_144,
    num_clients=2, arrival_rate=40.0, max_submissions=640,
    job_mix=[JobShape(weight=3, count=1, cpu=100, memory_mb=128,
                      priority=50),
             JobShape(weight=1, count=2, cpu=200, memory_mb=256,
                      priority=60)],
    warmup_s=1.0, measure_s=16.0, drain_s=60.0,
    subscribers=8, min_heartbeat_ttl=30.0,
    num_workers=2, num_servers=2, leader_workers=1, follower_workers=2,
    follower_voting=False, audit=True,
    chaos={"seed": 11, "kills": 1, "partitions": 1, "partition_s": 2.5,
           "restart_delay_s": 0.5, "start_offset_s": 3.0,
           "spacing_s": 6.0, "recovery_bound_s": 25.0},
    seed=23)

#: Multi-tenant serving gate: ~1k namespaces with per-tenant
#: pending-eval and live-alloc quotas, a zipf-skewed compliant
#: population, and ONE abusive tenant soaking up half the offered load.
#: The acceptance shape: the abuser's own completion p99 degrades (its
#: subqueue saturates and its overflow is 429'd at the admission front
#: door) while compliant tenants keep dequeuing promptly under DRF;
#: accepted evals are never lost; and no tenant's committed live-alloc
#: count ever exceeds its quota (the strict final sweep asserts it).
#: submit_retries=1 keeps the open-loop schedule honest — the abuser's
#: rejected overflow must not stall the submitter threads into a
#: different experiment.
MULTI_TENANT = Scenario(
    name="multi_tenant",
    num_nodes=300, node_cpu=64_000, node_memory_mb=262_144,
    num_clients=8, arrival_rate=600.0, max_submissions=3000,
    job_mix=[JobShape(weight=1, count=1, cpu=50, memory_mb=64,
                      priority=50)],
    warmup_s=0.0, measure_s=20.0, drain_s=45.0,
    subscribers=16, min_heartbeat_ttl=30.0, num_workers=1,
    submit_retries=1,
    num_tenants=1000, tenant_zipf=1.1, abusive_tenants=1,
    abusive_share=0.5, tenant_max_pending_evals=32,
    tenant_max_live_allocs=800, seed=16)

#: Region federation gate: two single-voter regions
#: WAN-joined, clients split across home regions, a quarter of all
#: submissions targeting the OTHER region (the measured cross-region
#: forward tax), and a full blackout of one region mid-run.  The
#: partition-tolerance contract under test: cross-region submissions
#: into the dark region degrade to typed retryable NoPathToRegion
#: errors (never a hang, never a lost acked eval), the dark region
#: keeps serving its OWN clients throughout, and after heal a probe
#: submission registers and places inside the recovery bound.  The
#: federated auditor sweeps continuously: no job may ever hold live
#: allocs in two regions, and each region's own integrity + FSM-digest
#: invariants hold through partition and heal.
MULTI_REGION = Scenario(
    name="multi_region",
    num_nodes=80, node_cpu=64_000, node_memory_mb=262_144,
    num_clients=4, arrival_rate=40.0, max_submissions=480,
    job_mix=[JobShape(weight=3, count=1, cpu=100, memory_mb=128,
                      priority=50),
             JobShape(weight=1, count=2, cpu=200, memory_mb=256,
                      priority=60)],
    warmup_s=1.0, measure_s=12.0, drain_s=45.0,
    subscribers=0, min_heartbeat_ttl=30.0, num_workers=1,
    submit_retries=6, audit=True,
    num_regions=2, cross_region_fraction=0.25,
    region_blackout={"at_s": 4.0, "duration_s": 3.0,
                     "recovery_bound_s": 30.0},
    seed=17)

BUILTIN_SCENARIOS: Dict[str, Scenario] = {
    sc.name: sc for sc in (SMOKE, BASELINE, OVERLOAD_10X, FANOUT_10K,
                           MULTI_SERVER, CHAOS_SOAK, CHAOS_SMOKE,
                           MULTI_TENANT, MULTI_REGION)}


def get_scenario(name: str) -> Scenario:
    try:
        return BUILTIN_SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; builtins: "
            f"{', '.join(sorted(BUILTIN_SCENARIOS))}") from None
