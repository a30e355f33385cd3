"""The open-loop load harness: drives the port's ``Server`` under a
scenario (a copy of ``nomad_tpu/loadgen/harness.py``).

Phase protocol (sustained measurement, Gavel, arxiv 2008.09213):

  warmup    — offered load runs but nothing is scored (the card's first
              batches, heartbeat timers spreading out);
  measure   — completions, placements, and latencies inside this window
              produce the sustained numbers;
  drain     — submission stops; the harness waits (bounded) for the
              backlog so straggler accounting is exact.

Simulated clients are threads sharing one open-loop arrival schedule:
submission n fires at ``start + n/arrival_rate`` regardless of how long
submission n−1 took (open-loop, so queueing delay is *visible* instead of
self-throttled away).  Each client also renews heartbeats for its slice
of the registered nodes and the harness keeps K event-stream
subscriptions with per-job topic filters alive, so the server pays the
full fan-out and TTL bookkeeping while being measured.

Backpressure contract: a 429-style ``BrokerLimitError`` NACK from
admission control is retried with the server's ``retry_after`` hint plus
client-side jitter (scenario.submit_retries times), then counted as
dropped — what a well-behaved SDK client does.

The server under test is the port's: one ``Server`` whose
``num_workers`` ``BatchWorker``\\ s run ``TorchBatchScheduler`` on the
harness's ``device`` (``cuda`` by default, which raises without a card;
the harness never carries on on the CPU), named in the report's
``server`` section (``worker: torch-batch``).  The reference's per-eval
CPU workers (its default ``use_tpu_batch_worker=False``) have no
counterpart here: the field parses and changes nothing.  Everything the
reference reads from the environment is an argument here:
``server_options`` go into the ``ServerConfig`` (the flight recorder,
the profiler, the SLO watch, a breaker of its own, ``rng_seed``),
``raft_tuning`` is the multi-server raft timing (``RAFT_TUNING``, the
reference's ``NOMAD_TPU_RAFT_*``) and ``switch_interval`` the GIL switch
interval of every server process of a multi-server run
(``NOMAD_TPU_SWITCH_INTERVAL``).

Multi-server mode (``num_servers`` > 1): the in-process server is the
deterministic leader (``MultiRaft``, a single-voter bootstrap) and
``num_servers`` − 1 follower-scheduler servers run as subprocesses
(``python -m nomad_tpu_torch.loadgen --follower-child``) that join it
over TCP, replicate its log and schedule on the CPU off their replicas
(the follower-read design), forwarding plans to the leader's plan
queue.  With ``audit`` the continuous ``SafetyAuditor`` runs against
every server.  With ``chaos`` the seeded ``_ChaosScheduler`` SIGKILLs
followers and restarts them from their raft stores (a persistent data
dir and the same port each) and splits and heals partitions on both
sides: the harness's own net plane (``fault.py``) and the follower's,
driven over a chaos-exempt control pool (``Chaos.SetNet``; the children
run with ``--chaos``); the report's ``chaos`` section gives each event's
recovery time (``_chaos_report``).  A scenario with more than one region
runs through ``loadgen/federation.py``'s ``MultiRegionHarness``
(``run_scenario`` routes it there).
"""
from __future__ import annotations

import logging
import os
import random
import sys
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from .. import fault
from ..server import Server, ServerConfig
from ..server.eval_broker import BrokerLimitError
from ..structs import structs as s
from ..utils import contprof, lockcheck, tracing
from .scenario import JobShape, Scenario

# Raft timing for multi-server measurement clusters: elections slowed to
# seconds (leader and followers alike) so GIL stalls under offered load
# cannot depose the leader mid-run; heartbeats stay sub-second so a real
# leader death still fails over inside the drain budget.
RAFT_TUNING = {"raft_heartbeat": 0.2, "raft_election_min": 5.0,
               "raft_election_max": 8.0}
# The GIL switch interval of every server process of a multi-server run:
# a follower's AppendEntries handler sits inside the leader's quorum
# wait, and at CPython's default 5 ms a busy follower's scheduling loops
# add ~25 ms to every commit.
SWITCH_INTERVAL = 0.001
# The checkout's root: the follower children run ``-m`` from there.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def apply_switch_interval(value: Optional[float]) -> Optional[float]:
    """Set the GIL switch interval; returns the prior value (None when
    ``value`` is None), so an in-process caller can restore it."""
    if value is None:
        return None
    prior = sys.getswitchinterval()
    sys.setswitchinterval(value)
    return prior


def _percentiles(values: List[float]) -> Dict[str, float]:
    if not values:
        return {"count": 0, "p50": 0.0, "p95": 0.0, "p99": 0.0,
                "mean": 0.0, "max": 0.0}
    ordered = sorted(values)

    def pct(q: float) -> float:
        return ordered[min(len(ordered) - 1, int(q * len(ordered)))]

    return {"count": len(ordered),
            "p50": round(pct(0.50) * 1000.0, 3),
            "p95": round(pct(0.95) * 1000.0, 3),
            "p99": round(pct(0.99) * 1000.0, 3),
            "mean": round(sum(ordered) / len(ordered) * 1000.0, 3),
            "max": round(ordered[-1] * 1000.0, 3)}


class _Submission:
    __slots__ = ("seq", "eval_id", "job_id", "priority", "submit_t",
                 "running_t", "done_t", "rejected", "ns")

    def __init__(self, seq: int, eval_id: str, job_id: str, priority: int,
                 submit_t: float, ns: str = ""):
        self.seq = seq
        self.eval_id = eval_id
        self.job_id = job_id
        self.priority = priority
        self.submit_t = submit_t
        self.running_t: Optional[float] = None
        self.done_t: Optional[float] = None
        self.rejected = 0
        self.ns = ns


class _ChaosScheduler:
    """Seeded fault timeline for multi-server soak runs (harness.py:111): a
    deterministic schedule of follower kills (SIGKILL + restart from
    the raft store) and split/heal network partitions, interleaved with
    the offered load.

    Partitions are enforced on BOTH sides: the harness process arms its
    own net plane (severing the leader's dials/sends — including raft
    replication — to the target) and drives the follower's plane over
    the chaos-exempt control pool via ``Chaos.SetNet``, so the
    follower's dequeue/plan-forward traffic dies too.  Every event is
    recorded with monotonic timestamps for the recovery-time report."""

    def __init__(self, harness: "LoadHarness", spec: Dict, logger):
        self.h = harness
        self.spec = dict(spec or {})
        self.logger = logger
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.events: List[Dict] = []
        seed = int(self.spec.get("seed", harness.sc.seed))
        rng = random.Random(f"chaos/{seed}")
        kills = int(self.spec.get("kills", 1))
        partitions = int(self.spec.get("partitions", 2))
        start = float(self.spec.get("start_offset_s", 6.0))
        spacing = float(self.spec.get("spacing_s", 9.0))
        n_followers = max(1, harness.sc.num_servers - 1)
        # Deterministic interleave: partitions and kills alternate,
        # jittered spacing, seeded follower choice.
        kinds = []
        for i in range(max(kills, partitions)):
            if i < partitions:
                kinds.append("partition")
            if i < kills:
                kinds.append("kill")
        self.timeline: List[Dict] = []
        t = start
        for k, kind in enumerate(kinds):
            # Seeded base + ordinal rotation: deterministic, and a
            # multi-event timeline spreads across followers instead of
            # the seed happening to abuse one server all run.
            self.timeline.append({
                "at_s": round(t, 2), "kind": kind,
                "target": (rng.randrange(n_followers) + k) % n_followers})
            t += spacing * (0.8 + 0.4 * rng.random())

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="lg-chaos")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)

    # -- actions -----------------------------------------------------------

    def _set_follower_net(self, addr: str, body: Dict) -> None:
        try:
            self.h._chaos_pool.call(addr, "Chaos.SetNet", body,
                                    timeout=5.0)
        except Exception as e:
            self.logger.warning("chaos: Chaos.SetNet on %s failed: %s",
                                addr, e)

    def _do_partition(self, ev: Dict) -> None:
        idx = ev["target"] % len(self.h.follower_addrs)
        addr = self.h.follower_addrs[idx]
        leader = self.h.server.config.rpc_advertise
        name = f"chaos-{len(self.events)}"
        hold = float(self.spec.get("partition_s", 4.0))
        ev.update(target_addr=addr, name=name, t=time.monotonic())
        # Split: both sides sever their own outbound traffic.
        fault.net_partition(name, [[leader], [addr]])
        self._set_follower_net(addr, {"Partitions": [
            {"Name": name, "Groups": [[addr], [leader]]}]})
        self.logger.info("chaos: partition %s <-> %s for %.1fs",
                         leader, addr, hold)
        self._stop.wait(hold)
        fault.net_heal(name)
        self._set_follower_net(addr, {"Heal": [name]})
        ev["healed_t"] = time.monotonic()

    def _do_kill(self, ev: Dict) -> None:
        idx = ev["target"] % len(self.h.follower_addrs)
        delay = float(self.spec.get("restart_delay_s", 1.0))
        ev.update(t=time.monotonic())
        addr = self.h.kill_follower(idx)
        ev["target_addr"] = addr
        self.logger.info("chaos: SIGKILLed follower %s; restarting in "
                         "%.1fs", addr, delay)
        self._stop.wait(delay)
        self.h.restart_follower(idx)
        ev["restarted_t"] = time.monotonic()

    def _run(self) -> None:
        for ev in self.timeline:
            due = self.h._start_t + ev["at_s"]
            while not self._stop.is_set():
                wait = due - time.monotonic()
                if wait <= 0:
                    break
                self._stop.wait(min(wait, 0.5))
            if self._stop.is_set():
                return
            ev = dict(ev)
            try:
                if ev["kind"] == "partition":
                    self._do_partition(ev)
                else:
                    self._do_kill(ev)
            except Exception as e:
                ev["error"] = repr(e)
                self.logger.exception("chaos: %s event failed", ev["kind"])
            self.events.append(ev)


class LoadHarness:
    """One scenario run against one in-process server on ``device``."""

    def __init__(self, scenario: Scenario,
                 logger: Optional[logging.Logger] = None,
                 device: str = "cuda",
                 server_options: Optional[Dict] = None,
                 raft_tuning: Optional[Dict] = None,
                 switch_interval: Optional[float] = SWITCH_INTERVAL):
        if scenario.num_regions > 1:
            raise ValueError(
                f"scenario {scenario.name!r} has {scenario.num_regions} "
                "regions: run it through loadgen.federation."
                "MultiRegionHarness (run_scenario routes it there)")
        self.sc = scenario
        self.logger = logger or logging.getLogger("nomad_tpu_torch.loadgen")
        self.device = device
        self.server_options = dict(server_options or {})
        self.raft_tuning = dict(RAFT_TUNING if raft_tuning is None
                                else raft_tuning)
        self.switch_interval = switch_interval
        self.server: Optional[Server] = None
        self._stop = threading.Event()
        self._l = threading.Lock()
        self._seq = 0
        self._start_t = 0.0
        self._submit_end_t = 0.0
        self.subs: Dict[str, _Submission] = {}      # eval_id → record
        # Events that arrived for an eval BEFORE its submitter thread
        # registered the record (job_register returns the eval id, but
        # a fast worker can plan-apply and ack it before the submitter
        # reacquires the lock) — replayed at registration.  Bounded:
        # untracked ids (internal evals) must not accumulate.
        self._early: "OrderedDict[str, list]" = OrderedDict()
        self.dropped = 0                            # gave up after retries
        self.reject_events = 0                      # total 429 NACKs seen
        # Multi-tenant plane: namespace names (abusers first), the zipf
        # CDF over the compliant tail, and per-tenant reject/drop
        # tallies keyed by namespace.
        self._tenants: List[str] = []
        self._tenant_cdf: List[float] = []
        self.ns_rejects: Dict[str, int] = {}
        self.ns_dropped: Dict[str, int] = {}
        self.placed_events: List[Tuple[float, int]] = []
        self._hb_renewals: List[float] = []         # granted TTLs
        self._filter_subs: list = []
        self._threads: List[threading.Thread] = []
        # Multi-server mode: follower-scheduler subprocesses, and the
        # continuous safety auditor with its own connection pool.
        self._follower_procs: list = []
        self.follower_addrs: List[str] = []
        # The chaos plane: per-follower persistent data dirs (a SIGKILLed
        # follower restarts from its raft store), the chaos-exempt
        # control pool (split, heal and audit must reach a partitioned
        # server, as an out-of-band console does) and the scheduler.
        self._follower_dirs: List[str] = []
        self._chaos_root = ""
        self._chaos_pool = None
        self._chaos = None
        self.auditor = None
        self._wal_dir = ""
        self._prior_switch_interval: Optional[float] = None

    # -- setup -------------------------------------------------------------

    def _build_server(self) -> Server:
        sc = self.sc
        if sc.wal:
            # Durable raft log (FileLog + the native group-commit WAL):
            # every plan apply pays real fsync latency, which is what
            # the plan_apply_fsync percentiles measure.
            import tempfile

            self._wal_dir = tempfile.mkdtemp(
                prefix="nomad-tpu-torch-loadgen-")
        opts = dict(
            device=self.device,
            data_dir=self._wal_dir,
            num_schedulers=sc.num_workers,
            batch_size=sc.batch_size,
            min_heartbeat_ttl=sc.min_heartbeat_ttl,
            broker_max_pending=sc.broker_max_pending,
            broker_coalesce=sc.broker_coalesce,
            stale_snapshot=sc.stale_snapshot,
            node_name=f"loadgen-{sc.name}")
        if sc.num_servers > 1:
            # Multi-server cluster: the in-process server is the
            # deterministic leader (MultiRaft, single-voter bootstrap);
            # follower-scheduler subprocesses join it over real TCP and
            # are promoted to voters through replicated CONFIG entries.
            # Elections are slowed (``raft_tuning``): the measurement
            # load can starve the leader's heartbeat threads past the
            # stock window, and a mid-run deposition would measure
            # election churn, not scheduling.
            opts.update(enable_rpc=True, force_multi_raft=True,
                        bootstrap_expect=1, **self.raft_tuning)
            if sc.leader_workers >= 0:
                opts["num_schedulers"] = sc.leader_workers
                # The leader's own follower pool parks while it leads,
                # but keeps the shape symmetric for failover.
                opts["follower_schedulers"] = max(
                    0, (0 if sc.follower_workers < 0
                        else sc.follower_workers or sc.num_workers))
        opts.update(self.server_options)
        srv = Server(ServerConfig(**opts),
                     logger=self.logger.getChild("server"))
        try:
            srv.start()
        except Exception:
            srv.shutdown()
            raise
        # One aggregation window for the whole run: a long straggler
        # drain must not rotate the histograms out before _assemble or
        # the follower-stats collection read them.
        srv.metrics.sink.interval = 3600.0
        deadline = (time.monotonic() + 10.0
                    + float(self.raft_tuning.get("raft_election_max", 0.0)
                            if sc.num_servers > 1 else 0.0))
        while not srv.is_leader() and time.monotonic() < deadline:
            time.sleep(0.005)
        if not srv.is_leader():
            srv.shutdown()
            raise RuntimeError("loadgen server failed to take leadership")
        if sc.num_servers > 1:
            # A failure from here on is cleaned up by run(): the
            # followers stopped, the server shut down, the interval
            # restored.
            self.server = srv
            self._prior_switch_interval = apply_switch_interval(
                self.switch_interval)
            self._spawn_followers()
        return srv

    # -- follower-scheduler subprocesses ------------------------------------

    def _spawn_one_follower(self, i: int, port: int = 0):
        """Spawn follower ``i`` (fresh, or restarted after a chaos kill):
        a server process on the CPU that joins the leader, schedules with
        follower workers and parks on stdin.  Everything the reference
        passes it through the environment is an argument here.  With a
        chaos spec it gets a persistent data dir, and on a restart the
        port it had, so it comes back as the same raft member."""
        import subprocess

        sc = self.sc
        addr = self.server.config.rpc_advertise
        workers = (0 if sc.follower_workers < 0
                   else sc.follower_workers or sc.num_workers)
        cmd = [sys.executable, "-m", "nomad_tpu_torch.loadgen",
               "--follower-child", "--join", addr,
               "--workers", str(workers),
               "--name", f"lg-follower-{i + 1}",
               "--device", "cpu", "--follower-sched"]
        for key, value in sorted(self.raft_tuning.items()):
            cmd += ["--" + key.replace("_", "-"), str(value)]
        if self.switch_interval is not None:
            cmd += ["--switch-interval", str(self.switch_interval)]
        if not sc.follower_voting:
            cmd.append("--non-voting")
        if sc.audit or sc.chaos is not None:
            # The auditor's Event.Since feed: every server's event
            # stream armed.
            cmd.append("--events")
        if sc.chaos is not None:
            cmd.append("--chaos")
        if i < len(self._follower_dirs) and self._follower_dirs[i]:
            cmd += ["--data-dir", self._follower_dirs[i]]
        if port:
            cmd += ["--port", str(port)]
        return subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, text=True,
                                cwd=_ROOT)

    def _await_ready(self, proc, deadline: float) -> str:
        import select

        line = ""
        while time.monotonic() < deadline:
            ready, _, _ = select.select([proc.stdout], [], [], 0.5)
            if ready:
                line = proc.stdout.readline()
                break
            if proc.poll() is not None:
                break
        if not line.startswith("READY "):
            raise RuntimeError(
                f"follower server failed to start (got {line!r})")
        return line.split()[1]

    def _spawn_followers(self) -> None:
        """1 leader + K follower-scheduler servers: each follower is a
        real subprocess (its scheduling CPU runs on its own
        interpreter) that joins the leader over TCP, replicates the
        FSM, and pulls evals via the follower-read path
        (server/follower_sched.py)."""
        sc = self.sc
        addr = self.server.config.rpc_advertise
        if sc.chaos is not None:
            import tempfile

            self._chaos_root = tempfile.mkdtemp(
                prefix="nomad-tpu-torch-chaos-")
            self._follower_dirs = [
                os.path.join(self._chaos_root, f"follower-{i + 1}")
                for i in range(sc.num_servers - 1)]
        for i in range(sc.num_servers - 1):
            self._follower_procs.append(self._spawn_one_follower(i))
        deadline = time.monotonic() + 60.0
        for proc in self._follower_procs:
            self.follower_addrs.append(self._await_ready(proc, deadline))
        # Membership: voters are promoted through replicated CONFIG
        # entries; non-voting followers attach to the replication
        # fan-out as learners.
        def formed():
            raft = self.server.raft
            return len(set(raft.peers) | set(raft.learners))
        while time.monotonic() < deadline:
            if formed() == sc.num_servers:
                break
            time.sleep(0.05)
        if formed() != sc.num_servers:
            raise RuntimeError(
                f"cluster formed {formed()} members, "
                f"wanted {sc.num_servers}")
        self.logger.info("loadgen: cluster up — leader %s + followers %s",
                         addr, self.follower_addrs)

    def _follower_stats(self) -> List[Dict]:
        """Per-follower telemetry over the wire (Status.Metrics /
        Status.BrokerStats): forwarded plans, plan-forward RTT
        percentiles, follower snapshot lag, lag handbacks."""
        out = []
        for addr in self.follower_addrs:
            try:
                def call(method):
                    # One retry: a restarted follower leaves stale
                    # pooled connections to the old process; the first
                    # call discards one, the retry dials fresh.
                    for attempt in (0, 1):
                        try:
                            return self.server.pool.call(addr, method, {},
                                                         timeout=5.0)
                        except Exception:
                            if attempt:
                                raise
                m = call("Status.Metrics")
                b = call("Status.BrokerStats")
            except Exception as e:
                out.append({"addr": addr, "error": str(e)})
                continue
            samples = m.get("Samples") or {}
            totals = m.get("CounterTotals") or {}

            def pct(key):
                agg = samples.get(key) or {}
                return {k: agg.get(k)
                        for k in ("count", "p50", "p95", "p99") if agg}

            fs = (b.get("FollowerSched") or {})
            st = m.get("SampleTotals") or {}

            def tot(key):
                pair = st.get(key)
                return round(pair[1], 4) if pair else 0.0

            codec_split = {
                f"{sub}_{op}_s":
                    tot(f"nomad.codec.{sub}.{op}_seconds")
                for sub in ("rpc", "raft") for op in ("encode", "decode")}
            out.append({
                "addr": addr,
                "codec": codec_split,
                "forwarded_plans": fs.get("ForwardedPlans", 0),
                "forward_errors": fs.get("ForwardErrors", 0),
                "forwarded_inflight": fs.get("ForwardedPlansInFlight", 0),
                "plan_forward_rtt_ms": pct("nomad.plan.forward"),
                "snapshot_lag_entries": pct("nomad.follower.snapshot_lag"),
                "evals_scheduled": totals.get(
                    "nomad.follower.evals_scheduled", 0),
                "lag_handbacks": totals.get(
                    "nomad.follower.lag_handback", 0),
            })
        return out

    def _stop_followers(self) -> None:
        for proc in self._follower_procs:
            try:
                if proc.stdin is not None:
                    proc.stdin.close()  # child parks on stdin EOF
            except OSError:
                pass
        for proc in self._follower_procs:
            try:
                proc.wait(timeout=10.0)
            except Exception:
                proc.kill()
                proc.wait(timeout=5.0)
        self._follower_procs = []

    # -- the chaos plane (harness.py:522-553) --------------------------------

    def kill_follower(self, idx: int) -> str:
        """SIGKILL follower ``idx``: a real process crash, no drain, no
        flush.  Returns its address."""
        proc = self._follower_procs[idx]
        proc.kill()
        proc.wait(timeout=10.0)
        return self.follower_addrs[idx]

    def restart_follower(self, idx: int, timeout: float = 60.0) -> str:
        """Respawn a killed follower at the same address on the same data
        dir: it recovers its term, vote, log and snapshot from its raft
        store, rejoins the leader, and replication and follower-read
        scheduling resume."""
        addr = self.follower_addrs[idx]
        port = int(addr.rsplit(":", 1)[1])
        proc = self._spawn_one_follower(idx, port=port)
        self._follower_procs[idx] = proc
        got = self._await_ready(proc, time.monotonic() + timeout)
        if got != addr:
            raise RuntimeError(
                f"restarted follower came back at {got}, wanted {addr}")
        # The old process's sockets are dead: purge them (and the dial
        # gate), so the next caller dials the new incarnation.
        for pool in (self.server.pool, self._chaos_pool):
            if pool is not None:
                pool.invalidate(addr)
        if self.auditor is not None:
            self.auditor.note_restart(addr)
        return addr

    def _collect_integrity(self) -> Dict:
        """Placement-integrity sweep over the leader's final state: the
        follower-read acceptance bar is ZERO double placements — no job
        with more live allocs than its (latest registered) total count,
        no duplicate alloc names within a job, no overcommitted node.
        One shared predicate with the continuous auditor
        (loadgen/auditor.integrity_sweep)."""
        from .auditor import integrity_sweep

        with self._l:
            job_ids = {rec.job_id for rec in self.subs.values()}
        out = integrity_sweep(self.server.state, job_ids)
        out.pop("detail", None)
        return out

    def _register_nodes(self) -> List[str]:
        sc = self.sc
        ids = []
        for i in range(sc.num_nodes):
            node = s.Node(
                id=f"lg-node-{i:05d}",
                datacenter="dc1", name=f"lg-node-{i:05d}",
                attributes={"kernel.name": "linux", "driver.exec": "1"},
                resources=s.Resources(cpu=sc.node_cpu,
                                      memory_mb=sc.node_memory_mb,
                                      disk_mb=100 * 1024, iops=1000),
                reserved=s.Resources(),
                node_class="loadgen",
                status=s.NODE_STATUS_READY)
            self.server.node_register(node)
            ids.append(node.id)
        return ids

    # -- multi-tenant plane -------------------------------------------------

    def _register_tenants(self) -> None:
        """Pre-register the scenario's namespaces through raft (the
        production onboarding path) and precompute the zipf CDF the
        arrival stream draws compliant tenants from.  Abusers come
        first in the name list so ``_tenant_for`` can split classes by
        index."""
        sc = self.sc
        names = ([f"lg-abuser-{i:02d}" for i in range(sc.abusive_tenants)]
                 + [f"lg-t-{i:04d}"
                    for i in range(sc.num_tenants - sc.abusive_tenants)])
        for name in names:
            self.server.namespace_upsert(s.Namespace(
                name=name,
                max_live_allocs=sc.tenant_max_live_allocs,
                max_pending_evals=sc.tenant_max_pending_evals,
                dequeue_weight=sc.tenant_dequeue_weight,
                objective=sc.tenant_objective))
        self._tenants = names
        compliant = max(0, sc.num_tenants - sc.abusive_tenants)
        cdf, acc = [], 0.0
        for k in range(compliant):
            acc += (1.0 / (k + 1) ** sc.tenant_zipf if sc.tenant_zipf
                    else 1.0)
            cdf.append(acc)
        self._tenant_cdf = cdf
        self.logger.info("loadgen: registered %d tenants (%d abusive)",
                         len(names), sc.abusive_tenants)

    def _tenant_for(self, seq: int) -> str:
        """Deterministic tenant of job ``seq``: keyed on the job's own
        sequence number (not the submitting thread), so a re-register
        of job n lands in job n's namespace."""
        import bisect

        sc = self.sc
        rng = random.Random((sc.seed << 21) ^ seq)
        if sc.abusive_tenants and rng.random() < sc.abusive_share:
            return self._tenants[rng.randrange(sc.abusive_tenants)]
        if not self._tenant_cdf:
            return self._tenants[0]
        pick = rng.random() * self._tenant_cdf[-1]
        idx = bisect.bisect_left(self._tenant_cdf, pick)
        return self._tenants[sc.abusive_tenants
                             + min(idx, len(self._tenant_cdf) - 1)]

    def _job_for(self, seq: int) -> s.Job:
        """Deterministic job n of the arrival stream: the mix draw keys
        on (scenario seed, n), not on thread interleaving, so two runs
        offer byte-identical load (the reference's job without its
        ``log_config``, a client field the port's structs leave out)."""
        sc = self.sc
        rng = random.Random((sc.seed << 20) ^ seq)
        total = sum(m.weight for m in sc.job_mix)
        pick = rng.random() * total
        shape: JobShape = sc.job_mix[-1]
        for m in sc.job_mix:
            pick -= m.weight
            if pick <= 0:
                shape = m
                break
        job_id = f"lg-{sc.name}-{seq:06d}"
        if sc.update_fraction and seq >= 20 \
                and rng.random() < sc.update_fraction:
            # A job UPDATE: re-register a recent job under a new eval —
            # the duplicate-eval stream per-job coalescing exists for.
            target = rng.randrange(max(0, seq - 500), seq)
            job_id = f"lg-{sc.name}-{target:06d}"
            seq = target
        namespace = self._tenant_for(seq) if self._tenants else ""
        return s.Job(
            region="global", id=job_id, name=job_id,
            namespace=namespace,
            type=s.JOB_TYPE_SERVICE, priority=shape.priority,
            datacenters=["dc1"],
            task_groups=[s.TaskGroup(
                name="tg", count=shape.count,
                ephemeral_disk=s.EphemeralDisk(size_mb=10),
                tasks=[s.Task(
                    name="t", driver="exec",
                    config={"command": "/bin/date"},
                    resources=s.Resources(cpu=shape.cpu,
                                          memory_mb=shape.memory_mb))])])

    # -- client behaviors --------------------------------------------------

    def _submitter(self, client_idx: int) -> None:
        sc = self.sc
        rng = random.Random((sc.seed << 8) ^ client_idx)
        while not self._stop.is_set():
            with self._l:
                seq = self._seq
                if sc.max_submissions and seq >= sc.max_submissions:
                    return
                target_t = self._start_t + seq / sc.arrival_rate
                if target_t >= self._submit_end_t:
                    return
                self._seq = seq + 1
            delay = target_t - time.monotonic()
            if delay > 0:
                if self._stop.wait(delay):
                    return
            job = self._job_for(seq)
            submit_t = time.monotonic()
            rejected = 0
            for attempt in range(sc.submit_retries + 1):
                try:
                    _, eval_id = self.server.job_register(job)
                    rec = _Submission(seq, eval_id, job.id, job.priority,
                                      submit_t, ns=job.namespace)
                    rec.rejected = rejected
                    with self._l:
                        self.subs[eval_id] = rec
                        for kind, t in self._early.pop(eval_id, ()):
                            self._apply_event_locked(rec, kind, t)
                    break
                except BrokerLimitError as e:
                    rejected += 1
                    with self._l:
                        self.reject_events += 1
                        if job.namespace:
                            self.ns_rejects[job.namespace] = \
                                self.ns_rejects.get(job.namespace, 0) + 1
                    if attempt >= sc.submit_retries:
                        with self._l:
                            self.dropped += 1
                            if job.namespace:
                                self.ns_dropped[job.namespace] = \
                                    self.ns_dropped.get(job.namespace,
                                                        0) + 1
                        break
                    # The server's hint plus client-side full jitter —
                    # the same discipline utils/backoff applies.
                    if self._stop.wait(e.retry_after * (0.5 + rng.random())):
                        return
                except Exception:
                    # Transient control-plane churn (leadership moving
                    # in a multi-server cluster, a mid-election window):
                    # a real SDK client retries with backoff rather
                    # than dying — re-registering the same job id is an
                    # idempotent update, so a half-landed earlier
                    # attempt cannot double-place.
                    if attempt >= sc.submit_retries:
                        with self._l:
                            self.dropped += 1
                        self.logger.exception(
                            "loadgen: submission %d dropped", seq)
                        break
                    if self._stop.wait(0.2 * (0.5 + rng.random())):
                        return

    def _heartbeater(self, node_ids: List[str]) -> None:
        """Renew each owned node at ~70% of its granted TTL, like the
        client agent does; granted TTLs are recorded so the report can
        show the jitter dispersal."""
        next_due: Dict[str, float] = {n: 0.0 for n in node_ids}
        while not self._stop.is_set():
            now = time.monotonic()
            soonest = now + 0.5
            for node_id, due in next_due.items():
                if due <= now:
                    try:
                        _, ttl = self.server.node_update_status(
                            node_id, s.NODE_STATUS_READY)
                    except Exception:
                        continue
                    with self._l:
                        self._hb_renewals.append(ttl)
                    next_due[node_id] = now + max(0.2, ttl * 0.7)
                soonest = min(soonest, next_due[node_id])
            if self._stop.wait(max(0.02, soonest - time.monotonic())):
                return

    def _attach_subscribers(self) -> None:
        """K event-stream subscriptions with per-job topic filters (each
        follower watches its own job key, the realistic alloc-watch
        shape): the cost under test is the publish-side filter walk,
        which every state write now pays."""
        for i in range(self.sc.subscribers):
            sub = self.server.event_stream_subscribe(
                topics={"Job": {f"lg-{self.sc.name}-{i:06d}"},
                        "Alloc": {f"lg-{self.sc.name}-{i:06d}"}})
            self._filter_subs.append(sub)

    def _sub_drainer(self) -> None:
        """Keeps the filtered subscriptions from shedding: round-robin
        drain, cheap because most filters match nothing."""
        while not self._stop.is_set():
            for sub in self._filter_subs:
                while sub.next(timeout=0) is not None:
                    pass
            if self._stop.wait(0.25):
                return

    @staticmethod
    def _apply_event_locked(rec: _Submission, kind: str, t: float) -> None:
        if kind == "running":
            if rec.running_t is None:
                rec.running_t = t
        elif rec.done_t is None:
            rec.done_t = t

    def _note_event_locked(self, eval_id: str, kind: str,
                           t: float) -> None:
        """Apply to the tracked record, or buffer for a submission whose
        registering thread hasn't run yet (caller holds self._l)."""
        rec = self.subs.get(eval_id)
        if rec is not None:
            self._apply_event_locked(rec, kind, t)
            return
        self._early.setdefault(eval_id, []).append((kind, t))
        self._early.move_to_end(eval_id)
        while len(self._early) > 2048:
            self._early.popitem(last=False)

    def _tracker(self) -> None:
        """Follows the real event stream (the SDK-visible signal):
        PlanApplied marks submit→running, EvalAcked marks completion."""
        sub = self.server.event_stream_subscribe(
            topics={s.TOPIC_PLAN: set(), "Eval": set()})
        try:
            while True:
                ev = sub.next(timeout=0.2)
                if ev is None:
                    if self._stop.is_set() and self._drained_locked():
                        return
                    continue
                now = time.monotonic()
                if ev.topic == s.TOPIC_PLAN and ev.type == "PlanApplied":
                    placed = int((ev.payload or {}).get("Placed", 0))
                    with self._l:
                        self.placed_events.append((now, placed))
                        if placed > 0:
                            self._note_event_locked(ev.key, "running", now)
                elif ev.topic == "Eval" and ev.type == "EvalAcked":
                    with self._l:
                        self._note_event_locked(ev.key, "done", now)
                elif ev.topic == "Eval" and ev.type == "EvalUpdated":
                    # Terminal status writes also close a submission:
                    # a COALESCED eval is cancelled by the shed reaper
                    # and never acked (its trigger was absorbed by the
                    # kept eval), and failed evals end here too.
                    status = (ev.payload or {}).get("Status", "")
                    if status in (s.EVAL_STATUS_CANCELLED,
                                  s.EVAL_STATUS_FAILED):
                        with self._l:
                            self._note_event_locked(ev.key, "done", now)
        finally:
            sub.close()

    def _drained_locked(self) -> bool:
        with self._l:
            return all(rec.done_t is not None for rec in self.subs.values())

    # -- fan-out probe -----------------------------------------------------

    def _measure_fanout(self, events: int = 200) -> Dict:
        """Publish-side cost per event with the scenario's subscriber
        population attached: the walk over K filters is the fan-out
        bill every state write pays."""
        eb = self.server.event_broker
        t0 = time.perf_counter()
        for i in range(events):
            eb.publish_external("Loadgen", "FanoutProbe", f"probe-{i}")
        elapsed = time.perf_counter() - t0
        return {"subscribers": len(self._filter_subs) + 1,
                "events": events,
                "us_per_event": round(elapsed / events * 1e6, 2)}

    # -- run ---------------------------------------------------------------

    def run(self) -> Dict:
        from .. import codec

        # Codec accounting is process-global and cumulative; snapshot it
        # here so the report's time-split covers THIS run only (the
        # compare_* drivers run several legs in one process).
        self._codec_before = codec.stats()
        # Host-attribution accounting is process-cumulative too: zero
        # the profiler's counters and the contention ledger so the
        # host_attribution section covers THIS run only.
        if contprof.enabled():
            contprof.reset()
            lockcheck.reset_waits()
        try:
            self.server = self._build_server()
            return self._run_inner()
        finally:
            self._stop.set()
            if self._chaos is not None:
                self._chaos.stop()
            if self.auditor is not None:
                self.auditor.stop()
            if self.sc.chaos is not None:
                fault.net_disarm()
            for t in self._threads:
                t.join(timeout=5.0)
            self._stop_followers()
            if self._chaos_pool is not None:
                self._chaos_pool.close()
            if self.server is not None:
                self.server.shutdown()
            if self._prior_switch_interval is not None:
                sys.setswitchinterval(self._prior_switch_interval)
            for path in (self._wal_dir, self._chaos_root):
                if path:
                    import shutil

                    shutil.rmtree(path, ignore_errors=True)

    def _run_inner(self) -> Dict:
        sc = self.sc
        node_ids = self._register_nodes()
        if sc.num_tenants > 0:
            self._register_tenants()
        self._attach_subscribers()

        # The chaos plane and the continuous safety auditor: the exempt
        # control pool is the out-of-band console, so split and heal and
        # the fingerprint and event audits keep reaching a server its
        # data plane can no longer talk to.
        if sc.num_servers > 1 and (sc.chaos is not None or sc.audit):
            from ..server.rpc import ConnPool
            from .auditor import SafetyAuditor

            self._chaos_pool = ConnPool()
            self._chaos_pool.chaos_exempt = True
            # The sweep cadence scales with the run: fingerprints hash
            # the whole replicated store.
            interval = float((sc.chaos or {}).get("audit_interval_s", 1.0))
            self.auditor = SafetyAuditor(
                self.server, self.follower_addrs, pool=self._chaos_pool,
                interval=interval, logger=self.logger.getChild("auditor"))
            self.auditor.start()

        def spawn(fn, *args, name=""):
            t = threading.Thread(target=fn, args=args, daemon=True,
                                 name=name)
            t.start()
            self._threads.append(t)
            return t

        tracker = spawn(self._tracker, name="lg-tracker")
        if self._filter_subs:
            spawn(self._sub_drainer, name="lg-sub-drain")
        if sc.heartbeat:
            # Ceiling split: a truncating divide leaves the remainder
            # nodes with NO heartbeater, and they get marked down
            # mid-run (e.g. 300 nodes / 8 clients stranded 4).
            per = -(-len(node_ids) // max(1, sc.num_clients))
            for c in range(sc.num_clients):
                chunk = node_ids[c * per:(c + 1) * per]
                if chunk:
                    spawn(self._heartbeater, chunk, name=f"lg-hb-{c}")

        self._start_t = time.monotonic() + 0.05
        measure_start = self._start_t + sc.warmup_s
        measure_end = measure_start + sc.measure_s
        self._submit_end_t = measure_end
        if sc.chaos is not None and sc.num_servers > 1:
            self._chaos = _ChaosScheduler(self, sc.chaos,
                                          self.logger.getChild("chaos"))
            self._chaos.start()
        submitters = [spawn(self._submitter, c, name=f"lg-client-{c}")
                      for c in range(sc.num_clients)]

        for t in submitters:
            t.join(timeout=sc.warmup_s + sc.measure_s + 30.0)
        submit_done_t = time.monotonic()
        self._submit_done_t = submit_done_t

        # Drain: bounded wait for the backlog to clear.
        drain_deadline = submit_done_t + sc.drain_s
        while time.monotonic() < drain_deadline:
            if self._drained_locked():
                break
            time.sleep(0.05)
        drained_t = time.monotonic()

        fanout = self._measure_fanout() if self._filter_subs else {}
        report = self._assemble(measure_start, measure_end, drained_t,
                                fanout)
        report["integrity"] = self._collect_integrity()
        if self._chaos is not None:
            # Heal whatever is still split before the auditor's converged
            # cross-check (it needs the cluster whole again).
            self._chaos.stop()
            report["chaos"] = self._chaos_report()
        if self.auditor is not None:
            report["auditor"] = self.auditor.finalize()
            if report["auditor"]["violation_count"]:
                self.logger.error(
                    "SAFETY AUDITOR recorded %d violations",
                    report["auditor"]["violation_count"])
        if self.follower_addrs:
            # Per-server scale-out telemetry, read over the wire while
            # the followers are still up.
            followers = self._follower_stats()
            report["follower_servers"] = followers
            rtts = [f.get("plan_forward_rtt_ms") or {} for f in followers]
            report["plan_forward"] = {
                "servers": len(followers),
                "forwarded_total": sum(f.get("forwarded_plans", 0)
                                       for f in followers),
                "errors_total": sum(f.get("forward_errors", 0)
                                    for f in followers),
                "evals_scheduled_total": sum(f.get("evals_scheduled", 0)
                                             for f in followers),
                "lag_handbacks_total": sum(f.get("lag_handbacks", 0)
                                           for f in followers),
                "rtt_p99_ms_max": max(
                    (r.get("p99") or 0.0 for r in rtts), default=0.0),
            }
        self._stop.set()
        tracker.join(timeout=5.0)
        return report

    # -- report ------------------------------------------------------------

    def _chaos_report(self) -> Dict:
        """Per-event recovery times: seconds from fault injection until
        the 2s-rolling placed/s climbs back to ≥80% of the rate over
        the 6s before the fault.  An event whose bound window runs past
        the end of offered load is CENSORED (not observable), never
        silently counted as recovered."""
        spec = self._chaos.spec
        bound = float(spec.get("recovery_bound_s", 30.0))
        with self._l:
            placed = list(self.placed_events)

        def rate(t0: float, t1: float) -> float:
            if t1 <= t0:
                return 0.0
            return sum(p for t, p in placed if t0 <= t < t1) / (t1 - t0)

        observable_until = getattr(self, "_submit_done_t", 0.0)
        events_out: List[Dict] = []
        recs: List[float] = []
        unrecovered = censored = 0
        for ev in self._chaos.events:
            item = {k: ev.get(k) for k in ("kind", "at_s", "target_addr",
                                           "error") if ev.get(k) is not None}
            t_f = ev.get("t")
            if t_f is None:
                events_out.append(item)
                continue
            for key, label in (("healed_t", "healed_after_s"),
                               ("restarted_t", "restarted_after_s")):
                if ev.get(key):
                    item[label] = round(ev[key] - t_f, 2)
            pre = rate(t_f - 6.0, t_f)
            item["pre_rate_placed_per_s"] = round(pre, 1)
            if pre < 1.0:
                item["recovery_s"] = None
                item["note"] = "no meaningful pre-fault load"
                events_out.append(item)
                continue
            # Recovery = time until the rolling rate is back at target
            # AND STAYS there for the rest of the observed horizon —
            # the first-crossing definition lies when the fault's bite
            # lags the injection (a partition takes a beat to starve
            # the pipeline).  The horizon is clipped to the end of
            # offered load: a dip the submitters' exit would explain
            # censors the event instead of counting it unrecovered.
            target = 0.8 * pre
            horizon = min(t_f + bound, observable_until + 2.0)
            samples = []
            t = t_f
            while t < horizon:
                t += 0.25
                samples.append((t, rate(t - 2.0, t)))
            if not samples:
                censored += 1
                item["recovery_s"] = None
                item["note"] = "censored: offered load ended at the fault"
                events_out.append(item)
                continue
            item["min_rate_ratio"] = round(
                min(r for _, r in samples) / pre, 2)
            below = [t for t, r in samples if r < target]
            if not below and horizon < t_f + bound:
                # No dip observed, but the window was clipped: the bite
                # can lag injection, so an unclipped window is required
                # before claiming the cluster rode through.
                censored += 1
                item["recovery_s"] = None
                item["note"] = "censored: offered load ended inside the bound"
            elif not below:
                # Surviving capacity absorbed it: never dipped past 20%
                # anywhere in the full bound window.
                recs.append(0.0)
                item["recovery_s"] = 0.0
                item["note"] = "rode through (never below 80% of pre-fault)"
            elif below[-1] < samples[-1][0]:
                rec = below[-1] + 0.25 - t_f
                recs.append(rec)
                item["recovery_s"] = round(rec, 2)
            elif horizon < t_f + bound:
                censored += 1
                item["recovery_s"] = None
                item["note"] = "censored: offered load ended inside the bound"
            else:
                unrecovered += 1
                item["recovery_s"] = None
            events_out.append(item)
        recs.sort()

        def pct(q: float):
            return (round(recs[min(len(recs) - 1, int(q * len(recs)))], 2)
                    if recs else None)

        return {"spec": dict(spec), "events": events_out,
                "recovered": len(recs), "unrecovered": unrecovered,
                "censored": censored, "recovery_bound_s": bound,
                "recovery_s": {"p50": pct(0.50), "p90": pct(0.90),
                               "p99": pct(0.99),
                               "max": round(recs[-1], 2) if recs else None}}

    def _codec_split(self) -> Dict:
        """Leader-side codec time-split for this run: per-subsystem
        encode/decode seconds and frame counts.  The port has one codec,
        so ``enabled`` is always true and there is no msgpack residue
        (the reference's ``msgpack_methods``) and no fallback."""
        from .. import codec

        delta = codec.stats_delta(getattr(self, "_codec_before", {}))
        out: Dict = {"enabled": True}
        for sub in ("rpc", "raft", "snapshot"):
            d = delta.get(sub) or {}
            if not (d.get("encodes") or d.get("decodes")):
                continue
            out[sub] = {
                "encode_s": round(d.get("encode_seconds", 0.0), 4),
                "decode_s": round(d.get("decode_seconds", 0.0), 4),
                "encodes": int(d.get("encodes", 0)),
                "decodes": int(d.get("decodes", 0)),
                "fallbacks": 0,
                "encode_mb": round(d.get("encode_bytes", 0) / 1e6, 3),
                "decode_mb": round(d.get("decode_bytes", 0) / 1e6, 3),
            }
        return out

    def _tenancy_section(self, records, ns_rejects: Dict[str, int],
                         ns_dropped: Dict[str, int]) -> Dict:
        """Per-tenant attribution of the run: completion-
        latency percentiles split abuser vs compliant, per-class 429 /
        drop tallies, the broker's per-tenant counters, and the
        committed-state quota sweep — the noisy-neighbor isolation
        numbers the multi_tenant gate asserts on."""
        sc = self.sc
        abusers = set(self._tenants[:sc.abusive_tenants])

        def cls(ns: str) -> str:
            return "abuser" if ns in abusers else "compliant"

        latency: Dict[str, List[float]] = {"abuser": [], "compliant": []}
        accepted = {"abuser": 0, "compliant": 0}
        lost = {"abuser": 0, "compliant": 0}
        for r in records:
            c = cls(r.ns)
            accepted[c] += 1
            if r.done_t is None:
                lost[c] += 1
            else:
                latency[c].append(r.done_t - r.submit_t)
        rejects = {"abuser": 0, "compliant": 0}
        for ns, n in ns_rejects.items():
            rejects[cls(ns)] += n
        dropped = {"abuser": 0, "compliant": 0}
        for ns, n in ns_dropped.items():
            dropped[cls(ns)] += n

        counters = self.server.eval_broker.tenant_counters()
        broker_dequeued = {"abuser": 0, "compliant": 0}
        broker_shed = {"abuser": 0, "compliant": 0}
        for ns, (_pending, deq, shed, _rej) in counters.items():
            if ns in abusers or ns.startswith("lg-"):
                broker_dequeued[cls(ns)] += deq
                broker_shed[cls(ns)] += shed

        # Committed-state quota sweep: the hard bar — no tenant's live
        # alloc count may exceed its registered quota.
        usage = self.server.state.namespace_usage()
        over = []
        if sc.tenant_max_live_allocs > 0:
            for ns in self._tenants:
                live = usage.get(ns, (0, 0, 0, 0, 0))[4]
                if live > sc.tenant_max_live_allocs:
                    over.append({"namespace": ns, "live": live,
                                 "quota": sc.tenant_max_live_allocs})
        return {
            "tenants": len(self._tenants),
            "abusive_tenants": sc.abusive_tenants,
            "objective": self.server.eval_broker.fairness.objective,
            "latency_ms": {c: _percentiles(v)
                           for c, v in latency.items()},
            "accepted": accepted,
            "lost_accepted": lost,
            "rejects_429": rejects,
            "dropped_after_retries": dropped,
            "broker_dequeued": broker_dequeued,
            "broker_shed": broker_shed,
            "active_tenants_in_broker": len(counters),
            "quota_violations": len(over),
            "quota_violation_detail": over[:10],
        }

    def _assemble(self, m_start: float, m_end: float, drained_t: float,
                  fanout: Dict) -> Dict:
        sc = self.sc
        with self._l:
            records = list(self.subs.values())
            hb_ttls = list(self._hb_renewals)
            placed_events = list(self.placed_events)
            dropped = self.dropped
            rejects = self.reject_events
            ns_rejects = dict(self.ns_rejects)
            ns_dropped = dict(self.ns_dropped)

        window = max(1e-9, m_end - m_start)
        completed_in_window = [r for r in records
                               if r.done_t is not None
                               and m_start <= r.done_t <= m_end]
        placed_in_window = sum(p for t, p in placed_events
                               if m_start <= t <= m_end)
        all_done = [r for r in records if r.done_t is not None]
        submit_to_running = [r.running_t - r.submit_t for r in records
                             if r.running_t is not None]
        submit_to_done = [r.done_t - r.submit_t for r in all_done]
        # Active-period rate: completions over first-submit → last-done.
        # For work-bounded runs (max_submissions) this is THE sustained
        # number — the fixed measure window under-reads a burst that
        # drains before the window closes.
        if all_done:
            active = (max(r.done_t for r in all_done)
                      - min(r.submit_t for r in records))
            active_rate = len(all_done) / max(1e-9, active)
            active_placed = sum(p for _, p in placed_events) \
                / max(1e-9, active)
        else:
            active_rate = active_placed = 0.0

        # Server-side histograms/counters (must AGREE with /v1/metrics —
        # they are read from the same sink the endpoint renders).
        latest = self.server.metrics.sink.latest()
        samples = latest.get("Samples", {})
        totals = latest.get("CounterTotals", {})

        def sample(key):
            agg = samples.get(key) or {}
            return {k: agg.get(k) for k in ("count", "p50", "p95", "p99")
                    if agg} if agg else {}

        slowest = sorted((r for r in records if r.running_t is not None),
                         key=lambda r: r.running_t - r.submit_t,
                         reverse=True)[:5]
        report = {
            "scenario": sc.to_dict(),
            "server": {"worker": "torch-batch",
                       "device": str(self.server.device)},
            "offered": {
                "submitted": len(records),
                "target_rate_per_s": sc.arrival_rate,
                "dropped_after_retries": dropped,
                "admission_rejects_seen": rejects,
            },
            "sustained": {
                "window_s": round(window, 3),
                "evals_per_s": round(active_rate, 2),
                "placed_per_s": round(active_placed, 2),
                "evals_per_s_window": round(
                    len(completed_in_window) / window, 2),
                "placed_per_s_window": round(placed_in_window / window, 2),
                "completed_total": len(all_done),
                "completed_in_window": len(completed_in_window),
                "stragglers_after_drain": len(records) - len(all_done),
            },
            "latency_ms": {
                "submit_to_running": _percentiles(submit_to_running),
                "submit_to_complete": _percentiles(submit_to_done),
                "plan_apply": sample("nomad.plan.apply"),
                "plan_apply_fsync": sample("nomad.raft.fsync.plan"),
                "raft_fsync": sample("nomad.raft.fsync"),
                "plan_evaluate": sample("nomad.plan.evaluate"),
                "plan_staleness_entries": sample("nomad.plan.staleness"),
            },
            "control_plane": {
                "plan_conflicts": totals.get("nomad.plan.conflict", 0),
                "snapshot_reuse": totals.get("nomad.worker.snapshot_reuse",
                                             0),
                "snapshot_fresh": totals.get("nomad.worker.snapshot_fresh",
                                             0),
                "broker": self.server.broker_stats(),
            },
            "heartbeat": {
                "renewals": len(hb_ttls),
                "distinct_ttls": len({round(t, 4) for t in hb_ttls}),
                "ttl_min": round(min(hb_ttls), 4) if hb_ttls else 0,
                "ttl_max": round(max(hb_ttls), 4) if hb_ttls else 0,
            },
            "event_fanout": fanout,
            # The leader-side serialization time-split —
            # encode/decode seconds per subsystem over this leg (codec
            # frames + msgpack fallbacks both counted).  Followers
            # report their own split via Status.Metrics.
            "codec": self._codec_split(),
        }
        if sc.num_tenants > 0:
            report["tenancy"] = self._tenancy_section(
                records, ns_rejects, ns_dropped)
        # Where did host CPU go this leg?  Per-subsystem
        # attribution shares + top contended locks + GIL pressure from
        # the continuous profiler (present only when armed; run()
        # resets the cumulative counters at leg start).
        attribution = contprof.host_attribution(top_locks=5)
        if attribution is not None:
            report["host_attribution"] = attribution
        if tracing.enabled() and slowest:
            report["slow_tail_traces"] = [
                {"eval_id": r.eval_id,
                 "submit_to_running_ms": round(
                     (r.running_t - r.submit_t) * 1000.0, 2),
                 "trace": f"Server.trace_for_eval({r.eval_id!r})"}
                for r in slowest]
        return report


def run_scenario(scenario: Scenario,
                 logger: Optional[logging.Logger] = None,
                 **harness_kwargs) -> Dict:
    """One run; ``harness_kwargs`` go to :class:`LoadHarness` (``device``,
    ``server_options``, ``raft_tuning``, ``switch_interval``).  A
    scenario with more than one region runs through
    ``federation.run_multi_region`` (``device`` and ``server_options``)."""
    if scenario.num_regions > 1:
        from .federation import run_multi_region

        return run_multi_region(
            scenario, logger=logger,
            **{k: v for k, v in harness_kwargs.items()
               if k in ("device", "server_options")})
    return LoadHarness(scenario, logger=logger, **harness_kwargs).run()


def compare_wal(scenario: Scenario,
                logger: Optional[logging.Logger] = None,
                **harness_kwargs) -> Dict:
    """Run the same offered load with the in-memory raft log and with
    the durable WAL (FileLog + native group commit), and report the
    plan-apply latency cost of durability measured on the REAL server
    stack — the group-commit win shows up as a WAL-on p99 that stays
    close to WAL-off instead of paying one serial fsync per apply."""
    from dataclasses import replace

    runs = {
        "wal_off": run_scenario(replace(scenario, wal=False),
                                logger=logger, **harness_kwargs),
        "wal_on": run_scenario(replace(scenario, wal=True), logger=logger,
                               **harness_kwargs),
    }

    def p99(run, key):
        agg = run["latency_ms"].get(key) or {}
        return agg.get("p99")

    return {
        "scenario": scenario.name,
        "compare": "wal",
        "evals_per_s": {k: r["sustained"]["evals_per_s"]
                        for k, r in runs.items()},
        "plan_apply_p99_ms": {k: p99(r, "plan_apply")
                              for k, r in runs.items()},
        "plan_apply_fsync": runs["wal_on"]["latency_ms"].get(
            "plan_apply_fsync"),
        "runs": runs,
    }


def compare_servers(scenario: Scenario,
                    logger: Optional[logging.Logger] = None,
                    cluster_leg: bool = True, **harness_kwargs) -> Dict:
    """Horizontal scale-out gate: the same offered load
    against

    - ``single``                — ONE server with the scenario's M
      workers (the stale-snapshot baseline; in-process, single-
      voter, no serialization anywhere);
    - ``cluster_leader_sched``  — the SAME multi-server cluster with
      replication but all scheduling leader-local (what a replicated
      deployment pays without follower reads); and
    - ``cluster_follower_sched`` — follower-read scheduling per the
      scenario (the tentpole path).

    Reports sustained evals/s for each, both speedups, the plan-forward
    RTT tail, plan-conflict rate, and the double-placement sweep — zero
    is the bar."""
    from dataclasses import replace

    single = run_scenario(replace(scenario, num_servers=1), logger=logger,
                          **harness_kwargs)
    cluster = None
    if cluster_leg:
        cluster = run_scenario(
            replace(scenario, leader_workers=scenario.num_workers,
                    follower_workers=-1, follower_voting=True),
            logger=logger, **harness_kwargs)
    multi = run_scenario(scenario, logger=logger, **harness_kwargs)
    single_rate = single["sustained"]["evals_per_s"]
    multi_rate = multi["sustained"]["evals_per_s"]

    def conflicts(run):
        return run["control_plane"]["plan_conflicts"]

    def bad(run):
        integ = run.get("integrity") or {}
        return (integ.get("overplaced_jobs", 0)
                + integ.get("duplicate_alloc_names", 0)
                + integ.get("overcommitted_nodes", 0))

    rates = {f"single_m{scenario.num_workers}": single_rate,
             "cluster_follower_sched": multi_rate}
    out = {
        "scenario": scenario.name,
        "compare": "servers",
        "num_servers": scenario.num_servers,
        "workers_per_server": scenario.num_workers,
        "evals_per_s": rates,
        "speedup": (round(multi_rate / single_rate, 3)
                    if single_rate else None),
        "plan_conflicts": {"single": conflicts(single),
                           "multi": conflicts(multi)},
        "plan_forward": multi.get("plan_forward", {}),
        # The serialization time-split per leg (leader side;
        # per-follower splits ride runs.multi.follower_servers[].codec).
        "codec_split": {
            "single": single.get("codec", {}),
            "multi": multi.get("codec", {}),
            "multi_follower_rpc_encode_s": round(sum(
                (f.get("codec") or {}).get("rpc_encode_s", 0.0)
                for f in multi.get("follower_servers", [])), 4),
            "multi_follower_raft_decode_s": round(sum(
                (f.get("codec") or {}).get("raft_decode_s", 0.0)
                for f in multi.get("follower_servers", [])), 4),
        },
        "double_placements": {"single": bad(single), "multi": bad(multi)},
        "stragglers": {
            "single": single["sustained"]["stragglers_after_drain"],
            "multi": multi["sustained"]["stragglers_after_drain"]},
        "runs": {"single": single, "multi": multi},
    }
    if cluster is not None:
        cluster_rate = cluster["sustained"]["evals_per_s"]
        rates["cluster_leader_sched"] = cluster_rate
        out["speedup_vs_cluster_leader"] = (
            round(multi_rate / cluster_rate, 3) if cluster_rate else None)
        out["double_placements"]["cluster_leader"] = bad(cluster)
        out["runs"]["cluster_leader"] = cluster
    return out


def compare_workers(scenario: Scenario, worker_counts: List[int],
                    logger: Optional[logging.Logger] = None,
                    baseline_serial: bool = True,
                    **harness_kwargs) -> Dict:
    """Run the same offered load at each worker count and report the
    sustained evals/s speedup of the last count over the first.

    With ``baseline_serial`` (the acceptance-gate shape) the FIRST count
    runs with ``stale_snapshot=False`` — the older serial
    discipline (fresh O(cluster) snapshot per eval) — and the rest run
    the stale-snapshot pool, so the ratio is the end-to-end gain of the
    multi-worker stale-snapshot drain over the serial baseline."""
    from dataclasses import replace

    runs = {}
    labels = []
    for i, m in enumerate(worker_counts):
        stale = scenario.stale_snapshot and not (baseline_serial and i == 0)
        label = f"{m}" + ("" if stale else "-serial-baseline")
        labels.append(label)
        runs[label] = run_scenario(
            replace(scenario, num_workers=m, stale_snapshot=stale),
            logger=logger, **harness_kwargs)
    first = runs[labels[0]]["sustained"]["evals_per_s"]
    last = runs[labels[-1]]["sustained"]["evals_per_s"]
    return {
        "scenario": scenario.name,
        "worker_counts": worker_counts,
        "evals_per_s": {lbl: runs[lbl]["sustained"]["evals_per_s"]
                        for lbl in labels},
        "speedup": round(last / first, 3) if first else None,
        "runs": runs,
    }
