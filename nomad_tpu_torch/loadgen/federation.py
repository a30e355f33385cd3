"""The federated load harness: drives N regions as one federation (a
copy of ``nomad_tpu/loadgen/federation.py``).

Topology: ``num_regions`` in-process single-voter Servers, each its own
raft quorum / eval broker / scheduler pool, WAN-joined into one
federation (serf-lite gossip keyed ``(name, region)``).  Clients are
spread round-robin across home regions and submit through their home
server only — exactly how a real fleet fronts a federation — so a
submission whose target region differs from home rides the
rpc.go:263 forwardRegion path, and its wall time IS the cross-region
forward tax the report's percentiles measure.

Robustness legs:

- **blackout** — mid-run, one region is severed from the entire
  federation (``fault.net_sever_regions(isolate=...)``).  The contract
  under test: the dark region keeps serving its OWN clients (in-process
  submits never touch the wire), cross-region submissions into it
  degrade to typed retryable ``NoPathToRegion`` errors honoring the
  retry_after hint — never a hang — and after heal a cross-region probe
  registers AND places inside the recovery bound.
- **federated audit** — the continuous :class:`FederatedAuditor` sweep:
  no job ever holds live allocs in two regions, every region's own
  integrity invariants hold, per-region FSM digests stay single-valued
  per index through partition + heal, and no acked eval is ever lost.
- **global tail** — a :class:`RegionEventAggregator` polls every
  region's ``Event.Since`` over real RPC throughout; during the
  blackout it must go dark on that region (counted, cursor intact) and
  resume without gaps after heal.

Each region's server is the port's: its batch workers run
``TorchBatchScheduler`` on ``device`` (``cuda`` by default, which raises
without a card), and ``server_options`` adds ``ServerConfig`` fields (a
breaker of its own, ``rng_seed``), as ``LoadHarness`` takes them.
"""
from __future__ import annotations

import logging
import random
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from .. import fault
from ..server import Server, ServerConfig
from ..server.eval_broker import BrokerLimitError
from ..server.federation import RegionEventAggregator
from ..server.rpc import ConnPool, NoPathToRegion
from ..structs import structs as s
from .harness import _percentiles
from .scenario import JobShape, Scenario


class _FedSub:
    __slots__ = ("seq", "eval_id", "job_id", "home", "target", "cross",
                 "submit_t", "running_t", "done_t", "rejected")

    def __init__(self, seq: int, eval_id: str, job_id: str, home: str,
                 target: str, cross: bool, submit_t: float):
        self.seq = seq
        self.eval_id = eval_id
        self.job_id = job_id
        self.home = home
        self.target = target
        self.cross = cross
        self.submit_t = submit_t
        self.running_t: Optional[float] = None
        self.done_t: Optional[float] = None
        self.rejected = 0


class MultiRegionHarness:
    """One ``multi_region`` scenario run against a real federation."""

    def __init__(self, scenario: Scenario,
                 logger: Optional[logging.Logger] = None,
                 device: str = "cuda",
                 server_options: Optional[Dict] = None):
        self.sc = scenario
        self.logger = logger or logging.getLogger(
            "nomad_tpu_torch.loadgen.fed")
        self.device = device
        self.server_options = dict(server_options or {})
        self.regions: List[str] = [
            f"r{i}" for i in range(max(2, scenario.num_regions))]
        self.servers: Dict[str, Server] = {}
        self._stop = threading.Event()
        self._l = threading.Lock()
        self._seq = 0
        self._start_t = 0.0
        self._submit_end_t = 0.0
        self.subs: Dict[str, _FedSub] = {}        # eval_id → record
        self._early: "OrderedDict[str, list]" = OrderedDict()
        self.dropped = 0
        self.reject_events = 0
        self.no_path_events = 0                   # NoPathToRegion NACKs seen
        self.no_path_drops = 0                    # gave up after retries
        # Submit wall times (seconds): cross-region forwards vs local.
        self.forward_s: List[float] = []
        self.local_s: List[float] = []
        # Read-probe wall times (seconds): region-local vs forwarded.
        self.read_local_s: List[float] = []
        self.read_cross_s: List[float] = []
        self.read_no_path = 0
        self.placed_by_region: Dict[str, List[Tuple[float, int]]] = {}
        self._threads: List[threading.Thread] = []
        self.auditor = None
        self.aggregator: Optional[RegionEventAggregator] = None
        self._agg_pool: Optional[ConnPool] = None
        self.blackout: Dict = {}

    # -- setup -------------------------------------------------------------

    def _build_servers(self) -> None:
        sc = self.sc
        for i, region in enumerate(self.regions):
            opts = dict(
                region=region, node_name=f"lg-{region}",
                enable_rpc=True, num_schedulers=sc.num_workers,
                batch_size=sc.batch_size, device=self.device,
                min_heartbeat_ttl=sc.min_heartbeat_ttl,
                broker_max_pending=sc.broker_max_pending,
                broker_coalesce=sc.broker_coalesce)
            if i:
                opts["wan_join"] = [
                    self.servers[self.regions[0]].config.rpc_advertise]
            opts.update(self.server_options)
            srv = Server(ServerConfig(**opts),
                         logger=self.logger.getChild(region))
            # Registered before start(), so run() shuts it down whatever
            # fails from here on.
            self.servers[region] = srv
            srv.start()

        def formed() -> bool:
            return all(srv.is_leader()
                       and len(srv.members()) == len(self.regions)
                       for srv in self.servers.values())

        deadline = time.monotonic() + 30.0
        while not formed() and time.monotonic() < deadline:
            time.sleep(0.05)
        if not formed():
            raise RuntimeError(
                "federation failed to form: "
                + ", ".join(f"{r}: leader={srv.is_leader()} "
                            f"members={len(srv.members())}"
                            for r, srv in self.servers.items()))
        self.logger.info("fed loadgen: federation up — %s",
                         {r: srv.config.rpc_advertise
                          for r, srv in self.servers.items()})

    def _register_nodes(self) -> Dict[str, List[str]]:
        sc = self.sc
        per = max(1, sc.num_nodes // len(self.regions))
        out: Dict[str, List[str]] = {}
        for region, srv in self.servers.items():
            ids = []
            for i in range(per):
                node = s.Node(
                    id=f"lg-{region}-n{i:04d}",
                    datacenter="dc1", name=f"lg-{region}-n{i:04d}",
                    attributes={"kernel.name": "linux", "driver.exec": "1"},
                    resources=s.Resources(cpu=sc.node_cpu,
                                          memory_mb=sc.node_memory_mb,
                                          disk_mb=100 * 1024, iops=1000),
                    reserved=s.Resources(),
                    node_class="loadgen",
                    status=s.NODE_STATUS_READY)
                srv.node_register(node)
                ids.append(node.id)
            out[region] = ids
        return out

    # -- client behaviors --------------------------------------------------

    def _heartbeater(self, region: str, node_ids: List[str]) -> None:
        srv = self.servers[region]
        next_due: Dict[str, float] = {n: 0.0 for n in node_ids}
        while not self._stop.is_set():
            now = time.monotonic()
            soonest = now + 0.5
            for node_id, due in next_due.items():
                if due <= now:
                    try:
                        _, ttl = srv.node_update_status(
                            node_id, s.NODE_STATUS_READY)
                    except Exception:
                        continue
                    next_due[node_id] = now + max(0.2, ttl * 0.7)
                soonest = min(soonest, next_due[node_id])
            if self._stop.wait(max(0.02, soonest - time.monotonic())):
                return

    @staticmethod
    def _apply_event_locked(rec: _FedSub, kind: str, t: float) -> None:
        if kind == "running":
            if rec.running_t is None:
                rec.running_t = t
        elif rec.done_t is None:
            rec.done_t = t

    def _note_event_locked(self, eval_id: str, kind: str,
                           t: float) -> None:
        rec = self.subs.get(eval_id)
        if rec is not None:
            self._apply_event_locked(rec, kind, t)
            return
        self._early.setdefault(eval_id, []).append((kind, t))
        self._early.move_to_end(eval_id)
        while len(self._early) > 2048:
            self._early.popitem(last=False)

    def _tracker(self, region: str) -> None:
        """Follows one region's event stream in-process (the region's
        SDK-visible signal): PlanApplied marks submit→running, EvalAcked
        marks completion and feeds the lost-acked audit."""
        srv = self.servers[region]
        sub = srv.event_stream_subscribe(
            topics={s.TOPIC_PLAN: set(), "Eval": set()})
        try:
            while True:
                ev = sub.next(timeout=0.2)
                if ev is None:
                    if self._stop.is_set():
                        return
                    continue
                now = time.monotonic()
                if ev.topic == s.TOPIC_PLAN and ev.type == "PlanApplied":
                    placed = int((ev.payload or {}).get("Placed", 0))
                    with self._l:
                        self.placed_by_region.setdefault(
                            region, []).append((now, placed))
                        if placed > 0:
                            self._note_event_locked(ev.key, "running", now)
                elif ev.topic == "Eval" and ev.type == "EvalAcked":
                    if self.auditor is not None:
                        self.auditor.note_acked(region, ev.key)
                    with self._l:
                        self._note_event_locked(ev.key, "done", now)
                elif ev.topic == "Eval" and ev.type == "EvalUpdated":
                    status = (ev.payload or {}).get("Status", "")
                    if status in (s.EVAL_STATUS_CANCELLED,
                                  s.EVAL_STATUS_FAILED):
                        with self._l:
                            self._note_event_locked(ev.key, "done", now)
        finally:
            sub.close()

    def _job_for(self, seq: int, home: str) -> Tuple[s.Job, str, bool]:
        """Deterministic job n of the arrival stream.  The mix draw and
        the cross-region draw key on (seed, n); the cross TARGET is
        drawn relative to the submitting client's home region."""
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
        cross = (len(self.regions) > 1
                 and rng.random() < sc.cross_region_fraction)
        if cross:
            others = [r for r in self.regions if r != home]
            target = others[rng.randrange(len(others))]
        else:
            target = home
        job_id = f"lg-{sc.name}-{seq:06d}"
        job = s.Job(
            region=target, id=job_id, name=job_id,
            type=s.JOB_TYPE_SERVICE, priority=shape.priority,
            datacenters=["dc1"],
            task_groups=[s.TaskGroup(
                name="tg", count=shape.count,
                ephemeral_disk=s.EphemeralDisk(size_mb=10),
                tasks=[s.Task(
                    name="t", driver="exec",
                    config={"command": "/bin/date"},
                    resources=s.Resources(cpu=shape.cpu,
                                          memory_mb=shape.memory_mb),
                    log_config=s.LogConfig())])])
        return job, target, cross

    def _submitter(self, client_idx: int) -> None:
        """One region-homed client on the shared open-loop schedule.
        429 NACKs and NoPathToRegion both retry with the server's
        retry_after hint plus client-side full jitter — a down region is
        a typed, bounded backoff, never a stall."""
        sc = self.sc
        home = self.regions[client_idx % len(self.regions)]
        srv = self.servers[home]
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
            if delay > 0 and self._stop.wait(delay):
                return
            job, target, cross = self._job_for(seq, home)
            submit_t = time.monotonic()
            rejected = 0
            for attempt in range(sc.submit_retries + 1):
                t0 = time.monotonic()
                try:
                    if cross:
                        _, eval_id = srv.job_register(job, region=target)
                    else:
                        _, eval_id = srv.job_register(job)
                    call_s = time.monotonic() - t0
                    rec = _FedSub(seq, eval_id, job.id, home, target,
                                  cross, submit_t)
                    rec.rejected = rejected
                    with self._l:
                        self.subs[eval_id] = rec
                        (self.forward_s if cross
                         else self.local_s).append(call_s)
                        for kind, t in self._early.pop(eval_id, ()):
                            self._apply_event_locked(rec, kind, t)
                    break
                except NoPathToRegion as e:
                    with self._l:
                        self.no_path_events += 1
                    if attempt >= sc.submit_retries:
                        with self._l:
                            self.dropped += 1
                            self.no_path_drops += 1
                        break
                    if self._stop.wait(e.retry_after * (0.5 + rng.random())):
                        return
                except BrokerLimitError as e:
                    rejected += 1
                    with self._l:
                        self.reject_events += 1
                    if attempt >= sc.submit_retries:
                        with self._l:
                            self.dropped += 1
                        break
                    if self._stop.wait(e.retry_after * (0.5 + rng.random())):
                        return
                except Exception:
                    if attempt >= sc.submit_retries:
                        with self._l:
                            self.dropped += 1
                        self.logger.exception(
                            "fed loadgen: submission %d dropped", seq)
                        break
                    if self._stop.wait(0.2 * (0.5 + rng.random())):
                        return

    def _reader(self) -> None:
        """Read probe: region-local listings on each region's own server
        (never leave the region) plus a forwarded cross-region listing —
        the read half of the forward tax.  A dark region's cross read
        degrades to NoPathToRegion, counted, never a hang."""
        prefix = f"lg-{self.sc.name}-"
        i = 0
        while not self._stop.wait(0.5):
            region = self.regions[i % len(self.regions)]
            srv = self.servers[region]
            t0 = time.monotonic()
            try:
                srv.job_list(prefix=prefix)
                with self._l:
                    self.read_local_s.append(time.monotonic() - t0)
            except Exception:
                pass
            other = self.regions[(i + 1) % len(self.regions)]
            if other != region:
                t0 = time.monotonic()
                try:
                    srv.job_list(prefix=prefix, region=other)
                    with self._l:
                        self.read_cross_s.append(time.monotonic() - t0)
                except NoPathToRegion:
                    with self._l:
                        self.read_no_path += 1
                except Exception:
                    pass
            i += 1

    # -- blackout + heal leg -----------------------------------------------

    def _probe_job(self, target: str, n: int) -> s.Job:
        job_id = f"lg-mr-probe-{n:03d}"
        return s.Job(
            region=target, id=job_id, name=job_id,
            type=s.JOB_TYPE_SERVICE, priority=50, datacenters=["dc1"],
            task_groups=[s.TaskGroup(
                name="tg", count=1,
                ephemeral_disk=s.EphemeralDisk(size_mb=10),
                tasks=[s.Task(
                    name="t", driver="exec",
                    config={"command": "/bin/date"},
                    resources=s.Resources(cpu=50, memory_mb=64),
                    log_config=s.LogConfig())])])

    def _blackout_leg(self) -> None:
        """Sever one region from the whole federation, hold, heal, then
        prove recovery: a cross-region probe from a surviving region
        must register AND place in the healed region inside the bound."""
        sc = self.sc
        spec = dict(sc.region_blackout or {})
        target = spec.get("region") or self.regions[-1]
        if target not in self.servers:
            self.blackout = {"error": f"unknown blackout region {target!r}"}
            return
        due = self._start_t + float(spec.get("at_s", 4.0))
        while not self._stop.is_set():
            wait = due - time.monotonic()
            if wait <= 0:
                break
            self._stop.wait(min(wait, 0.25))
        if self._stop.is_set():
            return
        region_addrs = {r: [srv.config.rpc_advertise]
                        for r, srv in self.servers.items()}
        duration = float(spec.get("duration_s", 3.0))
        bound = float(spec.get("recovery_bound_s", 30.0))
        name = "lg-region-blackout"
        t_fault = time.monotonic()
        fault.net_sever_regions(region_addrs, isolate=target, name=name)
        self.logger.info("fed loadgen: region %s blacked out for %.1fs",
                         target, duration)
        self._stop.wait(duration)
        fault.net_heal(name)
        t_heal = time.monotonic()

        src = next(r for r in self.regions if r != target)
        srv = self.servers[src]
        registered_s: Optional[float] = None
        placed_s: Optional[float] = None
        probe_id = ""
        deadline = t_heal + bound
        attempts = 0
        while time.monotonic() < deadline and registered_s is None:
            probe = self._probe_job(target, attempts)
            attempts += 1
            try:
                srv.job_register(probe, region=target)
                registered_s = time.monotonic() - t_heal
                probe_id = probe.id
                break
            except Exception:
                if self._stop.wait(0.25):
                    break
        if registered_s is not None:
            state = self.servers[target].state
            while time.monotonic() < deadline:
                live = [a for a in state.allocs_by_job(None, probe_id, True)
                        if not a.terminal_status()]
                if live:
                    placed_s = time.monotonic() - t_heal
                    break
                if self._stop.wait(0.1):
                    break
        self.blackout = {
            "region": target,
            "at_s": round(t_fault - self._start_t, 2),
            "duration_s": duration,
            "healed": True,
            "recovery_bound_s": bound,
            "probe_attempts": attempts,
            "registered_after_heal_s": (round(registered_s, 2)
                                        if registered_s is not None
                                        else None),
            "placed_after_heal_s": (round(placed_s, 2)
                                    if placed_s is not None else None),
            "recovered": placed_s is not None,
        }
        self.logger.info("fed loadgen: blackout healed — recovery %s",
                         self.blackout)

    # -- aggregator --------------------------------------------------------

    def _agg_loop(self) -> None:
        while not self._stop.wait(0.25):
            try:
                self.aggregator.poll()
            except Exception:
                self.logger.exception("fed loadgen: aggregator poll failed")

    # -- run ---------------------------------------------------------------

    def run(self) -> Dict:
        try:
            self._build_servers()
            return self._run_inner()
        finally:
            self._stop.set()
            fault.net_disarm()
            if self.auditor is not None:
                self.auditor.stop()
            for t in self._threads:
                t.join(timeout=5.0)
            if self._agg_pool is not None:
                self._agg_pool.close()
            for srv in self.servers.values():
                srv.shutdown()

    def _drained(self) -> bool:
        with self._l:
            return all(rec.done_t is not None for rec in self.subs.values())

    def _run_inner(self) -> Dict:
        sc = self.sc
        nodes = self._register_nodes()
        if sc.audit:
            from .auditor import FederatedAuditor

            self.auditor = FederatedAuditor(
                self.servers, interval=1.0,
                logger=self.logger.getChild("auditor"))
            self.auditor.start()
        self._agg_pool = ConnPool()
        self.aggregator = RegionEventAggregator(
            {r: srv.config.rpc_advertise
             for r, srv in self.servers.items()},
            pool=self._agg_pool)

        def spawn(fn, *args, name=""):
            t = threading.Thread(target=fn, args=args, daemon=True,
                                 name=name)
            t.start()
            self._threads.append(t)
            return t

        for region in self.regions:
            spawn(self._tracker, region, name=f"fed-track-{region}")
            if sc.heartbeat:
                spawn(self._heartbeater, region, nodes[region],
                      name=f"fed-hb-{region}")
        spawn(self._agg_loop, name="fed-agg")
        spawn(self._reader, name="fed-reader")

        self._start_t = time.monotonic() + 0.05
        self._submit_end_t = self._start_t + sc.warmup_s + sc.measure_s
        blackout_thread = None
        if sc.region_blackout is not None:
            blackout_thread = spawn(self._blackout_leg, name="fed-blackout")
        submitters = [spawn(self._submitter, c, name=f"fed-client-{c}")
                      for c in range(sc.num_clients)]
        for t in submitters:
            t.join(timeout=sc.warmup_s + sc.measure_s + 60.0)
        submit_done_t = time.monotonic()

        drain_deadline = submit_done_t + sc.drain_s
        while time.monotonic() < drain_deadline:
            if self._drained():
                break
            time.sleep(0.05)
        if blackout_thread is not None:
            bound = float((sc.region_blackout or {}).get(
                "recovery_bound_s", 30.0))
            blackout_thread.join(timeout=bound + 20.0)

        report = self._assemble(len(next(iter(nodes.values()))))
        if self.auditor is not None:
            report["auditor"] = self.auditor.finalize()
            if report["auditor"]["violation_count"]:
                self.logger.error(
                    "FEDERATED AUDITOR recorded %d violations",
                    report["auditor"]["violation_count"])
        return report

    # -- report ------------------------------------------------------------

    def _assemble(self, nodes_per_region: int) -> Dict:
        sc = self.sc
        with self._l:
            records = list(self.subs.values())
            forward_s = list(self.forward_s)
            local_s = list(self.local_s)
            read_local_s = list(self.read_local_s)
            read_cross_s = list(self.read_cross_s)
            placed_by_region = {r: list(v)
                                for r, v in self.placed_by_region.items()}
            dropped = self.dropped
            rejects = self.reject_events
            no_path = self.no_path_events
            no_path_drops = self.no_path_drops
            read_no_path = self.read_no_path

        all_done = [r for r in records if r.done_t is not None]
        submit_to_running = [r.running_t - r.submit_t for r in records
                             if r.running_t is not None]
        submit_to_done = [r.done_t - r.submit_t for r in all_done]
        placed_total = sum(p for evs in placed_by_region.values()
                           for _, p in evs)
        if all_done:
            active = (max(r.done_t for r in all_done)
                      - min(r.submit_t for r in records))
            active_rate = len(all_done) / max(1e-9, active)
            placed_rate = placed_total / max(1e-9, active)
        else:
            active_rate = placed_rate = 0.0

        per_region: Dict[str, Dict] = {}
        for region in self.regions:
            recs = [r for r in records if r.target == region]
            per_region[region] = {
                "submitted": len(recs),
                "completed": sum(1 for r in recs if r.done_t is not None),
                "cross_in": sum(1 for r in recs if r.cross),
                "placed": sum(p for _, p in
                              placed_by_region.get(region, [])),
            }
        cross_records = [r for r in records if r.cross]

        return {
            "scenario": sc.to_dict(),
            "offered": {
                "submitted": len(records),
                "target_rate_per_s": sc.arrival_rate,
                "dropped_after_retries": dropped,
                "admission_rejects_seen": rejects,
                "no_path_events": no_path,
                "no_path_drops": no_path_drops,
            },
            "sustained": {
                "window_s": round(sc.measure_s, 3),
                "evals_per_s": round(active_rate, 2),
                "placed_per_s": round(placed_rate, 2),
                "completed_total": len(all_done),
                "stragglers_after_drain": len(records) - len(all_done),
            },
            "latency_ms": {
                "submit_to_running": _percentiles(submit_to_running),
                "submit_to_complete": _percentiles(submit_to_done),
            },
            "federation": {
                "regions": list(self.regions),
                "nodes_per_region": nodes_per_region,
                "cross_submitted": len(cross_records),
                "cross_completed": sum(1 for r in cross_records
                                       if r.done_t is not None),
                "forward_tax_ms": {
                    "local": _percentiles(local_s),
                    "cross": _percentiles(forward_s),
                },
                "reads_ms": {
                    "local": _percentiles(read_local_s),
                    "cross": _percentiles(read_cross_s),
                },
                "read_no_path_events": read_no_path,
                "per_region": per_region,
                "blackout": self.blackout or None,
                "aggregator": (self.aggregator.stats()
                               if self.aggregator is not None else {}),
            },
        }


def run_multi_region(scenario: Scenario,
                     logger: Optional[logging.Logger] = None,
                     device: str = "cuda",
                     server_options: Optional[Dict] = None) -> Dict:
    return MultiRegionHarness(scenario, logger=logger, device=device,
                              server_options=server_options).run()
