"""``python -m nomad_tpu_torch.ops --selfcheck``: the port's drills.

    python -m nomad_tpu_torch.ops --selfcheck [--device cpu|cuda]
        [--nodes N --specs U --seed S --snapshot-chunk BYTES]

- The preemption drill (``nomad_tpu/ops/__main__.py:1542-1562``, its
  first check): the eviction sets of ``ops/preempt.py`` on ``--device``
  (default ``cuda``, which builds and launches the kernel and raises
  without a card) against the scalar oracle over every (spec, node) pair
  of a seeded random cluster.
- The columnar drill (``nomad_tpu/ops/__main__.py:333``): batches through
  ``TorchBatchScheduler`` on ``--device`` over a store with its columnar
  mirror and the guards at every read.  The cold build is verified
  bit-identical to the walk, incremental node writes keep parity, an
  injected ``state.columns`` corruption is caught and trips a private
  breaker while the walk's buffers carry that batch (its placements equal
  a clean twin's), and the open breaker routes the next batch through
  the oracle.
- The tracing drill (``nomad_tpu/ops/__main__.py:113-211``): with the
  tracing plane armed, one batch on ``--device`` must leave a
  ``batch.schedule`` root with every phase span under it (``phase1``,
  ``phase2``, ``encode``, ``device``, one ``fetch``, ``metrics``,
  ``finalize``), starts monotone; an injected ``ops.kernel_result``
  corruption must be traced as ``batch.oracle_routed(kernel_reject)`` with
  its ``fault.fire``, and the open breaker's next batch as
  ``batch.oracle_routed(breaker_open)``.  It always disarms on exit.

- The WAL drill (``nomad_tpu/ops/__main__.py:456-528``): entries
  appended through a ``FileLog`` on the native group-commit WAL and
  snapshotted, more appended, then one under a ``wal.fsync`` crash (a
  torn half frame is left on disk); recovery truncates the torn tail,
  keeps every committed entry and never applies the torn one; the
  recovered store schedules one batch on ``--device``, and an entry
  appended after the recovery survives the next boot.
- The follower drill (``nomad_tpu/ops/__main__.py:1186-1318``): a
  3-voter port cluster on loopback whose servers run no batch workers,
  only follower workers, schedules a job on a follower (the plan
  forwarded to the leader's plan-apply, visible on every FSM); then the
  leader is compacted past its log and a fresh joiner catches up by a
  chunked InstallSnapshot (``--snapshot-chunk`` bytes, default 1024).
  The servers run on ``--device`` (the leader's plan applier re-checks
  the fit there); follower workers use the CPU schedulers.

Exits 0 when every drill passes, 1 otherwise.  The reference's other
drills (breaker, residency, fused, residue, mesh) wait for their modules'
ports.
"""
from __future__ import annotations

import argparse
import sys

from .preempt import selfcheck


def _drill_node(i: int):
    from .. import mock

    node = mock.node()
    node.id = node.name = f"drill-node-{i:02d}"
    node.resources.networks = []
    node.reserved.networks = []
    node.compute_class()
    return node


def _drill_job(k: int, count: int = 2):
    from .. import mock

    job = mock.job()
    job.id = job.name = f"drill-job-{k}"
    job.task_groups[0].count = count
    for tg in job.task_groups:
        for t in tg.tasks:
            t.resources.networks = []
    return job


class _DrillWorld:
    """A store with its columnar mirror, a harness and a private breaker;
    every batch of the drill runs in two of them alike (the second clean)
    so placements can be compared."""

    def __init__(self, device, seed: int):
        from ..scheduler.testing import Harness
        from .breaker import KernelCircuitBreaker

        self.h = Harness()
        self.device = device
        self.seed = seed
        self.breaker = KernelCircuitBreaker(threshold=0.9, window=8,
                                            min_checks=1, cooldown=3600.0)
        self.jobs = 0
        self.last_eval_id = ""

    def add_node(self, i: int) -> None:
        self.h.state.upsert_node(self.h.next_index(), _drill_node(i))

    def run_batch(self):
        """One register eval of a fresh 2-alloc job: (stats, the job's
        live placements as sorted (name, node))."""
        from ..structs import structs as s
        from .batch_sched import TorchBatchScheduler

        job = _drill_job(self.jobs)
        self.jobs += 1
        self.h.state.upsert_job(self.h.next_index(), job)
        ev = s.Evaluation(
            id=f"drill-eval-{self.jobs}", priority=job.priority,
            type=job.type, triggered_by=s.EVAL_TRIGGER_JOB_REGISTER,
            job_id=job.id, status=s.EVAL_STATUS_PENDING)
        self.last_eval_id = ev.id
        sched = TorchBatchScheduler(
            self.h.logger, self.h.snapshot(), self.h, device=self.device,
            breaker=self.breaker, rng_seed=self.seed,
            columnar_guard_every=1)
        stats = sched.schedule_batch([ev])
        placed = sorted((a.name, a.node_id)
                        for a in self.h.state.allocs_by_job(None, job.id,
                                                            True)
                        if not a.terminal_status())
        return stats, placed


def columnar_drill(seed: int = 0, device=None, log=print) -> bool:
    """The columnar state-store drill (see the module docstring)."""
    from .. import fault
    from ..state import columnar

    def check(cond, msg):
        if not cond:
            log(f"columnar drill: FAIL — {msg}")
        return cond

    columnar.reset_counters()
    epoch0 = columnar.EPOCH
    world, clean = _DrillWorld(device, seed), _DrillWorld(device, seed)
    try:
        for w in (world, clean):
            for i in range(8):
                w.add_node(i)

        # 1. The cold build and the first columnar encode, guard-verified.
        _, p1 = world.run_batch()
        _, c1 = clean.run_batch()
        if not (check(columnar.COLUMNAR_ENCODES >= 1,
                      "the first batch did not take the columnar encode")
                and check(columnar.GUARD_RUNS >= 1
                          and columnar.GUARD_MISMATCHES == 0,
                          "the guard did not verify the cold build")
                and check(len(p1) == 2 and p1 == c1,
                          f"the cold batch placed {p1}, the twin {c1}")):
            return False

        # 2. Incremental writes (a drain flip, a fresh node) re-key the
        # static cache; the columnar re-encode must still equal the walk.
        for w in (world, clean):
            st = w.h.state
            nid = st.nodes(None)[0].id
            st.update_node_drain(w.h.next_index(), nid, True)
            st.update_node_drain(w.h.next_index(), nid, False)
            w.add_node(8)
        guard_before = columnar.GUARD_RUNS
        _, p2 = world.run_batch()
        _, c2 = clean.run_batch()
        if not (check(columnar.GUARD_RUNS > guard_before
                      and columnar.GUARD_MISMATCHES == 0,
                      "the guard did not verify the incremental re-encode")
                and check(len(p2) == 2 and p2 == c2,
                          f"the incremental batch placed {p2}, the twin "
                          f"{c2}")):
            return False

        # 3. An injected column corruption: the guard catches it, feeds
        # the breaker, and the walk's buffers carry the batch.
        for w in (world, clean):
            w.add_node(9)  # a new nodes index: the static encode is cold
        with fault.scenario({"seed": seed, "faults": [
                {"point": "state.columns", "action": "corrupt",
                 "times": 1}]}):
            _, p3 = world.run_batch()
        _, c3 = clean.run_batch()
        if not (check(columnar.GUARD_MISMATCHES == 1,
                      "the guard missed the injected corruption")
                and check(columnar.EPOCH == epoch0 + 1,
                          "the mismatch did not bump the epoch")
                and check(world.breaker.state == "open",
                          f"breaker {world.breaker.state!r}, expected "
                          "open")
                and check(clean.breaker.state == "closed",
                          "the clean twin's breaker left closed")
                and check(len(p3) == 2 and p3 == c3,
                          f"the corrupted batch placed {p3}, the clean "
                          f"twin {c3}")):
            return False

        # 4. The open breaker: the oracle carries the next batch.
        s4, p4 = world.run_batch()
        if not (check(s4.oracle_routed > 0,
                      "the open breaker did not route through the oracle")
                and check(len(p4) == 2, "the oracle's batch did not "
                          "place")):
            return False
    finally:
        columnar.reset_counters()
    log("columnar drill: OK — cold build verified bit-identical to the "
        "walk, incremental writes kept parity, the injected corruption "
        "tripped the breaker with the walk carrying the batch (placements "
        "equal the clean twin's), the oracle carried the next batch "
        f"(device {world.device or 'cuda'})")
    return True


# The phase spans of one device batch, in the order their starts must
# follow, each parented under the batch.schedule root.
PHASE_SPANS = ("batch.phase1", "batch.phase2", "batch.encode",
               "batch.device", "batch.fetch", "batch.metrics",
               "batch.finalize")


def tracing_drill(seed: int = 0, device=None, log=print) -> bool:
    """The tracing drill (see the module docstring)."""
    from .. import fault
    from ..utils import tracing

    def check(cond, msg):
        if not cond:
            log(f"tracing drill: FAIL — {msg}")
        return cond

    world = _DrillWorld(device, seed)
    for i in range(8):
        world.add_node(i)
    tracing.enable()
    try:
        stats, placed = world.run_batch()
        spans = tracing.trace_for_eval(world.last_eval_id)
        names = [sp["Name"] for sp in spans]
        roots = [sp for sp in spans if sp["Name"] == "batch.schedule"]
        if not (check(len(roots) == 1, f"{len(roots)} batch.schedule "
                      "roots")
                and check(len(placed) == 2, f"the batch placed {placed}")
                and check(all(names.count(n) == 1 for n in PHASE_SPANS),
                          f"phase spans missing or repeated in {names}")):
            return False
        by_name = {sp["Name"]: sp for sp in spans}
        root = roots[0]
        starts = [by_name[n]["Start"] for n in PHASE_SPANS]
        device_ms = by_name["batch.device"]["DurationMs"]
        if not (check(all(by_name[n]["ParentID"] == root["SpanID"]
                          for n in PHASE_SPANS),
                      "phase spans not parented under batch.schedule")
                and check(root["Start"] <= starts[0]
                          and starts == sorted(starts),
                          f"phase starts not monotone: "
                          f"{list(zip(PHASE_SPANS, starts))}")
                and check(abs(device_ms - stats.device_seconds * 1000.0)
                          < 1e-3,
                          f"batch.device {device_ms} ms, device_seconds "
                          f"{stats.device_seconds}")
                and check(by_name["batch.device"]["Attrs"].get("rounds")
                          == stats.rounds, "batch.device rounds")):
            return False

        with fault.scenario({"seed": seed, "faults": [
                {"point": "ops.kernel_result", "action": "corrupt",
                 "times": 1}]}):
            stats2, placed2 = world.run_batch()
        spans2 = tracing.trace_for_eval(world.last_eval_id)
        routed = [sp for sp in spans2
                  if sp["Name"] == "batch.oracle_routed"]
        fires = [sp for sp in spans2 if sp["Name"] == "fault.fire"]
        if not (check(routed, "the corrupted batch produced no "
                              "batch.oracle_routed span")
                and check(routed[0]["Attrs"].get("reason")
                          == "kernel_reject", f"bad attrs {routed[0]}")
                and check(fires and fires[0]["Attrs"].get("point")
                          == "ops.kernel_result",
                          "fault.fire not correlated into the eval trace")
                and check(world.breaker.state == "open",
                          f"breaker {world.breaker.state!r}, expected "
                          "open")
                and check(len(placed2) == 2, "the oracle did not place "
                                             "the corrupted batch")):
            return False

        _, placed3 = world.run_batch()    # the breaker is open
        routed3 = [sp for sp in tracing.trace_for_eval(world.last_eval_id)
                   if sp["Name"] == "batch.oracle_routed"]
        if not (check(routed3, "the open-breaker batch produced no "
                               "batch.oracle_routed span")
                and check(routed3[0]["Attrs"].get("reason")
                          == "breaker_open", f"bad attrs {routed3[0]}")
                and check(len(placed3) == 2, "the oracle did not place "
                                             "the open-breaker batch")):
            return False
    finally:
        tracing.disable()
    log(f"tracing drill: OK — batch.schedule with the {len(PHASE_SPANS)} "
        f"phase spans under it, starts monotone ({len(spans)} spans for "
        "one eval), the corrupt batch traced as oracle_routed("
        "kernel_reject) + fault.fire, the open breaker as oracle_routed("
        f"breaker_open) (device {world.device or 'cuda'})")
    return True


def wal_drill(seed: int = 0, device: str = "cuda", log=print) -> bool:
    """Crash mid-frame, recover, and keep going (see the module
    docstring)."""
    import os
    import shutil
    import tempfile

    from .. import fault
    from ..scheduler.testing import Harness
    from ..server.fsm import FSM, MessageType
    from ..server.raft import FileLog
    from ..structs import structs as s
    from .batch_sched import TorchBatchScheduler

    def check(cond, msg):
        if not cond:
            log(f"wal drill: FAIL — {msg}")
        return cond

    d = tempfile.mkdtemp(prefix="nomad-torch-waldrill-")
    try:
        flog = FileLog(FSM(), d, snapshot_entries=0, snapshot_bytes=0)
        nodes = [_drill_node(i) for i in range(8)]
        for node in nodes[:4]:
            flog.apply(MessageType.NODE_REGISTER, {"node": node})
        flog.snapshot()
        for node in nodes[4:]:
            flog.apply(MessageType.NODE_REGISTER, {"node": node})
        applied = flog.applied_index()
        torn_job = _drill_job(0)
        crashed = False
        with fault.scenario({"seed": seed, "faults": [
                {"point": "wal.fsync", "action": "crash", "times": 1}]}):
            try:
                flog.apply(MessageType.JOB_REGISTER, {"job": torn_job})
            except fault.InjectedFault:
                crashed = True
        flog.close()
        if not check(crashed, "the injected mid-frame crash did not fire"):
            return False
        wal_file = os.path.join(d, "wal.crc")
        torn_size = os.path.getsize(wal_file)

        flog2 = FileLog(FSM(), d, snapshot_entries=0, snapshot_bytes=0)
        st = flog2.fsm.state
        if not (check(flog2.applied_index() == applied,
                      "recovery lost or invented entries")
                and check(flog2.recovery["snapshot_index"] == 4,
                          "recovery did not start from the snapshot")
                and check(len(st.nodes(None)) == len(nodes),
                          "a committed entry was lost")
                and check(st.job_by_id(None, torn_job.id) is None,
                          "the torn entry was applied")
                and check(os.path.getsize(wal_file) < torn_size,
                          "the torn tail was not truncated")):
            flog2.close()
            return False
        # The recovered store keeps scheduling on the device.
        job = _drill_job(1, count=4)
        flog2.apply(MessageType.JOB_REGISTER, {"job": job})
        h = Harness(st)
        h._next_index = flog2.applied_index() + 1
        ev = s.Evaluation(id=s.generate_uuid(), priority=job.priority,
                          type=job.type, job_id=job.id,
                          triggered_by=s.EVAL_TRIGGER_JOB_REGISTER)
        TorchBatchScheduler(h.logger, st.snapshot(), h, device=device,
                            rng_seed=seed).schedule_batch([ev])
        placed = [a for a in st.allocs_by_job(None, job.id, True)
                  if not a.terminal_status()]
        applied2 = flog2.applied_index()
        flog2.close()
        if not check(len(placed) == 4,
                     f"the recovered store placed {len(placed)} of 4"):
            return False

        flog3 = FileLog(FSM(), d, snapshot_entries=0, snapshot_bytes=0)
        ok = (check(flog3.applied_index() == applied2,
                    "the post-recovery append did not survive")
              and check(flog3.fsm.state.job_by_id(None, job.id)
                        is not None, "the post-recovery entry was lost"))
        flog3.close()
        if not ok:
            return False
    finally:
        shutil.rmtree(d, ignore_errors=True)
    log("wal drill: OK — the native WAL crashed mid-frame, recovery "
        "restored the snapshot, truncated the torn tail and kept every "
        "committed entry, the recovered store placed a batch on "
        f"{device}, and the post-recovery append survived the next boot")
    return True


def follower_drill(seed: int = 0, device: str = "cuda",
                   snapshot_chunk: int = 1024, log=print) -> bool:
    """Follower-read scheduling and a chunked InstallSnapshot (see the
    module docstring)."""
    from ..server import Server, ServerConfig
    from ..structs import structs as s
    from ..utils.backoff import wait_until

    def check(cond, msg):
        if not cond:
            log(f"follower drill: FAIL — {msg}")
        return cond

    def chunks_sent(srv):
        return srv.metrics.sink.latest()["CounterTotals"].get(
            "nomad.raft.snapshot.chunks_sent", 0)

    # The loaded-host election timing of the reference's loadgen harness
    # (nomad_tpu/loadgen/harness.py:45-47): elections hold while the
    # drill's process is busy.
    raft = {"raft_heartbeat": 0.2, "raft_election_min": 5.0,
            "raft_election_max": 8.0, "snapshot_chunk": snapshot_chunk}
    servers = []
    fresh = None
    try:
        first = None
        for i in range(3):
            # num_schedulers=0: no server runs a batch worker, and one
            # follower worker each, so the eval completes only through
            # the follower path (the leader's own follower worker parks).
            srv = Server(ServerConfig(
                device=device, rng_seed=seed, node_name=f"drill-s{i + 1}",
                enable_rpc=True, bootstrap_expect=3,
                start_join=[first] if first else [], num_schedulers=0,
                follower_schedulers=1, min_heartbeat_ttl=60.0, **raft))
            if first is None:
                first = srv.config.rpc_advertise
            servers.append(srv)
        for srv in servers:
            srv.start()
        if not check(wait_until(lambda: any(
                x.is_leader() and x.raft.is_raft_leader()
                for x in servers), 40.0), "no leader elected"):
            return False
        leader = next(x for x in servers if x.is_leader())
        followers = [x for x in servers if x is not leader]
        if not check(wait_until(lambda: all(
                len(x.raft.peers) == 3 for x in servers), 30.0),
                "the voter set did not converge"):
            return False

        leader.node_register(_drill_node(0))
        job = _drill_job(0, count=2)
        _, eval_id = leader.job_register(job)
        if not check(wait_until(lambda: (
                (ev := leader.state.eval_by_id(None, eval_id)) is not None
                and ev.status == s.EVAL_STATUS_COMPLETE), 30.0),
                "the eval did not complete through follower scheduling"):
            return False
        forwarded = sum(f.leader_channel.stats()["ForwardedPlans"]
                        for f in followers)
        if not (check(forwarded >= 1, "no plan was forwarded by a follower")
                and check(leader.leader_channel.stats()["ForwardedPlans"]
                          == 0, "the leader's own channel forwarded")
                and check(wait_until(lambda: all(
                    len(x.state.allocs_by_job(None, job.id, True)) == 2
                    for x in servers), 30.0),
                    "the placements are not on every FSM")):
            return False

        # A lagging joiner: the leader compacted past its log, then a
        # fresh server joins and must catch up by a chunked install.
        leader.raft.snapshot()
        before = chunks_sent(leader)
        fresh = Server(ServerConfig(
            device=device, node_name="drill-fresh", enable_rpc=True,
            bootstrap_expect=3, start_join=[leader.config.rpc_advertise],
            num_schedulers=0, min_heartbeat_ttl=60.0, **raft))
        fresh.start()
        if not check(wait_until(lambda: fresh.state.job_by_id(
                None, job.id) is not None, 30.0),
                "the fresh joiner did not receive the snapshot"):
            return False
        if not check(wait_until(
                lambda: fresh.raft.base_index >= leader.raft.base_index,
                10.0), "the joiner's log base did not advance"):
            return False
        chunks = chunks_sent(leader) - before
        if not check(chunks >= 2, f"the snapshot was not chunked ({chunks} "
                     "chunks sent)"):
            return False
    finally:
        if fresh is not None:
            fresh.shutdown()
        for srv in servers:
            srv.shutdown()
    log("follower drill: OK — a 3-voter port cluster scheduled on a "
        f"follower ({forwarded} plan(s) forwarded to the leader's "
        "plan-apply, visible on every FSM), and a lagging joiner caught up "
        f"by a chunked InstallSnapshot ({chunks} chunks of "
        f"{snapshot_chunk} bytes) (device {device})")
    return True


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m nomad_tpu_torch.ops")
    parser.add_argument("--selfcheck", action="store_true",
                        help="run the drills")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (their plain "
                             "versions)")
    parser.add_argument("--nodes", type=int, default=64)
    parser.add_argument("--specs", type=int, default=64)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--snapshot-chunk", type=int, default=1024,
                        help="the follower drill's InstallSnapshot chunk "
                             "in bytes")
    args = parser.parse_args(argv)
    if not args.selfcheck:
        parser.print_help()
        return 2
    ok = selfcheck(n_nodes=args.nodes, n_specs=args.specs, seed=args.seed,
                   device=args.device)
    ok = columnar_drill(seed=args.seed, device=args.device) and ok
    ok = tracing_drill(seed=args.seed, device=args.device) and ok
    ok = wal_drill(seed=args.seed, device=args.device) and ok
    ok = follower_drill(seed=args.seed, device=args.device,
                        snapshot_chunk=args.snapshot_chunk) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
