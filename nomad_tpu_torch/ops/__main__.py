"""``python -m nomad_tpu_torch.ops --selfcheck``: the port's drills.

    python -m nomad_tpu_torch.ops --selfcheck [--device cpu|cuda]
        [--nodes N --specs U --seed S --snapshot-chunk BYTES]
        [--only DRILL ...]

The thirteen drills of :data:`DRILLS`, in this order (each takes
``device=``; :func:`run_drills` runs them from code):

- The preemption drill (``nomad_tpu/ops/__main__.py:1542-1562``, its
  first check): the eviction sets of ``ops/preempt.py`` on ``--device``
  (default ``cuda``, which builds and launches the kernel and raises
  without a card) against the scalar oracle over every (spec, node) pair
  of a seeded random cluster.
- The breaker drill (``nomad_tpu/ops/__main__.py:36-105``): one
  ``ops.kernel_result`` corruption in a batch on ``--device`` trips a
  private breaker on a fake clock, the oracle places that batch and the
  next (routed while open), and past the cooldown the half-open probe
  takes the device path and closes the breaker.
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
- The chaos drill (``nomad_tpu/ops/__main__.py:1328-1455``): a 3-voter
  port cluster on ``--device`` under the ``SafetyAuditor``; a follower
  is partitioned from the leader in both directions through the net
  plane of ``fault.py``, misses a write committed meanwhile, catches up
  after the heal, and the auditor's converged fingerprint cross-check
  ends with 0 violations and the split and heal in the plane's trace.

- The residency drill (``nomad_tpu/ops/__main__.py:215``): the resident
  mirror's cold install, a delta hit verified by the guard at every hit,
  the staleness fence of an old snapshot, an injected
  ``ops.resident_state`` corruption tripping a private breaker.
- The fused drill (``:529``): one ``batch.fetch`` a batch, oracle parity
  with no node over capacity, the quantized rows' round-trip guard (a
  corrupted codebook caught), a corrupted result rejected and carried by
  the oracle.
- The residue drill (``:723``): the mirror's device twin against the
  sparse-row upload over a four-batch stream (same placements, one
  install, the twin equal to the host mirror), the int8 scale guard, and
  the native decode (``native/decode.cc``) against its numpy twins with
  the guard at every call.
- The codec drill (``:1077``): a seeded corpus round trip, truncation
  and header corruption rejected with ``CodecError``, the native string
  columns against their Python twins with the guard at every call.
- The mesh drill (``:893-1076``): four shards of ``--device``, the
  per-shard device twin with the guard at every hit, one corrupted row
  attributed to its shard, the breaker tripping and the oracle placing
  the next batch.  The reference provisions a virtual 8-device CPU mesh
  in a child process; the port's mesh is in this process.
- The analysis drill (``:1458``): the static pass
  (``python -m nomad_tpu_torch.analysis --check``) clean, the runtime
  lock-order sanitizer catching a seeded inversion with its witness, and
  the native corpora under ASan and UBSan (``python -m
  nomad_tpu_torch.native``; a toolchain without the sanitizer runtimes
  is reported as a skip, never as a pass).

Exits 0 when every drill passes, 1 otherwise.  The reference's chaos
drill (``:1328``) waits for the chaos net hook (ROADMAP queue 1 item
30).
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict

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


def breaker_drill(seed: int = 0, device=None, log=print,
                  breaker=None, clock=None) -> bool:
    """Inject one corrupted kernel batch; assert trip → oracle fallback →
    half-open probe → closed.  Uses a private breaker on a fake clock
    (``breaker`` and its ``clock``, a one-item list of seconds, when the
    caller passes them) so the drill is instant and never touches the
    process-wide breaker."""
    from .. import fault, mock
    from ..scheduler.testing import Harness
    from ..structs import structs as s
    from .batch_sched import TorchBatchScheduler
    from .breaker import KernelCircuitBreaker

    if breaker is None:
        clock = [0.0]
        breaker = KernelCircuitBreaker(threshold=0.9, window=8,
                                       min_checks=1, cooldown=5.0,
                                       clock=lambda: clock[0])
    brk = breaker
    h = Harness()
    for _ in range(8):
        node = mock.node()
        node.resources.networks = []
        node.reserved.networks = []
        node.compute_class()
        h.state.upsert_node(h.next_index(), node)

    def run_batch():
        jobs = []
        for _ in range(2):
            job = mock.job()
            for tg in job.task_groups:
                for t in tg.tasks:
                    t.resources.networks = []
            job.task_groups[0].count = 2
            h.state.upsert_job(h.next_index(), job)
            jobs.append(job)
        evals = [s.Evaluation(
            id=s.generate_uuid(), priority=j.priority, type=j.type,
            triggered_by=s.EVAL_TRIGGER_JOB_REGISTER, job_id=j.id,
            status=s.EVAL_STATUS_PENDING) for j in jobs]
        sched = TorchBatchScheduler(h.logger, h.snapshot(), h,
                                    device=device, breaker=brk,
                                    rng_seed=seed)
        stats = sched.schedule_batch(evals)
        placed = all(
            len([a for a in h.state.allocs_by_job(None, j.id, True)
                 if not a.terminal_status()]) == 2 for j in jobs)
        return stats, placed

    def check(cond, msg):
        if not cond:
            log(f"breaker drill: FAIL — {msg}")
        return cond

    with fault.scenario({"seed": seed, "faults": [
            {"point": "ops.kernel_result", "action": "corrupt",
             "times": 1}]}):
        stats, placed = run_batch()
    if not (check(stats.kernel_rejects == 1, "corrupt batch not rejected")
            and check(placed, "oracle fallback did not place the batch")
            and check(brk.state == "open",
                      f"breaker {brk.state!r}, expected open")):
        return False

    stats2, placed2 = run_batch()
    if not (check(stats2.oracle_routed > 0, "open breaker did not route "
                                            "evals through the oracle")
            and check(placed2, "oracle-routed batch did not place")):
        return False

    clock[0] += 10.0  # past cooldown: next batch is the half-open probe
    stats3, placed3 = run_batch()
    if not (check(stats3.oracle_routed == 0, "probe batch did not take "
                                             "the device path")
            and check(placed3, "probe batch did not place")
            and check(brk.state == "closed",
                      f"breaker {brk.state!r} after clean probe")):
        return False
    log(f"breaker drill: OK — trip on corrupt batch (seed {seed}), "
        "oracle fallback placed everything, clean probe re-closed "
        f"(trips={brk.trips}, device {device or 'cuda'})")
    return True


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


def chaos_drill(seed: int = 0, device: str = "cuda", log=print) -> bool:
    """A partitioned follower blinded, healed and caught up under the
    safety auditor (see the module docstring)."""
    import time

    from .. import fault
    from ..loadgen.auditor import SafetyAuditor
    from ..server import Server, ServerConfig
    from ..server.rpc import ConnPool
    from ..structs import structs as s
    from ..utils.backoff import wait_until

    def check(cond, msg):
        if not cond:
            log(f"chaos drill: FAIL — {msg}")
        return cond

    def make_job(jid):
        return s.Job(
            region="global", id=jid, name=jid, type=s.JOB_TYPE_SERVICE,
            priority=50, datacenters=["dc1"],
            task_groups=[s.TaskGroup(
                name="tg", count=1,
                ephemeral_disk=s.EphemeralDisk(size_mb=10),
                tasks=[s.Task(name="t", driver="exec",
                              config={"command": "/bin/date"},
                              resources=s.Resources(cpu=100,
                                                    memory_mb=128),
                              log_config=s.LogConfig())])])

    # Slowed elections (the reference's 8-12 s): a partitioned voter
    # must not campaign during the short split.  Every server's event
    # stream is armed for the auditor's feeds.
    raft = {"raft_election_min": 8.0, "raft_election_max": 12.0}
    servers = []
    auditor = None
    report = {}
    pool = ConnPool()
    pool.chaos_exempt = True
    try:
        first = None
        for i in range(3):
            srv = Server(ServerConfig(
                device=device, rng_seed=seed, node_name=f"chaos-s{i + 1}",
                enable_rpc=True, bootstrap_expect=3,
                start_join=[first] if first else [], num_schedulers=0,
                min_heartbeat_ttl=60.0, events=True, **raft))
            if first is None:
                first = srv.config.rpc_advertise
            servers.append(srv)
        for srv in servers:
            srv.start()
        if not check(wait_until(lambda: any(
                x.is_leader() and x.raft.is_raft_leader()
                for x in servers), 30.0), "no leader elected"):
            return False
        leader = next(x for x in servers if x.is_leader())
        victim = next(x for x in servers if x is not leader)
        if not check(wait_until(lambda: all(
                len(x.raft.peers) == 3 for x in servers), 30.0),
                "voter config did not converge"):
            return False

        auditor = SafetyAuditor(
            leader, [x.config.rpc_advertise for x in servers
                     if x is not leader],
            pool=pool, interval=0.25)
        auditor.start()
        leader.job_register(make_job("chaos-pre"))
        if not check(wait_until(lambda: victim.state.job_by_id(
                None, "chaos-pre") is not None, 30.0),
                "pre-partition write did not replicate"):
            return False

        # Split, both directions: every in-process pool is stamped with
        # its server's address.
        fault.net_partition("drill", [[leader.config.rpc_advertise],
                                      [victim.config.rpc_advertise]])
        leader.job_register(make_job("chaos-during"))
        time.sleep(0.8)
        if not check(victim.state.job_by_id(None, "chaos-during") is None,
                     "partitioned follower saw a write it cannot have"):
            return False
        fault.net_heal("drill")
        if not check(wait_until(lambda: victim.state.job_by_id(
                None, "chaos-during") is not None, 20.0),
                "healed follower did not catch up"):
            return False
        report = auditor.finalize()
        trace = fault.net().trace()
        if not (check(report["violation_count"] == 0,
                      f"auditor violations: {report['violations']}")
                and check(report["checks"]["fingerprint_matches"] >= 1,
                          "no cross-server fingerprint match recorded")
                and check(("net.partition", "drill", "split") in trace
                          and ("net.partition", "drill", "heal") in trace,
                          f"partition trace incomplete: {trace}")):
            return False
    finally:
        if auditor is not None:
            auditor.stop()
        fault.net_disarm()
        pool.close()
        for srv in servers:
            srv.shutdown()
    log("chaos drill: OK — partitioned follower blinded then healed and "
        "caught up, auditor recorded 0 violations with "
        f"{report['checks']['fingerprint_matches']} cross-server "
        "fingerprint matches")
    return True


def _register_job(h, k: int, count: int = 2):
    """A fresh drill job into ``h``'s store and its register eval."""
    from ..structs import structs as s

    job = _drill_job(k, count)
    h.state.upsert_job(h.next_index(), job)
    ev = s.Evaluation(
        id=f"drill-eval-{job.id}", priority=job.priority, type=job.type,
        triggered_by=s.EVAL_TRIGGER_JOB_REGISTER, job_id=job.id,
        status=s.EVAL_STATUS_PENDING)
    return job, ev


def _live(h, job_id: str):
    """A job's live placements as sorted (name, node)."""
    return sorted((a.name, a.node_id)
                  for a in h.state.allocs_by_job(None, job_id, True)
                  if not a.terminal_status())


def _private_breaker():
    from .breaker import KernelCircuitBreaker

    return KernelCircuitBreaker(threshold=0.9, window=8, min_checks=1,
                                cooldown=3600.0)


def residency_drill(seed: int = 0, device=None, log=print) -> bool:
    """The resident mirror (``nomad_tpu/ops/__main__.py:215``): the cold
    batch installs the mirror, the next takes the delta path with the
    guard at every hit (the delta apply verified against a full walk), a
    snapshot two batches old falls back over the staleness fence without
    moving the mirror, and an injected ``ops.resident_state`` corruption
    is caught and trips a private breaker while the walk places the
    batch."""
    from .. import fault
    from ..scheduler.testing import Harness
    from . import resident
    from .batch_sched import TorchBatchScheduler

    def check(cond, msg):
        if not cond:
            log(f"residency drill: FAIL — {msg}")
        return cond

    resident.invalidate()
    resident.reset_counters()
    brk = _private_breaker()
    h = Harness()
    jobs = [0]
    try:
        for i in range(8):
            h.state.upsert_node(h.next_index(), _drill_node(i))

        def next_job():
            jobs[0] += 1
            return _register_job(h, jobs[0] - 1)

        def run_batch(state=None, job_ev=None):
            job, ev = job_ev if job_ev is not None else next_job()
            stats = TorchBatchScheduler(
                h.logger, state if state is not None else h.snapshot(), h,
                device=device, breaker=brk, rng_seed=seed, resident=True,
                guard_every=1).schedule_batch([ev])
            return stats, len(_live(h, job.id)) == 2

        s1, p1 = run_batch()
        if not (check(s1.full_reencodes == 1 and not s1.resident_hits,
                      f"the cold batch should walk ({s1!r})")
                and check(p1, "the cold batch did not place")):
            return False
        s2, p2 = run_batch()
        if not (check(s2.resident_hits == 1,
                      f"the second batch should take the delta path "
                      f"({s2!r})")
                and check(p2, "the delta batch did not place")
                and check(resident.GUARD_RUNS >= 1
                          and resident.GUARD_MISMATCHES == 0,
                          "the guard did not verify the delta apply "
                          "against a full walk")):
            return False

        # The fence: the fence job registers before the snapshot, so the
        # stale world sees it; two batches later that snapshot is stale.
        fence = next_job()
        stale = h.snapshot()
        run_batch()
        run_batch()
        cached = resident._STATE.alloc_index
        s3, p3 = run_batch(state=stale, job_ev=fence)
        if not (check(s3.staleness_fences == 1 and s3.full_reencodes == 1,
                      f"the stale snapshot did not take the fence ({s3!r})")
                and check(p3, "the fenced batch did not place")
                and check(resident._STATE.alloc_index == cached,
                          "the fence moved the resident mirror")):
            return False

        with fault.scenario({"seed": seed, "faults": [
                {"point": "ops.resident_state", "action": "corrupt",
                 "times": 1}]}):
            s4, p4 = run_batch()
        if not (check(resident.GUARD_MISMATCHES == 1,
                      "the guard missed the injected corruption")
                and check(brk.state == "open",
                          f"breaker {brk.state!r}, expected open")
                and check(p4, "the corrupted-mirror batch did not place")):
            return False
        runs = resident.GUARD_RUNS
    finally:
        resident.reset_counters()
        resident.invalidate()
    log("residency drill: OK — the cold walk installed the mirror, the "
        "delta apply was verified bit-identical by the guard, the stale "
        "snapshot took the fence, the injected corruption tripped the "
        f"breaker (guard runs {runs}, device {device or 'cuda'})")
    return True


def fused_drill(seed: int = 0, device=None, log=print) -> bool:
    """The single-dispatch pass (``nomad_tpu/ops/__main__.py:529``): a
    cold batch on ``device`` places with exactly one ``batch.fetch`` span;
    the same problem through the CPU oracle places the same per-job counts
    with no node over capacity; quantized resource rows round-trip
    exactly and a corrupted codebook is caught and fed to a breaker; a
    corrupted result is rejected, trips the breaker, and the oracle
    carries the batch."""
    import numpy as np

    from .. import fault
    from ..scheduler.generic import GenericScheduler
    from ..scheduler.testing import Harness
    from ..utils import tracing
    from . import encode, resident
    from .batch_sched import TorchBatchScheduler

    def check(cond, msg):
        if not cond:
            log(f"fused drill: FAIL — {msg}")
        return cond

    brk = _private_breaker()
    h_dev, h_orc = Harness(), Harness()
    try:
        for h in (h_dev, h_orc):
            for i in range(8):
                h.state.upsert_node(h.next_index(), _drill_node(i))
        batch = [_register_job(h_dev, k) for k in range(3)]
        for job, _ in batch:
            h_orc.state.upsert_job(h_orc.next_index(), job.copy())

        # 1. The cold batch, traced: one batch.fetch span, the device ran.
        was = tracing.enabled()
        if not was:
            tracing.enable()
        try:
            stats = TorchBatchScheduler(
                h_dev.logger, h_dev.snapshot(), h_dev, device=device,
                breaker=brk, rng_seed=seed).schedule_batch(
                    [ev for _, ev in batch])
            fetches = [sp for sp in tracing.trace_for_eval(batch[0][1].id)
                       if sp["Name"] == "batch.fetch"]
        finally:
            if not was:
                tracing.disable()
        if not (check(stats.device_ran and stats.oracle_routed == 0,
                      f"the batch did not run on the device ({stats!r})")
                and check(len(fetches) == 1,
                          f"{len(fetches)} batch.fetch spans, expected "
                          "exactly 1 (one transfer a batch)")):
            return False

        # 2. The oracle twin: the same per-job counts, no node over
        # capacity on either side.
        for _, ev in batch:
            GenericScheduler(h_orc.logger, h_orc.snapshot(), h_orc,
                             batch=False).process(ev.copy())
        for job, _ in batch:
            n_dev = len(_live(h_dev, job.id))
            n_orc = len(_live(h_orc, job.id))
            if not check(n_dev == n_orc == 2,
                         f"placement parity broke for {job.id}: device "
                         f"{n_dev}, oracle {n_orc} (want 2)"):
                return False
        for h in (h_dev, h_orc):
            for node in h.state.nodes(None):
                used = np.zeros(2, dtype=np.int64)
                for a in h.state.allocs_by_node(None, node.id):
                    if a.terminal_status():
                        continue
                    r = a.resources
                    if r is None:
                        tr = list(a.task_resources.values())
                        used += (sum(t.cpu for t in tr),
                                 sum(t.memory_mb for t in tr))
                    else:
                        used += (r.cpu, r.memory_mb)
                if not check(used[0] <= node.resources.cpu
                             and used[1] <= node.resources.memory_mb,
                             f"node {node.id} over capacity ({used})"):
                    return False

        # 3. Quantized rows: exact rows round-trip, a corrupted codebook
        # fails the bound, is counted and feeds the breaker.
        resident.reset_counters()
        cap = np.tile(np.array([4000, 8192, 102400, 150]), (8, 1))
        base_used = np.tile(np.array([100, 128, 0, 0]), (8, 1))
        q = encode.quantize_resource_rows(cap, base_used)
        if not (check(q is not None, "the bench-shape rows did not "
                                     "quantize")
                and check(resident.check_quant_roundtrip(
                              cap, q.cap_q, q.scale[0], what="capacity"),
                          "exact quantization failed the round trip")
                and check(np.array_equal(
                              encode.dequantize_rows(q.used_q, q.scale[1]),
                              base_used),
                          "the used baseline did not round-trip")):
            return False
        bad_brk = _private_breaker()
        corrupt = np.array(q.cap_q)
        corrupt[0, 0] += 1
        if not (check(not resident.check_quant_roundtrip(
                          cap, corrupt, q.scale[0], breaker=bad_brk,
                          what="capacity"),
                      "a corrupted codebook passed the round trip")
                and check(resident.QUANT_MISMATCHES == 1,
                          "the quant mismatch counter did not move")
                and check(bad_brk.agreement() < 1.0,
                          "the quant mismatch did not feed the breaker")):
            return False

        # 4. A corrupted result: rejected, the breaker trips, the oracle
        # carries the batch (fresh jobs: the first ones are placed).
        batch2 = [_register_job(h_dev, k, count=1) for k in (3, 4)]
        with fault.scenario({"seed": seed, "faults": [
                {"point": "ops.kernel_result", "action": "corrupt",
                 "times": 1}]}):
            stats2 = TorchBatchScheduler(
                h_dev.logger, h_dev.snapshot(), h_dev, device=device,
                breaker=brk, rng_seed=seed).schedule_batch(
                    [ev for _, ev in batch2])
        if not (check(stats2.kernel_rejects == 1,
                      f"the corrupted batch was not rejected ({stats2!r})")
                and check(stats2.oracle_routed == len(batch2),
                          "the rejected batch did not route to the oracle")
                and check(all(len(_live(h_dev, j.id)) == 1
                              for j, _ in batch2),
                          "the oracle did not place the rejected batch")
                and check(brk.state == "open",
                          f"breaker {brk.state!r}, expected open")):
            return False
    finally:
        resident.reset_counters()
    log("fused drill: OK — one fetch for the batch, oracle parity with no "
        "node over capacity, quantized rows round-tripped exactly (the "
        "corrupted codebook caught), the corrupted result tripped the "
        "breaker and the oracle carried the batch (device "
        f"{device or 'cuda'})")
    return True


def residue_drill(seed: int = 0, device=None, log=print) -> bool:
    """The host residue (``nomad_tpu/ops/__main__.py:723``): the same
    four-batch stream through the mirror's device twin and through the
    sparse-row upload places identically, the twin equal to the host
    mirror after its in-place applies (one install); the int8 guard
    catches an out-of-range scale; and the native packed-result decode
    (``native/decode.cc``) equals its numpy twins on a seeded corpus with
    the guard at every call."""
    import random

    import numpy as np

    from ..scheduler.testing import Harness
    from . import decode as decode_mod
    from . import encode, resident
    from .batch_sched import TorchBatchScheduler

    def check(cond, msg):
        if not cond:
            log(f"residue drill: FAIL — {msg}")
        return cond

    rng_seed = 1234567 + seed
    resident.reset_counters()
    decode_mod.reset_counters()
    try:
        def run_stream(device_mirror: bool):
            resident.invalidate()
            h = Harness()
            for i in range(8):
                h.state.upsert_node(h.next_index(), _drill_node(i))
            placements = []
            for k in range(4):
                job, ev = _register_job(h, k)
                TorchBatchScheduler(
                    h.logger, h.snapshot(), h, device=device,
                    breaker=_private_breaker(), rng_seed=rng_seed,
                    resident=True, resident_device=device_mirror,
                    guard_every=1, decode_guard_every=1
                ).schedule_batch([ev])
                placements.append(_live(h, job.id))
            st = resident._STATE
            dev_ok = True
            if device_mirror:
                dev_ok = (st is not None and st.used_dev is not None
                          and np.array_equal(
                              resident.device_used_host(st.used_dev),
                              st.used))
            return placements, dev_ok

        pl_dev, dev_ok = run_stream(True)
        applies, installs = resident.DEV_APPLIES, resident.DEV_INSTALLS
        pl_rows, _ = run_stream(False)
        if not (check(installs == 1,
                      f"expected one device-twin install, got {installs}")
                and check(applies >= 3,
                          f"the in-place delta applies did not run "
                          f"({applies})")
                and check(dev_ok, "the device twin diverged from the host "
                                  "mirror after its applies")
                and check(pl_dev == pl_rows,
                          "the device twin's placements differ from the "
                          "sparse-row upload's")
                and check(all(len(p) == 2 for p in pl_dev),
                          f"a stream batch did not place: {pl_dev}")
                and check(resident.DEV_GUARD_MISMATCHES == 0
                          and resident.GUARD_MISMATCHES == 0,
                          "the mirror guards reported mismatches")):
            return False

        # The int8 guard: a scale pushed out of range fails the bound.
        cap = np.tile(np.array([4000, 8192, 102400, 150]), (8, 1))
        q = encode.quantize_resource_rows(cap, np.zeros_like(cap))
        if not (check(q is not None and q.cap_q.dtype == np.int8,
                      f"the bench-shape capacity did not quantize to int8 "
                      f"({None if q is None else q.cap_q.dtype})")
                and check(resident.check_quant_roundtrip(
                              cap, q.cap_q, q.scale[0], what="capacity"),
                          "exact int8 rows failed the round trip")):
            return False
        bad_scale = np.array(q.scale[0])
        bad_scale[1] <<= 1
        if not check(not resident.check_quant_roundtrip(
                         cap, q.cap_q, bad_scale, what="capacity"),
                     "an out-of-range scale passed the guard"):
            return False

        # The native decode against its twins, the guard at every call.
        guard0 = decode_mod.GUARD_RUNS
        rng = random.Random(seed)
        n_specs, n_real = 17, 203
        rows_l, cols_l, cnt_l = [], [], []
        for u in range(n_specs):
            for _ in range(rng.randrange(0, 9)):
                rows_l.append(u)
                cols_l.append(rng.randrange(n_real))
                cnt_l.append(rng.randrange(1, 4))
        rows = np.array(rows_l, dtype=np.int32)
        cols = np.array(cols_l, dtype=np.int32)
        cnts = np.array(cnt_l, dtype=np.int32)
        scores = np.array([rng.random() * 18 for _ in rows_l],
                          dtype=np.float32)
        coll = np.array([rng.randrange(0, 3) for _ in rows_l],
                        dtype=np.int32)
        off, exp = decode_mod.expand_coo(rows, cols, cnts, n_specs, n_real,
                                         guard_every=1)
        ref_off, ref_exp = decode_mod.expand_coo(
            rows, cols, cnts, n_specs, n_real, native=False)
        ls = decode_mod.last_scores(rows, cols, scores, coll, n_specs,
                                    n_real, guard_every=1)
        ref_ls = decode_mod.last_scores(rows, cols, scores, coll, n_specs,
                                        n_real, native=False)
        if not (check(np.array_equal(off, ref_off)
                      and np.array_equal(exp, ref_exp),
                      "the native expand diverged from the numpy twin")
                and check(all(np.array_equal(a, b)
                              for a, b in zip(ls, ref_ls)),
                          "the native last-scores diverged from the twin")
                and check(decode_mod.GUARD_RUNS - guard0 == 2
                          and decode_mod.GUARD_MISMATCHES == 0,
                          "the decode guard did not verify both calls")):
            return False
        native_calls = decode_mod.NATIVE_CALLS
    finally:
        resident.reset_counters()
        resident.invalidate()
        decode_mod.reset_counters()
    log("residue drill: OK — the device twin round-tripped bit-identical "
        "(one install, in-place applies, placements = the sparse-row "
        "upload's), the out-of-range int8 scale caught by the round-trip "
        f"guard, the native decode equal to its twins ({native_calls} "
        f"native calls, every one guarded; device {device or 'cuda'})")
    return True


def mesh_drill(seed: int = 0, device=None, log=print,
               n_shards: int = 4) -> bool:
    """The node mesh (``nomad_tpu/ops/__main__.py:893-1076``), as
    ``n_shards`` shards of ``device``: the cold batch installs the
    per-shard device twin, the next applies its delta in place on the
    owning shards with the guard at every hit (the twin equal to the host
    mirror), one corrupted mirror row is attributed to its shard on the
    event stream and trips a private breaker, and the open breaker routes
    the next batch through the oracle, which places it.  The reference
    provisions a virtual 8-device CPU mesh in a child process; the port's
    mesh is ``n_shards`` shards of one device, in this process."""
    import numpy as np

    from .. import fault
    from ..parallel import make_node_mesh
    from ..scheduler.testing import Harness
    from ..server import event_broker
    from . import resident
    from .batch_sched import TorchBatchScheduler

    def check(cond, msg):
        if not cond:
            log(f"mesh drill: FAIL — {msg}")
        return cond

    mesh = make_node_mesh([device or "cuda"] * n_shards)
    resident.invalidate()
    resident.reset_counters()
    brk = _private_breaker()
    h = Harness()
    broker = event_broker.EventBroker(
        index_source=lambda: h.state.latest_index())
    event_broker.register(broker)
    event_broker.clear_recent()
    jobs = [0]
    bad_shards = None
    try:
        for i in range(16):
            h.state.upsert_node(h.next_index(), _drill_node(i))

        def run_batch():
            job, ev = _register_job(h, jobs[0])
            jobs[0] += 1
            stats = TorchBatchScheduler(
                h.logger, h.snapshot(), h, mesh=mesh, breaker=brk,
                rng_seed=seed, resident=True, resident_device=True,
                guard_every=1).schedule_batch([ev])
            return stats, len(_live(h, job.id)) == 2

        s1, p1 = run_batch()
        if not (check(s1.mesh_shards == n_shards and s1.device_ran,
                      f"the cold batch did not run the mesh pass ({s1!r})")
                and check(s1.full_reencodes == 1,
                          f"the cold batch should walk ({s1!r})")
                and check(p1, "the cold mesh batch did not place")
                and check(resident.DEV_INSTALLS == 1,
                          f"the sharded twin should install once "
                          f"({resident.DEV_INSTALLS})")):
            return False
        s2, p2 = run_batch()
        st = resident._STATE
        if not (check(s2.resident_hits == 1,
                      f"the second batch should take the sharded delta "
                      f"path ({s2!r})")
                and check(p2, "the delta batch did not place")
                and check(resident.DEV_APPLIES >= 1,
                          "no shard-routed delta apply ran")
                and check(resident.DEV_INSTALLS == 1,
                          "the delta batch reinstalled the twin instead of "
                          "applying in place")
                and check(st is not None and isinstance(st.used_dev, list)
                          and len(st.used_dev) == n_shards
                          and np.array_equal(
                              resident.device_used_host(st.used_dev),
                              st.used),
                          "the sharded twin diverged from the host mirror")
                and check(resident.GUARD_RUNS >= 1
                          and resident.GUARD_MISMATCHES == 0,
                          "the per-shard guard did not verify the delta "
                          "apply")):
            return False
        with fault.scenario({"seed": seed, "faults": [
                {"point": "ops.resident_state", "action": "corrupt",
                 "times": 1}]}):
            s3, p3 = run_batch()
        events = [e for e in event_broker.recent()
                  if e.type == "NodeStateDelta"
                  and e.payload.get("Reason") == "guard_mismatch"]
        bad_shards = events[-1].payload.get("Shards") if events else None
        if not (check(resident.GUARD_MISMATCHES == 1,
                      "the guard missed the injected shard corruption")
                and check(bad_shards is not None and len(bad_shards) == 1
                          and 0 <= bad_shards[0] < n_shards,
                          f"the corruption was not attributed to its shard "
                          f"(Shards={bad_shards})")
                and check(brk.state == "open",
                          f"breaker {brk.state!r}, expected open")
                and check(p3, "the corrupted-shard batch did not place")):
            return False
        s4, p4 = run_batch()
        if not (check(s4.oracle_routed > 0,
                      "the open breaker did not route the mesh batch "
                      "through the oracle")
                and check(p4, "the oracle's batch did not place")):
            return False
    finally:
        event_broker.unregister(broker)
        event_broker.clear_recent()
        resident.reset_counters()
        resident.invalidate()
    log(f"mesh drill: OK — the {n_shards}-shard cold walk installed the "
        "per-shard twin and placed, the shard-routed applies landed in "
        "place (the twin equal to the host mirror, the guard verified), "
        f"the injected corruption was attributed to shard {bad_shards[0]} "
        "and tripped the breaker, and the oracle carried the next batch "
        f"(device {device or 'cuda'})")
    return True


def codec_drill(seed: int = 0, device=None, log=print) -> bool:
    """The struct codec (``nomad_tpu/ops/__main__.py:1077``): a seeded
    corpus of the hot payloads (jobs, allocs, lazy slabs, evals)
    round-trips equal to its source; truncation and header corruption are
    rejected with ``CodecError``, never misread; and the native
    string-column pack and split (``native/codec.cc``) equal their Python
    twins with the guard at every call.  The reference also compares with
    its msgpack path, which the port does not have (ROADMAP queue 3 item
    16(a)).  Host code only: ``device`` is accepted for the drills'
    common signature."""
    import random

    from .. import codec, mock
    from ..api.codec import to_wire
    from ..codec import CodecError
    from ..codec import native as cnative
    from ..structs import structs as s

    def check(cond, msg):
        if not cond:
            log(f"codec drill: FAIL — {msg}")
        return cond

    rng = random.Random(seed)

    def corpus_item(i):
        job = mock.job()
        alloc = s.Allocation(
            id=s.generate_uuid(), job_id=job.id, job=job,
            name=f"{job.id}.tg[{i}]", node_id=s.generate_uuid(),
            task_resources={"t": s.Resources(cpu=100, memory_mb=128)})
        slab = s.AllocSlab(proto=alloc, ids=s.LazyUuids(8),
                           names=s.LazyNames(8, f"{job.id}.tg"),
                           node_ids=s.generate_uuids(8))
        ev = s.Evaluation(id=s.generate_uuid(), job_id=job.id,
                          priority=rng.randrange(1, 100))
        return {"evals": [ev], "allocs": [alloc], "slabs": [slab],
                "job": job, "eval_id": ev.id}

    corpus = [corpus_item(i) for i in range(8)]
    for payload in corpus:
        got = codec.decode(codec.encode(payload))
        if not check(to_wire(got["job"]) == to_wire(payload["job"])
                     and to_wire(got["allocs"]) == to_wire(
                         payload["allocs"])
                     and to_wire(got["evals"]) == to_wire(payload["evals"])
                     and list(got["slabs"][0].ids)
                     == list(payload["slabs"][0].ids)
                     and list(got["slabs"][0].node_ids)
                     == list(payload["slabs"][0].node_ids),
                     "the round trip diverged from the source payload"):
            return False

    rejected = accepted = 0
    for payload in corpus:
        blob = codec.encode(payload)
        for k in [rng.randrange(1, len(blob)) for _ in range(16)]:
            try:
                codec.decode(blob[:k])
                return check(False, f"a truncation at {k} was accepted")
            except CodecError:
                rejected += 1
        for pos in (0, 1, 2):
            bad = bytearray(blob)
            bad[pos] ^= 0xFF
            try:
                codec.decode(bytes(bad))
                accepted += 1
            except CodecError:
                rejected += 1
    if not check(rejected > 0, "no corruption was rejected"):
        return False

    every, runs0 = cnative.GUARD_EVERY, cnative.GUARD_RUNS
    mismatches0 = cnative.GUARD_MISMATCHES
    cnative.GUARD_EVERY = 1
    try:
        for payload in corpus:
            for col in (list(payload["slabs"][0].node_ids),
                        s.generate_uuids(64)):
                py = cnative.py_pack_strs([x.encode() for x in col])
                if not check(cnative.pack_strs(col) == py,
                             "the native pack diverged from the twin"):
                    return False
                got, end = cnative.unpack_strs(py, 0, len(col))
                if not check(got == col and end == len(py),
                             "the native split diverged from the twin"):
                    return False
        guarded = cnative.GUARD_RUNS - runs0
        if not (check(cnative.GUARD_MISMATCHES == mismatches0,
                      "the guard counted a mismatch")
                and check(guarded == 4 * len(corpus),
                          f"{guarded} guarded calls, expected "
                          f"{4 * len(corpus)}")):
            return False
    finally:
        cnative.GUARD_EVERY = every
    log(f"codec drill: OK — the corpus round-tripped equal, {rejected} "
        f"corruptions rejected ({accepted} content flips decoded), the "
        f"native string columns equal their twins ({guarded} guarded "
        "calls)")
    return True


def analysis_drill(seed: int = 0, device=None, log=print,
                   verdicts=None) -> bool:
    """The guard plane's self-check (``nomad_tpu/ops/__main__.py:1458``),
    three legs: the static pass (``python -m nomad_tpu_torch.analysis
    --check``) is clean on the tree; the runtime lock-order sanitizer
    catches a seeded inversion (A then B in one thread, B then A in
    another) with its witness, and is silent on the well-ordered control;
    the native corpora run clean under ASan and UBSan.  A toolchain
    without the sanitizer runtimes makes the last leg a skip, reported as
    one (``verdicts``, a dict when given, gets ``"sanitized_corpus"``:
    ``"clean"`` or ``"skip: <reason>"``).  Host code only: ``device`` is
    accepted for the drills' common signature."""
    import threading

    from ..analysis import run_checks
    from ..native.__main__ import run_sanitized
    from ..utils import lockcheck

    def check(cond, msg):
        if not cond:
            log(f"analysis drill: FAIL — {msg}")
        return bool(cond)

    ok = True
    active, suppressed = run_checks()
    ok = check(not active,
               f"the static pass found {len(active)} unsuppressed "
               f"violation(s): " + "; ".join(v.key for v in active[:4])
               ) and ok

    was_armed = lockcheck.armed()
    if not was_armed:
        lockcheck.arm()
    try:
        lockcheck.reset()
        a = lockcheck.make_tracked("drill:lock_a")
        b = lockcheck.make_tracked("drill:lock_b")
        with a:
            with b:
                pass
        ok = check(lockcheck.find_cycle() is None,
                   "well-ordered acquisitions reported a cycle") and ok

        def invert():
            with b:
                with a:
                    pass

        t = threading.Thread(target=invert, name="drill-invert")
        t.start()
        t.join(5)
        cycle = lockcheck.find_cycle()
        ok = check(cycle is not None,
                   "the seeded A-B / B-A inversion was not detected") and ok
        if cycle is not None:
            caught = False
            try:
                lockcheck.assert_acyclic()
            except lockcheck.LockOrderError as exc:
                caught = ("drill:lock_a" in str(exc)
                          and "drill:lock_b" in str(exc))
            ok = check(caught, "the witness chain misses the seeded "
                               "locks") and ok
    finally:
        lockcheck.reset()
        if not was_armed:
            lockcheck.disarm()

    verdict = run_sanitized(seed=seed, log=log)
    if isinstance(verdict, tuple):
        corpus = f"skip: {verdict[1]}"
        log(f"analysis drill: the sanitized corpus leg SKIPPED "
            f"({verdict[1]})")
    else:
        corpus = "clean" if verdict == "ok" else verdict
        ok = check(verdict == "ok", verdict) and ok
    if verdicts is not None:
        verdicts["sanitized_corpus"] = corpus
    if ok:
        log(f"analysis drill: OK — the static pass clean "
            f"({len(suppressed)} allowlisted), the seeded inversion caught "
            f"with its witness, the sanitized native corpus {corpus}")
    return ok


#: The drills of ``--selfcheck``, in the order they run.
DRILLS = ("preempt", "breaker", "columnar", "tracing", "wal", "follower",
          "chaos", "residency", "fused", "residue", "codec", "mesh",
          "analysis")


def run_drills(seed: int = 0, device: str = "cuda", nodes: int = 64,
               specs: int = 64, snapshot_chunk: int = 1024, log=print,
               verdicts=None, only=None) -> Dict[str, bool]:
    """Every drill of :data:`DRILLS` (or those named in ``only``) on
    ``device``; returns each drill's verdict by name.  ``verdicts``, a
    dict when given, gets the analysis drill's corpus verdict."""
    calls = {
        "preempt": lambda: selfcheck(n_nodes=nodes, n_specs=specs,
                                     seed=seed, device=device, log=log),
        "breaker": lambda: breaker_drill(seed=seed, device=device, log=log),
        "columnar": lambda: columnar_drill(seed=seed, device=device,
                                           log=log),
        "tracing": lambda: tracing_drill(seed=seed, device=device, log=log),
        "wal": lambda: wal_drill(seed=seed, device=device, log=log),
        "follower": lambda: follower_drill(seed=seed, device=device,
                                           snapshot_chunk=snapshot_chunk,
                                           log=log),
        "chaos": lambda: chaos_drill(seed=seed, device=device, log=log),
        "residency": lambda: residency_drill(seed=seed, device=device,
                                             log=log),
        "fused": lambda: fused_drill(seed=seed, device=device, log=log),
        "residue": lambda: residue_drill(seed=seed, device=device, log=log),
        "codec": lambda: codec_drill(seed=seed, device=device, log=log),
        "mesh": lambda: mesh_drill(seed=seed, device=device, log=log),
        "analysis": lambda: analysis_drill(seed=seed, device=device,
                                           log=log, verdicts=verdicts),
    }
    return {name: bool(calls[name]()) for name in DRILLS
            if only is None or name in only}


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
    parser.add_argument("--only", action="append", choices=list(DRILLS),
                        help="run only this drill (repeatable)")
    args = parser.parse_args(argv)
    if not args.selfcheck:
        parser.print_help()
        return 2
    results = run_drills(seed=args.seed, device=args.device,
                         nodes=args.nodes, specs=args.specs,
                         snapshot_chunk=args.snapshot_chunk, only=args.only)
    failed = [name for name, ok in results.items() if not ok]
    print(f"selfcheck: {len(results) - len(failed)} of {len(results)} "
          f"drills passed" + (f"; failed: {', '.join(failed)}"
                              if failed else ""))
    return 0 if not failed else 1


if __name__ == "__main__":
    sys.exit(main())
