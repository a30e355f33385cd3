"""The port's eval-driven batch scheduler against the JAX reference.

``TPUBatchScheduler`` runs in the reference's ``Harness`` and
``TorchBatchScheduler(device="cpu")`` in the port's, on one cluster built
in both packages (converted), with the same evaluation ids, the same
pinned tie-break seed (``NOMAD_TPU_RNG_SEED`` / ``rng_seed``) and, while
a batch runs, the same deterministic id sequence in both packages (so
alloc ids, and with them the order in which the reconciler walks a job's
allocs, agree).  After every batch the two worlds are compared whole:

- every alloc in the state store (id, name, node, eval, desired and
  client status and description, previous allocation, network offers)
  and its AllocMetric scores (<= 1e-5);
- every plan's stops, explicit placements and alloc slabs;
- every eval status update (status, next and blocked eval, queued counts,
  failed task groups' AllocMetrics field by field), every created eval
  (blocked and rolling, with class eligibility and the escaped flag) and
  every reblocked one.

The reference runs on its device path in each (``oracle_routed == 0``,
with a breaker of its own).  Also here: failure forensics, the breaker's
trip and probe recovery, the static-buffer cache, and a plan conflict.
"""
import dataclasses
import os
import random

import jax  # noqa: F401  (the reference computes on the CPU backend)
import pytest

from nomad_tpu import mock as jmock
from nomad_tpu.ops.batch_sched import TPUBatchScheduler
from nomad_tpu.ops.breaker import KernelCircuitBreaker as JBreaker
from nomad_tpu.scheduler import Harness as JHarness
from nomad_tpu.scheduler import RejectPlan as JRejectPlan
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert, fault
from nomad_tpu_torch.ops import batch_sched, breaker
from nomad_tpu_torch.ops.batch_sched import TorchBatchScheduler
from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
from nomad_tpu_torch.scheduler.scheduler import new_scheduler
from nomad_tpu_torch.scheduler.testing import Harness, RejectPlan
from nomad_tpu_torch.state import StateStore, columnar
from nomad_tpu_torch.structs import structs as ps

SCORE_ATOL = 1e-5


@pytest.fixture(autouse=True)
def fresh_breaker():
    """The port's process-wide breaker, fresh for every test here."""
    breaker.reset_for_tests()
    yield
    breaker.reset_for_tests()


class Ids:
    """A deterministic uuid sequence, one per package."""

    def __init__(self, seed):
        self.rng = random.Random(seed)

    def one(self):
        h = f"{self.rng.getrandbits(128):032x}"
        return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"

    def many(self, n):
        return [self.one() for _ in range(n)]


def conv(obj, fn):
    return fn(dataclasses.asdict(obj))


def make_node(rng, rack=None):
    n = jmock.node()
    n.resources.networks = []
    n.reserved.networks = []
    n.resources.cpu = rng.choice([2000, 4000])
    n.resources.memory_mb = rng.choice([4096, 8192])
    if rack is not None:
        n.meta["rack"] = rack
    n.compute_class()
    return n


def make_job(rng, count, cpu=None):
    j = jmock.job()
    j.task_groups[0].count = count
    for t in j.task_groups[0].tasks:
        t.resources.networks = []
        t.resources.cpu = cpu if cpu is not None else rng.choice([250, 500])
        t.resources.memory_mb = rng.choice([128, 256])
    return j


class Twin:
    """One cluster in both packages' harnesses.  The port's store keeps a
    columnar mirror when the reference's ``NOMAD_TPU_COLUMNAR`` (read
    here) leaves the reference's on."""

    def __init__(self, monkeypatch, seed):
        self.mp = monkeypatch
        self.seed = seed
        self.rng = random.Random(seed)
        columnar = os.environ.get("NOMAD_TPU_COLUMNAR", "1") != "0"
        self.jh = JHarness()
        self.ph = Harness(StateStore(columnar=columnar))
        self.jids, self.pids = Ids(seed), Ids(seed)
        self.jobs = {}

    def add_node(self, node):
        self.jh.state.upsert_node(self.jh.next_index(), node)
        self.ph.state.upsert_node(self.ph.next_index(),
                                  conv(node, convert.node_from_dict))

    def put_job(self, job):
        self.jobs[job.id] = job
        self.jh.state.upsert_job(self.jh.next_index(), job)
        self.ph.state.upsert_job(self.ph.next_index(),
                                 conv(job, convert.job_from_dict))

    def node_down(self, node_id):
        self.jh.state.update_node_status(self.jh.next_index(), node_id,
                                         js.NODE_STATUS_DOWN)
        self.ph.state.update_node_status(self.ph.next_index(), node_id,
                                         ps.NODE_STATUS_DOWN)

    def eval_for(self, job, trigger=js.EVAL_TRIGGER_JOB_REGISTER):
        h = f"{self.rng.getrandbits(128):032x}"
        return js.Evaluation(
            id=f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}",
            priority=job.priority, type=job.type, triggered_by=trigger,
            job_id=job.id, status=js.EVAL_STATUS_PENDING)

    def run(self, evals, seed=None, **port_kw):
        """One batch through both schedulers; ``port_kw`` go to the
        port's."""
        seed = self.seed if seed is None else seed
        self.mp.setenv("NOMAD_TPU_RNG_SEED", str(seed))
        with self.mp.context() as m:
            m.setattr(js, "generate_uuid", self.jids.one)
            m.setattr(js, "generate_uuids", self.jids.many)
            jst = TPUBatchScheduler(self.jh.logger, self.jh.snapshot(),
                                    self.jh, breaker=JBreaker()
                                    ).schedule_batch(evals)
        with self.mp.context() as m:
            m.setattr(ps, "generate_uuid", self.pids.one)
            m.setattr(ps, "generate_uuids", self.pids.many)
            pst = TorchBatchScheduler(
                self.ph.logger, self.ph.snapshot(), self.ph, device="cpu",
                rng_seed=seed, breaker=KernelCircuitBreaker(), **port_kw
            ).schedule_batch([conv(e, convert.eval_from_dict)
                              for e in evals])
        assert jst.oracle_routed == 0
        assert pst.oracle_routed == 0
        assert_same_world(self.jh, self.ph)
        return jst, pst


def _metric(m):
    return (m.nodes_evaluated, m.nodes_filtered, m.nodes_available,
            m.class_filtered, m.constraint_filtered, m.nodes_exhausted,
            m.class_exhausted, m.dimension_exhausted, m.coalesced_failures)


def _scores_close(want, got):
    assert set(want) == set(got)
    for k, v in want.items():
        assert abs(got[k] - v) <= SCORE_ATOL, k


def _alloc_row(a):
    """An alloc's identity, statuses and network offers."""
    return (a.id, a.name, a.node_id, a.job_id, a.task_group, a.eval_id,
            a.desired_status, a.desired_description, a.client_status,
            a.previous_allocation, tuple(sorted(
                (task, n.device, n.ip, n.mbits,
                 tuple((p.label, p.value) for p in n.reserved_ports),
                 tuple((p.label, p.value) for p in n.dynamic_ports))
                for task, res in a.task_resources.items()
                for n in res.networks)))


def _eval_row(e):
    return (e.id, e.status, e.status_description, e.triggered_by,
            e.job_id, e.next_eval, e.previous_eval, e.blocked_eval,
            e.wait, e.queued_allocations, e.class_eligibility,
            e.escaped_computed_class,
            {k: _metric(m) for k, m in e.failed_tg_allocs.items()})


def _plan_rows(p):
    return (
        p.eval_id,
        {n: [(a.id, a.name, a.desired_status, a.desired_description,
              a.client_status) for a in v] for n, v in p.node_update.items()},
        {n: [_alloc_row(a) for a in v]
         for n, v in p.node_allocation.items()},
        [(sl.proto.task_group, list(sl.ids), list(sl.names),
          list(sl.node_ids), list(sl.prev_ids)) for sl in p.alloc_slabs])


def assert_same_world(jh, ph):
    want = {a.id: a for a in jh.state.allocs(None)}
    got = {a.id: a for a in ph.state.allocs(None)}
    assert sorted(map(_alloc_row, got.values())) == \
        sorted(map(_alloc_row, want.values()))
    for aid, a in want.items():
        if a.metrics is not None:
            _scores_close(a.metrics.scores, got[aid].metrics.scores)
    assert [_plan_rows(p) for p in ph.plans] == \
        [_plan_rows(p) for p in jh.plans]
    for wh, gh in ((jh.evals, ph.evals), (jh.create_evals, ph.create_evals),
                   (jh.reblock_evals, ph.reblock_evals)):
        assert [_eval_row(e) for e in gh] == [_eval_row(e) for e in wh]


def registered_twin(monkeypatch, seed, n_nodes=16, counts=(6, 9, 4),
                    update=None):
    t = Twin(monkeypatch, seed)
    for _ in range(n_nodes):
        t.add_node(make_node(t.rng))
    jobs = []
    for c in counts:
        j = make_job(t.rng, c)
        if update is not None:
            j.update = update
        t.put_job(j)
        jobs.append(j)
    t.run([t.eval_for(j) for j in jobs])
    return t, jobs


def bump(t, job, change):
    """A new version of ``job`` with ``change`` applied, upserted in both
    packages."""
    new = job.copy()
    change(new)
    t.put_job(new)
    return new


SCENARIOS = ("register", "scale_up", "scale_down", "destructive",
             "inplace", "node_down", "job_stop", "rolling",
             "distinct_property", "networks")


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_twin_eval_batch(scenario, monkeypatch):
    seed = 1000 + SCENARIOS.index(scenario)
    if scenario == "register":
        # One job asks for more than the cluster holds: a partial
        # placement, a blocked eval and its failure metrics.
        t, jobs = registered_twin(monkeypatch, seed, counts=(6, 200, 4))
        assert any(e.failed_tg_allocs for e in t.ph.evals)
        assert t.ph.create_evals
        return
    if scenario == "networks":
        # mock.node()/mock.job() as written: network asks on the device
        # path, offers made at finalize from the state store.
        t = Twin(monkeypatch, seed)
        for _ in range(10):
            t.add_node(jmock.node())
        jobs = [jmock.job() for _ in range(3)]
        jobs[2].task_groups[0].count = 60
        for j in jobs:
            t.put_job(j)
        t.run([t.eval_for(j) for j in jobs])
        more = jmock.job()
        t.put_job(more)
        t.run([t.eval_for(more)], seed=seed + 1)
        allocs = t.ph.state.allocs(None)
        assert allocs and all(a.task_resources["web"].networks
                              for a in allocs)
        return
    if scenario == "distinct_property":
        t = Twin(monkeypatch, seed)
        for i in range(12):
            t.add_node(make_node(t.rng, rack=f"r{i % 6}"))
        job = make_job(t.rng, 4, cpu=250)
        job.task_groups[0].constraints = [js.Constraint(
            "${meta.rack}", "", js.CONSTRAINT_DISTINCT_PROPERTY)]
        t.put_job(job)
        t.run([t.eval_for(job)])
        new = bump(t, job, lambda j: setattr(
            j.task_groups[0].tasks[0].resources, "cpu", 300))
        t.run([t.eval_for(new)], seed=seed + 1)
        placed = [a for a in t.ph.state.allocs_by_job(None, job.id, True)
                  if not a.terminal_status()]
        racks = [t.ph.state.node_by_id(None, a.node_id).meta["rack"]
                 for a in placed]
        assert len(placed) == 4 and len(set(racks)) == 4
        return

    update = (js.UpdateStrategy(stagger=30.0, max_parallel=2)
              if scenario == "rolling" else None)
    t, jobs = registered_twin(monkeypatch, seed, update=update)
    job = jobs[1]
    if scenario == "scale_up":
        new = bump(t, job, lambda j: setattr(j.task_groups[0], "count", 14))
        evals = [t.eval_for(new)]
    elif scenario == "scale_down":
        new = bump(t, job, lambda j: setattr(j.task_groups[0], "count", 3))
        evals = [t.eval_for(new)]
    elif scenario in ("destructive", "rolling"):
        new = bump(t, job, lambda j: setattr(
            j.task_groups[0].tasks[0].resources, "cpu", 400))
        evals = [t.eval_for(new)]
    elif scenario == "inplace":
        new = bump(t, job, lambda j: j.constraints.append(
            js.Constraint("${attr.arch}", "x86", "=")))
        evals = [t.eval_for(new)]
    elif scenario == "node_down":
        busy = {a.node_id for a in t.jh.state.allocs(None)}
        down = sorted(busy)[:2]
        for nid in down:
            t.node_down(nid)
        hit = sorted({a.job_id for a in t.jh.state.allocs(None)
                      if a.node_id in down})
        evals = [t.eval_for(t.jobs[jid], js.EVAL_TRIGGER_NODE_UPDATE)
                 for jid in hit]
    elif scenario == "job_stop":
        new = bump(t, job, lambda j: setattr(j, "stop", True))
        evals = [t.eval_for(new, js.EVAL_TRIGGER_JOB_DEREGISTER)]
    # One more register in the same batch: the device path runs for it.
    extra = make_job(t.rng, 5)
    t.put_job(extra)
    t.run(evals + [t.eval_for(extra)], seed=seed + 1)

    plan = next(p for p in t.ph.plans if p.eval_id == evals[0].id)
    stops = [a for v in plan.node_update.values() for a in v]
    prevs = [p for sl in plan.alloc_slabs for p in sl.prev_ids if p]
    if scenario == "scale_down":
        assert len(stops) == 6
    elif scenario == "destructive":
        assert len(stops) == 9 and len(prevs) == 9
    elif scenario == "rolling":
        assert len(stops) == 2 and len(prevs) == 2
        assert [e.triggered_by for e in t.ph.create_evals] == \
            [ps.EVAL_TRIGGER_ROLLING_UPDATE]
    elif scenario == "inplace":
        assert not stops and sum(
            len(v) for v in plan.node_allocation.values()) == 9
    elif scenario == "node_down":
        assert stops and all(a.client_status == ps.ALLOC_CLIENT_STATUS_LOST
                             for a in stops)
    elif scenario == "job_stop":
        assert len(stops) == 9 and not plan.alloc_slabs
    elif scenario == "scale_up":
        assert sum(len(sl) for sl in plan.alloc_slabs) == 5


def test_failure_forensics_match_reference(monkeypatch):
    """Every failed task group's AllocMetric, field by field, on the
    scenario of tests/test_tpu_kernels.py:360 (class and constraint
    filtering, capacity exhaustion)."""
    t = Twin(monkeypatch, 11)
    for i in range(12):
        n = jmock.node()
        n.resources.networks = []
        n.reserved.networks = []
        n.node_class = "big" if i % 2 == 0 else "small"
        n.attributes["kernel.name"] = "linux" if i < 8 else "windows"
        n.resources.cpu = 500
        n.resources.memory_mb = 512
        n.compute_class()
        t.add_node(n)
    job = make_job(t.rng, 2, cpu=2000)
    job.constraints = [js.Constraint("${attr.kernel.name}", "linux", "=")]
    t.put_job(job)
    t.run([t.eval_for(job)])
    m = t.ph.evals[-1].failed_tg_allocs["web"]
    assert m.nodes_evaluated == 12 and m.nodes_filtered == 4
    assert m.constraint_filtered and m.dimension_exhausted


def test_coalesced_failures_match_reference(monkeypatch):
    """tests/test_tpu_kernels.py:254: one node fits 2 of 5; the failure
    is recorded once and coalesced twice."""
    t = Twin(monkeypatch, 12)
    n = jmock.node()
    n.resources = js.Resources(cpu=1100, memory_mb=1024, disk_mb=20000,
                               iops=100)
    n.reserved = None
    n.compute_class()
    t.add_node(n)
    job = make_job(t.rng, 5, cpu=500)
    t.put_job(job)
    t.run([t.eval_for(job)])
    assert len(t.ph.state.allocs_by_job(None, job.id, True)) == 2
    assert t.ph.evals[-1].failed_tg_allocs["web"].coalesced_failures == 2
    assert [e.status for e in t.ph.create_evals] == [ps.EVAL_STATUS_BLOCKED]


def port_cluster(n_nodes, seed):
    rng = random.Random(seed)
    h = Harness()
    for _ in range(n_nodes):
        h.state.upsert_node(h.next_index(),
                            conv(make_node(rng), convert.node_from_dict))
    return h, rng


def port_register(h, rng, counts):
    jobs = []
    for c in counts:
        j = conv(make_job(rng, c), convert.job_from_dict)
        h.state.upsert_job(h.next_index(), j)
        jobs.append(j)
    return jobs, [ps.Evaluation(
        id=ps.generate_uuid(), priority=j.priority, type=j.type,
        triggered_by=ps.EVAL_TRIGGER_JOB_REGISTER, job_id=j.id,
        status=ps.EVAL_STATUS_PENDING) for j in jobs]


def placed_count(h, job):
    return len([a for a in h.state.allocs_by_job(None, job.id, True)
                if not a.terminal_status()])


def test_breaker_trip_and_probe_recovery():
    """tests/test_fused.py:396 on the port: ``ops.kernel_result``
    corrupts the result, the batch is rejected, the breaker opens and the
    oracle places everything; while open the oracle carries; past the
    cooldown a clean half-open probe closes it."""
    clock = [0.0]
    brk = KernelCircuitBreaker(threshold=0.9, window=8, min_checks=1,
                               cooldown=5.0, clock=lambda: clock[0])
    h, rng = port_cluster(8, 5)

    def batch():
        jobs, evals = port_register(h, rng, (2, 2))
        stats = TorchBatchScheduler(h.logger, h.snapshot(), h, device="cpu",
                                    breaker=brk).schedule_batch(evals)
        return stats, all(placed_count(h, j) == 2 for j in jobs)

    with fault.scenario({"seed": 5, "faults": [
            {"point": "ops.kernel_result", "action": "corrupt",
             "times": 1}]}):
        st1, placed1 = batch()
        fired = fault.trace()
    assert fired == [("ops.kernel_result", 0, "corrupt")]
    assert st1.kernel_rejects == 1 and st1.oracle_routed == 2 and placed1
    assert brk.state == "open" and brk.trips == 1

    st2, placed2 = batch()              # open: the oracle carries
    assert st2.oracle_routed == 2 and not st2.device_ran and placed2

    clock[0] += 6.0                     # past the cooldown: the probe
    st3, placed3 = batch()
    assert st3.oracle_routed == 0 and st3.device_ran and placed3
    assert brk.state == "closed"


@pytest.mark.parametrize("stage", ["_dispatch", "_fetch"])
def test_raw_device_error_propagates_without_the_breaker(monkeypatch,
                                                         stage):
    """A failed launch or fetch is no validation verdict: it propagates,
    the breaker records nothing and stays closed, and no eval is routed
    through the oracle."""
    # The columnar guards' cadence counts reads process-wide: from zero,
    # no guard verdict of the encode lands on this breaker either.
    columnar.reset_counters()
    brk = KernelCircuitBreaker(threshold=0.9, window=8, min_checks=1)
    h, rng = port_cluster(8, 9)
    jobs, evals = port_register(h, rng, (2, 2))

    def fail(*args, **kwargs):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(batch_sched, stage, fail)
    with pytest.raises(RuntimeError, match="launch failed"):
        TorchBatchScheduler(h.logger, h.snapshot(), h, device="cpu",
                            breaker=brk).schedule_batch(evals)
    assert brk.state == "closed" and not brk._checks
    assert all(placed_count(h, j) == 0 for j in jobs)


def test_process_wide_breaker_is_the_default():
    h, rng = port_cluster(4, 6)
    sched = TorchBatchScheduler(h.logger, h.snapshot(), h, device="cpu")
    assert sched.breaker is breaker.BREAKER


def test_static_buffer_uploaded_once():
    """A second batch on an unchanged node table uploads no static bytes:
    its h2d is the dynamic buffer alone (counted on the CPU too)."""
    batch_sched._DEVICE_STATIC_CACHE.clear()
    h, rng = port_cluster(20, 7)
    stats = []
    for counts in ((5, 7), (4, 3)):
        _, evals = port_register(h, rng, counts)
        stats.append(new_scheduler("torch-batch", h.logger, h.snapshot(), h,
                                   device="cpu", rng_seed=3
                                   ).schedule_batch(evals))
    first, second = stats
    assert first.device_ran and second.device_ran
    assert first.static_h2d_bytes > 0
    assert first.h2d_bytes > first.static_h2d_bytes
    assert second.static_h2d_bytes == 0
    assert 0 < second.h2d_bytes < first.h2d_bytes
    # A node write changes the static tensors: uploaded again.
    node = h.state.nodes(None)[0]
    h.state.update_node_drain(h.next_index(), node.id, True)
    _, evals = port_register(h, rng, (2,))
    third = TorchBatchScheduler(h.logger, h.snapshot(), h, device="cpu",
                                rng_seed=3).schedule_batch(evals)
    assert third.static_h2d_bytes > 0


def test_plan_conflict_retried_through_oracle(monkeypatch):
    """A planner that rejects every plan: the eval goes to the oracle's
    refresh-and-retry, which fails it with a max-plan-attempts blocked
    eval, as the reference does."""
    t = Twin(monkeypatch, 21)
    for _ in range(6):
        t.add_node(make_node(t.rng))
    job = make_job(t.rng, 3)
    t.put_job(job)
    t.jh.planner = JRejectPlan(t.jh)
    t.ph.planner = RejectPlan(t.ph)
    ev = t.eval_for(job)
    t.mp.setenv("NOMAD_TPU_RNG_SEED", "4")
    with t.mp.context() as m:
        m.setattr(js, "generate_uuid", t.jids.one)
        m.setattr(js, "generate_uuids", t.jids.many)
        TPUBatchScheduler(t.jh.logger, t.jh.snapshot(), t.jh,
                          breaker=JBreaker()).schedule_batch([ev])
    with t.mp.context() as m:
        m.setattr(ps, "generate_uuid", t.pids.one)
        m.setattr(ps, "generate_uuids", t.pids.many)
        st = TorchBatchScheduler(t.ph.logger, t.ph.snapshot(), t.ph,
                                 device="cpu", rng_seed=4).schedule_batch(
            [conv(ev, convert.eval_from_dict)])
    assert st.device_ran and st.conflict_retries == 1
    assert st.oracle_routed == 0
    assert [e.status for e in t.ph.evals] == [ps.EVAL_STATUS_FAILED]
    assert [e.triggered_by for e in t.ph.create_evals] == \
        [ps.EVAL_TRIGGER_MAX_PLANS]
    assert len(t.ph.plans) == len(t.jh.plans) > 1
    for wh, gh in ((t.jh.evals, t.ph.evals),
                   (t.jh.create_evals, t.ph.create_evals)):
        assert [_eval_row(e) for e in gh] == [_eval_row(e) for e in wh]


def test_unported_options_raise():
    h, rng = port_cluster(2, 8)
    # Device preemption is ported: the flag is taken, no longer refused
    # (its behaviour is held in tests/test_torch_preempt.py).
    assert TorchBatchScheduler(h.logger, h.snapshot(), h, device="cpu",
                               preemption_enabled=True).preemption_enabled
    # So are annotate_plan evals (the job plan dry run): the plan carries
    # the annotations (held against the reference in
    # tests/test_torch_plan.py).
    _, evals = port_register(h, rng, (1,))
    evals[0].annotate_plan = True
    TorchBatchScheduler(h.logger, h.snapshot(), h,
                        device="cpu").process(evals[0])
    assert h.plans[-1].eval_id == evals[0].id
    assert h.plans[-1].annotations.desired_tg_updates["web"].place == 1


def test_mesh_matches_single_device(monkeypatch):
    """``TorchBatchScheduler(mesh=...)`` (four shards on the CPU) makes the
    single device's plans, eval updates and failure forensics (a job
    filtered on part of the fleet fails too: its feasibility row is
    fetched from the shards)."""
    from nomad_tpu_torch.parallel import make_node_mesh

    rng = random.Random(31)
    nodes = [conv(make_node(rng), convert.node_from_dict) for _ in range(40)]
    for n in nodes[:10]:
        n.attributes["kernel.name"] = "windows"
        n.compute_class()
    jobs = [conv(make_job(rng, c), convert.job_from_dict)
            for c in (12, 30, 600)]
    worlds = []
    for kw in ({"device": "cpu"}, {"mesh": make_node_mesh(["cpu"] * 4)}):
        ids = Ids(5)
        with monkeypatch.context() as m:
            m.setattr(ps, "generate_uuid", ids.one)
            m.setattr(ps, "generate_uuids", ids.many)
            h = Harness()
            for n in nodes:
                h.state.upsert_node(h.next_index(), n)
            for j in jobs:
                h.state.upsert_job(h.next_index(), j)
            evals = [ps.Evaluation(
                id=ids.one(), priority=j.priority, type=j.type,
                triggered_by=ps.EVAL_TRIGGER_JOB_REGISTER, job_id=j.id,
                status=ps.EVAL_STATUS_PENDING) for j in jobs]
            st = TorchBatchScheduler(h.logger, h.snapshot(), h, rng_seed=9,
                                     **kw).schedule_batch(evals)
        worlds.append((h, st))
    (single, st1), (mesh, st4) = worlds
    assert st1.mesh_shards == 0 and st4.mesh_shards == 4
    assert st4.device_ran and st4.oracle_routed == 0
    failed = single.evals[-1].failed_tg_allocs["web"]
    assert failed.nodes_filtered == 10
    assert [_plan_rows(p) for p in mesh.plans] == \
        [_plan_rows(p) for p in single.plans]
    assert [_eval_row(e) for e in mesh.evals] == \
        [_eval_row(e) for e in single.evals]
    got = {a.id: a for a in mesh.state.allocs(None)}
    for a in single.state.allocs(None):
        _scores_close(a.metrics.scores, got[a.id].metrics.scores)
