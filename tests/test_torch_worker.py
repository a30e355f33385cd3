"""The port's batch worker, its system route and its telemetry.

- The pipelined drain (``ServerConfig(pipeline=True)``, the reference's
  ``NOMAD_TPU_PIPELINE``) commits what the serial drain commits, over a
  stream of several batches.
- A failing batch is nacked whole and redelivered, and the second
  delivery places it (``tests/test_server.py::TestBatchWorkerMixedStream``
  on the port), for the serial and the pipelined drain.
- System evals go to ``torch-system``, whose placements equal the
  reference's ``tpu-system`` and the oracle's (``tests/test_system_batch.py``
  on the port), on the happy path and on both fallbacks.
- The ``breaker.oracle_routed`` counter counts what the reference counts:
  nothing for a gated eval or a conflicting plan, every eval of a batch
  the open breaker routes.
- ``ServerConfig(stale_snapshot=False)`` commits what the stale-snapshot
  default commits, with no snapshot cached or reused.
- A batch's ``commit_steps`` are its own pass's, on one device and on a
  mesh, whatever other batches add to the process-wide count meanwhile.

Every server started here is shut down in a fixture's teardown; every
wait is bounded.
"""
import dataclasses
import random

import jax  # noqa: F401  (the reference computes on the CPU backend)
import pytest

from nomad_tpu import mock as jmock
from nomad_tpu.ops.batch_sched import TPUBatchScheduler
from nomad_tpu.ops.breaker import KernelCircuitBreaker as JBreaker
from nomad_tpu.ops.system_batch import new_tpu_system_scheduler
from nomad_tpu.scheduler import RejectPlan as JRejectPlan
from nomad_tpu.scheduler import context as jcontext
from nomad_tpu.scheduler.system import new_system_scheduler as j_oracle
from nomad_tpu.structs import structs as js
from nomad_tpu.utils.telemetry import Telemetry as JTelemetry
from nomad_tpu_torch import convert
from nomad_tpu_torch.ops import batch_sched
from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
from nomad_tpu_torch.ops.system_batch import new_torch_system_scheduler
from nomad_tpu_torch.scheduler import context as pcontext
from nomad_tpu_torch.scheduler.system import new_system_scheduler
from nomad_tpu_torch.scheduler.testing import Harness, RejectPlan
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.worker import BatchWorker
from nomad_tpu_torch.structs import structs as ps
from nomad_tpu_torch.utils.backoff import wait_until
from nomad_tpu_torch.utils.telemetry import Telemetry

from test_torch_oracle import route_cluster
from test_torch_sched import Twin
from test_torch_server import (HEARTBEAT_TTL, JOIN_TIMEOUT, Ids, conv,
                               content, make_job, settle, strip_node,
                               system_job)

SEED = 17


@pytest.fixture
def servers(monkeypatch):
    """Port servers a test makes, with ids drawn from one seeded sequence
    per server; each is shut down in the teardown."""
    made = []

    def make(**cfg):
        ids = Ids(SEED)
        monkeypatch.setattr(ps, "generate_uuid", ids.one)
        monkeypatch.setattr(ps, "generate_uuids", ids.many)
        srv = Server(ServerConfig(device="cpu", rng_seed=SEED,
                                  min_heartbeat_ttl=HEARTBEAT_TTL,
                                  breaker=KernelCircuitBreaker(), **cfg))
        made.append(srv)
        srv.start()
        return srv

    yield make
    for srv in made:
        srv.shutdown()
        assert wait_until(lambda: not srv.threads(), JOIN_TIMEOUT)


def stream():
    rng = random.Random(SEED)
    nodes = [conv(strip_node(jmock.node(), f"node-{i:02d}",
                             cpu=rng.choice([2000, 4000])),
                  convert.node_from_dict) for i in range(24)]
    jobs = [conv(make_job(f"job-{k}", rng.randint(2, 9),
                          rng.choice([250, 500]), rng.choice([128, 256]),
                          priority=rng.choice([40, 50, 60])),
                 convert.job_from_dict) for k in range(9)]
    return nodes, jobs


def drain(srv, nodes, jobs):
    for n in nodes:
        srv.node_register(n)
    assert srv.set_workers_paused(True, timeout=30.0)
    for j in jobs:
        srv.job_register(j)
    srv.set_workers_paused(False)
    settle(srv)
    return content(srv)


def batch_count(srv):
    return srv.metrics.sink.latest()["SampleTotals"][
        "nomad.worker.invoke_scheduler.batch"][0]


def test_pipelined_drain_equals_serial_drain(servers):
    nodes, jobs = stream()
    serial = servers(batch_size=2)
    want = drain(serial, nodes, jobs)
    nodes, jobs = stream()
    piped = servers(batch_size=2, pipeline=True)
    got = drain(piped, nodes, jobs)
    assert got == want
    # Nine evals in batches of two: five batches in each drain.
    assert batch_count(serial) == batch_count(piped) == 5
    placed = [a for a in got["allocs"] if a[3] == "run"]
    assert len(placed) == sum(j.task_groups[0].count for j in jobs)
    assert serial.eval_broker.stats()["total_nacks"] == 0
    assert piped.eval_broker.stats()["total_nacks"] == 0


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["serial", "pipelined"])
def test_failing_batch_is_nacked_and_redelivered(servers, monkeypatch,
                                                 pipeline):
    calls = {"n": 0}
    orig = batch_sched.TorchBatchScheduler._dispatch_prepared

    def flaky(self, prep):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected batch failure")
        return orig(self, prep)

    monkeypatch.setattr(batch_sched.TorchBatchScheduler,
                        "_dispatch_prepared", flaky)
    srv = servers(pipeline=pipeline)
    srv.eval_broker.initial_nack_delay = 0.05
    failures = []
    orig_fail = BatchWorker.record_eval_failures

    def record(self, evs, exc):
        failures.append(([e.id for e in evs], str(exc)))
        return orig_fail(self, evs, exc)

    monkeypatch.setattr(BatchWorker, "record_eval_failures", record)
    srv.node_register(conv(strip_node(jmock.node()), convert.node_from_dict))
    job = conv(make_job("flaky", 2, 500, 256), convert.job_from_dict)
    _, eval_id = srv.job_register(job)
    assert wait_until(lambda: srv.state.eval_by_id(None, eval_id).status
                      == ps.EVAL_STATUS_COMPLETE, 60.0)
    assert len(srv.state.allocs_by_job(None, job.id, True)) == 2
    assert calls["n"] == 2
    assert srv.eval_broker.stats()["total_nacks"] == 1
    assert failures == [([eval_id], "injected batch failure")]


def test_system_evals_go_to_torch_system(servers, monkeypatch):
    srv = servers()
    sched_names = set()
    orig = BatchWorker.sched_name

    def spy(self, ev):
        name = orig(self, ev)
        sched_names.add(name)
        return name

    monkeypatch.setattr(BatchWorker, "sched_name", spy)
    for i in range(6):
        srv.node_register(conv(strip_node(jmock.node(), f"n-{i}"),
                               convert.node_from_dict))
    job = conv(system_job(), convert.job_from_dict)
    _, eval_id = srv.job_register(job)
    assert wait_until(lambda: srv.state.eval_by_id(None, eval_id).status
                      == ps.EVAL_STATUS_COMPLETE, 60.0)
    allocs = srv.state.allocs_by_job(None, job.id, True)
    assert sorted(a.node_id for a in allocs) == [f"n-{i}" for i in range(6)]
    assert sched_names == {"torch-system"}


def test_fresh_snapshots_commit_what_stale_ones_commit(servers):
    """``ServerConfig(stale_snapshot=False)``: every single-eval schedule
    (here the system evals) takes a fresh snapshot, with no cache and no
    reuse, and commits what the stale-snapshot default commits."""
    def run(stale):
        srv = servers(stale_snapshot=stale)
        for i in range(6):
            srv.node_register(conv(strip_node(jmock.node(), f"n-{i}"),
                                   convert.node_from_dict))
        for k in range(3):
            srv.job_register(conv(system_job(f"sys-{k}"),
                                  convert.job_from_dict))
            settle(srv)
        return srv, content(srv)

    stale, want = run(True)
    fresh, got = run(False)
    assert got == want
    assert len([a for a in got["allocs"] if a[3] == "run"]) == 18
    totals = [srv.metrics.sink.latest()["CounterTotals"]
              for srv in (stale, fresh)]
    assert totals[0].get("nomad.worker.snapshot_fresh", 0) > 0
    assert not any(k in totals[1] for k in ("nomad.worker.snapshot_fresh",
                                            "nomad.worker.snapshot_reuse"))
    assert all(w._snap_cache is None for w in fresh.workers)


# -- torch-system against tpu-system -----------------------------------------

def system_cluster(n, attrs=None):
    nodes = []
    for i in range(n):
        node = jmock.node()
        node.id = f"node-{i:04d}"
        node.resources.networks = []
        node.reserved.networks = []
        # Every third node too small for a 3000-MHz ask.
        node.resources.cpu = 2000 if i % 3 == 1 else 4000
        if attrs:
            node.attributes.update(attrs(i))
        node.compute_class()
        nodes.append(node)
    return nodes


def sys_job(cpu=100, constrained=False):
    job = system_job("sys", cpu=cpu, mem=64)
    if constrained:
        job.task_groups[0].constraints = list(
            job.task_groups[0].constraints) + [
            js.Constraint("${attr.rack}", "r1", "=")]
    return job


SYSTEM_CASES = {
    "happy": (50, None, lambda: sys_job()),
    "filtered": (30, lambda i: {"rack": "r1" if i % 3 == 0 else "r2"},
                 lambda: sys_job(constrained=True)),
    "exhausted": (9, None, lambda: sys_job(cpu=3000)),
}


def run_system(factory, nodes, job, port):
    from nomad_tpu.scheduler import Harness as JHarness

    h = Harness() if port else JHarness()
    for n in nodes:
        h.state.upsert_node(h.next_index(),
                            conv(n, convert.node_from_dict) if port else n)
    j = conv(job, convert.job_from_dict) if port else job
    h.state.upsert_job(h.next_index(), j)
    s = ps if port else js
    ev = s.Evaluation(id=f"eval-{job.id}", priority=j.priority, type=j.type,
                      triggered_by=s.EVAL_TRIGGER_JOB_REGISTER, job_id=j.id,
                      status=s.EVAL_STATUS_PENDING)
    factory(h.logger, h.snapshot(), h).process(ev)
    placements = sorted((a.node_id, a.task_group, a.name)
                        for a in h.state.allocs_by_job(None, j.id, True))
    return (placements, h.evals[-1].status,
            sum(len(p.alloc_slabs) for p in h.plans))


@pytest.mark.parametrize("case", sorted(SYSTEM_CASES))
def test_torch_system_places_what_tpu_system_places(case):
    n, attrs, job_fn = SYSTEM_CASES[case]
    nodes, job = system_cluster(n, attrs), job_fn()
    want, want_st, want_slabs = run_system(new_tpu_system_scheduler, nodes,
                                           job, port=False)
    got, got_st, got_slabs = run_system(new_torch_system_scheduler, nodes,
                                        job, port=True)
    oracle, oracle_st, _ = run_system(new_system_scheduler, nodes, job,
                                      port=True)
    ref_oracle, _, _ = run_system(j_oracle, nodes, job, port=False)
    assert got == want == oracle == ref_oracle
    assert len(got) == {"happy": 50, "filtered": 10, "exhausted": 6}[case]
    assert got_st == want_st == oracle_st
    # The vectorized pass commits one slab on the happy path; the
    # fallbacks commit explicit allocs.
    assert got_slabs == want_slabs == (1 if case == "happy" else 0)


# -- the oracle-route counter, counted as the reference counts it ------------

def counter(metrics, key="breaker.oracle_routed"):
    return metrics.sink.latest()["CounterTotals"].get(f"nomad.{key}", 0)


def run_counted(t, evals, jbrk=None, pbrk=None):
    jm, pm = JTelemetry(), Telemetry()
    with t.mp.context() as m:
        m.setenv("NOMAD_TPU_RNG_SEED", "5")
        m.setattr(js, "generate_uuid", t.jids.one)
        m.setattr(js, "generate_uuids", t.jids.many)
        jst = TPUBatchScheduler(t.jh.logger, t.jh.snapshot(), t.jh,
                                breaker=jbrk or JBreaker(),
                                metrics=jm).schedule_batch(evals)
    with t.mp.context() as m:
        m.setattr(ps, "generate_uuid", t.pids.one)
        m.setattr(ps, "generate_uuids", t.pids.many)
        pst = batch_sched.TorchBatchScheduler(
            t.ph.logger, t.ph.snapshot(), t.ph, device="cpu", rng_seed=5,
            breaker=pbrk or KernelCircuitBreaker(), metrics=pm
        ).schedule_batch([conv(e, convert.eval_from_dict) for e in evals])
    return jst, pst, counter(jm), counter(pm)


def test_gated_eval_is_not_an_oracle_route(monkeypatch):
    t = Twin(monkeypatch, 31)
    job, other = route_cluster(t, "job_distinct_property")
    monkeypatch.setattr(jcontext, "_SEED_SOURCE", random.Random(7))
    monkeypatch.setattr(pcontext, "_SEED_SOURCE", random.Random(7))
    jst, pst, jc, pc = run_counted(t, [t.eval_for(job), t.eval_for(other)])
    assert pst.gate_routed == 1 and pst.device_ran and jst.device_ran
    assert pst.oracle_routed == jst.oracle_routed == 0
    assert pc == jc == 0


def test_conflicting_plan_is_not_an_oracle_route(monkeypatch):
    t = Twin(monkeypatch, 21)
    rng = random.Random(21)
    for i in range(6):
        t.add_node(strip_node(jmock.node(), f"node-{i}",
                              cpu=rng.choice([2000, 4000])))
    job = make_job("conflict", 3, 500, 256)
    t.put_job(job)
    t.jh.planner = JRejectPlan(t.jh)
    t.ph.planner = RejectPlan(t.ph)
    jst, pst, jc, pc = run_counted(t, [t.eval_for(job)])
    assert pst.conflict_retries == 1
    assert pst.oracle_routed == jst.oracle_routed == 0
    assert pc == jc == 0
    assert [e.status for e in t.ph.evals] == \
        [e.status for e in t.jh.evals] == [ps.EVAL_STATUS_FAILED]


def test_open_breaker_routes_count_alike(monkeypatch):
    t = Twin(monkeypatch, 41)
    for i in range(6):
        t.add_node(strip_node(jmock.node(), f"node-{i}"))
    jobs = [make_job(f"open-{k}", 2, 250, 128) for k in range(3)]
    for j in jobs:
        t.put_job(j)
    jbrk = JBreaker(min_checks=1, cooldown=3600.0)
    pbrk = KernelCircuitBreaker(min_checks=1, cooldown=3600.0)
    jbrk.record(False)
    pbrk.record(False)
    assert jbrk.state == pbrk.state == "open"
    monkeypatch.setattr(jcontext, "_SEED_SOURCE", random.Random(3))
    monkeypatch.setattr(pcontext, "_SEED_SOURCE", random.Random(3))
    jst, pst, jc, pc = run_counted(t, [t.eval_for(j) for j in jobs],
                                   jbrk=jbrk, pbrk=pbrk)
    assert pst.oracle_routed == jst.oracle_routed == 3
    assert pc == jc == 3
    assert not pst.device_ran and not jst.device_ran


def test_batch_telemetry_names_match_the_reference(monkeypatch):
    """The port's batch samples are the reference's
    ``worker.invoke_scheduler.*`` family (the port's host decode is its
    ``metrics`` sample), and the breaker gauges are set."""
    t = Twin(monkeypatch, 51)
    for i in range(6):
        t.add_node(strip_node(jmock.node(), f"node-{i}"))
    job = make_job("telemetry", 4, 250, 128)
    t.put_job(job)
    jm, pm = JTelemetry(), Telemetry()
    with t.mp.context() as m:
        m.setenv("NOMAD_TPU_RNG_SEED", "5")
        TPUBatchScheduler(t.jh.logger, t.jh.snapshot(), t.jh,
                          breaker=JBreaker(), metrics=jm).schedule_batch(
            [t.eval_for(job)])
    batch_sched.TorchBatchScheduler(
        t.ph.logger, t.ph.snapshot(), t.ph, device="cpu", rng_seed=5,
        breaker=KernelCircuitBreaker(), metrics=pm).schedule_batch(
        [conv(t.eval_for(job), convert.eval_from_dict)])
    jl, pl = jm.sink.latest(), pm.sink.latest()
    want = {k for k in jl["SampleTotals"]
            if k not in ("nomad.worker.invoke_scheduler.commit",
                         "nomad.worker.invoke_scheduler.fetch")}
    assert want | {"nomad.worker.invoke_scheduler.metrics"} == \
        set(pl["SampleTotals"])
    for key in ("nomad.breaker.state", "nomad.breaker.trips"):
        assert pl["Gauges"][key] == jl["Gauges"][key] == 0
    assert dataclasses.is_dataclass(ps.Plan)


@pytest.mark.parametrize("shards", [0, 4], ids=["card", "mesh4"])
def test_commit_steps_are_counted_by_the_pass(monkeypatch, shards):
    """``BatchStats.commit_steps`` and the ``batch.commit_steps`` counter
    come from the batch's own pass: steps that other batches add to the
    process-wide ``kernels.COMMIT_STEPS`` meanwhile are not counted."""
    from nomad_tpu_torch.ops import fused_score, kernels
    from nomad_tpu_torch.parallel import make_node_mesh

    t = Twin(monkeypatch, 61)
    for i in range(8):
        t.add_node(strip_node(jmock.node(), f"node-{i}"))
    jobs = [make_job(f"steps-{k}", 3, 250, 128) for k in range(3)]
    for j in jobs:
        t.put_job(j)
    calls = {"n": 0}
    orig = fused_score.scored_rows

    def busy_neighbour(*args, **kwargs):
        # Another batch placing at the same time bumps the process-wide
        # count between this pass's steps.
        calls["n"] += 1
        kernels.COMMIT_STEPS += 1000
        return orig(*args, **kwargs)

    monkeypatch.setattr(fused_score, "scored_rows", busy_neighbour)
    where = ({"mesh": make_node_mesh(["cpu"] * shards)} if shards
             else {"device": "cpu"})
    pm = Telemetry()
    st = batch_sched.TorchBatchScheduler(
        t.ph.logger, t.ph.snapshot(), t.ph, rng_seed=5,
        breaker=KernelCircuitBreaker(), metrics=pm, **where
    ).schedule_batch([conv(t.eval_for(j), convert.eval_from_dict)
                      for j in jobs])
    assert st.device_ran and st.mesh_shards == shards
    assert st.commit_steps == calls["n"] // max(1, shards) > 0
    assert counter(pm, "batch.commit_steps") == st.commit_steps
