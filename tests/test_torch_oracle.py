"""The port's CPU oracle against the reference's.

- The copy: the port's ``GenericScheduler`` and the reference's process
  the same evals on one cluster built in both packages, each with
  ``random.Random(seed)`` and the same deterministic id sequence, on
  scenarios of ``tests/test_generic_sched.py`` (``mock.job()`` with its
  network asks, so the offers' port picks are compared too).
- The oracle route: specs the device pass cannot express (a job-level
  distinct_property over two groups, conflicting reserved ports, a node
  with two network devices) go through each scheduler's oracle, with
  both modules' per-eval seed source seeded alike; the port places them
  exactly as the reference does, and the rest of the batch still takes
  the device pass.
"""
import random

import jax  # noqa: F401  (the reference computes on the CPU backend)
import pytest

from nomad_tpu import mock as jmock
from nomad_tpu.ops.batch_sched import TPUBatchScheduler
from nomad_tpu.ops.breaker import KernelCircuitBreaker as JBreaker
from nomad_tpu.scheduler import RejectPlan as JRejectPlan
from nomad_tpu.scheduler import context as jcontext
from nomad_tpu.scheduler.generic import GenericScheduler as JGeneric
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert
from nomad_tpu_torch.ops import breaker
from nomad_tpu_torch.ops.batch_sched import TorchBatchScheduler
from nomad_tpu_torch.scheduler import context as pcontext
from nomad_tpu_torch.scheduler.generic import GenericScheduler
from nomad_tpu_torch.scheduler.testing import RejectPlan
from nomad_tpu_torch.structs import structs as ps
from test_torch_sched import Twin, assert_same_world, conv


@pytest.fixture(autouse=True)
def fresh_breaker():
    """The port's process-wide breaker, fresh for every test here."""
    breaker.reset_for_tests()
    yield
    breaker.reset_for_tests()


def process_both(t, ev, batch=False, seed=0):
    """One eval through both oracles, each with random.Random(seed)."""
    with t.mp.context() as m:
        m.setattr(js, "generate_uuid", t.jids.one)
        m.setattr(js, "generate_uuids", t.jids.many)
        JGeneric(t.jh.logger, t.jh.snapshot(), t.jh, batch,
                 rng=random.Random(seed),
                 preemption_enabled=False).process(ev)
    with t.mp.context() as m:
        m.setattr(ps, "generate_uuid", t.pids.one)
        m.setattr(ps, "generate_uuids", t.pids.many)
        GenericScheduler(t.ph.logger, t.ph.snapshot(), t.ph, batch,
                         rng=random.Random(seed),
                         preemption_enabled=False).process(
            conv(ev, convert.eval_from_dict))
    assert_same_world(t.jh, t.ph)


def oracle_twin(monkeypatch, seed, n_nodes, count=10, job_change=None):
    t = Twin(monkeypatch, seed)
    for _ in range(n_nodes):
        t.add_node(jmock.node())
    job = jmock.job()
    job.task_groups[0].count = count
    if job_change is not None:
        job_change(job)
    t.put_job(job)
    return t, job


ORACLE_CASES = ("register", "infeasible_class", "destructive", "inplace",
                "rolling", "node_down", "node_drain", "deregister",
                "distinct_hosts", "reject_plan", "anti_affinity",
                "batch_job")


@pytest.mark.parametrize("case", ORACLE_CASES)
def test_generic_scheduler_copy_matches_reference(case, monkeypatch):
    seed = 500 + ORACLE_CASES.index(case)
    if case == "infeasible_class":
        t, job = oracle_twin(monkeypatch, seed, 3, job_change=lambda j: setattr(
            j, "constraints",
            [js.Constraint("${attr.kernel.name}", "windows", "=")]))
        process_both(t, t.eval_for(job), seed=seed)
        blocked = t.ph.create_evals[0]
        assert blocked.class_eligibility and not any(
            blocked.class_eligibility.values())
        return
    if case == "distinct_hosts":
        t, job = oracle_twin(monkeypatch, seed, 3, count=5,
                             job_change=lambda j: j.constraints.append(
                                 js.Constraint(
                                     operand=js.CONSTRAINT_DISTINCT_HOSTS)))
        process_both(t, t.eval_for(job), seed=seed)
        assert t.ph.evals[0].failed_tg_allocs["web"].coalesced_failures == 1
        return
    if case == "batch_job":
        t = Twin(monkeypatch, seed)
        for _ in range(4):
            t.add_node(jmock.node())
        job = jmock.batch_job()
        job.task_groups[0].count = 6
        t.put_job(job)
        process_both(t, t.eval_for(job), batch=True, seed=seed)
        assert len(t.ph.state.allocs_by_job(None, job.id, True)) == 6
        return
    if case == "reject_plan":
        t, job = oracle_twin(monkeypatch, seed, 2)
        t.jh.planner = JRejectPlan(t.jh)
        t.ph.planner = RejectPlan(t.ph)
        process_both(t, t.eval_for(job), seed=seed)
        assert t.ph.evals[-1].status == ps.EVAL_STATUS_FAILED
        return
    n_nodes = {"node_down": 2, "node_drain": 3}.get(case, 10)
    count = {"node_down": 2, "node_drain": 3}.get(case, 10)
    update = (js.UpdateStrategy(stagger=30.0, max_parallel=3)
              if case == "rolling" else None)
    t, job = oracle_twin(
        monkeypatch, seed, n_nodes, count,
        job_change=(lambda j: setattr(j, "update", update))
        if update else None)
    process_both(t, t.eval_for(job), seed=seed)
    if case in ("register", "anti_affinity"):
        assert len(t.ph.state.allocs_by_job(None, job.id, True)) == 10
        return
    trigger = js.EVAL_TRIGGER_JOB_REGISTER
    if case in ("destructive", "rolling", "inplace", "deregister"):
        new = job.copy()
        if case == "inplace":
            new.priority = 80
        elif case == "deregister":
            new.stop = True
            trigger = js.EVAL_TRIGGER_JOB_DEREGISTER
        else:
            new.task_groups[0].tasks[0].config = {"command": "/bin/other"}
        t.put_job(new)
    else:
        nid = t.jh.state.allocs_by_job(None, job.id, True)[0].node_id
        if case == "node_down":
            t.node_down(nid)
        else:
            t.jh.state.update_node_drain(t.jh.next_index(), nid, True)
            t.ph.state.update_node_drain(t.ph.next_index(), nid, True)
        trigger = js.EVAL_TRIGGER_NODE_UPDATE
    process_both(t, t.eval_for(job, trigger), seed=seed + 1)
    plan = t.ph.plans[-1]
    stops = [a for v in plan.node_update.values() for a in v]
    placed = [a for v in plan.node_allocation.values() for a in v]
    want = {"destructive": (10, 10), "rolling": (3, 3), "inplace": (0, 10),
            "deregister": (10, 0)}.get(case)
    if want is not None:
        assert (len(stops), len(placed)) == want
    else:
        assert stops and len(placed) == len(stops)


# -- the oracle route of the batch scheduler ----------------------------------

def route_cluster(t, case):
    """Nodes and one job the device pass cannot express, plus one it
    can."""
    for i in range(8):
        n = jmock.node()
        n.meta["rack"] = f"r{i % 4}"
        if case == "multi_ip" and i == 0:
            n.resources.networks.append(js.NetworkResource(
                device="eth1", cidr="10.0.0.0/30", mbits=1000))
        n.compute_class()
        t.add_node(n)
    job = jmock.job()
    job.task_groups[0].count = 3
    if case == "job_distinct_property":
        tg2 = job.task_groups[0].copy()
        tg2.name = "api"
        tg2.count = 2
        job.task_groups.append(tg2)
        job.constraints.append(js.Constraint(
            "${meta.rack}", "", js.CONSTRAINT_DISTINCT_PROPERTY))
    elif case == "reserved_ports":
        res = job.task_groups[0].tasks[0].resources
        res.networks[0].reserved_ports = [js.Port("a", 9100)]
        task2 = job.task_groups[0].tasks[0].copy()
        task2.name = "sidecar"
        job.task_groups[0].tasks.append(task2)
    other = jmock.job()
    other.task_groups[0].count = 4
    other.task_groups[0].tasks[0].resources.networks = []
    for j in (job, other):
        t.put_job(j)
    return job, other


@pytest.mark.parametrize("case", ("job_distinct_property", "reserved_ports",
                                  "multi_ip"))
def test_oracle_route_matches_reference(case, monkeypatch):
    """The specs the port's list entry raises on: the eval goes through
    the oracle in both schedulers, placed identically (allocs, offers,
    eval statuses, blocked evals)."""
    t = Twin(monkeypatch, 900 + len(case))
    job, other = route_cluster(t, case)
    evals = [t.eval_for(job), t.eval_for(other)]
    seed = 77
    monkeypatch.setattr(jcontext, "_SEED_SOURCE", random.Random(seed))
    monkeypatch.setattr(pcontext, "_SEED_SOURCE", random.Random(seed))
    t.mp.setenv("NOMAD_TPU_RNG_SEED", "5")
    with t.mp.context() as m:
        m.setattr(js, "generate_uuid", t.jids.one)
        m.setattr(js, "generate_uuids", t.jids.many)
        jst = TPUBatchScheduler(t.jh.logger, t.jh.snapshot(), t.jh,
                                breaker=JBreaker()).schedule_batch(evals)
    with t.mp.context() as m:
        m.setattr(ps, "generate_uuid", t.pids.one)
        m.setattr(ps, "generate_uuids", t.pids.many)
        pst = TorchBatchScheduler(t.ph.logger, t.ph.snapshot(), t.ph,
                                  device="cpu", rng_seed=5).schedule_batch(
            [conv(e, convert.eval_from_dict) for e in evals])
    # Neither package counts a gate route as oracle_routed (only the
    # breaker and reject routes); the port counts it in gate_routed.
    assert pst.gate_routed == 1
    assert pst.oracle_routed == jst.oracle_routed == 0
    assert pst.device_ran and jst.device_ran
    assert_same_world(t.jh, t.ph)
    placed = [a for a in t.ph.state.allocs_by_job(None, job.id, True)]
    if case == "job_distinct_property":
        racks = [t.ph.state.node_by_id(None, a.node_id).meta["rack"]
                 for a in placed]
        assert len(racks) == 4 and len(set(racks)) == 4
    elif case == "reserved_ports":
        assert not placed and t.ph.evals[0].failed_tg_allocs
    else:
        assert len(placed) == 3


def test_state_store_copy_matches_reference():
    """The port's state store subset against the reference's on one
    sequence of writes: nodes (status and drain), jobs (versions and the
    summary that filters an earlier incarnation's allocs), evals (a
    successful one cancels the job's blocked evals), allocs (an update
    keeps the client's status unless it marks the alloc lost) and slabs
    (read back as allocations), read through every reader the scheduler
    calls."""
    from nomad_tpu.state import StateStore as JStore
    from nomad_tpu_torch.state import StateStore

    stores = (JStore(), StateStore())
    nodes = [jmock.node() for _ in range(3)]
    job = jmock.job()
    a1, a2 = jmock.alloc(), jmock.alloc()
    for a, n in ((a1, nodes[0]), (a2, nodes[1])):
        a.node_id, a.job_id, a.job = n.id, job.id, job
        a.client_status = js.ALLOC_CLIENT_STATUS_RUNNING
    blocked = js.Evaluation(id="b-1", job_id=job.id,
                            status=js.EVAL_STATUS_BLOCKED)
    done = js.Evaluation(id="c-1", job_id=job.id,
                         status=js.EVAL_STATUS_COMPLETE)
    slab_ids = [f"00000000-0000-0000-0000-{i:012x}" for i in range(4)]

    def writes(st, conv_node, conv_job, conv_alloc, conv_eval, S):
        for i, n in enumerate(nodes):
            st.upsert_node(i + 1, conv_node(n))
        st.update_node_status(4, nodes[2].id, S.NODE_STATUS_DOWN)
        st.update_node_drain(5, nodes[1].id, True)
        st.upsert_job(6, conv_job(job))
        st.upsert_job(7, conv_job(job))
        st.upsert_evals(8, [conv_eval(blocked)])
        st.upsert_allocs(9, [conv_alloc(a1), conv_alloc(a2)])
        lost = conv_alloc(a1)
        lost.client_status = S.ALLOC_CLIENT_STATUS_LOST
        lost.desired_status = S.ALLOC_DESIRED_STATUS_STOP
        upd = conv_alloc(a2)
        upd.client_status = S.ALLOC_CLIENT_STATUS_PENDING
        st.upsert_allocs(10, [lost, upd])
        proto = conv_alloc(a2)
        proto.id, proto.eval_id = "", "e-slab"
        proto.job = st.job_by_id(None, job.id)
        st.upsert_slabs(11, [S.AllocSlab(
            proto=proto, ids=list(slab_ids),
            names=[f"slab[{i}]" for i in range(4)],
            node_ids=[nodes[i % 2].id for i in range(4)],
            prev_ids=["", a1.id, "", ""])])
        st.upsert_evals(12, [conv_eval(done)])
        return st

    def reads(st):
        snap = st.snapshot()
        row = lambda a: (a.id, a.name, a.node_id, a.eval_id,  # noqa: E731
                         a.desired_status, a.client_status,
                         a.previous_allocation, a.create_index,
                         a.modify_index)
        return (
            [(n.id, n.status, n.drain, n.create_index, n.modify_index)
             for n in snap.nodes(None)],
            snap.node_by_id(None, nodes[1].id).drain,
            (lambda j: (j.version, j.status, j.create_index,
                        j.job_modify_index))(snap.job_by_id(None, job.id)),
            sorted((e.id, e.status, e.create_index, e.modify_index)
                   for e in (snap.eval_by_id(None, "b-1"),
                             snap.eval_by_id(None, "c-1"))),
            sorted(map(row, snap.allocs(None))),
            sorted(map(row, snap.allocs_by_job(None, job.id, False))),
            sorted(map(row, snap.allocs_by_job(None, job.id, True))),
            [sorted(map(row, snap.allocs_by_node(None, n.id)))
             for n in nodes],
            [sorted(map(row, snap.allocs_by_node_terminal(None, n.id, t)))
             for n in nodes for t in (False, True)],
            sorted(map(row, snap.allocs_by_eval(None, "e-slab"))),
            {k: snap.table_index(k) for k in ("nodes", "jobs", "evals",
                                              "allocs")},
            snap.latest_index(), snap.store_uid == st.store_uid)

    want = reads(writes(stores[0], lambda x: x.copy(), lambda x: x.copy(),
                        lambda x: x.copy(), lambda x: x.copy(), js))
    got = reads(writes(
        stores[1], lambda x: conv(x, convert.node_from_dict),
        lambda x: conv(x, convert.job_from_dict),
        lambda x: conv(x, convert.alloc_from_dict),
        lambda x: conv(x, convert.eval_from_dict), ps))
    assert got == want
