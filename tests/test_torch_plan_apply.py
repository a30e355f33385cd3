"""The port's plan applier against the JAX reference's.

The same plans go through ``nomad_tpu.server.plan_apply.PlanApplier``
(over its FSM, committing at the index the test hands it) and the port's
``nomad_tpu_torch.server.PlanApplier(device="cpu")`` over one world
built in both packages.  ``evaluate_plan``'s result and, after
``apply_plan``, every alloc, job summary, job status, eval and table
index of the two stores, and their usage-delta feeds, must be equal.
Both packages' columnar fit routes are off here (the reference's
``NOMAD_TPU_COLUMNAR=0``, the port's ``StateStore(columnar=False)``), so
the walk and the vectorized re-check are held;
``tests/test_torch_columnar.py`` holds the columnar route.

Also here: ``batch_allocs_fit`` (exactly) and ``aggregate_binpack_score``
(to 1e-5 relative) against the JAX functions, ``submit_plan`` and the
conflict retry through ``Harness.planner``, and the ``plan.apply`` fault
point.
"""
import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu import fault as jfault
from nomad_tpu import mock as jmock
from nomad_tpu.ops import kernels as jkernels
from nomad_tpu.server.fsm import FSM
from nomad_tpu.server.plan_apply import PlanApplier as JApplier
from nomad_tpu.server.plan_queue import PlanQueue
from nomad_tpu.state import StateStore as JStore
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert, fault
from nomad_tpu_torch.ops import kernels, resident
from nomad_tpu_torch.server import PlanApplier, plan_apply
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.structs import structs as ps

THRESHOLD = plan_apply.VECTORIZE_THRESHOLD


@pytest.fixture(autouse=True)
def walk_route(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_COLUMNAR", "0")
    resident.reset_counters()
    yield
    resident.reset_counters()


class IndexRaft:
    """The reference applier's log, cut to what ``apply_plan`` needs: the
    FSM apply at the index ``next_index()`` gives."""

    def __init__(self, state, next_index):
        self.fsm = FSM(state=state)
        self.next_index = next_index

    def apply(self, msg_type, payload):
        index = self.next_index()
        return self.fsm.apply(index, msg_type, payload), index


def conv(obj, fn):
    return fn(dataclasses.asdict(obj))


class World:
    """One cluster and one job in both packages' stores; every write goes
    to both at the same index."""

    def __init__(self, n_nodes, seed=1, networks=False, columnar=False,
                 **applier_kw):
        self.rng = random.Random(seed)
        self.js, self.ps = JStore(), StateStore(columnar=columnar)
        self.index = 0
        self.nodes = []
        for i in range(n_nodes):
            n = jmock.node()
            n.id = n.name = f"node-{i:03d}"
            n.resources.cpu = self.rng.choice([2000, 4000])
            n.resources.memory_mb = self.rng.choice([4096, 8192])
            if not networks:
                n.resources.networks = []
                n.reserved.networks = []
            n.compute_class()
            self.nodes.append(n)
            idx = self.next()
            self.js.upsert_node(idx, n)
            self.ps.upsert_node(idx, conv(n, convert.node_from_dict))
        job = jmock.job()
        job.id = job.name = "job-a"
        if not networks:
            for t in job.task_groups[0].tasks:
                t.resources.networks = []
        idx = self.next()
        self.js.upsert_job(idx, job)
        self.ps.upsert_job(idx, conv(job, convert.job_from_dict))
        self.jjob = self.js.job_by_id(None, job.id)
        self.pjob = self.ps.job_by_id(None, job.id)
        self.commit_index = 0
        self.japp = JApplier(PlanQueue(), IndexRaft(self.js,
                                                    self._commit_index))
        self.papp = PlanApplier(self.ps, device="cpu",
                                next_index=self._commit_index, **applier_kw)

    def next(self):
        self.index += 1
        return self.index

    def _commit_index(self):
        return self.commit_index

    # -- writes to both stores ---------------------------------------------

    def put_allocs(self, allocs):
        idx = self.next()
        self.js.upsert_allocs(idx, [a.copy() for a in allocs])
        self.ps.upsert_allocs(idx, [conv(a, convert.alloc_from_dict)
                                    for a in allocs])

    def node_status(self, node_id, status):
        idx = self.next()
        self.js.update_node_status(idx, node_id, status)
        self.ps.update_node_status(idx, node_id, status)

    def node_drain(self, node_id):
        idx = self.next()
        self.js.update_node_drain(idx, node_id, True)
        self.ps.update_node_drain(idx, node_id, True)

    # -- plans -------------------------------------------------------------

    def alloc(self, node_id, cpu=500, mem=256, ports=()):
        tg = self.jjob.task_groups[0]
        task = tg.tasks[0]
        res = js.Resources(cpu=cpu, memory_mb=mem)
        if ports:
            res.networks = [js.NetworkResource(
                device="eth0", ip="192.168.0.100", mbits=10,
                reserved_ports=[js.Port(f"p{p}", p) for p in ports])]
        return js.Allocation(
            id=f"alloc-{self.rng.getrandbits(64):016x}", eval_id="ev-0",
            name=f"{self.jjob.name}.{tg.name}[0]", node_id=node_id,
            job_id=self.jjob.id, job=self.jjob, task_group=tg.name,
            task_resources={task.name: res},
            shared_resources=js.Resources(disk_mb=150),
            desired_status=js.ALLOC_DESIRED_STATUS_RUN,
            client_status=js.ALLOC_CLIENT_STATUS_PENDING)

    def slab(self, node_ids, ev_id="ev-1", cpu=500, mem=256):
        tg = self.jjob.task_groups[0]
        proto = js.Allocation(
            eval_id=ev_id, job_id=self.jjob.id, job=self.jjob,
            task_group=tg.name,
            resources=js.Resources(cpu=cpu, memory_mb=mem, disk_mb=150),
            task_resources={tg.tasks[0].name: js.Resources(
                cpu=cpu, memory_mb=mem)},
            shared_resources=js.Resources(disk_mb=150),
            desired_status=js.ALLOC_DESIRED_STATUS_RUN,
            client_status=js.ALLOC_CLIENT_STATUS_PENDING)
        k = len(node_ids)
        return js.AllocSlab(
            proto=proto,
            ids=[f"slab-{ev_id}-{i:05d}" for i in range(k)],
            names=[f"{self.jjob.name}.{tg.name}[{i}]" for i in range(k)],
            node_ids=list(node_ids))

    def port_plan(self, jplan):
        """The reference plan in the port's structs, its job the port
        store's copy."""
        def allocs(d):
            return {n: [conv(a, convert.alloc_from_dict) for a in v]
                    for n, v in d.items()}
        slabs = [ps.AllocSlab(
            proto=conv(sl.proto, convert.alloc_from_dict),
            ids=list(sl.ids), names=list(sl.names),
            node_ids=list(sl.node_ids), prev_ids=list(sl.prev_ids))
            for sl in jplan.alloc_slabs]
        for sl in slabs:
            sl.proto.job = self.pjob
        plan = ps.Plan(eval_id=jplan.eval_id, priority=jplan.priority,
                       all_at_once=jplan.all_at_once, job=self.pjob,
                       node_update=allocs(jplan.node_update),
                       node_allocation=allocs(jplan.node_allocation),
                       alloc_slabs=slabs,
                       node_preemptions=allocs(jplan.node_preemptions))
        for v in plan.node_allocation.values():
            for a in v:
                a.job = self.pjob
        return plan

    def evaluate_and_apply(self, jplan, apply=True):
        """Both appliers on one plan: returns (reference result, port
        result), after asserting they agree and, with ``apply``, that the
        stores agree after the commit."""
        pplan = self.port_plan(jplan)
        jsnap, psnap = self.js.snapshot(), self.ps.snapshot()
        jres = self.japp.evaluate_plan(jsnap, jplan)
        pres = self.papp.evaluate_plan(psnap, pplan)
        assert result_rows(pres) == result_rows(jres)
        if apply and (jres.node_update or jres.node_allocation
                      or jres.alloc_slabs):
            self.commit_index = self.next()
            assert self.japp.apply_plan(jplan, jres, jsnap) == \
                self.commit_index
            assert self.papp.apply_plan(pplan, pres, psnap) == \
                self.commit_index
        assert_same_store(self.js, self.ps)
        return jres, pres


def _alloc_rows(d):
    return {n: sorted((a.id, a.desired_status, a.client_status)
                      for a in v) for n, v in d.items()}


def result_rows(r):
    return (_alloc_rows(r.node_update), _alloc_rows(r.node_allocation),
            _alloc_rows(r.node_preemptions),
            [(list(sl.ids), list(sl.names), list(sl.node_ids))
             for sl in r.alloc_slabs], r.refresh_index)


def _res(r):
    return None if r is None else (r.cpu, r.memory_mb, r.disk_mb, r.iops)


def _stored_alloc(a):
    return (a.id, a.name, a.node_id, a.job_id, a.task_group, a.eval_id,
            a.desired_status, a.desired_description, a.client_status,
            a.previous_allocation, a.create_index, a.modify_index,
            a.alloc_modify_index, _res(a.resources),
            _res(a.shared_resources),
            sorted((k, _res(v)) for k, v in a.task_resources.items()),
            None if a.job is None else (a.job.id, a.job.create_index),
            a.terminal_status())


def assert_same_store(jst, pst):
    assert sorted(map(_stored_alloc, pst.allocs(None))) == \
        sorted(map(_stored_alloc, jst.allocs(None)))
    for node in jst.nodes(None):
        assert sorted(a.id for a in pst.allocs_by_node(None, node.id)) == \
            sorted(a.id for a in jst.allocs_by_node(None, node.id))
    for job_id, want in jst.job_summary_table.items():
        got = pst.job_summary_table[job_id]
        assert {k: dataclasses.asdict(v) for k, v in got.summary.items()} \
            == {k: dataclasses.asdict(v) for k, v in want.summary.items()}
        assert (got.create_index, got.modify_index) == \
            (want.create_index, want.modify_index)
    assert {j.id: (j.status, j.modify_index)
            for j in pst.jobs_table.values()} == \
        {j.id: (j.status, j.modify_index) for j in jst.jobs_table.values()}
    assert sorted((e.job_id, e.status, e.triggered_by, e.snapshot_index,
                   e.create_index) for e in pst.evals_table.values()) == \
        sorted((e.job_id, e.status, e.triggered_by, e.snapshot_index,
                e.create_index) for e in jst.evals_table.values())
    for table in ("nodes", "jobs", "allocs", "evals", "job_summary"):
        assert pst.table_index(table) == jst.table_index(table), table
    assert pst.allocs_since(0) == jst.allocs_since(0)


def fill(w, node, cpu_left=0):
    """A live alloc on ``node`` that leaves ``cpu_left`` of its cpu."""
    a = w.alloc(node.id, cpu=node.resources.cpu - node.reserved.cpu
                - 150 - cpu_left, mem=64)
    w.put_allocs([a])
    return a


SIZES = (8, THRESHOLD - 1, THRESHOLD, 150)


@pytest.mark.parametrize("n", SIZES)
def test_slab_full_commit(n):
    w = World(n)
    plan = js.Plan(eval_id="ev-1", job=w.jjob)
    plan.append_slab(w.slab([nd.id for nd in w.nodes]))
    jres, pres = w.evaluate_and_apply(plan)
    assert not pres.refresh_index and len(pres.alloc_slabs) == 1
    route = "vectorized" if n >= THRESHOLD else "scalar"
    assert w.papp.stats[route] == 1
    if n >= THRESHOLD:
        assert w.papp.stats["fit_devices"] == {"cpu"}
    assert len(w.ps.allocs(None)) == n


@pytest.mark.parametrize("n", (8, 100))
def test_over_committed_node_partial_commit(n):
    w = World(n)
    fill(w, w.nodes[0], cpu_left=100)
    plan = js.Plan(eval_id="ev-1", job=w.jjob)
    plan.append_slab(w.slab([nd.id for nd in w.nodes]))
    jres, pres = w.evaluate_and_apply(plan)
    assert pres.refresh_index == max(w.ps.table_index("nodes"),
                                     w.index - 1)
    committed = {nid for sl in pres.alloc_slabs for nid in sl.node_ids}
    assert committed == {nd.id for nd in w.nodes[1:]}
    assert w.ps.allocs_by_node(None, w.nodes[0].id)[0].name != "ev-1"


@pytest.mark.parametrize("n", (8, 100))
def test_all_at_once_gang(n):
    w = World(n)
    fill(w, w.nodes[n // 2], cpu_left=0)
    plan = js.Plan(eval_id="ev-1", job=w.jjob, all_at_once=True)
    plan.append_slab(w.slab([nd.id for nd in w.nodes]))
    plan.append_alloc(w.alloc(w.nodes[1].id))
    jres, pres = w.evaluate_and_apply(plan)
    assert not pres.alloc_slabs and not pres.node_allocation
    assert pres.refresh_index


@pytest.mark.parametrize("kind", ("down", "drain"))
@pytest.mark.parametrize("n", (8, 100))
def test_down_or_draining_node(kind, n):
    w = World(n)
    if kind == "down":
        w.node_status(w.nodes[2].id, js.NODE_STATUS_DOWN)
    else:
        w.node_drain(w.nodes[2].id)
    plan = js.Plan(eval_id="ev-1", job=w.jjob)
    plan.append_slab(w.slab([nd.id for nd in w.nodes]))
    jres, pres = w.evaluate_and_apply(plan)
    committed = {nid for sl in pres.alloc_slabs for nid in sl.node_ids}
    assert w.nodes[2].id not in committed and len(committed) == n - 1


@pytest.mark.parametrize("n", (8, 100))
def test_stale_and_fresh_preemption(n):
    w = World(n)
    victims = [w.alloc(w.nodes[i].id) for i in (0, 1)]
    w.put_allocs(victims)
    stored = {a.id: w.js.alloc_by_id(None, a.id) for a in victims}
    plan = js.Plan(eval_id="ev-1", job=w.jjob)
    for a in stored.values():
        plan.append_preempted_alloc(a)
    plan.append_slab(w.slab([nd.id for nd in w.nodes]))
    # The victim on node 1 changes after the plan was made: stale.
    moved = victims[1].copy()
    moved.desired_description = "touched"
    w.put_allocs([moved])
    jres, pres = w.evaluate_and_apply(plan)
    assert w.nodes[0].id in pres.node_preemptions
    assert w.nodes[1].id not in pres.node_preemptions
    committed = {nid for sl in pres.alloc_slabs for nid in sl.node_ids}
    assert w.nodes[1].id not in committed and w.nodes[0].id in committed
    # The evicted job's follow-up eval committed with the plan.
    assert [e.triggered_by for e in w.ps.evals_table.values()] == \
        [ps.EVAL_TRIGGER_PREEMPTION]


@pytest.mark.parametrize("n", (8, 100))
def test_network_nodes_take_the_scalar_check(n):
    """Allocs that reserve ports keep the scalar allocs_fit on both
    routes; a reserved-port collision fails its node."""
    w = World(n, networks=True)
    w.put_allocs([w.alloc(w.nodes[0].id, ports=(8080,))])
    plan = js.Plan(eval_id="ev-1", job=w.jjob)
    for nd in w.nodes:
        plan.append_alloc(w.alloc(nd.id, ports=(8080,)))
    jres, pres = w.evaluate_and_apply(plan)
    assert w.nodes[0].id not in pres.node_allocation
    assert len(pres.node_allocation) == n - 1
    if n >= THRESHOLD:
        assert w.papp.stats["scalar_fallback"] == n


@pytest.mark.parametrize("n", (8, 100))
def test_inflight_overlay_entry(n):
    """A placement still in flight on a node counts against it (by its
    combined resources on the vectorized route, as in the reference)."""
    w = World(n)
    node = w.nodes[3]
    big = w.alloc(node.id, cpu=node.resources.cpu - node.reserved.cpu - 300,
                  mem=64)
    big.resources = js.Resources(cpu=big.task_resources["web"].cpu,
                                 memory_mb=64, disk_mb=150)
    hog = js.PlanResult(node_allocation={node.id: [big]})
    w.japp._overlay.add(1, hog)
    w.papp._overlay.add(1, ps.PlanResult(node_allocation={
        node.id: [conv(hog.node_allocation[node.id][0],
                       convert.alloc_from_dict)]}))
    plan = js.Plan(eval_id="ev-1", job=w.jjob)
    plan.append_slab(w.slab([nd.id for nd in w.nodes]))
    jres, pres = w.evaluate_and_apply(plan)
    committed = {nid for sl in pres.alloc_slabs for nid in sl.node_ids}
    assert node.id not in committed and len(committed) == n - 1


@pytest.mark.parametrize("n", (8, 100))
def test_stops_and_placements(n):
    """node_update stops free their usage in the re-check and commit
    terminal; explicit placements commit with the plan's job."""
    w = World(n)
    live = [w.alloc(nd.id, cpu=1000) for nd in w.nodes]
    w.put_allocs(live)
    plan = js.Plan(eval_id="ev-1", job=w.jjob)
    for a in live[: n // 2]:
        plan.append_update(w.js.alloc_by_id(None, a.id),
                           js.ALLOC_DESIRED_STATUS_STOP, "replaced")
    for nd in w.nodes:
        plan.append_alloc(w.alloc(nd.id, cpu=1200))
    jres, pres = w.evaluate_and_apply(plan)
    assert len(pres.node_update) == n // 2
    stopped = [a for a in w.ps.allocs(None)
               if a.desired_status == ps.ALLOC_DESIRED_STATUS_STOP]
    assert len(stopped) == n // 2


def test_apply_fault_point_error_commits_nothing():
    w = World(8)
    plan = js.Plan(eval_id="ev-1", job=w.jjob)
    plan.append_slab(w.slab([nd.id for nd in w.nodes]))
    pplan = w.port_plan(plan)
    cfg = {"seed": 1, "faults": [{"point": "plan.apply", "action": "error",
                                  "times": 1}]}
    jsnap, psnap = w.js.snapshot(), w.ps.snapshot()
    jres = w.japp.evaluate_plan(jsnap, plan)
    pres = w.papp.evaluate_plan(psnap, pplan)
    with jfault.scenario(cfg), pytest.raises(jfault.InjectedFault):
        w.japp.apply_plan(plan, jres, jsnap)
    with fault.scenario(cfg), pytest.raises(fault.InjectedFault) as err:
        w.papp.apply_plan(pplan, pres, psnap)
    assert str(err.value) == "injected error at plan.apply"
    assert w.ps.allocs(None) == [] and w.js.allocs(None) == []
    assert_same_store(w.js, w.ps)


@pytest.mark.parametrize("partial", (False, True))
def test_submit_plan_commits_like_the_serial_applier(partial):
    """submit_plan = _process_plan -> _commit: the commit index in
    alloc_index, on a partial commit refresh_index raised to it and a
    fresh snapshot returned."""
    w = World(12)
    if partial:
        fill(w, w.nodes[5], cpu_left=0)
    plan = js.Plan(eval_id="ev-1", job=w.jjob)
    plan.append_slab(w.slab([nd.id for nd in w.nodes]))
    pplan = w.port_plan(plan)
    jsnap = w.js.snapshot()
    jres = w.japp.evaluate_plan(jsnap, plan)
    w.commit_index = w.next()
    index = w.japp.apply_plan(plan, jres, jsnap)
    result, state = w.papp.submit_plan(pplan)
    assert result.alloc_index == index == w.commit_index
    assert_same_store(w.js, w.ps)
    if partial:
        assert result.refresh_index == max(jres.refresh_index, index)
        assert state is not None
        assert state.table_index("allocs") == index
        assert w.papp.stats["partial"] == 1
    else:
        assert result.refresh_index == 0 and state is None
    assert resident.LAST_PLAN_INDEX == index


def test_applier_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PlanApplier(StateStore())


# -- the re-check helpers against the JAX functions ---------------------------

@pytest.mark.parametrize("n", (1, 7, 64, 100, 1000))
def test_batch_allocs_fit_matches_jax(n):
    rng = np.random.default_rng(n)
    capacity = rng.integers(0, 5000, (n, 4)).astype(np.int32)
    used = (capacity + rng.integers(-300, 40, (n, 4))).astype(np.int32)
    # The reference pads the node axis to a power of two and slices.
    padded = 1 << (n - 1).bit_length()
    pad = np.zeros((padded - n, 4), dtype=np.int32)
    jfit, jdim = jkernels.batch_allocs_fit(
        jnp.asarray(np.concatenate([capacity, pad])),
        jnp.asarray(np.concatenate([used, pad])))
    fit, dim = kernels.batch_allocs_fit(torch.from_numpy(capacity),
                                        torch.from_numpy(used))
    np.testing.assert_array_equal(fit.numpy(), np.asarray(jfit)[:n])
    np.testing.assert_array_equal(dim.numpy(), np.asarray(jdim)[:n])
    assert fit.dtype == torch.bool and dim.dtype == torch.int32
    # Unpadded, the reference agrees too.
    jfit2, jdim2 = jkernels.batch_allocs_fit(jnp.asarray(capacity),
                                             jnp.asarray(used))
    np.testing.assert_array_equal(fit.numpy(), np.asarray(jfit2))
    np.testing.assert_array_equal(dim.numpy(), np.asarray(jdim2))


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_aggregate_binpack_score_matches_jax(seed):
    rng = np.random.default_rng(seed)
    u, n = 6, 40
    placements = (rng.random((u, n)) < 0.2).astype(np.int32)
    used0 = rng.integers(0, 1500, (n, 4)).astype(np.int32)
    ask = rng.integers(10, 300, (u, 4)).astype(np.int32)
    denom = rng.integers(2000, 9000, (n, 2)).astype(np.float32)
    denom[3] = 0.0
    want = float(jkernels.aggregate_binpack_score(
        jnp.asarray(placements), jnp.asarray(used0), jnp.asarray(denom),
        jnp.asarray(ask)))
    got = float(kernels.aggregate_binpack_score(
        torch.from_numpy(placements), torch.from_numpy(used0),
        torch.from_numpy(denom), torch.from_numpy(ask)))
    assert got == pytest.approx(want, rel=1e-5)
