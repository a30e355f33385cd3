"""Device preemption in the port against the JAX reference.

- ``ops/preempt.py``: ``encode_alloc_tensors`` and the plain
  ``eviction_sets_reference`` against the reference's encoding and its
  jitted ``eviction_sets`` (JAX on the CPU) on seeded random clusters and
  on edge rows: masks, feasibility and eviction counts exact, scores
  within 1e-5; the kernel invariant and the oracle agreement of
  ``tests/test_preempt.py``; the ``--selfcheck`` drill.
- ``TorchBatchScheduler(preemption_enabled=True)`` against the
  reference's ``TPUBatchScheduler`` on the scenarios of
  ``tests/test_preempt.py`` (ids alike in both packages, as in
  ``tests/test_torch_sched.py``): the same plans with their
  ``node_preemptions``, created evals and preempt counters; the same
  through each package's plan applier; a 4-shard CPU mesh against the
  single device; the CPU oracle with preemption on; and the resident
  mirror across a preempting batch and a follow-up.

The reference gets a breaker of its own wherever it builds a scheduler.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eviction_inputs import edge_inputs, random_inputs
from nomad_tpu import mock as jmock
from nomad_tpu.ops import breaker as jbreaker
from nomad_tpu.ops import preempt as jpreempt
from nomad_tpu.ops.batch_sched import TPUBatchScheduler
from nomad_tpu.ops.breaker import KernelCircuitBreaker as JBreaker
from nomad_tpu.scheduler import preempt as joracle
from nomad_tpu.scheduler.generic import GenericScheduler as JGeneric
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert
from nomad_tpu_torch.ops import breaker, resident
from nomad_tpu_torch.ops import preempt as ppreempt
from nomad_tpu_torch.ops.__main__ import main as ops_main
from nomad_tpu_torch.ops.batch_sched import TorchBatchScheduler
from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
from nomad_tpu_torch.parallel import make_node_mesh
from nomad_tpu_torch.scheduler import preempt as poracle
from nomad_tpu_torch.scheduler.generic import GenericScheduler
from nomad_tpu_torch.scheduler.testing import Harness
from nomad_tpu_torch.server import PlanApplier
from nomad_tpu_torch.structs import structs as ps

from test_torch_plan_apply import assert_same_store
from test_torch_resident import JApplierPlanner
from test_torch_sched import Twin, assert_same_world, conv

SCORE_ATOL = 1e-5
OUTPUTS = ("mask", "feasible", "n_evict", "score")


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    """The port's process-wide breaker and mirror fresh for every test,
    and the reference's columnar route off (the port has none)."""
    monkeypatch.setenv("NOMAD_TPU_COLUMNAR", "0")
    breaker.reset_for_tests()
    resident.reset_counters()
    yield
    breaker.reset_for_tests()
    resident.reset_counters()


# -- ops/preempt.py against the reference ------------------------------------

def both_eviction_sets(arrays):
    """The port's plain version and the reference's jitted program on the
    same numpy inputs, as numpy arrays."""
    got = [t.numpy() for t in ppreempt.eviction_sets(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays))]
    want = [np.asarray(x) for x in jpreempt.eviction_sets(
        *(jnp.asarray(a) for a in arrays))]
    return got, want


def assert_same_sets(got, want):
    for name, g, w in zip(OUTPUTS, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name == "score":
            err = float(np.abs(g - w).max()) if g.size else 0.0
            print(f"score max |port - reference| = {err:.3g}")
            assert err <= SCORE_ATOL
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("seed", range(5))
def test_encode_alloc_tensors_matches_reference(seed):
    nodes, abn, _, _ = ppreempt.random_cluster(40, 4, seed)
    jnodes, jabn, _, _ = jpreempt.random_cluster(40, 4, seed)
    ids = [n.id for n in nodes]
    assert ids == [n.id for n in jnodes]
    prio, sizes, sorted_allocs = ppreempt.encode_alloc_tensors(
        ids, abn, poracle.alloc_priority, n_pad=48)
    jprio, jsizes, jsorted = jpreempt.encode_alloc_tensors(
        ids, jabn, joracle.alloc_priority, n_pad=48)
    np.testing.assert_array_equal(prio, jprio)
    np.testing.assert_array_equal(sizes, jsizes)
    assert prio.dtype == jprio.dtype and sizes.dtype == jsizes.dtype
    assert [[a.id for a in c] for c in sorted_allocs] == \
        [[a.id for a in c] for c in jsorted]
    assert poracle.PRIORITY_SENTINEL == joracle.PRIORITY_SENTINEL


@pytest.mark.parametrize("seed", range(5))
def test_eviction_sets_match_reference(seed):
    nodes, abn, asks, prios = ppreempt.random_cluster(48, 16, seed)
    arrays, _ = ppreempt.cluster_inputs(nodes, abn, asks, prios)
    got, want = both_eviction_sets(arrays)
    assert got[1].any(), "the seeded cluster has preempting pairs"
    assert_same_sets(got, want)


def test_eviction_sets_match_reference_on_edge_rows():
    got, want = both_eviction_sets(edge_inputs())
    assert_same_sets(got, want)
    mask, feasible, n_evict, _ = got
    assert not feasible[:, 0].any()       # no candidate
    assert not feasible[:, 1].any()       # fits without eviction
    assert not feasible[:, 2].any()       # no eviction is enough
    assert feasible[0, 7] and n_evict[0, 7] < 3    # the reverse trim
    assert not feasible[:, 9].any()       # padding
    np.testing.assert_array_equal(mask.sum(axis=-1), n_evict)


@pytest.mark.parametrize("a", [2, 3, 16, 64, 128])
def test_eviction_sets_match_reference_at_wide_alloc_axes(a, monkeypatch):
    """The plain version against the reference's jitted program past the
    main path's A = 8 (3 and 128 are no power of two), on
    ``random_inputs``' near-full nodes: the semantics the card's kernel
    is held to at every width it is built for.  The reference gets its
    own breaker."""
    own = JBreaker()
    monkeypatch.setattr(jbreaker, "BREAKER", own)
    got, want = both_eviction_sets(random_inputs(96, 9, a, seed=a))
    assert got[1].any(), "the inputs have preempting pairs"
    assert (got[2] > 1).any(), "some trims keep more than one candidate"
    assert_same_sets(got, want)
    assert own.state == "closed"


def test_kernel_invariant_no_high_priority_eviction():
    """Masked allocs always have a strictly lower priority than the spec,
    and no mask lies outside a feasible pair (test_preempt.py:291)."""
    nodes, abn, asks, prios = ppreempt.random_cluster(24, 12, seed=7)
    arrays, _ = ppreempt.cluster_inputs(nodes, abn, asks, prios)
    prio_np, jp = arrays[3], arrays[6]
    mask, feasible, n_evict, _ = (t.numpy() for t in ppreempt.eviction_sets(
        *(torch.from_numpy(a) for a in arrays)))
    for u in range(len(asks)):
        sel = mask[u]
        assert not np.any(sel & (prio_np >= jp[u])), u
        np.testing.assert_array_equal(sel.sum(axis=1), n_evict[u])
        assert not np.any(n_evict[u][~feasible[u]])


def test_agreement_with_the_oracle():
    nodes, abn, asks, prios = ppreempt.random_cluster(32, 16, seed=3)
    checked, n_mismatch, mismatches = ppreempt.agreement_check(
        nodes, abn, asks, prios, device="cpu")
    assert checked == 32 * 16
    assert n_mismatch == 0, mismatches


@pytest.mark.slow
def test_fuzz_eviction_sets_match_oracle():
    for seed in (1, 2, 3, 4):
        nodes, abn, asks, prios = ppreempt.random_cluster(48, 24, seed=seed)
        checked, n_mismatch, mismatches = ppreempt.agreement_check(
            nodes, abn, asks, prios, device="cpu")
        assert checked == 48 * 24
        assert n_mismatch == 0, mismatches


def test_selfcheck_drill_on_the_cpu(capsys):
    assert ops_main(["--selfcheck", "--device", "cpu", "--nodes", "16",
                     "--specs", "8", "--seed", "3"]) == 0
    assert "preempt selfcheck: OK" in capsys.readouterr().out
    assert ops_main([]) == 2


def test_selfcheck_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ppreempt.selfcheck(n_nodes=4, n_specs=2)


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    arrays = [torch.from_numpy(a) for a in edge_inputs()]
    before = ppreempt.LAUNCHES
    ppreempt.eviction_sets(*arrays)
    assert ppreempt.LAUNCHES == before
    with pytest.raises(ValueError, match="unsupported device"):
        ppreempt.eviction_sets(*(a.to("meta") for a in arrays))


# -- the batch scheduler against the reference's -----------------------------

def _victims(p):
    return {n: [(a.id, a.desired_status, a.desired_description,
                 a.modify_index) for a in v]
            for n, v in p.node_preemptions.items()}


def assert_same_preemptions(jh, ph):
    assert [_victims(p) for p in ph.plans] == [_victims(p) for p in jh.plans]


COUNTERS = ("preempt_placed", "preempt_evicted", "preempt_checked",
            "preempt_agree")


def run_twin(t, evals, preemption=True, port_kw=None, seed=None):
    """One batch through the reference's ``TPUBatchScheduler`` and the
    port's ``TorchBatchScheduler`` (CPU), ids alike; the worlds, their
    victims and their preempt counters must be equal."""
    seed = t.seed if seed is None else seed
    t.mp.setenv("NOMAD_TPU_RNG_SEED", str(seed))
    with t.mp.context() as m:
        m.setattr(js, "generate_uuid", t.jids.one)
        m.setattr(js, "generate_uuids", t.jids.many)
        jst = TPUBatchScheduler(t.jh.logger, t.jh.snapshot(), t.jh,
                                breaker=JBreaker(),
                                preemption_enabled=preemption
                                ).schedule_batch(evals)
    kw = port_kw or {"device": "cpu"}
    with t.mp.context() as m:
        m.setattr(ps, "generate_uuid", t.pids.one)
        m.setattr(ps, "generate_uuids", t.pids.many)
        pst = TorchBatchScheduler(
            t.ph.logger, t.ph.snapshot(), t.ph, rng_seed=seed,
            breaker=KernelCircuitBreaker(), preemption_enabled=preemption,
            **kw).schedule_batch([conv(e, convert.eval_from_dict)
                                  for e in evals])
    assert jst.oracle_routed == pst.oracle_routed == 0
    assert_same_world(t.jh, t.ph)
    assert_same_preemptions(t.jh, t.ph)
    assert {k: getattr(pst, k) for k in COUNTERS} == \
        {k: getattr(jst, k) for k in COUNTERS}
    return jst, pst


def strip(n):
    n.resources.networks = []
    n.reserved.networks = []
    n.compute_class()
    return n


def fill_twin(t, n_nodes=3, per_node=3, filler_prio=20, alloc_cpu=1200,
              alloc_mem=2500):
    """tests/test_preempt.py's fill_cluster in both packages: a filler job
    and ``per_node`` explicit allocs of it on every node."""
    filler = jmock.job()
    filler.id = filler.name = "filler"
    filler.priority = filler_prio
    filler.task_groups[0].count = 0
    t.put_job(filler)
    # Each store's own job object, as an alloc read back carries it.
    jfiller = t.jh.state.job_by_id(None, filler.id)
    pfiller = t.ph.state.job_by_id(None, filler.id)
    for i in range(n_nodes):
        n = jmock.node()
        n.id = n.name = f"node-{i:03d}"
        t.add_node(strip(n))
        for k in range(per_node):
            a = js.Allocation(
                id=f"filler-{i:03d}-{k}", job_id=filler.id, job=jfiller,
                node_id=n.id, task_group="web", name=f"f.web[{k}]",
                resources=js.Resources(cpu=alloc_cpu, memory_mb=alloc_mem))
            t.jh.state.upsert_allocs(t.jh.next_index(), [a])
            pa = conv(a, convert.alloc_from_dict)
            pa.job = pfiller
            t.ph.state.upsert_allocs(t.ph.next_index(), [pa])
    return filler


def high_prio_job(count=2, prio=70, cpu=1000, mem=2000, job_id=None):
    job = jmock.job()
    if job_id is not None:
        job.id = job.name = job_id
    job.priority = prio
    job.task_groups[0].count = count
    for tk in job.task_groups[0].tasks:
        tk.resources = js.Resources(cpu=cpu, memory_mb=mem)
    return job


def preemption_evals(h):
    """The evicted jobs' follow-up evals in the store (written by the
    harness or by the plan applier)."""
    return [e for e in h.state.evals_table.values()
            if e.triggered_by == js.EVAL_TRIGGER_PREEMPTION]


def scenario_preempt_pass(t):
    filler = fill_twin(t, n_nodes=4)
    job = high_prio_job(count=3)
    t.put_job(job)
    jst, pst = run_twin(t, [t.eval_for(job)])
    assert pst.preempt_placed == pst.preempt_checked == \
        pst.preempt_agree == 3
    evicted = [a for p in t.ph.plans for v in p.node_preemptions.values()
               for a in v]
    assert pst.preempt_evicted == len(evicted) > 0
    assert len(t.ph.state.allocs_by_job(None, job.id, True)) == 3
    pe = preemption_evals(t.ph)
    assert len(pe) == 1 and pe[0].job_id == filler.id


def scenario_slab_backed(t):
    for _ in range(3):
        t.add_node(strip(jmock.node()))
    filler = jmock.job()
    filler.priority = 20
    filler.task_groups[0].count = 9
    for tk in filler.task_groups[0].tasks:
        tk.resources = js.Resources(cpu=1200, memory_mb=2500)
    t.put_job(filler)
    # Fill through the batch schedulers, so both stores hold slabs; no
    # read between the fill and the preempting batch.
    run_twin(t, [t.eval_for(filler)], preemption=False)
    job = high_prio_job(count=2)
    t.put_job(job)
    _, pst = run_twin(t, [t.eval_for(job)], seed=t.seed + 1)
    assert pst.preempt_placed == pst.preempt_agree == 2
    evicted = [a for v in t.ph.plans[-1].node_preemptions.values()
               for a in v]
    assert evicted and all(a.id for a in evicted)
    in_store = [a for a in t.ph.state.allocs_by_job(None, filler.id, True)
                if a.desired_status == ps.ALLOC_DESIRED_STATUS_EVICT]
    assert {a.id for a in in_store} == {a.id for a in evicted}


def scenario_disabled_is_inert(t):
    fill_twin(t, n_nodes=2)
    job = high_prio_job(count=1)
    t.put_job(job)
    _, pst = run_twin(t, [t.eval_for(job)], preemption=False)
    assert pst.preempt_placed == pst.preempt_checked == 0
    assert not t.ph.state.allocs_by_job(None, job.id, True)


def scenario_mixed(t):
    """Asks that place in the main pass, asks that place only by
    eviction and asks that do not place at all, over two priorities."""
    fill_twin(t, n_nodes=6, per_node=2, filler_prio=20, alloc_cpu=1500,
              alloc_mem=3000)
    jobs = [high_prio_job(count=4, prio=70, cpu=600, mem=1000),
            high_prio_job(count=5, prio=60, cpu=1200, mem=1500),
            high_prio_job(count=6, prio=15, cpu=1000, mem=1000)]
    for j in jobs:
        t.put_job(j)
    _, pst = run_twin(t, [t.eval_for(j) for j in jobs])
    assert pst.preempt_placed > 0


SCENARIOS = {"preempt_pass": scenario_preempt_pass,
             "slab_backed": scenario_slab_backed,
             "disabled_is_inert": scenario_disabled_is_inert,
             "mixed": scenario_mixed}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_twin_preempting_batch(name, monkeypatch):
    SCENARIOS[name](Twin(monkeypatch, 7000 + sorted(SCENARIOS).index(name)))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_twin_preempting_batch_through_the_appliers(name, monkeypatch):
    """The same scenarios with each package's plan applier as the
    harness planner: evict and place commit together, the evicted jobs'
    follow-up evals land in the store, and the stores stay equal."""
    t = Twin(monkeypatch, 7100 + sorted(SCENARIOS).index(name))
    t.jh.planner = JApplierPlanner(t.jh)
    t.ph.planner = PlanApplier(t.ph.state, device="cpu",
                               next_index=t.ph.next_index)
    SCENARIOS[name](t)
    assert_same_store(t.jh.state, t.ph.state)


def test_mesh_preemption_equals_single_device(monkeypatch):
    """The same preempting batch on a 4-shard CPU mesh and on one device:
    identical plans, victims and counters."""
    out = {}
    for label, kw in (("single", {"device": "cpu"}),
                      ("mesh", {"mesh": make_node_mesh(["cpu"] * 4)})):
        with monkeypatch.context() as m:
            t = Twin(m, 7200)
            fill_twin(t, n_nodes=6, per_node=2, alloc_cpu=1500,
                      alloc_mem=3000)
            jobs = [high_prio_job(count=4, prio=70, cpu=600, mem=1000,
                                  job_id="hi-a"),
                    high_prio_job(count=5, prio=60, cpu=1200, mem=1500,
                                  job_id="hi-b")]
            for j in jobs:
                t.put_job(j)
            _, pst = run_twin(t, [t.eval_for(j) for j in jobs],
                              port_kw=kw)
            assert pst.mesh_shards == (4 if label == "mesh" else 0)
            out[label] = ([(p.eval_id, sorted(
                (n, sorted(a.id for a in v))
                for n, v in p.node_allocation.items()), _victims(p))
                for p in t.ph.plans],
                {k: getattr(pst, k) for k in COUNTERS})
    assert out["mesh"] == out["single"]
    assert out["single"][1]["preempt_placed"] > 0


@pytest.mark.parametrize("case", ["preempts", "disabled_blocks"])
def test_cpu_oracle_with_preemption_matches_reference(case, monkeypatch):
    """The port's GenericScheduler against the reference's with
    preemption on (test_preempt.py:159, :187)."""
    enabled = case == "preempts"
    t = Twin(monkeypatch, 7300 + enabled)
    filler = fill_twin(t)
    job = high_prio_job()
    t.put_job(job)
    ev = t.eval_for(job)
    with t.mp.context() as m:
        m.setattr(js, "generate_uuid", t.jids.one)
        m.setattr(js, "generate_uuids", t.jids.many)
        JGeneric(t.jh.logger, t.jh.snapshot(), t.jh, False,
                 rng=random.Random(5), preemption_enabled=enabled).process(ev)
    with t.mp.context() as m:
        m.setattr(ps, "generate_uuid", t.pids.one)
        m.setattr(ps, "generate_uuids", t.pids.many)
        GenericScheduler(t.ph.logger, t.ph.snapshot(), t.ph, False,
                         rng=random.Random(5), preemption_enabled=enabled
                         ).process(conv(ev, convert.eval_from_dict))
    assert_same_world(t.jh, t.ph)
    assert_same_preemptions(t.jh, t.ph)
    if enabled:
        evicted = [a for p in t.ph.plans
                   for v in p.node_preemptions.values() for a in v]
        assert evicted
        pe = preemption_evals(t.ph)
        assert len(pe) == 1 and pe[0].job_id == filler.id
    else:
        assert t.ph.plans == []


def test_preemption_feeds_the_breaker(monkeypatch):
    """Every kernel-vs-oracle comparison is one check in the breaker's
    window, beside the batch's own clean check."""
    t = Twin(monkeypatch, 7400)
    fill_twin(t, n_nodes=4)
    job = high_prio_job(count=3)
    t.put_job(job)
    brk = KernelCircuitBreaker()
    st = TorchBatchScheduler(
        t.ph.logger, t.ph.snapshot(), t.ph, device="cpu", rng_seed=1,
        breaker=brk, preemption_enabled=True).schedule_batch(
            [conv(t.eval_for(job), convert.eval_from_dict)])
    assert st.preempt_checked == st.preempt_agree == 3
    assert len(brk._checks) == 1 + 3 and all(brk._checks)


def test_mirror_across_a_preempting_batch_and_a_follow_up():
    """The evictions reach the resident mirror through the store's delta
    feed: a preempting batch, then a follow-up batch, with the guard on
    every batch, show no mismatch and equal a full walk."""
    from nomad_tpu_torch import mock

    h = Harness()
    h.planner = PlanApplier(h.state, device="cpu", next_index=h.next_index)
    filler = mock.job()
    filler.priority = 20
    filler.task_groups[0].count = 0
    h.state.upsert_job(h.next_index(), filler)
    for i in range(8):
        n = mock.node()
        n.resources.networks = []
        n.reserved.networks = []
        h.state.upsert_node(h.next_index(), n)
        h.state.upsert_allocs(h.next_index(), [ps.Allocation(
            id=f"f-{i}-{k}", job_id=filler.id, job=filler, node_id=n.id,
            task_group="web", name=f"f.web[{k}]",
            resources=ps.Resources(cpu=1200, memory_mb=2500))
            for k in range(3)])

    def batch(count, prio, cpu, seed):
        job = mock.job()
        job.priority = prio
        job.task_groups[0].count = count
        for tk in job.task_groups[0].tasks:
            tk.resources = ps.Resources(cpu=cpu, memory_mb=512)
        h.state.upsert_job(h.next_index(), job)
        ev = ps.Evaluation(id=f"ev-{seed}", priority=prio, type=job.type,
                           triggered_by=ps.EVAL_TRIGGER_JOB_REGISTER,
                           job_id=job.id, status=ps.EVAL_STATUS_PENDING)
        return TorchBatchScheduler(
            h.logger, h.snapshot(), h, device="cpu", rng_seed=seed,
            breaker=KernelCircuitBreaker(), preemption_enabled=True,
            guard_every=1).schedule_batch([ev])

    first = batch(5, 70, 1000, 1)
    assert first.preempt_placed == 5 and first.preempt_evicted > 0
    second = batch(4, 50, 300, 2)
    assert second.resident_hits == 1 and second.delta_rows > 0
    assert resident.GUARD_RUNS >= 1 and resident.GUARD_MISMATCHES == 0
    evicted = [a for a in h.state.allocs(None)
               if a.desired_status == ps.ALLOC_DESIRED_STATUS_EVICT]
    assert len(evicted) == first.preempt_evicted
