"""The port's whole batch-placement slice against the JAX reference.

The reference ``TPUBatchScheduler`` runs in a scheduler ``Harness`` with
a pinned ``NOMAD_TPU_RNG_SEED``; the port's ``schedule_batch`` runs on
the CPU over the same nodes (converted, in ``state.nodes(None)`` order),
the same jobs and the same live allocations.  Placements by (job, task
group) must be identical and the AllocMetric binpack scores equal within
1e-5 (both sides compute float32 ScoreFit; the bound leaves room for a
1-ulp difference in 10^x, measured at 0 here).
"""
import dataclasses
import random

import jax  # noqa: F401  (the reference computes on the CPU backend)
import numpy as np
import pytest

from nomad_tpu import mock as jmock
from nomad_tpu.ops import batch_sched as jbatch
from nomad_tpu.ops import kernels as jkernels
from nomad_tpu.ops import xfer as jxfer
from nomad_tpu.ops.batch_sched import TPUBatchScheduler
from nomad_tpu.ops.breaker import KernelCircuitBreaker
from nomad_tpu.scheduler import Harness
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert
from nomad_tpu_torch.ops import batch_sched, kernels, xfer

SCORE_ATOL = 1e-5


def make_node(rng):
    node = jmock.node()
    node.resources.networks = []
    node.reserved.networks = []
    node.resources.cpu = rng.choice([2000, 4000, 8000])
    node.resources.memory_mb = rng.choice([4096, 8192, 16384])
    node.compute_class()
    return node


def make_job(count, rng, constrained=False):
    job = jmock.job()
    job.priority = rng.choice([30, 50, 70])
    job.task_groups[0].count = count
    for t in job.task_groups[0].tasks:
        t.resources.networks = []
        t.resources.cpu = rng.choice([100, 250, 500])
        t.resources.memory_mb = rng.choice([64, 256, 512])
    if constrained:
        job.task_groups[0].constraints = [
            js.Constraint("", "", js.CONSTRAINT_DISTINCT_HOSTS)]
    return job


def reg_eval(job):
    return js.Evaluation(
        id=js.generate_uuid(), priority=job.priority, type=job.type,
        triggered_by=js.EVAL_TRIGGER_JOB_REGISTER, job_id=job.id,
        status=js.EVAL_STATUS_PENDING)


def run_reference(h, jobs, seed, monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_RNG_SEED", str(seed))
    for j in jobs:
        if h.state.job_by_id(None, j.id) is None:
            h.state.upsert_job(h.next_index(), j)
    # Its own breaker: the process-wide one may have been tripped by
    # another test in this process, which would route the reference
    # through its CPU oracle.
    sched = TPUBatchScheduler(h.logger, h.snapshot(), h,
                              breaker=KernelCircuitBreaker())
    stats = sched.schedule_batch([reg_eval(j) for j in jobs])
    assert stats.oracle_routed == 0


def reference_outcome(h, jobs, before=()):
    """(job, tg) → (sorted node ids, AllocMetric scores) of the live
    allocs not in ``before`` (ids of allocs that existed earlier)."""
    before = set(before)
    nodes, scores = {}, {}
    for job in jobs:
        for a in h.state.allocs_by_job(None, job.id, True):
            if a.terminal_status() or a.id in before:
                continue
            key = (job.id, a.task_group)
            nodes.setdefault(key, []).append(a.node_id)
            scores[key] = a.metrics.scores
    return {k: sorted(v) for k, v in nodes.items()}, scores


def run_port(h, jobs, seed, live):
    nodes = [convert.node_from_dict(dataclasses.asdict(n))
             for n in h.state.nodes(None)]
    pjobs = [convert.job_from_dict(dataclasses.asdict(j)) for j in jobs]
    return batch_sched.schedule_batch(nodes, pjobs, live_allocs=live,
                                      rng_seed=seed, device="cpu")


def live_allocs(h):
    return [convert.alloc_from_dict(dataclasses.asdict(a))
            for a in h.state.allocs(None) if not a.terminal_status()]


def assert_same(res, h, jobs, before=()):
    want_nodes, want_scores = reference_outcome(h, jobs, before)
    got_nodes = {k: sorted(v.node_ids)
                 for k, v in res.placements.items() if v.node_ids}
    assert got_nodes == want_nodes
    for key, sp in res.placements.items():
        if not sp.node_ids:
            continue
        want = {k: v for k, v in want_scores[key].items()}
        assert set(sp.metric_scores) == set(want)
        for k, v in want.items():
            assert abs(sp.metric_scores[k] - v) <= SCORE_ATOL, k


def build(seed, n_nodes, n_jobs, max_count, constrained=False):
    rng = random.Random(seed)
    h = Harness()
    for _ in range(n_nodes):
        h.state.upsert_node(h.next_index(), make_node(rng))
    jobs = [make_job(rng.randint(1, max_count), rng,
                     constrained=constrained and i % 2 == 0)
            for i in range(n_jobs)]
    return h, rng, jobs


@pytest.mark.parametrize("seed", [3, 17, 29, 41])
def test_batch_then_follow_up_matches_reference(seed, monkeypatch):
    """Two batches: the second runs against the first's placements,
    passed to the port as live allocs (usage and collisions)."""
    h, rng, jobs = build(seed, n_nodes=40, n_jobs=5, max_count=30)
    live = live_allocs(h)
    res = run_port(h, jobs, seed, live)
    run_reference(h, jobs, seed, monkeypatch)
    assert_same(res, h, jobs)

    more = [make_job(rng.randint(1, 20), rng) for _ in range(3)]
    live = live_allocs(h)
    res2 = run_port(h, more, seed + 1, live)
    run_reference(h, more, seed + 1, monkeypatch)
    assert_same(res2, h, more)


@pytest.mark.parametrize("seed", [5, 11])
def test_saturated_cluster_with_distinct_hosts(seed, monkeypatch):
    """More asks than capacity (unplaced, early exit) and distinct_hosts
    specs: the unplaced counts and the rounds agree too."""
    h, rng, jobs = build(seed, n_nodes=12, n_jobs=6, max_count=25,
                         constrained=True)
    res = run_port(h, jobs, seed, live_allocs(h))
    run_reference(h, jobs, seed, monkeypatch)
    assert_same(res, h, jobs)
    want_nodes, _ = reference_outcome(h, jobs)
    for job in jobs:
        key = (job.id, "web")
        placed = len(want_nodes.get(key, []))
        assert res.placements[key].unplaced == \
            job.task_groups[0].count - placed
    assert any(sp.unplaced for sp in res.placements.values())


def test_re_evaluation_counts_existing_allocs(monkeypatch):
    """Jobs evaluated again after new nodes join: only the missing
    allocations are placed, and the existing ones count as collisions."""
    h, rng, jobs = build(23, n_nodes=3, n_jobs=4, max_count=40)
    run_reference(h, jobs, 23, monkeypatch)
    for _ in range(6):
        h.state.upsert_node(h.next_index(), make_node(rng))
    live = live_allocs(h)
    first = [a.id for a in live]
    res = run_port(h, jobs, 24, live)
    run_reference(h, jobs, 24, monkeypatch)
    assert res.placements, "the first batch left nothing unplaced"
    assert_same(res, h, jobs, before=first)
    assert any(sp.collisions.any() for sp in res.placements.values())


def test_fused_buffer_matches_reference(monkeypatch):
    """The port's fused_pass on the reference's own upload buffers
    returns the same result buffer: unplaced, feas_count, scalars and
    the COO rows, cols and counts exactly; score bits within 1e-5.  With
    the reference's default NOMAD_TPU_QUANT the resource rows ship
    quantized, and the port's fused pass dequantizes them; with it off
    they ship as int32."""
    monkeypatch.setenv("NOMAD_TPU_RESIDENT", "0")   # sparse-delta uploads
    captured = {}
    orig = jkernels.fused_pass

    def spy(static_buf, dyn_buf, used_dev=None, **kw):
        out = orig(static_buf, dyn_buf, used_dev, **kw)
        captured.update(static=np.asarray(static_buf),
                        dyn=np.asarray(dyn_buf), kw=kw,
                        buf=np.asarray(out[0]), meta=out[3])
        return out

    monkeypatch.setattr(jbatch.kernels, "fused_pass", spy)
    for quant in ("1", "0"):
        monkeypatch.setenv("NOMAD_TPU_QUANT", quant)
        h, rng, jobs = build(31, n_nodes=30, n_jobs=4, max_count=30)
        run_reference(h, jobs, 31, monkeypatch)
        more = [make_job(rng.randint(5, 25), rng) for _ in range(3)]
        run_reference(h, more, 32, monkeypatch)   # live usage and jc rows

        kw = captured["kw"]
        static = jxfer.unpack_host(captured["static"], kw["meta_s"])
        dyn = jxfer.unpack_host(captured["dyn"], kw["meta_d"])
        assert ("res_scale" in static) == (quant == "1")
        sbuf, dbuf, meta_s, meta_d = convert.device_inputs_from_buffers(
            static, dyn, device="cpu")
        out = kernels.fused_pass(
            sbuf, dbuf, meta_s=meta_s, meta_d=meta_d, u_pad=kw["u_pad"],
            n_pad=kw["n_pad"], with_scores=kw["with_scores"],
            max_nnz=kw["max_nnz"], max_rounds=kw.get("max_rounds", 256),
            slot_m=kw["slot_m"])
        assert out.meta == captured["meta"]
        got = xfer.unpack_host(out.buf.numpy(), out.meta)
        want = jxfer.unpack_host(captured["buf"], captured["meta"])
        for name in ("unplaced", "feas_count", "scalars"):
            np.testing.assert_array_equal(got[name], want[name])
        nnz = int(want["scalars"][0])
        assert nnz > 0
        np.testing.assert_array_equal(got["coo"][:nnz, :3],
                                      want["coo"][:nnz, :3])
        np.testing.assert_array_equal(got["coo"][:nnz, 4],
                                      want["coo"][:nnz, 4])
        gs = got["coo"][:nnz, 3].view(np.float32)
        ws = want["coo"][:nnz, 3].view(np.float32)
        assert np.abs(gs - ws).max() <= SCORE_ATOL


def test_payload_window_overflow_takes_the_extra_fetch(monkeypatch):
    """More placements than the packed buffer's COO window: the result
    comes from the overflow source and equals the unwindowed one."""
    h, rng, jobs = build(7, n_nodes=30, n_jobs=4, max_count=40)
    want = run_port(h, jobs, 7, [])
    monkeypatch.setattr(kernels, "FUSED_WINDOW_BYTES", 16 * 20)
    got = run_port(h, jobs, 7, [])
    placed = sum(len(sp.node_ids) for sp in got.placements.values())
    assert placed > 16
    assert got.placements.keys() == want.placements.keys()
    for key, sp in want.placements.items():
        assert got.placements[key].node_ids == sp.node_ids
        np.testing.assert_array_equal(got.placements[key].scores, sp.scores)
        assert got.placements[key].metric_scores == sp.metric_scores
