"""The port's node-mesh batch path against the JAX single-chip scheduler
and the port's own single-chip path, on the CPU.

The reference's mesh program fails under the installed jax (ROADMAP
queue 3 item 1), so ``schedule_batch(mesh=...)`` is held against the
reference's single-chip ``TPUBatchScheduler``, as the reference's mesh
tests do: with ``k_cand`` at least the largest count (or the whole
shard), each round's global top-k lies inside the gathered candidates
and the mesh commits what the single chip commits
(nomad_tpu/parallel/sharded.py:411-418).  Placements by (job, task group)
and unplaced counts are exact, AllocMetric scores within 1e-5 of the
reference and bit-identical to the port's single-chip path.  Rounds are
not compared across the two: the mesh loop has no capacity early exit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from nomad_tpu.ops import batch_sched as jbatch
from nomad_tpu.ops import kernels as jkernels
from nomad_tpu.ops import xfer as jxfer
from nomad_tpu_torch import convert
from nomad_tpu_torch.ops import batch_sched, fused_score, xfer
from nomad_tpu_torch.parallel import sharded
from test_torch_batch import (SCORE_ATOL, assert_same, build, live_allocs,
                              make_job, run_port, run_reference)


def run_mesh(h, jobs, seed, live, d):
    nodes = [convert.node_from_dict(dataclasses.asdict(n))
             for n in h.state.nodes(None)]
    pjobs = [convert.job_from_dict(dataclasses.asdict(j)) for j in jobs]
    res = batch_sched.schedule_batch(
        nodes, pjobs, live_allocs=live, rng_seed=seed,
        mesh=sharded.make_node_mesh(["cpu"] * d))
    assert res.mesh_shards == d
    return res


def assert_identical(got, want):
    """Bit-identical batch results: node order, unplaced, score bits and
    the AllocMetric scores."""
    assert got.placements.keys() == want.placements.keys()
    for key, sp in want.placements.items():
        g = got.placements[key]
        assert g.node_ids == sp.node_ids, key
        assert g.unplaced == sp.unplaced, key
        np.testing.assert_array_equal(g.scores.view(np.int32),
                                      sp.scores.view(np.int32))
        np.testing.assert_array_equal(g.collisions, sp.collisions)
        assert g.metric_scores == sp.metric_scores


@pytest.mark.parametrize("d", [8, 3])
@pytest.mark.parametrize("seed", [3, 17, 41])
def test_mesh_batch_then_follow_up_matches_reference(seed, d, monkeypatch):
    """Two batches on a d-shard mesh against the reference's single-chip
    scheduler; the second runs against the first's placements."""
    h, rng, jobs = build(seed, n_nodes=40, n_jobs=5, max_count=30)
    res = run_mesh(h, jobs, seed, live_allocs(h), d)
    run_reference(h, jobs, seed, monkeypatch)
    assert_same(res, h, jobs)

    more = [make_job(rng.randint(1, 20), rng) for _ in range(3)]
    live = live_allocs(h)
    res2 = run_mesh(h, more, seed + 1, live, d)
    run_reference(h, more, seed + 1, monkeypatch)
    assert_same(res2, h, more)
    assert res2.placements


@pytest.mark.parametrize("d", [4, 3])
def test_saturated_mesh_batch_matches_reference(d, monkeypatch):
    """More asks than capacity and distinct_hosts specs: unplaced counts
    agree with the reference and with the port's single-chip path, which
    may stop a round earlier."""
    h, rng, jobs = build(5, n_nodes=12, n_jobs=6, max_count=25,
                         constrained=True)
    res = run_mesh(h, jobs, 5, live_allocs(h), d)
    single = run_port(h, jobs, 5, live_allocs(h))
    run_reference(h, jobs, 5, monkeypatch)
    assert_same(res, h, jobs)
    assert any(sp.unplaced for sp in res.placements.values())
    assert_identical(res, single)
    assert single.mesh_shards == 0
    assert res.rounds >= single.rounds


@pytest.mark.parametrize("d", [8, 3])
def test_mesh_bit_identical_to_port_single_chip(d):
    h, rng, jobs = build(29, n_nodes=150, n_jobs=8, max_count=60)
    single = run_port(h, jobs, 29, [])
    mesh = run_mesh(h, jobs, 29, [], d)
    assert_identical(mesh, single)
    placed = sum(len(sp.node_ids) for sp in single.placements.values())
    assert placed > 0


def test_slot_record_over_budget_takes_the_single_chip_path(monkeypatch):
    h, rng, jobs = build(7, n_nodes=30, n_jobs=4, max_count=30)
    want = run_port(h, jobs, 7, [])
    monkeypatch.setattr(batch_sched, "MESH_SLOT_BUDGET_BYTES", 64)
    nodes = [convert.node_from_dict(dataclasses.asdict(n))
             for n in h.state.nodes(None)]
    pjobs = [convert.job_from_dict(dataclasses.asdict(j)) for j in jobs]
    got = batch_sched.schedule_batch(
        nodes, pjobs, rng_seed=7, mesh=sharded.make_node_mesh(["cpu"] * 4))
    assert got.mesh_shards == 0
    assert_identical(got, want)


def test_mesh_and_device_are_exclusive():
    with pytest.raises(ValueError, match="not both"):
        batch_sched.schedule_batch([], [], device="cpu",
                                   mesh=sharded.make_node_mesh(["cpu"]))


@pytest.mark.parametrize("d", [8, 4])
def test_fused_mesh_pass_matches_reference_fused_buffer(d, monkeypatch):
    """The port's sharded_fused_pass on the reference's own single-chip
    upload, cut into d shards, returns the reference fused pass's
    result: unplaced, feas_count, nnz and the COO rows exactly, scores
    within 1e-5.  Only the round count may differ (one more round)."""
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
    h, rng, jobs = build(31, n_nodes=30, n_jobs=4, max_count=30)
    run_reference(h, jobs, 31, monkeypatch)
    more = [make_job(rng.randint(5, 25), rng) for _ in range(3)]
    run_reference(h, more, 32, monkeypatch)   # with live usage and jc rows

    kw = captured["kw"]
    static = jxfer.unpack_host(captured["static"], kw["meta_s"])
    dyn = jxfer.unpack_host(captured["dyn"], kw["meta_d"])
    sbuf, _, meta_s, _ = convert.device_inputs_from_buffers(static, dyn,
                                                            device="cpu")
    static = xfer.unpack_host(sbuf.numpy(), meta_s)       # dequantized
    shards, meta_s = xfer.pack_host_sharded(static, d)
    dbuf, meta_d = xfer.pack_host(dyn)
    mesh = sharded.make_node_mesh(["cpu"] * d)
    assert kw["slot_m"] > 0
    out = sharded.sharded_fused_pass(
        mesh, [torch.from_numpy(shards[i]) for i in range(d)],
        torch.from_numpy(dbuf), meta_s=meta_s, meta_d=meta_d,
        u_pad=kw["u_pad"], n_pad=kw["n_pad"], with_scores=kw["with_scores"],
        max_nnz=kw["max_nnz"], slot_m=kw["slot_m"],
        k_cand=max(64, kw["slot_m"]))
    assert fused_score.MASKED_LAUNCHES == 0 and fused_score.LAUNCHES == 0
    assert out.meta == captured["meta"]
    got = xfer.unpack_host(out.buf.numpy(), out.meta)
    want = jxfer.unpack_host(captured["buf"], captured["meta"])
    for name in ("unplaced", "feas_count"):
        np.testing.assert_array_equal(got[name], want[name])
    nnz = int(want["scalars"][0])
    assert nnz > 0 and int(got["scalars"][0]) == nnz
    assert int(got["scalars"][1]) >= int(want["scalars"][1])
    np.testing.assert_array_equal(got["coo"][:nnz, :3], want["coo"][:nnz, :3])
    np.testing.assert_array_equal(got["coo"][:nnz, 4], want["coo"][:nnz, 4])
    gs = got["coo"][:nnz, 3].view(np.float32)
    ws = want["coo"][:nnz, 3].view(np.float32)
    assert np.abs(gs - ws).max() <= SCORE_ATOL
    assert [f.shape for f in out.feas] == [(kw["u_pad"], kw["n_pad"] // d)] * d
