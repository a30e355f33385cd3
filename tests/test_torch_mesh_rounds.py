"""The port's node-sharded placement rounds against the reference's
``sharded_placement_rounds`` on the CPU (the cases of
tests/test_parallel.py).

Inputs are made with numpy from a seed and handed to both packages; the
reference runs on the virtual CPU devices of ``tests/conftest.py``, the
port on ``["cpu"] * D``.  Placements, unplaced counts, the usage after
the batch and the round count are exact: the port's mesh loop keeps the
reference's (no capacity early exit, so it ends with a round that places
nothing).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.ops import kernels as jk
from nomad_tpu.parallel import make_node_mesh as jax_mesh
from nomad_tpu.parallel import sharded_placement_rounds as jax_rounds
from nomad_tpu.parallel import sharded_schedule_step as jax_step
from nomad_tpu_torch.ops import kernels
from nomad_tpu_torch.parallel import sharded


def full_problem(n=256, u=12, j=6, seed=11, tight=False):
    """tests/test_parallel.py:_mk_full_problem: several specs per job,
    distinct_hosts on some, existing job counts, capacity feedback."""
    rng = np.random.default_rng(seed)
    capacity = np.tile(np.array([4000, 8192, 102400, 150], np.int32), (n, 1))
    used = np.zeros((n, 4), np.int32)
    used[:, 0] = rng.integers(0, 3000 if tight else 2000, n)
    used[:, 1] = rng.integers(0, 6144 if tight else 4096, n)
    denom = capacity[:, :2].astype(np.float32)
    feas = rng.random((u, n)) < 0.7
    ask = np.stack([np.array([rng.integers(200, 900), rng.integers(128, 1024),
                              150, 0], np.int32) for _ in range(u)])
    count = rng.integers(4, 24, u).astype(np.int32)
    penalty = np.where(rng.random(u) < 0.5, 20.0, 10.0).astype(np.float32)
    distinct = rng.random(u) < 0.3
    job_index = rng.integers(0, j, u).astype(np.int32)
    job_counts = (rng.random((j, n)) < 0.05).astype(np.int32)
    return [feas, used, capacity, denom, ask, count, penalty, distinct,
            job_index, job_counts]


def under_commit_problem():
    """tests/test_parallel.py:294: one spec needing far more than k_cand·D
    a round, on nodes with distinct scores."""
    n = 1024
    rng = np.random.default_rng(41)
    capacity = np.tile(np.array([4000, 8192, 102400, 150], np.int32), (n, 1))
    used = np.zeros((n, 4), np.int32)
    used[:, 0] = rng.permutation(n) * 3
    used[:, 1] = rng.permutation(n) * 4
    denom = capacity[:, :2].astype(np.float32)
    feas = rng.random((1, n)) < 0.9
    return [feas, used, capacity, denom,
            np.array([[500, 256, 150, 0]], np.int32),
            np.array([300], np.int32), np.array([20.0], np.float32),
            np.zeros(1, bool), np.zeros(1, np.int32),
            np.zeros((1, n), np.int32)]


def contended_problem():
    """tests/test_parallel.py:357: 24 specs competing for a 80-95 % full
    fleet of 4096 nodes over several rounds."""
    n, u, j = 4096, 24, 8
    rng = np.random.default_rng(77)
    capacity = np.tile(np.array([4000, 8192, 102400, 150], np.int32), (n, 1))
    used = np.zeros((n, 4), np.int32)
    used[:, 0] = rng.integers(1000, 3500, n)
    used[:, 1] = rng.integers(2048, 7168, n)
    denom = capacity[:, :2].astype(np.float32)
    feas = rng.random((u, n)) < 0.8
    ask = np.stack([np.array([rng.integers(300, 800), rng.integers(256, 1024),
                              150, 0], np.int32) for _ in range(u)])
    count = rng.integers(64, 256, u).astype(np.int32)
    return [feas, used, capacity, denom, ask, count,
            np.full(u, 20.0, np.float32), rng.random(u) < 0.25,
            rng.integers(0, j, u).astype(np.int32),
            np.zeros((j, n), np.int32)]


def run_both(problem, seed, k_cand, d=8):
    want = jax_rounds(jax_mesh(jax.devices()[:d]),
                      *[jnp.asarray(a) for a in problem],
                      jax.random.PRNGKey(seed), k_cand=k_cand)
    got = sharded.sharded_placement_rounds(
        sharded.make_node_mesh(["cpu"] * d),
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in problem],
        kernels.jitter_seed(seed), k_cand=k_cand)
    np.testing.assert_array_equal(got.placements.numpy(),
                                  np.asarray(want.placements))
    np.testing.assert_array_equal(got.unplaced.numpy(),
                                  np.asarray(want.unplaced))
    np.testing.assert_array_equal(got.used_after.numpy(),
                                  np.asarray(want.used_after))
    assert got.rounds == int(want.rounds)
    return got


@pytest.mark.parametrize("seed,tight,k_cand", [
    (11, False, 8),    # k_cand·D = 64 < N: the local top-k truncates
    (23, True, 16),    # tight capacity and truncation
    (57, False, 32),   # the whole shard is the candidate set
])
def test_rounds_match_reference(seed, tight, k_cand):
    problem = full_problem(seed=seed, tight=tight)
    problem[5] = np.minimum(problem[5], k_cand)
    got = run_both(problem, seed, k_cand)
    assert got.placements.sum() > 0


def test_rounds_with_three_shards_match_reference():
    problem = full_problem(n=384, seed=31, tight=True)
    problem[5] = problem[5] * 40          # more asks than the fleet holds
    got = run_both(problem, 31, 64, d=3)
    assert got.placements.sum() > 0 and got.unplaced.sum() > 0


def test_distinct_hosts_and_anti_affinity_match_reference():
    problem = full_problem(seed=99)
    problem[7][:] = True
    got = run_both(problem, 7, 32)
    job_counts, job_index = problem[9], problem[8]
    for ji in range(job_counts.shape[0]):
        total = job_counts[ji] + got.placements.numpy()[job_index == ji].sum(0)
        assert total.max() <= 1


def test_under_commit_converges_like_reference():
    got = run_both(under_commit_problem(), 13, 8)
    assert got.rounds > 2 and int(got.placements.sum()) == 300


def test_contended_4k_nodes_match_reference():
    problem = contended_problem()
    got = run_both(problem, 19, 16)
    assert (got.used_after.numpy() <= problem[2]).all()
    assert got.rounds >= 2


def test_mesh_rounds_run_one_more_round_than_the_single_chip_loop():
    """The single-chip loop stops as soon as no node fits the smallest
    remaining ask; the mesh loop, like the reference's, stops on the
    round without progress.  Placements agree; rounds differ by one."""
    problem = full_problem(seed=23, tight=True)
    problem[0][:] = True                  # every node feasible, and
    problem[7][:] = False                 # no distinct_hosts: the fleet
    problem[4][:] = (1000, 512, 150, 0)   # runs out of capacity first
    problem[5][:] = 64
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in problem]
    seed = kernels.jitter_seed(23)
    single = kernels.placement_rounds(*t, seed, with_scores=False)
    mesh = sharded.sharded_placement_rounds(
        sharded.make_node_mesh(["cpu"] * 4), *t, seed, k_cand=64)
    assert single.unplaced.sum() > 0
    assert torch.equal(mesh.placements, single.placements)
    assert torch.equal(mesh.unplaced, single.unplaced)
    assert mesh.rounds == single.rounds + 1
    np.testing.assert_array_equal(
        np.asarray(jk.placement_rounds(*[jnp.asarray(a) for a in problem],
                                       jax.random.PRNGKey(23)).placements),
        mesh.placements.numpy())


def test_schedule_step_matches_reference():
    rng = np.random.default_rng(5)
    n, u = 256, 4
    capacity = np.tile(np.array([4000, 8192, 102400, 150], np.int32), (n, 1))
    used = np.zeros((n, 4), np.int32)
    used[:, 0] = rng.integers(0, 2000, n)
    used[:, 1] = rng.integers(0, 4096, n)
    denom = capacity[:, :2].astype(np.float32)
    feas = rng.random((u, n)) < 0.8
    ask = np.tile(np.array([500, 256, 150, 0], np.int32), (u, 1))
    count = np.full(u, 20, np.int32)
    args = (feas, used, capacity, denom, ask, count)
    want_p, want_u = jax_step(jax_mesh(), *[jnp.asarray(a) for a in args],
                              k=16)
    got_p, got_u = sharded.sharded_schedule_step(
        sharded.make_node_mesh(["cpu"] * 8),
        *[torch.from_numpy(a) for a in args], k=16)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    assert int(got_p.sum()) == count.sum()


def test_networks_and_distinct_property_are_a_later_slice():
    """Network asks and distinct_property together on a 2-shard mesh: the
    reference mesh's placements, unplaced counts and usage."""
    problem = full_problem(seed=31)
    u, n = problem[0].shape
    rng = np.random.default_rng(31)
    active = rng.random(u) < 0.7
    resv = np.zeros((u, 2), np.uint32)
    resv[::3, 1] = np.uint32(1 << 31)
    ports = np.zeros((n, 2), np.uint32)
    ports[::5, 1] = np.uint32(1 << 31)
    bw_cap = rng.integers(100, 600, n).astype(np.int32)
    bw_cap[::11] = -1
    net = (active, np.where(active, 40, 0).astype(np.int32),
           np.ones(u, np.int32), resv, bw_cap, np.zeros(n, np.int32),
           rng.integers(0, 6, n).astype(np.int32), ports)
    attr = rng.integers(0, 9, (n, 1)).astype(np.int32)
    attr[::13] = -1
    dp = (np.zeros(u, np.int32), rng.random(u) < 0.5,
          np.zeros((u, 16), bool), attr)
    want = jax_rounds(
        jax_mesh(jax.devices()[:2]), *[jnp.asarray(a) for a in problem],
        jax.random.PRNGKey(31), k_cand=16,
        net=jk.NetTensors(*[jnp.asarray(a) for a in net]),
        dp=jk.DPTensors(*[jnp.asarray(a) for a in dp]))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        a.view(np.int32) if a.dtype == np.uint32 else a))
    got = sharded.sharded_placement_rounds(
        sharded.make_node_mesh(["cpu"] * 2), *[t(a) for a in problem],
        kernels.jitter_seed(31), k_cand=16,
        net=kernels.NetTensors(*[t(a) for a in net]),
        dp=kernels.DPTensors(*[t(a) for a in dp]))
    np.testing.assert_array_equal(got.placements.numpy(),
                                  np.asarray(want.placements))
    np.testing.assert_array_equal(got.unplaced.numpy(),
                                  np.asarray(want.unplaced))
    np.testing.assert_array_equal(got.used_after.numpy(),
                                  np.asarray(want.used_after))
    assert got.rounds == int(want.rounds)
    assert np.asarray(want.placements).sum() > 0
