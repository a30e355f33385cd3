"""The port's placement kernels against the JAX reference on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Exact unless stated: the score tolerance of 1e-5 covers only the
penalty product, which XLA may contract into an FMA with the
subtraction while the port rounds it on its own (the reference's own
scored_rows test allows the same, tests/test_pallas_score.py:165-169).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_problem
from nomad_tpu.ops import kernels as jk
from nomad_tpu.ops import pallas_score
from nomad_tpu_torch.ops import fused_score
from nomad_tpu_torch.ops import kernels as tk

SCORE_ATOL = 1e-5


def score_inputs(n, u, seed):
    rng = np.random.default_rng(seed)
    capacity = np.tile(np.array([4000, 8192, 102400, 150], np.int32), (n, 1))
    used = np.zeros((n, 4), np.int32)
    used[:, 0] = rng.integers(0, 4200, n)
    used[:, 1] = rng.integers(0, 8192, n)
    used[: n // 16] = capacity[: n // 16]          # full nodes
    denom = capacity[:, :2].astype(np.float32)
    denom[rng.random(n) < 0.1, 0] = 0.0            # degenerate capacity
    feas = rng.random((u, n)) < 0.8
    ask = np.stack([np.array([rng.integers(100, 900), rng.integers(64, 1024),
                              150, 0], np.int32) for _ in range(u)])
    penalty = rng.uniform(0.0, 25.0, u).astype(np.float32)
    coll = ((rng.random((u, n)) < 0.1).astype(np.int32)
            * rng.integers(1, 4, (u, n)).astype(np.int32))
    return feas, used, capacity, denom, ask, penalty, coll


def port_scored(feas, used, capacity, denom, ask, penalty, coll, seed,
                u_off=0, n_off=0):
    t = torch.from_numpy
    scored, base = fused_score.scored_rows(
        t(feas), t(used), t(capacity), t(denom), t(ask), t(penalty), t(coll),
        seed, u_offset=u_off, n_offset=n_off)
    return scored.numpy(), base.numpy()


def commit_composition(feas, used, capacity, denom, ask, penalty, coll,
                       seed, u_off, n_off):
    """kernels.py:463-506, one spec row at a time."""
    rows = []
    n = feas.shape[1]
    node_idx = jnp.arange(n, dtype=jnp.int32) + n_off
    for i in range(feas.shape[0]):
        fits = jnp.all(jnp.asarray(ask[i])[None, :]
                       <= jnp.asarray(capacity - used), axis=1)
        ok = jnp.asarray(feas[i]) & fits
        score = jk._score_fit(jnp.asarray(used), jnp.asarray(ask[i]),
                              jnp.asarray(denom))
        score = score - penalty[i] * jnp.asarray(coll[i]).astype(jnp.float32)
        score = score + jk.tie_jitter(jnp.uint32(seed),
                                      jnp.int32(u_off + i), node_idx)
        rows.append(jnp.where(ok, score, jnp.float32(jk.NEG_INF)))
    return np.asarray(jnp.stack(rows))


@pytest.mark.parametrize("n,u,seed,u_off,n_off", [
    (512, 3, 7, 0, 0),
    (700, 2, 13, 0, 0),
    (512, 2, 17, 32, 2048),
    # The CUDA tile's edges: N % 4 != 0 (its scalar path) and a row count
    # that is no multiple of a row tile.
    (701, 9, 19, 0, 0),
    (701, 9, 23, 41, 250_016),
])
def test_scored_rows_plain_matches_pallas_and_composition(n, u, seed, u_off,
                                                          n_off):
    args = score_inputs(n, u, seed)
    js = seed * 2654435761 % 2**32
    got, base = port_scored(*args, js, u_off, n_off)
    feas, used, capacity, denom, ask, penalty, coll = args
    pallas = np.asarray(pallas_score.scored_rows(
        *(jnp.asarray(a) for a in args), np.uint32(js), u_offset=u_off,
        n_offset=n_off, interpret=True))
    comp = commit_composition(*args, js, u_off, n_off)
    for want in (pallas, comp):
        np.testing.assert_array_equal(got == jk.NEG_INF, want == jk.NEG_INF)
        inactive = coll == 0
        np.testing.assert_array_equal(got[inactive], want[inactive])
        assert np.abs(got - want).max() <= SCORE_ATOL
    want_base = np.stack([np.asarray(jk._score_fit(
        jnp.asarray(used), jnp.asarray(ask[i]), jnp.asarray(denom)))
        for i in range(u)])
    np.testing.assert_array_equal(base, want_base)


@pytest.mark.parametrize("n,u,n_off", [(512, 3, 0), (701, 9, 250_016)])
def test_scored_rows_without_base(n, u, n_off):
    """``with_base=False`` returns ``(scored, None)``, ``scored`` equal to
    the ``with_base=True`` call's."""
    args = [torch.from_numpy(a) for a in score_inputs(n, u, n + u)]
    scored, base = fused_score.scored_rows(*args, 4242, u_offset=3,
                                           n_offset=n_off, with_base=False)
    want, want_base = fused_score.scored_rows(*args, 4242, u_offset=3,
                                              n_offset=n_off)
    assert base is None and want_base.shape == (u, n)
    assert torch.equal(scored.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("with_scores", [True, False])
def test_placement_rounds_asks_for_base_only_with_scores(with_scores,
                                                         monkeypatch):
    """The loop asks the score kernel for ``base`` only when it keeps
    scores, and places the same either way."""
    asked = []
    wrapped = fused_score.scored_rows

    def recording(*args, **kw):
        asked.append(kw["with_base"])
        return wrapped(*args, **kw)

    problem = [torch.from_numpy(a) for a in random_problem(6)]
    want = tk.placement_rounds(*problem, tk.jitter_seed(6), slot_m=64)
    monkeypatch.setattr(fused_score, "scored_rows", recording)
    got = tk.placement_rounds(*problem, tk.jitter_seed(6), slot_m=64,
                              with_scores=with_scores)
    assert asked and set(asked) == {with_scores}
    assert torch.equal(got.slots, want.slots)
    assert torch.equal(got.unplaced, want.unplaced)


def test_scored_rows_penalty_product_exact_for_integer_penalties():
    """The placement loop's penalties are 10 or 20: the product with a
    small collision count is exact, so the scores are bit-identical."""
    feas, used, capacity, denom, ask, _, coll = score_inputs(512, 4, 3)
    penalty = np.array([20.0, 10.0, 20.0, 10.0], np.float32)
    got, _ = port_scored(feas, used, capacity, denom, ask, penalty, coll, 99)
    want = commit_composition(feas, used, capacity, denom, ask, penalty,
                              coll, 99, 0, 0)
    np.testing.assert_array_equal(got, want)


def test_tie_jitter_matches():
    n = np.arange(0, 70000, 7, dtype=np.int32)
    for seed, u in [(0, 0), (2**32 - 1, 5), (123456789, 1023)]:
        want = np.asarray(jk.tie_jitter(jnp.uint32(seed), jnp.int32(u),
                                        jnp.asarray(n)))
        got = fused_score.tie_jitter(seed, u, torch.from_numpy(n)).numpy()
        np.testing.assert_array_equal(got, want)


def test_jitter_seed_matches_jax_for_256_seeds():
    rng = np.random.default_rng(0)
    seeds = list(range(128)) + [int(x) for x in rng.integers(0, 2**31, 128)]
    for s in seeds:
        want = int(jk.jitter_seed(jax.random.PRNGKey(np.int32(s))))
        assert tk.jitter_seed(s) == want, s


@pytest.mark.parametrize("case", ["ties", "neg_inf", "k1", "kall",
                                  "random"])
def test_select_top_k_matches(case):
    rng = np.random.default_rng(hash(case) % 2**32)
    n = 300
    scored = rng.normal(5.0, 3.0, n).astype(np.float32)
    ok = rng.random(n) < 0.8
    k = 37
    if case == "ties":
        scored = rng.choice(np.float32([1.5, 2.5, -0.0, 0.0, 7.25]), n)
    elif case == "neg_inf":
        scored[::3] = jk.NEG_INF
        ok[::3] = False
        scored[1::7] = -3.0
    elif case == "k1":
        k = 1
    elif case == "kall":
        k = int(ok.sum())
    scored = np.where(ok, scored, np.float32(jk.NEG_INF)).astype(np.float32)
    want = np.asarray(jax.jit(jk._select_top_k)(
        jnp.asarray(scored), jnp.asarray(ok), jnp.int32(k)))
    got = tk._select_top_k(torch.from_numpy(scored), torch.from_numpy(ok),
                           k).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == k


def test_feasibility_matrix_all_ops():
    from nomad_tpu.ops.encode import (MISSING, OP_EQ, OP_GE, OP_GT, OP_LE,
                                      OP_LT, OP_NE, OP_TRUE, UNKNOWN_RHS)

    rng = np.random.default_rng(5)
    n, u, k_attrs, kc, d = 64, 16, 3, 4, 4
    attr = rng.integers(0, 5, (n, k_attrs)).astype(np.int32)
    attr[rng.random((n, k_attrs)) < 0.2] = MISSING
    elig = rng.random(n) < 0.9
    dc = rng.integers(0, 3, n).astype(np.int32)
    dc[-4:] = MISSING             # padding rows: ineligible
    elig[-4:] = False
    ops = [OP_TRUE, OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE]
    c_attr = rng.integers(0, k_attrs, (u, kc)).astype(np.int32)
    c_op = rng.choice(ops, (u, kc)).astype(np.int32)
    c_rhs = rng.integers(0, 5, (u, kc)).astype(np.int32)
    c_rhs[rng.random((u, kc)) < 0.2] = UNKNOWN_RHS
    dc_mask = rng.random((u, d)) < 0.7
    for precomp in (np.ones((1, 1), bool), rng.random((u, n)) < 0.9):
        args = (attr, elig, dc, c_attr, c_op, c_rhs, dc_mask, precomp)
        want = np.asarray(jk.feasibility_matrix(*(jnp.asarray(a)
                                                  for a in args)))
        got = tk.feasibility_matrix(*(torch.from_numpy(a)
                                      for a in args)).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < want.sum() < want.size


def random_problem(seed, n=96, u=8):
    rng = np.random.default_rng(seed)
    capacity = np.zeros((n, 4), np.int32)
    capacity[:, 0] = rng.choice([2000, 4000, 8000], n)
    capacity[:, 1] = rng.choice([4096, 8192, 16384], n)
    capacity[:, 2] = 102400
    capacity[:, 3] = 150
    used = np.zeros((n, 4), np.int32)
    used[:, 0] = 100 + 250 * rng.integers(0, 4, n)
    used[:, 1] = 256
    denom = (capacity[:, :2] - used[:, :2]).astype(np.float32)
    feas = rng.random((u, n)) < 0.85
    ask = np.stack([np.array([rng.choice([100, 250, 500]),
                              rng.choice([64, 256, 512]), 150, 0], np.int32)
                    for _ in range(u)])
    count = rng.integers(0, 60, u).astype(np.int32)
    penalty = rng.choice([10.0, 20.0], u).astype(np.float32)
    distinct = rng.random(u) < 0.3
    job_index = rng.integers(0, u // 2, u).astype(np.int32)
    job_counts = (rng.random((u, n)) < 0.05).astype(np.int32)
    return (feas, used, capacity, denom, ask, count, penalty, distinct,
            job_index, job_counts)


def compare_rounds(problem, seed, slot_m, max_rounds=64):
    jres = jk.placement_rounds(*(jnp.asarray(a) for a in problem),
                               jax.random.PRNGKey(seed),
                               max_rounds=max_rounds, with_scores=True,
                               slot_m=slot_m)
    tres = tk.placement_rounds(*(torch.from_numpy(a) for a in problem),
                               tk.jitter_seed(seed), max_rounds=max_rounds,
                               with_scores=True, slot_m=slot_m)
    np.testing.assert_array_equal(tres.unplaced.numpy(),
                                  np.asarray(jres.unplaced))
    assert tres.rounds == int(jres.rounds)
    np.testing.assert_array_equal(tres.used_after.numpy(),
                                  np.asarray(jres.used_after))
    if slot_m:
        np.testing.assert_array_equal(tres.slots.numpy(),
                                      np.asarray(jres.slots))
        np.testing.assert_array_equal(tres.slot_coll.numpy(),
                                      np.asarray(jres.slot_coll))
        got, want = tres.slot_scores.numpy(), np.asarray(jres.slot_scores)
    else:
        np.testing.assert_array_equal(tres.placements.numpy(),
                                      np.asarray(jres.placements))
        np.testing.assert_array_equal(tres.commit_collisions.numpy(),
                                      np.asarray(jres.commit_collisions))
        got, want = (tres.commit_scores.numpy(),
                     np.asarray(jres.commit_scores))
    assert np.abs(got - want).max() <= SCORE_ATOL
    return tres


@pytest.mark.parametrize("slot_m", [0, 64])
def test_placement_rounds_tiny_problem(slot_m, monkeypatch):
    """The loop scores each committing step through the kernel's
    wrapper, one spec row at a time."""
    rows = []
    wrapped = fused_score.scored_rows

    def counting(feas, *args, **kw):
        rows.append(feas.shape[0])
        return wrapped(feas, *args, **kw)

    monkeypatch.setattr(fused_score, "scored_rows", counting)
    compare_rounds(_tiny_problem(), 0, slot_m)
    assert rows and set(rows) == {1}


@pytest.mark.parametrize("seed,slot_m", [(1, 0), (2, 64), (3, 64), (4, 0),
                                         (5, 64)])
def test_placement_rounds_random(seed, slot_m):
    compare_rounds(random_problem(seed), seed, slot_m)


def test_placement_rounds_max_rounds_cut():
    """A max_rounds cut leaves asks unplaced exactly as the reference."""
    problem = list(random_problem(9))
    problem[5] = np.full(8, 200, np.int32)     # more than one round needs
    compare_rounds(tuple(problem), 9, 256, max_rounds=2)


def test_scatter_job_counts_matches():
    rows = np.array([0, 2, 2, -1, 1, -1, 0, 0], np.int32)
    cols = np.array([3, 5, 5, 0, 7, 9, 3, 1], np.int32)
    vals = np.array([1, 2, 3, 9, 1, 9, 4, 1], np.int32)
    want = np.asarray(jk.scatter_job_counts(
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
        u_pad=4, n_pad=8))
    got = tk.scatter_job_counts(torch.from_numpy(rows), torch.from_numpy(cols),
                                torch.from_numpy(vals), 4, 8).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_scores", [True, False])
def test_coo_compaction_matches(with_scores):
    problem = random_problem(12)
    seed = 12
    for slot_m in (0, 64):
        jres = jk.placement_rounds(*(jnp.asarray(a) for a in problem),
                                   jax.random.PRNGKey(seed), max_rounds=64,
                                   with_scores=with_scores, slot_m=slot_m)
        tres = tk.placement_rounds(*(torch.from_numpy(a) for a in problem),
                                   tk.jitter_seed(seed), max_rounds=64,
                                   with_scores=with_scores, slot_m=slot_m)
        u16 = not with_scores
        if slot_m:
            want, wnnz = jk._slots_coo_gather(
                jres.slots, jres.slot_scores, jres.slot_coll, out_rows=512,
                with_scores=with_scores, compact_u16=u16)
            tag, got, gnnz = tk._slots_coo_gather(
                tres.slots, tres.slot_scores, tres.slot_coll, out_rows=512,
                with_scores=with_scores, compact_u16=u16)
        else:
            want, wnnz = jk._compact_coo(jres, u_pad=8, n_pad=96,
                                         with_scores=with_scores,
                                         max_nnz=512, compact_u16=u16)
            tag, got, gnnz = tk._compact_coo(tres, u_pad=8, n_pad=96,
                                             with_scores=with_scores,
                                             max_nnz=512, compact_u16=u16)
        assert int(gnnz) == int(wnnz) > 0
        assert tag == ("u16" if u16 else "i32")
        want = np.asarray(want)
        got = got.numpy()
        if u16:
            got = (got & 0xFFFF).astype(np.uint16)
        np.testing.assert_array_equal(got, want)
