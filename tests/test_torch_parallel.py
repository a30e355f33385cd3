"""The port's mesh scoring pieces against the JAX reference on the CPU:
the plain ``masked_score_matrix``, ``stable_top_k``,
``sharded_candidate_scores``, ``pack_host_sharded`` and the shard
offsets of ``scored_rows``.

Inputs are made with numpy from a seed and handed to both packages.  The
reference mesh runs on the virtual CPU devices of ``tests/conftest.py``;
the port's mesh is ``["cpu"] * D``.  Node indices and masks are exact;
scores agree within 2e-6, one ulp at 18 (the port's CPU ``pow`` against
XLA's, ROADMAP queue 3 item 2).
"""
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.ops import kernels as jk
from nomad_tpu.ops import pallas_score
from nomad_tpu.ops import xfer as jxfer
from nomad_tpu.parallel import make_node_mesh as jax_mesh
from nomad_tpu.parallel import sharded_candidate_scores as jax_candidates
from nomad_tpu_torch import device
from nomad_tpu_torch.ops import fused_score, kernels, xfer
from nomad_tpu_torch.parallel import sharded

SCORE_ATOL = 2e-6
NEG_INF = -1e30


def node_inputs(n, u, seed, n_pad=None):
    """A node fleet with full nodes, denom == 0 and, past ``n``, padding
    columns (zero capacity, infeasible) up to ``n_pad``."""
    n_pad = n_pad or n
    rng = np.random.default_rng(seed)
    capacity = np.zeros((n_pad, 4), np.int32)
    capacity[:n] = (4000, 8192, 102400, 150)
    used = np.zeros((n_pad, 4), np.int32)
    used[:n, 0] = rng.integers(0, 4200, n)
    used[:n, 1] = rng.integers(0, 8192, n)
    full = rng.random(n) < 0.06
    used[:n][full] = capacity[:n][full]
    denom = np.ones((n_pad, 2), np.float32)
    denom[:n] = capacity[:n, :2]
    denom[:n][rng.random(n) < 0.1, 0] = 0.0
    feas = rng.random((u, n_pad)) < 0.8
    feas[:, n:] = False
    ask = np.stack([np.array([rng.integers(100, 900), rng.integers(64, 1024),
                              150, 0], np.int32) for _ in range(u)])
    return feas, used, capacity, denom, ask


def candidate_problem(n, u, seed):
    """The inputs of tests/test_parallel.py:_mk_problem."""
    rng = np.random.default_rng(seed)
    capacity = np.tile(np.array([4000, 8192, 102400, 150], np.int32), (n, 1))
    used = np.zeros((n, 4), np.int32)
    used[:, 0] = rng.integers(0, 2000, n)
    used[:, 1] = rng.integers(0, 4096, n)
    denom = capacity[:, :2].astype(np.float32)
    feas = rng.random((u, n)) < 0.8
    ask = np.tile(np.array([500, 256, 150, 0], np.int32), (u, 1))
    return feas, used, capacity, denom, ask


def identical_fleet(n, u, seed):
    """Identical nodes (mock.node()'s shape): every feasible score ties,
    so the candidates are decided by the tie order alone."""
    rng = np.random.default_rng(seed)
    capacity = np.tile(np.array([4000, 8192, 102400, 150], np.int32), (n, 1))
    used = np.tile(np.array([100, 256, 0, 0], np.int32), (n, 1))
    denom = (capacity[:, :2] - used[:, :2]).astype(np.float32)
    feas = rng.random((u, n)) < 0.9
    ask = np.stack([np.array([rng.choice([250, 500]), 256, 150, 0], np.int32)
                    for _ in range(u)])
    return feas, used, capacity, denom, ask


def torch_args(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- masked_score_matrix -----------------------------------------------------

@pytest.mark.parametrize("n,n_pad,u,seed", [
    (700, 700, 3, 1),        # N not a multiple of the TPU's 512 block
    (250, 384, 5, 2),        # padding columns
    (1000, 1024, 2, 3),
    (701, 701, 9, 4),        # the CUDA tile's scalar path, 9 rows
])
def test_masked_score_plain_matches_pallas_and_composition(n, n_pad, u, seed):
    feas, used, capacity, denom, ask = node_inputs(n, u, seed, n_pad)
    got = fused_score.masked_score_matrix(
        *torch_args(feas, used, capacity, denom, ask)).numpy()
    assert fused_score.MASKED_LAUNCHES == 0     # the CPU runs no kernel
    pallas = np.asarray(pallas_score.masked_score_matrix(
        jnp.asarray(feas), jnp.asarray(used), jnp.asarray(capacity),
        jnp.asarray(denom), jnp.asarray(ask), interpret=True))
    fits = np.all(ask[:, None, :] <= (capacity - used)[None], axis=2)
    ok = feas & fits
    comp = np.stack([np.asarray(jnp.where(
        jnp.asarray(ok[i]),
        jk._score_fit(jnp.asarray(used), jnp.asarray(ask[i]),
                      jnp.asarray(denom)), jnp.float32(NEG_INF)))
        for i in range(u)])
    for want in (pallas, comp):
        np.testing.assert_array_equal(got == NEG_INF, want == NEG_INF)
        live = want != NEG_INF
        assert np.abs(got[live] - want[live]).max() <= SCORE_ATOL
    assert (got[:, n:] == NEG_INF).all()        # padding never scores
    assert ok.any() and (~ok[:, :n]).any()


def test_masked_score_equals_scored_rows_base_where_ok():
    """One ScoreFit, two kernels: the masked score is scored_rows' base
    wherever the spec fits (bit for bit in the plain versions too)."""
    feas, used, capacity, denom, ask = node_inputs(640, 4, 9)
    t = torch_args(feas, used, capacity, denom, ask)
    masked = fused_score.masked_score_matrix(*t)
    scored, base = fused_score.scored_rows(
        *t, torch.zeros(4), torch.zeros((4, 640), dtype=torch.int32), 77)
    ok = scored != NEG_INF
    assert torch.equal(masked == NEG_INF, ~ok)
    assert torch.equal(masked[ok].view(torch.int32),
                       base[ok].view(torch.int32))


# -- stable_top_k -------------------------------------------------------------

def top_k_rows():
    rng = np.random.default_rng(5)
    trap = np.array([1, 3, 3, -1e30, 3, 2, -1e30, -1e30], np.float32)
    ties = rng.choice(np.float32([0.0, 1.5, 7.25, -1e30]), (4, 300))
    zeros = np.tile(np.float32([0.0, -0.0, 2.0, -0.0, 0.0, -1e30]), (2, 9))
    return {
        "trap": trap[None],
        "ties": ties.astype(np.float32),
        "all_neg_inf": np.full((3, 40), -1e30, np.float32),
        "signed_zeros": zeros,
        "distinct": rng.standard_normal((3, 129)).astype(np.float32),
    }


@pytest.mark.parametrize("name", sorted(top_k_rows()))
def test_stable_top_k_matches_lax_top_k(name):
    rows = top_k_rows()[name]
    n = rows.shape[1]
    for k in sorted({1, min(6, n), n // 2 or 1, n}):
        want_v, want_i = jax.lax.top_k(jnp.asarray(rows), k)
        got_v, got_i = kernels.stable_top_k(torch.from_numpy(rows), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                      np.asarray(want_v).view(np.int32))


def test_stable_top_k_keeps_the_tie_order_torch_topk_breaks():
    row = torch.tensor([1, 3, 3, -1e30, 3, 2, -1e30, -1e30])
    assert kernels.stable_top_k(row, 6)[1].tolist() == [1, 2, 4, 5, 0, 3]


# -- sharded_candidate_scores -------------------------------------------------

@pytest.mark.parametrize("d,problem", [(8, "mk_problem"), (8, "identical"),
                                       (3, "mk_problem"), (3, "identical")])
def test_candidate_scores_match_reference(d, problem):
    """The port's candidates (shard-major, global indices) equal the
    reference's, with the Pallas score and with the jnp one."""
    n = 256 if d == 8 else 384
    make = candidate_problem if problem == "mk_problem" else identical_fleet
    feas, used, capacity, denom, ask = make(n, 4, 3 + d)
    k = 16
    mesh = sharded.make_node_mesh(["cpu"] * d)
    got_s, got_i = sharded.sharded_candidate_scores(
        mesh, *torch_args(feas, used, capacity, denom, ask), k=k)
    assert got_s.shape == (4, k * d) and got_i.dtype == torch.int32
    jmesh = jax_mesh(jax.devices()[:d])
    for use_pallas in (False, True):
        want_s, want_i = jax_candidates(
            jmesh, jnp.asarray(feas), jnp.asarray(used),
            jnp.asarray(capacity), jnp.asarray(denom), jnp.asarray(ask),
            k=k, use_pallas=use_pallas)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        want_s = np.asarray(want_s)
        np.testing.assert_array_equal(got_s.numpy() == NEG_INF,
                                      want_s == NEG_INF)
        assert np.abs(got_s.numpy() - want_s).max() <= SCORE_ATOL
    if problem == "identical":
        # All ties: each shard's candidates are its first k feasible nodes.
        n_l = n // d
        for u in range(4):
            for i in range(d):
                part = got_i[u, i * k:(i + 1) * k].numpy()
                fits = np.all(ask[u] <= capacity - used, axis=1)
                ok = np.nonzero((feas[u] & fits)[i * n_l:(i + 1) * n_l])[0]
                np.testing.assert_array_equal(part, ok[:k] + i * n_l)


def test_candidates_hold_the_global_top_k():
    """The gathered candidates, stably sorted, give the 1-shard top-k:
    the exactness the mesh's commit relies on."""
    feas, used, capacity, denom, ask = identical_fleet(512, 3, 21)
    args = torch_args(feas, used, capacity, denom, ask)
    k = 32
    one_s, one_i = sharded.sharded_candidate_scores(
        sharded.make_node_mesh(["cpu"]), *args, k=k)
    many_s, many_i = sharded.sharded_candidate_scores(
        sharded.make_node_mesh(["cpu"] * 4), *args, k=k)
    top_s, pos = kernels.stable_top_k(many_s, k)
    assert torch.equal(torch.gather(many_i, 1, pos.to(torch.int64)), one_i)
    assert torch.equal(top_s, one_s)


def test_candidate_scores_need_a_dividing_mesh():
    feas, used, capacity, denom, ask = candidate_problem(100, 2, 1)
    with pytest.raises(ValueError, match="must divide"):
        sharded.sharded_candidate_scores(
            sharded.make_node_mesh(["cpu"] * 3),
            *torch_args(feas, used, capacity, denom, ask), k=8)


# -- scored_rows on a shard ---------------------------------------------------

def test_scored_rows_shard_offsets_tile_global_matrix():
    """Scoring shard by shard with n_offset = shard·n_l gives the columns
    of the one global matrix: the jitter is keyed on the global node
    index (the port's counterpart of tests/test_pallas_score.py:174)."""
    feas, used, capacity, denom, ask = node_inputs(512, 3, 13)
    rng = np.random.default_rng(13)
    penalty = rng.uniform(0, 25, 3).astype(np.float32)
    coll = rng.integers(0, 3, (3, 512)).astype(np.int32)
    args = torch_args(feas, used, capacity, denom, ask, penalty, coll)
    whole, whole_base = fused_score.scored_rows(*args, 1234, u_offset=5)
    n_l = 128
    for i in range(4):
        lo, hi = i * n_l, (i + 1) * n_l
        part, part_base = fused_score.scored_rows(
            args[0][:, lo:hi].contiguous(), args[1][lo:hi], args[2][lo:hi],
            args[3][lo:hi], args[4], args[5],
            args[6][:, lo:hi].contiguous(), 1234, u_offset=5, n_offset=lo)
        assert torch.equal(part, whole[:, lo:hi])
        assert torch.equal(part_base, whole_base[:, lo:hi])


# -- pack_host_sharded --------------------------------------------------------

def test_pack_host_sharded_bytes_identical():
    rng = np.random.default_rng(8)
    arrays = {
        "cap": rng.integers(0, 9000, (96, 4)).astype(np.int32),
        "denom": rng.random((96, 2)).astype(np.float32),
        "elig": rng.random(96) < 0.5,
        "attr": rng.integers(-1, 5, (96, 3)).astype(np.int32),
        "res_scale": np.arange(8, dtype=np.int32).reshape(2, 4),
    }
    for shards in (1, 3, 4, 8):
        got, meta = xfer.pack_host_sharded(arrays, shards,
                                           replicate=("res_scale",))
        want, jmeta = jxfer.pack_host_sharded(arrays, shards,
                                              replicate=("res_scale",))
        assert meta == jmeta
        assert got.shape == (shards, got.shape[1])
        np.testing.assert_array_equal(got, want)


def test_pack_host_sharded_rejects_a_non_dividing_axis():
    with pytest.raises(ValueError, match="not divisible by 3 shards"):
        xfer.pack_host_sharded({"cap": np.zeros((8, 4), np.int32)}, 3)


# -- the mesh's devices and the kernel's wrapper ------------------------------

def test_make_node_mesh_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sharded.make_node_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sharded.make_node_mesh(["cuda:0"] * 4)
    mesh = sharded.make_node_mesh(["cpu"] * 4)
    assert mesh.size == 4 and mesh.root == torch.device("cpu")


def test_masked_wrapper_never_computes_plain_off_the_cpu():
    t = lambda *shape, dt=torch.int32: torch.empty(  # noqa: E731
        shape, dtype=dt, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_score.masked_score_matrix(
            t(1, 128, dt=torch.bool), t(128, 4), t(128, 4),
            t(128, 2, dt=torch.float32), t(1, 4))
    assert fused_score.MASKED_LAUNCHES == 0


def test_masked_kernel_raises_without_a_built_library(monkeypatch, tmp_path):
    monkeypatch.setattr(device, "find_nvcc", lambda: None)
    monkeypatch.setattr(device, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(device, "_LIBS", {})
    monkeypatch.setattr(fused_score, "_FNS", {})
    with pytest.raises(device.KernelUnavailable, match="nvcc not found"):
        fused_score._fn("masked_score")
    assert fused_score.MASKED_LAUNCHES == 0


def test_mesh_path_runs_with_jax_unimportable():
    code = """
import sys
sys.modules["jax"] = None
sys.modules["nomad_tpu"] = None
from nomad_tpu_torch import mock
from nomad_tpu_torch.ops.batch_sched import schedule_batch
from nomad_tpu_torch.parallel import make_node_mesh
nodes = [mock.node() for _ in range(30)]
for n in nodes:
    n.resources.networks = []
job = mock.job()
for t in job.task_groups[0].tasks:
    t.resources.networks = []
res = schedule_batch(nodes, [job], rng_seed=3,
                     mesh=make_node_mesh(["cpu"] * 3))
sp = res.placements[(job.id, "web")]
assert len(sp.node_ids) == 10 and sp.unplaced == 0, sp
assert res.mesh_shards == 3, res.mesh_shards
print("ok")
"""
    root = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
