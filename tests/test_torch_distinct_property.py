"""distinct_property and the host-evaluated constraint rows in the port
against the JAX reference on the CPU.

- The placement loop with ``dp=`` against the reference's
  ``placement_rounds`` with ``DPTensors`` (several selected nodes sharing
  a value in one round, ``MISSING`` values, used values), on one device
  and on the mesh against the reference's ``sharded_placement_rounds``:
  exact.  The value dedup against the reference's expression, with equal
  scores.
- The batch against the reference's ``TPUBatchScheduler`` in a
  ``Harness`` (the scenarios of ``tests/test_tpu_networks.py``): one
  alloc per value, a count beyond the values, a value an existing alloc
  holds.
- The ``version``, ``regexp``, ``set_contains`` and ``${...}``
  right-hand-side rows against the reference's ``_constraint_row``, and
  the whole spec encoding against ``encode_specs``.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu import mock as jmock
from nomad_tpu.ops import encode as jenc
from nomad_tpu.ops import kernels as jk
from nomad_tpu.parallel import make_node_mesh as jax_mesh
from nomad_tpu.parallel import sharded_placement_rounds as jax_rounds
from nomad_tpu.scheduler import Harness
from nomad_tpu.scheduler.context import EvalContext as JEvalContext
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert
from nomad_tpu_torch.ops import encode, kernels
from nomad_tpu_torch.parallel import sharded
from nomad_tpu_torch.scheduler.context import EvalContext
from test_torch_networks import assert_same, loop_problem, run_both, t

MISSING = int(jenc.MISSING)


# -- the placement loop -------------------------------------------------------

def dp_problem(seed, n=256, u=12, v=16, k_attr=2):
    """tests/test_parallel.py's DPTensors over a small value space: some
    MISSING codes, some values in use, two attribute columns."""
    base, _ = loop_problem(seed, n=n, u=u)
    rng = np.random.default_rng(seed + 1000)
    col = rng.integers(0, k_attr, u).astype(np.int32)
    active = rng.random(u) < 0.6
    active[0] = True
    used0 = rng.random((u, v)) < 0.15
    attr = rng.integers(0, v, (n, k_attr)).astype(np.int32)
    attr[rng.random((n, k_attr)) < 0.05] = MISSING
    return base, (col, active, used0, attr)


def jax_dp(dp):
    return jk.DPTensors(*[jnp.asarray(a) for a in dp])


def port_dp(dp):
    return kernels.DPTensors(*[torch.from_numpy(a) for a in dp])


@pytest.mark.parametrize("seed,slot_m", [(5, 0), (29, 0), (5, 32), (41, 32)])
def test_placement_rounds_with_dp_matches_reference(seed, slot_m):
    base, dp = dp_problem(seed)
    reads = kernels.DP_HOST_READS
    want = jk.placement_rounds(*[jnp.asarray(a) for a in base],
                               jax.random.PRNGKey(seed), dp=jax_dp(dp),
                               slot_m=slot_m)
    got = kernels.placement_rounds(*[t(a) for a in base],
                                   kernels.jitter_seed(seed), dp=port_dp(dp),
                                   slot_m=slot_m)
    np.testing.assert_array_equal(got.unplaced.numpy(),
                                  np.asarray(want.unplaced))
    np.testing.assert_array_equal(got.used_after.numpy(),
                                  np.asarray(want.used_after))
    assert got.rounds == int(want.rounds)
    if slot_m:
        np.testing.assert_array_equal(got.slots.numpy(),
                                      np.asarray(want.slots))
    else:
        placements = np.asarray(want.placements)
        np.testing.assert_array_equal(got.placements.numpy(), placements)
        assert placements[dp[1]].sum() > 0
    # One extra host read per committing distinct_property step.
    assert kernels.DP_HOST_READS > reads


def test_dedup_keeps_several_values_in_one_round():
    """Identical nodes over four values: the first round selects 12 nodes
    and keeps one per value; with every value then used, the other eight
    allocs stay unplaced, as in the reference."""
    n, v = 128, 4
    base, _ = loop_problem(9, n=n, u=1, j=1)
    base[0][:] = True
    base[1][:] = 0                      # identical nodes: scores differ by
    base[5][:] = 12                     # the jitter alone
    base[7][:] = False
    base[9][:] = 0
    attr = (np.arange(n) % v).astype(np.int32)[:, None]
    attr[::9] = MISSING
    dp = (np.zeros(1, np.int32), np.ones(1, bool), np.zeros((1, 8), bool),
          attr)
    got = kernels.placement_rounds(*[t(a) for a in base],
                                   kernels.jitter_seed(9), dp=port_dp(dp))
    want = jk.placement_rounds(*[jnp.asarray(a) for a in base],
                               jax.random.PRNGKey(9), dp=jax_dp(dp))
    np.testing.assert_array_equal(got.placements.numpy(),
                                  np.asarray(want.placements))
    assert int(got.unplaced[0]) == 12 - v and got.rounds == int(want.rounds)
    placed = np.nonzero(got.placements.numpy()[0])[0]
    assert sorted(attr[placed, 0].tolist()) == list(range(v))


def reference_dedup(sel, scored, code_c, v_pad, big):
    """kernels.py:512-525, in jnp."""
    node_idx = jnp.arange(sel.shape[0], dtype=jnp.int32)
    sel_score = jnp.where(sel, scored, jnp.float32(jk.NEG_INF))
    best = jnp.full(v_pad, jk.NEG_INF, dtype=jnp.float32).at[code_c].max(
        sel_score)
    cand = sel & (sel_score >= best[code_c])
    first = jnp.full(v_pad, big, dtype=jnp.int32).at[code_c].min(
        jnp.where(cand, node_idx, big))
    return cand & (node_idx == first[code_c])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedup_with_equal_scores_matches_reference(seed):
    """Scores drawn from three values, so many selected nodes of one
    property value tie: the lowest node index wins, as in the reference."""
    rng = np.random.default_rng(seed)
    n, v_pad = 300, 8
    sel = rng.random(n) < 0.5
    scored = rng.choice(np.array([3.5, 7.25, 7.25, -1e30], np.float32), n)
    code_c = rng.integers(0, v_pad, n).astype(np.int32)
    want = reference_dedup(jnp.asarray(sel), jnp.asarray(scored),
                           jnp.asarray(code_c), v_pad, n + 1)
    got = kernels.dp_dedup(torch.from_numpy(sel), torch.from_numpy(scored),
                           torch.from_numpy(code_c).to(torch.int64),
                           torch.arange(n, dtype=torch.int32), v_pad, n + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kept = got.numpy()
    assert len(set(code_c[kept].tolist())) == kept.sum()


@pytest.mark.parametrize("seed,d", [(5, 8), (29, 4), (41, 3)])
def test_mesh_rounds_with_dp_match_reference(seed, d):
    """The cross-shard dedup keeps the reference mesh's winners."""
    base, dp = dp_problem(seed, n=264 if d == 3 else 256)
    want = jax_rounds(jax_mesh(jax.devices()[:d]),
                      *[jnp.asarray(a) for a in base],
                      jax.random.PRNGKey(seed), k_cand=16, dp=jax_dp(dp))
    got = sharded.sharded_placement_rounds(
        sharded.make_node_mesh(["cpu"] * d), *[t(a) for a in base],
        kernels.jitter_seed(seed), k_cand=16, dp=port_dp(dp))
    np.testing.assert_array_equal(got.placements.numpy(),
                                  np.asarray(want.placements))
    np.testing.assert_array_equal(got.unplaced.numpy(),
                                  np.asarray(want.unplaced))
    assert got.rounds == int(want.rounds)
    assert np.asarray(want.placements)[dp[1]].sum() > 0


def test_mesh_rounds_with_net_and_dp_match_single_card():
    """Both branches at once on a 4-shard mesh: the single card's
    placements (k_cand covers every count, so the selection is exact)."""
    from test_torch_networks import port_net

    base, dp = dp_problem(13)
    _, net = loop_problem(13)
    one = kernels.placement_rounds(*[t(a) for a in base],
                                   kernels.jitter_seed(13), net=port_net(net),
                                   dp=port_dp(dp))
    mesh = sharded.sharded_placement_rounds(
        sharded.make_node_mesh(["cpu"] * 4), *[t(a) for a in base],
        kernels.jitter_seed(13), k_cand=64, net=port_net(net),
        dp=port_dp(dp))
    np.testing.assert_array_equal(mesh.placements.numpy(),
                                  one.placements.numpy())
    np.testing.assert_array_equal(mesh.unplaced.numpy(), one.unplaced.numpy())


# -- the batch against the reference scheduler --------------------------------

def rack_nodes(h, racks, networks=False):
    """tests/test_tpu_networks.py:rack_nodes."""
    nodes = []
    for rack in racks:
        node = jmock.node()
        if not networks:
            node.resources.networks = []
            node.reserved.networks = []
        node.meta["rack"] = rack
        node.compute_class()
        h.state.upsert_node(h.next_index(), node)
        nodes.append(node)
    return nodes


def dp_job(count, networks=False, job_level=False):
    job = jmock.job()
    tg = job.task_groups[0]
    tg.count = count
    if not networks:
        for task in tg.tasks:
            task.resources.networks = []
    con = js.Constraint("${meta.rack}", "", js.CONSTRAINT_DISTINCT_PROPERTY)
    if job_level:
        job.constraints = list(job.constraints) + [con]
    else:
        tg.constraints = list(tg.constraints) + [con]
    return job


def existing_alloc_no_net(h, job_src, node):
    alloc = jmock.alloc()
    alloc.node_id = node.id
    alloc.job = job_src
    alloc.job_id = job_src.id
    alloc.task_group = job_src.task_groups[0].name
    alloc.task_resources = {"web": js.Resources(cpu=100, memory_mb=64)}
    alloc.resources = js.Resources(cpu=100, memory_mb=64)
    h.state.upsert_allocs(h.next_index(), [alloc])
    return alloc


def racks_of(h, res, key):
    by_id = {n.id: n for n in h.state.nodes(None)}
    return [by_id[nid].meta["rack"] for nid in res.placements[key].node_ids]


def test_one_alloc_per_value(monkeypatch):
    h = Harness()
    rack_nodes(h, ["r1", "r1", "r2", "r2", "r3", "r3"])
    job = dp_job(3)
    res, before = run_both(h, [job], 11, monkeypatch)
    assert_same(res, h, [job], before)
    racks = racks_of(h, res, (job.id, "web"))
    assert sorted(racks) == ["r1", "r2", "r3"]


def test_count_beyond_the_values(monkeypatch):
    h = Harness()
    rack_nodes(h, ["r1", "r2", "r3"])
    job = dp_job(5)
    res, before = run_both(h, [job], 12, monkeypatch)
    assert_same(res, h, [job], before)
    assert res.placements[(job.id, "web")].unplaced == 2


@pytest.mark.parametrize("job_level", [False, True])
def test_existing_value_excluded(job_level, monkeypatch):
    """A live alloc of the job holds r1: the two new allocs take r2 and
    r3, with the constraint on the group or on the job."""
    h = Harness()
    nodes = rack_nodes(h, ["r1", "r2", "r3"])
    job = dp_job(3, job_level=job_level)
    h.state.upsert_job(h.next_index(), job)
    existing_alloc_no_net(h, job, nodes[0])
    res, before = run_both(h, [job], 13, monkeypatch)
    assert_same(res, h, [job], before)
    assert sorted(racks_of(h, res, (job.id, "web"))) == ["r2", "r3"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_dp_with_networks_matches_reference(seed, monkeypatch):
    """tests/test_tpu_networks.py:test_matches_oracle's random racks, with
    the network asks of mock.job() kept and two jobs in the batch."""
    h = Harness()
    rng = random.Random(seed)
    rack_nodes(h, [f"r{rng.randrange(4)}" for _ in range(12)],
               networks=True)
    jobs = [dp_job(4, networks=True), jmock.job()]
    res, before = run_both(h, jobs, seed, monkeypatch)
    assert_same(res, h, jobs, before)


def test_version_and_regexp_constraints_match_reference(monkeypatch):
    """The host-evaluated rows in a whole batch: a version constraint on
    ${attr.nomad.version}, a regexp on ${attr.kernel.name}, a set_contains
    and a ${...} right-hand side."""
    h = Harness()
    rng = random.Random(5)
    for i in range(30):
        node = jmock.node()
        node.attributes["nomad.version"] = rng.choice(
            ["0.4.1", "0.5.0", "0.5.2", "0.6.0-rc1"])
        node.attributes["kernel.name"] = rng.choice(["linux", "linux-rt",
                                                     "darwin"])
        node.attributes["features"] = rng.choice(["a,b,c", "a", "b,c"])
        node.meta["want_kernel"] = rng.choice(["linux", "darwin"])
        node.compute_class()
        h.state.upsert_node(h.next_index(), node)
    jobs = [jmock.job() for _ in range(4)]
    jobs[0].constraints = [js.Constraint("${attr.nomad.version}",
                                         ">= 0.5.0, < 0.6",
                                         js.CONSTRAINT_VERSION)]
    jobs[1].constraints = [js.Constraint("${attr.kernel.name}", "^linux",
                                         js.CONSTRAINT_REGEX)]
    jobs[2].task_groups[0].constraints = [js.Constraint(
        "${attr.features}", "a,b", js.CONSTRAINT_SET_CONTAINS)]
    jobs[3].constraints = [js.Constraint("${attr.kernel.name}",
                                         "${meta.want_kernel}", "=")]
    for j in jobs:
        j.task_groups[0].count = 6
    res, before = run_both(h, jobs, 21, monkeypatch)
    assert_same(res, h, jobs, before)


# -- the host-evaluated rows --------------------------------------------------

def row_nodes(seed):
    rng = random.Random(seed)
    nodes = []
    for i in range(60):
        n = jmock.node()
        n.attributes["nomad.version"] = rng.choice(
            ["0.4.1", "0.5.0", "0.5.2", "1.2", "v0.6.0-rc1", "bogus"])
        n.attributes["kernel.name"] = rng.choice(["linux", "linux-rt",
                                                  "darwin"])
        n.attributes["features"] = rng.choice(["a,b,c", "a", "b, c", ""])
        n.attributes["unique.hostname"] = f"host-{i}"
        n.meta["want"] = rng.choice(["linux", "darwin", "a"])
        if i % 7 == 0:
            del n.attributes["nomad.version"]          # missing value
        n.compute_class()
        nodes.append(n)
    return nodes


CONSTRAINTS = [
    ("${attr.nomad.version}", ">= 0.5.0, < 0.6", js.CONSTRAINT_VERSION),
    ("${attr.nomad.version}", "~> 0.5", js.CONSTRAINT_VERSION),
    ("${attr.nomad.version}", "not a constraint", js.CONSTRAINT_VERSION),
    ("${attr.kernel.name}", "^linux(-rt)?$", js.CONSTRAINT_REGEX),
    ("${attr.kernel.name}", "(", js.CONSTRAINT_REGEX),
    ("${attr.unique.hostname}", "-[0-3]$", js.CONSTRAINT_REGEX),
    ("${attr.features}", "a,b", js.CONSTRAINT_SET_CONTAINS),
    ("${attr.features}", "c", js.CONSTRAINT_SET_CONTAINS),
    ("${attr.kernel.name}", "${meta.want}", "="),
    ("${attr.kernel.name}", "${meta.want}", "!="),
    ("${meta.want}", "${attr.kernel.name}", "<"),
    ("${attr.missing}", "x", js.CONSTRAINT_VERSION),
]


@pytest.mark.parametrize("seed", [0, 1])
def test_constraint_rows_match_reference(seed):
    nodes = row_nodes(seed)
    pnodes = [convert.node_from_dict(dataclasses.asdict(n)) for n in nodes]
    jct = jenc.encode_cluster_static(nodes, [])
    pct = encode.encode_cluster_static(pnodes, [])
    jcache, pcache = {}, {}
    jctx, pctx = JEvalContext(state=None, plan=js.Plan()), EvalContext()
    for lt, rt, op in CONSTRAINTS:
        want = jenc._constraint_row(nodes, js.Constraint(lt, rt, op), jct,
                                    jcache, jctx)
        got = encode._constraint_row(pnodes, js.Constraint(lt, rt, op),
                                     pct, pcache, pctx)
        np.testing.assert_array_equal(got, want, err_msg=f"{lt} {op} {rt}")
    assert pcache == jcache
    assert pctx.cache.re_cache.keys() == jctx.cache.re_cache.keys()
    assert (pctx.cache.constraint_cache.keys()
            == jctx.cache.constraint_cache.keys())


def test_spec_encoding_with_host_rows_and_dp_matches_reference():
    """encode_specs on specs with host rows, distinct_property (used
    values included) and network asks: every array equal."""
    nodes = row_nodes(3)
    for i, n in enumerate(nodes):
        n.meta["rack"] = f"r{i % 5}"
        n.compute_class()
    jobs = []
    for i, (lt, rt, op) in enumerate(CONSTRAINTS):
        j = jmock.job()
        j.task_groups[0].constraints = [js.Constraint(lt, rt, op)]
        if i % 3 == 0:
            j.task_groups[0].constraints.append(js.Constraint(
                "${meta.rack}", "", js.CONSTRAINT_DISTINCT_PROPERTY))
        if i % 4 == 0:
            j.task_groups[0].tasks[0].resources.networks[0].reserved_ports = [
                js.Port("x", 21000 + i), js.Port("y", 8000 + i)]
        jobs.append(j)
    pnodes = [convert.node_from_dict(dataclasses.asdict(n)) for n in nodes]
    pjobs = [convert.job_from_dict(dataclasses.asdict(j)) for j in jobs]
    jspecs, pspecs = [], []
    for jj, pj in zip(jobs, pjobs):
        for build, job, out in ((jenc.build_spec, jj, jspecs),
                                (encode.build_spec, pj, pspecs)):
            sp = build(job, job.task_groups[0], False)
            sp.count = 3
            if sp.dp_target is not None:
                sp.dp_used_values = {"r1", "r4"}
            out.append(sp)
    jt, jl = jenc.collect_attr_targets(jspecs)
    pt, pl = encode.collect_attr_targets(pspecs)
    assert (pt, pl) == (jt, jl)
    jct = jenc.encode_cluster_static(nodes, jt, with_networks=True)
    jenc.finalize_codebooks(jct, jl)
    pct = encode.encode_cluster_static(pnodes, pt, with_networks=True)
    encode.finalize_codebooks(pct, pl)
    for name in ("attr_values", "bw_cap", "bw_used", "dyn_free",
                 "port_words"):
        np.testing.assert_array_equal(getattr(pct, name), getattr(jct, name),
                                      err_msg=name)
    jst = jenc.encode_specs(jspecs, jct, nodes)
    pst = encode.encode_specs(pspecs, pct, pnodes)
    for name in ("constraint_attr", "constraint_op", "constraint_rhs",
                 "precomp", "net_active", "net_mbits", "dyn_need",
                 "resv_words", "dp_col", "dp_active", "dp_used"):
        np.testing.assert_array_equal(getattr(pst, name), getattr(jst, name),
                                      err_msg=name)
    assert pst.precomp.shape == (pst.u_pad, pct.n_pad)
    assert pst.dp_used.any() and pst.resv_words.any()


def test_live_alloc_ports_are_derived_again_like_reference():
    """apply_alloc_usage with networks: a touched node's port set,
    bandwidth and free dynamic ports from its reserved networks and its
    live allocs' first networks."""
    nodes = [jmock.node() for _ in range(6)]
    allocs = {}
    for i in (1, 4):
        for _ in range(2):
            a = jmock.alloc()
            a.node_id = nodes[i].id
            allocs.setdefault(a.node_id, []).append(a)
    allocs[nodes[4].id][1].task_resources["web"].networks[0].dynamic_ports = [
        js.Port("http", 25000), js.Port("x", 70000)]
    jct = jenc.encode_cluster_static(nodes, [], with_networks=True)
    jct = jenc.apply_alloc_usage(jct, allocs)
    pct = encode.encode_cluster_static(
        [convert.node_from_dict(dataclasses.asdict(n)) for n in nodes], [],
        with_networks=True)
    pct = encode.apply_alloc_usage(pct, {
        nid: [convert.alloc_from_dict(dataclasses.asdict(a)) for a in lst]
        for nid, lst in allocs.items()})
    for name in ("used", "bw_used", "dyn_free", "port_words"):
        np.testing.assert_array_equal(getattr(pct, name), getattr(jct, name),
                                      err_msg=name)
    assert pct.dyn_free[4] < pct.dyn_free[0]
