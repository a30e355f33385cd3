"""Card-only checks of the port's CUDA kernels (marker ``gpu``).

They need an NVIDIA card with nvcc and skip elsewhere; run them on the
card with ``python -m pytest tests/test_torch_gpu.py -m gpu -q``.  This
file imports no jax: the card's machine has none.
"""
import numpy as np
import pytest
import torch

from eviction_inputs import edge_inputs, random_inputs
from nomad_tpu_torch.ops import fused_score, kernels
from round_inputs import port_rounds_args, random_rounds

ATOL = 4e-6    # 2 ulp of float32 at 18, the top of ScoreFit


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def inputs(u, n, seed, dev):
    g = torch.Generator().manual_seed(seed)
    cap = torch.tensor([4000, 8192, 102400, 150],
                       dtype=torch.int32).repeat(n, 1)
    used = torch.zeros((n, 4), dtype=torch.int32)
    used[:, 0] = torch.randint(0, 4200, (n,), generator=g, dtype=torch.int32)
    used[:, 1] = torch.randint(0, 8192, (n,), generator=g, dtype=torch.int32)
    denom = cap[:, :2].to(torch.float32)
    denom[torch.rand(n, generator=g) < 0.1, 0] = 0.0
    feas = torch.rand((u, n), generator=g) < 0.8
    ask = torch.tensor([500, 256, 150, 0], dtype=torch.int32).repeat(u, 1)
    penalty = torch.rand(u, generator=g) * 25.0
    coll = torch.randint(0, 3, (u, n), generator=g, dtype=torch.int32)
    return [x.to(dev) for x in (feas, used, cap, denom, ask, penalty, coll)]


def same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def check_scored(args, u_off, n_off):
    """One launch of scored_rows against its plain version on the same
    inputs: identical mask, 0 differing bits in scored and base."""
    before = fused_score.LAUNCHES
    got, got_base = fused_score.scored_rows(*args, 12345, u_offset=u_off,
                                            n_offset=n_off)
    want, want_base = fused_score.scored_rows_reference(
        *args, 12345, u_offset=u_off, n_offset=n_off)
    torch.cuda.synchronize()
    assert fused_score.LAUNCHES == before + 1
    assert torch.equal(got == -1e30, want == -1e30)
    live = want != -1e30
    assert float((got - want)[live].abs().max()) <= ATOL
    assert float((got_base - want_base).abs().max()) <= ATOL
    # The kernel and its plain version agree bit for bit.
    assert same_bits(got, want)
    assert same_bits(got_base, want_base)


# The score tile's edges: N % 4 != 0 takes the scalar path (701); U = 1,
# 7, 9 and 129 are no multiple of a row tile; the mesh's shard offsets.
EDGE_SHAPES = [(1, 701, 0, 0), (9, 701, 3, 0), (7, 10112, 0, 0),
               (9, 10112, 5, 0), (129, 10112, 0, 0),
               (9, 2528, 11, 7584), (9, 250_016, 2, 250_016)]


@pytest.mark.gpu
@pytest.mark.parametrize("u,n,u_off,n_off", [
    (1, 10112, 0, 0), (1, 10112, 37, 0), (128, 10112, 0, 0), (3, 700, 5, 0),
    # The mesh's per-shard call: one spec row over a 250,016-node shard,
    # jitter keyed on the global node index of the last of four shards.
    (1, 250_016, 77, 750_048)] + EDGE_SHAPES)
def test_scored_rows_kernel_matches_plain(u, n, u_off, n_off):
    need_card()
    check_scored(inputs(u, n, u + n + u_off, "cuda"), u_off, n_off)


@pytest.mark.gpu
@pytest.mark.parametrize("u,n", [(9, 10113), (3, 70_000)])
def test_scored_rows_kernel_on_row_views(u, n):
    """The loop passes one row of a [U, N] tensor: its start lies u·N
    bytes into feas.  With N % 4 != 0 the rows are misaligned; with an
    odd storage offset so is every row, where an aligned row of 70,000
    nodes would take the vector path.  The kernel takes its scalar path
    there and still agrees bit for bit."""
    need_card()
    feas, used, cap, denom, ask, penalty, coll = inputs(u, n, u * n, "cuda")
    shifted = torch.zeros(u * n + 1, dtype=torch.uint8, device="cuda")
    shifted[1:] = feas.view(torch.uint8).reshape(-1)
    for rows in (feas, shifted[1:].view(u, n)):
        for r in range(u):
            check_scored([rows[r:r + 1], used, cap, denom, ask[r:r + 1],
                          penalty[r:r + 1], coll[r:r + 1]], r, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("u,n,n_off", [(1, 10112, 0), (1, 250_016, 250_016),
                                       (9, 701, 0), (129, 10112, 0)])
def test_scored_rows_kernel_without_base(u, n, n_off):
    """``with_base=False`` (the loops' call when they keep no scores)
    writes the same scores, bit for bit, and no base."""
    need_card()
    args = inputs(u, n, 3 * u + n, "cuda")
    got, none = fused_score.scored_rows(*args, 777, u_offset=2,
                                        n_offset=n_off, with_base=False)
    want, _ = fused_score.scored_rows(*args, 777, u_offset=2, n_offset=n_off)
    torch.cuda.synchronize()
    assert none is None
    assert same_bits(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("u,n", [(1, 10112), (128, 10112), (3, 700),
                                 (1, 701), (9, 701), (7, 10112), (129, 10112),
                                 (9, 10113)])
def test_masked_score_kernel_matches_plain(u, n):
    need_card()
    feas, used, cap, denom, ask, penalty, coll = inputs(u, n, u + n, "cuda")
    feas[:, n - 50:] = False                  # padding columns
    before = fused_score.MASKED_LAUNCHES
    got = fused_score.masked_score_matrix(feas, used, cap, denom, ask)
    want = fused_score.masked_score_matrix_reference(feas, used, cap, denom,
                                                     ask)
    _, base = fused_score.scored_rows(feas, used, cap, denom, ask, penalty,
                                      coll, 99)
    torch.cuda.synchronize()
    assert fused_score.MASKED_LAUNCHES == before + 1
    assert torch.equal(got == -1e30, want == -1e30)
    live = want != -1e30
    assert float((got - want)[live].abs().max()) <= ATOL
    assert same_bits(got, want)
    # One shared ScoreFit: the masked score is scored_rows' base, bit for
    # bit, wherever the spec fits.
    assert same_bits(got[live], base[live])


@pytest.mark.gpu
def test_kernels_on_degenerate_denominators():
    """NaN, ±inf, negative, ±0 and tiny denominators and asks that
    overflow the fit: ScoreFit's NaN/inf rules, held bit for bit against
    the plain versions by both kernels."""
    need_card()
    u, n = 5, 4096
    args = inputs(u, n, 5, "cuda")
    odd = torch.tensor([float("nan"), float("inf"), float("-inf"), -5.0,
                        0.0, -0.0, 1e-30, 1e30], device="cuda")
    args[3] = odd[torch.randint(0, 8, (n, 2), device="cuda")]
    args[4] = torch.tensor([[500, 256, 0, 0], [0, 0, 0, 0],
                            [-100000, 5, 0, 0], [2**30, 2**30, 0, 0],
                            [7, -3, 0, 0]], dtype=torch.int32, device="cuda")
    check_scored(args, 0, 0)
    feas, used, cap, denom, ask = args[:5]
    got = fused_score.masked_score_matrix(feas, used, cap, denom, ask)
    want = fused_score.masked_score_matrix_reference(feas, used, cap, denom,
                                                     ask)
    torch.cuda.synchronize()
    assert same_bits(got, want)


@pytest.mark.gpu
def test_placement_rounds_on_card_matches_cpu():
    need_card()
    g = torch.Generator().manual_seed(4)
    u, n = 8, 2048
    cap = torch.tensor([4000, 8192, 102400, 150],
                       dtype=torch.int32).repeat(n, 1)
    used = torch.zeros((n, 4), dtype=torch.int32)
    denom = cap[:, :2].to(torch.float32)
    feas = torch.rand((u, n), generator=g) < 0.9
    ask = torch.tensor([500, 256, 150, 0], dtype=torch.int32).repeat(u, 1)
    count = torch.full((u,), 700, dtype=torch.int32)
    penalty = torch.full((u,), 20.0)
    dh = torch.zeros(u, dtype=torch.bool)
    ji = torch.arange(u, dtype=torch.int32)
    jc = torch.zeros((u, n), dtype=torch.int32)
    args = (feas, used, cap, denom, ask, count, penalty, dh, ji, jc)
    seed = kernels.jitter_seed(11)
    cpu = kernels.placement_rounds(*args, seed, slot_m=1024)
    card = kernels.placement_rounds(*(a.cuda() for a in args), seed,
                                    slot_m=1024)
    assert card.rounds == cpu.rounds
    assert torch.equal(card.slots.cpu(), cpu.slots)
    assert torch.equal(card.unplaced.cpu(), cpu.unplaced)
    assert float((card.slot_scores.cpu() - cpu.slot_scores).abs().max()) \
        <= ATOL


ROUND_OUTPUTS = ("placements", "unplaced", "used_after", "commit_scores",
                 "commit_collisions", "slots", "slot_scores", "slot_coll")


def check_round_kernel(x, seed, **opts):
    """The round kernel (``run_placement_rounds`` on the card) against the
    eager loop on the same CUDA tensors: every output bit for bit, the
    rounds, the committing steps, and one launch a round."""
    args, extra = port_rounds_args(x, "cuda")
    before = fused_score.ROUND_LAUNCHES
    got = kernels.run_placement_rounds(*args, seed, **opts, **extra)
    launches = fused_score.ROUND_LAUNCHES - before
    want = kernels.placement_rounds(*args, seed, **opts, **extra)
    torch.cuda.synchronize()
    assert (got.rounds, got.commit_steps) == (want.rounds, want.commit_steps)
    assert launches == got.rounds
    for f in ROUND_OUTPUTS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert same_bits(a, b) if a.dtype == torch.float32 \
            else torch.equal(a, b), f
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("slot_m,with_scores", [
    (0, True), (0, False), (1024, True), (1024, False)])
def test_round_kernel_matches_eager_at_config_b_width(slot_m, with_scores):
    """128 specs over 10,112 nodes (config (b)'s pads), distinct_hosts
    and shared job rows, with and without scores, matrix and slot mode."""
    need_card()
    got = check_round_kernel(random_rounds(22, 128, 10_112), 0x9E3779B9,
                             slot_m=slot_m, with_scores=with_scores)
    assert got.commit_steps > 0 and got.rounds > 1


@pytest.mark.gpu
@pytest.mark.parametrize("tight", [False, True])
def test_round_kernel_matches_eager_with_networks_and_dp(tight):
    """A networks-plus-distinct_property batch (reserved ports, bandwidth,
    dynamic ports, property values), and a capacity-exhausted one that
    ends by the min-ask exit."""
    need_card()
    x = random_rounds(23 + tight, 64, 5_000, net=True, dp=True, tight=tight)
    for slot_m in (0, 600):
        check_round_kernel(x, 12345, slot_m=slot_m, with_scores=True)


@pytest.mark.gpu
def test_round_kernel_matches_eager_on_small_edges():
    """Small batches (one partial tile of nodes, a few specs): ties from
    large penalties, counts of 0, max_rounds of 2, every mode."""
    need_card()
    for seed in range(24):
        rng = np.random.default_rng(seed)
        x = random_rounds(seed, int(rng.integers(1, 9)),
                          int(rng.integers(8, 3000)), net=seed % 3 == 1,
                          dp=seed % 4 == 2, tight=seed % 5 == 0)
        check_round_kernel(x, int(rng.integers(0, 2**32)),
                           max_rounds=int(rng.choice([256, 2])),
                           slot_m=int(rng.choice([0, 7])),
                           with_scores=bool(seed % 2))


@pytest.mark.gpu
def test_round_kernel_ends_by_the_min_ask_exit():
    """More asks than the cluster holds, one ask for every spec: the
    rounds fill the nodes and stop when none fits the smallest ask left,
    as the eager loop does, at the same round."""
    need_card()
    x = random_rounds(31, 16, 3000, tight=True)
    x["feas"][:] = True
    x["dh"][:] = False
    x["count"][:] = 12_000
    x["ask"][:] = x["ask"][0]
    got = check_round_kernel(x, 77, slot_m=0, with_scores=True)
    left = got.unplaced.cpu().numpy() > 0
    free = x["cap"] - got.used_after.cpu().numpy()
    assert left.any() and not (x["ask"][0] <= free).all(1).any()


@pytest.mark.gpu
def test_round_kernel_wrapper_refuses_bad_inputs():
    """The wrapper launches on a whole, well-typed state and refuses a
    wrong shape, dtype or device, a missing tensor and half a group."""
    need_card()
    u, n = 4, 64

    def z(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device="cuda")

    def state():
        return {"feas": z((u, n), torch.uint8), "used": z((n, 4)),
                "cap": z((n, 4)), "denom": z((n, 2), torch.float32),
                "ask": z((u, 4)), "count": z(u), "remaining": z(u),
                "penalty": z(u, torch.float32), "dh": z(u, torch.uint8),
                "ji": z(u), "job_counts": z((u, n)), "key": z(n),
                "flag": z(n, torch.uint8), "status": z(4),
                "placements": z((u, n))}

    before = fused_score.ROUND_LAUNCHES
    assert fused_score.placement_round(state(), 1).tolist() == [0, 0, 0, 0]
    assert fused_score.ROUND_LAUNCHES == before + 1
    bad = [("used", z((n, 3))), ("penalty", z(u, torch.float64)),
           ("feas", torch.zeros((u, n), dtype=torch.uint8)),
           ("key", None), ("mbits", z(u))]
    for name, value in bad:
        t = state()
        t[name] = value
        with pytest.raises((ValueError, TypeError)):
            fused_score.placement_round(t, 1)
    assert fused_score.ROUND_LAUNCHES == before + 1


@pytest.mark.gpu
def test_batch_with_networks_and_distinct_property_card_matches_cpu():
    """mock.job()s with their network asks, one of them with a
    distinct_property constraint and a version constraint, on mock.node()s
    with racks: the card's placements and offers are the CPU's, on one
    card and on a 4-shard mesh of it."""
    need_card()
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops import batch_sched
    from nomad_tpu_torch.parallel import make_node_mesh
    from nomad_tpu_torch.structs import structs as s

    nodes = []
    for i in range(300):
        node = mock.node()
        node.meta["rack"] = f"r{i % 40}"
        node.compute_class()
        nodes.append(node)
    jobs = [mock.job() for _ in range(6)]
    for j in jobs:
        j.task_groups[0].count = 150
    jobs[0].task_groups[0].constraints = [
        s.Constraint("${meta.rack}", "", s.CONSTRAINT_DISTINCT_PROPERTY)]
    jobs[1].constraints.append(s.Constraint(
        "${attr.nomad.version}", ">= 0.5.0", s.CONSTRAINT_VERSION))
    ids = [f"eval-{i}" for i in range(len(jobs))]

    def run(**where):
        return batch_sched.schedule_batch(nodes, jobs, rng_seed=17,
                                          eval_ids=ids, **where)

    def offers(res):
        return {k: (sp.node_ids, sp.unplaced,
                    [{t: (o.ip, o.mbits,
                          [p.value for p in o.dynamic_ports])
                      for t, o in nets.items()} for nets in sp.networks])
                for k, sp in res.placements.items()}

    cpu = run(device="cpu")
    assert len(cpu.placements[(jobs[0].id, "web")].node_ids) == 40
    for res in (run(device="cuda"),
                run(mesh=make_node_mesh(["cuda:0"] * 4))):
        assert offers(res) == offers(cpu)
        for k, sp in cpu.placements.items():
            assert float(abs(res.placements[k].scores - sp.scores).max()) \
                <= ATOL


# -- plans applied and fed back: the resident mirror and the re-check ---------

def mirror_world(n_nodes, dev, batches, guard_every=1, mesh=None):
    """A Harness with the port's PlanApplier, ``batches`` register batches
    of 4 jobs x 30 through TorchBatchScheduler on ``dev`` (or ``mesh``)
    with the resident mirror on; returns the harness and the stats."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops.batch_sched import TorchBatchScheduler
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.server import PlanApplier
    from nomad_tpu_torch.structs import structs as s

    h = Harness()
    h.planner = PlanApplier(h.state, device="cpu" if dev == "cpu" else
                            "cuda", next_index=h.next_index)
    for i in range(n_nodes):
        node = mock.node()
        node.id = node.name = f"node-{i:04d}"
        node.resources.networks = []
        node.reserved.networks = []
        node.compute_class()
        h.state.upsert_node(h.next_index(), node)
    brk = KernelCircuitBreaker()
    stats = []
    for b in range(batches):
        jobs = []
        for k in range(4):
            j = mock.job()
            j.id = j.name = f"job-{b}-{k}"
            j.task_groups[0].count = 30
            for t in j.task_groups[0].tasks:
                t.resources.networks = []
            h.state.upsert_job(h.next_index(), j)
            jobs.append(j)
        evals = [s.Evaluation(id=f"ev-{j.id}", priority=j.priority,
                              type=j.type, job_id=j.id,
                              triggered_by=s.EVAL_TRIGGER_JOB_REGISTER,
                              status=s.EVAL_STATUS_PENDING) for j in jobs]
        where = {"mesh": mesh} if mesh is not None else {"device": dev}
        st = TorchBatchScheduler(h.logger, h.snapshot(), h, rng_seed=b,
                                 breaker=brk, guard_every=guard_every,
                                 **where).schedule_batch(evals)
        assert st.oracle_routed == 0 and st.device_ran
        stats.append(st)
    return h, stats


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [0, 4])
def test_mirror_after_cuda_applies_equals_host_mirror(shards):
    """After N in-place CUDA applies the twin equals the host mirror bit
    for bit, and the placements equal the CPU's."""
    need_card()
    from nomad_tpu_torch.ops import resident
    from nomad_tpu_torch.parallel import make_node_mesh

    resident.reset_counters()
    mesh = make_node_mesh(["cuda:0"] * shards) if shards else None
    h, stats = mirror_world(200, "cuda", 6, mesh=mesh)
    st = resident._STATE
    parts = st.used_dev if shards else [st.used_dev]
    assert all(p.device.type == "cuda" for p in parts)
    assert len(parts) == max(1, shards)
    assert resident.DEV_INSTALLS == 1 and resident.DEV_APPLIES == 5
    assert resident.GUARD_RUNS == 5 and resident.GUARD_MISMATCHES == 0
    assert resident.DEV_GUARD_MISMATCHES == 0
    np.testing.assert_array_equal(resident.device_used_host(st.used_dev),
                                  st.used)
    card = sorted((a.job_id, a.node_id) for a in h.state.allocs(None))
    resident.reset_counters()
    hc, _ = mirror_world(200, "cpu", 6)
    assert card == sorted((a.job_id, a.node_id)
                          for a in hc.state.allocs(None))
    resident.reset_counters()


@pytest.mark.gpu
def test_delta_apply_on_cuda_equals_numpy():
    """index_add_ of unpadded delta rows, repeated rows included, on an
    int32 CUDA mirror; and the mesh route's per-shard applies."""
    need_card()
    from nomad_tpu_torch.ops import resident

    rng = np.random.default_rng(3)
    n = 10112
    host = rng.integers(0, 1000, (n, 4)).astype(np.int64)
    rows = rng.integers(0, n, 5000)
    rows[:100] = 7                                  # one row, many times
    vals = rng.integers(-50, 50, (5000, 4))
    dev_rows = [(int(r), tuple(int(x) for x in v))
                for r, v in zip(rows, vals)]
    want = host.copy()
    np.add.at(want, rows, vals)
    single = torch.from_numpy(host.astype(np.int32)).cuda()
    resident._apply_device_deltas(single, dev_rows)
    parts = [torch.from_numpy(host[i * 2528:(i + 1) * 2528].astype(
        np.int32)).cuda() for i in range(4)]
    resident._apply_device_deltas(parts, dev_rows)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(resident.device_used_host(single), want)
    np.testing.assert_array_equal(resident.device_used_host(parts), want)


@pytest.mark.gpu
@pytest.mark.parametrize("slot", [True, False])
def test_fused_pass_with_used_dev_equals_sparse_rows(slot):
    """The pass started from the lent mirror gives the packed result of
    the pass started from the sparse usage rows, and hands the mirror back
    unchanged."""
    need_card()
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops import batch_sched, encode, xfer

    nodes = []
    for i in range(700):
        node = mock.node()
        node.id = f"node-{i:04d}"
        node.resources.networks = []
        node.reserved.networks = []
        nodes.append(node)
    jobs = [mock.job() for _ in range(5)]
    for j in jobs:
        j.task_groups[0].count = 90
        for t in j.task_groups[0].tasks:
            t.resources.networks = []
    live = batch_sched.placed_allocs(batch_sched.schedule_batch(
        nodes, jobs[:2], rng_seed=1, device="cpu"), jobs[:2])
    by_node = {}
    for a in live:
        by_node.setdefault(a.node_id, []).append(a)
    specs = batch_sched._prepare_specs(jobs[2:], {})
    targets, literals = encode.collect_attr_targets(specs)
    base = batch_sched._cluster_static(nodes, targets, literals, False, 128)
    ct, touched = batch_sched._layer_usage(base, by_node)
    b = batch_sched._encode_batch(specs, nodes, base, ct, touched,
                                  lambda job_id: (), 5)
    slot_m = b.slot_m if slot else 0
    sbuf, meta_s = xfer.pack_host(b.static)
    dbuf, meta_d = xfer.pack_host(b.dyn)
    kw = dict(meta_s=meta_s, meta_d=meta_d, u_pad=b.st.u_pad,
              n_pad=ct.n_pad, with_scores=b.with_scores, max_nnz=b.max_nnz,
              slot_m=slot_m)
    static = torch.from_numpy(sbuf).cuda()
    sparse = kernels.fused_pass(static, torch.from_numpy(dbuf).cuda(), **kw)
    dyn = dict(b.dyn)
    del dyn["u_rows"], dyn["u_vals"]
    dbuf2, meta_d2 = xfer.pack_host(dyn)
    mirror = torch.from_numpy(ct.used.astype(np.int32)).cuda()
    before = mirror.clone()
    kw["meta_d"] = meta_d2
    lent = kernels.fused_pass(static, torch.from_numpy(dbuf2).cuda(),
                              used_dev=mirror, **kw)
    torch.cuda.synchronize()
    assert torch.equal(lent.buf, sparse.buf)
    assert torch.equal(mirror, before)


@pytest.mark.gpu
def test_batch_allocs_fit_on_cuda_equals_cpu():
    need_card()
    rng = np.random.default_rng(5)
    cap = torch.from_numpy(rng.integers(0, 5000, (3000, 4)).astype(np.int32))
    used = cap + torch.from_numpy(
        rng.integers(-300, 40, (3000, 4)).astype(np.int32))
    fit, dim = kernels.batch_allocs_fit(cap.cuda(), used.cuda())
    want_fit, want_dim = kernels.batch_allocs_fit(cap, used)
    assert fit.device.type == "cuda"
    assert torch.equal(fit.cpu(), want_fit)
    assert torch.equal(dim.cpu(), want_dim)


# -- the eviction-set kernel (ops/preempt.py, csrc/eviction_sets.cu) ----------

def check_eviction_sets(arrays):
    """One launch of the kernel against its plain version on the card, on
    the same inputs: 0 differing bits in every output."""
    from nomad_tpu_torch.ops import preempt

    t = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]
    before = preempt.LAUNCHES
    got = preempt.eviction_sets(*t)
    want = preempt.eviction_sets_reference(*t)
    torch.cuda.synchronize()
    assert preempt.LAUNCHES == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.float32:
            assert same_bits(g, w)
        else:
            assert torch.equal(g, w)
    return [g.cpu() for g in got]


@pytest.mark.gpu
def test_eviction_sets_kernel_matches_plain_on_edge_rows():
    need_card()
    _, feasible, _, _ = check_eviction_sets(edge_inputs())
    assert feasible.any() and not feasible[:, :3].any()


# The kernel's tile edges: the templated widths (A = 1-64, 32-node tiles)
# and the generic one (A = 3, 128 with dynamic shared memory, 1,024 with
# an 8-node tile, 12,000 read in place), U = 1 and 129 (no multiple of a
# spec chunk), N one below and above a tile multiple, misaligned rows.
@pytest.mark.gpu
@pytest.mark.parametrize("n,u,a", [(10112, 50, 8), (701, 7, 2),
                                   (1000, 129, 16), (300, 3, 64),
                                   (701, 7, 8), (700, 9, 3), (700, 9, 32),
                                   (300, 9, 128), (50, 3, 1024),
                                   (3, 2, 12000), (10112, 1, 8),
                                   (2048, 129, 16), (2047, 50, 8),
                                   (2049, 50, 8), (33, 300, 1)])
def test_eviction_sets_kernel_matches_plain(n, u, a):
    need_card()
    check_eviction_sets(random_inputs(n, u, a, seed=n + u + a))


@pytest.mark.gpu
def test_eviction_sets_wrapper_refuses_bad_inputs():
    need_card()
    from nomad_tpu_torch.ops import preempt

    arrays = [torch.from_numpy(a) for a in edge_inputs()]
    cuda = [a.cuda() for a in arrays]
    before = preempt.LAUNCHES
    bad_dtype = list(cuda)
    bad_dtype[1] = cuda[1].to(torch.int64)
    with pytest.raises(TypeError, match="used"):
        preempt.eviction_sets(*bad_dtype)
    bad_shape = list(cuda)
    bad_shape[2] = cuda[2][:-1]
    with pytest.raises(ValueError, match="denom"):
        preempt.eviction_sets(*bad_shape)
    mixed = list(cuda)
    mixed[4] = arrays[4]           # sizes left on the CPU
    with pytest.raises(ValueError, match="sizes"):
        preempt.eviction_sets(*mixed)
    strided = list(cuda)
    strided[0] = torch.cat([cuda[0], cuda[0]], dim=1)[:, :4]
    with pytest.raises(ValueError, match="contiguous"):
        preempt.eviction_sets(*strided)
    assert preempt.LAUNCHES == before


@pytest.mark.gpu
def test_one_eviction_launch_per_preempting_batch():
    """A preempting batch on the card launches the kernel once and makes
    the CPU's plans; a batch with nothing to preempt launches nothing."""
    need_card()
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops import preempt
    from nomad_tpu_torch.ops.batch_sched import TorchBatchScheduler
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.structs import structs as ps

    def world(dev):
        h = Harness()
        filler = mock.job()
        filler.id = "filler"
        filler.priority = 20
        filler.task_groups[0].count = 0
        h.state.upsert_job(h.next_index(), filler)
        for i in range(6):
            n = mock.node()
            n.id = f"node-{i}"
            n.resources.networks = []
            n.reserved.networks = []
            h.state.upsert_node(h.next_index(), n)
            h.state.upsert_allocs(h.next_index(), [ps.Allocation(
                id=f"f-{i}-{k}", job_id=filler.id, job=filler, node_id=n.id,
                task_group="web", resources=ps.Resources(cpu=1200,
                                                         memory_mb=2500))
                for k in range(3)])
        launches = []
        # The second batch fits without an eviction: no unplaced ask.
        for b, (prio, count, cpu) in enumerate(((70, 4, 1000),
                                                (50, 1, 100))):
            job = mock.job()
            job.id = f"job-{b}"
            job.priority = prio
            job.task_groups[0].count = count
            for tk in job.task_groups[0].tasks:
                tk.resources = ps.Resources(cpu=cpu, memory_mb=cpu * 2)
            h.state.upsert_job(h.next_index(), job)
            ev = ps.Evaluation(id=f"ev-{b}", priority=prio, type=job.type,
                               triggered_by=ps.EVAL_TRIGGER_JOB_REGISTER,
                               job_id=job.id, status=ps.EVAL_STATUS_PENDING)
            before = preempt.LAUNCHES
            st = TorchBatchScheduler(
                h.logger, h.snapshot(), h, device=dev, rng_seed=3,
                breaker=KernelCircuitBreaker(),
                preemption_enabled=True).schedule_batch([ev])
            launches.append((preempt.LAUNCHES - before, st.preempt_placed))
        victims = sorted((n, sorted(a.id for a in v)) for p in h.plans
                         for n, v in p.node_preemptions.items())
        return launches, victims

    card, cpu = world("cuda"), world("cpu")
    assert card[0] == [(1, 4), (0, 0)]
    assert cpu[0] == [(0, 4), (0, 0)]
    assert card[1] == cpu[1] and card[1]


@pytest.mark.gpu
def test_server_path_on_the_card_equals_the_cpu():
    """``chip_smoke.py`` phase ``server`` at a small size: jobs through
    the port's ``Server`` on the card and on the CPU (config (d)'s system
    job, two register waves whose leftovers block, the nodes that unblock
    them, nodes down, a deregistration, the preempting drill): the same
    committed allocs and eval statuses, one round-kernel launch a round
    with the batches' committing steps, one ``eviction_sets`` launch in
    the drill, the
    breaker closed, no nack; every server shut down."""
    need_card()
    import chip_smoke

    got = chip_smoke.phase_server(
        "cuda", n_nodes=200, n_jobs=20, count=100, follow_jobs=3,
        follow_count=20, extra_nodes=200, n_down=3, drill_nodes=16)
    assert got["card_equals_cpu"]
    assert got["system_allocs"] == 200
    assert got["config_b_placed"] == 2000 and got["config_b_blocked"] > 0
    assert got["drill_evicted"] == 8
    assert got["launches"]["drill"]["eviction_sets"] == 1
    assert chip_smoke.launches_ok(got["launches"]["main"])


@pytest.mark.gpu
def test_columnar_server_batch_on_the_card_equals_the_cpu():
    """One register wave through the port's ``Server`` with its store's
    columnar mirror and every guard at every read
    (``columnar_guard_every=1``), on the card and on the CPU: the same
    committed allocs and eval statuses, every plan re-checked on the
    applier's columnar route and double-checked by its guard, no guard
    mismatch."""
    need_card()
    import chip_smoke
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.state import columnar

    nodes = []
    for i in range(300):
        n = chip_smoke.strip_node(mock.node())
        n.id = f"node-{i:05d}"
        nodes.append(n)
    jobs = []
    for k in range(8):
        j = chip_smoke.strip_job(mock.job(), 50)
        j.id = j.name = f"job-{k:03d}"
        jobs.append(j)

    def run(dev):
        columnar.reset_counters()
        # Made before the ids are seeded: a store lineage of its own, so
        # the CPU's run never reads the card's caches.
        srv = Server(ServerConfig(
            device=dev, rng_seed=5, min_heartbeat_ttl=3600.0,
            breaker=KernelCircuitBreaker(), columnar_guard_every=1))
        with chip_smoke.seeded_ids(5):
            try:
                srv.start()
                for n in nodes:
                    srv.node_register(n)
                chip_smoke.server_wave(srv, "wave", lambda s: [
                    s.job_register(j) for j in jobs])
                return (chip_smoke.server_content(srv),
                        dict(srv.plan_applier.stats),
                        chip_smoke.columnar_counters())
            finally:
                srv.shutdown()

    card, cpu = run("cuda"), run("cpu")
    assert card[0] == cpu[0]
    assert len([a for a in card[0]["allocs"] if a[3] == "run"]) == 400
    for content, app, counts in (card, cpu):
        assert app["columnar"] == app["columnar_guards"] == app["plans"] > 0
        assert counts["GUARD_RUNS"] > 0 and counts["USAGE_GUARD_RUNS"] > 0
        assert counts["GUARD_MISMATCHES"] == 0
        assert counts["USAGE_GUARD_MISMATCHES"] == 0


@pytest.mark.gpu
def test_annotate_plan_batch_on_the_card_equals_the_cpu():
    """``chip_smoke.py`` phase ``plan`` at a small size: annotate-plan
    evals (count, env and constraint edits, new jobs) in one batch over a
    snapshot, on the card and on the CPU: the same plans, annotations and
    eval updates, the round kernel once a round and no ``scored_rows``
    launch, its committing steps the batch's and inside the bounds read
    from what it placed, no oracle route, the store untouched;
    ``Server.job_plan`` on the card equals the CPU's."""
    need_card()
    import chip_smoke

    got = chip_smoke.phase_plan("cuda", n_nodes=300, n_jobs=30, count=80,
                                n_new=5, server_nodes=100)
    assert got["card_equals_cpu"] and got["store_untouched"]
    assert got["plans"] == got["evals"] == 25
    assert got["oracle_routed"] == 0
    assert got["placement_rounds_launches"] == got["rounds_run"] \
        == got["rounds"] > 0
    assert got["scored_rows_launches"] == 0
    lo, hi = got["steps_bounds"]
    assert 0 < lo <= got["committing_spec_steps"] <= hi
    assert got["committing_spec_steps"] == got["batch_commit_steps"]
    assert got["by_kind"]["new"]["place"] == 5 * 80


@pytest.mark.gpu
def test_gpu_fingerprint_and_tracer_on_the_card(tmp_path):
    """``GPUFingerprint`` publishes the card as ``torch.cuda`` sees it;
    a ``DeviceTracer`` session on the card (its default device) records
    one ``scored_rows`` kernel event per launch."""
    need_card()
    import json
    import os

    from nomad_tpu_torch.client import ClientConfig
    from nomad_tpu_torch.client.fingerprint import GPUFingerprint
    from nomad_tpu_torch.structs import structs as ps
    from nomad_tpu_torch.utils.profiling import DeviceTracer

    node = ps.Node()
    cfg = ClientConfig(options={"fingerprint.gpu.enable": "true"})
    assert GPUFingerprint().fingerprint(cfg, node)
    assert node.attributes == {
        "gpu.count": str(torch.cuda.device_count()),
        "gpu.type": torch.cuda.get_device_name(0), "driver.gpu": "1"}

    tracer = DeviceTracer(base_dir=str(tmp_path))
    assert tracer.device.type == "cuda"
    args = inputs(9, 10112, 5, "cuda")
    before = fused_score.LAUNCHES
    tracer.start()
    with pytest.raises(RuntimeError, match="already active"):
        tracer.start()
    for _ in range(3):
        fused_score.scored_rows(*args, 12345)
    info = tracer.stop()
    assert fused_score.LAUNCHES == before + 3
    with open(os.path.join(info["dir"], DeviceTracer.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    kernels_seen = [e for e in events if e.get("cat") == "kernel"
                    and "scored_rows" in e.get("name", "")]
    assert len(kernels_seen) == 3


@pytest.mark.gpu
def test_fingerprint_path_on_the_card():
    """``chip_smoke.py`` phase ``fingerprint`` at a small size: jobs
    constrained on the fingerprinted ``${attr.gpu.type}`` placed only on
    the nodes that carry it, card = CPU, as many kernel events in the
    session's trace as launches counted."""
    need_card()
    import chip_smoke

    got = chip_smoke.phase_fingerprint("cuda", n_nodes=400, n_jobs=4,
                                       count=60)
    assert got["placed"] == 240 and got["off_fingerprinted_nodes"] == 0
    assert got["card_equals_cpu"] and got["second_start_refused"]
    assert (got["trace_round_kernel_events"]
            == got["placement_rounds_launches"] > 0)
    assert got["scored_rows_launches"] == 0
    lo, hi = got["steps_bounds"]
    assert 0 < lo <= got["committing_spec_steps"] <= hi


@pytest.mark.gpu
def test_traced_batch_on_the_card():
    """One batch on the card with the tracing plane armed: the
    ``batch.schedule`` root holds every phase span, one ``batch.fetch``,
    and a ``batch.device`` as long as the batch's ``device_seconds`` (the
    CUDA-event interval) with its rounds; the placements equal the
    untraced CPU batch's."""
    need_card()
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops.batch_sched import TorchBatchScheduler
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.structs import structs as ps
    from nomad_tpu_torch.utils import tracing

    def world(dev, traced):
        h = Harness()
        for i in range(64):
            n = mock.node()
            n.id = f"node-{i:02d}"
            n.resources.networks = []
            n.reserved.networks = []
            h.state.upsert_node(h.next_index(), n)
        evals = []
        for k in range(4):
            job = mock.job()
            job.id = f"job-{k}"
            job.task_groups[0].count = 20
            for tk in job.task_groups[0].tasks:
                tk.resources.networks = []
            h.state.upsert_job(h.next_index(), job)
            evals.append(ps.Evaluation(
                id=f"ev-{k}", priority=job.priority, type=job.type,
                triggered_by=ps.EVAL_TRIGGER_JOB_REGISTER, job_id=job.id,
                status=ps.EVAL_STATUS_PENDING))
        if traced:
            tracing.enable()
        try:
            st = TorchBatchScheduler(
                h.logger, h.snapshot(), h, device=dev, rng_seed=3,
                breaker=KernelCircuitBreaker()).schedule_batch(evals)
            spans = tracing.trace_for_eval("ev-0")
        finally:
            tracing.disable()
        placed = sorted((a.job_id, a.name, a.node_id)
                        for a in h.state.allocs(None))
        return st, spans, placed

    st, spans, placed = world("cuda", True)
    _, none, want = world("cpu", False)
    assert none == [] and placed == want and len(placed) == 80
    (root,) = [sp for sp in spans if sp["Name"] == "batch.schedule"]
    kids = [sp for sp in spans if sp["ParentID"] == root["SpanID"]]
    names = [sp["Name"] for sp in kids]
    for n in ("batch.phase1", "batch.phase2", "batch.encode",
              "batch.device", "batch.metrics", "batch.finalize"):
        assert names.count(n) == 1, (n, names)
    assert names.count("batch.fetch") == 1
    (dev_span,) = [sp for sp in kids if sp["Name"] == "batch.device"]
    assert abs((dev_span["End"] - dev_span["Start"])
               - st.device_seconds) < 1e-6
    assert dev_span["Attrs"]["rounds"] == st.rounds
    assert st.device_seconds > 0


@pytest.mark.gpu
def test_trace_path_on_the_card_equals_the_cpu():
    """``chip_smoke.py`` phase ``trace`` at a small size: complete
    lifecycles, one fetch and the device span per batch, the stream
    monotone and never shed, a round-kernel launch a round, the drill's
    one eviction launch under its ``batch.preempt``, card = CPU on the
    trace's and the stream's multisets, and the same copies and syncs
    armed and disarmed."""
    need_card()
    import chip_smoke

    got = chip_smoke.phase_trace("cuda", n_nodes=300, n_jobs=10, count=100,
                                 follow_jobs=3, follow_count=20,
                                 drill_nodes=16, turns=1)
    assert got["card_equals_cpu"]
    assert got["main"]["acked_evals"] == 13
    assert got["preempt"]["eviction_sets"] == 1
    assert chip_smoke.launches_ok(got["launches"]["main"])
    sync = got["sync"]
    assert sync["armed"]["syncs"] == sync["disarmed"]["syncs"]


@pytest.mark.gpu
def test_cluster_path_on_the_card_equals_the_cpu():
    """``chip_smoke.py`` phase ``cluster`` at a small size: a 3-server
    cluster on the card through the failover script equals the same
    cluster on the CPU after every step, its survivors' fingerprints
    agree, one round-kernel launch a round on the old leader and on the
    new one, and follower-read scheduling keeps its
    invariants with the leader killed mid-drain."""
    need_card()
    import chip_smoke

    got = chip_smoke.phase_cluster(
        "cuda", sizes={"n_nodes": 300, "n_jobs": 10, "count": 100,
                       "wave_jobs": 4, "wave_count": 20, "follow_jobs": 3},
        leg2_sizes={"n_nodes": 200, "n_jobs": 40, "count": 4})
    assert got["a_equals_c"] and got["fingerprints_equal"]
    for part in ("A_before_failover", "A_after_failover", "leg2"):
        assert chip_smoke.launches_ok(got["launches"][part]), part
    assert got["new_leader_applied"] >= got["acked_index"]


@pytest.mark.gpu
def test_lifecycle_path_on_the_card_equals_the_cpu():
    """``chip_smoke.py`` phase ``lifecycle`` at a small size: periodic and
    parameterized batch jobs in two namespaces, the quota drill, the
    completions, a force-gc core eval and a second wave on the card equal
    the CPU's, with one round-kernel launch a round in each wave."""
    need_card()
    import chip_smoke

    got = chip_smoke.phase_lifecycle(
        "cuda", sizes={"n_nodes": 300, "n_prod": 3, "n_periodic": 4,
                       "count": 20, "n_dispatch": 4, "quota": 200,
                       "wave2_dispatch": 2, "timer_count": 10})
    assert got["card_equals_cpu"]
    assert got["quota_drill"]["admitted"] == 2
    assert got["eval_deleted_events"] == got["deleted"]["evals"] > 0
    for wave in ("wave1", "wave2"):
        c = got["launches"][wave]
        assert chip_smoke.launches_ok(c), wave
        assert c["eviction_sets"] == 0


@pytest.mark.gpu
def test_loadgen_smoke_on_the_card():
    """The load harness's ``smoke`` scenario through the port's server on
    the card (``chip_smoke.py`` phase ``loadgen`` at that size): every
    submission complete, each job its count, a clean strict sweep, no
    nack and no oracle route, one SLO bundle, one round-kernel launch a
    round, and the breaker drill's one ``breaker.open`` bundle."""
    need_card()
    from dataclasses import replace

    import chip_smoke
    from nomad_tpu_torch import device
    from nomad_tpu_torch.loadgen.scenario import get_scenario

    device.build_kernels()
    # Arrivals over 8 s (80 submissions at 10/s, measured over 12 s), so
    # several metrics ticks (1 s) fall inside the run after the card's
    # first batch (about a second): the SLO watch fires, and the sampler
    # takes enough non-idle samples for its 80 % coverage bound.  At 30
    # submissions over 3 s both were chance (ROADMAP queue 3 item 27).
    got = chip_smoke.phase_loadgen(
        "cuda", replace(get_scenario("smoke"), arrival_rate=10.0,
                        max_submissions=80, measure_s=12.0))
    base = got["launches"]["baseline"]
    assert chip_smoke.launches_ok(base)
    assert base["eviction_sets"] == base["masked_score_matrix"] == 0
    assert got["baseline"]["coverage"] >= 0.80
    assert got["shape_parity"]["max_abs_err"] <= ATOL
    drill = got["launches"]["breaker_drill"]
    assert drill["placement_rounds"] == drill["rounds_run"] > 0
    assert drill["committing_spec_steps"] > 0 and drill["scored_rows"] == 0
    assert chip_smoke.steps_in_bounds(drill)


@pytest.mark.gpu
def test_agent_path_on_the_card_equals_the_cpu():
    """``chip_smoke.py`` phase ``agent`` at a small size: HCL jobs through
    the CLI and HTTP into an agent's server on the card place as the same
    jobs through ``Server.job_register`` on the card and as the agent on
    the CPU, with one round-kernel launch a round and the blocking query
    woken by the commit."""
    need_card()
    import chip_smoke

    got = chip_smoke.phase_agent(
        "cuda", sizes={"n_nodes": 200, "n_rpc": 20, "n_jobs": 6,
                       "count": 60})
    assert got["placements_equal"] and got["placed"] > 0
    assert chip_smoke.launches_ok(got["launches"]["agent"])
    assert got["A_http"]["blocking"]["allocations"]["after_release"]


@pytest.mark.gpu
def test_guard_plane_drills_on_the_card():
    """``chip_smoke.py`` phase ``drills`` on the card: the thirteen drills
    of ``--selfcheck`` (the chaos drill among them) pass, the round
    kernel runs once a round of the single card's batches, ``scored_rows``
    once per committing step and shard of the mesh drill's, and the
    sanitized corpus reports ``clean`` or a skip
    with its reason."""
    need_card()
    import chip_smoke

    got = chip_smoke.phase_drills("cuda")
    assert len(got["drills"]) == 13 and all(got["drills"].values())
    la = got["launches"]
    assert la["scored_rows"] == got["mesh_committing_steps_x_shards"] > 0
    assert la["placement_rounds"] == la["rounds_run"] > 0
    assert la["committing_spec_steps"] == got["committing_steps"]
    assert la["steps_lo"] > 0
    assert got["sanitized_corpus"] == "clean" or got[
        "sanitized_corpus"].startswith("skip: ")


@pytest.mark.gpu
def test_native_decode_on_a_card_batch_equals_the_twin():
    """A card batch's fetched result decoded by ``native/decode.cc`` and
    by the numpy twins (``chip_smoke.decode_routes``): equal outputs."""
    need_card()
    import chip_smoke
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops import batch_sched

    nodes = [chip_smoke.strip_node(mock.node()) for _ in range(500)]
    jobs = [chip_smoke.strip_job(mock.job(), 40) for _ in range(8)]
    with chip_smoke.recorded_decodes(1) as fetched:
        batch_sched.schedule_batch(nodes, jobs, device="cuda", rng_seed=3)
    (row,) = chip_smoke.decode_routes(fetched, ["batch"])
    assert row["native_equals_twin"] and row["placed"] == 320


@pytest.mark.gpu
def test_gpu_fingerprinted_client_runs_a_gpu_job(tmp_path, monkeypatch):
    """A port client with ``fingerprint.gpu.enable`` registers with a
    server on the card, publishing ``gpu.type``; a job constrained on
    ``${attr.gpu.type}`` is placed there by ``scored_rows`` and runs on
    the mock driver to completion.  The cloud metadata fingerprints'
    probes stay on the machine (connections off the loopback refused)."""
    need_card()
    import socket

    import chip_smoke

    real = socket.create_connection

    def local_only(address, *args, **kwargs):
        if address[0] not in ("127.0.0.1", "localhost"):
            raise OSError("no network in this test")
        return real(address, *args, **kwargs)

    monkeypatch.setattr(socket, "create_connection", local_only)
    from nomad_tpu_torch.client import Client, ClientConfig
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.structs import structs as s
    from nomad_tpu_torch.utils.backoff import wait_until

    card = torch.cuda.get_device_name(0)
    srv = Server(ServerConfig(device="cuda", rng_seed=7,
                              min_heartbeat_ttl=3600.0,
                              breaker=KernelCircuitBreaker()))
    srv.start()
    c = Client(ClientConfig(node_id="gpu-node", node_class="gpu",
                            cpu_total_compute=4000, alloc_dir=str(tmp_path),
                            options={"fingerprint.gpu.enable": "true"}),
               rpc=srv, heartbeat_stagger=0.1)
    try:
        assert c.node.attributes["gpu.type"] == card
        c.start()
        assert wait_until(lambda: (srv.node_get("gpu-node") or s.Node())
                          .status == "ready", 30.0)
        chip_smoke.zero_counts()
        job = s.Job(id="on-gpu", name="on-gpu", type="batch",
                    datacenters=["dc1"],
                    constraints=[s.Constraint("${attr.gpu.type}", card, "=")],
                    task_groups=[s.TaskGroup(
                        name="g", count=2, tasks=[s.Task(
                            name="t", driver="mock_driver",
                            config={"run_for": "100ms"},
                            resources=s.Resources(cpu=100, memory_mb=64))],
                        restart_policy=s.RestartPolicy(attempts=0,
                                                       mode="fail"),
                        ephemeral_disk=s.EphemeralDisk(size_mb=10))])
        srv.job_register(job)
        assert wait_until(lambda: len(srv.state.allocs(None)) == 2 and all(
            a.client_status == "complete" for a in srv.state.allocs(None)),
            60.0)
        assert {a.node_id for a in srv.state.allocs(None)} == {"gpu-node"}
        # The round kernel once a round, no score kernel, its committing
        # steps inside the bounds read from what it placed (before the
        # round kernel: one scored_rows launch a committing step).
        counts = chip_smoke.loop_counts()
        assert counts["placement_rounds_launches"] == counts[
            "rounds_run"] > 0
        assert counts["scored_rows_launches"] == 0
        assert counts["committing_spec_steps"] > 0
        assert chip_smoke.steps_in_bounds(counts)
    finally:
        c.shutdown()
        srv.shutdown()


@pytest.mark.gpu
def test_exec_task_through_a_client_of_a_card_server(tmp_path, monkeypatch):
    """A port client registers with a server on the card; an ``exec``
    job is placed by ``scored_rows`` and runs for real under its
    supervisor (the default ``ClientConfig``: no cgroup, the RLIMIT_AS
    cap): exit code 0, its interpolated stdout in the alloc's log dir,
    and no supervisor or task left once the client has shut down."""
    need_card()
    import json
    import socket

    import chip_smoke

    real = socket.create_connection

    def local_only(address, *args, **kwargs):
        if address[0] not in ("127.0.0.1", "localhost"):
            raise OSError("no network in this test")
        return real(address, *args, **kwargs)

    monkeypatch.setattr(socket, "create_connection", local_only)
    from nomad_tpu_torch.client import Client, ClientConfig
    from nomad_tpu_torch.client.driver.executor import pid_alive
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.structs import structs as s
    from nomad_tpu_torch.utils.backoff import wait_until

    srv = Server(ServerConfig(device="cuda", rng_seed=7,
                              min_heartbeat_ttl=3600.0,
                              breaker=KernelCircuitBreaker()))
    srv.start()
    c = Client(ClientConfig(node_id="exec-node", node_class="exec",
                            cpu_total_compute=4000, alloc_dir=str(tmp_path)),
               rpc=srv, heartbeat_stagger=0.1)
    pids = []
    try:
        assert c.node.attributes["driver.exec"] == "1"
        c.start()
        assert wait_until(lambda: (srv.node_get("exec-node") or s.Node())
                          .status == "ready", 30.0)
        chip_smoke.zero_counts()
        job = s.Job(id="exec-job", name="exec-job", type="batch",
                    datacenters=["dc1"], task_groups=[s.TaskGroup(
                        name="g", count=2, tasks=[s.Task(
                            name="t", driver="exec",
                            config={"command": "/bin/sh", "args": [
                                "-c", 'echo "$NOMAD_ALLOC_INDEX '
                                '${NOMAD_TASK_NAME}"']},
                            resources=s.Resources(cpu=100, memory_mb=64))],
                        restart_policy=s.RestartPolicy(attempts=0,
                                                       mode="fail"),
                        ephemeral_disk=s.EphemeralDisk(size_mb=10))])
        srv.job_register(job)
        assert wait_until(lambda: len(srv.state.allocs(None)) == 2 and all(
            a.client_status == "complete" for a in srv.state.allocs(None)),
            60.0)
        # The round kernel once a round, no score kernel, its committing
        # steps inside the bounds read from what it placed (before the
        # round kernel: one scored_rows launch a committing step).
        counts = chip_smoke.loop_counts()
        assert counts["placement_rounds_launches"] == counts[
            "rounds_run"] > 0
        assert counts["scored_rows_launches"] == 0
        assert counts["committing_spec_steps"] > 0
        assert chip_smoke.steps_in_bounds(counts)
        outs = set()
        for a in srv.state.allocs(None):
            ev = a.task_states["t"].events
            assert [e.type for e in ev] == ["Received", "Started",
                                            "Terminated"]
            assert ev[-1].exit_code == 0
            adir = tmp_path / a.id
            outs.add((adir / "alloc" / "logs" / "t.stdout.0").read_text())
            ctl = adir / "t" / ".t.executor"
            pids += [json.loads((ctl / f).read_text())["pid"]
                     for f in ("supervisor.pid", "task.pid")]
        assert outs == {"0 t\n", "1 t\n"}
    finally:
        c.shutdown()
        srv.shutdown()
    assert len(pids) == 4 and not any(pid_alive(p) for p in pids)
