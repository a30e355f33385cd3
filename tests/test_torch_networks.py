"""Network asks in the port against the JAX reference on the CPU.

- The placement loop with ``net=``: the port's ``placement_rounds``
  against ``nomad_tpu.ops.kernels.placement_rounds`` with ``NetTensors``
  on the same numpy inputs -- placements, unplaced counts, rounds and the
  slot record exact; commit scores within 1e-5.
- The batch: ``schedule_batch(device="cpu")`` against the reference's
  ``TPUBatchScheduler`` in a ``Harness``, with a pinned
  ``NOMAD_TPU_RNG_SEED`` and the reference's evaluation ids, on the
  scenarios of ``tests/test_tpu_networks.py`` and on unmodified
  ``mock.job()``s over ``mock.node()``s: placements identical,
  AllocMetric scores within 1e-5, every network offer (device, IP,
  Mbit/s, every port) identical.
- What the reference sends to its CPU oracle raises
  ``NotImplementedError`` here.
- The mesh: ``sharded_placement_rounds`` with ``net=`` against the
  reference's, and ``schedule_batch(mesh=...)`` against the reference's
  single-chip batch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu import mock as jmock
from nomad_tpu.ops import batch_sched as jbatch
from nomad_tpu.ops import kernels as jk
from nomad_tpu.ops import xfer as jxfer
from nomad_tpu.ops.batch_sched import TPUBatchScheduler
from nomad_tpu.ops.breaker import KernelCircuitBreaker
from nomad_tpu.parallel import make_node_mesh as jax_mesh
from nomad_tpu.parallel import sharded_placement_rounds as jax_rounds
from nomad_tpu.scheduler import Harness
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert
from nomad_tpu_torch.ops import batch_sched, fused_score, kernels, xfer
from nomad_tpu_torch.parallel import sharded

SCORE_ATOL = 1e-5


# -- the placement loop -------------------------------------------------------

def loop_problem(seed, n=256, u=12, j=6, w=4):
    """tests/test_parallel.py's full problem and small-port-space
    NetTensors (W = 4 words): per-spec bandwidth, reserved-port and
    dynamic asks, per-node port state, nodes without a network device."""
    rng = np.random.default_rng(seed)
    capacity = np.tile(np.array([4000, 8192, 102400, 150], np.int32), (n, 1))
    used = np.zeros((n, 4), np.int32)
    used[:, 0] = rng.integers(0, 2000, n)
    used[:, 1] = rng.integers(0, 4096, n)
    denom = capacity[:, :2].astype(np.float32)
    feas = rng.random((u, n)) < 0.7
    ask = np.stack([np.array([rng.integers(200, 900), rng.integers(128, 1024),
                              150, 0], np.int32) for _ in range(u)])
    count = np.minimum(rng.integers(4, 24, u), 16).astype(np.int32)
    penalty = np.where(rng.random(u) < 0.5, 20.0, 10.0).astype(np.float32)
    distinct = rng.random(u) < 0.3
    job_index = rng.integers(0, j, u).astype(np.int32)
    job_counts = (rng.random((j, n)) < 0.05).astype(np.int32)
    base = [feas, used, capacity, denom, ask, count, penalty, distinct,
            job_index, job_counts]

    active = rng.random(u) < 0.7
    mbits = np.where(active, rng.integers(10, 200, u), 0).astype(np.int32)
    dyn_need = np.where(active, rng.integers(0, 3, u), 0).astype(np.int32)
    resv_words = np.zeros((u, w), dtype=np.uint32)
    for i in range(u):
        if active[i] and rng.random() < 0.6:
            bit = int(rng.integers(0, 32 * w))
            resv_words[i, bit // 32] |= np.uint32(1 << (bit % 32))
    resv_words[0, 1] |= np.uint32(1 << 31)            # the sign bit
    bw_cap = rng.integers(100, 1000, n).astype(np.int32)
    bw_cap[rng.random(n) < 0.1] = -1                  # no network device
    bw_used = rng.integers(0, 100, n).astype(np.int32)
    dyn_free = rng.integers(0, 50, n).astype(np.int32)
    port_words = np.zeros((n, w), dtype=np.uint32)
    for i in range(n):
        for _ in range(int(rng.integers(0, 4))):
            bit = int(rng.integers(0, 32 * w))
            port_words[i, bit // 32] |= np.uint32(1 << (bit % 32))
    port_words[::7, 1] |= np.uint32(1 << 31)
    net = (active, mbits, dyn_need, resv_words, bw_cap, bw_used, dyn_free,
           port_words)
    return base, net


def jax_net(net):
    return jk.NetTensors(*[jnp.asarray(a) for a in net])


def port_net(net):
    return kernels.NetTensors(*[torch.from_numpy(
        a.view(np.int32) if a.dtype == np.uint32 else a) for a in net])


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed,slot_m", [(3, 0), (17, 0), (3, 32), (29, 32)])
def test_placement_rounds_with_net_matches_reference(seed, slot_m):
    base, net = loop_problem(seed)
    want = jk.placement_rounds(*[jnp.asarray(a) for a in base],
                               jax.random.PRNGKey(seed), net=jax_net(net),
                               slot_m=slot_m)
    got = kernels.placement_rounds(*[t(a) for a in base],
                                   kernels.jitter_seed(seed),
                                   net=port_net(net), slot_m=slot_m)
    np.testing.assert_array_equal(got.unplaced.numpy(),
                                  np.asarray(want.unplaced))
    np.testing.assert_array_equal(got.used_after.numpy(),
                                  np.asarray(want.used_after))
    assert got.rounds == int(want.rounds)
    if slot_m:
        np.testing.assert_array_equal(got.slots.numpy(),
                                      np.asarray(want.slots))
        np.testing.assert_array_equal(got.slot_coll.numpy(),
                                      np.asarray(want.slot_coll))
        np.testing.assert_allclose(got.slot_scores.numpy(),
                                   np.asarray(want.slot_scores),
                                   atol=SCORE_ATOL, rtol=0)
    else:
        placements = np.asarray(want.placements)
        np.testing.assert_array_equal(got.placements.numpy(), placements)
        np.testing.assert_allclose(got.commit_scores.numpy(),
                                   np.asarray(want.commit_scores),
                                   atol=SCORE_ATOL, rtol=0)
        # The network branch ran: some net-active spec placed.
        assert placements[net[0]].sum() > 0


def test_network_mask_refuses_what_the_reference_refuses():
    """A node without a network device refuses even a 0 Mbit/s ask; a
    reserved port held at bit 31 of a word blocks the node.  The
    reference places the same three allocs."""
    n = 128
    base, _ = loop_problem(5, n=n, u=1, j=1)
    base[0][:] = True
    base[5][:] = 3
    base[7][:] = False
    base[9][:] = 0
    bw_cap = np.full(n, 1000, np.int32)
    bw_cap[:100] = -1
    port_words = np.zeros((n, 4), np.uint32)
    port_words[100:110, 2] = np.uint32(1 << 31)
    resv = np.zeros((1, 4), np.uint32)
    resv[0, 2] = np.uint32(1 << 31)
    net = (np.ones(1, bool), np.zeros(1, np.int32), np.zeros(1, np.int32),
           resv, bw_cap, np.zeros(n, np.int32), np.full(n, 40000, np.int32),
           port_words)
    got = kernels.placement_rounds(*[t(a) for a in base],
                                   kernels.jitter_seed(7), net=port_net(net))
    want = jk.placement_rounds(*[jnp.asarray(a) for a in base],
                               jax.random.PRNGKey(7), net=jax_net(net))
    np.testing.assert_array_equal(got.placements.numpy(),
                                  np.asarray(want.placements))
    placed = np.nonzero(got.placements.numpy()[0])[0]
    assert len(placed) == 3 and (placed >= 110).all()


# -- the batch against the reference scheduler --------------------------------

def reg_eval(job):
    return js.Evaluation(
        id=js.generate_uuid(), priority=job.priority, type=job.type,
        triggered_by=js.EVAL_TRIGGER_JOB_REGISTER, job_id=job.id,
        status=js.EVAL_STATUS_PENDING)


def make_nodes(h, n, mbits=1000):
    """tests/test_tpu_networks.py:make_nodes: one /32 device each, no
    reserved networks."""
    nodes = []
    for i in range(n):
        node = jmock.node()
        node.resources.networks = [js.NetworkResource(
            device="eth0", cidr=f"192.168.0.{100 + i}/32", mbits=mbits)]
        node.reserved.networks = []
        node.compute_class()
        h.state.upsert_node(h.next_index(), node)
        nodes.append(node)
    return nodes


def port_job(count=1, reserved=(), dynamic=1, mbits=10):
    job = jmock.job()
    tg = job.task_groups[0]
    tg.count = count
    for task in tg.tasks:
        task.resources.networks = [js.NetworkResource(
            mbits=mbits,
            reserved_ports=[js.Port(f"r{p}", p) for p in reserved],
            dynamic_ports=[js.Port(f"d{i}") for i in range(dynamic)])]
    return job


def existing_alloc(h, job_src, node, reserved=(), mbits=10):
    """A live alloc holding ports and bandwidth on ``node``."""
    alloc = jmock.alloc()
    alloc.node_id = node.id
    alloc.job = job_src
    alloc.job_id = job_src.id
    net = js.NetworkResource(
        device="eth0", ip=node.resources.networks[0].cidr.split("/")[0],
        mbits=mbits, reserved_ports=[js.Port(f"r{p}", p) for p in reserved])
    alloc.task_resources = {"web": js.Resources(
        cpu=100, memory_mb=64, networks=[net])}
    alloc.resources = js.Resources(cpu=100, memory_mb=64, networks=[net])
    h.state.upsert_allocs(h.next_index(), [alloc])
    return alloc


def run_both(h, jobs, seed, monkeypatch, mesh=None):
    """The port's batch first (on the state before), then the
    reference's; returns (port result, the ids of the allocs that were
    live before)."""
    for j in jobs:
        if h.state.job_by_id(None, j.id) is None:
            h.state.upsert_job(h.next_index(), j)
    evals = [reg_eval(j) for j in jobs]
    before = [a for a in h.state.allocs(None) if not a.terminal_status()]
    nodes = [convert.node_from_dict(dataclasses.asdict(n))
             for n in h.state.nodes(None)]
    pjobs = [convert.job_from_dict(dataclasses.asdict(j)) for j in jobs]
    live = [convert.alloc_from_dict(dataclasses.asdict(a)) for a in before]
    kw = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    res = batch_sched.schedule_batch(nodes, pjobs, live_allocs=live,
                                     rng_seed=seed,
                                     eval_ids=[e.id for e in evals], **kw)
    monkeypatch.setenv("NOMAD_TPU_RNG_SEED", str(seed))
    # Its own breaker: a tripped process-wide one would route the
    # reference through its CPU oracle.
    stats = TPUBatchScheduler(h.logger, h.snapshot(), h,
                              breaker=KernelCircuitBreaker()
                              ).schedule_batch(evals)
    assert stats.oracle_routed == 0
    return res, {a.id for a in before}


def offer_key(nid, task, offer):
    return (nid, task, offer.device, offer.ip, offer.mbits,
            tuple((p.label, p.value) for p in offer.reserved_ports),
            tuple((p.label, p.value) for p in offer.dynamic_ports))


def assert_same(res, h, jobs, before=()):
    """Placements, AllocMetric scores and offers of the port's result
    against the reference's new allocs."""
    want_nodes, want_scores, want_offers = {}, {}, {}
    for job in jobs:
        for a in h.state.allocs_by_job(None, job.id, True):
            if a.terminal_status() or a.id in before:
                continue
            key = (job.id, a.task_group)
            want_nodes.setdefault(key, []).append(a.node_id)
            want_scores[key] = a.metrics.scores
            want_offers.setdefault(key, []).extend(
                offer_key(a.node_id, task, tr.networks[0])
                for task, tr in a.task_resources.items() if tr.networks)
    got_nodes = {k: sorted(v.node_ids)
                 for k, v in res.placements.items() if v.node_ids}
    assert got_nodes == {k: sorted(v) for k, v in want_nodes.items()}
    for key, sp in res.placements.items():
        if not sp.node_ids:
            continue
        want = want_scores[key]
        assert set(sp.metric_scores) == set(want)
        for k, v in want.items():
            assert abs(sp.metric_scores[k] - v) <= SCORE_ATOL, k
        offers = want_offers.get(key, [])
        assert len(sp.networks) == (len(sp.node_ids) if offers else 0)
        got = sorted(offer_key(nid, task, offer)
                     for nid, offers in zip(sp.node_ids, sp.networks)
                     for task, offer in offers.items())
        assert got == sorted(offers)
    return want_nodes


def scenario(name, h):
    """The scenarios of tests/test_tpu_networks.py: (jobs, checks)."""
    if name == "reserved_port_conflict":
        nodes = make_nodes(h, 4)
        blocker = jmock.job()
        h.state.upsert_job(h.next_index(), blocker)
        existing_alloc(h, blocker, nodes[0], reserved=(8080,))
        return [port_job(count=3, reserved=(8080,))], nodes[0].id
    if name == "within_batch_conflict":
        make_nodes(h, 2)
        return [port_job(count=1, reserved=(9000,)) for _ in range(2)], None
    if name == "dynamic_ports":
        make_nodes(h, 4)
        return [port_job(count=4, dynamic=2)], None
    if name == "bandwidth_exhausted":
        nodes = make_nodes(h, 3, mbits=100)
        blocker = jmock.job()
        h.state.upsert_job(h.next_index(), blocker)
        existing_alloc(h, blocker, nodes[0], mbits=80)
        return [port_job(count=2, dynamic=0, mbits=50)], nodes[0].id
    if name == "live_alloc_holds_ports":
        nodes = make_nodes(h, 6)
        blocker = jmock.job()
        h.state.upsert_job(h.next_index(), blocker)
        for i in range(3):
            existing_alloc(h, blocker, nodes[i], reserved=(7000,))
        return [port_job(count=3, reserved=(7000,), dynamic=1)], None
    if name == "several_jobs_share_nodes":
        make_nodes(h, 3)
        return [port_job(count=2, reserved=(6000 + i,), dynamic=1)
                for i in range(3)], None
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "reserved_port_conflict", "within_batch_conflict", "dynamic_ports",
    "bandwidth_exhausted", "live_alloc_holds_ports",
    "several_jobs_share_nodes"])
def test_batch_scenarios_match_reference(name, monkeypatch):
    h = Harness()
    jobs, blocked = scenario(name, h)
    res, before = run_both(h, jobs, 41, monkeypatch)
    want = assert_same(res, h, jobs, before)
    assert want, "the reference placed nothing"
    if blocked is not None:
        assert all(blocked not in sp.node_ids
                   for sp in res.placements.values())


@pytest.mark.parametrize("seed", [7, 19])
def test_mock_jobs_then_follow_up_match_reference(seed, monkeypatch):
    """Unmodified mock.job()s (50 Mbit/s, two dynamic ports) on
    mock.node()s (port 22 and 1 Mbit/s reserved, one /32 address
    shared by all, 1000 Mbit/s), then a second batch against the first's
    live allocs, whose ports and bandwidth it must count."""
    h = Harness()
    for _ in range(24):
        h.state.upsert_node(h.next_index(), jmock.node())
    jobs = [jmock.job() for _ in range(4)]
    jobs[1].task_groups[0].count = 25
    jobs[2].type = js.JOB_TYPE_BATCH
    res, before = run_both(h, jobs, seed, monkeypatch)
    assert_same(res, h, jobs, before)
    more = [jmock.job() for _ in range(3)]
    more[0].task_groups[0].count = 40
    res2, before2 = run_both(h, more, seed + 1, monkeypatch)
    assert before2, "the follow-up has no live allocs"
    assert_same(res2, h, more, before2)
    assert sum(sp.unplaced for sp in res2.placements.values()) == 0


def test_bandwidth_binds_before_cpu_like_reference(monkeypatch):
    """Nodes of 120 Mbit/s take two 50 Mbit/s asks; the rest is unplaced
    and the counts agree."""
    h = Harness()
    for _ in range(5):
        node = jmock.node()
        node.resources.networks[0].mbits = 120
        node.compute_class()
        h.state.upsert_node(h.next_index(), node)
    jobs = [jmock.job() for _ in range(2)]
    res, before = run_both(h, jobs, 3, monkeypatch)
    assert_same(res, h, jobs, before)
    assert sum(len(sp.node_ids) for sp in res.placements.values()) == 10
    assert sum(sp.unplaced for sp in res.placements.values()) == 10


def test_failed_offer_leaves_the_alloc_unplaced(monkeypatch, caplog):
    """An offer that fails at finalize (here: every port pick refused)
    unplaces its alloc and logs a warning."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import network

    nodes = [mock.node() for _ in range(4)]
    job = mock.job()
    job.task_groups[0].count = 3
    monkeypatch.setattr(network.NetworkIndex, "assign_network",
                        lambda self, ask, rng=None: (None, "refused"))
    res = batch_sched.schedule_batch(nodes, [job], rng_seed=1, device="cpu",
                                     eval_ids=["e"])
    sp = res.placements[(job.id, "web")]
    assert sp.node_ids == [] and sp.unplaced == 3 and sp.networks == []
    assert len(sp.scores) == 0 and "network offer failed" in caplog.text


# -- what the reference routes to its oracle ----------------------------------

def test_non_simple_cluster_raises():
    from nomad_tpu_torch import mock

    nodes = [mock.node() for _ in range(3)]
    nodes[1].resources.networks[0].cidr = "10.0.0.0/30"   # four addresses
    with pytest.raises(NotImplementedError, match="multi-device/multi-IP"):
        batch_sched.schedule_batch(nodes, [mock.job()], rng_seed=1,
                                   device="cpu")
    nodes[1].resources.networks[0].cidr = "192.168.0.100/32"
    nodes[2].resources.networks.append(js.NetworkResource(
        device="eth1", cidr="10.0.0.1/32", mbits=100))
    with pytest.raises(NotImplementedError, match="multi-device/multi-IP"):
        batch_sched.schedule_batch(nodes, [mock.job()], rng_seed=1,
                                   device="cpu")
    # Without network asks the same cluster places.
    job = mock.job()
    job.task_groups[0].count = 3
    job.task_groups[0].tasks[0].resources.networks = []
    res = batch_sched.schedule_batch(nodes, [job], rng_seed=1, device="cpu")
    assert len(set(res.placements[(job.id, "web")].node_ids)) == 3


def oracle_job(reason):
    job = jmock.job()
    tg = job.task_groups[0]
    if reason == "conflicting reserved ports":
        tg.tasks[0].resources.networks[0].reserved_ports = [
            js.Port("a", 5000), js.Port("b", 5000)]
    elif reason == "reserved port out of range":
        tg.tasks[0].resources.networks[0].reserved_ports = [
            js.Port("a", 70000)]
    elif reason == "multiple distinct_property":
        tg.constraints = [
            js.Constraint("${meta.rack}", "", js.CONSTRAINT_DISTINCT_PROPERTY),
            js.Constraint("${meta.zone}", "", js.CONSTRAINT_DISTINCT_PROPERTY)]
    elif reason == "job-level distinct_property":
        job.constraints.append(js.Constraint(
            "${meta.rack}", "", js.CONSTRAINT_DISTINCT_PROPERTY))
        second = dataclasses.replace(tg, name="second")
        job.task_groups.append(second)
    return job


@pytest.mark.parametrize("reason", [
    "conflicting reserved ports", "reserved port out of range",
    "multiple distinct_property", "job-level distinct_property"])
def test_needs_oracle_reasons_raise(reason):
    """Each reason the reference's build_spec names makes the port raise
    with that reason; the reference names the same one."""
    from nomad_tpu.ops import encode as jenc
    from nomad_tpu_torch import mock

    job = oracle_job(reason)
    want = jenc.build_spec(job, job.task_groups[0], False).needs_oracle
    assert want and want.startswith(reason.split()[0])
    pjob = convert.job_from_dict(dataclasses.asdict(job))
    nodes = [mock.node() for _ in range(4)]
    with pytest.raises(NotImplementedError) as exc:
        batch_sched.schedule_batch(nodes, [pjob], rng_seed=1, device="cpu")
    assert want in str(exc.value)


# -- the fused pass on the reference's network buffers ------------------------

def capture_reference_fused(monkeypatch, build):
    """Run ``build(h) -> jobs`` through the reference scheduler and keep
    the upload buffers and the result of its (last) fused pass."""
    monkeypatch.setenv("NOMAD_TPU_RESIDENT", "0")
    captured = {}
    orig = jk.fused_pass

    def spy(static_buf, dyn_buf, used_dev=None, **kw):
        out = orig(static_buf, dyn_buf, used_dev, **kw)
        captured.update(static=np.asarray(static_buf),
                        dyn=np.asarray(dyn_buf), kw=kw,
                        buf=np.asarray(out[0]), meta=out[3])
        return out

    monkeypatch.setattr(jbatch.kernels, "fused_pass", spy)
    h = Harness()
    jobs = build(h)
    for j in jobs:
        h.state.upsert_job(h.next_index(), j)
    monkeypatch.setenv("NOMAD_TPU_RNG_SEED", "61")
    stats = TPUBatchScheduler(h.logger, h.snapshot(), h,
                              breaker=KernelCircuitBreaker()
                              ).schedule_batch([reg_eval(j) for j in jobs])
    assert stats.oracle_routed == 0
    kw = captured["kw"]
    return (jxfer.unpack_host(captured["static"], kw["meta_s"]),
            jxfer.unpack_host(captured["dyn"], kw["meta_d"]), kw,
            jxfer.unpack_host(captured["buf"], captured["meta"]),
            captured["meta"])


def net_dp_cluster(h):
    """Nodes with racks, live allocs holding ports, jobs with network
    asks (one with a reserved port) and a distinct_property group."""
    nodes = make_nodes(h, 40, mbits=400)
    for i, node in enumerate(nodes):
        node.meta["rack"] = f"r{i % 6}"
        node.compute_class()
        h.state.upsert_node(h.next_index(), node)
    blocker = jmock.job()
    h.state.upsert_job(h.next_index(), blocker)
    for i in range(0, 40, 5):
        existing_alloc(h, blocker, nodes[i], reserved=(8080,), mbits=300)
    jobs = [port_job(count=12, reserved=(8080,), dynamic=1, mbits=60),
            port_job(count=20, dynamic=2, mbits=50), jmock.job()]
    jobs[2].task_groups[0].count = 9
    jobs[2].task_groups[0].constraints = [js.Constraint(
        "${meta.rack}", "", js.CONSTRAINT_DISTINCT_PROPERTY)]
    return jobs


def assert_buffers_equal(got, want):
    for name in ("unplaced", "feas_count", "scalars"):
        np.testing.assert_array_equal(got[name], want[name])
    nnz = int(want["scalars"][0])
    assert nnz > 0
    np.testing.assert_array_equal(got["coo"][:nnz, :3], want["coo"][:nnz, :3])
    np.testing.assert_array_equal(got["coo"][:nnz, 4], want["coo"][:nnz, 4])
    gs = got["coo"][:nnz, 3].view(np.float32)
    ws = want["coo"][:nnz, 3].view(np.float32)
    assert np.abs(gs - ws).max() <= SCORE_ATOL


def test_fused_pass_on_reference_network_buffers(monkeypatch):
    """The port's fused_pass on the reference's own upload with network,
    distinct_property and quantized keys (dequantized on the device)
    returns the reference's result buffer."""
    static, dyn, kw, want, meta = capture_reference_fused(
        monkeypatch, net_dp_cluster)
    assert {"u_ports", "dp_used", "res_scale"} <= set(static) | set(dyn)
    sbuf, dbuf, meta_s, meta_d = convert.device_inputs_from_buffers(
        static, dyn, device="cpu")
    out = kernels.fused_pass(
        sbuf, dbuf, meta_s=meta_s, meta_d=meta_d, u_pad=kw["u_pad"],
        n_pad=kw["n_pad"], with_scores=kw["with_scores"],
        max_nnz=kw["max_nnz"], max_rounds=kw.get("max_rounds", 256),
        slot_m=kw["slot_m"])
    assert out.meta == meta
    assert_buffers_equal(xfer.unpack_host(out.buf.numpy(), out.meta), want)


@pytest.mark.parametrize("d", [4])
def test_fused_mesh_pass_on_reference_network_buffers(d, monkeypatch):
    """The same upload cut into d shards through sharded_fused_pass: the
    reference single chip's result (the mesh may run one more round)."""
    static, dyn, kw, want, meta = capture_reference_fused(
        monkeypatch, net_dp_cluster)
    sbuf, dbuf, meta_s, meta_d = convert.device_inputs_from_buffers(
        static, dyn, device="cpu")
    static_p = xfer.unpack_host(sbuf.numpy(), meta_s)
    shards, meta_s = xfer.pack_host_sharded(static_p, d,
                                            replicate=("res_scale",))
    out = sharded.sharded_fused_pass(
        sharded.make_node_mesh(["cpu"] * d),
        [torch.from_numpy(shards[i]) for i in range(d)], dbuf,
        meta_s=meta_s, meta_d=meta_d, u_pad=kw["u_pad"], n_pad=kw["n_pad"],
        with_scores=kw["with_scores"], max_nnz=kw["max_nnz"],
        slot_m=kw["slot_m"], k_cand=max(64, kw["slot_m"]))
    got = xfer.unpack_host(out.buf.numpy(), out.meta)
    want = dict(want, scalars=np.array([want["scalars"][0],
                                        got["scalars"][1]]))
    assert_buffers_equal(got, want)
    assert fused_score.LAUNCHES == 0


# -- the mesh ------------------------------------------------------------------

@pytest.mark.parametrize("seed,d", [(3, 8), (17, 4)])
def test_mesh_rounds_with_net_match_reference(seed, d):
    """sharded_placement_rounds with net= against the reference's, on
    d virtual CPU devices and d CPU shards: exact."""
    base, net = loop_problem(seed)
    want = jax_rounds(jax_mesh(jax.devices()[:d]),
                      *[jnp.asarray(a) for a in base],
                      jax.random.PRNGKey(seed), k_cand=16, net=jax_net(net))
    got = sharded.sharded_placement_rounds(
        sharded.make_node_mesh(["cpu"] * d), *[t(a) for a in base],
        kernels.jitter_seed(seed), k_cand=16, net=port_net(net))
    np.testing.assert_array_equal(got.placements.numpy(),
                                  np.asarray(want.placements))
    np.testing.assert_array_equal(got.unplaced.numpy(),
                                  np.asarray(want.unplaced))
    np.testing.assert_array_equal(got.used_after.numpy(),
                                  np.asarray(want.used_after))
    assert got.rounds == int(want.rounds)


def test_mesh_batch_with_networks_matches_reference(monkeypatch):
    """schedule_batch on a 4-shard CPU mesh against the reference's
    single-chip batch: placements, scores and offers."""
    h = Harness()
    for i in range(30):
        node = jmock.node()
        node.meta["rack"] = f"r{i % 4}"
        node.compute_class()
        h.state.upsert_node(h.next_index(), node)
    jobs = [jmock.job() for _ in range(3)] + [port_job(count=5,
                                                       reserved=(9000,))]
    jobs[0].task_groups[0].constraints = [js.Constraint(
        "${meta.rack}", "", js.CONSTRAINT_DISTINCT_PROPERTY)]
    res, before = run_both(h, jobs, 5, monkeypatch,
                           mesh=sharded.make_node_mesh(["cpu"] * 4))
    assert res.mesh_shards == 4
    assert_same(res, h, jobs, before)
