"""The schedule program's halves and the three single-card dispatches
against the JAX reference, on the CPU.

- ``device_pass`` (the two calls in turn), ``device_schedule`` and
  ``device_compact`` of the port against the reference's
  ``device_pass``, ``_device_schedule`` and ``_device_compact``, on the
  reference scheduler's own upload buffers (a plain cluster, and one
  with networks, a reserved port and a distinct_property group): equal
  summaries, equal COO prefixes, in slot mode and in matrix mode, with
  and without scores, with ``compact_u16`` on and off.  Integers are
  exact; the scores differ by at most 4e-6 (two float32 ulp at 18, where
  the reference's ``10^x`` rounds otherwise; ROADMAP queue 3 item 2).
- ``TorchBatchScheduler(dispatch="fused" | "two_pass" | "staged")``
  against ``TPUBatchScheduler`` with the default, ``NOMAD_TPU_FUSED=0``
  and ``NOMAD_TPU_FUSED=0 NOMAD_TPU_TIMING=2``: the same worlds after
  each batch (``test_torch_sched.assert_same_world``), the reference on
  its device path with a breaker of its own.
- ``Server(ServerConfig(dispatch=...))`` on the CPU, resident mirror on
  (the default): the two-pass and staged servers commit the fused
  server's allocs and evals, the fused and two-pass ones lend the
  mirror to the pass, the staged one never does and logs both halves'
  seconds.
"""
import logging

import jax.numpy as jnp
import numpy as np
import pytest

from nomad_tpu import mock as jmock
from nomad_tpu.ops import kernels as jk
from nomad_tpu.ops import xfer as jxfer
from nomad_tpu_torch import convert
from nomad_tpu_torch.ops import batch_sched, kernels, resident, xfer
from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.structs import structs as ps
from nomad_tpu_torch.utils.backoff import wait_until
from test_torch_networks import (capture_reference_fused, make_nodes,
                                 net_dp_cluster)
from test_torch_sched import Twin, make_job, make_node
from test_torch_server import (HEARTBEAT_TTL, JOIN_TIMEOUT, SEED, Ids, conv,
                               settle, strip_node)
from test_torch_server import make_job as server_job

SCORE_ATOL = 4e-6


def plain_cluster(h):
    """Twelve nodes and three jobs without network asks."""
    for node in make_nodes(h, 12):
        node.resources.networks = []
        node.reserved.networks = []
        node.compute_class()
        h.state.upsert_node(h.next_index(), node)
    jobs = []
    for count in (9, 14, 5):
        j = jmock.job()
        j.task_groups[0].count = count
        for t in j.task_groups[0].tasks:
            t.resources.networks = []
        jobs.append(j)
    return jobs


CLUSTERS = {"plain": plain_cluster, "net_dp": net_dp_cluster}
_BUFFERS = {}


def buffers(monkeypatch, name):
    """The reference scheduler's upload of cluster ``name`` (packed for
    both packages) and the pass's keyword arguments; made once."""
    if name not in _BUFFERS:
        static, dyn, kw, _, _ = capture_reference_fused(monkeypatch,
                                                        CLUSTERS[name])
        jsb, jmeta_s = jxfer.pack_host(static)
        jdb, jmeta_d = jxfer.pack_host(dyn)
        _BUFFERS[name] = (static, dyn, kw, (jsb, jmeta_s, jdb, jmeta_d))
    static, dyn, kw, ref = _BUFFERS[name]
    port = convert.device_inputs_from_buffers(static, dyn, device="cpu")
    return kw, ref, port


def ref_args(kw, ref, with_scores, slot_m):
    jsb, jmeta_s, jdb, jmeta_d = ref
    return dict(meta_s=jmeta_s, meta_d=jmeta_d, u_pad=kw["u_pad"],
                n_pad=kw["n_pad"], with_networks=kw["with_networks"],
                with_dp=kw["with_dp"], with_scores=with_scores,
                slot_m=slot_m)


def assert_summary_and_coo(got_summary, got_coo, want_summary, want_coo,
                           u_pad, n_pad, with_scores):
    """Equal summaries and equal COO prefixes (scores within 4e-6)."""
    layout = jk.summary_layout(u_pad, n_pad)
    assert kernels.summary_layout(u_pad, n_pad) == layout
    got = xfer.unpack_host(got_summary.numpy(), layout)
    want = jxfer.unpack_host(np.asarray(want_summary), layout)
    for name in ("unplaced", "feas_count", "scalars"):
        np.testing.assert_array_equal(got[name], want[name])
    nnz = int(want["scalars"][0])
    assert nnz > 0
    want_coo = np.asarray(want_coo)
    got_coo = got_coo.numpy()
    if want_coo.dtype == np.uint16:
        got_coo = got_coo.view(np.uint16)
    assert got_coo.shape == want_coo.shape
    assert got_coo.dtype == want_coo.dtype
    np.testing.assert_array_equal(got_coo[:nnz, :3], want_coo[:nnz, :3])
    if with_scores:
        np.testing.assert_array_equal(got_coo[:nnz, 4], want_coo[:nnz, 4])
        gs = got_coo[:nnz, 3].view(np.float32)
        ws = want_coo[:nnz, 3].view(np.float32)
        assert np.abs(gs - ws).max() <= SCORE_ATOL


MODES = [(slot, scores) for slot in (True, False) for scores in (True, False)]


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
@pytest.mark.parametrize("slot,with_scores", MODES)
def test_device_pass_matches_reference(cluster, slot, with_scores,
                                       monkeypatch):
    kw, ref, (sbuf, dbuf, meta_s, meta_d) = buffers(monkeypatch, cluster)
    slot_m = kw["slot_m"] if slot else 0
    assert not slot or slot_m > 0
    jsb, _, jdb, _ = ref
    want_summary, want_coo, want_feas, _ = jk.device_pass(
        jnp.asarray(jsb), jnp.asarray(jdb), None, max_nnz=kw["max_nnz"],
        **ref_args(kw, ref, with_scores, slot_m))
    out = kernels.device_pass(
        sbuf, dbuf, meta_s=meta_s, meta_d=meta_d, u_pad=kw["u_pad"],
        n_pad=kw["n_pad"], with_scores=with_scores, max_nnz=kw["max_nnz"],
        slot_m=slot_m)
    assert out.commit_steps > 0
    np.testing.assert_array_equal(out.feas.numpy(), np.asarray(want_feas))
    assert_summary_and_coo(out.summary, out.coo, want_summary, want_coo,
                           kw["u_pad"], kw["n_pad"], with_scores)
    # compact_u16 exactly where the reference takes it.
    assert (out.coo.dtype.itemsize == 2) == (not with_scores)


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
@pytest.mark.parametrize("slot,with_scores", MODES)
def test_schedule_then_compact_match_reference(cluster, slot, with_scores,
                                               monkeypatch):
    """The two halves apart: the placement result and feasibility of the
    schedule half, then the compact half with compact_u16 on (where the
    scores allow it) and off."""
    kw, ref, (sbuf, dbuf, meta_s, meta_d) = buffers(monkeypatch, cluster)
    slot_m = kw["slot_m"] if slot else 0
    jsb, _, jdb, _ = ref
    jres, jfeas, _ = jk._device_schedule(
        jnp.asarray(jsb), jnp.asarray(jdb), jnp.zeros((1, 4), jnp.int32),
        **ref_args(kw, ref, with_scores, slot_m))
    pres, pfeas = kernels.device_schedule(
        sbuf, dbuf, meta_s=meta_s, meta_d=meta_d, u_pad=kw["u_pad"],
        n_pad=kw["n_pad"], with_scores=with_scores, slot_m=slot_m)
    np.testing.assert_array_equal(pfeas.numpy(), np.asarray(jfeas))
    assert pres.rounds == int(jres.rounds)
    for f in ("unplaced", "used_after", "placements", "slots",
              "commit_collisions", "slot_coll"):
        np.testing.assert_array_equal(getattr(pres, f).numpy(),
                                      np.asarray(getattr(jres, f)), f)
    for f in ("commit_scores", "slot_scores"):
        assert np.abs(getattr(pres, f).numpy()
                      - np.asarray(getattr(jres, f))).max() <= SCORE_ATOL
    for u16 in ((False, True) if not with_scores else (False,)):
        want = jk._device_compact(jres, jfeas, with_scores=with_scores,
                                  max_nnz=kw["max_nnz"], compact_u16=u16,
                                  slot_m=slot_m)
        got = kernels.device_compact(pres, pfeas, with_scores=with_scores,
                                     max_nnz=kw["max_nnz"], compact_u16=u16,
                                     slot_m=slot_m)
        assert_summary_and_coo(*got, *want, kw["u_pad"], kw["n_pad"],
                               with_scores)


def test_fused_pass_runs_device_schedule(monkeypatch):
    """The fused pass takes its first half from device_schedule, so the
    two routes cannot drift apart."""
    kw, _, (sbuf, dbuf, meta_s, meta_d) = buffers(monkeypatch, "plain")
    calls = []
    real = kernels.device_schedule

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(kernels, "device_schedule", spy)
    kernels.fused_pass(sbuf, dbuf, meta_s=meta_s, meta_d=meta_d,
                       u_pad=kw["u_pad"], n_pad=kw["n_pad"],
                       with_scores=True, max_nnz=kw["max_nnz"],
                       slot_m=kw["slot_m"])
    assert len(calls) == 1 and calls[0]["slot_m"] == kw["slot_m"]


# -- the dispatches through the eval-driven scheduler --------------------------

REFERENCE_KNOBS = {"fused": {},
                   "two_pass": {"NOMAD_TPU_FUSED": "0"},
                   "staged": {"NOMAD_TPU_FUSED": "0",
                              "NOMAD_TPU_TIMING": "2"}}


@pytest.mark.parametrize("dispatch", batch_sched.DISPATCHES)
def test_dispatch_plans_match_reference(dispatch, monkeypatch):
    """Two batches (a register wave, then a scale-up with a node down)
    through each dispatch: the same allocs, plans and evals as the
    reference set the same way; the staged route times both halves."""
    for name, value in REFERENCE_KNOBS[dispatch].items():
        monkeypatch.setenv(name, value)
    t = Twin(monkeypatch, 2200 + batch_sched.DISPATCHES.index(dispatch))
    nodes = [make_node(t.rng, rack=f"r{i % 3}") for i in range(14)]
    for n in nodes:
        t.add_node(n)
    jobs = [make_job(t.rng, c) for c in (7, 11, 30)]
    for j in jobs:
        t.put_job(j)
    _, pst = t.run([t.eval_for(j) for j in jobs], dispatch=dispatch)
    assert pst.device_ran and pst.commit_steps > 0
    assert set(pst.timings) == ({"schedule", "compact"}
                                if dispatch == "staged" else set())
    t.node_down(nodes[0].id)
    grown = jobs[0].copy()
    grown.task_groups[0].count = 12
    t.put_job(grown)
    t.run([t.eval_for(grown)], dispatch=dispatch)


def test_unknown_dispatch_is_refused():
    with pytest.raises(ValueError):
        batch_sched.TorchBatchScheduler(None, None, None, device="cpu",
                                        dispatch="fast")
    with pytest.raises(ValueError):
        batch_sched.schedule_batch([], [], device="cpu", dispatch="")


# -- the dispatches through a Server -----------------------------------------

def server_world(monkeypatch, dispatch):
    """A port ``Server`` on the CPU with ``dispatch`` (resident mirror on,
    the default) driven through two waves, each registered with the
    workers paused: three jobs on twelve nodes, then one node down and a
    job scaled up (the mirror's delta path).  Returns what it committed,
    by content, and how many passes it lent the mirror to."""
    ids = Ids(SEED)
    monkeypatch.setattr(ps, "generate_uuid", ids.one)
    monkeypatch.setattr(ps, "generate_uuids", ids.many)
    loans = []
    take = resident.take_device_used

    def counted_take(*args, **kwargs):
        dev = take(*args, **kwargs)
        loans.append(dev is not None)
        return dev

    monkeypatch.setattr(resident, "take_device_used", counted_take)
    # The seeded ids give every world the same store id: no world may
    # find the last one's mirror.
    resident.invalidate()
    brk = KernelCircuitBreaker()
    srv = Server(ServerConfig(device="cpu", rng_seed=SEED, broker_seed=SEED,
                              num_schedulers=1, batch_size=8,
                              min_heartbeat_ttl=HEARTBEAT_TTL, breaker=brk,
                              dispatch=dispatch))
    try:
        srv.start()
        nodes = [conv(strip_node(jmock.node(), f"d-{i:02d}", cpu=4000,
                                 mem=8192), convert.node_from_dict)
                 for i in range(12)]
        for n in nodes:
            srv.node_register(n)
        jobs = [conv(server_job(f"job-{k}", count, 500, 256),
                     convert.job_from_dict)
                for k, count in enumerate((7, 11, 9))]

        def wave(fn):
            assert srv.set_workers_paused(True, timeout=30.0)
            fn()
            srv.set_workers_paused(False)
            settle(srv)

        wave(lambda: [srv.job_register(j) for j in jobs])
        grown = jobs[0].copy()
        grown.task_groups[0].count = 12

        def second():
            srv.node_update_status(nodes[0].id, ps.NODE_STATUS_DOWN)
            srv.job_register(grown)

        wave(second)
        allocs = sorted((a.job_id, a.name, a.node_id, a.desired_status,
                         a.client_status)
                        for a in srv.state.allocs(None))
        evals = sorted((e.job_id, e.triggered_by, e.status)
                       for e in srv.state.evals(None))
        return {"allocs": allocs, "evals": evals,
                "breaker": (brk.state, brk.trips), "loans": loans}
    finally:
        srv.shutdown()
        assert wait_until(lambda: not srv.threads(), JOIN_TIMEOUT)


def test_server_dispatches_commit_the_fused_plans(monkeypatch, caplog):
    """``ServerConfig.dispatch`` reaches the batch scheduler: the same
    allocs and evals from each dispatch, the mirror lent to the fused and
    two-pass passes (twice each: both waves) and never to the staged
    one, whose halves are timed and logged."""
    worlds = {}
    for dispatch in batch_sched.DISPATCHES:
        with monkeypatch.context() as mp, caplog.at_level(
                logging.WARNING, logger=batch_sched.logger.name):
            caplog.clear()
            worlds[dispatch] = server_world(mp, dispatch)
            worlds[dispatch]["staged_logs"] = sum(
                "staged: schedule" in r.getMessage() for r in caplog.records)
    fused = worlds["fused"]
    live = [a for a in fused["allocs"] if a[3] == ps.ALLOC_DESIRED_STATUS_RUN]
    assert len(live) == 12 + 11 + 9 and len(fused["evals"]) == 7
    for dispatch, w in worlds.items():
        assert w["breaker"] == ("closed", 0), dispatch
        assert w["allocs"] == fused["allocs"], dispatch
        assert w["evals"] == fused["evals"], dispatch
    for dispatch in ("fused", "two_pass"):
        assert worlds[dispatch]["loans"] == [True, True], dispatch
        assert worlds[dispatch]["staged_logs"] == 0
    assert worlds["staged"]["loans"] == []
    assert worlds["staged"]["staged_logs"] == 2
