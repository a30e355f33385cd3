"""The port's load harness (``nomad_tpu_torch/loadgen/``) against the
reference's (``nomad_tpu/loadgen/``).

- Scenarios: every builtin's ``to_dict()`` equals the reference's
  ``asdict``, and a spec file parses alike in both.
- The offered load: the first 500 jobs of ``_job_for`` and tenants of
  ``_tenant_for`` equal the reference's (its job's ``log_config``, a
  client field the port's structs leave out, removed by the conversion).
- ``_percentiles`` and ``render_report`` give the same output.
- ``integrity_sweep`` over seeded faulty stores finds the same
  violations, live and strict.
- End to end on the CPU: the ``smoke`` scenario through both packages'
  servers (the reference with its batch worker and a breaker of its own)
  places the same count for every job, completes every submission, and
  leaves a clean strict sweep; ``overload_10x``, shrunk, keeps the
  broker's pending evals at or below its cap with rejects above 0; a
  two-server run (one follower subprocess, the auditor armed) is clean.
- A chaos scenario builds a harness; a multi-region one goes to the
  federated harness.
- The broker's front-door reservation (a port departure, ROADMAP queue
  3 item 20) holds its cap against registrations in flight.

Only what is deterministic is asserted: no wall-clock threshold.
"""
import dataclasses
import io
import json
import random
import threading
import types
from dataclasses import replace

import jax  # noqa: F401  (the reference computes on the CPU backend)
import pytest

from nomad_tpu import mock as jmock
from nomad_tpu.loadgen import harness as jharness
from nomad_tpu.loadgen import report as jreport
from nomad_tpu.loadgen import scenario as jscenario
from nomad_tpu.loadgen.auditor import integrity_sweep as jsweep
from nomad_tpu.ops import breaker as jbreaker
from nomad_tpu.state.state_store import StateStore as JStateStore
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert
from nomad_tpu_torch.loadgen import harness as pharness
from nomad_tpu_torch.loadgen import report as preport
from nomad_tpu_torch.loadgen import scenario as pscenario
from nomad_tpu_torch.loadgen.auditor import integrity_sweep as psweep
from nomad_tpu_torch.ops import breaker as pbreaker
from nomad_tpu_torch.state.state_store import StateStore as PStateStore
from nomad_tpu_torch.structs import structs as ps

BUILTINS = sorted(jscenario.BUILTIN_SCENARIOS)


# ---------------------------------------------------------------------------
# scenarios and the offered load
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", BUILTINS)
def test_builtin_scenario_dicts_equal(name):
    ref = jscenario.get_scenario(name)
    port = pscenario.get_scenario(name)
    assert port.to_dict() == dataclasses.asdict(ref) == ref.to_dict()
    assert pscenario.Scenario.from_dict(port.to_dict()) == port


def test_spec_file_parses_alike(tmp_path):
    spec = {"name": "my-load", "num_nodes": 200, "num_clients": 8,
            "arrival_rate": 120, "warmup_s": 2, "measure_s": 10,
            "drain_s": 20, "update_fraction": 0.25, "num_tenants": 3,
            "job_mix": [{"weight": 8, "count": 1, "cpu": 100,
                         "memory_mb": 128, "priority": 50},
                        {"weight": 1, "count": 4, "cpu": 500,
                         "memory_mb": 512, "priority": 80}],
            "num_workers": 4, "subscribers": 64, "seed": 5}
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    assert pscenario.load_scenario(str(path)).to_dict() == \
        jscenario.load_scenario(str(path)).to_dict()
    for mod in (jscenario, pscenario):
        with pytest.raises(ValueError, match="unknown scenario fields"):
            mod.Scenario.from_dict(dict(spec, bogus=1))
        with pytest.raises(ValueError, match="unknown scenario"):
            mod.get_scenario("nope")


def offered_load(harness_mod, scenario, n=500, **kwargs):
    h = harness_mod.LoadHarness(scenario, **kwargs)
    if scenario.num_tenants:
        # The tenants' names and CDF without a server.
        h.server = types.SimpleNamespace(namespace_upsert=lambda ns: None)
        h._register_tenants()
    jobs = [h._job_for(seq) for seq in range(n)]
    tenants = ([h._tenant_for(seq) for seq in range(n)]
               if scenario.num_tenants else [])
    return jobs, tenants


@pytest.mark.parametrize("name", ["smoke", "baseline", "overload_10x",
                                  "multi_tenant", "multi_server"])
def test_job_and_tenant_streams_equal(name):
    ref_jobs, ref_tenants = offered_load(jharness,
                                         jscenario.get_scenario(name))
    port_jobs, port_tenants = offered_load(
        pharness, pscenario.get_scenario(name), device="cpu")
    assert port_tenants == ref_tenants
    for ref, port in zip(ref_jobs, port_jobs):
        assert dataclasses.asdict(port) == dataclasses.asdict(
            convert.job_from_dict(dataclasses.asdict(ref)))


def test_percentiles_equal():
    rng = random.Random(11)
    for n in (0, 1, 2, 7, 100, 999):
        values = [rng.expovariate(20.0) for _ in range(n)]
        assert pharness._percentiles(values) == jharness._percentiles(values)


@pytest.mark.parametrize("name,kwargs", [
    ("chaos_smoke", {}), ("chaos_soak", {}), ("multi_region", {}),
    ("smoke", {"num_regions": 2}), ("smoke", {"chaos": {"kills": 1}})])
def test_chaos_and_regions_raise(name, kwargs):
    """The chaos scheduler and the federated harness are ported (these
    raised naming ROADMAP queue 1 item 30 before): a chaos scenario
    builds a ``LoadHarness``; a multi-region one is refused by it with a
    ``ValueError`` naming the federated harness, which takes it."""
    from nomad_tpu_torch.loadgen.federation import MultiRegionHarness

    sc = replace(pscenario.get_scenario(name), **kwargs)
    if sc.num_regions > 1:
        with pytest.raises(ValueError, match="MultiRegionHarness"):
            pharness.LoadHarness(sc, device="cpu")
        assert MultiRegionHarness(sc, device="cpu").regions == ["r0", "r1"]
    else:
        assert pharness.LoadHarness(sc, device="cpu").sc.chaos is not None


# ---------------------------------------------------------------------------
# the integrity sweep
# ---------------------------------------------------------------------------


def faulty_stores(seed):
    """One cluster in both packages' stores with seeded faults: an
    overplaced job, duplicate alloc names, an overcommitted node, a
    tenant over its live-alloc quota, a surplus job with a pending eval
    (reconciling while live), and terminal allocs that do not count."""
    rng = random.Random(seed)
    ref, port = JStateStore(), PStateStore()
    index = [0]

    def put(method, obj, conv=None, many=False):
        index[0] += 1
        getattr(ref, method)(index[0], [obj] if many else obj)
        pobj = conv(dataclasses.asdict(obj)) if conv else obj
        getattr(port, method)(index[0], [pobj] if many else pobj)

    for name, quota in (("t1", 2), ("t2", 0)):
        index[0] += 1
        ref.upsert_namespace(index[0], js.Namespace(name=name,
                                                    max_live_allocs=quota))
        port.upsert_namespace(index[0], ps.Namespace(name=name,
                                                     max_live_allocs=quota))
    nodes = []
    for _ in range(6):
        node = jmock.node()
        node.resources.networks = []
        node.reserved.networks = []
        put("upsert_node", node, convert.node_from_dict)
        nodes.append(node)
    jobs = []
    for k in range(6):
        job = jmock.job()
        job.namespace = ("t1", "t2", "")[k % 3]
        job.task_groups[0].count = rng.randint(1, 3)
        for tg in job.task_groups:
            for t in tg.tasks:
                t.resources.networks = []
        put("upsert_job", job, convert.job_from_dict)
        jobs.append(job)

    def alloc(job, i, node, cpu=100, mem=64, status="running"):
        a = jmock.alloc()
        a.job_id, a.job, a.namespace = job.id, job, job.namespace
        a.node_id = node.id
        a.name = f"{job.id}.web[{i}]"
        a.resources = js.Resources(cpu=cpu, memory_mb=mem)
        a.task_resources = {}
        a.shared_resources = None
        a.client_status = status
        put("upsert_allocs", a, convert.alloc_from_dict, many=True)

    for job in jobs:
        for i in range(job.task_groups[0].count):
            alloc(job, i, rng.choice(nodes))
    over = jobs[rng.randrange(6)]
    alloc(over, 7, rng.choice(nodes))                      # overplaced
    dup = jobs[rng.randrange(6)]
    alloc(dup, 0, rng.choice(nodes), status="pending")     # a name twice
    alloc(jobs[2], 9, nodes[5], cpu=10_000_000)            # overcommit
    for i in range(3):                                     # t1 over quota
        alloc(jobs[0], 20 + i, rng.choice(nodes))
    surplus = jobs[4]
    alloc(surplus, 30, rng.choice(nodes))
    ev = jmock.eval()
    ev.job_id, ev.namespace = surplus.id, surplus.namespace
    ev.status = js.EVAL_STATUS_PENDING
    put("upsert_evals", ev, convert.eval_from_dict, many=True)
    for job in jobs[:3]:                                   # terminal
        alloc(job, 40, rng.choice(nodes), status="complete")
    return ref, port, [j.id for j in jobs]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("strict", [False, True])
def test_integrity_sweep_equal(seed, strict):
    ref, port, ids = faulty_stores(seed)
    want = jsweep(ref, strict=strict)
    assert psweep(port, strict=strict) == want
    assert want["overplaced_jobs"] and want["duplicate_alloc_names"]
    assert want["overcommitted_nodes"] == 1
    assert want["tenant_quota_violations"] == 1
    assert psweep(port, set(ids[:3]), strict=strict) == \
        jsweep(ref, set(ids[:3]), strict=strict)


# ---------------------------------------------------------------------------
# end to end on the CPU
# ---------------------------------------------------------------------------


def live_counts(harness):
    state = harness.server.state
    return {jid: len([a for a in state.allocs_by_job(None, jid, True)
                      if not a.terminal_status()])
            for jid in sorted({r.job_id for r in harness.subs.values()})}


def oracle_routed(harness):
    return harness.server.metrics.sink.latest()["CounterTotals"].get(
        "nomad.breaker.oracle_routed", 0)


@pytest.fixture(scope="module")
def smoke_runs():
    """The smoke scenario through both packages: the reference with its
    batch worker and a breaker of its own, the port on the CPU."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jbreaker, "BREAKER", jbreaker.KernelCircuitBreaker())
        ref = jharness.LoadHarness(replace(
            jscenario.get_scenario("smoke"), use_tpu_batch_worker=True))
        ref_report = ref.run()
    finally:
        mp.undo()
    brk = pbreaker.KernelCircuitBreaker()
    port = pharness.LoadHarness(
        pscenario.get_scenario("smoke"), device="cpu",
        server_options={"breaker": brk, "rng_seed": 7})
    port_report = port.run()
    return {"ref": (ref, ref_report), "port": (port, port_report, brk)}


def test_smoke_end_to_end_equals_the_reference(smoke_runs):
    ref, ref_report = smoke_runs["ref"]
    port, report, brk = smoke_runs["port"]
    assert oracle_routed(ref) == 0
    assert oracle_routed(port) == 0 and brk.trips == 0
    assert live_counts(port) == live_counts(ref)
    counts = live_counts(port)
    assert len(counts) == 30 and set(counts.values()) <= {1, 2}
    for r in (report, ref_report):
        off, sus = r["offered"], r["sustained"]
        assert off["submitted"] == 30 and off["dropped_after_retries"] == 0
        assert sus["completed_total"] == 30
        assert sus["stragglers_after_drain"] == 0
    assert report["server"] == {"worker": "torch-batch", "device": "cpu"}
    assert report["latency_ms"]["submit_to_running"]["count"] == 30
    assert report["latency_ms"]["plan_apply"]["count"] > 0
    assert report["heartbeat"]["renewals"] >= 20
    assert report["event_fanout"]["subscribers"] == 9
    assert report["control_plane"]["broker"]["Pending"] == 0
    assert set(report) == set(ref_report) | {"server"}
    strict = psweep(port.server.state, strict=True)
    assert (strict["overplaced_jobs"], strict["duplicate_alloc_names"],
            strict["overcommitted_nodes"],
            strict["tenant_quota_violations"]) == (0, 0, 0, 0)
    assert report["integrity"]["jobs_checked"] == 30


def test_render_report_equal(smoke_runs):
    _, ref_report = smoke_runs["ref"]
    _, port_report, _ = smoke_runs["port"]
    port_report = {k: v for k, v in port_report.items() if k != "server"}
    for r in (ref_report, port_report,
              {"scenario": "smoke", "worker_counts": [1, 2],
               "evals_per_s": {"1": 3.0, "2": 4.5}, "speedup": 1.5,
               "runs": {"1": ref_report, "2": port_report}}):
        out = {}
        for mod in (jreport, preport):
            buf = io.StringIO()
            mod.render_report(r, buf)
            out[mod] = buf.getvalue()
        assert out[preport] == out[jreport] and out[preport]


def test_overload_keeps_the_broker_bounded():
    sc = replace(pscenario.get_scenario("overload_10x"),
                 num_nodes=20, num_clients=8, arrival_rate=1500.0,
                 max_submissions=400, subscribers=8,
                 broker_max_pending=32, drain_s=30.0)
    h = pharness.LoadHarness(sc, device="cpu", server_options={
        "breaker": pbreaker.KernelCircuitBreaker(), "rng_seed": 7})
    peak = [0]
    done = threading.Event()

    def watch():
        while not done.wait(0.002):
            srv = h.server
            if srv is not None:
                peak[0] = max(peak[0], srv.eval_broker.pending_count())

    t = threading.Thread(target=watch, daemon=True)
    t.start()
    try:
        report = h.run()
    finally:
        done.set()
        t.join()
    off = report["offered"]
    broker = report["control_plane"]["broker"]
    assert off["admission_rejects_seen"] > 0
    assert broker["AdmissionRejects"] > 0
    assert broker["MaxPending"] == 32
    assert 0 < peak[0] <= 32
    assert report["sustained"]["stragglers_after_drain"] == 0
    assert off["submitted"] + off["dropped_after_retries"] <= 400
    assert report["sustained"]["completed_total"] == off["submitted"]
    assert oracle_routed(h) == 0


def test_two_server_run_is_clean():
    sc = replace(pscenario.get_scenario("smoke"), num_servers=2, audit=True)
    h = pharness.LoadHarness(sc, device="cpu", server_options={
        "breaker": pbreaker.KernelCircuitBreaker()})
    report = h.run()
    assert report["offered"]["submitted"] == 30
    assert report["sustained"]["completed_total"] == 30
    assert report["sustained"]["stragglers_after_drain"] == 0
    integ = report["integrity"]
    assert (integ["overplaced_jobs"], integ["duplicate_alloc_names"],
            integ["overcommitted_nodes"]) == (0, 0, 0)
    aud = report["auditor"]
    assert aud["violation_count"] == 0 and aud["lost_acked"] == 0
    assert aud["converged"]["converged"] == 1
    assert aud["final_sweep"]["jobs_checked"] == 30
    assert report["plan_forward"]["servers"] == 1
    assert report["plan_forward"]["errors_total"] == 0
    assert "error" not in report["follower_servers"][0]
    assert set(live_counts(h).values()) <= {1, 2}
    assert h._follower_procs == [] and h.server.threads() == []


def test_front_door_reservation_holds_the_cap():
    """``reserve_admission`` counts an admitted registration as pending
    until ``release_admission``: with a cap of 2, a third registration in
    flight is refused before any eval is written (a check alone admits
    it), and admitted again once one slot is released."""
    from nomad_tpu_torch.server.eval_broker import (BrokerLimitError,
                                                    EvalBroker)

    b = EvalBroker(max_pending=2)
    b.set_enabled(True)
    try:
        assert b.reserve_admission(50) and b.reserve_admission(50)
        b.check_admission(priority=ps.JOB_MAX_PRIORITY)    # bypass
        with pytest.raises(BrokerLimitError) as err:
            b.reserve_admission(50)
        assert (err.value.pending, err.value.limit) == (2, 2)
        b.release_admission()
        assert b.reserve_admission(50)
        assert not EvalBroker().reserve_admission(50)      # unbounded
    finally:
        b.set_enabled(False)


def test_front_door_reservation_under_contention():
    """Threads past the cores reserve and release slots with a short
    switch interval: the slots held never exceed the cap and all are
    handed back (a lost update would break either)."""
    import sys

    from nomad_tpu_torch.server.eval_broker import (BrokerLimitError,
                                                    EvalBroker)

    cap, held, peak = 3, [0], [0]
    count_l = threading.Lock()
    b = EvalBroker(max_pending=cap)
    b.set_enabled(True)

    def client():
        for _ in range(200):
            try:
                b.reserve_admission(50)
            except BrokerLimitError:
                continue
            with count_l:
                held[0] += 1
                peak[0] = max(peak[0], held[0])
            with count_l:
                held[0] -= 1
            b.release_admission()

    prior = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prior)
        b.set_enabled(False)
    assert 0 < peak[0] <= cap and b._admitting == 0
