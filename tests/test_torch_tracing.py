"""The port's tracing plane (``nomad_tpu_torch/utils/tracing.py``) against
the reference's (``nomad_tpu/utils/tracing.py``).

- The mechanics: each case of ``tests/test_tracing.py``'s
  ``TestTracerMechanics`` runs the same call sequence through both
  modules; the span dicts must be equal with their times and ids taken
  out (a parent is named, not numbered).
- The server lifecycle: the port's ``Server(ServerConfig(device="cpu",
  trace=True))`` against the reference's ``Server`` with
  ``NOMAD_TPU_TRACE=1`` on ``test_torch_server.py``'s register stream at a
  small size (the workers paused and released around each wave, seeded
  ids and tie-breaks in both).  Per eval, matched by its job and trigger,
  the multiset of span names and the (span, parent) structure must be
  equal, but for the names only the reference emits, listed in
  ``REF_ONLY`` with the queue item each waits for.  Then the port's own
  checks: a complete lifecycle for every register eval, one
  ``batch.fetch`` and a ``batch.device`` as long as the batch's device
  time, starts in lifecycle order.
- A plan forwarded over the wire: on a 3-server cluster of each package
  whose servers schedule only on follower workers, an eval's plan reaches
  the leader through ``Plan.Submit``; the eval's span names and parents
  and the ``rpc.request`` spans of the write methods equal the
  reference's.
- Disarmed, nothing: no ``Span`` and no ``Event`` is made through a
  config (b)-shaped server wave at a small size with both planes off.
- The port's tracing drill (``python -m nomad_tpu_torch.ops
  --selfcheck``) on the CPU.

Each test arms and disarms both packages' planes itself, as the
reference's ``_fresh_tracer`` fixture does.
"""
import collections

import jax  # noqa: F401  (the reference computes on the CPU backend)
import pytest

from nomad_tpu import fault as jfault
from nomad_tpu import mock as jmock
from nomad_tpu.ops import resident as jresident
from nomad_tpu.utils import tracing as jtracing
from nomad_tpu_torch import convert
from nomad_tpu_torch import fault as pfault
from nomad_tpu_torch.ops import __main__ as drills
from nomad_tpu_torch.ops import resident as president
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.structs import structs as ps
from nomad_tpu_torch.utils import tracing as ptracing
from nomad_tpu_torch.utils.backoff import wait_until

from test_torch_server import (World, cluster, conv, make_job, running,
                               strip_node)

# Span names the reference emits on this path and the port does not yet,
# with the ROADMAP queue 1 item each waits for (none: the broker's
# ``broker.admission_reject`` and ``broker.quota_reject`` are compared in
# tests/test_torch_tenancy.py).
REF_ONLY = {}

PKGS = {"ref": (jtracing, jfault), "port": (ptracing, pfault)}


@pytest.fixture(autouse=True)
def _fresh_tracers():
    """Both planes disarmed around every test."""
    jtracing.disable()
    ptracing.disable()
    yield
    jtracing.disable()
    ptracing.disable()
    jfault.disarm()


def shape(spans):
    """Span dicts without times and ids: each parent named by its span's
    name (``-`` for a root, ``?`` for a parent outside ``spans``)."""
    names = {sp["SpanID"]: sp["Name"] for sp in spans}
    out = []
    for sp in spans:
        parent = ("-" if sp["ParentID"] == 0
                  else names.get(sp["ParentID"], "?"))
        out.append({"Name": sp["Name"], "Parent": parent,
                    "Attrs": sp["Attrs"]})
    return out


# -- the mechanics, call for call ------------------------------------------

def case_disarmed(tr, fault):
    tr.disable()
    with tr.span("anything", eval_id="e1") as sp:
        sp.set(k="v")   # the no-op singleton takes attrs
    tr.event("thing", eval_id="e1")
    tr.record("thing", 0.0, 1.0, eval_id="e1")
    return {"enabled": tr.enabled(), "recent": tr.recent(10),
            "trace": tr.trace_for_eval("e1")}


def case_nesting(tr, fault):
    with tr.span("outer", eval_id="e1"):
        with tr.span("inner"):
            pass
        tr.event("marker")
    spans = tr.trace_for_eval("e1")
    return {"spans": sorted(shape(spans), key=lambda d: d["Name"]),
            "ends": all(sp["End"] >= sp["Start"] for sp in spans)}


def case_batch_eval_ids(tr, fault):
    with tr.span("batch", eval_ids=["a", "b"]):
        tr.event("inside")
    return {k: shape(tr.trace_for_eval(k)) for k in ("a", "b", "c")}


def case_eval_ids_cap(tr, fault):
    ids = [f"e{i}" for i in range(200)]
    with tr.span("batch", eval_ids=ids):
        pass
    attrs = tr.eval_id_attrs([type("E", (), {"id": i})() for i in ids], 200)
    return {"head": shape(tr.trace_for_eval("e0")),
            "last_kept": len(tr.trace_for_eval(
                f"e{tr.MAX_EVAL_IDS_PER_SPAN - 1}")),
            "past_cap": tr.trace_for_eval("e199"),
            "attrs": attrs}


def case_exception(tr, fault):
    with pytest.raises(ValueError):
        with tr.span("boom", eval_id="e2"):
            raise ValueError("kapow")
    return shape(tr.trace_for_eval("e2"))


def case_bounded_store(tr, fault):
    t = tr.enable(capacity=32, max_evals=4)
    for i in range(100):
        t.event("tick", eval_id=f"e{i}")
    for i in range(300):
        t.event("flood", eval_id="hot")
    hot = tr.trace_for_eval("hot")
    return {"recent": len(t.recent(1000)), "e0": tr.trace_for_eval("e0"),
            "e99": shape(tr.trace_for_eval("e99")),
            "hot": len(hot),
            "truncated": hot[0]["Attrs"].get("trace_truncated"),
            "bounds": (tr.DEFAULT_CAPACITY, tr.DEFAULT_MAX_EVALS,
                       tr.MAX_SPANS_PER_EVAL, tr.MAX_EVAL_IDS_PER_SPAN,
                       tr.MAX_MARKS)}


def case_marks(tr, fault):
    tr.mark("e5", job_id="j", submit="job_register")
    tr.close_mark("e5", job_id="j", outcome="acked")
    tr.close_mark("never-marked")
    return shape(tr.trace_for_eval("e5")) + shape(
        tr.trace_for_eval("never-marked"))


def case_fault_fire(tr, fault):
    with fault.scenario({"seed": 3, "faults": [
            {"point": "plan.apply", "action": "error", "times": 1}]}):
        with tr.span("lifecycle", eval_id="e3"):
            act = fault.faultpoint("plan.apply")
            fault.faultpoint("plan.apply")     # spent: no second fire
    return {"kind": act.kind, "spans": shape(tr.trace_for_eval("e3")),
            "trace": fault.trace() if hasattr(fault, "trace") else None}


MECHANICS = {
    "disarmed_is_inert": case_disarmed,
    "nesting_and_eval_inheritance": case_nesting,
    "batch_eval_ids_index_under_every_member": case_batch_eval_ids,
    "eval_ids_capped_per_span": case_eval_ids_cap,
    "exception_recorded": case_exception,
    "store_is_bounded": case_bounded_store,
    "marks_close_across_threads": case_marks,
    "fault_fire_correlation": case_fault_fire,
}


@pytest.mark.parametrize("case", sorted(MECHANICS))
def test_mechanics_match_the_reference(case):
    got = {}
    for kind, (tr, fault) in PKGS.items():
        tr.enable()
        try:
            got[kind] = MECHANICS[case](tr, fault)
        finally:
            tr.disable()
    # The fault trace lives inside the scenario in the port, on the plane
    # in the reference: both are compared by the span they left.
    if case == "fault_fire_correlation":
        for obs in got.values():
            obs.pop("trace")
    assert got["port"] == got["ref"]


def test_fault_fire_span_attrs():
    ptracing.enable()
    obs = case_fault_fire(ptracing, pfault)
    (fire,) = [sp for sp in obs["spans"] if sp["Name"] == "fault.fire"]
    assert fire == {"Name": "fault.fire", "Parent": "lifecycle",
                    "Attrs": {"point": "plan.apply", "rule": 0,
                              "action": "error", "eval_id": "e3"}}


# -- the server lifecycle ----------------------------------------------------

# The lifecycle of a register eval through the batch worker, in the order
# of its spans' starts (tests/test_tracing.py:164-166, extended).
LIFECYCLE = ("broker.enqueue", "broker.dequeue", "worker.process_batch",
             "batch.schedule", "batch.phase1", "batch.phase2",
             "batch.encode", "batch.device", "batch.fetch", "batch.metrics",
             "batch.finalize", "worker.submit_plan", "plan.evaluate",
             "plan.apply", "raft.apply", "broker.ack")
PHASES = ("batch.phase1", "batch.phase2", "batch.encode", "batch.device",
          "batch.fetch", "batch.metrics", "batch.finalize")


def lifecycle_scenario():
    nodes, wave1, wave2, big, extra = cluster()
    return nodes[:24], wave1, wave2, big, extra[:2]


def run_lifecycle(world, scenario, tr):
    nodes, wave1, wave2, big, extra = scenario
    for n in nodes:
        world.node_register(n)
    world.wave(wave1)
    world.wave(wave2)
    world.wave([big])
    with world.paused():
        for n in extra:
            world.node_register(n)
    host = sorted({a.node_id for a in world.srv.state.allocs(None)
                   if a.job_id == "svc-a"})[0]
    with world.paused() as srv:
        srv.node_update_status(host, ps.NODE_STATUS_DOWN)
    # A forced evaluation opens its umbrella at the evaluate path.
    with world.paused() as srv:
        srv.job_evaluate("svc-e")
    # Each eval by (job, trigger, ordinal by create index).
    seen = collections.Counter()
    traces = {}
    for ev in sorted(world.srv.state.evals(None),
                     key=lambda e: (e.job_id, e.triggered_by,
                                    e.create_index)):
        key = (ev.job_id, ev.triggered_by)
        traces[key + (seen[key],)] = {
            "spans": tr.trace_for_eval(ev.id), "status": ev.status}
        seen[key] += 1
    return traces


@pytest.fixture(scope="module")
def lifecycle_runs():
    scenario = lifecycle_scenario()
    runs = {}
    for kind in ("ref", "port"):
        tr = PKGS[kind][0]
        # Each package's one resident slot starts cold: a world of an
        # earlier test (seeded ids: the same store lineage) would turn
        # the first batch's resident.full_reencode into a fence.
        jresident.invalidate()
        president.invalidate()
        with pytest.MonkeyPatch.context() as mp:
            try:
                with running(World(kind, mp, trace=True)) as world:
                    assert tr.enabled()
                    runs[kind] = run_lifecycle(world, scenario, tr)
            finally:
                tr.disable()
    return runs


def structure(spans):
    """(name, parent name) pairs, sorted: the multiset of names and the
    parent structure in one."""
    return sorted((d["Name"], d["Parent"]) for d in shape(spans)
                  if d["Name"] not in REF_ONLY)


def test_every_eval_traced_in_both(lifecycle_runs):
    ref, port = lifecycle_runs["ref"], lifecycle_runs["port"]
    assert sorted(port) == sorted(ref)
    assert len(port) >= 9
    assert all(t["spans"] for t in port.values())


def test_per_eval_spans_match_the_reference(lifecycle_runs):
    ref, port = lifecycle_runs["ref"], lifecycle_runs["port"]
    for key in ref:
        assert structure(port[key]["spans"]) == \
            structure(ref[key]["spans"]), key


def test_ref_only_names_are_the_listed_ones(lifecycle_runs):
    ref_names = {sp["Name"] for t in lifecycle_runs["ref"].values()
                 for sp in t["spans"]}
    port_names = {sp["Name"] for t in lifecycle_runs["port"].values()
                  for sp in t["spans"]}
    assert ref_names - port_names <= set(REF_ONLY)
    assert port_names <= ref_names


def test_register_evals_have_a_complete_lifecycle(lifecycle_runs):
    # The first eval of each registered job (a blocked follow-up keeps
    # its trigger but was never submitted).
    regs = {k: t for k, t in lifecycle_runs["port"].items()
            if k[1] == ps.EVAL_TRIGGER_JOB_REGISTER and k[2] == 0}
    assert len(regs) == 8
    for key, t in regs.items():
        spans = t["spans"]
        by_name = {}
        for sp in spans:
            by_name.setdefault(sp["Name"], sp)
        missing = [n for n in LIFECYCLE + ("eval.e2e",) if n not in by_name]
        assert not missing, (key, missing)
        starts = [by_name[n]["Start"] for n in LIFECYCLE
                  if n != "raft.apply"]
        assert starts == sorted(starts), key
        root = by_name["batch.schedule"]
        # Within a batch: one fetch, the phases under the root.
        mine = [sp for sp in spans
                if sp["ParentID"] == root["SpanID"]]
        assert sum(sp["Name"] == "batch.fetch" for sp in mine) == 1, key
        assert {n for n in PHASES} <= {sp["Name"] for sp in mine}, key
        e2e = by_name["eval.e2e"]
        assert e2e["Attrs"]["outcome"] == "acked"
        assert e2e["Start"] <= by_name["broker.enqueue"]["Start"]
        assert e2e["End"] >= by_name["broker.ack"]["Start"]


def test_forced_evaluation_opens_its_umbrella(lifecycle_runs):
    """A forced evaluation of a placed job changes nothing, and its
    umbrella still spans submit to ack."""
    for kind in ("ref", "port"):
        spans = lifecycle_runs[kind][("svc-e", "job-register", 1)]["spans"]
        (e2e,) = [sp for sp in spans if sp["Name"] == "eval.e2e"]
        assert e2e["Attrs"]["submit"] == "job_evaluate", kind
        assert e2e["Attrs"]["outcome"] == "acked", kind


def test_pipelined_drain_leaks_no_span(monkeypatch):
    """The pipelined drain interleaves batches on the worker's thread:
    its ``worker.process_batch`` is recorded after the fact, so no span
    is left open on the thread's stack between batches, and every
    recorded span's parent was itself recorded."""
    from nomad_tpu_torch.server.worker import BatchWorker

    open_at_ack = []
    ack = BatchWorker._ack_batch

    def ack_rec(self, batch, attempts):
        open_at_ack.append(ptracing.TRACER.current())
        return ack(self, batch, attempts)

    monkeypatch.setattr(BatchWorker, "_ack_batch", ack_rec)
    srv = Server(ServerConfig(device="cpu", rng_seed=5, batch_size=2,
                              pipeline=True, trace=True,
                              min_heartbeat_ttl=3600.0))
    srv.start()
    try:
        for n in cluster()[0][:12]:
            srv.node_register(conv(strip_node(n), convert.node_from_dict))
        assert srv.set_workers_paused(True, timeout=30.0)
        ids = [srv.job_register(conv(make_job(f"p-{k}", 3, 250, 128),
                                     convert.job_from_dict))[1]
               for k in range(7)]
        srv.set_workers_paused(False)
        assert wait_until(lambda: all(
            any(sp["Name"] == "broker.ack"
                for sp in srv.trace_for_eval(i)) for i in ids), 60.0)
        recent = ptracing.recent(ptracing.DEFAULT_CAPACITY)
    finally:
        srv.shutdown()
    assert len(open_at_ack) >= 4 and all(sp is None for sp in open_at_ack)
    recorded = {sp["SpanID"] for sp in recent}
    assert all(sp["ParentID"] == 0 or sp["ParentID"] in recorded
               for sp in recent)
    for i in ids:
        (pb,) = [sp for sp in srv.trace_for_eval(i)
                 if sp["Name"] == "worker.process_batch"]
        assert pb["Attrs"]["pipelined"] is True


# -- a plan forwarded from a follower ----------------------------------------

# The write methods a follower worker sends its leader for one eval, each
# once (the dequeue is polled, so its count varies).
WIRE_WRITES = ("Plan.Submit", "Eval.Update", "Eval.Ack")


def forwarded_plan_run(kind, mp):
    """A 3-server cluster of ``kind`` with follower workers only, traced:
    one job placed through a follower.  The eval's spans, and every
    ``rpc.request`` span of ``WIRE_WRITES`` with its subtree."""
    from nomad_tpu.server import Server as JServer
    from nomad_tpu.server import ServerConfig as JServerConfig
    from test_torch_raft import SLOW_RAFT, wait_for_leader

    tr = PKGS[kind][0]
    tr.enable()
    servers, first = [], None
    for key, env in (("raft_heartbeat", "NOMAD_TPU_RAFT_HEARTBEAT_S"),
                     ("raft_election_min", "NOMAD_TPU_RAFT_ELECTION_MIN_S"),
                     ("raft_election_max",
                      "NOMAD_TPU_RAFT_ELECTION_MAX_S")):
        mp.setenv(env, str(SLOW_RAFT[key]))
    try:
        for i in range(3):
            join = [first] if first else []
            if kind == "ref":
                srv = JServer(JServerConfig(
                    node_name=f"t-{i}", enable_rpc=True, bootstrap_expect=3,
                    start_join=join, num_schedulers=0,
                    follower_schedulers=1, follower_scheduling=True,
                    min_heartbeat_ttl=3600.0))
            else:
                srv = Server(ServerConfig(
                    device="cpu", node_name=f"t-{i}", enable_rpc=True,
                    bootstrap_expect=3, start_join=join, num_schedulers=0,
                    follower_schedulers=1, min_heartbeat_ttl=3600.0,
                    **SLOW_RAFT))
            first = first or srv.config.rpc_advertise
            servers.append(srv)
        for srv in servers:
            srv.start()
        leader = wait_for_leader(servers)
        assert wait_until(lambda: all(len(x.raft.peers) == 3
                                      for x in servers), 30.0)
        node = strip_node(jmock.node(), "t-node")
        job = make_job("t-job", 2, 100, 128)
        if kind == "port":
            node = conv(node, convert.node_from_dict)
            job = conv(job, convert.job_from_dict)
        leader.node_register(node)
        _, eval_id = leader.job_register(job)
        assert wait_until(lambda: any(
            sp["Name"] == "broker.ack" for sp in tr.trace_for_eval(eval_id)),
            60.0)
        recent = tr.recent(tr.DEFAULT_CAPACITY)
        spans = tr.trace_for_eval(eval_id)
    finally:
        for srv in servers:
            srv.shutdown()
        tr.disable()
    roots = {sp["SpanID"] for sp in recent if sp["Name"] == "rpc.request"
             and sp["Attrs"].get("method") in WIRE_WRITES}
    subtree = [sp for sp in recent
               if sp["SpanID"] in roots or sp["ParentID"] in roots]
    # Ids are drawn at random in both packages: the attrs compare without.
    return {"eval": structure(spans), "wire": sorted(
        (d["Name"], d["Parent"], repr(sorted(
            (k, v) for k, v in d["Attrs"].items() if k != "eval_id")))
        for d in shape(subtree))}


@pytest.fixture(scope="module")
def forwarded_runs():
    runs = {}
    for kind in ("ref", "port"):
        with pytest.MonkeyPatch.context() as mp:
            runs[kind] = forwarded_plan_run(kind, mp)
    return runs


def test_forwarded_plan_spans_match_the_reference(forwarded_runs):
    ref, port = forwarded_runs["ref"], forwarded_runs["port"]
    assert port["eval"] == ref["eval"]
    assert any(name == "worker.submit_plan" for name, _ in port["eval"])
    assert port["wire"] == ref["wire"]
    assert [w[:2] for w in port["wire"]
            if "Plan.Submit" in w[2]] == [("rpc.request", "-")]


# -- disarmed, nothing -----------------------------------------------------

def test_disarmed_planes_make_no_span_and_no_event(monkeypatch):
    """A config (b)-shaped wave (jobs of many asks each, then a follow-up
    wave) at a small size through the port's server with both planes
    off: no Span and no Event is constructed anywhere on the path."""
    made = collections.Counter()

    def counting(cls, key):
        init = cls.__init__

        def __init__(self, *a, **kw):
            made[key] += 1
            init(self, *a, **kw)
        monkeypatch.setattr(cls, "__init__", __init__)

    counting(ptracing.Span, "span")
    counting(ps.Event, "event")
    world_nodes = [strip_node(n) for n in cluster()[0][:16]]
    srv = Server(ServerConfig(device="cpu", rng_seed=3, batch_size=64,
                              min_heartbeat_ttl=3600.0))
    srv.start()
    try:
        for n in world_nodes:
            srv.node_register(conv(n, convert.node_from_dict))
        jobs = [make_job(f"b-{k}", 10, 100, 64) for k in range(10)]
        follow = [make_job(f"f-{k}", 2, 100, 64) for k in range(10)]
        for wave in (jobs, follow):
            assert srv.set_workers_paused(True, timeout=30.0)
            ids = [srv.job_register(conv(j, convert.job_from_dict))[1]
                   for j in wave]
            srv.set_workers_paused(False)
            assert wait_until(lambda: all(
                srv.state.eval_by_id(None, i).status == "complete"
                for i in ids), 60.0)
        placed = [a for a in srv.state.allocs(None)
                  if not a.terminal_status()]
        assert len(placed) == 120
        assert srv.state.event_broker is None
        assert "events" not in srv.stats()
    finally:
        srv.shutdown()
    assert not ptracing.enabled()
    assert made == collections.Counter()


# -- the drill -------------------------------------------------------------

def test_tracing_drill_on_the_cpu():
    lines = []
    assert drills.tracing_drill(seed=0, device="cpu", log=lines.append), \
        lines
    assert lines and lines[-1].startswith("tracing drill: OK")
    assert not ptracing.enabled()
