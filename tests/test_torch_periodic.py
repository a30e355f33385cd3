"""The port's periodic and parameterized jobs (``server/periodic.py``, the
server's dispatcher wiring, ``Server.job_dispatch``) against the
reference's, on the CPU.

- ``PeriodicDispatch`` alone in both packages, on a patched clock: add,
  re-add, remove (the heap's generation tombstones), ``force_run`` and
  ``derive_job``, and a test-spec launch fired by the dispatcher's own
  thread;
- twin servers (the port's ``Server(device="cpu")`` and the reference's,
  no scheduler, so every eval stays pending; one id sequence and one
  clock for both): a periodic or parameterized registration or
  deregistration makes no eval; ``periodic_force`` launches a child
  ``<id>/periodic-<launch>`` with its eval and its launch row;
  ``prohibit_overlap`` skips a launch while the previous child is live;
  ``job_plan``'s ``next_periodic_launch``; ``job_dispatch``'s children
  and every validation error, by message; the children summaries;
- a test-spec launch by the dispatcher's timer, and the catch-up of a
  missed launch after a ``FileLog`` restart, in both packages, with the
  quota ledger rebuilt from the pending child's eval.

Exact on every id, status, count and message.
"""
import dataclasses
import re
import time
import types

import jax  # noqa: F401  (the reference's package imports it)
import pytest

from nomad_tpu import mock as jmock
from nomad_tpu.server import periodic as jperiodic
from nomad_tpu.server.server import Server as JServer
from nomad_tpu.server.server import ServerConfig as JServerConfig
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server import periodic as pperiodic
from nomad_tpu_torch.structs import structs as ps
from nomad_tpu_torch.utils.backoff import wait_until

NOW = 1_800_000_000.0
DISPATCHED = re.compile(r"(.+)/dispatch-(\d+)-[0-9a-f]{8}")


class Clock:
    def __init__(self, t=NOW):
        self.t = t

    def time(self):
        return self.t


def conv(obj, fn):
    return fn(dataclasses.asdict(obj))


def batch_job(job_id, count=2, ns="default"):
    j = jmock.job()
    j.id = j.name = job_id
    j.type = "batch"
    j.namespace = ns
    j.task_groups[0].count = count
    for t in j.task_groups[0].tasks:
        t.resources.networks = []
    return j


def periodic_job(job_id, spec, spec_type=js.PERIODIC_SPEC_TEST,
                 overlap=False, **kw):
    j = batch_job(job_id, **kw)
    j.periodic = js.PeriodicConfig(enabled=True, spec=spec,
                                   spec_type=spec_type,
                                   prohibit_overlap=overlap)
    return j


def param_job(job_id, payload="optional", required=("k",),
              optional=("o",), **kw):
    j = batch_job(job_id, **kw)
    j.parameterized_job = js.ParameterizedJobConfig(
        payload=payload, meta_required=list(required),
        meta_optional=list(optional))
    j.task_groups[0].tasks[0].dispatch_payload = js.DispatchPayloadConfig(
        file="input.json")
    return j


# -- PeriodicDispatch alone ----------------------------------------------------

def dispatcher_case(kind, mp):
    mod = pperiodic if kind == "port" else jperiodic
    conv_job = ((lambda j: conv(j, convert.job_from_dict)) if kind == "port"
                else (lambda j: j))
    clock = Clock()
    mp.setattr(mod, "time", types.SimpleNamespace(time=clock.time))
    calls = []
    d = mod.PeriodicDispatch(
        lambda parent, child, at: calls.append((parent.id, child.id,
                                                child.parent_id, at)))
    out = []
    a = conv_job(periodic_job("a", f"{NOW + 100},{NOW + 200}"))
    b = conv_job(periodic_job("b", f"{NOW + 150}"))
    d.add(a)                       # ignored: not enabled
    out.append(sorted(d.tracked))
    d.set_enabled(True)
    try:
        d.add(a)
        d.add(b)
        d.add(a)                   # re-add: the first entry tombstones
        out.append((sorted(d._heap), dict(d._generation)))
        d.remove("b")
        out.append((sorted(d.tracked), dict(d._generation)))
        plain = conv_job(batch_job("plain"))
        d.add(plain)               # not periodic: removed, never tracked
        out.append((sorted(d.tracked), dict(d._generation)))
        child = d.force_run("a")
        out.append((child.id, child.name, child.parent_id, child.periodic,
                    child.status))
        out.append(d.force_run("missing"))
        out.append([j.id for j in d.tracked_jobs()])
    finally:
        d.set_enabled(False)
    out.append((sorted(d.tracked), d._heap))
    out.append(calls)
    derived = mod.derive_job(a, NOW + 12.7)
    out.append((derived.id, derived.name, derived.parent_id,
                derived.periodic, derived.status, a.periodic is not None))
    return out


def test_dispatcher_equals_the_reference(monkeypatch):
    out = {}
    for kind in ("ref", "port"):
        with monkeypatch.context() as mp:
            out[kind] = dispatcher_case(kind, mp)
    assert out["port"] == out["ref"]
    assert out["port"][4][0] == f"a/periodic-{int(NOW)}"


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_dispatcher_thread_fires_a_test_spec_launch(kind):
    mod = pperiodic if kind == "port" else jperiodic
    conv_job = ((lambda j: conv(j, convert.job_from_dict)) if kind == "port"
                else (lambda j: j))
    fired = []
    d = mod.PeriodicDispatch(lambda p, c, at: fired.append((c.id, at)))
    d.set_enabled(True)
    try:
        at = time.time() + 0.5
        d.add(conv_job(periodic_job("t", f"{at}")))
        assert wait_until(lambda: fired, 10.0)
        time.sleep(0.3)
    finally:
        d.set_enabled(False)
    assert fired == [(f"t/periodic-{int(at)}", at)]


# -- twin servers ---------------------------------------------------------------

def start_server(kind, data_dir="", schedulers=0):
    if kind == "port":
        srv = Server(ServerConfig(device="cpu", num_schedulers=schedulers,
                                  min_heartbeat_ttl=3600.0,
                                  data_dir=data_dir, snapshot_entries=0,
                                  snapshot_bytes=0))
    else:
        srv = JServer(JServerConfig(num_schedulers=schedulers,
                                    min_heartbeat_ttl=3600.0,
                                    data_dir=data_dir))
    srv.start()
    assert wait_until(srv.is_leader, 10.0)
    return srv


class Twin:
    """One server of either package with one id sequence and a clock."""

    def __init__(self, kind, mp, data_dir="", fake_clock=True):
        self.kind = kind
        self.port = kind == "port"
        self.s = ps if self.port else js
        ids = iter(range(100_000))
        mp.setattr(self.s, "generate_uuid",
                   lambda: f"{next(ids):08x}-0000-0000-0000-000000000000")
        self.clock = Clock()
        if fake_clock:
            # The dispatch clock and the launch clock: the structs'
            # ``now`` and the periodic module's ``time.time``.
            mp.setattr(self.s, "now", self.clock.time)
            mp.setattr(pperiodic if self.port else jperiodic, "time",
                       types.SimpleNamespace(time=self.clock.time))
        self.srv = start_server(kind, data_dir)

    def job(self, j):
        return conv(j, convert.job_from_dict) if self.port else j

    def register(self, j):
        return self.srv.job_register(self.job(j))

    def evals(self):
        return sorted((self.child_key(e.job_id), e.triggered_by, e.status)
                      for e in self.srv.state.evals(None))

    def child_key(self, job_id):
        """A dispatched child's id with its uuid part replaced by the
        child's ordinal among its parent's children (the packages draw
        their ids from their own sequences)."""
        m = DISPATCHED.fullmatch(job_id)
        if m is None:
            return job_id
        st = self.srv.state
        kids = sorted((j.create_index, j.id) for j in st.jobs(None)
                      if j.parent_id == m.group(1)
                      and DISPATCHED.fullmatch(j.id))
        ordinal = [jid for _, jid in kids].index(job_id)
        return f"{m.group(1)}/dispatch-{m.group(2)}-#{ordinal}"

    def dispatch(self, *args):
        index, child, eval_id = self.srv.job_dispatch(*args)
        return index, self.child_key(child), bool(eval_id)

    def jobs(self):
        st = self.srv.state
        out = []
        for j in sorted(st.jobs(None), key=lambda j: self.child_key(j.id)):
            summ = st.job_summary_by_id(None, j.id)
            out.append((self.child_key(j.id), j.parent_id, j.status, j.type,
                        j.is_periodic(), j.is_parameterized(),
                        bytes(j.payload), sorted(j.meta.items()),
                        dataclasses.astuple(summ.children)
                        if summ and summ.children else None))
        return out

    def launches(self):
        return sorted((p.id, p.launch)
                      for p in self.srv.state.periodic_launches(None))


def error_of(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001
        return (type(e).__name__, str(e))
    return None


def lifecycle_calls(t):
    out = []
    # Registrations of periodic and parameterized jobs make no eval.
    out.append(t.register(periodic_job("per", f"{NOW + 86400}"))[1])
    out.append(t.register(param_job("par"))[1])
    out.append(t.evals())
    # A forced launch: the child and its eval, then the launch row.
    t.clock.t = NOW + 10
    child = t.srv.periodic_force("per")
    out.append((child.id, child.parent_id))
    out.append(t.launches())
    out.append(t.srv.periodic_force("nope"))
    # prohibit_overlap: a second launch while the first child is live is
    # skipped (no child, no launch row moved).
    t.register(periodic_job("solo", f"{NOW + 86400}", overlap=True))
    t.srv.periodic_force("solo")
    t.clock.t = NOW + 20
    t.srv.periodic_force("solo")
    out.append([j[0] for j in t.jobs() if j[1] == "solo"])
    # Dispatches: children with payload and meta, and the errors.
    out.append(t.dispatch("par", b"data", {"k": "1", "o": "x"}))
    out.append(t.dispatch("par", b"", {"k": "2"}))
    t.register(param_job("req", payload="required", required=()))
    t.register(param_job("forb", payload="forbidden", required=()))
    t.register(batch_job("plain"))
    for args in [("par", b"", {}), ("par", b"", {"k": "1", "bad": "2"}),
                 ("req", b"", {}), ("forb", b"x", {}),
                 ("par", b"x" * (16 * 1024 + 1), {"k": "1"}),
                 ("plain", b"", {}), ("nope", b"", {})]:
        out.append(error_of(lambda a=args: t.srv.job_dispatch(*a)))
    out.append(t.dispatch("forb", b"", {}))
    # Evaluate and deregister of a periodic job: refused / no eval.
    out.append(error_of(lambda: t.srv.job_evaluate("per")))
    out.append(error_of(lambda: t.srv.job_evaluate("par")))
    # job_plan's next launch: a test spec and a cron spec.
    out.append(t.srv.job_plan(t.job(periodic_job(
        "plan-t", f"{NOW + 30},{NOW + 99}")), diff=False)
        .next_periodic_launch)
    out.append(t.srv.job_plan(t.job(periodic_job(
        "plan-c", "15 */2 * * *", spec_type=js.PERIODIC_SPEC_CRON)),
        diff=False).next_periodic_launch)
    out.append(t.srv.job_plan(t.job(batch_job("plan-b")),
                              diff=False).next_periodic_launch)
    out.append(t.evals())
    out.append(t.jobs())
    out.append(t.launches())
    out.append(t.srv.job_deregister("solo", purge=False)[1])
    out.append(t.srv.job_deregister("par", purge=True)[1])
    out.append([j[0] for j in t.jobs()])
    return out


@pytest.fixture(scope="module")
def lifecycle_runs():
    runs = {}
    for kind in ("ref", "port"):
        with pytest.MonkeyPatch.context() as mp:
            t = Twin(kind, mp)
            try:
                runs[kind] = lifecycle_calls(t)
            finally:
                t.srv.shutdown()
    return runs


def test_lifecycle_calls_equal_the_reference(lifecycle_runs):
    assert lifecycle_runs["port"] == lifecycle_runs["ref"]


def test_lifecycle_calls_do_what_they_should(lifecycle_runs):
    out = lifecycle_runs["port"]
    assert out[0] == "" and out[1] == "" and out[2] == []
    assert out[3] == (f"per/periodic-{int(NOW + 10)}", "per")
    assert out[4] == [("per", NOW + 10)]
    assert out[5] is None
    assert out[6] == [f"solo/periodic-{int(NOW + 10)}"]
    errors = out[9:16]
    assert errors[0] == ("ValueError", "missing required dispatch metadata: k")
    assert errors[1] == ("ValueError", "dispatch metadata not allowed: bad")
    assert errors[5] == ("ValueError", "job 'plain' is not parameterized")
    assert errors[6][0] == "KeyError"
    assert out[17] == ("ValueError", "can't evaluate periodic job")
    assert out[19] == NOW + 30
    assert out[21] == 0.0
    jobs = {j[0]: j for j in out[23]}
    child = jobs[out[7][1]]
    assert out[7][1] == f"par/dispatch-{int(NOW + 20)}-#0" and out[7][2]
    assert child[1] == "par" and child[6] == b"data"
    assert dict(child[7]) == {"owner": "armon", "k": "1", "o": "x"}
    assert not child[5]
    # Both parents are running; each child pending (no scheduler).
    assert jobs["par"][2] == jobs["per"][2] == "running"
    assert out[25] == "" and out[26] == ""


def run_restart(kind, mp, data_dir):
    """A test-spec launch by the timer, the server down across the next
    launch, and the catch-up at the restart."""
    t = Twin(kind, mp, data_dir=str(data_dir), fake_clock=False)
    first = time.time() + 1.0
    second = first + 1.5
    out = {}
    try:
        t.srv.namespace_upsert(t.s.Namespace(name="q", max_live_allocs=100))
        t.register(periodic_job("cron", f"{first},{second}", ns="q",
                                count=3))
        assert wait_until(lambda: t.launches(), 10.0)
        out["first"] = t.launches()
        out["first_children"] = [j[0] for j in t.jobs() if j[1] == "cron"]
        out["reserved"] = t.srv.quota_ledger.reserved("q")
    finally:
        t.srv.shutdown()
    while time.time() < second + 0.2:
        time.sleep(0.1)
    t.srv = start_server(kind, str(data_dir))
    try:
        # The missed launch runs at the restart, stamped with its time.
        assert wait_until(lambda: len(t.launches()) == 1
                          and t.launches()[0][1] > second, 10.0)
        out["after"] = t.launches()
        out["children"] = [j[0] for j in t.jobs() if j[1] == "cron"]
        # Rebuilt from the two children's pending evals.
        out["reserved_after"] = t.srv.quota_ledger.reserved("q")
        out["evals"] = t.evals()
    finally:
        t.srv.shutdown()
    return out, first, second


def test_timer_launch_and_restart_catch_up(tmp_path, monkeypatch):
    out = {}
    for kind in ("ref", "port"):
        with monkeypatch.context() as mp:
            out[kind] = run_restart(kind, mp, tmp_path / kind)
    (port, first, second), (ref, rfirst, rsecond) = out["port"], out["ref"]
    assert port["first"] == [("cron", first)]
    assert port["first_children"] == [f"cron/periodic-{int(first)}"]
    assert port["reserved"] == 3
    (launch,), = port["after"],
    assert launch[0] == "cron" and launch[1] > second
    assert port["children"] == sorted([f"cron/periodic-{int(first)}",
                                       f"cron/periodic-{int(launch[1])}"])
    assert port["reserved_after"] == 6
    # The reference did the same on its own clock.
    assert ref["reserved"] == 3 and ref["reserved_after"] == 6
    assert len(ref["children"]) == len(port["children"]) == 2
    # The same evals, their launch times aside.
    assert ([e[1:] for e in port["evals"]]
            == [e[1:] for e in ref["evals"]] == [
                ("job-register", "pending")] * 2)


def test_follower_forwards_the_lifecycle_writes():
    """Three port servers on the CPU: every new write through a follower
    is forwarded to the leader (Namespace.Upsert/Delete, Job.Dispatch,
    Periodic.Force, Node.UpdateAlloc, System.GarbageCollect,
    System.ReconcileJobSummaries), and the reads answer over the wire
    (Namespace.List/Status, Status.BrokerStats)."""
    from nomad_tpu_torch.server.rpc import ConnPool

    servers, first = [], None
    for i in range(3):
        srv = Server(ServerConfig(
            device="cpu", node_name=f"fw-{i}", enable_rpc=True,
            bootstrap_expect=3, start_join=[first] if first else [],
            num_schedulers=1, follower_scheduling=False,
            min_heartbeat_ttl=3600.0))
        first = first or srv.config.rpc_advertise
        servers.append(srv)
    for srv in servers:
        srv.start()
    pool = ConnPool()
    try:
        assert wait_until(lambda: any(x.is_leader() and x.raft.is_raft_leader()
                                      for x in servers), 60.0)
        leader = next(x for x in servers if x.is_leader())
        f = next(x for x in servers if x is not leader)
        n = jmock.node()
        n.resources.networks = []
        n.reserved.networks = []
        f.node_register(conv(n, convert.node_from_dict))
        f.namespace_upsert(ps.Namespace(name="fw", max_live_allocs=50))
        f.namespace_upsert(ps.Namespace(name="gone"))
        # The existence check reads the follower's replica.
        assert wait_until(lambda: f.state.namespace_by_name(None, "gone")
                          is not None, 10.0)
        f.namespace_delete("gone")
        per = periodic_job("per", f"{time.time() + 86400}", ns="fw")
        par = param_job("par", ns="fw")
        for j in (per, par):
            f.job_register(conv(j, convert.job_from_dict))
        assert wait_until(lambda: f.state.job_by_id(None, "par")
                          is not None, 10.0)
        child = f.periodic_force("per")
        index, dispatched, eval_id = f.job_dispatch("par", b"p", {"k": "1"})
        assert dispatched.startswith("par/dispatch-") and eval_id
        assert child is not None and child.id.startswith("per/periodic-")

        def done():
            evs = leader.state.evals(None)
            return len(evs) == 2 and all(e.status == "complete" for e in evs)

        assert wait_until(done, 60.0)
        assert wait_until(lambda: f.raft.applied_index()
                          >= leader.raft.applied_index(), 30.0)
        allocs = [a.copy() for a in f.state.allocs(None)]
        for a in allocs:
            a.client_status = "complete"
        f.node_update_allocs(allocs)
        f.system_reconcile_summaries()
        f.system_gc()
        assert wait_until(lambda: not [j for j in leader.state.jobs(None)
                                       if j.parent_id], 60.0)
        assert f.metrics.sink.latest()["CounterTotals"].get(
            "nomad.rpc.forward", 0) >= 9
        addr = leader.config.rpc_advertise
        names = pool.call(addr, "Namespace.List", {})["Namespaces"]
        assert sorted(ns.name for ns in names) == ["fw"]
        status = pool.call(addr, "Namespace.Status", {"Name": "fw"})
        assert status["Namespace"].max_live_allocs == 50
        assert status["Usage"]["LiveAllocs"] == 0
        stats = pool.call(f.config.rpc_advertise, "Status.BrokerStats", {})
        assert "Tenants" in stats and not stats["FollowerSched"]["IsLeader"]
        assert wait_until(lambda: len({x.fsm_fingerprint()
                                       for x in servers}) == 1, 30.0)
    finally:
        pool.close()
        for srv in servers:
            srv.shutdown()
