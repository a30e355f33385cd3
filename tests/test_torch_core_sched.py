"""The port's GC (``nomad_tpu_torch/server/core_sched.py`` over the port's
FSM, ``EVAL_DELETE`` and ``StateStore.delete_eval``) against the
reference's, on twin stores.

Each package gets its own FSM on an in-memory log, a ``TimeTable`` and an
event broker on its store, and takes one seeded write sequence built from
the reference's mock objects (converted for the port): six nodes (one
down with allocs, one down without), batch, service and periodic-child
jobs whose placements are slab rows (one slab with an id taken over by a
client update), standalone alloc rows in a tenant namespace, terminal
and live evals, written in two phases two hours apart on a patched
clock.  Then one core eval runs through ``CoreScheduler``: eval-gc,
job-gc and node-gc on their ``TimeTable`` thresholds under the patched
clock, and force-gc.  After it, on both stores: the evals, allocs, jobs
(with statuses), nodes, job summaries (children counts included), the
per-namespace usage fold and the usage-delta feed are equal; one
``EvalDeleted`` per deleted eval; the columnar mirror equals the
reference's and a walk, and the delta feed replayed onto the pre-GC
usage (the resident mirror's catch-up) equals the walk.  The summary
reconcile (``RECONCILE_JOB_SUMMARIES``) and a persist/restore of the
port's store after GC are held the same way.  Exact on every count.
"""
import dataclasses
import types

import jax  # noqa: F401  (the reference's package imports it)
import numpy as np
import pytest

from nomad_tpu import mock as jmock
from nomad_tpu.server import core_sched as jcore
from nomad_tpu.server import event_broker as jevents
from nomad_tpu.server.fsm import FSM as JFSM
from nomad_tpu.server.fsm import MessageType as JMT
from nomad_tpu.server.fsm import TimeTable as JTimeTable
from nomad_tpu.server.raft import InmemLog as JInmem
from nomad_tpu.state import columnar as jcolumnar
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert
from nomad_tpu_torch.server import core_sched as pcore
from nomad_tpu_torch.server import event_broker as pevents
from nomad_tpu_torch.server.fsm import FSM as PFSM
from nomad_tpu_torch.server.fsm import MessageType as PMT
from nomad_tpu_torch.server.fsm import TimeTable as PTimeTable
from nomad_tpu_torch.server.raft import InmemLog as PInmem
from nomad_tpu_torch.state import StateStore as PStore
from nomad_tpu_torch.state import columnar as pcolumnar
from nomad_tpu_torch.structs import structs as ps

from test_torch_columnar import assert_mirrors, scratch_mirror

T0 = 1_700_000_000.0
HOUR = 3600.0


@pytest.fixture(autouse=True)
def columnar_on(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_COLUMNAR", "1")
    monkeypatch.setenv("NOMAD_TPU_COLUMNAR_GUARD_EVERY", "1")
    for mod in (pcolumnar, jcolumnar):
        mod.reset_counters()


class Side:
    """One package's FSM, log, time table and event broker."""

    def __init__(self, kind):
        self.port = kind == "port"
        self.s = ps if self.port else js
        self.MT = PMT if self.port else JMT
        self.core = pcore if self.port else jcore
        self.fsm = PFSM() if self.port else JFSM()
        self.raft = (PInmem if self.port else JInmem)(self.fsm)
        self.tt = (PTimeTable if self.port else JTimeTable)()
        self.events = (pevents if self.port else jevents).EventBroker()
        self.fsm.state.event_broker = self.events
        self.evals_done = []

    @property
    def state(self):
        return self.fsm.state

    def apply(self, name, payload):
        return self.raft.apply(getattr(self.MT, name), payload)

    def obj(self, ref_obj, fn):
        return fn(dataclasses.asdict(ref_obj)) if self.port else ref_obj

    # The planner CoreScheduler hands its finished eval to.
    def update_eval(self, ev):
        self.evals_done.append(ev)
        self.apply("EVAL_UPDATE", {"evals": [ev]})


def node(i):
    n = jmock.node()
    n.id = n.name = f"node-{i}"
    n.resources.networks = []
    n.reserved.networks = []
    n.compute_class()
    return n


def job(job_id, type_, count, parent="", namespace="default", periodic=False):
    j = jmock.job()
    j.id = j.name = job_id
    j.type = type_
    j.parent_id = parent
    j.namespace = namespace
    j.task_groups[0].count = count
    for t in j.task_groups[0].tasks:
        t.resources.networks = []
        t.resources.cpu = 250
        t.resources.memory_mb = 128
    if periodic:
        j.periodic = js.PeriodicConfig(enabled=True, spec=str(T0 + 99 * HOUR),
                                       spec_type=js.PERIODIC_SPEC_TEST)
    return j


def ev(side, eval_id, job_id, status, namespace="default", type_="batch"):
    return side.s.Evaluation(
        id=eval_id, namespace=namespace, priority=50, type=type_,
        triggered_by="job-register", job_id=job_id, status=status)


def slab(side, j, eval_id, prefix, nodes):
    s = side.s
    proto = s.Allocation(
        eval_id=eval_id, job_id=j.id, task_group="web",
        resources=s.Resources(cpu=250, memory_mb=128, disk_mb=300),
        desired_status="run", client_status="pending")
    n = len(nodes)
    return s.AllocSlab(proto=proto, ids=[f"{prefix}-{i}" for i in range(n)],
                       names=[f"{j.id}.web[{i}]" for i in range(n)],
                       node_ids=list(nodes))


def rows(side, j, eval_id, prefix, nodes, namespace):
    s = side.s
    return [s.Allocation(
        id=f"{prefix}-{i}", eval_id=eval_id, namespace=namespace,
        name=f"{j.id}.web[{i}]", node_id=nid, job_id=j.id, task_group="web",
        resources=s.Resources(cpu=100, memory_mb=64, disk_mb=300),
        desired_status="run", client_status="pending")
        for i, nid in enumerate(nodes)]


def client_update(side, alloc_ids, status):
    out = []
    for aid in alloc_ids:
        a = side.state.alloc_by_id(None, aid).copy()
        a.client_status = status
        out.append(a)
    side.apply("ALLOC_CLIENT_UPDATE", {"allocs": out})


def place(side, ref_job, eval_id, *, slab_nodes=(), row_nodes=(),
          namespace="default"):
    j = side.state.job_by_id(None, ref_job.id)
    payload = {"job": j, "allocs": [], "eval_id": eval_id}
    if slab_nodes:
        payload["slabs"] = [slab(side, j, eval_id, f"{j.id}-s", slab_nodes)]
    if row_nodes:
        payload["allocs"] = rows(side, j, eval_id, f"{j.id}-r", row_nodes,
                                 namespace)
    side.apply("APPLY_PLAN_RESULTS", payload)


def build(side, scenario):
    """The write sequence: phase 1 at T0, phase 2 two hours later; the
    time table witnesses the log index at the start of each phase."""
    nodes, jobs = scenario
    side.apply("NAMESPACE_UPSERT", {"namespace": side.obj(
        js.Namespace(name="tenant", max_live_allocs=100),
        lambda d: ps.Namespace(**d))})
    for n in nodes:
        side.apply("NODE_REGISTER", {"node": side.obj(n, convert.node_from_dict)})
    side.tt.witness(side.raft.applied_index() + 1, T0)
    for j in jobs.values():
        side.apply("JOB_REGISTER", {"job": side.obj(j, convert.job_from_dict)})
    N = [n.id for n in nodes]
    # Phase 1: bat-a done (slab, complete), per's child done, an old
    # failed svc eval with no allocs, bat-c's slab with one id complete,
    # the tenant's rows complete.
    side.apply("EVAL_UPDATE", {"evals": [
        ev(side, "e-bat-a", "bat-a", "complete"),
        ev(side, "e-child", "per/periodic-100", "complete"),
        ev(side, "e-svc-old", "svc", "failed", type_="service"),
        ev(side, "e-bat-c", "bat-c", "complete"),
        ev(side, "e-ten", "ten", "complete", namespace="tenant")]})
    place(side, jobs["bat-a"], "e-bat-a", slab_nodes=N[0:3])
    place(side, jobs["per/periodic-100"], "e-child", slab_nodes=N[1:3])
    place(side, jobs["bat-c"], "e-bat-c", slab_nodes=N[0:3])
    place(side, jobs["ten"], "e-ten", row_nodes=N[2:4], namespace="tenant")
    client_update(side, ["bat-a-s-0", "bat-a-s-1", "bat-a-s-2",
                         "per/periodic-100-s-0", "per/periodic-100-s-1",
                         "bat-c-s-1", "ten-r-0", "ten-r-1"], "complete")
    # node-5 goes down with nothing on it, node-4 down with a live row.
    place(side, jobs["bat-b"], "e-bat-b", row_nodes=N[4:5])
    side.apply("NODE_UPDATE_STATUS", {"node_id": "node-5", "status": "down"})
    side.apply("NODE_UPDATE_STATUS", {"node_id": "node-4", "status": "down"})
    # Phase 2: a live service and the batch eval of bat-b, both recent.
    side.tt.witness(side.raft.applied_index() + 1, T0 + 2 * HOUR)
    side.apply("EVAL_UPDATE", {"evals": [
        ev(side, "e-svc", "svc", "complete", type_="service"),
        ev(side, "e-bat-b", "bat-b", "complete")]})
    place(side, jobs["svc"], "e-svc", slab_nodes=N[0:2])


def scenario():
    nodes = [node(i) for i in range(6)]
    jobs = {j.id: j for j in [
        job("bat-a", "batch", 3), job("bat-b", "batch", 1),
        job("bat-c", "batch", 3), job("svc", "service", 2),
        job("per", "batch", 2, periodic=True),
        job("per/periodic-100", "batch", 2, parent="per"),
        job("ten", "batch", 2, namespace="tenant")]}
    return nodes, jobs


def content(side):
    st = side.state
    summaries = {}
    for j in st.jobs(None):
        summ = st.job_summary_by_id(None, j.id)
        if summ is not None:
            summaries[j.id] = (
                {tg: dataclasses.astuple(v) for tg, v in summ.summary.items()},
                dataclasses.astuple(summ.children) if summ.children else None)
    return {
        "evals": sorted((e.id, e.job_id, e.status) for e in st.evals(None)),
        "allocs": sorted((a.id, a.job_id, a.node_id, a.client_status,
                          a.namespace) for a in st.allocs(None)),
        "jobs": sorted((j.id, j.status, j.stop) for j in st.jobs(None)),
        "nodes": sorted((n.id, n.status) for n in st.nodes(None)),
        "summaries": summaries,
        "usage": st.namespace_usage(),
        "launches": sorted((p.id, p.launch) for p in st.periodic_launches(None)),
    }


def run_core(side, core_job, now):
    """One core eval through ``CoreScheduler`` off a snapshot, with the
    package's clock at ``now``."""
    clock = types.SimpleNamespace(time=lambda: now)
    core = side.core
    saved = core.time
    core.time = clock
    try:
        ev0 = side.s.Evaluation(id=f"core-{core_job}", priority=100,
                                type="_core", triggered_by="scheduled",
                                job_id=core_job, status="pending")
        side.apply("EVAL_UPDATE", {"evals": [ev0]})
        core.CoreScheduler(_log(), side.state.snapshot(),
                           side, side.raft, time_table=side.tt).process(ev0)
    finally:
        core.time = saved


def _log():
    import logging

    return logging.getLogger("test_torch_core_sched")


def deleted_events(side):
    return sorted(e.key for e in side.events.buffered()
                  if e.type == "EvalDeleted")


PASSES = {
    # Evals older than an hour: phase 1's; the live-alloc ones stay.
    "eval-gc": (ps.CORE_JOB_EVAL_GC, T0 + 3 * HOUR + 1),
    # Dead GC-able jobs older than four hours: phase 1's.
    "job-gc": (ps.CORE_JOB_JOB_GC, T0 + 6 * HOUR + 1),
    # Down nodes without allocs, older than a day.
    "node-gc": (ps.CORE_JOB_NODE_GC, T0 + 26 * HOUR + 1),
    "force-gc": (ps.CORE_JOB_FORCE_GC, T0 + 2 * HOUR),
    # A clock before any threshold: nothing goes.
    "eval-gc-early": (ps.CORE_JOB_EVAL_GC, T0 + 2 * HOUR),
}


def both(pass_name, after=None):
    """Build both sides, run the pass, return (ref, port, pre-GC port
    usage snapshot index and usage)."""
    sc = scenario()
    out = {}
    for kind in ("ref", "port"):
        side = Side(kind)
        build(side, sc)
        before = content(side)
        k = side.state.latest_index()
        pre = scratch_mirror(side.state)
        pre_usage = dict(zip(pre["node_ids"], pre["usage"].tolist()))
        core_job, now = PASSES[pass_name]
        run_core(side, core_job, now)
        out[kind] = {"side": side, "before": before, "after": content(side),
                     "k": k, "pre_usage": pre_usage}
        if after is not None:
            after(side)
            out[kind]["final"] = content(side)
    return out["ref"], out["port"]


@pytest.mark.parametrize("pass_name", sorted(PASSES))
def test_gc_pass_equals_the_reference(pass_name):
    ref, port = both(pass_name)
    assert port["before"] == ref["before"]
    assert port["after"] == ref["after"]
    assert [e.status for e in port["side"].evals_done] == ["complete"]


def gone(run, key):
    return ({r[0] for r in run["before"][key]}
            - {r[0] for r in run["after"][key]})


def test_eval_gc_reaps_old_terminal_evals_whose_allocs_are_terminal():
    _, port = both("eval-gc")
    assert gone(port, "evals") == {"e-bat-a", "e-child", "e-svc-old",
                                   "e-ten"}
    assert gone(port, "allocs") == {
        "bat-a-s-0", "bat-a-s-1", "bat-a-s-2", "per/periodic-100-s-0",
        "per/periodic-100-s-1", "ten-r-0", "ten-r-1"}
    # bat-c keeps its mixed slab: two of its ids are live.
    after = {r[0] for r in port["after"]["allocs"]}
    assert {"bat-c-s-0", "bat-c-s-2", "bat-c-s-1"} <= after


def test_job_gc_purges_dead_children_and_batch_jobs_not_periodic_parents():
    _, port = both("job-gc")
    assert gone(port, "jobs") == {"bat-a", "per/periodic-100", "ten"}
    jobs = {r[0] for r in port["after"]["jobs"]}
    assert "per" in jobs and "svc" in jobs
    summ = port["after"]["summaries"]
    assert "per/periodic-100" not in summ


def test_node_gc_reaps_only_down_nodes_without_allocs():
    _, port = both("node-gc")
    assert gone(port, "nodes") == {"node-5"}


def test_early_clock_reaps_nothing():
    _, port = both("eval-gc-early")
    for key in ("evals", "allocs", "jobs", "nodes"):
        assert not gone(port, key), key


def test_force_gc_and_eval_deleted_events():
    ref, port = both("force-gc")
    deleted = gone(port, "evals")
    assert {"e-bat-a", "e-child", "e-svc-old", "e-ten"} <= deleted
    for run in (ref, port):
        assert deleted_events(run["side"]) == sorted(deleted)
    assert gone(port, "nodes") == {"node-5"}


def test_usage_fold_and_feed_after_gc():
    """The fold and the usage-delta feed after the deletes: equal to the
    reference's, the fold equal to a walk by namespace, and the feed
    replayed on the pre-GC usage equal to the walk (the resident
    mirror's catch-up)."""
    ref, port = both("force-gc")
    pst, jst = port["side"].state, ref["side"].state
    assert pst.allocs_since(port["k"]) == jst.allocs_since(ref["k"])
    walk = {}
    for _nid, row in pst.alloc_rows(None):
        if row.terminal_status():
            continue
        c, m, d, i = ps.alloc_usage_vec(row)
        cur = walk.get(row.namespace, (0, 0, 0, 0, 0))
        walk[row.namespace] = (cur[0] + c, cur[1] + m, cur[2] + d,
                               cur[3] + i, cur[4] + 1)
    assert {k: v for k, v in pst.namespace_usage().items()
            if v != (0, 0, 0, 0, 0)} == walk
    mirror = scratch_mirror(pst)
    usage = {nid: np.array(v) for nid, v in port["pre_usage"].items()}
    for nid, delta in pst.allocs_since(port["k"]):
        usage[nid] += np.array(delta)
    for nid, row in zip(mirror["node_ids"], mirror["usage"]):
        np.testing.assert_array_equal(usage.pop(nid), row, err_msg=nid)
    # The node GC took away a node with nothing on it.
    assert [v.tolist() for v in usage.values()] == [[0, 0, 0, 0]]


def test_columnar_mirrors_after_gc():
    ref, port = both("force-gc")
    assert_mirrors(ref["side"].state, port["side"].state)
    assert pcolumnar.GUARD_MISMATCHES == 0
    assert pcolumnar.USAGE_GUARD_MISMATCHES == 0


def reconcile(side):
    side.apply("RECONCILE_JOB_SUMMARIES", {})


def test_reconcile_job_summaries_equals_the_reference():
    ref, port = both("eval-gc", after=reconcile)
    assert port["final"] == ref["final"]
    summ = port["final"]["summaries"]
    # Rebuilt from the allocs: bat-c has one complete and two pending.
    tgs = summ["bat-c"][0]["web"]
    assert tgs == dataclasses.astuple(ps.TaskGroupSummary(
        complete=1, starting=2))


def test_persist_restore_after_gc_keeps_the_store():
    _, port = both("eval-gc")
    st = port["side"].state
    for columnar in (True, False):
        st.columnar = columnar
        back = PStore.restore(st.persist(), columnar=columnar)
        side = types.SimpleNamespace(state=back)
        got, want = content(side), dict(port["after"])
        # The fold is rebuilt from the live rows: a namespace whose rows
        # all went has no row after a restore.
        want["usage"] = {k: v for k, v in want["usage"].items()
                         if v != (0, 0, 0, 0, 0)}
        assert got == want, columnar
        assert back.drain_ns_dirty() == set(back.namespace_usage())
