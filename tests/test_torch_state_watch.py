"""Blocking-query watches of the port's state store, the server's read
methods and the broker's seeded draw, against the JAX package.

- ``WatchSet``: a reader given one adds its table; ``watch`` returns
  ``False`` once a write moves a watched table and ``True`` at its
  timeout, in both packages alike (``nomad_tpu/state/state_store.py:70``).
  In the port every write path wakes it, a bulk plan commit of slabs and
  a node write through the columnar mirror included, and a store that a
  restore replaced wakes its watchers for good.
- The server's reads (``job_list``, ``job_get``, ``job_summary``,
  ``job_allocations``, ``job_evaluations``, ``eval_list``,
  ``eval_allocations``, ``alloc_get``, ``alloc_list``, ``node_get``,
  ``node_list``, ``node_get_allocs``, ``node_get_client_allocs``,
  ``node_evaluate``, ``regions``, ``region_info``,
  ``trace_for_eval_fanout``) answer as the reference's on one cluster
  (``test_torch_server.World``), compared by wire form without times.
- ``EvalBroker(rng=)``: the port's seeded draw among equal-priority ready
  queues dequeues as the reference's broker with its module's ``random``
  patched to the same seed.
"""
import dataclasses
import random
import threading
import time

import jax  # noqa: F401  (the reference computes on the CPU backend)
import pytest

import nomad_tpu.server.eval_broker as jeval_broker
from nomad_tpu import mock as jmock
from nomad_tpu.api.codec import to_wire as jto_wire
from nomad_tpu.state.state_store import StateStore as JStateStore
from nomad_tpu.state.state_store import WatchSet as JWatchSet
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert
from nomad_tpu_torch.api.codec import to_wire
from nomad_tpu_torch.server import FSM, eval_broker as peval_broker
from nomad_tpu_torch.state.state_store import StateStore, WatchSet
from nomad_tpu_torch.structs import structs as ps

from test_torch_agent_http import TIMES, REF_ONLY
from test_torch_server import (World, make_job, running, settle,
                               strip_node)

STORES = {"ref": (JStateStore, JWatchSet, js, lambda n: n),
          "port": (StateStore, WatchSet, ps,
                   lambda n: convert.node_from_dict(
                       dataclasses.asdict(n)))}


def a_node(i):
    return strip_node(jmock.node(), node_id=f"n-{i}")


@pytest.mark.parametrize("kind", sorted(STORES))
@pytest.mark.parametrize("table,reader,writer", [
    ("nodes", lambda st, ws: st.nodes(ws),
     lambda st, conv: st.upsert_node(10, conv(a_node(1)))),
    ("nodes", lambda st, ws: st.node_by_id(ws, "n-0"),
     lambda st, conv: st.update_node_status(10, "n-0", "down")),
    ("jobs", lambda st, ws: st.jobs(ws),
     lambda st, conv: st.upsert_job(10, conv.job(make_job("j", 1, 10, 10)))),
    ("evals", lambda st, ws: st.evals(ws),
     lambda st, conv: st.upsert_evals(10, [conv.eval()])),
], ids=["nodes", "node_by_id", "jobs", "evals"])
def test_watch_wakes_on_a_write_and_times_out(kind, table, reader, writer):
    store_cls, ws_cls, structs, conv_node = STORES[kind]

    class Conv:
        def __call__(self, n):
            return conv_node(n)

        def job(self, j):
            return j if kind == "ref" else convert.job_from_dict(
                dataclasses.asdict(j))

        def eval(self):
            return structs.Evaluation(id="e-1", job_id="j",
                                      status="pending")

    st = store_cls()
    st.upsert_node(5, Conv()(a_node(0)))
    ws = ws_cls()
    reader(st, ws)
    t0 = time.monotonic()
    assert ws.watch(timeout=0.2) is True
    assert time.monotonic() - t0 >= 0.19
    ws = ws_cls()
    reader(st, ws)
    threading.Timer(0.1, writer, args=(st, Conv())).start()
    t0 = time.monotonic()
    assert ws.watch(timeout=10.0) is False
    assert time.monotonic() - t0 < 5.0


def test_no_watch_without_entries():
    assert WatchSet().watch(timeout=5.0) is True


def test_plan_commit_of_slabs_wakes_an_alloc_watch():
    """A bulk commit through the batch path (slabs) bumps the allocs
    table and wakes an alloc watch."""
    st = StateStore()
    for i in range(4):
        st.upsert_node(i + 1, convert.node_from_dict(
            dataclasses.asdict(a_node(i))))
    job = convert.job_from_dict(dataclasses.asdict(
        make_job("j", 4, 100, 64)))
    st.upsert_job(10, job)
    proto = ps.Allocation(job_id="j", task_group="web", job=job,
                          resources=ps.Resources(cpu=100, memory_mb=64))
    slab = ps.AllocSlab(proto=proto, ids=["a0", "a1"],
                        names=["j.web[0]", "j.web[1]"],
                        node_ids=["n-0", "n-1"])
    ws = WatchSet()
    st.allocs(ws)
    threading.Timer(0.1, lambda: st.upsert_plan_results(
        11, job, [], [slab])).start()
    assert ws.watch(timeout=10.0) is False
    assert st.table_index("allocs") == 11


def test_a_restore_wakes_the_old_stores_watchers():
    fsm = FSM(state=StateStore())
    fsm.state.upsert_node(3, convert.node_from_dict(
        dataclasses.asdict(a_node(0))))
    blob = fsm.state.persist()
    old = fsm.state
    ws = WatchSet()
    old.jobs(ws)
    threading.Timer(0.1, fsm.restore, args=(blob,)).start()
    assert ws.watch(timeout=10.0) is False
    assert fsm.state is not old
    # The retired store wakes a new watch at once.
    ws = WatchSet()
    old.jobs(ws)
    assert ws.watch(timeout=10.0) is False


def test_columnar_node_write_wakes_a_node_watch():
    st = StateStore(columnar=True)
    for i in range(3):
        st.upsert_node(i + 1, convert.node_from_dict(
            dataclasses.asdict(a_node(i))))
    st.columns()  # the mirror is built
    ws = WatchSet()
    st.nodes(ws)
    threading.Timer(0.1, st.update_node_drain, args=(9, "n-1", True)).start()
    assert ws.watch(timeout=10.0) is False


# -- the server's reads ----------------------------------------------------

def wire(obj, ref):
    def strip(v):
        if isinstance(v, dict):
            return {k: strip(x) for k, x in v.items()
                    if k not in TIMES and k not in REF_ONLY}
        if isinstance(v, list):
            return [strip(x) for x in v]
        return v
    return strip((jto_wire if ref else to_wire)(obj))


def reads(world):
    srv = world.srv
    job = srv.job_get("web")
    allocs = sorted(srv.job_allocations("web"), key=lambda a: a.name)
    eval_id = allocs[0].eval_id
    node_id = allocs[0].node_id
    ref = world.ref
    out = {
        "job_list": wire(srv.job_list()[0], ref),
        "job_list_prefix": wire(srv.job_list(prefix="we")[0], ref),
        "job_get": wire(job, ref),
        "job_get_missing": srv.job_get("nope"),
        "job_summary": wire(srv.job_summary("web"), ref),
        "job_allocations": wire(allocs, ref),
        "job_evaluations": wire(srv.job_evaluations("web"), ref),
        "eval_list": wire(sorted(srv.eval_list(), key=lambda e: e.id), ref),
        "eval_allocations": wire(sorted(srv.eval_allocations(eval_id),
                                        key=lambda a: a.name), ref),
        "alloc_get": wire(srv.alloc_get(allocs[0].id), ref),
        "alloc_list": len(srv.alloc_list()),
        "node_get": wire(srv.node_get(node_id), ref),
        "node_list": sorted(n.id for n in srv.node_list()),
        "node_get_allocs": sorted(a.name for a in
                                  srv.node_get_allocs(node_id)),
        "client_allocs": sorted(a.name for a in
                                srv.node_get_client_allocs(node_id)[0]),
        "regions": srv.regions(),
        "region_info": [{**r, "Leader": bool(r["Leader"])}
                        for r in srv.region_info()],
        "fanout": srv.trace_for_eval_fanout(eval_id),
    }
    with pytest.raises(KeyError):
        srv.node_evaluate("nope")
    return out


def test_server_reads_match_reference(monkeypatch):
    got = {}
    # Made before either world seeds its ids: they consume none.
    nodes = [strip_node(jmock.node(), node_id=f"node-{i}") for i in range(4)]
    job = make_job("web", 3, 200, 64)
    for kind in ("ref", "port"):
        with pytest.MonkeyPatch.context() as mp:
            world = World(kind, mp)
            with running(world):
                for n in nodes:
                    world.node_register(n)
                world.job_register(job)
                settle(world.srv)
                got[kind] = reads(world)
                got[kind]["node_evaluate"] = len(
                    world.srv.node_evaluate("node-0"))
                settle(world.srv)
    assert got["port"] == got["ref"]


def test_client_allocs_long_poll_wakes_on_a_commit():
    with pytest.MonkeyPatch.context() as mp:
        world = World("port", mp)
        with running(world):
            world.node_register(strip_node(jmock.node(), node_id="node-0"))
            settle(world.srv)
            index = world.srv.raft.applied_index()
            out = {}

            def poll():
                out["r"] = world.srv.node_get_client_allocs(
                    "node-0", min_index=index, max_wait=20.0)

            t = threading.Thread(target=poll)
            t.start()
            time.sleep(0.3)
            assert t.is_alive()
            world.job_register(make_job("web", 2, 100, 64))
            t.join(20)
            allocs, got = out["r"]
            assert got > index and len(allocs) >= 1


def test_region_routing_answers_as_the_reference():
    """A region with no known server: ValueError naming it, in both."""
    msgs = {}
    for kind in ("ref", "port"):
        with pytest.MonkeyPatch.context() as mp:
            world = World(kind, mp)
            with running(world):
                with pytest.raises(ValueError) as e:
                    world.srv.job_register(world._obj(
                        make_job("far", 1, 10, 10), convert.job_from_dict),
                        region="mars")
                msgs[kind] = str(e.value)
    assert msgs["port"] == msgs["ref"] == "no servers known in region 'mars'"


# -- the broker's seeded draw ----------------------------------------------

def draw_order(broker_mod, structs, make_broker):
    b = make_broker()
    b.set_enabled(True)
    evals = []
    for i in range(24):
        typ = ("service", "batch", "system")[i % 3]
        evals.append(structs.Evaluation(
            id=f"e-{i:02d}", priority=50, type=typ, job_id=f"j-{i}",
            status="pending"))
    for ev in evals:
        b.enqueue(ev)
    order = []
    for _ in evals:
        ev, token = b.dequeue(["service", "batch", "system"], timeout=1.0)
        order.append(ev.id)
        b.ack(ev.id, token)
    b.set_enabled(False)
    return order


@pytest.mark.parametrize("seed", [1, 7, 42])
def test_seeded_broker_draw_matches_the_reference(seed, monkeypatch):
    monkeypatch.setattr(jeval_broker, "random", random.Random(seed))
    want = draw_order(jeval_broker, js, lambda: jeval_broker.EvalBroker())
    got = draw_order(peval_broker, ps, lambda: peval_broker.EvalBroker(
        rng=random.Random(seed)))
    assert got == want
    # ... and the unseeded port broker keeps drawing from the module.
    monkeypatch.setattr(peval_broker, "random", random.Random(seed))
    assert draw_order(peval_broker, ps, peval_broker.EvalBroker) == want


def test_server_config_passes_the_broker_seed():
    from nomad_tpu_torch.server import Server, ServerConfig

    srv = Server(ServerConfig(device="cpu", broker_seed=5))
    assert srv.eval_broker.rng.random() == random.Random(5).random()
    assert Server(ServerConfig(device="cpu")).eval_broker.rng is None
