"""The port's cluster event stream (``nomad_tpu_torch/server/event_broker.py``
and its publishers) against the reference's.

- The broker mechanics (``tests/test_event_stream.py``'s
  ``TestBrokerMechanics``): each case runs the same calls through both
  packages' brokers and must observe the same events, errors and stats.
- The server publishes (its ``TestServerEventPublish``), by content: the
  port's ``Server(ServerConfig(device="cpu", events=True))`` and the
  reference's ``Server`` with ``NOMAD_TPU_EVENTS=1`` take the same
  register stream at a small size (``test_torch_server.py``'s worlds:
  seeded ids and tie-breaks, waves with the workers paused and released),
  each with a subscriber from index 0.  The multisets of events by
  (topic, type, content key, payload) must be equal, with jobs and nodes
  named and evals and allocs by their job; the indices never decrease,
  the ``PlanApplied`` placements sum to the committed allocs, and the
  subscriber is never shed.  Disarmed by default, armed on subscribe, and
  snapshot writes never publish, in both.
- The cross-cutting publishers: the resident mirror's ``NodeStateDelta``
  under an injected ``ops.resident_state`` and the columnar guard's
  ``ColumnarGuardMismatch`` under an injected ``state.columns`` match the
  reference's in topic, type and payload keys.
"""
import collections
import time

import jax  # noqa: F401  (the reference computes on the CPU backend)
import numpy as np
import pytest

from nomad_tpu import fault as jfault
from nomad_tpu import mock as jmock
from nomad_tpu.ops import encode as jencode
from nomad_tpu.ops import resident as jresident
from nomad_tpu.ops.breaker import KernelCircuitBreaker as JBreaker
from nomad_tpu.server import Server as JServer
from nomad_tpu.server import ServerConfig as JServerConfig
from nomad_tpu.server import event_broker as jeb
from nomad_tpu.structs import structs as js
from nomad_tpu.utils import tracing as jtracing
from nomad_tpu_torch import convert
from nomad_tpu_torch import fault as pfault
from nomad_tpu_torch.ops import encode as pencode
from nomad_tpu_torch.ops import resident as president
from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server import event_broker as peb
from nomad_tpu_torch.structs import structs as ps
from nomad_tpu_torch.utils import tracing as ptracing

from test_torch_columnar import encode_fleet
from test_torch_resident import SEED as RESIDENT_SEED
from test_torch_resident import both, corruption_scenario
from test_torch_server import (World, cluster, conv, make_job, running,
                               strip_node)

PKGS = {"ref": (jeb, js, jtracing), "port": (peb, ps, ptracing)}


def drain(sub, timeout=0.05):
    out = []
    while True:
        ev = sub.next(timeout=timeout)
        if ev is None:
            return out
        out.append(ev)


def mk(b, index, topic="Node", etype="NodeUpdated", key="n1"):
    return b.make_event(topic, etype, key, index)


def wire(events):
    """Events without their wall clock."""
    return [dict(e.to_wire_dict(), Wall=None) for e in events]


# -- the broker mechanics, call for call ----------------------------------

def case_filters(eb, s, tr):
    b = eb.EventBroker(ring_size=64)
    every = b.subscribe()
    nodes = b.subscribe(topics=eb.parse_topic_filter("Node"))
    one_key = b.subscribe(topics=eb.parse_topic_filter("Node:n2,Eval"))
    star = b.subscribe(topics={"*": {"n1", "e1"}})
    b.publish([mk(b, 1, "Node", "NodeUpdated", "n1"),
               mk(b, 2, "Node", "NodeUpdated", "n2"),
               mk(b, 3, "Eval", "EvalUpdated", "e1"),
               mk(b, 4, "Alloc", "AllocPlaced", "a1")])
    out = {k: wire(drain(sub)) for k, sub in
           (("every", every), ("nodes", nodes), ("one_key", one_key),
            ("star", star))}
    one_key.close()
    b.publish([mk(b, 5, "Node", "NodeUpdated", "n2")])
    out["after_close"] = (wire(drain(one_key)), b.stats())
    return out


def case_parse(eb, s, tr):
    return [eb.parse_topic_filter(spec) for spec in
            ("", "*", "Node", "Node:a,Node:b", "Node:a,Node",
             "Node,Node:a", " Eval , ,Alloc:x ")]


def case_resume(eb, s, tr):
    b = eb.EventBroker(ring_size=64)
    for i in range(1, 11):
        b.publish([mk(b, i)])
    sub = b.subscribe(from_index=4)
    got = [e.index for e in drain(sub)]
    b.publish([mk(b, 11)])
    return got, [e.index for e in drain(sub)]


def case_out_of_ring(eb, s, tr):
    b = eb.EventBroker(ring_size=8)     # the broker's floor
    for i in range(1, 13):
        b.publish([mk(b, i)])
    with pytest.raises(eb.EventIndexError) as exc:
        b.subscribe(from_index=3)
    dump = b.subscribe(replay_all=True)
    ok = b.subscribe(from_index=5)
    b.mark_armed(40)
    with pytest.raises(eb.EventIndexError) as late:
        b.subscribe(from_index=20)
    return {"oldest": (exc.value.oldest, b.oldest_buffered_index(),
                       b.latest_index()),
            "message": str(exc.value),
            "dump": [e.index for e in drain(dump)],
            "ok": [e.index for e in drain(ok)],
            "after_mark": (late.value.requested, late.value.oldest),
            "stats": b.stats()}


def case_shed(eb, s, tr):
    b = eb.EventBroker(ring_size=1024)
    sub = b.subscribe(max_pending=8)
    for i in range(1, 20):
        b.publish([mk(b, i)])
    return {"closed": sub.closed, "error": sub.close_error,
            "pending": sub.pending(), "stats": b.stats()}


def case_clamp(eb, s, tr):
    b = eb.EventBroker(ring_size=16, index_source=lambda: 3)
    b.publish([mk(b, 7)])
    b.publish_one("Plan", "PlanApplied", "e1", 5, {"PlanIndex": 5},
                  clamp=True)
    b.publish_external("Breaker", "BreakerTransition", "open")
    b.publish([mk(b, 6)])    # unclamped: kept as stamped
    return [(e.topic, e.index) for e in b.buffered()]


def case_eval_correlation(eb, s, tr):
    b = eb.EventBroker(ring_size=16)
    tr.enable()
    try:
        with tr.TRACER.span("worker.attempt", eval_id="ev-123"):
            b.publish_one("Alloc", "AllocPlaced", "a1", 5)
        with tr.TRACER.span("batch", eval_ids=["x", "y"]):
            b.publish_one("Alloc", "AllocPlaced", "a2", 6,
                          eval_id="ev-given")
    finally:
        tr.disable()
    b.publish_one("Alloc", "AllocPlaced", "a3", 7)
    return [(e.key, e.eval_id, e.span_id > 0) for e in b.buffered()]


def case_external_registry(eb, s, tr):
    eb.clear_recent()
    b = eb.EventBroker(ring_size=16, index_source=lambda: 9)
    eb.note_external("Fault", "FaultFired", "p")   # disarmed: dropped
    was = eb.armed()
    eb.register(b)
    eb.register(b)
    try:
        eb.note_external("Fault", "FaultFired", "p", {"Rule": 0})
        armed = eb.armed()
    finally:
        eb.unregister(b)
        eb.unregister(b)
    eb.note_external("Fault", "FaultFired", "q")
    return {"was": was, "armed": armed, "now": eb.armed(),
            "ring": wire(b.buffered()),
            "recent": [(e.topic, e.key) for e in eb.recent(10)]}


MECHANICS = {
    "topic_and_key_filters": case_filters,
    "parse_topic_filter": case_parse,
    "index_resume": case_resume,
    "out_of_ring_resume_raises_with_oldest": case_out_of_ring,
    "lagging_subscriber_shed": case_shed,
    "clamp_keeps_the_stream_monotone": case_clamp,
    "eval_correlation": case_eval_correlation,
    "external_publisher_registry": case_external_registry,
}


@pytest.mark.parametrize("case", sorted(MECHANICS))
def test_broker_mechanics_match_the_reference(case):
    got = {kind: MECHANICS[case](*mods) for kind, mods in PKGS.items()}
    assert got["port"] == got["ref"]


def test_event_struct_and_topics():
    assert ps.EVENT_TOPICS == js.EVENT_TOPICS
    ev = ps.Event(topic=ps.TOPIC_PLAN, type="PlanApplied", key="e",
                  index=3, payload={"Placed": 1}, eval_id="e", span_id=2,
                  wall=1.5)
    ref = js.Event(topic=js.TOPIC_PLAN, type="PlanApplied", key="e",
                   index=3, payload={"Placed": 1}, eval_id="e", span_id=2,
                   wall=1.5)
    assert ev.to_wire_dict() == ref.to_wire_dict()
    assert (peb.DEFAULT_RING_SIZE, peb.DEFAULT_MAX_PENDING,
            peb.RECENT_CAPACITY) == (jeb.DEFAULT_RING_SIZE,
                                     jeb.DEFAULT_MAX_PENDING,
                                     jeb.RECENT_CAPACITY)


# -- the server publishes ------------------------------------------------

def make_node():
    return strip_node(jmock.node())


def new_server(kind, mp, **kw):
    if kind == "ref":
        mp.setattr(jeb, "_ARMED", [])
        return JServer(JServerConfig(num_schedulers=0, **kw))
    return Server(ServerConfig(device="cpu", num_schedulers=0, **kw))


def disarmed_scenario(kind, mp):
    srv = new_server(kind, mp)
    srv.start()
    try:
        out = {"store": srv.state.event_broker is None,
               "stats": "events" in srv.stats()}
        n = make_node()
        if kind == "port":
            n = conv(n, convert.node_from_dict)
        srv.node_register(n)
        out["buffered"] = srv.event_broker.buffered()
        sub = srv.event_stream_subscribe()
        out["armed"] = srv.state.event_broker is srv.event_broker
        out["stats_after"] = sorted(srv.stats()["events"])
        srv.node_update_status(n.id, "down")
        out["got"] = [(e.topic, e.type) for e in drain(sub)]
        with pytest.raises((jeb.EventIndexError, peb.EventIndexError)):
            srv.event_stream_subscribe(from_index=1)
    finally:
        srv.shutdown()
    return out


def snapshot_scenario(kind, mp):
    mp.setenv("NOMAD_TPU_EVENTS", "1")
    srv = new_server(kind, mp, **({"events": True} if kind == "port"
                                  else {}))
    srv.start()
    try:
        snap = srv.state.snapshot()
        j = make_job("snap-job", 1, 100, 64)
        if kind == "port":
            j = conv(j, convert.job_from_dict)
        snap.upsert_job(99, j)
        return {"snap": snap.event_broker is None,
                "buffered": srv.event_broker.buffered()}
    finally:
        srv.shutdown()


@pytest.mark.parametrize("scenario", [disarmed_scenario, snapshot_scenario],
                         ids=["disarmed_by_default_armed_on_subscribe",
                              "snapshot_writes_do_not_publish"])
def test_server_arming_matches_the_reference(scenario):
    got = {}
    for kind in ("ref", "port"):
        with pytest.MonkeyPatch.context() as mp:
            got[kind] = scenario(kind, mp)
    assert got["port"] == got["ref"]


# Payload fields that carry ids or indices: the content is compared
# without them (the key of an eval or alloc event is its job instead).
ID_FIELDS = {"PlanIndex", "AllocIndex", "SnapshotIndex", "CachedIndex"}


def content_key(ev, evals):
    """(topic, type, content key, payload) of one event, jobs and nodes
    by name, evals and allocs by their job."""
    key = ev.key
    if ev.topic == "Eval":
        key = ev.payload.get("JobID") or evals.get(ev.key, ("?",))[0]
    elif ev.topic == "Alloc" and ev.type != "AllocPlacedBulk":
        key = ev.payload.get("JobID")
    elif ev.topic == "Plan":
        key = evals.get(ev.key, ("?",))[0]
    payload = tuple(sorted(
        (k, tuple(v) if isinstance(v, list) else v)
        for k, v in ev.payload.items() if k not in ID_FIELDS))
    return (ev.topic, ev.type, key, payload)


def run_stream(world):
    nodes, wave1, wave2, big, extra = cluster()
    sub = world.srv.event_stream_subscribe(from_index=0)
    for n in nodes[:24]:
        world.node_register(n)
    world.wave(wave1)
    world.wave(wave2)
    world.wave([big])
    with world.paused():
        for n in extra[:2]:
            world.node_register(n)
    host = sorted({a.node_id for a in world.srv.state.allocs(None)
                   if a.job_id == "svc-a"})[0]
    with world.paused() as srv:
        srv.node_update_status(host, "down")
    # The acks land just after the last status write.
    time.sleep(0.3)
    events = drain(sub)
    st = world.srv.state
    evals = {e.id: (e.job_id, e.triggered_by) for e in st.evals(None)}
    live = [a for a in st.allocs(None)]
    return {"content": collections.Counter(content_key(e, evals)
                                           for e in events),
            "indices": [e.index for e in events],
            "placed": sum(e.payload["Placed"] for e in events
                          if e.type == "PlanApplied"),
            "allocs": len(live),
            "shed": sub.closed,
            "stats": world.srv.stats()["events"],
            "correlated": all(
                evals.get(e.eval_id, ("?",))[0] == e.payload["JobID"]
                for e in events if e.type == "AllocPlacedBulk"),
            "registered": sorted(e.key for e in events
                                 if e.type == "NodeRegistered")}


@pytest.fixture(scope="module")
def stream_runs():
    runs = {}
    for kind in ("ref", "port"):
        # Each package's one resident slot starts cold: a world of an
        # earlier test (seeded ids: the same store lineage) would turn
        # the first batch's NodeStateDelta into a fence.
        jresident.invalidate()
        president.invalidate()
        with pytest.MonkeyPatch.context() as mp:
            if kind == "ref":
                mp.setattr(jeb, "_ARMED", [])
            with running(World(kind, mp, events=True)) as world:
                runs[kind] = run_stream(world)
    return runs


def test_stream_content_matches_the_reference(stream_runs):
    ref, port = stream_runs["ref"], stream_runs["port"]
    assert port["content"] == ref["content"]
    assert sum(port["content"].values()) > 100


def test_stream_is_monotone_complete_and_unshed(stream_runs):
    port = stream_runs["port"]
    idx = port["indices"]
    assert idx == sorted(idx) and idx[0] >= 1
    assert not port["shed"]
    assert port["stats"]["subscribers"] == 1
    assert port["stats"]["max_subscriber_lag"] == 0
    # Every placement of every applied plan is one committed alloc.
    assert port["placed"] == port["allocs"] > 0
    assert port["correlated"]
    assert len(port["registered"]) == 26
    assert port["placed"] == stream_runs["ref"]["placed"]


# -- the cross-cutting publishers ------------------------------------------

def armed_corruption(p, warm):
    ebm = peb if p.port else jeb
    b = ebm.EventBroker(ring_size=64)
    ebm.register(b)
    try:
        out = corruption_scenario(p, warm=warm)
    finally:
        ebm.unregister(b)
    out["events"] = [(e.topic, e.type, e.key, sorted(e.payload))
                     for e in b.buffered()
                     if e.type in ("NodeStateDelta", "BreakerTransition",
                                   "FaultFired")]
    return out


@pytest.mark.parametrize("warm", (1, 2))
def test_resident_state_delta_event_matches_the_reference(monkeypatch,
                                                          warm):
    # test_torch_resident.py's setting: the reference's mirror on, its
    # guard at every hit, the seed pinned, and the columnar mirror off.
    for k, v in (("NOMAD_TPU_RESIDENT", "1"),
                 ("NOMAD_TPU_RESIDENT_GUARD_EVERY", "1"),
                 ("NOMAD_TPU_RNG_SEED", str(RESIDENT_SEED)),
                 ("NOMAD_TPU_COLUMNAR", "0")):
        monkeypatch.setenv(k, v)
    jresident.reset_counters()
    president.reset_counters()
    try:
        got = both(monkeypatch, armed_corruption, warm=warm)
    finally:
        jresident.reset_counters()
        president.reset_counters()
    assert ("Node", "NodeStateDelta", "guard_mismatch",
            ["AllocIndex", "PlanIndex", "Reason", "Rows", "Shards"]) \
        in got["events"]
    assert ("Fault", "FaultFired", "ops.resident_state",
            ["Action", "Rule"]) in got["events"]
    assert ("Breaker", "BreakerTransition", "open",
            ["Agreement", "From", "To", "Trips"]) in got["events"]


def test_columnar_guard_event_matches_the_reference(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_COLUMNAR", "1")
    monkeypatch.setenv("NOMAD_TPU_COLUMNAR_GUARD_EVERY", "1")
    st = encode_fleet(10, 30)
    got = {}
    for kind, store, enc, fault, brk, ebm, tr in (
            ("ref", st.js, jencode, jfault, JBreaker, jeb, jtracing),
            ("port", st.ps, pencode, pfault, KernelCircuitBreaker, peb,
             ptracing)):
        b = ebm.EventBroker(ring_size=64)
        ebm.register(b)
        tr.enable()
        breaker = brk(threshold=0.9, window=8, min_checks=1,
                      cooldown=3600.0)
        try:
            with fault.scenario({"seed": 5, "faults": [
                    {"point": "state.columns", "action": "corrupt",
                     "times": 1}]}):
                # The port's guard cadence is an argument, the
                # reference's the environment above.
                kw = {"guard_every": 1} if kind == "port" else {}
                ct = enc.build_cluster_static(store, store.nodes(None), [],
                                              {}, breaker=breaker, **kw)
            spans = [sp for sp in tr.recent(50)
                     if sp["Name"] == "columnar.guard_mismatch"]
        finally:
            tr.disable()
            ebm.unregister(b)
        guard = [e for e in b.buffered()
                 if e.type == "ColumnarGuardMismatch"]
        assert len(guard) == 1 and len(spans) == 1, kind
        got[kind] = {"event": (guard[0].topic, guard[0].type,
                               sorted(guard[0].payload),
                               guard[0].payload["Kind"]),
                     "span": sorted(spans[0]["Attrs"]),
                     "capacity": np.asarray(ct.capacity).tolist()}
    assert got["port"] == got["ref"]
    assert got["port"]["event"] == ("Node", "ColumnarGuardMismatch",
                                    ["Field", "Kind", "Nodes"], "static")
