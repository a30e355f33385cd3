"""The port's federation (``Server(wan_join=)``, the region forward of
``server/server.py``, ``server/federation.py``'s ``RegionEventAggregator``
and the region routes of the HTTP API) against the JAX package's, case
for case with ``tests/test_federation.py``.

Each case builds the same federation in both packages (one single-voter
server per region, WAN-joined over loopback; the reference's with the
batch worker and a ``KernelCircuitBreaker`` of its own, the port's on
the CPU) and compares what the case observes: the regions and members,
where a job lives and how many allocs it holds, what a routed read
returns, the typed ``NoPathToRegion`` of a severed region and the
exactly-once placement after the heal, and the aggregator's tagged,
gap-free fan-in.  ``breaker.oracle_routed`` stays 0 in both worlds.

The twin of ``TestMultiSliceMesh`` gives each region's port server its
own mesh of four CPU shards; the reference's mesh program fails under
jax 0.9.0 (ROADMAP queue 3 item 1), so the port's mesh placements are
held against the reference's single-device batch worker on the same
fleet and job.  Every wait has a deadline.
"""
import contextlib
import dataclasses
import json
import time
import urllib.request

import jax  # noqa: F401  (the reference computes on the CPU backend)
import pytest

import nomad_tpu.ops.breaker as jbreaker
from nomad_tpu import fault as jfault
from nomad_tpu import mock as jmock
from nomad_tpu.server import Server as JServer
from nomad_tpu.server import ServerConfig as JServerConfig
from nomad_tpu.server.federation import RegionEventAggregator as JAgg
from nomad_tpu.server.rpc import ConnPool as JConnPool
from nomad_tpu.server.rpc import NoPathToRegion as JNoPath
from nomad_tpu_torch import convert, fault
from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
from nomad_tpu_torch.parallel import make_node_mesh
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.federation import RegionEventAggregator
from nomad_tpu_torch.server.rpc import ConnPool, NoPathToRegion
from nomad_tpu_torch.utils.backoff import wait_until

DEADLINE = 20.0
HEARTBEAT_TTL = 3600.0
KINDS = ("ref", "port")


def make_server(kind, monkeypatch, **fields):
    if kind == "ref":
        monkeypatch.setattr(jbreaker, "BREAKER",
                            jbreaker.KernelCircuitBreaker())
        return JServer(JServerConfig(use_tpu_batch_worker=True,
                                     min_heartbeat_ttl=HEARTBEAT_TTL,
                                     **fields))
    return Server(ServerConfig(device=fields.pop("device", "cpu"),
                               rng_seed=7, breaker=KernelCircuitBreaker(),
                               min_heartbeat_ttl=HEARTBEAT_TTL, **fields))


@contextlib.contextmanager
def federation(kind, monkeypatch, **extra):
    """One single-voter server per region ("global", "eu"), WAN-joined."""
    g = make_server(kind, monkeypatch, region="global", node_name="global-1",
                    enable_rpc=True, num_schedulers=1,
                    **extra.get("global", {}))
    g.start()
    eu = None
    try:
        eu = make_server(kind, monkeypatch, region="eu", node_name="eu-1",
                         enable_rpc=True, num_schedulers=1,
                         wan_join=[g.config.rpc_advertise],
                         **extra.get("eu", {}))
        eu.start()
        assert wait_until(lambda: len(g.members()) == 2
                          and len(eu.members()) == 2, DEADLINE)
        yield g, eu
    finally:
        if eu is not None:
            eu.shutdown()
        g.shutdown()
    if kind == "port":
        assert wait_until(lambda: not g.threads() and not eu.threads(),
                          DEADLINE)


def counter(srv, key):
    return srv.metrics.sink.latest()["CounterTotals"].get(f"nomad.{key}", 0)


def node(kind):
    n = jmock.node()
    n.resources.networks = []
    n.reserved.networks = []
    return n if kind == "ref" else convert.node_from_dict(
        dataclasses.asdict(n))


def make_job(kind, region, job_id=None, count=1):
    job = jmock.job()
    job.region = region
    if job_id:
        job.id = job.name = job_id
    job.task_groups[0].count = count
    for t in job.task_groups[0].tasks:
        t.resources.networks = []
    return job if kind == "ref" else convert.job_from_dict(
        dataclasses.asdict(job))


def live(srv, job_id):
    return [a for a in srv.state.allocs_by_job(None, job_id, True)
            if not a.terminal_status()]


def fault_mod(kind):
    return jfault if kind == "ref" else fault


# -- TestFederation ------------------------------------------------------------

def membership(kind, monkeypatch):
    with federation(kind, monkeypatch) as (g, eu):
        return (g.regions(), eu.regions(), g.is_leader(), eu.is_leader(),
                sorted((m["Name"], m["Region"]) for m in g.members()),
                sorted((m["Name"], m["Region"]) for m in eu.members()))


def test_wan_membership_and_regions(monkeypatch):
    port = membership("port", monkeypatch)
    assert port == membership("ref", monkeypatch)
    assert port[:4] == (["eu", "global"], ["eu", "global"], True, True)


def quorum(kind, monkeypatch, tmp_path):
    common = dict(enable_rpc=True, num_schedulers=0)
    s1 = make_server(kind, monkeypatch, region="global", node_name="g1",
                     data_dir=str(tmp_path / kind / "g1"),
                     bootstrap_expect=2, **common)
    s1.start()
    s2 = make_server(kind, monkeypatch, region="global", node_name="g2",
                     data_dir=str(tmp_path / kind / "g2"),
                     bootstrap_expect=2,
                     start_join=[s1.config.rpc_advertise], **common)
    s2.start()
    eu = make_server(kind, monkeypatch, region="eu", node_name="eu1",
                     wan_join=[s1.config.rpc_advertise], **common)
    eu.start()
    try:
        assert wait_until(lambda: any(x.is_leader() for x in (s1, s2)),
                          DEADLINE)
        assert wait_until(lambda: len(s1.members()) == 3, DEADLINE)
        leader = s1 if s1.is_leader() else s2
        voters = set(leader.raft.peers)
        return voters == {s1.config.rpc_advertise, s2.config.rpc_advertise}
    finally:
        eu.shutdown()
        s2.shutdown()
        s1.shutdown()


def test_wan_members_not_in_raft_quorum(monkeypatch, tmp_path):
    assert quorum("port", monkeypatch, tmp_path) is True
    assert quorum("ref", monkeypatch, tmp_path) is True


def routes(kind, monkeypatch):
    with federation(kind, monkeypatch) as (g, eu):
        job = make_job(kind, "eu")
        _, eval_id = g.job_register(job)
        out = [bool(eval_id), eu.state.job_by_id(None, job.id) is not None,
               g.state.job_by_id(None, job.id) is None]
        eu.node_register(node(kind))
        assert wait_until(lambda: len(eu.state.allocs_by_job(
            None, job.id, True)) == 1, DEADLINE)
        g.job_deregister(job.id, purge=False, region="eu")
        assert wait_until(lambda: eu.state.job_by_id(None, job.id).stop,
                          DEADLINE)
        out += [len(eu.state.allocs_by_job(None, job.id, True)),
                counter(g, "breaker.oracle_routed"),
                counter(eu, "breaker.oracle_routed")]
        return out


def test_job_routes_to_its_region(monkeypatch):
    port = routes("port", monkeypatch)
    assert port == routes("ref", monkeypatch)
    assert port == [True, True, True, 1, 0, 0]


def http_routes(kind, monkeypatch):
    with federation(kind, monkeypatch) as (g, eu):
        if kind == "ref":
            from nomad_tpu.agent.agent import Agent as A
            from nomad_tpu.agent.config import AgentConfig as C
            from nomad_tpu.api.client import NomadAPI
        else:
            from nomad_tpu_torch.agent.agent import Agent as A
            from nomad_tpu_torch.agent.config import AgentConfig as C
            from nomad_tpu_torch.api.client import NomadAPI
        cfg = C()
        cfg.name = "g-http"
        cfg.server.enabled = True
        cfg.client.enabled = False
        cfg.ports.http = 0
        cfg.ports.rpc = 0
        cfg.server.wan_join = [eu.config.rpc_advertise]
        agent = (A(cfg) if kind == "ref" else
                 A(cfg, device="cpu",
                   server_options={"min_heartbeat_ttl": HEARTBEAT_TTL}))
        agent.start()
        try:
            assert wait_until(lambda: "eu" in agent.server.regions(),
                              DEADLINE)
            api = NomadAPI(address=agent.http.address, region="eu")
            job = make_job(kind, "eu", "http-routed")
            resp, _ = api.jobs.register(job)
            assert wait_until(lambda: eu.state.job_by_id(
                None, "http-routed") is not None, DEADLINE)
            with urllib.request.urlopen(
                    agent.http.address + "/v1/regions") as r:
                regions = json.loads(r.read())
            with urllib.request.urlopen(
                    agent.http.address + "/v1/regions?detail=1") as r:
                detail = json.loads(r.read())
            by_name = {d["Name"]: d for d in detail}
            return (bool(resp["EvalID"]),
                    agent.server.state.job_by_id(None, "http-routed")
                    is None, regions, [d["Name"] for d in detail],
                    by_name["eu"]["Servers"],
                    by_name["eu"]["Leader"] == eu.config.rpc_advertise,
                    by_name["global"]["Leader"]
                    == agent.server.config.rpc_advertise)
        finally:
            agent.shutdown()


def test_http_region_param_routes(monkeypatch):
    port = http_routes("port", monkeypatch)
    assert port == http_routes("ref", monkeypatch)
    assert port == (True, True, ["eu", "global"], ["eu", "global"], 1,
                    True, True)


def unknown_region(kind, monkeypatch):
    with federation(kind, monkeypatch) as (g, _):
        try:
            g.job_register(make_job(kind, "mars"), region="mars")
            explicit = "ok"
        except ValueError as e:
            explicit = ("ValueError", str(e))
        job2 = make_job(kind, "mars")
        _, eval_id = g.job_register(job2)
        return explicit, bool(eval_id), \
            g.state.job_by_id(None, job2.id) is not None


def test_unknown_region_semantics(monkeypatch):
    port = unknown_region("port", monkeypatch)
    assert port == unknown_region("ref", monkeypatch)
    assert port[0][0] == "ValueError" and port[1:] == (True, True)


# -- TestRegionReads -----------------------------------------------------------

def reads(kind, monkeypatch):
    with federation(kind, monkeypatch) as (g, eu):
        g.job_register(make_job(kind, "eu", "read-routed"))
        assert wait_until(lambda: eu.state.job_by_id(
            None, "read-routed") is not None, DEADLINE)
        got = g.job_get("read-routed", region="eu")
        listed, idx = g.job_list(prefix="read-", region="eu")
        return (got.id if got else None, [j.id for j in listed], idx > 0,
                g.job_get("read-routed"))


def test_job_list_and_get_route(monkeypatch):
    port = reads("port", monkeypatch)
    assert port == reads("ref", monkeypatch)
    assert port == ("read-routed", ["read-routed"], True, None)


# -- TestMultiSliceMesh --------------------------------------------------------

def two_slices(kind, monkeypatch):
    """Each region its own slice: the port's a mesh of four CPU shards per
    region; the reference's single-device batch worker (its mesh program
    fails under jax 0.9.0)."""
    extra = {}
    if kind == "port":
        from nomad_tpu_torch.ops import resident

        resident.invalidate()
        extra = {"global": {"mesh": make_node_mesh(["cpu"] * 4)},
                 "eu": {"mesh": make_node_mesh(["cpu"] * 4)}}
    with federation(kind, monkeypatch, **extra) as (g, eu):
        nodes = [node(kind) for _ in range(4)]
        for n in nodes:
            eu.node_register(n)
        job = make_job(kind, "eu", count=6)
        _, eval_id = g.job_register(job)
        assert eval_id
        forwarded = (eu.state.job_by_id(None, job.id) is not None,
                     g.state.job_by_id(None, job.id) is None)
        assert wait_until(lambda: len(eu.state.allocs_by_job(
            None, job.id, True)) == 6, 60.0)
        allocs = eu.state.allocs_by_job(None, job.id, True)
        per_node = {}
        for a in allocs:
            assert eu.state.node_by_id(None, a.node_id) is not None
            per_node[a.node_id] = per_node.get(a.node_id, 0) + 1
        # A mesh batch books its uploads under the mesh's key (0 bytes
        # when the resident mirror hits), a single-card batch under the
        # other; the batch books them once it returns, which can be after
        # its plan's allocs are visible.
        keys = ("nomad.batch.mesh_h2d_bytes", "nomad.batch.h2d_bytes")

        def totals():
            return eu.metrics.sink.latest()["CounterTotals"]

        if kind == "port":
            assert wait_until(lambda: any(k in totals() for k in keys),
                              DEADLINE)
        mesh_ran = ((keys[0] in totals() and keys[1] not in totals())
                    if kind == "port" else None)
        return (forwarded, sorted(per_node.values()),
                counter(eu, "breaker.oracle_routed"), mesh_ran)


def test_two_meshes_cross_region(monkeypatch):
    port = two_slices("port", monkeypatch)
    ref = two_slices("ref", monkeypatch)
    assert port[:3] == ref[:3]
    assert port == ((True, True), [1, 1, 2, 2], 0, True)


def test_a_stopped_region_answers_no_path_to_region(monkeypatch):
    """A departure (ROADMAP queue 3 item 26(b)), the port alone: a region
    forward leaves its connection pooled; the region's server then
    stops.  The next forward drops that dead connection before it sends
    (``ConnPool.drop_stale``), its dials fail, and it raises
    ``NoPathToRegion`` with a retry hint within the bound, where the
    reference sends on the dead connection and fails with a
    ``TransportError``.  A plain call of the pool still takes the pooled
    connection as it is."""
    from nomad_tpu_torch.server.rpc import RPC_NOMAD, TransportError

    plain = ConnPool()
    try:
        with federation("port", monkeypatch) as (g, eu):
            addr = eu.config.rpc_advertise
            g.job_register(make_job("port", "eu", "before-stop"))
            assert plain.call(addr, "Status.Ping", {}) == {"ok": True}
            assert g.pool._idle[(addr, RPC_NOMAD)]
            eu.shutdown()
            with pytest.raises(TransportError):
                plain.call(addr, "Status.Ping", {})
            t0 = time.monotonic()
            with pytest.raises(NoPathToRegion) as exc:
                g.job_register(make_job("port", "eu", "after-stop"))
            assert time.monotonic() - t0 < 10.0
            assert exc.value.region == "eu" and exc.value.retry_after > 0
            assert not g.pool._idle.get((addr, RPC_NOMAD))
    finally:
        plain.close()


# -- TestNoPathToRegionWire ----------------------------------------------------

@pytest.mark.parametrize("cls", [JNoPath, NoPathToRegion],
                         ids=["ref", "port"])
def test_from_message_round_trip(cls):
    orig = cls("eu", 2.5, rounds=3, detail="2 dials failed")
    back = NoPathToRegion.from_message(str(orig))
    ref_back = JNoPath.from_message(str(orig))
    assert (back.region, back.retry_after, back.rounds) == (
        ref_back.region, ref_back.retry_after, ref_back.rounds) == (
        "eu", 2.5, 3)
    assert str(NoPathToRegion("eu", 2.5, 3, "x")) == str(
        JNoPath("eu", 2.5, 3, "x"))


def test_from_message_defaults_on_garbage():
    back = NoPathToRegion.from_message("mangled wire error")
    ref = JNoPath.from_message("mangled wire error")
    assert (back.region, back.retry_after, back.rounds) == (
        ref.region, ref.retry_after, ref.rounds)
    assert back.region == "" and back.retry_after > 0


# -- TestRegionPartition -------------------------------------------------------

def sever_mid_submit(kind, monkeypatch):
    fm = fault_mod(kind)
    no_path = JNoPath if kind == "ref" else NoPathToRegion
    with federation(kind, monkeypatch) as (g, eu):
        eu.node_register(node(kind))
        addrs = {"global": [g.config.rpc_advertise],
                 "eu": [eu.config.rpc_advertise]}
        job = make_job(kind, "eu")
        try:
            fm.net_sever_regions(addrs, isolate="eu", name="t-fed-sever")
            t0 = time.monotonic()
            with pytest.raises(no_path) as exc:
                g.job_register(job, region="eu")
            took = time.monotonic() - t0
            out = [exc.value.region, exc.value.retry_after > 0,
                   exc.value.rounds >= 1, took < 15.0,
                   g.state.job_by_id(None, job.id) is None,
                   eu.state.job_by_id(None, job.id) is None]
            fm.net_heal("t-fed-sever")

            def resubmit():
                try:
                    _, eval_id = g.job_register(job, region="eu")
                    return bool(eval_id)
                except no_path:
                    return False

            assert wait_until(resubmit, 15.0)
            assert wait_until(lambda: len(eu.state.allocs_by_job(
                None, job.id, True)) == 1, DEADLINE)
            time.sleep(0.3)
            out += [len(eu.state.allocs_by_job(None, job.id, True)),
                    g.state.job_by_id(None, job.id) is None,
                    len(g.state.allocs_by_job(None, job.id, True)),
                    counter(eu, "breaker.oracle_routed")]
            return out
        finally:
            fm.net_disarm()


def test_sever_mid_submit_is_retryable_then_heals(monkeypatch):
    port = sever_mid_submit("port", monkeypatch)
    assert port == sever_mid_submit("ref", monkeypatch)
    assert port == ["eu", True, True, True, True, True, 1, True, 0, 0]


# -- TestRegionEventAggregator -------------------------------------------------

def agg_classes(kind):
    return (JAgg, JConnPool) if kind == "ref" else (RegionEventAggregator,
                                                    ConnPool)


def fan_in(kind, monkeypatch):
    agg_cls, pool_cls = agg_classes(kind)
    with federation(kind, monkeypatch) as (g, eu):
        subs = [srv.event_stream_subscribe(topics={"Job": set()})
                for srv in (g, eu)]
        pool = pool_cls()
        agg = agg_cls({"global": g.config.rpc_advertise,
                       "eu": eu.config.rpc_advertise}, pool=pool)
        try:
            g.job_register(make_job(kind, "global", "agg-global"))
            eu.job_register(make_job(kind, "eu", "agg-eu"))
            seen = []

            def both():
                seen.extend(agg.poll())
                return {"global", "eu"} <= {ev["Region"] for ev in seen}

            assert wait_until(both, 10.0)
            # The batch worker's mirror publishes NodeStateDelta events
            # outside the log, several with one index and key: the
            # uniqueness check is over the log's own events.
            keys = [(ev["Region"], ev["Index"], ev.get("Topic"),
                     ev.get("Type"), ev.get("Key")) for ev in seen
                    if ev.get("Topic") != "Node"]
            cursors = agg.cursors()
            return (len(keys) == len(set(keys)), cursors["global"] > 0,
                    cursors["eu"] > 0, agg.stats()["Events"] == len(seen),
                    sorted({(ev["Region"], ev.get("Key")) for ev in seen
                            if ev.get("Topic") == "Job"}))
        finally:
            pool.close()
            for sub in subs:
                sub.close()


def test_fan_in_tags_and_cursors(monkeypatch):
    port = fan_in("port", monkeypatch)
    assert port == fan_in("ref", monkeypatch)
    assert port[:4] == (True, True, True, True)


def dark_region(kind, monkeypatch):
    agg_cls, pool_cls = agg_classes(kind)
    fm = fault_mod(kind)
    with federation(kind, monkeypatch) as (g, eu):
        subs = [srv.event_stream_subscribe(topics={"Job": set()})
                for srv in (g, eu)]
        pool = pool_cls()
        agg = agg_cls({"global": g.config.rpc_advertise,
                       "eu": eu.config.rpc_advertise}, pool=pool)
        try:
            eu.job_register(make_job(kind, "eu", "agg-dark-1"))
            assert wait_until(lambda: any(ev["Region"] == "eu"
                                          for ev in agg.poll()), 10.0)
            before = agg.cursors()["eu"]
            fm.net_sever_regions({"global": [g.config.rpc_advertise],
                                  "eu": [eu.config.rpc_advertise]},
                                 isolate="eu", name="t-agg-dark")
            agg.poll()
            dark = ("eu" in agg.unreachable(),
                    agg.cursors()["eu"] == before)
            fm.net_heal("t-agg-dark")
            eu.job_register(make_job(kind, "eu", "agg-dark-2"))
            resumed = []

            def eu_resumes():
                resumed.extend(ev for ev in agg.poll()
                               if ev["Region"] == "eu")
                return any(ev.get("Key") == "agg-dark-2"
                           or "agg-dark-2" in str(ev.get("Payload", ""))
                           for ev in resumed)

            assert wait_until(eu_resumes, 10.0)
            idxs = [ev["Index"] for ev in resumed]
            keys = [(ev["Index"], ev.get("Topic"), ev.get("Type"),
                     ev.get("Key")) for ev in resumed]
            return dark + (idxs == sorted(idxs),
                           len(keys) == len(set(keys)),
                           all(i > before for i in idxs))
        finally:
            fm.net_disarm()
            pool.close()
            for sub in subs:
                sub.close()


def test_dark_region_skipped_cursor_intact(monkeypatch):
    port = dark_region("port", monkeypatch)
    assert port == dark_region("ref", monkeypatch)
    assert port == (True, True, True, True, True)
