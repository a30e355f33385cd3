"""The port's client on a server, over RPC and in an agent, against the
JAX package's.

- A server with three clients in each package (the port's ``Server(
  device="cpu")`` and ``Client``s in process; the reference's ``Server``
  with the batch worker and its ``Client``s), seeded ids, one broker
  seed: a batch job whose task fails once, restarts and fails for good,
  and a service job that runs until it is stopped.  Compared: placements
  ((job, alloc name) -> node), every alloc's final client status, each
  task's event types, the job statuses and summaries.  The reference's
  first heartbeat comes half a TTL after registration (an hour here), so
  the test sends each node's first heartbeat in both worlds.  A stopped
  alloc's last state can fail to reach the reference's server (its
  runner is done before its task dies; ROADMAP queue 3): the test pushes
  those states once in the reference's world (``push_final_states``).
- ``RemoteServerRPC`` against the port's RPC listener: a client that
  reaches its server only over the wire runs a job, and the retry over
  the server list follows a leader hint as the reference's does.
- An agent with a server and a client in each package: the
  ``/v1/client/*`` bodies, ``/v1/agent/servers`` and ``/v1/agent/self``'s
  client stats, and the CLI's ``alloc logs``, ``alloc fs``, ``alloc
  status`` and ``node status -self`` outputs, with the times removed;
  ``/v1/client/gc`` destroys the alloc dirs in both.
- ``Agent(AgentConfig.dev(), device="cpu")`` starts a server and a client
  in one process, and no thread is left after ``shutdown``.

A destroyed running task reports ``Killing`` before ``Killed`` in the
port (its run loop kills it, as task_runner.go orders them; see
``test_torch_client_runners``): the reference's event types are compared
with that ``Killing`` put in.  Every reference server gets its own
``KernelCircuitBreaker`` and ``breaker.oracle_routed`` stays 0 in both.
The fingerprints' probes stay on this machine: connections off the
loopback are refused and the network fingerprint's address is fixed, in
both packages.  Every wait has a deadline.
"""
import contextlib
import dataclasses
import functools
import io
import json
import os
import random
import re
import socket
import threading
import time
import types
import urllib.error
import urllib.request

import jax  # noqa: F401  (the reference computes on the CPU backend)
import pytest

import nomad_tpu.agent.agent as jagent_mod
import nomad_tpu.ops.breaker as jbreaker
import nomad_tpu.server.eval_broker as jeval_broker
import nomad_tpu.server.rpc as jrpc
from nomad_tpu import mock as jmock
from nomad_tpu.agent import Agent as JAgent
from nomad_tpu.agent import parse_config as jparse_config
from nomad_tpu.cli import main as jmain
from nomad_tpu.client import Client as JClient
from nomad_tpu.client import ClientConfig as JClientConfig
from nomad_tpu.client import fingerprint as jfp
from nomad_tpu.server import ServerConfig as JServerConfig
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert
from nomad_tpu_torch.agent import Agent, AgentConfig, parse_config
from nomad_tpu_torch.cli import main
from nomad_tpu_torch.client import Client as PClient
from nomad_tpu_torch.client import ClientConfig as PClientConfig
from nomad_tpu_torch.client import fingerprint as pfp
from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server import rpc as prpc
from nomad_tpu_torch.structs import structs as ps
from nomad_tpu_torch.utils.backoff import wait_until

from test_torch_server import Ids, World, settle

SEED = 29
HEARTBEAT_TTL = 3600.0
DEADLINE = 30.0
KILLS = ("Killed", "Sibling task failed")
_TIME = re.compile(r"\d\d/\d\d/\d\d \d\d:\d\d:\d\d")


@contextlib.contextmanager
def local_only(mp):
    """Fingerprint probes stay on the machine (see the module
    docstring)."""
    real = socket.create_connection

    def connect(address, *args, **kwargs):
        if address[0] not in ("127.0.0.1", "localhost"):
            raise OSError("no network in this test")
        return real(address, *args, **kwargs)

    mp.setattr(socket, "create_connection", connect)
    for mod in (jfp, pfp):
        mp.setattr(mod.NetworkFingerprint, "_default_ip",
                   staticmethod(lambda interface: "10.1.2.3"))
    yield


@pytest.fixture(autouse=True)
def stay_local(monkeypatch):
    """``local_only`` around every test of the file."""
    with local_only(monkeypatch):
        yield


def with_killing(types_):
    out = []
    for t in types_:
        if t in KILLS and out and out[-1] == "Started":
            out.append("Killing")
        out.append(t)
    return out


def mock_job(job_id, type_, count, config, restart, networks=False):
    """``mock.job()`` on the mock driver and the client nodes; its
    network ask (50 Mbit/s, two dynamic ports) kept when ``networks``."""
    j = jmock.job()
    j.id = j.name = job_id
    j.type = type_
    tg = j.task_groups[0]
    tg.count = count
    tg.restart_policy = js.RestartPolicy(**restart)
    tg.ephemeral_disk.size_mb = 10
    for t in tg.tasks:
        t.driver = "mock_driver"
        t.config = dict(config)
        t.services = []
        if not networks:
            t.resources.networks = []
        t.resources.cpu = 250
        t.resources.memory_mb = 64
    j.constraints.append(js.Constraint("${node.class}", "client-slice", "="))
    return j


def jobs():
    return [mock_job("bat", "batch", 4, {"run_for": "100ms", "exit_code": 1},
                     dict(attempts=1, interval=60.0, delay=0.05,
                          mode="fail")),
            mock_job("svc", "service", 3, {"run_for": "1h"},
                     dict(attempts=2, interval=60.0, delay=0.05,
                          mode="delay"), networks=True)]


def node_ids():
    return [f"00000000-0000-0000-0000-{i:012d}" for i in range(3)]


def client_config(cls, root, i):
    return cls(alloc_dir=os.path.join(root, f"c{i}"),
               node_name=f"client-{i}", node_class="client-slice",
               cpu_total_compute=2000)


def terminal(srv, n):
    allocs = srv.state.allocs(None)
    return len(allocs) == n and all(
        a.client_status in ("complete", "failed") for a in allocs)


def push_final_states(clients, job_id):
    """The reference's destroyed ``AllocRunner`` can be done before its
    task's last state is pushed, and then that state never reaches the
    server (ROADMAP queue 3; the port's runner waits for its tasks): once
    each of the job's tasks is dead, its final state is pushed once."""
    for c in clients:
        assert wait_until(lambda: all(
            r.alloc.desired_status == "stop"
            for r in list(c.alloc_runners.values())
            if r.alloc.job_id == job_id), DEADLINE)
        for r in list(c.alloc_runners.values()):
            if r.alloc.job_id != job_id:
                continue
            assert all(tr.done.wait(DEADLINE)
                       for tr in list(r.task_runners.values()))
            c._alloc_status_update(r.current_alloc())


def drive(world, root):
    """The scenario in one world (see the module docstring); its
    outcome."""
    srv = world.srv
    clients = []
    srv.start()
    try:
        for i in range(3):
            # Each client draws its node's uuid from the world's sequence,
            # then takes the fixed id (so both worlds draw alike).
            if world.ref:
                c = JClient(client_config(JClientConfig, root, i), rpc=srv)
            else:
                c = PClient(client_config(PClientConfig, root, i), rpc=srv,
                            rng=random.Random(SEED))
            c.node.id = node_ids()[i]
            clients.append(c)
            c.start()
            # One registration after the other: the store lists nodes in
            # registration order, which breaks score ties.
            assert wait_until(lambda: srv.node_get(node_ids()[i])
                              is not None, DEADLINE)
        with world.paused():
            for i in node_ids():     # each node's first heartbeat
                srv.node_update_status(i, "ready")
        world.wave(jobs())
        assert wait_until(lambda: sum(
            a.client_status == "running" for a in srv.state.allocs(None)
            if a.job_id == "svc") == 3 and all(
                a.client_status == "failed" for a in srv.state.allocs(None)
                if a.job_id == "bat"), DEADLINE)
        with world.paused():
            srv.job_deregister("svc", purge=False)
        if world.ref:
            push_final_states(clients, "svc")
        assert wait_until(lambda: terminal(srv, 7), DEADLINE), (
            world.kind, sorted((a.name, a.desired_status, a.client_status)
                               for a in srv.state.allocs(None)))
        st = srv.state
        out = {
            "placements": sorted((a.job_id, a.name, a.node_id)
                                 for a in st.allocs(None)),
            "statuses": sorted((a.job_id, a.name, a.desired_status,
                                a.client_status) for a in st.allocs(None)),
            "events": sorted(
                (a.job_id, a.name, task,
                 tuple((with_killing if world.ref else list)(
                     [e.type for e in ts.events])))
                for a in st.allocs(None)
                for task, ts in a.task_states.items()),
            "jobs": sorted((j.id, j.status) for j in st.jobs(None)),
            "summaries": {
                j: {tg: dataclasses.asdict(v) for tg, v in
                    st.job_summary_by_id(None, j).summary.items()}
                for j in ("bat", "svc")},
            "nodes": sorted((n.id, n.name, n.status, n.node_class,
                             n.attributes.get("driver.mock_driver"),
                             tuple((nw.device, nw.ip, nw.mbits)
                                   for nw in n.resources.networks))
                            for n in st.nodes(None)),
            "networks": sorted(
                (a.job_id, a.name, task, tuple(
                    (nw.ip, nw.mbits, len(nw.dynamic_ports))
                    for nw in r.networks))
                for a in st.allocs(None)
                for task, r in sorted(a.task_resources.items())),
            "health": (world.breaker.state, world.breaker.trips,
                       world.counter("breaker.oracle_routed"),
                       world.counter("broker.nack")),
            "dirs": [len(os.listdir(os.path.join(root, f"c{i}")))
                     for i in range(3)],
        }
        for c in clients:
            c.garbage_collector.collect_all()
        out["dirs_after_gc"] = [sorted(os.listdir(os.path.join(root,
                                                               f"c{i}")))
                                for i in range(3)]
        out["sync_calls"] = sum(getattr(c, "sync_calls", 0)
                                for c in clients)
    finally:
        for c in clients:
            c.shutdown()
        srv.shutdown()
    if not world.ref:
        assert wait_until(lambda: not any(c.threads() for c in clients),
                          DEADLINE)
        assert wait_until(lambda: not srv.threads(), DEADLINE)
    return out


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleets")
    out = {}
    with pytest.MonkeyPatch.context() as mp, local_only(mp):
        for kind in ("ref", "port"):
            with pytest.MonkeyPatch.context() as wmp:
                out[kind] = drive(World(kind, wmp),
                                  str(root / kind))
    return out


@pytest.mark.parametrize("key", ["placements", "statuses", "events", "jobs",
                                 "summaries", "nodes", "networks", "dirs",
                                 "dirs_after_gc"])
def test_server_and_clients_equal_the_reference(fleets, key):
    assert fleets["port"][key] == fleets["ref"][key]


def test_the_fleets_ran_what_was_planned(fleets):
    port = fleets["port"]
    assert {s for *_, s in port["statuses"]} == {"complete", "failed"}
    bat = [e for e in port["events"] if e[0] == "bat"]
    assert len(bat) == 4 and all(e[3] == (
        "Received", "Started", "Terminated", "Restarting", "Started",
        "Terminated", "Not Restarting") for e in bat)
    svc = [e for e in port["events"] if e[0] == "svc"]
    assert len(svc) == 3 and all(e[3][-2:] == ("Killing", "Killed")
                                 for e in svc)
    assert len({n for *_, n in port["placements"]}) == 3
    # The service job's network ask was placed on the fingerprinted
    # network of each node.
    assert {e[3] for e in port["networks"] if e[0] == "svc"} == {
        (("10.1.2.3", 50, 2),)}
    assert sum(port["dirs"]) == 7 and port["dirs_after_gc"] == [[], [], []]
    assert port["sync_calls"] > 0


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_the_fleets_stayed_healthy(fleets, kind):
    assert fleets[kind]["health"] == ("closed", 0, 0, 0)


# -- RemoteServerRPC -----------------------------------------------------------

def test_a_client_over_the_wire_runs_its_job(tmp_path):
    """A port client whose only way to its server is the RPC listener
    registers, runs a batch job and syncs its statuses; the reads of a
    sticky disk's migration come back typed."""
    srv = Server(ServerConfig(device="cpu", rng_seed=SEED,
                              min_heartbeat_ttl=HEARTBEAT_TTL,
                              enable_rpc=True, num_schedulers=1,
                              breaker=KernelCircuitBreaker()))
    srv.start()
    rpc = prpc.RemoteServerRPC([srv.config.rpc_advertise])
    c = PClient(PClientConfig(node_id="node-wire", node_name="wire",
                              node_class="client-slice",
                              cpu_total_compute=2000,
                              alloc_dir=str(tmp_path)), rpc=rpc,
                heartbeat_stagger=0.1)
    try:
        c.start()
        assert wait_until(lambda: (srv.node_get("node-wire") or
                                   ps.Node()).status == "ready", DEADLINE)
        job = convert.job_from_dict(dataclasses.asdict(mock_job(
            "wire", "batch", 2, {"run_for": "50ms"},
            dict(attempts=0, mode="fail"))))
        srv.job_register(job)
        assert wait_until(lambda: terminal(srv, 2), DEADLINE)
        allocs = srv.state.allocs_by_job(None, "wire", True)
        assert {a.client_status for a in allocs} == {"complete"}
        got = rpc.alloc_get(allocs[0].id)
        assert isinstance(got, ps.Allocation) and got.id == allocs[0].id
        assert [e.type for e in got.task_states["web"].events] == [
            "Received", "Started", "Terminated"]
        node = rpc.node_get("node-wire")
        assert isinstance(node, ps.Node) and node.name == "wire"
        assert rpc.node_get("nope") is None
        assert c.sync_calls > 0 and c.heartbeats > 0
    finally:
        c.shutdown()
        rpc.close()
        srv.shutdown()
    assert wait_until(lambda: not c.threads() and not srv.threads(),
                      DEADLINE)


class FakePool:
    """A pool whose first call to ``a:1`` answers 'not the leader' with a
    hint; every other call succeeds with the address it reached."""

    def __init__(self, rpc_mod, hint):
        self.mod, self.hint, self.calls = rpc_mod, hint, []
        self.timeout = 10.0

    def call(self, addr, method, body, timeout=None, **kw):
        self.calls.append(addr)
        if addr == "a:1" and len(self.calls) == 1:
            raise self.mod.NoLeaderError(self.hint)
        if addr == "dead:9":
            raise self.mod.RPCError("connection refused")
        return {"Index": 7, "HeartbeatTTL": 10.0, "addr": addr}


@pytest.mark.parametrize("hint", ["c:3", "no cluster leader", "a:1"])
def test_remote_rpc_follows_the_leader_hint_like_the_reference(hint):
    out = []
    for mod in (jrpc, prpc):
        pool = FakePool(mod, hint)
        r = mod.RemoteServerRPC(["a:1", "dead:9", "b:2"], pool=pool,
                                sleep=lambda s: None)
        res = r.node_update_status("n", "ready")
        out.append((res, pool.calls, r.servers))
    assert out[1] == out[0]


def test_remote_rpc_gives_up_after_its_rounds():
    out = []
    for mod in (jrpc, prpc):
        pool = FakePool(mod, "")
        r = mod.RemoteServerRPC(["dead:9"], pool=pool, sleep=lambda s: None,
                                max_rounds=2)
        with pytest.raises(mod.RPCError, match="after 2 rounds") as e:
            r.node_update_allocs([])
        out.append((len(pool.calls), str(e.value)))
    assert out[1] == out[0]


# -- the agent with a client -------------------------------------------------

AGENT_HCL = """
name      = "twin"
log_level = "INFO"
data_dir  = "{data_dir}"
ports {{
  http = 0
  rpc  = 0
}}
server {{
  enabled              = true
  num_schedulers       = 1
  batch_size           = 8
  use_tpu_batch_worker = true
}}
client {{
  enabled           = true
  node_class        = "client-slice"
  alloc_dir         = "{data_dir}/allocs"
  cpu_total_compute = 2000
}}
"""
NODE_ID = "00000000-0000-0000-0000-00000000c11e"
# Made once, before any world seeds its ids (mock.job() draws one).
LOGS_JOB = mock_job("logs", "batch", 1, {"run_for": "50ms"},
                    dict(attempts=0, mode="fail"))
LOG = b"line one\nline two\n" * 50


class AgentWorld:
    def __init__(self, kind, mp, tmp_path):
        self.ref = kind == "ref"
        ids = Ids(SEED)
        structs = js if self.ref else ps
        mp.setattr(structs, "generate_uuid", ids.one)
        mp.setattr(structs, "generate_uuids", ids.many)
        self.data_dir = tmp_path / kind
        self.data_dir.mkdir()
        src = AGENT_HCL.format(data_dir=self.data_dir)
        if self.ref:
            mp.setenv("NOMAD_TPU_RNG_SEED", str(SEED))
            self.breaker = jbreaker.KernelCircuitBreaker()
            mp.setattr(jbreaker, "BREAKER", self.breaker)
            mp.setattr(jeval_broker, "random", random.Random(SEED))
            mp.setattr(jagent_mod, "ServerConfig", functools.partial(
                JServerConfig, min_heartbeat_ttl=HEARTBEAT_TTL))
            cfg = jparse_config(src)
            cfg.dev_mode = True
            self.agent = JAgent(cfg)
            self.agent.client.node.id = NODE_ID
        else:
            self.breaker = KernelCircuitBreaker()
            cfg = parse_config(src)
            cfg.dev_mode = True
            self.agent = Agent(cfg, device="cpu", server_options=dict(
                rng_seed=SEED, min_heartbeat_ttl=HEARTBEAT_TTL,
                breaker=self.breaker, broker_seed=SEED))
            # The node's uuid is drawn as the reference's is, then fixed.
            self.agent.client.node.id = NODE_ID
        self.agent.start()
        self.srv = self.agent.server
        self.base = self.agent.http.address

    def counter(self, key):
        return self.srv.metrics.sink.latest()["CounterTotals"].get(
            f"nomad.{key}", 0)

    def run_job(self):
        assert wait_until(lambda: self.srv.node_get(NODE_ID) is not None,
                          DEADLINE)
        self.srv.node_update_status(NODE_ID, "ready")
        job = LOGS_JOB.copy()
        self.srv.job_register(job if self.ref else convert.job_from_dict(
            dataclasses.asdict(job)))
        assert wait_until(lambda: terminal(self.srv, 1), DEADLINE)
        settle(self.srv)
        self.alloc = self.srv.state.allocs(None)[0]
        adir = os.path.join(str(self.data_dir), "allocs", self.alloc.id)
        with open(os.path.join(adir, "alloc", "logs", "web.stdout.0"),
                  "wb") as fh:
            fh.write(LOG)
        with open(os.path.join(adir, "alloc", "data", "hello.txt"),
                  "w") as fh:
            fh.write("hello from the alloc dir\n")
        self.adir = adir


def request(base, method, path):
    req = urllib.request.Request(base + path, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            code, payload = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        code, payload = e.code, e.read()
    text = payload.decode("utf-8", "replace")
    try:
        return code, json.loads(text)
    except ValueError:
        pass
    try:    # a stream of NDJSON frames
        return code, [json.loads(ln) for ln in text.splitlines() if ln]
    except ValueError:
        return code, text


def untimed(obj, world):
    """``obj`` without the keys that hold times or this agent's own
    directories and addresses."""
    if isinstance(obj, dict):
        return {k: untimed(v, world) for k, v in obj.items()
                if k not in ("ModTime", "Timestamp", "Uptime")}
    if isinstance(obj, list):
        return [untimed(v, world) for v in obj]
    if isinstance(obj, str):
        return obj.replace(str(world.data_dir), "<dir>").replace(
            world.base, "<addr>")
    return obj


@pytest.fixture(scope="module")
def agents(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("client-agents")
    with pytest.MonkeyPatch.context() as mp, local_only(mp):
        worlds = []
        try:
            for kind in ("ref", "port"):
                with pytest.MonkeyPatch.context() as wmp:
                    w = AgentWorld(kind, wmp, tmp)
                    worlds.append(w)
                    w.run_job()
            yield worlds
        finally:
            for w in worlds:
                w.agent.shutdown()
    port = worlds[1].agent
    assert wait_until(lambda: not port.threads(), DEADLINE)


def both(agents, method, path):
    out = []
    for w in agents:
        if "<alloc>" in path:
            path = path.replace("<alloc>", w.alloc.id)
        code, body = request(w.base, method, path)
        out.append((code, untimed(body, w)))
    return out


@pytest.mark.parametrize("path", [
    "/v1/client/fs/ls/<alloc>?path=/",
    "/v1/client/fs/ls/<alloc>?path=alloc/logs",
    "/v1/client/fs/stat/<alloc>?path=alloc/data/hello.txt",
    "/v1/client/fs/cat/<alloc>?path=alloc/data/hello.txt",
    "/v1/client/fs/readat/<alloc>?path=alloc/data/hello.txt&offset=6"
    "&limit=4",
    "/v1/client/fs/logs/<alloc>?task=web",
    "/v1/client/fs/logs/<alloc>?task=web&type=stderr",
    "/v1/client/fs/logs/<alloc>?task=web&origin=end&offset=25",
    "/v1/client/fs/logs/<alloc>?task=web&origin=start&offset=0",
    "/v1/client/fs/stream/<alloc>?path=alloc/data/hello.txt&follow=false",
    "/v1/client/fs/logs/<alloc>",
    "/v1/client/fs/ls/",
    "/v1/client/fs/bogus/<alloc>",
    "/v1/client/fs/ls/unknown-alloc",
    "/v1/client/allocation/<alloc>/stats",
    "/v1/client/allocation/unknown-alloc/stats",
])
def test_client_routes_equal_the_reference(agents, path):
    (rc, rb), (pc, pb) = both(agents, "GET", path)
    assert (pc, pb) == (rc, rb)
    if "hello.txt" in path and "stat" not in path and rc == 200:
        assert "hello" in json.dumps(pb) or pb


def test_client_stats_equal_the_reference(agents):
    (rc, rb), (pc, pb) = both(agents, "GET", "/v1/client/stats")
    assert rc == pc == 200
    assert set(pb) == set(rb)
    assert (pb["node_id"], pb["known_servers"], pb["num_allocations"]) == \
        (rb["node_id"], rb["known_servers"], rb["num_allocations"]) == \
        (NODE_ID, [], 1)
    assert set(pb["host_stats"]) == set(rb["host_stats"])


def test_agent_servers_and_self_equal_the_reference(agents):
    assert both(agents, "GET", "/v1/agent/servers") == [(200, [])] * 2
    (rc, _), (pc, _) = both(agents, "PUT",
                            "/v1/agent/servers?address=10.9.9.9:4647")
    assert rc == pc == 200
    assert both(agents, "GET", "/v1/agent/servers") == \
        [(200, ["10.9.9.9:4647"])] * 2
    (_, rb), (_, pb) = both(agents, "GET", "/v1/agent/self")
    assert pb["stats"]["client"] == rb["stats"]["client"]
    assert pb["config"]["Client"] == rb["config"]["Client"] == {
        "Enabled": True}


@pytest.mark.parametrize("argv", [
    ["alloc", "logs", "<alloc>", "web"],
    ["alloc", "logs", "-stderr", "<alloc>", "web"],
    ["alloc", "logs", "-tail", "25", "<alloc>", "web"],
    ["alloc", "fs", "<alloc>", "alloc/data"],
    ["alloc", "fs", "-stat", "<alloc>", "alloc/data/hello.txt"],
    ["alloc", "fs", "-cat", "<alloc>", "alloc/data/hello.txt"],
    ["alloc", "status", "<alloc>"],
])
def test_cli_outputs_equal_the_reference(agents, argv):
    """The reference's one-word verbs (``logs``, ``fs``, ``alloc-status``)
    against the port's two-word spellings of them."""
    ref, port = agents
    one = {"logs": "logs", "fs": "fs", "status": "alloc-status"}[argv[1]]
    rest = [a.replace("<alloc>", ref.alloc.id) for a in argv[2:]]
    jbuf, pbuf = io.StringIO(), io.StringIO()
    jrc = jmain([one, "-address", ref.base] + rest, out=jbuf)
    prc = main(argv[:2] + ["-address", port.base] + [
        a.replace("<alloc>", port.alloc.id) for a in argv[2:]], out=pbuf)
    want = untimed(_TIME.sub("<time>", jbuf.getvalue()), ref)
    got = untimed(_TIME.sub("<time>", pbuf.getvalue()), port)
    if "-stat" in argv:
        want, got = (json.dumps(untimed(json.loads(t), w)) for t, w in
                     ((want, ref), (got, port)))
    assert (prc, got) == (jrc, want)
    if argv[1] == "logs" and "-stderr" not in argv:
        assert "line two" in got
    if argv[1] == "status":
        assert "Terminated" in got and "Exit Code: 0" in got


def test_node_status_self_reads_the_agents_client(agents):
    port = agents[1]
    buf = io.StringIO()
    assert main(["node", "status", "-self", "-address", port.base],
                out=buf) == 0
    text = buf.getvalue()
    assert NODE_ID in text and "client-slice" in text
    assert port.alloc.id[:8] in text


def test_client_gc_destroys_the_alloc_dirs_in_both(agents):
    assert all(os.path.isdir(w.adir) for w in agents)
    (rc, _), (pc, _) = both(agents, "PUT", "/v1/client/gc")
    assert rc == pc == 200
    assert not any(os.path.isdir(w.adir) for w in agents)
    assert both(agents, "DELETE", "/v1/client/gc")[0][0] == \
        both(agents, "DELETE", "/v1/client/gc")[1][0] == 405


@pytest.mark.parametrize("kind", [0, 1])
def test_the_agents_stayed_healthy(agents, kind):
    w = agents[kind]
    assert (w.breaker.state, w.breaker.trips,
            w.counter("breaker.oracle_routed")) == ("closed", 0, 0)


# -- the dev agent -----------------------------------------------------------

def test_dev_agent_starts_a_server_and_a_client_on_the_cpu(tmp_path):
    cfg = AgentConfig.dev()
    cfg.ports.http = 0
    cfg.client.alloc_dir = str(tmp_path)
    before = set(threading.enumerate())
    a = Agent(cfg, device="cpu", server_options={
        "min_heartbeat_ttl": HEARTBEAT_TTL})
    a.client.heartbeat_stagger = 0.1
    try:
        a.start()
        assert a.server is not None and a.client is not None
        assert a.client.rpc is a.server
        node_id = a.client.node.id
        assert wait_until(lambda: (a.server.node_get(node_id) or
                                   ps.Node()).status == "ready", DEADLINE)
        code, body = request(a.http.address, "GET", "/v1/client/stats")
        assert code == 200 and body["node_id"] == node_id
        # Every builtin fingerprint ran, as the reference's client runs
        # them: the network one applied (its address fixed here), the
        # cloud metadata probes found no answer.
        applied = set(a.client.fingerprints_applied)
        assert "network" in applied and not {"env_aws", "env_gce"} & applied
        node = a.server.node_get(node_id)
        assert [(n.ip, n.mbits) for n in node.resources.networks] == [
            ("10.1.2.3", 1000)]
    finally:
        a.shutdown()
    assert wait_until(lambda: not a.threads(), DEADLINE)
    assert wait_until(lambda: set(threading.enumerate()) <= before, DEADLINE)


def test_client_only_agent_reaches_its_server_over_rpc(tmp_path):
    srv = Server(ServerConfig(device="cpu", min_heartbeat_ttl=HEARTBEAT_TTL,
                              enable_rpc=True))
    srv.start()
    cfg = parse_config(f'client {{\n enabled = true\n servers = '
                       f'["{srv.config.rpc_advertise}"]\n alloc_dir = '
                       f'"{tmp_path}"\n}}\nports {{\n http = 0\n}}')
    a = Agent(cfg, device="cpu", client_options={"node_id": "node-remote"})
    try:
        assert a.server is None
        assert isinstance(a.client.rpc, prpc.RemoteServerRPC)
        a.start()
        assert wait_until(lambda: srv.node_get("node-remote") is not None,
                          DEADLINE)
        assert both([types.SimpleNamespace(base=a.http.address, alloc=None,
                                           data_dir=tmp_path)],
                    "GET", "/v1/agent/servers") == [
            (200, [srv.config.rpc_advertise])]
    finally:
        a.shutdown()
        srv.shutdown()
    assert wait_until(lambda: not a.threads(), DEADLINE)


def test_vault_in_the_client_config_raises_naming_item_30():
    """The client's vault transport is ported (the config raised naming
    ROADMAP item 30 before): ``vault_addr`` and ``vault_token`` are kept
    as the reference's config keeps them."""
    cfg = PClientConfig(vault_addr="http://127.0.0.1:8200",
                        vault_token="t")
    ref = JClientConfig(vault_addr="http://127.0.0.1:8200", vault_token="t")
    assert (cfg.vault_addr, cfg.vault_token) == (
        ref.vault_addr, ref.vault_token) == ("http://127.0.0.1:8200", "t")
