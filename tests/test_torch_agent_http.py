"""The port's agent and HTTP API (``nomad_tpu_torch/agent``) against the
JAX package's (``nomad_tpu/agent``), with the client off in both.

Each world is an agent from one HCL config (a server, no client, HTTP
and RPC on ephemeral ports, the in-memory log).  The reference's server
runs its batch worker (``use_tpu_batch_worker = true``) with a
``KernelCircuitBreaker`` of its own; the port's runs ``torch-batch`` on
the CPU.  Both draw their ids from one seeded sequence each, the
broker's draw among equal-priority queues from ``random.Random(SEED)``
(the reference's module patched, the port's ``broker_seed``), run every
columnar guard at every read, and grant nodes an hour of heartbeat TTL.
The same requests go to both, one world after the other, each settled
before the next request; the JSON bodies are compared with the times
removed (``TIMES``), the reference's job fields the port does not carry
removed from its side (``REF_ONLY``), each agent's own addresses named
alike, and scores within 1e-5.  This covers the scenarios of
``tests/test_agent_http.py`` that need no client: jobs, nodes, allocs
and evals, blocking queries (one that wakes on a commit), the 429s of
the API rate and of the broker's admission, the client routes' 400,
the system, status, operator and keyring routes, the catalog and KV,
the event stream (launch and dispatch times read one fixed clock in
both), the agent configs (HCL, JSON, env, sockaddr,
``tls {}``), the agent's refusals (the scheduler list, no card), its
vault and WAN-join configs, an agent with a client starting (the client routes'
bodies are ``test_torch_client_agent.py``'s) and a shutdown that leaves
no thread.
"""
import base64
import contextlib
import dataclasses
import functools
import json
import random
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
import nomad_tpu.server.periodic as jperiodic
from nomad_tpu import mock as jmock
from nomad_tpu.agent import Agent as JAgent
from nomad_tpu.agent import parse_config as jparse_config
from nomad_tpu.api.codec import to_wire as jto_wire
from nomad_tpu.server import ServerConfig as JServerConfig
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert
from nomad_tpu_torch.agent import Agent, parse_config
from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
from nomad_tpu_torch.server import periodic as pperiodic
from nomad_tpu_torch.structs import structs as ps

from nomad_tpu_torch.utils.backoff import wait_until
from test_torch_server import Ids, park_signal, settled

SEED = 23
HEARTBEAT_TTL = 3600.0
SETTLE_TIMEOUT = 60.0
# The wall clock of launch and dispatch times in both worlds.
NOW = 1_800_000_000.0

# Wire keys that hold wall-clock times.
TIMES = frozenset({"CreateTime", "SubmitTime", "AllocationTime",
                   "StatusUpdatedAt", "ModifyTime"})
# The reference's job fields the port's structs do not carry (none since
# the vault integration).
REF_ONLY = frozenset()

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
  enabled = false
}}
"""


def settle(srv):
    """Nothing queued, in flight or pending, at two looks 0.1 s apart."""
    for _ in range(2):
        assert wait_until(lambda: settled(srv), SETTLE_TIMEOUT,
                          max_interval=0.02)
        time.sleep(0.1)
    assert settled(srv)


def node_template():
    n = jmock.node()
    n.resources.networks = []
    n.reserved.networks = []
    return n


def job_template():
    j = jmock.job()
    for t in j.task_groups[0].tasks:
        t.resources.networks = []
        t.resources.cpu = 100
        t.resources.memory_mb = 64
        for svc in t.services:
            svc.port_label = ""
    return j


# Made once, before any world seeds its ids: the templates consume none.
NODE = node_template()
JOB = job_template()


def make_node(i):
    n = NODE.copy()
    n.id = f"00000000-0000-0000-0000-{i:012d}"
    n.name = f"node-{i}"
    n.compute_class()
    return n


def make_job(job_id, count=1, **fields):
    j = JOB.copy()
    j.id = j.name = job_id
    j.task_groups[0].count = count
    for k, v in fields.items():
        setattr(j, k, v)
    return j


class World:
    """One agent of either package, started."""

    def __init__(self, kind, mp, tmp_path):
        self.ref = kind == "ref"
        ids = Ids(SEED)
        structs = js if self.ref else ps
        mp.setattr(structs, "generate_uuid", ids.one)
        mp.setattr(structs, "generate_uuids", ids.many)
        mp.setattr(structs, "now", lambda: NOW)
        mp.setattr(jperiodic if self.ref else pperiodic, "time",
                   types.SimpleNamespace(time=lambda: NOW))
        self.data_dir = tmp_path / kind
        self.data_dir.mkdir()
        src = AGENT_HCL.format(data_dir=self.data_dir)
        if self.ref:
            mp.setenv("NOMAD_TPU_RNG_SEED", str(SEED))
            mp.setenv("NOMAD_TPU_COLUMNAR", "1")
            mp.setenv("NOMAD_TPU_COLUMNAR_GUARD_EVERY", "1")
            self.breaker = jbreaker.KernelCircuitBreaker()
            mp.setattr(jbreaker, "BREAKER", self.breaker)
            mp.setattr(jeval_broker, "random", random.Random(SEED))
            mp.setattr(jagent_mod, "ServerConfig", functools.partial(
                JServerConfig, min_heartbeat_ttl=HEARTBEAT_TTL))
            cfg = jparse_config(src)
            cfg.dev_mode = True
            self.agent = JAgent(cfg)
        else:
            self.breaker = KernelCircuitBreaker()
            cfg = parse_config(src)
            cfg.dev_mode = True
            self.agent = Agent(cfg, device="cpu", server_options=dict(
                rng_seed=SEED, min_heartbeat_ttl=HEARTBEAT_TTL,
                breaker=self.breaker, broker_seed=SEED,
                columnar_guard_every=1))
        self.agent.start()
        self.srv = self.agent.server
        self.base = self.agent.http.address
        self.me = self.srv.config.rpc_advertise

    def obj(self, o, fn):
        return o if self.ref else fn(dataclasses.asdict(o))

    def node_register(self, node):
        self.srv.node_register(self.obj(node, convert.node_from_dict))

    def pause(self):
        if self.ref:
            parked = [park_signal(w) for w in self.srv.workers]
            for w in self.srv.workers:
                w.set_pause(True)
            assert all(ev.wait(30.0) for ev in parked)
        else:
            assert self.srv.set_workers_paused(True, timeout=30.0)

    def release(self):
        for w in self.srv.workers:
            w.set_pause(False)


def http(base, method, path, body=None, raw=None, timeout=30.0):
    """(status, headers, body): the body parsed as JSON when it is JSON,
    else the text."""
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(base + path, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            code, headers, payload = resp.status, dict(resp.headers), \
                resp.read()
    except urllib.error.HTTPError as e:
        code, headers, payload = e.code, dict(e.headers), e.read()
    text = payload.decode("utf-8", "replace")
    if headers.get("Content-Type") == "application/json" and text:
        return code, headers, json.loads(text)
    return code, headers, text


def normalized(obj, me):
    """``obj`` with the times and the reference-only fields removed and
    this agent's RPC address named ``<self>``."""
    if isinstance(obj, dict):
        return {k: normalized(v, me) for k, v in obj.items()
                if k not in TIMES and k not in REF_ONLY}
    if isinstance(obj, list):
        return [normalized(v, me) for v in obj]
    if isinstance(obj, str):
        return obj.replace(me, "<self>").replace(me.rsplit(":", 1)[0],
                                                 "<host>")
    return obj


def assert_same(want, got, path="$"):
    """Equal, floats within 1e-5 (the scores)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            path, sorted(set(want) ^ set(got or {})))
        for k in want:
            assert_same(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, got)
        for i, (a, b) in enumerate(zip(want, got)):
            assert_same(a, b, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert got == pytest.approx(want, abs=1e-5), (path, want, got)
    else:
        assert got == want, (path, want, got)


class Pair:
    def __init__(self, ref, port):
        self.ref, self.port = ref, port

    def worlds(self):
        return (self.ref, self.port)

    def each(self, fn):
        """``fn(world)`` in the reference's world, settled, then in the
        port's, settled."""
        out = []
        for w in self.worlds():
            out.append(fn(w))
            settle(w.srv)
        return out

    def call(self, method, path, body=None):
        """The request in both worlds, each settled after a write; (ref,
        port) of (status, body)."""
        out = []
        for w in self.worlds():
            code, _h, payload = http(w.base, method, path, body)
            out.append((code, normalized(payload, w.me)))
            if method != "GET":
                settle(w.srv)
        return out

    def same(self, method, path, body=None, code=200):
        (rc, rb), (pc, pb) = self.call(method, path, body)
        assert (pc, rc) == (code, code), (path, rb, pb)
        assert_same(rb, pb)
        return rb

    def register(self, job):
        return self.same("PUT", "/v1/jobs", {"Job": jto_wire(job)})


@contextlib.contextmanager
def twin_agents(tmp_path, nodes=4):
    """Both agents started with ``nodes`` nodes registered in each."""
    with pytest.MonkeyPatch.context() as mp:
        ref = World("ref", mp, tmp_path)
        try:
            port = World("port", mp, tmp_path)
        except BaseException:
            ref.agent.shutdown()
            raise
        pair = Pair(ref, port)
        try:
            for i in range(nodes):
                pair.each(lambda w, i=i: w.node_register(make_node(i)))
            yield pair
        finally:
            ref.agent.shutdown()
            port.agent.shutdown()
            assert wait_until(lambda: not port.agent.threads(), 15.0)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    with twin_agents(tmp_path_factory.mktemp("agents")) as p:
        yield p


# -- jobs --------------------------------------------------------------------

def test_register_list_info(pair):
    resp = pair.register(make_job("web", count=2))
    assert resp["EvalID"] and resp["JobModifyIndex"] > 0
    jobs = pair.same("GET", "/v1/jobs")
    assert any(j["ID"] == "web" for j in jobs)
    info = pair.same("GET", "/v1/job/web")
    assert info["TaskGroups"][0]["RestartPolicy"]["Attempts"] == 3
    pair.same("GET", "/v1/jobs?prefix=we")


@pytest.mark.parametrize("path,code", [
    ("/v1/job/does-not-exist", 404), ("/v1/job/web/summary", 200),
    ("/v1/job/web/allocations", 200), ("/v1/job/web/allocations?all=true",
                                       200),
    ("/v1/job/web/evaluations", 200), ("/v1/job/nope/summary", 404),
    ("/v1/job/", 400), ("/v1/job/web/bogus/sub", 404)])
def test_job_reads(pair, path, code):
    if not pair.ref.srv.state.job_by_id(None, "web"):
        pair.register(make_job("web", count=2))
    pair.same("GET", path, code=code)


def test_plan_validate_evaluate(pair):
    job = make_job("planned", count=2)
    plan = pair.same("PUT", "/v1/job/planned/plan",
                     {"Job": jto_wire(job), "Diff": True})
    assert plan["Annotations"]["DesiredTGUpdates"]["web"]["Place"] == 2
    pair.same("PUT", "/v1/job/other/plan", {"Job": jto_wire(job)}, code=400)
    good = pair.same("PUT", "/v1/validate/job", {"Job": jto_wire(job)})
    assert good["ValidationErrors"] == []
    bad = make_job("bad")
    bad.task_groups[0].tasks[0].driver = ""
    assert pair.same("PUT", "/v1/validate/job",
                     {"Job": jto_wire(bad)})["ValidationErrors"]
    pair.register(job)
    assert pair.same("PUT", "/v1/job/planned/evaluate")["EvalID"]


def test_deregister(pair):
    pair.register(make_job("gone"))
    assert pair.same("DELETE", "/v1/job/gone")["EvalID"]
    pair.same("GET", "/v1/job/gone", code=404)
    pair.same("DELETE", "/v1/job/gone", code=400)


def test_dispatch_and_periodic_force(pair):
    par = make_job("par", parameterized_job=js.ParameterizedJobConfig(
        payload="required", meta_required=["who"]))
    pair.register(par)
    resp = pair.same("PUT", "/v1/job/par/dispatch",
                     {"Payload": base64.b64encode(b"hello").decode(),
                      "Meta": {"who": "world"}})
    child = resp["DispatchedJobID"]
    assert child.startswith("par/dispatch-")
    info = pair.same("GET", f"/v1/job/{child}")
    assert info["ParentID"] == "par" and info["Meta"]["who"] == "world"
    pair.same("PUT", "/v1/job/par/dispatch",
              {"Payload": base64.b64encode(b"x").decode(), "Meta": {}},
              code=400)
    per = make_job("per", type="batch", periodic=js.PeriodicConfig(
        enabled=True, spec="*/5 * * * *"))
    assert pair.register(per)["EvalID"] == ""
    (rc, _), (pc, _) = pair.call("PUT", "/v1/job/per/periodic/force")
    assert rc == pc == 200
    pair.same("PUT", "/v1/job/missing/periodic/force", code=404)


def test_other_region_answers_as_the_reference(pair):
    pair.same("GET", "/v1/jobs?region=elsewhere", code=400)
    pair.same("PUT", "/v1/jobs?region=elsewhere",
              {"Job": jto_wire(make_job("far"))}, code=400)
    pair.same("GET", "/v1/namespaces?region=elsewhere", code=400)


# -- nodes, allocations, evaluations ----------------------------------------

def test_nodes(pair):
    nodes = pair.same("GET", "/v1/nodes")
    node_id = nodes[0]["ID"]
    node = pair.same("GET", f"/v1/node/{node_id}")
    assert node["Status"] == "ready"
    pair.same("GET", f"/v1/node/{node_id}/allocations")
    pair.same("GET", "/v1/nodes?prefix=00000000")
    pair.same("GET", "/v1/node/nope", code=404)
    assert pair.same("PUT", f"/v1/node/{node_id}/drain?enable=true")[
        "NodeModifyIndex"] > 0
    assert pair.same("GET", f"/v1/node/{node_id}")["Drain"] is True
    pair.same("PUT", f"/v1/node/{node_id}/drain?enable=false")
    assert "EvalIDs" in pair.same("PUT", f"/v1/node/{node_id}/evaluate")
    pair.same("PUT", "/v1/node/nope/evaluate", code=400)


def test_allocs_and_evals(pair):
    resp = pair.register(make_job("allocd", count=2))
    eval_id = resp["EvalID"]
    stubs = pair.same("GET", "/v1/job/allocd/allocations")
    assert len(stubs) == 2
    alloc = pair.same("GET", f"/v1/allocation/{stubs[0]['ID']}")
    assert alloc["JobID"] == "allocd"
    assert alloc["Metrics"]["Scores"]
    pair.same("GET", "/v1/allocations")
    pair.same("GET", f"/v1/allocations?prefix={stubs[0]['ID'][:4]}")
    pair.same("GET", "/v1/allocation/nope", code=404)
    ev = pair.same("GET", f"/v1/evaluation/{eval_id}")
    assert ev["Status"] == "complete"
    assert len(pair.same("GET",
                         f"/v1/evaluation/{eval_id}/allocations")) == 2
    pair.same("GET", "/v1/evaluations")
    pair.same("GET", f"/v1/evaluations?prefix={eval_id[:4]}")
    pair.same("GET", "/v1/evaluation/nope", code=404)


# -- blocking queries --------------------------------------------------------

def blocking_get(w, path, out):
    t0 = time.monotonic()
    code, headers, body = http(w.base, "GET", path)
    out.update(code=code, index=int(headers.get("X-Nomad-Index") or 0),
               body=normalized(body, w.me), waited=time.monotonic() - t0)


def test_blocking_query_wakes_on_commit(pair):
    """A job-list long poll and an allocs long poll started before a
    register return once the job and then its plan are committed, with a
    higher index; the bodies agree."""
    got = []
    for w in pair.worlds():
        jobs_at = w.srv.state.table_index("jobs")
        allocs_at = w.srv.raft.applied_index()
        outs = [{}, {}]
        threads = [threading.Thread(target=blocking_get, args=(
            w, f"/v1/jobs?index={jobs_at}&wait=20s", outs[0])),
            threading.Thread(target=blocking_get, args=(
                w, f"/v1/allocations?index={allocs_at}&wait=20s", outs[1]))]
        for t in threads:
            t.start()
        time.sleep(0.4)
        assert all(t.is_alive() for t in threads)  # both polls are held
        code, _h, _b = http(w.base, "PUT", "/v1/jobs",
                            {"Job": jto_wire(make_job("woken"))})
        assert code == 200
        for t in threads:
            t.join(20)
        settle(w.srv)
        assert outs[0]["index"] > jobs_at and outs[1]["index"] > allocs_at
        assert outs[0]["waited"] < 15 and outs[1]["waited"] < 15
        assert any(j["ID"] == "woken" for j in outs[0]["body"])
        assert any(a["JobID"] == "woken" for a in outs[1]["body"])
        got.append([o["body"] for o in outs])
    assert_same(got[0][0], got[1][0])


def test_blocking_query_times_out(pair):
    for w in pair.worlds():
        index = w.srv.state.table_index("jobs") + 1000
        out = {}
        blocking_get(w, f"/v1/jobs?index={index}&wait=1s", out)
        assert out["code"] == 200 and 0.9 <= out["waited"] < 5.0


def test_blocking_eval_read_wakes_when_the_eval_completes(pair):
    for w in pair.worlds():
        w.pause()
        code, _h, body = http(w.base, "PUT", "/v1/jobs",
                              {"Job": jto_wire(make_job("awaited"))})
        eval_id = body["EvalID"]
        _c, headers, ev = http(w.base, "GET", f"/v1/evaluation/{eval_id}")
        assert ev["Status"] == "pending"
        index = int(headers["X-Nomad-Index"])
        out = {}
        t = threading.Thread(target=blocking_get, args=(
            w, f"/v1/evaluation/{eval_id}?index={index}&wait=20s", out))
        t.start()
        time.sleep(0.3)
        assert t.is_alive()
        w.release()
        t.join(20)
        settle(w.srv)
        assert out["index"] > index


# -- the front door's 429s ---------------------------------------------------

def test_api_rate_answers_429_with_retry_after(pair):
    ns = {"Name": "ratey", "ApiRate": 0.01, "ApiBurst": 1}
    pair.same("PUT", "/v1/namespaces", {"Namespace": ns})
    pair.same("GET", "/v1/namespace/ratey")
    first = pair.register(make_job("rated-1", namespace="ratey"))
    assert first["EvalID"]
    for w in pair.worlds():
        code, headers, body = http(w.base, "PUT", "/v1/jobs", {
            "Job": jto_wire(make_job("rated-2", namespace="ratey"))})
        assert code == 429, body
        assert float(headers["Retry-After"]) > 0
        assert "API rate limit exceeded" in body


def test_broker_admission_answers_429_with_retry_after(pair):
    for w in pair.worlds():
        broker = w.srv.eval_broker
        prev = broker.max_pending
        broker.max_pending = 1
        with broker._l:
            broker.evals["fake-saturation"] = 0
        try:
            code, headers, body = http(w.base, "PUT", "/v1/jobs", {
                "Job": jto_wire(make_job("refused"))})
            assert code == 429, body
            assert float(headers["Retry-After"]) > 0
            assert "eval broker at capacity" in body
        finally:
            broker.max_pending = prev
            with broker._l:
                broker.evals.pop("fake-saturation", None)
    pair.same("GET", "/v1/job/refused", code=404)


def test_broker_stats(pair):
    (rc, rb), (pc, pb) = pair.call("GET", "/v1/broker/stats")
    assert rc == pc == 200
    assert set(rb) <= set(pb)
    assert set(pb["ByState"]) == set(rb["ByState"])


# -- the client routes -------------------------------------------------------

@pytest.mark.parametrize("method,path", [
    ("GET", "/v1/client/stats"),
    ("GET", "/v1/client/allocation/abc/stats"),
    ("GET", "/v1/client/fs/ls/abc"), ("GET", "/v1/client/fs/logs/abc"),
    ("GET", "/v1/client/fs/ls/"), ("GET", "/v1/client/fs/bogus/abc"),
    ("PUT", "/v1/client/gc"), ("DELETE", "/v1/client/gc"),
    ("GET", "/v1/agent/servers"), ("PUT", "/v1/agent/servers?address=x")])
def test_client_routes_answer_as_without_a_client(pair, method, path):
    (rc, rb), (pc, pb) = pair.call(method, path)
    assert (pc, pb) == (rc, rb)


# -- agent, status, operator, system -----------------------------------------

def test_agent_self_and_members(pair):
    (rc, rb), (pc, pb) = pair.call("GET", "/v1/agent/self")
    assert rc == pc == 200
    for body in (rb, pb):
        body["config"].pop("Version")
        body["config"].pop("DataDir")  # each world's own directory
    assert pb["config"] == rb["config"]
    assert pb["member"] == rb["member"]
    assert pb["config"]["Client"]["Enabled"] is False
    pair.same("GET", "/v1/agent/members")


@pytest.mark.parametrize("path", [
    "/v1/status/leader", "/v1/status/peers", "/v1/regions",
    "/v1/regions?detail=1", "/v1/operator/raft/configuration",
    "/v1/namespaces", "/v1/namespace/default", "/v1/catalog/services",
    "/v1/catalog/service/nomad", "/v1/traces",
    "/v1/profile/continuous?seconds=5", "/v1/bogus"])
def test_reads(pair, path):
    (rc, rb), (pc, pb) = pair.call("GET", path)
    assert pc == rc
    if path.startswith(("/v1/catalog", "/v1/profile")):
        # The catalog's and the profiler's shapes (addresses and samples
        # are each world's own).
        if isinstance(rb, dict):
            assert set(pb) == set(rb)
        else:
            assert len(pb) == len(rb)
    else:
        assert_same(rb, pb)


@pytest.mark.parametrize("method,path,code", [
    ("DELETE", "/v1/nodes", 405), ("PUT", "/v1/system/gc", 200),
    ("PUT", "/v1/system/reconcile/summaries", 200),
    ("GET", "/v1/system/gc", 405), ("DELETE", "/v1/operator/raft/peer", 400),
    ("GET", "/v1/operator/raft/peer", 405), ("PUT", "/v1/agent/join", 400),
    ("PUT", "/v1/agent/force-leave", 400),
    ("PUT", "/v1/agent/force-leave?node=nobody", 404),
    ("GET", "/v1/debug/blackbox", 404), ("GET", "/debug/pprof/heap", 404),
    ("GET", "/v1/trace/eval/nope", 404)])
def test_system_operator_and_gated_routes(pair, method, path, code):
    (rc, rb), (pc, pb) = pair.call(method, path)
    assert (rc, pc) == (code, code)
    if "trace/eval" not in path:
        assert pb == rb


def test_raft_peer_removal_of_an_unknown_address(pair):
    """404 naming the address (the reference's server on its in-memory
    log answers 500 here: its log has no peer set)."""
    code, _h, body = http(pair.port.base, "DELETE",
                          "/v1/operator/raft/peer?address=10.0.0.9:4647")
    assert code == 404 and "10.0.0.9:4647" in body


def test_keyring(pair):
    k1 = base64.b64encode(bytes(range(32))).decode()
    k2 = base64.b64encode(bytes(range(1, 33))).decode()
    for w in pair.worlds():
        w.agent.config.data_dir = str(w.data_dir)
    resp = pair.same("PUT", "/v1/agent/keyring/install", {"Key": k1})
    assert resp["Keys"] == {k1: 1}
    pair.same("PUT", "/v1/agent/keyring/install", {"Key": k2})
    pair.same("GET", "/v1/agent/keyring/list")
    pair.same("PUT", "/v1/agent/keyring/remove", {"Key": k1}, code=400)
    pair.same("PUT", "/v1/agent/keyring/use", {"Key": k2})
    assert pair.same("PUT", "/v1/agent/keyring/remove",
                     {"Key": k1})["Keys"] == {k2: 1}
    pair.same("PUT", "/v1/agent/keyring/install", {"Key": "short"},
              code=400)
    pair.same("GET", "/v1/agent/keyring/bogus", code=404)
    pair.same("GET", "/v1/agent/keyring/install", code=405)


def test_kv(pair):
    for w in pair.worlds():
        code, _h, body = http(w.base, "PUT", "/v1/kv/app/config",
                              raw=b"value-1")
        assert code == 200 and body["Key"] == "app/config"
    pair.same("GET", "/v1/kv/app/config")
    pair.same("GET", "/v1/kv/app?recurse")
    pair.same("DELETE", "/v1/kv/app/config")
    pair.same("GET", "/v1/kv/app/config", code=404)


def test_event_stream(pair):
    """The buffered events (follow=false) of the worlds' jobs and
    evals, by content."""
    for w in pair.worlds():
        w.srv.enable_event_stream()
    pair.register(make_job("streamed", count=2))
    (rc, rb), (pc, pb) = pair.call(
        "GET", "/v1/event/stream?follow=false&topic=Job,Eval")
    assert rc == pc == 200

    def rows(text):
        return [(e["Topic"], e["Type"], e["Key"])
                for e in map(json.loads, text.splitlines()) if e]

    assert rows(pb) == rows(rb)
    assert ("Job", "JobRegistered", "streamed") in rows(pb)
    pair.same("GET", "/v1/event/stream?index=1&topic=Job", code=400)


def test_metrics_and_prometheus(pair):
    (rc, _), (pc, pb) = pair.call("GET", "/v1/metrics?format=prometheus")
    assert rc == pc == 200 and "nomad_" in pb
    (rc, _), (pc, _) = pair.call("GET", "/v1/metrics")
    assert rc == pc == 200


def test_monitor_streams_backlog_and_live_lines(pair):
    agent = pair.port.agent
    agent.logger.info("before-monitor marker")
    lines = []

    def run():
        with contextlib.suppress(Exception):
            with urllib.request.urlopen(agent.http.address
                                        + "/v1/agent/monitor",
                                        timeout=30) as resp:
                for raw in resp:
                    frame = json.loads(raw)
                    if frame.get("Data"):
                        lines.append(base64.b64decode(
                            frame["Data"]).decode())

    t = threading.Thread(target=run, daemon=True)
    t.start()
    deadline = time.time() + 10
    while time.time() < deadline and "before-monitor" not in "".join(lines):
        time.sleep(0.05)
    assert "before-monitor marker" in "".join(lines)
    agent.logger.info("after-monitor marker")
    deadline = time.time() + 10
    while time.time() < deadline and "after-monitor" not in "".join(lines):
        time.sleep(0.05)
    assert "after-monitor marker" in "".join(lines)


def test_placements_equal_the_reference(pair):
    """Last: every alloc of the module's jobs on the same node in both
    worlds, with the same statuses."""
    def content(srv):
        return sorted((a.job_id, a.name, a.node_id, a.desired_status,
                       a.client_status) for a in srv.state.allocs(None))

    assert content(pair.port.srv) == content(pair.ref.srv)
    assert pair.port.breaker.state == "closed"
    assert pair.port.srv.metrics.sink.latest()["CounterTotals"].get(
        "nomad.breaker.oracle_routed", 0) == 0
    assert pair.ref.srv.metrics.sink.latest()["CounterTotals"].get(
        "nomad.breaker.oracle_routed", 0) == 0
    b = pair.port.srv.eval_broker.stats()
    assert b["total_nacks"] == 0 and b["total_failed"] == 0


# -- agent configs -----------------------------------------------------------

CONFIGS = {
    "hcl": '''
region     = "euw"
datacenter = "dc7"
data_dir   = "/tmp/nomad"
ports {
  http = 5646
}
server {
  enabled        = true
  num_schedulers = 4
  start_join     = ["10.0.0.1:4647"]
}
client {
  enabled = true
  servers = ["1.2.3.4:4647"]
  meta {
    rack = "r1"
  }
}
''',
    "json": '{"region": "ap", "ports": {"http": 7777},'
            ' "server": {"enabled": true}}',
    "env": '''
region   = "${NOMAD_TEST_REGION}"
data_dir = "$NOMAD_TEST_DATA/agent"
client {
  enabled = true
  meta {
    placeholder = "${NOT_SET_ANYWHERE_XYZ}"
  }
}
''',
    "json_env": '{"client": {"enabled": true,'
                ' "servers": ["${NOMAD_TEST_SRV}:4647"],'
                ' "meta": {"rack": "$NOMAD_TEST_RACK"}}}',
    "inject": 'datacenter = "${NOMAD_TEST_EVIL}"',
    "sockaddr_bind": 'bind_addr = "{{ GetInterfaceIP \\"lo\\" }}"',
    "plain_bind": 'bind_addr = "0.0.0.0"',
    "sockaddr_blocks": '''
addresses {
  http = "{{ GetInterfaceIP \\"lo\\" }}"
}
advertise {
  rpc  = "{{ GetInterfaceIP \\"lo\\" }}:4647"
  serf = "10.9.8.7:4648"
}
''',
    "sockaddr_json": '{"advertise": {"rpc": "{{ GetInterfaceIP \\"lo\\" }}'
                     ':4647"}, "addresses": {"http": "{{ GetInterfaceIP '
                     '\\"lo\\" }}"}}',
    "bad_template": 'bind_addr = "{{ GetMagicIP }}"',
    "bad_advertise": 'advertise { rpc = "{{ GetMagicIP }}:4647" }',
    "tls": '''
tls {
  rpc                    = true
  ca_file                = "/etc/nomad/ca.pem"
  cert_file              = "/etc/nomad/server.pem"
  key_file               = "/etc/nomad/server-key.pem"
  verify_server_hostname = true
}
''',
    "vault": '''
vault {
  enabled        = true
  address        = "http://vault:8200"
  token          = "t"
  task_token_ttl = "1h"
}
''',
}


def parsed(parse, src):
    try:
        return "ok", dataclasses.asdict(parse(src))
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return type(e).__name__, str(e)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_agent_config_matches_reference(name, monkeypatch):
    monkeypatch.setenv("NOMAD_TEST_REGION", "apse")
    monkeypatch.setenv("NOMAD_TEST_DATA", "/srv/nomad")
    monkeypatch.setenv("NOMAD_TEST_SRV", "10.1.2.3")
    monkeypatch.setenv("NOMAD_TEST_RACK", "r9")
    monkeypatch.setenv("NOMAD_TEST_EVIL",
                       'x" }\nserver { enabled = true }\nregion = "pwned')
    want = parsed(jparse_config, CONFIGS[name])
    got = parsed(parse_config, CONFIGS[name])
    assert got == want
    if name.startswith("bad"):
        assert got[0] == "ValueError"


def test_tls_block_fills_the_server_config(monkeypatch):
    from nomad_tpu_torch.agent import agent as agent_mod
    from nomad_tpu_torch.utils.tlsutil import TLSConfig

    cfg = parse_config(CONFIGS["tls"] + AGENT_HCL.format(data_dir="/x"))
    want = jparse_config(CONFIGS["tls"]).tls.to_tls_config()
    assert dataclasses.asdict(cfg.tls.to_tls_config()) == \
        dataclasses.asdict(want)
    seen = {}

    class Captured(Exception):
        pass

    def fake_server(scfg, logger=None, vault_api=None):
        seen["cfg"] = scfg
        raise Captured()

    monkeypatch.setattr(agent_mod, "Server", fake_server)
    with pytest.raises(Captured):
        Agent(cfg, device="cpu")
    assert seen["cfg"].tls == TLSConfig(
        enabled=True, ca_file="/etc/nomad/ca.pem",
        cert_file="/etc/nomad/server.pem",
        key_file="/etc/nomad/server-key.pem", verify_server_hostname=True)
    assert seen["cfg"].device == "cpu"


def test_advertise_rpc_feeds_server_config(tmp_path):
    cfg = parse_config(AGENT_HCL.format(data_dir=tmp_path))
    cfg.dev_mode = True
    cfg.advertise.rpc = "127.0.0.1"
    a = Agent(cfg, device="cpu",
              server_options={"min_heartbeat_ttl": HEARTBEAT_TTL})
    a.start()
    try:
        assert a.server.config.rpc_advertise.rsplit(":", 1)[0] == \
            "127.0.0.1"
    finally:
        a.shutdown()
    assert wait_until(lambda: not a.threads(), 15.0)


# -- what the port's agent refuses -------------------------------------------

@pytest.fixture
def local_probes(monkeypatch):
    """A port client's fingerprint probes stay on this machine: its
    connections off the loopback are refused, so the cloud metadata
    probes find no answer."""
    import socket

    real = socket.create_connection

    def connect(address, *args, **kwargs):
        if address[0] not in ("127.0.0.1", "localhost"):
            raise OSError("no network in this test")
        return real(address, *args, **kwargs)

    monkeypatch.setattr(socket, "create_connection", connect)


@pytest.mark.parametrize("src,item", [
    ('server { enabled = true }\nclient { enabled = true }', "item 28"),
    ('client { enabled = true }', "item 28"),
    ('server { enabled = true }\nvault { enabled = true }', "item 30"),
    ('server {\n enabled = true\n retry_join_wan = ["10.0.0.1:4648"]\n}',
     "item 30"),
    ('server {\n enabled = true\n enabled_schedulers = ["batch"]\n}',
     "queue 3 item 19"),
])
def test_unported_config_raises_naming_its_roadmap_item(src, item, tmp_path,
                                                       local_probes):
    import socket

    before = {t.name for t in threading.enumerate()}
    if item == "item 30":
        # Vault and the WAN join are ported (they raised naming ROADMAP
        # item 30 before): the agent builds its server with them.  It is
        # not started, so no join dials the listed address.
        from nomad_tpu_torch.server.vault import FakeVault

        cfg = parse_config(src + '\nports {\n http = 0\n rpc = 0\n}')
        cfg.dev_mode = True
        a = Agent(cfg, device="cpu", vault_api=FakeVault(),
                  server_options={"min_heartbeat_ttl": HEARTBEAT_TTL})
        try:
            if "vault" in src:
                assert a.server.vault.enabled
            else:
                assert a.server.config.wan_join == ["10.0.0.1:4648"]
        finally:
            a.shutdown()
        assert wait_until(lambda: not a.threads(), 15.0)
        return
    if item == "item 28":
        # The client is ported: a config that enables it builds an agent
        # with a client (over RPC to the listed servers when it has no
        # server of its own), which starts and shuts down.
        cfg = parse_config(src + f'\nports {{\n http = 0\n rpc = 0\n}}\n'
                                 f'client {{\n alloc_dir = "{tmp_path}"\n}}')
        cfg.dev_mode = True
        a = Agent(cfg, device="cpu",
                  server_options={"min_heartbeat_ttl": HEARTBEAT_TTL})
        assert a.client is not None
        assert (a.server is None) == ("server" not in src)
        a.start()
        a.shutdown()
        assert wait_until(lambda: not a.threads(), 15.0)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        Agent(parse_config(src), device="cpu")
    # Nothing was started or bound.
    assert {t.name for t in threading.enumerate()} <= before | {"MainThread"}
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))


def test_dev_config_enables_the_client_and_raises(local_probes, tmp_path):
    """The dev config enables the client, which the port now has: asked
    for the CPU, the dev agent starts a server and a client in one
    process (it raised ``NotImplementedError`` for ROADMAP item 28 before
    the client was ported)."""
    from nomad_tpu_torch.agent import AgentConfig

    cfg = AgentConfig.dev()
    cfg.ports.http = 0
    cfg.client.alloc_dir = str(tmp_path)
    a = Agent(cfg, device="cpu",
              server_options={"min_heartbeat_ttl": HEARTBEAT_TTL})
    try:
        a.start()
        assert a.server is not None and a.client is not None
        assert a.client.rpc is a.server
        assert wait_until(lambda: a.server.node_get(a.client.node.id)
                          is not None, 15.0)
    finally:
        a.shutdown()
    assert wait_until(lambda: not a.threads(), 15.0)


def test_server_only_agent_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; this checks the CPU-only case")
    cfg = parse_config('server { enabled = true }\nports { http = 0 }')
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Agent(cfg)


def test_shutdown_of_an_agent_never_started(tmp_path):
    cfg = parse_config(AGENT_HCL.format(data_dir=tmp_path))
    cfg.dev_mode = True
    a = Agent(cfg, device="cpu")
    a.shutdown()
    assert not a.threads()


def test_no_server_no_client_raises():
    with pytest.raises(ValueError, match="at least client or server"):
        Agent(parse_config('server { enabled = false }'), device="cpu")


def test_use_tpu_batch_worker_parses_and_changes_nothing(tmp_path):
    srcs = [AGENT_HCL.format(data_dir=tmp_path).replace(
        "use_tpu_batch_worker = true", f"use_tpu_batch_worker = {v}")
        for v in ("true", "false")]
    kinds = []
    for src in srcs:
        cfg = parse_config(src)
        cfg.dev_mode = True
        a = Agent(cfg, device="cpu",
                  server_options={"min_heartbeat_ttl": HEARTBEAT_TTL})
        a.start()
        try:
            kinds.append(sorted({type(w).__name__
                                 for w in a.server.workers}))
        finally:
            a.shutdown()
    assert kinds[0] == kinds[1] == ["BatchWorker"]


def test_shutdown_ends_long_polls_streams_and_joins(tmp_path):
    """An event stream, a monitor and a long poll in flight at shutdown
    end; no thread of the agent is left."""
    cfg = parse_config(AGENT_HCL.format(data_dir=tmp_path))
    cfg.dev_mode = True
    a = Agent(cfg, device="cpu",
              server_options={"min_heartbeat_ttl": HEARTBEAT_TTL,
                              "events": True})
    a.start()
    base = a.http.address
    index = a.server.raft.applied_index() + 1000
    ended = []

    def hold(path):
        with contextlib.suppress(Exception):
            with urllib.request.urlopen(base + path, timeout=60) as resp:
                resp.read()
        ended.append(path)

    paths = ["/v1/event/stream", "/v1/agent/monitor",
             f"/v1/jobs?index={index}&wait=120s"]
    clients = [threading.Thread(target=hold, args=(p,), daemon=True)
               for p in paths]
    for t in clients:
        t.start()
    time.sleep(0.5)
    t0 = time.monotonic()
    a.shutdown()
    assert time.monotonic() - t0 < 15
    assert wait_until(lambda: not a.threads(), 15.0)
    for t in clients:
        t.join(10)
    assert sorted(ended) == sorted(paths)
