"""The port's cluster chaos (the net plane of ``nomad_tpu_torch/fault.py``,
``ConnPool``'s net hook and dial gate, partitions of a three-server
cluster, a leader killed with plans in flight, a torn WAL segment, the
load harness's chaos scheduler and the chaos drill) against the JAX
package's, case for case with ``tests/test_chaos_cluster.py``.

Each case runs the same seeded scenario in both packages and compares
what it observes: which traffic a partition or a seeded rule blocks and
its trace, the flap schedule, the dial gate, a partitioned follower's
catch-up by a chunked InstallSnapshot and the converged fingerprints, no
job over its count after a failover, the exact durable prefix a torn
segment leaves, and the ``chaos_smoke`` scenario through each package's
harness (one split and heal, one real follower SIGKILL and restart, the
continuous auditor): 0 violations, every event recovered or censored,
no straggler.  The port's servers run on the CPU, its harness's batch
workers too; the reference's load harness runs its own workers.

The struct codec is the port's only wire format (ROADMAP queue 3 item
16(a)): the twins of the msgpack residue counter hold that no frame of
the port rides anything else, and that a frame outside the codec is
refused, where the reference counts its legacy frames per method.
Every case disarms both planes; every wait has a deadline.
"""
import dataclasses
import os
import socket
import struct
import time

import jax  # noqa: F401  (the reference computes on the CPU backend)
import pytest

import nomad_tpu.ops.breaker as jbreaker
from nomad_tpu import fault as jfault
from nomad_tpu import mock as jmock
from nomad_tpu.server import Server as JServer
from nomad_tpu.server import ServerConfig as JServerConfig
from nomad_tpu.server import rpc as jrpc
from nomad_tpu.server.fsm import FSM as JFSM
from nomad_tpu.server.fsm import MessageType as JMT
from nomad_tpu.server.raft import FileLog as JFileLog
from nomad_tpu.server.raft import MultiRaft as JMultiRaft
from nomad_tpu_torch import convert, fault
from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server import rpc as prpc
from nomad_tpu_torch.server.fsm import FSM as PFSM
from nomad_tpu_torch.server.fsm import MessageType as PMT
from nomad_tpu_torch.server.raft import FileLog as PFileLog
from nomad_tpu_torch.server.raft import MultiRaft as PMultiRaft
from nomad_tpu_torch.utils.backoff import wait_until

DEADLINE = 30.0
KINDS = ("ref", "port")


@pytest.fixture(autouse=True)
def _always_disarm():
    yield
    for m in (fault, jfault):
        m.disarm()
        m.net_disarm()


def fmod(kind):
    return jfault if kind == "ref" else fault


def rmod(kind):
    return jrpc if kind == "ref" else prpc


def make_node(kind):
    n = jmock.node()
    n.resources.networks = []
    n.reserved.networks = []
    return n if kind == "ref" else convert.node_from_dict(
        dataclasses.asdict(n))


def make_job(kind, count=2):
    j = jmock.job()
    j.task_groups[0].count = count
    for t in j.task_groups[0].tasks:
        t.resources.networks = []
    return j if kind == "ref" else convert.job_from_dict(
        dataclasses.asdict(j))


# -- the net plane (TestNetPlane) ---------------------------------------------

def partition_and_heal(m):
    plane = m.net_partition("p", [["a:1"], ["b:2", "c:3"]])
    out = [plane.blocked("a:1", "b:2"), plane.blocked("c:3", "a:1"),
           plane.blocked("b:2", "c:3"), plane.blocked("a:1", "d:4")]
    m.net_heal("p")
    out.append(plane.blocked("a:1", "b:2"))
    m.net_disarm()
    return out, plane.trace()


def test_partition_blocks_both_directions_and_heals():
    port = partition_and_heal(fault)
    assert port == partition_and_heal(jfault)
    assert port[0] == [True, True, False, False, False]
    assert ("net.partition", "p", "split") in port[1]
    assert ("net.partition", "p", "heal") in port[1]


def wildcard(m):
    plane = m.net_partition("iso", [["*"], ["b:2"]])
    out = [plane.blocked("", "b:2"), plane.blocked("b:2", "a:1"),
           plane.blocked("a:1", "c:3")]
    m.net_heal()
    m.net_disarm()
    return out


def test_wildcard_group_isolates_most_specific():
    assert wildcard(fault) == wildcard(jfault) == [True, True, False]


def asymmetric(m, seed):
    plane = m.net_arm({"seed": seed, "rules": [
        {"src": "a:1", "dst": "b:2", "action": "drop", "prob": 0.5}]})
    fires = []
    for _ in range(64):
        fires.append(plane.check("send", "a:1", "b:2") is not None)
        assert plane.check("send", "b:2", "a:1") is None
    m.net_disarm()
    return fires


def test_asymmetric_rule_seeded_determinism():
    port = [asymmetric(fault, s) for s in (5, 5, 6)]
    assert port == [asymmetric(jfault, s) for s in (5, 5, 6)]
    assert port[0] == port[1] != port[2] and 0 < sum(port[0]) < 64


def flaps(m):
    w = m.flap_windows(9, count=3, period=1.0, duty=0.5)
    out = [w, w == m.flap_windows(9, count=3, period=1.0, duty=0.5),
           w != m.flap_windows(10, count=3, period=1.0, duty=0.5),
           all(b > a for a, b in w)]
    plane = m.net_arm()
    plane.partition("flap", [["a:1"], ["b:2"]], windows=[(10.0, 11.0)])
    out.append(plane.blocked("a:1", "b:2"))
    plane._anchor -= 10.5
    out.append(plane.blocked("a:1", "b:2"))
    plane._anchor -= 5.0
    out.append(plane.blocked("a:1", "b:2"))
    m.net_disarm()
    return out


def test_flap_windows_deterministic_and_scheduled():
    port = flaps(fault)
    assert port == flaps(jfault)
    assert port[1:] == [True, True, True, False, True, False]


def reorder(m):
    plane = m.net_arm({"seed": 1, "rules": [
        {"action": "reorder", "max_delay": 0.5}]})
    act = plane.check("send", "x", "y")
    m.net_disarm()
    return act


def test_reorder_is_bounded_delay():
    port = reorder(fault)
    assert port == reorder(jfault)
    assert port[0] == "reorder" and 0.0 <= port[1] <= 0.5


def test_partition_blocks_a_pools_dial_and_send():
    """The net hook (rpc.py:546): a pool stamped with its owner's address
    fails a call across a partition with a ``DialError`` before any
    socket is touched, in both packages; an exempt pool passes."""
    def run(kind):
        m, r = fmod(kind), rmod(kind)
        srv = r.RPCServer()
        srv.register("Echo", lambda body: body)
        srv.start()
        pool, exempt = r.ConnPool(timeout=2.0), r.ConnPool(timeout=2.0)
        pool.local_addr = "me:1"
        exempt.local_addr = "me:1"
        exempt.chaos_exempt = True
        try:
            m.net_partition("cut", [["me:1"], [srv.address]])
            try:
                pool.call(srv.address, "Echo", {"x": 1})
                blocked = None
            except r.DialError as e:
                blocked = "partitioned" in str(e)
            passed = exempt.call(srv.address, "Echo", {"x": 2})
            m.net_heal("cut")
            return blocked, passed, pool.call(srv.address, "Echo", {"x": 3})
        finally:
            m.net_disarm()
            pool.close()
            exempt.close()
            srv.shutdown()

    assert run("port") == run("ref") == (True, {"x": 2}, {"x": 3})


# -- the dial gate (TestDialBackoff) ------------------------------------------

def dead_peer(kind):
    r = rmod(kind)
    pool = r.ConnPool(timeout=0.5)
    dead = "127.0.0.1:1"
    out = []
    try:
        for _ in range(2):
            try:
                pool.call(dead, "Status.Ping", {})
            except r.DialError as e:
                out.append("dial backoff" in str(e))
        gate = pool._dial_gate[dead]
        time.sleep(max(0.0, gate[1] - time.monotonic()) + 0.01)
        try:
            pool.call(dead, "Status.Ping", {})
        except r.DialError as e:
            out.append("dial backoff" in str(e))
        return out
    finally:
        pool.close()


def test_dead_peer_dials_gate_instead_of_hammering():
    assert dead_peer("port") == dead_peer("ref") == [False, True, False]


def gate_clears(kind, monkeypatch):
    if kind == "ref":
        from nomad_tpu.utils.backoff import Backoff

        monkeypatch.setattr(jbreaker, "BREAKER",
                            jbreaker.KernelCircuitBreaker())
        srv = JServer(JServerConfig(enable_rpc=True, num_schedulers=0))
    else:
        from nomad_tpu_torch.utils.backoff import Backoff

        srv = Server(ServerConfig(device="cpu", enable_rpc=True,
                                  num_schedulers=0))
    srv.start()
    pool = rmod(kind).ConnPool(timeout=2.0)
    try:
        addr = srv.config.rpc_advertise
        pool._dial_gate[addr] = [Backoff(), 0.0]
        reply = pool.call(addr, "Status.Ping", {})
        return reply, addr in pool._dial_gate
    finally:
        pool.close()
        srv.shutdown()


def test_gate_clears_on_success(monkeypatch):
    assert gate_clears("port", monkeypatch) == gate_clears(
        "ref", monkeypatch) == ({"ok": True}, False)


def restarted_peer(kind, drop_stale=False):
    """A pooled connection whose server went away and came back on the
    same port: a plain call sends on the dead socket and fails (a
    ``TransportError``) in both packages; the port's caller that first
    drops the idle connections whose peer closed them
    (``ConnPool.drop_stale``, what its region forward does; ROADMAP
    queue 3 item 26(b)) dials the new server instead."""
    r = rmod(kind)
    srv = r.RPCServer()
    srv.register("Echo", lambda body: body)
    srv.start()
    port = int(srv.address.rsplit(":", 1)[1])
    pool = r.ConnPool(timeout=2.0)
    try:
        first = pool.call(srv.address, "Echo", {"x": 1})
        srv.shutdown()
        srv = r.RPCServer(port=port)
        srv.register("Echo", lambda body: body)
        srv.start()
        if drop_stale:
            assert pool.drop_stale(srv.address) == 1
        try:
            second = pool.call(srv.address, "Echo", {"x": 2})
        except r.TransportError:
            second = "TransportError"
        return first, second, pool.call(srv.address, "Echo", {"x": 3})
    finally:
        pool.close()
        srv.shutdown()


def test_idle_connection_to_a_restarted_peer():
    assert restarted_peer("ref") == ({"x": 1}, "TransportError", {"x": 3})
    assert restarted_peer("port") == restarted_peer("ref")
    assert restarted_peer("port", drop_stale=True) == (
        {"x": 1}, {"x": 2}, {"x": 3})


# -- one wire format (TestMsgpackMethodCounter) -------------------------------

def test_hot_methods_never_ride_msgpack_between_codec_peers(monkeypatch):
    """The reference's hot methods stay off its msgpack fallback between
    codec peers; the port has no other format: every frame of the same
    calls is a struct-codec frame, counted by the codec."""
    from nomad_tpu import codec as jcodec
    from nomad_tpu.api.codec import to_wire
    from nomad_tpu_torch import codec as pcodec

    monkeypatch.setattr(jbreaker, "BREAKER", jbreaker.KernelCircuitBreaker())
    jsrv = JServer(JServerConfig(enable_rpc=True, num_schedulers=0))
    psrv = Server(ServerConfig(device="cpu", enable_rpc=True,
                               num_schedulers=0))
    jsrv.start()
    psrv.start()
    jpool, ppool = jrpc.ConnPool(), prpc.ConnPool()
    try:
        before = jcodec.msgpack_methods()
        a = jsrv.config.rpc_advertise
        jpool.call(a, "Node.Register", {"Node": to_wire(make_node("ref"))})
        jpool.call(a, "Job.Register", {"Job": to_wire(make_job("ref", 1))})
        jpool.call(a, "Status.Ping", {})
        delta = {m: n - before.get(m, 0)
                 for m, n in jcodec.msgpack_methods().items()
                 if n - before.get(m, 0) > 0}
        assert {m: n for m, n in delta.items()
                if m.startswith(jcodec.HOT_METHOD_PREFIXES)} == {}
        pbefore = pcodec.stats()
        b = psrv.config.rpc_advertise
        ppool.call(b, "Node.Register", {"Node": make_node("port")})
        ppool.call(b, "Job.Register", {"Job": make_job("port", 1)})
        assert ppool.call(b, "Status.Ping", {}) == {"ok": True}
        rpc = pcodec.stats_delta(pbefore)["rpc"]
        assert rpc["encodes"] >= 6 and rpc["decodes"] >= 6
        assert not hasattr(pcodec, "msgpack_methods")
    finally:
        jpool.close()
        ppool.close()
        jsrv.shutdown()
        psrv.shutdown()


def test_legacy_peer_frames_are_counted_per_method(monkeypatch):
    """A legacy (msgpack) peer: the reference counts its frames per
    method; the port refuses a frame outside the struct codec (no legacy
    channel) and keeps serving codec peers."""
    from nomad_tpu import codec as jcodec

    monkeypatch.setattr(jbreaker, "BREAKER", jbreaker.KernelCircuitBreaker())
    jsrv = JServer(JServerConfig(enable_rpc=True, num_schedulers=0))
    psrv = Server(ServerConfig(device="cpu", enable_rpc=True,
                               num_schedulers=0))
    jsrv.start()
    psrv.start()
    jpool, ppool = jrpc.ConnPool(), prpc.ConnPool()
    try:
        a = jsrv.config.rpc_advertise
        jpool._legacy_addrs.add(a)
        before = jcodec.msgpack_methods().get("Status.Ping", 0)
        jpool.call(a, "Status.Ping", {})
        jpool.call(a, "Status.Ping", {})
        assert jcodec.msgpack_methods().get("Status.Ping", 0) - before == 2
        host, port = psrv.config.rpc_advertise.rsplit(":", 1)
        with socket.create_connection((host, int(port)), timeout=5.0) as sk:
            sk.sendall(bytes([prpc.RPC_NOMAD]))
            junk = b"\x93\x01\xa4Ping\x80"  # a msgpack array, not a frame
            sk.sendall(struct.pack("<I", len(junk)) + junk)
            sk.settimeout(5.0)
            try:
                got = sk.recv(64)
            except OSError:
                got = b""
        assert got == b""  # refused: the connection closed, no reply
        assert ppool.call(psrv.config.rpc_advertise, "Status.Ping",
                          {}) == {"ok": True}
    finally:
        jpool.close()
        ppool.close()
        jsrv.shutdown()
        psrv.shutdown()


# -- a three-server cluster ----------------------------------------------------

def make_cluster(kind, tmp_path, monkeypatch, n=3, num_schedulers=0,
                 raft=None):
    raft = dict(raft or {})
    servers, first = [], None
    if kind == "ref":
        monkeypatch.setattr(jbreaker, "BREAKER",
                            jbreaker.KernelCircuitBreaker())
        env = {"raft_election_min": "NOMAD_TPU_RAFT_ELECTION_MIN_S",
               "raft_election_max": "NOMAD_TPU_RAFT_ELECTION_MAX_S",
               "snapshot_chunk": "NOMAD_TPU_SNAPSHOT_CHUNK"}
        for k, v in raft.items():
            monkeypatch.setenv(env[k], str(v))
    for i in range(n):
        common = dict(node_name=f"chaos-{i + 1}",
                      data_dir=str(tmp_path / kind / f"s{i + 1}"),
                      enable_rpc=True, bootstrap_expect=n,
                      start_join=[first] if first else [],
                      num_schedulers=num_schedulers, min_heartbeat_ttl=60.0)
        if kind == "ref":
            srv = JServer(JServerConfig(use_tpu_batch_worker=True, **common))
        else:
            srv = Server(ServerConfig(device="cpu", rng_seed=7,
                                      breaker=KernelCircuitBreaker(),
                                      **common, **raft))
        first = first or srv.config.rpc_advertise
        servers.append(srv)
    for srv in servers:
        srv.start()
    return servers


def wait_for_leader(servers, timeout=DEADLINE):
    assert wait_until(lambda: any(x.is_leader() and x.raft.is_raft_leader()
                                  for x in servers), timeout)
    return next(x for x in servers
                if x.is_leader() and x.raft.is_raft_leader())


def chunks_sent(srv):
    return int(srv.metrics.sink.latest()["CounterTotals"].get(
        "nomad.raft.snapshot.chunks_sent", 0))


def partition_heal(kind, tmp_path, monkeypatch):
    m = fmod(kind)
    servers = make_cluster(kind, tmp_path, monkeypatch, raft={
        "raft_election_min": 8.0, "raft_election_max": 12.0,
        "snapshot_chunk": 512})
    try:
        leader = wait_for_leader(servers)
        victim = next(x for x in servers if x is not leader)
        assert wait_until(lambda: all(len(x.raft.peers) == 3
                                      for x in servers), DEADLINE)
        job0 = make_job(kind, 1)
        leader.job_register(job0)
        assert wait_until(lambda: victim.state.job_by_id(None, job0.id)
                          is not None, DEADLINE)
        m.net_partition("split", [[leader.config.rpc_advertise],
                                  [victim.config.rpc_advertise]])
        jobs = [make_job(kind, 1) for _ in range(5)]
        for job in jobs:
            leader.job_register(job)
        time.sleep(0.3)
        out = [all(victim.state.job_by_id(None, j.id) is None for j in jobs)]
        leader.raft.snapshot()
        out.append(isinstance(leader.raft, (JMultiRaft, PMultiRaft))
                   and leader.raft.base_index > 0)
        before = chunks_sent(leader)
        m.net_heal("split")
        out.append(wait_until(lambda: all(
            victim.state.job_by_id(None, j.id) is not None for j in jobs),
            DEADLINE))
        out.append(wait_until(lambda: victim.raft.base_index
                              >= leader.raft.base_index, 10.0))
        out.append(chunks_sent(leader) - before >= 2)
        m.net_partition("split2", [[leader.config.rpc_advertise],
                                   [victim.config.rpc_advertise]])
        job_z = make_job(kind, 1)
        leader.job_register(job_z)
        time.sleep(0.2)
        out.append(victim.state.job_by_id(None, job_z.id) is None)
        m.net_heal("split2")
        out.append(wait_until(lambda: victim.state.job_by_id(
            None, job_z.id) is not None, DEADLINE))
        out.append(wait_until(lambda: leader.fsm_fingerprint()
                              == victim.fsm_fingerprint(), 10.0))
        return out
    finally:
        m.net_disarm()
        for srv in servers:
            srv.shutdown()


def test_partitioned_follower_catches_up_via_chunked_install(tmp_path,
                                                            monkeypatch):
    port = partition_heal("port", tmp_path, monkeypatch)
    assert port == partition_heal("ref", tmp_path, monkeypatch)
    assert port == [True] * 8


def leader_kill(kind, tmp_path, monkeypatch):
    m = fmod(kind)
    servers = make_cluster(kind, tmp_path, monkeypatch, num_schedulers=1)
    try:
        leader = wait_for_leader(servers)
        for srv in servers:
            srv.eval_broker.initial_nack_delay = 0.1
        for _ in range(4):
            leader.node_register(make_node(kind))
        m.arm({"seed": 3, "faults": [
            {"point": "raft.apply", "action": "delay", "delay": 0.25,
             "match": {"msg_type": "APPLY_PLAN_RESULTS"}}]})
        jobs = [make_job(kind, 2) for _ in range(4)]
        for job in jobs:
            leader.job_register(job)
        time.sleep(0.3)
        leader.shutdown()
        m.disarm()
        survivors = [x for x in servers if x is not leader]
        new_leader = wait_for_leader(survivors, timeout=45.0)

        def live(srv, job):
            return [a for a in srv.state.allocs_by_job(None, job.id, True)
                    if not a.terminal_status()]

        settled = wait_until(lambda: all(len(live(new_leader, j)) == 2
                                         for j in jobs), 90.0)
        ok = all(len(live(srv, j)) <= 2
                 and len({a.name for a in live(srv, j)}) == len(live(srv, j))
                 for srv in survivors for j in jobs)
        routed = sum(srv.metrics.sink.latest()["CounterTotals"].get(
            "nomad.breaker.oracle_routed", 0) for srv in servers)
        return settled, ok, routed
    finally:
        m.disarm()
        for srv in servers:
            srv.shutdown()


def test_leader_death_with_inflight_plans_no_double_placement(tmp_path,
                                                              monkeypatch):
    assert leader_kill("port", tmp_path, monkeypatch) == leader_kill(
        "ref", tmp_path, monkeypatch) == (True, True, 0)


# -- a torn WAL segment (TestTornWalsegRecovery) -------------------------------

def torn_segment(kind, d, monkeypatch):
    fsm_cls, log_cls, mt = ((JFSM, JFileLog, JMT) if kind == "ref"
                            else (PFSM, PFileLog, PMT))
    log = log_cls(fsm_cls(), d, snapshot_entries=0, snapshot_bytes=0)
    nodes = [make_node(kind) for _ in range(4)]
    for n in nodes:
        log.apply(mt.NODE_REGISTER, {"node": n})

    def boom(snap_store, index):
        raise OSError("injected crash before snapshot blob")

    with monkeypatch.context() as mp:
        mp.setattr(log, "_persist_snapshot_blob", boom)
        with pytest.raises(OSError):
            log.snapshot()
    log.close()
    segs = [os.path.join(d, f) for f in os.listdir(d)
            if f.startswith("walseg-")]
    assert segs
    with open(segs[0], "r+b") as fh:
        fh.truncate(os.path.getsize(segs[0]) - 7)
    log2 = log_cls(fsm_cls(), d, snapshot_entries=0, snapshot_bytes=0)
    try:
        out = [len(segs), log2.applied_index(),
               [log2.fsm.state.node_by_id(None, n.id) is not None
                for n in nodes]]
        extra = make_node(kind)
        out.append(log2.apply(mt.NODE_REGISTER, {"node": extra})[1])
    finally:
        log2.close()
    log3 = log_cls(fsm_cls(), d, snapshot_entries=0, snapshot_bytes=0)
    try:
        out += [log3.applied_index(),
                log3.fsm.state.node_by_id(None, extra.id) is not None]
    finally:
        log3.close()
    return out


def test_torn_sealed_segment_recovers_durable_prefix_exactly(tmp_path,
                                                            monkeypatch):
    port = torn_segment("port", str(tmp_path / "port"), monkeypatch)
    assert port == torn_segment("ref", str(tmp_path / "ref"), monkeypatch)
    assert port == [1, 3, [True, True, True, False], 4, 4, True]


# -- the chaos_soak smoke tier (TestChaosSoakSmoke) -----------------------------

SOAK_CODE = """
import json, sys
sys.path.insert(0, {root!r})
if {ref!r}:
    import nomad_tpu.ops.breaker as jbreaker
    from nomad_tpu.loadgen.harness import run_scenario
    from nomad_tpu.loadgen.scenario import get_scenario
    jbreaker.BREAKER = jbreaker.KernelCircuitBreaker()
    rep = run_scenario(get_scenario("chaos_smoke"))
else:
    from nomad_tpu_torch.loadgen.harness import run_scenario
    from nomad_tpu_torch.loadgen.scenario import get_scenario
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    rep = run_scenario(get_scenario("chaos_smoke"), device="cpu",
                       server_options={{"rng_seed": 7,
                                        "breaker": KernelCircuitBreaker()}})
aud = rep.get("auditor") or {{}}
chaos = rep.get("chaos") or {{}}
events = chaos.get("events") or []
kill = next((ev for ev in events if ev["kind"] == "kill"), {{}})
integ = rep["integrity"]
print(json.dumps({{
    "violations": aud.get("violation_count"),
    "fingerprint_matched": (aud.get("checks") or {{}}).get(
        "fingerprint_matches", 0) >= 1,
    "events": sorted(ev["kind"] for ev in events),
    "errors": [ev["error"] for ev in events if ev.get("error")],
    "restarted": kill.get("restarted_after_s") is not None,
    "unrecovered": chaos.get("unrecovered"),
    "integrity": [integ["overplaced_jobs"], integ["duplicate_alloc_names"],
                  integ["overcommitted_nodes"]],
    "stragglers": rep["sustained"]["stragglers_after_drain"]}}))
"""
# Each package's scenario takes about 80 s (60 of them the nack timeout of
# the evals the killed follower held); a run that outlives this fails the
# test instead of holding the suite.
SOAK_TIMEOUT = 400.0


def soak_both():
    """``chaos_smoke`` through each package's load harness, each in a
    process of its own (its follower children, data dirs and net plane
    with it), the two side by side: most of each run waits on the
    nack timeout."""
    import json
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = {kind: subprocess.Popen(
        [sys.executable, "-c", SOAK_CODE.format(root=root,
                                                ref=kind == "ref")],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for kind in KINDS}
    out = {}
    try:
        for kind, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=SOAK_TIMEOUT)
            assert proc.returncode == 0, (kind, stderr[-4000:])
            out[kind] = json.loads(stdout.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


def test_smoke_soak_fixed_seed_zero_violations():
    """The ``chaos_smoke`` scenario (one split and heal, one real follower
    SIGKILL and restart from its raft store) through each package's load
    harness: 0 violations, both events, the kill restarted, none
    unrecovered, no double placement, no straggler."""
    both = soak_both()
    port = both["port"]
    assert port == both["ref"]
    assert port == {"violations": 0, "fingerprint_matched": True,
                    "events": ["kill", "partition"], "errors": [],
                    "restarted": True, "unrecovered": 0,
                    "integrity": [0, 0, 0], "stragglers": 0}


# -- the chaos drill (nomad_tpu/ops/__main__.py:1328) --------------------------

def test_chaos_drill_passes_like_the_reference():
    from nomad_tpu.ops import __main__ as jdrills
    from nomad_tpu_torch.ops import __main__ as pdrills

    ref_lines, port_lines = [], []
    assert jdrills.chaos_drill(seed=0, log=ref_lines.append), ref_lines
    assert pdrills.chaos_drill(seed=0, device="cpu",
                               log=port_lines.append), port_lines
    assert any("chaos drill: OK" in ln for ln in port_lines)
    assert [ln.split(" — ")[0] for ln in port_lines] == \
        [ln.split(" — ")[0] for ln in ref_lines]
