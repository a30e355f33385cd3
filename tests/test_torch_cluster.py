"""The twin: a port 3-server cluster against a reference 3-server cluster,
on one script, compared by role after every step.

The reference's three ``Server``\\ s (``use_tpu_batch_worker=True``,
``follower_scheduling=False``, ``NOMAD_TPU_RNG_SEED``, its own
``KernelCircuitBreaker``) and the port's three (``device="cpu"``,
``rng_seed``, ``follower_scheduling=False``) run over loopback TCP with
the reference loadgen harness's loaded-host election timing
(``test_torch_raft.SLOW_RAFT``; the reference reads it from
``NOMAD_TPU_RAFT_*``), at ``tests/test_torch_server.py``'s ``World``
sizes, with seeded ids and a seeded broker tie-break in both.  The
script:

1. the nodes registered through the leader, every fifth through a
   follower (forwarded);
2. wave 1;
3. every worker paused, then wave 2 registered through a follower;
4. the leader shut down (its broker disabled first: a worker released
   from its pause by ``stop()`` dequeues once more on its way out, in
   both packages, and would take wave 2 with it);
5. a new leader elected, its restore re-enqueues wave 2, the workers
   released;
6. a node goes down.

After each step the leader's committed content (``content()`` of
``test_torch_server.py``: allocs, eval statuses, blocked stats, queued
counts) is the reference's, exactly; every live port server's
``fsm_fingerprint()`` is equal at the same index; no nack; the breaker
closed with no trip; ``breaker.oracle_routed`` 0.  Servers are compared
by role (the leader, its followers), never by name: which server wins an
election depends on the process's string hashes.
"""
import random

import jax  # noqa: F401  (the reference computes on the CPU backend)
import pytest

import nomad_tpu.ops.breaker as jbreaker
import nomad_tpu.server.eval_broker as jeval_broker
from nomad_tpu.server import Server as JServer
from nomad_tpu.server import ServerConfig as JServerConfig
from nomad_tpu.state import columnar as jcolumnar
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert
from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server import eval_broker as peval_broker
from nomad_tpu_torch.state import columnar as pcolumnar
from nomad_tpu_torch.structs import structs as ps
from nomad_tpu_torch.utils.backoff import wait_until

from test_torch_raft import ELECTION_TIMEOUT, SLOW_RAFT
from test_torch_server import (HEARTBEAT_TTL, SEED, SETTLE_TIMEOUT, Ids,
                               cluster, content, conv, park_signal, settle,
                               settled)

STEPS = ["nodes", "wave1", "wave2_paused", "leader_down", "restored",
         "node_down"]
FINGERPRINT_TIMEOUT = 30.0


def find_leader(servers):
    for srv in servers:
        if srv.is_leader() and srv.raft.is_raft_leader():
            return srv
    return None


class ClusterWorld:
    """Three servers of either package in this process."""

    def __init__(self, kind, mp):
        self.kind = kind
        self.ref = kind == "ref"
        ids = Ids(SEED)
        structs = js if self.ref else ps
        mp.setattr(structs, "generate_uuid", ids.one)
        mp.setattr(structs, "generate_uuids", ids.many)
        (jcolumnar if self.ref else pcolumnar).reset_counters()
        if self.ref:
            for key, val in {
                    "NOMAD_TPU_RNG_SEED": str(SEED),
                    "NOMAD_TPU_COLUMNAR": "1",
                    "NOMAD_TPU_COLUMNAR_GUARD_EVERY": "1",
                    "NOMAD_TPU_PREEMPTION": "0", "NOMAD_TPU_TRACE": "0",
                    "NOMAD_TPU_EVENTS": "0",
                    "NOMAD_TPU_RAFT_HEARTBEAT_S":
                        str(SLOW_RAFT["raft_heartbeat"]),
                    "NOMAD_TPU_RAFT_ELECTION_MIN_S":
                        str(SLOW_RAFT["raft_election_min"]),
                    "NOMAD_TPU_RAFT_ELECTION_MAX_S":
                        str(SLOW_RAFT["raft_election_max"])}.items():
                mp.setenv(key, val)
            self.breaker = jbreaker.KernelCircuitBreaker()
            mp.setattr(jbreaker, "BREAKER", self.breaker)
            mp.setattr(jeval_broker, "random", random.Random(SEED))
        else:
            mp.setattr(peval_broker, "random", random.Random(SEED))
            self.breaker = KernelCircuitBreaker()
        self.servers = []
        first = None
        for i in range(3):
            join = [first] if first else []
            if self.ref:
                srv = JServer(JServerConfig(
                    node_name=f"ref-{i + 1}", enable_rpc=True,
                    bootstrap_expect=3, start_join=join,
                    use_tpu_batch_worker=True, num_schedulers=1,
                    batch_size=8, min_heartbeat_ttl=HEARTBEAT_TTL,
                    follower_scheduling=False))
            else:
                srv = Server(ServerConfig(
                    device="cpu", rng_seed=SEED, num_schedulers=1,
                    batch_size=8, min_heartbeat_ttl=HEARTBEAT_TTL,
                    breaker=self.breaker, columnar=True,
                    columnar_guard_every=1, node_name=f"port-{i + 1}",
                    enable_rpc=True, bootstrap_expect=3, start_join=join,
                    follower_scheduling=False, **SLOW_RAFT))
            if first is None:
                first = srv.config.rpc_advertise
            self.servers.append(srv)
        self.alive = list(self.servers)

    def start(self):
        for srv in self.servers:
            srv.start()
        self.wait_leader()
        assert wait_until(lambda: all(len(srv.raft.peers) == 3
                                      for srv in self.servers), 30.0)

    def wait_leader(self):
        assert wait_until(lambda: find_leader(self.alive) is not None,
                          ELECTION_TIMEOUT, max_interval=0.05), [
            (srv.raft.state, srv.raft.term) for srv in self.alive]
        return find_leader(self.alive)

    @property
    def leader(self):
        return find_leader(self.alive)

    @property
    def followers(self):
        lead = self.leader
        return [srv for srv in self.alive if srv is not lead]

    def _obj(self, obj, fn):
        return obj if self.ref else conv(obj, fn)

    def node_register(self, node, srv):
        return srv.node_register(self._obj(node, convert.node_from_dict))

    def job_register(self, job, srv):
        return srv.job_register(self._obj(job, convert.job_from_dict))

    def pause(self):
        lead = self.leader
        assert wait_until(lambda: settled(lead), SETTLE_TIMEOUT)
        for srv in self.alive:
            if self.ref:
                parked = [park_signal(w) for w in srv.workers]
                for w in srv.workers:
                    w.set_pause(True)
                assert all(ev.wait(30.0) for ev in parked)
            else:
                assert srv.set_workers_paused(True, timeout=30.0)

    def release(self):
        for srv in self.alive:
            for w in srv.workers:
                w.set_pause(False)

    def counter(self, srv, key):
        return srv.metrics.sink.latest()["CounterTotals"].get(
            f"nomad.{key}", 0)

    def health(self, srv):
        return {"state": self.breaker.state, "trips": self.breaker.trips,
                "oracle_routed": self.counter(srv, "breaker.oracle_routed"),
                "nacks": self.counter(srv, "broker.nack")}

    def fingerprints(self):
        """Every live server's (index, digest), once they agree (or the
        deadline passes)."""
        wait_until(lambda: len({srv.fsm_fingerprint()
                                for srv in self.alive}) == 1,
                   FINGERPRINT_TIMEOUT, max_interval=0.05)
        return [srv.fsm_fingerprint() for srv in self.alive]

    def shutdown(self):
        for srv in self.servers:
            srv.shutdown()
        if not self.ref:
            for srv in self.servers:
                assert wait_until(lambda: not srv.threads(), 15.0), \
                    srv.threads()


def run_script(world, scenario):
    nodes, wave1, wave2, _big, _extra = scenario
    out = {}

    def record(step, srv):
        out[step] = {"content": content(srv), "health": world.health(srv),
                     "fingerprints": world.fingerprints()}

    lead = world.leader
    for i, n in enumerate(nodes):
        via = world.followers[0] if i % 5 == 4 else lead
        world.node_register(n, via)
    record("nodes", lead)
    out["forwards"] = sum(world.counter(srv, "rpc.forward")
                          for srv in world.followers)

    world.pause()
    for j in wave1:
        world.job_register(j, lead)
    world.release()
    settle(lead)
    record("wave1", lead)

    world.pause()
    for j in wave2:
        world.job_register(j, world.followers[0])
    record("wave2_paused", lead)
    out["old_leader_health"] = world.health(lead)

    acked = lead.raft.applied_index()
    world.alive.remove(lead)
    # Its broker first: a stopping worker is released from its pause and
    # would take wave 2 on its way out (in both packages).
    lead.eval_broker.set_enabled(False)
    lead.shutdown()
    new = world.wait_leader()
    out["new_leader_applied"] = new.raft.applied_index()
    out["acked"] = acked
    record("leader_down", new)

    # The restore re-enqueued wave 2 (the workers are still paused).
    assert wait_until(lambda: new.eval_broker.stats()["total_ready"]
                      == len(wave2), SETTLE_TIMEOUT)
    world.release()
    settle(new)
    record("restored", new)

    host = sorted({a.node_id for a in new.state.allocs(None)
                   if a.job_id == wave1[0].id})[0]
    world.pause()
    new.node_update_status(host, js.NODE_STATUS_DOWN)
    world.release()
    settle(new)
    record("node_down", new)
    return out


@pytest.fixture(scope="module")
def twin_runs():
    scenario = cluster()
    runs = {}
    for kind in ("ref", "port"):
        with pytest.MonkeyPatch.context() as mp:
            world = ClusterWorld(kind, mp)
            try:
                world.start()
                runs[kind] = run_script(world, scenario)
            finally:
                world.shutdown()
    return runs


@pytest.mark.parametrize("step", STEPS)
def test_step_commits_what_the_reference_commits(twin_runs, step):
    ref, port = twin_runs["ref"][step], twin_runs["port"][step]
    assert port["content"]["allocs"] == ref["content"]["allocs"]
    assert port["content"]["evals"] == ref["content"]["evals"]
    assert port["content"]["blocked"] == ref["content"]["blocked"]
    assert port["content"]["queued"] == ref["content"]["queued"]


@pytest.mark.parametrize("step", STEPS)
def test_every_live_server_has_one_fingerprint(twin_runs, step):
    fps = twin_runs["port"][step]["fingerprints"]
    assert len(fps) == (3 if step in STEPS[:3] else 2)
    assert len(set(fps)) == 1, fps


@pytest.mark.parametrize("step", STEPS)
def test_no_nack_and_no_oracle_route(twin_runs, step):
    for kind in ("ref", "port"):
        assert twin_runs[kind][step]["health"] == {
            "state": "closed", "trips": 0, "oracle_routed": 0,
            "nacks": 0}, kind


def test_failover_keeps_every_acknowledged_entry(twin_runs):
    port = twin_runs["port"]
    assert port["new_leader_applied"] >= port["acked"]
    assert port["old_leader_health"]["nacks"] == 0
    # Every fifth node went through a follower: forwarded to the leader.
    assert port["forwards"] == len(cluster()[0]) // 5


def test_the_script_placed_and_replaced(twin_runs):
    port = twin_runs["port"]
    nodes, wave1, wave2, _, _ = cluster()
    allocs = port["restored"]["content"]["allocs"]
    for j in wave1 + wave2:
        placed = [a for a in allocs if a[0] == j.id and a[3] == "run"]
        assert len(placed) == j.task_groups[0].count, j.id
    pending = [e for e in port["wave2_paused"]["content"]["evals"]
               if e[2] == ps.EVAL_STATUS_PENDING]
    assert sorted(e[0] for e in pending) == sorted(j.id for j in wave2)
    lost = [a for a in port["node_down"]["content"]["allocs"]
            if a[4] == ps.ALLOC_CLIENT_STATUS_LOST]
    assert lost
    assert {e[2] for e in port["node_down"]["content"]["evals"]} == {
        ps.EVAL_STATUS_COMPLETE}
