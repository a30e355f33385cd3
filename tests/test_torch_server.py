"""The port's in-process Server against the reference Server.

The port's ``Server(ServerConfig(device="cpu", rng_seed=S,
num_schedulers=1, batch_size=8))`` and the reference's
``Server(ServerConfig(use_tpu_batch_worker=True, num_schedulers=1,
batch_size=8))`` under ``NOMAD_TPU_RNG_SEED=S`` take the same calls on
one cluster (the reference's mock objects, converted for the port): a
register stream in two waves, capacity exhaustion then the node that
unblocks it, two nodes going down, a job deregistered, a node
deregistered, a system job on every node, and, on a second pair of
servers with preemption on, a
preempting drill whose victims' follow-up eval reaches ``BlockedEvals``
through ``block_preempted`` and is placed when capacity is added.

Each wave (and each node registration or status change that enqueues
evals) is made with the workers paused and then released, so the broker
forms the same batches in both.  Where evals of equal priority tie
across the service and batch queues, each broker draws from a
``random.Random`` seeded alike, and each world draws its ids from a
seeded sequence of its own, so the reconciler's walks over id-keyed
sets agree.  After each phase the two worlds are compared by content,
not ids: every alloc's (job, name, node, desired status, client status),
every eval's (job, trigger, status), the blocked-eval stats and the
queued counts of the job summaries.

Both run their state store's columnar mirror with every guard at every
read (the reference's ``NOMAD_TPU_COLUMNAR=1`` and
``NOMAD_TPU_COLUMNAR_GUARD_EVERY=1``; the port's ``ServerConfig(
columnar=True, columnar_guard_every=1)``): each static encode and usage
read is checked against the walk, and each plan the port's applier
re-checks on its columnar route is checked against the walk's verdicts.

Heartbeats: both servers grant a node TTL of an hour, longer than any
run here, so no node expires mid-run and the only node-down is the
deliberate one.  The reference gets its own breaker; in both the
breaker stays closed with no trip, no eval is nacked, and the
``breaker.oracle_routed`` counter stays at 0.  Every server is shut down
in its fixture's teardown, with bounded joins.
"""
import contextlib
import dataclasses
import random
import re
import threading
import time
import types

import jax  # noqa: F401  (the reference computes on the CPU backend)
import pytest

import nomad_tpu.ops.batch_sched as jbatch_sched
import nomad_tpu.ops.breaker as jbreaker
import nomad_tpu.server.eval_broker as jeval_broker
import nomad_tpu.server.periodic as jperiodic
from nomad_tpu import mock as jmock
from nomad_tpu.server import Server as JServer
from nomad_tpu.server import ServerConfig as JServerConfig
from nomad_tpu.state import columnar as jcolumnar
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert, device
from nomad_tpu_torch.ops import batch_sched as pbatch_sched
from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server import eval_broker as peval_broker
from nomad_tpu_torch.server import periodic as pperiodic
from nomad_tpu_torch.state import columnar as pcolumnar
from nomad_tpu_torch.structs import structs as ps
from nomad_tpu_torch.utils.backoff import wait_until

SEED = 11
# Longer than any run here, in both servers alike.
HEARTBEAT_TTL = 3600.0
SETTLE_TIMEOUT = 120.0
JOIN_TIMEOUT = 15.0


def conv(obj, fn):
    return fn(dataclasses.asdict(obj))


def strip_node(n, node_id=None, cpu=None, mem=None):
    if node_id is not None:
        n.id = n.name = node_id
    n.resources.networks = []
    n.reserved.networks = []
    if cpu is not None:
        n.resources.cpu = cpu
    if mem is not None:
        n.resources.memory_mb = mem
    n.compute_class()
    return n


def make_job(job_id, count, cpu, mem, priority=50, type_="service"):
    j = jmock.job()
    j.id = j.name = job_id
    j.priority = priority
    j.type = type_
    j.task_groups[0].count = count
    for t in j.task_groups[0].tasks:
        t.resources.networks = []
        t.resources.cpu = cpu
        t.resources.memory_mb = mem
    return j


def system_job(job_id="system", cpu=50, mem=32):
    j = jmock.system_job()
    j.id = j.name = job_id
    for t in j.task_groups[0].tasks:
        t.resources.networks = []
        t.resources.cpu = cpu
        t.resources.memory_mb = mem
    return j


class Ids:
    """A deterministic uuid sequence (one per world)."""

    def __init__(self, seed):
        self.rng = random.Random(seed)
        self.lock = threading.Lock()

    def one(self):
        with self.lock:
            h = f"{self.rng.getrandbits(128):032x}"
        return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"

    def many(self, n):
        return [self.one() for _ in range(n)]


class World:
    """One server of either package, driven with the reference's objects
    (converted for the port)."""

    def __init__(self, kind, mp, preemption=False, batch_size=8,
                 trace=False, events=False):
        self.kind = kind
        self.ref = kind == "ref"
        ids = Ids(SEED)
        structs = js if self.ref else ps
        mp.setattr(structs, "generate_uuid", ids.one)
        mp.setattr(structs, "generate_uuids", ids.many)
        self.columnar = jcolumnar if self.ref else pcolumnar
        self.columnar.reset_counters()
        if self.ref:
            mp.setenv("NOMAD_TPU_RNG_SEED", str(SEED))
            mp.setenv("NOMAD_TPU_COLUMNAR", "1")
            mp.setenv("NOMAD_TPU_COLUMNAR_GUARD_EVERY", "1")
            mp.setenv("NOMAD_TPU_PREEMPTION", "1" if preemption else "0")
            # The reference arms its planes at construction from these.
            mp.setenv("NOMAD_TPU_TRACE", "1" if trace else "0")
            mp.setenv("NOMAD_TPU_EVENTS", "1" if events else "0")
            self.breaker = jbreaker.KernelCircuitBreaker()
            # The reference's scheduler reads the process-wide breaker
            # at construction (nomad_tpu/ops/batch_sched.py:346).
            mp.setattr(jbreaker, "BREAKER", self.breaker)
            mp.setattr(jeval_broker, "random", random.Random(SEED))
            self.srv = JServer(JServerConfig(
                use_tpu_batch_worker=True, num_schedulers=1,
                batch_size=batch_size, min_heartbeat_ttl=HEARTBEAT_TTL))
        else:
            mp.setattr(peval_broker, "random", random.Random(SEED))
            self.breaker = KernelCircuitBreaker()
            self.srv = Server(ServerConfig(
                device="cpu", rng_seed=SEED, num_schedulers=1,
                batch_size=batch_size, min_heartbeat_ttl=HEARTBEAT_TTL,
                preemption_enabled=preemption, breaker=self.breaker,
                columnar=True, columnar_guard_every=1, trace=trace,
                events=events))

    def _obj(self, obj, fn):
        return obj if self.ref else conv(obj, fn)

    def node_register(self, node):
        return self.srv.node_register(self._obj(node,
                                                convert.node_from_dict))

    def job_register(self, job):
        return self.srv.job_register(self._obj(job, convert.job_from_dict))

    def pause(self):
        assert wait_until(lambda: settled(self.srv), SETTLE_TIMEOUT)
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

    @contextlib.contextmanager
    def paused(self):
        """Calls made inside run with the workers paused; on exit they are
        released and the server settles, so what the calls enqueued forms
        the same batches in both worlds."""
        self.pause()
        try:
            yield self.srv
        finally:
            self.release()
        settle(self.srv)

    def wave(self, jobs):
        """Register ``jobs`` with the workers paused, then release them:
        one batch of up to ``batch_size`` evals."""
        with self.paused():
            for j in jobs:
                self.job_register(j)

    def counter(self, key):
        return self.srv.metrics.sink.latest()["CounterTotals"].get(
            f"nomad.{key}", 0)

    def columnar_stats(self):
        """The columnar mirror's counters of this world's package, and
        (port) the applier's columnar route and guard runs."""
        c = self.columnar
        out = {"encodes": c.COLUMNAR_ENCODES, "guard_runs": c.GUARD_RUNS,
               "guard_mismatches": c.GUARD_MISMATCHES,
               "usage_reads": c.USAGE_READS,
               "usage_guard_runs": c.USAGE_GUARD_RUNS,
               "usage_guard_mismatches": c.USAGE_GUARD_MISMATCHES}
        if not self.ref:
            stats = self.srv.plan_applier.stats
            out["applier"] = {k: stats[k]
                              for k in ("plans", "columnar",
                                        "columnar_guards")}
        return out


def park_signal(worker):
    """An event the reference's worker sets when it reaches its pause
    check with a pause asked for (its loop's head: no batch in hand, none
    being dequeued).  Instruments this worker object only."""
    ev = getattr(worker, "_test_parked", None)
    if ev is None:
        ev = worker._test_parked = threading.Event()
        check = worker._check_paused

        def check_paused():
            if worker._paused:
                ev.set()
            check()
            ev.clear()

        worker._check_paused = check_paused
    return ev


def settled(srv):
    b = srv.eval_broker.stats()
    return (b["total_ready"] == 0 and b["total_unacked"] == 0
            and b["total_waiting"] == 0 and srv.plan_queue.depth() == 0
            and srv.blocked_evals._capacity_q.empty()
            and not srv.blocked_evals.duplicates
            and not any(e.status == js.EVAL_STATUS_PENDING
                        for e in srv.state.evals(None)))


def settle(srv):
    """Wait until nothing is queued, in flight or pending, twice in a
    row (the second look catches a reaper's apply)."""
    for _ in range(2):
        assert wait_until(lambda: settled(srv), SETTLE_TIMEOUT,
                          max_interval=0.05)
        time.sleep(0.3)
    assert settled(srv)


def content(srv):
    st = srv.state
    allocs = sorted((a.job_id, a.name, a.node_id, a.desired_status,
                     a.client_status) for a in st.allocs(None))
    evals = sorted((e.job_id, e.triggered_by, e.status)
                   for e in st.evals(None))
    queued = {}
    for job_id in sorted({e.job_id for e in st.evals(None)}):
        summ = st.job_summary_by_id(None, job_id)
        if summ is not None:
            queued[job_id] = {tg: v.queued
                              for tg, v in sorted(summ.summary.items())}
    return {"allocs": allocs, "evals": evals,
            "blocked": dict(srv.blocked_evals.stats()), "queued": queued}


@contextlib.contextmanager
def running(world):
    world.srv.start()
    try:
        yield world
    finally:
        world.srv.shutdown()
        if not world.ref:
            assert wait_until(lambda: not world.srv.threads(), JOIN_TIMEOUT)


def health(world):
    """Breaker closed with no trip, no oracle route, no nack."""
    brk = world.breaker
    return {"state": brk.state, "trips": brk.trips,
            "oracle_routed": world.counter("breaker.oracle_routed"),
            "nacks": world.counter("broker.nack")}


# -- the main scenario ----------------------------------------------------

def cluster():
    rng = random.Random(SEED)
    nodes = [strip_node(jmock.node(), f"node-{i:03d}",
                        cpu=rng.choice([2000, 4000]),
                        mem=rng.choice([4096, 8192])) for i in range(40)]
    wave1 = [make_job("svc-a", 8, 500, 256),
             make_job("svc-b", 5, 250, 128, priority=60),
             make_job("svc-c", 12, 500, 512),
             make_job("svc-d", 6, 250, 256),
             make_job("bat-a", 4, 250, 256, type_="batch")]
    wave2 = [make_job("svc-e", 6, 100, 128),
             make_job("bat-b", 3, 100, 128, type_="batch")]
    # Asks of 3000 MHz fit one per 4000-MHz node: not all 30 fit.
    big = make_job("svc-big", 30, 3000, 512)
    extra = [strip_node(jmock.node(), f"extra-{i}", cpu=16000,
                        mem=16384) for i in range(6)]
    return nodes, wave1, wave2, big, extra


def run_main(world, scenario, sys_job):
    nodes, wave1, wave2, big, extra = scenario
    out = {}
    for n in nodes:
        world.node_register(n)
    world.wave(wave1)
    out["wave1"] = content(world.srv)
    world.wave(wave2)
    out["wave2"] = content(world.srv)
    world.wave([big])
    out["blocked"] = content(world.srv)
    with world.paused():
        for n in extra:
            world.node_register(n)
    out["unblocked"] = content(world.srv)
    hosts = sorted({a.node_id for a in world.srv.state.allocs(None)
                    if a.job_id == "svc-a"})[:2]
    with world.paused() as srv:
        for nid in hosts:
            srv.node_update_status(nid, js.NODE_STATUS_DOWN)
    out["node_down"] = content(world.srv)
    out["down_hosts"] = hosts
    with world.paused() as srv:
        srv.job_deregister("svc-c", purge=False)
    out["deregister"] = content(world.srv)
    # A node that carries live allocs leaves: the mirror is dropped and
    # rebuilt, and its allocs are placed again elsewhere.
    gone = sorted({a.node_id for a in world.srv.state.allocs(None)
                   if a.job_id == "svc-d" and not a.terminal_status()})[0]
    with world.paused() as srv:
        srv.node_deregister(gone)
    out["node_deregister"] = content(world.srv)
    out["gone"] = gone
    world.wave([sys_job])
    out["system"] = content(world.srv)
    out["health"] = health(world)
    out["columnar"] = world.columnar_stats()
    return out


@pytest.fixture(scope="module")
def main_runs():
    # The reference's objects are made before either world draws ids.
    scenario = cluster()
    sys_job = system_job()
    runs = {}
    for kind in ("ref", "port"):
        with pytest.MonkeyPatch.context() as mp:
            with running(World(kind, mp)) as world:
                runs[kind] = run_main(world, scenario, sys_job)
    return runs


PHASES = ["wave1", "wave2", "blocked", "unblocked", "node_down",
          "deregister", "node_deregister", "system"]


@pytest.mark.parametrize("phase", PHASES)
def test_phase_commits_what_the_reference_commits(main_runs, phase):
    ref, port = main_runs["ref"][phase], main_runs["port"][phase]
    assert port["allocs"] == ref["allocs"]
    assert port["evals"] == ref["evals"]
    assert port["blocked"] == ref["blocked"]
    assert port["queued"] == ref["queued"]


def test_register_stream_places_every_ask(main_runs):
    nodes, wave1, wave2, _, _ = cluster()
    allocs = main_runs["port"]["wave2"]["allocs"]
    for j in wave1 + wave2:
        placed = [a for a in allocs if a[0] == j.id and a[3] == "run"]
        assert len(placed) == j.task_groups[0].count, j.id
    evals = main_runs["port"]["wave2"]["evals"]
    assert {e[2] for e in evals} == {ps.EVAL_STATUS_COMPLETE}


def test_capacity_exhaustion_blocks_then_unblocks(main_runs):
    port = main_runs["port"]
    live = lambda phase: [a for a in port[phase]["allocs"]  # noqa: E731
                          if a[0] == "svc-big" and a[3] == "run"]
    assert 0 < len(live("blocked")) < 30
    assert port["blocked"]["blocked"]["total_blocked"] == 1
    assert ("svc-big", "job-register", "blocked") in port["blocked"]["evals"]
    # The new nodes' capacity unblocked it; everything is placed.
    assert len(live("unblocked")) == 30
    assert port["unblocked"]["blocked"]["total_blocked"] == 0


def test_node_down_replaces_lost_allocs(main_runs):
    port = main_runs["port"]
    down = set(port["down_hosts"])
    lost = [a for a in port["node_down"]["allocs"]
            if a[2] in down and a[4] == ps.ALLOC_CLIENT_STATUS_LOST]
    assert lost and all(a[3] == ps.ALLOC_DESIRED_STATUS_STOP for a in lost)
    for job_id, name, *_ in lost:
        repl = [a for a in port["node_down"]["allocs"]
                if a[0] == job_id and a[1] == name and a[3] == "run"]
        assert len(repl) == 1 and repl[0][2] not in down
    assert any(e[1] == ps.EVAL_TRIGGER_NODE_UPDATE
               for e in port["node_down"]["evals"])


def test_job_deregister_stops_its_allocs(main_runs):
    allocs = main_runs["port"]["deregister"]["allocs"]
    mine = [a for a in allocs if a[0] == "svc-c"]
    assert all(a[3] == ps.ALLOC_DESIRED_STATUS_STOP for a in mine)
    assert len([a for a in mine
                if a[4] != ps.ALLOC_CLIENT_STATUS_LOST]) == 12


def test_node_deregister_replaces_its_allocs(main_runs):
    port = main_runs["port"]
    gone = port["gone"]
    assert gone == main_runs["ref"]["gone"]
    before = [a for a in port["deregister"]["allocs"]
              if a[2] == gone and a[3] == "run"]
    after = port["node_deregister"]["allocs"]
    assert before
    for job_id, name, *_ in before:
        repl = [a for a in after if a[0] == job_id and a[1] == name
                and a[3] == "run" and a[2] != gone]
        assert len(repl) == 1, (job_id, name)
    assert any(e[1] == ps.EVAL_TRIGGER_NODE_UPDATE
               for e in port["node_deregister"]["evals"])


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_columnar_guards_ran_without_mismatch(main_runs, kind):
    """Both servers ran their columnar mirror with every guard at every
    read: the static encode, the usage read and, on the port, the
    applier's fit route, each plan double-checked against the walk."""
    c = main_runs[kind]["columnar"]
    assert c["encodes"] > 0 and c["guard_runs"] == c["encodes"]
    assert c["guard_mismatches"] == c["usage_guard_mismatches"] == 0
    assert c["usage_guard_runs"] == c["usage_reads"] > 0
    if kind == "port":
        app = c["applier"]
        assert app["columnar"] == app["columnar_guards"] == app["plans"] > 0


def test_system_job_on_every_ready_node(main_runs):
    port = main_runs["port"]
    nodes, *_, extra = cluster()
    ready = ({n.id for n in nodes + extra} - set(port["down_hosts"])
             - {port["gone"]})
    placed = [a for a in port["system"]["allocs"] if a[0] == "system"]
    assert sorted(a[2] for a in placed) == sorted(ready)


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_breaker_closed_no_oracle_route_no_nack(main_runs, kind):
    assert main_runs[kind]["health"] == {
        "state": "closed", "trips": 0, "oracle_routed": 0, "nacks": 0}


# -- the preempting drill ---------------------------------------------------

def drill():
    """Eight nodes each filled by one low-priority alloc; a high-priority
    job that fits only by evicting; then capacity for the victims."""
    fleet = [strip_node(jmock.node(), f"fleet-{i}") for i in range(8)]
    filler = make_job("filler", 8, 3000, 512, priority=10)
    urgent = make_job("urgent", 4, 2000, 512, priority=70)
    spare = [strip_node(jmock.node(), f"spare-{i}") for i in range(4)]
    return fleet, filler, urgent, spare


def run_drill(world, scenario):
    fleet, filler, urgent, spare = scenario
    out = {}
    for n in fleet:
        world.node_register(n)
    world.wave([filler])
    out["filled"] = content(world.srv)
    world.wave([urgent])
    out["preempted"] = content(world.srv)
    out["follow_up"] = sorted(
        (e.job_id, e.triggered_by, e.status, e.snapshot_index > 0)
        for e in world.srv.state.evals(None)
        if e.triggered_by == js.EVAL_TRIGGER_PREEMPTION)
    with world.paused():
        for n in spare:
            world.node_register(n)
    out["replaced"] = content(world.srv)
    out["health"] = health(world)
    return out


@pytest.fixture(scope="module")
def drill_runs():
    scenario = drill()
    runs = {}
    for kind in ("ref", "port"):
        with pytest.MonkeyPatch.context() as mp:
            with running(World(kind, mp, preemption=True)) as world:
                runs[kind] = run_drill(world, scenario)
    return runs


@pytest.mark.parametrize("phase", ["filled", "preempted", "replaced"])
def test_preempting_drill_commits_what_the_reference_commits(drill_runs,
                                                             phase):
    ref, port = drill_runs["ref"][phase], drill_runs["port"][phase]
    assert port == ref


def test_preempting_drill_hands_victims_to_blocked_evals(drill_runs):
    port = drill_runs["port"]
    assert port["follow_up"] == drill_runs["ref"]["follow_up"] == [
        ("filler", ps.EVAL_TRIGGER_PREEMPTION, ps.EVAL_STATUS_BLOCKED,
         True)]
    evicted = [a for a in port["preempted"]["allocs"]
               if a[3] == ps.ALLOC_DESIRED_STATUS_EVICT]
    assert len(evicted) == 4 and {a[0] for a in evicted} == {"filler"}
    assert port["preempted"]["blocked"]["total_blocked"] == 1
    urgent = [a for a in port["preempted"]["allocs"]
              if a[0] == "urgent" and a[3] == "run"]
    assert sorted(a[2] for a in urgent) == sorted(a[2] for a in evicted)
    # Capacity added: the victims are placed again on the spare nodes.
    back = [a for a in port["replaced"]["allocs"]
            if a[0] == "filler" and a[3] == "run"]
    assert len(back) == 8
    assert sum(a[2].startswith("spare-") for a in back) == 4
    assert port["replaced"]["blocked"]["total_blocked"] == 0
    assert port["health"] == drill_runs["ref"]["health"] == {
        "state": "closed", "trips": 0, "oracle_routed": 0, "nacks": 0}


# -- the server itself ------------------------------------------------------

@pytest.fixture
def servers():
    """Port servers a test makes, each shut down in the teardown."""
    made = []
    yield made
    for srv in made:
        srv.shutdown()
        assert wait_until(lambda: not srv.threads(), JOIN_TIMEOUT)


def test_default_device_raises_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Server(ServerConfig()).start()


def test_failed_kernel_build_raises_at_start(monkeypatch, servers):
    """On ``cuda``, start() builds the kernels in the calling thread, and
    a failed build raises there before any worker starts."""
    import torch

    from nomad_tpu_torch.server import plan_apply, server as server_mod

    calls = []

    def fail():
        calls.append(1)
        raise device.KernelUnavailable("nvcc not found")

    cuda = lambda d=None: torch.device("cuda")  # noqa: E731
    monkeypatch.setattr(server_mod.device_mod, "build_kernels", fail)
    monkeypatch.setattr(server_mod.device_mod, "resolve_device", cuda)
    monkeypatch.setattr(plan_apply, "resolve_device", cuda)
    srv = Server(ServerConfig(device="cuda"))
    servers.append(srv)
    with pytest.raises(device.KernelUnavailable):
        srv.start()
    assert calls == [1] and not srv.workers and not srv.threads()


def test_shutdown_stops_every_thread(servers):
    srv = Server(ServerConfig(device="cpu", min_heartbeat_ttl=HEARTBEAT_TTL,
                              num_schedulers=2))
    servers.append(srv)
    srv.start()
    threads = srv.threads()
    assert srv.is_leader() and len(threads) >= 8
    assert all(t.daemon for t in threads)
    srv.node_register(conv(strip_node(jmock.node()), convert.node_from_dict))
    srv.shutdown()
    assert wait_until(lambda: not srv.threads(), JOIN_TIMEOUT)


def test_job_register_validates():
    srv = Server(ServerConfig(device="cpu"))
    bad = conv(make_job("bad", 2, 100, 64), convert.job_from_dict)
    bad.task_groups[0].tasks[0].driver = ""
    with pytest.raises(ValueError, match="must specify a driver"):
        srv.job_register(bad)


def test_heartbeat_expiry_marks_the_node_down(servers):
    """A node that stops heartbeating is marked down through the log
    (tests/test_server.py:125 on the port)."""
    srv = Server(ServerConfig(device="cpu", min_heartbeat_ttl=0.3))
    servers.append(srv)
    srv.heartbeat.grace = 0.2
    srv.start()
    node = conv(strip_node(jmock.node()), convert.node_from_dict)
    srv.node_register(node)
    assert wait_until(lambda: srv.state.node_by_id(None, node.id).status
                      == ps.NODE_STATUS_DOWN, 10.0)


def test_drain_moves_allocs_off_the_node(servers):
    srv = Server(ServerConfig(device="cpu", rng_seed=SEED,
                              min_heartbeat_ttl=HEARTBEAT_TTL))
    servers.append(srv)
    srv.start()
    nodes = [conv(strip_node(jmock.node(), f"n-{i}"), convert.node_from_dict)
             for i in range(3)]
    for n in nodes:
        srv.node_register(n)
    job = conv(make_job("drained", 4, 500, 256), convert.job_from_dict)
    _, eval_id = srv.job_register(job)
    assert wait_until(lambda: srv.state.eval_by_id(None, eval_id).status
                      == ps.EVAL_STATUS_COMPLETE, 60.0)
    victim = srv.state.allocs_by_job(None, job.id, True)[0].node_id
    srv.node_update_drain(victim, True)
    settle(srv)
    live = [a for a in srv.state.allocs_by_job(None, job.id, True)
            if a.desired_status == ps.ALLOC_DESIRED_STATUS_RUN]
    assert len(live) == 4 and all(a.node_id != victim for a in live)
    assert srv.state.node_by_id(None, victim).drain


def test_leadership_loss_stops_the_pipeline(servers):
    srv = Server(ServerConfig(device="cpu", min_heartbeat_ttl=HEARTBEAT_TTL))
    servers.append(srv)
    srv.start()
    assert srv.eval_broker.stats() is not None and srv.is_leader()
    srv.raft._set_leader(False)
    assert not srv.is_leader()
    assert not srv.plan_applier.threads()
    with pytest.raises(peval_broker.EvalBrokerError):
        srv.eval_broker.dequeue([ps.JOB_TYPE_SERVICE], 0)
    with pytest.raises(RuntimeError, match="disabled"):
        srv.plan_queue.enqueue(ps.Plan())


# -- the job lifecycle --------------------------------------------------------
#
# Periodic and parameterized batch jobs in two tenant namespaces through
# both servers: a wave with the workers paused (prod's service jobs, two
# periodic parents forced once, a parameterized parent dispatched twice,
# then dispatched until its namespace's live-alloc quota refuses), the
# batch children's allocs completed through node_update_allocs, a
# force-gc core eval through the worker, and a second wave.  The tenancy
# feed (the usage fold into the broker's DRF order) runs before each
# release in both worlds.  Dispatched children are keyed by their
# parent and ordinal (their ids carry a uuid); both worlds share one
# clock for the launch and dispatch times.

LIFECYCLE_NOW = 1_700_000_000.0


def lifecycle_job(job_id, ns, count, cpu=250, mem=128, type_="batch"):
    j = make_job(job_id, count, cpu, mem, type_=type_)
    j.namespace = ns
    return j


def lifecycle_scenario():
    rng = random.Random(SEED + 1)
    nodes = [strip_node(jmock.node(), f"lc-{i:03d}",
                        cpu=rng.choice([2000, 4000]), mem=4096)
             for i in range(24)]
    prod = [lifecycle_job(f"prod-{i}", "prod", 4, type_="service")
            for i in range(3)]
    pers = []
    for i in range(2):
        j = lifecycle_job(f"per-{i}", "batch", 3)
        j.periodic = js.PeriodicConfig(
            enabled=True, spec=str(LIFECYCLE_NOW + 86400),
            spec_type=js.PERIODIC_SPEC_TEST)
        pers.append(j)
    par = lifecycle_job("par", "batch", 3)
    par.parameterized_job = js.ParameterizedJobConfig(
        payload="optional", meta_required=["k"])
    return nodes, prod, pers, par


DISPATCH_ID = re.compile(r"(.+)/dispatch-(\d+)-[0-9a-f]{8}")


class Keys:
    """Dispatched children keyed by (parent, ordinal of creation)."""

    def __init__(self, srv):
        self.keys, count = {}, {}
        for j in sorted(srv.state.jobs(None), key=lambda j: j.create_index):
            m = DISPATCH_ID.fullmatch(j.id)
            if m:
                n = count[m.group(1)] = count.get(m.group(1), -1) + 1
                self.keys[j.id] = f"{m.group(1)}/dispatch-{m.group(2)}-#{n}"

    def __call__(self, job_id):
        return self.keys.get(job_id, job_id)


def lifecycle_content(srv, deleted_seen=None):
    key = Keys(srv)
    st = srv.state
    out = content(srv)
    out["allocs"] = sorted((key(a[0]),) + a[1:] for a in out["allocs"])
    out["evals"] = sorted((key(e[0]),) + e[1:] for e in out["evals"])
    out["queued"] = {key(k): v for k, v in out["queued"].items()}
    jobs = {}
    for j in st.jobs(None):
        summ = st.job_summary_by_id(None, j.id)
        jobs[key(j.id)] = (j.status, j.parent_id,
                           dataclasses.astuple(summ.children)
                           if summ and summ.children else None)
    out["jobs"] = jobs
    out["usage"] = st.namespace_usage()
    out["launches"] = sorted((p.id, p.launch)
                             for p in st.periodic_launches(None))
    return out


def run_lifecycle(world, scenario, clock, mp):
    nodes, prod, pers, par = scenario
    srv = world.srv
    S = js if world.ref else ps
    out = {"refused": []}
    sub = srv.event_stream_subscribe()
    for n in nodes:
        world.node_register(n)
    srv.namespace_upsert(S.Namespace(name="prod", dequeue_weight=2.0))
    srv.namespace_upsert(S.Namespace(name="batch", dequeue_weight=1.0,
                                     max_live_allocs=18))

    def dispatch(k):
        try:
            srv.job_dispatch("par", b"", {"k": str(k)})
            return True
        except Exception as e:  # noqa: BLE001
            out["refused"].append((type(e).__name__,
                                   getattr(e, "namespace", ""), str(e)))
            return False

    def feed():
        srv._feed_tenancy(10)

    with world.paused():
        for j in prod + pers + [par]:
            world.job_register(j)
        clock.t = LIFECYCLE_NOW + 60
        for j in pers:
            srv.periodic_force(j.id)
        dispatch(0)
        dispatch(1)
        # The quota drill: 12 of 18 held; two more fit, the third not.
        out["admitted"] = sum(dispatch(k) for k in range(2, 8)
                              if len(out["refused"]) == 0)
        feed()
    out["wave1"] = lifecycle_content(srv)
    out["tenants1"] = {ns: row["Dequeued"] for ns, row in
                       srv.broker_stats()["Tenants"].items()}
    children = [a for a in srv.state.allocs(None) if "/" in a.job_id]
    with world.paused():
        done = []
        for a in children:
            a = a.copy()
            a.client_status = js.ALLOC_CLIENT_STATUS_COMPLETE
            done.append(a)
        srv.node_update_allocs(done)
    out["completed"] = lifecycle_content(srv)
    n_evals = len(srv.state.evals(None))
    srv.system_gc()
    settle(srv)
    out["gc"] = lifecycle_content(srv)
    deleted = n_evals + 1 - len(srv.state.evals(None))
    events = []
    while True:
        ev = sub.next(0.5)
        if ev is None:
            break
        events.append(ev.type)
    out["eval_deleted"] = (events.count("EvalDeleted"), deleted)
    with world.paused():
        clock.t = LIFECYCLE_NOW + 120
        for j in pers:
            srv.periodic_force(j.id)
        dispatch(20)
        dispatch(21)
        feed()
    out["wave2"] = lifecycle_content(srv)
    out["reserved"] = srv.quota_ledger.reserved("batch")
    out["health"] = health(world)
    out["columnar"] = world.columnar_stats()
    return out


def drop_cluster_caches():
    """Both packages' static-cluster caches are keyed by the store's
    lineage id, which the seeded ids make the same in every world: a
    world must not find an earlier world's fleet under its own key."""
    jbatch_sched._CLUSTER_CACHE.clear()
    pbatch_sched._CLUSTER_CACHE.clear()


@pytest.fixture(scope="module")
def lifecycle_runs():
    scenario = lifecycle_scenario()
    runs = {}
    for kind in ("ref", "port"):
        drop_cluster_caches()
        with pytest.MonkeyPatch.context() as mp:
            world = World(kind, mp, events=True)
            clock = types.SimpleNamespace(t=LIFECYCLE_NOW)
            structs = js if world.ref else ps
            mp.setattr(structs, "now", lambda: clock.t)
            mp.setattr(jperiodic if world.ref else pperiodic, "time",
                       types.SimpleNamespace(time=lambda: clock.t))
            with running(world):
                runs[kind] = run_lifecycle(world, scenario, clock, mp)
    drop_cluster_caches()
    return runs


LIFECYCLE_PHASES = ["wave1", "completed", "gc", "wave2"]


@pytest.mark.parametrize("phase", LIFECYCLE_PHASES)
def test_lifecycle_phase_equals_the_reference(lifecycle_runs, phase):
    ref, port = lifecycle_runs["ref"][phase], lifecycle_runs["port"][phase]
    for k in ("allocs", "evals", "blocked", "queued", "jobs", "usage",
              "launches"):
        assert port[k] == ref[k], k


def test_lifecycle_refusals_and_tenants_equal_the_reference(
        lifecycle_runs):
    ref, port = lifecycle_runs["ref"], lifecycle_runs["port"]
    for k in ("refused", "admitted", "tenants1", "eval_deleted",
              "reserved"):
        assert port[k] == ref[k], k
    assert port["admitted"] == 2
    assert [r[:2] for r in port["refused"]] == [("BrokerLimitError",
                                                 "batch")]
    count, deleted = port["eval_deleted"]
    assert count == deleted > 0


def test_lifecycle_places_gcs_and_relaunches(lifecycle_runs):
    port = lifecycle_runs["port"]
    w1, gc, w2 = port["wave1"], port["gc"], port["wave2"]
    child_jobs = [j for j, v in w1["jobs"].items() if v[1]]
    assert len(child_jobs) == 2 + 4
    assert all(w1["jobs"][j][0] == "running" for j in child_jobs)
    # GC took every child's evals, allocs and job; prod and the parents
    # stay.
    assert not [j for j, v in gc["jobs"].items() if v[1]]
    assert {"prod-0", "prod-1", "prod-2", "per-0", "per-1", "par"} <= set(
        gc["jobs"])
    assert not [a for a in gc["allocs"] if "/" in a[0]]
    assert len([a for a in gc["allocs"] if a[0].startswith("prod")]) == 12
    # The children summaries rolled their children to dead.
    assert gc["jobs"]["per-0"][2][2] == 1
    assert w2["launches"] == [("per-0", LIFECYCLE_NOW + 120),
                              ("per-1", LIFECYCLE_NOW + 120)]
    placed = [a for a in w2["allocs"] if "/" in a[0] and a[3] == "run"]
    assert len(placed) == 4 * 3
    assert port["reserved"] == 0


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_lifecycle_health(lifecycle_runs, kind):
    assert lifecycle_runs[kind]["health"] == {
        "state": "closed", "trips": 0, "oracle_routed": 0, "nacks": 0}
    c = lifecycle_runs[kind]["columnar"]
    assert c["guard_mismatches"] == c["usage_guard_mismatches"] == 0
    assert c["guard_runs"] > 0
