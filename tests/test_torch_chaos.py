"""The port's fault plane and the chaos scenarios it drives
(``nomad_tpu_torch/fault.py``, the ``rpc.send``, ``plan.apply`` and
``raft.apply`` fault points, the kernel breaker) against the JAX
package's, case for case with ``tests/test_chaos.py``.

Each case runs the same seeded scenario in both packages and compares
what it observes: the fire traces of one seed (and another), the
``after``/``times``/``match`` gates, the transport's classification of a
truncated, oversized, duplicated or delayed frame and the pool's discard
of a poisoned connection, a crash or error at plan apply (one fire, every
placement exactly once, the failure reason on the eval), a crash at a
chosen log index and a step-down, a heartbeat blackout (node down, the
alloc lost, rescheduled on the other node), a nack redelivery, the
device-output validator, and the breaker's trip, oracle carry and probe
(in a ``Harness`` and through a server's batch worker, whose trip leaves
one flight-recorder bundle).  The port's scheduler runs on the CPU;
every reference scheduler gets a ``KernelCircuitBreaker`` of its own.
Every wait has a deadline; every case disarms the plane.
"""
import json
import socket
import threading
import time

import jax  # noqa: F401  (the reference computes on the CPU backend)
import numpy as np
import pytest

import nomad_tpu.ops.breaker as jbreaker
from nomad_tpu import fault as jfault
from nomad_tpu import mock as jmock
from nomad_tpu.ops import batch_sched as jbatch
from nomad_tpu.scheduler import Harness as JHarness
from nomad_tpu.server import EvalBroker as JEvalBroker
from nomad_tpu.server import Server as JServer
from nomad_tpu.server import ServerConfig as JServerConfig
from nomad_tpu.server import rpc as jrpc
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert, fault
from nomad_tpu_torch.ops import batch_sched as pbatch
from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
from nomad_tpu_torch.scheduler.testing import Harness as PHarness
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server import rpc as prpc
from nomad_tpu_torch.server.eval_broker import EvalBroker as PEvalBroker
from nomad_tpu_torch.structs import structs as ps
from nomad_tpu_torch.utils.backoff import wait_until

DEADLINE = 30.0
KINDS = ("ref", "port")


@pytest.fixture(autouse=True)
def _always_disarm():
    yield
    fault.disarm()
    jfault.disarm()


def fmod(kind):
    return jfault if kind == "ref" else fault


def smod(kind):
    return js if kind == "ref" else ps


def make_node(kind):
    n = jmock.node()
    n.resources.networks = []
    n.reserved.networks = []
    if kind == "ref":
        return n
    import dataclasses

    return convert.node_from_dict(dataclasses.asdict(n))


def make_job(kind, count=2):
    j = jmock.job()
    j.task_groups[0].count = count
    for t in j.task_groups[0].tasks:
        t.resources.networks = []
    if kind == "ref":
        return j
    import dataclasses

    return convert.job_from_dict(dataclasses.asdict(j))


def live(srv, job_id):
    return [a for a in srv.state.allocs_by_job(None, job_id, True)
            if not a.terminal_status()]


def server(kind, monkeypatch, **fields):
    """One server of ``kind``: the reference's with the batch worker and
    its own breaker, the port's on the CPU."""
    if kind == "ref":
        monkeypatch.setattr(jbreaker, "BREAKER",
                            jbreaker.KernelCircuitBreaker())
        return JServer(JServerConfig(use_tpu_batch_worker=True, **fields))
    return Server(ServerConfig(device="cpu", rng_seed=7,
                               breaker=KernelCircuitBreaker(), **fields))


def oracle_routed(srv):
    return srv.metrics.sink.latest()["CounterTotals"].get(
        "nomad.breaker.oracle_routed", 0)


# -- the fault plane (TestFaultPlane) -----------------------------------------

def test_disarmed_is_inert():
    for m in (jfault, fault):
        assert not m.armed()
        assert m.faultpoint("rpc.send") is None
        assert m.trace() == []


def seeded_trace(m, seed):
    cfg = {"faults": [{"point": "p.q", "action": "drop", "prob": 0.5}]}
    with m.scenario(cfg, seed=seed) as plane:
        for _ in range(64):
            m.faultpoint("p.q")
        return plane.trace()


def test_same_seed_same_trace():
    port = [seeded_trace(fault, s) for s in (11, 11, 12)]
    ref = [seeded_trace(jfault, s) for s in (11, 11, 12)]
    assert port == ref
    assert port[0] == port[1] and port[0] != port[2]
    assert 0 < len(port[0]) < 64


def gates(m):
    m.arm({"seed": 0, "faults": [
        {"point": "a.b", "action": "delay", "after": 2, "times": 2,
         "match": {"index": 7}}]})
    fired = []
    for _ in range(8):
        assert m.faultpoint("a.b", index=3) is None
        fired.append(m.faultpoint("a.b", index=7) is not None)
    m.disarm()
    return fired


def test_after_times_and_match_gates():
    assert gates(fault) == gates(jfault) == [
        False, False, True, True, False, False, False, False]


@pytest.mark.parametrize("kind", KINDS)
def test_glob_points_and_error_action(kind):
    m = fmod(kind)
    m.arm([{"point": "rpc.*", "action": "error", "error": "boom injected"}])
    act = m.faultpoint("rpc.send")
    with pytest.raises(m.InjectedFault, match="boom injected"):
        act.raise_injected()


# -- the transport (TestTransportFaults) --------------------------------------

def rpc_mod(kind):
    return jrpc if kind == "ref" else prpc


def recv_outcome(kind, prefix):
    a, b = socket.socketpair()
    try:
        a.sendall(prefix)
        a.close()
        try:
            rpc_mod(kind)._recv_frame(b)
            return "ok"
        except Exception as e:  # noqa: BLE001 — compared
            return type(e).__name__, str(e)
    finally:
        b.close()


def test_recv_mid_frame_eof_is_transport_error():
    want = recv_outcome("ref", (100).to_bytes(4, "little") + b"abc")
    assert recv_outcome("port", (100).to_bytes(4, "little") + b"abc") \
        == want
    assert want[0] == "TransportError" and "mid-frame" in want[1]


def test_oversized_frame_is_transport_error():
    want = recv_outcome("ref", (1 << 30).to_bytes(4, "little"))
    assert recv_outcome("port", (1 << 30).to_bytes(4, "little")) == want
    assert want[0] == "TransportError" and "frame too large" in want[1]


def echo_world(kind):
    m = rpc_mod(kind)
    srv = m.RPCServer()
    srv.register("Echo", lambda body: body)
    srv.start()
    return srv, m.ConnPool(timeout=5.0)


def truncation(kind, after):
    m = fmod(kind)
    srv, pool = echo_world(kind)
    try:
        first = pool.call(srv.address, "Echo", {"x": 1})
        rule = {"point": "rpc.send", "action": "truncate", "times": 1}
        if after:
            rule["after"] = 1
        with m.scenario({"seed": 5, "faults": [rule]}):
            try:
                pool.call(srv.address, "Echo", {"x": 2})
                raised = None
            except Exception as e:  # noqa: BLE001 — compared
                raised = type(e).__name__
        pooled = any(bucket for bucket in pool._idle.values())
        return first, raised, pooled, pool.call(srv.address, "Echo",
                                                {"x": 3})
    finally:
        pool.close()
        srv.shutdown()


@pytest.mark.parametrize("after", [False, True],
                         ids=["request_truncated", "reply_truncated"])
def test_pool_discards_poisoned_conn_after_truncation(after):
    port = truncation("port", after)
    assert port == truncation("ref", after)
    assert port == ({"x": 1}, "TransportError", False, {"x": 3})


def delayed(kind):
    m = fmod(kind)
    srv, pool = echo_world(kind)
    try:
        with m.scenario({"seed": 9, "faults": [
                {"point": "rpc.send", "action": "delay", "delay": 0.01,
                 "times": 4}]}) as plane:
            out = [pool.call(srv.address, "Echo", {"i": i})
                   for i in range(6)]
            return out, plane.trace()
    finally:
        pool.close()
        srv.shutdown()


def test_delay_is_benign():
    port = delayed("port")
    assert port == delayed("ref")
    assert port[0] == [{"i": i} for i in range(6)] and len(port[1]) == 4


def duplicated(kind):
    m = fmod(kind)
    srv, pool = echo_world(kind)
    try:
        desyncs = wrong = 0
        with m.scenario({"seed": 9, "faults": [
                {"point": "rpc.send", "action": "dup", "times": 1}]}):
            for i in range(4):
                try:
                    if pool.call(srv.address, "Echo", {"i": i}) != {"i": i}:
                        wrong += 1
                except rpc_mod(kind).TransportError:
                    desyncs += 1
        after = [pool.call(srv.address, "Echo", {"i": i}) == {"i": i}
                 for i in range(5)]
        return desyncs <= 1, wrong, all(after)
    finally:
        pool.close()
        srv.shutdown()


def test_dup_is_detected_never_misdelivered():
    assert duplicated("port") == duplicated("ref") == (True, 0, True)


# -- plan apply (TestPlanApplyCrash) ------------------------------------------

def plan_crash(kind, monkeypatch):
    m = fmod(kind)
    srv = server(kind, monkeypatch, num_schedulers=1)
    srv.eval_broker.initial_nack_delay = 0.1
    srv.start()
    try:
        for _ in range(3):
            srv.node_register(make_node(kind))
        m.arm({"seed": 21, "faults": [
            {"point": "plan.apply", "action": "crash", "times": 1}]})
        job = make_job(kind, 3)
        _, eval_id = srv.job_register(job)
        assert wait_until(lambda: srv.state.eval_by_id(
            None, eval_id).status == "complete", DEADLINE)
        allocs = live(srv, job.id)
        return (m.trace(), len(allocs), len({a.id for a in allocs}),
                len({a.name for a in allocs}), oracle_routed(srv))
    finally:
        m.disarm()
        srv.shutdown()


def test_crash_then_redelivery_loses_no_placements(monkeypatch):
    port = plan_crash("port", monkeypatch)
    assert port == plan_crash("ref", monkeypatch)
    assert port == ([("plan.apply", 0, "crash")], 3, 3, 3, 0)


def plan_error(kind, monkeypatch):
    m = fmod(kind)
    srv = server(kind, monkeypatch, num_schedulers=1)
    srv.eval_broker.initial_nack_delay = 0.1
    srv.start()
    try:
        srv.node_register(make_node(kind))
        m.arm({"seed": 3, "faults": [
            {"point": "plan.apply", "action": "error",
             "error": "injected applier fault", "times": 1}]})
        job = make_job(kind, 1)
        _, eval_id = srv.job_register(job)
        assert wait_until(lambda: "injected applier fault" in (
            srv.state.eval_by_id(None, eval_id).status_description or ""),
            DEADLINE)
        desc = srv.state.eval_by_id(None, eval_id).status_description
        assert wait_until(lambda: srv.state.eval_by_id(
            None, eval_id).status == "complete", DEADLINE)
        return ("scheduler error on delivery attempt 1" in desc,
                oracle_routed(srv))
    finally:
        m.disarm()
        srv.shutdown()


def test_failure_reason_recorded_on_eval(monkeypatch):
    assert plan_error("port", monkeypatch) == plan_error(
        "ref", monkeypatch) == (True, 0)


# -- the log (TestRaftApplyFaults) --------------------------------------------

def crash_at_index(kind, monkeypatch):
    m = fmod(kind)
    srv = server(kind, monkeypatch, num_schedulers=0)
    srv.start()
    try:
        m.arm({"seed": 1, "faults": [
            {"point": "raft.apply", "action": "crash",
             "match": {"index": 2}}]})
        srv.node_register(make_node(kind))
        victim = make_node(kind)
        with pytest.raises(m.InjectedFault):
            srv.node_register(victim)
        out = [srv.state.node_by_id(None, victim.id) is None,
               srv.raft.applied_index(), m.trace()]
        m.disarm()
        n3 = make_node(kind)
        srv.node_register(n3)
        return out + [srv.state.node_by_id(None, n3.id) is not None,
                      srv.raft.applied_index()]
    finally:
        m.disarm()
        srv.shutdown()


def test_crash_at_chosen_index(monkeypatch):
    port = crash_at_index("port", monkeypatch)
    assert port == crash_at_index("ref", monkeypatch)
    assert port == [True, 1, [("raft.apply", 0, "crash")], True, 2]


def step_down(kind, monkeypatch):
    from nomad_tpu.server.raft import NotLeaderError as JNotLeader
    from nomad_tpu_torch.server.raft import NotLeaderError as PNotLeader

    m = fmod(kind)
    srv = server(kind, monkeypatch, num_schedulers=0)
    srv.start()
    try:
        m.arm({"seed": 2, "faults": [
            {"point": "raft.apply", "action": "step_down", "times": 1,
             "match": {"msg_type": "NODE_REGISTER"}}]})
        with pytest.raises(JNotLeader if kind == "ref" else PNotLeader):
            srv.node_register(make_node(kind))
        m.disarm()
        n2 = make_node(kind)
        srv.node_register(n2)
        return srv.state.node_by_id(None, n2.id) is not None
    finally:
        m.disarm()
        srv.shutdown()


def test_step_down_surfaces_as_not_leader(monkeypatch):
    assert step_down("port", monkeypatch) is step_down("ref", monkeypatch) \
        is True


# -- a heartbeat blackout (TestHeartbeatBlackout) ------------------------------

def blackout(kind, monkeypatch):
    m = fmod(kind)
    if kind == "ref":
        srv = server(kind, monkeypatch, num_schedulers=1,
                     min_heartbeat_ttl=0.3, max_heartbeats_per_second=1000.0)
    else:
        srv = server(kind, monkeypatch, num_schedulers=1,
                     min_heartbeat_ttl=0.3)
        srv.heartbeat.max_per_second = 1000.0
    srv.heartbeat.grace = 0.2
    srv.start()
    stop = threading.Event()
    try:
        nodes = [make_node(kind) for _ in range(2)]
        for n in nodes:
            srv.node_register(n)
            srv.node_update_status(n.id, "ready")

        def heartbeater():
            while not stop.is_set():
                for n in nodes:
                    act = m.faultpoint("rpc.send", method="Node.UpdateStatus",
                                       node_id=n.id, side="client")
                    if act is not None and act.kind == "drop":
                        continue
                    try:
                        srv.node_update_status(n.id, "ready")
                    except Exception:  # noqa: BLE001 — a heartbeat lost
                        pass
                stop.wait(0.1)

        t = threading.Thread(target=heartbeater, daemon=True)
        t.start()
        job = make_job(kind, 1)
        srv.job_register(job)
        assert wait_until(lambda: live(srv, job.id), DEADLINE)
        victim = live(srv, job.id)[0].node_id
        other = next(n.id for n in nodes if n.id != victim)
        m.arm({"seed": 13, "faults": [
            {"point": "rpc.send", "action": "drop",
             "match": {"node_id": victim}}]})
        down = wait_until(lambda: srv.state.node_by_id(
            None, victim).status == "down", 10.0)

        def recovered():
            allocs = srv.state.allocs_by_job(None, job.id, True)
            lost = [a for a in allocs if a.client_status == "lost"]
            up = [a for a in allocs if not a.terminal_status()
                  and a.client_status != "lost"]
            return len(lost) == 1 and len(up) == 1 and up[0].node_id == other

        return down, wait_until(recovered, DEADLINE), oracle_routed(srv)
    finally:
        stop.set()
        m.disarm()
        srv.shutdown()


def test_blackout_marks_down_loses_allocs_reschedules(monkeypatch):
    port = blackout("port", monkeypatch)
    assert port == blackout("ref", monkeypatch) == (True, True, 0)


# -- nack redelivery (TestNackRedelivery) -------------------------------------

def redelivery(kind):
    broker = (JEvalBroker if kind == "ref" else PEvalBroker)(
        nack_timeout=0.25, initial_nack_delay=0.0, delivery_limit=3)
    broker.set_enabled(True)
    ev = jmock.eval()
    if kind == "port":
        import dataclasses

        ev = ps.Evaluation(**{k: v for k, v in dataclasses.asdict(ev).items()
                              if k in ps.Evaluation.__dataclass_fields__})
    broker.enqueue(ev)
    got, token = broker.dequeue([ev.type], 1.0)
    out = [got.id == ev.id, broker.delivery_attempts(ev.id)]
    got2, token2 = broker.dequeue([ev.type], 5.0)
    out += [got2 is not None and got2.id == ev.id, token2 != token,
            broker.delivery_attempts(ev.id)]
    broker.ack(ev.id, token2)
    st = broker.stats()
    broker.set_enabled(False)
    return out + [st["total_ready"], st["total_unacked"]]


def test_dead_worker_eval_redelivers_after_nack_timeout():
    assert redelivery("port") == redelivery("ref") == [
        True, 1, True, True, 2, 0, 0]


# -- the device-output validator (TestKernelOutputValidation) -----------------

class _SP:
    def __init__(self, count):
        self.count = count


class _CT:
    n_real = 4


@pytest.mark.parametrize("case", [
    ([2, 1], [0, 0], [0, 0, 1], [1, 2, 3], [1, 1, 1]),
    ([2], [-3], [], [], []),
    ([2], [7], [], [], []),
    ([2], [0], [0, 0], [1, -2], [1, 1]),
    ([2], [0], [0], [1], [5]),
], ids=["healthy", "negative_unplaced", "unplaced_exceeds_asks",
        "negative_node_index", "placed_unplaced_mismatch"])
def test_validate_device_outputs_equals_the_reference(case):
    counts, up, rows, cols, cnt = case

    def run(mod):
        return mod.validate_device_outputs(
            [_SP(c) for c in counts], _CT, np.asarray(up), np.asarray(rows),
            np.asarray(cols), np.asarray(cnt))

    assert run(pbatch) == run(jbatch)


# -- the breaker (TestKernelCorruptionBreaker) ---------------------------------

def breaker_scenario(kind, seed):
    m = fmod(kind)
    clock = [0.0]
    kw = dict(threshold=0.9, window=8, min_checks=1, cooldown=5.0,
              clock=lambda: clock[0])
    brk = (jbreaker.KernelCircuitBreaker(**kw) if kind == "ref"
           else KernelCircuitBreaker(**kw))
    h = JHarness() if kind == "ref" else PHarness()
    for _ in range(6):
        node = make_node(kind)
        node.compute_class()
        h.state.upsert_node(h.next_index(), node)
    S = smod(kind)

    def batch(n_jobs=2):
        jobs = []
        for _ in range(n_jobs):
            job = make_job(kind, 2)
            h.state.upsert_job(h.next_index(), job)
            jobs.append(job)
        evals = [S.Evaluation(
            id=S.generate_uuid(), priority=j.priority, type=j.type,
            triggered_by="job-register", job_id=j.id, status="pending")
            for j in jobs]
        if kind == "ref":
            sched = jbatch.TPUBatchScheduler(h.logger, h.snapshot(), h,
                                             breaker=brk)
        else:
            sched = pbatch.TorchBatchScheduler(h.logger, h.snapshot(), h,
                                               breaker=brk, device="cpu")
        st = sched.schedule_batch(evals)
        placed = all(len([a for a in h.state.allocs_by_job(None, j.id, True)
                          if not a.terminal_status()]) == 2 for j in jobs)
        return (st.kernel_rejects, st.oracle_routed), placed

    out = {}
    with m.scenario({"seed": seed, "faults": [
            {"point": "ops.kernel_result", "action": "corrupt",
             "times": 1}]}) as plane:
        out["b1"] = batch() + (brk.state,)
        out["b2"] = batch() + (brk.state,)
        clock[0] += 10.0
        out["b3"] = batch() + (brk.state,)
        out["trace"] = plane.trace()
    return out


def test_trip_oracle_fallback_and_recovery():
    port = breaker_scenario("port", 42)
    assert port == breaker_scenario("ref", 42)
    assert port["b1"] == ((1, 2), True, "open")
    assert port["b2"] == ((0, 2), True, "open")
    assert port["b3"] == ((0, 0), True, "closed")


def test_same_seed_same_chaos_trace():
    a, b = breaker_scenario("port", 7), breaker_scenario("port", 7)
    ref = breaker_scenario("ref", 7)
    assert a["trace"] == b["trace"] == ref["trace"] == [
        ("ops.kernel_result", 0, "corrupt")]
    assert [a[k][-1] for k in ("b1", "b2", "b3")] == \
        [ref[k][-1] for k in ("b1", "b2", "b3")]


def probe_expiry(cls):
    clock = [0.0]
    brk = cls(threshold=0.9, window=8, min_checks=1, cooldown=5.0,
              clock=lambda: clock[0])
    brk.record(False)
    out = [brk.state]
    clock[0] = 6.0
    out += [brk.allow_kernel(), brk.state, brk.allow_kernel()]
    clock[0] = 12.0
    out.append(brk.allow_kernel())
    brk.on_probe(True)
    return out + [brk.state]


def test_unresolved_probe_expires_and_regrants():
    assert probe_expiry(KernelCircuitBreaker) == probe_expiry(
        jbreaker.KernelCircuitBreaker) == [
        "open", True, "half-open", False, True, "closed"]


def test_probe_device_exception_resolves_probe(monkeypatch):
    """A raw device error during the probe batch, at dispatch and at
    fetch, propagates in both packages.  The reference feeds it to the
    breaker and re-opens it; the port's raw errors feed no breaker (a
    departure, ROADMAP queue 3 item 8(a)), so its probe stays half-open
    until it expires, and then a fresh probe is granted: neither wedges.
    The port's clean probe after the expiry closes its breaker."""
    def run(kind):
        clock = [0.0]
        kw = dict(threshold=0.9, window=8, min_checks=1, cooldown=5.0,
                  clock=lambda: clock[0])
        brk = (jbreaker.KernelCircuitBreaker(**kw) if kind == "ref"
               else KernelCircuitBreaker(**kw))
        brk.record(False)
        clock[0] = 6.0
        h = JHarness() if kind == "ref" else PHarness()
        for _ in range(3):
            node = make_node(kind)
            node.compute_class()
            h.state.upsert_node(h.next_index(), node)
        job = make_job(kind, 1)
        h.state.upsert_job(h.next_index(), job)
        S = smod(kind)
        ev = S.Evaluation(id=S.generate_uuid(), priority=job.priority,
                          type=job.type, triggered_by="job-register",
                          job_id=job.id, status="pending")
        if kind == "ref":
            sched = jbatch.TPUBatchScheduler(h.logger, h.snapshot(), h,
                                             breaker=brk)
        else:
            sched = pbatch.TorchBatchScheduler(h.logger, h.snapshot(), h,
                                               breaker=brk, device="cpu")

        def blow_up(*args, **kwargs):
            raise RuntimeError("device died")

        out = []
        with monkeypatch.context() as mp:
            mp.setattr(sched, "_dispatch_device", blow_up)
            with pytest.raises(RuntimeError, match="device died"):
                sched.schedule_batch([ev])
            out.append(brk.state)
        clock[0] += 6.0
        with monkeypatch.context() as mp:
            mp.setattr(sched, "_fetch_device", blow_up)
            with pytest.raises(RuntimeError, match="device died"):
                sched.schedule_batch([ev])
            out.append(brk.state)
        # Past another cooldown: a fresh probe, clean this time.
        clock[0] += 6.0
        job2 = make_job(kind, 1)
        h.state.upsert_job(h.next_index(), job2)
        if kind == "ref":
            sched = jbatch.TPUBatchScheduler(h.logger, h.snapshot(), h,
                                             breaker=brk)
        else:
            sched = pbatch.TorchBatchScheduler(h.logger, h.snapshot(), h,
                                               breaker=brk, device="cpu")
        sched.schedule_batch([S.Evaluation(
            id=S.generate_uuid(), priority=job2.priority, type=job2.type,
            triggered_by="job-register", job_id=job2.id,
            status="pending")])
        return out + [brk.state]

    assert run("ref")[:2] == ["open", "open"]
    assert run("port") == ["half-open", "half-open", "closed"]


def breaker_through_worker(kind, monkeypatch, tmp_path):
    """A corrupted batch trips the server's breaker; later jobs complete
    through the oracle; past the cooldown a probe closes it; the trip
    leaves one flight-recorder bundle."""
    from nomad_tpu.utils import blackbox as jblackbox
    from nomad_tpu_torch.utils import blackbox as pblackbox

    m = fmod(kind)
    bb = jblackbox if kind == "ref" else pblackbox
    d = tmp_path / kind
    if kind == "ref":
        monkeypatch.setenv("NOMAD_TPU_BREAKER_MIN_CHECKS", "1")
        monkeypatch.setenv("NOMAD_TPU_BREAKER_COOLDOWN", "0.5")
        jbreaker.reset_for_tests()
        bb.enable(directory=str(d), min_interval_s=300.0)
        srv = JServer(JServerConfig(num_schedulers=1,
                                    use_tpu_batch_worker=True, batch_size=8))
        brk = lambda: jbreaker.BREAKER  # noqa: E731
    else:
        b = KernelCircuitBreaker(min_checks=1, cooldown=0.5)
        srv = Server(ServerConfig(device="cpu", rng_seed=7, batch_size=8,
                                  breaker=b, blackbox_dir=str(d),
                                  blackbox_min_interval_s=300.0))
        brk = lambda: b  # noqa: E731
    srv.start()
    try:
        for _ in range(4):
            srv.node_register(make_node(kind))
        m.arm({"seed": 33, "faults": [
            {"point": "ops.kernel_result", "action": "corrupt",
             "times": 1}]})
        placed = []
        for k in range(3):
            if k == 2:
                time.sleep(0.6)  # past the cooldown: the probe
            job = make_job(kind, 2)
            srv.job_register(job)
            placed.append(wait_until(lambda: len(live(srv, job.id)) == 2,
                                     60.0))
        closed = wait_until(lambda: brk().state == "closed", DEADLINE)
        assert wait_until(lambda: len(bb.bundles()) >= 1, 10.0)
        with open(bb.bundles()[0], encoding="utf-8") as fh:
            bundle = json.load(fh)
        bb.note_trigger("breaker.open", {"Trips": 99})
        time.sleep(0.3)
        return (placed, brk().trips >= 1, closed, len(bb.bundles()),
                bundle["Reason"], bundle["Detail"]["Trips"] >= 1,
                any(sv["Name"] == srv.config.node_name
                    for sv in bundle["Servers"]),
                sorted(k for k in ("Spans", "Events", "Profile", "Locks",
                                   "Threads", "Servers", "Breaker")
                       if k in bundle))
    finally:
        m.disarm()
        bb.disable()
        srv.shutdown()
        if kind == "ref":
            jbreaker.reset_for_tests()


def test_breaker_trips_through_real_batch_worker(monkeypatch, tmp_path):
    port = breaker_through_worker("port", monkeypatch, tmp_path)
    assert port == breaker_through_worker("ref", monkeypatch, tmp_path)
    assert port[:6] == ([True] * 3, True, True, 1, "breaker.open", True)


# -- a lossy wire (TestDeepRPCSweep) -------------------------------------------

def lossy_wire(kind, seed):
    m = fmod(kind)
    rmod = rpc_mod(kind)
    srv = rmod.RPCServer()
    srv.register("Echo", lambda body: body)
    srv.start()
    pool = rmod.ConnPool(timeout=0.5)
    try:
        ok = failed = 0
        with m.scenario({"seed": seed, "faults": [
                {"point": "rpc.send", "action": "truncate", "prob": 0.10},
                {"point": "rpc.send", "action": "dup", "prob": 0.10},
                {"point": "rpc.send", "action": "delay", "delay": 0.005,
                 "prob": 0.10}]}):
            for i in range(120):
                try:
                    if pool.call(srv.address, "Echo", {"i": i}) == {"i": i}:
                        ok += 1
                except (rmod.RPCError, OSError):
                    failed += 1
        pool.close()
        clean = all(pool.call(srv.address, "Echo", {"i": i}) == {"i": i}
                    for i in range(10))
        return ok > 0, failed > 0, clean
    finally:
        pool.close()
        srv.shutdown()


@pytest.mark.parametrize("seed", [101, 202, 303])
def test_lossy_wire_never_wedges_the_server(seed):
    assert lossy_wire("port", seed) == lossy_wire("ref", seed) == (
        True, True, True)
