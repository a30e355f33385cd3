"""The port's tenancy plane against the reference's: the quota ledger, the
token buckets and the rate limiter (``tenancy/quota.py``), the eval
broker's namespace hooks (the per-tenant pending quota, the quota
refusals, the namespace policies, the DRF dequeue order, the tenant
rows and their tracing events), and the server's admission gates (the
live-alloc and the node-units quotas), on the CPU with the same calls in
both packages.

The ledger and bucket cases are twins of ``tests/test_tenancy.py``'s:
each case runs on both packages' classes and its observations must be
equal (and equal to the reference test's asserted values).  A seeded
sequence of ledger operations is held the same way.  The broker cases
enqueue, dequeue and admit identical evals in both brokers, each with
its ``random`` seeded alike; the DRF order of two namespaces is compared
eval by eval.  The server cases run a port ``Server(device="cpu",
num_schedulers=0)`` and a reference ``Server(num_schedulers=0)``, so
every eval stays pending and every reservation stays held; each
registration's outcome (admitted, or refused with the namespace) and
the ledgers' sums must be equal.  The last case holds the port's ledger
through a 3-server failover: the new leader's conservative rebuild
keeps the old leader's reservations, and a follower's write is
forwarded and refused with the namespace in the error.  Exact on every
count; floats of the node-units gate within 1e-9.
"""
import dataclasses
import random

import jax  # noqa: F401  (the reference's package imports it)
import pytest

from nomad_tpu import mock as jmock
from nomad_tpu.server import eval_broker as jbroker_mod
from nomad_tpu.server.server import Server as JServer
from nomad_tpu.server.server import ServerConfig as JServerConfig
from nomad_tpu.structs import structs as js
from nomad_tpu.tenancy import quota as jquota
from nomad_tpu.utils import tracing as jtracing
from nomad_tpu_torch import convert
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server import eval_broker as pbroker_mod
from nomad_tpu_torch.structs import structs as ps
from nomad_tpu_torch.tenancy import quota as pquota
from nomad_tpu_torch.utils import tracing as ptracing
from nomad_tpu_torch.utils.backoff import wait_until

MODS = {"ref": (js, jquota, jbroker_mod, jtracing),
        "port": (ps, pquota, pbroker_mod, ptracing)}


def twin(case):
    """``case(structs, quota, broker module)`` in both packages: the
    observations must be equal.  Returns the port's."""
    out = {k: case(*mods[:3]) for k, mods in MODS.items()}
    assert out["port"] == out["ref"]
    return out["port"]


# -- the ledger, the buckets and the limiter ---------------------------------

def ledger_admit_reject(s, q, b):
    led = q.QuotaLedger()
    return [led.check_and_reserve("t", "j1", 5, live=0, quota=10),
            led.check_and_reserve("t", "j2", 5, live=0, quota=10),
            led.check_and_reserve("t", "j3", 1, live=0, quota=10),
            led.check_and_reserve("t", "j3", 1000, live=0, quota=0),
            led.reserved("t")]


def ledger_live_fold(s, q, b):
    led = q.QuotaLedger()
    return [led.check_and_reserve("t", "j1", 2, live=8, quota=10),
            led.check_and_reserve("t", "j2", 1, live=8, quota=10)]


def ledger_reregister(s, q, b):
    led = q.QuotaLedger()
    out = [led.check_and_reserve("t", "j1", 5, live=0, quota=6),
           led.check_and_reserve("t", "j1", 5, live=0, quota=6),
           led.reserved("t")]
    out += [led.check_and_reserve("t", "j1", 3, live=0, quota=6),
            led.reserved("t")]
    return out


def ledger_release(s, q, b):
    led = q.QuotaLedger()
    out = [led.check_and_reserve("t", "j1", 4, live=0, quota=4),
           led.check_and_reserve("t", "j2", 1, live=0, quota=4)]
    led.release("j1")
    out.append(led.reserved("t"))
    led.release("j1")
    led.release("never-seen")
    out.append(led.check_and_reserve("t", "j2", 4, live=0, quota=4))
    return out


def ledger_rebuild(s, q, b):
    led = q.QuotaLedger()
    led.check_and_reserve("old", "j1", 9, live=0, quota=0)
    led.rebuild([("j2", "a", 3), ("j3", "b", 2), ("j4", "a", 1)])
    return [led.reserved("old"), led.reserved("a"), led.reserved("b")]


def bucket_burst_refill(s, q, b):
    tb = q.TokenBucket(rate=1.0, burst=2.0)
    return [tb.take(100.0), tb.take(100.0), tb.take(100.0), tb.take(101.1)]


def bucket_default_burst(s, q, b):
    return [q.TokenBucket(rate=5.0, burst=0.0).burst,
            q.TokenBucket(rate=0.2, burst=0.0).burst]


def limiter_unconfigured(s, q, b):
    rl = q.RateLimiter()
    return [rl.check("default", now=1.0), rl.check("anything", now=1.0)]


def limiter_configure_drop(s, q, b):
    rl = q.RateLimiter()
    rl.configure("t", rate=1.0, burst=1.0)
    out = [rl.check("t", now=10.0), rl.check("t", now=10.0) > 0.0]
    rl.configure("t", rate=1.0, burst=1.0)
    out.append(rl.check("t", now=10.0) > 0.0)
    rl.configure("t", rate=5.0, burst=5.0)
    out.append(rl.check("t", now=10.0))
    rl.drop("t")
    out.append(rl.check("t", now=10.0))
    rl.configure("u", rate=1.0, burst=1.0)
    rl.configure("u", rate=0.0)
    out.append(rl.check("u", now=10.0))
    return out


# The reference test's asserted values (tests/test_tenancy.py).
EXPECTED = {
    ledger_admit_reject: [True, True, False, True, 1010],
    ledger_live_fold: [True, False],
    ledger_reregister: [True, True, 5, True, 3],
    ledger_release: [True, False, 0, True],
    ledger_rebuild: [0, 4, 2],
    bucket_burst_refill: [0.0, 0.0, pytest.approx(1.0), 0.0],
    bucket_default_burst: [10.0, 1.0],
    limiter_unconfigured: [0.0, 0.0],
    limiter_configure_drop: [0.0, True, True, 0.0, 0.0, 0.0],
}


@pytest.mark.parametrize("case", list(EXPECTED), ids=lambda f: f.__name__)
def test_quota_primitives_equal_the_reference(case):
    assert twin(case) == EXPECTED[case]


@pytest.mark.parametrize("seed", range(4))
def test_seeded_ledger_sequence_equals_the_reference(seed):
    def case(s, q, b):
        rng = random.Random(seed)
        led = q.QuotaLedger()
        out = []
        for _ in range(300):
            op = rng.random()
            ns = rng.choice("abc")
            job = f"j{rng.randrange(12)}"
            if op < 0.6:
                out.append(led.check_and_reserve(
                    ns, job, rng.randrange(0, 6), rng.randrange(0, 5),
                    rng.choice([0, 8, 12, 20])))
            elif op < 0.9:
                led.release(job)
            else:
                led.rebuild([(f"j{rng.randrange(12)}", rng.choice("abc"),
                              rng.randrange(1, 4)) for _ in range(3)])
            out.append(tuple(led.reserved(n) for n in "abc"))
        return out
    twin(case)


# -- the broker's namespace hooks ----------------------------------------------

def make_eval(s, ns, i, priority=50, type_="service"):
    return s.Evaluation(
        id=f"ev-{ns}-{i:03d}", namespace=ns, priority=priority, type=type_,
        triggered_by="job-register", job_id=f"job-{ns}-{i:03d}",
        status="pending", create_index=i + 1)


def broker_admission(s, q, b):
    br = b.EvalBroker(nack_timeout=0)
    br.set_enabled(True)
    for i in range(3):
        br.enqueue(make_eval(s, "team-a", i))
    out = []
    try:
        br.check_admission(priority=50, namespace="team-a", ns_max_pending=3)
    except b.BrokerLimitError as e:
        out.append((e.namespace, e.limit, e.pending, e.retry_after, str(e)))
        again = b.BrokerLimitError.from_message(str(e))
        out.append((again.namespace, again.limit, again.pending))
    br.check_admission(priority=50, namespace="team-b", ns_max_pending=3)
    br.check_admission(priority=50, namespace="team-a", ns_max_pending=0)
    # The bypass priority is always admitted.
    br.check_admission(priority=100, namespace="team-a", ns_max_pending=1)
    # The global cap names no namespace.
    br.max_pending = 3
    try:
        br.check_admission(priority=50, namespace="team-b")
    except b.BrokerLimitError as e:
        out.append((e.namespace, e.limit, str(e)))
    br.note_quota_reject("team-b")
    br.note_quota_reject("")
    out.append(sorted(br.tenant_counters().items()))
    out.append(br.ns_pending_count("team-a"))
    # An ack lowers the tenant's pending count.
    ev, token = br.dequeue(["service"], 0)
    br.ack(ev.id, token)
    out.append((ev.namespace, br.ns_pending_count("team-a")))
    stats = br.extended_stats()
    out.append((stats["Tenants"], stats["AdmissionRejects"],
                stats["Pending"], stats["Objective"], stats["ByState"]))
    return out


def test_broker_namespace_admission_equals_the_reference():
    got = twin(broker_admission)
    assert got[0][0] == "team-a" and got[0][1] == 3
    counters = dict(got[3])
    assert counters["team-a"] == (3, 0, 0, 1)
    assert counters["team-b"] == (0, 0, 0, 2)


def drf_order(objective, weights, usage, mid_usage=None):
    def case(s, q, b):
        br = b.EvalBroker(nack_timeout=0)
        br.set_objective(objective)
        br.set_enabled(True)
        for ns, w in weights.items():
            br.set_namespace_policy(ns, w, "")
        br.set_cluster_capacity((40000, 80000, 100000, 0))
        br.note_usage_changed(usage)
        for i in range(12):
            for ns in sorted(weights):
                br.enqueue(make_eval(s, ns, i))
        # Every eval is a service eval: one ready queue, so the broker
        # never draws among queues at random.
        order = []
        for k in range(12 * len(weights)):
            if mid_usage is not None and k == 8:
                br.note_usage_changed(mid_usage)
            ev, token = br.dequeue(["service"], 0)
            order.append(ev.id)
            br.ack(ev.id, token)
        tenants = br.extended_stats()["Tenants"]
        return order, {k: (v["Dequeued"], v["Weight"], v["DominantShare"],
                           v["VirtualTime"]) for k, v in tenants.items()}
    return twin(case)


@pytest.mark.parametrize("objective", ["drf", "weighted-rr", "fifo"])
def test_two_namespaces_dequeue_in_the_reference_order(objective):
    order, tenants = drf_order(
        objective, {"prod": 2.0, "batch": 1.0},
        {"prod": (8000, 4096, 0, 0, 16), "batch": (4000, 16384, 0, 0, 8)},
        mid_usage={"batch": (0, 0, 0, 0, 0)})
    assert len(order) == 24 and len(set(order)) == 24
    assert tenants["prod"][0] == tenants["batch"][0] == 12
    if objective == "fifo":
        # Arrival order across tenants.
        assert order[:2] == ["ev-batch-000", "ev-prod-000"]


def test_drf_serves_the_lower_dominant_share_first():
    order, _ = drf_order("drf", {"prod": 2.0, "batch": 1.0},
                         {"prod": (0, 0, 0, 0, 0),
                          "batch": (20000, 0, 0, 0, 10)})
    # batch holds half the cpu: prod drains first.
    assert all(e.startswith("ev-prod") for e in order[:12]), order


def trace_events(s, q, b, tracing):
    tracing.disable()
    tracing.enable()
    try:
        br = b.EvalBroker(nack_timeout=0)
        br.set_enabled(True)
        br.enqueue(make_eval(s, "team-a", 0))
        for kwargs in ({"namespace": "team-a", "ns_max_pending": 1},):
            with pytest.raises(b.BrokerLimitError):
                br.check_admission(priority=50, **kwargs)
        br.max_pending = 1
        with pytest.raises(b.BrokerLimitError):
            br.check_admission(priority=50, namespace="team-b")
        br.note_quota_reject("team-c")
        return [(sp["Name"], {k: v for k, v in sp["Attrs"].items()})
                for sp in tracing.recent(50)
                if sp["Name"] in ("broker.admission_reject",
                                  "broker.quota_reject")]
    finally:
        tracing.disable()


def test_refusal_trace_events_equal_the_reference():
    out = {k: trace_events(*mods[:3], mods[3]) for k, mods in MODS.items()}
    assert out["port"] == out["ref"]
    assert [name for name, _ in out["port"]] == [
        "broker.admission_reject", "broker.admission_reject",
        "broker.quota_reject"]
    assert out["port"][0][1]["namespace"] == "team-a"
    assert out["port"][2][1] == {"namespace": "team-c"}


# -- the server's admission gates ---------------------------------------------

def conv(obj, fn):
    return fn(dataclasses.asdict(obj))


def tenant_job(job_id, ns, count, cpu=None):
    j = jmock.job()
    j.id = j.name = job_id
    j.namespace = ns
    j.task_groups[0].count = count
    if cpu is not None:
        for t in j.task_groups[0].tasks:
            t.resources.cpu = cpu
    return j


def gate_run(kind):
    """Registrations against a live-alloc quota, a node-units quota and a
    pending-eval quota, with no worker: every eval stays pending."""
    port = kind == "port"
    if port:
        srv = Server(ServerConfig(device="cpu", num_schedulers=0,
                                  min_heartbeat_ttl=3600.0))
    else:
        srv = JServer(JServerConfig(num_schedulers=0,
                                    min_heartbeat_ttl=3600.0))
    S = ps if port else js

    def obj(o, fn):
        return conv(o, fn) if port else o

    out = []
    srv.start()
    try:
        for i in range(2):
            n = jmock.node()
            n.id = n.name = f"node-{i}"
            srv.node_register(obj(n, convert.node_from_dict))
        srv.namespace_upsert(S.Namespace(name="live", max_live_allocs=12))
        srv.namespace_upsert(S.Namespace(name="units", quota_node_units=1.0))
        srv.namespace_upsert(S.Namespace(name="pend", max_pending_evals=2))

        def reg(job):
            try:
                _, eval_id = srv.job_register(obj(job, convert.job_from_dict))
                out.append(("ok", job.id, bool(eval_id)))
            except Exception as e:  # noqa: BLE001
                out.append((type(e).__name__, job.id,
                            getattr(e, "namespace", ""), str(e)))

        for i in range(4):
            reg(tenant_job(f"live-{i}", "live", 5))
        reg(tenant_job("units-big", "units", 10))
        reg(tenant_job("units-a", "units", 4))
        reg(tenant_job("units-b", "units", 4))
        reg(tenant_job("units-c", "units", 4))
        srv.job_deregister("units-b")
        reg(tenant_job("units-d", "units", 4))
        for i in range(3):
            reg(tenant_job(f"pend-{i}", "pend", 1))
        reg(tenant_job("other", "other", 50))
        out.append(("reserved",
                    [srv.quota_ledger.reserved(n) for n in
                     ("live", "units", "pend", "other")],
                    [round(srv.node_units_ledger.reserved(n), 9)
                     for n in ("live", "units")]))
        status = srv.namespace_status("units")
        out.append(("status", status["ReservedAllocs"],
                    round(status["ReservedNodeUnits"], 9),
                    status["PendingEvals"], status["Usage"]))
        out.append(("broker", srv.broker_stats()["Tenants"]))
        out.append(("list", sorted(n.name for n in srv.namespace_list())))
        # Evaluating a periodic or parameterized job is refused.
        per = tenant_job("per", "live", 1)
        per.type = "batch"
        per.periodic = js.PeriodicConfig(enabled=True, spec="@daily")
        reg(per)
        try:
            srv.job_evaluate("per")
        except ValueError as e:
            out.append(("evaluate", str(e)))
        srv.namespace_delete("pend")
        out.append(("deleted", sorted(n.name for n in srv.namespace_list())))
        for bad in (S.Namespace(name=""), S.Namespace(name="x",
                                                      dequeue_weight=0)):
            try:
                srv.namespace_upsert(bad)
            except ValueError as e:
                out.append(("invalid", str(e)))
    finally:
        srv.shutdown()
    return out


@pytest.fixture(scope="module")
def gate_runs():
    runs = {}
    for kind in ("ref", "port"):
        with pytest.MonkeyPatch.context() as mp:
            ids = iter(range(10_000))
            structs = js if kind == "ref" else ps
            mp.setattr(structs, "generate_uuid",
                       lambda: f"00000000-0000-0000-0000-{next(ids):012d}")
            runs[kind] = gate_run(kind)
    return runs


def test_admission_gates_equal_the_reference(gate_runs):
    assert gate_runs["port"] == gate_runs["ref"]


def test_admission_gates_refuse_what_they_should(gate_runs):
    out = gate_runs["port"]
    verdict = {r[1]: r[0] for r in out if r[0] in ("ok", "BrokerLimitError")}
    # 12 live allocs: two jobs of 5 fit, the third refused.
    assert [verdict[f"live-{i}"] for i in range(4)] == [
        "ok", "ok", "BrokerLimitError", "BrokerLimitError"]
    assert verdict["units-big"] == "BrokerLimitError"
    assert [verdict[j] for j in ("units-a", "units-b", "units-c",
                                 "units-d")] == [
        "ok", "ok", "BrokerLimitError", "ok"]
    assert [verdict[f"pend-{i}"] for i in range(3)] == [
        "ok", "ok", "BrokerLimitError"]
    assert verdict["other"] == "ok"
    refused = [r for r in out if r[0] == "BrokerLimitError"]
    assert all(r[2] in ("live", "units", "pend") for r in refused)
    reserved = next(r for r in out if r[0] == "reserved")
    # Only a namespace with a live-alloc quota reserves counts; the
    # node-units book holds units-a and units-d, half a node each.
    assert reserved[1] == [10, 0, 0, 0]
    assert reserved[2] == [0, 1.0]


def test_ledger_survives_a_three_server_failover():
    """Reservations held by pending evals on the old leader are rebuilt
    by the new one; a follower's registration over the quota is
    forwarded and refused with the namespace."""
    servers, first = [], None
    for i in range(3):
        srv = Server(ServerConfig(
            device="cpu", node_name=f"tq-{i}", enable_rpc=True,
            bootstrap_expect=3, start_join=[first] if first else [],
            num_schedulers=0, min_heartbeat_ttl=3600.0))
        first = first or srv.config.rpc_advertise
        servers.append(srv)
    for srv in servers:
        srv.start()
    try:
        def leader():
            return next((x for x in servers if x.is_leader()
                         and x.raft.is_raft_leader()), None)

        assert wait_until(lambda: leader() is not None, 60.0)
        old = leader()
        old.namespace_upsert(ps.Namespace(name="t", max_live_allocs=12))
        for i in range(2):
            old.job_register(conv(tenant_job(f"t-{i}", "t", 5),
                                  convert.job_from_dict))
        assert old.quota_ledger.reserved("t") == 10
        index = old.raft.applied_index()
        rest = [x for x in servers if x is not old]
        assert wait_until(lambda: all(x.raft.applied_index() >= index
                                      for x in rest), 30.0)
        old.shutdown()
        assert wait_until(lambda: (x := leader()) is not None
                          and x is not old, 60.0)
        new = leader()
        # The leadership callbacks run after is_leader() turns true: the
        # rebuild lands within them.
        assert wait_until(lambda: new.quota_ledger.reserved("t") == 10,
                          10.0)
        follower = next(x for x in rest if x is not new)
        with pytest.raises(pbroker_mod.BrokerLimitError) as ei:
            follower.job_register(conv(tenant_job("t-2", "t", 5),
                                       convert.job_from_dict))
        assert ei.value.namespace == "t"
        assert new.job_register(conv(tenant_job("t-3", "t", 2),
                                     convert.job_from_dict))[1]
        assert new.quota_ledger.reserved("t") == 12
        assert new.state.job_by_id(None, "t-2") is None
    finally:
        for srv in servers:
            srv.shutdown()
