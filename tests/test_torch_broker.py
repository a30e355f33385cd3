"""The port's eval broker, blocked evals and plan queue, each case run on
the reference's class and on the port's copy alike
(``tests/test_server.py::TestEvalBroker`` and more): priority order,
per-job serialization, nack → redeliver → failed, token fencing, the
wait delay, ``dequeue_batch``, the nack-timeout sweep and its pause,
coalescing and admission; blocking by computed class, the missed
unblock, untrack, ``block_preempted``, duplicates and the max-plan
retry; the plan queue's order, its per-job apply fence and the
abandoned-plan race.  Every wait is bounded."""
import time

import pytest

from nomad_tpu.server import blocked_evals as jblocked
from nomad_tpu.server import eval_broker as jbroker
from nomad_tpu.server import plan_queue as jplanq
from nomad_tpu.structs import structs as js
from nomad_tpu_torch.server import blocked_evals as pblocked
from nomad_tpu_torch.server import eval_broker as pbroker
from nomad_tpu_torch.server import plan_queue as pplanq
from nomad_tpu_torch.structs import structs as ps
from nomad_tpu_torch.utils.backoff import wait_until

PKGS = {"ref": (js, jbroker, jblocked, jplanq),
        "port": (ps, pbroker, pblocked, pplanq)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture
def brokers(pkg):
    """Brokers a test makes, each disabled (its sweeper ends) in the
    teardown."""
    made = []

    def make(**kw):
        b = pkg[1].EvalBroker(**kw)
        b.set_enabled(True)
        made.append(b)
        return b

    yield make
    for b in made:
        b.set_enabled(False)


def make_eval(s, job_id=None, priority=50, type_=None, **kw):
    return s.Evaluation(id=s.generate_uuid(), priority=priority,
                        type=type_ or s.JOB_TYPE_SERVICE,
                        triggered_by=s.EVAL_TRIGGER_JOB_REGISTER,
                        job_id=job_id or s.generate_uuid(),
                        status=s.EVAL_STATUS_PENDING, **kw)


def test_enqueue_dequeue_ack(pkg, brokers):
    s = pkg[0]
    b = brokers(nack_timeout=5.0)
    ev = make_eval(s)
    b.enqueue(ev)
    out, token = b.dequeue([s.JOB_TYPE_SERVICE], 1.0)
    assert out.id == ev.id and token
    assert b.outstanding(ev.id) == (token, True)
    assert b.delivery_attempts(ev.id) == 1
    b.ack(ev.id, token)
    assert b.outstanding(ev.id) == ("", False)
    assert b.stats()["total_ready"] == 0


def test_priority_order(pkg, brokers):
    s = pkg[0]
    b = brokers()
    low, high = make_eval(s, priority=20), make_eval(s, priority=90)
    b.enqueue(low)
    b.enqueue(high)
    out, t1 = b.dequeue([s.JOB_TYPE_SERVICE], 1.0)
    assert out.id == high.id
    b.ack(high.id, t1)
    out2, _ = b.dequeue([s.JOB_TYPE_SERVICE], 1.0)
    assert out2.id == low.id


def test_per_job_serialization(pkg, brokers):
    s = pkg[0]
    b = brokers()
    ev1, ev2 = make_eval(s, job_id="same"), make_eval(s, job_id="same")
    b.enqueue(ev1)
    b.enqueue(ev2)
    out1, t1 = b.dequeue([s.JOB_TYPE_SERVICE], 1.0)
    assert b.dequeue([s.JOB_TYPE_SERVICE], 0) == (None, "")
    assert b.stats()["total_blocked"] == 1
    b.ack(out1.id, t1)
    out3, _ = b.dequeue([s.JOB_TYPE_SERVICE], 1.0)
    assert out3.id == ev2.id


def test_nack_redelivers_then_fails(pkg, brokers):
    s = pkg[0]
    b = brokers(nack_timeout=5.0, initial_nack_delay=0.0,
                subsequent_nack_delay=0.0, delivery_limit=2)
    ev = make_eval(s)
    b.enqueue(ev)
    out, token = b.dequeue([s.JOB_TYPE_SERVICE], 1.0)
    b.nack(ev.id, token)
    out, token2 = b.dequeue([s.JOB_TYPE_SERVICE], 1.0)
    assert out.id == ev.id and b.delivery_attempts(ev.id) == 2
    b.nack(ev.id, token2)
    # The delivery limit: the failed queue only.
    assert b.dequeue([s.JOB_TYPE_SERVICE], 0) == (None, "")
    failed, _ = b.dequeue([pkg[1].FAILED_QUEUE], 1.0)
    assert failed.id == ev.id


def test_token_fencing(pkg, brokers):
    s = pkg[0]
    b = brokers()
    ev = make_eval(s)
    b.enqueue(ev)
    _, token = b.dequeue([s.JOB_TYPE_SERVICE], 1.0)
    with pytest.raises(pkg[1].EvalBrokerError):
        b.ack(ev.id, "wrong-token")
    with pytest.raises(pkg[1].EvalBrokerError):
        b.nack(ev.id, "wrong-token")
    b.ack(ev.id, token)
    with pytest.raises(pkg[1].EvalBrokerError):
        b.ack(ev.id, token)


def test_wait_delay(pkg, brokers):
    s = pkg[0]
    b = brokers()
    ev = make_eval(s, wait=0.2)
    b.enqueue(ev)
    assert b.dequeue([s.JOB_TYPE_SERVICE], 0) == (None, "")
    assert b.stats()["total_waiting"] == 1
    out, _ = b.dequeue([s.JOB_TYPE_SERVICE], 5.0)
    assert out.id == ev.id


def test_dequeue_batch_drains_in_priority_order(pkg, brokers):
    s = pkg[0]
    b = brokers()
    evals = [make_eval(s, priority=p) for p in (30, 70, 50, 70, 10)]
    for ev in evals:
        b.enqueue(ev)
    batch = b.dequeue_batch([s.JOB_TYPE_SERVICE], 4, 1.0)
    assert [ev.priority for ev, _ in batch] == [70, 70, 50, 30]
    assert [ev.id for ev, _ in batch][:2] == [evals[1].id, evals[3].id]
    for ev, token in batch:
        b.ack(ev.id, token)
    rest = b.dequeue_batch([s.JOB_TYPE_SERVICE], 4, 1.0)
    assert [ev.id for ev, _ in rest] == [evals[4].id]
    assert b.dequeue_batch([s.JOB_TYPE_SERVICE], 4, 0) == []


def test_nack_timeout_sweep_and_pause(pkg, brokers):
    s = pkg[0]
    b = brokers(nack_timeout=0.1, initial_nack_delay=0.0)
    ev, held = make_eval(s), make_eval(s)
    b.enqueue(ev)
    b.enqueue(held)
    batch = b.dequeue_batch([s.JOB_TYPE_SERVICE], 2, 1.0)
    tokens = {e.id: t for e, t in batch}
    b.pause_nack_timeout(held.id, tokens[held.id])
    # The unpaused delivery expires and is redelivered; the paused one
    # stays outstanding.
    assert wait_until(lambda: b.outstanding(ev.id)[1] is False
                      or b.delivery_attempts(ev.id) == 2, 5.0)
    out, _ = b.dequeue([s.JOB_TYPE_SERVICE], 5.0)
    assert out.id == ev.id and b.delivery_attempts(ev.id) == 2
    assert b.outstanding(held.id) == (tokens[held.id], True)
    with pytest.raises(pkg[1].EvalBrokerError):
        b.ack(ev.id, tokens[ev.id])
    b.resume_nack_timeout(held.id, tokens[held.id])
    b.ack(held.id, tokens[held.id])


def test_coalescing_sheds_a_covered_duplicate(pkg, brokers):
    s = pkg[0]
    b = brokers()
    first = make_eval(s, job_id="job")
    second = make_eval(s, job_id="job", job_modify_index=5)
    third = make_eval(s, job_id="job", job_modify_index=5)
    for ev in (first, second, third):
        b.enqueue(ev)
    assert b.coalesced_total == 1 and b.shed_total == 1
    assert [e.id for e in b.get_shed(0.1)] == [third.id]
    out, token = b.dequeue([s.JOB_TYPE_SERVICE], 1.0)
    b.ack(out.id, token)
    out2, _ = b.dequeue([s.JOB_TYPE_SERVICE], 1.0)
    assert (out.id, out2.id) == (first.id, second.id)


def test_admission_limit_and_bypass(pkg, brokers):
    s = pkg[0]
    b = brokers(max_pending=2)
    b.enqueue(make_eval(s))
    b.enqueue(make_eval(s))
    with pytest.raises(pkg[1].BrokerLimitError) as err:
        b.check_admission(priority=50)
    assert err.value.pending == 2 and err.value.limit == 2
    assert err.value.retry_after > 0
    b.check_admission(priority=s.JOB_MAX_PRIORITY)
    assert b.admission_rejects == 1


def test_disabled_broker_refuses_and_flushes(pkg, brokers):
    s = pkg[0]
    b = brokers()
    b.enqueue(make_eval(s))
    b.set_enabled(False)
    assert b.stats()["total_ready"] == 0
    with pytest.raises(pkg[1].EvalBrokerError):
        b.dequeue([s.JOB_TYPE_SERVICE], 0)


# -- blocked evals ------------------------------------------------------------

@pytest.fixture
def blocked(pkg, brokers):
    b = brokers()
    tracker = pkg[2].BlockedEvals(b)
    tracker.set_enabled(True)
    yield tracker, b
    tracker.set_enabled(False)


def blocked_eval(s, job_id, classes=None, escaped=False, snapshot_index=10,
                 trigger=None):
    ev = make_eval(s, job_id=job_id, class_eligibility=classes or {},
                   escaped_computed_class=escaped,
                   snapshot_index=snapshot_index)
    ev.status = s.EVAL_STATUS_BLOCKED
    if trigger:
        ev.triggered_by = trigger
    return ev


def ready_ids(b, s):
    return {ev.id for ev, _ in b.dequeue_batch([s.JOB_TYPE_SERVICE], 16, 0)}


def test_unblock_by_computed_class(pkg, blocked):
    s = pkg[0]
    tracker, b = blocked
    ineligible = blocked_eval(s, "a", classes={"c1": False, "c2": True})
    eligible = blocked_eval(s, "b", classes={"c1": True})
    escaped = blocked_eval(s, "c", escaped=True)
    for ev in (ineligible, eligible, escaped):
        tracker.block(ev)
    assert tracker.stats() == {"total_blocked": 3, "total_escaped": 1}
    tracker.unblock("c1", 20)
    assert wait_until(lambda: tracker.stats()["total_blocked"] == 1, 5.0)
    got = ready_ids(b, s)
    assert got == {eligible.id, escaped.id}
    tracker.unblock("c2", 21)
    assert wait_until(lambda: tracker.stats()["total_blocked"] == 0, 5.0)
    assert wait_until(lambda: b.stats()["total_ready"] == 1, 5.0)


def test_missed_unblock_requeues_at_once(pkg, blocked):
    s = pkg[0]
    tracker, b = blocked
    tracker.unblock("c1", 30)
    assert wait_until(lambda: tracker._capacity_q.empty(), 5.0)
    late = blocked_eval(s, "late", snapshot_index=20)
    tracker.block(late)
    assert tracker.stats()["total_blocked"] == 0
    assert ready_ids(b, s) == {late.id}


def test_untrack_duplicates_and_max_plan_retry(pkg, blocked):
    s = pkg[0]
    tracker, b = blocked
    first = blocked_eval(s, "job")
    dup = blocked_eval(s, "job")
    tracker.block(first)
    tracker.block(dup)
    assert [e.id for e in tracker.get_duplicates(1.0)] == [dup.id]
    assert tracker.get_duplicates(0.01) == []
    tracker.untrack("job")
    assert tracker.stats()["total_blocked"] == 0
    retry = blocked_eval(s, "plans", trigger=s.EVAL_TRIGGER_MAX_PLANS)
    other = blocked_eval(s, "other")
    tracker.block(retry)
    tracker.block(other)
    tracker.unblock_failed()
    assert tracker.stats()["total_blocked"] == 1
    assert ready_ids(b, s) == {retry.id}


def test_block_preempted_then_capacity(pkg, blocked):
    """The applier hands a preemption's follow-up evals here: tracked
    with no class eligibility, so any capacity change re-admits them,
    carrying the unblock index."""
    s = pkg[0]
    tracker, b = blocked
    follow = s.preemption_follow_up_evals(
        [s.Allocation(id="v1", job_id="victim", node_id="n1")], 40)
    for ev in follow:
        ev.snapshot_index = 41
    tracker.block_preempted(follow)
    assert tracker.stats()["total_blocked"] == 1
    tracker.unblock("any-class", 50)
    assert wait_until(lambda: b.stats()["total_ready"] == 1, 5.0)
    out, _ = b.dequeue([s.JOB_TYPE_SERVICE], 1.0)
    assert out.job_id == "victim" and out.snapshot_index == 50
    assert out.triggered_by == s.EVAL_TRIGGER_PREEMPTION


# -- plan queue ---------------------------------------------------------------

def test_plan_queue_order_and_apply_fence(pkg):
    s, q = pkg[0], pkg[3].PlanQueue()
    with pytest.raises(RuntimeError):
        q.enqueue(s.Plan(priority=1))
    q.set_enabled(True)
    low = q.enqueue(s.Plan(eval_id="low", priority=10))
    high = q.enqueue(s.Plan(eval_id="high", priority=90))
    assert q.depth() == 2
    assert q.dequeue(1.0)[0].eval_id == "high"
    assert q.dequeue(1.0)[0].eval_id == "low"
    assert q.dequeue(0.01) is None
    q.note_applied("j1", 7)
    q.note_applied("j1", 5)
    q.note_applied("", 3)
    assert q.applied_index_for("j1") == 7
    assert q.applied_index_for("j2") == 3
    # Disabling answers every waiter with an error instead of hanging.
    pending = q.enqueue(s.Plan(eval_id="left"))
    q.set_enabled(False)
    with pytest.raises(RuntimeError):
        pending.wait(1.0)
    for fut in (low, high):
        with pytest.raises(TimeoutError):
            fut.wait(0.01)


def test_plan_future_claim_and_cancel(pkg):
    mod = pkg[3]
    fut = mod.PlanFuture()
    assert fut.cancel() and not fut.claim()
    fut2 = mod.PlanFuture()
    assert fut2.claim() and not fut2.cancel()
    fut2.respond("result", None)
    assert fut2.wait(1.0) == "result"
    started = time.monotonic()
    with pytest.raises(TimeoutError):
        mod.PlanFuture().wait(0.05)
    assert time.monotonic() - started < 5.0
