"""The port's flight-recorder plane (``nomad_tpu_torch/utils/lockcheck.py``,
``contprof.py`` and ``blackbox.py``, and their hooks in the breaker and
the server) against the reference's (``nomad_tpu/utils/``).

- The lock-order sanitizer: the witness of a seeded inversion, RLock
  re-entry and a condition wait, the disarmed fast path, in both packages
  through one driver (never both armed at once); the port wraps only
  locks made by its own files (``PKG_DIR`` followed by a separator).
- The profiler's classifier: the reference's known-stack table
  (``tests/test_contprof.py``) with port paths gives the reference's
  subsystems; the frames that wait on the card land in ``ops.*``; the
  coverage of a synthetic sample set; ``merge_metrics``.
- The recorder: the limiter (per reason, global floor, lifetime cap) on a
  fake clock; one bundle per trip of a ``TorchBatchScheduler`` batch on
  the CPU under an ``ops.kernel_result`` corruption, with the reference's
  reasons and detail keys for a trip and a failed probe; a lock-order
  cycle lands a ``lockcheck.cycle`` bundle; the server's SLO watch; the
  planes armed from ``ServerConfig``.
- ``Status.Metrics`` and ``Event.Since`` over the port's RPC.

Every comparison with the reference gives it a ``KernelCircuitBreaker()``
of its own and asserts it routed nothing through the oracle.
"""
import json
import os
import random
import threading
import time
import types

import jax  # noqa: F401  (the reference computes on the CPU backend)
import pytest

from nomad_tpu import mock as jmock
from nomad_tpu.ops import breaker as jbreaker
from nomad_tpu.utils import blackbox as jblackbox
from nomad_tpu.utils import contprof as jcontprof
from nomad_tpu.utils import lockcheck as jlockcheck
from nomad_tpu_torch import convert
from nomad_tpu_torch.ops import breaker as pbreaker
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.utils import blackbox as pblackbox
from nomad_tpu_torch.utils import contprof as pcontprof
from nomad_tpu_torch.utils import lockcheck as plockcheck
from nomad_tpu_torch.utils import tracing as ptracing

LOCKCHECK = {"ref": jlockcheck, "port": plockcheck}


def wait_until(pred, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


@pytest.fixture
def disarmed():
    """Every plane disarmed after the test, in both packages."""
    yield
    for lc in LOCKCHECK.values():
        lc.disarm()
        lc.reset_waits()
    for bb in (jblackbox, pblackbox):
        bb.disable()
    for cp in (jcontprof, pcontprof):
        cp.disable()
    ptracing.disable()


# ---------------------------------------------------------------------------
# the lock-order sanitizer
# ---------------------------------------------------------------------------


def seeded_inversion(lc, seed):
    """Thread A takes a seeded chain of tracked locks nested; thread B
    (after A is done, so nothing deadlocks) takes the chain's last lock
    and then its first: one inversion.  Returns the graph, the cycle,
    its witness and the assertion's message."""
    lc.arm()
    try:
        lc.reset()
        rng = random.Random(seed)
        names = [f"lk{i}" for i in range(8)]
        rng.shuffle(names)
        chain = names[:rng.randrange(3, 7)]
        locks = {n: lc.make_tracked(n) for n in names}

        def nested(seq):
            if seq:
                with locks[seq[0]]:
                    nested(seq[1:])

        for name, seq in (("lc-A", chain), ("lc-B", [chain[-1], chain[0]])):
            t = threading.Thread(target=nested, args=(seq,), name=name)
            t.start()
            t.join()
        cycle = lc.find_cycle()
        with pytest.raises(lc.LockOrderError) as err:
            lc.assert_acyclic()
        return (sorted(lc.edges().items()), cycle, lc.witness(cycle),
                str(err.value))
    finally:
        lc.disarm()


@pytest.mark.parametrize("seed", [1, 7, 23])
def test_lockcheck_witness_of_a_seeded_inversion(disarmed, seed):
    ref = seeded_inversion(jlockcheck, seed)
    port = seeded_inversion(plockcheck, seed)
    assert port == ref
    assert port[1] is not None and "lock-order cycle" in port[2]


def rlock_and_condition(lc):
    """Re-entry, a condition wait at depth 3 and a nested plain lock: the
    held stacks along the way and the graph."""
    lc.arm()
    try:
        lc.reset()
        r = lc.make_tracked("rl", rlock=True)
        other = lc.make_tracked("other")
        seen = []
        with r:
            with r:
                seen.append(lc.held_tracked())
                cond = threading.Condition(r)
                with cond:
                    cond.wait(timeout=0.01)
                    seen.append(lc.held_tracked())
                seen.append(lc.held_tracked())
                with other:
                    seen.append(lc.held_tracked())
            seen.append(lc.held_tracked())
        seen.append(lc.held_tracked())
        return seen, sorted(lc.edges()), lc.find_cycle()
    finally:
        lc.disarm()


def test_lockcheck_rlock_reentry_and_condition_wait(disarmed):
    ref = rlock_and_condition(jlockcheck)
    port = rlock_and_condition(plockcheck)
    assert port == ref
    assert port[0][-1] == [] and port[1] == [("rl", "other")]


def disarmed_path(lc):
    lc.arm()
    tracked = lc.make_tracked("x")
    lc.disarm()
    with tracked:
        inner = lc.held_tracked()
    plain = threading.Lock()
    return (inner, lc.edges(), lc.armed(), type(plain).__name__,
            threading.Lock is lc._REAL_LOCK)


def test_lockcheck_disarmed_fast_path(disarmed):
    assert disarmed_path(plockcheck) == disarmed_path(jlockcheck) == (
        [], {}, False, "lock", True)


def test_lockcheck_disarm_puts_back_what_arm_replaced(disarmed):
    originals = (threading.Lock, threading.RLock, time.sleep, os.fsync)
    plockcheck.arm()
    assert threading.Lock is not originals[0]
    plockcheck.disarm()
    assert (threading.Lock, threading.RLock, time.sleep,
            os.fsync) == originals
    plockcheck.disarm()     # disarmed: nothing to put back
    assert threading.RLock is originals[1]


def test_port_sanitizer_wraps_only_port_locks(disarmed):
    from nomad_tpu.server.plan_queue import PlanQueue as JPlanQueue
    from nomad_tpu_torch.server.plan_queue import PlanQueue as PPlanQueue

    plockcheck.arm()
    try:
        ref_q, port_q = JPlanQueue(), PPlanQueue()
        assert not isinstance(ref_q._l, plockcheck.TrackedLock)
        assert isinstance(port_q._l, plockcheck.TrackedLock)
        assert port_q._l.name.startswith(
            os.path.join("server", "plan_queue.py") + ":")
        # A file beside the package whose path merely starts with the
        # package's directory is not the package's.
        made = {}
        for fn in (plockcheck.PKG_DIR + "_beside" + os.sep + "x.py",
                   os.path.join(plockcheck.PKG_DIR, "x.py")):
            ns = {}
            exec(compile("import threading\nlk = threading.Lock()\n", fn,
                         "exec"), ns)
            made[fn] = isinstance(ns["lk"], plockcheck.TrackedLock)
        assert list(made.values()) == [False, True]
    finally:
        plockcheck.disarm()


def test_lockcheck_takes_the_real_primitives():
    import _thread

    assert plockcheck._REAL_LOCK is _thread.allocate_lock
    assert plockcheck._REAL_RLOCK is _thread.RLock
    assert type(plockcheck._REAL_SLEEP).__name__ == \
        "builtin_function_or_method"
    assert plockcheck._REAL_FSYNC is os.fsync


# ---------------------------------------------------------------------------
# the profiler's classifier
# ---------------------------------------------------------------------------

REF_ROOT = "/home/x/nomad_tpu"
PORT_ROOT = "/home/x/nomad_tpu_torch"
PY = "/usr/lib/python3.12"

# The reference's known-stack table (tests/test_contprof.py:35-76), paths
# relative to the package.
KNOWN = [
    ([("scheduler/generic_scheduler.py", "process")], "plan.evaluate"),
    ([("codec/gen.py", "pack_Job")], "codec.encode"),
    ([("codec/gen.py", "unpack_Job")], "codec.decode"),
    ([("codec/native.py", "sniff_frame")], "codec.decode"),
    ([("server/raft.py", "apply")], "raft.apply"),
    ([("server/fsm.py", "_apply_plan")], "raft.apply"),
    ([("server/log_codec.py", "append")], "raft.apply"),
    ([("server/plan_apply.py", "_evaluate_plan")], "plan.evaluate"),
    ([("server/plan_apply.py", "_apply_plan")], "plan.apply"),
    ([("server/plan_queue.py", "dequeue")], "plan.apply"),
    ([("server/follower_sched.py", "_forward")], "plan.apply"),
    ([("server/eval_broker.py", "dequeue")], "broker"),
    ([("server/blocked_evals.py", "unblock")], "broker"),
    ([("server/event_broker.py", "publish")], "broker"),
    ([("server/heartbeat.py", "_invalidate")], "broker"),
    ([("tenancy/drf.py", "pick")], "broker"),
    ([("server/worker.py", "_snapshot_state")], "worker.snapshot"),
    ([("server/worker.py", "invoke_scheduler")], "plan.evaluate"),
    ([("ops/batch_sched.py", "_fetch_results")], "ops.fetch"),
    ([("ops/batch_sched.py", "_dispatch_batch")], "ops.dispatch"),
    ([("ops/batch_sched.py", "phase1")], "plan.evaluate"),
    ([("ops/kernels.py", "score_nodes")], "ops.dispatch"),
    ([("ops/pallas_score.py", "scored_rows")], "ops.dispatch"),
    ([("ops/decode.py", "expand_results")], "codec.decode"),
    ([("ops/encode.py", "encode_static")], "ops.dispatch"),
    ([("server/rpc.py", "_serve_conn")], "http"),
    ([("agent/http.py", "metrics_request")], "http"),
    ([("api/client.py", "get")], "http"),
    ([("server/federation.py", "poll")], "federation"),
    ([("loadgen/federation.py", "_drive")], "federation"),
    ([("loadgen/harness.py", "_submit_loop")], "loadgen"),
    # transparent layers walk to the owner; the leaf-most match wins
    ([("structs/structs.py", "to_wire"), ("utils/telemetry.py", "add_sample"),
      ("state/state_store.py", "upsert_allocs"), ("server/fsm.py",
                                                  "_apply_plan")],
     "raft.apply"),
    ([("codec/gen.py", "pack_LogEntry"), ("server/raft.py", "append")],
     "codec.encode"),
]
# Where a file of the reference has another name in the port.
PORT_NAME = {"ops/pallas_score.py": "ops/fused_score.py"}
IDLE = [(f"{PY}/threading.py", "wait"),
        (f"{PY}/threading.py", "_wait_for_tstate_lock"),
        (f"{PY}/selectors.py", "select"), (f"{PY}/socket.py", "accept")]


def rooted(frames, root, names=None):
    return [(f"{root}/{(names or {}).get(rel, rel)}", fn)
            for rel, fn in frames]


@pytest.mark.parametrize("frames,expected", KNOWN)
def test_classifier_known_stacks(frames, expected):
    ref = jcontprof.classify_frames(rooted(frames, REF_ROOT))
    port = pcontprof.classify_frames(rooted(frames, PORT_ROOT, PORT_NAME))
    assert port == ref == expected
    # A literal copy of the reference's rule files every port frame
    # under ``other``.
    assert jcontprof.classify_frames(
        rooted(frames, PORT_ROOT, PORT_NAME)) == "other"


@pytest.mark.parametrize("leaf", IDLE + [
    ("utils/lockcheck.py", "_checked_sleep"),
    ("server/heartbeat.py", "_sweep"), ("utils/contprof.py", "_gil_loop")])
def test_classifier_idle_leaves(leaf):
    stack = [("server/raft.py", "apply")]
    if leaf[0].startswith(PY):
        ref = jcontprof.classify_frames([leaf] + rooted(stack, REF_ROOT))
        port = pcontprof.classify_frames([leaf] + rooted(stack, PORT_ROOT))
    else:
        ref = jcontprof.classify_frames(rooted([leaf] + stack, REF_ROOT))
        port = pcontprof.classify_frames(rooted([leaf] + stack, PORT_ROOT))
    assert port == ref == "idle"


@pytest.mark.parametrize("frames,expected", [
    # A CUDA synchronize under .item() in the placement loop.
    ([("/site-packages/torch/cuda/__init__.py", "synchronize"),
      (f"{PORT_ROOT}/ops/kernels.py", "fused_pass"),
      (f"{PORT_ROOT}/ops/batch_sched.py", "_dispatch_device")],
     "ops.dispatch"),
    # The one D2H copy of a batch's result.
    ([("/site-packages/torch/_tensor.py", "numpy"),
      (f"{PORT_ROOT}/ops/batch_sched.py", "_fetch_together"),
      (f"{PORT_ROOT}/ops/batch_sched.py", "_fetch_device")], "ops.fetch"),
    # The device timer's event read.
    ([(f"{PORT_ROOT}/ops/batch_sched.py", "seconds")], "ops.fetch"),
    ([(f"{PORT_ROOT}/ops/batch_sched.py", "_upload_static")],
     "ops.dispatch"),
    ([(f"{PORT_ROOT}/ops/fused_score.py", "scored_rows")], "ops.dispatch"),
    ([(f"{PORT_ROOT}/ops/xfer.py", "unpack_device")], "ops.fetch"),
    ([(f"{PORT_ROOT}/device.py", "build_kernels")], "ops.dispatch"),
    ([(f"{PORT_ROOT}/parallel/sharded.py", "sharded_fused_pass")],
     "ops.dispatch"),
    ([(f"{PORT_ROOT}/server/server.py", "emit_gauges")], "other"),
    ([("/site-packages/numpy/core.py", "dot")], "other"),
    ([], "other"),
])
def test_classifier_port_frames(frames, expected):
    assert pcontprof.classify_frames(frames) == expected


def test_classifier_coverage_of_a_synthetic_sample_set():
    population = (
        [[("scheduler/rank.py", "score")]] * 30
        + [[("server/raft.py", "apply")]] * 20
        + [[("codec/gen.py", "unpack_Job")]] * 15
        + [[("server/eval_broker.py", "dequeue")]] * 10
        + [[("server/plan_apply.py", "_apply_plan")]] * 10
        + [[("ops/kernels.py", "fused_pass")]] * 5)
    idle = [[(f"{PY}/threading.py", "wait")]] * 40
    foreign = [[("/site-packages/weird.py", "f")]] * 5
    counts = {}
    for mod, root in ((jcontprof, REF_ROOT), (pcontprof, PORT_ROOT)):
        c = {}
        for stack in ([rooted(st, root) for st in population]
                      + idle + foreign):
            sub = mod.classify_frames(stack)
            c[sub] = c.get(sub, 0) + 1
        counts[mod] = (c, mod.ContinuousProfiler._coverage(c))
    assert counts[pcontprof] == counts[jcontprof]
    c, cov = counts[pcontprof]
    assert cov >= 0.80 and cov == round(
        1.0 - c["other"] / (sum(c.values()) - c["idle"]), 4)


def lock_waits_merged(lc, cp):
    lc.arm()
    try:
        lc.reset_waits()
        lk = lc.make_tracked("test.merge")
        for _ in range(5):
            with lk:
                pass
        latest = cp.merge_metrics({})
    finally:
        lc.disarm()
        lc.reset_waits()
    key = "nomad.lock.test.merge.wait_seconds"
    summ = latest["Samples"][key]
    return (sorted(latest), sorted(summ), summ["count"],
            latest["SampleTotals"][key][0])


def test_merge_metrics(disarmed):
    assert pcontprof.merge_metrics({}) == jcontprof.merge_metrics({}) == {}
    assert lock_waits_merged(plockcheck, pcontprof) == \
        lock_waits_merged(jlockcheck, jcontprof) == (
            ["SampleTotals", "Samples"],
            ["count", "max", "mean", "min", "p50", "p95", "p99", "sum"], 5, 5)
    p = pcontprof.enable(hz=100, gil_ms=2.0)
    assert wait_until(lambda: p.window(30)["ThreadSamples"] > 0)
    gauges = pcontprof.merge_metrics({})["Gauges"]
    assert "nomad.runtime.gil_delay_p99_ms" in gauges
    assert any(k.startswith("nomad.cpu.") for k in gauges)


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

# (advance the clock by, reason): per-reason interval 30 s, floor 1 s,
# cap 4.
LIMITER_STEPS = [(0.0, "breaker.open"), (0.5, "breaker.reopen"),
                 (0.6, "breaker.reopen"), (5.0, "breaker.open"),
                 (26.0, "breaker.open"), (0.2, "slo.plan_apply_p99"),
                 (2.0, "slo.plan_apply_p99"), (1.5, "auditor.violation"),
                 (1.5, "lockcheck.cycle"), (40.0, "breaker.open"),
                 (40.0, "breaker.reopen")]


def limiter_verdicts(recorder, clock):
    out = []
    for dt, reason in LIMITER_STEPS:
        clock[0] += dt
        out.append(recorder._admit(reason))
    return out


def test_recorder_limiter_on_a_fake_clock(tmp_path, monkeypatch):
    clock = [100.0]
    ref = jblackbox.FlightRecorder(directory=str(tmp_path / "ref"),
                                   min_interval_s=30.0, max_bundles=4)
    # The reference's limiter reads its module's ``time.perf_counter``.
    monkeypatch.setattr(jblackbox, "time", types.SimpleNamespace(
        perf_counter=lambda: clock[0]))
    want = limiter_verdicts(ref, clock)
    clock[0] = 100.0
    port = pblackbox.FlightRecorder(str(tmp_path / "port"),
                                    min_interval_s=30.0, max_bundles=4,
                                    clock=lambda: clock[0])
    assert limiter_verdicts(port, clock) == want
    assert want.count(True) == 4 and port.suppressed == len(want) - 4


def test_recorder_needs_a_directory():
    with pytest.raises(ValueError):
        pblackbox.FlightRecorder("")


def breaker_bundles(bb, brk_mod, tmp, clock):
    """A trip and a failed probe through a breaker of its own, with the
    recorder's clock faked past the global floor between them."""
    rec = bb.enable(directory=str(tmp), min_interval_s=30.0)
    if hasattr(rec, "clock"):
        rec.clock = lambda: clock[0]
    brk = brk_mod.KernelCircuitBreaker(threshold=0.9, window=8,
                                       min_checks=1, cooldown=5.0,
                                       clock=lambda: clock[0])
    brk.record(False)
    assert wait_until(lambda: len(rec.captured) == 1)
    clock[0] += 10.0
    assert brk.allow_kernel()
    brk.on_probe(False)
    assert wait_until(lambda: len(rec.captured) == 2)
    out = []
    for path in rec.captured:
        with open(path, encoding="utf-8") as fh:
            b = json.load(fh)
        out.append((b["Reason"], b["Detail"]))
    bb.disable()
    return out, brk


def test_breaker_trip_and_reopen_bundles(tmp_path, monkeypatch, disarmed):
    clock = [0.0]
    monkeypatch.setattr(jblackbox, "time", types.SimpleNamespace(
        perf_counter=lambda: clock[0], strftime=time.strftime,
        gmtime=time.gmtime, time=time.time))
    ref, _ = breaker_bundles(jblackbox, jbreaker, tmp_path / "ref", clock)
    clock[0] = 0.0
    port, brk = breaker_bundles(pblackbox, pbreaker, tmp_path / "port",
                                clock)
    assert port == ref == [("breaker.open", {"Agreement": 0.0, "Trips": 1}),
                           ("breaker.reopen", {"Trips": 1})]
    assert brk.trips == 1


def test_one_bundle_per_trip_of_a_cpu_batch(tmp_path, disarmed):
    """The reference's breaker drill and the port's (a corrupt
    ``ops.kernel_result`` in a batch on the CPU, a private breaker on a
    fake clock), each with its recorder armed: one ``breaker.open``
    bundle, whose detail has the same keys; the port's holds the
    tripping batch's ``fault.fire`` span and ``breaker.transition``
    event, and its ``Breaker`` section the private breaker."""
    from nomad_tpu.ops.__main__ import breaker_drill as jdrill
    from nomad_tpu_torch.ops.__main__ import breaker_drill as pdrill

    out = {}
    for name, bb, drill, kwargs in (
            ("ref", jblackbox, jdrill, {}),
            ("port", pblackbox, pdrill, {"device": "cpu"})):
        rec = bb.enable(directory=str(tmp_path / name), min_interval_s=30.0)
        if name == "port":
            ptracing.enable()
            clock = [0.0]
            kwargs["breaker"] = pbreaker.KernelCircuitBreaker(
                threshold=0.9, window=8, min_checks=1, cooldown=5.0,
                clock=lambda: clock[0])
            kwargs["clock"] = clock
        assert drill(seed=3, log=lambda msg: None, **kwargs)
        assert wait_until(lambda: len(rec.captured) == 1)
        bb.note_trigger("breaker.open", {"Trips": 1})
        time.sleep(0.2)
        assert len(rec.captured) == 1
        with open(rec.captured[0], encoding="utf-8") as fh:
            out[name] = json.load(fh)
        bb.disable()
    # The agreement differs with the number of verdicts each package's
    # batch records before the corrupt one (the reference's resident
    # guard records its own); the reason and the detail's keys do not.
    assert [(b["Reason"], sorted(b["Detail"]), b["Detail"]["Trips"])
            for b in out.values()] == [
        ("breaker.open", ["Agreement", "Trips"], 1)] * 2
    assert out["port"]["Detail"]["Agreement"] < 0.9
    bundle = out["port"]
    assert {"Reason", "Detail", "Config", "Spans", "Events", "Profile",
            "Locks", "Threads", "Breaker", "Servers"} <= set(bundle)
    names = [sp["Name"] for sp in bundle["Spans"]]
    assert "fault.fire" in names and "breaker.transition" in names
    assert names.index("fault.fire") < names.index("breaker.transition")
    assert bundle["Breaker"]["Trigger"]["Trips"] == 1
    assert kwargs["breaker"].state == "closed"


def test_lockcheck_cycle_lands_in_a_bundle(tmp_path, disarmed):
    rec = pblackbox.enable(str(tmp_path))
    seeded_inversion(plockcheck, 5)
    assert wait_until(lambda: len(rec.captured) == 1)
    with open(rec.captured[0], encoding="utf-8") as fh:
        bundle = json.load(fh)
    assert bundle["Reason"] == "lockcheck.cycle"
    assert bundle["Detail"]["witness"].startswith("lock-order cycle:")


def test_capture_failure_is_logged_and_counted(tmp_path, caplog):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    rec = pblackbox.FlightRecorder(str(blocker / "sub"))
    assert rec.capture("manual", {}, force=True) is None
    assert rec.failures == 1 and rec.captured == []
    assert "capture of 'manual' failed" in caplog.text


def node_and_job(n_nodes=4):
    nodes, job = [], jmock.job()
    for _ in range(n_nodes):
        node = jmock.node()
        node.resources.networks = []
        node.reserved.networks = []
        nodes.append(node)
    for tg in job.task_groups:
        for t in tg.tasks:
            t.resources.networks = []
    job.task_groups[0].count = 2
    return nodes, job


def port_server(**cfg):
    return Server(ServerConfig(device="cpu", rng_seed=7,
                               min_heartbeat_ttl=3600.0,
                               breaker=pbreaker.KernelCircuitBreaker(),
                               **cfg))


def test_server_arms_the_planes_from_its_config(tmp_path, disarmed):
    srv = port_server(blackbox_dir=str(tmp_path), contprof_hz=20.0,
                      blackbox_min_interval_s=5.0, blackbox_max_bundles=3,
                      broker_max_pending=7, broker_coalesce=False)
    try:
        assert pcontprof.enabled() and pcontprof.PROFILER.hz == 20.0
        rec = pblackbox.recorder()
        assert (rec.directory, rec.min_interval_s, rec.max_bundles) == (
            str(tmp_path), 5.0, 3)
        assert srv in pblackbox._SERVERS
        assert (srv.eval_broker.max_pending,
                srv.eval_broker.coalesce) == (7, False)
        bundle = pblackbox.assemble_bundle("manual")
        assert bundle["Config"]["server-1"]["broker_max_pending"] == 7
        assert bundle["Breaker"]["Servers"] == [
            {"State": "closed", "Trips": 0, "Name": "server-1"}]
        assert [s["Name"] for s in bundle["Servers"]] == ["server-1"]
    finally:
        srv.shutdown()
    assert srv not in pblackbox._SERVERS
    off = port_server()
    try:
        assert (off.eval_broker.max_pending, off.eval_broker.coalesce) == (
            0, True)
    finally:
        off.shutdown()


def slo_bundle(srv, rec, nodes, job, register):
    srv.start()
    try:
        for n in nodes:
            srv.node_register(register(n))
        srv.job_register(register(job))
        assert wait_until(lambda: srv.metrics.sink.latest()["Samples"].get(
            "nomad.plan.apply", {}).get("count"), timeout=60.0)
        if hasattr(srv, "emit_gauges"):
            srv.emit_gauges()
        else:
            srv._watch_plan_slo()
        assert wait_until(lambda: len(rec.captured) == 1)
        with open(rec.captured[0], encoding="utf-8") as fh:
            bundle = json.load(fh)
        return bundle["Reason"], sorted(bundle["Detail"])
    finally:
        srv.shutdown()


def test_slo_watch(tmp_path, monkeypatch, disarmed):
    from nomad_tpu.server import Server as JServer
    from nomad_tpu.server import ServerConfig as JServerConfig

    nodes, job = node_and_job()
    monkeypatch.setenv("NOMAD_TPU_BLACKBOX_SLO_PLAN_P99_MS", "1e-6")
    monkeypatch.setattr(jbreaker, "BREAKER", jbreaker.KernelCircuitBreaker())
    rec = jblackbox.enable(directory=str(tmp_path / "ref"))
    ref = slo_bundle(JServer(JServerConfig(min_heartbeat_ttl=3600.0)), rec,
                     nodes, job, lambda x: x.copy())
    jblackbox.disable()
    srv = port_server(blackbox_dir=str(tmp_path / "port"),
                      slo_plan_p99_ms=1e-6)
    port = slo_bundle(srv, pblackbox.recorder(), nodes, job, _convert)
    assert port == ref == ("slo.plan_apply_p99",
                           ["Count", "Node", "P99Ms", "SloMs"])
    assert jbreaker.BREAKER.trips == 0
    # Off by default: no trigger whatever the p99.
    srv2 = port_server(blackbox_dir=str(tmp_path / "port"))
    try:
        srv2._watch_plan_slo()
    finally:
        srv2.shutdown()


def _convert(obj):
    import dataclasses

    d = dataclasses.asdict(obj)
    if "task_groups" in d:
        return convert.job_from_dict(d)
    return convert.node_from_dict(d)


# ---------------------------------------------------------------------------
# Status.Metrics and Event.Since over the wire
# ---------------------------------------------------------------------------


def test_status_metrics_and_event_since_over_rpc(disarmed):
    from nomad_tpu_torch.server.rpc import ConnPool

    nodes, job = node_and_job()
    srv = port_server(enable_rpc=True, events=True, contprof_hz=50.0)
    pool = ConnPool()
    try:
        srv.start()
        for n in nodes:
            srv.node_register(_convert(n))
        srv.job_register(_convert(job))
        assert wait_until(lambda: len(srv.state.allocs_by_job(
            None, job.id, True)) == 2, timeout=60.0)
        addr = srv.config.rpc_advertise
        assert wait_until(lambda: pcontprof.PROFILER.window(30)[
            "ThreadSamples"] > 0)
        m = pool.call(addr, "Status.Metrics", {}, timeout=10.0)
        assert {"Gauges", "Samples", "Counters", "CounterTotals",
                "SampleTotals"} <= set(m)
        assert "nomad.plan.apply" in m["Samples"]
        assert "nomad.codec.rpc.decode_seconds" in m["Samples"]
        assert "nomad.runtime.gil_delay_p50_ms" in m["Gauges"]
        first = pool.call(addr, "Event.Since", {"MinIndex": 0, "Max": 3},
                          timeout=10.0)
        assert set(first) == {"Events", "Latest", "Armed"}
        assert len(first["Events"]) == 3 and first["Armed"]
        assert set(first["Events"][0]) == {"Topic", "Type", "Key", "Index",
                                           "Payload", "EvalID"}
        rest = pool.call(addr, "Event.Since", {
            "MinIndex": first["Events"][-1]["Index"], "Max": 2048},
            timeout=10.0)
        idx = [e["Index"] for e in first["Events"] + rest["Events"]]
        assert idx == sorted(idx) and idx[-1] == rest["Latest"]
        assert [e for e in rest["Events"] if e["Index"] <= idx[2]] == []
        types_seen = {(e["Topic"], e["Type"]) for e in rest["Events"]}
        assert ("Plan", "PlanApplied") in types_seen
        assert srv.breaker().trips == 0
    finally:
        pool.close()
        srv.shutdown()
