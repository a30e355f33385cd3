"""The port's task and alloc runners, GC and state restore against the
JAX package's, on the mock driver (``nomad_tpu_torch/client/`` against
``nomad_tpu/client/``).

Each scenario of ``tests/test_client.py``'s ``TestTaskRunner``,
``TestAllocRunner`` and ``TestGC`` (and more: artifacts, templates,
restarts on success, recoverable start errors, a vault ask) runs in both
packages on the same mock objects (the port's converted from the
reference's), and the runs are compared without their times: each
reported transition's state and event (type, failed, exit code, signal,
restart reason, sibling), the alloc's folded client status, which alloc
dirs the GC destroyed, and what a client restores from its state dir.

A vault ask: both packages' runners get a vault client whose token
derivation fails (a cluster without vault), and the task fails its
setup with the same message in both.

A running task that is destroyed: the port's run loop emits ``Killing``
before it kills (task_runner.go's order), where the reference's destroy
kills the handle at once and its ``Killing`` shows only when its loop
wakes first.  The reference's events are compared with that ``Killing``
put before a kill that follows ``Started`` (``with_killing``).  Every
wait has a deadline.
"""
import dataclasses
import os
import random
import socket
import threading

import jax  # noqa: F401  (kept like the other port tests)
import pytest

from nomad_tpu import mock as jmock
from nomad_tpu.client import AllocRunner as JAllocRunner
from nomad_tpu.client import Client as JClient
from nomad_tpu.client import ClientConfig as JClientConfig
from nomad_tpu.client import TaskRunner as JTaskRunner
from nomad_tpu.client import allocdir as jallocdir
from nomad_tpu.client import fingerprint as jfp
from nomad_tpu.client import gc as jgc
from nomad_tpu.client import get_client_status as jget_client_status
from nomad_tpu.client import state as jstate
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert
from nomad_tpu_torch.client import AllocRunner as PAllocRunner
from nomad_tpu_torch.client import Client as PClient
from nomad_tpu_torch.client import ClientConfig as PClientConfig
from nomad_tpu_torch.client import TaskRunner as PTaskRunner
from nomad_tpu_torch.client import allocdir as pallocdir
from nomad_tpu_torch.client import fingerprint as pfp
from nomad_tpu_torch.client import gc as pgc
from nomad_tpu_torch.client import get_client_status as pget_client_status
from nomad_tpu_torch.client import state as pstate
from nomad_tpu_torch.structs import structs as ps
from nomad_tpu_torch.utils.backoff import wait_until

SEED = 23
DEADLINE = 20.0


@pytest.fixture
def no_network(monkeypatch):
    """The fingerprints' probes stay on this machine in both packages:
    connections off the loopback are refused and the network
    fingerprint's address is fixed."""
    real = socket.create_connection

    def local_only(address, *args, **kwargs):
        if address[0] not in ("127.0.0.1", "localhost"):
            raise OSError("no network in this test")
        return real(address, *args, **kwargs)

    monkeypatch.setattr(socket, "create_connection", local_only)
    for mod in (jfp, pfp):
        monkeypatch.setattr(mod.NetworkFingerprint, "_default_ip",
                            staticmethod(lambda interface: "10.1.2.3"))


class FailingVault:
    """The reference's vault client on a cluster without vault: every
    derivation fails."""

    def derive_token(self, alloc_id, tasks):
        raise RuntimeError("vault is not enabled on the servers")

    def stop_renew_token(self, token):
        pass


KILLS = ("Killed", "Sibling task failed")
KILL_TIMEOUT = jmock.job().task_groups[0].tasks[0].kill_timeout


def killing(kill_timeout=KILL_TIMEOUT):
    return ("Killing", False, 0, 0, "", "", kill_timeout)


def with_killing(events):
    """The reference's event keys with a ``Killing`` before each kill of a
    running task that lacks one (see the module docstring)."""
    out = []
    for e in events:
        if e[0] in KILLS and out and out[-1][0] == "Started":
            out.append(killing())
        out.append(e)
    return out


def with_killing_updates(updates):
    """``with_killing`` over (task, state, event key) updates: the port
    reports its ``Killing`` with the state running."""
    out = []
    for name, state, ev in updates:
        if ev is not None and ev[0] in KILLS and out and \
                out[-1][2] is not None and out[-1][2][0] == "Started":
            out.append((name, "running", killing()))
        out.append((name, state, ev))
    return out


def ev_key(ev):
    if ev is None:
        return None
    return (ev.type, ev.failed, ev.exit_code, ev.signal, ev.restart_reason,
            ev.failed_sibling, ev.kill_timeout)


# -- the task runner (client/task_runner_test.go) -----------------------------

TASK_CASES = {
    "simple": ("batch", {"run_for": "50ms"}, None),
    "failed_exit": ("batch", {"run_for": "10ms", "exit_code": 1}, None),
    "exit_signal": ("batch", {"run_for": "10ms", "exit_signal": 15,
                              "exit_err_msg": "stopped"}, None),
    "start_error": ("batch", {"start_error": "boom"}, None),
    "recoverable_start_error": (
        "batch", {"start_error": "again", "start_error_recoverable": True},
        dict(attempts=1, interval=60.0, delay=0.01, mode="fail")),
    "restart_within_policy": (
        "batch", {"run_for": "10ms", "exit_code": 1},
        dict(attempts=1, interval=60.0, delay=0.01, mode="fail")),
    "service_restarts_on_success": (
        "service", {"run_for": "10ms"},
        dict(attempts=2, interval=60.0, delay=0.01, mode="fail")),
    "invalid_config": ("batch", {"exit_code": "not-an-int"}, None),
    "artifact": ("batch", {"run_for": "10ms"}, None),
    "artifact_missing": ("batch", {"run_for": "10ms"}, None),
    "template": ("batch", {"run_for": "10ms"}, None),
    "vault": ("batch", {"run_for": "10ms"}, None),
    "destroy": ("batch", {"run_for": "60s"}, None),
}


def task_runner(pkg, tmp, case):
    """One package's runner for ``case``: (runner, updates, task dir)."""
    job_type, config, restart = TASK_CASES[case]
    ref = pkg == "ref"
    alloc = jmock.alloc()
    alloc.id = "a1b2c3d4-0000-0000-0000-000000000001"
    alloc.job.type = job_type
    tg = alloc.job.task_groups[0]
    tg.restart_policy = js.RestartPolicy(
        **(restart or dict(attempts=0, mode="fail")))
    task = tg.tasks[0]
    task.driver = "mock_driver"
    task.config = dict(config)
    task.services = []
    if case.startswith("artifact"):
        src = os.path.join(tmp, "payload.txt")
        with open(src, "w") as fh:
            fh.write("payload")
        task.artifacts = [js.TaskArtifact(
            getter_source=src if case == "artifact" else src + ".missing",
            relative_dest="local/")]
    if case == "template":
        task.templates = [js.Template(
            embedded_tmpl='task={{env "NOMAD_TASK_NAME"}}',
            dest_path="local/rendered.txt")]
    if case == "vault":
        task.vault = js.Vault(policies=["p"])
    node = jmock.node()
    if not ref:
        alloc = convert.alloc_from_dict(dataclasses.asdict(alloc))
        node = convert.node_from_dict(dataclasses.asdict(node))
        task = alloc.job.task_groups[0].tasks[0]
    root = os.path.join(tmp, pkg)
    ad = (jallocdir if ref else pallocdir).AllocDir(
        os.path.join(root, alloc.id))
    ad.build()
    td = ad.new_task_dir(task.name)
    td.build()
    updates = []

    def updater(name, state, event):
        updates.append((name, state, event))

    if ref:
        tr = JTaskRunner(config=JClientConfig(alloc_dir=root), alloc=alloc,
                         task=task, task_dir=td, updater=updater, node=node,
                         vault_client=FailingVault())
        tr.restart_tracker._rand = random.Random(SEED)
    else:
        tr = PTaskRunner(config=PClientConfig(alloc_dir=root), alloc=alloc,
                         task=task, task_dir=td, updater=updater, node=node,
                         rng=random.Random(SEED),
                         vault_client=FailingVault())
    return tr, updates, td


def run_task(tr, updates, case):
    tr.run()
    if case == "destroy":
        assert wait_until(lambda: any(
            u[2] is not None and u[2].type == "Started"
            for u in list(updates)), DEADLINE)
        tr.destroy(type(updates[0][2])(type="Killed"))
    assert tr.done.wait(DEADLINE)
    return [(name, state, ev_key(ev)) for name, state, ev in updates]


@pytest.mark.parametrize("case", sorted(TASK_CASES))
def test_task_runner_events_equal_the_reference(case, tmp_path):
    jtr, jupd, jtd = task_runner("ref", str(tmp_path), case)
    ptr, pupd, ptd = task_runner("port", str(tmp_path), case)
    want = with_killing_updates(run_task(jtr, jupd, case))
    got = run_task(ptr, pupd, case)
    assert got == want
    assert got[-1][1] == ps.TASK_STATE_DEAD
    if case.startswith("artifact") or case == "template":
        assert sorted(os.listdir(ptd.local_dir)) == \
            sorted(os.listdir(jtd.local_dir))
    if case == "template":
        with open(os.path.join(ptd.dir, "local", "rendered.txt")) as fh:
            assert fh.read() == "task=web"
    if case == "vault":
        last = pupd[-1][2]
        assert last.type == ps.TASK_SETUP_FAILURE and last.failed
        assert last.message == jupd[-1][2].message
        assert "vault token derivation failed" in last.message
    assert wait_until(lambda: not ptr.threads(), DEADLINE)


# -- the alloc runner (client/alloc_runner_test.go) ---------------------------

ALLOC_CASES = {
    "single_complete": ("batch", {"web": {"run_for": "50ms"}}),
    "multi_running_destroyed": ("service", {"a": {"run_for": "30s"},
                                            "b": {"run_for": "30s"}}),
    "failed_kills_sibling": ("batch", {"bad": {"run_for": "10ms",
                                               "exit_code": 1},
                                       "good": {"run_for": "60s"}}),
    "two_complete": ("batch", {"a": {"run_for": "10ms"},
                               "b": {"run_for": "30ms"}}),
}


def alloc_runner(pkg, tmp, case, state_db=None):
    job_type, tasks = ALLOC_CASES[case]
    alloc = jmock.alloc()
    alloc.id = f"a1b2c3d4-0000-0000-0000-{len(case):012d}"
    alloc.job.type = job_type
    tg = alloc.job.task_groups[0]
    tg.restart_policy = js.RestartPolicy(attempts=0, mode="fail")
    base = tg.tasks[0]
    tg.tasks = []
    for name, cfg in tasks.items():
        t = base.copy()
        t.name, t.driver, t.config, t.services = name, "mock_driver", cfg, []
        tg.tasks.append(t)
    updates = []
    root = os.path.join(tmp, pkg)
    if pkg == "ref":
        ar = JAllocRunner(config=JClientConfig(alloc_dir=root), alloc=alloc,
                          updater=updates.append, node=jmock.node(),
                          state_db=state_db)
    else:
        ar = PAllocRunner(
            config=PClientConfig(alloc_dir=root),
            alloc=convert.alloc_from_dict(dataclasses.asdict(alloc)),
            updater=updates.append,
            node=convert.node_from_dict(dataclasses.asdict(jmock.node())),
            state_db=state_db, rng=random.Random(SEED))
    return ar, updates


def alloc_outcome(ar, updates, case):
    ar.run()
    if case == "multi_running_destroyed":
        assert wait_until(lambda: updates and len(
            updates[-1].task_states) == 2 and all(
                st.state == "running"
                for st in updates[-1].task_states.values()), DEADLINE)
        ar.destroy()
    assert ar.wait(DEADLINE)
    assert wait_until(lambda: all(
        tr.done.is_set() for tr in list(ar.task_runners.values())), DEADLINE)
    final = ar.current_alloc()
    if isinstance(ar, PAllocRunner):
        # The port's runner is done after its tasks and pushes their last
        # states (the reference's can be done first and miss them,
        # ROADMAP queue 3).
        assert wait_until(lambda: updates and get_status(updates[-1]) ==
                          final.client_status and all(
                              st.state == "dead"
                              for st in updates[-1].task_states.values()),
                          DEADLINE)
    fix = with_killing if isinstance(ar, JAllocRunner) else list
    return (final.client_status,
            {name: (st.state, st.failed, fix([ev_key(e) for e in st.events]))
             for name, st in sorted(final.task_states.items())})


def get_status(alloc):
    return pget_client_status(alloc.task_states) if isinstance(
        alloc, ps.Allocation) else jget_client_status(alloc.task_states)


@pytest.mark.parametrize("case", sorted(ALLOC_CASES))
def test_alloc_runner_equals_the_reference(case, tmp_path):
    want = alloc_outcome(*alloc_runner("ref", str(tmp_path), case), case)
    par, pupd = alloc_runner("port", str(tmp_path), case)
    got = alloc_outcome(par, pupd, case)
    assert got == want
    if case == "failed_kills_sibling":
        assert got[0] == "failed"
        assert ps.TASK_SIBLING_FAILED in [e[0] for e in got[1]["good"][2]]
    assert wait_until(lambda: not par.threads(), DEADLINE)


def states(pkg, spec):
    structs = js if pkg == "ref" else ps
    return {name: structs.TaskState(state=st, failed=failed)
            for name, (st, failed) in spec.items()}


@pytest.mark.parametrize("spec", [
    {}, {"a": ("running", False)}, {"a": ("pending", False)},
    {"a": ("dead", False)}, {"a": ("dead", True), "b": ("running", False)},
    {"a": ("running", False), "b": ("pending", False)},
    {"a": ("dead", False), "b": ("pending", False)},
    {"a": ("dead", False), "b": ("dead", True)}])
def test_get_client_status_equals_the_reference(spec):
    assert pget_client_status(states("port", spec)) == \
        jget_client_status(states("ref", spec))


# -- the GC (client/gc_test.go) ------------------------------------------------

def terminal_runner(pkg, tmp, name):
    ar, _ = alloc_runner(pkg, os.path.join(tmp, name), "single_complete")
    ar.run()
    assert ar.wait(DEADLINE)
    return ar


@pytest.mark.parametrize("case", ["make_room_count", "make_room_disk",
                                  "collect_all", "collect_one",
                                  "no_room_needed"])
def test_gc_equals_the_reference(case, tmp_path):
    out = []
    for pkg, gcmod, cfg_cls in (("ref", jgc, JClientConfig),
                                ("port", pgc, PClientConfig)):
        tmp = str(tmp_path / pkg)
        cfg = cfg_cls(alloc_dir=tmp, gc_max_allocs=2)
        gc = gcmod.AllocGarbageCollector(cfg, stats_path=tmp)
        runners = [terminal_runner(pkg, tmp, n) for n in ("a", "b", "c")]
        for r in runners:
            gc.mark_for_collection(r)
        gc.mark_for_collection(runners[0])   # marked twice: counted once
        if case == "make_room_count":
            gc.make_room_for(0, total_live_allocs=1)
            result = None
        elif case == "make_room_disk":
            gc.make_room_for(1 << 40, total_live_allocs=0)
            result = None
        elif case == "collect_all":
            result = gc.collect_all()
        elif case == "collect_one":
            result = (gc.collect(runners[1].alloc.id),
                      gc.collect("not-marked"))
        else:
            gc.make_room_for(1, total_live_allocs=0)
            result = None
        out.append((result, gc.count(),
                    [os.path.isdir(r.alloc_dir.alloc_dir) for r in runners]))
    assert out[1] == out[0]


# -- the client's state restore (client.go:335 restoreState) ------------------

def restore_world(pkg, tmp, live):
    """A state dir with one alloc's saved runner, read by a new client:
    (the restored runner's outcome, whether the GC holds it)."""
    ref = pkg == "ref"
    alloc = jmock.alloc()
    alloc.id = "a1b2c3d4-0000-0000-0000-0000000000aa"
    alloc.job.type = "batch"
    tg = alloc.job.task_groups[0]
    tg.restart_policy = js.RestartPolicy(attempts=0, mode="fail")
    for t in tg.tasks:
        t.driver, t.config, t.services = "mock_driver", {"run_for": "30ms"}, []
        t.resources.networks = []
    if not live:
        alloc.desired_status = "stop"
    structs = js if ref else ps
    if not ref:
        alloc = convert.alloc_from_dict(dataclasses.asdict(alloc))
    state_dir = os.path.join(tmp, pkg, "state")
    db = (jstate if ref else pstate).StateDB(state_dir)
    saved = structs.TaskState(state="running", events=[
        structs.TaskEvent(type="Received"), structs.TaskEvent(type="Started")])
    db.put_alloc_runner(alloc.id, {"alloc": alloc,
                                   "task_states": {"web": saved},
                                   "handles": {}, "alloc_dir": ""})
    cfg_cls, client_cls = ((JClientConfig, JClient) if ref
                           else (PClientConfig, PClient))
    client = client_cls(cfg_cls(state_dir=state_dir,
                                alloc_dir=os.path.join(tmp, pkg, "allocs")))
    runner = client.get_alloc_runner(alloc.id)
    assert runner is not None
    assert runner.wait(DEADLINE)
    if live:
        assert wait_until(lambda: runner.current_alloc().client_status
                          == "complete", DEADLINE)
    final = runner.current_alloc()
    outcome = (final.client_status,
               {n: (st.state, [ev_key(e) for e in st.events])
                for n, st in final.task_states.items()},
               client.garbage_collector.count(), client.num_allocs())
    if ref:
        client.shutdown()
    else:
        client.shutdown()
        assert wait_until(lambda: not client.threads(), DEADLINE)
    return outcome


@pytest.mark.parametrize("live", [True, False])
def test_restore_state_equals_the_reference(live, tmp_path, no_network):
    want = restore_world("ref", str(tmp_path), live)
    got = restore_world("port", str(tmp_path), live)
    assert got == want
    if live:
        assert [e[0] for e in got[1]["web"][1]] == [
            "Received", "Started", "Received", "Started", "Terminated"]


def test_shutdown_saves_state_and_a_new_client_resumes(tmp_path, no_network):
    """A port client's shutdown saves each runner, stops its task and
    leaves no thread; a client on the same state dir runs the alloc
    again from what was saved."""
    state_dir = str(tmp_path / "state")
    cfg = dict(state_dir=state_dir, alloc_dir=str(tmp_path / "allocs"),
               node_id="node-restore")
    before = set(threading.enumerate())
    c1 = PClient(PClientConfig(**cfg))
    alloc = convert.alloc_from_dict(dataclasses.asdict(jmock.alloc()))
    alloc.job.type = "batch"
    tg = alloc.job.task_groups[0]
    tg.restart_policy = ps.RestartPolicy(attempts=0, mode="fail")
    for t in tg.tasks:
        t.driver, t.config, t.services = "mock_driver", {"run_for": "60s"}, []
    c1._add_alloc(alloc)
    runner = c1.get_alloc_runner(alloc.id)
    assert wait_until(lambda: runner.current_alloc().client_status ==
                      "running", DEADLINE)
    c1.shutdown()
    assert wait_until(lambda: not c1.threads(), DEADLINE)
    assert set(threading.enumerate()) <= before
    saved = pstate.StateDB(state_dir).get_alloc_runner(alloc.id)
    assert [e.type for e in saved["task_states"]["web"].events] == [
        "Received", "Started"]
    c2 = PClient(PClientConfig(**cfg))
    try:
        r2 = c2.get_alloc_runner(alloc.id)
        assert wait_until(lambda: [e.type for e in r2.current_alloc()
                                   .task_states["web"].events].count(
                                       "Started") == 2, DEADLINE)
    finally:
        c2.shutdown()
    assert wait_until(lambda: not c2.threads(), DEADLINE)
