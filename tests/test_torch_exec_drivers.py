"""The port's exec family (``nomad_tpu_torch/client/driver/
exec_drivers.py``, ``executor.py``'s ``LogRotator``, ``cgroups.py``)
against the JAX package's, twins of ``tests/test_client.py::TestRawExec``
and the reference's exec-driver checks.

- Config validation and the java, qemu, docker-CLI, raw_exec and exec
  command lines are equal, exactly, for the same seeded configs and task
  environments.
- The ``LogRotator``'s file names, rotation and purge are equal.
- A ``raw_exec`` task runs through each package's ``TaskRunner``: the
  events (type, exit code, failed), the exit codes and the stdout logs
  are equal.  The ``exec`` driver builds the same ``ExecCommand`` (the
  port's carries its cgroup root too) and runs for real in the port.
- The port's default ``ClientConfig`` creates nothing under
  ``/sys/fs/cgroup`` (listed before and after an ``exec`` task); the
  cgroup code's limits (``memory.max``, ``cpu.weight``, ``cgroup.procs``,
  destroy killing the listed pids) are held against the reference's on a
  v2-shaped tree in ``tmp_path``.  The reference's ``exec`` driver is
  never run for real here: it would create groups under the host's
  ``/sys/fs/cgroup``.
- A client's shutdown leaves a running ``raw_exec`` task running in both
  packages; a new port client on the same state dir re-attaches to it
  and collects what the reference's (still running) runner collects;
  a saved task whose supervisor is gone starts anew, as the reference's.
- The fingerprints (``raw_exec`` gated by ``driver.raw_exec.enable``,
  ``exec``, and ``java``, ``qemu``, ``docker`` through stub binaries on
  ``PATH``) publish the same attributes.
"""
import dataclasses
import json
import os
import random
import signal
import stat
import subprocess

import jax  # noqa: F401  (kept like the other port tests)
import pytest

from nomad_tpu import mock as jmock
from nomad_tpu.client import Client as JClient
from nomad_tpu.client import ClientConfig as JClientConfig
from nomad_tpu.client import TaskRunner as JTaskRunner
from nomad_tpu.client import allocdir as jallocdir
from nomad_tpu.client import state as jstate
from nomad_tpu.client.driver import cgroups as jcgroups
from nomad_tpu.client.driver import driver as jdriver
from nomad_tpu.client.driver import env as jenv
from nomad_tpu.client.driver import exec_drivers as jexec
from nomad_tpu.client.driver import executor as jexecutor
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert
from nomad_tpu_torch.client import Client as PClient
from nomad_tpu_torch.client import ClientConfig as PClientConfig
from nomad_tpu_torch.client import TaskRunner as PTaskRunner
from nomad_tpu_torch.client import allocdir as pallocdir
from nomad_tpu_torch.client import state as pstate
from nomad_tpu_torch.client.driver import cgroups as pcgroups
from nomad_tpu_torch.client.driver import driver as pdriver
from nomad_tpu_torch.client.driver import env as penv
from nomad_tpu_torch.client.driver import exec_drivers as pexec
from nomad_tpu_torch.client.driver import executor as pexecutor
from nomad_tpu_torch.structs import structs as ps
from test_torch_client_runners import no_network  # noqa: F401 (fixture)
from test_torch_supervisor import kill_leftovers, wait_until

DEADLINE = 30.0
PKG = {"ref": (js, jdriver, jenv, jexec, jallocdir, JClientConfig,
               JTaskRunner),
       "port": (ps, pdriver, penv, pexec, pallocdir, PClientConfig,
                PTaskRunner)}


@pytest.fixture(autouse=True)
def no_leftovers(tmp_path):
    yield
    kill_leftovers(tmp_path)


class FakeConfig:
    def __init__(self, options=None):
        self.options = options or {}


def stub(dirpath, name, script):
    """An executable ``name`` in ``dirpath`` running the sh ``script``."""
    os.makedirs(dirpath, exist_ok=True)
    path = os.path.join(dirpath, name)
    with open(path, "w") as fh:
        fh.write("#!/bin/sh\n" + script + "\n")
    os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR | stat.S_IXGRP
             | stat.S_IXOTH)
    return path


# -- validation and command lines --------------------------------------------

CONFIGS = [
    ("raw_exec", {"command": "/bin/echo", "args": ["${NOMAD_TASK_NAME}",
                                                   "$NOMAD_ALLOC_INDEX"]}),
    ("raw_exec", {}),
    ("raw_exec", {"command": 7}),
    ("exec", {"command": "run-${NOMAD_TASK_NAME}", "args": ["a", "b"]}),
    ("java", {"jar_path": "local/app-${NOMAD_TASK_NAME}.jar",
              "jvm_options": ["-Xmx64m"], "args": ["${NOMAD_ALLOC_ID}"]}),
    ("java", {"class": "Main", "class_path": "${NOMAD_TASK_DIR}/lib"}),
    ("java", {"args": ["x"]}),
    ("qemu", {"image_path": "local/img-${NOMAD_TASK_NAME}.qcow2",
              "accelerator": "kvm", "args": ["-smp", "${NOMAD_CPU_LIMIT}"]}),
    ("qemu", {"image_path": "linux.img"}),
    ("qemu", {"accelerator": "kvm"}),
    ("docker", {"image": "redis:${NOMAD_TASK_NAME}", "command": "redis",
                "args": ["--port", "${NOMAD_ALLOC_INDEX}"],
                "labels": {"a": "b"}}),
    ("docker", {"image": "busybox"}),
    ("docker", {"command": "x"}),
]


def verdict(mod, name, cfg):
    try:
        mod.validate_driver_config(name, cfg)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("name,cfg", CONFIGS)
def test_validation_equals_the_reference(name, cfg):
    assert verdict(pdriver, name, cfg) == verdict(jdriver, name, cfg)


def exec_context(pkg, tmp_path, task, alloc):
    """The task dir and environment the task runner would give ``task``
    of ``alloc`` (built for ``pkg``)."""
    m, drv, envmod, _, allocdir, _, _ = PKG[pkg]
    ad = allocdir.AllocDir(str(tmp_path / pkg / alloc.id))
    ad.build()
    td = ad.new_task_dir(task.name)
    td.build()
    b = envmod.Builder()
    b.set_task(task).set_alloc(alloc).set_node(mock_node(pkg))
    b.set_region("global")
    b.set_dirs(td.shared_alloc_dir, td.local_dir, td.secrets_dir)
    return drv.ExecContext(task_dir=td, task_env=b.build())


def mock_node(pkg):
    node = jmock.node()
    node.id = "node-twin"
    return node if pkg == "ref" else convert.node_from_dict(
        dataclasses.asdict(node))


def mock_alloc(pkg, driver, config, job_type="batch", restart=None,
               count=1):
    alloc = jmock.alloc()
    alloc.id = "a1b2c3d4-0000-0000-0000-00000000000a"
    alloc.name = "my-job.web[0]"
    alloc.job.type = job_type
    tg = alloc.job.task_groups[0]
    tg.count = count
    tg.restart_policy = js.RestartPolicy(
        **(restart or dict(attempts=0, mode="fail")))
    task = tg.tasks[0]
    task.driver = driver
    task.config = dict(config)
    task.services = []
    task.kill_timeout = 2.0
    if pkg == "port":
        alloc = convert.alloc_from_dict(dataclasses.asdict(alloc))
    return alloc, alloc.job.task_groups[0].tasks[0]


def command_line(pkg, tmp_path, name, cfg):
    m, drv, _, _, _, _, _ = PKG[pkg]
    alloc, task = mock_alloc(pkg, name, cfg)
    ctx = exec_context(pkg, tmp_path, task, alloc)
    d = drv.new_driver(name, drv.DriverContext(
        driver_name=name, alloc_id=alloc.id, config=FakeConfig()))
    try:
        cmd, args = d.command_line(ctx, task)
    except Exception as e:  # noqa: BLE001 -- an invalid config's error
        return ("error", type(e).__name__, str(e))
    # The task dir differs by package: compare paths relative to it.
    root = str(tmp_path / pkg)
    return (cmd.replace(root, "<root>"),
            [a.replace(root, "<root>") for a in args])


@pytest.mark.parametrize("name,cfg", CONFIGS)
def test_command_line_equals_the_reference(tmp_path, name, cfg):
    ref = command_line("ref", tmp_path, name, cfg)
    port = command_line("port", tmp_path, name, cfg)
    assert port == ref


# -- the log rotator ---------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2, 3])
def test_log_rotator_equals_the_reference(tmp_path, seed):
    rng = random.Random(seed)
    chunks = [bytes(rng.getrandbits(8) for _ in range(rng.randint(1, 90)))
              for _ in range(40)]
    out = {}
    for pkg, mod in (("ref", jexecutor), ("port", pexecutor)):
        d = tmp_path / pkg
        d.mkdir()
        # Leftovers of an earlier run: the rotator continues after them.
        (d / "web.stdout.0").write_bytes(b"old")
        (d / "web.stdout.x").write_bytes(b"not ours")
        rot = mod.LogRotator(str(d), "web.stdout", max_files=3,
                             file_size_mb=1)
        rot.max_bytes = 200
        for c in chunks:
            rot.write(c)
        rot.close()
        out[pkg] = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}
    assert out["port"] == out["ref"]
    names = [f for f in out["port"] if f.startswith("web.stdout.")
             and f.rsplit(".", 1)[1].isdigit()]
    assert len(names) == 3 and "web.stdout.x" in out["port"]


# -- tasks through the task runners -------------------------------------------

TASKS = {
    "echo": ("raw_exec", {"command": "/bin/sh", "args": [
        "-c", 'echo "$NOMAD_ALLOC_INDEX ${NOMAD_TASK_NAME}"; echo e >&2']},
        None),
    "fail_restart": ("raw_exec", {"command": "/bin/sh",
                                  "args": ["-c", "echo run; exit 3"]},
                     dict(attempts=1, interval=3600.0, delay=0.05,
                          mode="fail")),
    "missing": ("raw_exec", {"command": "/nonexistent/bin/task"}, None),
    "succeed_restart": ("raw_exec", {"command": "/bin/sh", "args": [
        "-c", "exit 0"]}, dict(attempts=0, mode="fail")),
}


def read_logs(log_dir):
    return {f: open(os.path.join(log_dir, f), "rb").read()
            for f in sorted(os.listdir(log_dir))}


def run_task(pkg, tmp_path, case, options=None, driver=None,
             config_kwargs=None, logs_done=None):
    """One package's run of ``TASKS[case]``: the reported events (type,
    exit code, failed), the final state and the stdout/stderr logs (once
    ``logs_done(logs)`` holds, if given)."""
    m, drv, _, _, allocdir, config_cls, runner_cls = PKG[pkg]
    name, cfg, restart = TASKS[case]
    alloc, task = mock_alloc(pkg, driver or name, cfg, restart=restart)
    root = str(tmp_path / pkg)
    ad = allocdir.AllocDir(os.path.join(root, alloc.id))
    ad.build()
    td = ad.new_task_dir(task.name)
    td.build()
    updates = []
    config = config_cls(alloc_dir=root, options=dict(
        options if options is not None else {"driver.raw_exec.enable": "1"}),
        **(config_kwargs or {}))
    tr = runner_cls(config=config, alloc=alloc, task=task, task_dir=td,
                    updater=lambda n, st, ev: updates.append((st, ev)),
                    node=mock_node(pkg))
    tr.run()
    assert tr.done.wait(DEADLINE)
    events = [(ev.type, ev.exit_code, ev.failed) for _, ev in updates
              if ev is not None]
    if logs_done is not None:
        wait_until(lambda: logs_done(read_logs(td.log_dir)), DEADLINE)
    logs = read_logs(td.log_dir)
    return {"events": events, "state": updates[-1][0], "logs": logs}


def two_runs(logs):
    return logs.get("web.stdout.0", b"").count(b"run") == 2


@pytest.mark.parametrize("case", sorted(TASKS))
def test_raw_exec_task_equals_the_reference(tmp_path, case):
    """A restarted task reuses its control dir; the reference's launch
    takes the previous run's files for the new run's (``executor.py``),
    so its second run may still be writing when the runner is done: the
    logs are read once both runs have written."""
    done = two_runs if case == "fail_restart" else None
    ref = run_task("ref", tmp_path, case, logs_done=done)
    port = run_task("port", tmp_path, case, logs_done=done)
    assert port == ref
    if case == "echo":
        assert port["logs"] == {"web.stderr.0": b"e\n",
                                "web.stdout.0": b"0 web\n"}
        assert [e[0] for e in port["events"]] == [
            "Received", "Started", "Terminated"]
    if case == "fail_restart":
        assert [e[1] for e in port["events"]
                if e[0] == "Terminated"] == [3, 3]
        assert port["logs"]["web.stdout.0"] == b"run\nrun\n"


def test_raw_exec_disabled_fails_the_start_like_the_reference(tmp_path):
    """Without ``driver.raw_exec.enable`` the driver still starts the
    task (the option gates its fingerprint, so the scheduler never places
    one there), as in the reference."""
    ref = run_task("ref", tmp_path, "echo", options={})
    port = run_task("port", tmp_path, "echo", options={})
    assert port == ref


def captured_exec_command(pkg, tmp_path, monkeypatch, config):
    """The ``ExecCommand`` the ``exec`` driver hands its supervisor, the
    launch itself stubbed (the reference's would join /sys/fs/cgroup)."""
    m, drv, _, execmod, _, _, _ = PKG[pkg]
    seen = []

    def fake_launch(self):
        seen.append(dataclasses.asdict(self.command))
        self.pid = 1
        return 1

    monkeypatch.setattr(execmod.SupervisedExecutor, "launch", fake_launch)
    alloc, task = mock_alloc(pkg, "exec", {"command": "/bin/echo",
                                           "args": ["${NOMAD_TASK_NAME}"]})
    ctx = exec_context(pkg, tmp_path, task, alloc)
    d = drv.new_driver("exec", drv.DriverContext(
        driver_name="exec", alloc_id=alloc.id, config=config))
    d.start(ctx, task)
    cmd = seen[0]
    root = str(tmp_path / pkg)
    return {k: (v.replace(root, "<root>") if isinstance(v, str) else v)
            for k, v in cmd.items() if k != "env"}


def test_exec_driver_builds_the_reference_command(tmp_path, monkeypatch):
    ref = captured_exec_command("ref", tmp_path, monkeypatch,
                                JClientConfig())
    port = captured_exec_command("port", tmp_path, monkeypatch,
                                 PClientConfig(cgroup_root="/x/cg"))
    assert port.pop("cgroup_root") == "/x/cg"
    assert port == ref
    assert port["use_cgroups"] and port["memory_limit_mb"] > 0
    assert port["cgroup_name"] == "a1b2c3d4-web"


def cgroup_tree():
    """Every directory under /sys/fs/cgroup, two levels deep."""
    root = "/sys/fs/cgroup"
    if not os.path.isdir(root):
        return []
    out = []
    for a in sorted(os.listdir(root)):
        pa = os.path.join(root, a)
        if os.path.isdir(pa):
            out.append(a)
            try:
                out += [f"{a}/{b}" for b in sorted(os.listdir(pa))
                        if os.path.isdir(os.path.join(pa, b))]
            except OSError:
                pass
    return out


def test_exec_task_with_the_default_config_creates_no_cgroup(tmp_path):
    """An ``exec`` task through a default ``ClientConfig`` (no
    ``cgroup_root``) runs under the RLIMIT_AS cap and leaves the host's
    cgroup tree as it was."""
    before = cgroup_tree()
    TASKS["exec_echo"] = ("exec", {"command": "/bin/sh", "args": [
        "-c", "ulimit -v; echo done"]}, None)
    try:
        out = run_task("port", tmp_path, "exec_echo", options={})
    finally:
        del TASKS["exec_echo"]
    assert [e[:2] for e in out["events"]] == [
        ("Received", 0), ("Started", 0), ("Terminated", 0)]
    limit_kb, done = out["logs"]["web.stdout.0"].decode().split()
    assert done == "done" and int(limit_kb) == 256 * 1024
    # The RLIMIT_AS cap applies only when no cgroup was made (executor.py),
    # and no group of this task appeared.  (Other tests running at the
    # same time may add or remove the JAX package's groups.)
    made = set(cgroup_tree()) - set(before)
    assert not any("a1b2c3d4" in p for p in made), made


# -- the cgroup code on a fake tree ------------------------------------------

@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    """A v2-shaped cgroup tree in ``tmp_path`` for both packages (the
    reference's root is its module constant, patched for the test)."""
    roots = {}
    for pkg in ("ref", "port"):
        r = tmp_path / f"cg-{pkg}"
        r.mkdir()
        (r / "cgroup.controllers").write_text("cpu memory\n")
        roots[pkg] = str(r)
    monkeypatch.setattr(jcgroups, "CGROUP_ROOT", roots["ref"])
    for mod in (jcgroups, pcgroups):
        monkeypatch.setattr(mod.os, "geteuid", lambda: 0)
    jcgroups.available.cache_clear()
    pcgroups.available.cache_clear()
    yield roots
    jcgroups.available.cache_clear()
    pcgroups.available.cache_clear()


def tree_files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = open(p).read()
    return out


def test_available_needs_a_root(fake_tree):
    assert pcgroups.available("") is False
    assert pcgroups.available(fake_tree["port"]) is True
    assert jcgroups.available() is True
    assert not os.path.exists(os.path.join(fake_tree["port"],
                                           "nomad-tpu-probe"))


@pytest.mark.parametrize("cpu,mem", [(500, 256), (20000, 0), (0, 64)])
def test_limits_written_like_the_reference(fake_tree, cpu, mem):
    jcg = jcgroups.TaskCgroup("a1-web", cpu_mhz=cpu, memory_mb=mem)
    pcg = pcgroups.TaskCgroup("a1-web", cpu_mhz=cpu, memory_mb=mem,
                              root=fake_tree["port"])
    assert jcg.create() is pcg.create() is True
    jcg.add_pid(4242)
    pcg.add_pid(4242)
    assert pcg.pids() == jcg.pids() == [4242]
    files = tree_files(fake_tree["port"])
    assert files == tree_files(fake_tree["ref"])
    group = os.path.join("nomad-tpu", "a1-web")
    assert files[os.path.join(group, "cgroup.procs")] == "4242"
    if mem:
        assert files[os.path.join(group, "memory.max")] == str(mem << 20)
    if cpu:
        assert files[os.path.join(group, "cpu.weight")] == str(
            max(1, min(10000, cpu)))
    assert files["cgroup.subtree_control"] == "+memory +cpu"


def test_destroy_kills_the_listed_pids_like_the_reference(fake_tree):
    procs = {}
    for pkg, cg in (
            ("ref", jcgroups.TaskCgroup("g", memory_mb=32)),
            ("port", pcgroups.TaskCgroup("g", memory_mb=32,
                                         root=fake_tree["port"]))):
        assert cg.create()
        p = subprocess.Popen(["sleep", "30"])
        cg.add_pid(p.pid)
        procs[pkg] = p
        # The fake tree keeps listing a dead pid (a real one drops it),
        # so the kill loop runs out its timeout; the pid stays ours (a
        # zombie) until it is waited for.
        cg.destroy(timeout=0.3)
        assert p.wait(5.0) == -signal.SIGKILL
        assert cg.paths == []


def test_an_empty_root_creates_nothing(tmp_path):
    cg = pcgroups.TaskCgroup("g", cpu_mhz=100, memory_mb=64, root="")
    assert cg.create() is False and cg.paths == []


# -- fingerprints --------------------------------------------------------------

def fingerprint(pkg, name, options=None):
    m, drv, _, _, _, _, _ = PKG[pkg]
    node = m.Node()
    d = drv.new_driver(name, drv.DriverContext(
        driver_name=name, alloc_id="", config=FakeConfig(options)))
    ok = d.fingerprint(node)
    return ok, dict(node.attributes), d.periodic()


@pytest.mark.parametrize("name,options", [
    ("raw_exec", {"driver.raw_exec.enable": "1"}),
    ("raw_exec", {"driver.raw_exec.enable": "true"}),
    ("raw_exec", {}),
    ("exec", {}),
])
def test_fingerprint_equals_the_reference(name, options):
    assert fingerprint("port", name, options) == \
        fingerprint("ref", name, options)


@pytest.mark.parametrize("present", [True, False])
def test_binary_fingerprints_equal_the_reference(tmp_path, monkeypatch,
                                                 present):
    """java, qemu and docker through stub binaries on ``PATH`` (none of
    them installed here), and with none on ``PATH``."""
    bindir = tmp_path / "bin"
    if present:
        stub(bindir, "java", "echo 'openjdk version \"17.0.9\" 2023' >&2")
        stub(bindir, "qemu-system-x86_64", "exit 0")
        stub(bindir, "docker", "echo 24.0.7")
    else:
        bindir.mkdir()
    monkeypatch.setenv("PATH", str(bindir))
    monkeypatch.setenv("DOCKER_HOST", f"unix://{tmp_path}/no-docker.sock")
    for name in ("java", "qemu", "docker"):
        port = fingerprint("port", name)
        assert port == fingerprint("ref", name)
        assert port[0] is present
    if present:
        assert fingerprint("port", "java")[1]["driver.java.version"] == \
            "17.0.9"
        assert fingerprint("port", "docker")[1][
            "driver.docker.version"] == "24.0.7"


def test_docker_cli_task_runs_the_stub_like_the_reference(tmp_path,
                                                          monkeypatch):
    """The docker CLI driver (no daemon socket) runs ``docker run ...``
    under the supervisor; a stub ``docker`` prints its arguments."""
    bindir = tmp_path / "bin"
    stub(bindir, "docker", 'for a in "$@"; do echo "$a"; done')
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    monkeypatch.setenv("DOCKER_HOST", f"unix://{tmp_path}/no-docker.sock")
    TASKS["docker"] = ("docker", {"image": "busybox:1", "command": "echo",
                                  "args": ["${NOMAD_TASK_NAME}"]}, None)
    try:
        out = {pkg: run_task(pkg, tmp_path, "docker") for pkg in PKG}
    finally:
        del TASKS["docker"]
    lines = {pkg: o["logs"]["web.stdout.0"].decode().splitlines()
             for pkg, o in out.items()}
    # The container name ends in the task dir's name; the -e pairs carry
    # each package's own paths.
    for pkg in lines:
        root = str(tmp_path / pkg)
        lines[pkg] = [ln.replace(root, "<root>") for ln in lines[pkg]]
    assert lines["port"] == lines["ref"]
    assert lines["port"][:3] == ["run", "--rm", "--name"]
    assert lines["port"][-3:] == ["busybox:1", "echo", "web"]
    assert out["port"]["events"] == out["ref"]["events"]


def test_exec_handle_lists_and_ends_its_threads(tmp_path):
    """The port's handle lists the executor's watcher while the task
    runs and nothing once it is collected (a client's shutdown joins
    what it lists)."""
    alloc, task = mock_alloc("port", "raw_exec", {
        "command": "/bin/sh", "args": ["-c", "sleep 30"]})
    ctx = exec_context("port", tmp_path, task, alloc)
    d = pdriver.new_driver("raw_exec", pdriver.DriverContext(
        driver_name="raw_exec", alloc_id=alloc.id, config=FakeConfig()))
    h = d.start(ctx, task).handle
    assert [t.name for t in h.threads()] == ["exec-watch-web"]
    h.kill()
    assert h.wait_ch().wait(DEADLINE)
    assert h.wait_result().signal == signal.SIGINT
    assert h.threads() == []
    assert not pexecutor.pid_alive(h.executor.supervisor_pid)
    assert not pexecutor.pid_alive(h.executor.pid)


def test_restarted_run_reports_its_own_exit_code(tmp_path):
    """A restarted task reuses its control dir: the port's launch clears
    the last run's ``task.pid`` and ``exit.json`` first, so the second
    run's ``Terminated`` carries the second run's code (the JAX
    package's launch may report the first run's again)."""
    marker = tmp_path / "ran-once"
    TASKS["two_codes"] = ("raw_exec", {"command": "/bin/sh", "args": [
        "-c", f"if [ -f {marker} ]; then exit 4; fi; touch {marker}; "
        "exit 3"]}, dict(attempts=1, interval=3600.0, delay=0.05,
                         mode="fail"))
    try:
        out = run_task("port", tmp_path, "two_codes")
    finally:
        del TASKS["two_codes"]
    assert [e[1] for e in out["events"] if e[0] == "Terminated"] == [3, 4]
    assert out["state"] == "dead"


# -- a client's shutdown and restore ------------------------------------------

GATED = ('echo "$NOMAD_ALLOC_INDEX ${{NOMAD_TASK_NAME}}"; '
         'while [ ! -e {gate} ]; do sleep 0.05; done; exit 3')


def gated_alloc(pkg, gate):
    """A batch alloc whose raw_exec task echoes, waits for ``gate`` and
    exits 3 (no restart)."""
    alloc = jmock.alloc()
    alloc.id = "a1b2c3d4-0000-0000-0000-0000000000ee"
    alloc.job.type = "batch"
    tg = alloc.job.task_groups[0]
    tg.restart_policy = js.RestartPolicy(attempts=0, mode="fail")
    for t in tg.tasks:
        t.driver, t.services = "raw_exec", []
        t.config = {"command": "/bin/sh",
                    "args": ["-c", GATED.format(gate=gate)]}
        t.resources.networks = []
    if pkg == "ref":
        return alloc
    return convert.alloc_from_dict(dataclasses.asdict(alloc))


def test_raw_exec_task_outlives_a_client_shutdown_like_the_reference(
        tmp_path, no_network):
    """A client's shutdown leaves a running raw_exec task running, in
    both packages.  The reference's runner threads run on past its
    shutdown and collect the task; the port's end with the shutdown, and
    a new port client on the same state dir re-attaches to the task (its
    saved ``sup:`` handle) and collects it: the same events, exit code
    and log as the reference's, the task run once."""
    out = {}
    for pkg, (cfg_cls, client_cls) in (("ref", (JClientConfig, JClient)),
                                       ("port", (PClientConfig, PClient))):
        base = tmp_path / pkg
        gate = base / "gate"
        cfg = dict(state_dir=str(base / "state"),
                   alloc_dir=str(base / "allocs"),
                   options={"driver.raw_exec.enable": "1"})
        c1 = client_cls(cfg_cls(**cfg))
        alloc = gated_alloc(pkg, gate)
        c1._add_alloc(alloc)
        runner = c1.get_alloc_runner(alloc.id)
        ctl = os.path.join(runner.alloc_dir.alloc_dir, "web", ".web.executor")
        pid_file = os.path.join(ctl, "task.pid")
        assert wait_until(lambda: runner.current_alloc().client_status
                          == "running" and os.path.exists(pid_file),
                          DEADLINE)
        with open(pid_file) as fh:
            task_pid = json.load(fh)["pid"]
        c1.shutdown()
        c2 = None
        if pkg == "port":
            assert wait_until(lambda: not c1.threads(), DEADLINE)
            saved = pstate.StateDB(cfg["state_dir"]).get_alloc_runner(
                alloc.id)
            assert saved["handles"] == {"web": f"sup:{ctl}"}
        assert pexecutor.pid_alive(task_pid)
        gate.touch()
        if pkg == "port":
            assert wait_until(lambda: os.path.exists(
                os.path.join(ctl, "exit.json")), DEADLINE)
            c2 = PClient(PClientConfig(**cfg))
            runner = c2.get_alloc_runner(alloc.id)
        assert wait_until(lambda: runner.current_alloc().client_status
                          == "failed", DEADLINE)
        final = runner.current_alloc()
        out[pkg] = (final.client_status,
                    {n: [(e.type, e.exit_code, e.failed) for e in st.events]
                     for n, st in final.task_states.items()},
                    read_logs(os.path.join(runner.alloc_dir.alloc_dir,
                                           "alloc", "logs")))
        if c2 is not None:
            c2.shutdown()
            assert wait_until(lambda: not c2.threads(), DEADLINE)
            assert wait_until(lambda: not pexecutor.pid_alive(task_pid),
                              DEADLINE)
    assert out["port"] == out["ref"]
    assert out["port"][1]["web"] == [
        ("Received", 0, False), ("Started", 0, False),
        ("Terminated", 3, False), ("Not Restarting", 0, True)]
    assert out["port"][2]["web.stdout.0"] == b"0 web\n"


def test_restored_task_whose_supervisor_is_gone_starts_anew_like_the_reference(
        tmp_path, no_network):
    """A saved running raw_exec task whose control dir is gone: the
    port's re-attach fails and the task starts anew, received again, as
    the reference's restored runner starts every task anew."""
    out = {}
    for pkg, (structs, db_mod, cfg_cls, client_cls) in (
            ("ref", (js, jstate, JClientConfig, JClient)),
            ("port", (ps, pstate, PClientConfig, PClient))):
        base = tmp_path / pkg
        alloc = gated_alloc(pkg, base / "gate")
        (base / "gate").parent.mkdir(parents=True, exist_ok=True)
        (base / "gate").touch()
        db = db_mod.StateDB(str(base / "state"))
        saved = structs.TaskState(state="running", events=[
            structs.TaskEvent(type="Received"),
            structs.TaskEvent(type="Started")])
        db.put_alloc_runner(alloc.id, {
            "alloc": alloc, "task_states": {"web": saved},
            "handles": {"web": f"sup:{base / 'gone'}"}, "alloc_dir": ""})
        client = client_cls(cfg_cls(state_dir=str(base / "state"),
                                    alloc_dir=str(base / "allocs"),
                                    options={"driver.raw_exec.enable": "1"}))
        runner = client.get_alloc_runner(alloc.id)
        assert wait_until(lambda: runner.current_alloc().client_status
                          == "failed", DEADLINE)
        final = runner.current_alloc()
        out[pkg] = [(e.type, e.exit_code) for e in
                    final.task_states["web"].events]
        client.shutdown()
    assert out["port"] == out["ref"] == [
        ("Received", 0), ("Started", 0), ("Received", 0), ("Started", 0),
        ("Terminated", 3), ("Not Restarting", 0)]
