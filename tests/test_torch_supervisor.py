"""The port's supervised executor (``nomad_tpu_torch/client/driver/
executor.py`` and ``supervisor.py``) against the JAX package's, twins of
``tests/test_supervisor.py``.

Each scenario runs a real task (``/bin/sh``) under each package's
detached supervisor and compares what the "agent" collects: exit codes,
signals, stdout, the socket protocol's replies, the exit status after
the agent died (a child process that launched the task and was killed)
and re-attach through the driver's ``sup:`` handle id.

Also shown here: the port's supervisor interpreter is the port's own
module and maps no torch library (``/proc/<pid>/cmdline`` and
``/proc/<pid>/maps``), and its task's pid is known within 5 s; and the
port's departures: once the agent has the result, the port's supervisor
is gone, where the reference's lingers 60 s (``supervisor.py``), and a
detached executor (a client's shutdown) leaves its task running.

Every test's leftovers (a supervisor or task a failing test left alive)
are killed by the ``no_leftovers`` fixture: a process is killed only if
its command line names one of the test's control dirs or its working
directory is inside the test's directory.
"""
import json
import os
import signal
import subprocess
import sys
import time

import jax  # noqa: F401  (kept like the other port tests)
import pytest

from nomad_tpu.client.driver import exec_drivers as jexec
from nomad_tpu.client.driver import executor as jexecutor
from nomad_tpu.client.driver import supervisor as jsup
from nomad_tpu_torch.client.driver import exec_drivers as pexec
from nomad_tpu_torch.client.driver import executor as pexecutor
from nomad_tpu_torch.client.driver import supervisor as psup
from nomad_tpu_torch.client.driver.executor import pid_alive

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"ref": (jexecutor, jsup, jexec), "port": (pexecutor, psup, pexec)}
WAIT = 20.0


def wait_until(fn, timeout=WAIT, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


def _read(path):
    try:
        with open(path, "rb") as fh:
            return fh.read()
    except OSError:
        return b""


def kill_leftovers(root):
    """Kill every supervisor and task of the control dirs under ``root``
    that is still alive (and any process whose command line names a
    path under ``root``: a supervisor of an earlier run of a task, whose
    pid file was overwritten), and remove their private socket dirs."""
    root = os.path.realpath(str(root))
    for entry in os.listdir("/proc"):
        if entry.isdigit() and int(entry) != os.getpid() and \
                (root + os.sep).encode() in _read(f"/proc/{entry}/cmdline"):
            try:
                os.kill(int(entry), signal.SIGKILL)
            except OSError:
                pass
    for dirpath, _, files in os.walk(root):
        for name in ("task.pid", "supervisor.pid"):
            if name not in files:
                continue
            try:
                pid = json.loads(_read(os.path.join(dirpath, name)))["pid"]
            except (ValueError, KeyError, TypeError):
                continue
            try:
                cwd = os.path.realpath(os.readlink(f"/proc/{pid}/cwd"))
            except OSError:
                cwd = ""
            ours = (dirpath.encode() in _read(f"/proc/{pid}/cmdline")
                    or cwd == root or cwd.startswith(root + os.sep))
            if ours:
                for kill in (os.killpg, os.kill):
                    try:
                        kill(pid, signal.SIGKILL)
                    except OSError:
                        pass
        if "sock.path" in files:
            spath = _read(os.path.join(dirpath, "sock.path")).decode()
            for p in (spath, os.path.dirname(spath)):
                try:
                    (os.unlink if p == spath else os.rmdir)(p)
                except OSError:
                    pass


@pytest.fixture(autouse=True)
def no_leftovers(tmp_path):
    yield
    kill_leftovers(tmp_path)


def mk_cmd(executor_mod, base, script, name="t"):
    os.makedirs(base, exist_ok=True)
    return executor_mod.ExecCommand(
        cmd="/bin/sh", args=["-c", script],
        env={"PATH": os.environ.get("PATH", "")},
        cwd=str(base), task_name=name, log_dir=os.path.join(base, "logs"))


def launch(pkg, tmp_path, script, name="t"):
    executor_mod = PKGS[pkg][0]
    base = str(tmp_path / pkg)
    ex = executor_mod.SupervisedExecutor(
        mk_cmd(executor_mod, base, script, name), os.path.join(base, "ctl"))
    ex.launch()
    return ex


def result(ex):
    assert ex.exited.wait(WAIT)
    return (ex.result.exit_code, ex.result.signal)


def both(tmp_path, script, name="t"):
    """Run ``script`` under each package's supervisor; (ref, port)."""
    exs = {pkg: launch(pkg, tmp_path, script, name) for pkg in PKGS}
    return result(exs["ref"]), result(exs["port"])


@pytest.mark.parametrize("code", [0, 1, 7, 127])
def test_exit_code_collected_like_the_reference(tmp_path, code):
    ref, port = both(tmp_path, f"exit {code}")
    assert ref == port == (code, 0)


def test_logs_flow_through_the_supervisor_like_the_reference(tmp_path):
    ref, port = both(tmp_path, "echo hello-from-task; echo oops >&2")
    assert ref == port == (0, 0)
    for pkg in PKGS:
        logs = tmp_path / pkg / "logs"
        assert sorted(os.listdir(logs)) == ["t.stderr.0", "t.stdout.0"]
        assert (logs / "t.stdout.0").read_bytes() == b"hello-from-task\n"
        assert (logs / "t.stderr.0").read_bytes() == b"oops\n"


def test_signal_and_stats_via_the_socket_like_the_reference(tmp_path):
    out = {}
    for pkg in PKGS:
        ready = tmp_path / f"ready-{pkg}"
        ex = launch(pkg, tmp_path,
                    f"trap 'exit 42' USR1; touch {ready}; "
                    f"while :; do sleep 0.05; done")
        assert wait_until(ready.exists)
        stats = ex.stats()
        assert stats["pid"] == ex.pid and stats["rss_bytes"] > 0
        ex.send_signal(signal.SIGUSR1)
        out[pkg] = result(ex)
    assert out["ref"] == out["port"] == (42, 0)


def test_shutdown_grace_like_the_reference(tmp_path):
    out = {}
    for pkg in PKGS:
        ex = launch(pkg, tmp_path, "sleep 120")
        t0 = time.monotonic()
        ex.shutdown(grace=3.0)
        out[pkg] = result(ex)
        assert time.monotonic() - t0 < 8.0
    # sleep dies of the SIGINT the shutdown sends its process group.
    assert out["ref"] == out["port"] == (0, signal.SIGINT)


AGENT = """
import json, os, sys
sys.path.insert(0, {root!r})
if {pkg!r} == "ref":
    from nomad_tpu.client.driver.executor import ExecCommand, SupervisedExecutor
else:
    from nomad_tpu_torch.client.driver.executor import (ExecCommand,
                                                        SupervisedExecutor)
cmd = ExecCommand(cmd="/bin/sh", args=["-c", {script!r}],
                  env={{"PATH": os.environ.get("PATH", "")}}, cwd={base!r},
                  task_name="t", log_dir=os.path.join({base!r}, "logs"))
ex = SupervisedExecutor(cmd, os.path.join({base!r}, "ctl"))
print(json.dumps({{"pid": ex.launch()}}), flush=True)
os._exit(0)
"""


def agent_dies(pkg, tmp_path, script):
    """Launch ``script`` under ``pkg``'s supervisor from a child process
    that then exits at once (the agent dies); the control dir and the
    task's pid."""
    base = str(tmp_path / pkg)
    os.makedirs(base, exist_ok=True)
    proc = subprocess.run(
        [sys.executable, "-c", AGENT.format(root=ROOT, pkg=pkg,
                                            script=script, base=base)],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    return os.path.join(base, "ctl"), json.loads(proc.stdout)["pid"]


def test_task_survives_agent_death_and_exit_code_is_collected(tmp_path):
    """The agent dies while the task runs; the task keeps running under
    its supervisor, and a restarted agent re-attaches by control dir and
    collects its exact exit code."""
    out = {}
    for pkg in PKGS:
        marker = tmp_path / f"ran-{pkg}"
        ctl, task_pid = agent_dies(pkg, tmp_path,
                                   f"touch {marker}; sleep 2; exit 9")
        assert wait_until(marker.exists)
        assert pid_alive(task_pid)
        ex = PKGS[pkg][0].attach_supervised(ctl)
        assert ex is not None
        out[pkg] = result(ex)
    assert out["ref"] == out["port"] == (9, 0)


def test_reattach_after_task_finished_while_agent_down(tmp_path):
    """The exit status persists on disk (exit.json): a task that ended
    before the agent returned is collected exactly."""
    out = {}
    for pkg in PKGS:
        ctl, _ = agent_dies(pkg, tmp_path, "exit 5")
        assert wait_until(lambda: os.path.exists(
            os.path.join(ctl, "exit.json")))
        ex = PKGS[pkg][0].attach_supervised(ctl)
        assert ex is not None
        out[pkg] = result(ex)
    assert out["ref"] == out["port"] == (5, 0)


def test_attach_to_nothing_returns_none(tmp_path):
    for executor_mod, _, _ in PKGS.values():
        assert executor_mod.attach_supervised(str(tmp_path / "nope")) is None
        assert executor_mod.attach(2 ** 22 + 12345) is None


def test_driver_handle_roundtrip(tmp_path):
    """The ``sup:<ctl_dir>`` handle id re-attaches through the driver's
    ``open``, the path a restored task runner takes."""
    from nomad_tpu.client.driver import driver as jdriver
    from nomad_tpu_torch.client.driver import driver as pdriver

    out = {}
    for pkg, drv in (("ref", jdriver), ("port", pdriver)):
        ex = launch(pkg, tmp_path, "sleep 30")
        handle = PKGS[pkg][2].ExecutorHandle(ex, "t", 5.0)
        hid = handle.id()
        assert hid == f"sup:{ex.ctl_dir}"
        d = drv.new_driver("raw_exec", drv.DriverContext(
            driver_name="raw_exec", alloc_id="a1", config=None))
        h2 = d.open(None, hid)
        h2.kill()
        assert h2.wait_ch().wait(WAIT)
        out[pkg] = (h2.wait_result().exit_code, h2.wait_result().signal)
        assert result(ex) == out[pkg]
        with pytest.raises(drv.DriverError):
            d.open(None, "bogus:1")
    assert out["ref"] == out["port"] == (0, signal.SIGINT)


@pytest.mark.parametrize("req", [{"op": "ping"}, {"op": "nosuch"},
                                 {"op": "signal", "sig": 0}])
def test_socket_protocol_replies_like_the_reference(tmp_path, req):
    replies = {}
    for pkg in PKGS:
        ex = launch(pkg, tmp_path, "sleep 30")
        resp = PKGS[pkg][1].request(ex.ctl_dir, req)
        if "pid" in resp:
            assert resp["pid"] == ex.pid
            resp["pid"] = "task"
        replies[pkg] = resp
        ex.shutdown(grace=2.0)
        result(ex)
    assert replies["ref"] == replies["port"]


def test_deep_control_dir_past_the_socket_path_limit(tmp_path):
    """A control dir deeper than AF_UNIX's 108 bytes: the socket lives
    in a short private dir, so the protocol still works."""
    out = {}
    for pkg in PKGS:
        executor_mod, sup, _ = PKGS[pkg]
        base = str(tmp_path / pkg / ("d" * 60) / ("e" * 60))
        ex = executor_mod.SupervisedExecutor(
            mk_cmd(executor_mod, base, "sleep 0.5; exit 3"),
            os.path.join(base, "ctl"))
        ex.launch()
        assert len(ex.ctl_dir) > 108
        assert sup.request(ex.ctl_dir, {"op": "ping"})["ok"] is True
        assert len(sup.sock_path(ex.ctl_dir)) < 108
        out[pkg] = result(ex)
    assert out["ref"] == out["port"] == (3, 0)


def test_port_supervisor_is_its_own_and_loads_no_torch(tmp_path):
    """The port's supervisor, started as ``SupervisedExecutor.launch``
    starts it: its command line names the port's module (never the JAX
    package's), its interpreter maps no torch library, and the task's
    pid is known within 5 s."""
    t0 = time.monotonic()
    ex = launch("port", tmp_path, "sleep 30")
    launched_s = time.monotonic() - t0
    assert ex.pid > 0 and launched_s < 5.0
    cmdline = _read(f"/proc/{ex.supervisor_pid}/cmdline").split(b"\0")
    assert cmdline[1:4] == [b"-S", b"-m",
                            b"nomad_tpu_torch.client.driver.supervisor"]
    assert cmdline[4] == ex.ctl_dir.encode()
    assert not any(arg.startswith(b"nomad_tpu.") for arg in cmdline)
    maps = _read(f"/proc/{ex.supervisor_pid}/maps").decode()
    assert maps and "libtorch" not in maps and "libc10" not in maps
    assert "python" in maps
    ex.shutdown(grace=2.0)
    assert result(ex) == (0, signal.SIGINT)


def test_port_supervisor_exits_once_its_result_is_collected(tmp_path):
    """The port's departure: when ``exited`` is set the supervisor (and
    the task) are gone; the reference's supervisor lingers 60 s after
    its task, serving a socket nobody asks."""
    exs = {pkg: launch(pkg, tmp_path, "exit 4") for pkg in PKGS}
    for pkg, ex in exs.items():
        assert result(ex) == (4, 0)
        assert not pid_alive(ex.pid)
    assert not pid_alive(exs["port"].supervisor_pid)
    assert exs["port"].threads() == [] or wait_until(
        lambda: exs["port"].threads() == [], 2.0)
    assert pid_alive(exs["ref"].supervisor_pid)
    # The port's status stays collectable from disk.
    again = pexecutor.attach_supervised(exs["port"].ctl_dir)
    assert result(again) == (4, 0)


def test_port_supervisor_is_the_agents_child_and_is_reaped(tmp_path):
    """The agent starts each supervisor itself, as the reference's does,
    and reaps it once the result is collected: no zombie is left."""
    exs = {pkg: launch(pkg, tmp_path / pkg, "sleep 30") for pkg in PKGS}
    for ex in exs.values():
        stat = _read(f"/proc/{ex.supervisor_pid}/stat").decode()
        assert int(stat[stat.rindex(")") + 2:].split()[1]) == os.getpid()
        ex.shutdown(grace=2.0)
    assert result(exs["ref"]) == result(exs["port"]) == (0, signal.SIGINT)
    assert wait_until(lambda: not os.path.exists(
        f"/proc/{exs['port'].supervisor_pid}"), 5.0)


def test_detached_task_runs_on_and_is_collected_like_the_reference(
        tmp_path):
    """``detach`` (a client's shutdown) ends the port's watch and leaves
    the task and its supervisor running; re-attaching later collects the
    exit code the reference's re-attach collects after its agent died."""
    gate = tmp_path / "gate"
    script = f"while [ ! -e {gate} ]; do sleep 0.05; done; exit 7"
    ex = launch("port", tmp_path / "port", script)
    assert [t.name for t in ex.threads()] == ["exec-watch-t"]
    ex.detach()
    assert wait_until(lambda: ex.threads() == [], 5.0)
    assert not ex.exited.is_set()
    assert pid_alive(ex.pid) and pid_alive(ex.supervisor_pid)
    ctl_ref, ref_pid = agent_dies("ref", tmp_path, script)
    assert pid_alive(ref_pid)
    gate.touch()
    again = pexecutor.attach_supervised(ex.ctl_dir)
    assert result(again) == result(jexecutor.attach_supervised(ctl_ref)) \
        == (7, 0)
    assert wait_until(lambda: not pid_alive(ex.supervisor_pid), 5.0)
