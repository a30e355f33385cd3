"""Universal executor: runs task processes with stdout/stderr log
rotation, pid tracking, resource stats, and graceful shutdown (a copy of
``nomad_tpu/client/driver/executor.py``; reference:
client/driver/executor/executor.go:50-726,
client/driver/logging/rotator.go).

The reference runs this as a go-plugin *subprocess* so tasks survive agent
restarts; here tasks are direct children detached into their own session
(``start_new_session``), and re-attach after agent restart is done by pid
(`attach`), which covers the same restart-survival contract without a
plugin RPC layer.

Where the port departs from the JAX package's executor:

- The supervisor is this package's own module (its name is the
  imported module's), started with ``-S``: its interpreter imports the
  standard library and this package's ``supervisor``, ``executor`` and
  ``cgroups`` only (the package ``__init__``s import lazily, and
  ``WaitResult`` is defined here, not in ``driver.py``).
- The cgroup root is ``ExecCommand.cgroup_root`` (the client's
  ``ClientConfig.cgroup_root``); empty, no cgroup is made.
- A launch first removes the previous run's control files
  (``STALE_CONTROL_FILES``): a restarted task reuses its control dir,
  and the JAX package's launch takes the last run's ``task.pid`` and
  ``exit.json`` (and its lingering supervisor's socket) for the new
  run's, so it reports the new run's end at once with the old code.
  A supervisor removes the socket advertisement only if it is its own.
- The result is published only once the supervisor has exited: once
  ``exited`` is set, no supervisor of that task is alive, and the
  supervisor exits as soon as its ``wait`` reply is delivered
  (``supervisor.py``).  ``threads()`` lists the executor's
  live threads, which a client's shutdown joins.
- ``SupervisedExecutor.detach`` ends the executor's watch without ending
  the task (a client's shutdown: the task runs on, and a restarted
  client re-attaches with ``attach_supervised``).
"""
from __future__ import annotations

import json
import os
import resource
import signal
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class WaitResult:
    """Outcome of a finished task process
    (reference: client/driver/structs/structs.go WaitResult).  Defined
    here, not in ``driver.py`` as in the JAX package, so that a
    supervisor's interpreter loads only the standard library and this
    package's ``executor``/``cgroups``/``supervisor``; ``driver.py``
    re-exports it."""

    exit_code: int = 0
    signal: int = 0
    err: Optional[str] = None

    def successful(self) -> bool:
        return self.exit_code == 0 and self.signal == 0 and self.err is None


class LogRotator:
    """Size-based rotating file writer
    (reference: client/driver/logging/rotator.go).

    Files are named ``<task>.<stream>.<n>`` under the log dir; at most
    ``max_files`` are kept.
    """

    def __init__(self, log_dir: str, base_name: str,
                 max_files: int = 10, file_size_mb: int = 10):
        self.log_dir = log_dir
        self.base_name = base_name
        self.max_files = max(1, max_files)
        self.max_bytes = file_size_mb * 1024 * 1024
        self._idx = self._initial_index()
        self._fh = None
        self._written = 0
        self._lock = threading.Lock()

    def _path(self, idx: int) -> str:
        return os.path.join(self.log_dir, f"{self.base_name}.{idx}")

    def _initial_index(self) -> int:
        try:
            existing = [
                int(f.rsplit(".", 1)[1])
                for f in os.listdir(self.log_dir)
                if f.startswith(self.base_name + ".") and f.rsplit(".", 1)[1].isdigit()
            ]
        except OSError:
            existing = []
        return max(existing, default=0)

    def _open(self) -> None:
        path = self._path(self._idx)
        self._fh = open(path, "ab")
        self._written = self._fh.tell()

    def write(self, data: bytes) -> None:
        with self._lock:
            if self._fh is None:
                self._open()
            if self._written + len(data) > self.max_bytes:
                self._fh.close()
                self._idx += 1
                self._open()
                self._purge()
            self._fh.write(data)
            self._fh.flush()
            self._written += len(data)

    def _purge(self) -> None:
        lo = self._idx - self.max_files + 1
        for f in os.listdir(self.log_dir):
            if f.startswith(self.base_name + "."):
                tail = f.rsplit(".", 1)[1]
                if tail.isdigit() and int(tail) < lo:
                    try:
                        os.unlink(os.path.join(self.log_dir, f))
                    except OSError:
                        pass

    def close(self) -> None:
        with self._lock:
            if self._fh:
                self._fh.close()
                self._fh = None


@dataclass
class ExecCommand:
    """(executor.go ExecCommand)."""

    cmd: str
    args: List[str] = field(default_factory=list)
    env: Dict[str, str] = field(default_factory=dict)
    cwd: str = ""
    task_name: str = "task"
    log_dir: str = ""
    max_log_files: int = 10
    max_log_file_size_mb: int = 10
    cpu_limit: int = 0        # MHz ask — cpu.shares/weight when cgroups apply
    memory_limit_mb: int = 0  # cgroup memory limit; RLIMIT_AS fallback
    user: str = ""
    use_cgroups: bool = False  # exec-family isolation (executor_linux.go)
    cgroup_name: str = ""
    cgroup_root: str = ""      # ClientConfig.cgroup_root; "" -> no cgroup


class Executor:
    """Runs one task process (reference: executor.go:50 UniversalExecutor)."""

    def __init__(self, command: ExecCommand):
        self.command = command
        self.proc: Optional[subprocess.Popen] = None
        self.pid = 0
        self.start_time = 0.0
        self.exited = threading.Event()
        self.result: Optional[WaitResult] = None
        self._out_rot: Optional[LogRotator] = None
        self._err_rot: Optional[LogRotator] = None
        self._pumps: List[threading.Thread] = []
        self._threads: List[threading.Thread] = []
        self.cgroup = None

    def _start_thread(self, target, name: str) -> None:
        t = threading.Thread(target=target, daemon=True, name=name)
        self._threads.append(t)
        t.start()

    def threads(self) -> List[threading.Thread]:
        """The executor's live threads (log pumps, waiter, watcher)."""
        return [t for t in self._pumps + self._threads if t.is_alive()]

    # -- lifecycle ---------------------------------------------------------
    def launch(self) -> int:
        c = self.command
        stdout = stderr = subprocess.DEVNULL
        if c.log_dir:
            os.makedirs(c.log_dir, exist_ok=True)
            self._out_rot = LogRotator(c.log_dir, f"{c.task_name}.stdout",
                                       c.max_log_files, c.max_log_file_size_mb)
            self._err_rot = LogRotator(c.log_dir, f"{c.task_name}.stderr",
                                       c.max_log_files, c.max_log_file_size_mb)
            stdout = stderr = subprocess.PIPE

        # Isolation: cgroup limits when requested and the host allows
        # (executor_linux.go configureCgroups); RLIMIT_AS fallback keeps
        # a memory bound on hosts without cgroups.
        use_rlimit = c.memory_limit_mb > 0
        if c.use_cgroups:
            from . import cgroups

            if cgroups.available(c.cgroup_root):
                self.cgroup = cgroups.TaskCgroup(
                    c.cgroup_name or f"{c.task_name}-{os.getpid()}",
                    cpu_mhz=c.cpu_limit, memory_mb=c.memory_limit_mb,
                    root=c.cgroup_root)
                if self.cgroup.create():
                    use_rlimit = False
                else:
                    self.cgroup = None

        cg_paths = list(self.cgroup.paths) if self.cgroup is not None else []

        def preexec():
            # Join the cgroup BEFORE exec so nothing the task forks can
            # escape it (executor_linux.go joins pre-exec); if the join
            # fails, fall back to RLIMIT_AS in-child.
            joined = False
            for path in cg_paths:
                try:
                    with open(os.path.join(path, "cgroup.procs"), "w") as fh:
                        fh.write(str(os.getpid()))
                    joined = True
                except OSError:
                    pass
            if (use_rlimit or (cg_paths and not joined)) \
                    and c.memory_limit_mb > 0:
                lim = c.memory_limit_mb * 1024 * 1024
                try:
                    resource.setrlimit(resource.RLIMIT_AS, (lim, lim))
                except (ValueError, OSError):
                    pass

        self.proc = subprocess.Popen(
            [c.cmd] + list(c.args),
            env=c.env or None,
            cwd=c.cwd or None,
            stdout=stdout,
            stderr=stderr,
            start_new_session=True,
            preexec_fn=preexec,
        )
        self.pid = self.proc.pid
        self.start_time = time.time()
        if self._out_rot:
            self._pumps = [
                threading.Thread(target=self._pump, args=(self.proc.stdout, self._out_rot),
                                 daemon=True, name=f"exec-pump-{c.task_name}"),
                threading.Thread(target=self._pump, args=(self.proc.stderr, self._err_rot),
                                 daemon=True, name=f"exec-pump-{c.task_name}"),
            ]
            for t in self._pumps:
                t.start()
        self._start_thread(self._wait, f"exec-wait-{c.task_name}")
        return self.pid

    @staticmethod
    def _pump(stream, rot: LogRotator) -> None:
        try:
            for chunk in iter(lambda: stream.read(8192), b""):
                rot.write(chunk)
        except (OSError, ValueError):
            pass
        finally:
            rot.close()

    def _wait(self) -> None:
        rc = self.proc.wait()
        for t in self._pumps:
            t.join(timeout=2.0)
        if rc < 0:
            self.result = WaitResult(exit_code=0, signal=-rc)
        else:
            self.result = WaitResult(exit_code=rc)
        if self.cgroup is not None:
            # Reap stragglers the task forked, then remove the group
            # (executor_linux.go destroyCgroup).
            self.cgroup.destroy()
            self.cgroup = None
        self.exited.set()

    # -- control -----------------------------------------------------------
    def shutdown(self, grace: float = 5.0) -> None:
        """SIGINT → grace → SIGKILL the whole process group
        (executor.go Exit/ShutDown)."""
        if self.proc is None or self.result is not None:
            return
        try:
            os.killpg(self.pid, signal.SIGINT)
        except (ProcessLookupError, PermissionError, OSError):
            return
        if not self.exited.wait(grace):
            try:
                os.killpg(self.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError, OSError):
                pass

    def send_signal(self, sig: int) -> None:
        if self.proc is not None and self.result is None:
            os.kill(self.pid, sig)

    def stats(self) -> Dict:
        """Resource usage snapshot (executor.go:643 collectPids/stats)."""
        try:
            with open(f"/proc/{self.pid}/stat", "rb") as f:
                parts = f.read().split()
            utime, stime = int(parts[13]), int(parts[14])
            rss_pages = int(parts[23])
            hz = os.sysconf("SC_CLK_TCK")
            page = os.sysconf("SC_PAGE_SIZE")
            return {
                "pid": self.pid,
                "cpu_seconds": (utime + stime) / hz,
                "rss_bytes": rss_pages * page,
                "uptime": time.time() - self.start_time,
            }
        except (OSError, IndexError, ValueError):
            return {"pid": self.pid}


# How long a launch waits for the supervisor to start its task (the
# reference's bound).
LAUNCH_TIMEOUT = 45.0

# The control files of a previous run, removed before a launch.
STALE_CONTROL_FILES = ("task.pid", "exit.json", "supervisor.pid",
                       "sock.path")


class SupervisedExecutor(Executor):
    """Runs the task under a DETACHED supervisor subprocess
    (driver/supervisor.py ≙ the reference's go-plugin executor,
    client/driver/executor_plugin.go): the agent can die and restart and
    the supervisor keeps running the task, serving control on a unix
    socket and persisting the exit status to disk — so re-attach
    re-collects the real exit code, not a best-effort guess."""

    def __init__(self, command: ExecCommand, ctl_dir: str):
        super().__init__(command)
        self.ctl_dir = ctl_dir
        self.supervisor_pid = 0
        self._sup_proc: Optional[subprocess.Popen] = None
        self._detached = threading.Event()
        self._wait_lock = threading.Lock()
        self._wait_sock: Optional[socket.socket] = None

    def launch(self) -> int:
        from . import supervisor as sup

        os.makedirs(self.ctl_dir, exist_ok=True)
        # A restarted task reuses its control dir: the previous run's
        # files would pass for this run's pid and exit status.
        for name in STALE_CONTROL_FILES:
            try:
                os.unlink(os.path.join(self.ctl_dir, name))
            except OSError:
                pass
        with open(os.path.join(self.ctl_dir, "command.json"), "w") as fh:
            json.dump(self.command.__dict__, fh)
        # -S: no site-packages (the supervisor needs the standard library
        # and this package only; the site scan dominates an interpreter's
        # start on a slow filesystem).
        deadline = time.time() + LAUNCH_TIMEOUT
        self._sup_proc = subprocess.Popen(
            [sys.executable, "-S", "-m", sup.__name__, self.ctl_dir],
            env=_package_env(), stdin=subprocess.DEVNULL,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            start_new_session=True)
        self.supervisor_pid = self._sup_proc.pid
        try:
            self._await_launch(deadline)
        except BaseException:
            # Leave nothing behind: the supervisor and the task each lead
            # a session of their own.
            pids = [self.supervisor_pid]
            try:
                with open(os.path.join(self.ctl_dir, "task.pid")) as fh:
                    pids.append(json.load(fh)["pid"])
            except (OSError, ValueError, KeyError):
                pass
            for pid in pids:
                try:
                    os.killpg(pid, signal.SIGKILL)
                except OSError:
                    pass
            raise
        self.start_time = time.time()
        self._start_thread(self._watch, f"exec-watch-{self.command.task_name}")
        return self.pid

    def _await_launch(self, deadline: float) -> None:
        """The task pid, once the supervisor wrote it; returns too if the
        launch failed (exit.json: the watcher delivers the error
        result)."""
        from . import supervisor as sup

        pid_path = os.path.join(self.ctl_dir, "task.pid")
        while True:
            if os.path.exists(pid_path):
                with open(pid_path) as fh:
                    self.pid = json.load(fh)["pid"]
                return
            if os.path.exists(sup.exit_path(self.ctl_dir)):
                return
            if self._sup_proc.poll() is not None:
                raise OSError(f"supervisor exited rc="
                              f"{self._sup_proc.returncode} before launch")
            if time.time() > deadline:
                raise OSError("timed out waiting for supervised task launch")
            time.sleep(0.02)

    # -- result collection -------------------------------------------------

    def _watch(self) -> None:
        """Block on the supervisor's wait op; fall back to polling
        exit.json if the socket goes away (supervisor reaped after
        persisting the status).

        The degraded guess (exit 0, no record) is a LAST resort: the task
        pid looking dead does not mean the status is lost — the task is
        the supervisor's child, so the pid only becomes signalable-dead
        after the supervisor reaps it, at which point the supervisor is
        about to persist exit.json (pump joins + fsync in between).
        Degrading while the supervisor is still alive fabricates an exit 0
        before logs are flushed, so only give up once the supervisor
        itself is gone AND a grace period for a straggling exit.json
        write has passed.

        The result is published only once the supervisor is gone
        (``_reap_supervisor``); nothing is published once ``detach`` has
        been called."""
        import json

        from . import supervisor as sup

        sup_gone_since = None
        while not self._detached.is_set():
            try:
                res = self._wait_reply()["result"]
                self._finish(WaitResult(exit_code=res["exit_code"],
                                        signal=res["signal"]))
                return
            except (OSError, KeyError, TypeError, ValueError):
                pass
            if self._detached.is_set():
                return
            ep = sup.exit_path(self.ctl_dir)
            if os.path.exists(ep):
                with open(ep) as fh:
                    res = json.load(fh)
                self._finish(WaitResult(exit_code=res.get("exit_code", 0),
                                        signal=res.get("signal", 0)))
                return
            if self._supervisor_alive():
                sup_gone_since = None
            elif sup_gone_since is None:
                sup_gone_since = time.monotonic()
            elif time.monotonic() - sup_gone_since > 2.0:
                # Supervisor dead >2s and still no exit record: the status
                # really is lost — degrade like a pid re-attach.
                self._finish(WaitResult(exit_code=0))
                return
            self._detached.wait(0.25)

    def _wait_reply(self) -> Dict:
        """The supervisor's answer to ``wait`` (blocks until the task has
        exited); ``detach`` shuts its socket."""
        from . import supervisor as sup

        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as sk:
            sk.connect(sup.sock_path(self.ctl_dir))
            with self._wait_lock:
                if self._detached.is_set():
                    raise OSError("detached")
                self._wait_sock = sk
            try:
                sk.sendall(b'{"op": "wait"}\n')
                buf = b""
                while not buf.endswith(b"\n"):
                    chunk = sk.recv(65536)
                    if not chunk:
                        break
                    buf += chunk
            finally:
                with self._wait_lock:
                    self._wait_sock = None
        return json.loads(buf.decode())

    def detach(self) -> None:
        """Stop watching the task and leave it running under its
        supervisor (a client's shutdown): the watch thread ends, and
        ``attach_supervised`` collects the task later."""
        with self._wait_lock:
            self._detached.set()
            if self._wait_sock is not None:
                try:
                    self._wait_sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    # How long the result waits for the supervisor to exit once the task's
    # status is collected (it exits right after its wait reply).
    REAP_TIMEOUT = 10.0

    def _finish(self, result: WaitResult) -> None:
        self._reap_supervisor()
        self.result = result
        self.exited.set()

    def _reap_supervisor(self) -> None:
        """Wait (bounded) until the supervisor has exited, and reap it if
        this process started it."""
        deadline = time.monotonic() + self.REAP_TIMEOUT
        while self._supervisor_alive() and time.monotonic() < deadline:
            time.sleep(0.05)
        if self._sup_proc is not None:
            self._sup_proc.poll()

    def _supervisor_alive(self) -> bool:
        import json

        pid = self.supervisor_pid
        if not pid:
            try:
                with open(os.path.join(self.ctl_dir,
                                       "supervisor.pid")) as fh:
                    pid = json.load(fh)["pid"]
            except (OSError, ValueError, KeyError):
                return False
        return pid_alive(pid)

    # -- control (socket first, direct-signal fallback) --------------------

    def shutdown(self, grace: float = 5.0) -> None:
        from . import supervisor as sup

        if self.result is not None:
            return
        try:
            sup.request(self.ctl_dir, {"op": "shutdown", "grace": grace})
            self.exited.wait(grace + 5.0)
            return
        except (OSError, ValueError):
            pass
        if self.pid:
            try:
                os.killpg(self.pid, signal.SIGINT)
            except (ProcessLookupError, PermissionError, OSError):
                return
            if not self.exited.wait(grace):
                try:
                    os.killpg(self.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError, OSError):
                    pass

    def send_signal(self, sig: int) -> None:
        from . import supervisor as sup

        try:
            sup.request(self.ctl_dir, {"op": "signal", "sig": sig})
        except (OSError, ValueError):
            if self.pid and self.result is None:
                os.kill(self.pid, sig)

    def stats(self) -> Dict:
        from . import supervisor as sup

        try:
            return sup.request(self.ctl_dir, {"op": "stats"})["stats"]
        except (OSError, KeyError, ValueError):
            return super().stats()


def _package_env() -> Dict[str, str]:
    """This process's environment with the package's root first on
    ``PYTHONPATH``: a supervisor must import the package whatever the
    agent's working directory."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    env = dict(os.environ)
    env["PYTHONPATH"] = pkg_root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def pid_alive(pid: int) -> bool:
    """Whether ``pid`` names a live process: a zombie (exited, not yet
    reaped by its parent) counts as gone.  Read from ``/proc``, not with
    ``kill(pid, 0)``: ``os.kill`` holds the GIL, and on a sandboxed kernel
    busy starting processes one call blocked the whole agent for tens
    of seconds."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as fh:
            stat = fh.read()
    except OSError:
        return False
    # The state follows the parenthesised command name.
    return stat[stat.rfind(b")") + 2:stat.rfind(b")") + 3] not in (b"Z", b"")


def attach_supervised(ctl_dir: str) -> Optional["SupervisedExecutor"]:
    """Re-attach to a supervised task after agent restart: the exit
    status persisted by the supervisor (exit.json) makes collection
    exact even when the task finished while the agent was down."""
    import json

    from . import supervisor as sup

    if not os.path.isdir(ctl_dir):
        return None
    ex = SupervisedExecutor(ExecCommand(cmd=""), ctl_dir)
    pid_path = os.path.join(ctl_dir, "task.pid")
    if os.path.exists(pid_path):
        try:
            with open(pid_path) as fh:
                ex.pid = json.load(fh)["pid"]
        except (OSError, ValueError, KeyError):
            pass
    ep = sup.exit_path(ctl_dir)
    live = False
    if not os.path.exists(ep):
        try:
            resp = sup.request(ctl_dir, {"op": "ping"}, timeout=2.0)
            live = bool(resp.get("ok"))
        except (OSError, ValueError):
            live = False
        if not live and ex.pid:
            try:
                os.kill(ex.pid, 0)
            except (ProcessLookupError, PermissionError):
                return None  # no record, no task: nothing to re-attach
    ex.start_time = time.time()
    ex._start_thread(ex._watch, "exec-watch-reattached")
    return ex


def attach(pid: int) -> Optional["AttachedExecutor"]:
    """Re-attach to a still-running task process after agent restart
    (reference: executor plugin re-connect, task_runner.go:279)."""
    try:
        os.kill(pid, 0)
    except (ProcessLookupError, PermissionError):
        return None
    return AttachedExecutor(pid)


class AttachedExecutor(Executor):
    """Executor recovered by pid: can signal/kill/poll but not re-collect
    the exit code (the reaper lost it across the restart) — reports exit 0
    when the pid disappears, like the reference's best-effort re-attach."""

    def __init__(self, pid: int):
        super().__init__(ExecCommand(cmd=""))
        self.pid = pid
        self.start_time = time.time()
        self._start_thread(self._poll, f"exec-poll-{pid}")

    def _poll(self) -> None:
        while True:
            try:
                os.kill(self.pid, 0)
            except (ProcessLookupError, PermissionError):
                self.result = WaitResult(exit_code=0)
                self.exited.set()
                return
            time.sleep(1.0)

    def shutdown(self, grace: float = 5.0) -> None:
        if self.result is not None:
            return
        try:
            os.killpg(self.pid, signal.SIGINT)
        except (ProcessLookupError, PermissionError, OSError):
            try:
                os.kill(self.pid, signal.SIGINT)
            except (ProcessLookupError, PermissionError, OSError):
                return
        if not self.exited.wait(grace):
            try:
                os.killpg(self.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError, OSError):
                pass
