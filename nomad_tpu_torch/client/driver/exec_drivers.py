"""Process-executing drivers: raw_exec, exec, java, qemu (a copy of
``nomad_tpu/client/driver/exec_drivers.py``; reference:
client/driver/raw_exec.go, exec.go + exec_linux.go, java.go, qemu.go).

All four share the Executor; they differ in how the command line is
assembled and how availability is fingerprinted.  The reference's `exec`
driver isolates via cgroups+chroot; here `exec` runs inside the task dir
with an RLIMIT_AS memory cap — the strongest isolation available without
root — while `raw_exec` runs with no isolation, exactly as the reference
distinguishes them.

The port's ``exec`` takes its cgroup root from the client's
``ClientConfig.cgroup_root`` (empty by default: no cgroup, the RLIMIT_AS
cap), not the host's ``/sys/fs/cgroup``.  Its tasks outlive the agent
(``reattach``): a client's shutdown detaches from them, and a restored
client re-attaches through ``open``.
"""
from __future__ import annotations

import os
import subprocess
import threading
from typing import Dict, List

from ...structs import structs as s
# Registered before the exec family, as the JAX package's client
# registers them (driver.load_builtins).
from . import mock_driver  # noqa: F401
from .fields import FieldSchema
from .driver import (
    Driver,
    DriverAbilities,
    DriverError,
    DriverHandle,
    ExecContext,
    FS_ISOLATION_CHROOT,
    FS_ISOLATION_NONE,
    StartResponse,
    WaitResult,
    find_executable,
    opt,
    register_driver,
)
from .executor import (
    ExecCommand,
    Executor,
    SupervisedExecutor,
    attach,
    attach_supervised,
)


class ExecutorHandle(DriverHandle):
    """Wraps a live Executor (reference: raw_exec.go rawExecHandle)."""

    def __init__(self, executor: Executor, task_name: str, kill_timeout: float):
        self.executor = executor
        self.task_name = task_name
        self.kill_timeout = kill_timeout or 5.0

    def id(self) -> str:
        ctl = getattr(self.executor, "ctl_dir", None)
        if ctl:
            return f"sup:{ctl}"
        return f"pid:{self.executor.pid}"

    def wait_ch(self) -> threading.Event:
        return self.executor.exited

    def wait_result(self) -> WaitResult:
        self.executor.exited.wait()
        return self.executor.result

    def update(self, task: s.Task) -> None:
        self.kill_timeout = task.kill_timeout or self.kill_timeout

    def kill(self) -> None:
        self.executor.shutdown(grace=self.kill_timeout)

    def signal(self, sig: int) -> None:
        self.executor.send_signal(sig)

    def exec_cmd(self, cmd: str, args: List[str]):
        try:
            out = subprocess.run([cmd] + args, capture_output=True, timeout=30)
            return (out.stdout + out.stderr, out.returncode)
        except (OSError, subprocess.SubprocessError) as e:
            return (str(e).encode(), 1)

    def stats(self) -> Dict:
        return self.executor.stats()

    def threads(self) -> List[threading.Thread]:
        return self.executor.threads()

    def detach(self) -> bool:
        detach = getattr(self.executor, "detach", None)
        if detach is None:
            return False
        detach()
        return True


class _ExecFamilyDriver(Driver):
    """Shared start path for raw_exec/exec/java/qemu."""

    # Its tasks run under supervisors that outlive the agent: a client's
    # shutdown leaves them running, and a restored client re-attaches.
    reattach = True

    # cgroup isolation for the family (executor_linux.go); raw_exec opts
    # out to run unisolated like the reference.
    use_cgroups = True

    name = ""
    isolation = FS_ISOLATION_NONE
    enforce_memory = False

    def abilities(self) -> DriverAbilities:
        return DriverAbilities(send_signals=True, exec=True)

    def fs_isolation(self) -> str:
        return self.isolation

    def command_line(self, exec_ctx: ExecContext, task: s.Task) -> tuple[str, List[str]]:
        cfg = task.config or {}
        command = opt(cfg, "command", "")
        if not command:
            raise DriverError(f"missing 'command' in {self.name} driver config")
        args = [str(a) for a in opt(cfg, "args", []) or []]
        env = exec_ctx.task_env
        return env.replace_env(command), env.parse_and_replace(args)

    CONFIG_FIELDS = {
        "command": FieldSchema("string", required=True),
        "args": FieldSchema("list"),
    }

    def ctl_dir(self, exec_ctx: ExecContext, task_name: str) -> str:
        """The supervisor control dir for a task (one place owns the
        naming convention; LxcDriver reads it pre-launch)."""
        return os.path.join(exec_ctx.task_dir.dir, f".{task_name}.executor")

    def start(self, exec_ctx: ExecContext, task: s.Task) -> StartResponse:
        cmd, args = self.command_line(exec_ctx, task)
        td = exec_ctx.task_dir
        resolved = find_executable(cmd) or os.path.join(td.dir, cmd)
        exec_cmd = ExecCommand(
            cmd=resolved,
            args=args,
            env=exec_ctx.task_env.env(),
            cwd=td.dir,
            task_name=task.name,
            log_dir=td.log_dir,
            max_log_files=task.log_config.max_files if task.log_config else 10,
            max_log_file_size_mb=(
                task.log_config.max_file_size_mb if task.log_config else 10),
            memory_limit_mb=(
                task.resources.memory_mb
                if (self.enforce_memory and task.resources) else 0),
            cpu_limit=(task.resources.cpu if task.resources else 0),
            # exec-family isolation (exec_linux.go): cgroups when the
            # host allows; raw_exec opts out by design (raw_exec.go).
            use_cgroups=self.use_cgroups,
            cgroup_name=f"{self.ctx.alloc_id[:8]}-{task.name}",
            cgroup_root=getattr(self.ctx.config, "cgroup_root", ""),
        )
        # Every exec-family task runs under a detached supervisor
        # subprocess (driver/supervisor.py ≙ executor_plugin.go): the
        # agent can restart and re-attach with the real exit status.
        executor = SupervisedExecutor(exec_cmd,
                                      self.ctl_dir(exec_ctx, task.name))
        try:
            executor.launch()
        except OSError as e:
            raise DriverError(f"failed to launch {resolved}: {e}") from e
        return StartResponse(
            handle=ExecutorHandle(executor, task.name, task.kill_timeout))

    def open(self, exec_ctx: ExecContext, handle_id: str) -> DriverHandle:
        if handle_id.startswith("sup:"):
            ex = attach_supervised(handle_id.split(":", 1)[1])
            if ex is None:
                raise DriverError(f"supervised task gone: {handle_id!r}")
            return ExecutorHandle(ex, "reattached", 5.0)
        if not handle_id.startswith("pid:"):
            raise DriverError(f"bad handle id {handle_id!r}")
        pid = int(handle_id.split(":", 1)[1])
        ex = attach(pid)
        if ex is None:
            raise DriverError(f"process {pid} not running")
        return ExecutorHandle(ex, "reattached", 5.0)


class RawExecDriver(_ExecFamilyDriver):
    """(raw_exec.go) — no isolation; must be enabled explicitly via client
    option ``driver.raw_exec.enable``."""

    use_cgroups = False

    name = "raw_exec"
    isolation = FS_ISOLATION_NONE

    def fingerprint(self, node: s.Node) -> bool:
        options = getattr(self.ctx.config, "options", {}) or {}
        if str(options.get("driver.raw_exec.enable", "")).lower() in ("1", "true"):
            node.attributes["driver.raw_exec"] = "1"
            return True
        node.attributes.pop("driver.raw_exec", None)
        return False


class ExecDriver(_ExecFamilyDriver):
    """(exec.go / exec_linux.go) — isolated exec; linux only."""

    name = "exec"
    isolation = FS_ISOLATION_CHROOT
    enforce_memory = True

    def fingerprint(self, node: s.Node) -> bool:
        if os.name != "posix" or not os.path.isdir("/proc"):
            return False
        node.attributes["driver.exec"] = "1"
        return True


class JavaDriver(_ExecFamilyDriver):
    """(java.go) — runs jars via the JVM."""

    name = "java"
    enforce_memory = True

    CONFIG_FIELDS = {
        "jar_path": FieldSchema("string"),
        "class": FieldSchema("string"),
        "class_path": FieldSchema("string"),
        "jvm_options": FieldSchema("list"),
        "args": FieldSchema("list"),
    }

    def validate(self, config) -> None:
        super().validate(config)
        if not (config or {}).get("jar_path") and not (config or {}).get("class"):
            raise ValueError("missing 'jar_path' or 'class'")

    def command_line(self, exec_ctx: ExecContext, task: s.Task):
        cfg = task.config or {}
        env = exec_ctx.task_env
        args: List[str] = [str(a) for a in opt(cfg, "jvm_options", []) or []]
        jar = opt(cfg, "jar_path", "")
        if jar:
            args += ["-jar", env.replace_env(jar)]
        else:
            cls = opt(cfg, "class", "")
            if not cls:
                raise DriverError("missing 'jar_path' or 'class' in java config")
            cp = opt(cfg, "class_path", "")
            if cp:
                args += ["-cp", env.replace_env(cp)]
            args.append(cls)
        args += env.parse_and_replace([str(a) for a in opt(cfg, "args", []) or []])
        return "java", args

    def fingerprint(self, node: s.Node) -> bool:
        path = find_executable("java")
        if not path:
            node.attributes.pop("driver.java", None)
            return False
        node.attributes["driver.java"] = "1"
        try:
            out = subprocess.run(["java", "-version"], capture_output=True,
                                 timeout=10).stderr.decode()
            first = out.splitlines()[0] if out else ""
            if '"' in first:
                node.attributes["driver.java.version"] = first.split('"')[1]
        except (OSError, subprocess.SubprocessError):
            pass
        return True


class QemuDriver(_ExecFamilyDriver):
    """(qemu.go) — boots VM images via qemu-system-x86_64."""

    name = "qemu"
    isolation = "image"

    CONFIG_FIELDS = {
        "image_path": FieldSchema("string", required=True),
        "accelerator": FieldSchema("string"),
        "args": FieldSchema("list"),
        "port_map": FieldSchema("map"),
    }

    def command_line(self, exec_ctx: ExecContext, task: s.Task):
        cfg = task.config or {}
        env = exec_ctx.task_env
        image = env.replace_env(opt(cfg, "image_path", ""))
        mem = task.resources.memory_mb if task.resources else 128
        args = ["-machine", "type=pc,accel=" + opt(cfg, "accelerator", "tcg"),
                "-name", task.name, "-m", f"{mem}M",
                "-drive", f"file={image}", "-nographic"]
        for extra in opt(cfg, "args", []) or []:
            args.append(env.replace_env(str(extra)))
        return "qemu-system-x86_64", args

    def fingerprint(self, node: s.Node) -> bool:
        path = find_executable("qemu-system-x86_64")
        if not path:
            node.attributes.pop("driver.qemu", None)
            return False
        node.attributes["driver.qemu"] = "1"
        return True


class DockerDriver(_ExecFamilyDriver):
    """(docker.go) — container tasks via the docker CLI when present.

    The reference speaks the docker API; driving the CLI keeps the same
    user-visible contract (image pull, port map, run, stop) without a
    vendored API client.
    """

    name = "docker"
    isolation = "image"

    CONFIG_FIELDS = {
        "image": FieldSchema("string", required=True),
        "command": FieldSchema("string"),
        "args": FieldSchema("list"),
        "port_map": FieldSchema("map"),
        "network_mode": FieldSchema("string"),
        "labels": FieldSchema("map"),
    }

    def command_line(self, exec_ctx: ExecContext, task: s.Task):
        cfg = task.config or {}
        env = exec_ctx.task_env
        image = env.replace_env(opt(cfg, "image", ""))
        name = f"nomad-{task.name}-{os.path.basename(exec_ctx.task_dir.dir)}"
        args = ["run", "--rm", "--name", name]
        for k, v in exec_ctx.task_env.env().items():
            args += ["-e", f"{k}={v}"]
        if task.resources and task.resources.memory_mb:
            args += ["--memory", f"{task.resources.memory_mb}m"]
        cmd_override = opt(cfg, "command", "")
        args.append(image)
        if cmd_override:
            args.append(env.replace_env(cmd_override))
            args += env.parse_and_replace(
                [str(a) for a in opt(cfg, "args", []) or []])
        return "docker", args

    def fingerprint(self, node: s.Node) -> bool:
        path = find_executable("docker")
        if not path:
            node.attributes.pop("driver.docker", None)
            return False
        try:
            out = subprocess.run(["docker", "version", "--format",
                                  "{{.Server.Version}}"],
                                 capture_output=True, timeout=5)
            if out.returncode != 0:
                return False
            node.attributes["driver.docker"] = "1"
            node.attributes["driver.docker.version"] = out.stdout.decode().strip()
            return True
        except (OSError, subprocess.SubprocessError):
            return False

    def periodic(self):
        return (True, 30.0)


def _docker_factory(ctx):
    """Prefer the Engine API over the daemon socket (docker.go's actual
    transport); fall back to the CLI shell-out when no socket answers."""
    from .docker_api import DockerAPI, DockerAPIDriver

    api = DockerAPI()
    if api.available():
        return DockerAPIDriver(ctx, api)
    return DockerDriver(ctx)


register_driver("raw_exec", RawExecDriver)
register_driver("exec", ExecDriver)
register_driver("java", JavaDriver)
register_driver("qemu", QemuDriver)
register_driver("docker", _docker_factory)
