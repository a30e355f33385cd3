"""Container-image drivers: rkt and lxc (a copy of
``nomad_tpu/client/driver/container_drivers.py``; reference:
client/driver/rkt.go:1-647, client/driver/lxc.go:1-519).

Both drive their engine's CLI in the foreground under the shared
SupervisedExecutor, so handle attach/kill/stats and agent-restart
re-attach come from the same machinery as the exec family.  The
reference links go-lxc and shells out to the rkt binary; a foreground
CLI run keeps the identical user-visible contract (image fetch,
mount layout, net/dns config, stop-on-kill) without vendoring either
runtime.  Command assembly is pure (``command_line``), so tests
exercise the full argument surface without the binaries installed.
"""
from __future__ import annotations

import os
import subprocess
from typing import List

from ...structs import structs as s
from .driver import (
    DriverError,
    DriverHandle,
    ExecContext,
    StartResponse,
    find_executable,
    opt,
    register_driver,
)
from .exec_drivers import ExecutorHandle, _ExecFamilyDriver
from .fields import FieldSchema

# In-container mount targets (reference: client/allocdir/alloc_dir.go
# SharedAllocContainerPath / TaskLocalContainerPath / TaskSecretsContainerPath).
ALLOC_CONTAINER_PATH = "/alloc"
LOCAL_CONTAINER_PATH = "/local"
SECRETS_CONTAINER_PATH = "/secrets"

# Client option gating user-supplied host volumes (rkt.go:52
# rktVolumesConfigOption, default enabled).
RKT_VOLUMES_OPTION = "rkt.volumes.enabled"
# Client option gating the lxc driver itself (lxc.go lxcConfigOption).
LXC_ENABLE_OPTION = "driver.lxc.enable"
LXC_VOLUMES_OPTION = "lxc.volumes.enabled"


class RktDriver(_ExecFamilyDriver):
    """(rkt.go) — CoreOS rkt pods via ``rkt run`` in the foreground.

    The reference execs rkt under its executor plugin with
    --uuid-file-save for re-attach; here the foreground rkt process
    itself runs under the supervisor, so the uuid file is kept for
    status/debugging parity and the supervisor owns the lifecycle.
    """

    name = "rkt"
    isolation = "image"
    use_cgroups = False          # rkt manages its own pod cgroups

    CONFIG_FIELDS = {
        "image": FieldSchema("string", required=True),
        "command": FieldSchema("string"),
        "args": FieldSchema("list"),
        "trust_prefix": FieldSchema("string"),
        "dns_servers": FieldSchema("list"),
        "dns_search_domains": FieldSchema("list"),
        "net": FieldSchema("list"),
        "port_map": FieldSchema("map"),
        "volumes": FieldSchema("list"),
        "insecure_options": FieldSchema("list"),
        "no_overlay": FieldSchema("bool"),
        "debug": FieldSchema("bool"),
    }

    def _volumes_enabled(self) -> bool:
        options = getattr(self.ctx.config, "options", {}) or {}
        return str(options.get(RKT_VOLUMES_OPTION, "1")).lower() in (
            "1", "true", "")

    def command_line(self, exec_ctx: ExecContext, task: s.Task):
        """rkt.go:251-370 cmdArgs assembly, minus the trust pre-step
        (which runs in start())."""
        cfg = task.config or {}
        env = exec_ctx.task_env
        td = exec_ctx.task_dir
        debug = bool(opt(cfg, "debug", False, cast=bool))

        args: List[str] = []
        insecure = [str(i) for i in opt(cfg, "insecure_options", []) or []]
        if opt(cfg, "trust_prefix", ""):
            if insecure:
                args.append("--insecure-options=" + ",".join(insecure))
        else:
            # No trust prefix ⇒ signature verification is off, like the
            # reference (rkt.go:270-279).
            args.append("--insecure-options=" +
                        (",".join(insecure) if insecure else "all"))
        args.append(f"--debug={str(debug).lower()}")
        args.append("run")
        if opt(cfg, "no_overlay", False, cast=bool):
            args.append("--no-overlay=true")
        uuid_path = os.path.join(td.local_dir, "rkt.uuid")
        args.append(f"--uuid-file-save={uuid_path}")

        # The standard task-dir mounts (rkt.go:298-313).
        mounts = [
            ("alloc", td.shared_alloc_dir, ALLOC_CONTAINER_PATH),
            ("local", td.local_dir, LOCAL_CONTAINER_PATH),
            ("secrets", td.secrets_dir, SECRETS_CONTAINER_PATH),
        ]
        for name, source, target in mounts:
            args.append(f"--volume={name},kind=host,source={source}")
            args.append(f"--mount=volume={name},target={target}")
        user_volumes = [str(v) for v in opt(cfg, "volumes", []) or []]
        if user_volumes and not self._volumes_enabled():
            raise DriverError(
                f"volumes are disabled on this client ({RKT_VOLUMES_OPTION})")
        for i, vol in enumerate(user_volumes):
            parts = env.replace_env(vol).split(":")
            if len(parts) != 2:
                raise DriverError(f"invalid rkt volume {vol!r} "
                                  "(want /host/path:/container/path)")
            args.append(f"--volume=task-{i},kind=host,source={parts[0]}")
            args.append(f"--mount=volume=task-{i},target={parts[1]}")

        for net in opt(cfg, "net", []) or []:
            args.append(f"--net={env.replace_env(str(net))}")
        for dns in opt(cfg, "dns_servers", []) or []:
            args.append(f"--dns={env.replace_env(str(dns))}")
        for domain in opt(cfg, "dns_search_domains", []) or []:
            args.append(f"--dns-search={env.replace_env(str(domain))}")
        for name, host_port in (opt(cfg, "port_map", {}) or {}).items():
            args.append(f"--port={name}:{host_port}")

        # Resource isolators (rkt.go:340-352).
        if task.resources:
            if task.resources.memory_mb:
                args.append(f"--memory={task.resources.memory_mb}M")
            if task.resources.cpu:
                args.append(f"--cpu={task.resources.cpu}m")

        args.append(env.replace_env(opt(cfg, "image", "")))
        command = opt(cfg, "command", "")
        if command:
            args.append(f"--exec={env.replace_env(command)}")
        task_args = env.parse_and_replace(
            [str(a) for a in opt(cfg, "args", []) or []])
        if task_args:
            args.append("--")
            args.extend(task_args)
        return "rkt", args

    def start(self, exec_ctx: ExecContext, task: s.Task) -> StartResponse:
        cfg = task.config or {}
        trust_prefix = opt(cfg, "trust_prefix", "")
        if trust_prefix:
            # Synchronous trust before run (rkt.go:257-268).
            debug = str(bool(opt(cfg, "debug", False, cast=bool))).lower()
            out = self._run_rkt_trust(trust_prefix, debug)
            if out.returncode != 0:
                raise DriverError(
                    f"rkt trust failed for prefix {trust_prefix!r}: "
                    f"{out.stderr.decode(errors='replace')}")
        return super().start(exec_ctx, task)

    def _run_rkt_trust(self, prefix: str, debug: str):
        return subprocess.run(
            ["rkt", "trust", "--skip-fingerprint-review=true",
             f"--prefix={prefix}", f"--debug={debug}"],
            capture_output=True, timeout=120)

    def fingerprint(self, node: s.Node) -> bool:
        """rkt.go:171-215: present + versions recorded.

        Attributes are dropped up front and re-set only on a fully
        working binary: absent, raising, and nonzero-exit rkt all stop
        advertising the driver identically."""
        for attr in ("driver.rkt", "driver.rkt.version",
                     "driver.rkt.appc.version"):
            node.attributes.pop(attr, None)
        if not find_executable("rkt"):
            return False
        try:
            out = subprocess.run(["rkt", "version"], capture_output=True,
                                 timeout=10)
        except (OSError, subprocess.SubprocessError):
            return False
        if out.returncode != 0:
            return False
        versions = {}
        for line in out.stdout.decode(errors="replace").splitlines():
            if ":" in line:
                k, _, v = line.partition(":")
                versions[k.strip().lower()] = v.strip()
        node.attributes["driver.rkt"] = "1"
        if "rkt version" in versions:
            node.attributes["driver.rkt.version"] = versions["rkt version"]
        if "appc version" in versions:
            node.attributes["driver.rkt.appc.version"] = versions["appc version"]
        return True

    def periodic(self):
        return (True, 30.0)


def _lxc_teardown(container_name: str) -> None:
    """Authoritative container stop + rootfs removal (lxc.go:388
    h.container.Stop(); the CLI twin is lxc-stop -k).  Signaling the
    foreground lxc-start monitor is not enough: if the supervisor
    escalates to SIGKILL, the monitor dies but the container init is
    reparented and keeps running — so always force-stop the container
    itself, then destroy the lxc-create'd rootfs."""
    for cmd, timeout in ((["lxc-stop", "-n", container_name, "-k"], 30),
                         (["lxc-destroy", "-n", container_name, "-f"], 60)):
        try:
            subprocess.run(cmd, capture_output=True, timeout=timeout)
        except (OSError, subprocess.SubprocessError):
            pass


class LxcHandle(ExecutorHandle):
    """ExecutorHandle that also owns the container lifecycle: after the
    monitor is signaled (and possibly SIGKILLed past the grace period),
    force-stop the container and remove its rootfs."""

    def __init__(self, executor, task_name: str, kill_timeout: float,
                 container_name: str):
        super().__init__(executor, task_name, kill_timeout)
        self.container_name = container_name

    def kill(self) -> None:
        super().kill()
        # Synchronous on purpose: a restart re-enters start() with the
        # SAME container name the moment kill() returns, and agent
        # shutdown exits the process right after — a background teardown
        # would either destroy the restarted container or never run.
        self.executor.exited.wait(self.kill_timeout + 10.0)
        _lxc_teardown(self.container_name)


class LxcDriver(_ExecFamilyDriver):
    """(lxc.go) — LXC system containers.

    The reference drives liblxc via go-lxc (Create from a template,
    Start, then poll state); the CLI equivalents are ``lxc-create`` as
    a synchronous pre-step and a foreground ``lxc-start -F`` owned by
    the supervisor, with the task-dir mounts injected as
    lxc.mount.entry config items (lxc.go:244-258).
    """

    name = "lxc"
    isolation = "image"
    use_cgroups = False          # lxc manages the container cgroups

    CONFIG_FIELDS = {
        "template": FieldSchema("string", required=True),
        "distro": FieldSchema("string"),
        "release": FieldSchema("string"),
        "arch": FieldSchema("string"),
        "image_variant": FieldSchema("string"),
        "image_server": FieldSchema("string"),
        "gpg_key_id": FieldSchema("string"),
        "gpg_key_server": FieldSchema("string"),
        "disable_gpg": FieldSchema("bool"),
        "flush_cache": FieldSchema("bool"),
        "force_cache": FieldSchema("bool"),
        "template_args": FieldSchema("list"),
        "log_level": FieldSchema("string"),
        "verbosity": FieldSchema("string"),
        "volumes": FieldSchema("list"),
    }

    def container_name(self, exec_ctx: ExecContext, task: s.Task) -> str:
        """(lxc.go:200) <task>-<alloc_id>, plus a per-launch nonce.

        The nonce makes each start attempt's container unique: the task
        runner is released by the executor's exit event, not by kill()
        returning, so a restart can lxc-create while the previous
        handle's stop/destroy is still in flight — under a reused name
        that teardown would hit the NEW container.  The previous
        launch's name is persisted in the ctl dir and cleaned up before
        the next create."""
        if self._launch_name is None:
            self._launch_name = (
                f"{task.name}-{self.ctx.alloc_id}-{os.urandom(4).hex()}")
        return self._launch_name

    _launch_name: str | None = None

    def create_args(self, exec_ctx: ExecContext, task: s.Task) -> List[str]:
        """lxc-create argument list from the template options
        (lxc.go:228-242 TemplateOptions)."""
        cfg = task.config or {}
        env = exec_ctx.task_env
        name = self.container_name(exec_ctx, task)
        args = ["-n", name, "-t", env.replace_env(opt(cfg, "template", ""))]
        targs: List[str] = []
        for key, flag in (("distro", "--dist"), ("release", "--release"),
                          ("arch", "--arch"), ("image_variant", "--variant"),
                          ("image_server", "--server"),
                          ("gpg_key_id", "--keyid"),
                          ("gpg_key_server", "--keyserver")):
            val = opt(cfg, key, "")
            if val:
                targs += [flag, env.replace_env(str(val))]
        if opt(cfg, "disable_gpg", False, cast=bool):
            targs.append("--no-validate")
        if opt(cfg, "flush_cache", False, cast=bool):
            targs.append("--flush-cache")
        if opt(cfg, "force_cache", False, cast=bool):
            targs.append("--force-cache")
        targs += env.parse_and_replace(
            [str(a) for a in opt(cfg, "template_args", []) or []])
        if targs:
            args.append("--")
            args.extend(targs)
        return args

    def command_line(self, exec_ctx: ExecContext, task: s.Task):
        """The foreground run: lxc-start -F with the task-dir bind
        mounts (lxc.go:244-258 sets these as lxc.mount.entry items)."""
        cfg = task.config or {}
        td = exec_ctx.task_dir
        name = self.container_name(exec_ctx, task)
        args = ["-F", "-n", name]
        log_level = opt(cfg, "log_level", "")
        if log_level:
            args += ["-l", str(log_level)]
        mounts = [
            (td.shared_alloc_dir, ALLOC_CONTAINER_PATH.lstrip("/")),
            (td.local_dir, LOCAL_CONTAINER_PATH.lstrip("/")),
            (td.secrets_dir, SECRETS_CONTAINER_PATH.lstrip("/")),
        ]
        options = getattr(self.ctx.config, "options", {}) or {}
        volumes_ok = str(options.get(LXC_VOLUMES_OPTION, "1")).lower() in (
            "1", "true", "")
        for vol in opt(cfg, "volumes", []) or []:
            if not volumes_ok:
                raise DriverError(
                    f"volumes are disabled on this client "
                    f"({LXC_VOLUMES_OPTION})")
            parts = str(vol).split(":")
            if len(parts) != 2 or parts[1].startswith("/"):
                raise DriverError(
                    f"invalid lxc volume {vol!r} (want "
                    "/host/path:relative/container/path)")
            mounts.append((parts[0], parts[1]))
        for source, target in mounts:
            args += ["-s",
                     f"lxc.mount.entry={source} {target} "
                     "none rw,bind,create=dir 0 0"]
        return "lxc-start", args

    def start(self, exec_ctx: ExecContext, task: s.Task) -> StartResponse:
        ctl_dir = self.ctl_dir(exec_ctx, task.name)
        # A task that exited on its own (no kill()) leaves its rootfs
        # behind; clean up the PREVIOUS launch's container before
        # creating this one.
        try:
            with open(os.path.join(ctl_dir, "container.name")) as fh:
                prev = fh.read().strip()
        except OSError:
            prev = ""
        if prev:
            _lxc_teardown(prev)
        self._launch_name = None        # fresh nonce for this attempt
        name = self.container_name(exec_ctx, task)
        create = self.create_args(exec_ctx, task)
        out = self._run_lxc_create(create)
        if out.returncode != 0:
            raise DriverError(
                f"lxc-create failed: {out.stderr.decode(errors='replace')}")
        # Persist the name BEFORE launching: the moment a container can
        # be running, a re-attaching agent (and the next start attempt)
        # must be able to find and tear it down.
        os.makedirs(ctl_dir, exist_ok=True)
        with open(os.path.join(ctl_dir, "container.name"), "w") as fh:
            fh.write(name)
        try:
            resp = super().start(exec_ctx, task)
        except DriverError:
            # Supervisor launch failed after the rootfs was built: tear
            # it down now — a rescheduled alloc may never retry here.
            _lxc_teardown(name)
            try:
                os.unlink(os.path.join(ctl_dir, "container.name"))
            except OSError:
                pass
            raise
        base = resp.handle
        return StartResponse(
            handle=LxcHandle(base.executor, task.name, task.kill_timeout,
                             name),
            network=resp.network)

    def open(self, exec_ctx: ExecContext, handle_id: str) -> DriverHandle:
        name = ""
        if handle_id.startswith("sup:"):
            ctl_dir = handle_id.split(":", 1)[1]
            try:
                with open(os.path.join(ctl_dir, "container.name")) as fh:
                    name = fh.read().strip()
            except OSError:
                pass
        try:
            base = super().open(exec_ctx, handle_id)
        except DriverError:
            # Supervisor gone (e.g. OOM-killed): the reparented container
            # init may still be running — tear it down before reporting
            # the task lost, or it leaks forever.
            if name:
                _lxc_teardown(name)
            raise
        if name:
            return LxcHandle(base.executor, base.task_name,
                             base.kill_timeout, name)
        return base

    def _run_lxc_create(self, args: List[str]):
        return subprocess.run(["lxc-create"] + args, capture_output=True,
                              timeout=600)

    def fingerprint(self, node: s.Node) -> bool:
        """lxc.go:139-160: gated by driver.lxc.enable + liblxc present.
        Disabled, absent, raising, and nonzero-exit lxc-start all stop
        advertising the driver identically."""
        node.attributes.pop("driver.lxc", None)
        node.attributes.pop("driver.lxc.version", None)
        options = getattr(self.ctx.config, "options", {}) or {}
        enabled = str(options.get(LXC_ENABLE_OPTION, "")).lower() in (
            "1", "true")
        if not enabled or not find_executable("lxc-start"):
            return False
        try:
            out = subprocess.run(["lxc-start", "--version"],
                                 capture_output=True, timeout=10)
        except (OSError, subprocess.SubprocessError):
            return False
        if out.returncode != 0:
            return False
        node.attributes["driver.lxc"] = "1"
        node.attributes["driver.lxc.version"] = out.stdout.decode(
            errors="replace").strip()
        return True


register_driver("rkt", RktDriver)
register_driver("lxc", LxcDriver)
