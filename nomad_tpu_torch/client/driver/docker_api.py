"""Docker driver over the Engine API (a copy of
``nomad_tpu/client/driver/docker_api.py``; reference:
client/driver/docker.go, which speaks the API via go-dockerclient — the
CLI shell-out in exec_drivers.py remains as the fallback when no daemon
socket is reachable).

The API client is a minimal HTTP-over-unix-socket implementation
(http.client with a connect() override) covering the container lifecycle
the driver needs: ping/version, image pull, create/start/wait/kill/
remove, multiplexed log streaming, and one-shot stats.  No SDK.
"""
from __future__ import annotations

import http.client
import json
import os
import socket
import struct
import threading
from typing import Dict, Optional, Tuple

from ...structs import structs as s
from .driver import (
    Driver,
    DriverAbilities,
    DriverError,
    DriverHandle,
    ExecContext,
    StartResponse,
    WaitResult,
    opt,
)

DEFAULT_SOCKET = "/var/run/docker.sock"
API_VERSION = "v1.24"  # old enough for every live daemon

# socket path → (available, probed_at); see DockerAPI.available().
_AVAILABLE_CACHE: Dict[str, tuple] = {}


class _UnixHTTPConnection(http.client.HTTPConnection):
    def __init__(self, socket_path: str, timeout: Optional[float]):
        super().__init__("localhost", timeout=timeout)
        self._socket_path = socket_path

    def connect(self) -> None:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        if self.timeout is not None:
            sock.settimeout(self.timeout)
        sock.connect(self._socket_path)
        self.sock = sock


class DockerAPIError(DriverError):
    pass


class DockerAPI:
    """Minimal Docker Engine API client."""

    def __init__(self, socket_path: str = DEFAULT_SOCKET):
        host = os.environ.get("DOCKER_HOST", "")
        if host.startswith("unix://"):
            socket_path = host[len("unix://"):]
        self.socket_path = socket_path

    def available(self, cache_ttl: float = 30.0) -> bool:
        """Daemon reachability, cached per socket path: the probe runs on
        every driver instantiation (incl. static job validation), and a
        present-but-hung daemon must not stall each of those by 2s."""
        import time as _time

        ent = _AVAILABLE_CACHE.get(self.socket_path)
        now = _time.monotonic()
        if ent is not None and now - ent[1] < cache_ttl:
            return ent[0]
        ok = False
        if os.path.exists(self.socket_path):
            try:
                status, _ = self._request("GET", "/_ping", timeout=2)
                ok = status == 200
            except (OSError, http.client.HTTPException):
                ok = False
        _AVAILABLE_CACHE[self.socket_path] = (ok, now)
        return ok

    # -- plumbing ----------------------------------------------------------

    def _request(self, method: str, path: str, body: Optional[dict] = None,
                 timeout: Optional[float] = 60.0,
                 raw: bool = False) -> Tuple[int, object]:
        conn = _UnixHTTPConnection(self.socket_path, timeout)
        try:
            payload = None
            headers = {}
            if body is not None:
                payload = json.dumps(body).encode()
                headers["Content-Type"] = "application/json"
            conn.request(method, f"/{API_VERSION}{path}"
                         if not path.startswith("/_") else path,
                         body=payload, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            if raw:
                return resp.status, data
            if data and resp.headers.get_content_type() == "application/json":
                try:
                    return resp.status, json.loads(data)
                except json.JSONDecodeError:
                    return resp.status, data
            return resp.status, data
        finally:
            conn.close()

    def _check(self, status: int, data, what: str):
        if status >= 300:
            msg = data.get("message") if isinstance(data, dict) else data
            raise DockerAPIError(f"{what}: HTTP {status}: {msg}")
        return data

    # -- API surface -------------------------------------------------------

    def version(self) -> dict:
        return self._check(*self._request("GET", "/version", timeout=5),
                           "version")

    def pull(self, image: str) -> None:
        """POST /images/create — consume the progress stream fully (the
        pull isn't done until the stream closes)."""
        if ":" not in image.rsplit("/", 1)[-1]:
            image = image + ":latest"
        status, data = self._request(
            "POST", f"/images/create?fromImage={image}", timeout=600,
            raw=True)
        if status >= 300:
            raise DockerAPIError(f"pull {image}: HTTP {status}: "
                                 f"{data[:200]!r}")
        # Progress stream is NDJSON; an inline error object means failure.
        for line in data.splitlines():
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(msg, dict) and msg.get("error"):
                raise DockerAPIError(f"pull {image}: {msg['error']}")

    def image_exists(self, image: str) -> bool:
        status, _ = self._request("GET", f"/images/{image}/json", timeout=10)
        return status == 200

    def create_container(self, name: str, config: dict) -> str:
        data = self._check(*self._request(
            "POST", f"/containers/create?name={name}", body=config),
            f"create {name}")
        return data["Id"]

    def start(self, cid: str) -> None:
        status, data = self._request("POST", f"/containers/{cid}/start")
        if status not in (204, 304):
            self._check(status, data, f"start {cid}")

    def wait(self, cid: str) -> int:
        """Blocks until the container exits; returns its exit code."""
        data = self._check(*self._request(
            "POST", f"/containers/{cid}/wait", timeout=None), f"wait {cid}")
        return int(data.get("StatusCode", -1))

    def kill(self, cid: str, signal_name: str = "SIGKILL") -> None:
        status, data = self._request(
            "POST", f"/containers/{cid}/kill?signal={signal_name}")
        if status not in (204, 304, 404, 409):
            self._check(status, data, f"kill {cid}")

    def stop(self, cid: str, timeout_s: int = 5) -> None:
        status, data = self._request(
            "POST", f"/containers/{cid}/stop?t={timeout_s}",
            timeout=timeout_s + 30)
        if status not in (204, 304, 404):
            self._check(status, data, f"stop {cid}")

    def remove(self, cid: str, force: bool = True) -> None:
        status, data = self._request(
            "DELETE", f"/containers/{cid}?force={'true' if force else 'false'}")
        if status not in (204, 404):
            self._check(status, data, f"remove {cid}")

    def inspect(self, cid: str) -> dict:
        return self._check(*self._request("GET", f"/containers/{cid}/json"),
                           f"inspect {cid}")

    def logs(self, cid: str) -> Tuple[bytes, bytes]:
        """Full stdout/stderr so far, demultiplexed from the 8-byte-header
        stream framing (Engine API 'attach' framing)."""
        status, data = self._request(
            "GET", f"/containers/{cid}/logs?stdout=1&stderr=1", raw=True)
        if status >= 300:
            raise DockerAPIError(f"logs {cid}: HTTP {status}")
        return _demux(data)

    def stats(self, cid: str) -> dict:
        status, data = self._request(
            "GET", f"/containers/{cid}/stats?stream=false", timeout=10)
        if status >= 300:
            return {}
        return data if isinstance(data, dict) else {}


def _demux(raw: bytes) -> Tuple[bytes, bytes]:
    """Split a multiplexed attach/logs stream into (stdout, stderr).
    Frames: [stream u8][0 u8 x3][len u32 BE][payload]."""
    out, err = bytearray(), bytearray()
    i = 0
    n = len(raw)
    while i + 8 <= n:
        stream = raw[i]
        # A valid frame header is [0|1|2][\x00 x3][len u32]; anything else
        # means the stream is unframed (TTY container) — hand it back raw.
        if stream not in (0, 1, 2) or raw[i + 1:i + 4] != b"\x00\x00\x00":
            if i == 0:
                return bytes(raw), b""
            out.extend(raw[i:])
            break
        (length,) = struct.unpack(">I", raw[i + 4:i + 8])
        payload = raw[i + 8:i + 8 + length]
        if stream == 2:
            err.extend(payload)
        else:
            out.extend(payload)
        i += 8 + length
    if i == 0 and n:  # shorter than one header: raw
        return bytes(raw), b""
    return bytes(out), bytes(err)


class DockerAPIHandle(DriverHandle):
    """Handle for an API-managed container: waits via /wait, kills via
    /kill, reattaches by container id after agent restart."""

    def __init__(self, api: DockerAPI, cid: str, task_name: str,
                 log_dir: Optional[str] = None):
        self.api = api
        self.cid = cid
        self.task_name = task_name
        self.log_dir = log_dir
        self._done = threading.Event()
        self._result = WaitResult()
        self._waiter = threading.Thread(target=self._wait_loop,
                                        name=f"docker-wait-{cid[:12]}",
                                        daemon=True)
        self._waiter.start()

    def _wait_loop(self) -> None:
        try:
            code = self.api.wait(self.cid)
            self._result = WaitResult(exit_code=code)
        except Exception as exc:
            self._result = WaitResult(exit_code=-1, err=str(exc))
        try:
            self._flush_logs()
            self.api.remove(self.cid, force=True)
        except Exception:
            pass
        self._done.set()

    def _flush_logs(self) -> None:
        """Write collected container output into the task log tree the fs
        endpoint serves (executor log-file naming)."""
        if not self.log_dir:
            return
        try:
            out, err = self.api.logs(self.cid)
        except Exception:
            return
        os.makedirs(self.log_dir, exist_ok=True)
        for suffix, data in (("stdout", out), ("stderr", err)):
            with open(os.path.join(
                    self.log_dir, f"{self.task_name}.{suffix}.0"), "ab") as fh:
                fh.write(data)

    # -- DriverHandle ------------------------------------------------------

    def id(self) -> str:
        return f"docker-api:{self.cid}"

    def wait_ch(self) -> threading.Event:
        return self._done

    def wait_result(self) -> WaitResult:
        return self._result

    def update(self, task: s.Task) -> None:
        pass

    def kill(self) -> None:
        # Transport hiccups are absorbed like the executor handle's
        # shutdown path — the destroy flow must not mark the task dead
        # while leaving the container running silently; the wait loop
        # still owns cleanup when the container eventually exits.
        try:
            self.api.kill(self.cid)
        except (OSError, http.client.HTTPException, DriverError) as exc:
            import logging

            logging.getLogger("nomad_tpu_torch.client.driver.docker").warning(
                "docker kill %s failed: %s", self.cid[:12], exc)

    def signal(self, sig: int) -> None:
        import signal as _signal

        try:
            name = _signal.Signals(sig).name
        except ValueError:
            name = str(sig)
        try:
            self.api.kill(self.cid, name)
        except (OSError, http.client.HTTPException, DriverError) as exc:
            import logging

            logging.getLogger("nomad_tpu_torch.client.driver.docker").warning(
                "docker signal %s %s failed: %s", name, self.cid[:12], exc)

    def stats(self) -> Dict:
        """Executor-schema stats ({rss_bytes, cpu_seconds, ...}) so the
        client stats endpoint reports one shape regardless of which
        transport ran the docker task."""
        raw = self.api.stats(self.cid)
        mem = (raw.get("memory_stats") or {}).get("usage", 0)
        cpu_ns = ((raw.get("cpu_stats") or {}).get("cpu_usage") or {}).get(
            "total_usage", 0)
        return {"rss_bytes": mem, "cpu_seconds": cpu_ns / 1e9,
                "container_id": self.cid}


class DockerAPIDriver(Driver):
    """Container tasks via the Engine API (docker.go semantics: pull if
    absent, create with env/memory/labels/network, start, wait)."""

    name = "docker"

    # Single source of truth for the task-config schema: whichever
    # transport the factory picks, a docker job validates identically.
    from .exec_drivers import DockerDriver as _CLI

    CONFIG_FIELDS = _CLI.CONFIG_FIELDS

    def __init__(self, ctx, api: Optional[DockerAPI] = None):
        super().__init__(ctx)
        self.api = api or DockerAPI()

    def abilities(self) -> DriverAbilities:
        return DriverAbilities(send_signals=True, exec=False)

    def fs_isolation(self) -> str:
        from .driver import FS_ISOLATION_IMAGE

        return FS_ISOLATION_IMAGE

    def prestart(self, exec_ctx: ExecContext, task: s.Task):
        cfg = task.config or {}
        image = exec_ctx.task_env.replace_env(opt(cfg, "image", ""))
        if not image:
            raise DriverError("docker: image required")
        if not self.api.image_exists(image):
            self.api.pull(image)
        return None

    def start(self, exec_ctx: ExecContext, task: s.Task) -> StartResponse:
        cfg = task.config or {}
        env = exec_ctx.task_env
        image = env.replace_env(opt(cfg, "image", ""))
        # Unique per allocation (docker.go names containers
        # <task>-<alloc-id>); two allocs of the same task on one node
        # must not collide.
        name = f"nomad-{task.name}-{self.ctx.alloc_id or os.getpid()}"

        container: dict = {
            "Image": image,
            "Env": [f"{k}={v}" for k, v in env.env().items()],
            "Labels": dict(opt(cfg, "labels", {}) or {}),
            "HostConfig": {},
        }
        cmd_override = opt(cfg, "command", "")
        if cmd_override:
            container["Cmd"] = [env.replace_env(cmd_override)] + \
                env.parse_and_replace(
                    [str(a) for a in opt(cfg, "args", []) or []])
        hc = container["HostConfig"]
        if task.resources is not None:
            if task.resources.memory_mb:
                hc["Memory"] = task.resources.memory_mb * 1024 * 1024
            if task.resources.cpu:
                hc["CpuShares"] = task.resources.cpu
        mode = opt(cfg, "network_mode", "")
        if mode:
            hc["NetworkMode"] = mode
        # Mount the task dir at the NOMAD_TASK_DIR the env advertises.
        task_dir = getattr(exec_ctx.task_dir, "dir", None)
        if task_dir:
            hc["Binds"] = [f"{task_dir}:/nomad/task"]
        # Port bindings from the task's network offer + port_map labels.
        port_map = dict(opt(cfg, "port_map", {}) or {})
        bindings: Dict[str, list] = {}
        nets = task.resources.networks if task.resources else []
        for net in nets or []:
            for port in list(net.reserved_ports) + list(net.dynamic_ports):
                inside = int(port_map.get(port.label, port.value))
                bindings[f"{inside}/tcp"] = [
                    {"HostIp": net.ip or "", "HostPort": str(port.value)}]
        if bindings:
            hc["PortBindings"] = bindings
            container["ExposedPorts"] = {k: {} for k in bindings}

        # Purge a stale same-name container (crash before the wait loop's
        # remove) — docker.go does the same before create.
        self.api.remove(name, force=True)
        cid = self.api.create_container(name, container)
        try:
            self.api.start(cid)
        except DriverError:
            # Don't leak the created-but-unstarted container.
            self.api.remove(cid, force=True)
            raise
        log_dir = getattr(exec_ctx.task_dir, "log_dir", None)
        handle = DockerAPIHandle(self.api, cid, task.name, log_dir)
        return StartResponse(handle=handle)

    def open(self, exec_ctx: ExecContext, handle_id: str) -> DriverHandle:
        if not handle_id.startswith("docker-api:"):
            raise DriverError(f"not a docker api handle: {handle_id}")
        cid = handle_id.split(":", 1)[1]
        self.api.inspect(cid)  # raises if gone
        log_dir = getattr(exec_ctx.task_dir, "log_dir", None)
        task_name = getattr(exec_ctx.task_dir, "task_name", None) or \
            os.path.basename(exec_ctx.task_dir.dir)
        return DockerAPIHandle(self.api, cid, task_name, log_dir)

    def fingerprint(self, node: s.Node) -> bool:
        if not self.api.available():
            # The daemon went away: withdraw the capability so the
            # scheduler stops placing docker tasks here (the sibling
            # drivers pop their attribute the same way).
            node.attributes.pop("driver.docker", None)
            node.attributes.pop("driver.docker.version", None)
            return False
        try:
            ver = self.api.version()
        except DriverError:
            node.attributes.pop("driver.docker", None)
            node.attributes.pop("driver.docker.version", None)
            return False
        node.attributes["driver.docker"] = "1"
        node.attributes["driver.docker.version"] = str(
            ver.get("Version", ""))
        return True

    def periodic(self):
        return (True, 30.0)
