"""The port's docker driver over the Engine API (``nomad_tpu_torch/
client/driver/docker_api.py``) against the JAX package's, twins of
``tests/test_docker_api.py``.

Each package drives its own fake dockerd, a threading HTTP server on a
unix socket in ``tmp_path`` that records every request (method, path,
JSON body) and answers like the daemon.  The same scenario through both
packages must send the same requests in the same order (the task dir's
path in the bind mount compared relative to each package's root) and
reach the same results: fingerprints, image pulls, container create
payloads, exit codes, the flushed logs, kills and signals, re-attach by
container id and the stats' executor schema.  ``_demux`` is held to the
reference's on seeded frame streams.
"""
import http.server
import json
import os
import random
import socketserver
import struct
import sys
import threading
import time

import jax  # noqa: F401  (kept like the other port tests)
import pytest

from nomad_tpu.client.driver import docker_api as jdocker
from nomad_tpu.client.driver import driver as jdriver
from nomad_tpu.client.driver import env as jenv
from nomad_tpu.structs import structs as js
from nomad_tpu_torch.client.driver import docker_api as pdocker
from nomad_tpu_torch.client.driver import driver as pdriver
from nomad_tpu_torch.client.driver import env as penv
from nomad_tpu_torch.structs import structs as ps

PKG = {"ref": (js, jdriver, jenv, jdocker),
       "port": (ps, pdriver, penv, pdocker)}
WAIT = 10.0


class _FakeDockerd(socketserver.ThreadingUnixStreamServer):
    allow_reuse_address = True
    daemon_threads = True

    def handle_error(self, request, client_address):
        # A client that hung up before the answer (a wait cut short by
        # the test's end) is not the daemon's fault.
        if not isinstance(sys.exc_info()[1], (BrokenPipeError,
                                               ConnectionResetError)):
            super().handle_error(request, client_address)


def frame(stream: int, payload: bytes) -> bytes:
    return bytes([stream, 0, 0, 0]) + struct.pack(">I", len(payload)) + payload


class FakeState:
    def __init__(self):
        self.lock = threading.Lock()
        self.requests = []
        self.containers = {}
        self.images = {"present:latest"}
        self.exit_code = 0
        self.wait_delay = 0.05


def make_handler(state: FakeState):
    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _record(self, body=b""):
            with state.lock:
                state.requests.append((self.command, self.path,
                                       json.loads(body) if body else None))

        def _send(self, code, body=b"", ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code, obj):
            self._send(code, json.dumps(obj).encode())

        def do_GET(self):
            path = self.path
            self._record()
            if path == "/_ping":
                return self._send(200, b"OK", "text/plain")
            if path.endswith("/version"):
                return self._json(200, {"Version": "99.fake"})
            if "/images/" in path and path.endswith("/json"):
                name = path.split("/images/")[1][:-len("/json")]
                name = name if ":" in name else name + ":latest"
                if name in state.images:
                    return self._json(200, {"Id": "sha256:abc"})
                return self._json(404, {"message": "no such image"})
            if path.endswith("/json") and "/containers/" in path:
                cid = path.split("/containers/")[1][:-len("/json")]
                if cid in state.containers:
                    return self._json(200, {"Id": cid,
                                            "State": {"Running": True}})
                return self._json(404, {"message": "no such container"})
            if "/logs" in path:
                return self._send(200, frame(1, b"hello-out\n")
                                  + frame(2, b"hello-err\n"),
                                  "application/octet-stream")
            if "/stats" in path:
                return self._json(200, {
                    "memory_stats": {"usage": 1048576},
                    "cpu_stats": {"cpu_usage": {"total_usage": 5000000}}})
            return self._json(404, {"message": f"GET {path}?"})

        def do_POST(self):
            path = self.path
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n) if n else b""
            self._record(body)
            if "/images/create" in path:
                state.images.add(path.split("fromImage=")[1])
                return self._send(200, b'{"status": "Download complete"}\n')
            if "/containers/create" in path:
                name = path.split("name=")[1] if "name=" in path else "c"
                cid = f"cid-{len(state.containers)}-{name[:20]}"
                state.containers[cid] = "created"
                return self._json(201, {"Id": cid})
            if path.endswith("/start"):
                return self._send(204)
            if path.endswith("/wait"):
                time.sleep(state.wait_delay)
                return self._json(200, {"StatusCode": state.exit_code})
            if "/kill" in path:
                return self._send(204)
            return self._json(404, {"message": f"POST {path}?"})

        def do_DELETE(self):
            self._record()
            cid = self.path.split("/containers/")[1].split("?")[0]
            state.containers.pop(cid, None)
            self._send(204)

    return Handler


@pytest.fixture
def daemons(tmp_path):
    """A fake dockerd for each package: {pkg: (socket path, state)}."""
    out, servers = {}, []
    for pkg in PKG:
        state = FakeState()
        sock = str(tmp_path / f"docker-{pkg}.sock")
        server = _FakeDockerd(sock, make_handler(state))
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers.append(server)
        out[pkg] = (sock, state)
    yield out
    for server in servers:
        server.shutdown()
        server.server_close()


class _TaskDir:
    def __init__(self, base):
        self.dir = str(base)
        self.log_dir = os.path.join(str(base), "logs")
        self.task_name = "web"


def mk(pkg, sock):
    m, drv, envmod, docker = PKG[pkg]
    api = docker.DockerAPI(socket_path=sock)
    d = docker.DockerAPIDriver(drv.DriverContext(
        driver_name="docker", alloc_id="a1", config=None), api)
    return d, api


def mk_task(pkg, image="present", command="", args=(), networks=False):
    m = PKG[pkg][0]
    task = m.Task(name="web", driver="docker", config={"image": image},
                  resources=m.Resources(cpu=250, memory_mb=64))
    if command:
        task.config["command"] = command
        task.config["args"] = list(args)
    if networks:
        task.config["port_map"] = {"http": "8080"}
        task.config["network_mode"] = "bridge"
        task.config["labels"] = {"team": "a"}
        task.resources.networks = [m.NetworkResource(
            ip="10.0.0.9", mbits=10,
            reserved_ports=[m.Port("admin", 9000)],
            dynamic_ports=[m.Port("http", 23456)])]
    return task


def exec_ctx(pkg, tmp_path):
    m, drv, envmod, _ = PKG[pkg]
    return drv.ExecContext(
        task_dir=_TaskDir(tmp_path / pkg / "task"),
        task_env=envmod.TaskEnv(env_map={"NOMAD_TASK_NAME": "web",
                                         "NOMAD_ALLOC_INDEX": "3"}))


def requests_of(pkg, tmp_path, state):
    root = str(tmp_path / pkg)
    return json.loads(json.dumps(state.requests).replace(root, "<root>"))


def test_fingerprint_equals_the_reference(daemons):
    out = {}
    for pkg in PKG:
        d, api = mk(pkg, daemons[pkg][0])
        node = PKG[pkg][0].Node()
        out[pkg] = (d.fingerprint(node), dict(node.attributes), d.periodic(),
                    daemons[pkg][1].requests)
    assert out["port"] == out["ref"]
    assert out["port"][1] == {"driver.docker": "1",
                              "driver.docker.version": "99.fake"}


def test_unavailable_socket_withdraws_the_driver(tmp_path):
    for pkg in PKG:
        d, api = mk(pkg, str(tmp_path / "nope.sock"))
        node = PKG[pkg][0].Node()
        node.attributes = {"driver.docker": "1",
                           "driver.docker.version": "1"}
        assert not api.available()
        assert d.fingerprint(node) is False and node.attributes == {}


@pytest.mark.parametrize("image,command,networks", [
    ("busybox", "sleep", False), ("present", "", False),
    ("registry.example/app:2", "run", True)])
def test_full_lifecycle_sends_the_reference_requests(daemons, tmp_path,
                                                     image, command,
                                                     networks):
    out = {}
    for pkg in PKG:
        sock, state = daemons[pkg]
        d, _ = mk(pkg, sock)
        task = mk_task(pkg, image, command, ["${NOMAD_ALLOC_INDEX}"],
                       networks)
        ctx = exec_ctx(pkg, tmp_path)
        d.prestart(ctx, task)
        h = d.start(ctx, task).handle
        assert h.wait_ch().wait(WAIT)
        logs = {f: open(os.path.join(ctx.task_dir.log_dir, f), "rb").read()
                for f in sorted(os.listdir(ctx.task_dir.log_dir))}
        out[pkg] = (h.id(), h.wait_result().exit_code, logs,
                    requests_of(pkg, tmp_path, state))
    assert out["port"] == out["ref"]
    hid, code, logs, reqs = out["port"]
    assert code == 0 and logs == {"web.stderr.0": b"hello-err\n",
                                  "web.stdout.0": b"hello-out\n"}
    create = [r for r in reqs if "/containers/create" in r[1]][0][2]
    assert create["Image"] == image
    assert create["HostConfig"]["Memory"] == 64 << 20
    if command:
        assert create["Cmd"] == [command, "3"]
    if networks:
        assert create["HostConfig"]["PortBindings"]["8080/tcp"] == [
            {"HostIp": "10.0.0.9", "HostPort": "23456"}]


@pytest.mark.parametrize("code", [0, 1, 137])
def test_exit_code_like_the_reference(daemons, tmp_path, code):
    out = {}
    for pkg in PKG:
        sock, state = daemons[pkg]
        state.exit_code = code
        d, _ = mk(pkg, sock)
        h = d.start(exec_ctx(pkg, tmp_path), mk_task(pkg)).handle
        assert h.wait_ch().wait(WAIT)
        out[pkg] = h.wait_result().exit_code
    assert out["port"] == out["ref"] == code


def test_kill_and_signal_like_the_reference(daemons, tmp_path):
    out = {}
    for pkg in PKG:
        sock, state = daemons[pkg]
        state.wait_delay = 0.5
        d, _ = mk(pkg, sock)
        h = d.start(exec_ctx(pkg, tmp_path), mk_task(pkg)).handle
        h.signal(15)
        h.kill()
        assert h.wait_ch().wait(WAIT)
        out[pkg] = [r[:2] for r in state.requests if "/kill" in r[1]]
    assert out["port"] == out["ref"]
    assert [p.split("signal=")[1] for _, p in out["port"]] == [
        "SIGTERM", "SIGKILL"]


def test_open_reattach_and_stats_like_the_reference(daemons, tmp_path):
    out = {}
    for pkg in PKG:
        sock, state = daemons[pkg]
        state.wait_delay = 0.5
        d, _ = mk(pkg, sock)
        ctx = exec_ctx(pkg, tmp_path)
        h = d.start(ctx, mk_task(pkg)).handle
        stats = h.stats()
        h2 = d.open(ctx, h.id())
        assert h2.wait_ch().wait(WAIT) and h.wait_ch().wait(WAIT)
        with pytest.raises(PKG[pkg][1].DriverError):
            d.open(ctx, "pid:1")
        out[pkg] = (stats, h2.id(), h2.wait_result().exit_code)
    assert out["port"] == out["ref"]
    assert out["port"][0]["rss_bytes"] == 1048576
    assert out["port"][0]["cpu_seconds"] == pytest.approx(0.005)


def test_missing_image_config_fails_like_the_reference(daemons, tmp_path):
    out = {}
    for pkg in PKG:
        d, _ = mk(pkg, daemons[pkg][0])
        try:
            d.prestart(exec_ctx(pkg, tmp_path), mk_task(pkg, image=""))
            out[pkg] = None
        except PKG[pkg][1].DriverError as e:
            out[pkg] = str(e)
    assert out["port"] == out["ref"] == "docker: image required"


def test_factory_falls_back_to_the_cli_without_a_daemon(tmp_path,
                                                        monkeypatch):
    from nomad_tpu.client.driver import exec_drivers as jexec
    from nomad_tpu_torch.client.driver import exec_drivers as pexec

    monkeypatch.setenv("DOCKER_HOST", f"unix://{tmp_path}/none.sock")
    for drv, execmod in ((jdriver, jexec), (pdriver, pexec)):
        d = drv.new_driver("docker", drv.DriverContext(
            driver_name="docker", alloc_id="", config=None))
        assert type(d) is execmod.DockerDriver


@pytest.mark.parametrize("seed", range(6))
def test_demux_equals_the_reference(seed):
    rng = random.Random(seed)
    raw = b"".join(frame(rng.choice([0, 1, 2]), bytes(
        rng.getrandbits(8) for _ in range(rng.randint(0, 40))))
        for _ in range(rng.randint(0, 8)))
    if seed % 3 == 1:
        raw += b"tail-without-frame"
    if seed % 3 == 2:
        raw = raw[:max(0, len(raw) - rng.randint(1, 5))]
    assert pdocker._demux(raw) == jdocker._demux(raw)
    assert pdocker._demux(b"raw tty output") == (b"raw tty output", b"")
