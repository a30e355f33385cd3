"""Task supervisor: a detached per-task subprocess that owns the task's
lifecycle, so the agent can restart and re-attach with FULL control —
including collecting the exit code of a task that finished while the
agent was down (a copy of ``nomad_tpu/client/driver/supervisor.py``).

Reference: the go-plugin executor subprocess
(client/driver/executor_plugin.go:1-60, plugins.go, executor.go:50,211):
every exec-family task runs under a plugin process the agent talks to
over RPC; agent restarts reconnect to the still-running plugin.  Here the
supervisor is ``python -m <this module> <ctl_dir>``,
detached into its own session, embedding the in-process Executor and
serving a line-JSON protocol on a unix socket:

    {"op": "ping"}                     → {"ok": true, "pid": <task pid>}
    {"op": "stats"}                    → {"ok": true, "stats": {...}}
    {"op": "signal", "sig": N}         → {"ok": true}
    {"op": "shutdown", "grace": secs}  → {"ok": true}
    {"op": "wait"}                     → blocks; {"ok": true, "result": ...}

Durability: when the task exits, the supervisor atomically writes
``exit.json`` into the control dir before anything else — so even if the
supervisor itself dies (or is reaped long before the agent returns), the
exit status is collectable from disk.  The control dir is the contract:

    <ctl_dir>/command.json    — the ExecCommand (written by the agent)
    <ctl_dir>/supervisor.pid  — the supervisor's pid
    <ctl_dir>/task.pid        — the task's pid (written post-launch)
    <ctl_dir>/sock            — control socket
    <ctl_dir>/exit.json       — terminal WaitResult (written at task exit)

Where the port departs from the JAX package's supervisor: once the task
has exited and a ``wait`` reply carrying its result has been delivered,
the supervisor exits at once instead of lingering ``LINGER_AFTER_EXIT``
s (the status is on disk in ``exit.json`` for any later collector), so
an agent that collected its tasks leaves no supervisor behind.  Without
a delivered reply it lingers as the reference's does.  Started as
``python -S -m <this module> <ctl_dir>`` (no site-packages), its
interpreter loads the standard library and this module, ``executor``
and ``cgroups``: not the structs, and never torch.
"""
from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time

# How long the supervisor keeps serving the socket after the task exits
# (exit.json already persisted) when no wait() reply has been delivered:
# enough for a live agent to collect the result without a disk poll
# round.
LINGER_AFTER_EXIT = 60.0


def _write_atomic(path: str, data: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(data, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def sock_path(ctl_dir: str) -> str:
    """Control-socket path for a ctl dir.

    NOT inside the ctl dir: AF_UNIX paths are capped at ~108 bytes and
    ctl dirs live inside alloc dirs whose paths can be arbitrarily deep
    (a too-long bind/connect path crashes the supervisor silently and
    loses the task's logs). The supervisor binds a short
    socket inside a private mode-0700 tempdir (unpredictable, so no
    shared-/tmp squatting or hijack) and advertises the real path via
    ``sock.path`` in the permission-protected ctl dir."""
    try:
        with open(os.path.join(ctl_dir, "sock.path")) as fh:
            return fh.read().strip()
    except OSError:
        # No advertisement (supervisor not up yet, or pre-bind): a
        # connect() to this per-ctl-dir placeholder fails cleanly.
        return os.path.join(ctl_dir, "sock")


def _make_private_sock_path() -> str:
    """A short socket path in a fresh private (0700) directory."""
    import tempfile

    d = tempfile.mkdtemp(prefix="ntpu-sup-")
    return os.path.join(d, "s")


def exit_path(ctl_dir: str) -> str:
    return os.path.join(ctl_dir, "exit.json")


def request(ctl_dir: str, req: dict, timeout: float = 5.0) -> dict:
    """One request/response round on the supervisor socket."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as sk:
        sk.settimeout(timeout)
        sk.connect(sock_path(ctl_dir))
        sk.sendall((json.dumps(req) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = sk.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.decode())


def main(ctl_dir: str) -> int:
    from .executor import ExecCommand, Executor

    with open(os.path.join(ctl_dir, "command.json")) as fh:
        spec = json.load(fh)
    command = ExecCommand(**spec)

    _write_atomic(os.path.join(ctl_dir, "supervisor.pid"),
                  {"pid": os.getpid()})

    # Bind the control socket BEFORE launching the task: the agent's
    # launch() returns once task.pid exists, so binding first guarantees
    # its result watcher can always take the socket wait path instead of
    # racing exit.json on disk.
    server = None
    spath = ""
    try:
        spath = _make_private_sock_path()
        server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        server.bind(spath)
        server.listen(8)
        with open(os.path.join(ctl_dir, "sock.path.tmp"), "w") as fh:
            fh.write(spath)
        os.replace(os.path.join(ctl_dir, "sock.path.tmp"),
                   os.path.join(ctl_dir, "sock.path"))
    except OSError:
        # Degraded but alive: no control socket, but the task still runs,
        # logs still pump, and exit.json still lands on disk. Never let
        # socket setup kill the supervisor.
        if server is not None:
            server.close()
        server = None
        _cleanup_sock(ctl_dir, spath)
        spath = ""

    executor = Executor(command)
    try:
        pid = executor.launch()
    except OSError as exc:
        _write_atomic(exit_path(ctl_dir),
                      {"exit_code": 127, "signal": 0,
                       "err": str(exc), "finished_at": time.time()})
        if server is not None:
            server.close()
        _cleanup_sock(ctl_dir, spath)
        return 1
    _write_atomic(os.path.join(ctl_dir, "task.pid"), {"pid": pid})

    done = threading.Event()
    # Set once a wait() reply with the result has been delivered.
    collected = threading.Event()

    def reaper():
        executor.exited.wait()
        res = executor.result
        _write_atomic(exit_path(ctl_dir), {
            "exit_code": res.exit_code,
            "signal": res.signal,
            "err": getattr(res, "err", "") or "",
            "finished_at": time.time(),
        })
        collected.wait(LINGER_AFTER_EXIT)
        done.set()
        # Wake the accept loop.
        try:
            poke = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            poke.connect(spath)
            poke.close()
        except OSError:
            pass

    threading.Thread(target=reaper, daemon=True).start()

    def serve(conn: socket.socket) -> None:
        try:
            fh = conn.makefile("rwb")
            line = fh.readline()
            if not line:
                return
            req = json.loads(line.decode())
            op = req.get("op")
            if op == "ping":
                resp = {"ok": True, "pid": executor.pid,
                        "exited": executor.result is not None}
            elif op == "stats":
                resp = {"ok": True, "stats": executor.stats()}
            elif op == "signal":
                executor.send_signal(int(req.get("sig", 15)))
                resp = {"ok": True}
            elif op == "shutdown":
                # Run the grace period out of line so the reply is
                # immediate; exit status arrives via wait/exit.json.
                threading.Thread(
                    target=executor.shutdown,
                    kwargs={"grace": float(req.get("grace", 5.0))},
                    daemon=True).start()
                resp = {"ok": True}
            elif op == "wait":
                executor.exited.wait()
                res = executor.result
                resp = {"ok": True, "result": {
                    "exit_code": res.exit_code, "signal": res.signal,
                    "err": getattr(res, "err", "") or ""}}
            else:
                resp = {"ok": False, "err": f"unknown op {op!r}"}
            fh.write((json.dumps(resp) + "\n").encode())
            fh.flush()
            if op == "wait":
                collected.set()
        except (OSError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    if server is None:
        # No control socket (cleaned up in the bind-failure handler):
        # just outlive the task long enough for a collector to land on
        # exit.json.
        executor.exited.wait()
        time.sleep(LINGER_AFTER_EXIT)
        return 0
    while not done.is_set():
        try:
            conn, _ = server.accept()
        except OSError:
            break
        threading.Thread(target=serve, args=(conn,), daemon=True).start()
    server.close()
    _cleanup_sock(ctl_dir, spath)
    return 0


def _cleanup_sock(ctl_dir: str, spath: str) -> None:
    # The advertisement goes only if it is still this supervisor's: a
    # later run of the task may have a supervisor of its own there.
    advert = os.path.join(ctl_dir, "sock.path")
    try:
        with open(advert) as fh:
            mine = fh.read().strip() == spath
    except OSError:
        mine = False
    for p in ((advert, spath) if mine else (spath,)):
        if not p:
            continue
        try:
            os.unlink(p)
        except OSError:
            pass
    if spath:
        try:
            os.rmdir(os.path.dirname(spath))
        except OSError:
            pass


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
