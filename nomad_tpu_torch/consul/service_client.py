"""Task service/check registration against the catalog (a copy of
``nomad_tpu/consul/service_client.py``; reference:
command/agent/consul/client.go:87 ServiceClient; script checks via
DriverHandle exec, consul/script.go)."""

from __future__ import annotations

import logging
import socket
import threading
import time
from typing import Callable, Dict, List, Optional

from ..structs import structs as s
from .catalog import (
    CHECK_CRITICAL,
    CHECK_PASSING,
    CatalogCheck,
    CatalogEntry,
    ServiceCatalog,
)


def make_task_service_id(alloc_id: str, task: str, svc_name: str) -> str:
    """(consul/client.go makeTaskServiceID convention)."""
    return f"_nomad-task-{alloc_id}-{task}-{svc_name}"


class ServiceClient:
    """Registers task services + checks, runs the check loops, and keeps
    the catalog in sync with task lifecycles."""

    def __init__(self, catalog: ServiceCatalog,
                 logger: Optional[logging.Logger] = None):
        self.catalog = catalog
        self.logger = logger or logging.getLogger("nomad_tpu_torch.consul")
        self._l = threading.Lock()
        # check runner state: (service_id, check_id) -> spec dict
        self._checks: Dict[tuple, Dict] = {}
        self._by_task: Dict[tuple, List[str]] = {}  # (alloc, task) -> ids
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._check_loop,
                                        name="consul-checks", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the check loop and join its thread (bounded)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    # -- agent self-registration (agent.go:492) ------------------------

    def register_agent(self, role: str, address: str, port: int,
                       tags: Optional[List[str]] = None) -> None:
        """Register the agent itself: 'nomad' for servers (rpc port),
        'nomad-client' for clients (http port)."""
        name = "nomad" if role == "server" else "nomad-client"
        entry = CatalogEntry(
            id=f"_nomad-{role}-{address}-{port}",
            name=name, tags=tags or [role],
            address=address, port=port)
        self.catalog.register(entry)

    # -- task services (consul/client.go RegisterTask) -----------------

    def register_task(self, alloc: s.Allocation, task: s.Task,
                      address: str = "",
                      exec_fn: Optional[Callable] = None) -> List[str]:
        """Register every service of ``task``; ports resolve through the
        alloc's network offer port labels (client.go resolve via
        task resources).  ``exec_fn(cmd, args) -> (output, exit_code)``
        (the DriverHandle.exec_cmd shape) runs script checks inside the
        task (consul/script.go)."""
        ids: List[str] = []
        tr = alloc.task_resources.get(task.name)
        labels: Dict[str, int] = {}
        ip = address
        if tr is not None and tr.networks:
            offer = tr.networks[0]
            labels = offer.port_labels()
            ip = offer.ip or ip
        for svc in task.services or []:
            sid = make_task_service_id(alloc.id, task.name, svc.name)
            checks = []
            for i, chk in enumerate(svc.checks or []):
                cid = f"{sid}-check{i}"
                checks.append(CatalogCheck(
                    id=cid, name=chk.name or f"service: {svc.name} check",
                    type=chk.type,
                    status=chk.initial_status or CHECK_PASSING))
                with self._l:
                    self._checks[(sid, cid)] = {
                        "check": chk, "exec_fn": exec_fn,
                        "address": ip,
                        "port": labels.get(chk.port_label or svc.port_label, 0),
                        "next_run": time.monotonic() + chk.interval,
                    }
            entry = CatalogEntry(
                id=sid, name=svc.name, tags=list(svc.tags),
                address=ip, port=labels.get(svc.port_label, 0),
                checks=checks)
            self.catalog.register(entry)
            ids.append(sid)
        with self._l:
            self._by_task[(alloc.id, task.name)] = ids
        return ids

    def deregister_task(self, alloc_id: str, task_name: str) -> None:
        with self._l:
            ids = self._by_task.pop((alloc_id, task_name), [])
            for sid in ids:
                for key in [k for k in self._checks if k[0] == sid]:
                    del self._checks[key]
        for sid in ids:
            self.catalog.deregister(sid)

    # -- check execution (script/tcp/http; consul/script.go) -----------

    def _check_loop(self) -> None:
        while not self._stop.is_set():
            now = time.monotonic()
            due = []
            with self._l:
                for key, spec in self._checks.items():
                    if spec["next_run"] <= now:
                        spec["next_run"] = now + spec["check"].interval
                        due.append((key, dict(spec)))
            for (sid, cid), spec in due:
                status, output = self._run_check(spec)
                self.catalog.set_check_status(sid, cid, status, output)
            self._stop.wait(0.2)

    def _run_check(self, spec: Dict) -> tuple:
        chk: s.ServiceCheck = spec["check"]
        try:
            if chk.type == "script":
                exec_fn = spec.get("exec_fn")
                if exec_fn is None:
                    return CHECK_CRITICAL, "no exec available for script check"
                output, code = exec_fn(chk.command, chk.args)
                if isinstance(output, bytes):
                    output = output.decode("utf-8", "replace")
                return (CHECK_PASSING if code == 0 else CHECK_CRITICAL,
                        str(output)[:256])
            if chk.type == "tcp":
                with socket.create_connection(
                        (spec["address"] or "127.0.0.1", spec["port"]),
                        timeout=chk.timeout):
                    return CHECK_PASSING, "tcp connect ok"
            if chk.type == "http":
                import urllib.request
                proto = chk.protocol or "http"
                url = (f"{proto}://{spec['address'] or '127.0.0.1'}:"
                       f"{spec['port']}{chk.path or '/'}")
                with urllib.request.urlopen(url, timeout=chk.timeout) as r:
                    ok = 200 <= r.status < 300
                    return (CHECK_PASSING if ok else CHECK_CRITICAL,
                            f"HTTP {r.status}")
            # Consul rejects unknown check types at registration; never
            # report an un-runnable check as healthy.
            return CHECK_CRITICAL, f"unknown check type {chk.type!r}"
        except Exception as e:
            return CHECK_CRITICAL, str(e)
