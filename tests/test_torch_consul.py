"""The port's consul-shaped catalog and service client
(``nomad_tpu_torch/consul``) against the JAX package's
(``nomad_tpu/consul``): the same calls on both, the catalog's answers
compared by their wire form; the script and TCP checks; and the agent's
self-registration (a server-only agent, as the port runs no client: the
reference's client-discovery scenario waits for ROADMAP item 28).
"""
import dataclasses
import socketserver
import threading

import jax  # noqa: F401  (kept like the other port tests)
import pytest

from nomad_tpu import consul as jconsul
from nomad_tpu import mock as jmock
from nomad_tpu.consul.catalog import CHECK_CRITICAL as JCHECK_CRITICAL
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import consul, convert
from nomad_tpu_torch.agent import Agent, parse_config
from nomad_tpu_torch.consul.catalog import CHECK_CRITICAL, CHECK_PASSING
from nomad_tpu_torch.structs import structs as ps
from nomad_tpu_torch.utils.backoff import wait_until

PKGS = {"ref": (jconsul, js), "port": (consul, ps)}


def catalog_ops(pkg):
    """A register / query / deregister sequence and the catalog's answers
    after each step."""
    cons, _ = pkg
    cat = cons.ServiceCatalog()
    out = []
    cat.register(cons.CatalogEntry(id="a", name="web", tags=["v1"],
                                   address="10.0.0.1", port=80))
    cat.register(cons.CatalogEntry(id="b", name="web", tags=["v2"],
                                   address="10.0.0.2", port=81))
    cat.register(cons.CatalogEntry(id="c", name="db", address="10.0.0.3",
                                   port=5432))
    out.append(cat.services())
    out.append([e.to_wire() for e in cat.service("web")])
    out.append([e.to_wire() for e in cat.service("web", tag="v2")])
    out.append([e.to_wire() for e in cat.service("db", healthy_only=True)])
    cat.deregister("a")
    out.append([e.to_wire() for e in cat.service("web")])
    out.append((cat.kv_set("app/a", "1"), cat.kv_set("app/b", "2"),
                cat.kv_get("app/a"), cat.kv_list("app/"), cat.kv_index()))
    cat.kv_delete("app/a")
    out.append((cat.kv_get("app/a"), cat.kv_list(""), cat.ids()))
    return out


def test_catalog_matches_reference():
    assert catalog_ops(PKGS["port"]) == catalog_ops(PKGS["ref"])


def alloc_with_service(kind, checks=()):
    """A reference alloc whose web task advertises one service (converted
    for the port)."""
    job = jmock.job()
    task = job.task_groups[0].tasks[0]
    task.services = [js.Service(name="web-frontend", port_label="http",
                                tags=["prod"], checks=list(checks))]
    alloc = jmock.alloc()
    alloc.id = "11111111-2222-3333-4444-555555555555"
    alloc.job = job
    alloc.task_resources = {"web": js.Resources(networks=[
        js.NetworkResource(device="eth0", ip="192.168.1.10", mbits=10,
                           dynamic_ports=[js.Port("http", 23456)])])}
    if kind == "port":
        alloc = convert.alloc_from_dict(dataclasses.asdict(alloc))
        task = alloc.job.task_groups[0].tasks[0]
    return alloc, task


@pytest.mark.parametrize("checks", [(), (js.ServiceCheck(
    name="status", type="script", command="/bin/check", interval=30.0),)],
    ids=["no_check", "script_check"])
def test_task_service_lifecycle_matches_reference(checks):
    got = {}
    for kind, (cons, _) in PKGS.items():
        cat = cons.ServiceCatalog()
        sc = cons.ServiceClient(cat)
        alloc, task = alloc_with_service(kind, checks)
        ids = sc.register_task(alloc, task)
        entries = [e.to_wire() for e in cat.service("web-frontend")]
        sc.deregister_task(alloc.id, task.name)
        got[kind] = (ids, entries, cat.service("web-frontend"))
    assert got["port"] == got["ref"]
    ids, entries, after = got["port"]
    assert entries[0]["Address"] == "192.168.1.10"
    assert entries[0]["Port"] == 23456 and after == []


def test_script_check_runs_through_exec():
    cat = consul.ServiceCatalog()
    sc = consul.ServiceClient(cat)
    sc.start()
    try:
        chk = js.ServiceCheck(name="status", type="script",
                              command="/bin/check", interval=0.1)
        alloc, task = alloc_with_service("port", checks=[chk])
        calls = {"n": 0}

        def exec_fn(cmd, args):
            calls["n"] += 1
            return f"run {calls['n']}", (0 if calls["n"] < 3 else 1)

        sc.register_task(alloc, task, exec_fn=exec_fn)
        sid = cat.service("web-frontend")[0].id
        assert wait_until(lambda: calls["n"] >= 3, 5.0)
        assert wait_until(lambda: cat.entry(sid).checks[0].status
                          == CHECK_CRITICAL, 5.0)
        assert not cat.entry(sid).healthy()
        assert CHECK_CRITICAL == JCHECK_CRITICAL
    finally:
        sc.stop()
    assert not sc._thread.is_alive()


def test_tcp_check():
    class Quiet(socketserver.BaseRequestHandler):
        def handle(self):
            pass

    srv = socketserver.TCPServer(("127.0.0.1", 0), Quiet)
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    cat = consul.ServiceCatalog()
    sc = consul.ServiceClient(cat)
    sc.start()
    try:
        chk = js.ServiceCheck(name="up", type="tcp", port_label="http",
                              interval=0.1, timeout=1.0)
        alloc, task = alloc_with_service("port", checks=[chk])
        net = alloc.task_resources["web"].networks[0]
        net.ip = "127.0.0.1"
        net.dynamic_ports = [ps.Port("http", port)]
        sc.register_task(alloc, task)
        sid = cat.service("web-frontend")[0].id
        assert wait_until(lambda: cat.entry(sid).checks[0].output
                          == "tcp connect ok", 5.0)
        assert cat.entry(sid).checks[0].status == CHECK_PASSING
    finally:
        sc.stop()
        srv.shutdown()
        srv.server_close()


def test_server_agent_registers_itself_in_its_catalog(tmp_path):
    cfg = parse_config('server { enabled = true }\n'
                       'ports {\n  http = 0\n  rpc = 0\n}\n'
                       f'data_dir = "{tmp_path}"')
    cfg.dev_mode = True
    a = Agent(cfg, device="cpu",
              server_options={"min_heartbeat_ttl": 3600.0})
    a.start()
    try:
        nomads = a.catalog.service("nomad")
        assert len(nomads) == 1
        assert (f"{nomads[0].address}:{nomads[0].port}"
                == a.server.config.rpc_advertise)
        assert nomads[0].tags == ["rpc"]
        assert a.catalog.service("nomad-client") == []
    finally:
        a.shutdown()
    assert wait_until(lambda: not a.threads(), 15.0)
