"""The agent: a server in one process plus the HTTP API (a copy of
``nomad_tpu/agent/agent.py``; reference: command/agent/agent.go:46-719,
setupServer at agent.go:336, NewHTTPServer wiring).

The port's agent runs a server only.  A config that enables the client
raises ``NotImplementedError`` (the client is ROADMAP item 28), and so
does one that enables vault or joins another region over the WAN (item
30): each before any port is bound, never a silent start without it.
The server runs on ``device`` (default ``cuda``: without a card the
server's construction raises; there is no CPU fallback).  ``server {
use_tpu_batch_worker = ... }`` parses and changes nothing: the port's
server has only the batch worker (ROADMAP queue 3 item 19).
``server_options`` adds ``ServerConfig`` fields that an agent config
file cannot carry (seeds, a breaker, the node heartbeat TTL), for a
program that embeds the agent.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from .. import __version__ as VERSION
from ..server.server import Server, ServerConfig
from .config import AgentConfig, split_host_port
from .http import HTTPServer


def _advertisable(host: str) -> str:
    """A wildcard bind must never reach the catalog: a peer dialing
    0.0.0.0 connects to itself (agent.go advertise-address resolution)."""
    if not host or host == "0.0.0.0":
        import socket

        try:
            return socket.gethostbyname(socket.gethostname())
        except OSError:
            return "127.0.0.1"
    return host


def _refuse_unported(config: AgentConfig) -> None:
    """Raise for what the agent's config asks that the port does not
    have, before anything is built or bound."""
    if config.client.enabled:
        raise NotImplementedError(
            "client mode is not ported: the client is ROADMAP item 28; "
            "run a server-only agent (client { enabled = false })")
    if config.vault.enabled:
        raise NotImplementedError(
            "vault is not ported: the vault integration is ROADMAP item "
            "30; remove the vault block or set enabled = false")
    if config.server.wan_join:
        raise NotImplementedError(
            "retry_join_wan is not ported: the federation is ROADMAP "
            "item 30")
    if config.server.enabled_schedulers:
        raise NotImplementedError(
            "enabled_schedulers is not ported: the port's server runs the "
            "batch worker only (ROADMAP queue 3 item 19)")


class Agent:
    def __init__(self, config: Optional[AgentConfig] = None,
                 logger: Optional[logging.Logger] = None,
                 device: str = "cuda",
                 server_options: Optional[Dict] = None):
        self.config = config or AgentConfig.dev()
        _refuse_unported(self.config)
        self.device = device
        self.server_options = dict(server_options or {})
        self.logger = logger or logging.getLogger("nomad_tpu_torch.agent")
        # Log ring for /v1/agent/monitor (command/agent/log_writer.go):
        # retains recent lines and fans out to attached monitors.  NOTE:
        # agents sharing one logger in one process (tests) share the
        # stream, like processes sharing stderr; shutdown detaches the
        # handler and restores the level.
        from ..utils.logring import LogRingHandler

        self.log_ring = LogRingHandler()
        self.log_ring.setLevel(getattr(logging, self.config.log_level.upper(),
                                       logging.INFO))
        self._prev_log_level = self.logger.level
        self.logger.addHandler(self.log_ring)
        self.logger.setLevel(min(self.logger.level or logging.INFO,
                                 self.log_ring.level) or logging.INFO)
        self.server: Optional[Server] = None
        self.http: Optional[HTTPServer] = None
        self._server_started = False
        # Consul-shaped catalog + service client (command/agent/consul/):
        # the agent hosts the catalog and registers itself.
        from ..consul import ServiceCatalog, ServiceClient

        self.catalog = ServiceCatalog()
        self.consul_service_client = ServiceClient(
            self.catalog, logger=self.logger.getChild("consul"))
        try:
            self._setup_server()
        except BaseException:
            self._detach_log()
            raise
        if self.server is None:
            self._detach_log()
            raise ValueError(
                "must have at least client or server mode enabled")

    # -- composition (agent.go:336) ----------------------------------------

    def _setup_server(self) -> None:
        if not self.config.server.enabled:
            return
        sb = self.config.server
        # Advertise resolution (agent.go:336 + config.go AdvertiseAddrs):
        # an explicit advertise.rpc wins (port defaulting to ports.rpc),
        # else the (per-service or global) bind address.
        rpc_bind = self.config.addresses.rpc or self.config.bind_addr
        adv_host, adv_port = split_host_port(
            self.config.advertise.rpc or rpc_bind, self.config.ports.rpc)
        scfg = ServerConfig(
            region=self.config.region,
            node_name=self.config.name or "server-1",
            rpc_advertise=f"{adv_host}:{adv_port}",
            data_dir=sb.data_dir or (
                "" if self.config.dev_mode else self.config.data_dir),
            # Server agents always listen on ports.rpc (agent.go:336
            # setupServer → server.go:250 setupRPC); dev mode takes an
            # ephemeral port.
            enable_rpc=True,
            rpc_bind=rpc_bind,
            rpc_port=0 if self.config.dev_mode else self.config.ports.rpc,
            bootstrap_expect=sb.bootstrap_expect,
            start_join=list(sb.start_join),
            num_schedulers=sb.num_schedulers,
            batch_size=sb.batch_size,
            device=self.device,
            tls=self.config.tls.to_tls_config(),
            **self.server_options)
        self.server = Server(scfg, logger=self.logger.getChild("server"))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self.http = HTTPServer(self,
                               host=(self.config.addresses.http
                                     or self.config.bind_addr),
                               port=self.config.ports.http)
        self.server.start()
        self._server_started = True
        self.http.start()
        self.consul_service_client.start()
        # Self-registration into the catalog (agent.go:492): servers
        # advertise their RPC endpoint as 'nomad'.
        host, port = self.server.config.rpc_advertise.rsplit(":", 1)
        self.consul_service_client.register_agent(
            "server", _advertisable(host), int(port), tags=["rpc"])
        self.logger.info("agent: started (http=%s)", self.http.address)

    def _detach_log(self) -> None:
        self.logger.removeHandler(self.log_ring)
        self.logger.setLevel(self._prev_log_level)

    def shutdown(self) -> None:
        """Stop the HTTP API, the catalog's check loop and the server,
        joining their threads (each bounded)."""
        self._detach_log()
        self.consul_service_client.stop()
        if self.http is not None:
            self.http.shutdown()
        if self._server_started:
            self.server.shutdown()

    def threads(self) -> List:
        """The live threads of the HTTP API and the server."""
        out = list(self.http.threads()) if self.http is not None else []
        if self.server is not None:
            out += self.server.threads()
        t = self.consul_service_client._thread
        if t is not None and t.is_alive():
            out.append(t)
        return out

    # -- introspection (agent_endpoint.go) ---------------------------------

    def self_info(self) -> Dict:
        cfg = self.config
        stats: Dict[str, Dict] = {}
        if self.server is not None:
            stats["nomad"] = {str(k): str(v)
                              for k, v in self.server.stats().items()}
        return {
            "config": {
                "Region": cfg.region, "Datacenter": cfg.datacenter,
                "Name": cfg.name, "DataDir": cfg.data_dir,
                "LogLevel": cfg.log_level, "BindAddr": cfg.bind_addr,
                "EnableDebug": cfg.enable_debug,
                "Ports": {"HTTP": cfg.ports.http, "RPC": cfg.ports.rpc,
                          "Serf": cfg.ports.serf},
                "Version": VERSION,
                "Server": {"Enabled": cfg.server.enabled},
                "Client": {"Enabled": cfg.client.enabled},
            },
            "member": self._self_member(),
            "stats": stats,
        }

    def _self_member(self) -> Dict:
        if self.server is None:
            return {}
        return {
            "Name": self.config.name or self.server.config.node_name,
            "Addr": self.config.bind_addr,
            "Port": self.config.ports.serf,
            "Status": "alive",
            "Tags": {"region": self.config.region,
                     "dc": self.config.datacenter,
                     "role": "nomad", "vsn": "1"},
        }

    def members(self) -> List[Dict]:
        if self.server is None:
            return []
        cluster = self.server.members()
        if cluster:
            me = self._self_member()
            out = []
            for m in cluster:
                entry = dict(me) if m["Name"] == self.server.config.node_name \
                    else {"Name": m["Name"], "Addr": m["Addr"].rsplit(":", 1)[0],
                          "Port": 0, "Status": m.get("Status", "alive"),
                          "Tags": {"region": m.get("Region", ""),
                                   "role": "nomad"}}
                out.append(entry)
            return out
        return [self._self_member()]

    def client_servers(self) -> List[str]:
        return []

    def set_client_servers(self, servers: List[str]) -> None:
        raise ValueError("client is not enabled")
