"""The agent: a server, a client or both in one process plus the HTTP
API (a copy of ``nomad_tpu/agent/agent.py``; reference:
command/agent/agent.go:46-719, setupServer at agent.go:336, setupClient
at agent.go:390, NewHTTPServer wiring).

A config that enables vault or joins another region over the WAN raises
``NotImplementedError`` (ROADMAP item 30), and so does one that names
``enabled_schedulers``: each before any port is bound, never a silent
start without it.  The server runs on ``device`` (default ``cuda``:
without a card the server's construction raises; there is no CPU
fallback).  ``server { use_tpu_batch_worker = ... }`` parses and changes
nothing: the port's server has only the batch worker (ROADMAP queue 3
item 19).  The client talks to this agent's server in process when there
is one, else to ``client { servers = [...] }`` through
``RemoteServerRPC`` (TLS when the agent's ``tls`` block asks for it).
``server_options`` adds ``ServerConfig`` fields and ``client_options``
``ClientConfig`` fields (over the config file's) that an agent config
file cannot carry (seeds, a breaker, the node heartbeat TTL, a node id,
a reservation), for a program that embeds the agent.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from .. import __version__ as VERSION
from ..client import Client, ClientConfig
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
                 server_options: Optional[Dict] = None,
                 client_options: Optional[Dict] = None):
        self.config = config or AgentConfig.dev()
        _refuse_unported(self.config)
        self.device = device
        self.server_options = dict(server_options or {})
        self.client_options = dict(client_options or {})
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
        self.client: Optional[Client] = None
        self.http: Optional[HTTPServer] = None
        self._server_started = False
        self._client_started = False
        # Consul-shaped catalog + service client (command/agent/consul/):
        # the agent hosts the catalog and registers itself.
        from ..consul import ServiceCatalog, ServiceClient

        self.catalog = ServiceCatalog()
        self.consul_service_client = ServiceClient(
            self.catalog, logger=self.logger.getChild("consul"))
        try:
            self._setup_server()
            self._setup_client()
        except BaseException:
            self._detach_log()
            raise
        if self.server is None and self.client is None:
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

    def _setup_client(self) -> None:
        """(agent.go:390 setupClient)."""
        if not self.config.client.enabled:
            return
        cb = self.config.client
        fields = dict(
            region=self.config.region,
            datacenter=self.config.datacenter,
            node_name=self.config.name,
            node_class=cb.node_class,
            state_dir=cb.state_dir,
            alloc_dir=cb.alloc_dir,
            servers=list(cb.servers),
            meta=dict(cb.meta),
            options=dict(cb.options),
            network_speed=cb.network_speed,
            cpu_total_compute=cb.cpu_total_compute,
            gc_max_allocs=cb.gc_max_allocs,
            consul_address=cb.consul_address,
            dev_mode=self.config.dev_mode)
        fields.update(self.client_options)   # the embedding program's
        ccfg = ClientConfig(**fields)
        # In-process RPC when this agent also runs a server; a remote RPC
        # proxy otherwise (reference clients RPC over TCP; the in-proc
        # fast path mirrors agent-embedded client behavior).
        rpc = self.server
        if rpc is None:
            from ..server.rpc import ConnPool, RemoteServerRPC

            pool = None
            tls_cfg = self.config.tls.to_tls_config()
            if tls_cfg is not None:
                from ..utils.tlsutil import client_context

                pool = ConnPool(tls_context=client_context(tls_cfg))
            rpc = RemoteServerRPC(cb.servers, pool=pool)
        self.client = Client(ccfg, rpc=rpc,
                             logger=self.logger.getChild("client"),
                             consul=self.consul_service_client)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        # Bind HTTP first: the client advertises its HTTP address on the
        # node (structs Node.HTTPAddr) so peers can pull sticky-disk
        # snapshots from it (client.go:1743 migrateRemoteAllocDir).
        self.http = HTTPServer(self,
                               host=(self.config.addresses.http
                                     or self.config.bind_addr),
                               port=self.config.ports.http)
        if self.client is not None:
            host, port = self._http_advertise()
            self.client.node.http_addr = f"{host}:{port}"
        if self.server is not None:
            self.server.start()
            self._server_started = True
        if self.client is not None:
            self.client.start()
            self._client_started = True
        self.http.start()
        self.consul_service_client.start()
        # Self-registration into the catalog (agent.go:492): servers
        # advertise their RPC endpoint as 'nomad', clients their HTTP as
        # 'nomad-client'.
        if self.server is not None:
            host, port = self.server.config.rpc_advertise.rsplit(":", 1)
            self.consul_service_client.register_agent(
                "server", _advertisable(host), int(port), tags=["rpc"])
        if self.client is not None:
            host, port = self._http_advertise()
            self.consul_service_client.register_agent(
                "client", host, port, tags=["http"])
        self.logger.info("agent: started (http=%s)", self.http.address)

    def _http_advertise(self) -> tuple:
        """(host, port) peers are told to dial for this agent's HTTP API:
        ``advertise { http }`` (NAT/multi-homed override, optionally with
        its own port) > ``addresses { http }`` (the bind) > bind_addr
        (agent.go advertise-address resolution order)."""
        adv = self.config.advertise.http or \
            self.config.addresses.http or self.config.bind_addr
        host, port = split_host_port(adv, self.http.port)
        return _advertisable(host), port

    def _detach_log(self) -> None:
        self.logger.removeHandler(self.log_ring)
        self.logger.setLevel(self._prev_log_level)

    def shutdown(self) -> None:
        """Stop the HTTP API, the catalog's check loop, the client and the
        server, joining their threads (each bounded)."""
        self._detach_log()
        self.consul_service_client.stop()
        if self.http is not None:
            self.http.shutdown()
        if self._client_started:
            self.client.shutdown()
        if self._server_started:
            self.server.shutdown()

    def threads(self) -> List:
        """The live threads of the HTTP API, the client and the server."""
        out = list(self.http.threads()) if self.http is not None else []
        if self.client is not None:
            out += self.client.threads()
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
        if self.client is not None:
            stats["client"] = {
                "node_id": self.client.node.id,
                "known_servers": ",".join(self.client.servers.all()),
                "num_allocations": str(self.client.num_allocs()),
            }
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
        if self.client is None:
            return []
        return self.client.servers.all()

    def set_client_servers(self, servers: List[str]) -> None:
        if self.client is None:
            raise ValueError("client is not enabled")
        self.client.servers.set(servers)
