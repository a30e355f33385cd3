"""Agent configuration (a copy of ``nomad_tpu/agent/config.py``;
reference: command/agent/config.go + config_parse.go).

Config comes from HCL/JSON files merged over defaults, with the same block
shape as the reference agent config (server{}/client{}/ports{}/advertise{}).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..jobspec.hcl import Block, parse_hcl


@dataclass
class Ports:
    http: int = 4646
    rpc: int = 4647
    serf: int = 4648


@dataclass
class ServerBlock:
    enabled: bool = False
    bootstrap_expect: int = 1
    data_dir: str = ""
    num_schedulers: int = 1
    enabled_schedulers: List[str] = field(default_factory=list)
    node_gc_threshold: str = ""
    heartbeat_grace: str = ""
    start_join: List[str] = field(default_factory=list)
    wan_join: List[str] = field(default_factory=list)
    use_tpu_batch_worker: bool = False
    batch_size: int = 64


@dataclass
class ClientBlock:
    enabled: bool = False
    state_dir: str = ""
    alloc_dir: str = ""
    servers: List[str] = field(default_factory=list)
    node_class: str = ""
    meta: Dict[str, str] = field(default_factory=dict)
    options: Dict[str, str] = field(default_factory=dict)
    network_interface: str = ""
    network_speed: int = 0
    cpu_total_compute: int = 0
    gc_interval: str = ""
    gc_max_allocs: int = 50
    consul_address: str = ""  # catalog HTTP address for server discovery


@dataclass
class TLSBlock:
    """(reference: helper/tlsutil via the agent tls{} block)."""

    rpc: bool = False
    ca_file: str = ""
    cert_file: str = ""
    key_file: str = ""
    # Verify the server cert's hostname/SAN on dial (requires certs with
    # address SANs; default is cluster-CA pinning like the reference's
    # verify_server_hostname=false).
    verify_server_hostname: bool = False

    def to_tls_config(self):
        """→ tlsutil.TLSConfig, or None when TLS is off — the ONE place
        agent TLS settings become a config object."""
        if not self.rpc:
            return None
        from ..utils.tlsutil import TLSConfig

        return TLSConfig(enabled=True, ca_file=self.ca_file,
                         cert_file=self.cert_file, key_file=self.key_file,
                         verify_server_hostname=self.verify_server_hostname)


@dataclass
class VaultBlock:
    """(reference: nomad/structs/config/vault.go via the agent vault{}
    block)."""

    enabled: bool = False
    address: str = ""
    token: str = ""
    task_token_ttl: str = ""


@dataclass
class AddressesBlock:
    """Per-service bind overrides (config.go Addresses): empty fields
    fall back to bind_addr.  Values accept go-sockaddr templates."""

    http: str = ""
    rpc: str = ""
    serf: str = ""


@dataclass
class AdvertiseBlock:
    """Per-service advertise addresses (config.go AdvertiseAddrs):
    what peers/clients are told to dial, which may differ from the bind
    (NAT, multi-homed hosts).  Values accept go-sockaddr templates,
    optionally with a ``:port`` suffix."""

    http: str = ""
    rpc: str = ""
    serf: str = ""


@dataclass
class AgentConfig:
    region: str = "global"
    datacenter: str = "dc1"
    name: str = ""
    data_dir: str = ""
    log_level: str = "INFO"
    bind_addr: str = "127.0.0.1"
    enable_debug: bool = False
    ports: Ports = field(default_factory=Ports)
    addresses: AddressesBlock = field(default_factory=AddressesBlock)
    advertise: AdvertiseBlock = field(default_factory=AdvertiseBlock)
    server: ServerBlock = field(default_factory=ServerBlock)
    client: ClientBlock = field(default_factory=ClientBlock)
    vault: VaultBlock = field(default_factory=VaultBlock)
    tls: TLSBlock = field(default_factory=TLSBlock)
    dev_mode: bool = False

    @staticmethod
    def dev() -> "AgentConfig":
        """-dev: in-memory server + client in one process, on the
        standard port so the CLI's default address reaches it
        (command/agent/config.go DevConfig). Tests that run many agents
        set ``ports.http = 0`` for an ephemeral port."""
        cfg = AgentConfig()
        cfg.dev_mode = True
        cfg.server.enabled = True
        cfg.client.enabled = True
        return cfg


def expand_env(value: str) -> str:
    """Environment-variable interpolation for agent config VALUES
    (the reference expands on parsed values, never raw file bytes — a
    value containing quotes must not be able to corrupt or inject
    config syntax): ``${VAR}`` and ``$VAR`` are replaced when VAR is
    set; unknown names are left untouched so runtime placeholders
    (e.g. jobspec-style ``${node.class}`` in client meta) survive."""
    import os
    import re

    def sub(m):
        name = m.group(1) or m.group(2)
        val = os.environ.get(name)
        return val if val is not None else m.group(0)

    return re.sub(r"\$\{(\w+)\}|\$(\w+)", sub, value)


def _interface_ip(name: str) -> str:
    """IPv4 address of a named interface (SIOCGIFADDR)."""
    import fcntl
    import socket
    import struct

    sk = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        packed = fcntl.ioctl(
            sk.fileno(), 0x8915,  # SIOCGIFADDR
            struct.pack("256s", name.encode()[:15]))
        return socket.inet_ntoa(packed[20:24])
    finally:
        sk.close()


def _all_interface_ips() -> List[str]:
    import socket

    out = []
    for _, name in socket.if_nameindex():
        try:
            out.append(_interface_ip(name))
        except OSError:
            continue
    return out


def _classify(ip: str):
    """True = private candidate, False = public candidate, None =
    excluded (loopback/link-local — neither, matching go-sockaddr's
    GetPrivateIP/GetPublicIP semantics)."""
    import ipaddress

    try:
        a = ipaddress.ip_address(ip)
    except ValueError:
        return None
    if a.is_loopback or a.is_link_local:
        return None
    return a.is_private


def parse_ip_template(tmpl: str) -> str:
    """go-sockaddr single-IP template subset for address fields
    (config.go:787 parseSingleIPTemplate): ``{{ GetPrivateIP }}``,
    ``{{ GetPublicIP }}``, ``{{ GetInterfaceIP "name" }}``; plain
    addresses pass through.  Like the reference, resolving to zero or
    multiple addresses is an error."""
    import re

    m = re.fullmatch(r"\s*\{\{\s*(\w+)(?:\s+\"([^\"]+)\")?\s*\}\}\s*",
                     tmpl)
    if m is None:
        if "{{" in tmpl:
            raise ValueError(f"unable to parse address template {tmpl!r}")
        return tmpl
    fn, arg = m.group(1), m.group(2)
    import sys as _sys

    if _sys.platform != "linux":
        # The interface enumeration uses the Linux SIOCGIFADDR ioctl;
        # the port runs on Linux hosts.  Fail with a clear message elsewhere.
        raise ValueError(
            "go-sockaddr address templates are supported on linux only; "
            "configure a literal address")
    if fn == "GetInterfaceIP":
        if not arg:
            raise ValueError("GetInterfaceIP requires an interface name")
        try:
            return _interface_ip(arg)
        except OSError as e:
            raise ValueError(
                f"unable to resolve interface {arg!r}: {e}") from e
    if fn in ("GetPrivateIP", "GetPublicIP"):
        want_private = fn == "GetPrivateIP"
        ips = sorted({ip for ip in _all_interface_ips()
                      if _classify(ip) is want_private})
        if not ips:
            raise ValueError(
                f"no addresses found for {fn}, please configure one")
        if len(ips) > 1:
            # Like the reference (config.go:800): ambiguity is an
            # error, never a silent first-interface guess.
            raise ValueError(
                f"multiple addresses found for {fn} ({', '.join(ips)}), "
                "please configure one")
        return ips[0]
    raise ValueError(f"unsupported address template function {fn!r}")


def split_host_port(addr: str, default_port: int) -> Tuple[str, int]:
    """``host[:port]`` → ``(host, port)``, falling back to
    ``default_port`` when the suffix is absent or non-numeric
    (advertise values are full dial addresses, optionally without the
    port) — the one splitter for every advertise/address consumer."""
    host, sep, port = addr.rpartition(":")
    if sep and port.isdigit():
        return host, int(port)
    return addr, default_port


def resolve_addr_template(value: str) -> str:
    """parse_ip_template over an address field that may carry a
    ``:port`` suffix after the template (advertise blocks are full
    dial addresses, e.g. ``{{ GetPrivateIP }}:4647``)."""
    if "{{" not in value:
        return value
    host, port = split_host_port(value, -1)
    if port >= 0 and "}}" in host:
        return f"{parse_ip_template(host)}:{port}"
    return parse_ip_template(value)


def _resolve_address_fields(cfg: "AgentConfig") -> "AgentConfig":
    """Run go-sockaddr template resolution over every address-valued
    field — bind_addr plus the addresses{} and advertise{} blocks, in
    BOTH the HCL and JSON paths (config_parse.go / config.go:787 does
    the same; a templated advertise address must never pass through
    literally and fail later at bind/gossip time)."""
    cfg.bind_addr = parse_ip_template(cfg.bind_addr)
    for blk in (cfg.addresses, cfg.advertise):
        for field_name in ("http", "rpc", "serf"):
            v = getattr(blk, field_name)
            if v:
                setattr(blk, field_name, resolve_addr_template(str(v)))
    return cfg


def _expand(v):
    """Env expansion on a parsed VALUE — recursive, so JSON configs with
    nested lists/maps (client.servers, client.meta) expand the same way
    the HCL helpers do."""
    if isinstance(v, str):
        return expand_env(v)
    if isinstance(v, list):
        return [_expand(x) for x in v]
    if isinstance(v, dict):
        return {k: _expand(x) for k, x in v.items()}
    return v


def _scalar(blk: Block, key: str, default=None):
    e = blk.one(key)
    if e is None or isinstance(e.value, Block):
        return default
    return _expand(e.value)


def _str_list(blk: Block, key: str) -> List[str]:
    e = blk.one(key)
    if e is None or isinstance(e.value, Block):
        return []
    v = e.value
    return ([str(_expand(x)) for x in v] if isinstance(v, list)
            else [str(_expand(v))])


def _str_map(blk: Block, key: str) -> Dict[str, str]:
    e = blk.one(key)
    if e is None or not isinstance(e.value, Block):
        return {}
    return {x.key: str(_expand(x.value)) for x in e.value.entries
            if not isinstance(x.value, Block)}


def parse_config(src: str) -> AgentConfig:
    """Parse an HCL (or JSON) agent config file into AgentConfig.
    Parsed string values pass through env-var expansion, and address
    fields accept go-sockaddr templates (config_parse.go +
    config.go:787)."""
    src_stripped = src.lstrip()
    if src_stripped.startswith("{"):
        return _resolve_address_fields(_from_json(json.loads(src)))
    root = parse_hcl(src)
    cfg = AgentConfig()
    cfg.region = str(_scalar(root, "region", cfg.region))
    cfg.datacenter = str(_scalar(root, "datacenter", cfg.datacenter))
    cfg.name = str(_scalar(root, "name", cfg.name))
    cfg.data_dir = str(_scalar(root, "data_dir", cfg.data_dir))
    cfg.log_level = str(_scalar(root, "log_level", cfg.log_level))
    cfg.bind_addr = str(_scalar(root, "bind_addr", cfg.bind_addr))
    cfg.enable_debug = bool(_scalar(root, "enable_debug", False))

    pe = root.one("ports")
    if pe is not None and isinstance(pe.value, Block):
        cfg.ports.http = int(_scalar(pe.value, "http", cfg.ports.http))
        cfg.ports.rpc = int(_scalar(pe.value, "rpc", cfg.ports.rpc))
        cfg.ports.serf = int(_scalar(pe.value, "serf", cfg.ports.serf))

    for blk_key, target in (("addresses", cfg.addresses),
                            ("advertise", cfg.advertise)):
        be = root.one(blk_key)
        if be is not None and isinstance(be.value, Block):
            for k in ("http", "rpc", "serf"):
                v = _scalar(be.value, k, "")
                if v:
                    setattr(target, k, str(v))

    se = root.one("server")
    if se is not None and isinstance(se.value, Block):
        sb = se.value
        cfg.server.enabled = bool(_scalar(sb, "enabled", False))
        cfg.server.bootstrap_expect = int(_scalar(sb, "bootstrap_expect", 1))
        cfg.server.data_dir = str(_scalar(sb, "data_dir", ""))
        cfg.server.num_schedulers = int(_scalar(sb, "num_schedulers", 1))
        cfg.server.enabled_schedulers = _str_list(sb, "enabled_schedulers")
        cfg.server.start_join = _str_list(sb, "start_join")
        cfg.server.wan_join = _str_list(sb, "retry_join_wan")
        cfg.server.use_tpu_batch_worker = bool(
            _scalar(sb, "use_tpu_batch_worker", False))
        cfg.server.batch_size = int(_scalar(sb, "batch_size", 64))

    ce = root.one("client")
    if ce is not None and isinstance(ce.value, Block):
        cb = ce.value
        cfg.client.enabled = bool(_scalar(cb, "enabled", False))
        cfg.client.state_dir = str(_scalar(cb, "state_dir", ""))
        cfg.client.alloc_dir = str(_scalar(cb, "alloc_dir", ""))
        cfg.client.servers = _str_list(cb, "servers")
        cfg.client.node_class = str(_scalar(cb, "node_class", ""))
        cfg.client.meta = _str_map(cb, "meta")
        cfg.client.options = _str_map(cb, "options")
        cfg.client.network_speed = int(_scalar(cb, "network_speed", 0))
        cfg.client.cpu_total_compute = int(_scalar(cb, "cpu_total_compute", 0))
        cfg.client.gc_max_allocs = int(_scalar(cb, "gc_max_allocs", 50))
        cfg.client.consul_address = str(_scalar(cb, "consul_address", ""))

    te = root.one("tls")
    if te is not None and isinstance(te.value, Block):
        tb = te.value
        cfg.tls.rpc = bool(_scalar(tb, "rpc", False))
        cfg.tls.ca_file = str(_scalar(tb, "ca_file", ""))
        cfg.tls.cert_file = str(_scalar(tb, "cert_file", ""))
        cfg.tls.key_file = str(_scalar(tb, "key_file", ""))
        cfg.tls.verify_server_hostname = bool(
            _scalar(tb, "verify_server_hostname", False))

    ve = root.one("vault")
    if ve is not None and isinstance(ve.value, Block):
        vb = ve.value
        cfg.vault.enabled = bool(_scalar(vb, "enabled", False))
        cfg.vault.address = str(_scalar(vb, "address", ""))
        cfg.vault.token = str(_scalar(vb, "token", ""))
        cfg.vault.task_token_ttl = str(_scalar(vb, "task_token_ttl", ""))

    return _resolve_address_fields(cfg)


def _from_json(data: dict) -> AgentConfig:
    cfg = AgentConfig()
    for k in ("region", "datacenter", "name", "data_dir", "log_level",
              "bind_addr"):
        if k in data:
            setattr(cfg, k, _expand(data[k]))
    ports = data.get("ports") or {}
    for k in ("http", "rpc", "serf"):
        if k in ports:
            setattr(cfg.ports, k, int(ports[k]))
    for blk_name, target in (("server", cfg.server), ("client", cfg.client),
                             ("addresses", cfg.addresses),
                             ("advertise", cfg.advertise)):
        blk = data.get(blk_name) or {}
        for k, v in blk.items():
            if hasattr(target, k):
                setattr(target, k, _expand(v))
    return cfg


def load_config_file(path: str) -> AgentConfig:
    with open(path, "r", encoding="utf-8") as f:
        return parse_config(f.read())
