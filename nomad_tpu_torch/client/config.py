"""Client configuration (a copy of ``nomad_tpu/client/config.py``;
reference client/config/config.go).

Two fields of the port's own:

- ``node_id``.  Empty, the client makes a fresh UUID at construction, as
  the reference's does (client.go:114); set, the node registers under
  it.  The state store orders nodes by id, so two worlds compare only
  when their clients' ids are fixed.
- ``cgroup_root``: the cgroup tree the ``exec`` driver puts its tasks in
  (``driver/cgroups.py``).  Empty, the default, means none: tasks get
  the ``RLIMIT_AS`` memory cap, and nothing is written under the host's
  cgroup tree.  The JAX package's driver always uses ``/sys/fs/cgroup``
  when it is writable.

``vault_addr`` and ``vault_token`` reach vault over HTTP to renew and
unwrap the tasks' tokens (``server/vault.py`` ``HTTPVault``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..structs import structs as s


@dataclass
class ClientConfig:
    state_dir: str = ""                 # "" -> no persistence (dev mode)
    alloc_dir: str = ""                 # "" -> a temporary directory
    region: str = "global"
    datacenter: str = "dc1"
    node_name: str = ""
    node_class: str = ""
    network_interface: str = ""
    network_speed: int = 0
    cpu_total_compute: int = 0
    max_kill_timeout: float = 30.0
    meta: Dict[str, str] = field(default_factory=dict)
    options: Dict[str, str] = field(default_factory=dict)
    reserved: Optional[s.Resources] = None
    servers: List[str] = field(default_factory=list)
    # GC knobs (client/config/config.go:180-204)
    gc_interval: float = 60.0
    gc_disk_usage_threshold: float = 80.0
    gc_inode_usage_threshold: float = 70.0
    gc_max_allocs: int = 50
    gc_parallel_destroys: int = 2
    # Consul-shaped catalog HTTP address for server discovery
    # (client/config consul block; client.go:2139 consulDiscovery)
    consul_address: str = ""
    # The vault transport of the client's token manager (renew, unwrap).
    vault_addr: str = ""
    vault_token: str = ""
    # Dev-mode shortcuts
    dev_mode: bool = False
    # The node's id; "" -> a fresh UUID (client.go:114).
    node_id: str = ""
    # The exec driver's cgroup root; "" -> no cgroups (RLIMIT_AS only).
    cgroup_root: str = ""

    def read_option(self, key: str, default: str = "") -> str:
        return self.options.get(key, default)

    def read_bool_option(self, key: str, default: bool = False) -> bool:
        v = self.options.get(key)
        if v is None:
            return default
        return str(v).lower() in ("1", "true", "yes")
