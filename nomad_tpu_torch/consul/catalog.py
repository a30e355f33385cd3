"""Consul-shaped service catalog (a copy of ``nomad_tpu/consul/catalog.py``).

The reference delegates service registration to an external Consul agent
(command/agent/consul/client.go) and discovers servers through Consul's
catalog (client/client.go:2139 consulDiscovery).  This build ships an
internal catalog with the same shape: services keyed by ID with name/tags/
address/port and per-check health, queryable by service name — surfaced
over the agent HTTP API (/v1/catalog/...) so other agents can discover
through it exactly like a Consul endpoint.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

CHECK_PASSING = "passing"
CHECK_WARNING = "warning"
CHECK_CRITICAL = "critical"


@dataclass
class CatalogCheck:
    id: str = ""
    name: str = ""
    type: str = ""          # http | tcp | script | ttl
    status: str = CHECK_PASSING
    output: str = ""


@dataclass
class CatalogEntry:
    id: str = ""
    name: str = ""
    tags: List[str] = field(default_factory=list)
    address: str = ""
    port: int = 0
    checks: List[CatalogCheck] = field(default_factory=list)
    registered_at: float = field(default_factory=time.time)

    def healthy(self) -> bool:
        return all(c.status != CHECK_CRITICAL for c in self.checks)

    def to_wire(self) -> Dict:
        return {
            "ID": self.id, "Service": self.name, "Tags": list(self.tags),
            "Address": self.address, "Port": self.port,
            "Checks": [{"CheckID": c.id, "Name": c.name, "Type": c.type,
                        "Status": c.status, "Output": c.output}
                       for c in self.checks],
        }


class ServiceCatalog:
    """Thread-safe service registry + KV (the catalog and KV halves of
    Consul's API — the KV side feeds task templates exactly as
    consul-template reads Consul KV)."""

    def __init__(self) -> None:
        self._l = threading.Lock()
        self._entries: Dict[str, CatalogEntry] = {}
        self._kv: Dict[str, str] = {}
        self._kv_index = 0
        self._generation = 0  # bumps on ANY mutation (KV or services)

    # -- KV (consul-template's `key` function source) ------------------

    def kv_set(self, key: str, value: str) -> int:
        with self._l:
            self._kv[key] = value
            self._kv_index += 1
            self._generation += 1
            return self._kv_index

    def kv_get(self, key: str) -> Optional[str]:
        with self._l:
            return self._kv.get(key)

    def kv_delete(self, key: str) -> None:
        with self._l:
            self._kv.pop(key, None)
            self._kv_index += 1
            self._generation += 1

    def kv_list(self, prefix: str = "") -> Dict[str, str]:
        with self._l:
            return {k: v for k, v in self._kv.items()
                    if k.startswith(prefix)}

    def kv_index(self) -> int:
        """Monotonic modify index — template watchers poll it for change
        detection (Consul's X-Consul-Index role)."""
        with self._l:
            return self._kv_index

    def register(self, entry: CatalogEntry) -> None:
        with self._l:
            self._entries[entry.id] = entry
            self._generation += 1

    def deregister(self, service_id: str) -> None:
        with self._l:
            self._entries.pop(service_id, None)
            self._generation += 1

    def entry(self, service_id: str) -> Optional[CatalogEntry]:
        with self._l:
            return self._entries.get(service_id)

    def services(self) -> Dict[str, List[str]]:
        """name → union of tags (GET /v1/catalog/services shape)."""
        out: Dict[str, List[str]] = {}
        with self._l:
            for e in self._entries.values():
                tags = out.setdefault(e.name, [])
                for t in e.tags:
                    if t not in tags:
                        tags.append(t)
        return out

    def service(self, name: str, tag: str = "",
                healthy_only: bool = False) -> List[CatalogEntry]:
        with self._l:
            out = [e for e in self._entries.values() if e.name == name]
        if tag:
            out = [e for e in out if tag in e.tags]
        if healthy_only:
            out = [e for e in out if e.healthy()]
        return sorted(out, key=lambda e: e.id)

    def set_check_status(self, service_id: str, check_id: str,
                         status: str, output: str = "") -> None:
        with self._l:
            e = self._entries.get(service_id)
            if e is None:
                return
            for c in e.checks:
                if c.id == check_id:
                    if c.status != status:
                        self._generation += 1
                    c.status = status
                    c.output = output

    def generation(self) -> int:
        """Monotonic mutation counter across KV + services — template
        watchers poll it to short-circuit unchanged polls."""
        with self._l:
            return self._generation

    def ids(self) -> List[str]:
        with self._l:
            return sorted(self._entries)
