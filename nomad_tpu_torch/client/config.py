"""Client configuration (a copy of ``nomad_tpu/client/config.py``;
reference client/config/config.go), trimmed to what the fingerprints
read: the options map, the network interface and speed, and the alloc
directory."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass
class ClientConfig:
    alloc_dir: str = ""                 # "" -> the root volume
    network_interface: str = ""
    network_speed: int = 0
    options: Dict[str, str] = field(default_factory=dict)

    def read_option(self, key: str, default: str = "") -> str:
        return self.options.get(key, default)

    def read_bool_option(self, key: str, default: bool = False) -> bool:
        v = self.options.get(key)
        if v is None:
            return default
        return str(v).lower() in ("1", "true", "yes")
