"""Host stats collection (a copy of ``nomad_tpu/client/stats.py``;
reference: client/stats/host.go:78-213).

gopsutil-equivalents read straight from /proc; fields mirror
HostStats so the `/v1/client/stats` payload shape matches.
"""
from __future__ import annotations

import os
import random
import shutil
import time
from typing import Dict, List, Optional


class HostStatsCollector:
    def __init__(self, alloc_dir: str = "/"):
        self.alloc_dir = alloc_dir if os.path.exists(alloc_dir) else "/"
        self._last_cpu: Optional[List[int]] = None
        self._last_ts = 0.0

    def collect(self) -> Dict:
        now = time.time()
        stats = {
            "Timestamp": int(now * 1e9),
            "Uptime": self._uptime(),
            "Memory": self._memory(),
            "CPU": self._cpu(now),
            "DiskStats": [self._disk(self.alloc_dir)],
            "AllocDirStats": self._disk(self.alloc_dir),
        }
        return stats

    @staticmethod
    def _uptime() -> int:
        try:
            with open("/proc/uptime") as f:
                return int(float(f.read().split()[0]))
        except (OSError, ValueError, IndexError):
            return 0

    @staticmethod
    def _memory() -> Dict:
        info = {}
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    k, v = line.split(":", 1)
                    info[k] = int(v.strip().split()[0]) * 1024
        except (OSError, ValueError, IndexError):
            return {}
        total = info.get("MemTotal", 0)
        free = info.get("MemFree", 0)
        avail = info.get("MemAvailable", free)
        return {"Total": total, "Available": avail, "Free": free,
                "Used": total - avail}

    def _cpu(self, now: float) -> List[Dict]:
        try:
            with open("/proc/stat") as f:
                first = f.readline().split()
            ticks = [int(x) for x in first[1:8]]
        except (OSError, ValueError, IndexError):
            return []
        out = []
        if self._last_cpu is not None:
            dt = [b - a for a, b in zip(self._last_cpu, ticks)]
            total = sum(dt) or 1
            idle = dt[3]
            out = [{
                "CPU": "cpu-total",
                "User": 100.0 * dt[0] / total,
                "System": 100.0 * dt[2] / total,
                "Idle": 100.0 * idle / total,
                "Total": 100.0 * (total - idle) / total,
            }]
        self._last_cpu = ticks
        self._last_ts = now
        return out

    @staticmethod
    def _disk(path: str) -> Dict:
        try:
            u = shutil.disk_usage(path)
        except OSError:
            return {"Device": path}
        return {
            "Device": path,
            "Mountpoint": path,
            "Size": u.total,
            "Used": u.used,
            "Available": u.free,
            "UsedPercent": 100.0 * u.used / max(1, u.total),
        }


class ServerList:
    """Prioritized, shuffled server endpoint list
    (reference: client/serverlist.go).  The shuffle's generator is an
    argument, ``rng`` (default: a fresh ``random.Random()``, as the
    reference makes one)."""

    def __init__(self, servers: Optional[List[str]] = None,
                 rng: Optional[random.Random] = None):
        self._rand = rng if rng is not None else random.Random()
        self._servers: List[str] = list(servers or [])
        self._rand.shuffle(self._servers)

    def all(self) -> List[str]:
        return list(self._servers)

    def set(self, servers: List[str]) -> None:
        self._servers = list(servers)
        self._rand.shuffle(self._servers)

    def failed(self, server: str) -> None:
        """Demote a failed server to the back of the list."""
        if server in self._servers:
            self._servers.remove(server)
            self._servers.append(server)

    def first(self) -> Optional[str]:
        return self._servers[0] if self._servers else None
