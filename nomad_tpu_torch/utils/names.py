"""snake_case to Go-style CamelCase names (a copy of
``nomad_tpu/utils/names.py``).

The reference's user-visible output (the job diff of ``job plan``) uses
Go field names; the dataclasses use snake_case.  The job-diff renderer
(``structs/diff.py``) names every field through :func:`go_name`.
"""

from __future__ import annotations

_TOKEN_MAP = {
    "id": "ID", "cpu": "CPU", "iops": "IOPS", "mb": "MB", "mbits": "MBits",
    "url": "URL", "ttl": "TTL", "http": "HTTP", "tls": "TLS", "ip": "IP",
    "uuid": "UUID", "gc": "GC", "ltarget": "LTarget", "rtarget": "RTarget",
    "tg": "TG", "dc": "DC", "rpc": "RPC", "tmpl": "Tmpl",
}


def go_name(snake: str) -> str:
    """kill_timeout -> KillTimeout, memory_mb -> MemoryMB, job_id -> JobID."""
    return "".join(_TOKEN_MAP.get(t, t.capitalize()) for t in snake.split("_"))
