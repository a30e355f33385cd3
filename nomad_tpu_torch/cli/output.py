"""CLI output helpers (a copy of ``nomad_tpu/cli/output.py``): the reference renders aligned pipe-tables via
ryanuber/columnize (command/helpers.go formatList) and key|value blocks
(formatKV).  Same look here."""

from __future__ import annotations

import time
from typing import List


def format_list(rows: List[str]) -> str:
    """Rows are pipe-separated; align into columns like columnize."""
    if not rows:
        return ""
    split = [r.split("|") for r in rows]
    ncols = max(len(r) for r in split)
    widths = [0] * ncols
    for r in split:
        for i, cell in enumerate(r):
            widths[i] = max(widths[i], len(cell))
    out = []
    for r in split:
        line = "  ".join(cell.ljust(widths[i]) for i, cell in enumerate(r))
        out.append(line.rstrip())
    return "\n".join(out)


def format_kv(rows: List[str]) -> str:
    """key|value rows -> 'key = value' aligned."""
    if not rows:
        return ""
    split = [r.split("|", 1) for r in rows]
    width = max(len(r[0]) for r in split)
    return "\n".join(
        f"{r[0].ljust(width)} = {r[1] if len(r) > 1 else ''}".rstrip()
        for r in split)


def format_time(ts: float) -> str:
    if not ts:
        return "<none>"
    return time.strftime("%m/%d/%y %H:%M:%S", time.localtime(ts))


def limit(s: str, n: int = 8) -> str:
    """Short identifiers like the reference's limit() (command/helpers.go)."""
    return s[:n] if s else ""
