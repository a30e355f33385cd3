"""Framed file/log streaming with follow (a copy of
``nomad_tpu/client/fs_stream.py``; reference:
command/agent/fs_endpoint.go — StreamFrame {File, Offset, Data, FileEvent}
over a chunked response; client/allocdir ReadAt/BlockUntilExists/
ChangeEvents).

Generators yield frame dicts; the HTTP layer serializes each as one
NDJSON line (Data bytes → base64 via the wire codec).  Log streaming
follows the executor's rotated files (`<task>.<stream>.<n>`,
client/driver/executor.py LogRotator) across rotation boundaries,
emitting a FileEvent frame on each switch.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Iterator, List, Optional

# Frame payload cap; the reference streams 64KiB frames.
MAX_FRAME = 64 * 1024
POLL_INTERVAL = 0.15
# Follow mode emits an empty heartbeat frame when idle so consumers can
# detect liveness (fs_endpoint.go heartbeat ticker).
HEARTBEAT_INTERVAL = 10.0


def _frame(file: str, offset: int, data: bytes = b"",
           event: str = "") -> Dict:
    out: Dict = {"File": file, "Offset": offset}
    if data:
        out["Data"] = data
    if event:
        out["FileEvent"] = event
    return out


def stream_file_frames(
    path: str,
    rel_name: str,
    offset: int = 0,
    origin: str = "start",
    follow: bool = False,
    alive: Optional[Callable[[], bool]] = None,
    poll: float = POLL_INTERVAL,
) -> Iterator[Dict]:
    """Stream one file from ``origin``±``offset``; with ``follow``, keep
    tailing until the consumer stops or ``alive()`` turns false with no
    more data (truncation resets to the new end)."""
    pos = _start_pos(path, offset, origin)
    last_beat = time.monotonic()
    while True:
        size = os.path.getsize(path) if os.path.exists(path) else 0
        if size < pos:
            pos = 0  # truncated/rewritten — restart from the top
        if size > pos:
            with open(path, "rb") as fh:
                fh.seek(pos)
                data = fh.read(MAX_FRAME)
            pos += len(data)
            yield _frame(rel_name, pos, data)
            last_beat = time.monotonic()
            continue
        if not follow:
            return
        if alive is not None and not alive():
            return
        if time.monotonic() - last_beat >= HEARTBEAT_INTERVAL:
            yield _frame(rel_name, pos)
            last_beat = time.monotonic()
        time.sleep(poll)


def _start_pos(path: str, offset: int, origin: str) -> int:
    size = os.path.getsize(path) if os.path.exists(path) else 0
    if origin == "end":
        return max(0, size - offset)
    return min(offset, size) if size else 0


def _log_files(log_dir: str, prefix: str) -> List[str]:
    if not os.path.isdir(log_dir):
        return []
    out = [f for f in os.listdir(log_dir)
           if f.startswith(prefix) and f[len(prefix):].isdigit()]
    return sorted(out, key=lambda f: int(f[len(prefix):]))


def stream_log_frames(
    log_dir: str,
    task: str,
    log_type: str = "stdout",
    offset: int = 0,
    origin: str = "start",
    follow: bool = False,
    alive: Optional[Callable[[], bool]] = None,
    poll: float = POLL_INTERVAL,
) -> Iterator[Dict]:
    """Stream a task's rotated logs as frames, following across rotation
    boundaries (fs_endpoint.go logs handler + logging/rotator.go)."""
    prefix = f"{task}.{log_type}."

    # Wait for the first log file in follow mode (BlockUntilExists).
    files = _log_files(log_dir, prefix)
    while not files:
        if not follow or (alive is not None and not alive()):
            return
        time.sleep(poll)
        files = _log_files(log_dir, prefix)

    if origin == "end":
        fname = files[-1]
        pos = _start_pos(os.path.join(log_dir, fname), offset, "end")
    else:
        fname = files[0]
        pos = offset

    rel = f"alloc/logs/{fname}"
    last_beat = time.monotonic()
    idle_after_dead = False
    while True:
        path = os.path.join(log_dir, fname)
        size = os.path.getsize(path) if os.path.exists(path) else 0
        if size < pos:
            pos = 0
        if size > pos:
            with open(path, "rb") as fh:
                fh.seek(pos)
                data = fh.read(MAX_FRAME)
            pos += len(data)
            yield _frame(rel, pos, data)
            last_beat = time.monotonic()
            idle_after_dead = False
            continue

        # Current file exhausted: advance across a rotation boundary.
        files = _log_files(log_dir, prefix)
        try:
            cur = files.index(fname)
        except ValueError:
            cur = -1
        if cur != -1 and cur + 1 < len(files):
            fname = files[cur + 1]
            rel = f"alloc/logs/{fname}"
            pos = 0
            yield _frame(rel, 0, event="next log file")
            continue

        if not follow:
            return
        if alive is not None and not alive():
            if idle_after_dead:
                return  # drained once after death — done
            idle_after_dead = True
        if time.monotonic() - last_beat >= HEARTBEAT_INTERVAL:
            yield _frame(rel, pos)
            last_beat = time.monotonic()
        time.sleep(poll)
