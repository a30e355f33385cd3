"""Agent log ring + streaming (a copy of ``nomad_tpu/utils/logring.py``;
reference: command/agent/log_*.go — the
gated writer and log writer ring feeding /v1/agent/monitor-style
streaming, plus the level filter).

A logging.Handler keeps the last N formatted records in a ring; monitors
attach a queue and receive every subsequent record (the gated-writer
role: late attachers first drain the retained backlog)."""

from __future__ import annotations

import collections
import logging
import queue
import threading
from typing import Iterator, List, Optional


class LogRingHandler(logging.Handler):
    """Ring buffer of formatted log lines with live fan-out."""

    def __init__(self, capacity: int = 512):
        super().__init__()
        self.capacity = capacity
        self._l = threading.Lock()
        self._ring: "collections.deque[str]" = collections.deque(
            maxlen=capacity)
        self._monitors: List["queue.Queue[str]"] = []
        self.setFormatter(logging.Formatter(
            "%(asctime)s [%(levelname)s] %(name)s: %(message)s"))

    def emit(self, record: logging.LogRecord) -> None:
        try:
            line = self.format(record)
        except Exception:
            return
        with self._l:
            self._ring.append(line)
            monitors = list(self._monitors)
        for q in monitors:
            try:
                q.put_nowait(line)
            except queue.Full:
                pass  # slow monitor: drop, never block logging

    def backlog(self) -> List[str]:
        with self._l:
            return list(self._ring)

    def monitor(self, level: int = logging.INFO,
                stop_event: Optional[threading.Event] = None,
                ) -> Iterator[str]:
        """Yield retained lines then follow live ones (the monitor
        command's stream).  The caller stops by closing the generator or
        setting ``stop_event``."""
        q: "queue.Queue[str]" = queue.Queue(maxsize=1024)
        with self._l:
            backlog = list(self._ring)
            self._monitors.append(q)
        try:
            for line in backlog:
                yield line
            while stop_event is None or not stop_event.is_set():
                try:
                    yield q.get(timeout=0.5)
                except queue.Empty:
                    continue
        finally:
            with self._l:
                if q in self._monitors:
                    self._monitors.remove(q)
