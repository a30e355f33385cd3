"""Client-side allocation garbage collector (a copy of
``nomad_tpu/client/gc.py``; reference: client/gc.go:20-435).

Terminal alloc runners enter an eviction priority queue (oldest
terminal first); collection triggers on an interval when disk usage or
the alloc-count cap is exceeded, and ``make_room_for`` evicts ahead of
new allocations.
"""
from __future__ import annotations

import heapq
import logging
import shutil
import threading
import time
from typing import Dict, List, Optional

from .alloc_runner import AllocRunner


class _IndexedGCAlloc:
    __slots__ = ("mod_time", "alloc_id", "runner")

    def __init__(self, mod_time: float, alloc_id: str, runner: AllocRunner):
        self.mod_time = mod_time
        self.alloc_id = alloc_id
        self.runner = runner

    def __lt__(self, other: "_IndexedGCAlloc") -> bool:
        return self.mod_time < other.mod_time


class AllocGarbageCollector:
    def __init__(self, config, stats_path: str = "/",
                 logger: Optional[logging.Logger] = None):
        self.config = config
        self.stats_path = stats_path
        self.logger = logger or logging.getLogger("nomad_tpu_torch.client.gc")
        self._heap: List[_IndexedGCAlloc] = []
        self._index: Dict[str, _IndexedGCAlloc] = {}
        self._lock = threading.Lock()
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- queue -------------------------------------------------------------
    def mark_for_collection(self, runner: AllocRunner) -> None:
        with self._lock:
            if runner.alloc.id in self._index:
                return
            item = _IndexedGCAlloc(time.time(), runner.alloc.id, runner)
            self._index[runner.alloc.id] = item
            heapq.heappush(self._heap, item)

    def remove(self, alloc_id: str) -> None:
        with self._lock:
            item = self._index.pop(alloc_id, None)
            if item is not None:
                self._heap.remove(item)
                heapq.heapify(self._heap)

    def _pop(self) -> Optional[AllocRunner]:
        with self._lock:
            while self._heap:
                item = heapq.heappop(self._heap)
                if self._index.pop(item.alloc_id, None) is not None:
                    return item.runner
        return None

    def count(self) -> int:
        with self._lock:
            return len(self._heap)

    # -- collection --------------------------------------------------------
    def _destroy(self, runner: AllocRunner) -> None:
        runner.destroy()
        runner.wait(timeout=30.0)
        runner.destroy_alloc_dir()

    def collect(self, alloc_id: str) -> bool:
        """Explicit GC of one alloc (client GC HTTP endpoint)."""
        with self._lock:
            item = self._index.pop(alloc_id, None)
            if item is None:
                return False
            self._heap.remove(item)
            heapq.heapify(self._heap)
        self._destroy(item.runner)
        return True

    def collect_all(self) -> int:
        n = 0
        while True:
            runner = self._pop()
            if runner is None:
                return n
            self._destroy(runner)
            n += 1

    def make_room_for(self, needed_mb: int, total_live_allocs: int) -> None:
        """Evict terminal allocs until the new alloc fits under the
        gc_max_allocs cap and disk need (gc.go:170 MakeRoomFor)."""
        max_allocs = getattr(self.config, "gc_max_allocs", 50)
        while (total_live_allocs + self.count() >= max_allocs
               and self.count() > 0):
            runner = self._pop()
            if runner is None:
                break
            self._destroy(runner)
        if needed_mb > 0:
            try:
                usage = shutil.disk_usage(self.stats_path)
                free_mb = usage.free >> 20
            except OSError:
                return
            while free_mb < needed_mb and self.count() > 0:
                runner = self._pop()
                if runner is None:
                    return
                self._destroy(runner)
                try:
                    free_mb = shutil.disk_usage(self.stats_path).free >> 20
                except OSError:
                    return

    # -- periodic ----------------------------------------------------------
    def run(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="client-gc")
        self._thread.start()

    def stop(self) -> None:
        self._shutdown.set()

    def threads(self) -> List[threading.Thread]:
        t = self._thread
        return [t] if t is not None and t.is_alive() else []

    def _loop(self) -> None:
        interval = getattr(self.config, "gc_interval", 60.0)
        threshold = getattr(self.config, "gc_disk_usage_threshold", 80.0)
        while not self._shutdown.wait(interval):
            try:
                usage = shutil.disk_usage(self.stats_path)
                pct = 100.0 * (usage.total - usage.free) / max(1, usage.total)
            except OSError:
                continue
            if pct >= threshold:
                runner = self._pop()
                if runner is not None:
                    self.logger.info("gc: disk %.0f%% — collecting %s",
                                     pct, runner.alloc.id[:8])
                    self._destroy(runner)
