"""Client state persistence: alloc/task-runner state checkpointed to
disk so a restarted agent re-attaches to its work (a copy of
``nomad_tpu/client/state.py``; reference: client/client.go:357 bolt
state.db, alloc_runner.go:322 saveAllocRunnerState).

The reference uses boltdb; here each alloc's state is one struct-codec
frame (``server/log_codec``: registered struct trees only, never pickle,
so a corrupt or attacker-written state file can only inject data, not
code) under ``<state_dir>/allocs/<alloc_id>`` written atomically
(tmp+rename), giving the same crash-safety contract (a partially written
state file is never observed).  A frame of another struct schema (a
state dir of an earlier build) reads as no state, like a corrupt one:
the agent restarts the alloc from the server's view.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from ..server.log_codec import decode_payload, encode_payload


class StateDB:
    def __init__(self, state_dir: str):
        self.dir = os.path.join(state_dir, "allocs")
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.Lock()
        # Tmp names carry a writer-thread suffix (".tmp<ident>"), so a
        # crash between write and rename strands one; reap here, before
        # this process has any writer.  Age-gated: a sibling process
        # mid-handover may still be between fsync and rename on its own
        # tmp — deleting that would crash its os.replace — and a live
        # write is milliseconds old, never minutes.
        now = time.time()
        try:
            for f in os.listdir(self.dir):
                if ".tmp" not in f:
                    continue
                p = os.path.join(self.dir, f)
                try:
                    if now - os.path.getmtime(p) > 60.0:
                        os.unlink(p)
                except OSError:
                    pass
        except OSError:
            pass

    def _path(self, alloc_id: str) -> str:
        return os.path.join(self.dir, alloc_id)

    def put_alloc_runner(self, alloc_id: str, state: Dict) -> None:
        # fsync outside the lock (the static pass's lock-blocking rule):
        # each writer builds a private tmp file and only the atomic
        # rename serializes.
        path = self._path(alloc_id)
        tmp = f"{path}.tmp{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(encode_payload(state, "other"))
            f.flush()
            os.fsync(f.fileno())
        with self._lock:
            os.replace(tmp, path)

    def get_alloc_runner(self, alloc_id: str) -> Optional[Dict]:
        try:
            with open(self._path(alloc_id), "rb") as f:
                return decode_payload(f.read(), "other")
        except Exception:
            # Unreadable/corrupt state file == no state (the agent
            # restarts the alloc from the server's view).
            return None

    def list_alloc_runners(self) -> List[str]:
        try:
            return [f for f in os.listdir(self.dir) if ".tmp" not in f]
        except OSError:
            return []

    def delete_alloc_runner(self, alloc_id: str) -> None:
        try:
            os.unlink(self._path(alloc_id))
        except OSError:
            pass
