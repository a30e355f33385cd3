"""Leader-side node heartbeat TTL tracking (a copy of
``nomad_tpu/server/heartbeat.py``; reference nomad/heartbeat.go:15-137).

TTL scales with fleet size: ttl = max(min_heartbeat_ttl,
nodes / max_heartbeats_per_second) + grace (config.go:185-197,264-266).
Expiry transitions the node to down through the log, which fans out
node-update evals via the server hook; it is traced (a
``heartbeat.expire`` event) and, with the stream armed, published as
``Node``/``NodeHeartbeatExpired``.  Left out: the ``heartbeat.deliver``
fault point.
"""
from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, Dict, Optional

from ..utils import tracing
from ..utils.telemetry import NULL_TELEMETRY

MIN_HEARTBEAT_TTL = 10.0
MAX_HEARTBEATS_PER_SECOND = 50.0
HEARTBEAT_GRACE = 10.0
# Server-assigned TTLs are jittered by up to this fraction so a fleet
# registered in one burst (agent rollout, load-harness client spin-up)
# does not renew in lockstep forever: identical TTLs turn N clients into
# one thundering herd hitting Node.UpdateStatus on the same beat.
HEARTBEAT_TTL_JITTER = 0.1


class HeartbeatTimers:
    # The owning server's event broker (attached by
    # Server.enable_event_stream): expiry events are per server, not
    # process-wide, so they do not go through the global note_external
    # hook, which would stamp them onto every armed stream.
    event_broker = None

    def __init__(
        self,
        on_expire: Callable[[str], None],
        min_ttl: float = MIN_HEARTBEAT_TTL,
        max_per_second: float = MAX_HEARTBEATS_PER_SECOND,
        grace: float = HEARTBEAT_GRACE,
        logger: Optional[logging.Logger] = None,
        metrics=None,
        ttl_jitter: float = HEARTBEAT_TTL_JITTER,
        rng: Optional[random.Random] = None,
    ):
        self.metrics = metrics if metrics is not None else NULL_TELEMETRY
        self.on_expire = on_expire
        self.min_ttl = min_ttl
        self.max_per_second = max_per_second
        self.grace = grace
        self.ttl_jitter = max(0.0, ttl_jitter)
        self.rng = rng or random.Random()
        self.logger = logger or logging.getLogger(
            "nomad_tpu_torch.heartbeat")
        self._l = threading.Lock()
        # node id → monotonic expiry deadline.  One sweeper thread walks
        # the table instead of one threading.Timer per node: at harness
        # scale a 2500-node fleet meant 2500 live timer THREADS plus two
        # thread creations per renewal, which starved the very renewals
        # the timers were guarding.
        self._timers: Dict[str, float] = {}
        self._enabled = False
        self._sweeper: Optional[threading.Thread] = None

    def set_enabled(self, enabled: bool) -> None:
        sweeper = None
        with self._l:
            self._enabled = enabled
            if not enabled:
                self._timers = {}
            else:
                # ALWAYS spawn on enable (an is_alive() check races a
                # disable→enable flap against the old sweeper's exit,
                # which would leave expiry permanently dead); the sweeper
                # exits when superseded.
                sweeper = self._sweeper = threading.Thread(
                    target=self._sweep, daemon=True,
                    name="heartbeat-sweeper")
        if sweeper is not None:
            sweeper.start()

    def _sweep(self) -> None:
        """Fire expiries for every deadline that passed.  Granularity
        scales with the configured TTL floor so test-sized TTLs expire
        promptly while production settings wake a few times a second."""
        interval = max(0.01, min(0.25, (self.min_ttl + self.grace) / 20.0))
        me = threading.current_thread()
        while True:
            with self._l:
                if not self._enabled or self._sweeper is not me:
                    return
                now = time.monotonic()
                due = [node_id for node_id, deadline in self._timers.items()
                       if deadline <= now]
            for node_id in due:
                self._invalidate(node_id)
            time.sleep(interval)

    def reset_heartbeat_timer(self, node_id: str) -> float:
        """(heartbeat.go:40 resetHeartbeatTimer) — returns the TTL granted."""
        with self._l:
            if not self._enabled:
                return self.min_ttl
            self.metrics.incr_counter("heartbeat.reset")
            ttl = max(self.min_ttl, len(self._timers) / self.max_per_second)
            # Granted TTL is jittered (uniform in [ttl, ttl·(1+jitter)])
            # so renewal arrivals stay dispersed: clients renew relative
            # to the GRANTED ttl, and an un-jittered grant keeps a
            # burst-registered fleet phase-locked indefinitely.  Always
            # upward: the expiry timer below uses the same jittered
            # value, so the liveness guarantee (ttl + grace) is intact.
            if self.ttl_jitter > 0:
                ttl *= 1.0 + self.rng.random() * self.ttl_jitter
            self._timers[node_id] = time.monotonic() + ttl + self.grace
            return ttl

    def _invalidate(self, node_id: str) -> None:
        """(heartbeat.go:86 invalidateHeartbeat)."""
        with self._l:
            deadline = self._timers.get(node_id)
            if deadline is None or deadline > time.monotonic():
                return  # cleared or renewed between sweep and fire
            del self._timers[node_id]
            if not self._enabled:
                return
        self.logger.warning("node %s heartbeat missed; marking down", node_id)
        self.metrics.incr_counter("heartbeat.invalidate")
        tracing.event("heartbeat.expire", node_id=node_id)
        # The expiry itself; the NodeStatusUpdated it causes is the
        # store's.  One branch while no broker is armed.
        eb = self.event_broker
        if eb is not None:
            eb.publish_external("Node", "NodeHeartbeatExpired", node_id)
        try:
            self.on_expire(node_id)
        except Exception:
            self.logger.exception("heartbeat invalidation for %s failed", node_id)

    def sweeper(self) -> Optional[threading.Thread]:
        """The live sweeper thread (it exits once disabled), for a bounded
        join at shutdown."""
        return self._sweeper

    def clear_heartbeat_timer(self, node_id: str) -> None:
        with self._l:
            self._timers.pop(node_id, None)

    def active(self) -> int:
        with self._l:
            return len(self._timers)
