"""Kernel circuit breaker: graceful degradation from the device pass to the
CPU oracle (a copy of ``nomad_tpu/ops/breaker.py``).

The batch scheduler validates the structural invariants of every device
result (``ops/batch_sched.validate_device_outputs``) and feeds the
verdict here.  When agreement over a sliding window drops below the
threshold the breaker **trips open** and every eval takes the CPU
``GenericScheduler`` oracle: scheduling slows down but never stops or
mis-places.  After a cooldown the breaker goes **half-open**: exactly one
batch probes the device path; a clean probe closes the breaker, a dirty
one opens it again.

The breaker is process-wide (``BREAKER``) so that a trip outlives the
scheduler made for one batch; tests pass their own instance.  Each
transition is logged, traced (a ``breaker.transition`` span) and
published on the cluster event stream (``Breaker``/``BreakerTransition``).
A trip and a failed probe are flight-recorder incidents
(``utils/blackbox.py``): ``breaker.open`` with the agreement and the trip
count, ``breaker.reopen`` with the trip count, each bundle naming the
breaker that fired it.

Verdicts recorded: the structural validation of each device result, the
resident usage mirror's differential guard and the quantized rows'
round-trip check (``ops/resident.py``).  A raw device error (a build,
launch or CUDA fault) propagates to the caller and is never recorded, so
a kernel that cannot run never leaves evals on the CPU oracle.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable

from .. import fault
from ..utils import blackbox, tracing

logger = logging.getLogger("nomad_tpu_torch.ops.breaker")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

def _stream_transition(frm: str, to: str, **payload) -> None:
    """Mirror a breaker transition into the cluster event stream
    (fault.note_event_stream avoids importing the server package)."""
    fault.note_event_stream("Breaker", "BreakerTransition", to,
                            dict(payload, From=frm, To=to))


# The state's gauge code (breaker.state telemetry).
STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class KernelIntegrityError(RuntimeError):
    """The device result broke a structural invariant; nothing of it was
    used."""


class KernelCircuitBreaker:
    def __init__(self, threshold: float = 0.9, window: int = 64,
                 min_checks: int = 8, cooldown: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = threshold
        self.window = int(window)
        self.min_checks = int(min_checks)
        self.cooldown = cooldown
        self.clock = clock
        self._l = threading.Lock()
        self._state = CLOSED
        self._checks: deque = deque(maxlen=max(1, self.window))
        self._tripped_at = 0.0
        self._probe_started = 0.0
        self.trips = 0  # lifetime trip count

    # -- observations ------------------------------------------------------

    def record(self, ok: bool, n: int = 1) -> None:
        """Record ``n`` checks with one outcome: a device batch contributes
        its structural-validation verdict."""
        if n <= 0:
            return
        with self._l:
            self._checks.extend([bool(ok)] * min(n, self._checks.maxlen))
            if self._state != CLOSED:
                return
            total = len(self._checks)
            if total < self.min_checks:
                return
            ratio = sum(self._checks) / total
            if ratio < self.threshold:
                self._state = OPEN
                self._tripped_at = self.clock()
                self.trips += 1
                tracing.event("breaker.transition", frm=CLOSED, to=OPEN,
                              agreement=round(ratio, 4), trips=self.trips)
                _stream_transition(CLOSED, OPEN,
                                   Agreement=round(ratio, 4),
                                   Trips=self.trips)
                blackbox.note_trigger(
                    "breaker.open", {"Agreement": round(ratio, 4),
                                     "Trips": self.trips}, breaker=self)
                logger.warning(
                    "kernel circuit breaker OPEN: agreement %.2f < %.2f "
                    "over %d checks; routing evals through the CPU oracle "
                    "for %.1fs", ratio, self.threshold, total, self.cooldown)

    # -- gating ------------------------------------------------------------

    def allow_kernel(self) -> bool:
        """May the next batch take the device path?  While open, False
        until the cooldown elapses; then exactly one caller gets True as
        the half-open probe and the others stay on the oracle until
        ``on_probe`` resolves it."""
        with self._l:
            if self._state == CLOSED:
                return True
            if self._state == OPEN and (
                    self.clock() - self._tripped_at >= self.cooldown):
                self._state = HALF_OPEN
                self._probe_started = self.clock()
                tracing.event("breaker.transition", frm=OPEN, to=HALF_OPEN)
                _stream_transition(OPEN, HALF_OPEN)
                logger.info("kernel circuit breaker HALF-OPEN: probing the "
                            "device path with one batch")
                return True
            if self._state == HALF_OPEN and (
                    self.clock() - self._probe_started >= self.cooldown):
                # The probe never resolved (its batch died on another
                # error): grant a fresh one rather than wedge.
                self._probe_started = self.clock()
                logger.warning("kernel circuit breaker: probe expired "
                               "unresolved; granting a new probe batch")
                return True
            return False

    def on_probe(self, ok: bool) -> None:
        """Resolve a half-open probe: clean closes (fresh window), dirty
        opens again and restarts the cooldown."""
        with self._l:
            if self._state != HALF_OPEN:
                return
            if ok:
                self._state = CLOSED
                self._checks.clear()
                tracing.event("breaker.transition", frm=HALF_OPEN, to=CLOSED)
                _stream_transition(HALF_OPEN, CLOSED)
                logger.info("kernel circuit breaker CLOSED: probe batch "
                            "agreed; device path restored")
            else:
                self._state = OPEN
                self._tripped_at = self.clock()
                tracing.event("breaker.transition", frm=HALF_OPEN, to=OPEN)
                _stream_transition(HALF_OPEN, OPEN)
                blackbox.note_trigger("breaker.reopen",
                                      {"Trips": self.trips}, breaker=self)
                logger.warning("kernel circuit breaker RE-OPEN: probe batch "
                               "disagreed; staying on the CPU oracle")

    # -- introspection -----------------------------------------------------

    def agreement(self) -> float:
        """The share of good checks in the window (1.0 when empty)."""
        with self._l:
            return (sum(self._checks) / len(self._checks)
                    if self._checks else 1.0)

    @property
    def state(self) -> str:
        with self._l:
            return self._state


# Process-wide breaker shared by every TorchBatchScheduler.
BREAKER = KernelCircuitBreaker()


def reset_for_tests() -> None:
    """A fresh process-wide breaker."""
    global BREAKER
    BREAKER = KernelCircuitBreaker()
