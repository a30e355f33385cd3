"""Restart policy state machine (a copy of ``nomad_tpu/client/restarts.py``;
reference: client/restarts.go:1-222).

Given the latest start error / wait result / restart signal, decides
whether the task should restart and after what delay, honoring the
task group's RestartPolicy (attempts within interval, delay vs fail
mode, 25% jitter).  The jitter's generator is an argument, ``rng``
(default: a fresh ``random.Random()``, as the reference makes one), so a
caller can seed the restart delays.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Optional

from ..structs import structs as s
from .driver.driver import WaitResult, is_recoverable

JITTER = 0.25

REASON_NO_RESTARTS_ALLOWED = "Policy allows no restarts"
REASON_UNRECOVERABLE = "Error was unrecoverable"
REASON_WITHIN_POLICY = "Restart within policy"
REASON_DELAY = "Exceeded allowed attempts, applying a delay"


class RestartTracker:
    def __init__(self, policy: s.RestartPolicy, job_type: str,
                 rng: Optional[random.Random] = None):
        # Batch jobs that exit 0 are done; service jobs restart on success
        # (restarts.go:23-27).
        self.on_success = job_type != s.JOB_TYPE_BATCH
        self.policy = policy
        self.count = 0
        self.start_time = time.time()
        self.reason = ""
        self._wait_res: Optional[WaitResult] = None
        self._start_err: Optional[BaseException] = None
        self._restart_triggered = False
        self._lock = threading.Lock()
        self._rand = rng if rng is not None else random.Random()

    def set_policy(self, policy: s.RestartPolicy) -> None:
        with self._lock:
            self.policy = policy

    def set_start_error(self, err: Optional[BaseException]) -> "RestartTracker":
        with self._lock:
            self._start_err = err
        return self

    def set_wait_result(self, res: WaitResult) -> "RestartTracker":
        with self._lock:
            self._wait_res = res
        return self

    def set_restart_triggered(self) -> "RestartTracker":
        with self._lock:
            self._restart_triggered = True
        return self

    def get_reason(self) -> str:
        with self._lock:
            return self.reason

    def get_state(self) -> tuple[str, float]:
        """→ (TASK_RESTARTING|TASK_NOT_RESTARTING|TASK_TERMINATED|'', delay)
        (restarts.go:91 GetState)."""
        with self._lock:
            try:
                return self._get_state()
            finally:
                self._start_err = None
                self._wait_res = None
                self._restart_triggered = False

    def _get_state(self) -> tuple[str, float]:
        if self._restart_triggered:
            self.reason = ""
            return s.TASK_RESTARTING, 0.0

        if self.policy.attempts == 0:
            self.reason = REASON_NO_RESTARTS_ALLOWED
            if self._wait_res is not None and self._wait_res.successful():
                return s.TASK_TERMINATED, 0.0
            return s.TASK_NOT_RESTARTING, 0.0

        self.count += 1

        # New interval resets the attempt budget (restarts.go:129-135).
        now = time.time()
        if now > self.start_time + self.policy.interval:
            self.count = 0
            self.start_time = now

        if self._start_err is not None:
            return self._handle_start_error()
        if self._wait_res is not None:
            return self._handle_wait_result()
        return "", 0.0

    def _over_budget(self) -> Optional[tuple[str, float]]:
        if self.count > self.policy.attempts:
            if self.policy.mode == s.RESTART_POLICY_MODE_FAIL:
                self.reason = (
                    f'Exceeded allowed attempts {self.policy.attempts} in interval '
                    f'{self.policy.interval}s and mode is "fail"')
                return s.TASK_NOT_RESTARTING, 0.0
            self.reason = REASON_DELAY
            return s.TASK_RESTARTING, self._interval_delay()
        return None

    def _handle_start_error(self) -> tuple[str, float]:
        if not is_recoverable(self._start_err):
            self.reason = REASON_UNRECOVERABLE
            return s.TASK_NOT_RESTARTING, 0.0
        over = self._over_budget()
        if over is not None:
            return over
        self.reason = REASON_WITHIN_POLICY
        return s.TASK_RESTARTING, self._jitter()

    def _handle_wait_result(self) -> tuple[str, float]:
        if self._wait_res.successful() and not self.on_success:
            self.reason = "Restart unnecessary as task terminated successfully"
            return s.TASK_TERMINATED, 0.0
        over = self._over_budget()
        if over is not None:
            return over
        self.reason = REASON_WITHIN_POLICY
        return s.TASK_RESTARTING, self._jitter()

    def _interval_delay(self) -> float:
        """Wait out the remainder of the current interval (restarts.go:199)."""
        return max(0.0, self.start_time + self.policy.interval - time.time())

    def _jitter(self) -> float:
        d = self.policy.delay or 1e-9
        return d + self._rand.uniform(0, d) * JITTER


def no_restarts_tracker() -> RestartTracker:
    return RestartTracker(
        s.RestartPolicy(attempts=0, mode=s.RESTART_POLICY_MODE_FAIL),
        s.JOB_TYPE_BATCH)
