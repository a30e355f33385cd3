"""Mock driver: simulates task lifecycles without running processes —
the workhorse of client/integration tests (a copy of
``nomad_tpu/client/driver/mock_driver.py``; reference:
client/driver/mock_driver.go, build tag ``nomad_test``).  It is the only
builtin driver of the port's client: the exec family and the containers
are ROADMAP item 28(b).

Config keys (task.config):
  start_error / start_error_recoverable — fail Start()
  run_for          — simulated run duration ("10s" or seconds)
  exit_code        — exit code reported at the end of run_for
  exit_signal      — signal reported
  exit_err_msg     — error string attached to the wait result
  signal_error     — error returned from Signal()
  kill_after       — extra delay after kill before reporting exit
"""
from __future__ import annotations

import threading
import time

from ...structs import structs as s
from .fields import FieldSchema
from .driver import (
    Driver,
    DriverAbilities,
    DriverError,
    DriverHandle,
    ExecContext,
    FS_ISOLATION_NONE,
    RecoverableError,
    StartResponse,
    WaitResult,
    opt,
    parse_duration,
    register_driver,
)


class MockDriverHandle(DriverHandle):
    def __init__(self, task_name: str, run_for: float, exit_code: int,
                 exit_signal: int, exit_err: str, signal_err: str,
                 kill_after: float):
        self.task_name = task_name
        self.run_for = run_for
        self.exit_code = exit_code
        self.exit_signal = exit_signal
        self.exit_err = exit_err or None
        self.signal_err = signal_err
        self.kill_after = kill_after
        self._done = threading.Event()
        self._kill = threading.Event()
        self._result = WaitResult()
        self._start = time.time()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"mock-task-{task_name}")
        self._thread.start()

    def _run(self) -> None:
        killed = self._kill.wait(timeout=self.run_for)
        if killed:
            if self.kill_after > 0:
                time.sleep(self.kill_after)
            self._result = WaitResult(exit_code=1, signal=9)
        else:
            self._result = WaitResult(
                exit_code=self.exit_code, signal=self.exit_signal,
                err=self.exit_err)
        self._done.set()

    def id(self) -> str:
        return f"mock:{self.task_name}:{self._start}"

    def wait_ch(self) -> threading.Event:
        return self._done

    def wait_result(self) -> WaitResult:
        self._done.wait()
        return self._result

    def update(self, task: s.Task) -> None:
        return None

    def kill(self) -> None:
        self._kill.set()

    def signal(self, sig: int) -> None:
        if self.signal_err:
            raise DriverError(self.signal_err)

    def exec_cmd(self, cmd, args):
        return (b"", 0)

    def stats(self):
        return {"pid": 0, "uptime": time.time() - self._start}

    def threads(self):
        return [self._thread] if self._thread.is_alive() else []


class MockDriver(Driver):
    def abilities(self) -> DriverAbilities:
        return DriverAbilities(send_signals=True, exec=True)

    def fs_isolation(self) -> str:
        return FS_ISOLATION_NONE

    def start(self, exec_ctx: ExecContext, task: s.Task) -> StartResponse:
        cfg = task.config or {}
        start_err = opt(cfg, "start_error", "")
        if start_err:
            if opt(cfg, "start_error_recoverable", False, bool):
                raise RecoverableError(start_err)
            raise DriverError(start_err)
        handle = MockDriverHandle(
            task_name=task.name,
            run_for=parse_duration(opt(cfg, "run_for", 0)),
            exit_code=opt(cfg, "exit_code", 0, int),
            exit_signal=opt(cfg, "exit_signal", 0, int),
            exit_err=opt(cfg, "exit_err_msg", ""),
            signal_err=opt(cfg, "signal_error", ""),
            kill_after=parse_duration(opt(cfg, "kill_after", 0)),
        )
        return StartResponse(handle=handle)

    def open(self, exec_ctx: ExecContext, handle_id: str) -> DriverHandle:
        # A restarted agent cannot re-attach to a purely simulated task;
        # return a handle that reports immediate success.
        h = MockDriverHandle(task_name="reattached", run_for=0, exit_code=0,
                             exit_signal=0, exit_err="", signal_err="",
                             kill_after=0)
        return h

    # Weakly typed like the driver's own start-time casts (parse_duration
    # passes numbers through; exit codes cast digit strings).
    CONFIG_FIELDS = {
        "run_for": FieldSchema("duration"),
        "start_error": FieldSchema("string"),
        "start_error_recoverable": FieldSchema("boollike"),
        "exit_code": FieldSchema("intlike"),
        "exit_signal": FieldSchema("intlike"),
        "exit_err_msg": FieldSchema("string"),
        "signal_error": FieldSchema("string"),
        "stdout_string": FieldSchema("string"),
        "kill_after": FieldSchema("duration"),
    }

    def fingerprint(self, node: s.Node) -> bool:
        node.attributes["driver.mock_driver"] = "1"
        return True


register_driver("mock_driver", MockDriver)
