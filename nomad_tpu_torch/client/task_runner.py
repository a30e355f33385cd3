"""TaskRunner: drives one task through its lifecycle — artifacts,
driver start, wait, restart policy, kill/signal/update — and reports
TaskState transitions up to the AllocRunner (a copy of
``nomad_tpu/client/task_runner.py``; reference:
client/task_runner.go:69-1737).

The run loop mirrors task_runner.go:517 Run: prestart (artifacts) →
driver start → wait for exit or control events → consult RestartTracker
→ delay → loop.  Event names and the dead/failed accounting match the
reference so `alloc-status` output is comparable.

A task with a ``vault`` ask derives its token through the client's
``vault_client`` before it starts (task_runner.py:205-226): the token is
written to ``secrets/vault_token``, set as ``VAULT_TOKEN`` in the task's
environment and renewed until the runner ends; a failed derivation ends
the task dead with a failed ``Setup Failure`` event.  The restart
tracker's jitter takes the runner's ``rng`` (default: a
fresh generator, as the reference makes one).  A destroyed running task
always reports ``Killing`` before ``Killed`` (see ``destroy``).

Past the reference: ``stop()`` ends the runner at its client's shutdown,
and a task that outlives the agent (its handle ``detach``es: the exec
family's, under a supervisor) runs on without an event; a runner given
``restore_handle`` (a restored client's, for a task that was running)
re-attaches to that task through the driver's ``open`` instead of
starting it again (Go Nomad's restoreState; the JAX package's restored
runner starts the task anew).
"""
from __future__ import annotations

import logging
import os
import random
import threading
from typing import Callable, List, Optional

from ..structs import structs as s
from .allocdir import TaskDir
from .driver import env as envmod
from .driver.driver import (
    Driver,
    DriverContext,
    DriverHandle,
    ExecContext,
    StartResponse,
    WaitResult,
    new_driver,
)
from .getter import ArtifactError, get_artifact
from .restarts import RestartTracker

# Update callback: (task_name, new_state, event) → None.  state may be ""
# (append event only, no transition) and event may be None (transition
# only), matching task_runner.go setState semantics.
StateUpdater = Callable[[str, str, Optional[s.TaskEvent]], None]


class TaskRunner:
    def __init__(self,
                 config,                    # client config
                 alloc: s.Allocation,
                 task: s.Task,
                 task_dir: TaskDir,
                 updater: StateUpdater,
                 node: Optional[s.Node] = None,
                 consul=None,
                 logger: Optional[logging.Logger] = None,
                 rng: Optional[random.Random] = None,
                 restore_handle: str = "",
                 vault_token: str = "",
                 vault_client=None):
        self.config = config
        self.alloc = alloc
        self.task = task.copy()
        self.task_dir = task_dir
        self.updater = updater
        self.node = node
        self.consul = consul
        # The task's vault token (a restored runner's, or derived before
        # the first start) and the client's token manager.
        self.vault_token = vault_token
        self.vault_client = vault_client
        self._template_mgr = None
        self.logger = logger or logging.getLogger(
            "nomad_tpu_torch.client.task_runner")

        tg = alloc.job.lookup_task_group(alloc.task_group) if alloc.job else None
        policy = tg.restart_policy if tg and tg.restart_policy else s.RestartPolicy()
        job_type = alloc.job.type if alloc.job else s.JOB_TYPE_SERVICE
        self.restart_tracker = RestartTracker(policy, job_type, rng=rng)

        self.handle: Optional[DriverHandle] = None
        self._handle_lock = threading.Lock()
        self._destroy = threading.Event()
        self._destroy_event: Optional[s.TaskEvent] = None
        self._restart_ch = threading.Event()
        self._signal_queue: list[int] = []
        self._update_queue: list[s.Allocation] = []
        self._control = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._dead_emitted = False
        self._restore_handle = restore_handle
        self._stopping = False
        self._detached = False
        self.done = threading.Event()

    # -- env / driver ------------------------------------------------------
    def _build_env(self) -> envmod.TaskEnv:
        b = envmod.Builder()
        b.set_task(self.task).set_alloc(self.alloc)
        if self.node is not None:
            b.set_node(self.node)
        b.set_region(getattr(self.config, "region", "global"))
        b.set_dirs(self.task_dir.shared_alloc_dir, self.task_dir.local_dir,
                   self.task_dir.secrets_dir)
        if self.vault_token:
            b.set_vault_token(self.vault_token)
        return b.build()

    def _create_driver(self, task_env: envmod.TaskEnv) -> Driver:
        ctx = DriverContext(
            driver_name=self.task.driver,
            alloc_id=self.alloc.id,
            config=self.config,
            node=self.node,
            task_env=task_env,
            logger=self.logger,
        )
        return new_driver(self.task.driver, ctx)

    # -- state reporting ---------------------------------------------------
    def _emit(self, state: str, event: Optional[s.TaskEvent]) -> None:
        if state == s.TASK_STATE_DEAD:
            self._dead_emitted = True
        self.updater(self.task.name, state, event)

    # -- control surface (called by AllocRunner / client API) --------------
    def restart(self, source: str = "", reason: str = "") -> None:
        """(task_runner.go Restart) — user/template triggered restart."""
        self.restart_tracker.set_restart_triggered()
        with self._handle_lock:
            h = self.handle
        if h is not None:
            self._emit(s.TASK_STATE_RUNNING,
                       s.TaskEvent(type=s.TASK_RESTART_SIGNAL,
                                   restart_reason=reason or source))
            h.kill()

    def signal(self, sig: int) -> None:
        with self._handle_lock:
            h = self.handle
        if h is not None:
            self._emit(s.TASK_STATE_RUNNING,
                       s.TaskEvent(type=s.TASK_SIGNALING, signal=sig))
            h.signal(sig)

    def update(self, alloc: s.Allocation) -> None:
        """Adopt in-place updates (kill_timeout, env) without a restart
        (task_runner.go Update)."""
        self.alloc = alloc
        if alloc.job:
            tg = alloc.job.lookup_task_group(alloc.task_group)
            if tg:
                if tg.restart_policy:
                    self.restart_tracker.set_policy(tg.restart_policy)
                updated = tg.lookup_task(self.task.name)
                if updated is not None:
                    self.task = updated.copy()
                    with self._handle_lock:
                        if self.handle is not None:
                            self.handle.update(self.task)

    def destroy(self, event: Optional[s.TaskEvent] = None) -> None:
        """Kill the task and stop the runner (task_runner.go Destroy).
        The run loop kills a running task within its 0.1 s wait, after a
        ``Killing`` event, as task_runner.go orders them; the JAX
        package's destroy kills the handle at once, so its ``Killing``
        shows only when its loop wakes first."""
        self._destroy_event = event
        self._destroy.set()

    def stop(self) -> None:
        """End the runner at its client's shutdown: a running task whose
        handle detaches runs on, with no event (a restarted client
        re-attaches to it); any other task is destroyed, since it cannot
        outlive the agent's process."""
        self._stopping = True
        self.destroy()

    # -- main loop ---------------------------------------------------------
    def run(self) -> None:
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"task-runner-{self.alloc.id[:8]}-{self.task.name}")
        self._thread.start()

    def threads(self) -> List[threading.Thread]:
        """The runner's live threads: its loop, the task's handle and the
        template watcher."""
        out = []
        if self._thread is not None and self._thread.is_alive():
            out.append(self._thread)
        with self._handle_lock:
            h = self.handle
        if h is not None:
            out += h.threads()
        if self._template_mgr is not None:
            out += self._template_mgr.threads()
        return out

    def _run(self) -> None:
        try:
            self._run_loop()
        except Exception as e:  # defensive: never strand the alloc runner
            self.logger.exception("task runner crashed")
            self._emit(s.TASK_STATE_DEAD,
                       s.TaskEvent(type=s.TASK_SETUP_FAILURE, failed=True,
                                   message=str(e)))
        finally:
            if self.vault_token and self.vault_client is not None:
                self.vault_client.stop_renew_token(self.vault_token)
            if self._template_mgr is not None:
                self._template_mgr.stop()
            self._deregister_services()
            self.done.set()

    def _prestart(self, task_env: envmod.TaskEnv) -> bool:
        """Artifacts (+ dispatch payload); templates render here in the
        reference (task_runner.go prestart)."""
        if self.task.artifacts:
            self._emit(s.TASK_STATE_PENDING,
                       s.TaskEvent(type=s.TASK_DOWNLOADING_ARTIFACTS))
            for art in self.task.artifacts:
                try:
                    get_artifact(task_env, art, self.task_dir.dir)
                except ArtifactError as e:
                    self._emit(
                        s.TASK_STATE_DEAD,
                        s.TaskEvent(type=s.TASK_ARTIFACT_DOWNLOAD_FAILED,
                                    failed=True, message=str(e)))
                    return False
        return True

    def _run_loop(self) -> None:
        if not self._restore_handle:
            self._emit(s.TASK_STATE_PENDING,
                       s.TaskEvent(type=s.TASK_RECEIVED))

        self._loop_body()
        # Destroyed before (or between) iterations: still record the death
        # so the alloc status converges.
        if self._destroy.is_set() and not self._dead_emitted \
                and not self._detached:
            ev = self._destroy_event or s.TaskEvent(type=s.TASK_KILLED)
            self._emit(s.TASK_STATE_DEAD, ev)

    def _derive_vault_token(self) -> bool:
        """This task's vault token through the client's manager, written
        to the secrets dir and tracked for renewal (task_runner.go:675,
        :785 writeToken).  A failed derivation ends the task dead."""
        if self.task.vault is None or self.vault_client is None \
                or self.vault_token:
            return True
        try:
            info = self.vault_client.derive_token(
                self.alloc.id, [self.task.name])[self.task.name]
        except Exception as e:
            self._emit(s.TASK_STATE_DEAD,
                       s.TaskEvent(type=s.TASK_SETUP_FAILURE, failed=True,
                                   message=f"vault token derivation "
                                           f"failed: {e}"))
            return False
        self.vault_token = info["token"]
        try:
            token_path = os.path.join(self.task_dir.secrets_dir,
                                      "vault_token")
            with open(token_path, "w", encoding="utf-8") as fh:
                fh.write(self.vault_token)
            os.chmod(token_path, 0o600)
        except OSError as e:
            self.logger.warning("vault token write failed: %s", e)
        self.vault_client.renew_token(self.vault_token,
                                      float(info.get("ttl") or 3600.0))
        return True

    def _register_services(self, handle) -> None:
        """Advertise the task's services + checks with the task lifecycle
        (consul/client.go RegisterTask; script checks exec through the
        driver handle, consul/script.go)."""
        if self.consul is None or not self.task.services:
            return
        # Driver handles expose exec_cmd(cmd, args) -> (output, exit_code)
        # (driver.py DriverHandle); script checks run through it
        # (consul/script.go execs via the driver).
        exec_fn = getattr(handle, "exec_cmd", None)
        try:
            self.consul.register_task(self.alloc, self.task, exec_fn=exec_fn)
        except Exception as e:
            self.logger.warning("consul: service registration failed: %s", e)

    def _deregister_services(self) -> None:
        if self.consul is None or not self.task.services:
            return
        try:
            self.consul.deregister_task(self.alloc.id, self.task.name)
        except Exception as e:
            self.logger.warning("consul: deregistration failed: %s", e)

    def _render_templates(self, task_env) -> bool:
        """Render-block before start (consul_template.go:52: tasks wait
        for the initial render) and start the change watcher."""
        if not self.task.templates:
            return True
        if self._template_mgr is None:
            from .template import TaskTemplateManager

            catalog = getattr(self.consul, "catalog", None) \
                if self.consul is not None else None
            self._template_mgr = TaskTemplateManager(
                templates=self.task.templates,
                task_dir=self.task_dir.dir,
                env=task_env.env(),
                catalog=catalog,
                on_signal=self.signal,
                on_restart=lambda: self.restart(source="template",
                                                reason="template changed"),
                logger=self.logger)
            self._emit(s.TASK_STATE_PENDING,
                       s.TaskEvent(type=s.TASK_RECEIVED,
                                   message="rendering templates"))
            ok = self._template_mgr.render_all_blocking(
                should_abort=self._destroy.is_set)
            if not ok:
                return False
            self._template_mgr.start_watching()
        return True

    def _loop_body(self) -> None:
        while not self._destroy.is_set():
            resp = self._reattach()
            if resp is None:
                if not self._derive_vault_token():
                    return
                task_env = self._build_env()

                if not self._render_templates(task_env):
                    return

                if not self._prestart(task_env):
                    return

                # -- start ------------------------------------------------
                # Config validation is TERMINAL: an invalid config can
                # never succeed, so it must not burn restart attempts
                # (the reference fails Validate once, before the run loop).
                try:
                    driver = self._create_driver(task_env)
                    driver.validate(self.task.config or {})
                except ValueError as e:
                    self._emit(s.TASK_STATE_DEAD,
                               s.TaskEvent(type=s.TASK_DRIVER_FAILURE,
                                           failed=True,
                                           message=f"driver config "
                                                   f"validation failed: {e}"))
                    return

                try:
                    exec_ctx = ExecContext(task_dir=self.task_dir,
                                           task_env=task_env)
                    driver.prestart(exec_ctx, self.task)
                    resp = driver.start(exec_ctx, self.task)
                except Exception as e:
                    self.logger.warning("driver start failed: %s", e)
                    self._emit(s.TASK_STATE_PENDING,
                               s.TaskEvent(type=s.TASK_DRIVER_FAILURE,
                                           message=str(e)))
                    self.restart_tracker.set_start_error(e)
                    if not self._should_restart():
                        return
                    continue

            with self._handle_lock:
                self.handle = resp.handle
            if not resp.reattached:
                self._emit(s.TASK_STATE_RUNNING,
                           s.TaskEvent(type=s.TASK_STARTED))
            self._register_services(resp.handle)

            # -- wait -----------------------------------------------------
            wait_ev = resp.handle.wait_ch()
            while not wait_ev.wait(timeout=0.1):
                if self._stopping and resp.handle.detach():
                    # The client's shutdown: the task runs on.
                    self._detached = True
                    return
                if self._destroy.is_set():
                    self._emit(s.TASK_STATE_RUNNING,
                               s.TaskEvent(type=s.TASK_KILLING,
                                           kill_timeout=self.task.kill_timeout))
                    resp.handle.kill()
                    wait_ev.wait()
                    break
            res: WaitResult = resp.handle.wait_result()
            self._deregister_services()
            with self._handle_lock:
                self.handle = None

            if self._destroy.is_set():
                # the _run_loop trailer emits the dead state
                return

            # Event-only append: the restart decision below sets the state
            # (task_runner.go: setState("", waitEvent) then shouldRestart).
            self._emit(
                "",
                s.TaskEvent(type=s.TASK_TERMINATED, exit_code=res.exit_code,
                            signal=res.signal, message=res.err or ""))
            self.restart_tracker.set_wait_result(res)
            if not self._should_restart():
                return

    def _reattach(self) -> Optional[StartResponse]:
        """The restored task's handle through the driver's ``open``, once
        (None: the task starts anew, received again)."""
        handle_id, self._restore_handle = self._restore_handle, ""
        if not handle_id:
            return None
        try:
            task_env = self._build_env()
            driver = self._create_driver(task_env)
            if driver.reattach:
                return StartResponse(handle=driver.open(ExecContext(
                    task_dir=self.task_dir, task_env=task_env), handle_id),
                    reattached=True)
        except Exception as e:
            self.logger.warning("re-attach to %s failed: %s", handle_id, e)
        self._emit(s.TASK_STATE_PENDING, s.TaskEvent(type=s.TASK_RECEIVED))
        return None

    def _should_restart(self) -> bool:
        """Consult the tracker; sleep the restart delay; emit the verdict
        events (task_runner.go:1400 shouldRestart)."""
        state, delay = self.restart_tracker.get_state()
        reason = self.restart_tracker.get_reason()

        if state in ("", s.TASK_TERMINATED):
            # The Terminated event is already appended; just transition.
            self._emit(s.TASK_STATE_DEAD, None)
            return False
        if state == s.TASK_NOT_RESTARTING:
            self._emit(s.TASK_STATE_DEAD,
                       s.TaskEvent(type=s.TASK_NOT_RESTARTING, failed=True,
                                   restart_reason=reason))
            return False
        # TASK_RESTARTING
        self._emit(s.TASK_STATE_PENDING,
                   s.TaskEvent(type=s.TASK_RESTARTING, restart_reason=reason,
                               start_delay=delay))
        if self._destroy.wait(timeout=delay):
            # destroyed during the restart delay; trailer emits dead
            return False
        return True
