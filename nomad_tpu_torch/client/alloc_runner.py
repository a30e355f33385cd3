"""AllocRunner: runs one allocation — builds the alloc dir, spawns a
TaskRunner per task, aggregates task states into the allocation's
client status, and pushes dirty status upstream (a copy of
``nomad_tpu/client/alloc_runner.py``; reference:
client/alloc_runner.go:47-921).

Past the reference: a destroyed runner is done once its tasks have died
(bounded by the client's ``max_kill_timeout``), not at once, so their
last states are synced; ``stop()`` ends the runner's threads at the
client's shutdown without recording anything more (an exec-family task
runs on under its supervisor, as the reference's does, and a restored
runner re-attaches to it through ``restored_handles``; a mock driver's
task is a thread of the agent's process, which cannot outlive it, and
is killed); and ``threads()`` lists what is still alive.
"""
from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional

from ..structs import structs as s
from .allocdir import AllocDir
from .task_runner import TaskRunner

AllocUpdater = Callable[[s.Allocation], None]


def get_client_status(task_states: Dict[str, s.TaskState]) -> str:
    """Fold task states into an alloc client status
    (alloc_runner.go:491 getClientStatus)."""
    pending = running = dead = failed = False
    for st in task_states.values():
        if st.state == s.TASK_STATE_RUNNING:
            running = True
        elif st.state == s.TASK_STATE_PENDING:
            pending = True
        elif st.state == s.TASK_STATE_DEAD:
            if st.failed:
                failed = True
            else:
                dead = True
    if failed:
        return s.ALLOC_CLIENT_STATUS_FAILED
    if running:
        return s.ALLOC_CLIENT_STATUS_RUNNING
    if pending:
        return s.ALLOC_CLIENT_STATUS_PENDING
    if dead:
        return s.ALLOC_CLIENT_STATUS_COMPLETE
    return ""


class AllocRunner:
    def __init__(self,
                 config,
                 alloc: s.Allocation,
                 updater: AllocUpdater,
                 node: Optional[s.Node] = None,
                 state_db=None,
                 prev_alloc_dir: Optional[AllocDir] = None,
                 consul=None,
                 logger: Optional[logging.Logger] = None,
                 rng: Optional[random.Random] = None,
                 vault_client=None):
        self.config = config
        self.alloc = alloc.copy()
        self.updater = updater
        self.node = node
        self.state_db = state_db
        self.consul = consul
        self.rng = rng
        # The client's vault token manager, handed to every task runner.
        self.vault_client = vault_client
        self.logger = logger or logging.getLogger(
            "nomad_tpu_torch.client.alloc_runner")

        base = getattr(config, "alloc_dir", None) or "/tmp/nomad-tpu-allocs"
        self.alloc_dir = AllocDir(os.path.join(base, alloc.id))
        self.prev_alloc_dir = prev_alloc_dir

        self.task_states: Dict[str, s.TaskState] = {}
        # task -> its saved handle id (a restored runner's).
        self.restored_handles: Dict[str, str] = {}
        self.task_runners: Dict[str, TaskRunner] = {}
        self._state_lock = threading.Lock()
        self._alloc_client_status = ""
        self._alloc_client_description = ""
        self._failed_task = ""
        self._dirty = threading.Event()
        self._destroy = threading.Event()
        self._destroy_event: Optional[s.TaskEvent] = None
        self._stopped = threading.Event()
        self._threads: List[threading.Thread] = []
        self.done = threading.Event()
        self.waiting_on_previous = threading.Event()
        self.waiting_on_previous.set()
        # Path to a sticky-disk tar pulled from a previous alloc on
        # another node (client.go:1743); applied after the alloc dir is
        # built, then deleted.
        self.remote_snapshot_path = None

    # -- views -------------------------------------------------------------
    def current_alloc(self) -> s.Allocation:
        """Copy with live client status folded in (alloc_runner.go Alloc)."""
        alloc = self.alloc.copy()
        with self._state_lock:
            alloc.task_states = {k: v.copy() for k, v in self.task_states.items()}
            if self._alloc_client_status:
                alloc.client_status = self._alloc_client_status
                alloc.client_description = self._alloc_client_description
            else:
                alloc.client_status = (
                    get_client_status(self.task_states)
                    or s.ALLOC_CLIENT_STATUS_PENDING)
        return alloc

    # -- task state intake -------------------------------------------------
    def _set_task_state(self, task_name: str, state: str,
                        event: Optional[s.TaskEvent]) -> None:
        """(alloc_runner.go:558 setTaskState) + failed-sibling kill."""
        kill_siblings = False
        with self._state_lock:
            ts = self.task_states.setdefault(task_name, s.TaskState())
            if event is not None:
                if event.time == 0.0:
                    event.time = time.time()
                if event.failed:
                    ts.failed = True
                ts.events.append(event)
                # Keep the event window bounded like the 10-event ring
                # (structs.go maxTaskEventBuffer).
                if len(ts.events) > 10:
                    ts.events = ts.events[-10:]
            if state:
                if state == s.TASK_STATE_RUNNING and ts.state != state:
                    ts.started_at = time.time()
                if state == s.TASK_STATE_DEAD and ts.state != state:
                    ts.finished_at = time.time()
                ts.state = state
            if ts.state == s.TASK_STATE_DEAD and ts.failed:
                kill_siblings = True
                self._failed_task = task_name
            # Snapshot under the lock: _run_inner may still be inserting
            # runners concurrently.
            siblings = [(n, tr) for n, tr in self.task_runners.items()
                        if n != task_name] if kill_siblings else []

        for name, tr in siblings:
            tr.destroy(s.TaskEvent(
                type=s.TASK_SIBLING_FAILED, failed_sibling=task_name,
                failed=True))
        self._dirty.set()

    # -- persistence -------------------------------------------------------
    def save_state(self) -> None:
        if self.state_db is None or self._stopped.is_set():
            return
        with self._state_lock:
            handles = {
                name: tr.handle.id()
                for name, tr in self.task_runners.items()
                if tr.handle is not None
            }
            self.state_db.put_alloc_runner(self.alloc.id, {
                "alloc": self.alloc,
                "task_states": {k: v.copy() for k, v in self.task_states.items()},
                "handles": handles,
                "alloc_dir": self.alloc_dir.alloc_dir,
            })

    # -- lifecycle ---------------------------------------------------------
    def run(self) -> None:
        self.spawn(self._run, f"alloc-runner-{self.alloc.id[:8]}")
        self.spawn(self._sync_loop, f"alloc-sync-{self.alloc.id[:8]}")

    def spawn(self, target, name: str) -> None:
        """Start a thread of this runner (listed by ``threads()``)."""
        t = threading.Thread(target=target, daemon=True, name=name)
        t.start()
        self._threads.append(t)

    def threads(self) -> List[threading.Thread]:
        out = [t for t in self._threads if t.is_alive()]
        for tr in list(self.task_runners.values()):
            out += tr.threads()
        return out

    def stop(self) -> None:
        """End the runner's threads at the client's shutdown: a task that
        outlives the agent runs on (``TaskRunner.stop``), and nothing more
        is recorded or pushed (the state saved before stays what a
        restarted client restores)."""
        self._stopped.set()
        self._destroy.set()
        self.waiting_on_previous.set()
        with self._state_lock:
            runners = list(self.task_runners.values())
        for tr in runners:
            tr.stop()
        self._dirty.set()

    def _run(self) -> None:
        try:
            self._run_inner()
        except Exception as e:
            self.logger.exception("alloc runner failed")
            with self._state_lock:
                self._alloc_client_status = s.ALLOC_CLIENT_STATUS_FAILED
                self._alloc_client_description = str(e)
            self._dirty.set()
        finally:
            self.done.set()
            self._dirty.set()

    def _run_inner(self) -> None:
        tg = (self.alloc.job.lookup_task_group(self.alloc.task_group)
              if self.alloc.job else None)
        if tg is None:
            with self._state_lock:
                self._alloc_client_status = s.ALLOC_CLIENT_STATUS_FAILED
                self._alloc_client_description = (
                    f"task group {self.alloc.task_group!r} not in job")
            return

        if self.alloc.terminal_status():
            return

        # Block on a previous allocation's shutdown for sticky disks
        # (client.go:1654 blocking + migration).
        self.waiting_on_previous.wait()

        self.alloc_dir.build()
        for task in tg.tasks:
            self.alloc_dir.new_task_dir(task.name).build()
        if (self.prev_alloc_dir is not None and tg.ephemeral_disk is not None
                and tg.ephemeral_disk.sticky):
            try:
                self.alloc_dir.move(self.prev_alloc_dir,
                                    [t.name for t in tg.tasks])
            except OSError as e:
                self.logger.warning("sticky disk move failed: %s", e)
        elif self.remote_snapshot_path:
            import tarfile
            try:
                self.alloc_dir.restore_snapshot_file(self.remote_snapshot_path)
            except (OSError, tarfile.TarError) as e:
                self.logger.warning("remote sticky restore failed: %s", e)
            try:
                os.unlink(self.remote_snapshot_path)
            except OSError:
                pass
            self.remote_snapshot_path = None

        for task in tg.tasks:
            tr = TaskRunner(
                config=self.config,
                alloc=self.alloc,
                task=task,
                task_dir=self.alloc_dir.task_dirs[task.name],
                updater=self._set_task_state,
                node=self.node,
                consul=self.consul,
                vault_client=self.vault_client,
                logger=self.logger,
                rng=self.rng,
                restore_handle=self._restore_handle(task.name),
            )
            with self._state_lock:
                self.task_runners[task.name] = tr
                failed_sibling = self._failed_task
            if failed_sibling:
                # A sibling already failed while we were still spawning —
                # this late runner must die too, not slip past the kill.
                tr.destroy(s.TaskEvent(type=s.TASK_SIBLING_FAILED,
                                       failed_sibling=failed_sibling,
                                       failed=True))
            elif self._stopped.is_set():
                tr.stop()
            elif self._destroy.is_set():
                # Destroyed while spawning: a runner made after the kill
                # must not start its task.
                tr.destroy(self._destroy_event
                           or s.TaskEvent(type=s.TASK_KILLED))
            tr.run()

        for tr in self.task_runners.values():
            while not tr.done.wait(timeout=0.25):
                if self._destroy.is_set():
                    # A destroyed task's runner kills it within its wait
                    # loop: wait for its last state (bounded by the
                    # client's kill timeout), so that state is synced
                    # before this runner is done.
                    tr.done.wait(getattr(self.config, "max_kill_timeout",
                                         30.0))
                    break
        self.save_state()

    def _restore_handle(self, task: str) -> str:
        """The saved handle id of a restored task that was running (the
        task runner re-attaches to it), else ""."""
        ts = self.task_states.get(task)
        if ts is None or ts.state != s.TASK_STATE_RUNNING:
            return ""
        return self.restored_handles.get(task, "")

    def _sync_loop(self) -> None:
        """Debounced status push (alloc_runner.go dirtySyncState)."""
        while True:
            self._dirty.wait()
            self._dirty.clear()
            if self._stopped.is_set():
                return
            self.updater(self.current_alloc())
            self.save_state()
            if self.done.is_set() and not self._dirty.is_set():
                return
            time.sleep(0.05)

    # -- control -----------------------------------------------------------
    def update(self, alloc: s.Allocation) -> None:
        """Server pushed a new version of this alloc
        (alloc_runner.go Update)."""
        self.alloc = alloc.copy()
        if alloc.desired_status in (s.ALLOC_DESIRED_STATUS_STOP,
                                    s.ALLOC_DESIRED_STATUS_EVICT):
            self.destroy()
            return
        with self._state_lock:
            runners = list(self.task_runners.values())
        for tr in runners:
            tr.update(alloc)
        self._dirty.set()

    def destroy(self, event: Optional[s.TaskEvent] = None) -> None:
        self._destroy_event = event
        self._destroy.set()
        self.waiting_on_previous.set()
        with self._state_lock:
            runners = list(self.task_runners.values())
        for tr in runners:
            tr.destroy(event or s.TaskEvent(type=s.TASK_KILLED))

    def destroy_alloc_dir(self) -> None:
        self.alloc_dir.destroy()
        if self.state_db is not None:
            self.state_db.delete_alloc_runner(self.alloc.id)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)

    def is_destroyed(self) -> bool:
        return self._destroy.is_set()

    def stats_report(self) -> Dict:
        """Per-task resource-usage snapshot for the client HTTP stats
        endpoint (reference: AllocRunner.StatsReporter / alloc stats)."""
        tasks: Dict[str, Dict] = {}
        for name, tr in list(self.task_runners.items()):
            h = tr.handle
            if h is None:
                continue
            try:
                tasks[name] = h.stats()
            except Exception:
                tasks[name] = {}
        return {"ResourceUsage": {"Tasks": tasks}, "Timestamp": time.time()}
