"""cgroup resource isolation for executed tasks (a copy of
``nomad_tpu/client/driver/cgroups.py``; reference:
client/driver/executor/executor_linux.go -- configureCgroups applies
memory.limit_in_bytes, cpu.shares, and cleanup kills the group).

Supports both hierarchies:
  v2 (unified): <root>/cgroup.controllers present --
      memory.max + cpu.weight, membership via cgroup.procs
  v1 (split):   per-controller trees memory/ and cpu/

Where the port departs from the reference: the cgroup root is the
client's ``ClientConfig.cgroup_root``, passed down to ``available`` and
``TaskCgroup``, not the constant ``/sys/fs/cgroup``.  Empty, the default,
means no cgroups at all: the executor takes the reference's route for a
host without writable cgroups (no group, the ``RLIMIT_AS`` memory cap),
so nothing is created under the host's cgroup tree unless a client is
configured to.

Availability is probed once a root; on hosts without writable cgroups
(or non-root) isolation degrades to the executor's RLIMIT fallback, like
the reference's non-Linux executors."""

from __future__ import annotations

import functools
import logging
import os
import signal
import time
from typing import List

PARENT = "nomad-tpu"

logger = logging.getLogger("nomad_tpu_torch.cgroups")


def _is_v2(root: str) -> bool:
    return os.path.exists(os.path.join(root, "cgroup.controllers"))


@functools.lru_cache(maxsize=None)
def available(root: str) -> bool:
    """Writable cgroup tree at ``root`` + root privileges: isolation can
    be applied.  Probed once a root per process (a host property that
    does not change); an empty root is never available."""
    if not root or os.geteuid() != 0:
        return False
    try:
        if _is_v2(root):
            probe = os.path.join(root, f"{PARENT}-probe")
        else:
            probe = os.path.join(root, "memory", f"{PARENT}-probe")
        os.makedirs(probe, exist_ok=True)
        os.rmdir(probe)
        return True
    except OSError:
        return False


class TaskCgroup:
    """One task's cgroup(s) under ``root``: created with limits, pid
    added, destroyed with the task (executor_linux.go configureCgroups +
    destroyCgroup)."""

    def __init__(self, name: str, cpu_mhz: int = 0, memory_mb: int = 0,
                 root: str = ""):
        self.name = name
        self.cpu_mhz = cpu_mhz
        self.memory_mb = memory_mb
        self.root = root
        self.paths: List[str] = []

    def _write(self, path: str, fname: str, value: str) -> bool:
        try:
            with open(os.path.join(path, fname), "w") as fh:
                fh.write(value)
            return True
        except OSError as e:
            logger.warning("cgroup write %s/%s failed: %s", path, fname, e)
            return False

    def create(self) -> bool:
        """True only when the MEMORY limit verifiably applied -- a caller
        that drops its RLIMIT fallback on our word must not be lied to."""
        if not self.root:
            return False
        root = self.root
        try:
            mem_ok = True
            if _is_v2(root):
                parent = os.path.join(root, PARENT)
                os.makedirs(parent, exist_ok=True)
                # v2 children only get controller files once the parent
                # delegates them (cgroup.subtree_control).
                self._write(root, "cgroup.subtree_control", "+memory +cpu")
                self._write(parent, "cgroup.subtree_control",
                            "+memory +cpu")
                path = os.path.join(parent, self.name)
                os.makedirs(path, exist_ok=True)
                if self.memory_mb > 0:
                    mem_ok = self._write(path, "memory.max",
                                         str(self.memory_mb * 1024 * 1024))
                if self.cpu_mhz > 0:
                    # cpu.weight 1-10000; the reference maps MHz shares --
                    # same monotone mapping, clamped.
                    self._write(path, "cpu.weight",
                                str(max(1, min(10000, self.cpu_mhz))))
                self.paths = [path]
            else:
                mem = os.path.join(root, "memory", PARENT, self.name)
                cpu = os.path.join(root, "cpu", PARENT, self.name)
                os.makedirs(mem, exist_ok=True)
                os.makedirs(cpu, exist_ok=True)
                if self.memory_mb > 0:
                    mem_ok = self._write(mem, "memory.limit_in_bytes",
                                         str(self.memory_mb * 1024 * 1024))
                if self.cpu_mhz > 0:
                    # cpu.shares: MHz, floor 2 (executor_linux.go)
                    self._write(cpu, "cpu.shares",
                                str(max(2, self.cpu_mhz)))
                self.paths = [mem, cpu]
            if not mem_ok:
                self.destroy(kill=False)
                return False
            return True
        except OSError as e:
            logger.warning("cgroup create failed for %s: %s", self.name, e)
            self.paths = []
            return False

    def add_pid(self, pid: int) -> None:
        for path in self.paths:
            self._write(path, "cgroup.procs", str(pid))

    def pids(self) -> List[int]:
        """Union over every hierarchy -- a process may have joined only
        one of the v1 controllers."""
        out: set = set()
        for path in self.paths:
            try:
                with open(os.path.join(path, "cgroup.procs")) as fh:
                    out.update(int(line) for line in fh if line.strip())
            except OSError:
                pass
        return sorted(out)

    def destroy(self, kill: bool = True, timeout: float = 5.0) -> None:
        """Kill every process still in the group, then remove it
        (executor_linux.go destroyCgroup)."""
        if kill:
            deadline = time.time() + timeout
            sig = signal.SIGKILL
            while time.time() < deadline:
                pids = self.pids()
                if not pids:
                    break
                for pid in pids:
                    try:
                        os.kill(pid, sig)
                    except (ProcessLookupError, PermissionError):
                        pass
                time.sleep(0.05)
        for path in self.paths:
            try:
                os.rmdir(path)
            except OSError:
                pass
        self.paths = []
