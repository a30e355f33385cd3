"""Allocation directory tree (a copy of ``nomad_tpu/client/allocdir.py``;
reference: client/allocdir/alloc_dir.go:56-393, task_dir.go).

Layout per allocation:
    <alloc_id>/
      alloc/            shared between tasks
        data/  logs/  tmp/
      <task>/
        local/  secrets/  tmp/

Shared-dir contents migrate between allocations for sticky ephemeral
disks (`move`), and snapshot to a tar stream for cross-node migration
(`snapshot`).  The reference bind-mounts the shared dir into chroots;
here tasks get the paths via NOMAD_* env instead, which is the same
user-facing contract for non-chroot drivers.
"""
from __future__ import annotations

import io
import os
import shutil
import tarfile
import time
from typing import Dict, List

SHARED_ALLOC_NAME = "alloc"
SHARED_DATA_DIR = "data"
SHARED_LOGS = "logs"
TMP_DIR = "tmp"
TASK_LOCAL = "local"
TASK_SECRETS = "secrets"


class TaskDir:
    """Paths for one task within an allocation (task_dir.go)."""

    def __init__(self, alloc_dir: str, task_name: str):
        self.task_name = task_name
        self.dir = os.path.join(alloc_dir, task_name)
        self.local_dir = os.path.join(self.dir, TASK_LOCAL)
        self.secrets_dir = os.path.join(self.dir, TASK_SECRETS)
        self.tmp_dir = os.path.join(self.dir, TMP_DIR)
        self.shared_alloc_dir = os.path.join(alloc_dir, SHARED_ALLOC_NAME)
        self.log_dir = os.path.join(self.shared_alloc_dir, SHARED_LOGS)

    def build(self) -> None:
        for d in (self.dir, self.local_dir, self.tmp_dir):
            os.makedirs(d, exist_ok=True)
        os.makedirs(self.secrets_dir, exist_ok=True)
        try:
            os.chmod(self.secrets_dir, 0o700)
        except OSError:
            pass


class AllocDir:
    """(alloc_dir.go:56 AllocDir)."""

    def __init__(self, alloc_dir: str):
        self.alloc_dir = alloc_dir
        self.shared_dir = os.path.join(alloc_dir, SHARED_ALLOC_NAME)
        self.task_dirs: Dict[str, TaskDir] = {}
        self.built = False

    def new_task_dir(self, task_name: str) -> TaskDir:
        td = TaskDir(self.alloc_dir, task_name)
        self.task_dirs[task_name] = td
        return td

    def build(self) -> None:
        os.makedirs(self.alloc_dir, exist_ok=True)
        for sub in (SHARED_DATA_DIR, SHARED_LOGS, TMP_DIR):
            os.makedirs(os.path.join(self.shared_dir, sub), exist_ok=True)
        self.built = True

    def destroy(self) -> None:
        shutil.rmtree(self.alloc_dir, ignore_errors=True)

    # -- sticky disk -------------------------------------------------------
    def move(self, other: "AllocDir", tasks: List[str]) -> None:
        """Adopt the shared data dir + task local dirs from a previous
        allocation on the same node (alloc_dir.go:172 Move)."""
        other_data = os.path.join(other.shared_dir, SHARED_DATA_DIR)
        self_data = os.path.join(self.shared_dir, SHARED_DATA_DIR)
        if os.path.isdir(other_data):
            shutil.rmtree(self_data, ignore_errors=True)
            shutil.move(other_data, self_data)
        for name in tasks:
            src = TaskDir(other.alloc_dir, name).local_dir
            dst = self.task_dirs.get(name)
            if dst is None or not os.path.isdir(src):
                continue
            shutil.rmtree(dst.local_dir, ignore_errors=True)
            shutil.move(src, dst.local_dir)

    # -- migration ---------------------------------------------------------
    def snapshot(self) -> bytes:
        """Tar of shared data + task local dirs for cross-node sticky-disk
        migration (alloc_dir.go:110 Snapshot)."""
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as tar:
            targets = [os.path.join(self.shared_dir, SHARED_DATA_DIR)]
            targets += [td.local_dir for td in self.task_dirs.values()]
            for root in targets:
                if not os.path.isdir(root):
                    continue
                arc_root = os.path.relpath(root, self.alloc_dir)
                tar.add(root, arcname=arc_root)
        return buf.getvalue()

    def snapshot_to_file(self, path: str) -> None:
        """Tar the sticky data straight to ``path`` — migration transfers
        must not hold whole disks in memory (alloc_dir.go streams its
        Snapshot too)."""
        with tarfile.open(path, mode="w") as tar:
            targets = [os.path.join(self.shared_dir, SHARED_DATA_DIR)]
            targets += [td.local_dir for td in self.task_dirs.values()]
            for root in targets:
                if not os.path.isdir(root):
                    continue
                arc_root = os.path.relpath(root, self.alloc_dir)
                tar.add(root, arcname=arc_root)

    def restore_snapshot_file(self, path: str) -> None:
        with tarfile.open(path, mode="r") as tar:
            self._extract(tar)

    def restore_snapshot(self, data: bytes) -> None:
        with tarfile.open(fileobj=io.BytesIO(data), mode="r") as tar:
            self._extract(tar)

    def _extract(self, tar) -> None:
        for member in tar.getmembers():
            # refuse path escapes
            target = os.path.join(self.alloc_dir, member.name)
            if not os.path.realpath(target).startswith(
                    os.path.realpath(self.alloc_dir) + os.sep):
                continue
            tar.extract(member, self.alloc_dir, filter="data")

    # -- log access (fs API) ----------------------------------------------
    def list_dir(self, rel: str) -> List[Dict]:
        base = self._safe_path(rel)
        out = []
        for name in sorted(os.listdir(base)):
            st = os.stat(os.path.join(base, name))
            out.append({
                "Name": name,
                "IsDir": os.path.isdir(os.path.join(base, name)),
                "Size": st.st_size,
                "ModTime": st.st_mtime,
            })
        return out

    def stat(self, rel: str) -> Dict:
        p = self._safe_path(rel)
        st = os.stat(p)
        return {"Name": os.path.basename(p), "IsDir": os.path.isdir(p),
                "Size": st.st_size, "ModTime": st.st_mtime}

    def read_all(self, rel: str, max_bytes: int = 1 << 20) -> bytes:
        """Read a file, capped at max_bytes (the HTTP cat endpoint must not
        buffer arbitrarily large task output)."""
        with open(self._safe_path(rel), "rb") as f:
            return f.read(max_bytes)

    def read_at(self, rel: str, offset: int, limit: int) -> bytes:
        """(alloc_dir.go:334 ReadAt)."""
        p = self._safe_path(rel)
        with open(p, "rb") as f:
            f.seek(offset)
            return f.read(limit if limit > 0 else -1)

    def block_until_exists(self, rel: str, timeout: float = 10.0) -> bool:
        """(alloc_dir.go:358 BlockUntilExists) — poll-based tail support."""
        deadline = time.time() + timeout
        p = os.path.join(self.alloc_dir, rel)
        while time.time() < deadline:
            if os.path.exists(p):
                return True
            time.sleep(0.05)
        return False

    def _safe_path(self, rel: str) -> str:
        p = os.path.realpath(os.path.join(self.alloc_dir, rel.lstrip("/")))
        root = os.path.realpath(self.alloc_dir)
        if not (p == root or p.startswith(root + os.sep)):
            raise PermissionError(f"path escapes alloc dir: {rel}")
        return p


def disk_usage(path: str) -> int:
    """Bytes used under path (client/gc uses this for threshold checks)."""
    total = 0
    for root, _dirs, files in os.walk(path, onerror=lambda e: None):
        for f in files:
            try:
                total += os.lstat(os.path.join(root, f)).st_size
            except OSError:
                pass
    return total
