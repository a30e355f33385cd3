"""Artifact fetcher (a copy of ``nomad_tpu/client/getter.py``'s local and
git routes; reference client/getter/getter.go:36-127, which wraps
go-getter).

Supports ``file://`` paths, plain local paths and ``git::`` clones (ref
via the ``ref`` getter option), with optional checksum verification via
the same ``checksum=<type>:<hex>`` option go-getter uses.  Source
strings are env-interpolated before fetch (getter.go GetArtifact).

Left out: the reference's ``http(s)://`` and ``s3://`` routes.  Such a
source raises ``ArtifactError``, which fails the task with a
``Failed Artifact Download`` event, never a silent skip.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import urllib.parse

from ..structs import structs as s
from .driver.env import TaskEnv


class ArtifactError(Exception):
    pass


def get_artifact(task_env: TaskEnv, artifact: s.TaskArtifact, task_dir: str) -> str:
    source = task_env.replace_env(artifact.getter_source or "")
    if not source:
        raise ArtifactError("artifact source empty")
    rel_dest = task_env.replace_env(artifact.relative_dest or "local/")
    dest_dir = os.path.join(task_dir, rel_dest.lstrip("/"))
    os.makedirs(dest_dir, exist_ok=True)

    # git::<url> (go-getter forced-protocol syntax) clones the repository
    # into the destination directory.
    if source.startswith("git::") or source.endswith(".git"):
        return _get_git(source, artifact, dest_dir)

    parsed = urllib.parse.urlparse(source)
    name = os.path.basename(parsed.path) or "artifact"
    dest = os.path.join(dest_dir, name)

    if parsed.scheme in ("", "file"):
        src_path = parsed.path if parsed.scheme == "file" else source
        if not os.path.exists(src_path):
            raise ArtifactError(f"artifact not found: {src_path}")
        if os.path.isdir(src_path):
            shutil.copytree(src_path, dest, dirs_exist_ok=True)
        else:
            shutil.copy2(src_path, dest)
    else:
        raise ArtifactError(
            f"unsupported artifact scheme {parsed.scheme!r}: the port's "
            "getter fetches local files and git repositories only")

    _verify_checksum(artifact, task_env, dest)
    return dest


def _verify_checksum(artifact: s.TaskArtifact, task_env: TaskEnv, path: str) -> None:
    opts = artifact.getter_options or {}
    spec = task_env.replace_env(opts.get("checksum", "") or "")
    if not spec or os.path.isdir(path):
        return
    try:
        algo, want = spec.split(":", 1)
    except ValueError:
        raise ArtifactError(f"bad checksum spec {spec!r}")
    try:
        h = hashlib.new(algo)
    except ValueError:
        raise ArtifactError(f"unsupported checksum algo {algo!r}")
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 16), b""):
            h.update(chunk)
    if h.hexdigest() != want.lower():
        raise ArtifactError(
            f"checksum mismatch for {path}: got {h.hexdigest()}, want {want}")


def _get_git(source: str, artifact: s.TaskArtifact, dest_dir: str) -> str:
    """Clone a git artifact (go-getter's git detector): ``git::<url>``,
    optional ``ref`` getter option selects a branch/tag/commit."""
    import subprocess

    opts = artifact.getter_options or {}
    if opts.get("checksum"):
        # go-getter rejects checksums on directory gets; silently skipping
        # a user-specified integrity check would be worse.
        raise ArtifactError(
            "checksum verification is not supported for git artifacts")
    url = source[len("git::"):] if source.startswith("git::") else source
    name = os.path.basename(urllib.parse.urlparse(url).path)
    if name.endswith(".git"):
        name = name[:-4]
    dest = os.path.join(dest_dir, name or "repo")
    # Restart loops re-run artifact fetch; a stale clone must not fail it.
    if os.path.isdir(dest):
        shutil.rmtree(dest, ignore_errors=True)
    ref = opts.get("ref", "")
    try:
        subprocess.run(["git", "clone", "--quiet", url, dest],
                       check=True, capture_output=True, timeout=300)
        if ref:
            subprocess.run(["git", "-C", dest, "checkout", "--quiet", ref],
                           check=True, capture_output=True, timeout=60)
    except FileNotFoundError as e:
        raise ArtifactError(f"git not available: {e}") from e
    except subprocess.TimeoutExpired as e:
        raise ArtifactError(f"git clone timed out: {e}") from e
    except subprocess.CalledProcessError as e:
        raise ArtifactError(
            f"git clone failed: {e.stderr.decode(errors='replace')}") from e
    return dest
