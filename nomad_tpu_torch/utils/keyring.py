"""Gossip keyring file management (<data_dir>/keyring.json; a copy of
``nomad_tpu/utils/keyring.py``).

Shared by the CLI keyring verb (cli/commands.py) and the agent HTTP
surface (/v1/agent/keyring/<op>, command/agent/http.go:158 +
agent_endpoint.go:166 KeyringOperationRequest).  Key semantics mirror
serf's keyring management: install adds a key (first install becomes
primary), use re-points the primary, remove refuses to drop the primary.
Keys are 32 bytes of base64; the wire encryption itself is a transport
concern (the reference's serf encrypt option).
"""
from __future__ import annotations

import base64
import contextlib
import json
import os
import threading
from typing import Dict

# The agent HTTP server is threaded; every mutation is a
# load→mutate→save round, so serialize them process-wide...
_LOCK = threading.Lock()


@contextlib.contextmanager
def _ring_lock(data_dir: str):
    """...and across processes: the CLI's file mode mutates the same
    keyring.json a live agent serves, so a thread lock alone still
    loses updates.  fcntl.flock on a sidecar lockfile covers both."""
    with _LOCK:
        os.makedirs(data_dir or ".", exist_ok=True)
        lockfile = keyring_path(data_dir) + ".lock"
        fh = open(lockfile, "a")
        try:
            try:
                import fcntl
                fcntl.flock(fh.fileno(), fcntl.LOCK_EX)
            except (ImportError, OSError):
                pass  # non-posix: thread lock only
            yield
        finally:
            fh.close()


class KeyringError(ValueError):
    pass


def keyring_path(data_dir: str) -> str:
    return os.path.join(data_dir or ".", "keyring.json")


def load(data_dir: str) -> Dict:
    path = keyring_path(data_dir)
    if os.path.exists(path):
        with open(path) as fh:
            return json.load(fh)
    return {"Keys": [], "Primary": ""}


def save(data_dir: str, ring: Dict) -> None:
    os.makedirs(data_dir or ".", exist_ok=True)
    path = keyring_path(data_dir)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(ring, fh, indent=2)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def validate_key(key: str) -> None:
    try:
        if len(base64.b64decode(key)) != 32:
            raise ValueError
    except Exception:
        raise KeyringError("key must be 32 bytes of base64") from None


def list_keys(data_dir: str) -> Dict:
    ring = load(data_dir)
    return {"Keys": list(ring["Keys"]), "Primary": ring["Primary"]}


def install(data_dir: str, key: str) -> None:
    validate_key(key)
    with _ring_lock(data_dir):
        ring = load(data_dir)
        if key not in ring["Keys"]:
            ring["Keys"].append(key)
        if not ring["Primary"]:
            ring["Primary"] = key
        save(data_dir, ring)


def use(data_dir: str, key: str) -> None:
    validate_key(key)
    with _ring_lock(data_dir):
        ring = load(data_dir)
        if key not in ring["Keys"]:
            raise KeyringError("key is not in the keyring")
        ring["Primary"] = key
        save(data_dir, ring)


def remove(data_dir: str, key: str) -> None:
    validate_key(key)
    with _ring_lock(data_dir):
        ring = load(data_dir)
        if key == ring["Primary"]:
            raise KeyringError("cannot remove the primary key")
        if key in ring["Keys"]:
            ring["Keys"].remove(key)
            save(data_dir, ring)


def key_response(data_dir: str) -> Dict:
    """The serf.KeyResponse shape the reference endpoint returns
    (agent_endpoint.go:205-215): per-key node counts — a single-process
    keyring reports one node."""
    ring = load(data_dir)
    return {
        "Messages": {},
        "NumNodes": 1,
        "Keys": {k: 1 for k in ring["Keys"]},
        "PrimaryKeys": ({ring["Primary"]: 1} if ring["Primary"] else {}),
    }
