"""The port's client data plane (copies of ``nomad_tpu/client/``): the
node agent, its alloc and task runners, the builtin drivers (the mock
driver, the exec family and the containers), the restart tracker, the
alloc dirs, the GC, the client's state, the fingerprints and the
configuration they read.  Left for later: the vault client (ROADMAP item
30).

The names below are imported when first read (PEP 562), not when the
package is: a task's supervisor (``driver/supervisor.py``) runs as a
module of this package in an interpreter of its own, and must not pay
for ``client.py``'s imports (the fingerprints reach torch)."""

import importlib

_EXPORTS = {
    "AllocRunner": "alloc_runner",
    "get_client_status": "alloc_runner",
    "BUILTIN_FINGERPRINTS": "fingerprint",
    "fingerprint_node": "fingerprint",
    "Client": "client",
    "ClientConfig": "config",
    "RestartTracker": "restarts",
    "TaskRunner": "task_runner",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{module}", __name__), name)
    globals()[name] = value
    return value
