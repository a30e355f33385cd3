"""The port's client data plane (copies of ``nomad_tpu/client/``): the
node agent, its alloc and task runners on the mock driver, the restart
tracker, the alloc dirs, the GC, the client's state, the fingerprints
and the configuration they read.  Left for later: the exec family and
the containers (ROADMAP item 28(b)) and the vault client (item 30)."""

from .alloc_runner import AllocRunner, get_client_status
from .client import Client
from .config import ClientConfig
from .fingerprint import BUILTIN_FINGERPRINTS, fingerprint_node
from .restarts import RestartTracker
from .task_runner import TaskRunner

__all__ = [
    "AllocRunner",
    "BUILTIN_FINGERPRINTS",
    "Client",
    "ClientConfig",
    "RestartTracker",
    "TaskRunner",
    "fingerprint_node",
    "get_client_status",
]
