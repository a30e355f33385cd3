"""Driver framework: the pluggable task-execution interface of the data
plane (a copy of ``nomad_tpu/client/driver/driver.py``; reference:
client/driver/driver.go:25-318).

A Driver knows how to validate a task's config, fingerprint its own
availability onto the node, and start a task — returning a DriverHandle
the TaskRunner uses to wait on / signal / kill the running task.  The
registry maps driver names (``task.driver``) to factories, mirroring
``BuiltinDrivers`` (driver.go:25-32).

In the port, ``load_builtins`` registers the builtin drivers (importing
their modules) and ``new_driver``/``validate_driver_config`` call it
first; ``WaitResult`` is defined in ``executor.py`` (a task's
supervisor interpreter loads that module without this one's structs)
and re-exported here.
"""
from __future__ import annotations

import logging
import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ...structs import structs as s
from .env import TaskEnv
from .executor import WaitResult  # noqa: F401  (re-exported)


# FS isolation modes advertised by drivers
# (reference: client/structs/structs.go FSIsolation).
FS_ISOLATION_NONE = "none"
FS_ISOLATION_CHROOT = "chroot"
FS_ISOLATION_IMAGE = "image"


class DriverError(Exception):
    """Base error for driver failures."""


class RecoverableError(DriverError):
    """An error the restart tracker may retry
    (reference: nomad/structs/errors.go IsRecoverable)."""


def is_recoverable(err: BaseException) -> bool:
    return isinstance(err, RecoverableError)


@dataclass
class DriverAbilities:
    """(driver.go:246-256)."""

    send_signals: bool = False
    exec: bool = False


@dataclass
class DriverContext:
    """Everything a driver factory gets handed
    (reference: driver.go:107-135 DriverContext)."""

    driver_name: str
    alloc_id: str
    config: "object"           # client config (duck-typed; needs .options dict)
    node: Optional[s.Node] = None
    task_env: Optional[TaskEnv] = None
    logger: logging.Logger = field(
        default_factory=lambda: logging.getLogger(
            "nomad_tpu_torch.client.driver"))


@dataclass
class ExecContext:
    """Paths a task executes within (reference: driver.go:339-352)."""

    task_dir: "object"         # allocdir.TaskDir
    task_env: TaskEnv


@dataclass
class PrestartResponse:
    """(driver.go:258-270) — created resources + network, pre-start."""

    created_resources: Dict[str, List[str]] = field(default_factory=dict)


@dataclass
class StartResponse:
    handle: "DriverHandle" = None
    network: Optional[s.NetworkResource] = None
    # The handle is a restored task's, from ``Driver.open`` (the port's).
    reattached: bool = False


class DriverHandle:
    """Live interface to a started task (reference: driver.go:295-318).

    ``wait_ch()`` returns a threading.Event set when the task exits;
    ``wait_result()`` then yields the WaitResult.  This replaces Go's
    ``WaitCh() chan *WaitResult``.
    """

    def id(self) -> str:
        raise NotImplementedError

    def wait_ch(self) -> threading.Event:
        raise NotImplementedError

    def wait_result(self) -> WaitResult:
        raise NotImplementedError

    def update(self, task: s.Task) -> None:
        raise NotImplementedError

    def kill(self) -> None:
        raise NotImplementedError

    def signal(self, sig: int) -> None:
        raise NotImplementedError

    def exec_cmd(self, cmd: str, args: List[str]) -> tuple[bytes, int]:
        raise NotImplementedError

    def stats(self) -> Dict:
        return {}

    def threads(self) -> List[threading.Thread]:
        """The live threads the handle runs the task on (none for a task
        in another process)."""
        return []

    def detach(self) -> bool:
        """Stop watching a task that outlives the agent, leaving it
        running (the port's; a client's shutdown).  False: the task
        cannot, and is killed instead."""
        return False


class Driver:
    """Task-execution backend (reference: driver.go:207-243)."""

    # Whether a restored client re-attaches to the driver's running
    # tasks through ``open`` (the port's; else it starts them anew).
    reattach = False

    def __init__(self, ctx: DriverContext):
        self.ctx = ctx
        self.logger = ctx.logger

    # -- lifecycle ---------------------------------------------------------
    def prestart(self, exec_ctx: ExecContext, task: s.Task) -> Optional[PrestartResponse]:
        return None

    def start(self, exec_ctx: ExecContext, task: s.Task) -> StartResponse:
        raise NotImplementedError

    def open(self, exec_ctx: ExecContext, handle_id: str) -> DriverHandle:
        """Re-attach to a running task after agent restart (driver.go:224)."""
        raise NotImplementedError

    def cleanup(self, exec_ctx: ExecContext, resources: Dict[str, List[str]]) -> None:
        return None

    # -- metadata ----------------------------------------------------------
    # Field schema for this driver's task config (helper/fields role);
    # subclasses declare {field: FieldSchema} and inherit validation.
    CONFIG_FIELDS: Dict = {}

    def validate(self, config: Dict) -> None:
        """Raise ValueError on bad task driver config (driver.go:230 via
        helper/fields FieldData.Validate)."""
        from .fields import validate_fields

        problems = validate_fields(config, self.CONFIG_FIELDS)
        if problems:
            raise ValueError("; ".join(problems))

    def abilities(self) -> DriverAbilities:
        return DriverAbilities()

    def fs_isolation(self) -> str:
        return FS_ISOLATION_NONE

    # -- fingerprinting ----------------------------------------------------
    def fingerprint(self, node: s.Node) -> bool:
        """Detect availability; set ``driver.<name>`` node attribute and
        return applicability (reference: each driver's Fingerprint)."""
        return False

    def periodic(self) -> tuple[bool, float]:
        """(enabled, period_seconds) — most drivers are static."""
        return (False, 0.0)


# ---------------------------------------------------------------------------
# Registry (reference: driver.go:25-41 BuiltinDrivers / NewDriver)

DriverFactory = Callable[[DriverContext], Driver]

BUILTIN_DRIVERS: Dict[str, DriverFactory] = {}


def register_driver(name: str, factory: DriverFactory) -> None:
    BUILTIN_DRIVERS[name] = factory


def load_builtins() -> Dict[str, DriverFactory]:
    """The registry with every builtin driver registered: importing
    ``container_drivers`` imports ``exec_drivers``, which imports
    ``mock_driver`` first, so the order is the JAX package's client's
    (mock_driver, the exec family, the containers) whichever module was
    imported first."""
    import importlib

    importlib.import_module(f"{__package__}.container_drivers")
    return BUILTIN_DRIVERS


def new_driver(name: str, ctx: DriverContext) -> Driver:
    factory = load_builtins().get(name)
    if factory is None:
        raise DriverError(f"unknown driver '{name}'")
    ctx.driver_name = name
    return factory(ctx)


def validate_driver_config(name: str, config: Dict, node: Optional[s.Node] = None) -> None:
    """Static validation used by job endpoints / jobspec checks."""
    ctx = DriverContext(driver_name=name, alloc_id="", config=None, node=node)
    new_driver(name, ctx).validate(config)


# ---------------------------------------------------------------------------
# Shared option parsing helper (mapstructure-equivalent, weakly typed)

_DURATION_SUFFIX = {"ns": 1e-9, "us": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0}


def parse_duration(v) -> float:
    """'10s'/'1m'/'250ms' → seconds; numbers pass through."""
    if isinstance(v, (int, float)):
        return float(v)
    txt = str(v).strip()
    for suf in ("ms", "us", "ns", "s", "m", "h"):
        if txt.endswith(suf):
            return float(txt[: -len(suf)]) * _DURATION_SUFFIX[suf]
    return float(txt)


def opt(config: Dict, key: str, default=None, cast=None):
    if key not in config or config[key] is None:
        return default
    v = config[key]
    if cast is bool and isinstance(v, str):
        return v.lower() in ("1", "true", "yes")
    if cast is not None:
        return cast(v)
    return v


def find_executable(name: str) -> Optional[str]:
    """PATH lookup used by driver fingerprints."""
    if os.path.sep in name:
        return name if os.access(name, os.X_OK) else None
    for p in os.environ.get("PATH", "").split(os.pathsep):
        cand = os.path.join(p, name)
        if os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    return None
