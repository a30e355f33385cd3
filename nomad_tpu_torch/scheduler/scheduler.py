"""Scheduler interfaces and factory (a copy of
``nomad_tpu/scheduler/scheduler.py``; reference
scheduler/scheduler.go:16-104): a registry keyed by name, and the State
and Planner interfaces that keep a scheduler free of plumbing (it sees a
state snapshot and a planner to submit plans through).

The port keeps its own registry: ``service`` and ``batch`` are the CPU
oracle (``scheduler/generic.py``), ``torch-batch`` the batch scheduler
of ``ops/batch_sched.py`` (the reference's ``tpu-batch``) and
``torch-system`` the vectorized system scheduler of
``ops/system_batch.py`` (the reference's ``tpu-system``).
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Protocol, Tuple

from ..structs import structs as s

class State(Protocol):
    """The immutable world view the scheduler works from
    (scheduler.go:63-82)."""

    def nodes(self, ws) -> List[s.Node]: ...

    def node_by_id(self, ws, node_id: str) -> Optional[s.Node]: ...

    def allocs_by_job(self, ws, job_id: str, all_allocs: bool = False) -> List[s.Allocation]: ...

    def allocs_by_node(self, ws, node_id: str) -> List[s.Allocation]: ...

    def allocs_by_node_terminal(self, ws, node_id: str, terminal: bool) -> List[s.Allocation]: ...

    def job_by_id(self, ws, job_id: str) -> Optional[s.Job]: ...


class Planner(Protocol):
    """How the scheduler submits its decisions (scheduler.go:84-104)."""

    def submit_plan(self, plan: s.Plan) -> Tuple[Optional[s.PlanResult], Optional[State]]:
        """Returns (result, refreshed_state_or_None)."""
        ...

    def update_eval(self, ev: s.Evaluation) -> None: ...

    def create_eval(self, ev: s.Evaluation) -> None: ...

    def reblock_eval(self, ev: s.Evaluation) -> None: ...


class Scheduler(Protocol):
    def process(self, ev: s.Evaluation) -> None: ...


SchedulerFactory = Callable[..., Scheduler]

_BUILTIN: Dict[str, SchedulerFactory] = {}


def register_scheduler(name: str, factory: SchedulerFactory) -> None:
    _BUILTIN[name] = factory


def _load_builtins() -> None:
    """Import the modules that register the built-in schedulers."""
    from . import generic  # noqa: F401
    from ..ops import batch_sched, system_batch  # noqa: F401


def new_scheduler(name: str, logger: logging.Logger, state: State,
                  planner: Planner, **kwargs) -> Scheduler:
    """Instantiate a scheduler by name (scheduler.go:42 NewScheduler).
    ``kwargs`` go to the factory: ``device="cpu"`` for ``torch-batch`` on
    the CPU (it runs on the card otherwise)."""
    factory = _BUILTIN.get(name)
    if factory is None:
        _load_builtins()
        factory = _BUILTIN.get(name)
    if factory is None:
        raise ValueError(f"unknown scheduler {name!r}")
    return factory(logger, state, planner, **kwargs)
