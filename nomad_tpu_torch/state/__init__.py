"""The port's state store (a subset of ``nomad_tpu/state/``)."""

from .state_store import StateSnapshot, StateStore  # noqa: F401
