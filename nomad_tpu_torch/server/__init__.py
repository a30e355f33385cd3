"""The port's server package: so far the plan applier
(``server/plan_apply.py``, a subset of ``nomad_tpu/server/``)."""

from .plan_apply import PlanApplier  # noqa: F401
