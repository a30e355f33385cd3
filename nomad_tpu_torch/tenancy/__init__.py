"""The port's tenancy plane: so far the broker's weighted fair dequeue
(``fairness.py``).  The quota ledger and the rate limiter come with a
later slice."""

from .fairness import FairnessState, TenantQueue

__all__ = ["FairnessState", "TenantQueue"]
