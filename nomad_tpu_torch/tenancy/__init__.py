"""The port's tenancy plane (a copy of ``nomad_tpu/tenancy/``): namespaces
are registered through the log like jobs (``structs.Namespace``,
``MessageType.NAMESPACE_UPSERT``) and enforced at host-side choke points,
none of which touch the device path:

- ``quota.QuotaLedger``   -- the admission-time alloc-count and
  node-units quotas, checked before the log write (a refusal is the
  broker's ``BrokerLimitError``);
- ``quota.RateLimiter``   -- the per-tenant token-bucket API rate,
  configured from the namespace rows (its HTTP front door comes later);
- ``fairness.TenantQueue`` -- the weighted fair dequeue in the eval
  broker: per-tenant subqueues drained by dominant-resource fairness.
"""

from .fairness import FairnessState, TenantQueue
from .quota import QuotaLedger, RateLimiter, TokenBucket

__all__ = ["FairnessState", "TenantQueue", "QuotaLedger", "RateLimiter",
           "TokenBucket"]
