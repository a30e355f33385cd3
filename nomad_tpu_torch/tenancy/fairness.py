"""Weighted fair dequeue: per-tenant subqueues under priority tiers (a copy
of ``nomad_tpu/tenancy/fairness.py``; the server feeds it the namespace
rows' weights and objectives and the store's per-namespace usage fold).

The eval broker's ready queue used to be one heap ordered by
``(-priority, create_index, seq)`` — strict FIFO within a priority
band, so one tenant submitting 10k evals starves everyone behind it
for the whole band.  ``TenantQueue`` keeps the exact same external
contract (push/pop of the broker's ``_HeapEntry``, ``len``/``iter``/
truthiness for the stats surface) but splits each priority tier into
per-tenant subheaps and picks WHICH tenant drains next by a pluggable
objective (Gavel-style policy family, arxiv 2008.09213):

- ``drf``         — lowest dominant-resource share / weight first
                    (usage fed from the state store's O(changed)
                    per-namespace fold, never a table walk here).
- ``weighted-rr`` — lowest virtual time first; each dequeue charges
                    ``1/weight`` of virtual time.
- ``fifo``        — score 0 for everyone: selection falls through to
                    the arrival tiebreak, reproducing the legacy
                    global-FIFO order exactly.

Complexity: every push/pop is O(log tiers + log tenants) — tenant
selection heaps use lazy invalidation (a version counter per tenant;
stale entries are skipped on pop), so nothing ever scans all tenants
on the hot path.  Priority composes ABOVE fairness: a higher tier
always drains first, which keeps the preemption plane and the
admission bypass-priority semantics unchanged.

Locking: none here.  The broker calls every method under its own lock,
exactly as it did for the plain list heaps this class replaces.
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..structs import structs as s

#: Usage-vector dims folded by the state store: cpu, mem, disk, iops.
_DIMS = 4


class FairnessState:
    """Shared fairness bookkeeping for one broker: resolved per-tenant
    policy (weight + objective), the usage fold mirror, cluster
    capacity, and virtual-time clocks.  One instance is shared by every
    TenantQueue of the broker (all scheduler-type queues and the failed
    queue draw from the same tenant clocks), mutated only under the
    broker's lock."""

    __slots__ = ("objective", "policy", "usage", "capacity", "vt",
                 "dequeued")

    def __init__(self, objective: str = s.TENANCY_OBJECTIVE_DRF):
        #: Cluster-wide default objective (NOMAD_TPU_TENANCY_OBJECTIVE);
        #: a Namespace row's ``objective`` field overrides per tenant.
        self.objective = objective
        #: ns -> (weight, objective_override)
        self.policy: Dict[str, Tuple[float, str]] = {}
        #: ns -> (cpu, mem, disk, iops, live_allocs) fold mirror.
        self.usage: Dict[str, Tuple[int, ...]] = {}
        #: Cluster capacity totals (cpu, mem, disk, iops); 0-dims are
        #: skipped when computing dominant share.
        self.capacity: Tuple[int, int, int, int] = (0, 0, 0, 0)
        #: Virtual-time clock per tenant (weighted-rr): advances
        #: 1/weight per dequeue, so heavier tenants drain more often.
        self.vt: Dict[str, float] = {}
        #: Lifetime dequeues per tenant (stats surface).
        self.dequeued: Dict[str, int] = {}

    # -- policy / usage feeds ----------------------------------------------

    def set_policy(self, name: str, weight: float, objective: str) -> None:
        self.policy[name] = (weight if weight > 0 else 1.0, objective)

    def drop_policy(self, name: str) -> None:
        self.policy.pop(name, None)

    def set_usage(self, name: str, vec: Tuple[int, ...]) -> None:
        self.usage[name] = vec

    def set_capacity(self, cap: Tuple[int, int, int, int]) -> None:
        self.capacity = cap

    # -- scoring ------------------------------------------------------------

    def weight(self, ns: str) -> float:
        p = self.policy.get(ns)
        return p[0] if p is not None else 1.0

    def tenant_objective(self, ns: str) -> str:
        p = self.policy.get(ns)
        if p is not None and p[1]:
            return p[1]
        return self.objective

    def dominant_share(self, ns: str) -> float:
        """max_d usage[d]/capacity[d] — the DRF dominant share."""
        u = self.usage.get(ns)
        if u is None:
            return 0.0
        cap = self.capacity
        share = 0.0
        for d in range(_DIMS):
            if cap[d] > 0 and u[d] > 0:
                frac = u[d] / cap[d]
                if frac > share:
                    share = frac
        return share

    def score(self, ns: str) -> float:
        """Lower drains first.  fifo scores 0 so ordering falls through
        to the arrival tiebreak (legacy order); drf and weighted-rr
        both normalize by the tenant's dequeue weight."""
        obj = self.tenant_objective(ns)
        if obj == s.TENANCY_OBJECTIVE_FIFO:
            return 0.0
        if obj == s.TENANCY_OBJECTIVE_WRR:
            return self.vt.get(ns, 0.0)
        return self.dominant_share(ns) / self.weight(ns)

    def on_dequeue(self, ns: str) -> None:
        self.vt[ns] = self.vt.get(ns, 0.0) + 1.0 / self.weight(ns)
        self.dequeued[ns] = self.dequeued.get(ns, 0) + 1


class _Tier:
    """One priority band: per-tenant subheaps plus a lazily-invalidated
    tenant selection heap."""

    __slots__ = ("subq", "sel", "ver", "size")

    def __init__(self) -> None:
        #: ns -> heap of _HeapEntry (sort_key order: within one tier
        #: the priority component ties, so this is (create_index, seq)
        #: arrival order — the legacy within-band FIFO).
        self.subq: Dict[str, List] = {}
        #: (score, head_create_index, head_seq, version, ns) — version
        #: mismatches against ``ver`` mark stale entries, skipped on pop.
        self.sel: List[Tuple[float, int, int, int, str]] = []
        self.ver: Dict[str, int] = {}
        self.size = 0


def _entry_ns(entry) -> str:
    ns = entry.eval.namespace
    return ns if ns else "default"


class TenantQueue:
    """Drop-in replacement for the broker's ``List[_HeapEntry]`` ready
    heaps: same push/pop element type, same len/iter/bool surface, but
    drained per-tenant by the shared FairnessState's objective."""

    __slots__ = ("fs", "tiers", "tier_heap", "_ns_tiers", "_len")

    def __init__(self, fs: FairnessState):
        self.fs = fs
        self.tiers: Dict[int, _Tier] = {}
        #: Lazy max-heap of -priority (entries for emptied tiers are
        #: skipped on read).
        self.tier_heap: List[int] = []
        #: ns -> set of priorities where the tenant has queued entries
        #: (the usage-changed re-score touches only these).
        self._ns_tiers: Dict[str, Set[int]] = {}
        self._len = 0

    # -- list-compatible surface -------------------------------------------

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def __iter__(self) -> Iterator:
        for tier in self.tiers.values():
            for heap in tier.subq.values():
                yield from heap

    # -- internals ----------------------------------------------------------

    def _sel_push(self, tier: _Tier, ns: str) -> None:
        """(Re)score a tenant within a tier: bump its version (stale
        entries die lazily) and push a fresh selection entry keyed on
        its current score + head arrival order."""
        head = tier.subq[ns][0]
        v = tier.ver.get(ns, 0) + 1
        tier.ver[ns] = v
        # sort_key = (-priority, create_index, seq); [1:] is arrival.
        k = head.sort_key
        heapq.heappush(tier.sel, (self.fs.score(ns), k[1], k[2], v, ns))

    def _top_tier(self) -> Optional[int]:
        th = self.tier_heap
        while th:
            prio = -th[0]
            tier = self.tiers.get(prio)
            if tier is not None and tier.size > 0:
                return prio
            heapq.heappop(th)
        return None

    # -- queue ops ----------------------------------------------------------

    def push(self, entry) -> None:
        prio = -entry.sort_key[0]
        ns = _entry_ns(entry)
        tier = self.tiers.get(prio)
        if tier is None:
            tier = self.tiers[prio] = _Tier()
            heapq.heappush(self.tier_heap, -prio)
        subq = tier.subq.get(ns)
        if subq is None:
            subq = tier.subq[ns] = []
        head_changed = not subq or entry.sort_key < subq[0].sort_key
        heapq.heappush(subq, entry)
        tier.size += 1
        self._len += 1
        self._ns_tiers.setdefault(ns, set()).add(prio)
        if head_changed:
            self._sel_push(tier, ns)

    def peek_priority(self) -> Optional[int]:
        """Highest queued priority, or None when empty (the broker's
        _scan cross-scheduler comparison point)."""
        return self._top_tier()

    def pop(self):
        """Dequeue the fairest tenant's oldest entry from the highest
        non-empty priority tier.  O(log tiers + log tenants) amortized;
        stale selection entries (version mismatch or drained subqueue)
        are discarded as they surface."""
        prio = self._top_tier()
        if prio is None:
            raise IndexError("pop from empty TenantQueue")
        tier = self.tiers[prio]
        sel = tier.sel
        while True:
            score, _ci, _seq, ver, ns = sel[0]
            subq = tier.subq.get(ns)
            if subq and tier.ver.get(ns) == ver:
                break
            heapq.heappop(sel)
        heapq.heappop(sel)
        entry = heapq.heappop(subq)
        tier.size -= 1
        self._len -= 1
        self.fs.on_dequeue(ns)
        if subq:
            # Refresh: the tenant's score and head arrival key both
            # changed; one push keeps selection O(log T) with staleness
            # bounded by a single dequeue.
            self._sel_push(tier, ns)
        else:
            del tier.subq[ns]
            tier.ver.pop(ns, None)
            tiers_of_ns = self._ns_tiers.get(ns)
            if tiers_of_ns is not None:
                tiers_of_ns.discard(prio)
                if not tiers_of_ns:
                    del self._ns_tiers[ns]
            if tier.size == 0:
                # Drop the tier dict entry; its tier_heap token dies
                # lazily in _top_tier.
                del self.tiers[prio]
        return entry

    def note_usage_changed(self, changed) -> None:
        """Re-score tenants whose usage fold moved (DRF only cares;
        re-pushing is harmless under other objectives).  O(changed ×
        log T) — driven by the state store's dirty drain, so an idle
        tenant costs nothing."""
        for ns in changed:
            tiers_of_ns = self._ns_tiers.get(ns)
            if not tiers_of_ns:
                continue
            for prio in tiers_of_ns:
                tier = self.tiers.get(prio)
                if tier is not None and ns in tier.subq:
                    self._sel_push(tier, ns)

    # -- stats --------------------------------------------------------------

    def pending_by_tenant(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for tier in self.tiers.values():
            for ns, heap in tier.subq.items():
                out[ns] = out.get(ns, 0) + len(heap)
        return out
