"""Preemption oracle: minimal eviction-set selection for priority-tier
preemption.

When a high-priority task group finds no node with spare capacity, the
scheduler may make room by evicting strictly-lower-priority allocations
(the reference reserves this via BinPackIterator's evict/priority flags,
rank.go:130; the selection semantics mirror Nomad's later
SpaceToMakeRoom: candidates ordered priority-ascending, then
largest-resource-first, so the cheapest work is displaced and the fewest
allocations move).

This module is the per-node CPU oracle (a copy of
``nomad_tpu/scheduler/preempt.py``).  Its batched device twin,
``ops/preempt.py`` (the ``csrc/eviction_sets.cu`` kernel and its plain
PyTorch version), runs the same algorithm over every (task group, node)
pair at once; both take their candidates from ``sort_candidates``, so
their eviction sets agree exactly, and ``TorchBatchScheduler``
replays this oracle on every set it commits.  ``preemption_enabled`` is
a constructor argument of the schedulers (default False); the port reads
no environment for it.

Algorithm per (node, ask, priority):

1. candidates = non-terminal allocs with job priority < the placing
   priority, sorted by (priority asc, resources desc, id asc);
2. greedy prefix: take candidates in order until the ask fits the freed
   capacity (scalar dims: cpu, memory, disk, iops);
3. reverse trim: walk the chosen prefix backwards (highest-priority
   victim first) dropping any alloc whose eviction is not needed for the
   fit.  Dropping only shrinks the freed capacity, so a kept alloc can
   never become droppable later — one pass yields an inclusion-minimal
   set (no member can be removed; asserted by tests/test_preempt.py).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from ..structs import structs as s

# Score discount applied to a preempting placement so any node that fits
# WITHOUT eviction outranks it (binpack scores live in [0, 18]); the
# per-alloc term prefers smaller eviction sets among preempting nodes.
PREEMPTION_SCORE_PENALTY = 20.0
PREEMPTION_PER_ALLOC_PENALTY = 1.0

# Priority of the padding rows of the device encoding: never a candidate
# (real job priorities are 0-100, structs.go JobMaxPriority).
PRIORITY_SENTINEL = 1 << 30


def preemption_score_penalty(n_evicted: int) -> float:
    return (PREEMPTION_SCORE_PENALTY
            + PREEMPTION_PER_ALLOC_PENALTY * n_evicted)


def alloc_priority(alloc: s.Allocation, state=None) -> int:
    """The priority tier an allocation runs at: its job's priority,
    falling back to a state lookup for normalized plan copies (the job
    pointer is stripped by Plan.append_update) and to the default tier
    when neither is available."""
    if alloc.job is not None:
        return alloc.job.priority
    if state is not None:
        job = state.job_by_id(None, alloc.job_id)
        if job is not None:
            return job.priority
    return s.JOB_DEFAULT_PRIORITY


def alloc_size(alloc: s.Allocation) -> Tuple[int, int, int, int]:
    """(cpu, memory_mb, disk_mb, iops) an allocation occupies — combined
    resources when present, else shared + per-task (the same split
    funcs.allocs_fit consumes)."""
    r = alloc.resources
    if r is not None:
        return (r.cpu, r.memory_mb, r.disk_mb, r.iops)
    cpu = mem = disk = iops = 0
    if alloc.shared_resources is not None:
        sr = alloc.shared_resources
        cpu, mem, disk, iops = sr.cpu, sr.memory_mb, sr.disk_mb, sr.iops
    for tr in alloc.task_resources.values():
        cpu += tr.cpu
        mem += tr.memory_mb
        disk += tr.disk_mb
        iops += tr.iops
    return (cpu, mem, disk, iops)


def sort_candidates(
    allocs: List[s.Allocation],
    prio_of: Callable[[s.Allocation], int],
) -> List[s.Allocation]:
    """Eviction-candidate order shared by the oracle and the device
    encoding: priority ascending (cheapest tier first), then
    largest-resource-first within a tier (fewest evictions make room),
    id ascending as the deterministic tie-break."""
    return sorted(allocs, key=lambda a: (
        prio_of(a), tuple(-d for d in alloc_size(a)), a.id))


def select_eviction_prefix(
    free: Tuple[int, int, int, int],
    ask: Tuple[int, int, int, int],
    sizes: List[Tuple[int, int, int, int]],
) -> Optional[List[int]]:
    """Indices (into the pre-sorted candidate list) to evict so that
    ``ask`` fits into ``free`` plus the freed capacity, or None when even
    evicting every candidate is not enough.  Pure integer arithmetic —
    the exact sequence the device kernel replays as cumsum + scan."""
    freed = [0, 0, 0, 0]

    def fits(extra=(0, 0, 0, 0), minus=(0, 0, 0, 0)) -> bool:
        return all(ask[d] <= free[d] + freed[d] + extra[d] - minus[d]
                   for d in range(4))

    k = 0
    while not fits():
        if k == len(sizes):
            return None
        for d in range(4):
            freed[d] += sizes[k][d]
        k += 1
    chosen = list(range(k))
    # Reverse trim: un-evict from the back (highest-priority victim
    # first) whenever the fit survives without that alloc.
    for i in reversed(range(k)):
        size = sizes[i]
        if fits(minus=size):
            for d in range(4):
                freed[d] -= size[d]
            chosen.remove(i)
    return chosen


def find_eviction_set(
    node: s.Node,
    allocs: List[s.Allocation],
    ask: s.Resources,
    priority: int,
    prio_of: Optional[Callable[[s.Allocation], int]] = None,
) -> Optional[List[s.Allocation]]:
    """Minimal set of strictly-lower-priority allocs on ``node`` whose
    eviction lets ``ask`` fit, or None when no such set exists.

    ``allocs`` is the node's proposed (non-terminal) allocation list;
    capacity accounting covers the four scalar dimensions — network
    feasibility after eviction is the caller's re-check (rank.py rebuilds
    the NetworkIndex over the survivors)."""
    if prio_of is None:
        prio_of = alloc_priority
    cand = sort_candidates([a for a in allocs if prio_of(a) < priority],
                           prio_of)
    if not cand:
        return None

    cap = node.resources
    used = [0, 0, 0, 0]
    if node.reserved is not None:
        rv = node.reserved
        used = [rv.cpu, rv.memory_mb, rv.disk_mb, rv.iops]
    for a in allocs:
        sz = alloc_size(a)
        for d in range(4):
            used[d] += sz[d]
    free = (cap.cpu - used[0], cap.memory_mb - used[1],
            cap.disk_mb - used[2], cap.iops - used[3])
    ask_vec = (ask.cpu, ask.memory_mb, ask.disk_mb, ask.iops)
    if all(ask_vec[d] <= free[d] for d in range(4)):
        return []  # fits without eviction; nothing to preempt

    chosen = select_eviction_prefix(
        free, ask_vec, [alloc_size(a) for a in cand])
    if chosen is None or not chosen:
        return None
    return [cand[i] for i in chosen]
