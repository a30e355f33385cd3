"""Batched eviction sets: the device twin of the preemption oracle
(``scheduler/preempt.py``), ported from the jitted XLA program
``nomad_tpu/ops/preempt.py:eviction_sets``.

For every (spec u, node n) pair at once: WHICH strictly-lower-priority
allocations must be evicted for the ask to fit, whether that makes it
fit, how many are evicted, and the post-eviction bin-pack score.  The
candidate order is fixed on the host (``sort_candidates``: priority
ascending, largest resources first, id), so the oracle's sequential
algorithm becomes:

- greedy prefix: an inclusive cumsum over the alloc axis and a count of
  the prefixes that fit give k*, the prefix length, for every pair;
- reverse trim: a walk over the alloc axis from back to front with a
  freed-capacity carry replays the oracle's drop-if-it-still-fits walk.

Everything is integer arithmetic on the same sorted inputs, so the sets
are the oracle's exactly (held by :func:`agreement_check`).

:func:`eviction_sets` is the wrapper: for CPU tensors it computes
:func:`eviction_sets_reference`, the plain PyTorch version; for CUDA
tensors it launches the hand-written kernel ``csrc/eviction_sets.cu`` or
raises.  There is no fallback from one to the other.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..scheduler.preempt import (PRIORITY_SENTINEL, alloc_priority,
                                 alloc_size, find_eviction_set,
                                 sort_candidates)
from ..structs import structs as s
from . import fused_score
from .encode import RES_DIMS, pow2_bucket

# Kernel launches made by eviction_sets (the plain version counts none).
LAUNCHES = 0


def encode_alloc_tensors(
    node_ids: List[str],
    allocs_by_node: Dict[str, List[s.Allocation]],
    prio_of: Callable[[s.Allocation], int],
    n_pad: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, List[List[s.Allocation]]]:
    """Per-node candidate tensors in the oracle's order
    (``sort_candidates``), sentinel-padded:

    - prio [n_pad, A] int32: ``PRIORITY_SENTINEL`` in the padding, which
      is never below a job's priority, so padding never enters a prefix;
    - sizes [n_pad, A, 4] int32;
    - sorted_allocs: per node, its allocs in tensor order (to decode a
      mask back to allocations).

    ``A = pow2_bucket(max allocs on a node, minimum=2)``."""
    n = len(node_ids)
    if n_pad is None:
        n_pad = n
    sorted_allocs: List[List[s.Allocation]] = []
    max_a = 1
    for nid in node_ids:
        cand = sort_candidates(allocs_by_node.get(nid, []), prio_of)
        sorted_allocs.append(cand)
        max_a = max(max_a, len(cand))
    a_pad = pow2_bucket(max_a, minimum=2)

    prio = np.full((n_pad, a_pad), PRIORITY_SENTINEL, dtype=np.int32)
    sizes = np.zeros((n_pad, a_pad, RES_DIMS), dtype=np.int32)
    for i, cand in enumerate(sorted_allocs):
        for a, alloc in enumerate(cand):
            prio[i, a] = prio_of(alloc)
            sizes[i, a] = alloc_size(alloc)
    return prio, sizes, sorted_allocs


def eviction_sets_reference(free, used, denom, prio, sizes, ask, job_prio):
    """Plain PyTorch version, line by line with the reference's
    (``nomad_tpu/ops/preempt.py:83-148``).

    free [N, 4] int32 (capacity - used after the main pass), used [N, 4]
    int32, denom [N, 2] f32, prio [N, A] int32, sizes [N, A, 4] int32,
    ask [U, 4] int32, job_prio [U] int32.  Returns ``(mask [U, N, A]
    bool, feasible [U, N] bool, n_evict [U, N] int32, score [U, N] f32)``.
    ``feasible`` is False both where the ask fits with no eviction (the
    main pass owns that case) and where evicting every lower-priority
    alloc is not enough."""
    n, a = prio.shape
    u = ask.shape[0]
    i32 = torch.int32
    cum = torch.cumsum(sizes, dim=1, dtype=i32)           # [N, A, 4]
    need = ask[:, None, :] - free[None, :, :]             # [U, N, 4]
    # The ask fits after evicting the k-prefix: k = 0 frees nothing, k >= 1
    # frees cum[k-1].  Monotone in k (sizes are non-negative), so the
    # count of prefixes that do not fit is k*.
    fits0 = (need <= 0).all(dim=-1)                       # [U, N]
    fits_k = (need[:, :, None, :] <= cum[None]).all(dim=-1)   # [U, N, A]
    kstar = (a + 1) - (fits0.to(i32) + fits_k.sum(dim=-1, dtype=i32))
    ncand = (prio[None, :, :] < job_prio[:, None, None]).sum(
        dim=-1, dtype=i32)                                # [U, N]
    feasible = (kstar >= 1) & (kstar <= ncand)

    arange_a = torch.arange(a, dtype=i32, device=prio.device)
    m0 = arange_a[None, None, :] < kstar[:, :, None]      # [U, N, A]
    m0 = m0 & feasible[:, :, None]
    # The freed capacity of the prefix: an integer sum, in any order.
    freed = torch.zeros((u, n, RES_DIMS), dtype=i32, device=prio.device)
    for k in range(a):
        freed += m0[:, :, k, None].to(i32) * sizes[None, :, k, :]

    # Reverse trim, from the last alloc to the first.
    drops = torch.zeros_like(m0)
    for idx in range(a - 1, -1, -1):
        in_set = m0[:, :, idx]                            # [U, N]
        size_i = sizes[None, :, idx, :]                   # [1, N, 4]
        drop = in_set & (need <= freed - size_i).all(dim=-1)
        freed = freed - drop[:, :, None].to(i32) * size_i
        drops[:, :, idx] = drop
    mask = m0 & ~drops
    n_evict = mask.sum(dim=-1, dtype=i32)

    # Post-eviction ScoreFit: the usage after evicting the set and placing
    # the ask, summed in int32 before the float conversion, scored as rows
    # by fused_score.score_fit with a zero ask.
    after = (used[None, :, :] - freed + ask[:, None, :]).reshape(u * n, 4)
    denom_rows = denom[None, :, :].expand(u, n, 2).reshape(u * n, 2)
    score = fused_score.score_fit(
        after, torch.zeros(4, dtype=i32, device=prio.device),
        denom_rows).reshape(u, n)
    return mask, feasible, n_evict, score


def eviction_sets(free, used, denom, prio, sizes, ask, job_prio):
    """The eviction-set pass: ``(mask [U, N, A] bool, feasible [U, N]
    bool, n_evict [U, N] int32, score [U, N] f32)`` for the inputs of
    :func:`eviction_sets_reference`, all on one device.  On the CPU the
    plain version; on a card one launch of ``csrc/eviction_sets.cu``."""
    global LAUNCHES
    from .kernels import note_signature

    dev = free.device
    note_signature("eviction_sets", (dev.type, ask.shape[0],
                                     *tuple(prio.shape)))
    if dev.type == "cpu":
        return eviction_sets_reference(free, used, denom, prio, sizes, ask,
                                       job_prio)
    if dev.type != "cuda":
        raise ValueError(f"eviction_sets: unsupported device {dev}")
    if prio.dim() != 2 or ask.dim() != 2:
        raise ValueError("eviction_sets: prio must be [N, A] and ask [U, 4]")
    n, a = prio.shape
    u = ask.shape[0]
    if u > 65535:
        raise ValueError(f"eviction_sets: {u} specs exceed the grid's 65535")
    if a < 1:
        raise ValueError("eviction_sets: the alloc axis is empty")
    check = fused_score._check
    check("eviction_sets", "free", free, torch.int32, (n, 4), dev, 16)
    check("eviction_sets", "used", used, torch.int32, (n, 4), dev, 16)
    check("eviction_sets", "denom", denom, torch.float32, (n, 2), dev, 8)
    check("eviction_sets", "prio", prio, torch.int32, (n, a), dev, 4)
    check("eviction_sets", "sizes", sizes, torch.int32, (n, a, 4), dev, 16)
    check("eviction_sets", "ask", ask, torch.int32, (u, 4), dev, 16)
    check("eviction_sets", "job_prio", job_prio, torch.int32, (u,), dev, 4)
    mask = torch.empty((u, n, a), dtype=torch.uint8, device=dev)
    feasible = torch.empty((u, n), dtype=torch.uint8, device=dev)
    n_evict = torch.empty((u, n), dtype=torch.int32, device=dev)
    score = torch.empty((u, n), dtype=torch.float32, device=dev)
    if u and n:
        fn = fused_score._fn("eviction_sets")
        with torch.cuda.device(dev):   # the launch goes to the tensors' card
            rc = fn(free.data_ptr(), used.data_ptr(), denom.data_ptr(),
                    prio.data_ptr(), sizes.data_ptr(), ask.data_ptr(),
                    job_prio.data_ptr(), u, n, a, mask.data_ptr(),
                    feasible.data_ptr(), n_evict.data_ptr(),
                    score.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"eviction_sets kernel launch failed: cudaError {rc}")
        LAUNCHES += 1
    return (mask.view(torch.bool), feasible.view(torch.bool), n_evict,
            score)


def random_cluster(n_nodes: int, n_specs: int, seed: int = 0):
    """A seeded random preemption problem (``nomad_tpu/ops/preempt.py:151``,
    the same draws): nodes at high utilization with allocs of mixed
    priority and size, and high-priority asks that mostly need an
    eviction to fit.  Returns ``(nodes, allocs_by_node, asks,
    priorities)``."""
    rng = np.random.RandomState(seed)
    nodes: List[s.Node] = []
    allocs_by_node: Dict[str, List[s.Allocation]] = {}
    for i in range(n_nodes):
        node = s.Node(
            id=f"n{i:04d}",
            datacenter="dc1",
            resources=s.Resources(cpu=4000, memory_mb=8192,
                                  disk_mb=100 * 1024, iops=150),
            reserved=s.Resources(cpu=100, memory_mb=256),
            status=s.NODE_STATUS_READY,
        )
        nodes.append(node)
        allocs = []
        for a in range(int(rng.randint(0, 9))):
            job = s.Job(id=f"filler-{i}-{a}",
                        priority=int(rng.randint(1, 80)))
            allocs.append(s.Allocation(
                id=f"a{i:04d}-{a}",
                job_id=job.id,
                job=job,
                node_id=node.id,
                resources=s.Resources(
                    cpu=int(rng.randint(100, 900)),
                    memory_mb=int(rng.randint(128, 1800)),
                    disk_mb=int(rng.randint(0, 2000)),
                    iops=int(rng.randint(0, 20))),
            ))
        allocs_by_node[node.id] = allocs
    asks = [s.Resources(cpu=int(rng.randint(500, 3000)),
                        memory_mb=int(rng.randint(512, 6000)),
                        disk_mb=int(rng.randint(0, 4000)),
                        iops=int(rng.randint(0, 40)))
            for _ in range(n_specs)]
    priorities = [int(rng.randint(10, 100)) for _ in range(n_specs)]
    return nodes, allocs_by_node, asks, priorities


def cluster_inputs(nodes, allocs_by_node, asks, priorities, prio_of=None):
    """The kernel's inputs for a fleet with no placements of its own:
    ``(free, used, denom, prio, sizes, ask, job_prio)`` as numpy arrays
    and the per-node sorted candidates (``agreement_check``'s encoding,
    ``nomad_tpu/ops/preempt.py:201-226``)."""
    if prio_of is None:
        prio_of = alloc_priority
    prio, sizes, sorted_allocs = encode_alloc_tensors(
        [n.id for n in nodes], allocs_by_node, prio_of)
    free = np.zeros((len(nodes), RES_DIMS), dtype=np.int32)
    used = np.zeros((len(nodes), RES_DIMS), dtype=np.int32)
    denom = np.ones((len(nodes), 2), dtype=np.float32)
    for i, node in enumerate(nodes):
        cap = np.array([node.resources.cpu, node.resources.memory_mb,
                        node.resources.disk_mb, node.resources.iops],
                       dtype=np.int64)
        u = np.zeros(RES_DIMS, dtype=np.int64)
        if node.reserved is not None:
            rv = node.reserved
            u += (rv.cpu, rv.memory_mb, rv.disk_mb, rv.iops)
        for a in allocs_by_node.get(node.id, []):
            u += np.array(alloc_size(a), dtype=np.int64)
        free[i] = cap - u
        used[i] = u
        denom[i] = (cap[0] - (node.reserved.cpu if node.reserved else 0),
                    cap[1] - (node.reserved.memory_mb
                              if node.reserved else 0))
    ask = np.array([[r.cpu, r.memory_mb, r.disk_mb, r.iops] for r in asks],
                   dtype=np.int32).reshape(len(asks), RES_DIMS)
    job_prio = np.array(priorities, dtype=np.int32)
    return (free, used, denom, prio, sizes, ask, job_prio), sorted_allocs


def agreement_check(nodes, allocs_by_node, asks, priorities, prio_of=None,
                    device=None) -> Tuple[int, int, List[str]]:
    """The pass on ``device`` (default ``cuda``) against the scalar oracle
    over every (spec, node) pair: ``(pairs checked, mismatches, the first
    few mismatches)``."""
    dev = resolve_device(device)
    if prio_of is None:
        prio_of = alloc_priority
    arrays, sorted_allocs = cluster_inputs(nodes, allocs_by_node, asks,
                                           priorities, prio_of)
    mask, feasible, _n_evict, _score = (
        t.cpu().numpy() for t in eviction_sets(
            *(torch.from_numpy(x).to(dev) for x in arrays)))

    checked = 0
    n_mismatch = 0
    mismatches: List[str] = []
    for u in range(len(asks)):
        for i, node in enumerate(nodes):
            checked += 1
            oracle = find_eviction_set(
                node, allocs_by_node.get(node.id, []), asks[u],
                priorities[u], prio_of)
            kernel_ids = ([sorted_allocs[i][a].id
                           for a in np.nonzero(mask[u, i])[0]]
                          if feasible[u, i] else None)
            oracle_ids = [a.id for a in oracle] if oracle else None
            if kernel_ids != oracle_ids:
                n_mismatch += 1
                if len(mismatches) < 5:
                    mismatches.append(
                        f"spec {u} node {node.id}: kernel={kernel_ids} "
                        f"oracle={oracle_ids}")
    return checked, n_mismatch, mismatches


def selfcheck(n_nodes: int = 64, n_specs: int = 64, seed: int = 0,
              log=print, device=None) -> bool:
    """The eviction sets against the oracle on a seeded random cluster:
    the drill behind ``python -m nomad_tpu_torch.ops --selfcheck``."""
    dev = resolve_device(device)
    nodes, allocs_by_node, asks, priorities = random_cluster(
        n_nodes, n_specs, seed)
    checked, n_mismatch, mismatches = agreement_check(
        nodes, allocs_by_node, asks, priorities, device=dev)
    if n_mismatch:
        log(f"preempt selfcheck: FAIL — {n_mismatch} of {checked} "
            f"pairs disagree on {dev}; first few:")
        for m in mismatches:
            log(f"  {m}")
        return False
    log(f"preempt selfcheck: OK — eviction sets == oracle on all {checked} "
        f"(spec, node) pairs ({n_specs} specs x {n_nodes} nodes) on {dev}")
    return True
