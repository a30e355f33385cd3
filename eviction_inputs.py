"""Seeded inputs of the eviction-set pass
(``nomad_tpu_torch.ops.preempt.eviction_sets``) for its parity checks:
the card tests, the CPU tests and ``chip_smoke.py`` hold the kernel
against its plain version on them.  Numpy arrays in the kernel's
argument order ``(free, used, denom, prio, sizes, ask, job_prio)``.
Imports no jax."""
from __future__ import annotations

import numpy as np

from nomad_tpu_torch.scheduler.preempt import PRIORITY_SENTINEL


def random_inputs(n: int, u: int, a: int, seed: int = 0):
    """Seeded kernel inputs ``(free, used, denom, prio, sizes, ask,
    job_prio)`` as numpy arrays at a chosen shape: ``n`` nodes with up to
    ``a`` candidates each (node 0 has ``a``, so ``a`` is the alloc axis),
    in the oracle's order, on nodes filled to within a few hundred MHz
    and MB of capacity (some over it), some with a zero denominator, and
    ``u`` asks at priorities 10-99.  For parity checks at the main
    path's shapes without building a fleet of objects."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, a + 1, n)
    counts[0] = a
    live = np.arange(a)[None, :] < counts[:, None]          # [n, a]
    prio = np.where(live, rng.integers(1, 80, (n, a)), PRIORITY_SENTINEL)
    sizes = np.stack([rng.integers(100, 900, (n, a)),
                      rng.integers(128, 1800, (n, a)),
                      rng.integers(0, 2000, (n, a)),
                      rng.integers(0, 20, (n, a))], axis=-1) * live[..., None]
    # Priority ascending, then largest first: sort_candidates' order.
    order = np.lexsort((-sizes[..., 3], -sizes[..., 2], -sizes[..., 1],
                        -sizes[..., 0], prio), axis=1)
    prio = np.take_along_axis(prio, order, axis=1)
    sizes = np.take_along_axis(sizes, order[..., None], axis=1)
    used = np.array([100, 256, 0, 0], np.int64) + sizes.sum(axis=1)
    # Near full at any ``a``: cpu and memory headroom of -200..399 (a
    # negative free is a node over capacity), disk and iops to spare.
    free = np.stack([rng.integers(-200, 400, n), rng.integers(-200, 400, n),
                     rng.integers(0, 4000, n), rng.integers(0, 40, n)],
                    axis=-1)
    cap = used + free
    denom = (cap[:, :2] - (100, 256)).astype(np.float32)
    denom[rng.random(n) < 0.02, 0] = 0.0
    ask = np.stack([rng.integers(200, 1500, u), rng.integers(200, 2500, u),
                    rng.integers(0, 4000, u), rng.integers(0, 40, u)],
                   axis=-1)
    job_prio = rng.integers(10, 100, u)
    return (free.astype(np.int32), used.astype(np.int32), denom,
            prio.astype(np.int32), sizes.astype(np.int32),
            ask.astype(np.int32), job_prio.astype(np.int32))


def edge_inputs():
    """Edge rows of the pass, as the kernel's numpy inputs ``(free, used,
    denom, prio, sizes, ask, job_prio)``: 10 nodes x 4 candidate slots,
    3 specs (priorities 50, 30 and 100).  Node 0 has no candidate; on
    node 1 the ask fits without an eviction; on node 2 no eviction is
    enough; node 3's free capacity is negative; nodes 4 and 5 have a zero
    denominator (cpu; both); on node 6 a candidate's priority equals the
    first spec's; node 7 needs the reverse trim (a memory hog before the
    cpu hog that suffices); node 8 has a negative size, which breaks the
    monotone prefix (the count of non-fitting prefixes still defines
    k*); node 9 is a padding row."""
    sent = PRIORITY_SENTINEL
    n, a = 10, 4
    cap = np.tile(np.array([4000, 8192, 102400, 150], np.int64), (n, 1))
    cap[9] = 0
    prio = np.full((n, a), sent, np.int32)
    sizes = np.zeros((n, a, 4), np.int32)
    rows = {
        1: [(10, (500, 500, 0, 0))],
        2: [(10, (100, 100, 0, 0)), (20, (200, 100, 0, 0))],
        3: [(10, (900, 1000, 0, 0)), (20, (1200, 2000, 0, 0))],
        4: [(10, (1500, 1000, 0, 0)), (40, (1500, 3000, 0, 0))],
        5: [(20, (3000, 6000, 0, 0))],
        6: [(20, (1000, 2000, 0, 0)), (50, (2500, 2500, 0, 0))],
        7: [(10, (0, 6000, 0, 0)), (20, (2500, 100, 0, 0)),
            (25, (400, 400, 0, 0))],
        8: [(10, (1500, 100, 0, 0)), (15, (-1400, 0, 0, 0)),
            (20, (1600, 100, 0, 0)), (30, (200, 50, 0, 0))],
    }
    for i, cand in rows.items():
        for k, (p, sz) in enumerate(cand):
            prio[i, k] = p
            sizes[i, k] = sz
    used = np.zeros((n, 4), np.int64)
    used[:9] = (100, 256, 0, 0)
    used += sizes.astype(np.int64).sum(axis=1)
    used[0] = (3900, 8000, 100, 10)     # full, nothing to evict
    used[1] = (1000, 1000, 0, 0)        # room for every ask
    used[3] += (1000, 0, 0, 0)          # 900 MHz over capacity
    used[4] = (3900, 4256, 0, 0)
    used[5] = (3100, 6256, 0, 0)
    denom = (cap[:, :2] - (100, 256)).astype(np.float32)
    denom[4, 0] = 0.0
    denom[5] = 0.0
    denom[9] = 1.0
    free = cap - used
    ask = np.array([[2400, 1800, 150, 0], [1000, 512, 0, 0],
                    [3000, 4000, 500, 5]], np.int32)
    job_prio = np.array([50, 30, 100], np.int32)
    return (free.astype(np.int32), used.astype(np.int32), denom, prio,
            sizes, ask, job_prio)
