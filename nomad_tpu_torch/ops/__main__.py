"""``python -m nomad_tpu_torch.ops --selfcheck``: the port's drills.

    python -m nomad_tpu_torch.ops --selfcheck [--device cpu|cuda]
        [--nodes N --specs U --seed S]

- The preemption drill (``nomad_tpu/ops/__main__.py:1542-1562``, its
  first check): the eviction sets of ``ops/preempt.py`` on ``--device``
  (default ``cuda``, which builds and launches the kernel and raises
  without a card) against the scalar oracle over every (spec, node) pair
  of a seeded random cluster.
- The columnar drill (``nomad_tpu/ops/__main__.py:333``): batches through
  ``TorchBatchScheduler`` on ``--device`` over a store with its columnar
  mirror and the guards at every read.  The cold build is verified
  bit-identical to the walk, incremental node writes keep parity, an
  injected ``state.columns`` corruption is caught and trips a private
  breaker while the walk's buffers carry that batch (its placements equal
  a clean twin's), and the open breaker routes the next batch through
  the oracle.

Exits 0 when every drill passes, 1 otherwise.  The reference's other
drills (breaker, tracing, residency, fused, residue, mesh) wait for their
modules' ports.
"""
from __future__ import annotations

import argparse
import sys

from .preempt import selfcheck


def _drill_node(i: int):
    from .. import mock

    node = mock.node()
    node.id = node.name = f"drill-node-{i:02d}"
    node.resources.networks = []
    node.reserved.networks = []
    node.compute_class()
    return node


def _drill_job(k: int, count: int = 2):
    from .. import mock

    job = mock.job()
    job.id = job.name = f"drill-job-{k}"
    job.task_groups[0].count = count
    for tg in job.task_groups:
        for t in tg.tasks:
            t.resources.networks = []
    return job


class _DrillWorld:
    """A store with its columnar mirror, a harness and a private breaker;
    every batch of the drill runs in two of them alike (the second clean)
    so placements can be compared."""

    def __init__(self, device, seed: int):
        from ..scheduler.testing import Harness
        from .breaker import KernelCircuitBreaker

        self.h = Harness()
        self.device = device
        self.seed = seed
        self.breaker = KernelCircuitBreaker(threshold=0.9, window=8,
                                            min_checks=1, cooldown=3600.0)
        self.jobs = 0

    def add_node(self, i: int) -> None:
        self.h.state.upsert_node(self.h.next_index(), _drill_node(i))

    def run_batch(self):
        """One register eval of a fresh 2-alloc job: (stats, the job's
        live placements as sorted (name, node))."""
        from ..structs import structs as s
        from .batch_sched import TorchBatchScheduler

        job = _drill_job(self.jobs)
        self.jobs += 1
        self.h.state.upsert_job(self.h.next_index(), job)
        ev = s.Evaluation(
            id=f"drill-eval-{self.jobs}", priority=job.priority,
            type=job.type, triggered_by=s.EVAL_TRIGGER_JOB_REGISTER,
            job_id=job.id, status=s.EVAL_STATUS_PENDING)
        sched = TorchBatchScheduler(
            self.h.logger, self.h.snapshot(), self.h, device=self.device,
            breaker=self.breaker, rng_seed=self.seed,
            columnar_guard_every=1)
        stats = sched.schedule_batch([ev])
        placed = sorted((a.name, a.node_id)
                        for a in self.h.state.allocs_by_job(None, job.id,
                                                            True)
                        if not a.terminal_status())
        return stats, placed


def columnar_drill(seed: int = 0, device=None, log=print) -> bool:
    """The columnar state-store drill (see the module docstring)."""
    from .. import fault
    from ..state import columnar

    def check(cond, msg):
        if not cond:
            log(f"columnar drill: FAIL — {msg}")
        return cond

    columnar.reset_counters()
    epoch0 = columnar.EPOCH
    world, clean = _DrillWorld(device, seed), _DrillWorld(device, seed)
    try:
        for w in (world, clean):
            for i in range(8):
                w.add_node(i)

        # 1. The cold build and the first columnar encode, guard-verified.
        _, p1 = world.run_batch()
        _, c1 = clean.run_batch()
        if not (check(columnar.COLUMNAR_ENCODES >= 1,
                      "the first batch did not take the columnar encode")
                and check(columnar.GUARD_RUNS >= 1
                          and columnar.GUARD_MISMATCHES == 0,
                          "the guard did not verify the cold build")
                and check(len(p1) == 2 and p1 == c1,
                          f"the cold batch placed {p1}, the twin {c1}")):
            return False

        # 2. Incremental writes (a drain flip, a fresh node) re-key the
        # static cache; the columnar re-encode must still equal the walk.
        for w in (world, clean):
            st = w.h.state
            nid = st.nodes(None)[0].id
            st.update_node_drain(w.h.next_index(), nid, True)
            st.update_node_drain(w.h.next_index(), nid, False)
            w.add_node(8)
        guard_before = columnar.GUARD_RUNS
        _, p2 = world.run_batch()
        _, c2 = clean.run_batch()
        if not (check(columnar.GUARD_RUNS > guard_before
                      and columnar.GUARD_MISMATCHES == 0,
                      "the guard did not verify the incremental re-encode")
                and check(len(p2) == 2 and p2 == c2,
                          f"the incremental batch placed {p2}, the twin "
                          f"{c2}")):
            return False

        # 3. An injected column corruption: the guard catches it, feeds
        # the breaker, and the walk's buffers carry the batch.
        for w in (world, clean):
            w.add_node(9)  # a new nodes index: the static encode is cold
        with fault.scenario({"seed": seed, "faults": [
                {"point": "state.columns", "action": "corrupt",
                 "times": 1}]}):
            _, p3 = world.run_batch()
        _, c3 = clean.run_batch()
        if not (check(columnar.GUARD_MISMATCHES == 1,
                      "the guard missed the injected corruption")
                and check(columnar.EPOCH == epoch0 + 1,
                          "the mismatch did not bump the epoch")
                and check(world.breaker.state == "open",
                          f"breaker {world.breaker.state!r}, expected "
                          "open")
                and check(clean.breaker.state == "closed",
                          "the clean twin's breaker left closed")
                and check(len(p3) == 2 and p3 == c3,
                          f"the corrupted batch placed {p3}, the clean "
                          f"twin {c3}")):
            return False

        # 4. The open breaker: the oracle carries the next batch.
        s4, p4 = world.run_batch()
        if not (check(s4.oracle_routed > 0,
                      "the open breaker did not route through the oracle")
                and check(len(p4) == 2, "the oracle's batch did not "
                          "place")):
            return False
    finally:
        columnar.reset_counters()
    log("columnar drill: OK — cold build verified bit-identical to the "
        "walk, incremental writes kept parity, the injected corruption "
        "tripped the breaker with the walk carrying the batch (placements "
        "equal the clean twin's), the oracle carried the next batch "
        f"(device {world.device or 'cuda'})")
    return True


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m nomad_tpu_torch.ops")
    parser.add_argument("--selfcheck", action="store_true",
                        help="run the drills")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (their plain "
                             "versions)")
    parser.add_argument("--nodes", type=int, default=64)
    parser.add_argument("--specs", type=int, default=64)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not args.selfcheck:
        parser.print_help()
        return 2
    ok = selfcheck(n_nodes=args.nodes, n_specs=args.specs, seed=args.seed,
                   device=args.device)
    ok = columnar_drill(seed=args.seed, device=args.device) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
