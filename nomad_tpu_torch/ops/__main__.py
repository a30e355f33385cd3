"""``python -m nomad_tpu_torch.ops --selfcheck``: the port's drills.

    python -m nomad_tpu_torch.ops --selfcheck [--device cpu|cuda]
        [--nodes N --specs U --seed S]

The preemption drill (``nomad_tpu/ops/__main__.py:1542-1562``, its first
check): the eviction sets of ``ops/preempt.py`` on ``--device`` (default
``cuda``, which builds and launches the kernel and raises without a card)
against the scalar oracle over every (spec, node) pair of a seeded random
cluster.  Exits 0 when every drill passes, 1 otherwise.  The reference's
other drills (breaker, tracing, residency, columnar, fused, residue,
mesh) wait for their modules' ports.
"""
from __future__ import annotations

import argparse
import sys

from .preempt import selfcheck


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m nomad_tpu_torch.ops")
    parser.add_argument("--selfcheck", action="store_true",
                        help="run the kernel-vs-oracle agreement drills")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernel) or cpu (its plain version)")
    parser.add_argument("--nodes", type=int, default=64)
    parser.add_argument("--specs", type=int, default=64)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not args.selfcheck:
        parser.print_help()
        return 2
    ok = selfcheck(n_nodes=args.nodes, n_specs=args.specs, seed=args.seed,
                   device=args.device)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
