"""``python -m nomad_tpu_torch.analysis``: run the static pass.

    python -m nomad_tpu_torch.analysis --check [--list] [--rule NAME]

``--check`` runs every rule family and exits 1 on an unsuppressed
violation (it is the only mode; the flag spells the intent).  ``--list``
also prints the allowlisted findings.  ``--rule`` (repeatable) restricts
the run to ``lock-discipline``, ``guard-coverage`` or
``device-discipline``.  ``--root`` scans
another tree.
"""
from __future__ import annotations

import argparse
import sys

from . import RULE_FAMILIES, repo_root, run_checks


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m nomad_tpu_torch.analysis")
    parser.add_argument("--check", action="store_true", default=False)
    parser.add_argument("--list", action="store_true", default=False)
    parser.add_argument("--rule", action="append", default=None,
                        choices=list(RULE_FAMILIES))
    parser.add_argument("--root", default=None)
    args = parser.parse_args(argv)

    active, suppressed = run_checks(args.root or repo_root(),
                                    rules=args.rule)
    if args.list and suppressed:
        print(f"-- {len(suppressed)} allowlisted finding(s) --")
        for v in suppressed:
            print("  " + v.render().replace("\n", "\n  "))
    if active:
        print(f"-- {len(active)} violation(s) --")
        for v in active:
            print(v.render())
        print(f"\nFAIL: {len(active)} violation(s) ({len(suppressed)} "
              f"allowlisted).  Fix them or add a justified entry to "
              f"nomad_tpu_torch/analysis/allowlist.txt")
        return 1
    print(f"analysis: clean ({len(suppressed)} allowlisted finding(s) "
          f"across the tree)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
