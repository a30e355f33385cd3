"""CLI entry: ``python -m nomad_tpu_torch.loadgen`` (a copy of
``nomad_tpu/loadgen/__main__.py``, with ``--device``).

Prints ONE JSON line to stdout (the machine contract) and a human summary
to stderr.  ``--smoke`` is the fast path; ``--compare-workers 1,4`` runs
the same offered load at each worker count and reports the
sustained-throughput speedup.  ``--device`` (default ``cuda``) is where
the server's batch workers run; ``cpu`` runs the kernels' plain
versions.  The follower child's settings, which the reference reads from
its environment, are arguments (``--device``, ``--follower-sched``,
``--events``, ``--chaos`` for the chaos control endpoints,
``--switch-interval``, ``--raft-*``), and its stack sampler is
``--profile``.  A scenario with more than one region (``multi_region``)
runs through the federated harness.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys

from .harness import compare_workers, run_scenario
from .report import render_report, write_report
from .scenario import BUILTIN_SCENARIOS, get_scenario, load_scenario


def _start_child_sampler() -> None:
    """``--profile``: sample every thread's top frames and dump the
    histogram to stderr at exit — a poor man's py-spy for tuning
    follower-scheduler subprocesses."""
    import atexit
    import collections
    import threading
    import time

    samples: collections.Counter = collections.Counter()

    def sampler():
        me = threading.get_ident()
        while True:
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue
                f, stack = frame, []
                for _ in range(3):
                    if f is None:
                        break
                    stack.append(f"{f.f_code.co_filename.rsplit('/', 1)[-1]}"
                                 f":{f.f_code.co_name}")
                    f = f.f_back
                samples["|".join(stack)] += 1
            time.sleep(0.005)

    threading.Thread(target=sampler, daemon=True).start()
    atexit.register(lambda: print(
        "\n".join(f"{n:6d}  {s}" for s, n in samples.most_common(25)),
        file=sys.stderr, flush=True))


def _follower_child_main(args) -> int:
    """Follower-scheduler server subprocess (spawned by the harness for
    multi-server scenarios): joins the leader, runs FollowerWorkers off
    its replicated FSM, prints ``READY <addr>`` once serving, and parks
    until the parent closes stdin."""
    from ..server import Server, ServerConfig
    from .harness import apply_switch_interval

    apply_switch_interval(args.switch_interval)
    if not args.join:
        print("ERROR --follower-child requires --join", flush=True)
        return 2
    srv = Server(ServerConfig(
        device=args.device,
        node_name=args.name or "lg-follower",
        enable_rpc=True, start_join=[args.join], bootstrap_expect=1,
        num_schedulers=max(0, args.workers), min_heartbeat_ttl=60.0,
        non_voting=args.non_voting,
        follower_scheduling=args.follower_sched,
        events=args.events,
        chaos_endpoints=args.chaos,
        raft_heartbeat=args.raft_heartbeat,
        raft_election_min=args.raft_election_min,
        raft_election_max=args.raft_election_max,
        data_dir=args.data_dir or "",
        rpc_port=int(args.port or 0)),
        logger=logging.getLogger("nomad_tpu_torch.loadgen.follower"))
    # One aggregation window for the whole run, like the harness leader:
    # the parent collects RTT/lag histograms at teardown.
    srv.metrics.sink.interval = 3600.0
    if args.profile:
        _start_child_sampler()
    srv.start()
    print(f"READY {srv.config.rpc_advertise}", flush=True)
    try:
        sys.stdin.read()  # EOF = parent teardown
    except (OSError, KeyboardInterrupt):
        pass
    srv.shutdown()
    return 0


def main(argv=None) -> int:
    from ..server import ServerConfig

    defaults = ServerConfig()
    p = argparse.ArgumentParser(
        prog="python -m nomad_tpu_torch.loadgen",
        description="open-loop control-plane load harness")
    p.add_argument("--scenario", default="",
                   help="builtin scenario: "
                        + ", ".join(sorted(BUILTIN_SCENARIOS)))
    p.add_argument("--spec", default="",
                   help="path to a scenario spec JSON file")
    p.add_argument("--smoke", action="store_true",
                   help="alias for --scenario smoke")
    p.add_argument("--device", default="cuda",
                   help="where the server's batch workers run: cuda (the "
                        "kernels; raises without a card) or cpu")
    p.add_argument("--workers", type=int, default=0,
                   help="override scenario num_workers")
    p.add_argument("--compare-workers", default="",
                   help="comma list, e.g. 1,4: run per worker count and "
                        "report the speedup")
    p.add_argument("--wal", action="store_true",
                   help="durable raft log (FileLog + native group-commit "
                        "WAL): plan applies pay real fsyncs")
    p.add_argument("--compare-wal", action="store_true",
                   help="run WAL-off then WAL-on and report the "
                        "plan-apply durability cost")
    p.add_argument("--servers", type=int, default=0,
                   help="override scenario num_servers (1 leader + N-1 "
                        "follower-scheduler subprocesses)")
    p.add_argument("--compare-servers", action="store_true",
                   help="run single-server then multi-server on the same "
                        "offered load and report the scale-out speedup")
    # Internal: the follower-scheduler subprocess entry (spawned by the
    # harness; parks on stdin EOF).
    p.add_argument("--follower-child", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--join", default="", help=argparse.SUPPRESS)
    p.add_argument("--name", default="", help=argparse.SUPPRESS)
    p.add_argument("--non-voting", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--follower-sched", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--events", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--chaos", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--switch-interval", type=float, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--raft-heartbeat", type=float,
                   default=defaults.raft_heartbeat, help=argparse.SUPPRESS)
    p.add_argument("--raft-election-min", type=float,
                   default=defaults.raft_election_min,
                   help=argparse.SUPPRESS)
    p.add_argument("--raft-election-max", type=float,
                   default=defaults.raft_election_max,
                   help=argparse.SUPPRESS)
    p.add_argument("--data-dir", default="", help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--profile", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--out", default="", help="write the JSON report here")
    p.add_argument("--trace", action="store_true",
                   help="arm the eval-lifecycle tracing plane (slow-tail "
                        "report entries name Server.trace_for_eval)")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.WARNING,
        stream=sys.stderr)
    if args.follower_child:
        return _follower_child_main(args)
    if args.trace:
        from ..utils import tracing

        tracing.enable()

    if args.smoke:
        sc = get_scenario("smoke")
    elif args.spec:
        sc = load_scenario(args.spec)
    elif args.scenario:
        sc = get_scenario(args.scenario)
    else:
        p.error("one of --scenario, --spec, --smoke is required")
        return 2
    from dataclasses import replace

    if args.workers:
        sc = replace(sc, num_workers=args.workers)
    if args.wal:
        sc = replace(sc, wal=True)
    if args.servers:
        sc = replace(sc, num_servers=args.servers)

    kwargs = {"device": args.device}
    if args.compare_workers:
        counts = [int(x) for x in args.compare_workers.split(",") if x]
        report = compare_workers(sc, counts, **kwargs)
    elif args.compare_wal:
        from .harness import compare_wal

        report = compare_wal(sc, **kwargs)
    elif args.compare_servers:
        from .harness import compare_servers

        report = compare_servers(sc, **kwargs)
    else:
        report = run_scenario(sc, **kwargs)

    render_report(report, sys.stderr)
    if args.out:
        write_report(report, args.out)
    print(json.dumps(report))

    # Exit contract for CI: nonzero only when the run measured nothing.
    if "runs" in report:
        measured = any(r["sustained"]["completed_total"]
                       for r in report["runs"].values())
    else:
        measured = bool(report["sustained"]["completed_total"])
    return 0 if measured else 1


if __name__ == "__main__":
    sys.exit(main())
