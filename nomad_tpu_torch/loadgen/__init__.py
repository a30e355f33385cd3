"""Open-loop control-plane load harness (a copy of ``nomad_tpu/loadgen/``).

The control plane bounds what a fleet of users sees: broker, plan and
worker throughput and tail latency.  This package drives the port's
**real** server stack — N simulated clients concurrently submitting
jobs, heartbeating, and following the event stream — under open-loop
arrival rates from scenario specs, through a warmup/measure/drain phase
protocol, and emits a machine-readable report:

- sustained end-to-end evals/s and placed/s (completions during the
  measure window, not one-shot batch numbers — the Gavel discipline of
  measuring throughput under a continuous arrival stream);
- submit→running p50/p95/p99 (job_register → plan applied);
- plan-apply p50/p99, plan conflicts, snapshot reuse;
- broker admission-control counters (rejects/coalesced/shed) and
  event-stream fan-out cost under K filtered subscribers;
- with the continuous profiler armed, ``host_attribution``: where the
  host's CPU went, the contended locks and the GIL delay.

Usage::

    python -m nomad_tpu_torch.loadgen --smoke --device cpu
    python -m nomad_tpu_torch.loadgen --scenario baseline
    python -m nomad_tpu_torch.loadgen --scenario baseline --compare-workers 1,2
    python -m nomad_tpu_torch.loadgen --spec my_scenario.json --out report.json

The harness is in-process (the server's own RPC-facing methods): the
quantities under test are broker/plan/worker throughput and tail
latency, and an in-process driver measures them without socket noise;
the heartbeat, event-stream and admission paths it exercises are the
production code paths.  The server's batch workers run on ``--device``
(default ``cuda``; raises without a card).
"""
from .harness import LoadHarness
from .report import render_report, write_report
from .scenario import BUILTIN_SCENARIOS, JobShape, Scenario

__all__ = ["LoadHarness", "Scenario", "JobShape", "BUILTIN_SCENARIOS",
           "render_report", "write_report"]
