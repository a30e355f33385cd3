#!/usr/bin/env python3
"""Where the torch profiler stops recording device events on one card.

    python3 profiler_gap.py

A probe is one profiled ``torch.zeros`` fill (``chip_smoke.
profiler_probe``): 1 when the session records the fill's kernel, 0 when
it records no device event.  The script prints one JSON line of probes
after each of: the start; one session of 10,000 fills; a 3 s session;
config (b)'s batch 0 traced whole (``chip_smoke.profile_batch``, as
phase ``profile`` does); and the same batch with the networks of
``mock.node()`` and ``mock.job()`` kept, traced whole (as phase
``networks`` does: the offers run on the host inside the session).
Then the card's name and power limit.  Needs a CUDA card.
"""
import json
import sys
import time

import torch

import chip_smoke as c


def probes(label, k=4):
    print(json.dumps({"after": label,
                      "probes": [c.profiler_probe() for _ in range(k)]}),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_gap: CUDA is not available", file=sys.stderr)
        return 2
    from nomad_tpu_torch import device, mock

    device.build_kernels()
    probes("start")
    evs = c.cuda_kernel_events(c.profiled(
        lambda: torch.zeros(1, device="cuda"), 10_000))
    probes(f"a session of 10,000 fills ({len(evs)} recorded)")

    def long_session():
        torch.zeros(1, device="cuda")
        time.sleep(3.0)
        torch.zeros(1, device="cuda")

    c.profiled(long_session)
    probes("a 3 s session")
    nodes = [c.strip_node(mock.node()) for _ in range(10_000)]
    jobs = [c.strip_job(mock.job(), 1000) for _ in range(100)]
    row = c.profile_batch("cuda", nodes, jobs)
    probes(f"config (b) batch 0 traced ({row.get('device_ops')} device "
           f"ops)")
    net_nodes = [mock.node() for _ in range(10_000)]
    net_jobs = [c.net_job(1000) for _ in range(100)]
    t0 = time.perf_counter()
    row = c.profile_batch("cuda", net_nodes, net_jobs)
    probes(f"config (b) batch 0 with networks traced "
           f"({row.get('device_ops')} device ops, "
           f"{time.perf_counter() - t0:.1f} s)", 8)
    print(c.smi_name_power(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
