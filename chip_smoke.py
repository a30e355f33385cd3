#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``nomad_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --against TREE   # time against another checkout

Phases, each printed as one JSON line:

1. device   -- the card's name, count and power limit;
2. build    -- compile every ``nomad_tpu_torch/csrc/*.cu`` with nvcc, one
               process per source, all started together (ptxas report
               included);
3. parity   -- the scored_rows kernel against its plain PyTorch version
               on the card, at the main paths' shapes (the mesh's with
               shard node offsets), on edge rows and at the score tile's
               edges (N % 4 != 0, U no multiple of a row tile, misaligned
               row views, with_base=False against True): 0 differing bits;
4. masked_parity -- the masked_score_matrix kernel against its plain
               version (0 differing bits), at the same edges, and against
               scored_rows' base where the spec fits (one shared ScoreFit:
               0 differing bits);
5. config_b -- the single-card path at BASELINE.json config (b) width:
               10,000 nodes, 100 jobs x 1000 asks, then two follow-up
               batches against the live placements, through
               ``schedule_batch``;
6. cpu_vs_card -- a 2,048-node problem on the card and on the CPU: the
               placements must be identical;
7. networks -- config (b) with the networks of ``mock.node()`` and
               ``mock.job()`` kept (eth0 at 1000 Mbit/s, port 22
               reserved; 50 Mbit/s and two dynamic ports an ask), then
               two follow-up batches against the live placements and
               their offers: no node over capacity or bandwidth, no port
               used twice on a node, every dynamic port in [20000,
               60000), one ``scored_rows`` launch per committing step;
               the warm device pass and device ops per committing step
               beside the same batch with networks stripped;
8. distinct_property -- config (c) width: 5,000 nodes with ``meta.rack``
               (500 values), 50 ``mock.job()`` x 1000 with networks, ten
               with a group-level distinct_property on the rack, all with
               a version and a regexp constraint (host-evaluated rows);
               the extra host reads of the distinct_property steps;
9. net_dp_vs_cpu_mesh -- a 2,048-node problem with network asks (one
               with a reserved port) and distinct_property on the card
               and on the CPU, then phase 7's batch 0 and phase 8's batch
               on a 4-shard mesh of the card against the single card:
               identical placements, unplaced counts, AllocMetric scores
               and offers;
10. mesh_scores -- config (b) through a 4-shard and a 3-shard node mesh
               on the card and through the single-card path: identical
               placements, unplaced counts and AllocMetric scores;
11. candidates -- the mesh's candidate scoring at config_mesh width
               (1,000,000 nodes, U = 128, k = 64, 4 shards on the card);
12. mesh    -- config_mesh (bench.py:79-89): 1,000,000 nodes, 100 jobs x
               100,000 asks, through ``schedule_batch`` on a 4-shard mesh
               and on the single-card path: identical placements;
13. columnar -- the columnar state store at half of config_mesh's
               width: the first 500,000 of phase 12's nodes into a port
               ``StateStore`` (its columnar mirror cold-built; cut from
               1,000,000 to keep the whole run inside its time limit),
               config (b)'s 100 x 1,000
               asks, then a node down (a cold static encode) and the
               10 x 200 follow-up, twice (``columnar_guard_every=1``,
               then the default 16), through ``TorchBatchScheduler`` and
               the store-backed ``PlanApplier``; the same waves over a
               ``StateStore(columnar=False)``: the same plans, no guard
               mismatch, no node over capacity, every ask placed, one
               ``scored_rows`` launch per committing step and the kernel
               held at its shapes there; the static encode and the usage
               read timed against their walks, and each wave's encode,
               total and applier seconds by route; then the store with
               the mirror persisted in the v2 snapshot format and
               restored (bytes and seconds): the restored mirror comes
               from the snapshot's column section, its static encode and
               usage read equal the original's (guard walks, 0
               mismatches), and one more config (b) batch over each
               store on the card gives the same plans;
14. evals   -- the eval-driven entry: ``TorchBatchScheduler`` over the
               port's state store and ``Harness``, at config (b) width:
               100 register evals (batch 0), the two follow-ups, and a
               reconciler batch (10 jobs scaled down to half, 10 changed
               destructively), on the card and again on the CPU: every
               plan and eval update identical, batch 0 identical to the
               list entry's placements, no node over capacity, no static
               bytes uploaded by a follow-up, one ``scored_rows`` launch
               per committing step; then the kernel breaker drill (a
               corrupted result rejected, the oracle carrying, a clean
               probe closing it);
15. applied -- plans applied and fed back at config (b) width: the
               port's ``PlanApplier`` as the ``Harness`` planner and the
               resident usage mirror (``ops/resident.py``); batch 0, two
               follow-ups and six more through ``schedule_stream``, on
               the card with the mirror (``guard_every=1``), the card
               without it and the CPU with it: every plan, eval update
               and failure AllocMetric identical; batch 0 committed whole
               by the vectorized re-check on the card (that world's store
               without the columnar mirror); no mismatch of the
               mirror's guards, one install, the card twin equal to the
               host mirror and to a full walk; an over-commit drill (a
               node filled between a batch's snapshot and its submit: a
               partial commit, the retry places the rest) and a
               corruption drill (``ops.resident_state``: the guard trips,
               the breaker hears it, the plans are the clean worlds');
               then the card with the default guard cadence (follow-up
               encode and ``h2d_bytes`` against the card without the
               mirror; the stream against the same batches one by one),
               batch 0 and two follow-ups on a 4-shard mesh of the card
               (its sharded twin; plans equal the single card's) and a
               batch with network asks through the applier's scalar
               check on the card and the CPU (plans and offers equal);
16. preempt -- device preemption: the eviction-set kernel against its
               plain version on the card (edge rows; config_preempt's
               shape and others, A = 2 to 64, and the kernel's tile
               edges: A = 3, 32, 128 and 1,024, U = 1 and 129, N one
               off a tile multiple: 0 differing bits), its ptxas report
               (registers and spills of every instantiation), and
               against the scalar oracle (2,048 nodes x 64 specs: 0
               mismatches); config_preempt (bench.py:716-818: 10,000
               nodes, 70,000 fillers at priorities 10 and 30, 50 jobs x
               1,000 asks at 70) through ``TorchBatchScheduler(
               preemption_enabled=True)`` with the port's ``PlanApplier``
               on the card and the CPU: 10,000 placed by eviction, every
               eviction set equal to the oracle's, no victim at 70 or
               above, no node over capacity, 10 follow-up evals, one
               kernel launch, card plans = CPU plans; a mixed fleet
               (``random_cluster``'s, 2,048 nodes, 64 jobs x 64 asks) on
               the card, the CPU and a 4-shard mesh of the card: mesh =
               single card, card = CPU but where two nodes' effective
               scores, each within 4e-6 of the CPU's, are ordered the
               other way (printed); the kernel's times at U = 50 x
               10,112 x A = 8 and U = 128 x 10,112 x A = 16 over copies
               of its inputs that overflow the L2;
17. server  -- the server path: jobs into the port's in-process
               ``Server`` (``node_register``, ``job_register``), evals
               through its broker and ``BatchWorker`` into
               ``TorchBatchScheduler``, plans through its plan queue and
               ``PlanApplier`` onto the in-memory log, on the card and on
               the CPU.  10,000 ``mock.node()`` nodes; config (d)'s
               system job on every node (first: after config (b) no node
               has its 500 MHz free); config (b)'s 100 jobs x 1000 asks
               and 10 x 200 follow-ups, each wave registered with the
               workers paused, then released (batches of 64); the asks
               that find no room block, and 6,000 more nodes unblock
               them; 10 nodes down and their replacements; a job
               deregistered; then a preempting drill on a second server
               (64 nodes each filled by one priority-10 alloc, 32
               priority-70 asks placed by eviction, the victims'
               follow-up eval handed to ``BlockedEvals`` and placed when
               32 nodes are added).  Card = CPU on every committed alloc
               and eval status; no node over capacity; the breaker
               closed with no trip and no oracle route; no eval nacked or
               failed; one ``scored_rows`` launch per committing spec
               step the batches report, one ``eviction_sets`` launch in
               the drill; each wave's wall time, evals per second and the
               server's telemetry (batch, scheduler, plan queue wait,
               plan evaluate and apply); the servers keep their store's
               columnar mirror, both main servers with every guard at
               every read (``columnar_guard_every=1``: the static, usage
               and plan-fit guards all run), the drills every 16: no
               guard mismatch, and the applier's plans by route
               (columnar, and the guard's vectorized and scalar walks);
18. trace   -- the observability plane on the server path: phase 17's
               fleet (10,000 nodes through ``node_register``) and config
               (b)'s waves (100 x 1000, then 10 x 200, each paused and
               released) through a ``Server(ServerConfig(trace=True,
               events=True))`` on the card with an event subscriber from
               index 0 consumed live on its own thread, then phase 17's
               preempting drill on a second armed server; the same wave on
               the CPU.  Every acked eval's trace holds its whole
               lifecycle (broker enqueue and dequeue, the worker's batch,
               ``batch.schedule`` with every phase span under it, plan
               submit, evaluate and apply, the log apply, the ack and a
               closed ``eval.e2e``), starts in lifecycle order; each
               device batch has one ``batch.fetch`` and a
               ``batch.device`` of its ``BatchStats.device_seconds``
               (within 1 us) and rounds; the stream's indices never
               decrease, one ``PlanApplied`` per applied plan, their
               placements sum to the committed allocs, one
               ``NodeRegistered`` per node, the subscriber never shed;
               one ``scored_rows`` launch per committing step, the
               drill's one ``eviction_sets`` launch in the batch whose
               ``batch.preempt`` span commits it; card = CPU on each
               eval's span names and on the events by content; one traced
               and one untraced batch of the same input in
               ``DeviceTracer`` sessions with the same device-to-host
               copies and synchronizations; then the wave disarmed and
               armed in turns, three each, for evals per second (printed,
               not gated);
19. plan    -- the ``job plan`` dry run at config (b) width: batch 0
               (100 jobs x 1000 asks on 10,000 nodes) through
               ``TorchBatchScheduler`` into a ``Harness``; then 20 of
               those jobs edited (7 with their count raised by 100, 7
               with a task env edit, destructive, 6 with a job-level
               constraint edited, in place) and 5 new jobs, all 25 as
               ``annotate_plan`` evals in one batch over a snapshot
               holding their new versions, on the card and on the CPU:
               the same plans, plan annotations, eval updates and
               failure forensics, no oracle route, one ``scored_rows``
               launch per committing step, the store's allocs untouched;
               each job's ``job_diff`` annotated with its plan's updates
               ("forces create" on Count, "forces create/destroy update"
               on the env edit); then ``Server.job_plan`` of a job's
               edited version on a port ``Server`` (1,000 nodes) on the
               card and on the CPU: the same response, the store
               untouched;
20. fingerprint -- ``GPUFingerprint`` (``fingerprint.gpu.enable``) on
               the card: ``gpu.count``, ``gpu.type`` and ``driver.gpu``
               from ``torch.cuda``, listed by ``fingerprint_node``; the
               three attributes copied onto 2,500 of 10,000 nodes and 10
               jobs x 1000 asks constrained on ``${attr.gpu.type}`` and
               ``${attr.driver.gpu}`` placed through
               ``TorchBatchScheduler`` inside a ``DeviceTracer`` session
               on the card, then on the CPU: every placement on a
               fingerprinted node, no node over capacity, card = CPU
               plans, as many ``scored_rows`` kernel events in the
               session's chrome trace as launches counted, and a second
               ``start()`` during the session refused;
21. durable -- the durable server: phase 17's fleet and config (b)'s
               waves through the port's ``Server`` on a ``FileLog`` (the
               native group-commit WAL, fsync on, in a fresh temporary
               dir) on the card (A), an uninterrupted twin on the
               in-memory log on the card (B), and the CPU server on a
               ``FileLog`` (C), each world in a process of its own under
               one string hash seed.  A and C: the fleet, wave 1 (100 x
               1000) to settled, ``raft.snapshot()``, wave 2 (10 x 200)
               and one node down, wave 3's jobs registered with their
               evals pending, one more entry under a ``wal.fsync`` crash,
               and the process dies (no shutdown, no final snapshot);
               restarted on the same dir: the recovery split (snapshot
               read and restore, replay, leadership), the applied index
               equal to the last acknowledged one, the content equal to
               the pre-crash content, the torn entry absent, the mirror
               from the snapshot's columns; then wave 3 (re-enqueued by
               the leadership restore) and a follow-up (5 x 200): A = B
               = C on committed allocs, eval statuses, blocked stats and
               queued counts; one ``scored_rows`` launch per committing
               step; one full re-encode of the resident mirror after the
               restore, then hits; no guard mismatch, no nack, the
               breaker closed, no node over capacity; a restart from the
               snapshot alone equal again.  ``raft.apply`` mean and p99
               on the file log against the in-memory log, fsyncs per
               apply, wave 1's evals per second, snapshot bytes, each
               with the data dir's filesystem type;
22. cluster -- the replicated cluster: three port servers over loopback
               TCP (RPC over the struct codec, serf-lite membership,
               ``MultiRaft``, forwarding), each world in a process of its
               own under one string hash seed and one guard cadence
               (every read).  Leg 1, exact: phase 17's fleet (every fifth
               node registered through a follower, forwarded), config
               (b)'s wave 1 (100 x 1000), every worker paused and wave 2
               (10 x 200) registered through a follower, the leader shut
               down (its broker first), a new leader elected whose
               restore re-enqueues wave 2, the workers released, a node
               down, a follow-up (10 x 200); on the card (A), on the CPU
               (C), and on one card server on the in-memory log (B, no
               failover).  A = C on allocs, eval statuses, blocked stats
               and queued counts after each step; A against B printed
               where it differs; every survivor's fingerprint equal; the
               new leader's applied index at least the last acknowledged;
               one ``scored_rows`` launch per committing step on the old
               leader and on the new one; one full re-encode of the
               resident mirror more than B's after the failover; no guard
               mismatch, no nack, the breaker closed, no node over
               capacity; node registration seconds and ``raft.apply``
               mean and p99 through ``MultiRaft`` against B's, the kill
               to a new leader and to wave 2 settled, wave 1's evals per
               second, the forwarded writes.  Leg 2, invariants:
               follower-read scheduling (the leader's batch worker on
               the card, the followers' on the CPU schedulers), 2,000
               nodes and 200 jobs x 20 asks, the leader killed mid-drain
               at a seeded point: every eval complete, each job exactly
               its count of distinct allocs, no node over capacity, the
               survivors' fingerprints equal, plans forwarded by the
               followers and none by the leader's own channel, launches =
               committing steps on each leader; the lag handbacks and
               the ``follower.snapshot_lag`` samples;
23. lifecycle -- the job lifecycle: periodic and parameterized batch
               jobs in tenant namespaces through a port ``Server`` on the
               in-memory log (every columnar guard at every read, the
               resident mirror's guard every batch, both observability
               planes armed), on the card and on the CPU, each world in a
               process of its own under one string hash seed: phase 17's
               10,000 ``mock.node()`` nodes; namespaces ``prod`` (weight
               2) and ``batch`` (weight 1, 25,000 live allocs), DRF; wave
               1 with the workers paused: ``prod``'s 30 service jobs x
               1000, ten periodic parents x 1000 (a test spec ten days
               out) each launched by ``periodic_force``, a parameterized
               parent x 1000 dispatched ten times, then dispatched until
               the quota refuses (five admitted, the sixth refused with
               ``BrokerLimitError`` naming ``batch``, nothing of it
               committed); every child's allocs completed through
               ``node_update_allocs``, 1000 a call; ``system_gc``: one
               force-gc core eval through the leader's worker purges the
               children's evals, allocs and jobs (one ``EvalDeleted`` an
               eval), ``prod`` and the parents stay; wave 2: every
               periodic parent launched again and five dispatches; then a
               parent on a test spec 3 s out, launched once by the
               dispatcher's timer (its launch row written, its child
               placed).  Card = CPU on allocs, eval and job statuses, the
               job summaries with their children counts, the launch rows,
               the usage fold, the refusals, the dequeue counts per tenant
               and what GC deleted (children keyed by parent and
               ordinal); 0 guard mismatches before and after the GC; no
               node over capacity; the breaker closed, no oracle route, no
               nack, no failed eval; one ``scored_rows`` launch per
               committing step in each wave and none of
               ``eviction_sets``; each wave's evals per second, the GC's
               seconds, the tenants' dequeues and the force and dispatch
               latencies;
24. times   -- each kernel's device time (profiler trace; CUDA events
               where the trace has none) over copies of its inputs that
               overflow the L2 (``rotating``: twice the L2 of input bytes
               a cycle), its plain version's, the bound for the same work
               on this card and the share of it reached (none where the
               time reads above the bound); scored_rows also without base
               (the mesh's call at config_mesh); the launch floor (a
               one-element fill); the kernels' SASS instruction counts and the
               issue-rate time they give;
25. profile -- config (b)'s first batch again, warm, on the single card
               and on a 4-shard mesh: untraced, and under a device-only
               trace for the device busy time and idle share.

Each path is driven with the kernels' launch counts set to 0 just before
it and read just after; a path that should launch a kernel and did not
fails.

Then the kernel table, the card's name and power limit, and the last
line ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, if CUDA is absent, the package is missing or any phase fails.
Imports nothing of JAX.

``--against TREE`` runs only the device and build phases and then
``against``: every timed row of ``times`` and ``preempt`` with the
kernels of the checkout at TREE (built with this tree's flags; their C
interface must be this tree's) and with this tree's, on the same inputs,
in turns (that tree, this, this, that, twice).  It prints the rows and
the card's name and power limit, not the result line.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import math
import os
import random
import re
import statistics
import subprocess
import sys
import threading
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20260
MESH_SEED = 20260804           # config_mesh's pinned seed (bench.py:88)
MESH_NODES = 1_000_000
MESH_JOBS = 100
MESH_COUNT = 100_000
MESH_SHARDS = 4

# Kernel-vs-plain tolerance: 2 ulp of float32 at 18, the top of ScoreFit.
ATOL = 4e-6

# H100 SXM published peaks (NVIDIA data sheet), at a 700 W limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
L2_BYTES = 50 * 2**20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_name_power() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else f"nvidia-smi: {out.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"


def time_ms(fn, n: int = 100, warmup: int = 10) -> float:
    """Median of ``n`` single launches, each between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# -- phase 3: kernel parity --------------------------------------------------

def score_inputs(u: int, n: int, seed: int, dev, distinct_asks=False):
    """Inputs of the score kernel at the main path's layout, with edge
    rows: padding columns (zero capacity, infeasible), full nodes,
    denom == 0, and nonzero collisions.  ``distinct_asks``: no two rows
    ask for the same CPU or memory."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n_real = n - 112 if n > 256 else n
    cap = np.zeros((n, 4), np.int32)
    cap[:n_real] = (4000, 8192, 102400, 150)
    used = np.zeros((n, 4), np.int32)
    used[:n_real, 0] = 100 + 500 * rng.integers(0, 8, n_real)
    used[:n_real, 1] = 256 + 256 * rng.integers(0, 8, n_real)
    used[:n_real, 2] = 4096
    full = rng.random(n_real) < 0.05
    used[:n_real][full] = cap[:n_real][full]
    denom = np.ones((n, 2), np.float32)
    denom[:n_real] = (cap[:n_real, :2] - (100, 256)).astype(np.float32)
    zero = rng.random(n_real) < 0.02
    denom[:n_real][zero, 0] = 0.0
    feas = rng.random((u, n)) < 0.9
    feas[:, n_real:] = False
    ask = np.tile(np.array([500, 256, 150, 0], np.int32), (u, 1))
    ask[:, 0] = rng.choice([100, 250, 500], u)
    if distinct_asks:
        ask[:, 0] = 100 + 7 * np.arange(u)
        ask[:, 1] = 64 + 3 * np.arange(u)
    penalty = rng.choice([10.0, 20.0], u).astype(np.float32)
    penalty[::3] = rng.uniform(0.0, 25.0, len(penalty[::3]))
    coll = (rng.random((u, n)) < 0.1).astype(np.int32) * rng.integers(
        1, 4, (u, n)).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (t(feas), t(used), t(cap), t(denom), t(ask), t(penalty), t(coll))


def bit_diff(a, b) -> int:
    import torch

    return int((a.contiguous().view(torch.int32)
                != b.contiguous().view(torch.int32)).sum())


def scored_row(got, got_base, want, want_base, cpu, cpu_base, **shape):
    """One scored_rows check: identical mask and 0 differing bits against
    the plain version on the card (``cpu`` None: no CPU comparison)."""
    import torch

    mask_same = bool(torch.equal(got == -1e30, want == -1e30))
    live = want != -1e30
    d = float((got - want)[live].abs().max()) if live.any() else 0.0
    row = {**shape, "mask_identical": mask_same, "max_abs_err": d,
           "score_bits_differ": bit_diff(got, want), "cells": got.numel()}
    if got_base is not None:
        row.update(base_max_abs_err=float((got_base - want_base).abs().max()),
                   base_bits_differ=bit_diff(got_base, want_base))
    if cpu is not None:
        row.update(
            vs_cpu_plain_max_abs_err=float(
                (got.cpu() - cpu)[live.cpu()].abs().max()),
            vs_cpu_plain_score_bits_differ=bit_diff(got.cpu(), cpu),
            vs_cpu_plain_base_bits_differ=bit_diff(got_base.cpu(), cpu_base))
    if (not mask_same or d > ATOL or row["score_bits_differ"]
            or row.get("base_bits_differ")):
        raise AssertionError(f"scored_rows disagrees with its plain "
                             f"version: {row}")
    return row


# (u, n, u_offset, n_offset).  (1, 250_016, ...) are the mesh's per-shard
# calls on config_mesh: one spec row over one 250,016-node shard, keyed on
# the global node index of shards 1 and 3.  From (1, 701, ...) on, the
# score tile's edges: N % 4 != 0 (the scalar path), U = 1, 7, 9, 129 (no
# multiple of a row tile), config (b)'s 4-shard offsets and U = 9 over a
# config_mesh shard.  Then phase preempt's mixed fleet: one spec row over
# its 2,048-node axis on one card, and over the 512-node shards 1-3 of its
# 4-shard mesh.  The last two are phase server's: one spec row over the
# 16,000-node fleet after the unblock wave, and over the drill's fleet,
# padded to 128 nodes.
SCORE_PARITY_CASES = (
    (1, 10112, 0, 0), (1, 10112, 37, 0), (1, 10112, 127, 0),
    (128, 10112, 0, 0), (3, 700, 5, 0),
    (1, 250_016, 41, 250_016), (1, 250_016, 99, 750_048),
    (1, 701, 0, 0), (9, 701, 3, 0), (7, 10112, 0, 0),
    (9, 10112, 5, 0), (129, 10112, 0, 0), (9, 2528, 11, 7584),
    (9, 250_016, 2, 500_032),
    (1, 2048, 13, 0), (1, 512, 29, 512), (1, 512, 47, 1024),
    (1, 512, 63, 1536),
    (1, 16_000, 71, 0), (1, 128, 5, 0))


def score_parity_rows(dev, cases):
    """scored_rows against its plain version on the card and on the CPU,
    with and without ``base``, at each (u, n, u_offset, n_offset) of
    ``cases``: 0 differing bits.  Returns the rows and the largest
    difference."""
    import torch

    from nomad_tpu_torch.ops import fused_score, kernels

    seed = kernels.jitter_seed(SEED)
    rows = []
    worst = 0.0
    for u, n, u_off, n_off in cases:
        args = score_inputs(u, n, SEED + u + u_off + n_off, dev)
        got, got_base = fused_score.scored_rows(*args, seed, u_offset=u_off,
                                                n_offset=n_off)
        want, want_base = fused_score.scored_rows_reference(
            *args, seed, u_offset=u_off, n_offset=n_off)
        cpu, cpu_base = fused_score.scored_rows_reference(
            *[a.cpu() for a in args], seed, u_offset=u_off, n_offset=n_off)
        no_base, none = fused_score.scored_rows(
            *args, seed, u_offset=u_off, n_offset=n_off, with_base=False)
        torch.cuda.synchronize()
        row = scored_row(got, got_base, want, want_base, cpu, cpu_base, u=u,
                         n=n, u_offset=u_off, n_offset=n_off)
        row["without_base_bits_differ"] = bit_diff(no_base, got)
        rows.append(row)
        worst = max(worst, row["max_abs_err"], row["base_max_abs_err"])
        if none is not None or row["without_base_bits_differ"]:
            raise AssertionError(f"scored_rows with_base=False differs: "
                                 f"{row}")
    return rows, worst


def phase_parity(dev):
    import torch

    from nomad_tpu_torch.ops import fused_score, kernels

    seed = kernels.jitter_seed(SEED)
    rows, worst = score_parity_rows(dev, SCORE_PARITY_CASES)
    # The loop's call: one row of a [U, N] tensor, u·N bytes into feas.
    # N = 10,113 misaligns the rows; a storage offset of 1 misaligns every
    # row of a 70,000-node tensor that would otherwise take the vector
    # path.
    for u, n, shift in ((9, 10113, 0), (3, 70_000, 1)):
        args = score_inputs(u, n, SEED + n, dev)
        feas = args[0].view(torch.uint8)
        if shift:
            buf = torch.zeros(u * n + shift, dtype=torch.uint8, device=dev)
            buf[shift:] = feas.reshape(-1)
            feas = buf[shift:].view(u, n)
        for r in range(u):
            view = [feas[r:r + 1], *args[1:4], args[4][r:r + 1],
                    args[5][r:r + 1], args[6][r:r + 1]]
            got, got_base = fused_score.scored_rows(*view, seed, u_offset=r)
            want, want_base = fused_score.scored_rows_reference(
                *view, seed, u_offset=r)
            torch.cuda.synchronize()
            row = scored_row(got, got_base, want, want_base, None, None,
                             u=1, n=n, u_offset=r, n_offset=0,
                             row_view_of=[u, n], storage_shift=shift,
                             feas_byte_offset=feas[r:r + 1].data_ptr() % 16)
            rows.append(row)
            worst = max(worst, row["max_abs_err"], row["base_max_abs_err"])
    return {"scored_rows": rows}, worst


def phase_masked_parity(dev):
    """masked_score_matrix against its plain version on the card, at the
    candidate path's shard shape, at U = 1 and on a padded edge case; and
    against scored_rows' ``base`` masked by ``ok`` on the same inputs."""
    import torch

    from nomad_tpu_torch.ops import fused_score

    rows = []
    worst = 0.0
    # After (3, 700): the score tile's edges, as in phase_parity.
    for u, n in ((128, 250_016), (1, 10112), (3, 700), (1, 701), (9, 701),
                 (7, 10112), (129, 10112), (9, 10113), (129, 250_016)):
        feas, used, cap, denom, ask, penalty, coll = score_inputs(
            u, n, SEED + 7 * u, dev)
        got = fused_score.masked_score_matrix(feas, used, cap, denom, ask)
        want = fused_score.masked_score_matrix_reference(feas, used, cap,
                                                         denom, ask)
        scored, base = fused_score.scored_rows(feas, used, cap, denom, ask,
                                               penalty, coll, 1)
        via_base = torch.where(scored != -1e30, base, -1e30)
        torch.cuda.synchronize()
        mask_same = bool(torch.equal(got == -1e30, want == -1e30))
        live = want != -1e30
        d = float((got - want)[live].abs().max()) if live.any() else 0.0
        row = {"u": u, "n": n, "mask_identical": mask_same,
               "max_abs_err": d, "score_bits_differ": bit_diff(got, want),
               "vs_scored_rows_base_bits_differ": bit_diff(got, via_base),
               "cells": u * n, "live_cells": int(live.sum()),
               "padding_columns": int((~feas.any(0)).sum())}
        rows.append(row)
        worst = max(worst, d)
        if (not mask_same or d > ATOL or row["score_bits_differ"]
                or row["vs_scored_rows_base_bits_differ"]):
            raise AssertionError(f"masked_score_matrix disagrees: {row}")
    return {"masked_score_matrix": rows}, worst


# -- phase 4: config (b) -----------------------------------------------------

def strip_node(n):
    n.resources.networks = []
    if n.reserved is not None:
        n.reserved.networks = []
    return n


def strip_job(j, count, cpu=None, mem=None):
    j.task_groups[0].count = count
    for t in j.task_groups[0].tasks:
        t.resources.networks = []
        if cpu is not None:
            t.resources.cpu = cpu
        if mem is not None:
            t.resources.memory_mb = mem
    return j


def capacity_check(nodes, allocs) -> int:
    """Nodes over capacity on any dimension, recomputed from the
    placements (reserved + every live alloc)."""
    use = {n.id: list((n.reserved.as_tuple() if n.reserved else (0,) * 4))
           for n in nodes}
    for a in allocs:
        u = use[a.node_id]
        for d, v in enumerate(a.resources.as_tuple()):
            u[d] += v
    return sum(1 for n in nodes
               if any(x > c for x, c in zip(use[n.id],
                                            n.resources.as_tuple())))


def binpack_aggregate(nodes, allocs):
    """bench.py's order-free bin-pack metric: ScoreFit of every node that
    carries an alloc, from its final alloc usage; (sum, nodes used)."""
    from nomad_tpu_torch.structs.funcs import score_fit
    from nomad_tpu_torch.structs.structs import Resources

    by_id = {n.id: n for n in nodes}
    used = {}
    for a in allocs:
        cpu, mem = used.get(a.node_id, (0, 0))
        used[a.node_id] = (cpu + a.resources.cpu, mem + a.resources.memory_mb)
    total = sum(score_fit(by_id[nid], Resources(cpu=cpu, memory_mb=mem))
                for nid, (cpu, mem) in used.items())
    return total, len(used)


def committing_steps_bounds(res):
    """Bounds on the committing spec steps of a batch, read from its
    result alone.  A spec commits at most once per round and places at
    most one alloc per node per round, so a spec that placed anything
    committed in at least max(per-node allocs) rounds and at most in
    ``rounds``.  With one round the two bounds meet."""
    from collections import Counter

    lo = hi = 0
    for sp in res.placements.values():
        if sp.node_ids:
            lo += max(Counter(sp.node_ids).values())
            hi += res.rounds
    return lo, hi


def check_mesh_launches(res, launches, what):
    """A committing spec step launches ``scored_rows`` once per shard
    (once on the single card): hold the count to D times the bounds of
    :func:`committing_steps_bounds`."""
    d = max(1, res.mesh_shards)
    lo, hi = committing_steps_bounds(res)
    if launches <= 0 or not d * lo <= launches <= d * hi:
        raise AssertionError(f"{what}: scored_rows launched {launches} "
                             f"times, outside {d} x the committing spec "
                             f"steps [{lo}, {hi}] read from the result")
    return [d * lo, d * hi]


def phase_config_b(dev):
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops import batch_sched, fused_score

    nodes = [strip_node(mock.node()) for _ in range(10_000)]
    batches = [[strip_job(mock.job(), 1000) for _ in range(100)]]
    for _ in range(2):
        batches.append([strip_job(mock.job(), 200, cpu=100, mem=128)
                        for _ in range(10)])
    live = []
    out = []
    fused_score.LAUNCHES = 0
    for b, jobs in enumerate(batches):
        before = fused_score.LAUNCHES
        res = batch_sched.schedule_batch(nodes, jobs, live_allocs=live,
                                         rng_seed=SEED + b, device=dev)
        launches = fused_score.LAUNCHES - before
        steps_lo, steps_hi = committing_steps_bounds(res)
        live = live + batch_sched.placed_allocs(res, jobs)
        placed = sum(len(sp.node_ids) for sp in res.placements.values())
        unplaced = sum(sp.unplaced for sp in res.placements.values())
        over = capacity_check(nodes, live)
        agg, used_nodes = binpack_aggregate(nodes, live)
        row = {"batch": b, "jobs": len(jobs),
               "asks": sum(j.task_groups[0].count for j in jobs),
               "placed": placed, "unplaced": unplaced, "rounds": res.rounds,
               "kernel_launches": launches,
               "committing_spec_steps_from_result": [steps_lo, steps_hi],
               "validate_device_outputs": "ok", "nodes_over_capacity": over,
               "binpack_sum": agg, "nodes_used": used_nodes,
               "encode_s": res.timings["encode"],
               "device_s_cuda_events": res.timings["device"],
               "decode_s": res.timings["decode"]}
        out.append(row)
        emit({"phase": "config_b", **row})
        if launches <= 0 or not steps_lo <= launches <= steps_hi:
            raise AssertionError(f"kernel launches {launches} outside the "
                                 f"committing spec steps [{steps_lo}, "
                                 f"{steps_hi}] read from the result")
        if over:
            raise AssertionError(f"{over} nodes over capacity")
        if placed + unplaced != row["asks"]:
            raise AssertionError("placed + unplaced != asks")
    return out, fused_score.LAUNCHES


# -- phase 5: card vs CPU ----------------------------------------------------

def phase_cpu_vs_card(dev):
    import numpy as np

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops import batch_sched

    rng = random.Random(SEED)
    nodes = []
    for _ in range(2048):
        n = strip_node(mock.node())
        n.resources.cpu = rng.choice([2000, 4000, 8000])
        n.resources.memory_mb = rng.choice([4096, 8192, 16384])
        n.compute_class()
        nodes.append(n)
    jobs = [strip_job(mock.job(), 200, cpu=rng.choice([100, 250, 500]),
                      mem=rng.choice([64, 256, 512])) for _ in range(16)]
    results = {}
    for d in (dev, "cpu"):
        results[d] = batch_sched.schedule_batch(nodes, jobs, rng_seed=SEED,
                                                device=d)
    card, cpu = results[dev], results["cpu"]
    same = (card.rounds == cpu.rounds and card.placements.keys()
            == cpu.placements.keys()
            and all(card.placements[k].node_ids == cpu.placements[k].node_ids
                    and card.placements[k].unplaced
                    == cpu.placements[k].unplaced
                    for k in cpu.placements))
    diffs = [float(np.abs(card.placements[k].scores
                          - cpu.placements[k].scores).max())
             for k in cpu.placements if len(cpu.placements[k].scores)
             and same]
    d = max(diffs, default=0.0)
    row = {"nodes": len(nodes), "jobs": len(jobs),
           "placed": sum(len(p.node_ids) for p in cpu.placements.values()),
           "rounds": cpu.rounds, "placements_identical": same,
           "score_max_abs_err": d}
    if not same or d > ATOL:
        raise AssertionError(f"card and CPU disagree: {row}")
    return row


# -- phases 7 to 9: networks, distinct_property, card vs CPU and mesh --------

_NET = {}      # the batches of phases 7 and 8 and their single-card results


def net_job(count, cpu=None, mem=None):
    """A ``mock.job()`` with its network asks kept (50 Mbit/s, dynamic
    ports http and admin)."""
    from nomad_tpu_torch import mock

    j = mock.job()
    j.task_groups[0].count = count
    for t in j.task_groups[0].tasks:
        if cpu is not None:
            t.resources.cpu = cpu
        if mem is not None:
            t.resources.memory_mb = mem
    return j


def network_check(nodes, allocs):
    """(nodes over bandwidth, nodes with a port used twice, dynamic ports
    outside [20000, 60000)): each node's NetworkIndex rebuilt from the
    node and every live alloc on it."""
    from nomad_tpu_torch.structs.network import (MAX_DYNAMIC_PORT,
                                                 MIN_DYNAMIC_PORT,
                                                 NetworkIndex)

    by_node = {}
    bad_dyn = 0
    for a in allocs:
        by_node.setdefault(a.node_id, []).append(a)
        for tr in a.task_resources.values():
            for net in tr.networks[:1]:
                bad_dyn += sum(not MIN_DYNAMIC_PORT <= p.value
                               < MAX_DYNAMIC_PORT for p in net.dynamic_ports)
    by_id = {n.id: n for n in nodes}
    over = collide = 0
    for nid, lst in by_node.items():
        idx = NetworkIndex()
        idx.set_node(by_id[nid])
        collide += bool(idx.add_allocs(lst))
        over += idx.overcommitted()
    return over, collide, bad_dyn


def run_counted(fn):
    """``fn()`` with the launch, committing-step and distinct_property
    read counts set to 0 just before and read just after."""
    from nomad_tpu_torch.ops import fused_score, kernels

    fused_score.LAUNCHES = kernels.COMMIT_STEPS = kernels.DP_HOST_READS = 0
    res = fn()
    return res, {"scored_rows_launches": fused_score.LAUNCHES,
                 "committing_spec_steps": kernels.COMMIT_STEPS,
                 "dp_host_reads": kernels.DP_HOST_READS}


def check_steps(res, counts, what):
    """One ``scored_rows`` launch per committing spec step on the card
    (one per shard on a mesh), and the step count inside the bounds read
    from the result."""
    d = max(1, res.mesh_shards)
    steps = counts["committing_spec_steps"]
    lo, hi = committing_steps_bounds(res)
    if (steps <= 0 or counts["scored_rows_launches"] != d * steps
            or not lo <= steps <= hi):
        raise AssertionError(f"{what}: {counts}, {d} shards, committing "
                             f"steps from the result [{lo}, {hi}]")


def phase_networks(dev):
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops import batch_sched

    nodes = [mock.node() for _ in range(10_000)]
    batches = [[net_job(1000) for _ in range(100)]]
    for _ in range(2):
        batches.append([net_job(200, cpu=100, mem=128) for _ in range(10)])
    live = []
    out = []
    for b, jobs in enumerate(batches):
        ids = [f"net-{b}-{i}" for i in range(len(jobs))]
        res, counts = run_counted(lambda: batch_sched.schedule_batch(
            nodes, jobs, live_allocs=live, rng_seed=SEED + b, device=dev,
            eval_ids=ids))
        check_steps(res, counts, f"networks batch {b}")
        if b == 0:
            _NET["net"] = (nodes, jobs, ids, res)
        live = live + batch_sched.placed_allocs(res, jobs)
        placed = sum(len(sp.node_ids) for sp in res.placements.values())
        unplaced = sum(sp.unplaced for sp in res.placements.values())
        offers = sum(len(sp.networks) for sp in res.placements.values())
        over = capacity_check(nodes, live)
        bw_over, collide, bad_dyn = network_check(nodes, live)
        row = {"batch": b, "jobs": len(jobs),
               "asks": sum(j.task_groups[0].count for j in jobs),
               "placed": placed, "unplaced": unplaced, "offers": offers,
               "rounds": res.rounds, **counts,
               "nodes_over_capacity": over, "nodes_over_bandwidth": bw_over,
               "nodes_with_port_collisions": collide,
               "dynamic_ports_out_of_range": bad_dyn,
               "encode_s": res.timings["encode"],
               "device_s_cuda_events": res.timings["device"],
               "decode_and_offers_s": res.timings["decode"]}
        out.append(row)
        emit({"phase": "networks", **row})
        if over or bw_over or collide or bad_dyn:
            raise AssertionError(f"networks batch {b}: {row}")
        if placed + unplaced != row["asks"] or offers != placed:
            raise AssertionError(f"networks batch {b}: counts {row}")
        if b == 0 and placed != 70_000:
            raise AssertionError(f"networks batch 0 placed {placed}, "
                                 "CPU binds at 7 allocs a node: 70,000")
    stripped_nodes = [strip_node(mock.node()) for _ in range(10_000)]
    stripped_jobs = [strip_job(mock.job(), 1000) for _ in range(100)]
    prof = {"networks": profile_batch(dev, nodes, batches[0]),
            "stripped": profile_batch(dev, stripped_nodes, stripped_jobs)}
    return {"batches": out, "profile_batch0": prof}


def phase_distinct_property(dev):
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops import batch_sched
    from nomad_tpu_torch.structs import structs as s

    nodes = []
    for i in range(5_000):
        n = mock.node()
        n.meta["rack"] = f"rack-{i % 500}"
        n.compute_class()
        nodes.append(n)
    jobs = []
    for i in range(50):
        j = net_job(1000)
        j.constraints += [
            s.Constraint("${attr.nomad.version}", ">= 0.5.0, < 0.7",
                         s.CONSTRAINT_VERSION),
            s.Constraint("${attr.kernel.name}", "^linux$",
                         s.CONSTRAINT_REGEX)]
        if i % 5 == 0:
            j.task_groups[0].constraints = [s.Constraint(
                "${meta.rack}", "", s.CONSTRAINT_DISTINCT_PROPERTY)]
        jobs.append(j)
    ids = [f"dp-{i}" for i in range(len(jobs))]
    res, counts = run_counted(lambda: batch_sched.schedule_batch(
        nodes, jobs, rng_seed=SEED, device=dev, eval_ids=ids))
    check_steps(res, counts, "distinct_property")
    _NET["dp"] = (nodes, jobs, ids, res)
    live = batch_sched.placed_allocs(res, jobs)
    by_id = {n.id: n for n in nodes}
    dp_placed, dp_reuse = [], 0
    for i, j in enumerate(jobs):
        if i % 5 == 0:
            racks = [by_id[nid].meta["rack"]
                     for nid in res.placements[(j.id, "web")].node_ids]
            dp_placed.append(len(racks))
            dp_reuse += len(racks) - len(set(racks))
    placed = sum(len(sp.node_ids) for sp in res.placements.values())
    unplaced = sum(sp.unplaced for sp in res.placements.values())
    over = capacity_check(nodes, live)
    bw_over, collide, bad_dyn = network_check(nodes, live)
    row = {"nodes": len(nodes), "jobs": len(jobs), "asks": 50_000,
           "placed": placed, "unplaced": unplaced, "rounds": res.rounds,
           **counts, "dp_jobs_placed": dp_placed,
           "dp_values_reused": dp_reuse, "nodes_over_capacity": over,
           "nodes_over_bandwidth": bw_over,
           "nodes_with_port_collisions": collide,
           "dynamic_ports_out_of_range": bad_dyn,
           "encode_s": res.timings["encode"],
           "device_s_cuda_events": res.timings["device"],
           "decode_and_offers_s": res.timings["decode"]}
    if (dp_reuse or max(dp_placed) > 500 or over or bw_over or collide
            or bad_dyn or placed + unplaced != 50_000
            or counts["dp_host_reads"] <= 0):
        raise AssertionError(f"distinct_property: {row}")
    return row


def same_offers(a, b) -> bool:
    """Equal offers (device, IP, Mbit/s, every port) alloc by alloc."""
    def key(res):
        return {k: [{t: (o.device, o.ip, o.mbits,
                         [(p.label, p.value) for p in o.reserved_ports],
                         [(p.label, p.value) for p in o.dynamic_ports])
                     for t, o in nets.items()} for nets in sp.networks]
                for k, sp in res.placements.items()}
    return key(a) == key(b)


def phase_net_dp_vs_cpu_mesh(dev):
    import numpy as np

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops import batch_sched
    from nomad_tpu_torch.parallel import make_node_mesh
    from nomad_tpu_torch.structs import structs as s

    rng = random.Random(SEED)
    nodes = []
    for i in range(2048):
        n = mock.node()
        n.resources.cpu = rng.choice([2000, 4000, 8000])
        n.resources.memory_mb = rng.choice([4096, 8192, 16384])
        n.meta["rack"] = f"r{i % 64}"
        n.compute_class()
        nodes.append(n)
    jobs = [net_job(200, cpu=rng.choice([100, 250, 500]),
                    mem=rng.choice([64, 256, 512])) for _ in range(16)]
    for j in jobs[:3]:
        j.task_groups[0].constraints = [s.Constraint(
            "${meta.rack}", "", s.CONSTRAINT_DISTINCT_PROPERTY)]
    jobs[5].task_groups[0].tasks[0].resources.networks[0].reserved_ports = [
        s.Port("metrics", 9100)]
    ids = [f"cmp-{i}" for i in range(len(jobs))]
    results = {}
    for d in (dev, "cpu"):
        results[d] = batch_sched.schedule_batch(
            nodes, jobs, rng_seed=SEED, device=d, eval_ids=ids)
    card, cpu = results[dev], results["cpu"]
    same = (card.placements.keys() == cpu.placements.keys()
            and all(card.placements[k].node_ids == cpu.placements[k].node_ids
                    and card.placements[k].unplaced
                    == cpu.placements[k].unplaced for k in cpu.placements))
    diffs = [float(np.abs(card.placements[k].scores
                          - cpu.placements[k].scores).max())
             for k in cpu.placements if len(cpu.placements[k].scores)
             and same]
    row = {"cpu_vs_card": {
        "nodes": len(nodes), "jobs": len(jobs),
        "placed": sum(len(p.node_ids) for p in cpu.placements.values()),
        "rounds": [card.rounds, cpu.rounds], "placements_identical": same,
        "offers_identical": same_offers(card, cpu),
        "score_max_abs_err": max(diffs, default=0.0)}}
    if (not same or not row["cpu_vs_card"]["offers_identical"]
            or card.rounds != cpu.rounds
            or row["cpu_vs_card"]["score_max_abs_err"] > ATOL):
        raise AssertionError(f"card and CPU disagree: {row}")
    mesh = make_node_mesh([dev] * MESH_SHARDS)
    for name in ("net", "dp"):
        # Phase 7's batch 0 and phase 8's batch ran with rng_seed SEED.
        nodes, jobs, ids, single = _NET[name]
        res, counts = run_counted(lambda: batch_sched.schedule_batch(
            nodes, jobs, rng_seed=SEED, mesh=mesh, eval_ids=ids))
        check_steps(res, counts, f"{name} on the mesh")
        row[f"mesh4_{name}"] = {
            "mesh_shards": res.mesh_shards, "rounds": res.rounds, **counts,
            "identical_to_single": same_batches(res, single),
            "offers_identical": same_offers(res, single),
            "device_s_cuda_events": res.timings["device"]}
        if (res.mesh_shards != MESH_SHARDS
                or not row[f"mesh4_{name}"]["identical_to_single"]
                or not row[f"mesh4_{name}"]["offers_identical"]):
            raise AssertionError(f"{name}: mesh and single card disagree: "
                                 f"{row}")
    _NET.clear()
    return row


# -- phase 10: the mesh at config (b) width, scores included ------------------

def same_batches(a, b, exact_order=True):
    """Placements, unplaced counts and AllocMetric scores of two batch
    results; False on the first difference."""
    import numpy as np

    if a.placements.keys() != b.placements.keys():
        return False
    for k, sp in b.placements.items():
        g = a.placements[k]
        ids_same = (g.node_ids == sp.node_ids if exact_order
                    else sorted(g.node_ids) == sorted(sp.node_ids))
        if not ids_same or g.unplaced != sp.unplaced:
            return False
        if exact_order and not (
                np.array_equal(g.scores.view(np.int32),
                               sp.scores.view(np.int32))
                and g.metric_scores == sp.metric_scores):
            return False
    return True


def phase_mesh_scores(dev):
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops import batch_sched, fused_score
    from nomad_tpu_torch.parallel import make_node_mesh

    nodes = [strip_node(mock.node()) for _ in range(10_000)]
    jobs = [strip_job(mock.job(), 1000) for _ in range(100)]
    single = batch_sched.schedule_batch(nodes, jobs, rng_seed=SEED,
                                        device=dev)
    out = {"single_rounds": single.rounds,
           "placed": sum(len(sp.node_ids)
                         for sp in single.placements.values()),
           "scored_entries": sum(len(sp.metric_scores)
                                 for sp in single.placements.values())}
    for d in (4, 3):
        fused_score.LAUNCHES = 0
        res = batch_sched.schedule_batch(
            nodes, jobs, rng_seed=SEED,
            mesh=make_node_mesh([dev] * d))
        launches = fused_score.LAUNCHES
        same = same_batches(res, single)
        out[f"mesh{d}"] = {"mesh_shards": res.mesh_shards,
                           "rounds": res.rounds,
                           "identical_to_single": same,
                           "scored_rows_launches": launches,
                           "device_s_cuda_events": res.timings["device"]}
        if not same or res.mesh_shards != d:
            raise AssertionError(f"{d}-shard mesh disagrees: {out}")
        out[f"mesh{d}"]["launch_bounds"] = check_mesh_launches(
            res, launches, f"{d}-shard mesh")
    if not out["scored_entries"]:
        raise AssertionError("no AllocMetric scores to compare")
    return out


# -- phases 11 and 12: config_mesh width --------------------------------------

_MESH_FLEET = {}


def mesh_fleet():
    """config_mesh's 1,000,000 mock.node() nodes (networks stripped) and
    its 100 jobs x 100,000 asks, built once for both phases."""
    from nomad_tpu_torch import mock

    if not _MESH_FLEET:
        t0 = time.perf_counter()
        _MESH_FLEET["nodes"] = [strip_node(mock.node())
                                for _ in range(MESH_NODES)]
        _MESH_FLEET["jobs"] = [strip_job(mock.job(), MESH_COUNT)
                               for _ in range(MESH_JOBS)]
        _MESH_FLEET["build_s"] = time.perf_counter() - t0
    return _MESH_FLEET


def phase_candidates(dev):
    """``sharded_candidate_scores`` on 4 shards of the card at config_mesh
    width, held against the plain score at each candidate's node, the
    best feasible node of each spec and the 1-shard top 64."""
    import numpy as np
    import torch

    from nomad_tpu_torch.ops import batch_sched, encode, fused_score, kernels
    from nomad_tpu_torch.parallel import (make_node_mesh,
                                          sharded_candidate_scores)

    fleet = mesh_fleet()
    nodes, jobs = fleet["nodes"], fleet["jobs"]
    t0 = time.perf_counter()
    specs = batch_sched._prepare_specs(jobs, {})
    targets, literals = encode.collect_attr_targets(specs)
    ct = encode.encode_cluster_static(nodes, targets)
    encode.finalize_codebooks(ct, literals)
    st = encode.encode_specs(specs, ct, nodes)
    encode_s = time.perf_counter() - t0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    feas = kernels.feasibility_matrix(
        t(ct.attr_values), t(ct.eligible), t(ct.dc_code),
        t(st.constraint_attr), t(st.constraint_op), t(st.constraint_rhs),
        t(st.dc_mask), t(st.precomp))
    used, cap = t(ct.used.astype(np.int32)), t(ct.capacity.astype(np.int32))
    denom, ask = t(ct.score_denom), t(st.ask.astype(np.int32))
    k = 64

    fused_score.LAUNCHES = fused_score.MASKED_LAUNCHES = 0
    mesh = make_node_mesh([dev] * MESH_SHARDS)
    scores, idx = sharded_candidate_scores(mesh, feas, used, cap, denom, ask,
                                           k=k)
    torch.cuda.synchronize()
    launches = fused_score.MASKED_LAUNCHES
    if launches != MESH_SHARDS:
        raise AssertionError(f"masked_score_matrix launched {launches} "
                             f"times, expected {MESH_SHARDS}")

    plain = fused_score.masked_score_matrix_reference(feas, used, cap, denom,
                                                      ask)
    at_idx = torch.gather(plain, 1, idx.to(torch.int64))
    mask_same = bool(torch.equal(scores == -1e30, at_idx == -1e30))
    live = at_idx != -1e30
    d = float((scores - at_idx)[live].abs().max()) if live.any() else 0.0
    best = kernels.stable_top_k(plain, 1)[1]          # lowest index on ties
    has_best = bool((idx.to(torch.int64) == best).any(1).all())
    one_s, one_i = sharded_candidate_scores(make_node_mesh([dev]),
                                            feas, used, cap, denom, ask, k=k)
    top_s, pos = kernels.stable_top_k(scores, k)
    same_top = bool(torch.equal(torch.gather(idx, 1, pos), one_i)
                    and torch.equal(top_s, one_s))
    row = {"nodes": ct.n_real, "n_pad": ct.n_pad, "u_pad": st.u_pad,
           "shards": MESH_SHARDS, "k": k, "candidates": list(idx.shape),
           "masked_launches": launches, "mask_identical": mask_same,
           "max_abs_err": d, "score_bits_differ": bit_diff(scores, at_idx),
           "best_feasible_in_candidates": has_best,
           "global_top_k_equals_one_shard": same_top,
           "live_candidates": int(live.sum()),
           "fleet_build_s": fleet["build_s"], "encode_s": encode_s}
    if not (mask_same and d <= ATOL and has_best and same_top):
        raise AssertionError(f"mesh candidates disagree: {row}")
    return row, launches, d


def fleet_check(nodes, jobs, res):
    """(nodes over capacity, binpack sum, nodes used) of one batch on an
    empty fleet: reserved plus every placed alloc's ask per node; the
    binpack sum is bench.py's ScoreFit of every node that carries an
    alloc, from its alloc usage.  In numpy, unlike capacity_check and
    binpack_aggregate: config_mesh places 7,000,000 allocs, too many to
    build as Allocation objects."""
    import numpy as np

    from nomad_tpu_torch.scheduler.util import task_group_constraints

    index = {n.id: i for i, n in enumerate(nodes)}
    cap = np.array([n.resources.as_tuple() for n in nodes], np.int64)
    resv = np.array([n.reserved.as_tuple() if n.reserved else (0,) * 4
                     for n in nodes], np.int64)
    alloc = np.zeros_like(cap)
    for job in jobs:
        for tg in job.task_groups:
            sp = res.placements.get((job.id, tg.name))
            if sp is None or not sp.node_ids:
                continue
            at = np.fromiter((index[nid] for nid in sp.node_ids), np.int64,
                             len(sp.node_ids))
            np.add.at(alloc, at,
                      np.array(task_group_constraints(tg).size.as_tuple()))
    over = int(((resv + alloc) > cap).any(1).sum())
    carry = alloc.any(1)
    node_res = (cap - resv)[carry, :2].astype(np.float64)
    free = 1.0 - alloc[carry, :2] / node_res
    score = np.clip(20.0 - (10.0 ** free[:, 0] + 10.0 ** free[:, 1]),
                    0.0, 18.0)
    return over, float(score.sum()), int(carry.sum())


def phase_mesh(dev):
    """config_mesh through ``schedule_batch(mesh=...)`` on 4 shards of the
    card, then through the single-card path: identical placements and
    unplaced counts, no node over capacity, equal binpack aggregates."""
    import torch

    from nomad_tpu_torch.ops import batch_sched, fused_score
    from nomad_tpu_torch.parallel import make_node_mesh

    fleet = mesh_fleet()
    nodes, jobs = fleet["nodes"], fleet["jobs"]
    out = {}
    results = {}
    for name in ("mesh", "single"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fused_score.LAUNCHES = fused_score.MASKED_LAUNCHES = 0
        kw = ({"mesh": make_node_mesh([dev] * MESH_SHARDS)}
              if name == "mesh" else {"device": dev})
        t0 = time.perf_counter()
        res = batch_sched.schedule_batch(nodes, jobs, rng_seed=MESH_SEED,
                                         **kw)
        wall = time.perf_counter() - t0
        launches = fused_score.LAUNCHES
        over, agg, used_nodes = fleet_check(nodes, jobs, res)
        row = {"mesh_shards": res.mesh_shards, "rounds": res.rounds,
               "placed": sum(len(sp.node_ids)
                             for sp in res.placements.values()),
               "unplaced": sum(sp.unplaced for sp in res.placements.values()),
               "scored_rows_launches": launches,
               "masked_launches": fused_score.MASKED_LAUNCHES,
               "nodes_over_capacity": over, "binpack_sum": agg,
               "nodes_used": used_nodes, "encode_s": res.timings["encode"],
               "device_s_cuda_events": res.timings["device"],
               "decode_s": res.timings["decode"], "wall_s": wall,
               "peak_device_bytes": torch.cuda.max_memory_allocated()}
        if name == "mesh":
            row["scored_rows_launches_per_shard"] = launches / MESH_SHARDS
        emit({"phase": "mesh", "path": name, **row})
        out[name] = row
        results[name] = res
        row["launch_bounds"] = check_mesh_launches(res, launches, name)
        if over:
            raise AssertionError(f"{name}: {over} nodes over capacity")
    same = same_batches(results["mesh"], results["single"],
                        exact_order=False)
    out.update({"nodes": MESH_NODES, "jobs": MESH_JOBS,
                "count_per_job": MESH_COUNT,
                "fleet_build_s": fleet["build_s"],
                "placements_identical": same})
    if (not same or out["mesh"]["mesh_shards"] != MESH_SHARDS
            or out["single"]["mesh_shards"] != 0
            or out["mesh"]["binpack_sum"] != out["single"]["binpack_sum"]
            or out["mesh"]["placed"] + out["mesh"]["unplaced"]
            != MESH_JOBS * MESH_COUNT):
        raise AssertionError(f"mesh and single card disagree: {out}")
    return out


# -- phase 13: the columnar state store at config_mesh width ------------------

COLUMNAR_SEED = 20261021
# Phase columnar's fleet: the first half of phase mesh's 1,000,000 nodes
# (the depth the whole run could give up to stay inside its limit).
COLUMNAR_NODES = 500_000


def columnar_over_capacity(store) -> int:
    """Nodes over capacity on any dimension: reserved plus every live
    alloc row, summed in numpy over the store's objects (not its
    mirror)."""
    import numpy as np

    from nomad_tpu_torch.structs.structs import alloc_usage_vec

    nodes = store.nodes(None)
    index = {n.id: i for i, n in enumerate(nodes)}
    cap = np.array([n.resources.as_tuple() for n in nodes], np.int64)
    use = np.array([n.reserved.as_tuple() if n.reserved else (0,) * 4
                    for n in nodes], np.int64)
    rows = [(index[nid], alloc_usage_vec(r))
            for nid, r in store.alloc_rows(None)
            if not r.terminal_status() and nid in index]
    if rows:
        at = np.fromiter((i for i, _ in rows), np.int64, len(rows))
        np.add.at(use, at, np.array([v for _, v in rows], np.int64))
    return int((use > cap).any(1).sum())


def columnar_counters() -> dict:
    from nomad_tpu_torch.state import columnar

    return {k: getattr(columnar, k) for k in (
        "COLUMNAR_ENCODES", "WALK_ENCODES", "REBUILDS", "GUARD_RUNS",
        "GUARD_MISMATCHES", "USAGE_READS", "USAGE_GUARD_RUNS",
        "USAGE_GUARD_MISMATCHES")}


def columnar_world(dev, nodes, waves, smi, *, columnar, flips,
                   shapes=None):
    """``waves`` through ``TorchBatchScheduler`` and a store-backed
    ``PlanApplier`` over one port ``StateStore(columnar=columnar)`` on
    ``dev`` (ids seeded, so the two worlds' plans compare whole).  Before
    wave ``b`` the node ``flips[b]`` (if any) goes down: the nodes index
    moves and the next static encode is cold.  Each wave is ``(name,
    jobs, columnar_guard_every)``, the guard cadence of the scheduler and
    the applier alike.  With ``shapes``, the shapes the waves give the
    kernel wrappers are recorded into it."""
    from nomad_tpu_torch.ops import resident
    from nomad_tpu_torch.ops.batch_sched import TorchBatchScheduler
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.server import PlanApplier
    from nomad_tpu_torch.state import StateStore
    from nomad_tpu_torch.state import columnar as colmod

    resident.invalidate()
    resident.reset_counters()
    colmod.reset_counters()
    store = StateStore(columnar=columnar)
    label = "columnar" if columnar else "walk"
    out = {"label": label, "rows": [], "plans": []}
    with seeded_ids(COLUMNAR_SEED) as ids:
        h = Harness(store)
        t0 = time.perf_counter()
        for n in nodes:
            h.state.upsert_node(h.next_index(), n)
        out["register_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cols = h.state.columns()
        out["cold_build_s"] = (time.perf_counter() - t0
                               if cols is not None else None)
        app = PlanApplier(h.state, device=dev, next_index=h.next_index)
        h.planner = app
        brk = KernelCircuitBreaker()
        for b, (name, jobs, guard) in enumerate(waves):
            if flips.get(b):
                h.state.update_node_status(h.next_index(), flips[b], "down")
            for j in jobs:
                h.state.upsert_job(h.next_index(), j)
            evals = reg_evals(jobs, ids)
            n_plans = len(h.plans)
            app.reset_stats()
            app.columnar_guard_every = guard
            c0 = columnar_counters()
            t0 = time.perf_counter()
            with (kernel_shapes(shapes) if shapes is not None
                  else contextlib.nullcontext()):
                st, counts = run_counted(lambda: TorchBatchScheduler(
                    h.logger, h.snapshot(), h, device=dev,
                    rng_seed=COLUMNAR_SEED + b, breaker=brk,
                    columnar_guard_every=guard).schedule_batch(evals))
            wall = time.perf_counter() - t0
            c1 = columnar_counters()
            stats = app.stats
            row = {"phase": "columnar", "world": label, "wave": name,
                   "columnar_guard_every": guard, "evals": st.num_evals,
                   "asks": st.num_asks, "wall_s": wall,
                   "oracle_routed": st.oracle_routed,
                   **{k: getattr(st, k) for k in (
                       "phase1_seconds", "encode_seconds",
                       "device_seconds", "metrics_seconds",
                       "finalize_seconds", "total_seconds",
                       "resident_hits", "full_reencodes")},
                   "applier": {k: (sorted(v) if isinstance(v, set) else v)
                               for k, v in stats.items()},
                   "counters": {k: c1[k] - c0[k] for k in c1},
                   **counts, "card": smi}
            emit(row)
            out["rows"].append(row)
            out["plans"].append([plan_rows(p) for p in h.plans[n_plans:]])
        out["harness"] = h
        out["breaker"] = {"state": brk.state, "trips": brk.trips}
        t0 = time.perf_counter()
        out["over_capacity"] = columnar_over_capacity(h.state)
        out["over_capacity_check_s"] = time.perf_counter() - t0
    return out


def columnar_reads(dev, h, jobs) -> dict:
    """The columnar world's two readers timed against their walks on one
    snapshot (the host clock, one call each): the static encode
    (``build_cluster_static`` over the mirror against
    ``encode_cluster_static`` + ``finalize_codebooks``) and the live-usage
    read (``_columnar_usage`` against the full alloc-row walk); each pair
    must be bit-identical."""
    import numpy as np

    from nomad_tpu_torch.ops import batch_sched, encode, resident
    from nomad_tpu_torch.ops.batch_sched import TorchBatchScheduler

    snap = h.snapshot()
    nodes = snap.nodes(None)
    targets, literals = encode.collect_attr_targets(
        batch_sched._prepare_specs(jobs, {}))
    t0 = time.perf_counter()
    ct = encode.build_cluster_static(snap, nodes, targets, literals,
                                     guard_every=0)
    col_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = encode.encode_cluster_static(nodes, targets)
    encode.finalize_codebooks(ref, literals)
    walk_s = time.perf_counter() - t0
    bad = encode._static_mismatch(ct, ref)
    if not ct.columnar or bad:
        raise AssertionError(f"columnar static encode: columnar "
                             f"{ct.columnar}, differs in {bad!r}")
    sched = TorchBatchScheduler(h.logger, snap, h, device=dev,
                                columnar_guard_every=0)
    t0 = time.perf_counter()
    used, touched = sched._columnar_usage(ct)
    ucol_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_used, ref_touched = resident._full_usage(
        ct, sched._live_allocs_by_node)
    uwalk_s = time.perf_counter() - t0
    if not np.array_equal(used, ref_used) or touched != ref_touched:
        raise AssertionError("columnar usage read differs from the walk")
    return {"nodes": ct.n_real, "n_pad": ct.n_pad, "attr_targets": targets,
            "live_nodes": len(touched),
            "static_encode_s": {"columnar": col_s, "walk": walk_s},
            "usage_read_s": {"columnar": ucol_s, "walk": uwalk_s}}


def columnar_restore(dev, h, jobs, smi) -> dict:
    """Step 8 of phase ``durable``, on this phase's store (it holds the
    fleet already): ``persist`` in v2 and ``restore``, timed; the static
    encode and the usage read of the restored store equal the original's
    (each through its guard walk); then one config (b) batch of ``jobs``
    on ``dev`` over a snapshot of each store: the same plans."""
    import numpy as np

    from nomad_tpu_torch.ops import batch_sched, encode
    from nomad_tpu_torch.ops.batch_sched import TorchBatchScheduler
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.state import StateStore
    from nomad_tpu_torch.state import columnar as colmod

    store = h.state
    t0 = time.perf_counter()
    blob = store.persist()
    persist_s = time.perf_counter() - t0
    rebuilds = colmod.REBUILDS
    t0 = time.perf_counter()
    restored = StateStore.restore(blob)
    restore_s = time.perf_counter() - t0
    errors = []
    if (restored._columns is None or colmod.REBUILDS != rebuilds
            or restored.store_uid == store.store_uid):
        errors.append("the restored mirror is not the snapshot's columns, "
                      "or the lineage was kept")
    targets, literals = encode.collect_attr_targets(
        batch_sched._prepare_specs(jobs, {}))
    reads, g0 = {}, colmod.GUARD_RUNS
    m0 = (colmod.GUARD_MISMATCHES, colmod.USAGE_GUARD_MISMATCHES)
    for label, st in (("original", store), ("restored", restored)):
        snap = st.snapshot()
        ct = encode.build_cluster_static(snap, snap.nodes(None), targets,
                                         literals, guard_every=1)
        sched = TorchBatchScheduler(h.logger, snap, h, device=dev,
                                    columnar_guard_every=1)
        used, touched = sched._columnar_usage(ct)
        reads[label] = (ct, used, touched)
    (ct_o, used_o, t_o), (ct_r, used_r, t_r) = (reads["original"],
                                                reads["restored"])
    bad = encode._static_mismatch(ct_o, ct_r)
    if not ct_r.columnar or bad:
        errors.append(f"the restored static encode differs in {bad!r}")
    if not np.array_equal(used_o, used_r) or t_o != t_r:
        errors.append("the restored usage read differs")
    guard_runs = colmod.GUARD_RUNS - g0
    if (colmod.GUARD_MISMATCHES, colmod.USAGE_GUARD_MISMATCHES) != m0 \
            or guard_runs < 2:
        errors.append(f"guards: {guard_runs} runs, mismatches "
                      f"{columnar_counters()}")
    plans, rows = {}, {}
    for label, st in (("original", store), ("restored", restored)):
        with seeded_ids(COLUMNAR_SEED + 8) as ids:
            hh = Harness(st.snapshot())
            hh._next_index = st.latest_index() + 1
            for j in jobs:
                hh.state.upsert_job(hh.next_index(), j)
            evals = reg_evals(jobs, ids)
            t0 = time.perf_counter()
            # The default guard cadence: the reads above already held
            # the restored encode and usage read to their walks.
            stats, counts = run_counted(lambda: TorchBatchScheduler(
                hh.logger, hh.state.snapshot(), hh, device=dev,
                rng_seed=COLUMNAR_SEED + 8,
                breaker=KernelCircuitBreaker()).schedule_batch(evals))
            rows[label] = {"wall_s": time.perf_counter() - t0,
                           "oracle_routed": stats.oracle_routed,
                           **{k: getattr(stats, k) for k in (
                               "phase1_seconds", "encode_seconds",
                               "device_seconds", "metrics_seconds",
                               "finalize_seconds", "total_seconds",
                               "full_reencodes", "resident_hits")},
                           **counts}
            plans[label] = [plan_rows(p) for p in hh.plans]
    if plans["original"] != plans["restored"] or not plans["original"]:
        errors.append("the batch over the restored store places otherwise")
    for label, row in rows.items():
        if row["oracle_routed"] or (
                torch_device(dev).type == "cuda"
                and (row["scored_rows_launches"] <= 0
                     or row["scored_rows_launches"]
                     != row["committing_spec_steps"])):
            errors.append(f"{label} batch: {row}")
    if errors:
        raise AssertionError(f"columnar restore: {errors}")
    return {"nodes": len(store.nodes_table), "snapshot_bytes": len(blob),
            "persist_s": persist_s, "restore_s": restore_s,
            "guard_runs": guard_runs, "plans_equal": True,
            "batches": rows, "card": smi}


def phase_columnar(dev, nodes=None, n_jobs=100, count=1000, follow_jobs=10,
                   follow_count=200):
    """The columnar state store over the first ``COLUMNAR_NODES`` of
    phase mesh's fleet: config (b)'s wave of 100 x 1,000 asks (500 MHz / 256
    MB), then, each after one node goes down (a cold static encode), the
    follow-up wave of 10 x 200 twice: with ``columnar_guard_every=1``
    and with the default.  Through ``TorchBatchScheduler`` and the
    store-backed ``PlanApplier`` on the card, over a store with the
    mirror and one without: the same plans, no guard mismatch, no node
    over capacity, one ``scored_rows`` launch per committing step."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops import batch_sched
    from nomad_tpu_torch.state import columnar

    smi = smi_name_power()
    if nodes is None:
        nodes = mesh_fleet()["nodes"][:COLUMNAR_NODES]
    wave0 = [strip_job(mock.job(), count) for _ in range(n_jobs)]
    follow = [[strip_job(mock.job(), follow_count, cpu=100, mem=128)
               for _ in range(follow_jobs)] for _ in range(2)]
    restore_wave = [strip_job(mock.job(), count) for _ in range(n_jobs)]
    for k, j in enumerate(wave0 + follow[0] + follow[1] + restore_wave):
        j.id = j.name = f"col-job-{k:03d}"
    waves = [("config_b", wave0, columnar.GUARD_EVERY),
             ("follow_up_guard1", follow[0], 1),
             ("follow_up_default", follow[1], columnar.GUARD_EVERY)]
    flips = {1: nodes[0].id, 2: nodes[1].id}
    on_card = torch_device(dev).type == "cuda"

    shapes = {"scored_rows": set(), "eviction_sets": set()}
    wc = columnar_world(dev, nodes, waves, smi, columnar=True, flips=flips,
                        shapes=shapes)
    reads = columnar_reads(dev, wc["harness"], follow[1])
    emit({"phase": "columnar", "reads": reads, "card": smi})
    restore = columnar_restore(dev, wc["harness"], restore_wave, smi)
    emit({"phase": "columnar", "restore": restore})
    c_counts = columnar_counters()
    wc.pop("harness")
    batch_sched._CLUSTER_CACHE.clear()
    batch_sched._DEVICE_STATIC_CACHE.clear()
    ww = columnar_world(dev, nodes, waves, smi, columnar=False, flips=flips)
    ww.pop("harness")
    batch_sched._CLUSTER_CACHE.clear()
    batch_sched._DEVICE_STATIC_CACHE.clear()

    errors = []
    for b, (name, jobs, _) in enumerate(waves):
        if wc["plans"][b] != ww["plans"][b]:
            errors.append(f"{name}: the mirror's plans differ from the "
                          "walk's")
    asks = sum(j.task_groups[0].count for _, jobs, _ in waves for j in jobs)
    placed = sum(sum(len(sl[3]) for sl in p[3])
                 + sum(len(v) for v in p[2].values())
                 for plans in wc["plans"] for p in plans)
    if placed != asks:
        errors.append(f"{placed} of {asks} asks placed")
    for w in (wc, ww):
        if w["over_capacity"]:
            errors.append(f"{w['label']}: {w['over_capacity']} nodes over "
                          "capacity")
        if w["breaker"] != {"state": "closed", "trips": 0}:
            errors.append(f"{w['label']}: breaker {w['breaker']}")
        for row in w["rows"]:
            c = row["counters"]
            if (row["oracle_routed"] or c["GUARD_MISMATCHES"]
                    or c["USAGE_GUARD_MISMATCHES"]):
                errors.append(f"{w['label']} {row['wave']}: oracle or "
                              f"guard mismatch {c}")
            if on_card and (row["scored_rows_launches"] <= 0
                            or row["scored_rows_launches"]
                            != row["committing_spec_steps"]):
                errors.append(f"{w['label']} {row['wave']}: launches "
                              f"{row['scored_rows_launches']} for "
                              f"{row['committing_spec_steps']} steps")
    for row in wc["rows"]:
        c, app = row["counters"], row["applier"]
        if (c["COLUMNAR_ENCODES"] != 1 or c["WALK_ENCODES"]
                or app["columnar"] != app["plans"]):
            errors.append(f"mirror {row['wave']}: encodes {c}, applier "
                          f"{app}")
        if row["columnar_guard_every"] == 1 and not (
                c["GUARD_RUNS"] == 1 and c["USAGE_GUARD_RUNS"] >= 1
                and app["columnar_guards"] == app["plans"]):
            errors.append(f"mirror {row['wave']}: guards did not run: "
                          f"{c}, {app}")
    for row in ww["rows"]:
        c, app = row["counters"], row["applier"]
        if c["COLUMNAR_ENCODES"] or c["USAGE_READS"] or app["columnar"]:
            errors.append(f"walk {row['wave']}: the mirror was read: {c}")
    if errors:
        raise AssertionError(f"phase columnar: {errors}")
    # scored_rows against its plain version at every shape the waves gave
    # it: 0 differing bits.
    parity = []
    if on_card:
        parity, _ = score_parity_rows(
            dev, [(u, n, 17, n_off)
                  for u, n, n_off in sorted(shapes["scored_rows"])])

    def per_wave(w, key):
        return {row["wave"]: row[key] for row in w["rows"]}

    def evaluate(w):
        return {row["wave"]: {k: row["applier"][k] for k in (
            "evaluate_seconds", "columnar", "columnar_guards",
            "vectorized", "scalar", "plans", "touched_nodes")}
            for row in w["rows"]}

    return {"nodes": len(nodes), "plans_equal_walk": True,
            "asks_placed": placed, "over_capacity": 0,
            "register_s": {"columnar": wc["register_s"],
                           "walk": ww["register_s"]},
            "cold_build_s": wc["cold_build_s"],
            "reads": reads,
            "encode_seconds": {"columnar": per_wave(wc, "encode_seconds"),
                               "walk": per_wave(ww, "encode_seconds")},
            "total_seconds": {"columnar": per_wave(wc, "total_seconds"),
                              "walk": per_wave(ww, "total_seconds")},
            "applier": {"columnar": evaluate(wc), "walk": evaluate(ww)},
            "guards": {k: c_counts[k] for k in (
                "GUARD_RUNS", "GUARD_MISMATCHES", "USAGE_GUARD_RUNS",
                "USAGE_GUARD_MISMATCHES", "REBUILDS")},
            "scored_rows_launches": sum(r["scored_rows_launches"]
                                        for r in wc["rows"]),
            "kernel_shapes": sorted(shapes["scored_rows"]),
            "shape_parity": parity,
            "restore": restore,
            "card": smi}


# -- phase 14: evaluations through the state store ----------------------------

EVAL_SEED = 20261017


class seeded_ids:
    """While active, the port's id generators draw from
    ``random.Random(seed)``: two runs of the same sequence of batches make
    the same alloc and eval ids, so their plans compare whole."""

    def __init__(self, seed):
        self.rng = random.Random(seed)
        self.draws = 0

    def one(self):
        self.draws += 1
        h = f"{self.rng.getrandbits(128):032x}"
        return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"

    def skip(self, n):
        """Advance past the first ``n`` ids (another process drew them)."""
        for _ in range(n):
            self.one()

    def __enter__(self):
        from nomad_tpu_torch.structs import structs

        self.saved = structs.generate_uuid, structs.generate_uuids
        structs.generate_uuid = self.one
        structs.generate_uuids = lambda n: [self.one() for _ in range(n)]
        return self

    def __exit__(self, *exc):
        from nomad_tpu_torch.structs import structs

        structs.generate_uuid, structs.generate_uuids = self.saved


@contextlib.contextmanager
def seeded_world(seed, nodes, jobs=(), store=None):
    """A fresh Harness over ``store`` (default: a new one, made before the
    ids are seeded, so its lineage is its own) holding ``nodes``, then
    ``jobs``; yields ``(h, ids)`` with the ids seeded from ``seed`` while
    the block runs."""
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.state import StateStore

    store = StateStore() if store is None else store
    with seeded_ids(seed) as ids:
        h = Harness(store)
        for n in nodes:
            h.state.upsert_node(h.next_index(), n)
        for j in jobs:
            h.state.upsert_job(h.next_index(), j)
        yield h, ids


def reg_evals(jobs, ids, trigger="job-register"):
    from nomad_tpu_torch.structs import structs as ps

    return [ps.Evaluation(id=ids.one(), priority=j.priority, type=j.type,
                          triggered_by=trigger, job_id=j.id,
                          status=ps.EVAL_STATUS_PENDING) for j in jobs]


def over_capacity_nodes(h) -> set:
    """Ids of the nodes over capacity on any dimension, from the state
    store's live allocs (reserved + each alloc's usage, combined or per
    task)."""
    import numpy as np

    from nomad_tpu_torch.ops.encode import alloc_usage

    over = set()
    for node in h.state.nodes(None):
        use = np.array(node.reserved.as_tuple() if node.reserved
                       else (0,) * 4, dtype=np.int64)
        for a in h.state.allocs_by_node_terminal(None, node.id, False):
            use = use + alloc_usage(a)
        if (use > np.array(node.resources.as_tuple())).any():
            over.add(node.id)
    return over


def store_over_capacity(h) -> int:
    return len(over_capacity_nodes(h))


def plan_rows(p):
    return (
        p.eval_id,
        {n: [(a.id, a.name, a.desired_status, a.desired_description,
              a.client_status) for a in v] for n, v in p.node_update.items()},
        {n: [(a.id, a.name, a.previous_allocation) for a in v]
         for n, v in p.node_allocation.items()},
        [(sl.proto.task_group, list(sl.ids), list(sl.names),
          list(sl.node_ids), list(sl.prev_ids)) for sl in p.alloc_slabs])


def metric_row(m):
    return (m.nodes_evaluated, m.nodes_filtered, m.nodes_available,
            m.class_filtered, m.constraint_filtered, m.nodes_exhausted,
            m.class_exhausted, m.dimension_exhausted, m.coalesced_failures)


def eval_rows(h):
    return [(e.id, e.status, e.next_eval, e.blocked_eval,
             e.queued_allocations,
             {k: metric_row(m) for k, m in e.failed_tg_allocs.items()})
            for e in h.evals]


def eval_world(dev, nodes, batches, smi, counted):
    """Batch 0, the two follow-ups and the reconciler batch through a
    fresh Harness and ``TorchBatchScheduler`` on ``dev``; ids seeded."""
    from nomad_tpu_torch.ops.batch_sched import TorchBatchScheduler
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker

    # A store of its own lineage, so the resident usage mirror of the
    # card's world never keys as the CPU's.
    with seeded_world(EVAL_SEED, nodes) as (h, ids):
        out = {"stats": [], "plans": [], "store_uid": h.state.store_uid}
        brk = KernelCircuitBreaker()
        for b, (name, jobs, make) in enumerate(batches):
            for j in jobs:
                h.state.upsert_job(h.next_index(), j)
            evals = make(h, ids)
            n_plans = len(h.plans)

            def run():
                return TorchBatchScheduler(
                    h.logger, h.snapshot(), h, device=dev,
                    rng_seed=SEED + b, breaker=brk).schedule_batch(evals)

            if counted:
                st, counts = run_counted(run)
            else:
                st, counts = run(), {}
            row = {"batch": name, "device": str(dev), "evals": len(evals),
                   "asks": st.num_asks, "rounds": st.rounds,
                   "oracle_routed": st.oracle_routed,
                   "h2d_bytes": st.h2d_bytes,
                   "static_h2d_bytes": st.static_h2d_bytes,
                   "fetch_bytes": st.fetch_bytes,
                   **{k: getattr(st, k) for k in (
                       "phase1_seconds", "phase2_seconds", "encode_seconds",
                       "device_seconds", "metrics_seconds",
                       "finalize_seconds", "total_seconds")},
                   **counts, "card": smi}
            out["stats"].append((st, row))
            out["plans"].append([plan_rows(p) for p in h.plans[n_plans:]])
            out.setdefault("evals", []).append(evals)
        out["harness"] = h
    return out


def phase_evals(dev, n_nodes=10_000, n_jobs=100, count=1000):
    """The eval-driven entry at config (b) width, on the card and on the
    CPU, with a list-entry and a breaker check."""
    from nomad_tpu_torch import fault, mock
    from nomad_tpu_torch.ops import batch_sched, fused_score
    from nomad_tpu_torch.ops.batch_sched import TorchBatchScheduler
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.structs import structs as ps

    smi = smi_name_power()
    nodes = [strip_node(mock.node()) for _ in range(n_nodes)]
    jobs0 = [strip_job(mock.job(), count) for _ in range(n_jobs)]
    follow = [[strip_job(mock.job(), count // 5, cpu=100, mem=128)
               for _ in range(10)] for _ in range(2)]
    # The reconciler batch: jobs 0-9 (placed whole in batch 0: specs go in
    # priority order, all 50, stable) scale down to 500, jobs 10-19 change
    # their CPU ask 500 -> 400 (destructive).  New versions made here,
    # once, for both runs.
    scaled = [j.copy() for j in jobs0[:10]]
    for j in scaled:
        j.task_groups[0].count = count // 2
    changed = [j.copy() for j in jobs0[10:20]]
    for j in changed:
        j.task_groups[0].tasks[0].resources.cpu = 400
    batches = [("batch0", jobs0, lambda h, ids: reg_evals(jobs0, ids))]
    for i, jobs in enumerate(follow):
        batches.append((f"follow_up{i + 1}", jobs,
                        lambda h, ids, jobs=jobs: reg_evals(jobs, ids)))
    batches.append(("reconcile", scaled + changed,
                    lambda h, ids: reg_evals(scaled + changed, ids)))

    card = eval_world(dev, nodes, batches, smi, counted=True)
    cpu = eval_world("cpu", nodes, batches, smi, counted=False)
    if card["store_uid"] == cpu["store_uid"]:
        raise AssertionError("the card's and the CPU's stores share a "
                             "lineage")
    rows = []
    for (st, row), (cst, crow) in zip(card["stats"], cpu["stats"]):
        emit({"phase": "evals", **row})
        emit({"phase": "evals", **crow})
        rows.append(row)
    h = card["harness"]

    # Batch 0 against the list entry on the same nodes, jobs, seed and
    # eval ids.
    ev0 = card["evals"][0]
    res = batch_sched.schedule_batch(nodes, jobs0, rng_seed=SEED,
                                     device=dev,
                                     eval_ids=[e.id for e in ev0])
    st0 = card["stats"][0][0]
    job_of = {e.id: e.job_id for e in ev0}
    b0 = {(job_of[p[0]], sl[0]): sorted(sl[3])
          for p in card["plans"][0] for sl in p[3]}
    want = {k: sorted(v.node_ids) for k, v in res.placements.items()
            if v.node_ids}
    if b0 != want or st0.rounds != res.rounds:
        raise AssertionError("batch 0 through the state store differs from "
                             "the list entry's placements")
    updates0 = [e for e in h.evals if e.id in {x.id for x in ev0}]
    complete = sum(e.status == ps.EVAL_STATUS_COMPLETE for e in updates0)
    blocked = sum(bool(e.blocked_eval) for e in updates0)
    placed0 = sum(len(v) for v in b0.values())
    failed0 = [m for e in updates0 for m in e.failed_tg_allocs.values()]
    # Card and CPU: every plan, every eval update, the failed groups'
    # AllocMetrics included, identical batch by batch.
    for b in range(len(batches)):
        if card["plans"][b] != cpu["plans"][b]:
            raise AssertionError(f"{batches[b][0]}: the card's plans differ "
                                 "from the CPU run's")
    if eval_rows(h) != eval_rows(cpu["harness"]):
        raise AssertionError("eval updates differ between card and CPU")
    over = store_over_capacity(h)
    if over:
        raise AssertionError(f"{over} nodes over capacity")
    follow_static = [card["stats"][b][0].static_h2d_bytes for b in (1, 2)]
    follow_dyn_only = all(
        card["stats"][b][0].h2d_bytes > 0 and s_b == 0
        for b, s_b in zip((1, 2), follow_static))
    if not follow_dyn_only:
        raise AssertionError(f"follow-ups uploaded static bytes: "
                             f"{follow_static}")
    for st, row in card["stats"]:
        if st.oracle_routed or not st.device_ran:
            raise AssertionError(f"{row['batch']}: oracle_routed "
                                 f"{st.oracle_routed}, device_ran "
                                 f"{st.device_ran}")
        if (row["scored_rows_launches"] <= 0 or row["scored_rows_launches"]
                != row["committing_spec_steps"]):
            raise AssertionError(f"{row['batch']}: {row}")
    rec = card["plans"][3]
    stops = sum(len(v) for p in rec for v in p[1].values())
    rec_placed = sum(len(sl[1]) for p in rec for sl in p[3])
    with_prev = sum(1 for p in rec for sl in p[3] for x in sl[4] if x)
    inplace = sum(len(v) for p in rec for v in p[2].values())

    # The breaker drill (tests/test_fused.py:396) on the card: 8 nodes,
    # 2 jobs x 2.
    clock = [0.0]
    brk = KernelCircuitBreaker(threshold=0.9, window=8, min_checks=1,
                               cooldown=5.0, clock=lambda: clock[0])
    hb = Harness()
    for _ in range(8):
        hb.state.upsert_node(hb.next_index(), strip_node(mock.node()))
    ids = seeded_ids(EVAL_SEED + 1)

    def drill():
        jobs = [strip_job(mock.job(), 2) for _ in range(2)]
        for j in jobs:
            hb.state.upsert_job(hb.next_index(), j)
        st = TorchBatchScheduler(hb.logger, hb.snapshot(), hb, device=dev,
                                 breaker=brk).schedule_batch(
            reg_evals(jobs, ids))
        placed = all(len([a for a in hb.state.allocs_by_job(None, j.id, True)
                          if not a.terminal_status()]) == 2 for j in jobs)
        return st, placed

    with fault.scenario({"seed": 5, "faults": [
            {"point": "ops.kernel_result", "action": "corrupt",
             "times": 1}]}):
        d1, p1 = drill()
        fired = fault.trace()
    state1 = brk.state
    d2, p2 = drill()
    clock[0] += 6.0
    d3, p3 = drill()
    drill_row = {"fired": fired, "reject": [d1.kernel_rejects,
                                            d1.oracle_routed, p1, state1],
                 "open": [d2.oracle_routed, d2.device_ran, p2],
                 "probe": [d3.oracle_routed, d3.device_ran, p3, brk.state]}
    if not (fired == [("ops.kernel_result", 0, "corrupt")]
            and d1.kernel_rejects == 1 and p1 and state1 == "open"
            and d2.oracle_routed == 2 and not d2.device_ran and p2
            and d3.oracle_routed == 0 and d3.device_ran and p3
            and brk.state == "closed"):
        raise AssertionError(f"breaker drill: {drill_row}")
    batch_sched._CLUSTER_CACHE.clear()
    batch_sched._DEVICE_STATIC_CACHE.clear()
    return {"batch0": {"placed": placed0, "evals_complete": complete,
                       "evals_with_blocked_eval": blocked,
                       "failed_groups": len(failed0),
                       "failed_metric_first": {
                           k: getattr(failed0[0], k) for k in (
                               "nodes_evaluated", "nodes_filtered",
                               "nodes_exhausted", "dimension_exhausted",
                               "class_exhausted", "coalesced_failures")}
                       if failed0 else None,
                       "same_as_list_entry": True,
                       "list_entry_rounds": res.rounds},
            "card_equals_cpu": True, "nodes_over_capacity": over,
            "follow_up_static_h2d_bytes": follow_static,
            "follow_up_h2d_bytes": [card["stats"][b][0].h2d_bytes
                                    for b in (1, 2)],
            "reconcile": {"stops": stops, "placed": rec_placed,
                          "placed_with_previous_allocation": with_prev,
                          "in_place_updates": inplace},
            "breaker_drill": drill_row,
            "eval_path_launches": sum(r["scored_rows_launches"]
                                      for r in rows),
            "card": smi}


# -- phase 15: applied -------------------------------------------------------

APPLIED_SEED = 20261018


class OverCommit:
    """A planner in front of another: before the first plan it forwards,
    it fills the first node that plan places on to its CPU capacity
    (outside the scheduler, between the batch's snapshot and its
    submit)."""

    def __init__(self, h, inner):
        self.h, self.inner = h, inner
        self.node_id = None

    def submit_plan(self, plan):
        from nomad_tpu_torch.structs import structs as ps

        if self.node_id is None and plan.alloc_slabs:
            state = self.h.state
            self.node_id = plan.alloc_slabs[0].node_ids[0]
            node = state.node_by_id(None, self.node_id)
            left = node.resources.cpu - node.reserved.cpu - sum(
                a.resources.cpu for a in state.allocs_by_node_terminal(
                    None, self.node_id, False))
            state.upsert_allocs(self.h.next_index(), [ps.Allocation(
                id="over-commit-drill", job_id="over-commit-drill",
                node_id=self.node_id, task_group="web",
                resources=ps.Resources(cpu=left, memory_mb=16))])
        return self.inner.submit_plan(plan)

    def update_eval(self, ev):
        self.inner.update_eval(ev)

    def create_eval(self, ev):
        self.inner.create_eval(ev)

    def reblock_eval(self, ev):
        self.inner.reblock_eval(ev)


def mirror_check(h, pad_m=128) -> dict:
    """Catch the resident mirror up to the store (as the next batch
    would, without the guard), then hold its device twin against the
    host mirror and the host mirror against a full walk."""
    import numpy as np

    from nomad_tpu_torch.ops import batch_sched, resident
    from nomad_tpu_torch.ops.batch_sched import TorchBatchScheduler

    st = resident._STATE
    if st is None:
        raise AssertionError("no resident mirror")
    snap = h.snapshot()
    base = batch_sched._cluster_static(snap.nodes(None), [], {}, False,
                                       pad_m)
    rows_fn = TorchBatchScheduler(h.logger, snap, h,
                                  device="cpu")._live_allocs_by_node
    resident.acquire(snap, st.key, base, rows_fn, guard_every=0)
    st = resident._STATE
    walk, _ = resident._full_usage(base, rows_fn)
    dev = (resident.device_used_host(st.used_dev)
           if st.used_dev is not None else None)
    out = {"device_twin": None if st.used_dev is None else (
               [str(p.device) for p in st.used_dev]
               if isinstance(st.used_dev, list) else str(st.used_dev.device)),
           "device_eq_host": dev is not None
           and bool(np.array_equal(dev, st.used)),
           "host_eq_walk": bool(np.array_equal(st.used, walk)),
           "alloc_index": st.alloc_index}
    if not (out["device_eq_host"] and out["host_eq_walk"]):
        raise AssertionError(f"mirror check: {out}")
    return out


def applied_world(dev, nodes, batches, smi, label, *, resident=True,
                  guard_every=1, mesh=None, stream=(), drills=(),
                  serial_tail=(), counted=False, check_mirror=False,
                  columnar=True):
    """Batches through a fresh Harness whose planner is the port's
    ``PlanApplier`` on ``dev``: ``batches`` one by one, then ``stream``
    through ``schedule_stream``, then the ``drills`` (``overcommit``,
    ``corrupt``) and ``serial_tail`` one by one.  With
    ``check_mirror``, the mirror's counters and :func:`mirror_check`
    after the stream and again after the drills.  ``columnar`` is the
    store's columnar mirror (off: the applier's walk and vectorized
    re-check).  Ids and seeds as in every other world, so plans compare
    whole."""
    from nomad_tpu_torch import fault
    from nomad_tpu_torch.ops import resident as resmod
    from nomad_tpu_torch.ops.batch_sched import TorchBatchScheduler
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.scheduler import context as pcontext
    from nomad_tpu_torch.server import PlanApplier
    from nomad_tpu_torch.state import StateStore

    resmod.reset_counters()
    # A store of its own lineage (made before the ids are seeded): the
    # resident mirror of one world never keys as another's.
    store = StateStore(columnar=columnar)
    out = {"label": label, "rows": [], "plans": [], "checkpoint": None,
           "store_uid": store.store_uid}
    kw = {"mesh": mesh} if mesh is not None else {"device": dev}
    with seeded_world(APPLIED_SEED, nodes, store=store) as (h, ids):
        app = PlanApplier(h.state, device=dev, next_index=h.next_index)
        h.planner = app
        brk = KernelCircuitBreaker()
        out["harness"], out["breaker"] = h, brk

        def sched(seed):
            return TorchBatchScheduler(
                h.logger, h.snapshot(), h, rng_seed=seed, breaker=brk,
                resident=resident, guard_every=guard_every, **kw)

        def record(name, st, app_stats, counts, plans, wall=None):
            row = {"phase": "applied", "world": label, "batch": name,
                   "evals": st.num_evals, "asks": st.num_asks,
                   "rounds": st.rounds, "oracle_routed": st.oracle_routed,
                   "conflict_retries": st.conflict_retries,
                   "h2d_bytes": st.h2d_bytes,
                   "static_h2d_bytes": st.static_h2d_bytes,
                   "delta_rows": st.delta_rows,
                   "resident_hits": st.resident_hits,
                   "full_reencodes": st.full_reencodes,
                   "delta_apply_seconds": st.delta_apply_seconds,
                   "pipeline_overlap_s": st.pipeline_overlap_s,
                   **{k: getattr(st, k) for k in (
                       "phase1_seconds", "encode_seconds", "device_seconds",
                       "metrics_seconds", "finalize_seconds",
                       "total_seconds")},
                   "applier": {k: (sorted(v) if isinstance(v, set) else v)
                               for k, v in app_stats.items()},
                   **counts, "card": smi}
            if wall is not None:
                row["wall_seconds"] = wall
            out["rows"].append((st, row))
            out["plans"].append([plan_rows(p) for p in plans])
            emit(row)
            return row

        def one(name, jobs, seed, planner=None):
            for j in jobs:
                h.state.upsert_job(h.next_index(), j)
            evals = reg_evals(jobs, ids)
            n_plans = len(h.plans)
            app.reset_stats()
            if planner is not None:
                h.planner = planner
            try:
                if counted:
                    st, counts = run_counted(
                        lambda: sched(seed).schedule_batch(evals))
                else:
                    st, counts = sched(seed).schedule_batch(evals), {}
            finally:
                h.planner = app
            return record(name, st, dict(app.stats), counts,
                          h.plans[n_plans:])

        for b, (name, jobs) in enumerate(batches):
            one(name, jobs, SEED + b)

        if stream:
            for _, jobs in stream:
                for j in jobs:
                    h.state.upsert_job(h.next_index(), j)
            ev_lists = [reg_evals(jobs, ids) for _, jobs in stream]
            s = sched(SEED + 50)
            per_batch = []
            real_complete = s._complete_prepared

            def complete(prep):
                app.reset_stats()
                n0 = len(h.plans)
                st_b = real_complete(prep)
                per_batch.append((dict(app.stats), n0))
                return st_b

            # Each batch's plans are submitted as it completes.
            s._complete_prepared = complete
            t0 = time.perf_counter()
            if counted:
                sts, counts = run_counted(
                    lambda: s.schedule_stream(ev_lists,
                                              state_source=h.snapshot))
            else:
                sts, counts = s.schedule_stream(
                    ev_lists, state_source=h.snapshot), {}
            wall = time.perf_counter() - t0
            ends = [n0 for _, n0 in per_batch[1:]] + [len(h.plans)]
            for (name, _), st_b, (a_st, n0), end in zip(stream, sts,
                                                         per_batch, ends):
                record(name, st_b, a_st, {}, h.plans[n0:end])
            out["stream"] = {"batches": len(sts), "wall_seconds": wall,
                             "sum_total_seconds": sum(x.total_seconds
                                                      for x in sts),
                             "overlap_seconds": [x.pipeline_overlap_s
                                                 for x in sts],
                             **counts}
            emit({"phase": "applied", "world": label, "stream":
                  out["stream"], "card": smi})

        if check_mirror:
            out["checkpoint"] = {
                "counters": {c: getattr(resmod, c) for c in (
                    "HITS", "GUARD_RUNS", "GUARD_MISMATCHES",
                    "DEV_GUARD_MISMATCHES", "DEV_INSTALLS", "DEV_APPLIES",
                    "FULL_REENCODES", "STALENESS_FALLBACKS")},
                "mirror": mirror_check(h)}

        for k, (name, jobs) in enumerate(drills):
            # The oracle's conflict retry draws its node order from here.
            pcontext._SEED_SOURCE = random.Random(APPLIED_SEED + k)
            if name == "overcommit":
                oc = OverCommit(h, app)
                row = one(name, jobs, SEED + 60 + k, planner=oc)
                row["overcommit_node"] = oc.node_id
                out["overcommit"] = row
            elif name == "corrupt":
                mm0 = resmod.GUARD_MISMATCHES
                with fault.scenario({"seed": 3, "faults": [
                        {"point": "ops.resident_state", "action": "corrupt",
                         "times": 1}]}):
                    row = one(name, jobs, SEED + 60 + k)
                    fired = fault.trace()
                out["corrupt"] = {"row": row, "fired": fired,
                                  "guard_mismatches": resmod.GUARD_MISMATCHES
                                  - mm0,
                                  "breaker_agreement": brk.agreement()}
        if drills and check_mirror:
            out["final_mirror"] = mirror_check(h)

        if serial_tail:
            t0 = time.perf_counter()
            for k, (name, jobs) in enumerate(serial_tail):
                one(name, jobs, SEED + 50)
            out["serial_tail_wall_seconds"] = time.perf_counter() - t0
        out["over_capacity"] = store_over_capacity(h)
        out["eval_rows"] = eval_rows(h)
    return out


def net_plan_rows(p):
    """A plan's rows with every placed alloc's offers."""
    return (plan_rows(p), {n: [(a.id, sorted(
        (t, nr.device, nr.ip, nr.mbits,
         tuple((x.label, x.value) for x in nr.reserved_ports),
         tuple((x.label, x.value) for x in nr.dynamic_ports))
        for t, r in a.task_resources.items() for nr in r.networks))
        for a in v] for n, v in p.node_allocation.items()})


def network_world(dev, nodes, jobs, smi):
    """One batch with network asks through the applier: the resident
    mirror is bypassed and every node takes the scalar fit check."""
    from nomad_tpu_torch.ops import resident as resmod
    from nomad_tpu_torch.ops.batch_sched import TorchBatchScheduler
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.server import PlanApplier

    resmod.reset_counters()
    with seeded_world(APPLIED_SEED + 1, nodes) as (h, ids):
        app = PlanApplier(h.state, device=dev, next_index=h.next_index)
        h.planner = app
        for j in jobs:
            h.state.upsert_job(h.next_index(), j)
        st = TorchBatchScheduler(
            h.logger, h.snapshot(), h, device=dev, rng_seed=SEED,
            breaker=KernelCircuitBreaker(), guard_every=1).schedule_batch(
            reg_evals(jobs, ids))
        row = {"phase": "applied", "world": f"network {dev}",
               "batch": "network", "asks": st.num_asks,
               "oracle_routed": st.oracle_routed,
               "resident_hits": st.resident_hits,
               "full_reencodes": st.full_reencodes,
               "mirror_installs": resmod.DEV_INSTALLS,
               "h2d_bytes": st.h2d_bytes,
               **{k: getattr(st, k) for k in (
                   "encode_seconds", "device_seconds", "total_seconds")},
               "applier": {k: (sorted(v) if isinstance(v, set) else v)
                           for k, v in app.stats.items()},
               "placed": sum(len(v) for p in h.plans
                             for v in p.node_allocation.values()),
               "nodes_over_capacity": store_over_capacity(h), "card": smi}
        emit(row)
        return row, [net_plan_rows(p) for p in h.plans], eval_rows(h), \
            network_check(nodes, [a for a in h.state.allocs(None)
                                  if not a.terminal_status()])


def phase_applied(dev, n_nodes=10_000, n_jobs=100, count=1000,
                  n_stream=6):
    """Plans applied and fed back at config (b) width: the port's
    ``PlanApplier`` as the Harness planner, the resident usage mirror on
    (card, ``guard_every=1``), off (card) and on (CPU); batch 0, two
    follow-ups, ``n_stream`` more through ``schedule_stream``, an
    over-commit drill and a corruption drill.  Then the card with the
    default guard cadence (for the encode times, and the stream against
    the same follow-ups one by one), batch 0 and two follow-ups on a
    4-shard mesh of the card, and a batch with network asks on the card
    and the CPU."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops import batch_sched, resident
    from nomad_tpu_torch.parallel import make_node_mesh

    smi = smi_name_power()
    nodes = [strip_node(mock.node()) for _ in range(n_nodes)]
    jobs0 = [strip_job(mock.job(), count) for _ in range(n_jobs)]

    def follow(n):
        return [strip_job(mock.job(), count // 5, cpu=100, mem=128)
                for _ in range(10)] if n else []

    head = [("batch0", jobs0), ("follow_up1", follow(1)),
            ("follow_up2", follow(1))]
    stream = [(f"stream{k + 1}", follow(1)) for k in range(n_stream)]
    # The corruption drill first: the mirror it drops is rebuilt by the
    # over-commit drill's batch, and checked again after it.
    drills = [("corrupt", follow(1)), ("overcommit", follow(1))]
    tail = [(f"serial{k + 1}", follow(1)) for k in range(n_stream)]

    # The first world's store has no columnar mirror: its applier keeps
    # the walk, and batch_allocs_fit on the card.
    w1 = applied_world(dev, nodes, head, smi, "card mirror guard_every=1",
                       stream=stream, drills=drills, counted=True,
                       check_mirror=True, columnar=False)
    w2 = applied_world(dev, nodes, head, smi, "card no mirror",
                       resident=False, stream=stream, drills=drills)
    w3 = applied_world("cpu", nodes, head, smi, "cpu mirror guard_every=1",
                       stream=stream, drills=drills, check_mirror=True)
    w4 = applied_world(dev, nodes, head, smi, "card mirror guard_every=64",
                       guard_every=64, stream=stream, serial_tail=tail)
    # The card's and the CPU's stores are of different lineages, so their
    # mirrors key apart (their placements differ besides).
    if len({w["store_uid"] for w in (w1, w2, w3, w4)}) != 4:
        raise AssertionError("two worlds share a store lineage")
    mesh = make_node_mesh([dev] * MESH_SHARDS)
    w5 = applied_world(dev, nodes, head, smi, "card mesh4 mirror",
                       mesh=mesh)
    mesh_twin = type(resident._STATE.used_dev).__name__
    mesh_mirror = mirror_check(w5["harness"], pad_m=batch_sched.
                               _node_pad_multiple(mesh))

    # Plans, eval statuses and failure AllocMetrics: every world equal.
    names = [n for n, _ in head + stream + drills]
    for w in (w2, w3):
        for b, name in enumerate(names):
            if w["plans"][b] != w1["plans"][b]:
                raise AssertionError(f"{name}: {w['label']} plans differ "
                                     f"from {w1['label']}")
        if w["eval_rows"] != w1["eval_rows"]:
            raise AssertionError(f"{w['label']}: eval updates differ")
    n_head_stream = len(head) + len(stream)
    if w4["plans"][:n_head_stream] != w1["plans"][:n_head_stream]:
        raise AssertionError("guard_every=64 plans differ")
    if w5["plans"] != w1["plans"][:len(head)]:
        raise AssertionError("the mesh's plans differ from the single "
                             "card's")
    for w in (w1, w2, w3, w4, w5):
        if w["over_capacity"]:
            raise AssertionError(f"{w['label']}: {w['over_capacity']} nodes "
                                 "over capacity")
        for st, row in w["rows"]:
            if not st.device_ran or st.oracle_routed or (
                    st.conflict_retries and row["batch"] != "overcommit"):
                raise AssertionError(f"{w['label']}: {row}")
    for st, row in w5["rows"]:
        if st.mesh_shards != MESH_SHARDS:
            raise AssertionError(f"mesh batch on {st.mesh_shards} shards")

    # The applier: batch 0 whole through the vectorized route on the card
    # (the first world's store has no columnar mirror).
    b0 = w1["rows"][0][1]["applier"]
    if (b0["partial"] or b0["vectorized"] != b0["plans"]
            or b0["fit_devices"] != [str(torch_device(dev))]):
        raise AssertionError(f"batch 0's applier: {b0}")

    # The mirror: clean, one install, a guard run at every hit.
    c = w1["checkpoint"]["counters"]
    if (c["GUARD_MISMATCHES"] or c["DEV_GUARD_MISMATCHES"]
            or c["DEV_INSTALLS"] != 1 or c["GUARD_RUNS"] != c["HITS"]
            or c["HITS"] != len(head) + len(stream) - 1):
        raise AssertionError(f"mirror counters: {c}")
    if w1["checkpoint"]["mirror"]["device_twin"] != str(torch_device(dev)):
        raise AssertionError(f"mirror twin: {w1['checkpoint']['mirror']}")
    # One scored_rows launch per committing spec step (on the card; the
    # CPU computes the plain version).
    on_card = torch_device(dev).type == "cuda"
    for counts in [r for _, r in w1["rows"] if "scored_rows_launches" in r
                   ] + [w1["stream"]]:
        if on_card and (counts["scored_rows_launches"] <= 0
                        or counts["scored_rows_launches"]
                        != counts["committing_spec_steps"]):
            raise AssertionError(f"launches: {counts}")

    # Over-commit drill: a partial commit, the retry placed the rest.
    oc = w1["overcommit"]
    if not (oc["applier"]["partial"] >= 1 and oc["conflict_retries"] >= 1):
        raise AssertionError(f"over-commit drill: {oc}")
    oc_jobs = drills[0][1]
    placed_oc = sum(len([a for a in w1["harness"].state.allocs_by_job(
        None, j.id, True) if not a.terminal_status()]) for j in oc_jobs)
    if placed_oc != sum(j.task_groups[0].count for j in oc_jobs):
        raise AssertionError(f"over-commit drill placed {placed_oc}")

    # Corruption drill: the guard tripped, the breaker heard it, the batch
    # ran on the walk (its plans equal the clean worlds', checked above).
    cd = w1["corrupt"]
    if not (cd["fired"] == [("ops.resident_state", 0, "corrupt")]
            and cd["guard_mismatches"] == 1
            and cd["breaker_agreement"] < 1.0
            and cd["row"]["full_reencodes"] == 1
            and cd["row"]["resident_hits"] == 0):
        raise AssertionError(f"corruption drill: {cd}")
    if w2["corrupt"]["fired"]:
        raise AssertionError("the corruption fired without a mirror")

    # The network batch (mirror bypassed, scalar fit checks): card = CPU.
    net_nodes = [mock.node() for _ in range(2_000)]
    net_jobs = [net_job(200) for _ in range(10)]
    n_card, p_card, e_card, chk_card = network_world(dev, net_nodes,
                                                     net_jobs, smi)
    n_cpu, p_cpu, e_cpu, chk_cpu = network_world("cpu", net_nodes,
                                                 net_jobs, smi)
    if chk_card != (0, 0, 0) or chk_cpu != (0, 0, 0):
        raise AssertionError(f"network batch (over bandwidth, ports used "
                             f"twice, dynamic ports out of range): "
                             f"{chk_card}, {chk_cpu}")
    if p_card != p_cpu or e_card != e_cpu:
        raise AssertionError("network batch: card plans or offers differ "
                             "from the CPU's")
    if (n_card["resident_hits"] or n_card["full_reencodes"]
            or n_card["mirror_installs"] or n_card["oracle_routed"]
            or n_card["applier"]["scalar_fallback"]
            != n_card["applier"]["touched_nodes"]
            or n_card["nodes_over_capacity"] or not n_card["placed"]):
        raise AssertionError(f"network batch: {n_card}")

    def seconds(w, key, names_):
        return [r[key] for _, r in w["rows"] if r["batch"] in names_]

    follow_names = [n for n, _ in head[1:] + stream]
    batch_sched._CLUSTER_CACHE.clear()
    batch_sched._DEVICE_STATIC_CACHE.clear()
    resident.reset_counters()
    return {
        "card_equals_card_without_mirror_equals_cpu": True,
        "mesh_equals_single_card": True, "mesh_twin": mesh_twin,
        "mesh_mirror": mesh_mirror,
        "network_card_equals_cpu": True, "network_check": chk_card,
        "mirror_counters": c, "mirror": w1["checkpoint"]["mirror"],
        "final_mirror": w1["final_mirror"],
        "batch0_applier": b0,
        "overcommit": {"node": oc["overcommit_node"],
                       "partial_commits": oc["applier"]["partial"],
                       "conflict_retries": oc["conflict_retries"],
                       "placed": placed_oc},
        "corrupt": {"guard_mismatches": cd["guard_mismatches"],
                    "breaker_agreement": cd["breaker_agreement"]},
        "follow_up_encode_seconds": {
            "mirror_guard64": seconds(w4, "encode_seconds", follow_names),
            "mirror_guard1": seconds(w1, "encode_seconds", follow_names),
            "no_mirror": seconds(w2, "encode_seconds", follow_names)},
        "follow_up_h2d_bytes": {
            "mirror": seconds(w4, "h2d_bytes", follow_names),
            "no_mirror": seconds(w2, "h2d_bytes", follow_names)},
        "applier_seconds": {
            w["label"]: [(r["batch"], r["applier"]["evaluate_seconds"],
                          r["applier"]["apply_seconds"])
                         for _, r in w["rows"]] for w in (w1, w2, w4)},
        "stream": {"guard64": w4["stream"],
                   "serial_tail_wall_seconds":
                       w4["serial_tail_wall_seconds"],
                   "guard1": w1["stream"]},
        "applied_path_launches": sum(
            r.get("scored_rows_launches", 0) for _, r in w1["rows"])
        + w1["stream"]["scored_rows_launches"],
        "card": smi}


# -- phase 16: preempt --------------------------------------------------------

PREEMPT_SEED = 20261019
# (u, n, a) of the kernel's timed rows: config_preempt's shape (50
# preempting specs over 10,112 padded nodes, 8 candidate slots) and a
# wider one (128 specs, 16 slots).
PREEMPT_TIMES = ((50, 10112, 8), (128, 10112, 16))


def evict_bytes(u: int, n: int, a: int) -> int:
    """Bytes the pass must move: per pair mask (a), feasible (1), n_evict
    (4) and score (4) out; per node free, used (16 each), denom (8) and per
    candidate prio (4) and sizes (16) in; per spec ask (16) and job_prio
    (4) in."""
    return u * n * (a + 9) + n * (20 * a + 40) + u * 20


def evict_ops(u: int, n: int, a: int) -> int:
    """Operations per pair: per candidate the forward count (a 4-wide add,
    a 4-wide compare, the priority test: ~14) and the backward trim (~3
    outside the set), and one ScoreFit (~30)."""
    return u * n * (17 * a + 30)


def evict_case(dev, u, n, a):
    """(kernel call, plain call, bytes, operations) on rotating copies of
    ``eviction_inputs.random_inputs`` at one shape."""
    import torch

    from eviction_inputs import random_inputs
    from nomad_tpu_torch.ops import preempt

    args = [torch.from_numpy(x).to(dev)
            for x in random_inputs(n, u, a, seed=PREEMPT_SEED)]
    nbytes = evict_bytes(u, n, a)
    nxt = rotating(args)
    return (lambda: preempt.eviction_sets(*nxt()),
            lambda: preempt.eviction_sets_reference(*nxt()),
            nbytes, evict_ops(u, n, a))


# (u, n, a) of the eviction-set parity cases: the timed shapes, the mixed
# fleet's A = 2-64 over 2,048 nodes, a misaligned edge, and phase server's
# drill (one preempting spec over its fleet padded to 128 nodes, one
# filler a node, padded to A = 2); then the kernel's tile edges: A = 3 and
# 128 (the generic instantiation; 128 with dynamic shared memory) and 32,
# U = 1 and 129 (no multiple of a spec chunk), N one below and one above
# a multiple of the 32-node tile, and 1,024 candidates (a tile of 8
# nodes).
EVICT_PARITY_SHAPES = PREEMPT_TIMES + (
    (64, 2048, 2), (64, 2048, 8), (64, 2048, 16), (64, 2048, 64),
    (7, 701, 8), (1, 128, 2),
    (9, 700, 3), (9, 700, 32), (9, 300, 128), (1, 10112, 8),
    (129, 2048, 16), (50, 2047, 8), (50, 2049, 8), (3, 50, 1024))


def evict_parity(dev):
    """The kernel against its plain version on the card, same inputs: 0
    differing bits in mask, feasible, n_evict and score.  Returns the
    rows and the largest score difference."""
    from eviction_inputs import edge_inputs, random_inputs

    cases = [("edge_rows", edge_inputs())]
    cases += [(f"random u={u} n={n} a={a}",
               random_inputs(n, u, a, seed=PREEMPT_SEED + a))
              for u, n, a in EVICT_PARITY_SHAPES]
    return evict_parity_rows(dev, cases)


def evict_parity_rows(dev, cases):
    """eviction_sets against its plain version on the card for each
    (name, numpy inputs) of ``cases``: 0 differing bits."""
    import torch

    from nomad_tpu_torch.ops import preempt

    rows, max_err = [], 0.0
    for name, arrays in cases:
        t = [torch.from_numpy(x).to(dev) for x in arrays]
        got = preempt.eviction_sets(*t)
        want = preempt.eviction_sets_reference(*t)
        torch.cuda.synchronize()
        differ = {k: (bit_diff(g, w) if g.dtype == torch.float32
                      else int((g != w).sum()))
                  for k, g, w in zip(("mask", "feasible", "n_evict",
                                      "score"), got, want)}
        err = float((got[3] - want[3]).abs().max())
        max_err = max(max_err, err)
        row = {"case": name, "shape": list(got[0].shape),
               "feasible_pairs": int(got[1].sum()),
               "differing": differ, "score_max_abs_err": err}
        if any(differ.values()) or err:
            raise AssertionError(f"eviction_sets disagrees with its plain "
                                 f"version: {row}")
        rows.append(row)
    return rows, max_err


def ptxas_report(log: str):
    """The ptxas report of a build log, one entry an instantiation: its
    name (``kernel<A>``; ``<0>`` the generic one), registers, stack and
    spills."""
    import re

    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            t = re.search(r"([a-z][a-z_]*_kernel)(?:ILi(\d+)E)?", name)
            cur = {"function": (f"{t.group(1)}<{t.group(2)}>" if t and
                                t.group(2) else t.group(1) if t else name)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return rows


def filler_fleet(n_nodes):
    """config_preempt's fleet (bench.py:716-764) in the port's structs:
    ``n_nodes`` copies of ``mock.node()`` with networks stripped, two
    filler jobs at priorities 10 and 30, and 7 fillers of (520 MHz,
    1060 MB) a node alternating between them (~93 % of the usable CPU:
    the free 260 MHz does not fit a 500 MHz ask, one eviction does)."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import structs as ps

    base = strip_node(mock.node())
    nodes = []
    for i in range(n_nodes):
        node = base.copy()
        node.id = node.name = f"node-{i:06d}"
        nodes.append(node)
    fillers = []
    for prio in (10, 30):
        fj = strip_job(mock.job(), 0)
        fj.id = f"filler-{prio}"
        fj.priority = prio
        fillers.append(fj)
    allocs = [ps.Allocation(
        id=f"fill-{i:06d}-{k}", job_id=fillers[k % 2].id, job=fillers[k % 2],
        node_id=nodes[i].id, task_group="web",
        name=f"{fillers[k % 2].name}.web[{k}]",
        resources=ps.Resources(cpu=520, memory_mb=1060))
        for i in range(n_nodes) for k in range(7)]
    return nodes, fillers, allocs


def mixed_fleet(n_nodes, n_jobs, count):
    """``preempt.random_cluster``'s nodes (given ``mock.node()``'s
    attributes, so ``mock.job()``'s constraint and exec task fit), allocs,
    asks and priorities as a store's fleet: each alloc's job upserted, and
    ``n_jobs`` jobs of ``count`` asks that take the cluster's asks and
    priorities (10-99)."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops import preempt
    from nomad_tpu_torch.structs import structs as ps

    nodes, abn, asks, prios = preempt.random_cluster(n_nodes, n_jobs,
                                                     PREEMPT_SEED)
    attrs = mock.node().attributes     # linux, exec available
    for n in nodes:
        n.attributes = dict(attrs)
        n.compute_class()
    allocs = [a for i in range(n_nodes) for a in abn[nodes[i].id]]
    for a in allocs:
        a.task_group = "web"
    fillers = [a.job for a in allocs]
    jobs = []
    for u in range(n_jobs):
        j = strip_job(mock.job(), count)
        j.id = f"mixed-{u:03d}"
        j.priority = prios[u]
        r = asks[u]
        j.task_groups[0].ephemeral_disk.size_mb = r.disk_mb
        j.task_groups[0].tasks[0].resources = ps.Resources(
            cpu=r.cpu, memory_mb=r.memory_mb, iops=r.iops)
        jobs.append(j)
    return nodes, fillers, allocs, jobs


def victim_rows(p):
    return {n: [(a.id, a.job_id, a.desired_status, a.modify_index)
                for a in v] for n, v in p.node_preemptions.items()}


def preempt_world(dev, fleet, label, mesh=None, counted=False):
    """One batch of ``fleet``'s jobs through a fresh Harness whose planner
    is the port's ``PlanApplier``, with
    ``TorchBatchScheduler(preemption_enabled=True)`` on ``dev`` or
    ``mesh``; ids seeded, so worlds compare whole.  Records each
    preemption commit's candidates and effective scores."""
    from nomad_tpu_torch.ops import fused_score, kernels, preempt
    from nomad_tpu_torch.ops.batch_sched import TorchBatchScheduler
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.scheduler import preempt as oracle
    from nomad_tpu_torch.server import PlanApplier
    from nomad_tpu_torch.structs import structs as ps

    nodes, fillers, allocs, jobs = fleet
    commits = []

    class Recording(TorchBatchScheduler):
        def _preempt_commit(self, ctx, fetched, spec_list, ct, *rest):
            _, feasible, n_evict, score, feas_rows = fetched
            commits.append({
                "pu": list(ctx["pu"]), "node_ids": ct.node_ids,
                "jobs": [spec_list[u].job.id for u in ctx["pu"]],
                "ok": feasible & feas_rows.astype(bool),
                "eff": score - (oracle.PREEMPTION_SCORE_PENALTY
                                + oracle.PREEMPTION_PER_ALLOC_PENALTY
                                * n_evict)})
            return super()._preempt_commit(ctx, fetched, spec_list, ct,
                                           *rest)

    kw = {"mesh": mesh} if mesh is not None else {"device": dev}
    t0 = time.perf_counter()
    with seeded_world(PREEMPT_SEED, nodes) as (h, ids):
        seen = set()
        for fj in fillers:
            if fj.id not in seen:
                seen.add(fj.id)
                h.state.upsert_job(h.next_index(), fj)
        h.state.upsert_allocs(h.next_index(), allocs)
        for j in jobs:
            h.state.upsert_job(h.next_index(), j)
        app = PlanApplier(h.state, device=dev, next_index=h.next_index)
        h.planner = app
        evals = reg_evals(jobs, ids)
        build_s = time.perf_counter() - t0
        over_before = over_capacity_nodes(h)

        def run():
            return Recording(h.logger, h.snapshot(), h, rng_seed=SEED,
                             breaker=KernelCircuitBreaker(),
                             preemption_enabled=True, **kw
                             ).schedule_batch(evals)

        counts = {}
        if counted:
            fused_score.LAUNCHES = preempt.LAUNCHES = 0
            kernels.COMMIT_STEPS = 0
        st = run()
        if counted:
            counts = {"eviction_sets_launches": preempt.LAUNCHES,
                      "scored_rows_launches": fused_score.LAUNCHES,
                      "committing_spec_steps": kernels.COMMIT_STEPS}
    evicted = [a for a in h.state.allocs(None)
               if a.desired_status == ps.ALLOC_DESIRED_STATUS_EVICT]
    follow_ups = sorted(
        (e.job_id, e.status) for e in h.state.evals_table.values()
        if e.triggered_by == ps.EVAL_TRIGGER_PREEMPTION)
    placed = {j.id: len([a for a in h.state.allocs_by_job(None, j.id, True)
                         if not a.terminal_status()]) for j in jobs}
    row = {"phase": "preempt", "world": label, "device": str(dev),
           "fleet_build_seconds": build_s,
           "asks": st.num_asks, "rounds": st.rounds,
           "oracle_routed": st.oracle_routed, "mesh_shards": st.mesh_shards,
           **{k: getattr(st, k) for k in (
               "preempt_placed", "preempt_evicted", "preempt_checked",
               "preempt_agree", "preempt_encode_seconds", "encode_seconds",
               "device_seconds", "metrics_seconds", "finalize_seconds",
               "total_seconds", "fetch_bytes")},
           "placed_main_pass": sum(sl.node_ids.__len__()
                                   for p in h.plans for sl in p.alloc_slabs),
           "placed": sum(placed.values()),
           "unplaced": st.num_asks - sum(placed.values()),
           "evicted_in_store": len(evicted),
           "victim_max_priority": max(
               (h.state.job_by_id(None, a.job_id).priority
                for a in evicted), default=None),
           "blocked_evals": sum(1 for e in h.create_evals
                                if e.status == ps.EVAL_STATUS_BLOCKED),
           "preemption_follow_up_evals": len(follow_ups),
           # The evicted jobs named when few, else counted.
           "follow_up_jobs": (sorted({j for j, _ in follow_ups})
                              if len({j for j, _ in follow_ups}) <= 8
                              else len({j for j, _ in follow_ups})),
           # Nodes the fleet put over capacity stay so; the batch may
           # put none there.
           "nodes_over_capacity_before": len(over_before),
           "nodes_over_capacity": len(over_capacity_nodes(h)
                                      - over_before),
           "applier": {k: (sorted(v) if isinstance(v, set) else v)
                       for k, v in app.stats.items()},
           **counts}
    emit(row)
    return {"row": row, "stats": st, "commits": commits,
            "plans": [(plan_rows(p), victim_rows(p)) for p in h.plans],
            "evals": eval_rows(h),
            "created": [(e.id, e.job_id, e.status, e.triggered_by)
                        for e in h.create_evals],
            "follow_ups": follow_ups, "placed": placed}


def flipped_pairs(card, cpu, tol=ATOL):
    """Pairs of candidate nodes of one preempting spec whose effective
    scores the card and the CPU order differently: (spec, node, node,
    card values, CPU values).  Only a node whose two values differ can
    take part, and only with a node within 2 tol on the CPU."""
    import numpy as np

    out = []
    for c, p in zip(card["commits"], cpu["commits"]):
        for k, u in enumerate(c["pu"]):
            ok = c["ok"][k] & p["ok"][k]
            ec, ep = c["eff"][k], p["eff"][k]
            cand = np.nonzero(ok)[0]
            if not len(cand):
                continue
            order = cand[np.argsort(ep[cand], kind="stable")]
            sorted_ep = ep[order]
            for i in cand[ec[cand] != ep[cand]].tolist():
                lo = np.searchsorted(sorted_ep, ep[i] - 2 * tol, "left")
                hi = np.searchsorted(sorted_ep, ep[i] + 2 * tol, "right")
                for j in order[lo:hi].tolist():
                    if j <= i and ec[j] != ep[j]:
                        continue     # each pair once
                    if np.sign(ec[i] - ec[j]) != np.sign(ep[i] - ep[j]):
                        out.append({
                            "spec": int(u), "job": c["jobs"][k],
                            "nodes": [c["node_ids"][i],
                                                      c["node_ids"][j]],
                            "card_eff": [float(ec[i]), float(ec[j])],
                            "cpu_eff": [float(ep[i]), float(ep[j])],
                            "within_tol": bool(
                                abs(ec[i] - ep[i]) <= tol
                                and abs(ec[j] - ep[j]) <= tol)})
    return out


def placed_pairs(w):
    """(job, node) -> count of the world's placements, the main pass's
    slab rows and the explicit allocs (the preemption winners) alike, and
    node -> its victims' ids over all plans."""
    from collections import Counter

    placed, victims = Counter(), {}
    for (_, _, explicit, slabs), vic in w["plans"]:
        for node, rows in explicit.items():
            placed.update((name.split(".")[0], node) for _, name, _ in rows)
        for _, _, names, node_ids, _ in slabs:
            placed.update((name.split(".")[0], node)
                          for name, node in zip(names, node_ids))
        for node, rows in vic.items():
            victims.setdefault(node, []).extend(r[0] for r in rows)
    return placed, {n: sorted(v) for n, v in victims.items()}


def unexplained_differences(card, cpu, pairs):
    """The differences between two worlds' results that no flipped
    near-tie pair explains.  A placement of job j on node n that only one
    world made is explained by a pair of j's spec that holds n; a node
    whose victims differ, by a pair that holds the node; the follow-up
    evals may differ only when some victims do.  Evals, created evals and
    the plans' stops must be equal."""
    out = [k for k in ("evals", "created") if card[k] != cpu[k]]
    stops = lambda w: [(p[0], p[1]) for p, _ in w["plans"]]  # noqa: E731
    if stops(card) != stops(cpu):
        out.append("plan stops")
    (pc, vc), (pp, vp) = placed_pairs(card), placed_pairs(cpu)
    by_job = {(p["job"], n) for p in pairs for n in p["nodes"]}
    pair_nodes = {n for p in pairs for n in p["nodes"]}
    out += [f"placement {jn} x{k}" for jn, k in ((pc - pp) + (pp - pc)).items()
            if jn not in by_job]
    bad_victims = [n for n in set(vc) | set(vp)
                   if vc.get(n) != vp.get(n)]
    out += [f"victims on {n}" for n in sorted(bad_victims)
            if n not in pair_nodes]
    if card["follow_ups"] != cpu["follow_ups"] and not bad_victims:
        out.append("follow_ups")
    return out


def phase_preempt(dev, n_nodes=10_000, n_hi=50, count=1000,
                  mixed_nodes=2048, mixed_jobs=64, mixed_count=64):
    """Device preemption: (a) the eviction-set kernel against its plain
    version and the scalar oracle on the card; (b) config_preempt
    (bench.py:716-818) through the eval path with the port's
    ``PlanApplier``, on the card and on the CPU; (c) a mixed fleet on the
    card, the CPU and a 4-shard mesh of the card; then the kernel's
    times."""
    import numpy as np

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops import preempt
    from nomad_tpu_torch.parallel import make_node_mesh

    smi = smi_name_power()
    on_card = torch_device(dev).type == "cuda"

    # (a) The kernel against its plain version, and against the oracle.
    parity_rows, max_err = (evict_parity(dev) if on_card else ([], 0.0))
    if on_card:
        from nomad_tpu_torch import device as devmod

        log = devmod.BUILD_LOGS.get("eviction_sets")
        emit({"phase": "preempt", "kernel": "eviction_sets",
              "ptxas": ptxas_report(log) if log is not None else
              "not in this process's build (the library was built before)"})
    t0 = time.perf_counter()
    agree_nodes, agree_specs = (2048, 64) if on_card else (64, 8)
    checked, mismatches, first = preempt.agreement_check(
        *preempt.random_cluster(agree_nodes, agree_specs, PREEMPT_SEED),
        device=dev)
    if mismatches:
        raise AssertionError(f"{mismatches} of {checked} pairs disagree "
                             f"with the oracle: {first}")
    agreement = {"pairs": checked, "mismatches": mismatches,
                 "seconds": time.perf_counter() - t0}

    # (b) config_preempt: card and CPU.
    nodes, fillers, allocs = filler_fleet(n_nodes)
    hi = []
    for k in range(n_hi):
        j = strip_job(mock.job(), count, cpu=500, mem=256)
        j.id = f"hi-{k:03d}"
        j.priority = 70
        hi.append(j)
    fleet = (nodes, fillers, allocs, hi)
    w_card = preempt_world(dev, fleet, "config_preempt card", counted=True)
    w_cpu = preempt_world("cpu", fleet, "config_preempt cpu")
    for w in (w_card, w_cpu):
        r = w["row"]
        filled = min(n_nodes // count, n_hi)
        want = {"placed_main_pass": 0, "preempt_placed": n_nodes,
                "preempt_evicted": n_nodes, "preempt_checked": n_nodes,
                "preempt_agree": n_nodes, "evicted_in_store": n_nodes,
                "unplaced": n_hi * count - n_nodes,
                "blocked_evals": n_hi - filled,
                "preemption_follow_up_evals": filled,
                "follow_up_jobs": ["filler-10"],
                "nodes_over_capacity": 0, "oracle_routed": 0}
        got = {k: r[k] for k in want}
        if got != want or r["victim_max_priority"] >= 70:
            raise AssertionError(f"{r['world']}: {got} != {want}, victim "
                                 f"priority {r['victim_max_priority']}")
        full = [j for j, v in w["placed"].items() if v == count]
        if full != [j.id for j in hi[:filled]]:
            raise AssertionError(f"{r['world']}: full jobs {full}")
    if on_card and w_card["row"]["eviction_sets_launches"] != 1:
        raise AssertionError(f"config_preempt: {w_card['row']}")
    for key in ("plans", "evals", "created", "follow_ups"):
        if w_card[key] != w_cpu[key]:
            raise AssertionError(f"config_preempt: card {key} differ from "
                                 "the CPU's")

    # (c) The mixed fleet: card, CPU, and a 4-shard mesh of the card.
    mfleet = mixed_fleet(mixed_nodes, mixed_jobs, mixed_count)
    m_card = preempt_world(dev, mfleet, "mixed card", counted=True)
    m_cpu = preempt_world("cpu", mfleet, "mixed cpu")
    m_mesh = preempt_world(dev, mfleet, "mixed card mesh4",
                           mesh=make_node_mesh([dev] * MESH_SHARDS),
                           counted=True)
    mr = m_card["row"]
    if not (mr["placed_main_pass"] and mr["preempt_placed"]
            and mr["unplaced"]):
        raise AssertionError(f"the mixed fleet does not mix: {mr}")
    if mr["preempt_agree"] != mr["preempt_checked"] or \
            mr["nodes_over_capacity"]:
        raise AssertionError(f"mixed fleet: {mr}")
    if on_card and (mr["eviction_sets_launches"] != 1
                    or mr["scored_rows_launches"] <= 0
                    or m_mesh["row"]["eviction_sets_launches"] != 1):
        raise AssertionError(f"mixed fleet launches: {mr}, "
                             f"{m_mesh['row']}")
    if m_mesh["row"]["mesh_shards"] != MESH_SHARDS:
        raise AssertionError(f"mesh batch: {m_mesh['row']}")
    for key in ("plans", "evals", "created", "follow_ups"):
        if m_mesh[key] != m_card[key]:
            raise AssertionError(f"mixed fleet: mesh {key} differ from the "
                                 "single card's")
    pairs = flipped_pairs(m_card, m_cpu)
    same = all(m_card[k] == m_cpu[k]
               for k in ("plans", "evals", "created", "follow_ups"))
    if not same:
        unexplained = unexplained_differences(m_card, m_cpu, pairs)
        if unexplained:
            raise AssertionError(
                f"mixed fleet: card results differ from the CPU's where "
                f"no flipped near-tie pair explains it: {unexplained}; "
                f"pairs: {pairs}")
    if any(not p["within_tol"] for p in pairs):
        raise AssertionError(f"mixed fleet: a card score is more than "
                             f"{ATOL} from the CPU's: {pairs}")
    eff_err = max((float(np.abs(c["eff"][c["ok"]] - p["eff"][c["ok"]]).max())
                   for c, p in zip(m_card["commits"], m_cpu["commits"])
                   if c["ok"].any()), default=0.0)

    # The kernel's times at the two bound shapes (card only).
    times = []
    if on_card:
        for u, n, a in PREEMPT_TIMES:
            call, plain, nbytes, nops = evict_case(dev, u, n, a)
            row = {"u": u, "n": n, "a": a,
                   **timed_row(call, plain, "eviction_sets_kernel", nbytes,
                               nops, n=60)}
            emit({"phase": "preempt", "kernel": "eviction_sets", **row,
                  "card": smi})
            times.append(row)
    main = times[0] if times else {}
    table_row = {
        "name": "eviction_sets", "route": "cuda",
        "source": "nomad_tpu_torch/csrc/eviction_sets.cu",
        "replaces": "nomad_tpu/ops/preempt.py:82",
        "launches": w_card["row"].get("eviction_sets_launches"),
        "max_abs_err": max_err,
        **{k: main.get(k) for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by")},
        "library_ms": None}
    keep = ("encode_seconds", "device_seconds", "metrics_seconds",
            "finalize_seconds", "total_seconds", "preempt_encode_seconds",
            "fetch_bytes", "fleet_build_seconds")
    return {
        "parity": parity_rows, "agreement": agreement,
        "config_preempt": {
            "card_equals_cpu": True,
            "card": {k: w_card["row"][k] for k in keep},
            "cpu": {k: w_cpu["row"][k] for k in keep},
            "applier": {w["row"]["world"]: {
                k: w["row"]["applier"][k] for k in (
                    "plans", "evaluate_seconds", "apply_seconds",
                    "touched_nodes", "vectorized", "scalar")}
                for w in (w_card, w_cpu)}},
        "mixed": {"card_equals_cpu": same, "mesh_equals_single_card": True,
                  "flipped_near_tie_pairs": pairs,
                  "eff_max_abs_card_minus_cpu": eff_err,
                  **{k: mr[k] for k in ("placed_main_pass",
                                         "preempt_placed", "unplaced",
                                         "preempt_evicted",
                                         "eviction_sets_launches",
                                         "scored_rows_launches")
                     if k in mr}},
        "times": times, "kernel_row": table_row, "card": smi}


# -- phase 17: server --------------------------------------------------------

SERVER_SEED = 20261020
# The node heartbeat TTL of every server of the phase: longer than the
# run, so no node expires mid-run (the TTL would otherwise be 10 s plus
# 10 s of grace for the first nodes of the fleet); the only node-down is
# the deliberate one.
SERVER_HEARTBEAT_TTL = 3600.0
SERVER_SETTLE_TIMEOUT = 120.0
SERVER_SAMPLES = ("worker.invoke_scheduler.batch", "worker.invoke_scheduler",
                  "worker.invoke_scheduler.device",
                  "worker.invoke_scheduler.encode",
                  "worker.invoke_scheduler.finalize",
                  "worker.invoke_scheduler.system", "plan.queue_wait",
                  "plan.evaluate", "plan.apply", "raft.apply")


def server_settled(srv) -> bool:
    """Nothing queued, in flight or pending in ``srv``."""
    b = srv.eval_broker.stats()
    return (b["total_ready"] == b["total_failed"]
            and b["total_unacked"] == 0 and b["total_waiting"] == 0
            and srv.plan_queue.depth() == 0
            and srv.blocked_evals._capacity_q.empty()
            and not srv.blocked_evals.duplicates
            and not any(e.status == "pending"
                        for e in srv.state.evals(None)))


def server_settle(srv) -> float:
    """Settled at two looks 0.2 s apart with no log entry applied between
    them (a reaper's cancel or a watcher's unblock that lands in the gap
    starts the wait over); raises past ``SERVER_SETTLE_TIMEOUT``.
    Returns the host clock of the first of the two looks."""
    from nomad_tpu_torch.utils.backoff import wait_until

    deadline = time.perf_counter() + SERVER_SETTLE_TIMEOUT
    while True:
        left = deadline - time.perf_counter()
        if left <= 0 or not wait_until(lambda: server_settled(srv), left,
                                       max_interval=0.01):
            raise AssertionError(f"server did not settle in "
                                 f"{SERVER_SETTLE_TIMEOUT} s: {srv.stats()}")
        first = time.perf_counter()
        index = srv.raft.applied_index()
        time.sleep(0.2)
        if server_settled(srv) and srv.raft.applied_index() == index:
            return first


def sample_totals(srv) -> dict:
    """(count, sum in ms) of each timing the phase reads, since the
    server started."""
    tot = srv.metrics.sink.latest()["SampleTotals"]
    return {k: tot.get(f"nomad.{k}", (0, 0.0)) for k in SERVER_SAMPLES}


def server_counter(srv, key: str) -> float:
    return srv.metrics.sink.latest()["CounterTotals"].get(f"nomad.{key}",
                                                          0.0)


def server_wave(srv, label, fn) -> dict:
    """``fn(srv)`` with the workers paused, then released: the evals it
    made are dequeued together, in batches of ``batch_size``.  Returns
    the wave's wall time from the release to settled, its evals, and the
    server's telemetry over the wave (count and ms of each timing)."""
    if not srv.set_workers_paused(True, timeout=SERVER_SETTLE_TIMEOUT):
        raise AssertionError(f"{label}: workers did not park")
    before = sample_totals(srv)
    acks0 = server_counter(srv, "broker.ack")
    t_call = time.perf_counter()
    fn(srv)
    t0 = time.perf_counter()
    srv.set_workers_paused(False)
    wall = server_settle(srv) - t0
    after = sample_totals(srv)
    acked = int(server_counter(srv, "broker.ack") - acks0)
    row = {"wave": label, "calls_s": t0 - t_call, "wall_s": wall,
           "evals_acked": acked, "evals_per_s": acked / wall}
    for k in SERVER_SAMPLES:
        c = after[k][0] - before[k][0]
        if c:
            row[k] = {"count": c, "ms": after[k][1] - before[k][1]}
    b = row.get("worker.invoke_scheduler.batch")
    if b:
        # The worker's batch time, split: the scheduler's call (which
        # waits on its plans), and within it each plan's queue wait and
        # the applier's evaluate and apply.
        row["batch_share"] = {
            name: row[name]["ms"] / b["ms"]
            for name in ("worker.invoke_scheduler", "plan.queue_wait",
                         "plan.evaluate", "plan.apply") if name in row}
    return row


def server_content(srv) -> dict:
    """What the server committed, by content (no ids): every alloc's
    (job, name, node, desired and client status) and every eval's (job,
    trigger, status)."""
    st = srv.state
    return {"allocs": sorted((a.job_id, a.name, a.node_id,
                              a.desired_status, a.client_status)
                             for a in st.allocs(None)),
            "evals": sorted((e.job_id, e.triggered_by, e.status)
                            for e in st.evals(None)),
            "blocked": dict(srv.blocked_evals.stats())}


def content_diff(card, cpu, k: int = 8) -> dict:
    """Where two ``server_content`` views differ: the first ``k`` allocs
    and evals that only one side holds, and both blocked counts."""
    out = {}
    for key in ("allocs", "evals"):
        if card[key] != cpu[key]:
            a, b = set(card[key]), set(cpu[key])
            out[key] = {"card_only": sorted(a - b)[:k],
                        "cpu_only": sorted(b - a)[:k],
                        "counts": [len(card[key]), len(cpu[key])]}
    if card["blocked"] != cpu["blocked"]:
        out["blocked"] = {"card": card["blocked"], "cpu": cpu["blocked"]}
    return out


def server_scenario(n_nodes, n_jobs, count, follow_jobs, follow_count,
                    extra_nodes, n_down, drill_nodes):
    """The phase's objects, made once for every world: config (b)'s
    fleet and waves, config (d)'s system job, the nodes that unblock the
    waves' leftovers, and the preempting drill's fleet and jobs."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import structs as ps

    def node(i, prefix="node"):
        n = strip_node(mock.node())
        n.id = f"{prefix}-{i:05d}"
        return n

    nodes = [node(i) for i in range(n_nodes)]
    wave_a = [strip_job(mock.job(), count) for _ in range(n_jobs)]
    wave_b = [strip_job(mock.job(), follow_count, cpu=100, mem=128)
              for _ in range(follow_jobs)]
    for k, j in enumerate(wave_a + wave_b):
        j.id = j.name = f"job-{k:03d}"
    # Config (d): bench.py:620-660's system job, networks stripped.
    system = mock.job()
    system.id = system.name = "system"
    system.type = ps.JOB_TYPE_SYSTEM
    system.priority = 100
    strip_job(system, 1)
    extra = [node(i, "extra") for i in range(extra_nodes)]
    fleet = [node(i, "fleet") for i in range(drill_nodes)]
    filler = strip_job(mock.job(), drill_nodes, cpu=3000, mem=512)
    filler.id = filler.name = "filler"
    filler.priority = 10
    urgent = strip_job(mock.job(), drill_nodes // 2, cpu=2000, mem=512)
    urgent.id = urgent.name = "urgent"
    urgent.priority = 70
    spare = [node(i, "spare") for i in range(drill_nodes // 2)]
    return {"nodes": nodes, "wave_a": wave_a, "wave_b": wave_b,
            "system": system, "extra": extra, "n_down": n_down,
            "drill": (fleet, filler, urgent, spare)}


@contextlib.contextmanager
def kernel_shapes(shapes):
    """Record into ``shapes`` the shape of every call of the server path's
    kernel wrappers: ``(u, n, n_offset)`` of ``scored_rows`` and ``(u, n,
    a)`` of ``eviction_sets``.  Both are called through their modules, so
    the recorder stands in for them until the block ends."""
    from nomad_tpu_torch.ops import fused_score, preempt

    score, evict = fused_score.scored_rows, preempt.eviction_sets

    def score_rec(feas, *args, n_offset=0, **kwargs):
        shapes["scored_rows"].add((*feas.shape, n_offset))
        return score(feas, *args, n_offset=n_offset, **kwargs)

    def evict_rec(free, used, denom, prio, sizes, ask, job_prio):
        shapes["eviction_sets"].add((ask.shape[0], *prio.shape))
        return evict(free, used, denom, prio, sizes, ask, job_prio)

    fused_score.scored_rows, preempt.eviction_sets = score_rec, evict_rec
    try:
        yield
    finally:
        fused_score.scored_rows, preempt.eviction_sets = score, evict


def server_run(out, dev, label, seed, body, counted=False, shapes=None,
               **cfg) -> None:
    """One port ``Server`` on ``dev`` (batches of 64, ids seeded from
    ``seed``, a breaker of its own, ``cfg`` on top) started, driven by
    ``body(srv)`` and shut down; ``out[label]`` gets its launches, the
    applier's routes, the columnar counters, its health and what it
    committed.  With ``counted``, the kernels' launch counts are set to 0
    just before ``body`` and read just after, and with ``shapes`` (see
    :func:`kernel_shapes`) the shapes the path gives the kernels are
    recorded."""
    from nomad_tpu_torch.ops import fused_score, kernels, preempt
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.state import columnar as colmod

    colmod.reset_counters()
    brk = KernelCircuitBreaker()
    # A store of its own lineage (made before the ids are seeded): the
    # card's world never keys a cache or the resident mirror as the CPU's
    # does.
    srv = Server(ServerConfig(
        device=dev, rng_seed=SERVER_SEED, batch_size=64,
        min_heartbeat_ttl=SERVER_HEARTBEAT_TTL, breaker=brk, **cfg))
    try:
        with seeded_ids(seed):
            srv.start()
            if counted:
                fused_score.LAUNCHES = kernels.COMMIT_STEPS = 0
                fused_score.MASKED_LAUNCHES = preempt.LAUNCHES = 0
            with (kernel_shapes(shapes) if shapes is not None
                  else contextlib.nullcontext()):
                body(srv)
        launches = {"scored_rows": fused_score.LAUNCHES,
                    "masked_score_matrix": fused_score.MASKED_LAUNCHES,
                    "eviction_sets": preempt.LAUNCHES,
                    "committing_spec_steps": kernels.COMMIT_STEPS,
                    "batch_commit_steps": server_counter(
                        srv, "batch.commit_steps")}
        b = srv.eval_broker.stats()
        app = srv.plan_applier.stats
        out[label] = {
            "launches": launches,
            "applier": {k: app[k] for k in (
                "plans", "columnar", "columnar_guards", "vectorized",
                "scalar", "scalar_fallback")},
            "columnar": columnar_counters(),
            "breaker": {"state": brk.state, "trips": brk.trips,
                        "oracle_routed": server_counter(
                            srv, "breaker.oracle_routed")},
            "nacks": b["total_nacks"], "failed": b["total_failed"],
            "over_capacity": store_over_capacity(srv),
            "content": server_content(srv)}
    finally:
        srv.shutdown()


def drill_waves(sc, out):
    """The preempting drill's body: the fleet registered, the filler,
    the urgent job placed by eviction, the spare nodes that place the
    victims' follow-up; each wave's row into ``out["waves"]``."""
    def drill(srv):
        fleet, filler, urgent, spare = sc["drill"]
        for n in fleet:
            srv.node_register(n)
        for label, fn in (
                ("drill_fill", lambda s: s.job_register(filler)),
                ("drill_preempt", lambda s: s.job_register(urgent)),
                ("drill_replace", lambda s: [s.node_register(n)
                                             for n in spare])):
            out["waves"].append(server_wave(srv, label, fn))
            if label == "drill_preempt":
                out["drill_follow_up"] = sorted(
                    (e.job_id, e.triggered_by, e.status)
                    for e in srv.state.evals(None)
                    if e.triggered_by == "preemption")
                out["drill_blocked"] = dict(srv.blocked_evals.stats())
    return drill


def server_world(dev, sc, smi, counted=False, guard_every=None) -> dict:
    """Part C of the server slice through the port's ``Server`` on
    ``dev`` (ids seeded, so worlds compare): the fleet registered by
    ``node_register``; config (d)'s system job on every node; config
    (b)'s waves by ``job_register`` (the asks that find no room block);
    the extra nodes that unblock them; ``n_down`` nodes down and their
    replacements; a job deregistered; then, on a second server with
    preemption on, the drill.  With ``counted``, the kernels' launch
    counts are set to 0 just before each server is driven and read just
    after, and the shapes the path gives the kernels are recorded.
    ``guard_every`` is the main server's ``columnar_guard_every`` (None:
    the default cadence)."""
    out = {"device": str(dev), "card": smi, "waves": [],
           "guard_every": guard_every,
           "kernel_shapes": {"scored_rows": set(), "eviction_sets": set()}}
    shapes = out["kernel_shapes"] if counted else None

    def main(srv):
        t0 = time.perf_counter()
        for n in sc["nodes"]:
            srv.node_register(n)
        out["node_register_s"] = time.perf_counter() - t0
        waves = [
            ("config_d", lambda s: s.job_register(sc["system"])),
            ("config_b", lambda s: [s.job_register(j)
                                    for j in sc["wave_a"]]),
            ("follow_up", lambda s: [s.job_register(j)
                                     for j in sc["wave_b"]]),
            ("unblock", lambda s: [s.node_register(n)
                                   for n in sc["extra"]]),
        ]
        for label, fn in waves:
            out["waves"].append(server_wave(srv, label, fn))
            out[f"after_{label}"] = server_content(srv)
        hosts = sorted({a.node_id for a in srv.state.allocs(None)
                        if a.job_id == sc["wave_a"][0].id})[:sc["n_down"]]
        out["down_hosts"] = hosts
        out["waves"].append(server_wave(srv, "node_down", lambda s: [
            s.node_update_status(nid, "down") for nid in hosts]))
        out["after_node_down"] = server_content(srv)
        out["waves"].append(server_wave(srv, "deregister", lambda s:
                            s.job_deregister(sc["wave_a"][1].id,
                                             purge=False)))

    server_run(out, dev, "main", SERVER_SEED, main, counted=counted,
               shapes=shapes,
               **({} if guard_every is None
                  else {"columnar_guard_every": guard_every}))
    server_run(out, dev, "drill", SERVER_SEED + 1, drill_waves(sc, out),
               counted=counted, shapes=shapes, preemption_enabled=True)
    return out


def check_server_world(w, sc, on_card) -> dict:
    """The world's own checks: what config (b) and (d) placed, the
    blocked leftovers and their unblock, the replacements, the
    deregistration, the drill's eviction and hand-off; no node over
    capacity, the breaker closed with no trip and no oracle route, no
    nack, no failed eval; and on the card one scored_rows launch per
    committing spec step the batches report, one eviction_sets launch in
    the drill."""
    fleet, filler, urgent, spare = sc["drill"]
    main, drill = w["main"], w["drill"]
    live = lambda c, pred: [a for a in c["allocs"]  # noqa: E731
                            if a[3] == "run" and pred(a)]
    asks_b = sum(j.task_groups[0].count for j in sc["wave_a"])
    asks_f = sum(j.task_groups[0].count for j in sc["wave_b"])
    b_ids = {j.id for j in sc["wave_a"]}
    f_ids = {j.id for j in sc["wave_b"]}
    got = {
        "system_allocs": len(live(w["after_config_d"],
                                  lambda a: a[0] == "system")),
        "config_b_placed_first": len(live(w["after_config_b"],
                                          lambda a: a[0] in b_ids)),
        "config_b_blocked": w["after_config_b"]["blocked"]["total_blocked"],
        "follow_up_placed": len(live(w["after_follow_up"],
                                     lambda a: a[0] in f_ids)),
        "config_b_placed": len(live(w["after_unblock"],
                                    lambda a: a[0] in b_ids)),
        "blocked_after_unblock":
            w["after_unblock"]["blocked"]["total_blocked"],
        "lost": len([a for a in w["after_node_down"]["allocs"]
                     if a[4] == "lost"]),
        "drill_evicted": len([a for a in drill["content"]["allocs"]
                              if a[3] == "evict"]),
        "drill_follow_up": w["drill_follow_up"],
        "drill_blocked": w["drill_blocked"]["total_blocked"],
        "drill_filler_placed": len(live(drill["content"],
                                        lambda a: a[0] == "filler")),
    }
    errors = []
    if got["system_allocs"] != len(sc["nodes"]):
        errors.append("config (d): not one system alloc on every node")
    if got["config_b_placed"] != asks_b or got["follow_up_placed"] != asks_f:
        errors.append("config (b): not every ask placed")
    if not got["config_b_blocked"] or got["blocked_after_unblock"]:
        errors.append("config (b): the leftovers did not block, then "
                      "unblock")
    lost = [a for a in w["after_node_down"]["allocs"]
            if a[4] == "lost" and a[0] != "system"]
    repl = {(a[0], a[1]) for a in live(w["after_node_down"],
                                       lambda a: True)}
    if not lost or any((a[0], a[1]) not in repl for a in lost):
        errors.append("node down: a lost alloc was not replaced")
    dereg = [a for a in main["content"]["allocs"]
             if a[0] == sc["wave_a"][1].id]
    if not dereg or any(a[3] != "stop" for a in dereg):
        errors.append("deregister: an alloc of the job is not stopped")
    half = len(fleet) // 2
    if (got["drill_evicted"] != half
            or got["drill_follow_up"] != [("filler", "preemption",
                                           "blocked")]
            or got["drill_blocked"] != 1
            or got["drill_filler_placed"] != len(fleet)
            or drill["content"]["blocked"]["total_blocked"]):
        errors.append("preempting drill: eviction, hand-off or replacement")
    for label in ("main", "drill"):
        r = w[label]
        if r["over_capacity"] or r["nacks"] or r["failed"] or r[
                "breaker"] != {"state": "closed", "trips": 0,
                               "oracle_routed": 0}:
            errors.append(f"{label}: {r['over_capacity']} nodes over "
                          f"capacity, {r['nacks']} nacks, {r['failed']} "
                          f"failed, breaker {r['breaker']}")
        c, app = r["columnar"], r["applier"]
        if (c["GUARD_MISMATCHES"] or c["USAGE_GUARD_MISMATCHES"]
                or not c["COLUMNAR_ENCODES"] or not app["columnar"]):
            errors.append(f"{label}: the columnar mirror: {c}, the "
                          f"applier's routes {app}")
        lc = r["launches"]
        if on_card and (lc["scored_rows"] <= 0
                        or lc["scored_rows"] != lc["batch_commit_steps"]
                        or lc["scored_rows"] != lc["committing_spec_steps"]):
            errors.append(f"{label}: launches {lc}")
    # At every read, the static, usage and plan-fit guards all ran.
    c, app = main["columnar"], main["applier"]
    if w["guard_every"] == 1 and not (c["GUARD_RUNS"] > 0
                                      and c["USAGE_GUARD_RUNS"] > 0
                                      and app["columnar_guards"] > 0):
        errors.append(f"main: guards at every read did not all run: {c}, "
                      f"the applier's routes {app}")
    if on_card and any(w[k]["launches"]["masked_score_matrix"]
                       for k in ("main", "drill")):
        errors.append("masked_score_matrix launched on one card: main "
                      f"{w['main']['launches']}, drill "
                      f"{w['drill']['launches']}")
    if on_card and (w["main"]["launches"]["eviction_sets"] != 0
                    or w["drill"]["launches"]["eviction_sets"] != 1):
        errors.append("eviction_sets launches: main "
                      f"{w['main']['launches']['eviction_sets']}, drill "
                      f"{w['drill']['launches']['eviction_sets']}")
    if errors:
        raise AssertionError(f"{w['device']}: {errors}; {got}")
    return got


def server_shape_parity(dev, shapes, on_card) -> dict:
    """Each kernel against its plain version at every shape the card's
    server run gave it: 0 differing bits."""
    from eviction_inputs import random_inputs

    if not on_card:
        return {}
    score = sorted(shapes["scored_rows"])
    evict = sorted(shapes["eviction_sets"])
    if not score or not evict:
        raise AssertionError(f"the server path gave a kernel no shape: "
                             f"{shapes}")
    rows, worst = score_parity_rows(
        dev, [(u, n, 17, n_off) for u, n, n_off in score])
    erows, eworst = evict_parity_rows(
        dev, [(f"server u={u} n={n} a={a}",
               random_inputs(n, u, a, seed=PREEMPT_SEED + n + a))
              for u, n, a in evict])
    return {"scored_rows": rows, "eviction_sets": erows,
            "max_abs_err": max(worst, eworst)}


def phase_server(dev, n_nodes=10_000, n_jobs=100, count=1000,
                 follow_jobs=10, follow_count=200, extra_nodes=6_000,
                 n_down=10, drill_nodes=64):
    """The server path: jobs into the port's ``Server``, evals through
    its broker and ``BatchWorker`` into ``TorchBatchScheduler``, plans
    through its plan queue and ``PlanApplier`` onto the in-memory log, on
    the card and on the CPU, compared by content."""
    smi = smi_name_power()
    sc = server_scenario(n_nodes, n_jobs, count, follow_jobs, follow_count,
                         extra_nodes, n_down, drill_nodes)
    on_card = torch_device(dev).type == "cuda"
    # Both main servers run every columnar guard at every read (the static
    # encode, the usage read, the applier's plan fit).  The cadence must
    # match: a guard's object walk materializes the store's per-node alloc
    # sets, whose iteration order then orders a node update's evals, and
    # so a batch's specs and their tie-breaks.
    card = server_world(dev, sc, smi, counted=True, guard_every=1)
    got = check_server_world(card, sc, on_card=on_card)
    shape_parity = server_shape_parity(dev, card["kernel_shapes"],
                                       on_card)
    cpu = server_world("cpu", sc, smi, guard_every=1)
    check_server_world(cpu, sc, on_card=False)
    keys = [k for k in card if k.startswith("after_")]
    for key in keys:
        if card[key] != cpu[key]:
            raise AssertionError(f"{key}: the card's allocs or eval "
                                 "statuses differ from the CPU's: "
                                 f"{content_diff(card[key], cpu[key])}")
    for label in ("main", "drill"):
        if card[label]["content"] != cpu[label]["content"]:
            raise AssertionError(
                f"{label}: the card's allocs or eval statuses differ from "
                "the CPU's: "
                f"{content_diff(card[label]['content'], cpu[label]['content'])}")
    for w in (card, cpu):
        for row in w["waves"]:
            emit({"phase": "server", "world": w["device"], **row})
    return {"card_equals_cpu": True, **got,
            "kernel_shapes": {k: sorted(v) for k, v in
                              card["kernel_shapes"].items()},
            "shape_parity": shape_parity,
            "node_register_s": {"card": card["node_register_s"],
                                "cpu": cpu["node_register_s"]},
            "launches": {k: card[k]["launches"] for k in ("main", "drill")},
            "applier_routes": {w["device"]: {k: w[k]["applier"]
                                             for k in ("main", "drill")}
                               for w in (card, cpu)},
            "columnar": {w["device"]: {k: w[k]["columnar"]
                                       for k in ("main", "drill")}
                         for w in (card, cpu)},
            "main_guard_every": {w["device"]: w["guard_every"]
                                 for w in (card, cpu)},
            "breaker": card["main"]["breaker"], "card": smi}


# -- phase 18: trace ---------------------------------------------------------

TRACE_SEED = 20261023
# What every acked eval's trace holds, in the order its spans start
# (tests/test_tracing.py:164-166, extended by the batch's phases), but
# the plan's three spans for an eval whose plan placed nothing (it
# submits none); and the log applies of its writes.
TRACE_LIFECYCLE = ("broker.enqueue", "broker.dequeue", "worker.process_batch",
                   "batch.schedule", "batch.phase1", "batch.phase2",
                   "batch.encode", "batch.device", "batch.fetch",
                   "batch.metrics", "batch.finalize", "worker.submit_plan",
                   "plan.evaluate", "plan.apply", "broker.ack")
TRACE_PLAN = ("worker.submit_plan", "plan.evaluate", "plan.apply")
TRACE_PHASES = ("batch.phase1", "batch.phase2", "batch.encode",
                "batch.device", "batch.fetch", "batch.metrics",
                "batch.finalize")
# Payload fields that carry indices: events compare without them.
TRACE_INDEX_FIELDS = ("PlanIndex", "AllocIndex", "SnapshotIndex",
                      "CachedIndex")
# The timing worlds: disarmed and armed, in turns, on the card.
TRACE_TIMING_TURNS = 3


class StreamConsumer:
    """A subscriber to ``srv``'s event stream from index 0, consumed live
    on a thread of its own, so the ring need not hold the run."""

    def __init__(self, srv):
        self.srv = srv
        self.sub = srv.event_stream_subscribe(from_index=0)
        self.events = []
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="event-consumer")
        self._thread.start()

    def _run(self):
        while True:
            ev = self.sub.next(timeout=0.05)
            if ev is not None:
                self.events.append(ev)
            elif self._done.is_set() or self.sub.closed:
                return

    def stop(self) -> dict:
        """Wait until the subscriber has taken every event published,
        then stop the thread: the events, the broker's stats (the
        subscriber still attached) and the subscriber's close error (None:
        never shed)."""
        from nomad_tpu_torch.utils.backoff import wait_until

        wait_until(lambda: self.sub.pending() == 0 or self.sub.closed,
                   30.0)
        stats = self.srv.stats()["events"]
        self._done.set()
        self._thread.join(timeout=30.0)
        if self._thread.is_alive():
            raise AssertionError("the event consumer did not stop")
        return {"events": self.events, "stats": stats,
                "shed": self.sub.close_error}


@contextlib.contextmanager
def batch_recorder(batches, parents):
    """Record each ``TorchBatchScheduler.schedule_batch``'s BatchStats by
    its evals (sorted ids) into ``batches``, and the span under which
    each ``eviction_sets`` launch runs into ``parents``."""
    from nomad_tpu_torch.ops import batch_sched, preempt
    from nomad_tpu_torch.utils import tracing

    cls = batch_sched.TorchBatchScheduler
    schedule, evict = cls.schedule_batch, preempt.eviction_sets

    def schedule_rec(self, evals):
        stats = schedule(self, evals)
        batches[tuple(sorted(ev.id for ev in evals))] = stats
        return stats

    def evict_rec(*args):
        tr = tracing.TRACER
        cur = tr.current() if tr is not None else None
        parents.append(cur.span_id if cur is not None else 0)
        return evict(*args)

    cls.schedule_batch, preempt.eviction_sets = schedule_rec, evict_rec
    try:
        yield
    finally:
        cls.schedule_batch, preempt.eviction_sets = schedule, evict


def trace_main(sc, out, armed, label):
    """The traced wave's body: the fleet through ``node_register``, then
    config (b)'s waves (each registered with the workers paused, then
    released), with a live subscriber from index 0 when ``armed``."""
    def main(srv):
        stream = StreamConsumer(srv) if armed else None
        t0 = time.perf_counter()
        for n in sc["nodes"]:
            srv.node_register(n)
        out[f"{label}_node_register_s"] = time.perf_counter() - t0
        for wave, fn in (
                ("config_b", lambda s: [s.job_register(j)
                                        for j in sc["wave_a"]]),
                ("follow_up", lambda s: [s.job_register(j)
                                         for j in sc["wave_b"]])):
            out["waves"].append(dict(server_wave(srv, wave, fn),
                                     server=label))
        trace_collect(srv, out, label, stream)
    return main


def trace_collect(srv, out, label, stream):
    """What the server did, read before its shutdown: each eval's trace,
    the stream, the plans applied and the committed allocs."""
    from nomad_tpu_torch.utils import tracing

    out[f"{label}_evals"] = [
        (e.id, e.job_id, e.triggered_by, e.status, e.create_index)
        for e in srv.state.evals(None)]
    out[f"{label}_traces"] = {e.id: tracing.trace_for_eval(e.id)
                              for e in srv.state.evals(None)}
    out[f"{label}_plans_applied"] = sample_totals(srv)["plan.apply"][0]
    out[f"{label}_allocs"] = len(srv.state.allocs(None))
    if stream is not None:
        out[f"{label}_stream"] = stream.stop()


def trace_world(dev, sc, smi, armed, checked=False) -> dict:
    """The traced wave on ``dev``, both planes ``armed`` or off (a fresh
    tracer each time); ``checked``: the kernels' counts set to 0 just
    before each server is driven and read just after, each batch's stats
    recorded, and the preempting drill on a second server."""
    from nomad_tpu_torch.ops import resident
    from nomad_tpu_torch.utils import tracing

    tracing.disable()
    # The resident mirror's one slot starts cold in every world, or the
    # first batch's NodeStateDelta would name the world before it.
    resident.invalidate()
    out = {"device": str(dev), "card": smi, "armed": armed, "waves": []}
    batches, parents = {}, []
    out["batches"], out["evict_parents"] = batches, parents
    cfg = {"trace": armed, "events": armed}
    try:
        with (batch_recorder(batches, parents) if checked
              else contextlib.nullcontext()):
            server_run(out, dev, "main", TRACE_SEED,
                       trace_main(sc, out, armed, "main"),
                       counted=checked, **cfg)
            if checked:
                drill = drill_waves(sc, out)

                def drill_traced(srv):
                    stream = StreamConsumer(srv) if armed else None
                    drill(srv)
                    trace_collect(srv, out, "drill", stream)

                server_run(out, dev, "drill", TRACE_SEED + 1, drill_traced,
                           counted=True, preemption_enabled=True, **cfg)
    finally:
        tracing.disable()
    return out


def trace_eval_key(evals):
    """Eval id -> (job, trigger, ordinal by create index): the same eval
    in two worlds whose ids differ."""
    seen = collections.Counter()
    out = {}
    for eid, job, trig, _status, _ci in sorted(
            evals, key=lambda e: (e[1], e[2], e[4])):
        out[eid] = (job, trig, seen[(job, trig)])
        seen[(job, trig)] += 1
    return out


def trace_event_key(ev, eval_job):
    """(topic, type, content key, payload) of one event: jobs and nodes
    by name, evals and allocs by their job, no index fields."""
    key = ev.key
    if ev.topic == "Eval" or (ev.topic == "Alloc"
                              and ev.type != "AllocPlacedBulk"):
        key = ev.payload.get("JobID") or eval_job.get(ev.key, "?")
    elif ev.topic == "Plan":
        key = eval_job.get(ev.key, "?")
    payload = tuple(sorted(
        (k, tuple(v) if isinstance(v, list) else v)
        for k, v in ev.payload.items() if k not in TRACE_INDEX_FIELDS))
    return (ev.topic, ev.type, key, payload)


def check_trace_world(w, sc, label, on_card) -> dict:
    """The armed world's checks of one server: every acked eval's
    lifecycle, each device batch's one fetch and its device span, and the
    stream (monotone, one PlanApplied per applied plan whose placements
    sum to the committed allocs, the registrations, never shed)."""
    errors = []
    evals, traces = w[f"{label}_evals"], w[f"{label}_traces"]
    acked = {eid: traces[eid] for eid, *_ in evals
             if any(sp["Name"] == "broker.ack" for sp in traces[eid])}
    # An acked eval of trigger job-register came through job_register (a
    # blocked follow-up keeps the trigger, but none is unblocked here):
    # its eval.e2e umbrella must be closed.
    registered = {eid for eid, _job, trig, *_ in evals
                  if trig == "job-register"}
    # The evals whose plan was applied: one PlanApplied each, by eval.
    st = w[f"{label}_stream"]
    planned = {e.key for e in st["events"] if e.type == "PlanApplied"}
    roots = {}
    for eid, spans in acked.items():
        by_name = {}
        for sp in spans:
            by_name.setdefault(sp["Name"], sp)
        order = [n for n in TRACE_LIFECYCLE
                 if eid in planned or n not in TRACE_PLAN]
        want = order + ["raft.apply"]
        if eid in registered:
            want.append("eval.e2e")
        missing = [n for n in want if n not in by_name]
        if missing:
            errors.append(f"{label}: eval {eid} misses {missing}")
            continue
        if eid not in planned and any(n in by_name for n in TRACE_PLAN):
            errors.append(f"{label}: eval {eid}: plan spans without a "
                          "PlanApplied")
        starts = [by_name[n]["Start"] for n in order]
        if starts != sorted(starts):
            errors.append(f"{label}: eval {eid}: starts out of order")
        root = by_name["batch.schedule"]
        if any(by_name[n]["ParentID"] != root["SpanID"]
               for n in TRACE_PHASES):
            errors.append(f"{label}: eval {eid}: a phase span is not "
                          "under batch.schedule")
        e2e = by_name.get("eval.e2e")
        if e2e is not None and (e2e["Attrs"].get("outcome") != "acked"
                                or e2e["End"] < by_name["broker.ack"][
                                    "Start"]):
            errors.append(f"{label}: eval {eid}: eval.e2e not closed at "
                          "the ack")
        for sp in spans:
            if sp["Name"] == "batch.schedule":
                roots[sp["SpanID"]] = (sp, spans)
    # Per batch: one fetch, the device span = BatchStats.device_seconds.
    batch_rows = []
    for sid, (root, spans) in roots.items():
        ids = tuple(sorted(root["Attrs"].get("eval_ids", ())))
        stats = w["batches"].get(ids)
        kids = [sp for sp in spans if sp["ParentID"] == sid]
        fetches = [sp for sp in kids if sp["Name"] == "batch.fetch"]
        device = [sp for sp in kids if sp["Name"] == "batch.device"]
        if stats is None:
            errors.append(f"{label}: no stats for batch {sid}")
            continue
        if not stats.device_ran:
            continue
        if len(fetches) != 1 or len(device) != 1:
            errors.append(f"{label}: batch {sid}: {len(fetches)} fetch, "
                          f"{len(device)} device spans")
            continue
        d = device[0]
        gap = abs((d["End"] - d["Start"]) - stats.device_seconds)
        if gap > 1e-6 or d["Attrs"].get("rounds") != stats.rounds:
            errors.append(f"{label}: batch {sid}: batch.device "
                          f"{d['End'] - d['Start']} s rounds "
                          f"{d['Attrs'].get('rounds')}, stats "
                          f"{stats.device_seconds} s {stats.rounds}")
        batch_rows.append({"evals": len(ids), "rounds": stats.rounds,
                           "device_s": stats.device_seconds,
                           "span_gap_s": gap})
    # The stream.
    events = st["events"]
    idx = [e.index for e in events]
    applied = [e for e in events if e.type == "PlanApplied"]
    node_keys = sorted(e.key for e in events
                       if e.type == "NodeRegistered")
    if idx != sorted(idx):
        errors.append(f"{label}: event indices decrease")
    if len(applied) != w[f"{label}_plans_applied"]:
        errors.append(f"{label}: {len(applied)} PlanApplied events, "
                      f"{w[f'{label}_plans_applied']} plans applied")
    if sum(e.payload["Placed"] for e in applied) != w[f"{label}_allocs"]:
        errors.append(f"{label}: PlanApplied placed "
                      f"{sum(e.payload['Placed'] for e in applied)}, "
                      f"{w[f'{label}_allocs']} allocs committed")
    fleet = (sc["nodes"] if label == "main"
             else sc["drill"][0] + sc["drill"][3])
    if node_keys != sorted(n.id for n in fleet):
        errors.append(f"{label}: {len(node_keys)} NodeRegistered events "
                      f"for {len(fleet)} registrations")
    if st["shed"] is not None or st["stats"]["max_subscriber_lag"]:
        errors.append(f"{label}: the subscriber was shed or lagging: "
                      f"{st['shed']} {st['stats']}")
    lc = w[label]["launches"]
    if on_card and (lc["scored_rows"] <= 0
                    or lc["scored_rows"] != lc["batch_commit_steps"]
                    or lc["scored_rows"] != lc["committing_spec_steps"]):
        errors.append(f"{label}: launches {lc}")
    r = w[label]
    if r["over_capacity"] or r["nacks"] or r["failed"] or r[
            "breaker"] != {"state": "closed", "trips": 0,
                           "oracle_routed": 0}:
        errors.append(f"{label}: health {r['breaker']}, {r['nacks']} "
                      f"nacks, {r['failed']} failed, "
                      f"{r['over_capacity']} over capacity")
    if errors:
        raise AssertionError(f"{w['device']}: {errors[:8]}")
    spans = sum(len(t) for t in acked.values())
    return {"acked_evals": len(acked), "device_batches": len(batch_rows),
            "batches": batch_rows, "spans_per_eval": spans / len(acked),
            "events": len(events), "events_per_eval": len(events)
            / len(acked), "launches": lc,
            "stream": st["stats"]}


def trace_multisets(w, label) -> dict:
    """What users see of one server's trace and stream, by content: per
    eval (job, trigger, ordinal), the multiset of span names; the
    multiset of events by (topic, type, content key, payload)."""
    key = trace_eval_key(w[f"{label}_evals"])
    eval_job = {eid: k[0] for eid, k in key.items()}
    spans = {key[eid]: sorted(sp["Name"] for sp in t)
             for eid, t in w[f"{label}_traces"].items()}
    events = collections.Counter(trace_event_key(e, eval_job)
                                 for e in w[f"{label}_stream"]["events"])
    return {"spans": spans, "events": events}


def trace_preempt_check(w) -> dict:
    """The drill's one eviction_sets launch ran in the batch whose
    batch.preempt span commits its outputs."""
    lc = w["drill"]["launches"]
    preempts = {}
    for spans in w["drill_traces"].values():
        for sp in spans:
            if sp["Name"] == "batch.preempt":
                preempts[sp["SpanID"]] = sp["ParentID"]
    if (lc["eviction_sets"] != 1 or len(preempts) != 1
            or list(preempts.values()) != w["evict_parents"]):
        raise AssertionError(
            f"drill: {lc['eviction_sets']} eviction_sets launches under "
            f"{w['evict_parents']}, batch.preempt spans {preempts}")
    return {"eviction_sets": 1, "batch_preempt_spans": 1}


def trace_sync_counts(dev, nodes, jobs, armed, trace_dir) -> dict:
    """One batch of ``jobs`` on ``nodes`` (a fresh store, ids seeded)
    inside a ``DeviceTracer`` session, the tracing plane armed or off:
    the session's device-to-host copies and synchronizations."""
    from nomad_tpu_torch.ops.batch_sched import TorchBatchScheduler
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.utils import tracing
    from nomad_tpu_torch.utils.profiling import DeviceTracer

    with seeded_world(TRACE_SEED, nodes, jobs) as (h, ids):
        evals = reg_evals(jobs, ids)
        tracer = DeviceTracer(base_dir=trace_dir, device=dev)
        if armed:
            tracing.enable()
        else:
            tracing.disable()
        tracer.start()
        try:
            stats = TorchBatchScheduler(
                h.logger, h.snapshot(), h, device=dev, rng_seed=SEED,
                breaker=KernelCircuitBreaker()).schedule_batch(evals)
        finally:
            info = tracer.stop()
            spans = len(tracing.recent(10_000))
            tracing.disable()
    with open(os.path.join(info["dir"], DeviceTracer.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    d2h = sum(1 for e in events if e.get("cat") == "gpu_memcpy"
              and "DtoH" in e.get("name", ""))
    syncs = collections.Counter(
        e["name"] for e in events if e.get("cat") == "cuda_runtime"
        and "ynchronize" in e.get("name", ""))
    copies = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                 and e.get("name", "").startswith("cudaMemcpy"))
    return {"d2h_copies": d2h, "memcpy_calls": copies,
            "syncs": dict(syncs), "spans": spans,
            "placed": len([a for a in h.state.allocs(None)
                           if not a.terminal_status()]),
            "device_seconds": stats.device_seconds,
            "rounds": stats.rounds}


def trace_sync_check(dev, sc) -> dict:
    """The armed plane adds no host-device sync: one traced and one
    untraced batch of the same input (config (b)'s follow-up jobs on the
    fleet, after an untimed warm batch) show the same copies and
    synchronizations in their ``DeviceTracer`` sessions."""
    import tempfile

    nodes, jobs = sc["nodes"], sc["wave_b"]
    with tempfile.TemporaryDirectory() as tmp:
        trace_sync_counts(dev, nodes, jobs, False,
                          os.path.join(tmp, "warm"))
        off = trace_sync_counts(dev, nodes, jobs, False,
                                os.path.join(tmp, "off"))
        on = trace_sync_counts(dev, nodes, jobs, True,
                               os.path.join(tmp, "on"))
    same = ("d2h_copies", "memcpy_calls", "syncs", "placed", "rounds")
    if (any(on[k] != off[k] for k in same) or not on["d2h_copies"]
            or not on["syncs"] or not on["spans"] or off["spans"]):
        raise AssertionError(f"sync contract: armed {on}, disarmed {off}")
    return {"armed": on, "disarmed": off}


def phase_trace(dev, n_nodes=10_000, n_jobs=100, count=1000,
                follow_jobs=10, follow_count=200, drill_nodes=64,
                turns=TRACE_TIMING_TURNS):
    """The observability plane on the server path: the traced wave on the
    card (checked: lifecycles, fetches, device spans, launches, the
    stream, the drill) and on the CPU, card = CPU on the trace's and the
    stream's multisets; the sync contract in ``DeviceTracer`` sessions;
    then the wave disarmed and armed in turns on the card, for its evals
    per second (printed, not gated)."""
    t0 = time.perf_counter()
    smi = smi_name_power()
    on_card = torch_device(dev).type == "cuda"
    sc = server_scenario(n_nodes, n_jobs, count, follow_jobs, follow_count,
                         0, 0, drill_nodes)
    card = trace_world(dev, sc, smi, armed=True, checked=True)
    got = {"main": check_trace_world(card, sc, "main", on_card),
           "drill": check_trace_world(card, sc, "drill", on_card)}
    if on_card:
        got["preempt"] = trace_preempt_check(card)
    cpu = trace_world("cpu", sc, smi, armed=True)
    for label in ("main",):
        a, b = trace_multisets(card, label), trace_multisets(cpu, label)
        for what in ("spans", "events"):
            if a[what] != b[what]:
                if what == "spans":
                    diff = {k: (a[what].get(k), b[what].get(k))
                            for k in set(a[what]) | set(b[what])
                            if a[what].get(k) != b[what].get(k)}
                else:
                    diff = {"card_only": list((a[what] - b[what]))[:8],
                            "cpu_only": list((b[what] - a[what]))[:8]}
                raise AssertionError(f"{label}: the card's {what} differ "
                                     f"from the CPU's: "
                                     f"{str(diff)[:3000]}")
    got["card_equals_cpu"] = True
    if on_card:
        got["sync"] = trace_sync_check(dev, sc)
    # Evals per second, disarmed and armed in turns, in this call.
    rates = {"disarmed": [], "armed": []}
    for _ in range(turns):
        for mode in ("disarmed", "armed"):
            w = trace_world(dev, sc, smi, armed=mode == "armed")
            rates[mode].append({r["wave"]: r["evals_per_s"]
                                for r in w["waves"]})
    for w in (card, cpu):
        for row in w["waves"]:
            emit({"phase": "trace", "world": w["device"], **row})
    return {**got, "evals_per_s": rates,
            "spans_per_eval": got["main"]["spans_per_eval"],
            "events_per_eval": got["main"]["events_per_eval"],
            "launches": {k: card[k]["launches"] for k in ("main", "drill")},
            "seconds": time.perf_counter() - t0, "card": smi}


# -- phase 19: plan ----------------------------------------------------------

PLAN_SEED = 20261021
# Edited versions of batch 0's first jobs, by kind; then new jobs.
PLAN_EDITS = (("count", 7), ("env", 7), ("constraint", 6))


def plan_jobs(jobs0, n_new, new_count):
    """The dry run's jobs, made once for every world: new versions of
    batch 0's first jobs -- their count raised by 100, a task env edit
    (destructive), a job-level constraint edited (in place) -- and
    ``n_new`` jobs not registered yet.  Returns ``[(kind, job)]``."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import structs as ps

    out = []
    old = iter(jobs0)
    for kind, n in PLAN_EDITS:
        for _ in range(n):
            j = next(old).copy()
            if kind == "count":
                j.task_groups[0].count += 100
            elif kind == "env":
                t = j.task_groups[0].tasks[0]
                t.env = dict(t.env, PLAN_EDIT="1")
            else:
                j.constraints = [ps.Constraint("${attr.arch}", "x86", "=")]
            out.append((kind, j))
    out += [("new", strip_job(mock.job(), new_count, cpu=100, mem=128))
            for _ in range(n_new)]
    return out


def store_allocs(store):
    return sorted((a.id, a.node_id, a.desired_status, a.client_status,
                   a.modify_index) for a in store.allocs(None))


def plan_world(dev, nodes, jobs0, edits, smi, counted):
    """Config (b)'s batch 0 into a fresh Harness on ``dev``, then every
    edited and new job as an ``annotate_plan`` eval, in one batch, over a
    snapshot holding their new versions, into a Harness over that
    snapshot (the dry run of ``Server.job_plan``); ids seeded."""
    from nomad_tpu_torch.ops.batch_sched import TorchBatchScheduler
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.scheduler.testing import Harness

    with seeded_world(PLAN_SEED, nodes, jobs0) as (h, ids):
        brk = KernelCircuitBreaker()
        TorchBatchScheduler(h.logger, h.snapshot(), h, device=dev,
                            rng_seed=SEED, breaker=brk).schedule_batch(
            reg_evals(jobs0, ids))
        before = store_allocs(h.state)
        snap = h.state.snapshot()
        for _, j in edits:
            snap.upsert_job(h.next_index(), j)
        dry = Harness(snap)
        dry._next_index = h.next_index()
        evals = reg_evals([j for _, j in edits], ids)
        for ev in evals:
            ev.annotate_plan = True

        def run():
            return TorchBatchScheduler(
                h.logger, snap.snapshot(), dry, device=dev,
                rng_seed=SEED + 1, breaker=brk).schedule_batch(evals)

        st, counts = run_counted(run) if counted else (run(), {})
        return {"h": h, "dry": dry, "stats": st, "counts": counts,
                "evals": evals, "allocs_before": before,
                "allocs_after": store_allocs(h.state)}


def batch_split(st) -> dict:
    """A batch's seconds by part (``BatchStats``)."""
    return {k: getattr(st, k) for k in (
        "phase1_seconds", "phase2_seconds", "encode_seconds",
        "device_seconds", "metrics_seconds", "finalize_seconds",
        "total_seconds")}


def plan_annotations(p):
    import dataclasses

    return None if p.annotations is None else dataclasses.asdict(
        p.annotations)


def plan_server(dev, nodes, job, edit, smi):
    """``Server.job_plan`` of ``edit`` on a port ``Server`` on ``dev``
    holding ``nodes`` and the registered ``job``: the response as plain
    data (no ids), and the store before and after the dry run."""
    import dataclasses

    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.server import Server, ServerConfig

    srv = Server(ServerConfig(device=dev, rng_seed=SERVER_SEED,
                              min_heartbeat_ttl=SERVER_HEARTBEAT_TTL,
                              breaker=KernelCircuitBreaker()))
    try:
        with seeded_ids(PLAN_SEED + 1):
            srv.start()
            for n in nodes:
                srv.node_register(n)
            srv.job_register(job)
            server_settle(srv)

            def view():
                stored = srv.state.job_by_id(None, job.id)
                return (server_content(srv), srv.raft.applied_index(),
                        stored.version, stored.task_groups[0].count)

            before = view()
            resp = srv.job_plan(edit)
            after = view()
    finally:
        srv.shutdown()
    return {"diff": dataclasses.asdict(resp.diff),
            "annotations": plan_annotations(resp),
            "failed_tg_allocs": {k: metric_row(m) for k, m in
                                 resp.failed_tg_allocs.items()},
            "job_modify_index": resp.job_modify_index,
            "created_evals": [(e.job_id, e.triggered_by, e.status)
                              for e in resp.created_evals],
            "next_periodic_launch": resp.next_periodic_launch,
            "untouched": before == after, "card": smi}


def phase_plan(dev, n_nodes=10_000, n_jobs=100, count=1000, n_new=5,
               server_nodes=1_000):
    """The ``job plan`` dry run at config (b) width: annotate-plan evals
    through ``TorchBatchScheduler`` on the card and on the CPU, the
    diffs and annotations of every edited job, and ``Server.job_plan``
    on the card against the CPU."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler.annotate import (
        ANNOTATION_FORCES_CREATE, ANNOTATION_FORCES_DESTRUCTIVE_UPDATE,
        annotate)
    from nomad_tpu_torch.structs.diff import job_diff

    smi = smi_name_power()
    on_card = torch_device(dev).type == "cuda"
    nodes = [strip_node(mock.node()) for _ in range(n_nodes)]
    jobs0 = [strip_job(mock.job(), count) for _ in range(n_jobs)]
    edits = plan_jobs(jobs0, n_new, count)
    card = plan_world(dev, nodes, jobs0, edits, smi, counted=True)
    cpu = plan_world("cpu", nodes, jobs0, edits, smi, counted=False)
    for w in (card, cpu):
        if w["allocs_after"] != w["allocs_before"]:
            raise AssertionError("the dry run changed the store's allocs")
        st = w["stats"]
        if st.oracle_routed or not st.device_ran:
            raise AssertionError(f"oracle_routed {st.oracle_routed}, "
                                 f"device_ran {st.device_ran}")
    dry, cdry = card["dry"], cpu["dry"]
    differ = [name for name, view in (
        ("plans", lambda d: [plan_rows(p) for p in d.plans]),
        ("annotations", lambda d: [plan_annotations(p) for p in d.plans]),
        ("eval updates", eval_rows),
        ("created evals", lambda d: [e.job_id for e in d.create_evals]))
        if view(dry) != view(cdry)]
    if differ:
        raise AssertionError(f"the card's dry-run {differ} differ from the "
                             "CPU's")
    counts = card["counts"]
    if on_card and (counts["scored_rows_launches"] <= 0
                    or counts["scored_rows_launches"]
                    != counts["committing_spec_steps"]):
        raise AssertionError(f"launches {counts}")
    # Each job's diff against the stored version, annotated with its
    # plan's desired updates.
    plan_of = {p.eval_id: p for p in dry.plans}
    h = card["h"]
    kinds = {}
    for (kind, job), ev in zip(edits, card["evals"]):
        plan = plan_of.get(ev.id)
        if plan is None or plan.annotations is None:
            raise AssertionError(f"{kind} {job.id}: no annotated plan")
        diff = job_diff(h.state.job_by_id(None, job.id), job)
        annotate(diff, plan.annotations)
        tg = diff.task_groups[0] if diff.task_groups else None
        task = tg.tasks[0] if tg is not None and tg.tasks else None
        count_field = next((f for f in tg.fields if f.name == "Count"),
                           None) if tg is not None else None
        ok = {
            "count": count_field is not None
            and count_field.annotations == [ANNOTATION_FORCES_CREATE],
            "env": task is not None
            and task.annotations == [ANNOTATION_FORCES_DESTRUCTIVE_UPDATE],
            "constraint": not diff.task_groups and any(
                o.name == "Constraint" for o in diff.objects),
            "new": diff.type == "Added" and task is not None
            and task.annotations == [ANNOTATION_FORCES_CREATE],
        }[kind]
        if not ok:
            raise AssertionError(f"{kind} {job.id}: diff {diff}")
        up = plan.annotations.desired_tg_updates["web"]
        row = kinds.setdefault(kind, {"jobs": 0, "place": 0, "stop": 0,
                                      "in_place_update": 0,
                                      "destructive_update": 0,
                                      "ignore": 0})
        row["jobs"] += 1
        for k in row:
            if k != "jobs":
                row[k] += getattr(up, k)
    failed = {e.job_id: {k: metric_row(m) for k, m in
                         e.failed_tg_allocs.items()}
              for e in dry.evals if e.failed_tg_allocs}

    # Server.job_plan: the same response from a server on the card and
    # one on the CPU, the store untouched.
    job = strip_job(mock.job(), count)
    job.id = job.name = "plan-job"
    edit = job.copy()
    edit.task_groups[0].count += 100
    t = edit.task_groups[0].tasks[0]
    t.env = dict(t.env, PLAN_EDIT="1")
    srv_card = plan_server(dev, nodes[:server_nodes], job, edit, smi)
    srv_cpu = plan_server("cpu", nodes[:server_nodes], job, edit, smi)
    if srv_card != srv_cpu or not srv_card["untouched"]:
        raise AssertionError(f"job_plan: card {srv_card}, cpu {srv_cpu}")
    st = card["stats"]
    return {"card_equals_cpu": True, "evals": len(edits),
            "plans": len(dry.plans), "by_kind": kinds,
            "failed_groups": len(failed), "created_evals": len(
                dry.create_evals),
            "store_untouched": True, "oracle_routed": st.oracle_routed,
            "rounds": st.rounds, "split": batch_split(st),
            "cpu_split": batch_split(cpu["stats"]),
            "scored_rows_launches": counts.get("scored_rows_launches", 0),
            "committing_spec_steps": counts.get("committing_spec_steps", 0),
            "job_plan": {k: srv_card[k] for k in (
                "annotations", "failed_tg_allocs", "job_modify_index",
                "created_evals")},
            "card": smi}


# -- phase 20: fingerprint ---------------------------------------------------

FINGERPRINT_SEED = 20261022
# The fingerprints that open a socket (a route probe, the cloud metadata
# address): left out of the builtin list while this phase runs
# ``fingerprint_node``, since the smoke contacts no host off the machine.
SOCKET_FINGERPRINTS = ("network", "env_aws", "env_gce")


def trace_kernel_events(trace_dir, name):
    """The kernel events of a ``DeviceTracer`` session whose name holds
    ``name``."""
    from nomad_tpu_torch.utils.profiling import DeviceTracer

    with open(os.path.join(trace_dir, DeviceTracer.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events
            if e.get("cat") == "kernel" and name in e.get("name", "")]


def fingerprint_world(dev, nodes, jobs, trace_dir=None):
    """The constrained jobs through ``TorchBatchScheduler`` into a fresh
    Harness on ``dev`` (ids seeded); with ``trace_dir``, inside a
    ``DeviceTracer`` session there, the launch counts set to 0 just
    before the batch and read just after."""
    from nomad_tpu_torch.ops.batch_sched import TorchBatchScheduler
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.utils.profiling import DeviceTracer

    out = {}
    with seeded_world(FINGERPRINT_SEED, nodes, jobs) as (h, ids):
        evals = reg_evals(jobs, ids)

        def run():
            return TorchBatchScheduler(
                h.logger, h.snapshot(), h, device=dev, rng_seed=SEED,
                breaker=KernelCircuitBreaker()).schedule_batch(evals)

        if trace_dir is None:
            out["stats"] = run()
        else:
            tracer = DeviceTracer(base_dir=trace_dir, device=dev)
            tracer.start()
            try:
                try:
                    tracer.start()
                    out["second_start_refused"] = False
                except RuntimeError:
                    out["second_start_refused"] = True
                out["stats"], out["counts"] = run_counted(run)
            finally:
                out["session"] = tracer.stop()
    out["h"] = h
    return out


def phase_fingerprint(dev, n_nodes=10_000, gpu_every=4, n_jobs=10,
                      count=1000):
    """The GPU fingerprint on the card, then jobs constrained on its
    attributes placed on the nodes that carry them, inside a
    ``DeviceTracer`` session."""
    import tempfile
    from unittest.mock import patch as mock_patch

    import torch

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.client import ClientConfig, fingerprint as fp
    from nomad_tpu_torch.structs import structs as ps

    smi = smi_name_power()
    on_card = torch_device(dev).type == "cuda"
    cfg = ClientConfig(options={"fingerprint.gpu.enable": "true"})
    node = ps.Node()
    if not fp.GPUFingerprint().fingerprint(cfg, node):
        raise AssertionError("the GPU fingerprint did not apply")
    want = {"gpu.count": str(torch.cuda.device_count()),
            "gpu.type": torch.cuda.get_device_name(0), "driver.gpu": "1"}
    if node.attributes != want:
        raise AssertionError(f"GPU fingerprint {node.attributes}, "
                             f"want {want}")
    local = [f for f in fp.BUILTIN_FINGERPRINTS
             if f.name not in SOCKET_FINGERPRINTS]
    with mock_patch.object(fp, "BUILTIN_FINGERPRINTS", local):
        applied = fp.fingerprint_node(cfg, ps.Node(resources=None))
    if "gpu" not in applied:
        raise AssertionError(f"fingerprint_node applied {applied}")

    nodes = [strip_node(mock.node()) for _ in range(n_nodes)]
    for n in nodes[::gpu_every]:
        n.attributes.update(want)
        n.compute_class()
    gpu_nodes = {n.id for n in nodes[::gpu_every]}
    jobs = []
    for _ in range(n_jobs):
        j = strip_job(mock.job(), count)
        j.constraints += [
            ps.Constraint("${attr.gpu.type}", want["gpu.type"], "="),
            ps.Constraint("${attr.driver.gpu}", "1", "=")]
        jobs.append(j)
    with tempfile.TemporaryDirectory() as tmp:
        card = fingerprint_world(dev, nodes, jobs, trace_dir=tmp)
        events = trace_kernel_events(card["session"]["dir"], "scored_rows")
    cpu = fingerprint_world("cpu", nodes, jobs)
    h = card["h"]
    placed = [a for a in h.state.allocs(None) if not a.terminal_status()]
    off = [a.id for a in placed if a.node_id not in gpu_nodes]
    counts = card["counts"]
    launches = counts["scored_rows_launches"]
    errors = []
    if len(placed) != n_jobs * count or off:
        errors.append(f"{len(placed)} placed, {len(off)} off the "
                      "fingerprinted nodes")
    over = store_over_capacity(h)
    if over:
        errors.append(f"{over} nodes over capacity")
    if ([plan_rows(p) for p in h.plans]
            != [plan_rows(p) for p in cpu["h"].plans]):
        errors.append("the card's plans differ from the CPU's")
    if not card["second_start_refused"]:
        errors.append("a second start() during the session was taken")
    if card["stats"].oracle_routed:
        errors.append(f"oracle_routed {card['stats'].oracle_routed}")
    if on_card and (launches <= 0 or len(events) != launches
                    or launches != counts["committing_spec_steps"]):
        errors.append(f"{len(events)} scored_rows events in the trace, "
                      f"counts {counts}")
    if errors:
        raise AssertionError(f"fingerprint: {errors}")
    return {"attributes": want, "fingerprint_node": applied,
            "gpu_nodes": len(gpu_nodes), "placed": len(placed),
            "off_fingerprinted_nodes": 0, "nodes_over_capacity": 0,
            "card_equals_cpu": True, "second_start_refused": True,
            "session_s": card["session"]["duration_s"],
            "trace_scored_rows_events": len(events),
            "scored_rows_launches": launches,
            "committing_spec_steps": counts["committing_spec_steps"],
            "split": batch_split(card["stats"]),
            "cpu_split": batch_split(cpu["stats"]), "card": smi}


# -- phase 21: durable -------------------------------------------------------

DURABLE_SEED = 20261024
DURABLE_TORN = "torn-job"
DURABLE_CHILD_TIMEOUT = 400.0
# Every world of the phase runs in a process of its own with this string
# hash seed: the server's walks over id-keyed sets (a node's jobs when a
# node goes down, the reconciler's) order its evals and tie-breaks, so
# worlds compare only under one hash order.
DURABLE_HASH_SEED = 20261024
# Phase 17's fleet and config (b)'s waves; wave 3 and the follow-up.
DURABLE_SIZES = {"n_nodes": 10_000, "n_jobs": 100, "count": 1000,
                 "wave_jobs": 10, "wave_count": 200, "follow_jobs": 5}


def durable_scenario(n_nodes, n_jobs, count, wave_jobs, wave_count,
                     follow_jobs):
    """Phase 17's fleet and config (b)'s waves (``n_jobs`` x ``count``,
    then ``wave_jobs`` x ``wave_count`` and one node down), wave 3
    (``wave_jobs`` x ``wave_count``), the follow-up after the restart
    (``follow_jobs`` x ``wave_count``) and the job whose registration the
    crash tears."""
    from nomad_tpu_torch import mock

    sc = server_scenario(n_nodes, n_jobs, count, wave_jobs, wave_count, 0,
                         1, 0)
    wave3 = [strip_job(mock.job(), wave_count, cpu=100, mem=128)
             for _ in range(wave_jobs)]
    follow = [strip_job(mock.job(), wave_count, cpu=100, mem=128)
              for _ in range(follow_jobs)]
    for k, j in enumerate(wave3 + follow):
        j.id = j.name = f"job-{n_jobs + wave_jobs + k:03d}"
    torn = strip_job(mock.job(), 10, cpu=100, mem=128)
    torn.id = torn.name = DURABLE_TORN
    sc.update(wave3=wave3, follow=follow, torn=torn)
    return sc


def fs_type(path) -> str:
    """The filesystem type of ``path`` (``stat -f -c %T``)."""
    return subprocess.run(["stat", "-f", "-c", "%T", path],
                          capture_output=True, text=True,
                          timeout=30).stdout.strip()


def durable_content(srv) -> dict:
    """``server_content`` and the queued count of every job's groups, as
    JSON gives them back (so a child's report compares)."""
    out = server_content(srv)
    st = srv.state
    queued = {}
    for job_id in sorted({e.job_id for e in st.evals(None)}):
        summ = st.job_summary_by_id(None, job_id)
        if summ is not None:
            queued[job_id] = {tg: v.queued
                              for tg, v in sorted(summ.summary.items())}
    out["queued"] = queued
    return json.loads(json.dumps(out))


class apply_timer:
    """Records the wall time of every ``raft.apply`` of ``srv`` (the log's
    whole commit: write, durability wait, the sequencer and the FSM);
    with ``by_type`` the summary also splits them by message type."""

    def __init__(self, srv, by_type=False):
        self.raft, self.ms, self.types = srv.raft, [], []
        self.by_type = by_type
        inner = srv.raft.apply

        def timed(msg_type, payload):
            t0 = time.perf_counter()
            try:
                return inner(msg_type, payload)
            finally:
                self.ms.append((time.perf_counter() - t0) * 1e3)
                self.types.append(getattr(msg_type, "name", str(msg_type)))

        srv.raft.apply = timed

    def reset(self) -> None:
        self.ms, self.types = [], []

    @staticmethod
    def _stats(ms) -> dict:
        import numpy as np

        a = np.asarray(ms or [0.0])
        return {"applies": len(ms), "mean_ms": float(a.mean()),
                "p99_ms": float(np.percentile(a, 99))}

    def summary(self) -> dict:
        out = self._stats(self.ms)
        if self.by_type:
            groups = collections.defaultdict(list)
            for name, ms in zip(self.types, self.ms):
                groups[name].append(ms)
            out["by_type"] = {k: self._stats(v)
                              for k, v in sorted(groups.items())}
        return out


def durable_server(dev, data_dir=""):
    """A port ``Server`` for phase ``durable`` on ``dev`` (on a
    ``FileLog`` in ``data_dir``, with fsync, or on an ``InmemLog``),
    constructed and started before any id is seeded, so its store's
    lineage is its own; automatic snapshots off, every columnar guard at
    every read.  Building it on a data dir recovers the store."""
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.server import Server, ServerConfig

    brk = KernelCircuitBreaker()
    t0 = time.perf_counter()
    srv = Server(ServerConfig(
        device=dev, rng_seed=SERVER_SEED, batch_size=64,
        min_heartbeat_ttl=SERVER_HEARTBEAT_TTL, breaker=brk,
        columnar_guard_every=1, data_dir=data_dir, snapshot_entries=0,
        snapshot_bytes=0))
    built_s = time.perf_counter() - t0
    return srv, brk, built_s


def durable_health(srv, brk) -> dict:
    b = srv.eval_broker.stats()
    return {"breaker": {"state": brk.state, "trips": brk.trips,
                        "oracle_routed": server_counter(
                            srv, "breaker.oracle_routed")},
            "nacks": b["total_nacks"], "failed": b["total_failed"],
            "over_capacity": store_over_capacity(srv)}


def zero_launches(srv) -> float:
    """Set the kernels' launch counts to 0; returns the server's count of
    committing steps so far, for :func:`durable_launches`."""
    from nomad_tpu_torch.ops import fused_score, kernels, preempt

    fused_score.LAUNCHES = kernels.COMMIT_STEPS = 0
    fused_score.MASKED_LAUNCHES = preempt.LAUNCHES = 0
    return server_counter(srv, "batch.commit_steps")


def durable_launches(srv, steps0) -> dict:
    """The launch counts since :func:`zero_launches` returned
    ``steps0``, and the committing steps the batches reported since."""
    from nomad_tpu_torch.ops import fused_score, kernels, preempt

    return {"scored_rows": fused_score.LAUNCHES,
            "masked_score_matrix": fused_score.MASKED_LAUNCHES,
            "eviction_sets": preempt.LAUNCHES,
            "committing_spec_steps": kernels.COMMIT_STEPS,
            "batch_commit_steps": server_counter(
                srv, "batch.commit_steps") - steps0}


def durable_before(srv, sc, ids, out) -> None:
    """Steps 1-3 before the crash: the fleet registered, wave 1 to
    settled, ``raft.snapshot()`` (a no-op on ``InmemLog``), wave 2 and one
    node down, then wave 3's jobs registered with the workers paused
    (their evals stay pending).  The launch counts are set to 0 just
    before and read just after (with the wave-3 registration, which
    launches nothing)."""
    steps0 = zero_launches(srv)
    with ids:
        t0 = time.perf_counter()
        for n in sc["nodes"]:
            srv.node_register(n)
        out["node_register_s"] = time.perf_counter() - t0
        out["waves"] = [server_wave(srv, "wave1", lambda s: [
            s.job_register(j) for j in sc["wave_a"]])]
        t0 = time.perf_counter()
        srv.raft.snapshot()
        out["snapshot_s"] = time.perf_counter() - t0
        out["snapshot_bytes"] = getattr(srv.raft, "last_snapshot_bytes", 0)

        def wave2(s):
            for j in sc["wave_b"]:
                s.job_register(j)
            host = sorted({a.node_id for a in s.state.allocs(None)
                           if a.job_id == sc["wave_a"][0].id})[0]
            out["down_host"] = host
            s.node_update_status(host, "down")

        out["waves"].append(server_wave(srv, "wave2_node_down", wave2))
        if not srv.set_workers_paused(True, timeout=SERVER_SETTLE_TIMEOUT):
            raise AssertionError("durable: workers did not park")
        for j in sc["wave3"]:
            srv.job_register(j)
    out["launches_before"] = durable_launches(srv, steps0)
    out["acked_index"] = srv.raft.applied_index()
    out["before"] = durable_content(srv)
    out["pending"] = sorted(e.job_id for e in srv.state.evals(None)
                            if e.status == "pending")
    out["draws"] = ids.draws


def durable_after(srv, sc, ids, out, start=None) -> None:
    """Step 6: wave 3 scheduled, then the follow-up.  On a restarted
    server ``start`` starts it: its leadership re-enqueues wave 3's
    pending evals and the workers take them (the wave's wall time runs
    from the start to settled); on the twin the paused workers are
    released.  Launch counts and the resident mirror's counters are set
    to 0 just before, read just after."""
    from nomad_tpu_torch.ops import resident

    steps0 = zero_launches(srv)
    resident.reset_counters()
    with ids:
        if start is None:
            out["waves_after"] = [server_wave(srv, "wave3", lambda s: None)]
        else:
            acks0 = server_counter(srv, "broker.ack")
            t0 = time.perf_counter()
            start()
            wall = server_settle(srv) - t0
            acked = int(server_counter(srv, "broker.ack") - acks0)
            out["waves_after"] = [{"wave": "wave3", "wall_s": wall,
                                   "evals_acked": acked,
                                   "evals_per_s": acked / wall}]
        out["after_wave3"] = durable_content(srv)
        out["waves_after"].append(server_wave(srv, "follow", lambda s: [
            s.job_register(j) for j in sc["follow"]]))
    out["launches_after"] = durable_launches(srv, steps0)
    out["resident"] = {"full_reencodes": resident.FULL_REENCODES,
                       "hits": resident.HITS,
                       "guard_mismatches": resident.GUARD_MISMATCHES,
                       "dev_guard_mismatches":
                           resident.DEV_GUARD_MISMATCHES}
    out["after"] = durable_content(srv)
    out["applier"] = {k: srv.plan_applier.stats[k] for k in (
        "plans", "columnar", "columnar_guards")}


def durable_crash(dev, data_dir, sizes) -> dict:
    """Worlds (A) and (C) before the crash: steps 1-3 on a ``FileLog`` in
    ``data_dir``, then one more entry (the torn job's registration) under
    a ``wal.fsync`` crash.  The caller's process then dies: no
    ``shutdown()``, no final snapshot, nothing closed."""
    from nomad_tpu_torch import fault
    from nomad_tpu_torch.state import columnar as colmod

    sc = durable_scenario(**sizes)
    colmod.reset_counters()
    srv, brk, _ = durable_server(dev, data_dir)
    srv.start()
    timer = apply_timer(srv)
    out = {"device": dev, "fs": fs_type(data_dir)}
    ids = seeded_ids(DURABLE_SEED)
    durable_before(srv, sc, ids, out)
    out["raft_apply"] = timer.summary()
    out["entries_written"] = srv.raft.entries_written
    out["fsyncs"] = srv.raft.fsyncs()
    with fault.scenario({"seed": DURABLE_SEED, "faults": [
            {"point": "wal.fsync", "action": "crash", "times": 1,
             "match": {"msg_type": "JOB_REGISTER"}}]}):
        try:
            srv.job_register(sc["torn"])
            out["crashed"] = False
        except fault.InjectedFault:
            out["crashed"] = True
        out["fault_trace"] = fault.trace()
    out["draws_after_crash"] = ids.draws
    out["health"] = durable_health(srv, brk)
    out["columnar"] = columnar_counters()
    return out


def durable_child(mode, dev, data_dir, out_path, sizes, skip=0) -> None:
    """One world's part of phase ``durable`` in a process of its own:
    ``crash`` (``durable_crash``; the process then dies with
    ``os._exit``), ``restart`` (``durable_restart``) or ``twin``
    (``durable_twin``); the report is written to ``out_path``."""
    if mode == "crash":
        out = durable_crash(dev, data_dir, sizes)
    elif mode == "restart":
        out = durable_restart(dev, data_dir, skip, sizes)
    else:
        out = durable_twin(dev, sizes)
    with open(out_path, "w") as fh:
        json.dump(out, fh)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run_durable_child(mode, dev, data_dir, sizes, skip=0) -> dict:
    """``durable_child`` in a fresh process with the phase's fixed string
    hash seed; its report."""
    out_path = os.path.join(data_dir, f"{mode}-{dev}.json")
    code = ("import sys; sys.path.insert(0, {0!r}); import chip_smoke as c; "
            "c.durable_child({1!r}, {2!r}, {3!r}, {4!r}, {5!r}, {6!r})"
            ).format(REPO, mode, dev, data_dir, out_path, sizes, skip)
    env = dict(os.environ, PYTHONHASHSEED=str(DURABLE_HASH_SEED))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True,
                          timeout=DURABLE_CHILD_TIMEOUT)
    if proc.returncode != 0 or not os.path.exists(out_path):
        raise AssertionError(f"durable {mode} child on {dev}: rc "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    with open(out_path) as fh:
        out = json.load(fh)
    os.unlink(out_path)
    out["child_wall_s"] = time.perf_counter() - t0
    return out


def durable_restart(dev, data_dir, skip, sizes) -> dict:
    """Steps 5-7: the server rebuilt on ``data_dir`` (the recovery and
    its split), started (its leadership re-enqueues wave 3's pending
    evals), step 6's waves with the ids drawn after the first ``skip``
    (the crashed process drew those), ``raft.snapshot()``, and a restart
    from the snapshot alone."""
    from nomad_tpu_torch.ops import resident
    from nomad_tpu_torch.state import columnar as colmod

    sc = durable_scenario(**sizes)
    resident.invalidate()
    colmod.reset_counters()
    out = {"device": dev, "fs": fs_type(data_dir)}
    t0 = time.perf_counter()
    srv, brk, built_s = durable_server(dev, data_dir)
    rec = dict(srv.raft.recovery)
    rec["server_build_s"] = built_s
    rec["replay_entries_per_s"] = (
        rec["replayed_entries"] / rec["replay_apply_s"]
        if rec["replay_apply_s"] else None)
    out["recovery"] = rec
    out["mirror_from_snapshot"] = (srv.state._columns is not None
                                   and colmod.REBUILDS == 0)
    out["recovered_index"] = srv.raft.applied_index()
    out["recovered"] = durable_content(srv)
    out["torn_absent"] = srv.state.job_by_id(None, DURABLE_TORN) is None
    try:
        timer = apply_timer(srv)
        ids = seeded_ids(DURABLE_SEED)
        ids.skip(skip)

        def start():
            t1 = time.perf_counter()
            srv.start()
            rec["leadership_s"] = time.perf_counter() - t1
            rec["total_s"] = time.perf_counter() - t0

        durable_after(srv, sc, ids, out, start=start)
        out["raft_apply"] = timer.summary()
        out["health"] = durable_health(srv, brk)
        out["columnar"] = columnar_counters()
        t1 = time.perf_counter()
        srv.raft.snapshot()
        out["snapshot_s"] = time.perf_counter() - t1
        out["snapshot_bytes"] = srv.raft.last_snapshot_bytes
        out["applied_final"] = srv.raft.applied_index()
    finally:
        srv.shutdown()
    srv2, _, _ = durable_server(dev, data_dir)
    try:
        out["from_snapshot"] = durable_content(srv2)
        out["from_snapshot_recovery"] = dict(srv2.raft.recovery)
        out["from_snapshot_index"] = srv2.raft.applied_index()
    finally:
        srv2.shutdown()
    return out


def durable_twin(dev, sizes) -> dict:
    """World (B): the same steps on an uninterrupted ``InmemLog`` server,
    no crash."""
    from nomad_tpu_torch.ops import resident
    from nomad_tpu_torch.state import columnar as colmod

    sc = durable_scenario(**sizes)
    resident.invalidate()
    colmod.reset_counters()
    srv, brk, _ = durable_server(dev)
    out = {"device": dev}
    try:
        srv.start()
        timer = apply_timer(srv)
        ids = seeded_ids(DURABLE_SEED)
        durable_before(srv, sc, ids, out)
        out["raft_apply"] = timer.summary()
        durable_after(srv, sc, ids, out)
        out["health"] = durable_health(srv, brk)
        out["columnar"] = columnar_counters()
    finally:
        srv.shutdown()
    return out


def same_commits(a, b) -> dict:
    """Where two ``durable_content`` views differ (empty: equal)."""
    def rows(c):
        return {**c, **{k: [tuple(r) for r in c[k]]
                        for k in ("allocs", "evals")}}

    diff = content_diff(rows(a), rows(b))
    if a["queued"] != b["queued"]:
        diff["queued"] = {k: (a["queued"].get(k), b["queued"].get(k))
                          for k in set(a["queued"]) | set(b["queued"])
                          if a["queued"].get(k) != b["queued"].get(k)}
    return diff


def check_launches(label, counts, need_launch=True) -> list:
    """One ``scored_rows`` launch per committing step in one part of a
    card world's run (at least one when ``need_launch``), and no other
    kernel's launch."""
    if ((need_launch and counts["scored_rows"] <= 0)
            or counts["scored_rows"] != counts["committing_spec_steps"]
            or counts["scored_rows"] != counts["batch_commit_steps"]
            or counts["masked_score_matrix"] or counts["eviction_sets"]):
        return [f"{label}: launches {counts}"]
    return []


def check_durable_launches(label, before, after) -> list:
    return (check_launches(f"{label} before the crash", before)
            + check_launches(f"{label} after the restart", after))


def check_durable(child, restart, label, on_card, sc) -> list:
    """Steps 5-7's checks of one crashed world."""
    errors = []
    if not child["crashed"] or child["fault_trace"] != [
            ["wal.fsync", 0, "crash"]]:
        errors.append(f"{label}: the wal.fsync crash did not fire: "
                      f"{child['fault_trace']}")
    if restart["recovered_index"] != child["acked_index"]:
        errors.append(f"{label}: recovered index "
                      f"{restart['recovered_index']} != the last "
                      f"acknowledged {child['acked_index']}")
    rec, before = restart["recovered"], child["before"]
    for key in ("allocs", "evals", "queued"):
        if rec[key] != before[key]:
            errors.append(f"{label}: restored {key} differ from the "
                          f"pre-crash content: "
                          f"{str(same_commits(rec, before))[:2000]}")
    if not restart["torn_absent"]:
        errors.append(f"{label}: the torn entry was applied")
    if not restart["mirror_from_snapshot"]:
        errors.append(f"{label}: the columnar mirror was not installed "
                      "from the snapshot's column section")
    if restart["recovery"]["snapshot_index"] <= 0:
        errors.append(f"{label}: recovery did not start from a snapshot")
    wave3 = [j.id for j in sc["wave3"]]
    if not set(wave3) <= set(child["pending"]):
        errors.append(f"{label}: wave 3's evals were not pending at the "
                      f"crash: {child['pending']}")
    after = restart["after_wave3"]
    for job_id in wave3:
        if [e for e in after["evals"] if e[0] == job_id
                and e[1] == "job-register" and e[2] != "complete"]:
            errors.append(f"{label}: wave 3's eval of {job_id} was not "
                          "re-enqueued and completed after the restart")
    if (restart["from_snapshot_recovery"]["replayed_entries"] != 0
            or restart["from_snapshot_index"] != restart["applied_final"]):
        errors.append(f"{label}: the restart from the snapshot replayed "
                      f"{restart['from_snapshot_recovery']}")
    for key in ("allocs", "evals", "queued"):
        if restart["from_snapshot"][key] != restart["after"][key]:
            errors.append(f"{label}: the content restored from the "
                          f"snapshot alone differs in {key}")
    if on_card:
        errors += check_durable_launches(
            label, child["launches_before"], restart["launches_after"])
    res = restart["resident"]
    if (res["full_reencodes"] != 1 or res["hits"] < 1
            or res["guard_mismatches"] or res["dev_guard_mismatches"]):
        errors.append(f"{label}: the resident mirror after the restore: "
                      f"{res}")
    return errors


def check_world_health(w, label) -> list:
    errors = []
    h, c = w["health"], w["columnar"]
    if (h["over_capacity"] or h["nacks"] or h["failed"]
            or h["breaker"] != {"state": "closed", "trips": 0,
                                "oracle_routed": 0}):
        errors.append(f"{label}: health {h}")
    if (c["GUARD_MISMATCHES"] or c["USAGE_GUARD_MISMATCHES"]
            or not c["GUARD_RUNS"] or not c["USAGE_GUARD_RUNS"]):
        errors.append(f"{label}: columnar guards {c}")
    app = w.get("applier")
    if app is not None and (not app["columnar_guards"]
                            or app["columnar"] != app["plans"]):
        errors.append(f"{label}: the applier's routes {app}")
    return errors


def phase_durable(dev, sizes=None):
    """The durable server (see the module docstring, phase 21): (A) the
    card server on a ``FileLog``, crashed in a process of its own and
    restarted in another, (B) its uninterrupted twin on ``InmemLog``,
    (C) the CPU server on a ``FileLog``, crashed and restarted the same
    way; every world in a process of its own under one string hash seed
    (``DURABLE_HASH_SEED``), compared here."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    smi = smi_name_power()
    on_card = torch_device(dev).type == "cuda"
    sizes = dict(DURABLE_SIZES if sizes is None else sizes)
    sc = durable_scenario(**sizes)
    root = tempfile.mkdtemp(prefix="nomad-torch-durable-")
    try:
        dirs = {k: os.path.join(root, k) for k in ("A", "C")}
        for d in dirs.values():
            os.makedirs(d)
        t0 = time.perf_counter()
        a_child = run_durable_child("crash", dev, dirs["A"], sizes)
        a = run_durable_child("restart", dev, dirs["A"], sizes,
                              a_child["draws_after_crash"])
        t_a = time.perf_counter() - t0
        t0 = time.perf_counter()
        b = run_durable_child("twin", dev, root, sizes)
        t_b = time.perf_counter() - t0
        t0 = time.perf_counter()
        c_child = run_durable_child("crash", "cpu", dirs["C"], sizes)
        c = run_durable_child("restart", "cpu", dirs["C"], sizes,
                              c_child["draws_after_crash"])
        t_c = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)

    errors = check_durable(a_child, a, "A", on_card, sc)
    errors += check_durable(c_child, c, "C", False, sc)
    if a_child["draws_after_crash"] != b["draws"]:
        errors.append(f"ids drawn before the crash: A "
                      f"{a_child['draws_after_crash']}, B {b['draws']}")
    for key, mine, others in (
            ("before", a_child, ((b, "B"), (c_child, "C"))),
            ("after_wave3", a, ((b, "B"), (c, "C"))),
            ("after", a, ((b, "B"), (c, "C")))):
        for other, label in others:
            diff = same_commits(mine[key], other[key])
            if diff:
                errors.append(f"{key}: A differs from {label}: "
                              f"{str(diff)[:2000]}")
    if on_card:
        errors += check_durable_launches("B", b["launches_before"],
                                         b["launches_after"])
    for w, label in ((a_child, "A before the crash"), (a, "A"), (b, "B"),
                     (c_child, "C before the crash"), (c, "C")):
        errors += check_world_health(w, label)
    if errors:
        raise AssertionError(f"phase durable: {errors}")

    for w, label in ((a_child, "A"), (b, "B"), (c_child, "C")):
        for row in w["waves"]:
            emit({"phase": "durable", "world": label, **row})
    for w, label in ((a, "A"), (b, "B"), (c, "C")):
        for row in w["waves_after"]:
            emit({"phase": "durable", "world": label, "after_restart":
                  label != "B", **row})

    def wave1_rate(w):
        return w["waves"][0]["evals_per_s"]

    return {
        "card": smi, "fs": {"A": a["fs"], "C": c["fs"]},
        "restored_equals_pre_crash": True, "torn_entry_absent": True,
        "a_equals_b_equals_c": True,
        "recovery": {"A": a["recovery"], "C": c["recovery"]},
        "recovered_index": a["recovered_index"],
        "replay_entries": a["recovery"]["replayed_entries"],
        "raft_apply": {"FileLog_A_before_crash": a_child["raft_apply"],
                       "FileLog_A_after_restart": a["raft_apply"],
                       "InmemLog_B": b["raft_apply"],
                       "FileLog_C_before_crash": c_child["raft_apply"]},
        "fsyncs_per_apply": {
            "A": a_child["fsyncs"] / max(1, a_child["entries_written"]),
            "C": c_child["fsyncs"] / max(1, c_child["entries_written"])},
        "wave1_evals_per_s": {"A": wave1_rate(a_child),
                              "B": wave1_rate(b),
                              "C": wave1_rate(c_child)},
        "snapshot_bytes_10k": {"after_wave1": a_child["snapshot_bytes"],
                               "final": a["snapshot_bytes"]},
        "snapshot_s": {"after_wave1": a_child["snapshot_s"],
                       "final": a["snapshot_s"]},
        "resident_after_restore": a["resident"],
        "launches": {"A_before_crash": a_child["launches_before"],
                     "A_after_restart": a["launches_after"],
                     "B": {k: b["launches_before"][k]
                           + b["launches_after"][k]
                           for k in b["launches_after"]}},
        "columnar": {"A": a["columnar"], "B": b["columnar"],
                     "C": c["columnar"]},
        "world_seconds": {"A": t_a, "A_crash_child": a_child["child_wall_s"],
                          "A_restart_child": a["child_wall_s"],
                          "B": t_b, "C": t_c},
        "seconds": time.perf_counter() - t_phase}


# -- phase 22: cluster -------------------------------------------------------

CLUSTER_SEED = 20261025
CLUSTER_CHILD_TIMEOUT = 420.0
# Every world of the phase runs in a process of its own under this string
# hash seed (node-update evals follow set order; queue 3 item 13).
CLUSTER_HASH_SEED = 20261025
# The loaded-host election timing of the reference's loadgen harness
# (nomad_tpu/loadgen/harness.py:45-47): the three servers share one
# process and the card's batches hold the GIL in stretches.
CLUSTER_RAFT = {"raft_heartbeat": 0.2, "raft_election_min": 5.0,
                "raft_election_max": 8.0}
CLUSTER_ELECTION_TIMEOUT = 60.0
# Leg 1: phase 17's fleet, config (b)'s wave 1 (100 x 1000), wave 2
# (10 x 200) and a follow-up (10 x 200).  Leg 2: its fleet and jobs.
CLUSTER_SIZES = {"n_nodes": 10_000, "n_jobs": 100, "count": 1000,
                 "wave_jobs": 10, "wave_count": 200, "follow_jobs": 10}
LEG2_SIZES = {"n_nodes": 2_000, "n_jobs": 200, "count": 20}
CLUSTER_STEPS = ("nodes", "wave1", "wave2_paused", "leader_down",
                 "restored", "node_down", "follow")


def cluster_scenario(n_nodes, n_jobs, count, wave_jobs, wave_count,
                     follow_jobs):
    """Phase 17's fleet and config (b)'s waves (``n_jobs`` x ``count``,
    then ``wave_jobs`` x ``wave_count``), and the follow-up
    (``follow_jobs`` x ``wave_count``)."""
    from nomad_tpu_torch import mock

    sc = server_scenario(n_nodes, n_jobs, count, wave_jobs, wave_count, 0,
                         1, 0)
    follow = [strip_job(mock.job(), wave_count, cpu=100, mem=128)
              for _ in range(follow_jobs)]
    for k, j in enumerate(follow):
        j.id = j.name = f"job-{n_jobs + wave_jobs + k:03d}"
    sc["follow"] = follow
    return sc


def cluster_servers(dev, brk, follower_scheduling, single=False):
    """Three port servers over loopback TCP (the first the seed), or one
    ``Server`` on the in-memory log; constructed before any id is
    seeded, every columnar guard at every read."""
    from nomad_tpu_torch.server import Server, ServerConfig

    common = dict(device=dev, rng_seed=SERVER_SEED, batch_size=64,
                  min_heartbeat_ttl=SERVER_HEARTBEAT_TTL, breaker=brk,
                  columnar_guard_every=1)
    if single:
        return [Server(ServerConfig(**common))]
    servers, first = [], None
    for i in range(3):
        srv = Server(ServerConfig(
            node_name=f"cluster-{i + 1}", enable_rpc=True,
            bootstrap_expect=3, start_join=[first] if first else [],
            follower_scheduling=follower_scheduling, **CLUSTER_RAFT,
            **common))
        first = first or srv.config.rpc_advertise
        servers.append(srv)
    return servers


def cluster_leader(servers, timeout=CLUSTER_ELECTION_TIMEOUT):
    """The elected leader of ``servers`` (its raft leads and its
    leadership is established); raises past ``timeout``."""
    from nomad_tpu_torch.utils.backoff import wait_until

    def lead():
        return next((x for x in servers
                     if x.is_leader() and getattr(
                         x.raft, "is_raft_leader", lambda: True)()), None)

    if not wait_until(lambda: lead() is not None, timeout,
                      max_interval=0.02):
        raise AssertionError("cluster: no leader in "
                             f"{timeout} s: {[x.stats() for x in servers]}")
    return lead()


def cluster_fingerprints(servers) -> list:
    """Every server's (index, digest) once they agree (30 s at most)."""
    from nomad_tpu_torch.utils.backoff import wait_until

    wait_until(lambda: len({x.fsm_fingerprint() for x in servers}) == 1,
               30.0, max_interval=0.05)
    return [list(x.fsm_fingerprint()) for x in servers]


def cluster_pause(servers) -> None:
    for x in servers:
        if not x.set_workers_paused(True, timeout=SERVER_SETTLE_TIMEOUT):
            raise AssertionError("cluster: workers did not park")


def cluster_release(servers) -> None:
    for x in servers:
        x.set_workers_paused(False)


def resident_counts() -> dict:
    from nomad_tpu_torch.ops import resident

    return {"full_reencodes": resident.FULL_REENCODES,
            "hits": resident.HITS, "guard_runs": resident.GUARD_RUNS,
            "guard_mismatches": resident.GUARD_MISMATCHES,
            "dev_guard_mismatches": resident.DEV_GUARD_MISMATCHES}


def cluster_leg1(dev, sizes, single=False) -> dict:
    """One world of leg 1: the script on three servers (A on the card, C
    on the CPU) or on one (B), with the counts set to 0 just before each
    leader's part and read just after."""
    from nomad_tpu_torch.ops import resident
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.state import columnar as colmod

    sc = cluster_scenario(**sizes)
    resident.invalidate()
    colmod.reset_counters()
    brk = KernelCircuitBreaker()
    servers = cluster_servers(dev, brk, False, single=single)
    out = {"device": dev, "single": single, "contents": {}}
    t0 = time.perf_counter()
    for x in servers:
        x.start()
    lead = cluster_leader(servers)
    out["first_leader_s"] = time.perf_counter() - t0
    alive = list(servers)
    followers = [x for x in servers if x is not lead]
    ids = seeded_ids(CLUSTER_SEED)
    try:
        if not single:
            from nomad_tpu_torch.utils.backoff import wait_until

            if not wait_until(lambda: all(len(x.raft.peers) == 3
                                          for x in servers), 30.0):
                raise AssertionError("cluster: the voter set did not form")
        timer = apply_timer(lead, by_type=True)
        steps0 = zero_launches(lead)
        with ids:
            t0 = time.perf_counter()
            for i, n in enumerate(sc["nodes"]):
                via = followers[0] if followers and i % 5 == 4 else lead
                via.node_register(n)
            out["node_register_s"] = time.perf_counter() - t0
            out["contents"]["nodes"] = durable_content(lead)
            out["waves"] = [server_wave(lead, "wave1", lambda s: [
                s.job_register(j) for j in sc["wave_a"]])]
            out["contents"]["wave1"] = durable_content(lead)
            cluster_pause(alive)
            via = followers[0] if followers else lead
            for j in sc["wave_b"]:
                via.job_register(j)
            out["contents"]["wave2_paused"] = durable_content(lead)
        out["launches_before"] = durable_launches(lead, steps0)
        out["raft_apply_before"] = timer.summary()
        out["acked_index"] = lead.raft.applied_index()
        out["old_leader_health"] = durable_health(lead, brk)
        out["old_leader_forwards"] = server_counter(lead, "rpc.forward")
        t_kill = time.perf_counter()
        if not single:
            # Its broker first: a worker released from its pause by
            # stop() would take wave 2 on its way out.
            lead.eval_broker.set_enabled(False)
            lead.shutdown()
            alive.remove(lead)
            lead = cluster_leader(alive)
            out["kill_to_leader_s"] = time.perf_counter() - t_kill
            out["new_leader_applied"] = lead.raft.applied_index()
            out["contents"]["leader_down"] = durable_content(lead)
            from nomad_tpu_torch.utils.backoff import wait_until

            if not wait_until(lambda: lead.eval_broker.stats()[
                    "total_ready"] == len(sc["wave_b"]),
                    SERVER_SETTLE_TIMEOUT):
                raise AssertionError("cluster: the new leader did not "
                                     "re-enqueue wave 2")
            timer = apply_timer(lead, by_type=True)
        else:
            timer.reset()
        steps1 = zero_launches(lead)
        # Read, not reset: a reset drops the mirror, and whether the new
        # leader's first batch finds it is what is measured.
        res0 = resident_counts()
        with ids:
            acks0 = server_counter(lead, "broker.ack")
            t0 = time.perf_counter()
            cluster_release(alive)
            settled = server_settle(lead)
            acked = int(server_counter(lead, "broker.ack") - acks0)
            out["waves"].append({"wave": "wave2", "wall_s": settled - t0,
                                 "evals_acked": acked,
                                 "evals_per_s": acked / (settled - t0)})
            out["kill_to_wave2_settled_s"] = settled - t_kill
            out["contents"]["restored"] = durable_content(lead)
            host = sorted({a.node_id for a in lead.state.allocs(None)
                           if a.job_id == sc["wave_a"][0].id})[0]
            out["waves"].append(server_wave(
                lead, "node_down",
                lambda s: s.node_update_status(host, "down")))
            out["contents"]["node_down"] = durable_content(lead)
            out["waves"].append(server_wave(lead, "follow", lambda s: [
                s.job_register(j) for j in sc["follow"]]))
            out["contents"]["follow"] = durable_content(lead)
        out["launches_after"] = durable_launches(lead, steps1)
        out["raft_apply_after"] = timer.summary()
        out["resident"] = {k: v - res0[k]
                           for k, v in resident_counts().items()}
        out["fingerprints"] = cluster_fingerprints(alive)
        out["forwarded_writes"] = sum(server_counter(x, "rpc.forward")
                                      for x in servers)
        out["health"] = durable_health(lead, brk)
        out["columnar"] = columnar_counters()
        out["applier"] = {k: lead.plan_applier.stats[k] for k in (
            "plans", "columnar", "columnar_guards")}
        out["draws"] = ids.draws
    finally:
        for x in alive:
            x.shutdown()
    return out


def cluster_leg2(dev, sizes) -> dict:
    """Leg 2: follower-read scheduling (the leader's ``BatchWorker`` on
    ``dev``, each follower's worker on the CPU schedulers), the leader
    killed mid-drain at a seeded point."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.utils.backoff import wait_until

    rng = random.Random(CLUSTER_SEED)
    nodes = []
    for i in range(sizes["n_nodes"]):
        n = strip_node(mock.node())
        n.id = n.name = f"leg2-{i:05d}"
        nodes.append(n)
    jobs = []
    for k in range(sizes["n_jobs"]):
        j = strip_job(mock.job(), sizes["count"])
        j.id = j.name = f"leg2-job-{k:03d}"
        jobs.append(j)
    kill_after = rng.randint(sizes["n_jobs"] // 4, sizes["n_jobs"] // 2)
    brk = KernelCircuitBreaker()
    servers = cluster_servers(dev, brk, True)
    out = {"device": dev, "kill_after_complete": kill_after}
    for x in servers:
        x.start()
    alive = list(servers)
    try:
        lead = cluster_leader(servers)
        if not wait_until(lambda: all(len(x.raft.peers) == 3
                                      for x in servers), 30.0):
            raise AssertionError("leg 2: the voter set did not form")
        old = lead
        steps0 = zero_launches(lead)
        t0 = time.perf_counter()
        for n in nodes:
            lead.node_register(n)
        out["node_register_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        eval_ids = [lead.job_register(j)[1] for j in jobs]

        def complete(srv):
            st = srv.state
            return sum(1 for e in eval_ids
                       if (ev := st.eval_by_id(None, e)) is not None
                       and ev.status == "complete")

        if not wait_until(lambda: complete(lead) >= kill_after,
                          SERVER_SETTLE_TIMEOUT, max_interval=0.005):
            raise AssertionError("leg 2: the drain did not start")
        out["complete_at_kill"] = complete(lead)
        # The survivors' card workers stay parked until the new leader's
        # counts are set to 0; their follower workers go on scheduling.
        cluster_pause([x for x in alive if x is not lead])
        t_kill = time.perf_counter()
        lead.shutdown()
        alive.remove(lead)
        wait_until(lambda: not old.threads(), 30.0)
        out["launches_old_leader"] = durable_launches(old, steps0)
        out["old_leader_channel"] = old.leader_channel.stats()
        lead = cluster_leader(alive)
        out["kill_to_leader_s"] = time.perf_counter() - t_kill
        steps1 = zero_launches(lead)
        cluster_release(alive)
        if not wait_until(lambda: all(
                (ev := lead.state.eval_by_id(None, e)) is not None
                and ev.terminal_status() for e in eval_ids),
                SERVER_SETTLE_TIMEOUT, max_interval=0.01):
            raise AssertionError("leg 2: the drain did not finish")
        out["drain_s"] = time.perf_counter() - t0
        out["kill_to_drained_s"] = time.perf_counter() - t_kill
        server_settle(lead)
        out["launches_new_leader"] = durable_launches(lead, steps1)
        st = lead.state
        out["eval_statuses"] = sorted({st.eval_by_id(None, e).status
                                       for e in eval_ids})
        by_job = collections.defaultdict(list)
        for a in st.allocs(None):
            if not a.terminal_status():
                by_job[a.job_id].append(a)
        out["jobs_wrong_count"] = sorted(
            j.id for j in jobs
            if len(by_job[j.id]) != sizes["count"]
            or len({a.name for a in by_job[j.id]}) != sizes["count"]
            or len({a.id for a in by_job[j.id]}) != sizes["count"])
        out["over_capacity"] = store_over_capacity(lead)
        out["fingerprints"] = cluster_fingerprints(alive)
        out["follower_channels"] = [x.leader_channel.stats()
                                    for x in servers if x is not old]
        out["lag_handbacks"] = sum(server_counter(x, "follower.lag_handback")
                                   for x in servers)
        out["follower_evals_scheduled"] = sum(
            server_counter(x, "follower.evals_scheduled") for x in servers)
        out["snapshot_lag"] = {
            x.config.node_name: x.metrics.sink.latest()["SampleTotals"].get(
                "nomad.follower.snapshot_lag", (0, 0.0))
            for x in servers}
        out["health"] = durable_health(lead, brk)
        out["old_health"] = durable_health(old, brk)
    finally:
        for x in alive:
            x.shutdown()
    return out


def cluster_child(mode, dev, out_path, sizes) -> None:
    """One world of phase ``cluster`` in a process of its own: ``leg1``
    (three servers), ``single`` (B) or ``leg2``; the report is written to
    ``out_path``."""
    if mode == "leg2":
        out = cluster_leg2(dev, sizes)
    else:
        out = cluster_leg1(dev, sizes, single=mode == "single")
    with open(out_path, "w") as fh:
        json.dump(out, fh)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run_cluster_child(mode, dev, root, sizes) -> dict:
    """``cluster_child`` in a fresh process with the phase's fixed string
    hash seed; its report."""
    out_path = os.path.join(root, f"{mode}-{dev}.json")
    code = ("import sys; sys.path.insert(0, {0!r}); import chip_smoke as c; "
            "c.cluster_child({1!r}, {2!r}, {3!r}, {4!r})"
            ).format(REPO, mode, dev, out_path, sizes)
    env = dict(os.environ, PYTHONHASHSEED=str(CLUSTER_HASH_SEED))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True,
                          timeout=CLUSTER_CHILD_TIMEOUT)
    if proc.returncode != 0 or not os.path.exists(out_path):
        raise AssertionError(f"cluster {mode} child on {dev}: rc "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    with open(out_path) as fh:
        out = json.load(fh)
    os.unlink(out_path)
    out["child_wall_s"] = time.perf_counter() - t0
    return out


def check_cluster_world(w, label, on_card) -> list:
    """Leg 1's checks of one cluster world."""
    errors = []
    if len({tuple(fp) for fp in w["fingerprints"]}) != 1:
        errors.append(f"{label}: survivors' fingerprints {w['fingerprints']}")
    if w["new_leader_applied"] < w["acked_index"]:
        errors.append(f"{label}: the new leader applied "
                      f"{w['new_leader_applied']} < the last acknowledged "
                      f"{w['acked_index']}")
    if on_card:
        errors += check_launches(f"{label} before the failover",
                                 w["launches_before"])
        errors += check_launches(f"{label} after the failover",
                                 w["launches_after"])
    res = w["resident"]
    if res["guard_mismatches"] or res["dev_guard_mismatches"]:
        errors.append(f"{label}: the resident mirror after the failover: "
                      f"{res}")
    if w["old_leader_health"]["nacks"] or w["old_leader_health"]["failed"]:
        errors.append(f"{label}: the old leader's broker "
                      f"{w['old_leader_health']}")
    return errors


def check_leg2(w, sizes, on_card) -> list:
    errors = []
    if w["eval_statuses"] != ["complete"]:
        errors.append(f"leg 2: eval statuses {w['eval_statuses']}")
    if w["jobs_wrong_count"]:
        errors.append(f"leg 2: jobs without exactly {sizes['count']} "
                      f"distinct allocs: {w['jobs_wrong_count'][:10]}")
    if w["over_capacity"]:
        errors.append(f"leg 2: {w['over_capacity']} nodes over capacity")
    if len({tuple(fp) for fp in w["fingerprints"]}) != 1:
        errors.append(f"leg 2: survivors' fingerprints {w['fingerprints']}")
    if sum(c["ForwardedPlans"] for c in w["follower_channels"]) < 1:
        errors.append(f"leg 2: no plan forwarded {w['follower_channels']}")
    if w["old_leader_channel"]["ForwardedPlans"] != 0:
        errors.append(f"leg 2: the leader's own channel forwarded "
                      f"{w['old_leader_channel']}")
    if on_card:
        # The followers may finish the drain with the new leader's
        # workers launching nothing.
        errors += check_launches("leg 2 old leader",
                                 w["launches_old_leader"])
        errors += check_launches("leg 2 new leader",
                                 w["launches_new_leader"],
                                 need_launch=False)
    for key in ("health", "old_health"):
        h = w[key]
        if h["breaker"] != {"state": "closed", "trips": 0,
                            "oracle_routed": 0} or h["over_capacity"]:
            errors.append(f"leg 2 {key}: {h}")
    return errors


def phase_cluster(dev, sizes=None, leg2_sizes=None):
    """The replicated cluster (see the module docstring, phase 22): leg
    1's worlds A (three servers on the card), B (one server on the card,
    no failover) and C (three servers on the CPU), then leg 2 on the
    card; every world in a process of its own under one string hash
    seed, compared here."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    smi = smi_name_power()
    on_card = torch_device(dev).type == "cuda"
    sizes = dict(CLUSTER_SIZES if sizes is None else sizes)
    leg2_sizes = dict(LEG2_SIZES if leg2_sizes is None else leg2_sizes)
    root = tempfile.mkdtemp(prefix="nomad-torch-cluster-")
    secs = {}
    try:
        worlds = {}
        for label, mode, d in (("A", "leg1", dev), ("B", "single", dev),
                               ("C", "leg1", "cpu")):
            t0 = time.perf_counter()
            worlds[label] = run_cluster_child(mode, d, root, sizes)
            secs[label] = time.perf_counter() - t0
        t0 = time.perf_counter()
        leg2 = run_cluster_child("leg2", dev, root, leg2_sizes)
        secs["leg2"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    a, b, c = worlds["A"], worlds["B"], worlds["C"]

    errors = check_cluster_world(a, "A", on_card)
    errors += check_cluster_world(c, "C", False)
    # Every fifth node and wave 2's jobs went through a follower.
    want_fwd = sizes["n_nodes"] // 5 + sizes["wave_jobs"]
    for w, label in ((a, "A"), (c, "C")):
        if w["forwarded_writes"] != want_fwd:
            errors.append(f"{label}: {w['forwarded_writes']} forwarded "
                          f"writes, not {want_fwd}")
    for step in CLUSTER_STEPS:
        diff = same_commits(a["contents"][step], c["contents"][step])
        if diff:
            errors.append(f"{step}: A differs from C: {str(diff)[:2000]}")
    if a["draws"] != c["draws"]:
        errors.append(f"ids drawn: A {a['draws']}, C {c['draws']}")
    a_vs_b = {}
    for step in CLUSTER_STEPS:
        if step in b["contents"]:
            diff = same_commits(a["contents"][step], b["contents"][step])
            if diff:
                a_vs_b[step] = diff
    # The new leader's store was built by replication, a lineage of its
    # own: one full re-encode more than B's (whose node-down makes one),
    # then the same hits.
    for w, label in ((a, "A"), (c, "C")):
        res, res_b = w["resident"], b["resident"]
        if (res["full_reencodes"] != res_b["full_reencodes"] + 1
                or res["hits"] != res_b["hits"] - 1 or res["hits"] < 1):
            errors.append(f"{label}: the resident mirror after the "
                          f"failover {res}, B {res_b}")
    if on_card:
        errors += check_launches("B", {
            k: b["launches_before"][k] + b["launches_after"][k]
            for k in b["launches_after"]})
    for w, label in ((a, "A"), (b, "B"), (c, "C")):
        errors += check_world_health(w, label)
    errors += check_leg2(leg2, leg2_sizes, on_card)
    for w, label in ((a, "A"), (b, "B"), (c, "C")):
        for row in w["waves"]:
            emit({"phase": "cluster", "world": label, **row})
    if a_vs_b:
        # The first differing rows, printed; PERF.md says why.
        emit({"phase": "cluster", "a_vs_b": {
            k: str(v)[:1500] for k, v in a_vs_b.items()}})
    if errors:
        raise AssertionError(f"phase cluster: {errors}")

    def wave(w, name, key="evals_per_s"):
        return next(r[key] for r in w["waves"] if r["wave"] == name)

    def both_leaders(x):
        return {k: x["launches_old_leader"][k] + x["launches_new_leader"][k]
                for k in x["launches_new_leader"]}

    return {
        "card": smi, "a_equals_c": True, "a_equals_b": not a_vs_b,
        "a_vs_b_steps": sorted(a_vs_b),
        "fingerprints_equal": True,
        "first_leader_s": {"A": a["first_leader_s"], "C": c["first_leader_s"]},
        "kill_to_leader_s": {"A": a["kill_to_leader_s"],
                             "C": c["kill_to_leader_s"],
                             "leg2": leg2["kill_to_leader_s"]},
        "kill_to_wave2_settled_s": {"A": a["kill_to_wave2_settled_s"],
                                    "C": c["kill_to_wave2_settled_s"]},
        "acked_index": a["acked_index"],
        "new_leader_applied": a["new_leader_applied"],
        "node_register_s": {"A_multiraft": a["node_register_s"],
                            "B_inmem": b["node_register_s"],
                            "C_multiraft": c["node_register_s"]},
        "raft_apply": {"A_before_failover": a["raft_apply_before"],
                       "A_after_failover": a["raft_apply_after"],
                       "B_inmem": b["raft_apply_before"],
                       "B_inmem_after": b["raft_apply_after"],
                       "C_before_failover": c["raft_apply_before"]},
        "wave1_evals_per_s": {"A": wave(a, "wave1"), "B": wave(b, "wave1"),
                              "C": wave(c, "wave1")},
        "forwarded_writes": {"A": a["forwarded_writes"],
                             "C": c["forwarded_writes"]},
        "resident_after_failover": {"A": a["resident"],
                                    "B": b["resident"]},
        "launches": {"A_before_failover": a["launches_before"],
                     "A_after_failover": a["launches_after"],
                     "B": {k: b["launches_before"][k]
                           + b["launches_after"][k]
                           for k in b["launches_after"]},
                     "leg2": both_leaders(leg2),
                     "leg2_old_leader": leg2["launches_old_leader"],
                     "leg2_new_leader": leg2["launches_new_leader"]},
        "leg2": {k: leg2[k] for k in (
            "kill_after_complete", "complete_at_kill", "node_register_s",
            "drain_s", "kill_to_drained_s", "lag_handbacks",
            "follower_evals_scheduled", "snapshot_lag",
            "follower_channels", "old_leader_channel")},
        "columnar": {"A": a["columnar"], "B": b["columnar"],
                     "C": c["columnar"]},
        "world_seconds": {**secs,
                          **{f"{k}_child": w["child_wall_s"] for k, w in
                             (("A", a), ("B", b), ("C", c),
                              ("leg2", leg2))}},
        "seconds": time.perf_counter() - t_phase}


# -- phase 23: lifecycle -----------------------------------------------------

LIFECYCLE_SEED = 20261026
LIFECYCLE_CHILD_TIMEOUT = 400.0
# Every world of the phase runs in a process of its own under this string
# hash seed (node-update evals follow set order; queue 3 item 13).
LIFECYCLE_HASH_SEED = 20261026
# The clock of the launches and dispatches (both worlds share it; the
# periodic parents' test specs lie ten days past it).
LIFECYCLE_NOW = 1_900_000_000.0
LIFECYCLE_SIZES = {"n_nodes": 10_000, "n_prod": 30, "n_periodic": 10,
                   "count": 1000, "n_dispatch": 10, "quota": 25_000,
                   "wave2_dispatch": 5, "timer_count": 100}
# Allocs marked complete per node_update_allocs call.
LIFECYCLE_UPDATE_CHUNK = 1000
LIFECYCLE_TIMER_DELAY = 3.0
LIFECYCLE_TIMER_TIMEOUT = 30.0
DISPATCH_ID = re.compile(r"(.+)/dispatch-(\d+)-[0-9a-f]{8}")


def lifecycle_scenario(n_nodes, n_prod, n_periodic, count, n_dispatch,
                       quota, wave2_dispatch, timer_count):
    """The phase's fleet and jobs: ``mock.node()`` nodes, ``prod``'s
    service jobs, ``batch``'s periodic parents on a test spec ten days
    past the phase's clock, the parameterized parent (one required meta
    key, payload optional) and the timer's parent."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import structs as ps

    nodes = []
    for i in range(n_nodes):
        n = strip_node(mock.node())
        n.id = f"node-{i:05d}"
        nodes.append(n)

    def job(job_id, ns, type_, n_asks):
        j = strip_job(mock.job(), n_asks)
        j.id = j.name = job_id
        j.namespace = ns
        j.type = type_
        return j

    prod = [job(f"prod-{k:02d}", "prod", ps.JOB_TYPE_SERVICE, count)
            for k in range(n_prod)]
    periodic = []
    for k in range(n_periodic):
        j = job(f"per-{k:02d}", "batch", ps.JOB_TYPE_BATCH, count)
        j.periodic = ps.PeriodicConfig(
            enabled=True, spec=str(LIFECYCLE_NOW + 10 * 86400),
            spec_type=ps.PERIODIC_SPEC_TEST)
        periodic.append(j)
    par = job("par", "batch", ps.JOB_TYPE_BATCH, count)
    par.parameterized_job = ps.ParameterizedJobConfig(
        payload="optional", meta_required=["k"])
    timer = job("timer", "batch", ps.JOB_TYPE_BATCH, timer_count)
    return {"nodes": nodes, "prod": prod, "periodic": periodic, "par": par,
            "timer": timer, "n_dispatch": n_dispatch, "quota": quota,
            "wave2_dispatch": wave2_dispatch}


class lifecycle_clock:
    """While active, the launch clock (the periodic module's
    ``time.time``) and the dispatch clock (``structs.now``) read ``t``."""

    def __init__(self, t):
        self.t = t

    def time(self):
        return self.t

    def __enter__(self):
        import types

        from nomad_tpu_torch.server import periodic
        from nomad_tpu_torch.structs import structs

        self.saved = periodic.time, structs.now
        periodic.time = types.SimpleNamespace(time=self.time)
        structs.now = self.time
        return self

    def __exit__(self, *exc):
        from nomad_tpu_torch.server import periodic
        from nomad_tpu_torch.structs import structs

        periodic.time, structs.now = self.saved


def lifecycle_keys(srv):
    """Dispatched children keyed by (parent, ordinal of creation): their
    ids carry a uuid."""
    keys, count = {}, {}
    for j in sorted(srv.state.jobs(None), key=lambda j: j.create_index):
        m = DISPATCH_ID.fullmatch(j.id)
        if m:
            n = count[m.group(1)] = count.get(m.group(1), -1) + 1
            keys[j.id] = f"{m.group(1)}/dispatch-{m.group(2)}-#{n}"
    return lambda job_id: keys.get(job_id, job_id)


def lifecycle_content(srv) -> dict:
    """What the server committed, children keyed by parent and ordinal:
    allocs, eval statuses, job statuses with their summaries (queued
    counts and children), the launch rows' times, the usage fold."""
    key = lifecycle_keys(srv)
    st = srv.state
    out = server_content(srv)
    out["allocs"] = sorted((key(a[0]),) + a[1:] for a in out["allocs"])
    out["evals"] = sorted((key(e[0]),) + e[1:] for e in out["evals"])
    jobs = {}
    for j in st.jobs(None):
        summ = st.job_summary_by_id(None, j.id)
        jobs[key(j.id)] = [
            j.status, j.parent_id,
            {tg: [v.queued, v.starting, v.running, v.complete]
             for tg, v in sorted(summ.summary.items())} if summ else None,
            [summ.children.pending, summ.children.running,
             summ.children.dead] if summ and summ.children else None]
    out["jobs"] = jobs
    out["launches"] = sorted([p.id, p.launch]
                             for p in st.periodic_launches(None))
    out["usage"] = {k: list(v) for k, v in
                    sorted(st.namespace_usage().items())}
    return json.loads(json.dumps(out))


def lifecycle_wave(srv, label, fn) -> dict:
    """``server_wave`` with the kernels' counts set to 0 just before
    ``fn`` and read after the wave settled, and the tenancy feed run
    before the release (the DRF order then follows the same usage in
    every world)."""
    steps0 = zero_launches(srv)

    def body(s):
        fn(s)
        s._feed_tenancy(s.config.tenancy_metrics_top)

    row = server_wave(srv, label, body)
    row["launches"] = durable_launches(srv, steps0)
    return row


def lifecycle_world(dev, sizes) -> dict:
    """One world of phase ``lifecycle`` (see the module docstring): the
    port ``Server`` on ``dev`` on the in-memory log, every columnar guard
    at every read, the resident mirror's guard every batch, both
    observability planes armed."""
    from nomad_tpu_torch.ops import resident
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.server import eval_broker as broker_mod
    from nomad_tpu_torch.server.eval_broker import BrokerLimitError
    from nomad_tpu_torch.state import columnar as colmod
    from nomad_tpu_torch.structs import structs as ps
    from nomad_tpu_torch.utils.backoff import wait_until

    sc = lifecycle_scenario(**sizes)
    colmod.reset_counters()
    resident.reset_counters()
    # The broker draws among the ready service and batch queues at
    # random: one seeded draw sequence in every world, so the batches
    # hold their evals in the same order.
    broker_mod.random = random.Random(LIFECYCLE_SEED)
    brk = KernelCircuitBreaker()
    srv = Server(ServerConfig(
        device=dev, rng_seed=SERVER_SEED, batch_size=64,
        min_heartbeat_ttl=SERVER_HEARTBEAT_TTL, breaker=brk,
        columnar_guard_every=1, trace=True, events=True))
    out = {"waves": [], "refused": [], "force_ms": [], "dispatch_ms": []}
    try:
        with seeded_ids(LIFECYCLE_SEED), \
                lifecycle_clock(LIFECYCLE_NOW) as clock:
            srv.start()
            for w in srv.workers:
                w.scheduler_kwargs["guard_every"] = 1
            t0 = time.perf_counter()
            for n in sc["nodes"]:
                srv.node_register(n)
            out["node_register_s"] = time.perf_counter() - t0
            srv.namespace_upsert(ps.Namespace(name="prod",
                                              dequeue_weight=2.0))
            srv.namespace_upsert(ps.Namespace(
                name="batch", dequeue_weight=1.0,
                max_live_allocs=sc["quota"]))

            def force(s, job_id):
                t = time.perf_counter()
                child = s.periodic_force(job_id)
                out["force_ms"].append((time.perf_counter() - t) * 1e3)
                return child

            def dispatch(s, k):
                t = time.perf_counter()
                try:
                    s.job_dispatch("par", b"", {"k": str(k)})
                except BrokerLimitError as e:
                    out["refused"].append([e.namespace, e.pending, e.limit])
                    return False
                out["dispatch_ms"].append((time.perf_counter() - t) * 1e3)
                return True

            def wave1(s):
                for j in sc["prod"] + sc["periodic"] + [sc["par"]]:
                    s.job_register(j)
                clock.t = LIFECYCLE_NOW + 60
                for j in sc["periodic"]:
                    force(s, j.id)
                for k in range(sc["n_dispatch"]):
                    dispatch(s, k)
                # The quota drill: dispatch until the namespace refuses.
                k = sc["n_dispatch"]
                jobs_before = len(s.state.jobs(None))
                while dispatch(s, k):
                    k += 1
                out["drill_admitted"] = k - sc["n_dispatch"]
                out["drill_jobs_committed"] = (len(s.state.jobs(None))
                                               - jobs_before)

            out["waves"].append(lifecycle_wave(srv, "wave1", wave1))
            out["wave1"] = lifecycle_content(srv)
            out["tenants"] = {ns: row["Dequeued"] for ns, row in
                              srv.broker_stats()["Tenants"].items()}
            out["guards_before_gc"] = {**columnar_counters(),
                                       **resident_counts()}

            # Completion: every batch child's allocs through the client
            # sync, a thousand a call.
            done = []
            for a in srv.state.allocs(None):
                if "/" in a.job_id:
                    a = a.copy()
                    a.client_status = ps.ALLOC_CLIENT_STATUS_COMPLETE
                    done.append(a)
            t0 = time.perf_counter()
            for i in range(0, len(done), LIFECYCLE_UPDATE_CHUNK):
                srv.node_update_allocs(done[i:i + LIFECYCLE_UPDATE_CHUNK])
            out["completed_allocs"] = len(done)
            out["update_allocs_s"] = time.perf_counter() - t0
            out["completed"] = lifecycle_content(srv)

            # GC: one force-gc core eval through the leader's worker.
            sub = srv.event_stream_subscribe(topics={"Eval": set()})
            before = {k: len(v) for k, v in (
                ("evals", srv.state.evals(None)),
                ("allocs", srv.state.allocs(None)),
                ("jobs", srv.state.jobs(None)))}
            t0 = time.perf_counter()
            srv.system_gc()

            def core_done():
                return [e for e in srv.state.evals(None)
                        if e.type == ps.JOB_TYPE_CORE
                        and e.status == ps.EVAL_STATUS_COMPLETE]

            if not wait_until(core_done, SERVER_SETTLE_TIMEOUT,
                              max_interval=0.05):
                raise AssertionError("the force-gc core eval did not "
                                     "complete")
            out["gc_s"] = time.perf_counter() - t0
            server_settle(srv)
            deleted = 0
            while True:
                ev = sub.next(0.5)
                if ev is None:
                    break
                deleted += ev.type == "EvalDeleted"
            after = {k: len(v) for k, v in (
                ("evals", srv.state.evals(None)),
                ("allocs", srv.state.allocs(None)),
                ("jobs", srv.state.jobs(None)))}
            # The core eval itself is the one eval added.
            out["deleted"] = {"evals": before["evals"] + 1 - after["evals"],
                              "allocs": before["allocs"] - after["allocs"],
                              "jobs": before["jobs"] - after["jobs"]}
            out["eval_deleted_events"] = deleted
            out["gc"] = lifecycle_content(srv)
            out["guards_after_gc"] = {**columnar_counters(),
                                      **resident_counts()}

            def wave2(s):
                clock.t = LIFECYCLE_NOW + 120
                for j in sc["periodic"]:
                    force(s, j.id)
                for k in range(sc["wave2_dispatch"]):
                    dispatch(s, 100 + k)

            out["waves"].append(lifecycle_wave(srv, "wave2", wave2))
            out["wave2"] = lifecycle_content(srv)
        out["health"] = durable_health(srv, brk)
        out["guards"] = {**columnar_counters(), **resident_counts()}
        app = srv.plan_applier.stats
        out["applier"] = {k: app[k] for k in ("plans", "columnar",
                                              "columnar_guards")}

        # The timer: a parent on a test spec a few seconds out, on the
        # real clock; the dispatcher's thread launches it once.
        timer = sc["timer"]
        at = time.time() + LIFECYCLE_TIMER_DELAY
        timer.periodic = ps.PeriodicConfig(
            enabled=True, spec=f"{at}", spec_type=ps.PERIODIC_SPEC_TEST)
        steps0 = zero_launches(srv)
        srv.job_register(timer)
        if not wait_until(
                lambda: srv.state.periodic_launch_by_id(None, "timer"),
                LIFECYCLE_TIMER_TIMEOUT, max_interval=0.05):
            raise AssertionError("the timer's launch was not recorded")
        seen_s = time.time() - at
        server_settle(srv)
        children = [j for j in srv.state.jobs(None)
                    if j.parent_id == "timer"]
        launch = srv.state.periodic_launch_by_id(None, "timer")
        placed = sum(len(srv.state.allocs_by_job(None, j.id))
                     for j in children)
        out["timer"] = {"children": len(children), "placed": placed,
                        "launch_time_off_s": launch.launch - at,
                        "row_seen_after_s": seen_s,
                        "launches": durable_launches(srv, steps0)}
    finally:
        srv.shutdown()
    return out


def lifecycle_child(dev, out_path, sizes) -> None:
    """One world of phase ``lifecycle`` in a process of its own; the
    report is written to ``out_path``."""
    out = lifecycle_world(dev, sizes)
    with open(out_path, "w") as fh:
        json.dump(out, fh)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run_lifecycle_child(dev, root, sizes) -> dict:
    """``lifecycle_child`` in a fresh process with the phase's fixed
    string hash seed; its report."""
    out_path = os.path.join(root, f"lifecycle-{dev}.json")
    code = ("import sys; sys.path.insert(0, {0!r}); import chip_smoke as c; "
            "c.lifecycle_child({1!r}, {2!r}, {3!r})"
            ).format(REPO, dev, out_path, sizes)
    env = dict(os.environ, PYTHONHASHSEED=str(LIFECYCLE_HASH_SEED))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True,
                          timeout=LIFECYCLE_CHILD_TIMEOUT)
    if proc.returncode != 0 or not os.path.exists(out_path):
        raise AssertionError(f"lifecycle child on {dev}: rc "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    with open(out_path) as fh:
        out = json.load(fh)
    os.unlink(out_path)
    out["child_wall_s"] = time.perf_counter() - t0
    return out


LIFECYCLE_COMPARED = ("allocs", "evals", "blocked", "jobs", "launches",
                      "usage")


def check_lifecycle_world(w, label, sizes, on_card) -> list:
    """The invariants of one world."""
    errors = []
    n_per, count = sizes["n_periodic"], sizes["count"]
    held = (n_per + sizes["n_dispatch"]) * count
    want_admitted = (sizes["quota"] - held) // count
    if (w["drill_admitted"] != want_admitted
            or w["refused"] != [["batch", held + (want_admitted + 1) * count,
                                 sizes["quota"]]]
            or w["drill_jobs_committed"] != want_admitted):
        errors.append(f"{label}: quota drill admitted "
                      f"{w['drill_admitted']} (want {want_admitted}), "
                      f"refused {w['refused']}, committed "
                      f"{w['drill_jobs_committed']}")
    children = n_per + sizes["n_dispatch"] + want_admitted
    w1 = w["wave1"]
    kids = [j for j, v in w1["jobs"].items() if v[1]]
    placed = [a for a in w1["allocs"] if "/" in a[0] and a[3] == "run"]
    if len(kids) != children or len(placed) != children * count:
        errors.append(f"{label}: wave 1 placed {len(placed)} allocs of "
                      f"{len(kids)} children (want {children} x {count})")
    if w["completed_allocs"] != children * count:
        errors.append(f"{label}: completed {w['completed_allocs']}")
    gc = w["gc"]
    left = [j for j, v in gc["jobs"].items() if v[1]]
    if left or [a for a in gc["allocs"] if "/" in a[0]]:
        errors.append(f"{label}: GC left children {left[:5]}")
    stay = ([f"prod-{k:02d}" for k in range(sizes["n_prod"])]
            + [f"per-{k:02d}" for k in range(n_per)] + ["par"])
    if [j for j in stay if j not in gc["jobs"]]:
        errors.append(f"{label}: GC took a parent or a prod job")
    if (w["deleted"]["jobs"] != children
            or w["deleted"]["allocs"] != children * count
            or w["deleted"]["evals"] != w["eval_deleted_events"]
            or w["deleted"]["evals"] < children):
        errors.append(f"{label}: deleted {w['deleted']}, EvalDeleted "
                      f"{w['eval_deleted_events']}")
    w2 = w["wave2"]
    placed2 = [a for a in w2["allocs"] if "/" in a[0] and a[3] == "run"]
    if len(placed2) != (n_per + sizes["wave2_dispatch"]) * count:
        errors.append(f"{label}: wave 2 placed {len(placed2)}")
    if [e for e in w2["evals"] if e[2] != "complete"]:
        errors.append(f"{label}: evals not complete after wave 2")
    for key in ("guards_before_gc", "guards_after_gc", "guards"):
        g = w[key]
        if (g["GUARD_MISMATCHES"] or g["USAGE_GUARD_MISMATCHES"]
                or not g["GUARD_RUNS"] or not g["USAGE_GUARD_RUNS"]
                or g["guard_mismatches"] or g["dev_guard_mismatches"]):
            errors.append(f"{label}: {key} {g}")
    app = w["applier"]
    if not app["plans"] or app["columnar_guards"] != app["plans"]:
        errors.append(f"{label}: the applier's plan-fit guard {app}")
    # The resident mirror's guard ran on wave 2's batch, after the GC's
    # negative deltas.
    if w["guards"]["guard_runs"] <= w["guards_after_gc"]["guard_runs"]:
        errors.append(f"{label}: no resident guard after the GC")
    h = w["health"]
    if (h["over_capacity"] or h["nacks"] or h["failed"]
            or h["breaker"] != {"state": "closed", "trips": 0,
                                "oracle_routed": 0}):
        errors.append(f"{label}: health {h}")
    t = w["timer"]
    if (t["children"] != 1 or t["placed"] != sizes["timer_count"]
            or t["launch_time_off_s"] != 0 or t["row_seen_after_s"] < 0):
        errors.append(f"{label}: timer {t}")
    if on_card:
        for row in w["waves"]:
            errors += check_launches(f"{label} {row['wave']}",
                                     row["launches"])
        errors += check_launches(f"{label} timer", t["launches"])
    return errors


def phase_lifecycle(dev, sizes=None):
    """The job lifecycle (see the module docstring, phase 23): the card
    world and the CPU world, each in a process of its own under one
    string hash seed, compared here."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    smi = smi_name_power()
    on_card = torch_device(dev).type == "cuda"
    sizes = dict(LIFECYCLE_SIZES if sizes is None else sizes)
    root = tempfile.mkdtemp(prefix="nomad-torch-lifecycle-")
    try:
        card = run_lifecycle_child(dev, root, sizes)
        cpu = run_lifecycle_child("cpu", root, sizes)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    errors = check_lifecycle_world(card, "card", sizes, on_card)
    errors += check_lifecycle_world(cpu, "cpu", sizes, False)
    for step in ("wave1", "completed", "gc", "wave2"):
        for key in LIFECYCLE_COMPARED:
            a, b = card[step][key], cpu[step][key]
            if a != b:
                if isinstance(a, list):
                    a = {tuple(r) if isinstance(r, list) else r for r in a}
                    b = {tuple(r) if isinstance(r, list) else r for r in b}
                    diff = {"card_only": sorted(a - b)[:8],
                            "cpu_only": sorted(b - a)[:8]}
                elif isinstance(a, dict):
                    diff = {k: (a.get(k), b.get(k)) for k in set(a) | set(b)
                            if a.get(k) != b.get(k)}
                else:
                    diff = (a, b)
                errors.append(f"{step}: card != cpu on {key}: "
                              f"{str(diff)[:2000]}")
    for key in ("refused", "drill_admitted", "deleted",
                "eval_deleted_events", "tenants"):
        if card[key] != cpu[key]:
            errors.append(f"card != cpu on {key}: {card[key]} "
                          f"{cpu[key]}")
    if errors:
        raise AssertionError(f"phase lifecycle: {errors}")

    for w, label in ((card, "card"), (cpu, "cpu")):
        for row in w["waves"]:
            emit({"phase": "lifecycle", "world": label,
                  **{k: v for k, v in row.items() if k != "launches"}})

    def ms(xs):
        return {"n": len(xs), "mean_ms": statistics.fmean(xs),
                "max_ms": max(xs)}

    return {
        "card": smi, "card_equals_cpu": True,
        "evals_per_s": {w: {row["wave"]: row["evals_per_s"]
                            for row in x["waves"]}
                        for w, x in (("card", card), ("cpu", cpu))},
        "gc_s": {"card": card["gc_s"], "cpu": cpu["gc_s"]},
        "deleted": card["deleted"],
        "eval_deleted_events": card["eval_deleted_events"],
        "quota_drill": {"admitted": card["drill_admitted"],
                        "refused": card["refused"]},
        "tenant_dequeued": card["tenants"],
        "periodic_force_ms": ms(card["force_ms"]),
        "job_dispatch_ms": ms(card["dispatch_ms"]),
        "node_register_s": {"card": card["node_register_s"],
                            "cpu": cpu["node_register_s"]},
        "update_allocs_s": {"card": card["update_allocs_s"],
                            "cpu": cpu["update_allocs_s"]},
        "timer": {"card": card["timer"], "cpu": cpu["timer"]},
        "guards": {"card": card["guards"], "cpu": cpu["guards"]},
        "applier": {"card": card["applier"], "cpu": cpu["applier"]},
        "launches": {row["wave"]: row["launches"] for row in card["waves"]},
        "world_seconds": {"card": card["child_wall_s"],
                          "cpu": cpu["child_wall_s"]},
        "seconds": time.perf_counter() - t_phase}


def torch_device(dev):
    import torch

    d = torch.device(dev)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


# -- phase 24: times ---------------------------------------------------------

def score_bytes(u: int, n: int, with_base: bool = True) -> int:
    """Bytes the function must move: feas (1) + collisions (4) in and
    scored (4) + base (4, when asked for) out per cell; used, cap (16
    each) and denom (8) per node; ask (16) and penalty (4) per row."""
    return u * n * (13 if with_base else 9) + n * 40 + u * 20


def score_ops(u: int, n: int) -> int:
    """Operations per cell: the 4-dim fit test (8), ScoreFit with two
    divides and two powers (~30), penalty, jitter hash and select (~20)."""
    return u * n * 58


def cuda_kernel_events(prof):
    """The profiler's device-side kernel events (empty if the profiler
    recorded no device activity on this machine)."""
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if getattr(e, "device_type", None) == DeviceType.CUDA]


def profiled(fn, n: int = 1):
    """Trace ``n`` calls of ``fn`` with device activity only: no host
    operator records, so the host-bound loop is not slowed by them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return prof


def kernel_device_ms(fn, name: str, n: int = 100):
    """Median device time of ``n`` runs of the kernel whose name contains
    ``name``, by the profiler's CUPTI trace; None when the trace has
    none."""
    fn()
    evs = [e for e in cuda_kernel_events(profiled(fn, n)) if name in e.name]
    if not evs:
        return None
    return statistics.median(e.time_range.elapsed_us() for e in evs) / 1e3


def back_to_back_ms(fn, n: int = 200) -> float:
    """Events around ``n`` calls in a row, divided by ``n``: the rate the
    card sustains, host overhead included where the host is slower."""
    import torch

    for _ in range(10):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def masked_bytes(u: int, n: int) -> int:
    """Bytes the masked score must move: feas (1) in and the score (4) out
    per cell; used, cap (16 each) and denom (8) per node; ask (16) per
    row."""
    return u * n * 5 + n * 40 + u * 16


def masked_ops(u: int, n: int) -> int:
    """Operations per cell: the 4-dim fit test (8) and ScoreFit with two
    divides and two powers (~30)."""
    return u * n * 38


def rotating(args):
    """A function giving the next of enough copies of ``args`` that a pass
    over them reads at least twice the L2's size: each timed launch then
    reads its inputs from HBM, not from the L2 the launches before filled.
    Sized by the bytes of the tensors it copies, not by what a launch
    writes: outputs are allocated anew by each call and may stay in the
    L2."""
    in_bytes = sum(a.numel() * a.element_size() for a in args)
    reps = max(1, min(1024, math.ceil(2 * L2_BYTES / max(1, in_bytes))))
    sets = [args] + [[a.clone() for a in args] for _ in range(reps - 1)]
    it = itertools.cycle(sets)
    return lambda: next(it)


def bound_of(n_bytes, n_ops):
    """(bound ms, what bounds it): the larger of the bytes over the HBM
    rate and the operations over the float32 rate."""
    b_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    b_ops = n_ops / FP32_FLOPS * 1e3
    return max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops
                                 else "operations")


def bound_share(bound_ms, ms):
    """The share of the bound a time reaches, or None with the reason when
    it reads above 1 (outputs that stay dirty in the L2 across launches
    are not written to HBM within the launch)."""
    share = bound_ms / ms if ms else None
    if share is None or share > 1.0:
        return {"bound_share": None,
                "bound_note": f"reads {share} of the HBM bound: above it, "
                              "so not a share (outputs stay in the L2)"}
    return {"bound_share": share}


def timed_row(call, plain, kernel_name, n_bytes, n_ops, n=100):
    """One kernel's times at one shape: its median device time over ``n``
    launches, one call's median through the wrapper, back-to-back calls,
    its plain version's median, and the bound for the same work."""
    dev_ms = kernel_device_ms(call, kernel_name, n)
    ms = dev_ms if dev_ms is not None else back_to_back_ms(call)
    bound_ms, bound_by = bound_of(n_bytes, n_ops)
    return {"ms": ms,
            "ms_source": ("profiler device time, median" if dev_ms is not None
                          else "CUDA events, back-to-back launches"),
            "call_ms_median": time_ms(call),
            "back_to_back_ms": back_to_back_ms(call),
            "plain_ms": time_ms(plain, n=20),
            "bound_ms": bound_ms, "bound_by": bound_by,
            **bound_share(bound_ms, ms), "bytes": n_bytes}


# The timed rows: ("masked", u, n, distinct_asks) of masked_score_matrix;
# ("scored", u, n, n_offset, with_base) of scored_rows.  (1, 250_016,
# 250_016, ...) is the mesh's per-shard commit score (U = 1 over one
# config_mesh shard, at shard 1's node offset): with base as config (b)
# on a mesh calls it, without as config_mesh, which keeps no scores, does.
# The distinct-ask row gives every spec row its own CPU and memory ask.
MASKED_TIMES = (("masked", 128, 250_016, False), ("masked", 1, 10112, False),
                ("masked", 128, 250_016, True))
SCORED_TIMES = (("scored", 1, 250_016, 250_016, True),
                ("scored", 1, 250_016, 250_016, False),
                ("scored", 1, 10112, 0, True),
                ("scored", 128, 10112, 0, True))


def timed_case(dev, shape):
    """(kernel call, plain call, kernel name, bytes, operations) of one
    timed row, each call on the next of the rotating copies of
    ``score_inputs`` -- the same inputs every tree is timed on."""
    from nomad_tpu_torch.ops import fused_score, kernels

    if shape[0] == "masked":
        _, u, n, distinct = shape
        nbytes = masked_bytes(u, n)
        nxt = rotating(score_inputs(u, n, SEED, dev, distinct)[:5])
        return (lambda: fused_score.masked_score_matrix(*nxt()),
                lambda: fused_score.masked_score_matrix_reference(*nxt()),
                "masked_score_kernel", nbytes, masked_ops(u, n))
    _, u, n, n_off, with_base = shape
    seed = kernels.jitter_seed(SEED)
    nbytes = score_bytes(u, n, with_base)
    nxt = rotating(score_inputs(u, n, SEED, dev))
    return (lambda: fused_score.scored_rows(*nxt(), seed, n_offset=n_off,
                                            with_base=with_base),
            lambda: fused_score.scored_rows_reference(*nxt(), seed,
                                                      n_offset=n_off),
            "scored_rows_kernel", nbytes, score_ops(u, n))


def launch_floor(dev):
    """Device time of a one-element ``torch.zeros`` fill: what the card
    takes for a launch that does nothing, the floor under the U = 1 x
    10,112 rows."""
    import torch

    def call():
        return torch.zeros(1, device=dev)

    ms = kernel_device_ms(call, "", 100)
    return {"what": "torch.zeros(1) fill kernel",
            "ms": ms if ms is not None else "not measured (no device events)",
            "back_to_back_ms": back_to_back_ms(call)}


def sass_report(paths, issue_cells):
    """Static SASS of every kernel instantiation (``cuobjdump -sass`` of
    the built libraries): instructions and MUFU (special function unit)
    instructions.  One cell's instructions are estimated as (V=4 count -
    V=1 count) / 3 -- the vector kernel repeats the cell body four times
    over the same row and block code -- an estimate of the static body,
    slow paths included.  ``issue_cells`` maps a kernel name to the cells
    of a timed row; for each, the issue-rate time: one warp instruction
    per scheduler per clock, 4 schedulers per SM, at the card's maximum SM
    clock."""
    import re

    import torch

    from nomad_tpu_torch import device as devmod

    tool = os.path.join(os.path.dirname(devmod.find_nvcc()), "cuobjdump")
    funcs = {}
    for so in paths.values():
        try:
            text = subprocess.run([tool, "-sass", str(so)],
                                  capture_output=True, text=True, timeout=120,
                                  check=True).stdout
        except (OSError, subprocess.SubprocessError) as exc:
            return {"not measured": f"cuobjdump: {exc!r}"}
        cur = None
        for line in text.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                cur = funcs.setdefault(m.group(1),
                                       {"instructions": 0, "mufu": 0})
                continue
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)", line)
            if cur is not None and m and not m.group(1).startswith("NOP"):
                cur["instructions"] += 1
                cur["mufu"] += m.group(1).startswith("MUFU")
    per_cell = {}
    for name, c in funcs.items():
        if "ILi4E" not in name:
            continue
        one = funcs.get(name.replace("ILi4E", "ILi1E"))
        if one is not None:
            per_cell[name] = {
                "instructions": (c["instructions"] - one["instructions"]) / 3,
                "mufu": (c["mufu"] - one["mufu"]) / 3}
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=30).stdout.split()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue = {}
    if clock:
        rate = sms * 4 * float(clock[0]) * 1e6     # warp instructions / s
        for kernel, (cells, variant) in issue_cells.items():
            body = next((v for k, v in per_cell.items()
                         if kernel in k and variant in k), None)
            if body is not None:
                issue[kernel] = {
                    "cells": cells, "instructions_per_cell":
                    body["instructions"], "max_sm_clock_mhz": float(clock[0]),
                    "issue_ms": cells / 32 * body["instructions"] / rate
                    * 1e3}
    return {"functions": funcs, "per_cell_estimate": per_cell,
            "issue_rate": issue}


def phase_times(dev, launches, max_err, masked_launches, masked_err):
    import torch

    from nomad_tpu_torch import device as devmod

    masked = {}
    for shape in MASKED_TIMES:
        _, u, n, distinct = shape
        call, plain, name, nbytes, nops = timed_case(dev, shape)
        row = {"u": u, "n": n, "distinct_asks": distinct,
               **timed_row(call, plain, name, nbytes, nops, n=60)}
        emit({"phase": "times", "kernel": "masked_score_matrix", **row})
        if not distinct:
            masked[u] = row
    out = {}
    for shape in SCORED_TIMES:
        _, u, n, n_off, with_base = shape
        call, plain, name, nbytes, nops = timed_case(dev, shape)
        row = {"u": u, "n": n, "n_offset": n_off, "with_base": with_base,
               **timed_row(call, plain, name, nbytes, nops)}
        emit({"phase": "times", "kernel": "scored_rows", **row})
        if not n_off:
            out[u] = row
    emit({"phase": "times", "launch_floor": launch_floor(dev)})
    # Masked U=128 x 250,016 runs masked_score_kernel<4>; scored U=128 x
    # 10,112 with base runs scored_rows_kernel<4, Out::kScoredBase> (its
    # mangled template argument ...E2E).
    emit({"phase": "times", "sass": sass_report(
        devmod.build_kernels(),
        {"masked_score_kernel": (128 * 250_016, "ILi4E"),
         "scored_rows_kernel": (128 * 10112, "E2E")})})
    torch.cuda.synchronize()
    main = out[1]    # the placement loop calls the kernel at U = 1
    cand = masked[128]   # the candidate path's call: U = 128 per shard
    return [{"name": "scored_rows", "route": "cuda",
             "source": "nomad_tpu_torch/csrc/scored_rows.cu",
             "replaces": "nomad_tpu/ops/pallas_score.py:166",
             "launches": launches, "max_abs_err": max_err,
             "ms": main["ms"], "plain_ms": main["plain_ms"],
             "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
             "library_ms": None},
            {"name": "masked_score_matrix", "route": "cuda",
             "source": "nomad_tpu_torch/csrc/masked_score.cu",
             "replaces": "nomad_tpu/ops/pallas_score.py:102",
             "launches": masked_launches, "max_abs_err": masked_err,
             "ms": cand["ms"], "plain_ms": cand["plain_ms"],
             "bound_ms": cand["bound_ms"], "bound_by": cand["bound_by"],
             "library_ms": None}]


# -- --against: two trees' kernels on the same inputs --------------------------

def build_against(root):
    """Build the kernels of the tree at ``root`` with this tree's flags
    into ``build/against/`` (one nvcc per source, all started together);
    name -> its C entry point, which has this tree's C interface."""
    import ctypes

    from nomad_tpu_torch import device as devmod
    from nomad_tpu_torch.ops import fused_score

    out_dir = os.path.join(REPO, "build", "against")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in fused_score._C_API:
        so = os.path.join(out_dir, f"lib{name}.so")
        src = os.path.join(root, "nomad_tpu_torch", "csrc", f"{name}.cu")
        if not os.path.exists(src):
            continue      # a kernel that tree does not have
        procs[name] = (so, subprocess.Popen(
            [devmod.find_nvcc(), *devmod.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {root}'s {name}.cu:\n{log}")
        symbol, argtypes = fused_score._C_API[name]
        fn = getattr(ctypes.CDLL(so), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def against_cases(dev):
    """(shape, kernel call, kernel name, bytes, operations) of every timed
    row: those of ``times`` and phase ``preempt``'s, one at a time."""
    for shape in MASKED_TIMES + SCORED_TIMES:
        call, _, name, nbytes, nops = timed_case(dev, shape)
        yield list(shape), call, name, nbytes, nops
    for u, n, a in PREEMPT_TIMES:
        call, _, nbytes, nops = evict_case(dev, u, n, a)
        yield (["evict", u, n, a], call, "eviction_sets_kernel", nbytes,
               nops)


def phase_against(dev, root):
    """Every timed row of ``times`` and ``preempt`` with the kernels of the
    tree at ``root`` and with this tree's, through this tree's wrappers on
    the same rotating inputs, in turns: that tree, this, this, that,
    twice.  Each entry is the profiler's median over 100 launches."""
    from nomad_tpu_torch.ops import fused_score

    mine = {name: fused_score._fn(name) for name in fused_score._C_API}
    theirs = build_against(root)
    rows = []
    try:
        for shape, call, name, nbytes, nops in against_cases(dev):
            times = {"against": [], "this": []}
            for who in ("against", "this", "this", "against") * 2:
                fused_score._FNS.update(theirs if who == "against" else mine)
                ms = kernel_device_ms(call, name, 100)
                times[who].append(ms if ms is not None
                                  else back_to_back_ms(call))
            a, t = times["against"], times["this"]
            spread = max(max(a) - min(a), max(t) - min(t))
            bound_ms, bound_by = bound_of(nbytes, nops)
            row = {"kernel": name, "shape": shape, "bytes": nbytes,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "against_ms": a, "this_ms": t,
                   "speedup_of_medians": statistics.median(a)
                   / statistics.median(t),
                   "largest_repeat_spread_ms": spread,
                   "slower_beyond_spread": min(t) - max(a) > spread,
                   "faster_beyond_spread": min(a) - max(t) > spread,
                   **bound_share(bound_ms, statistics.median(t))}
            emit({"phase": "against", **row})
            rows.append(row)
    finally:
        fused_score._FNS.update(mine)
    return rows


def profile_batch(dev, nodes, jobs, mesh=None):
    """Config (b) batch 0 again, warm, on the single card or on ``mesh``.
    First three runs without the profiler (CUDA events), then one under a
    device-only trace.  Device busy = the sum of kernel and copy times on
    the card; idle share = 1 - busy / a batch's device time, against the
    traced run's and against the untraced median.  The trace also counts
    the score kernel's executions on the card, held against the
    wrapper's launch count for the same run."""
    from nomad_tpu_torch.ops import batch_sched, fused_score

    res = {}
    where = {"mesh": mesh} if mesh is not None else {"device": dev}

    def run():
        res["r"] = batch_sched.schedule_batch(nodes, jobs, rng_seed=SEED,
                                              **where)

    plain = []
    for _ in range(3):
        run()
        plain.append(res["r"].timings)
    warm_device_s = statistics.median(t["device"] for t in plain)
    fused_score.LAUNCHES = 0
    prof = profiled(run)
    launches = fused_score.LAUNCHES
    evs = cuda_kernel_events(prof)
    r = res["r"]
    row = {"batch": "config_b_0", "mesh_shards": r.mesh_shards,
           "rounds": r.rounds,
           "untraced_device_s_cuda_events": [t["device"] for t in plain],
           "untraced_encode_s": [t["encode"] for t in plain],
           "untraced_decode_s": [t["decode"] for t in plain],
           "traced_device_s_cuda_events": r.timings["device"],
           "kernel_launches": launches}
    if not evs:
        row["device_busy_s"] = "not measured (no device events in trace)"
        return row
    by_name = {}
    for e in evs:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    busy = sum(t for t, _ in by_name.values()) / 1e6
    traced = sum(c for k, (_, c) in by_name.items()
                 if "scored_rows_kernel" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    row.update({
        "device_ops": len(evs), "device_busy_s": busy,
        "device_idle_share_traced": 1.0 - busy / r.timings["device"],
        "device_idle_share_untraced": 1.0 - busy / warm_device_s,
        # A committing spec step launches the score kernel once per shard.
        "device_ops_per_spec_step": len(evs) * max(1, r.mesh_shards)
        / max(1, launches),
        "score_kernel_in_trace": traced,
        "top_device_ops": [{"name": k[:80], "us": t, "count": c}
                           for k, (t, c) in top]})
    if traced != launches:
        raise AssertionError(f"the trace shows {traced} score kernel runs, "
                             f"the wrapper counted {launches}")
    return row


def phase_profile(dev):
    """Where the time of config (b)'s first batch goes, on the single card
    and on a 4-shard mesh of the card."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.parallel import make_node_mesh

    nodes = [strip_node(mock.node()) for _ in range(10_000)]
    jobs = [strip_job(mock.job(), 1000) for _ in range(100)]
    return {"single": profile_batch(dev, nodes, jobs),
            "mesh4": profile_batch(dev, nodes, jobs,
                                   make_node_mesh([dev] * MESH_SHARDS))}


def run_phase(name, fn, *args):
    t0 = time.perf_counter()
    try:
        result = fn(*args)
    except Exception as exc:  # noqa: BLE001 — report the phase and stop
        tb = traceback.format_exc()[-4000:]
        emit({"phase": name, "ok": False, "error": repr(exc),
              "traceback": tb})
        # Also on stderr, whose tail is what a caller keeps of a failed run.
        print(f"chip_smoke: phase {name} failed: {exc!r}\n{tb}",
              file=sys.stderr, flush=True)
        sys.exit(1)
    emit({"phase": name, "ok": True, "seconds": time.perf_counter() - t0})
    return result


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--against", metavar="TREE",
        help="only time this tree's kernels against those of the checkout "
             "at TREE (same C interface), on the same inputs, and exit")
    opts = parser.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "nomad_tpu_torch")):
        print("chip_smoke: the nomad_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()
    dev = "cuda"
    smi = smi_name_power()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    from nomad_tpu_torch import device as devmod

    def build():
        paths = devmod.build_kernels()
        for name, log in devmod.BUILD_LOGS.items():
            emit({"phase": "build", "kernel": name, "nvcc": log[-3000:]})
        return {k: str(v) for k, v in paths.items()}

    run_phase("build", build)
    if opts.against:
        rows = run_phase("against", phase_against, dev, opts.against)
        emit({"against": opts.against, "rows": rows})
        print(smi, flush=True)
        return 0
    parity, max_err = run_phase("parity", phase_parity, dev)
    emit({"phase": "parity", **parity})
    masked, masked_err = run_phase("masked_parity", phase_masked_parity, dev)
    emit({"phase": "masked_parity", **masked})
    _, launches = run_phase("config_b", phase_config_b, dev)
    emit({"phase": "cpu_vs_card",
          **run_phase("cpu_vs_card", phase_cpu_vs_card, dev)})
    emit({"phase": "networks", **run_phase("networks", phase_networks, dev)})
    emit({"phase": "distinct_property",
          **run_phase("distinct_property", phase_distinct_property, dev)})
    emit({"phase": "net_dp_vs_cpu_mesh",
          **run_phase("net_dp_vs_cpu_mesh", phase_net_dp_vs_cpu_mesh, dev)})
    emit({"phase": "mesh_scores",
          **run_phase("mesh_scores", phase_mesh_scores, dev)})
    cand, masked_launches, cand_err = run_phase("candidates",
                                                phase_candidates, dev)
    emit({"phase": "candidates", **cand})
    emit({"phase": "mesh", **run_phase("mesh", phase_mesh, dev)})
    col = run_phase("columnar", phase_columnar, dev)
    emit({"phase": "columnar", **col})
    _MESH_FLEET.clear()
    evals = run_phase("evals", phase_evals, dev)
    emit({"phase": "evals", **evals})
    applied = run_phase("applied", phase_applied, dev)
    emit({"phase": "applied", **applied})
    pre = run_phase("preempt", phase_preempt, dev)
    emit({"phase": "preempt", **{k: v for k, v in pre.items()
                                 if k != "kernel_row"}})
    srv = run_phase("server", phase_server, dev)
    emit({"phase": "server", **srv})
    trc = run_phase("trace", phase_trace, dev)
    emit({"phase": "trace", **trc})
    plan = run_phase("plan", phase_plan, dev)
    emit({"phase": "plan", **plan})
    fpr = run_phase("fingerprint", phase_fingerprint, dev)
    emit({"phase": "fingerprint", **fpr})
    dur = run_phase("durable", phase_durable, dev)
    emit({"phase": "durable", **dur})
    clu = run_phase("cluster", phase_cluster, dev)
    emit({"phase": "cluster", **clu})
    life = run_phase("lifecycle", phase_lifecycle, dev)
    emit({"phase": "lifecycle", **life})
    table = run_phase("times", phase_times, dev, launches, max_err,
                      masked_launches, max(masked_err, cand_err))
    # scored_rows' launches on the eval-driven path (phase evals, each
    # batch driven with the counts set to 0 just before it).
    table[0]["eval_path_launches"] = evals["eval_path_launches"]
    # ... and on the applied path (phase applied, the card with the mirror
    # and guard_every=1: batch 0, the follow-ups and the stream).
    table[0]["applied_path_launches"] = applied["applied_path_launches"]
    # ... and on the columnar path (phase columnar, the store with the
    # mirror: its three waves, each driven with the counts set to 0 just
    # before it).
    table[0]["columnar_path_launches"] = col["scored_rows_launches"]
    # ... on the dry-run path (phase plan: the annotate-plan batch) and on
    # the fingerprint path (phase fingerprint: the constrained batch).
    table[0]["plan_path_launches"] = plan["scored_rows_launches"]
    table[0]["fingerprint_path_launches"] = fpr["scored_rows_launches"]
    # eviction_sets: launches on config_preempt's eval path (phase
    # preempt, its count set to 0 just before the card's batch).
    table.append(pre["kernel_row"])
    # ... and on the server path (phase server, each server driven with
    # the counts set to 0 just before it): the main server's batches and
    # the preempting drill's.
    for row in table:
        row["server_path_launches"] = {
            label: srv["launches"][label][row["name"]]
            for label in ("main", "drill")}
        # ... and on the traced server path (phase trace, the armed card
        # world, each server driven with the counts set to 0 just
        # before it).
        row["trace_path_launches"] = {
            label: trc["launches"][label][row["name"]]
            for label in ("main", "drill")}
        # ... and on the durable server path (phase durable, each part
        # driven with the counts set to 0 just before it): world (A)
        # before its crash (in its own process) and after its restart,
        # and its uninterrupted twin (B).
        row["durable_path_launches"] = {
            label: dur["launches"][label][row["name"]]
            for label in ("A_before_crash", "A_after_restart", "B")}
        # ... and on the replicated cluster's path (phase cluster, each
        # leader's part driven with the counts set to 0 just before it):
        # leg 1's card cluster before and after its failover, and leg 2
        # (follower-read scheduling; both leaders, the kill mid-drain).
        row["cluster_path_launches"] = {
            label: clu["launches"][label][row["name"]]
            for label in ("A_before_failover", "A_after_failover", "leg2")}
        # ... and on the job lifecycle's path (phase lifecycle, the card
        # world, each wave driven with the counts set to 0 just before
        # it): wave 1 and wave 2 after the GC.
        row["lifecycle_path_launches"] = {
            label: life["launches"][label][row["name"]]
            for label in ("wave1", "wave2")}
    emit({"phase": "profile", **run_phase("profile", phase_profile, dev)})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
