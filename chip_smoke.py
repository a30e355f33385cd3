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
               ``schedule_batch``: one round-kernel launch a batch, the
               committing steps inside the bounds read from the result;
5b. rounds  -- the round kernel (``csrc/placement_rounds.cu``) against
               its plain version, the eager ``placement_rounds``, on the
               card: config (b)'s three batches and a networks-plus-
               distinct_property batch at phase 8's size, each batch's
               ``device_schedule`` replayed through both, every output
               bit for bit; batch 0's seconds, launches, committing
               steps, the kernel's device time per launch (profiler, CUDA
               events beside it) and each route's device busy and idle
               share; then config (b) batch 0 through the ``two_pass``
               and ``staged`` dispatches (placements equal to the fused
               route's; the staged route's schedule and compact seconds);
6. cpu_vs_card -- a 2,048-node problem on the card and on the CPU: the
               placements must be identical;
7. networks -- config (b) with the networks of ``mock.node()`` and
               ``mock.job()`` kept (eth0 at 1000 Mbit/s, port 22
               reserved; 50 Mbit/s and two dynamic ports an ask), then
               two follow-up batches against the live placements and
               their offers: no node over capacity or bandwidth, no port
               used twice on a node, every dynamic port in [20000,
               60000), one round-kernel launch a batch;
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
13. columnar -- the columnar state store at a quarter of config_mesh's
               width: the first 250,000 of phase 12's nodes into a port
               ``StateStore`` (its columnar mirror cold-built; cut from
               1,000,000 to keep the whole run inside its time limit),
               config (b)'s 100 x 1,000
               asks, then a node down (a cold static encode) and the
               10 x 200 follow-up, twice (``columnar_guard_every=1``,
               then the default 16), through ``TorchBatchScheduler`` and
               the store-backed ``PlanApplier``; the same waves over a
               ``StateStore(columnar=False)``: the same plans, no guard
               mismatch, no node over capacity, every ask placed, one round-kernel launch a batch and the kernel
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
               bytes uploaded by a follow-up, one round-kernel launch a batch; then the kernel breaker drill (a
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
               batch 0's and the follow-ups' fetched results decoded
               again by the native decode (``native/decode.cc``) and by
               its numpy twins, in turns: equal outputs, both times
               printed (``decode_routes``);
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
               failed; one round-kernel launch a batch the batches report, one ``eviction_sets`` launch in
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
               one round-kernel launch a batch, the
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
               failure forensics, no oracle route, one round-kernel
               launch a batch, the store's allocs untouched;
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
21. durable -- the durable server: half of phase 17's fleet (5,000
               nodes) and config (b)'s waves, wave 1 halved (cut to keep
               the whole run inside its time limit), through the port's
               ``Server`` on a ``FileLog`` (the
               native group-commit WAL, fsync on, in a fresh temporary
               dir) on the card (A), an uninterrupted twin on the
               in-memory log on the card (B), and the CPU server on a
               ``FileLog`` (C), each world in a process of its own under
               one string hash seed, the card's (A's crash, its restart,
               then B) one after the other beside C's (every time a world
               prints names the worlds it ran beside, ``ran_beside``).
               A and C: the fleet, wave 1 (50 x
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
               = C on committed allocs, eval statuses, blocked stats,
               queued counts and every job's version history
               (``job_versions_by_id``, also restored equal to the
               pre-crash history); one round-kernel launch a batch; one full re-encode of the resident mirror after the
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
               (every read), the card's (A, B, then leg 2) one after the
               other beside C (``ran_beside``).  Leg 1, exact: a quarter of phase 17's
               fleet, 2,500 nodes (every fifth registered through a
               follower, forwarded), a quarter of config
               (b)'s wave 1 (25 x 1000), every worker paused and wave 2
               (10 x 200) registered through a follower, the leader shut
               down (its broker first), a new leader elected whose
               restore re-enqueues wave 2, the workers released, a node
               down, a follow-up (10 x 200); on the card (A), on the CPU
               (C), and on one card server on the in-memory log (B, no
               failover).  A = C on allocs, eval statuses, blocked stats
               and queued counts after each step; A against B printed
               where it differs; every survivor's fingerprint equal; the
               new leader's applied index at least the last acknowledged;
               one round-kernel launch a batch on the old
               leader and on the new one; one full re-encode of the
               resident mirror more than B's after the failover; no guard
               mismatch, no nack, the breaker closed, no node over
               capacity; node registration seconds and ``raft.apply``
               mean and p99 through ``MultiRaft`` against B's, the kill
               to a new leader and to wave 2 settled, wave 1's evals per
               second, the forwarded writes.  Leg 2, invariants:
               follower-read scheduling (the leader's batch worker on
               the card, the followers' on the CPU schedulers), 1,000
               nodes and 100 jobs x 20 asks, the leader killed mid-drain
               at a seeded point: every eval complete, each job exactly
               its count of distinct allocs, no node over capacity, the
               survivors' fingerprints equal, plans forwarded by the
               followers and none by the leader's own channel, a
               round-kernel launch a batch on each leader; the lag
               handbacks and
               the ``follower.snapshot_lag`` samples;
23. lifecycle -- the job lifecycle: periodic and parameterized batch
               jobs in tenant namespaces through a port ``Server`` on the
               in-memory log (every columnar guard at every read, the
               resident mirror's guard every batch, both observability
               planes armed), on the card and on the CPU, each world in a
               process of its own under one string hash seed, the two
               side by side (``ran_beside``): phase 17's
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
               nack, no failed eval; one round-kernel launch a batch in each wave and none of
               ``eviction_sets``; each wave's evals per second, the GC's
               seconds, the tenants' dequeues and the force and dispatch
               latencies;
24. loadgen -- the load harness and the flight recorder: (a) the
               reference's ``baseline`` scenario (5,000 nodes of 64,000
               MHz and 256 GiB, 8 open-loop clients at 1,500 arrivals a
               second, 2,000 submissions of the 8:2:1 mix of 1-, 2- and
               4-count jobs, 64 filtered event-stream followers,
               heartbeats, a 30 s measure window and 60 s of drain)
               through ``nomad_tpu_torch.loadgen.LoadHarness`` into one
               port ``Server`` on the card (the in-memory log, batches
               of 16, one worker), with the continuous profiler (10 Hz),
               the flight recorder, its plan-apply SLO watch (set far
               below any real p99) and the lock-order sanitizer armed:
               every submission acknowledged and complete, every job its
               count of live allocs, a clean strict integrity sweep, no
               nack or failed eval, the breaker closed, no oracle route,
               one round-kernel launch a batch, exactly
               one ``slo.plan_apply_p99`` bundle (valid JSON with every
               section) and its ``BundleCaptured`` event on the stream,
               at least 80 % of the non-idle host samples attributed,
               no lock-order cycle; the sustained evals and placements a
               second, submit-to-running and plan-apply percentiles, the
               host's CPU shares, the GIL delay and the top lock waits;
               ``scored_rows`` against its plain version at every shape
               the run gave it; (b) the breaker drill
               (``python -m nomad_tpu_torch.ops``'s) on the card with
               the recorder, the tracing plane and the sanitizer armed:
               trip, oracle route, half-open probe, closed; exactly one
               ``breaker.open`` bundle holding the tripping batch's
               ``fault.fire`` span and ``breaker.transition`` event and
               the private breaker at one trip; a second trigger inside
               the interval writes nothing; no lock-order cycle;
25. agent   -- the front door, each world in a process of its own under
               one string hash seed, the card's (A, then B) beside C
               (``ran_beside``): (A) a port ``Agent`` from an HCL
               config (a server, no client, HTTP and RPC on ephemeral
               ports, the in-memory log) on the card, 10,000
               ``mock.node()`` nodes (the first 100 over its RPC
               listener), 100 HCL files of config (b)'s ``mock.job()``
               at count 1,000 through ``python -m nomad_tpu_torch.cli job
               run -detach`` and HTTP with the workers paused, then
               released, every eval awaited by a blocking query; (B) the
               same jobs through ``Server.job_register`` on the card; (C)
               A's script on the CPU.  A = B = C on the placements (job,
               alloc name -> node) and eval statuses, A = B on the
               scores, A vs C within 4e-6; every parsed job's wire form
               that of its ``mock.job()``; one round-kernel launch a batch and 0 differing bits at the shapes the
               path gave it; no nack or failed eval, the breaker closed,
               no oracle route, no node over capacity; blocking queries
               on the jobs and allocs tables started before the
               submissions return with a higher index, the allocs one
               after the release; ``job status``, ``alloc status``,
               ``eval status``, ``node status`` and ``job inspect`` exit
               0, ``job plan`` of an edited file shows the count edit,
               the event stream holds a ``PlanApplied`` for every placing
               eval and an ``EvalUpdated`` for every eval, ``job stop
               -purge`` leaves no live alloc, and no agent thread
               outlives ``shutdown``; evals per second through HTTP
               against the direct path, and the CLI's request ms;
26. client  -- the client, each world in processes of its own under one
               string hash seed, the two side by side: (A) a port
               ``Agent`` (a server on the card and the first client)
               with 10,000 nodes, 64 of them real port ``Client``s on the
               mock driver (48 in the server's process with the GPU
               fingerprint on, 16 in a child process through
               ``RemoteServerRPC`` over its RPC listener; the rest
               ``mock.node()`` registered in process: a client per node
               would be 10,000 clients on one host), 56 jobs on the
               client nodes (40 batch x 8 that complete, 8 batch x 4
               whose task fails, restarts once and fails, 8 service x 8
               with ``mock.job()``'s network ask, stopped once every
               alloc runs) submitted with the workers paused and
               released; 4 of the batch jobs on ``raw_exec``, 4 on
               ``exec`` and 2 of the failing ones on ``raw_exec`` run
               real processes under their supervisors (``/bin/sh``: the
               batch ones echo their alloc index and task name, then
               sleep), the rest on the mock driver; the clients get the
               wave's allocs only once its last eval is acked (the
               server's answers to their alloc watch held till then);
               (C) A's script on the CPU.  Every client enables ``raw_exec``
               and keeps ``cgroup_root`` empty.  Every builtin fingerprint runs but
               the cloud metadata probes.  A = C on the placements (job,
               alloc name -> node), every alloc's final client status,
               each task's event types and ``Terminated`` exit codes, the
               exec-family tasks' stdout logs and their count, the
               network each task got (the one its node's fingerprint
               found), the job statuses and summaries; no supervisor or
               task pid alive after each world's shutdown, nothing made
               under /sys/fs/cgroup, the supervisor start times (median,
               p99); no alloc terminal before the wave's last eval is
               acked; one round-kernel launch a batch and the kernel at the shapes the path gave
               it within 4e-6 of its plain version; no nack, the breaker
               closed, no oracle route, no node over capacity; every alloc
               dir made where its alloc ran and none left after the GC
               (the agent's client through ``/v1/client/gc``); no thread
               left.  On the card, the in-process clients carry
               ``gpu.type`` (the card's name) and a job pinned on it runs
               there; release to all running and to all terminal, and the
               ``Node.UpdateAlloc`` calls and their mean batch.  Vault:
               the agent's ``vault {}`` block on a ``FakeVault``; a batch
               job whose task asks for vault, pinned on the agent's
               client, derives its token (wrapped, unwrapped by the
               client): its ``secrets/vault_token`` holds a token with
               the task's policy, and once the alloc has ended its
               accessor reads revoked and its row is gone; A = C on its
               task events;
27. federation -- two regions (r0 on the in-memory log, r1 on a
               ``FileLog``), each one port server, WAN-joined, (A) on
               the card and (C) on the CPU, side by side, each world in
               a process of its own under one string hash seed.  Leg 1:
               each region cluster leg 1's fleet at 5,000 nodes, 40 jobs
               x 250 submitted through r0, the odd ones for r1
               (forwarded), each region released and settled in turn:
               A = C on each region's placements, unplaced counts and
               AllocMetric scores (within 4e-6), every job only in its
               own region and none holding allocs in two
               (``federated_sweep``), one round-kernel launch a batch and the kernel at A's shapes against its
               plain version (0 differing bits).  Leg 2: r1 stopped; its
               submissions through r0 (in process and over the wire)
               raise ``NoPathToRegion`` with a ``retry_after`` within 10
               s, r0 places its own jobs meanwhile, the
               ``RegionEventAggregator`` names r1 unreachable with its
               cursor kept; r1 restarted on its address and data dir, a
               probe through r0 placed in r1 within 30 s.  Between
               legs 1 and 2, the forward tax as a rate: 256 one-alloc
               jobs of r1 from 8 threads, through r1 itself, then
               through r0 (forwarded): registrations and evals acked a
               second in each stream, one launch a batch.
               Leg 3 (A only): the ``multi_region`` scenario through
               ``run_multi_region``'s harness on card servers (80
               nodes, 480 submissions, 25 % cross-region, r1 dark 3 s
               at 4 s): the federated auditor's 0 violations, the
               blackout recovered, its breaker closed with no trip and
               no oracle route, one launch a batch of its servers, the kernel at its shapes against its plain
               version (0 differing bits), and the forward's submit
               latency, local against cross;
28. drills  -- the thirteen drills of ``python -m nomad_tpu_torch.ops
               --selfcheck --device cuda`` in this process: preemption,
               breaker, columnar, tracing, wal, follower, chaos (a
               partitioned follower blinded, healed and caught up under
               the safety auditor), residency,
               fused, residue (the native decode against its numpy twins,
               the guard at every call), codec, mesh (four shards of the
               card: the per-shard device twin, one corrupted row
               attributed to its shard, the breaker and the oracle) and
               analysis (the static pass clean, the lock-order sanitizer's
               seeded inversion, the native corpora under ASan and UBSan:
               ``clean`` or ``skip: <reason>``, printed); every drill
               must pass; the round kernel runs once a batch of the
               single card's batches, ``scored_rows`` once per committing
               step and shard of the mesh's, ``masked_score_matrix``
               launches four a call of
               ``sharded_candidate_scores`` (none on the fused mesh pass);
29. times   -- each kernel's device time (profiler trace; CUDA events
               where the trace has none) over copies of its inputs that
               overflow the L2 (``rotating``: twice the L2 of input bytes
               a cycle), its plain version's, the bound for the same work
               on this card and the share of it reached (none where the
               time reads above the bound); scored_rows also without base
               (the mesh's call at config_mesh); the launch floor (a
               one-element fill); the kernels' SASS instruction counts and the
               issue-rate time they give;
30. profile -- config (b)'s first batch again, warm, on the single card
               and on a 4-shard mesh: untraced, and under a device-only
               trace for the device busy time and idle share.

Each path is driven with the kernels' launch counts set to 0 just before
it and read just after; a path that should launch a kernel and did not
fails.  On one card the placement loop is the round kernel: a batch
launches it once, every round inside the launch, and launches no
``scored_rows`` (whose
arithmetic runs inside it); its committing steps equal the batches'
``batch.commit_steps``.  On a mesh the loop is the eager one, and
``scored_rows`` runs once per committing step and shard.

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
import dataclasses
import itertools
import json
import math
import os
import random
import re
import signal
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


def side_by_side(chains):
    """Run each chain of ``chains`` ({chain: (worlds, callable)}, where
    ``worlds`` labels the worlds the callable runs one after the other)
    in a thread of its own, side by side (each world is a child process,
    so they share only the host).  Returns ``(results by chain,
    beside)``: ``beside`` names, for each world, the worlds of the other
    chains, which ran on the same host while it did.  The first fault is
    raised once every chain has ended."""
    out, faults = {}, []
    beside = {w: [o for other, (theirs, _) in chains.items()
                  if other != chain for o in theirs]
              for chain, (worlds, _) in chains.items() for w in worlds}

    def run(label, fn):
        try:
            out[label] = fn()
        except BaseException as exc:  # noqa: BLE001 — raised below
            faults.append(exc)

    threads = [threading.Thread(target=run, args=(label, fn),
                                name=f"world-{label}")
               for label, (_, fn) in chains.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if faults:
        raise faults[0]
    return out, beside


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


def check_mesh_launches(res, counts, what):
    """The launches of one batch (:func:`loop_counts`) held to the bounds
    of :func:`committing_steps_bounds`: on a mesh a committing spec step
    launches ``scored_rows`` once per shard (D times the bounds); on the
    single card the round kernel runs once a batch and its committing
    steps lie inside the bounds.  Returns the bounds the count was held
    to."""
    d = res.mesh_shards
    lo, hi = committing_steps_bounds(res)
    launches = counts["scored_rows_launches"]
    if d:
        if launches <= 0 or not d * lo <= launches <= d * hi:
            raise AssertionError(f"{what}: scored_rows launched {launches} "
                                 f"times, outside {d} x the committing "
                                 f"spec steps [{lo}, {hi}] read from the "
                                 f"result")
        return [d * lo, d * hi]
    steps = counts["committing_spec_steps"]
    if not one_card_work_ok(counts, res.rounds) or not lo <= steps <= hi:
        raise AssertionError(f"{what}: {counts} on one card, {res.rounds} "
                             f"rounds, committing spec steps [{lo}, {hi}] "
                             f"read from the result")
    return [lo, hi]


def phase_config_b(dev):
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops import batch_sched

    nodes = [strip_node(mock.node()) for _ in range(10_000)]
    batches = [[strip_job(mock.job(), 1000) for _ in range(100)]]
    for _ in range(2):
        batches.append([strip_job(mock.job(), 200, cpu=100, mem=128)
                        for _ in range(10)])
    live = []
    out = []
    round_launches = 0
    for b, jobs in enumerate(batches):
        res, counts = run_counted(lambda: batch_sched.schedule_batch(
            nodes, jobs, live_allocs=live, rng_seed=SEED + b, device=dev))
        launches = counts["placement_rounds_launches"]
        round_launches += launches
        steps_lo, steps_hi = committing_steps_bounds(res)
        live = live + batch_sched.placed_allocs(res, jobs)
        placed = sum(len(sp.node_ids) for sp in res.placements.values())
        unplaced = sum(sp.unplaced for sp in res.placements.values())
        over = capacity_check(nodes, live)
        agg, used_nodes = binpack_aggregate(nodes, live)
        row = {"batch": b, "jobs": len(jobs),
               "asks": sum(j.task_groups[0].count for j in jobs),
               "placed": placed, "unplaced": unplaced, "rounds": res.rounds,
               "kernel_launches": launches, **counts,
               "committing_spec_steps_from_result": [steps_lo, steps_hi],
               "validate_device_outputs": "ok", "nodes_over_capacity": over,
               "binpack_sum": agg, "nodes_used": used_nodes,
               "encode_s": res.timings["encode"],
               "device_s_cuda_events": res.timings["device"],
               "decode_s": res.timings["decode"]}
        out.append(row)
        emit({"phase": "config_b", **row})
        # One round-kernel launch a batch, no score kernel, and the
        # kernel's committing steps inside the bounds read from the result
        # (before the round kernel: one scored_rows launch a step).
        check_steps(res, counts, f"config_b batch {b}")
        if over:
            raise AssertionError(f"{over} nodes over capacity")
        if placed + unplaced != row["asks"]:
            raise AssertionError("placed + unplaced != asks")
    return out, round_launches


# -- phase rounds: the round kernel against its plain version -----------------

ROUND_OUTPUTS = ("placements", "unplaced", "used_after", "commit_scores",
                 "commit_collisions", "slots", "slot_scores", "slot_coll")
# Bytes a committing step must move per node (used, cap 16 B each, denom
# 8 B, feas 1 B, job count 4 B), and per node more for a network spec
# (bandwidth used and cap, free dynamic ports: 12 B, plus 4 B for each
# word in which the spec reserves a port) and a distinct_property spec (the
# attribute code: 4 B); per committed alloc the usage row, job count and
# slot record written.
ROUND_NODE_BYTES = 45
ROUND_NET_NODE_BYTES = 12
ROUND_DP_NODE_BYTES = 4
ROUND_ALLOC_BYTES = 32


def recorded_schedules(fn):
    """``fn()`` with the arguments of every ``kernels.device_schedule``
    call it makes recorded: ``(result, [(args, kwargs)])``."""
    from nomad_tpu_torch.ops import kernels

    calls = []
    real = kernels.device_schedule

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    kernels.device_schedule = record
    try:
        out = fn()
    finally:
        kernels.device_schedule = real
    return out, calls


def round_diffs(got, want) -> dict:
    """Per output of the placement rounds, the elements that differ (for
    floats, differing bits), and the largest absolute difference."""
    import torch

    out, worst = {}, 0.0
    for f in ROUND_OUTPUTS:
        a, b = getattr(got, f), getattr(want, f)
        if a.shape != b.shape or a.dtype != b.dtype:
            out[f] = f"{tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}"
            continue
        if a.dtype == torch.float32:
            out[f] = int((a.view(torch.int32) != b.view(torch.int32)).sum())
            worst = max(worst, float((a - b).abs().max()) if a.numel() else 0)
        else:
            out[f] = int((a != b).sum())
            worst = max(worst, float((a.double() - b.double()).abs().max())
                        if a.numel() else 0.0)
    out["rounds"] = [got.rounds, want.rounds]
    out["commit_steps"] = [got.commit_steps, want.commit_steps]
    return {"differing": out, "max_abs_err": worst,
            "equal": all(v == 0 for k, v in out.items()
                         if k in ROUND_OUTPUTS)
            and got.rounds == want.rounds
            and got.commit_steps == want.commit_steps}


def round_step_bytes(args, extra, step_specs, placed):
    """The bytes the committing steps of one batch must move (each spec
    step reads its nodes once, writes its commits once)."""
    n = args[0].shape[1]
    net, dp = extra["net"], extra["dp"]
    total = placed * ROUND_ALLOC_BYTES
    for u in step_specs:
        per = ROUND_NODE_BYTES
        if net is not None and bool(net.active[u]):
            per += ROUND_NET_NODE_BYTES
            per += 4 * int((net.resv_words[u] != 0).sum())
        if dp is not None and bool(dp.active[u]):
            per += ROUND_DP_NODE_BYTES
        total += n * per
    return total


def round_routes(call, dev, profile=False) -> dict:
    """One recorded batch through ``device_schedule`` on the card with the
    round kernel, and through ``schedule_inputs`` and the eager
    ``placement_rounds`` (the plain version, on the same CUDA tensors):
    both results held bit for bit, each route's seconds (timed without
    the step-bounds recorder, :func:`bare_rounds`), launches and
    committing steps, the kernel's grid, grid barriers a step and time
    per launch (CUDA events); with ``profile`` also its profiler time
    and share of its bound, and each route's device busy and idle
    share."""
    import torch

    from nomad_tpu_torch.ops import fused_score, kernels

    args, kwargs = call
    static_buf, dyn_buf = args[0], args[1]
    used_dev = args[2] if len(args) > 2 else kwargs.get("used_dev")
    opts = {k: kwargs[k] for k in ("max_rounds", "with_scores", "slot_m")
            if k in kwargs}
    where = {k: kwargs[k] for k in ("meta_s", "meta_d", "u_pad", "n_pad")}

    def kernel_route():
        return kernels.device_schedule(static_buf, dyn_buf, used_dev,
                                       **where, **opts)[0]

    def eager_route():
        a, extra = kernels.schedule_inputs(static_buf, dyn_buf, used_dev,
                                           **where)
        return kernels.placement_rounds(*a, **opts, **extra)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    kernel_route()    # warm: the first call builds and loads
    zero_counts()
    got = kernel_route()
    k_counts = loop_counts()
    with bare_rounds():
        _, k_s = timed(kernel_route)
    steps = []
    real_scored = fused_score.scored_rows

    def scored(*a, u_offset=0, **kw):
        steps.append(u_offset)
        return real_scored(*a, u_offset=u_offset, **kw)

    zero_counts()
    fused_score.scored_rows = scored
    try:
        want, e_s = timed(eager_route)
    finally:
        fused_score.scored_rows = real_scored
    e_counts = loop_counts()
    a, extra = kernels.schedule_inputs(static_buf, dyn_buf, used_dev,
                                       **where)
    # The plain version's rounds alone, on inputs made beforehand.
    _, e_rounds_s = timed(lambda: kernels.placement_rounds(*a, **opts,
                                                           **extra))
    placed = int(got.placements.sum()) if got.placements.numel() > 1 \
        else int((got.slots >= 0).sum())
    nbytes = round_step_bytes(a, extra, steps, placed)
    launches = k_counts["placement_rounds_launches"]
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3 / max(1, launches)
    dp_steps = sum(1 for u in steps if extra["dp"] is not None
                   and bool(extra["dp"].active[u]))
    row = {"u_pad": kwargs["u_pad"], "n_pad": kwargs["n_pad"],
           "with_networks": extra["net"] is not None,
           "with_dp": extra["dp"] is not None, **opts,
           "kernel_route": {"seconds": k_s, **k_counts},
           "eager_route": {"seconds": e_s, "rounds_seconds": e_rounds_s,
                           **e_counts},
           "rounds": got.rounds, "placed": placed, "step_bytes": nbytes,
           "bound_ms_per_launch": bound_ms, "bound_by": "bytes",
           # The kernel's grid barriers (csrc/placement_rounds.cu): four a
           # committing step, two more a distinct_property step, two a
           # round test (one before the first round and one after each
           # round that placed something under max_rounds), one a spec
           # step with k == 0 (not counted here).
           "grid_barriers_committing_steps": 4 * len(steps) + 2 * dp_steps,
           "grid_barriers_per_committing_step": (4 * len(steps)
                                                 + 2 * dp_steps)
           / max(1, len(steps)),
           **round_diffs(got, want)}
    # The grid the launch ran on (its status: blocks, keys in shared
    # memory), and with ``profile`` its device time: CUDA events around
    # each launch, the profiler's events as the cross-check.
    real_round = fused_score.placement_round
    ev, grids = [], []

    def evented(t, seed, max_rounds):
        s0 = torch.cuda.Event(enable_timing=True)
        s1 = torch.cuda.Event(enable_timing=True)
        s0.record()
        out = real_round(t, seed, max_rounds)
        s1.record()
        ev.append((s0, s1))
        grids.append(out)
        return out

    fused_score.placement_round = evented
    try:
        with bare_rounds():
            kernel_route()
    finally:
        fused_score.placement_round = real_round
    torch.cuda.synchronize()
    row["grid_blocks"] = [int(g[2]) for g in grids]
    row["keys_in_shared_memory"] = [bool(g[3]) for g in grids]
    row["kernel_ms_cuda_events"] = [a0.elapsed_time(a1) for a0, a1 in ev]
    if not profile:
        return row
    for name, fn in (("kernel_route", kernel_route),
                     ("eager_route", eager_route)):
        wall = {}

        def run():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall["s"] = time.perf_counter() - t0

        with bare_rounds():
            evs = cuda_kernel_events(profiled(run))
        if not evs:
            row[name]["device_busy_s"] = "not measured (no device events)"
            continue
        busy = sum(e.time_range.elapsed_us() for e in evs) / 1e6
        row[name].update({
            "device_ops": len(evs), "device_busy_s": busy,
            "traced_seconds": wall["s"],
            "device_idle_share": 1.0 - busy / wall["s"],
            "device_ops_per_committing_step":
                len(evs) / max(1, row[name]["committing_spec_steps"]
                               or len(steps))})
        if name == "kernel_route":
            ks = [e.time_range.elapsed_us() for e in evs
                  if "placement_rounds_kernel" in e.name]
            row["kernel_us_per_launch_profiler"] = ks
            if len(ks) != launches:
                raise AssertionError(f"the trace shows {len(ks)} round "
                                     f"kernel runs, {launches} launches")
            row.update(bound_share(bound_ms, statistics.median(ks) / 1e3))
    return row


# The grids timed at config (b) batch 0 (10,112 nodes: ten blocks of
# 1,024 threads at most), and at 250,112 and 1,000,064 nodes (a quarter,
# half and all of the H100's 132 SMs): at most this many blocks.
ROUND_GRID_CHOICES = (1, 2, 5, 10)
ROUND_GRID_CHOICES_LARGE = (33, 66, 132)


def round_grid_choice(call, dev, caps=ROUND_GRID_CHOICES, reps=5) -> list:
    """One recorded batch's rounds (``call`` from
    :func:`recorded_schedules`) through the round kernel on grids of at
    most ``caps`` blocks, on the same inputs: each result held bit for
    bit against the eager loop's, each grid's device time per launch
    (CUDA events around the launch, ``reps`` runs)."""
    import torch

    from nomad_tpu_torch.ops import fused_score, kernels

    args, kwargs = call
    used_dev = args[2] if len(args) > 2 else kwargs.get("used_dev")
    opts = {"max_rounds": 256, "slot_m": 0,
            **{k: kwargs[k] for k in ("max_rounds", "with_scores", "slot_m")
               if k in kwargs}}
    a, extra = kernels.schedule_inputs(
        args[0], args[1], used_dev,
        **{k: kwargs[k] for k in ("meta_s", "meta_d", "u_pad", "n_pad")})
    want = kernels.placement_rounds(*a, **opts, **extra)
    rows = []
    for cap in caps:
        ms, grids = [], []

        def launch(t, seed, max_rounds):
            s0 = torch.cuda.Event(enable_timing=True)
            s1 = torch.cuda.Event(enable_timing=True)
            s0.record()
            out = fused_score.placement_round(t, seed, max_rounds)
            s1.record()
            ms.append((s0, s1))
            grids.append(out)
            return out

        for _ in range(reps):
            got = kernels._kernel_rounds(
                *a, opts["max_rounds"], opts["with_scores"], opts["slot_m"],
                extra["net"], extra["dp"], launch, cap)
        torch.cuda.synchronize()
        times = [e0.elapsed_time(e1) for e0, e1 in ms]
        row = {"n_pad": kwargs["n_pad"], "max_blocks": cap,
               "grid_blocks": int(grids[-1][2]),
               "kernel_ms_cuda_events": times,
               "median_ms": statistics.median(times),
               **round_diffs(got, want)}
        rows.append(row)
        emit({"phase": "rounds", "grid_choice": row})
        if not row["equal"]:
            raise AssertionError(f"rounds: a grid of {cap} blocks differs "
                                 f"from the eager loop: {row}")
    return rows


def round_replay(label, call, dev) -> dict:
    """One recorded batch of a large phase (``call``, from
    :func:`recorded_schedules`) through both routes (:func:`round_routes`:
    the round kernel and the eager loop on the same CUDA tensors, the
    kernel's device time traced), every output bit for bit; emitted as
    phase ``rounds`` rows, so that the kernel's grid over the card is
    timed against the loop it replaced at the sizes where the grid
    matters most, and on grids of a quarter, half and all of the SMs."""
    row = {"batch": label, **round_routes(call, dev, profile=True),
           "grid_choice": round_grid_choice(call, dev,
                                            ROUND_GRID_CHOICES_LARGE)}
    k, e = row["kernel_route"], row["eager_route"]
    row["kernel_ms_per_step"] = (k["seconds"] * 1e3
                                 / max(1, k["committing_spec_steps"]))
    row["eager_ms_per_step"] = (e["seconds"] * 1e3
                                / max(1, e["committing_spec_steps"]))
    emit({"phase": "rounds", **row})
    if (not row["equal"] or k["placement_rounds_launches"] != 1
            or k["round_calls"] != 1
            or k["committing_spec_steps"] != e["committing_spec_steps"]
            or k["scored_rows_launches"]):
        raise AssertionError(f"{label}: the round kernel and the eager loop "
                             f"differ: {row}")
    return row


def phase_rounds(dev):
    """The round kernel against the eager loop on the card: config (b)'s
    three batches and phase distinct_property's batch (networks and
    distinct_property), each batch's ``device_schedule`` arguments
    recorded from the library entry on the card and replayed through both
    routes, every output bit for bit, one launch a batch; batch 0's
    seconds, committing steps, the kernel's device time per launch, its
    grid and share of the bound, each route's device idle share, and the
    kernel on grids of 1 to 10 blocks (:func:`round_grid_choice`).
    (Phases ``columnar`` and ``mesh`` replay 250,112 and 1,000,064 nodes
    the same way, :func:`round_replay`.)  Then config (b)'s batch 0 through the
    two-pass and staged dispatches: placements equal to the fused
    route's, the staged route's schedule and compact seconds."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops import batch_sched
    from nomad_tpu_torch.structs import structs as s

    nodes = [strip_node(mock.node()) for _ in range(10_000)]
    batches = [[strip_job(mock.job(), 1000) for _ in range(100)]]
    for _ in range(2):
        batches.append([strip_job(mock.job(), 200, cpu=100, mem=128)
                        for _ in range(10)])
    live, rows, fused0 = [], [], None
    for b, jobs in enumerate(batches):
        res, calls = recorded_schedules(lambda: batch_sched.schedule_batch(
            nodes, jobs, live_allocs=live, rng_seed=SEED + b, device=dev))
        if b == 0:
            fused0 = res
        live = live + batch_sched.placed_allocs(res, jobs)
        row = {"batch": f"config_b_{b}",
               **round_routes(calls[0], dev, profile=b == 0)}
        rows.append(row)
        emit({"phase": "rounds", **row})
        if b == 0:
            grid_choice = round_grid_choice(calls[0], dev)
    dp_nodes = []
    for i in range(5_000):
        n = mock.node()
        n.meta["rack"] = f"rack-{i % 500}"
        n.compute_class()
        dp_nodes.append(n)
    dp_jobs = []
    for i in range(50):
        j = net_job(1000)
        if i % 5 == 0:
            j.task_groups[0].constraints = [s.Constraint(
                "${meta.rack}", "", s.CONSTRAINT_DISTINCT_PROPERTY)]
        dp_jobs.append(j)
    _, calls = recorded_schedules(lambda: batch_sched.schedule_batch(
        dp_nodes, dp_jobs, rng_seed=SEED, device=dev,
        eval_ids=[f"dp-{i}" for i in range(len(dp_jobs))]))
    row = {"batch": "networks_dp", **round_routes(calls[0], dev)}
    rows.append(row)
    emit({"phase": "rounds", **row})
    bad = [r["batch"] for r in rows if not r["equal"]
           or not r["with_networks"] == (r["batch"] == "networks_dp")
           or r["kernel_route"]["placement_rounds_launches"] != 1
           or r["kernel_route"]["round_calls"] != 1
           or r["kernel_route"]["scored_rows_launches"]
           or r["kernel_route"]["dp_host_reads"]
           or r["kernel_route"]["committing_spec_steps"]
           != r["eager_route"]["committing_spec_steps"]
           or r["eager_route"]["scored_rows_launches"]
           != r["eager_route"]["committing_spec_steps"]]
    if bad or not rows[-1]["with_dp"]:
        raise AssertionError(f"rounds: the kernel and the eager loop "
                             f"differ on {bad}: {rows}")
    dispatch = {}
    for mode in ("two_pass", "staged"):
        res = batch_sched.schedule_batch(nodes, batches[0], rng_seed=SEED,
                                         device=dev, dispatch=mode)
        same = {k: (sp.node_ids, sp.scores.tolist(), sp.unplaced)
                for k, sp in res.placements.items()} == {
            k: (sp.node_ids, sp.scores.tolist(), sp.unplaced)
            for k, sp in fused0.placements.items()}
        dispatch[mode] = {"placements_equal_fused": same,
                          "rounds": res.rounds, "timings": res.timings}
        emit({"phase": "rounds", "dispatch": mode, **dispatch[mode]})
        if not same or (mode == "staged" and not {
                "schedule", "compact"} <= set(res.timings)):
            raise AssertionError(f"rounds: dispatch {mode}: "
                                 f"{dispatch[mode]}")
    return {"batches": rows, "grid_choice": grid_choice,
            "dispatch": dispatch}


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


# The bounds on the committing steps of every single-card placement-
# rounds result since zero_counts(), read from the placements alone
# (result_step_bounds): [lo, hi].  The round kernel reports its own
# steps; these hold that count to what it placed.
# The single card's step bounds read from its placements, and its calls
# of the placement loop that launch the round kernel (work to run).
_STEP_BOUNDS = [0, 0, 0]
_STEP_LOCK = threading.Lock()


def result_step_bounds(res, count, slot_m) -> tuple:
    """Bounds on the committing spec steps of one ``PlacementResult``,
    from its placements alone (:func:`committing_steps_bounds`' rule per
    spec): a spec that placed anything committed at least once and in at
    least as many rounds as its busiest node took its allocs (one a node
    a round), and in at most ``rounds``.  Slot mode reads the slot record
    (destinations past M are dropped, so its count is a lower bound)."""
    import numpy as np

    placed = (count.to(res.unplaced.dtype) - res.unplaced).cpu().numpy()
    rows = (res.slots if slot_m else res.placements).cpu().numpy()
    lo = hi = 0
    for u in np.flatnonzero(placed > 0):
        if slot_m:
            ids = rows[u][rows[u] >= 0]
            most = int(np.bincount(ids).max()) if ids.size else 0
        else:
            most = int(rows[u].max())
        lo += max(1, most)
        hi += res.rounds
    return lo, hi


def record_step_bounds():
    """Wrap ``kernels.run_placement_rounds`` once per process so that each
    result adds its :func:`result_step_bounds` to ``_STEP_BOUNDS``, and
    each call on a card with work (a spec, a node, a round allowed) one
    to its count of round-kernel calls."""
    from nomad_tpu_torch.ops import kernels

    real = kernels.run_placement_rounds
    if getattr(real, "step_bounds", False):
        return

    def bounded(*args, **kwargs):
        res = real(*args, **kwargs)
        feas = args[0] if args else kwargs["feas"]
        count = args[5] if len(args) > 5 else kwargs["count"]
        max_rounds = args[11] if len(args) > 11 else kwargs.get(
            "max_rounds", 256)
        work = (feas.device.type == "cuda" and min(feas.shape) > 0
                and max_rounds > 0)
        lo, hi = result_step_bounds(res, count, kwargs.get("slot_m", 0))
        with _STEP_LOCK:
            _STEP_BOUNDS[0] += lo
            _STEP_BOUNDS[1] += hi
            _STEP_BOUNDS[2] += int(work)
        return res

    bounded.step_bounds = True
    bounded.real = real
    kernels.run_placement_rounds = bounded


@contextlib.contextmanager
def bare_rounds():
    """``kernels.run_placement_rounds`` without :func:`record_step_bounds`'
    wrapper (its host read-back of every result) inside the block: for
    runs that are timed or traced, not counted."""
    from nomad_tpu_torch.ops import kernels

    wrapped = kernels.run_placement_rounds
    kernels.run_placement_rounds = getattr(wrapped, "real", wrapped)
    try:
        yield
    finally:
        kernels.run_placement_rounds = wrapped


def zero_counts():
    """Every kernel's launch count, the placement loops' counts and the
    step bounds (:func:`record_step_bounds`, installed here) set to 0."""
    from nomad_tpu_torch.ops import fused_score, kernels, preempt

    record_step_bounds()
    fused_score.LAUNCHES = fused_score.MASKED_LAUNCHES = 0
    fused_score.ROUND_LAUNCHES = preempt.LAUNCHES = 0
    kernels.COMMIT_STEPS = kernels.DP_HOST_READS = kernels.ROUNDS = 0
    with _STEP_LOCK:
        _STEP_BOUNDS[:] = [0, 0, 0]


def loop_counts() -> dict:
    """The placement loops' launches and counts since :func:`zero_counts`:
    round-kernel launches (one a call of the loop with work on one card,
    every round inside it) and those calls, ``scored_rows`` launches (one
    a committing step a shard on a mesh), the committing spec steps and
    the eager loops' distinct_property host reads, and the single card's
    step bounds read from its placements."""
    from nomad_tpu_torch.ops import fused_score, kernels

    return {"placement_rounds_launches": fused_score.ROUND_LAUNCHES,
            "round_calls": _STEP_BOUNDS[2],
            "scored_rows_launches": fused_score.LAUNCHES,
            "committing_spec_steps": kernels.COMMIT_STEPS,
            "dp_host_reads": kernels.DP_HOST_READS,
            "rounds_run": kernels.ROUNDS,
            "steps_lo": _STEP_BOUNDS[0], "steps_hi": _STEP_BOUNDS[1]}


def kernel_counts(**extra) -> dict:
    """Every kernel's launches since :func:`zero_counts` (the names of the
    ``kernels`` line), the committing spec steps and their bounds, and
    ``extra``."""
    from nomad_tpu_torch.ops import fused_score, kernels, preempt

    return {"scored_rows": fused_score.LAUNCHES,
            "masked_score_matrix": fused_score.MASKED_LAUNCHES,
            "eviction_sets": preempt.LAUNCHES,
            "placement_rounds": fused_score.ROUND_LAUNCHES,
            "round_calls": _STEP_BOUNDS[2],
            "committing_spec_steps": kernels.COMMIT_STEPS,
            "rounds_run": kernels.ROUNDS,
            "steps_lo": _STEP_BOUNDS[0], "steps_hi": _STEP_BOUNDS[1],
            **extra}


def run_counted(fn):
    """``fn()`` with the counts of :func:`loop_counts` set to 0 just before
    and read just after."""
    zero_counts()
    res = fn()
    return res, loop_counts()


def steps_in_bounds(counts) -> bool:
    """The kernel's committing steps inside the bounds read from what its
    results placed (:func:`record_step_bounds`)."""
    return (counts["steps_lo"] <= counts["committing_spec_steps"]
            <= counts["steps_hi"])


def one_card_work_ok(counts, rounds, steps=None) -> bool:
    """What one card's batches launch (the round kernel once a call of the
    placement loop with work, at least once, the rounds read from its
    status summing to ``rounds``; no score kernel; no host read of a
    distinct_property step), with the kernel's committing steps inside
    the bounds read from its placements and equal to ``steps`` (the
    server's ``batch.commit_steps``) where it is given."""
    return (counts["placement_rounds_launches"] == counts["round_calls"] > 0
            and counts["rounds_run"] == rounds
            and counts["scored_rows_launches"] == 0
            and counts.get("dp_host_reads", 0) == 0
            and steps_in_bounds(counts)
            and (steps is None or counts["committing_spec_steps"] == steps))


def check_steps(res, counts, what):
    """The card's work on one batch, held to the result: on one card one
    round-kernel launch a call of the loop, its rounds the batch's, and
    no ``scored_rows``; on a mesh one
    ``scored_rows`` launch per committing spec step and shard.  Either
    way the committing steps lie inside the bounds read from the
    result."""
    d = res.mesh_shards
    steps = counts["committing_spec_steps"]
    lo, hi = committing_steps_bounds(res)
    if d:
        ok = (counts["scored_rows_launches"] == d * steps
              and counts["placement_rounds_launches"] == 0)
    else:
        ok = one_card_work_ok(counts, res.rounds)
    if steps <= 0 or not ok or not lo <= steps <= hi:
        raise AssertionError(f"{what}: {counts}, {d} shards, "
                             f"{res.rounds} rounds, committing steps from "
                             f"the result [{lo}, {hi}]")


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
            or counts["dp_host_reads"] != 0):
        # The round kernel reads nothing back for a distinct_property
        # step (the eager loop read each step's kept count).
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
    from nomad_tpu_torch.ops import batch_sched
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
        res, counts = run_counted(lambda: batch_sched.schedule_batch(
            nodes, jobs, rng_seed=SEED,
            mesh=make_node_mesh([dev] * d)))
        same = same_batches(res, single)
        out[f"mesh{d}"] = {"mesh_shards": res.mesh_shards,
                           "rounds": res.rounds,
                           "identical_to_single": same, **counts,
                           "device_s_cuda_events": res.timings["device"]}
        if not same or res.mesh_shards != d:
            raise AssertionError(f"{d}-shard mesh disagrees: {out}")
        out[f"mesh{d}"]["launch_bounds"] = check_mesh_launches(
            res, counts, f"{d}-shard mesh")
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
        kw = ({"mesh": make_node_mesh([dev] * MESH_SHARDS)}
              if name == "mesh" else {"device": dev})
        t0 = time.perf_counter()
        (res, counts), calls = recorded_schedules(lambda: run_counted(
            lambda: batch_sched.schedule_batch(nodes, jobs,
                                               rng_seed=MESH_SEED, **kw)))
        wall = time.perf_counter() - t0
        launches = counts["scored_rows_launches"]
        over, agg, used_nodes = fleet_check(nodes, jobs, res)
        row = {"mesh_shards": res.mesh_shards, "rounds": res.rounds,
               "placed": sum(len(sp.node_ids)
                             for sp in res.placements.values()),
               "unplaced": sum(sp.unplaced for sp in res.placements.values()),
               **counts,
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
        row["launch_bounds"] = check_mesh_launches(res, counts, name)
        if over:
            raise AssertionError(f"{name}: {over} nodes over capacity")
        if name == "single":
            # The single card's batch again through both routes of the
            # placement rounds (counted apart from the batch above).
            out["rounds_replay"] = round_replay("mesh_single_1m", calls[0],
                                                dev)
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
# Phase columnar's fleet: the first quarter of phase mesh's 1,000,000
# nodes (the depth the whole run could give up to stay inside its limit:
# first half, then a quarter once a whole run with the exec family's
# processes in phase client took 1,195 s on a slow host).
COLUMNAR_NODES = 250_000


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
                   "rounds": st.rounds, "batch_commit_steps":
                   st.commit_steps, **counts, "card": smi}
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
                           "rounds": stats.rounds,
                           "batch_commit_steps": stats.commit_steps,
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
        # One round-kernel launch a batch, its committing steps the
        # batch's (before the round kernel: one scored_rows launch a
        # step).
        if row["oracle_routed"] or (
                torch_device(dev).type == "cuda"
                and not one_card_work_ok(row, row["rounds"],
                                         row["batch_commit_steps"])):
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
    over capacity, one round-kernel launch a batch."""
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

    shapes = new_shapes()
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
            # One round-kernel launch a batch, its committing steps the
            # batch's (before the round kernel: one scored_rows launch a
            # step).
            if on_card and not one_card_work_ok(row, row["rounds"],
                                                row["batch_commit_steps"]):
                errors.append(f"{w['label']} {row['wave']}: launches "
                              f"{row['placement_rounds_launches']} for "
                              f"{row['rounds']} rounds, "
                              f"{row['committing_spec_steps']} steps for "
                              f"{row['batch_commit_steps']}")
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
    # The round kernel against its plain version at every shape the waves
    # gave it: 0 differing bits.
    parity, replay = [], None
    if on_card:
        parity, _ = round_parity_rows(dev, sorted(shapes["placement_rounds"]))
        # Config (b)'s wave over these nodes through the library entry,
        # its placement rounds through both routes.
        _, calls = recorded_schedules(lambda: batch_sched.schedule_batch(
            nodes, wave0, rng_seed=COLUMNAR_SEED, device=dev))
        replay = round_replay("columnar_config_b", calls[0], dev)

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
            "placement_rounds_launches": sum(
                r["placement_rounds_launches"] for r in wc["rows"]),
            "kernel_shapes": sorted(shapes["placement_rounds"]),
            "shape_parity": parity,
            "rounds_replay": replay,
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
                   "batch_commit_steps": st.commit_steps,
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
        # One round-kernel launch a batch, its committing steps the
        # batch's (before the round kernel: one scored_rows launch a
        # step).
        if not one_card_work_ok(row, row["rounds"],
                                row["batch_commit_steps"]):
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
            "eval_path_launches": sum(r["placement_rounds_launches"]
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
                   "batch_commit_steps": st.commit_steps,
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
                             "rounds": sum(x.rounds for x in sts),
                             "batch_commit_steps": sum(x.commit_steps
                                                       for x in sts),
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


@contextlib.contextmanager
def recorded_decodes(limit):
    """Record the inputs of the first ``limit`` calls of
    ``batch_sched._decode`` (the fetched results of those batches) while
    the block runs; the calls themselves run unchanged."""
    from nomad_tpu_torch.ops import batch_sched

    real = batch_sched._decode
    calls = []

    def spy(*args, **kw):
        if len(calls) < limit:
            calls.append(args[:5])
        return real(*args, **kw)

    batch_sched._decode = spy
    try:
        yield calls
    finally:
        batch_sched._decode = real


def same_placements(a, b) -> bool:
    """Two ``_decode`` outputs equal: every spec's node ids, commit scores
    and collisions (bit for bit), unplaced count and AllocMetric
    scores."""
    if a.keys() != b.keys():
        return False
    for k, x in a.items():
        y = b[k]
        if (x.node_ids != y.node_ids or x.unplaced != y.unplaced
                or x.scores.tobytes() != y.scores.tobytes()
                or x.collisions.tobytes() != y.collisions.tobytes()
                or x.metric_scores != y.metric_scores):
            return False
    return True


def decode_routes(calls, names, reps=5):
    """``timings["decode"]``'s two routes on the same fetched results: the
    native decode (``native/decode.cc``, guard off) and the numpy twins,
    in turns, ``reps`` times each (the median); their outputs must be
    equal."""
    from nomad_tpu_torch.ops import batch_sched

    rows = []
    for name, args in zip(names, calls):
        times = {True: [], False: []}
        outs = {}
        for _ in range(reps):
            for native in (True, False):
                t0 = time.perf_counter()
                outs[native] = batch_sched._decode(
                    *args, native_decode=native, decode_guard_every=0)
                times[native].append(time.perf_counter() - t0)
        if not same_placements(outs[True], outs[False]):
            raise AssertionError(f"{name}: the native decode differs from "
                                 "the numpy twin's")
        coo = args[3]
        rows.append({"batch": name, "coo_entries": int(len(coo)),
                     "placed": sum(len(p.node_ids)
                                   for p in outs[True].values()),
                     "decode_native_s": statistics.median(times[True]),
                     "decode_twin_s": statistics.median(times[False]),
                     "native_equals_twin": True})
    return rows


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
    # Batch 0's and the follow-ups' fetched results are kept for the
    # decode routes' times below.
    with recorded_decodes(len(head)) as fetched:
        w1 = applied_world(dev, nodes, head, smi,
                           "card mirror guard_every=1", stream=stream,
                           drills=drills, counted=True, check_mirror=True,
                           columnar=False)
    decode = decode_routes(fetched, [n for n, _ in head])
    for row in decode:
        emit({"phase": "applied", "decode_routes": row, "card": smi})
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
    # One round-kernel launch a batch and the kernel's committing steps
    # the batches' (on the card; the CPU computes the plain version).
    # Before the round kernel: one scored_rows launch a committing step.
    on_card = torch_device(dev).type == "cuda"
    for counts in [r for _, r in w1["rows"]
                   if "placement_rounds_launches" in r] + [w1["stream"]]:
        if on_card and not one_card_work_ok(counts, counts["rounds"],
                                            counts["batch_commit_steps"]):
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
        "decode_routes": decode,
        "applied_path_launches": sum(
            r.get("placement_rounds_launches", 0) for _, r in w1["rows"])
        + w1["stream"]["placement_rounds_launches"],
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
            zero_counts()
        st = run()
        if counted:
            counts = {"eviction_sets_launches": preempt.LAUNCHES,
                      **loop_counts(), "rounds": st.rounds,
                      "batch_commit_steps": st.commit_steps}
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
    # One eviction-set launch a preempting batch, and on the single card
    # the round kernel once a batch with the batch's committing steps
    # (before it: scored_rows launches > 0).
    if on_card and (mr["eviction_sets_launches"] != 1
                    or not one_card_work_ok(mr, mr["rounds"],
                                            mr["batch_commit_steps"])
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
                                         "placement_rounds_launches",
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


def server_rounds(srv) -> float:
    """The placement rounds the server's device batches ran: the sum of
    its ``worker.invoke_scheduler.rounds`` samples since it started."""
    tot = srv.metrics.sink.latest()["SampleTotals"]
    return tot.get("nomad.worker.invoke_scheduler.rounds", (0, 0.0))[1]


def launches_ok(lc, need_launch=True) -> bool:
    """A counted card run of single-card servers (:func:`kernel_counts`
    with the servers' ``rounds`` and ``batch_commit_steps``): one
    round-kernel launch a call of the placement loop with work, the
    rounds read from its status the servers' rounds, the kernel's
    committing steps the servers' ``batch.commit_steps`` and inside the
    bounds read from what the batches placed, no ``scored_rows`` launch
    (before the round kernel: one a committing step), and with
    ``need_launch`` at least one launch."""
    return (lc["placement_rounds"] == lc["round_calls"]
            and lc["rounds_run"] == lc["rounds"]
            and lc["committing_spec_steps"] == lc["batch_commit_steps"]
            and lc["scored_rows"] == 0 and steps_in_bounds(lc)
            and (lc["placement_rounds"] > 0 or not need_launch))


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


def new_shapes() -> dict:
    """An empty record for :func:`kernel_shapes`."""
    return {"scored_rows": set(), "eviction_sets": set(),
            "placement_rounds": set()}


@contextlib.contextmanager
def kernel_shapes(shapes):
    """Record into ``shapes`` the shape of every call of the server path's
    kernel wrappers: ``(u, n, n_offset)`` of ``scored_rows``, ``(u, n,
    a)`` of ``eviction_sets`` and ``(u, n)`` of the round kernel's
    ``placement_round``.  They are called through their modules, so the
    recorders stand in for them until the block ends."""
    from nomad_tpu_torch.ops import fused_score, preempt

    score, evict = fused_score.scored_rows, preempt.eviction_sets
    round_ = fused_score.placement_round

    def score_rec(feas, *args, n_offset=0, **kwargs):
        shapes["scored_rows"].add((*feas.shape, n_offset))
        return score(feas, *args, n_offset=n_offset, **kwargs)

    def evict_rec(free, used, denom, prio, sizes, ask, job_prio):
        shapes["eviction_sets"].add((ask.shape[0], *prio.shape))
        return evict(free, used, denom, prio, sizes, ask, job_prio)

    def round_rec(t, seed, max_rounds):
        shapes["placement_rounds"].add(tuple(t["feas"].shape))
        return round_(t, seed, max_rounds)

    fused_score.scored_rows, preempt.eviction_sets = score_rec, evict_rec
    fused_score.placement_round = round_rec
    try:
        yield
    finally:
        fused_score.scored_rows, preempt.eviction_sets = score, evict
        fused_score.placement_round = round_


def round_parity_rows(dev, shapes):
    """The round kernel against its plain version, the eager loop, on the
    card at each ``(u, n)`` of ``shapes``, on seeded inputs
    (``round_inputs.py``, networks and distinct_property on, counts cut
    to 64 so the eager loop stays short): every output equal, 0
    differing bits.  Returns the rows and the largest difference."""
    import numpy as np

    from nomad_tpu_torch.ops import kernels
    from round_inputs import port_rounds_args, random_rounds

    rows, worst = [], 0.0
    seed = kernels.jitter_seed(SEED)
    for u, n in shapes:
        x = random_rounds(SEED + u + n, u, n, net=True, dp=True)
        x["count"] = np.minimum(x["count"], 64).astype(np.int32)
        args, extra = port_rounds_args(x, dev)
        got = kernels.run_placement_rounds(*args, seed, slot_m=64, **extra)
        want = kernels.placement_rounds(*args, seed, slot_m=64, **extra)
        row = {"u": u, "n": n, "rounds": got.rounds,
               "commit_steps": got.commit_steps, **round_diffs(got, want)}
        rows.append(row)
        worst = max(worst, row["max_abs_err"])
        if not row["equal"]:
            raise AssertionError(f"round kernel differs from the eager "
                                 f"loop: {row}")
    return rows, worst


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
                zero_counts()
            with (kernel_shapes(shapes) if shapes is not None
                  else contextlib.nullcontext()):
                body(srv)
        launches = kernel_counts(
            batch_commit_steps=server_counter(srv, "batch.commit_steps"),
            rounds=server_rounds(srv))
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
           "kernel_shapes": new_shapes()}
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
    nack, no failed eval; and on the card one round-kernel launch a
    round, its committing steps those the batches report, one
    eviction_sets launch in the drill."""
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
        if on_card and not launches_ok(lc):
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


def path_shape_parity(dev, shapes, label) -> dict:
    """The round kernel, and ``scored_rows`` where the path gave it
    shapes, against its plain version at every shape a card path without
    preemption gave it (``shapes`` of :func:`kernel_shapes`, sets or the
    lists a child process sent): 0 differing bits.  Raises when the path
    gave the round kernel no shape or ``eviction_sets`` one."""
    rounds = sorted(tuple(x) for x in shapes["placement_rounds"])
    if not rounds or shapes["eviction_sets"]:
        raise AssertionError(f"{label} kernel shapes: {shapes}")
    rrows, rworst = round_parity_rows(dev, rounds)
    srows, sworst = score_parity_rows(
        dev, [(u, n, 17, n_off) for u, n, n_off in
              sorted(tuple(x) for x in shapes["scored_rows"])])
    return {"placement_rounds": rrows, "scored_rows": srows,
            "max_abs_err": max(rworst, sworst)}


def server_shape_parity(dev, shapes, on_card) -> dict:
    """Each kernel against its plain version at every shape the card's
    server run gave it: 0 differing bits.  The single card's path gives
    the round kernel and ``eviction_sets`` their shapes (``scored_rows``
    runs on a mesh, or inside the round kernel)."""
    from eviction_inputs import random_inputs

    if not on_card:
        return {}
    score = sorted(shapes["scored_rows"])
    evict = sorted(shapes["eviction_sets"])
    rounds = sorted(shapes["placement_rounds"])
    if not rounds or not evict:
        raise AssertionError(f"the server path gave a kernel no shape: "
                             f"{shapes}")
    rows, worst = score_parity_rows(
        dev, [(u, n, 17, n_off) for u, n, n_off in score])
    rrows, rworst = round_parity_rows(dev, rounds)
    erows, eworst = evict_parity_rows(
        dev, [(f"server u={u} n={n} a={a}",
               random_inputs(n, u, a, seed=PREEMPT_SEED + n + a))
              for u, n, a in evict])
    return {"scored_rows": rows, "placement_rounds": rrows,
            "eviction_sets": erows, "max_abs_err": max(worst, rworst,
                                                       eworst)}


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
    if on_card and not launches_ok(lc):
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
    # One round-kernel launch a batch, its committing steps the batch's
    # (before the round kernel: one scored_rows launch a step).
    if on_card and not one_card_work_ok(counts, card["stats"].rounds,
                                        card["stats"].commit_steps):
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
            "placement_rounds_launches": counts.get(
                "placement_rounds_launches", 0),
            "round_calls": counts.get("round_calls", 0),
            "committing_spec_steps": counts.get("committing_spec_steps", 0),
            "batch_commit_steps": st.commit_steps,
            "rounds_run": counts.get("rounds_run", 0),
            "steps_bounds": [counts.get("steps_lo", 0),
                             counts.get("steps_hi", 0)],
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
        events = trace_kernel_events(card["session"]["dir"],
                                     "placement_round")
    cpu = fingerprint_world("cpu", nodes, jobs)
    h = card["h"]
    placed = [a for a in h.state.allocs(None) if not a.terminal_status()]
    off = [a.id for a in placed if a.node_id not in gpu_nodes]
    counts = card["counts"]
    launches = counts["placement_rounds_launches"]
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
    # The round kernel in the tracer's trace once a launch, once a batch,
    # its committing steps the batch's (before the round kernel: one
    # scored_rows event and launch a committing step).
    if on_card and (len(events) != launches or not one_card_work_ok(
            counts, card["stats"].rounds, card["stats"].commit_steps)):
        errors.append(f"{len(events)} round kernel events in the trace, "
                      f"counts {counts}")
    if errors:
        raise AssertionError(f"fingerprint: {errors}")
    return {"attributes": want, "fingerprint_node": applied,
            "gpu_nodes": len(gpu_nodes), "placed": len(placed),
            "off_fingerprinted_nodes": 0, "nodes_over_capacity": 0,
            "card_equals_cpu": True, "second_start_refused": True,
            "session_s": card["session"]["duration_s"],
            "trace_round_kernel_events": len(events),
            "placement_rounds_launches": launches,
            "scored_rows_launches": counts["scored_rows_launches"],
            "committing_spec_steps": counts["committing_spec_steps"],
            "steps_bounds": [counts["steps_lo"], counts["steps_hi"]],
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
# Half of phase 17's fleet and of config (b)'s wave 1 (cut to keep the
# whole run inside its time limit); wave 3 and the follow-up.
DURABLE_SIZES = {"n_nodes": 5_000, "n_jobs": 50, "count": 1000,
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
    """``server_content``, the queued count of every job's groups and
    every job's version history (``job_versions_by_id``: id and version,
    newest first), as JSON gives them back (so a child's report
    compares)."""
    out = server_content(srv)
    st = srv.state
    queued = {}
    for job_id in sorted({e.job_id for e in st.evals(None)}):
        summ = st.job_summary_by_id(None, job_id)
        if summ is not None:
            queued[job_id] = {tg: v.queued
                              for tg, v in sorted(summ.summary.items())}
    out["queued"] = queued
    out["job_versions"] = {
        j.id: [[v.id, v.version] for v in st.job_versions_by_id(None, j.id)]
        for j in sorted(st.jobs(None), key=lambda j: j.id)}
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


def zero_launches(srv) -> tuple:
    """Set the kernels' launch counts to 0; returns the server's count of
    committing steps and of rounds so far, for :func:`durable_launches`."""
    zero_counts()
    return (server_counter(srv, "batch.commit_steps"), server_rounds(srv))


def durable_launches(srv, base) -> dict:
    """The launch counts since :func:`zero_launches` returned ``base``,
    and the committing steps and rounds the batches reported since."""
    steps0, rounds0 = base
    return kernel_counts(
        batch_commit_steps=server_counter(srv, "batch.commit_steps")
        - steps0, rounds=server_rounds(srv) - rounds0)


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
    for key in ("queued", "job_versions"):
        if a[key] != b[key]:
            diff[key] = {k: (a[key].get(k), b[key].get(k))
                         for k in set(a[key]) | set(b[key])
                         if a[key].get(k) != b[key].get(k)}
    return diff


def check_launches(label, counts, need_launch=True) -> list:
    """One round-kernel launch a batch in one part of a card world's
    run, the kernel's committing steps the servers' (at least one launch
    when ``need_launch``; :func:`launches_ok`), and no other kernel's
    launch.  Before the round kernel: one ``scored_rows`` launch a
    committing step."""
    if (not launches_ok(counts, need_launch)
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
    for key in ("allocs", "evals", "queued", "job_versions"):
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
    for key in ("allocs", "evals", "queued", "job_versions"):
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
        # The card's worlds (A's crash, then its restart, then B) in one
        # chain, beside the CPU's C (its crash, then its restart).
        secs = {}

        def crash_restart(label, device):
            t0 = time.perf_counter()
            child = run_durable_child("crash", device, dirs[label], sizes)
            after = run_durable_child("restart", device, dirs[label], sizes,
                                      child["draws_after_crash"])
            secs[label] = time.perf_counter() - t0
            return child, after

        def card_chain():
            out = crash_restart("A", dev)
            t0 = time.perf_counter()
            twin = run_durable_child("twin", dev, root, sizes)
            secs["B"] = time.perf_counter() - t0
            return out, twin

        worlds, beside = side_by_side({
            "card": (["A", "B"], card_chain),
            "C": (["C"], lambda: crash_restart("C", "cpu"))})
        (a_child, a), b = worlds["card"]
        c_child, c = worlds["C"]
        t_a, t_b, t_c = secs["A"], secs["B"], secs["C"]
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
            emit({"phase": "durable", "world": label,
                  "ran_beside": beside[label], **row})
    for w, label in ((a, "A"), (b, "B"), (c, "C")):
        for row in w["waves_after"]:
            emit({"phase": "durable", "world": label, "after_restart":
                  label != "B", "ran_beside": beside[label], **row})

    def wave1_rate(w):
        return w["waves"][0]["evals_per_s"]

    return {
        "card": smi, "fs": {"A": a["fs"], "C": c["fs"]},
        "restored_equals_pre_crash": True, "torn_entry_absent": True,
        "a_equals_b_equals_c": True,
        "job_versions_compared": sum(
            len(v) for v in a["after"]["job_versions"].values()),
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
        "ran_beside": beside,
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
# Leg 1: a quarter of phase 17's fleet (2,500 nodes) and a quarter of
# config (b)'s wave 1 (25 x 1000; the asks past the fleet's room block),
# wave 2 (10 x 200) and a follow-up (10 x 200).  Leg 2: its fleet and
# jobs, halved.  Both cut (5,000 nodes and 100 x 1000, then 50 x 1000;
# 2,000 nodes and 200 jobs before) to keep the whole run inside its time
# limit; every compared item holds at these sizes.
CLUSTER_SIZES = {"n_nodes": 2_500, "n_jobs": 25, "count": 1000,
                 "wave_jobs": 10, "wave_count": 200, "follow_jobs": 10}
LEG2_SIZES = {"n_nodes": 1_000, "n_jobs": 100, "count": 20}
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
    leadership is established: the restores and the reapers have run,
    so what it holds can be compared); raises past ``timeout``."""
    from nomad_tpu_torch.utils.backoff import wait_until

    def lead():
        return next((x for x in servers
                     if x.leadership_established() and getattr(
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

        def world(label, mode, d, world_sizes):
            t0 = time.perf_counter()
            worlds[label] = run_cluster_child(mode, d, root, world_sizes)
            secs[label] = time.perf_counter() - t0

        def card_chain():
            # The card's worlds one after the other: A, B, then leg 2.
            world("A", "leg1", dev, sizes)
            world("B", "single", dev, sizes)
            world("leg2", "leg2", dev, leg2_sizes)

        _, beside = side_by_side({
            "card": (["A", "B", "leg2"], card_chain),
            "C": (["C"], lambda: world("C", "leg1", "cpu", sizes))})
        leg2 = worlds["leg2"]
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
            emit({"phase": "cluster", "world": label,
                  "ran_beside": beside[label], **row})
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
        "ran_beside": beside,
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
    from nomad_tpu_torch.server.eval_broker import BrokerLimitError
    from nomad_tpu_torch.state import columnar as colmod
    from nomad_tpu_torch.structs import structs as ps
    from nomad_tpu_torch.utils.backoff import wait_until

    sc = lifecycle_scenario(**sizes)
    colmod.reset_counters()
    resident.reset_counters()
    brk = KernelCircuitBreaker()
    # The broker draws among the ready service and batch queues at
    # random: one seeded draw sequence in every world, so the batches
    # hold their evals in the same order.
    srv = Server(ServerConfig(
        device=dev, rng_seed=SERVER_SEED, broker_seed=LIFECYCLE_SEED,
        batch_size=64,
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
        worlds, beside = side_by_side({
            "card": (["card"], lambda: run_lifecycle_child(dev, root, sizes)),
            "cpu": (["cpu"], lambda: run_lifecycle_child("cpu", root,
                                                         sizes))})
        card, cpu = worlds["card"], worlds["cpu"]
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
                  "ran_beside": beside[label],
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
        "ran_beside": beside,
        "seconds": time.perf_counter() - t_phase}


def torch_device(dev):
    import torch

    d = torch.device(dev)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


# -- phase 24: loadgen -------------------------------------------------------

# Far below any real plan-apply p99 (ms): the SLO watch must fire.
LOADGEN_SLO_MS = 1e-3
BUNDLE_SECTIONS = ("Spans", "Events", "Profile", "Locks", "Threads",
                   "Breaker", "Servers", "Config")


def read_bundles(rec, reason) -> list:
    """The bundles ``rec`` wrote for ``reason``, each parsed (a bundle
    that is no valid JSON raises)."""
    out = []
    for path in rec.captured:
        with open(path, encoding="utf-8") as fh:
            bundle = json.load(fh)
        if bundle["Reason"] == reason:
            out.append(bundle)
    return out


def loadgen_baseline(dev, sc, bdir, smi) -> dict:
    """Part (a): ``sc`` (the reference's ``baseline``) through a port
    ``Server`` on ``dev`` by the load harness, with the profiler, the
    flight recorder and its SLO watch and the lock-order sanitizer armed;
    the kernels' counts set to 0 just before the run and read just
    after."""
    from nomad_tpu_torch.loadgen import LoadHarness
    from nomad_tpu_torch.loadgen.auditor import integrity_sweep
    from nomad_tpu_torch.ops import fused_score, kernels, preempt
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.utils import blackbox, contprof, lockcheck
    from nomad_tpu_torch.utils.backoff import wait_until

    on_card = torch_device(dev).type == "cuda"
    brk = KernelCircuitBreaker()
    h = LoadHarness(sc, device=dev, server_options={
        "breaker": brk, "rng_seed": SEED, "contprof_hz": 10.0,
        "blackbox_dir": bdir, "blackbox_min_interval_s": 3600.0,
        "slo_plan_p99_ms": LOADGEN_SLO_MS})
    # A follower of the stream's Blackbox topic from the server's start
    # (before the first plan, so before any SLO tick can fire).
    captured_events = []
    stop = threading.Event()

    def follow():
        while h.server is None and not stop.wait(0.001):
            pass
        if h.server is None:
            return
        sub = h.server.event_stream_subscribe(topics={"Blackbox": set()})
        while not stop.is_set():
            ev = sub.next(timeout=0.1)
            if ev is not None:
                captured_events.append((ev.type, ev.key,
                                        (ev.payload or {}).get("Path")))
        sub.close()

    follower = threading.Thread(target=follow, daemon=True,
                                name="loadgen-bundle-follower")
    shapes = new_shapes()
    lockcheck.arm()
    try:
        lockcheck.reset()
        follower.start()
        zero_counts()
        t0 = time.perf_counter()
        with kernel_shapes(shapes):
            report = h.run()
        run_s = time.perf_counter() - t0
        srv = h.server
        launches = kernel_counts(
            batch_commit_steps=server_counter(srv, "batch.commit_steps"),
            rounds=server_rounds(srv))
        rec = blackbox.recorder()
        wait_until(lambda: rec.captured, 10.0)
        bundles = read_bundles(rec, "slo.plan_apply_p99")
        stop.set()
        follower.join(timeout=5.0)
        cycle = lockcheck.find_cycle()
        lockcheck.assert_acyclic()
        lock_edges = len(lockcheck.edges())
    finally:
        stop.set()
        lockcheck.disarm()
        contprof.disable()
        recorder = blackbox.recorder()
        blackbox.disable()
    errors = []
    off, sus = report["offered"], report["sustained"]
    if (off["submitted"] != sc.max_submissions
            or off["dropped_after_retries"] or sus["stragglers_after_drain"]
            or sus["completed_total"] != sc.max_submissions):
        errors.append(f"submissions not all acknowledged and complete: "
                      f"{off} {sus}")
    short = {}
    for job in srv.state.jobs(None):
        want = sum(tg.count for tg in job.task_groups)
        got = len([a for a in srv.state.allocs_by_job(None, job.id, True)
                   if not a.terminal_status()])
        if got != want:
            short[job.id] = (got, want)
    if short or len(srv.state.jobs(None)) != sc.max_submissions:
        errors.append(f"jobs without their count: "
                      f"{dict(list(short.items())[:8])}")
    sweep = integrity_sweep(srv.state, strict=True)
    if (sweep["overplaced_jobs"] or sweep["duplicate_alloc_names"]
            or sweep["overcommitted_nodes"]
            or sweep["tenant_quota_violations"]):
        errors.append(f"strict integrity sweep: {sweep}")
    b = srv.eval_broker.stats()
    health = {"nacks": b["total_nacks"], "failed": b["total_failed"],
              "breaker": brk.state, "trips": brk.trips,
              "oracle_routed": server_counter(srv, "breaker.oracle_routed")}
    if health != {"nacks": 0, "failed": 0, "breaker": "closed", "trips": 0,
                  "oracle_routed": 0}:
        errors.append(f"health {health}")
    if on_card:
        errors += check_launches("loadgen", launches)
    if len(bundles) != 1:
        errors.append(f"{len(bundles)} slo.plan_apply_p99 bundles "
                      f"(captured {recorder.captured}, failures "
                      f"{recorder.failures})")
    else:
        missing = [k for k in BUNDLE_SECTIONS if k not in bundles[0]]
        if missing or not bundles[0]["Servers"]:
            errors.append(f"the SLO bundle lacks {missing}")
    slo_events = [e for e in captured_events
                  if e[:2] == ("BundleCaptured", "slo.plan_apply_p99")]
    if len(slo_events) != 1 or slo_events[0][2] not in recorder.captured:
        errors.append(f"BundleCaptured events {captured_events}")
    ha = report.get("host_attribution") or {}
    if ha.get("non_idle_coverage", 0.0) < 0.80:
        errors.append(f"host attribution coverage "
                      f"{ha.get('non_idle_coverage')} < 0.80: "
                      f"{ha.get('shares')}")
    if cycle is not None:
        errors.append(f"lock-order cycle {cycle}")
    if errors:
        raise AssertionError(f"loadgen baseline: {errors}")
    lat = report["latency_ms"]
    line = {
        "phase": "loadgen", "part": "baseline", "card": smi,
        "evals_per_s": sus["evals_per_s"],
        "placed_per_s": sus["placed_per_s"],
        "evals_per_s_window": sus["evals_per_s_window"],
        "submit_to_running_ms": {k: lat["submit_to_running"][k]
                                 for k in ("p50", "p95", "p99")},
        "submit_to_complete_ms": {k: lat["submit_to_complete"][k]
                                  for k in ("p50", "p95", "p99")},
        "plan_apply_ms": {k: lat["plan_apply"].get(k)
                          for k in ("p50", "p99")},
        "plan_evaluate_ms": {k: lat["plan_evaluate"].get(k)
                             for k in ("p50", "p99")},
        "cpu_shares": ha.get("shares"),
        "coverage": ha.get("non_idle_coverage"),
        "thread_samples": ha.get("thread_samples"),
        "gil_ms": {k: ha["gil_pressure_ms"][k] for k in ("p50", "p99")},
        "top_lock_waits": [{k: w[k] for k in ("name", "count", "wait_s_sum",
                                              "p99_ms")}
                           for w in (ha.get("top_locks") or [])[:3]],
        "lock_edges": lock_edges,
        "heartbeat_renewals": report["heartbeat"]["renewals"],
        "event_fanout_us": report["event_fanout"].get("us_per_event"),
        "run_s": run_s}
    emit(line)
    return {"line": line, "launches": launches, "shapes": shapes,
            "broker": report["control_plane"]["broker"]["Pending"],
            "integrity": sweep}


def loadgen_drill(dev, bdir, smi) -> dict:
    """Part (b): the reference's breaker drill (``ops/__main__.py``) on
    ``dev`` with the flight recorder, the tracing plane and the
    lock-order sanitizer armed: exactly one ``breaker.open`` bundle
    holding the tripping batch's ``fault.fire`` span and
    ``breaker.transition`` event and the private breaker at one trip; a
    second trigger inside the interval writes nothing; no lock-order
    cycle."""
    from nomad_tpu_torch.ops import fused_score, kernels, preempt
    from nomad_tpu_torch.ops.__main__ import breaker_drill
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.utils import blackbox, lockcheck, tracing
    from nomad_tpu_torch.utils.backoff import wait_until

    on_card = torch_device(dev).type == "cuda"
    log = []
    tracing.enable()
    lockcheck.arm()
    try:
        lockcheck.reset()
        rec = blackbox.enable(bdir, min_interval_s=3600.0)
        clock = [0.0]
        brk = KernelCircuitBreaker(threshold=0.9, window=8, min_checks=1,
                                   cooldown=5.0, clock=lambda: clock[0])
        zero_counts()
        ok = breaker_drill(seed=SEED, device=dev, log=log.append,
                           breaker=brk, clock=clock)
        launches = kernel_counts()
        wait_until(lambda: rec.captured, 10.0)
        suppressed = rec.suppressed
        blackbox.note_trigger("breaker.open", {"Trips": brk.trips})
        time.sleep(0.5)
        bundles = read_bundles(rec, "breaker.open")
        captured = list(rec.captured)
        refused = rec.suppressed - suppressed
        cycle = lockcheck.find_cycle()
        lockcheck.assert_acyclic()
    finally:
        blackbox.disable()
        lockcheck.disarm()
        tracing.disable()
    errors = []
    if not ok:
        errors.append(f"the drill failed: {log}")
    if len(bundles) != 1 or len(captured) != 1 or refused != 1:
        errors.append(f"breaker.open bundles {len(bundles)} of "
                      f"{captured}; the second trigger refused {refused}")
    else:
        spans = bundles[0]["Spans"]
        fires = [sp for sp in spans if sp["Name"] == "fault.fire"]
        trans = [sp for sp in spans if sp["Name"] == "breaker.transition"
                 and sp["Attrs"].get("to") == "open"]
        if (len(fires) != 1 or len(trans) != 1
                or fires[0]["Attrs"].get("point") != "ops.kernel_result"
                or fires[0]["Start"] > trans[0]["Start"]):
            errors.append(f"the bundle's spans: fault.fire {fires}, "
                          f"breaker.transition {trans}")
        trig = bundles[0]["Breaker"].get("Trigger") or {}
        if trig.get("Trips") != 1 or bundles[0]["Detail"].get("Trips") != 1:
            errors.append(f"the bundle's breaker {bundles[0]['Breaker']}")
        missing = [k for k in BUNDLE_SECTIONS if k not in bundles[0]]
        if missing:
            errors.append(f"the drill's bundle lacks {missing}")
    if brk.state != "closed" or brk.trips != 1:
        errors.append(f"breaker {brk.state} after {brk.trips} trips")
    # The round kernel once a batch the drill's batches ran, no other
    # kernel (before the round kernel: one scored_rows launch a step).
    if on_card and (launches["placement_rounds"] <= 0
                    or launches["placement_rounds"]
                    != launches["round_calls"]
                    or launches["rounds_run"] <= 0
                    or launches["committing_spec_steps"] <= 0
                    or not steps_in_bounds(launches)
                    or launches["scored_rows"]
                    or launches["masked_score_matrix"]
                    or launches["eviction_sets"]):
        errors.append(f"drill launches {launches}")
    if cycle is not None:
        errors.append(f"lock-order cycle {cycle}")
    if errors:
        raise AssertionError(f"breaker drill: {errors}")
    line = {"phase": "loadgen", "part": "breaker_drill", "card": smi,
            "drill": log[-1] if log else "", "launches": launches,
            "bundle_spans": [sp["Name"] for sp in bundles[0]["Spans"]],
            "bundle_breaker": bundles[0]["Breaker"]}
    emit(line)
    return {"launches": launches}


def phase_loadgen(dev, scenario=None):
    """The load harness and the flight recorder (see the module
    docstring, phase 24): part (a), the ``baseline`` scenario, then part
    (b), the breaker drill; each kernel at the shapes part (a) gave it
    against its plain version."""
    import shutil
    import tempfile

    from nomad_tpu_torch.loadgen.scenario import get_scenario

    t_phase = time.perf_counter()
    smi = smi_name_power()
    on_card = torch_device(dev).type == "cuda"
    sc = scenario or get_scenario("baseline")
    root = tempfile.mkdtemp(prefix="nomad-torch-loadgen-")
    try:
        base = loadgen_baseline(dev, sc, os.path.join(root, "a"), smi)
        drill = loadgen_drill(dev, os.path.join(root, "b"), smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    shape_parity = {}
    if on_card:
        shape_parity = path_shape_parity(dev, base["shapes"], "loadgen")
    return {"card": smi, "scenario": sc.name,
            "baseline": base["line"],
            "kernel_shapes": {k: sorted(v)
                              for k, v in base["shapes"].items()},
            "shape_parity": shape_parity,
            "launches": {"baseline": base["launches"],
                         "breaker_drill": drill["launches"]},
            "seconds": time.perf_counter() - t_phase}


# -- phase 25: agent ---------------------------------------------------------

AGENT_SEED = 20261117
# Every world of the phase runs in a process of its own under this string
# hash seed (a node update's evals follow set order; ROADMAP queue 3
# item 13).
AGENT_HASH_SEED = 20261117
AGENT_CHILD_TIMEOUT = 600.0
AGENT_SIZES = {"n_nodes": 10_000, "n_rpc": 100, "n_jobs": 100,
               "count": 1000}
# The HCL agent config of the HTTP worlds: a server, no client, HTTP and
# RPC on ephemeral ports, the in-memory log (no data_dir).
AGENT_HCL = """
name      = "agent-smoke"
region    = "global"
log_level = "WARN"
bind_addr = "127.0.0.1"
ports {
  http = 0
  rpc  = 0
}
server {
  enabled        = true
  num_schedulers = 1
  batch_size     = 64
}
client {
  enabled = false
}
"""


def _hcl_str(v) -> str:
    return json.dumps(str(v))


def _hcl_dur(seconds: float) -> str:
    return _hcl_str(f"{float(seconds)!r}s")


def _hcl_map(name: str, d: dict, pad: str) -> list:
    if not d:
        return []
    return ([f"{pad}{name} {{"]
            + [f"{pad}  {json.dumps(k)} = {_hcl_str(v)}"
               for k, v in d.items()] + [f"{pad}}}"])


def _hcl_constraints(cs, pad: str) -> list:
    out = []
    for c in cs:
        out += [f"{pad}constraint {{",
                f"{pad}  attribute = {_hcl_str(c.ltarget)}",
                f"{pad}  operator  = {_hcl_str(c.operand)}",
                f"{pad}  value     = {_hcl_str(c.rtarget)}", f"{pad}}}"]
    return out


def job_hcl(job) -> str:
    """An HCL jobspec of ``job`` that ``nomad_tpu_torch.jobspec.parse``
    reads back to the same job: the fields ``mock.job()`` sets (task
    groups with their restart policy, ephemeral disk and meta; tasks with
    their driver, config, env, resources and networks, services and
    checks, log config, kill timeout and meta), every value written out,
    none left to the parser's defaults."""
    lines = [f"job {_hcl_str(job.id)} {{",
             f"  name        = {_hcl_str(job.name)}",
             f"  region      = {_hcl_str(job.region)}",
             f"  type        = {_hcl_str(job.type)}",
             f"  priority    = {job.priority}",
             f"  all_at_once = {str(job.all_at_once).lower()}",
             f"  datacenters = {json.dumps(list(job.datacenters))}"]
    lines += _hcl_map("meta", job.meta, "  ")
    lines += _hcl_constraints(job.constraints, "  ")
    if job.update.stagger or job.update.max_parallel:
        lines += ["  update {", f"    stagger      = "
                  f"{_hcl_dur(job.update.stagger)}",
                  f"    max_parallel = {job.update.max_parallel}", "  }"]
    for tg in job.task_groups:
        rp, disk = tg.restart_policy, tg.ephemeral_disk
        lines += [f"  group {_hcl_str(tg.name)} {{",
                  f"    count = {tg.count}",
                  "    restart {", f"      attempts = {rp.attempts}",
                  f"      interval = {_hcl_dur(rp.interval)}",
                  f"      delay    = {_hcl_dur(rp.delay)}",
                  f"      mode     = {_hcl_str(rp.mode)}", "    }",
                  "    ephemeral_disk {",
                  f"      sticky  = {str(disk.sticky).lower()}",
                  f"      migrate = {str(disk.migrate).lower()}",
                  f"      size    = {disk.size_mb}", "    }"]
        lines += _hcl_map("meta", tg.meta, "    ")
        lines += _hcl_constraints(tg.constraints, "    ")
        for t in tg.tasks:
            r = t.resources
            lines += [f"    task {_hcl_str(t.name)} {{",
                      f"      driver       = {_hcl_str(t.driver)}",
                      f"      user         = {_hcl_str(t.user)}",
                      f"      leader       = {str(t.leader).lower()}",
                      f"      kill_timeout = {_hcl_dur(t.kill_timeout)}"]
            lines += _hcl_map("config", t.config, "      ")
            lines += _hcl_map("env", t.env, "      ")
            lines += _hcl_map("meta", t.meta, "      ")
            lines += _hcl_constraints(t.constraints, "      ")
            for svc in t.services:
                lines += ["      service {",
                          f"        name = {_hcl_str(svc.name)}",
                          f"        port = {_hcl_str(svc.port_label)}",
                          f"        tags = {json.dumps(list(svc.tags))}"]
                for c in svc.checks:
                    lines += ["        check {",
                              f"          name     = {_hcl_str(c.name)}",
                              f"          type     = {_hcl_str(c.type)}",
                              f"          command  = {_hcl_str(c.command)}",
                              f"          args     = {json.dumps(c.args)}",
                              f"          path     = {_hcl_str(c.path)}",
                              f"          protocol = {_hcl_str(c.protocol)}",
                              f"          port     = "
                              f"{_hcl_str(c.port_label)}",
                              f"          interval = {_hcl_dur(c.interval)}",
                              f"          timeout  = {_hcl_dur(c.timeout)}",
                              f"          initial_status = "
                              f"{_hcl_str(c.initial_status)}",
                              "        }"]
                lines.append("      }")
            lines += ["      logs {",
                      f"        max_files     = {t.log_config.max_files}",
                      f"        max_file_size = "
                      f"{t.log_config.max_file_size_mb}", "      }",
                      "      resources {", f"        cpu    = {r.cpu}",
                      f"        memory = {r.memory_mb}",
                      f"        disk   = {r.disk_mb}",
                      f"        iops   = {r.iops}"]
            for net in r.networks:
                lines += ["        network {", f"          mbits = {net.mbits}"]
                lines += [f"          port {_hcl_str(p.label)} {{ static = "
                          f"{p.value} }}" for p in net.reserved_ports]
                lines += [f"          port {_hcl_str(p.label)} {{}}"
                          for p in net.dynamic_ports]
                lines.append("        }")
            lines += ["      }", "    }"]
        lines.append("  }")
    lines.append("}")
    return "\n".join(lines) + "\n"


# Fields that differ between a job as submitted and as parsed only by
# when and where it was stored.
_WIRE_UNCOMPARED = frozenset({"CreateIndex", "ModifyIndex", "JobModifyIndex",
                              "SubmitTime"})


def wire_without_indexes(job) -> dict:
    from nomad_tpu_torch.api.codec import to_wire

    return {k: v for k, v in to_wire(job).items()
            if k not in _WIRE_UNCOMPARED}


def agent_scenario(n_nodes, n_rpc, n_jobs, count):
    """The phase's nodes (``mock.node()``, networks stripped, id and name
    ``node-NNNNN``) and config (b)'s jobs (``mock.job()`` at ``count``,
    networks stripped, id and name ``job-NNN``)."""
    from nomad_tpu_torch import mock

    nodes = []
    for i in range(n_nodes):
        n = strip_node(mock.node())
        n.id = n.name = f"node-{i:05d}"
        nodes.append(n)
    jobs = []
    for k in range(n_jobs):
        j = strip_job(mock.job(), count)
        j.id = j.name = f"job-{k:03d}"
        jobs.append(j)
    return {"nodes": nodes, "jobs": jobs, "n_rpc": n_rpc}


def _http_get(url: str, timeout: float = 330.0):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return (json.loads(resp.read() or b"null"),
                int(resp.headers.get("X-Nomad-Index") or 0))


def _cli(argv) -> tuple:
    """``python -m nomad_tpu_torch.cli`` in this process: (exit code,
    output, ms)."""
    import io

    from nomad_tpu_torch.cli import main

    buf = io.StringIO()
    t0 = time.perf_counter()
    rc = main(list(argv), out=buf)
    return rc, buf.getvalue(), (time.perf_counter() - t0) * 1e3


def agent_world(dev, mode, sizes, root) -> dict:
    """One world of phase ``agent`` (see the module docstring, phase 25).
    ``mode`` ``http``: a port ``Agent`` from the HCL config, the first
    ``n_rpc`` nodes over its RPC listener and the rest in-process, the
    jobs as HCL files through ``python -m nomad_tpu_torch.cli job run
    -detach``, every eval awaited by a blocking query, then the CLI's
    reads, a plan, the event stream and a purge.  ``direct``: a port
    ``Server`` and ``job_register`` of the same jobs as structs.  The
    kernels' launch counts are set to 0 just before the submissions and
    read once every eval is complete."""
    from nomad_tpu_torch.agent import Agent, load_config_file
    from nomad_tpu_torch.jobspec import parse_file
    from nomad_tpu_torch.ops import fused_score, kernels, preempt
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.server.rpc import ConnPool
    from nomad_tpu_torch.state import columnar as colmod

    sc = agent_scenario(**sizes)
    colmod.reset_counters()
    brk = KernelCircuitBreaker()
    opts = dict(rng_seed=SERVER_SEED, min_heartbeat_ttl=SERVER_HEARTBEAT_TTL,
                breaker=brk, broker_seed=AGENT_SEED, events=True,
                events_ring=1 << 16)
    http = mode == "http"
    out = {"device": str(dev), "mode": mode, "card": smi_name_power(),
           "kernel_shapes": new_shapes()}
    agent = None
    if http:
        import tempfile

        wdir = tempfile.mkdtemp(prefix=f"agent-{dev}-{mode}-", dir=root)
        os.makedirs(os.path.join(wdir, "jobs"))
        cfg_path = os.path.join(wdir, "agent.hcl")
        with open(cfg_path, "w") as fh:
            fh.write(AGENT_HCL)
        agent = Agent(load_config_file(cfg_path), device=dev,
                      server_options=opts)
        srv = agent.server
    else:
        srv = Server(ServerConfig(device=dev, batch_size=64, **opts))
    try:
        with seeded_ids(AGENT_SEED):
            if http:
                agent.start()
                addr = agent.http.address
            else:
                srv.start()
            t0 = time.perf_counter()
            pool = ConnPool() if http else None
            for i, n in enumerate(sc["nodes"]):
                if http and i < sc["n_rpc"]:
                    pool.call(srv.config.rpc_advertise, "Node.Register",
                              {"Node": n})
                else:
                    srv.node_register(n)
            if pool is not None:
                pool.close()
            out["node_register_s"] = time.perf_counter() - t0
            if len(srv.state.nodes(None)) != len(sc["nodes"]):
                raise AssertionError(f"{mode}: nodes registered "
                                     f"{len(srv.state.nodes(None))}")
            paths = []
            if http:
                mismatched = []
                for j in sc["jobs"]:
                    p = os.path.join(wdir, "jobs", f"{j.id}.nomad")
                    with open(p, "w") as fh:
                        fh.write(job_hcl(j))
                    paths.append(p)
                    if wire_without_indexes(parse_file(p)) != \
                            wire_without_indexes(j):
                        mismatched.append(j.id)
                out["jobspec_mismatches"] = mismatched
                # Blocking queries started before the submissions: the
                # jobs table's and the allocs table's (the latter wakes
                # on the first plan's commit).
                blocking = {}

                def block(table, index):
                    t = time.perf_counter()
                    body, got = _http_get(
                        f"{addr}/v1/{table}?index={index}&wait=300s")
                    blocking[table] = {"before": index, "after": got,
                                       "returned_at": time.perf_counter(),
                                       "waited_s": time.perf_counter() - t,
                                       "rows": len(body or [])}

                # (index 0 would not block: both wait past the index of
                # the last node registration.)
                before = srv.raft.applied_index()
                waiters = [threading.Thread(target=block,
                                            args=(tbl, before), daemon=True)
                           for tbl in ("jobs", "allocations")]
                for w in waiters:
                    w.start()
                time.sleep(0.5)
            if not srv.set_workers_paused(True,
                                          timeout=SERVER_SETTLE_TIMEOUT):
                raise AssertionError(f"{mode}: workers did not park")
            base = zero_launches(srv)
            shapes = out["kernel_shapes"]
            eval_ids, request_ms = [], []
            t_submit = time.perf_counter()
            with kernel_shapes(shapes):
                if http:
                    for p in paths:
                        rc, text, ms = _cli(["job", "run", "-detach",
                                             "-address", addr, p])
                        if rc != 0 or "Evaluation ID: " not in text:
                            raise AssertionError(f"job run {p}: rc {rc}: "
                                                 f"{text[-500:]}")
                        eval_ids.append(text.split("Evaluation ID: ")[1]
                                        .split()[0])
                        request_ms.append(ms)
                else:
                    for j in sc["jobs"]:
                        t = time.perf_counter()
                        eval_ids.append(srv.job_register(j)[1])
                        request_ms.append((time.perf_counter() - t) * 1e3)
                t_release = time.perf_counter()
                srv.set_workers_paused(False)
                if http:
                    # Each eval awaited by a blocking query on it.
                    for eid in eval_ids:
                        index = 0
                        while True:
                            body, index = _http_get(
                                f"{addr}/v1/evaluation/{eid}?index={index}"
                                f"&wait=60s")
                            if body["Status"] in ("complete", "failed",
                                                  "canceled"):
                                break
                    t_done = time.perf_counter()
                    server_settle(srv)
                else:
                    t_done = server_settle(srv)
            launches = durable_launches(srv, base)
            wall = t_done - t_release
            out.update({
                "launches": launches,
                "submit_s": t_release - t_submit,
                "request_ms": {"n": len(request_ms),
                               "mean": statistics.fmean(request_ms),
                               "p50": statistics.median(request_ms),
                               "max": max(request_ms)},
                "release_to_complete_s": wall,
                "evals_per_s": len(eval_ids) / wall,
                "eval_statuses": sorted(
                    (e.job_id, e.triggered_by, e.status)
                    for e in srv.state.evals(None)),
                "submitted_not_complete": [
                    eid for eid in eval_ids
                    if srv.state.eval_by_id(None, eid).status != "complete"],
            })
            st = srv.state
            placements, scores = {}, {}
            for a in st.allocs(None):
                if a.desired_status == "run":
                    placements[f"{a.job_id}/{a.name}"] = a.node_id
                    if a.metrics is not None and a.job_id not in scores:
                        scores[a.job_id] = sorted(a.metrics.scores.items())
            out["placements"] = placements
            out["scores"] = scores
            b = srv.eval_broker.stats()
            out["health"] = {
                "nacks": b["total_nacks"], "failed": b["total_failed"],
                "breaker": brk.state, "trips": brk.trips,
                "oracle_routed": server_counter(srv,
                                                "breaker.oracle_routed"),
                "over_capacity": store_over_capacity(srv),
                "columnar": columnar_counters()}
            if http:
                for w in waiters:
                    w.join(60.0)
                for tbl, row in blocking.items():
                    row["after_release"] = row.pop("returned_at") > t_release
                out["blocking"] = blocking
                out["cli"] = agent_cli_reads(addr, srv, sc, wdir,
                                             eval_ids)
        if agent is not None:
            from nomad_tpu_torch.utils.backoff import wait_until

            agent.shutdown()
            # The server's sweepers end within their bounded joins.
            wait_until(lambda: not agent.threads(), 15.0)
            out["threads_after_shutdown"] = [t.name for t in agent.threads()]
            agent = None
        else:
            srv.shutdown()
        srv = None
    finally:
        if agent is not None:
            agent.shutdown()
        elif srv is not None:
            srv.shutdown()
    out["kernel_shapes"] = {k: sorted(v) for k, v in
                            out["kernel_shapes"].items()}
    return out


def agent_cli_reads(addr, srv, sc, wdir, eval_ids) -> dict:
    """The CLI's and the API's reads after the wave: each command's exit
    code, a ``job plan`` of an edited file (its diff and annotations),
    the event stream's ``PlanApplied`` and ``EvalUpdated`` events of the
    wave's evals, and ``job stop -purge`` of the first job."""
    from nomad_tpu_torch.jobspec import parse_file

    first = sc["jobs"][0]
    alloc = sorted(srv.state.allocs_by_job(None, first.id, False),
                   key=lambda a: a.name)[0]
    rows = {}
    for label, argv in (
            ("job status", ["job", "status", first.id]),
            ("job status (list)", ["job", "status"]),
            ("alloc status", ["alloc", "status", alloc.id]),
            ("eval status", ["eval", "status", eval_ids[0]]),
            ("node status", ["node", "status"]),
            ("node status (one)", ["node", "status", sc["nodes"][0].id]),
            ("job inspect", ["job", "inspect", first.id])):
        rc, text, ms = _cli(argv[:2] + ["-address", addr] + argv[2:])
        rows[label] = {"rc": rc, "ms": ms, "lines": text.count("\n")}
        if rc != 0:
            raise AssertionError(f"{label}: rc {rc}: {text[-500:]}")
    # job plan on an edited file: one more task group count.
    edited = parse_file(os.path.join(wdir, "jobs", f"{first.id}.nomad"))
    edited.task_groups[0].count += 10
    path = os.path.join(wdir, "edited.nomad")
    with open(path, "w") as fh:
        fh.write(job_hcl(edited))
    rc, text, ms = _cli(["job", "plan", "-address", addr, path])
    plan = {"rc": rc, "ms": ms,
            "count_edit": "Count" in text and "+/-" in text,
            "place": next((ln.strip() for ln in text.splitlines()
                           if "create" in ln or "place" in ln), "")}
    if rc != 1 or not plan["count_edit"]:
        raise AssertionError(f"job plan: rc {rc}: {text[-800:]}")
    rows["job plan"] = plan
    # The event stream: the wave's plans and eval updates.
    import urllib.request

    with urllib.request.urlopen(f"{addr}/v1/event/stream?follow=false&"
                                f"topic=Plan,Eval", timeout=60) as resp:
        events = [json.loads(ln) for ln in resp.read().splitlines() if ln]
    wave = set(eval_ids)
    # The evals that placed anything (the asks past the fleet's room
    # block and apply no plan).
    placing = {a.eval_id for a in srv.state.allocs(None)} & wave
    applied = {e["Key"] for e in events
               if e.get("Type") == "PlanApplied" and e.get("Key") in wave}
    updated = {e["Key"] for e in events
               if e.get("Type") == "EvalUpdated" and e.get("Key") in wave}
    rows["event_stream"] = {"events": len(events),
                            "placing_evals": len(placing),
                            "plan_applied_evals": len(applied),
                            "eval_updated_evals": len(updated)}
    if applied != placing or updated != wave:
        raise AssertionError(f"event stream: {rows['event_stream']} of "
                             f"{len(wave)} evals")
    rc, text, ms = _cli(["job", "stop", "-purge", "-detach", "-address",
                         addr, first.id])
    if rc != 0:
        raise AssertionError(f"job stop -purge: rc {rc}: {text[-500:]}")
    server_settle(srv)
    rows["job stop -purge"] = {
        "rc": rc, "ms": ms,
        "purged": srv.state.job_by_id(None, first.id) is None,
        "live_allocs_left": sum(
            1 for a in srv.state.allocs_by_job(None, first.id, True)
            if not a.terminal_status())}
    if not rows["job stop -purge"]["purged"] or \
            rows["job stop -purge"]["live_allocs_left"]:
        raise AssertionError(f"job stop -purge: {rows['job stop -purge']}")
    return rows


def agent_child(dev, mode, out_path, sizes, root) -> None:
    """One world of phase ``agent`` in a process of its own; the report
    is written to ``out_path``."""
    out = agent_world(dev, mode, sizes, root)
    with open(out_path, "w") as fh:
        json.dump(out, fh)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run_agent_child(dev, mode, root, sizes) -> dict:
    """``agent_child`` in a fresh process under the phase's string hash
    seed; its report."""
    out_path = os.path.join(root, f"agent-{dev}-{mode}.json")
    code = ("import sys; sys.path.insert(0, {0!r}); import chip_smoke as c; "
            "c.agent_child({1!r}, {2!r}, {3!r}, {4!r}, {5!r})"
            ).format(REPO, dev, mode, out_path, sizes, root)
    env = dict(os.environ, PYTHONHASHSEED=str(AGENT_HASH_SEED))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True,
                          timeout=AGENT_CHILD_TIMEOUT)
    if proc.returncode != 0 or not os.path.exists(out_path):
        raise AssertionError(f"agent child on {dev} ({mode}): rc "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    with open(out_path) as fh:
        out = json.load(fh)
    os.unlink(out_path)
    out["child_wall_s"] = time.perf_counter() - t0
    return out


def check_agent_world(w, label, sizes, on_card) -> list:
    """The invariants of one world."""
    errors = []
    h = w["health"]
    if (h["nacks"] or h["failed"] or h["breaker"] != "closed" or h["trips"]
            or h["oracle_routed"] or h["over_capacity"]):
        errors.append(f"{label}: health {h}")
    if h["columnar"]["GUARD_MISMATCHES"] or \
            h["columnar"]["USAGE_GUARD_MISMATCHES"]:
        errors.append(f"{label}: columnar guards {h['columnar']}")
    if w["submitted_not_complete"]:
        errors.append(f"{label}: submitted evals not complete: "
                      f"{w['submitted_not_complete'][:5]}")
    la = w["launches"]
    # One round-kernel launch a batch, the kernel's committing steps the
    # server's (before the round kernel: one scored_rows launch a step).
    if on_card and not launches_ok(la):
        errors.append(f"{label}: round kernel launches {la}")
    if not on_card and (la["scored_rows"] or la["placement_rounds"]):
        errors.append(f"{label}: kernel launched off the card {la}")
    if la["masked_score_matrix"] or la["eviction_sets"]:
        errors.append(f"{label}: unexpected launches {la}")
    if not w["placements"]:
        errors.append(f"{label}: nothing placed")
    if w["mode"] == "http":
        if w["jobspec_mismatches"]:
            errors.append(f"{label}: parsed jobs differ from mock.job(): "
                          f"{w['jobspec_mismatches'][:5]}")
        for tbl, row in w["blocking"].items():
            if not (row["after"] > row["before"] and row["after_release"]
                    or tbl == "jobs" and row["after"] > row["before"]):
                errors.append(f"{label}: blocking query on {tbl}: {row}")
        if w["threads_after_shutdown"]:
            errors.append(f"{label}: threads left after shutdown: "
                          f"{w['threads_after_shutdown']}")
    return errors


def phase_agent(dev, sizes=None):
    """The front door (see the module docstring, phase 25): world A (HCL
    through the CLI and HTTP into an agent's server on ``dev``), world B
    (the same jobs through ``Server.job_register`` on ``dev``) and world
    C (A's script on the CPU), each in a process of its own, compared
    here; ``scored_rows`` at the shapes A gave it against its plain
    version."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    smi = smi_name_power()
    on_card = torch_device(dev).type == "cuda"
    sizes = dict(AGENT_SIZES if sizes is None else sizes)
    root = tempfile.mkdtemp(prefix="nomad-torch-agent-")
    try:
        def card_chain():
            return (run_agent_child(dev, "http", root, sizes),
                    run_agent_child(dev, "direct", root, sizes))

        worlds, beside = side_by_side({
            "card": (["A", "B"], card_chain),
            "C": (["C"], lambda: run_agent_child("cpu", "http", root,
                                                 sizes))})
        (a, b), c = worlds["card"], worlds["C"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    errors = (check_agent_world(a, "A", sizes, on_card)
              + check_agent_world(b, "B", sizes, on_card)
              + check_agent_world(c, "C", sizes, False))
    for other, label in ((b, "B"), (c, "C")):
        if a["placements"] != other["placements"]:
            pa, po = set(a["placements"].items()), set(
                other["placements"].items())
            errors.append(f"A != {label} placements: "
                          f"{sorted(pa - po)[:5]} / {sorted(po - pa)[:5]} "
                          f"({len(pa)} / {len(po)})")
        if a["eval_statuses"] != other["eval_statuses"]:
            errors.append(f"A != {label} eval statuses")
        if a["launches"]["committing_spec_steps"] != \
                other["launches"]["committing_spec_steps"]:
            errors.append(f"A != {label} committing steps: "
                          f"{a['launches']} {other['launches']}")
    score_err = {}
    for other, label in ((b, "B"), (c, "C")):
        worst = 0.0
        if set(a["scores"]) != set(other["scores"]):
            errors.append(f"A != {label}: jobs with scores differ")
        for job, rows in a["scores"].items():
            theirs = dict(map(tuple, other["scores"].get(job, [])))
            if set(k for k, _ in rows) != set(theirs):
                errors.append(f"A != {label}: score keys of {job}")
                continue
            for k, v in rows:
                worst = max(worst, abs(v - theirs[k]))
        score_err[label] = worst
    if score_err.get("B", 0.0) != 0.0:
        errors.append(f"A != B scores: {score_err['B']}")
    if score_err.get("C", 0.0) > 4e-6:
        errors.append(f"A vs C scores differ by {score_err['C']} > 4e-6")
    shape_parity = {}
    if on_card:
        try:
            shape_parity = path_shape_parity(dev, a["kernel_shapes"],
                                             "agent")
        except AssertionError as exc:
            errors.append(str(exc))
    if errors:
        raise AssertionError(f"phase agent: {errors}")

    def world_row(w, label):
        return {**{k: w[k] for k in (
            "device", "mode", "node_register_s", "submit_s", "request_ms",
            "release_to_complete_s", "evals_per_s", "launches",
            "child_wall_s") if k in w}, "ran_beside": beside[label]}

    return {"card": smi, "sizes": sizes,
            "A_http": {**world_row(a, "A"), "blocking": a["blocking"],
                       "cli": a["cli"]},
            "B_direct": world_row(b, "B"), "C_cpu_http": world_row(c, "C"),
            "placed": len(a["placements"]),
            "placements_equal": True, "score_max_abs_err": score_err,
            "evals_per_s_http_vs_direct": [a["evals_per_s"],
                                           b["evals_per_s"]],
            "kernel_shapes": a["kernel_shapes"],
            "shape_parity": shape_parity,
            "launches": {"agent": a["launches"], "direct": b["launches"]},
            "seconds": time.perf_counter() - t_phase}


# -- phase 26: client --------------------------------------------------------

CLIENT_SEED = 20261118
# Every world of the phase runs in a process of its own under this string
# hash seed, as phase agent's do.
CLIENT_HASH_SEED = 20261118
CLIENT_CHILD_TIMEOUT = 600.0
CLIENT_SIZES = {
    # The fleet: n_nodes in all, n_clients of them real port clients
    # (n_remote of those in a child process over RPC), the rest
    # mock.node() registered in process.
    "n_nodes": 10_000, "n_clients": 64, "n_remote": 16,
    # The wave: (jobs, count) of each kind, and the tasks' run time (a
    # batch task 16 s, a failing one 8 s twice).  No alloc may end before
    # the wave's last eval is acked: the clients get the wave's allocs
    # only once it is (``AllocDelivery``), so no task starts before.
    "batch": (40, 8), "fail": (8, 4), "service": (8, 8),
    "run_for_s": 16.0, "fail_run_for_s": 8.0,
    # The exec family: the first raw_exec_batch batch jobs run on
    # raw_exec and the next exec_batch on exec, a real process each
    # (``EXEC_SCRIPT``, sleeping run_for_s); the first raw_exec_fail
    # failing jobs run ``sleep fail_run_for_s; exit 1`` on raw_exec.
    "raw_exec_batch": 4, "exec_batch": 4, "raw_exec_fail": 2,
    # The GPU-pinned job of world A.
    "gpu_count": 4,
}
# What every client offers: cpu_total_compute and its reservation pin
# the CPU the fingerprint would read; a task asks 500 MHz, so a node
# holds seven (448 slots for the wave's 416 allocs).
CLIENT_CPU = 4000
CLIENT_RESERVED = {"cpu": 100, "memory_mb": 256}
CLIENT_ASK = {"cpu": 500, "memory_mb": 256, "disk_mb": 10}
CLIENT_CLASS = "client-slice"
CLIENT_HEARTBEAT_STAGGER = 1.0
CLIENT_WAIT = 120.0
# Every client enables raw_exec (and keeps ``cgroup_root`` empty: no
# cgroup, nothing written under /sys/fs/cgroup).
CLIENT_OPTIONS = {"driver.raw_exec.enable": "1"}
# An exec-family batch task: its alloc index and task name (interpolated
# by the driver), then the batch run time.
EXEC_SCRIPT = 'echo "$NOMAD_ALLOC_INDEX ${NOMAD_TASK_NAME}"; sleep %s'
# The cloud metadata fingerprints probe 169.254.169.254: the phase's
# processes leave them out of the builtin list, since the smoke contacts
# no host off the machine.  Every other fingerprint runs, ``network``
# (which reads the routing table) included.
CLOUD_FINGERPRINTS = ("env_aws", "env_gce")
# The agent of world A's first client: a server and a client, HTTP and
# RPC on ephemeral ports, the in-memory log.
CLIENT_HCL = """
name      = "client-smoke"
region    = "global"
log_level = "WARN"
bind_addr = "127.0.0.1"
ports {
  http = 0
  rpc  = 0
}
server {
  enabled        = true
  num_schedulers = 1
  batch_size     = 64
}
client {
  enabled           = true
  node_class        = "client-slice"
  cpu_total_compute = 4000
  alloc_dir         = "%s"
  options = {
    "fingerprint.gpu.enable" = "true"
    "driver.raw_exec.enable" = "1"
  }
}
vault {
  enabled        = true
  task_token_ttl = "1h"
}
"""


def client_name(i: int) -> str:
    return f"client-{i:02d}"


def no_cloud_probes() -> None:
    """``CLOUD_FINGERPRINTS`` out of this process's builtin list."""
    from nomad_tpu_torch.client import fingerprint as fp

    fp.BUILTIN_FINGERPRINTS = [f for f in fp.BUILTIN_FINGERPRINTS
                               if f.name not in CLOUD_FINGERPRINTS]


def client_config(i, root, gpu):
    """The ``ClientConfig`` of the phase's client ``i`` (see
    ``CLIENT_CPU``)."""
    from nomad_tpu_torch.client import ClientConfig
    from nomad_tpu_torch.structs import structs as ps

    return ClientConfig(
        node_id=client_name(i), node_name=client_name(i),
        node_class=CLIENT_CLASS, cpu_total_compute=CLIENT_CPU,
        reserved=ps.Resources(**CLIENT_RESERVED),
        alloc_dir=os.path.join(root, client_name(i)),
        options=dict(CLIENT_OPTIONS, **(
            {"fingerprint.gpu.enable": "true"} if gpu else {})))


def client_job(job_id, type_, count, config, restart, networks=False,
               driver="mock_driver"):
    """``mock.job()`` as the phase runs it: services stripped, ``driver``
    (the mock driver by default), ``CLIENT_ASK``, on the client nodes
    only; its network ask (50 Mbit/s, two dynamic ports) kept when
    ``networks``."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import structs as ps

    j = mock.job()
    j.id = j.name = job_id
    j.type = type_
    tg = j.task_groups[0]
    tg.count = count
    tg.restart_policy = ps.RestartPolicy(**restart)
    tg.ephemeral_disk = ps.EphemeralDisk(size_mb=CLIENT_ASK["disk_mb"])
    for t in tg.tasks:
        t.driver = driver
        t.config = dict(config)
        t.services = []
        t.resources = ps.Resources(
            cpu=CLIENT_ASK["cpu"], memory_mb=CLIENT_ASK["memory_mb"],
            networks=t.resources.networks if networks else [])
    j.constraints.append(ps.Constraint("${node.class}", CLIENT_CLASS, "="))
    return j


def exec_driver_of(job_id, sizes):
    """The driver of a wave job: the exec family for the first batch and
    failing jobs (``CLIENT_SIZES``), the mock driver for the rest."""
    kind, k = job_id.rsplit("-", 1)
    k = int(k)
    if kind == "batch":
        if k < sizes["raw_exec_batch"]:
            return "raw_exec"
        if k < sizes["raw_exec_batch"] + sizes["exec_batch"]:
            return "exec"
    if kind == "fail" and k < sizes["raw_exec_fail"]:
        return "raw_exec"
    return "mock_driver"


def client_jobs(sizes):
    """The wave: batch jobs that complete, batch jobs whose task fails,
    restarts once and fails for good, and service jobs, with their
    network ask, that run until they are stopped.  The first batch and
    failing jobs run real processes (``exec_driver_of``)."""
    def task_config(job_id, mock_config, script):
        if exec_driver_of(job_id, sizes) == "mock_driver":
            return mock_config
        return {"command": "/bin/sh", "args": ["-c", script]}

    jobs = []
    n, count = sizes["batch"]
    for k in range(n):
        job_id = f"batch-{k:02d}"
        jobs.append(client_job(
            job_id, "batch", count, task_config(
                job_id, {"run_for": sizes["run_for_s"]},
                EXEC_SCRIPT % sizes["run_for_s"]),
            dict(attempts=0, mode="fail"),
            driver=exec_driver_of(job_id, sizes)))
    n, count = sizes["fail"]
    for k in range(n):
        job_id = f"fail-{k:02d}"
        jobs.append(client_job(
            job_id, "batch", count, task_config(
                job_id, {"run_for": sizes["fail_run_for_s"], "exit_code": 1},
                f"sleep {sizes['fail_run_for_s']}; exit 1"),
            dict(attempts=1, interval=3600.0, delay=0.2, mode="fail"),
            driver=exec_driver_of(job_id, sizes)))
    n, count = sizes["service"]
    jobs += [client_job(f"service-{k:02d}", "service", count,
                        {"run_for": "1h"},
                        dict(attempts=2, interval=3600.0, delay=0.2,
                             mode="delay"), networks=True)
             for k in range(n)]
    return jobs


class AllocDelivery:
    """The server's answers to the clients' alloc watch
    (``node_get_client_allocs``, in process and over RPC), held while
    ``hold()`` lasts: an answer that would come during the hold waits for
    ``release()`` and is read afresh then.  The phase holds the wave's
    allocs until its last eval is acked, so no task starts, and none
    ends, before: a terminal alloc frees its resources and would change
    a later eval's placements with its timing."""

    def __init__(self, srv):
        self._open = threading.Event()
        self._open.set()
        real = srv.node_get_client_allocs

        def answer(node_id, min_index=0, max_wait=0.0):
            out = real(node_id, min_index, max_wait)
            if not self._open.is_set():
                self._open.wait()
                out = real(node_id, min_index, 0.0)
            return out

        srv.node_get_client_allocs = answer

    def hold(self) -> None:
        self._open.clear()

    def release(self) -> None:
        self._open.set()


def shutdown_clients(clients) -> None:
    """Every client's ``shutdown`` at once (each waits up to a long poll
    for its watch)."""
    threads = [threading.Thread(target=c.shutdown) for c in clients]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)


def alloc_dirs(root, names) -> dict:
    """client name -> the alloc dirs under its alloc dir."""
    out = {}
    for name in names:
        d = os.path.join(root, name)
        out[name] = sorted(os.listdir(d)) if os.path.isdir(d) else []
    return out


def exec_records(root, names) -> dict:
    """alloc id -> what its exec-family tasks left in the alloc dir: the
    log files (name -> content), the pids of ``supervisor.pid`` and
    ``task.pid`` in each task's control dir, and each task's last
    supervisor start (``task.pid`` written after ``command.json``, s)."""
    out = {}
    for name in names:
        croot = os.path.join(root, name)
        if not os.path.isdir(croot):
            continue
        for alloc_id in sorted(os.listdir(croot)):
            adir = os.path.join(croot, alloc_id)
            logs_dir = os.path.join(adir, "alloc", "logs")
            logs = {}
            if os.path.isdir(logs_dir):
                for f in sorted(os.listdir(logs_dir)):
                    with open(os.path.join(logs_dir, f), "rb") as fh:
                        logs[f] = fh.read().decode(errors="replace")
            pids, starts = [], []
            for task in sorted(os.listdir(adir)):
                ctl = os.path.join(adir, task, f".{task}.executor")
                if not os.path.isdir(ctl):
                    continue
                for f in ("supervisor.pid", "task.pid"):
                    try:
                        with open(os.path.join(ctl, f)) as fh:
                            pids.append(json.load(fh)["pid"])
                    except (OSError, ValueError, KeyError):
                        pass
                try:
                    starts.append(
                        os.path.getmtime(os.path.join(ctl, "task.pid"))
                        - os.path.getmtime(os.path.join(ctl, "command.json")))
                except OSError:
                    pass
            if logs or pids:
                out[alloc_id] = {"logs": logs, "pids": pids,
                                 "start_s": starts}
    return out


def alive_pids(records) -> list:
    """The pids of ``exec_records`` still alive (a zombie counts as
    gone)."""
    from nomad_tpu_torch.client.driver.executor import pid_alive

    return sorted(p for r in records.values() for p in r["pids"]
                  if pid_alive(p))


def cgroup_tree() -> list:
    """Every directory under /sys/fs/cgroup, two levels deep."""
    root = "/sys/fs/cgroup"
    out = []
    if not os.path.isdir(root):
        return out
    for a in sorted(os.listdir(root)):
        pa = os.path.join(root, a)
        if not os.path.isdir(pa):
            continue
        out.append(a)
        try:
            out += [f"{a}/{b}" for b in sorted(os.listdir(pa))
                    if os.path.isdir(os.path.join(pa, b))]
        except OSError:
            pass
    return out


def client_remote_child(addr, first, n, root) -> None:
    """The phase's remote clients, ``first`` .. ``first + n - 1``, each
    reaching the server at ``addr`` only through ``RemoteServerRPC``.  A
    line protocol on stdin: ``start`` starts them one by one, each once
    the one before has registered (the store lists nodes in registration
    order, and the scheduler breaks score ties by that order), ``dirs``
    prints the alloc dirs, ``gc`` runs each client's GC and prints them
    again, ``stop`` shuts the clients down and prints the threads left
    and the sync counts; each answer is one JSON line on stdout."""
    from nomad_tpu_torch.client import Client
    from nomad_tpu_torch.server.rpc import RemoteServerRPC
    from nomad_tpu_torch.utils.backoff import wait_until

    no_cloud_probes()
    names = [client_name(i) for i in range(first, first + n)]
    clients = [Client(client_config(i, root, gpu=False),
                      rpc=RemoteServerRPC([addr]),
                      rng=random.Random(CLIENT_SEED + i),
                      heartbeat_stagger=CLIENT_HEARTBEAT_STAGGER)
               for i in range(first, first + n)]

    def say(obj):
        sys.stdout.write(json.dumps(obj) + "\n")
        sys.stdout.flush()

    say({"built": names})
    records = {}
    for line in sys.stdin:
        cmd = line.strip()
        if cmd == "start":
            for c in clients:
                c.start()
                if not c._registered.wait(CLIENT_WAIT):
                    raise AssertionError(f"{c.node.name} did not register")
            say({"started": names})
        elif cmd == "dirs":
            records = exec_records(root, names)
            say({"dirs": alloc_dirs(root, names), "exec": records})
        elif cmd == "gc":
            for c in clients:
                c.garbage_collector.collect_all()
            say({"dirs": alloc_dirs(root, names)})
        elif cmd == "stop":
            shutdown_clients(clients)
            wait_until(lambda: not any(c.threads() for c in clients), 15.0)
            for c in clients:
                c.rpc.close()
            say({"threads": [t.name for c in clients for t in c.threads()],
                 "alive_pids": alive_pids(records),
                 "sync_calls": sum(c.sync_calls for c in clients),
                 "sync_allocs": sum(c.sync_allocs for c in clients),
                 "attributes": {c.node.name: sorted(c.node.attributes)
                                for c in clients}})
            break
    sys.stdout.flush()
    os._exit(0)


class RemoteClients:
    """``client_remote_child`` in a process of its own, spoken to over
    its stdin and stdout."""

    def __init__(self, addr, first, n, root):
        code = ("import sys; sys.path.insert(0, {0!r}); import chip_smoke "
                "as c; c.client_remote_child({1!r}, {2!r}, {3!r}, {4!r})"
                ).format(REPO, addr, first, n, root)
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code], cwd=REPO, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONHASHSEED=str(CLIENT_HASH_SEED)))

    def read(self):
        line = self.proc.stdout.readline()
        if not line:
            raise AssertionError(f"remote clients ended: rc "
                                 f"{self.proc.poll()}: "
                                 f"{self.proc.stderr.read()[-3000:]}")
        return json.loads(line)

    def ask(self, cmd):
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()
        return self.read()

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(30.0)


def no_alloc_started(srv) -> None:
    """Once the wave's last eval is acked, no alloc of it has reported a
    task: the clients get none of its allocs before (``AllocDelivery``),
    so none ended and freed its resources while the wave was placed."""
    early = sorted(
        (f"{a.job_id}/{a.name}", a.client_status,
         [(e.type, e.message) for ts in a.task_states.values()
          for e in ts.events][-3:])
        for a in srv.state.allocs(None)
        if a.client_status != "pending" or a.task_states)
    if early:
        raise AssertionError(f"allocs started before the wave was acked: "
                             f"{early[:8]}")


def wave_acked(srv, eval_ids) -> float:
    """Wait until every eval of ``eval_ids`` is done and acked and no plan
    is queued; the host clock then.  (``server_settle`` would wait for the
    clients' status updates to stop as well.)"""
    from nomad_tpu_torch.utils.backoff import wait_until

    def done():
        for i in eval_ids:
            e = srv.state.eval_by_id(None, i)
            if e is None or e.status not in ("complete", "failed",
                                             "canceled"):
                return False
        b = srv.eval_broker.stats()
        return (b["total_unacked"] == 0 and b["total_ready"] == 0
                and srv.plan_queue.depth() == 0)

    if not wait_until(done, SERVER_SETTLE_TIMEOUT, max_interval=0.01):
        raise AssertionError(f"the wave's evals were not acked: "
                             f"{srv.eval_broker.stats()}")
    return time.perf_counter()


def client_state(srv) -> dict:
    """What the server holds of the fleet's work, by content."""
    st = srv.state
    allocs = sorted(st.allocs(None), key=lambda a: (a.job_id, a.name))
    by_id = {n.id: n.name for n in st.nodes(None)}
    return {
        "placements": {f"{a.job_id}/{a.name}": by_id[a.node_id]
                       for a in allocs},
        "client_statuses": {f"{a.job_id}/{a.name}": a.client_status
                            for a in allocs},
        "events": {f"{a.job_id}/{a.name}/{task}": [e.type
                                                    for e in ts.events]
                   for a in allocs for task, ts in sorted(
                       a.task_states.items())},
        "exit_codes": {f"{a.job_id}/{a.name}/{task}": [
            e.exit_code for e in ts.events if e.type == "Terminated"]
            for a in allocs for task, ts in sorted(a.task_states.items())},
        "driver_failures": {f"{a.job_id}/{a.name}/{task}": [
            e.message for e in ts.events if e.type == "Driver Failure"]
            for a in allocs for task, ts in sorted(a.task_states.items())
            if any(e.type == "Driver Failure" for e in ts.events)},
        "networks": {f"{a.job_id}/{a.name}/{task}": [
            [nw.ip, nw.mbits, len(nw.dynamic_ports)] for nw in r.networks]
            for a in allocs for task, r in sorted(a.task_resources.items())},
        "jobs": {j.id: j.status for j in st.jobs(None)},
        "summaries": {j.id: {tg: dataclasses.asdict(v) for tg, v in sorted(
            st.job_summary_by_id(None, j.id).summary.items())}
            for j in st.jobs(None)},
    }


def client_world(dev, sizes, root) -> dict:
    """One world of phase ``client`` (see the module docstring, phase
    26): a port ``Agent`` (a server on ``dev`` and the first client),
    ``n_clients - n_remote - 1`` more clients in this process, ``n_remote``
    in a child process over RPC, the rest of the fleet ``mock.node()`` in
    process; the wave submitted with the workers paused and released, its
    allocs delivered to the clients once its last eval is acked, the
    service jobs stopped once every alloc has started, every alloc
    terminal,
    the alloc dirs collected.  On the card, then, a job pinned on
    ``${attr.gpu.type}``.  The kernels' counts are set to 0 just before
    each wave and read once it is terminal."""
    import urllib.request

    import torch

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.agent import Agent, parse_config
    from nomad_tpu_torch.client import Client
    from nomad_tpu_torch.ops import fused_score, kernels, preempt
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.server.vault import FakeVault
    from nomad_tpu_torch.structs import structs as ps
    from nomad_tpu_torch.utils.backoff import wait_until

    t_world = time.perf_counter()
    no_cloud_probes()
    on_card = torch_device(dev).type == "cuda"
    n_clients, n_remote = sizes["n_clients"], sizes["n_remote"]
    n_local = n_clients - n_remote
    names = [client_name(i) for i in range(n_clients)]
    brk = KernelCircuitBreaker()
    out = {"device": str(dev), "card": smi_name_power(),
           "kernel_shapes": new_shapes(),
           "reduced": {"clients": f"{n_clients} real clients of "
                       f"{sizes['n_nodes']} nodes (the rest mock.node() "
                       f"registered in process): a client per node would "
                       f"be {sizes['n_nodes']} clients on one host"}}
    mock_nodes = []
    for i in range(sizes["n_nodes"] - n_clients):
        n = strip_node(mock.node())
        n.id = n.name = f"node-{i:05d}"
        mock_nodes.append(n)
    jobs = client_jobs(sizes)
    cfg = parse_config(CLIENT_HCL % os.path.join(root, names[0]))
    cfg.dev_mode = True
    # The agent's vault block with an in-memory vault: its server derives
    # and revokes, its client unwraps and renews through it.
    fv = FakeVault()
    agent = Agent(cfg, device=dev, vault_api=fv, server_options=dict(
        rng_seed=SERVER_SEED, min_heartbeat_ttl=SERVER_HEARTBEAT_TTL,
        breaker=brk, broker_seed=CLIENT_SEED),
        client_options=dict(node_id=names[0], node_name=names[0],
                            reserved=ps.Resources(**CLIENT_RESERVED)))
    agent.client.heartbeat_stagger = CLIENT_HEARTBEAT_STAGGER
    agent.client.rng = random.Random(CLIENT_SEED)
    srv = agent.server
    delivery = AllocDelivery(srv)
    local = [agent.client]
    remote = None
    calls = {"n": 0, "allocs": 0}
    steps = out["steps"] = {}
    try:
        with seeded_ids(CLIENT_SEED):
            agent.start()
            addr = agent.http.address
            remote = RemoteClients(srv.config.rpc_advertise, n_local,
                                   n_remote, root)
            steps["agent_start_s"] = time.perf_counter() - t_world
            # The agent's client, the mock nodes, then the other clients
            # one registration after the other, in name order: the store
            # lists nodes in registration order, which breaks score ties.
            if not wait_until(lambda: srv.node_get(names[0]) is not None,
                              CLIENT_WAIT):
                raise AssertionError(f"{names[0]} did not register")
            t1 = time.perf_counter()
            for n in mock_nodes:
                srv.node_register(n)
            out["mock_node_register_s"] = time.perf_counter() - t1
            t0 = time.perf_counter()
            for i in range(1, n_local):
                c = Client(client_config(i, root, gpu=True), rpc=srv,
                           rng=random.Random(CLIENT_SEED + i),
                           heartbeat_stagger=CLIENT_HEARTBEAT_STAGGER)
                c.start()
                local.append(c)
                if not c._registered.wait(CLIENT_WAIT):
                    raise AssertionError(f"{names[i]} did not register")
            if remote.read().get("built") != names[n_local:] or \
                    remote.ask("start").get("started") != names[n_local:]:
                raise AssertionError("remote clients did not start")
            out["clients_register_s"] = time.perf_counter() - t0
            if not wait_until(lambda: all(
                    (srv.node_get(n) or ps.Node()).status == "ready"
                    for n in names), CLIENT_WAIT):
                raise AssertionError(
                    "clients not ready: " + str(sorted(
                        n for n in names
                        if (srv.node_get(n) or ps.Node()).status
                        != "ready")[:8]))
            out["fleet_ready_s"] = time.perf_counter() - t0
            out["nodes"] = len(srv.state.nodes(None))
            out["gpu_type"] = {c.node.name: c.node.attributes.get("gpu.type")
                               for c in local}
            out["node_networks"] = sorted({
                (nw.ip, nw.mbits) for n in names
                for nw in srv.node_get(n).resources.networks})
            # Every Node.UpdateAlloc the server takes, in process or over
            # RPC, and the allocs it carries.
            update_allocs = srv.node_update_allocs

            def counted_updates(allocs):
                calls["n"] += 1
                calls["allocs"] += len(allocs)
                return update_allocs(allocs)

            srv.node_update_allocs = counted_updates
            if not srv.set_workers_paused(True,
                                          timeout=SERVER_SETTLE_TIMEOUT):
                raise AssertionError("workers did not park")
            base = zero_launches(srv)
            shapes = out["kernel_shapes"]
            with kernel_shapes(shapes):
                delivery.hold()
                eval_ids = [srv.job_register(j)[1] for j in jobs]
                t_release = time.perf_counter()
                srv.set_workers_paused(False)
                t_acked = wave_acked(srv, eval_ids)
                no_alloc_started(srv)
                delivery.release()
                out["release_to_acked_s"] = t_acked - t_release
                out["allocs"] = len(srv.state.allocs(None))
                # Every alloc started (a batch task may have ended since),
                # every service running.
                if not wait_until(lambda: all(
                        a.client_status != "pending" and (
                            a.client_status == "running"
                            or a.job.type != "service")
                        for a in srv.state.allocs(None)), CLIENT_WAIT,
                        max_interval=0.05):
                    raise AssertionError("not every alloc ran: " + str(
                        collections.Counter(a.client_status for a in
                                            srv.state.allocs(None))))
                out["release_to_all_running_s"] = (time.perf_counter()
                                                   - t_release)
                if not srv.set_workers_paused(
                        True, timeout=SERVER_SETTLE_TIMEOUT):
                    raise AssertionError("workers did not park")
                stops = [srv.job_deregister(j.id, purge=False)[1]
                         for j in jobs if j.type == "service"]
                t_stop = time.perf_counter()
                srv.set_workers_paused(False)
                out["service_stop_acked_s"] = (wave_acked(srv, stops)
                                               - t_stop)
                if not wait_until(lambda: all(
                        a.client_terminal_status()
                        for a in srv.state.allocs(None)), CLIENT_WAIT,
                        max_interval=0.05):
                    raise AssertionError("not every alloc ended: " + str(
                        collections.Counter(a.client_status for a in
                                            srv.state.allocs(None))))
                out["release_to_all_terminal_s"] = (time.perf_counter()
                                                    - t_release)
                t_settle = time.perf_counter()
                server_settle(srv)
                steps["settle_s"] = time.perf_counter() - t_settle
            out["launches"] = durable_launches(srv, base)
            out["update_allocs"] = dict(calls)
            out.update(client_state(srv))
            by_node = collections.defaultdict(list)
            for a in srv.state.allocs(None):
                by_node[srv.state.node_by_id(None, a.node_id).name].append(
                    a.id)
            t_gc = time.perf_counter()
            made = alloc_dirs(root, names[:n_local])
            local_records = exec_records(root, names[:n_local])
            answer = remote.ask("dirs")
            made.update(answer["dirs"])
            out.update(exec_content(srv, {**local_records,
                                          **answer["exec"]}))
            out["dirs_made_as_placed"] = all(
                made[n] == sorted(by_node.get(n, [])) for n in names)
            out["dirs_made"] = sum(len(v) for v in made.values())
            # The agent's client through its HTTP API (stats, an alloc's
            # stats, the fs listing, then /v1/client/gc); every other
            # client's GC is the call that route makes.
            first = sorted(by_node.get(names[0], []))
            http = {}
            if first:
                for label, path in (
                        ("stats", "/v1/client/stats"),
                        ("alloc_stats",
                         f"/v1/client/allocation/{first[0]}/stats"),
                        ("fs_ls", f"/v1/client/fs/ls/{first[0]}?path=/")):
                    body, _ = _http_get(addr + path, timeout=60.0)
                    http[label] = sorted(body) if isinstance(
                        body, dict) else len(body)
            req = urllib.request.Request(addr + "/v1/client/gc",
                                         method="PUT")
            with urllib.request.urlopen(req, timeout=120) as resp:
                http["gc_status"] = resp.status
            out["http"] = http
            for c in local[1:]:
                c.garbage_collector.collect_all()
            left = alloc_dirs(root, names[:n_local])
            left.update(remote.ask("gc")["dirs"])
            out["dirs_after_gc"] = sum(len(v) for v in left.values())
            steps["dirs_and_gc_s"] = time.perf_counter() - t_gc
            b = srv.eval_broker.stats()
            out["health"] = {
                "nacks": b["total_nacks"], "failed": b["total_failed"],
                "breaker": brk.state, "trips": brk.trips,
                "oracle_routed": server_counter(srv,
                                                "breaker.oracle_routed"),
                "over_capacity": store_over_capacity(srv)}
            t_vault = time.perf_counter()
            out["vault"] = client_vault_job(srv, fv, agent.client)
            steps["vault_job_s"] = time.perf_counter() - t_vault
            if on_card:
                t_gpu = time.perf_counter()
                out["gpu_job"] = client_gpu_job(srv, sizes, local)
                steps["gpu_job_s"] = time.perf_counter() - t_gpu
        t_stop = time.perf_counter()
        # The remote clients stop while the local ones do.
        remote.proc.stdin.write("stop\n")
        remote.proc.stdin.flush()
        shutdown_clients(local[1:])
        report = remote.read()
        out["remote"] = report
        out["remote_gpu_attrs"] = sum(
            "gpu.type" in attrs for attrs in report["attributes"].values())
        out["update_allocs"]["client_side_calls"] = (
            sum(c.sync_calls for c in local) + report["sync_calls"])
        agent.shutdown()
        wait_until(lambda: not agent.threads() and not any(
            c.threads() for c in local), 30.0)
        out["pids_alive_after_shutdown"] = (
            alive_pids(local_records) + report["alive_pids"])
        out["threads_after_shutdown"] = (
            [t.name for t in agent.threads()]
            + [t.name for c in local for t in c.threads()]
            + report["threads"])
        steps["shutdown_s"] = time.perf_counter() - t_stop
        agent = None
    finally:
        delivery.release()
        if remote is not None:
            remote.close()
        if agent is not None:
            shutdown_clients(local[1:])
            agent.shutdown()
        # After a fault, no supervisor or task outlives the world (a
        # client's shutdown leaves them running).
        for pid in alive_pids(exec_records(root, names)):
            try:
                os.killpg(pid, signal.SIGKILL)
            except OSError:
                pass
    out["kernel_shapes"] = {k: sorted(v) for k, v in
                            out["kernel_shapes"].items()}
    out["world_s"] = time.perf_counter() - t_world
    return out


def percentile(values, q):
    """The ``q``-th percentile of ``values`` (None when empty)."""
    import numpy as np

    return float(np.percentile(values, q)) if len(values) else None


def exec_content(srv, records) -> dict:
    """The exec-family tasks' outcome by content, keyed by job and alloc
    name: each log file's content, the count of log files and of
    supervisor and task pids recorded, and the supervisor start times
    (ms)."""
    by_id = {a.id: f"{a.job_id}/{a.name}" for a in srv.state.allocs(None)}
    logs = {}
    starts = []
    for alloc_id, r in records.items():
        for f, content in r["logs"].items():
            logs[f"{by_id.get(alloc_id, alloc_id)}/{f}"] = content
        starts += [s * 1e3 for s in r["start_s"]]
    return {"exec_logs": dict(sorted(logs.items())),
            "exec_log_files": len(logs),
            "exec_allocs": len(records),
            "exec_pids": sum(len(r["pids"]) for r in records.values()),
            "supervisor_start_ms": sorted(starts)}


def client_gpu_job(srv, sizes, local) -> dict:
    """A job pinned on ``${attr.gpu.type}`` (the card's name) through the
    card server: it must land only on the clients that fingerprinted the
    card and run to completion; its own launch counts."""
    import torch

    from nomad_tpu_torch.ops import fused_score, kernels
    from nomad_tpu_torch.structs import structs as ps
    from nomad_tpu_torch.utils.backoff import wait_until

    card = torch.cuda.get_device_name(0)
    job = client_job("gpu-pinned", "batch", sizes["gpu_count"],
                     {"run_for": 1.0}, dict(attempts=0, mode="fail"))
    job.constraints = [ps.Constraint("${attr.gpu.type}", card, "=")]
    zero_counts()
    srv.job_register(job)
    ok = wait_until(lambda: len(srv.state.allocs_by_job(
        None, job.id, True)) == sizes["gpu_count"] and all(
            a.client_status == "complete"
            for a in srv.state.allocs_by_job(None, job.id, True)),
        CLIENT_WAIT)
    allocs = srv.state.allocs_by_job(None, job.id, True)
    fingerprinted = {c.node.id for c in local
                     if c.node.attributes.get("gpu.type") == card}
    return {"card": card, "completed": ok, "allocs": len(allocs),
            "statuses": sorted(a.client_status for a in allocs),
            "on_fingerprinted": all(a.node_id in fingerprinted
                                    for a in allocs),
            "nodes": sorted({srv.state.node_by_id(None, a.node_id).name
                             for a in allocs}),
            "launches": kernel_counts()}


def client_vault_job(srv, fv, client) -> dict:
    """A batch job whose task asks for vault, pinned on the agent's own
    client (whose token manager unwraps through ``FakeVault``): its task
    events, its ``secrets/vault_token`` (the token vault minted with the
    task's policy), and its accessor revoked in ``FakeVault`` and its row
    deregistered once the alloc has ended."""
    from nomad_tpu_torch.structs import structs as ps
    from nomad_tpu_torch.utils.backoff import wait_until

    job = client_job("vault-task", "batch", 1, {"run_for": 0.5},
                     dict(attempts=0, mode="fail"))
    job.constraints = [ps.Constraint("${node.unique.name}",
                                     client.node.name, "=")]
    for t in job.task_groups[0].tasks:
        t.vault = ps.Vault(policies=["smoke-read"])
    srv.job_register(job)

    def alloc():
        got = srv.state.allocs_by_job(None, job.id, True)
        return got[0] if got else None

    done = wait_until(lambda: alloc() is not None
                      and alloc().client_terminal_status(), CLIENT_WAIT)
    a = alloc()
    out = {"completed": bool(done) and a.client_status == "complete",
           "node": srv.state.node_by_id(None, a.node_id).name if a else ""}
    runner = client.get_alloc_runner(a.id) if a else None
    token = ""
    if runner is not None:
        path = os.path.join(
            runner.alloc_dir.task_dirs[job.task_groups[0].tasks[0].name]
            .secrets_dir, "vault_token")
        if os.path.exists(path):
            with open(path) as fh:
                token = fh.read()
    rec = fv.tokens.get(token) or {}
    accessor = rec.get("accessor", "")
    out["token_file"] = bool(token)
    out["token_policies"] = rec.get("policies")
    out["token_metadata_alloc"] = (rec.get("metadata") or {}).get(
        "AllocationID") == (a.id if a else None)
    out["accessor_revoked"] = bool(accessor) and wait_until(
        lambda: fv.is_revoked(accessor), CLIENT_WAIT)
    out["accessor_rows_left"] = len(srv.state.vault_accessors_by_alloc(
        None, a.id)) if a else None
    if a is not None and out["accessor_rows_left"]:
        wait_until(lambda: not srv.state.vault_accessors_by_alloc(
            None, a.id), CLIENT_WAIT)
        out["accessor_rows_left"] = len(
            srv.state.vault_accessors_by_alloc(None, a.id))
    out["task_events"] = {
        name: [ev.type for ev in st.events]
        for name, st in sorted((a.task_states or {}).items())} if a else {}
    out["derived"] = len(fv.tokens)
    return out


def client_child(dev, out_path, sizes, root) -> None:
    """One world of phase ``client`` in a process of its own; the report
    is written to ``out_path``."""
    out = client_world(dev, sizes, root)
    with open(out_path, "w") as fh:
        json.dump(out, fh)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run_client_child(dev, root, sizes, label) -> dict:
    """``client_child`` in a fresh process under the phase's string hash
    seed, its files under ``root/label``; its report."""
    wroot = os.path.join(root, label)
    os.makedirs(wroot)
    out_path = os.path.join(root, f"client-{label}.json")
    code = ("import sys; sys.path.insert(0, {0!r}); import chip_smoke as c; "
            "c.client_child({1!r}, {2!r}, {3!r}, {4!r})"
            ).format(REPO, dev, out_path, sizes, wroot)
    env = dict(os.environ, PYTHONHASHSEED=str(CLIENT_HASH_SEED))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True,
                          timeout=CLIENT_CHILD_TIMEOUT)
    if proc.returncode != 0 or not os.path.exists(out_path):
        raise AssertionError(f"client child {label} on {dev}: rc "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    with open(out_path) as fh:
        out = json.load(fh)
    os.unlink(out_path)
    out["child_wall_s"] = time.perf_counter() - t0
    return out


def check_client_world(w, label, sizes, on_card) -> list:
    """The invariants of one world."""
    errors = []
    h = w["health"]
    if (h["nacks"] or h["failed"] or h["breaker"] != "closed" or h["trips"]
            or h["oracle_routed"] or h["over_capacity"]):
        errors.append(f"{label}: health {h}")
    planned = sum(n * c for n, c in (sizes["batch"], sizes["fail"],
                                     sizes["service"]))
    if w["allocs"] != planned or len(w["placements"]) != planned:
        errors.append(f"{label}: {w['allocs']} allocs, planned {planned}")
    want = {"batch": ("complete", ["Received", "Started", "Terminated"]),
            "fail": ("failed", ["Received", "Started", "Terminated",
                                "Restarting", "Started", "Terminated",
                                "Not Restarting"]),
            "service": ("complete", ["Received", "Started", "Killing",
                                     "Killed"])}
    for key, status in w["client_statuses"].items():
        kind = key.split("-")[0]
        if status != want[kind][0]:
            errors.append(f"{label}: {key} ended {status}")
            break
    for key, types_ in w["events"].items():
        if types_ != want[key.split("-")[0]][1]:
            errors.append(f"{label}: {key} events {types_}")
            break
    if w["driver_failures"]:
        errors.append(f"{label}: driver failures "
                      f"{list(w['driver_failures'].items())[:4]}")
    codes = {"batch": [0], "fail": [1, 1], "service": []}
    for key, got in w["exit_codes"].items():
        if got != codes[key.split("-")[0]]:
            errors.append(f"{label}: {key} exit codes {got}")
            break
    # The exec family: a real process an alloc (and its supervisor), the
    # batch tasks' interpolated stdout, nothing alive after the shutdown.
    bcount, fcount = sizes["batch"][1], sizes["fail"][1]
    n_exec = ((sizes["raw_exec_batch"] + sizes["exec_batch"]) * bcount
              + sizes["raw_exec_fail"] * fcount)
    if w["exec_allocs"] != n_exec or w["exec_pids"] != 2 * n_exec:
        errors.append(f"{label}: {w['exec_allocs']} exec-family allocs "
                      f"with {w['exec_pids']} pids, want {n_exec}")
    want_logs = {}
    for key in w["placements"]:
        job_id, name = key.split("/")
        if job_id.startswith("batch") and exec_driver_of(
                job_id, sizes) != "mock_driver":
            index = name[name.rindex("[") + 1:-1]
            want_logs[f"{key}/web.stdout.0"] = f"{index} web\n"
    if w["exec_logs"] != want_logs or w["exec_log_files"] != len(want_logs):
        diff = sorted(k for k in set(want_logs) | set(w["exec_logs"])
                      if want_logs.get(k) != w["exec_logs"].get(k))
        errors.append(f"{label}: exec logs differ at {diff[:4]} of "
                      f"{len(diff)}")
    if w["pids_alive_after_shutdown"]:
        errors.append(f"{label}: supervisor or task pids alive after "
                      f"shutdown: {w['pids_alive_after_shutdown'][:8]}")
    # Every client offers the network its fingerprint found; only the
    # service tasks ask for one, and each got it.
    if len(w["node_networks"]) != 1:
        errors.append(f"{label}: client networks {w['node_networks']}")
    for key, nets in w["networks"].items():
        ask = [[w["node_networks"][0][0], 50, 2]] if (
            key.startswith("service") and w["node_networks"]) else []
        if nets != ask:
            errors.append(f"{label}: {key} networks {nets}, want {ask}")
            break
    la = w["launches"]
    # One round-kernel launch a batch, the kernel's committing steps the
    # server's (before the round kernel: one scored_rows launch a step).
    if on_card and not launches_ok(la):
        errors.append(f"{label}: round kernel launches {la}")
    if not on_card and (la["scored_rows"] or la["placement_rounds"]):
        errors.append(f"{label}: kernel launched off the card {la}")
    if la["masked_score_matrix"] or la["eviction_sets"]:
        errors.append(f"{label}: unexpected launches {la}")
    if not w["dirs_made_as_placed"] or w["dirs_made"] != planned \
            or w["dirs_after_gc"]:
        errors.append(f"{label}: alloc dirs {w['dirs_made']} made (as "
                      f"placed: {w['dirs_made_as_placed']}), "
                      f"{w['dirs_after_gc']} after the GC")
    if w["http"].get("gc_status") != 200:
        errors.append(f"{label}: /v1/client/gc {w['http']}")
    if w["threads_after_shutdown"]:
        errors.append(f"{label}: threads left after shutdown: "
                      f"{w['threads_after_shutdown'][:8]}")
    if w["nodes"] != sizes["n_nodes"]:
        errors.append(f"{label}: {w['nodes']} nodes registered")
    return errors


def phase_client(dev, sizes=None):
    """The client (see the module docstring, phase 26): world A (a fleet
    of port clients on a card server) and world C (A's script on the
    CPU), each in a process of its own, compared here; A's GPU-pinned
    job; ``scored_rows`` at the shapes A gave it against its plain
    version."""
    import shutil
    import tempfile

    import torch

    t_phase = time.perf_counter()
    smi = smi_name_power()
    on_card = torch_device(dev).type == "cuda"
    sizes = dict(CLIENT_SIZES if sizes is None else sizes)
    root = tempfile.mkdtemp(prefix="nomad-torch-client-")
    cgroups_before = cgroup_tree()
    # The two worlds run side by side, each in its own processes: neither
    # reads the other, and no timing moves a placement (``AllocDelivery``).
    try:
        worlds, beside = side_by_side({
            "A": (["A"], lambda: run_client_child(dev, root, sizes, "A")),
            "C": (["C"], lambda: run_client_child("cpu", root, sizes,
                                                  "C"))})
    finally:
        shutil.rmtree(root, ignore_errors=True)
        cgroups_made = sorted(set(cgroup_tree()) - set(cgroups_before))
    a, c = worlds["A"], worlds["C"]
    errors = (check_client_world(a, "A", sizes, on_card)
              + check_client_world(c, "C", sizes, False))
    if cgroups_made:
        errors.append(f"cgroups made under /sys/fs/cgroup: "
                      f"{cgroups_made[:8]}")
    for w, label in ((a, "A"), (c, "C")):
        v = w["vault"]
        if not (v["completed"] and v["token_file"]
                and v["token_policies"] == ["smoke-read"]
                and v["token_metadata_alloc"] and v["accessor_revoked"]
                and v["accessor_rows_left"] == 0):
            errors.append(f"{label}: the vault job {v}")
    if a["vault"]["task_events"] != c["vault"]["task_events"]:
        errors.append(f"A != C vault task events: "
                      f"{a['vault']['task_events']} "
                      f"{c['vault']['task_events']}")
    for key in ("placements", "client_statuses", "events", "exit_codes",
                "networks", "jobs", "summaries", "exec_logs",
                "exec_log_files"):
        if a[key] != c[key]:
            diff = [k for k in set(a[key]) | set(c[key])
                    if a[key].get(k) != c[key].get(k)]
            errors.append(f"A != C {key}: {sorted(diff)[:5]} of "
                          f"{len(diff)}")
    if a["launches"]["committing_spec_steps"] != \
            c["launches"]["committing_spec_steps"]:
        errors.append(f"A != C committing steps: {a['launches']} "
                      f"{c['launches']}")
    n_local = sizes["n_clients"] - sizes["n_remote"]
    gpu = {}
    shape_parity = {}
    if on_card:
        card = torch.cuda.get_device_name(0)
        if sorted(a["gpu_type"].values()) != [card] * n_local or \
                a["remote_gpu_attrs"]:
            errors.append(f"A: gpu.type on the in-process clients "
                          f"{set(a['gpu_type'].values())}, on "
                          f"{a['remote_gpu_attrs']} remote ones")
        gpu = a["gpu_job"]
        lg = gpu["launches"]
        # The round kernel once a batch the job's batch ran (before it:
        # one scored_rows launch a committing step).
        if not (gpu["completed"] and gpu["on_fingerprinted"]
                and gpu["allocs"] == sizes["gpu_count"]
                and lg["placement_rounds"] == lg["round_calls"] > 0
                and lg["rounds_run"] > 0
                and lg["committing_spec_steps"] > 0
                and steps_in_bounds(lg)
                and lg["scored_rows"] == 0):
            errors.append(f"A: the GPU-pinned job {gpu}")
        try:
            shape_parity = path_shape_parity(dev, a["kernel_shapes"],
                                             "client")
        except AssertionError as exc:
            errors.append(str(exc))
    if errors:
        errors.append("release -> acked s: A {} C {}".format(
            a["release_to_acked_s"], c["release_to_acked_s"]))
        raise AssertionError(f"phase client: {errors}")

    def start_stats(w):
        ms = w["supervisor_start_ms"]
        return {"n": len(ms), "median_ms": percentile(ms, 50),
                "p99_ms": percentile(ms, 99)}

    def world_row(w, label):
        calls = w["update_allocs"]
        return {"device": w["device"],
                "supervisor_start": start_stats(w),
                "clients_register_s": w["clients_register_s"],
                "mock_node_register_s": w["mock_node_register_s"],
                "fleet_ready_s": w["fleet_ready_s"],
                "release_to_acked_s": w["release_to_acked_s"],
                "release_to_all_running_s": w["release_to_all_running_s"],
                "release_to_all_terminal_s": w["release_to_all_terminal_s"],
                "node_update_allocs_calls": calls["n"],
                "node_update_allocs_mean_batch": (calls["allocs"]
                                                  / max(1, calls["n"])),
                "client_side_sync_calls": calls["client_side_calls"],
                "launches": w["launches"], "http": w["http"],
                "steps": w["steps"],
                "world_s": w["world_s"], "child_wall_s": w["child_wall_s"],
                "ran_beside": beside[label]}

    return {"card": smi, "sizes": sizes, "reduced": a["reduced"],
            "A_card": world_row(a, "A"), "C_cpu": world_row(c, "C"),
            "allocs": a["allocs"], "placements_equal": True,
            "statuses_equal": True, "events_equal": True,
            "exit_codes_equal": True, "exec_logs_equal": True,
            "summaries_equal": True, "networks_equal": True,
            "exec_allocs": a["exec_allocs"],
            "exec_log_files": a["exec_log_files"],
            "pids_alive_after_shutdown": 0, "cgroups_made": 0,
            "node_networks": a["node_networks"],
            "client_statuses": dict(collections.Counter(
                a["client_statuses"].values())),
            "vault": {"A": a["vault"], "C": c["vault"],
                      "task_events_equal": True},
            "gpu_job": gpu, "kernel_shapes": a["kernel_shapes"],
            "shape_parity": shape_parity,
            "launches": {"client": a["launches"],
                         "gpu_job": gpu.get("launches", {})},
            "seconds": time.perf_counter() - t_phase}


# -- phase 27: federation ---------------------------------------------------

# Two regions, each one port server (single voter), WAN-joined: r0 on the
# in-memory log, r1 on a FileLog (leg 2 restarts it from its data dir).
FEDERATION_REGIONS = ("r0", "r1")
# Each region: cluster leg 1's fleet at 5,000 nodes; leg 1's wave: 40 jobs
# of 250 asks, submitted through r0, the odd ones for r1 (forwarded).
FEDERATION_SIZES = {"n_nodes": 5_000, "n_jobs": 40, "count": 250,
                    "rate_jobs": 256, "rate_clients": 8,
                    "dark_jobs": 4, "home_jobs": 4, "home_count": 50}
FEDERATION_SEED = 20261118
FEDERATION_HASH_SEED = 20261118
FEDERATION_CHILD_TIMEOUT = 600.0
# Leg 2's bounds: a submission for the dark region raises NoPathToRegion
# within FEDERATION_NO_PATH_BOUND_S (never hangs); after the restart a
# probe job is placed there within the multi_region scenario's
# recovery_bound_s.
FEDERATION_NO_PATH_BOUND_S = 10.0
FEDERATION_RECOVERY_BOUND_S = 30.0


def federation_server(dev, region, brk, root, join="", port=0):
    """One region's port server on ``dev``: RPC on loopback, its event
    stream armed (the aggregator's ``Event.Since``), r1 on a FileLog."""
    from nomad_tpu_torch.server import Server, ServerConfig

    return Server(ServerConfig(
        device=dev, rng_seed=SERVER_SEED, batch_size=64,
        min_heartbeat_ttl=SERVER_HEARTBEAT_TTL, breaker=brk,
        region=region, node_name=f"fed-{region}", enable_rpc=True,
        rpc_port=port, events=True, wan_join=[join] if join else [],
        data_dir=os.path.join(root, region) if region == "r1" else ""))


def federation_content(srv, jobs) -> dict:
    """One region's outcome by content: each job's placements (alloc name
    to node), its unplaced count (the summary's queued plus the eval's
    failed allocs) and its first alloc's AllocMetric scores."""
    st = srv.state
    out = {"placements": {}, "unplaced": {}, "scores": {}}
    for j in jobs:
        allocs = sorted(st.allocs_by_job(None, j.id, True),
                        key=lambda a: a.name)
        out["placements"][j.id] = [[a.name, a.node_id] for a in allocs
                                   if not a.terminal_status()]
        summ = st.job_summary_by_id(None, j.id)
        queued = sum(v.queued for v in summ.summary.values()) if summ else 0
        failed = sum(m.coalesced_failures + 1
                     for e in st.evals_by_job(None, j.id)
                     for m in e.failed_tg_allocs.values())
        out["unplaced"][j.id] = [queued, failed]
        scored = [a for a in allocs if a.metrics is not None]
        out["scores"][j.id] = (sorted(scored[0].metrics.scores.items())
                               if scored else [])
    return out


def federation_rates(servers, n_jobs, n_clients) -> dict:
    """The cross-region forward tax as a rate: ``n_jobs`` one-alloc jobs
    of r1 sent by ``n_clients`` threads at once, first through r1 itself
    (``local``), then through r0 (``cross``: each one forwarded to r1).
    For each stream: the registrations a second, and the evals a second
    r1 acked from the stream's first submission to its last eval acked.
    Both streams end in the same server, log and scheduler, so what
    differs is the forward.  The kernels' counts are set to 0 just
    before and read just after."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.utils.backoff import wait_until

    r0n, r1n = FEDERATION_REGIONS
    r1 = servers[r1n]
    out = {}
    for stream, via in (("local", r1n), ("cross", r0n)):
        jobs = []
        for k in range(n_jobs):
            j = strip_job(mock.job(), 1)
            j.id = j.name = f"fed-rate-{stream}-{k:04d}"
            j.region = r1n
            jobs.append(j)
        faults = []

        def send(part, srv=servers[via]):
            try:
                for j in part:
                    srv.job_register(j)
            except BaseException as exc:  # noqa: BLE001 — raised below
                faults.append(exc)

        steps0 = zero_launches(r1)
        acks0 = server_counter(r1, "broker.ack")
        threads = [threading.Thread(target=send, args=(jobs[i::n_clients],))
                   for i in range(n_clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        submit_s = time.perf_counter() - t0
        if faults:
            raise faults[0]
        if not wait_until(lambda: server_counter(r1, "broker.ack") - acks0
                          >= n_jobs, SERVER_SETTLE_TIMEOUT):
            raise AssertionError(f"federation: the {stream} stream's evals "
                                 "were not acked")
        acked_s = time.perf_counter() - t0
        server_settle(r1)
        out[stream] = {
            "jobs": n_jobs, "clients": n_clients, "submit_s": submit_s,
            "registrations_per_s": n_jobs / submit_s, "acked_s": acked_s,
            "evals_acked": int(server_counter(r1, "broker.ack") - acks0),
            "evals_per_s": n_jobs / acked_s,
            "placed": sum(len(r1.state.allocs_by_job(None, j.id, True))
                          for j in jobs),
            "launches": durable_launches(r1, steps0)}
    return out


def federation_world(dev, sizes, root, leg3) -> dict:
    """One world of phase ``federation`` (see the module docstring): leg 1
    (the wave through r0, half forwarded to r1, each region released and
    settled in turn), the forward rates (:func:`federation_rates`), leg
    2 (r1 stopped: its submissions through r0 raise ``NoPathToRegion``,
    r0 serves its own, the aggregator names r1 dark; r1 restarted on its
    data dir and a probe placed there) and, when ``leg3``, the
    ``multi_region`` scenario through ``run_multi_region``'s harness on
    ``dev``.  The kernels' counts are set to 0 just before leg 1's
    release and read once both regions have settled, and likewise
    around each rate stream and leg 3."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.loadgen.auditor import federated_sweep
    from nomad_tpu_torch.ops import fused_score, kernels, preempt
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.server.federation import RegionEventAggregator
    from nomad_tpu_torch.server.rpc import ConnPool, NoPathToRegion
    from nomad_tpu_torch.utils.backoff import wait_until

    t_world = time.perf_counter()
    r0n, r1n = FEDERATION_REGIONS
    fleet = {}
    for r in FEDERATION_REGIONS:
        fleet[r] = []
        for i in range(sizes["n_nodes"]):
            n = strip_node(mock.node())
            n.id = n.name = f"{r}-node-{i:05d}"
            fleet[r].append(n)
    jobs = []
    for k in range(sizes["n_jobs"]):
        j = strip_job(mock.job(), sizes["count"])
        j.id = j.name = f"fed-{k:03d}"
        j.region = FEDERATION_REGIONS[k % 2]
        jobs.append(j)
    brks = {r: KernelCircuitBreaker() for r in FEDERATION_REGIONS}
    out = {"device": str(dev), "card": smi_name_power(),
           "kernel_shapes": new_shapes(),
           "reduced": {"nodes": f"{sizes['n_nodes']} nodes a region "
                       "(cluster leg 1's fleet shape; two regions on one "
                       "host)"}}
    servers = {}
    r0 = servers[r0n] = federation_server(dev, r0n, brks[r0n], root)
    r0.start()
    servers[r1n] = federation_server(dev, r1n, brks[r1n], root,
                                     join=r0.config.rpc_advertise)
    servers[r1n].start()
    pool = ConnPool()
    ids = seeded_ids(FEDERATION_SEED)
    try:
        if not wait_until(lambda: all(
                x.is_leader() and len(x.members()) == 2
                for x in servers.values()), CLUSTER_ELECTION_TIMEOUT):
            raise AssertionError("federation: the regions did not form")
        out["regions"] = r0.regions()
        with ids:
            t0 = time.perf_counter()
            for r, srv in servers.items():
                for n in fleet[r]:
                    srv.node_register(n)
            out["node_register_s"] = time.perf_counter() - t0
            for srv in servers.values():
                if not srv.set_workers_paused(
                        True, timeout=SERVER_SETTLE_TIMEOUT):
                    raise AssertionError("federation: workers did not park")
            steps0 = sum(server_counter(x, "batch.commit_steps")
                         for x in servers.values())
            rounds0 = sum(server_rounds(x) for x in servers.values())
            zero_counts()
            submit = {"local": [], "forwarded": []}
            with kernel_shapes(out["kernel_shapes"]):
                for j in jobs:
                    t0 = time.perf_counter()
                    r0.job_register(j)
                    submit["forwarded" if j.region == r1n else "local"].append(
                        (time.perf_counter() - t0) * 1000.0)
                waves = {}
                for r, srv in servers.items():
                    acks0 = server_counter(srv, "broker.ack")
                    t0 = time.perf_counter()
                    srv.set_workers_paused(False)
                    wall = server_settle(srv) - t0
                    acked = int(server_counter(srv, "broker.ack") - acks0)
                    waves[r] = {"wall_s": wall, "evals_acked": acked,
                                "evals_per_s": acked / wall}
            out["launches"] = kernel_counts(
                batch_commit_steps=sum(
                    server_counter(x, "batch.commit_steps")
                    for x in servers.values()) - steps0,
                rounds=sum(server_rounds(x) for x in servers.values())
                - rounds0)
        out["waves"] = waves
        out["submit_ms"] = {k: {"n": len(v), "mean": statistics.fmean(v),
                                "max": max(v)} for k, v in submit.items()}
        out["content"] = {r: federation_content(
            srv, [j for j in jobs if j.region == r])
            for r, srv in servers.items()}
        out["not_in_home"] = {r: sorted(
            j.id for j in jobs if j.region != r
            and srv.state.job_by_id(None, j.id) is not None)
            for r, srv in servers.items()}
        sweep = federated_sweep({r: srv.consistent_snapshot()
                                 for r, srv in servers.items()}, strict=True)
        out["cross_region_double_placed"] = sweep[
            "cross_region_double_placed"]
        out["sweep_regions"] = {r: {k: v[k] for k in (
            "overplaced_jobs", "duplicate_alloc_names",
            "overcommitted_nodes")} for r, v in sweep["regions"].items()}
        out["health"] = {r: durable_health(srv, brks[r])
                         for r, srv in servers.items()}
        out["rates"] = federation_rates(servers, sizes["rate_jobs"],
                                        sizes["rate_clients"])

        # Leg 2: r1 goes dark, comes back on its data dir.
        agg = RegionEventAggregator(
            {r: srv.config.rpc_advertise for r, srv in servers.items()},
            pool=pool)
        agg.poll()
        cursor = agg.cursors()[r1n]
        r1_addr = servers[r1n].config.rpc_advertise
        servers[r1n].shutdown()
        t_dark = time.perf_counter()
        dark = []
        for k in range(sizes["dark_jobs"]):
            j = strip_job(mock.job(), 1)
            j.id = j.name = f"fed-dark-{k:02d}"
            j.region = r1n
            t0 = time.perf_counter()
            try:
                r0.job_register(j)
                dark.append({"raised": None})
            except NoPathToRegion as e:
                dark.append({"raised": type(e).__name__, "region": e.region,
                             "retry_after": e.retry_after,
                             "rounds": e.rounds,
                             "s": time.perf_counter() - t0})
        # The same refusal over the wire, re-typed from the reply.
        j = strip_job(mock.job(), 1)
        j.id = j.name = "fed-dark-wire"
        t0 = time.perf_counter()
        try:
            pool.call(r0.config.rpc_advertise, "Job.Register",
                      {"Job": j, "Region": r1n})
            wire = {"raised": None}
        except NoPathToRegion as e:
            wire = {"raised": type(e).__name__, "region": e.region,
                    "retry_after": e.retry_after,
                    "s": time.perf_counter() - t0}
        agg.poll()
        leg2 = {"dark_submits": dark, "wire_submit": wire,
                "unreachable_while_dark": agg.unreachable(),
                "cursor_kept": agg.cursors()[r1n] == cursor}
        home = []
        for k in range(sizes["home_jobs"]):
            j = strip_job(mock.job(), sizes["home_count"])
            j.id = j.name = f"fed-home-{k:02d}"
            j.region = r0n
            home.append(j)
        with ids:
            leg2["home_wave"] = server_wave(r0, "home_during_blackout",
                                            lambda s: [s.job_register(j)
                                                       for j in home])
        leg2["home_placed"] = sum(len(r0.state.allocs_by_job(None, j.id,
                                                              True))
                                  for j in home)
        leg2["dark_s"] = time.perf_counter() - t_dark
        # The restart on the same address and data dir heals the region.
        t_heal = time.perf_counter()
        r1b = servers[r1n] = federation_server(
            dev, r1n, brks[r1n], root, join=r0.config.rpc_advertise,
            port=int(r1_addr.rsplit(":", 1)[1]))
        r1b.start()
        if not wait_until(r1b.is_leader, CLUSTER_ELECTION_TIMEOUT):
            raise AssertionError("federation: r1 did not lead again")
        leg2["restart_s"] = time.perf_counter() - t_heal
        probe = strip_job(mock.job(), 1)
        probe.id = probe.name = "fed-probe"
        probe.region = r1n
        registered = placed = None
        attempts = 0
        with ids:
            while time.perf_counter() - t_heal < FEDERATION_RECOVERY_BOUND_S:
                attempts += 1
                try:
                    r0.job_register(probe)
                    registered = time.perf_counter() - t_heal
                    break
                except NoPathToRegion:
                    time.sleep(0.25)
            if registered is not None and wait_until(
                    lambda: any(not a.terminal_status()
                                for a in r1b.state.allocs_by_job(
                                    None, probe.id, True)),
                    max(0.0, FEDERATION_RECOVERY_BOUND_S
                        - (time.perf_counter() - t_heal))):
                placed = time.perf_counter() - t_heal
        leg2.update(probe_attempts=attempts, registered_after_heal_s=registered,
                    placed_after_heal_s=placed,
                    recovered_index=r1b.raft.applied_index())
        wait_until(lambda: not agg.poll() and not agg.unreachable(), 10.0)
        leg2["unreachable_after_heal"] = agg.unreachable()
        leg2["cursor_after_heal"] = agg.cursors()[r1n] >= cursor
        leg2["aggregator"] = agg.stats()
        out["leg2"] = leg2
        out["draws"] = ids.draws
    finally:
        pool.close()
        for srv in servers.values():
            srv.shutdown()
    out["kernel_shapes"] = {k: sorted(v) for k, v in
                            out["kernel_shapes"].items()}
    if leg3:
        # run_multi_region's harness, kept to read its servers' counters.
        from nomad_tpu_torch.loadgen.federation import MultiRegionHarness
        from nomad_tpu_torch.loadgen.scenario import get_scenario

        brk = KernelCircuitBreaker()
        harness = MultiRegionHarness(
            get_scenario("multi_region"), device=dev,
            server_options={"rng_seed": SERVER_SEED, "breaker": brk})
        shapes = new_shapes()
        zero_counts()
        t0 = time.perf_counter()
        with kernel_shapes(shapes):
            rep = harness.run()
        fed = rep["federation"]
        regions = harness.servers.values()
        out["leg3"] = {
            "wall_s": time.perf_counter() - t0,
            "offered": rep["offered"], "sustained": rep["sustained"],
            "forward_tax_ms": fed["forward_tax_ms"],
            "reads_ms": fed["reads_ms"], "blackout": fed["blackout"],
            "per_region": fed["per_region"],
            "aggregator": fed["aggregator"],
            "auditor": {k: rep["auditor"][k] for k in (
                "violation_count", "violations", "checks", "acked_checked",
                "lost_acked")},
            "launches": kernel_counts(
                batch_commit_steps=sum(
                    server_counter(x, "batch.commit_steps")
                    for x in regions),
                rounds=sum(server_rounds(x) for x in regions)),
            "breaker": {"state": brk.state, "trips": brk.trips,
                        "oracle_routed": sum(
                            server_counter(x, "breaker.oracle_routed")
                            for x in regions)},
            "kernel_shapes": {k: sorted(v) for k, v in shapes.items()}}
    out["world_s"] = time.perf_counter() - t_world
    return out


def federation_child(dev, out_path, sizes, root, leg3) -> None:
    """One world of phase ``federation`` in a process of its own; the
    report is written to ``out_path``."""
    out = federation_world(dev, sizes, root, leg3)
    with open(out_path, "w") as fh:
        json.dump(out, fh)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run_federation_child(dev, root, sizes, label, leg3) -> dict:
    """``federation_child`` in a fresh process under the phase's string
    hash seed, its data dirs under ``root/label``; its report."""
    wroot = os.path.join(root, label)
    os.makedirs(wroot)
    out_path = os.path.join(root, f"federation-{label}.json")
    code = ("import sys; sys.path.insert(0, {0!r}); import chip_smoke as c; "
            "c.federation_child({1!r}, {2!r}, {3!r}, {4!r}, {5!r})"
            ).format(REPO, dev, out_path, sizes, wroot, leg3)
    env = dict(os.environ, PYTHONHASHSEED=str(FEDERATION_HASH_SEED))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True,
                          timeout=FEDERATION_CHILD_TIMEOUT)
    if proc.returncode != 0 or not os.path.exists(out_path):
        raise AssertionError(f"federation child {label} on {dev}: rc "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    with open(out_path) as fh:
        out = json.load(fh)
    os.unlink(out_path)
    out["child_wall_s"] = time.perf_counter() - t0
    return out


def check_federation_world(w, label, sizes, on_card) -> list:
    """One world's checks: every job only in its own region, nothing
    double placed across or within the regions, healthy regions, and leg
    2's contract."""
    errors = []
    if w["regions"] != list(FEDERATION_REGIONS):
        errors.append(f"{label}: regions {w['regions']}")
    if any(w["not_in_home"].values()):
        errors.append(f"{label}: jobs outside their region "
                      f"{w['not_in_home']}")
    if w["cross_region_double_placed"]:
        errors.append(f"{label}: {w['cross_region_double_placed']} jobs "
                      "hold allocs in two regions")
    for r, sw in w["sweep_regions"].items():
        if any(sw.values()):
            errors.append(f"{label}: region {r} sweep {sw}")
    for r, h in w["health"].items():
        if (h["over_capacity"] or h["nacks"] or h["failed"]
                or h["breaker"] != {"state": "closed", "trips": 0,
                                    "oracle_routed": 0}):
            errors.append(f"{label}: region {r} health {h}")
    want = sizes["n_jobs"] // 2
    for r, wv in w["waves"].items():
        if wv["evals_acked"] != want:
            errors.append(f"{label}: region {r} acked "
                          f"{wv['evals_acked']} of {want}")
    if on_card:
        errors += check_launches(f"{label} leg 1", w["launches"])
    for stream, rate in w["rates"].items():
        if (rate["evals_acked"] != rate["jobs"]
                or rate["placed"] != rate["jobs"]):
            errors.append(f"{label}: the {stream} rate stream {rate}")
        if on_card:
            errors += check_launches(f"{label} {stream} rate stream",
                                     rate["launches"])
    leg2 = w["leg2"]
    for d in leg2["dark_submits"] + [leg2["wire_submit"]]:
        if (d.get("raised") != "NoPathToRegion"
                or d.get("region") != FEDERATION_REGIONS[1]
                or not d.get("retry_after", 0) > 0
                or d.get("s", 1e9) > FEDERATION_NO_PATH_BOUND_S):
            errors.append(f"{label}: a submission for the dark region {d}")
    if leg2["unreachable_while_dark"] != [FEDERATION_REGIONS[1]] \
            or not leg2["cursor_kept"]:
        errors.append(f"{label}: the aggregator while dark {leg2}")
    if leg2["home_placed"] != sizes["home_jobs"] * sizes["home_count"]:
        errors.append(f"{label}: the home region placed "
                      f"{leg2['home_placed']} while r1 was dark")
    if (leg2["placed_after_heal_s"] is None
            or leg2["placed_after_heal_s"] > FEDERATION_RECOVERY_BOUND_S):
        errors.append(f"{label}: the probe after the heal {leg2}")
    if leg2["unreachable_after_heal"] or not leg2["cursor_after_heal"]:
        errors.append(f"{label}: the aggregator after the heal "
                      f"{leg2['unreachable_after_heal']}")
    return errors


def phase_federation(dev, sizes=None):
    """The federation (see the module docstring, phase 27): world A (two
    WAN-joined regions, each its own port server on ``dev``) and world C
    (the same on the CPU) side by side, each in a process of its own,
    compared here; ``scored_rows`` at the shapes A's leg 1 and leg 3
    gave it against its plain version; A's leg 3 is the
    ``multi_region`` scenario."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    smi = smi_name_power()
    on_card = torch_device(dev).type == "cuda"
    sizes = dict(FEDERATION_SIZES if sizes is None else sizes)
    root = tempfile.mkdtemp(prefix="nomad-torch-federation-")
    try:
        worlds, beside = side_by_side({
            "A": (["A"], lambda: run_federation_child(dev, root, sizes, "A",
                                                      True)),
            "C": (["C"], lambda: run_federation_child("cpu", root, sizes,
                                                      "C", False))})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    a, c = worlds["A"], worlds["C"]
    errors = (check_federation_world(a, "A", sizes, on_card)
              + check_federation_world(c, "C", sizes, False))
    score_err = 0.0
    for r in FEDERATION_REGIONS:
        ca, cc = a["content"][r], c["content"][r]
        for key in ("placements", "unplaced"):
            if ca[key] != cc[key]:
                diff = [j for j in ca[key] if ca[key][j] != cc[key].get(j)]
                errors.append(f"A != C region {r} {key}: {diff[:5]}")
        for job, rows in ca["scores"].items():
            theirs = dict(map(tuple, cc["scores"].get(job, [])))
            if {k for k, _ in rows} != set(theirs):
                errors.append(f"A != C region {r}: score keys of {job}")
                continue
            for k, v in rows:
                score_err = max(score_err, abs(v - theirs[k]))
    if score_err > 4e-6:
        errors.append(f"A vs C scores differ by {score_err} > 4e-6")
    if a["launches"]["committing_spec_steps"] != \
            c["launches"]["committing_spec_steps"]:
        errors.append(f"A != C committing steps: {a['launches']} "
                      f"{c['launches']}")
    if a["draws"] != c["draws"]:
        errors.append(f"ids drawn: A {a['draws']}, C {c['draws']}")
    shape_parity = {}
    leg3 = a["leg3"]
    if leg3["breaker"] != {"state": "closed", "trips": 0,
                           "oracle_routed": 0}:
        errors.append(f"leg 3: the breaker {leg3['breaker']}")
    if leg3["auditor"]["violation_count"]:
        errors.append(f"leg 3: the federated auditor "
                      f"{leg3['auditor']['violations'][:5]}")
    if not (leg3["blackout"] or {}).get("recovered"):
        errors.append(f"leg 3: the blackout {leg3['blackout']}")
    if leg3["sustained"]["stragglers_after_drain"]:
        errors.append(f"leg 3: stragglers {leg3['sustained']}")
    if on_card:
        errors += check_launches("leg 3", leg3["launches"])
        for leg, shapes in (("leg 1", a["kernel_shapes"]),
                            ("leg 3", leg3["kernel_shapes"])):
            # 0 differing bits against the plain version (raises
            # otherwise).
            try:
                shape_parity[leg] = path_shape_parity(
                    dev, shapes, f"federation {leg}")
            except AssertionError as exc:
                errors.append(str(exc))
    if errors:
        raise AssertionError(f"phase federation: {errors}")

    def world_row(w, label):
        return {"device": w["device"], "node_register_s":
                w["node_register_s"], "waves": w["waves"],
                "submit_ms": w["submit_ms"], "launches": w["launches"],
                "leg2": {k: w["leg2"][k] for k in (
                    "dark_submits", "wire_submit", "unreachable_while_dark",
                    "home_placed", "dark_s", "restart_s", "probe_attempts",
                    "registered_after_heal_s", "placed_after_heal_s")},
                "world_s": w["world_s"], "child_wall_s": w["child_wall_s"],
                "ran_beside": beside[label]}

    return {"card": smi, "sizes": sizes, "reduced": a["reduced"],
            "A_card": world_row(a, "A"), "C_cpu": world_row(c, "C"),
            "a_equals_c": True, "score_max_abs_err": score_err,
            "placed": {r: sum(len(v) for v in a["content"][r][
                "placements"].values()) for r in FEDERATION_REGIONS},
            "cross_region_double_placed": 0,
            "kernel_shapes": a["kernel_shapes"],
            "shape_parity": shape_parity,
            "launches": {"leg1": a["launches"], "leg3": leg3["launches"]},
            "forward_rates": {"A": {**a["rates"], "ran_beside": beside["A"]},
                              "C": {**c["rates"], "ran_beside": beside["C"]}},
            "leg3": {**leg3, "ran_beside": beside["A"]},
            "seconds": time.perf_counter() - t_phase}


# -- phase 28: drills --------------------------------------------------------

def phase_drills(dev):
    """The thirteen drills of ``python -m nomad_tpu_torch.ops --selfcheck
    --device cuda`` in this process (``ops.__main__.run_drills``), each
    of which must return True, with the kernels' counts set to 0 just
    before and read just after: ``scored_rows`` launches against the
    committing steps of every device batch the drills run (one launch a
    step, one a shard on the mesh drill's four shards), and
    ``masked_score_matrix`` launches against the drills' calls of
    ``sharded_candidate_scores``."""
    from nomad_tpu_torch.ops import __main__ as drills
    from nomad_tpu_torch.ops import batch_sched, fused_score, preempt
    from nomad_tpu_torch.parallel import sharded

    smi = smi_name_power()
    batches = []
    candidate_calls = [0]
    real_batch = batch_sched.TorchBatchScheduler.schedule_batch
    real_cand = sharded.sharded_candidate_scores

    def batch_spy(self, evals):
        st = real_batch(self, evals)
        batches.append((st.commit_steps, st.mesh_shards, st.device_ran))
        return st

    def cand_spy(*args, **kw):
        candidate_calls[0] += 1
        return real_cand(*args, **kw)

    lines, verdicts, seconds = [], {}, {}

    def log(msg):
        lines.append(msg)
        print(msg, file=sys.stderr, flush=True)

    batch_sched.TorchBatchScheduler.schedule_batch = batch_spy
    sharded.sharded_candidate_scores = cand_spy
    zero_counts()
    try:
        results = {}
        for name in drills.DRILLS:
            t0 = time.perf_counter()
            results.update(drills.run_drills(seed=0, device=dev, log=log,
                                             verdicts=verdicts,
                                             only=(name,)))
            seconds[name] = time.perf_counter() - t0
            emit({"phase": "drills", "drill": name, "ok": results[name],
                  "seconds": seconds[name]})
    finally:
        batch_sched.TorchBatchScheduler.schedule_batch = real_batch
        sharded.sharded_candidate_scores = real_cand
    launches = kernel_counts()
    steps = sum(n for n, _, _ in batches)
    mesh_steps = sum(n * shards for n, shards, _ in batches if shards)
    failed = [name for name, ok in results.items() if not ok]
    if failed or len(results) != 13:
        raise AssertionError(f"drills failed: {failed}; "
                             f"{[ln for ln in lines if 'FAIL' in ln]}")
    # The single card's batches run the round kernel once a batch; the
    # mesh's launch scored_rows once per committing step and shard (before
    # the round kernel: scored_rows once a step on one card too); the
    # loops' committing steps are the batches', and the single card's lie
    # inside the bounds read from what its batches placed.
    if (launches["scored_rows"] != mesh_steps or mesh_steps <= 0
            or launches["placement_rounds"] != launches["round_calls"]
            or launches["placement_rounds"] <= 0
            or launches["rounds_run"] <= 0
            or launches["committing_spec_steps"] != steps
            or not launches["steps_lo"] <= sum(
                n for n, shards, _ in batches if not shards)
            <= launches["steps_hi"]):
        raise AssertionError(f"launches {launches} against {steps} "
                             f"committing steps, {mesh_steps} on the "
                             f"mesh's shards")
    # sharded_candidate_scores launches the masked kernel once a shard
    # (the mesh drill's four).
    if launches["masked_score_matrix"] != candidate_calls[0] * 4:
        raise AssertionError(f"masked launches {launches} against "
                             f"{candidate_calls[0]} candidate calls")
    return {"drills": results, "seconds": seconds,
            "sanitized_corpus": verdicts.get("sanitized_corpus"),
            "device_batches": len(batches),
            "device_batches_on_the_mesh": sum(
                1 for _, shards, _ in batches if shards),
            "committing_steps": steps,
            "mesh_committing_steps_x_shards": mesh_steps,
            "candidate_calls": candidate_calls[0],
            "launches": launches, "card": smi}


# -- phase 29: times ---------------------------------------------------------

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


# Profiler sessions that recorded fewer device events of the kernel they
# traced than it was launched: (kernel name, the events recorded).
PROFILER_MISSES = []


def kernel_device_ms(fn, name: str, n: int = 100, attempts: int = 3):
    """Median device time of ``n`` runs of the kernel whose name contains
    ``name``, by the profiler's CUPTI trace; None when ``attempts``
    sessions in a row record fewer than ``n`` of its launches (each miss
    is kept in :data:`PROFILER_MISSES`): a partial record is not read."""
    fn()
    for _ in range(attempts):
        evs = [e for e in cuda_kernel_events(profiled(fn, n))
               if name in e.name]
        if len(evs) >= n:
            return statistics.median(e.time_range.elapsed_us()
                                     for e in evs) / 1e3
        PROFILER_MISSES.append((name, len(evs)))
    return None


def profiler_probe() -> int:
    """The device kernel events of one profiled ``torch.zeros`` fill: 0
    when the profiler records no device activity at this point of the
    run."""
    import torch

    return len(cuda_kernel_events(profiled(
        lambda: torch.zeros(1, device="cuda"))))


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
    its plain version's median, and the bound for the same work.
    ``profiler_misses`` lists the sessions that recorded fewer than
    ``n`` of the kernel's launches before one recorded them all (or
    before the row fell back to CUDA events)."""
    misses0 = len(PROFILER_MISSES)
    dev_ms = kernel_device_ms(call, kernel_name, n)
    ms = dev_ms if dev_ms is not None else back_to_back_ms(call)
    bound_ms, bound_by = bound_of(n_bytes, n_ops)
    return {"ms": ms,
            "ms_source": ("profiler device time, median" if dev_ms is not None
                          else "CUDA events, back-to-back launches"),
            "profiler_misses": PROFILER_MISSES[misses0:],
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
    the loop kernel's executions on the card, held against the wrapper's
    launch count for the same run.  Every run goes without the step-bounds
    recorder (:func:`bare_rounds`), which reads each result back."""
    from nomad_tpu_torch.ops import batch_sched, fused_score

    res = {}
    where = {"mesh": mesh} if mesh is not None else {"device": dev}

    def run():
        with bare_rounds():
            res["r"] = batch_sched.schedule_batch(nodes, jobs, rng_seed=SEED,
                                                  **where)

    plain = []
    for _ in range(3):
        run()
        plain.append(res["r"].timings)
    warm_device_s = statistics.median(t["device"] for t in plain)
    zero_counts()
    prof = profiled(run)
    counts = loop_counts()
    # The loop's kernel: scored_rows on a mesh (once a committing step and
    # shard), the round kernel on one card (once a batch).
    kernel = "scored_rows_kernel" if mesh is not None else \
        "placement_rounds_kernel"
    launches = counts["scored_rows_launches" if mesh is not None
                      else "placement_rounds_launches"]
    evs = cuda_kernel_events(prof)
    r = res["r"]
    row = {"batch": "config_b_0", "mesh_shards": r.mesh_shards,
           "rounds": r.rounds,
           "untraced_device_s_cuda_events": [t["device"] for t in plain],
           "untraced_encode_s": [t["encode"] for t in plain],
           "untraced_decode_s": [t["decode"] for t in plain],
           "traced_device_s_cuda_events": r.timings["device"],
           "kernel_launches": launches, **counts}
    if not evs:
        row["device_busy_s"] = "not measured (no device events in trace)"
        return row
    by_name = {}
    for e in evs:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    busy = sum(t for t, _ in by_name.values()) / 1e6
    traced = sum(c for k, (_, c) in by_name.items() if kernel in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    row.update({
        "device_ops": len(evs), "device_busy_s": busy,
        "device_idle_share_traced": 1.0 - busy / r.timings["device"],
        "device_idle_share_untraced": 1.0 - busy / warm_device_s,
        "device_ops_per_spec_step": len(evs)
        / max(1, counts["committing_spec_steps"]),
        "loop_kernel": kernel, "loop_kernel_in_trace": traced,
        "top_device_ops": [{"name": k[:80], "us": t, "count": c}
                           for k, (t, c) in top]})
    if traced != launches:
        raise AssertionError(f"the trace shows {traced} {kernel} runs, "
                             f"the wrapper counted {launches}")
    return row


# The stages of the single card's device pass (``kernels.fused_pass``):
# (stage, module, function), each call wrapped in a profiler range named
# ``stage:<stage>`` by :func:`device_pass_split`.
PASS_STAGES = (
    ("unpack", "xfer", "unpack_device"), ("unpack", "kernels", "dequantize"),
    ("job_counts", "kernels", "scatter_job_counts"),
    ("feasibility_matrix", "kernels", "feasibility_matrix"),
    ("usage", "kernels", "delta_rows"), ("usage", "kernels", "apply_deltas"),
    ("usage", "kernels", "net_tensors"), ("usage", "kernels", "dp_tensors"),
    ("rounds", "kernels", "run_placement_rounds"),
    ("coo_gather", "kernels", "_slots_coo_gather"),
    ("coo_gather", "kernels", "_compact_coo"),
    ("pack", "xfer", "pack_device"))


def device_pass_split(run) -> dict:
    """One ``run()`` (a warm config (b) batch 0 on the single card) under
    a host-and-device trace with each stage of the device pass in a
    profiler range: every device op in time order with its name, stage,
    duration and the idle gap before it; per stage its span on the
    device (the range's device-side annotation), the device time of its
    ops and the idle gaps before them; the idle gaps' sum and the
    largest.  An op's stage is the innermost range whose device span
    holds its start; ``outside`` the ops of no range (the uploads, the
    seed read, the result fetch)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from nomad_tpu_torch.ops import kernels, xfer

    mods = {"kernels": kernels, "xfer": xfer}
    saved = []

    def wrap(stage, fn):
        def staged(*a, **kw):
            with record_function(f"stage:{stage}"):
                return fn(*a, **kw)
        return staged

    with bare_rounds():
        for stage, mod, name in PASS_STAGES:
            real = getattr(mods[mod], name)
            saved.append((mods[mod], name, real))
            setattr(mods[mod], name, wrap(stage, real))
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
        finally:
            for mod, name, real in reversed(saved):
                setattr(mod, name, real)
    dev_evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [e for e in dev_evs if e.name.startswith("stage:")]
    dev_ops = sorted((e for e in dev_evs if not e.name.startswith("stage:")),
                     key=lambda e: e.time_range.start)
    if not dev_ops:
        return {"device_ops": "not measured (no device events in trace)"}

    def stage_of(e):
        t = e.time_range.start
        inside = [r for r in spans
                  if r.time_range.start <= t <= r.time_range.end]
        if not inside:
            return "outside"
        return min(inside, key=lambda r: r.time_range.elapsed_us()
                   ).name[len("stage:"):]

    stages = {}
    for r in spans:
        agg = stages.setdefault(r.name[len("stage:"):], {
            "span_us": 0.0, "device_us": 0.0, "ops": 0,
            "idle_before_us": 0.0})
        agg["span_us"] += r.time_range.elapsed_us()
    ops, gaps, end = [], [], None
    for e in dev_ops:
        st = stage_of(e)
        us = e.time_range.elapsed_us()
        gap = 0.0 if end is None else max(0.0, e.time_range.start - end)
        end = e.time_range.end if end is None else max(end, e.time_range.end)
        ops.append([e.name[:60], st, us, gap])
        agg = stages.setdefault(st, {"span_us": 0.0, "device_us": 0.0,
                                     "ops": 0, "idle_before_us": 0.0})
        agg["device_us"] += us
        agg["ops"] += 1
        agg["idle_before_us"] += gap
        gaps.append((gap, e.name[:60], st))
    span = end - dev_ops[0].time_range.start
    busy = sum(o[2] for o in ops)
    return {"device_ops": len(ops), "span_us": span, "busy_us": busy,
            "idle_gaps_us": sum(g for g, _, _ in gaps),
            "idle_share_of_span": 1.0 - busy / span if span else None,
            "largest_gaps": [{"us": g, "before": n, "stage": st}
                             for g, n, st in sorted(gaps, reverse=True)[:8]],
            "stages": stages, "ops_in_order": ops}


def phase_profile(dev):
    """Where the time of config (b)'s first batch goes, on the single card
    (with its device pass split by stage, :func:`device_pass_split`) and
    on a 4-shard mesh of the card."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops import batch_sched
    from nomad_tpu_torch.parallel import make_node_mesh

    nodes = [strip_node(mock.node()) for _ in range(10_000)]
    jobs = [strip_job(mock.job(), 1000) for _ in range(100)]
    single = profile_batch(dev, nodes, jobs)
    single["device_pass_split"] = device_pass_split(
        lambda: batch_sched.schedule_batch(nodes, jobs, rng_seed=SEED,
                                           device=dev))
    return {"single": single,
            "mesh4": profile_batch(dev, nodes, jobs,
                                   make_node_mesh([dev] * MESH_SHARDS))}


def rounds_table_row(rounds, launches) -> dict:
    """The ``kernels`` line's row of the round kernel: its launches on the
    main path (config (b)'s batches, one a batch), its largest difference
    from the eager loop over phase rounds' batches (0: bit for bit), and
    at config (b) batch 0 its device time per launch (the profiler's
    median), the eager loop's time for the same rounds (host clock, its
    inputs made beforehand) per launch, and the bound per launch (the
    committing steps' bytes over the HBM rate)."""
    b0 = rounds["batches"][0]
    ks = b0.get("kernel_us_per_launch_profiler") or []
    ms = (statistics.median(ks) / 1e3 if ks
          else statistics.median(b0["kernel_ms_cuda_events"]))
    launches0 = b0["kernel_route"]["placement_rounds_launches"]
    return {"name": "placement_rounds", "route": "cuda",
            "source": "nomad_tpu_torch/csrc/placement_rounds.cu",
            "replaces": "nomad_tpu/ops/kernels.py:412",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rounds["batches"]),
            "ms": ms,
            "plain_ms": b0["eager_route"]["rounds_seconds"] * 1e3
            / launches0,
            "bound_ms": b0["bound_ms_per_launch"], "bound_by": "bytes",
            "library_ms": None}


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
    seconds = time.perf_counter() - t0
    # Whether the profiler still records device activity after the phase
    # (phase times' profiler rows depend on it).
    emit({"phase": name, "ok": True, "seconds": seconds,
          "profiler_probe_kernels": profiler_probe()})
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
          "cpu_count": os.cpu_count(),
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
    _, round_launches = run_phase("config_b", phase_config_b, dev)
    rounds = run_phase("rounds", phase_rounds, dev)
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
    mesh = run_phase("mesh", phase_mesh, dev)
    emit({"phase": "mesh", **mesh})
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
    lg = run_phase("loadgen", phase_loadgen, dev)
    emit({"phase": "loadgen", **{k: v for k, v in lg.items()
                                 if k != "baseline"}})
    agt = run_phase("agent", phase_agent, dev)
    emit({"phase": "agent", **agt})
    cli = run_phase("client", phase_client, dev)
    emit({"phase": "client", **cli})
    fed = run_phase("federation", phase_federation, dev)
    emit({"phase": "federation", **fed})
    drl = run_phase("drills", phase_drills, dev)
    emit({"phase": "drills", **drl})
    # scored_rows' launches on its main path since the round kernel: the
    # config_mesh batch on 4 shards of the card (phase mesh, the counts
    # set to 0 just before it).
    table = run_phase("times", phase_times, dev,
                      mesh["mesh"]["scored_rows_launches"], max_err,
                      masked_launches, max(masked_err, cand_err))
    # The round kernel: its launches on config (b)'s three batches (phase
    # config_b), its time, its plain version's and its bound at config
    # (b) batch 0 (phase rounds).
    rrow = rounds_table_row(rounds, round_launches)
    table.append(rrow)
    # ... its launches on the eval-driven path (phase evals, each batch
    # driven with the counts set to 0 just before it).
    rrow["eval_path_launches"] = evals["eval_path_launches"]
    # ... and on the applied path (phase applied, the card with the mirror
    # and guard_every=1: batch 0, the follow-ups and the stream).
    rrow["applied_path_launches"] = applied["applied_path_launches"]
    # ... and on the columnar path (phase columnar, the store with the
    # mirror: its three waves, each driven with the counts set to 0 just
    # before it).
    rrow["columnar_path_launches"] = col["placement_rounds_launches"]
    # ... on the dry-run path (phase plan: the annotate-plan batch) and on
    # the fingerprint path (phase fingerprint: the constrained batch).
    rrow["plan_path_launches"] = plan["placement_rounds_launches"]
    rrow["fingerprint_path_launches"] = fpr["placement_rounds_launches"]
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
        # ... on the load harness's path (phase loadgen part (a), the
        # baseline scenario through the port's server, the counts set to
        # 0 just before the run) and in the breaker drill (part (b)).
        row["loadgen_path_launches"] = lg["launches"]["baseline"][
            row["name"]]
        row["breaker_drill_launches"] = lg["launches"]["breaker_drill"][
            row["name"]]
        # ... and on the front door's path (phase agent, world A: HCL
        # jobs through the CLI and HTTP into the agent's server, the
        # counts set to 0 just before the submissions).
        row["agent_path_launches"] = agt["launches"]["agent"][row["name"]]
        # ... on the client's path (phase client, world A: the wave of
        # 416 allocs the fleet of port clients runs, the counts set to 0
        # just before its submissions).
        row["client_path_launches"] = cli["launches"]["client"][
            row["name"]]
        # ... on the federation's path (phase federation, world A's leg 1:
        # the wave through both regions, the counts set to 0 just before
        # its release).
        row["federation_path_launches"] = fed["launches"]["leg1"][
            row["name"]]
        # ... and on the drills' path (phase drills, the thirteen drills
        # of --selfcheck, the counts set to 0 just before them).
        row["drills_path_launches"] = drl["launches"][row["name"]]
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
