"""The round kernel's wrapper and the launch-signature count against the
JAX reference, on the CPU.

``kernels.run_placement_rounds`` is what ``device_schedule`` runs: on a
card the round kernel (``csrc/placement_rounds.cu``, held against the
eager loop bit for bit by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``
phase ``rounds``), on CPU tensors its plain version, the eager
``placement_rounds``.  Here, on seeded inputs (``round_inputs.py``, 8-64
nodes, 2-8 specs), its CPU route equals the eager loop bit for bit and
the reference's ``placement_rounds`` on plain specs, distinct_hosts,
networks with reserved ports, distinct_property, and capacity-exhausted
batches that end by the min-ask exit: integers exact, commit scores
within 4e-6 (two float32 ulp at 18, where the reference's ``10^x``
rounds otherwise; ROADMAP queue 3 item 2).

``note_signature`` counts as the reference's does for the same sequence
of calls.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.ops import kernels as jk
from nomad_tpu_torch.ops import fused_score
from nomad_tpu_torch.ops import kernels as tk
from round_inputs import port_rounds_args, random_rounds

SCORE_ATOL = 4e-6
OUTPUTS = ("placements", "unplaced", "used_after", "commit_scores",
           "commit_collisions", "slots", "slot_scores", "slot_coll")


def reference_rounds(x, seed, *, max_rounds, with_scores, slot_m):
    """The reference's placement_rounds on the arrays of random_rounds
    (port words as the uint32 words they are there)."""
    args = [jnp.asarray(x[k]) for k in ("feas", "used", "cap", "denom",
                                        "ask", "count", "penalty", "dh",
                                        "ji", "jc")]
    net = dp = None
    if "net_active" in x:
        net = jk.NetTensors(
            active=jnp.asarray(x["net_active"]),
            mbits=jnp.asarray(x["net_mbits"]),
            dyn_need=jnp.asarray(x["dyn_need"]),
            resv_words=jnp.asarray(x["resv_words"].view(np.uint32)),
            bw_cap=jnp.asarray(x["bw_cap"]), bw_used=jnp.asarray(x["bw_used"]),
            dyn_free=jnp.asarray(x["dyn_free"]),
            port_words=jnp.asarray(x["port_words"].view(np.uint32)))
    if "dp_col" in x:
        dp = jk.DPTensors(col=jnp.asarray(x["dp_col"]),
                          active=jnp.asarray(x["dp_active"]),
                          used0=jnp.asarray(x["dp_used"]),
                          attr_values=jnp.asarray(x["attr"]))
    return jk.placement_rounds(*args, jax.random.PRNGKey(seed),
                               max_rounds=max_rounds, net=net, dp=dp,
                               with_scores=with_scores, slot_m=slot_m)


# (name, seed, nodes, specs, random_rounds options)
CASES = [
    ("plain", 1, 48, 6, {}),
    ("plain_small", 2, 8, 2, {}),
    ("distinct_hosts", 3, 64, 8, {}),
    ("networks", 4, 40, 5, {"net": True}),
    ("distinct_property", 5, 64, 7, {"dp": True}),
    ("networks_dp", 6, 56, 8, {"net": True, "dp": True}),
    ("exhausted", 7, 32, 8, {"tight": True}),
    ("exhausted_networks_dp", 8, 24, 6, {"net": True, "dp": True,
                                         "tight": True}),
]


@pytest.mark.parametrize("slot_m", [0, 9])
@pytest.mark.parametrize("with_scores", [True, False])
@pytest.mark.parametrize("name,seed,n,u,opts", CASES,
                         ids=[c[0] for c in CASES])
def test_round_wrapper_matches_eager_and_reference(name, seed, n, u, opts,
                                                   with_scores, slot_m):
    x = random_rounds(seed, u, n, **opts)
    if name == "distinct_hosts":
        x["dh"][:] = True
    if name == "exhausted":
        # Every node feasible and more asks than the cluster holds: the
        # rounds fill the nodes until none fits the smallest ask left.
        x["feas"][:] = True
        x["dh"][:] = False
        x["count"][:] = 4 * n
        x["ask"][:] = x["ask"][0]
    kw = dict(max_rounds=256, with_scores=with_scores, slot_m=slot_m)
    args, extra = port_rounds_args(x)
    jseed = tk.jitter_seed(seed)
    launches = fused_score.ROUND_LAUNCHES
    got = tk.run_placement_rounds(*args, jseed, **kw, **extra)
    assert fused_score.ROUND_LAUNCHES == launches   # the CPU route
    eager = tk.placement_rounds(*args, jseed, **kw, **extra)
    want = reference_rounds(x, seed, **kw)
    assert (got.rounds, got.commit_steps) == (eager.rounds,
                                              eager.commit_steps)
    assert got.rounds == int(want.rounds)
    for f in OUTPUTS:
        a, b = getattr(got, f), getattr(eager, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
        ref = np.asarray(getattr(want, f))
        assert a.shape == ref.shape, f
        if f in ("commit_scores", "slot_scores"):
            assert np.abs(a.numpy() - ref).max() <= SCORE_ATOL, f
        else:
            np.testing.assert_array_equal(a.numpy(), ref, f)
    assert got.commit_steps > 0
    if name == "exhausted":
        # Asks left and no node fits the smallest: the min-ask exit, not
        # a round without progress, ended the loop.
        left = got.unplaced.numpy() > 0
        assert left.any()
        min_ask = np.where(left[:, None], x["ask"], 2**30).min(0)
        free = x["cap"] - got.used_after.numpy()
        assert not (min_ask[None, :] <= free).all(1).any()


def test_round_wrapper_stops_at_max_rounds():
    x = random_rounds(9, 6, 16)
    x["count"][:] = 40                 # more than one round needs
    args, extra = port_rounds_args(x)
    got = tk.run_placement_rounds(*args, tk.jitter_seed(9), max_rounds=2,
                                  slot_m=64, **extra)
    want = reference_rounds(x, 9, max_rounds=2, with_scores=True, slot_m=64)
    assert got.rounds == int(want.rounds) == 2
    np.testing.assert_array_equal(got.unplaced.numpy(),
                                  np.asarray(want.unplaced))
    np.testing.assert_array_equal(got.slots.numpy(), np.asarray(want.slots))


def test_round_kernel_refuses_cpu_tensors():
    """The kernel itself has no CPU route: its wrapper raises on CPU
    tensors (the loop picks the plain version before it is reached)."""
    with pytest.raises(ValueError, match="unsupported device"):
        fused_score.placement_round(
            {"feas": torch.zeros((2, 8), dtype=torch.uint8)}, 1, 256)


CALLS = [("device_pass", (1, 2)), ("device_pass", (1, 2)),
         ("fused_pass", (1, 2)), ("device_pass", (3,)),
         ("resident_install", ((8, 4), 0)), ("fused_pass", (1, 2)),
         ("resident_delta", ((8, 4), 16))]


def test_note_signature_counts_as_the_reference():
    jk.reset_compile_signatures()
    tk.reset_compile_signatures()
    try:
        for kind, sig in CALLS:
            assert tk.note_signature(kind, sig) == jk.note_signature(kind,
                                                                     sig)
            assert tk.compile_signatures() == jk.compile_signatures()
        assert tk.compile_signatures() == 5
        assert tk.signature_kinds() == jk.signature_kinds()
    finally:
        jk.reset_compile_signatures()
        tk.reset_compile_signatures()
    assert tk.compile_signatures() == 0 and tk.signature_kinds() == {}


def test_batch_compiles_gauge_counts_launch_signatures():
    """The batch scheduler publishes the count as the ``batch.compiles``
    gauge (batch_sched.py:451); a batch records its pass and score
    signatures, and a batch of the same shapes records no new pass."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops.batch_sched import TorchBatchScheduler
    from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.structs import structs as s
    from nomad_tpu_torch.utils.telemetry import Telemetry

    tk.reset_compile_signatures()
    h = Harness()
    for _ in range(20):
        node = mock.node()
        node.resources.networks = []
        node.reserved.networks = []
        node.compute_class()
        h.state.upsert_node(h.next_index(), node)
    metrics = Telemetry()

    def batch(k):
        j = mock.job()
        j.task_groups[0].count = 6
        for t in j.task_groups[0].tasks:
            t.resources.networks = []
        h.state.upsert_job(h.next_index(), j)
        ev = s.Evaluation(id=f"ev-{k}", priority=j.priority, type=j.type,
                          job_id=j.id, status=s.EVAL_STATUS_PENDING,
                          triggered_by=s.EVAL_TRIGGER_JOB_REGISTER)
        st = TorchBatchScheduler(
            h.logger, h.snapshot(), h, device="cpu", rng_seed=k,
            breaker=KernelCircuitBreaker(), metrics=metrics
        ).schedule_batch([ev])
        assert st.device_ran
        gauges = metrics.sink.latest()["Gauges"]
        assert gauges["nomad.batch.compiles"] == tk.compile_signatures()
        return tk.signature_kinds()

    try:
        first = batch(0)
        assert {"fused_pass", "scored_rows"} <= set(first)
        assert batch(1)["fused_pass"] == first["fused_pass"]
    finally:
        tk.reset_compile_signatures()
