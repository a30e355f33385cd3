"""The native packed-result decode (``native/decode.cc``) against its numpy
twins and against the reference's twins.

``expand_coo`` and ``last_scores`` of ``nomad_tpu_torch/ops/decode.py``
run natively, beside the port's numpy twins (``_expand_twin``,
``_last_scores_twin``); the reference's ``nomad_tpu.ops.decode.
_expand_twin`` and ``_last_scores_twin`` are the contract.  On a corpus
seeded with numpy (more than 200 cases, with the edges: an empty
payload, every row -1, cols equal to ``n_real``, a node committed in
several rounds, one spec) the three agree bit for bit.  A guard mismatch
at cadence 1 raises ``DecodeGuardError`` and is counted; a batch through
``TorchBatchScheduler(device="cpu")`` places and scores alike with
``native_decode`` True and False.
"""
import numpy as np
import pytest

from nomad_tpu.ops import decode as jdecode
from nomad_tpu_torch import mock
from nomad_tpu_torch.ops import decode
from nomad_tpu_torch.ops.batch_sched import TorchBatchScheduler
from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
from nomad_tpu_torch.scheduler.testing import Harness
from nomad_tpu_torch.structs import structs as s


@pytest.fixture(autouse=True)
def fresh_counters():
    decode.reset_counters()
    yield
    decode.reset_counters()


def random_case(rng):
    """A COO payload as the fused pass emits it: rows ascending (padding
    rows -1 first after the sort), some cols past ``n_real``, counts from
    0 up, a node often committed in several rounds."""
    n_specs = int(rng.integers(1, 40))
    n_real = int(rng.integers(1, 500))
    n = int(rng.integers(0, 300))
    rows = np.sort(rng.integers(-1, n_specs, n)).astype(np.int32)
    pool = rng.integers(0, max(1, int(n_real * 1.2)),
                        max(1, int(rng.integers(1, 40))))
    cols = rng.choice(pool, n).astype(np.int32)
    counts = rng.integers(0, 5, n).astype(np.int32)
    scores = (rng.random(n) * 18).astype(np.float32)
    coll = rng.integers(0, 3, n).astype(np.int32)
    return rows, cols, counts, scores, coll, n_specs, n_real


def edge_case(name):
    e = np.array([], dtype=np.int32)
    if name == "empty":
        return e, e, e, e.astype(np.float32), e, 3, 10
    if name == "all_rows_minus_one":
        r = np.full(6, -1, np.int32)
        return (r, np.arange(6, dtype=np.int32), np.ones(6, np.int32),
                np.ones(6, np.float32), np.zeros(6, np.int32), 4, 10)
    if name == "cols_equal_n_real":
        return (np.array([0, 0, 1, 1], np.int32),
                np.array([9, 10, 10, 3], np.int32),
                np.array([1, 2, 1, 1], np.int32),
                np.array([1.5, 2.5, 3.5, 4.5], np.float32),
                np.array([0, 1, 0, 2], np.int32), 2, 10)
    if name == "several_rounds":
        # Node 7 committed in three rounds of spec 0 and twice of spec 2.
        return (np.array([0, 0, 0, 0, 2, 2, 2], np.int32),
                np.array([7, 3, 7, 7, 7, 1, 7], np.int32),
                np.array([1, 2, 1, 3, 1, 1, 2], np.int32),
                np.array([1, 2, 3, 4, 5, 6, 7], np.float32),
                np.array([0, 0, 1, 2, 0, 0, 1], np.int32), 3, 8)
    if name == "one_spec":
        return (np.zeros(5, np.int32), np.array([4, 2, 4, 0, 2], np.int32),
                np.array([2, 1, 1, 1, 3], np.int32),
                np.array([9, 8, 7, 6, 5], np.float32),
                np.array([1, 0, 0, 1, 1], np.int32), 1, 5)
    raise KeyError(name)


def assert_same(case):
    rows, cols, counts, scores, coll, n_specs, n_real = case
    got = decode.expand_coo(rows, cols, counts, n_specs, n_real,
                            guard_every=1)
    twin = decode.expand_coo(rows, cols, counts, n_specs, n_real,
                             native=False)
    ref = jdecode._expand_twin(rows, cols, counts, n_specs, n_real)
    for a, b, c in zip(got, twin, ref):
        assert a.dtype == b.dtype == c.dtype
        assert np.array_equal(a, b) and np.array_equal(a, c)
    got = decode.last_scores(rows, cols, scores, coll, n_specs, n_real,
                             guard_every=1)
    twin = decode.last_scores(rows, cols, scores, coll, n_specs, n_real,
                              native=False)
    ref = jdecode._last_scores_twin(rows, cols, scores, coll, n_specs,
                                    n_real)
    for a, b, c in zip(got, twin, ref):
        assert a.dtype == b.dtype == c.dtype
        # Bit for bit, float scores included.
        assert a.tobytes() == b.tobytes() == c.tobytes()


@pytest.mark.parametrize("name", ["empty", "all_rows_minus_one",
                                  "cols_equal_n_real", "several_rounds",
                                  "one_spec"])
def test_native_decode_equals_both_twins_at_the_edges(name):
    assert_same(edge_case(name))
    assert decode.GUARD_RUNS == 2 and decode.GUARD_MISMATCHES == 0


@pytest.mark.parametrize("chunk", range(8))
def test_native_decode_equals_both_twins_on_a_seeded_corpus(chunk):
    rng = np.random.default_rng(1800 + chunk)
    for _ in range(26):
        assert_same(random_case(rng))
    assert decode.NATIVE_CALLS == 2 * 26 == decode.GUARD_RUNS
    assert decode.GUARD_MISMATCHES == 0


def test_guard_cadence_is_counted_per_function():
    rows, cols, counts, scores, coll, n_specs, n_real = edge_case(
        "several_rounds")
    for _ in range(6):
        decode.expand_coo(rows, cols, counts, n_specs, n_real,
                          guard_every=3)
    for _ in range(3):
        decode.last_scores(rows, cols, scores, coll, n_specs, n_real,
                           guard_every=3)
    assert (decode.EXPAND_CALLS, decode.LAST_CALLS) == (6, 3)
    assert decode.GUARD_RUNS == 3
    decode.expand_coo(rows, cols, counts, n_specs, n_real, guard_every=0)
    assert decode.GUARD_RUNS == 3 and decode.NATIVE_CALLS == 10


@pytest.mark.parametrize("fn", ["expand", "last_scores"])
def test_a_guard_mismatch_raises_and_is_counted(monkeypatch, fn):
    rows, cols, counts, scores, coll, n_specs, n_real = edge_case(
        "several_rounds")
    if fn == "expand":
        real = decode._expand_twin

        def bent(*a):
            off, out = real(*a)
            out = out.copy()
            out[0] += 1
            return off, out

        monkeypatch.setattr(decode, "_expand_twin", bent)
        call = lambda: decode.expand_coo(rows, cols, counts,  # noqa: E731
                                         n_specs, n_real, guard_every=1)
    else:
        real = decode._last_scores_twin

        def bent(*a):
            off, col, sc, co = real(*a)
            return off, col, sc + np.float32(1e-6), co

        monkeypatch.setattr(decode, "_last_scores_twin", bent)
        call = lambda: decode.last_scores(  # noqa: E731
            rows, cols, scores, coll, n_specs, n_real, guard_every=1)
    with pytest.raises(decode.DecodeGuardError, match="diverged"):
        call()
    assert decode.GUARD_MISMATCHES == 1 and decode.GUARD_RUNS == 1
    # Off cadence, the native result is returned as it is.
    decode.reset_counters()
    if fn == "expand":
        decode.expand_coo(rows, cols, counts, n_specs, n_real,
                          guard_every=2)
    else:
        decode.last_scores(rows, cols, scores, coll, n_specs, n_real,
                           guard_every=2)
    assert decode.GUARD_MISMATCHES == 0


def test_a_payload_the_native_pass_refuses_raises():
    rows = np.array([1, 0], np.int32)      # spec rows out of order
    cols = np.array([0, 1], np.int32)
    one = np.ones(2, np.int32)
    with pytest.raises(decode.DecodeGuardError, match="refused"):
        decode.last_scores(rows, cols, one.astype(np.float32), one, 2, 4)
    with pytest.raises(decode.DecodeGuardError, match="refused"):
        decode.expand_coo(np.array([5], np.int32), cols[:1], one[:1], 2, 4)


def _node(i):
    n = mock.node()
    n.id = n.name = f"dec-node-{i:03d}"
    n.resources.networks = []
    n.reserved.networks = []
    n.compute_class()
    return n


def _job(k, count):
    job = mock.job()
    job.id = job.name = f"dec-job-{k}"
    job.task_groups[0].count = count
    for tg in job.task_groups:
        for t in tg.tasks:
            t.resources.networks = []
    return job


def _world(native_decode):
    h = Harness()
    for i in range(40):
        h.state.upsert_node(h.next_index(), _node(i))
    evals = []
    for k in range(12):
        job = _job(k, 3 + 5 * (k % 4))
        h.state.upsert_job(h.next_index(), job)
        evals.append(s.Evaluation(
            id=f"dec-eval-{k}", priority=job.priority, type=job.type,
            triggered_by=s.EVAL_TRIGGER_JOB_REGISTER, job_id=job.id,
            status=s.EVAL_STATUS_PENDING))
    stats = TorchBatchScheduler(
        h.logger, h.snapshot(), h, device="cpu", rng_seed=7,
        breaker=KernelCircuitBreaker(), native_decode=native_decode,
        decode_guard_every=1).schedule_batch(evals)
    allocs = sorted(
        (a.job_id, a.name, a.node_id, tuple(sorted(a.metrics.scores.items())))
        for a in h.state.allocs(None) if not a.terminal_status())
    return stats, allocs


def test_batch_places_alike_with_native_decode_on_and_off():
    on_stats, on = _world(True)
    native_calls = decode.NATIVE_CALLS
    off_stats, off = _world(False)
    assert on_stats.oracle_routed == off_stats.oracle_routed == 0
    assert on_stats.device_ran and off_stats.device_ran
    assert native_calls == 2 and decode.NATIVE_CALLS == 2
    assert decode.TWIN_CALLS == 2 and decode.GUARD_MISMATCHES == 0
    assert len(on) == sum(3 + 5 * (k % 4) for k in range(12))
    assert on == off
    assert all(sc for *_, sc in on)
