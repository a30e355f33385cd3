"""The port's resident usage mirror (``nomad_tpu_torch/ops/resident.py``)
against the JAX reference's (``nomad_tpu/ops/resident.py``).

The scenarios of ``tests/test_resident.py`` (all but the pipelined
``BatchWorker``, which needs the server), each run in both packages on
one world: the same node ids, job ids, tie-break seed and id sequence.
``TPUBatchScheduler`` runs with ``NOMAD_TPU_RESIDENT=1`` and
``NOMAD_TPU_RESIDENT_GUARD_EVERY=1``; ``TorchBatchScheduler(device="cpu")``
with ``guard_every=1`` in their place.  Each scenario's observations --
the module counters, the placements and the host mirror matrix -- must
be equal in both packages.  Every scheduler has a breaker of its own and
routes nothing to its oracle.

Then the twin sequence: seeded batches whose plans go through each
package's plan applier (the reference's over its FSM, the port's
``PlanApplier``), with an over-commit between a batch's snapshot and its
submit; plans, stores and host mirrors must be equal.
"""
import dataclasses
import logging
import random

import jax  # noqa: F401  (the reference computes on the CPU backend)
import numpy as np
import pytest
import torch

from nomad_tpu import fault as jfault
from nomad_tpu import mock as jmock
from nomad_tpu.ops import resident as jresident
from nomad_tpu.ops.batch_sched import TPUBatchScheduler
from nomad_tpu.ops.breaker import KernelCircuitBreaker as JBreaker
from nomad_tpu.scheduler import Harness as JHarness
from nomad_tpu.scheduler import context as jcontext
from nomad_tpu.server.plan_apply import PlanApplier as JApplier
from nomad_tpu.server.plan_queue import PlanQueue
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert, fault
from nomad_tpu_torch.ops import resident
from nomad_tpu_torch.ops.batch_sched import TorchBatchScheduler
from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
from nomad_tpu_torch.scheduler import context as pcontext
from nomad_tpu_torch.scheduler.testing import Harness
from nomad_tpu_torch.server import PlanApplier
from nomad_tpu_torch.structs import structs as ps

from test_torch_plan_apply import IndexRaft
from test_torch_sched import Ids, Twin, assert_same_world

SEED = 424242
COUNTERS = ("HITS", "FULL_REENCODES", "STALENESS_FALLBACKS", "GUARD_RUNS",
            "GUARD_MISMATCHES", "DEV_APPLIES", "DEV_INSTALLS",
            "DEV_GUARD_MISMATCHES")


@pytest.fixture(autouse=True)
def fresh_resident(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_RESIDENT", "1")
    monkeypatch.setenv("NOMAD_TPU_RESIDENT_GUARD_EVERY", "1")
    monkeypatch.setenv("NOMAD_TPU_RNG_SEED", str(SEED))
    monkeypatch.setenv("NOMAD_TPU_COLUMNAR", "0")
    jresident.reset_counters()
    resident.reset_counters()
    yield
    jresident.reset_counters()
    resident.reset_counters()


def conv(obj, fn):
    return fn(dataclasses.asdict(obj))


class Pkg:
    """One package's side of a scenario: its structs, resident module,
    fault module, breaker, harness and scheduler, fed reference-built
    nodes and jobs (converted for the port)."""

    def __init__(self, name, monkeypatch, seed=7):
        self.name = name
        self.port = name == "port"
        self.s = ps if self.port else js
        self.res = resident if self.port else jresident
        self.fault = fault if self.port else jfault
        self.Breaker = KernelCircuitBreaker if self.port else JBreaker
        self.mp = monkeypatch
        self.ids = Ids(seed)
        self.mp.setattr(self.s, "generate_uuid", self.ids.one)
        self.mp.setattr(self.s, "generate_uuids", self.ids.many)
        self.rng = random.Random(seed)
        self.n_jobs = 0
        self.breaker = self.Breaker()

    def harness(self):
        return Harness() if self.port else JHarness()

    def node(self, i):
        n = jmock.node()
        n.id = n.name = f"node-{i:03d}"
        n.resources.networks = []
        n.reserved.networks = []
        n.compute_class()
        return conv(n, convert.node_from_dict) if self.port else n

    def job(self, count, prio=50):
        j = jmock.job()
        j.id = j.name = f"job-{self.n_jobs:03d}"
        self.n_jobs += 1
        j.priority = prio
        j.task_groups[0].count = count
        for tg in j.task_groups:
            for t in tg.tasks:
                t.resources.networks = []
        return conv(j, convert.job_from_dict) if self.port else j

    def eval_for(self, job):
        return self.s.Evaluation(
            id=f"ev-{job.id}-{self.rng.getrandbits(32):08x}",
            priority=job.priority, type=job.type,
            triggered_by=self.s.EVAL_TRIGGER_JOB_REGISTER, job_id=job.id,
            status=self.s.EVAL_STATUS_PENDING)

    def scheduler(self, h, snap, breaker=None, resident_device=True):
        breaker = breaker if breaker is not None else self.breaker
        if self.port:
            return TorchBatchScheduler(
                h.logger, snap, h, device="cpu", rng_seed=SEED,
                breaker=breaker, guard_every=1,
                resident_device=resident_device)
        self.mp.setenv("NOMAD_TPU_RESIDENT_DEVICE",
                       "1" if resident_device else "0")
        return TPUBatchScheduler(h.logger, snap, h, breaker=breaker)

    def schedule(self, h, jobs, register=True, **kw):
        if register:
            for j in jobs:
                h.state.upsert_job(h.next_index(), j)
        stats = self.scheduler(h, h.snapshot(), **kw).schedule_batch(
            [self.eval_for(j) for j in jobs])
        assert stats.oracle_routed == 0
        return stats

    def counters(self):
        return {c: getattr(self.res, c) for c in COUNTERS}

    def mirror(self):
        st = self.res._STATE
        return None if st is None else st.used.copy()

    def placements(self, h):
        return sorted((a.job_id, a.node_id) for a in h.state.allocs(None)
                      if not a.terminal_status())

    def dev_mirror(self):
        """The device twin read back, None when absent."""
        st = self.res._STATE
        if st is None or st.used_dev is None:
            return None
        if self.port:
            return resident.device_used_host(st.used_dev)
        return np.asarray(st.used_dev).astype(np.int64)

    def reset(self):
        self.res.reset_counters()


def both(monkeypatch, scenario, **kw):
    """``scenario(pkg, **kw)`` in the reference, then in the port; their
    observations must be equal.  Returns the port's."""
    out = {}
    for name in ("reference", "port"):
        with monkeypatch.context() as m:
            p = Pkg(name, m)
            out[name] = scenario(p, **kw)
            out[name]["counters"] = p.counters()
    want, got = out["reference"], out["port"]
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray) or isinstance(got[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k
    return got


# -- the delta feed --------------------------------------------------------

def feed_scenario(p):
    h = p.harness()
    st = h.state
    s = p.s
    node = p.node(0)
    st.upsert_node(1, node)
    job = p.job(1)
    st.upsert_job(2, job)
    a = s.Allocation(id="a-1", job_id=job.id, job=job, node_id=node.id,
                     task_group="web",
                     resources=s.Resources(cpu=100, memory_mb=200))
    st.upsert_allocs(3, [a])
    obs = {"after_upsert": st.allocs_since(2), "empty": st.allocs_since(3)}
    done = s._fast_copy(a)
    done.client_status = s.ALLOC_CLIENT_STATUS_COMPLETE
    st.update_allocs_from_client(4, [done])
    obs["after_complete"] = st.allocs_since(3)
    proto = s.Allocation(job_id=job.id, job=job, task_group="web",
                         resources=s.Resources(cpu=10, memory_mb=20))
    slab = s.AllocSlab(proto=proto, ids=["s-1", "s-2", "s-3"],
                       names=["a", "b", "c"],
                       node_ids=[node.id, node.id, node.id])
    st.upsert_slabs(5, [slab])
    obs["after_slab"] = st.allocs_since(4)
    # Indexing the slab later logs nothing more.
    st.allocs_by_node(None, node.id)
    obs["after_read"] = st.allocs_since(4)
    st._alloc_log_floor = 10
    obs["below_floor"] = st.allocs_since(4)
    return obs


def test_upsert_update_evict_and_slab_deltas(monkeypatch):
    got = both(monkeypatch, feed_scenario)
    assert got["after_upsert"] == [("node-000", (100, 200, 0, 0))]
    assert got["empty"] == []
    assert got["after_complete"] == [("node-000", (-100, -200, 0, 0))]
    assert got["after_slab"] == got["after_read"] == \
        [("node-000", (30, 60, 0, 0))]
    assert got["below_floor"] is None


def snapshot_feed_scenario(p):
    h = p.harness()
    st = h.state
    s = p.s
    node = p.node(0)
    st.upsert_node(1, node)
    snap = st.snapshot()

    def alloc(aid, v):
        return s.Allocation(id=aid, job_id="j", node_id=node.id,
                            task_group="web",
                            resources=s.Resources(cpu=v, memory_mb=v))
    a = alloc("a", 5)
    st.upsert_allocs(2, [a])
    obs = {"parent": st.allocs_since(1), "snap": snap.allocs_since(1)}
    # A snapshot write copies its log prefix first: nothing leaks up.
    snap.upsert_allocs(3, [alloc("b", 7)])
    obs["snap_after_write"] = snap.allocs_since(1)
    obs["parent_after_snap_write"] = st.allocs_since(2)
    # A parent trim replaces the list: an older snapshot's view stays.
    snap2 = st.snapshot()
    st._alloc_log_weight = 10 ** 9
    st.upsert_allocs(4, [s._fast_copy(a)])
    st.upsert_allocs(5, [alloc("c", 9)])
    obs["snap2"] = snap2.allocs_since(1)
    obs["parent_floor"] = st._alloc_log_floor
    return obs


def test_snapshot_has_independent_feed(monkeypatch):
    got = both(monkeypatch, snapshot_feed_scenario)
    assert got["parent"] and got["snap"] == []
    assert got["snap_after_write"] == [("node-000", (7, 7, 0, 0))]
    assert got["parent_after_snap_write"] == []
    assert got["snap2"] == [("node-000", (5, 5, 0, 0))]


def test_log_cap_is_a_constructor_argument():
    st = __import__("nomad_tpu_torch.state", fromlist=["StateStore"]
                    ).StateStore(alloc_log_cap=4)
    assert st.alloc_log_cap == 4 and st.snapshot().alloc_log_cap == 4
    for i in range(6):
        st.upsert_allocs(i + 1, [ps.Allocation(
            id=f"a{i}", job_id="j", node_id="n", task_group="web",
            resources=ps.Resources(cpu=1))])
    assert st.allocs_since(0) is None
    assert st.allocs_since(st._alloc_log_floor) is not None


@pytest.mark.parametrize("shards", (1, 4))
def test_route_shard_deltas_matches_reference(shards):
    from nomad_tpu.ops import encode as jencode
    from nomad_tpu_torch.ops import encode

    rng = np.random.default_rng(shards)
    n_l = 100
    dev_rows = [(int(r), tuple(int(x) for x in v)) for r, v in zip(
        rng.integers(0, shards * n_l, 300), rng.integers(-9, 9, (300, 4)))]
    want = jencode.route_shard_deltas(dev_rows, shards, n_l)
    got = encode.route_shard_deltas(dev_rows, shards, n_l)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


# -- the mirror --------------------------------------------------------------

def randomized_scenario(p, rounds=12):
    rng = random.Random(7)
    h = p.harness()
    for i in range(24):
        h.state.upsert_node(h.next_index(), p.node(i))
    n_nodes = 24
    placed = []
    s = p.s
    for _ in range(rounds):
        op = rng.randrange(5)
        if op == 0 and placed:
            job = rng.choice(placed)
            victims = sorted((a for a in h.state.allocs_by_job(
                None, job.id, True) if not a.terminal_status()),
                key=lambda a: a.id)[:2]
            updates = []
            for v in victims:
                e = s._fast_copy(v)
                e.desired_status = s.ALLOC_DESIRED_STATUS_EVICT
                updates.append(e)
            if updates:
                h.state.upsert_allocs(h.next_index(), updates)
        elif op == 1 and placed:
            job = rng.choice(placed)
            live = sorted((a for a in h.state.allocs_by_job(
                None, job.id, True) if not a.terminal_status()),
                key=lambda a: a.id)[:3]
            updates = []
            for a in live:
                u = s._fast_copy(a)
                u.client_status = s.ALLOC_CLIENT_STATUS_COMPLETE
                updates.append(u)
            if updates:
                h.state.update_allocs_from_client(h.next_index(), updates)
        elif op == 2:
            h.state.upsert_node(h.next_index(), p.node(n_nodes))
            n_nodes += 1
        elif op == 3:
            node = h.state.node_by_id(None, f"node-{rng.randrange(24):03d}")
            h.state.update_node_drain(h.next_index(), node.id,
                                      not node.drain)
        jobs = [p.job(rng.randrange(1, 4)) for _ in range(2)]
        stats = p.schedule(h, jobs)
        assert stats.num_evals == 2
        placed.extend(jobs)
    return {"placements": p.placements(h), "mirror": p.mirror()}


def test_randomized_sequence_bit_identical(monkeypatch):
    got = both(monkeypatch, randomized_scenario)
    c = got["counters"]
    assert c["GUARD_MISMATCHES"] == 0 and c["GUARD_RUNS"] > 0
    assert c["HITS"] > 0 and c["FULL_REENCODES"] > 1


def fence_scenario(p):
    h = p.harness()
    for i in range(8):
        h.state.upsert_node(h.next_index(), p.node(i))
    p.schedule(h, [p.job(2)])
    p.schedule(h, [p.job(2)])
    job = p.job(1)
    h.state.upsert_job(h.next_index(), job)
    stale = h.snapshot()
    p.schedule(h, [p.job(2)])
    p.schedule(h, [p.job(2)])
    cached = p.res._STATE.alloc_index
    stats = p.scheduler(h, stale).schedule_batch([p.eval_for(job)])
    return {"fences": stats.staleness_fences,
            "full": stats.full_reencodes, "hits": stats.resident_hits,
            "kept": p.res._STATE.alloc_index == cached,
            "placed": len(h.state.allocs_by_job(None, job.id, True)),
            "placements": p.placements(h), "mirror": p.mirror()}


def test_staleness_fence_serves_old_snapshot_without_regressing(
        monkeypatch):
    got = both(monkeypatch, fence_scenario)
    assert (got["fences"], got["full"], got["hits"]) == (1, 1, 0)
    assert got["kept"] and got["placed"] == 1


def feed_gap_scenario(p, caplog=None):
    h = p.harness()
    for i in range(8):
        h.state.upsert_node(h.next_index(), p.node(i))
    p.schedule(h, [p.job(2)])
    h.state._alloc_log_floor = p.res._STATE.alloc_index + 10
    h.state._alloc_log.clear()
    stats = p.schedule(h, [p.job(2)])
    return {"full": stats.full_reencodes, "hits": stats.resident_hits,
            "placements": p.placements(h), "mirror": p.mirror()}


def test_feed_gap_forces_full_reencode(monkeypatch, caplog):
    with caplog.at_level(logging.WARNING,
                         logger="nomad_tpu_torch.ops.resident"):
        got = both(monkeypatch, feed_gap_scenario)
    assert got["full"] == 1 and got["hits"] == 0
    # The reference's NodeStateDelta event, logged by the port.
    assert any("NodeStateDelta feed_gap" in r.getMessage()
               for r in caplog.records)


def corruption_scenario(p, warm=1):
    brk = p.Breaker(threshold=0.9, window=8, min_checks=1, cooldown=3600.0)
    h = p.harness()
    for i in range(8):
        h.state.upsert_node(h.next_index(), p.node(i))
    for _ in range(warm):
        p.schedule(h, [p.job(2)], breaker=brk)
    applies = p.res.DEV_APPLIES
    with p.fault.scenario({"seed": 3, "faults": [
            {"point": "ops.resident_state", "action": "corrupt",
             "times": 1}]}):
        job = p.job(2)
        stats = p.schedule(h, [job], breaker=brk)
    st = p.res._STATE
    return {"full": stats.full_reencodes, "breaker": brk.state,
            "applies_before": applies,
            "dropped": st is None or (st.hits == 0 and st.used_dev is None),
            "placed": len([a for a in h.state.allocs_by_job(
                None, job.id, True) if not a.terminal_status()]),
            "placements": p.placements(h)}


@pytest.mark.parametrize("warm", (1, 2))
def test_injected_corruption_trips_breaker(monkeypatch, warm):
    """One warm batch: the corruption lands on the host mirror; two: on
    the device twin as well (after an in-place delta apply)."""
    got = both(monkeypatch, corruption_scenario, warm=warm)
    assert got["counters"]["GUARD_MISMATCHES"] == 1
    assert got["full"] == 1 and got["breaker"] == "open"
    assert got["dropped"] and got["placed"] == 2
    if warm == 2:
        assert got["applies_before"] >= 1


def residency_off_scenario(p):
    h = p.harness()
    for i in range(8):
        h.state.upsert_node(h.next_index(), p.node(i))
    if p.port:
        sched = lambda snap: TorchBatchScheduler(  # noqa: E731
            h.logger, snap, h, device="cpu", rng_seed=SEED,
            breaker=p.breaker, resident=False)
    else:
        p.mp.setenv("NOMAD_TPU_RESIDENT", "0")
        sched = lambda snap: TPUBatchScheduler(  # noqa: E731
            h.logger, snap, h, breaker=p.breaker)
    out = []
    for _ in range(2):
        job = p.job(2)
        h.state.upsert_job(h.next_index(), job)
        st = sched(h.snapshot()).schedule_batch([p.eval_for(job)])
        out.append((st.resident_hits, st.delta_rows))
    return {"stats": out, "placements": p.placements(h)}


def test_residency_off_disables_delta_path(monkeypatch):
    got = both(monkeypatch, residency_off_scenario)
    assert got["stats"] == [(0, 0), (0, 0)]
    assert got["counters"]["HITS"] == 0


def stream_scenario(p, stream=True):
    h = p.harness()
    for i in range(16):
        h.state.upsert_node(h.next_index(), p.node(i))
    batches, jobs = [], []
    for _ in range(5):
        bj = [p.job(2) for _ in range(2)]
        for j in bj:
            h.state.upsert_job(h.next_index(), j)
        jobs.extend(bj)
        batches.append([p.eval_for(j) for j in bj])
    sched = p.scheduler(h, h.snapshot())
    if stream:
        stats = sched.schedule_stream(batches, state_source=h.snapshot)
    else:
        stats = []
        for evals in batches:
            sched.state = h.snapshot()
            stats.append(sched.schedule_batch(evals))
    assert all(st.oracle_routed == 0 for st in stats)
    return {"n": len(stats),
            "hits": sum(st.resident_hits for st in stats),
            "per_job": [len([a for a in h.state.allocs_by_job(
                None, j.id, True) if not a.terminal_status()])
                for j in jobs],
            "placements": p.placements(h), "mirror": p.mirror()}


def test_stream_matches_serial_placements(monkeypatch):
    got = both(monkeypatch, stream_scenario)
    assert got["n"] == 5 and got["per_job"] == [2] * 10
    assert got["counters"]["GUARD_MISMATCHES"] == 0 and got["hits"] >= 4
    # The port's stream places what its serial batches place.
    resident.reset_counters()
    with monkeypatch.context() as m:
        serial = stream_scenario(Pkg("port", m), stream=False)
    assert serial["placements"] == got["placements"]
    np.testing.assert_array_equal(serial["mirror"], got["mirror"])


def test_stream_completes_the_batch_in_flight_on_error(monkeypatch):
    """A later batch's failure completes the dispatched batch (its plans
    are submitted) before the error propagates."""
    p = Pkg("port", monkeypatch)
    h = p.harness()
    for i in range(8):
        h.state.upsert_node(h.next_index(), p.node(i))
    first = p.job(2)
    h.state.upsert_job(h.next_index(), first)
    sched = p.scheduler(h, h.snapshot())
    real = sched._prepare_batch

    def prepare(evals):
        if evals == ["boom"]:
            raise RuntimeError("prepare failed")
        return real(evals)

    monkeypatch.setattr(sched, "_prepare_batch", prepare)
    with pytest.raises(RuntimeError, match="prepare failed"):
        sched.schedule_stream([[p.eval_for(first)], ["boom"]],
                              state_source=h.snapshot)
    assert len(h.state.allocs_by_job(None, first.id, True)) == 2


def device_mirror_scenario(p, resident_device=True):
    h = p.harness()
    for i in range(8):
        h.state.upsert_node(h.next_index(), p.node(i))
    placements = []
    for _ in range(5):
        job = p.job(2)
        p.schedule(h, [job], resident_device=resident_device)
        placements.append(sorted(a.node_id for a in h.state.allocs_by_job(
            None, job.id, True)))
    return {"placements": placements, "mirror": p.mirror(),
            "dev": p.dev_mirror()}


def test_donated_applies_bit_identical_to_delta_path(monkeypatch):
    dev = both(monkeypatch, device_mirror_scenario)
    assert dev["counters"]["DEV_INSTALLS"] == 1
    assert dev["counters"]["DEV_APPLIES"] >= 4
    np.testing.assert_array_equal(dev["dev"], dev["mirror"])
    jresident.reset_counters()
    resident.reset_counters()
    off = both(monkeypatch, device_mirror_scenario, resident_device=False)
    assert off["counters"]["DEV_INSTALLS"] == 0
    assert off["counters"]["DEV_APPLIES"] == 0 and off["dev"] is None
    assert off["placements"] == dev["placements"]
    np.testing.assert_array_equal(off["mirror"], dev["mirror"])


def test_take_give_loan_protocol(monkeypatch):
    p = Pkg("port", monkeypatch)
    h = p.harness()
    for i in range(8):
        h.state.upsert_node(h.next_index(), p.node(i))
    for _ in range(2):
        p.schedule(h, [p.job(2)])
    st = resident._STATE
    assert st is not None and st.used_dev is not None
    key, idx = st.key, st.alloc_index
    # A stale taker gets nothing and does not take the twin.
    assert resident.take_device_used(key, idx - 1, st.used,
                                     device="cpu") is None
    assert st.used_dev is not None
    dev = resident.take_device_used(key, idx, st.used, device="cpu")
    assert dev is not None and st.used_dev is None
    # Handed back under a moved-on index: dropped.
    resident.give_device_used(key, idx - 1, dev)
    assert st.used_dev is None
    resident.give_device_used(key, idx, dev)
    assert st.used_dev is dev
    # A taker on another placement gets a fresh install.
    installs = resident.DEV_INSTALLS
    from nomad_tpu_torch.parallel import make_node_mesh

    parts = resident.take_device_used(key, idx, st.used,
                                      mesh=make_node_mesh(["cpu"] * 2))
    assert isinstance(parts, list) and len(parts) == 2
    assert resident.DEV_INSTALLS == installs + 1
    np.testing.assert_array_equal(resident.device_used_host(parts),
                                  st.used)


def test_device_mirror_drift_guard(monkeypatch):
    """Drift in the device twin alone is caught by the device-vs-host
    compare: the breaker is fed, the twin dropped, the host mirror
    kept."""
    out = {}
    for name in ("reference", "port"):
        with monkeypatch.context() as m:
            p = Pkg(name, m)
            brk = p.Breaker(threshold=0.9, window=8, min_checks=1,
                            cooldown=3600.0)
            h = p.harness()
            for i in range(8):
                h.state.upsert_node(h.next_index(), p.node(i))
            p.schedule(h, [p.job(2)], breaker=brk)
            p.schedule(h, [p.job(2)], breaker=brk)
            st = p.res._STATE
            if p.port:
                st.used_dev = st.used_dev + 7
            else:
                import jax.numpy as jnp
                st.used_dev = jnp.asarray(np.asarray(st.used_dev)
                                          + np.int32(7))
            p.schedule(h, [p.job(2)], breaker=brk)
            # The twin was dropped; the batch's loan may have installed
            # a fresh one, which then equals the host mirror.
            dev = p.dev_mirror()
            out[name] = (p.res.DEV_GUARD_MISMATCHES, brk.agreement() < 1.0,
                         dev is None or np.array_equal(dev, p.mirror()),
                         p.placements(h), p.mirror().tolist())
            p.reset()
    assert out["port"] == out["reference"]
    assert out["port"][:3] == (1, True, True)


def test_quantized_codebook_corruption_feeds_the_breaker(monkeypatch):
    """A codebook that does not round-trip: counted, breaker fed, the
    batch ships exact int32 rows and places what a clean batch places."""
    from nomad_tpu_torch.ops import batch_sched, encode

    def run(corrupt):
        resident.reset_counters()
        batch_sched._CLUSTER_CACHE.clear()
        with monkeypatch.context() as m:
            if corrupt:
                real = encode.quantize_resource_rows

                def bad(cap, used):
                    q = real(cap, used)
                    if q is not None:
                        q.scale[0] = q.scale[0] * 2
                    return q
                m.setattr(encode, "quantize_resource_rows", bad)
            p = Pkg("port", m)
            brk = p.Breaker(threshold=0.9, window=8, min_checks=1,
                            cooldown=3600.0)
            h = p.harness()
            for i in range(8):
                h.state.upsert_node(h.next_index(), p.node(i))
            stats = p.schedule(h, [p.job(3)], breaker=brk)
            return (p.placements(h), resident.QUANT_CHECKS,
                    resident.QUANT_MISMATCHES, brk.agreement(),
                    stats.h2d_bytes)

    clean, bad = run(False), run(True)
    assert clean[1] == 2 and clean[2] == 0
    assert bad[1] == 1 and bad[2] == 1 and bad[3] < 1.0
    assert bad[0] == clean[0]
    assert bad[4] > clean[4]        # int32 rows instead of quantized ones


def test_mesh_mirror_matches_single_device(monkeypatch):
    """The sharded twin on a 4-shard CPU mesh: the same placements and
    mirror as one device, every shard part equal to its host rows."""
    from nomad_tpu_torch.parallel import make_node_mesh

    def run(mesh):
        resident.reset_counters()
        with monkeypatch.context() as m:
            p = Pkg("port", m)
            h = p.harness()
            for i in range(20):
                h.state.upsert_node(h.next_index(), p.node(i))
            for k in range(4):
                for j in [p.job(3), p.job(2)]:
                    h.state.upsert_job(h.next_index(), j)
                    kw = ({"mesh": make_node_mesh(["cpu"] * 4)} if mesh
                          else {"device": "cpu"})
                    st = TorchBatchScheduler(
                        h.logger, h.snapshot(), h, rng_seed=SEED,
                        breaker=p.breaker, guard_every=1, **kw
                    ).schedule_batch([p.eval_for(j)])
                    assert st.oracle_routed == 0
                    if mesh:
                        assert st.mesh_shards == 4
            dev = p.dev_mirror()
            np.testing.assert_array_equal(dev, p.mirror())
            if mesh:
                assert isinstance(resident._STATE.used_dev, list)
            return (p.placements(h), p.mirror(), resident.DEV_INSTALLS,
                    resident.GUARD_MISMATCHES, resident.DEV_APPLIES)

    one, four = run(False), run(True)
    assert four[0] == one[0]
    np.testing.assert_array_equal(four[1], one[1])
    assert four[2] == one[2] == 1 and four[3] == one[3] == 0
    assert four[4] >= 6


def test_pass_leaves_the_lent_mirror_unchanged(monkeypatch):
    """The device pass starts its usage from the lent twin and hands it
    back bit for bit: the placements reach it through the feed only."""
    from nomad_tpu_torch.ops import kernels

    seen = []
    real = kernels.fused_pass

    def spy(*args, used_dev=None, **kw):
        before = None if used_dev is None else used_dev.clone()
        out = real(*args, used_dev=used_dev, **kw)
        if used_dev is not None:
            seen.append(torch.equal(before, used_dev))
        return out

    monkeypatch.setattr(kernels, "fused_pass", spy)
    got = device_mirror_scenario(Pkg("port", monkeypatch))
    assert seen and all(seen)
    np.testing.assert_array_equal(got["dev"], got["mirror"])


def test_delta_apply_error_propagates_with_the_slot_empty(monkeypatch):
    """A device error in the in-place apply is not swallowed: it
    propagates, the slot holds no twin, and the next batch installs one
    again from the host mirror."""
    p = Pkg("port", monkeypatch)
    h = p.harness()
    for i in range(8):
        h.state.upsert_node(h.next_index(), p.node(i))
    p.schedule(h, [p.job(2)])
    p.schedule(h, [p.job(2)])
    assert resident.DEV_INSTALLS == 1

    def fail(dev, rows):
        raise RuntimeError("CUDA error: an illegal memory access")

    with monkeypatch.context() as m:
        m.setattr(resident, "_apply_device_deltas", fail)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            p.schedule(h, [p.job(2)])
    assert resident._STATE.used_dev is None
    p.schedule(h, [p.job(2)])
    assert resident.DEV_INSTALLS == 2
    np.testing.assert_array_equal(p.dev_mirror(), p.mirror())
    assert resident.GUARD_MISMATCHES == 0


# -- the twin sequence through each package's plan applier --------------------

class JApplierPlanner:
    """The reference applier as a Harness planner: its serial
    ``_process_plan`` -> ``_commit`` for one plan, committing at the
    harness's next index, with the worker's fresh snapshot on a
    refresh."""

    def __init__(self, h):
        self.state = h.state
        self.applier = JApplier(PlanQueue(), IndexRaft(h.state,
                                                       h.next_index))

    def submit_plan(self, plan):
        snap = self.state
        result = self.applier.evaluate_plan(snap, plan)
        if result.node_update or result.node_allocation \
                or result.alloc_slabs:
            index = self.applier.apply_plan(plan, result, snap)
            result.alloc_index = index
            if result.refresh_index:
                result.refresh_index = max(result.refresh_index, index)
        return result, (self.state.snapshot() if result.refresh_index
                        else None)

    def update_eval(self, ev):
        pass

    def create_eval(self, ev):
        pass

    def reblock_eval(self, ev):
        pass


class OverCommit:
    """A planner in front of another: before the first plan it forwards,
    it fills (outside the scheduler) the first node that plan places on,
    so the scheduler's snapshot no longer holds."""

    def __init__(self, h, s, inner):
        self.h, self.s, self.inner = h, s, inner
        self.done = False

    def submit_plan(self, plan):
        if not self.done:
            self.done = True
            state = self.h.state
            node_id = plan.alloc_slabs[0].node_ids[0]
            node = state.node_by_id(None, node_id)
            left = node.resources.cpu - node.reserved.cpu - sum(
                a.resources.cpu for a in state.allocs_by_node(None, node_id)
                if not a.terminal_status())
            state.upsert_allocs(self.h.next_index(), [self.s.Allocation(
                id="hog", job_id="hog", node_id=node_id, task_group="web",
                resources=self.s.Resources(cpu=left, memory_mb=16))])
        return self.inner.submit_plan(plan)

    def update_eval(self, ev):
        self.inner.update_eval(ev)

    def create_eval(self, ev):
        self.inner.create_eval(ev)

    def reblock_eval(self, ev):
        self.inner.reblock_eval(ev)


def test_twin_sequence_through_the_appliers(monkeypatch):
    """Seeded batches, plans through each package's applier: the same
    plans, stores and host mirrors after every batch.  One batch meets a
    node filled between its snapshot and its submit: a partial commit,
    and the conflict retry places the rest."""
    from test_torch_sched import make_job, make_node

    t = Twin(monkeypatch, 31)
    t.jh.planner = JApplierPlanner(t.jh)
    t.ph.planner = PlanApplier(t.ph.state, device="cpu",
                               next_index=t.ph.next_index)
    for _ in range(80):
        t.add_node(make_node(t.rng))

    def run(evals, seed):
        t.mp.setenv("NOMAD_TPU_RNG_SEED", str(seed))
        with t.mp.context() as m:
            m.setattr(js, "generate_uuid", t.jids.one)
            m.setattr(js, "generate_uuids", t.jids.many)
            jst = TPUBatchScheduler(t.jh.logger, t.jh.snapshot(), t.jh,
                                    breaker=JBreaker()).schedule_batch(evals)
        with t.mp.context() as m:
            m.setattr(ps, "generate_uuid", t.pids.one)
            m.setattr(ps, "generate_uuids", t.pids.many)
            pst = TorchBatchScheduler(
                t.ph.logger, t.ph.snapshot(), t.ph, device="cpu",
                rng_seed=seed, breaker=KernelCircuitBreaker(),
                guard_every=1).schedule_batch(
                    [conv(e, convert.eval_from_dict) for e in evals])
        assert_same_world(t.jh, t.ph)
        np.testing.assert_array_equal(resident._STATE.used,
                                      jresident._STATE.used)
        return jst, pst

    jobs = [make_job(t.rng, c) for c in (70, 12, 9)]
    for j in jobs:
        t.put_job(j)
    jst, pst = run([t.eval_for(j) for j in jobs], 31)
    assert pst.oracle_routed == jst.oracle_routed == 0
    assert t.ph.planner.stats["vectorized"] == 1

    for k in range(4):
        batch = [make_job(t.rng, c) for c in (5, 7)]
        for j in batch:
            t.put_job(j)
        if k == 2:
            for h, s in ((t.jh, js), (t.ph, ps)):
                h.planner = OverCommit(h, s, h.planner)
            # The oracle's retry draws its node order from these.
            monkeypatch.setattr(jcontext, "_SEED_SOURCE", random.Random(k))
            monkeypatch.setattr(pcontext, "_SEED_SOURCE", random.Random(k))
        jst, pst = run([t.eval_for(j) for j in batch], 40 + k)
        assert pst.resident_hits == jst.resident_hits == 1
        if k == 2:
            # Partial commits, each retried through the oracle (which the
            # port counts in oracle_routed and the reference only logs).
            assert pst.oracle_routed == \
                t.ph.planner.inner.stats["partial"] >= 1
            assert jst.oracle_routed == 0
            for h in (t.jh, t.ph):
                h.planner = h.planner.inner
    assert resident.GUARD_MISMATCHES == jresident.GUARD_MISMATCHES == 0
    for node in t.ph.state.nodes(None):
        used = [0, 0]
        for a in t.ph.state.allocs_by_node(None, node.id):
            if not a.terminal_status():
                used[0] += a.resources.cpu
                used[1] += a.resources.memory_mb
        assert used[0] + node.reserved.cpu <= node.resources.cpu
        assert used[1] + node.reserved.memory_mb <= node.resources.memory_mb


def test_acquire_with_concurrent_writers_and_readers():
    """The slot under its lock: more reader threads than cores acquire
    the mirror on fresh snapshots while a writer adds and completes
    allocs; every matrix a reader gets equals a full walk of its own
    snapshot, and the guard (every hit) never mismatches."""
    import os
    import sys
    import threading
    import time

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops import batch_sched
    from nomad_tpu_torch.state import StateStore

    st = StateStore()
    nodes = []
    for i in range(40):
        n = mock.node()
        n.id = f"node-{i:03d}"
        nodes.append(n)
        st.upsert_node(i + 1, n)
    base = batch_sched._cluster_static(st.nodes(None), [], {}, False, 128)
    key = (st.store_uid, st.table_index("nodes"), base.n_pad)
    index = [100]

    def walk(snap):
        out = {}
        for nid, row in snap.alloc_rows(None):
            if not row.terminal_status():
                out.setdefault(nid, []).append(row)
        return out

    stop = threading.Event()
    errors = []

    def writer():
        rng = random.Random(1)
        live = []
        while not stop.is_set():
            index[0] += 1
            if live and rng.random() < 0.3:
                done = ps._fast_copy(live.pop(rng.randrange(len(live))))
                done.client_status = ps.ALLOC_CLIENT_STATUS_COMPLETE
                st.update_allocs_from_client(index[0], [done])
            else:
                a = ps.Allocation(
                    id=f"a{index[0]}", job_id="j", task_group="web",
                    node_id=nodes[rng.randrange(40)].id,
                    resources=ps.Resources(cpu=rng.randrange(1, 99),
                                           memory_mb=rng.randrange(1, 99)))
                st.upsert_allocs(index[0], [a])
                live.append(a)

    def reader():
        while not stop.is_set():
            snap = st.snapshot()
            used, _, _ = resident.acquire(snap, key, base,
                                          lambda: walk(snap),
                                          guard_every=1)
            want, _ = resident._full_usage(base, lambda: walk(snap))
            if not np.array_equal(used, want):
                errors.append(snap.table_index("allocs"))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=writer)] + [
        threading.Thread(target=reader)
        for _ in range((os.cpu_count() or 4) + 2)]
    try:
        for t in threads:
            t.start()
        time.sleep(1.5)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert resident.GUARD_MISMATCHES == 0
    assert resident.HITS > 0 and resident.GUARD_RUNS == resident.HITS
