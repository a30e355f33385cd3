"""The port's columnar state store against the JAX package's.

``nomad_tpu_torch/state/columnar.py`` and its readers (the static encode
``ops/encode.build_cluster_static``, the live-usage read
``ops/batch_sched._columnar_usage``, the applier's
``_evaluate_nodes_columnar``) are held against ``nomad_tpu/state/
columnar.py`` and the same readers there, on the CPU at small sizes with
seeded inputs:

- a seeded sequence of writes (node upserts, status and drain flips,
  datacenter and class changes, deletes, alloc upserts, plan results with
  slabs, client updates, job deletes) through both stores: after each
  step the two mirrors are equal to each other and to a walk made from
  scratch;
- twins of the reference's ``TestColumnMirror`` and
  ``TestGuardAndScheduler`` (``tests/test_columnar.py``);
- the static encode bit-identical to the walk and to the reference's, on
  a pad of 128 and on a 3-shard mesh pad;
- the applier's columnar verdicts and commits equal the reference's;
- ``TorchBatchScheduler`` with the mirror on and off against
  ``TPUBatchScheduler`` over batch 0, a follow-up and a cold re-encode,
  every guard at every read, no mismatch and no oracle route.

The reference runs with ``NOMAD_TPU_COLUMNAR=1`` and
``NOMAD_TPU_COLUMNAR_GUARD_EVERY=1``, and each scheduler gets its own
breaker.  Tolerance: exact on every array, verdict and plan; AllocMetric
scores within 1e-5 (``test_torch_sched.assert_same_world``).
"""
import dataclasses
import random

import jax  # noqa: F401  (the reference computes on the CPU backend)
import numpy as np
import pytest

from nomad_tpu import mock as jmock
from nomad_tpu.ops import encode as jencode
from nomad_tpu.ops import resident as jresident
from nomad_tpu.ops.batch_sched import TPUBatchScheduler
from nomad_tpu.ops.breaker import KernelCircuitBreaker as JBreaker
from nomad_tpu.state import StateStore as JStore
from nomad_tpu.state import columnar as jcolumnar
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert, fault
from nomad_tpu_torch.ops import encode, resident
from nomad_tpu_torch.ops.batch_sched import TorchBatchScheduler
from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
from nomad_tpu_torch.scheduler.testing import Harness
from nomad_tpu_torch.state import StateStore, columnar
from nomad_tpu_torch.structs import structs as ps
from test_torch_plan_apply import THRESHOLD, World, fill
from test_torch_sched import Twin, make_job, make_node


@pytest.fixture(autouse=True)
def columnar_on(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_COLUMNAR", "1")
    monkeypatch.setenv("NOMAD_TPU_COLUMNAR_GUARD_EVERY", "1")
    for mod in (columnar, jcolumnar, resident, jresident):
        mod.reset_counters()
    yield
    for mod in (columnar, jcolumnar, resident, jresident):
        mod.reset_counters()


def conv(obj, fn):
    return fn(dataclasses.asdict(obj))


def strip(n, node_id, dc="dc1"):
    n.id = n.name = node_id
    n.datacenter = dc
    n.resources.networks = []
    n.reserved.networks = []
    n.compute_class()
    return n


# -- a walk made from scratch -------------------------------------------------

def scratch_mirror(store):
    """What the mirror must hold, from the store's objects: node rows in
    table order, first-seen codebooks, and the live usage of every alloc
    row on the alloc_usage_vec basis."""
    nodes = store.nodes(None)
    dc_book, class_book = {}, {}
    cap, res, elig, dc, cc = [], [], [], [], []
    for n in nodes:
        cap.append(n.resources.as_tuple())
        res.append(n.reserved.as_tuple() if n.reserved else (0, 0, 0, 0))
        elig.append(n.ready())
        dc.append(dc_book.setdefault(n.datacenter, len(dc_book)))
        cc.append(class_book.setdefault(n.computed_class, len(class_book)))
    row_of = {n.id: i for i, n in enumerate(nodes)}
    usage = np.zeros((len(nodes), 4), dtype=np.int64)
    for nid, row in store.alloc_rows(None):
        if not row.terminal_status() and nid in row_of:
            usage[row_of[nid]] += np.array(ps.alloc_usage_vec(row))
    return {"node_ids": [n.id for n in nodes],
            "cap": np.array(cap, np.int64).reshape(-1, 4),
            "res": np.array(res, np.int64).reshape(-1, 4),
            "eligible": np.array(elig, bool),
            "dc_code": np.array(dc, np.int32),
            "class_code": np.array(cc, np.int32),
            "dc_book": dc_book, "class_book": class_book, "usage": usage}


def mirror_view(store):
    cols = store.columns()
    assert cols is not None
    n = cols.n
    return {"node_ids": list(cols.node_ids[:n]), "cap": cols.cap[:n],
            "res": cols.res[:n], "eligible": cols.eligible[:n],
            "dc_code": cols.dc_code[:n], "class_code": cols.class_code[:n],
            "dc_book": cols.dc_codebook(),
            "class_book": cols.class_codebook(),
            "usage": store.column_usage(cols)[:n].copy()}


def assert_same_mirror(a, b):
    assert a["node_ids"] == b["node_ids"]
    assert a["dc_book"] == b["dc_book"]
    assert a["class_book"] == b["class_book"]
    for k in ("cap", "res", "eligible", "dc_code", "class_code", "usage"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def assert_mirrors(jst, pst):
    """The port's mirror equal to the reference's and to a scratch walk."""
    got = mirror_view(pst)
    assert_same_mirror(got, mirror_view(jst))
    assert_same_mirror(got, scratch_mirror(pst))


# -- both stores, one write sequence ------------------------------------------

class Stores:
    """The reference's and the port's store, written alike at the same
    index; objects are built as the reference's and converted."""

    def __init__(self, seed, **port_kw):
        self.rng = random.Random(seed)
        self.js, self.ps = JStore(), StateStore(**port_kw)
        self.index = 0
        self.nodes = {}
        self.node_seq = 0
        self.live = []
        job = jmock.job()
        job.id = job.name = "job-col"
        self.job = job
        self.both("upsert_job", lambda: job,
                  lambda: conv(job, convert.job_from_dict))

    def next(self):
        self.index += 1
        return self.index

    def both(self, method, jargs, pargs):
        """``method(index, *args)`` on both stores; each args factory
        returns the argument (or a tuple of arguments)."""
        idx = self.next()
        for st, fn in ((self.js, jargs), (self.ps, pargs)):
            args = fn()
            args = args if isinstance(args, tuple) else (args,)
            getattr(st, method)(idx, *args)

    def next_node_id(self):
        return f"node-{self.node_seq:03d}"

    def add_node(self, dc=None):
        n = strip(jmock.node(), self.next_node_id(),
                  dc or f"dc{self.rng.randrange(3)}")
        n.resources.cpu = self.rng.choice([2000, 4000])
        self.node_seq += 1
        self.nodes[n.id] = n
        self.both("upsert_node", lambda: n.copy(),
                  lambda: conv(n, convert.node_from_dict))
        return n

    def alloc(self, node_id, cpu=None):
        a = jmock.alloc()
        a.id = f"alloc-{self.rng.getrandbits(64):016x}"
        a.node_id = node_id
        a.job_id, a.job = self.job.id, self.job
        a.resources = js.Resources(
            cpu=cpu or self.rng.randrange(1, 300),
            memory_mb=self.rng.randrange(1, 64),
            disk_mb=self.rng.randrange(32))
        return a

    def upsert_allocs(self, allocs):
        self.both("upsert_allocs", lambda: [a.copy() for a in allocs],
                  lambda: [conv(a, convert.alloc_from_dict) for a in allocs])

    def slab(self, node_ids, tag):
        proto = jmock.alloc()
        proto.job_id, proto.job = self.job.id, self.job
        proto.resources = js.Resources(cpu=7, memory_mb=5, disk_mb=3)
        proto.desired_status = js.ALLOC_DESIRED_STATUS_RUN
        proto.client_status = js.ALLOC_CLIENT_STATUS_PENDING
        k = len(node_ids)
        return js.AllocSlab(
            proto=proto, ids=[f"slab-{tag}-{i}" for i in range(k)],
            names=[f"job-col.web[{i}]" for i in range(k)],
            node_ids=list(node_ids), prev_ids=[])

    def plan_results(self, allocs, slabs):
        def pslab(sl):
            return ps.AllocSlab(
                proto=conv(sl.proto, convert.alloc_from_dict),
                ids=list(sl.ids), names=list(sl.names),
                node_ids=list(sl.node_ids), prev_ids=[])
        self.both(
            "upsert_plan_results",
            lambda: (self.js.job_by_id(None, self.job.id),
                     [a.copy() for a in allocs], slabs),
            lambda: (self.ps.job_by_id(None, self.job.id),
                     [conv(a, convert.alloc_from_dict) for a in allocs],
                     [pslab(sl) for sl in slabs]))


def write_step(st, op, step):
    rng = st.rng
    ids = list(st.nodes)
    if op == "node":
        st.add_node()
    elif op == "status":
        nid = rng.choice(ids)
        status = rng.choice([js.NODE_STATUS_READY, js.NODE_STATUS_DOWN])
        st.both("update_node_status", lambda: (nid, status),
                lambda: (nid, status))
    elif op == "drain":
        nid, drain = rng.choice(ids), rng.random() < 0.5
        st.both("update_node_drain", lambda: (nid, drain),
                lambda: (nid, drain))
    elif op in ("dc", "class", "resize"):
        n = st.js.node_by_id(None, rng.choice(ids)).copy()
        if op == "dc":
            n.datacenter = f"dc-new-{step}"
        elif op == "class":
            n.node_class = f"class-{step}"
        else:
            n.resources.cpu += 512
        n.compute_class()
        st.both("upsert_node", lambda: n.copy(),
                lambda: conv(n, convert.node_from_dict))
    elif op == "delete":
        nid = rng.choice(ids)
        del st.nodes[nid]
        st.both("delete_node", lambda: nid, lambda: nid)
    elif op == "allocs":
        # One alloc names a node not registered yet (backfilled later).
        targets = [rng.choice(ids) for _ in range(3)]
        targets.append(st.next_node_id())
        allocs = [st.alloc(t) for t in targets]
        st.live += [a.id for a in allocs]
        st.upsert_allocs(allocs)
    elif op == "plan":
        allocs = [st.alloc(rng.choice(ids)) for _ in range(2)]
        st.live += [a.id for a in allocs]
        slab = st.slab([rng.choice(ids) for _ in range(rng.randrange(
            1, 12))], f"s{step}")
        st.plan_results(allocs, [slab])
    elif op == "stop" and st.live:
        aid = st.live.pop(rng.randrange(len(st.live)))
        stop = st.js.alloc_by_id(None, aid).copy()
        stop.desired_status = js.ALLOC_DESIRED_STATUS_STOP
        st.upsert_allocs([stop])
    elif op == "client" and st.live:
        aid = st.live.pop(rng.randrange(len(st.live)))
        upd = js.Allocation(id=aid,
                            client_status=js.ALLOC_CLIENT_STATUS_COMPLETE)
        st.both("update_allocs_from_client", lambda: [upd.copy()],
                lambda: [conv(upd, convert.alloc_from_dict)])
    elif op == "job_delete":
        if st.js.job_by_id(None, st.job.id) is not None:
            st.both("delete_job", lambda: st.job.id, lambda: st.job.id)


OPS = ("node", "status", "drain", "dc", "class", "resize", "delete",
       "allocs", "plan", "stop", "client", "job_delete")


@pytest.mark.parametrize("seed", [3, 17])
def test_random_writes_keep_both_mirrors_equal_to_the_walk(seed):
    st = Stores(seed)
    for _ in range(6):
        st.add_node()
    assert_mirrors(st.js, st.ps)
    snaps = []
    for step in range(50):
        op = st.rng.choice(OPS)
        if op == "delete" and len(st.nodes) < 4:
            op = "node"
        write_step(st, op, step)
        assert_mirrors(st.js, st.ps)
        if step % 9 == 0:
            snaps.append((st.js.snapshot(), st.ps.snapshot()))
    assert columnar.REBUILDS == jcolumnar.REBUILDS > 1
    # Every snapshot still holds its own point in time, equal in both.
    for jsnap, psnap in snaps:
        assert_mirrors(jsnap, psnap)


# -- twins of the reference's TestColumnMirror ---------------------------------

def test_incremental_writes_keep_parity():
    st = Stores(5)
    for i in range(12):
        st.add_node(dc=f"dc{i % 3}")
    nodes = list(st.nodes)
    for op, step in (("status", 1), ("drain", 2), ("resize", 3)):
        write_step(st, op, step)
    assert_mirrors(st.js, st.ps)
    al = st.alloc(nodes[0], cpu=100)
    st.upsert_allocs([al])
    st.plan_results([], [st.slab([nodes[i % 12] for i in range(40)], "a")])
    assert_mirrors(st.js, st.ps)
    stop = st.js.alloc_by_id(None, al.id).copy()
    stop.desired_status = js.ALLOC_DESIRED_STATUS_EVICT
    st.upsert_allocs([stop])
    assert_mirrors(st.js, st.ps)


def test_delete_and_dc_change_rebuild():
    st = Stores(6)
    for i in range(8):
        st.add_node(dc=f"dc{i % 2}")
    assert_mirrors(st.js, st.ps)
    first = next(iter(st.nodes))
    del st.nodes[first]
    st.both("delete_node", lambda: first, lambda: first)
    assert st.ps._columns is None and st.js._columns is None
    assert_mirrors(st.js, st.ps)
    write_step(st, "dc", 1)
    assert st.ps._columns is None and st.js._columns is None
    assert_mirrors(st.js, st.ps)


def test_node_registered_after_allocs_backfills():
    st = Stores(7)
    st.add_node()
    st.ps.columns(), st.js.columns()  # warm both mirrors
    late = "node-001"
    st.upsert_allocs([st.alloc(late, cpu=55)])
    st.plan_results([], [st.slab([late, late], "late")])
    st.add_node()
    assert list(st.nodes)[-1] == late
    assert_mirrors(st.js, st.ps)
    assert mirror_view(st.ps)["usage"][1][0] == 55 + 2 * 7


def test_snapshot_copy_on_write_isolation():
    st = Stores(8)
    for _ in range(6):
        st.add_node()
    nodes = list(st.nodes)
    st.upsert_allocs([st.alloc(nodes[0], cpu=10)])
    snap = st.ps.snapshot()
    before = mirror_view(snap)
    st.upsert_allocs([st.alloc(nodes[1], cpu=99)])
    st.both("update_node_drain", lambda: (nodes[2], True),
            lambda: (nodes[2], True))
    st.add_node()
    assert_same_mirror(mirror_view(snap), before)
    assert_same_mirror(mirror_view(snap), scratch_mirror(snap))
    assert_mirrors(st.js, st.ps)
    assert mirror_view(st.ps)["usage"][1][0] == 99
    assert mirror_view(snap)["eligible"][2]


def test_row_writes_on_a_view_copy_first():
    """A snapshot's view that writes a row (usage, eligibility, a new
    node) copies the arrays it writes; the owner's rows stay."""
    st = Stores(9)
    for _ in range(4):
        st.add_node()
    owner = st.ps.columns()
    view = st.ps.snapshot().columns()
    assert view.usage is owner.usage and view.eligible is owner.eligible
    nid = view.node_ids[1]
    view.add_usage(nid, (5, 6, 7, 8))
    view.set_eligible(nid, False)
    extra = conv(strip(jmock.node(), "node-x"), convert.node_from_dict)
    assert view.append_node(extra) == 4 and view.n == 5
    assert view.usage is not owner.usage and view.cap is not owner.cap
    assert list(view.usage[1]) == [5, 6, 7, 8] and not view.eligible[1]
    assert not owner.usage[:owner.n].any() and owner.eligible[1]
    assert owner.n == 4 and "node-x" not in owner.row_of
    assert_mirrors(st.js, st.ps)


def test_snapshot_folds_owner_cursor_past_log_trim(monkeypatch):
    monkeypatch.setattr(StateStore, "COL_FOLD_BACKLOG", 16)
    st = StateStore(alloc_log_cap=64)
    node = conv(strip(jmock.node(), "node-000"), convert.node_from_dict)
    st.upsert_node(1, node)
    frozen = st.columns().usage_index
    for i in range(200):
        al = conv(jmock.alloc(), convert.alloc_from_dict)
        al.id, al.node_id = f"a-{i}", node.id
        al.resources = ps.Resources(cpu=1, memory_mb=1, disk_mb=1)
        st.upsert_allocs(2 + i, [al])
    assert st._alloc_log_floor > frozen
    rebuilds = columnar.REBUILDS
    snap = st.snapshot()
    assert st._columns.usage_index > frozen
    assert columnar.REBUILDS == rebuilds  # a rebuild of usage, not of rows
    assert_same_mirror(mirror_view(snap), scratch_mirror(snap))
    assert mirror_view(snap)["usage"][0][0] == 200


def test_columnar_false_store_walks():
    st = StateStore(columnar=False)
    node = conv(strip(jmock.node(), "node-000"), convert.node_from_dict)
    st.upsert_node(1, node)
    assert st.columns() is None and st.snapshot().columns() is None
    ct = encode.build_cluster_static(st, st.nodes(None), [], {})
    assert not ct.columnar and columnar.WALK_ENCODES == 1
    assert columnar.COLUMNAR_ENCODES == 0 and columnar.REBUILDS == 0


# -- the static encode ---------------------------------------------------------

TARGETS = ["${attr.kernel.name}", "${node.class}", "${meta.rack}"]
LITERALS = {"${attr.kernel.name}": {"linux", "windows"},
            "${meta.rack}": {"r-3"}}


def encode_fleet(seed, n):
    st = Stores(seed)
    for i in range(n):
        node = st.add_node(dc=f"dc{i % 4}")
        del node  # the node objects are read back from the stores
    for nid in list(st.nodes)[::5]:
        st.both("update_node_drain", lambda: (nid, True),
                lambda: (nid, True))
    return st


def ref_fields(ct):
    return {"node_ids": ct.node_ids, "capacity": ct.capacity,
            "used": ct.used, "score_denom": ct.score_denom,
            "eligible": ct.eligible, "dc_code": ct.dc_code,
            "class_code": ct.class_code, "attr_values": ct.attr_values,
            "dc_codebook": ct.dc_codebook,
            "value_codebooks": ct.value_codebooks,
            "class_codebook": getattr(ct, "_class_codebook", None)
            if hasattr(ct, "_class_codebook") else ct.class_codebook}


@pytest.mark.parametrize("pad", [128, 384])  # one card; lcm(128, 3)
@pytest.mark.parametrize("n", [37, 300])
def test_static_encode_equals_the_walk_and_the_reference(pad, n):
    st = encode_fleet(40 + n, n)
    for node in st.ps.nodes(None)[:n // 3]:
        node.meta["rack"] = f"r-{int(node.id[-3:]) % 5}"
    jnodes, pnodes = st.js.nodes(None), st.ps.nodes(None)
    for jn, pn in zip(jnodes, pnodes):
        if "rack" in pn.meta:
            jn.meta["rack"] = pn.meta["rack"]
    ct = encode.build_cluster_static(st.ps, pnodes, TARGETS, LITERALS,
                                     node_pad_multiple=pad, guard_every=1)
    assert ct.columnar and ct.n_pad % pad == 0
    assert columnar.GUARD_RUNS == 1 and columnar.GUARD_MISMATCHES == 0
    walk = encode.encode_cluster_static(pnodes, TARGETS,
                                        node_pad_multiple=pad)
    encode.finalize_codebooks(walk, LITERALS)
    assert encode._static_mismatch(ct, walk) == ""
    ref = jencode.encode_cluster_static_columnar(
        st.js.columns(), jnodes, TARGETS, node_pad_multiple=pad)
    jencode.finalize_codebooks(ref, LITERALS)
    want, got = ref_fields(ref), ref_fields(ct)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def test_network_batches_and_stale_mirrors_walk():
    st = encode_fleet(9, 20)
    nodes = st.ps.nodes(None)
    ct = encode.build_cluster_static(st.ps, nodes, [], {},
                                     with_networks=True)
    assert not ct.columnar and ct.with_networks
    ct = encode.build_cluster_static(st.ps, nodes[:-1], [], {})
    assert not ct.columnar and ct.n_real == 19
    assert columnar.WALK_ENCODES == 2 and columnar.COLUMNAR_ENCODES == 0


def test_injected_corruption_is_caught_and_the_walk_returned():
    st = encode_fleet(10, 30)
    nodes = st.ps.nodes(None)
    brk = KernelCircuitBreaker(threshold=0.9, window=8, min_checks=1,
                               cooldown=3600.0)
    epoch = columnar.EPOCH
    with fault.scenario({"seed": 5, "faults": [
            {"point": "state.columns", "action": "corrupt", "times": 1}]}):
        ct = encode.build_cluster_static(st.ps, nodes, [], {},
                                         breaker=brk, guard_every=1)
    walk = encode.encode_cluster_static(nodes, [])
    encode.finalize_codebooks(walk, {})
    assert not ct.columnar and encode._static_mismatch(ct, walk) == ""
    assert columnar.GUARD_MISMATCHES == 1 and columnar.EPOCH == epoch + 1
    assert brk.state == "open"
    # The epoch bump made the owner rebuild: parity again.
    rebuilds = columnar.REBUILDS
    assert_mirrors(st.js, st.ps)
    assert columnar.REBUILDS == rebuilds + 1


# -- the applier's columnar route ----------------------------------------------

def plan_adds_and_slab(w):
    plan = js.Plan(eval_id="ev-1", job=w.jjob)
    plan.append_slab(w.slab([nd.id for nd in w.nodes]))
    for nd in w.nodes[:3]:
        plan.append_alloc(w.alloc(nd.id, cpu=300))
    fill(w, w.nodes[-1], cpu_left=100)   # over-committed: a partial
    return plan


def plan_removals(w):
    live = [w.alloc(nd.id, cpu=1000) for nd in w.nodes]
    w.put_allocs(live)
    other = w.alloc(w.nodes[1].id, cpu=900)
    w.put_allocs([other])
    plan = js.Plan(eval_id="ev-1", job=w.jjob)
    for a in live[: len(live) // 2]:
        plan.append_update(w.js.alloc_by_id(None, a.id),
                           js.ALLOC_DESIRED_STATUS_STOP, "replaced")
    # A removal naming an alloc of another node counts for nothing.
    wrong = w.js.alloc_by_id(None, other.id).copy()
    wrong.node_id = w.nodes[0].id
    plan.append_update(wrong, js.ALLOC_DESIRED_STATUS_STOP, "moved")
    for nd in w.nodes:
        plan.append_alloc(w.alloc(nd.id, cpu=1200))
    return plan


def plan_preemptions(w):
    victims = [w.alloc(w.nodes[i].id) for i in (0, 1)]
    w.put_allocs(victims)
    # Node 2 is evict-only: it always fits.
    evict_only = w.alloc(w.nodes[2].id)
    w.put_allocs([evict_only])
    plan = js.Plan(eval_id="ev-1", job=w.jjob)
    for a in victims + [evict_only]:
        plan.append_preempted_alloc(w.js.alloc_by_id(None, a.id))
    plan.append_slab(w.slab([nd.id for i, nd in enumerate(w.nodes)
                             if i != 2]))
    # The victim on node 1 changes after the plan was made: stale.
    moved = victims[1].copy()
    moved.desired_description = "touched"
    w.put_allocs([moved])
    return plan


def plan_ineligible(w):
    w.node_status(w.nodes[2].id, js.NODE_STATUS_DOWN)
    w.node_drain(w.nodes[3].id)
    plan = js.Plan(eval_id="ev-1", job=w.jjob)
    plan.append_slab(w.slab([nd.id for nd in w.nodes]))
    return plan


def plan_overlay(w):
    node = w.nodes[3]
    big = w.alloc(node.id, cpu=node.resources.cpu - node.reserved.cpu - 300,
                  mem=64)
    big.resources = js.Resources(cpu=big.task_resources["web"].cpu,
                                 memory_mb=64, disk_mb=150)
    w.japp._overlay.add(1, js.PlanResult(node_allocation={node.id: [big]}))
    w.papp._overlay.add(1, ps.PlanResult(node_allocation={
        node.id: [conv(big, convert.alloc_from_dict)]}))
    slab = w.slab([nd.id for nd in w.nodes])
    w.japp._overlay.add(2, js.PlanResult(alloc_slabs=[slab]))
    w.papp._overlay.add(2, ps.PlanResult(alloc_slabs=[ps.AllocSlab(
        proto=conv(slab.proto, convert.alloc_from_dict),
        ids=list(slab.ids), names=list(slab.names),
        node_ids=list(slab.node_ids))]))
    plan = js.Plan(eval_id="ev-2", job=w.jjob)
    plan.append_slab(w.slab([nd.id for nd in w.nodes], ev_id="ev-2",
                            cpu=1200))
    return plan


def plan_ports(w):
    w.put_allocs([w.alloc(w.nodes[0].id, ports=(8080,))])
    plan = js.Plan(eval_id="ev-1", job=w.jjob)
    for nd in w.nodes:
        plan.append_alloc(w.alloc(nd.id, ports=(8080,)))
    plan.append_slab(w.slab([nd.id for nd in w.nodes[1:]]))
    return plan


PLANS = {"adds_and_slab": plan_adds_and_slab, "removals": plan_removals,
         "preemptions": plan_preemptions, "ineligible": plan_ineligible,
         "overlay": plan_overlay, "ports": plan_ports}


@pytest.mark.parametrize("n", [8, THRESHOLD + 6])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_applier_columnar_verdicts_and_commits(name, n):
    w = World(n, networks=name == "ports", columnar=True,
              columnar_guard_every=1)
    jplan = PLANS[name](w)
    pplan = w.port_plan(jplan)
    jsnap, psnap = w.js.snapshot(), w.ps.snapshot()
    node_ids = sorted({*jplan.node_update, *jplan.node_allocation,
                       *jplan.node_preemptions,
                       *(nid for sl in jplan.alloc_slabs
                         for nid in sl.node_ids)})
    jover = {nid: w.japp._overlay.pending_for(nid) for nid in node_ids}
    pover = {nid: w.papp._overlay.pending_for(nid) for nid in node_ids}
    want = w.japp._evaluate_nodes_columnar(
        jsnap, jplan, node_ids, w.japp._slab_node_adds(jplan), jover,
        guard=False)
    got = w.papp._evaluate_nodes_columnar(
        psnap, pplan, node_ids, w.papp._slab_node_adds(pplan), pover,
        guard=False)
    assert want is not None and got == want
    assert not all(got.values())
    w.evaluate_and_apply(jplan)   # guard at every call in both
    assert w.papp.stats["columnar"] == 1
    assert w.papp.stats["columnar_guards"] == 1
    assert w.papp.stats["vectorized" if n >= THRESHOLD else "scalar"] == 1
    assert columnar.USAGE_GUARD_MISMATCHES == 0
    assert jcolumnar.USAGE_GUARD_MISMATCHES == 0
    assert_mirrors(w.js, w.ps)


def test_applier_guard_catches_a_lying_mirror():
    w = World(8, columnar=True, columnar_guard_every=1)
    plan = js.Plan(eval_id="ev-1", job=w.jjob)
    plan.append_slab(w.slab([nd.id for nd in w.nodes]))
    pplan = w.port_plan(plan)
    cols = w.ps.columns()
    cols.cap[0] = 0      # the mirror lies: node 0 has no capacity
    res = w.papp.evaluate_plan(w.ps, pplan)
    assert not res.refresh_index and len(res.alloc_slabs[0]) == 8
    assert columnar.USAGE_GUARD_MISMATCHES == 1
    assert w.ps.columns() is not cols   # the epoch bump: rebuilt


# -- TorchBatchScheduler -------------------------------------------------------

@pytest.mark.parametrize("resident_on", [True, False])
@pytest.mark.parametrize("on", [True, False])
def test_scheduler_plans_equal_the_reference(monkeypatch, on, resident_on):
    monkeypatch.setenv("NOMAD_TPU_COLUMNAR", "1" if on else "0")
    monkeypatch.setenv("NOMAD_TPU_RESIDENT", "1" if resident_on else "0")
    t = Twin(monkeypatch, 90 + 2 * on + resident_on)
    assert t.ph.state.columnar == on
    kw = {"columnar_guard_every": 1, "resident": resident_on}
    for _ in range(24):
        t.add_node(make_node(t.rng))
    jobs = [make_job(t.rng, c) for c in (9, 14, 5)]
    for j in jobs:
        t.put_job(j)
    t.run([t.eval_for(j) for j in jobs], **kw)            # batch 0
    follow = [make_job(t.rng, 4, cpu=100) for _ in range(2)]
    for j in follow:
        t.put_job(j)
    t.run([t.eval_for(j) for j in follow], **kw)          # a follow-up
    down = t.ph.state.nodes(None)[3].id
    t.node_down(down)                                     # cold re-encode
    t.add_node(make_node(t.rng))
    more = [make_job(t.rng, 6)]
    for j in more:
        t.put_job(j)
    t.run([t.eval_for(j) for j in more] + [
        t.eval_for(jobs[0], js.EVAL_TRIGGER_NODE_UPDATE)], **kw)
    if on:
        assert columnar.COLUMNAR_ENCODES == 2 and columnar.GUARD_RUNS == 2
        assert columnar.USAGE_GUARD_RUNS == columnar.USAGE_READS >= 2
    else:
        assert columnar.COLUMNAR_ENCODES == columnar.USAGE_READS == 0
        assert columnar.WALK_ENCODES == 2
    assert columnar.GUARD_MISMATCHES == jcolumnar.GUARD_MISMATCHES == 0
    assert columnar.USAGE_GUARD_MISMATCHES == 0


def test_scheduler_corruption_trips_the_breaker_and_the_walk_carries(
        monkeypatch):
    """The reference's test_injected_corruption_trips_breaker_and_walk_
    carries in both packages: the guard catches the corrupted cell, the
    private breaker opens, and the walk's buffers place the batch as the
    clean reference does."""
    t = Twin(monkeypatch, 77)
    for _ in range(8):
        t.add_node(make_node(t.rng))
    job = make_job(t.rng, 2)
    t.put_job(job)
    ev = t.eval_for(job)
    seed = 77
    t.mp.setenv("NOMAD_TPU_RNG_SEED", str(seed))
    TPUBatchScheduler(t.jh.logger, t.jh.snapshot(), t.jh,
                      breaker=JBreaker()).schedule_batch([ev])
    brk = KernelCircuitBreaker(threshold=0.9, window=8, min_checks=1,
                               cooldown=3600.0)
    epoch = columnar.EPOCH
    with fault.scenario({"seed": 5, "faults": [
            {"point": "state.columns", "action": "corrupt", "times": 1}]}):
        with t.mp.context() as m:
            m.setattr(ps, "generate_uuid", t.pids.one)
            m.setattr(ps, "generate_uuids", t.pids.many)
            st = TorchBatchScheduler(
                t.ph.logger, t.ph.snapshot(), t.ph, device="cpu",
                rng_seed=seed, breaker=brk, columnar_guard_every=1
            ).schedule_batch([conv(ev, convert.eval_from_dict)])
    assert st.oracle_routed == 0
    assert columnar.GUARD_MISMATCHES == 1 and columnar.EPOCH == epoch + 1
    assert brk.state == "open"
    want = sorted((a.name, a.node_id)
                  for a in t.jh.state.allocs_by_job(None, job.id, True))
    got = sorted((a.name, a.node_id)
                 for a in t.ph.state.allocs_by_job(None, job.id, True))
    assert got == want and len(got) == 2


def test_on_off_identical_placements():
    """The reference's test_columnar_on_off_identical_placements: the
    same batch over a store with the mirror and one without."""
    def run(on):
        h = Harness(StateStore(columnar=on))
        for i in range(8):
            node = conv(strip(jmock.node(), f"fixed-node-{i:02d}",
                              f"dc{i % 2}"), convert.node_from_dict)
            h.state.upsert_node(h.next_index(), node)
        job = jmock.job()
        job.id = job.name = "fixed-job"
        job.task_groups[0].count = 5
        for tg in job.task_groups:
            for task in tg.tasks:
                task.resources.networks = []
        job = conv(job, convert.job_from_dict)
        h.state.upsert_job(h.next_index(), job)
        ev = ps.Evaluation(id="fixed-eval", priority=job.priority,
                           type=job.type, job_id=job.id,
                           triggered_by=ps.EVAL_TRIGGER_JOB_REGISTER,
                           status=ps.EVAL_STATUS_PENDING)
        TorchBatchScheduler(h.logger, h.snapshot(), h, device="cpu",
                            rng_seed=11, breaker=KernelCircuitBreaker(),
                            columnar_guard_every=1).schedule_batch([ev])
        return sorted((a.name, a.node_id)
                      for a in h.state.allocs_by_job(None, job.id, True)
                      if not a.terminal_status())

    on, off = run(True), run(False)
    assert on == off and len(on) == 5
    assert columnar.GUARD_RUNS == 1 and columnar.GUARD_MISMATCHES == 0


def test_selfcheck_columnar_drill_on_the_cpu(capsys):
    from nomad_tpu_torch.ops.__main__ import columnar_drill

    assert columnar_drill(seed=3, device="cpu")
    assert "columnar drill: OK" in capsys.readouterr().out
