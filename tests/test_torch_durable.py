"""The port's durable server against the reference's: the FSM's vault,
periodic and namespace handlers, the FSM snapshot in both formats,
``FileLog`` crash and recovery, and a ``Server(data_dir=...)`` that
crashes, restarts from disk and goes on scheduling.

- The FSM handlers (``nomad_tpu/server/fsm.py:210-235``): one seeded
  stream of vault-accessor, periodic-launch and namespace entries
  through both FSMs; equal tables.
- The snapshot, twins of ``tests/test_columnar.py:441-534``: the v2 and
  per-object blobs restore to the store they were taken of, in both
  directions; v2 slabs come back pending; dead slab slots are skipped;
  the FSM round trip installs the mirror from the column section (no
  walk) and it equals a walk; a restored store keeps scheduling with
  every guard on; a restored store is a new lineage whose delta-log
  floor sits at the restored allocs index; a blob of another struct
  schema fails to restore, naming both fingerprints.  The same store
  built in both packages restores to equal content in both.
- ``FileLog``, twin of ``tests/test_columnar.py:549`` (the ``wal.fsync``
  chaos test) and ``tests/test_server.py:307``: the same seeded entry
  stream through the reference's ``FileLog`` and the port's, a crash
  mid-frame in each, recovery: equal applied index and content, the torn
  entry absent, a later append surviving the next boot.
- The server: the port's ``Server(ServerConfig(device="cpu",
  data_dir=...))`` and the reference's ``Server(ServerConfig(data_dir=...,
  use_tpu_batch_worker=True))`` take one seeded stream (the reference's
  objects converted for the port; ids drawn from a seeded sequence in
  each), snapshot, take more, register a wave whose evals stay pending,
  crash mid-frame, and restart on their directories: the restored
  content equals the pre-crash content, the torn job is absent, and the
  pending wave, re-enqueued by the leadership restore, commits what the
  reference's restored server commits.  Each reference server has its
  own ``KernelCircuitBreaker()``; ``oracle_routed`` stays 0 in both.
"""
import dataclasses
import os
import random

import numpy as np
import pytest

import nomad_tpu.ops.breaker as jbreaker
import nomad_tpu.server.eval_broker as jeval_broker
from nomad_tpu import fault as jfault
from nomad_tpu import mock as jmock
from nomad_tpu.server import Server as JServer
from nomad_tpu.server import ServerConfig as JServerConfig
from nomad_tpu.server.fsm import FSM as JFSM
from nomad_tpu.server.fsm import MessageType as JMT
from nomad_tpu.server.raft import FileLog as JFileLog
from nomad_tpu.state.state_store import VaultAccessor as JVaultAccessor
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import codec, convert, fault
from nomad_tpu_torch.ops.batch_sched import TorchBatchScheduler
from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
from nomad_tpu_torch.scheduler.testing import Harness
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server import eval_broker as peval_broker
from nomad_tpu_torch.server.fsm import FSM, MessageType
from nomad_tpu_torch.server.raft import FileLog
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.state import columnar
from nomad_tpu_torch.state.state_store import VaultAccessor
from nomad_tpu_torch.structs import structs as ps
from nomad_tpu_torch.utils.backoff import wait_until
from test_torch_columnar import scratch_mirror
from test_torch_server import (HEARTBEAT_TTL, Ids, content,
                               conv, health, make_job, park_signal, settle,
                               strip_node)

SEED = 13


def plain(v):
    """Dataclasses as dicts, recursively (lazy columns as lists)."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, ps._LazyStrs, js._LazyStrs)):
        return [plain(x) for x in v]
    return v


def strip_ref(ref, port):
    """``ref`` restricted to the keys ``port`` has, recursively (the
    reference-only fields removed)."""
    if isinstance(ref, dict) and isinstance(port, dict):
        return {k: strip_ref(ref[k], port[k]) for k in port if k in ref}
    if isinstance(ref, list) and isinstance(port, list):
        return [strip_ref(a, b) for a, b in zip(ref, port)]
    return ref


def dump(st):
    """A store's content by table, keyed by id (allocs materialized)."""
    st._materialize_pending()
    out = {
        "nodes": st.nodes_table, "jobs": st.jobs_table,
        "evals": st.evals_table, "summaries": st.job_summary_table,
        "allocs": {k: st._get_alloc(k) for k in list(st.allocs_table)},
        "periodic": st.periodic_launch_table,
        "vault": st.vault_accessors_table,
        "namespaces": st.namespaces_table,
        "indexes": st._indexes,
    }
    return plain(out)


def same_content(ref_store, port_store):
    got, want = dump(port_store), dump(ref_store)
    # Tables the port keeps only: the reference's indexes also name
    # deployments and job versions.
    want["indexes"] = {k: v for k, v in want["indexes"].items()
                       if k in got["indexes"]}
    assert got == strip_ref(want, got)


# -- the FSM's vault, periodic and namespace handlers ----------------------


def handler_stream(seed):
    rng = np.random.default_rng(seed)
    out = []
    accs = [dict(accessor=f"acc-{i}", alloc_id=f"alloc-{i % 3}",
                 node_id=f"node-{i % 2}", task="web",
                 creation_ttl=int(rng.integers(1, 100))) for i in range(6)]
    out.append(("VAULT_ACCESSOR_REGISTER", {"accessors": accs[:4]}))
    out.append(("PERIODIC_LAUNCH_UPSERT",
                {"job_id": "cron-a", "launch": float(rng.random())}))
    out.append(("NAMESPACE_UPSERT",
                {"namespace": dict(name="team-a", max_live_allocs=5,
                                   dequeue_weight=2.0)}))
    out.append(("VAULT_ACCESSOR_REGISTER", {"accessors": accs[4:]}))
    out.append(("VAULT_ACCESSOR_DEREGISTER", {"accessors": accs[1:3]}))
    out.append(("PERIODIC_LAUNCH_UPSERT",
                {"job_id": "cron-a", "launch": float(rng.random())}))
    out.append(("PERIODIC_LAUNCH_UPSERT",
                {"job_id": "cron-b", "launch": float(rng.random())}))
    out.append(("PERIODIC_LAUNCH_DELETE", {"job_id": "cron-b"}))
    out.append(("NAMESPACE_UPSERT",
                {"namespace": dict(name="team-b", api_rate=3.5)}))
    out.append(("NAMESPACE_UPSERT",
                {"namespace": dict(name="team-a", max_live_allocs=9)}))
    out.append(("NAMESPACE_DELETE", {"name": "team-b"}))
    return out


def typed(req, ref):
    req = dict(req)
    if "accessors" in req:
        cls = JVaultAccessor if ref else VaultAccessor
        req["accessors"] = [cls(**a) for a in req["accessors"]]
    if "namespace" in req:
        cls = js.Namespace if ref else ps.Namespace
        req["namespace"] = cls(**req["namespace"])
    return req


@pytest.mark.parametrize("seed", [0, 1])
def test_vault_periodic_namespace_handlers_match_the_reference(seed):
    jf, pf = JFSM(), FSM()
    seen = []
    pf.on_namespace_update = lambda name, ns: seen.append(
        (name, None if ns is None else ns.max_live_allocs))
    for index, (mt, req) in enumerate(handler_stream(seed), start=1):
        jf.apply(index, JMT[mt], typed(req, True))
        pf.apply(index, MessageType[mt], typed(req, False))
    same_content(jf.state, pf.state)
    st = pf.state
    assert sorted(a.accessor for a in st.vault_accessors_by_alloc(
        None, "alloc-0")) == ["acc-0", "acc-3"]
    assert sorted(a.accessor for a in st.vault_accessors_by_node(
        None, "node-1")) == ["acc-3", "acc-5"]
    assert [p.id for p in st.periodic_launches()] == ["cron-a"]
    assert st.periodic_launch_by_id(None, "cron-a").create_index == 2
    assert [n.name for n in st.namespaces()] == ["team-a"]
    assert seen == [("team-a", 5), ("team-b", 0), ("team-a", 9),
                    ("team-b", None)]
    # The snapshot carries the three tables.
    pf2 = FSM()
    pf2.restore(pf.snapshot())
    assert dump(pf2.state)["vault"] == dump(st)["vault"]
    assert dump(pf2.state)["periodic"] == dump(st)["periodic"]
    assert dump(pf2.state)["namespaces"] == dump(st)["namespaces"]


# -- the snapshot (tests/test_columnar.py:441-534) -------------------------


def build_store(kind="port", seed=SEED):
    """A store with nodes in three dcs, a job, its eval, one standalone
    alloc and a slab with lazy id and name columns (the reference's
    ``TestBinarySnapshot._build_store``), built in either package from
    the same seeded values."""
    rng = np.random.default_rng(seed)
    ref = kind == "ref"
    S = js if ref else ps
    st = StateStore() if not ref else __import__(
        "nomad_tpu.state", fromlist=["StateStore"]).StateStore()
    nodes = []
    for i in range(10):
        n = jmock.node()
        n.id = n.name = f"snap-node-{i}"
        n.datacenter = f"dc{i % 3}"
        n.resources.cpu = int(rng.integers(2000, 8000))
        nodes.append(n if ref else conv(n, convert.node_from_dict))
    index = 0

    def nxt():
        nonlocal index
        index += 1
        return index

    for n in nodes:
        st.upsert_node(nxt(), n)
    job = jmock.job()
    job.id = job.name = "snap-job"
    job.task_groups[0].count = 4
    if not ref:
        job = conv(job, convert.job_from_dict)
    st.upsert_job(nxt(), job)
    ev = S.Evaluation(id="snap-eval", priority=50, type="service",
                      triggered_by="job-register", job_id=job.id,
                      status="pending")
    st.upsert_evals(nxt(), [ev])
    al = S.Allocation(id="snap-alloc", eval_id=ev.id, name="snap-job.web[0]",
                      node_id=nodes[0].id, job_id=job.id, job=job,
                      task_group="web",
                      resources=S.Resources(cpu=500, memory_mb=256))
    st.upsert_allocs(nxt(), [al])
    proto = S.Allocation(eval_id=ev.id, job_id=job.id, job=job,
                         task_group="web",
                         resources=S.Resources(cpu=9, memory_mb=8,
                                               disk_mb=7))
    slab = S.AllocSlab(
        proto=proto, ids=S.LazyUuids(30, "0badc0de-0000-4000-8000-"),
        names=S.LazyNames(30, "snap-job.web"),
        node_ids=[nodes[int(k)].id for k in rng.integers(0, 10, size=30)],
        prev_ids=[])
    st.upsert_slabs(nxt(), [slab])
    return st, slab, nxt


@pytest.fixture(autouse=True)
def _counters():
    columnar.reset_counters()
    yield
    columnar.reset_counters()


@pytest.mark.parametrize("fmt", ["v2", "per-object"])
def test_snapshot_round_trips_in_both_formats(fmt):
    st, _, _ = build_store()
    st.columnar = fmt == "v2"
    blob = st.persist()
    assert (blob[:8] == StateStore.SNAP2_MAGIC) == (fmt == "v2")
    want = dump(st)
    assert dump(StateStore.restore(blob)) == want
    assert dump(StateStore.restore(blob, columnar=False)) == want
    # Cross direction: a store restored from one format persists the
    # other, which restores to the same content.
    other = StateStore.restore(blob, columnar=fmt != "v2")
    assert dump(StateStore.restore(other.persist())) == want


def test_v2_restores_slabs_lazily():
    st, slab, _ = build_store()
    restored = StateStore.restore(st.persist())
    assert restored._pending_slabs
    assert type(restored._pending_slabs[0].ids) is ps.LazyUuids
    assert restored.alloc_by_id(None, slab.ids[7]) is not None
    assert not restored._pending_slabs


def test_v2_restore_skips_dead_slab_slots():
    st, slab, nxt = build_store()
    st._materialize_pending()
    victim = slab.ids[3]
    upd = st.alloc_by_id(None, victim).copy()
    upd.client_status = ps.ALLOC_CLIENT_STATUS_FAILED
    st.update_allocs_from_client(nxt(), [upd])
    read_back = st.alloc_by_id(None, slab.ids[5])  # a cache-back
    assert read_back is not None
    blob = st.persist()
    restored = StateStore.restore(blob)
    assert len(restored._pending_slabs[0]) == 28
    ref = dump(st)
    assert dump(restored) == ref
    assert restored.alloc_by_id(
        None, victim).client_status == ps.ALLOC_CLIENT_STATUS_FAILED


def test_fsm_round_trip_installs_the_mirror_from_the_columns():
    st, _, _ = build_store()
    fsm = FSM(state=st)
    blob = fsm.snapshot()
    fsm2 = FSM()
    rebuilds = columnar.REBUILDS
    fsm2.restore(blob)
    assert dump(fsm2.state) == dump(st)
    cols = fsm2.state._columns
    assert cols is not None and columnar.REBUILDS == rebuilds
    assert cols.usage_index == st.table_index("allocs")
    want = scratch_mirror(fsm2.state)
    n = cols.n
    assert cols.node_ids[:n] == want["node_ids"]
    for k in ("cap", "res", "eligible", "dc_code", "class_code"):
        assert np.array_equal(getattr(cols, k)[:n], want[k]), k
    assert np.array_equal(fsm2.state.column_usage(cols)[:n], want["usage"])
    assert columnar.REBUILDS == rebuilds


def test_restored_store_is_a_new_lineage_with_the_log_floor_raised():
    st, _, _ = build_store()
    restored = StateStore.restore(st.persist())
    assert restored.store_uid != st.store_uid
    floor = st.table_index("allocs")
    assert restored.allocs_since(floor - 1) is None
    assert restored.allocs_since(floor) == []


def test_restored_store_keeps_scheduling_with_every_guard():
    st, _, nxt = build_store()
    restored = StateStore.restore(st.persist())
    h = Harness(restored)
    h._next_index = nxt() + 1
    job = jmock.job()
    job.id = job.name = "after-restore"
    job.task_groups[0].count = 2
    for t in job.task_groups[0].tasks:
        t.resources.networks = []
    pjob = conv(job, convert.job_from_dict)
    restored.upsert_job(h.next_index(), pjob)
    ev = ps.Evaluation(id="after-eval", priority=50, type="service",
                       job_id=pjob.id, triggered_by="job-register")
    stats = TorchBatchScheduler(
        h.logger, restored.snapshot(), h, device="cpu", rng_seed=SEED,
        breaker=KernelCircuitBreaker(),
        columnar_guard_every=1).schedule_batch([ev])
    placed = [a for a in restored.allocs_by_job(None, pjob.id, True)
              if not a.terminal_status()]
    assert len(placed) == 2 and stats.oracle_routed == 0
    assert columnar.GUARD_RUNS > 0 and columnar.GUARD_MISMATCHES == 0
    assert columnar.USAGE_GUARD_MISMATCHES == 0


def test_snapshot_of_another_schema_fails_naming_both_fingerprints():
    st, _, _ = build_store()
    blob = bytearray(st.persist())
    at = len(StateStore.SNAP2_MAGIC) + 2
    blob[at:at + 8] = b"\x01" * 8
    with pytest.raises(codec.CodecError) as e:
        StateStore.restore(bytes(blob))
    assert "0101010101010101" in str(e.value)
    assert codec.FINGERPRINT.hex() in str(e.value)


@pytest.mark.parametrize("fmt", ["v2", "per-object"])
def test_same_store_restores_alike_in_both_packages(fmt, monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_COLUMNAR", "1" if fmt == "v2" else "0")
    jst, _, _ = build_store("ref")
    pst, _, _ = build_store("port")
    pst.columnar = fmt == "v2"
    jr = type(jst).restore(jst.persist())
    pr = StateStore.restore(pst.persist())
    same_content(jr, pr)


# -- FileLog: one stream through both, crash, recover ----------------------


def log_stream(seed):
    """(message type name, reference payload, port payload) of a seeded
    stream: nodes, a job and its eval, standalone allocs, a plan with a
    lazy slab, status and drain updates, a client update."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(12):
        n = jmock.node()
        n.id = n.name = f"log-node-{i:02d}"
        n.resources.cpu = int(rng.integers(2000, 8000))
        nodes.append(n)
    job = jmock.job()
    job.id = job.name = f"log-job-{seed}"
    ev = js.Evaluation(id=f"log-eval-{seed}", priority=50, type="service",
                       triggered_by="job-register", job_id=job.id,
                       status="pending")
    allocs = []
    for k in range(3):
        a = jmock.alloc()
        a.id = f"log-alloc-{seed}-{k}"
        a.node_id = nodes[int(rng.integers(0, 12))].id
        a.job, a.job_id, a.eval_id = job, job.id, ev.id
        allocs.append(a)
    slab_nodes = [nodes[int(k)].id for k in rng.integers(0, 12, size=20)]

    def slab(S, j):
        proto = S.Allocation(eval_id=ev.id, job_id=j.id, job=j,
                             task_group="web",
                             resources=S.Resources(cpu=7, memory_mb=5))
        return S.AllocSlab(proto=proto,
                           ids=S.LazyUuids(20, "feedface-0000-4000-8000-"),
                           names=S.LazyNames(20, f"{j.id}.web"),
                           node_ids=list(slab_nodes), prev_ids=[])

    pnodes = [conv(n, convert.node_from_dict) for n in nodes]
    pjob = conv(job, convert.job_from_dict)
    pev = conv(ev, convert.eval_from_dict)
    pallocs = [conv(a, convert.alloc_from_dict) for a in allocs]
    upd = [dataclasses.replace(allocs[0], client_status="failed")]
    pupd = [dataclasses.replace(pallocs[0], client_status="failed")]
    out = [("NODE_REGISTER", {"node": n}, {"node": p})
           for n, p in zip(nodes, pnodes)]
    out += [
        ("JOB_REGISTER", {"job": job}, {"job": pjob}),
        ("EVAL_UPDATE", {"evals": [ev]}, {"evals": [pev]}),
        ("ALLOC_UPDATE", {"allocs": allocs, "job": job},
         {"allocs": pallocs, "job": pjob}),
        ("APPLY_PLAN_RESULTS",
         {"job": job, "allocs": [], "slabs": [slab(js, job)],
          "eval_id": ev.id},
         {"job": pjob, "allocs": [], "slabs": [slab(ps, pjob)],
          "eval_id": ev.id}),
        ("NODE_UPDATE_STATUS", {"node_id": nodes[3].id, "status": "down"},
         {"node_id": nodes[3].id, "status": "down"}),
        ("NODE_UPDATE_DRAIN", {"node_id": nodes[4].id, "drain": True},
         {"node_id": nodes[4].id, "drain": True}),
        ("ALLOC_CLIENT_UPDATE", {"allocs": upd}, {"allocs": pupd}),
    ]
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_filelog_crash_recovers_what_the_reference_recovers(tmp_path, seed):
    stream = log_stream(seed)
    torn_job = jmock.job()
    torn_job.id = "torn-job"
    ptorn = conv(torn_job, convert.job_from_dict)
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    jlog = JFileLog(JFSM(), d_ref, snapshot_entries=0, snapshot_bytes=0)
    plog = FileLog(FSM(), d_port, snapshot_entries=0, snapshot_bytes=0)
    assert jlog._nwal is not None and plog._nwal is not None
    for k, (mt, jreq, preq) in enumerate(stream):
        jlog.apply(JMT[mt], jreq)
        plog.apply(MessageType[mt], preq)
        if k == 9:
            jlog.snapshot()
            assert plog.snapshot()
    applied = plog.applied_index()
    assert applied == jlog.applied_index() == len(stream)
    with jfault.scenario({"seed": 3, "faults": [
            {"point": "wal.fsync", "action": "crash", "times": 1}]}):
        with pytest.raises(jfault.InjectedFault):
            jlog.apply(JMT.JOB_REGISTER, {"job": torn_job})
    with fault.scenario({"seed": 3, "faults": [
            {"point": "wal.fsync", "action": "crash", "times": 1}]}):
        with pytest.raises(fault.InjectedFault):
            plog.apply(MessageType.JOB_REGISTER, {"job": ptorn})
    # The crashed log takes nothing more.
    with pytest.raises(Exception):
        plog.apply(MessageType.JOB_REGISTER, {"job": ptorn})
    jlog.close()
    plog.close()
    torn_size = os.path.getsize(os.path.join(d_port, "wal.crc"))

    jlog2 = JFileLog(JFSM(), d_ref, snapshot_entries=0, snapshot_bytes=0)
    plog2 = FileLog(FSM(), d_port, snapshot_entries=0, snapshot_bytes=0)
    assert plog2.applied_index() == jlog2.applied_index() == applied
    assert plog2.recovery["snapshot_index"] == 10
    assert plog2.recovery["replayed_entries"] == applied - 10
    assert os.path.getsize(os.path.join(d_port, "wal.crc")) < torn_size
    assert plog2.fsm.state.job_by_id(None, "torn-job") is None
    same_content(jlog2.fsm.state, plog2.fsm.state)
    plog2.apply(MessageType.JOB_REGISTER, {"job": ptorn})
    plog2.close()
    jlog2.close()
    plog3 = FileLog(FSM(), d_port, snapshot_entries=0, snapshot_bytes=0)
    assert plog3.applied_index() == applied + 1
    assert plog3.fsm.state.job_by_id(None, "torn-job") is not None
    plog3.close()


@pytest.mark.parametrize("kind", ["crash", "error", "step_down", "delay"])
def test_raft_apply_fault_point(tmp_path, kind):
    """The ``raft.apply`` point (fault.py:46, raft.py:40-58): crash and
    error raise before the entry gets an index, step_down refuses it,
    delay only slows it; the log goes on after each."""
    from nomad_tpu_torch.server.raft import NotLeaderError

    log = FileLog(FSM(), str(tmp_path / "raft"), snapshot_entries=0,
                  snapshot_bytes=0)
    n0, n1 = jmock.node(), jmock.node()
    with fault.scenario({"seed": 1, "faults": [
            {"point": "raft.apply", "action": kind, "times": 1,
             "delay": 0.05, "match": {"msg_type": "NODE_REGISTER"}}]}):
        if kind == "delay":
            log.apply(MessageType.NODE_REGISTER,
                      {"node": conv(n0, convert.node_from_dict)})
        else:
            with pytest.raises(NotLeaderError if kind == "step_down"
                               else fault.InjectedFault):
                log.apply(MessageType.NODE_REGISTER,
                          {"node": conv(n0, convert.node_from_dict)})
        assert fault.trace() == [("raft.apply", 0, kind)]
    log.apply(MessageType.NODE_REGISTER,
              {"node": conv(n1, convert.node_from_dict)})
    want = 2 if kind == "delay" else 1
    assert log.applied_index() == want
    log.close()
    log2 = FileLog(FSM(), str(tmp_path / "raft"), snapshot_entries=0,
                   snapshot_bytes=0)
    assert log2.applied_index() == want
    log2.close()


# -- the server: crash, restart, go on (tests/test_server.py:307) ----------


class DurableWorld:
    """One server of either package on ``data_dir`` (the reference's
    objects converted for the port), ids from a seeded sequence."""

    def __init__(self, kind, mp, data_dir, id_seed):
        self.kind, self.ref = kind, kind == "ref"
        ids = Ids(id_seed)
        structs = js if self.ref else ps
        mp.setattr(structs, "generate_uuid", ids.one)
        mp.setattr(structs, "generate_uuids", ids.many)
        if self.ref:
            mp.setenv("NOMAD_TPU_RNG_SEED", str(SEED))
            mp.setenv("NOMAD_TPU_COLUMNAR", "1")
            mp.setenv("NOMAD_TPU_COLUMNAR_GUARD_EVERY", "1")
            mp.setenv("NOMAD_TPU_PREEMPTION", "0")
            mp.setenv("NOMAD_TPU_TRACE", "0")
            mp.setenv("NOMAD_TPU_EVENTS", "0")
            mp.setenv("NOMAD_TPU_FILELOG_SNAPSHOT_ENTRIES", "0")
            mp.setenv("NOMAD_TPU_FILELOG_SNAPSHOT_BYTES", "0")
            self.breaker = jbreaker.KernelCircuitBreaker()
            mp.setattr(jbreaker, "BREAKER", self.breaker)
            mp.setattr(jeval_broker, "random", random.Random(SEED))
            self.srv = JServer(JServerConfig(
                use_tpu_batch_worker=True, num_schedulers=1, batch_size=8,
                min_heartbeat_ttl=HEARTBEAT_TTL, data_dir=data_dir))
        else:
            mp.setattr(peval_broker, "random", random.Random(SEED))
            self.breaker = KernelCircuitBreaker()
            self.srv = Server(ServerConfig(
                device="cpu", rng_seed=SEED, num_schedulers=1, batch_size=8,
                min_heartbeat_ttl=HEARTBEAT_TTL, breaker=self.breaker,
                columnar=True, columnar_guard_every=1, data_dir=data_dir,
                snapshot_entries=0, snapshot_bytes=0))

    def obj(self, o, fn):
        return o if self.ref else conv(o, fn)

    def pause(self):
        if self.ref:
            parked = [park_signal(w) for w in self.srv.workers]
            for w in self.srv.workers:
                w.set_pause(True)
            assert all(ev.wait(30.0) for ev in parked)
        else:
            assert self.srv.set_workers_paused(True, timeout=30.0)

    def release(self):
        for w in self.srv.workers:
            w.set_pause(False)

    def wave(self, jobs):
        self.pause()
        for j in jobs:
            self.srv.job_register(self.obj(j, convert.job_from_dict))
        self.release()
        settle(self.srv)

    def counter(self, key):
        return self.srv.metrics.sink.latest()["CounterTotals"].get(
            f"nomad.{key}", 0)


def durable_scenario():
    rng = random.Random(SEED)
    nodes = [strip_node(jmock.node(), f"dnode-{i:03d}",
                        cpu=rng.choice([2000, 4000]),
                        mem=rng.choice([4096, 8192])) for i in range(24)]
    wave1 = [make_job("d-svc-a", 8, 500, 256),
             make_job("d-svc-b", 5, 250, 128, priority=60),
             make_job("d-bat-a", 4, 250, 256, type_="batch")]
    wave2 = [make_job("d-svc-c", 6, 100, 128)]
    wave3 = [make_job("d-svc-d", 7, 250, 256),
             make_job("d-bat-b", 3, 100, 128, type_="batch")]
    follow = [make_job("d-svc-e", 4, 100, 128)]
    torn = make_job("d-torn", 2, 100, 128)
    return nodes, wave1, wave2, wave3, follow, torn


def run_durable(kind, data_dir, scenario):
    nodes, wave1, wave2, wave3, follow, torn = scenario
    out = {}
    fp = jfault if kind == "ref" else fault
    with pytest.MonkeyPatch.context() as mp:
        w = DurableWorld(kind, mp, data_dir, SEED)
        w.srv.start()
        try:
            for n in nodes:
                w.srv.node_register(w.obj(n, convert.node_from_dict))
            w.wave(wave1)
            w.srv.raft.snapshot()
            w.wave(wave2)
            w.pause()
            down = sorted({a.node_id for a in w.srv.state.allocs(None)
                           if a.job_id == "d-svc-a"})[0]
            w.srv.node_update_status(down, "down")
            for j in wave3:
                w.srv.job_register(w.obj(j, convert.job_from_dict))
            out["applied"] = w.srv.raft.applied_index()
            out["before"] = content(w.srv)
            out["pending"] = sorted(e.job_id for e in w.srv.state.evals(None)
                                    if e.status == "pending")
            with fp.scenario({"seed": 5, "faults": [
                    {"point": "wal.fsync", "action": "crash",
                     "times": 1}]}):
                with pytest.raises(fp.InjectedFault):
                    w.srv.job_register(w.obj(torn, convert.job_from_dict))
            out["health_before"] = health(w)
        finally:
            w.srv.shutdown()
    with pytest.MonkeyPatch.context() as mp:
        w = DurableWorld(kind, mp, data_dir, SEED + 1)
        try:
            out["recovered_applied"] = w.srv.raft.applied_index()
            out["recovered"] = content(w.srv)
            out["torn_absent"] = w.srv.state.job_by_id(None,
                                                       "d-torn") is None
            w.srv.start()
            settle(w.srv)
            out["after"] = content(w.srv)
            w.wave(follow)
            out["follow"] = content(w.srv)
            out["health"] = health(w)
            out["applied_after"] = w.srv.raft.applied_index()
            w.srv.raft.snapshot()
        finally:
            w.srv.shutdown()
            if kind == "port":
                assert wait_until(lambda: not w.srv.threads(), 15.0)
    # Restart from the snapshot alone: the WAL is empty.
    with pytest.MonkeyPatch.context() as mp:
        w = DurableWorld(kind, mp, data_dir, SEED + 2)
        try:
            out["from_snapshot"] = content(w.srv)
            out["from_snapshot_applied"] = w.srv.raft.applied_index()
            if kind == "port":
                out["recovery"] = dict(w.srv.raft.recovery)
        finally:
            w.srv.raft.close()
    return out


@pytest.fixture(scope="module")
def durable_runs(tmp_path_factory):
    scenario = durable_scenario()
    root = tmp_path_factory.mktemp("durable")
    return {kind: run_durable(kind, str(root / kind), scenario)
            for kind in ("ref", "port")}


@pytest.mark.parametrize("phase", ["before", "recovered", "after",
                                   "follow", "from_snapshot"])
def test_durable_server_commits_what_the_reference_commits(durable_runs,
                                                           phase):
    ref, port = durable_runs["ref"][phase], durable_runs["port"][phase]
    assert port["allocs"] == ref["allocs"]
    assert port["evals"] == ref["evals"]
    assert port["queued"] == ref["queued"]
    if phase != "recovered":  # blocked evals are re-blocked at start
        assert port["blocked"] == ref["blocked"]


def test_restart_recovers_every_acknowledged_write(durable_runs):
    port = durable_runs["port"]
    assert port["recovered_applied"] == port["applied"]
    assert port["torn_absent"]
    before, rec = port["before"], port["recovered"]
    assert rec["allocs"] == before["allocs"]
    assert rec["evals"] == before["evals"]
    assert rec["queued"] == before["queued"]
    assert {"d-bat-b", "d-svc-d"} <= set(port["pending"])
    assert port["pending"] == durable_runs["ref"]["pending"]


def test_pending_wave_is_scheduled_after_the_restart(durable_runs):
    port = durable_runs["port"]
    live = [a for a in port["after"]["allocs"] if a[3] == "run"]
    for job_id, count in (("d-svc-d", 7), ("d-bat-b", 3)):
        assert len([a for a in live if a[0] == job_id]) == count
    assert not any(e[2] == "pending" for e in port["after"]["evals"])
    assert len([a for a in port["follow"]["allocs"]
                if a[0] == "d-svc-e" and a[3] == "run"]) == 4


def test_restart_from_the_snapshot_alone(durable_runs):
    port = durable_runs["port"]
    assert port["from_snapshot_applied"] == port["applied_after"]
    assert port["recovery"]["snapshot_index"] == port["applied_after"]
    assert port["recovery"]["replayed_entries"] == 0
    assert port["from_snapshot"]["allocs"] == port["follow"]["allocs"]
    assert port["from_snapshot"]["evals"] == port["follow"]["evals"]


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_breaker_closed_no_oracle_route_no_nack(durable_runs, kind):
    for key in ("health_before", "health"):
        assert durable_runs[kind][key] == {
            "state": "closed", "trips": 0, "oracle_routed": 0, "nacks": 0}
