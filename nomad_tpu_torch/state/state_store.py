"""The in-memory state store the batch scheduler reads (a subset of
``nomad_tpu/state/state_store.py``; reference
nomad/state/state_store.go:55-1880).

Plain dict tables plus explicit secondary indexes; every table tracks the
index of its last write, and ``snapshot()`` gives the scheduler an
isolated view (objects are immutable once inserted: every write path
inserts fresh copies).  The tables are nodes, jobs (with their alloc
summaries, which decide which incarnation's allocs ``allocs_by_job``
returns), evals and allocs.  Bulk placements are stored as the batch
scheduler makes them: one ``AllocSlab`` is the table value of each of its
alloc ids, indexed on first read and materialized into an
``Allocation`` when read by id.

Every alloc write also logs the per-node usage delta it caused (the
usage-delta feed, :meth:`StateStore.allocs_since`, state_store.py:
1315-1420), which the batch scheduler's resident usage mirror
(``ops/resident.py``) catches up from; a slab is logged once, when it is
upserted.  :meth:`StateStore.upsert_plan_results` is the commit of the
plan applier (``server/plan_apply.py``).

The store keeps the columnar mirror of its node table and live usage
(``state/columnar.py``; ``StateStore(columnar=True)``, the default): node
writes maintain it, the usage is folded from the delta feed when read,
and snapshots share it copy-on-write (:meth:`StateStore.columns`,
:meth:`StateStore.column_usage`).

Every write path publishes its events on the cluster event stream
(``server/event_broker.py``) when a broker is attached
(``StateStore.event_broker``, None by default: one attribute load and a
branch a write), after the write and outside the lock; a snapshot never
publishes (state_store.py:295).

The store also keeps the periodic launches, the vault accessors (with
their by-alloc and by-node indexes) and the namespaces, which the FSM
applies and the snapshot carries, and the per-namespace usage fold
(state_store.py:168-173): every alloc write that logs a usage delta also
folds it into its namespace's ``(cpu, memory_mb, disk_mb, iops,
live_allocs)`` row and marks the namespace dirty
(:meth:`StateStore.namespace_usage`, :meth:`StateStore.drain_ns_dirty`;
the quota ledger and the broker's DRF order read it).  The fold is
rebuilt from the rows at a restore, not persisted.

The GC path (state_store.py:962-985, :1165-1185):
:meth:`StateStore.delete_eval` removes evals and allocs (slab rows
included: pending slabs are materialized, and the ids leave every
per-node, per-job and per-eval index), logs a negative usage delta for
a non-terminal alloc, rolls the jobs' statuses (the ``eval_delete``
branch) and publishes one ``EvalDeleted`` an eval.  A job whose status
moves rolls the move into its parent's children summary;
:meth:`StateStore.reconcile_job_summaries` rebuilds the summaries from
the allocs.

Persistence (state_store.py:1966-2400): :meth:`StateStore.persist` writes
the FSM snapshot, :meth:`StateStore.restore` rebuilds a store from one.
A store with the columnar mirror writes the v2 format (``SNAP2_MAGIC``,
then one struct-codec frame of the document: the tables, the node table
struct-of-arrays, the standalone alloc rows, the slabs kept columnar and
the mirror's numeric columns); one without it writes the per-object
format (one struct-codec frame of every table).  Both restore.  The
store's lineage (``store_uid``) and the usage-delta log are not
persisted: a restored store is a new lineage whose delta-log floor sits
at the restored allocs index, so every cache keyed on the old one misses.

Left out of the copy: deployments and job version history (the snapshot
has no sections for them) and watch sets.  The ``ws`` argument of the
readers is kept for the interface and ignored.
"""
from __future__ import annotations

import bisect
import dataclasses
import threading
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..structs import structs as s
from . import columnar as columnar_mod

# Shared immutable empty result for index misses (never mutated).
_EMPTY_SET: Set[str] = set()

# The reference's default bound of the usage-delta log
# (NOMAD_TPU_ALLOC_LOG_CAP), in alloc rows: a slab entry weighs its
# length.
ALLOC_LOG_CAP = 262_144


@dataclass
class PeriodicLaunch:
    """The last launch time of a periodic job (state_store.py:49)."""

    id: str = ""
    launch: float = 0.0
    create_index: int = 0
    modify_index: int = 0


@dataclass
class VaultAccessor:
    """A derived Vault token's accessor (state_store.py:59)."""

    accessor: str = ""
    alloc_id: str = ""
    node_id: str = ""
    task: str = ""
    creation_ttl: int = 0
    create_index: int = 0


class StateStore:
    """The authoritative in-memory database of cluster state."""

    # The cluster event stream's broker: attached by the Server when the
    # stream is armed, None otherwise.  A class attribute, so snapshots
    # made through __new__ read None.
    event_broker = None

    def __init__(self, alloc_log_cap: int = ALLOC_LOG_CAP,
                 columnar: bool = True) -> None:
        self._lock = threading.RLock()
        # Store-lineage id: snapshots inherit it, distinct stores differ;
        # table indexes are only comparable within one lineage (the batch
        # scheduler's cluster cache keys on both).
        self.store_uid: str = s.generate_uuid()
        self.nodes_table: Dict[str, s.Node] = {}
        self.jobs_table: Dict[str, s.Job] = {}
        self.job_summary_table: Dict[str, s.JobSummary] = {}
        self.evals_table: Dict[str, s.Evaluation] = {}
        self.allocs_table: Dict[str, s.Allocation] = {}
        self.periodic_launch_table: Dict[str, PeriodicLaunch] = {}
        self.vault_accessors_table: Dict[str, VaultAccessor] = {}
        self.namespaces_table: Dict[str, s.Namespace] = {}
        self._indexes: Dict[str, int] = {}
        # The per-namespace usage fold: immutable (cpu, mem_mb, disk_mb,
        # iops, live_allocs) tuples kept at the same sites that feed the
        # usage-delta log, and the namespaces changed since the last
        # drain_ns_dirty (the broker's DRF feed).
        self._ns_usage: Dict[str, Tuple[int, int, int, int, int]] = {}
        self._ns_dirty: Set[str] = set()
        # Secondary indexes (schema.go secondary memdb indexes).
        self._allocs_by_node: Dict[str, object] = defaultdict(set)
        self._allocs_by_job: Dict[str, object] = defaultdict(set)
        self._allocs_by_eval: Dict[str, object] = defaultdict(set)
        self._evals_by_job: Dict[str, object] = defaultdict(set)
        self._vault_by_alloc: Dict[str, object] = defaultdict(set)
        self._vault_by_node: Dict[str, object] = defaultdict(set)
        # Slabs whose by-id rows and per-node index cells are not built
        # yet: a bulk commit never reads them back in the same batch, so
        # the per-alloc indexing lands on the first reader that needs it.
        self._pending_slabs: List[s.AllocSlab] = []
        self._pending_by_job: Dict[str, List[s.AllocSlab]] = {}
        # The usage-delta log: entries (index, node_id, (cpu, mem, disk,
        # iops)) for single rows and (index, slab) for slab inserts
        # (expanded at read), appended in index order.  allocs_since(i)
        # answers None for i < the floor, the highest index whose deltas
        # are no longer all present.  Snapshots share the list behind a
        # length cursor: the parent's appends land past it, a write by a
        # snapshot copies its prefix first, and a trim replaces the list
        # object, so no snapshot ever sees another world's deltas.
        self.alloc_log_cap = alloc_log_cap
        self._alloc_log: List[tuple] = []
        self._alloc_log_len = 0
        self._alloc_log_owned = True
        self._alloc_log_floor = 0
        self._alloc_log_weight = 0
        # The columnar mirror (state/columnar.py; the reference's
        # NOMAD_TPU_COLUMNAR is ``columnar``): None until built, or after
        # a structural change dropped it; the owner rebuilds it at its
        # next snapshot() or columns().
        self.columnar = columnar
        self._columns: Optional[columnar_mod.ClusterColumns] = None

    # -- snapshot ----------------------------------------------------------

    def snapshot(self) -> "StateSnapshot":
        """A point-in-time view (state_store.go:55)."""
        with self._lock:
            snap = StateSnapshot.__new__(StateSnapshot)
            snap._lock = threading.RLock()
            snap.store_uid = self.store_uid
            snap.nodes_table = dict(self.nodes_table)
            snap.jobs_table = dict(self.jobs_table)
            snap.job_summary_table = dict(self.job_summary_table)
            snap.evals_table = dict(self.evals_table)
            snap.allocs_table = dict(self.allocs_table)
            snap.periodic_launch_table = dict(self.periodic_launch_table)
            snap.vault_accessors_table = dict(self.vault_accessors_table)
            snap.namespaces_table = dict(self.namespaces_table)
            # The fold's values are immutable tuples: a shallow copy is a
            # full fork, and a snapshot's writes never dirty the parent.
            snap._ns_usage = dict(self._ns_usage)
            snap._ns_dirty = set(self._ns_dirty)
            snap._indexes = dict(self._indexes)
            # Index values are immutable by contract (the mutators
            # replace them), so a shallow dict copy is a full fork.
            snap._allocs_by_node = defaultdict(set, self._allocs_by_node)
            snap._allocs_by_job = defaultdict(set, self._allocs_by_job)
            snap._allocs_by_eval = defaultdict(set, self._allocs_by_eval)
            snap._evals_by_job = defaultdict(set, self._evals_by_job)
            snap._vault_by_alloc = defaultdict(set, self._vault_by_alloc)
            snap._vault_by_node = defaultdict(set, self._vault_by_node)
            snap._pending_slabs = list(self._pending_slabs)
            snap._pending_by_job = {k: list(v)
                                    for k, v in self._pending_by_job.items()}
            # The delta log: shared behind this store's length cursor
            # (state_store.py:260-268).
            snap.alloc_log_cap = self.alloc_log_cap
            snap._alloc_log = self._alloc_log
            snap._alloc_log_len = self._alloc_log_len
            snap._alloc_log_owned = False
            snap._alloc_log_floor = self._alloc_log_floor
            snap._alloc_log_weight = self._alloc_log_weight
            # The columnar mirror: an O(1) share behind copy-on-write
            # (state_store.py:269-278), built here on first use so it
            # warms on the owning store and outlives the snapshot.
            snap.columnar = self.columnar
            snap._columns = None
            if self.columnar:
                cols = self._ensure_columns_locked()
                if cols is not None:
                    self._col_fold_if_stale(cols)
                    snap._columns = cols.share()
            # The ready-node memo (scheduler/util.ready_nodes_in_dcs) is
            # shared by every snapshot cut from the same node table; a
            # node write drops only the writer's reference (_bump).
            snap._ready_nodes_cache = self.__dict__.setdefault(
                "_ready_nodes_cache", {})
            # Writes to a snapshot (job plan dry runs, scheduler harness
            # worlds) are hypothetical: they never publish events.
            snap.event_broker = None
            return snap

    # -- the columnar mirror ------------------------------------------------

    def _ensure_columns_locked(self) -> Optional[columnar_mod.ClusterColumns]:
        """The mirror, built cold when it is absent or of an old epoch.
        A snapshot never builds one: the mirror warms on the owning
        store, not on a per-batch view.  The caller holds the lock."""
        cols = self._columns
        if cols is not None and cols.epoch == columnar_mod.EPOCH:
            return cols
        if isinstance(self, StateSnapshot):
            return None
        self._columns = columnar_mod.ClusterColumns.build(self)
        return self._columns

    def columns(self) -> Optional[columnar_mod.ClusterColumns]:
        """The columnar node and usage mirror, or None when it is off or
        unavailable (the callers walk the objects then)."""
        if not self.columnar:
            return None
        with self._lock:
            return self._ensure_columns_locked()

    def column_usage(self, cols: columnar_mod.ClusterColumns) -> np.ndarray:
        """``cols``' usage matrix caught up with this store's alloc writes
        (the delta feed; a full row walk on a feed gap).  Rows at or past
        ``cols.n`` are padding."""
        with self._lock:
            if not cols.fold_usage(self):
                cols.rebuild_usage(self)
            return cols.usage

    #: Log entries past the owner's usage cursor beyond which snapshot()
    #: folds the owner forward before sharing.  Folding at every snapshot
    #: would copy [n, 4] for batches that never read usage; never folding
    #: lets the cursor fall below the log's trim floor, and every read
    #: would then rebuild from a full row walk.
    COL_FOLD_BACKLOG = 4096

    def _col_fold_if_stale(self, cols: columnar_mod.ClusterColumns) -> None:
        """The owner's usage cursor kept near the log's head at snapshot
        time (the caller holds the lock), so each view's fold stays
        O(recent)."""
        if cols.usage_index < self._alloc_log_floor:
            cols.rebuild_usage(self)
            return
        start = bisect.bisect_right(self._alloc_log, cols.usage_index,
                                    0, self._alloc_log_len,
                                    key=lambda e: e[0])
        if self._alloc_log_len - start > self.COL_FOLD_BACKLOG:
            if not cols.fold_usage(self):
                cols.rebuild_usage(self)

    def _col_node_upserted(self, node: s.Node,
                           existing: Optional[s.Node]) -> None:
        """upsert_node's hook (the caller holds the lock): append or
        update the node's row.  A datacenter or computed-class change of
        an existing node could reorder the first-seen codebooks: it drops
        the mirror instead."""
        cols = self._columns
        if cols is None:
            return
        if existing is None:
            # Fold BEFORE appending: the backfill reads the tables' truth
            # for this node, so its pending log entries must land first
            # or they would count twice.
            if not cols.fold_usage(self):
                cols.rebuild_usage(self)
            row = cols.append_node(node)
            self._col_backfill_usage(cols, node.id, row)
        elif not cols.update_node(node):
            self._columns = None

    @staticmethod
    def _slab_node_set(slab: s.AllocSlab) -> frozenset:
        """A slab's node ids as a set, built once and kept on the slab
        (its node ids never change after the insert)."""
        ns = getattr(slab, "_node_set", None)
        if ns is None:
            ns = frozenset(slab.node_ids)
            slab._node_set = ns
        return ns

    def _col_backfill_usage(self, cols: columnar_mod.ClusterColumns,
                            node_id: str, row: int) -> None:
        """A node registered after allocs that name it: its fresh usage
        row is seeded from the live rows already in the tables (the walk
        counts them)."""
        # Pending slabs are indexed only when one of them places on this
        # node, so a registration does not drain a large pending slab.
        if self._pending_slabs and any(
                node_id in self._slab_node_set(slab)
                for slab in self._pending_slabs):
            self._materialize_pending()
        ids = self._idx_get(self._allocs_by_node, node_id)
        if not ids:
            return
        c = m = d = io = 0
        for aid in ids:
            v = self.allocs_table.get(aid)
            if v is None:
                continue
            r = v.proto if type(v) is s.AllocSlab else v
            if r.terminal_status():
                continue
            vec = s.alloc_usage_vec(r)
            c += vec[0]
            m += vec[1]
            d += vec[2]
            io += vec[3]
        cols.usage[row] = (c, m, d, io)

    # -- secondary index values ---------------------------------------------
    #
    # A value is either a set or a cons cell ``(parent, item_or_items)``
    # appended in O(1) by a bulk commit; readers flatten it once through
    # _idx_get and write the set back.

    @staticmethod
    def _idx_get(idx: Dict[str, object], key: str) -> Set[str]:
        cur = idx.get(key)
        if cur is None:
            return _EMPTY_SET
        if type(cur) is set:
            return cur
        out: Set[str] = set()
        stack = [cur]
        while stack:
            v = stack.pop()
            if v is None:
                continue
            if type(v) is set:
                out |= v
            else:  # cons cell (parent, item_or_items)
                stack.append(v[0])
                items = v[1]
                if type(items) is str:
                    out.add(items)
                else:
                    out.update(items)
        idx[key] = out
        return out

    @classmethod
    def _idx_add(cls, idx: Dict[str, object], key: str, item: str) -> None:
        cur = cls._idx_get(idx, key)
        idx[key] = {item} if not cur else cur | {item}

    @classmethod
    def _idx_discard(cls, idx: Dict[str, object], key: str,
                     item: str) -> None:
        cur = cls._idx_get(idx, key)
        if item in cur:
            idx[key] = cur - {item}

    @staticmethod
    def _idx_append(idx: Dict[str, object], key: str, items) -> None:
        """O(1) bulk append of ids that are all new (an id or a sequence,
        possibly a lazy column that must not materialize here)."""
        cur = idx.get(key)
        if cur is None and type(items) is str:
            idx[key] = {items}
        else:
            idx[key] = (cur, items)

    # -- index bookkeeping -------------------------------------------------

    def _bump(self, table: str, index: int) -> None:
        self._indexes[table] = index
        if table == "nodes":
            # Node writes are the only thing that changes the ready-node
            # memo.
            self.__dict__.pop("_ready_nodes_cache", None)

    def table_index(self, table: str) -> int:
        with self._lock:
            return self._indexes.get(table, 0)

    def latest_index(self) -> int:
        with self._lock:
            return max(self._indexes.values(), default=0)

    def fingerprint(self) -> str:
        """A digest of the replicated core state (state_store.py:579):
        nodes, jobs, allocs and evals, by the fields the log stamps.  Two
        stores that applied the same committed prefix return the same hex
        string, whoever led.  Call it on a snapshot taken at an entry
        boundary (``Server.consistent_snapshot``)."""
        import hashlib

        h = hashlib.sha256()

        def w(*parts) -> None:
            h.update("\x1f".join(str(p) for p in parts).encode())
            h.update(b"\x1e")

        for n in sorted(self.nodes(None), key=lambda x: x.id):
            w("node", n.id, n.status, int(n.drain), n.modify_index)
        for j in sorted(self.jobs(None), key=lambda x: x.id):
            w("job", j.id, int(j.stop), j.version, j.modify_index)
        for a in sorted(self.allocs(None), key=lambda x: x.id):
            w("alloc", a.id, a.name, a.job_id, a.node_id, a.task_group,
              a.desired_status, a.client_status, a.modify_index)
        for e in sorted(self.evals(None), key=lambda x: x.id):
            w("eval", e.id, e.status, e.job_id, e.modify_index)
        return h.hexdigest()

    # -- lazy slab resolution ---------------------------------------------

    def _materialize_pending(self) -> None:
        """Build the by-id rows and per-node index cells of every pending
        slab."""
        pending = self._pending_slabs
        if not pending:
            return
        self._pending_slabs = []
        self._pending_by_job = {}
        self._drain_slabs(pending)

    def _drain_slabs(self, slabs) -> None:
        table = self.allocs_table
        by_node = self._allocs_by_node
        get = by_node.get
        for slab in slabs:
            ids = slab.ids
            if type(ids) is not list:
                ids = list(ids)
                slab.ids = ids
            for nid, aid in zip(slab.node_ids, ids):
                cur = get(nid)
                by_node[nid] = {aid} if cur is None else (cur, aid)
            for aid in ids:
                table[aid] = slab

    def _materialize_job_pending(self, job_id: str) -> None:
        """Drain ``job_id``'s pending slabs only, leaving the others
        deferred."""
        slabs = self._pending_by_job.pop(job_id, None)
        if not slabs:
            return
        gone = {id(sl) for sl in slabs}
        self._pending_slabs = [sl for sl in self._pending_slabs
                               if id(sl) not in gone]
        self._drain_slabs(slabs)

    def _get_alloc(self, alloc_id: str) -> Optional[s.Allocation]:
        """allocs_table read with slab materialization and cache-back.
        The caller holds the lock."""
        v = self.allocs_table.get(alloc_id)
        if v is None and self._pending_slabs:
            self._materialize_pending()
            v = self.allocs_table.get(alloc_id)
        if type(v) is s.AllocSlab:
            v = v.materialize(v.id_index(alloc_id))
            self.allocs_table[alloc_id] = v
        return v

    # -- nodes -------------------------------------------------------------

    def upsert_node(self, index: int, node: s.Node) -> None:
        """(state_store.go:413); keeps create_index on update."""
        with self._lock:
            existing = self.nodes_table.get(node.id)
            node = node.copy()
            node.create_index = (existing.create_index
                                 if existing is not None else index)
            node.modify_index = index
            self.nodes_table[node.id] = node
            self._col_node_upserted(node, existing)
            self._bump("nodes", index)
        eb = self.event_broker
        if eb is not None:
            eb.publish_one(
                s.TOPIC_NODE,
                "NodeRegistered" if existing is None else "NodeUpdated",
                node.id, index,
                {"Status": node.status, "Datacenter": node.datacenter})

    def delete_node(self, index: int, node_id: str) -> None:
        """(state_store.go:446).  A delete shifts every later row: the
        mirror is dropped and rebuilt by the owner at its next
        snapshot() or columns()."""
        with self._lock:
            if node_id not in self.nodes_table:
                raise KeyError(f"node not found: {node_id}")
            del self.nodes_table[node_id]
            self._columns = None
            self._bump("nodes", index)
        eb = self.event_broker
        if eb is not None:
            eb.publish_one(s.TOPIC_NODE, "NodeDeregistered", node_id, index)

    def update_node_status(self, index: int, node_id: str,
                           status: str) -> None:
        """(state_store.go:473)."""
        with self._lock:
            existing = self.nodes_table.get(node_id)
            if existing is None:
                raise KeyError(f"node not found: {node_id}")
            node = existing.copy()
            node.status = status
            node.modify_index = index
            self.nodes_table[node_id] = node
            if self._columns is not None:
                self._columns.set_eligible(node_id, node.ready())
            self._bump("nodes", index)
        eb = self.event_broker
        if eb is not None:
            eb.publish_one(s.TOPIC_NODE, "NodeStatusUpdated", node_id, index,
                           {"Status": status, "Previous": existing.status})

    def update_node_drain(self, index: int, node_id: str,
                          drain: bool) -> None:
        """(state_store.go:508)."""
        with self._lock:
            existing = self.nodes_table.get(node_id)
            if existing is None:
                raise KeyError(f"node not found: {node_id}")
            node = existing.copy()
            node.drain = drain
            node.modify_index = index
            self.nodes_table[node_id] = node
            if self._columns is not None:
                self._columns.set_eligible(node_id, node.ready())
            self._bump("nodes", index)
        eb = self.event_broker
        if eb is not None:
            eb.publish_one(s.TOPIC_NODE, "NodeDrainUpdated", node_id, index,
                           {"Drain": drain})

    def node_by_id(self, ws, node_id: str) -> Optional[s.Node]:
        with self._lock:
            return self.nodes_table.get(node_id)

    def nodes(self, ws=None) -> List[s.Node]:
        with self._lock:
            return list(self.nodes_table.values())

    # -- jobs --------------------------------------------------------------

    def upsert_job(self, index: int, job: s.Job) -> None:
        """(state_store.go:585): bumps the version on change and keeps the
        job summary."""
        with self._lock:
            job = job.copy()
            existing = self.jobs_table.get(job.id)
            if existing is not None:
                job.create_index = existing.create_index
                job.version = existing.version + 1
            else:
                job.create_index = index
                job.version = 0
            job.modify_index = index
            job.job_modify_index = index
            job.status = self._get_job_status(job, eval_delete=False)
            self._update_summary_with_job(index, job)
            self.jobs_table[job.id] = job
            self._bump("jobs", index)
        eb = self.event_broker
        if eb is not None:
            eb.publish_one(s.TOPIC_JOB, "JobRegistered", job.id, index,
                           {"Type": job.type, "Status": job.status,
                            "Version": job.version, "Stop": job.stop,
                            "Namespace": job.namespace})

    def delete_job(self, index: int, job_id: str) -> None:
        """(state_store.go:653): removes the job, its summary and its
        periodic launch."""
        with self._lock:
            if job_id not in self.jobs_table:
                raise KeyError(f"job not found: {job_id}")
            del self.jobs_table[job_id]
            self.job_summary_table.pop(job_id, None)
            self.periodic_launch_table.pop(job_id, None)
            self._bump("jobs", index)
            self._bump("job_summary", index)
        eb = self.event_broker
        if eb is not None:
            eb.publish_one(s.TOPIC_JOB, "JobDeregistered", job_id, index)

    def job_by_id(self, ws, job_id: str) -> Optional[s.Job]:
        with self._lock:
            return self.jobs_table.get(job_id)

    def jobs(self, ws=None) -> List[s.Job]:
        with self._lock:
            return list(self.jobs_table.values())

    def job_summary_by_id(self, ws, job_id: str) -> Optional[s.JobSummary]:
        with self._lock:
            return self.job_summary_table.get(job_id)

    def jobs_by_scheduler(self, ws, sched_type: str) -> List[s.Job]:
        """Every job of one scheduler type (the server's node evals reach
        each system job through it)."""
        with self._lock:
            return [j for j in self.jobs_table.values()
                    if j.type == sched_type]

    def jobs_by_id_prefix(self, ws, prefix: str) -> List[s.Job]:
        with self._lock:
            return [j for jid, j in self.jobs_table.items()
                    if jid.startswith(prefix)]

    def jobs_by_periodic(self, ws, periodic: bool) -> List[s.Job]:
        with self._lock:
            return [j for j in self.jobs_table.values()
                    if j.is_periodic() == periodic]

    def jobs_by_gc(self, ws, gc: bool) -> List[s.Job]:
        """Jobs by whether GC may reap them: batch jobs and the children
        of periodic and parameterized jobs (state_store.py:801)."""
        with self._lock:
            return [j for j in self.jobs_table.values()
                    if (j.type == s.JOB_TYPE_BATCH or j.parent_id != "")
                    == gc]

    def _update_summary_with_job(self, index: int, job: s.Job) -> None:
        """Create or extend the summary when a job is upserted
        (state_store.go:2159)."""
        summary = self.job_summary_table.get(job.id)
        if summary is None:
            summary = s.JobSummary(job_id=job.id, create_index=index)
        else:
            summary = summary.copy()
        changed = False
        for tg in job.task_groups:
            if tg.name not in summary.summary:
                summary.summary[tg.name] = s.TaskGroupSummary()
                changed = True
        if changed or summary.modify_index == 0:
            summary.modify_index = index
            self.job_summary_table[job.id] = summary
            self._bump("job_summary", index)

    # -- periodic launches -------------------------------------------------

    def upsert_periodic_launch(self, index: int,
                               launch: PeriodicLaunch) -> None:
        """(state_store.go:1003); keeps create_index on update."""
        with self._lock:
            existing = self.periodic_launch_table.get(launch.id)
            launch = PeriodicLaunch(
                launch.id, launch.launch,
                existing.create_index if existing else index, index)
            self.periodic_launch_table[launch.id] = launch
            self._bump("periodic_launch", index)

    def delete_periodic_launch(self, index: int, job_id: str) -> None:
        with self._lock:
            self.periodic_launch_table.pop(job_id, None)
            self._bump("periodic_launch", index)

    def periodic_launch_by_id(self, ws,
                              job_id: str) -> Optional[PeriodicLaunch]:
        with self._lock:
            return self.periodic_launch_table.get(job_id)

    def periodic_launches(self, ws=None) -> List[PeriodicLaunch]:
        with self._lock:
            return list(self.periodic_launch_table.values())

    # -- vault accessors ---------------------------------------------------

    def upsert_vault_accessors(self, index: int,
                               accessors: List[VaultAccessor]) -> None:
        with self._lock:
            for acc in accessors:
                acc = dataclasses.replace(acc, create_index=index)
                self.vault_accessors_table[acc.accessor] = acc
                self._idx_add(self._vault_by_alloc, acc.alloc_id,
                              acc.accessor)
                self._idx_add(self._vault_by_node, acc.node_id,
                              acc.accessor)
            self._bump("vault_accessors", index)

    def delete_vault_accessors(self, index: int,
                               accessors: List[VaultAccessor]) -> None:
        with self._lock:
            for acc in accessors:
                stored = self.vault_accessors_table.pop(acc.accessor, None)
                if stored is not None:
                    self._idx_discard(self._vault_by_alloc, stored.alloc_id,
                                      acc.accessor)
                    self._idx_discard(self._vault_by_node, stored.node_id,
                                      acc.accessor)
            self._bump("vault_accessors", index)

    def vault_accessors(self, ws=None) -> List[VaultAccessor]:
        with self._lock:
            return list(self.vault_accessors_table.values())

    def vault_accessor(self, ws, accessor: str) -> Optional[VaultAccessor]:
        with self._lock:
            return self.vault_accessors_table.get(accessor)

    def vault_accessors_by_alloc(self, ws,
                                 alloc_id: str) -> List[VaultAccessor]:
        with self._lock:
            table = self.vault_accessors_table
            return [table[a]
                    for a in self._idx_get(self._vault_by_alloc, alloc_id)
                    if a in table]

    def vault_accessors_by_node(self, ws,
                                node_id: str) -> List[VaultAccessor]:
        with self._lock:
            table = self.vault_accessors_table
            return [table[a]
                    for a in self._idx_get(self._vault_by_node, node_id)
                    if a in table]

    # -- namespaces --------------------------------------------------------

    def upsert_namespace(self, index: int, ns: s.Namespace) -> None:
        """A tenant registered or updated (the NAMESPACE_UPSERT apply)."""
        with self._lock:
            ns = ns.copy()
            existing = self.namespaces_table.get(ns.name)
            ns.create_index = (existing.create_index
                               if existing is not None else index)
            ns.modify_index = index
            self.namespaces_table[ns.name] = ns
            self._bump("namespaces", index)
        eb = self.event_broker
        if eb is not None:
            eb.publish_one(s.TOPIC_NAMESPACE, "NamespaceUpserted", ns.name,
                           index,
                           {"Namespace": ns.name,
                            "DequeueWeight": ns.dequeue_weight,
                            "MaxLiveAllocs": ns.max_live_allocs,
                            "MaxPendingEvals": ns.max_pending_evals})

    def delete_namespace(self, index: int, name: str) -> None:
        with self._lock:
            if self.namespaces_table.pop(name, None) is not None:
                self._bump("namespaces", index)
        eb = self.event_broker
        if eb is not None:
            eb.publish_one(s.TOPIC_NAMESPACE, "NamespaceDeleted", name,
                           index, {"Namespace": name})

    def namespace_by_name(self, ws, name: str) -> Optional[s.Namespace]:
        with self._lock:
            return self.namespaces_table.get(name)

    def namespaces(self, ws=None) -> List[s.Namespace]:
        with self._lock:
            return list(self.namespaces_table.values())

    # -- evals -------------------------------------------------------------

    def upsert_evals(self, index: int, evals: List[s.Evaluation]) -> None:
        """(state_store.go:1123): also syncs queued counts into the
        summaries and cancels blocked evals a successful one obsoletes."""
        with self._lock:
            jobs: Dict[str, str] = {}
            for ev in evals:
                self._nested_upsert_eval(index, ev)
                jobs.setdefault(ev.job_id, "")
            self._set_job_statuses(index, jobs, eval_delete=False)
            self._bump("evals", index)
        eb = self.event_broker
        if eb is not None:
            eb.publish([eb.make_event(
                s.TOPIC_EVAL, "EvalUpdated", ev.id, index,
                {"Status": ev.status, "JobID": ev.job_id,
                 "TriggeredBy": ev.triggered_by, "NodeID": ev.node_id,
                 "Namespace": ev.namespace},
                eval_id=ev.id) for ev in evals])

    def _nested_upsert_eval(self, index: int, ev: s.Evaluation) -> None:
        ev = ev.copy()
        existing = self.evals_table.get(ev.id)
        ev.create_index = (existing.create_index if existing is not None
                           else index)
        ev.modify_index = index

        summary = self.job_summary_table.get(ev.job_id)
        if summary is not None and ev.queued_allocations:
            summary = summary.copy()
            changed = False
            for tg, num in ev.queued_allocations.items():
                tgs = summary.summary.get(tg)
                if tgs is not None and tgs.queued != num:
                    tgs.queued = num
                    changed = True
            if changed:
                summary.modify_index = index
                self.job_summary_table[ev.job_id] = summary
                self._bump("job_summary", index)

        # A successful eval cancels the job's blocked evals.
        if ev.status == s.EVAL_STATUS_COMPLETE and not ev.failed_tg_allocs:
            for eid in list(self._idx_get(self._evals_by_job, ev.job_id)):
                blocked = self.evals_table.get(eid)
                if (blocked is not None
                        and blocked.status == s.EVAL_STATUS_BLOCKED):
                    cancelled = blocked.copy()
                    cancelled.status = s.EVAL_STATUS_CANCELLED
                    cancelled.status_description = (
                        f"evaluation {ev.id!r} successful")
                    cancelled.modify_index = index
                    self.evals_table[eid] = cancelled

        self.evals_table[ev.id] = ev
        self._idx_add(self._evals_by_job, ev.job_id, ev.id)

    def delete_eval(self, index: int, eval_ids: List[str],
                    alloc_ids: List[str]) -> None:
        """(state_store.go:1235) The GC path: evals and their allocs out
        of the store, the jobs' statuses rolled with ``eval_delete``, and
        one ``EvalDeleted`` an eval."""
        deleted: List[str] = []
        with self._lock:
            jobs: Dict[str, str] = {}
            for eid in eval_ids:
                ev = self.evals_table.pop(eid, None)
                if ev is None:
                    continue
                self._idx_discard(self._evals_by_job, ev.job_id, eid)
                jobs.setdefault(ev.job_id, "")
                deleted.append(eid)
            for aid in alloc_ids:
                self._remove_alloc(aid, index)
            self._bump("evals", index)
            self._bump("allocs", index)
            self._set_job_statuses(index, jobs, eval_delete=True)
        eb = self.event_broker
        if eb is not None and deleted:
            eb.publish([eb.make_event(s.TOPIC_EVAL, "EvalDeleted", eid,
                                      index, eval_id=eid)
                        for eid in deleted])

    def eval_by_id(self, ws, eval_id: str) -> Optional[s.Evaluation]:
        with self._lock:
            return self.evals_table.get(eval_id)

    def evals_by_job(self, ws, job_id: str) -> List[s.Evaluation]:
        with self._lock:
            return [self.evals_table[eid]
                    for eid in self._idx_get(self._evals_by_job, job_id)
                    if eid in self.evals_table]

    def evals(self, ws=None) -> List[s.Evaluation]:
        with self._lock:
            return list(self.evals_table.values())

    # -- allocs ------------------------------------------------------------

    def upsert_allocs(self, index: int, allocs: List[s.Allocation],
                      owned: bool = False) -> None:
        """(state_store.go:1435).  ``owned=True``: the caller hands the
        objects over (a plan commit makes fresh allocs) and the store
        inserts them as they are."""
        eb = self.event_broker
        events: Optional[List[s.Event]] = [] if eb is not None else None
        with self._lock:
            self._upsert_allocs_impl(index, allocs, owned, events=events)
        if events:
            eb.publish(events)

    @staticmethod
    def _alloc_event_type(alloc: s.Allocation,
                          existing: Optional[s.Allocation]) -> str:
        """Event type for one alloc write: the transition an operator
        cares about, not the table mechanics."""
        if alloc.client_status == s.ALLOC_CLIENT_STATUS_LOST:
            return "AllocLost"
        if alloc.desired_status == s.ALLOC_DESIRED_STATUS_EVICT:
            return "AllocEvicted"
        if alloc.desired_status == s.ALLOC_DESIRED_STATUS_STOP:
            return "AllocStopped"
        if existing is None:
            return "AllocPlaced"
        return "AllocUpdated"

    def _upsert_allocs_impl(self, index: int, allocs: List[s.Allocation],
                            owned: bool = False,
                            events: Optional[List[s.Event]] = None,
                            plan_eval_id: str = "") -> None:
        """``events`` (a list, when a broker is attached) collects one
        event per alloc; ``plan_eval_id`` is the plan's driving eval,
        which a stop or eviction keeps off the alloc row itself."""
        eb = self.event_broker
        jobs: Dict[str, str] = {}
        summary_cache: Dict[str, s.JobSummary] = {}
        # Index additions of fresh allocs are batched per key: one O(1)
        # cons per touched key instead of a set union per alloc.
        new_by_node: Dict[str, List[str]] = {}
        new_by_job: Dict[str, List[str]] = {}
        new_by_eval: Dict[str, List[str]] = {}
        for alloc in allocs:
            if not owned:
                alloc = s._fast_copy(alloc)
            existing = self._get_alloc(alloc.id)
            alloc.modify_index = index
            alloc.alloc_modify_index = index
            if existing is None:
                alloc.create_index = index
            else:
                alloc.create_index = existing.create_index
                # The client is the authority on these fields, except when
                # the scheduler marks the alloc lost
                # (state_store.go:1480-1489).
                alloc.task_states = existing.task_states
                if alloc.client_status != s.ALLOC_CLIENT_STATUS_LOST:
                    alloc.client_status = existing.client_status
                    alloc.client_description = existing.client_description
            self._update_summary_with_alloc(index, alloc, existing,
                                            summary_cache)
            if alloc.job is None and existing is not None:
                alloc.job = existing.job
            self._log_transition(index, existing, alloc)
            self.allocs_table[alloc.id] = alloc
            if events is not None:
                events.append(eb.make_event(
                    s.TOPIC_ALLOC, self._alloc_event_type(alloc, existing),
                    alloc.id, index,
                    {"JobID": alloc.job_id, "NodeID": alloc.node_id,
                     "TaskGroup": alloc.task_group,
                     "DesiredStatus": alloc.desired_status,
                     "ClientStatus": alloc.client_status,
                     "Namespace": alloc.namespace},
                    eval_id=plan_eval_id or alloc.eval_id))
            if existing is None:
                new_by_node.setdefault(alloc.node_id, []).append(alloc.id)
                new_by_job.setdefault(alloc.job_id, []).append(alloc.id)
                new_by_eval.setdefault(alloc.eval_id, []).append(alloc.id)
            else:
                if alloc.node_id != existing.node_id:
                    self._idx_add(self._allocs_by_node, alloc.node_id,
                                  alloc.id)
                if alloc.job_id != existing.job_id:
                    self._idx_add(self._allocs_by_job, alloc.job_id,
                                  alloc.id)
                if alloc.eval_id != existing.eval_id:
                    self._idx_add(self._allocs_by_eval, alloc.eval_id,
                                  alloc.id)
            if alloc.job is not None:
                forced = ("" if alloc.terminal_status()
                          else s.JOB_STATUS_RUNNING)
                jobs[alloc.job_id] = jobs.get(alloc.job_id) or forced
        for idx_dict, new_ids in ((self._allocs_by_node, new_by_node),
                                  (self._allocs_by_job, new_by_job),
                                  (self._allocs_by_eval, new_by_eval)):
            for key, ids in new_ids.items():
                self._idx_append(idx_dict, key,
                                 ids[0] if len(ids) == 1 else ids)
        self._set_job_statuses(index, jobs, eval_delete=False)
        self._bump("allocs", index)

    def update_allocs_from_client(self, index: int,
                                  allocs: List[s.Allocation]) -> None:
        """Merge the client-authoritative fields (status, description,
        task states) into the stored allocs (state_store.go:1367)."""
        eb = self.event_broker
        events: Optional[List[s.Event]] = [] if eb is not None else None
        with self._lock:
            for client_alloc in allocs:
                existing = self._get_alloc(client_alloc.id)
                if existing is None:
                    continue
                updated = s._fast_copy(existing)
                updated.client_status = client_alloc.client_status
                updated.client_description = client_alloc.client_description
                updated.task_states = {
                    k: v.copy() for k, v in client_alloc.task_states.items()}
                updated.modify_index = index
                self._update_summary_with_alloc(index, updated, existing)
                self._log_transition(index, existing, updated)
                self.allocs_table[client_alloc.id] = updated
                if events is not None:
                    events.append(eb.make_event(
                        s.TOPIC_ALLOC, "AllocClientUpdated", updated.id,
                        index,
                        {"JobID": updated.job_id, "NodeID": updated.node_id,
                         "ClientStatus": updated.client_status,
                         "Previous": existing.client_status},
                        eval_id=updated.eval_id))
                forced = ("" if updated.terminal_status()
                          else s.JOB_STATUS_RUNNING)
                self._set_job_statuses(index, {existing.job_id: forced},
                                       eval_delete=False)
            self._bump("allocs", index)
        if events:
            eb.publish(events)

    def _remove_alloc(self, alloc_id: str, index: int = 0) -> None:
        """One alloc out of the table and its indexes (the caller holds
        the lock); a slab's id leaves its slab's row behind for the
        others.  A live alloc's usage leaves the delta log and the fold."""
        if self._pending_slabs:
            self._materialize_pending()
        alloc = self.allocs_table.pop(alloc_id, None)
        if alloc is None:
            return
        if type(alloc) is s.AllocSlab:
            node_id = alloc.node_ids[alloc.id_index(alloc_id)]
            row = alloc.proto
        else:
            node_id, row = alloc.node_id, alloc
        if index and not row.terminal_status():
            c, m, d, i = s.alloc_usage_vec(row)
            self._log_usage(index, node_id, (-c, -m, -d, -i))
            self._ns_fold(row.namespace, -c, -m, -d, -i, -1)
        self._idx_discard(self._allocs_by_node, node_id, alloc_id)
        self._idx_discard(self._allocs_by_job, row.job_id, alloc_id)
        self._idx_discard(self._allocs_by_eval, row.eval_id, alloc_id)

    def alloc_by_id(self, ws, alloc_id: str) -> Optional[s.Allocation]:
        with self._lock:
            return self._get_alloc(alloc_id)

    def allocs_by_node(self, ws, node_id: str) -> List[s.Allocation]:
        with self._lock:
            if self._pending_slabs:
                self._materialize_pending()
            return [self._get_alloc(aid)
                    for aid in self._idx_get(self._allocs_by_node, node_id)
                    if aid in self.allocs_table]

    def allocs_by_node_terminal(self, ws, node_id: str,
                                terminal: bool) -> List[s.Allocation]:
        """(state_store.go:1592): the scheduler's proposed-allocs source."""
        return [a for a in self.allocs_by_node(ws, node_id)
                if a.terminal_status() == terminal]

    def allocs_by_job(self, ws, job_id: str,
                      all_allocs: bool = False) -> List[s.Allocation]:
        """(state_store.go:1615).  Without ``all_allocs``, allocs of an
        earlier incarnation of a re-registered job are filtered out by
        the summary's create_index."""
        with self._lock:
            if self._pending_slabs:
                self._materialize_job_pending(job_id)
            out = [self._get_alloc(aid)
                   for aid in self._idx_get(self._allocs_by_job, job_id)
                   if aid in self.allocs_table]
            if all_allocs:
                return out
            summary = self.job_summary_table.get(job_id)
            if summary is None:
                return out
            return [a for a in out if a.job is None
                    or a.job.create_index == summary.create_index]

    def allocs_by_eval(self, ws, eval_id: str) -> List[s.Allocation]:
        with self._lock:
            if self._pending_slabs:
                self._materialize_pending()
            return [self._get_alloc(aid)
                    for aid in self._idx_get(self._allocs_by_eval, eval_id)
                    if aid in self.allocs_table]

    def allocs(self, ws=None) -> List[s.Allocation]:
        with self._lock:
            if self._pending_slabs:
                self._materialize_pending()
            return [self._get_alloc(aid) for aid in list(self.allocs_table)]

    # -- rows without materialization (batch encode) -----------------------
    #
    # The batch scheduler needs only (node id, resources, status) of each
    # alloc to encode usage; a slab's allocs are read as (node id, the
    # slab's shared prototype).  Rows are read-only.

    def alloc_rows(self, ws=None) -> List[Tuple[str, s.Allocation]]:
        """(node_id, row) for every alloc."""
        with self._lock:
            out = []
            for slab in self._pending_slabs:
                proto = slab.proto
                for nid in slab.node_ids:
                    out.append((nid, proto))
            seen_slabs = set()
            table = self.allocs_table
            for v in table.values():
                if type(v) is s.AllocSlab:
                    if id(v) in seen_slabs:
                        continue
                    seen_slabs.add(id(v))
                    # Ids whose table entry was replaced (an update) are
                    # read through their own entry.
                    proto = v.proto
                    for i, aid in enumerate(v.ids):
                        if table.get(aid) is v:
                            out.append((v.node_ids[i], proto))
                else:
                    out.append((v.node_id, v))
            return out

    def alloc_rows_by_job(self, ws, job_id: str
                          ) -> List[Tuple[str, s.Allocation]]:
        """(node_id, row) for one job's allocs."""
        with self._lock:
            out = []
            for slab in self._pending_by_job.get(job_id, ()):
                proto = slab.proto
                for nid in slab.node_ids:
                    out.append((nid, proto))
            for aid in self._idx_get(self._allocs_by_job, job_id):
                v = self.allocs_table.get(aid)
                if v is None:
                    continue
                if type(v) is s.AllocSlab:
                    out.append((v.node_ids[v.id_index(aid)], v.proto))
                else:
                    out.append((v.node_id, v))
            return out

    # -- the usage-delta feed ----------------------------------------------
    #
    # The caller of every _log_* helper holds the lock.  The vectors are
    # on the structs.alloc_usage_vec basis, so a consumer replaying the
    # feed lands on the rows a full walk gives.

    def _log_ensure_owned(self) -> None:
        """A snapshot's first write takes a private copy of its log
        prefix, so the parent's feed never sees a dry run's deltas."""
        if not self._alloc_log_owned:
            self._alloc_log = self._alloc_log[:self._alloc_log_len]
            self._alloc_log_owned = True

    def _log_trim(self) -> None:
        """Past the cap, drop the oldest entries down to half of it and
        raise the floor to the last dropped index; the survivors are a
        new list, so cursors into the old one stay valid."""
        if self._alloc_log_weight <= self.alloc_log_cap:
            return
        target = self.alloc_log_cap // 2
        log = self._alloc_log
        drop = 0
        while drop < len(log) and self._alloc_log_weight > target:
            entry = log[drop]
            self._alloc_log_weight -= (len(entry[1].ids)
                                       if len(entry) == 2 else 1)
            self._alloc_log_floor = max(self._alloc_log_floor, entry[0])
            drop += 1
        self._alloc_log = log[drop:]
        self._alloc_log_len = len(self._alloc_log)

    def _log_usage(self, index: int, node_id: str,
                   delta: Tuple[int, int, int, int]) -> None:
        if delta == (0, 0, 0, 0) or not node_id:
            return
        self._log_ensure_owned()
        self._alloc_log.append((index, node_id, delta))
        self._alloc_log_len += 1
        self._alloc_log_weight += 1
        self._log_trim()

    def _log_slab(self, index: int, slab: s.AllocSlab) -> None:
        if not slab.ids:
            return
        self._log_ensure_owned()
        self._alloc_log.append((index, slab))
        self._alloc_log_len += 1
        self._alloc_log_weight += len(slab.ids)
        self._log_trim()
        # The fold: one update a slab, its n live rows sharing the
        # prototype's usage.
        proto = slab.proto
        if not proto.terminal_status():
            n = len(slab.ids)
            c, m, d, i = s.alloc_usage_vec(proto)
            self._ns_fold(proto.namespace, c * n, m * n, d * n, i * n, n)

    def _log_transition(self, index: int, existing: Optional[s.Allocation],
                        updated: s.Allocation) -> None:
        """The usage delta of one alloc write (old row -> new row), node
        moves included."""
        old_live = existing is not None and not existing.terminal_status()
        new_live = not updated.terminal_status()
        vec = s.alloc_usage_vec
        if old_live and new_live and existing.node_id == updated.node_id:
            ov, nv = vec(existing), vec(updated)
            self._log_usage(index, updated.node_id,
                            (nv[0] - ov[0], nv[1] - ov[1],
                             nv[2] - ov[2], nv[3] - ov[3]))
            if nv != ov:
                self._ns_fold(updated.namespace, nv[0] - ov[0],
                              nv[1] - ov[1], nv[2] - ov[2], nv[3] - ov[3],
                              0)
            return
        if old_live:
            c, m, d, i = vec(existing)
            self._log_usage(index, existing.node_id, (-c, -m, -d, -i))
            self._ns_fold(existing.namespace, -c, -m, -d, -i, -1)
        if new_live:
            v = vec(updated)
            self._log_usage(index, updated.node_id, v)
            self._ns_fold(updated.namespace, v[0], v[1], v[2], v[3], 1)

    # -- the per-namespace usage fold ----------------------------------------

    def namespace_usage(self) -> Dict[str, Tuple[int, int, int, int, int]]:
        """(cpu, mem_mb, disk_mb, iops, live_allocs) of every namespace
        (state_store.py:1601)."""
        with self._lock:
            return dict(self._ns_usage)

    def namespace_usage_one(
            self, name: str) -> Tuple[int, int, int, int, int]:
        """One namespace's row: the quota check's read."""
        with self._lock:
            return self._ns_usage.get(name or s.DEFAULT_NAMESPACE,
                                      (0, 0, 0, 0, 0))

    def drain_ns_dirty(self) -> Set[str]:
        """The namespaces whose usage changed since the last drain."""
        with self._lock:
            dirty = self._ns_dirty
            self._ns_dirty = set()
            return dirty

    def _ns_fold(self, ns: str, dc: int, dm: int, dd: int, di: int,
                 dn: int) -> None:
        """One alloc write's delta into its namespace's row (the caller
        holds the lock)."""
        key = ns or s.DEFAULT_NAMESPACE
        cur = self._ns_usage.get(key, (0, 0, 0, 0, 0))
        self._ns_usage[key] = (cur[0] + dc, cur[1] + dm, cur[2] + dd,
                               cur[3] + di, cur[4] + dn)
        self._ns_dirty.add(key)

    def _rebuild_ns_usage(self) -> None:
        """The fold recomputed from the alloc rows (the restore path)."""
        usage: Dict[str, Tuple[int, int, int, int, int]] = {}
        for _nid, row in self.alloc_rows():
            if row.terminal_status():
                continue
            c, m, d, i = s.alloc_usage_vec(row)
            key = row.namespace or s.DEFAULT_NAMESPACE
            cur = usage.get(key, (0, 0, 0, 0, 0))
            usage[key] = (cur[0] + c, cur[1] + m, cur[2] + d, cur[3] + i,
                          cur[4] + 1)
        with self._lock:
            self._ns_usage = usage
            self._ns_dirty = set(usage)

    def allocs_since(self, index: int
                     ) -> Optional[List[Tuple[str, Tuple[int, int, int,
                                                         int]]]]:
        """``(node_id, usage delta)`` of every alloc write with an index
        above ``index``, in write order; None when the log can no longer
        answer (``index`` fell below the trim floor).  A slab expands to
        one entry per node it places on."""
        with self._lock:
            if index < self._alloc_log_floor:
                return None
            # The log's indexes never decrease: bisect to the first entry
            # past ``index``, and read no further than this store's
            # cursor (a shared list may have grown past it).
            log, n = self._alloc_log, self._alloc_log_len
            start = bisect.bisect_right(log, index, 0, n,
                                        key=lambda e: e[0])
            out: List[Tuple[str, Tuple[int, int, int, int]]] = []
            for entry in log[start:n]:
                if len(entry) == 2:
                    slab = entry[1]
                    c, m, d, i = s.alloc_usage_vec(slab.proto)
                    for nid, cnt in slab.node_counts().items():
                        out.append((nid, (c * cnt, m * cnt, d * cnt,
                                          i * cnt)))
                else:
                    out.append((entry[1], entry[2]))
            return out

    # -- plan application ----------------------------------------------------

    def upsert_plan_results(self, index: int, job: Optional[s.Job],
                            allocs: List[s.Allocation],
                            slabs: Optional[List[s.AllocSlab]] = None,
                            eval_id: str = "") -> None:
        """Commit a plan's result (state_store.go:89): the plan's job
        onto its live allocs and slab prototypes that carry none, the
        combined resources of an alloc that has only per-task ones, then
        the upsert (the store owns the allocs from here on).  ``eval_id``
        is the plan's driving eval: a stop or eviction keeps its
        placement eval on the alloc row, so the event stream takes the
        driving one from here."""
        eb = self.event_broker
        events: Optional[List[s.Event]] = [] if eb is not None else None
        with self._lock:
            for alloc in allocs:
                if alloc.job is None and not alloc.terminal_status():
                    alloc.job = job
                if alloc.resources is None:
                    total = s.Resources()
                    for task_res in alloc.task_resources.values():
                        total.add(task_res)
                    total.add(alloc.shared_resources)
                    alloc.resources = total
            self._upsert_allocs_impl(index, allocs, owned=True,
                                     events=events, plan_eval_id=eval_id)
            if slabs:
                for slab in slabs:
                    p = slab.proto
                    if p.job is None and not p.terminal_status():
                        p.job = job
                self._upsert_slabs_impl(index, slabs, events=events)
        if events:
            eb.publish(events)

    # -- bulk placements ---------------------------------------------------

    def upsert_slabs(self, index: int, slabs: List[s.AllocSlab]) -> None:
        """Bulk columnar insert of fresh placements (the batch scheduler's
        plans)."""
        eb = self.event_broker
        events: Optional[List[s.Event]] = [] if eb is not None else None
        with self._lock:
            self._upsert_slabs_impl(index, slabs, events=events)
        if events:
            eb.publish(events)

    def _upsert_slabs_impl(self, index: int, slabs: List[s.AllocSlab],
                           events: Optional[List[s.Event]] = None) -> None:
        """The table value of each alloc id is the slab itself; the
        per-alloc work is deferred to the first reader, the summary and
        job status are updated once per slab, and so is the event: one
        ``AllocPlacedBulk`` a slab, not one a placement."""
        jobs: Dict[str, str] = {}
        for slab in slabs:
            ids = slab.ids
            if not ids:
                continue
            slab.create_index = index
            slab.modify_index = index
            proto = slab.proto
            self._idx_append(self._allocs_by_job, proto.job_id, ids)
            self._idx_append(self._allocs_by_eval, proto.eval_id, ids)
            # One log entry a slab, now: indexing the slab later
            # (_materialize_pending) logs nothing.
            self._log_slab(index, slab)
            self._pending_slabs.append(slab)
            self._pending_by_job.setdefault(proto.job_id, []).append(slab)
            if events is not None:
                events.append(self.event_broker.make_event(
                    s.TOPIC_ALLOC, "AllocPlacedBulk", proto.job_id, index,
                    {"JobID": proto.job_id, "TaskGroup": proto.task_group,
                     "Count": len(ids), "Namespace": proto.namespace},
                    eval_id=proto.eval_id))
            self._update_summary_bulk(index, proto, len(ids))
            if proto.job is not None:
                forced = ("" if proto.terminal_status()
                          else s.JOB_STATUS_RUNNING)
                jobs[proto.job_id] = jobs.get(proto.job_id) or forced
        self._set_job_statuses(index, jobs, eval_delete=False)
        self._bump("allocs", index)

    def _update_summary_bulk(self, index: int, proto: s.Allocation,
                             n: int) -> None:
        """``n`` fresh pending allocs of one (job, task group)."""
        job = proto.job
        if job is None:
            return
        summary = self.job_summary_table.get(proto.job_id)
        if summary is None or summary.create_index != job.create_index:
            return
        if (proto.task_group not in summary.summary
                or proto.client_status != s.ALLOC_CLIENT_STATUS_PENDING):
            return
        summary = summary.copy()
        tgs = summary.summary[proto.task_group]
        tgs.starting += n
        tgs.queued = max(0, tgs.queued - n)
        summary.modify_index = index
        self.job_summary_table[proto.job_id] = summary
        self._bump("job_summary", index)

    # -- job status --------------------------------------------------------

    def _set_job_statuses(self, index: int, jobs: Dict[str, str],
                          eval_delete: bool) -> None:
        """(state_store.go:1968)."""
        for job_id, forced in jobs.items():
            job = self.jobs_table.get(job_id)
            if job is None:
                continue
            self._set_job_status(index, job, eval_delete, forced)

    _CHILD_STATUS = {s.JOB_STATUS_PENDING: "pending",
                     s.JOB_STATUS_RUNNING: "running",
                     s.JOB_STATUS_DEAD: "dead"}

    def _set_job_status(self, index: int, job: s.Job, eval_delete: bool,
                        forced: str) -> None:
        """(state_store.go:1993): the job's new status, rolled into its
        parent's children summary."""
        old_status = job.status if index != job.create_index else ""
        new_status = forced or self._get_job_status(job, eval_delete)
        if old_status == new_status:
            return
        updated = job.copy()
        updated.status = new_status
        updated.modify_index = index
        self.jobs_table[job.id] = updated
        self._bump("jobs", index)
        if not updated.parent_id:
            return
        psummary = self.job_summary_table.get(updated.parent_id)
        if psummary is None:
            return
        psummary = psummary.copy()
        if psummary.children is None:
            psummary.children = s.JobChildrenSummary()
        ch = psummary.children
        f = self._CHILD_STATUS.get(old_status)
        if f is not None:
            setattr(ch, f, getattr(ch, f) - 1)
        f = self._CHILD_STATUS.get(new_status)
        if f is not None:
            setattr(ch, f, getattr(ch, f) + 1)
        psummary.modify_index = index
        self.job_summary_table[updated.parent_id] = psummary
        self._bump("job_summary", index)

    def _get_job_status(self, job: s.Job, eval_delete: bool) -> str:
        """(state_store.go:2092)."""
        has_alloc = False
        for slab in self._pending_by_job.get(job.id, ()):
            has_alloc = True
            if not slab.proto.terminal_status():
                return s.JOB_STATUS_RUNNING
        for aid in self._idx_get(self._allocs_by_job, job.id):
            alloc = self.allocs_table.get(aid)
            if alloc is None:
                continue
            if type(alloc) is s.AllocSlab:
                alloc = alloc.proto
            has_alloc = True
            if not alloc.terminal_status():
                return s.JOB_STATUS_RUNNING

        has_eval = False
        for eid in self._idx_get(self._evals_by_job, job.id):
            ev = self.evals_table.get(eid)
            if ev is None:
                continue
            has_eval = True
            if not ev.terminal_status():
                return s.JOB_STATUS_PENDING

        if job.type == s.JOB_TYPE_SYSTEM:
            return s.JOB_STATUS_DEAD if job.stop else s.JOB_STATUS_RUNNING
        if eval_delete or has_eval or has_alloc:
            return s.JOB_STATUS_DEAD
        if job.is_periodic() or job.is_parameterized():
            return s.JOB_STATUS_DEAD if job.stop else s.JOB_STATUS_RUNNING
        return s.JOB_STATUS_PENDING

    def _update_summary_with_alloc(
        self, index: int, alloc: s.Allocation,
        existing: Optional[s.Allocation],
        cache: Optional[Dict[str, s.JobSummary]] = None,
    ) -> None:
        """(state_store.go:2296).  ``cache`` copies each job's summary
        once per bulk upsert."""
        if alloc.job is None:
            return
        summary = cache.get(alloc.job_id) if cache is not None else None
        if summary is None:
            summary = self.job_summary_table.get(alloc.job_id)
            if summary is None:
                return
            if summary.create_index != alloc.job.create_index:
                return
            summary = summary.copy()
            if cache is not None:
                cache[alloc.job_id] = summary
        tgs = summary.summary.get(alloc.task_group)
        if tgs is None:
            return

        changed = False
        if existing is None:
            if alloc.client_status == s.ALLOC_CLIENT_STATUS_PENDING:
                tgs.starting += 1
                if tgs.queued > 0:
                    tgs.queued -= 1
                changed = True
        elif existing.client_status != alloc.client_status:
            inc = {
                s.ALLOC_CLIENT_STATUS_RUNNING: "running",
                s.ALLOC_CLIENT_STATUS_FAILED: "failed",
                s.ALLOC_CLIENT_STATUS_PENDING: "starting",
                s.ALLOC_CLIENT_STATUS_COMPLETE: "complete",
                s.ALLOC_CLIENT_STATUS_LOST: "lost",
            }
            dec = {
                s.ALLOC_CLIENT_STATUS_RUNNING: "running",
                s.ALLOC_CLIENT_STATUS_PENDING: "starting",
                s.ALLOC_CLIENT_STATUS_LOST: "lost",
            }
            if alloc.client_status in inc:
                f = inc[alloc.client_status]
                setattr(tgs, f, getattr(tgs, f) + 1)
            if existing.client_status in dec:
                f = dec[existing.client_status]
                setattr(tgs, f, getattr(tgs, f) - 1)
            changed = True

        if changed:
            summary.modify_index = index
            self.job_summary_table[alloc.job_id] = summary
            self._bump("job_summary", index)

    def reconcile_job_summaries(self, index: int) -> None:
        """Every summary rebuilt from the allocs (state_store.go:1883)."""
        with self._lock:
            if self._pending_slabs:
                self._materialize_pending()
            for job in list(self.jobs_table.values()):
                summary = s.JobSummary(job_id=job.id,
                                       create_index=job.create_index,
                                       modify_index=index)
                for tg in job.task_groups:
                    summary.summary[tg.name] = s.TaskGroupSummary()
                for aid in self._idx_get(self._allocs_by_job, job.id):
                    alloc = self.allocs_table.get(aid)
                    if type(alloc) is s.AllocSlab:
                        alloc = alloc.proto
                    if (alloc is None
                            or alloc.task_group not in summary.summary):
                        continue
                    tgs = summary.summary[alloc.task_group]
                    cs = alloc.client_status
                    if cs == s.ALLOC_CLIENT_STATUS_FAILED:
                        tgs.failed += 1
                    elif cs == s.ALLOC_CLIENT_STATUS_LOST:
                        tgs.lost += 1
                    elif cs == s.ALLOC_CLIENT_STATUS_COMPLETE:
                        tgs.complete += 1
                    elif cs == s.ALLOC_CLIENT_STATUS_RUNNING:
                        tgs.running += 1
                    elif cs == s.ALLOC_CLIENT_STATUS_PENDING:
                        tgs.starting += 1
                self.job_summary_table[job.id] = summary
            self._bump("job_summary", index)

    # -- persistence (the FSM snapshot) ------------------------------------

    #: The v2 format's magic (state_store.py:1973).  The per-object format
    #: starts with the codec frame's magic byte, never an ASCII "N", so an
    #: 8-byte sniff tells the two apart.
    SNAP2_MAGIC = b"NTPUSNP2"

    def persist(self) -> bytes:
        """Serialize every table for an FSM snapshot (fsm.go:568).  A
        store with the columnar mirror writes the v2 format, one without
        it the per-object format; both restore."""
        if self.columnar:
            return self._persist_columnar()
        return self._persist_legacy()

    @staticmethod
    def _slab_col_spec(col):
        """The snapshot form of one slab string column: a lazy column
        stays its prefix and count (the codec's value tree carries lazy
        columns as such), a list is one packed string column."""
        if isinstance(col, s._LazyStrs):
            return col
        return _pack_str_col(list(col))

    @staticmethod
    def _slab_col_load(v):
        if isinstance(v, s._LazyStrs):
            return v
        return _unpack_str_col(v)

    def _persist_columnar(self) -> bytes:
        """v2 (state_store.py:2004): ``SNAP2_MAGIC`` and one struct-codec
        frame of the document {tables, nodes as struct-of-arrays,
        standalone alloc rows, columnar slabs, the mirror's numeric
        columns}.  Slabs are not materialized: each proto is written
        once, its string columns as columns (lazy ones as their prefix
        and count), and restore installs them as pending slabs.  Job
        trees shared by alloc rows and protos are written once, by
        identity.  The reference's envelope is a msgpack map; the port
        has no msgpack, so the envelope is the codec frame itself."""
        from ..server.log_codec import encode_payload

        with self._lock:
            shared = _SharedRefs()
            ref_job = shared.jobs.ref
            table = self.allocs_table
            allocs_out: Dict[str, s.Allocation] = {}
            slab_docs: List[dict] = []
            seen_slabs: Set[int] = set()

            def slab_doc(slab: s.AllocSlab, dead: List[int]) -> dict:
                proto = slab.proto
                jr = None
                if proto.job is not None:
                    jr = ref_job(proto.job)
                    proto = s._fast_copy(proto)
                    proto.job = None
                return {"proto": proto, "job_ref": jr,
                        "ids": self._slab_col_spec(slab.ids),
                        "names": self._slab_col_spec(slab.names),
                        "node_ids": self._slab_col_spec(slab.node_ids),
                        "prev_ids": self._slab_col_spec(slab.prev_ids),
                        "ci": slab.create_index, "mi": slab.modify_index,
                        "dead": dead}

            for aid, v in table.items():
                if type(v) is s.AllocSlab:
                    if id(v) in seen_slabs:
                        continue
                    seen_slabs.add(id(v))
                    # Slots whose table entry was replaced (a client
                    # update, a read's cache-back, a stop) persist through
                    # their own row.
                    dead = [i for i, aid2 in enumerate(v.ids)
                            if table.get(aid2) is not v]
                    slab_docs.append(slab_doc(v, dead))
                else:
                    allocs_out[aid] = shared.strip(aid, v)
            # Pending slabs are disjoint from the table's values and have
            # no replaced slots.
            for slab in self._pending_slabs:
                slab_docs.append(slab_doc(slab, []))

            doc = {
                "tables": {
                    "jobs": self.jobs_table,
                    "job_summary": self.job_summary_table,
                    "evals": self.evals_table,
                    "periodic_launch": self.periodic_launch_table,
                    "vault_accessors": self.vault_accessors_table,
                    "namespaces": self.namespaces_table,
                    "indexes": self._indexes,
                },
                "nodes": _node_soa(list(self.nodes_table.values())),
                "allocs": {"rows": allocs_out, **shared.doc()},
                "slabs": slab_docs,
                "columns": None, "colmeta": None,
            }
            # The mirror's numeric columns, caught up with the allocs,
            # ride along when their rows are the node table's, so the
            # restored store encodes without a cold build.
            cols = self._ensure_columns_locked()
            if (cols is not None and cols.n == len(self.nodes_table)
                    and cols.node_ids[:cols.n]
                    == list(self.nodes_table)):
                if not cols.fold_usage(self):
                    cols.rebuild_usage(self)
                doc["columns"] = columnar_mod.pack_columns(cols)
                doc["colmeta"] = {
                    "dc": list(cols.dc_codebook()),
                    "class": list(cols.class_codebook()),
                    "usage_index": cols.usage_index}
            return self.SNAP2_MAGIC + encode_payload(doc, "snapshot")

    def _persist_legacy(self) -> bytes:
        """The per-object format (state_store.py:2157): every table as
        objects, slabs materialized into plain alloc rows for the blob
        only, shared job trees written once by identity."""
        from ..server.log_codec import encode_payload

        with self._lock:
            if self._pending_slabs:
                self._materialize_pending()
            shared = _SharedRefs()
            allocs_out: Dict[str, s.Allocation] = {}
            for aid, v in self.allocs_table.items():
                a = (v.materialize(v.id_index(aid))
                     if type(v) is s.AllocSlab else v)
                allocs_out[aid] = shared.strip(aid, a)
            return encode_payload({
                "nodes": self.nodes_table,
                "jobs": self.jobs_table,
                "job_summary": self.job_summary_table,
                "evals": self.evals_table,
                "allocs": allocs_out,
                "alloc_shared": shared.doc(),
                "periodic_launch": self.periodic_launch_table,
                "vault_accessors": self.vault_accessors_table,
                "namespaces": self.namespaces_table,
                "indexes": self._indexes,
            }, "snapshot")

    @classmethod
    def restore(cls, blob: bytes, alloc_log_cap: int = ALLOC_LOG_CAP,
                columnar: bool = True) -> "StateStore":
        """A store (and its secondary indexes) rebuilt from a snapshot
        (fsm.go:582 Restore), of either format (the v2 magic is
        sniffed).  The store is a new lineage (a fresh ``store_uid``);
        the usage-delta log starts empty with its floor at the restored
        allocs index, so every consumer from before the restore does a
        full re-encode."""
        if blob[:len(cls.SNAP2_MAGIC)] == cls.SNAP2_MAGIC:
            store = cls._restore_columnar(blob, alloc_log_cap, columnar)
        else:
            store = cls._restore_legacy(blob, alloc_log_cap, columnar)
        store._alloc_log_floor = store._indexes.get("allocs", 0)
        store._rebuild_ns_usage()
        return store

    def _restore_common(self, t: dict) -> None:
        self.jobs_table = t["jobs"]
        self.job_summary_table = t["job_summary"]
        self.evals_table = t["evals"]
        self.periodic_launch_table = t["periodic_launch"]
        self.vault_accessors_table = t["vault_accessors"]
        self.namespaces_table = t["namespaces"]
        self._indexes = t["indexes"]
        for ev in self.evals_table.values():
            self._evals_by_job[ev.job_id].add(ev.id)
        for acc in self.vault_accessors_table.values():
            self._vault_by_alloc[acc.alloc_id].add(acc.accessor)
            self._vault_by_node[acc.node_id].add(acc.accessor)

    def _restore_rows(self, rows: Dict[str, s.Allocation],
                      shared: dict) -> None:
        """Install standalone alloc rows, their job trees and placement
        metrics re-attached (one shared object a ref, as they were
        shared when persisted)."""
        self.allocs_table = rows
        _SharedRefs.attach(rows, shared)
        for alloc in rows.values():
            self._allocs_by_node[alloc.node_id].add(alloc.id)
            self._allocs_by_job[alloc.job_id].add(alloc.id)
            self._allocs_by_eval[alloc.eval_id].add(alloc.id)

    @classmethod
    def _restore_legacy(cls, blob: bytes, alloc_log_cap: int,
                        columnar: bool) -> "StateStore":
        from ..server.log_codec import decode_payload

        payload = decode_payload(blob, "snapshot")
        store = cls(alloc_log_cap=alloc_log_cap, columnar=columnar)
        store.nodes_table = payload["nodes"]
        store._restore_common(payload)
        store._restore_rows(payload["allocs"], payload["alloc_shared"])
        return store

    @classmethod
    def _restore_columnar(cls, blob: bytes, alloc_log_cap: int,
                          columnar: bool) -> "StateStore":
        """v2 restore (state_store.py:2260): node objects rebuilt from the
        struct-of-arrays without ``__init__``, slabs installed as pending
        (their per-alloc rows and node-index cells are built on first
        read, dead slots left out), and the mirror installed from the
        column section (``columnar.unpack_columns``), not rebuilt by a
        walk over the nodes."""
        from ..server.log_codec import decode_payload

        doc = decode_payload(blob[len(cls.SNAP2_MAGIC):], "snapshot")
        store = cls(alloc_log_cap=alloc_log_cap, columnar=columnar)
        store._restore_common(doc["tables"])
        ids = _restore_nodes(store.nodes_table, doc["nodes"])

        a = doc["allocs"]
        alloc_jobs = a["jobs"]
        store._restore_rows(a["rows"], a)

        for sd in doc["slabs"]:
            proto = sd["proto"]
            jr = sd["job_ref"]
            if jr is not None and 0 <= jr < len(alloc_jobs):
                proto.job = alloc_jobs[jr]
            cols = [cls._slab_col_load(sd[k])
                    for k in ("ids", "names", "node_ids", "prev_ids")]
            dead = sd["dead"]
            if dead:
                deadset = set(dead)
                keep = [i for i in range(len(cols[0])) if i not in deadset]
                cols = [[c[i] for i in keep] for c in cols[:3]] + [
                    [cols[3][i] for i in keep] if cols[3] else []]
            slab = s.AllocSlab(proto=proto, ids=cols[0], names=cols[1],
                               node_ids=cols[2], prev_ids=cols[3],
                               create_index=sd["ci"], modify_index=sd["mi"])
            if not len(slab):
                continue
            store._pending_slabs.append(slab)
            store._pending_by_job.setdefault(proto.job_id, []).append(slab)
            store._idx_append(store._allocs_by_job, proto.job_id, slab.ids)
            store._idx_append(store._allocs_by_eval, proto.eval_id,
                              slab.ids)

        if columnar and doc["columns"] is not None:
            cm = doc["colmeta"]
            store._columns = columnar_mod.unpack_columns(
                doc["columns"], ids, cm["dc"], cm["class"],
                cm["usage_index"])
        return store


class StateSnapshot(StateStore):
    """A point-in-time view; writes to a snapshot do not reach the parent
    store."""


# -- snapshot helpers ----------------------------------------------------------


class _Refs:
    """Objects shared by identity, each written once: ``ref(obj)`` is its
    position in ``items``."""

    def __init__(self) -> None:
        self.items: list = []
        self._by_id: Dict[int, int] = {}

    def ref(self, obj) -> int:
        r = self._by_id.get(id(obj))
        if r is None:
            r = self._by_id[id(obj)] = len(self.items)
            self.items.append(obj)
        return r


class _SharedRefs:
    """The job trees and placement metrics that alloc rows share: a batch
    gives every alloc of one placement spec the same ``AllocMetric``
    (its scores run to one entry a placement) and the same ``Job``, so a
    row is written without them and with a reference to the one copy
    (the reference dedupes the jobs only; its rows each carry their
    metric)."""

    def __init__(self) -> None:
        self.jobs, self.metrics = _Refs(), _Refs()
        self.job_refs: Dict[str, int] = {}
        self.metric_refs: Dict[str, int] = {}

    def strip(self, aid: str, a: s.Allocation) -> s.Allocation:
        if a.job is None and a.metrics is None:
            return a
        a = s._fast_copy(a)
        if a.job is not None:
            self.job_refs[aid] = self.jobs.ref(a.job)
            a.job = None
        if a.metrics is not None:
            self.metric_refs[aid] = self.metrics.ref(a.metrics)
            a.metrics = None
        return a

    def doc(self) -> dict:
        return {"jobs": self.jobs.items, "refs": self.job_refs,
                "metrics": self.metrics.items,
                "metric_refs": self.metric_refs}

    @staticmethod
    def attach(rows: Dict[str, s.Allocation], doc: dict) -> None:
        for key, refs, attr in (("jobs", "refs", "job"),
                                ("metrics", "metric_refs", "metrics")):
            objs = doc[key]
            for aid, r in doc[refs].items():
                row = rows.get(aid)
                if row is not None and 0 <= r < len(objs):
                    setattr(row, attr, objs[r])

_NODE_STR_FIELDS = ("datacenter", "name", "node_class", "computed_class",
                    "status", "status_description")
_ZERO4 = (0, 0, 0, 0)


def _pack_str_col(values: List[str]) -> bytes:
    """A string column as one bytes value: the varint count, then the
    packed strings (``codec/native.pack_strs``)."""
    from ..codec import gen, native

    w = bytearray()
    gen._uv(w, len(values))
    w += native.pack_strs(values)
    return bytes(w)


def _unpack_str_col(b: bytes) -> List[str]:
    from ..codec import gen, native

    n, p = gen._duv(b, 0)
    out, end = native.unpack_strs(b, p, n)
    if end != len(b):
        raise gen.CodecError("trailing bytes after a string column")
    return out


def _intern_col(values, key=None) -> dict:
    """A column of few distinct values: the distinct values in first-seen
    order and an int32 array of references into them (``key`` makes an
    unhashable value hashable)."""
    keys = values if key is None else list(map(key, values))
    index = {k: i for i, k in enumerate(dict.fromkeys(keys))}
    if key is None:
        book = list(index)
    else:
        first = dict(zip(reversed(keys), reversed(values)))
        book = [first[k] for k in index]
    refs = np.fromiter(map(index.__getitem__, keys), np.int32, len(keys))
    return {"book": book, "refs": columnar_mod.pack_array(refs)}


def _uninterned(col: dict, copy=None) -> list:
    book = col["book"]
    refs = columnar_mod.unpack_array(memoryview(col["refs"]), 0)[0]
    if copy is None:
        return [book[r] for r in refs.tolist()]
    return [copy(book[r]) for r in refs.tolist()]


def _res_rows(rs) -> Tuple[bytes, bytes, dict]:
    """Resource 4-vectors of a node column as one int64 array, the
    presence mask, and the networks of the rows that have any."""
    present = [r is not None for r in rs]
    vec = np.array([(r.cpu, r.memory_mb, r.disk_mb, r.iops)
                    if r is not None else _ZERO4 for r in rs],
                   np.int64).reshape(len(rs), 4)
    nets = {str(i): r.networks for i, r in enumerate(rs)
            if r is not None and r.networks}
    return (columnar_mod.pack_array(vec),
            columnar_mod.pack_array(np.asarray(present, bool)), nets)


def _node_soa(nodes: List[s.Node]) -> dict:
    """The node table as struct-of-arrays (state_store.py:2091-2135):
    ids as a packed string column, the few-valued string fields and the
    attribute and meta maps interned, the resource 4-vectors, flags and
    indexes as arrays, networks sparse."""
    cap, cap_present, nets = _res_rows([nd.resources for nd in nodes])
    res, res_present, rnets = _res_rows([nd.reserved for nd in nodes])
    soa = {
        "id": _pack_str_col([nd.id for nd in nodes]),
        "cap": cap, "cap_present": cap_present, "networks": nets,
        "res": res, "res_present": res_present, "res_networks": rnets,
        "drain": columnar_mod.pack_array(
            np.asarray([nd.drain for nd in nodes], bool)),
        "create_index": columnar_mod.pack_array(
            np.asarray([nd.create_index for nd in nodes], np.int64)),
        "modify_index": columnar_mod.pack_array(
            np.asarray([nd.modify_index for nd in nodes], np.int64)),
        "attributes": _intern_col([nd.attributes for nd in nodes],
                                  key=lambda d: tuple(d.items())),
        "meta": _intern_col([nd.meta for nd in nodes],
                            key=lambda d: tuple(d.items())),
    }
    for f in _NODE_STR_FIELDS:
        soa[f] = _intern_col([getattr(nd, f) for nd in nodes])
    return soa


def _restore_nodes(table: Dict[str, s.Node], nd: dict) -> List[str]:
    """Node objects from the struct-of-arrays, made with ``__new__`` and
    a direct ``__dict__`` (state_store.py:2282-2321), into ``table`` in
    the persisted order; returns their ids."""
    ids = _unpack_str_col(nd["id"])
    arr = lambda key: columnar_mod.unpack_array(  # noqa: E731
        memoryview(nd[key]), 0)[0]
    cap, cap_p = arr("cap").tolist(), arr("cap_present").tolist()
    res, res_p = arr("res").tolist(), arr("res_present").tolist()
    nets, rnets = nd["networks"], nd["res_networks"]
    drain = arr("drain").tolist()
    cidx, midx = arr("create_index").tolist(), arr("modify_index").tolist()
    attrs = _uninterned(nd["attributes"], dict)
    metas = _uninterned(nd["meta"], dict)
    strs = {f: _uninterned(nd[f]) for f in _NODE_STR_FIELDS}
    dcs, names, ncls = strs["datacenter"], strs["name"], strs["node_class"]
    ccls, sts, stsd = (strs["computed_class"], strs["status"],
                       strs["status_description"])
    new = object.__new__
    R, ND = s.Resources, s.Node
    for i, nid in enumerate(ids):
        key = str(i) if (nets or rnets) else ""
        if cap_p[i]:
            v = cap[i]
            r = new(R)
            r.__dict__ = {"cpu": v[0], "memory_mb": v[1], "disk_mb": v[2],
                          "iops": v[3], "networks": nets.get(key, [])}
        else:
            r = None
        if res_p[i]:
            v = res[i]
            rv = new(R)
            rv.__dict__ = {"cpu": v[0], "memory_mb": v[1], "disk_mb": v[2],
                           "iops": v[3], "networks": rnets.get(key, [])}
        else:
            rv = None
        node = new(ND)
        node.__dict__ = {
            "id": nid, "datacenter": dcs[i], "name": names[i],
            "attributes": attrs[i], "resources": r, "reserved": rv,
            "meta": metas[i], "node_class": ncls[i],
            "computed_class": ccls[i], "drain": drain[i],
            "status": sts[i], "status_description": stsd[i],
            "create_index": cidx[i], "modify_index": midx[i],
        }
        table[nid] = node
    return ids
