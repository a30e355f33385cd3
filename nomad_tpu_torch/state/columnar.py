"""Columnar numpy mirror of the state store's node table and live-usage
matrix (a copy of ``nomad_tpu/state/columnar.py`` without its environment
switches and without the snapshot serialization).

At a million nodes the host's cost is walking Python objects: the static
encode loops over every ``Node`` and the usage read over every alloc row.
This module keeps the numeric columns the scheduler reads inside the
``StateStore``, maintained at its node writes, so the encode
(``ops/encode.build_cluster_static``), the batch scheduler's usage read
(``ops/batch_sched._columnar_usage``, also the resident mirror's source)
and the plan applier's fit route (``server/plan_apply.
_evaluate_nodes_columnar``) slice arrays instead.

One ``ClusterColumns`` per store or snapshot:

- **Node columns**: ``cap``/``res`` ``[capy, 4] int64`` (resources and
  reserved), ``eligible [capy] bool`` (ready and not draining),
  ``dc_code``/``class_code [capy] int32`` against append-only codebooks
  whose codes are assigned in node-insertion order: the first-seen order
  of the object walk's ``setdefault`` over ``StateStore.nodes()``, which
  is what makes the sliced buffers bit-identical to the walk's.
- **Usage matrix**: ``usage [capy, 4] int64``, the summed live-alloc
  usage of each node row.  No write hook maintains it: it is folded at
  read time from the store's usage-delta log (``allocs_since``), so a
  bulk slab commit stays O(1) and a read costs O(changed allocs).

Sharing: ``snapshot()`` shares the arrays behind copy-on-write flags
(private ``n``, cursor and ownership).  Appends are safe for a view (it
never reads rows at or past its own ``n``), so only the creating store
appends in place; any in-place row update or usage fold first copies the
arrays it writes when they are shared.

Invalidation: a structural change that could reorder a codebook (a node
delete, an existing node changing datacenter or computed class) drops the
container; the owning store rebuilds it at its next ``snapshot()`` or
``columns()``.  A guard mismatch bumps the module :data:`EPOCH`, which
invalidates every container in the process.

The on/off switch is ``StateStore(columnar=...)`` and the guards'
cadence a ``columnar_guard_every`` argument of ``TorchBatchScheduler``,
``PlanApplier`` and ``ServerConfig`` (the reference's
``NOMAD_TPU_COLUMNAR`` and ``NOMAD_TPU_COLUMNAR_GUARD_EVERY``; defaults
on and 16, 0 turns a guard off).
"""
from __future__ import annotations

import logging
from typing import Dict, List, Tuple

import numpy as np

from ..structs.structs import alloc_usage_vec

logger = logging.getLogger("nomad_tpu_torch.state.columnar")

RES_DIMS = 4

# The guards' default cadence (the reference's
# NOMAD_TPU_COLUMNAR_GUARD_EVERY default, knobs.py:147).
GUARD_EVERY = 16

# Guard epoch: bumped on a guard mismatch; a container built under an
# older epoch is rebuilt by its owning store before it is trusted again.
EPOCH = 0

# Module counters (tests, the drill and chip_smoke.py read them).
GUARD_RUNS = 0
GUARD_MISMATCHES = 0
COLUMNAR_ENCODES = 0
WALK_ENCODES = 0
REBUILDS = 0
# Usage reads through ops/batch_sched._columnar_usage and its own
# walk-compare guard (same cadence as the static guard).
USAGE_READS = 0
USAGE_GUARD_RUNS = 0
USAGE_GUARD_MISMATCHES = 0


def bump_epoch() -> None:
    global EPOCH
    EPOCH += 1


def note_guard_mismatch(kind: str, detail: str, breaker=None,
                        **payload) -> None:
    """The one response of every columnar guard (static encode, usage,
    plan fit) to a mismatch: count it, bump the epoch (every mirror in
    the process rebuilds before it is trusted again), log it and feed the
    breaker.  The reference's trace event and ``ColumnarGuardMismatch``
    event-stream entry are this log line (no tracing or event stream in
    the port yet)."""
    global GUARD_MISMATCHES, USAGE_GUARD_MISMATCHES
    if kind == "static":
        GUARD_MISMATCHES += 1
    else:
        USAGE_GUARD_MISMATCHES += 1
    bump_epoch()
    logger.error(
        "columnar %s guard diverged from the object walk (%s, %s); "
        "rebuilding the mirror and feeding the breaker", kind, detail,
        payload)
    if breaker is not None:
        breaker.record(False)


def reset_counters() -> None:
    global GUARD_RUNS, GUARD_MISMATCHES, COLUMNAR_ENCODES, WALK_ENCODES
    global REBUILDS, USAGE_READS, USAGE_GUARD_RUNS, USAGE_GUARD_MISMATCHES
    GUARD_RUNS = GUARD_MISMATCHES = 0
    COLUMNAR_ENCODES = WALK_ENCODES = REBUILDS = 0
    USAGE_READS = USAGE_GUARD_RUNS = USAGE_GUARD_MISMATCHES = 0


class ClusterColumns:
    """The columnar mirror of one store's node table and live-usage
    matrix.  Arrays are shared between a store and its snapshots behind
    copy-on-write flags; the codebooks and the row index are append-only
    (each view trims by its own lengths)."""

    __slots__ = (
        "n", "capy", "node_ids", "row_of",
        "cap", "res", "eligible", "dc_code", "class_code",
        "dc_book", "class_book", "dc_len", "class_len",
        "usage", "usage_index",
        "_owned_static", "_owned_elig", "_owned_usage", "_can_append",
        "epoch",
    )

    def __init__(self, capy: int = 256):
        self.n = 0
        self.capy = capy
        self.node_ids: List[str] = []
        self.row_of: Dict[str, int] = {}
        self.cap = np.zeros((capy, RES_DIMS), dtype=np.int64)
        self.res = np.zeros((capy, RES_DIMS), dtype=np.int64)
        self.eligible = np.zeros(capy, dtype=bool)
        self.dc_code = np.full(capy, -1, dtype=np.int32)
        self.class_code = np.full(capy, -1, dtype=np.int32)
        self.dc_book: Dict[str, int] = {}
        self.class_book: Dict[str, int] = {}
        self.dc_len = 0
        self.class_len = 0
        self.usage = np.zeros((capy, RES_DIMS), dtype=np.int64)
        self.usage_index = 0        # the allocs-table index folded to
        self._owned_static = True
        self._owned_elig = True
        self._owned_usage = True
        self._can_append = True
        self.epoch = EPOCH

    # -- sharing -----------------------------------------------------------

    def share(self) -> "ClusterColumns":
        """An O(1) view for a snapshot: the array refs shared, private
        metadata.  The owner loses in-place ownership (its next row
        update or fold copies first); the view never appends in place.
        The codebooks are copied (they are small): the view reads them
        off the store lock while the owner may grow its dicts."""
        view = ClusterColumns.__new__(ClusterColumns)
        view.n = self.n
        view.capy = self.capy
        view.node_ids = self.node_ids          # append-only, trim by n
        view.row_of = self.row_of              # append-only, check < n
        view.cap = self.cap
        view.res = self.res
        view.eligible = self.eligible
        view.dc_code = self.dc_code
        view.class_code = self.class_code
        view.dc_book = self.dc_codebook()
        view.class_book = self.class_codebook()
        view.dc_len = self.dc_len
        view.class_len = self.class_len
        view.usage = self.usage
        view.usage_index = self.usage_index
        view._owned_static = False
        view._owned_elig = False
        view._owned_usage = False
        view._can_append = False
        view.epoch = self.epoch
        self._owned_static = False
        self._owned_elig = False
        self._owned_usage = False
        return view

    def _own_static(self) -> None:
        if not self._owned_static:
            self.cap = self.cap.copy()
            self.res = self.res.copy()
            self.dc_code = self.dc_code.copy()
            self.class_code = self.class_code.copy()
            self._owned_static = True

    def _own_elig(self) -> None:
        """Eligibility has its own ownership: a status or drain flip is
        the common in-place write, and one bool column is cheaper to
        copy than the static arrays."""
        if not self._owned_elig:
            self.eligible = self.eligible.copy()
            self._owned_elig = True

    def _own_usage(self) -> None:
        if not self._owned_usage:
            self.usage = self.usage.copy()
            self._owned_usage = True

    def _own_append(self) -> None:
        """A view that appends takes private copies of the append-only
        structures too: the shared ones belong to the owner's future."""
        if not self._can_append:
            self._own_static()
            self._own_elig()
            self._own_usage()
            self.node_ids = list(self.node_ids[:self.n])
            self.row_of = {nid: i for i, nid in enumerate(self.node_ids)}
            self.dc_book = self.dc_codebook()
            self.class_book = self.class_codebook()
            self._can_append = True

    def _grow(self, need: int) -> None:
        new_capy = max(need, self.capy * 2, 256)

        def g2(a):
            out = np.zeros((new_capy, RES_DIMS), dtype=a.dtype)
            out[:self.n] = a[:self.n]
            return out

        def g1(a, fill):
            out = np.full(new_capy, fill, dtype=a.dtype)
            out[:self.n] = a[:self.n]
            return out

        self.cap = g2(self.cap)
        self.res = g2(self.res)
        self.usage = g2(self.usage)
        self.eligible = g1(self.eligible, False)
        self.dc_code = g1(self.dc_code, -1)
        self.class_code = g1(self.class_code, -1)
        self.capy = new_capy
        # Fresh private arrays: ownership regained.
        self._owned_static = True
        self._owned_elig = True
        self._owned_usage = True

    # -- node writes (the caller holds the store lock) ---------------------

    @staticmethod
    def _vec(r) -> Tuple[int, int, int, int]:
        if r is None:
            return (0, 0, 0, 0)
        return (r.cpu, r.memory_mb, r.disk_mb, r.iops)

    def append_node(self, node) -> int:
        """A new node row; returns its index.  The caller folds the usage
        log first (``StateStore._col_node_upserted``), so the backfill it
        does next cannot count a pending log entry twice."""
        self._own_append()
        if self.n >= self.capy:
            self._grow(self.n + 1)
        i = self.n
        self.cap[i] = self._vec(node.resources)
        self.res[i] = self._vec(node.reserved)
        self.eligible[i] = node.ready()
        dc = self.dc_book.setdefault(node.datacenter, self.dc_len)
        if dc == self.dc_len:
            self.dc_len += 1
        cc = self.class_book.setdefault(node.computed_class, self.class_len)
        if cc == self.class_len:
            self.class_len += 1
        self.dc_code[i] = dc
        self.class_code[i] = cc
        self.usage[i] = 0
        self.node_ids.append(node.id)
        self.row_of[node.id] = i
        self.n = i + 1
        return i

    def update_node(self, node) -> bool:
        """Update an existing node's row in place.  False when the update
        could reorder a codebook (a datacenter or computed-class change):
        the caller drops the container."""
        i = self.row_of.get(node.id)
        if i is None or i >= self.n:
            return False
        dc = self.dc_book.get(node.datacenter)
        cc = self.class_book.get(node.computed_class)
        if (dc is None or dc != self.dc_code[i]
                or cc is None or cc != self.class_code[i]):
            return False
        self._own_static()
        self._own_elig()
        self.cap[i] = self._vec(node.resources)
        self.res[i] = self._vec(node.reserved)
        self.eligible[i] = node.ready()
        return True

    def set_eligible(self, node_id: str, eligible: bool) -> None:
        i = self.row_of.get(node_id)
        if i is None or i >= self.n:
            return
        self._own_elig()
        self.eligible[i] = eligible

    def add_usage(self, node_id: str, vec: Tuple[int, int, int, int]) -> None:
        i = self.row_of.get(node_id)
        if i is None or i >= self.n:
            return
        self._own_usage()
        u = self.usage
        u[i, 0] += vec[0]
        u[i, 1] += vec[1]
        u[i, 2] += vec[2]
        u[i, 3] += vec[3]

    # -- the usage fold (the caller holds the store lock) ------------------

    def fold_usage(self, store) -> bool:
        """Catch the usage matrix up with the store's alloc writes through
        its usage-delta feed, O(changed allocs).  False when the feed can
        no longer answer (the cursor fell below the log's trim floor):
        the caller rebuilds from a full row walk."""
        snap_index = store.table_index("allocs")
        if snap_index <= self.usage_index:
            return True
        deltas = store.allocs_since(self.usage_index)
        if deltas is None:
            return False
        self._own_usage()
        row_of, n, u = self.row_of, self.n, self.usage
        for nid, vec in deltas:
            i = row_of.get(nid)
            if i is None or i >= n:
                continue
            u[i, 0] += vec[0]
            u[i, 1] += vec[1]
            u[i, 2] += vec[2]
            u[i, 3] += vec[3]
        self.usage_index = snap_index
        return True

    def rebuild_usage(self, store) -> None:
        """The usage matrix anew from the store's live alloc rows (a feed
        gap, or a cold build)."""
        self._own_usage()
        self.usage[:self.n] = 0
        row_of, n, u = self.row_of, self.n, self.usage
        for nid, row in store.alloc_rows(None):
            if row.terminal_status():
                continue
            i = row_of.get(nid)
            if i is None or i >= n:
                continue
            c, m, d, io = alloc_usage_vec(row)
            u[i, 0] += c
            u[i, 1] += m
            u[i, 2] += d
            u[i, 3] += io
        self.usage_index = store.table_index("allocs")

    # -- codebook views ----------------------------------------------------

    def dc_codebook(self) -> Dict[str, int]:
        return _trim_book(self.dc_book, self.dc_len)

    def class_codebook(self) -> Dict[str, int]:
        return _trim_book(self.class_book, self.class_len)

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, store) -> "ClusterColumns":
        """A cold build from the store's tables (the caller holds the
        lock)."""
        global REBUILDS
        REBUILDS += 1
        nodes = list(store.nodes_table.values())
        cols = cls(capy=max(256, len(nodes)))
        for node in nodes:
            cols.append_node(node)
        cols.rebuild_usage(store)
        return cols


def _trim_book(book: Dict[str, int], length: int) -> Dict[str, int]:
    """A copy of an append-only codebook cut to its first ``length``
    codes (insertion order is code order)."""
    if len(book) == length:
        return dict(book)
    out: Dict[str, int] = {}
    for k, v in book.items():
        if v >= length:
            break
        out[k] = v
    return out
