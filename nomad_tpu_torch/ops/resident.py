"""The resident usage mirror of the batch scheduler (a copy of
``nomad_tpu/ops/resident.py`` without JAX and without its environment
switches).

A batch needs the live usage of every node.  Walking every alloc row of
the state store for it is O(cluster) host work a batch; this module keeps
the [n_pad, 4] usage matrix between batches instead, keyed by
``(store lineage, nodes-table index, n_pad)``, and catches it up from the
store's usage-delta feed (``StateStore.allocs_since``): O(changed allocs)
a batch.  Beside the host matrix it keeps a device twin, an int32
``torch`` tensor on the scheduler's device (one tensor per shard on a node
mesh), caught up in place by ``index_add_`` and lent to the device pass,
which starts its usage from it and hands it back unchanged.

Correctness machinery, as in the reference:

- **Staleness fence**: a snapshot older than the mirror (its allocs
  index, or its nodes index under the same lineage, is behind) gets a
  one-off full walk and leaves the mirror where it is.
- **Feed gap / key change**: when ``allocs_since`` cannot answer, or the
  key changed, the mirror is rebuilt from a full walk.
- **Differential guard**: every ``guard_every`` delta hits (the
  scheduler's constructor argument, default 64; 0 turns it off) the full
  walk runs anyway and must equal the host mirror bit for bit, and the
  device twin must equal the host mirror.  A mismatch feeds the breaker
  (``record(False)``), drops the mirror, and the batch runs on the walk.

Usage rows only, and only for batches without network asks (port bitmaps
are not in the feed).  Every install, fence, full walk and mismatch is
traced (``resident.device_install``, ``resident.fence``,
``resident.full_reencode``, ``resident.quant_mismatch``,
``resident.device_mismatch``, ``resident.guard_mismatch``), and all but
the install and a cold walk are published on the cluster event stream as
``Node``/``NodeStateDelta`` with the reason as its key.

Fault point ``ops.resident_state`` (action ``corrupt``): one mirror row
is perturbed after a delta apply, host and device alike, for the guard to
catch.

A CUDA error in the delta apply is not caught: the device twin's handle
is cleared first (the slot is never left holding a tensor that may be
bad; the next loan reinstalls from the host mirror) and the error
propagates, where the reference logs it and drops the twin.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import fault
from ..structs.structs import alloc_usage_vec
from ..utils import tracing

logger = logging.getLogger("nomad_tpu_torch.ops.resident")

RES_DIMS = 4


class ResidentState:
    """The one residency slot: a key and its usage mirror."""

    __slots__ = ("key", "used", "alloc_index", "touched", "hits",
                 "delta_rows", "since_guard", "used_dev", "dev_place")

    def __init__(self, key: Tuple, used: np.ndarray, alloc_index: int,
                 touched: set):
        self.key = key
        self.used = used                # [n_pad, 4] int64, owned here
        self.alloc_index = alloc_index  # the allocs-table index mirrored
        self.touched = touched          # rows that may differ from base
        self.hits = 0
        self.delta_rows = 0
        self.since_guard = 0
        # The device twin of ``used`` (int32): installed by the first
        # take_device_used, caught up in place, lent to the device pass
        # and handed back by give_device_used; None while lent or
        # dropped.  A tensor, or one tensor per shard on a mesh.
        self.used_dev = None
        # Where the twin lives (_placement): a taker asking for another
        # placement gets a fresh install.
        self.dev_place = None


# The single slot (a key change replaces it whole), under a lock.
_STATE: Optional[ResidentState] = None
_LOCK = threading.Lock()

# Module counters (tests and chip_smoke.py read them).
HITS = 0
FULL_REENCODES = 0
STALENESS_FALLBACKS = 0
GUARD_RUNS = 0
GUARD_MISMATCHES = 0
# The device twin: in-place delta applies, installs (host→device copies
# of the whole mirror, about one a mirror's life) and device-vs-host
# guard mismatches.
DEV_APPLIES = 0
DEV_INSTALLS = 0
DEV_GUARD_MISMATCHES = 0
# Host→device bytes of the twin's installs and delta uploads; the batch
# scheduler adds them to BatchStats.h2d_bytes.
DEV_H2D_BYTES = 0
# The quantized static rows' round-trip check (check_quant_roundtrip).
QUANT_CHECKS = 0
QUANT_MISMATCHES = 0

# The newest index the plan applier committed at (note_plan_applied).
LAST_PLAN_INDEX = 0


def note_plan_applied(index: int) -> None:
    """The plan applier's hook: record its newest commit index.  The
    fences key on the snapshot's allocs index; this is the breadcrumb
    (``PlanIndex``) that lines the ``NodeStateDelta`` events up against
    plan traffic."""
    global LAST_PLAN_INDEX
    if index > LAST_PLAN_INDEX:
        LAST_PLAN_INDEX = index


def invalidate() -> None:
    global _STATE
    with _LOCK:
        _STATE = None


def reset_counters() -> None:
    """Zero the counters and drop the mirror (tests)."""
    global HITS, FULL_REENCODES, STALENESS_FALLBACKS, GUARD_RUNS
    global GUARD_MISMATCHES, QUANT_CHECKS, QUANT_MISMATCHES
    global DEV_APPLIES, DEV_INSTALLS, DEV_GUARD_MISMATCHES, DEV_H2D_BYTES
    global LAST_PLAN_INDEX
    invalidate()
    HITS = FULL_REENCODES = STALENESS_FALLBACKS = 0
    GUARD_RUNS = GUARD_MISMATCHES = 0
    QUANT_CHECKS = QUANT_MISMATCHES = 0
    DEV_APPLIES = DEV_INSTALLS = DEV_GUARD_MISMATCHES = 0
    DEV_H2D_BYTES = 0
    LAST_PLAN_INDEX = 0


def _placement(device=None, mesh=None) -> Tuple:
    """The twin's identity beyond the slot key: its device, or the
    mesh's device tuple (the reference's ``_mesh_key``)."""
    if mesh is not None:
        return ("mesh", tuple(str(d) for d in mesh.devices))
    return ("device", str(torch.device(device)))


def take_device_used(key: Tuple, snap_index: int, host_used: np.ndarray,
                     device=None, mesh=None):
    """Lend the device twin to a device pass.

    Returns the int32 [n_pad, 4] tensor on ``device`` (with ``mesh``: the
    list of [n_l, 4] shard parts, each on its shard's device), installed
    from ``host_used`` on first use, or None when the slot does not match
    ``(key, snap_index)`` exactly (the caller then ships sparse deltas).
    The slot holds no handle while the loan is out, so an error between
    take and give leaves it empty, to be reinstalled at the next take."""
    global DEV_INSTALLS, DEV_H2D_BYTES
    place = _placement(device, mesh)
    with _LOCK:
        st = _STATE
        if (st is None or st.key != key
                or st.alloc_index != snap_index):
            return None
        dev = st.used_dev
        st.used_dev = None
        if dev is not None and st.dev_place != place:
            dev = None          # another placement: reinstall below
        st.dev_place = place
    if dev is None:
        src = np.ascontiguousarray(host_used, dtype=np.int32)
        if mesh is not None:
            n_l = src.shape[0] // mesh.size
            dev = [torch.from_numpy(src[i * n_l:(i + 1) * n_l]).to(d)
                   for i, d in enumerate(mesh.devices)]
        else:
            dev = torch.from_numpy(src).to(device)
        from .kernels import note_signature

        note_signature("resident_install", (host_used.shape,
                                            mesh.size if mesh is not None
                                            else 0))
        DEV_INSTALLS += 1
        DEV_H2D_BYTES += src.nbytes
        tracing.event("resident.device_install", rows=host_used.shape[0],
                      shards=mesh.size if mesh is not None else 0)
    return dev


def give_device_used(key: Tuple, snap_index: int, dev) -> None:
    """Take the lent twin back; dropped when the slot moved on while it
    was out (it is reinstalled from the host at the next take)."""
    with _LOCK:
        st = _STATE
        if (st is not None and st.key == key and st.used_dev is None
                and st.alloc_index == snap_index):
            st.used_dev = dev


def device_used_host(dev) -> np.ndarray:
    """The twin read back as one int64 [n_pad, 4] host matrix."""
    if isinstance(dev, list):
        return np.concatenate([p.cpu().numpy() for p in dev]).astype(
            np.int64)
    return dev.cpu().numpy().astype(np.int64)


def check_quant_roundtrip(exact: np.ndarray, quantized: np.ndarray,
                          scale: np.ndarray, breaker=None,
                          what: str = "rows") -> bool:
    """The quantized resource rows must dequantize to the exact ones (the
    quantizer only quantizes when that is exact, so any difference is
    corruption or a codebook bug).  A mismatch is counted and logged and
    feeds the breaker; the caller then ships exact int32 rows."""
    from .encode import dequantize_rows

    global QUANT_CHECKS, QUANT_MISMATCHES
    QUANT_CHECKS += 1
    back = dequantize_rows(quantized, scale)
    if np.array_equal(back, np.asarray(exact, dtype=np.int64)):
        return True
    QUANT_MISMATCHES += 1
    bad = int((back != exact).any(axis=-1).sum())
    logger.error(
        "quantized %s failed the round-trip bound on %d rows; shipping "
        "exact int32 rows and feeding the breaker", what, bad)
    tracing.event("resident.quant_mismatch", rows=bad, what=what)
    _publish("quant_mismatch", Rows=bad, What=what)
    if breaker is not None:
        breaker.record(False)
    return False


def _apply_device_deltas(used_dev, dev_rows) -> None:
    """Catch the device twin up in place: one ``index_add_``, or on a
    mesh (``used_dev`` a list of shard parts) one per shard with deltas,
    rows routed by ``encode.route_shard_deltas``.  Only real rows are
    uploaded: no padding row ever reaches ``index_add_``, where an index
    out of range is a device-side assert on CUDA."""
    global DEV_APPLIES, DEV_H2D_BYTES
    if not dev_rows:
        return
    from .kernels import note_signature

    if isinstance(used_dev, list):
        from .encode import route_shard_deltas

        n_l = used_dev[0].shape[0]
        rows, vals = route_shard_deltas(dev_rows, len(used_dev), n_l,
                                        dims=RES_DIMS)
        for s_i, part in enumerate(used_dev):
            keep = rows[s_i] >= 0
            if not keep.any():
                continue
            r, v = rows[s_i][keep], vals[s_i][keep]
            DEV_H2D_BYTES += r.nbytes + v.nbytes
            note_signature("resident_delta_mesh",
                           (tuple(part.shape), len(r), len(used_dev)))
            part.index_add_(0, torch.from_numpy(r).to(part.device),
                            torch.from_numpy(v).to(part.device))
        DEV_APPLIES += 1
        return
    rows = np.fromiter((i for i, _ in dev_rows), dtype=np.int32,
                       count=len(dev_rows))
    vals = np.array([vec for _, vec in dev_rows], dtype=np.int32)
    DEV_H2D_BYTES += rows.nbytes + vals.nbytes
    note_signature("resident_delta", (tuple(used_dev.shape), len(rows)))
    used_dev.index_add_(0, torch.from_numpy(rows).to(used_dev.device),
                        torch.from_numpy(vals).to(used_dev.device))
    DEV_APPLIES += 1


def _publish(reason: str, **payload) -> None:
    """The NodeStateDelta summary on the cluster event stream: one branch
    while disarmed, through the fault module's indirection, which does
    not import the server package (resident.py:423-429)."""
    fault.note_event_stream(
        "Node", "NodeStateDelta", reason,
        dict(payload, Reason=reason, PlanIndex=LAST_PLAN_INDEX))


def _full_usage(base, rows_fn) -> Tuple[np.ndarray, set]:
    """The independent rebuild: the reserved-only base usage plus every
    live alloc row of a full state walk (``rows_fn()``: node id -> rows),
    on the ``alloc_usage_vec`` basis.  It never reads the delta log: the
    guard's job is to catch that log lying.  Returns (used int64,
    touched rows)."""
    used = np.asarray(base.used, dtype=np.int64).copy()
    touched: set = set()
    node_index = base.node_index
    for nid, rows in rows_fn().items():
        i = node_index.get(nid)
        if i is None:
            continue
        for row in rows:
            c, m, d, io = alloc_usage_vec(row)
            used[i, 0] += c
            used[i, 1] += m
            used[i, 2] += d
            used[i, 3] += io
        touched.add(i)
    return used, touched


def _usage_source(base, rows_fn, usage_fn) -> Tuple[np.ndarray, set]:
    """The full live usage of a cold build, a fence or a feed-gap
    rebuild: the store's columnar mirror (``usage_fn``, O(changed) over
    the delta feed) where the caller gives one and it answers, the walk
    otherwise (``resident.py:456``).  The differential guard never reads
    ``usage_fn``: the mirror and this module both ride the delta log, and
    the guard is there to catch that log lying."""
    if usage_fn is not None:
        out = usage_fn()
        if out is not None:
            used, touched = out
            return used, set(touched)
    return _full_usage(base, rows_fn)


def _bad_shards(bad_rows, n_rows: int, shards: int) -> List[int]:
    if shards <= 0:
        return []
    n_l = max(1, n_rows // shards)
    return sorted({int(r) // n_l for r in bad_rows})


def acquire(state, cache_key: Tuple, base, rows_fn, breaker=None,
            shards: int = 0, guard_every: int = 64, usage_fn=None
            ) -> Tuple[np.ndarray, List[int], Dict]:
    """The live usage matrix for this batch.

    ``state`` is the scheduler's snapshot, ``cache_key`` the residency key
    ``(store_uid, nodes-table index, n_pad)``, ``base`` the static
    ``ClusterTensors`` (reserved-only usage), ``rows_fn`` returns
    ``{node_id: [live alloc rows]}`` for a full walk, and ``usage_fn``
    (optional) returns ``(used, touched)`` from the store's columnar
    mirror, or None: the source of a cold build, a fence or a rebuild.
    ``shards`` (the mesh size, 0 on one device) attributes a guard
    mismatch to shards.

    Returns ``(used int64 [n_pad, 4] -- the caller's copy, touched rows
    sorted, info)``; info carries ``resident_hit``, ``delta_rows``,
    ``full_reencode``, ``fence``, ``guard_ran``, ``guard_mismatch`` and
    ``delta_apply_s``."""
    global _STATE, HITS, FULL_REENCODES, STALENESS_FALLBACKS
    global GUARD_RUNS, GUARD_MISMATCHES, DEV_GUARD_MISMATCHES

    info = {"resident_hit": False, "delta_rows": 0, "full_reencode": False,
            "fence": False, "guard_ran": False, "guard_mismatch": False,
            "delta_apply_s": 0.0}
    snap_index = state.table_index("allocs")

    with _LOCK:
        st = _STATE
        if (st is not None and st.key != cache_key
                and st.key[0] == cache_key[0]
                and cache_key[1] < st.key[1]):
            # The snapshot's nodes index is older than the mirror's: a
            # one-off walk that must not replace the newer mirror.
            STALENESS_FALLBACKS += 1
            info["fence"] = info["full_reencode"] = True
            used, touched = _usage_source(base, rows_fn, usage_fn)
            tracing.event("resident.fence", snap_nodes_index=cache_key[1],
                          cached_nodes_index=st.key[1])
            _publish("staleness_fence", SnapshotNodesIndex=cache_key[1],
                     CachedNodesIndex=st.key[1])
            return used, sorted(touched), info
        if st is not None and st.key == cache_key:
            if snap_index < st.alloc_index:
                # The snapshot predates the mirror: the same fence.
                STALENESS_FALLBACKS += 1
                info["fence"] = info["full_reencode"] = True
                used, touched = _usage_source(base, rows_fn, usage_fn)
                tracing.event("resident.fence", snap_index=snap_index,
                              cached_index=st.alloc_index)
                _publish("staleness_fence", SnapshotIndex=snap_index,
                         CachedIndex=st.alloc_index)
                return used, sorted(touched), info

            deltas = (state.allocs_since(st.alloc_index)
                      if snap_index > st.alloc_index else [])
            if deltas is not None:
                node_index = base.node_index
                used = st.used
                dev_rows: List[Tuple[int, Tuple]] = []
                track_dev = st.used_dev is not None
                for nid, vec in deltas:
                    i = node_index.get(nid)
                    if i is None:
                        continue
                    used[i, 0] += vec[0]
                    used[i, 1] += vec[1]
                    used[i, 2] += vec[2]
                    used[i, 3] += vec[3]
                    st.touched.add(i)
                    if track_dev:
                        dev_rows.append((i, vec))
                st.alloc_index = snap_index
                st.hits += 1
                st.delta_rows += len(deltas)
                st.since_guard += 1
                HITS += 1
                info["resident_hit"] = True
                info["delta_rows"] = len(deltas)

                act = fault.faultpoint("ops.resident_state")
                if act is not None and act.kind == "corrupt":
                    row = (sorted(st.touched)[act.rng.randrange(
                        len(st.touched))] if st.touched
                        else act.rng.randrange(used.shape[0]))
                    dim = act.rng.randrange(RES_DIMS)
                    bump = 1 + act.rng.randrange(1000)
                    used[row, dim] += bump
                    st.touched.add(row)
                    if track_dev:
                        # The same damage on the device twin: host and
                        # device agree, and the walk guard catches both.
                        vec = [0] * RES_DIMS
                        vec[dim] = bump
                        dev_rows.append((row, tuple(vec)))

                if track_dev:
                    t_da = time.perf_counter()
                    dev, st.used_dev = st.used_dev, None
                    # A raw device error propagates with the slot empty.
                    _apply_device_deltas(dev, dev_rows)
                    st.used_dev = dev
                    info["delta_apply_s"] = time.perf_counter() - t_da

                if guard_every > 0 and st.since_guard >= guard_every:
                    st.since_guard = 0
                    GUARD_RUNS += 1
                    info["guard_ran"] = True
                    if st.used_dev is not None:
                        # The twin must equal the host mirror it copies.
                        dev_host = device_used_host(st.used_dev)
                        if not np.array_equal(dev_host, used):
                            DEV_GUARD_MISMATCHES += 1
                            bad_rows = np.nonzero(
                                (dev_host != used).any(axis=1))[0]
                            bad_shards = _bad_shards(bad_rows,
                                                     used.shape[0], shards)
                            logger.error(
                                "device usage mirror diverged from the "
                                "host mirror on %d rows%s; dropping it "
                                "and feeding the breaker", len(bad_rows),
                                (f" (mesh shards {bad_shards})"
                                 if bad_shards else ""))
                            tracing.event("resident.device_mismatch",
                                          rows=int(len(bad_rows)),
                                          shards=bad_shards)
                            _publish("device_mirror_mismatch",
                                     Rows=int(len(bad_rows)),
                                     AllocIndex=snap_index,
                                     Shards=bad_shards)
                            if breaker is not None:
                                breaker.record(False)
                            st.used_dev = None
                    ref_used, ref_touched = _full_usage(base, rows_fn)
                    if not np.array_equal(used, ref_used):
                        GUARD_MISMATCHES += 1
                        info["guard_mismatch"] = True
                        bad_rows = np.nonzero(
                            (used != ref_used).any(axis=1))[0]
                        bad_shards = _bad_shards(bad_rows, used.shape[0],
                                                 shards)
                        if bad_shards:
                            info["guard_bad_shards"] = bad_shards
                        logger.error(
                            "resident usage mirror diverged from the full "
                            "walk on %d node rows%s; invalidating and "
                            "feeding the breaker", len(bad_rows),
                            (f" (mesh shards {bad_shards})"
                             if bad_shards else ""))
                        tracing.event("resident.guard_mismatch",
                                      rows=int(len(bad_rows)),
                                      shards=bad_shards)
                        _publish("guard_mismatch", Rows=int(len(bad_rows)),
                                 AllocIndex=snap_index, Shards=bad_shards)
                        if breaker is not None:
                            breaker.record(False)
                        _STATE = None
                        info["resident_hit"] = False
                        info["full_reencode"] = True
                        return ref_used, sorted(ref_touched), info
                    if breaker is not None:
                        breaker.record(True)
                    # The guard also compacts the touched set.
                    st.touched = set(ref_touched)

                # The caller's copy: the mirror moves on under later
                # batches while this one is still being decoded.
                return used.copy(), sorted(st.touched), info

        # Cold, key change or feed gap: a full rebuild.
        reason = ("feed_gap" if st is not None and st.key == cache_key
                  else ("key_change" if st is not None else "cold"))
        FULL_REENCODES += 1
        info["full_reencode"] = True
        used, touched = _usage_source(base, rows_fn, usage_fn)
        _STATE = ResidentState(cache_key, used, snap_index, set(touched))
        tracing.event("resident.full_reencode", reason=reason,
                      alloc_index=snap_index)
        if reason != "cold":
            _publish(reason, AllocIndex=snap_index, Nodes=int(base.n_real))
        return used.copy(), sorted(touched), info

