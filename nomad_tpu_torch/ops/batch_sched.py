"""The port's batch scheduler: evaluations in, plans out
(``TPUBatchScheduler``, ``nomad_tpu/ops/batch_sched.py:304``).

Two entries share one device half (encode, upload, ``kernels.fused_pass``
or the mesh's ``sharded_fused_pass``, the one result fetch):

- :class:`TorchBatchScheduler` (registered as ``torch-batch``) takes
  evaluations.  It reads the cluster from a state store snapshot,
  reconciles each eval against its job's allocations through the CPU
  oracle's own code (:class:`_CollectingScheduler` over
  ``scheduler.generic.GenericScheduler``: stops, destructive and in-place
  updates, lost allocations, rolling limits), places every ask of the
  batch in one device pass, and submits one plan per eval to its planner
  (alloc slabs, AllocMetric failure forensics, blocked and rolling
  follow-up evals, queued counts).  The static tensors are sliced from
  the store's columnar mirror (``state/columnar.py``) where it has one,
  and the live usage comes from the resident mirror of
  ``ops/resident.py`` (which starts from the columnar mirror's usage),
  caught up from the store's delta feed, in batches without network
  asks; ``schedule_stream`` runs batches in the reference's pipelined
  order.  Evals whose specs the device pass cannot express, every eval
  while the kernel breaker is open, the evals of a batch whose device
  result was rejected, and a plan that conflicted go through the CPU
  oracle instead, as in the reference, each logged
  with its reason.  ``BatchStats.oracle_routed`` (and the
  ``breaker.oracle_routed`` counter) counts what the reference counts:
  the evals of the breaker and reject routes; the gate routes and the
  conflict retries have counts of their own (``gate_routed``,
  ``conflict_retries``).
  A raw device error (a failed build, launch or fetch) is no such route:
  it propagates and is not recorded by the breaker.  With
  ``preemption_enabled=True``, asks the capacity pass left unplaced take
  the reference's second pass: one launch of the eviction-set kernel
  (``ops/preempt.py``) over every still-failing (spec, node) pair, its
  outputs fetched with the forensics rows, then a host greedy pass that
  commits at most one preempting placement per node, each replayed
  against the scalar oracle (the agreement feeds the breaker); the
  placements and their victims go into the plan's
  ``node_preemptions``.  An ``annotate_plan`` eval (the ``job plan``
  dry run) skips the register fast path, so the oracle's diff sets the
  plan's annotations, its placements still go through the device pass,
  and its plan is submitted even when it changes nothing.
  Each batch is traced as the reference traces it: a ``batch.schedule``
  root (``eval_ids`` of its members) with ``batch.phase1``,
  ``batch.phase2``, ``batch.encode``, ``batch.device``, exactly one
  ``batch.fetch``, ``batch.metrics`` and ``batch.finalize`` under it,
  plus ``batch.fetch_forensics``, ``batch.preempt``,
  ``batch.oracle_routed`` and ``oracle.process`` where those happen.  The
  phase spans are recorded from the timers the path already takes; in
  particular ``batch.device`` starts where packing ended and lasts
  ``BatchStats.device_seconds``, the CUDA-event interval closed at the
  fetch, so no span adds a synchronization.
- :func:`schedule_batch` takes plain lists of nodes and jobs and treats
  every job as a registration.  It has no state store and no planner, so
  a spec the reference sends to its oracle raises ``NotImplementedError``
  there.
"""
from __future__ import annotations

import hashlib
import ipaddress
import logging
import math
import os
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import fault
from ..device import resolve_device
from ..scheduler.context import EvalContext
from ..scheduler import preempt as preempt_oracle
from ..scheduler.generic import GenericScheduler
from ..scheduler.propertyset import PropertySet, dp_used_values
from ..scheduler.scheduler import register_scheduler
from ..scheduler.stack import GenericStack
from ..scheduler.util import (AllocTuple, adjust_queued_allocations,
                              ready_nodes_in_dcs, set_status)
from ..state import columnar
from ..structs import structs as s
from ..structs.network import NetworkIndex
from ..utils import tracing
from ..utils.lru import LRU
from ..utils.telemetry import NULL_TELEMETRY
from . import breaker as breaker_mod
from . import decode, encode, kernels, preempt, resident, xfer
from .breaker import HALF_OPEN, KernelIntegrityError  # noqa: F401

logger = logging.getLogger("nomad_tpu_torch.ops.batch_sched")

# Budget of the mesh's commit-ordered slot record ([U, M] int32, plus the
# score rows when carried).  A batch whose record would exceed it takes
# the single-chip path, as the reference does (batch_sched.py:63).
MESH_SLOT_BUDGET_BYTES = 512 << 20

# Finalized static cluster tensors, keyed by (store lineage, nodes table
# index, constraint vocabulary, networks, pad): a fleet that did not
# change is not encoded again (batch_sched.py:73, :950-970).
_CLUSTER_CACHE = LRU(4)

# Device copies of the packed static buffer, keyed by its content digest:
# an unchanged cluster is not uploaded again (batch_sched.py:80,
# :1187-1195).
_DEVICE_STATIC_CACHE = LRU(4)


@dataclass
class SpecPlacement:
    """Outcome of one (job id, task group) spec."""

    node_ids: List[str]          # one per placed alloc, in COO order
    scores: np.ndarray           # [placed] f32 commit-time binpack score
    collisions: np.ndarray       # [placed] int32 same-job allocs on the node
    unplaced: int
    # The AllocMetric.scores of the reference: "<node>.binpack" per
    # distinct node (last commit wins) and "<node>.job-anti-affinity"
    # where the commit had collisions.
    metric_scores: Dict[str, float] = field(default_factory=dict)
    # With network asks: per placed alloc (aligned with node_ids), task
    # name -> its network offer.  Empty for a spec without network asks.
    networks: List[Dict[str, s.NetworkResource]] = field(
        default_factory=list)


@dataclass
class BatchResult:
    placements: Dict[Tuple[str, str], SpecPlacement]
    rounds: int
    device: str
    timings: Dict[str, float] = field(default_factory=dict)  # seconds
    # Shards of the node mesh that placed the batch; 0 for the
    # single-chip path (also when a mesh batch's slot record exceeded
    # MESH_SLOT_BUDGET_BYTES).
    mesh_shards: int = 0


def placed_allocs(result: BatchResult,
                  jobs: Sequence[s.Job]) -> List[s.Allocation]:
    """The placements of ``result`` as running allocations, to pass as
    ``live_allocs`` to a later batch.  Each carries its task group's
    combined resources (the ephemeral disk plus every task's ask) and,
    where the group asks for networks, its tasks' offers, so the next
    encode counts their ports and bandwidth."""
    from ..scheduler.util import task_group_constraints

    out: List[s.Allocation] = []
    for job in jobs:
        for tg in job.task_groups:
            sp = result.placements.get((job.id, tg.name))
            if sp is None:
                continue
            size = task_group_constraints(tg).size
            for i, nid in enumerate(sp.node_ids):
                task_resources = {}
                if sp.networks:
                    for t in tg.tasks:
                        res = t.resources.copy()
                        offer = sp.networks[i].get(t.name)
                        res.networks = [offer] if offer is not None else []
                        task_resources[t.name] = res
                out.append(s.Allocation(
                    id=s.generate_uuid(), node_id=nid, job_id=job.id,
                    task_group=tg.name,
                    resources=s.Resources(size.cpu, size.memory_mb,
                                          size.disk_mb, size.iops),
                    task_resources=task_resources))
    return out


def validate_device_outputs(spec_list, ct, unplaced_arr, coo_rows,
                            coo_cols, coo_counts) -> Optional[str]:
    """Structural invariants of the device result (batch_sched.py:123),
    checked on every batch before any placement is used.  Returns the
    first violation, or None."""
    n_specs = len(spec_list)
    counts = np.array([sp.count for sp in spec_list], dtype=np.int64)
    up = np.asarray(unplaced_arr[:n_specs], dtype=np.int64)
    if up.shape[0] < n_specs:
        return f"unplaced vector too short ({up.shape[0]} < {n_specs})"
    if (up < 0).any():
        u = int(np.argmax(up < 0))
        return f"negative unplaced count ({int(up[u])}) for spec {u}"
    if (up > counts).any():
        u = int(np.argmax(up > counts))
        return (f"unplaced {int(up[u])} exceeds ask count "
                f"{int(counts[u])} for spec {u}")
    cr = np.asarray(coo_rows, dtype=np.int64)
    cc = np.asarray(coo_cols, dtype=np.int64)
    cv = np.asarray(coo_counts, dtype=np.int64)
    live = (cr >= 0) & (cr < n_specs)
    # A negative node index would wrap under Python indexing and land an
    # alloc on a node that never passed feasibility.
    if (live & (cc < 0)).any():
        i = int(np.argmax(live & (cc < 0)))
        return (f"negative node index ({int(cc[i])}) in placement "
                f"output for spec {int(cr[i])}")
    valid = live & (cc < ct.n_real)
    if (cv[valid] < 0).any():
        return "negative commit count in placement output"
    placed = np.zeros(n_specs, dtype=np.int64)
    if valid.any():
        np.add.at(placed, cr[valid], cv[valid])
    bad = placed + up != counts
    if bad.any():
        u = int(np.argmax(bad))
        return (f"placed ({int(placed[u])}) + unplaced ({int(up[u])}) != "
                f"asks ({int(counts[u])}) for spec {u}")
    return None


def _corrupt_outputs(rng, spec_list, unplaced_arr, coo_counts):
    """The ``ops.kernel_result`` corrupt action (batch_sched.py:170):
    seeded damage to the device outputs that validation must catch.
    Returns writable, corrupted copies."""
    unplaced_arr = np.array(unplaced_arr)
    coo_counts = np.array(coo_counts)
    u = rng.randrange(len(spec_list))
    mode = rng.randrange(3)
    if mode == 0:
        unplaced_arr[u] = -3
    elif mode == 1:
        unplaced_arr[u] = spec_list[u].count + 5
    elif len(coo_counts):
        i = rng.randrange(len(coo_counts))
        coo_counts[i] = coo_counts[i] + spec_list[u].count + 1
    else:
        unplaced_arr[u] = -1
    return unplaced_arr, coo_counts


def _prepare_specs(jobs: Sequence[s.Job],
                   live: Dict[Tuple[str, str], int],
                   live_allocs: Sequence[s.Allocation] = (),
                   nodes_by_id: Optional[Dict[str, s.Node]] = None
                   ) -> List[encode.PlacementSpec]:
    """The list entry's spec dedup, sorted by priority, stable
    (batch_sched.py:587-618).  A distinct_property spec gets the values
    its job's live allocs already use (``scheduler.propertyset``).  A
    spec the reference would route to its oracle raises
    ``NotImplementedError`` with the reference's reason."""
    specs: Dict[Tuple[str, str], encode.PlacementSpec] = {}
    for job in jobs:
        for tg in job.task_groups:
            want = tg.count - live.get((job.id, tg.name), 0)
            if want <= 0:
                continue
            key = (job.id, tg.name)
            spec = specs.get(key)
            if spec is None:
                spec = encode.build_spec(job, tg,
                                         job.type == s.JOB_TYPE_BATCH)
                if spec.needs_oracle:
                    raise NotImplementedError(
                        f"job {job.id} group {tg.name}: "
                        f"{spec.needs_oracle}; the reference places this "
                        "with its CPU oracle, which needs a state store: "
                        "schedule it through TorchBatchScheduler")
                if spec.dp_target is not None:
                    con = next(c for c in spec.constraints if c.operand
                               == s.CONSTRAINT_DISTINCT_PROPERTY)
                    spec.dp_used_values = dp_used_values(
                        job, tg, con, live_allocs, nodes_by_id or {})
                specs[key] = spec
            spec.count += want
    return sorted(specs.values(), key=lambda sp: -sp.priority)


def cluster_networks_simple(nodes: Iterable[s.Node]) -> bool:
    """The device's port accounting assumes at most one network device a
    node with a single-IP CIDR, the common fingerprinted shape; anything
    richer needs the oracle's per-IP iteration (network.go:245,
    ``_cluster_networks_simple``, batch_sched.py:822)."""
    for node in nodes:
        nets = [nr for nr in (node.resources.networks or []) if nr.device]
        if len(nets) > 1:
            return False
        if nets and nets[0].cidr:
            try:
                if ipaddress.ip_network(
                        nets[0].cidr, strict=False).num_addresses > 1:
                    return False
            except ValueError:
                return False
    return True


# -- the device half, shared by both entries ----------------------------------

class _DeviceTimer:
    """Device time from upload to fetched result: CUDA events on a card,
    the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def seconds(self) -> float:
        if not self.cuda:
            return time.perf_counter() - self.t0
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        return self.start.elapsed_time(end) / 1000.0


@dataclass
class _DeviceBatch:
    """One batch's device inputs and, once dispatched, its pass."""

    spec_list: List[encode.PlacementSpec]
    nodes: List[s.Node]
    base: encode.ClusterTensors       # static tensors (reserved-only usage)
    ct: encode.ClusterTensors         # base with the live usage layered on
    st: encode.SpecTensors
    static: Dict[str, np.ndarray]
    dyn: Dict[str, np.ndarray]
    with_networks: bool
    with_scores: bool
    slot_m: int
    max_nnz: int
    shards: int                       # mesh shards placing it; 0: one device
    k_cand: int = 0
    # Set by _dispatch:
    out: Optional[kernels.FusedOutput] = None
    timer: Optional[_DeviceTimer] = None
    t_dispatch: float = 0.0           # host clock when packing ended
    device_seconds: float = 0.0       # upload to fetched result (_fetch)
    encode_seconds: float = 0.0
    h2d_bytes: int = 0
    static_h2d_bytes: int = 0
    resident: Dict = field(default_factory=dict)   # resident.acquire info
    # Rows of the nodes that carry live allocs (the usage walk's or the
    # mirror's): the preemption pass is gated on them and enumerates them.
    touched: List[int] = field(default_factory=list)
    commit_steps: int = 0             # committing spec steps of the pass
    # The staged dispatch's schedule and compact seconds.
    timings: Dict[str, float] = field(default_factory=dict)


def _node_pad_multiple(mesh) -> int:
    """128, raised to lcm(128, D) on a mesh so the shards divide the node
    axis evenly; padding rows are ineligible (batch_sched.py:1451)."""
    if mesh is None:
        return 128
    d = mesh.size
    return 128 * d // math.gcd(128, d)


def _cluster_static(nodes: Sequence[s.Node], attr_targets, literals,
                    with_networks: bool, pad_m: int, state=None,
                    breaker=None,
                    guard_every: int = columnar.GUARD_EVERY
                    ) -> encode.ClusterTensors:
    """The finalized static tensors: sliced from ``state``'s columnar
    mirror where it has one in step with ``nodes`` (its guard every
    ``guard_every`` columnar encodes, feeding ``breaker``), walked
    otherwise (the list entry has no store)."""
    return encode.build_cluster_static(
        state, nodes, attr_targets, literals, node_pad_multiple=pad_m,
        with_networks=with_networks, breaker=breaker,
        guard_every=guard_every)


def _quantized_rows(base: encode.ClusterTensors, shards: int = 0,
                    breaker=None):
    """Capacity and the reserved-only baseline quantized when that is
    exact, else None; memoized on the static tensors.  The quantized rows
    go through ``resident.check_quant_roundtrip`` once per static encode
    (per shard slice with ``shards``, the rows each shard will
    dequantize), as the reference's ``_quant_roundtrip_ok`` does
    (batch_sched.py:1278-1303): a mismatch is counted, feeds ``breaker``
    and ships int32 rows."""
    quant = getattr(base, "_quant_rows", False)
    if quant is False:
        quant = encode.quantize_resource_rows(base.capacity, base.used)
        if quant is not None and not _quant_roundtrip_ok(base, quant,
                                                         shards, breaker):
            quant = None
        base._quant_rows = quant
    return quant


def _quant_roundtrip_ok(base, quant, shards: int, breaker) -> bool:
    parts = [(slice(None), "")]
    if shards:
        n_l = base.n_pad // shards
        parts = [(slice(i * n_l, (i + 1) * n_l), f" shard {i}")
                 for i in range(shards)]
    for sl, where in parts:
        if not (resident.check_quant_roundtrip(
                    base.capacity[sl], quant.cap_q[sl], quant.scale[0],
                    breaker=breaker, what="capacity" + where)
                and resident.check_quant_roundtrip(
                    base.used[sl], quant.used_q[sl], quant.scale[1],
                    breaker=breaker, what="used baseline" + where)):
            return False
    return True


def _layer_usage(base: encode.ClusterTensors,
                 allocs_by_node: Dict[str, List[s.Allocation]]):
    """The walk's usage: ``base`` with the live usage of
    ``allocs_by_node`` layered on, and the rows it touched."""
    ct = (encode.apply_alloc_usage(base, allocs_by_node)
          if allocs_by_node else base)
    touched = sorted(i for i in (base.node_index.get(nid)
                                 for nid in allocs_by_node) if i is not None)
    return ct, touched


def _encode_batch(spec_list: List[encode.PlacementSpec],
                  nodes: List[s.Node], base: encode.ClusterTensors,
                  ct: encode.ClusterTensors, touched: List[int],
                  job_nodes: Callable[[str], Iterable[str]], rng_seed: int,
                  mesh=None, breaker=None) -> _DeviceBatch:
    """The static and dynamic upload dicts of a batch
    (batch_sched.py:1015-1134): ``ct``, the static ``base`` with the live
    usage on it, shipped as sparse deltas over the reserved-only baseline
    at the ``touched`` rows, the specs, the per-(job, node) alloc counts
    of the jobs' live allocs (``job_nodes(job_id)`` yields their node
    ids), and the tie-break seed.  ``breaker`` takes the verdict of the
    quantized rows' round-trip check."""
    st = encode.encode_specs(spec_list, ct, nodes)

    # Existing per-(job, node) alloc counts, uploaded sparse.
    jc_entries: Dict[Tuple[int, int], int] = {}
    for j, job_id in enumerate(st.job_ids):
        for nid in job_nodes(job_id):
            idx = base.node_index.get(nid)
            if idx is not None:
                jc_entries[(j, idx)] = jc_entries.get((j, idx), 0) + 1
    k_jc = encode.pow2_bucket(max(1, len(jc_entries)), minimum=8)
    jc_rows = np.full(k_jc, -1, dtype=np.int32)
    jc_cols = np.zeros(k_jc, dtype=np.int32)
    jc_vals = np.zeros(k_jc, dtype=np.int32)
    for i, ((j, n), v) in enumerate(jc_entries.items()):
        jc_rows[i], jc_cols[i], jc_vals[i] = j, n, v

    # Sparse usage deltas over the reserved-only baseline: one row per
    # node carrying live allocs.
    k_u = encode.pow2_bucket(max(1, len(touched)), minimum=8)
    u_rows = np.full(k_u, -1, dtype=np.int32)
    u_vals = np.zeros((k_u, 4), dtype=np.int32)
    if touched:
        tr = np.asarray(touched, dtype=np.int64)
        u_rows[:len(touched)] = tr
        u_vals[:len(touched)] = ct.used[tr] - base.used[tr]

    with_networks = any(sp.net_active for sp in spec_list)
    static = {
        "attr": ct.attr_values, "elig": ct.eligible, "dc": ct.dc_code,
        "denom": ct.score_denom,
    }
    d = mesh.size if mesh is not None else 0
    # Capacity and the reserved-only baseline ship quantized when that is
    # exact, as int32 otherwise.
    quant = _quantized_rows(base, d, breaker)
    if quant is not None:
        static.update(cap_q=quant.cap_q, used_base_q=quant.used_q,
                      res_scale=quant.scale)
    else:
        static.update(cap=ct.capacity.astype(np.int32),
                      used_base=base.used.astype(np.int32))
    if with_networks:
        # Port words travel as the int32 bit images of their uint32 words.
        static.update(bw_cap=ct.bw_cap, bw_used_base=base.bw_used,
                      dyn_free_base=base.dyn_free,
                      port_words_base=base.port_words.view(np.int32))
    dyn = {
        "c_attr": st.constraint_attr, "c_op": st.constraint_op,
        "c_rhs": st.constraint_rhs, "dc_mask": st.dc_mask,
        "precomp": st.precomp, "ask": st.ask.astype(np.int32),
        "count": st.count, "penalty": st.penalty, "dh": st.distinct_hosts,
        "ji": st.job_index, "jc_rows": jc_rows, "jc_cols": jc_cols,
        "jc_vals": jc_vals, "u_rows": u_rows, "u_vals": u_vals,
        "rng_seed": np.array([int(rng_seed) & 0x7FFFFFFF], dtype=np.int32),
    }
    if with_networks:
        # Touched nodes: bandwidth and free dynamic ports as deltas over
        # the reserved-only baseline, port words whole (batch_sched.py:
        # 1119-1134).
        u_bw = np.zeros(k_u, dtype=np.int32)
        u_dyn = np.zeros(k_u, dtype=np.int32)
        u_ports = np.zeros((k_u, ct.port_words.shape[1]), dtype=np.uint32)
        if touched:
            u_bw[:len(touched)] = ct.bw_used[tr] - base.bw_used[tr]
            u_dyn[:len(touched)] = ct.dyn_free[tr] - base.dyn_free[tr]
            u_ports[:len(touched)] = ct.port_words[tr]
        dyn.update(net_active=st.net_active, net_mbits=st.net_mbits,
                   dyn_need=st.dyn_need,
                   resv_words=st.resv_words.view(np.int32), u_bw=u_bw,
                   u_dyn=u_dyn, u_ports=u_ports.view(np.int32))
    if any(sp.dp_target is not None for sp in spec_list):
        dyn.update(dp_col=st.dp_col, dp_active=st.dp_active,
                   dp_used=st.dp_used)
    total_asks = int(sum(sp.count for sp in spec_list))
    max_count = max(sp.count for sp in spec_list)
    plan = None
    if d:
        plan = encode.shape_plan(
            st.u_pad, ct.n_pad, ct.n_real, max_count, total_asks, mesh=True,
            slot_budget_bytes=MESH_SLOT_BUDGET_BYTES)
        if not plan[1]:
            # The slot record exceeds its budget: the single-chip path
            # (batch_sched.py:1512-1518), on the mesh's first device.
            logger.warning("mesh slot record for %d specs x %d max count "
                           "exceeds its budget; the batch takes the "
                           "single-chip path", st.u_pad, max_count)
            plan, d = None, 0
    if plan is None:
        plan = encode.shape_plan(st.u_pad, ct.n_pad, ct.n_real, max_count,
                                 total_asks)
    with_scores, slot_m, max_nnz = plan
    # k_cand >= the largest count (or the whole shard) keeps each round's
    # global top-k inside the gathered candidates, so the mesh commits
    # exactly what the single-chip loop commits (sharded.py:411-418).
    k_cand = (min(ct.n_pad // d, encode.pow2_bucket(max(64, max_count)))
              if d else 0)
    return _DeviceBatch(
        spec_list=spec_list, nodes=nodes, base=base, ct=ct, st=st,
        static=static, dyn=dyn, with_networks=with_networks,
        with_scores=with_scores, slot_m=slot_m, max_nnz=max_nnz, shards=d,
        k_cand=k_cand, touched=list(touched))


def _upload_static(sbuf: np.ndarray, meta_s, devices: Sequence,
                   sharded: bool, cache: Optional[LRU]):
    """The packed static buffer on its device(s) -- one row per shard when
    ``sharded`` -- and the bytes uploaded.  With ``cache``, a buffer
    whose content and layout were uploaded before to the same devices is
    reused and nothing is uploaded."""
    key = None
    if cache is not None:
        key = (hashlib.blake2b(sbuf, digest_size=16).hexdigest(), meta_s,
               tuple(str(dv) for dv in devices))
        hit = cache.get(key)
        if hit is not None:
            return hit, 0
    if sharded:
        dev_buf = [torch.from_numpy(sbuf[i]).to(dv)
                   for i, dv in enumerate(devices)]
    else:
        dev_buf = torch.from_numpy(sbuf).to(devices[0])
    if cache is not None:
        cache.put(key, dev_buf)
    return dev_buf, sbuf.nbytes


# The single-card device dispatches (batch_sched.py:1208-1257): the fused
# pass and its one result buffer; the two-pass program (summary and COO
# apart); and the staged one, which waits for the schedule half before
# the compact half and times both.  The reference picks with
# NOMAD_TPU_FUSED and NOMAD_TPU_TIMING=2; the port with an argument.
DISPATCHES = ("fused", "two_pass", "staged")


def check_dispatch(dispatch: str) -> str:
    if dispatch not in DISPATCHES:
        raise ValueError(f"dispatch {dispatch!r}: one of {DISPATCHES}")
    return dispatch


def _dispatch(b: _DeviceBatch, dev: torch.device, mesh=None,
              static_cache: Optional[LRU] = None, used_dev=None,
              dispatch: str = "fused") -> None:
    """Pack, upload and run the device pass of ``b`` (its result stays on
    the device until :func:`_fetch`).  ``used_dev`` is the lent resident
    usage mirror (a tensor, or the mesh's shard parts): the usage comes
    from it and the sparse usage rows stay home.  ``dispatch`` picks the
    single card's program (:data:`DISPATCHES`); the mesh has its own.
    The staged program builds its COO from the placement matrix
    (``b.slot_m`` becomes 0) and takes no mirror (batch_sched.py:1146,
    :1174, :1217)."""
    d = b.shards
    if dispatch == "staged" and not d:
        if used_dev is not None:
            raise ValueError("the staged dispatch takes no resident mirror")
        b.slot_m = 0
    if used_dev is not None:
        del b.dyn["u_rows"], b.dyn["u_vals"]
    if d:
        # Per-shard static packs: node rows cut to their owning shard.
        sbuf, meta_s = xfer.pack_host_sharded(b.static, d,
                                              replicate=("res_scale",))
    else:
        sbuf, meta_s = xfer.pack_host(b.static)
    dbuf, meta_d = xfer.pack_host(b.dyn)
    b.t_dispatch = time.perf_counter()
    b.timer = _DeviceTimer(dev)
    dyn_dev = torch.from_numpy(dbuf).to(dev)
    static_dev, b.static_h2d_bytes = _upload_static(
        sbuf, meta_s, mesh.devices if d else [dev], bool(d), static_cache)
    b.h2d_bytes = dbuf.nbytes + b.static_h2d_bytes
    st, ct = b.st, b.ct
    if d:
        from ..parallel import sharded

        # The replicated dyn buffer goes to the other devices inside the
        # pass.
        b.out = sharded.sharded_fused_pass(
            mesh, static_dev, dyn_dev, meta_s=meta_s, meta_d=meta_d,
            u_pad=st.u_pad, n_pad=ct.n_pad, with_scores=b.with_scores,
            max_nnz=b.max_nnz, slot_m=b.slot_m, k_cand=b.k_cand,
            used_dev=used_dev)
    elif dispatch == "fused":
        b.out = kernels.fused_pass(
            static_dev, dyn_dev, meta_s=meta_s, meta_d=meta_d,
            u_pad=st.u_pad, n_pad=ct.n_pad, with_scores=b.with_scores,
            max_nnz=b.max_nnz, slot_m=b.slot_m, used_dev=used_dev)
    elif dispatch == "two_pass":
        b.out = kernels.device_pass(
            static_dev, dyn_dev, used_dev, meta_s=meta_s, meta_d=meta_d,
            u_pad=st.u_pad, n_pad=ct.n_pad, with_scores=b.with_scores,
            max_nnz=b.max_nnz, slot_m=b.slot_m)
    else:
        b.out = _staged_pass(b, static_dev, dyn_dev, meta_s, meta_d)


def _staged_pass(b: _DeviceBatch, static_dev, dyn_dev, meta_s,
                 meta_d) -> kernels.PassOutput:
    """The two halves of the device program one after the other, each
    waited for (batch_sched.py:1208-1237): the schedule and the compact
    seconds are logged and kept in ``b.timings``."""
    st, ct = b.st, b.ct
    t0 = time.perf_counter()
    result, feas = kernels.device_schedule(
        static_dev, dyn_dev, meta_s=meta_s, meta_d=meta_d, u_pad=st.u_pad,
        n_pad=ct.n_pad, with_scores=b.with_scores, slot_m=0)
    _device_sync(result.unplaced)
    t1 = time.perf_counter()
    logger.warning("staged: schedule %.3fs", t1 - t0)
    summary, coo = kernels.device_compact(
        result, feas, with_scores=b.with_scores, max_nnz=b.max_nnz,
        compact_u16=kernels.compact_u16_ok(st.u_pad, ct.n_pad,
                                           b.with_scores))
    _device_sync(summary)
    t2 = time.perf_counter()
    logger.warning("staged: compact %.3fs", t2 - t1)
    b.timings.update(schedule=t1 - t0, compact=t2 - t1)
    return kernels.PassOutput(summary=summary, coo=coo, feas=feas,
                              commit_steps=result.commit_steps)


def _device_sync(t: torch.Tensor) -> None:
    """Wait for the work that produces ``t`` (the staged dispatch's split;
    the reference reads a slice of the result)."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


# The two-pass fetch takes summary and COO in one transfer up to this many
# COO bytes, else the summary first and a bucketed prefix of the COO
# (batch_sched.py:1366-1408).
TWO_PASS_TOGETHER_BYTES = 4 << 20


def _fetch(b: _DeviceBatch):
    """The result fetch: ``(summary, coo int64 [nnz, C], fetched
    bytes)``.  Sets ``b.device_seconds``.  The fused buffer comes in one
    transfer (past its payload window, one more prefix fetch of the
    overflow source); the two-pass and staged outputs as the summary and
    a prefix of the COO."""
    if isinstance(b.out, kernels.PassOutput):
        summary, coo, fetch_bytes = _fetch_two_pass(b)
    else:
        raw = b.out.buf.cpu().numpy()
        fetch_bytes = raw.nbytes
        summary = xfer.unpack_host(raw, b.out.meta)
        nnz = int(summary["scalars"][0])
        coo = summary["coo"]
        if nnz > coo.shape[0]:
            coo = _overflow_coo(b.out, nnz, b.max_nnz, b.with_scores,
                                coo.dtype == np.uint16)
            fetch_bytes += coo.nbytes
        coo = coo[:nnz]
    b.device_seconds = b.timer.seconds()
    return summary, np.asarray(coo, dtype=np.int64), fetch_bytes


def _fetch_two_pass(b: _DeviceBatch):
    """Summary and COO of a :class:`kernels.PassOutput`: together when the
    whole COO is small, else the summary and then a power-of-two prefix
    of the COO (a stable slice shape from batch to batch)."""
    out = b.out
    layout = kernels.summary_layout(b.st.u_pad, b.ct.n_pad)
    u16 = out.coo.dtype == torch.int16
    if out.coo.numel() * out.coo.element_size() <= TWO_PASS_TOGETHER_BYTES:
        raw, coo = _fetch_together([out.summary, out.coo])
        summary = xfer.unpack_host(raw, layout)
        fetch_bytes = raw.nbytes + coo.nbytes
        coo = coo[:int(summary["scalars"][0])]
    else:
        raw = out.summary.cpu().numpy()
        summary = xfer.unpack_host(raw, layout)
        nnz = int(summary["scalars"][0])
        nnz_b = min(b.max_nnz, encode.pow2_bucket(max(nnz, 1), minimum=8))
        coo = out.coo[:nnz_b].cpu().numpy()
        fetch_bytes = raw.nbytes + coo.nbytes
        coo = coo[:nnz]
    return summary, coo.view(np.uint16) if u16 else coo, fetch_bytes


def _fetch_together(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """``tensors`` (one device) back to the host in one transfer: packed
    as bytes on the device, copied once, cut into numpy arrays of their
    dtypes and shapes."""
    if not tensors:
        return []
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    raw = torch.cat(flat).cpu().numpy()
    out, off = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel()
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(raw[off:off + n].view(dtype).reshape(tuple(t.shape)))
        off += n
    return out


def _overflow_coo(out, nnz, max_nnz, with_scores, compact_u16):
    """nnz beyond the payload window: one extra prefix fetch from the
    overflow source left on the device."""
    kind, aux = out.aux
    nnz_b = min(max_nnz, encode.pow2_bucket(nnz, minimum=8))
    if kind == "coo":
        coo = aux[:nnz_b]
    else:
        _, coo, _ = kernels._slots_coo_gather(
            *aux, out_rows=nnz_b, with_scores=with_scores,
            compact_u16=compact_u16)
    coo = coo.cpu().numpy()
    return (coo & 0xFFFF) if compact_u16 else coo


def _coo_scores(coo: np.ndarray, with_scores: bool):
    """The commit scores and collision counts of the COO entries."""
    if with_scores:
        return (coo[:, 3].astype(np.int32).view(np.float32),
                coo[:, 4].astype(np.int32))
    return (np.zeros(len(coo), dtype=np.float32),
            np.zeros(len(coo), dtype=np.int32))


def _decode(spec_list, ct, unplaced_arr, coo, with_scores,
            native_decode: bool = True,
            decode_guard_every: int = decode.GUARD_EVERY
            ) -> Dict[Tuple[str, str], SpecPlacement]:
    """The fetched device result as one :class:`SpecPlacement` per spec
    (``_finalize``, batch_sched.py:1583-1716): the ``ops.kernel_result``
    fault point, validation (a violation raises
    :class:`KernelIntegrityError` and nothing is used), the per-alloc
    node ids in commit order, and the AllocMetric scores.  The two COO
    passes run natively (``ops/decode.py``, its guard every
    ``decode_guard_every`` calls) or, with ``native_decode=False``, on
    their numpy twins."""
    rows, cols, counts = coo[:, 0], coo[:, 1], coo[:, 2]
    # Chaos hook: corrupt the fetched outputs (the damage a flaky card
    # would do), then validate.
    act = fault.faultpoint("ops.kernel_result")
    if act is not None and act.kind == "corrupt":
        unplaced_arr, counts = _corrupt_outputs(act.rng, spec_list,
                                                unplaced_arr, counts)
    problem = validate_device_outputs(spec_list, ct, unplaced_arr, rows,
                                      cols, counts)
    if problem is not None:
        raise KernelIntegrityError(problem)
    n_specs = len(spec_list)
    scores, coll = _coo_scores(coo, with_scores)
    exp_off, exp_idx = decode.expand_coo(rows, cols, counts, n_specs,
                                         ct.n_real, native=native_decode,
                                         guard_every=decode_guard_every)
    valid = (rows >= 0) & (cols < ct.n_real)
    per_alloc_sc = np.repeat(scores[valid], counts[valid])
    per_alloc_co = np.repeat(coll[valid], counts[valid])
    s_off, s_col, s_sc, s_co = decode.last_scores(
        rows, cols, scores, coll, n_specs, ct.n_real, native=native_decode,
        guard_every=decode_guard_every)
    node_ids = np.array(ct.node_ids, dtype=object)
    out: Dict[Tuple[str, str], SpecPlacement] = {}
    for u, sp in enumerate(spec_list):
        lo, hi = int(exp_off[u]), int(exp_off[u + 1])
        # "<node>.binpack" per distinct placed node (rank.go:139) and
        # "<node>.job-anti-affinity" where the commit had same-job
        # collisions (rank.go:167); last commit wins.
        metric: Dict[str, float] = {}
        if with_scores:
            a, b = int(s_off[u]), int(s_off[u + 1])
            ids = node_ids[s_col[a:b]].tolist()
            metric = {nid + ".binpack": sc
                      for nid, sc in zip(ids, s_sc[a:b].tolist())}
            pen = float(sp.anti_affinity_penalty)
            for j in np.nonzero(s_co[a:b] > 0)[0].tolist():
                metric[ids[j] + ".job-anti-affinity"] = -pen * int(s_co[a + j])
        out[(sp.job.id, sp.tg.name)] = SpecPlacement(
            node_ids=node_ids[exp_idx[lo:hi]].tolist(),
            scores=per_alloc_sc[lo:hi], collisions=per_alloc_co[lo:hi],
            unplaced=int(unplaced_arr[u]), metric_scores=metric)
    return out


class _NetIndexes(dict):
    """Node id -> the batch's ``NetworkIndex`` of that node, made on first
    use from ``node_of(id)`` and ``live_allocs_of(id)``.  Each index takes
    every offer as it is made, so the port numbers picked for one batch
    never collide."""

    def __init__(self, node_of, live_allocs_of):
        super().__init__()
        self.node_of = node_of
        self.live_allocs_of = live_allocs_of

    def __missing__(self, node_id: str) -> NetworkIndex:
        idx = self[node_id] = NetworkIndex()
        node = self.node_of(node_id)
        if node is not None:
            idx.set_node(node)
            idx.add_allocs(self.live_allocs_of(node_id))
        return idx


def _offer_group(tg: s.TaskGroup, net_asks, node_ids: Sequence[str],
                 rng: random.Random, indexes: _NetIndexes
                 ) -> List[Optional[Dict[str, s.NetworkResource]]]:
    """Concrete network offers for one task group's placed allocs
    (batch_sched.py:2226-2270, rank.go:199, network.go:245): the device
    counted ports and bandwidth; here each task gets its IP and port
    numbers, drawn from ``rng`` in placement order.  Per alloc, task name
    -> its offer, or None where an offer failed (logged; the caller
    leaves that alloc unplaced, as the reference does)."""
    out: List[Optional[Dict[str, s.NetworkResource]]] = []
    for nid in node_ids:
        idx = indexes[nid]
        nets: Optional[Dict[str, s.NetworkResource]] = {}
        for t in tg.tasks:
            ask_net = net_asks.get(t.name)
            if ask_net is None:
                continue
            offer, err = idx.assign_network(ask_net, rng)
            if offer is None:
                logger.warning("batch: network offer failed on %s: %s",
                               nid, err)
                nets = None
                break
            idx.add_reserved(offer)
            nets[t.name] = offer
        out.append(nets)
    return out


# -- the list entry -------------------------------------------------------------

def schedule_batch(nodes: Sequence[s.Node], jobs: Sequence[s.Job],
                   live_allocs: Iterable[s.Allocation] = (),
                   rng_seed: Optional[int] = None,
                   device=None, mesh=None,
                   eval_ids: Optional[Sequence[str]] = None,
                   native_decode: bool = True,
                   decode_guard_every: int = decode.GUARD_EVERY,
                   dispatch: str = "fused") -> BatchResult:
    """Place every task group of ``jobs`` on ``nodes`` in one device pass.

    ``nodes`` is the cluster in the order the node index follows (the
    index enters the tie-break jitter and the tie order).
    ``live_allocs`` are the allocations already running: their usage,
    ports and bandwidth are layered onto the nodes, they count as
    same-job collisions, and they hold their distinct_property values.
    ``rng_seed`` pins the tie-break seed (the reference's
    ``NOMAD_TPU_RNG_SEED``); None draws one.  ``device`` defaults to
    ``cuda`` and raises without it.

    ``eval_ids`` gives each job its evaluation id, in the order of
    ``jobs``: the port numbers of a task group's offers come from
    ``random.Random(<its evaluation id>)``, as in the reference's
    finalize (batch_sched.py:2236), so the same ids give the same offers
    from run to run.  None draws a fresh id per job.

    ``mesh`` (a :class:`nomad_tpu_torch.parallel.NodeMesh`, instead of
    ``device``) places the batch node-sharded over the mesh's devices,
    the counterpart of ``TPUBatchScheduler(mesh=...)``
    (batch_sched.py:1464-1580): same placements and scores as the
    single-chip path, and ``mesh_shards`` in the result.

    ``dispatch`` picks the single card's device program
    (:data:`DISPATCHES`): ``"fused"``, ``"two_pass"``, or ``"staged"``,
    whose schedule and compact seconds land in ``timings``."""
    if mesh is not None and device is not None:
        raise ValueError("pass a device or a mesh, not both")
    check_dispatch(dispatch)
    dev = mesh.root if mesh is not None else resolve_device(device)
    t0 = time.perf_counter()
    live = [a for a in live_allocs if not a.terminal_status()]
    live_by_spec: Dict[Tuple[str, str], int] = {}
    allocs_by_node: Dict[str, List[s.Allocation]] = {}
    nodes_by_job: Dict[str, List[str]] = {}
    for a in live:
        key = (a.job_id, a.task_group)
        live_by_spec[key] = live_by_spec.get(key, 0) + 1
        allocs_by_node.setdefault(a.node_id, []).append(a)
        nodes_by_job.setdefault(a.job_id, []).append(a.node_id)
    if eval_ids is None:
        eval_ids = [s.generate_uuid() for _ in jobs]
    if len(eval_ids) != len(jobs):
        raise ValueError(f"{len(eval_ids)} evaluation ids for "
                         f"{len(jobs)} jobs")
    nodes_by_id = {n.id: n for n in nodes}
    spec_list = _prepare_specs(jobs, live_by_spec, live, nodes_by_id)
    if not spec_list:
        return BatchResult({}, 0, str(dev))
    with_networks = any(sp.net_active for sp in spec_list)
    if with_networks and not cluster_networks_simple(nodes):
        raise NotImplementedError(
            "multi-device/multi-IP node networks; the reference places "
            "network asks on such a cluster with its CPU oracle, which "
            "needs a state store: schedule it through TorchBatchScheduler")

    attr_targets, literals = encode.collect_attr_targets(spec_list)
    base = _cluster_static(nodes, attr_targets, literals, with_networks,
                           _node_pad_multiple(mesh))
    if rng_seed is None:
        rng_seed = int.from_bytes(os.urandom(4), "big")
    ct, touched = _layer_usage(base, allocs_by_node)
    b = _encode_batch(spec_list, list(nodes), base, ct, touched,
                      lambda job_id: nodes_by_job.get(job_id, ()), rng_seed,
                      mesh)
    _dispatch(b, dev, mesh, dispatch=dispatch)
    summary, coo, _ = _fetch(b)
    t2 = time.perf_counter()

    placements = _decode(spec_list, b.ct, summary["unplaced"], coo,
                         b.with_scores, native_decode, decode_guard_every)
    if with_networks:
        _offer_networks(jobs, eval_ids, spec_list, placements, nodes_by_id,
                        allocs_by_node)
    t3 = time.perf_counter()
    return BatchResult(
        placements=placements, rounds=int(summary["scalars"][1]),
        device=str(dev),
        timings={"encode": b.t_dispatch - t0, "device": b.device_seconds,
                 "decode": t3 - t2, **b.timings}, mesh_shards=b.shards)


def _offer_networks(jobs, eval_ids, spec_list, placements, nodes_by_id,
                    allocs_by_node) -> None:
    """The offers of every placed alloc of a spec with network asks
    (:func:`_offer_group`), seeded from ``nodes_by_id`` and the live
    ``allocs_by_node``.  The jobs go in their given order, their groups
    in job order, and a group's port picks draw from
    ``random.Random(<the job's evaluation id>)``, made anew for each
    group -- the reference's order, so its offers repeat bit for bit."""
    specs = {(sp.job.id, sp.tg.name): sp for sp in spec_list}
    indexes = _NetIndexes(nodes_by_id.get,
                          lambda nid: allocs_by_node.get(nid, []))
    for job, ev_id in zip(jobs, eval_ids):
        for tg in job.task_groups:
            key = (job.id, tg.name)
            spec, res = specs.get(key), placements.get(key)
            if spec is None or res is None or not spec.net_asks:
                continue
            offers = _offer_group(tg, spec.net_asks, res.node_ids,
                                  random.Random(ev_id), indexes)
            keep = [i for i, nets in enumerate(offers) if nets is not None]
            lost = len(res.node_ids) - len(keep)
            if lost:
                res.node_ids = [res.node_ids[i] for i in keep]
                res.scores = res.scores[keep]
                res.collisions = res.collisions[keep]
                res.unplaced += lost
            res.networks = [offers[i] for i in keep]


# -- the eval-driven entry ------------------------------------------------------

class _CollectingScheduler(GenericScheduler):
    """A GenericScheduler whose placement loop *collects* asks instead of
    selecting nodes (batch_sched.py:214); everything else (diff, stops,
    in-place updates, rolling limits, blocked evals) is the oracle's."""

    def __init__(self, logger_, state, planner, batch: bool):
        super().__init__(logger_, state, planner, batch,
                         preemption_enabled=False)
        # Placement asks in bulk: per task group, (tg, names-or-count,
        # prev-ids-or-None).  The register fast path stores the count
        # only: names are formulaic '<job>.<tg>[i]' (util.go:22) and made
        # at finalize for the placements that happen.
        self.pending_bulk: List[Tuple] = []
        self.nodes_by_dc: Dict[str, int] = {}
        # The batch's shared cache of dc-tuple -> nodes-by-dc counts.
        self.dc_cache: Optional[Dict[Tuple[str, ...], Dict[str, int]]] = None

    def _set_nodes_by_dc(self) -> None:
        dcs = tuple(self.job.datacenters)
        if self.dc_cache is not None and dcs in self.dc_cache:
            self.nodes_by_dc = self.dc_cache[dcs]
        else:
            _, by_dc = ready_nodes_in_dcs(self.state, self.job.datacenters)
            self.nodes_by_dc = by_dc
            if self.dc_cache is not None:
                self.dc_cache[dcs] = by_dc

    def _compute_job_allocs(self) -> None:
        """Register fast path (batch_sched.py:244): a job with no existing
        allocations places every instance (the diff is the identity,
        util.go:70), so the name dict, the tuples, the taint scan and the
        in-place machinery are skipped.  Anything with history, and an
        ``annotate_plan`` eval (its annotations come from the diff), takes
        the oracle's path."""
        job = self.job
        if (job is None or job.stopped() or self.eval.annotate_plan
                or self.state.allocs_by_job(None, self.eval.job_id, True)):
            super()._compute_job_allocs()
            return
        bulk = []
        for tg in job.task_groups:
            if tg.count <= 0:
                continue
            self.queued_allocs[tg.name] = tg.count
            bulk.append((tg, tg.count, None))
        self.pending_bulk = bulk
        if bulk:
            self._set_nodes_by_dc()

    def _compute_placements(self, place: List[AllocTuple]) -> None:
        self._set_nodes_by_dc()
        by_tg: Dict[str, Tuple[s.TaskGroup, List[str],
                               List[Optional[str]]]] = {}
        order: List[Tuple[s.TaskGroup, List[str], List[Optional[str]]]] = []
        for tup in place:
            ent = by_tg.get(tup.task_group.name)
            if ent is None:
                ent = (tup.task_group, [], [])
                by_tg[tup.task_group.name] = ent
                order.append(ent)
            ent[1].append(tup.name)
            ent[2].append(tup.alloc.id if tup.alloc is not None else None)
        self.pending_bulk = [
            (tg, names,
             prevs if any(p is not None for p in prevs) else None)
            for tg, names, prevs in order]


class _PreparedBatch:
    """One batch between prepare and complete."""

    __slots__ = ("evals", "scheds", "specs", "spec_list", "stats", "t0",
                 "handle", "probe", "routed")

    def __init__(self, evals):
        self.evals = evals
        self.scheds = []
        self.specs = {}
        self.spec_list = []
        self.stats = BatchStats()
        self.t0 = time.perf_counter()
        self.handle: Optional[_DeviceBatch] = None
        self.probe = False      # this batch is the breaker's half-open probe
        self.routed = False     # breaker open: already oracle-processed


class TorchBatchScheduler:
    """The ``torch-batch`` scheduler: ``process(ev)`` handles one eval,
    ``schedule_batch(evals)`` a batch (batch_sched.py:304).

    ``state`` is a state store snapshot and ``planner`` takes the plans
    (``scheduler.testing.Harness``, or a server's plan queue).  The
    device pass runs on ``device`` (default ``cuda``; raises without a
    card) or node-sharded over ``mesh``.  ``rng_seed`` pins the
    tie-break seed (the reference's ``NOMAD_TPU_RNG_SEED``); None draws
    one per batch.  ``breaker`` defaults to the process-wide
    ``ops.breaker.BREAKER``.

    ``preemption_enabled`` (default False; the reference's
    ``NOMAD_TPU_PREEMPTION``, read from no environment here) runs the
    priority-tier preemption pass for asks the capacity loop left
    unplaced: the eviction-set kernel on the device (once per batch, over
    the whole node axis on the mesh's first device), the commit on the
    host (at most one preempting placement per node, each checked against
    the scalar oracle), the victims in the plan's ``node_preemptions``.
    Specs with network asks, ``distinct_property`` or ``distinct_hosts``
    keep the capacity pass's result.  The CPU oracle routes (gate,
    breaker, reject, plan conflict) take the same flag.

    ``metrics`` (a ``utils.telemetry.Telemetry``) takes each batch's
    ``BatchStats`` as the reference's ``worker.invoke_scheduler.*``
    samples and ``batch.*``/``breaker.*`` counters and gauges.

    The resident usage mirror (``ops/resident.py``) takes the place of
    the usage walk in batches without network asks, over a snapshot with
    a delta feed: ``resident`` turns it on (the reference's
    ``NOMAD_TPU_RESIDENT``), ``resident_device`` lends its device twin to
    the pass instead of shipping sparse usage rows
    (``NOMAD_TPU_RESIDENT_DEVICE``), and ``guard_every`` is the
    differential guard's cadence in delta hits, 0 for never
    (``NOMAD_TPU_RESIDENT_GUARD_EVERY``).

    The static tensors and, where the resident mirror does not serve it,
    the live usage are sliced from the state store's columnar mirror
    (``state/columnar.py``; on unless the store was made with
    ``columnar=False``); ``columnar_guard_every`` is the cadence of its
    guards in columnar encodes and usage reads, 0 for never (the
    reference's ``NOMAD_TPU_COLUMNAR_GUARD_EVERY``, default 16).

    The fetched result is decoded by ``native/decode.cc``;
    ``native_decode=False`` asks for the numpy twins instead, and
    ``decode_guard_every`` is the native decode's guard cadence per
    function, 0 for never (the reference's ``NOMAD_TPU_NO_NATIVE`` and
    ``NOMAD_TPU_DECODE_GUARD_EVERY``, default 64).  A guard mismatch
    raises ``decode.DecodeGuardError``: the batch is nacked.

    ``dispatch`` picks the single card's device program (the reference's
    ``NOMAD_TPU_FUSED`` and ``NOMAD_TPU_TIMING=2``): ``"fused"`` (the
    default: one result buffer), ``"two_pass"`` (the summary and the COO
    apart, ``kernels.device_pass``) or ``"staged"`` (the schedule half
    waited for before the compact half; both seconds in
    ``BatchStats.timings``; COO from the placement matrix; no resident
    loan).  The mesh keeps its own program."""

    def __init__(self, logger_: logging.Logger, state, planner, mesh=None,
                 device=None, preemption_enabled: bool = False,
                 breaker=None, rng_seed: Optional[int] = None,
                 resident: bool = True, resident_device: bool = True,
                 guard_every: int = 64, metrics=None,
                 columnar_guard_every: int = columnar.GUARD_EVERY,
                 native_decode: bool = True,
                 decode_guard_every: int = decode.GUARD_EVERY,
                 dispatch: str = "fused"):
        if mesh is not None and device is not None:
            raise ValueError("pass a device or a mesh, not both")
        self.dispatch = check_dispatch(dispatch)
        self.logger = logger_
        self.state = state
        self.planner = planner
        self.mesh = mesh
        self.device = mesh.root if mesh is not None else resolve_device(
            device)
        self.preemption_enabled = preemption_enabled
        # Per batch, the preemption pass's commits: (job id, group) ->
        # [(node id, victim allocs)], read by _finalize.
        self._preempt_plan: Dict[Tuple[str, str],
                                 List[Tuple[str, List[s.Allocation]]]] = {}
        self.breaker = (breaker if breaker is not None
                        else breaker_mod.BREAKER)
        self.rng_seed = rng_seed
        self.resident = resident
        self.resident_device = resident_device
        self.guard_every = guard_every
        self.columnar_guard_every = columnar_guard_every
        self.native_decode = native_decode
        self.decode_guard_every = decode_guard_every
        self.metrics = metrics if metrics is not None else NULL_TELEMETRY

    def process(self, ev: s.Evaluation) -> None:
        self.schedule_batch([ev])

    def schedule_batch(self, evals: List[s.Evaluation]) -> "BatchStats":
        """Reconcile every eval on the host, place all their asks in one
        device pass, then finalize and submit one plan per eval, under a
        ``batch.schedule`` span; the batch's stats go to the
        telemetry."""
        tr = tracing.TRACER
        if tr is None:
            stats = self._schedule_batch(evals)
        else:
            with tr.span("batch.schedule",
                         num_evals=len(evals),
                         **tracing.eval_id_attrs(evals, len(evals))) as sp:
                stats = self._schedule_batch(evals)
                sp.set(num_specs=stats.num_specs, num_asks=stats.num_asks,
                       breaker_state=stats.breaker_state,
                       oracle_routed=stats.oracle_routed,
                       resident_hits=stats.resident_hits,
                       delta_rows=stats.delta_rows,
                       h2d_bytes=stats.h2d_bytes,
                       delta_apply_s=round(stats.delta_apply_seconds, 6))
        self._emit_batch_stats(stats)
        return stats

    def _schedule_batch(self, evals: List[s.Evaluation]) -> "BatchStats":
        prep = self._prepare_batch(evals)
        self._dispatch_prepared(prep)
        return self._complete_prepared(prep)

    def _emit_batch_stats(self, stats: "BatchStats") -> None:
        """The batch's stats as telemetry (batch_sched.py:380-470): the
        timings in milliseconds, bytes as counters, the breaker's live
        state and trips as gauges, and the oracle routes and rejects as
        counters."""
        m = self.metrics
        m.add_sample("worker.invoke_scheduler",
                     stats.total_seconds * 1000.0)
        m.add_sample("worker.invoke_scheduler.phase1",
                     stats.phase1_seconds * 1000.0)
        m.add_sample("worker.invoke_scheduler.phase2",
                     stats.phase2_seconds * 1000.0)
        # The device phases only when the device pass ran: an oracle-
        # routed batch would flood their windows with zeros.
        if stats.device_ran:
            m.add_sample("worker.invoke_scheduler.encode",
                         stats.encode_seconds * 1000.0)
            m.add_sample("worker.invoke_scheduler.device",
                         stats.device_seconds * 1000.0)
            m.add_sample("worker.invoke_scheduler.rounds", stats.rounds)
            # The port's addition: the steps that launch scored_rows.
            m.incr_counter("batch.commit_steps", stats.commit_steps)
            # The port's host decode and forensics (the reference splits
            # its commit and fetch).
            m.add_sample("worker.invoke_scheduler.metrics",
                         stats.metrics_seconds * 1000.0)
            m.incr_counter("batch.fetch_bytes", stats.fetch_bytes)
            m.incr_counter("batch.mesh_h2d_bytes" if stats.mesh_shards
                           else "batch.h2d_bytes", stats.h2d_bytes)
            if stats.delta_apply_seconds:
                m.add_sample(
                    "batch.mesh_delta_apply" if stats.mesh_shards
                    else "batch.delta_apply",
                    stats.delta_apply_seconds * 1000.0)
        if not stats.oracle_routed:
            m.add_sample("worker.invoke_scheduler.finalize",
                         stats.finalize_seconds * 1000.0)
        m.add_sample("worker.invoke_scheduler.asks", stats.num_asks)
        if stats.resident_hits:
            m.incr_counter("batch.resident_hits", stats.resident_hits)
            m.add_sample("batch.delta_rows", stats.delta_rows)
        if stats.full_reencodes:
            m.incr_counter("batch.full_reencodes", stats.full_reencodes)
        if stats.staleness_fences:
            m.incr_counter("batch.staleness_fences", stats.staleness_fences)
        if stats.pipeline_overlap_s:
            m.add_sample("batch.pipeline_overlap",
                         stats.pipeline_overlap_s * 1000.0)
        if resident.GUARD_MISMATCHES:
            m.set_gauge("batch.resident_guard_mismatches",
                        resident.GUARD_MISMATCHES)
        if resident.DEV_GUARD_MISMATCHES:
            m.set_gauge("batch.resident_dev_mismatches",
                        resident.DEV_GUARD_MISMATCHES)
        if resident.DEV_APPLIES:
            m.set_gauge("batch.resident_dev_applies", resident.DEV_APPLIES)
        # Distinct launch signatures seen process-wide (batch_sched.py:451;
        # kernels.note_signature says what they count in the port).
        m.set_gauge("batch.compiles", kernels.compile_signatures())
        if stats.mesh_shards:
            m.incr_counter("batch.mesh_passes", 1)
            m.set_gauge("batch.mesh_shards", stats.mesh_shards)
        m.set_gauge("breaker.trips", self.breaker.trips)
        # The live breaker, not stats.breaker_state: a batch that never
        # reaches the gate keeps the "closed" default.
        m.set_gauge("breaker.state",
                    breaker_mod.STATE_CODE.get(self.breaker.state, 0))
        if stats.oracle_routed:
            m.incr_counter("breaker.oracle_routed", stats.oracle_routed)
        if stats.kernel_rejects:
            m.incr_counter("breaker.kernel_rejects", stats.kernel_rejects)

    def schedule_stream(self, batches, state_source=None
                        ) -> List["BatchStats"]:
        """A stream of eval batches, in the reference's pipelined order
        (batch_sched.py:482-553): prepare(k+1), then complete(k), then
        dispatch(k+1), so batch k+1's usage is read after batch k's
        plans were applied.  ``state_source`` (a callable giving a fresh
        snapshot) is called before each prepare and again before each
        dispatch.

        The port's device pass runs to its end inside the dispatch (the
        placement loop reads a count back each committing step), so
        prepare(k+1) does not overlap batch k's pass here: the order and
        its results are the reference's, the overlap is not.  A batch's
        ``pipeline_overlap_s`` is the time of its prepare while a
        dispatched batch was pending.  An error completes the batch in
        flight, then propagates.  Each completed batch is recorded as a
        ``batch.schedule`` span from its prepare to its completion, and
        its stats go to the telemetry (the reference's
        ``_finish_stream``)."""
        out: List[BatchStats] = []
        pending = None
        try:
            for evals in batches:
                if state_source is not None:
                    self.state = state_source()
                t_prep = time.perf_counter()
                prep = self._prepare_batch(evals)
                overlap = (time.perf_counter() - t_prep
                           if pending is not None else 0.0)
                if pending is not None:
                    out.append(self._complete_emitted(pending))
                    pending = None
                if state_source is not None:
                    self.state = state_source()
                prep.stats.pipeline_overlap_s = overlap
                self._dispatch_prepared(prep)
                pending = prep
        except BaseException:
            # The batch in flight is completed before the error goes on:
            # its plans are submitted and a probe it carries resolves.
            if pending is not None:
                try:
                    out.append(self._complete_emitted(pending))
                except Exception:
                    self.logger.exception(
                        "in-flight batch failed during stream unwind")
            raise
        if pending is not None:
            out.append(self._complete_emitted(pending))
        return out

    def _complete_emitted(self, prep: _PreparedBatch) -> "BatchStats":
        stats = self._complete_prepared(prep)
        tr = tracing.TRACER
        if tr is not None:
            tr.record("batch.schedule", prep.t0, tracing.now(),
                      num_evals=stats.num_evals, num_specs=stats.num_specs,
                      resident_hits=stats.resident_hits,
                      pipeline_overlap_s=round(stats.pipeline_overlap_s, 4),
                      **tracing.eval_id_attrs(prep.evals, len(prep.evals)))
        self._emit_batch_stats(stats)
        return stats

    # -- phase 1 and 2: reconcile, dedup, gate ------------------------------

    def _prepare_batch(self, evals: List[s.Evaluation]) -> _PreparedBatch:
        prep = _PreparedBatch(evals)
        stats = prep.stats

        # Phase 1: host reconciliation per eval (the oracle's code).
        t_phase1 = time.perf_counter()
        dc_cache: Dict[Tuple[str, ...], Dict[str, int]] = {}
        scheds: List[Tuple[s.Evaluation, _CollectingScheduler]] = []
        for ev in evals:
            sched = _CollectingScheduler(
                self.logger, self.state, self.planner,
                batch=(ev.type == s.JOB_TYPE_BATCH))
            sched.dc_cache = dc_cache
            sched.eval = ev
            sched.job = self.state.job_by_id(None, ev.job_id)
            sched.plan = ev.make_plan(sched.job)
            sched.ctx = EvalContext(self.state, sched.plan, self.logger)
            sched.stack = GenericStack(sched.batch, sched.ctx)
            if sched.job is not None and not sched.job.stopped():
                sched.stack.set_job(sched.job)
            sched._compute_job_allocs()
            scheds.append((ev, sched))
        stats.phase1_seconds = time.perf_counter() - t_phase1
        tr = tracing.TRACER
        if tr is not None:
            tr.record("batch.phase1", t_phase1,
                      t_phase1 + stats.phase1_seconds,
                      num_evals=len(evals))
        t_phase2 = time.perf_counter()

        # Phase 2: dedup placement asks into specs.
        specs: Dict[Tuple[str, str], encode.PlacementSpec] = {}
        spec_evs: Dict[Tuple[str, str], s.Evaluation] = {}
        for ev, sched in scheds:
            for tg, names_or_count, prevs in sched.pending_bulk:
                key = (sched.job.id, tg.name)
                spec = specs.get(key)
                if spec is None:
                    spec = encode.build_spec(sched.job, tg, sched.batch)
                    if spec.dp_target is not None:
                        spec.dp_used_values = self._dp_used_values(sched,
                                                                   spec)
                    specs[key] = spec
                    spec_evs[key] = ev
                spec.count += (names_or_count
                               if isinstance(names_or_count, int)
                               else len(names_or_count))

        # Gate: the evals of specs the device pass cannot express go
        # through the oracle whole, never mis-placed.
        gated = self._gate_oracle_evals(specs, spec_evs)
        if gated:
            for key in [k for k, ev in spec_evs.items() if ev.id in gated]:
                del specs[key]
            kept = []
            for ev, sched in scheds:
                if ev.id in gated:
                    self.logger.info("batch: eval %s routed through the "
                                     "CPU oracle: %s", ev.id, gated[ev.id])
                    stats.gate_routed += 1
                    self._route_through_oracle([(ev, sched)])
                else:
                    kept.append((ev, sched))
            scheds = kept
            evals = [ev for ev, _ in scheds]

        spec_list = sorted(specs.values(), key=lambda sp: -sp.priority)
        stats.num_specs = len(spec_list)
        stats.num_asks = sum(sp.count for sp in spec_list)
        stats.phase2_seconds = time.perf_counter() - t_phase2
        if tr is not None:
            tr.record("batch.phase2", t_phase2,
                      t_phase2 + stats.phase2_seconds,
                      num_specs=stats.num_specs, num_asks=stats.num_asks)
        prep.evals = evals
        prep.scheds = scheds
        prep.specs = specs
        prep.spec_list = spec_list
        return prep

    def _gate_oracle_evals(self, specs, spec_evs) -> Dict[str, str]:
        """Eval id -> the reason its spec cannot take the device pass."""
        out: Dict[str, str] = {}
        simple_networks: Optional[bool] = None
        for key, sp in specs.items():
            reason = sp.needs_oracle
            if not reason and sp.net_active:
                if simple_networks is None:
                    simple_networks = cluster_networks_simple(
                        self.state.nodes(None))
                if not simple_networks:
                    reason = "multi-device/multi-IP node networks"
            if reason:
                out.setdefault(spec_evs[key].id, reason)
        return out

    def _dp_used_values(self, sched, spec) -> set:
        """Existing + proposed - cleared values of the spec's
        distinct_property (propertyset.go:57), from state and this eval's
        plan after reconciliation (batch_sched.py:840)."""
        con = next(c for c in spec.constraints
                   if c.operand == s.CONSTRAINT_DISTINCT_PROPERTY)
        ps = PropertySet(sched.ctx, spec.job)
        if con in spec.job.constraints:
            ps.set_job_constraint(con)
        else:
            ps.set_tg_constraint(con, spec.tg.name)
        ps.populate_proposed()
        return ((ps.existing_values | ps.proposed_values)
                - ps.cleared_values)

    # -- dispatch --------------------------------------------------------------

    def _dispatch_prepared(self, prep: _PreparedBatch) -> None:
        """The breaker gate, then encode and the device dispatch."""
        stats = prep.stats
        self._preempt_plan = {}
        if not prep.spec_list:
            return
        # While OPEN every eval takes the CPU oracle; HALF-OPEN lets this
        # one batch probe the device path.
        if not self.breaker.allow_kernel():
            stats.breaker_state = self.breaker.state
            stats.oracle_routed += len(prep.scheds)
            self.logger.info(
                "batch: kernel breaker %s; routing %d evals through the "
                "CPU oracle", stats.breaker_state, len(prep.scheds))
            tracing.event("batch.oracle_routed", reason="breaker_open",
                          breaker_state=stats.breaker_state,
                          num_evals=len(prep.scheds))
            self._route_through_oracle(prep.scheds)
            prep.routed = True
            return
        prep.probe = self.breaker.state == HALF_OPEN
        # An encode, build, launch or upload error propagates and feeds
        # no breaker: only a validation verdict may route evals to the
        # oracle.  A probe that dies so stays unresolved until it expires.
        prep.handle = self._dispatch_device(prep.spec_list)

    def _live_allocs_by_node(self) -> Dict[str, List[s.Allocation]]:
        """Every live alloc row grouped by node: the usage basis."""
        allocs_by_node: Dict[str, List[s.Allocation]] = {}
        for node_id, row in self.state.alloc_rows(None):
            if not row.terminal_status():
                allocs_by_node.setdefault(node_id, []).append(row)
        return allocs_by_node

    def _columnar_usage(self, base: encode.ClusterTensors):
        """The live usage rows sliced from the store's columnar mirror:
        the reserved-only base plus the mirror's usage matrix, folded
        from the delta feed, O(changed allocs) instead of the row walk
        (``batch_sched.py:878``).  Returns ``(used int64 [n_pad, 4],
        touched rows)``, or None when the mirror is off, unavailable or
        out of step with ``base``.  Every ``columnar_guard_every`` reads
        (0: never) the walk runs anyway and must match bit for bit: a
        mismatch feeds the breaker, bumps the columnar epoch, and this
        batch goes on with the walk's rows."""
        if base.with_networks:
            return None
        columns_fn = getattr(self.state, "columns", None)
        if columns_fn is None:
            return None
        cols = columns_fn()
        if cols is None or cols.n != base.n_real:
            return None
        usage = self.state.column_usage(cols)[:cols.n]
        used = np.asarray(base.used, dtype=np.int64).copy()
        used[:cols.n] += usage
        touched = set(np.nonzero(usage.any(axis=1))[0].tolist())
        columnar.USAGE_READS += 1
        every = self.columnar_guard_every
        if every > 0 and columnar.USAGE_READS % every == 0:
            columnar.USAGE_GUARD_RUNS += 1
            ref_used, ref_touched = resident._full_usage(
                base, self._live_allocs_by_node)
            if not np.array_equal(used, ref_used):
                bad = int((used != ref_used).any(axis=1).sum())
                columnar.note_guard_mismatch("usage", "usage",
                                             breaker=self.breaker, Rows=bad)
                return ref_used, set(ref_touched)
            self.breaker.record(True)
            # The walk's touched set is the authority: it also holds
            # nodes whose live allocs net to zero usage.
            return used, set(ref_touched)
        return used, touched

    def _job_nodes(self, job_id: str) -> List[str]:
        return [nid for nid, row in self.state.alloc_rows_by_job(None,
                                                                 job_id)
                if not row.terminal_status()]

    def _dispatch_device(self, spec_list) -> _DeviceBatch:
        t0 = time.perf_counter()
        # The mirror's own uploads (install, delta rows) land in the
        # batch's h2d_bytes.
        h2d0 = resident.DEV_H2D_BYTES
        all_nodes = self.state.nodes(None)
        attr_targets, literals = encode.collect_attr_targets(spec_list)
        with_networks = any(sp.net_active for sp in spec_list)
        pad_m = _node_pad_multiple(self.mesh)
        lit_key = tuple(sorted(
            (t, tuple(sorted(vs))) for t, vs in literals.items()))
        cache_key = (self.state.store_uid, self.state.table_index("nodes"),
                     tuple(attr_targets), lit_key, with_networks, pad_m)
        base = _CLUSTER_CACHE.get(cache_key)
        if base is None:
            base = _cluster_static(all_nodes, attr_targets, literals,
                                   with_networks, pad_m, state=self.state,
                                   breaker=self.breaker,
                                   guard_every=self.columnar_guard_every)
            _CLUSTER_CACHE.put(cache_key, base)
        rng_seed = (self.rng_seed if self.rng_seed is not None
                    else int.from_bytes(os.urandom(4), "big"))
        # The usage: the resident mirror, caught up from the delta feed,
        # where the batch has no network asks and the snapshot has a
        # feed (batch_sched.py:973-1000); the full walk otherwise.
        res_info: Dict = {}
        res_key = None
        if (self.resident and not with_networks
                and getattr(self.state, "allocs_since", None) is not None):
            # The mirror depends on the node set and the pad only, not on
            # the batch's constraint vocabulary.
            res_key = cache_key[:2] + (base.n_pad,)
            used, touched, res_info = resident.acquire(
                self.state, res_key, base, self._live_allocs_by_node,
                breaker=self.breaker,
                shards=self.mesh.size if self.mesh is not None else 0,
                guard_every=self.guard_every,
                usage_fn=lambda: self._columnar_usage(base))
            ct = encode.with_usage(base, used)
        else:
            cu = self._columnar_usage(base)
            if cu is not None:
                used, touched_set = cu
                ct = encode.with_usage(base, used)
                touched = sorted(touched_set)
            else:
                ct, touched = _layer_usage(base,
                                           self._live_allocs_by_node())
        b = _encode_batch(spec_list, all_nodes, base, ct, touched,
                          self._job_nodes, rng_seed, self.mesh,
                          breaker=self.breaker)
        b.resident = res_info
        # Lend the device twin to the pass (batch_sched.py:1161-1180,
        # :1526-1567).  It is handed back only after the pass returns: an
        # error in between leaves the slot empty, and the next take
        # installs it again from the host mirror.
        used_dev = None
        if (res_key is not None and self.resident_device
                and (self.dispatch != "staged" or self.mesh is not None)):
            snap_index = self.state.table_index("allocs")
            used_dev = resident.take_device_used(
                res_key, snap_index, used, device=self.device,
                mesh=self.mesh if b.shards else None)
        _dispatch(b, self.device, self.mesh, _DEVICE_STATIC_CACHE,
                  used_dev=used_dev, dispatch=self.dispatch)
        b.commit_steps = b.out.commit_steps
        if used_dev is not None:
            resident.give_device_used(res_key, snap_index, used_dev)
        b.h2d_bytes += resident.DEV_H2D_BYTES - h2d0
        b.encode_seconds = b.t_dispatch - t0
        return b

    # -- complete --------------------------------------------------------------

    def _complete_prepared(self, prep: _PreparedBatch) -> "BatchStats":
        """The blocking fetch, the breaker's bookkeeping, and each eval's
        plan finalize and submit."""
        stats = prep.stats
        evals, scheds = prep.evals, prep.scheds
        if prep.routed:
            stats.total_seconds = time.perf_counter() - prep.t0
            stats.num_evals = len(evals)
            return stats

        expanded: Dict[Tuple[str, str], List[str]] = {}
        unplaced: Dict[Tuple[str, str], int] = {}
        per_spec_metrics: Dict[Tuple[str, str], s.AllocMetric] = {}
        b = prep.handle
        if b is not None:
            try:
                expanded, unplaced, per_spec_metrics = \
                    self._fetch_device(b, stats)
            except KernelIntegrityError as e:
                # Corrupt device output: reject the whole result, feed
                # the breaker, and degrade this batch to the oracle.
                self.breaker.record(False)
                if prep.probe:
                    self.breaker.on_probe(False)
                self.logger.error(
                    "batch: kernel output rejected (%s); routing %d evals "
                    "through the CPU oracle", e, len(scheds))
                stats.kernel_rejects = 1
                stats.oracle_routed += len(scheds)
                stats.breaker_state = self.breaker.state
                tracing.event("batch.oracle_routed", reason="kernel_reject",
                              breaker_state=stats.breaker_state,
                              num_evals=len(scheds), detail=str(e))
                self._route_through_oracle(scheds)
                stats.total_seconds = time.perf_counter() - prep.t0
                stats.num_evals = len(evals)
                return stats
            # Any other error (a failed launch or fetch) propagates
            # without feeding the breaker.  Validation passed: one clean
            # check, and every preemption kernel-vs-oracle comparison
            # feeds the same window (batch_sched.py:734-744).
            self.breaker.record(True)
            agree = stats.preempt_agree
            disagree = stats.preempt_checked - agree
            if agree:
                self.breaker.record(True, n=agree)
            if disagree:
                self.breaker.record(False, n=disagree)
            if prep.probe:
                self.breaker.on_probe(disagree == 0)
            stats.breaker_state = self.breaker.state
            stats.device_ran = True

        # Phase 3: materialize allocs into each eval's plan and submit.
        t_final = time.perf_counter()
        net_indexes = _NetIndexes(
            lambda nid: self.state.node_by_id(None, nid),
            lambda nid: [a for a in self.state.allocs_by_node(None, nid)
                         if not a.terminal_status()])
        for ev, sched in scheds:
            self._finalize(ev, sched, prep.specs, expanded, unplaced,
                           per_spec_metrics, net_indexes, stats)
        stats.finalize_seconds = time.perf_counter() - t_final
        tr = tracing.TRACER
        if tr is not None:
            tr.record("batch.finalize", t_final,
                      t_final + stats.finalize_seconds)
        stats.total_seconds = time.perf_counter() - prep.t0
        stats.num_evals = len(evals)
        return stats

    def _route_through_oracle(self, scheds) -> None:
        """Process each eval with the CPU GenericScheduler against live
        state (batch_sched.py:788), each under an ``oracle.process``
        span."""
        tr = tracing.TRACER
        for ev, _sched in scheds:
            oracle = GenericScheduler(
                self.logger, self.state, self.planner,
                batch=(ev.type == s.JOB_TYPE_BATCH),
                preemption_enabled=self.preemption_enabled)
            if tr is None:
                oracle.process(ev)
            else:
                with tr.span("oracle.process", eval_id=ev.id):
                    oracle.process(ev)

    def _fetch_device(self, b: _DeviceBatch, stats: "BatchStats"):
        # The whole result comes back in one transfer (past the payload
        # window, one more prefix fetch inside the same span): exactly
        # one batch.fetch span a batch.
        with tracing.span("batch.fetch", fused=1):
            summary, coo, fetch_bytes = _fetch(b)
        stats.rounds = int(summary["scalars"][1])
        stats.encode_seconds = b.encode_seconds
        stats.h2d_bytes = b.h2d_bytes
        stats.static_h2d_bytes = b.static_h2d_bytes
        stats.mesh_shards = b.shards
        stats.fetch_bytes = fetch_bytes
        stats.device_seconds = b.device_seconds
        stats.commit_steps = b.commit_steps
        stats.timings = dict(b.timings)
        self._apply_resident_stats(stats, b.resident)
        return self._finalize_device_outputs(b, summary, coo, stats)

    @staticmethod
    def _apply_resident_stats(stats: "BatchStats", info: Dict) -> None:
        stats.resident_hits = 1 if info.get("resident_hit") else 0
        stats.delta_rows = info.get("delta_rows", 0)
        stats.full_reencodes = 1 if info.get("full_reencode") else 0
        stats.staleness_fences = 1 if info.get("fence") else 0
        stats.delta_apply_seconds = info.get("delta_apply_s", 0.0)

    def _finalize_device_outputs(self, b: _DeviceBatch, summary, coo,
                                 stats: "BatchStats"):
        """Device result -> per-spec slots and AllocMetrics
        (batch_sched.py:1583): :func:`_decode` (the fault point and
        validation), the lazy forensics fetch, then the metrics."""
        t_host = time.perf_counter()
        spec_list, ct, st, all_nodes = b.spec_list, b.ct, b.st, b.nodes
        placements = _decode(spec_list, ct, summary["unplaced"], coo,
                             b.with_scores, self.native_decode,
                             self.decode_guard_every)
        unplaced_arr = summary["unplaced"]
        feas_count = summary["feas_count"]
        coo_rows, coo_cols, coo_counts = coo[:, 0], coo[:, 1], coo[:, 2]
        valid = (coo_rows >= 0) & (coo_cols < ct.n_real)
        vr, vc = coo_rows[valid], coo_cols[valid]
        vcnt = coo_counts[valid]
        u_lo = np.searchsorted(vr, np.arange(len(spec_list)), side="left")
        u_hi = np.searchsorted(vr, np.arange(len(spec_list)), side="right")

        # The usage after the commits, reconstructed on the host (exact
        # integer adds); only failure forensics needs it.
        failed_u = np.nonzero(unplaced_arr[:st.u_real] > 0)[0]
        used_after = None
        if len(failed_u):
            used_after = np.asarray(ct.used, dtype=np.int64).copy()
            if len(vr):
                np.add.at(used_after, vc.astype(np.int64),
                          vcnt.astype(np.int64)[:, None]
                          * np.asarray(st.ask)[vr.astype(np.int64)])

        # Feasibility rows are fetched lazily, only for failed specs whose
        # feasible count is below their evaluated count (ready nodes in
        # their DCs), i.e. a constraint filtered a node.  Capacity
        # exhaustion needs no row.  With the preemption outputs they come
        # back in one transfer: at most one extra a batch.  The host facts
        # are built first, so the device timer below spans only uploads,
        # launches and the fetch.
        feas_rows: Dict[int, np.ndarray] = {}
        rows_seconds = 0.0
        node_facts = None
        need_rows: List[int] = []
        if len(failed_u):
            node_facts = {
                "ready": np.array([n.ready() for n in all_nodes],
                                  dtype=bool),
                "dc": np.array([n.datacenter for n in all_nodes],
                               dtype=object),
                "class_codes": None,
                "class_names": None,
                # dcs tuple -> evaluated mask, once per DC set a batch.
                "evaluated": {},
            }
            need_rows = [int(u) for u in failed_u
                         if feas_count[u] < int(self._evaluated_mask(
                             node_facts, spec_list[u]).sum())]

        # The preemption pass goes in flight now, so its outputs ride the
        # same fetch as the forensics rows (batch_sched.py:1640).
        preempt_ctx = None
        if self.preemption_enabled and used_after is not None and b.touched:
            # Writable: the commit takes its placements off the counts.
            unplaced_arr = np.array(unplaced_arr)
            preempt_ctx = self._preempt_dispatch(b, unplaced_arr,
                                                 used_after)
            if preempt_ctx is not None:
                stats.preempt_encode_seconds = preempt_ctx["host_seconds"]

        preempt_out = None
        if need_rows or preempt_ctx is not None:
            timer = (preempt_ctx["timer"] if preempt_ctx is not None
                     else _DeviceTimer(self.device))
            gets = [self._feas_rows(b, need_rows)] if need_rows else []
            if preempt_ctx is not None:
                gets.extend(preempt_ctx["dev"])
            with tracing.span("batch.fetch_forensics",
                              feas_rows=len(need_rows),
                              preempt=int(preempt_ctx is not None)):
                fetched = _fetch_together(gets)
            stats.fetch_bytes += sum(a.nbytes for a in fetched)
            if need_rows:
                rows_np = fetched.pop(0)
                feas_rows = {u: rows_np[i] for i, u in enumerate(need_rows)}
            preempt_out = fetched
            rows_seconds = timer.seconds()
            stats.device_seconds += rows_seconds

        # The preemption commit: the host greedy pass over the fetched
        # eviction sets.  It takes its placements off unplaced_arr and
        # updates used_after, so the forensics below see the result.
        if preempt_ctx is not None:
            with tracing.span("batch.preempt"):
                self._preempt_commit(preempt_ctx, preempt_out, spec_list,
                                     ct, unplaced_arr, used_after, stats)

        expanded: Dict[Tuple[str, str], List[str]] = {}
        unplaced: Dict[Tuple[str, str], int] = {}
        metrics: Dict[Tuple[str, str], s.AllocMetric] = {}
        # Specs that placed nothing and had no row fetched fail with a
        # metric fixed by their shape: computed once per shape.
        fail_cache: Dict[Tuple, s.AllocMetric] = {}
        for u, sp in enumerate(spec_list):
            key = (sp.job.id, sp.tg.name)
            lo, hi = int(u_lo[u]), int(u_hi[u])
            pl = placements[key]
            expanded[key] = pl.node_ids
            unplaced[key] = int(unplaced_arr[u])

            n_unplaced = unplaced[key]
            sig = None
            if n_unplaced > 0 and lo == hi and feas_rows.get(u) is None:
                sig = (sp.ask.tobytes(), tuple(sp.datacenters),
                       tuple((c.ltarget, c.operand, c.rtarget)
                             for c in sp.constraints),
                       tuple(sorted(sp.drivers)), bool(sp.distinct_hosts),
                       sp.dp_target, int(feas_count[u]), n_unplaced,
                       bool(sp.net_active), int(sp.net_mbits),
                       int(sp.dyn_count), int(sp.resv_in_dyn),
                       tuple(sp.resv_ports))
                cached = fail_cache.get(sig)
                if cached is not None:
                    metrics[key] = cached.copy()
                    continue

            # AllocMetric from the device side outputs
            # (structs.go:4074-4172).
            m = s.AllocMetric()
            m.nodes_evaluated = ct.n_real
            m.nodes_filtered = ct.n_real - int(feas_count[u])
            if pl.metric_scores:
                m.scores = pl.metric_scores
            if n_unplaced > 0:
                placed_row = np.zeros(ct.n_real, dtype=np.int32)
                placed_row[vc[lo:hi]] = vcnt[lo:hi]
                self._fill_failure_metrics(
                    m, sp, all_nodes, ct, feas_rows.get(u), placed_row,
                    used_after, node_facts)
                m.coalesced_failures = n_unplaced - 1
                if sig is not None:
                    fail_cache[sig] = m
            metrics[key] = m
        t_end = time.perf_counter()
        stats.metrics_seconds = t_end - t_host - rows_seconds
        tr = tracing.TRACER
        if tr is not None:
            # The phase spans from the timers already taken: packing
            # ended at t_dispatch, where the device interval (CUDA events
            # from the upload to the fetched result, and the forensics
            # rows') begins.  No span of its own waits on the card.
            tr.record("batch.encode", b.t_dispatch - b.encode_seconds,
                      b.t_dispatch)
            tr.record("batch.device", b.t_dispatch,
                      b.t_dispatch + stats.device_seconds,
                      rounds=stats.rounds)
            tr.record("batch.metrics", t_end - stats.metrics_seconds, t_end,
                      preempt_placed=stats.preempt_placed)
        return expanded, unplaced, metrics

    def _feas_rows(self, b: _DeviceBatch, rows: List[int]) -> torch.Tensor:
        """Rows ``rows`` of the pass's feasibility matrix on the
        scheduler's device; on the mesh, each shard's part of the rows,
        concatenated in node order."""
        idx = torch.as_tensor(rows, dtype=torch.long)
        feas = b.out.feas
        if isinstance(feas, list):     # the mesh's shard parts
            return torch.cat([f[idx.to(f.device)].to(self.device)
                              for f in feas], dim=1)
        return feas[idx.to(feas.device)]

    # -- the preemption pass ---------------------------------------------------

    def _preempt_dispatch(self, b: _DeviceBatch, unplaced_arr,
                          used_after) -> Optional[Dict]:
        """Launch the eviction-set pass for the asks the capacity loop left
        unplaced (batch_sched.py:1833-1896): one kernel launch over every
        still-failing (spec, node) pair, and the preempting specs'
        feasibility rows (constraints, datacenters and eligibility still
        bind a preempting placement).  Returns the context the commit
        reads, its ``dev`` outputs still on the device; None when no spec
        qualifies.  On the mesh the pass runs once on the first device,
        over the whole padded node axis.

        Specs with network asks, distinct_hosts or distinct_property keep
        the capacity pass's result: their feasibility after an eviction is
        not expressible in the kernel's inputs."""
        spec_list, ct, st = b.spec_list, b.ct, b.st
        pu = [u for u in range(st.u_real)
              if unplaced_arr[u] > 0
              and spec_list[u].priority > 0
              and not spec_list[u].net_active
              and spec_list[u].dp_target is None
              and not spec_list[u].distinct_hosts]
        if not pu:
            return None
        t0 = time.perf_counter()
        state = self.state

        def prio_of(a: s.Allocation) -> int:
            return preempt_oracle.alloc_priority(a, state)

        # Materialized candidate rows from the store, not the usage rows:
        # a slab-backed alloc's usage row is the slab's shared prototype,
        # which has no id, and a victim needs its real id and
        # modify_index or the applier's preemption fence rejects it.
        allocs_by_node = {
            ct.node_ids[i]: state.allocs_by_node_terminal(
                None, ct.node_ids[i], False)
            for i in b.touched if i < ct.n_real}
        prio, sizes, sorted_allocs = preempt.encode_alloc_tensors(
            ct.node_ids, allocs_by_node, prio_of, n_pad=ct.n_pad)
        capacity = np.asarray(ct.capacity, dtype=np.int64)
        free = np.clip(capacity - used_after, -(2 ** 31), 2 ** 31 - 1)
        denom = np.asarray(ct.score_denom, dtype=np.float32)
        ask = np.asarray(st.ask, dtype=np.int64)[pu].astype(np.int32)
        jp = np.array([spec_list[u].priority for u in pu], dtype=np.int32)
        host_seconds = time.perf_counter() - t0

        timer = _DeviceTimer(self.device)

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        dev = (*preempt.eviction_sets(
                   up(free.astype(np.int32)),
                   up(used_after.astype(np.int32)), up(denom), up(prio),
                   up(sizes), up(ask), up(jp)),
               self._feas_rows(b, pu))
        return {"pu": pu, "sorted_allocs": sorted_allocs,
                "prio_of": prio_of, "free": free, "ask": ask, "jp": jp,
                "dev": dev, "timer": timer, "host_seconds": host_seconds}

    def _preempt_commit(self, ctx, fetched, spec_list, ct, unplaced_arr,
                        used_after, stats: "BatchStats") -> None:
        """The host half of the pass, over the fetched outputs
        (batch_sched.py:1898-1965): in the batch's priority order, best
        effective score first (post-eviction ScoreFit minus the preemption
        discount), at most one preempting placement per node per batch (a
        second eviction on a node would need the state after the first,
        which the kernel did not see).  Each commit is replayed against the
        scalar oracle on the same inputs; the counts go to ``stats``."""
        pu = ctx["pu"]
        sorted_allocs = ctx["sorted_allocs"]
        prio_of = ctx["prio_of"]
        free = ctx["free"]
        ask = ctx["ask"]
        jp = ctx["jp"]
        mask_np, feasible, n_evict, score, feas_rows = fetched
        feasible = feasible & feas_rows.astype(bool)
        # float64, as the reference's expression makes it: the stable
        # argsort below orders near-ties on it.
        eff = score - (preempt_oracle.PREEMPTION_SCORE_PENALTY
                       + preempt_oracle.PREEMPTION_PER_ALLOC_PENALTY
                       * n_evict)

        placed = evicted = checked = agree = 0
        dirty = np.zeros(ct.n_pad, dtype=bool)
        for p, u in enumerate(pu):
            sp = spec_list[u]
            key = (sp.job.id, sp.tg.name)
            need = int(unplaced_arr[u])
            ok = feasible[p] & ~dirty
            ok[ct.n_real:] = False
            if need <= 0 or not ok.any():
                continue
            cand = np.nonzero(ok)[0]
            order = cand[np.argsort(-eff[p][cand], kind="stable")]
            commits = self._preempt_plan.setdefault(key, [])
            for i in order[:need].tolist():
                victims = [sorted_allocs[i][a]
                           for a in np.nonzero(mask_np[p, i])[0]]
                checked += 1
                if not self._preempt_oracle_agrees(
                        sorted_allocs[i], free[i], ask[p], int(jp[p]),
                        victims, prio_of):
                    self.logger.warning(
                        "preempt kernel/oracle disagreement on node %s; "
                        "skipping commit", ct.node_ids[i])
                    continue
                agree += 1
                commits.append((ct.node_ids[i], victims))
                dirty[i] = True
                placed += 1
                evicted += len(victims)
                # The forensics usage: the ask lands, the victims leave.
                used_after[i] += ask[p].astype(np.int64)
                for v in victims:
                    used_after[i] -= np.array(preempt_oracle.alloc_size(v),
                                              dtype=np.int64)
                unplaced_arr[u] -= 1
        stats.preempt_placed = placed
        stats.preempt_evicted = evicted
        stats.preempt_checked = checked
        stats.preempt_agree = agree

    @staticmethod
    def _preempt_oracle_agrees(node_allocs_sorted, free_vec, ask_vec,
                               priority, kernel_victims, prio_of) -> bool:
        """Replay the scalar oracle (greedy prefix and reverse trim) on the
        kernel's inputs and compare the sets (batch_sched.py:1968)."""
        cand = [a for a in node_allocs_sorted if prio_of(a) < priority]
        free = tuple(int(x) for x in free_vec)
        ask = tuple(int(x) for x in ask_vec)
        if all(ask[d] <= free[d] for d in range(4)):
            return False  # fits without eviction: the kernel must not commit
        chosen = preempt_oracle.select_eviction_prefix(
            free, ask, [preempt_oracle.alloc_size(a) for a in cand])
        if not chosen:
            return False
        return [cand[j].id for j in chosen] == [a.id for a in kernel_victims]

    @staticmethod
    def _evaluated_mask(node_facts, sp) -> np.ndarray:
        dcs = tuple(sp.datacenters)
        ent = node_facts["evaluated"].get(dcs)
        if ent is None:
            ent = node_facts["ready"] & np.isin(node_facts["dc"], list(dcs))
            node_facts["evaluated"][dcs] = ent
        return ent

    def _fill_failure_metrics(self, m, sp, nodes, ct, feas_row, placed_row,
                              used_after, node_facts) -> None:
        """Forensics of a failed placement, matching the oracle's
        filter_node/exhausted_node accounting (batch_sched.py:1985): chain
        order job constraints -> drivers -> group and task constraints
        (feasible.go), the class cache ("computed class ineligible" after
        the first failure of a class, feasible.go:597), distinct checks
        before capacity (stack order), and Resources.superset's dimension
        names (rank.go).  Capacity exhaustion is vectorized; the Python
        checkers run over the filtered nodes only.  ``feas_row`` is None
        when every evaluated node was feasible."""
        n_real = ct.n_real
        feas_r = (feas_row[:n_real].astype(bool) if feas_row is not None
                  else np.ones(n_real, dtype=bool))
        placed_r = placed_row[:n_real]
        evaluated = self._evaluated_mask(node_facts, sp)
        m.nodes_evaluated = int(evaluated.sum())
        m.nodes_filtered = 0

        # -- exhausted (feasible, evaluated, uncommitted): vectorized ----
        exh_mask = evaluated & feas_r & (placed_r == 0)
        if exh_mask.any():
            # One [n, 4] compare per distinct ask a batch.
            ask_cache = node_facts.setdefault("ask_over", {})
            ask_key = sp.ask.tobytes()
            ent = ask_cache.get(ask_key)
            if ent is None:
                cap_left = node_facts.get("cap_left")
                if cap_left is None:
                    cap_left = ct.capacity[:n_real] - used_after[:n_real]
                    node_facts["cap_left"] = cap_left
                over = sp.ask[None, :] > cap_left      # [n, 4]
                ent = (over.any(axis=1), np.argmax(over, axis=1))
                ask_cache[ask_key] = ent
            any_over, first_dim = ent
            dim_names = ("cpu exhausted", "memory exhausted",
                         "disk exhausted", "iops exhausted")
            capacity_exh = exh_mask & any_over
            n_cap_exh = int(capacity_exh.sum())
            if n_cap_exh:
                m.nodes_exhausted += n_cap_exh
                dims = np.bincount(first_dim[capacity_exh], minlength=4)
                for di, cnt in enumerate(dims):
                    if cnt:
                        m.dimension_exhausted[dim_names[di]] = (
                            m.dimension_exhausted.get(dim_names[di], 0)
                            + int(cnt))
                if node_facts.get("class_codes") is None:
                    names: List[str] = []
                    index: Dict[str, int] = {}
                    codes = np.empty(len(nodes), dtype=np.int32)
                    for i2, n2 in enumerate(nodes):
                        cls = n2.node_class or ""
                        code = index.get(cls)
                        if code is None:
                            code = index[cls] = len(names)
                            names.append(cls)
                        codes[i2] = code
                    node_facts["class_codes"] = codes
                    node_facts["class_names"] = names
                codes = node_facts["class_codes"][:n_real]
                names = node_facts["class_names"]
                if len(names) > 1 or names[0]:
                    counts = np.bincount(codes[capacity_exh],
                                         minlength=len(names))
                    for code, cnt in enumerate(counts):
                        if cnt and names[code]:
                            m.class_exhausted[names[code]] = (
                                m.class_exhausted.get(names[code], 0)
                                + int(cnt))
            # The rarer non-capacity blocks keep per-node attribution.
            for i in np.nonzero(exh_mask & ~any_over)[0]:
                node = nodes[i]
                if sp.distinct_hosts or sp.dp_target is not None:
                    # Distinct checks precede BinPack in the oracle chain:
                    # blocked nodes are filtered, not exhausted
                    # (feasible.go:272).
                    m.filter_node(
                        node,
                        s.CONSTRAINT_DISTINCT_HOSTS if sp.distinct_hosts
                        else s.CONSTRAINT_DISTINCT_PROPERTY)
                elif sp.net_active:
                    m.exhausted_node(node, self._net_exhaust_dim(sp, ct, i))
                else:
                    m.exhausted_node(node, "resources exhausted")

        # -- filtered (evaluated, infeasible): the oracle's checkers ------
        filt_idx = np.nonzero(evaluated & ~feas_r)[0]
        if len(filt_idx) == 0:
            return
        from ..scheduler.feasible import ConstraintChecker, DriverChecker

        eval_ctx = EvalContext(state=None, plan=s.Plan())
        eval_ctx.metrics = m
        strip = (s.CONSTRAINT_DISTINCT_HOSTS, s.CONSTRAINT_DISTINCT_PROPERTY)
        job_cons = [c for c in sp.job.constraints if c.operand not in strip]
        tg_cons = [c for c in sp.constraints
                   if c not in sp.job.constraints and c.operand not in strip]
        job_checker = ConstraintChecker(eval_ctx, job_cons)
        tg_checker = ConstraintChecker(eval_ctx, tg_cons)
        driver_checker = DriverChecker(eval_ctx, sp.drivers)
        # The class cache: once a computed class is ineligible for a
        # reason that does not escape it, later nodes of the class are
        # "computed class ineligible" (feasible.go:627).
        cacheable = all(not encode._escapes_class(c)
                        for c in job_cons + tg_cons)
        ineligible_classes: set = set()
        for i in filt_idx:
            node = nodes[i]
            if cacheable and node.computed_class in ineligible_classes:
                m.filter_node(node, "computed class ineligible")
                continue
            ok = (job_checker.feasible(node)
                  and driver_checker.feasible(node)
                  and tg_checker.feasible(node))
            if ok:
                # Disagreement with the device row can only come from the
                # encode: attribute generically.
                m.filter_node(node, "constraint")
            elif cacheable and node.computed_class:
                ineligible_classes.add(node.computed_class)

    @staticmethod
    def _net_exhaust_dim(sp, ct, i) -> str:
        """The oracle's network error strings (network.go:245) from the
        encoded state."""
        if ct.bw_cap is not None and ct.bw_cap[i] < 0:
            return "network: no networks available"
        if ct.bw_cap is not None and sp.net_mbits > 0 and (
                ct.bw_used[i] + sp.net_mbits > ct.bw_cap[i]):
            return "network: bandwidth exceeded"
        if sp.resv_ports:
            return "network: reserved port collision"
        return "network: dynamic port selection failed"

    # -- finalize ----------------------------------------------------------------

    def _finalize(self, ev, sched, specs, expanded, unplaced,
                  per_spec_metrics, net_indexes, stats) -> None:
        """This eval's slots into its plan, then submit and set its status
        (batch_sched.py:2159, generic_sched.go:104)."""
        # One prototype alloc per spec; its metric and resources objects
        # are shared by every alloc of the spec (stored objects are
        # immutable by convention).
        for tg, names_or_count, prevs in sched.pending_bulk:
            key = (sched.job.id, tg.name)
            slots = expanded.get(key, [])
            if isinstance(names_or_count, int):
                n_asks = names_or_count
                names = None   # formulaic; made below only as needed
            else:
                names = names_or_count
                n_asks = len(names)
            metric = per_spec_metrics.get(key, s.AllocMetric())
            metric.nodes_available = sched.nodes_by_dc
            combined = s.Resources(disk_mb=tg.ephemeral_disk.size_mb)
            for t in tg.tasks:
                combined.add(t.resources)
            proto = s.Allocation(
                eval_id=ev.id, job_id=sched.job.id, task_group=tg.name,
                metrics=metric, resources=combined,
                task_resources={t.name: t.resources.copy()
                                for t in tg.tasks},
                desired_status=s.ALLOC_DESIRED_STATUS_RUN,
                client_status=s.ALLOC_CLIENT_STATUS_PENDING,
                shared_resources=s.Resources(
                    disk_mb=tg.ephemeral_disk.size_mb))
            spec = specs.get(key)
            net_asks = spec.net_asks if spec is not None else {}
            k = min(len(slots), n_asks)
            appended = 0
            if not net_asks:
                # One AllocSlab per (job, group): the prototype once, the
                # per-alloc columns beside it; ids and formulaic names are
                # lazy columns.
                if k:
                    sched.plan.append_slab(s.AllocSlab(
                        proto=proto, ids=s.LazyUuids(k),
                        names=(s.LazyNames(k, f"{sched.job.name}.{tg.name}")
                               if names is None
                               else (names[:k] if k < len(names)
                                     else names)),
                        node_ids=slots[:k] if k < len(slots) else slots,
                        prev_ids=([p or "" for p in prevs[:k]]
                                  if prevs is not None else [])))
                    appended = k
            else:
                if names is None and k:
                    names = [f"{sched.job.name}.{tg.name}[{i}]"
                             for i in range(k)]
                ids = s.generate_uuids(k) if k else []
                offers = _offer_group(tg, net_asks, slots[:k],
                                      random.Random(ev.id), net_indexes)
                for i, nets in enumerate(offers):
                    if nets is None:
                        continue
                    alloc = s._fast_copy(proto)
                    alloc.id = ids[i]
                    alloc.name = names[i]
                    alloc.node_id = slots[i]
                    task_resources = {}
                    total = s.Resources(disk_mb=tg.ephemeral_disk.size_mb)
                    for t in tg.tasks:
                        res = t.resources.copy()
                        if t.name in nets:
                            res.networks = [nets[t.name]]
                        task_resources[t.name] = res
                        total.add(res)
                    alloc.task_resources = task_resources
                    alloc.resources = total
                    if prevs is not None and prevs[i]:
                        alloc.previous_allocation = prevs[i]
                    sched.plan.append_alloc(alloc)
                    appended += 1
            # Placements won by the preemption pass: explicit allocs (each
            # carries its evictions), the victims staged into the plan's
            # node_preemptions so the applier commits evict and place
            # together and rejects a stale victim (batch_sched.py:2267).
            extra = self._preempt_plan.get(key) or []
            if extra:
                take = min(len(extra), n_asks - appended)
                first = appended
                extra_ids = s.generate_uuids(take)
                for i in range(take):
                    node_id, victims = extra[i]
                    alloc = s._fast_copy(proto)
                    alloc.id = extra_ids[i]
                    alloc.name = (names[first + i] if names is not None
                                  else f"{sched.job.name}.{tg.name}"
                                       f"[{first + i}]")
                    alloc.node_id = node_id
                    if prevs is not None and prevs[first + i]:
                        alloc.previous_allocation = prevs[first + i]
                    for victim in victims:
                        sched.plan.append_preempted_alloc(victim)
                    sched.plan.append_alloc(alloc)
                    appended += 1
            # A slot that yielded no alloc, a failed offer included, is a
            # placement failure: a blocked eval, not a silent
            # under-placement (generic_sched.go:218).
            if appended < n_asks:
                if sched.failed_tg_allocs is None:
                    sched.failed_tg_allocs = {}
                sched.failed_tg_allocs[tg.name] = metric

        # Blocked eval for failures (generic_sched.go:218-227).
        if (ev.status != s.EVAL_STATUS_BLOCKED and sched.failed_tg_allocs
                and sched.blocked is None):
            sched._create_blocked_eval(plan_failure=False)

        # Rolling-update limit reached: the follow-up eval
        # (generic_sched.go:232-240).
        if sched.limit_reached and sched.next_eval is None:
            sched.next_eval = ev.next_rolling_eval(sched.job.update.stagger)
            self.planner.create_eval(sched.next_eval)

        if sched.plan.is_no_op() and not ev.annotate_plan:
            set_status(self.logger, self.planner, ev, sched.next_eval,
                       sched.blocked, sched.failed_tg_allocs,
                       s.EVAL_STATUS_COMPLETE, "", sched.queued_allocs)
            return

        result, new_state = self.planner.submit_plan(sched.plan)
        adjust_queued_allocations(self.logger, result, sched.queued_allocs)

        if new_state is not None or (
                result is not None and not result.full_commit(sched.plan)[0]):
            # Conflict: the oracle retries this eval on refreshed state,
            # as Nomad reconciles optimistic concurrency
            # (plan_apply.go:27-41).
            self.logger.info("batch: plan conflict for eval %s; routing it "
                             "through the CPU oracle", ev.id)
            stats.conflict_retries += 1
            retry_state = new_state if new_state is not None else self.state
            GenericScheduler(self.logger, retry_state, self.planner,
                             batch=(ev.type == s.JOB_TYPE_BATCH),
                             preemption_enabled=self.preemption_enabled
                             ).process(ev)
            return

        if ev.status == s.EVAL_STATUS_BLOCKED and sched.failed_tg_allocs:
            e = sched.ctx.eligibility()
            new_eval = ev.copy()
            new_eval.escaped_computed_class = e.has_escaped()
            new_eval.class_eligibility = e.get_classes()
            self.planner.reblock_eval(new_eval)
            return

        set_status(self.logger, self.planner, ev, sched.next_eval,
                   sched.blocked, sched.failed_tg_allocs,
                   s.EVAL_STATUS_COMPLETE, "", sched.queued_allocs)


class BatchStats:
    """What one batch did and where its time went (batch_sched.py:2349).
    Seconds on the host clock, but ``device_seconds``: from the upload to
    the fetched result, plus the forensics rows' fetch (CUDA events on a
    card); the host's decode of the result is in ``metrics_seconds``."""

    def __init__(self) -> None:
        self.num_evals = 0
        self.num_specs = 0
        self.num_asks = 0
        self.phase1_seconds = 0.0       # reconcile (the oracle's diff)
        self.phase2_seconds = 0.0       # spec dedup and the oracle gate
        self.encode_seconds = 0.0
        self.device_seconds = 0.0
        self.metrics_seconds = 0.0      # decode, AllocMetrics, forensics
        self.finalize_seconds = 0.0     # plans, submit, eval statuses
        self.total_seconds = 0.0
        self.rounds = 0
        # Committing spec steps of the device pass: steps of the round
        # kernel on a card (one scored_rows launch a shard on a mesh),
        # counted by the pass itself, so batches placing at once do not
        # count each other's.
        self.commit_steps = 0
        # Bytes up (the dynamic buffer, the static one when not cached on
        # the device, and the resident mirror's install and delta rows)
        # and down (the result buffer and the forensics rows).
        self.h2d_bytes = 0
        self.static_h2d_bytes = 0
        self.fetch_bytes = 0
        self.mesh_shards = 0
        # Degradation: evals routed through the CPU oracle by an open
        # breaker or a rejected result (what the reference counts),
        # device results rejected, and the breaker's state after the
        # batch.  The other oracle routes: evals whose specs the device
        # pass cannot express (the gate), and evals whose plan conflicted
        # and were retried on refreshed state.
        self.oracle_routed = 0
        self.gate_routed = 0
        self.conflict_retries = 0
        self.kernel_rejects = 0
        self.breaker_state = "closed"
        self.device_ran = False
        # The preemption pass: placements won by eviction, allocs evicted,
        # eviction sets replayed against the scalar oracle and those that
        # agreed, and the host time of the candidate rows' materialization
        # and encode (also in metrics_seconds).
        self.preempt_placed = 0
        self.preempt_evicted = 0
        self.preempt_checked = 0
        self.preempt_agree = 0
        self.preempt_encode_seconds = 0.0
        # The resident usage mirror (ops/resident.py): whether the usage
        # came from the delta feed, the feed entries applied, full walks
        # (cold, key change, feed gap, guard mismatch), staleness fences,
        # and the seconds of the device twin's in-place delta apply.
        self.resident_hits = 0
        self.delta_rows = 0
        self.full_reencodes = 0
        self.staleness_fences = 0
        self.delta_apply_seconds = 0.0
        # schedule_stream: this batch's prepare time while the previous
        # batch was dispatched and not yet completed (0 when serial).
        self.pipeline_overlap_s = 0.0
        # The staged dispatch's schedule and compact seconds.
        self.timings: Dict[str, float] = {}

    def __repr__(self) -> str:
        return "BatchStats(" + " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in self.__dict__.items()) + ")"


def new_torch_batch_scheduler(logger_, state, planner,
                              **kwargs) -> TorchBatchScheduler:
    return TorchBatchScheduler(logger_, state, planner, **kwargs)


register_scheduler("torch-batch", new_torch_batch_scheduler)
