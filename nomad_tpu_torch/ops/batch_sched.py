"""The port's batch scheduler: one device pass places every task group of
a batch of jobs (``TPUBatchScheduler.schedule_batch``,
``nomad_tpu/ops/batch_sched.py:356``, from spec dedup to finalized
placements).

The cluster snapshot comes in as plain lists -- the state store, worker
and plan applier are later slices.  ``jobs`` are evaluated as
registrations: each task group asks for ``count`` allocations minus the
live allocations the job already has in that group.  Network asks get
concrete offers (IP, bandwidth, port numbers) at finalize, as the
reference's ``_finalize`` makes them.  A spec the reference sends to its
CPU oracle (``needs_oracle``, or network asks on a cluster whose
networks are not the simple shape) raises ``NotImplementedError`` with
the reference's reason: the port has no oracle, and such a spec is never
placed another way.
"""
from __future__ import annotations

import ipaddress
import logging
import math
import os
import random
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..scheduler.propertyset import dp_used_values
from ..structs import structs as s
from ..structs.network import NetworkIndex
from . import decode, encode, kernels, xfer

logger = logging.getLogger("nomad_tpu_torch.ops.batch_sched")

# Budget of the mesh's commit-ordered slot record ([U, M] int32, plus the
# score rows when carried).  A batch whose record would exceed it takes
# the single-chip path, as the reference does (batch_sched.py:63).
MESH_SLOT_BUDGET_BYTES = 512 << 20


class KernelIntegrityError(RuntimeError):
    """The device result broke a structural invariant; nothing of it was
    used."""


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


def _prepare_specs(jobs: Sequence[s.Job],
                   live: Dict[Tuple[str, str], int],
                   live_allocs: Sequence[s.Allocation] = (),
                   nodes_by_id: Optional[Dict[str, s.Node]] = None
                   ) -> List[encode.PlacementSpec]:
    """Dedup placement asks into specs and sort them by priority, stable
    (batch_sched.py:587-618).  A distinct_property spec gets the values
    its job's live allocs already use (module ``scheduler.propertyset``).
    A spec the reference would route to its oracle raises
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
                        "with its CPU oracle, which the port does not have")
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


def schedule_batch(nodes: Sequence[s.Node], jobs: Sequence[s.Job],
                   live_allocs: Iterable[s.Allocation] = (),
                   rng_seed: Optional[int] = None,
                   device=None, mesh=None,
                   eval_ids: Optional[Sequence[str]] = None) -> BatchResult:
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
    single-chip path, and ``mesh_shards`` in the result."""
    if mesh is not None and device is not None:
        raise ValueError("pass a device or a mesh, not both")
    dev = mesh.root if mesh is not None else resolve_device(device)
    t0 = time.perf_counter()
    live = [a for a in live_allocs if not a.terminal_status()]
    live_by_spec: Dict[Tuple[str, str], int] = {}
    allocs_by_node: Dict[str, List[s.Allocation]] = {}
    for a in live:
        key = (a.job_id, a.task_group)
        live_by_spec[key] = live_by_spec.get(key, 0) + 1
        allocs_by_node.setdefault(a.node_id, []).append(a)
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
            "network asks on such a cluster with its CPU oracle, which the "
            "port does not have")

    attr_targets, literals = encode.collect_attr_targets(spec_list)
    # The node axis pads to lcm(128, D), so the shards divide it evenly;
    # padding rows are ineligible (batch_sched.py:1451-1462).
    d = mesh.size if mesh is not None else 0
    base = encode.encode_cluster_static(
        nodes, attr_targets,
        node_pad_multiple=128 * d // math.gcd(128, d) if d else 128,
        with_networks=with_networks)
    encode.finalize_codebooks(base, literals)
    ct = (encode.apply_alloc_usage(base, allocs_by_node)
          if allocs_by_node else base)
    touched = sorted(i for i in (base.node_index.get(nid)
                                 for nid in allocs_by_node) if i is not None)
    st = encode.encode_specs(spec_list, ct, nodes)

    # Existing per-(job, node) alloc counts, uploaded sparse.
    jc_entries: Dict[Tuple[int, int], int] = {}
    job_row = {jid: j for j, jid in enumerate(st.job_ids)}
    for a in live:
        j = job_row.get(a.job_id)
        idx = base.node_index.get(a.node_id)
        if j is not None and idx is not None:
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

    if rng_seed is None:
        rng_seed = int.from_bytes(os.urandom(4), "big")
    static = {
        "attr": ct.attr_values, "elig": ct.eligible, "dc": ct.dc_code,
        "denom": ct.score_denom,
    }
    # Capacity and the reserved-only baseline ship quantized when that is
    # exact (checked by the host inverse), as int32 otherwise.
    quant = encode.quantize_resource_rows(ct.capacity, base.used)
    if quant is not None and (
            np.array_equal(encode.dequantize_rows(quant.cap_q,
                                                  quant.scale[0]),
                           ct.capacity)
            and np.array_equal(encode.dequantize_rows(quant.used_q,
                                                      quant.scale[1]),
                               base.used)):
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
            plan, d = None, 0
    if plan is None:
        plan = encode.shape_plan(st.u_pad, ct.n_pad, ct.n_real, max_count,
                                 total_asks)
    with_scores, slot_m, max_nnz = plan
    if d:
        # Per-shard static packs: node rows cut to their owning shard.
        sbuf, meta_s = xfer.pack_host_sharded(static, d,
                                              replicate=("res_scale",))
    else:
        sbuf, meta_s = xfer.pack_host(static)
    dbuf, meta_d = xfer.pack_host(dyn)
    t1 = time.perf_counter()

    timer = _DeviceTimer(dev)
    dyn_dev = torch.from_numpy(dbuf).to(dev)
    if d:
        from ..parallel import sharded

        # One upload per shard; the replicated dyn buffer goes to the
        # other devices inside the pass.  k_cand >= the largest count (or
        # the whole shard) keeps each round's global top-k inside the
        # gathered candidates, so the mesh commits exactly what the
        # single-chip loop commits (sharded.py:411-418).
        out = sharded.sharded_fused_pass(
            mesh, [torch.from_numpy(sbuf[i]).to(dv)
                   for i, dv in enumerate(mesh.devices)], dyn_dev,
            meta_s=meta_s, meta_d=meta_d, u_pad=st.u_pad, n_pad=ct.n_pad,
            with_scores=with_scores, max_nnz=max_nnz, slot_m=slot_m,
            k_cand=min(ct.n_pad // d,
                       encode.pow2_bucket(max(64, max_count))))
    else:
        out = kernels.fused_pass(
            torch.from_numpy(sbuf).to(dev), dyn_dev, meta_s=meta_s,
            meta_d=meta_d, u_pad=st.u_pad, n_pad=ct.n_pad,
            with_scores=with_scores, max_nnz=max_nnz, slot_m=slot_m)
    raw = out.buf.cpu().numpy()          # the one result fetch
    summary = xfer.unpack_host(raw, out.meta)
    nnz = int(summary["scalars"][0])
    coo = summary["coo"]
    if nnz > coo.shape[0]:
        coo = _overflow_coo(out, nnz, max_nnz, with_scores,
                            coo.dtype == np.uint16)
    coo = np.asarray(coo[:nnz], dtype=np.int64)
    device_s = timer.seconds()
    t2 = time.perf_counter()

    placements = _finalize(spec_list, ct, summary["unplaced"], coo,
                           with_scores)
    if with_networks:
        _offer_networks(jobs, eval_ids, spec_list, placements, nodes_by_id,
                        allocs_by_node)
    t3 = time.perf_counter()
    return BatchResult(
        placements=placements, rounds=int(summary["scalars"][1]),
        device=str(dev),
        timings={"encode": t1 - t0, "device": device_s,
                 "decode": t3 - t2}, mesh_shards=d)


def _offer_networks(jobs, eval_ids, spec_list, placements, nodes_by_id,
                    allocs_by_node) -> None:
    """Concrete network offers for every placed alloc of a spec with
    network asks (``_finalize``, batch_sched.py:2226-2270): the device
    counted ports and bandwidth; here each task gets its IP and port
    numbers.  One ``NetworkIndex`` per node serves the whole batch,
    seeded from the node and its live allocs, and takes each offer as it
    is made.  The jobs go in their given order, their groups in job
    order, each group's allocs in placement order, and a group's port
    picks draw from ``random.Random(<the job's evaluation id>)``, made
    anew for each group -- the reference's order, so its offers repeat
    bit for bit.  An alloc whose offer fails stays unplaced, with a
    warning, as there."""
    specs = {(sp.job.id, sp.tg.name): sp for sp in spec_list}
    cache: Dict[str, NetworkIndex] = {}
    for job, ev_id in zip(jobs, eval_ids):
        for tg in job.task_groups:
            key = (job.id, tg.name)
            spec, res = specs.get(key), placements.get(key)
            if spec is None or res is None or not spec.net_asks:
                continue
            rng = random.Random(ev_id)
            keep, offers = [], []
            for i, nid in enumerate(res.node_ids):
                idx = cache.get(nid)
                if idx is None:
                    idx = cache[nid] = NetworkIndex()
                    idx.set_node(nodes_by_id[nid])
                    idx.add_allocs(allocs_by_node.get(nid, []))
                nets: Dict[str, s.NetworkResource] = {}
                for t in tg.tasks:
                    ask_net = spec.net_asks.get(t.name)
                    if ask_net is None:
                        continue
                    offer, err = idx.assign_network(ask_net, rng)
                    if offer is None:
                        logger.warning("batch: network offer failed on "
                                       "%s: %s", nid, err)
                        nets = None
                        break
                    idx.add_reserved(offer)
                    nets[t.name] = offer
                if nets is not None:
                    keep.append(i)
                    offers.append(nets)
            lost = len(res.node_ids) - len(keep)
            if lost:
                res.node_ids = [res.node_ids[i] for i in keep]
                res.scores = res.scores[keep]
                res.collisions = res.collisions[keep]
                res.unplaced += lost
            res.networks = offers


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


def _finalize(spec_list, ct, unplaced_arr, coo, with_scores):
    rows, cols, counts = coo[:, 0], coo[:, 1], coo[:, 2]
    problem = validate_device_outputs(spec_list, ct, unplaced_arr, rows,
                                      cols, counts)
    if problem is not None:
        raise KernelIntegrityError(problem)
    n_specs = len(spec_list)
    if with_scores:
        scores = coo[:, 3].astype(np.int32).view(np.float32)
        coll = coo[:, 4].astype(np.int32)
    else:
        scores = np.zeros(len(coo), dtype=np.float32)
        coll = np.zeros(len(coo), dtype=np.int32)
    exp_off, exp_idx = decode.expand_coo(rows, cols, counts, n_specs,
                                         ct.n_real)
    valid = (rows >= 0) & (cols < ct.n_real)
    per_alloc_sc = np.repeat(scores[valid], counts[valid])
    per_alloc_co = np.repeat(coll[valid], counts[valid])
    s_off, s_col, s_sc, s_co = decode.last_scores(
        rows, cols, scores, coll, n_specs, ct.n_real)
    node_ids = np.array(ct.node_ids, dtype=object)
    out: Dict[Tuple[str, str], SpecPlacement] = {}
    for u, sp in enumerate(spec_list):
        lo, hi = int(exp_off[u]), int(exp_off[u + 1])
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
