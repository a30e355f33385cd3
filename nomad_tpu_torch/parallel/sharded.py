"""Node-sharded mesh path of the batch scheduler
(``nomad_tpu/parallel/sharded.py``).

The node axis is the scaling axis: each shard scores its nodes, reduces
them to a local top-k per spec, and the k·D candidates are gathered; the
sequential commit then runs on the merged candidates, keeping capacity
feedback.

The reference mesh is single-controller -- one process drives every
shard through ``shard_map`` -- and so is this one.  A :class:`NodeMesh`
is an ordered tuple of ``torch.device``; shard ``i`` owns node rows
``[i·n_l, (i+1)·n_l)`` as tensors on ``devices[i]``, and one Python loop
drives all shards.  The collectives are the small functions below:
:func:`all_gather` concatenates the shard parts in shard order on the
first device (``lax.all_gather(tiled=True)``), :func:`psum` sums them
there, and a shard reads a result back with ``.to(device)``.  One device
may appear several times: ``["cuda:0"] * 4`` is four shards on one card,
as the reference's tests run eight shards on virtual CPU devices.

Network asks shard their per-node state (bandwidth, free dynamic ports,
port bitmaps) with the nodes; distinct_property's per-spec used values
are replicated, and its within-round value dedup reduces across shards
(best score per value, then the lowest global node index).  The resident
usage mirror (``ops/resident.py``) is sharded the same way: one int32
[n_l, 4] part per shard, on the shard's device, lent to
:func:`sharded_fused_pass`.  A mesh over several cards (peer copies) is
unverified.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import fused_score, kernels, xfer

NEG_INF = -1e30
MAX_ROUNDS = 256    # the reference's default; no caller sets another


@dataclass(frozen=True)
class NodeMesh:
    """A 1-D mesh over the node axis: the shards' devices, in order."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def root(self) -> torch.device:
        """Where the collectives gather: the first shard's device."""
        return self.devices[0]


def make_node_mesh(devices: Optional[Sequence] = None) -> NodeMesh:
    """A node mesh over ``devices`` (every visible CUDA device when None;
    without CUDA that raises).  The CPU is used only when the caller
    lists ``"cpu"`` devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; list the mesh's "
                               "devices, e.g. ['cpu'] * 4")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.type == "cpu":
            dev = torch.device("cpu")     # the device CPU tensors report
        devs.append(dev)
    if not devs:
        raise ValueError("a node mesh needs at least one device")
    return NodeMesh(tuple(devs))


# -- collectives --------------------------------------------------------------

def all_gather(parts: Sequence[torch.Tensor], mesh: NodeMesh,
               dim: int = 0) -> torch.Tensor:
    """The shard parts concatenated along ``dim`` in shard order, on the
    mesh's root device."""
    return torch.cat([p.to(mesh.root) for p in parts], dim=dim)


def psum(parts: Sequence[torch.Tensor], mesh: NodeMesh) -> torch.Tensor:
    """The sum of the shard parts, on the mesh's root device."""
    total = parts[0].to(mesh.root)
    for p in parts[1:]:
        total = total + p.to(mesh.root)
    return total


def shard_nodes(mesh: NodeMesh, x: torch.Tensor,
                dim: int = 0) -> List[torch.Tensor]:
    """Cut ``x`` along its node axis ``dim`` into one contiguous part per
    shard, each on its shard's device.  A part may share memory with
    ``x``: callers that update a part in place clone it first."""
    n = x.shape[dim]
    if n % mesh.size:
        raise ValueError(f"mesh size {mesh.size} must divide the node "
                         f"axis {n} (pad the node axis up)")
    n_l = n // mesh.size
    return [x.narrow(dim, i * n_l, n_l).to(dev).contiguous()
            for i, dev in enumerate(mesh.devices)]


def _per_device(mesh: NodeMesh, x: torch.Tensor) -> dict:
    """One copy of a replicated tensor per distinct mesh device."""
    return {dev: x.to(dev).contiguous() for dev in dict.fromkeys(mesh.devices)}


# -- candidate scoring --------------------------------------------------------

def _local_topk_scores(feas_l, used_l, cap_l, denom_l, ask, k: int):
    """One shard's masked ScoreFit and its top ``k`` per spec:
    ``(scores [U, k], local_idx [U, k] int64)``.  The score is the
    ``masked_score_matrix`` kernel on a CUDA shard and its plain version
    on a CPU shard.  ``stable_top_k`` keeps ``lax.top_k``'s tie order
    (lower index first): the masked score has no jitter, so on a fleet of
    identical nodes nearly every score ties."""
    scored = fused_score.masked_score_matrix(feas_l, used_l, cap_l, denom_l,
                                             ask)
    return kernels.stable_top_k(scored, k)


def sharded_candidate_scores(mesh: NodeMesh, feas, used, capacity, denom,
                             ask, k: int = 64):
    """Score every (spec, node) pair across the mesh and return each
    spec's ``k`` best nodes of every shard: ``(scores [U, k·D] f32,
    node_idx [U, k·D] int32)`` on the root device, in shard-major order,
    with GLOBAL node indices.  ``feas`` [U, N] bool, ``used``/``capacity``
    [N, 4] int32, ``denom`` [N, 2] f32 are cut along N; ``ask`` [U, 4]
    int32 is replicated."""
    n = used.shape[0]
    n_l = n // mesh.size
    if k > n_l:
        raise ValueError(f"k={k} exceeds the {n_l} nodes of a shard")
    parts = zip(shard_nodes(mesh, feas, 1), shard_nodes(mesh, used),
                shard_nodes(mesh, capacity), shard_nodes(mesh, denom))
    ask_r = _per_device(mesh, ask.to(torch.int32))
    scores, idx = [], []
    for i, (feas_l, used_l, cap_l, denom_l) in enumerate(parts):
        s, local = _local_topk_scores(feas_l, used_l, cap_l, denom_l,
                                      ask_r[feas_l.device], k)
        scores.append(s)
        idx.append(local + i * n_l)
    return (all_gather(scores, mesh, dim=1),
            all_gather(idx, mesh, dim=1).to(torch.int32))


# -- the placement rounds -----------------------------------------------------

@dataclass
class _Shard:
    """One shard's node state in the placement rounds."""

    device: torch.device
    offset: int                  # global index of the shard's first node
    feas: torch.Tensor           # [U, n_l] bool
    used: torch.Tensor           # [n_l, 4] int32, updated in place
    cap: torch.Tensor            # [n_l, 4] int32
    denom: torch.Tensor          # [n_l, 2] f32
    jc: torch.Tensor             # [J, n_l] int32, updated in place
    out: Tuple[torch.Tensor, ...] = ()   # placements, or the slot record
    # The shard's part of the network state (per-spec asks replicated,
    # bw_used/dyn_free/port_words updated in place) and its rows of the
    # attribute codes distinct_property reads; None when unused.
    net: Optional[kernels.NetTensors] = None
    attr: Optional[torch.Tensor] = None  # [n_l, K] int32


def _mesh_rounds(mesh: NodeMesh, shards: List[_Shard], ask, count, penalty,
                 distinct_hosts, job_index, seed: int, *, k_cand: int,
                 slot_m: int = 0, with_scores: bool = False,
                 dp_spec: Optional[Tuple[torch.Tensor, ...]] = None):
    """The rank-and-commit loop of the reference's mesh
    (``sharded.py:264-389`` and ``:618-743``).  Per spec step every shard
    scores its nodes with the ``scored_rows`` kernel (jitter keyed on the
    GLOBAL node index: ``n_offset`` = the shard's first node) and keeps
    its top ``k_cand``; the gathered candidates are ranked by a stable
    argsort and the best ``k = min(remaining, |ok|)`` commit on their
    shards.

    Each shard's ``out`` is set to ``(placements [U, n_l],)`` in matrix
    mode, or to its part of the slot record ``(slots, scores, coll)``
    ``[U, slot_m + 1]`` (the encoding ``global index + 1``, 0 for empty;
    the extra column takes the dropped writes).  Returns ``(remaining
    [U] int64 numpy, rounds, committing spec steps)``.

    Shards carrying ``net`` add the network fit and commit of the active
    specs; ``dp_spec`` = ``(col, active, used0)`` adds distinct_property
    (per-spec state replicated on the root).  Its dedup keeps, per
    value, the best selected score over all shards, then the lowest
    global node index, as the single card's scatter-max and scatter-min
    do (``sharded.py:319-332``); the used values are ORed across shards.

    As in the reference there is no capacity early exit: the loop stops
    on no progress, all placed or :data:`MAX_ROUNDS`, so it ends with one
    round that places nothing (the single-chip loop's early exit,
    kernels.py:622-634, is not repeated here).  A spec with nothing left,
    or with k == 0, commits nothing in the reference; here it launches
    nothing either.  One host read per step brings the shards' ``|ok|``;
    a distinct_property step reads its deduped count as well."""
    d = mesh.size
    root = mesh.root
    u_pad = count.shape[0]
    n_l = shards[0].used.shape[0]
    remaining = count.cpu().numpy().astype(np.int64)
    count_h = remaining.copy()
    n_steps = 0
    dh_h = distinct_hosts.cpu().numpy()
    ji_h = job_index.cpu().numpy()
    ask_r = _per_device(mesh, ask.to(torch.int32))
    pen_r = _per_device(mesh, penalty.to(torch.float32))
    arange_c = torch.arange(k_cand * d, device=root)
    placed_dev = torch.zeros((), dtype=torch.int64, device=root)
    big = d * n_l + 1          # the reference's n_pad + 1
    net_h = resv_h = dp_h = np.zeros(u_pad, dtype=bool)
    if shards[0].net is not None:
        net0 = shards[0].net
        net_h = net0.active.cpu().numpy()
        resv_h = (net0.resv_words != 0).any(1).cpu().numpy()
    if dp_spec is not None:
        dp_col, dp_active, dp_used = dp_spec
        dp_h = dp_active.cpu().numpy()
        dp_col_h = np.clip(dp_col.cpu().numpy(), 0,
                           shards[0].attr.shape[1] - 1)
        dp_used = dp_used.to(root).clone()
        v_pad = dp_used.shape[1]
    for sh in shards:
        if slot_m:
            sshape = (u_pad, slot_m + 1) if with_scores else (1, 1)
            sh.out = (torch.zeros((u_pad, slot_m + 1), dtype=torch.int32,
                                  device=sh.device),
                      torch.zeros(sshape, dtype=torch.float32,
                                  device=sh.device),
                      torch.zeros(sshape, dtype=torch.int32,
                                  device=sh.device))
        else:
            sh.out = (torch.zeros((u_pad, n_l), dtype=torch.int32,
                                  device=sh.device),)
    gidx = [torch.arange(n_l, dtype=torch.int32, device=sh.device)
            + sh.offset for sh in shards]

    rounds = 0
    progress = 1
    while progress > 0 and remaining.sum() > 0 and rounds < MAX_ROUNDS:
        progress = 0
        for u in range(u_pad):
            if remaining[u] <= 0:
                continue
            j = int(ji_h[u])
            if dp_h[u]:
                used_row = _per_device(mesh, dp_used[u])
            steps = []
            for sh in shards:
                a = ask_r[sh.device][u]
                fits = (a[None, :] <= sh.cap - sh.used).all(1)
                # A copy: the commit updates jc in place, and the slot
                # record keeps the pre-commit count.
                coll = sh.jc[j].clone()
                feas_u = sh.feas[u]
                if dh_h[u]:
                    feas_u = feas_u & (coll == 0)
                if net_h[u]:
                    feas_u = feas_u & kernels.net_mask(sh.net, u,
                                                       bool(resv_h[u]))
                code_c = None
                if dp_h[u]:
                    mask, code_c = kernels.dp_mask(
                        sh.attr, int(dp_col_h[u]), used_row[sh.device],
                        v_pad)
                    feas_u = feas_u & mask
                steps.append((feas_u, coll, feas_u & fits, code_c))
            n_ok = torch.stack([ok.sum().to(root)
                                for _, _, ok, _ in steps]).cpu().numpy()
            k = min(int(remaining[u]), int(n_ok.sum()))
            if k <= 0:
                continue
            kernels.COMMIT_STEPS += 1
            n_steps += 1
            loc = []
            for sh, (feas_u, coll, _, _) in zip(shards, steps):
                scored, base = fused_score.scored_rows(
                    feas_u[None, :], sh.used, sh.cap, sh.denom,
                    ask_r[sh.device][u:u + 1], pen_r[sh.device][u:u + 1],
                    coll[None, :], seed, u_offset=u, n_offset=sh.offset,
                    with_base=with_scores)
                loc.append((scored[0],) + kernels.stable_top_k(
                    scored[0], k_cand) + (base,))
            # The global selection on the gathered candidates.  Their
            # order is (shard, local rank), so the stable argsort breaks
            # score ties by global node index, like jnp.argsort
            # (sharded.py:312) and the single-chip select.  Candidates at
            # NEG_INF are cut by the > NEG_INF / 2 test.
            all_scores = all_gather([s for _, s, _, _ in loc], mesh)
            order = torch.argsort(-all_scores, stable=True)
            ranks = torch.empty_like(order).scatter_(0, order, arange_c)
            sel_cand = (all_scores > NEG_INF / 2) & (ranks < k)
            sels = []
            for i, (sh, (_, _, ok, _), (_, _, loc_idx, _)) in enumerate(
                    zip(shards, steps, loc)):
                my_sel = sel_cand[i * k_cand:(i + 1) * k_cand].to(sh.device)
                # The reference's zeros(n_l).at[loc_idx].set(my_sel) & ok.
                sels.append(torch.zeros(n_l, dtype=torch.bool,
                                        device=sh.device).scatter_(
                    0, loc_idx, my_sel) & ok)
            if dp_h[u]:
                sels = _dp_dedup(mesh, shards, sels, loc, steps, gidx, v_pad,
                                 big)
                counts = torch.stack([sel.sum().to(root) for sel in sels])
            else:
                counts = sel_cand.view(d, k_cand).sum(1)
            # Slot positions: allocs placed so far + lower-shard prefix +
            # within-shard ascending-node rank (sharded.py:683-688).
            prefix = torch.cumsum(counts, 0) - counts
            offset = int(count_h[u] - remaining[u])
            for i, (sh, sel, (_, coll, _, code_c), (_, _, _, base)) in (
                    enumerate(zip(shards, sels, steps, loc))):
                sel_i = sel.to(torch.int32)
                sh.used += sel_i[:, None] * ask_r[sh.device][u][None, :]
                sh.jc[j] += sel_i
                placed_dev += sel_i.sum().to(root)
                if slot_m:
                    slots, sscores, scoll = sh.out
                    pos = torch.cumsum(sel_i, 0)
                    dest = torch.where(
                        sel, offset + prefix[i].to(sh.device) + pos - 1,
                        slot_m)
                    # The reference's mode="drop" scatter, made explicit:
                    # unselected nodes and positions past the record go
                    # to the extra column.
                    dest = torch.where(dest < slot_m, dest,
                                       slot_m).to(torch.int64)
                    slots[u].scatter_(0, dest, gidx[i] + 1)
                    if with_scores:
                        sscores[u].scatter_(0, dest, base[0])
                        scoll[u].scatter_(0, dest, coll)
                else:
                    sh.out[0][u] += sel_i
                if net_h[u]:
                    kernels.net_commit(sh.net, u, sel_i, bool(resv_h[u]))
                if dp_h[u]:
                    dp_used[u] |= kernels.dp_used_update(
                        sel, code_c, v_pad).to(root)
            if dp_h[u]:
                # The dedup can keep fewer than k: read the count.
                placed = int(counts.sum())
                kernels.DP_HOST_READS += 1
            else:
                # Every selected candidate is ok, so each shard commits
                # min(k_cand, its |ok|) candidates at most, and the step
                # min(k, their sum).  The device's own count is held
                # against this sum after the loop.
                placed = min(k, int(np.minimum(n_ok, k_cand).sum()))
            remaining[u] -= placed
            progress += placed
        rounds += 1
    if int(placed_dev) != int((count_h - remaining).sum()):
        raise RuntimeError(f"mesh commit placed {int(placed_dev)} allocs, "
                           f"the host counted "
                           f"{int((count_h - remaining).sum())}")
    return remaining, rounds, n_steps


def _dp_dedup(mesh: NodeMesh, shards, sels, loc, steps, gidx, v_pad: int,
              big: int):
    """The within-round distinct_property dedup across shards
    (``sharded.py:319-332``): per value the best selected score over all
    shards (a max of the shards' scatter-max), then among the nodes that
    reach it the lowest GLOBAL node index (a min of the shards'
    scatter-min).  Bit for bit the single card's choice."""
    parts = [kernels.dp_best(sel, scored, code_c, v_pad)
             for sel, (scored, _, _, _), (_, _, _, code_c)
             in zip(sels, loc, steps)]
    best_g = _per_device(mesh, torch.stack(
        [b.to(mesh.root) for _, b in parts]).amax(0))
    cands = [sel & (sel_score >= best_g[sh.device][code_c])
             for sh, sel, (sel_score, _), (_, _, _, code_c)
             in zip(shards, sels, parts, steps)]
    first_g = _per_device(mesh, torch.stack(
        [kernels.dp_first(cand, gi, code_c, v_pad, big).to(mesh.root)
         for cand, gi, (_, _, _, code_c) in zip(cands, gidx, steps)]
    ).amin(0))
    return [cand & (gi == first_g[sh.device][code_c])
            for sh, cand, gi, (_, _, _, code_c)
            in zip(shards, cands, gidx, steps)]


class MeshPlacementResult(NamedTuple):
    placements: torch.Tensor     # [U, N] int32 allocs of spec u on node n
    unplaced: torch.Tensor       # [U] int32
    used_after: torch.Tensor     # [N, 4] int32
    rounds: int


def _shard_net(mesh: NodeMesh, net: kernels.NetTensors):
    """One NetTensors per shard: the per-node state cut with the nodes
    (and copied: the loop updates it), the per-spec asks replicated."""
    spec = {f: _per_device(mesh, getattr(net, f))
            for f in ("active", "mbits", "dyn_need", "resv_words")}
    node = {f: shard_nodes(mesh, getattr(net, f))
            for f in ("bw_cap", "bw_used", "dyn_free", "port_words")}
    return [kernels.net_state(kernels.NetTensors(
        **{f: v[dev] for f, v in spec.items()},
        **{f: v[i] for f, v in node.items()}))
        for i, dev in enumerate(mesh.devices)]


def sharded_placement_rounds(mesh: NodeMesh, feas, used0, capacity, denom,
                             ask, count, penalty, distinct_hosts, job_index,
                             job_counts0, seed: int, k_cand: int = 64,
                             net: Optional[kernels.NetTensors] = None,
                             dp: Optional[kernels.DPTensors] = None
                             ) -> MeshPlacementResult:
    """The single-chip placement semantics, node-sharded over the mesh
    (reference ``sharded.py:173``): anti-affinity collisions,
    distinct_hosts, per-(job, node) counts, network accounting,
    distinct_property and the multi-round capacity-feedback loop.  Node
    tensors ([U, N] ``feas``, [N, 4] ``used0``/``capacity``, [N, 2]
    ``denom``, [J, N] ``job_counts0``, and the per-node parts of ``net``
    and ``dp``) are cut along N; the per-spec ones are replicated.
    ``seed`` is the uint32 of :func:`ops.kernels.jitter_seed`.

    While a spec commits at most ``k_cand`` allocs a round, the selection
    equals the single-chip loop's; a spec that needs more under-commits
    and finishes in later rounds.  Results are on the root device."""
    n_pad = feas.shape[1]
    n_l = n_pad // mesh.size
    nets = (_shard_net(mesh, net) if net is not None
            else [None] * mesh.size)
    attrs = (shard_nodes(mesh, dp.attr_values.to(torch.int32))
             if dp is not None else [None] * mesh.size)
    shards = [
        _Shard(device=dev, offset=i * n_l, feas=f, used=us.clone(), cap=c,
               denom=dn, jc=jc.clone(), net=nt, attr=at)
        for i, (dev, f, us, c, dn, jc, nt, at) in enumerate(zip(
            mesh.devices, shard_nodes(mesh, feas, 1),
            shard_nodes(mesh, used0.to(torch.int32)),
            shard_nodes(mesh, capacity.to(torch.int32)),
            shard_nodes(mesh, denom.to(torch.float32)),
            shard_nodes(mesh, job_counts0.to(torch.int32), 1), nets,
            attrs))]
    remaining, rounds, _ = _mesh_rounds(
        mesh, shards, ask, count, penalty, distinct_hosts, job_index, seed,
        k_cand=min(k_cand, n_l),
        dp_spec=None if dp is None else (dp.col, dp.active, dp.used0))
    return MeshPlacementResult(
        placements=all_gather([sh.out[0] for sh in shards], mesh, dim=1),
        unplaced=torch.as_tensor(remaining.astype(np.int32),
                                 device=mesh.root),
        used_after=all_gather([sh.used for sh in shards], mesh),
        rounds=rounds)


def sharded_schedule_step(mesh: NodeMesh, feas, used, capacity, denom, ask,
                          count, k: int = 64):
    """One scheduling step over the mesh with default job bookkeeping (one
    job per spec, the service anti-affinity penalty 20, no
    distinct_hosts, the seed of ``PRNGKey(0)``): ``(placements,
    used_after)`` (reference ``sharded.py:769``)."""
    u_pad, n_pad = feas.shape
    result = sharded_placement_rounds(
        mesh, feas, used, capacity, denom, ask, count,
        penalty=torch.full((u_pad,), 20.0),
        distinct_hosts=torch.zeros(u_pad, dtype=torch.bool),
        job_index=torch.arange(u_pad, dtype=torch.int32),
        job_counts0=torch.zeros((u_pad, n_pad), dtype=torch.int32),
        seed=kernels.jitter_seed(0), k_cand=k)
    return result.placements, result.used_after


# -- the fused mesh pass ------------------------------------------------------

def sharded_fused_pass(mesh: NodeMesh, static_shards: Sequence[torch.Tensor],
                       dyn_buf: torch.Tensor, *, meta_s, meta_d, u_pad: int,
                       n_pad: int, with_scores: bool, max_nnz: int,
                       slot_m: int, k_cand: int,
                       used_dev: Optional[Sequence[torch.Tensor]] = None
                       ) -> kernels.FusedOutput:
    """The whole batch over the mesh (reference ``sharded_fused_pass`` and
    ``_build_fused_mesh_fn``, ``sharded.py:443-766``).

    ``static_shards`` holds one packed static buffer per shard (the rows
    :func:`ops.xfer.pack_host_sharded` cut, laid out by ``meta_s``), each
    on its shard's device; ``dyn_buf`` is the replicated dynamic buffer.
    Each shard unpacks (and dequantizes) its part, applies the usage,
    bandwidth, dynamic-port and port-word deltas and the job counts of
    the nodes it owns and checks feasibility; the placement rounds run
    over the mesh; the shards' disjoint slot records merge by one
    :func:`psum`; then the slot→COO gather and the packed result buffer
    of :func:`ops.kernels.fused_pass`, on the root device.  ``feas`` of
    the result is the list of the shards' [U, n_l] parts.

    ``used_dev``, the resident mirror's shard parts, is each shard's
    starting usage in place of the ``u_rows``/``u_vals`` deltas, which
    the dynamic buffer then does not carry.  The rounds commit into
    clones, so the parts come back unchanged, as on one card."""
    d = mesh.size
    if n_pad % d:
        raise ValueError(f"mesh size {d} must divide the node pad {n_pad}")
    if slot_m <= 0:
        raise ValueError("the fused mesh pass needs a slot record")
    n_l = n_pad // d
    k_cand = min(k_cand, n_l)
    compact_u16 = not with_scores and u_pad <= 65536 and n_pad <= 65536
    window_nnz = kernels.fused_window(max_nnz, with_scores=with_scores,
                                      compact_u16=compact_u16)
    kernels.note_signature("sharded_fused_pass", (
        tuple(str(dv) for dv in mesh.devices), meta_s, meta_d, u_pad,
        n_pad, with_scores, slot_m, k_cand, window_nnz, compact_u16,
        used_dev is not None))
    dyn = {dev: xfer.unpack_device(dyn_buf.to(dev), meta_d)
           for dev in dict.fromkeys(mesh.devices)}
    shards = []
    for i, dev in enumerate(mesh.devices):
        ds = xfer.unpack_device(static_shards[i].to(dev), meta_s)
        kernels.dequantize(ds)
        dd = dyn[dev]
        lo = i * n_l
        # Usage deltas and job counts carry GLOBAL node indices; each
        # shard applies the ones it owns.  The others go to a spare row
        # (deltas) or are zeroed (counts): the reference's mode="drop"
        # scatters (sharded.py:570-582), made explicit.
        if used_dev is not None:
            if "net_active" in dd:
                raise ValueError("the resident usage mirror is for "
                                 "batches without network asks")
            rows, used0 = None, used_dev[i].clone()
        else:
            rows = kernels.delta_rows(dd["u_rows"], lo, n_l)
            used0 = kernels.apply_deltas(ds["used_base"], rows,
                                         dd["u_vals"])
        jcol = dd["jc_cols"] - lo
        jvalid = (dd["jc_rows"] >= 0) & (jcol >= 0) & (jcol < n_l)
        jc = kernels.scatter_job_counts(
            torch.where(jvalid, dd["jc_rows"], -1), jcol, dd["jc_vals"],
            u_pad=u_pad, n_pad=n_l)
        precomp = dd["precomp"]
        if precomp.shape != (1, 1):
            precomp = precomp[:, lo:lo + n_l]
        feas = kernels.feasibility_matrix(
            ds["attr"], ds["elig"], ds["dc"], dd["c_attr"], dd["c_op"],
            dd["c_rhs"], dd["dc_mask"], precomp)
        shards.append(_Shard(device=dev, offset=lo, feas=feas,
                             used=used0, cap=ds["cap"], denom=ds["denom"],
                             jc=jc, net=kernels.net_tensors(ds, dd, rows),
                             attr=ds["attr"]))
    dd = dyn[mesh.root]
    seed = kernels.jitter_seed(int(dd["rng_seed"][0]))
    remaining, rounds, steps = _mesh_rounds(
        mesh, shards, dd["ask"], dd["count"], dd["penalty"], dd["dh"],
        dd["ji"], seed, k_cand=k_cand, slot_m=slot_m,
        with_scores=with_scores,
        dp_spec=((dd["dp_col"], dd["dp_active"], dd["dp_used"])
                 if "dp_col" in dd else None))

    # Disjoint per-shard parts: one psum gives the commit-ordered record
    # (sharded.py:747-749); the +1 encoding leaves empty slots at -1.  The
    # extra column of dropped writes is cut off.
    slots = (psum([sh.out[0] for sh in shards], mesh) - 1)[:, :slot_m]
    if with_scores:
        sscores = psum([sh.out[1] for sh in shards], mesh)[:, :slot_m]
        scoll = psum([sh.out[2] for sh in shards], mesh)[:, :slot_m]
    else:                   # a record without scores: [1, 1] placeholders
        sscores, scoll = (t.to(mesh.root) for t in shards[0].out[1:])
    slots, sscores, scoll = (t.contiguous() for t in (slots, sscores, scoll))
    tag, coo_win, nnz = kernels._slots_coo_gather(
        slots, sscores, scoll, out_rows=window_nnz, with_scores=with_scores,
        compact_u16=compact_u16)
    feas_count = psum([sh.feas.sum(1).to(torch.int32) for sh in shards],
                      mesh)
    root = mesh.root
    scalars = torch.stack([nnz.to(torch.int32),
                           torch.tensor(rounds, dtype=torch.int32,
                                        device=root)])
    buf, meta = xfer.pack_device({
        "unplaced": ("i32", torch.as_tensor(remaining.astype(np.int32),
                                            device=root)),
        "feas_count": ("i32", feas_count),
        "scalars": ("i32", scalars),
        "coo": (tag, coo_win),
    })
    assert meta == kernels.fused_layout(u_pad, window_nnz=window_nnz,
                                        with_scores=with_scores,
                                        compact_u16=compact_u16)
    return kernels.FusedOutput(buf=buf, meta=meta,
                               aux=("slots", (slots, sscores, scoll)),
                               feas=[sh.feas for sh in shards],
                               commit_steps=steps)
