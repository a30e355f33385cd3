"""Batch-placement device program in PyTorch (``nomad_tpu/ops/kernels.py``):
feasibility, the rank-and-commit placement rounds, COO compaction and
the fused single-buffer pass.

Eager PyTorch on ``cuda`` or ``cpu``.  The per-commit score is the
hand-written kernel behind :func:`ops.fused_score.scored_rows`; the rest
is plain tensor code.  The placement loop is a Python loop over rounds
and specs: the reference's ``lax.cond`` skips and ``while_loop`` exit
become host decisions, at one host read per committing spec step (the
feasible count ``k``) and one per round (the early-exit test).  A step
whose spec carries an active distinct_property constraint makes one more
read, of the count its value dedup kept (:data:`DP_HOST_READS`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import fused_score, xfer
from .encode import (MISSING, OP_EQ, OP_GE, OP_GT, OP_LE, OP_LT, OP_NE,
                     OP_TRUE, UNKNOWN_RHS)
from .fused_score import score_fit as _score_fit  # noqa: F401 (kernels.py name)
from .fused_score import tie_jitter  # noqa: F401 (kernels.py name)

_U32 = 0xFFFFFFFF
NEG_INF = fused_score.NEG_INF

# Host-side counts of the placement loops (single card and mesh), read by
# chip_smoke.py: committing spec steps (a spec step with k > 0, which
# launches the score kernel once on one card and once per shard on the
# mesh), and the extra host reads of the distinct_property steps.
COMMIT_STEPS = 0
DP_HOST_READS = 0


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _U32


def _threefry2x32(k0: int, k1: int, x0: int, x1: int):
    """Threefry-2x32, 20 rounds (Random123; jax's threefry2x32_p)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = (x0 + ks[0]) & _U32
    x1 = (x1 + ks[1]) & _U32
    for i in range(5):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _U32
    return x0, x1


def jitter_seed(rng_seed: int) -> int:
    """The uint32 tie-break seed the reference draws as
    ``jax.random.bits(jax.random.PRNGKey(rng_seed), (), uint32)``
    (kernels.py:92-95, :781): a threefry2x32 hash of counter (0, 0)
    under the key (seed >> 32, seed & 0xFFFFFFFF), its two words XORed.
    Every near-tie depends on this value, so it is reproduced exactly."""
    seed = int(rng_seed)
    k0 = (seed >> 32) & _U32 if seed >= 0 else _U32
    a, b = _threefry2x32(k0, seed & _U32, 0, 0)
    return a ^ b


def _select_top_k(scored: torch.Tensor, ok: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Mask of the k highest-scored ok nodes, ties broken by ascending
    node index (kernels.py:157-212): an exact radix select over the
    order-preserving uint32 image of the f32 scores, four byte passes
    with the histogram as a scatter-add.  The uint32 image is held in
    int64 (torch's uint32 support is partial)."""
    dev = scored.device
    bits = scored.contiguous().view(torch.int32).to(torch.int64) & _U32
    ordered = torch.where((bits >> 31) == 0, bits | 0x80000000,
                          (~bits) & _U32)
    bins = torch.arange(256, dtype=torch.int64, device=dev)

    def radix_pass(cand, byte, above):
        hist = torch.zeros(256, dtype=torch.int64, device=dev).index_add_(
            0, byte, cand.to(torch.int64))
        cnt_ge = above + torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0),
                                    (0,))
        # cnt_ge is non-increasing and cnt_ge[0] >= k: the threshold byte
        # is the last b with cnt_ge[b] >= k.
        t_b = (cnt_ge >= k).sum() - 1
        above = above + torch.where(bins > t_b, hist, 0).sum()
        return t_b, above

    above = torch.zeros((), dtype=torch.int64, device=dev)
    t1, above = radix_pass(ok, ordered >> 24, above)
    cand = ok & ((ordered >> 24) == t1)
    t2, above = radix_pass(cand, (ordered >> 16) & 0xFF, above)
    p16 = (t1 << 8) | t2
    cand = ok & ((ordered >> 16) == p16)
    t3, above = radix_pass(cand, (ordered >> 8) & 0xFF, above)
    p24 = (p16 << 8) | t3
    cand = ok & ((ordered >> 8) == p24)
    t4, above = radix_pass(cand, ordered & 0xFF, above)
    thresh = (p24 << 8) | t4

    # T is the k-th largest ok value; fewer than k ok nodes lie strictly
    # above it.  The rest come from the == T band in node-index order.
    sel_gt = ok & (ordered > thresh)
    band = ok & (ordered == thresh)
    need = k - sel_gt.sum()
    csum = torch.cumsum(band.to(torch.int64), 0)
    return sel_gt | (band & (csum <= need))


def stable_top_k(scored: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis, with its order: descending,
    ties by the lower index first, in float32's total order (-0.0 below
    +0.0, NaN above +inf).  ``torch.topk`` does not keep that tie order,
    and a score row without jitter is mostly ties, so this is a stable
    descending sort of the order-preserving int32 image, cut to ``k``.
    Returns ``(values, indices int64)``."""
    bits = scored.contiguous().view(torch.int32)
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    idx = torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(scored, -1, idx), idx


def feasibility_matrix(attr_values, eligible, dc_code, c_attr, c_op, c_rhs,
                       dc_mask, precomp) -> torch.Tensor:
    """F[U, N]: static feasibility of spec u on node n (kernels.py:216):
    precomp ∧ dc membership ∧ eligible ∧ the AND over constraint columns
    of EQ/NE/LT/LE/GT/GE on ordered-interned codes.  A MISSING value
    fails every real constraint; UNKNOWN_RHS makes EQ false and NE true;
    OP_TRUE padding passes.  ``precomp`` may be the [1, 1] broadcast."""
    u = c_attr.shape[0]
    n = attr_values.shape[0]
    # Padding nodes carry dc MISSING (-1) and are ineligible, so the
    # clamped gather below never decides their row.
    dc_ok = torch.gather(dc_mask, 1,
                         dc_code.clamp(min=0).to(torch.int64)[None, :]
                         .expand(u, n))
    f = precomp & dc_ok & eligible[None, :]
    for k in range(c_attr.shape[1]):
        vals = attr_values[:, c_attr[:, k].to(torch.int64)].T    # [U, N]
        rhs = c_rhs[:, k][:, None]
        op = c_op[:, k][:, None]
        unknown_rhs = rhs == int(UNKNOWN_RHS)
        ok = torch.where(op == OP_EQ, (vals == rhs) & ~unknown_rhs,
             torch.where(op == OP_NE, (vals != rhs) | unknown_rhs,
             torch.where(op == OP_LT, vals < rhs,
             torch.where(op == OP_LE, vals <= rhs,
             torch.where(op == OP_GT, vals > rhs,
             torch.where(op == OP_GE, vals >= rhs,
                         torch.ones_like(vals, dtype=torch.bool)))))))
        ok = torch.where(op == OP_TRUE, True, ok & (vals != int(MISSING)))
        f = f & ok
    return f


class PlacementResult(NamedTuple):
    placements: torch.Tensor        # [U, N] int32 (matrix mode) or [1, 1]
    unplaced: torch.Tensor          # [U] int32
    used_after: torch.Tensor        # [N, 4] int32
    rounds: int
    commit_scores: torch.Tensor     # [U, N] f32 (matrix mode + scores)
    commit_collisions: torch.Tensor  # [U, N] int32
    slots: torch.Tensor             # [U, M] int32, -1 padding (slot mode)
    slot_scores: torch.Tensor       # [U, M] f32 (slot mode + scores)
    slot_coll: torch.Tensor         # [U, M] int32


class NetTensors(NamedTuple):
    """Per-spec network asks and per-node port and bandwidth state
    (kernels.py:321).  The port words are the int32 bit images of the
    reference's uint32 words (bit 31 is the sign bit)."""

    active: torch.Tensor      # [U] bool
    mbits: torch.Tensor       # [U] int32
    dyn_need: torch.Tensor    # [U] int32 — dynamic + reserved-in-dyn-range
    resv_words: torch.Tensor  # [U, W] int32 — reserved-port bitmask
    bw_cap: torch.Tensor      # [N] int32, -1 = no network device
    bw_used: torch.Tensor     # [N] int32
    dyn_free: torch.Tensor    # [N] int32
    port_words: torch.Tensor  # [N, W] int32 — used-port bitmaps


class DPTensors(NamedTuple):
    """distinct_property state (kernels.py:335, propertyset.go:11)."""

    col: torch.Tensor         # [U] int32 — attr column, -1 = none
    active: torch.Tensor      # [U] bool
    used0: torch.Tensor       # [U, V] bool — value codes in use
    attr_values: torch.Tensor  # [N, K] int32 — node attribute codes


def net_mask(net: NetTensors, u: int, reserved: bool) -> torch.Tensor:
    """[N] bool: bandwidth fits, free dynamic ports suffice and no
    reserved port of spec ``u`` is taken (kernels.py:472-478).  With
    ``reserved`` False -- the spec reserves no port, so the test is false
    on every node -- the [N, W] pass over the bitmaps is skipped."""
    ok = ((net.bw_used + net.mbits[u] <= net.bw_cap)
          & (net.dyn_free >= net.dyn_need[u]))
    if reserved:
        ok = ok & ~((net.port_words & net.resv_words[u][None, :]) != 0).any(1)
    return ok


def net_commit(net: NetTensors, u: int, sel_i, reserved: bool) -> None:
    """Spec ``u``'s network commit on the selected nodes, in place
    (kernels.py:554-562)."""
    net.bw_used.add_(sel_i * net.mbits[u])
    net.dyn_free.sub_(sel_i * net.dyn_need[u])
    if reserved:
        net.port_words.bitwise_or_(sel_i[:, None] * net.resv_words[u][None, :])


def net_state(net: NetTensors) -> NetTensors:
    """``net`` with its per-node state copied, for the loop to update in
    place."""
    return net._replace(**{f: getattr(net, f).clone()
                           for f in ("bw_used", "dyn_free", "port_words")})


def dp_mask(attr_values, col: int, used_row, v_pad: int):
    """The distinct_property mask of one spec (kernels.py:483-487): the
    node has the property and its value is unused.  Returns ``(mask,
    code_c)``, ``code_c`` the codes clamped into the value axis (int64)."""
    codes = attr_values[:, col]
    code_c = codes.clamp(0, v_pad - 1).to(torch.int64)
    return (codes != int(MISSING)) & ~used_row[code_c], code_c


def dp_best(sel, scored, code_c, v_pad: int):
    """The best selected score per property value, by a scatter-max into a
    NEG_INF-filled buffer (kernels.py:514-516): ``(sel_score, best)``."""
    sel_score = torch.where(sel, scored, NEG_INF)
    best = torch.full((v_pad,), NEG_INF, dtype=torch.float32,
                      device=sel.device).scatter_reduce_(
        0, code_c, sel_score, "amax", include_self=True)
    return sel_score, best


def dp_first(cand, node_idx, code_c, v_pad: int, big: int):
    """Per value, the lowest node index among the candidates, by a
    scatter-min into a buffer filled with ``big`` (kernels.py:518-520)."""
    return torch.full((v_pad,), big, dtype=torch.int32,
                      device=cand.device).scatter_reduce_(
        0, code_c, torch.where(cand, node_idx, big), "amin",
        include_self=True)


def dp_dedup(sel, scored, code_c, node_idx, v_pad: int,
             big: int) -> torch.Tensor:
    """The within-round value dedup of one card (kernels.py:512-525):
    among the selected nodes that share a property value, the
    best-scored one, then the lowest node index."""
    sel_score, best = dp_best(sel, scored, code_c, v_pad)
    cand = sel & (sel_score >= best[code_c])
    first = dp_first(cand, node_idx, code_c, v_pad, big)
    return cand & (node_idx == first[code_c])


def dp_used_update(sel, code_c, v_pad: int) -> torch.Tensor:
    """[V] bool: the values the selection took (kernels.py:564)."""
    return torch.zeros(v_pad, dtype=torch.int32,
                       device=sel.device).scatter_reduce_(
        0, code_c, sel.to(torch.int32), "amax", include_self=True) > 0


def placement_rounds(feas, used0, capacity, denom, ask, count, penalty,
                     distinct_hosts, job_index, job_counts0, seed: int,
                     max_rounds: int = 256, with_scores: bool = True,
                     slot_m: int = 0, net: NetTensors = None,
                     dp: DPTensors = None) -> PlacementResult:
    """The rank-and-commit loop of ``_placement_rounds_impl``
    (kernels.py:412).

    Each round walks the specs in order; a spec with work left commits
    its ``k = min(remaining, |ok|)`` best-scored ok nodes, one alloc per
    node per round, and updates usage, job counts and the slot record
    (slot mode) or the [U, N] placement matrix (matrix mode).  As in the
    reference: a spec with nothing left or with k == 0 commits nothing
    and never scores or selects (``lax.cond``, kernels.py:495, :593); the
    loop stops on no progress, all placed, ``max_rounds``, or when no
    node fits even the smallest remaining ask (``round_cond``,
    kernels.py:615-634) -- ``rounds`` counts the rounds run.  ``seed``
    is the uint32 from :func:`jitter_seed`.

    ``net`` adds the network fit and commit (bandwidth, reserved ports,
    free dynamic ports) for the specs it marks active; ``dp`` adds the
    distinct_property mask and, among the selected nodes that share a
    value, keeps the best-scored one (lowest node index on ties).  Both
    masks are ANDed into the feasibility row the score kernel gets."""
    global COMMIT_STEPS, DP_HOST_READS
    dev = feas.device
    u_pad, n_pad = feas.shape
    ask_h = ask.cpu().numpy().astype(np.int64)
    remaining = count.cpu().numpy().astype(np.int64)
    count_h = remaining.copy()
    dh_h = distinct_hosts.cpu().numpy()
    ji_h = job_index.cpu().numpy()

    used = used0.to(torch.int32).clone()
    job_counts = job_counts0.clone()
    node_idx = torch.arange(n_pad, dtype=torch.int32, device=dev)
    penalty = penalty.to(torch.float32)
    ask = ask.to(torch.int32).contiguous()
    placements = torch.zeros((u_pad, n_pad) if not slot_m else (1, 1),
                             dtype=torch.int32, device=dev)
    score_shape = (u_pad, n_pad) if with_scores and not slot_m else (1, 1)
    commit_scores = torch.zeros(score_shape, dtype=torch.float32, device=dev)
    commit_coll = torch.zeros(score_shape, dtype=torch.int32, device=dev)
    # Slot records carry one extra column: a commit's unselected nodes
    # scatter there (the reference's mode="drop" scatter, kernels.py:543,
    # made explicit), and the column is cut off at the end.
    m_cols = slot_m + 1 if slot_m else 1
    slots = torch.full((u_pad, m_cols), -1, dtype=torch.int32, device=dev)
    sshape = (u_pad, m_cols) if with_scores and slot_m else (1, 1)
    slot_scores = torch.zeros(sshape, dtype=torch.float32, device=dev)
    slot_coll = torch.zeros(sshape, dtype=torch.int32, device=dev)

    # Which specs take the network and distinct_property branches is
    # decided on the host, as the reference decides it at trace time.
    net_h = resv_h = dp_h = np.zeros(u_pad, dtype=bool)
    if net is not None:
        net_h = net.active.cpu().numpy()
        resv_h = (net.resv_words != 0).any(1).cpu().numpy()
        net = net_state(net)
    if dp is not None:
        dp_h = dp.active.cpu().numpy()
        dp_col_h = np.clip(dp.col.cpu().numpy(), 0,
                           dp.attr_values.shape[1] - 1)
        dp_used = dp.used0.clone()
        v_pad = dp_used.shape[1]

    rounds = 0
    progress = 1
    while progress > 0 and remaining.sum() > 0 and rounds < max_rounds:
        # Capacity early exit: no node fits even the dimension-wise
        # smallest remaining ask, so no spec can place anything.
        min_ask = np.where((remaining > 0)[:, None], ask_h, 2**30).min(0)
        min_ask_t = torch.as_tensor(min_ask, dtype=torch.int32, device=dev)
        if not bool((min_ask_t[None, :] <= capacity - used).all(1).any()):
            break
        progress = 0
        for u in range(u_pad):
            if remaining[u] <= 0:
                continue
            fits = (ask[u][None, :] <= capacity - used).all(1)
            # A copy: the commit below updates job_counts in place, and
            # the slot record keeps the pre-commit count.
            collisions = job_counts[int(ji_h[u])].clone()
            # The loop's ok also has distinct_hosts, the network fit and
            # the distinct_property mask (kernels.py:467-487): they are
            # ANDed into the feasibility row the score kernel gets, whose
            # own fit test repeats kernels.py:463-466.
            feas_u = feas[u]
            if dh_h[u]:
                feas_u = feas_u & (collisions == 0)
            if net_h[u]:
                feas_u = feas_u & net_mask(net, u, bool(resv_h[u]))
            if dp_h[u]:
                mask, code_c = dp_mask(dp.attr_values, int(dp_col_h[u]),
                                       dp_used[u], v_pad)
                feas_u = feas_u & mask
            ok = feas_u & fits
            k = min(int(remaining[u]), int(ok.sum()))
            if k <= 0:
                continue
            COMMIT_STEPS += 1
            scored, base = fused_score.scored_rows(
                feas_u[None, :], used, capacity, denom, ask[u:u + 1],
                penalty[u:u + 1], collisions[None, :], seed, u_offset=u,
                with_base=with_scores)
            sel = _select_top_k(scored[0], ok, k)
            placed = k
            if dp_h[u]:
                # The value dedup can keep fewer than k, so the step
                # reads its count back.
                sel = dp_dedup(sel, scored[0], code_c, node_idx, v_pad,
                               n_pad + 1)
                placed = int(sel.sum())
                DP_HOST_READS += 1

            sel_i = sel.to(torch.int32)
            used += sel_i[:, None] * ask[u][None, :]
            job_counts[int(ji_h[u])] += sel_i
            if slot_m:
                offset = int(count_h[u] - remaining[u])   # placed so far
                pos = torch.cumsum(sel_i, 0)
                dest = torch.where(sel, offset + pos - 1, slot_m).to(torch.int64)
                dest = torch.where(dest < slot_m, dest, slot_m)
                slots[u].scatter_(0, dest, node_idx)
                if with_scores:
                    slot_scores[u].scatter_(0, dest, base[0])
                    slot_coll[u].scatter_(0, dest, collisions)
            else:
                placements[u] += sel_i
                if with_scores:
                    commit_scores[u] = torch.where(sel, base[0],
                                                   commit_scores[u])
                    commit_coll[u] = torch.where(sel, collisions,
                                                 commit_coll[u])
            if net_h[u]:
                net_commit(net, u, sel_i, bool(resv_h[u]))
            if dp_h[u]:
                dp_used[u] |= dp_used_update(sel, code_c, v_pad)
            remaining[u] -= placed
            progress += placed
        rounds += 1

    if slot_m:
        slots = slots[:, :slot_m].contiguous()
        if with_scores:
            slot_scores = slot_scores[:, :slot_m].contiguous()
            slot_coll = slot_coll[:, :slot_m].contiguous()
    return PlacementResult(
        placements=placements,
        unplaced=torch.as_tensor(remaining.astype(np.int32), device=dev),
        used_after=used, rounds=rounds, commit_scores=commit_scores,
        commit_collisions=commit_coll, slots=slots,
        slot_scores=slot_scores, slot_coll=slot_coll)


def scatter_job_counts(rows, cols, vals, u_pad: int,
                       n_pad: int) -> torch.Tensor:
    """Dense per-(job, node) count matrix from the sparse upload; -1 rows
    are padding (kernels.py:1157)."""
    valid = rows >= 0
    r = rows.clamp(0, u_pad - 1).to(torch.int64)
    c = cols.clamp(0, n_pad - 1).to(torch.int64)
    out = torch.zeros(u_pad * n_pad, dtype=torch.int32, device=rows.device)
    out.index_add_(0, r * n_pad + c, torch.where(valid, vals, 0))
    return out.view(u_pad, n_pad)


def _coo_columns(rows, cols, counts, scores, coll, valid, with_scores,
                 compact_u16):
    tag = "u16" if compact_u16 else "i32"
    cols_out = [rows.to(torch.int32), cols.to(torch.int32),
                counts.to(torch.int32)]
    if with_scores:
        sc = torch.where(valid, scores, 0.0).contiguous()
        cols_out += [sc.view(torch.int32),
                     torch.where(valid, coll, 0).to(torch.int32)]
    return tag, torch.stack(cols_out, dim=1)


def _slots_coo_gather(slots, slot_scores, slot_coll, *, out_rows: int,
                      with_scores: bool, compact_u16: bool):
    """COO from the commit-ordered slot record by a gather over the
    output rows (kernels.py:793): entry i belongs to the spec found by
    ``searchsorted(csum, i, right=True)`` on the per-spec prefix sums.
    Per-alloc entries (counts 1), rows ascending, -1 rows past nnz.
    Returns ``(tag, coo [out_rows, C], nnz)``."""
    u_pad, m = slots.shape
    dev = slots.device
    placed = (slots >= 0).sum(1).to(torch.int64)
    csum = torch.cumsum(placed, 0)
    nnz = csum[-1]
    i = torch.arange(out_rows, dtype=torch.int64, device=dev)
    u = torch.searchsorted(csum, i, right=True)
    offs = csum - placed
    uc = u.clamp(0, u_pad - 1)
    j = (i - offs[uc]).clamp(0, m - 1)
    valid = i < nnz
    rows = torch.where(valid, uc, -1)
    cols = torch.where(valid, slots[uc, j].to(torch.int64), 0)
    counts = valid.to(torch.int64)
    sc = slot_scores[uc, j] if with_scores else None
    co = slot_coll[uc, j] if with_scores else None
    tag, coo = _coo_columns(rows, cols, counts, sc, co, valid, with_scores,
                            compact_u16)
    return tag, coo, nnz


def _compact_coo(result: PlacementResult, *, u_pad: int, n_pad: int,
                 with_scores: bool, max_nnz: int, compact_u16: bool):
    """COO from the [U, N] placement matrix (kernels.py:860): the
    row-major nonzeros, padded with -1 to ``max_nnz``.  Returns ``(tag,
    coo [max_nnz, C], nnz)``."""
    nz = torch.nonzero(result.placements)[:max_nnz]
    dev = result.placements.device
    rows = torch.full((max_nnz,), -1, dtype=torch.int64, device=dev)
    cols = torch.full((max_nnz,), -1, dtype=torch.int64, device=dev)
    rows[:nz.shape[0]] = nz[:, 0]
    cols[:nz.shape[0]] = nz[:, 1]
    valid = rows >= 0
    nnz = valid.sum()
    r = rows.clamp(0, u_pad - 1)
    c = cols.clamp(0, n_pad - 1)
    counts = torch.where(valid, result.placements[r, c].to(torch.int64), 0)
    sc = result.commit_scores[r, c] if with_scores else None
    co = result.commit_collisions[r, c] if with_scores else None
    tag, coo = _coo_columns(rows, cols, counts, sc, co, valid, with_scores,
                            compact_u16)
    return tag, coo, nnz


# The packed result buffer carries at most this many COO payload bytes;
# a batch whose nnz exceeds the window pays one extra prefix fetch.
FUSED_WINDOW_BYTES = 8 << 20


def fused_window(max_nnz: int, *, with_scores: bool,
                 compact_u16: bool) -> int:
    bytes_per_row = (5 if with_scores else 3) * (2 if compact_u16 else 4)
    window = max_nnz
    while window * bytes_per_row > FUSED_WINDOW_BYTES and window > 8:
        window //= 2
    return window


def fused_layout(u_pad: int, *, window_nnz: int, with_scores: bool,
                 compact_u16: bool):
    """Layout of the packed result buffer (kernels.py:994): summary
    (unplaced, feas_count, [nnz, rounds]) and the COO payload window."""
    ncols = 5 if with_scores else 3
    return xfer.layout({
        "unplaced": ("i32", (u_pad,)),
        "feas_count": ("i32", (u_pad,)),
        "scalars": ("i32", (2,)),       # [nnz, rounds]
        "coo": ("u16" if compact_u16 else "i32", (window_nnz, ncols)),
    })


def dequantize(d: dict) -> None:
    """Quantized resource rows in an unpacked static buffer
    (``cap_q``/``used_base_q`` and the [2, 4] ``res_scale`` codebook,
    ``encode.quantize_resource_rows``) become the int32 ``cap`` and
    ``used_base``, by the exact integer multiply of kernels.py:740-744."""
    if "res_scale" in d:
        scale = d.pop("res_scale").to(torch.int32)
        d["cap"] = d.pop("cap_q").to(torch.int32) * scale[0][None, :]
        d["used_base"] = (d.pop("used_base_q").to(torch.int32)
                          * scale[1][None, :])


def delta_rows(rows, lo: int, n: int) -> torch.Tensor:
    """Global delta rows -> local rows of the node range [lo, lo + n),
    int64.  Padding rows (-1) and rows outside the range go to the spare
    row ``n``, which :func:`apply_deltas` cuts off: the reference's
    mode="drop" scatters (kernels.py:752-761).  A padding row is never
    clamped onto a real one -- duplicate indices would let its write race
    a real row's in the port-word replace below."""
    local = rows.to(torch.int64) - lo
    return torch.where((rows >= 0) & (local >= 0) & (local < n), local, n)


def apply_deltas(base, rows, vals, replace: bool = False) -> torch.Tensor:
    """``base`` with ``vals`` added (or, ``replace``, written) at ``rows``
    of :func:`delta_rows`; a fresh tensor."""
    out = torch.cat([base, base.new_zeros((1,) + tuple(base.shape[1:]))])
    if replace:
        out.index_copy_(0, rows, vals)
    else:
        out.index_add_(0, rows, vals)
    return out[:base.shape[0]]


def net_tensors(ds: dict, dd: dict, rows) -> NetTensors:
    """The network state of an unpacked static/dynamic buffer pair, None
    when the batch asks for no network.  Bandwidth and free dynamic
    ports take the touched nodes' deltas *added*; their port words are
    *replaced*, since the host derives each touched node's whole port set
    again (kernels.py:757-772).  Port words ship as int32 bit images."""
    if "net_active" not in dd:
        return None
    return NetTensors(
        active=dd["net_active"], mbits=dd["net_mbits"],
        dyn_need=dd["dyn_need"], resv_words=dd["resv_words"],
        bw_cap=ds["bw_cap"],
        bw_used=apply_deltas(ds["bw_used_base"], rows, dd["u_bw"]),
        dyn_free=apply_deltas(ds["dyn_free_base"], rows, dd["u_dyn"]),
        port_words=apply_deltas(ds["port_words_base"], rows, dd["u_ports"],
                                replace=True))


def dp_tensors(d: dict) -> DPTensors:
    """The distinct_property state of the unpacked buffers, None when no
    spec carries one."""
    if "dp_col" not in d:
        return None
    return DPTensors(col=d["dp_col"], active=d["dp_active"],
                     used0=d["dp_used"], attr_values=d["attr"])


class FusedOutput(NamedTuple):
    buf: torch.Tensor            # packed uint8 result buffer
    meta: tuple                  # its layout (fused_layout)
    aux: tuple                   # overflow source: ("slots", (slots,
                                 # scores, coll)) or ("coo", coo)
    feas: torch.Tensor           # [U, N] bool, for failure forensics


def fused_pass(static_buf: torch.Tensor, dyn_buf: torch.Tensor, *, meta_s,
               meta_d, u_pad: int, n_pad: int, with_scores: bool,
               max_nnz: int, max_rounds: int = 256, slot_m: int = 0,
               used_dev: Optional[torch.Tensor] = None) -> FusedOutput:
    """The whole batch on the device (``_fused_score_commit``,
    kernels.py:1017): unpack the static and dynamic buffers, build the
    job counts and the usage matrix from their sparse rows, check
    feasibility, run the placement rounds and compact into ONE packed
    result buffer (:func:`fused_layout`).

    ``used_dev`` is the resident usage mirror (``ops/resident.py``), an
    int32 [n_pad, 4] tensor on the pass's device: it is the usage the
    rounds start from, and the dynamic buffer then carries no
    ``u_rows``/``u_vals`` (kernels.py:750-752).  The rounds work on a
    copy, so the mirror comes back unchanged (kernels.py:796): the
    applied plan's deltas reach it through the store's feed, and an
    in-place commit here would count every placement twice.  Resident
    batches carry no network asks."""
    d = xfer.unpack_device(static_buf, meta_s)
    d.update(xfer.unpack_device(dyn_buf, meta_d))
    dequantize(d)
    job_counts = scatter_job_counts(d["jc_rows"], d["jc_cols"], d["jc_vals"],
                                    u_pad=u_pad, n_pad=n_pad)
    feas = feasibility_matrix(d["attr"], d["elig"], d["dc"], d["c_attr"],
                              d["c_op"], d["c_rhs"], d["dc_mask"],
                              d["precomp"])
    if used_dev is not None:
        if "net_active" in d:
            raise ValueError("the resident usage mirror is for batches "
                             "without network asks")
        used0, net = used_dev, None
    else:
        # Sparse usage deltas over the reserved-only baseline, at the
        # rows the deltas own.
        rows = delta_rows(d["u_rows"], 0, n_pad)
        used0 = apply_deltas(d["used_base"], rows, d["u_vals"])
        net = net_tensors(d, d, rows)
    seed = jitter_seed(int(d["rng_seed"][0]))
    # placement_rounds commits into its own clone of used0.
    result = placement_rounds(
        feas, used0, d["cap"], d["denom"], d["ask"], d["count"],
        d["penalty"], d["dh"], d["ji"], job_counts, seed,
        max_rounds=max_rounds, with_scores=with_scores, slot_m=slot_m,
        net=net, dp=dp_tensors(d))

    compact_u16 = (not with_scores and u_pad <= 65536 and n_pad <= 65536
                   and max_rounds < 65536)
    window_nnz = fused_window(max_nnz, with_scores=with_scores,
                              compact_u16=compact_u16)
    feas_count = feas.sum(1).to(torch.int32)
    if slot_m:
        tag, coo_win, nnz = _slots_coo_gather(
            result.slots, result.slot_scores, result.slot_coll,
            out_rows=window_nnz, with_scores=with_scores,
            compact_u16=compact_u16)
        aux = ("slots", (result.slots, result.slot_scores, result.slot_coll))
    else:
        tag, coo_full, nnz = _compact_coo(
            result, u_pad=u_pad, n_pad=n_pad, with_scores=with_scores,
            max_nnz=max_nnz, compact_u16=compact_u16)
        coo_win = coo_full[:window_nnz]
        aux = ("coo", coo_full)
    scalars = torch.stack([nnz.to(torch.int32),
                           torch.tensor(result.rounds, dtype=torch.int32,
                                        device=nnz.device)])
    buf, meta = xfer.pack_device({
        "unplaced": ("i32", result.unplaced),
        "feas_count": ("i32", feas_count),
        "scalars": ("i32", scalars),
        "coo": (tag, coo_win),
    })
    assert meta == fused_layout(u_pad, window_nnz=window_nnz,
                                with_scores=with_scores,
                                compact_u16=compact_u16)
    return FusedOutput(buf=buf, meta=meta, aux=aux, feas=feas)


# -- plan verification (the plan applier's re-check) --------------------------

def batch_allocs_fit(capacity: torch.Tensor, used: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plan applier's vectorized fit re-check (kernels.py:1174;
    plan_apply.go:327 evaluateNodePlan, funcs.go:60 AllocsFit): for
    [n, 4] int32 ``capacity`` and proposed ``used`` (reserved included),
    ``(fit [n] bool, first exhausted dimension [n] int32, -1 where it
    fits)``, on the tensors' device.  Eager, so it takes any n: the
    reference's pow2 padding of the node axis (plan_apply.py:602-612)
    only bounds XLA's per-shape compiles and is not kept here; a zero pad
    row fits, so the reference's sliced result is the same (held by
    ``tests/test_torch_plan_apply.py``)."""
    over = used > capacity
    fit = ~over.any(dim=1)
    first_dim = torch.argmax(over.to(torch.int32), dim=1).to(torch.int32)
    return fit, torch.where(fit, torch.full_like(first_dim, -1), first_dim)


def aggregate_binpack_score(placements: torch.Tensor, used0: torch.Tensor,
                            denom: torch.Tensor,
                            ask: torch.Tensor) -> torch.Tensor:
    """The summed ScoreFit of the nodes ``placements`` [U, N] uses, taken
    at their final usage (kernels.py:1187): a scalar for differential
    score checks against the oracle."""
    total_ask = (placements.to(torch.int64)[:, :, None]
                 * ask.to(torch.int64)[:, None, :]).sum(dim=0)
    final_used = used0.to(torch.int64) + total_ask
    after = final_used[:, :2].to(torch.float32)
    safe_denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    frac = 1.0 - after / safe_denom
    total = torch.pow(10.0, frac[:, 0]) + torch.pow(10.0, frac[:, 1])
    score = torch.clamp(20.0 - total, 0.0, 18.0)
    n_placed = placements.sum(dim=0)
    return torch.sum(score * (n_placed > 0))
