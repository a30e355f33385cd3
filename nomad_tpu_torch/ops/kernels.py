"""Batch-placement device program in PyTorch (``nomad_tpu/ops/kernels.py``):
feasibility, the rank-and-commit placement rounds, COO compaction, the
schedule program's two halves (:func:`device_schedule`,
:func:`device_compact`, both in turn :func:`device_pass`) and the fused
single-buffer pass (:func:`fused_pass`), and the launch-signature count
(:func:`note_signature`).

On CUDA tensors the placement rounds run the round kernel
(``csrc/placement_rounds.cu``, through :func:`run_placement_rounds`):
one launch a round, every spec of the round inside it, and one read of
the round's four-int status on the host.  On CPU tensors they run the
kernel's plain version :func:`placement_rounds`, an eager Python loop
over rounds and specs whose per-commit score is
:func:`ops.fused_score.scored_rows`: there the reference's ``lax.cond``
skips and ``while_loop`` exit are host decisions, at one host read per
spec step with work left (the feasible count ``k``) and one per round
(the early-exit test), and one more per step of an active
distinct_property constraint (:data:`DP_HOST_READS`).  The rest is plain
tensor code.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

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
# chip_smoke.py: committing spec steps (a spec step with k > 0: a step of
# the round kernel on one card, one scored_rows launch a shard on the
# mesh and in the eager loop), and the extra host reads of the eager
# loop's distinct_property steps (the round kernel makes none).
COMMIT_STEPS = 0
DP_HOST_READS = 0
# Rounds the single card's placement rounds ran (run_placement_rounds,
# either route): on a card, one round-kernel launch each.
ROUNDS = 0

# -- the launch-signature count (kernels.py:46-89) -----------------------------

_COMPILE_SIGS = set()
COMPILES = 0


def note_signature(kind: str, sig: tuple) -> bool:
    """Record one launch signature; True when it is new.

    The reference counts the distinct static signatures its jitted
    programs are called with: each new one may be an XLA compile.  The
    port compiles nothing per shape -- a CUDA source is built once,
    whatever it is launched with -- so here the count is of distinct
    launch signatures (the program kind and the shapes and options it
    was given), a proxy for re-specialisation: a shape that leaks (a
    padding bucket that stopped holding) shows as a count that keeps
    climbing.  Published as the ``batch.compiles`` gauge."""
    global COMPILES
    key = (kind, sig)
    if key in _COMPILE_SIGS:
        return False
    _COMPILE_SIGS.add(key)
    COMPILES += 1
    return True


def compile_signatures() -> int:
    """Distinct launch signatures recorded in this process."""
    return COMPILES


def signature_kinds() -> dict:
    """Distinct recorded signatures per program kind: which family leaked
    shapes when the count climbs."""
    out: dict = {}
    for kind, _sig in _COMPILE_SIGS:
        out[kind] = out.get(kind, 0) + 1
    return out


def reset_compile_signatures() -> None:
    """Forget every recorded signature (tests)."""
    global COMPILES
    _COMPILE_SIGS.clear()
    COMPILES = 0


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
    commit_steps: int               # committing spec steps (launches)


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
    steps = 0
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
    slots = torch.full((u_pad, slot_m + 1) if slot_m else (1, 1), -1,
                       dtype=torch.int32, device=dev)
    sshape = (u_pad, slot_m + 1) if with_scores and slot_m else (1, 1)
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
            steps += 1
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
        slot_scores=slot_scores, slot_coll=slot_coll, commit_steps=steps)


def run_placement_rounds(feas, used0, capacity, denom, ask, count, penalty,
                         distinct_hosts, job_index, job_counts0, seed: int,
                         max_rounds: int = 256, with_scores: bool = True,
                         slot_m: int = 0, net: NetTensors = None,
                         dp: DPTensors = None) -> PlacementResult:
    """The placement rounds through the round kernel: on CUDA tensors one
    ``csrc/placement_rounds.cu`` launch a round; on CPU tensors the
    kernel's plain version, :func:`placement_rounds`.  Same arguments and
    result, bit for bit."""
    global ROUNDS
    if feas.device.type == "cpu":
        result = placement_rounds(
            feas, used0, capacity, denom, ask, count, penalty,
            distinct_hosts, job_index, job_counts0, seed,
            max_rounds=max_rounds, with_scores=with_scores, slot_m=slot_m,
            net=net, dp=dp)
    elif feas.device.type == "cuda":
        result = _kernel_rounds(
            feas, used0, capacity, denom, ask, count, penalty,
            distinct_hosts, job_index, job_counts0, seed, max_rounds,
            with_scores, slot_m, net, dp, fused_score.placement_round)
    else:
        raise ValueError(f"placement rounds: unsupported device "
                         f"{feas.device}")
    ROUNDS += result.rounds
    return result


def _kernel_rounds(feas, used0, capacity, denom, ask, count, penalty,
                   distinct_hosts, job_index, job_counts0, seed, max_rounds,
                   with_scores, slot_m, net, dp, launch) -> PlacementResult:
    """The round loop around the round kernel: the loop state in fresh
    tensors (``used0``, the job counts and the network and
    distinct_property state are not written), ``launch(t, seed)`` once a
    round (``fused_score.placement_round`` on a card; the source built
    with g++ against a CPU mock of the runtime in
    ``tests/test_torch_round_source.py``), and one read of the round's
    status.  The loop condition is
    :func:`placement_rounds`': placed something, asks left, under
    ``max_rounds``, and a node fits the smallest ask left (the first
    round's test here, the next round's at the end of each launch)."""
    global COMMIT_STEPS
    dev = feas.device
    u_pad, n_pad = feas.shape
    i32 = torch.int32

    def own(x, dtype=i32):
        return x.to(dtype).contiguous().clone()

    t = {
        "feas": feas.contiguous().view(torch.uint8),
        "used": own(used0), "cap": capacity.to(i32).contiguous(),
        "denom": denom.to(torch.float32).contiguous(),
        "ask": ask.to(i32).contiguous(), "count": count.to(i32).contiguous(),
        "remaining": own(count), "penalty": penalty.to(torch.float32)
        .contiguous(), "dh": distinct_hosts.to(torch.uint8).contiguous(),
        "ji": job_index.to(i32).contiguous(), "job_counts": own(job_counts0),
        "key": torch.empty(n_pad, dtype=i32, device=dev),
        "flag": torch.empty(n_pad, dtype=torch.uint8, device=dev),
        "status": torch.zeros(4, dtype=i32, device=dev),
    }
    if net is not None:
        t.update(net_active=net.active.to(torch.uint8).contiguous(),
                 mbits=net.mbits.to(i32).contiguous(),
                 dyn_need=net.dyn_need.to(i32).contiguous(),
                 resv_words=net.resv_words.to(i32).contiguous(),
                 bw_cap=net.bw_cap.to(i32).contiguous(),
                 bw_used=own(net.bw_used), dyn_free=own(net.dyn_free),
                 port_words=own(net.port_words))
    if dp is not None:
        v_pad = dp.used0.shape[1]
        t.update(dp_active=dp.active.to(torch.uint8).contiguous(),
                 dp_col=dp.col.clamp(0, dp.attr_values.shape[1] - 1)
                 .to(i32).contiguous(),
                 dp_used=own(dp.used0, torch.uint8),
                 attr=dp.attr_values.to(i32).contiguous(),
                 dp_best=torch.empty(v_pad, dtype=i32, device=dev),
                 dp_first=torch.empty(v_pad, dtype=i32, device=dev))
    if slot_m:
        t["slots"] = torch.full((u_pad, slot_m), -1, dtype=i32, device=dev)
        if with_scores:
            t["slot_scores"] = torch.zeros((u_pad, slot_m),
                                           dtype=torch.float32, device=dev)
            t["slot_coll"] = torch.zeros((u_pad, slot_m), dtype=i32,
                                         device=dev)
    else:
        t["placements"] = torch.zeros((u_pad, n_pad), dtype=i32, device=dev)
        if with_scores:
            t["commit_scores"] = torch.zeros((u_pad, n_pad),
                                             dtype=torch.float32, device=dev)
            t["commit_coll"] = torch.zeros((u_pad, n_pad), dtype=i32,
                                           device=dev)

    def one(dtype=i32, fill=0):     # a [1, 1] placeholder output
        return torch.full((1, 1), fill, dtype=dtype, device=dev)

    # The first round's test: asks left, and a node fits the smallest.
    active = t["remaining"] > 0
    min_ask = torch.where(active[:, None], t["ask"], 2**30).min(0).values
    first = torch.stack([
        t["remaining"].sum().to(i32),
        (min_ask[None, :] <= t["cap"] - t["used"]).all(1).any().to(i32)])
    left, fits = first.tolist()
    rounds = steps = 0
    go = left > 0 and fits and max_rounds > 0
    while go:
        status: torch.Tensor = launch(t, seed)
        rounds += 1
        placed, left, fits, round_steps = status.tolist()
        steps += round_steps
        go = placed > 0 and left > 0 and rounds < max_rounds and fits
    COMMIT_STEPS += steps
    f32 = torch.float32
    return PlacementResult(
        placements=t.get("placements", one()),
        unplaced=t["remaining"], used_after=t["used"], rounds=rounds,
        commit_scores=t.get("commit_scores", one(f32)),
        commit_collisions=t.get("commit_coll", one()),
        slots=t.get("slots", one(fill=-1)),
        slot_scores=t.get("slot_scores", one(f32)),
        slot_coll=t.get("slot_coll", one()), commit_steps=steps)


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


def compact_u16_ok(u_pad: int, n_pad: int, with_scores: bool,
                   max_rounds: int = 256) -> bool:
    """Whether the COO ships as uint16 (kernels.py:963-971): no scores,
    and row, column and count all below 65536.  ``<= 65536`` pads: a
    65,536-node bucket's largest column is 65,535."""
    return (not with_scores and u_pad <= 65536 and n_pad <= 65536
            and max_rounds < 65536)


def summary_layout(u_pad: int, n_pad: int):
    """Layout of the packed summary of :func:`device_compact`
    (kernels.py:671): unplaced, feas_count and [nnz, rounds].  The usage
    after the batch stays on the card: the host rebuilds it from the
    placements."""
    return xfer.layout({
        "unplaced": ("i32", (u_pad,)),
        "feas_count": ("i32", (u_pad,)),
        "scalars": ("i32", (2,)),       # [nnz, rounds]
    })


def schedule_inputs(static_buf: torch.Tensor, dyn_buf: torch.Tensor,
                    used_dev: Optional[torch.Tensor] = None, *, meta_s,
                    meta_d, u_pad: int, n_pad: int):
    """What the placement rounds of a batch start from: unpack the static
    and dynamic buffers, build the job counts and the usage matrix from
    their sparse rows, and check feasibility.  Returns ``(args, extra)``
    for ``run_placement_rounds(*args, **extra, ...)`` -- ``args[0]`` is
    feas [U, N] bool -- or the plain ``placement_rounds``.

    ``used_dev`` is the resident usage mirror (``ops/resident.py``), an
    int32 [n_pad, 4] tensor on the pass's device: it is the usage the
    rounds start from, and the dynamic buffer then carries no
    ``u_rows``/``u_vals`` (kernels.py:750-752).  Resident batches carry
    no network asks."""
    d: Dict[str, torch.Tensor] = xfer.unpack_device(static_buf, meta_s)
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
    args = (feas, used0, d["cap"], d["denom"], d["ask"], d["count"],
            d["penalty"], d["dh"], d["ji"], job_counts, seed)
    return args, {"net": net, "dp": dp_tensors(d)}


def device_schedule(static_buf: torch.Tensor, dyn_buf: torch.Tensor,
                    used_dev: Optional[torch.Tensor] = None, *, meta_s,
                    meta_d, u_pad: int, n_pad: int, with_scores: bool,
                    max_rounds: int = 256, slot_m: int = 0):
    """The schedule program's first half (``_device_schedule``,
    kernels.py:692): :func:`schedule_inputs` (unpack, job counts, usage,
    feasibility), then the placement rounds -- the round kernel on a
    card.  Returns ``(PlacementResult, feas [U, N] bool)``.

    The rounds work on a copy of the usage, so the resident mirror
    ``used_dev`` is not written: the applied plan's deltas reach it
    through the store's feed, and an in-place commit here would count
    every placement twice.  (The reference also returns the mirror, as
    the donated buffer XLA hands back; torch donates nothing, so the
    lender keeps its own reference.)"""
    args, extra = schedule_inputs(static_buf, dyn_buf, used_dev,
                                  meta_s=meta_s, meta_d=meta_d, u_pad=u_pad,
                                  n_pad=n_pad)
    result = run_placement_rounds(*args, max_rounds=max_rounds,
                                  with_scores=with_scores, slot_m=slot_m,
                                  **extra)
    return result, args[0]


def _summary_parts(result: PlacementResult, feas: torch.Tensor, nnz):
    """The summary's arrays (:func:`summary_layout`), as
    ``xfer.pack_device`` takes them."""
    scalars = torch.stack([nnz.to(torch.int32),
                           torch.tensor(result.rounds, dtype=torch.int32,
                                        device=nnz.device)])
    return {"unplaced": ("i32", result.unplaced.to(torch.int32)),
            "feas_count": ("i32", feas.sum(1).to(torch.int32)),
            "scalars": ("i32", scalars)}


def device_compact(result: PlacementResult, feas: torch.Tensor, *,
                   with_scores: bool, max_nnz: int,
                   compact_u16: bool = False, slot_m: int = 0):
    """The schedule program's second half (``_device_compact``,
    kernels.py:882): the COO of the placements and the packed summary
    (:func:`summary_layout`).  With ``slot_m`` the COO comes from the
    slot record (per-alloc entries, counts 1), else from the [U, N]
    placement matrix.  Returns ``(summary uint8, coo [max_nnz, C])``: C
    is 5 with scores (row, col, count, score bits, collisions), else 3;
    int32, or with ``compact_u16`` the low 16 bits as int16 (the host
    views them as uint16 and reads only the first nnz rows, where the -1
    fill would wrap)."""
    u_pad, n_pad = feas.shape
    if slot_m:
        tag, coo, nnz = _slots_coo_gather(
            result.slots, result.slot_scores, result.slot_coll,
            out_rows=max_nnz, with_scores=with_scores,
            compact_u16=compact_u16)
    else:
        tag, coo, nnz = _compact_coo(
            result, u_pad=u_pad, n_pad=n_pad, with_scores=with_scores,
            max_nnz=max_nnz, compact_u16=compact_u16)
    summary, meta = xfer.pack_device(_summary_parts(result, feas, nnz))
    assert meta == summary_layout(u_pad, n_pad)
    if tag == "u16":
        coo = coo.to(torch.int16)
    return summary, coo


class PassOutput(NamedTuple):
    """What :func:`device_pass` leaves on the card: the packed summary,
    the COO and feasibility (for failure forensics)."""

    summary: torch.Tensor        # packed uint8 (summary_layout)
    coo: torch.Tensor            # [max_nnz, C] int32, or int16 (u16)
    feas: torch.Tensor           # [U, N] bool
    commit_steps: int = 0        # the pass's committing spec steps


def device_pass(static_buf: torch.Tensor, dyn_buf: torch.Tensor,
                used_dev: Optional[torch.Tensor] = None, *, meta_s, meta_d,
                u_pad: int, n_pad: int, with_scores: bool, max_nnz: int,
                max_rounds: int = 256, slot_m: int = 0) -> PassOutput:
    """The two-pass device program (``device_pass``, kernels.py:915):
    :func:`device_schedule` then :func:`device_compact`, the COO in
    uint16 where :func:`compact_u16_ok` allows it.  The host fetches the
    summary and a [nnz, C] prefix of the COO."""
    note_signature("device_pass", (
        meta_s, meta_d, u_pad, n_pad, with_scores, max_nnz, max_rounds,
        slot_m, used_dev is not None))
    result, feas = device_schedule(
        static_buf, dyn_buf, used_dev, meta_s=meta_s, meta_d=meta_d,
        u_pad=u_pad, n_pad=n_pad, with_scores=with_scores,
        max_rounds=max_rounds, slot_m=slot_m)
    summary, coo = device_compact(
        result, feas, with_scores=with_scores, max_nnz=max_nnz,
        compact_u16=compact_u16_ok(u_pad, n_pad, with_scores, max_rounds),
        slot_m=slot_m)
    return PassOutput(summary=summary, coo=coo, feas=feas,
                      commit_steps=result.commit_steps)


class FusedOutput(NamedTuple):
    buf: torch.Tensor            # packed uint8 result buffer
    meta: tuple                  # its layout (fused_layout)
    aux: tuple                   # overflow source: ("slots", (slots,
                                 # scores, coll)) or ("coo", coo)
    feas: torch.Tensor           # [U, N] bool, for failure forensics
    commit_steps: int = 0        # the pass's committing spec steps


def fused_pass(static_buf: torch.Tensor, dyn_buf: torch.Tensor, *, meta_s,
               meta_d, u_pad: int, n_pad: int, with_scores: bool,
               max_nnz: int, max_rounds: int = 256, slot_m: int = 0,
               used_dev: Optional[torch.Tensor] = None) -> FusedOutput:
    """The whole batch on the device (``_fused_score_commit``,
    kernels.py:1017): :func:`device_schedule`, then the compaction into
    ONE packed result buffer (:func:`fused_layout`) of the summary and a
    window of the COO; past the window the COO (or the slot record) stays
    on the device as the overflow source.  ``used_dev`` is the resident
    usage mirror, as in :func:`device_schedule`."""
    compact_u16 = compact_u16_ok(u_pad, n_pad, with_scores, max_rounds)
    window_nnz = fused_window(max_nnz, with_scores=with_scores,
                              compact_u16=compact_u16)
    note_signature("fused_pass", (
        meta_s, meta_d, u_pad, n_pad, with_scores, max_nnz, max_rounds,
        slot_m, compact_u16, window_nnz, used_dev is not None))
    result, feas = device_schedule(
        static_buf, dyn_buf, used_dev, meta_s=meta_s, meta_d=meta_d,
        u_pad=u_pad, n_pad=n_pad, with_scores=with_scores,
        max_rounds=max_rounds, slot_m=slot_m)
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
    buf, meta = xfer.pack_device({**_summary_parts(result, feas, nnz),
                                  "coo": (tag, coo_win)})
    assert meta == fused_layout(u_pad, window_nnz=window_nnz,
                                with_scores=with_scores,
                                compact_u16=compact_u16)
    return FusedOutput(buf=buf, meta=meta, aux=aux, feas=feas,
                       commit_steps=result.commit_steps)


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
