"""The score kernels: the per-commit score of the placement loop
(``csrc/scored_rows.cu``) and the mesh's shard-local candidate score
(``csrc/masked_score.cu``), each with its plain PyTorch version and the
wrapper that picks between them by where the tensors lie.

Replaces the Pallas TPU kernel ``nomad_tpu/ops/pallas_score.py``
(``_scored_row_kernel``, entry ``scored_rows``).  The function is the
commit-time expression of ``nomad_tpu/ops/kernels.py:463-506``::

    ok     = feas & all(ask <= cap - used)
    base   = ScoreFit(used, ask, denom)
    scored = where(ok, base - penalty * coll + tie_jitter, NEG_INF)

The wrapper returns ``(scored, base)``, or ``(scored, None)`` when the
caller does not read ``base`` (``with_base=False``: the kernel then
writes 4 bytes a cell less).

:func:`masked_score_matrix` replaces the Pallas kernel ``_score_kernel``
(entry ``masked_score_matrix``, same file), the mask and score of
``nomad_tpu/parallel/sharded.py:_local_topk_scores``::

    masked = where(feas & all(ask <= cap - used), ScoreFit, NEG_INF)

with no penalty and no jitter.  Both kernels share their fit test and
ScoreFit (``csrc/score_common.cuh``).  For CPU tensors each wrapper
computes its plain version; for CUDA tensors it launches its kernel or
raises.  There is no fallback from one to the other.

:func:`placement_round` launches the round kernel
(``csrc/placement_rounds.cu``, one round of the placement loop, which
scores with the same device functions); its plain version is the eager
``kernels.placement_rounds``, and ``kernels.run_placement_rounds``
picks between them.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

NEG_INF = -1e30
_U32 = 0xFFFFFFFF
# float32(1e-3 / 2^24): the jitter's scale, rounded once from the double.
_JITTER_SCALE = np.float32(1e-3 / (1 << 24))

# Kernel launches made by scored_rows, by masked_score_matrix and by the
# round kernel's placement_round (the plain versions count nothing).
LAUNCHES = 0
MASKED_LAUNCHES = 0
ROUND_LAUNCHES = 0
# The port words a node may have (65,536 ports a bit each): the round
# kernel gathers a spec's reserved-port words into shared memory of this
# many entries (csrc/placement_rounds.cu kMaxPortWords).
ROUND_MAX_PORT_WORDS = 2048


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` in [0, 2^32): torch's uint32
    support is partial, so the product is split at 16 bits to stay inside
    int64 without overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def tie_jitter(seed: int, u, node_idx: torch.Tensor) -> torch.Tensor:
    """Per-(spec, node) tie-break jitter in [0, 1e-3): the fmix32 hash
    of (seed, u, node index), computed in int64 with ``& 0xFFFFFFFF``
    after every multiply and add (kernels.py:98-121).  ``u`` is an int
    or an int tensor broadcastable against ``node_idx``."""
    n = node_idx.to(torch.int64) & _U32
    u = torch.as_tensor(u, dtype=torch.int64, device=n.device) & _U32
    x = (_mul32(n, 0x9E3779B9) + _mul32(u, 0x85EBCA6B) + (seed & _U32)) & _U32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    scale = torch.tensor(_JITTER_SCALE, device=n.device)
    return (x >> 8).to(torch.float32) * scale


def score_fit(used: torch.Tensor, ask: torch.Tensor,
              denom: torch.Tensor) -> torch.Tensor:
    """Google best-fit-v3 (funcs.go:123 ScoreFit) for every node:
    ``clip(20 - 10^freeCpuFrac - 10^freeMemFrac, 0, 18)`` with the
    denom == 0 and NaN/inf rules of kernels.py:278-292.  ``used`` [N, 4],
    ``ask`` [..., 4] → [..., N]."""
    after = (used[:, :2].to(torch.float32)
             + ask[..., None, :2].to(torch.float32))
    zero = denom == 0.0
    safe = torch.where(zero, torch.ones_like(denom), denom)
    frac = 1.0 - after / safe
    frac = torch.where(zero, torch.full_like(frac, -float("inf")), frac)
    total = torch.pow(10.0, frac[..., 0]) + torch.pow(10.0, frac[..., 1])
    score = torch.nan_to_num(20.0 - total, nan=0.0, posinf=18.0,
                             neginf=0.0)
    return torch.clamp(score, 0.0, 18.0)


def scored_rows_reference(feas, used, capacity, denom, ask, penalty,
                          collisions, seed: int, u_offset: int = 0,
                          n_offset: int = 0):
    """Plain PyTorch version of the kernel: ``(scored [U, N], base
    [U, N])``, term for term with the jnp composition."""
    u, n = feas.shape
    fits = (ask[:, None, :] <= (capacity - used)[None, :, :]).all(dim=2)
    ok = (feas != 0) & fits
    base = score_fit(used, ask, denom)
    score = base - penalty.to(torch.float32)[:, None] * collisions.to(
        torch.float32)
    dev = feas.device
    u_idx = torch.arange(u, dtype=torch.int64, device=dev)[:, None] + u_offset
    n_idx = torch.arange(n, dtype=torch.int64, device=dev)[None, :] + n_offset
    score = score + tie_jitter(seed, u_idx, n_idx)
    return torch.where(ok, score, NEG_INF), base


def masked_score_matrix_reference(feas, used, capacity, denom, ask):
    """Plain PyTorch version of the masked score kernel: ``[U, N]`` f32,
    the ScoreFit of every (spec, node) pair that fits, NEG_INF elsewhere
    (pallas_score.py:44-76, term for term with ``_masked_fit_score``)."""
    fits = (ask[:, None, :] <= (capacity - used)[None, :, :]).all(dim=2)
    ok = (feas != 0) & fits
    return torch.where(ok, score_fit(used, ask, denom), NEG_INF)


# (C symbol, argument types) of each kernel library of csrc/.
_C_API = {
    "scored_rows": ("nomad_scored_rows", [ctypes.c_void_p] * 7 + [
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
        ctypes.c_int] + [ctypes.c_void_p] * 3),
    "masked_score": ("nomad_masked_score", [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 2),
    # ops/preempt.py's kernel.
    "eviction_sets": ("nomad_eviction_sets", [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p] * 5),
    # The round kernel: a pointer to its RoundArgs, and the stream.
    "placement_rounds": ("nomad_placement_round", [ctypes.c_void_p] * 2),
}
_FNS = {}


def _fn(name: str):
    """The C entry point of ``csrc/<name>.cu``, built and typed at first
    use."""
    fn = _FNS.get(name)
    if fn is None:
        from .. import device

        symbol, argtypes = _C_API[name]
        fn = getattr(device.load_library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _check(kernel, name, t, dtype, shape, device, align=1):
    if t.device != device:
        raise ValueError(f"{kernel}: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{kernel}: {name} must be {align}-byte aligned")


def _check_node_inputs(kernel, feas, used, capacity, denom, ask):
    """The checks both kernels share; returns ``feas`` as uint8."""
    dev = feas.device
    u, n = feas.shape
    if u > 65535:
        raise ValueError(f"{kernel}: {u} rows exceed the grid's 65535")
    if feas.dtype == torch.bool:
        feas = feas.view(torch.uint8)
    _check(kernel, "feas", feas, torch.uint8, (u, n), dev)
    _check(kernel, "used", used, torch.int32, (n, 4), dev, 16)
    _check(kernel, "capacity", capacity, torch.int32, (n, 4), dev, 16)
    _check(kernel, "denom", denom, torch.float32, (n, 2), dev, 8)
    _check(kernel, "ask", ask, torch.int32, (u, 4), dev, 16)
    return feas


def scored_rows(feas, used, capacity, denom, ask, penalty, collisions,
                seed: int, u_offset: int = 0, n_offset: int = 0,
                with_base: bool = True):
    """The complete per-commit scoring pass: ``(scored [U, N] f32, base
    [U, N] f32)``, or ``(scored, None)`` with ``with_base=False``.

    feas [U, N] bool/uint8 (static feasibility, already ANDed with the
    distinct_hosts mask), used/capacity [N, 4] int32, denom [N, 2] f32,
    ask [U, 4] int32, penalty [U] f32, collisions [U, N] int32, seed a
    uint32 (``kernels.jitter_seed``).  ``u_offset``/``n_offset`` are the
    global indices of row 0 and column 0 the jitter is keyed on.  The
    kernel takes its 16-byte vector path where N % 4 == 0 and the per-cell
    tensors allow it, its scalar path otherwise; both launch here."""
    global LAUNCHES
    from .kernels import note_signature

    dev = feas.device
    note_signature("scored_rows", (dev.type, *feas.shape, with_base))
    if dev.type == "cpu":
        scored, base = scored_rows_reference(
            feas, used, capacity, denom, ask, penalty, collisions, seed,
            u_offset, n_offset)
        return scored, (base if with_base else None)
    if dev.type != "cuda":
        raise ValueError(f"scored_rows: unsupported device {dev}")
    u, n = feas.shape
    feas = _check_node_inputs("scored_rows", feas, used, capacity, denom,
                              ask)
    _check("scored_rows", "penalty", penalty, torch.float32, (u,), dev)
    _check("scored_rows", "collisions", collisions, torch.int32, (u, n), dev)
    fn = _fn("scored_rows")
    out = torch.empty((u, n), dtype=torch.float32, device=dev)
    base = (torch.empty((u, n), dtype=torch.float32, device=dev)
            if with_base else None)
    with torch.cuda.device(dev):    # the launch goes to the tensors' card
        rc = fn(
            feas.data_ptr(), used.data_ptr(), capacity.data_ptr(),
            denom.data_ptr(), ask.data_ptr(), penalty.data_ptr(),
            collisions.data_ptr(), seed & 0xFFFFFFFF, u_offset & 0xFFFFFFFF,
            n_offset & 0xFFFFFFFF, u, n, out.data_ptr(),
            base.data_ptr() if with_base else None,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"scored_rows kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out, base


def masked_score_matrix(feas, used, capacity, denom, ask) -> torch.Tensor:
    """All-pairs masked ScoreFit of one node shard: ``[U, N]`` f32, NEG_INF
    where the spec does not fit or is statically infeasible.

    feas [U, N] bool/uint8 (padding columns False, so they come back
    NEG_INF), used/capacity [N, 4] int32, denom [N, 2] f32, ask [U, 4]
    int32, all on one device."""
    global MASKED_LAUNCHES
    from .kernels import note_signature

    dev = feas.device
    note_signature("masked_score_matrix", (dev.type, *feas.shape))
    if dev.type == "cpu":
        return masked_score_matrix_reference(feas, used, capacity, denom, ask)
    if dev.type != "cuda":
        raise ValueError(f"masked_score_matrix: unsupported device {dev}")
    u, n = feas.shape
    feas = _check_node_inputs("masked_score_matrix", feas, used, capacity,
                              denom, ask)
    fn = _fn("masked_score")
    out = torch.empty((u, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):    # the launch goes to the tensors' card
        rc = fn(feas.data_ptr(), used.data_ptr(), capacity.data_ptr(),
                denom.data_ptr(), ask.data_ptr(), u, n, out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"masked_score_matrix kernel launch failed: cudaError {rc}")
    MASKED_LAUNCHES += 1
    return out


# The round kernel's arguments (csrc/placement_rounds.cu ``RoundArgs``),
# in its field order: the tensors (None: a null pointer), then the
# sizes, every field 8 bytes.
_ROUND_TENSORS = (
    "feas", "used", "cap", "denom", "ask", "count", "remaining", "penalty",
    "dh", "ji", "job_counts", "net_active", "mbits", "dyn_need",
    "resv_words", "bw_cap", "bw_used", "dyn_free", "port_words",
    "dp_active", "dp_col", "dp_used", "attr", "placements", "commit_scores",
    "commit_coll", "slots", "slot_scores", "slot_coll", "key", "flag",
    "dp_best", "dp_first", "status")
_ROUND_SIZES = ("u", "n", "w", "k_attr", "v", "slot_m", "seed")


class _RoundArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in _ROUND_TENSORS]
                + [(f, ctypes.c_int64) for f in _ROUND_SIZES])


def _round_specs(sz: dict) -> dict:
    """name -> (dtype, shape, alignment) of every round-kernel tensor at
    the sizes ``sz`` (u, n, w, k_attr, v, slot_m, and j, the job rows)."""
    u, n, m = sz["u"], sz["n"], sz["slot_m"]
    i32, u8, f32 = torch.int32, torch.uint8, torch.float32
    return {
        "feas": (u8, (u, n), 1), "used": (i32, (n, 4), 16),
        "cap": (i32, (n, 4), 16), "denom": (f32, (n, 2), 8),
        "ask": (i32, (u, 4), 16), "count": (i32, (u,), 4),
        "remaining": (i32, (u,), 4), "penalty": (f32, (u,), 4),
        "dh": (u8, (u,), 1), "ji": (i32, (u,), 4),
        "job_counts": (i32, (sz["j"], n), 4),
        "net_active": (u8, (u,), 1), "mbits": (i32, (u,), 4),
        "dyn_need": (i32, (u,), 4), "resv_words": (i32, (u, sz["w"]), 4),
        "bw_cap": (i32, (n,), 4), "bw_used": (i32, (n,), 4),
        "dyn_free": (i32, (n,), 4), "port_words": (i32, (n, sz["w"]), 4),
        "dp_active": (u8, (u,), 1), "dp_col": (i32, (u,), 4),
        "dp_used": (u8, (u, sz["v"]), 1),
        "attr": (i32, (n, sz["k_attr"]), 4),
        "placements": (i32, (u, n), 4), "commit_scores": (f32, (u, n), 4),
        "commit_coll": (i32, (u, n), 4), "slots": (i32, (u, m), 4),
        "slot_scores": (f32, (u, m), 4), "slot_coll": (i32, (u, m), 4),
        "key": (i32, (n,), 4), "flag": (u8, (n,), 1),
        "dp_best": (i32, (sz["v"],), 4), "dp_first": (i32, (sz["v"],), 4),
        "status": (i32, (4,), 4),
    }


# The groups of round-kernel tensors that come all or none.
_ROUND_GROUPS = {
    "net": ("net_active", "mbits", "dyn_need", "resv_words", "bw_cap",
            "bw_used", "dyn_free", "port_words"),
    "dp": ("dp_active", "dp_col", "dp_used", "attr", "dp_best", "dp_first"),
}


def _round_sizes(t: dict) -> dict:
    """The sizes of the round-kernel tensors ``t``."""
    u, n = t["feas"].shape
    sz = {"u": u, "n": n, "j": t["job_counts"].shape[0], "w": 0,
          "k_attr": 0, "v": 0, "slot_m": 0}
    if t.get("port_words") is not None:
        sz["w"] = t["port_words"].shape[1]
    if t.get("attr") is not None:
        sz["k_attr"], sz["v"] = t["attr"].shape[1], t["dp_used"].shape[1]
    if t.get("slots") is not None:
        sz["slot_m"] = t["slots"].shape[1]
    return sz


def _round_args(t: dict, sz: dict, seed: int) -> _RoundArgs:
    """The ``RoundArgs`` of tensors ``t`` (missing or None: null) at sizes
    ``sz``."""
    args = _RoundArgs()
    for f in _ROUND_TENSORS:
        x = t.get(f)
        setattr(args, f, x.data_ptr() if x is not None else None)
    for f in _ROUND_SIZES[:-1]:
        setattr(args, f, int(sz[f]))
    args.seed = seed & 0xFFFFFFFF
    return args


def placement_round(t: dict, seed: int) -> torch.Tensor:
    """One launch of the round kernel (``csrc/placement_rounds.cu``): one
    round of the placement loop over the loop state ``t``, committed in
    place; returns ``t["status"]``, the round's int32 ``[placed, asks
    left, any node fits the smallest ask left, committing steps]``, still
    on the card.

    ``t`` maps the kernel's tensor names (``_ROUND_TENSORS``) to CUDA
    tensors of one card, contiguous, of the dtypes and shapes of
    :func:`_round_specs`; the network group, the distinct_property group,
    the matrix outputs (without ``slots``) or the slot outputs, and the
    score outputs may be left out.  Raises on anything else, and
    ``RuntimeError`` when the launch fails.  There is no CPU route: the
    plain version is ``kernels.placement_rounds``, the eager loop."""
    global ROUND_LAUNCHES
    feas = t["feas"]
    dev = feas.device
    if dev.type != "cuda":
        raise ValueError(f"placement_round: unsupported device {dev}")
    sz = _round_sizes(t)
    u, n = sz["u"], sz["n"]
    if n >= 1 << 31:
        raise ValueError(f"placement_round: {n} nodes exceed int32")
    if sz["w"] > ROUND_MAX_PORT_WORDS:
        raise ValueError(f"placement_round: {sz['w']} port words, at most "
                         f"{ROUND_MAX_PORT_WORDS}")
    specs = _round_specs(sz)
    required = ["feas", "used", "cap", "denom", "ask", "count", "remaining",
                "penalty", "dh", "ji", "job_counts", "key", "flag",
                "status"]
    required += ["slots"] if sz["slot_m"] else ["placements"]
    for group, names in _ROUND_GROUPS.items():
        given = [f for f in names if t.get(f) is not None]
        if given and len(given) != len(names):
            raise ValueError(f"placement_round: the {group} tensors come "
                             f"all or none, got {given}")
    for f in _ROUND_TENSORS:
        x = t.get(f)
        if x is None:
            if f in required:
                raise ValueError(f"placement_round: {f} is required")
            continue
        dtype, shape, align = specs[f]
        _check("placement_round", f, x, dtype, shape, dev, align)
    scores = [t.get(f) is not None for f in (
        ("slot_scores", "slot_coll") if sz["slot_m"]
        else ("commit_scores", "commit_coll"))]
    if scores[0] != scores[1]:
        raise ValueError("placement_round: the score outputs come in pairs")
    from .kernels import note_signature

    note_signature("placement_round", (
        u, n, sz["j"], sz["w"], sz["k_attr"], sz["v"], sz["slot_m"],
        scores[0]))
    fn = _fn("placement_rounds")
    args = _round_args(t, sz, seed)
    with torch.cuda.device(dev):    # the launch goes to the tensors' card
        rc = fn(ctypes.addressof(args),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"placement_round kernel launch failed: cudaError {rc}")
    ROUND_LAUNCHES += 1
    return t["status"]
