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
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

NEG_INF = -1e30
_U32 = 0xFFFFFFFF
# float32(1e-3 / 2^24): the jitter's scale, rounded once from the double.
_JITTER_SCALE = np.float32(1e-3 / (1 << 24))

# Kernel launches made by scored_rows and by masked_score_matrix (the
# plain versions count nothing).
LAUNCHES = 0
MASKED_LAUNCHES = 0


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
    dev = feas.device
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
    dev = feas.device
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
