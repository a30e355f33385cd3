"""Host half of the single result fetch (``nomad_tpu/ops/decode.py``):
two integer passes over the fetched COO placement payload.

- :func:`expand_coo`: per-alloc node-index runs per spec;
- :func:`last_scores`: per-spec last-commit (col, score, collisions)
  entries (slot-mode COO carries one entry per alloc, so a node committed
  in several rounds appears several times; the AllocMetric keeps the
  last commit's score).

Both run in C (``native/decode.cc``, built with ``g++`` at first use; a
build that fails raises) beside numpy twins, :func:`_expand_twin` and
:func:`_last_scores_twin` (the reference's, ``nomad_tpu/ops/decode.py:
138-259``; the last-scores twin without its Python loop).  The twin is a
route the caller asks for (``native=False`` here,
``TorchBatchScheduler(native_decode=False)`` and
``schedule_batch(native_decode=False)`` above), never a silent fallback.

Differential guard: every ``guard_every``-th native call of each function
(counted per function, as the reference does: expand and last-scores run
once each a batch, so a shared counter would only ever verify one of
them; 0 turns it off) runs the twin too and compares bit for bit.  A
mismatch is counted (:data:`GUARD_MISMATCHES`), logged and traced, and
raises :class:`DecodeGuardError`: the batch's placements are not used and
the batch is nacked, as a raw error is (ROADMAP queue 3 item 8(a)).  The
reference instead turns its native path off, feeds the kernel breaker
and carries on with the twin's output; the port keeps the codec's
precedent (queue 3 item 15(a)): a host fault never moves the card's
scheduling onto the CPU.  A payload the native pass refuses (a spec row
out of range or out of order) raises the same error.
"""
from __future__ import annotations

import ctypes
import logging
from typing import Tuple

import numpy as np

from ..utils import tracing

logger = logging.getLogger("nomad_tpu_torch.ops.decode")

#: The guard's default cadence (the reference's
#: NOMAD_TPU_DECODE_GUARD_EVERY default).
GUARD_EVERY = 64

# Module counters (the drills, the tests and chip_smoke.py read them).
# NATIVE_CALLS sums both functions; EXPAND_CALLS and LAST_CALLS drive the
# guard cadence of each.
NATIVE_CALLS = 0
EXPAND_CALLS = 0
LAST_CALLS = 0
TWIN_CALLS = 0
GUARD_RUNS = 0
GUARD_MISMATCHES = 0

_LIB = None


class DecodeGuardError(RuntimeError):
    """The native decode disagreed with its twin, or refused the payload."""


def reset_counters() -> None:
    global NATIVE_CALLS, EXPAND_CALLS, LAST_CALLS, TWIN_CALLS
    global GUARD_RUNS, GUARD_MISMATCHES
    NATIVE_CALLS = EXPAND_CALLS = LAST_CALLS = TWIN_CALLS = 0
    GUARD_RUNS = GUARD_MISMATCHES = 0


def _lib():
    """decode.cc, built and typed at first use (raises when it cannot be
    built)."""
    global _LIB
    if _LIB is None:
        from ..native import load

        lib = load("nomaddecode", "decode.cc")
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        c_i64p = ctypes.POINTER(ctypes.c_longlong)
        c_f32p = ctypes.POINTER(ctypes.c_float)
        lib.ndec_expand.restype = ctypes.c_longlong
        lib.ndec_expand.argtypes = [
            c_i32p, c_i32p, c_i32p, ctypes.c_longlong, ctypes.c_int32,
            ctypes.c_int32, c_i64p, c_i32p, ctypes.c_longlong]
        lib.ndec_last_scores.restype = ctypes.c_longlong
        lib.ndec_last_scores.argtypes = [
            c_i32p, c_i32p, c_f32p, c_i32p, ctypes.c_longlong,
            ctypes.c_int32, ctypes.c_int32, c_i32p, c_i64p, c_i64p,
            c_i32p, c_f32p, c_i32p]
        _LIB = lib
    return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _mismatch(what: str) -> DecodeGuardError:
    """Count, log and trace a guard mismatch; returns the error to
    raise."""
    global GUARD_MISMATCHES
    GUARD_MISMATCHES += 1
    logger.error("native decode %s diverged from the numpy twin", what)
    tracing.event("decode.guard_mismatch", what=what)
    return DecodeGuardError(f"native decode {what} diverged from the "
                            f"numpy twin")


def _guard_due(calls: int, guard_every: int) -> bool:
    global GUARD_RUNS
    if guard_every <= 0 or calls % guard_every:
        return False
    GUARD_RUNS += 1
    return True


# -- expand -----------------------------------------------------------------


def _expand_twin(rows: np.ndarray, cols: np.ndarray, counts: np.ndarray,
                 n_specs: int, n_real: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy reference: (off [n_specs+1] int64, expanded int32)."""
    valid = (rows >= 0) & (cols < n_real)
    vr, vc = rows[valid], cols[valid]
    vcnt = counts[valid]
    expanded = np.repeat(vc, vcnt).astype(np.int32, copy=False)
    per_spec = np.zeros(n_specs + 1, dtype=np.int64)
    np.add.at(per_spec, vr.astype(np.int64) + 1, vcnt.astype(np.int64))
    return np.cumsum(per_spec), expanded


def expand_coo(rows: np.ndarray, cols: np.ndarray, counts: np.ndarray,
               n_specs: int, n_real: int, native: bool = True,
               guard_every: int = GUARD_EVERY
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns ``(off, expanded)``: spec u's placements are
    ``expanded[off[u]:off[u+1]]`` (int32 node indexes, entry order).
    ``native=False`` runs the numpy twin instead."""
    global NATIVE_CALLS, EXPAND_CALLS, TWIN_CALLS
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    if not native:
        TWIN_CALLS += 1
        return _expand_twin(rows, cols, counts, n_specs, n_real)
    lib = _lib()
    # Every positive count fits: the native pass can only refuse a spec
    # row out of range.
    cap = max(1, int(counts.clip(min=0).sum(dtype=np.int64)))
    off = np.zeros(n_specs + 1, dtype=np.int64)
    out = np.empty(cap, dtype=np.int32)
    got = lib.ndec_expand(_ptr(rows, ctypes.c_int32),
                          _ptr(cols, ctypes.c_int32),
                          _ptr(counts, ctypes.c_int32), len(rows), n_specs,
                          n_real, _ptr(off, ctypes.c_longlong),
                          _ptr(out, ctypes.c_int32), cap)
    if got < 0:
        raise DecodeGuardError("native decode expand refused the payload: "
                               "a spec row out of range")
    NATIVE_CALLS += 1
    EXPAND_CALLS += 1
    out = out[:got]
    if _guard_due(EXPAND_CALLS, guard_every):
        ref_off, ref_out = _expand_twin(rows, cols, counts, n_specs,
                                        n_real)
        if not (np.array_equal(ref_off, off)
                and np.array_equal(ref_out, out)):
            raise _mismatch("expand")
    return off, out


# -- last-commit scores -----------------------------------------------------


def _last_scores_twin(rows: np.ndarray, cols: np.ndarray,
                      scores: np.ndarray, coll: np.ndarray,
                      n_specs: int, n_real: int):
    """Numpy reference: one entry per distinct (spec, col) in
    first-occurrence order, carrying the last occurrence's values (the
    reference's per-spec dicts, ``nomad_tpu/ops/decode.py:199``, without
    the Python loop)."""
    valid = (rows >= 0) & (cols < n_real)
    vr = rows[valid].astype(np.int64)
    vc = cols[valid].astype(np.int64)
    vsc = np.asarray(scores, dtype=np.float32)[valid]
    vco = np.asarray(coll, dtype=np.int32)[valid]
    key = vr * max(1, n_real) + vc
    _, first = np.unique(key, return_index=True)
    _, last_rev = np.unique(key[::-1], return_index=True)
    last = len(key) - 1 - last_rev      # same sorted-key order as first
    order = np.argsort(first, kind="stable")
    first, last = first[order], last[order]
    off = np.zeros(n_specs + 1, dtype=np.int64)
    np.add.at(off, vr[first] + 1, 1)
    return (np.cumsum(off), vc[first].astype(np.int32),
            vsc[last], vco[last])


def last_scores(rows: np.ndarray, cols: np.ndarray, scores: np.ndarray,
                coll: np.ndarray, n_specs: int, n_real: int,
                native: bool = True, guard_every: int = GUARD_EVERY):
    """Returns ``(off, col, score, coll)``: spec u's entries are the
    ``[off[u]:off[u+1]]`` slices, one per distinct committed node, in
    first-occurrence order, carrying the last commit's values.  Rows
    arrive ascending by spec.  ``native=False`` runs the twin instead."""
    global NATIVE_CALLS, LAST_CALLS, TWIN_CALLS
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    coll = np.ascontiguousarray(coll, dtype=np.int32)
    if not native:
        TWIN_CALLS += 1
        return _last_scores_twin(rows, cols, scores, coll, n_specs, n_real)
    lib = _lib()
    n = len(rows)
    stamp = np.full(max(1, n_real), -1, dtype=np.int32)
    pos = np.empty(max(1, n_real), dtype=np.int64)
    off = np.zeros(n_specs + 1, dtype=np.int64)
    out_col = np.empty(max(1, n), dtype=np.int32)
    out_sc = np.empty(max(1, n), dtype=np.float32)
    out_co = np.empty(max(1, n), dtype=np.int32)
    got = lib.ndec_last_scores(
        _ptr(rows, ctypes.c_int32), _ptr(cols, ctypes.c_int32),
        _ptr(scores, ctypes.c_float), _ptr(coll, ctypes.c_int32), n,
        n_specs, n_real, _ptr(stamp, ctypes.c_int32),
        _ptr(pos, ctypes.c_longlong), _ptr(off, ctypes.c_longlong),
        _ptr(out_col, ctypes.c_int32), _ptr(out_sc, ctypes.c_float),
        _ptr(out_co, ctypes.c_int32))
    if got < 0:
        raise DecodeGuardError("native decode last_scores refused the "
                               "payload: spec rows out of order or range")
    NATIVE_CALLS += 1
    LAST_CALLS += 1
    result = (off, out_col[:got], out_sc[:got], out_co[:got])
    if _guard_due(LAST_CALLS, guard_every):
        ref = _last_scores_twin(rows, cols, scores, coll, n_specs, n_real)
        if not all(np.array_equal(a, b) for a, b in zip(ref, result)):
            raise _mismatch("last_scores")
    return result
