"""Host half of the single result fetch (``nomad_tpu/ops/decode.py``):
two integer passes over the fetched COO placement payload.

- :func:`expand_coo`: per-alloc node-index runs per spec;
- :func:`last_scores`: per-spec last-commit (col, score, collisions)
  entries (slot-mode COO carries one entry per alloc, so a node committed
  in several rounds appears several times; the AllocMetric keeps the
  last commit's score).

Both are numpy; the reference's native C++ twin is not copied.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def expand_coo(rows: np.ndarray, cols: np.ndarray, counts: np.ndarray,
               n_specs: int, n_real: int) -> Tuple[np.ndarray, np.ndarray]:
    """Returns ``(off, expanded)``: spec u's placements are
    ``expanded[off[u]:off[u+1]]`` (int32 node indexes, entry order)."""
    valid = (rows >= 0) & (cols < n_real)
    vr, vc = rows[valid], cols[valid]
    vcnt = counts[valid]
    expanded = np.repeat(vc, vcnt).astype(np.int32, copy=False)
    per_spec = np.zeros(n_specs + 1, dtype=np.int64)
    np.add.at(per_spec, vr.astype(np.int64) + 1, vcnt.astype(np.int64))
    return np.cumsum(per_spec), expanded


def last_scores(rows: np.ndarray, cols: np.ndarray, scores: np.ndarray,
                coll: np.ndarray, n_specs: int, n_real: int):
    """Returns ``(off, col, score, coll)``: spec u's entries are the
    ``[off[u]:off[u+1]]`` slices, one per distinct committed node, in
    first-occurrence order, carrying the last commit's values.  Rows
    arrive ascending by spec."""
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
