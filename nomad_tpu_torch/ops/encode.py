"""Tensor encoding: lowers the scheduler-visible state into the numpy
arrays the device pass reads (``nomad_tpu/ops/encode.py``).

The subset of the batch-placement slice: the object walk over nodes, the
ordered attribute codebooks, live-alloc usage, and the spec lowering of
drivers and vectorizable constraints.  Quantized rows, networks,
distinct_property and the columnar store path are not in this slice; a
spec that needs them never reaches this module (``ops/batch_sched.py``
rejects it).

Ordered interning: each attribute target gets its own codebook whose
codes are assigned in sorted-value order, so lexical <, <=, >, >= lower
to integer compares on the device.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..scheduler.feasible import parse_bool, resolve_constraint_target
from ..scheduler.util import task_group_constraints
from ..structs import structs as s

# Constraint op codes on the device (order matters: see ops/kernels.py).
OP_TRUE = 0       # padding / pass-through
OP_EQ = 1
OP_NE = 2
OP_LT = 3
OP_LE = 4
OP_GT = 5
OP_GE = 6
OP_PRECOMP = 7    # gather from the host-precomputed boolean row

# Sentinel for "value missing on node": any comparison with it fails.
MISSING = np.int32(-1)
# Sentinel rhs for "literal not representable": EQ always false, NE true.
UNKNOWN_RHS = np.int32(-2)

RES_DIMS = 4  # cpu, memory_mb, disk_mb, iops — structs.Resources.TENSOR_DIMS


def _res_vec(r: Optional[s.Resources]) -> np.ndarray:
    if r is None:
        return np.zeros(RES_DIMS, dtype=np.int64)
    return np.array([r.cpu, r.memory_mb, r.disk_mb, r.iops], dtype=np.int64)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pow2_bucket(x: int, minimum: int = 8) -> int:
    """Next power of two >= x (>= minimum): batch axes are bucketed so
    differently-sized batches share a handful of shapes."""
    v = minimum
    while v < x:
        v <<= 1
    return v


def shape_plan(u_pad: int, n_pad: int, n_real: int, max_count: int,
               total_asks: int, *, mesh: bool = False,
               slot_budget_bytes: int = 64 << 20
               ) -> Tuple[bool, int, int]:
    """The shape-class plan of a placement dispatch, shared by the
    single-chip and mesh paths: ``(with_scores, slot_m, max_nnz)``.

    - ``with_scores``: commit-score side outputs while U x N stays under
      ~16M cells (N taken at the single-chip 128-multiple of ``n_real``,
      so a mesh's lcm(128, D) pad never drops scores the single-chip
      path carries).
    - ``slot_m``: minor axis of the commit-ordered slot record (pow2 of
      the largest count), or 0 when the record would exceed
      ``slot_budget_bytes`` -- the single-chip path then uses matrix
      mode, the mesh the single-chip path.  The single-chip path also
      uses matrix mode past 65536 node rows; the mesh always needs
      slots.
    - ``max_nnz``: COO capacity (per-alloc entries in slot mode,
      per-(spec, node) aggregates in matrix mode).
    """
    n_pad_ref = max(128, round_up(n_real, 128))
    with_scores = u_pad * n_pad_ref <= 16_000_000
    slot_m = 0
    if mesh or n_pad <= 65536:
        m_b = pow2_bucket(max(8, max_count), minimum=8)
        slot_bytes = 4 + (8 if with_scores else 0)
        if u_pad * m_b * slot_bytes <= slot_budget_bytes:
            slot_m = m_b
    max_nnz = pow2_bucket(
        max(8, total_asks if slot_m
            else min(total_asks, u_pad * n_pad)), minimum=8)
    return with_scores, slot_m, max_nnz


@dataclass
class ClusterTensors:
    """Host view of the node fleet, padded to ``n_pad`` (a multiple of
    128); padding rows are ineligible."""

    node_ids: List[str]                 # dense index → node id
    n_real: int
    n_pad: int
    capacity: np.ndarray                # [n_pad, 4] int64 — node.resources
    used: np.ndarray                    # [n_pad, 4] int64 — reserved + live allocs
    score_denom: np.ndarray             # [n_pad, 2] float32 — (cpu, mem) minus reserved
    eligible: np.ndarray                # [n_pad] bool — ready & not draining
    dc_code: np.ndarray                 # [n_pad] int32
    class_code: np.ndarray              # [n_pad] int32
    attr_values: np.ndarray             # [n_pad, n_attrs] int32 ordered codes
    attr_index: Dict[str, int]          # target string → column
    dc_codebook: Dict[str, int]
    value_codebooks: Dict[str, Dict[str, int]]
    # Per-node resolved attribute strings and the value sets they came
    # from; finalize_codebooks turns them into attr_values codes.
    raw_rows: List[Dict[str, Optional[str]]] = field(default_factory=list)
    value_sets: Dict[str, Set[str]] = field(default_factory=dict)
    class_codebook: Dict[str, int] = field(default_factory=dict)
    node_index: Dict[str, int] = field(default_factory=dict)


def encode_cluster_static(nodes: Sequence[s.Node],
                          attr_targets: Sequence[str],
                          node_pad_multiple: int = 128) -> ClusterTensors:
    """The alloc-independent cluster tensors: capacity, reserved-only
    usage, eligibility, dc/class codes and the attribute columns (codes
    are assigned by :func:`finalize_codebooks`)."""
    n_real = len(nodes)
    n_pad = max(node_pad_multiple, round_up(n_real, node_pad_multiple))

    capacity = np.zeros((n_pad, RES_DIMS), dtype=np.int64)
    used = np.zeros((n_pad, RES_DIMS), dtype=np.int64)
    score_denom = np.ones((n_pad, 2), dtype=np.float32)
    eligible = np.zeros(n_pad, dtype=bool)
    dc_code = np.full(n_pad, MISSING, dtype=np.int32)
    class_code = np.full(n_pad, MISSING, dtype=np.int32)
    dc_codebook: Dict[str, int] = {}
    class_codebook: Dict[str, int] = {}
    node_ids: List[str] = []

    for i, node in enumerate(nodes):
        node_ids.append(node.id)
        capacity[i] = _res_vec(node.resources)
        reserved = _res_vec(node.reserved)
        used[i] = reserved
        score_denom[i] = (float(capacity[i][0] - reserved[0]),
                          float(capacity[i][1] - reserved[1]))
        eligible[i] = node.ready()
        dc_code[i] = dc_codebook.setdefault(node.datacenter, len(dc_codebook))
        class_code[i] = class_codebook.setdefault(node.computed_class,
                                                  len(class_codebook))

    value_sets: Dict[str, Set[str]] = {t: set() for t in attr_targets}
    if attr_targets:
        raw_rows: List[Dict[str, Optional[str]]] = []
        for node in nodes:
            row: Dict[str, Optional[str]] = {}
            for t in attr_targets:
                val, ok = resolve_constraint_target(t, node)
                if ok and isinstance(val, str):
                    row[t] = val
                    value_sets[t].add(val)
                else:
                    row[t] = None
            raw_rows.append(row)
    else:
        raw_rows = [{}] * len(nodes)

    return ClusterTensors(
        node_ids=node_ids, n_real=n_real, n_pad=n_pad, capacity=capacity,
        used=used, score_denom=score_denom, eligible=eligible,
        dc_code=dc_code, class_code=class_code,
        attr_values=np.full((n_pad, max(1, len(attr_targets))), MISSING,
                            dtype=np.int32),
        attr_index={t: j for j, t in enumerate(attr_targets)},
        dc_codebook=dc_codebook,
        value_codebooks={t: {} for t in attr_targets},
        raw_rows=raw_rows, value_sets=value_sets,
        class_codebook=class_codebook,
        node_index={nid: i for i, nid in enumerate(node_ids)})


def alloc_usage(alloc: s.Allocation) -> np.ndarray:
    """One alloc's [4] usage: combined ``resources`` when present,
    ``shared_resources`` plus per-task resources otherwise."""
    if alloc.resources is not None:
        return _res_vec(alloc.resources)
    vec = _res_vec(alloc.shared_resources)
    for tr in alloc.task_resources.values():
        vec = vec + _res_vec(tr)
    return vec


def apply_alloc_usage(ct: ClusterTensors,
                      allocs_by_node: Dict[str, List[s.Allocation]]
                      ) -> ClusterTensors:
    """Layer live-allocation usage onto a copy of the static tensors (the
    static part is never mutated)."""
    used = ct.used.copy()
    for nid, allocs in allocs_by_node.items():
        i = ct.node_index.get(nid)
        if i is None:
            continue
        for alloc in allocs:
            used[i] += alloc_usage(alloc)
    return replace(ct, used=used)


def with_usage(ct: ClusterTensors, used: np.ndarray) -> ClusterTensors:
    """Clone the static tensors with a caller-provided usage matrix."""
    return replace(ct, used=used)


def finalize_codebooks(ct: ClusterTensors,
                       literals: Dict[str, Set[str]]) -> None:
    """Merge constraint literals into the per-target value sets, assign
    ordered codes, and fill the attr matrix."""
    for target, vals in literals.items():
        if target in ct.value_sets:
            ct.value_sets[target].update(vals)
    for target, vals in ct.value_sets.items():
        ct.value_codebooks[target] = {v: i for i, v in enumerate(sorted(vals))}
    for i, row in enumerate(ct.raw_rows):
        for target, j in ct.attr_index.items():
            val = row[target]
            if val is not None:
                ct.attr_values[i, j] = ct.value_codebooks[target][val]


# Operand → op code for the vectorizable subset (feasible.go:433-458).
_VECTOR_OPS = {
    "=": OP_EQ, "==": OP_EQ, "is": OP_EQ,
    "!=": OP_NE, "not": OP_NE,
    "<": OP_LT, "<=": OP_LE, ">": OP_GT, ">=": OP_GE,
}


@dataclass
class PlacementSpec:
    """One unique (job, task group) placement spec with its expansion
    count: the reference's materializeTaskGroups dedup (util.go:22)
    turned into the batch axis."""

    job: s.Job
    tg: s.TaskGroup
    count: int = 0
    ask: np.ndarray = None              # [4] int64
    priority: int = 50
    anti_affinity_penalty: float = 20.0
    distinct_hosts: bool = False
    drivers: Set[str] = field(default_factory=set)
    constraints: List[s.Constraint] = field(default_factory=list)
    datacenters: List[str] = field(default_factory=list)
    # Non-empty → this spec needs a part of the scheduler that is not in
    # this slice (ops/batch_sched.py raises NotImplementedError).
    unsupported: str = ""


def build_spec(job: s.Job, tg: s.TaskGroup,
               batch_penalty: bool) -> PlacementSpec:
    tup = task_group_constraints(tg)
    all_constraints = list(job.constraints) + list(tup.constraints)
    spec = PlacementSpec(
        job=job, tg=tg, count=0, ask=_res_vec(tup.size),
        priority=job.priority,
        anti_affinity_penalty=10.0 if batch_penalty else 20.0,
        distinct_hosts=any(c.operand == s.CONSTRAINT_DISTINCT_HOSTS
                           for c in all_constraints),
        drivers=tup.drivers, constraints=all_constraints,
        datacenters=list(job.datacenters))
    if any(t.resources is not None and t.resources.networks
           for t in tg.tasks):
        spec.unsupported = "network asks (the network slice)"
    elif any(c.operand == s.CONSTRAINT_DISTINCT_PROPERTY
             for c in all_constraints):
        spec.unsupported = "distinct_property (the distinct_property slice)"
    else:
        for con in all_constraints:
            if con.operand == s.CONSTRAINT_DISTINCT_HOSTS:
                continue
            if (con.operand not in _VECTOR_OPS
                    or con.rtarget.startswith("${")):
                spec.unsupported = (
                    f"host-precomputed constraint {con} (the constraint "
                    "precompute slice)")
                break
    return spec


@dataclass
class SpecTensors:
    """Host view of the unique placement specs, padded to ``u_pad``."""

    specs: List[PlacementSpec]
    u_real: int
    u_pad: int
    ask: np.ndarray              # [u_pad, 4] int64
    count: np.ndarray            # [u_pad] int32
    priority: np.ndarray         # [u_pad] int32
    penalty: np.ndarray          # [u_pad] float32
    distinct_hosts: np.ndarray   # [u_pad] bool
    dc_mask: np.ndarray          # [u_pad, n_dcs] bool
    constraint_attr: np.ndarray  # [u_pad, k_max] int32 column index
    constraint_op: np.ndarray    # [u_pad, k_max] int32 op code
    constraint_rhs: np.ndarray   # [u_pad, k_max] int32 rhs code
    precomp: np.ndarray          # [u_pad, n_pad] or [1, 1] bool
    job_index: np.ndarray        # [u_pad] int32 — same-job specs share a row
    job_ids: List[str]


def encode_specs(specs: List[PlacementSpec], ct: ClusterTensors,
                 nodes: Sequence[s.Node],
                 spec_pad_multiple: int = 8) -> SpecTensors:
    """Lower specs to arrays: drivers and vectorizable constraints become
    (column, op, rhs-code) triples; a driver whose truthy values do not
    reduce to one code becomes a host-computed boolean row."""
    u_real = len(specs)
    u_pad = pow2_bucket(u_real, spec_pad_multiple)
    k_max = pow2_bucket(
        max([1] + [len(sp.constraints) + len(sp.drivers) for sp in specs]),
        minimum=2)

    ask = np.zeros((u_pad, RES_DIMS), dtype=np.int64)
    count = np.zeros(u_pad, dtype=np.int32)
    priority = np.zeros(u_pad, dtype=np.int32)
    penalty = np.zeros(u_pad, dtype=np.float32)
    distinct = np.zeros(u_pad, dtype=bool)
    n_dcs = pow2_bucket(max(1, len(ct.dc_codebook)), minimum=2)
    dc_mask = np.zeros((u_pad, n_dcs), dtype=bool)
    c_attr = np.zeros((u_pad, k_max), dtype=np.int32)
    c_op = np.zeros((u_pad, k_max), dtype=np.int32)   # OP_TRUE padding
    c_rhs = np.zeros((u_pad, k_max), dtype=np.int32)
    # Materialized only when some spec needs a host row; otherwise a
    # trivially-true [1, 1] that the device broadcasts (saves a U x N
    # upload).
    precomp = None
    job_row: Dict[str, int] = {}
    job_index = np.zeros(u_pad, dtype=np.int32)

    for u, sp in enumerate(specs):
        if sp.unsupported:
            raise NotImplementedError(sp.unsupported)
        ask[u] = sp.ask
        count[u] = sp.count
        priority[u] = sp.priority
        penalty[u] = sp.anti_affinity_penalty
        distinct[u] = sp.distinct_hosts
        for dc in sp.datacenters:
            code = ct.dc_codebook.get(dc)
            if code is not None:
                dc_mask[u, code] = True
        job_index[u] = job_row.setdefault(sp.job.id, len(job_row))

        k = 0
        for driver in sorted(sp.drivers):
            target = "${attr.driver." + driver + "}"
            col = ct.attr_index.get(target)
            truthy = set() if col is None else {
                code for val, code in ct.value_codebooks[target].items()
                if parse_bool(val)}
            if len(truthy) == 1:
                c_attr[u, k] = col
                c_op[u, k] = OP_EQ
                c_rhs[u, k] = next(iter(truthy))
                k += 1
            else:
                if precomp is None:
                    precomp = np.ones((u_pad, ct.n_pad), dtype=bool)
                precomp[u, :ct.n_real] &= _driver_row(nodes, driver)

        for con in sp.constraints:
            if con.operand == s.CONSTRAINT_DISTINCT_HOSTS:
                continue
            col = ct.attr_index[con.ltarget]
            code = ct.value_codebooks[con.ltarget].get(con.rtarget, None)
            c_attr[u, k] = col
            c_op[u, k] = _VECTOR_OPS[con.operand]
            c_rhs[u, k] = UNKNOWN_RHS if code is None else code
            k += 1

    return SpecTensors(
        specs=specs, u_real=u_real, u_pad=u_pad, ask=ask, count=count,
        priority=priority, penalty=penalty, distinct_hosts=distinct,
        dc_mask=dc_mask, constraint_attr=c_attr, constraint_op=c_op,
        constraint_rhs=c_rhs,
        precomp=(precomp if precomp is not None
                 else np.ones((1, 1), dtype=bool)),
        job_index=job_index, job_ids=list(job_row))


def _driver_row(nodes: Sequence[s.Node], driver: str) -> np.ndarray:
    out = np.zeros(len(nodes), dtype=bool)
    key = f"driver.{driver}"
    for i, node in enumerate(nodes):
        val = node.attributes.get(key)
        out[i] = bool(val is not None and parse_bool(val))
    return out


def collect_attr_targets(specs: List[PlacementSpec]
                         ) -> Tuple[List[str], Dict[str, Set[str]]]:
    """The constraint LTargets that lower to int compares, plus the
    literal RHS values to merge into each codebook."""
    targets: List[str] = []
    literals: Dict[str, Set[str]] = {}
    seen: Set[str] = set()
    for sp in specs:
        for driver in sp.drivers:
            t = "${attr.driver." + driver + "}"
            if t not in seen:
                seen.add(t)
                targets.append(t)
                literals.setdefault(t, set())
        for con in sp.constraints:
            if con.operand not in _VECTOR_OPS:
                continue
            if con.rtarget.startswith("${"):
                continue
            if con.ltarget not in seen:
                seen.add(con.ltarget)
                targets.append(con.ltarget)
            literals.setdefault(con.ltarget, set()).add(con.rtarget)
    return targets, literals
