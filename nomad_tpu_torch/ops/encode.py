"""Tensor encoding: lowers the scheduler-visible state into the numpy
arrays the device pass reads (``nomad_tpu/ops/encode.py``).

The object walk over nodes, the ordered attribute codebooks, live-alloc
usage, the exact quantized resource rows, the network accounting (port
bitmaps, bandwidth and free dynamic ports, built only when the batch asks
for networks), distinct_property columns, and the spec lowering of
drivers and constraints: vectorizable ones become integer compares, the
rest become host-evaluated boolean rows cached per computed class.  The static
tensors are sliced from the state store's columnar mirror where it has
one (:func:`build_cluster_static`), with the walk as its guard.

Ordered interning: each attribute target gets its own codebook whose
codes are assigned in sorted-value order, so lexical <, <=, >, >= lower
to integer compares on the device.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .. import fault
from ..scheduler.context import EvalContext
from ..scheduler.feasible import (check_constraint, parse_bool,
                                  resolve_constraint_target)
from ..scheduler.util import task_group_constraints
from ..state import columnar
from ..structs import structs as s
from ..structs.network import MAX_DYNAMIC_PORT, MAX_VALID_PORT, MIN_DYNAMIC_PORT

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

# Port geometry comes from the host NetworkIndex (structs/network.py): the
# device's port accounting and the host's concrete port pick at finalize
# must agree exactly.
PORT_WORDS = MAX_VALID_PORT // 32          # 32-bit words per node bitmap


# -- quantized resource rows ------------------------------------------------
#
# The static upload carries two [n_pad, 4] int32 resource matrices
# (capacity and the reserved-only usage baseline).  They ship as int16,
# or int8 where ranges allow, with a per-matrix, per-dimension
# power-of-two scale codebook ([2, 4]: row 0 capacity, row 1 used).  The
# scheme is exact or absent: every value must divide by its scale and the
# scaled value fit the narrow type, else the pair ships as int32, so the
# placements stay bit-identical.  The device dequantizes with one integer
# multiply (ops/kernels.fused_pass).


@dataclass
class QuantizedRows:
    """Exactly-quantized (capacity, used-baseline) rows and their scale
    codebook; ``cap_q``/``used_q`` are int16 or int8 each."""

    cap_q: np.ndarray      # [n_pad, 4] int16/int8
    used_q: np.ndarray     # [n_pad, 4] int16/int8
    scale: np.ndarray      # [2, 4] int32 — power of two per matrix/dim


def _quant_one(mat: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Per-dimension exact power-of-two scales for ONE [n, 4] matrix,
    pushed into the int8 range where divisibility allows, int16
    otherwise; None when even the int16 range cannot be exact."""
    scale = np.ones(RES_DIMS, dtype=np.int64)
    for d in range(RES_DIMS):
        col = mat[:, d]
        m = int(col.max(initial=0))
        s16 = 1
        while m // s16 > np.iinfo(np.int16).max:
            s16 <<= 1
        s8 = s16
        while m // s8 > np.iinfo(np.int8).max:
            s8 <<= 1
        if s8 == 1 or not (col % s8).any():
            scale[d] = s8
        elif s16 == 1 or not (col % s16).any():
            scale[d] = s16
        else:
            return None
    return mat // scale, scale


def quantize_resource_rows(capacity: np.ndarray,
                           used: np.ndarray) -> Optional[QuantizedRows]:
    """The narrowest exact integer form of the [n, 4] capacity and used
    matrices (``encode.py:128``), or None when either cannot be exact.
    Scales and types are chosen per matrix."""
    cap = np.asarray(capacity, dtype=np.int64)
    use = np.asarray(used, dtype=np.int64)
    if (cap < 0).any() or (use < 0).any():
        return None
    qc = _quant_one(cap)
    qu = _quant_one(use)
    if qc is None or qu is None:
        return None

    def narrow(m):
        return (np.int8 if m.max(initial=0) <= np.iinfo(np.int8).max
                else np.int16)

    (cap_s, cap_scale), (use_s, use_scale) = qc, qu
    return QuantizedRows(
        cap_q=cap_s.astype(narrow(cap_s)), used_q=use_s.astype(narrow(use_s)),
        scale=np.stack([cap_scale, use_scale]).astype(np.int32))


def dequantize_rows(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Host inverse of one quantized matrix (its own [4] scale row); the
    device twin is the multiply in ``ops/kernels.fused_pass``."""
    return q.astype(np.int64) * np.asarray(scale, dtype=np.int64)


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


def route_shard_deltas(dev_rows, shards: int, n_local: int,
                       dims: int = RES_DIMS):
    """A run of global ``(row, vals)`` usage deltas split per shard of a
    node mesh (encode.py:192), in one pass over the changed rows:
    ``rows [D, k_b] int32`` of shard-local rows (-1 padding) and
    ``vals [D, k_b, dims] int32``, ``k_b`` the pow2 bucket of the
    longest shard run.  ``ops/resident.py`` applies each shard's valid
    rows to that shard's part of the mirror."""
    per_rows = [[] for _ in range(shards)]
    per_vals = [[] for _ in range(shards)]
    for i, vec in dev_rows:
        s_i = i // n_local
        if 0 <= s_i < shards:
            per_rows[s_i].append(i - s_i * n_local)
            per_vals[s_i].append(vec)
    k_b = pow2_bucket(max(1, max(len(r) for r in per_rows)))
    rows = np.full((shards, k_b), -1, dtype=np.int32)
    vals = np.zeros((shards, k_b, dims), dtype=np.int32)
    for s_i in range(shards):
        k = len(per_rows[s_i])
        if k:
            rows[s_i, :k] = per_rows[s_i]
            vals[s_i, :k] = per_vals[s_i]
    return rows, vals


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
    nodes: List[s.Node] = field(default_factory=list)
    # Network accounting, built only when the batch asks for networks
    # (w == PORT_WORDS; otherwise w == 1 and the device skips the
    # checks): the first device's bandwidth (-1 = no network device), the
    # used bandwidth, the free dynamic ports and the used-port bitmaps as
    # uint32 words.  Whether a cluster's networks are simple enough for
    # this accounting is decided in ops/batch_sched.py.
    with_networks: bool = False
    bw_cap: np.ndarray = None           # [n_pad] int32
    bw_used: np.ndarray = None          # [n_pad] int32
    dyn_free: np.ndarray = None         # [n_pad] int32
    port_words: np.ndarray = None       # [n_pad, w] uint32
    # Sliced from the store's columnar mirror (build_cluster_static).
    columnar: bool = False


def _node_ports(nets: Sequence[s.NetworkResource]) -> Tuple[int, Set[int]]:
    """Bandwidth and the set of valid port numbers the networks hold."""
    mbits = 0
    ports: Set[int] = set()
    for nr in nets:
        mbits += nr.mbits
        for p in list(nr.reserved_ports) + list(nr.dynamic_ports):
            if 0 <= p.value < MAX_VALID_PORT:
                ports.add(p.value)
    return mbits, ports


def _port_row(ports: Set[int], w: int) -> Tuple[np.ndarray, int]:
    """A port set as a [w] uint32 bitmap row, and the free dynamic ports
    it leaves."""
    row = np.zeros(w, dtype=np.uint32)
    for p in ports:
        row[p >> 5] |= np.uint32(1 << (p & 31))
    in_dyn = sum(1 for p in ports if MIN_DYNAMIC_PORT <= p < MAX_DYNAMIC_PORT)
    return row, (MAX_DYNAMIC_PORT - MIN_DYNAMIC_PORT) - in_dyn


def _resolve_attr_rows(nodes: Sequence[s.Node], attr_targets: Sequence[str]
                       ) -> Tuple[List[Dict[str, Optional[str]]],
                                  Dict[str, Set[str]]]:
    """Each node's resolved attribute targets and the value set of each
    target: the walk's second loop, shared with the columnar encode
    (string attributes have no columnar form)."""
    value_sets: Dict[str, Set[str]] = {t: set() for t in attr_targets}
    if not attr_targets:
        # One shared empty row: finalize_codebooks only reads them.
        return [{}] * len(nodes), value_sets
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
    return raw_rows, value_sets


def encode_cluster_static(nodes: Sequence[s.Node],
                          attr_targets: Sequence[str],
                          node_pad_multiple: int = 128,
                          with_networks: bool = False) -> ClusterTensors:
    """The alloc-independent cluster tensors: capacity, reserved-only
    usage, eligibility, dc/class codes, the attribute columns (codes are
    assigned by :func:`finalize_codebooks`) and, ``with_networks``, the
    reserved-only network accounting (8 KiB of port bitmap a node)."""
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

    w = PORT_WORDS if with_networks else 1
    # bw_cap = -1 marks "no network device": any network ask, even one
    # for 0 Mbit/s, fails the bandwidth test there, as the reference's
    # "no networks available" (network.go:245).
    bw_cap = np.full(n_pad, -1 if with_networks else 0, dtype=np.int32)
    bw_used = np.zeros(n_pad, dtype=np.int32)
    dyn_free = np.zeros(n_pad, dtype=np.int32)
    port_words = np.zeros((n_pad, w), dtype=np.uint32)

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
        if with_networks:
            nets = [nr for nr in (node.resources.networks or []) if nr.device]
            if nets:
                bw_cap[i] = nets[0].mbits
            bw_used[i], ports = _node_ports(
                node.reserved.networks or [] if node.reserved else [])
            port_words[i], dyn_free[i] = _port_row(ports, w)

    raw_rows, value_sets = _resolve_attr_rows(nodes, attr_targets)

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
        node_index={nid: i for i, nid in enumerate(node_ids)},
        nodes=list(nodes), with_networks=with_networks, bw_cap=bw_cap,
        bw_used=bw_used, dyn_free=dyn_free, port_words=port_words)


def encode_cluster_static_columnar(cols, nodes: Sequence[s.Node],
                                   attr_targets: Sequence[str],
                                   node_pad_multiple: int = 128
                                   ) -> ClusterTensors:
    """:func:`encode_cluster_static` built by slicing the store's columnar
    mirror (``state/columnar.ClusterColumns``) instead of walking a node
    object a row (``encode.py:450``).  Bit-identical to the walk by
    construction: the codes are assigned in the walk's first-seen order,
    and the guard of :func:`build_cluster_static` holds it.  Batches with
    network asks keep the walk (port bitmaps have no columnar form)."""
    n_real = cols.n
    n_pad = max(node_pad_multiple, round_up(n_real, node_pad_multiple))

    capacity = np.zeros((n_pad, RES_DIMS), dtype=np.int64)
    capacity[:n_real] = cols.cap[:n_real]
    used = np.zeros((n_pad, RES_DIMS), dtype=np.int64)
    used[:n_real] = cols.res[:n_real]
    score_denom = np.ones((n_pad, 2), dtype=np.float32)
    score_denom[:n_real, 0] = cols.cap[:n_real, 0] - cols.res[:n_real, 0]
    score_denom[:n_real, 1] = cols.cap[:n_real, 1] - cols.res[:n_real, 1]
    eligible = np.zeros(n_pad, dtype=bool)
    eligible[:n_real] = cols.eligible[:n_real]
    dc_code = np.full(n_pad, MISSING, dtype=np.int32)
    dc_code[:n_real] = cols.dc_code[:n_real]
    class_code = np.full(n_pad, MISSING, dtype=np.int32)
    class_code[:n_real] = cols.class_code[:n_real]

    node_ids = list(cols.node_ids[:n_real])
    raw_rows, value_sets = _resolve_attr_rows(nodes, attr_targets)
    return ClusterTensors(
        node_ids=node_ids, n_real=n_real, n_pad=n_pad, capacity=capacity,
        used=used, score_denom=score_denom, eligible=eligible,
        dc_code=dc_code, class_code=class_code,
        attr_values=np.full((n_pad, max(1, len(attr_targets))), MISSING,
                            dtype=np.int32),
        attr_index={t: j for j, t in enumerate(attr_targets)},
        dc_codebook=cols.dc_codebook(),
        value_codebooks={t: {} for t in attr_targets},
        raw_rows=raw_rows, value_sets=value_sets,
        class_codebook=cols.class_codebook(),
        node_index={nid: i for i, nid in enumerate(node_ids)},
        nodes=nodes if type(nodes) is list else list(nodes),
        with_networks=False, bw_cap=np.zeros(n_pad, dtype=np.int32),
        bw_used=np.zeros(n_pad, dtype=np.int32),
        dyn_free=np.zeros(n_pad, dtype=np.int32),
        port_words=np.zeros((n_pad, 1), dtype=np.uint32), columnar=True)


def _static_mismatch(ct: ClusterTensors, ref: ClusterTensors) -> str:
    """The first difference between a column-built and a walk-built
    static encode, or '' when they are bit-identical: everything the
    device pass and the spec lowering read."""
    if ct.node_ids != ref.node_ids:
        return "node_ids order"
    for name in ("capacity", "used", "score_denom", "eligible",
                 "dc_code", "class_code", "attr_values"):
        if not np.array_equal(getattr(ct, name), getattr(ref, name)):
            return name
    if ct.dc_codebook != ref.dc_codebook:
        return "dc_codebook"
    if ct.value_codebooks != ref.value_codebooks:
        return "value_codebooks"
    if ct.class_codebook != ref.class_codebook:
        return "class_codebook"
    return ""


def build_cluster_static(state, nodes: Sequence[s.Node],
                         attr_targets: Sequence[str],
                         literals: Dict[str, Set[str]],
                         node_pad_multiple: int = 128,
                         with_networks: bool = False, breaker=None,
                         guard_every: int = columnar.GUARD_EVERY
                         ) -> ClusterTensors:
    """The static cluster tensors with finalized codebooks, sliced from
    the store's columnar mirror when it has one in step with ``nodes``,
    walked otherwise (``encode.py:535``).  Every ``guard_every`` columnar
    encodes (0: never) the walk runs anyway and the two are bit-compared:
    a mismatch feeds ``breaker``, bumps the columnar epoch (every mirror
    rebuilds before it is trusted again), and the batch goes on with the
    walk's buffers.  Fault point ``state.columns`` (action ``corrupt``)
    perturbs one column-built capacity cell, for the guard to catch."""
    cols = None
    if not with_networks:
        columns_fn = getattr(state, "columns", None)
        if columns_fn is not None:
            cols = columns_fn()
        if cols is not None and cols.n != len(nodes):
            cols = None  # the mirror is out of step with the node list
    if cols is None:
        columnar.WALK_ENCODES += 1
        ct = encode_cluster_static(nodes, attr_targets,
                                   node_pad_multiple=node_pad_multiple,
                                   with_networks=with_networks)
        finalize_codebooks(ct, literals)
        return ct

    columnar.COLUMNAR_ENCODES += 1
    ct = encode_cluster_static_columnar(
        cols, nodes, attr_targets, node_pad_multiple=node_pad_multiple)
    finalize_codebooks(ct, literals)

    act = fault.faultpoint("state.columns")
    if act is not None and act.kind == "corrupt":
        row = act.rng.randrange(max(1, ct.n_real))
        ct.capacity[row, act.rng.randrange(RES_DIMS)] += \
            1 + act.rng.randrange(1000)

    if guard_every > 0 and columnar.COLUMNAR_ENCODES % guard_every == 0:
        columnar.GUARD_RUNS += 1
        ref = encode_cluster_static(nodes, attr_targets,
                                    node_pad_multiple=node_pad_multiple)
        finalize_codebooks(ref, literals)
        bad = _static_mismatch(ct, ref)
        if bad:
            columnar.note_guard_mismatch("static", bad, breaker=breaker,
                                         Nodes=int(ref.n_real))
            return ref
        if breaker is not None:
            breaker.record(True)
    return ct


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
    static part is never mutated).  With networks, each touched node's
    used-port set, bandwidth and free dynamic ports are derived again
    from its reserved networks and the first network of every task of
    its live allocs (``encode.py:598-665``)."""
    used = ct.used.copy()
    new = replace(ct, used=used)
    if ct.with_networks:
        new = replace(new, bw_used=ct.bw_used.copy(),
                      dyn_free=ct.dyn_free.copy(),
                      port_words=ct.port_words.copy())
    w = new.port_words.shape[1]
    for nid, allocs in allocs_by_node.items():
        i = ct.node_index.get(nid)
        if i is None:
            continue
        for alloc in allocs:
            used[i] += alloc_usage(alloc)
        if ct.with_networks:
            node = ct.nodes[i]
            nets = list(node.reserved.networks or []) if node.reserved else []
            for alloc in allocs:
                nets.extend(tr.networks[0]
                            for tr in alloc.task_resources.values()
                            if tr.networks)
            new.bw_used[i], ports = _node_ports(nets)
            new.port_words[i], new.dyn_free[i] = _port_row(ports, w)
    return new


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
    # Network asks, the first network of each task (rank.go:190-238):
    net_active: bool = False
    net_mbits: int = 0
    dyn_count: int = 0
    resv_ports: List[int] = field(default_factory=list)
    resv_in_dyn: int = 0
    net_asks: Dict[str, s.NetworkResource] = field(default_factory=dict)
    # distinct_property (propertyset.go:11): at most one on the device;
    # the used values are filled in by the batch scheduler.
    dp_target: Optional[str] = None
    dp_used_values: Set[str] = field(default_factory=set)
    # Non-empty: the reference sends this spec to its CPU oracle, for
    # this reason.  The port has no oracle (ops/batch_sched.py raises).
    needs_oracle: str = ""


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

    # Network asks: the first network of each task, as the oracle's
    # (rank.go:199).
    for t in tg.tasks:
        if t.resources is not None and t.resources.networks:
            ask_net = t.resources.networks[0]
            spec.net_asks[t.name] = ask_net
            spec.net_mbits += ask_net.mbits
            spec.dyn_count += len(ask_net.dynamic_ports)
            spec.resv_ports.extend(p.value for p in ask_net.reserved_ports)
    spec.net_active = bool(spec.net_asks)
    if spec.net_active:
        if len(spec.resv_ports) != len(set(spec.resv_ports)):
            spec.needs_oracle = "conflicting reserved ports within task group"
        if any(p < 0 or p >= MAX_VALID_PORT for p in spec.resv_ports):
            spec.needs_oracle = "reserved port out of range"
        spec.resv_in_dyn = sum(
            1 for p in set(spec.resv_ports)
            if MIN_DYNAMIC_PORT <= p < MAX_DYNAMIC_PORT)

    dp_cons = [c for c in all_constraints
               if c.operand == s.CONSTRAINT_DISTINCT_PROPERTY]
    if len(dp_cons) > 1:
        spec.needs_oracle = "multiple distinct_property constraints"
    elif dp_cons:
        con = dp_cons[0]
        if con in job.constraints and len(job.task_groups) > 1:
            # A job-level distinct_property spans task groups; the
            # per-spec used-value set cannot be shared across specs.
            spec.needs_oracle = "job-level distinct_property, multiple groups"
        else:
            spec.dp_target = con.ltarget
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
    # Network asks (zeros when the batch has none; w = the cluster's):
    net_active: np.ndarray = None   # [u_pad] bool
    net_mbits: np.ndarray = None    # [u_pad] int32
    dyn_need: np.ndarray = None     # [u_pad] int32 — dynamic + resv-in-dyn
    resv_words: np.ndarray = None   # [u_pad, w] uint32
    # distinct_property (V = 1 when unused):
    dp_col: np.ndarray = None       # [u_pad] int32 — attr column or -1
    dp_active: np.ndarray = None    # [u_pad] bool
    dp_used: np.ndarray = None      # [u_pad, V] bool — value codes in use


def encode_specs(specs: List[PlacementSpec], ct: ClusterTensors,
                 nodes: Sequence[s.Node],
                 spec_pad_multiple: int = 8) -> SpecTensors:
    """Lower specs to arrays (``encode.py:819-973``): drivers and
    vectorizable constraints become (column, op, rhs-code) triples; the
    rest become host-evaluated boolean rows, cached per computed class
    as the reference's EvalCache and FeasibilityWrapper do."""
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

    def _precomp():
        nonlocal precomp
        if precomp is None:
            precomp = np.ones((u_pad, ct.n_pad), dtype=bool)
        return precomp

    job_row: Dict[str, int] = {}
    job_index = np.zeros(u_pad, dtype=np.int32)

    w = ct.port_words.shape[1] if ct.port_words is not None else 1
    net_active = np.zeros(u_pad, dtype=bool)
    net_mbits = np.zeros(u_pad, dtype=np.int32)
    dyn_need = np.zeros(u_pad, dtype=np.int32)
    resv_words = np.zeros((u_pad, w), dtype=np.uint32)
    dp_col = np.full(u_pad, -1, dtype=np.int32)
    dp_active = np.zeros(u_pad, dtype=bool)
    v_max = 1
    for sp in specs:
        if sp.dp_target is not None and sp.dp_target in ct.value_codebooks:
            v_max = max(v_max, len(ct.value_codebooks[sp.dp_target]) + 1)
    v_pad = pow2_bucket(v_max, minimum=2) if v_max > 1 else 1
    dp_used = np.zeros((u_pad, v_pad), dtype=bool)

    # Per-class cache of host-evaluated constraints: (constraint, class).
    class_cache: Dict[Tuple[str, str, str, int], bool] = {}
    eval_ctx = EvalContext()

    for u, sp in enumerate(specs):
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

        if sp.net_active and w > 1:
            net_active[u] = True
            net_mbits[u] = sp.net_mbits
            dyn_need[u] = sp.dyn_count + sp.resv_in_dyn
            for p in set(sp.resv_ports):
                resv_words[u, p >> 5] |= np.uint32(1 << (p & 31))

        if sp.dp_target is not None:
            col = ct.attr_index.get(sp.dp_target)
            if col is not None:
                dp_col[u] = col
                dp_active[u] = True
                codebook = ct.value_codebooks.get(sp.dp_target, {})
                for val in sp.dp_used_values:
                    code = codebook.get(val)
                    if code is not None:
                        dp_used[u, code] = True

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
                _precomp()[u, :ct.n_real] &= _driver_row(nodes, driver)

        for con in sp.constraints:
            if con.operand in (s.CONSTRAINT_DISTINCT_HOSTS,
                               s.CONSTRAINT_DISTINCT_PROPERTY):
                continue
            op_code = _VECTOR_OPS.get(con.operand)
            col = ct.attr_index.get(con.ltarget)
            if (op_code is not None and col is not None
                    and not con.rtarget.startswith("${")):
                code = ct.value_codebooks[con.ltarget].get(con.rtarget, None)
                c_attr[u, k] = col
                c_op[u, k] = op_code
                c_rhs[u, k] = UNKNOWN_RHS if code is None else code
                k += 1
            else:
                # Evaluated on the host once per computed class (per node
                # where the constraint escapes the class), feasible.go:597.
                _precomp()[u, :ct.n_real] &= _constraint_row(
                    nodes, con, ct, class_cache, eval_ctx)

    return SpecTensors(
        specs=specs, u_real=u_real, u_pad=u_pad, ask=ask, count=count,
        priority=priority, penalty=penalty, distinct_hosts=distinct,
        dc_mask=dc_mask, constraint_attr=c_attr, constraint_op=c_op,
        constraint_rhs=c_rhs,
        precomp=(precomp if precomp is not None
                 else np.ones((1, 1), dtype=bool)),
        job_index=job_index, job_ids=list(job_row), net_active=net_active,
        net_mbits=net_mbits, dyn_need=dyn_need, resv_words=resv_words,
        dp_col=dp_col, dp_active=dp_active, dp_used=dp_used)


def _driver_row(nodes: Sequence[s.Node], driver: str) -> np.ndarray:
    out = np.zeros(len(nodes), dtype=bool)
    key = f"driver.{driver}"
    for i, node in enumerate(nodes):
        val = node.attributes.get(key)
        out[i] = bool(val is not None and parse_bool(val))
    return out


def _escapes_class(con: s.Constraint) -> bool:
    return s.target_escapes(con.ltarget) or s.target_escapes(con.rtarget)


def _constraint_row(nodes: Sequence[s.Node], con: s.Constraint,
                    ct: ClusterTensors, class_cache: Dict,
                    eval_ctx: EvalContext) -> np.ndarray:
    """One constraint the device cannot compare, evaluated on the host
    per node, cached per computed class unless the constraint escapes
    the class (``encode.py:990-1010``)."""
    out = np.zeros(len(nodes), dtype=bool)
    escaped = _escapes_class(con)
    for i, node in enumerate(nodes):
        cached = not escaped and node.computed_class
        if cached:
            key = (con.ltarget, con.operand, con.rtarget,
                   ct.class_code[i].item())
            if key in class_cache:
                out[i] = class_cache[key]
                continue
        ok = _check_on_node(eval_ctx, con, node)
        out[i] = ok
        if cached:
            class_cache[key] = ok
    return out


def _check_on_node(eval_ctx: EvalContext, con: s.Constraint,
                   node: s.Node) -> bool:
    lval, lok = resolve_constraint_target(con.ltarget, node)
    if not lok:
        return False
    rval, rok = resolve_constraint_target(con.rtarget, node)
    if not rok:
        return False
    return check_constraint(eval_ctx, con.operand, lval, rval)


def collect_attr_targets(specs: List[PlacementSpec]
                         ) -> Tuple[List[str], Dict[str, Set[str]]]:
    """The targets that lower to int compares -- drivers, the
    distinct_property targets and the LTargets of vectorizable
    constraints -- plus the literal values to merge into each codebook."""
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
        if sp.dp_target is not None and sp.dp_target not in seen:
            seen.add(sp.dp_target)
            targets.append(sp.dp_target)
            literals.setdefault(sp.dp_target, set()).update(sp.dp_used_values)
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
