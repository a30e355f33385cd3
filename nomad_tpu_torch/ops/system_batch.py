"""Vectorized system scheduling (a copy of ``nomad_tpu/ops/system_batch.py``):
the per-node Select loop of the SystemScheduler (system_sched.go:258, one
full stack evaluation per node) replaced by one numpy pass over the
encoded cluster tensors.

System placement has no inter-node competition: every feasible node with
capacity gets exactly one alloc per task group, so the decision is a
feasibility row AND a capacity compare.  The constraint evaluation is a
numpy mirror of the device feasibility pass (``feasibility_np``; a host
pass, no transfer), and placements land as one columnar ``AllocSlab``
per task group.

Gate, don't misplace: the vectorized pass runs only when it places on
every candidate node.  Any filtered or exhausted node, any spec it
cannot express (networks, distinct_property) or an annotate-plan run
falls back to the inherited per-node oracle loop, which owns the
reference's exact failure accounting.

Registered as ``torch-system`` (the reference's ``tpu-system``); the
server's batch worker routes system evals to it.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..scheduler.scheduler import register_scheduler
from ..scheduler.system import SystemScheduler
from ..scheduler.util import AllocTuple
from ..structs import structs as s
from . import encode


def feasibility_np(ct, st) -> np.ndarray:
    """numpy mirror of ``kernels.feasibility_matrix``: the same op codes,
    the same missing and unknown-RHS semantics; returns bool[U, n_pad]."""
    n = ct.n_pad
    u = st.constraint_attr.shape[0]
    dc_ok = np.take_along_axis(
        st.dc_mask, np.broadcast_to(
            np.clip(ct.dc_code[None, :], 0, st.dc_mask.shape[1] - 1), (u, n)),
        axis=1)
    dc_ok = dc_ok & (ct.dc_code[None, :] >= 0)
    precomp = (st.precomp if st.precomp.shape == (u, n)
               else np.broadcast_to(st.precomp, (u, n)))
    out = precomp & dc_ok & ct.eligible[None, :]
    for k in range(st.constraint_attr.shape[1]):
        attr_col = st.constraint_attr[:, k]              # [U]
        vals = ct.attr_values[:, attr_col].T             # [U, N]
        rhs = st.constraint_rhs[:, k][:, None]
        op = st.constraint_op[:, k][:, None]
        missing = vals == encode.MISSING
        unknown = rhs == encode.UNKNOWN_RHS
        ok = np.select(
            [op == encode.OP_EQ, op == encode.OP_NE, op == encode.OP_LT,
             op == encode.OP_LE, op == encode.OP_GT, op == encode.OP_GE],
            [(vals == rhs) & ~unknown, (vals != rhs) | unknown,
             vals < rhs, vals <= rhs, vals > rhs, vals >= rhs],
            default=True,
        )
        ok = np.where(op == encode.OP_TRUE, True, ok & ~missing)
        out = out & ok
    return out


class TorchSystemScheduler(SystemScheduler):
    """SystemScheduler with a vectorized all-or-fallback placement pass."""

    def _compute_placements(self, place: List[AllocTuple]) -> None:
        if self.eval.annotate_plan or not place:
            return super()._compute_placements(place)

        by_tg: Dict[str, List[AllocTuple]] = {}
        order: List[str] = []
        for tup in place:
            if tup.task_group.name not in by_tg:
                by_tg[tup.task_group.name] = []
                order.append(tup.task_group.name)
            by_tg[tup.task_group.name].append(tup)
        specs = {}
        for name in order:
            sp = encode.build_spec(self.job, by_tg[name][0].task_group, False)
            if sp.needs_oracle or sp.net_active or sp.dp_target is not None:
                return super()._compute_placements(place)
            specs[name] = sp

        spec_list = [specs[name] for name in order]
        attr_targets, literals = encode.collect_attr_targets(spec_list)
        allocs_by_node: Dict[str, List[s.Allocation]] = {}
        # Allocs staged for eviction in THIS plan free their capacity
        # (EvalContext.ProposedAllocs subtracts plan.node_update).
        evicted = {a.id for ups in self.plan.node_update.values()
                   for a in ups}
        for node_id, row in self.state.alloc_rows(None):
            if not row.terminal_status() and row.id not in evicted:
                allocs_by_node.setdefault(node_id, []).append(row)

        ct = encode.apply_alloc_usage(
            encode.encode_cluster_static(self.nodes, attr_targets),
            allocs_by_node)
        encode.finalize_codebooks(ct, literals)
        st = encode.encode_specs(spec_list, ct, self.nodes)
        feas = feasibility_np(ct, st)
        node_index = {nid: i for i, nid in enumerate(ct.node_ids)}
        used = ct.used.copy()                       # [n_pad, 4] int64
        capacity = ct.capacity

        staged: List[tuple] = []
        for u, name in enumerate(order):
            sp = specs[name]
            tups = by_tg[name]
            idx = np.array([node_index[t.alloc.node_id] for t in tups],
                           dtype=np.int64)
            feas_rows = feas[u, idx]
            fits = np.all(sp.ask[None, :] <= (capacity[idx] - used[idx]),
                          axis=1)
            if not bool(np.all(feas_rows & fits)):
                # Any failure → the oracle loop owns the exact filtered/
                # exhausted/queued accounting.  Nothing staged yet, so the
                # fallback starts clean.
                return super()._compute_placements(place)
            # Later task groups of this job see this group's placements
            # (the per-node loop's ProposedAllocs would).
            np.add.at(used, idx, sp.ask)
            staged.append((name, tups))

        for name, tups in staged:
            tg = tups[0].task_group
            # Fresh per-group metric matching the oracle's per-select
            # reset: on the happy path every node's chain sees exactly
            # one evaluated node and no filters, so one shared object
            # per group carries identical content (slab convention).
            m = s.AllocMetric()
            m.nodes_evaluated = 1
            m.nodes_available = self.nodes_by_dc
            combined = s.Resources(disk_mb=tg.ephemeral_disk.size_mb)
            for t in tg.tasks:
                combined.add(t.resources)
            proto = s.Allocation(
                eval_id=self.eval.id,
                job_id=self.job.id,
                task_group=tg.name,
                metrics=m,
                resources=combined,
                task_resources={t.name: t.resources.copy()
                                for t in tg.tasks},
                desired_status=s.ALLOC_DESIRED_STATUS_RUN,
                client_status=s.ALLOC_CLIENT_STATUS_PENDING,
                shared_resources=s.Resources(
                    disk_mb=tg.ephemeral_disk.size_mb),
            )
            prevs = [(t.alloc.id or "") if t.alloc is not None else ""
                     for t in tups]
            slab = s.AllocSlab(
                proto=proto,
                ids=s.generate_uuids(len(tups)),
                names=[t.name for t in tups],
                node_ids=[t.alloc.node_id for t in tups],
                prev_ids=prevs if any(prevs) else [],
            )
            self.plan.append_slab(slab)


def new_torch_system_scheduler(logger, state, planner
                               ) -> TorchSystemScheduler:
    return TorchSystemScheduler(logger, state, planner)


register_scheduler("torch-system", new_torch_system_scheduler)
