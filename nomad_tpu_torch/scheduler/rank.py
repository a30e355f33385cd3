"""Ranking iterators: bin-pack scoring and job anti-affinity (a copy of
``nomad_tpu/scheduler/rank.py``; reference scheduler/rank.go).

The per-node oracle of what the device pass scores for the whole matrix
at once: ``score_fit(used after) - penalty * collisions``
(``ops/fused_score.py``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..structs import structs as s
from ..structs.funcs import allocs_fit, remove_allocs, score_fit
from ..structs.network import NetworkIndex
from . import preempt
from .context import EvalContext


class RankedNode:
    """A node plus its accumulated score and per-task resources
    (rank.go:12-45)."""

    __slots__ = ("node", "score", "task_resources", "proposed",
                 "preempted_allocs")

    def __init__(self, node: s.Node):
        self.node = node
        self.score = 0.0
        self.task_resources: Dict[str, s.Resources] = {}
        self.proposed: Optional[List[s.Allocation]] = None
        # Lower-priority allocs whose eviction this option depends on
        # (preempt.py); staged into Plan.node_preemptions on selection.
        self.preempted_allocs: Optional[List[s.Allocation]] = None

    def __repr__(self) -> str:
        return f"<Node: {self.node.id} Score: {self.score:.3f}>"

    def proposed_allocs(self, ctx: EvalContext) -> List[s.Allocation]:
        if self.proposed is None:
            self.proposed = ctx.proposed_allocs(self.node.id)
        return self.proposed

    def set_task_resources(self, task: s.Task, resources: s.Resources) -> None:
        self.task_resources[task.name] = resources


class FeasibleRankIterator:
    """Upgrades a feasible iterator into the ranking chain (rank.go:60)."""

    def __init__(self, ctx: EvalContext, source):
        self.ctx = ctx
        self.source = source

    def next_option(self) -> Optional[RankedNode]:
        option = self.source.next_option()
        if option is None:
            return None
        return RankedNode(option)

    def reset(self) -> None:
        self.source.reset()


class BinPackIterator:
    """Scores nodes by best-fit bin packing after assigning task networks
    (rank.go:130-240)."""

    def __init__(self, ctx: EvalContext, source, evict: bool, priority: int,
                 preemption_enabled: bool = False):
        self.ctx = ctx
        self.source = source
        # evict + priority gate the preemption path: a node that cannot
        # fit the task group may still rank if evicting strictly-lower-
        # priority allocs makes room (preempt.py).  preemption_enabled
        # is the operator switch; with it off, evict is recorded but
        # inert — the reference ships the same dormant flag.
        self.evict = evict
        self.priority = priority
        self.preemption_enabled = preemption_enabled
        # Set by the stack for its SECOND select pass only (no node fits
        # without eviction).  Preempting options must never compete with
        # normally-fitting nodes inside the LimitIterator's small sample
        # — a full-but-preemptible node would consume a candidate slot
        # and could win on score while free capacity exists elsewhere.
        self.allow_preempt = False
        self.task_group: Optional[s.TaskGroup] = None

    def set_priority(self, priority: int) -> None:
        self.priority = priority

    def set_task_group(self, tg: s.TaskGroup) -> None:
        self.task_group = tg

    def next_option(self) -> Optional[RankedNode]:
        while True:
            option = self.source.next_option()
            if option is None:
                return None

            proposed = option.proposed_allocs(self.ctx)

            net_idx = NetworkIndex()
            net_idx.set_node(option.node)
            net_idx.add_allocs(proposed)

            total = s.Resources(disk_mb=self.task_group.ephemeral_disk.size_mb)
            network_ok = True
            for task in self.task_group.tasks:
                task_resources = task.resources.copy()
                if task_resources.networks:
                    ask = task_resources.networks[0]
                    offer, err = net_idx.assign_network(ask, self.ctx.rng)
                    if offer is None:
                        self.ctx.metrics.exhausted_node(option.node, f"network: {err}")
                        network_ok = False
                        break
                    net_idx.add_reserved(offer)
                    task_resources.networks = [offer]
                option.set_task_resources(task, task_resources)
                total.add(task_resources)
            if not network_ok:
                continue

            probe = s.Allocation(id="_binpack_probe", resources=total)
            candidate = proposed + [probe]
            fit, dim, util = allocs_fit(option.node, candidate, net_idx)
            if not fit:
                if (self.allow_preempt and self.evict
                        and self.preemption_enabled and self.priority > 0
                        and self._try_preempt(option, proposed, probe,
                                              total)):
                    return option
                if not self.allow_preempt:
                    # The preempt pass re-walks nodes the first pass
                    # already attributed; don't double-count exhaustion.
                    self.ctx.metrics.exhausted_node(option.node, dim)
                continue

            fitness = score_fit(option.node, util)
            option.score += fitness
            self.ctx.metrics.score_node(option.node, "binpack", fitness)
            return option

    def _try_preempt(self, option: RankedNode,
                     proposed: List[s.Allocation], probe: s.Allocation,
                     total: s.Resources) -> bool:
        """Rank the node anyway if evicting strictly-lower-priority
        allocs makes the task group fit (preempt.py oracle).  The score
        carries a discount so any node that fits WITHOUT eviction
        outranks a preempting one; ties among preempting nodes prefer
        the smaller eviction set."""
        state = self.ctx.state

        def prio_of(a: s.Allocation) -> int:
            return preempt.alloc_priority(a, state)

        victims = preempt.find_eviction_set(
            option.node, proposed, total, self.priority, prio_of)
        if not victims:
            return False
        survivors = remove_allocs(proposed, victims)
        # Full re-check over the survivors with a rebuilt NetworkIndex:
        # the scalar-dimension oracle freed enough cpu/mem/disk/iops,
        # but ports/bandwidth held by non-evicted allocs still bind.
        net_idx = NetworkIndex()
        net_idx.set_node(option.node)
        net_idx.add_allocs(survivors)
        for res in option.task_resources.values():
            for offer in res.networks or []:
                net_idx.add_reserved(offer)
        fit, _, util = allocs_fit(option.node, survivors + [probe], net_idx)
        if not fit:
            return False
        fitness = score_fit(option.node, util)
        penalty = preempt.preemption_score_penalty(len(victims))
        option.score += fitness - penalty
        option.preempted_allocs = victims
        self.ctx.metrics.score_node(option.node, "binpack", fitness)
        self.ctx.metrics.score_node(option.node, "preemption", -penalty)
        return True

    def reset(self) -> None:
        self.source.reset()


class JobAntiAffinityIterator:
    """Penalizes nodes already running allocs of this job (rank.go:247-306)."""

    def __init__(self, ctx: EvalContext, source, penalty: float, job_id: str):
        self.ctx = ctx
        self.source = source
        self.penalty = penalty
        self.job_id = job_id

    def set_job(self, job_id: str) -> None:
        self.job_id = job_id

    def next_option(self) -> Optional[RankedNode]:
        option = self.source.next_option()
        if option is None:
            return None
        proposed = option.proposed_allocs(self.ctx)
        collisions = sum(1 for alloc in proposed if alloc.job_id == self.job_id)
        if collisions > 0:
            penalty = -1.0 * collisions * self.penalty
            option.score += penalty
            self.ctx.metrics.score_node(option.node, "job-anti-affinity", penalty)
        return option

    def reset(self) -> None:
        self.source.reset()
