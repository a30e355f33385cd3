"""Reconciliation utilities: alloc diffing, tainted-node classification,
in-place updates, rolling-limit eviction (a copy of
``nomad_tpu/scheduler/util.py``; reference scheduler/util.go)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..structs import structs as s

# Desired-status descriptions (generic_sched.go:20-36).
ALLOC_NOT_NEEDED = "alloc not needed due to job update"
ALLOC_MIGRATING = "alloc is being migrated"
ALLOC_UPDATING = "alloc is being updated due to job update"
ALLOC_LOST = "alloc is lost since its node is down"
ALLOC_IN_PLACE = "alloc updating in-place"


@dataclass
class AllocTuple:
    """(name, task group, existing alloc) placement work item
    (util.go:14)."""

    name: str
    task_group: Optional[s.TaskGroup]
    alloc: Optional[s.Allocation]


@dataclass
class DiffResult:
    """The six reconciliation sets (util.go:38)."""

    place: List[AllocTuple] = field(default_factory=list)
    update: List[AllocTuple] = field(default_factory=list)
    migrate: List[AllocTuple] = field(default_factory=list)
    stop: List[AllocTuple] = field(default_factory=list)
    ignore: List[AllocTuple] = field(default_factory=list)
    lost: List[AllocTuple] = field(default_factory=list)

    def append(self, other: "DiffResult") -> None:
        self.place.extend(other.place)
        self.update.extend(other.update)
        self.migrate.extend(other.migrate)
        self.stop.extend(other.stop)
        self.ignore.extend(other.ignore)
        self.lost.extend(other.lost)

    def __str__(self) -> str:
        return (f"allocs: (place {len(self.place)}) (update {len(self.update)}) "
                f"(migrate {len(self.migrate)}) (stop {len(self.stop)}) "
                f"(ignore {len(self.ignore)}) (lost {len(self.lost)})")


def materialize_task_groups(job: Optional[s.Job]) -> Dict[str, s.TaskGroup]:
    """Count expansion → '<job>.<tg>[i]' names (util.go:22)."""
    out: Dict[str, s.TaskGroup] = {}
    if job is None or job.stopped():
        return out
    for tg in job.task_groups:
        for i in range(tg.count):
            out[f"{job.name}.{tg.name}[{i}]"] = tg
    return out


def diff_allocs(
    job: Optional[s.Job],
    tainted_nodes: Dict[str, Optional[s.Node]],
    required: Dict[str, s.TaskGroup],
    allocs: List[s.Allocation],
    terminal_allocs: Dict[str, s.Allocation],
) -> DiffResult:
    """Set-difference between required and existing allocations
    (util.go:70-160)."""
    result = DiffResult()
    existing: Set[str] = set()
    for exist in allocs:
        name = exist.name
        existing.add(name)
        tg = required.get(name)
        if tg is None:
            result.stop.append(AllocTuple(name, tg, exist))
            continue

        if exist.node_id in tainted_nodes:
            # Successfully finished batch work needn't move off a tainted
            # node — ignored outright (util.go:97-105 goto IGNORE).
            if (exist.job is not None and exist.job.type == s.JOB_TYPE_BATCH
                    and exist.ran_successfully()):
                result.ignore.append(AllocTuple(name, tg, exist))
                continue
            node = tainted_nodes[exist.node_id]
            if node is None or node.terminal_status():
                result.lost.append(AllocTuple(name, tg, exist))
            else:
                result.migrate.append(AllocTuple(name, tg, exist))
            continue
        if (exist.job is not None and job is not None
                and job.job_modify_index != exist.job.job_modify_index):
            result.update.append(AllocTuple(name, tg, exist))
            continue
        result.ignore.append(AllocTuple(name, tg, exist))

    for name, tg in required.items():
        if name not in existing:
            result.place.append(AllocTuple(name, tg, terminal_allocs.get(name)))
    return result


def diff_system_allocs(
    job: s.Job,
    nodes: List[s.Node],
    tainted_nodes: Dict[str, Optional[s.Node]],
    allocs: List[s.Allocation],
    terminal_allocs: Dict[str, s.Allocation],
) -> DiffResult:
    """Per-node diff for system jobs; placements are node-annotated
    (util.go:171-220)."""
    node_allocs: Dict[str, List[s.Allocation]] = {}
    for alloc in allocs:
        node_allocs.setdefault(alloc.node_id, []).append(alloc)
    for node in nodes:
        node_allocs.setdefault(node.id, [])

    required = materialize_task_groups(job)
    result = DiffResult()
    for node_id, nallocs in node_allocs.items():
        diff = diff_allocs(job, tainted_nodes, required, nallocs,
                           terminal_allocs)
        if node_id in tainted_nodes:
            diff.place = []
        else:
            for tup in diff.place:
                if tup.alloc is None or tup.alloc.node_id != node_id:
                    tup.alloc = s.Allocation(node_id=node_id)
        # A tainted node invalidates system allocs outright: stop, not
        # migrate (util.go:211-214).
        diff.stop.extend(diff.migrate)
        diff.migrate = []
        result.append(diff)
    return result


def ready_nodes_in_dcs(state, dcs: List[str]) -> Tuple[List[s.Node], Dict[str, int]]:
    """Ready, undrained nodes in the job's datacenters + per-DC counts
    (util.go:224).

    Memoized per store/snapshot (invalidated by node writes via
    StateStore._bump): the stale-snapshot worker pool schedules many
    evals off one snapshot, and this walk was the second-largest
    per-eval cost in the load-harness profile.  Callers receive a fresh
    list (stacks shuffle it in place)."""
    cache = getattr(state, "_ready_nodes_cache", None)
    key = tuple(dcs)
    if cache is not None:
        hit = cache.get(key)
        if hit is not None:
            return list(hit[0]), dict(hit[1])
    dc_map = {dc: 0 for dc in dcs}
    out: List[s.Node] = []
    for node in state.nodes(None):
        if node.status != s.NODE_STATUS_READY or node.drain:
            continue
        if node.datacenter not in dc_map:
            continue
        out.append(node)
        dc_map[node.datacenter] += 1
    try:
        if cache is None:
            cache = state._ready_nodes_cache = {}
        cache[key] = (out, dc_map)
    except AttributeError:
        return out, dc_map  # slot-restricted store: serve uncached
    return list(out), dict(dc_map)


class SetStatusError(Exception):
    """Carries the eval status to set when retries are exhausted
    (generic_sched.go:47)."""

    def __init__(self, message: str, eval_status: str):
        super().__init__(message)
        self.eval_status = eval_status


def retry_max(max_attempts: int, cb, reset=None,
              max_total: Optional[int] = None) -> None:
    """Retry cb until done, resetting the budget when progress is made
    (util.go:262).

    ``max_total`` caps TOTAL attempts regardless of progress resets: a
    plan that keeps getting partially committed (e.g. staleness fences
    rejecting a few nodes every round under churn) makes "progress" each
    time and would otherwise resubmit forever — a plan-resubmission
    storm against the single-threaded applier.  Defaults to
    ``8 × max_attempts``; the eval fails (→ blocked, retried later)
    rather than hammering the plan queue."""
    if max_total is None:
        max_total = max_attempts * 8
    attempts = 0
    total = 0
    while attempts < max_attempts and total < max_total:
        done = cb()
        total += 1
        if done:
            return
        if reset is not None and reset():
            attempts = 0
        else:
            attempts += 1
    raise SetStatusError(
        f"maximum attempts reached ({max_attempts}/{total} total)",
        s.EVAL_STATUS_FAILED)


def progress_made(result: Optional[s.PlanResult]) -> bool:
    """(util.go:291)."""
    return result is not None and (bool(result.node_update)
                                   or bool(result.node_allocation)
                                   or bool(result.alloc_slabs))


def tainted_nodes(state, allocs: List[s.Allocation]) -> Dict[str, Optional[s.Node]]:
    """Nodes (of the given allocs) that are down, draining, or gone
    (util.go:299)."""
    out: Dict[str, Optional[s.Node]] = {}
    for alloc in allocs:
        if alloc.node_id in out:
            continue
        node = state.node_by_id(None, alloc.node_id)
        if node is None:
            out[alloc.node_id] = None
            continue
        if node.status == s.NODE_STATUS_DOWN or node.drain:
            out[alloc.node_id] = node
    return out


def tasks_updated(job_a: s.Job, job_b: s.Job, task_group: str) -> bool:
    """Whether the TG change is destructive (driver/config/env/artifacts/
    vault/templates/meta/network/resources) vs in-place (util.go:336)."""
    a = job_a.lookup_task_group(task_group)
    b = job_b.lookup_task_group(task_group)
    if a is None or b is None:
        return True
    if len(a.tasks) != len(b.tasks):
        return True
    if a.ephemeral_disk != b.ephemeral_disk:
        return True
    for at in a.tasks:
        bt = b.lookup_task(at.name)
        if bt is None:
            return True
        if at.driver != bt.driver or at.user != bt.user:
            return True
        if at.config != bt.config or at.env != bt.env:
            return True
        if at.artifacts != bt.artifacts or at.vault != bt.vault:
            return True
        if at.templates != bt.templates:
            return True
        if _combined_meta(job_a, task_group, at.name) != _combined_meta(job_b, task_group, bt.name):
            return True
        if len(at.resources.networks) != len(bt.resources.networks):
            return True
        for an, bn in zip(at.resources.networks, bt.resources.networks):
            if an.mbits != bn.mbits:
                return True
            if _network_port_map(an) != _network_port_map(bn):
                return True
        ar, br = at.resources, bt.resources
        if ar.cpu != br.cpu or ar.memory_mb != br.memory_mb or ar.iops != br.iops:
            return True
    return False


def _combined_meta(job: s.Job, tg_name: str, task_name: str) -> Dict[str, str]:
    """Job < TG < task meta layering (structs.go CombinedTaskMeta)."""
    meta = dict(job.meta)
    tg = job.lookup_task_group(tg_name)
    if tg is not None:
        meta.update(tg.meta)
        task = tg.lookup_task(task_name)
        if task is not None:
            meta.update(task.meta)
    return meta


def _network_port_map(n: s.NetworkResource) -> Dict[str, int]:
    """Port labels → values, dynamic values disregarded (util.go:417)."""
    out = {p.label: p.value for p in n.reserved_ports}
    for p in n.dynamic_ports:
        out[p.label] = -1
    return out


def set_status(
    logger,
    planner,
    ev: s.Evaluation,
    next_eval: Optional[s.Evaluation],
    spawned_blocked: Optional[s.Evaluation],
    tg_metrics: Optional[Dict[str, s.AllocMetric]],
    status: str,
    description: str,
    queued_allocs: Optional[Dict[str, int]],
) -> None:
    """Update the eval's status via the planner (util.go:430)."""
    new_eval = ev.copy()
    new_eval.status = status
    new_eval.status_description = description
    new_eval.failed_tg_allocs = tg_metrics or {}
    if next_eval is not None:
        new_eval.next_eval = next_eval.id
    if spawned_blocked is not None:
        new_eval.blocked_eval = spawned_blocked.id
    if queued_allocs is not None:
        new_eval.queued_allocations = queued_allocs
    planner.update_eval(new_eval)


def inplace_update(
    ctx, ev: s.Evaluation, job: s.Job, stack, updates: List[AllocTuple]
) -> Tuple[List[AllocTuple], List[AllocTuple]]:
    """Attempt in-place updates; returns (destructive, inplace)
    (util.go:455-551).  Works by staging an eviction of the current alloc,
    running Select against only its node, then popping the staged evict."""
    destructive: List[AllocTuple] = []
    inplace: List[AllocTuple] = []
    for update in updates:
        existing_job = update.alloc.job
        if existing_job is None or tasks_updated(job, existing_job, update.task_group.name):
            destructive.append(update)
            continue

        # Successfully-finished terminal batch allocs: in-place with no plan
        # entry at all (util.go:481-488).
        if update.alloc.terminal_status():
            inplace.append(update)
            continue

        node = ctx.state.node_by_id(None, update.alloc.node_id)
        if node is None:
            destructive.append(update)
            continue

        stack.set_nodes([node])
        ctx.plan.append_update(update.alloc, s.ALLOC_DESIRED_STATUS_STOP, ALLOC_IN_PLACE)
        option, _ = stack.select(update.task_group)
        ctx.plan.pop_update(update.alloc)

        if option is None:
            destructive.append(update)
            continue

        # Network resources are never updated in place; restore the existing
        # offers (util.go:520-528).
        for task_name, resources in option.task_resources.items():
            existing_res = update.alloc.task_resources.get(task_name)
            if existing_res is not None:
                resources.networks = existing_res.networks

        new_alloc = update.alloc.copy()
        new_alloc.eval_id = ev.id
        new_alloc.job = None  # plan carries the job
        new_alloc.resources = None  # recomputed at plan apply
        new_alloc.task_resources = option.task_resources
        new_alloc.metrics = ctx.metrics
        ctx.plan.append_alloc(new_alloc)
        inplace.append(update)
    return destructive, inplace


def evict_and_place(
    ctx, diff: DiffResult, allocs: List[AllocTuple], desc: str, limit_box: List[int]
) -> bool:
    """Evict up to the rolling limit, queueing replacements; True if the
    limit was hit (util.go:556)."""
    n = len(allocs)
    limit = limit_box[0]
    for i in range(min(n, limit)):
        a = allocs[i]
        ctx.plan.append_update(a.alloc, s.ALLOC_DESIRED_STATUS_STOP, desc)
        diff.place.append(a)
    if n <= limit:
        limit_box[0] = limit - n
        return False
    limit_box[0] = 0
    return True


def mark_lost_and_place(
    ctx, diff: DiffResult, allocs: List[AllocTuple], desc: str, limit_box: List[int]
) -> bool:
    """Like evict_and_place but also forces client status lost
    (util.go:574)."""
    n = len(allocs)
    limit = limit_box[0]
    for i in range(min(n, limit)):
        a = allocs[i]
        ctx.plan.append_update(
            a.alloc, s.ALLOC_DESIRED_STATUS_STOP, desc, s.ALLOC_CLIENT_STATUS_LOST)
        diff.place.append(a)
    if n <= limit:
        limit_box[0] = limit - n
        return False
    limit_box[0] = 0
    return True


@dataclass
class TGConstraintTuple:
    """Aggregated constraints/drivers/resources of a TG (util.go:590)."""

    constraints: List[s.Constraint]
    drivers: Set[str]
    size: s.Resources


def task_group_constraints(tg: s.TaskGroup) -> TGConstraintTuple:
    """(util.go:606)."""
    size = s.Resources(disk_mb=tg.ephemeral_disk.size_mb)
    constraints = list(tg.constraints)
    drivers: Set[str] = set()
    for task in tg.tasks:
        drivers.add(task.driver)
        constraints.extend(task.constraints)
        size.add(task.resources)
    return TGConstraintTuple(constraints, drivers, size)


def desired_updates(
    diff: DiffResult,
    inplace_updates: List[AllocTuple],
    destructive_updates: List[AllocTuple],
) -> Dict[str, s.DesiredUpdates]:
    """Plan annotations per TG (util.go:625)."""
    out: Dict[str, s.DesiredUpdates] = {}

    def get(name: str) -> s.DesiredUpdates:
        return out.setdefault(name, s.DesiredUpdates())

    for tup in diff.place:
        get(tup.task_group.name).place += 1
    for tup in diff.stop:
        get(tup.alloc.task_group).stop += 1
    for tup in diff.ignore:
        get(tup.task_group.name).ignore += 1
    for tup in diff.migrate:
        get(tup.task_group.name).migrate += 1
    for tup in inplace_updates:
        get(tup.task_group.name).in_place_update += 1
    for tup in destructive_updates:
        get(tup.task_group.name).destructive_update += 1
    return out


def adjust_queued_allocations(
    logger, result: Optional[s.PlanResult], queued_allocs: Dict[str, int]
) -> None:
    """Decrement queued counts for freshly created allocs (util.go:698)."""
    if result is None:
        return
    for allocations in result.node_allocation.values():
        for allocation in allocations:
            if allocation.create_index != allocation.modify_index:
                continue
            if allocation.task_group in queued_allocs:
                queued_allocs[allocation.task_group] -= 1
            else:
                logger.error(
                    "allocation %r placed but not in list of unplaced allocations",
                    allocation.task_group)
    for slab in result.alloc_slabs:
        if slab.create_index != slab.modify_index:
            continue
        tg = slab.proto.task_group
        if tg in queued_allocs:
            queued_allocs[tg] -= len(slab)
        else:
            logger.error(
                "allocation %r placed but not in list of unplaced allocations",
                tg)


def update_non_terminal_allocs_to_lost(
    plan: s.Plan, tainted: Dict[str, Optional[s.Node]], allocs: List[s.Allocation]
) -> None:
    """Stopped-but-still-running allocs on tainted nodes become lost
    (util.go:725)."""
    for alloc in allocs:
        if (alloc.node_id in tainted
                and alloc.desired_status == s.ALLOC_DESIRED_STATUS_STOP
                and alloc.client_status in (s.ALLOC_CLIENT_STATUS_RUNNING,
                                            s.ALLOC_CLIENT_STATUS_PENDING)):
            plan.append_update(alloc, s.ALLOC_DESIRED_STATUS_STOP, ALLOC_LOST,
                               s.ALLOC_CLIENT_STATUS_LOST)
