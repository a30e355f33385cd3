"""Host-side data model: a copy of ``nomad_tpu/structs/structs.py``, trimmed
to what batch placement, the batch scheduler and the server path read and
write (nodes, jobs with their periodic and parameterized configs,
allocations with their placement forensics, evaluations, plans and their
results, the columnar alloc slabs, the namespaces and the job summaries
with their children counts).  Resource quantities are 4 scalar ints (cpu,
memory_mb, disk_mb, iops) so they lower directly to the int32 ``[N, 4]`` /
``[U, 4]`` tensors in ``ops/encode.py``.

Left out of the copy: services, vault, templates and artifacts as types
(a task keeps the last three as plain data, compared by the in-place
update test and rendered by the job diff, ``structs/diff.py``, as the
reference renders their types), the task fields the client reads
(restart policy, kill timeout, log config, leader), and deployments.  The
event stream's structs (``TOPIC_*``, ``EVENT_TOPICS``, ``Event``) are
here; the deployment topic names a table the port does not have yet.
"""
from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

JOB_TYPE_SERVICE = "service"
JOB_TYPE_BATCH = "batch"
JOB_TYPE_SYSTEM = "system"
# Core (GC) evals: the server's own, run by ``server/core_sched.py``.
JOB_TYPE_CORE = "_core"

JOB_STATUS_PENDING = "pending"
JOB_STATUS_RUNNING = "running"
JOB_STATUS_DEAD = "dead"

JOB_MIN_PRIORITY = 1
JOB_DEFAULT_PRIORITY = 50
JOB_MAX_PRIORITY = 100

# Core job IDs of the internal GC scheduler (structs.go / core_sched.go).
CORE_JOB_EVAL_GC = "eval-gc"
CORE_JOB_NODE_GC = "node-gc"
CORE_JOB_JOB_GC = "job-gc"
CORE_JOB_FORCE_GC = "force-gc"

# Periodic spec types (structs.go:1718-1724).
PERIODIC_SPEC_CRON = "cron"
PERIODIC_SPEC_TEST = "_internal_test"

# Fair-dequeue objectives of the broker's ready queues
# (tenancy/fairness.py).
TENANCY_OBJECTIVE_DRF = "drf"
TENANCY_OBJECTIVE_WRR = "weighted-rr"
TENANCY_OBJECTIVE_FIFO = "fifo"
TENANCY_OBJECTIVES = (TENANCY_OBJECTIVE_DRF, TENANCY_OBJECTIVE_WRR,
                      TENANCY_OBJECTIVE_FIFO)

NODE_STATUS_INIT = "initializing"
NODE_STATUS_READY = "ready"
NODE_STATUS_DOWN = "down"

ALLOC_DESIRED_STATUS_RUN = "run"
ALLOC_DESIRED_STATUS_STOP = "stop"
ALLOC_DESIRED_STATUS_EVICT = "evict"

ALLOC_CLIENT_STATUS_PENDING = "pending"
ALLOC_CLIENT_STATUS_RUNNING = "running"
ALLOC_CLIENT_STATUS_COMPLETE = "complete"
ALLOC_CLIENT_STATUS_FAILED = "failed"
ALLOC_CLIENT_STATUS_LOST = "lost"

# Evaluation statuses (structs.go:4230-4242).
EVAL_STATUS_BLOCKED = "blocked"
EVAL_STATUS_PENDING = "pending"
EVAL_STATUS_COMPLETE = "complete"
EVAL_STATUS_FAILED = "failed"
EVAL_STATUS_CANCELLED = "canceled"

# Evaluation trigger reasons (structs.go:4218-4228).
EVAL_TRIGGER_JOB_REGISTER = "job-register"
EVAL_TRIGGER_JOB_DEREGISTER = "job-deregister"
EVAL_TRIGGER_PERIODIC_JOB = "periodic-job"
EVAL_TRIGGER_NODE_UPDATE = "node-update"
EVAL_TRIGGER_SCHEDULED = "scheduled"
EVAL_TRIGGER_ROLLING_UPDATE = "rolling-update"
EVAL_TRIGGER_MAX_PLANS = "max-plan-attempts"
EVAL_TRIGGER_PREEMPTION = "preemption"

ALLOC_PREEMPTED = "preempted by a higher-priority allocation"

CONSTRAINT_DISTINCT_PROPERTY = "distinct_property"
CONSTRAINT_DISTINCT_HOSTS = "distinct_hosts"
CONSTRAINT_REGEX = "regexp"
CONSTRAINT_VERSION = "version"
CONSTRAINT_SET_CONTAINS = "set_contains"

TASK_STATE_PENDING = "pending"
TASK_STATE_RUNNING = "running"
TASK_STATE_DEAD = "dead"
TASK_TERMINATED = "Terminated"

DEFAULT_NAMESPACE = "default"

# Meta/attribute keys in this namespace are excluded from the computed
# class (node_class.go).
NODE_UNIQUE_NAMESPACE = "unique."


def target_escapes(target: str) -> bool:
    """A constraint target that reads a unique attribute escapes the
    computed class: nodes of one class may differ there
    (``structs/node_class.py``)."""
    from .node_class import _target_escapes

    return _target_escapes(target)


def generate_uuid() -> str:
    """Random 8-4-4-4-12 id (funcs.go:158)."""
    h = os.urandom(16).hex()
    return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"


def now() -> float:
    """The wall clock the server path stamps launches and dispatched
    children with (structs.py:1748)."""
    return time.time()


def generate_uuids(n: int) -> List[str]:
    """``n`` ids from one entropy read."""
    hx = os.urandom(16 * n).hex()
    return [f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"
            for h in (hx[32 * i:32 * i + 32] for i in range(n))]


def _fast_copy(obj):
    """Shallow field copy (== dataclasses.replace with no changes) without
    re-running __init__."""
    cls = obj.__class__
    new = cls.__new__(cls)
    new.__dict__.update(obj.__dict__)
    return new


def alloc_usage_vec(alloc) -> Tuple[int, int, int, int]:
    """The one per-alloc usage basis, (cpu, memory_mb, disk_mb, iops)
    (structs.py:190): combined ``resources`` when present,
    ``shared_resources`` plus the per-task resources otherwise.  The
    state store's usage-delta feed and the resident mirror's guard walk
    (``ops/resident.py``) both use it; ``ops/encode.alloc_usage`` is its
    numpy twin."""
    r = alloc.resources
    if r is not None:
        return (r.cpu, r.memory_mb, r.disk_mb, r.iops)
    cpu = mem = disk = iops = 0
    sr = alloc.shared_resources
    if sr is not None:
        cpu, mem, disk, iops = sr.cpu, sr.memory_mb, sr.disk_mb, sr.iops
    for tr in alloc.task_resources.values():
        cpu += tr.cpu
        mem += tr.memory_mb
        disk += tr.disk_mb
        iops += tr.iops
    return (cpu, mem, disk, iops)


@dataclass
class Port:
    label: str = ""
    value: int = 0


@dataclass
class NetworkResource:
    """A network interface, or a bandwidth and port ask
    (structs.go:1071-1158)."""

    device: str = ""
    cidr: str = ""
    ip: str = ""
    mbits: int = 0
    reserved_ports: List[Port] = field(default_factory=list)
    dynamic_ports: List[Port] = field(default_factory=list)

    def copy(self) -> "NetworkResource":
        return NetworkResource(
            device=self.device, cidr=self.cidr, ip=self.ip, mbits=self.mbits,
            reserved_ports=[Port(p.label, p.value)
                            for p in self.reserved_ports],
            dynamic_ports=[Port(p.label, p.value)
                           for p in self.dynamic_ports])

    def add(self, delta: "NetworkResource") -> None:
        self.reserved_ports.extend(Port(p.label, p.value)
                                   for p in delta.reserved_ports)
        self.mbits += delta.mbits


@dataclass
class Resources:
    """Resource ask or capacity; column order of the tensors is
    ``TENSOR_DIMS`` (structs.go:900-1069)."""

    cpu: int = 0
    memory_mb: int = 0
    disk_mb: int = 0
    iops: int = 0
    networks: List[NetworkResource] = field(default_factory=list)

    TENSOR_DIMS = ("cpu", "memory_mb", "disk_mb", "iops")

    def copy(self) -> "Resources":
        return Resources(cpu=self.cpu, memory_mb=self.memory_mb,
                         disk_mb=self.disk_mb, iops=self.iops,
                         networks=[n.copy() for n in self.networks])

    def net_index(self, n: NetworkResource) -> int:
        """Index of the first network with the same device, the empty
        device included (structs.go:1012)."""
        for idx, existing in enumerate(self.networks):
            if existing.device == n.device:
                return idx
        return -1

    def superset(self, other: "Resources") -> Tuple[bool, str]:
        """Whether self >= other on every scalar dimension; the exhausted
        dimension's name otherwise (structs.go:1024-1040)."""
        if self.cpu < other.cpu:
            return False, "cpu exhausted"
        if self.memory_mb < other.memory_mb:
            return False, "memory exhausted"
        if self.disk_mb < other.disk_mb:
            return False, "disk exhausted"
        if self.iops < other.iops:
            return False, "iops exhausted"
        return True, ""

    def add(self, delta: Optional["Resources"]) -> None:
        """Accumulate ``delta``, merging networks by device
        (structs.go:1042)."""
        if delta is None:
            return
        self.cpu += delta.cpu
        self.memory_mb += delta.memory_mb
        self.disk_mb += delta.disk_mb
        self.iops += delta.iops
        for n in delta.networks:
            idx = self.net_index(n)
            if idx == -1:
                self.networks.append(n.copy())
            else:
                self.networks[idx].add(n)

    def as_tuple(self) -> Tuple[int, int, int, int]:
        return (self.cpu, self.memory_mb, self.disk_mb, self.iops)


@dataclass
class Node:
    """A fingerprinted client machine (structs.go:756-898)."""

    id: str = ""
    datacenter: str = "dc1"
    name: str = ""
    attributes: Dict[str, str] = field(default_factory=dict)
    resources: Resources = field(default_factory=Resources)
    reserved: Optional[Resources] = None
    meta: Dict[str, str] = field(default_factory=dict)
    node_class: str = ""
    computed_class: str = ""
    drain: bool = False
    status: str = NODE_STATUS_INIT
    status_description: str = ""
    create_index: int = 0
    modify_index: int = 0

    def terminal_status(self) -> bool:
        """The node is down: allocs on it are lost (structs.go:888)."""
        return self.status == NODE_STATUS_DOWN

    def ready(self) -> bool:
        return self.status == NODE_STATUS_READY and not self.drain

    def compute_class(self) -> None:
        from .node_class import compute_node_class

        self.computed_class = compute_node_class(self)

    def copy(self) -> "Node":
        n = _fast_copy(self)
        n.attributes = dict(self.attributes)
        n.meta = dict(self.meta)
        n.resources = self.resources.copy()
        n.reserved = self.reserved.copy() if self.reserved else None
        return n


@dataclass
class Constraint:
    """A scheduling constraint (structs.go:3296-3349)."""

    ltarget: str = ""
    rtarget: str = ""
    operand: str = "="

    def copy(self) -> "Constraint":
        return Constraint(self.ltarget, self.rtarget, self.operand)

    def __str__(self) -> str:
        return f"{self.ltarget} {self.operand} {self.rtarget}"


@dataclass
class EphemeralDisk:
    """Shared task-group disk ask (structs.go:3357-3409)."""

    sticky: bool = False
    size_mb: int = 300
    migrate: bool = False

    def copy(self) -> "EphemeralDisk":
        return _fast_copy(self)


@dataclass
class UpdateStrategy:
    """Rolling-update policy (structs.go:1702-1716)."""

    stagger: float = 0.0  # seconds between rolling batches
    max_parallel: int = 0

    def rolling(self) -> bool:
        return self.stagger > 0 and self.max_parallel > 0

    def copy(self) -> "UpdateStrategy":
        return _fast_copy(self)


@dataclass
class PeriodicConfig:
    """Cron-style periodic launch config (structs.go:1726-1810)."""

    enabled: bool = False
    spec: str = ""
    spec_type: str = PERIODIC_SPEC_CRON
    prohibit_overlap: bool = False

    def copy(self) -> "PeriodicConfig":
        return _fast_copy(self)

    def next(self, from_time: float) -> float:
        """The next launch strictly after ``from_time``, or 0 if none.  A
        test spec is a comma-separated list of unix times."""
        if self.spec_type == PERIODIC_SPEC_CRON:
            from ..utils.cron import cron_next

            return cron_next(self.spec, from_time)
        if self.spec_type == PERIODIC_SPEC_TEST:
            for part in self.spec.split(","):
                part = part.strip()
                if not part:
                    continue
                t = float(part)
                if t > from_time:
                    return t
            return 0.0
        return 0.0


@dataclass
class ParameterizedJobConfig:
    """A dispatchable job's config (structs.py:462): ``payload`` is
    ``required``, ``optional`` or ``forbidden``; the dispatch meta keys
    must cover ``meta_required`` and stay within it and
    ``meta_optional``."""

    payload: str = ""
    meta_required: List[str] = field(default_factory=list)
    meta_optional: List[str] = field(default_factory=list)

    def copy(self) -> "ParameterizedJobConfig":
        return ParameterizedJobConfig(self.payload, list(self.meta_required),
                                      list(self.meta_optional))


@dataclass
class DispatchPayloadConfig:
    """Where a task finds a dispatched job's payload (structs.py:568)."""

    file: str = ""

    def copy(self) -> "DispatchPayloadConfig":
        return _fast_copy(self)


@dataclass
class Task:
    """A unit of work run by a driver (structs.go:2616-2790).  ``vault``,
    ``templates`` and ``artifacts`` are plain data here: the scheduler
    only compares them (``scheduler/util.tasks_updated``)."""

    name: str = ""
    driver: str = ""
    user: str = ""
    config: Dict[str, Any] = field(default_factory=dict)
    env: Dict[str, str] = field(default_factory=dict)
    vault: Optional[Dict[str, Any]] = None
    templates: List[Dict[str, Any]] = field(default_factory=list)
    constraints: List[Constraint] = field(default_factory=list)
    resources: Resources = field(default_factory=Resources)
    meta: Dict[str, str] = field(default_factory=dict)
    artifacts: List[Dict[str, Any]] = field(default_factory=list)
    dispatch_payload: Optional[DispatchPayloadConfig] = None

    def copy(self) -> "Task":
        return Task(
            name=self.name, driver=self.driver, user=self.user,
            config=dict(self.config), env=dict(self.env),
            vault=dict(self.vault) if self.vault is not None else None,
            templates=[dict(t) for t in self.templates],
            constraints=[c.copy() for c in self.constraints],
            resources=self.resources.copy(), meta=dict(self.meta),
            artifacts=[dict(a) for a in self.artifacts],
            dispatch_payload=(self.dispatch_payload.copy()
                              if self.dispatch_payload else None))


@dataclass
class TaskGroup:
    """A colocated set of tasks; the scheduler's placement unit
    (structs.go:2130-2248)."""

    name: str = ""
    count: int = 1
    constraints: List[Constraint] = field(default_factory=list)
    tasks: List[Task] = field(default_factory=list)
    ephemeral_disk: EphemeralDisk = field(default_factory=EphemeralDisk)
    meta: Dict[str, str] = field(default_factory=dict)

    def copy(self) -> "TaskGroup":
        return TaskGroup(
            name=self.name, count=self.count,
            constraints=[c.copy() for c in self.constraints],
            tasks=[t.copy() for t in self.tasks],
            ephemeral_disk=self.ephemeral_disk.copy(), meta=dict(self.meta))

    def lookup_task(self, name: str) -> Optional[Task]:
        for t in self.tasks:
            if t.name == name:
                return t
        return None


@dataclass
class Job:
    """A declarative workload specification (structs.go:1189-1560)."""

    region: str = "global"
    namespace: str = DEFAULT_NAMESPACE
    id: str = ""
    parent_id: str = ""
    name: str = ""
    type: str = JOB_TYPE_SERVICE
    priority: int = JOB_DEFAULT_PRIORITY
    all_at_once: bool = False
    datacenters: List[str] = field(default_factory=list)
    constraints: List[Constraint] = field(default_factory=list)
    task_groups: List[TaskGroup] = field(default_factory=list)
    update: UpdateStrategy = field(default_factory=UpdateStrategy)
    periodic: Optional[PeriodicConfig] = None
    parameterized_job: Optional[ParameterizedJobConfig] = None
    payload: bytes = b""
    meta: Dict[str, str] = field(default_factory=dict)
    status: str = JOB_STATUS_PENDING
    status_description: str = ""
    stop: bool = False
    version: int = 0
    create_index: int = 0
    modify_index: int = 0
    job_modify_index: int = 0

    def copy(self) -> "Job":
        j = _fast_copy(self)
        j.datacenters = list(self.datacenters)
        j.constraints = [c.copy() for c in self.constraints]
        j.task_groups = [tg.copy() for tg in self.task_groups]
        j.update = self.update.copy()
        j.periodic = self.periodic.copy() if self.periodic else None
        j.parameterized_job = (self.parameterized_job.copy()
                               if self.parameterized_job else None)
        j.meta = dict(self.meta)
        return j

    def stopped(self) -> bool:
        return self.stop

    def is_periodic(self) -> bool:
        return self.periodic is not None and self.periodic.enabled

    def is_parameterized(self) -> bool:
        return self.parameterized_job is not None

    def lookup_task_group(self, name: str) -> Optional[TaskGroup]:
        for tg in self.task_groups:
            if tg.name == name:
                return tg
        return None

    def validate(self) -> List[str]:
        """Structural problems, empty when none (structs.go:1334
        Job.Validate; the vault checks of the reference have no fields
        here)."""
        problems: List[str] = []
        if not self.region:
            problems.append("job region is empty")
        if not self.id:
            problems.append("job ID is empty")
        if not self.name:
            problems.append("job name is empty")
        if self.type not in (JOB_TYPE_SERVICE, JOB_TYPE_BATCH,
                             JOB_TYPE_SYSTEM):
            problems.append(f"job type '{self.type}' is invalid")
        if not JOB_MIN_PRIORITY <= self.priority <= JOB_MAX_PRIORITY:
            problems.append(f"job priority must be between "
                            f"[{JOB_MIN_PRIORITY}, {JOB_MAX_PRIORITY}]")
        if not self.datacenters:
            problems.append("job must specify at least one datacenter")
        if not self.task_groups:
            problems.append("job must have at least one task group")
        seen: set = set()
        for tg in self.task_groups:
            if not tg.name:
                problems.append("task group name is empty")
            if tg.name in seen:
                problems.append(
                    f"task group '{tg.name}' defined more than once")
            seen.add(tg.name)
            if tg.count < 0:
                problems.append(f"task group '{tg.name}' has negative count")
            if self.type == JOB_TYPE_SYSTEM and tg.count not in (0, 1):
                problems.append(f"system job task group '{tg.name}' should "
                                f"have count 1, not {tg.count}")
            if not tg.tasks:
                problems.append(f"task group '{tg.name}' has no tasks")
            tseen: set = set()
            for task in tg.tasks:
                if not task.name:
                    problems.append(f"task name empty in group '{tg.name}'")
                if task.name in tseen:
                    problems.append(
                        f"task '{task.name}' defined more than once")
                tseen.add(task.name)
                if not task.driver:
                    problems.append(
                        f"task '{task.name}' must specify a driver")
        if self.type == JOB_TYPE_SYSTEM and self.is_periodic():
            problems.append("periodic is not allowed on system jobs")
        return problems

    def canonicalize(self) -> None:
        """Fill defaults (structs.go:1286 Job.Canonicalize)."""
        if not self.name:
            self.name = self.id
        if not self.region:
            self.region = "global"
        if not self.namespace:
            self.namespace = DEFAULT_NAMESPACE
        if not self.datacenters:
            self.datacenters = ["dc1"]
        for tg in self.task_groups:
            if tg.count == 0 and self.type != JOB_TYPE_SYSTEM:
                tg.count = 1


@dataclass
class TaskEvent:
    """The part of a task event that decides success (structs.go:3030)."""

    type: str = ""
    exit_code: int = 0

    def copy(self) -> "TaskEvent":
        return _fast_copy(self)


@dataclass
class TaskState:
    """Client-side task state (structs.go:2928-3010)."""

    state: str = TASK_STATE_PENDING
    events: List[TaskEvent] = field(default_factory=list)

    def copy(self) -> "TaskState":
        t = _fast_copy(self)
        t.events = [e.copy() for e in self.events]
        return t

    def successful(self) -> bool:
        """The task is dead and its terminating event did not fail
        (structs.go:2980)."""
        if self.state != TASK_STATE_DEAD or not self.events:
            return False
        last = self.events[-1]
        return last.type == TASK_TERMINATED and last.exit_code == 0


@dataclass
class AllocMetric:
    """Placement forensics surfaced in alloc-status (structs.go:4074-4172):
    the batch scheduler fills them from the device pass's side outputs."""

    nodes_evaluated: int = 0
    nodes_filtered: int = 0
    nodes_available: Dict[str, int] = field(default_factory=dict)
    class_filtered: Dict[str, int] = field(default_factory=dict)
    constraint_filtered: Dict[str, int] = field(default_factory=dict)
    nodes_exhausted: int = 0
    class_exhausted: Dict[str, int] = field(default_factory=dict)
    dimension_exhausted: Dict[str, int] = field(default_factory=dict)
    scores: Dict[str, float] = field(default_factory=dict)
    allocation_time: float = 0.0
    coalesced_failures: int = 0

    def copy(self) -> "AllocMetric":
        m = _fast_copy(self)
        m.nodes_available = dict(self.nodes_available)
        m.class_filtered = dict(self.class_filtered)
        m.constraint_filtered = dict(self.constraint_filtered)
        m.class_exhausted = dict(self.class_exhausted)
        m.dimension_exhausted = dict(self.dimension_exhausted)
        m.scores = dict(self.scores)
        return m

    def evaluate_node(self) -> None:
        self.nodes_evaluated += 1

    def filter_node(self, node: Optional[Node], constraint: str) -> None:
        self.nodes_filtered += 1
        if node is not None and node.node_class:
            self.class_filtered[node.node_class] = (
                self.class_filtered.get(node.node_class, 0) + 1)
        if constraint:
            self.constraint_filtered[constraint] = (
                self.constraint_filtered.get(constraint, 0) + 1)

    def exhausted_node(self, node: Optional[Node], dimension: str) -> None:
        self.nodes_exhausted += 1
        if node is not None and node.node_class:
            self.class_exhausted[node.node_class] = (
                self.class_exhausted.get(node.node_class, 0) + 1)
        if dimension:
            self.dimension_exhausted[dimension] = (
                self.dimension_exhausted.get(dimension, 0) + 1)

    def score_node(self, node: Node, name: str, score: float) -> None:
        key = f"{node.id}.{name}"
        self.scores[key] = self.scores.get(key, 0.0) + score


@dataclass
class Allocation:
    """A placed task group on a node (structs.go:3820-4070)."""

    id: str = ""
    namespace: str = DEFAULT_NAMESPACE
    eval_id: str = ""
    name: str = ""
    node_id: str = ""
    job_id: str = ""
    job: Optional[Job] = None
    task_group: str = ""
    resources: Optional[Resources] = None
    shared_resources: Optional[Resources] = None
    task_resources: Dict[str, Resources] = field(default_factory=dict)
    metrics: Optional[AllocMetric] = None
    desired_status: str = ALLOC_DESIRED_STATUS_RUN
    desired_description: str = ""
    client_status: str = ALLOC_CLIENT_STATUS_PENDING
    client_description: str = ""
    task_states: Dict[str, TaskState] = field(default_factory=dict)
    previous_allocation: str = ""
    create_index: int = 0
    modify_index: int = 0
    alloc_modify_index: int = 0

    def copy(self) -> "Allocation":
        a = _fast_copy(self)
        a.job = self.job.copy() if self.job else None
        a.resources = self.resources.copy() if self.resources else None
        a.shared_resources = (self.shared_resources.copy()
                              if self.shared_resources else None)
        a.task_resources = {k: v.copy()
                            for k, v in self.task_resources.items()}
        a.metrics = self.metrics.copy() if self.metrics else None
        a.task_states = {k: v.copy() for k, v in self.task_states.items()}
        return a

    def terminal_status(self) -> bool:
        """Desired stop/evict, else a terminal client status
        (structs.go:3945)."""
        if self.desired_status in (ALLOC_DESIRED_STATUS_STOP,
                                   ALLOC_DESIRED_STATUS_EVICT):
            return True
        return self.client_status in (ALLOC_CLIENT_STATUS_COMPLETE,
                                      ALLOC_CLIENT_STATUS_FAILED,
                                      ALLOC_CLIENT_STATUS_LOST)

    def client_terminal_status(self) -> bool:
        return self.client_status in (ALLOC_CLIENT_STATUS_COMPLETE,
                                      ALLOC_CLIENT_STATUS_FAILED,
                                      ALLOC_CLIENT_STATUS_LOST)

    def ran_successfully(self) -> bool:
        """Every task finished successfully (structs.go:3974)."""
        if not self.task_states:
            return False
        return all(ts.successful() for ts in self.task_states.values())


@dataclass
class Evaluation:
    """A scheduling work item: 'job X needs reconciling'
    (structs.go:4244-4475)."""

    id: str = ""
    namespace: str = DEFAULT_NAMESPACE
    priority: int = JOB_DEFAULT_PRIORITY
    type: str = JOB_TYPE_SERVICE
    triggered_by: str = ""
    job_id: str = ""
    job_modify_index: int = 0
    node_id: str = ""
    node_modify_index: int = 0
    status: str = EVAL_STATUS_PENDING
    status_description: str = ""
    wait: float = 0.0  # seconds to delay before processing
    next_eval: str = ""
    previous_eval: str = ""
    blocked_eval: str = ""
    failed_tg_allocs: Dict[str, AllocMetric] = field(default_factory=dict)
    class_eligibility: Dict[str, bool] = field(default_factory=dict)
    escaped_computed_class: bool = False
    annotate_plan: bool = False
    queued_allocations: Dict[str, int] = field(default_factory=dict)
    snapshot_index: int = 0
    create_index: int = 0
    modify_index: int = 0

    def copy(self) -> "Evaluation":
        e = _fast_copy(self)
        e.failed_tg_allocs = {k: v.copy()
                              for k, v in self.failed_tg_allocs.items()}
        e.class_eligibility = dict(self.class_eligibility)
        e.queued_allocations = dict(self.queued_allocations)
        return e

    def terminal_status(self) -> bool:
        return self.status in (EVAL_STATUS_COMPLETE, EVAL_STATUS_FAILED,
                               EVAL_STATUS_CANCELLED)

    def trigger_index(self) -> int:
        """The lowest applied index a snapshot must cover for a
        scheduler to see what this eval was created about: the job
        write, the node transition, or the capacity change or previous
        attempt in ``snapshot_index`` (raised to the unblock index by
        ``BlockedEvals``).  Read by the worker's snapshot fence and the
        broker's coalescing guard."""
        return max(self.job_modify_index, self.node_modify_index,
                   self.snapshot_index)

    def should_enqueue(self) -> bool:
        """The eval belongs in the broker's ready queue
        (structs.go:4404)."""
        return self.status == EVAL_STATUS_PENDING

    def should_block(self) -> bool:
        return self.status == EVAL_STATUS_BLOCKED

    def make_plan(self, job: Optional[Job]) -> "Plan":
        """An empty plan for this eval (structs.go:4418 MakePlan)."""
        plan = Plan(eval_id=self.id, priority=self.priority, job=job,
                    node_update={}, node_allocation={})
        if job is not None:
            plan.all_at_once = job.all_at_once
        return plan

    def next_rolling_eval(self, wait: float) -> "Evaluation":
        """Follow-up eval for a rolling update (structs.go:4440)."""
        return Evaluation(
            id=generate_uuid(), namespace=self.namespace,
            priority=self.priority, type=self.type,
            triggered_by=EVAL_TRIGGER_ROLLING_UPDATE, job_id=self.job_id,
            job_modify_index=self.job_modify_index,
            status=EVAL_STATUS_PENDING, wait=wait, previous_eval=self.id)

    def create_blocked_eval(self, class_eligibility: Dict[str, bool],
                            escaped: bool) -> "Evaluation":
        """Blocked eval to retry placement when capacity appears
        (structs.go:4494 CreateBlockedEval)."""
        return Evaluation(
            id=generate_uuid(), namespace=self.namespace,
            priority=self.priority, type=self.type,
            triggered_by=self.triggered_by, job_id=self.job_id,
            job_modify_index=self.job_modify_index,
            status=EVAL_STATUS_BLOCKED, previous_eval=self.id,
            class_eligibility=class_eligibility,
            escaped_computed_class=escaped)


def preemption_follow_up_evals(
    preempted: List["Allocation"], snapshot_index: int, job_lookup=None,
) -> List["Evaluation"]:
    """One BLOCKED follow-up eval per distinct evicted job, so preempted
    work re-enters the scheduler when capacity appears.  ``job_lookup``
    (job_id -> Job) recovers priority and type; plan copies strip the
    job."""
    seen: Dict[str, Evaluation] = {}
    for alloc in preempted:
        if alloc.job_id in seen:
            continue
        job = alloc.job
        if job is None and job_lookup is not None:
            job = job_lookup(alloc.job_id)
        seen[alloc.job_id] = Evaluation(
            id=generate_uuid(),
            priority=job.priority if job is not None else JOB_DEFAULT_PRIORITY,
            type=job.type if job is not None else JOB_TYPE_SERVICE,
            triggered_by=EVAL_TRIGGER_PREEMPTION, job_id=alloc.job_id,
            status=EVAL_STATUS_BLOCKED, status_description=ALLOC_PREEMPTED,
            snapshot_index=snapshot_index)
    return list(seen.values())


class _LazyStrs:
    """A lazily generated string column for AllocSlab: values are
    formulaic (prefix + ordinal) and made only when read.  The batch
    scheduler commits tens of thousands of slab allocs a pass, and most
    ids and names are never read one by one."""

    __slots__ = ("n",)

    def __init__(self, n: int) -> None:
        self.n = n

    def _make(self, i: int) -> str:
        raise NotImplementedError

    def __len__(self) -> int:
        return self.n

    def __bool__(self) -> bool:
        return self.n > 0

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._make(j) for j in range(*i.indices(self.n))]
        if i < 0:
            i += self.n
        if not 0 <= i < self.n:
            raise IndexError(i)
        return self._make(i)

    def __iter__(self):
        make = self._make
        return (make(i) for i in range(self.n))


class LazyUuids(_LazyStrs):
    """Formulaic uuid column: one random uuid prefix (its first 24
    characters) + the ordinal as the last 12 hex digits, still a
    canonical 36-character uuid."""

    __slots__ = ("prefix",)

    def __init__(self, n: int, prefix: Optional[str] = None) -> None:
        super().__init__(n)
        # A restored column keeps the prefix it was written with.
        self.prefix = generate_uuid()[:24] if prefix is None else prefix

    def _make(self, i: int) -> str:
        return f"{self.prefix}{i:012x}"


class LazyNames(_LazyStrs):
    """Formulaic alloc names '<job>.<tg>[i]' (util.go:22)."""

    __slots__ = ("prefix",)

    def __init__(self, n: int, prefix: str) -> None:
        super().__init__(n)
        self.prefix = prefix

    def _make(self, i: int) -> str:
        return f"{self.prefix}[{i}]"


@dataclass
class AllocSlab:
    """Columnar batch of placements sharing one prototype allocation: the
    prototype is stored once, the per-alloc columns (id, name, node,
    previous alloc) beside it, and Allocation objects are made only when
    read.  ``prev_ids`` uses "" for "no previous allocation"."""

    proto: Optional[Allocation] = None
    ids: List[str] = field(default_factory=list)
    names: List[str] = field(default_factory=list)
    node_ids: List[str] = field(default_factory=list)
    prev_ids: List[str] = field(default_factory=list)
    create_index: int = 0
    modify_index: int = 0

    def __len__(self) -> int:
        return len(self.ids)

    def materialize(self, i: int) -> Allocation:
        a = _fast_copy(self.proto)
        a.id = self.ids[i]
        a.name = self.names[i]
        a.node_id = self.node_ids[i]
        if self.prev_ids and self.prev_ids[i]:
            a.previous_allocation = self.prev_ids[i]
        a.create_index = self.create_index
        a.modify_index = self.modify_index
        a.alloc_modify_index = self.modify_index
        return a

    def id_index(self, alloc_id: str) -> int:
        """Column index of an alloc id; the reverse map is built on the
        first by-id read."""
        idx = getattr(self, "_id_idx", None)
        if idx is None:
            idx = {aid: i for i, aid in enumerate(self.ids)}
            self._id_idx = idx
        return idx[alloc_id]

    def node_counts(self) -> Dict[str, int]:
        """Placements per node."""
        counts: Dict[str, int] = {}
        for nid in self.node_ids:
            counts[nid] = counts.get(nid, 0) + 1
        return counts

    def filter_nodes(self, keep: set) -> "AllocSlab":
        """The slab restricted to its placements on ``keep`` nodes (a
        partial plan commit, plan_apply.go:242)."""
        idx = [i for i, nid in enumerate(self.node_ids) if nid in keep]
        return AllocSlab(
            proto=self.proto,
            ids=[self.ids[i] for i in idx],
            names=[self.names[i] for i in idx],
            node_ids=[self.node_ids[i] for i in idx],
            prev_ids=[self.prev_ids[i] for i in idx] if self.prev_ids else [],
            create_index=self.create_index,
            modify_index=self.modify_index,
        )


@dataclass
class Namespace:
    """A tenant: quota and fairness configuration, registered through the
    log like jobs and carried by the snapshot (structs.py:1275).  Every
    quota field uses 0 for unlimited, so a namespace made with bare
    defaults throttles nothing."""

    name: str = ""
    description: str = ""
    quota_node_units: float = 0.0
    max_live_allocs: int = 0
    max_pending_evals: int = 0
    api_rate: float = 0.0
    api_burst: int = 0
    dequeue_weight: float = 1.0
    objective: str = ""
    create_index: int = 0
    modify_index: int = 0

    def copy(self) -> "Namespace":
        return _fast_copy(self)

    def validate(self) -> List[str]:
        """Problems of the row, empty when none (structs.py:1308)."""
        problems: List[str] = []
        if not self.name:
            problems.append("namespace name is empty")
        if self.dequeue_weight <= 0:
            problems.append("namespace dequeue_weight must be positive")
        if self.objective and self.objective not in TENANCY_OBJECTIVES:
            problems.append(
                f"namespace objective '{self.objective}' is invalid "
                f"(want one of {', '.join(TENANCY_OBJECTIVES)})")
        if (self.quota_node_units < 0 or self.max_live_allocs < 0
                or self.max_pending_evals < 0 or self.api_rate < 0
                or self.api_burst < 0):
            problems.append("namespace quota fields must be >= 0")
        return problems


@dataclass
class DesiredUpdates:
    ignore: int = 0
    place: int = 0
    migrate: int = 0
    stop: int = 0
    in_place_update: int = 0
    destructive_update: int = 0


@dataclass
class PlanAnnotations:
    """Dry-run plan annotations (structs.go:4625)."""

    desired_tg_updates: Dict[str, DesiredUpdates] = field(
        default_factory=dict)


# Job diff wire types (structs.go:1601-1662; the diff engine is
# structs/diff.py).

DIFF_TYPE_NONE = "None"
DIFF_TYPE_ADDED = "Added"
DIFF_TYPE_DELETED = "Deleted"
DIFF_TYPE_EDITED = "Edited"


@dataclass
class FieldDiff:
    type: str = DIFF_TYPE_NONE
    name: str = ""
    old: str = ""
    new: str = ""
    annotations: List[str] = field(default_factory=list)


@dataclass
class ObjectDiff:
    type: str = DIFF_TYPE_NONE
    name: str = ""
    fields: List[FieldDiff] = field(default_factory=list)
    objects: List["ObjectDiff"] = field(default_factory=list)


@dataclass
class TaskDiff:
    type: str = DIFF_TYPE_NONE
    name: str = ""
    fields: List[FieldDiff] = field(default_factory=list)
    objects: List[ObjectDiff] = field(default_factory=list)
    annotations: List[str] = field(default_factory=list)


@dataclass
class TaskGroupDiff:
    type: str = DIFF_TYPE_NONE
    name: str = ""
    fields: List[FieldDiff] = field(default_factory=list)
    objects: List[ObjectDiff] = field(default_factory=list)
    tasks: List[TaskDiff] = field(default_factory=list)
    updates: Dict[str, int] = field(default_factory=dict)


@dataclass
class JobDiff:
    type: str = DIFF_TYPE_NONE
    id: str = ""
    fields: List[FieldDiff] = field(default_factory=list)
    objects: List[ObjectDiff] = field(default_factory=list)
    task_groups: List[TaskGroupDiff] = field(default_factory=list)


@dataclass
class JobPlanResponse:
    """The dry run's result (structs.go JobPlanResponse): the annotated
    diff and the placement forensics; nothing is committed.  The port
    has no periodic jobs, so ``next_periodic_launch`` stays 0."""

    annotations: Optional[PlanAnnotations] = None
    failed_tg_allocs: Dict[str, AllocMetric] = field(default_factory=dict)
    job_modify_index: int = 0
    created_evals: List[Evaluation] = field(default_factory=list)
    diff: Optional[JobDiff] = None
    next_periodic_launch: float = 0.0


@dataclass
class Plan:
    """The scheduler's proposed state change, submitted for optimistic
    apply (structs.go:4477-4570)."""

    eval_id: str = ""
    # The broker token of the eval's delivery (fencing), and the applied
    # index of the snapshot the scheduler planned on (the applier samples
    # the plan's staleness from it).
    eval_token: str = ""
    snapshot_index: int = 0
    priority: int = 0
    all_at_once: bool = False
    job: Optional[Job] = None
    node_update: Dict[str, List[Allocation]] = field(default_factory=dict)
    node_allocation: Dict[str, List[Allocation]] = field(
        default_factory=dict)
    alloc_slabs: List[AllocSlab] = field(default_factory=list)
    # Evictions of lower-priority allocs this plan makes room with
    # (scheduler/preempt.py), committed with the placements.
    node_preemptions: Dict[str, List[Allocation]] = field(
        default_factory=dict)
    annotations: Optional[PlanAnnotations] = None

    def append_update(self, alloc: Allocation, desired_status: str,
                      desired_description: str,
                      client_status: str = "") -> None:
        """Mark an existing alloc for stop/evict (structs.go:4520
        AppendUpdate).  A plan without a job (deregistration) adopts the
        alloc's; the staged copy drops its job and combined resources."""
        new_alloc = alloc.copy()
        if self.job is None and new_alloc.job is not None:
            self.job = new_alloc.job
        new_alloc.job = None
        new_alloc.resources = None
        new_alloc.desired_status = desired_status
        new_alloc.desired_description = desired_description
        if client_status:
            new_alloc.client_status = client_status
        self.node_update.setdefault(alloc.node_id, []).append(new_alloc)

    def pop_update(self, alloc: Allocation) -> None:
        """Remove a staged eviction (in-place update speculation,
        structs.go:4546 PopUpdate)."""
        updates = self.node_update.get(alloc.node_id, [])
        if updates and updates[-1].id == alloc.id:
            updates.pop()
            if not updates:
                self.node_update.pop(alloc.node_id, None)

    def append_alloc(self, alloc: Allocation) -> None:
        self.node_allocation.setdefault(alloc.node_id, []).append(alloc)

    def append_preempted_alloc(self, alloc: Allocation) -> None:
        """Stage an eviction that makes room for a higher-priority
        placement; the copy keeps the victim's modify_index."""
        new_alloc = alloc.copy()
        new_alloc.job = None
        new_alloc.resources = None
        new_alloc.desired_status = ALLOC_DESIRED_STATUS_EVICT
        new_alloc.desired_description = ALLOC_PREEMPTED
        self.node_preemptions.setdefault(alloc.node_id, []).append(new_alloc)

    def append_slab(self, slab: AllocSlab) -> None:
        self.alloc_slabs.append(slab)

    def is_no_op(self) -> bool:
        return (not self.node_update and not self.node_allocation
                and not self.alloc_slabs and not self.node_preemptions)


@dataclass
class PlanResult:
    """The part of a plan that was committed (structs.go:4581-4620)."""

    node_update: Dict[str, List[Allocation]] = field(default_factory=dict)
    node_allocation: Dict[str, List[Allocation]] = field(
        default_factory=dict)
    alloc_slabs: List[AllocSlab] = field(default_factory=list)
    node_preemptions: Dict[str, List[Allocation]] = field(
        default_factory=dict)
    refresh_index: int = 0
    alloc_index: int = 0

    def full_commit(self, plan: Plan) -> Tuple[bool, int, int]:
        """Whether every proposed alloc was committed (structs.go:4604)."""
        expected = 0
        actual = 0
        for node, allocs in plan.node_update.items():
            expected += len(allocs)
            actual += len(self.node_update.get(node, []))
        for node, allocs in plan.node_allocation.items():
            expected += len(allocs)
            actual += len(self.node_allocation.get(node, []))
        for node, allocs in plan.node_preemptions.items():
            expected += len(allocs)
            actual += len(self.node_preemptions.get(node, []))
        expected += sum(len(sl) for sl in plan.alloc_slabs)
        actual += sum(len(sl) for sl in self.alloc_slabs)
        return actual == expected, expected, actual


@dataclass
class TaskGroupSummary:
    """Per-task-group alloc status counts (structs.go:1680-1700)."""

    queued: int = 0
    complete: int = 0
    failed: int = 0
    running: int = 0
    starting: int = 0
    lost: int = 0

    def copy(self) -> "TaskGroupSummary":
        return _fast_copy(self)


@dataclass
class JobSummary:
    """Per-job alloc summary (structs.go:1640-1678); a periodic or
    parameterized parent also counts its children by status."""

    job_id: str = ""
    summary: Dict[str, TaskGroupSummary] = field(default_factory=dict)
    children: Optional["JobChildrenSummary"] = None
    create_index: int = 0
    modify_index: int = 0

    def copy(self) -> "JobSummary":
        j = _fast_copy(self)
        j.summary = {k: v.copy() for k, v in self.summary.items()}
        j.children = (dataclasses.replace(self.children)
                      if self.children else None)
        return j


@dataclass
class JobChildrenSummary:
    """A parent job's children by status (structs.py:1700)."""

    pending: int = 0
    running: int = 0
    dead: int = 0


# -- cluster event stream (reference: nomad/stream, the 1.0 event broker) ----

TOPIC_NODE = "Node"
TOPIC_JOB = "Job"
TOPIC_EVAL = "Eval"
TOPIC_ALLOC = "Alloc"
TOPIC_DEPLOYMENT = "Deployment"
TOPIC_PLAN = "Plan"
TOPIC_BREAKER = "Breaker"
TOPIC_FAULT = "Fault"
TOPIC_NAMESPACE = "Namespace"

EVENT_TOPICS = (TOPIC_NODE, TOPIC_JOB, TOPIC_EVAL, TOPIC_ALLOC,
                TOPIC_DEPLOYMENT, TOPIC_PLAN, TOPIC_BREAKER, TOPIC_FAULT,
                TOPIC_NAMESPACE)


@dataclass
class Event:
    """One structured state-change event (structs/event.go Event): a
    (topic, type, key) triple stamped with the raft index of the write
    that produced it, a payload stub, and — when the write happened
    under a traced span — the correlating eval/span ids from the
    tracing plane, so an event timeline joins against
    ``trace_for_eval``."""

    topic: str = ""
    type: str = ""
    key: str = ""
    index: int = 0
    payload: Dict[str, object] = field(default_factory=dict)
    eval_id: str = ""
    span_id: int = 0
    wall: float = 0.0

    def to_wire_dict(self) -> Dict[str, object]:
        return {"Topic": self.topic, "Type": self.type, "Key": self.key,
                "Index": self.index, "Payload": self.payload,
                "EvalID": self.eval_id, "SpanID": self.span_id,
                "Wall": self.wall}
