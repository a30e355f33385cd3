"""Host-side data model: the subset of ``nomad_tpu/structs/structs.py``
that batch placement reads.  Resource quantities are 4 scalar ints
(cpu, memory_mb, disk_mb, iops) so they lower directly to the int32
``[N, 4]`` / ``[U, 4]`` tensors in ``ops/encode.py``.
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

JOB_TYPE_SERVICE = "service"
JOB_TYPE_BATCH = "batch"
JOB_TYPE_SYSTEM = "system"

JOB_STATUS_PENDING = "pending"
JOB_DEFAULT_PRIORITY = 50

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

CONSTRAINT_DISTINCT_PROPERTY = "distinct_property"
CONSTRAINT_DISTINCT_HOSTS = "distinct_hosts"
CONSTRAINT_REGEX = "regexp"
CONSTRAINT_VERSION = "version"
CONSTRAINT_SET_CONTAINS = "set_contains"

# Meta/attribute keys in this namespace are excluded from the computed
# class (node_class.go).
NODE_UNIQUE_NAMESPACE = "unique."


def generate_uuid() -> str:
    h = os.urandom(16).hex()
    return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"


@dataclass
class Port:
    label: str = ""
    value: int = 0


@dataclass
class NetworkResource:
    device: str = ""
    cidr: str = ""
    ip: str = ""
    mbits: int = 0
    reserved_ports: List[Port] = field(default_factory=list)
    dynamic_ports: List[Port] = field(default_factory=list)


@dataclass
class Resources:
    """Resource ask or capacity; column order of the tensors is
    ``TENSOR_DIMS``."""

    cpu: int = 0
    memory_mb: int = 0
    disk_mb: int = 0
    iops: int = 0
    networks: List[NetworkResource] = field(default_factory=list)

    TENSOR_DIMS = ("cpu", "memory_mb", "disk_mb", "iops")

    def add(self, delta: Optional["Resources"]) -> None:
        """Accumulate the scalar dims of ``delta`` (networks are not
        accumulated: a spec with network asks is rejected before
        encoding)."""
        if delta is None:
            return
        self.cpu += delta.cpu
        self.memory_mb += delta.memory_mb
        self.disk_mb += delta.disk_mb
        self.iops += delta.iops

    def as_tuple(self):
        return (self.cpu, self.memory_mb, self.disk_mb, self.iops)


@dataclass
class Node:
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

    def ready(self) -> bool:
        return self.status == NODE_STATUS_READY and not self.drain

    def compute_class(self) -> None:
        """Hash of the non-unique identity (node_class.go:31): nodes of
        one class are interchangeable for feasibility."""
        h = hashlib.sha1()
        h.update(self.datacenter.encode())
        h.update(b"\x00")
        h.update(self.node_class.encode())
        h.update(b"\x00")
        for source in (self.attributes, self.meta):
            for key in sorted(source):
                if key.startswith(NODE_UNIQUE_NAMESPACE):
                    continue
                h.update(key.encode())
                h.update(b"\x01")
                h.update(str(source[key]).encode())
                h.update(b"\x02")
            h.update(b"\x03")
        self.computed_class = f"v1:{int.from_bytes(h.digest()[:8], 'big')}"


@dataclass
class Constraint:
    ltarget: str = ""
    rtarget: str = ""
    operand: str = "="

    def __str__(self) -> str:
        return f"{self.ltarget} {self.operand} {self.rtarget}"


@dataclass
class EphemeralDisk:
    sticky: bool = False
    size_mb: int = 300
    migrate: bool = False


@dataclass
class Task:
    name: str = ""
    driver: str = ""
    constraints: List[Constraint] = field(default_factory=list)
    resources: Resources = field(default_factory=Resources)


@dataclass
class TaskGroup:
    name: str = ""
    count: int = 1
    constraints: List[Constraint] = field(default_factory=list)
    tasks: List[Task] = field(default_factory=list)
    ephemeral_disk: EphemeralDisk = field(default_factory=EphemeralDisk)


@dataclass
class Job:
    region: str = "global"
    id: str = ""
    name: str = ""
    type: str = JOB_TYPE_SERVICE
    priority: int = JOB_DEFAULT_PRIORITY
    datacenters: List[str] = field(default_factory=list)
    constraints: List[Constraint] = field(default_factory=list)
    task_groups: List[TaskGroup] = field(default_factory=list)
    status: str = JOB_STATUS_PENDING
    version: int = 0

    def canonicalize(self) -> None:
        if not self.name:
            self.name = self.id
        if not self.datacenters:
            self.datacenters = ["dc1"]
        for tg in self.task_groups:
            if tg.count == 0 and self.type != JOB_TYPE_SYSTEM:
                tg.count = 1


@dataclass
class Allocation:
    """A placed task group on a node; only what usage accounting and the
    per-(job, node) collision counts read."""

    id: str = ""
    node_id: str = ""
    job_id: str = ""
    task_group: str = ""
    resources: Optional[Resources] = None
    shared_resources: Optional[Resources] = None
    task_resources: Dict[str, Resources] = field(default_factory=dict)
    desired_status: str = ALLOC_DESIRED_STATUS_RUN
    client_status: str = ALLOC_CLIENT_STATUS_PENDING

    def terminal_status(self) -> bool:
        if self.desired_status in (ALLOC_DESIRED_STATUS_STOP,
                                   ALLOC_DESIRED_STATUS_EVICT):
            return True
        return self.client_status in (ALLOC_CLIENT_STATUS_COMPLETE,
                                      ALLOC_CLIENT_STATUS_FAILED,
                                      ALLOC_CLIENT_STATUS_LOST)
