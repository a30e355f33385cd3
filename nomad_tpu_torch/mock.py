"""Object-mother fixtures (``nomad_tpu/mock.py:14-120``; reference:
nomad/mock/mock.go), for ``chip_smoke.py`` and the tests."""
from __future__ import annotations

from .structs import structs as s


def node() -> s.Node:
    """A ready linux node with the exec driver (mock.go:9 Node)."""
    n = s.Node(
        id=s.generate_uuid(),
        datacenter="dc1",
        name="foobar",
        attributes={
            "kernel.name": "linux",
            "arch": "x86",
            "nomad.version": "0.5.0",
            "driver.exec": "1",
        },
        resources=s.Resources(
            cpu=4000, memory_mb=8192, disk_mb=100 * 1024, iops=150,
            networks=[s.NetworkResource(device="eth0",
                                        cidr="192.168.0.100/32",
                                        mbits=1000)]),
        reserved=s.Resources(
            cpu=100, memory_mb=256, disk_mb=4 * 1024,
            networks=[s.NetworkResource(device="eth0", ip="192.168.0.100",
                                        reserved_ports=[s.Port("main", 22)],
                                        mbits=1)]),
        meta={"pci-dss": "true", "database": "mysql", "version": "5.6"},
        node_class="linux-medium-pci",
        status=s.NODE_STATUS_READY,
    )
    n.compute_class()
    return n


def job() -> s.Job:
    """A 10-count service job with one web task (mock.go:62 Job)."""
    j = s.Job(
        region="global",
        id=s.generate_uuid(),
        name="my-job",
        type=s.JOB_TYPE_SERVICE,
        priority=50,
        datacenters=["dc1"],
        constraints=[s.Constraint("${attr.kernel.name}", "linux", "=")],
        task_groups=[s.TaskGroup(
            name="web",
            count=10,
            ephemeral_disk=s.EphemeralDisk(size_mb=150),
            tasks=[s.Task(
                name="web",
                driver="exec",
                resources=s.Resources(
                    cpu=500, memory_mb=256,
                    networks=[s.NetworkResource(
                        mbits=50,
                        dynamic_ports=[s.Port("http"), s.Port("admin")])]),
            )],
        )],
        status=s.JOB_STATUS_PENDING,
        version=0,
    )
    j.canonicalize()
    return j
