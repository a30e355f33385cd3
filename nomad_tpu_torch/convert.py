"""Carry state across from the reference package without importing it.

``node_from_dict``/``job_from_dict``/``alloc_from_dict`` take the plain
dicts that ``dataclasses.asdict`` makes of ``nomad_tpu``'s structs (keys
this port does not model are ignored).  ``device_inputs_from_buffers``
takes the reference path's static and dynamic upload dicts, as numpy
arrays under their key names, and returns the port's packed device
buffers, so that both fused passes compute on identical inputs.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .device import resolve_device
from .ops import xfer
from .structs import structs as s


def _res(d: Optional[dict]) -> Optional[s.Resources]:
    if d is None:
        return None
    return s.Resources(
        cpu=d.get("cpu", 0), memory_mb=d.get("memory_mb", 0),
        disk_mb=d.get("disk_mb", 0), iops=d.get("iops", 0),
        networks=[s.NetworkResource(
            device=n.get("device", ""), cidr=n.get("cidr", ""),
            ip=n.get("ip", ""), mbits=n.get("mbits", 0),
            reserved_ports=[s.Port(p["label"], p["value"])
                            for p in n.get("reserved_ports", [])],
            dynamic_ports=[s.Port(p["label"], p["value"])
                           for p in n.get("dynamic_ports", [])])
            for n in d.get("networks", [])])


def _constraints(lst) -> list:
    return [s.Constraint(c["ltarget"], c["rtarget"], c["operand"])
            for c in lst or []]


def node_from_dict(d: dict) -> s.Node:
    return s.Node(
        id=d["id"], datacenter=d["datacenter"], name=d["name"],
        attributes=dict(d["attributes"]), resources=_res(d["resources"]),
        reserved=_res(d.get("reserved")), meta=dict(d.get("meta") or {}),
        node_class=d.get("node_class", ""),
        computed_class=d.get("computed_class", ""),
        drain=d.get("drain", False), status=d["status"])


def job_from_dict(d: dict) -> s.Job:
    return s.Job(
        region=d.get("region", "global"), id=d["id"], name=d["name"],
        type=d["type"], priority=d["priority"],
        datacenters=list(d["datacenters"]),
        constraints=_constraints(d.get("constraints")),
        task_groups=[s.TaskGroup(
            name=tg["name"], count=tg["count"],
            constraints=_constraints(tg.get("constraints")),
            tasks=[s.Task(name=t["name"], driver=t["driver"],
                          constraints=_constraints(t.get("constraints")),
                          resources=_res(t["resources"]))
                   for t in tg["tasks"]],
            ephemeral_disk=s.EphemeralDisk(
                **{k: tg["ephemeral_disk"][k]
                   for k in ("sticky", "size_mb", "migrate")}))
            for tg in d["task_groups"]],
        status=d.get("status", s.JOB_STATUS_PENDING),
        version=d.get("version", 0))


def alloc_from_dict(d: dict) -> s.Allocation:
    return s.Allocation(
        id=d["id"], node_id=d["node_id"], job_id=d["job_id"],
        task_group=d["task_group"], resources=_res(d.get("resources")),
        shared_resources=_res(d.get("shared_resources")),
        task_resources={k: _res(v) for k, v in
                        (d.get("task_resources") or {}).items()},
        desired_status=d["desired_status"],
        client_status=d["client_status"])


def device_inputs_from_buffers(static: Dict[str, np.ndarray],
                               dyn: Dict[str, np.ndarray],
                               device=None):
    """The reference path's upload dicts → ``(static_buf, dyn_buf,
    meta_s, meta_d)`` for :func:`ops.kernels.fused_pass`.

    Quantized resource rows (``cap_q``/``used_base_q`` plus the [2, 4]
    ``res_scale`` codebook) are dequantized here with the same exact
    integer multiply the reference does on device; the port ships
    int32 rows.  ``device`` defaults to ``cuda`` (see
    :func:`nomad_tpu_torch.device.resolve_device`)."""
    dev = resolve_device(device)
    static = dict(static)
    if "res_scale" in static:
        scale = np.asarray(static.pop("res_scale"), dtype=np.int32)
        static["cap"] = (static.pop("cap_q").astype(np.int32)
                         * scale[0][None, :])
        static["used_base"] = (static.pop("used_base_q").astype(np.int32)
                               * scale[1][None, :])
    sbuf, meta_s = xfer.pack_host(static)
    dbuf, meta_d = xfer.pack_host(dyn)
    return (torch.from_numpy(sbuf).to(dev),
            torch.from_numpy(dbuf).to(dev), meta_s, meta_d)
