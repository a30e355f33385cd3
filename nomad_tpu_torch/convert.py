"""Carry state across from the reference package without importing it.

``node_from_dict``/``job_from_dict``/``alloc_from_dict``/
``eval_from_dict`` take the plain dicts that ``dataclasses.asdict`` makes
of ``nomad_tpu``'s structs (keys this port does not model are ignored);
networks, with their reserved and dynamic ports, are kept -- an alloc's
``task_resources`` carry the offers its ports came from.  Jobs keep what
the reconciler compares (the update strategy, version, meta, the task
fields of the in-place update test, ``stop``), the lifecycle's fields
(``parent_id``, the periodic and parameterized configs, the payload, a
task's ``dispatch_payload``) and the jobspec's (restart policies,
services and their checks, log configs, artifacts, templates, vault
asks, kill timeouts, leaders, ``submit_time``); allocs keep their name,
evaluation, previous allocation, metrics and job; evaluations keep every
field the scheduler reads and writes, so the tests can build one cluster
in both packages.  ``device_inputs_from_buffers``
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
        http_addr=d.get("http_addr", ""),
        attributes=dict(d["attributes"]), resources=_res(d["resources"]),
        reserved=_res(d.get("reserved")),
        links=dict(d.get("links") or {}), meta=dict(d.get("meta") or {}),
        node_class=d.get("node_class", ""),
        computed_class=d.get("computed_class", ""),
        drain=d.get("drain", False), status=d["status"],
        status_description=d.get("status_description", ""),
        status_updated_at=d.get("status_updated_at", 0.0),
        create_index=d.get("create_index", 0),
        modify_index=d.get("modify_index", 0))


def _service(d: dict) -> s.Service:
    return s.Service(
        name=d.get("name", ""), port_label=d.get("port_label", ""),
        tags=list(d.get("tags") or []),
        checks=[s.ServiceCheck(**{**c, "args": list(c.get("args") or [])})
                for c in d.get("checks") or []])


def _task(t: dict) -> s.Task:
    vault = t.get("vault")
    return s.Task(
        name=t["name"], driver=t["driver"], user=t.get("user", ""),
        config=dict(t.get("config") or {}), env=dict(t.get("env") or {}),
        services=[_service(sv) for sv in t.get("services") or []],
        vault=(s.Vault(**{**vault,
                          "policies": list(vault.get("policies") or [])})
               if vault else None),
        templates=[s.Template(**tm) for tm in t.get("templates") or []],
        constraints=_constraints(t.get("constraints")),
        resources=_res(t["resources"]),
        dispatch_payload=(s.DispatchPayloadConfig(**t["dispatch_payload"])
                          if t.get("dispatch_payload") else None),
        meta=dict(t.get("meta") or {}),
        kill_timeout=t.get("kill_timeout", 5.0),
        log_config=s.LogConfig(**(t.get("log_config") or {})),
        artifacts=[s.TaskArtifact(
            getter_source=a.get("getter_source", ""),
            getter_options=dict(a.get("getter_options") or {}),
            relative_dest=a.get("relative_dest", ""))
            for a in t.get("artifacts") or []],
        leader=t.get("leader", False))


def job_from_dict(d: dict) -> s.Job:
    upd = d.get("update") or {}
    per = d.get("periodic")
    par = d.get("parameterized_job")
    return s.Job(
        region=d.get("region", "global"),
        namespace=d.get("namespace", s.DEFAULT_NAMESPACE), id=d["id"],
        parent_id=d.get("parent_id", ""),
        name=d["name"], type=d["type"], priority=d["priority"],
        all_at_once=d.get("all_at_once", False),
        datacenters=list(d["datacenters"]),
        constraints=_constraints(d.get("constraints")),
        task_groups=[s.TaskGroup(
            name=tg["name"], count=tg["count"],
            constraints=_constraints(tg.get("constraints")),
            restart_policy=s.RestartPolicy(**(tg.get("restart_policy")
                                              or {})),
            tasks=[_task(t) for t in tg["tasks"]],
            ephemeral_disk=s.EphemeralDisk(
                **{k: tg["ephemeral_disk"][k]
                   for k in ("sticky", "size_mb", "migrate")}),
            meta=dict(tg.get("meta") or {}))
            for tg in d["task_groups"]],
        update=s.UpdateStrategy(stagger=upd.get("stagger", 0.0),
                                max_parallel=upd.get("max_parallel", 0)),
        periodic=s.PeriodicConfig(**per) if per else None,
        parameterized_job=(s.ParameterizedJobConfig(
            payload=par.get("payload", ""),
            meta_required=list(par.get("meta_required") or []),
            meta_optional=list(par.get("meta_optional") or []))
            if par else None),
        payload=bytes(d.get("payload") or b""),
        meta=dict(d.get("meta") or {}),
        vault_token=d.get("vault_token", ""),
        status=d.get("status", s.JOB_STATUS_PENDING),
        status_description=d.get("status_description", ""),
        stop=d.get("stop", False), version=d.get("version", 0),
        submit_time=d.get("submit_time", 0.0),
        create_index=d.get("create_index", 0),
        modify_index=d.get("modify_index", 0),
        job_modify_index=d.get("job_modify_index", 0))


def metric_from_dict(d: Optional[dict]) -> Optional[s.AllocMetric]:
    if d is None:
        return None
    return s.AllocMetric(**{k: (dict(v) if isinstance(v, dict) else v)
                            for k, v in d.items()})


def alloc_from_dict(d: dict) -> s.Allocation:
    job = d.get("job")
    return s.Allocation(
        id=d["id"], namespace=d.get("namespace", s.DEFAULT_NAMESPACE),
        eval_id=d.get("eval_id", ""), name=d.get("name", ""),
        node_id=d["node_id"], job_id=d["job_id"],
        job=job_from_dict(job) if job else None,
        task_group=d["task_group"], resources=_res(d.get("resources")),
        shared_resources=_res(d.get("shared_resources")),
        task_resources={k: _res(v) for k, v in
                        (d.get("task_resources") or {}).items()},
        metrics=metric_from_dict(d.get("metrics")),
        desired_status=d["desired_status"],
        desired_description=d.get("desired_description", ""),
        client_status=d["client_status"],
        client_description=d.get("client_description", ""),
        previous_allocation=d.get("previous_allocation", ""),
        create_index=d.get("create_index", 0),
        modify_index=d.get("modify_index", 0),
        alloc_modify_index=d.get("alloc_modify_index", 0),
        create_time=d.get("create_time", 0.0))


def eval_from_dict(d: dict) -> s.Evaluation:
    fields = {k: d[k] for k in (
        "id", "namespace", "priority", "type", "triggered_by", "job_id",
        "job_modify_index", "node_id", "node_modify_index", "status",
        "status_description", "wait", "next_eval", "previous_eval",
        "blocked_eval", "escaped_computed_class", "annotate_plan",
        "snapshot_index", "create_index", "modify_index") if k in d}
    return s.Evaluation(
        failed_tg_allocs={k: metric_from_dict(v) for k, v in
                          (d.get("failed_tg_allocs") or {}).items()},
        class_eligibility=dict(d.get("class_eligibility") or {}),
        queued_allocations=dict(d.get("queued_allocations") or {}),
        **fields)


def device_inputs_from_buffers(static: Dict[str, np.ndarray],
                               dyn: Dict[str, np.ndarray], device=None):
    """The reference path's upload dicts → ``(static_buf, dyn_buf,
    meta_s, meta_d)`` for :func:`ops.kernels.fused_pass`.

    Every key of the reference's single-chip upload is taken: the
    network keys (``bw_cap``, ``*_base``, ``net_*``, ``dyn_need``,
    ``resv_words``, ``u_bw``/``u_dyn``/``u_ports``), the
    distinct_property keys (``dp_*``), a precomputed ``precomp`` row and
    the quantized resource rows (``cap_q``/``used_base_q`` and the
    ``res_scale`` codebook, which the port's fused pass dequantizes as
    the reference's does).  The reference's uint32 port words become
    their int32 bit images, the form the port ships.  ``device``
    defaults to ``cuda`` (see
    :func:`nomad_tpu_torch.device.resolve_device`)."""
    dev = resolve_device(device)
    static, dyn = ({name: arr.view(np.int32) if arr.dtype == np.uint32
                    else arr for name, arr in arrays.items()}
                   for arrays in (static, dyn))
    sbuf, meta_s = xfer.pack_host(static)
    dbuf, meta_d = xfer.pack_host(dyn)
    return (torch.from_numpy(sbuf).to(dev),
            torch.from_numpy(dbuf).to(dev), meta_s, meta_d)
