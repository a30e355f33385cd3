"""CLI commands (a copy of ``nomad_tpu/cli/commands.py``; reference:
command/ package — one file per verb, registered in commands.go:13; entry
at main.go:15).  ``agent`` takes ``-device`` (default ``cuda``), the
card the agent's server places on.

Every command talks to an agent over the HTTP API via the SDK, exactly like
the reference CLI does, so the CLI works against any running agent.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from typing import List, Optional

from .. import __version__
from ..api import APIError, NomadAPI, QueryOptions
from ..api.codec import to_wire
from ..jobspec import ParseError, parse_file
from ..structs import structs as s
from .output import format_kv, format_list, format_time, limit


class CLIError(Exception):
    pass


def _api(args) -> NomadAPI:
    addr = args.address or os.environ.get("NOMAD_ADDR", "http://127.0.0.1:4646")
    return NomadAPI(addr, region=getattr(args, "region", "") or "")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("-address", default="", help="HTTP address of the agent")
    p.add_argument("-region", default="", help="region to forward to")


# ---------------------------------------------------------------------------
# eval monitor (command/monitor.go)
# ---------------------------------------------------------------------------


def monitor_eval(api: NomadAPI, eval_id: str, out, detach: bool = False,
                 timeout: float = 120.0) -> int:
    if detach:
        out.write(f"Evaluation ID: {eval_id}\n")
        return 0
    out.write(f'==> Monitoring evaluation "{limit(eval_id)}"\n')
    seen_allocs = set()
    last_status = ""
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            ev, _ = api.evaluations.info(eval_id)
        except APIError:
            time.sleep(0.2)
            continue
        if ev.status != last_status:
            if last_status:
                out.write(f'    Evaluation status changed: '
                          f'"{last_status}" -> "{ev.status}"\n')
            else:
                out.write(f'    Evaluation triggered by job "{ev.job_id}"\n')
            last_status = ev.status
        allocs, _ = api.evaluations.allocations(eval_id)
        for a in allocs:
            if a["ID"] not in seen_allocs:
                seen_allocs.add(a["ID"])
                out.write(f'    Allocation "{limit(a["ID"])}" created: '
                          f'node "{limit(a["NodeID"])}", '
                          f'group "{a["TaskGroup"]}"\n')
        if ev.status in (s.EVAL_STATUS_COMPLETE, s.EVAL_STATUS_FAILED,
                         s.EVAL_STATUS_CANCELLED):
            _print_placement_failures(ev, out)
            out.write(f'==> Evaluation "{limit(eval_id)}" finished '
                      f'with status "{ev.status}"\n')
            if ev.status == s.EVAL_STATUS_COMPLETE and ev.blocked_eval:
                out.write(f'    Evaluation "{limit(ev.blocked_eval)}" '
                          f'waiting for additional capacity to place '
                          f'remainder\n')
            return 0 if ev.status == s.EVAL_STATUS_COMPLETE else 2
        time.sleep(0.2)
    out.write("==> Monitor timed out\n")
    return 1


def _print_placement_failures(ev: s.Evaluation, out,
                              indent: str = "    ") -> None:
    for tg, metric in (ev.failed_tg_allocs or {}).items():
        out.write(f'{indent}Task Group "{tg}" '
                  f'(failed to place an allocation):\n')
        for line in format_alloc_metrics(metric, prefix=indent + "  "):
            out.write(line + "\n")


def format_alloc_metrics(m: s.AllocMetric, prefix: str = "") -> List[str]:
    """command/monitor.go:formatAllocMetrics."""
    out: List[str] = []
    if m.nodes_evaluated == 0:
        out.append(f"{prefix}* No nodes were eligible for evaluation")
    for dc, available in sorted((m.nodes_available or {}).items()):
        if available == 0:
            out.append(f'{prefix}* No nodes are available in datacenter "{dc}"')
    for cls, n in sorted((m.class_filtered or {}).items()):
        out.append(f'{prefix}* Class "{cls}" filtered {n} nodes')
    for cons, n in sorted((m.constraint_filtered or {}).items()):
        out.append(f'{prefix}* Constraint "{cons}" filtered {n} nodes')
    if m.nodes_exhausted > 0:
        out.append(f"{prefix}* Resources exhausted on {m.nodes_exhausted} nodes")
    for cls, n in sorted((m.class_exhausted or {}).items()):
        out.append(f'{prefix}* Class "{cls}" exhausted on {n} nodes')
    for dim, n in sorted((m.dimension_exhausted or {}).items()):
        out.append(f'{prefix}* Dimension "{dim}" exhausted on {n} nodes')
    if m.scores:
        for name, score in sorted(m.scores.items()):
            out.append(f'{prefix}* Score "{name}" = {score:f}')
    return out


# ---------------------------------------------------------------------------
# commands
# ---------------------------------------------------------------------------


def cmd_run(args, out) -> int:
    """command/run.go."""
    try:
        job = parse_file(args.jobfile)
    except (ParseError, OSError) as e:
        out.write(f"Error parsing job file: {e}\n")
        return 1
    api = _api(args)
    if args.output:
        out.write(json.dumps({"Job": to_wire(job)}, indent=2) + "\n")
        return 0
    try:
        resp, _ = api.jobs.register(job)
    except APIError as e:
        out.write(f"Error submitting job: {e}\n")
        return 1
    eval_id = resp.get("EvalID", "")
    if not eval_id:  # periodic/parameterized: no eval created
        out.write(f'Job registration successful\n')
        if job.is_periodic():
            nxt = job.periodic.next(s.now())
            out.write(f"Approximate next launch time: {format_time(nxt)}\n")
        return 0
    return monitor_eval(api, eval_id, out, detach=args.detach)


def cmd_plan(args, out) -> int:
    """command/plan.go."""
    try:
        job = parse_file(args.jobfile)
    except (ParseError, OSError) as e:
        out.write(f"Error parsing job file: {e}\n")
        return 1
    api = _api(args)
    try:
        resp, _ = api.jobs.plan(job, diff=not args.no_diff)
    except APIError as e:
        out.write(f"Error during plan: {e}\n")
        return 255
    if resp.diff is not None:
        _print_job_diff(resp.diff, out, args.verbose)
    out.write("\n")
    changes = False
    for tg, du in sorted((resp.annotations.desired_tg_updates or {}).items()
                         if resp.annotations else []):
        parts = []
        for label, n in (("create", du.place), ("destroy", du.stop),
                         ("migrate", du.migrate),
                         ("in-place update", du.in_place_update),
                         ("create/destroy update", du.destructive_update),
                         ("ignore", du.ignore)):
            if n:
                parts.append(f"{n} {label}")
        if parts:
            out.write(f'Task Group "{tg}" ({", ".join(parts)})\n')
            if du.place or du.stop or du.migrate or du.destructive_update:
                changes = True
    if resp.failed_tg_allocs:
        out.write("\nPlacement failures:\n")
        for tg, metric in resp.failed_tg_allocs.items():
            out.write(f'  Task Group "{tg}":\n')
            for line in format_alloc_metrics(metric, prefix="    "):
                out.write(line + "\n")
    if resp.next_periodic_launch:
        out.write("Approximate next launch time: "
                  f"{format_time(resp.next_periodic_launch)}\n")
    out.write(f"\nJob Modify Index: {resp.job_modify_index}\n")
    return 1 if changes else 0


_DIFF_MARK = {"Added": "+", "Deleted": "-", "Edited": "+/-", "None": ""}


def _print_field_diffs(fields, out, indent: str, verbose: bool) -> None:
    for f in fields:
        if f.type == "None" and not verbose:
            continue
        ann = f" ({', '.join(f.annotations)})" if f.annotations else ""
        out.write(f"{indent}{_DIFF_MARK.get(f.type, '')} {f.name}: "
                  f"{f.old!r} => {f.new!r}{ann}\n")


def _print_object_diffs(objects, out, indent: str, verbose: bool) -> None:
    for o in objects:
        if o.type == "None" and not verbose:
            continue
        out.write(f"{indent}{_DIFF_MARK.get(o.type, '')} {o.name}\n")
        _print_field_diffs(o.fields, out, indent + "  ", verbose)
        _print_object_diffs(o.objects, out, indent + "  ", verbose)


def _print_job_diff(diff, out, verbose: bool) -> None:
    mark = _DIFF_MARK.get(diff.type, "")
    out.write(f"{mark} Job: {diff.id!r}\n".lstrip())
    _print_field_diffs(diff.fields, out, "  ", verbose)
    _print_object_diffs(diff.objects, out, "  ", verbose)
    for tg in diff.task_groups:
        if tg.type == "None" and not verbose:
            continue
        counts = ", ".join(f"{n} {k}" for k, n in sorted(
            (tg.updates or {}).items()))
        suffix = f" ({counts})" if counts else ""
        out.write(f"{_DIFF_MARK.get(tg.type, '')} Task Group: "
                  f"{tg.name!r}{suffix}\n")
        _print_field_diffs(tg.fields, out, "    ", verbose)
        _print_object_diffs(tg.objects, out, "    ", verbose)
        for t in tg.tasks:
            if t.type == "None" and not verbose:
                continue
            ann = f" ({', '.join(t.annotations)})" if t.annotations else ""
            out.write(f"  {_DIFF_MARK.get(t.type, '')} Task: "
                      f"{t.name!r}{ann}\n")
            _print_field_diffs(t.fields, out, "      ", verbose)
            _print_object_diffs(t.objects, out, "      ", verbose)


def cmd_validate(args, out) -> int:
    """command/validate.go."""
    try:
        job = parse_file(args.jobfile)
    except (ParseError, OSError) as e:
        out.write(f"Error parsing job file: {e}\n")
        return 1
    job.canonicalize()
    problems = job.validate()
    if problems:
        out.write("Job validation errors:\n")
        for p in problems:
            out.write(f"  * {p}\n")
        return 1
    out.write("Job validation successful\n")
    return 0


def cmd_stop(args, out) -> int:
    """command/stop.go."""
    api = _api(args)
    try:
        jobs, _ = api.jobs.list(QueryOptions(prefix=args.job_id))
    except APIError as e:
        out.write(f"Error deregistering job: {e}\n")
        return 1
    matches = [j for j in jobs if j["ID"] == args.job_id] or jobs
    if not matches:
        out.write(f'No job(s) with prefix or id "{args.job_id}" found\n')
        return 1
    if len(matches) > 1:
        out.write("Prefix matched multiple jobs:\n")
        for j in matches:
            out.write(f"  {j['ID']}\n")
        return 1
    try:
        resp, _ = api.jobs.deregister(matches[0]["ID"])
    except APIError as e:
        out.write(f"Error deregistering job: {e}\n")
        return 1
    eval_id = resp.get("EvalID", "")
    if not eval_id:
        return 0
    return monitor_eval(api, eval_id, out, detach=args.detach)


def cmd_status(args, out) -> int:
    """command/status.go."""
    api = _api(args)
    if not args.job_id:
        jobs, _ = api.jobs.list()
        if getattr(args, "json", False):
            out.write(json.dumps(jobs, indent=4, sort_keys=True) + "\n")
            return 0
        if not jobs:
            out.write("No running jobs\n")
            return 0
        rows = ["ID|Type|Priority|Status"]
        for j in sorted(jobs, key=lambda x: x["ID"]):
            rows.append(f"{j['ID']}|{j['Type']}|{j['Priority']}|{j['Status']}")
        out.write(format_list(rows) + "\n")
        return 0
    try:
        job, _ = api.jobs.info(args.job_id)
    except APIError:
        jobs, _ = api.jobs.list(QueryOptions(prefix=args.job_id))
        if len(jobs) == 1:
            job, _ = api.jobs.info(jobs[0]["ID"])
        elif len(jobs) > 1:
            out.write("Prefix matched multiple jobs:\n")
            for j in jobs:
                out.write(f"  {j['ID']}\n")
            return 1
        else:
            out.write(f'No job(s) with prefix or id "{args.job_id}" found\n')
            return 1
    if getattr(args, "json", False):
        # -json: the raw API representation (command/status.go -json).
        out.write(json.dumps(to_wire(job), indent=4, sort_keys=True) + "\n")
        return 0
    periodic = job.is_periodic()
    kv = [
        f"ID|{job.id}", f"Name|{job.name}", f"Type|{job.type}",
        f"Priority|{job.priority}",
        f"Datacenters|{','.join(job.datacenters)}",
        f"Status|{job.status}", f"Periodic|{str(periodic).lower()}",
        f"Parameterized|{str(job.is_parameterized()).lower()}",
    ]
    out.write(format_kv(kv) + "\n")
    try:
        summary, _ = api.jobs.summary(job.id)
    except APIError:
        summary = None
    if summary is not None and not args.short:
        out.write("\nSummary\n")
        rows = ["Task Group|Queued|Starting|Running|Failed|Complete|Lost"]
        for tg, tgs in sorted(summary.summary.items()):
            rows.append(f"{tg}|{tgs.queued}|{tgs.starting}|{tgs.running}|"
                        f"{tgs.failed}|{tgs.complete}|{tgs.lost}")
        out.write(format_list(rows) + "\n")
    if not args.short:
        allocs, _ = api.jobs.allocations(job.id)
        out.write("\nAllocations\n")
        if allocs:
            rows = ["ID|Eval ID|Node ID|Task Group|Desired|Status|Created At"]
            for a in allocs:
                rows.append(
                    f"{limit(a['ID'])}|{limit(a['EvalID'])}|"
                    f"{limit(a['NodeID'])}|{a['TaskGroup']}|"
                    f"{a['DesiredStatus']}|{a['ClientStatus']}|"
                    f"{format_time(a.get('CreateTime') or 0)}")
            out.write(format_list(rows) + "\n")
        else:
            out.write("No allocations placed\n")
    return 0


def cmd_inspect(args, out) -> int:
    """command/inspect.go."""
    api = _api(args)
    try:
        job, _ = api.jobs.info(args.job_id)
    except APIError as e:
        out.write(f"Error inspecting job: {e}\n")
        return 1
    out.write(json.dumps({"Job": to_wire(job)}, indent=4, default=str) + "\n")
    return 0


def cmd_node_status(args, out) -> int:
    """command/node_status.go."""
    api = _api(args)
    if not args.node_id:
        nodes, _ = api.nodes.list()
        if getattr(args, "json", False):
            out.write(json.dumps(nodes, indent=4, sort_keys=True) + "\n")
            return 0
        if not nodes:
            out.write("No nodes registered\n")
            return 0
        rows = ["ID|DC|Name|Class|Drain|Status"]
        for n in sorted(nodes, key=lambda x: x["ID"]):
            rows.append(
                f"{limit(n['ID'])}|{n['Datacenter']}|{n['Name']}|"
                f"{n['NodeClass']}|{str(n['Drain']).lower()}|{n['Status']}")
        out.write(format_list(rows) + "\n")
        return 0
    nodes, _ = api.nodes.list(QueryOptions(prefix=args.node_id))
    if not nodes:
        out.write(f'No node(s) with prefix "{args.node_id}" found\n')
        return 1
    if len(nodes) > 1:
        out.write("Prefix matched multiple nodes:\n")
        for n in nodes:
            out.write(f"  {n['ID']}\n")
        return 1
    node, _ = api.nodes.info(nodes[0]["ID"])
    if getattr(args, "json", False):
        out.write(json.dumps(to_wire(node), indent=4, sort_keys=True) + "\n")
        return 0
    kv = [
        f"ID|{node.id}", f"Name|{node.name}", f"Class|{node.node_class}",
        f"DC|{node.datacenter}", f"Drain|{str(node.drain).lower()}",
        f"Status|{node.status}",
    ]
    out.write(format_kv(kv) + "\n")
    allocs, _ = api.nodes.allocations(node.id)
    running = [a for a in allocs
               if a.client_status == s.ALLOC_CLIENT_STATUS_RUNNING]
    if node.resources is not None:
        used = s.Resources()
        for a in running:
            if a.resources is not None:
                used.add(a.resources)
        out.write("\nAllocated Resources\n")
        rows = ["CPU|Memory|Disk|IOPS",
                f"{used.cpu}/{node.resources.cpu} MHz|"
                f"{used.memory_mb}/{node.resources.memory_mb} MiB|"
                f"{used.disk_mb}/{node.resources.disk_mb} MiB|"
                f"{used.iops}/{node.resources.iops}"]
        out.write(format_list(rows) + "\n")
    if not args.short:
        out.write("\nAllocations\n")
        if allocs:
            rows = ["ID|Eval ID|Job ID|Task Group|Desired|Status"]
            for a in allocs:
                rows.append(f"{limit(a.id)}|{limit(a.eval_id)}|{a.job_id}|"
                            f"{a.task_group}|{a.desired_status}|"
                            f"{a.client_status}")
            out.write(format_list(rows) + "\n")
        else:
            out.write("No allocations placed\n")
    return 0


def cmd_node_drain(args, out) -> int:
    """command/node_drain.go."""
    if args.enable == args.disable:
        out.write("Either the '-enable' or '-disable' flag must be set\n")
        return 1
    api = _api(args)
    nodes, _ = api.nodes.list(QueryOptions(prefix=args.node_id))
    if not nodes:
        out.write(f'No node(s) with prefix "{args.node_id}" found\n')
        return 1
    if len(nodes) > 1:
        out.write("Prefix matched multiple nodes:\n")
        for n in nodes:
            out.write(f"  {n['ID']}\n")
        return 1
    try:
        api.nodes.toggle_drain(nodes[0]["ID"], args.enable)
    except APIError as e:
        out.write(f"Error toggling drain: {e}\n")
        return 1
    return 0


def cmd_alloc_status(args, out) -> int:
    """command/alloc_status.go."""
    api = _api(args)
    allocs, _ = api.allocations.list(QueryOptions(prefix=args.alloc_id))
    if not allocs:
        out.write(f'No allocation(s) with prefix or id '
                  f'"{args.alloc_id}" found\n')
        return 1
    if len(allocs) > 1:
        out.write("Prefix matched multiple allocations:\n")
        for a in allocs:
            out.write(f"  {a['ID']}\n")
        return 1
    alloc, _ = api.allocations.info(allocs[0]["ID"])
    if getattr(args, "json", False):
        out.write(json.dumps(to_wire(alloc), indent=4, sort_keys=True) + "\n")
        return 0
    kv = [
        f"ID|{alloc.id}", f"Eval ID|{limit(alloc.eval_id)}",
        f"Name|{alloc.name}", f"Node ID|{limit(alloc.node_id)}",
        f"Job ID|{alloc.job_id}", f"Client Status|{alloc.client_status}",
        f"Desired Status|{alloc.desired_status}",
    ]
    out.write(format_kv(kv) + "\n")
    for task, state in sorted((alloc.task_states or {}).items()):
        out.write(f'\nTask "{task}" is "{state.state}"\n')
        if state.events:
            out.write("Recent Events:\n")
            rows = ["Time|Type|Description"]
            for e in state.events[-10:]:
                rows.append(f"{format_time(e.time)}|{e.type}|"
                            f"{e.display_message()}")
            out.write(format_list(rows) + "\n")
    if args.verbose and alloc.metrics is not None:
        out.write("\nPlacement Metrics\n")
        for line in format_alloc_metrics(alloc.metrics):
            out.write(line + "\n")
    return 0


def cmd_eval_status(args, out) -> int:
    """command/eval_status.go."""
    api = _api(args)
    evals, _ = api.evaluations.list(QueryOptions(prefix=args.eval_id))
    if not evals:
        out.write(f'No evaluation(s) with prefix or id '
                  f'"{args.eval_id}" found\n')
        return 1
    if len(evals) > 1:
        out.write("Prefix matched multiple evaluations:\n")
        for e in evals:
            out.write(f"  {e.id}\n")
        return 1
    ev = evals[0]
    if getattr(args, "json", False):
        out.write(json.dumps(to_wire(ev), indent=4, sort_keys=True) + "\n")
        return 0
    kv = [
        f"ID|{ev.id}", f"Status|{ev.status}", f"Type|{ev.type}",
        f"TriggeredBy|{ev.triggered_by}", f"Job ID|{ev.job_id}",
        f"Priority|{ev.priority}",
    ]
    if ev.status_description:
        kv.append(f"Status Description|{ev.status_description}")
    out.write(format_kv(kv) + "\n")
    if ev.failed_tg_allocs:
        out.write("\nFailed Placements\n")
        _print_placement_failures(ev, out, indent="")
    return 0


def cmd_logs(args, out) -> int:
    """command/logs.go."""
    api = _api(args)
    allocs, _ = api.allocations.list(QueryOptions(prefix=args.alloc_id))
    if len(allocs) != 1:
        out.write(f'No single allocation with prefix "{args.alloc_id}"\n')
        return 1
    log_type = "stderr" if args.stderr else "stdout"
    follow = getattr(args, "follow", False)
    tail_bytes = int(getattr(args, "tail_bytes", 0) or 0)
    try:
        if follow or tail_bytes:
            # Tail from the end, streaming frames; -f keeps following
            # (command/logs.go -f/-tail + fs_endpoint.go follow framing).
            frames = api.agent.stream_logs(
                allocs[0]["ID"], args.task, log_type,
                follow=follow, origin="end", offset=tail_bytes)
            return _drain_frames(frames, out)
        text = api.agent.task_logs(allocs[0]["ID"], args.task, log_type)
    except APIError as e:
        out.write(f"Error reading logs: {e}\n")
        return 1
    out.write(text)
    return 0


def _drain_frames(frames, out) -> int:
    """Write a StreamFrame sequence's data to ``out`` until the stream ends
    or the user interrupts."""
    try:
        for frame in frames:
            data = frame.get("Data")
            if data:
                out.write(data.decode("utf-8", "replace"))
                if hasattr(out, "flush"):
                    out.flush()
    except KeyboardInterrupt:
        pass
    return 0


def cmd_fs(args, out) -> int:
    """command/fs.go."""
    api = _api(args)
    allocs, _ = api.allocations.list(QueryOptions(prefix=args.alloc_id))
    if len(allocs) != 1:
        out.write(f'No single allocation with prefix "{args.alloc_id}"\n')
        return 1
    alloc_id = allocs[0]["ID"]
    path = args.path or "/"
    try:
        if args.stat:
            st = api.agent.fs_stat(alloc_id, path)
            out.write(json.dumps(st, indent=2) + "\n")
        elif args.cat and getattr(args, "follow", False):
            return _drain_frames(
                api.agent.stream_file(alloc_id, path, follow=True), out)
        elif args.cat:
            out.write(api.agent.fs_cat(alloc_id, path))
        else:
            entries = api.agent.fs_list(alloc_id, path)
            rows = ["Name|Size|Dir|Mod Time"]
            for e in entries:
                rows.append(f"{e.get('Name', '')}|{e.get('Size', 0)}|"
                            f"{str(bool(e.get('IsDir'))).lower()}|"
                            f"{format_time(e.get('ModTime') or 0)}")
            out.write(format_list(rows) + "\n")
    except APIError as e:
        out.write(f"Error: {e}\n")
        return 1
    return 0


def cmd_server_join(args, out) -> int:
    """command/server_join.go: join this agent's server to an existing
    cluster's gossip."""
    api = _api(args)
    reply = api.agent.join(args.addresses)
    if reply.get("error"):
        out.write(f"Error joining: {reply['error']}\n")
        return 1
    out.write(f"Joined {reply.get('num_joined', 0)} servers successfully\n")
    return 0


def cmd_server_force_leave(args, out) -> int:
    """command/server_force_leave.go."""
    api = _api(args)
    try:
        api.agent.force_leave(args.node)
    except APIError as e:
        out.write(f"Error force-leaving: {e}\n")
        return 1
    out.write(f"Server {args.node} marked as left\n")
    return 0


def cmd_keygen(args, out) -> int:
    """command/keygen.go: a random 32-byte base64 gossip key."""
    import base64

    out.write(base64.b64encode(os.urandom(32)).decode("ascii") + "\n")
    return 0


def _keyring_render(out, keys, primaries) -> int:
    if not keys:
        out.write("Keyring is empty\n")
    for k in sorted(keys):
        out.write(f"{k}{' (primary)' if k in primaries else ''}\n")
    return 0


_KEYRING_VERBS = (("install", "Installed key\n"),
                  ("use", "Changed primary key\n"),
                  ("remove", "Removed key\n"))


def cmd_keyring(args, out) -> int:
    """command/keyring.go: manage the gossip keyring. Like the reference,
    operations go through the agent HTTP API (client.Agent().InstallKey
    et al., keyring.go:66-97); with an explicit -data-dir the shared
    utils/keyring helper edits the file directly (offline management,
    e.g. pre-seeding before first start)."""
    from ..utils import keyring

    verb = next(((op, getattr(args, op), done)
                 for op, done in _KEYRING_VERBS if getattr(args, op)), None)
    if not args.list_keys and verb is None:
        out.write("Specify one of -install, -list, -use, -remove\n")
        return 1

    if not args.data_dir:
        api = _api(args)
        try:
            if args.list_keys:
                resp = api.agent.list_keys()
                return _keyring_render(out, resp["Keys"],
                                       resp["PrimaryKeys"])
            op, key, done = verb
            getattr(api.agent, f"{op}_key")(key)
            out.write(done)
            return 0
        except APIError as e:
            if e.code != 0:  # agent answered with an error
                out.write(f"Error: {e}\n")
                return 1
            out.write("Error: no agent reachable (use -address, or "
                      "-data-dir for offline file management)\n")
            return 1

    if args.list_keys:
        ring = keyring.list_keys(args.data_dir)
        return _keyring_render(out, ring["Keys"],
                               {ring["Primary"]} if ring["Primary"] else ())
    op, key, done = verb
    try:
        getattr(keyring, op)(args.data_dir, key)
    except keyring.KeyringError as e:
        out.write(f"Error: {e}\n")
        return 1
    out.write(done)
    return 0


def cmd_monitor(args, out) -> int:
    """command/monitor-style agent log streaming (agent monitor)."""
    api = _api(args)
    try:
        frames = api.agent._stream("/v1/agent/monitor", {}, follow=True)
        return _drain_frames(frames, out)
    except APIError as e:
        out.write(f"Error monitoring agent: {e}\n")
        return 1


def cmd_events(args, out) -> int:
    """command/event.go-style follow mode over /v1/event/stream: one
    line per cluster state-change event, with -topic filters and -index
    resume.  -no-follow dumps the server's buffered backlog and exits
    (incident forensics after the fact)."""
    api = _api(args)
    topics = list(args.topic or [])
    try:
        for ev in api.events.stream(topics=topics,
                                    index=int(args.index or 0),
                                    follow=not args.no_follow):
            if getattr(args, "json", False):
                out.write(json.dumps(ev) + "\n")
            else:
                extra = ""
                if ev.get("EvalID"):
                    extra = f" eval={limit(ev['EvalID'])}"
                payload = ev.get("Payload") or {}
                out.write(f"{ev.get('Index', 0):>8}  "
                          f"{ev.get('Topic', '')}/{ev.get('Type', '')}  "
                          f"{limit(ev.get('Key', ''))}{extra}  "
                          f"{json.dumps(payload, sort_keys=True)}\n")
            if hasattr(out, "flush"):
                out.flush()
    except APIError as e:
        out.write(f"Error streaming events: {e}\n")
        return 1
    except KeyboardInterrupt:
        pass
    return 0


def cmd_check(args, out) -> int:
    """command/check.go: agent health probe — exit 0 healthy, 1 not."""
    api = _api(args)
    try:
        info = api.agent.self_info()
    except APIError as e:
        out.write(f"unhealthy: {e}\n")
        return 1
    stats = info.get("stats", {})
    server_ok = "nomad" not in stats or         stats["nomad"].get("leader") in ("True", "true", True) or         stats["nomad"].get("applied_index") is not None
    out.write("ok\n" if server_ok else "unhealthy: no server state\n")
    return 0 if server_ok else 1


def cmd_server_members(args, out) -> int:
    """command/server_members.go."""
    api = _api(args)
    members = api.agent.members().get("Members", [])
    if getattr(args, "json", False):
        out.write(json.dumps(members, indent=4, sort_keys=True) + "\n")
        return 0
    if getattr(args, "detailed", False):
        # (server_members.go -detailed): every gossip tag.
        rows = ["Name|Address|Port|Tags"]
        for m in members:
            tags = ",".join(f"{k}={v}" for k, v in
                            sorted((m.get("Tags") or {}).items()))
            rows.append(f"{m['Name']}|{m['Addr']}|{m['Port']}|{tags}")
        out.write(format_list(rows) + "\n")
        return 0
    rows = ["Name|Address|Port|Status|Region|DC"]
    for m in members:
        tags = m.get("Tags", {})
        rows.append(f"{m['Name']}|{m['Addr']}|{m['Port']}|{m['Status']}|"
                    f"{tags.get('region', '')}|{tags.get('dc', '')}")
    out.write(format_list(rows) + "\n")
    return 0


def cmd_regions(args, out) -> int:
    """Federated-region inventory (reference: command/regions.go, plus
    the detail columns our /v1/regions?detail surface adds): region
    name, alive server count, best-known leader address."""
    api = _api(args)
    rows_in = api.regions.list()
    if getattr(args, "json", False):
        out.write(json.dumps(rows_in, indent=4, sort_keys=True) + "\n")
        return 0
    rows = ["Name|Servers|Leader"]
    for r in rows_in:
        rows.append(f"{r.get('Name', '')}|{r.get('Servers', 0)}|"
                    f"{r.get('Leader', '') or '(none)'}")
    out.write(format_list(rows) + "\n")
    return 0


def cmd_agent_info(args, out) -> int:
    """command/agent_info.go."""
    api = _api(args)
    info = api.agent.self_info()
    for section, stats in sorted((info.get("stats") or {}).items()):
        out.write(f"{section}\n")
        for k, v in sorted(stats.items()):
            out.write(f"  {k} = {v}\n")
    return 0


def cmd_broker_status(args, out) -> int:
    """Eval-broker saturation surface (/v1/broker/stats): admission /
    coalesce counters, pending by state and priority, delivery-attempt
    histogram, plan-queue depth."""
    api = _api(args)
    stats = api.system.broker_stats()
    if getattr(args, "json", False):
        out.write(json.dumps(stats, indent=4, sort_keys=True) + "\n")
        return 0
    out.write(format_kv([
        f"Enabled|{stats.get('Enabled')}",
        f"Pending|{stats.get('Pending')}",
        f"Max Pending|{stats.get('MaxPending') or 'unbounded'}",
        f"Plan Queue Depth|{stats.get('PlanQueueDepth')}",
        f"Admission Rejects|{stats.get('AdmissionRejects')}",
        f"Coalesced|{stats.get('CoalescedTotal')}",
        f"Shed|{stats.get('ShedTotal')}",
    ]) + "\n")
    by_state = stats.get("ByState") or {}
    if by_state:
        out.write("\nPending by State\n")
        for k, v in sorted(by_state.items()):
            out.write(f"  {k} = {v}\n")
    by_prio = stats.get("ByPriority") or {}
    if by_prio:
        out.write("\nPending by Priority\n")
        for k, v in sorted(by_prio.items(), key=lambda kv: int(kv[0])):
            out.write(f"  {k} = {v}\n")
    attempts = stats.get("DeliveryAttempts") or {}
    if attempts:
        out.write("\nDelivery Attempts\n")
        for k, v in sorted(attempts.items(), key=lambda kv: int(kv[0])):
            out.write(f"  {k} = {v}\n")
    tenants = stats.get("Tenants") or {}
    if tenants:
        out.write(f"\nTenants (objective={stats.get('Objective')})\n")
        rows = ["Namespace|Pending|Dequeued|Shed|Rejects|Weight|"
                "DominantShare|VirtualTime"]
        for name, t in sorted(
                tenants.items(),
                key=lambda kv: (-int(kv[1].get("Pending", 0)), kv[0])):
            rows.append("|".join(str(x) for x in (
                name, t.get("Pending", 0), t.get("Dequeued", 0),
                t.get("Shed", 0), t.get("Rejects", 0),
                t.get("Weight", 1.0), t.get("DominantShare", 0.0),
                t.get("VirtualTime", 0.0))))
        out.write(format_list(rows) + "\n")
        elided = stats.get("TenantsElided") or 0
        if elided:
            out.write(f"... and {elided} more tenants elided\n")
    return 0


def cmd_debug(args, out) -> int:
    """Flight-recorder capture (/v1/debug/blackbox): pull one incident
    bundle — span timeline, event tail, metrics, continuous-profile
    window, thread dump, knob/breaker state — from a live agent and
    write it to disk.  The agent must run with enable_debug (the pprof
    gate)."""
    api = _api(args)
    reason = getattr(args, "reason", "") or "operator.cli"
    bundle = api.agent.debug_bundle(reason)
    dest = getattr(args, "output", "") or ""
    if not dest:
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        dest = f"nomad-debug-{stamp}.json"
    with open(dest, "w", encoding="utf-8") as fh:
        json.dump(bundle, fh, indent=1)
    prof = bundle.get("Profile") or {}
    shares = prof.get("Shares") or {}
    top = ", ".join(f"{k}={v:.2f}" for k, v in list(shares.items())[:4]
                    if k != "idle") or "n/a"
    out.write(format_kv([
        f"Bundle|{dest}",
        f"Reason|{bundle.get('Reason')}",
        f"Agent Path|{bundle.get('Path') or 'not persisted (disarmed)'}",
        f"Spans|{len(bundle.get('Spans') or [])}",
        f"Events|{len(bundle.get('Events') or [])}",
        f"Profiler|{'armed' if prof.get('Enabled') else 'disarmed'}",
        f"Top CPU|{top}",
        f"Breaker|{(bundle.get('Breaker') or {}).get('State', 'n/a')}",
        f"Servers|{len(bundle.get('Servers') or [])}",
    ]) + "\n")
    return 0


def cmd_namespace_list(args, out) -> int:
    """Tenancy surface: /v1/namespaces."""
    api = _api(args)
    namespaces, _ = api.namespaces.list()
    if getattr(args, "json", False):
        out.write(json.dumps(
            [to_wire(ns) for ns in namespaces], indent=4, sort_keys=True)
            + "\n")
        return 0
    if not namespaces:
        out.write("No namespaces registered\n")
        return 0
    rows = ["Name|MaxLiveAllocs|MaxPendingEvals|APIRate|Weight|"
            "Objective|Description"]
    for ns in namespaces:
        rows.append("|".join(str(x) for x in (
            ns.name,
            ns.max_live_allocs or "unlimited",
            ns.max_pending_evals or "unlimited",
            ns.api_rate or "unlimited",
            ns.dequeue_weight,
            ns.objective or "(inherit)",
            ns.description)))
    out.write(format_list(rows) + "\n")
    return 0


def cmd_namespace_status(args, out) -> int:
    """Tenancy surface: /v1/namespace/<name> — row + live usage +
    admission counters."""
    api = _api(args)
    try:
        status, _ = api.namespaces.status(args.name)
    except APIError as e:
        out.write(f"Error querying namespace: {e}\n")
        return 1
    if getattr(args, "json", False):
        out.write(json.dumps(status, indent=4, sort_keys=True) + "\n")
        return 0
    row = status.get("Namespace") or {}
    out.write(format_kv([
        f"Name|{row.get('Name')}",
        f"Description|{row.get('Description') or '<none>'}",
        f"Max Live Allocs|{row.get('MaxLiveAllocs') or 'unlimited'}",
        f"Max Pending Evals|{row.get('MaxPendingEvals') or 'unlimited'}",
        f"API Rate|{row.get('ApiRate') or 'unlimited'}",
        f"Dequeue Weight|{row.get('DequeueWeight')}",
        f"Objective|{row.get('Objective') or '(inherit)'}",
    ]) + "\n")
    usage = status.get("Usage") or {}
    if usage:
        out.write("\nLive Usage\n")
        for k in ("CPU", "MemoryMB", "DiskMB", "IOPS", "LiveAllocs"):
            out.write(f"  {k} = {usage.get(k, 0)}\n")
    out.write("\nAdmission\n")
    out.write(f"  ReservedAllocs = {status.get('ReservedAllocs', 0)}\n")
    out.write(f"  PendingEvals   = {status.get('PendingEvals', 0)}\n")
    return 0


def cmd_job_dispatch(args, out) -> int:
    """command/job_dispatch.go."""
    api = _api(args)
    payload = b""
    if args.input_file:
        if args.input_file == "-":
            payload = sys.stdin.buffer.read()
        else:
            with open(args.input_file, "rb") as f:
                payload = f.read()
    meta = {}
    for m in args.meta or []:
        if "=" not in m:
            out.write(f"Invalid meta '{m}': expected key=value\n")
            return 1
        k, v = m.split("=", 1)
        meta[k] = v
    try:
        resp, _ = api.jobs.dispatch(args.job_id, payload=payload, meta=meta)
    except APIError as e:
        out.write(f"Error dispatching job: {e}\n")
        return 1
    out.write(f"Dispatched Job ID = {resp['DispatchedJobID']}\n")
    out.write(f"Evaluation ID     = {limit(resp['EvalID'])}\n")
    if args.detach:
        return 0
    return monitor_eval(api, resp["EvalID"], out)


def cmd_init(args, out) -> int:
    """command/init.go — write a starter example.nomad."""
    path = "example.nomad"
    if os.path.exists(path):
        out.write(f"Job file '{path}' already exists\n")
        return 1
    with open(path, "w", encoding="utf-8") as f:
        f.write(EXAMPLE_JOB)
    out.write(f"Example job file written to {path}\n")
    return 0


def cmd_version(args, out) -> int:
    out.write(f"nomad-tpu v{__version__}\n")
    return 0


def cmd_operator_raft(args, out) -> int:
    """command/operator_raft_list.go."""
    api = _api(args)
    conf = api.operator.raft_get_configuration()
    rows = ["Node|ID|Address|State|Voter"]
    for srv in conf.get("Servers", []):
        state = "leader" if srv.get("Leader") else "follower"
        rows.append(f"{srv['Node']}|{srv['ID']}|{srv['Address']}|{state}|"
                    f"{str(srv.get('Voter', False)).lower()}")
    out.write(format_list(rows) + "\n")
    return 0


def cmd_operator_raft_remove(args, out) -> int:
    """command/operator_raft_remove.go — remove a raft peer by address."""
    api = _api(args)
    try:
        api.operator.raft_remove_peer_by_address(args.peer_address)
    except APIError as e:
        out.write(f"Error removing peer: {e}\n")
        return 1
    out.write(f"Removed peer with address \"{args.peer_address}\"\n")
    return 0


def cmd_system_gc(args, out) -> int:
    """command/system_gc.go: a forced garbage collection."""
    _api(args).system.garbage_collect()
    return 0


def cmd_system_reconcile(args, out) -> int:
    """command/system_reconcile_summaries.go."""
    _api(args).system.reconcile_summaries()
    out.write("==> Reconciled job summaries\n")
    return 0


def cmd_agent(args, out) -> int:
    """command/agent/command.go — run an agent until signalled."""
    from ..agent import Agent, AgentConfig, load_config_file

    if args.dev:
        cfg = AgentConfig.dev()
    elif args.config:
        cfg = load_config_file(args.config)
    else:
        out.write("Must specify either -dev or -config\n")
        return 1
    if args.server:
        cfg.server.enabled = True
    if args.client:
        cfg.client.enabled = True
    if args.bind:
        cfg.bind_addr = args.bind

    agent = Agent(cfg, device=args.device)
    agent.start()
    out.write("==> Nomad-TPU agent started! Log data will stream below:\n")
    out.write(f"    HTTP: {agent.http.address}\n")
    stop = [False]

    def handler(signum, frame):
        stop[0] = True

    signal.signal(signal.SIGINT, handler)
    signal.signal(signal.SIGTERM, handler)
    try:
        while not stop[0]:
            time.sleep(0.2)
    finally:
        out.write("==> Caught signal, gracefully shutting down...\n")
        agent.shutdown()
    return 0


EXAMPLE_JOB = '''# There can only be a single job definition per file.
job "example" {
  datacenters = ["dc1"]
  type        = "service"

  update {
    stagger      = "10s"
    max_parallel = 1
  }

  group "cache" {
    count = 1

    restart {
      attempts = 10
      interval = "5m"
      delay    = "25s"
      mode     = "delay"
    }

    ephemeral_disk {
      size = 300
    }

    task "redis" {
      driver = "exec"

      config {
        command = "/bin/sh"
        args    = ["-c", "while true; do echo tick; sleep 5; done"]
      }

      resources {
        cpu    = 500
        memory = 256

        network {
          mbits = 10
          port "db" {}
        }
      }
    }
  }
}
'''


# ---------------------------------------------------------------------------
# parser / entry (main.go:15 + commands.go:13)
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nomad-tpu",
        description="cluster scheduler CLI (the PyTorch/CUDA port)")
    sub = p.add_subparsers(dest="command")

    def add(name, fn, configure=None):
        sp = sub.add_parser(name)
        _add_common(sp)
        if configure:
            configure(sp)
        sp.set_defaults(fn=fn)
        return sp

    add("run", cmd_run, lambda sp: (
        sp.add_argument("jobfile"),
        sp.add_argument("-detach", action="store_true"),
        sp.add_argument("-output", action="store_true")))
    add("plan", cmd_plan, lambda sp: (
        sp.add_argument("jobfile"),
        sp.add_argument("-no-diff", dest="no_diff", action="store_true"),
        sp.add_argument("-verbose", action="store_true")))
    add("validate", cmd_validate, lambda sp: sp.add_argument("jobfile"))
    add("stop", cmd_stop, lambda sp: (
        sp.add_argument("job_id"),
        sp.add_argument("-detach", action="store_true"),
        sp.add_argument("-purge", action="store_true",
                        help="purge the job (stop always purges, as the "
                             "reference's does)")))
    add("status", cmd_status, lambda sp: (
        sp.add_argument("job_id", nargs="?", default=""),
        sp.add_argument("-short", action="store_true"),
        sp.add_argument("-json", dest="json", action="store_true")))
    add("inspect", cmd_inspect, lambda sp: sp.add_argument("job_id"))
    add("node-status", cmd_node_status, lambda sp: (
        sp.add_argument("node_id", nargs="?", default=""),
        sp.add_argument("-short", action="store_true"),
        sp.add_argument("-json", dest="json", action="store_true")))
    add("node-drain", cmd_node_drain, lambda sp: (
        sp.add_argument("node_id"),
        sp.add_argument("-enable", action="store_true"),
        sp.add_argument("-disable", action="store_true")))
    add("alloc-status", cmd_alloc_status, lambda sp: (
        sp.add_argument("alloc_id"),
        sp.add_argument("-verbose", action="store_true"),
        sp.add_argument("-json", dest="json", action="store_true")))
    add("eval-status", cmd_eval_status, lambda sp: (
        sp.add_argument("eval_id"),
        sp.add_argument("-json", dest="json", action="store_true")))
    add("logs", cmd_logs, lambda sp: (
        sp.add_argument("alloc_id"),
        sp.add_argument("task"),
        sp.add_argument("-stderr", action="store_true"),
        sp.add_argument("-f", dest="follow", action="store_true"),
        sp.add_argument("-tail", dest="tail_bytes", type=int, default=0)))
    add("fs", cmd_fs, lambda sp: (
        sp.add_argument("alloc_id"),
        sp.add_argument("path", nargs="?", default="/"),
        sp.add_argument("-stat", action="store_true"),
        sp.add_argument("-cat", action="store_true"),
        sp.add_argument("-f", dest="follow", action="store_true")))
    add("server-members", cmd_server_members, lambda sp: (
        sp.add_argument("-detailed", action="store_true"),
        sp.add_argument("-json", dest="json", action="store_true")))
    add("regions", cmd_regions, lambda sp:
        sp.add_argument("-json", dest="json", action="store_true"))
    add("server-join", cmd_server_join, lambda sp: sp.add_argument(
        "addresses", nargs="+"))
    add("server-force-leave", cmd_server_force_leave, lambda sp:
        sp.add_argument("node"))
    add("keygen", cmd_keygen)
    add("agent-monitor", cmd_monitor)
    add("events", cmd_events, lambda sp: (
        sp.add_argument("-topic", action="append", default=[],
                        help='filter: "Topic" or "Topic:key", repeatable'),
        sp.add_argument("-index", type=int, default=0,
                        help="resume from this raft index"),
        sp.add_argument("-no-follow", dest="no_follow",
                        action="store_true",
                        help="dump the buffered backlog and exit"),
        sp.add_argument("-json", dest="json", action="store_true")))
    add("check", cmd_check)
    add("broker-status", cmd_broker_status, lambda sp:
        sp.add_argument("-json", dest="json", action="store_true"))
    add("debug", cmd_debug, lambda sp: (
        sp.add_argument("-reason", default="operator.cli",
                        help="reason stamped into the bundle"),
        sp.add_argument("-output", default="",
                        help="bundle destination (default: "
                             "./nomad-debug-<stamp>.json)")))
    add("namespace-list", cmd_namespace_list, lambda sp:
        sp.add_argument("-json", dest="json", action="store_true"))
    add("namespace-status", cmd_namespace_status, lambda sp: (
        sp.add_argument("name"),
        sp.add_argument("-json", dest="json", action="store_true")))
    add("keyring", cmd_keyring, lambda sp: (
        sp.add_argument("-data-dir", dest="data_dir", default=""),
        sp.add_argument("-install", default=""),
        sp.add_argument("-list", dest="list_keys", action="store_true"),
        sp.add_argument("-use", default=""),
        sp.add_argument("-remove", default="")))
    add("agent-info", cmd_agent_info)
    add("job-dispatch", cmd_job_dispatch, lambda sp: (
        sp.add_argument("job_id"),
        sp.add_argument("input_file", nargs="?", default=""),
        sp.add_argument("-meta", action="append"),
        sp.add_argument("-detach", action="store_true")))
    add("init", cmd_init)
    add("version", cmd_version)
    add("operator-raft-list", cmd_operator_raft)
    add("operator-raft-remove-peer", cmd_operator_raft_remove, lambda sp:
        sp.add_argument("-peer-address", dest="peer_address", required=True))
    add("system-gc", cmd_system_gc)
    add("system-reconcile-summaries", cmd_system_reconcile)
    add("agent", cmd_agent, lambda sp: (
        sp.add_argument("-dev", action="store_true"),
        sp.add_argument("-config", default=""),
        sp.add_argument("-server", action="store_true"),
        sp.add_argument("-client", action="store_true"),
        sp.add_argument("-bind", default=""),
        sp.add_argument("-device", default="cuda",
                        help="the device the server places on (cuda, "
                             "cuda:N or cpu)")))
    return p


# The two-word spellings of the verbs (``nomad job run``, ``nomad alloc
# status``): each is the one-word command of the same name.
_TWO_WORD = {
    ("job", "run"): "run", ("job", "plan"): "plan",
    ("job", "status"): "status", ("job", "stop"): "stop",
    ("job", "inspect"): "inspect", ("job", "validate"): "validate",
    ("job", "dispatch"): "job-dispatch", ("job", "init"): "init",
    ("eval", "status"): "eval-status", ("alloc", "status"): "alloc-status",
    ("alloc", "logs"): "logs", ("alloc", "fs"): "fs",
    ("node", "status"): "node-status", ("node", "drain"): "node-drain",
    ("server", "members"): "server-members", ("server", "join"): "server-join",
    ("server", "force-leave"): "server-force-leave",
    ("agent", "info"): "agent-info", ("agent", "monitor"): "agent-monitor",
    ("namespace", "list"): "namespace-list",
    ("namespace", "status"): "namespace-status",
    ("operator", "raft"): "operator-raft", ("system", "gc"): "system-gc",
    ("system", "reconcile"): "system-reconcile",
}
_OPERATOR_RAFT = {"list-peers": "operator-raft-list",
                  "remove-peer": "operator-raft-remove-peer"}


def _one_word(argv: List[str]) -> List[str]:
    """``argv`` with a two-word verb (``job run``, ``operator raft
    list-peers``, ``system reconcile summaries``) as its one-word
    command."""
    verb = _TWO_WORD.get(tuple(argv[:2]))
    if verb is None:
        return argv
    rest = argv[2:]
    if verb == "operator-raft" and rest and rest[0] in _OPERATOR_RAFT:
        return [_OPERATOR_RAFT[rest[0]]] + rest[1:]
    if verb == "system-reconcile" and rest[:1] == ["summaries"]:
        return ["system-reconcile-summaries"] + rest[1:]
    if verb in ("operator-raft", "system-reconcile"):
        return argv
    return [verb] + rest


def main(argv: Optional[List[str]] = None, out=None) -> int:
    out = out or sys.stdout
    parser = build_parser()
    args = parser.parse_args(_one_word(list(
        sys.argv[1:] if argv is None else argv)))
    if not getattr(args, "fn", None):
        parser.print_help(out)
        return 1
    try:
        return args.fn(args, out)
    except CLIError as e:
        out.write(f"Error: {e}\n")
        return 1
    except APIError as e:
        # commands catch expected APIErrors themselves; this is the net for
        # connection-level failures (agent down, bad -address)
        out.write(f"Error querying agent: {e}\n")
        return 1
