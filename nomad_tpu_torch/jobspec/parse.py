"""Job-file parser: HCL source -> structs.Job (a copy of
``nomad_tpu/jobspec/parse.py``; a job's ``vault_token`` is refused).

Reference behavior: jobspec/parse.go (Parse at parse.go:30, per-block strict
key validation at parse.go:1280 checkHCLKeys, constraint operator sugar at
parse.go:241-330, port-label validation parse.go:1083-1110).  The reference
decodes into the api.Job shape and the CLI converts to structs.Job
(command/helpers.go); here we map straight to structs.Job since both live in
one process.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

from ..structs import structs as s
from .hcl import Block, Entry, HCLError, parse_hcl


class ParseError(ValueError):
    pass


# Go time.ParseDuration subset: int/float + unit, concatenations allowed
# ("1h30m"), bare numbers rejected (like Go).
_DUR_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")
_DUR_UNITS = {"ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3,
              "s": 1.0, "m": 60.0, "h": 3600.0}

_PORT_LABEL_RE = re.compile(r"^[a-zA-Z0-9_]+$")


def parse_duration(v) -> float:
    """'10m' -> 600.0 seconds.  Accepts ints/floats as seconds for
    convenience when a numeric literal is given."""
    if isinstance(v, (int, float)):
        return float(v)
    text = str(v).strip()
    if text in ("0", ""):
        return 0.0
    pos = 0
    total = 0.0
    neg = text.startswith("-")
    if neg:
        pos = 1
    matched = False
    while pos < len(text):
        m = _DUR_RE.match(text, pos)
        if not m:
            raise ParseError(f"invalid duration {v!r}")
        total += float(m.group(1)) * _DUR_UNITS[m.group(2)]
        pos = m.end()
        matched = True
    if not matched:
        raise ParseError(f"invalid duration {v!r}")
    return -total if neg else total


def _check_keys(blk: Block, valid: List[str], context: str) -> None:
    """Strict unknown-key rejection (parse.go:1280 checkHCLKeys)."""
    vs = set(valid)
    for e in blk.entries:
        if e.key not in vs:
            raise ParseError(f"{context} -> invalid key: {e.key}")


def _attr(blk: Block, key: str, default=None):
    e = blk.one(key)
    if e is None:
        return default
    if isinstance(e.value, Block):
        raise ParseError(f"'{key}' must be an attribute, not a block")
    return e.value


def _str_map(entry: Optional[Entry], context: str) -> Dict[str, str]:
    if entry is None:
        return {}
    if not isinstance(entry.value, Block):
        raise ParseError(f"{context}: '{entry.key}' must be a block or map")
    out: Dict[str, str] = {}
    for e in entry.value.entries:
        if isinstance(e.value, Block):
            raise ParseError(f"{context}: nested block in '{entry.key}' map")
        v = e.value
        if isinstance(v, bool):
            v = "true" if v else "false"
        out[e.key] = str(v)
    return out


def _blocks(blk: Block, key: str, context: str) -> List[Block]:
    out = []
    for e in blk.get(key):
        if not isinstance(e.value, Block):
            raise ParseError(f"{context}: '{key}' must be a block")
        out.append(e.value)
    return out


# ---------------------------------------------------------------------------
# Constraints (parse.go:241-330): operator sugar keys
# ---------------------------------------------------------------------------


def parse_constraints(parent: Block, context: str) -> List[s.Constraint]:
    out: List[s.Constraint] = []
    for blk in _blocks(parent, "constraint", context):
        _check_keys(blk, ["attribute", "operator", "value", "version",
                          "regexp", "distinct_hosts", "distinct_property",
                          "set_contains"], f"{context} -> constraint")
        attr = _attr(blk, "attribute", "")
        operand = _attr(blk, "operator", "")
        value = _attr(blk, "value", "")

        for sugar in (s.CONSTRAINT_VERSION, s.CONSTRAINT_REGEX,
                      s.CONSTRAINT_SET_CONTAINS):
            sv = _attr(blk, sugar, None)
            if sv is not None:
                operand = sugar
                value = str(sv)

        if _attr(blk, "distinct_hosts", False):
            operand = s.CONSTRAINT_DISTINCT_HOSTS
        dp = _attr(blk, "distinct_property", None)
        if dp is not None:
            operand = s.CONSTRAINT_DISTINCT_PROPERTY
            attr = str(dp)

        if not operand:
            operand = "="
        out.append(s.Constraint(ltarget=str(attr), rtarget=str(value),
                                operand=operand))
    return out


# ---------------------------------------------------------------------------
# Leaf blocks
# ---------------------------------------------------------------------------


def _parse_update(blk: Block, context: str) -> s.UpdateStrategy:
    # 0.6-dev accepts the richer deployment-era keys; only stagger +
    # max_parallel drive behavior at this snapshot (structs.go:1702).
    _check_keys(blk, ["stagger", "max_parallel", "health_check",
                      "min_healthy_time", "healthy_deadline", "auto_revert",
                      "canary"], context)
    u = s.UpdateStrategy()
    st = _attr(blk, "stagger", None)
    if st is not None:
        u.stagger = parse_duration(st)
    u.max_parallel = int(_attr(blk, "max_parallel", 0))
    return u


def _parse_periodic(blk: Block, context: str) -> s.PeriodicConfig:
    _check_keys(blk, ["enabled", "cron", "prohibit_overlap", "time_zone"],
                context)
    p = s.PeriodicConfig(enabled=bool(_attr(blk, "enabled", True)),
                         prohibit_overlap=bool(_attr(blk, "prohibit_overlap",
                                                     False)))
    cron = _attr(blk, "cron", None)
    if cron is not None:
        p.spec_type = s.PERIODIC_SPEC_CRON
        p.spec = str(cron)
    return p


def _parse_parameterized(blk: Block, context: str) -> s.ParameterizedJobConfig:
    _check_keys(blk, ["payload", "meta_required", "meta_optional"], context)
    return s.ParameterizedJobConfig(
        payload=str(_attr(blk, "payload", "")),
        meta_required=[str(x) for x in (_attr(blk, "meta_required", []) or [])],
        meta_optional=[str(x) for x in (_attr(blk, "meta_optional", []) or [])])


def _parse_restart(blk: Block, context: str) -> s.RestartPolicy:
    _check_keys(blk, ["attempts", "interval", "delay", "mode"], context)
    r = s.RestartPolicy()
    if _attr(blk, "attempts", None) is not None:
        r.attempts = int(_attr(blk, "attempts"))
    if _attr(blk, "interval", None) is not None:
        r.interval = parse_duration(_attr(blk, "interval"))
    if _attr(blk, "delay", None) is not None:
        r.delay = parse_duration(_attr(blk, "delay"))
    if _attr(blk, "mode", None) is not None:
        r.mode = str(_attr(blk, "mode"))
    return r


def _parse_ephemeral_disk(blk: Block, context: str) -> s.EphemeralDisk:
    _check_keys(blk, ["sticky", "size", "migrate"], context)
    d = s.EphemeralDisk()
    d.sticky = bool(_attr(blk, "sticky", False))
    d.migrate = bool(_attr(blk, "migrate", False))
    if _attr(blk, "size", None) is not None:
        d.size_mb = int(_attr(blk, "size"))
    return d


def _parse_vault(blk: Block, context: str) -> s.Vault:
    _check_keys(blk, ["policies", "env", "change_mode", "change_signal"],
                context)
    v = s.Vault(policies=[str(p) for p in (_attr(blk, "policies", []) or [])])
    v.env = bool(_attr(blk, "env", True))
    v.change_mode = str(_attr(blk, "change_mode", "restart"))
    v.change_signal = str(_attr(blk, "change_signal", "")).upper() \
        if _attr(blk, "change_signal", None) else ""
    if v.change_mode == "signal" and not v.change_signal:
        raise ParseError(
            f"{context}: change_signal required when change_mode is signal")
    return v


def _parse_logs(blk: Block, context: str) -> s.LogConfig:
    _check_keys(blk, ["max_files", "max_file_size"], context)
    lc = s.LogConfig()
    if _attr(blk, "max_files", None) is not None:
        lc.max_files = int(_attr(blk, "max_files"))
    if _attr(blk, "max_file_size", None) is not None:
        lc.max_file_size_mb = int(_attr(blk, "max_file_size"))
    return lc


def _parse_artifact(blk: Block, context: str) -> s.TaskArtifact:
    _check_keys(blk, ["source", "destination", "mode", "options"], context)
    a = s.TaskArtifact(
        getter_source=str(_attr(blk, "source", "")),
        relative_dest=str(_attr(blk, "destination", "local/")))
    a.getter_options = _str_map(blk.one("options"), context)
    if not a.getter_source:
        raise ParseError(f"{context}: artifact requires a source")
    return a


def _parse_template(blk: Block, context: str) -> s.Template:
    _check_keys(blk, ["source", "destination", "data", "change_mode",
                      "change_signal", "splay", "perms", "left_delimiter",
                      "right_delimiter", "env"], context)
    t = s.Template(
        source_path=str(_attr(blk, "source", "")),
        dest_path=str(_attr(blk, "destination", "")),
        embedded_tmpl=str(_attr(blk, "data", "")))
    if _attr(blk, "change_mode", None) is not None:
        t.change_mode = str(_attr(blk, "change_mode"))
    if _attr(blk, "change_signal", None) is not None:
        t.change_signal = str(_attr(blk, "change_signal")).upper()
    if _attr(blk, "splay", None) is not None:
        t.splay = parse_duration(_attr(blk, "splay"))
    if _attr(blk, "perms", None) is not None:
        t.perms = str(_attr(blk, "perms"))
    return t


def _parse_check(blk: Block, context: str) -> s.ServiceCheck:
    _check_keys(blk, ["name", "type", "interval", "timeout", "path",
                      "protocol", "port", "command", "args",
                      "initial_status"], context)
    c = s.ServiceCheck(
        name=str(_attr(blk, "name", "")),
        type=str(_attr(blk, "type", "")).lower(),
        command=str(_attr(blk, "command", "")),
        args=[str(a) for a in (_attr(blk, "args", []) or [])],
        path=str(_attr(blk, "path", "")),
        protocol=str(_attr(blk, "protocol", "")),
        port_label=str(_attr(blk, "port", "")),
        initial_status=str(_attr(blk, "initial_status", "")))
    if _attr(blk, "interval", None) is not None:
        c.interval = parse_duration(_attr(blk, "interval"))
    if _attr(blk, "timeout", None) is not None:
        c.timeout = parse_duration(_attr(blk, "timeout"))
    return c


def _parse_service(blk: Block, job: str, group: str, task: str,
                   context: str) -> s.Service:
    _check_keys(blk, ["name", "tags", "port", "check", "address_mode"],
                context)
    svc = s.Service(
        name=str(_attr(blk, "name", "")),
        port_label=str(_attr(blk, "port", "")),
        tags=[str(t) for t in (_attr(blk, "tags", []) or [])])
    if not svc.name:
        # default service name (api.Service canonicalization)
        svc.name = f"{job}-{group}-{task}"
    for cb in _blocks(blk, "check", context):
        svc.checks.append(_parse_check(cb, f"{context} -> check"))
    return svc


def _parse_network(blk: Block, context: str) -> s.NetworkResource:
    _check_keys(blk, ["mbits", "port"], context)
    net = s.NetworkResource()
    mb = _attr(blk, "mbits", None)
    if mb is not None:
        net.mbits = int(mb)
    seen: Dict[str, bool] = {}
    for e in blk.get("port"):
        if not isinstance(e.value, Block) or len(e.labels) != 1:
            raise ParseError(f"{context}: port must be a named block")
        label = e.labels[0]
        if not _PORT_LABEL_RE.match(label):
            raise ParseError(
                f"{context}: port label '{label}' does not conform to naming "
                f"requirements {_PORT_LABEL_RE.pattern}")
        if label in seen:
            raise ParseError(f"{context}: found a port label collision: {label}")
        seen[label] = True
        _check_keys(e.value, ["static"], f"{context} -> port {label}")
        static = _attr(e.value, "static", None)
        if static is not None:
            net.reserved_ports.append(s.Port(label, int(static)))
        else:
            net.dynamic_ports.append(s.Port(label, 0))
    return net


def _parse_resources(blk: Block, context: str) -> s.Resources:
    _check_keys(blk, ["cpu", "memory", "disk", "iops", "network"], context)
    r = s.Resources(cpu=100, memory_mb=10)  # api defaults (api/resources.go)
    if _attr(blk, "cpu", None) is not None:
        r.cpu = int(_attr(blk, "cpu"))
    if _attr(blk, "memory", None) is not None:
        r.memory_mb = int(_attr(blk, "memory"))
    if _attr(blk, "disk", None) is not None:
        r.disk_mb = int(_attr(blk, "disk"))
    if _attr(blk, "iops", None) is not None:
        r.iops = int(_attr(blk, "iops"))
    nets = _blocks(blk, "network", context)
    if len(nets) > 1:
        raise ParseError(f"{context}: only one network resource allowed")
    for nb in nets:
        r.networks.append(_parse_network(nb, f"{context} -> network"))
    return r


# ---------------------------------------------------------------------------
# Task / group / job
# ---------------------------------------------------------------------------

_TASK_KEYS = ["artifact", "config", "constraint", "dispatch_payload",
              "driver", "env", "kill_timeout", "leader", "logs", "meta",
              "resources", "service", "template", "user", "vault"]


def _parse_task(entry: Entry, job_name: str, group_name: str) -> s.Task:
    if len(entry.labels) != 1:
        raise ParseError("task block requires a single name label")
    name = entry.labels[0]
    blk = entry.value
    if not isinstance(blk, Block):
        raise ParseError(f"task '{name}': must be a block")
    ctx = f"task '{name}'"
    _check_keys(blk, _TASK_KEYS, ctx)

    task = s.Task(name=name)
    task.driver = str(_attr(blk, "driver", ""))
    task.user = str(_attr(blk, "user", ""))
    task.leader = bool(_attr(blk, "leader", False))
    kt = _attr(blk, "kill_timeout", None)
    if kt is not None:
        task.kill_timeout = parse_duration(kt)
    cfg = blk.one("config")
    if cfg is not None:
        if not isinstance(cfg.value, Block):
            raise ParseError(f"{ctx}: config must be a block")
        task.config = cfg.value.to_dict()
    task.env = _str_map(blk.one("env"), ctx)
    task.meta = _str_map(blk.one("meta"), ctx)
    task.constraints = parse_constraints(blk, ctx)
    for sb in _blocks(blk, "service", ctx):
        task.services.append(
            _parse_service(sb, job_name, group_name, name, f"{ctx} -> service"))
    res = blk.one("resources")
    if res is not None:
        if not isinstance(res.value, Block):
            raise ParseError(f"{ctx}: resources must be a block")
        task.resources = _parse_resources(res.value, f"{ctx} -> resources")
    logs = _blocks(blk, "logs", ctx)
    if len(logs) > 1:
        raise ParseError(f"{ctx}: only one logs block is allowed")
    if logs:
        task.log_config = _parse_logs(logs[0], f"{ctx} -> logs")
    for ab in _blocks(blk, "artifact", ctx):
        task.artifacts.append(_parse_artifact(ab, f"{ctx} -> artifact"))
    for tb in _blocks(blk, "template", ctx):
        task.templates.append(_parse_template(tb, f"{ctx} -> template"))
    vb = _blocks(blk, "vault", ctx)
    if vb:
        task.vault = _parse_vault(vb[0], f"{ctx} -> vault")
    dp = _blocks(blk, "dispatch_payload", ctx)
    if dp:
        _check_keys(dp[0], ["file"], f"{ctx} -> dispatch_payload")
        task.dispatch_payload = s.DispatchPayloadConfig(
            file=str(_attr(dp[0], "file", "")))
    return task


_GROUP_KEYS = ["count", "constraint", "restart", "ephemeral_disk", "update",
               "task", "meta", "vault"]


def _parse_group(entry: Entry, job_name: str) -> s.TaskGroup:
    if len(entry.labels) != 1:
        raise ParseError("group block requires a single name label")
    name = entry.labels[0]
    blk = entry.value
    if not isinstance(blk, Block):
        raise ParseError(f"group '{name}': must be a block")
    ctx = f"group '{name}'"
    _check_keys(blk, _GROUP_KEYS, ctx)

    tg = s.TaskGroup(name=name)
    if _attr(blk, "count", None) is not None:
        tg.count = int(_attr(blk, "count"))
    tg.constraints = parse_constraints(blk, ctx)
    tg.meta = _str_map(blk.one("meta"), ctx)
    rb = _blocks(blk, "restart", ctx)
    if rb:
        tg.restart_policy = _parse_restart(rb[0], f"{ctx} -> restart")
    eb = _blocks(blk, "ephemeral_disk", ctx)
    if eb:
        tg.ephemeral_disk = _parse_ephemeral_disk(
            eb[0], f"{ctx} -> ephemeral_disk")
    group_vault: Optional[s.Vault] = None
    vb = _blocks(blk, "vault", ctx)
    if vb:
        group_vault = _parse_vault(vb[0], f"{ctx} -> vault")
    for te in blk.get("task"):
        tg.tasks.append(_parse_task(te, job_name, name))
    # vault inheritance: group-level block applies to tasks without their own
    # (jobspec/parse.go job/group vault propagation)
    if group_vault is not None:
        for t in tg.tasks:
            if t.vault is None:
                t.vault = group_vault.copy()
    return tg


_JOB_KEYS = ["id", "name", "region", "all_at_once", "constraint",
             "datacenters", "group", "meta", "parameterized", "periodic",
             "priority", "task", "type", "update", "vault", "vault_token"]


def parse_job(entry: Entry) -> s.Job:
    if len(entry.labels) != 1:
        raise ParseError("'job' block requires a single name label")
    blk = entry.value
    if not isinstance(blk, Block):
        raise ParseError("'job' must be a block")
    ctx = f"job '{entry.labels[0]}'"
    _check_keys(blk, _JOB_KEYS, ctx)

    job = s.Job(id=str(_attr(blk, "id", entry.labels[0])))
    job.name = str(_attr(blk, "name", job.id))
    job.region = str(_attr(blk, "region", "global"))
    job.type = str(_attr(blk, "type", s.JOB_TYPE_SERVICE))
    if _attr(blk, "priority", None) is not None:
        job.priority = int(_attr(blk, "priority"))
    job.all_at_once = bool(_attr(blk, "all_at_once", False))
    job.datacenters = [str(d) for d in (_attr(blk, "datacenters", []) or [])]
    job.vault_token = str(_attr(blk, "vault_token", ""))
    job.constraints = parse_constraints(blk, ctx)
    job.meta = _str_map(blk.one("meta"), ctx)
    ub = _blocks(blk, "update", ctx)
    if ub:
        job.update = _parse_update(ub[0], f"{ctx} -> update")
    pb = _blocks(blk, "periodic", ctx)
    if pb:
        job.periodic = _parse_periodic(pb[0], f"{ctx} -> periodic")
    qb = _blocks(blk, "parameterized", ctx)
    if qb:
        job.parameterized_job = _parse_parameterized(
            qb[0], f"{ctx} -> parameterized")
    job_vault: Optional[s.Vault] = None
    vb = _blocks(blk, "vault", ctx)
    if vb:
        job_vault = _parse_vault(vb[0], f"{ctx} -> vault")

    for ge in blk.get("group"):
        job.task_groups.append(_parse_group(ge, job.name))
    # bare task blocks wrap into a single-task group of the same name
    # (parse.go:615-617)
    for te in blk.get("task"):
        task = _parse_task(te, job.name, te.labels[0] if te.labels else "")
        job.task_groups.append(s.TaskGroup(name=task.name, count=1,
                                           tasks=[task]))
    if job_vault is not None:
        for tg in job.task_groups:
            for t in tg.tasks:
                if t.vault is None:
                    t.vault = job_vault.copy()
    return job


def parse(src: str) -> s.Job:
    """Parse HCL job-file source into a structs.Job (jobspec.Parse,
    parse.go:30).  Exactly one top-level job block is required."""
    try:
        root = parse_hcl(src)
    except HCLError as e:
        raise ParseError(str(e)) from e
    _check_keys(root, ["job"], "root")
    jobs = root.get("job")
    if len(jobs) == 0:
        raise ParseError("'job' stanza not found")
    if len(jobs) > 1:
        raise ParseError("only one 'job' block allowed per file")
    return parse_job(jobs[0])


def parse_file(path: str) -> s.Job:
    with open(path, "r", encoding="utf-8") as f:
        return parse(f.read())
