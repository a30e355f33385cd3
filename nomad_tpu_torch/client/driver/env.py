"""Task environment builder: NOMAD_* variables and ``${...}``
interpolation for commands/args/configs (a copy of
``nomad_tpu/client/driver/env.py``; reference:
client/driver/env/env.go:101-630).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ...structs import structs as s

# Env var names (env.go:16-100)
ALLOC_DIR = "NOMAD_ALLOC_DIR"
TASK_LOCAL_DIR = "NOMAD_TASK_DIR"
SECRETS_DIR = "NOMAD_SECRETS_DIR"
MEMORY_LIMIT = "NOMAD_MEMORY_LIMIT"
CPU_LIMIT = "NOMAD_CPU_LIMIT"
ALLOC_ID = "NOMAD_ALLOC_ID"
ALLOC_NAME = "NOMAD_ALLOC_NAME"
ALLOC_INDEX = "NOMAD_ALLOC_INDEX"
TASK_NAME = "NOMAD_TASK_NAME"
GROUP_NAME = "NOMAD_GROUP_NAME"
JOB_NAME = "NOMAD_JOB_NAME"
DATACENTER = "NOMAD_DC"
REGION = "NOMAD_REGION"
META_PREFIX = "NOMAD_META_"
ADDR_PREFIX = "NOMAD_ADDR_"
IP_PREFIX = "NOMAD_IP_"
HOST_PORT_PREFIX = "NOMAD_HOST_PORT_"
PORT_PREFIX = "NOMAD_PORT_"
VAULT_TOKEN = "VAULT_TOKEN"

_INTERP = re.compile(r"\$\{([^}]+)\}")


@dataclass
class TaskEnv:
    """Immutable rendered environment (env.go:101 TaskEnv)."""

    env_map: Dict[str, str] = field(default_factory=dict)
    node_attrs: Dict[str, str] = field(default_factory=dict)

    def env(self) -> Dict[str, str]:
        return dict(self.env_map)

    def all(self) -> Dict[str, str]:
        m = dict(self.node_attrs)
        m.update(self.env_map)
        return m

    def replace_env(self, text: Optional[str]) -> Optional[str]:
        """``${var}`` interpolation against env + node attrs
        (env.go:178 ReplaceEnv / helper/args)."""
        if text is None:
            return None
        table = self.all()

        def sub(m: re.Match) -> str:
            return table.get(m.group(1).strip(), "")

        return _INTERP.sub(sub, text)

    def parse_and_replace(self, args: Optional[List[str]]) -> List[str]:
        return [self.replace_env(a) for a in (args or [])]


class Builder:
    """Accumulates job/alloc/task/node facts, then ``build()`` renders the
    TaskEnv (env.go:247 Builder)."""

    def __init__(self):
        self._env: Dict[str, str] = {}
        self._meta: Dict[str, str] = {}
        self._node_attrs: Dict[str, str] = {}
        self._networks: List[s.NetworkResource] = []
        self.task_name = ""
        self.group_name = ""
        self.job_name = ""
        self.alloc_id = ""
        self.alloc_name = ""
        self.alloc_index = -1
        self.datacenter = ""
        self.region = ""
        self.mem_limit = 0
        self.cpu_limit = 0
        self.alloc_dir = ""
        self.local_dir = ""
        self.secrets_dir = ""
        self.vault_token = ""

    # -- fact setters ------------------------------------------------------
    def set_task(self, task: s.Task) -> "Builder":
        self.task_name = task.name
        if task.resources:
            self.mem_limit = task.resources.memory_mb
            self.cpu_limit = task.resources.cpu
            self._networks = [n.copy() for n in (task.resources.networks or [])]
        self._env.update({k: str(v) for k, v in (task.env or {}).items()})
        self._meta.update(task.meta or {})
        return self

    def set_alloc(self, alloc: s.Allocation) -> "Builder":
        self.alloc_id = alloc.id
        self.alloc_name = alloc.name
        self.job_name = alloc.job.name if alloc.job else alloc.job_id
        self.group_name = alloc.task_group
        # alloc index = trailing [N] of "job.group[N]" (structs.go Allocation.Index)
        m = re.search(r"\[(\d+)\]$", alloc.name or "")
        self.alloc_index = int(m.group(1)) if m else -1
        if alloc.job:
            self._meta = {**(alloc.job.meta or {}), **self._meta}
            tg = alloc.job.lookup_task_group(alloc.task_group)
            if tg is not None:
                self._meta.update(tg.meta or {})
        res = (alloc.task_resources or {}).get(self.task_name)
        if res is not None and res.networks:
            self._networks = [n.copy() for n in res.networks]
        return self

    def set_node(self, node: s.Node) -> "Builder":
        self.datacenter = node.datacenter
        attrs = {}
        attrs["node.unique.id"] = node.id
        attrs["node.datacenter"] = node.datacenter
        attrs["node.unique.name"] = node.name
        attrs["node.class"] = node.node_class
        for k, v in (node.attributes or {}).items():
            attrs[f"attr.{k}"] = v
        for k, v in (node.meta or {}).items():
            attrs[f"meta.{k}"] = v
        self._node_attrs.update(attrs)
        return self

    def set_region(self, region: str) -> "Builder":
        self.region = region
        return self

    def set_dirs(self, alloc_dir: str, local_dir: str, secrets_dir: str) -> "Builder":
        self.alloc_dir = alloc_dir
        self.local_dir = local_dir
        self.secrets_dir = secrets_dir
        return self

    def set_vault_token(self, token: str) -> "Builder":
        self.vault_token = token
        return self

    def set_env(self, key: str, value: str) -> "Builder":
        self._env[key] = value
        return self

    # -- rendering ---------------------------------------------------------
    @staticmethod
    def _clean(name: str) -> str:
        return re.sub(r"[^a-zA-Z0-9_]", "_", name)

    def build(self) -> TaskEnv:
        env: Dict[str, str] = {}
        if self.alloc_dir:
            env[ALLOC_DIR] = self.alloc_dir
        if self.local_dir:
            env[TASK_LOCAL_DIR] = self.local_dir
        if self.secrets_dir:
            env[SECRETS_DIR] = self.secrets_dir
        if self.mem_limit:
            env[MEMORY_LIMIT] = str(self.mem_limit)
        if self.cpu_limit:
            env[CPU_LIMIT] = str(self.cpu_limit)
        if self.alloc_id:
            env[ALLOC_ID] = self.alloc_id
        if self.alloc_name:
            env[ALLOC_NAME] = self.alloc_name
        if self.alloc_index >= 0:
            env[ALLOC_INDEX] = str(self.alloc_index)
        if self.task_name:
            env[TASK_NAME] = self.task_name
        if self.group_name:
            env[GROUP_NAME] = self.group_name
        if self.job_name:
            env[JOB_NAME] = self.job_name
        if self.datacenter:
            env[DATACENTER] = self.datacenter
        if self.region:
            env[REGION] = self.region
        if self.vault_token:
            env[VAULT_TOKEN] = self.vault_token

        # Network/port env (env.go:447 buildNetworkEnv)
        for net in self._networks:
            for label, port in net.port_labels().items():
                clean = self._clean(label)
                env[f"{IP_PREFIX}{clean}"] = net.ip
                env[f"{PORT_PREFIX}{clean}"] = str(port)
                env[f"{HOST_PORT_PREFIX}{clean}"] = str(port)
                env[f"{ADDR_PREFIX}{clean}"] = f"{net.ip}:{port}"

        for k, v in self._meta.items():
            env[f"{META_PREFIX}{self._clean(k.upper())}"] = str(v)
            env[f"{META_PREFIX}{self._clean(k)}"] = str(v)

        # Task env block last, interpolated against node attrs + built env
        table = dict(self._node_attrs)
        table.update({f"env.{k}": v for k, v in env.items()})
        table.update(env)
        for k, v in self._env.items():
            env[k] = _INTERP.sub(lambda m: table.get(m.group(1).strip(), ""), v)

        return TaskEnv(env_map=env, node_attrs=dict(self._node_attrs))
