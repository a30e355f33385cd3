"""Python SDK for the HTTP API (a copy of ``nomad_tpu/api/client.py``).

Reference behavior: the api/ Go package (api/api.go Client + per-resource
handles api/jobs.go, api/nodes.go, api/allocations.go, api/evaluations.go,
api/agent.go, api/operator.go, api/system.go).  Shapes: jobs are
structs.Job dataclasses encoded through api/codec.py; list endpoints return
stub dicts exactly as the HTTP layer emits them.

QueryOptions carry the blocking-query contract (wait_index + wait_time ->
``?index&wait``), and every query returns QueryMeta with the last index so
callers can long-poll, like the reference's WaitIndex loop.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ..structs import structs as s
from ..utils.backoff import Backoff
from .codec import from_wire, to_wire


class APIError(Exception):
    def __init__(self, code: int, message: str, retry_after: float = 0.0):
        super().__init__(f"Unexpected response code: {code} ({message})")
        self.code = code
        # 429 admission NACKs carry the server's Retry-After hint;
        # callers feed it into their jittered-backoff retry loops.
        self.retry_after = retry_after


@dataclass
class QueryOptions:
    region: str = ""
    prefix: str = ""
    wait_index: int = 0
    wait_time: float = 0.0  # seconds
    params: Optional[Dict[str, str]] = None


@dataclass
class QueryMeta:
    last_index: int = 0
    known_leader: bool = False


class NomadAPI:
    """api.Client (api/api.go:221 NewClient)."""

    def __init__(self, address: str = "http://127.0.0.1:4646",
                 region: str = "", timeout: float = 330.0):
        self.address = address.rstrip("/")
        self.region = region
        self.timeout = timeout
        self.jobs = Jobs(self)
        self.nodes = Nodes(self)
        self.allocations = Allocations(self)
        self.evaluations = Evaluations(self)
        self.agent = AgentAPI(self)
        self.system = System(self)
        self.operator = Operator(self)
        self.status = Status(self)
        self.events = Events(self)
        self.namespaces = Namespaces(self)
        self.regions = Regions(self)

    # -- raw transport -----------------------------------------------------

    def _url(self, path: str, q: Optional[QueryOptions]) -> str:
        params: Dict[str, str] = {}
        if q is not None:
            if q.region or self.region:
                params["region"] = q.region or self.region
            if q.prefix:
                params["prefix"] = q.prefix
            if q.wait_index:
                params["index"] = str(q.wait_index)
            if q.wait_time:
                params["wait"] = f"{q.wait_time}s"
            if q.params:
                params.update(q.params)
        qs = ("?" + urllib.parse.urlencode(params)) if params else ""
        return self.address + path + qs

    def _do(self, method: str, path: str, body: Any = None,
            q: Optional[QueryOptions] = None) -> Tuple[Any, QueryMeta]:
        data = None
        if body is not None:
            data = json.dumps(to_wire(body)).encode()
        req = urllib.request.Request(self._url(path, q), data=data,
                                     method=method)
        req.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                raw = resp.read()
                meta = QueryMeta(
                    last_index=int(resp.headers.get("X-Nomad-Index") or 0),
                    known_leader=resp.headers.get(
                        "X-Nomad-KnownLeader") == "true")
                obj = json.loads(raw) if raw else None
                return obj, meta
        except urllib.error.HTTPError as e:
            try:
                retry_after = float(e.headers.get("Retry-After") or 0.0)
            except (TypeError, ValueError):
                retry_after = 0.0
            raise APIError(e.code, e.read().decode("utf-8", "replace"),
                           retry_after=retry_after) from e
        except urllib.error.URLError as e:
            # connection-level failure (agent down, bad address)
            raise APIError(0, f"failed to reach agent at "
                              f"{self.address}: {e.reason}") from e

    def get(self, path: str, q: Optional[QueryOptions] = None):
        return self._do("GET", path, None, q)

    def put(self, path: str, body: Any = None, q: Optional[QueryOptions] = None):
        return self._do("PUT", path, body, q)

    def delete(self, path: str, q: Optional[QueryOptions] = None):
        return self._do("DELETE", path, None, q)


class Jobs:
    """api/jobs.go."""

    def __init__(self, c: NomadAPI):
        self.c = c

    def list(self, q: Optional[QueryOptions] = None) -> Tuple[List[dict], QueryMeta]:
        return self.c.get("/v1/jobs", q)

    def register(self, job: s.Job,
                 q: Optional[QueryOptions] = None) -> Tuple[dict, QueryMeta]:
        return self.c.put("/v1/jobs", {"Job": to_wire(job)},
                          q or QueryOptions())

    def register_with_retry(self, job: s.Job, retries: int = 5,
                            q: Optional[QueryOptions] = None,
                            sleep=time.sleep,
                            backoff: Optional[Backoff] = None
                            ) -> Tuple[dict, QueryMeta]:
        """register() with jittered client-side retry on 429 admission
        NACKs.  The delay honors the server's Retry-After hint but
        jitters it (0.5x-1.5x) so a rejected burst doesn't re-arrive as
        the same burst, and never waits less than the utils/backoff
        exponential floor.  Non-429 errors (and the final 429) raise
        unchanged."""
        bo = backoff or Backoff(base=0.05, max_delay=5.0)
        for attempt in range(retries + 1):
            try:
                return self.register(job, q)
            except APIError as e:
                if e.code != 429 or attempt >= retries:
                    raise
                delay = bo.next_delay()
                if e.retry_after > 0:
                    delay = max(delay,
                                e.retry_after * (0.5 + bo.rng.random()))
                sleep(delay)
        raise AssertionError("unreachable")

    def info(self, job_id: str, q: Optional[QueryOptions] = None
             ) -> Tuple[s.Job, QueryMeta]:
        obj, meta = self.c.get(f"/v1/job/{job_id}", q)
        return from_wire(s.Job, obj), meta

    def deregister(self, job_id: str, purge: bool = True,
                   q: Optional[QueryOptions] = None) -> Tuple[dict, QueryMeta]:
        base = q or QueryOptions()
        params = dict(base.params or {})
        params["purge"] = "true" if purge else "false"
        merged = QueryOptions(region=base.region, prefix=base.prefix,
                              wait_index=base.wait_index,
                              wait_time=base.wait_time, params=params)
        return self.c.delete(f"/v1/job/{job_id}", merged)

    def allocations(self, job_id: str, all_allocs: bool = False,
                    q: Optional[QueryOptions] = None):
        q = q or QueryOptions()
        if all_allocs:
            q.params = dict(q.params or {}, all="true")
        return self.c.get(f"/v1/job/{job_id}/allocations", q)

    def evaluations(self, job_id: str, q: Optional[QueryOptions] = None):
        return self.c.get(f"/v1/job/{job_id}/evaluations", q)

    def summary(self, job_id: str, q: Optional[QueryOptions] = None
                ) -> Tuple[s.JobSummary, QueryMeta]:
        obj, meta = self.c.get(f"/v1/job/{job_id}/summary", q)
        return from_wire(s.JobSummary, obj), meta

    def plan(self, job: s.Job, diff: bool = True) -> Tuple[s.JobPlanResponse, QueryMeta]:
        obj, meta = self.c.put(f"/v1/job/{job.id}/plan",
                               {"Job": to_wire(job), "Diff": diff})
        return from_wire(s.JobPlanResponse, obj), meta

    def evaluate(self, job_id: str) -> Tuple[dict, QueryMeta]:
        return self.c.put(f"/v1/job/{job_id}/evaluate")

    def periodic_force(self, job_id: str) -> Tuple[dict, QueryMeta]:
        return self.c.put(f"/v1/job/{job_id}/periodic/force")

    def dispatch(self, job_id: str, payload: bytes = b"",
                 meta: Optional[Dict[str, str]] = None) -> Tuple[dict, QueryMeta]:
        import base64
        body = {"Payload": base64.b64encode(payload).decode("ascii")
                if payload else "", "Meta": meta or {}}
        return self.c.put(f"/v1/job/{job_id}/dispatch", body)

    def validate(self, job: s.Job) -> Tuple[dict, QueryMeta]:
        return self.c.put("/v1/validate/job", {"Job": to_wire(job)})


class Nodes:
    """api/nodes.go."""

    def __init__(self, c: NomadAPI):
        self.c = c

    def list(self, q: Optional[QueryOptions] = None):
        return self.c.get("/v1/nodes", q)

    def info(self, node_id: str, q: Optional[QueryOptions] = None
             ) -> Tuple[s.Node, QueryMeta]:
        obj, meta = self.c.get(f"/v1/node/{node_id}", q)
        return from_wire(s.Node, obj), meta

    def allocations(self, node_id: str, q: Optional[QueryOptions] = None
                    ) -> Tuple[List[s.Allocation], QueryMeta]:
        obj, meta = self.c.get(f"/v1/node/{node_id}/allocations", q)
        return [from_wire(s.Allocation, a) for a in obj or []], meta

    def force_evaluate(self, node_id: str) -> Tuple[dict, QueryMeta]:
        return self.c.put(f"/v1/node/{node_id}/evaluate")

    def toggle_drain(self, node_id: str, drain: bool) -> Tuple[dict, QueryMeta]:
        q = QueryOptions(params={"enable": "true" if drain else "false"})
        return self.c.put(f"/v1/node/{node_id}/drain", None, q)


class Allocations:
    """api/allocations.go."""

    def __init__(self, c: NomadAPI):
        self.c = c

    def list(self, q: Optional[QueryOptions] = None):
        return self.c.get("/v1/allocations", q)

    def info(self, alloc_id: str, q: Optional[QueryOptions] = None
             ) -> Tuple[s.Allocation, QueryMeta]:
        obj, meta = self.c.get(f"/v1/allocation/{alloc_id}", q)
        return from_wire(s.Allocation, obj), meta


class Evaluations:
    """api/evaluations.go."""

    def __init__(self, c: NomadAPI):
        self.c = c

    def list(self, q: Optional[QueryOptions] = None
             ) -> Tuple[List[s.Evaluation], QueryMeta]:
        obj, meta = self.c.get("/v1/evaluations", q)
        return [from_wire(s.Evaluation, e) for e in obj or []], meta

    def info(self, eval_id: str, q: Optional[QueryOptions] = None
             ) -> Tuple[s.Evaluation, QueryMeta]:
        obj, meta = self.c.get(f"/v1/evaluation/{eval_id}", q)
        return from_wire(s.Evaluation, obj), meta

    def allocations(self, eval_id: str, q: Optional[QueryOptions] = None):
        return self.c.get(f"/v1/evaluation/{eval_id}/allocations", q)


class AgentAPI:
    """api/agent.go."""

    def __init__(self, c: NomadAPI):
        self.c = c

    def self_info(self) -> dict:
        obj, _ = self.c.get("/v1/agent/self")
        return obj

    def members(self) -> dict:
        obj, _ = self.c.get("/v1/agent/members")
        return obj

    def servers(self) -> List[str]:
        obj, _ = self.c.get("/v1/agent/servers")
        return obj or []

    def join(self, addresses) -> dict:
        q = QueryOptions(params={"address": ",".join(addresses)})
        obj, _ = self.c.put("/v1/agent/join", None, q)
        return obj or {}

    def force_leave(self, node: str) -> None:
        q = QueryOptions(params={"node": node})
        self.c.put("/v1/agent/force-leave", None, q)

    # Gossip keyring (api/agent.go:175-215 ListKeys/InstallKey/UseKey/
    # RemoveKey → /v1/agent/keyring/<op>).
    def list_keys(self) -> dict:
        obj, _ = self.c.get("/v1/agent/keyring/list")
        return obj

    def install_key(self, key: str) -> dict:
        obj, _ = self.c.put("/v1/agent/keyring/install", {"Key": key})
        return obj

    def use_key(self, key: str) -> dict:
        obj, _ = self.c.put("/v1/agent/keyring/use", {"Key": key})
        return obj

    def remove_key(self, key: str) -> dict:
        obj, _ = self.c.put("/v1/agent/keyring/remove", {"Key": key})
        return obj

    def profile_continuous(self, seconds: float = 60.0) -> dict:
        """Rolling host-attribution window (/v1/profile/continuous):
        CPU shares per subsystem, coverage, GIL pressure, top locks."""
        q = QueryOptions(params={"seconds": str(seconds)})
        obj, _ = self.c.get("/v1/profile/continuous", q)
        return obj

    def debug_bundle(self, reason: str = "operator.request") -> dict:
        """Force a flight-recorder capture (/v1/debug/blackbox) and
        return the bundle (requires enable_debug on the agent)."""
        q = QueryOptions(params={"reason": reason})
        obj, _ = self.c.get("/v1/debug/blackbox", q)
        return obj

    def client_stats(self) -> dict:
        obj, _ = self.c.get("/v1/client/stats")
        return obj

    def alloc_stats(self, alloc_id: str) -> dict:
        obj, _ = self.c.get(f"/v1/client/allocation/{alloc_id}/stats")
        return obj

    def task_logs(self, alloc_id: str, task: str,
                  log_type: str = "stdout") -> str:
        obj, _ = self.c.get(
            f"/v1/client/fs/logs/{alloc_id}",
            QueryOptions(params={"task": task, "type": log_type}))
        return obj or ""

    def _stream(self, path: str, params: Dict[str, str], follow: bool):
        """Consume an NDJSON StreamFrame response (api/fs.go Stream):
        yields dicts with 'Data' decoded back to bytes.  Transport errors
        surface as APIError, like the non-streaming paths."""
        import base64
        import urllib.request

        url = self.c._url(path, QueryOptions(params=params))
        req = urllib.request.Request(url)
        try:
            resp = urllib.request.urlopen(
                req, timeout=None if follow else self.c.timeout)
        except urllib.error.HTTPError as e:
            raise APIError(e.code, e.read().decode("utf-8", "replace")) from e
        except urllib.error.URLError as e:
            raise APIError(0, f"failed to reach agent at "
                              f"{self.c.address}: {e.reason}") from e
        try:
            for line in resp:
                line = line.strip()
                if not line:
                    continue
                frame = json.loads(line)
                if frame.get("Data"):
                    frame["Data"] = base64.b64decode(frame["Data"])
                yield frame
        except OSError as e:
            raise APIError(0, f"stream interrupted: {e}") from e
        finally:
            resp.close()

    def stream_logs(self, alloc_id: str, task: str,
                    log_type: str = "stdout", follow: bool = False,
                    offset: int = 0, origin: str = "start"):
        """Framed log streaming (api/fs.go Logs): generator of StreamFrames."""
        return self._stream(
            f"/v1/client/fs/logs/{alloc_id}",
            {"task": task, "type": log_type, "origin": origin,
             "offset": str(offset),
             "follow": "true" if follow else "false"}, follow)

    def stream_file(self, alloc_id: str, path: str, follow: bool = True,
                    offset: int = 0, origin: str = "start"):
        """Framed single-file streaming (api/fs.go Stream)."""
        return self._stream(
            f"/v1/client/fs/stream/{alloc_id}",
            {"path": path, "origin": origin, "offset": str(offset),
             "follow": "true" if follow else "false"}, follow)

    def fs_list(self, alloc_id: str, path: str = "/") -> List[dict]:
        obj, _ = self.c.get(f"/v1/client/fs/ls/{alloc_id}",
                            QueryOptions(params={"path": path}))
        return obj or []

    def fs_cat(self, alloc_id: str, path: str) -> str:
        obj, _ = self.c.get(f"/v1/client/fs/cat/{alloc_id}",
                            QueryOptions(params={"path": path}))
        return obj or ""

    def fs_stat(self, alloc_id: str, path: str) -> dict:
        obj, _ = self.c.get(f"/v1/client/fs/stat/{alloc_id}",
                            QueryOptions(params={"path": path}))
        return obj or {}


class Events:
    """api/event.go (the 1.0 event stream consumer handle)."""

    def __init__(self, c: NomadAPI):
        self.c = c

    def stream(self, topics: Optional[List[str]] = None, index: int = 0,
               follow: bool = True):
        """Consume /v1/event/stream: a generator of event dicts
        ({Topic, Type, Key, Index, Payload, EvalID, SpanID, Wall}).
        ``topics`` entries are ``Topic`` or ``Topic:key``; ``index``
        resumes from a raft index (events with Index >= index replay
        from the server's ring); ``follow=False`` drains the buffered
        backlog and returns.  Idle-heartbeat frames (``{}``) are
        filtered out.  An out-of-ring resume surfaces as APIError 400
        carrying the oldest buffered index; an in-band server error
        frame (e.g. the slow-subscriber shed) raises APIError too, so
        every yielded value is a real event dict."""
        params: Dict[str, str] = {
            "follow": "true" if follow else "false"}
        if topics:
            params["topic"] = ",".join(topics)
        if index:
            params["index"] = str(index)
        url = self.c._url("/v1/event/stream", QueryOptions(params=params))
        req = urllib.request.Request(url)
        try:
            resp = urllib.request.urlopen(
                req, timeout=None if follow else self.c.timeout)
        except urllib.error.HTTPError as e:
            raise APIError(e.code, e.read().decode("utf-8", "replace")) from e
        except urllib.error.URLError as e:
            raise APIError(0, f"failed to reach agent at "
                              f"{self.c.address}: {e.reason}") from e
        try:
            for line in resp:
                line = line.strip()
                if not line:
                    continue
                event = json.loads(line)
                if not event:
                    continue  # idle heartbeat
                if "Error" in event and "Topic" not in event:
                    raise APIError(0, event["Error"])
                yield event
        except OSError as e:
            raise APIError(0, f"event stream interrupted: {e}") from e
        finally:
            resp.close()


class Namespaces:
    """Tenancy handle: /v1/namespaces + /v1/namespace/<name>."""

    def __init__(self, c: NomadAPI):
        self.c = c

    def list(self, q: Optional[QueryOptions] = None
             ) -> Tuple[List[s.Namespace], QueryMeta]:
        obj, meta = self.c.get("/v1/namespaces", q)
        return [from_wire(s.Namespace, n) for n in obj or []], meta

    def register(self, ns: s.Namespace) -> Tuple[dict, QueryMeta]:
        return self.c.put("/v1/namespaces", {"Namespace": to_wire(ns)})

    def status(self, name: str) -> Tuple[dict, QueryMeta]:
        """Row + live usage + admission counters; the Namespace value
        under "Namespace" stays a wire dict (mixed payload)."""
        return self.c.get(f"/v1/namespace/{name}")

    def deregister(self, name: str) -> Tuple[dict, QueryMeta]:
        return self.c.delete(f"/v1/namespace/{name}")


class Regions:
    """Federation handle: /v1/regions (api/regions.go)."""

    def __init__(self, c: NomadAPI):
        self.c = c

    def names(self) -> List[str]:
        """Plain sorted region-name list (api/regions.go List)."""
        obj, _ = self.c.get("/v1/regions")
        return obj or []

    def list(self) -> List[dict]:
        """Detail rows: [{"Name", "Servers", "Leader"}, ...] — region
        name, alive server count, best-known leader address ("" when
        that region is currently unreachable)."""
        obj, _ = self.c.get("/v1/regions",
                            QueryOptions(params={"detail": "1"}))
        return obj or []


class System:
    """api/system.go."""

    def __init__(self, c: NomadAPI):
        self.c = c

    def garbage_collect(self) -> None:
        self.c.put("/v1/system/gc")

    def reconcile_summaries(self) -> None:
        self.c.put("/v1/system/reconcile/summaries")

    def broker_stats(self) -> dict:
        """Eval-broker saturation surface (/v1/broker/stats)."""
        obj, _ = self.c.get("/v1/broker/stats")
        return obj or {}


class Operator:
    """api/operator.go."""

    def __init__(self, c: NomadAPI):
        self.c = c

    def raft_get_configuration(self) -> dict:
        obj, _ = self.c.get("/v1/operator/raft/configuration")
        return obj

    def raft_remove_peer_by_address(self, address: str) -> None:
        """(api/operator.go:69 RaftRemovePeerByAddress)."""
        self.c.delete("/v1/operator/raft/peer",
                      QueryOptions(params={"address": address}))


class Status:
    """api/status.go."""

    def __init__(self, c: NomadAPI):
        self.c = c

    def leader(self) -> str:
        obj, _ = self.c.get("/v1/status/leader")
        return obj or ""

    def peers(self) -> List[str]:
        obj, _ = self.c.get("/v1/status/peers")
        return obj or []
