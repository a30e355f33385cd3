"""HTTP API server: the /v1 surface (a copy of
``nomad_tpu/agent/http.py``).

Reference behavior: command/agent/http.go (mux at http.go:135-178, the
``wrap`` helper at http.go:205 adding region/blocking-query/error handling,
parseWait at http.go:301) plus the per-resource endpoint files
(command/agent/*_endpoint.go).  Implemented on the stdlib threading HTTP
server; JSON bodies are the CamelCase wire shape from api/codec.py.

Blocking queries: ``?index=N&wait=Ds`` long-polls until the relevant state
tables pass index N (state.WatchSet re-run loop, the moral of
nomad/rpc.go:340 blockingRPC), replying with ``X-Nomad-Index``.

The port's agent runs no client (ROADMAP item 28): the ``/v1/client/*``
routes answer the reference's 400 "client is not enabled" after the same
URL checks.  :meth:`HTTPServer.shutdown` ends the long polls, the event
stream and the monitor, closes the open connections and joins every
thread it started (bounded).
"""

from __future__ import annotations

import json
import re
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..api.codec import from_wire, to_wire
from ..jobspec.parse import parse_duration
from ..server.eval_broker import BrokerLimitError
from ..server.rpc import NoPathToRegion
from ..state.state_store import WatchSet
from ..structs import structs as s

MAX_BLOCKING_WAIT = 300.0  # 5m default / 10m cap like the reference
# The longest a long poll, the event stream or the monitor waits before
# it looks at the server's shutdown flag again.
_POLL_SLICE = 0.25
# The event stream's idle heartbeat interval (an empty ``{}`` line).
_STREAM_HEARTBEAT = 10.0
# How long shutdown waits for each connection's thread.
_JOIN_TIMEOUT = 5.0


class CodedError(Exception):
    def __init__(self, code: int, message: str, headers=None):
        super().__init__(message)
        self.code = code
        self.headers = headers or {}


class StreamResponse:
    """Marker return value: the handler yields NDJSON frames instead of one
    JSON body (fs_endpoint.go streaming framing)."""

    def __init__(self, frames):
        self.frames = frames


class TextResponse:
    """Marker return value: raw text body with an explicit content type
    (the Prometheus exposition endpoint — scrapers don't speak JSON)."""

    def __init__(self, text: str,
                 content_type: str = "text/plain; version=0.0.4"):
        self.text = text
        self.content_type = content_type


class _ThreadingHTTPD(ThreadingHTTPServer):
    """One thread per connection, each tracked with its socket so that
    shutdown can close the connection and join the thread."""

    def __init__(self, *args, **kwargs):
        self.conns: dict = {}
        self.conns_lock = threading.Lock()
        super().__init__(*args, **kwargs)

    def process_request(self, request, client_address):
        t = threading.Thread(target=self._serve_conn,
                             args=(request, client_address),
                             name="http-conn", daemon=True)
        with self.conns_lock:
            self.conns[t] = request
        t.start()

    def _serve_conn(self, request, client_address):
        try:
            self.process_request_thread(request, client_address)
        finally:
            with self.conns_lock:
                self.conns.pop(threading.current_thread(), None)


class HTTPServer:
    """Routes /v1 requests onto an Agent's server/client."""

    def __init__(self, agent, host: str = "127.0.0.1", port: int = 4646):
        self.agent = agent
        self.host = host
        self.routes: List[Tuple[str, re.Pattern, Callable]] = []
        self._register_routes()
        # Set by shutdown: long polls, streams and the monitor end.
        self._closing = threading.Event()

        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                outer.agent.logger.debug("http: " + fmt % args)

            def _handle(self):
                outer._dispatch(self)

            do_GET = do_PUT = do_POST = do_DELETE = _handle

        self.httpd = _ThreadingHTTPD((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="http", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def shutdown(self) -> None:
        """Stop accepting, end the long polls and streams, close every
        open connection and join the threads (each bounded)."""
        self._closing.set()
        if self._thread.is_alive():
            self.httpd.shutdown()
            self._thread.join(_JOIN_TIMEOUT)
        self.httpd.server_close()
        with self.httpd.conns_lock:
            conns = list(self.httpd.conns.items())
        for _t, sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t, _sock in conns:
            t.join(_JOIN_TIMEOUT)

    def threads(self) -> List[threading.Thread]:
        """The live threads this server started (empty after shutdown)."""
        with self.httpd.conns_lock:
            out = list(self.httpd.conns)
        if self._thread.is_alive():
            out.append(self._thread)
        return [t for t in out if t.is_alive()]

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    # ------------------------------------------------------------------
    # routing / wrap
    # ------------------------------------------------------------------

    def _register_routes(self) -> None:
        r = self._route
        r("/v1/jobs", self.jobs_request)
        r("/v1/job/(?P<rest>.*)", self.job_specific_request)
        r("/v1/namespaces", self.namespaces_request)
        r("/v1/namespace/(?P<name>[^/]+)", self.namespace_specific_request)
        r("/v1/nodes", self.nodes_request)
        r("/v1/node/(?P<rest>.*)", self.node_specific_request)
        r("/v1/allocations", self.allocs_request)
        r("/v1/allocation/(?P<id>[^/]+)", self.alloc_specific_request)
        r("/v1/evaluations", self.evals_request)
        r("/v1/evaluation/(?P<rest>.*)", self.eval_specific_request)
        r("/v1/client/stats", self.client_stats_request)
        r("/v1/client/allocation/(?P<id>[^/]+)/stats", self.client_alloc_stats_request)
        r("/v1/client/fs/(?P<rest>.*)", self.client_fs_request)
        r("/v1/client/gc", self.client_gc_request)
        r("/v1/agent/self", self.agent_self_request)
        r("/v1/agent/monitor", self.agent_monitor_request)
        r("/v1/agent/members", self.agent_members_request)
        r("/v1/agent/servers", self.agent_servers_request)
        r("/v1/agent/join", self.agent_join_request)
        r("/v1/agent/force-leave", self.agent_force_leave_request)
        r("/v1/agent/keyring/(?P<op>[^/]+)", self.agent_keyring_request)
        r("/v1/validate/job", self.validate_job_request)
        r("/v1/regions", self.regions_request)
        r("/v1/status/leader", self.status_leader_request)
        r("/v1/status/peers", self.status_peers_request)
        r("/v1/operator/raft/configuration", self.operator_raft_conf_request)
        r("/v1/operator/raft/peer", self.operator_raft_peer_request)
        r("/v1/system/gc", self.system_gc_request)
        r("/v1/system/reconcile/summaries", self.system_reconcile_request)
        r("/v1/catalog/services", self.catalog_services_request)
        r("/v1/catalog/service/(?P<name>[^/]+)", self.catalog_service_request)
        r("/v1/metrics", self.metrics_request)
        r("/v1/broker/stats", self.broker_stats_request)
        r("/v1/event/stream", self.event_stream_request)
        r("/v1/traces", self.traces_request)
        r("/v1/trace/eval/(?P<id>[^/]+)", self.trace_eval_request)
        r("/v1/profile/continuous", self.profile_continuous_request)
        r("/v1/debug/blackbox", self.debug_blackbox_request)
        r("/v1/kv/(?P<key>.*)", self.kv_request)
        # Debug/profiling surface, gated by enable_debug — the reference
        # mounts net/http/pprof the same way (command/agent/http.go:173).
        r("/debug/pprof/profile", self.debug_profile_request)
        r("/debug/pprof/heap", self.debug_heap_request)
        r("/debug/pprof/threads", self.debug_threads_request)
        r("/debug/pprof/trace", self.debug_trace_request)

    def _route(self, pattern: str, fn: Callable) -> None:
        self.routes.append((pattern, re.compile("^" + pattern + "$"), fn))

    def _dispatch(self, req: BaseHTTPRequestHandler) -> None:
        parsed = urlparse(req.path)
        query = {k: v[0] for k, v in parse_qs(
            parsed.query, keep_blank_values=True).items()}
        for _pat, rx, fn in self.routes:
            m = rx.match(parsed.path)
            if m is None:
                continue
            try:
                obj, index = fn(req, query, **m.groupdict())
            except CodedError as e:
                self._reply_error(req, e.code, str(e), e.headers)
                return
            except BrokerLimitError as e:
                # Admission NACK: 429 + Retry-After so well-behaved
                # clients back off (jittered client-side) instead of
                # retrying into the saturated broker.
                self._reply_error(req, 429, str(e),
                                  {"Retry-After": f"{e.retry_after:.2f}"})
                return
            except NoPathToRegion as e:
                # Federation degradation contract: a down region is a
                # retryable 429 with a Retry-After hint, never a hang or
                # an opaque 500 — callers can distinguish "region
                # unreachable" from "no leader" by the typed body.
                self._reply_error(req, 429, str(e),
                                  {"Retry-After": f"{e.retry_after:.2f}"})
                return
            except (ValueError, KeyError) as e:
                self._reply_error(req, 400, str(e))
                return
            except Exception as e:  # 500 like wrap (http.go:224)
                self.agent.logger.exception("http: request failed")
                self._reply_error(req, 500, str(e))
                return
            if isinstance(obj, StreamResponse):
                self._reply_stream(req, obj)
            elif isinstance(obj, TextResponse):
                self._reply_text(req, obj)
            else:
                self._reply_json(req, obj, index)
            return
        self._reply_error(req, 404, "Invalid URL")

    def _reply_stream(self, req, stream: StreamResponse) -> None:
        """One NDJSON line per frame, flushed immediately; the connection
        closes when the generator ends or the consumer disconnects."""
        req.send_response(200)
        req.send_header("Content-Type", "application/x-ndjson")
        req.send_header("Connection", "close")
        req.end_headers()
        req.close_connection = True
        frames = iter(stream.frames)
        try:
            while True:
                # Generator errors (unreadable path, mid-stream IO failure)
                # must surface, not read as a clean EOF — only write-side
                # failures mean "consumer went away".
                try:
                    frame = next(frames)
                except StopIteration:
                    break
                except OSError as e:
                    self.agent.logger.warning("http: stream read failed: %s",
                                              e)
                    err = {"FileEvent": f"stream error: {e}"}
                    try:
                        req.wfile.write(
                            json.dumps(err).encode() + b"\n")
                    except OSError:
                        pass
                    break
                line = json.dumps(to_wire(frame)).encode() + b"\n"
                try:
                    req.wfile.write(line)
                    req.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    break  # consumer went away — stop the generator
        finally:
            close = getattr(stream.frames, "close", None)
            if close is not None:
                close()

    def _reply_json(self, req, obj: Any, index: Optional[int]) -> None:
        body = b"" if obj is None else json.dumps(
            to_wire(obj), default=str).encode()
        req.send_response(200)
        req.send_header("Content-Type", "application/json")
        req.send_header("Content-Length", str(len(body)))
        if index is not None:
            req.send_header("X-Nomad-Index", str(index))
            req.send_header("X-Nomad-KnownLeader", "true")
            req.send_header("X-Nomad-LastContact", "0")
        req.end_headers()
        req.wfile.write(body)

    def _reply_text(self, req, resp: TextResponse) -> None:
        body = resp.text.encode()
        req.send_response(200)
        req.send_header("Content-Type", resp.content_type)
        req.send_header("Content-Length", str(len(body)))
        req.end_headers()
        req.wfile.write(body)

    def _reply_error(self, req, code: int, msg: str,
                     headers: Optional[dict] = None) -> None:
        body = msg.encode()
        req.send_response(code)
        req.send_header("Content-Type", "text/plain")
        req.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            req.send_header(k, str(v))
        req.end_headers()
        req.wfile.write(body)

    def _body(self, req, typ=None):
        length = int(req.headers.get("Content-Length") or 0)
        raw = req.rfile.read(length) if length else b""
        if typ is None:
            return json.loads(raw) if raw else None
        data = json.loads(raw) if raw else None
        if data is None:
            raise CodedError(400, "request body required")
        return from_wire(typ, data)

    @property
    def server(self):
        if self.agent.server is None:
            raise CodedError(400, "server is not enabled")
        return self.agent.server

    @staticmethod
    def _no_client() -> CodedError:
        """What every client route answers: the port's agent runs no
        client (ROADMAP item 28), as the reference's answers without
        one (http.py:285)."""
        return CodedError(400, "client is not enabled")

    # ------------------------------------------------------------------
    # blocking-query helper (http.go:301 parseWait + rpc.go:340 blockingRPC)
    # ------------------------------------------------------------------

    def _blocking(self, query: dict, run: Callable[[Optional[WatchSet]], Tuple[Any, int]]):
        min_index = int(query.get("index", 0) or 0)
        if "wait" in query:
            wait = min(parse_duration(query["wait"]), MAX_BLOCKING_WAIT)
        else:
            wait = MAX_BLOCKING_WAIT
        if min_index <= 0:
            return run(None)
        deadline = time.monotonic() + wait
        while True:
            ws = WatchSet()
            try:
                obj, index = run(ws)
            except BaseException:
                ws.close()
                raise
            if (index > min_index or time.monotonic() >= deadline
                    or self._closing.is_set()):
                ws.close()
                return obj, index
            ws.watch(min(_POLL_SLICE, max(0.0, deadline - time.monotonic())))

    # ------------------------------------------------------------------
    # jobs (command/agent/job_endpoint.go)
    # ------------------------------------------------------------------

    def jobs_request(self, req, query):
        if req.command == "GET":
            region = query.get("region", "")
            if region and region != self.server.config.region:
                wait = parse_duration(query["wait"]) if "wait" in query \
                    else MAX_BLOCKING_WAIT
                jobs, index = self.server.job_list(
                    prefix=query.get("prefix", ""), region=region,
                    min_index=int(query.get("index", 0) or 0),
                    max_wait=wait)
                return [self._job_stub(j) for j in jobs], index

            def run(ws):
                state = self.server.state
                prefix = query.get("prefix", "")
                jobs = (state.jobs_by_id_prefix(ws, prefix) if prefix
                        else state.jobs(ws))
                stubs = [self._job_stub(j) for j in jobs]
                return stubs, state.table_index("jobs")
            return self._blocking(query, run)
        if req.command in ("PUT", "POST"):
            payload = self._body(req)
            if payload is None or "Job" not in payload:
                raise CodedError(400, "JSON body with Job required")
            job = from_wire(s.Job, payload["Job"])
            self._check_api_rate(job.namespace)
            index, eval_id = self.server.job_register(
                job, region=query.get("region", ""))
            return {"EvalID": eval_id, "EvalCreateIndex": index,
                    "JobModifyIndex": index}, index
        raise CodedError(405, "Invalid method")

    def _check_api_rate(self, namespace: str) -> None:
        """Per-tenant token-bucket gate on the submit front door.
        Tenants without a configured api_rate (including "default") are
        never throttled; a drained bucket answers 429 + Retry-After
        before the request ever reaches the server's admission path."""
        limiter = getattr(self.server, "api_limiter", None)
        if limiter is None:
            return
        ns = namespace or "default"
        wait = limiter.check(ns)
        if wait > 0.0:
            raise CodedError(
                429, f"tenant {ns!r} API rate limit exceeded; "
                     f"retry_after={wait:.2f}",
                {"Retry-After": f"{wait:.2f}"})

    @staticmethod
    def _job_stub(j: s.Job) -> dict:
        return {
            "ID": j.id, "ParentID": j.parent_id, "Name": j.name,
            "Type": j.type, "Priority": j.priority, "Status": j.status,
            "StatusDescription": j.status_description,
            "CreateIndex": j.create_index, "ModifyIndex": j.modify_index,
            "JobModifyIndex": j.job_modify_index,
        }

    _JOB_SUBPATHS = ("allocations", "evaluations", "summary", "plan",
                     "evaluate", "periodic/force", "dispatch")

    def job_specific_request(self, req, query, rest: str):
        # Job IDs may themselves contain slashes (periodic/dispatch children
        # like "job/periodic-123"), so match known suffixes instead of
        # splitting at the first slash (reference: http.go jobSpecificRequest
        # switches on HasSuffix).
        job_id, sub = rest, ""
        for cand in self._JOB_SUBPATHS:
            if rest.endswith("/" + cand):
                job_id, sub = rest[: -len(cand) - 1], cand
                break
        if not job_id:
            raise CodedError(400, "Missing job ID")
        if sub == "":
            return self._job_crud(req, query, job_id)
        if sub == "allocations":
            def run(ws):
                allocs = self.server.state.allocs_by_job(
                    ws, job_id, query.get("all") not in (None, "", "false"))
                return ([self._alloc_stub(a) for a in allocs],
                        self.server.state.table_index("allocs"))
            return self._blocking(query, run)
        if sub == "evaluations":
            def run(ws):
                evals = self.server.state.evals_by_job(ws, job_id)
                return evals, self.server.state.table_index("evals")
            return self._blocking(query, run)
        if sub == "summary":
            def run(ws):
                summary = self.server.job_summary(job_id)
                if summary is None:
                    raise CodedError(404, "job summary not found")
                return summary, self.server.state.table_index("job_summary")
            return self._blocking(query, run)
        if sub == "plan":
            if req.command not in ("PUT", "POST"):
                raise CodedError(405, "Invalid method")
            payload = self._body(req)
            if payload is None or "Job" not in payload:
                raise CodedError(400, "JSON body with Job required")
            job = from_wire(s.Job, payload["Job"])
            if job.id != job_id:
                raise CodedError(400, "Job ID does not match")
            resp = self.server.job_plan(job, diff=bool(payload.get("Diff", True)))
            return resp, self.server.raft.applied_index()
        if sub == "evaluate":
            if req.command not in ("PUT", "POST"):
                raise CodedError(405, "Invalid method")
            index, eval_id = self.server.job_evaluate(job_id)
            return {"EvalID": eval_id, "EvalCreateIndex": index,
                    "JobModifyIndex": index}, index
        if sub == "periodic/force":
            if req.command not in ("PUT", "POST"):
                raise CodedError(405, "Invalid method")
            child = self.server.periodic_force(job_id)
            if child is None:
                raise CodedError(404, f"periodic job {job_id!r} not found")
            idx = self.server.raft.applied_index()
            return {"EvalCreateIndex": idx, "Index": idx}, idx
        if sub == "dispatch":
            if req.command not in ("PUT", "POST"):
                raise CodedError(405, "Invalid method")
            payload = self._body(req) or {}
            meta = payload.get("Meta") or {}
            body = payload.get("Payload") or ""
            import base64 as b64
            raw = b64.b64decode(body) if isinstance(body, str) and body else b""
            index, child_id, eval_id = self.server.job_dispatch(
                job_id, raw, meta)
            return {"DispatchedJobID": child_id, "EvalID": eval_id,
                    "EvalCreateIndex": index, "JobCreateIndex": index}, index
        raise CodedError(404, "Invalid URL")

    def _job_crud(self, req, query, job_id: str):
        if req.command == "GET":
            region = query.get("region", "")
            if region and region != self.server.config.region:
                job = self.server.job_get(job_id, region=region)
                if job is None:
                    raise CodedError(404, "job not found")
                return job, None

            def run(ws):
                job = self.server.state.job_by_id(ws, job_id)
                if job is None:
                    raise CodedError(404, "job not found")
                return job, self.server.state.table_index("jobs")
            return self._blocking(query, run)
        if req.command in ("PUT", "POST"):
            payload = self._body(req)
            if payload is None or "Job" not in payload:
                raise CodedError(400, "JSON body with Job required")
            job = from_wire(s.Job, payload["Job"])
            if job.id != job_id:
                raise CodedError(400, "Job ID does not match name")
            self._check_api_rate(job.namespace)
            index, eval_id = self.server.job_register(
                job, region=query.get("region", ""))
            return {"EvalID": eval_id, "EvalCreateIndex": index,
                    "JobModifyIndex": index}, index
        if req.command == "DELETE":
            purge = query.get("purge", "true") != "false"
            index, eval_id = self.server.job_deregister(
                job_id, purge=purge, region=query.get("region", ""))
            return {"EvalID": eval_id, "EvalCreateIndex": index,
                    "JobModifyIndex": index}, index
        raise CodedError(405, "Invalid method")

    # ------------------------------------------------------------------
    # namespaces (tenancy plane, ROADMAP item 3)
    # ------------------------------------------------------------------

    def namespaces_request(self, req, query):
        # Namespaces are region-scoped: ?region= routes reads and writes
        # over the federation like jobs (each region's raft owns its
        # tenant rows and enforces their quotas locally).
        region = query.get("region", "")
        if req.command == "GET":
            if region and region != self.agent.config.region:
                rows = self.server.namespace_list(region=region)
                return ([to_wire(n) for n in
                         sorted(rows, key=lambda n: n.name)], None)

            def run(ws):
                state = self.server.state
                rows = state.namespaces(ws)
                return ([to_wire(n) for n in
                         sorted(rows, key=lambda n: n.name)],
                        state.table_index("namespaces"))
            return self._blocking(query, run)
        if req.command in ("PUT", "POST"):
            payload = self._body(req)
            if payload is None or "Namespace" not in payload:
                raise CodedError(400, "JSON body with Namespace required")
            ns = from_wire(s.Namespace, payload["Namespace"])
            index = self.server.namespace_upsert(ns, region=region)
            return {"Index": index}, index
        raise CodedError(405, "Invalid method")

    def namespace_specific_request(self, req, query, name: str):
        region = query.get("region", "")
        if req.command == "GET":
            try:
                status = self.server.namespace_status(name, region=region)
            except KeyError as e:
                raise CodedError(404, str(e))
            if not isinstance(status["Namespace"], dict):
                status["Namespace"] = to_wire(status["Namespace"])
            return status, self.server.state.table_index("namespaces")
        if req.command in ("PUT", "POST"):
            payload = self._body(req)
            if payload is None or "Namespace" not in payload:
                raise CodedError(400, "JSON body with Namespace required")
            ns = from_wire(s.Namespace, payload["Namespace"])
            if ns.name != name:
                raise CodedError(400, "Namespace name does not match URL")
            index = self.server.namespace_upsert(ns, region=region)
            return {"Index": index}, index
        if req.command == "DELETE":
            try:
                index = self.server.namespace_delete(name, region=region)
            except KeyError as e:
                raise CodedError(404, str(e))
            return {"Index": index}, index
        raise CodedError(405, "Invalid method")

    # ------------------------------------------------------------------
    # nodes (command/agent/node_endpoint.go)
    # ------------------------------------------------------------------

    def nodes_request(self, req, query):
        if req.command != "GET":
            raise CodedError(405, "Invalid method")

        def run(ws):
            state = self.server.state
            prefix = query.get("prefix", "")
            nodes = (state.nodes_by_id_prefix(ws, prefix) if prefix
                     else state.nodes(ws))
            stubs = [self._node_stub(n) for n in nodes]
            return stubs, state.table_index("nodes")
        return self._blocking(query, run)

    @staticmethod
    def _node_stub(n: s.Node) -> dict:
        return {
            "ID": n.id, "Datacenter": n.datacenter, "Name": n.name,
            "NodeClass": n.node_class, "Drain": n.drain, "Status": n.status,
            "StatusDescription": n.status_description,
            "CreateIndex": n.create_index, "ModifyIndex": n.modify_index,
        }

    def node_specific_request(self, req, query, rest: str):
        parts = rest.split("/")
        node_id = parts[0]
        sub = "/".join(parts[1:])
        if not node_id:
            raise CodedError(400, "Missing node ID")
        if sub == "":
            if req.command != "GET":
                raise CodedError(405, "Invalid method")

            def run(ws):
                node = self.server.state.node_by_id(ws, node_id)
                if node is None:
                    raise CodedError(404, "node not found")
                return node, self.server.state.table_index("nodes")
            return self._blocking(query, run)
        if sub == "allocations":
            def run(ws):
                allocs = self.server.state.allocs_by_node(ws, node_id)
                return allocs, self.server.state.table_index("allocs")
            return self._blocking(query, run)
        if sub == "evaluate":
            if req.command not in ("PUT", "POST"):
                raise CodedError(405, "Invalid method")
            eval_ids = self.server.node_evaluate(node_id)
            idx = self.server.raft.applied_index()
            return {"EvalIDs": eval_ids, "EvalCreateIndex": idx}, idx
        if sub == "drain":
            if req.command not in ("PUT", "POST"):
                raise CodedError(405, "Invalid method")
            enable = query.get("enable") in ("true", "1")
            index = self.server.node_update_drain(node_id, enable)
            return {"EvalCreateIndex": index, "NodeModifyIndex": index}, index
        raise CodedError(404, "Invalid URL")

    # ------------------------------------------------------------------
    # allocations / evaluations
    # ------------------------------------------------------------------

    def allocs_request(self, req, query):
        if req.command != "GET":
            raise CodedError(405, "Invalid method")

        def run(ws):
            state = self.server.state
            prefix = query.get("prefix", "")
            allocs = state.allocs(ws)
            if prefix:
                allocs = [a for a in allocs if a.id.startswith(prefix)]
            return ([self._alloc_stub(a) for a in allocs],
                    state.table_index("allocs"))
        return self._blocking(query, run)

    @staticmethod
    def _alloc_stub(a: s.Allocation) -> dict:
        return {
            "ID": a.id, "EvalID": a.eval_id, "Name": a.name,
            "NodeID": a.node_id, "JobID": a.job_id, "TaskGroup": a.task_group,
            "DesiredStatus": a.desired_status,
            "DesiredDescription": a.desired_description,
            "ClientStatus": a.client_status,
            "ClientDescription": a.client_description,
            "TaskStates": to_wire(a.task_states),
            "CreateIndex": a.create_index, "ModifyIndex": a.modify_index,
            "CreateTime": a.create_time,
        }

    def alloc_specific_request(self, req, query, id: str):
        if req.command != "GET":
            raise CodedError(405, "Invalid method")

        def run(ws):
            alloc = self.server.state.alloc_by_id(ws, id)
            if alloc is None:
                raise CodedError(404, "alloc not found")
            return alloc, self.server.state.table_index("allocs")
        return self._blocking(query, run)

    def evals_request(self, req, query):
        if req.command != "GET":
            raise CodedError(405, "Invalid method")

        def run(ws):
            state = self.server.state
            prefix = query.get("prefix", "")
            evals = (state.evals_by_id_prefix(ws, prefix) if prefix
                     else state.evals(ws))
            return evals, state.table_index("evals")
        return self._blocking(query, run)

    def eval_specific_request(self, req, query, rest: str):
        parts = rest.split("/")
        eval_id = parts[0]
        sub = "/".join(parts[1:])
        if sub == "":
            def run(ws):
                ev = self.server.state.eval_by_id(ws, eval_id)
                if ev is None:
                    raise CodedError(404, "eval not found")
                return ev, self.server.state.table_index("evals")
            return self._blocking(query, run)
        if sub == "allocations":
            def run(ws):
                allocs = self.server.state.allocs_by_eval(ws, eval_id)
                return ([self._alloc_stub(a) for a in allocs],
                        self.server.state.table_index("allocs"))
            return self._blocking(query, run)
        raise CodedError(404, "Invalid URL")

    # ------------------------------------------------------------------
    # client endpoints (command/agent/{stats,fs}_endpoint.go)
    # ------------------------------------------------------------------

    def client_stats_request(self, req, query):
        raise self._no_client()

    def client_alloc_stats_request(self, req, query, id: str):
        raise self._no_client()

    def client_gc_request(self, req, query):
        if req.command not in ("PUT", "POST", "GET"):
            raise CodedError(405, "Invalid method")
        raise self._no_client()

    def client_fs_request(self, req, query, rest: str):
        parts = rest.split("/", 1)
        op = parts[0]
        alloc_id = parts[1] if len(parts) > 1 else ""
        if op not in ("ls", "stat", "cat", "readat", "logs", "stream",
                      "snapshot"):
            raise CodedError(404, "Invalid URL")
        if not alloc_id:
            raise CodedError(400, "Missing allocation ID")
        raise self._no_client()

    # ------------------------------------------------------------------
    # agent / status / operator / system
    # ------------------------------------------------------------------

    def agent_self_request(self, req, query):
        return self.agent.self_info(), None

    # Consul-shaped catalog surface (command/agent/consul; discovery
    # endpoint the reference gets from the real Consul HTTP API).
    def catalog_services_request(self, req, query):
        return self.agent.catalog.services(), None

    def agent_monitor_request(self, req, query):
        """Stream the agent's log ring + live lines
        (command/agent/log_*.go monitor surface)."""
        ring = getattr(self.agent, "log_ring", None)
        if ring is None:
            raise CodedError(404, "log monitoring unavailable")

        def frames():
            for line in ring.monitor(stop_event=self._closing):
                yield {"Data": (line + "\n").encode()}

        return StreamResponse(frames()), None

    def metrics_request(self, req, query):
        """In-memory telemetry aggregates (the reference's go-metrics
        inventory; names per telemetry.html.md).  ``?format=prometheus``
        renders the newest interval as text exposition (gauges, counters,
        and sample summaries with p50/p95/p99 quantiles)."""
        from .. import codec

        from ..utils import contprof

        if query.get("format") == "prometheus":
            from ..utils.telemetry import render_prometheus

            sink = self.server.metrics.sink
            if not hasattr(sink, "latest"):
                raise CodedError(400, "metrics sink has no interval data")
            # Struct-codec histograms (codec.{rpc,raft,snapshot}.
            # {encode,decode}_seconds) account process-globally in the
            # codec package; merge them into this server's rendering.
            # The host-attribution plane merges the same way:
            # nomad.cpu.* shares and nomad.lock.*.wait_seconds
            # histograms.
            return TextResponse(render_prometheus(
                contprof.merge_metrics(
                    codec.merge_metrics(sink.latest())))), None
        data = self.server.metrics.sink.data()
        if isinstance(data, list) and data:
            contprof.merge_metrics(codec.merge_metrics(data[-1]))
        return data, None

    def broker_stats_request(self, req, query):
        """Eval-broker saturation surface (/v1/broker/stats): pending by
        state/priority, the delivery-attempts histogram, admission /
        coalesce / shed counters, plan-queue depth.  What the load
        harness polls; what an operator reads to tell busy from
        melting."""
        if req.command != "GET":
            raise CodedError(405, "Invalid method")
        return self.server.broker_stats(), None

    # -- cluster event stream (server/event_broker.py) -----------------

    def event_stream_request(self, req, query):
        """Chunked JSON-lines feed of cluster state-change events
        (event_endpoint.go /v1/event/stream).

        Query params:
          ``topic=``  comma-separated ``Topic`` or ``Topic:key`` filters
                      (default: every topic);
          ``index=``  resume point — replays buffered events with raft
                      index >= N, 400 with the oldest buffered index when
                      N has already been evicted from the ring;
          ``follow=`` ``false`` dumps the buffered backlog and closes
                      (the forensic/CLI no-follow mode); default ``true``
                      keeps streaming, emitting ``{}`` heartbeat lines
                      while idle;
          ``namespace=`` keep only events attributed to one tenant
                      (payload ``Namespace`` stamp) — unattributed
                      events are dropped too, so a tenant-scoped
                      consumer never sees another tenant's traffic.
        """
        from ..server.event_broker import EventIndexError, parse_topic_filter

        if req.command != "GET":
            raise CodedError(405, "Invalid method")
        topics = parse_topic_filter(query.get("topic", ""))
        ns_filter = query.get("namespace", "")
        index = int(query.get("index", 0) or 0)
        follow = query.get("follow", "true").lower() != "false"
        # No-follow with no explicit index dumps whatever the ring still
        # buffers — no gap check, since the consumer asked for "what you
        # have", not "everything since N".
        replay_all = not follow and index <= 0
        try:
            sub = self.server.event_stream_subscribe(topics=topics,
                                                     from_index=index,
                                                     replay_all=replay_all)
        except EventIndexError as e:
            raise CodedError(400, str(e))

        def frames():
            idle_since = time.monotonic()
            try:
                while not self._closing.is_set():
                    ev = sub.next(timeout=_POLL_SLICE if follow else 0.05)
                    if ev is not None:
                        idle_since = time.monotonic()
                        if ns_filter and (ev.payload or {}).get(
                                "Namespace") != ns_filter:
                            continue
                        yield ev.to_wire_dict()
                        continue
                    if sub.closed:
                        if sub.close_error:
                            yield {"Error": sub.close_error}
                        return
                    if not follow:
                        return  # backlog drained
                    if time.monotonic() - idle_since >= _STREAM_HEARTBEAT:
                        # Idle heartbeat: keeps the chunked stream alive
                        # and makes a vanished consumer fail the next
                        # write so the subscription is reaped.
                        idle_since = time.monotonic()
                        yield {}
            finally:
                sub.close()

        return StreamResponse(frames()), None

    # -- eval-lifecycle tracing (utils/tracing.py) ---------------------

    def traces_request(self, req, query):
        """Recent completed spans: /v1/traces?recent=N (newest last).
        Body always carries Enabled so a disarmed plane reads as such
        instead of as an empty cluster."""
        from ..utils import tracing

        n = min(int(query.get("recent", 100) or 100), 1000)
        return {"Enabled": tracing.enabled(),
                "Spans": tracing.recent(n)}, None

    def trace_eval_request(self, req, query, id: str):
        """Full lifecycle timeline of one evaluation:
        /v1/trace/eval/<id> — every span tagged with the eval id,
        sorted by monotonic start time."""
        from ..utils import tracing

        if not tracing.enabled():
            raise CodedError(
                404, "tracing disabled (set ServerConfig.trace or call "
                     "tracing.enable())")
        # The tracer is per-process: a follower-scheduled eval's spans
        # live on the scheduling follower.  Fan out to peers over
        # Status.TraceEval before 404ing (best-effort, dark followers
        # skipped).
        spans, source = self.server.trace_for_eval_fanout(id)
        if not spans:
            raise CodedError(404, f"no trace recorded for eval {id!r} "
                                  "on any reachable server")
        return {"EvalID": id, "Spans": spans, "Source": source}, None

    def profile_continuous_request(self, req, query):
        """Rolling host-attribution window from the continuous profiler
        (/v1/profile/continuous?seconds=N): per-subsystem CPU shares,
        non-idle attribution coverage, GIL-pressure percentiles, and the
        top contended locks.  Ungated like /v1/metrics — the sampler
        only runs when armed (ServerConfig.contprof_hz), and a disarmed
        plane reads as {"Enabled": false} rather than 404 so pollers
        can tell 'off' from 'down'."""
        from ..utils import contprof

        if req.command != "GET":
            raise CodedError(405, "Invalid method")
        seconds = float(query.get("seconds", "60") or 60)
        return contprof.window(seconds), None

    def debug_blackbox_request(self, req, query):
        """Operator-forced flight-recorder capture (/v1/debug/blackbox):
        assembles a full incident bundle NOW — spans, event tail,
        metrics, profile window, thread dump, knob/breaker state — and,
        when the recorder is armed, also writes it to the bundle
        directory (response carries the path).  Debug-gated like the
        pprof surface; forced captures bypass the auto-capture rate
        limits by design."""
        self._require_debug()
        from ..utils import blackbox

        reason = query.get("reason", "operator.request")
        path = blackbox.capture(reason, {"Via": "http"}, force=True)
        if path is not None:
            with open(path, "r", encoding="utf-8") as fh:
                bundle = json.load(fh)
        else:  # recorder disarmed: assemble in memory, nothing on disk
            bundle = blackbox.assemble_bundle(reason, {"Via": "http"})
        bundle["Path"] = path
        return bundle, None

    # -- debug / profiling (pprof equivalent) --------------------------

    def _require_debug(self) -> None:
        if not self.agent.config.enable_debug:
            raise CodedError(404, "debug endpoints disabled "
                                  "(set enable_debug = true)")

    def debug_profile_request(self, req, query):
        """Process CPU profile over a bounded window
        (/debug/pprof/profile?seconds=N equivalent)."""
        self._require_debug()
        from ..utils import profiling

        seconds = float(query.get("seconds", "1"))
        text = profiling.cpu_profile(
            seconds, sort=query.get("sort", "cumulative"),
            top=int(query.get("top", "60")))
        return {"Seconds": seconds, "Profile": text}, None

    def debug_heap_request(self, req, query):
        """tracemalloc top allocation sites (/debug/pprof/heap)."""
        self._require_debug()
        from ..utils import profiling

        return profiling.heap_profile(int(query.get("top", "40"))), None

    def debug_threads_request(self, req, query):
        """All-thread stack dump (/debug/pprof/goroutine?debug=2)."""
        self._require_debug()
        from ..utils import profiling

        return {"Stacks": profiling.thread_dump()}, None

    def debug_trace_request(self, req, query):
        """A bounded device trace of the card (``DeviceTracer``, a Chrome
        trace with the kernel events), the device-side pprof."""
        self._require_debug()
        from ..utils import profiling

        return profiling.get_tracer().capture(
            float(query.get("seconds", "1"))), None

    def kv_request(self, req, query, key: str):
        """Consul-KV-shaped store feeding task templates
        (the `{{key}}` function's data source)."""
        cat = self.agent.catalog
        if req.command == "GET":
            recurse = "recurse" in query and \
                query["recurse"].lower() in ("", "true", "1")
            if recurse or not key:
                return cat.kv_list(key), None
            val = cat.kv_get(key)
            if val is None:
                raise CodedError(404, f"key not found: {key}")
            return {"Key": key, "Value": val,
                    "ModifyIndex": cat.kv_index()}, None
        if req.command in ("PUT", "POST"):
            length = int(req.headers.get("Content-Length") or 0)
            value = (req.rfile.read(length) if length else b"").decode(
                "utf-8", "replace")
            index = cat.kv_set(key, value)
            return {"Key": key, "ModifyIndex": index}, None
        if req.command == "DELETE":
            cat.kv_delete(key)
            return None, None
        raise CodedError(405, "Invalid method")

    def catalog_service_request(self, req, query, name: str):
        tag = query.get("tag", "")
        healthy = query.get("passing", "").lower() == "true"
        entries = self.agent.catalog.service(name, tag=tag,
                                             healthy_only=healthy)
        return [e.to_wire() for e in entries], None

    def agent_members_request(self, req, query):
        return {"Members": self.agent.members()}, None

    def agent_servers_request(self, req, query):
        if req.command == "GET":
            return self.agent.client_servers(), None
        if req.command in ("PUT", "POST"):
            addrs = query.get("address")
            self.agent.set_client_servers([addrs] if addrs else [])
            return None, None
        raise CodedError(405, "Invalid method")

    def agent_join_request(self, req, query):
        if req.command not in ("PUT", "POST"):
            raise CodedError(405, "Invalid method")
        addrs = [a for a in (query.get("address", "")).split(",") if a]
        if not addrs:
            raise CodedError(400, "missing address to join")
        try:
            joined = self.server.join(addrs)
        except ValueError as e:
            return {"num_joined": 0, "error": str(e)}, None
        return {"num_joined": joined, "error": ""}, None

    def agent_keyring_request(self, req, query, op=""):
        """Gossip keyring management over HTTP
        (command/agent/http.go:158 + agent_endpoint.go:166
        KeyringOperationRequest): /v1/agent/keyring/{list,install,use,
        remove}, mutations via PUT/POST with a {"Key": ...} body.
        Server-only, like the reference (501 when no server)."""
        from ..utils import keyring

        if self.agent.server is None:
            raise CodedError(501, "keyring requires a server agent")
        data_dir = (getattr(self.agent.config, "data_dir", "") or
                    getattr(self.agent.server.config, "data_dir", ""))
        if not data_dir:
            # A dev agent has no data_dir; silently writing keyring.json
            # into the process cwd would persist stale keys across runs.
            raise CodedError(400, "keyring requires a data_dir")
        if op == "list":
            return keyring.key_response(data_dir), None
        if op not in ("install", "use", "remove"):
            raise CodedError(404, "resource not found")
        if req.command not in ("PUT", "POST"):
            raise CodedError(405, "Invalid method")
        body = self._body(req) or {}
        key = body.get("Key", "")
        if not key:
            raise CodedError(400, "missing key")
        try:
            getattr(keyring, op)(data_dir, key)
        except keyring.KeyringError as e:
            raise CodedError(400, str(e))
        return keyring.key_response(data_dir), None

    def agent_force_leave_request(self, req, query):
        if req.command not in ("PUT", "POST"):
            raise CodedError(405, "Invalid method")
        node = query.get("node", "")
        if not node:
            raise CodedError(400, "missing node to force leave")
        if not self.server.force_leave(node):
            raise CodedError(404, f"unknown member {node!r}")
        return None, None

    def validate_job_request(self, req, query):
        if req.command not in ("PUT", "POST"):
            raise CodedError(405, "Invalid method")
        payload = self._body(req)
        if payload is None or "Job" not in payload:
            raise CodedError(400, "JSON body with Job required")
        job = from_wire(s.Job, payload["Job"])
        job.canonicalize()
        problems = job.validate()
        return {"ValidationErrors": problems,
                "Error": "; ".join(problems) if problems else ""}, None

    def regions_request(self, req, query):
        """Plain region-name list by default (the reference's
        /v1/regions shape); ``?detail`` adds server count + leader
        address per region."""
        detail = query.get("detail") not in (None, "", "0", "false")
        if self.agent.server is not None:
            if detail:
                return self.agent.server.region_info(), None
            return self.agent.server.regions(), None
        if detail:
            return [{"Name": self.agent.config.region, "Servers": 0,
                     "Leader": ""}], None
        return [self.agent.config.region], None

    def status_leader_request(self, req, query):
        return self.server.leader_address(), None

    def status_peers_request(self, req, query):
        return self.server.peer_addresses(), None

    def operator_raft_conf_request(self, req, query):
        return self.server.raft_configuration(), None

    def operator_raft_peer_request(self, req, query):
        """DELETE /v1/operator/raft/peer?address=ip:port
        (operator_endpoint.go OperatorRequest)."""
        if req.command != "DELETE":
            raise CodedError(405, "Invalid method")
        address = query.get("address") or ""
        if not address:
            raise CodedError(400, "missing address parameter")
        try:
            self.server.operator_raft_remove_peer(address)
        except KeyError as e:
            # str(KeyError) reprs its argument (stray quotes).
            raise CodedError(404, str(e.args[0]) if e.args else "not found")
        except ValueError as e:
            raise CodedError(400, str(e))
        return None, None

    def system_gc_request(self, req, query):
        if req.command not in ("PUT", "POST"):
            raise CodedError(405, "Invalid method")
        self.server.system_gc()
        return None, None

    def system_reconcile_request(self, req, query):
        if req.command not in ("PUT", "POST"):
            raise CodedError(405, "Invalid method")
        self.server.system_reconcile_summaries()
        return None, None
