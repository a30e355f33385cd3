"""The RPC endpoint registry: wire method names onto ``Server`` methods (a
copy of ``nomad_tpu/server/endpoints.py`` for the endpoints the cluster
uses; reference: the endpoint structs registered at
nomad/server.go:163-174, forwarding at nomad/rpc.go:178).

Forwarding lives in one place: every ``Server`` write method catches
``NotLeaderError`` and re-issues the call to the leader through
``Server._forward``, and a request for another region goes there through
``Server._forward_region``.  This module's wrapper only marks a request
that already took its one forwarding hop (the reference's Forwarded
flag) or its region hop, and turns an unforwardable ``NotLeaderError``
into the wire's ``NoLeaderError``, whose message names the known
leader.

Bodies and replies are struct-codec values (``server/rpc.py``): the
structs arrive typed, and a body of the wrong type is refused.

Registered: ``Status.Ping/Leader/Peers/Fingerprint/BrokerStats/
Metrics/TraceEval``, ``Event.Since``, ``Region.List``,
``Serf.Join/Members``, ``Node.Register/UpdateStatus/Deregister/
UpdateDrain/UpdateAlloc/Get/Evaluate/GetClientAllocs/DeriveVaultToken``,
``Alloc.Get/List``, ``Job.Register/Deregister/Evaluate/Dispatch/List/
Get``, ``Periodic.Force``,
``Namespace.Upsert/Delete/List/Status``,
``System.GarbageCollect/ReconcileJobSummaries``,
``Eval.Dequeue/DequeueBatch/Ack/Nack/Update/Reblock/PauseNack/
ResumeNack/GetEval/List/Allocations``, ``Plan.Submit`` and ``Operator.
RaftGetConfiguration/RaftRemovePeerByAddress``; with
``ServerConfig.chaos_endpoints`` also ``Chaos.SetNet/Status`` (the
reference registers them under ``NOMAD_TPU_CHAOS=1``): a load harness
splits and heals a child server's own side of a partition with them.
"""

from __future__ import annotations

from typing import Any

from .. import codec, fault
from ..structs import structs as s
from ..utils import contprof, tracing
from . import event_broker as event_stream
from .raft import NotLeaderError
from .rpc import NoLeaderError


def _typed(cls, value: Any):
    if not isinstance(value, cls):
        raise TypeError(f"expected {cls.__name__}, got "
                        f"{type(value).__name__}")
    return value


def register_endpoints(server, rpc) -> None:
    """Attach every wire method of ``server`` to the ``RPCServer``
    ``rpc``."""

    def register(method, fn):
        def handler(body):
            forwarded = isinstance(body, dict) and body.pop("__forwarded__",
                                                            False)
            region_hop = isinstance(body, dict) and body.pop(
                "__region_hop__", False)
            if forwarded:
                server._fwd_ctx.active = True
            if region_hop:
                server._fwd_ctx.region_hop = True
            try:
                return fn(body)
            except NotLeaderError as e:
                # Carry the known leader's address, so wire clients can
                # redirect.
                raise NoLeaderError(str(e) or "no cluster leader")
            finally:
                if forwarded:
                    server._fwd_ctx.active = False
                if region_hop:
                    server._fwd_ctx.region_hop = False
        rpc.register(method, handler)

    # -- Status ------------------------------------------------------------

    def status_fingerprint(body):
        """The committed prefix's digest, for a cross-server check."""
        index, fp = server.fsm_fingerprint()
        return {"Index": index, "Fingerprint": fp,
                "AppliedIndex": server.raft.applied_index_relaxed()}

    def status_metrics(body):
        """The telemetry sink's newest interval over the wire, with the
        codec's histograms and, while armed, the profiler's gauges and
        the contention ledger merged in (endpoints.py:83-93)."""
        latest = server.metrics.sink.latest()
        return contprof.merge_metrics(codec.merge_metrics(latest))

    def event_since(body):
        """The buffered events with an index above ``MinIndex``, oldest
        first, at most ``Max`` (1 to 2048; default 256): the poll-based
        tail the auditor reads of a server without a stream listener
        (endpoints.py:107-128)."""
        min_index = int(body.get("MinIndex", 0) or 0)
        cap = max(1, min(int(body.get("Max", 256) or 256), 2048))
        broker = server.event_broker
        events = [ev for ev in broker.buffered() if ev.index > min_index]
        out = [{"Topic": ev.topic, "Type": ev.type, "Key": ev.key,
                "Index": ev.index, "Payload": ev.payload or {},
                "EvalID": ev.eval_id} for ev in events[:cap]]
        return {"Events": out, "Latest": broker.latest_index(),
                "Armed": event_stream.armed()}

    rpc.register("Status.Ping", lambda body: {"ok": True})
    rpc.register("Status.Leader", lambda body: server.leader_address())
    rpc.register("Status.Peers", lambda body: server.peer_addresses())
    rpc.register("Status.Fingerprint", status_fingerprint)
    rpc.register("Status.BrokerStats", lambda body: server.broker_stats())
    rpc.register("Status.Metrics", status_metrics)
    rpc.register("Event.Since", event_since)

    def status_trace_eval(body):
        """This process's spans of one eval, for a peer's trace fanout
        (endpoints.py:94): one hop, local spans only."""
        return {"Spans": tracing.trace_for_eval(body.get("EvalID", ""))}

    def region_list(body):
        reply = {"Regions": server.regions()}
        if body.get("Detail"):
            reply["Detail"] = server.region_info()
        return reply

    rpc.register("Status.TraceEval", status_trace_eval)
    rpc.register("Region.List", region_list)

    # -- the chaos control plane (endpoints.py:137-163) ---------------------

    if server.config.chaos_endpoints:
        def chaos_set_net(body):
            plane = fault.net()
            for p in body.get("Partitions") or []:
                plane.partition(p["Name"], p["Groups"],
                                windows=p.get("Windows"))
            for name in body.get("Heal") or []:
                plane.heal(name)
            if body.get("HealAll"):
                plane.heal()
            return {"Active": plane.active_partitions()}

        def chaos_status(body):
            plane = fault.net()
            return {"Active": plane.active_partitions(),
                    "Trace": [list(t) for t in plane.trace()[-64:]]}

        rpc.register("Chaos.SetNet", chaos_set_net)
        rpc.register("Chaos.Status", chaos_status)

    # -- serf-lite membership ----------------------------------------------

    register("Serf.Join", lambda body: server.membership_join(body["Member"]))
    register("Serf.Members", lambda body: {"Members": server.members()})

    # -- Node ----------------------------------------------------------------

    def node_register(body):
        index, ttl = server.node_register(_typed(s.Node, body["Node"]))
        return {"Index": index, "HeartbeatTTL": ttl}

    def node_update_status(body):
        index, ttl = server.node_update_status(body["NodeID"], body["Status"])
        return {"Index": index, "HeartbeatTTL": ttl}

    def node_deregister(body):
        return {"Index": server.node_deregister(body["NodeID"])}

    def node_update_drain(body):
        return {"Index": server.node_update_drain(body["NodeID"],
                                                  body["Drain"])}

    def node_get_client_allocs(body):
        allocs, index = server.node_get_client_allocs(
            body["NodeID"], int(body.get("MinQueryIndex", 0) or 0),
            float(body.get("MaxQueryTime", 30.0)))
        return {"Allocs": allocs, "Index": index}

    register("Node.Get",
             lambda body: {"Node": server.node_get(body["NodeID"])})
    register("Node.Evaluate", lambda body: {
        "EvalIDs": server.node_evaluate(body["NodeID"])})
    register("Node.GetClientAllocs", node_get_client_allocs)
    register("Alloc.Get",
             lambda body: {"Alloc": server.alloc_get(body["AllocID"])})
    register("Alloc.List", lambda body: {
        "Allocs": server.alloc_list(),
        "Index": server.state.table_index("allocs")})
    register("Node.Register", node_register)
    register("Node.UpdateStatus", node_update_status)
    register("Node.Deregister", node_deregister)
    register("Node.UpdateDrain", node_update_drain)

    def node_update_alloc(body):
        allocs = [_typed(s.Allocation, a) for a in body["Allocs"]]
        return {"Index": server.node_update_allocs(allocs)}

    register("Node.UpdateAlloc", node_update_alloc)

    def node_derive_vault_token(body):
        return {"Tasks": server.derive_vault_token(
            body["AllocID"], list(body.get("Tasks") or []))}

    register("Node.DeriveVaultToken", node_derive_vault_token)

    # -- Job -----------------------------------------------------------------

    def job_register(body):
        index, eval_id = server.job_register(_typed(s.Job, body["Job"]),
                                             region=body.get("Region", ""))
        return {"Index": index, "EvalID": eval_id}

    def job_deregister(body):
        index, eval_id = server.job_deregister(
            body["JobID"], purge=body.get("Purge", True),
            region=body.get("Region", ""))
        return {"Index": index, "EvalID": eval_id}

    def job_evaluate(body):
        index, eval_id = server.job_evaluate(body["JobID"])
        return {"Index": index, "EvalID": eval_id}

    def job_dispatch(body):
        index, child_id, eval_id = server.job_dispatch(
            body["JobID"], body.get("Payload") or b"",
            body.get("Meta") or {})
        return {"Index": index, "DispatchedJobID": child_id,
                "EvalID": eval_id}

    def periodic_force(body):
        child = server.periodic_force(body["JobID"])
        return {"ChildJobID": child.id if child else ""}

    def job_list(body):
        jobs, index = server.job_list(
            prefix=body.get("Prefix", ""), region=body.get("Region", ""),
            min_index=int(body.get("MinQueryIndex", 0) or 0),
            max_wait=float(body.get("MaxQueryTime", 0) or 0))
        return {"Jobs": jobs, "Index": index}

    def job_get(body):
        job = server.job_get(
            body["JobID"], region=body.get("Region", ""),
            min_index=int(body.get("MinQueryIndex", 0) or 0),
            max_wait=float(body.get("MaxQueryTime", 0) or 0))
        return {"Job": job, "Index": server.state.table_index("jobs")}

    register("Job.List", job_list)
    register("Job.Get", job_get)
    register("Job.Register", job_register)
    register("Job.Deregister", job_deregister)
    register("Job.Evaluate", job_evaluate)
    register("Job.Dispatch", job_dispatch)
    register("Periodic.Force", periodic_force)

    # -- Namespace and System (the tenancy plane, system_endpoint.go) -------

    def namespace_upsert(body):
        ns = _typed(s.Namespace, body["Namespace"])
        return {"Index": server.namespace_upsert(
            ns, region=body.get("Region", ""))}

    def namespace_delete(body):
        return {"Index": server.namespace_delete(
            body["Name"], region=body.get("Region", ""))}

    def namespace_list(body):
        return {"Namespaces": server.namespace_list(
            region=body.get("Region", "")),
                "Index": server.state.table_index("namespaces")}

    def system_gc(body):
        server.system_gc()
        return {}

    def system_reconcile(body):
        server.system_reconcile_summaries()
        return {}

    register("Namespace.Upsert", namespace_upsert)
    register("Namespace.Delete", namespace_delete)
    register("Namespace.List", namespace_list)
    register("Namespace.Status", lambda body: server.namespace_status(
        body["Name"], region=body.get("Region", "")))
    register("System.GarbageCollect", system_gc)
    register("System.ReconcileJobSummaries", system_reconcile)

    # -- Eval (the worker surface, eval_endpoint.go:64-211) ----------------

    def eval_dequeue(body):
        # The server-side block stays under the transport's read timeout
        # (workers re-issue their long polls).
        timeout = min(float(body.get("Timeout", 0.0) or 0.0), 5.0)
        ev, token = server.eval_dequeue(body.get("Schedulers") or [],
                                        timeout)
        return {"Eval": ev, "Token": token}

    def eval_dequeue_batch(body):
        # The follower workers' pull (server/follower_sched.py).
        timeout = min(float(body.get("Timeout", 0.0) or 0.0), 5.0)
        reply = server.eval_dequeue_batch(
            body.get("Schedulers") or [], int(body.get("Max", 1) or 1),
            timeout)
        return {"Evals": [{"Eval": item["eval"],
                           "Token": item["token"],
                           "Attempts": item["attempts"],
                           "PlanFence": item["fence"]}
                          for item in reply["items"]],
                "AppliedIndex": reply["applied_index"]}

    def eval_ack(body):
        server.eval_ack(body["EvalID"], body["Token"])
        return {}

    def eval_nack(body):
        server.eval_nack(body["EvalID"], body["Token"])
        return {}

    def eval_update(body):
        evals = [_typed(s.Evaluation, ev) for ev in body["Evals"]]
        return {"Index": server.eval_update(evals)}

    def eval_reblock(body):
        ev = _typed(s.Evaluation, body["Eval"])
        return {"Index": server.eval_reblock(ev, body["Token"])}

    def eval_pause_nack(body):
        server.eval_pause_nack(body["EvalID"], body["Token"])
        return {}

    def eval_resume_nack(body):
        server.eval_resume_nack(body["EvalID"], body["Token"])
        return {}

    register("Eval.Dequeue", eval_dequeue)
    register("Eval.DequeueBatch", eval_dequeue_batch)
    register("Eval.Ack", eval_ack)
    register("Eval.Nack", eval_nack)
    register("Eval.Update", eval_update)
    register("Eval.Reblock", eval_reblock)
    register("Eval.PauseNack", eval_pause_nack)
    register("Eval.ResumeNack", eval_resume_nack)
    register("Eval.GetEval",
             lambda body: {"Eval": server.eval_get(body["EvalID"])})
    register("Eval.List", lambda body: {
        "Evals": server.eval_list(),
        "Index": server.state.table_index("evals")})
    register("Eval.Allocations", lambda body: {
        "Allocs": server.eval_allocations(body["EvalID"]),
        "Index": server.state.table_index("allocs")})

    # -- Plan (plan_endpoint.go) --------------------------------------------

    def plan_submit(body):
        plan = _typed(s.Plan, body["Plan"])
        # Re-denormalize the wire-stripped placements: the submitter
        # (follower_sched._strip_plan_for_wire) ships the job once.
        if plan.job is not None:
            for allocs in plan.node_allocation.values():
                for alloc in allocs:
                    if alloc.job is None:
                        alloc.job = plan.job
        future = server.plan_submit(plan)
        # Bounded: a dropped plan (leadership churn) answers with an
        # error; an unresponsive applier must not pin this thread.  On a
        # timeout, cancel if unclaimed: either the applier never saw the
        # plan (the worker may replan) or it owns it and will answer, so
        # wait a grace period rather than let the placements commit twice.
        try:
            result = future.wait(timeout=60.0)
        except TimeoutError:
            if future.cancel():
                raise
            try:
                result = future.wait(timeout=540.0)
            except TimeoutError:
                raise TimeoutError(
                    "plan outcome unknown: applier claimed the plan but "
                    "did not respond in 600s; do not replan immediately")
        if result is None:
            return {"Result": None}
        # A full commit would only echo the plan's own allocations back:
        # reply with a compact marker, and the submitter rebuilds the
        # result from its copy of the plan.
        if not result.refresh_index and (
                sum(map(len, result.node_allocation.values()))
                == sum(map(len, plan.node_allocation.values()))
                and sum(map(len, result.node_update.values()))
                == sum(map(len, plan.node_update.values()))
                and sum(len(sl) for sl in result.alloc_slabs)
                == sum(len(sl) for sl in plan.alloc_slabs)):
            return {"Result": {"Full": True,
                               "AllocIndex": result.alloc_index}}
        return {"Result": result}

    register("Plan.Submit", plan_submit)

    # -- Operator ------------------------------------------------------------

    def operator_raft_remove_peer(body):
        server.operator_raft_remove_peer(body.get("Address", ""))
        return {}

    rpc.register("Operator.RaftGetConfiguration",
                 lambda body: server.raft_configuration())
    rpc.register("Operator.RaftRemovePeerByAddress",
                 operator_raft_remove_peer)
