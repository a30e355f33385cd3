"""The RPC endpoint registry: wire method names onto ``Server`` methods (a
copy of ``nomad_tpu/server/endpoints.py`` for the endpoints the cluster
uses; reference: the endpoint structs registered at
nomad/server.go:163-174, forwarding at nomad/rpc.go:178).

Forwarding lives in one place: every ``Server`` write method catches
``NotLeaderError`` and re-issues the call to the leader through
``Server._forward``.  This module's wrapper only marks a request that
already took its one forwarding hop (the reference's Forwarded flag) and
turns an unforwardable ``NotLeaderError`` into the wire's
``NoLeaderError``, whose message names the known leader.

Bodies and replies are struct-codec values (``server/rpc.py``): the
structs arrive typed, and a body of the wrong type is refused.

Registered: ``Status.Ping/Leader/Peers/Fingerprint/BrokerStats``,
``Serf.Join/Members``, ``Node.Register/UpdateStatus/Deregister/
UpdateDrain/UpdateAlloc``, ``Job.Register/Deregister/Evaluate/
Dispatch``, ``Periodic.Force``, ``Namespace.Upsert/Delete/List/
Status``, ``System.GarbageCollect/ReconcileJobSummaries``,
``Eval.Dequeue/DequeueBatch/Ack/Nack/Update/Reblock/PauseNack/
ResumeNack/GetEval``, ``Plan.Submit`` and ``Operator.
RaftGetConfiguration/RaftRemovePeerByAddress``.  Vault, events, chaos,
regions and the client's reads wait for their server methods (ROADMAP
queue 1 item 20).
"""

from __future__ import annotations

from typing import Any

from ..structs import structs as s
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
            if forwarded:
                server._fwd_ctx.active = True
            try:
                return fn(body)
            except NotLeaderError as e:
                # Carry the known leader's address, so wire clients can
                # redirect.
                raise NoLeaderError(str(e) or "no cluster leader")
            finally:
                if forwarded:
                    server._fwd_ctx.active = False
        rpc.register(method, handler)

    # -- Status ------------------------------------------------------------

    def status_fingerprint(body):
        """The committed prefix's digest, for a cross-server check."""
        index, fp = server.fsm_fingerprint()
        return {"Index": index, "Fingerprint": fp,
                "AppliedIndex": server.raft.applied_index_relaxed()}

    rpc.register("Status.Ping", lambda body: {"ok": True})
    rpc.register("Status.Leader", lambda body: server.leader_address())
    rpc.register("Status.Peers", lambda body: server.peer_addresses())
    rpc.register("Status.Fingerprint", status_fingerprint)
    rpc.register("Status.BrokerStats", lambda body: server.broker_stats())

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

    register("Node.Register", node_register)
    register("Node.UpdateStatus", node_update_status)
    register("Node.Deregister", node_deregister)
    register("Node.UpdateDrain", node_update_drain)

    def node_update_alloc(body):
        allocs = [_typed(s.Allocation, a) for a in body["Allocs"]]
        return {"Index": server.node_update_allocs(allocs)}

    register("Node.UpdateAlloc", node_update_alloc)

    # -- Job -----------------------------------------------------------------

    def job_register(body):
        index, eval_id = server.job_register(_typed(s.Job, body["Job"]))
        return {"Index": index, "EvalID": eval_id}

    def job_deregister(body):
        index, eval_id = server.job_deregister(
            body["JobID"], purge=body.get("Purge", True))
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

    register("Job.Register", job_register)
    register("Job.Deregister", job_deregister)
    register("Job.Evaluate", job_evaluate)
    register("Job.Dispatch", job_dispatch)
    register("Periodic.Force", periodic_force)

    # -- Namespace and System (the tenancy plane, system_endpoint.go) -------

    def namespace_upsert(body):
        ns = _typed(s.Namespace, body["Namespace"])
        return {"Index": server.namespace_upsert(ns)}

    def namespace_delete(body):
        return {"Index": server.namespace_delete(body["Name"])}

    def namespace_list(body):
        return {"Namespaces": server.namespace_list(),
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
    register("Namespace.Status",
             lambda body: server.namespace_status(body["Name"]))
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
