"""The port's server package (copies of ``nomad_tpu/server/``): the
in-process :class:`Server` with its eval broker, blocked evals, plan
queue, FSM over an in-memory or a durable log (``FileLog``: the native
group-commit WAL and FSM snapshots) or the replicated ``MultiRaft``, the
plan applier, heartbeats, the batch workers, and the cluster: the RPC
layer (``rpc``), its endpoints, serf-lite membership, leader forwarding
and the follower workers (``follower_sched``)."""

from .blocked_evals import BlockedEvals  # noqa: F401
from .eval_broker import (BrokerLimitError, EvalBroker,  # noqa: F401
                          EvalBrokerError)
from .fsm import FSM, MessageType, TimeTable  # noqa: F401
from .heartbeat import HeartbeatTimers  # noqa: F401
from .plan_apply import PlanApplier  # noqa: F401
from .plan_queue import PlanFuture, PlanQueue  # noqa: F401
from .raft import (FileLog, InmemLog, MultiRaft, NotLeaderError,  # noqa: F401
                   RaftLog)
from .server import Server, ServerConfig  # noqa: F401
from .worker import BatchWorker, Worker  # noqa: F401
