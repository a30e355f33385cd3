"""The port's server package (copies of ``nomad_tpu/server/``): the
in-process :class:`Server` with its eval broker, blocked evals, plan
queue, FSM over an in-memory or a durable log (``FileLog``: the native
group-commit WAL and FSM snapshots), the plan applier, heartbeats and the
batch workers."""

from .blocked_evals import BlockedEvals  # noqa: F401
from .eval_broker import (BrokerLimitError, EvalBroker,  # noqa: F401
                          EvalBrokerError)
from .fsm import FSM, MessageType, TimeTable  # noqa: F401
from .heartbeat import HeartbeatTimers  # noqa: F401
from .plan_apply import PlanApplier  # noqa: F401
from .plan_queue import PlanFuture, PlanQueue  # noqa: F401
from .raft import FileLog, InmemLog, NotLeaderError, RaftLog  # noqa: F401
from .server import Server, ServerConfig  # noqa: F401
from .worker import BatchWorker, Worker  # noqa: F401
