"""Client SDK + wire codec (a copy of ``nomad_tpu/api/``; reference: api/
Go package)."""

from .client import (AgentAPI, Allocations, APIError, Evaluations, Jobs,
                     NomadAPI, Nodes, Operator, QueryMeta, QueryOptions,
                     Status, System)
from .codec import from_wire, to_wire

__all__ = ["AgentAPI", "Allocations", "APIError", "Evaluations", "Jobs",
           "NomadAPI", "Nodes", "Operator", "QueryMeta", "QueryOptions",
           "Status", "System", "from_wire", "to_wire"]
