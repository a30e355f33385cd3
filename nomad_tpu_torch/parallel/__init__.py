"""Node-mesh parallelism for the batch scheduler (``nomad_tpu/parallel``)."""

from .sharded import (
    NodeMesh,
    make_node_mesh,
    sharded_candidate_scores,
    sharded_fused_pass,
    sharded_placement_rounds,
    sharded_schedule_step,
)

__all__ = [
    "NodeMesh",
    "make_node_mesh",
    "sharded_candidate_scores",
    "sharded_fused_pass",
    "sharded_placement_rounds",
    "sharded_schedule_step",
]
