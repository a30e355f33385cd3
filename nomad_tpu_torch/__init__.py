"""PyTorch/CUDA port of nomad_tpu's batch-placement path.

A second package beside ``nomad_tpu`` (which stays the reference).  It
imports torch and numpy only -- never jax and nothing of ``nomad_tpu``;
what it needs from the reference's jax-free modules is copied here under
the same layout (``structs/``, ``scheduler/``, ``ops/``).

Entry point: :func:`nomad_tpu_torch.ops.batch_sched.schedule_batch`.
"""

__version__ = "0.1.0"
