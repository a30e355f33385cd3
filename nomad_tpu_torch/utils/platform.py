"""Device-platform identification shared by the GPU fingerprint and the
device tracer (the counterpart of ``nomad_tpu/utils/platform.py``).

The reference's ``virtual_mesh_env`` (a subprocess environment that
provisions a virtual CPU mesh for jax) has no torch counterpart: the
port's mesh takes a tuple of devices (``parallel.make_node_mesh``), so a
CPU mesh needs no environment.
"""
from __future__ import annotations

import torch


def is_cuda_platform(device=None) -> bool:
    """Whether ``device`` (a ``torch.device`` or its string; ``None``
    means ``cuda``) is a CUDA card this process can use: the counterpart
    of ``is_tpu_platform``."""
    dev = torch.device("cuda" if device is None else device)
    return dev.type == "cuda" and torch.cuda.is_available()
