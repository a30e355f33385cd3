"""The round kernel's CUDA source, compiled with g++ and run on the CPU.

``nomad_tpu_torch/csrc/placement_rounds.cu`` is built against
``tests/cuda_mock/cuda_runtime.h``, a mock of the CUDA runtime that runs
one block's threads as ``std::thread``s (``__syncthreads`` a barrier, the
warp shuffles, ballots and ``__match_any_sync`` through a per-warp
barrier, ``__shared__`` as ``static``), at ``NOMAD_ROUND_THREADS=64``
(two warps, so a few hundred nodes span several tiles and a reserved
port's words several passes) and at the card's 1,024.
``kernels._kernel_rounds`` drives it through ctypes on CPU tensors, one
launch a round, with the wrapper's own ``RoundArgs``; its result must
equal the eager loop's (``kernels.placement_rounds``, the kernel's plain
version) bit for bit: placements, commit scores and collisions, slots
and their scores and collisions, unplaced, used_after, rounds and
committing steps.  Inputs are seeded (``round_inputs.py``): plain
specs, distinct_hosts, networks with reserved ports, distinct_property,
and tight batches that end by the min-ask exit.

This holds the kernel's indexing, barriers and arithmetic without a
card; ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` phase ``rounds``
hold it on one.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from nomad_tpu_torch.ops import fused_score, kernels
from round_inputs import port_rounds_args, random_rounds

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "nomad_tpu_torch" / "csrc" / "placement_rounds.cu"
MOCK = Path(__file__).resolve().parent / "cuda_mock"
OUTPUTS = ("placements", "unplaced", "used_after", "commit_scores",
           "commit_collisions", "slots", "slot_scores", "slot_coll")


@pytest.fixture(scope="module")
def mock_libs(tmp_path_factory):
    """``threads -> ctypes library`` of the source built against the mock,
    at 64 threads a block and at the card's default."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ is needed to build the CUDA source on the CPU")
    out = tmp_path_factory.mktemp("round_mock")
    libs = {}
    for threads in (64, None):
        so = out / f"round_{threads or 'default'}.so"
        cmd = [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fwrapv",
               "-shared", "-fPIC", "-pthread", "-x", "c++",
               f"-I{MOCK}", f"-I{SOURCE.parent}", str(SOURCE), "-o", str(so)]
        if threads is not None:
            cmd.insert(1, f"-DNOMAD_ROUND_THREADS={threads}")
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-4000:]
        lib = ctypes.CDLL(str(so))
        lib.nomad_placement_round.argtypes = [ctypes.c_void_p,
                                              ctypes.c_void_p]
        lib.nomad_placement_round.restype = ctypes.c_int
        libs[threads or 1024] = lib
    return libs


def mock_launch(lib, launches):
    """A ``launch(t, seed)`` for ``kernels._kernel_rounds``: the wrapper's
    ``RoundArgs`` of the CPU tensors ``t``, through the mock library."""
    def launch(t, seed):
        args = fused_score._round_args(t, fused_score._round_sizes(t), seed)
        rc = lib.nomad_placement_round(ctypes.addressof(args), None)
        if rc:
            raise RuntimeError(f"mock launch failed: {rc}")
        launches.append(1)
        return t["status"]
    return launch


def assert_same(got, want):
    for f in OUTPUTS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f"{f}: {int((a != b).sum())} differ"
    assert (got.rounds, got.commit_steps) == (want.rounds, want.commit_steps)


def case(seed):
    """Seed ``seed``'s batch: 1-8 specs on 8-300 nodes, networks on every
    third seed (70 port words: two passes of the 64-thread gather), dp on
    every fourth, tight capacity on every fifth."""
    rng = np.random.default_rng(seed)
    u, n = int(rng.integers(1, 9)), int(rng.integers(8, 300))
    x = random_rounds(1000 + seed, u, n, net=seed % 3 == 1, dp=seed % 4 == 2,
                      tight=seed % 5 == 0, w=70)
    return x, int(rng.integers(1, 12)), int(rng.integers(0, 2**32))


@pytest.mark.parametrize("with_scores", [True, False])
@pytest.mark.parametrize("slot", [True, False])
@pytest.mark.parametrize("seed", range(12))
def test_source_matches_eager_loop(mock_libs, seed, slot, with_scores):
    x, slot_m, jseed = case(seed)
    slot_m = slot_m if slot else 0
    args, extra = port_rounds_args(x)
    launches = []
    max_rounds = 2 if seed % 6 == 3 else 256
    got = kernels._kernel_rounds(*args, jseed, max_rounds, with_scores,
                                 slot_m, extra["net"], extra["dp"],
                                 mock_launch(mock_libs[64], launches))
    want = kernels.placement_rounds(*args, jseed, max_rounds=max_rounds,
                                    with_scores=with_scores, slot_m=slot_m,
                                    **extra)
    assert_same(got, want)
    assert len(launches) == want.rounds


@pytest.mark.parametrize("opts", [{}, {"net": True, "dp": True}],
                         ids=["plain", "networks_dp"])
def test_source_at_the_card_block_size(mock_libs, opts):
    """The default build (1,024 threads a block, 32 warps) on 2,500 nodes:
    three tiles, a full warp of warps in every block scan."""
    x = random_rounds(77, 6, 2500, w=70, **opts)
    x["count"] = np.minimum(x["count"], 300).astype(np.int32)
    args, extra = port_rounds_args(x)
    launches = []
    got = kernels._kernel_rounds(*args, 12345, 256, True, 64, extra["net"],
                                 extra["dp"],
                                 mock_launch(mock_libs[1024], launches))
    want = kernels.placement_rounds(*args, 12345, slot_m=64, **extra)
    assert_same(got, want)
    assert want.commit_steps > 0 and len(launches) == want.rounds

