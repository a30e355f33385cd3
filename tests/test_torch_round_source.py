"""The round kernel's CUDA source, compiled with g++ and run on the CPU.

``nomad_tpu_torch/csrc/placement_rounds.cu`` is built against
``tests/cuda_mock/cuda_runtime.h`` and ``cooperative_groups.h``, a mock
of the CUDA runtime that runs a cooperative launch's blocks at once, one
OS thread a block, and each block's CUDA threads as fibers
(``__syncthreads``, the warp shuffles and ``__match_any_sync``
and the grid barrier wait for their block, warp or grid; ``__shared__``
is ``thread_local``, so every block has its own shared memory, static
and dynamic).  It is built at ``NOMAD_ROUND_THREADS=64`` (two warps, so a
few hundred nodes span several tiles and a reserved port's words several
passes) and run on grids of up to three blocks, and at the card's 1,024
threads on two blocks.  ``kernels._kernel_rounds`` drives it through
ctypes on CPU tensors, one launch a call, with the wrapper's own
``RoundArgs``; its result must equal the eager loop's
(``kernels.placement_rounds``, the kernel's plain version) bit for bit:
placements, commit scores and collisions, slots and their scores and
collisions, unplaced, used_after, rounds and committing steps.  Inputs
are seeded (``round_inputs.py``): plain specs, distinct_hosts, networks
with reserved ports, distinct_property, tight batches that end by the
min-ask exit, and the grid's own cases (a ragged last block, an == T band
and a distinct_property value across blocks, slot records cut inside a
later block, many rounds, specs with k = 0, keys outside shared memory).

This holds the kernel's indexing, barriers and arithmetic without a
card; ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` phase ``rounds``
hold it on one (the mock cannot show a missing memory fence).
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
# The card's defaults of the mock's device (SMs, opt-in shared memory a
# block, blocks of the kernel an SM holds).
CARD = (132, 232448, 1)


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
        lib.nomad_placement_rounds.argtypes = [ctypes.c_void_p,
                                               ctypes.c_void_p]
        lib.nomad_placement_rounds.restype = ctypes.c_int
        lib.nomad_mock_device.argtypes = [ctypes.c_int, ctypes.c_longlong,
                                          ctypes.c_int]
        libs[threads or 1024] = lib
    return libs


def mock_launch(lib, statuses, device=CARD):
    """A ``launch(t, seed, max_rounds)`` for ``kernels._kernel_rounds``:
    the wrapper's ``RoundArgs`` of the CPU tensors ``t``, through the mock
    library on a mocked ``device``; each launch's status is appended to
    ``statuses``."""
    def launch(t, seed, max_rounds):
        lib.nomad_mock_device(*device)
        try:
            args = fused_score._round_args(t, fused_score._round_sizes(t),
                                           seed, max_rounds)
            rc = lib.nomad_placement_rounds(ctypes.addressof(args), None)
        finally:
            lib.nomad_mock_device(*CARD)
        if rc:
            raise RuntimeError(f"mock launch failed: cudaError {rc}")
        statuses.append(t["status"].tolist())
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


def run_both(lib, x, seed, *, max_rounds=256, with_scores=True, slot_m=0,
             blocks=3, device=CARD):
    """The batch ``x`` through the source on the mock (a grid of at most
    ``blocks`` blocks) and through the eager loop: ``(got, want,
    statuses)``, held bit for bit, one launch unless nothing can run."""
    args, extra = port_rounds_args(x)
    statuses = []
    got = kernels._kernel_rounds(*args, seed, max_rounds, with_scores,
                                 slot_m, extra["net"], extra["dp"],
                                 mock_launch(lib, statuses, device), blocks)
    want = kernels.placement_rounds(*args, seed, max_rounds=max_rounds,
                                    with_scores=with_scores, slot_m=slot_m,
                                    **extra)
    assert_same(got, want)
    assert len(statuses) == 1
    assert statuses[0][:2] == [want.rounds, want.commit_steps]
    return got, want, statuses


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
    run_both(mock_libs[64], x, jseed,
             max_rounds=2 if seed % 6 == 3 else 256,
             with_scores=with_scores, slot_m=slot_m if slot else 0)


@pytest.mark.parametrize("opts", [{}, {"net": True, "dp": True}],
                         ids=["plain", "networks_dp"])
def test_source_at_the_card_block_size(mock_libs, opts):
    """The default build (1,024 threads a block, 32 warps) on 2,500 nodes
    over two blocks: two tiles in each, a full warp of warps in every
    block scan."""
    x = random_rounds(77, 6, 2500, w=70, **opts)
    x["count"] = np.minimum(x["count"], 300).astype(np.int32)
    _, want, st = run_both(mock_libs[1024], x, 12345, slot_m=64, blocks=2)
    assert want.commit_steps > 0 and st[0][2] == 2


def uniform(n, u=1, count=None, seed=5):
    """``u`` specs on ``n`` identical nodes, all feasible: their scores
    differ only by the tie jitter, so many keys tie."""
    x = random_rounds(seed, u, n)
    x["cap"][:] = 8000
    x["used"][:] = 1000
    x["denom"] = x["cap"][:, :2].astype(np.float32)
    x["feas"][:] = True
    x["ask"][:] = 100
    x["penalty"][:] = 0.0
    x["dh"][:] = False
    x["jc"][:] = 0
    if count is not None:
        x["count"][:] = count
    return x


def first_step_keys(x, seed):
    """The first spec's commit scores in the first step (the eager loop's
    scoring, on the CPU)."""
    args, _ = port_rounds_args(x)
    feas, used, cap, denom, ask, _, penalty, _, ji, jc = args
    scored, _ = fused_score.scored_rows(
        feas[:1], used, cap, denom, ask[:1], penalty[:1], jc[ji[0]][None],
        seed)
    return scored[0].numpy()


def band_case():
    """One spec on 200 identical nodes over blocks of 67, k set so that T
    is a tied score whose band starts in one block and is completed by
    a node of a later block."""
    n, chunk, seed = 200, 67, 4242
    x = uniform(n)
    s = first_step_keys(x, seed)
    block = np.arange(n) // chunk
    for v in sorted(set(s.tolist()), reverse=True):
        members = np.flatnonzero(s == v)
        if len(set(block[members].tolist())) > 1:
            first_block = block[members[0]]
            before = int((s > v).sum())
            take = int((block[members] == first_block).sum()) + 1
            x["count"][:] = before + take
            return x, seed, {"band": len(members), "take": take}
    raise AssertionError("no tied score spans two blocks")


def grid_cases():
    """name -> (build, run options, check of the eager result)."""
    def ragged():
        # 64 x 3 threads do not divide 200 or 129 nodes.
        return random_rounds(31, 5, 200, w=70, net=True), 99, {}

    def band():
        x, seed, info = band_case()
        assert info["band"] >= 2
        return x, seed, {}

    def slot_cut():
        # 150 picks over three blocks, the record cut at 80: inside the
        # second block's picks.
        x = uniform(200, count=150)
        return x, 7, {"slot_m": 80}

    def dp_across():
        x = random_rounds(41, 6, 200, dp=True, v=4)
        x["dp_active"][:] = True
        x["dp_col"][:] = 0
        x["attr"][:, 0] = np.arange(200) % 4   # every value in every block
        x["dp_used"][:] = False
        return x, 11, {}

    def reserved():
        x = random_rounds(53, 7, 180, net=True, w=70)
        x["net_active"][:] = True
        x["resv_words"][::2, 3] = np.int32(-2147483648)
        x["resv_words"][1::2, 66] = 1 << 5
        return x, 13, {}

    def many_rounds():
        # 4 allocs a node: a round places at most one a node.
        return uniform(150, u=2, count=500), 17, {"slot_m": 512}

    def max_rounds():
        return uniform(150, u=2, count=500), 17, {"max_rounds": 3}

    def dp_tied():
        # A penalty of 1e6 on one collision swamps the jitter: every ok
        # node's key ties, so each value keeps its lowest node index.
        x = uniform(200, u=3, count=90)
        x["dp_active"], x["dp_col"] = np.ones(3, bool), np.zeros(3, np.int32)
        x["dp_used"] = np.zeros((3, 4), bool)
        x["attr"] = (np.arange(200) % 4).astype(np.int32)[:, None]
        x["penalty"][:] = 1e6
        x["ji"][:] = 0
        x["jc"][0] = 1
        return x, 23, {}

    def min_ask_exit():
        # Room for one alloc a node: the first round fills every node,
        # then no node fits the smallest ask and the loop stops.
        x = uniform(150, u=2, count=200)
        x["cap"][:] = x["used"] + 100
        return x, 29, {}

    def nothing_fits():
        x = uniform(150, u=2, count=5)
        x["cap"][:] = x["used"] + 99
        return x, 31, {}

    def k_zero():
        x = random_rounds(61, 8, 170, w=70, net=True)
        x["feas"][1::3] = False   # these specs never have an ok node
        return x, 19, {}

    return {"ragged_200": ragged, "ragged_129": lambda: (
                random_rounds(32, 4, 129, dp=True), 98, {}),
            "band_across_blocks": band, "slot_cut_in_later_block": slot_cut,
            "dp_value_across_blocks": dp_across, "reserved_ports": reserved,
            "dp_tied_keys": dp_tied, "many_rounds": many_rounds,
            "max_rounds": max_rounds, "min_ask_exit": min_ask_exit,
            "nothing_fits": nothing_fits, "k_zero": k_zero}


@pytest.mark.parametrize("smem", [True, False], ids=["keys_shared",
                                                       "keys_global"])
@pytest.mark.parametrize("name", list(grid_cases()))
def test_source_grid_cases(mock_libs, name, smem):
    """The grid's own cases on three blocks of 64 threads, bit for bit,
    with the keys in each block's shared memory and, where the card's
    shared memory is too small for them, in the global scratch."""
    x, seed, opts = grid_cases()[name]()
    device = CARD if smem else (132, 0, 1)
    got, want, st = run_both(mock_libs[64], x, seed, device=device, **opts)
    rounds, steps, blocks, in_shared = st[0]
    assert blocks == 3 and in_shared == int(smem)
    assert steps > 0 or name == "nothing_fits"
    if name == "slot_cut_in_later_block":
        assert int((want.slots >= 0).sum()) == 80
        assert int(want.unplaced.sum()) == 0
    if name == "many_rounds":
        assert rounds >= 4 and int(want.unplaced.sum()) == 0
    if name == "max_rounds":
        assert rounds == 3 and int(want.unplaced.sum()) > 0
    if name == "min_ask_exit":
        assert rounds == 1 and int(want.unplaced.sum()) == 2 * 200 - 150
    if name == "nothing_fits":
        assert rounds == steps == 0
    if name == "dp_tied_keys":
        assert int(want.unplaced.sum()) > 0
    if name == "k_zero":
        assert int(want.unplaced[1::3].sum()) == int(x["count"][1::3].sum())


def test_source_grid_of_one_block(mock_libs):
    """At most one block: the same result as three."""
    x, slot_m, jseed = case(4)
    _, _, st = run_both(mock_libs[64], x, jseed, slot_m=slot_m, blocks=1)
    assert st[0][2] == 1


def test_source_refused_launch_raises(mock_libs):
    """A card that cannot keep the grid resident refuses the cooperative
    launch; the loop raises, nothing falls back."""
    x = random_rounds(3, 3, 200)
    args, extra = port_rounds_args(x)
    with pytest.raises(RuntimeError, match="cudaError 82"):
        kernels._kernel_rounds(*args, 5, 256, True, 0, extra["net"],
                               extra["dp"],
                               mock_launch(mock_libs[64], [], (132, 232448,
                                                               0)), 3)


def test_nothing_to_run_launches_nothing(mock_libs):
    x = random_rounds(3, 3, 50)
    args, extra = port_rounds_args(x)
    statuses = []
    got = kernels._kernel_rounds(*args, 5, 0, True, 0, extra["net"],
                                 extra["dp"],
                                 mock_launch(mock_libs[64], statuses), 3)
    assert statuses == [] and got.rounds == 0
    assert torch.equal(got.unplaced, args[5])
