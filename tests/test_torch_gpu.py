"""Card-only checks of the port's CUDA kernels (marker ``gpu``).

They need an NVIDIA card with nvcc and skip elsewhere; run them on the
card with ``python -m pytest tests/test_torch_gpu.py -m gpu -q``.  This
file imports no jax: the card's machine has none.
"""
import pytest
import torch

from nomad_tpu_torch.ops import fused_score, kernels

ATOL = 4e-6    # 2 ulp of float32 at 18, the top of ScoreFit


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def inputs(u, n, seed, dev):
    g = torch.Generator().manual_seed(seed)
    cap = torch.tensor([4000, 8192, 102400, 150],
                       dtype=torch.int32).repeat(n, 1)
    used = torch.zeros((n, 4), dtype=torch.int32)
    used[:, 0] = torch.randint(0, 4200, (n,), generator=g, dtype=torch.int32)
    used[:, 1] = torch.randint(0, 8192, (n,), generator=g, dtype=torch.int32)
    denom = cap[:, :2].to(torch.float32)
    denom[torch.rand(n, generator=g) < 0.1, 0] = 0.0
    feas = torch.rand((u, n), generator=g) < 0.8
    ask = torch.tensor([500, 256, 150, 0], dtype=torch.int32).repeat(u, 1)
    penalty = torch.rand(u, generator=g) * 25.0
    coll = torch.randint(0, 3, (u, n), generator=g, dtype=torch.int32)
    return [x.to(dev) for x in (feas, used, cap, denom, ask, penalty, coll)]


def same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def check_scored(args, u_off, n_off):
    """One launch of scored_rows against its plain version on the same
    inputs: identical mask, 0 differing bits in scored and base."""
    before = fused_score.LAUNCHES
    got, got_base = fused_score.scored_rows(*args, 12345, u_offset=u_off,
                                            n_offset=n_off)
    want, want_base = fused_score.scored_rows_reference(
        *args, 12345, u_offset=u_off, n_offset=n_off)
    torch.cuda.synchronize()
    assert fused_score.LAUNCHES == before + 1
    assert torch.equal(got == -1e30, want == -1e30)
    live = want != -1e30
    assert float((got - want)[live].abs().max()) <= ATOL
    assert float((got_base - want_base).abs().max()) <= ATOL
    # The kernel and its plain version agree bit for bit.
    assert same_bits(got, want)
    assert same_bits(got_base, want_base)


# The score tile's edges: N % 4 != 0 takes the scalar path (701); U = 1,
# 7, 9 and 129 are no multiple of a row tile; the mesh's shard offsets.
EDGE_SHAPES = [(1, 701, 0, 0), (9, 701, 3, 0), (7, 10112, 0, 0),
               (9, 10112, 5, 0), (129, 10112, 0, 0),
               (9, 2528, 11, 7584), (9, 250_016, 2, 250_016)]


@pytest.mark.gpu
@pytest.mark.parametrize("u,n,u_off,n_off", [
    (1, 10112, 0, 0), (1, 10112, 37, 0), (128, 10112, 0, 0), (3, 700, 5, 0),
    # The mesh's per-shard call: one spec row over a 250,016-node shard,
    # jitter keyed on the global node index of the last of four shards.
    (1, 250_016, 77, 750_048)] + EDGE_SHAPES)
def test_scored_rows_kernel_matches_plain(u, n, u_off, n_off):
    need_card()
    check_scored(inputs(u, n, u + n + u_off, "cuda"), u_off, n_off)


@pytest.mark.gpu
@pytest.mark.parametrize("u,n", [(9, 10113), (3, 70_000)])
def test_scored_rows_kernel_on_row_views(u, n):
    """The loop passes one row of a [U, N] tensor: its start lies u·N
    bytes into feas.  With N % 4 != 0 the rows are misaligned; with an
    odd storage offset so is every row, where an aligned row of 70,000
    nodes would take the vector path.  The kernel takes its scalar path
    there and still agrees bit for bit."""
    need_card()
    feas, used, cap, denom, ask, penalty, coll = inputs(u, n, u * n, "cuda")
    shifted = torch.zeros(u * n + 1, dtype=torch.uint8, device="cuda")
    shifted[1:] = feas.view(torch.uint8).reshape(-1)
    for rows in (feas, shifted[1:].view(u, n)):
        for r in range(u):
            check_scored([rows[r:r + 1], used, cap, denom, ask[r:r + 1],
                          penalty[r:r + 1], coll[r:r + 1]], r, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("u,n,n_off", [(1, 10112, 0), (1, 250_016, 250_016),
                                       (9, 701, 0), (129, 10112, 0)])
def test_scored_rows_kernel_without_base(u, n, n_off):
    """``with_base=False`` (the loops' call when they keep no scores)
    writes the same scores, bit for bit, and no base."""
    need_card()
    args = inputs(u, n, 3 * u + n, "cuda")
    got, none = fused_score.scored_rows(*args, 777, u_offset=2,
                                        n_offset=n_off, with_base=False)
    want, _ = fused_score.scored_rows(*args, 777, u_offset=2, n_offset=n_off)
    torch.cuda.synchronize()
    assert none is None
    assert same_bits(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("u,n", [(1, 10112), (128, 10112), (3, 700),
                                 (1, 701), (9, 701), (7, 10112), (129, 10112),
                                 (9, 10113)])
def test_masked_score_kernel_matches_plain(u, n):
    need_card()
    feas, used, cap, denom, ask, penalty, coll = inputs(u, n, u + n, "cuda")
    feas[:, n - 50:] = False                  # padding columns
    before = fused_score.MASKED_LAUNCHES
    got = fused_score.masked_score_matrix(feas, used, cap, denom, ask)
    want = fused_score.masked_score_matrix_reference(feas, used, cap, denom,
                                                     ask)
    _, base = fused_score.scored_rows(feas, used, cap, denom, ask, penalty,
                                      coll, 99)
    torch.cuda.synchronize()
    assert fused_score.MASKED_LAUNCHES == before + 1
    assert torch.equal(got == -1e30, want == -1e30)
    live = want != -1e30
    assert float((got - want)[live].abs().max()) <= ATOL
    assert same_bits(got, want)
    # One shared ScoreFit: the masked score is scored_rows' base, bit for
    # bit, wherever the spec fits.
    assert same_bits(got[live], base[live])


@pytest.mark.gpu
def test_kernels_on_degenerate_denominators():
    """NaN, ±inf, negative, ±0 and tiny denominators and asks that
    overflow the fit: ScoreFit's NaN/inf rules, held bit for bit against
    the plain versions by both kernels."""
    need_card()
    u, n = 5, 4096
    args = inputs(u, n, 5, "cuda")
    odd = torch.tensor([float("nan"), float("inf"), float("-inf"), -5.0,
                        0.0, -0.0, 1e-30, 1e30], device="cuda")
    args[3] = odd[torch.randint(0, 8, (n, 2), device="cuda")]
    args[4] = torch.tensor([[500, 256, 0, 0], [0, 0, 0, 0],
                            [-100000, 5, 0, 0], [2**30, 2**30, 0, 0],
                            [7, -3, 0, 0]], dtype=torch.int32, device="cuda")
    check_scored(args, 0, 0)
    feas, used, cap, denom, ask = args[:5]
    got = fused_score.masked_score_matrix(feas, used, cap, denom, ask)
    want = fused_score.masked_score_matrix_reference(feas, used, cap, denom,
                                                     ask)
    torch.cuda.synchronize()
    assert same_bits(got, want)


@pytest.mark.gpu
def test_placement_rounds_on_card_matches_cpu():
    need_card()
    g = torch.Generator().manual_seed(4)
    u, n = 8, 2048
    cap = torch.tensor([4000, 8192, 102400, 150],
                       dtype=torch.int32).repeat(n, 1)
    used = torch.zeros((n, 4), dtype=torch.int32)
    denom = cap[:, :2].to(torch.float32)
    feas = torch.rand((u, n), generator=g) < 0.9
    ask = torch.tensor([500, 256, 150, 0], dtype=torch.int32).repeat(u, 1)
    count = torch.full((u,), 700, dtype=torch.int32)
    penalty = torch.full((u,), 20.0)
    dh = torch.zeros(u, dtype=torch.bool)
    ji = torch.arange(u, dtype=torch.int32)
    jc = torch.zeros((u, n), dtype=torch.int32)
    args = (feas, used, cap, denom, ask, count, penalty, dh, ji, jc)
    seed = kernels.jitter_seed(11)
    cpu = kernels.placement_rounds(*args, seed, slot_m=1024)
    card = kernels.placement_rounds(*(a.cuda() for a in args), seed,
                                    slot_m=1024)
    assert card.rounds == cpu.rounds
    assert torch.equal(card.slots.cpu(), cpu.slots)
    assert torch.equal(card.unplaced.cpu(), cpu.unplaced)
    assert float((card.slot_scores.cpu() - cpu.slot_scores).abs().max()) \
        <= ATOL
