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


@pytest.mark.gpu
@pytest.mark.parametrize("u,n,u_off,n_off", [
    (1, 10112, 0, 0), (1, 10112, 37, 0), (128, 10112, 0, 0), (3, 700, 5, 0),
    # The mesh's per-shard call: one spec row over a 250,016-node shard,
    # jitter keyed on the global node index of the last of four shards.
    (1, 250_016, 77, 750_048)])
def test_scored_rows_kernel_matches_plain(u, n, u_off, n_off):
    need_card()
    args = inputs(u, n, u + n + u_off, "cuda")
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
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got_base.view(torch.int32),
                       want_base.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("u,n", [(1, 10112), (128, 10112), (3, 700)])
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
    # One shared ScoreFit: the masked score is scored_rows' base, bit for
    # bit, wherever the spec fits.
    assert torch.equal(got[live].view(torch.int32),
                       base[live].view(torch.int32))


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
