"""The drills of ``python -m nomad_tpu_torch.ops --selfcheck`` that came
with the guard plane (residency, fused, residue, codec, mesh, analysis),
on the CPU.

Each passes.  The reference's residency, fused, residue, codec and
analysis drills run on this box, so the port's are held against them on
the same seed: batch by batch, the counters the drills assert on
(evals, asks, resident hits, full walks, staleness fences, oracle routes,
rejected results, whether the device ran) and the placed count of each
batch's jobs; the codec drill's rejected corruptions and guarded calls.
The reference's mesh drill fails under jax 0.9.0 (ROADMAP queue 3 item
1), so the port's mesh drill's placements are held against the port's
single-device path on the same batches instead.
"""
import re

import jax  # noqa: F401  (the reference computes on the CPU backend)
import pytest

from nomad_tpu.ops import __main__ as jdrills
from nomad_tpu.ops import batch_sched as jbatch
from nomad_tpu.ops import breaker as jbreaker
from nomad_tpu_torch.ops import __main__ as drills
from nomad_tpu_torch.ops import batch_sched, breaker, resident

NEW_DRILLS = ("residency", "fused", "residue", "codec", "mesh", "analysis")
COUNTERS = ("num_evals", "num_asks", "resident_hits", "full_reencodes",
            "staleness_fences", "oracle_routed", "kernel_rejects",
            "device_ran")


@pytest.fixture(autouse=True)
def fresh_state():
    breaker.reset_for_tests()
    resident.reset_counters()
    resident.invalidate()
    yield
    breaker.reset_for_tests()
    resident.reset_counters()
    resident.invalidate()


def _live_count(h, job_id):
    return len([a for a in h.state.allocs_by_job(None, job_id, True)
                if not a.terminal_status()])


def _spy(monkeypatch, cls, rows, placements=None):
    """Record each batch's counters and live placements of its jobs."""
    real = cls.schedule_batch

    def spy(self, evals):
        stats = real(self, evals)
        rows.append(tuple(getattr(stats, k) for k in COUNTERS)
                    + (tuple(_live_count(self.planner, ev.job_id)
                             for ev in evals),))
        if placements is not None:
            placements.append([sorted(
                (a.name, a.node_id)
                for a in self.planner.state.allocs_by_job(None, ev.job_id,
                                                          True)
                if not a.terminal_status()) for ev in evals])
        return stats

    monkeypatch.setattr(cls, "schedule_batch", spy)


@pytest.mark.parametrize("name", NEW_DRILLS)
def test_drill_passes_on_the_cpu(name):
    lines = []
    verdicts = {}
    kw = {"verdicts": verdicts} if name == "analysis" else {}
    ok = getattr(drills, f"{name}_drill")(seed=0, device="cpu",
                                          log=lines.append, **kw)
    assert ok, lines
    assert any(f"{name} drill: OK" in ln for ln in lines), lines
    if name == "analysis":
        assert verdicts["sanitized_corpus"] == "clean" or verdicts[
            "sanitized_corpus"].startswith("skip: ")


def test_selfcheck_names_twelve_drills():
    """The twelve drills and, since the chaos plane was ported, the
    chaos drill after the follower drill (thirteen)."""
    assert drills.DRILLS == (
        "preempt", "breaker", "columnar", "tracing", "wal", "follower",
        "chaos", "residency", "fused", "residue", "codec", "mesh",
        "analysis")
    assert drills.run_drills(device="cpu", log=lambda m: None,
                             only=("codec",)) == {"codec": True}


@pytest.mark.parametrize("name", ["residency", "fused", "residue"])
def test_drill_batches_equal_the_references(monkeypatch, name):
    # The reference's residue drill runs on its process-wide breaker,
    # which an earlier test in this worker may have tripped (ROADMAP
    # queue 3 item 7): the reference gets a fresh one here.
    monkeypatch.setattr(jbreaker, "BREAKER",
                        jbreaker.KernelCircuitBreaker())
    ref_rows, port_rows = [], []
    _spy(monkeypatch, jbatch.TPUBatchScheduler, ref_rows)
    _spy(monkeypatch, batch_sched.TorchBatchScheduler, port_rows)
    assert getattr(jdrills, f"{name}_drill")(seed=0, log=lambda m: None)
    assert getattr(drills, f"{name}_drill")(seed=0, device="cpu",
                                            log=lambda m: None)
    assert len(ref_rows) >= 2
    assert port_rows == ref_rows


def test_codec_drill_counts_equal_the_references():
    def numbers(fn):
        lines = []
        assert fn(lines.append)
        line = next(ln for ln in lines if "codec drill: OK" in ln)
        rejected = re.search(r"(\d+) corruptions rejected", line).group(1)
        guarded = re.search(r"(\d+) guarded calls", line).group(1)
        return int(rejected), int(guarded)

    ref = numbers(lambda log: jdrills.codec_drill(seed=0, log=log))
    port = numbers(lambda log: drills.codec_drill(seed=0, device="cpu",
                                                  log=log))
    assert port == ref and port[0] > 0 and port[1] == 32


def test_analysis_drill_legs_agree_with_the_references():
    ref_lines, port_lines, verdicts = [], [], {}
    assert jdrills.analysis_drill(seed=0, log=ref_lines.append)
    assert drills.analysis_drill(seed=0, device="cpu",
                                 log=port_lines.append, verdicts=verdicts)
    ref_corpus = ("clean" if any("corpus clean" in ln for ln in ref_lines)
                  else "skip")
    assert verdicts["sanitized_corpus"].split(":")[0] == ref_corpus
    for leg in ("wal", "codec", "decode", "ids"):
        assert any(f"{leg} leg OK" in ln for ln in port_lines)


def test_mesh_drill_places_as_the_single_device_path(monkeypatch):
    from nomad_tpu_torch.ops.__main__ import (_drill_node, _live,
                                              _private_breaker,
                                              _register_job)
    from nomad_tpu_torch.scheduler.testing import Harness

    mesh_rows, mesh_pl = [], []
    _spy(monkeypatch, batch_sched.TorchBatchScheduler, mesh_rows, mesh_pl)
    assert drills.mesh_drill(seed=0, device="cpu", log=lambda m: None)
    assert len(mesh_pl) == 4
    monkeypatch.undo()

    # The same fleet and the first three batches (the fourth is the
    # oracle's, routed by the tripped breaker) on one device.
    resident.invalidate()
    resident.reset_counters()
    h = Harness()
    for i in range(16):
        h.state.upsert_node(h.next_index(), _drill_node(i))
    single = []
    for k in range(3):
        job, ev = _register_job(h, k)
        stats = batch_sched.TorchBatchScheduler(
            h.logger, h.snapshot(), h, device="cpu", rng_seed=0,
            breaker=_private_breaker(), resident=True,
            guard_every=1).schedule_batch([ev])
        assert stats.oracle_routed == 0 and stats.mesh_shards == 0
        single.append([_live(h, job.id)])
    assert mesh_pl[:3] == single
    assert all(len(p[0]) == 2 for p in mesh_pl)
    # The mesh drill's batches: 4 shards on the device, then the oracle.
    assert [r[COUNTERS.index("oracle_routed")] for r in mesh_rows] == [
        0, 0, 0, 1]
