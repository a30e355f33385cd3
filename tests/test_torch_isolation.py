"""The port stands alone: it imports neither jax nor nomad_tpu, runs with
jax unimportable, and never falls back from the card to the CPU."""
import ast
import pathlib
import subprocess
import sys

import jax  # noqa: F401  (kept like the other port tests; unused here)
import pytest
import torch

from nomad_tpu_torch import device
from nomad_tpu_torch.ops import fused_score

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "nomad_tpu_torch"


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "nomad_tpu"), (path, mod)


def test_runs_with_jax_unimportable():
    code = """
import sys
sys.modules["jax"] = None
sys.modules["nomad_tpu"] = None
from nomad_tpu_torch import mock
from nomad_tpu_torch.ops.batch_sched import schedule_batch
nodes = [mock.node() for _ in range(20)]
for n in nodes:
    n.resources.networks = []
job = mock.job()
for t in job.task_groups[0].tasks:
    t.resources.networks = []
res = schedule_batch(nodes, [job], rng_seed=3, device="cpu")
sp = res.placements[(job.id, "web")]
assert len(sp.node_ids) == 10 and sp.unplaced == 0, sp
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device.resolve_device("cuda")
    assert device.resolve_device("cpu").type == "cpu"
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops.batch_sched import schedule_batch

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        schedule_batch([mock.node()], [mock.job()], rng_seed=1)


def test_kernel_wrapper_never_computes_plain_off_the_cpu():
    t = lambda *shape, dt=torch.int32: torch.empty(  # noqa: E731
        shape, dtype=dt, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_score.scored_rows(
            t(1, 128, dt=torch.bool), t(128, 4), t(128, 4),
            t(128, 2, dt=torch.float32), t(1, 4), t(1, dt=torch.float32),
            t(1, 128), 7)
    assert fused_score.LAUNCHES == 0


def test_kernel_library_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(device, "find_nvcc", lambda: None)
    monkeypatch.setattr(device, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(device, "_LIBS", {})
    with pytest.raises(device.KernelUnavailable, match="nvcc not found"):
        device.load_library("scored_rows")
