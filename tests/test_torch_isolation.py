"""The port stands alone: it imports neither jax nor nomad_tpu, nor
msgpack (the card's machine does not install it: the port's log,
snapshot, RPC frames and replicated log use its own struct codec), looks
none of them up by name, runs with jax unimportable (and a replicated
cluster over the wire with all three unimportable), and never falls back
from the card to the CPU."""
import ast
import pathlib
import re
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


# A string that names a module of jax or of the reference: what a lookup
# by name (sys.modules.get, importlib.import_module, __import__) takes.
MODULE_NAME = re.compile(r"(jax|jaxlib|nomad_tpu|msgpack)(\.[\w.]*)?")


def named_modules(source, filename="<string>"):
    """The string constants of ``source`` that name a forbidden module."""
    tree = ast.parse(source, filename=filename)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and MODULE_NAME.fullmatch(node.value.strip())):
            yield node.value


PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "eviction_inputs.py",
                                          ROOT / "evict_ablation.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "nomad_tpu", "msgpack"), (path,
                                                                   mod)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_module_looked_up_by_name(path):
    assert list(named_modules(path.read_text(), str(path))) == [], path


@pytest.mark.parametrize("source,found", [
    ('import sys\nm = sys.modules.get("nomad_tpu.ops.resident")\n',
     ["nomad_tpu.ops.resident"]),
    ('import importlib\nimportlib.import_module("jax")\n', ["jax"]),
    ('__import__("nomad_tpu")\n', ["nomad_tpu"]),
    ('import importlib\nimportlib.import_module("msgpack")\n', ["msgpack"]),
    ('import sys\nm = sys.modules.get("nomad_tpu_torch.ops.resident")\n',
     []),
    ('"""Reads nomad_tpu/ops/resident.py, like jax.jit does."""\n', []),
])
def test_name_lookup_check_catches_what_it_should(source, found):
    assert list(named_modules(source)) == found


def test_plan_applier_notes_the_port_mirror():
    from nomad_tpu_torch.server import plan_apply

    assert plan_apply.resident.__name__ == "nomad_tpu_torch.ops.resident"


def test_runs_with_jax_unimportable():
    code = """
import sys
sys.modules["jax"] = None
sys.modules["nomad_tpu"] = None
sys.modules["msgpack"] = None
from nomad_tpu_torch import mock
from nomad_tpu_torch.ops.batch_sched import schedule_batch
nodes = [mock.node() for _ in range(20)]
for n in nodes:
    n.resources.networks = []
    n.reserved.networks = []
job = mock.job()
for t in job.task_groups[0].tasks:
    t.resources.networks = []
res = schedule_batch(nodes, [job], rng_seed=3, device="cpu")
sp = res.placements[(job.id, "web")]
assert len(sp.node_ids) == 10 and sp.unplaced == 0, sp
from nomad_tpu_torch.scheduler.scheduler import new_scheduler
from nomad_tpu_torch.scheduler.testing import Harness
from nomad_tpu_torch.structs import structs as s
from nomad_tpu_torch.server import PlanApplier
h = Harness()
h.planner = PlanApplier(h.state, device="cpu", next_index=h.next_index)
for n in nodes:
    h.state.upsert_node(h.next_index(), n)
h.state.upsert_job(h.next_index(), job)
ev = s.Evaluation(id=s.generate_uuid(), type=job.type, job_id=job.id,
                  triggered_by=s.EVAL_TRIGGER_JOB_REGISTER)
stats = new_scheduler("torch-batch", h.logger, h.snapshot(), h,
                      device="cpu", rng_seed=3).schedule_batch([ev])
assert stats.device_ran and stats.oracle_routed == 0, stats
assert len(h.state.allocs_by_job(None, job.id, True)) == 10
assert [e.status for e in h.evals] == [s.EVAL_STATUS_COMPLETE], h.evals
import shutil, tempfile
from nomad_tpu_torch.server.fsm import FSM, MessageType
from nomad_tpu_torch.server.raft import FileLog
d = tempfile.mkdtemp()
log = FileLog(FSM(), d, snapshot_entries=0, snapshot_bytes=0)
log.apply(MessageType.NODE_REGISTER, {"node": nodes[0]})
assert log.snapshot()
log.apply(MessageType.JOB_REGISTER, {"job": job})
log.close()
log = FileLog(FSM(), d, snapshot_entries=0, snapshot_bytes=0)
assert log.applied_index() == 2 and log.recovery["snapshot_index"] == 1
assert log.fsm.state.job_by_id(None, job.id) is not None
log.close()
shutil.rmtree(d)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_lifecycle_runs_with_jax_unimportable():
    """The job lifecycle's modules (cron, periodic, core GC, the quota
    ledger and the broker's namespace hooks) on a port server, with jax,
    nomad_tpu and msgpack unimportable."""
    code = """
import sys
sys.modules["jax"] = None
sys.modules["nomad_tpu"] = None
sys.modules["msgpack"] = None
import time
from nomad_tpu_torch import mock
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.eval_broker import BrokerLimitError
from nomad_tpu_torch.structs import structs as s
from nomad_tpu_torch.utils.backoff import wait_until
from nomad_tpu_torch.utils.cron import cron_next
assert cron_next("@hourly", 0.0) == 3600.0 - time.localtime(0).tm_min * 60
srv = Server(ServerConfig(device="cpu", min_heartbeat_ttl=3600.0))
srv.start()
try:
    for _ in range(4):
        n = mock.node()
        n.resources.networks = []
        n.reserved.networks = []
        srv.node_register(n)
    srv.namespace_upsert(s.Namespace(name="t", max_live_allocs=20))
    def job(job_id):
        j = mock.job()
        j.id = j.name = job_id
        j.type = "batch"
        j.namespace = "t"
        for t in j.task_groups[0].tasks:
            t.resources.networks = []
        return j
    per = job("per")
    per.periodic = s.PeriodicConfig(enabled=True, spec="@yearly")
    par = job("par")
    par.parameterized_job = s.ParameterizedJobConfig(payload="optional")
    assert srv.job_register(per)[1] == "" and srv.job_register(par)[1] == ""
    srv.set_workers_paused(True)
    srv.periodic_force("per")
    srv.job_dispatch("par", b"", {})
    try:
        srv.job_dispatch("par", b"", {})
        raise AssertionError("admitted over the quota")
    except BrokerLimitError as e:
        assert e.namespace == "t"
    srv.set_workers_paused(False)
    assert wait_until(lambda: all(e.status == "complete"
                                  for e in srv.state.evals(None)), 60.0)
    done = [a.copy() for a in srv.state.allocs(None)]
    for a in done:
        a.client_status = "complete"
    srv.node_update_allocs(done)
    srv.system_gc()
    assert wait_until(lambda: not [j for j in srv.state.jobs(None)
                                   if j.parent_id], 60.0)
finally:
    srv.shutdown()
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cluster_runs_with_msgpack_unimportable():
    """Three port servers over loopback: RPC, membership, MultiRaft and a
    write forwarded from a follower, with jax, nomad_tpu and msgpack
    unimportable."""
    code = """
import sys
sys.modules["jax"] = None
sys.modules["nomad_tpu"] = None
sys.modules["msgpack"] = None
from nomad_tpu_torch import mock
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.utils.backoff import wait_until
servers, first = [], None
for i in range(3):
    srv = Server(ServerConfig(
        device="cpu", node_name=f"iso-{i}", enable_rpc=True,
        bootstrap_expect=3, start_join=[first] if first else [],
        num_schedulers=1, follower_schedulers=1, min_heartbeat_ttl=3600.0,
        raft_heartbeat=0.2, raft_election_min=5.0, raft_election_max=8.0))
    first = first or srv.config.rpc_advertise
    servers.append(srv)
for srv in servers:
    srv.start()
try:
    assert wait_until(lambda: any(x.is_leader() for x in servers), 40.0)
    leader = next(x for x in servers if x.is_leader())
    follower = next(x for x in servers if x is not leader)
    node = mock.node()
    node.resources.networks = []
    node.reserved.networks = []
    follower.node_register(node)
    job = mock.job()
    for t in job.task_groups[0].tasks:
        t.resources.networks = []
    _, eval_id = follower.job_register(job)
    assert wait_until(lambda: (e := leader.state.eval_by_id(None, eval_id))
                      is not None and e.status == "complete", 60.0)
    assert wait_until(lambda: len({x.fsm_fingerprint()
                                   for x in servers}) == 1, 30.0)
finally:
    for srv in servers:
        srv.shutdown()
assert sys.modules["msgpack"] is None
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=180)
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
    from nomad_tpu_torch.ops.batch_sched import TorchBatchScheduler
    from nomad_tpu_torch.scheduler.testing import Harness

    h = Harness()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchBatchScheduler(h.logger, h.snapshot(), h)
    from nomad_tpu_torch.server import PlanApplier

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PlanApplier(h.state)


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
