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
                                          ROOT / "evict_ablation.py",
                                          ROOT / "profiler_gap.py",
                                          ROOT / "round_inputs.py"]


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


def test_loadgen_smoke_runs_with_jax_unimportable(tmp_path):
    """The load harness's smoke scenario on the CPU, through the CLI and
    then with the profiler, the flight recorder, its SLO watch and the
    lock-order sanitizer armed, with jax, nomad_tpu and msgpack
    unimportable."""
    code = f"""
import json, sys
sys.modules["jax"] = None
sys.modules["nomad_tpu"] = None
sys.modules["msgpack"] = None
from nomad_tpu_torch.loadgen.__main__ import main
from nomad_tpu_torch.loadgen import LoadHarness
from nomad_tpu_torch.loadgen.scenario import get_scenario
from nomad_tpu_torch.utils import blackbox, contprof, lockcheck
from nomad_tpu_torch.utils.backoff import wait_until
out = {str(tmp_path / "report.json")!r}
assert main(["--smoke", "--device", "cpu", "--out", out]) == 0
with open(out) as fh:
    report = json.load(fh)
assert report["sustained"]["completed_total"] == 30, report["sustained"]
lockcheck.arm()
try:
    h = LoadHarness(get_scenario("smoke"), device="cpu",
                    server_options={{
                        "contprof_hz": 20.0,
                        "blackbox_dir": {str(tmp_path / "bb")!r},
                        "blackbox_min_interval_s": 3600.0,
                        "slo_plan_p99_ms": 1e-6}})
    report = h.run()
    assert report["sustained"]["completed_total"] == 30
    assert report["host_attribution"]["thread_samples"] > 0
    # The run may end inside the first metrics tick: tick once more.
    h.server.emit_gauges()
    assert wait_until(lambda: len(blackbox.bundles()) == 1, 10.0)
    lockcheck.assert_acyclic()
finally:
    lockcheck.disarm()
    contprof.disable()
    blackbox.disable()
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"


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
    # The follower forwards only once its first AppendEntries named the
    # leader.
    assert wait_until(lambda: all(
        x.leader_address() == leader.config.rpc_advertise
        for x in servers), 30.0)
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


# The modules of the vault and federation slice, named so that their
# check cannot silently drop out of PORT_FILES.
SLICE_MODULES = ("server/vault.py", "client/vaultclient.py",
                 "server/federation.py", "loadgen/federation.py")


@pytest.mark.parametrize("rel", SLICE_MODULES)
def test_vault_and_federation_modules_are_checked(rel):
    path = PKG / rel
    assert path in PORT_FILES
    assert not [m for m in imported_modules(path)
                if m.split(".")[0] in ("jax", "jaxlib", "nomad_tpu",
                                       "msgpack")]
    assert list(named_modules(path.read_text(), str(path))) == []


def test_federation_and_vault_run_with_jax_unimportable():
    """Two WAN-joined port regions over loopback with jax, nomad_tpu and
    msgpack unimportable: a job forwarded across regions, a vault token
    derived through ``FakeVault``, a severed region answering
    ``NoPathToRegion``, and the aggregator's fan-in."""
    code = """
import sys
sys.modules["jax"] = None
sys.modules["nomad_tpu"] = None
sys.modules["msgpack"] = None
from nomad_tpu_torch import fault, mock
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.federation import RegionEventAggregator
from nomad_tpu_torch.server.rpc import NoPathToRegion
from nomad_tpu_torch.server.vault import FakeVault, VaultConfig
from nomad_tpu_torch.structs import structs as s
from nomad_tpu_torch.utils.backoff import wait_until
fv = FakeVault()
a = Server(ServerConfig(device="cpu", region="ra", node_name="a",
                        enable_rpc=True, min_heartbeat_ttl=3600.0,
                        vault=VaultConfig(enabled=True)), vault_api=fv)
b = Server(ServerConfig(device="cpu", region="rb", node_name="b",
                        enable_rpc=True, min_heartbeat_ttl=3600.0,
                        wan_join=[a.config.rpc_advertise]))
a.start()
b.start()
try:
    assert wait_until(lambda: a.regions() == ["ra", "rb"]
                      and b.regions() == ["ra", "rb"], 20.0)
    node = mock.node()
    node.resources.networks = []
    node.reserved.networks = []
    b.node_register(node)
    job = mock.job()
    job.region = "rb"
    for t in job.task_groups[0].tasks:
        t.resources.networks = []
    _, eval_id = a.job_register(job)
    assert wait_until(lambda: (e := b.state.eval_by_id(None, eval_id))
                      is not None and e.status == "complete", 60.0)
    assert a.state.job_by_id(None, job.id) is None
    vjob = mock.job()
    vjob.task_groups[0].tasks[0].vault = s.Vault(policies=["p"])
    alloc = s.Allocation(id=s.generate_uuid(), node_id="vault-node",
                         job_id=vjob.id, job=vjob,
                         task_group=vjob.task_groups[0].name,
                         desired_status="run", client_status="running")
    a.state.upsert_job(a.raft.applied_index() + 1, vjob)
    a.state.upsert_allocs(a.raft.applied_index() + 2, [alloc])
    out = a.derive_vault_token(alloc.id, ["web"])
    assert fv.unwrap(out["web"]["wrapped_token"])["accessor"] \\
        == out["web"]["accessor"]
    agg = RegionEventAggregator({"ra": a.config.rpc_advertise,
                                 "rb": b.config.rpc_advertise})
    agg.poll()
    fault.net_sever_regions({"ra": [a.config.rpc_advertise],
                             "rb": [b.config.rpc_advertise]},
                            isolate="rb", name="dark")
    job2 = mock.job()
    try:
        a.job_register(job2, region="rb")
        raise AssertionError("no NoPathToRegion")
    except NoPathToRegion as e:
        assert e.region == "rb" and e.retry_after > 0
    fault.net_heal("dark")
    agg.pool.close()
finally:
    fault.net_disarm()
    a.shutdown()
    b.shutdown()
assert sys.modules["msgpack"] is None
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"


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


def test_load_harness_raises_without_cuda():
    """The harness's leader runs on the device it is given: with the
    default ``cuda`` and no card it raises, through the API and the CLI,
    and never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; this checks the CPU-only case")
    from nomad_tpu_torch.loadgen import LoadHarness
    from nomad_tpu_torch.loadgen.__main__ import main
    from nomad_tpu_torch.loadgen.scenario import get_scenario

    h = LoadHarness(get_scenario("smoke"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        h.run()
    assert h.server is None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--smoke"])


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


@pytest.mark.parametrize("package", ["agent", "api", "cli", "consul",
                                     "jobspec"])
def test_front_door_packages_are_checked(package):
    """The front door's directories are among the files the import and
    name-lookup checks above walk."""
    files = [p for p in PORT_FILES if p.parent == PKG / package]
    assert {p.name for p in files} >= {"__init__.py"}
    assert len(files) >= 2


def test_front_door_runs_with_jax_unimportable(tmp_path):
    """A server-only agent from an HCL config on the CPU, an HCL job
    through the CLI and HTTP, a blocking read of its eval and the CLI's
    status, with jax, nomad_tpu and msgpack unimportable."""
    code = f"""
import io, json, sys, urllib.request
sys.modules["jax"] = None
sys.modules["nomad_tpu"] = None
sys.modules["msgpack"] = None
from nomad_tpu_torch import mock
from nomad_tpu_torch.agent import Agent, load_config_file
from nomad_tpu_torch.cli import main
from nomad_tpu_torch.utils.backoff import wait_until
cfg_path = {str(tmp_path / "agent.hcl")!r}
with open(cfg_path, "w") as fh:
    fh.write('server {{ enabled = true }}\\nclient {{ enabled = false }}\\n'
             'ports {{\\n  http = 0\\n  rpc = 0\\n}}\\n')
job_path = {str(tmp_path / "web.nomad")!r}
with open(job_path, "w") as fh:
    fh.write('job "web" {{\\n  datacenters = ["dc1"]\\n  group "g" {{\\n'
             '    count = 2\\n    task "t" {{\\n      driver = "exec"\\n'
             '      resources {{\\n        cpu = 100\\n        memory = 64\\n'
             '      }}\\n    }}\\n  }}\\n}}\\n')
cfg = load_config_file(cfg_path)
cfg.dev_mode = True
agent = Agent(cfg, device="cpu",
              server_options={{"min_heartbeat_ttl": 3600.0}})
agent.start()
try:
    for _ in range(3):
        n = mock.node()
        n.resources.networks = []
        n.reserved.networks = []
        agent.server.node_register(n)
    out = io.StringIO()
    addr = agent.http.address
    assert main(["job", "run", "-detach", "-address", addr, job_path],
                out=out) == 0, out.getvalue()
    eval_id = out.getvalue().split("Evaluation ID: ")[1].split()[0]
    index = 0
    while True:
        with urllib.request.urlopen(
                f"{{addr}}/v1/evaluation/{{eval_id}}?index={{index}}"
                f"&wait=30s", timeout=60) as resp:
            ev = json.load(resp)
            index = int(resp.headers["X-Nomad-Index"])
        if ev["Status"] == "complete":
            break
    out = io.StringIO()
    assert main(["job", "status", "-address", addr, "web"], out=out) == 0
    assert "running" in out.getvalue()
    assert len(agent.server.state.allocs_by_job(None, "web", False)) == 2
finally:
    agent.shutdown()
assert wait_until(lambda: not agent.threads(), 15.0)
assert sys.modules["jax"] is None and sys.modules["msgpack"] is None
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"


@pytest.mark.parametrize("module", [
    "analysis/__init__.py", "analysis/__main__.py", "analysis/lockrules.py",
    "analysis/guardrules.py", "native/__main__.py", "ops/guards.py",
    "ops/decode.py"])
def test_guard_plane_modules_are_checked(module):
    """The guard plane's modules are among the files the import and
    name-lookup checks above walk."""
    assert PKG / module in PORT_FILES


def test_guard_plane_runs_with_jax_unimportable():
    """The static pass, the native decode against its twin, the native
    uuids, the residue and analysis drills (the sanitized corpus child
    included, which imports the package anew) with jax, nomad_tpu and
    msgpack unimportable."""
    code = """
import sys
sys.modules["jax"] = None
sys.modules["nomad_tpu"] = None
sys.modules["msgpack"] = None
import numpy as np
from nomad_tpu_torch.analysis import run_checks
from nomad_tpu_torch.ops import decode
from nomad_tpu_torch.ops.__main__ import analysis_drill, residue_drill
from nomad_tpu_torch.structs import structs as s
active, _ = run_checks()
assert not active, [v.key for v in active]
rows = np.array([0, 0, 1, -1], dtype=np.int32)
cols = np.array([2, 2, 0, 1], dtype=np.int32)
counts = np.array([1, 2, 1, 0], dtype=np.int32)
got = decode.expand_coo(rows, cols, counts, 2, 3, guard_every=1)
want = decode.expand_coo(rows, cols, counts, 2, 3, native=False)
assert all(np.array_equal(a, b) for a, b in zip(got, want))
assert len(set(s.generate_uuids(100))) == 100
assert residue_drill(device="cpu", log=lambda m: None)
verdicts = {}
assert analysis_drill(device="cpu", log=lambda m: None, verdicts=verdicts)
assert sys.modules["jax"] is None and sys.modules["msgpack"] is None
print(verdicts["sanitized_corpus"].split(":")[0])
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] in ("clean", "skip")


@pytest.mark.parametrize("module", [
    "client/__init__.py", "client/client.py", "client/config.py",
    "client/alloc_runner.py", "client/task_runner.py", "client/allocdir.py",
    "client/restarts.py", "client/getter.py", "client/template.py",
    "client/state.py", "client/gc.py", "client/stats.py",
    "client/fs_stream.py", "client/driver/__init__.py",
    "client/driver/driver.py", "client/driver/env.py",
    "client/driver/fields.py", "client/driver/mock_driver.py",
    "client/driver/cgroups.py", "client/driver/executor.py",
    "client/driver/supervisor.py", "client/driver/exec_drivers.py",
    "client/driver/docker_api.py", "client/driver/container_drivers.py",
])
def test_client_modules_are_checked(module):
    """The client's modules are among the files the import and name-lookup
    checks above walk."""
    assert PKG / module in PORT_FILES


def test_client_runs_with_jax_unimportable(tmp_path):
    """A dev agent (a server and a client) on the CPU runs a mock-driver
    job to completion, and a second client reaches the server through
    ``RemoteServerRPC``, with jax, nomad_tpu and msgpack unimportable."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["nomad_tpu"] = None
sys.modules["msgpack"] = None
import socket
_connect = socket.create_connection
def _local_only(address, *args, **kwargs):
    # The cloud metadata fingerprints' probes stay on this machine.
    if address[0] not in ("127.0.0.1", "localhost"):
        raise OSError("no network in this test")
    return _connect(address, *args, **kwargs)
socket.create_connection = _local_only
from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.client import Client, ClientConfig
from nomad_tpu_torch.server.rpc import RemoteServerRPC
from nomad_tpu_torch.structs import structs as s
from nomad_tpu_torch.utils.backoff import wait_until
cfg = AgentConfig.dev()
cfg.ports.http = 0
cfg.client.alloc_dir = {str(tmp_path / "a")!r}
agent = Agent(cfg, device="cpu",
              server_options={{"min_heartbeat_ttl": 3600.0}})
agent.client.heartbeat_stagger = 0.1
agent.start()
srv = agent.server
remote = Client(ClientConfig(node_id="remote", alloc_dir={str(tmp_path / "b")!r}),
                rpc=RemoteServerRPC([srv.config.rpc_advertise]),
                heartbeat_stagger=0.1)
remote.start()
try:
    assert wait_until(lambda: all(
        (srv.node_get(i) or s.Node()).status == "ready"
        for i in (agent.client.node.id, "remote")), 30.0)
    job = s.Job(id="iso", name="iso", type="batch", datacenters=["dc1"],
                task_groups=[s.TaskGroup(name="g", count=3, tasks=[s.Task(
                    name="t", driver="mock_driver",
                    config={{"run_for": "50ms"}},
                    resources=s.Resources(cpu=100, memory_mb=64))],
                    restart_policy=s.RestartPolicy(attempts=0, mode="fail"),
                    ephemeral_disk=s.EphemeralDisk(size_mb=10))])
    srv.job_register(job)
    assert wait_until(lambda: len(srv.state.allocs(None)) == 3 and all(
        a.client_status == "complete" for a in srv.state.allocs(None)), 30.0)
finally:
    remote.shutdown()
    agent.shutdown()
assert wait_until(lambda: not agent.threads() and not remote.threads(), 15.0)
assert sys.modules["jax"] is None and sys.modules["msgpack"] is None
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"
