"""The port's rkt and lxc drivers (``nomad_tpu_torch/client/driver/
container_drivers.py``) against the JAX package's, twins of
``tests/test_container_drivers.py``.

The same configs and task dirs go through both packages' pure command
assembly (rkt's ``command_line``, lxc's ``create_args`` and
``command_line``), and the argument lists must be equal exactly (paths
compared relative to each package's task dir; the lxc per-launch nonce
pinned).  The fingerprints, the start paths (``rkt trust``,
``lxc-create``, the foreground run under the supervisor) and lxc's kill
(``lxc-stop -k`` and ``lxc-destroy -f``) run against stub binaries on
``PATH`` in both packages: no rkt or lxc is installed or needed.
"""
import os
import subprocess

import jax  # noqa: F401  (kept like the other port tests)
import pytest

from nomad_tpu.client import allocdir as jallocdir
from nomad_tpu.client.driver import container_drivers as jcont
from nomad_tpu.client.driver import driver as jdriver
from nomad_tpu.client.driver import env as jenv
from nomad_tpu.structs import structs as js
from nomad_tpu_torch.client import allocdir as pallocdir
from nomad_tpu_torch.client.driver import container_drivers as pcont
from nomad_tpu_torch.client.driver import driver as pdriver
from nomad_tpu_torch.client.driver import env as penv
from nomad_tpu_torch.structs import structs as ps
from test_torch_exec_drivers import FakeConfig, stub
from test_torch_supervisor import kill_leftovers, wait_until

PKG = {"ref": (js, jdriver, jenv, jcont, jallocdir),
       "port": (ps, pdriver, penv, pcont, pallocdir)}
WAIT = 20.0


@pytest.fixture(autouse=True)
def no_leftovers(tmp_path):
    yield
    kill_leftovers(tmp_path)


@pytest.fixture
def fixed_nonce(monkeypatch):
    monkeypatch.setattr(os, "urandom", lambda n: b"\x5a" * n)


def setup(pkg, tmp_path, name, config, options=None, env=None):
    m, drv, envmod, cont, allocdir = PKG[pkg]
    ad = allocdir.AllocDir(str(tmp_path / pkg / "alloc-dir"))
    ad.build()
    td = ad.new_task_dir("web")
    td.build()
    ectx = drv.ExecContext(task_dir=td, task_env=envmod.TaskEnv(
        env_map=dict(env or {"NOMAD_TASK_NAME": "web"})))
    task = m.Task(name="web", driver=name, config=dict(config),
                  resources=m.Resources(cpu=500, memory_mb=256),
                  kill_timeout=2.0)
    cls = cont.RktDriver if name == "rkt" else cont.LxcDriver
    d = cls(drv.DriverContext(driver_name=name, alloc_id="alloc12345",
                              config=FakeConfig(options)))
    return d, ectx, task


def rel(pkg, tmp_path, value):
    root = str(tmp_path / pkg)
    if isinstance(value, str):
        return value.replace(root, "<root>")
    return type(value)(rel(pkg, tmp_path, v) for v in value)


def outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 -- compared across packages
        return ("error", type(e).__name__, str(e))


RKT = [
    ({"image": "example.com/app:1.0", "command": "/bin/serve",
      "args": ["--name", "${NOMAD_TASK_NAME}"], "dns_servers": ["8.8.8.8"],
      "dns_search_domains": ["example.com"], "net": ["host"],
      "port_map": {"http": "8080"}, "volumes": ["/host/data:/data"],
      "no_overlay": True, "debug": True}, None),
    ({"image": "img", "trust_prefix": "example.com",
      "insecure_options": ["image"]}, None),
    ({"image": "img", "trust_prefix": "example.com"}, None),
    ({"image": "img", "insecure_options": ["image", "ondisk"]}, None),
    ({"image": "img", "volumes": ["/a:/b"]}, {"rkt.volumes.enabled": "false"}),
    ({"image": "img", "volumes": ["/only-host-path"]}, None),
    ({"image": "img-${NOMAD_TASK_NAME}", "debug": "true",
      "no_overlay": "false"}, None),
]


@pytest.mark.parametrize("config,options", RKT)
def test_rkt_command_line_equals_the_reference(tmp_path, config, options):
    out = {}
    for pkg in PKG:
        d, ectx, task = setup(pkg, tmp_path, "rkt", config, options)
        out[pkg] = rel(pkg, tmp_path, outcome(
            lambda: list(d.command_line(ectx, task))))
    assert out["port"] == out["ref"]


LXC = [
    ({"template": "download", "distro": "ubuntu", "release": "xenial",
      "arch": "amd64", "disable_gpg": True, "flush_cache": True,
      "template_args": ["--extra", "${NOMAD_TASK_NAME}"]}, None),
    ({"template": "t", "volumes": ["/host/x:container/x"],
      "log_level": "debug"}, None),
    ({"template": "t", "volumes": ["/a:/abs"]}, None),
    ({"template": "t", "volumes": ["/a:b"]}, {"lxc.volumes.enabled": "0"}),
    ({"template": "busybox", "image_variant": "default",
      "image_server": "images.example", "gpg_key_id": "k",
      "gpg_key_server": "ks", "force_cache": "true"}, None),
]


@pytest.mark.parametrize("config,options", LXC)
def test_lxc_assembly_equals_the_reference(tmp_path, fixed_nonce, config,
                                           options):
    out = {}
    for pkg in PKG:
        d, ectx, task = setup(pkg, tmp_path, "lxc", config, options)
        out[pkg] = rel(pkg, tmp_path, [
            outcome(lambda: d.container_name(ectx, task)),
            outcome(lambda: d.create_args(ectx, task)),
            outcome(lambda: list(d.command_line(ectx, task)))])
    assert out["port"] == out["ref"]
    assert out["port"][0] == ("ok", "web-alloc12345-5a5a5a5a")


@pytest.mark.parametrize("name,config", [
    ("rkt", {"image": "coreos.com/etcd:v2.0.4"}), ("rkt", {}),
    ("rkt", {"image": 123}), ("lxc", {"template": "/usr/share/lxc/t"}),
    ("lxc", {}), ("lxc", {"template": "t", "volumes": "x"})])
def test_validation_equals_the_reference(name, config):
    out = []
    for drv in (jdriver, pdriver):
        try:
            drv.validate_driver_config(name, config)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    assert out[0] == out[1]


FINGERPRINTS = {
    "rkt_versions": ("rkt", {"rkt": "echo 'rkt Version: 1.29.0'\n"
                                    "echo 'appc Version: 0.8.11'"}, None),
    "rkt_broken": ("rkt", {"rkt": "exit 3"}, None),
    "rkt_absent": ("rkt", {}, None),
    "lxc_disabled": ("lxc", {"lxc-start": "echo 2.0.8"}, None),
    "lxc_enabled": ("lxc", {"lxc-start": "echo 2.0.8"},
                    {"driver.lxc.enable": "1"}),
    "lxc_broken": ("lxc", {"lxc-start": "exit 1"},
                   {"driver.lxc.enable": "true"}),
}


@pytest.mark.parametrize("case", sorted(FINGERPRINTS))
def test_fingerprint_equals_the_reference(tmp_path, monkeypatch, case):
    name, stubs, options = FINGERPRINTS[case]
    bindir = tmp_path / "bin"
    bindir.mkdir()
    for binary, script in stubs.items():
        stub(bindir, binary, script)
    monkeypatch.setenv("PATH", str(bindir))
    out = {}
    for pkg in PKG:
        d, _, _ = setup(pkg, tmp_path, name, {}, options)
        node = PKG[pkg][0].Node()
        node.attributes = {f"driver.{name}": "1",
                           f"driver.{name}.version": "old"}
        out[pkg] = (d.fingerprint(node), node.attributes, d.periodic())
    assert out["port"] == out["ref"]
    assert out["port"][0] is case.endswith(("versions", "enabled"))


def logs_of(ectx):
    d = ectx.task_dir.log_dir
    return b"".join(open(os.path.join(d, f), "rb").read()
                    for f in sorted(os.listdir(d)) if ".stdout." in f)


def test_rkt_start_runs_the_stub_like_the_reference(tmp_path, monkeypatch):
    """The assembled rkt argv runs under the supervisor against a stub
    that prints it; the trust pre-step runs first."""
    bindir = tmp_path / "bin"
    trusted = tmp_path / "trusted"
    stub(bindir, "rkt", 'if [ "$1" = trust ]; then echo "$@" >> '
         f'{trusted}; exit 0; fi\nfor a in "$@"; do echo "$a"; done')
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    out = {}
    for pkg in PKG:
        d, ectx, task = setup(pkg, tmp_path, "rkt", {
            "image": "img", "trust_prefix": "example.com",
            "args": ["${NOMAD_TASK_NAME}"]},
            env={"PATH": os.environ["PATH"], "NOMAD_TASK_NAME": "web"})
        h = d.start(ectx, task).handle
        assert h.wait_ch().wait(WAIT)
        out[pkg] = (h.wait_result().exit_code,
                    rel(pkg, tmp_path, logs_of(ectx).decode()))
    assert out["port"] == out["ref"]
    assert out["port"][1].splitlines()[-3:] == ["img", "--", "web"]
    assert trusted.read_text().splitlines() == [
        "trust --skip-fingerprint-review=true --prefix=example.com "
        "--debug=false"] * 2


@pytest.mark.parametrize("which", ["rkt", "lxc"])
def test_failing_pre_step_fails_the_start_like_the_reference(
        tmp_path, monkeypatch, which):
    class Boom:
        returncode = 1
        stderr = b"no such thing"

    out = {}
    for pkg in PKG:
        if which == "rkt":
            d, ectx, task = setup(pkg, tmp_path, "rkt", {
                "image": "img", "trust_prefix": "x.com"})
            monkeypatch.setattr(d, "_run_rkt_trust", lambda *a: Boom())
        else:
            d, ectx, task = setup(pkg, tmp_path, "lxc", {"template": "nope"})
            monkeypatch.setattr(d, "_run_lxc_create", lambda *a: Boom())
        out[pkg] = outcome(lambda: d.start(ectx, task))
    assert out["port"] == out["ref"]
    assert out["port"][:2] == ("error", "DriverError")


def test_lxc_start_and_kill_like_the_reference(tmp_path, monkeypatch,
                                               fixed_nonce):
    """``lxc-create`` then a foreground ``lxc-start -F`` under the
    supervisor; kill takes the container down itself (``lxc-stop -k``)
    and removes its rootfs (``lxc-destroy -f``)."""
    bindir = tmp_path / "bin"
    calls = tmp_path / "calls"
    for binary in ("lxc-create", "lxc-stop", "lxc-destroy"):
        stub(bindir, binary, f'echo "{binary} $*" >> {calls}')
    stub(bindir, "lxc-start", "sleep 30")
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    out = {}
    for pkg in PKG:
        calls.write_text("")
        d, ectx, task = setup(pkg, tmp_path, "lxc", {"template": "busybox"},
                              env={"PATH": os.environ["PATH"]})
        h = d.start(ectx, task).handle
        name = h.container_name
        started = calls.read_text()
        h.kill()
        assert h.wait_ch().wait(WAIT)
        assert wait_until(lambda: "lxc-destroy" in calls.read_text())
        out[pkg] = (name, started, calls.read_text(),
                    h.wait_result().signal)
        with open(os.path.join(d.ctl_dir(ectx, "web"),
                               "container.name")) as fh:
            assert fh.read() == name
    assert out["port"] == out["ref"]
    name = "web-alloc12345-5a5a5a5a"
    assert out["port"][2].splitlines() == [
        f"lxc-create -n {name} -t busybox", f"lxc-stop -n {name} -k",
        f"lxc-destroy -n {name} -f"]


def test_lxc_open_of_a_gone_supervisor_tears_down(tmp_path, monkeypatch):
    """Re-attach to a task whose supervisor is gone: the reparented
    container may still run, so ``open`` tears it down before it
    reports the task lost."""
    bindir = tmp_path / "bin"
    calls = tmp_path / "calls"
    for binary in ("lxc-stop", "lxc-destroy"):
        stub(bindir, binary, f'echo "{binary} $*" >> {calls}')
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    out = {}
    for pkg in PKG:
        calls.write_text("")
        d, ectx, task = setup(pkg, tmp_path, "lxc", {"template": "t"})
        ctl = d.ctl_dir(ectx, "web")
        os.makedirs(ctl)
        with open(os.path.join(ctl, "container.name"), "w") as fh:
            fh.write("web-old")
        with open(os.path.join(ctl, "task.pid"), "w") as fh:
            fh.write('{"pid": 4194303}')
        out[pkg] = (outcome(lambda: d.open(ectx, f"sup:{ctl}"))[:2],
                    calls.read_text())
    assert out["port"] == out["ref"]
    assert out["port"] == (("error", "DriverError"),
                           "lxc-stop -n web-old -k\n"
                           "lxc-destroy -n web-old -f\n")


def test_rkt_trust_subprocess_is_the_references(tmp_path, monkeypatch):
    seen = {}
    for pkg in PKG:
        d, _, _ = setup(pkg, tmp_path, "rkt", {"image": "i"})
        calls = []
        monkeypatch.setattr(subprocess, "run",
                            lambda argv, **kw: calls.append((argv, kw)))
        d._run_rkt_trust("example.com", "true")
        monkeypatch.undo()
        seen[pkg] = calls
    assert seen["port"] == seen["ref"]
