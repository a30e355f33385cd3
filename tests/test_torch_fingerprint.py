"""The port's node fingerprints (``client/fingerprint.py``) and client
config against the JAX package's, on this host.

Every builtin fingerprint of both packages runs on a fresh node; the
attributes and resources they publish must be equal, except the
accelerator fingerprint (the port's ``gpu``, the reference's ``tpu``) and
``nomad.*``: the port's ``NomadFingerprint`` publishes ``nomad.version``
(the package version the reference's agent reports) and
``nomad.revision = "torch"``, while the reference's raises ImportError
(``nomad_tpu/utils/version.py`` has no ``VERSION``), which its
``fingerprint_node`` skips.  The probes that would open a socket are
stubbed in both packages alike (the network fingerprint's address, the
cloud metadata connection), and the two readings that drift between
calls (the CPU clock, free disk) are read once and given to both.
"""
import shutil
import socket

import jax  # noqa: F401  (kept like the other port tests)
import pytest
import torch

import nomad_tpu
from nomad_tpu.client import config as jconfig
from nomad_tpu.client import fingerprint as jfp
from nomad_tpu.structs import structs as js
from nomad_tpu_torch.client import ClientConfig, fingerprint_node
from nomad_tpu_torch.client import fingerprint as pfp
from nomad_tpu_torch.structs import structs as ps
from nomad_tpu_torch.utils.platform import is_cuda_platform

CARD = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def host(monkeypatch):
    """This host's facts, with the socket probes stubbed and the drifting
    readings pinned, in both packages."""
    mhz = pfp.CPUFingerprint._clock_mhz()
    usage = shutil.disk_usage("/")

    def refuse(*args, **kwargs):
        raise OSError("no network in this test")

    monkeypatch.setattr(socket, "create_connection", refuse)
    monkeypatch.setattr(shutil, "disk_usage", lambda path: usage)
    for mod in (jfp, pfp):
        monkeypatch.setattr(mod.CPUFingerprint, "_clock_mhz",
                            staticmethod(lambda: mhz))
        monkeypatch.setattr(mod.NetworkFingerprint, "_default_ip",
                            staticmethod(lambda interface: "10.1.2.3"))
    return mhz


def node_facts(node):
    r = node.resources
    return (dict(node.attributes), None if r is None else (
        r.cpu, r.memory_mb, r.disk_mb, r.iops,
        [(n.device, n.cidr, n.ip, n.mbits) for n in r.networks]))


PAIRS = [(j, p) for j, p in zip(jfp.BUILTIN_FINGERPRINTS,
                                pfp.BUILTIN_FINGERPRINTS)]


def test_builtin_order_matches_reference():
    names = [f.name for f in pfp.BUILTIN_FINGERPRINTS]
    want = [f.name for f in jfp.BUILTIN_FINGERPRINTS]
    assert names == [("gpu" if n == "tpu" else n) for n in want]


@pytest.mark.parametrize("jcls,pcls", [
    pair for pair in PAIRS if pair[1].name not in ("nomad", "gpu")],
    ids=lambda c: c.name)
def test_fingerprint_matches_reference(host, jcls, pcls):
    jcfg = jconfig.ClientConfig(network_speed=100, alloc_dir="/")
    pcfg = ClientConfig(network_speed=100, alloc_dir="/")
    jnode, pnode = js.Node(resources=None), ps.Node(resources=None)
    assert pcls().fingerprint(pcfg, pnode) == jcls().fingerprint(jcfg, jnode)
    assert node_facts(pnode) == node_facts(jnode)
    assert pcls().periodic() == jcls().periodic()


def test_nomad_fingerprint_names_the_port(host):
    node = ps.Node()
    assert pfp.NomadFingerprint().fingerprint(ClientConfig(), node)
    assert node.attributes == {"nomad.version": nomad_tpu.__version__,
                               "nomad.revision": "torch"}
    with pytest.raises(ImportError):
        jfp.NomadFingerprint().fingerprint(jconfig.ClientConfig(),
                                           js.Node())


def test_fingerprint_node_matches_reference(host):
    jnode, pnode = js.Node(resources=None), ps.Node(resources=None)
    japplied = jfp.fingerprint_node(jconfig.ClientConfig(), jnode)
    papplied = fingerprint_node(ClientConfig(), pnode)
    # Neither accelerator fingerprint is enabled; the reference skips its
    # failing nomad fingerprint.
    assert papplied == [n for n in [f.name for f in pfp.BUILTIN_FINGERPRINTS]
                        if n in japplied or n == "nomad"]
    attrs, res = node_facts(pnode)
    want_attrs, want_res = node_facts(jnode)
    assert res == want_res
    assert {k: v for k, v in attrs.items()
            if not k.startswith("nomad.")} == want_attrs


def test_fingerprint_node_runs_the_builtin_list(monkeypatch):
    # It runs BUILTIN_FINGERPRINTS as it stands when called, in order.
    monkeypatch.setattr(pfp, "BUILTIN_FINGERPRINTS",
                        [pfp.HostFingerprint, pfp.ArchFingerprint])
    node = ps.Node(resources=None)
    assert fingerprint_node(ClientConfig(), node) == ["host", "arch"]
    assert "cpu.numcores" not in node.attributes


@pytest.mark.parametrize("options", [{}, {"fingerprint.gpu.enable": "false"},
                                     {"fingerprint.tpu.enable": "true"}])
def test_gpu_fingerprint_disabled(options):
    node = ps.Node()
    assert not pfp.GPUFingerprint().fingerprint(ClientConfig(options=options),
                                                node)
    assert node.attributes == {}


def test_gpu_fingerprint_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    node = ps.Node()
    cfg = ClientConfig(options={"fingerprint.gpu.enable": "true"})
    assert not pfp.GPUFingerprint().fingerprint(cfg, node)
    assert node.attributes == {}
    monkeypatch.setattr(pfp, "BUILTIN_FINGERPRINTS", [pfp.GPUFingerprint])
    assert "gpu" not in fingerprint_node(cfg, ps.Node())


@pytest.fixture
def two_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: CARD)


@pytest.mark.parametrize("flag", ["true", "1", "TRUE"])
def test_gpu_fingerprint_on_two_cards(two_cards, flag):
    node = ps.Node(attributes={"kernel.name": "linux"})
    cfg = ClientConfig(options={"fingerprint.gpu.enable": flag})
    assert pfp.GPUFingerprint().fingerprint(cfg, node)
    assert node.attributes == {"kernel.name": "linux", "gpu.count": "2",
                               "gpu.type": CARD, "driver.gpu": "1"}
    assert is_cuda_platform() and is_cuda_platform("cuda:1")
    assert not is_cuda_platform("cpu")


def test_gpu_fingerprint_cuda_error_propagates(two_cards, monkeypatch):
    def broken(device=None):
        raise RuntimeError("CUDA error: unspecified launch failure")

    monkeypatch.setattr(torch.cuda, "get_device_name", broken)
    cfg = ClientConfig(options={"fingerprint.gpu.enable": "true"})
    with pytest.raises(RuntimeError, match="CUDA error"):
        pfp.GPUFingerprint().fingerprint(cfg, ps.Node())
    # fingerprint_node skips a failing fingerprint, as the reference's does.
    monkeypatch.setattr(pfp, "BUILTIN_FINGERPRINTS",
                        [pfp.ArchFingerprint, pfp.GPUFingerprint])
    assert fingerprint_node(cfg, ps.Node()) == ["arch"]


@pytest.mark.parametrize("value", [None, "1", "true", "yes", "TRUE", "no",
                                   "0", ""])
def test_client_config_options_match_reference(value):
    options = {} if value is None else {"fingerprint.gpu.enable": value}
    jcfg = jconfig.ClientConfig(options=dict(options))
    pcfg = ClientConfig(options=dict(options))
    for default in (False, True):
        assert pcfg.read_bool_option("fingerprint.gpu.enable", default) == \
            jcfg.read_bool_option("fingerprint.gpu.enable", default)
    assert pcfg.read_option("fingerprint.gpu.enable", "d") == \
        jcfg.read_option("fingerprint.gpu.enable", "d")
