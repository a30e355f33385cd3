"""Node fingerprinting: detect host facts and publish them as node
attributes and resources before registration (a copy of
``nomad_tpu/client/fingerprint.py``; reference
client/fingerprint/fingerprint.go:28-100 and the per-fact files).

Registry order matters like the reference's ``BuiltinFingerprints``
ordered list: later fingerprints may read attributes set by earlier ones.
Each fingerprint returns whether it applied; periodic ones re-run on an
interval (fingerprint.go:67-100).

The accelerator fingerprint is ``gpu`` (the reference's ``tpu``): behind
the client option ``fingerprint.gpu.enable`` it publishes the card's
facts from ``torch.cuda`` -- ``gpu.count``, ``gpu.type`` and
``driver.gpu`` -- which a job constrains on (``${attr.gpu.type}``).  It
does not apply on a host without CUDA.
"""
from __future__ import annotations

import multiprocessing
import os
import platform
import shutil
import socket
from typing import Callable, List, Tuple

import torch

from .. import __version__
from ..structs import structs as s
from ..utils.platform import is_cuda_platform


class Fingerprint:
    name = ""

    def fingerprint(self, config, node: s.Node) -> bool:
        raise NotImplementedError

    def periodic(self) -> Tuple[bool, float]:
        return (False, 0.0)


class ArchFingerprint(Fingerprint):
    """(fingerprint/arch.go)."""

    name = "arch"

    def fingerprint(self, config, node: s.Node) -> bool:
        node.attributes["cpu.arch"] = platform.machine()
        return True


class CPUFingerprint(Fingerprint):
    """(fingerprint/cpu.go) — core count + total MHz → node resources."""

    name = "cpu"

    def fingerprint(self, config, node: s.Node) -> bool:
        cores = multiprocessing.cpu_count()
        mhz = self._clock_mhz()
        node.attributes["cpu.numcores"] = str(cores)
        node.attributes["cpu.frequency"] = f"{mhz:.0f}"
        total = int(cores * mhz)
        node.attributes["cpu.totalcompute"] = str(total)
        if node.resources is None:
            node.resources = s.Resources()
        if node.resources.cpu == 0:
            node.resources.cpu = total
        return True

    @staticmethod
    def _clock_mhz() -> float:
        try:
            with open("/proc/cpuinfo") as f:
                for line in f:
                    if line.lower().startswith("cpu mhz"):
                        return float(line.split(":")[1])
        except (OSError, ValueError, IndexError):
            pass
        return 1000.0


class MemoryFingerprint(Fingerprint):
    """(fingerprint/memory.go)."""

    name = "memory"

    def fingerprint(self, config, node: s.Node) -> bool:
        total_mb = self._total_mb()
        if total_mb <= 0:
            return False
        node.attributes["memory.totalbytes"] = str(total_mb * 1024 * 1024)
        if node.resources is None:
            node.resources = s.Resources()
        if node.resources.memory_mb == 0:
            node.resources.memory_mb = total_mb
        return True

    @staticmethod
    def _total_mb() -> int:
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemTotal:"):
                        return int(line.split()[1]) // 1024
        except (OSError, ValueError, IndexError):
            pass
        try:
            return (os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")) // (1 << 20)
        except (ValueError, OSError):
            return 0


class HostFingerprint(Fingerprint):
    """(fingerprint/host.go) — os/kernel/hostname."""

    name = "host"

    def fingerprint(self, config, node: s.Node) -> bool:
        node.attributes["kernel.name"] = platform.system().lower()
        node.attributes["kernel.version"] = platform.release()
        node.attributes["os.name"] = platform.system().lower()
        node.attributes["os.version"] = platform.version()
        node.attributes["unique.hostname"] = socket.gethostname()
        return True


class NetworkFingerprint(Fingerprint):
    """(fingerprint/network.go) — primary IP + link speed → network
    resource."""

    name = "network"

    def fingerprint(self, config, node: s.Node) -> bool:
        ip = self._default_ip(getattr(config, "network_interface", "") or "")
        if not ip:
            return False
        node.attributes["unique.network.ip-address"] = ip
        if node.resources is None:
            node.resources = s.Resources()
        speed = getattr(config, "network_speed", 0) or 1000
        if not node.resources.networks:
            node.resources.networks = [
                s.NetworkResource(device="eth0", cidr=f"{ip}/32", ip=ip,
                                  mbits=speed)]
        return True

    @staticmethod
    def _default_ip(interface: str) -> str:
        """The IPv4 address of the default route's interface (or of
        ``interface``), read from the routing table and the interface
        (SIOCGIFADDR): the address the reference's UDP ``connect`` toward
        8.8.8.8 reads back, with no socket aimed off the machine.
        127.0.0.1 without a default route."""
        import fcntl
        import struct

        try:
            if not interface:
                with open("/proc/net/route") as fh:
                    routes = [line.split() for line in fh.readlines()[1:]]
                default = sorted((int(r[6]), r[0]) for r in routes
                                 if r[1] == "00000000" and r[7] == "00000000"
                                 and int(r[3], 16) & 0x1)   # RTF_UP
                if not default:
                    return "127.0.0.1"
                interface = default[0][1]
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sk:
                packed = fcntl.ioctl(sk.fileno(), 0x8915,  # SIOCGIFADDR
                                     struct.pack("256s",
                                                 interface.encode()[:15]))
            return socket.inet_ntoa(packed[20:24])
        except (OSError, ValueError, IndexError):
            return "127.0.0.1"


class StorageFingerprint(Fingerprint):
    """(fingerprint/storage.go) — free disk on the alloc volume."""

    name = "storage"

    def fingerprint(self, config, node: s.Node) -> bool:
        path = getattr(config, "alloc_dir", "") or "/"
        try:
            usage = shutil.disk_usage(path if os.path.exists(path) else "/")
        except OSError:
            return False
        mb = usage.free // (1 << 20)
        node.attributes["unique.storage.volume"] = path
        node.attributes["unique.storage.bytesfree"] = str(usage.free)
        node.attributes["unique.storage.bytestotal"] = str(usage.total)
        if node.resources is None:
            node.resources = s.Resources()
        if node.resources.disk_mb == 0:
            node.resources.disk_mb = int(mb)
        return True


class NomadFingerprint(Fingerprint):
    """(fingerprint/nomad.go) — agent version attrs."""

    name = "nomad"

    def fingerprint(self, config, node: s.Node) -> bool:
        node.attributes["nomad.version"] = __version__
        node.attributes["nomad.revision"] = "torch"
        return True


class SignalFingerprint(Fingerprint):
    """(fingerprint/signal.go) — signals the drivers can deliver."""

    name = "signal"

    def fingerprint(self, config, node: s.Node) -> bool:
        node.attributes["os.signals"] = (
            "SIGABRT,SIGALRM,SIGBUS,SIGCHLD,SIGCONT,SIGFPE,SIGHUP,SIGILL,"
            "SIGINT,SIGIO,SIGKILL,SIGPIPE,SIGPROF,SIGQUIT,SIGSEGV,SIGSTOP,"
            "SIGSYS,SIGTERM,SIGTRAP,SIGTSTP,SIGTTIN,SIGTTOU,SIGURG,SIGUSR1,"
            "SIGUSR2,SIGWINCH,SIGXCPU,SIGXFSZ")
        return True


class GPUFingerprint(Fingerprint):
    """Publish the card as node attributes so jobs can constrain on
    ``${attr.gpu.type}`` (the reference's ``TPUFingerprint``), behind the
    client option ``fingerprint.gpu.enable``.  A CUDA error on a host
    with a card propagates."""

    name = "gpu"

    def fingerprint(self, config, node: s.Node) -> bool:
        options = getattr(config, "options", {}) or {}
        if str(options.get("fingerprint.gpu.enable", "")).lower() not in ("1", "true"):
            return False
        if not is_cuda_platform():
            return False   # the host has no GPU
        node.attributes["gpu.count"] = str(torch.cuda.device_count())
        node.attributes["gpu.type"] = torch.cuda.get_device_name(0)
        node.attributes["driver.gpu"] = "1"
        return True


class EnvAWSFingerprint(Fingerprint):
    """(fingerprint/env_aws.go) — instance metadata; zero-egress here, so
    it applies only when the metadata answers instantly (it won't off
    EC2), exactly like the reference's 2s-timeout probe."""

    name = "env_aws"

    def fingerprint(self, config, node: s.Node) -> bool:
        try:
            sk = socket.create_connection(("169.254.169.254", 80), timeout=0.2)
            sk.close()
        except OSError:
            return False
        # GCE answers the same address: its replies carry
        # Metadata-Flavor: Google — that is NOT an EC2 metadata service.
        import urllib.request
        try:
            with urllib.request.urlopen("http://169.254.169.254/",
                                        timeout=0.2) as resp:
                if resp.headers.get("Metadata-Flavor") == "Google":
                    return False
        except OSError:
            pass  # EC2 IMDSv2 may refuse the bare request; still AWS-ish
        node.attributes["platform.aws.probed"] = "1"
        return True


class EnvGCEFingerprint(Fingerprint):
    """(fingerprint/env_gce.go) — GCE metadata; same zero-egress fast
    probe as env_aws (metadata.google.internal answers instantly on GCE,
    refuses instantly elsewhere)."""

    name = "env_gce"

    def fingerprint(self, config, node: s.Node) -> bool:
        try:
            sk = socket.create_connection(("169.254.169.254", 80),
                                          timeout=0.2)
            sk.close()
        except OSError:
            return False
        # Distinguish from AWS by the Metadata-Flavor header probe.
        import urllib.request
        try:
            req = urllib.request.Request(
                "http://169.254.169.254/computeMetadata/v1/",
                headers={"Metadata-Flavor": "Google"})
            with urllib.request.urlopen(req, timeout=0.2) as resp:
                if resp.headers.get("Metadata-Flavor") != "Google":
                    return False
        except OSError:
            return False
        node.attributes["platform.gce.probed"] = "1"
        return True


BUILTIN_FINGERPRINTS: List[Callable[[], Fingerprint]] = [
    ArchFingerprint,
    CPUFingerprint,
    MemoryFingerprint,
    HostFingerprint,
    NetworkFingerprint,
    NomadFingerprint,
    SignalFingerprint,
    StorageFingerprint,
    GPUFingerprint,
    EnvAWSFingerprint,
    EnvGCEFingerprint,
]


def fingerprint_node(config, node: s.Node) -> List[str]:
    """Run every builtin fingerprint; returns names that applied
    (reference: client.go:902 fingerprint())."""
    applied = []
    for factory in BUILTIN_FINGERPRINTS:
        fp = factory()
        try:
            if fp.fingerprint(config, node):
                applied.append(fp.name)
        except Exception:
            continue
    return applied
