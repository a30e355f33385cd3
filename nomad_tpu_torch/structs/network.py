"""Per-node network/port accounting (``nomad_tpu/structs/network.py``;
reference nomad/structs/network.go:43-326, NetworkIndex): available
bandwidth per device, used-port bitmaps per IP, and the dynamic-port pick
that tries a fast stochastic probe before the precise bitmap scan.

The batch scheduler's device pass only counts ports and bandwidth
(``ops/encode.py`` builds its port bitmaps with the constants below); the
concrete port numbers of an offer are picked here, on the host, at
finalize.  Both must agree exactly, so the geometry lives in this one
place.
"""
from __future__ import annotations

import ipaddress
import random
from typing import Dict, List, Optional, Tuple

from .bitmap import Bitmap
from .structs import Allocation, NetworkResource, Node, Port

MIN_DYNAMIC_PORT = 20000
MAX_DYNAMIC_PORT = 60000
MAX_RAND_PORT_ATTEMPTS = 20
MAX_VALID_PORT = 65536


class NetworkIndex:
    """Indexes available and used network resources on one machine."""

    def __init__(self) -> None:
        self.avail_networks: List[NetworkResource] = []
        self.avail_bandwidth: Dict[str, int] = {}
        self.used_ports: Dict[str, Bitmap] = {}
        self.used_bandwidth: Dict[str, int] = {}

    def overcommitted(self) -> bool:
        """Any device's used bandwidth above its capacity (network.go:60)."""
        for device, used in self.used_bandwidth.items():
            if used > self.avail_bandwidth.get(device, 0):
                return True
        return False

    def set_node(self, node: Node) -> bool:
        """Load the node's available networks + reserved usage; returns True
        on a reserved-port collision (network.go:71)."""
        collide = False
        for n in node.resources.networks:
            if n.device:
                self.avail_networks.append(n)
                self.avail_bandwidth[n.device] = n.mbits
        if node.reserved is not None:
            for n in node.reserved.networks:
                if self.add_reserved(n):
                    collide = True
        return collide

    def add_allocs(self, allocs: List[Allocation]) -> bool:
        """Add the first network of each task resource (network.go:93)."""
        collide = False
        for alloc in allocs:
            for task_res in alloc.task_resources.values():
                if not task_res.networks:
                    continue
                if self.add_reserved(task_res.networks[0]):
                    collide = True
        return collide

    def add_reserved(self, n: NetworkResource) -> bool:
        """Mark ports + bandwidth used; True on collision (network.go:111)."""
        used = self.used_ports.get(n.ip)
        if used is None:
            used = Bitmap(MAX_VALID_PORT)
            self.used_ports[n.ip] = used

        collide = False
        for port in list(n.reserved_ports) + list(n.dynamic_ports):
            if port.value < 0 or port.value >= MAX_VALID_PORT:
                return True
            if used.check(port.value):
                collide = True
            else:
                used.set(port.value)

        self.used_bandwidth[n.device] = self.used_bandwidth.get(n.device, 0) + n.mbits
        return collide

    def _yield_ips(self):
        for n in self.avail_networks:
            try:
                net = ipaddress.ip_network(n.cidr, strict=False)
            except ValueError:
                continue
            for ip in net:
                yield n, str(ip)

    def assign_network(
        self, ask: NetworkResource, rng: Optional[random.Random] = None
    ) -> Tuple[Optional[NetworkResource], str]:
        """Build an offer satisfying the ask, or (None, reason)
        (network.go:245 AssignNetwork)."""
        rng = rng or random
        err = "no networks available"
        for n, ip_str in self._yield_ips():
            avail_bw = self.avail_bandwidth.get(n.device, 0)
            used_bw = self.used_bandwidth.get(n.device, 0)
            if used_bw + ask.mbits > avail_bw:
                err = "bandwidth exceeded"
                continue

            used = self.used_ports.get(ip_str)

            reserved_collision = False
            for port in ask.reserved_ports:
                if port.value < 0 or port.value >= MAX_VALID_PORT:
                    err = f"invalid port {port.value} (out of range)"
                    reserved_collision = True
                    break
                if used is not None and used.check(port.value):
                    err = "reserved port collision"
                    reserved_collision = True
                    break
            if reserved_collision:
                continue

            offer = NetworkResource(
                device=n.device,
                ip=ip_str,
                mbits=ask.mbits,
                reserved_ports=[Port(p.label, p.value) for p in ask.reserved_ports],
                dynamic_ports=[Port(p.label, p.value) for p in ask.dynamic_ports],
            )

            dyn_ports, dyn_err = _dynamic_ports_stochastic(used, ask, rng)
            if dyn_err:
                dyn_ports, dyn_err = _dynamic_ports_precise(used, ask, rng)
                if dyn_err:
                    err = dyn_err
                    continue

            for i, port_val in enumerate(dyn_ports):
                offer.dynamic_ports[i].value = port_val
            return offer, ""
        return None, err


def _dynamic_ports_precise(
    used: Optional[Bitmap], ask: NetworkResource, rng
) -> Tuple[List[int], str]:
    """Exact scan of the free-port bitmap (network.go:288)."""
    used_set = used.copy() if used is not None else Bitmap(MAX_VALID_PORT)
    for port in ask.reserved_ports:
        used_set.set(port.value)

    available = used_set.indexes_in_range(False, MIN_DYNAMIC_PORT, MAX_DYNAMIC_PORT)
    num_dyn = len(ask.dynamic_ports)
    if len(available) < num_dyn:
        return [], "dynamic port selection failed"
    # Partial Fisher-Yates over the needed amount.
    n_avail = len(available)
    for i in range(num_dyn):
        j = rng.randrange(n_avail)
        available[i], available[j] = available[j], available[i]
    return available[:num_dyn], ""


def _dynamic_ports_stochastic(
    used: Optional[Bitmap], ask: NetworkResource, rng
) -> Tuple[List[int], str]:
    """Bounded random probing — fast path (network.go:318)."""
    reserved = [p.value for p in ask.reserved_ports]
    dynamic: List[int] = []
    for _ in range(len(ask.dynamic_ports)):
        for attempt in range(MAX_RAND_PORT_ATTEMPTS + 1):
            if attempt == MAX_RAND_PORT_ATTEMPTS:
                return [], "stochastic dynamic port selection failed"
            cand = MIN_DYNAMIC_PORT + rng.randrange(MAX_DYNAMIC_PORT - MIN_DYNAMIC_PORT)
            if used is not None and used.check(cand):
                continue
            if cand in reserved or cand in dynamic:
                continue
            dynamic.append(cand)
            break
    return dynamic, ""
