"""mTLS configuration for the RPC layer (a copy of
``nomad_tpu/utils/tlsutil.py``; reference helper/tlsutil: region-wrapped
mutual TLS for server-to-server and client-to-server RPC).

``TLSConfig`` carries the CA and the cert/key paths of the agent's tls{}
block; ``server_context``/``client_context`` build ssl contexts that
require the peer to present a certificate signed by the cluster CA
(mutual auth), with hostname verification replaced by CA pinning, the
way the reference verifies ``server.<region>.nomad`` names against the
cluster CA rather than public DNS.
"""

from __future__ import annotations

import ssl
from dataclasses import dataclass
from typing import Optional


@dataclass
class TLSConfig:
    enabled: bool = False
    ca_file: str = ""
    cert_file: str = ""
    key_file: str = ""
    verify_server_hostname: bool = False  # CA pinning by default


def server_context(cfg: TLSConfig) -> Optional[ssl.SSLContext]:
    """TLS context for listeners: present our cert, demand a CA-signed
    peer cert (tlsutil.Config.IncomingTLSConfig with VerifyIncoming)."""
    if not cfg.enabled:
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cfg.cert_file, cfg.key_file)
    ctx.load_verify_locations(cfg.ca_file)
    ctx.verify_mode = ssl.CERT_REQUIRED  # mutual: clients must present
    return ctx


def client_context(cfg: TLSConfig) -> Optional[ssl.SSLContext]:
    """TLS context for dialers: verify the server against the cluster CA
    and present our own cert (tlsutil OutgoingTLSConfig)."""
    if not cfg.enabled:
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_cert_chain(cfg.cert_file, cfg.key_file)
    ctx.load_verify_locations(cfg.ca_file)
    if not cfg.verify_server_hostname:
        # Cluster-CA pinning: any cert signed by our CA is a cluster
        # member; hostnames are dynamic addresses, not DNS identities.
        ctx.check_hostname = False
    return ctx
