"""Mutual TLS on the port's RPC layer (``ServerConfig.tls``,
``nomad_tpu_torch/utils/tlsutil.py``; the counterparts of the reference's
``tests/test_tls.py``, reference helper/tlsutil).

A server with ``tls`` set demands a certificate signed by the cluster CA
from every peer and presents its own; a pool dialing with a client
context verifies the server against that CA.  A call over mutual TLS
completes, a plaintext peer and a peer of another CA are refused, and a
three-server cluster elects and replicates with every server-to-server
connection (membership and the raft channel) on mutual TLS.  The
certificates are made per test with the ``openssl`` command line.
"""
import subprocess

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.rpc import ConnPool, RPCError
from nomad_tpu_torch.utils.backoff import wait_until
from nomad_tpu_torch.utils.tlsutil import TLSConfig, client_context

# The slowed election timing of tests/test_torch_raft.py.
SLOW_RAFT = {"raft_heartbeat": 0.2, "raft_election_min": 5.0,
             "raft_election_max": 8.0}
ELECTION_TIMEOUT = 40.0


def make_ca(dir_path, name="nomad-ca"):
    ca_key = dir_path / f"{name}.key"
    ca_crt = dir_path / f"{name}.crt"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(ca_key), "-out", str(ca_crt), "-days", "2",
         "-subj", f"/CN={name}"], check=True, capture_output=True)
    return ca_key, ca_crt


def issue_cert(dir_path, ca_key, ca_crt, cn):
    key = dir_path / f"{cn}.key"
    csr = dir_path / f"{cn}.csr"
    crt = dir_path / f"{cn}.crt"
    subprocess.run(
        ["openssl", "req", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(csr), "-subj", f"/CN={cn}"],
        check=True, capture_output=True)
    subprocess.run(
        ["openssl", "x509", "-req", "-in", str(csr), "-CA", str(ca_crt),
         "-CAkey", str(ca_key), "-CAcreateserial", "-out", str(crt),
         "-days", "2"], check=True, capture_output=True)
    return key, crt


@pytest.fixture()
def pki(tmp_path):
    ca_key, ca_crt = make_ca(tmp_path)
    s_key, s_crt = issue_cert(tmp_path, ca_key, ca_crt, "server.global.nomad")
    c_key, c_crt = issue_cert(tmp_path, ca_key, ca_crt, "client.global.nomad")
    return {"ca": ca_crt, "server": (s_crt, s_key), "client": (c_crt, c_key)}


def tls_of(ca, crt, key):
    return TLSConfig(enabled=True, ca_file=str(ca), cert_file=str(crt),
                     key_file=str(key))


def tls_server(pki, **kw):
    crt, key = pki["server"]
    srv = Server(ServerConfig(device="cpu", enable_rpc=True,
                              num_schedulers=0, min_heartbeat_ttl=3600.0,
                              tls=tls_of(pki["ca"], crt, key), **kw))
    srv.start()
    return srv


def shutdown(srv):
    srv.shutdown()
    assert wait_until(lambda: not srv.threads(), 15.0), srv.threads()


def make_job():
    job = mock.job()
    for t in job.task_groups[0].tasks:
        t.resources.networks = []
    return job


def test_rpc_over_mtls(pki):
    srv = tls_server(pki)
    try:
        crt, key = pki["client"]
        pool = ConnPool(tls_context=client_context(
            tls_of(pki["ca"], crt, key)))
        job = make_job()
        reply = pool.call(srv.config.rpc_advertise, "Job.Register",
                          {"Job": job})
        assert reply["Index"] > 0 and reply["EvalID"]
        assert srv.state.job_by_id(None, job.id) is not None
        pool.close()
    finally:
        shutdown(srv)


def test_plaintext_client_rejected(pki):
    srv = tls_server(pki)
    try:
        pool = ConnPool()
        with pytest.raises(RPCError):
            pool.call(srv.config.rpc_advertise, "Status.Ping", {},
                      timeout=3.0)
        pool.close()
    finally:
        shutdown(srv)


def test_wrong_ca_client_rejected(pki, tmp_path):
    srv = tls_server(pki)
    try:
        rogue_dir = tmp_path / "rogue"
        rogue_dir.mkdir()
        r_ca_key, r_ca_crt = make_ca(rogue_dir, "rogue-ca")
        r_key, r_crt = issue_cert(rogue_dir, r_ca_key, r_ca_crt, "intruder")
        pool = ConnPool(tls_context=client_context(
            tls_of(r_ca_crt, r_crt, r_key)))
        with pytest.raises(RPCError):
            pool.call(srv.config.rpc_advertise, "Status.Ping", {},
                      timeout=3.0)
        pool.close()
    finally:
        shutdown(srv)


def test_mtls_cluster_replicates(pki, tmp_path):
    crt, key = pki["server"]
    tls = tls_of(pki["ca"], crt, key)
    servers, first = [], None
    for i in range(3):
        srv = Server(ServerConfig(
            device="cpu", node_name=f"tls-{i}", enable_rpc=True, tls=tls,
            data_dir=str(tmp_path / f"s{i}"), bootstrap_expect=3,
            start_join=[first] if first else [], num_schedulers=0,
            min_heartbeat_ttl=3600.0, **SLOW_RAFT))
        if first is None:
            first = srv.config.rpc_advertise
        servers.append(srv)
    for srv in servers:
        srv.start()
    try:
        assert wait_until(lambda: any(srv.is_leader() for srv in servers),
                          ELECTION_TIMEOUT, max_interval=0.05), \
            "no leader over mutual TLS"
        assert all(srv.pool.tls_context is not None
                   and srv.rpc.tls_context is not None for srv in servers)
        job = make_job()
        leader = next(srv for srv in servers if srv.is_leader())
        follower = next(srv for srv in servers if not srv.is_leader())
        # A follower learns the leader from its first AppendEntries; until
        # then a forward has nowhere to go and raises NotLeaderError, as
        # the reference's does (a race under load, not a TLS fault).
        assert wait_until(
            lambda: follower.leader_address() == leader.config.rpc_advertise,
            ELECTION_TIMEOUT, max_interval=0.05), \
            "the follower never learned the leader over mutual TLS"
        follower.job_register(job)      # forwarded to the leader
        assert wait_until(lambda: all(
            srv.state.job_by_id(None, job.id) is not None
            for srv in servers), 20.0), "replication over mutual TLS failed"
    finally:
        for srv in servers:
            shutdown(srv)
