"""The port's vault integration (``nomad_tpu_torch/server/vault.py``,
``client/vaultclient.py`` and their wiring in the server, the client,
the agent and the jobspec) against the JAX package's, case for case
with ``tests/test_vault.py``.

- ``FakeVault``, ``ServerVaultClient`` (derive, wrap, self-token renewal
  on a fake clock, the revocation retry queue) and ``ClientVaultClient``
  (the renewal heap, the unwrap's 0-TTL fallback) run the same steps in
  both packages; their outcomes are compared.
- End to end, in each package: a server with ``FakeVault`` and a client
  on the mock driver.  A task's vault ask derives a token, its accessor
  registers through the log, the token lands in ``secrets/vault_token``
  with the task's policies, and stopping the job revokes the accessor
  and drops its row; a stale accessor is revoked at a leader's restore
  and after a failover of a three-server cluster; a node going down
  revokes its allocs' accessors.  The reference's servers run the batch
  worker with a ``KernelCircuitBreaker`` of their own, and
  ``breaker.oracle_routed`` stays 0 in both worlds.
- ``HTTPVault`` of both packages against one fake vault HTTP server on
  the loopback: the same requests, the same answers (no vault server,
  no network).
- ``Node.DeriveVaultToken`` over the wire, and the agent's ``vault {}``
  block.

The fingerprints' probes stay on this machine: connections off the
loopback are refused, and the network fingerprint's address is fixed,
in both packages.  Every wait has a deadline.
"""
import contextlib
import dataclasses
import http.server
import json
import os
import random
import socket
import threading
import time

import jax  # noqa: F401  (the reference computes on the CPU backend)
import pytest

import nomad_tpu.ops.breaker as jbreaker
from nomad_tpu import mock as jmock
from nomad_tpu.client import Client as JClient
from nomad_tpu.client import ClientConfig as JClientConfig
from nomad_tpu.client import fingerprint as jfp
from nomad_tpu.client.vaultclient import ClientVaultClient as JCVC
from nomad_tpu.server import Server as JServer
from nomad_tpu.server import ServerConfig as JServerConfig
from nomad_tpu.server import vault as jvault
from nomad_tpu.server.fsm import MessageType as JMessageType
from nomad_tpu.state.state_store import VaultAccessor as JVaultAccessor
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert
from nomad_tpu_torch.client import Client as PClient
from nomad_tpu_torch.client import ClientConfig as PClientConfig
from nomad_tpu_torch.client import fingerprint as pfp
from nomad_tpu_torch.client.vaultclient import ClientVaultClient as PCVC
from nomad_tpu_torch.ops.breaker import KernelCircuitBreaker
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server import vault as pvault
from nomad_tpu_torch.server.fsm import MessageType as PMessageType
from nomad_tpu_torch.state.state_store import VaultAccessor as PVaultAccessor
from nomad_tpu_torch.utils.backoff import wait_until

DEADLINE = 30.0
HEARTBEAT_TTL = 3600.0
KINDS = ("ref", "port")


def vault_mod(kind):
    return jvault if kind == "ref" else pvault


@pytest.fixture(autouse=True)
def stay_local(monkeypatch):
    """No fingerprint probe leaves the loopback, in either package."""
    real = socket.create_connection

    def connect(address, *args, **kwargs):
        if address[0] not in ("127.0.0.1", "localhost"):
            raise OSError("no network in this test")
        return real(address, *args, **kwargs)

    monkeypatch.setattr(socket, "create_connection", connect)
    for mod in (jfp, pfp):
        monkeypatch.setattr(mod.NetworkFingerprint, "_default_ip",
                            staticmethod(lambda interface: "10.1.2.3"))


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def vault_alloc(kind, policies=("p1", "p2")):
    """The reference's mock alloc whose first task asks for vault, in
    ``kind``'s structs."""
    job = jmock.job()
    job.task_groups[0].tasks[0].vault = js.Vault(policies=list(policies))
    alloc = jmock.alloc()
    alloc.job = job
    alloc.job_id = job.id
    alloc.task_group = job.task_groups[0].name
    if kind == "ref":
        return alloc
    return convert.alloc_from_dict(dataclasses.asdict(alloc))


def plain_alloc(kind):
    alloc = jmock.alloc()
    alloc.job = jmock.job()
    alloc.task_group = alloc.job.task_groups[0].name
    if kind == "ref":
        return alloc
    return convert.alloc_from_dict(dataclasses.asdict(alloc))


def outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return type(e).__name__, str(e)


# -- FakeVault (TestFakeVault) ----------------------------------------------

def token_lifecycle(kind):
    fv = vault_mod(kind).FakeVault()
    out = fv.create_token(["read-db"], 60.0, {"AllocationID": "a1"})
    steps = [out["token"][:2], out["accessor"][:2],
             fv.lookup_token(out["token"])["policies"],
             fv.renew_token(out["token"], 120.0)]
    fv.revoke_accessor(out["accessor"])
    steps += [fv.is_revoked(out["accessor"]),
              outcome(lambda: fv.lookup_token(out["token"]))]
    return steps


def test_token_lifecycle_equals_the_reference():
    ref, port = token_lifecycle("ref"), token_lifecycle("port")
    assert port == ref
    assert port[:2] == ["s.", "a."] and port[-1][0] == "VaultError"


# -- ServerVaultClient (TestServerVaultClient) ------------------------------

def derive_per_task(kind):
    mod = vault_mod(kind)
    fv = mod.FakeVault()
    vc = mod.ServerVaultClient(mod.VaultConfig(enabled=True), api=fv)
    alloc = vault_alloc(kind)
    out = vc.derive_token(alloc, ["web"])
    rec = fv.lookup_token(out["web"]["token"])
    return (sorted(out), out["web"]["ttl"], rec["policies"],
            rec["metadata"]["AllocationID"] == alloc.id,
            rec["metadata"]["Task"], rec["metadata"]["NodeID"])


def test_derive_tokens_per_task_equals_the_reference():
    assert derive_per_task("port") == derive_per_task("ref")
    assert derive_per_task("port")[2] == ["p1", "p2"]


@pytest.mark.parametrize("case", ["no_vault_block", "disabled"])
def test_derive_refusals_equal_the_reference(case):
    def run(kind):
        mod = vault_mod(kind)
        if case == "disabled":
            vc = mod.ServerVaultClient(mod.VaultConfig(enabled=False))
            return outcome(lambda: vc.derive_token(vault_alloc(kind),
                                                   ["web"]))
        vc = mod.ServerVaultClient(mod.VaultConfig(enabled=True),
                                   api=mod.FakeVault())
        return outcome(lambda: vc.derive_token(plain_alloc(kind), ["web"]))

    ref, port = run("ref"), run("port")
    assert port == ref and port[0] == "VaultError"


# -- the client's renewal heap (TestRenewalHeap) ----------------------------

def cvc(kind):
    return JCVC if kind == "ref" else PCVC


@pytest.mark.parametrize("kind", KINDS)
def test_tokens_renewed_at_half_ttl(kind):
    fv = vault_mod(kind).FakeVault()
    out = fv.create_token(["p"], 0.4, {})
    c = cvc(kind)(derive_fn=None, renew_fn=fv.renew_token)
    c.start()
    try:
        c.renew_token(out["token"], 0.4)
        assert wait_until(lambda: fv.renew_calls >= 2, 5.0)
    finally:
        c.stop()


def zero_ttl(kind):
    fv = vault_mod(kind).FakeVault()
    out = fv.create_token(["p"], 60.0, {})
    c = cvc(kind)(derive_fn=None, renew_fn=fv.renew_token)
    c.start()
    try:
        c.renew_token(out["token"], 0.0)
        c.renew_token(out["token"], -1.0)
        tracked = c.num_tracked()
        time.sleep(0.3)
        return tracked, fv.renew_calls
    finally:
        c.stop()


def test_zero_ttl_never_enters_heap_like_the_reference():
    assert zero_ttl("port") == zero_ttl("ref") == (0, 0)


def unwrap_fallback(kind):
    fv = vault_mod(kind).FakeVault()

    def derive_fn(alloc_id, tasks):
        return {"web": fv.create_token(["p"], 42.0, {}, wrap_ttl=60.0)}

    def unwrap_no_lease(wrapping_token):
        secret = fv.unwrap(wrapping_token)
        return {"token": secret["token"], "accessor": secret["accessor"],
                "ttl": 0.0}

    c = cvc(kind)(derive_fn=derive_fn, renew_fn=None,
                  unwrap_fn=unwrap_no_lease)
    out = c.derive_token("a1", ["web"])
    no_unwrap = cvc(kind)(derive_fn=derive_fn, renew_fn=None)
    return out["web"]["ttl"], outcome(lambda: no_unwrap.derive_token(
        "a1", ["web"]))


def test_unwrap_without_lease_falls_back_to_envelope_ttl():
    assert unwrap_fallback("port") == unwrap_fallback("ref")
    assert unwrap_fallback("port")[0] == 42.0


@pytest.mark.parametrize("kind", KINDS)
def test_stop_renew_stops(kind):
    fv = vault_mod(kind).FakeVault()
    out = fv.create_token(["p"], 0.2, {})
    c = cvc(kind)(derive_fn=None, renew_fn=fv.renew_token)
    c.start()
    try:
        c.renew_token(out["token"], 0.2)
        assert wait_until(lambda: fv.renew_calls >= 1, 5.0)
        c.stop_renew_token(out["token"])
        count = fv.renew_calls
        time.sleep(0.5)
        assert fv.renew_calls <= count + 1  # at most one in flight
        assert c.num_tracked() == 0
    finally:
        c.stop()


# -- the server's own token (TestSelfTokenRenewal) --------------------------

def self_renewal(kind, ttl):
    mod = vault_mod(kind)
    clock = FakeClock()
    fv = mod.FakeVault(clock=clock)
    rec = fv.create_token(["root"], ttl, {})
    vc = mod.ServerVaultClient(
        mod.VaultConfig(enabled=True, token=rec["token"]), api=fv,
        clock=clock, rand=lambda: 0.5)
    vc.creation_ttl = ttl
    vc.last_renewed = clock()
    return clock, fv, vc


def renew_schedule(kind):
    clock, fv, vc = self_renewal(kind, 60.0)
    delays = [vc.renewal_tick()]
    for _ in range(5):
        clock.advance(delays[-1])
        assert vc.last_renewed + vc.creation_ttl - clock() > 0
        delays.append(vc.renewal_tick())
    return delays, fv.renew_calls


def test_renew_scheduled_at_half_time_to_expiry():
    assert renew_schedule("port") == renew_schedule("ref")
    assert renew_schedule("port")[0] == [pytest.approx(30.0)] * 6


def backoff_schedule(kind):
    clock, fv, vc = self_renewal(kind, 200.0)
    fv.revoke_accessor(fv.tokens[vc.config.token]["accessor"])
    delays = []
    for _ in range(6):
        delays.append(vc.renewal_tick())
        clock.advance(min(delays[-1], 5.0))
    return delays


def test_error_backoff_ordering_and_cap():
    port = backoff_schedule("port")
    assert port == backoff_schedule("ref")
    assert port[0] == pytest.approx(7.5)
    assert port[1] == pytest.approx(7.5 * 1.25)


def gives_up(kind):
    clock, fv, vc = self_renewal(kind, 10.0)
    fv.revoke_accessor(fv.tokens[vc.config.token]["accessor"])
    clock.advance(11.0)
    return vc.renewal_tick(), bool(vc.connection_lost)


def test_gives_up_past_expiration():
    assert gives_up("port") == gives_up("ref") == (None, True)


# -- wrapped tokens (TestWrappedTokens) -------------------------------------

def wrapped_derive(kind):
    mod = vault_mod(kind)
    clock = FakeClock()
    fv = mod.FakeVault(clock=clock)
    vc = mod.ServerVaultClient(mod.VaultConfig(enabled=True), api=fv,
                               clock=clock)
    info = vc.derive_token(vault_alloc(kind, ("p1",)), ["web"],
                           wrapped=True)["web"]
    secret = fv.unwrap(info["wrapped_token"])
    return (sorted(info), info["wrapped_token"][:2], info["accessor"][:2],
            info["accessor"] == secret["accessor"],
            fv.lookup_token(secret["token"])["policies"],
            outcome(lambda: fv.unwrap(info["wrapped_token"])))


def test_wrapped_derive_and_single_use_unwrap():
    port = wrapped_derive("port")
    assert port == wrapped_derive("ref")
    assert "token" not in port[0] and port[-1][0] == "VaultError"


def wrapper_expiry(kind):
    clock = FakeClock()
    fv = vault_mod(kind).FakeVault(clock=clock)
    out = fv.create_token(["p"], 60.0, {}, wrap_ttl=120.0)
    clock.advance(121.0)
    return outcome(lambda: fv.unwrap(out["wrapped_token"]))


def test_wrapper_expires():
    assert wrapper_expiry("port") == wrapper_expiry("ref")
    assert wrapper_expiry("port")[0] == "VaultError"


def private_breaker(monkeypatch):
    """The reference's process-wide breaker, replaced by a fresh one
    (ROADMAP queue 3 item 7)."""
    brk = jbreaker.KernelCircuitBreaker()
    monkeypatch.setattr(jbreaker, "BREAKER", brk)
    return brk


def make_server(kind, fv, monkeypatch, **fields):
    mod = vault_mod(kind)
    wrap = fields.pop("wrap_derived_tokens", True)
    vcfg = mod.VaultConfig(enabled=True, wrap_derived_tokens=wrap)
    if kind == "ref":
        private_breaker(monkeypatch)
        return JServer(JServerConfig(use_tpu_batch_worker=True,
                                     min_heartbeat_ttl=HEARTBEAT_TTL,
                                     vault=vcfg, **fields), vault_api=fv)
    return Server(ServerConfig(device="cpu", rng_seed=7,
                               min_heartbeat_ttl=HEARTBEAT_TTL,
                               breaker=KernelCircuitBreaker(), vault=vcfg,
                               **fields), vault_api=fv)


def oracle_routed(srv):
    return srv.metrics.sink.latest()["CounterTotals"].get(
        "nomad.breaker.oracle_routed", 0)


def wrap_flag(kind, monkeypatch):
    fv = vault_mod(kind).FakeVault()
    out = []
    for flag in (False, True):
        srv = make_server(kind, fv, monkeypatch, num_schedulers=0,
                          wrap_derived_tokens=flag)
        srv.start()
        try:
            assert wait_until(srv.is_leader, DEADLINE)
            alloc = vault_alloc(kind, ("p1",))
            srv.state.upsert_job(srv.raft.applied_index() + 1, alloc.job)
            srv.state.upsert_allocs(srv.raft.applied_index() + 2, [alloc])
            info = srv.derive_vault_token(alloc.id, ["web"])["web"]
            assert wait_until(lambda: len(srv.state.vault_accessors_by_alloc(
                None, alloc.id)) == 1, DEADLINE)
            acc = srv.state.vault_accessors_by_alloc(None, alloc.id)[0]
            out.append((flag, "token" in info, "wrapped_token" in info,
                         acc.task, acc.accessor == info["accessor"]))
        finally:
            srv.shutdown()
    return out


def test_wrap_derived_tokens_flag_disables_wrapping(monkeypatch):
    port = wrap_flag("port", monkeypatch)
    assert port == wrap_flag("ref", monkeypatch)
    assert port == [(False, True, False, "web", True),
                    (True, False, True, "web", True)]


# -- the revocation retry queue (TestRevocationRetry) -----------------------

def retry_until_success(kind):
    mod = vault_mod(kind)
    clock = FakeClock()
    fv = mod.FakeVault(clock=clock)
    rec = fv.create_token(["p"], 60.0, {})
    vc = mod.ServerVaultClient(mod.VaultConfig(enabled=True), api=fv,
                               clock=clock)
    fv.fail_revokes = 1
    steps = [vc.revoke_accessors([rec["accessor"]])]
    vc.store_for_revocation([rec["accessor"]], ttl=60.0)
    steps.append(vc.num_revoking())
    fv.fail_revokes = 1
    steps += [vc.tick_revocations(), vc.num_revoking()]
    steps.append(vc.tick_revocations() == [rec["accessor"]])
    steps += [fv.is_revoked(rec["accessor"]), vc.num_revoking()]
    return steps


def test_retry_until_success():
    assert retry_until_success("port") == retry_until_success("ref") == [
        [], 1, [], 1, True, True, 0]


def queue_drop(kind):
    mod = vault_mod(kind)
    clock = FakeClock()
    fv = mod.FakeVault(clock=clock)
    vc = mod.ServerVaultClient(mod.VaultConfig(enabled=True), api=fv,
                               clock=clock)
    vc.store_for_revocation(["a.dead"], ttl=30.0)
    clock.advance(31.0)
    return vc.tick_revocations(), vc.num_revoking(), fv.is_revoked("a.dead")


def test_queue_drops_past_token_ttl():
    assert queue_drop("port") == queue_drop("ref") == ([], 0, False)


def deactivation(kind):
    mod = vault_mod(kind)
    vc = mod.ServerVaultClient(mod.VaultConfig(enabled=True),
                               api=mod.FakeVault())
    vc.store_for_revocation(["a.x"], ttl=60.0)
    vc.set_active(False)
    return vc.num_revoking(), vc.tick_revocations()


def test_deactivation_clears_queue():
    assert deactivation("port") == deactivation("ref") == (0, [])


# -- end to end (TestVaultEndToEnd, TestVaultFailureModes) -------------------

def vault_job(kind):
    job = jmock.job()
    tg = job.task_groups[0]
    tg.count = 1
    tg.restart_policy = js.RestartPolicy(attempts=0, mode="fail")
    for t in tg.tasks:
        t.driver = "mock_driver"
        t.config = {"run_for": "60s"}
        t.resources.networks = []
        t.services = []
        t.vault = js.Vault(policies=["task-policy"])
    if kind == "ref":
        return job
    return convert.job_from_dict(dataclasses.asdict(job))


@contextlib.contextmanager
def vault_world(kind, tmp_path, monkeypatch):
    """A server with ``FakeVault`` and one client on the mock driver,
    its node ready."""
    fv = vault_mod(kind).FakeVault()
    srv = make_server(kind, fv, monkeypatch, num_schedulers=1)
    srv.start()
    root = tmp_path / kind
    if kind == "ref":
        client = JClient(JClientConfig(alloc_dir=str(root / "allocs"),
                                       state_dir=str(root / "state")),
                         rpc=srv, vault_api=fv)
    else:
        client = PClient(PClientConfig(alloc_dir=str(root / "allocs"),
                                       state_dir=str(root / "state"),
                                       node_id="vault-node"),
                         rpc=srv, vault_api=fv, rng=random.Random(7),
                         heartbeat_stagger=0.1)
    client.start()
    try:
        node_id = client.node.id
        assert wait_until(lambda: srv.node_get(node_id) is not None,
                          DEADLINE)
        # The reference's first heartbeat waits half the TTL.
        srv.node_update_status(node_id, "ready")
        yield srv, client, fv
    finally:
        client.shutdown()
        srv.shutdown()
    if kind == "port":
        assert wait_until(lambda: not srv.threads() and not client.threads(),
                          DEADLINE)


def running_vault_alloc(kind, srv, client):
    job = vault_job(kind)
    srv.job_register(job)
    assert wait_until(lambda: any(
        a.client_status == "running" for a in srv.job_allocations(job.id)),
        DEADLINE)
    alloc = srv.job_allocations(job.id)[0]
    assert wait_until(lambda: len(srv.state.vault_accessors_by_alloc(
        None, alloc.id)) == 1, DEADLINE)
    return job, alloc, srv.state.vault_accessors_by_alloc(None, alloc.id)[0]


def derived_and_revoked(kind, tmp_path, monkeypatch):
    with vault_world(kind, tmp_path, monkeypatch) as (srv, client, fv):
        job, alloc, acc = running_vault_alloc(kind, srv, client)
        runner = client.get_alloc_runner(alloc.id)
        path = os.path.join(runner.alloc_dir.task_dirs["web"].secrets_dir,
                            "vault_token")
        assert wait_until(lambda: os.path.exists(path), DEADLINE)
        with open(path) as fh:
            token = fh.read()
        live = fv.lookup_token(token)
        srv.job_deregister(job.id, purge=False)
        assert wait_until(lambda: fv.is_revoked(acc.accessor), DEADLINE)
        assert wait_until(lambda: not srv.state.vault_accessors_by_alloc(
            None, alloc.id), DEADLINE)
        return {"task": acc.task,
                "node_is_client": acc.node_id == client.node.id,
                "policies": live["policies"],
                "alloc_matches": live["metadata"]["AllocationID"] == alloc.id,
                "revoked": fv.is_revoked(acc.accessor),
                "token_dead": outcome(lambda: fv.lookup_token(token))[0],
                "oracle_routed": oracle_routed(srv)}


def test_token_derived_and_revoked_on_stop(tmp_path, monkeypatch):
    ref = derived_and_revoked("ref", tmp_path, monkeypatch)
    port = derived_and_revoked("port", tmp_path, monkeypatch)
    assert port == ref
    assert port == {"task": "web", "node_is_client": True,
                    "policies": ["task-policy"], "alloc_matches": True,
                    "revoked": True, "token_dead": "VaultError",
                    "oracle_routed": 0}


def stale_at_restore(kind, tmp_path, monkeypatch):
    mtype = JMessageType if kind == "ref" else PMessageType
    accessor_cls = JVaultAccessor if kind == "ref" else PVaultAccessor
    with vault_world(kind, tmp_path, monkeypatch) as (srv, client, fv):
        out = fv.create_token(["p"], 60.0, {})
        srv.raft.apply(mtype.VAULT_ACCESSOR_REGISTER, {"accessors": [
            accessor_cls(accessor=out["accessor"], alloc_id="gone",
                         node_id="gone-node", task="t")]})
        srv._restore_revoking_accessors()
        assert wait_until(lambda: fv.is_revoked(out["accessor"]), DEADLINE)
        assert wait_until(lambda: not srv.state.vault_accessors(None),
                          DEADLINE)
        return fv.is_revoked(out["accessor"]), srv.state.vault_accessors(None)


def test_leader_restore_revokes_stale_accessors(tmp_path, monkeypatch):
    assert stale_at_restore("port", tmp_path, monkeypatch) == \
        stale_at_restore("ref", tmp_path, monkeypatch) == (True, [])


def node_down(kind, tmp_path, monkeypatch):
    with vault_world(kind, tmp_path, monkeypatch) as (srv, client, fv):
        _, alloc, acc = running_vault_alloc(kind, srv, client)
        node_id = client.node.id
        client.shutdown()
        srv.node_update_status(node_id, "down")
        assert wait_until(lambda: fv.is_revoked(acc.accessor), DEADLINE)
        return acc.task, fv.is_revoked(acc.accessor), oracle_routed(srv)


def test_revoke_on_node_down(tmp_path, monkeypatch):
    assert node_down("port", tmp_path, monkeypatch) == \
        node_down("ref", tmp_path, monkeypatch) == ("web", True, 0)


def failover(kind, tmp_path):
    """Three servers on durable logs; a stale accessor registered through
    the log is revoked by the new leader once the old one is gone."""
    mod = vault_mod(kind)
    mtype = JMessageType if kind == "ref" else PMessageType
    accessor_cls = JVaultAccessor if kind == "ref" else PVaultAccessor
    fv = mod.FakeVault()
    servers = []
    first = None
    for i in range(3):
        fields = dict(node_name=f"vault-{kind}-s{i + 1}",
                      data_dir=str(tmp_path / kind / f"s{i + 1}"),
                      enable_rpc=True, bootstrap_expect=3,
                      start_join=[first] if first else [],
                      num_schedulers=0,
                      vault=mod.VaultConfig(enabled=True))
        srv = (JServer(JServerConfig(**fields), vault_api=fv)
               if kind == "ref" else
               Server(ServerConfig(device="cpu", **fields), vault_api=fv))
        if first is None:
            first = srv.config.rpc_advertise
        servers.append(srv)
    for srv in servers:
        srv.start()
    try:
        assert wait_until(lambda: any(s.is_leader() for s in servers),
                          DEADLINE)
        leader = next(s for s in servers if s.is_leader())
        out = fv.create_token(["p"], 3600.0, {})
        leader.raft.apply(mtype.VAULT_ACCESSOR_REGISTER, {"accessors": [
            accessor_cls(accessor=out["accessor"], alloc_id="gone",
                         node_id="gone-node", task="t")]})
        followers = [s for s in servers if s is not leader]
        assert wait_until(lambda: all(
            len(s.state.vault_accessors(None)) == 1 for s in followers),
            DEADLINE)
        leader.shutdown()
        assert wait_until(lambda: any(s.is_leader() for s in followers),
                          DEADLINE)
        assert wait_until(lambda: fv.is_revoked(out["accessor"]), DEADLINE)
        return fv.is_revoked(out["accessor"]), len(fv.revoked_accessors)
    finally:
        for srv in servers:
            srv.shutdown()


def test_restore_after_failover(tmp_path):
    assert failover("port", tmp_path) == failover("ref", tmp_path)


# -- HTTPVault against a fake vault on the loopback --------------------------

class FakeVaultHTTP(http.server.BaseHTTPRequestHandler):
    """The four token calls and the unwrap, answered as vault does; every
    request recorded (path, token header, wrap header, body)."""

    requests = []
    lease_on_unwrap = True

    def log_message(self, *args):
        pass

    def do_POST(self):
        body = json.loads(self.rfile.read(
            int(self.headers.get("Content-Length") or 0)) or b"{}")
        self.requests.append((self.path, self.headers.get("X-Vault-Token"),
                              self.headers.get("X-Vault-Wrap-TTL"), body))
        if self.path == "/v1/auth/token/create":
            if self.headers.get("X-Vault-Wrap-TTL"):
                reply = {"wrap_info": {"token": "w.1", "ttl": 120,
                                       "wrapped_accessor": "a.w"}}
            else:
                reply = {"auth": {"client_token": "s.1", "accessor": "a.1",
                                  "lease_duration": 3600}}
        elif self.path == "/v1/sys/wrapping/unwrap":
            auth = {"client_token": "s.2", "accessor": "a.2"}
            if self.lease_on_unwrap:
                auth["lease_duration"] = 60
            reply = {"auth": auth}
        elif self.path == "/v1/auth/token/renew":
            reply = {"auth": {"lease_duration": 90}}
        elif self.path == "/v1/auth/token/lookup":
            reply = {"data": {"policies": ["p"], "ttl": 30}}
        elif self.path == "/v1/auth/token/revoke-accessor":
            self.send_response(204)
            self.end_headers()
            return
        else:
            self.send_response(404)
            self.end_headers()
            self.wfile.write(b'{"errors": ["not found"]}')
            return
        data = json.dumps(reply).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


@pytest.fixture()
def fake_vault_http():
    FakeVaultHTTP.requests = []
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), FakeVaultHTTP)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(5.0)


def http_calls(kind, addr):
    FakeVaultHTTP.requests = []
    hv = vault_mod(kind).HTTPVault(addr + "/", "root-token", timeout=5.0)
    out = [hv.create_token(["p"], 3600.0, {"Task": "web"}),
           hv.create_token(["p"], 3600.0, {"Task": "web"}, wrap_ttl=120.0)]
    FakeVaultHTTP.lease_on_unwrap = True
    out.append(hv.unwrap("w.1"))
    FakeVaultHTTP.lease_on_unwrap = False
    out.append(hv.unwrap("w.1"))
    out += [hv.renew_token("s.1", 60.0), hv.lookup_token("s.1")]
    hv.revoke_accessor("a.1")
    bad = vault_mod(kind).HTTPVault(addr + "/nope", "t", timeout=5.0)
    out.append(outcome(lambda: bad.renew_token("s.1", 1.0))[0])
    return out, list(FakeVaultHTTP.requests)


def test_http_vault_equals_the_reference(fake_vault_http):
    ref = http_calls("ref", fake_vault_http)
    port = http_calls("port", fake_vault_http)
    assert port == ref
    # The unwrap without a lease reads 0.0 (the client falls back to the
    # envelope's TTL); the unwrap sends the wrapping token as its token.
    assert port[0][3]["ttl"] == 0.0 and port[0][2]["ttl"] == 60.0
    assert port[1][2][:2] == ("/v1/sys/wrapping/unwrap", "w.1")
    assert port[1][1][2] == "120s"
    assert port[0][-1] == "VaultError"


# -- over the wire and in the agent -------------------------------------------

def wire_derive(kind, monkeypatch):
    from nomad_tpu.server.rpc import RemoteServerRPC as JRemote
    from nomad_tpu_torch.server.rpc import RemoteServerRPC as PRemote

    fv = vault_mod(kind).FakeVault()
    srv = make_server(kind, fv, monkeypatch, num_schedulers=0,
                      enable_rpc=True)
    srv.start()
    remote = (JRemote if kind == "ref" else PRemote)(
        [srv.config.rpc_advertise])
    try:
        assert wait_until(srv.is_leader, DEADLINE)
        alloc = vault_alloc(kind, ("p1",))
        srv.state.upsert_job(srv.raft.applied_index() + 1, alloc.job)
        srv.state.upsert_allocs(srv.raft.applied_index() + 2, [alloc])
        info = remote.derive_vault_token(alloc.id, ["web"])["web"]
        missing = outcome(lambda: remote.derive_vault_token("nope", ["web"]))
        secret = fv.unwrap(info["wrapped_token"])
        return (sorted(info), secret["accessor"] == info["accessor"],
                fv.lookup_token(secret["token"])["policies"],
                missing[0] != "ok")
    finally:
        # The reference's proxy has no close(): its pool's is called.
        (getattr(remote, "close", None) or remote.pool.close)()
        srv.shutdown()


def test_derive_vault_token_over_the_wire(monkeypatch):
    assert wire_derive("port", monkeypatch) == wire_derive("ref",
                                                           monkeypatch)


def test_agent_vault_block_configures_server_and_client(tmp_path):
    """The agent's ``vault {}`` block (agent.py:103-113, :136-139): the
    server's vault config, and the client's vault address and token, as
    the reference's agent sets them."""
    from nomad_tpu.agent import parse_config as jparse_config
    from nomad_tpu_torch.agent import Agent, parse_config

    src = ('server { enabled = true }\nclient { enabled = false }\n'
           'ports {\n http = 0\n rpc = 0\n}\n'
           'vault {\n enabled = true\n address = "http://127.0.0.1:1"\n'
           ' token = "t"\n task_token_ttl = "1h"\n}\n')
    cfg = parse_config(src)
    cfg.dev_mode = True
    a = Agent(cfg, device="cpu", vault_api=pvault.FakeVault(),
              server_options={"min_heartbeat_ttl": HEARTBEAT_TTL})
    try:
        got = dataclasses.asdict(a.server.config.vault)
        assert a.server.vault.enabled
        assert isinstance(a.server.vault.api, pvault.FakeVault)
    finally:
        a.shutdown()
    assert wait_until(lambda: not a.threads(), DEADLINE)
    jcfg = jparse_config(src)
    want = dataclasses.asdict(jvault.VaultConfig(
        enabled=True, addr=jcfg.vault.address, token=jcfg.vault.token,
        task_token_ttl=3600.0))
    assert got == want
