"""The server's Vault subsystem (a copy of ``nomad_tpu/server/vault.py``;
reference nomad/vault.go:234-1218 vaultClient): derives per-task tokens
against a Vault endpoint, renews the server's own token, and revokes
accessors when allocations terminate.

The transport is pluggable: ``HTTPVault`` speaks the Vault token API
(/v1/auth/token/*, /v1/sys/wrapping/unwrap); ``FakeVault`` is the
in-memory double of tests and dev mode (the role of
nomad/vault_testing.go and testutil/vault.go).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..structs import structs as s


class VaultError(Exception):
    pass


@dataclass
class VaultConfig:
    """(reference: nomad/structs/config/vault.go VaultConfig)."""

    enabled: bool = False
    addr: str = "https://vault.service.consul:8200"
    token: str = ""
    task_token_ttl: float = 72 * 3600.0
    allow_unauthenticated: bool = True
    # Response-wrap derived task tokens (vault.go getWrappingFn).  On by
    # default: clients receive a single-use wrapping token, never the
    # raw secret on the wire.  A client that reaches its server over the
    # wire without a ``vault_addr`` cannot unwrap: turn this off for
    # such clients (or give them a vault_addr).
    wrap_derived_tokens: bool = True


# Wrapping TTL for derived task tokens (vault.go:28 vaultTokenCreateTTL):
# the server hands the client a single-use wrapping token whose cubbyhole
# holds the real secret; an uncommitted leak dies with the wrapper.
WRAP_TTL_S = 120.0


class VaultAPI:
    """The subset of Vault's token API the control plane uses."""

    def create_token(self, policies: List[str], ttl: float,
                     metadata: Dict[str, str],
                     wrap_ttl: float = 0.0) -> Dict:
        """→ {"token", "accessor", "ttl"} (auth/token/create), or with
        ``wrap_ttl`` > 0 a response-wrapped secret
        {"wrapped_token", "wrap_ttl"} (sys/wrapping semantics)."""
        raise NotImplementedError

    def unwrap(self, wrapping_token: str) -> Dict:
        """Single-use cubbyhole unwrap (sys/wrapping/unwrap) →
        {"token", "accessor", "ttl"}."""
        raise NotImplementedError

    def renew_token(self, token: str, increment: float) -> float:
        """→ new ttl seconds (auth/token/renew)."""
        raise NotImplementedError

    def revoke_accessor(self, accessor: str) -> None:
        """(auth/token/revoke-accessor)."""
        raise NotImplementedError

    def lookup_token(self, token: str) -> Dict:
        """(auth/token/lookup)."""
        raise NotImplementedError


class FakeVault(VaultAPI):
    """In-memory Vault double: real token/accessor lifecycle, inspectable
    revocations (nomad/vault_testing.go)."""

    def __init__(self, clock=time.time) -> None:
        self._l = threading.Lock()
        self.clock = clock
        self.tokens: Dict[str, Dict] = {}          # token -> record
        self.by_accessor: Dict[str, str] = {}      # accessor -> token
        self.wrapped: Dict[str, Dict] = {}         # wrap token -> cubbyhole
        self.revoked_accessors: List[str] = []
        self.renew_calls = 0
        self.unwrap_calls = 0
        # Test fault injection: revoke_accessor raises while > 0.
        self.fail_revokes = 0

    def create_token(self, policies, ttl, metadata, wrap_ttl=0.0):
        token = "s." + s.generate_uuid()
        accessor = "a." + s.generate_uuid()
        with self._l:
            rec = {"token": token, "accessor": accessor,
                   "policies": list(policies), "ttl": ttl,
                   "expires": self.clock() + ttl,
                   "metadata": dict(metadata), "revoked": False}
            self.tokens[token] = rec
            self.by_accessor[accessor] = token
            if wrap_ttl > 0:
                # Response wrapping: the real secret lives in a cubbyhole
                # behind a single-use wrapping token with its own short
                # TTL (vault.go getWrappingFn; sys/wrapping semantics).
                wrap = "w." + s.generate_uuid()
                self.wrapped[wrap] = {
                    "secret": {"token": token, "accessor": accessor,
                               "ttl": ttl},
                    "expires": self.clock() + wrap_ttl,
                    "used": False}
                return {"wrapped_token": wrap, "wrap_ttl": wrap_ttl,
                        "accessor": accessor, "ttl": ttl}
        return {"token": token, "accessor": accessor, "ttl": ttl}

    def unwrap(self, wrapping_token):
        with self._l:
            rec = self.wrapped.get(wrapping_token)
            self.unwrap_calls += 1
            if rec is None:
                raise VaultError("unknown wrapping token")
            if rec["used"]:
                raise VaultError("wrapping token already used")
            if self.clock() > rec["expires"]:
                raise VaultError("wrapping token expired")
            rec["used"] = True
            return dict(rec["secret"])

    def renew_token(self, token, increment):
        with self._l:
            rec = self.tokens.get(token)
            if rec is None or rec["revoked"]:
                raise VaultError("token not found or revoked")
            rec["expires"] = time.time() + increment
            rec["ttl"] = increment
            self.renew_calls += 1
            return increment

    def revoke_accessor(self, accessor):
        with self._l:
            if self.fail_revokes > 0:
                self.fail_revokes -= 1
                raise VaultError("injected revoke failure")
            token = self.by_accessor.get(accessor)
            if token is not None:
                self.tokens[token]["revoked"] = True
            self.revoked_accessors.append(accessor)

    def lookup_token(self, token):
        with self._l:
            rec = self.tokens.get(token)
            if rec is None or rec["revoked"]:
                raise VaultError("token not found or revoked")
            return dict(rec)

    # test helpers
    def is_revoked(self, accessor: str) -> bool:
        with self._l:
            return accessor in self.revoked_accessors


class HTTPVault(VaultAPI):
    """Real-Vault transport over its HTTP token API (vault.go uses the
    official client; the wire calls are the same four)."""

    def __init__(self, addr: str, token: str, timeout: float = 10.0):
        self.addr = addr.rstrip("/")
        self.token = token
        self.timeout = timeout

    def _call(self, method: str, path: str, body: Optional[dict] = None,
              headers: Optional[dict] = None,
              token_override: Optional[str] = None):
        import json
        import urllib.request

        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(self.addr + path, data=data,
                                     method=method)
        req.add_header("X-Vault-Token", token_override or self.token)
        for k, v in (headers or {}).items():
            req.add_header(k, v)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                raw = resp.read()
                return json.loads(raw) if raw else {}
        except Exception as e:  # connection + HTTP errors alike
            raise VaultError(f"vault request {path} failed: {e}") from e

    def create_token(self, policies, ttl, metadata, wrap_ttl=0.0):
        headers = ({"X-Vault-Wrap-TTL": f"{int(wrap_ttl)}s"}
                   if wrap_ttl > 0 else None)
        out = self._call("POST", "/v1/auth/token/create", {
            "policies": policies, "ttl": f"{int(ttl)}s",
            "meta": metadata, "renewable": True}, headers=headers)
        if wrap_ttl > 0:
            wi = out.get("wrap_info") or {}
            return {"wrapped_token": wi.get("token", ""),
                    "wrap_ttl": float(wi.get("ttl", wrap_ttl)),
                    "accessor": wi.get("wrapped_accessor", ""),
                    "ttl": ttl}
        auth = out.get("auth") or {}
        return {"token": auth.get("client_token", ""),
                "accessor": auth.get("accessor", ""),
                "ttl": float(auth.get("lease_duration", ttl))}

    def unwrap(self, wrapping_token):
        out = self._call("POST", "/v1/sys/wrapping/unwrap", {},
                         token_override=wrapping_token)
        auth = out.get("auth") or {}
        # lease_duration may be absent (or 0) in the unwrap response;
        # emit 0.0 and let the consumer (ClientVaultClient.derive_token)
        # fall back to the wrapped envelope's requested TTL — a 0 TTL
        # must never reach the renewal heap (it would schedule immediate
        # never-ending renewal churn).
        return {"token": auth.get("client_token", ""),
                "accessor": auth.get("accessor", ""),
                "ttl": float(auth.get("lease_duration") or 0.0)}

    def renew_token(self, token, increment):
        out = self._call("POST", "/v1/auth/token/renew", {
            "token": token, "increment": f"{int(increment)}s"})
        return float((out.get("auth") or {}).get("lease_duration", increment))

    def revoke_accessor(self, accessor):
        self._call("POST", "/v1/auth/token/revoke-accessor",
                   {"accessor": accessor})

    def lookup_token(self, token):
        return self._call("POST", "/v1/auth/token/lookup", {"token": token})


class ServerVaultClient:
    """Token derivation + revocation driver on the server
    (vault.go:234 vaultClient; DeriveToken at vault.go:~900,
    RevokeTokens at vault.go:~1050)."""

    def __init__(self, config: VaultConfig, api: Optional[VaultAPI] = None,
                 logger: Optional[logging.Logger] = None,
                 clock=time.time, rand=None):
        import random

        self.config = config
        self.logger = logger or logging.getLogger("nomad_tpu_torch.vault")
        self.api = api if api is not None else (
            HTTPVault(config.addr, config.token) if config.enabled else None)
        self._stop = threading.Event()
        self.clock = clock
        self.rand = rand if rand is not None else random.random
        # Self-token renewal state (vault.go:467 renewalLoop).
        self.creation_ttl = 0.0
        self.last_renewed = 0.0
        self._backoff = 0.0
        self.connection_lost: Optional[str] = None
        self._renew_thread: Optional[threading.Thread] = None
        self._renew_wake = threading.Event()
        # Revocation retry queue (vault.go:1027 storeForRevocation +
        # :1104 revokeDaemon): accessor → give-up deadline (token TTL).
        self._rev_l = threading.Lock()
        self._revoking: Dict[str, float] = {}
        self._active = True

    @property
    def enabled(self) -> bool:
        return self.config.enabled and self.api is not None

    def stop(self) -> None:
        self._stop.set()
        self._renew_wake.set()

    # -- activation (vault.go:290 SetActive) ---------------------------

    def set_active(self, active: bool) -> None:
        """Leadership hook: while inactive, queued revocations are
        cleared — another server is assumed to be taking over them."""
        self._active = active
        if not active:
            with self._rev_l:
                self._revoking.clear()

    # -- self-token renewal (vault.go:467-567) -------------------------

    def start_renewal(self, creation_ttl: Optional[float] = None) -> None:
        """Begin renewing the server's own Vault token.  The creation
        TTL comes from a lookup-self (parseSelfToken, vault.go:590)
        unless given explicitly."""
        if not self.enabled:
            return
        if creation_ttl is None:
            try:
                info = self.api.lookup_token(self.config.token)
                creation_ttl = float(info.get("ttl", 0) or
                                     info.get("creation_ttl", 0) or 3600.0)
            except VaultError as e:
                self.logger.warning("vault: self-token lookup failed: %s", e)
                creation_ttl = 3600.0
        self.creation_ttl = creation_ttl
        self.last_renewed = self.clock()
        self._renew_thread = threading.Thread(
            target=self._renewal_loop, name="vault-self-renewal",
            daemon=True)
        self._renew_thread.start()

    def renewal_tick(self) -> Optional[float]:
        """One renewal attempt; returns seconds until the next attempt,
        or None when renewal must stop (token expired — vault.go:528
        'failed to renew before lease expiration').

        Success schedules the next renew at HALF the time to expiry;
        failure backs off 5s → ×1.25 → 30s cap, ×(1 + rand) jitter,
        never more than half the remaining lease."""
        now = self.clock()
        expiration = self.last_renewed + self.creation_ttl
        try:
            self.api.renew_token(self.config.token, self.creation_ttl)
            self.last_renewed = self.clock()
            self._backoff = 0.0
            return (self.last_renewed + self.creation_ttl
                    - self.clock()) / 2.0
        except VaultError as e:
            self.logger.warning("vault: self-token renewal failed: %s", e)
            if self._backoff < 5:
                self._backoff = 5.0
            elif self._backoff >= 24:
                self._backoff = 30.0
            else:
                self._backoff *= 1.25
            backoff = self._backoff * (1.0 + self.rand())
            max_backoff = (expiration - now) / 2.0
            if max_backoff < 0:
                self.connection_lost = str(e)
                self.logger.error(
                    "vault: failed to renew token before lease "
                    "expiration; stopping renewal")
                return None
            return min(backoff, max_backoff)

    def _renewal_loop(self) -> None:
        delay = 0.0
        while not self._stop.is_set():
            self._renew_wake.wait(timeout=max(0.01, delay))
            self._renew_wake.clear()
            if self._stop.is_set():
                return
            delay = self.renewal_tick()
            if delay is None:
                return

    # -- revocation retry (vault.go:1027, :1104) -----------------------

    def store_for_revocation(self, accessors: List[str],
                             ttl: Optional[float] = None) -> None:
        """Queue failed revocations for retry until the token's TTL —
        past that the token is dead anyway (vault.go:965)."""
        deadline = self.clock() + (ttl if ttl is not None
                                   else self.config.task_token_ttl)
        with self._rev_l:
            for acc in accessors:
                self._revoking.setdefault(acc, deadline)

    def tick_revocations(self) -> List[str]:
        """One retry pass over the queue; returns accessors revoked this
        pass.  Entries past their deadline are dropped (token TTL'd)."""
        if not self.enabled or not self._active:
            return []
        now = self.clock()
        with self._rev_l:
            pending = list(self._revoking.items())
        done: List[str] = []
        for acc, deadline in pending:
            if now > deadline:
                with self._rev_l:
                    self._revoking.pop(acc, None)
                continue
            try:
                self.api.revoke_accessor(acc)
                done.append(acc)
                with self._rev_l:
                    self._revoking.pop(acc, None)
            except VaultError as e:
                self.logger.warning("vault: retry revoke %s failed: %s",
                                    acc, e)
        return done

    def num_revoking(self) -> int:
        with self._rev_l:
            return len(self._revoking)

    def derive_token(self, alloc: s.Allocation, task_names: List[str],
                     wrapped: bool = False) -> Dict[str, Dict]:
        """Create one token per task → {task: {token, accessor, ttl}}.
        Tasks must carry a vault block (vault.go DeriveToken
        validation).  With ``wrapped``, each entry is response-wrapped
        ({task: {wrapped_token, wrap_ttl, accessor, ttl}}) — the client
        unwraps the single-use cubbyhole (vault.go getWrappingFn), so a
        secret leaked before distribution dies with the wrapper."""
        if not self.enabled:
            raise VaultError("Vault is not enabled")
        job = alloc.job
        if job is None:
            raise VaultError("allocation has no job")
        tg = next((g for g in job.task_groups
                   if g.name == alloc.task_group), None)
        if tg is None:
            raise VaultError(f"unknown task group {alloc.task_group!r}")
        out: Dict[str, Dict] = {}
        for name in task_names:
            task = next((t for t in tg.tasks if t.name == name), None)
            if task is None or task.vault is None:
                raise VaultError(
                    f"task {name!r} does not request a Vault token")
            out[name] = self.api.create_token(
                task.vault.policies, self.config.task_token_ttl,
                {"AllocationID": alloc.id, "Task": name,
                 "NodeID": alloc.node_id},
                wrap_ttl=WRAP_TTL_S if wrapped else 0.0)
        return out

    def revoke_accessors(self, accessors: List[str]) -> List[str]:
        """Best-effort revoke; returns accessors revoked successfully."""
        if not self.enabled:
            return list(accessors)  # nothing to revoke against
        done = []
        for acc in accessors:
            try:
                self.api.revoke_accessor(acc)
                done.append(acc)
            except VaultError as e:
                self.logger.warning("vault: revoke %s failed: %s", acc, e)
        return done
