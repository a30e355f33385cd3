"""The client's Vault token manager (a copy of
``nomad_tpu/client/vaultclient.py``; reference
client/vaultclient/vaultclient.go): derives tokens through the server's
``Node.DeriveVaultToken`` and keeps them alive with a renewal min-heap."""

from __future__ import annotations

import heapq
import logging
import threading
import time
from typing import Callable, Dict, List, Optional


class ClientVaultClient:
    """Renewal heap + derive pass-through.

    ``derive_fn(alloc_id, task_names) -> {task: {token, accessor, ttl}}``
    is the server RPC; ``renew_fn(token, increment) -> new_ttl`` talks to
    Vault directly (the reference client renews against Vault itself)."""

    def __init__(self, derive_fn: Callable, renew_fn: Optional[Callable],
                 logger: Optional[logging.Logger] = None,
                 unwrap_fn: Optional[Callable] = None):
        self.derive_fn = derive_fn
        self.renew_fn = renew_fn
        self.unwrap_fn = unwrap_fn
        self.logger = logger or logging.getLogger("nomad_tpu_torch.vaultclient")
        self._l = threading.Lock()
        self._heap: List = []          # (due_time, seq, token, ttl)
        self._tracked: Dict[str, float] = {}   # token -> ttl
        self._seq = 0
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._renewal_loop,
                                        name="vault-renewal", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()

    # -- derive --------------------------------------------------------

    def derive_token(self, alloc_id: str, task_names: List[str]
                     ) -> Dict[str, Dict]:
        out = self.derive_fn(alloc_id, task_names)
        # Servers response-wrap derived tokens (vault.go getWrappingFn):
        # unwrap the single-use cubbyhole here so task runners see the
        # plain {token, accessor, ttl} shape.
        unwrapped: Dict[str, Dict] = {}
        for task, info in out.items():
            if "wrapped_token" in info:
                if self.unwrap_fn is None:
                    raise RuntimeError(
                        "received a wrapped Vault token but no unwrap "
                        "transport is configured (vault_addr)")
                plain = dict(self.unwrap_fn(info["wrapped_token"]))
                if float(plain.get("ttl") or 0.0) <= 0.0:
                    # The unwrap response omitted lease_duration: fall
                    # back to the envelope's requested task-token TTL so
                    # the renewal heap gets a real deadline instead of a
                    # ttl=0 immediate-renewal churn loop.
                    plain["ttl"] = float(info.get("ttl") or 0.0)
                unwrapped[task] = plain
            else:
                unwrapped[task] = info
        return unwrapped

    # -- renewal heap (vaultclient.go renewal loop) ----------------------

    def renew_token(self, token: str, ttl: float) -> None:
        """Track ``token`` for periodic renewal at ttl/2 cadence.
        ``ttl <= 0`` is refused outright: a zero deadline would schedule
        the token for immediate, never-ending renewal churn."""
        if ttl <= 0:
            self.logger.warning(
                "vault: refusing to track token with non-positive ttl "
                "%.1fs (missing lease_duration?); it will not be renewed",
                ttl)
            return
        if self.renew_fn is None:
            # Without a Vault transport the heap cannot actually renew —
            # say so instead of silently letting the token expire at TTL.
            self.logger.warning(
                "vault: no renewal transport configured (vault_addr); "
                "token will expire at its original TTL")
        with self._l:
            if token in self._tracked:
                return
            self._tracked[token] = ttl
            self._seq += 1
            heapq.heappush(self._heap,
                           (time.monotonic() + ttl / 2, self._seq, token))
        self._wake.set()

    def stop_renew_token(self, token: str) -> None:
        with self._l:
            self._tracked.pop(token, None)

    def num_tracked(self) -> int:
        with self._l:
            return len(self._tracked)

    def _renewal_loop(self) -> None:
        while not self._stop.is_set():
            with self._l:
                due = self._heap[0][0] if self._heap else None
            now = time.monotonic()
            if due is None or due > now:
                self._wake.wait(timeout=0.5 if due is None
                                else min(due - now, 5.0))
                self._wake.clear()
                continue
            with self._l:
                _, _, token = heapq.heappop(self._heap)
                ttl = self._tracked.get(token)
            if ttl is None:
                continue  # stopped tracking — drop silently
            try:
                new_ttl = (self.renew_fn(token, ttl)
                           if self.renew_fn is not None else ttl)
            except Exception as e:
                self.logger.warning("vault: token renewal failed: %s", e)
                # Retry sooner, like the reference's backoff on failure.
                new_ttl = min(ttl, 60.0)
            with self._l:
                if token in self._tracked:
                    self._tracked[token] = new_ttl
                    self._seq += 1
                    heapq.heappush(
                        self._heap,
                        (time.monotonic() + max(new_ttl / 2, 1.0),
                         self._seq, token))
