"""Client: the node agent — fingerprints the host, registers the node,
heartbeats, long-polls its allocation set, diffs it against running
AllocRunners, and batches alloc status updates back to the servers (a
copy of ``nomad_tpu/client/client.py``; reference:
client/client.go:99-2461).

The server connection is abstracted behind the duck-typed RPC surface
(node_register / node_update_status / node_update_allocs /
node_get_client_allocs) so the same Client runs against an in-process
Server (dev/test, like the reference's dev agent) or a remote one through
``server.rpc.RemoteServerRPC``.

Where the port departs from the reference:

- ``ClientConfig.node_id`` fixes the node's id (empty: a fresh UUID), and
  ``rng`` seeds the server list's shuffle and the restart jitter.
- ``BUILTIN_DRIVERS`` holds ``mock_driver`` only (ROADMAP item 28(b)),
  and there is no vault client (item 30).
- The first heartbeat (init to ready) follows registration after a
  random stagger of up to ``heartbeat_stagger`` s (default 10, the Go
  client's initialHeartbeatStagger) or half the TTL, whichever is
  sooner; the JAX package's client waits half the TTL, so under a long
  TTL its node stays init.
- ``shutdown()`` saves every runner's state, then ends every thread the
  client started (its loops, the runners, the mock driver's tasks),
  each join bounded; ``threads()`` lists what is still alive.  The
  alloc watch long-polls ``WATCH_MAX_WAIT`` s (the reference 5 s), the
  longest a shutdown waits for it.
"""
from __future__ import annotations

import logging
import os
import random
import tempfile
import threading
import time
from typing import Dict, List, Optional

from .. import fault
from ..structs import structs as s
from ..utils.backoff import Backoff
from .alloc_runner import AllocRunner
from .config import ClientConfig
from .driver.driver import BUILTIN_DRIVERS, DriverContext, new_driver
from .fingerprint import fingerprint_node
from .gc import AllocGarbageCollector
from .state import StateDB
from .stats import HostStatsCollector, ServerList

# Status-sync batching interval (client.go:76-78 allocSyncIntv = 200ms).
ALLOC_SYNC_INTERVAL = 0.2
REGISTER_RETRY_INTERVAL = 15.0
# The first heartbeat, which moves a registered node from init to ready,
# comes after a random stagger of up to this many seconds (client.go:1051
# initialHeartbeatStagger), or half the TTL if that is sooner.
INITIAL_HEARTBEAT_STAGGER = 10.0
# The alloc watch's blocking-query wait.
WATCH_MAX_WAIT = 1.0
# How long shutdown waits for each thread.
JOIN_TIMEOUT = 10.0


class Client:
    def __init__(self, config: Optional[ClientConfig] = None,
                 rpc=None,
                 logger: Optional[logging.Logger] = None,
                 consul=None,
                 rng: Optional[random.Random] = None,
                 heartbeat_stagger: float = INITIAL_HEARTBEAT_STAGGER):
        self.config = config or ClientConfig()
        self.heartbeat_stagger = heartbeat_stagger
        self.rpc = rpc
        self.logger = logger or logging.getLogger("nomad_tpu_torch.client")
        # Consul-shaped service client (command/agent/consul/client.go:87);
        # owned by the agent, shared with task runners for service
        # registration with the task lifecycle.
        self.consul = consul
        self.rng = rng if rng is not None else random.Random()

        if not self.config.alloc_dir:
            self.config.alloc_dir = tempfile.mkdtemp(
                prefix="nomad-torch-alloc-")
        self.state_db: Optional[StateDB] = None
        if self.config.state_dir:
            self.state_db = StateDB(self.config.state_dir)

        self.node = self._setup_node()
        self.fingerprints_applied = self._fingerprint()
        self._setup_drivers()

        self.alloc_runners: Dict[str, AllocRunner] = {}
        self._alloc_lock = threading.Lock()
        self._alloc_updates: Dict[str, s.Allocation] = {}
        self._alloc_updates_lock = threading.Lock()
        self.garbage_collector = AllocGarbageCollector(
            self.config, stats_path=self.config.alloc_dir, logger=self.logger)
        self.host_stats = HostStatsCollector(self.config.alloc_dir)
        self.servers = ServerList(self.config.servers, rng=self.rng)

        self.heartbeat_ttl = 10.0
        self._registered = threading.Event()
        self._shutdown = threading.Event()
        self._threads: List[threading.Thread] = []
        self._threads_lock = threading.Lock()
        self._latest_alloc_index = 0
        # Status-sync accounting: Node.UpdateAlloc calls and the allocs
        # they carried.
        self.sync_calls = 0
        self.sync_allocs = 0
        self.heartbeats = 0

        # Restore persisted alloc runners before any server traffic, like
        # NewClient → restoreState (client.go:335).
        if self.state_db is not None:
            self._restore_state()

    # -- node construction -------------------------------------------------
    def _setup_node(self) -> s.Node:
        """(client.go:253 setupNode)."""
        node = s.Node(
            id=self.config.node_id or s.generate_uuid(),
            datacenter=self.config.datacenter,
            name=self.config.node_name or os.uname().nodename,
            node_class=self.config.node_class,
            attributes={},
            meta=dict(self.config.meta),
            resources=s.Resources(),
            reserved=self.config.reserved or s.Resources(),
            status=s.NODE_STATUS_INIT,
        )
        return node

    def _fingerprint(self) -> List[str]:
        applied = fingerprint_node(self.config, self.node)
        if self.config.cpu_total_compute:
            self.node.resources.cpu = self.config.cpu_total_compute
            self.node.attributes["cpu.totalcompute"] = str(
                self.config.cpu_total_compute)
        self.logger.info("client: fingerprints applied: %s", ",".join(applied))
        return applied

    def _setup_drivers(self) -> None:
        """Driver availability scan (client.go:969 setupDrivers)."""
        avail = []
        for name in BUILTIN_DRIVERS:
            ctx = DriverContext(driver_name=name, alloc_id="",
                                config=self.config, node=self.node)
            try:
                d = new_driver(name, ctx)
                if d.fingerprint(self.node):
                    avail.append(name)
            except Exception:
                continue
        self.node.compute_class()
        self.logger.info("client: available drivers: %s", ",".join(avail))

    # -- lifecycle ---------------------------------------------------------
    def _spawn(self, target, *args, name: str = "") -> threading.Thread:
        t = threading.Thread(target=target, args=args, daemon=True,
                             name=name or f"client-{target.__name__}")
        with self._threads_lock:
            self._threads.append(t)
        t.start()
        return t

    def start(self) -> None:
        for target in (self._register_and_heartbeat, self._watch_allocations,
                       self._alloc_sync_loop):
            self._spawn(target)
        self.garbage_collector.run()

    def shutdown(self) -> None:
        """Save every runner's state, then end every thread the client
        started, each join bounded by ``JOIN_TIMEOUT``."""
        self._shutdown.set()
        self._registered.set()   # a watch still waiting for registration
        self.garbage_collector.stop()
        deadline = time.monotonic() + JOIN_TIMEOUT
        # The loops first: once the watch has ended, no runner is added.
        with self._threads_lock:
            loops = list(self._threads)
        for t in loops:
            t.join(max(0.0, deadline - time.monotonic()))
        with self._alloc_lock:
            runners = list(self.alloc_runners.values())
        for r in runners:
            r.save_state()
        for r in runners:
            r.stop()
        for t in self.threads():
            t.join(max(0.0, deadline - time.monotonic()))

    def threads(self) -> List[threading.Thread]:
        """The live threads of the client, its GC and its runners."""
        with self._threads_lock:
            out = [t for t in self._threads if t.is_alive()]
        out += self.garbage_collector.threads()
        with self._alloc_lock:
            runners = list(self.alloc_runners.values())
        for r in runners:
            out += r.threads()
        return out

    # -- registration + heartbeat (client.go:1031) -------------------------
    @staticmethod
    def _client_rpc_fault(method: str) -> None:
        """Client-side ``rpc.send`` fault point: the agent's logical
        server calls pass through here even when the transport is an
        in-process Server (dev/test), so scenarios can drop or delay a
        client's registration/heartbeat/watch traffic deterministically
        regardless of wiring.  drop/error/truncate all surface as the
        exception the surrounding retry loop already handles."""
        act = fault.faultpoint("rpc.send", method=method, side="client")
        if act is None:
            return
        if act.kind == "delay":
            time.sleep(act.delay)
            return
        if act.kind in ("drop", "truncate", "error", "crash"):
            act.raise_injected()

    def _try_register(self) -> bool:
        try:
            self._client_rpc_fault("Node.Register")
            _index, ttl = self.rpc.node_register(self.node.copy())
            self.heartbeat_ttl = ttl or self.heartbeat_ttl
            self.node.status = s.NODE_STATUS_READY
            self._registered.set()
            return True
        except Exception as e:
            self.logger.warning("client: registration failed: %s", e)
            return False

    def _consul_discover_servers(self) -> bool:
        """Find servers through a Consul-shaped catalog when none answer
        (client.go:2139 consulDiscovery): query the configured catalog's
        'nomad' service (an agent's ``/v1/catalog/service/nomad``) for RPC
        endpoints."""
        addr = self.config.consul_address
        if not addr:
            return False
        import json
        import urllib.request
        try:
            url = addr.rstrip("/") + "/v1/catalog/service/nomad"
            with urllib.request.urlopen(url, timeout=5.0) as resp:
                entries = json.loads(resp.read() or b"[]")
        except Exception as e:
            self.logger.warning("client: consul discovery failed: %s", e)
            return False
        servers = [f"{e['Address']}:{e['Port']}" for e in entries
                   if e.get("Address") and e.get("Port")]
        if not servers:
            return False
        self.logger.info("client: discovered servers via consul: %s",
                         ",".join(servers))
        self.servers.set(servers)
        if hasattr(self.rpc, "servers"):
            self.rpc.servers = list(servers)
        return True

    def _register_and_heartbeat(self) -> None:
        # Jittered exponential backoff between registration attempts: a
        # fleet re-registering after a server restart must spread out
        # rather than re-dial on one fixed 15s boundary.
        register_backoff = Backoff(base=0.5,
                                   max_delay=REGISTER_RETRY_INTERVAL)
        while not self._shutdown.is_set():
            if self._try_register():
                break
            if self._consul_discover_servers():
                register_backoff.reset()
                continue  # fresh servers — retry immediately
            if self._shutdown.wait(register_backoff.next_delay()):
                return
        # Heartbeat at TTL/2-ish like the reference's jittered resend; the
        # first after the initial stagger (client.go:1051).
        wait = min(self.rng.uniform(0.0, self.heartbeat_stagger),
                   self.heartbeat_ttl / 2.0)
        while not self._shutdown.is_set():
            if self._shutdown.wait(wait):
                return
            try:
                self._client_rpc_fault("Node.UpdateStatus")
                _index, ttl = self.rpc.node_update_status(
                    self.node.id, s.NODE_STATUS_READY)
                if ttl:
                    self.heartbeat_ttl = ttl
                self.heartbeats += 1
            except Exception as e:
                # The server may have forgotten us (restart with lost state,
                # node GC) — fall back to re-registration like
                # client.go:1127 (retryRegisterNode on heartbeat failure).
                self.logger.warning(
                    "client: heartbeat failed, re-registering: %s", e)
                self._try_register()
            wait = max(0.5, self.heartbeat_ttl / 2.0)

    # -- allocation watching (client.go:1364 watchAllocations) -------------
    def _watch_allocations(self) -> None:
        self._registered.wait()
        watch_backoff = Backoff(base=0.25, max_delay=5.0)
        while not self._shutdown.is_set():
            try:
                self._client_rpc_fault("Node.GetClientAllocs")
                allocs, index = self.rpc.node_get_client_allocs(
                    self.node.id, min_index=self._latest_alloc_index,
                    max_wait=WATCH_MAX_WAIT)
            except Exception as e:
                self.logger.warning("client: alloc watch failed: %s", e)
                if self._shutdown.wait(watch_backoff.next_delay()):
                    return
                continue
            watch_backoff.reset()
            if index <= self._latest_alloc_index or self._shutdown.is_set():
                continue
            self._latest_alloc_index = index
            self._run_allocs(allocs)

    def _run_allocs(self, server_allocs: List[s.Allocation]) -> None:
        """Diff desired vs running (client.go:1559 runAllocs)."""
        by_id = {a.id: a for a in server_allocs}
        with self._alloc_lock:
            existing = dict(self.alloc_runners)

        # removals: the server no longer knows the alloc
        for alloc_id, runner in existing.items():
            if alloc_id not in by_id:
                self._remove_alloc(alloc_id, runner)

        for alloc_id, alloc in by_id.items():
            runner = existing.get(alloc_id)
            if runner is None:
                if not alloc.terminal_status():
                    self._add_alloc(alloc)
            elif alloc.alloc_modify_index > runner.alloc.alloc_modify_index:
                runner.update(alloc)

    def _add_alloc(self, alloc: s.Allocation) -> None:
        """(client.go:1812 addAlloc) + sticky-disk chaining."""
        tg = alloc.job.lookup_task_group(alloc.task_group) if alloc.job else None
        prev_dir = None
        remote_migrate = False
        if (alloc.previous_allocation and tg is not None
                and tg.ephemeral_disk is not None and tg.ephemeral_disk.sticky):
            with self._alloc_lock:
                prev = self.alloc_runners.get(alloc.previous_allocation)
            if prev is not None:
                prev_dir = prev.alloc_dir
            elif tg.ephemeral_disk.migrate:
                # Previous alloc lives on another node: pull its sticky
                # data over that node's HTTP fs surface once it is
                # terminal (client.go:1743 migrateRemoteAllocDir).
                remote_migrate = True

        self.garbage_collector.make_room_for(
            tg.ephemeral_disk.size_mb if tg and tg.ephemeral_disk else 0,
            total_live_allocs=len(self.alloc_runners))

        runner = AllocRunner(
            config=self.config,
            alloc=alloc,
            updater=self._alloc_status_update,
            node=self.node,
            state_db=self.state_db,
            prev_alloc_dir=prev_dir,
            consul=self.consul,
            logger=self.logger,
            rng=self.rng,
        )
        # Block start on the previous alloc reaching a terminal state
        # (sticky disk / in-place upgrade ordering, client.go:1654).
        if alloc.previous_allocation:
            with self._alloc_lock:
                prev = self.alloc_runners.get(alloc.previous_allocation)
            if prev is not None and not prev.done.is_set():
                runner.waiting_on_previous.clear()
                self._spawn(lambda: (prev.done.wait(),
                                     runner.waiting_on_previous.set()),
                            name=f"client-prev-{alloc.id[:8]}")
            elif remote_migrate:
                runner.waiting_on_previous.clear()
                self._spawn(self._migrate_remote_alloc_dir,
                            alloc.previous_allocation, runner)
        with self._alloc_lock:
            self.alloc_runners[alloc.id] = runner
        runner.run()

    def _migrate_remote_alloc_dir(self, prev_alloc_id: str,
                                  runner: AllocRunner) -> None:
        """Pull the previous allocation's sticky data from its node's HTTP
        fs surface once that alloc is terminal
        (client.go:1743 migrateRemoteAllocDir).  Always releases the
        runner's start gate — a failed migration starts fresh, it does
        not wedge the replacement."""
        import base64
        import json as _json
        import urllib.request

        try:
            deadline = time.time() + 300.0
            prev = None
            terminal = False
            while time.time() < deadline and not self._shutdown.is_set():
                prev = self.rpc.alloc_get(prev_alloc_id)
                if prev is None or prev.terminal_status() \
                        or prev.client_terminal_status():
                    terminal = True
                    break
                self._shutdown.wait(0.5)
            if prev is None:
                return
            if not terminal:
                # The old alloc is still live: snapshotting a dir being
                # written would migrate torn data.  Start fresh instead.
                self.logger.warning(
                    "migration: previous alloc %s still running after "
                    "wait; starting without sticky data",
                    prev_alloc_id[:8])
                return
            node = self.rpc.node_get(prev.node_id)
            if node is None or not node.http_addr:
                self.logger.warning(
                    "migration: node %s has no HTTP address", prev.node_id)
                return
            url = (f"http://{node.http_addr}/v1/client/fs/snapshot/"
                   f"{prev_alloc_id}")
            # Stream the tar frames to a temp file: sticky disks can be
            # GBs; neither side holds the whole archive in memory.
            fd, tmp = tempfile.mkstemp(suffix=".tar")
            size = 0
            try:
                with os.fdopen(fd, "wb") as out, urllib.request.urlopen(
                        url, timeout=300.0) as resp:
                    for line in resp:
                        line = line.strip()
                        if not line:
                            continue
                        frame = _json.loads(line)
                        if frame.get("Data"):
                            chunk = base64.b64decode(frame["Data"])
                            out.write(chunk)
                            size += len(chunk)
            except Exception:
                try:
                    os.unlink(tmp)  # never leak a partial multi-GB tar
                except OSError:
                    pass
                raise
            if size:
                runner.remote_snapshot_path = tmp
                self.logger.info(
                    "migration: pulled %d bytes of sticky data for %s",
                    size, runner.alloc.id[:8])
            else:
                os.unlink(tmp)
        except Exception as e:
            self.logger.warning("migration from %s failed: %s",
                                prev_alloc_id[:8], e)
        finally:
            runner.waiting_on_previous.set()

    def _remove_alloc(self, alloc_id: str, runner: AllocRunner) -> None:
        with self._alloc_lock:
            self.alloc_runners.pop(alloc_id, None)
        runner.destroy()
        self.garbage_collector.mark_for_collection(runner)

    # -- status sync (client.go:1305 allocSync) ----------------------------
    def _alloc_status_update(self, alloc: s.Allocation) -> None:
        with self._alloc_updates_lock:
            self._alloc_updates[alloc.id] = alloc
        if alloc.terminal_status():
            with self._alloc_lock:
                runner = self.alloc_runners.get(alloc.id)
            if runner is not None:
                self.garbage_collector.mark_for_collection(runner)

    def _alloc_sync_loop(self) -> None:
        while not self._shutdown.wait(ALLOC_SYNC_INTERVAL):
            with self._alloc_updates_lock:
                if not self._alloc_updates:
                    continue
                batch = list(self._alloc_updates.values())
                self._alloc_updates = {}
            try:
                self.rpc.node_update_allocs(batch)
                self.sync_calls += 1
                self.sync_allocs += len(batch)
            except Exception as e:
                self.logger.warning("client: alloc sync failed: %s", e)
                with self._alloc_updates_lock:
                    for a in batch:
                        self._alloc_updates.setdefault(a.id, a)

    # -- restore (client.go:335 restoreState) ------------------------------
    def _restore_state(self) -> None:
        for alloc_id in self.state_db.list_alloc_runners():
            state = self.state_db.get_alloc_runner(alloc_id)
            if not state:
                continue
            alloc = state.get("alloc")
            if alloc is None:
                continue
            runner = AllocRunner(
                config=self.config, alloc=alloc,
                updater=self._alloc_status_update, node=self.node,
                state_db=self.state_db, consul=self.consul,
                logger=self.logger, rng=self.rng)
            runner.task_states = dict(state.get("task_states", {}))
            with self._alloc_lock:
                self.alloc_runners[alloc_id] = runner
            if not alloc.terminal_status():
                runner.run()
            else:
                runner.done.set()
                self.garbage_collector.mark_for_collection(runner)

    # -- introspection (client HTTP endpoints) -----------------------------
    def get_alloc_runner(self, alloc_id: str) -> Optional[AllocRunner]:
        with self._alloc_lock:
            return self.alloc_runners.get(alloc_id)

    def get_client_alloc(self, alloc_id: str) -> Optional[s.Allocation]:
        runner = self.get_alloc_runner(alloc_id)
        return runner.current_alloc() if runner else None

    def stats(self) -> Dict:
        with self._alloc_lock:
            n = len(self.alloc_runners)
        return {
            "node_id": self.node.id,
            "known_servers": self.servers.all(),
            "num_allocations": n,
            "last_heartbeat_ttl": self.heartbeat_ttl,
            "host_stats": self.host_stats.collect(),
        }

    def num_allocs(self) -> int:
        with self._alloc_lock:
            return len(self.alloc_runners)

    def stream_task_logs(self, alloc_id: str, task: str,
                         log_type: str = "stdout", offset: int = 0,
                         origin: str = "start", follow: bool = False):
        """Framed log streaming with follow across rotations
        (fs_endpoint.go logs handler); yields StreamFrame dicts."""
        from .fs_stream import stream_log_frames

        runner = self.get_alloc_runner(alloc_id)
        if runner is None:
            raise KeyError(f"unknown allocation ID {alloc_id!r}")
        log_dir = os.path.join(runner.alloc_dir.alloc_dir, "alloc", "logs")

        def alive() -> bool:
            r = self.get_alloc_runner(alloc_id)
            return r is not None and not r.alloc.terminal_status()

        return stream_log_frames(log_dir, task, log_type, offset=offset,
                                 origin=origin, follow=follow, alive=alive)

    def stream_file(self, alloc_id: str, path: str, offset: int = 0,
                    origin: str = "start", follow: bool = False):
        """Framed single-file streaming (fs_endpoint.go stream handler)."""
        from .fs_stream import stream_file_frames

        runner = self.get_alloc_runner(alloc_id)
        if runner is None:
            raise KeyError(f"unknown allocation ID {alloc_id!r}")
        abs_path = runner.alloc_dir._safe_path(path)

        def alive() -> bool:
            r = self.get_alloc_runner(alloc_id)
            return r is not None and not r.alloc.terminal_status()

        return stream_file_frames(abs_path, path, offset=offset,
                                  origin=origin, follow=follow, alive=alive)

    def task_logs(self, alloc_id: str, task: str, log_type: str = "stdout",
                  max_bytes: int = 1 << 20) -> str:
        """Concatenate the tail of the rotated log files for a task (fs logs
        endpoint; reference: client log streaming via AllocDir ReadAt).
        Reads newest-first and stops once max_bytes is gathered so large
        rotations aren't buffered whole."""
        runner = self.get_alloc_runner(alloc_id)
        if runner is None:
            raise KeyError(f"unknown allocation ID {alloc_id!r}")
        log_dir = os.path.join(runner.alloc_dir.alloc_dir, "alloc", "logs")
        if not os.path.isdir(log_dir):
            return ""
        prefix = f"{task}.{log_type}."
        files = sorted(
            (f for f in os.listdir(log_dir) if f.startswith(prefix)),
            key=lambda f: int(f.rsplit(".", 1)[-1])
            if f.rsplit(".", 1)[-1].isdigit() else 0)
        chunks: List[bytes] = []
        remaining = max_bytes
        for fname in reversed(files):
            if remaining <= 0:
                break
            path = os.path.join(log_dir, fname)
            size = os.path.getsize(path)
            with open(path, "rb") as fh:
                if size > remaining:
                    fh.seek(size - remaining)
                data = fh.read(remaining)
            chunks.append(data)
            remaining -= len(data)
        return b"".join(reversed(chunks)).decode("utf-8", "replace")
