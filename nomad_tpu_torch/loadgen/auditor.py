"""Continuous safety auditors (a copy of ``nomad_tpu/loadgen/auditor.py``):
prove cluster invariants LIVE while load runs, instead of only in a
post-run sweep.  ``SafetyAuditor`` watches one region's servers;
``FederatedAuditor`` (with ``federated_sweep``) the regions of a
federation, each an in-process server (see its docstring).

Feeds
-----
- the leader's in-process event stream (all topics): eval ack/terminal
  tracking, monotonically nondecreasing event indexes, fault-fire
  forensics;
- a per-follower ``Event.Since`` poll over the auditor's own connection
  pool: every server's event stream stays alive and monotonic;
- periodic FSM cross-checks: an entry-boundary-consistent integrity
  sweep of the leader's state plus ``Status.Fingerprint`` polls of
  every server.  Any committed-prefix index that ever maps to two
  different state digests is replicated-state divergence — the bug
  class raft exists to make impossible, asserted rather than assumed.

Invariants asserted, live:

1. no overplaced job (live allocs ≤ the latest registered count),
2. no duplicate alloc names within a job,
3. no overcommitted node (usage ≤ capacity − reserved),
4. no lost acked eval (an EvalAcked eval must be terminal in the FSM),
5. per-server monotonic applied/event indexes (reset across an
   audited restart — volatile state may lawfully regress, the
   committed prefix may not),
6. identical committed-prefix FSM fingerprints across servers.

``finalize()`` additionally forces the strongest form of (6): after
drain it waits for every server to converge on the leader's prefix and
compares digests at the SAME index — a guaranteed cross-check even if
the live polls never landed on matching indexes under load.  Each
violation is a flight-recorder incident (``auditor.violation``).
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from ..structs import structs as s
from ..utils import blackbox

# Terminal eval states an acked eval may lawfully rest in.
_TERMINAL = (s.EVAL_STATUS_COMPLETE, s.EVAL_STATUS_FAILED,
             s.EVAL_STATUS_CANCELLED, s.EVAL_STATUS_BLOCKED)


def integrity_sweep(state, job_ids: Optional[Set[str]] = None,
                    strict: bool = False) -> Dict:
    """One placement-integrity pass over ``state`` (a consistent
    snapshot): overplaced jobs, duplicate alloc names, overcommitted
    nodes.  Shared by the harness's end-of-run report and the auditor's
    continuous sweeps — zero everywhere is the bar.

    ``strict=False`` (live sweeps) excuses a surplus-alloc job that has
    a non-terminal eval as a scale-down in progress; the honest cost is
    that a transient double placement healed before the job quiesces is
    only caught if it persists.  ``strict=True`` (the post-drain final
    sweep, where every tracked eval is terminal) counts every surplus
    as overplacement."""
    live_by_job: Dict[str, list] = {}
    usage: Dict[str, Tuple[int, int]] = {}
    live_by_ns: Dict[str, int] = {}
    for a in state.allocs(None):
        if a.terminal_status():
            continue
        live_by_job.setdefault(a.job_id, []).append(a)
        ns = a.namespace or "default"
        live_by_ns[ns] = live_by_ns.get(ns, 0) + 1
        res = a.resources
        if res is not None:
            cpu, mem = usage.get(a.node_id, (0, 0))
            usage[a.node_id] = (cpu + res.cpu, mem + res.memory_mb)
    checked = overplaced = dup_names = reconciling = 0
    detail: List[str] = []
    jobs = (state.jobs(None) if job_ids is None
            else [state.job_by_id(None, jid) for jid in job_ids])
    for job in jobs:
        if job is None or job.stop:
            continue
        checked += 1
        allocs = live_by_job.get(job.id, [])
        want = sum(tg.count for tg in job.task_groups)
        if len(allocs) > want:
            # A job UPDATE that lowered the count leaves surplus live
            # allocs until its eval reconciles them away — that is a
            # scale-down IN PROGRESS, not a double placement, exactly
            # while a non-terminal eval for the job exists (the chaos
            # plane stretches that window by killing the worker holding
            # the eval; redelivery closes it).  No pending eval and
            # still surplus ⇒ the real thing.
            if not strict and any(not e.terminal_status()
                                  for e in state.evals_by_job(None, job.id)):
                reconciling += 1
            else:
                overplaced += 1
                detail.append(f"job {job.id}: {len(allocs)} live > {want}")
        if len({a.name for a in allocs}) != len(allocs):
            dup_names += 1
            detail.append(f"job {job.id}: duplicate alloc names")
    overcommitted = 0
    for node in state.nodes(None):
        cpu, mem = usage.get(node.id, (0, 0))
        res_cpu = node.resources.cpu - (node.reserved.cpu
                                        if node.reserved else 0)
        res_mem = node.resources.memory_mb - (
            node.reserved.memory_mb if node.reserved else 0)
        if cpu > res_cpu or mem > res_mem:
            overcommitted += 1
            detail.append(f"node {node.id}: {cpu}/{res_cpu} cpu "
                          f"{mem}/{res_mem} mem")
    # Tenant quota invariant: no namespace's committed live
    # allocs may exceed its registered quota.  Live (non-strict) sweeps
    # excuse a tenant that still has a non-terminal eval — a scale-down
    # or replacement in flight lawfully overlaps old and new allocs for
    # a beat; the strict post-drain sweep excuses nothing.
    tenant_quota = 0
    pending_ns: Optional[Set[str]] = None
    for row in state.namespaces(None):
        if row.max_live_allocs <= 0:
            continue
        live = live_by_ns.get(row.name, 0)
        if live <= row.max_live_allocs:
            continue
        if not strict:
            if pending_ns is None:
                pending_ns = {e.namespace or "default"
                              for e in state.evals(None)
                              if not e.terminal_status()}
            if row.name in pending_ns:
                continue
        tenant_quota += 1
        detail.append(f"namespace {row.name}: {live} live allocs > "
                      f"quota {row.max_live_allocs}")
    return {"jobs_checked": checked,
            "overplaced_jobs": overplaced,
            "reconciling_jobs": reconciling,
            "duplicate_alloc_names": dup_names,
            "overcommitted_nodes": overcommitted,
            "tenant_quota_violations": tenant_quota,
            "detail": detail[:10]}


def federated_sweep(states_by_region: Dict[str, object],
                    strict: bool = False) -> Dict:
    """One federated placement-integrity pass over every region's state
    snapshot (auditor.py:146): regions are independent fault domains, so the
    cross-region invariant is OWNERSHIP — a job must never hold live
    allocs in more than one region (a double place across the
    federation), and each region must pass its own single-region
    ``integrity_sweep`` besides."""
    live_regions: Dict[str, List[str]] = {}
    per_region: Dict[str, Dict] = {}
    for region, state in sorted(states_by_region.items()):
        seen = set()
        for a in state.allocs(None):
            if not a.terminal_status():
                seen.add(a.job_id)
        for jid in seen:
            live_regions.setdefault(jid, []).append(region)
        per_region[region] = integrity_sweep(state, strict=strict)
    cross = sorted(jid for jid, rs in live_regions.items() if len(rs) > 1)
    detail = [f"job {jid}: live allocs in {live_regions[jid]}"
              for jid in cross[:10]]
    return {"regions": per_region,
            "cross_region_double_placed": len(cross),
            "jobs_with_live_allocs": len(live_regions),
            "detail": detail}


class FederatedAuditor:
    """Continuous federated safety sweeps (auditor.py:173) over a set of
    IN-PROCESS region servers: the cross-region ownership invariant
    (``federated_sweep``), each region's own integrity invariants, a
    per-region FSM-digest history (any raft index that ever maps to two
    different digests within one region is state divergence — asserted
    straight through partition and heal), and the lost-acked-eval audit
    per region at finalize.  Violations accumulate exactly like
    :class:`SafetyAuditor`'s; a run is healthy iff
    ``violation_count == 0``."""

    FP_HISTORY = 1024

    def __init__(self, servers: Dict[str, object], interval: float = 1.0,
                 logger: Optional[logging.Logger] = None):
        self.servers = dict(servers)      # region -> in-process Server
        self.interval = interval
        self.logger = logger or logging.getLogger("nomad_tpu_torch.fedauditor")
        self._stop = threading.Event()
        self._l = threading.Lock()
        self._t0 = time.monotonic()
        self._thread: Optional[threading.Thread] = None
        self.violations: List[Dict] = []
        # region -> {index -> {fingerprint}}
        self._fps: Dict[str, Dict[int, Set[str]]] = {
            r: {} for r in self.servers}
        # region -> acked eval ids (fed by the harness trackers)
        self.acked: Dict[str, Set[str]] = {r: set() for r in self.servers}
        self.counts = {"sweeps": 0, "fingerprint_samples": 0,
                       "cross_region_checks": 0}

    def start(self) -> None:
        self._t0 = time.monotonic()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fed-audit")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def note_acked(self, region: str, eval_id: str) -> None:
        with self._l:
            self.acked.setdefault(region, set()).add(eval_id)

    def _violate(self, kind: str, detail: str) -> None:
        v = {"t": round(time.monotonic() - self._t0, 3), "kind": kind,
             "detail": detail}
        with self._l:
            self.violations.append(v)
        blackbox.note_trigger("auditor.violation", v)
        self.logger.error("FED AUDIT VIOLATION %s: %s", kind, detail)

    def _note_fingerprint(self, region: str, index: int, fp: str) -> None:
        with self._l:
            hist = self._fps.setdefault(region, {})
            bucket = hist.setdefault(index, set())
            bucket.add(fp)
            if len(bucket) > 1:
                self._violate(
                    "fsm_digest_instability",
                    f"region {region}: index {index} maps to "
                    f"{len(bucket)} distinct digests")
            self.counts["fingerprint_samples"] += 1
            if len(hist) > self.FP_HISTORY:
                for idx in sorted(hist)[:len(hist) - self.FP_HISTORY]:
                    del hist[idx]

    def _sweep_once(self, strict: bool = False) -> Dict:
        states = {r: srv.consistent_snapshot()
                  for r, srv in self.servers.items()}
        fed = federated_sweep(states, strict=strict)
        self.counts["sweeps"] += 1
        self.counts["cross_region_checks"] += fed["jobs_with_live_allocs"]
        if fed["cross_region_double_placed"]:
            self._violate(
                "cross_region_double_placement",
                f"{fed['cross_region_double_placed']} "
                f"({'; '.join(fed['detail'])})")
        for region, sweep in fed["regions"].items():
            for key, kind in (("overplaced_jobs", "double_placement"),
                              ("duplicate_alloc_names",
                               "duplicate_alloc_names"),
                              ("overcommitted_nodes", "node_overcommit"),
                              ("tenant_quota_violations",
                               "tenant_quota_exceeded")):
                if sweep[key]:
                    self._violate(
                        kind, f"region {region}: {sweep[key]} "
                              f"({'; '.join(sweep['detail'])})")
        for region, snap in states.items():
            self._note_fingerprint(region, snap.latest_index(),
                                   snap.fingerprint())
        return fed

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._sweep_once()
            except Exception:
                self.logger.exception("federated auditor sweep failed")

    def finalize(self) -> Dict:
        """Stop the live sweeps, run the strict post-drain federated
        sweep and the per-region lost-acked-eval audit, and return the
        report section."""
        self.stop()
        final = self._sweep_once(strict=True)
        lost = checked = 0
        with self._l:
            acked = {r: set(ids) for r, ids in self.acked.items()}
        for region, ids in acked.items():
            state = self.servers[region].state
            for eval_id in ids:
                checked += 1
                ev = state.eval_by_id(None, eval_id)
                if ev is None:
                    continue  # GC'd after terminal — lawful
                if ev.status not in _TERMINAL:
                    lost += 1
                    self._violate(
                        "lost_acked_eval",
                        f"region {region}: eval {eval_id} was acked but "
                        f"rests {ev.status}")
        with self._l:
            violations = list(self.violations)
        return {"violation_count": len(violations),
                "violations": violations[:50],
                "checks": dict(self.counts),
                "final_sweep": final,
                "acked_checked": checked,
                "lost_acked": lost}


class SafetyAuditor:
    """See module docstring.  Violations accumulate as dicts
    ``{"t": wall_offset_s, "kind": ..., "detail": ...}``; a run is
    healthy iff ``violation_count == 0``."""

    # Fingerprint history horizon: (index → {fp → servers}) entries
    # kept for cross-matching.  Old indexes can't recur (indexes are
    # monotonic), so pruning the map is pure memory hygiene.
    FP_HISTORY = 1024

    def __init__(self, server, follower_addrs: List[str] = (),
                 pool=None, interval: float = 1.0,
                 logger: Optional[logging.Logger] = None):
        self.server = server
        self.follower_addrs = list(follower_addrs)
        self.pool = pool if pool is not None else getattr(server, "pool",
                                                          None)
        self.interval = interval
        self.logger = logger or logging.getLogger("nomad_tpu_torch.auditor")
        self._stop = threading.Event()
        self._l = threading.Lock()
        self._t0 = time.monotonic()
        self._threads: List[threading.Thread] = []
        self.violations: List[Dict] = []
        # fingerprint history: index -> {fingerprint -> set(server)}
        self._fps: Dict[int, Dict[str, Set[str]]] = {}
        self._last_applied: Dict[str, int] = {}
        self._last_event_index: Dict[str, int] = {}
        self._event_cursor: Dict[str, int] = {}
        self.acked: Set[str] = set()
        self.terminal_events: Set[str] = set()
        self.counts = {"sweeps": 0, "fingerprint_samples": 0,
                       "fingerprint_matches": 0, "events_seen": 0,
                       "follower_events_seen": 0, "follower_polls": 0,
                       "unreachable_polls": 0, "fault_fires": 0}

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._t0 = time.monotonic()
        for target, name in ((self._event_loop, "audit-events"),
                             (self._sweep_loop, "audit-sweep")):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)

    def note_restart(self, addr: str) -> None:
        """A server at ``addr`` was crash-restarted: volatile state
        (applied index, event ring) lawfully regresses across the
        restart — reset the per-incarnation monotonicity baselines so
        recovery is not misread as regression.  The fingerprint history
        is KEPT: the restarted server re-applies the same committed
        prefix and must reproduce the same digests."""
        with self._l:
            self._last_applied.pop(addr, None)
            self._last_event_index.pop(addr, None)
            self._event_cursor.pop(addr, None)

    def _violate(self, kind: str, detail: str) -> None:
        v = {"t": round(time.monotonic() - self._t0, 3), "kind": kind,
             "detail": detail}
        with self._l:
            self.violations.append(v)
        blackbox.note_trigger("auditor.violation", v)
        self.logger.error("AUDIT VIOLATION %s: %s", kind, detail)

    # -- leader event stream -----------------------------------------------

    def _event_loop(self) -> None:
        sub = self.server.event_stream_subscribe(topics=None)
        last_index = 0
        try:
            while not self._stop.is_set():
                ev = sub.next(timeout=0.2)
                if ev is None:
                    if sub.closed:
                        # Shed as a lagging subscriber under burst load:
                        # re-attach rather than silently going blind
                        # (monotonicity restarts from the new horizon).
                        sub.close()
                        sub = self.server.event_stream_subscribe(
                            topics=None)
                        last_index = 0
                        self.counts["event_resubscribes"] = (
                            self.counts.get("event_resubscribes", 0) + 1)
                    continue
                self.counts["events_seen"] += 1
                if ev.index < last_index:
                    self._violate(
                        "event_index_regression",
                        f"leader event {ev.topic}/{ev.type} index "
                        f"{ev.index} < {last_index}")
                last_index = max(last_index, ev.index)
                if ev.topic == "Eval" and ev.type == "EvalAcked":
                    with self._l:
                        self.acked.add(ev.key)
                elif ev.topic == "Eval" and ev.type == "EvalUpdated":
                    status = (ev.payload or {}).get("Status", "")
                    if status in _TERMINAL:
                        with self._l:
                            self.terminal_events.add(ev.key)
                elif ev.topic == "Fault":
                    self.counts["fault_fires"] += 1
        finally:
            sub.close()

    # -- periodic cross-checks ---------------------------------------------

    def _note_fingerprint(self, who: str, index: int, fp: str,
                          applied: Optional[int] = None) -> None:
        """Record one (index → digest) sample; ``applied`` additionally
        feeds the per-incarnation monotonicity check — pass None when
        the caller has no fresh raft applied index (the converged
        cross-check only knows the state-write index, which lawfully
        trails it; feeding that in would fabricate a regression)."""
        with self._l:
            prev = self._last_applied.get(who)
            if applied is not None:
                if prev is not None and applied < prev:
                    self._violate(
                        "applied_index_regression",
                        f"{who}: applied index {applied} < {prev} without "
                        "a recorded restart")
                self._last_applied[who] = max(applied, prev or 0)
            bucket = self._fps.setdefault(index, {})
            bucket.setdefault(fp, set()).add(who)
            if len(bucket) > 1:
                self._violate(
                    "fsm_divergence",
                    f"index {index} maps to {len(bucket)} distinct "
                    f"fingerprints across "
                    f"{sorted(set().union(*bucket.values()))}")
            elif len(next(iter(bucket.values()))) > 1:
                self.counts["fingerprint_matches"] += 1
            self.counts["fingerprint_samples"] += 1
            if len(self._fps) > self.FP_HISTORY:
                for idx in sorted(self._fps)[:len(self._fps)
                                             - self.FP_HISTORY]:
                    del self._fps[idx]

    def _poll_follower(self, addr: str) -> None:
        self.counts["follower_polls"] += 1
        try:
            fp = self.pool.call(addr, "Status.Fingerprint", {},
                                timeout=5.0)
        except Exception:
            # Dead (mid-restart) or wedged: absence of an answer is not
            # divergence — counted so the report shows audit coverage.
            self.counts["unreachable_polls"] += 1
            return
        self._note_fingerprint(addr, int(fp["Index"]),
                               str(fp["Fingerprint"]),
                               int(fp.get("AppliedIndex", 0)))
        try:
            reply = self.pool.call(
                addr, "Event.Since",
                {"MinIndex": self._event_cursor.get(addr, 0), "Max": 512},
                timeout=5.0)
        except Exception:
            self.counts["unreachable_polls"] += 1
            return
        last = self._last_event_index.get(addr, 0)
        for ev in reply.get("Events") or []:
            idx = int(ev.get("Index", 0))
            if idx < last:
                self._violate(
                    "event_index_regression",
                    f"{addr}: event index {idx} < {last}")
            last = max(last, idx)
            self.counts["follower_events_seen"] += 1
        self._last_event_index[addr] = last
        self._event_cursor[addr] = max(self._event_cursor.get(addr, 0),
                                       last)

    def _sweep_once(self) -> None:
        snap = self.server.consistent_snapshot()
        sweep = integrity_sweep(snap)
        self.counts["sweeps"] += 1
        for key, kind in (("overplaced_jobs", "double_placement"),
                          ("duplicate_alloc_names", "duplicate_alloc_names"),
                          ("overcommitted_nodes", "node_overcommit"),
                          ("tenant_quota_violations",
                           "tenant_quota_exceeded")):
            if sweep[key]:
                self._violate(kind,
                              f"{sweep[key]} ({'; '.join(sweep['detail'])})")
        self._note_fingerprint("leader", snap.latest_index(),
                               snap.fingerprint(),
                               self.server.raft.applied_index_relaxed())
        for addr in self.follower_addrs:
            if self._stop.is_set():
                return
            self._poll_follower(addr)

    def _sweep_loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._sweep_once()
            except Exception:
                self.logger.exception("auditor sweep failed")

    # -- finalize ----------------------------------------------------------

    def _converged_crosscheck(self, wait_s: float) -> Dict:
        """Post-drain: wait for every follower to reach the leader's
        committed prefix, then compare digests at the SAME index — the
        guaranteed divergence check."""
        leader_index, leader_fp = self.server.fsm_fingerprint()
        deadline = time.monotonic() + wait_s
        pending = dict.fromkeys(self.follower_addrs)
        while pending and time.monotonic() < deadline:
            for addr in [a for a, v in pending.items() if v is None]:
                try:
                    fp = self.pool.call(addr, "Status.Fingerprint", {},
                                        timeout=5.0)
                except Exception:
                    continue
                if int(fp["Index"]) >= leader_index:
                    pending[addr] = (int(fp["Index"]),
                                     str(fp["Fingerprint"]))
            if all(v is not None for v in pending.values()):
                break
            time.sleep(0.25)
        out = {"leader_index": leader_index, "converged": 0,
               "unconverged": []}
        for addr, got in pending.items():
            if got is None:
                out["unconverged"].append(addr)
                self._violate(
                    "no_final_convergence",
                    f"{addr} never reached leader index {leader_index} "
                    f"within {wait_s}s")
                continue
            idx, fp = got
            if idx == leader_index and fp != leader_fp:
                self._violate(
                    "fsm_divergence",
                    f"{addr} digest differs from leader at index {idx}")
            elif idx == leader_index:
                out["converged"] += 1
                self.counts["fingerprint_matches"] += 1
            else:
                # Moved past the leader's sample (late writes, e.g. a
                # trailing heartbeat): feed the history matcher only —
                # no fresh applied index in hand here.
                self._note_fingerprint(addr, idx, fp)
                out["converged"] += 1
        return out

    def finalize(self, converge_wait_s: float = 15.0) -> Dict:
        """Stop the live threads, run the converged cross-check and the
        acked-eval audit, and return the report section."""
        self.stop()
        final_sweep = integrity_sweep(self.server.consistent_snapshot(),
                                      strict=True)
        for key, kind in (("overplaced_jobs", "double_placement"),
                          ("duplicate_alloc_names", "duplicate_alloc_names"),
                          ("overcommitted_nodes", "node_overcommit"),
                          ("tenant_quota_violations",
                           "tenant_quota_exceeded")):
            if final_sweep[key]:
                self._violate(
                    kind, f"final sweep: {final_sweep[key]} "
                          f"({'; '.join(final_sweep['detail'])})")
        converged = (self._converged_crosscheck(converge_wait_s)
                     if self.follower_addrs else {})
        state = self.server.state
        with self._l:
            acked = set(self.acked)
        lost = 0
        for eval_id in acked:
            ev = state.eval_by_id(None, eval_id)
            if ev is None:
                continue  # GC'd after terminal — lawful
            if ev.status not in _TERMINAL:
                lost += 1
                self._violate(
                    "lost_acked_eval",
                    f"eval {eval_id} was acked but rests {ev.status}")
        return self.report(final_sweep=final_sweep, converged=converged,
                           acked_checked=len(acked), lost_acked=lost)

    def report(self, **extra) -> Dict:
        with self._l:
            violations = list(self.violations)
        out = {
            "violation_count": len(violations),
            "violations": violations[:50],
            "checks": dict(self.counts),
        }
        out.update(extra)
        return out
