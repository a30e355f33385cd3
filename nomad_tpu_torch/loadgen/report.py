"""Report rendering and persistence for load-harness runs (a copy of
``nomad_tpu/loadgen/report.py``).

The JSON report is the machine contract; ``render_report`` is the human
summary printed to stderr, line for line the reference's for the same
report of a struct-codec run, the chaos and federated sections
included.  The port has one codec, so no residue of another is
rendered; the
port's ``server`` section (the worker and the device) is rendered after
the scenario line.
"""
from __future__ import annotations

import json
from typing import Dict, TextIO


def write_report(report: Dict, path: str) -> None:
    with open(path, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True)
        fh.write("\n")


def render_report(report: Dict, out: TextIO) -> None:
    if report.get("compare") == "wal":  # compare_wal shape
        out.write(f"== loadgen WAL compare: {report['scenario']} ==\n")
        for k in ("wal_off", "wal_on"):
            out.write(f"  {k}: {report['evals_per_s'][k]} evals/s, "
                      f"plan.apply p99={report['plan_apply_p99_ms'][k]}ms\n")
        fs = report.get("plan_apply_fsync") or {}
        if fs:
            out.write(f"  plan_apply_fsync ms: p50={fs.get('p50')} "
                      f"p99={fs.get('p99')} (n={fs.get('count')})\n")
        for k, run in report["runs"].items():
            out.write(f"-- {k} --\n")
            _render_single(run, out, indent="  ")
        return
    if report.get("compare") == "servers":  # compare_servers shape
        out.write(f"== loadgen scale-out compare: {report['scenario']} "
                  f"({report['num_servers']} servers x "
                  f"M={report['workers_per_server']}) ==\n")
        for k, rate in report["evals_per_s"].items():
            out.write(f"  {k}: sustained {rate} evals/s\n")
        out.write(f"  speedup: {report['speedup']}x, double placements: "
                  f"{report['double_placements']}, plan conflicts: "
                  f"{report['plan_conflicts']}\n")
        pf = report.get("plan_forward") or {}
        if pf:
            out.write(f"  plan-forward: {pf.get('forwarded_total')} plans "
                      f"across {pf.get('servers')} followers, rtt p99 "
                      f"{pf.get('rtt_p99_ms_max')}ms, "
                      f"{pf.get('lag_handbacks_total')} lag handbacks\n")
        for k, run in report["runs"].items():
            out.write(f"-- {k} --\n")
            _render_single(run, out, indent="  ")
        return
    if "worker_counts" in report:  # compare_workers shape
        out.write(f"== loadgen compare: {report['scenario']} "
                  f"workers={report['worker_counts']} ==\n")
        for m, rate in report["evals_per_s"].items():
            out.write(f"  M={m}: sustained {rate} evals/s\n")
        out.write(f"  speedup: {report['speedup']}x\n")
        for m, run in report["runs"].items():
            out.write(f"-- M={m} --\n")
            _render_single(run, out, indent="  ")
        return
    if "federation" in report:  # multi_region shape
        _render_federation(report, out)
        return
    _render_single(report, out)


def _render_federation(r: Dict, out: TextIO) -> None:
    sc = r["scenario"]
    off = r["offered"]
    sus = r["sustained"]
    fed = r["federation"]

    def w(line: str) -> None:
        out.write(line + "\n")

    w(f"== loadgen federation: {sc['name']} — {len(fed['regions'])} regions "
      f"({', '.join(fed['regions'])}), {fed['nodes_per_region']} nodes each, "
      f"{sc['num_clients']} region-homed clients @ {sc['arrival_rate']}/s ==")
    w(f"offered: {off['submitted']} submitted "
      f"({fed['cross_submitted']} cross-region), "
      f"{off['dropped_after_retries']} dropped, "
      f"{off['admission_rejects_seen']} 429s, "
      f"{off['no_path_events']} NoPathToRegion NACKs "
      f"({off['no_path_drops']} gave up)")
    w(f"sustained: {sus['evals_per_s']} evals/s, {sus['placed_per_s']} "
      f"placed/s ({sus['stragglers_after_drain']} stragglers)")
    s2r = r["latency_ms"]["submit_to_running"]
    w(f"submit→running ms: p50={s2r['p50']} p95={s2r['p95']} "
      f"p99={s2r['p99']} (n={s2r['count']})")
    tax = fed["forward_tax_ms"]
    w(f"forward tax ms (submit): local p50={tax['local']['p50']} "
      f"p99={tax['local']['p99']} | cross p50={tax['cross']['p50']} "
      f"p99={tax['cross']['p99']} (n={tax['cross']['count']})")
    reads = fed["reads_ms"]
    w(f"reads ms: local p50={reads['local']['p50']} "
      f"p99={reads['local']['p99']} | cross p50={reads['cross']['p50']} "
      f"p99={reads['cross']['p99']} "
      f"({fed['read_no_path_events']} dark-region read NACKs)")
    for region, pr in fed["per_region"].items():
        w(f"  {region}: {pr['submitted']} submitted "
          f"({pr['cross_in']} forwarded in), {pr['completed']} completed, "
          f"{pr['placed']} placed")
    bo = fed.get("blackout") or {}
    if bo:
        w(f"blackout: region {bo.get('region')} dark "
          f"{bo.get('duration_s')}s @ {bo.get('at_s')}s — "
          f"{'RECOVERED' if bo.get('recovered') else 'NOT RECOVERED'} "
          f"(registered {bo.get('registered_after_heal_s')}s, placed "
          f"{bo.get('placed_after_heal_s')}s after heal, "
          f"{bo.get('probe_attempts')} probes, "
          f"bound {bo.get('recovery_bound_s')}s)")
    agg = fed.get("aggregator") or {}
    if agg:
        w(f"aggregator: {agg.get('Events')} events over "
          f"{agg.get('Polls')} polls, {agg.get('Unreachable')} "
          f"dark-region skips, cursors={agg.get('Cursors')}")
    aud = r.get("auditor") or {}
    if aud:
        checks = aud.get("checks") or {}
        w(f"federated auditor: {aud.get('violation_count')} violations — "
          f"{checks.get('sweeps')} sweeps, "
          f"{checks.get('cross_region_checks')} cross-region checks, "
          f"{checks.get('fingerprint_samples')} fingerprint samples, "
          f"{aud.get('acked_checked', 0)} acked evals audited "
          f"({aud.get('lost_acked', 0)} lost)")
        for v in (aud.get("violations") or [])[:8]:
            w(f"  VIOLATION +{v['t']}s {v['kind']}: {v['detail']}")


def _render_single(r: Dict, out: TextIO, indent: str = "") -> None:
    sc = r["scenario"]
    off = r["offered"]
    sus = r["sustained"]
    lat = r["latency_ms"]
    cp = r["control_plane"]

    def w(line: str) -> None:
        out.write(indent + line + "\n")

    w(f"scenario {sc['name']}: {sc['num_nodes']} nodes, "
      f"{sc['num_clients']} clients @ {sc['arrival_rate']}/s, "
      f"M={sc['num_workers']} workers"
      + (" (batch)" if sc["use_tpu_batch_worker"] else ""))
    srv = r.get("server") or {}
    if srv:
        w(f"server: {srv['worker']} workers on {srv['device']}")
    w(f"offered: {off['submitted']} submitted, "
      f"{off['dropped_after_retries']} dropped, "
      f"{off['admission_rejects_seen']} 429s")
    w(f"sustained: {sus['evals_per_s']} evals/s, "
      f"{sus['placed_per_s']} placed/s over {sus['window_s']}s "
      f"({sus['stragglers_after_drain']} stragglers)")
    s2r = lat["submit_to_running"]
    w(f"submit→running ms: p50={s2r['p50']} p95={s2r['p95']} "
      f"p99={s2r['p99']} (n={s2r['count']})")
    pa = lat.get("plan_apply") or {}
    if pa:
        w(f"plan.apply ms: p50={pa.get('p50')} p99={pa.get('p99')}")
    fs = lat.get("plan_apply_fsync") or {}
    if fs:
        w(f"plan.apply fsync ms: p50={fs.get('p50')} p99={fs.get('p99')} "
          f"(n={fs.get('count')})")
    w(f"plan conflicts: {cp['plan_conflicts']}, snapshot reuse/fresh: "
      f"{cp['snapshot_reuse']}/{cp['snapshot_fresh']}")
    broker = cp["broker"]
    w(f"broker: pending={broker['Pending']} "
      f"coalesced={broker['CoalescedTotal']} shed={broker['ShedTotal']} "
      f"rejects={broker['AdmissionRejects']} "
      f"plan_queue={broker['PlanQueueDepth']}")
    hb = r.get("heartbeat") or {}
    if hb.get("renewals"):
        w(f"heartbeats: {hb['renewals']} renewals, "
          f"{hb['distinct_ttls']} distinct TTLs in "
          f"[{hb['ttl_min']}, {hb['ttl_max']}]")
    fo = r.get("event_fanout") or {}
    if fo:
        w(f"event fan-out: {fo['us_per_event']}us/event @ "
          f"{fo['subscribers']} filtered subscribers")
    # The port has one codec: its frames are always the struct codec's.
    cd = r.get("codec") or {}
    for sub in ("rpc", "raft", "snapshot"):
        d = cd.get(sub)
        if d:
            w(f"codec[{sub}]: encode {d['encode_s']}s/"
              f"{d['encodes']} frames, decode {d['decode_s']}s/"
              f"{d['decodes']} frames, {d['fallbacks']} fallbacks "
              "(struct-codec)")
    integ = r.get("integrity") or {}
    if integ:
        w(f"integrity: {integ['jobs_checked']} jobs checked, "
          f"overplaced={integ['overplaced_jobs']} "
          f"dup_names={integ['duplicate_alloc_names']} "
          f"overcommitted_nodes={integ['overcommitted_nodes']}"
          + (f" tenant_quota={integ['tenant_quota_violations']}"
             if "tenant_quota_violations" in integ else ""))
    ten = r.get("tenancy") or {}
    if ten:
        w(f"tenancy: {ten['tenants']} tenants "
          f"({ten['abusive_tenants']} abusive, "
          f"objective={ten['objective']}), "
          f"{ten['active_tenants_in_broker']} active in broker, "
          f"quota violations={ten['quota_violations']}")
        for c in ("abuser", "compliant"):
            lat = ten["latency_ms"][c]
            w(f"  {c}: {ten['accepted'][c]} accepted "
              f"({ten['lost_accepted'][c]} lost), "
              f"{ten['rejects_429'][c]} 429s, "
              f"{ten['dropped_after_retries'][c]} dropped — "
              f"done ms p50={lat['p50']} p99={lat['p99']}")
    ha = r.get("host_attribution") or {}
    if ha:
        top = ", ".join(f"{k}={v:.0%}" for k, v in
                        (ha.get("top_subsystems") or []))
        gil = ha.get("gil_pressure_ms") or {}
        w(f"host attribution: {ha.get('thread_samples')} thread-samples "
          f"@ {ha.get('hz')}Hz, coverage={ha.get('non_idle_coverage'):.0%}"
          f" — {top}")
        w(f"  gil pressure ms: p50={gil.get('p50')} p99={gil.get('p99')} "
          f"(n={gil.get('count')})")
        for lk in (ha.get("top_locks") or [])[:5]:
            w(f"  lock {lk['name']}: {lk['count']} waits, "
              f"{lk['wait_s_sum']}s total, p99={lk['p99_ms']}ms")
    for f in r.get("follower_servers", []):
        if "error" in f:
            w(f"follower {f['addr']}: stats unavailable ({f['error']})")
            continue
        rtt = f.get("plan_forward_rtt_ms") or {}
        lag = f.get("snapshot_lag_entries") or {}
        w(f"follower {f['addr']}: {f['evals_scheduled']} evals scheduled, "
          f"{f['forwarded_plans']} plans forwarded "
          f"(rtt p50={rtt.get('p50')} p99={rtt.get('p99')}ms), "
          f"snapshot lag p95={lag.get('p95')} entries, "
          f"{f['lag_handbacks']} lag handbacks")
    chaos = r.get("chaos") or {}
    if chaos:
        rec = chaos.get("recovery_s") or {}
        w(f"chaos: {len(chaos.get('events', []))} events "
          f"({chaos.get('recovered')} recovered, "
          f"{chaos.get('unrecovered')} unrecovered, "
          f"{chaos.get('censored')} censored) — recovery p50={rec.get('p50')}s "
          f"p90={rec.get('p90')}s max={rec.get('max')}s "
          f"(bound {chaos.get('recovery_bound_s')}s)")
        for ev in chaos.get("events", []):
            w(f"  {ev.get('kind'):>9} @ {ev.get('at_s')}s {ev.get('target_addr', '')}"
              f" pre={ev.get('pre_rate_placed_per_s')}/s"
              f" recovery={ev.get('recovery_s')}s"
              + (f" [{ev['note']}]" if ev.get("note") else "")
              + (f" ERROR {ev['error']}" if ev.get("error") else ""))
    aud = r.get("auditor") or {}
    if aud:
        checks = aud.get("checks") or {}
        w(f"auditor: {aud.get('violation_count')} violations — "
          f"{checks.get('sweeps')} sweeps, "
          f"{checks.get('fingerprint_samples')} fingerprint samples "
          f"({checks.get('fingerprint_matches')} cross-server matches), "
          f"{aud.get('acked_checked', 0)} acked evals audited, "
          f"{checks.get('events_seen')} leader + "
          f"{checks.get('follower_events_seen')} follower events")
        for v in (aud.get("violations") or [])[:8]:
            w(f"  VIOLATION +{v['t']}s {v['kind']}: {v['detail']}")
    for tr in r.get("slow_tail_traces", []):
        w(f"slow tail: {tr['submit_to_running_ms']}ms {tr['trace']}")
