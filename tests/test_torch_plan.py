"""The ``job plan`` dry run in the port against the JAX reference.

- Annotate-plan evals: ``TorchBatchScheduler(device="cpu")`` against the
  reference's ``TPUBatchScheduler`` (its own breaker, ``oracle_routed ==
  0`` in both), through ``tests/test_torch_sched.py``'s ``Twin``: a fresh
  job (it skips the register fast path), a count change, an in-place and
  a destructive edit with live allocs, and a no-op.  Both worlds' plans,
  plan annotations (``desired_tg_updates``), eval rows and failure
  metrics are compared whole.
- ``Server.job_plan``: the port's ``Server(device="cpu")`` against the
  reference's on the same nodes and jobs (``tests/test_torch_server.py``'s
  ``World``), in the three scenarios of ``tests/test_diff.py`` and for a
  system job: the diff
  (without the reference-only fields), the annotations, the failed
  allocs, ``job_modify_index`` and the created evals, and the store
  untouched by the dry run.
"""
import dataclasses

import jax  # noqa: F401  (the reference computes on the CPU backend)
import pytest

from nomad_tpu import mock as jmock
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert
from nomad_tpu_torch.ops import kernels
from nomad_tpu_torch.scheduler.generic import GenericScheduler
from nomad_tpu_torch.scheduler.testing import Harness
from nomad_tpu_torch.scheduler.annotate import ANNOTATION_FORCES_CREATE
from nomad_tpu_torch.structs.diff import DIFF_TYPE_ADDED, DIFF_TYPE_EDITED
from test_torch_diff import without_ref_only
from test_torch_sched import Twin, bump, make_job, make_node, registered_twin
from test_torch_server import (World, content, running, settle, strip_node,
                               system_job)
from test_torch_server import make_job as server_job


def annotate_eval(t, job):
    ev = t.eval_for(job)
    ev.annotate_plan = True
    return ev


def annotations(plans):
    return [dataclasses.asdict(p.annotations) if p.annotations else None
            for p in plans]


def run_annotated(t, evals, seed=None):
    """One batch through both schedulers; the two worlds' plans, evals and
    failure metrics are held equal by ``Twin.run``, the plans'
    annotations here.  Returns the port's new plans and batch stats."""
    first = len(t.ph.plans)
    kernels.COMMIT_STEPS = 0
    _, pst = t.run(evals, seed=seed)
    assert annotations(t.ph.plans) == annotations(t.jh.plans)
    return t.ph.plans[first:], pst


CASES = ("fresh", "count", "inplace", "destructive", "noop")


@pytest.mark.parametrize("case", CASES)
def test_annotate_plan_evals_match_reference(case, monkeypatch):
    seed = 4100 + CASES.index(case)
    if case == "fresh":
        t = Twin(monkeypatch, seed)
        for _ in range(16):
            t.add_node(make_node(t.rng))
        job = make_job(t.rng, 9)
        t.put_job(job)
        evals = [annotate_eval(t, job)]
        plans, pst = run_annotated(t, evals)
        updates = plans[0].annotations.desired_tg_updates["web"]
        assert updates.place == 9
        # The placements went through the device pass.
        assert pst.device_ran and kernels.COMMIT_STEPS > 0
        return
    t, jobs = registered_twin(monkeypatch, seed)
    job = jobs[1]
    if case == "count":
        new = bump(t, job, lambda j: setattr(j.task_groups[0], "count", 14))
    elif case == "inplace":
        new = bump(t, job, lambda j: j.constraints.append(
            js.Constraint("${attr.arch}", "x86", "=")))
    elif case == "destructive":
        new = bump(t, job, lambda j: setattr(
            j.task_groups[0].tasks[0].resources, "cpu", 400))
    else:
        new = job
    # With one register eval in the same batch, as the server's batches
    # mix them.
    extra = make_job(t.rng, 5)
    t.put_job(extra)
    evals = [annotate_eval(t, new), t.eval_for(extra)]
    plans, pst = run_annotated(t, evals, seed=seed + 1)
    assert pst.device_ran
    by_eval = {p.eval_id: p for p in plans}
    # A no-op annotate eval still submits its plan (batch_sched.py:2312).
    updates = by_eval[evals[0].id].annotations.desired_tg_updates["web"]
    want = {"count": {"place": 5, "in_place_update": 9},
            "inplace": {"in_place_update": 9},
            "destructive": {"destructive_update": 9},
            "noop": {"ignore": 9}}[case]
    assert {k: v for k, v in dataclasses.asdict(updates).items() if v} == want
    assert by_eval[evals[1].id].annotations is None


def test_destructive_edit_on_a_full_fleet_matches_reference(monkeypatch):
    """Neither package's batch path counts an eval's own stops as free
    room: on a full fleet a destructive edit stops every alloc and places
    none of the replacements, in both alike; the CPU oracle places them
    all on the room the stops free."""
    t = Twin(monkeypatch, 4200)
    for i in range(4):
        # 1,900 MHz free a node: three asks of 500.
        t.add_node(strip_node(jmock.node(), f"node-{i}", cpu=2000, mem=4096))
    job = make_job(t.rng, 12, cpu=500)
    t.put_job(job)
    t.run([t.eval_for(job)])
    new = bump(t, job, lambda j: setattr(j.task_groups[0].tasks[0], "env",
                                         {"EDIT": "1"}))
    ev = annotate_eval(t, new)
    plans, _ = run_annotated(t, [ev], seed=4201)
    plan = plans[0]
    assert sum(len(v) for v in plan.node_update.values()) == 12
    assert not plan.node_allocation
    assert not any(sl.ids for sl in plan.alloc_slabs)
    assert plan.annotations.desired_tg_updates["web"].destructive_update == 12
    # The oracle, on the same snapshot.
    h = Harness(t.ph.state.snapshot())
    GenericScheduler(h.logger, h.state, h, batch=False).process(
        convert.eval_from_dict(dataclasses.asdict(ev)))
    assert sum(len(v) for v in h.plans[0].node_allocation.values()) == 12


# -- Server.job_plan -----------------------------------------------------------

def plan_response(resp):
    """A JobPlanResponse as plain data, ids left out of the created
    evals."""
    return {
        "diff": None if resp.diff is None else dataclasses.asdict(resp.diff),
        "annotations": (dataclasses.asdict(resp.annotations)
                        if resp.annotations else None),
        "failed_tg_allocs": {
            tg: {k: v for k, v in dataclasses.asdict(m).items()
                 if k != "allocation_time"}
            for tg, m in resp.failed_tg_allocs.items()},
        "job_modify_index": resp.job_modify_index,
        "created_evals": [(e.job_id, e.triggered_by, e.status,
                           e.status_description, e.class_eligibility,
                           e.escaped_computed_class, e.queued_allocations)
                          for e in resp.created_evals],
        "next_periodic_launch": resp.next_periodic_launch}


def store_view(srv):
    """The store's allocs, evals and blocked stats, the planned job as
    stored, and the log's applied index."""
    job = srv.state.job_by_id(None, "planned")
    return (content(srv), None if job is None else (
        job.job_modify_index, job.version, job.task_groups[0].count),
            srv.raft.applied_index())


def dry_run(world, scenario):
    job = server_job("planned", 10, 500, 256)
    if scenario == "system":
        # A system job: its scheduler is the port's registered ``system``.
        job = system_job("planned")
    for i in range({"no_nodes": 0, "system": 3}.get(scenario, 1)):
        world.node_register(strip_node(jmock.node(), f"node-{i:03d}"))
    if scenario == "update":
        world.wave([job])
        job = job.copy()
        job.task_groups[0].count += 1
    settle(world.srv)
    before = store_view(world.srv)
    resp = world.srv.job_plan(world._obj(job, convert.job_from_dict))
    after = store_view(world.srv)
    return resp, before, after


SCENARIOS = ("dry_run", "no_nodes", "update", "system")


@pytest.fixture(scope="module")
def plan_runs():
    runs = {}
    for scenario in SCENARIOS:
        for kind in ("ref", "port"):
            with pytest.MonkeyPatch.context() as mp:
                with running(World(kind, mp)) as world:
                    runs[scenario, kind] = dry_run(world, scenario)
    return runs


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_job_plan_matches_reference(plan_runs, scenario):
    ref, _, _ = plan_runs[scenario, "ref"]
    port, before, after = plan_runs[scenario, "port"]
    want, got = plan_response(ref), plan_response(port)
    want["diff"] = without_ref_only(want["diff"])
    assert got == want
    # The dry run commits nothing.
    assert after == before
    assert plan_runs[scenario, "ref"][2] == plan_runs[scenario, "ref"][1]


def test_job_plan_scenarios(plan_runs):
    """tests/test_diff.py's server cases, on the port."""
    resp, before, _ = plan_runs["dry_run", "port"]
    assert resp.diff.type == DIFF_TYPE_ADDED
    assert resp.annotations.desired_tg_updates["web"].place == 10
    assert before[1] is None
    resp, _, _ = plan_runs["no_nodes", "port"]
    assert resp.failed_tg_allocs["web"].nodes_evaluated == 0
    resp, _, _ = plan_runs["update", "port"]
    assert resp.diff.type == DIFF_TYPE_EDITED
    assert resp.job_modify_index > 0
    f = next(f for f in resp.diff.task_groups[0].fields if f.name == "Count")
    assert ANNOTATION_FORCES_CREATE in f.annotations
    resp, _, _ = plan_runs["system", "port"]
    assert resp.diff.type == DIFF_TYPE_ADDED
    assert resp.annotations.desired_tg_updates["web"].place == 3
