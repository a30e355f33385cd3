"""The port's job version history and deployment table
(``nomad_tpu_torch/state/state_store.py``) against the JAX package's
(``nomad_tpu/state/state_store.py:45``, ``:737-825``, ``:1458-1553``),
twins of ``tests/test_deployments.py``.

The same seeded sequence of store operations (job registrations that
bump versions, job deletes, deployment upserts with and without
``cancel_prior``, status updates, deletes) runs on a reference store and
on a port store, and every read is compared as plain data, the
reference-only fields (``Job.vault_token`` and the like) removed from
the reference's side: ``job_versions_by_id``, ``job_by_id_and_version``,
``deployment_by_id``, ``deployments``, ``deployments_by_job``,
``latest_deployment_by_job`` and the table indexes.  Snapshots stay
isolated from later writes, and ``persist``/``restore`` (the port's v2
and per-object formats, the reference's own) give back equal tables.
"""
import dataclasses

import jax  # noqa: F401  (kept like the other port tests)
import numpy as np
import pytest

from nomad_tpu import mock as jmock
from nomad_tpu.state import StateStore as JStateStore
from nomad_tpu.state.state_store import JOB_TRACKED_VERSIONS as JTRACKED
from nomad_tpu.state.state_store import WatchSet as JWatchSet
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert
from nomad_tpu_torch.state.state_store import JOB_TRACKED_VERSIONS
from nomad_tpu_torch.state.state_store import StateStore as PStateStore
from nomad_tpu_torch.state.state_store import WatchSet as PWatchSet
from nomad_tpu_torch.structs import structs as ps

SEEDS = [3, 17, 29, 41]


def plain(v):
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return plain(dataclasses.asdict(v))
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    return v


def strip_ref(ref, port):
    """``ref`` restricted to the keys ``port`` has, recursively."""
    if isinstance(ref, dict) and isinstance(port, dict):
        return {k: strip_ref(ref[k], port[k]) for k in port if k in ref}
    if isinstance(ref, list) and isinstance(port, list):
        return [strip_ref(a, b) for a, b in zip(ref, port)]
    return ref


def same(ref, port):
    r, p = plain(ref), plain(port)
    return strip_ref(r, p) == p and (
        not isinstance(r, list) or len(r) == len(p))


def deployment(m, rng, job_id, k):
    return m.Deployment(
        id=f"dep-{job_id}-{k}", job_id=job_id,
        job_version=int(rng.integers(0, 9)),
        job_modify_index=int(rng.integers(1, 99)),
        task_groups={"web": m.DeploymentState(
            desired_total=int(rng.integers(1, 9)),
            placed_allocs=int(rng.integers(0, 5)),
            healthy_allocs=int(rng.integers(0, 3)))},
        status=(m.DEPLOYMENT_STATUS_PAUSED if rng.random() < 0.3
                else m.DEPLOYMENT_STATUS_RUNNING))


def operations(seed, n=60):
    """A seeded list of store operations, each a tuple of its name and
    arguments (package-free: structs are made per package at apply)."""
    rng = np.random.default_rng(seed)
    ops = []
    jobs = [f"job-{i}" for i in range(4)]
    for step in range(n):
        r = rng.random()
        job_id = jobs[int(rng.integers(0, len(jobs)))]
        if r < 0.45:
            ops.append(("job", job_id, int(rng.integers(1, 9)),
                        bool(rng.random() < 0.3)))
        elif r < 0.5:
            ops.append(("delete_job", job_id))
        elif r < 0.75:
            ops.append(("deployment", job_id, step,
                        bool(rng.random() < 0.5), int(rng.integers(0, 2**31))))
        elif r < 0.9:
            ops.append(("status", job_id, int(rng.integers(0, n)),
                        str(rng.choice(["successful", "failed",
                                        "cancelled", "paused"]))))
        else:
            ops.append(("delete_deployment", job_id,
                        int(rng.integers(0, n))))
    return ops


def apply(store, m, ops, ref):
    """Run ``ops`` on ``store`` (structs of module ``m``); the index of
    the last write."""
    index = 0
    made = []
    for op in ops:
        index += 1
        kind = op[0]
        if kind == "job":
            _, job_id, count, stable = op
            job = jmock.job()
            job.id = job.name = job_id
            job.task_groups[0].count = count
            job.stable = stable
            if not ref:
                job = convert.job_from_dict(dataclasses.asdict(job))
                job.stable = stable
            store.upsert_job(index, job)
        elif kind == "delete_job":
            if store.job_by_id(None, op[1]) is not None:
                store.delete_job(index, op[1])
        elif kind == "deployment":
            _, job_id, step, cancel, dseed = op
            d = deployment(m, np.random.default_rng(dseed), job_id, step)
            made.append(d.id)
            store.upsert_deployment(index, d, cancel_prior=cancel)
        elif kind == "status":
            _, job_id, pick, status = op
            if made:
                store.update_deployment_status(index, m.DeploymentStatusUpdate(
                    deployment_id=made[pick % len(made)], status=status,
                    status_description=f"to {status}"))
        else:
            if made:
                store.delete_deployment(index, made[op[2] % len(made)])
    return index


def reads(store):
    """Every read of the two tables, keyed."""
    job_ids = [f"job-{i}" for i in range(4)]
    out = {"versions": {j: store.job_versions_by_id(None, j)
                        for j in job_ids},
           "by_version": {f"{j}@{v}": store.job_by_id_and_version(None, j, v)
                          for j in job_ids for v in range(12)},
           "deployments": sorted(store.deployments(None),
                                 key=lambda d: d.id),
           "by_job": {j: sorted(store.deployments_by_job(None, j),
                                key=lambda d: d.id) for j in job_ids},
           "latest": {j: store.latest_deployment_by_job(None, j)
                      for j in job_ids},
           "indexes": {t: store.table_index(t)
                       for t in ("jobs", "job_summary", "deployment")}}
    out["by_id"] = {d.id: store.deployment_by_id(None, d.id)
                    for d in out["deployments"]}
    return out


def both(seed):
    ops = operations(seed)
    jst, pst = JStateStore(), PStateStore()
    apply(jst, js, ops, ref=True)
    apply(pst, ps, ops, ref=False)
    return jst, pst, ops


def test_tracked_versions_equal_the_reference():
    assert JOB_TRACKED_VERSIONS == JTRACKED == 6


@pytest.mark.parametrize("seed", SEEDS)
def test_store_operations_equal_the_reference(seed):
    jst, pst, _ = both(seed)
    jr, pr = reads(jst), reads(pst)
    for key in jr:
        assert same(jr[key], pr[key]), key
    # The scenario exercised what it is about.
    assert any(len(v) > 1 for v in pr["versions"].values())
    assert pr["deployments"]
    assert max(len(v) for v in pr["versions"].values()) <= 6


@pytest.mark.parametrize("seed", SEEDS)
def test_cancel_prior_equals_the_reference(seed):
    out = []
    for m, store in ((js, JStateStore()), (ps, PStateStore())):
        rng = np.random.default_rng(seed)
        ds = [deployment(m, np.random.default_rng(seed + k), "job-a", k)
              for k in range(4)]
        ds.append(deployment(m, rng, "job-b", 9))
        for i, d in enumerate(ds):
            store.upsert_deployment(10 + i, d, cancel_prior=(i == 3))
        out.append(reads(store))
        got = {d.id: d.status for d in store.deployments(None)}
        assert got["dep-job-a-3"] in ("running", "paused")
        assert all(got[f"dep-job-a-{k}"] == "cancelled" for k in range(3)
                   if ds[k].active())
        assert got["dep-job-b-9"] == ds[-1].status
    assert same(out[0], out[1])


def test_status_update_of_an_unknown_deployment_is_ignored():
    for m, store in ((js, JStateStore()), (ps, PStateStore())):
        store.update_deployment_status(5, m.DeploymentStatusUpdate(
            deployment_id="nope", status="failed"))
        store.delete_deployment(6, "nope")
        assert store.deployments(None) == []
        assert store.table_index("deployment") == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_snapshot_is_isolated_like_the_reference(seed):
    jst, pst, ops = both(seed)
    jsnap, psnap = jst.snapshot(), pst.snapshot()
    more = operations(seed + 1000, n=20)
    apply(jst, js, more, ref=True)
    apply(pst, ps, more, ref=False)
    assert same(reads(jsnap), reads(psnap))
    assert same(reads(jst), reads(pst))
    # The snapshot still reads the state before the later writes.
    fresh = PStateStore()
    apply(fresh, ps, ops, ref=False)
    assert plain(reads(psnap)) == plain(reads(fresh))


@pytest.mark.parametrize("columnar", [True, False])
@pytest.mark.parametrize("seed", SEEDS)
def test_persist_restore_round_trip_equals_the_reference(seed, columnar):
    ops = operations(seed)
    jst = JStateStore()
    pst = PStateStore(columnar=columnar)
    apply(jst, js, ops, ref=True)
    apply(pst, ps, ops, ref=False)
    blob = pst.persist()
    assert blob.startswith(pst.SNAP2_MAGIC) == columnar
    prest = PStateStore.restore(blob, columnar=columnar)
    jrest = JStateStore.restore(jst.persist())
    assert plain(reads(prest)) == plain(reads(pst))
    assert same(reads(jrest), reads(prest))
    # The restored tables are the persisted ones, field for field.
    assert plain(prest.job_versions) == plain(pst.job_versions)
    assert plain(prest.deployments_table) == plain(pst.deployments_table)
    # A restored store keeps its history going.
    job = convert.job_from_dict(dataclasses.asdict(jmock.job()))
    job.id = job.name = "job-0"
    idx = prest.latest_index() + 1
    prest.upsert_job(idx, job)
    hist = prest.job_versions_by_id(None, "job-0")
    assert hist[0].modify_index == idx
    assert [j.version for j in hist] == sorted(
        (j.version for j in hist), reverse=True)


def test_delete_job_drops_its_history():
    for m, store, ref in ((js, JStateStore(), True),
                          (ps, PStateStore(), False)):
        for i in range(8):
            apply(store, m, [("job", "job-0", i + 1, i == 2)], ref)
        hist = store.job_versions_by_id(None, "job-0")
        assert [j.version for j in hist] == [0, 0, 0, 0, 0, 0][:len(hist)] \
            or [j.version for j in hist] == list(range(7, 1, -1))
        assert store.job_by_id_and_version(None, "job-0", 1) is None
        assert store.job_by_id_and_version(None, "job-0", 7).version == 7
        store.delete_job(99, "job-0")
        assert store.job_versions_by_id(None, "job-0") == []


@pytest.mark.parametrize("table,write", [
    ("deployment", "deployment"), ("jobs", "job")])
def test_blocking_query_watch_fires(table, write):
    for m, store, ws, ref in ((js, JStateStore(), JWatchSet(), True),
                              (ps, PStateStore(), PWatchSet(), False)):
        if table == "deployment":
            store.deployments_by_job(ws, "job-0")
        else:
            store.job_versions_by_id(ws, "job-0")
        op = (("deployment", "job-0", 1, False, 5) if write == "deployment"
              else ("job", "job-0", 2, False))
        apply(store, m, [op], ref)
        # watch() answers False once a watched table moved.
        assert ws.watch(timeout=2.0) is False


def test_deployment_events_equal_the_reference():
    """With an event broker attached, the deployment writes publish the
    reference's events (topic, type, key, index, payload)."""
    from nomad_tpu.server.event_broker import EventBroker as JBroker
    from nomad_tpu_torch.server.event_broker import EventBroker as PBroker

    out = []
    for m, store, broker in ((js, JStateStore(), JBroker()),
                             (ps, PStateStore(), PBroker())):
        store.event_broker = broker
        sub = broker.subscribe()
        rng = np.random.default_rng(5)
        a = deployment(m, rng, "job-0", 1)
        b = deployment(m, rng, "job-0", 2)
        a.status = b.status = m.DEPLOYMENT_STATUS_RUNNING
        store.upsert_deployment(3, a)
        store.upsert_deployment(4, b, cancel_prior=True)
        store.update_deployment_status(5, m.DeploymentStatusUpdate(
            deployment_id=b.id, status="successful"))
        evs = []
        while True:
            ev = sub.next(0.2)
            if ev is None:
                break
            evs.append((ev.topic, ev.type, ev.key, ev.index, ev.payload))
        out.append(evs)
    assert out[0] == out[1]
    assert [e[1] for e in out[1]] == [
        "DeploymentUpserted", "DeploymentUpserted",
        "DeploymentStatusUpdated", "DeploymentStatusUpdated"]
