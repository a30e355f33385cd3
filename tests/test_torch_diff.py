"""The port's job diff and plan annotations (``structs/diff.py``,
``scheduler/annotate.py``) against the JAX package's.

Job pairs are made from ``mock.job()`` of the reference with a seeded
edit, and converted for the port (``dataclasses.asdict`` ->
``convert.job_from_dict``); both diffs are annotated and compared as
dicts.  Fields the port's structs did not carry were removed from the
reference's side only (``REF_ONLY``, empty now that the port carries
every field the reference diffs).  The unit cases of ``tests/test_diff.py`` run below as
port-side twins.
"""
import dataclasses
import random

import jax  # noqa: F401  (kept like the other port tests)
import pytest

from nomad_tpu import mock as jmock
from nomad_tpu.scheduler.annotate import annotate as jannotate
from nomad_tpu.structs import structs as js
from nomad_tpu.structs.diff import job_diff as jjob_diff
from nomad_tpu_torch import convert, mock
from nomad_tpu_torch.scheduler.annotate import (
    ANNOTATION_FORCES_CREATE, ANNOTATION_FORCES_DESTROY,
    ANNOTATION_FORCES_DESTRUCTIVE_UPDATE, ANNOTATION_FORCES_INPLACE_UPDATE,
    UPDATE_TYPE_CREATE, UPDATE_TYPE_DESTROY, annotate)
from nomad_tpu_torch.structs import structs as s
from nomad_tpu_torch.structs.diff import (DIFF_TYPE_ADDED, DIFF_TYPE_DELETED,
                                          DIFF_TYPE_EDITED, DIFF_TYPE_NONE,
                                          go_name, job_diff, task_diff,
                                          task_group_diff)

# The Go names of the reference's fields that the port's structs do not
# carry.  None since the port's jobspec types (restart policies,
# services, kill timeouts, log configs, leaders) are the reference's.
REF_ONLY = frozenset()


def without_ref_only(d):
    """``asdict`` of a reference diff with the ``REF_ONLY`` fields and
    objects removed at every level."""
    if isinstance(d, dict):
        return {k: [without_ref_only(x) for x in v
                    if not (isinstance(x, dict) and x.get("name") in REF_ONLY)]
                if k in ("fields", "objects") else without_ref_only(v)
                for k, v in d.items()}
    if isinstance(d, list):
        return [without_ref_only(x) for x in d]
    return d


def port_job(job):
    return None if job is None else convert.job_from_dict(
        dataclasses.asdict(job))


def both_diffs(old, new, contextual=False, annotations=None):
    """(reference, port) diffs of one pair, annotated, as dicts."""
    want = jjob_diff(old, new, contextual)
    jannotate(want, annotations)
    got = job_diff(port_job(old), port_job(new), contextual)
    annotate(got, None if annotations is None else s.PlanAnnotations(
        desired_tg_updates={k: s.DesiredUpdates(**dataclasses.asdict(v))
                            for k, v in annotations.desired_tg_updates.items()}))
    return without_ref_only(dataclasses.asdict(want)), dataclasses.asdict(got)


def _task(job):
    return job.task_groups[0].tasks[0]


def edit_count(j, rng):
    j.task_groups[0].count += rng.choice([-7, -1, 3, 20])


def edit_env(j, rng):
    t = _task(j)
    t.env = dict(t.env, NEW_VAR=str(rng.random()))
    t.env.pop("FOO", None)


def edit_config(j, rng):
    t = _task(j)
    t.config = {"command": "/bin/other", "args": str(rng.randint(0, 99))}


def edit_meta(j, rng):
    j.meta = {"owner": "someone", "team": str(rng.randint(0, 9))}
    j.task_groups[0].meta = {}
    _task(j).meta = dict(_task(j).meta, extra=str(rng.random()))


def edit_resources(j, rng):
    res = _task(j).resources
    res.cpu += rng.choice([100, 250])
    res.memory_mb *= 2
    res.networks[0].mbits += 10
    res.networks[0].dynamic_ports.append(js.Port("metrics", 0))


def edit_constraints(j, rng):
    j.constraints.append(js.Constraint("${attr.arch}", "x86", "="))
    j.task_groups[0].constraints = [js.Constraint(
        "${meta.rack}", f"r{rng.randint(0, 9)}", "distinct_property")]
    _task(j).constraints = [js.Constraint("${attr.kernel.name}", "linux",
                                          "=")]


def edit_constraint_removed(j, rng):
    j.constraints = []


def edit_datacenters(j, rng):
    j.datacenters = ["dc1", f"dc{rng.randint(2, 9)}"]


def edit_top_fields(j, rng):
    j.priority = rng.randint(1, 100)
    j.all_at_once = True
    j.update = js.UpdateStrategy(stagger=30.0, max_parallel=2)
    j.task_groups[0].ephemeral_disk.size_mb += 1


def edit_tg_added(j, rng):
    extra = j.task_groups[0].copy()
    extra.name = f"extra{rng.randint(0, 9)}"
    j.task_groups.append(extra)


def edit_tg_removed(j, rng):
    extra = j.task_groups[0].copy()
    extra.name = "extra"
    j.task_groups = [extra]


def edit_task_added(j, rng):
    t = _task(j).copy()
    t.name = f"sidecar{rng.randint(0, 9)}"
    t.driver = "docker"
    j.task_groups[0].tasks.append(t)


def edit_task_removed(j, rng):
    _task(j).name = "renamed"


def edit_driver(j, rng):
    _task(j).driver = rng.choice(["raw_exec", "docker"])
    _task(j).user = "nobody"


def edit_vault(j, rng):
    _task(j).vault = js.Vault(policies=["a", f"p{rng.randint(0, 9)}"],
                              change_mode="signal", change_signal="SIGHUP")


def edit_templates(j, rng):
    _task(j).templates = [
        js.Template(source_path="in.tpl", dest_path="out"),
        js.Template(embedded_tmpl=f"{{{{ key \"k{rng.randint(0, 9)}\" }}}}",
                    dest_path="local/x", splay=2.5)]


def edit_artifacts(j, rng):
    _task(j).artifacts = [js.TaskArtifact(
        getter_source="https://example.invalid/a.tgz",
        getter_options={"checksum": f"md5:{rng.randint(0, 99)}"},
        relative_dest="local/")]


EDITS = {f.__name__[len("edit_"):]: f for f in (
    edit_count, edit_env, edit_config, edit_meta, edit_resources,
    edit_constraints, edit_constraint_removed, edit_datacenters,
    edit_top_fields, edit_tg_added, edit_tg_removed, edit_task_added,
    edit_task_removed, edit_driver, edit_vault, edit_templates,
    edit_artifacts)}

# Edits on a job that already holds vault, templates and artifacts (the
# typed-object path, not the empty-list one).
PLAIN_EDITS = ("vault", "templates", "artifacts")


def seeded_pair(kind, seed, with_plain_data=False):
    """A reference job and its copy with the ``kind`` edit; with
    ``with_plain_data`` both first hold vault, templates and artifacts."""
    rng = random.Random(seed)
    old = jmock.job()
    if with_plain_data:
        for name in PLAIN_EDITS:
            EDITS[name](old, rng)
    new = old.copy()
    EDITS[kind](new, rng)
    return old, new


@pytest.mark.parametrize("contextual", [False, True],
                         ids=["plain", "contextual"])
@pytest.mark.parametrize("kind", sorted(EDITS))
def test_job_diff_matches_reference(kind, contextual):
    old, new = seeded_pair(kind, seed=sorted(EDITS).index(kind))
    want, got = both_diffs(old, new, contextual)
    assert got == want
    assert got["type"] == DIFF_TYPE_EDITED
    # And the other way round (adds become deletes).
    want, got = both_diffs(new, old, contextual)
    assert got == want


@pytest.mark.parametrize("kind", PLAIN_EDITS)
def test_plain_data_edits_match_reference(kind):
    """Vault, templates and artifacts edited on a task that has them: the
    reference's ``Vault``/``Template``/``Artifact`` objects."""
    old, new = seeded_pair(kind, seed=77, with_plain_data=True)
    want, got = both_diffs(old, new, contextual=True)
    assert got == want
    want, got = both_diffs(old, new)
    assert got == want
    # One vault is edited in place; list elements match set-wise, so an
    # edited template or artifact is one deleted and one added.
    name, types = {"vault": ("Vault", [DIFF_TYPE_EDITED]),
                   "templates": ("Template", [DIFF_TYPE_ADDED,
                                              DIFF_TYPE_DELETED]),
                   "artifacts": ("Artifact", [DIFF_TYPE_ADDED,
                                              DIFF_TYPE_DELETED])}[kind]
    assert sorted(o["type"] for o in got["task_groups"][0]["tasks"][0][
        "objects"] if o["name"] == name) == types


@pytest.mark.parametrize("direction", ["added", "deleted"])
def test_whole_job_matches_reference(direction):
    job = jmock.job()
    pair = (None, job) if direction == "added" else (job, None)
    for contextual in (False, True):
        want, got = both_diffs(*pair, contextual=contextual)
        assert got == want


def test_annotations_with_desired_updates_match_reference():
    old, new = seeded_pair("count", seed=5)
    ann = js.PlanAnnotations(desired_tg_updates={"web": js.DesiredUpdates(
        ignore=2, place=3, migrate=1, stop=4, in_place_update=5,
        destructive_update=6)})
    want, got = both_diffs(old, new, annotations=ann)
    assert got == want
    assert got["task_groups"][0]["updates"]


def test_different_ids_raise_in_both():
    a, b = jmock.job(), jmock.job()
    with pytest.raises(ValueError):
        jjob_diff(a, b)
    with pytest.raises(ValueError, match="different IDs"):
        job_diff(port_job(a), port_job(b))


# -- the reference's tests/test_diff.py unit cases, port-side ---------------


def test_go_name():
    assert go_name("kill_timeout") == "KillTimeout"
    assert go_name("count") == "Count"
    assert go_name("memory_mb") == "MemoryMB"
    assert go_name("cpu") == "CPU"


def test_identical_jobs_no_diff():
    job = mock.job()
    d = job_diff(job, job.copy())
    assert d.type == DIFF_TYPE_NONE
    assert not d.fields
    assert not d.task_groups


def test_job_added_and_deleted():
    job = mock.job()
    assert job_diff(None, job).type == DIFF_TYPE_ADDED
    assert job_diff(job, None).type == DIFF_TYPE_DELETED


def test_primitive_field_edit():
    old = mock.job()
    new = old.copy()
    new.priority = old.priority + 10
    d = job_diff(old, new)
    assert d.type == DIFF_TYPE_EDITED
    f = next(f for f in d.fields if f.name == "Priority")
    assert f.type == DIFF_TYPE_EDITED
    assert f.old == str(old.priority)
    assert f.new == str(new.priority)


def test_datacenters_set_diff():
    old = mock.job()
    old.datacenters = ["dc1", "dc2"]
    new = old.copy()
    new.datacenters = ["dc1", "dc3"]
    d = job_diff(old, new)
    types = sorted(f.type for f in d.fields if f.name == "Datacenters")
    assert types == [DIFF_TYPE_ADDED, DIFF_TYPE_DELETED]


def test_constraint_added():
    old = mock.job()
    new = old.copy()
    new.constraints = list(new.constraints) + [
        s.Constraint(ltarget="${attr.kernel.name}", rtarget="linux",
                     operand="=")]
    d = job_diff(old, new)
    cons = [o for o in d.objects if o.name == "Constraint"]
    assert any(o.type == DIFF_TYPE_ADDED for o in cons)


def test_task_group_count_change():
    old = mock.job()
    new = old.copy()
    new.task_groups[0].count = old.task_groups[0].count + 2
    d = job_diff(old, new)
    assert len(d.task_groups) == 1
    tg = d.task_groups[0]
    assert tg.type == DIFF_TYPE_EDITED
    f = next(f for f in tg.fields if f.name == "Count")
    assert f.type == DIFF_TYPE_EDITED


def test_task_group_added_removed():
    old = mock.job()
    new = old.copy()
    extra = old.task_groups[0].copy()
    extra.name = "extra"
    new.task_groups.append(extra)
    d = job_diff(old, new)
    assert any(tg.type == DIFF_TYPE_ADDED and tg.name == "extra"
               for tg in d.task_groups)
    d2 = job_diff(new, old)
    assert any(tg.type == DIFF_TYPE_DELETED and tg.name == "extra"
               for tg in d2.task_groups)


def test_task_env_and_config_diff():
    old = mock.job()
    new = old.copy()
    t = new.task_groups[0].tasks[0]
    t.env = dict(t.env)
    t.env["NEW_VAR"] = "x"
    t.config = dict(t.config)
    t.config["command"] = "/bin/other"
    d = job_diff(old, new)
    td = d.task_groups[0].tasks[0]
    assert td.type == DIFF_TYPE_EDITED
    assert any(f.name == "Env[NEW_VAR]" and f.type == DIFF_TYPE_ADDED
               for f in td.fields)
    cfg = next(o for o in td.objects if o.name == "Config")
    assert any(f.name == "Config[command]" for f in cfg.fields)


def test_task_resources_diff():
    old = mock.job()
    new = old.copy()
    new.task_groups[0].tasks[0].resources.cpu += 100
    d = job_diff(old, new)
    td = d.task_groups[0].tasks[0]
    res = next(o for o in td.objects if o.name == "Resources")
    assert res.type == DIFF_TYPE_EDITED
    assert any(f.name == "CPU" for f in res.fields)


def test_task_and_group_diff_of_one_side():
    tg = mock.job().task_groups[0]
    assert task_group_diff(None, tg).type == DIFF_TYPE_ADDED
    assert task_diff(tg.tasks[0], None).type == DIFF_TYPE_DELETED
    assert task_diff(None, None) is None


def test_annotate_count_change():
    old = mock.job()
    new = old.copy()
    new.task_groups[0].count = old.task_groups[0].count + 3
    d = job_diff(old, new)
    annotate(d, None)
    f = next(f for f in d.task_groups[0].fields if f.name == "Count")
    assert ANNOTATION_FORCES_CREATE in f.annotations

    d2 = job_diff(new, old)
    annotate(d2, None)
    f2 = next(f for f in d2.task_groups[0].fields if f.name == "Count")
    assert ANNOTATION_FORCES_DESTROY in f2.annotations


def test_annotate_updates_map():
    old = mock.job()
    new = old.copy()
    new.task_groups[0].count += 1
    d = job_diff(old, new)
    ann = s.PlanAnnotations(desired_tg_updates={
        new.task_groups[0].name: s.DesiredUpdates(place=1, ignore=2, stop=3)})
    annotate(d, ann)
    tg = d.task_groups[0]
    assert tg.updates[UPDATE_TYPE_CREATE] == 1
    assert tg.updates[UPDATE_TYPE_DESTROY] == 3


def test_annotate_task_destructive_vs_inplace():
    old = mock.job()
    new = old.copy()
    new.task_groups[0].tasks[0].driver = "raw_exec"
    d = job_diff(old, new)
    annotate(d, None)
    td = d.task_groups[0].tasks[0]
    assert ANNOTATION_FORCES_DESTRUCTIVE_UPDATE in td.annotations

    # The port's tasks carry no kill timeout (the reference's in-place
    # field); an edited task constraint is an in-place object change.
    old.task_groups[0].tasks[0].constraints = [
        s.Constraint("${attr.arch}", "x86", "=")]
    new2 = old.copy()
    new2.task_groups[0].tasks[0].constraints[0].rtarget = "arm"
    d2 = job_diff(old, new2)
    annotate(d2, None)
    td2 = d2.task_groups[0].tasks[0]
    assert ANNOTATION_FORCES_INPLACE_UPDATE in td2.annotations


def test_annotate_new_task_in_new_group():
    old = mock.job()
    new = old.copy()
    extra = old.task_groups[0].copy()
    extra.name = "extra"
    new.task_groups.append(extra)
    d = job_diff(old, new)
    annotate(d, None)
    tg = next(t for t in d.task_groups if t.name == "extra")
    for td in tg.tasks:
        assert ANNOTATION_FORCES_CREATE in td.annotations
