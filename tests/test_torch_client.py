"""The port's client building blocks against the JAX package's, on the
same seeded inputs (``nomad_tpu_torch/client/`` against
``nomad_tpu/client/``).

The scenarios of ``tests/test_client.py`` that belong to the port's
client, each run in both packages and compared: the restart tracker's
decisions (both trackers' jitter seeded alike: the port's through its
``rng`` argument, the reference's by setting its ``_rand``), the task
environment, the alloc directory tree, the artifact getter (local files
and a local git repository only, never the network), the driver-config
field schemas and the mock driver's validation, the ``fs`` stream
frames, the template renders over each package's catalog, and the
client's state file.  Objects for the port are the reference's mock
objects converted (``nomad_tpu_torch.convert``).
"""
import dataclasses
import os
import random
import subprocess
import time

import jax  # noqa: F401  (kept like the other port tests)
import pytest

from nomad_tpu import mock as jmock
from nomad_tpu.client import RestartTracker as JRestartTracker
from nomad_tpu.client import allocdir as jallocdir
from nomad_tpu.client import fs_stream as jfs_stream
from nomad_tpu.client import getter as jgetter
from nomad_tpu.client import state as jstate
from nomad_tpu.client import template as jtemplate
from nomad_tpu.client.driver import driver as jdriver
from nomad_tpu.client.driver import env as jenv
from nomad_tpu.client.driver import fields as jfields
from nomad_tpu.consul import catalog as jcatalog
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert
from nomad_tpu_torch.client import RestartTracker as PRestartTracker
from nomad_tpu_torch.client import allocdir as pallocdir
from nomad_tpu_torch.client import fs_stream as pfs_stream
from nomad_tpu_torch.client import getter as pgetter
from nomad_tpu_torch.client import state as pstate
from nomad_tpu_torch.client import template as ptemplate
from nomad_tpu_torch.client.driver import BUILTIN_DRIVERS
from nomad_tpu_torch.client.driver import driver as pdriver
from nomad_tpu_torch.client.driver import env as penv
from nomad_tpu_torch.client.driver import fields as pfields
from nomad_tpu_torch.consul import catalog as pcatalog
from nomad_tpu_torch.structs import structs as ps

SEED = 19


def conv(obj, fn):
    return fn(dataclasses.asdict(obj))


# -- the restart tracker (client/restarts_test.go) ---------------------------

def policy(pkg, attempts=2, interval=60.0, delay=0.01, mode="delay"):
    return pkg.RestartPolicy(attempts=attempts, interval=interval,
                             delay=delay, mode=mode)


def trackers(job_type, **kw):
    jt = JRestartTracker(policy(js, **kw), job_type)
    jt._rand = random.Random(SEED)
    pt = PRestartTracker(policy(ps, **kw), job_type,
                         rng=random.Random(SEED))
    return jt, pt


# Each step: ("wait", exit_code) | ("start", recoverable) | ("trigger",)
# | ("sleep", seconds).
RESTART_CASES = {
    "service_restarts_on_success": ("service", {}, [("wait", 0)]),
    "batch_terminates_on_success": ("batch", {}, [("wait", 0)]),
    "zero_attempts": ("service", {"attempts": 0}, [("wait", 1)]),
    "zero_attempts_success": ("batch", {"attempts": 0}, [("wait", 0)]),
    "fail_mode_exhausts": ("service", {"attempts": 1, "mode": "fail"},
                           [("wait", 1), ("wait", 1)]),
    "delay_mode_waits_out_interval": ("service",
                                      {"attempts": 1, "interval": 5.0},
                                      [("wait", 1), ("wait", 1)]),
    "unrecoverable_start_error": ("service", {}, [("start", False)]),
    "recoverable_start_error": ("service", {}, [("start", True),
                                                ("start", True),
                                                ("start", True)]),
    "restart_triggered": ("service", {"attempts": 0}, [("trigger",)]),
    "interval_reset": ("service", {"attempts": 1, "interval": 0.05},
                       [("wait", 1), ("sleep", 0.06), ("wait", 1)]),
    "jitter_sequence": ("service", {"attempts": 5, "delay": 2.0},
                        [("wait", 1)] * 4),
}


def restart_steps(tracker, dmod, steps):
    out = []
    for step in steps:
        if step[0] == "sleep":
            time.sleep(step[1])
            continue
        if step[0] == "wait":
            tracker.set_wait_result(dmod.WaitResult(exit_code=step[1]))
        elif step[0] == "start":
            err = (dmod.RecoverableError if step[1]
                   else dmod.DriverError)("boom")
            tracker.set_start_error(err)
        else:
            tracker.set_restart_triggered()
        state, delay = tracker.get_state()
        out.append((state, delay, tracker.get_reason()))
    return out


@pytest.mark.parametrize("case", sorted(RESTART_CASES))
def test_restart_decisions_equal_the_reference(case):
    job_type, kw, steps = RESTART_CASES[case]
    jt, pt = trackers(job_type, **kw)
    want = restart_steps(jt, jdriver, steps)
    got = restart_steps(pt, pdriver, steps)
    assert [(s_, r) for s_, _, r in got] == [(s_, r) for s_, _, r in want]
    for (_, gd, reason), (_, wd, _) in zip(got, want):
        # The interval's remainder reads the clock a moment apart; a
        # jittered delay is drawn from the same seeded sequence.
        interval = reason == "Exceeded allowed attempts, applying a delay"
        assert abs(gd - wd) < 0.05 if interval else gd == wd


def test_restart_tracker_default_rng_is_fresh():
    a = PRestartTracker(policy(ps, delay=1.0), "service")
    b = PRestartTracker(policy(ps, delay=1.0), "service")
    assert a._rand is not b._rand


# -- the task environment (client/driver/env/env_test.go) ---------------------

def env_pair(with_ports=False):
    alloc = jmock.alloc()
    task = alloc.job.task_groups[0].tasks[0]
    task.env = {"CUSTOM": "x-${NOMAD_TASK_NAME}",
                "NODE_DC": "${node.datacenter}",
                "META": "${meta.rack}-${attr.kernel.name}"}
    task.meta = {"owner": "team-a", "Mixed-Case": "v"}
    alloc.job.meta = {"tier": "gold"}
    node = jmock.node()
    node.meta = {"rack": "r1"}
    out = []
    for pkg_env, a, n in (
            (jenv, alloc, node),
            (penv, conv(alloc, convert.alloc_from_dict),
             conv(node, convert.node_from_dict))):
        t = a.job.task_groups[0].tasks[0]
        b = pkg_env.Builder()
        b.set_task(t).set_alloc(a)
        if not with_ports:
            b.set_node(n).set_region("global")
            b.set_dirs("/a/alloc", "/a/web/local", "/a/web/secrets")
        out.append(b.build())
    return out


@pytest.mark.parametrize("with_ports", [False, True])
def test_task_env_equals_the_reference(with_ports):
    want, got = env_pair(with_ports)
    assert got.env() == want.env()
    assert got.all() == want.all()
    for text in ("${node.datacenter}-suffix", "${missing.var}",
                 "${NOMAD_ALLOC_INDEX}/${NOMAD_META_owner}", None):
        assert got.replace_env(text) == want.replace_env(text)
    assert got.parse_and_replace(["${NOMAD_TASK_NAME}", "x"]) == \
        want.parse_and_replace(["${NOMAD_TASK_NAME}", "x"])


# -- the alloc dir -------------------------------------------------------------

def tree(root):
    """Every path under ``root`` with its content (files) or None (dirs)."""
    out = {}
    for base, dirs, files in os.walk(root):
        rel = os.path.relpath(base, root)
        out[rel] = None
        for f in files:
            with open(os.path.join(base, f), "rb") as fh:
                out[os.path.join(rel, f)] = fh.read()
    return out


def alloc_dir_ops(pkg, root):
    """The alloc-dir scenarios of ``tests/test_client.py`` in one run: the
    layout, a sticky move, a snapshot and its restore, the fs readers and
    a path escape."""
    old = pkg.AllocDir(os.path.join(root, "old"))
    old.build()
    old.new_task_dir("web").build()
    with open(os.path.join(old.shared_dir, "data", "state.bin"), "w") as f:
        f.write("persisted")
    with open(os.path.join(old.task_dirs["web"].local_dir, "cache"),
              "w") as f:
        f.write("warm")
    blob = old.snapshot()
    new = pkg.AllocDir(os.path.join(root, "new"))
    new.build()
    new.new_task_dir("web").build()
    new.move(old, ["web"])
    dst = pkg.AllocDir(os.path.join(root, "dst"))
    dst.build()
    dst.new_task_dir("web").build()
    dst.restore_snapshot(blob)
    listing = [{k: v for k, v in e.items() if k != "ModTime"}
               for e in new.list_dir("alloc/data")]
    stat = {k: v for k, v in new.stat("alloc/data/state.bin").items()
            if k != "ModTime"}
    try:
        new.read_at("../../etc/passwd", 0, 10)
        escaped = "read"
    except PermissionError:
        escaped = "refused"
    return {"old": tree(old.alloc_dir), "new": tree(new.alloc_dir),
            "dst": tree(dst.alloc_dir), "listing": listing, "stat": stat,
            "read_at": new.read_at("alloc/data/state.bin", 2, 4),
            "read_all": new.read_all("alloc/data/state.bin"),
            "escape": escaped,
            "usage": pkg.disk_usage(new.alloc_dir)}


def test_alloc_dir_equals_the_reference(tmp_path):
    want = alloc_dir_ops(jallocdir, str(tmp_path / "ref"))
    got = alloc_dir_ops(pallocdir, str(tmp_path / "port"))
    assert got == want
    assert got["new"]["alloc/data/state.bin"] == b"persisted"
    assert got["escape"] == "refused"


def test_task_dir_paths_equal_the_reference(tmp_path):
    j = jallocdir.TaskDir(str(tmp_path / "a"), "web")
    p = pallocdir.TaskDir(str(tmp_path / "a"), "web")
    assert vars(p) == vars(j)


# -- the artifact getter ----------------------------------------------------

def fetch(pkg, envmod, art, task_dir, env_map=None):
    try:
        path = pkg.get_artifact(envmod.TaskEnv(env_map=env_map or {}), art,
                                str(task_dir))
    except pkg.ArtifactError as e:
        return ("error", str(e).replace(str(task_dir), "<task>"))
    return ("ok", os.path.relpath(path, task_dir), tree(os.path.dirname(
        path)) if os.path.isdir(path) else open(path, "rb").read())


def getter_case(case, tmp_path, structs):
    src = tmp_path / "artifact.txt"
    src.write_bytes(b"payload")
    import hashlib

    good = hashlib.sha256(b"payload").hexdigest()
    d = tmp_path / "adir"
    d.mkdir(exist_ok=True)
    (d / "f").write_text("in a dir")
    return {
        "file_url": (structs.TaskArtifact(getter_source=f"file://{src}",
                                          relative_dest="local/"), None),
        "plain_path": (structs.TaskArtifact(getter_source=str(src)), None),
        "directory": (structs.TaskArtifact(getter_source=str(d),
                                           relative_dest="local/in"), None),
        "checksum_ok": (structs.TaskArtifact(
            getter_source=str(src),
            getter_options={"checksum": f"sha256:{good}"}), None),
        "checksum_mismatch": (structs.TaskArtifact(
            getter_source=str(src),
            getter_options={"checksum": "sha256:" + "0" * 64}), None),
        "checksum_bad_spec": (structs.TaskArtifact(
            getter_source=str(src), getter_options={"checksum": "nocolon"}),
            None),
        "interpolated": (structs.TaskArtifact(getter_source="${SRC}"),
                         {"SRC": str(src)}),
        "missing": (structs.TaskArtifact(
            getter_source=str(tmp_path / "nope")), None),
        "empty": (structs.TaskArtifact(getter_source=""), None),
    }[case]


@pytest.mark.parametrize("case", ["file_url", "plain_path", "directory",
                                  "checksum_ok", "checksum_mismatch",
                                  "checksum_bad_spec", "interpolated",
                                  "missing", "empty"])
def test_getter_equals_the_reference(case, tmp_path):
    out = []
    for pkg, envmod, structs, sub in ((jgetter, jenv, js, "ref"),
                                      (pgetter, penv, ps, "port")):
        art, env_map = getter_case(case, tmp_path, structs)
        task_dir = tmp_path / sub
        task_dir.mkdir()
        out.append(fetch(pkg, envmod, art, task_dir, env_map))
    assert out[1] == out[0]


@pytest.mark.parametrize("source", ["http://127.0.0.1:9/x.bin",
                                    "https://example.invalid/a.tgz",
                                    "s3://bucket/key"])
def test_getter_refuses_the_network_routes(source, tmp_path):
    """The port keeps the local and git routes only: a network source
    raises before any connection is made."""
    art = ps.TaskArtifact(getter_source=source)
    with pytest.raises(pgetter.ArtifactError, match="local files and git"):
        pgetter.get_artifact(penv.TaskEnv(), art, str(tmp_path))


def make_repo(path):
    env = {**os.environ, "GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
           "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t"}
    path.mkdir()
    subprocess.run(["git", "init", "-q", str(path)], check=True, env=env)
    (path / "hello.txt").write_text("from git")
    subprocess.run(["git", "-C", str(path), "add", "."], check=True,
                   env=env)
    subprocess.run(["git", "-C", str(path), "commit", "-q", "-m", "one"],
                   check=True, env=env)
    subprocess.run(["git", "-C", str(path), "tag", "v1"], check=True,
                   env=env)
    (path / "hello.txt").write_text("from git, second")
    subprocess.run(["git", "-C", str(path), "commit", "-q", "-am", "two"],
                   check=True, env=env)


@pytest.mark.parametrize("opts", [{}, {"ref": "v1"}, {"checksum": "md5:0"}])
def test_git_getter_equals_the_reference(opts, tmp_path):
    """go-getter's git:: route against a local repository (twice each, so
    the restart path's re-clone over a stale one runs too)."""
    make_repo(tmp_path / "srcrepo")
    out = []
    for pkg, envmod, structs, sub in ((jgetter, jenv, js, "ref"),
                                      (pgetter, penv, ps, "port")):
        task_dir = tmp_path / sub
        task_dir.mkdir()
        art = structs.TaskArtifact(
            getter_source=f"git::file://{tmp_path / 'srcrepo'}",
            relative_dest="local/", getter_options=dict(opts))
        runs = [fetch(pkg, envmod, art, task_dir) for _ in range(2)]
        out.append([(r[0], r[1]) if r[0] == "error" else
                    (r[0], r[1], open(task_dir / r[1] / "hello.txt").read())
                    for r in runs])
    assert out[1] == out[0]
    if not opts:
        assert out[1][0][2] == "from git, second"


# -- driver field schemas and the mock driver ----------------------------------

SCHEMA_CONFIGS = [
    {"command": "/bin/x"}, {}, {"command": 5, "args": "no", "count": "x"},
    {"command": "x", "bogus": 1}, {"command": ""}, "not-a-map", None,
    {"command": "x", "verbose": "maybe", "count": True},
    {"command": "x", "n": "-12", "m": "1.5", "d": "10s", "b": "yes",
     "l": (1, 2), "mp": {"k": 1}},
]


def schema(pkg):
    F = pkg.FieldSchema
    return {"command": F("string", required=True), "args": F("list"),
            "count": F("int"), "verbose": F("bool"), "n": F("intlike"),
            "m": F("intlike"), "d": F("duration"), "b": F("boollike"),
            "l": F("list"), "mp": F("map")}


@pytest.mark.parametrize("k", range(len(SCHEMA_CONFIGS)))
@pytest.mark.parametrize("strict", [False, True])
def test_field_schema_equals_the_reference(k, strict):
    cfg = SCHEMA_CONFIGS[k]
    assert pfields.validate_fields(cfg, schema(pfields), strict=strict) == \
        jfields.validate_fields(cfg, schema(jfields), strict=strict)


MOCK_CONFIGS = [
    {"run_for": "10s"}, {"run_for": 3}, {"exit_code": "not-an-int"},
    {"exit_code": "-1", "exit_signal": 9}, {"start_error": 5},
    {"start_error_recoverable": "yes"}, {"kill_after": True},
    {"stdout_string": "hi", "exit_err_msg": "bye"}, {},
]


@pytest.mark.parametrize("cfg", MOCK_CONFIGS)
def test_mock_driver_validation_equals_the_reference(cfg):
    def verdict(fn):
        try:
            fn("mock_driver", cfg)
        except ValueError as e:
            return str(e)
        return None

    assert verdict(pdriver.validate_driver_config) == \
        verdict(jdriver.validate_driver_config)


@pytest.mark.parametrize("name", ["raw_exec", "exec", "docker", "qemu"])
def test_only_the_mock_driver_is_built_in(name):
    """The builtin drivers are the reference's, registered in its order
    (the exec family and the containers joined the mock driver; the name
    is kept from when the mock driver was the only one): each validates a
    config as the reference's does, and both registries refuse a driver
    they do not know."""
    import nomad_tpu.client.client  # noqa: F401  (registers the builtins)

    assert list(BUILTIN_DRIVERS) == list(jdriver.BUILTIN_DRIVERS)
    assert name in BUILTIN_DRIVERS
    for cfg in ({"command": "/bin/true"}, {"image": "redis:7"}, {}):
        verdicts = []
        for mod in (jdriver, pdriver):
            try:
                mod.validate_driver_config(name, cfg)
                verdicts.append(None)
            except ValueError as e:
                verdicts.append(str(e))
        assert verdicts[0] == verdicts[1], (name, cfg)
    for mod in (jdriver, pdriver):
        with pytest.raises(mod.DriverError, match="unknown driver 'nosuch'"):
            mod.validate_driver_config("nosuch", {})


@pytest.mark.parametrize("value", [0, 2.5, "250ms", "10s", "1m", "3h", "7"])
def test_parse_duration_equals_the_reference(value):
    assert pdriver.parse_duration(value) == jdriver.parse_duration(value)


def test_mock_driver_fingerprint_equals_the_reference():
    jn, pn = jmock.node(), ps.Node()
    jn.attributes = {}
    jd = jdriver.new_driver("mock_driver", jdriver.DriverContext(
        driver_name="mock_driver", alloc_id="", config=None))
    pd = pdriver.new_driver("mock_driver", pdriver.DriverContext(
        driver_name="mock_driver", alloc_id="", config=None))
    assert pd.fingerprint(pn) == jd.fingerprint(jn)
    assert pn.attributes == jn.attributes == {"driver.mock_driver": "1"}
    assert dataclasses.asdict(pd.abilities()) == \
        dataclasses.asdict(jd.abilities())


# -- fs stream frames ----------------------------------------------------------

def write_logs(root, sizes):
    logs = os.path.join(root, "alloc", "logs")
    os.makedirs(logs, exist_ok=True)
    rng = random.Random(SEED)
    for i, n in enumerate(sizes):
        with open(os.path.join(logs, f"web.stdout.{i}"), "wb") as fh:
            fh.write(bytes(rng.getrandbits(8) for _ in range(n)))
    return logs


STREAM_CASES = [
    ("logs", 0, "start"), ("logs", 100, "start"), ("logs", 10, "end"),
    ("logs", 70_000, "end"), ("file", 0, "start"), ("file", 5, "start"),
    ("file", 5, "end"), ("file", 10 ** 9, "end"),
]


@pytest.mark.parametrize("kind,offset,origin", STREAM_CASES)
def test_fs_stream_frames_equal_the_reference(kind, offset, origin,
                                              tmp_path):
    """Frames across rotated logs (64 KiB frames, the rotation's
    FileEvent) and of one file, from either end."""
    logs = write_logs(str(tmp_path), [70_000, 10, 140_000])
    out = []
    for mod in (jfs_stream, pfs_stream):
        if kind == "logs":
            frames = mod.stream_log_frames(logs, "web", "stdout",
                                           offset=offset, origin=origin)
        else:
            frames = mod.stream_file_frames(
                os.path.join(logs, "web.stdout.0"), "alloc/logs/web.stdout.0",
                offset=offset, origin=origin)
        out.append(list(frames))
    assert out[1] == out[0]
    assert out[1]


def test_fs_stream_follow_ends_when_the_task_is_dead(tmp_path):
    logs = write_logs(str(tmp_path), [5])
    out = []
    for mod in (jfs_stream, pfs_stream):
        out.append(list(mod.stream_log_frames(
            logs, "web", follow=True, alive=lambda: False, poll=0.01)))
    assert out[1] == out[0]


# -- template renders ----------------------------------------------------------

TEMPLATES = [
    'key={{key "cfg/a"}} env={{env "NOMAD_TASK_NAME"}}',
    'svc={{service "db"}}',
    '{{range service "db"}}{{.Name}}@{{.Address}}:{{.Port}};{{end}}',
    'missing={{env "NOPE"}} other={{ bogus "x" }}',
    'plain text',
]


def catalog(mod):
    cat = mod.ServiceCatalog()
    cat.kv_set("cfg/a", "alpha")
    for i, port in enumerate((5432, 5433)):
        cat.register(mod.CatalogEntry(id=f"db-{i}", name="db",
                                      address=f"10.0.0.{i + 1}", port=port))
    return cat


@pytest.mark.parametrize("k", range(len(TEMPLATES)))
def test_template_renders_equal_the_reference(k, tmp_path):
    out = []
    for tmod, cmod, structs in ((jtemplate, jcatalog, js),
                                (ptemplate, pcatalog, ps)):
        tm = tmod.TaskTemplateManager(
            templates=[structs.Template(embedded_tmpl=TEMPLATES[k],
                                        dest_path="local/out.txt")],
            task_dir=str(tmp_path), env={"NOMAD_TASK_NAME": "web"},
            catalog=catalog(cmod))
        out.append(tm.render_one(tm.templates[0]))
    assert out[1] == out[0]


def test_template_blocks_on_a_missing_key_like_the_reference(tmp_path):
    out = []
    for tmod, cmod, structs, sub in ((jtemplate, jcatalog, js, "ref"),
                                     (ptemplate, pcatalog, ps, "port")):
        cat = cmod.ServiceCatalog()
        tm = tmod.TaskTemplateManager(
            templates=[structs.Template(embedded_tmpl='{{key "late"}}',
                                        dest_path="local/o", perms="0600")],
            task_dir=str(tmp_path / sub), env={}, catalog=cat)
        polls = []

        def abort():
            polls.append(1)
            if len(polls) == 2:
                cat.kv_set("late", "arrived")
            return len(polls) > 5

        ok = tm.render_all_blocking(abort, poll=0.01)
        path = tmp_path / sub / "local" / "o"
        out.append((ok, len(polls), path.read_text(),
                    oct(os.stat(path).st_mode & 0o777)))
    assert out[1] == out[0] == [(True, 2, "arrived", "0o600")][0]


@pytest.mark.parametrize("name", ["SIGHUP", "usr1", "", "SIGNOPE"])
def test_parse_signal_equals_the_reference(name):
    assert ptemplate.parse_signal(name) == jtemplate.parse_signal(name)


# -- the client's state file ---------------------------------------------------

def runner_state(structs, alloc):
    ev = [structs.TaskEvent(type="Received", time=1.5),
          structs.TaskEvent(type="Started", time=2.0),
          structs.TaskEvent(type="Terminated", exit_code=1, signal=9,
                            message="bye", time=3.0),
          structs.TaskEvent(type="Not Restarting", failed=True,
                            restart_reason="Policy allows no restarts")]
    return {"alloc": alloc,
            "task_states": {"web": structs.TaskState(
                state="dead", failed=True, started_at=2.0, finished_at=3.0,
                events=ev)},
            "handles": {"web": "mock:web:2.0"},
            "alloc_dir": "/a/b"}


def plain(v):
    if dataclasses.is_dataclass(v):
        return plain(dataclasses.asdict(v))
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    return v


def test_state_db_round_trip_equals_the_reference(tmp_path):
    alloc = jmock.alloc()
    out = []
    for mod, structs, a, sub in (
            (jstate, js, alloc, "ref"),
            (pstate, ps, conv(alloc, convert.alloc_from_dict), "port")):
        db = mod.StateDB(str(tmp_path / sub))
        db.put_alloc_runner(a.id, runner_state(structs, a))
        db.put_alloc_runner("other", {"alloc": None, "task_states": {}})
        got = db.get_alloc_runner(a.id)
        assert got == runner_state(structs, a)
        listed = sorted(db.list_alloc_runners())
        db.delete_alloc_runner("other")
        db.delete_alloc_runner("never-there")
        out.append((plain(got["task_states"]), got["handles"],
                    got["alloc_dir"], got["alloc"].id, listed,
                    db.list_alloc_runners(),
                    db.get_alloc_runner("missing")))
    assert out[1] == out[0]


def test_state_db_reads_a_corrupt_or_foreign_file_as_no_state(tmp_path):
    """A torn file, a reference (msgpack or reference-codec) frame and a
    frame of another struct schema all read as no state, as a corrupt
    file reads in the reference."""
    db = pstate.StateDB(str(tmp_path))
    jdb = jstate.StateDB(str(tmp_path / "ref"))
    jdb.put_alloc_runner("a", {"handles": {}})
    with open(os.path.join(jdb.dir, "a"), "rb") as fh:
        foreign = fh.read()
    stale = bytes.fromhex(
        "c1019cc63ba0cff31391080205066a6f625f696405037065720505707572676502")
    for name, blob in (("torn", b"\xc1\x01\x00"), ("ref", foreign),
                       ("stale", stale)):
        with open(os.path.join(db.dir, name), "wb") as fh:
            fh.write(blob)
        assert db.get_alloc_runner(name) is None


def test_state_db_reaps_old_tmp_files(tmp_path):
    for mod in (jstate, pstate):
        d = tmp_path / mod.__name__ / "allocs"
        d.mkdir(parents=True)
        old, fresh = d / "x.tmp1", d / "y.tmp2"
        old.write_bytes(b"")
        fresh.write_bytes(b"")
        os.utime(old, (time.time() - 120, time.time() - 120))
        mod.StateDB(str(tmp_path / mod.__name__))
        assert not old.exists() and fresh.exists()
