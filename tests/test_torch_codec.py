"""The port's struct codec (``nomad_tpu_torch/codec``) and log codec
(``server/log_codec.py``), twins of the reference's codec tests
(``tests/test_codec.py``).

- Every registered port type round-trips, at its defaults and filled
  with seeded values by its type hints.
- The same payloads (log entries of every message type the server
  writes) through the reference's ``encode_payload``/``decode_payload``
  and the port's decode to equal content, the reference-only fields
  removed from the reference's side.  Frames are never compared across
  the packages: the port's structs lack fields the reference has, so the
  schema fingerprints differ, and a frame of either decodes only in its
  own package.
- A frame of another fingerprint raises a ``CodecError`` that names both
  fingerprints; truncation, trailing bytes, ints past int64 and types
  outside the registry raise too.  There is no msgpack fallback.
- The native string-column loops equal their pure-Python twins, and the
  differential guard catches a divergence.
"""
import dataclasses
import typing

import numpy as np
import pytest

from nomad_tpu import mock as jmock
from nomad_tpu.codec import FINGERPRINT as JFINGERPRINT
from nomad_tpu.server import log_codec as jlog_codec
from nomad_tpu.state.state_store import PeriodicLaunch as JPeriodicLaunch
from nomad_tpu.state.state_store import VaultAccessor as JVaultAccessor
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import codec, convert, mock
from nomad_tpu_torch.codec import native, schema
from nomad_tpu_torch.ops import breaker
from nomad_tpu_torch.server import log_codec
from nomad_tpu_torch.state.state_store import PeriodicLaunch, VaultAccessor
from nomad_tpu_torch.structs import structs as ps

TYPES = schema.TYPES_BY_ID


def fill(tp, rng, depth=0):
    """A seeded value of type hint ``tp`` (dataclasses filled field by
    field, two levels deep)."""
    origin = typing.get_origin(tp)
    if tp is int:
        return int(rng.integers(-2**40, 2**40))
    if tp is float:
        return float(rng.normal())
    if tp is bool:
        return bool(rng.integers(0, 2))
    if tp is str:
        return "".join(rng.choice(list("abcé→z0-_. "), size=int(
            rng.integers(0, 12))))
    if tp is bytes:
        return rng.integers(0, 256, size=5, dtype=np.uint8).tobytes()
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if rng.random() < 0.3 or depth > 2:
            return None
        return fill(args[0], rng, depth)
    if origin in (list, tuple):
        (inner,) = typing.get_args(tp)[:1] or (str,)
        if depth > 2:
            return []
        return [fill(inner, rng, depth + 1)
                for _ in range(int(rng.integers(0, 3)))]
    if origin is dict:
        _, val = typing.get_args(tp)
        if depth > 2:
            return {}
        return {f"k{i}": fill(val, rng, depth + 1)
                for i in range(int(rng.integers(0, 3)))}
    if isinstance(tp, type) and dataclasses.is_dataclass(tp):
        if depth > 2:
            return None
        hints = typing.get_type_hints(tp)
        return tp(**{f.name: fill(hints[f.name], rng, depth + 1)
                     for f in dataclasses.fields(tp)})
    # Any / object: a small value tree.
    return {"n": int(rng.integers(0, 100)), "l": [1.5, "x", None, True]}


@pytest.mark.parametrize("cls", TYPES, ids=lambda c: c.__name__)
def test_every_registered_type_round_trips(cls):
    assert codec.decode(codec.encode(cls())) == cls()
    rng = np.random.default_rng(TYPES.index(cls))
    for _ in range(3):
        obj = fill(cls, rng)
        got = codec.decode(codec.encode(obj))
        assert got == obj
        assert type(got) is cls


def test_registry_is_the_ports_structs():
    names = {c.__name__ for c in TYPES}
    assert {"Node", "Job", "Allocation", "AllocSlab", "Evaluation",
            "Namespace", "PeriodicLaunch", "VaultAccessor"} <= names
    assert all(c.__module__.startswith("nomad_tpu_torch.") for c in TYPES)


def test_lazy_slab_columns_stay_lazy():
    slab = ps.AllocSlab(proto=ps.Allocation(job_id="j"),
                        ids=ps.LazyUuids(100_000),
                        names=ps.LazyNames(100_000, "j.web"),
                        node_ids=[f"n{i % 7}" for i in range(50)])
    blob = codec.encode(slab)
    got = codec.decode(blob)
    assert type(got.ids) is ps.LazyUuids and type(got.names) is ps.LazyNames
    assert got.ids.prefix == slab.ids.prefix and len(got.ids) == 100_000
    assert got.ids[99_999] == slab.ids[99_999]
    assert list(got.node_ids) == list(slab.node_ids)
    assert len(blob) < 1000


# -- the same payloads through both packages -------------------------------


def strip_ref(ref, port):
    """``ref``'s dict form restricted to the keys the port's form has
    (the reference-only fields removed), recursively."""
    if isinstance(ref, dict) and isinstance(port, dict):
        return {k: strip_ref(ref[k], port[k]) for k in port if k in ref}
    if isinstance(ref, list) and isinstance(port, list):
        return [strip_ref(a, b) for a, b in zip(ref, port)]
    return ref


def as_plain(v):
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return as_plain(dataclasses.asdict(v))
    if isinstance(v, dict):
        return {k: as_plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [as_plain(x) for x in v]
    return v


def ref_world(seed):
    """Seeded reference objects for every payload the server logs."""
    rng = np.random.default_rng(seed)
    node = jmock.node()
    node.resources.cpu = int(rng.integers(1000, 9000))
    job = jmock.job()
    job.task_groups[0].count = int(rng.integers(1, 20))
    alloc = jmock.alloc()
    alloc.node_id, alloc.job, alloc.job_id = node.id, job, job.id
    ev = jmock.eval()
    ev.job_id = job.id
    ev.priority = int(rng.integers(1, 100))
    return node, job, alloc, ev


def payloads(seed):
    """(reference payload, port payload) pairs: the same entries built in
    both packages (the port's objects converted from the reference's)."""
    node, job, alloc, ev = ref_world(seed)
    pnode = convert.node_from_dict(dataclasses.asdict(node))
    pjob = convert.job_from_dict(dataclasses.asdict(job))
    palloc = convert.alloc_from_dict(dataclasses.asdict(alloc))
    pev = convert.eval_from_dict(dataclasses.asdict(ev))
    ns = dict(name=f"team-{seed}", description="d", max_live_allocs=seed,
              dequeue_weight=1.5 + seed)
    acc = dict(accessor=f"acc-{seed}", alloc_id=alloc.id,
               node_id=node.id, task="web", creation_ttl=60)
    return [
        ({"node": node}, {"node": pnode}),
        ({"node_id": node.id, "status": "down"},
         {"node_id": node.id, "status": "down"}),
        ({"job": job}, {"job": pjob}),
        ({"job_id": job.id, "purge": False},
         {"job_id": job.id, "purge": False}),
        ({"evals": [ev]}, {"evals": [pev]}),
        ({"allocs": [alloc], "job": job}, {"allocs": [palloc],
                                           "job": pjob}),
        ({"job": job, "allocs": [alloc], "slabs": None, "eval_id": ev.id},
         {"job": pjob, "allocs": [palloc], "slabs": None,
          "eval_id": ev.id}),
        ({"namespace": js.Namespace(**ns)},
         {"namespace": ps.Namespace(**ns)}),
        ({"accessors": [JVaultAccessor(**acc)]},
         {"accessors": [VaultAccessor(**acc)]}),
        ({"job_id": job.id, "launch": 12.5},
         {"job_id": job.id, "launch": 12.5}),
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", range(10))
def test_payload_decodes_as_the_reference_payload(seed, k):
    ref, port = payloads(seed)[k]
    ref_out = jlog_codec.decode_payload(jlog_codec.encode_payload(ref))
    port_out = log_codec.decode_payload(log_codec.encode_payload(port))
    want, got = as_plain(ref_out), as_plain(port_out)
    assert got == strip_ref(want, got)
    assert got == as_plain(port)


def test_periodic_launch_rows_round_trip_alike():
    ref = JPeriodicLaunch(id="p", launch=3.25, create_index=4,
                          modify_index=5)
    port = PeriodicLaunch(id="p", launch=3.25, create_index=4,
                          modify_index=5)
    a = jlog_codec.decode_payload(jlog_codec.encode_payload({"r": ref}))
    b = log_codec.decode_payload(log_codec.encode_payload({"r": port}))
    assert dataclasses.asdict(a["r"]) == dataclasses.asdict(b["r"])


# -- what must raise -------------------------------------------------------


def test_fingerprints_differ_from_the_reference():
    assert schema.FINGERPRINT != JFINGERPRINT
    assert len(schema.FINGERPRINT) == 8


def test_reference_frame_raises_naming_both_fingerprints():
    blob = jlog_codec.encode_payload({"node": jmock.node()})
    with pytest.raises(codec.CodecError) as e:
        log_codec.decode_payload(blob)
    assert JFINGERPRINT.hex() in str(e.value)
    assert schema.FINGERPRINT.hex() in str(e.value)


def test_wrong_fingerprint_frame_raises():
    blob = bytearray(codec.encode({"node": mock.node()}))
    blob[2] ^= 0xFF
    with pytest.raises(codec.CodecError, match="fingerprint mismatch"):
        codec.decode(bytes(blob))


@pytest.mark.parametrize("cut", [1, 5, 11, 40])
def test_truncated_frame_raises(cut):
    blob = codec.encode({"job": mock.job()})
    with pytest.raises(codec.CodecError):
        codec.decode(blob[:cut])


def test_trailing_bytes_raise():
    with pytest.raises(codec.CodecError, match="trailing"):
        codec.decode(codec.encode({"a": 1}) + b"\x00")


def test_payload_outside_the_schema_raises_at_encode():
    class Foreign:
        pass

    with pytest.raises(codec.CodecError):
        log_codec.encode_payload({"x": Foreign()})
    with pytest.raises(codec.CodecError):
        log_codec.encode_payload({"x": 1 << 70})
    with pytest.raises(codec.CodecError):
        log_codec.encode_payload({"x": {1, 2}})


def test_non_frame_blob_raises():
    import json

    with pytest.raises(codec.CodecError, match="not a struct-codec frame"):
        log_codec.decode_payload(json.dumps({"i": 1}).encode())


def test_stats_count_frames_per_subsystem():
    codec.reset()
    blob = log_codec.encode_payload({"a": 1})
    log_codec.decode_payload(blob, "snapshot")
    st = codec.stats()
    assert st["raft"]["encodes"] == 1 and st["raft"]["encode_bytes"] == len(
        blob)
    assert st["snapshot"]["decodes"] == 1


# -- the native string columns ---------------------------------------------


def seeded_strs(seed, n):
    rng = np.random.default_rng(seed)
    alphabet = list("abcxyz0129-._é→世界")
    return ["".join(rng.choice(alphabet, size=int(k)))
            for k in rng.integers(0, 300, size=n)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_native_columns_equal_the_twins(seed, monkeypatch):
    monkeypatch.setattr(native, "GUARD_EVERY", 1)
    native.reset_counters()
    strs = seeded_strs(seed, 500)
    packed = native.pack_strs(strs)
    assert packed == native.py_pack_strs([x.encode() for x in strs])
    prefix = b"\x07" * 3
    got, end = native.unpack_strs(prefix + packed + b"tail", 3, len(strs))
    assert got == strs and end == 3 + len(packed)
    assert native.NATIVE_PACKS == 1 and native.NATIVE_UNPACKS == 1
    assert native.GUARD_RUNS == 2 and native.GUARD_MISMATCHES == 0


def test_native_split_refuses_a_truncated_column():
    packed = native.pack_strs(["alpha", "beta"])
    with pytest.raises(codec.CodecError):
        native.unpack_strs(packed[:-1], 0, 2)


def test_guard_mismatch_raises_and_leaves_the_breaker_alone(monkeypatch):
    """A guard mismatch is the codec's own verdict: counted and raised as
    ``CodecError`` (the wrong bytes reach no log), the native path stays
    in use, and the kernel breaker that routes the card's evals is not
    fed (the reference feeds it; the port keeps host codec faults off the
    card's scheduling)."""
    breaker.reset_for_tests()
    monkeypatch.setattr(native, "GUARD_EVERY", 1)
    native.reset_counters()
    monkeypatch.setattr(native, "py_pack_strs", lambda enc: b"\x00")
    try:
        with pytest.raises(codec.CodecError, match="pack_strs"):
            native.pack_strs(["a", "b"])
        assert native.GUARD_MISMATCHES == 1
        assert list(breaker.BREAKER._checks) == []
        monkeypatch.setattr(native, "GUARD_EVERY", 0)
        assert native.pack_strs(["a", "b"]) == b"\x01a\x01b"
        assert native.NATIVE_PACKS == 2
    finally:
        native.reset_counters()
        breaker.reset_for_tests()


# -- the job lifecycle's structs and bodies --------------------------------

# The schema fingerprint of the port's structs before the lifecycle
# fields (Job.parent_id, periodic, parameterized_job, payload,
# Task.dispatch_payload, JobSummary.children), and a frame that build
# wrote: {"job_id": "per", "purge": True}.
PRE_LIFECYCLE_FINGERPRINT = bytes.fromhex("1b3c6208980af597")
PRE_LIFECYCLE_FRAME = bytes.fromhex(
    "c1011b3c6208980af597080205066a6f625f696405037065720505707572676502")


def lifecycle_world():
    """Reference objects of the lifecycle: a periodic parent, a
    parameterized parent with a task's dispatch payload, a dispatched
    child with a payload, a summary with children counts."""
    per = jmock.job()
    per.id = per.name = "per"
    per.type = "batch"
    per.periodic = js.PeriodicConfig(enabled=True, spec="*/5 * * * *",
                                     prohibit_overlap=True)
    par = jmock.job()
    par.id = par.name = "par"
    par.type = "batch"
    par.parameterized_job = js.ParameterizedJobConfig(
        payload="optional", meta_required=["k"], meta_optional=["o", "p"])
    par.task_groups[0].tasks[0].dispatch_payload = js.DispatchPayloadConfig(
        file="in.json")
    child = par.copy()
    child.id = child.name = "par/dispatch-1700000000-0a1b2c3d"
    child.parent_id = "par"
    child.parameterized_job = None
    child.payload = b"\x00\x01payload\xff"
    child.meta = {"k": "1"}
    summ = js.JobSummary(job_id="par", summary={
        "web": js.TaskGroupSummary(queued=1, complete=2)},
        children=js.JobChildrenSummary(pending=1, running=2, dead=3))
    return per, par, child, summ


def lifecycle_payloads():
    per, par, child, summ = lifecycle_world()
    cv = convert.job_from_dict
    return [
        ({"job": per}, {"job": cv(dataclasses.asdict(per))}),
        ({"job": par}, {"job": cv(dataclasses.asdict(par))}),
        ({"job": child}, {"job": cv(dataclasses.asdict(child))}),
        ({"evals": ["e1", "e2"], "allocs": ["a1"]},
         {"evals": ["e1", "e2"], "allocs": ["a1"]}),
        ({}, {}),
        ({"summary": summ}, {"summary": ps.JobSummary(
            job_id="par", summary={"web": ps.TaskGroupSummary(
                queued=1, complete=2)},
            children=ps.JobChildrenSummary(pending=1, running=2, dead=3))}),
    ]


@pytest.mark.parametrize("k", range(6))
def test_lifecycle_payload_decodes_as_the_reference_payload(k):
    ref, port = lifecycle_payloads()[k]
    ref_out = jlog_codec.decode_payload(jlog_codec.encode_payload(ref))
    port_out = log_codec.decode_payload(log_codec.encode_payload(port))
    want, got = as_plain(ref_out), as_plain(port_out)
    assert got == strip_ref(want, got)
    assert got == as_plain(port)


def test_lifecycle_types_are_registered():
    names = {c.__name__ for c in TYPES}
    assert {"PeriodicConfig", "ParameterizedJobConfig",
            "DispatchPayloadConfig", "JobChildrenSummary"} <= names


def rpc_bodies():
    per, par, child, summ = lifecycle_world()
    pchild = convert.job_from_dict(dataclasses.asdict(child))
    alloc = convert.alloc_from_dict(dataclasses.asdict(jmock.alloc()))
    alloc.client_status = "complete"
    ns = ps.Namespace(name="batch", max_live_allocs=25_000,
                      dequeue_weight=1.0)
    return [
        {"JobID": "par", "Payload": b"\x00raw", "Meta": {"k": "1"}},
        {"Index": 7, "DispatchedJobID": pchild.id, "EvalID": "e"},
        {"JobID": "per"}, {"ChildJobID": "per/periodic-1700000000"},
        {"Allocs": [alloc]}, {"Index": 9},
        {"Namespace": ns}, {"Name": "batch"},
        {"Namespaces": [ns], "Index": 3},
        {"Namespace": ns, "Usage": {"CPU": 1, "MemoryMB": 2, "DiskMB": 3,
                                    "IOPS": 0, "LiveAllocs": 4,
                                    "NodeUnits": 0.25},
         "ReservedAllocs": 5, "ReservedNodeUnits": 0.5, "PendingEvals": 6},
        {"Enabled": True, "Pending": 0, "ByPriority": {"50": 3},
         "Tenants": {"batch": {"Pending": 1, "Dequeued": 2, "Shed": 0,
                               "Rejects": 1, "Weight": 1.0,
                               "DominantShare": 0.125,
                               "VirtualTime": 2.0}},
         "TenantsElided": 0, "FollowerSched": {"Enabled": False}},
        {}, {"Job": pchild},
    ]


@pytest.mark.parametrize("k", range(13))
def test_lifecycle_rpc_bodies_round_trip(k):
    body = rpc_bodies()[k]
    got = codec.decode(codec.encode(body, "rpc"), "rpc")
    assert got == body
    assert as_plain(got) == as_plain(body)


# The schema fingerprint of the port's structs before the jobspec's types
# and fields (restart policies, services, log configs, artifacts,
# templates, vault asks, kill timeouts, leaders, submit and create
# times, a node's HTTP address, links and status time), and a frame that
# build wrote: {"job_id": "per", "purge": True}.
PRE_JOBSPEC_FINGERPRINT = bytes.fromhex("e01650e579db354a")
PRE_JOBSPEC_FRAME = bytes.fromhex(
    "c101e01650e579db354a080205066a6f625f696405037065720505707572676502")


def test_pre_jobspec_frame_raises_naming_both_fingerprints():
    assert schema.FINGERPRINT != PRE_JOBSPEC_FINGERPRINT
    assert PRE_JOBSPEC_FRAME[2:10] == PRE_JOBSPEC_FINGERPRINT
    with pytest.raises(codec.CodecError) as e:
        log_codec.decode_payload(PRE_JOBSPEC_FRAME)
    assert PRE_JOBSPEC_FINGERPRINT.hex() in str(e.value)
    assert schema.FINGERPRINT.hex() in str(e.value)
    blob = log_codec.encode_payload({"job_id": "per", "purge": True})
    assert blob[10:] == PRE_JOBSPEC_FRAME[10:]


def test_jobspec_types_round_trip_through_the_codec():
    """A job with every jobspec type, an alloc with its create time and a
    node with its HTTP address, links and status time decode as they
    were encoded."""
    job = convert.job_from_dict(dataclasses.asdict(jmock.job()))
    task = job.task_groups[0].tasks[0]
    task.templates = [ps.Template(dest_path="local/x", embedded_tmpl="hi")]
    task.artifacts = [ps.TaskArtifact(getter_source="http://a/b",
                                      getter_options={"k": "v"})]
    task.vault = ps.Vault(policies=["p"], change_mode="signal",
                          change_signal="SIGHUP")
    task.leader = True
    job.submit_time = 12.5
    node = convert.node_from_dict(dataclasses.asdict(jmock.node()))
    node.http_addr, node.links = "10.0.0.1:4646", {"aws.ec2": "i-1"}
    node.status_updated_at = 99.0
    alloc = ps.Allocation(id="a", job_id=job.id, job=job, create_time=7.0)
    body = {"job": job, "node": node, "alloc": alloc}
    got = log_codec.decode_payload(log_codec.encode_payload(body))
    assert got == body


def test_pre_lifecycle_frame_raises_naming_both_fingerprints():
    assert schema.FINGERPRINT != PRE_LIFECYCLE_FINGERPRINT
    assert PRE_LIFECYCLE_FRAME[2:10] == PRE_LIFECYCLE_FINGERPRINT
    with pytest.raises(codec.CodecError) as e:
        log_codec.decode_payload(PRE_LIFECYCLE_FRAME)
    assert PRE_LIFECYCLE_FINGERPRINT.hex() in str(e.value)
    assert schema.FINGERPRINT.hex() in str(e.value)
    # This build's frame of the same payload decodes.
    blob = log_codec.encode_payload({"job_id": "per", "purge": True})
    assert blob[10:] == PRE_LIFECYCLE_FRAME[10:]
    assert log_codec.decode_payload(blob) == {"job_id": "per", "purge": True}


# -- the client's task-event fields ----------------------------------------

# The schema fingerprint of the port's structs before the client's fields
# (TaskEvent's time, message, driver error, signal, kill timeout, restart
# reason, failed sibling, failed and start delay; TaskState's failed,
# started_at and finished_at), and a frame that build wrote:
# {"job_id": "per", "purge": True}.
PRE_CLIENT_FINGERPRINT = bytes.fromhex("9cc63ba0cff31391")
PRE_CLIENT_FRAME = bytes.fromhex(
    "c1019cc63ba0cff31391080205066a6f625f696405037065720505707572676502")


def test_pre_client_frame_raises_naming_both_fingerprints():
    assert schema.FINGERPRINT != PRE_CLIENT_FINGERPRINT
    assert PRE_CLIENT_FRAME[2:10] == PRE_CLIENT_FINGERPRINT
    with pytest.raises(codec.CodecError) as e:
        log_codec.decode_payload(PRE_CLIENT_FRAME)
    assert PRE_CLIENT_FINGERPRINT.hex() in str(e.value)
    assert schema.FINGERPRINT.hex() in str(e.value)
    # This build's frame of the same payload decodes.
    blob = log_codec.encode_payload({"job_id": "per", "purge": True})
    assert blob[10:] == PRE_CLIENT_FRAME[10:]
    assert log_codec.decode_payload(blob) == {"job_id": "per", "purge": True}


def test_client_task_states_decode_as_the_reference_states():
    """An alloc's task states with every client field, through both
    codecs: the port's decode equals the reference's, field for field."""
    ev = dict(type="Restarting", time=3.5, message="m", driver_error="d",
              exit_code=1, signal=9, kill_timeout=5.0, restart_reason="r",
              failed_sibling="s", failed=True, start_delay=0.25)
    ref = {"states": {"web": js.TaskState(
        state="dead", failed=True, started_at=1.0, finished_at=2.0,
        events=[js.TaskEvent(**ev), js.TaskEvent(type="Received")])}}
    port = {"states": {"web": ps.TaskState(
        state="dead", failed=True, started_at=1.0, finished_at=2.0,
        events=[ps.TaskEvent(**ev), ps.TaskEvent(type="Received")])}}
    ref_out = jlog_codec.decode_payload(jlog_codec.encode_payload(ref))
    port_out = log_codec.decode_payload(log_codec.encode_payload(port))
    assert as_plain(port_out) == as_plain(ref_out) == as_plain(port)
    assert port_out["states"]["web"].events[0].display_message() == \
        ref_out["states"]["web"].events[0].display_message() == "m"
