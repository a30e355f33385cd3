"""The port's RPC layer (``nomad_tpu_torch/server/rpc.py``) and the bodies
the cluster sends through it (reference ``nomad_tpu/server/rpc.py``,
``endpoints.py``, ``follower_sched.py``, ``raft.py``).

- Every body type the cluster sends round-trips through the struct codec
  (subsystem ``rpc``): the ``Eval.*`` requests and replies, a
  wire-stripped ``Plan.Submit`` and its compact full-commit reply, the
  ``Serf.*`` member records, the raft messages (RequestVote,
  AppendEntries with ``[index, term, type, blob]`` entries, a chunked
  InstallSnapshot) and a ``CONFIG`` entry's voter set.  A body outside
  the schema raises ``CodecError`` at encode: there is no msgpack.
- What arrives must be a frame of this build's schema: a non-frame, a
  frame of another fingerprint and a reference peer's frame raise
  ``TransportError`` (the two packages do not interoperate on the wire).
- Call, a typed error reply (``NoLeaderError`` re-typed), connection
  reuse and ``invalidate``; a dial to a closed port raises ``DialError``;
  the first byte demuxes the Nomad and raft channels.
"""
import dataclasses
import socket
import threading

import pytest

from nomad_tpu import mock as jmock
from nomad_tpu_torch import codec, convert, mock
from nomad_tpu_torch.server import rpc
from nomad_tpu_torch.server.follower_sched import LeaderChannel
from nomad_tpu_torch.server.raft import (CONFIG_TYPE, _decode_peers,
                                         _encode_peers)
from nomad_tpu_torch.server.fsm import FSM, MessageType
from nomad_tpu_torch.server.log_codec import encode_payload
from nomad_tpu_torch.structs import structs as s
from nomad_tpu_torch.utils import tracing
from nomad_tpu_torch.utils.telemetry import Telemetry


def mock_eval():
    return convert.eval_from_dict(dataclasses.asdict(jmock.eval()))


def mock_alloc():
    return convert.alloc_from_dict(dataclasses.asdict(jmock.alloc()))


def plan_with_placements(n_allocs=6):
    """A plan as the CPU scheduler makes it: every placement embeds the
    job; one network-less task group (slabbable past COMPACT_MIN)."""
    job = mock.job()
    for t in job.task_groups[0].tasks:
        t.resources.networks = []
    ev = mock_eval()
    plan = ev.make_plan(job)
    for i in range(n_allocs):
        a = mock_alloc()
        a.job, a.job_id = job, job.id
        a.node_id = f"node-{i % 3}"
        a.name = f"{job.id}.web[{i}]"
        a.resources.networks = []
        for tr in a.task_resources.values():
            tr.networks = []
        plan.node_allocation.setdefault(a.node_id, []).append(a)
    return plan


def idle(pool, addr):
    """Idle pooled connections to ``addr`` (all channels)."""
    return sum(len(b) for k, b in pool._idle.items() if k[0] == addr)


def roundtrip(obj):
    return codec.decode(codec.encode(obj, "rpc"), "rpc")


def bodies():
    ev = mock_eval()
    node = mock.node()
    job = mock.job()
    stripped = LeaderChannel._strip_plan_for_wire(plan_with_placements())
    fsm = FSM()
    fsm.apply(1, MessageType.NODE_REGISTER, {"node": node})
    snap = fsm.snapshot()
    member = {"Name": "s1", "Addr": "127.0.0.1:4647", "Region": "global",
              "Status": "alive", "StatusTime": 3, "NonVoter": False}
    entry = [7, 2, int(MessageType.JOB_REGISTER),
             encode_payload({"job": job})]
    return {
        "Node.Register": {"Node": node, "__forwarded__": True},
        "Node.Register.reply": {"Index": 12, "HeartbeatTTL": 10.5},
        "Job.Register": {"Job": job},
        "Job.Register.reply": {"Index": 13, "EvalID": ev.id},
        "Eval.DequeueBatch": {"Schedulers": ["service", "batch"],
                              "Max": 8, "Timeout": 0.5},
        "Eval.DequeueBatch.reply": {
            "Evals": [{"Eval": ev, "Token": "tok", "Attempts": 1,
                       "PlanFence": 40}], "AppliedIndex": 41},
        "Eval.Dequeue.reply": {"Eval": None, "Token": ""},
        "Eval.Ack": {"EvalID": ev.id, "Token": "tok"},
        "Eval.Update": {"Evals": [ev, mock_eval()]},
        "Eval.Reblock": {"Eval": ev, "Token": "tok"},
        "Eval.GetEval.reply": {"Eval": ev},
        "Plan.Submit": {"Plan": stripped},
        "Plan.Submit.full": {"Result": {"Full": True, "AllocIndex": 99}},
        "Plan.Submit.result": {"Result": s.PlanResult(
            node_allocation=stripped.node_allocation, refresh_index=5,
            alloc_index=6)},
        "Serf.Join": {"Member": member},
        "Serf.Members.reply": {"Members": [member, dict(member, Name="s2")]},
        "raft.request_vote": {"kind": "request_vote", "term": 4,
                              "candidate": "127.0.0.1:1",
                              "last_log_index": 9, "last_log_term": 3},
        "raft.append_entries": {
            "kind": "append_entries", "term": 4, "leader": "127.0.0.1:1",
            "prev_log_index": 6, "prev_log_term": 2,
            "entries": [entry, [8, 4, CONFIG_TYPE,
                                _encode_peers(["a:1", "b:2"])]],
            "leader_commit": 7},
        "raft.append_entries.reply": {"success": True, "term": 4,
                                      "match": 8},
        "raft.install_snapshot": {
            "kind": "install_snapshot", "term": 4, "leader": "127.0.0.1:1",
            "last_index": 9, "last_term": 3, "peers": ["a:1", "b:2"],
            "data": snap[:64], "offset": 0, "total": len(snap),
            "done": False},
        "raft.install_snapshot.reply": {"term": 4, "success": True},
    }


@pytest.mark.parametrize("name", sorted(bodies()))
def test_every_body_round_trips(name):
    body = bodies()[name]
    frame = codec.encode(body, "rpc")
    assert codec.is_frame(frame)
    assert codec.decode(frame, "rpc") == body


def test_config_voter_set_is_a_codec_frame():
    blob = _encode_peers(["127.0.0.1:3", "127.0.0.1:1"])
    assert codec.is_frame(blob)
    assert _decode_peers(blob) == ["127.0.0.1:3", "127.0.0.1:1"]


def test_stripped_plan_ships_the_job_once():
    plan = plan_with_placements(6)
    slim = LeaderChannel._strip_plan_for_wire(plan)
    # One task group of six placements rides one slab; the caller's
    # objects are untouched.
    assert not slim.node_allocation
    assert len(slim.alloc_slabs) == 1 and len(slim.alloc_slabs[0]) == 6
    assert slim.alloc_slabs[0].proto.job is None
    assert all(a.job is plan.job for allocs in plan.node_allocation.values()
               for a in allocs)
    # Below COMPACT_MIN the per-alloc form stays, without the job.
    few = LeaderChannel._strip_plan_for_wire(plan_with_placements(2))
    assert not few.alloc_slabs
    assert all(a.job is None for allocs in few.node_allocation.values()
               for a in allocs)
    assert roundtrip({"Plan": few}) == {"Plan": few}
    assert len(codec.encode({"Plan": slim}, "rpc")) < len(
        codec.encode({"Plan": plan}, "rpc"))


@pytest.mark.parametrize("bad", [object(), {1, 2}, {"Node": threading.Lock()},
                                 [1, 2 ** 70]])
def test_a_body_outside_the_schema_raises_at_encode(bad):
    with pytest.raises(codec.CodecError):
        codec.encode(bad, "rpc")


def test_rpc_frames_are_counted_under_rpc():
    codec.reset()
    roundtrip({"Member": {"Name": "x"}})
    st = codec.stats()["rpc"]
    assert st["encodes"] == 1 and st["decodes"] == 1


# -- the wire ------------------------------------------------------------------

@pytest.fixture
def server():
    srv = rpc.RPCServer(metrics=Telemetry())
    srv.register("Echo.Body", lambda body: body)
    srv.register("Status.Leader", lambda body: "127.0.0.1:9")

    def no_leader(body):
        raise rpc.NoLeaderError("127.0.0.1:4242")

    def boom(body):
        raise KeyError("gone")

    srv.register("Fail.NoLeader", no_leader)
    srv.register("Fail.KeyError", boom)
    srv.register("Reply.Unencodable", lambda body: object())
    srv.start()
    yield srv
    srv.shutdown()


def test_call_and_connection_reuse(server):
    pool = rpc.ConnPool(timeout=5.0)
    try:
        node = mock.node()
        assert pool.call(server.address, "Echo.Body", {"Node": node}) == {
            "Node": node}
        assert idle(pool, server.address) == 1
        conn = pool._idle[(server.address, rpc.RPC_NOMAD)][0]
        assert pool.call(server.address, "Status.Leader", {}) == \
            "127.0.0.1:9"
        # The same connection served the second call and went back.
        assert pool._idle[(server.address, rpc.RPC_NOMAD)] == [conn]
        assert conn.seq == 2
        pool.invalidate(server.address)
        assert idle(pool, server.address) == 0
        assert pool.call(server.address, "Status.Leader", {}) == \
            "127.0.0.1:9"
    finally:
        pool.close()


def test_typed_error_replies_keep_the_connection(server):
    pool = rpc.ConnPool(timeout=5.0)
    try:
        with pytest.raises(rpc.NoLeaderError) as exc:
            pool.call(server.address, "Fail.NoLeader", {})
        assert str(exc.value) == "127.0.0.1:4242"
        with pytest.raises(rpc.RPCError, match="KeyError: 'gone'"):
            pool.call(server.address, "Fail.KeyError", {})
        with pytest.raises(rpc.RPCError, match="can't find method"):
            pool.call(server.address, "No.Such", {})
        # A reply outside the schema comes back as the error it is.
        with pytest.raises(rpc.RPCError, match="CodecError"):
            pool.call(server.address, "Reply.Unencodable", {})
        # A request outside the schema is refused before it is sent.
        with pytest.raises(codec.CodecError):
            pool.call(server.address, "Echo.Body", {"x": object()})
        assert idle(pool, server.address) == 1
        assert pool.call(server.address, "Echo.Body", [1]) == [1]
        totals = server.metrics.sink.latest()["CounterTotals"]
        assert totals["nomad.rpc.request"] == 5
        assert totals["nomad.rpc.request_error"] == 2
    finally:
        pool.close()


def test_dial_to_a_closed_port_raises_dial_error():
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    pool = rpc.ConnPool(timeout=2.0)
    addr = f"127.0.0.1:{port}"
    with pytest.raises(rpc.DialError):
        pool.call(addr, "Status.Ping", {})
    # The dial gate now fails fast, without a socket.
    with pytest.raises(rpc.DialError, match="dial backoff"):
        pool.call(addr, "Status.Ping", {})
    pool.invalidate(addr)
    assert addr not in pool._dial_gate


def _raw_reply(payload: bytes):
    """A one-shot listener that answers any request with ``payload``
    behind a valid length prefix; the address."""
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)

    def serve():
        conn, _ = lsock.accept()
        with conn:
            conn.recv(65536)
            conn.sendall(rpc._LEN.pack(len(payload)) + payload)
        lsock.close()

    threading.Thread(target=serve, daemon=True).start()
    return "127.0.0.1:%d" % lsock.getsockname()[1]


def test_a_non_frame_raises_transport_error():
    pool = rpc.ConnPool(timeout=5.0)
    with pytest.raises(rpc.TransportError, match="not a struct-codec"):
        pool.call(_raw_reply(b"\x93\x01\xc0\xc0"), "Status.Ping", {})


def test_a_frame_of_another_schema_raises_transport_error():
    frame = bytearray(codec.encode([1, None, {"ok": True}], "rpc"))
    frame[2:10] = bytes(8)
    pool = rpc.ConnPool(timeout=5.0)
    with pytest.raises(rpc.TransportError, match="fingerprint"):
        pool.call(_raw_reply(bytes(frame)), "Status.Ping", {})


def test_reference_frames_do_not_interoperate():
    from nomad_tpu import codec as jcodec
    from nomad_tpu.server import rpc as jrpc

    # A reference peer's reply frame: the reference's codec, whose schema
    # fingerprint is not the port's.
    ref_frame = jcodec.encode([1, None, {"ok": True}], "rpc")
    pool = rpc.ConnPool(timeout=5.0)
    with pytest.raises(rpc.TransportError, match="fingerprint"):
        pool.call(_raw_reply(ref_frame), "Status.Ping", {})
    # A reference server drops the port's request frame.
    jsrv = jrpc.RPCServer()
    jsrv.register("Status.Ping", lambda body: {"ok": True})
    jsrv.start()
    try:
        with pytest.raises(rpc.TransportError):
            pool.call(jsrv.address, "Status.Ping", {})
    finally:
        jsrv.shutdown()


def test_first_byte_demuxes_the_raft_channel(server):
    pool = rpc.ConnPool(timeout=5.0)
    try:
        with pytest.raises(rpc.RPCError, match="raft: not ready"):
            pool.call(server.address, "raft", {"kind": "request_vote"},
                      channel=rpc.RPC_RAFT)
        got = []
        server.raft_handler = lambda body: got.append(body) or {"term": 3}
        msg = bodies()["raft.append_entries"]
        assert pool.call(server.address, "raft", msg,
                         channel=rpc.RPC_RAFT) == {"term": 3}
        assert got == [msg]
        # The same method name on the Nomad channel is an endpoint lookup.
        with pytest.raises(rpc.RPCError, match="can't find method raft"):
            pool.call(server.address, "raft", msg)
        assert {k[1] for k in pool._idle} == {rpc.RPC_NOMAD, rpc.RPC_RAFT}
    finally:
        pool.close()


def test_an_unknown_protocol_byte_is_dropped(server):
    with socket.create_connection(("127.0.0.1", server.port), 5.0) as sock:
        sock.sendall(b"\x05")
        assert sock.recv(16) == b""


def test_request_span_and_method_timing(server):
    tracing.enable()
    try:
        pool = rpc.ConnPool(timeout=5.0)
        pool.call(server.address, "Status.Leader", {})
        pool.close()
        spans = [sp for sp in tracing.recent(50)
                 if sp["Name"] == "rpc.request"]
    finally:
        tracing.disable()
    assert [(sp["ParentID"], sp["Attrs"]) for sp in spans] == [
        (0, {"method": "Status.Leader"})]
    samples = server.metrics.sink.latest()["SampleTotals"]
    assert "nomad.rpc.request.Status.Leader" in samples


def test_shutdown_severs_established_connections(server):
    pool = rpc.ConnPool(timeout=5.0)
    pool.call(server.address, "Status.Leader", {})
    server.shutdown()
    with pytest.raises(rpc.TransportError):
        pool.call(server.address, "Status.Leader", {})
    assert not server.threads()


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_tls_off_gives_no_contexts(kind):
    if kind == "ref":
        from nomad_tpu.utils import tlsutil
    else:
        from nomad_tpu_torch.utils import tlsutil
    cfg = tlsutil.TLSConfig()
    assert not cfg.enabled and not cfg.verify_server_hostname
    assert tlsutil.server_context(cfg) is None
    assert tlsutil.client_context(cfg) is None


def test_struct_bodies_keep_their_types():
    ev = mock_eval()
    got = roundtrip({"Evals": [{"Eval": ev}]})["Evals"][0]["Eval"]
    assert type(got) is s.Evaluation
    assert dataclasses.asdict(got) == dataclasses.asdict(ev)
