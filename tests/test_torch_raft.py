"""The port's replicated cluster: ``MultiRaft`` under port ``Server``s on
loopback ports (the counterparts of the reference's
``tests/test_cluster.py`` scenarios; reference nomad/leader_test.go,
serf_test.go, raft_rpc.go).

- Election, replication, forwarding from a follower over the wire, and
  failover with no state lost; writes go on through the new leader.
- A follower restarted on its data dir recovers its log and catches up;
  a fresh peer behind the leader's compaction horizon gets an
  InstallSnapshot, whole or in 1 KB chunks; an out-of-sequence chunk is
  refused and a restart from offset 0 recovers.
- Term and vote survive a restart (no second vote in a term), and the
  store is CRC-framed codec frames whose torn tail is truncated.
- A dead peer is removed through a follower (forwarded to the leader);
  a force-left server that is alive rejoins; a ``non_voting`` member
  replicates as a learner of a ``force_multi_raft`` seed; the worker's
  wire surface (``Eval.Dequeue``/``Ack``/``GetEval``, the operator's raft
  configuration) answers.
- ``MultiRaft.apply`` passes the ``raft.apply`` fault point and is
  traced as ``raft.apply``.

Every cluster runs the slowed election timing the reference's loadgen
harness uses on loaded hosts (``nomad_tpu/loadgen/harness.py:45-47``:
heartbeats every 0.2 s, elections after 5 to 8 s), passed as
``ServerConfig`` arguments, so a loaded test host does not depose a
leader mid-test.  Every wait has a deadline; no check depends on which
server wins an election.
"""
import os

import pytest

from nomad_tpu_torch import codec, mock
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.fsm import FSM, MessageType
from nomad_tpu_torch.server.log_codec import encode_payload
from nomad_tpu_torch.server.raft import MultiRaft, _read_crc_frames
from nomad_tpu_torch.server.rpc import ConnPool
from nomad_tpu_torch.utils.backoff import wait_until

SLOW_RAFT = {"raft_heartbeat": 0.2, "raft_election_min": 5.0,
             "raft_election_max": 8.0}
# Two elections at most 8 s each, with room for a split vote.
ELECTION_TIMEOUT = 40.0
CATCH_UP_TIMEOUT = 20.0


def make_job(count=1):
    j = mock.job()
    j.task_groups[0].count = count
    for t in j.task_groups[0].tasks:
        t.resources.networks = []
    return j


def port_of(srv):
    return int(srv.config.rpc_advertise.rsplit(":", 1)[1])


def server_config(name, data_dir="", start_join=(), bootstrap_expect=3,
                  **kw):
    kw.setdefault("num_schedulers", 0)
    return ServerConfig(device="cpu", node_name=name, data_dir=data_dir,
                        enable_rpc=True, bootstrap_expect=bootstrap_expect,
                        start_join=list(start_join),
                        min_heartbeat_ttl=3600.0, **SLOW_RAFT, **kw)


def make_cluster(n=3, data_root=None, **kw):
    """``n`` port servers in this process; the first is the join point
    (the seed, which bootstraps the voter set)."""
    servers, first = [], None
    for i in range(n):
        d = str(data_root / f"s{i + 1}") if data_root is not None else ""
        srv = Server(server_config(f"server-{i + 1}", d,
                                   [first] if first else [],
                                   bootstrap_expect=n, **kw))
        if first is None:
            first = srv.config.rpc_advertise
        servers.append(srv)
    for srv in servers:
        srv.start()
    return servers


def find_leader(servers):
    for srv in servers:
        if srv.is_leader() and srv.raft.is_raft_leader():
            return srv
    return None


def wait_for_leader(servers, timeout=ELECTION_TIMEOUT):
    if not wait_until(lambda: find_leader(servers) is not None, timeout,
                      max_interval=0.05):
        detail = "; ".join(
            f"{srv.config.node_name}: raft={srv.raft.state} "
            f"term={srv.raft.term} leader_flag={srv.is_leader()} "
            f"peers={len(srv.raft.peers)} members={len(srv.members())}"
            for srv in servers)
        raise AssertionError(f"no leader elected: {detail}")
    return find_leader(servers)


def shutdown_all(servers):
    for srv in servers:
        srv.shutdown()
    for srv in servers:
        assert wait_until(lambda: not srv.threads(), 15.0), srv.threads()


def test_election_replication_forwarding_failover(tmp_path):
    servers = make_cluster(3, tmp_path)
    pool = ConnPool()
    try:
        leader = wait_for_leader(servers)
        followers = [srv for srv in servers if srv is not leader]
        assert wait_until(lambda: all(len(srv.members()) == 3
                                      for srv in servers), 10.0)
        assert wait_until(lambda: all(
            srv.leader_address() == leader.config.rpc_advertise
            for srv in servers), 10.0)
        assert wait_until(lambda: all(len(srv.raft.peers) == 3
                                      for srv in servers), 10.0)

        # A register sent to a follower over the wire forwards to the
        # leader (rpc.go:178) and replicates to all three.
        job = make_job()
        reply = pool.call(followers[0].config.rpc_advertise,
                          "Job.Register", {"Job": job})
        assert reply["Index"] > 0 and reply["EvalID"]
        assert leader.metrics.sink.latest()["CounterTotals"].get(
            "nomad.rpc.forward", 0) == 0
        assert followers[0].metrics.sink.latest()["CounterTotals"][
            "nomad.rpc.forward"] == 1
        assert wait_until(lambda: all(
            srv.state.job_by_id(None, job.id) is not None
            for srv in servers), CATCH_UP_TIMEOUT)
        assert wait_until(lambda: len({srv.fsm_fingerprint()
                                       for srv in servers}) == 1,
                          CATCH_UP_TIMEOUT)

        # The leader dies: the survivors elect a new one, nothing is lost.
        acked = leader.raft.applied_index()
        leader.shutdown()
        new_leader = wait_for_leader(followers)
        assert new_leader.raft.applied_index() >= acked
        assert new_leader.state.job_by_id(None, job.id) is not None

        job2 = make_job()
        reply2 = pool.call(new_leader.config.rpc_advertise,
                           "Job.Register", {"Job": job2})
        assert reply2["Index"] > reply["Index"]
        assert wait_until(lambda: all(
            srv.state.job_by_id(None, job2.id) is not None
            for srv in followers), CATCH_UP_TIMEOUT)
        assert wait_until(lambda: len({srv.fsm_fingerprint()
                                       for srv in followers}) == 1,
                          CATCH_UP_TIMEOUT)
    finally:
        pool.close()
        shutdown_all(servers)


def test_follower_restart_catches_up(tmp_path):
    servers = make_cluster(3, tmp_path)
    try:
        leader = wait_for_leader(servers)
        follower = next(srv for srv in servers if srv is not leader)
        job1 = make_job()
        leader.job_register(job1)
        assert wait_until(
            lambda: follower.state.job_by_id(None, job1.id) is not None,
            CATCH_UP_TIMEOUT)

        # The follower stops; a write lands while it is down; it restarts
        # on the same data dir and port: its own log and term recover,
        # the leader replays the suffix it missed.
        idx = servers.index(follower)
        cfg = follower.config
        follower.shutdown()
        job2 = make_job()
        leader.job_register(job2)
        restarted = Server(server_config(
            cfg.node_name, cfg.data_dir, [leader.config.rpc_advertise],
            rpc_port=port_of(follower)))
        assert restarted.raft.term >= 1
        assert restarted.raft._last_log_index() > 0
        servers[idx] = restarted
        restarted.start()
        assert wait_until(
            lambda: restarted.state.job_by_id(None, job2.id) is not None,
            CATCH_UP_TIMEOUT), "the restarted follower did not catch up"
        assert restarted.state.job_by_id(None, job1.id) is not None
        assert wait_until(lambda: restarted.fsm_fingerprint()
                          == leader.fsm_fingerprint(), CATCH_UP_TIMEOUT)
    finally:
        shutdown_all(servers)


def _fresh_peer_after_compaction(tmp_path, servers, jobs):
    """Stop a follower, compact the leader past ``jobs``, and start a
    fresh server on the follower's port with an empty data dir."""
    leader = wait_for_leader(servers)
    follower = next(srv for srv in servers if srv is not leader)
    for job in jobs:
        leader.job_register(job)
    idx = servers.index(follower)
    follower.shutdown()
    leader.job_register(make_job())
    leader.raft.snapshot()
    assert leader.raft.base_index > 0 and not leader.raft.log
    fresh = Server(server_config(
        "server-fresh", str(tmp_path / "fresh"),
        [leader.config.rpc_advertise], rpc_port=port_of(follower),
        snapshot_chunk=leader.config.snapshot_chunk))
    servers[idx] = fresh
    fresh.start()
    return leader, fresh


def test_snapshot_install_for_a_fresh_peer(tmp_path):
    servers = make_cluster(3, tmp_path)
    try:
        jobs = [make_job()]
        leader, fresh = _fresh_peer_after_compaction(tmp_path, servers,
                                                     jobs)
        assert wait_until(lambda: fresh.state.job_by_id(
            None, jobs[0].id) is not None, CATCH_UP_TIMEOUT), \
            "the fresh peer did not receive a snapshot"
        assert wait_until(
            lambda: fresh.raft.base_index >= leader.raft.base_index, 5.0)
        assert wait_until(lambda: fresh.fsm_fingerprint()
                          == leader.fsm_fingerprint(), CATCH_UP_TIMEOUT)
        assert leader.metrics.sink.latest()["CounterTotals"].get(
            "nomad.raft.snapshot.chunks_sent", 0) == 0
    finally:
        shutdown_all(servers)


def test_chunked_install_at_a_1kb_chunk(tmp_path):
    servers = make_cluster(3, tmp_path, snapshot_chunk=1024)
    try:
        jobs = [make_job() for _ in range(5)]
        leader, fresh = _fresh_peer_after_compaction(tmp_path, servers,
                                                     jobs)
        assert wait_until(lambda: all(
            fresh.state.job_by_id(None, j.id) is not None for j in jobs),
            CATCH_UP_TIMEOUT), "the fresh peer did not get the chunks"
        assert wait_until(
            lambda: fresh.raft.base_index >= leader.raft.base_index, 5.0)
        totals = leader.metrics.sink.latest()["CounterTotals"]
        assert totals.get("nomad.raft.snapshot.chunks_sent", 0) >= 2
        # The installed snapshot is on the fresh peer's disk, framed.
        snaps = [n for n in os.listdir(tmp_path / "fresh" / "raft")
                 if n.startswith("snapshot-")]
        assert snaps
    finally:
        shutdown_all(servers)


def test_out_of_sequence_chunk_refused_then_recovers():
    src = FSM()
    job = make_job()
    src.apply(1, MessageType.JOB_REGISTER, {"job": job})
    blob = src.snapshot()
    cut = len(blob) // 2

    r = MultiRaft(FSM(), "127.0.0.1:1", pool=None, data_dir=None)
    base = {"kind": "install_snapshot", "term": 1,
            "leader": "127.0.0.1:2", "last_index": 7, "last_term": 1,
            "peers": ["127.0.0.1:1", "127.0.0.1:2"], "total": len(blob)}
    ok = r.handle_message(dict(base, offset=0, data=blob[:cut], done=False))
    assert ok["success"] is True
    # A skip ahead breaks the sequence: refused, the buffer dropped, the
    # FSM untouched.
    bad = r.handle_message(dict(base, offset=cut + 8, data=blob[cut + 8:],
                                done=True))
    assert bad["success"] is False
    assert r.fsm.state.job_by_id(None, job.id) is None
    assert r.handle_message(dict(base, offset=0, data=blob[:cut],
                                 done=False))["success"] is True
    fin = r.handle_message(dict(base, offset=cut, data=blob[cut:],
                                done=True))
    assert fin["success"] is True
    assert r.fsm.state.job_by_id(None, job.id) is not None
    assert r.base_index == 7 and r.applied_index() == 7
    assert r.peers == ["127.0.0.1:1", "127.0.0.1:2"]
    r.close()


def test_term_and_vote_survive_a_restart(tmp_path):
    """A restarted server must not vote twice in one term (Raft §5.2)."""
    r = MultiRaft(FSM(), "127.0.0.1:1", pool=None,
                  data_dir=str(tmp_path / "raft"))
    r.term = 7
    r.voted_for = "127.0.0.1:2"
    r._persist_meta()
    r.log.append([1, 7, int(MessageType.JOB_REGISTER),
                  encode_payload({"job": make_job()})])
    r.store.append([r.log[-1]])
    r.close()

    r2 = MultiRaft(FSM(), "127.0.0.1:1", pool=None,
                   data_dir=str(tmp_path / "raft"))
    assert r2.term == 7
    assert r2.voted_for == "127.0.0.1:2"
    assert r2._last_log_index() == 1
    # The recovered entry is not applied: it was never known committed.
    assert r2.applied_index() == 0
    reply = r2._on_request_vote({
        "term": 7, "candidate": "127.0.0.1:3",
        "last_log_index": 5, "last_log_term": 7})
    assert reply["granted"] is False
    assert r2._on_request_vote({
        "term": 7, "candidate": "127.0.0.1:2",
        "last_log_index": 5, "last_log_term": 7})["granted"] is True
    r2.close()


def test_store_is_crc_framed_codec_frames_with_a_torn_tail_cut(tmp_path):
    d = tmp_path / "raft"
    r = MultiRaft(FSM(), "127.0.0.1:1", pool=None, data_dir=str(d))
    r.term = 2
    r._persist_meta()
    entries = [[i, 2, int(MessageType.JOB_REGISTER),
                encode_payload({"job": make_job()})] for i in (1, 2, 3)]
    r.log.extend(entries)
    r.store.append(entries)
    r.close()
    for name in ("meta.crc", "wal.crc"):
        frames, good, size = _read_crc_frames(str(d / name))
        assert frames and good == size
        assert all(codec.is_frame(f) for f in frames)
    size = os.path.getsize(d / "wal.crc")
    with open(d / "wal.crc", "ab") as fh:
        fh.write(b"\x40\x00\x00\x00\xde\xad")  # a torn frame
    r2 = MultiRaft(FSM(), "127.0.0.1:1", pool=None, data_dir=str(d))
    assert r2._last_log_index() == 3 and r2.term == 2
    assert os.path.getsize(d / "wal.crc") == size
    assert [e[0] for e in r2.log] == [1, 2, 3]
    r2.close()


def test_remove_a_dead_peer_through_a_follower(tmp_path):
    servers = make_cluster(3, tmp_path)
    pool = ConnPool()
    try:
        leader = wait_for_leader(servers)
        assert wait_until(lambda: all(len(srv.raft.peers) == 3
                                      for srv in servers), 10.0)
        dead, alive = [srv for srv in servers if srv is not leader]
        dead_addr = dead.config.rpc_advertise
        dead.shutdown()
        # Through the surviving follower: it forwards to the leader.
        pool.call(alive.config.rpc_advertise,
                  "Operator.RaftRemovePeerByAddress", {"Address": dead_addr})
        assert dead_addr not in leader.raft.peers
        assert set(leader.raft.peers) == {leader.config.rpc_advertise,
                                          alive.config.rpc_advertise}
        assert wait_until(lambda: dead_addr not in alive.raft.peers,
                          CATCH_UP_TIMEOUT)
        # The leader's typed errors come back by type through a follower.
        with pytest.raises(KeyError):
            alive.operator_raft_remove_peer("10.0.0.9:4647")
        with pytest.raises(Exception, match="KeyError"):
            pool.call(leader.config.rpc_advertise,
                      "Operator.RaftRemovePeerByAddress",
                      {"Address": "10.0.0.9:4647"})
        cfg = pool.call(alive.config.rpc_advertise,
                        "Operator.RaftGetConfiguration", {})
        assert sum(s_["Leader"] for s_ in cfg["Servers"]) == 1
    finally:
        pool.close()
        shutdown_all(servers)


def test_force_left_server_rejoins():
    a = Server(server_config("srv-a", bootstrap_expect=1))
    b = Server(server_config("srv-b", bootstrap_expect=1))
    a.start()
    b.start()
    try:
        assert a.join([b.config.rpc_advertise]) == 1
        assert wait_until(lambda: len(a.members()) == 2
                          and len(b.members()) == 2, 10.0)
        assert a.force_leave("srv-b")
        assert wait_until(lambda: any(
            m["Name"] == "srv-b" and m["Status"] == "left"
            for m in a.members()), 10.0)
        assert b.join([a.config.rpc_advertise]) == 1
        assert wait_until(lambda: all(any(
            m["Name"] == "srv-b" and m["Status"] == "alive"
            for m in srv.members()) for srv in (a, b)), 10.0), (
            a.members(), b.members())
    finally:
        shutdown_all([b, a])


def test_the_worker_surface_over_the_wire():
    """A single-voter server with RPC: a remote worker dequeues, acks and
    reads an eval over the wire (eval_endpoint.go)."""
    srv = Server(server_config("solo", bootstrap_expect=1))
    assert not isinstance(srv.raft, MultiRaft)
    srv.start()
    pool = ConnPool()
    try:
        addr = srv.config.rpc_advertise
        assert pool.call(addr, "Status.Ping", {}) == {"ok": True}
        assert pool.call(addr, "Status.Leader", {}) == addr
        assert pool.call(addr, "Status.Peers", {}) == [addr]
        node = mock.node()
        node.resources.networks = []
        node.reserved.networks = []
        assert pool.call(addr, "Node.Register", {"Node": node})["Index"] > 0
        job = make_job(1)
        reply = pool.call(addr, "Job.Register", {"Job": job})
        dq = pool.call(addr, "Eval.Dequeue",
                       {"Schedulers": [job.type], "Timeout": 5.0})
        assert dq["Eval"].id == reply["EvalID"]
        pool.call(addr, "Eval.Ack",
                  {"EvalID": reply["EvalID"], "Token": dq["Token"]})
        got = pool.call(addr, "Eval.GetEval", {"EvalID": reply["EvalID"]})
        assert got["Eval"].id == reply["EvalID"]
        fp = pool.call(addr, "Status.Fingerprint", {})
        assert (fp["Index"], fp["Fingerprint"]) == srv.fsm_fingerprint()
        cfg = pool.call(addr, "Operator.RaftGetConfiguration", {})
        assert [x["Address"] for x in cfg["Servers"]] == [addr]
        with pytest.raises(Exception, match="TypeError"):
            pool.call(addr, "Node.Register", {"Node": {"ID": "x"}})
    finally:
        pool.close()
        shutdown_all([srv])


def test_apply_span_and_fault_points_on_a_lone_voter():
    """``MultiRaft.apply`` passes the ``raft.apply`` fault point before
    the entry gets its index and is traced as ``raft.apply``, as
    ``FileLog.apply`` is: a crash raises with nothing appended, a
    step_down demotes the leader."""
    from nomad_tpu_torch import fault
    from nomad_tpu_torch.server.raft import NotLeaderError
    from nomad_tpu_torch.utils import tracing

    r = MultiRaft(FSM(), "127.0.0.1:1", pool=None, data_dir=None)
    r.bootstrap(["127.0.0.1:1"])
    r._run_election()           # no peers: a quorum of one
    assert r.state == "leader" and r.term == 1
    tracing.enable()
    try:
        _, index = r.apply(MessageType.JOB_REGISTER, {"job": make_job()})
        spans = [sp for sp in tracing.recent(20)
                 if sp["Name"] == "raft.apply"]
    finally:
        tracing.disable()
    assert [sp["Attrs"] for sp in spans] == [
        {"index": index, "msg_type": "JOB_REGISTER"}]
    last = r._last_log_index()
    with fault.scenario({"seed": 1, "faults": [
            {"point": "raft.apply", "action": "crash", "times": 1}]}):
        with pytest.raises(fault.InjectedFault):
            r.apply(MessageType.JOB_REGISTER, {"job": make_job()})
    assert r._last_log_index() == last and r.state == "leader"
    with fault.scenario({"seed": 1, "faults": [
            {"point": "raft.apply", "action": "step_down", "times": 1}]}):
        with pytest.raises(NotLeaderError):
            r.apply(MessageType.JOB_REGISTER, {"job": make_job()})
    assert r.state == "follower" and r._last_log_index() == last
    r.close()


def test_a_non_voting_member_replicates_as_a_learner():
    """``force_multi_raft`` makes a lone seed a ``MultiRaft`` voter; a
    ``non_voting`` member that joins it is replicated to (a learner: its
    FSM applies the log) but never enters the voter set or campaigns."""
    seed = Server(server_config("seed", bootstrap_expect=1,
                                force_multi_raft=True))
    assert isinstance(seed.raft, MultiRaft)
    learner = Server(server_config("learner", bootstrap_expect=1,
                                   non_voting=True,
                                   start_join=[seed.config.rpc_advertise]))
    assert isinstance(learner.raft, MultiRaft)
    servers = [seed, learner]
    for srv in servers:
        srv.start()
    try:
        leader = wait_for_leader([seed])
        assert leader is seed
        job = make_job()
        leader.job_register(job)
        assert wait_until(lambda: learner.state.job_by_id(None, job.id)
                          is not None, CATCH_UP_TIMEOUT)
        assert learner.config.rpc_advertise in seed.raft.learners
        assert seed.raft.peers == [seed.config.rpc_advertise]
        assert learner.raft.state == "follower" and learner.raft.term == \
            seed.raft.term
        cfg = seed.raft_configuration()
        assert {(x["Node"], x["Voter"]) for x in cfg["Servers"]} == {
            ("seed", True), ("learner", False)}
    finally:
        shutdown_all(servers)


def test_a_new_leader_restores_only_after_its_barrier(monkeypatch, caplog):
    """A new leader on the replicated log restores nothing from the store
    until the entries of earlier terms have applied: with the applier
    held past several rounds of the barrier it keeps waiting (each round
    logged) and restores nothing; once they apply it restores; and
    leadership lost while the applier is held establishes nothing."""
    import logging
    import threading

    from nomad_tpu_torch.server import server as server_mod

    monkeypatch.setattr(server_mod, "LEADER_BARRIER_TIMEOUT", 0.05)
    srv = Server(server_config("seed", bootstrap_expect=1,
                               force_multi_raft=True))
    assert isinstance(srv.raft, MultiRaft)
    srv.rpc.start()             # the listener only: no raft, no election
    log = {"applied": 5, "fence": 10, "leader": True}
    monkeypatch.setattr(srv.raft, "fence_index", lambda: log["fence"])
    monkeypatch.setattr(srv.raft, "applied_index", lambda: log["applied"])
    monkeypatch.setattr(srv.raft, "is_raft_leader", lambda: log["leader"])
    restores = []
    real_restore = srv._restore_evals
    monkeypatch.setattr(srv, "_restore_evals",
                        lambda: (restores.append(log["applied"]),
                                 real_restore()))

    def establish():
        t = threading.Thread(target=srv._establish_leadership, daemon=True)
        t.start()
        return t

    caplog.set_level(logging.ERROR)
    try:
        t = establish()
        assert not wait_until(lambda: not t.is_alive(), 0.4)
        assert restores == [] and not srv.is_leader()
        assert any("retrying" in r.getMessage() for r in caplog.records)
        log["applied"] = 10
        assert wait_until(lambda: not t.is_alive(), 10.0)
        assert restores == [10] and srv.is_leader()

        srv._revoke_leadership()
        log.update(applied=12, fence=20)
        t = establish()
        assert not wait_until(lambda: not t.is_alive(), 0.3)
        log["leader"] = False
        assert wait_until(lambda: not t.is_alive(), 10.0)
        assert restores == [10] and not srv.is_leader()
    finally:
        srv.shutdown()
