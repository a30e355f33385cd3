"""Follower-read scheduling in the port (``nomad_tpu_torch/server/
follower_sched.py``; the counterparts of the reference's
``tests/test_follower_sched.py``).

- A 3-voter port cluster with no batch workers drains a 30-job backlog
  through follower workers only: plans forwarded over the wire, applied
  by the leader, replicated to every FSM, with the full invariant set
  (every eval complete, each job exactly its count of allocs with
  distinct ids and names, no node over capacity) and equal fingerprints.
- The leader killed mid-drain at seeded points (7 and 23): the survivors
  re-elect, the new leader re-enqueues, its fence floor holds the
  followers to every pre-failover plan, and the invariants still hold.
- Both lag fences (a job's plan fence, an eval's trigger index) hand the
  eval back instead of scheduling off a stale replica; the
  ``LeaderChannel`` follows a ``NoLeaderError`` hint, refuses with no
  known leader and with its own address; remote broker errors surface as
  broker errors.  These unit cases run against both packages.
- The port's follower drill (``python -m nomad_tpu_torch.ops
  --selfcheck``) on the CPU.

Clusters run the reference loadgen harness's loaded-host election timing
(``test_torch_raft.SLOW_RAFT``); every wait has a deadline.
"""
import time

import pytest

from nomad_tpu.server import eval_broker as jeval_broker
from nomad_tpu.server import follower_sched as jfs
from nomad_tpu.server import rpc as jrpc
from nomad_tpu.structs import structs as js
from nomad_tpu_torch.server import eval_broker as peval_broker
from nomad_tpu_torch.server import follower_sched as pfs
from nomad_tpu_torch.server import rpc as prpc
from nomad_tpu_torch.structs import structs as ps
from nomad_tpu_torch.utils.backoff import wait_until

from test_torch_raft import (ELECTION_TIMEOUT, make_cluster, shutdown_all,
                             wait_for_leader)

PKGS = {"ref": (jfs, jrpc, jeval_broker, js),
        "port": (pfs, prpc, peval_broker, ps)}
DRAIN_TIMEOUT = 120.0


def make_node(i, cpu=4000, mem=8192):
    return ps.Node(
        id=f"fs-node-{i:04d}", datacenter="dc1", name=f"fs-node-{i:04d}",
        attributes={"kernel.name": "linux", "driver.exec": "1"},
        resources=ps.Resources(cpu=cpu, memory_mb=mem, disk_mb=100 * 1024,
                               iops=1000),
        reserved=ps.Resources(), status=ps.NODE_STATUS_READY)


def make_job(n, count=2, cpu=100, mem=128, priority=50):
    jid = f"fs-job-{n:05d}"
    return ps.Job(
        region="global", id=jid, name=jid, type=ps.JOB_TYPE_SERVICE,
        priority=priority, datacenters=["dc1"],
        task_groups=[ps.TaskGroup(
            name="tg", count=count,
            ephemeral_disk=ps.EphemeralDisk(size_mb=10),
            tasks=[ps.Task(name="t", driver="exec",
                           config={"command": "/bin/date"},
                           resources=ps.Resources(cpu=cpu, memory_mb=mem))])])


def follower_cluster():
    """Three voters, no batch workers, two follower workers each: work
    completes only through the follower-read path."""
    return make_cluster(3, num_schedulers=0, follower_schedulers=2)


def assert_drain_invariants(leader, eval_ids, n_jobs, count):
    evals = [leader.state.eval_by_id(None, eid) for eid in eval_ids]
    assert all(ev is not None and ev.status == ps.EVAL_STATUS_COMPLETE
               for ev in evals), [getattr(ev, "status", None)
                                  for ev in evals]
    allocs = [a for a in leader.state.allocs(None)
              if not a.terminal_status()]
    by_job = {}
    for a in allocs:
        by_job.setdefault(a.job_id, []).append(a)
    assert len(by_job) == n_jobs
    for job_id, job_allocs in by_job.items():
        assert len(job_allocs) == count, \
            f"{job_id}: {len(job_allocs)} allocs (want {count})"
        assert len({a.id for a in job_allocs}) == count
        assert len({a.name for a in job_allocs}) == count
    node_map = {n.id: n for n in leader.state.nodes(None)}
    usage = {}
    for a in allocs:
        cpu, mem = usage.get(a.node_id, (0, 0))
        usage[a.node_id] = (cpu + a.resources.cpu,
                            mem + a.resources.memory_mb)
    for node_id, (cpu, mem) in usage.items():
        node = node_map[node_id]
        assert cpu <= node.resources.cpu - node.reserved.cpu
        assert mem <= node.resources.memory_mb - node.reserved.memory_mb


def settled_everywhere(servers, eval_ids, want_allocs):
    """Every server's replica holds the placements and one fingerprint."""
    def done():
        if not all(len([a for a in x.state.allocs(None)
                        if not a.terminal_status()]) == want_allocs
                   for x in servers):
            return False
        return len({x.fsm_fingerprint() for x in servers}) == 1
    return wait_until(done, 30.0, max_interval=0.05)


N_JOBS = 30
COUNT = 2


def register_backlog(leader):
    for i in range(30):
        leader.node_register(make_node(i))
    return [leader.job_register(make_job(n, count=COUNT))[1]
            for n in range(N_JOBS)]


def test_followers_drain_with_invariants():
    servers = follower_cluster()
    try:
        leader = wait_for_leader(servers)
        followers = [x for x in servers if x is not leader]
        assert wait_until(lambda: all(len(x.raft.peers) == 3
                                      for x in servers), 20.0)
        eval_ids = register_backlog(leader)
        assert wait_until(lambda: all(
            (ev := leader.state.eval_by_id(None, eid)) is not None
            and ev.terminal_status() for eid in eval_ids), DRAIN_TIMEOUT)
        assert_drain_invariants(leader, eval_ids, N_JOBS, COUNT)
        forwarded = sum(f.leader_channel.stats()["ForwardedPlans"]
                        for f in followers)
        assert forwarded >= N_JOBS
        assert sum(f.leader_channel.stats()["ForwardErrors"]
                   for f in followers) == 0
        assert leader.leader_channel.stats()["ForwardedPlans"] == 0
        assert settled_everywhere(servers, eval_ids, N_JOBS * COUNT)
        st = followers[0].stats()["FollowerSched"]
        assert st["Enabled"] and not st["IsLeader"]
        assert leader.eval_broker.stats()["total_nacks"] == 0
    finally:
        shutdown_all(servers)


@pytest.mark.parametrize("seed", [7, 23])
def test_leader_failover_with_inflight_plans(seed):
    servers = follower_cluster()
    try:
        leader = wait_for_leader(servers)
        survivors = [x for x in servers if x is not leader]
        assert wait_until(lambda: all(len(x.raft.peers) == 3
                                      for x in servers), 20.0)
        eval_ids = register_backlog(leader)
        # Let the drain start, then kill the leader mid-flight (the seed
        # moves where in the drain the failover lands).
        assert wait_until(lambda: any(
            (ev := leader.state.eval_by_id(None, eid)) is not None
            and ev.terminal_status() for eid in eval_ids), 60.0)
        time.sleep(0.05 * (seed % 5))
        leader.shutdown()
        new_leader = wait_for_leader(survivors, ELECTION_TIMEOUT)
        assert wait_until(lambda: all(
            (ev := new_leader.state.eval_by_id(None, eid)) is not None
            and ev.terminal_status() for eid in eval_ids), DRAIN_TIMEOUT), \
            "the drain did not finish after the failover"
        assert_drain_invariants(new_leader, eval_ids, N_JOBS, COUNT)
        assert settled_everywhere(survivors, eval_ids, N_JOBS * COUNT)
    finally:
        shutdown_all(servers)


# -- the unit cases, in both packages -------------------------------------

class _StubChannel:
    def __init__(self):
        self.calls = []

    def call(self, method, body, timeout=10.0):
        self.calls.append((method, body))
        return {}


class _StubRaft:
    """A raft whose applied index is pinned: a follower that can never
    catch up."""

    def __init__(self, applied=5):
        self._applied = applied

    def applied_index(self):
        return self._applied

    def applied_index_relaxed(self):
        return self._applied


@pytest.mark.parametrize("kind", sorted(PKGS))
@pytest.mark.parametrize("fence,trigger", [(100, 3), (0, 50)],
                         ids=["plan_fence", "trigger_index"])
def test_lag_fences_hand_the_eval_back(kind, fence, trigger, monkeypatch):
    fs, _, _, st = PKGS[kind]
    channel = _StubChannel()
    w = fs.FollowerWorker(_StubRaft(applied=5), channel,
                          is_leader_fn=lambda: False)
    if fence:
        w.plan_queue.note_applied("job-x", fence)
    ev = st.Evaluation(id="e1", job_id="job-x", type=st.JOB_TYPE_SERVICE,
                       status=st.EVAL_STATUS_PENDING,
                       job_modify_index=trigger)
    # A short catch-up window; the wait is real (polls the pinned index).
    monkeypatch.setattr(fs, "RAFT_SYNC_LIMIT", 0.1)
    with pytest.raises(fs.FollowerLagError):
        w.invoke_scheduler(ev, "tok")
    assert channel.calls == []


class _HintPool:
    """The first address answers NoLeaderError with a hint, the hinted
    one answers."""

    def __init__(self, rpc, leader_addr):
        self.rpc = rpc
        self.leader_addr = leader_addr
        self.calls = []

    def call(self, addr, method, body, channel=None, timeout=None):
        self.calls.append(addr)
        if addr != self.leader_addr:
            raise self.rpc.NoLeaderError(self.leader_addr)
        return {"ok": True}


@pytest.mark.parametrize("kind", sorted(PKGS))
def test_no_leader_hint_is_followed(kind):
    fs, rpc, _, _ = PKGS[kind]
    pool = _HintPool(rpc, "127.0.0.1:4647")
    ch = fs.LeaderChannel(pool, lambda: "127.0.0.1:9999",
                          my_addr="127.0.0.1:1111")
    assert ch.call("Status.Ping", {}) == {"ok": True}
    assert pool.calls == ["127.0.0.1:9999", "127.0.0.1:4647"]


@pytest.mark.parametrize("kind", sorted(PKGS))
@pytest.mark.parametrize("leader", ["", "127.0.0.1:1111"],
                         ids=["no_known_leader", "own_address"])
def test_channel_refuses_without_a_remote_leader(kind, leader):
    fs, rpc, _, _ = PKGS[kind]
    pool = _HintPool(rpc, "x")
    ch = fs.LeaderChannel(pool, lambda: leader, my_addr="127.0.0.1:1111")
    with pytest.raises(rpc.NoLeaderError):
        ch.call("Status.Ping", {})
    assert pool.calls == []


@pytest.mark.parametrize("kind", sorted(PKGS))
def test_remote_broker_errors_surface_as_broker_errors(kind):
    fs, rpc, broker, st = PKGS[kind]

    class _Boom:
        def call(self, *a, **k):
            raise rpc.NoLeaderError("")

    ch = fs.LeaderChannel(_Boom(), lambda: "127.0.0.1:2",
                          my_addr="127.0.0.1:1")
    rb = fs.RemoteBroker(ch, {})
    with pytest.raises(broker.EvalBrokerError):
        rb.dequeue_batch([st.JOB_TYPE_SERVICE], 4, 0.0)
    with pytest.raises(broker.EvalBrokerError):
        rb.ack("e1", "tok")


def test_follower_worker_parks_on_the_leader():
    channel = _StubChannel()
    w = pfs.FollowerWorker(_StubRaft(), channel, is_leader_fn=lambda: True)
    t0 = time.monotonic()
    assert w._dequeue_batch() == []
    assert time.monotonic() - t0 >= 0.2
    assert channel.calls == []


def test_follower_drill_on_the_cpu(capsys):
    from nomad_tpu_torch.ops.__main__ import follower_drill

    assert follower_drill(seed=3, device="cpu", snapshot_chunk=1024)
    out = capsys.readouterr().out
    assert "follower drill: OK" in out
