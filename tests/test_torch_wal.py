"""The port's native group-commit WAL and its ``FileLog``, twins of the
reference's ``tests/test_native_wal.py:17-305`` and
``tests/test_autosnapshot.py:48-176``.

``NativeWAL`` (``nomad_tpu_torch/native/wal.cc``, built with g++ into
``build/native/``): append and replay, a torn tail, a corrupt CRC,
concurrent appends, the split write/sync, reset; the same records
written by the reference's ``NativeWAL`` make the same file, and the
port's pure-Python CRC reader agrees with the native one record for
record.  ``FileLog`` on both routes (``native=True``, and ``native=False``
for the pure-Python writer the reference reaches with
``NOMAD_TPU_NO_NATIVE=1``; in the port it writes the same ``wal.crc``
frames): replay, torn tails, mixed routes, a failed
FSM apply that must not wedge the sequencer, concurrent appliers
sharing fsyncs, and the automatic snapshot off the apply path.  Inputs
are seeded with numpy.
"""
import os
import threading
import time

import numpy as np
import pytest

from nomad_tpu.native import NativeWAL as JNativeWAL
from nomad_tpu_torch import mock
from nomad_tpu_torch.native import NativeWAL, lib_path
from nomad_tpu_torch.server.fsm import FSM, MessageType
from nomad_tpu_torch.server.raft import FileLog, _decode_entry, _encode_entry


def wait_until(predicate, timeout=15.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def seeded_records(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(k), dtype=np.uint8).tobytes()
            for k in rng.choice([0, 1, 7, 64, 513, 4096], size=n)]


def node(i):
    n = mock.node()
    n.id = n.name = f"wal-node-{i:04d}"
    return n


# -- NativeWAL (tests/test_native_wal.py:17-110) ---------------------------


def test_native_library_builds_into_the_repository_build_dir(tmp_path):
    NativeWAL(str(tmp_path / "wal.crc")).close()
    path = lib_path("wal.cc")
    assert path.exists()
    assert path.parent.name == "native" and path.parent.parent.name == "build"


def test_append_replay(tmp_path):
    """Twin of test_native_wal.py:17."""
    p = str(tmp_path / "wal.crc")
    w = NativeWAL(p)
    for i in range(50):
        w.append(f"r{i}".encode())
    assert len(w) == 50
    w.close()
    w2 = NativeWAL(p)
    recs = list(w2.records())
    assert len(recs) == 50 and recs[0] == b"r0" and recs[-1] == b"r49"
    w2.close()


def test_torn_tail_truncated(tmp_path):
    """Twin of test_native_wal.py:31."""
    p = str(tmp_path / "wal.crc")
    w = NativeWAL(p)
    w.append(b"good-1")
    w.append(b"good-2")
    w.close()
    with open(p, "ab") as fh:
        fh.write(b"\xff\xff\x00\x00garbage")
    w2 = NativeWAL(p)
    assert list(w2.records()) == [b"good-1", b"good-2"]
    w2.append(b"good-3")
    w2.close()
    w3 = NativeWAL(p)
    assert list(w3.records()) == [b"good-1", b"good-2", b"good-3"]
    w3.close()


def test_corrupt_crc_truncated(tmp_path):
    """Twin of test_native_wal.py:48."""
    p = str(tmp_path / "wal.crc")
    w = NativeWAL(p)
    w.append(b"alpha")
    w.append(b"beta")
    w.close()
    size = os.path.getsize(p)
    with open(p, "r+b") as fh:
        fh.seek(size - 1)
        last = fh.read(1)
        fh.seek(size - 1)
        fh.write(bytes([last[0] ^ 0xFF]))
    w2 = NativeWAL(p)
    assert list(w2.records()) == [b"alpha"]
    w2.close()


def test_concurrent_appends_all_durable(tmp_path):
    """Twin of test_native_wal.py:66: every thread's records, in its
    order; the group commit makes at most one fsync an append."""
    p = str(tmp_path / "wal.crc")
    w = NativeWAL(p)
    n_threads, per = 8, 100

    def worker(k):
        for i in range(per):
            w.append(f"t{k}-{i}".encode())

    ts = [threading.Thread(target=worker, args=(k,))
          for k in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(w) == n_threads * per
    assert 0 < w.fsyncs() <= n_threads * per
    w.close()
    w2 = NativeWAL(p)
    recs = list(w2.records())
    assert len(recs) == n_threads * per
    for k in range(n_threads):
        mine = [r for r in recs if r.startswith(f"t{k}-".encode())]
        assert mine == [f"t{k}-{i}".encode() for i in range(per)]
    w2.close()


def test_write_then_sync_split_api(tmp_path):
    """Twin of test_native_wal.py:89: one fsync covers the batch."""
    p = str(tmp_path / "wal.crc")
    w = NativeWAL(p)
    seqs = [w.write(f"s{i}".encode()) for i in range(20)]
    assert seqs == list(range(1, 21))
    w.sync_to(seqs[-1])
    assert w.fsyncs() == 1
    w.close()
    w2 = NativeWAL(p)
    assert list(w2.records()) == [f"s{i}".encode() for i in range(20)]
    w2.close()


def test_reset(tmp_path):
    """Twin of test_native_wal.py:100."""
    p = str(tmp_path / "wal.crc")
    w = NativeWAL(p)
    w.append(b"x")
    w.reset()
    assert len(w) == 0
    w.append(b"y")
    w.close()
    w2 = NativeWAL(p)
    assert list(w2.records()) == [b"y"]
    w2.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_records_make_the_reference_file(tmp_path, seed):
    """The port's wal.cc and the reference's frame alike: the same seeded
    records make byte-identical files, and each reads the other's."""
    recs = seeded_records(seed, 120)
    paths = []
    for cls, name in ((NativeWAL, "port.crc"), (JNativeWAL, "ref.crc")):
        p = str(tmp_path / name)
        w = cls(p, fsync=False)
        for i, r in enumerate(recs):
            if i % 3:
                w.sync_to(w.write(r))
            else:
                w.append(r)
        w.close()
        paths.append(p)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    assert list(NativeWAL(paths[1]).records()) == recs
    assert list(JNativeWAL(paths[0]).records()) == recs


@pytest.mark.parametrize("seed", [3, 4])
def test_python_reader_agrees_with_native_record_for_record(tmp_path,
                                                           seed):
    """Entries written through the native WAL, then a torn frame: the
    pure-Python CRC reader (FileLog's ``native=False`` route) and the
    native reader give the same entries, and both truncate to the same
    size."""
    rng = np.random.default_rng(seed)
    entries = [(i + 1, int(rng.integers(0, 9)),
                {"k": [int(x) for x in rng.integers(0, 1000, size=5)],
                 "s": f"v{i}"}) for i in range(40)]
    d = tmp_path / "d"
    d.mkdir()
    p = str(d / "wal.crc")
    w = NativeWAL(p, fsync=False)
    for e in entries:
        w.append(_encode_entry(*e))
    w.close()
    with open(p, "ab") as fh:
        fh.write(b"\x40\x00\x00\x00\xef\xbe\xad\xdetorn")
    flog = FileLog.__new__(FileLog)
    flog.data_dir, flog.crc_path = str(d), p
    py = flog._read_crc_entries(0)
    size_py = os.path.getsize(p)
    w2 = NativeWAL(p, fsync=False)
    native = [_decode_entry(b) for b in w2.records()]
    w2.close()
    assert py == native == entries
    assert os.path.getsize(p) == size_py


# -- FileLog (tests/test_native_wal.py:113-305) ----------------------------


ROUTES = [True, False]


def mk(d, native, **kw):
    kw.setdefault("snapshot_entries", 0)
    kw.setdefault("snapshot_bytes", 0)
    return FileLog(FSM(), str(d), native=native, **kw)


@pytest.mark.parametrize("native", ROUTES)
def test_filelog_replays(tmp_path, native):
    """Twin of test_native_wal.py:120."""
    d = tmp_path / "raft"
    log = mk(d, native)
    assert (log._nwal is not None) == native
    n = node(0)
    log.apply(MessageType.NODE_REGISTER, {"node": n})
    log.close()
    active = d / "wal.crc"
    assert os.path.getsize(active) > 0
    log2 = mk(d, native)
    assert log2.fsm.state.node_by_id(None, n.id) is not None
    log2.close()


@pytest.mark.parametrize("native", ROUTES)
def test_filelog_torn_tail(tmp_path, native):
    """Twin of test_native_wal.py:133 (and test_server.py's torn-tail
    test on the pure-Python route)."""
    d = tmp_path / "raft"
    log = mk(d, native)
    log.apply(MessageType.NODE_REGISTER, {"node": node(0)})
    applied = log.applied_index()
    log.close()
    with open(d / "wal.crc", "ab") as fh:
        fh.write(b"\x99\x00\x00\x00partial-record")
    log2 = mk(d, native)
    assert log2.applied_index() == applied
    job = mock.job()
    log2.apply(MessageType.JOB_REGISTER, {"job": job})
    applied2 = log2.applied_index()
    log2.close()
    log3 = mk(d, native)
    assert log3.applied_index() == applied2
    assert log3.fsm.state.job_by_id(None, job.id) is not None
    log3.close()


def test_mixed_python_then_native_replays_in_order(tmp_path):
    """Twin of test_native_wal.py:155."""
    d = tmp_path / "raft"
    log = mk(d, native=False)
    n = node(0)
    log.apply(MessageType.NODE_REGISTER, {"node": n})
    log.close()
    log2 = mk(d, native=True)
    assert log2.fsm.state.node_by_id(None, n.id) is not None
    job = mock.job()
    log2.apply(MessageType.JOB_REGISTER, {"job": job})
    applied = log2.applied_index()
    log2.close()
    log3 = mk(d, native=True)
    assert log3.applied_index() == applied == 2
    assert log3.fsm.state.node_by_id(None, n.id) is not None
    assert log3.fsm.state.job_by_id(None, job.id) is not None
    log3.close()


def test_native_entries_survive_a_python_boot(tmp_path):
    """Twin of test_native_wal.py:183: a wal.crc replays through the
    pure-Python CRC reader, the Python writer appends to the same file,
    and it replays in index order with no duplicates."""
    d = tmp_path / "raft"
    log = mk(d, native=True)
    n = node(0)
    log.apply(MessageType.NODE_REGISTER, {"node": n})
    applied = log.applied_index()
    log.close()
    log2 = mk(d, native=False)
    assert log2.applied_index() == applied
    job = mock.job()
    log2.apply(MessageType.JOB_REGISTER, {"job": job})
    applied2 = log2.applied_index()
    assert applied2 > applied
    log2.close()
    log3 = mk(d, native=True)
    assert log3.applied_index() == applied2
    assert log3.fsm.state.node_by_id(None, n.id) is not None
    assert log3.fsm.state.job_by_id(None, job.id) is not None
    log3.close()


@pytest.mark.parametrize("seed", [5, 6])
def test_both_routes_write_the_same_file(tmp_path, seed):
    """One on-disk format: the same seeded apply stream through the
    native WAL and the pure-Python writer makes byte-identical
    ``wal.crc`` files (the reference's Python route writes another
    format, ``wal.log``)."""
    import copy

    rng = np.random.default_rng(seed)
    nodes = [node(int(i)) for i in rng.choice(1000, size=12, replace=False)]
    files = []
    for native in ROUTES:
        d = tmp_path / f"raft-{native}"
        log = mk(d, native)
        for n in copy.deepcopy(nodes):
            log.apply(MessageType.NODE_REGISTER, {"node": n})
        log.close()
        assert sorted(os.listdir(d)) == ["wal.crc"]
        files.append((d / "wal.crc").read_bytes())
    assert files[0] == files[1] and len(files[0]) > 0


@pytest.mark.parametrize("native", ROUTES)
def test_failed_fsm_apply_does_not_wedge_the_sequencer(tmp_path, native):
    """Twin of test_native_wal.py:218."""
    log = mk(tmp_path / "raft", native)
    with pytest.raises(KeyError):
        log.apply(MessageType.NODE_DEREGISTER, {"node_id": "no-such-node"})
    n = node(0)
    log.apply(MessageType.NODE_REGISTER, {"node": n})
    assert log.fsm.state.node_by_id(None, n.id) is not None
    assert log.snapshot()
    log.close()


@pytest.mark.parametrize("native", ROUTES)
def test_concurrent_applies_group_commit_durable(tmp_path, native):
    """Twin of test_native_wal.py:232 and :259: concurrent appliers share
    fsyncs (at most one an entry); every acked entry survives a reopen,
    in index order with no gap."""
    d = tmp_path / "raft"
    log = mk(d, native)
    n_threads, per = 6, 20

    def worker(k):
        for i in range(per):
            log.apply(MessageType.NODE_REGISTER,
                      {"node": node(k * per + i)})

    ts = [threading.Thread(target=worker, args=(k,))
          for k in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    applied = log.applied_index()
    assert applied == n_threads * per == log.entries_written
    assert 0 < log.fsyncs() <= applied
    log.close()
    log2 = mk(d, native)
    assert log2.applied_index() == applied
    assert len(log2.fsm.state.nodes(None)) == applied
    log2.close()


@pytest.mark.parametrize("native", ROUTES)
def test_snapshot_truncates_the_logs(tmp_path, native):
    """Twin of test_native_wal.py:288."""
    d = tmp_path / "raft"
    log = mk(d, native)
    log.apply(MessageType.NODE_REGISTER, {"node": node(0)})
    assert log.snapshot()
    active = d / "wal.crc"
    assert os.path.getsize(active) == 0
    applied = log.applied_index()
    log.close()
    log2 = mk(d, native)
    assert log2.applied_index() == applied
    assert len(log2.fsm.state.nodes(None)) == 1
    assert log2.recovery["snapshot_index"] == applied
    log2.close()


def test_native_route_raises_when_the_build_fails(tmp_path, monkeypatch):
    """No silent pure-Python fallback: a WAL that cannot be built
    raises."""
    from nomad_tpu_torch import native

    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    with pytest.raises(native.NativeUnavailable, match="g\\+\\+ not found"):
        FileLog(FSM(), str(tmp_path / "raft"))


# -- automatic snapshots (tests/test_autosnapshot.py:48-176) ---------------


def snapshots_in(d):
    return sorted(int(f.split("-", 1)[1]) for f in os.listdir(d)
                  if f.startswith("snapshot-") and not f.endswith(".tmp"))


def segments_in(d):
    return [f for f in os.listdir(d) if f.startswith("walseg-")]


@pytest.mark.parametrize("native", ROUTES)
def test_threshold_trips_under_live_writes(tmp_path, native):
    """Twin of test_autosnapshot.py:48."""
    d = str(tmp_path / "raft")
    log = mk(d, native, snapshot_entries=40, snapshot_bytes=0,
             snapshot_interval=0.05)

    def writer(k):
        for i in range(60):
            log.apply(MessageType.NODE_REGISTER, {"node": node(k * 60 + i)})

    threads = [threading.Thread(target=writer, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert log.applied_index() == 180
    assert wait_until(lambda: bool(snapshots_in(d)))
    assert wait_until(lambda: not segments_in(d))
    log.close()
    log2 = mk(d, native)
    assert log2.applied_index() == 180
    assert len(log2.fsm.state.nodes(None)) == 180
    log2.close()


@pytest.mark.parametrize("native", ROUTES)
def test_snapshot_runs_off_the_apply_path(tmp_path, native):
    """Twin of test_autosnapshot.py:79: the persist runs on the snapshot
    thread, appends made while it runs complete and survive the
    compaction."""
    d = str(tmp_path / "raft")
    persist_threads = []
    release = threading.Event()
    entered = threading.Event()

    class SlowSnapLog(FileLog):
        def _persist_snapshot_blob(self, snap_store, index):
            persist_threads.append(threading.current_thread().name)
            entered.set()
            release.wait(10.0)
            super()._persist_snapshot_blob(snap_store, index)

    log = SlowSnapLog(FSM(), d, native=native, snapshot_entries=10,
                      snapshot_bytes=0, snapshot_interval=0.02)
    for i in range(12):
        log.apply(MessageType.NODE_REGISTER, {"node": node(i)})
    assert entered.wait(5.0), "the automatic snapshot did not start"
    done = threading.Event()

    def late_appends():
        for i in range(5):
            log.apply(MessageType.NODE_REGISTER, {"node": node(100 + i)})
        done.set()

    t = threading.Thread(target=late_appends)
    t.start()
    assert done.wait(5.0), "appends blocked behind the snapshot persist"
    release.set()
    t.join()
    assert wait_until(lambda: bool(snapshots_in(d)))
    assert snapshots_in(d)[-1] <= 12
    assert log.applied_index() == 17
    log.close()
    assert persist_threads
    assert all(name == "filelog-snapshot" for name in persist_threads)
    log2 = mk(d, native)
    assert log2.applied_index() == 17
    assert len(log2.fsm.state.nodes(None)) == 17
    log2.close()


@pytest.mark.parametrize("native", ROUTES)
def test_restore_parity_with_operator_snapshot(tmp_path, native):
    """Twin of test_autosnapshot.py:136."""
    nodes = [node(i) for i in range(30)]
    d_auto, d_op = str(tmp_path / "auto"), str(tmp_path / "op")
    log_a = mk(d_auto, native, snapshot_entries=10, snapshot_bytes=0,
               snapshot_interval=0.02)
    log_o = mk(d_op, native)
    assert log_o._snap_thread is None  # thresholds 0: no watcher
    for n in nodes:
        log_a.apply(MessageType.NODE_REGISTER, {"node": n})
        log_o.apply(MessageType.NODE_REGISTER, {"node": n})
    assert wait_until(lambda: bool(snapshots_in(d_auto)))
    assert log_o.snapshot()
    assert snapshots_in(d_op) == [30]
    log_a.close()
    log_o.close()
    ra, ro = mk(d_auto, native), mk(d_op, native)
    assert ra.applied_index() == ro.applied_index() == 30
    ids_a = {n.id for n in ra.fsm.state.nodes(None)}
    ids_o = {n.id for n in ro.fsm.state.nodes(None)}
    assert ids_a == ids_o == {n.id for n in nodes}
    ra.close()
    ro.close()


@pytest.mark.parametrize("native", ROUTES)
def test_crash_between_roll_and_blob_loses_nothing(tmp_path, native):
    """Twin of test_autosnapshot.py:176."""
    d = str(tmp_path / "raft")

    class CrashySnapLog(FileLog):
        def _persist_snapshot_blob(self, snap_store, index):
            raise RuntimeError("injected crash before the blob persist")

    log = CrashySnapLog(FSM(), d, native=native, snapshot_entries=0,
                        snapshot_bytes=0)
    for i in range(8):
        log.apply(MessageType.NODE_REGISTER, {"node": node(i)})
    with pytest.raises(RuntimeError):
        log.snapshot()
    assert segments_in(d), "the roll did not seal a segment"
    assert not snapshots_in(d)
    log.close()
    log2 = mk(d, native)
    assert log2.applied_index() == 8
    assert len(log2.fsm.state.nodes(None)) == 8
    assert log2.snapshot()
    assert snapshots_in(d) == [8]
    log2.close()


@pytest.mark.parametrize("native", ROUTES)
def test_roll_waits_for_inflight_syncs(tmp_path, native):
    """A snapshot never rolls the WAL under an applier that is still in
    its durability wait (the sequencer drain, then the roll's
    ``_sync_inflight`` wait): the held applier delays the roll, and its
    entry survives the restart."""
    d = str(tmp_path / "raft")
    entered, release = threading.Event(), threading.Event()

    class SlowSyncLog(FileLog):
        def _do_sync_persist(self, seq):
            if threading.current_thread().name == "slow-applier":
                entered.set()
                release.wait(10.0)
            super()._do_sync_persist(seq)

    log = SlowSyncLog(FSM(), d, native=native, snapshot_entries=0,
                      snapshot_bytes=0)
    log.apply(MessageType.NODE_REGISTER, {"node": node(0)})
    t = threading.Thread(target=log.apply, name="slow-applier",
                         args=(MessageType.NODE_REGISTER,
                               {"node": node(1)}))
    t.start()
    assert entered.wait(5.0)
    snap = threading.Thread(target=log.snapshot)
    snap.start()
    time.sleep(0.2)
    assert snap.is_alive() and not segments_in(d) and not snapshots_in(d)
    release.set()
    t.join(5.0)
    snap.join(5.0)
    assert snapshots_in(d) == [2]
    log.close()
    log2 = mk(d, native)
    assert log2.applied_index() == 2
    assert len(log2.fsm.state.nodes(None)) == 2
    log2.close()


def test_wal_drill_on_the_cpu(capsys):
    """``python -m nomad_tpu_torch.ops --selfcheck``'s WAL drill
    (``nomad_tpu/ops/__main__.py:456-528``) with its batch on the CPU."""
    from nomad_tpu_torch.ops.__main__ import wal_drill

    assert wal_drill(seed=3, device="cpu")
    assert "wal drill: OK" in capsys.readouterr().out
