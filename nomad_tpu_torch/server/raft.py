"""The replicated log under the FSM (a copy of
``nomad_tpu/server/raft.py``; reference hashicorp/raft with its in-memory
store and raft-boltdb, nomad/server.go:91-95, raft_rpc.go).

- ``RaftLog`` — the interface the server applies through: ``apply``
  assigns the next index, writes the entry (the durable logs), waits for
  its durability outside the log lock, and applies it to the FSM in
  strict index order; ``applied_index`` (locked),
  ``applied_index_relaxed`` (lock-free lower bound), ``fence_index``, and
  leadership notification.
- ``InmemLog`` — the single-voter in-memory log (raftInmem): always the
  leader, nothing persisted.
- ``FileLog`` — the single-voter durable log: entries go to the native
  group-commit WAL (``native/wal.cc``; ``FileLog(native=False)`` asks for
  the pure-Python writer of the same frames instead), FSM snapshots are
  taken off the apply path, and a restart recovers from the newest
  snapshot and the WAL.
- ``MultiRaft`` — election and replication across servers over the RPC
  layer's raft channel (raft.py:1042-1855): randomized elections,
  persisted term and vote, AppendEntries with the prev-entry check and
  conflict truncation, per-peer replicators, majority commit of
  current-term entries, learners, voter-set changes through ``CONFIG``
  entries, the followers' FSM apply off the reply path, the ordered
  leadership dispatcher, compaction and chunked InstallSnapshot.  Its
  durable state (``_RaftStore``) is CRC-framed struct-codec frames, as
  ``FileLog``'s; the reference's env knobs for its timing and snapshot
  chunk are constructor arguments with the same defaults.

Each apply passes the ``raft.apply`` fault point first (``crash``,
``error``, ``delay``, ``step_down``; raft.py:40-58) and is traced as a
``raft.apply`` span (raft.py:241-245), which inherits the eval of the
span it runs under (``plan.apply``).  Entries and snapshots are struct-
codec frames (``server/log_codec.py``): a corrupt or foreign file can
only produce registered data types, never code, and a frame of another
struct schema fails to decode.
"""
from __future__ import annotations

import logging
import os
import queue
import random
import struct
import threading
import time
import zlib
from typing import Callable, List, Optional, Tuple

from .. import fault
from ..utils import tracing
from ..utils.telemetry import NULL_TELEMETRY
from .fsm import FSM, MessageType
from .log_codec import decode_payload, encode_payload

logger = logging.getLogger("nomad_tpu_torch.raft")


def _fire_apply_fault(index: int, msg_type) -> Optional[str]:
    """The ``raft.apply`` fault point.  Returns "step_down" for the caller
    to turn into a refusal; ``crash``/``error`` raise here, ``delay``
    sleeps here.  The rule's ``match`` sees the prospective ``index`` and
    the message type's name (``msg_type``)."""
    act = fault.faultpoint("raft.apply", index=index,
                           msg_type=getattr(msg_type, "name",
                                            str(msg_type)))
    if act is None:
        return None
    if act.kind == "delay":
        time.sleep(act.delay)
        return None
    if act.kind == "step_down":
        return "step_down"
    act.raise_injected()
    return None


def _encode_entry(index, msg_type, payload) -> bytes:
    return encode_payload({"i": int(index), "t": int(msg_type),
                           "p": payload})


def _decode_entry(blob):
    """One WAL record; raises on anything that is not a well-formed entry
    (callers treat that as a corrupt tail)."""
    d = decode_payload(blob)
    return d["i"], d["t"], d["p"]


_CRC_HDR = struct.Struct("<II")


def _crc_frame(blob: bytes) -> bytes:
    return _CRC_HDR.pack(len(blob), zlib.crc32(blob) & 0xFFFFFFFF) + blob


def _read_crc_frames(path: str) -> Tuple[List[bytes], int, int]:
    """The valid CRC frames at the head of ``path``, the offset after the
    last of them, and the file's size (a torn or corrupt tail lies
    between the two)."""
    out: List[bytes] = []
    good = 0
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        while True:
            header = fh.read(_CRC_HDR.size)
            if len(header) < _CRC_HDR.size:
                break
            length, crc = _CRC_HDR.unpack(header)
            if length > size - fh.tell():
                break
            blob = fh.read(length)
            if len(blob) < length or (zlib.crc32(blob)
                                      & 0xFFFFFFFF) != crc:
                break
            out.append(blob)
            good = fh.tell()
    return out, good, size


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)

# FSM snapshots kept on disk (server.go:51 snapshotsRetained = 2).
SNAPSHOTS_RETAINED = 2


class NotLeaderError(Exception):
    pass


class RaftLog:
    """Single-voter commit path: append → (durable logs: write, then wait
    for the fsync outside the lock) → apply in index order."""

    # Telemetry handle, assigned by the owning Server after construction.
    metrics = NULL_TELEMETRY

    def __init__(self, fsm: FSM):
        self.fsm = fsm
        # RLock: index assignment and persist run under it; FSM-apply
        # hooks may read applied_index() on the applying thread.
        self._l = threading.RLock()
        self._last_index = 0
        self._applied = 0
        self._leader = True  # single voter: always the leader
        self._leader_listeners: List[Callable[[bool], None]] = []
        # Apply sequencer: entries apply to the FSM in strict index order
        # after their durability wait.  A sync covers the whole written
        # prefix, so the wait here is for apply order only.
        self._apply_cv = threading.Condition()
        self._apply_next = 1
        self._apply_failed = False
        # A durability failure poisons the log (the reference panics): no
        # further applies until a restart recovers the durable prefix.
        self._wal_failed = False

    # -- leadership --------------------------------------------------------

    def is_leader(self) -> bool:
        return self._leader

    def notify_leadership(self, cb: Callable[[bool], None]) -> None:
        self._leader_listeners.append(cb)
        cb(self._leader)

    def _set_leader(self, leader: bool) -> None:
        if leader == self._leader:
            return
        self._leader = leader
        for cb in self._leader_listeners:
            cb(leader)

    # -- log ---------------------------------------------------------------

    def applied_index(self) -> int:
        with self._l:
            return self._applied

    def fence_index(self) -> int:
        """Upper bound on every committed entry's index (the follower-read
        fence floor at leadership).  Applied equals last here."""
        return self.applied_index()

    def applied_index_relaxed(self) -> int:
        """Lock-free lower bound on :meth:`applied_index`: ``_applied`` is
        stamped after each FSM apply, so this never reports an entry whose
        state is not yet visible; it may lag an in-flight apply by one.
        For hot polls (wait-for-index)."""
        return self._applied

    def apply(self, msg_type: MessageType, payload: dict):
        """Append + commit + apply one entry; returns (result, index)
        (raft.py:139-232).

        1. Under the log lock: the ``raft.apply`` fault point, the index,
           and the entry written (file order is index order, so the
           durable prefix never has a gap).  No fsync here.
        2. Outside the lock: wait for durability; concurrent waiters share
           one group-commit fsync.
        3. The sequencer applies to the FSM in index order, after
           durability: nothing can observe state a crash would erase.

        An FSM apply that raises propagates to its caller, and the
        sequencer still advances past its index.  A durability failure
        poisons the log: the entry never applies, and every queued and
        later apply fails too."""
        t0 = time.perf_counter()
        with self._l:
            if not self._leader:
                raise NotLeaderError("not the leader")
            if self._wal_failed:
                raise NotLeaderError("write-ahead log failed; restart to "
                                     "recover from the durable prefix")
            # Before the index: an injected crash models the leader dying
            # before the entry commits (nothing persists or applies).
            if _fire_apply_fault(self._last_index + 1, msg_type) is not None:
                raise NotLeaderError("injected step-down")
            self._last_index += 1
            index = self._last_index
            try:
                token = self._persist(index, msg_type, payload)
            except Exception:
                # Nothing reached the log (writes roll torn frames back):
                # release the index so the sequencer never waits on it.
                self._last_index -= 1
                raise
        if token is not None:
            try:
                self._sync_persist(token, msg_type)
            except Exception:
                with self._l:
                    self._wal_failed = True
                with self._apply_cv:
                    self._apply_failed = True
                    self._apply_cv.notify_all()
                raise
        with self._apply_cv:
            while self._apply_next != index:
                if self._apply_failed:
                    raise NotLeaderError(
                        "write-ahead log failed; restart to recover from "
                        "the durable prefix")
                self._apply_cv.wait()
            try:
                result = self.fsm.apply(index, msg_type, payload)
            finally:
                self._applied = index
                self._apply_next = index + 1
                self._apply_cv.notify_all()
        self.metrics.measure_since("raft.apply", t0)
        # Branch before building attrs: disarmed, a commit pays one load
        # and a comparison.
        tr = tracing.TRACER
        if tr is not None:
            tr.record("raft.apply", t0, time.perf_counter(), index=index,
                      msg_type=getattr(msg_type, "name", str(msg_type)))
        return result, index

    def _persist(self, index: int, msg_type: MessageType, payload: dict):
        return None  # in memory: nothing to write

    def _sync_persist(self, token, msg_type) -> None:
        pass  # in memory: nothing to wait for

    def snapshot(self) -> None:
        pass

    def close(self) -> None:
        pass


class InmemLog(RaftLog):
    """In-memory log for dev and tests (the raftInmem analogue)."""


class FileLog(RaftLog):
    """The durable single-voter log and its snapshots (raft.py:268-846).

    Layout of ``data_dir``:

    - ``wal.crc`` — CRC-framed records (``[u32 len][u32 crc32][payload]``),
      written by the native group-commit WAL or, with ``native=False``, by
      the pure-Python writer of the same frames: concurrent appliers share
      one fsync either way, and either route reads what the other wrote.
      The reference's length-prefixed ``wal.log`` (raft.py:496) is not
      written or read: the port has one on-disk format;
    - ``walseg-<idx>.crc`` — WAL segments sealed at a snapshot: fsynced,
      immutable, deleted once the snapshot that covers them is durable (a
      crash before that leaves them for replay, so an unfinished snapshot
      never loses an entry);
    - ``snapshot-<idx>`` — the FSM snapshot taken at ``<idx>``.

    Recovery restores the newest snapshot, then replays the segments'
    and the WALs' entries past it in index order; a torn or corrupt tail
    is truncated so later appends stay reachable.  ``recovery`` holds the
    split of its seconds.

    Snapshots: a background thread watches ``snapshot_entries`` and
    ``snapshot_bytes`` (0 turns a threshold off) every
    ``snapshot_interval`` seconds and snapshots off the apply path: the
    store is snapshotted copy-on-write and the WAL rolled under the lock,
    and the serialization and its fsync run outside it while appends go
    on into the fresh WAL.  :meth:`snapshot` runs the same thing at once.
    The thresholds are the reference's ``NOMAD_TPU_FILELOG_SNAPSHOT_*``
    defaults (the hashicorp/raft SnapshotThreshold of 8192 entries).

    Every acknowledged entry is fsynced, and so is the directory after
    each rename or file creation that moves where entries live (the WAL
    roll, the snapshot's replace), before sealed segments are unlinked or
    an entry of the fresh WAL is acknowledged: the reference skips the
    directory fsync, which leaves a power loss after a roll uncovered.
    """

    def __init__(self, fsm: FSM, data_dir: str, native: bool = True,
                 snapshot_entries: int = 8192,
                 snapshot_bytes: int = 64 << 20,
                 snapshot_interval: float = 1.0):
        super().__init__(fsm)
        self.data_dir = data_dir
        self.native = native
        os.makedirs(data_dir, exist_ok=True)
        self.crc_path = os.path.join(data_dir, "wal.crc")
        self._nwal = None
        if native:
            from ..native import NativeWAL

            self._nwal = NativeWAL(self.crc_path)
        self.recovery: dict = {}
        self._recover()
        self._fh = open(self.crc_path, "ab") if self._nwal is None else None
        self._fsync_dir()
        # The pure-Python group commit (the twin of wal.cc's written and
        # synced seqs and single syncer): writes in index order under the
        # log lock, the fsync wait outside it.
        self._py_cv = threading.Condition()
        self._py_written = 0
        self._py_synced = 0
        self._py_fsyncs = 0
        self._py_sync_in_flight = False
        self._py_failed = False
        # Appliers holding a durability token (between _persist and the
        # end of _sync_persist): the WAL roll at a snapshot waits for it
        # to reach zero, so the old handles are quiescent when swapped.
        self._sync_inflight = 0
        self._entries_since_snap = 0
        self._bytes_since_snap = 0
        self._fsyncs_before = 0    # the fsyncs of WALs rolled away
        self.entries_written = 0
        self.last_snapshot_bytes = 0
        self._snap_serial = threading.Lock()
        self._snap_stop = threading.Event()
        self._snap_thread: Optional[threading.Thread] = None
        self.snapshot_entries = snapshot_entries
        self.snapshot_bytes = snapshot_bytes
        self.snapshot_interval = snapshot_interval
        if (snapshot_entries > 0 or snapshot_bytes > 0) \
                and snapshot_interval > 0:
            self._snap_thread = threading.Thread(
                target=self._auto_snapshot_loop, daemon=True,
                name="filelog-snapshot")
            self._snap_thread.start()

    # -- recovery ----------------------------------------------------------

    def _snapshot_files(self) -> List[Tuple[int, str]]:
        out = []
        for name in os.listdir(self.data_dir):
            if name.startswith("snapshot-") and not name.endswith(".tmp"):
                try:
                    idx = int(name.split("-", 1)[1])
                except ValueError:
                    continue
                out.append((idx, os.path.join(self.data_dir, name)))
        return sorted(out)

    def _segment_files(self) -> List[str]:
        return sorted(os.path.join(self.data_dir, name)
                      for name in os.listdir(self.data_dir)
                      if name.startswith("walseg-"))

    def _recover(self) -> None:
        """(raft.py:385).  The newest snapshot restored, then every entry
        past it from the sealed segments and the WAL, in index order."""
        rec = {"snapshot_index": 0, "snapshot_bytes": 0,
               "snapshot_read_s": 0.0, "snapshot_restore_s": 0.0}
        snap_idx = 0
        snaps = self._snapshot_files()
        if snaps:
            snap_idx, path = snaps[-1]
            t0 = time.perf_counter()
            with open(path, "rb") as fh:
                blob = fh.read()
            t1 = time.perf_counter()
            self.fsm.restore(blob)
            rec.update(snapshot_index=snap_idx, snapshot_bytes=len(blob),
                       snapshot_read_s=t1 - t0,
                       snapshot_restore_s=time.perf_counter() - t1)
            self._last_index = snap_idx
            self._applied = snap_idx

        t0 = time.perf_counter()
        # Sealed segments first (a crash between a roll and its snapshot's
        # fsync leaves their entries only there); the ones the snapshot
        # covers are deleted.
        entries: List[Tuple[int, int, dict]] = []
        for seg in self._segment_files():
            got = self._read_crc_entries(snap_idx, path=seg)
            if got:
                entries.extend(got)
            else:
                try:
                    os.unlink(seg)
                except OSError:  # pragma: no cover - best effort
                    pass
        if self._nwal is not None:
            # CRC and torn-tail handling were done at open.  A CRC-valid
            # record that does not decode ends the replay at the last good
            # entry, and the WAL is rewritten to that prefix, so appends
            # made after this boot stay reachable.
            good, bad = [], False
            for blob in self._nwal.records():
                try:
                    index, msg_type, payload = _decode_entry(blob)
                except Exception:
                    bad = True
                    break
                good.append(blob)
                if index > snap_idx:
                    entries.append((index, msg_type, payload))
            if bad:
                self._nwal.reset()
                for blob in good:
                    self._nwal.append(blob)
        else:
            # The pure-Python route: the same frames through the Python
            # CRC reader, whichever route wrote them.
            entries.extend(self._read_crc_entries(snap_idx))
        rec["replay_read_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # A segment and the WAL never share an index, but a crash between
        # a roll's rename and its snapshot can leave a segment the
        # snapshot already covers: same-index entries are the same entry,
        # keep the first.
        entries.sort(key=lambda e: e[0])
        prev, replayed = None, 0
        for index, msg_type, payload in entries:
            if index == prev:
                continue
            prev = index
            self.fsm.apply(index, MessageType(msg_type), payload)
            self._last_index = index
            replayed += 1
        rec["replay_apply_s"] = time.perf_counter() - t0
        rec["replayed_entries"] = replayed
        self._applied = self._last_index
        self._apply_next = self._last_index + 1
        self.recovery = rec

    def _read_crc_entries(self, snap_idx: int, path: Optional[str] = None):
        """The pure-Python reader of the ``wal.crc`` format; validates the
        CRCs and truncates a torn or corrupt tail as ``wal.cc`` does at
        open (raft.py:459).  ``path`` reads a sealed segment."""
        out = []
        path = path or self.crc_path
        if not os.path.exists(path):
            return out
        frames, _, size = _read_crc_frames(path)
        good = 0
        for blob in frames:
            try:
                index, msg_type, payload = _decode_entry(blob)
            except Exception:
                break  # an undecodable record: a corrupt tail
            good += _CRC_HDR.size + len(blob)
            if index > snap_idx:
                out.append((index, msg_type, payload))
        if good < size:
            with open(path, "r+b") as fh:
                fh.truncate(good)
        return out

    # -- persistence -------------------------------------------------------

    def _persist(self, index: int, msg_type: MessageType, payload: dict):
        """Write one entry (index order: the caller holds the log lock)
        and return the durability token ``_sync_persist`` waits on
        outside the lock (raft.py:543)."""
        blob = _encode_entry(index, msg_type, payload)
        # The ``wal.fsync`` fault point: a crash models the process dying
        # mid-frame, a torn partial record left on disk (recovery must
        # truncate it); the entry never applies.
        act = fault.faultpoint("wal.fsync", index=index,
                               msg_type=getattr(msg_type, "name",
                                                str(msg_type)))
        if act is not None:
            if act.kind == "delay":
                time.sleep(act.delay)
            else:
                self._write_torn_frame(blob)
                # The crashed process's log is dead: a caller that catches
                # the injected error must not append after the torn frame
                # (those frames would be acked, then truncated away).
                self._wal_failed = True
                act.raise_injected()
        if self._nwal is not None:
            token = self._nwal.write(blob)
        else:
            pos = self._fh.tell()
            try:
                self._fh.write(_crc_frame(blob))
                self._fh.flush()
            except OSError:
                # Roll the torn frame back (ENOSPC): left mid-log it would
                # strand later appends behind it.
                try:
                    self._fh.seek(pos)
                    self._fh.truncate(pos)
                except OSError:  # pragma: no cover - the disk is gone
                    pass
                raise
            with self._py_cv:
                self._py_written += 1
                token = self._py_written
        self._entries_since_snap += 1
        self._bytes_since_snap += len(blob) + _CRC_HDR.size
        self.entries_written += 1
        with self._py_cv:
            self._sync_inflight += 1
        return token

    def _sync_persist(self, seq: int, msg_type) -> None:
        """Wait, outside the log lock, until the entry written as ``seq``
        is durable; concurrent callers share one fsync."""
        t0 = time.perf_counter()
        try:
            self._do_sync_persist(seq)
        finally:
            with self._py_cv:
                self._sync_inflight -= 1
                self._py_cv.notify_all()
        self.metrics.measure_since("raft.fsync", t0)
        if msg_type == MessageType.APPLY_PLAN_RESULTS:
            self.metrics.measure_since("raft.fsync.plan", t0)

    def _do_sync_persist(self, seq: int) -> None:
        if self._nwal is not None:
            self._nwal.sync_to(seq)
            return
        with self._py_cv:
            while True:
                if self._py_failed:
                    # Sticky: a failed fsync may have dropped dirty pages
                    # and cleared the kernel's error (fsyncgate); a retry
                    # would falsely ack.
                    raise OSError("wal fsync previously failed")
                if self._py_synced >= seq:
                    return
                if not self._py_sync_in_flight:
                    self._py_sync_in_flight = True
                    cover = self._py_written
                    self._py_cv.release()
                    try:
                        os.fsync(self._fh.fileno())
                    except OSError:
                        self._py_cv.acquire()
                        self._py_sync_in_flight = False
                        self._py_failed = True
                        self._py_cv.notify_all()
                        raise
                    self._py_cv.acquire()
                    self._py_fsyncs += 1
                    self._py_sync_in_flight = False
                    self._py_cv.notify_all()
                    if cover > self._py_synced:
                        self._py_synced = cover
                    return
                self._py_cv.wait()

    def _write_torn_frame(self, blob: bytes) -> None:
        """A crash mid-append: a partial frame (header + half the payload)
        at the tail of the active WAL (raft.py:650)."""
        frame = _CRC_HDR.pack(len(blob), 0xDEADBEEF) + blob
        with open(self.crc_path, "ab") as fh:
            fh.write(frame[:max(4, len(frame) // 2)])
            fh.flush()

    def _fsync_dir(self) -> None:
        """Make the data dir's entries (renames, a created file) durable."""
        _fsync_dir(self.data_dir)

    def fsyncs(self) -> int:
        """fsyncs made by appliers' durability waits since this log
        opened (rolled WALs included)."""
        live = (self._nwal.fsyncs() if self._nwal is not None
                else self._py_fsyncs)
        return self._fsyncs_before + live

    def _roll_wal(self, index: int) -> List[str]:
        """Seal the active WAL into ``walseg-<index>.crc`` and open a fresh
        one (raft.py:665; the caller holds the log lock).  What is sealed
        is made durable first, so a token issued before the roll resolves
        against an fsynced prefix, and the directory after the rename and
        the creation, so no entry of the fresh WAL is acknowledged before
        its file is.  Returns the sealed paths, deleted once the snapshot
        that covers them is durable."""
        # Wait out the durability waiters: appends are blocked by the log
        # lock, so the set only drains, and waiters never take that lock.
        with self._py_cv:
            while self._sync_inflight:
                self._py_cv.wait(0.05)
        try:
            if self._nwal is not None:
                self._nwal.sync()
                self._fsyncs_before += self._nwal.fsyncs()
                self._nwal.close()
            else:
                os.fsync(self._fh.fileno())
                self._fh.close()
        except OSError:
            if self._nwal is None:
                with self._py_cv:
                    self._py_failed = True
                    self._py_cv.notify_all()
            self._wal_failed = True
            raise
        segs: List[str] = []
        if os.path.exists(self.crc_path) and os.path.getsize(self.crc_path):
            seg = os.path.join(self.data_dir, f"walseg-{index:012d}.crc")
            os.replace(self.crc_path, seg)
            segs.append(seg)
        if self._nwal is not None:
            from ..native import NativeWAL

            self._nwal = NativeWAL(self.crc_path)
        else:
            self._fh = open(self.crc_path, "ab")
            with self._py_cv:
                self._py_synced = self._py_written
                self._py_cv.notify_all()
        self._fsync_dir()
        self._entries_since_snap = 0
        self._bytes_since_snap = 0
        return segs

    def _persist_snapshot_blob(self, snap_store, index: int) -> None:
        """Serialize and write the FSM snapshot: the expensive step, run
        outside the log lock (the seam the off-apply-path tests hook)."""
        blob = snap_store.persist()
        path = os.path.join(self.data_dir, f"snapshot-{index}")
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(blob)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        self._fsync_dir()
        self.last_snapshot_bytes = len(blob)

    def _snapshot_impl(self) -> bool:
        """One FSM snapshot and WAL compaction (raft.py:727; fsm.go:568,
        two snapshots retained).  The log lock is held for the target
        check, a copy-on-write store snapshot and the roll; the
        serialization and the fsyncs run outside it."""
        t0 = time.perf_counter()
        with self._snap_serial:
            # The sequencer drain runs without the log lock (FSM-apply
            # hooks read applied_index(), which takes it): read the
            # target, wait for the sequencer to pass it, then re-take the
            # lock and check nothing new was assigned; chase a moving
            # target a bounded number of times.
            for _attempt in range(50):
                with self._l:
                    if self._wal_failed:
                        return False
                    index = self._last_index
                with self._apply_cv:
                    while (self._apply_next <= index
                           and not self._apply_failed):
                        self._apply_cv.wait(timeout=1.0)
                with self._l:
                    if self._wal_failed:
                        return False
                    if self._last_index != index:
                        continue
                    snap_store = self.fsm.state.snapshot()
                    segs = self._roll_wal(index)
                    break
            else:
                return False  # never quiesced: the next tick retries
            # Appends flow into the fresh WAL from here on.  A crash
            # anywhere below is safe: the sealed segments still hold
            # every entry the unfinished snapshot would cover.
            self._persist_snapshot_blob(snap_store, index)
            for seg in segs:
                try:
                    os.unlink(seg)
                except OSError:  # pragma: no cover - best effort
                    pass
            for _old, old_path in \
                    self._snapshot_files()[:-SNAPSHOTS_RETAINED]:
                try:
                    os.unlink(old_path)
                except OSError:  # pragma: no cover
                    pass
        self.metrics.incr_counter("raft.snapshot")
        self.metrics.measure_since("raft.snapshot.persist", t0)
        return True

    def _auto_snapshot_loop(self) -> None:
        """The threshold watcher (hashicorp/raft runSnapshots): snapshots
        on this thread, never on an applier's."""
        while not self._snap_stop.wait(self.snapshot_interval):
            with self._l:
                due = not self._wal_failed and (
                    (self.snapshot_entries > 0
                     and self._entries_since_snap >= self.snapshot_entries)
                    or (self.snapshot_bytes > 0
                        and self._bytes_since_snap >= self.snapshot_bytes))
            if not due:
                continue
            try:
                if self._snapshot_impl():
                    self.metrics.incr_counter("raft.snapshot.auto")
            except Exception:
                logger.exception("automatic FSM snapshot failed")

    def snapshot(self) -> bool:
        """Write an FSM snapshot and compact the WAL now (the operator's
        entry point; the automatic path runs the same code).  False when
        the log could not be quiesced or has failed."""
        return self._snapshot_impl()

    def threads(self) -> List[threading.Thread]:
        t = self._snap_thread
        return [t] if t is not None and t.is_alive() else []

    def close(self) -> None:
        self._snap_stop.set()
        if self._snap_thread is not None:
            self._snap_thread.join(timeout=5.0)
        if self._nwal is not None:
            self._nwal.close()
        if self._fh is not None:
            self._fh.close()


# ---------------------------------------------------------------------------
# Multi-server replication (hashicorp/raft)
# ---------------------------------------------------------------------------

# Log entries are [index, term, msg_type, payload_blob] lists, as they
# cross the wire.  NOOP_TYPE marks an entry that commits prior-term
# entries without feeding the FSM (hashicorp/raft LogNoop); CONFIG_TYPE
# entries carry the voter set (LogConfiguration), so every server's
# quorum derives from a committed configuration, never from its private
# membership view (raft.py:845-846).  A CONFIG entry's blob is a struct-
# codec frame of the sorted voter addresses (the reference packs it with
# msgpack, raft.py:1263, :1430).
NOOP_TYPE = -1
CONFIG_TYPE = -2


def _encode_peers(peers: List[str]) -> bytes:
    return encode_payload(list(peers))


def _decode_peers(blob: bytes) -> List[str]:
    return list(decode_payload(blob))


class RaftTimeoutError(Exception):
    """An apply did not reach a quorum within the timeout (raft.Apply's
    ErrEnqueueTimeout)."""


class _ApplyFuture:
    """The outcome of one leader-appended entry: the FSM's result once
    the entry commits and applies, or the error when leadership was lost
    first (raft.py:854)."""

    __slots__ = ("_ev", "result", "error")

    def __init__(self):
        self._ev = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None

    def resolve(self, result) -> None:
        self.result = result
        self._ev.set()

    def fail(self, exc: Exception) -> None:
        self.error = exc
        self._ev.set()

    def wait(self, timeout: float):
        if not self._ev.wait(timeout):
            raise RaftTimeoutError("raft apply timed out awaiting quorum")
        if self.error is not None:
            raise self.error
        return self.result


class _RaftStore:
    """``MultiRaft``'s durable state: the current term and vote, the entry
    log and FSM snapshots (raft.py:883; raft-boltdb's log and stable
    stores and the snapshot store).  ``data_dir=None`` keeps everything
    in memory (the raftInmem dev path).

    Layout, every file in ``FileLog``'s ``[u32 len][u32 crc32][payload]``
    framing:

    - ``meta.crc``     — one frame, a codec frame of ``{term, voted_for,
      peers}``, rewritten through a fsynced temporary file;
    - ``wal.crc``      — one frame per entry, a codec frame of
      ``[index, term, type, blob]``;
    - ``snapshot-<idx>-<term>`` — one frame holding the FSM snapshot.

    A torn or corrupt WAL tail is truncated at load; a snapshot whose
    frame does not check is skipped for the next newest.  Every rewrite
    or rename is followed by a fsync of the directory, as ``FileLog``
    does: the reference skips it (raft.py:973-1032), which leaves a power
    loss after a rename uncovered."""

    def __init__(self, data_dir: Optional[str]):
        self.dir = data_dir
        self._fh = None
        if self.dir:
            os.makedirs(self.dir, exist_ok=True)

    # -- load --------------------------------------------------------------

    def load(self):
        """(term, voted_for, peers, base_index, base_term, entries,
        snapshot_blob or None)."""
        term, voted = 0, None
        peers: List[str] = []
        base_index, base_term = 0, 0
        entries: List[list] = []
        snap_blob = None
        if not self.dir:
            return term, voted, peers, base_index, base_term, entries, snap_blob

        meta_path = os.path.join(self.dir, "meta.crc")
        if os.path.exists(meta_path):
            frames, _, _ = _read_crc_frames(meta_path)
            if not frames:
                raise ValueError(f"raft meta {meta_path} is corrupt")
            meta = decode_payload(frames[0])
            term, voted = meta.get("term", 0), meta.get("voted_for")
            peers = list(meta.get("peers") or [])

        for (idx, snap_term), path in reversed(self._snapshot_files()):
            frames, _, _ = _read_crc_frames(path)
            if frames:
                base_index, base_term, snap_blob = idx, snap_term, frames[0]
                break
            logger.warning("raft: skipping corrupt snapshot %s", path)

        wal_path = os.path.join(self.dir, "wal.crc")
        if os.path.exists(wal_path):
            frames, good, size = _read_crc_frames(wal_path)
            end = 0
            for blob in frames:
                try:
                    entry = list(decode_payload(blob))
                except Exception:
                    break  # an undecodable record: a corrupt tail
                end += _CRC_HDR.size + len(blob)
                if entry[0] <= base_index:
                    continue  # covered by the snapshot
                entries.append(entry)
            if end < size:
                with open(wal_path, "r+b") as fh:
                    fh.truncate(end)
                    fh.flush()
                    os.fsync(fh.fileno())
        self._fh = open(wal_path, "ab")
        _fsync_dir(self.dir)
        return term, voted, peers, base_index, base_term, entries, snap_blob

    def _snapshot_files(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("snapshot-") and not name.endswith(".tmp"):
                parts = name.split("-")
                try:
                    idx, term = int(parts[1]), int(parts[2])
                except (IndexError, ValueError):
                    continue
                out.append(((idx, term), os.path.join(self.dir, name)))
        return sorted(out)

    # -- persist -----------------------------------------------------------

    def _replace(self, path: str, data: bytes) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        _fsync_dir(self.dir)

    def save_meta(self, term: int, voted_for: Optional[str],
                  peers: Optional[List[str]] = None) -> None:
        if not self.dir:
            return
        self._replace(os.path.join(self.dir, "meta.crc"), _crc_frame(
            encode_payload({"term": term, "voted_for": voted_for,
                            "peers": list(peers or [])})))

    @staticmethod
    def _entry_frames(entries: List[list]) -> bytes:
        return b"".join(_crc_frame(encode_payload(list(e)))
                        for e in entries)

    def append(self, entries: List[list]) -> None:
        """One write and one fsync for the whole batch."""
        if self._fh is None:
            return
        self._fh.write(self._entry_frames(entries))
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def rewrite(self, entries: List[list]) -> None:
        """Conflict truncation and compaction: the whole WAL replaced
        atomically (a fsynced temporary file renamed over it), so a crash
        mid-rewrite never loses an entry a quorum counted on."""
        if not self.dir:
            return
        path = os.path.join(self.dir, "wal.crc")
        if self._fh is not None:
            self._fh.close()
        self._replace(path, self._entry_frames(entries))
        self._fh = open(path, "ab")

    def save_snapshot(self, index: int, term: int, blob: bytes) -> None:
        if not self.dir:
            return
        self._replace(os.path.join(self.dir, f"snapshot-{index}-{term}"),
                      _crc_frame(blob))
        for _, old in self._snapshot_files()[:-SNAPSHOTS_RETAINED]:
            os.unlink(old)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class MultiRaft(RaftLog):
    """Leader election and log replication across servers over the RPC
    layer's raft channel (raft.py:1042; hashicorp/raft beneath
    nomad/server.go setupRaft, carried by raft_rpc.go's RaftLayer on the
    shared RPC port).

    ``apply`` blocks until the entry is committed by a majority and
    applied locally and returns (result, index), as the single voter's
    does, so the server above it does not change.  The leader applies its
    own entries from the payload objects it was handed; followers decode
    the replicated blob.

    Timing (the reference's ``NOMAD_TPU_RAFT_HEARTBEAT_S``,
    ``NOMAD_TPU_RAFT_ELECTION_MIN_S``/``MAX_S`` and
    ``NOMAD_TPU_SNAPSHOT_CHUNK``, raft.py:1094-1100, :1568): the
    ``heartbeat_interval``, ``election_timeout`` (min, max) and
    ``snapshot_chunk`` arguments, with the same defaults.  The election
    jitter is seeded with ``hash(my_addr)`` (raft.py:1085), which depends
    on the process's string hash seed: which server wins an election is
    not a thing to rely on."""

    # Election timeout must exceed the worst-case latency of a new
    # leader's first heartbeat (the reference runs 500 ms-1 s timeouts
    # against 100 ms heartbeats).
    HEARTBEAT_INTERVAL = 0.05
    ELECTION_TIMEOUT = (0.30, 0.60)
    APPLY_TIMEOUT = 10.0
    REPLICATE_BATCH = 512
    # Compact once the in-memory log passes this many entries
    # (hashicorp/raft SnapshotThreshold).
    SNAPSHOT_THRESHOLD = 8192
    SNAPSHOT_CHUNK = 4 << 20
    # Entries applied per lock hold by the applier thread: an incoming
    # AppendEntries never waits behind a long committed backlog.
    APPLY_CHUNK = 16

    def __init__(self, fsm: FSM, my_addr: str, pool,
                 data_dir: Optional[str] = None, logger=None,
                 heartbeat_interval: Optional[float] = None,
                 election_timeout: Optional[Tuple[float, float]] = None,
                 snapshot_chunk: Optional[int] = None):
        super().__init__(fsm)
        self.logger = logger or logging.getLogger("nomad_tpu_torch.raft")
        self.my_addr = my_addr
        self.pool = pool
        self._rand = random.Random(hash(my_addr) & 0xFFFFFF)
        self._leader = False  # starts as a follower
        if heartbeat_interval is not None:
            self.HEARTBEAT_INTERVAL = heartbeat_interval
        if election_timeout is not None:
            self.ELECTION_TIMEOUT = tuple(election_timeout)
        if snapshot_chunk is not None:
            self.SNAPSHOT_CHUNK = max(1, int(snapshot_chunk))

        self.store = _RaftStore(data_dir)
        (self.term, self.voted_for, saved_peers, self.base_index,
         self.base_term, self.log, snap_blob) = self.store.load()
        if snap_blob is not None:
            self.fsm.restore(snap_blob)
        # Only the snapshot's prefix is known committed at boot: entries
        # past it are committed again by the leader.
        self.commit_index = self.base_index
        self._last_index = self.base_index  # the last applied
        self._applied = self.base_index

        self.leader_addr: Optional[str] = None
        self.state = "follower"
        # The voter set comes from the persisted committed configuration;
        # a fresh server has none and cannot campaign until it is
        # bootstrapped (initial formation) or added through a CONFIG entry.
        self.peers: List[str] = saved_peers or [my_addr]
        self._bootstrapped = bool(saved_peers)
        # Non-voting members: replicated like voters (they apply the FSM,
        # which follower scheduling needs) but never counted toward a
        # quorum and never campaigning.
        self.learners: List[str] = []

        self._futures: dict = {}           # index -> _ApplyFuture
        # The payload objects of the leader's own entries: its FSM apply
        # skips decoding its own blob.  Dropped at apply and at conflict
        # truncation (a truncated index may be refilled by another
        # leader's entry).
        self._local_payloads: dict = {}    # index -> payload
        self._next: dict = {}              # peer -> next index to send
        self._match: dict = {}             # peer -> highest replicated
        self._repl_events: dict = {}       # peer -> threading.Event
        self._repl_threads: dict = {}      # peer -> (term, Thread)
        self._snap_rx: Optional[dict] = None

        self._last_contact = 0.0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # The applier thread drains commit_index outside the
        # AppendEntries reply path: a follower acks once it has appended.
        self._apply_kick = threading.Event()
        # Leadership transitions reach the callbacks in the order they
        # happened, through one dispatcher thread.
        self._leader_q: "queue.Queue" = queue.Queue()

    def _leader_dispatch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                val = self._leader_q.get(timeout=0.5)
            except queue.Empty:
                continue
            try:
                self._set_leader(val)
            except Exception:
                # A raising callback must not kill the dispatcher: later
                # transitions still need delivery.
                self.logger.exception("raft: leadership callback failed")

    # -- log shape helpers (the caller holds self._l) ----------------------

    def _last_log_index(self) -> int:
        return self.base_index + len(self.log)

    def _term_at(self, index: int) -> int:
        if index == self.base_index:
            return self.base_term
        if index < self.base_index or index > self._last_log_index():
            return -1  # unknown (compacted away, or beyond the end)
        return self.log[index - self.base_index - 1][1]

    def _entries_from(self, index: int, limit: int) -> List[list]:
        start = index - self.base_index - 1
        return self.log[start:start + limit]

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._last_contact = time.monotonic()
        for target, name in ((self._ticker, "raft-ticker"),
                             (self._leader_dispatch_loop, "raft-leadership"),
                             (self._apply_loop, "raft-applier")):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def _apply_loop(self) -> None:
        """Drains ``commit_index`` in chunks; ordering holds because
        ``_apply_to`` advances ``_last_index`` only under the lock."""
        while not self._stop.is_set():
            if not self._apply_kick.wait(0.05):
                continue
            self._apply_kick.clear()
            while not self._stop.is_set():
                with self._l:
                    if self._last_index >= self.commit_index:
                        break
                    self._apply_to(min(self.commit_index,
                                       self._last_index + self.APPLY_CHUNK))

    def threads(self) -> List[threading.Thread]:
        out = list(self._threads)
        out += [t for _term, t in list(self._repl_threads.values())]
        return [t for t in out if t.is_alive()]

    def close(self) -> None:
        self._stop.set()
        with self._l:
            self._fail_futures(NotLeaderError("shutting down"))
            events = list(self._repl_events.values())
        for ev in events:
            ev.set()
        self._apply_kick.set()
        for t in self.threads():
            if t is not threading.current_thread():
                t.join(timeout=5.0)
        with self._l:
            self.store.close()

    def bootstrap(self, peers: List[str]) -> None:
        """Adopt the initial voter set and enable elections (serf.go:91
        maybeBootstrap).  A no-op once a configuration exists: later
        changes replicate through the log (``propose_config``)."""
        with self._l:
            if self._bootstrapped:
                return
            self.peers = sorted(set(peers) | {self.my_addr})
            self._bootstrapped = True
            self._persist_meta()

    def propose_config(self, peers: List[str]) -> None:
        """A leader-only voter-set change through a replicated CONFIG
        entry (hashicorp/raft AddVoter; the leader uses the new set once
        it is appended, followers once it applies)."""
        with self._l:
            if self.state != "leader":
                raise NotLeaderError(self.leader_addr or "")
            peers = sorted(set(peers) | {self.my_addr})
            if peers == self.peers:
                return
            index = self._last_log_index() + 1
            entry = [index, self.term, CONFIG_TYPE, _encode_peers(peers)]
            self.log.append(entry)
            self.store.append([entry])
            fut = _ApplyFuture()
            self._futures[index] = fut
            self._adopt_peers(peers)
            self._advance_commit()
        self._kick_replicators()
        fut.wait(self.APPLY_TIMEOUT)

    def _adopt_peers(self, peers: List[str]) -> None:
        # the caller holds self._l
        added = [p for p in peers if p not in self.peers]
        self.peers = list(peers)
        self._bootstrapped = True
        self._persist_meta()
        if self.state == "leader":
            for p in added:
                if p != self.my_addr:
                    self._start_replicator(p)

    def _quorum(self) -> int:
        return len(self.peers) // 2 + 1

    def is_raft_leader(self) -> bool:
        with self._l:
            return self.state == "leader"

    def fence_index(self) -> int:
        """The last log index: election safety puts every committed entry
        at or below it, and unlike the applied index it cannot lag the
        applier thread."""
        with self._l:
            return self._last_log_index()

    def _persist_meta(self) -> None:
        # the caller holds self._l
        self.store.save_meta(self.term, self.voted_for,
                             self.peers if self._bootstrapped else [])

    # -- RPC entry (RPCServer.raft_handler) --------------------------------

    def handle_message(self, msg: dict) -> dict:
        if self._stop.is_set():
            raise RuntimeError("raft: node is shut down")
        kind = msg.get("kind")
        if kind == "request_vote":
            return self._on_request_vote(msg)
        if kind == "append_entries":
            return self._on_append_entries(msg)
        if kind == "install_snapshot":
            return self._on_install_snapshot(msg)
        raise ValueError(f"unknown raft message kind {kind!r}")

    # -- election ----------------------------------------------------------

    def _election_timeout(self) -> float:
        lo, hi = self.ELECTION_TIMEOUT
        return lo + self._rand.random() * (hi - lo)

    def add_learner(self, addr: str) -> None:
        """Leader side: a non-voting member joins the replication fan-out
        (no CONFIG entry: learners are not in the quorum's set)."""
        with self._l:
            if (addr == self.my_addr or addr in self.peers
                    or addr in self.learners):
                return
            self.learners.append(addr)
            if self.state == "leader":
                self._start_replicator(addr)

    def _ticker(self) -> None:
        timeout = self._election_timeout()
        while not self._stop.is_set():
            time.sleep(0.015)
            with self._l:
                # Non-members never campaign: a learner, or a voter
                # removed from the set, cannot win a quorum.
                campaigning_ok = (self._bootstrapped
                                  and self.state != "leader"
                                  and self.my_addr in self.peers)
                since = time.monotonic() - self._last_contact
            if campaigning_ok and since >= timeout and \
                    not self._stop.is_set():
                self._run_election()
                timeout = self._election_timeout()

    def _run_election(self) -> None:
        from .rpc import RPC_RAFT

        with self._l:
            self.state = "candidate"
            self.term += 1
            term = self.term
            self.voted_for = self.my_addr
            self._persist_meta()
            self.leader_addr = None
            last_index = self._last_log_index()
            last_term = self._term_at(last_index)
            peers = [p for p in self.peers if p != self.my_addr]
            self._last_contact = time.monotonic()
        votes = 1
        lock = threading.Lock()
        done = threading.Event()

        def ask(peer):
            nonlocal votes
            try:
                reply = self.pool.call(peer, "raft", {
                    "kind": "request_vote", "term": term,
                    "candidate": self.my_addr,
                    "last_log_index": last_index, "last_log_term": last_term,
                }, channel=RPC_RAFT, timeout=0.5)
            except Exception:
                return
            step_down = False
            with self._l:
                if reply.get("term", 0) > self.term:
                    self._step_down(reply["term"])
                    step_down = True
            if step_down:
                done.set()
                return
            with lock:
                if reply.get("granted"):
                    votes += 1
                    if votes >= self._quorum():
                        done.set()

        threads = [threading.Thread(target=ask, args=(p,), daemon=True,
                                    name="raft-vote")
                   for p in peers]
        for t in threads:
            t.start()
        if not peers:
            done.set()
        done.wait(timeout=0.6)
        with self._l:
            if self.state == "candidate" and self.term == term \
                    and votes >= self._quorum() and not self._stop.is_set():
                self._become_leader()
                # The callbacks (broker enable, eval restore, ...) run on
                # the dispatcher thread, outside the raft lock: they may
                # apply entries themselves.
                self._leader_q.put(True)

    def _become_leader(self) -> None:
        # the caller holds self._l
        self.state = "leader"
        self.leader_addr = self.my_addr
        self.logger.info("raft: %s won election for term %d",
                         self.my_addr, self.term)
        last = self._last_log_index()
        for p in self.peers:
            if p == self.my_addr:
                continue
            self._next[p] = last + 1
            self._match[p] = 0
        # The term-establishment entry (Raft §5.4.2: a leader never counts
        # replicas of older-term entries toward a commit).  It carries the
        # voter set, so every follower adopts and persists the committed
        # configuration.
        cfg = [last + 1, self.term, CONFIG_TYPE, _encode_peers(self.peers)]
        self.log.append(cfg)
        self.store.append([cfg])
        for p in self.peers + self.learners:
            if p != self.my_addr:
                self._start_replicator(p)
        self._advance_commit()

    def _start_replicator(self, peer: str) -> None:
        # The caller holds self._l.  Replicators are per (peer, term): an
        # older term's thread is already exiting (its term check fails).
        old = self._repl_threads.get(peer)
        if old is not None and old[0] == self.term and old[1].is_alive():
            self._repl_events[peer].set()
            return
        self._next.setdefault(peer, self._last_log_index() + 1)
        self._match.setdefault(peer, 0)
        ev = threading.Event()
        ev.set()
        self._repl_events[peer] = ev
        t = threading.Thread(target=self._replicate_peer,
                             args=(peer, self.term, ev),
                             name=f"raft-repl-{peer}", daemon=True)
        self._repl_threads[peer] = (self.term, t)
        t.start()

    def _step_down(self, term: int) -> None:
        # the caller holds self._l
        was_leader = self.state == "leader"
        if term > self.term:
            self.term = term
            self.voted_for = None
            self._persist_meta()
        self.state = "follower"
        self._fail_futures(NotLeaderError(self.leader_addr or ""))
        for ev in self._repl_events.values():
            ev.set()  # replicators observe the term change
        if was_leader:
            self._leader_q.put(False)

    def _fail_futures(self, exc: Exception) -> None:
        # the caller holds self._l
        for fut in self._futures.values():
            fut.fail(exc)
        self._futures.clear()

    def _on_request_vote(self, msg: dict) -> dict:
        with self._l:
            if msg["term"] < self.term:
                return {"granted": False, "term": self.term}
            if msg["term"] > self.term:
                self._step_down(msg["term"])
            my_last = self._last_log_index()
            up_to_date = (
                msg["last_log_term"], msg["last_log_index"]
            ) >= (self._term_at(my_last), my_last)
            if up_to_date and self.voted_for in (None, msg["candidate"]):
                self.voted_for = msg["candidate"]
                self._persist_meta()  # durable before granting (§5.2)
                self._last_contact = time.monotonic()
                return {"granted": True, "term": self.term}
            return {"granted": False, "term": self.term}

    # -- leader replication ------------------------------------------------

    def _replicate_peer(self, peer: str, term: int,
                        kick: threading.Event) -> None:
        """The per-peer replication loop (hashicorp/raft replicate()):
        ships missing entries or heartbeats, and InstallSnapshot when the
        peer is behind the compaction horizon."""
        from .rpc import RPC_RAFT

        while not self._stop.is_set():
            with self._l:
                if self.state != "leader" or self.term != term:
                    return
                ni = self._next.get(peer, self.base_index + 1)
                snapshot_needed = ni <= self.base_index
                if not snapshot_needed:
                    entries = self._entries_from(ni, self.REPLICATE_BATCH)
                    prev_index = ni - 1
                    prev_term = self._term_at(prev_index)
                    commit = self.commit_index
            try:
                if snapshot_needed:
                    self._send_snapshot(peer, term)
                    continue
                reply = self.pool.call(peer, "raft", {
                    "kind": "append_entries", "term": term,
                    "leader": self.my_addr,
                    "prev_log_index": prev_index,
                    "prev_log_term": prev_term,
                    "entries": entries,
                    "leader_commit": commit,
                }, channel=RPC_RAFT, timeout=2.0)
            except Exception:
                kick.clear()
                kick.wait(0.1)
                continue
            with self._l:
                if reply.get("term", 0) > self.term:
                    self._step_down(reply["term"])
                    return
                if self.state != "leader" or self.term != term:
                    return
                if reply.get("success"):
                    sent_through = prev_index + len(entries)
                    self._match[peer] = max(self._match.get(peer, 0),
                                            sent_through)
                    self._next[peer] = sent_through + 1
                    self._advance_commit()
                    more = self._next[peer] <= self._last_log_index()
                else:
                    # The consistency check failed: back up by the
                    # follower's hint.  A hint behind the compaction
                    # horizon means a snapshot.
                    hint = reply.get("match", prev_index - 1)
                    if hint < self.base_index:
                        self._next[peer] = self.base_index
                    else:
                        self._next[peer] = max(self.base_index + 1,
                                               min(hint + 1, ni - 1))
                    more = True
            if not more:
                kick.clear()
                kick.wait(self.HEARTBEAT_INTERVAL)

    def _send_snapshot(self, peer: str, term: int) -> None:
        """InstallSnapshot for a peer behind the log horizon: one frame up
        to ``SNAPSHOT_CHUNK`` bytes, chunked offset/total/done frames past
        it.  Each chunk refreshes the follower's leader-contact clock, so
        a large install does not starve its election timer."""
        from .rpc import RPC_RAFT

        with self._l:
            if self.state != "leader" or self.term != term:
                return
            blob = self.fsm.snapshot()
            last_index = self._last_index
            last_term = self._term_at(last_index)
            if last_term < 0:
                last_term = self.base_term
            peers = list(self.peers)
        chunk = self.SNAPSHOT_CHUNK
        base = {"kind": "install_snapshot", "term": term,
                "leader": self.my_addr,
                "last_index": last_index, "last_term": last_term,
                "peers": peers}  # the configuration rides the snapshot
        try:
            if len(blob) <= chunk:
                reply = self.pool.call(
                    peer, "raft", dict(base, data=blob),
                    channel=RPC_RAFT, timeout=10.0)
            else:
                total = len(blob)
                reply = None
                for off in range(0, total, chunk):
                    with self._l:
                        if self.state != "leader" or self.term != term:
                            return
                    reply = self.pool.call(peer, "raft", dict(
                        base, data=blob[off:off + chunk], offset=off,
                        total=total, done=off + chunk >= total,
                    ), channel=RPC_RAFT, timeout=10.0)
                    self.metrics.incr_counter("raft.snapshot.chunks_sent")
                    if reply.get("term", 0) > term \
                            or not reply.get("success", False):
                        break  # demoted, or the receiver lost the sequence
        except Exception:
            self._repl_events[peer].clear()
            self._repl_events[peer].wait(0.2)
            return
        with self._l:
            if reply is not None and reply.get("term", 0) > self.term:
                self._step_down(reply["term"])
                return
            if reply is None or not reply.get("success", True):
                # The receiver aborted: the loop retries from offset 0.
                return
            self._match[peer] = max(self._match.get(peer, 0), last_index)
            self._next[peer] = last_index + 1
            self._advance_commit()

    def _kick_replicators(self) -> None:
        with self._l:
            events = list(self._repl_events.values())
        for ev in events:
            ev.set()

    def _advance_commit(self) -> None:
        """Majority-match commit; only current-term entries commit by
        counting (Raft §5.4.2).  The caller holds self._l."""
        if self.state != "leader":
            return
        matches = sorted(
            [self._last_log_index()]
            + [self._match.get(p, 0) for p in self.peers if p != self.my_addr]
        )
        n = matches[len(matches) - self._quorum()]
        if n > self.commit_index and self._term_at(n) == self.term:
            self.commit_index = n
            if self._threads:
                # The FSM applies (and the futures resolve) on the
                # applier thread, not under a replicator's reply handling.
                self._apply_kick.set()
            else:  # not started (a unit test's harness): inline
                self._apply_to(self.commit_index)

    def _apply_to(self, target: int) -> None:
        """Apply committed entries through ``target`` in index order,
        resolving their futures.  The caller holds self._l."""
        while self._last_index < target:
            idx = self._last_index + 1
            _eidx, _eterm, mt, blob = self.log[idx - self.base_index - 1]
            result = None
            fut = self._futures.pop(idx, None)
            if mt == CONFIG_TYPE:
                peers = _decode_peers(blob)
                if peers != self.peers:
                    self._adopt_peers(peers)
                else:
                    self._bootstrapped = True
                    self._persist_meta()
            elif mt != NOOP_TYPE:
                payload = self._local_payloads.pop(idx, None)
                try:
                    result = self.fsm.apply(
                        idx, MessageType(mt),
                        payload if payload is not None
                        else decode_payload(blob))
                except Exception as exc:
                    self.logger.exception("raft: fsm apply failed at %d",
                                          idx)
                    self._last_index = self._applied = idx
                    if fut is not None:
                        fut.fail(exc)
                    continue
            self._last_index = idx
            self._applied = idx
            if fut is not None:
                fut.resolve(result)
        if len(self.log) > self.SNAPSHOT_THRESHOLD:
            self._compact()

    # -- follower side -----------------------------------------------------

    def _on_append_entries(self, msg: dict) -> dict:
        with self._l:
            if msg["term"] < self.term:
                return {"success": False, "term": self.term}
            if msg["term"] > self.term or self.state != "follower":
                self._step_down(msg["term"])
                self.term = msg["term"]
                self._persist_meta()
            self.leader_addr = msg["leader"]
            self._last_contact = time.monotonic()

            prev_index = msg["prev_log_index"]
            prev_term = msg["prev_log_term"]
            entries = [list(e) for e in msg["entries"]]
            # At or before our snapshot's base everything is committed
            # here: skip those entries and anchor at the base.
            if prev_index < self.base_index:
                entries = [e for e in entries if e[0] > self.base_index]
                prev_index = self.base_index
                prev_term = self.base_term
            if prev_index > self._last_log_index():
                return {"success": False, "term": self.term,
                        "match": self._last_log_index()}
            if self._term_at(prev_index) != prev_term:
                return {"success": False, "term": self.term,
                        "match": max(self.base_index, prev_index - 1)}
            # Truncate a conflict, then append the new suffix with one
            # durable write (one fsync a message, not an entry).
            append_from = None
            for k, e in enumerate(entries):
                pos = e[0] - self.base_index - 1
                if pos < len(self.log):
                    if self.log[pos][1] != e[1]:
                        del self.log[pos:]
                        self.store.rewrite(self.log)
                        # Another leader refills these indexes.
                        for cached in [i for i in self._local_payloads
                                       if i >= e[0]]:
                            del self._local_payloads[cached]
                        append_from = k
                        break
                    # the same entry is already here: skip
                else:
                    append_from = k
                    break
            if append_from is not None:
                new = entries[append_from:]
                self.log.extend(new)
                self.store.append(new)
            new_commit = min(msg["leader_commit"], self._last_log_index())
            if new_commit > self.commit_index:
                self.commit_index = new_commit
                if self._threads:
                    # Ack now, apply on the applier thread: a busy
                    # follower's apply time never rides the leader's
                    # quorum wait.
                    self._apply_kick.set()
                else:  # not started (a unit test's harness): inline
                    self._apply_to(new_commit)
            return {"success": True, "term": self.term,
                    "match": self._last_log_index()}

    def _on_install_snapshot(self, msg: dict) -> dict:
        with self._l:
            if msg["term"] < self.term:
                return {"term": self.term}
            if msg["term"] > self.term or self.state != "follower":
                self._step_down(msg["term"])
                self.term = msg["term"]
                self._persist_meta()
            self.leader_addr = msg["leader"]
            self._last_contact = time.monotonic()
            if "offset" in msg:
                # A chunked install: chunks buffer until ``done``.  The key
                # pins one transfer; any break in the sequence (a leader
                # restart, an interleaved transfer) replies success=False
                # and the leader starts again from offset 0.
                key = (msg["term"], msg["last_index"], msg["total"])
                rx = self._snap_rx
                if msg["offset"] == 0:
                    rx = self._snap_rx = {"key": key, "chunks": [],
                                          "received": 0}
                if (rx is None or rx["key"] != key
                        or rx["received"] != msg["offset"]):
                    self._snap_rx = None
                    return {"term": self.term, "success": False}
                rx["chunks"].append(msg["data"])
                rx["received"] += len(msg["data"])
                if not msg.get("done"):
                    return {"term": self.term, "success": True}
                self._snap_rx = None
                if rx["received"] != msg["total"]:
                    return {"term": self.term, "success": False}
                msg = dict(msg, data=b"".join(rx["chunks"]))
            self.fsm.restore(msg["data"])
            if msg.get("peers"):
                self._adopt_peers(list(msg["peers"]))
            self.base_index = msg["last_index"]
            self.base_term = msg["last_term"]
            self.log = []
            self._local_payloads.clear()
            self.store.save_snapshot(self.base_index, self.base_term,
                                     msg["data"])
            self.store.rewrite([])
            self.commit_index = self.base_index
            self._last_index = self.base_index
            self._applied = self.base_index
            return {"term": self.term, "success": True}

    # -- compaction --------------------------------------------------------

    def _compact(self) -> None:
        """Snapshot the FSM at the applied index and drop the entries it
        covers.  The caller holds self._l."""
        applied = self._last_index
        if applied <= self.base_index:
            return
        blob = self.fsm.snapshot()
        new_base_term = self._term_at(applied)
        self.log = self.log[applied - self.base_index:]
        self.base_index = applied
        self.base_term = new_base_term
        self.store.save_snapshot(applied, new_base_term, blob)
        self.store.rewrite(self.log)

    def snapshot(self) -> None:
        with self._l:
            self._compact()

    # -- the apply path ----------------------------------------------------

    def apply(self, msg_type: MessageType, payload: dict):
        t0 = time.perf_counter()
        # Encoded outside the raft lock: concurrent appliers pay their own
        # codec time (index assignment below still orders the log).
        blob = encode_payload(payload)
        with self._l:
            if self.state != "leader":
                raise NotLeaderError(self.leader_addr or "")
            if _fire_apply_fault(self._last_log_index() + 1,
                                 msg_type) is not None:
                # An injected step-down is a real demotion: the cluster
                # re-elects (possibly us) through the election timer.
                self._step_down(self.term)
                raise NotLeaderError(self.leader_addr or "")
            index = self._last_log_index() + 1
            entry = [index, self.term, int(msg_type), blob]
            self.log.append(entry)
            self.store.append([entry])
            fut = _ApplyFuture()
            self._futures[index] = fut
            self._local_payloads[index] = payload
            self._advance_commit()  # a single-voter cluster commits here
        self._kick_replicators()
        result = fut.wait(self.APPLY_TIMEOUT)
        self.metrics.measure_since("raft.apply", t0)
        tr = tracing.TRACER
        if tr is not None:
            tr.record("raft.apply", t0, time.perf_counter(), index=index,
                      msg_type=getattr(msg_type, "name", str(msg_type)))
        return result, index
