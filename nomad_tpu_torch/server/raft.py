"""The replicated log under the FSM (a subset of
``nomad_tpu/server/raft.py:1-846``; reference hashicorp/raft with its
in-memory store, nomad/server.go:91-95, and raft-boltdb).

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

Each apply passes the ``raft.apply`` fault point first (``crash``,
``error``, ``delay``, ``step_down``; raft.py:40-58) and is traced as a
``raft.apply`` span (raft.py:241-245), which inherits the eval of the
span it runs under (``plan.apply``).  Entries and snapshots are struct-
codec frames (``server/log_codec.py``): a corrupt or foreign file can
only produce registered data types, never code, and a frame of another
struct schema fails to decode.

Left out, for a later slice: ``MultiRaft`` and the replication transport
(ROADMAP queue 1 item 17).
"""
from __future__ import annotations

import logging
import os
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
        size = os.path.getsize(path)
        good = 0
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
                try:
                    index, msg_type, payload = _decode_entry(blob)
                except Exception:
                    break  # an undecodable record: a corrupt tail
                good = fh.tell()
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
                self._fh.write(_CRC_HDR.pack(
                    len(blob), zlib.crc32(blob) & 0xFFFFFFFF))
                self._fh.write(blob)
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
        fd = os.open(self.data_dir, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

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
