"""Native (C++) host components, bound with ctypes (a copy of
``nomad_tpu/native/__init__.py:1-240`` without its environment switches
and without the sanitizer build).

Two libraries: the group-commit WAL behind the durable log
(``wal.cc``, :class:`NativeWAL`) and the struct codec's string-column
loops (``codec.cc``, bound in ``codec/native.py``).

Build: the sources ship in this package and are compiled with ``g++`` at
first use into ``build/native/`` at the repository root (git-ignored),
under a name keyed by a hash of the source and the flags, written to a
temporary file and moved into place (concurrent builds agree), as
``device.py`` builds the CUDA kernels.  They are host code: no ``nvcc``
and no card are needed.  A build that fails raises
:class:`NativeUnavailable`; nothing here falls back to Python.  The
pure-Python log writer and CRC reader are a route of their own,
``FileLog(native=False)``, which the caller asks for.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parent.parent / "build" / "native"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class NativeUnavailable(RuntimeError):
    """A native library could not be built or loaded on this machine."""


def lib_path(source: str) -> Path:
    """The library's path, keyed on its source and the flags."""
    h = hashlib.sha256((HERE / source).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """Compile ``source`` (a ``.cc`` of this package) unless it is built
    already; returns the library's path.  Raises
    :class:`NativeUnavailable` when there is no ``g++`` or it fails."""
    path = lib_path(source)
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeUnavailable(f"g++ not found: {source} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(HERE / source), "-o",
                           str(tmp)], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeUnavailable(f"g++ failed on {source}:\n"
                                f"{proc.stderr[-2000:]}")
    os.replace(tmp, path)   # atomic: concurrent builds agree
    return path


def load(name: str, source: str) -> ctypes.CDLL:
    """The library of ``source``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _LIBS[name] = lib
        return lib


# ---------------------------------------------------------------------------
# Group-commit WAL (wal.cc)
# ---------------------------------------------------------------------------


def _wal_lib() -> ctypes.CDLL:
    lib = load("nomadwal", "wal.cc")
    if not getattr(lib, "_nwal_typed", False):
        lib.nwal_open.restype = ctypes.c_void_p
        lib.nwal_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                  ctypes.c_char_p, ctypes.c_int]
        lib.nwal_entry_count.restype = ctypes.c_long
        lib.nwal_entry_count.argtypes = [ctypes.c_void_p]
        lib.nwal_fsync_count.restype = ctypes.c_long
        lib.nwal_fsync_count.argtypes = [ctypes.c_void_p]
        lib.nwal_append.restype = ctypes.c_int
        lib.nwal_append.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_uint32]
        lib.nwal_write.restype = ctypes.c_uint64
        lib.nwal_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_uint32]
        lib.nwal_sync_seq.restype = ctypes.c_int
        lib.nwal_sync_seq.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.nwal_iter_start.restype = None
        lib.nwal_iter_start.argtypes = [ctypes.c_void_p]
        lib.nwal_iter_next.restype = ctypes.c_int
        lib.nwal_iter_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint32)]
        lib.nwal_reset.restype = ctypes.c_int
        lib.nwal_reset.argtypes = [ctypes.c_void_p]
        lib.nwal_sync.restype = ctypes.c_int
        lib.nwal_sync.argtypes = [ctypes.c_void_p]
        lib.nwal_close.restype = None
        lib.nwal_close.argtypes = [ctypes.c_void_p]
        lib._nwal_typed = True
    return lib


class NativeWAL:
    """CRC-framed append-only record log with group-commit fsync.

    Records are opaque bytes; framing, CRC validation, torn or corrupt
    tail truncation at open, and fsync coalescing across threads live in
    ``wal.cc``.  Raises :class:`NativeUnavailable` when it cannot be
    built."""

    def __init__(self, path: str, fsync: bool = True):
        self._lib = _wal_lib()
        err = ctypes.create_string_buffer(256)
        self._h = self._lib.nwal_open(path.encode(), 1 if fsync else 0,
                                      err, len(err))
        if not self._h:
            raise OSError(f"nwal_open({path}): "
                          f"{err.value.decode(errors='replace')}")
        self.path = path

    def __len__(self) -> int:
        return int(self._lib.nwal_entry_count(self._h))

    def fsyncs(self) -> int:
        """fsync calls made by group-commit syncs so far."""
        return int(self._lib.nwal_fsync_count(self._h))

    def append(self, record: bytes) -> None:
        """Durable when this returns (group-commit fsync)."""
        if self._lib.nwal_append(self._h, record, len(record)) != 0:
            raise OSError(f"nwal_append failed on {self.path}")

    def write(self, record: bytes) -> int:
        """Write one record without waiting for durability; returns its
        seq for :meth:`sync_to`.  The log calls this under its apply lock
        (file order is index order for the durable prefix) and syncs
        outside it, so concurrent appliers share one fsync."""
        seq = self._lib.nwal_write(self._h, record, len(record))
        if seq == 0:
            raise OSError(f"nwal_write failed on {self.path}")
        return seq

    def sync_to(self, seq: int) -> None:
        """Block until records through ``seq`` are durable (group commit
        across concurrent callers)."""
        if self._lib.nwal_sync_seq(self._h, seq) != 0:
            raise OSError(f"nwal_sync_seq failed on {self.path}")

    def records(self) -> Iterator[bytes]:
        """Every record from the start (one cursor: not safe to interleave
        with another iteration; appends are fine)."""
        self._lib.nwal_iter_start(self._h)
        data = ctypes.POINTER(ctypes.c_uint8)()
        length = ctypes.c_uint32()
        while True:
            rc = self._lib.nwal_iter_next(self._h, ctypes.byref(data),
                                          ctypes.byref(length))
            if rc == 0:
                return
            if rc < 0:
                raise OSError(f"nwal_iter_next failed on {self.path}")
            yield ctypes.string_at(data, length.value)

    def sync(self) -> None:
        """fsync everything written so far (the barrier before the log
        rolls the WAL at a snapshot)."""
        if self._lib.nwal_sync(self._h) != 0:
            raise OSError(f"nwal_sync failed on {self.path}")

    def reset(self) -> None:
        """Truncate to empty."""
        if self._lib.nwal_reset(self._h) != 0:
            raise OSError(f"nwal_reset failed on {self.path}")

    def close(self) -> None:
        if self._h:
            self._lib.nwal_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass
