"""String-column pack and split: the codec's inner framing loop in C++
(``native/codec.cc``) with a pure-Python twin kept bit-identical (a copy
of ``nomad_tpu/codec/native.py`` without its environment switches).

Where it pays: AllocSlab's node-id columns (tens of thousands of 36-char
uuids a plan), every ``List[str]`` field of a struct, and the string
columns of the snapshot's node section.  The layout is a varint byte
length and the utf8 bytes per string; the caller writes the count.

The native library is built with ``g++`` at first use (``native/
__init__.py``); a build that fails raises -- the twin is not a silent
fallback.  Differential guard: every ``GUARD_EVERY``-th native call
(a module setting; 1 runs it at every call, 0 turns it off) is re-run
through the twin and compared.  A mismatch is counted, logged and raised
as ``CodecError``: the call's bytes reach no log or snapshot, and the
native path stays the one in use (no fallback the caller did not ask
for).  The verdict stays in the codec: unlike the reference, which turns
its native path off and feeds the kernel breaker, a host codec fault
never moves the card's scheduling onto the CPU.
"""
from __future__ import annotations

import ctypes
import logging
from typing import List, Tuple

logger = logging.getLogger("nomad_tpu_torch.codec")

#: The guard's cadence (the reference's NOMAD_TPU_CODEC_GUARD_EVERY
#: default).
GUARD_EVERY = 512

GUARD_RUNS = 0
GUARD_MISMATCHES = 0
NATIVE_PACKS = 0
NATIVE_UNPACKS = 0

_guard_counter = 0
_lib = None


def reset_counters() -> None:
    global GUARD_RUNS, GUARD_MISMATCHES, NATIVE_PACKS, NATIVE_UNPACKS
    global _guard_counter
    GUARD_RUNS = GUARD_MISMATCHES = 0
    NATIVE_PACKS = NATIVE_UNPACKS = 0
    _guard_counter = 0


def _get_lib():
    """codec.cc, built and typed at first use (raises when it cannot be
    built)."""
    global _lib
    if _lib is None:
        from ..native import load

        lib = load("nomadcodec", "codec.cc")
        lib.ncodec_packed_size.restype = ctypes.c_long
        lib.ncodec_packed_size.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_long]
        lib.ncodec_pack_strs.restype = ctypes.c_long
        lib.ncodec_pack_strs.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_long,
            ctypes.c_char_p, ctypes.c_long]
        lib.ncodec_split_strs.restype = ctypes.c_long
        lib.ncodec_split_strs.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
    return _lib


def _guard_due() -> bool:
    global _guard_counter, GUARD_RUNS
    if GUARD_EVERY <= 0:
        return False
    _guard_counter += 1
    if _guard_counter < GUARD_EVERY:
        return False
    _guard_counter = 0
    GUARD_RUNS += 1
    return True


def _mismatch(op: str):
    """Count and log a guard mismatch; returns the error to raise."""
    from .gen import CodecError

    global GUARD_MISMATCHES
    GUARD_MISMATCHES += 1
    logger.error("codec: native %s diverged from the python twin", op)
    return CodecError(f"native {op} diverged from the python twin")


# -- python twins ------------------------------------------------------------


def py_pack_strs(encoded: List[bytes]) -> bytes:
    w = bytearray()
    for e in encoded:
        n = len(e)
        while n > 0x7F:
            w.append(0x80 | (n & 0x7F))
            n >>= 7
        w.append(n)
        w += e
    return bytes(w)


def py_split_strs(b: bytes, p: int, n: int) -> Tuple[List[str], int]:
    from .gen import CodecError

    out = []
    ln = len(b)
    for _ in range(n):
        size = 0
        shift = 0
        while True:
            if p >= ln:
                raise CodecError("truncated string column")
            c = b[p]
            p += 1
            size |= (c & 0x7F) << shift
            if c < 0x80:
                break
            shift += 7
            if shift > 35:
                raise CodecError("string length varint overflow")
        e = p + size
        if e > ln:
            raise CodecError("truncated string column")
        out.append(b[p:e].decode("utf-8"))
        p = e
    return out, p


# -- entry points ------------------------------------------------------------


def pack_strs(strs) -> bytes:
    """Pack a string column (varint length + utf8 per item); the caller
    writes the count."""
    global NATIVE_PACKS
    encoded = [x.encode("utf-8") for x in strs]
    if not encoded:
        return py_pack_strs(encoded)
    lib = _get_lib()
    n = len(encoded)
    lens = (ctypes.c_int32 * n)(*map(len, encoded))
    concat = b"".join(encoded)
    total = lib.ncodec_packed_size(lens, n)
    out = ctypes.create_string_buffer(total)
    written = lib.ncodec_pack_strs(concat, lens, n, out, total)
    if written != total:  # pragma: no cover - a C-side invariant
        raise _mismatch("pack_strs(size)")
    NATIVE_PACKS += 1
    result = out.raw
    if _guard_due() and result != py_pack_strs(encoded):
        raise _mismatch("pack_strs")
    return result


def unpack_strs(b: bytes, p: int, n: int) -> Tuple[List[str], int]:
    """Parse ``n`` packed strings from ``b`` at ``p``; returns (strings,
    new position)."""
    global NATIVE_UNPACKS
    from .gen import CodecError

    if n > len(b) - p:  # each string costs at least one byte
        raise CodecError("string column count exceeds frame")
    if n == 0 or not isinstance(b, bytes):
        return py_split_strs(b, p, n)
    lib = _get_lib()
    lens = (ctypes.c_int32 * n)()
    offs = (ctypes.c_int32 * n)()
    # The whole frame and a start offset cross the ABI (ctypes passes the
    # bytes object's buffer, no copy).
    end = lib.ncodec_split_strs(b, p, len(b), n, lens, offs)
    if end < 0:
        raise CodecError("malformed string column")
    NATIVE_UNPACKS += 1
    out = [b[o:o + ln].decode("utf-8") for o, ln in zip(offs, lens)]
    if _guard_due():
        twin, twin_end = py_split_strs(b, p, n)
        if twin != out or twin_end != end:
            raise _mismatch("unpack_strs")
    return out, end
