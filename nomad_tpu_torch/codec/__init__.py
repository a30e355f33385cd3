"""The struct codec: one generated binary format for the durable log's
entries and the FSM snapshot (a copy of ``nomad_tpu/codec/`` without the
kill switch, the msgpack fallback and the RPC accounting; the port has
one codec).

Per-type encoders and decoders are generated from the dataclass schemas
once (``codec/gen.py``) and emit flat length-prefixed layouts; every
frame starts with the ``MAGIC`` byte, the ``VERSION`` and the schema
``FINGERPRINT`` (``codec/schema.py``), so a frame of another struct
schema fails to decode instead of being misread.  String columns drop to
C++ (``native/codec.cc`` through ``codec/native.py``) with a pure-Python
twin behind a differential guard.

``encode``/``decode`` count frames, bytes and seconds per subsystem
(``raft``: log entries and the replicated log's messages' entries,
``snapshot``: snapshot documents, ``rpc``: the RPC layer's frames);
``stats()`` reads the counts.  A value outside the schema raises
``CodecError`` at encode in every subsystem: the RPC layer has no
msgpack channel to fall back to.
"""
from __future__ import annotations

import time
from typing import Dict

from . import native  # noqa: F401  (re-exported for its guard counters)
from .gen import CodecError, decode_frame, encode_frame, is_frame
from .schema import FINGERPRINT, MAGIC, VERSION

__all__ = ["CodecError", "MAGIC", "VERSION", "FINGERPRINT", "encode",
           "decode", "is_frame", "stats", "reset", "native"]

_SUBSYSTEMS = ("raft", "snapshot", "rpc", "other")


def _fresh_counters() -> Dict[str, Dict[str, float]]:
    return {sub: {"encodes": 0, "decodes": 0, "encode_seconds": 0.0,
                  "decode_seconds": 0.0, "encode_bytes": 0,
                  "decode_bytes": 0}
            for sub in _SUBSYSTEMS}


_COUNTERS = _fresh_counters()


def encode(obj, subsystem: str = "other") -> bytes:
    """One codec frame (header + value tree).  Raises CodecError when the
    value holds something outside the schema."""
    c = _COUNTERS.get(subsystem) or _COUNTERS["other"]
    t0 = time.perf_counter()
    blob = encode_frame(obj)
    c["encodes"] += 1
    c["encode_seconds"] += time.perf_counter() - t0
    c["encode_bytes"] += len(blob)
    return blob


def decode(blob: bytes, subsystem: str = "other"):
    """Strict decode of one codec frame (see ``gen.decode_frame``)."""
    c = _COUNTERS.get(subsystem) or _COUNTERS["other"]
    t0 = time.perf_counter()
    obj = decode_frame(blob)
    c["decodes"] += 1
    c["decode_seconds"] += time.perf_counter() - t0
    c["decode_bytes"] += len(blob)
    return obj


def stats() -> Dict[str, Dict[str, float]]:
    """Cumulative frames, bytes and seconds per subsystem."""
    return {sub: dict(vals) for sub, vals in _COUNTERS.items()}


def reset() -> None:
    """Zero the counters (tests and the drill)."""
    global _COUNTERS
    _COUNTERS = _fresh_counters()
    native.reset_counters()
