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
``stats()`` reads the counts and ``stats_delta`` their change since a
``stats()`` taken earlier (the load harness's per-run split).  Each frame's
seconds also go into the ``codec.<subsystem>.encode_seconds``/
``decode_seconds`` histograms of the process-wide ``TELEMETRY`` sink,
which ``merge_metrics`` merges into a server's ``Status.Metrics``.  A
value outside the schema raises ``CodecError`` at encode in every
subsystem: the RPC layer has no msgpack channel to fall back to.
"""
from __future__ import annotations

import time
from typing import Dict

from ..utils.telemetry import InmemSink, Telemetry
from . import native  # noqa: F401  (re-exported for its guard counters)
from .gen import CodecError, decode_frame, encode_frame, is_frame
from .schema import FINGERPRINT, MAGIC, VERSION

__all__ = ["CodecError", "MAGIC", "VERSION", "FINGERPRINT", "encode",
           "decode", "is_frame", "stats", "stats_delta", "merge_metrics",
           "reset", "native", "TELEMETRY"]

_SUBSYSTEMS = ("raft", "snapshot", "rpc", "other")

# One long interval: codec percentiles must survive a whole run, as the
# load harness pins its server sink's interval.
TELEMETRY = Telemetry(sink=InmemSink(interval=3600.0), prefix="nomad")


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
    dt = time.perf_counter() - t0
    c["encodes"] += 1
    c["encode_seconds"] += dt
    c["encode_bytes"] += len(blob)
    TELEMETRY.add_sample(f"codec.{subsystem}.encode_seconds", dt)
    return blob


def decode(blob: bytes, subsystem: str = "other"):
    """Strict decode of one codec frame (see ``gen.decode_frame``)."""
    c = _COUNTERS.get(subsystem) or _COUNTERS["other"]
    t0 = time.perf_counter()
    obj = decode_frame(blob)
    dt = time.perf_counter() - t0
    c["decodes"] += 1
    c["decode_seconds"] += dt
    c["decode_bytes"] += len(blob)
    TELEMETRY.add_sample(f"codec.{subsystem}.decode_seconds", dt)
    return obj


def stats() -> Dict[str, Dict[str, float]]:
    """Cumulative frames, bytes and seconds per subsystem."""
    return {sub: dict(vals) for sub, vals in _COUNTERS.items()}


def stats_delta(before: Dict[str, Dict[str, float]]
                ) -> Dict[str, Dict[str, float]]:
    """The counts' change since ``before`` (an earlier ``stats()``)."""
    now = stats()
    return {sub: {k: round(v - before.get(sub, {}).get(k, 0), 6)
                  for k, v in vals.items()}
            for sub, vals in now.items()}


def metrics_latest() -> Dict:
    """The codec sink's newest interval, ``Status.Metrics``-shaped."""
    return TELEMETRY.sink.latest()


def merge_metrics(latest: Dict) -> Dict:
    """Merge the codec histograms and totals into a server sink's
    ``latest()`` summary (the ``Status.Metrics`` bridge: the codec
    accounts process-wide, the servers render per sink)."""
    mine = metrics_latest()
    for section in ("Samples", "Counters", "Gauges",
                    "CounterTotals", "SampleTotals"):
        vals = mine.get(section)
        if vals:
            latest.setdefault(section, {}).update(vals)
    return latest


def reset() -> None:
    """Zero the counters and the histograms (tests and the drill)."""
    global _COUNTERS
    _COUNTERS = _fresh_counters()
    TELEMETRY.sink = InmemSink(interval=3600.0)
    native.reset_counters()
