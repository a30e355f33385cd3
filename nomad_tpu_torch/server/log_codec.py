"""Codec of the log's entry payloads and of the FSM snapshot's sections
(a copy of ``nomad_tpu/server/log_codec.py`` over the struct codec only).

The reference encodes with the generated struct codec and falls back to
a tagged msgpack tree for a payload outside its schema, decoding both
forever.  The port has no msgpack (its machine does not install it) and
no second format: a payload outside the schema raises ``CodecError`` at
encode, before anything reaches the log, and a blob that is not a frame
of this build's schema raises at decode.  Nothing falls back silently.
The codec's type registry (``codec/schema.py``) is the whitelist: a log
or snapshot can only produce registered data types, never code.
"""
from __future__ import annotations

from .. import codec


def encode_payload(payload: dict, subsystem: str = "raft") -> bytes:
    """One log-entry or snapshot-section blob."""
    return codec.encode(payload, subsystem)


def decode_payload(blob: bytes, subsystem: str = "raft") -> dict:
    """The payload of one blob; raises ``codec.CodecError`` for anything
    but a well-formed frame of this build's schema."""
    if not codec.is_frame(blob):
        raise codec.CodecError("not a struct-codec frame")
    return codec.decode(blob, subsystem)
