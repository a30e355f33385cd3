"""Wire codec: dataclasses <-> Go-style CamelCase JSON objects (a copy of
``nomad_tpu/api/codec.py``).

The reference exposes its API as CamelCase JSON of the api/ package structs
(api/jobs.go etc.) encoded by encoding/json.  Here one reflection codec
serves every struct: encode walks dataclass fields emitting
``{GoName: value}``; decode resolves typing hints (Optional/List/Dict/
nested dataclasses) and accepts both CamelCase and snake_case keys.

Durations are plain float seconds on the wire (the reference emits Go
nanosecond ints; seconds are this build's convention, documented in the
SDK).  ``bytes`` round-trip as base64 strings, matching encoding/json.
"""

from __future__ import annotations

import base64
import dataclasses
import typing
from typing import Any, Dict, Optional, Type

from ..utils.names import go_name

_HINTS_CACHE: Dict[type, Dict[str, Any]] = {}
_KEYMAP_CACHE: Dict[type, Dict[str, str]] = {}


def _hints(cls: type) -> Dict[str, Any]:
    h = _HINTS_CACHE.get(cls)
    if h is None:
        h = typing.get_type_hints(cls)
        _HINTS_CACHE[cls] = h
    return h


def _keymap(cls: type) -> Dict[str, str]:
    """wire key (CamelCase or snake) -> dataclass field name."""
    m = _KEYMAP_CACHE.get(cls)
    if m is None:
        m = {}
        for f in dataclasses.fields(cls):
            m[go_name(f.name)] = f.name
            m[f.name] = f.name
        _KEYMAP_CACHE[cls] = m
    return m


def to_wire(v: Any) -> Any:
    """Encode any value (dataclass trees included) to JSON-ready data."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {go_name(f.name): to_wire(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, dict):
        return {k: to_wire(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [to_wire(x) for x in v]
    if isinstance(v, bytes):
        return base64.b64encode(v).decode("ascii")
    if getattr(v, "__lazy_strs__", False):
        # Lazily-generated slab columns (structs._LazyStrs) materialize
        # to plain string lists on the wire.
        return list(v)
    return v


def from_wire(typ: Any, data: Any) -> Any:
    """Decode JSON data into an instance of ``typ`` (a dataclass or a
    typing hint)."""
    if data is None:
        return None
    origin = typing.get_origin(typ)
    if origin is typing.Union:  # Optional[X] and unions
        for arg in typing.get_args(typ):
            if arg is type(None):
                continue
            return from_wire(arg, data)
        return data
    if origin in (list, tuple):
        (arg,) = typing.get_args(typ) or (Any,)
        return [from_wire(arg, x) for x in data]
    if origin is dict:
        args = typing.get_args(typ)
        val_t = args[1] if len(args) == 2 else Any
        return {k: from_wire(val_t, v) for k, v in data.items()}
    if typ is bytes:
        if isinstance(data, str):
            return base64.b64decode(data)
        return bytes(data)
    if typ is float:
        return float(data)
    if typ is int:
        return int(data)
    if isinstance(typ, type) and dataclasses.is_dataclass(typ):
        if not isinstance(data, dict):
            raise ValueError(f"expected object for {typ.__name__}, got {data!r}")
        hints = _hints(typ)
        keymap = _keymap(typ)
        kwargs = {}
        for k, v in data.items():
            fname = keymap.get(k)
            if fname is None:
                continue  # lenient: unknown wire keys ignored (like json.Unmarshal)
            kwargs[fname] = from_wire(hints.get(fname, Any), v)
        return typ(**kwargs)
    return data


def ensure(typ: Type, data: Any) -> Any:
    """The receiver-side adapter of a body that may arrive typed (a
    struct-codec RPC) or as a CamelCase wire dict (JSON): pass through
    what is already typed, reflect-decode what is not."""
    if data is None or isinstance(data, typ):
        return data
    return from_wire(typ, data)


def ensure_list(typ: Type, seq: Any) -> list:
    return [ensure(typ, x) for x in (seq or [])]


def decode_json(typ: Optional[Type], body: bytes) -> Any:
    import json

    data = json.loads(body.decode("utf-8")) if body else None
    if typ is None or data is None:
        return data
    return from_wire(typ, data)
