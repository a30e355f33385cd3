"""Generated per-type binary encoders and decoders (a copy of
``nomad_tpu/codec/gen.py`` over the port's structs).

The reflection is done once per type: a dataclass's type hints are
compiled into straight-line Python source (field loads, varints, packed
doubles, length-prefixed strings) and ``exec``'d into an encoder and
decoder pair cached by type id (``_build``).  Encoding touches no
``fields()`` and no ``get_type_hints``.

Layout (little-endian throughout):

- int    zigzag varint (int64 range)
- float  8-byte IEEE double
- bool   1 byte
- str    varint byte length + utf8
- bytes  varint length + raw
- Optional[X] / a dataclass-typed field: 1 presence byte, then X
- List[X]     varint count + elements
- List[str]   1 subtag (0 packed / 1 lazy uuids / 2 lazy names) + the
              packed varint-prefixed strings (``codec/native.py``) or the
              lazy column's prefix and count, so an AllocSlab's formulaic
              columns stay a few dozen bytes in the log and the snapshot
- Dict[str,X] varint count + (str, X) pairs
- Any         the tagged value tree (``_val``/``_dval``), which also
              carries whole log payloads and snapshot documents: dicts,
              lists, scalars, bytes and any registered dataclass (tag 9 +
              type id + flat body)

A value the generated code cannot encode (a type outside the registry)
raises :class:`CodecError`; the port has no second codec to fall back
to, so the caller sees the error.
"""
from __future__ import annotations

import dataclasses
import struct
import typing
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..structs.structs import LazyNames, LazyUuids, _LazyStrs
from . import native
from .schema import FINGERPRINT, MAGIC, TYPE_IDS, TYPES_BY_ID, VERSION


class CodecError(ValueError):
    """Encode: the value does not fit the generated layout.  Decode: the
    frame is truncated, oversized, of another schema or structurally
    invalid; never silently misread."""


_PD = struct.Struct("<d")
_pd = _PD.pack
_ud = _PD.unpack_from


# -- primitive helpers (bound into generated code) --------------------------


def _uv(w: bytearray, n: int) -> None:
    while n > 0x7F:
        w.append(0x80 | (n & 0x7F))
        n >>= 7
    w.append(n)


_INT_BOUND = 1 << 63


def _zz(w: bytearray, v: int) -> None:
    # int64 range: an unbounded int fails at encode, never producing a
    # frame the decoder's varint cap would reject after it is persisted.
    if v >= _INT_BOUND or v < -_INT_BOUND:
        raise CodecError(f"int out of 64-bit codec range: {v}")
    if v >= 0:
        _uv(w, v << 1)
    else:
        _uv(w, ((-v) << 1) - 1)


def _duv(b: bytes, p: int) -> Tuple[int, int]:
    n = 0
    shift = 0
    ln = len(b)
    while True:
        if p >= ln:
            raise CodecError("truncated varint")
        c = b[p]
        p += 1
        n |= (c & 0x7F) << shift
        if c < 0x80:
            return n, p
        shift += 7
        if shift > 70:
            raise CodecError("varint overflow")


def _dzz(b: bytes, p: int) -> Tuple[int, int]:
    n, p = _duv(b, p)
    return ((n >> 1) if not (n & 1) else -((n + 1) >> 1)), p


def _dstr(b: bytes, p: int) -> Tuple[str, int]:
    n, p = _duv(b, p)
    e = p + n
    if e > len(b):
        raise CodecError("truncated string")
    return b[p:e].decode("utf-8"), e


def _dbytes(b: bytes, p: int) -> Tuple[bytes, int]:
    n, p = _duv(b, p)
    e = p + n
    if e > len(b):
        raise CodecError("truncated bytes")
    return bytes(b[p:e]), e


def _dby(b: bytes, p: int) -> int:
    if p >= len(b):
        raise CodecError("truncated byte")
    return b[p]


def _dd(b: bytes, p: int) -> Tuple[float, int]:
    if p + 8 > len(b):
        raise CodecError("truncated float")
    return _ud(b, p)[0], p + 8


# -- string columns (native-accelerated, AllocSlab lazy specs preserved) ----


def _strs(w: bytearray, col) -> None:
    if type(col) is LazyUuids:
        w.append(1)
        pb = col.prefix.encode("utf-8")
        _uv(w, len(pb))
        w += pb
        _uv(w, col.n)
        return
    if type(col) is LazyNames:
        w.append(2)
        pb = col.prefix.encode("utf-8")
        _uv(w, len(pb))
        w += pb
        _uv(w, col.n)
        return
    if isinstance(col, _LazyStrs):  # another lazy subclass: materialize
        col = list(col)
    w.append(0)
    _uv(w, len(col))
    w += native.pack_strs(col)


def _dstrs(b: bytes, p: int):
    sub = _dby(b, p)
    p += 1
    if sub == 0:
        n, p = _duv(b, p)
        return native.unpack_strs(b, p, n)
    if sub in (1, 2):
        prefix, p = _dstr(b, p)
        n, p = _duv(b, p)
        cls = LazyUuids if sub == 1 else LazyNames
        return cls(n, prefix), p
    raise CodecError(f"bad string-column subtag {sub}")


# -- per-type codegen --------------------------------------------------------

_ENCODERS: List[Optional[Callable]] = [None] * len(TYPES_BY_ID)
_DECODERS: List[Optional[Callable]] = [None] * len(TYPES_BY_ID)


def _classify(hint) -> tuple:
    """Map one type hint onto an emission plan."""
    if hint is int:
        return ("int",)
    if hint is float:
        return ("float",)
    if hint is bool:
        return ("bool",)
    if hint is str:
        return ("str",)
    if hint is bytes:
        return ("bytes",)
    origin = typing.get_origin(hint)
    if origin is typing.Union:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        if len(args) == 1:
            return ("opt", _classify(args[0]))
        return ("any",)
    if origin in (list, tuple):
        args = typing.get_args(hint)
        inner = args[0] if args else Any
        if inner is str:
            return ("strlist",)
        return ("list", _classify(inner))
    if origin is dict:
        args = typing.get_args(hint)
        if len(args) == 2 and args[0] is str:
            return ("dict", _classify(args[1]))
        return ("any",)
    if isinstance(hint, type) and dataclasses.is_dataclass(hint):
        tid = TYPE_IDS.get(hint)
        if tid is not None:
            return ("struct", tid)
    return ("any",)


class _Src:
    def __init__(self) -> None:
        self.lines: List[str] = []
        self.n = 0

    def emit(self, indent: int, line: str) -> None:
        self.lines.append("    " * indent + line)

    def tmp(self) -> str:
        self.n += 1
        return f"t{self.n}"


def _emit_enc(src: _Src, ind: int, expr: str, plan: tuple) -> None:
    kind = plan[0]
    if kind == "int":
        src.emit(ind, f"_zz(w, {expr})")
    elif kind == "float":
        src.emit(ind, f"w += _pd({expr})")
    elif kind == "bool":
        src.emit(ind, f"w.append(1 if {expr} else 0)")
    elif kind == "str":
        t = src.tmp()
        src.emit(ind, f"{t} = {expr}.encode('utf-8')")
        src.emit(ind, f"_uv(w, len({t})); w += {t}")
    elif kind == "bytes":
        t = src.tmp()
        src.emit(ind, f"{t} = {expr}")
        src.emit(ind, f"_uv(w, len({t})); w += {t}")
    elif kind == "opt":
        t = src.tmp()
        src.emit(ind, f"{t} = {expr}")
        src.emit(ind, f"if {t} is None:")
        src.emit(ind + 1, "w.append(0)")
        src.emit(ind, "else:")
        src.emit(ind + 1, "w.append(1)")
        _emit_enc(src, ind + 1, t, plan[1])
    elif kind == "struct":
        t = src.tmp()
        src.emit(ind, f"{t} = {expr}")
        src.emit(ind, f"if {t} is None:")
        src.emit(ind + 1, "w.append(0)")
        src.emit(ind, "else:")
        src.emit(ind + 1, f"w.append(1); _E[{plan[1]}]({t}, w)")
    elif kind == "strlist":
        src.emit(ind, f"_strs(w, {expr})")
    elif kind == "list":
        t, u = src.tmp(), src.tmp()
        src.emit(ind, f"{t} = {expr}")
        src.emit(ind, f"_uv(w, len({t}))")
        src.emit(ind, f"for {u} in {t}:")
        _emit_enc(src, ind + 1, u, plan[1])
    elif kind == "dict":
        t, k, u, kb = src.tmp(), src.tmp(), src.tmp(), src.tmp()
        src.emit(ind, f"{t} = {expr}")
        src.emit(ind, f"_uv(w, len({t}))")
        src.emit(ind, f"for {k}, {u} in {t}.items():")
        src.emit(ind + 1, f"{kb} = {k}.encode('utf-8')")
        src.emit(ind + 1, f"_uv(w, len({kb})); w += {kb}")
        _emit_enc(src, ind + 1, u, plan[1])
    else:  # any
        src.emit(ind, f"_val(w, {expr})")


def _emit_dec(src: _Src, ind: int, out: str, plan: tuple) -> None:
    kind = plan[0]
    if kind == "int":
        src.emit(ind, f"{out}, p = _dzz(b, p)")
    elif kind == "float":
        src.emit(ind, f"{out}, p = _dd(b, p)")
    elif kind == "bool":
        src.emit(ind, f"{out} = _dby(b, p) != 0; p += 1")
    elif kind == "str":
        src.emit(ind, f"{out}, p = _dstr(b, p)")
    elif kind == "bytes":
        src.emit(ind, f"{out}, p = _dbytes(b, p)")
    elif kind == "opt":
        src.emit(ind, f"if _dby(b, p) == 0:")
        src.emit(ind + 1, f"{out} = None; p += 1")
        src.emit(ind, "else:")
        src.emit(ind + 1, "p += 1")
        _emit_dec(src, ind + 1, out, plan[1])
    elif kind == "struct":
        src.emit(ind, f"if _dby(b, p) == 0:")
        src.emit(ind + 1, f"{out} = None; p += 1")
        src.emit(ind, "else:")
        src.emit(ind + 1, "p += 1")
        src.emit(ind + 1, f"{out}, p = _D[{plan[1]}](b, p)")
    elif kind == "strlist":
        src.emit(ind, f"{out}, p = _dstrs(b, p)")
    elif kind == "list":
        n, u = src.tmp(), src.tmp()
        src.emit(ind, f"{n}, p = _duv(b, p)")
        src.emit(ind, f"{out} = []")
        src.emit(ind, f"for _ in range({n}):")
        _emit_dec(src, ind + 1, u, plan[1])
        src.emit(ind + 1, f"{out}.append({u})")
    elif kind == "dict":
        n, k, u = src.tmp(), src.tmp(), src.tmp()
        src.emit(ind, f"{n}, p = _duv(b, p)")
        src.emit(ind, f"{out} = {{}}")
        src.emit(ind, f"for _ in range({n}):")
        src.emit(ind + 1, f"{k}, p = _dstr(b, p)")
        _emit_dec(src, ind + 1, u, plan[1])
        src.emit(ind + 1, f"{out}[{k}] = {u}")
    else:  # any
        src.emit(ind, f"{out}, p = _dval(b, p)")


def _field_plans(cls: type) -> List[Tuple[str, tuple]]:
    try:
        hints = typing.get_type_hints(cls)
    except Exception:
        hints = {}
    return [(f.name, _classify(hints.get(f.name, Any)))
            for f in dataclasses.fields(cls)]


_NAMESPACE: Dict[str, Any] = {
    "_uv": _uv, "_zz": _zz, "_pd": _pd, "_duv": _duv, "_dzz": _dzz,
    "_dstr": _dstr, "_dbytes": _dbytes, "_dby": _dby, "_dd": _dd,
    "_strs": _strs, "_dstrs": _dstrs, "_E": _ENCODERS, "_D": _DECODERS,
}


def _build(tid: int) -> None:
    cls = TYPES_BY_ID[tid]
    plans = _field_plans(cls)

    src = _Src()
    src.emit(0, f"def _enc_{tid}(v, w):")
    if not plans:
        src.emit(1, "pass")
    for fname, plan in plans:
        _emit_enc(src, 1, f"v.{fname}", plan)
    ns = dict(_NAMESPACE)
    # _val/_dval bind lazily (value codec is defined below in this
    # module; the namespace copy resolves at exec time).
    ns["_val"] = _val
    ns["_dval"] = _dval
    exec("\n".join(src.lines), ns)  # noqa: S102 — our own generated source
    _ENCODERS[tid] = ns[f"_enc_{tid}"]

    src = _Src()
    src.emit(0, f"def _dec_{tid}(b, p):")
    outs = []
    for i, (fname, plan) in enumerate(plans):
        out = f"x{i}"
        outs.append((fname, out))
        _emit_dec(src, 1, out, plan)
    src.emit(1, "o = _new(_cls)")
    pairs = ", ".join(f"{fname!r}: {out}" for fname, out in outs)
    src.emit(1, f"o.__dict__ = {{{pairs}}}")
    src.emit(1, "return o, p")
    ns = dict(_NAMESPACE)
    ns["_val"] = _val
    ns["_dval"] = _dval
    ns["_new"] = object.__new__
    ns["_cls"] = cls
    exec("\n".join(src.lines), ns)  # noqa: S102
    _DECODERS[tid] = ns[f"_dec_{tid}"]


def _enc_thunk(tid: int) -> Callable:
    def thunk(v, w):
        _build(tid)
        return _ENCODERS[tid](v, w)
    return thunk


def _dec_thunk(tid: int) -> Callable:
    def thunk(b, p):
        _build(tid)
        return _DECODERS[tid](b, p)
    return thunk


for _tid in range(len(TYPES_BY_ID)):
    _ENCODERS[_tid] = _enc_thunk(_tid)
    _DECODERS[_tid] = _dec_thunk(_tid)


# -- the tagged value tree (log payloads, snapshot documents, Any fields) ---

_T_NONE, _T_FALSE, _T_TRUE, _T_INT, _T_FLOAT = 0, 1, 2, 3, 4
_T_STR, _T_BYTES, _T_LIST, _T_DICT, _T_STRUCT = 5, 6, 7, 8, 9
_T_LAZY_UUIDS, _T_LAZY_NAMES = 10, 11


def _val(w: bytearray, v) -> None:
    t = type(v)
    if v is None:
        w.append(_T_NONE)
    elif t is bool:
        w.append(_T_TRUE if v else _T_FALSE)
    elif t is int:
        w.append(_T_INT)
        _zz(w, v)
    elif t is float:
        w.append(_T_FLOAT)
        w += _pd(v)
    elif t is str:
        w.append(_T_STR)
        b = v.encode("utf-8")
        _uv(w, len(b))
        w += b
    elif t is bytes:
        w.append(_T_BYTES)
        _uv(w, len(v))
        w += v
    elif t is list or t is tuple:
        w.append(_T_LIST)
        _uv(w, len(v))
        for x in v:
            _val(w, x)
    elif t is dict:
        w.append(_T_DICT)
        _uv(w, len(v))
        for k, x in v.items():
            _val(w, k)
            _val(w, x)
    else:
        tid = TYPE_IDS.get(t)
        if tid is not None:
            w.append(_T_STRUCT)
            _uv(w, tid)
            _ENCODERS[tid](v, w)
        elif t is LazyUuids:
            w.append(_T_LAZY_UUIDS)
            b = v.prefix.encode("utf-8")
            _uv(w, len(b))
            w += b
            _uv(w, v.n)
        elif t is LazyNames:
            w.append(_T_LAZY_NAMES)
            b = v.prefix.encode("utf-8")
            _uv(w, len(b))
            w += b
            _uv(w, v.n)
        elif isinstance(v, (bytes, bytearray, memoryview)):
            b = bytes(v)
            w.append(_T_BYTES)
            _uv(w, len(b))
            w += b
        else:
            raise CodecError(f"unencodable value type {t.__name__}")


def _dval(b: bytes, p: int):
    tag = _dby(b, p)
    p += 1
    if tag == _T_NONE:
        return None, p
    if tag == _T_FALSE:
        return False, p
    if tag == _T_TRUE:
        return True, p
    if tag == _T_INT:
        return _dzz(b, p)
    if tag == _T_FLOAT:
        return _dd(b, p)
    if tag == _T_STR:
        return _dstr(b, p)
    if tag == _T_BYTES:
        return _dbytes(b, p)
    if tag == _T_LIST:
        n, p = _duv(b, p)
        out = []
        for _ in range(n):
            x, p = _dval(b, p)
            out.append(x)
        return out, p
    if tag == _T_DICT:
        n, p = _duv(b, p)
        out = {}
        for _ in range(n):
            k, p = _dval(b, p)
            x, p = _dval(b, p)
            out[k] = x
        return out, p
    if tag == _T_STRUCT:
        tid, p = _duv(b, p)
        if not 0 <= tid < len(TYPES_BY_ID):
            raise CodecError(f"unknown struct type id {tid}")
        return _DECODERS[tid](b, p)
    if tag == _T_LAZY_UUIDS:
        prefix, p = _dstr(b, p)
        n, p = _duv(b, p)
        return LazyUuids(n, prefix), p
    if tag == _T_LAZY_NAMES:
        prefix, p = _dstr(b, p)
        n, p = _duv(b, p)
        return LazyNames(n, prefix), p
    raise CodecError(f"unknown value tag {tag}")


# -- frames ------------------------------------------------------------------

# Header: magic + version + the 8-byte schema fingerprint.  Log entries
# and snapshot documents are decoded with nothing but the bytes (restart
# replay, restore), so the fingerprint in every frame makes cross-schema
# misparsing impossible: a frame written by a build with other struct
# fields fails with a CodecError naming both fingerprints, never as a
# silently shifted layout.
_HEADER = bytes((MAGIC, VERSION)) + FINGERPRINT
_BODY_START = len(_HEADER)

# Decode failures that indicate a malformed frame rather than a codec
# bug; the frame-level decode translates them all into CodecError.
_DECODE_ERRORS = (IndexError, OverflowError, UnicodeDecodeError,
                  struct.error, MemoryError)


def encode_frame(obj) -> bytes:
    """MAGIC + VERSION + fingerprint + tagged value.  Raises CodecError
    when the tree holds something outside the generated schema."""
    w = bytearray(_HEADER)
    try:
        _val(w, obj)
    except CodecError:
        raise
    except (TypeError, AttributeError, ValueError) as e:
        # Schema drift or a foreign object.
        raise CodecError(f"unencodable value: {e}") from e
    return bytes(w)


def is_frame(blob: bytes) -> bool:
    return len(blob) >= 2 and blob[0] == MAGIC


def decode_frame(blob: bytes):
    """Strict inverse of :func:`encode_frame`: rejects bad magic,
    unknown versions, schema-fingerprint mismatches, truncation, and
    trailing garbage."""
    if len(blob) < 2 or blob[0] != MAGIC:
        raise CodecError("bad frame magic")
    if blob[1] != VERSION:
        raise CodecError(f"unsupported codec version {blob[1]}")
    if len(blob) < _BODY_START:
        raise CodecError("truncated frame header")
    if blob[2:_BODY_START] != FINGERPRINT:
        raise CodecError(
            f"schema fingerprint mismatch: the frame's is "
            f"{bytes(blob[2:_BODY_START]).hex()}, this build's is "
            f"{FINGERPRINT.hex()} (it was written by a build with other "
            f"struct fields)")
    try:
        v, p = _dval(blob, _BODY_START)
    except CodecError:
        raise
    except _DECODE_ERRORS as e:
        raise CodecError(f"malformed frame: {e}") from e
    if p != len(blob):
        raise CodecError(f"trailing bytes after frame ({len(blob) - p})")
    return v
