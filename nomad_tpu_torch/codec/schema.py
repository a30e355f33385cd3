"""Type registry and schema fingerprint of the struct codec (a copy of
``nomad_tpu/codec/schema.py`` over the port's own structs).

Every decodable type gets a stable numeric id, its position in the
sorted registry, and the whole registry folds into one 8-byte
fingerprint that every frame carries after its magic and version.  The
fingerprint hashes the port's own struct fields, which differ from the
reference's (the port's structs lack fields the reference has), so a
port frame and a reference frame never decode as each other: the
decoder refuses a frame whose fingerprint is not this process's with a
``CodecError`` that names both.  A WAL or snapshot written by one
version of the port's structs therefore fails to decode under another;
it is never misread.  The registry is also the whitelist: a frame can
only produce registered data types, never code.
"""
from __future__ import annotations

import dataclasses
import hashlib
import typing
from typing import Dict, List, Tuple

from ..state.state_store import PeriodicLaunch, VaultAccessor
from ..structs import structs as _structs

#: Frame magic (0xC1: the first byte of every struct-codec frame).
MAGIC = 0xC1

#: Flat-layout schema version carried in every frame after the magic.
VERSION = 1


def _registry() -> List[Tuple[str, type]]:
    types = {
        name: obj
        for name, obj in vars(_structs).items()
        if isinstance(obj, type) and dataclasses.is_dataclass(obj)
    }
    types["PeriodicLaunch"] = PeriodicLaunch
    types["VaultAccessor"] = VaultAccessor
    return sorted(types.items())


_REGISTRY = _registry()

#: type -> id and id -> type (ids are positions in the sorted registry).
TYPE_IDS: Dict[type, int] = {cls: i for i, (_, cls) in enumerate(_REGISTRY)}
TYPES_BY_ID: List[type] = [cls for _, cls in _REGISTRY]


def schema_fingerprint() -> bytes:
    """8-byte digest of every registered type's name, fields and type
    hints: two builds agree on the flat layouts iff their fingerprints
    match."""
    h = hashlib.sha256()
    h.update(bytes([VERSION]))
    for name, cls in _REGISTRY:
        h.update(name.encode())
        try:
            hints = typing.get_type_hints(cls)
        except Exception:
            hints = {}
        for f in dataclasses.fields(cls):
            h.update(f.name.encode())
            h.update(repr(hints.get(f.name, "?")).encode())
    return h.digest()[:8]


FINGERPRINT = schema_fingerprint()
