"""Host↔device transfer packing (``nomad_tpu/ops/xfer.py``).

Every batch crosses the host↔device boundary as ONE uint8 buffer each
way, with a deterministic layout both sides compute independently:

- host→device: :func:`pack_host` (numpy) → one copy → :func:`unpack_device`
  (slices + dtype views of the device tensor);
- device→host: :func:`pack_device` (torch) → one copy → :func:`unpack_host`
  (numpy views).

:func:`layout` is the single source of truth for offsets, identical to
the reference's, so the packed bytes are too.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

# dtype tag → numpy dtype
_DTYPES = {
    "i32": np.int32,
    "u32": np.uint32,
    "f32": np.float32,
    "i16": np.int16,
    "u16": np.uint16,
    "i8": np.int8,
    "u8": np.uint8,
    "b1": np.bool_,
}

# dtype tag → the torch dtype a device-side array of that tag is viewed
# as.  torch's unsigned 16/32-bit types support few operations, so u16
# and u32 arrays are read back as their signed twins and widened (see
# unpack_device).
_TORCH_VIEW = {
    "i32": torch.int32,
    "u32": torch.int32,
    "f32": torch.float32,
    "i16": torch.int16,
    "u16": torch.int16,
    "i8": torch.int8,
    "u8": torch.uint8,
    "b1": torch.uint8,
}

# (name, tag, shape, byte offset)
Meta = Tuple[Tuple[str, str, Tuple[int, ...], int], ...]


def _tag(dtype) -> str:
    dtype = np.dtype(dtype)
    for tag, dt in _DTYPES.items():
        if dtype == dt:
            return tag
    raise TypeError(f"unsupported pack dtype {dtype}")


def _nbytes(tag: str, shape: Tuple[int, ...]) -> int:
    nelem = int(np.prod(shape, dtype=np.int64)) if shape else 1
    return nelem * np.dtype(_DTYPES[tag]).itemsize


def layout(items: Dict[str, Tuple[str, Tuple[int, ...]]]) -> Meta:
    """Deterministic buffer layout: sorted by name, 4-byte aligned."""
    metas: List[Tuple[str, str, Tuple[int, ...], int]] = []
    off = 0
    for name in sorted(items):
        tag, shape = items[name]
        metas.append((name, tag, tuple(shape), off))
        nbytes = _nbytes(tag, shape)
        off += nbytes + ((-nbytes) % 4)
    return tuple(metas)


def total_bytes(meta: Meta) -> int:
    if not meta:
        return 0
    name, tag, shape, off = meta[-1]
    nbytes = _nbytes(tag, shape)
    return off + nbytes + ((-nbytes) % 4)


def pack_host(arrays: Dict[str, np.ndarray]) -> Tuple[np.ndarray, Meta]:
    """Concatenate host arrays into one uint8 buffer + layout meta."""
    meta = layout({n: (_tag(a.dtype), tuple(a.shape))
                   for n, a in arrays.items()})
    buf = np.zeros(total_bytes(meta), dtype=np.uint8)
    for name, tag, shape, off in meta:
        a = np.ascontiguousarray(arrays[name])
        raw = a.view(np.uint8).reshape(-1)
        buf[off:off + raw.size] = raw
    return buf, meta


def pack_host_sharded(arrays: Dict[str, np.ndarray], shards: int,
                      replicate: Tuple[str, ...] = ()
                      ) -> Tuple[np.ndarray, Meta]:
    """Per-shard packing for the node mesh (reference ``xfer.py:94``):
    every array is cut into ``shards`` equal slices along its leading
    axis -- except the ``replicate`` names, copied whole into every
    shard -- and each slice set packs into one uint8 row of the returned
    ``[shards, B]`` buffer.  All rows share one layout, so the one meta
    describes every shard.  Raises ``ValueError`` when a sliced array's
    leading axis does not divide into ``shards`` (it would be cut into
    wrong slices)."""
    for name, arr in arrays.items():
        if name not in replicate and arr.shape[0] % shards:
            raise ValueError(
                f"pack_host_sharded: array {name!r} leading axis "
                f"{arr.shape[0]} not divisible by {shards} shards")
    rows: List[np.ndarray] = []
    meta: Meta = ()
    for s_i in range(shards):
        sl: Dict[str, np.ndarray] = {}
        for name, arr in arrays.items():
            if name in replicate:
                sl[name] = arr
            else:
                n_l = arr.shape[0] // shards
                sl[name] = arr[s_i * n_l:(s_i + 1) * n_l]
        buf, meta = pack_host(sl)
        rows.append(buf)
    return np.stack(rows), meta


def unpack_host(buf: np.ndarray, meta: Meta) -> Dict[str, np.ndarray]:
    """numpy-view unpack of a fetched :func:`pack_device` buffer."""
    out: Dict[str, np.ndarray] = {}
    for name, tag, shape, off in meta:
        np_dtype = _DTYPES[tag]
        raw = buf[off:off + _nbytes(tag, shape)]
        if np_dtype == np.bool_:
            out[name] = raw.view(np.uint8).astype(bool).reshape(shape)
        else:
            out[name] = raw.view(np_dtype).reshape(shape)
    return out


def unpack_device(buf: torch.Tensor, meta: Meta) -> Dict[str, torch.Tensor]:
    """Slice each array out of the packed device buffer.

    Every array is materialized with ``clone()``: the placement loop then
    reads fresh, aligned allocations (the score kernel loads ``[N, 4]``
    rows as 16-byte vectors) instead of views at 4-byte offsets.  u16 and
    u32 arrays come back widened to int32 and int64 with their unsigned
    values."""
    out: Dict[str, torch.Tensor] = {}
    for name, tag, shape, off in meta:
        raw = buf[off:off + _nbytes(tag, shape)]
        arr = raw.view(_TORCH_VIEW[tag]).reshape(shape)
        if tag == "b1":
            arr = arr != 0
        elif tag == "u16":
            arr = arr.to(torch.int32) & 0xFFFF
        elif tag == "u32":
            arr = arr.to(torch.int64) & 0xFFFFFFFF
        out[name] = arr.clone()
    return out


def pack_device(arrays: Dict[str, Tuple[str, torch.Tensor]]
                ) -> Tuple[torch.Tensor, Meta]:
    """Pack ``{name: (tag, tensor)}`` into one uint8 device buffer.

    The tag names the wire dtype.  A ``"u16"`` or ``"u32"`` array is
    passed as any integer tensor and written as the low two or four bytes
    of each value (two's complement wrap, as numpy's ``astype`` does);
    every other tag must match the tensor's dtype."""
    meta = layout({n: (tag, tuple(t.shape))
                   for n, (tag, t) in arrays.items()})
    chunks: List[torch.Tensor] = []
    for name, tag, shape, off in meta:
        t = arrays[name][1].contiguous()
        if tag in ("u16", "u32"):
            width = _nbytes(tag, ())
            raw = t.to(torch.int64).view(torch.uint8).reshape(-1, 8)[:, :width]
        elif tag == "b1":
            raw = t.to(torch.uint8)
        else:
            if t.dtype != _TORCH_VIEW[tag]:
                raise TypeError(f"{name}: tag {tag} does not match {t.dtype}")
            raw = t.view(torch.uint8)
        raw = raw.reshape(-1)
        pad = (-raw.numel()) % 4
        if pad:
            raw = torch.cat([raw, raw.new_zeros(pad)])
        chunks.append(raw)
    buf = (torch.cat(chunks) if chunks
           else torch.zeros(0, dtype=torch.uint8))
    return buf, meta
