"""Fixed-size bitmap used for port accounting (``nomad_tpu/structs/bitmap.py``;
reference nomad/structs/bitmap.go:9-69), backed by a numpy uint8 array."""
from __future__ import annotations

from typing import List

import numpy as np


class Bitmap:
    """A fixed-size bitmap over ``size`` bits."""

    __slots__ = ("size", "_bits")

    def __init__(self, size: int):
        if size == 0:
            raise ValueError("bitmap must be positive size")
        if size % 8 != 0:
            raise ValueError("bitmap must be byte aligned")
        self.size = size
        self._bits = np.zeros(size >> 3, dtype=np.uint8)

    def copy(self) -> "Bitmap":
        b = Bitmap(self.size)
        b._bits[:] = self._bits
        return b

    def set(self, idx: int) -> None:
        self._bits[idx >> 3] |= np.uint8(1 << (idx & 7))

    def check(self, idx: int) -> bool:
        return bool(self._bits[idx >> 3] & (1 << (idx & 7)))

    def indexes_in_range(self, value: bool, frm: int, to: int) -> List[int]:
        """All indexes in [frm, to] whose bit equals ``value``
        (reference: bitmap.go:52 IndexesInRange)."""
        hi = min(to + 1, self.size)
        if frm >= hi:
            return []
        bits = np.unpackbits(self._bits, bitorder="little")[frm:hi]
        want = 1 if value else 0
        return (np.nonzero(bits == want)[0] + frm).tolist()
