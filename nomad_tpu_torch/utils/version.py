"""Semantic-ish version parsing and constraint matching
(``nomad_tpu/utils/version.py``).

Replicates the behavior of hashicorp/go-version as used by the scheduler's
``version`` constraint operand (reference: scheduler/feasible.go:487
checkVersionConstraint): versions like ``1.2.3``, ``0.7.1-rc1``; constraint
strings like ``>= 0.6.0, < 0.8``.
"""
from __future__ import annotations

import re
from functools import total_ordering
from typing import List, Optional, Tuple

_VERSION_RE = re.compile(
    r"^v?(\d+(?:\.\d+)*)" r"(?:-([0-9A-Za-z.-]+))?" r"(?:\+([0-9A-Za-z.-]+))?$"
)


@total_ordering
class Version:
    def __init__(self, text: str):
        m = _VERSION_RE.match(text.strip())
        if not m:
            raise ValueError(f"malformed version: {text!r}")
        self.segments: Tuple[int, ...] = tuple(int(p) for p in m.group(1).split("."))
        self.prerelease: str = m.group(2) or ""
        self.metadata: str = m.group(3) or ""

    def _padded(self, n: int = 3) -> Tuple[int, ...]:
        segs = self.segments
        return segs + (0,) * (n - len(segs)) if len(segs) < n else segs

    def __eq__(self, other) -> bool:
        if not isinstance(other, Version):
            return NotImplemented
        n = max(len(self.segments), len(other.segments), 3)
        return (self._padded(n), self.prerelease) == (other._padded(n), other.prerelease)

    def __lt__(self, other) -> bool:
        if not isinstance(other, Version):
            return NotImplemented
        n = max(len(self.segments), len(other.segments), 3)
        if self._padded(n) != other._padded(n):
            return self._padded(n) < other._padded(n)
        # A prerelease sorts before its release.
        if (self.prerelease == "") != (other.prerelease == ""):
            return self.prerelease != ""
        return self.prerelease < other.prerelease

    def __repr__(self) -> str:
        return f"Version({'.'.join(map(str, self.segments))}{'-' + self.prerelease if self.prerelease else ''})"


_CONSTRAINT_RE = re.compile(r"^\s*(>=|<=|!=|>|<|=|~>)?\s*(.+?)\s*$")


class Constraint:
    def __init__(self, text: str):
        m = _CONSTRAINT_RE.match(text)
        if not m or not m.group(2):
            raise ValueError(f"malformed constraint: {text!r}")
        self.op = m.group(1) or "="
        self.version = Version(m.group(2))

    def check(self, v: Version) -> bool:
        if self.op == "=":
            return v == self.version
        if self.op == "!=":
            return v != self.version
        if self.op == ">":
            return v > self.version
        if self.op == ">=":
            return v >= self.version
        if self.op == "<":
            return v < self.version
        if self.op == "<=":
            return v <= self.version
        if self.op == "~>":
            # pessimistic operator: >= x.y.z and < x.(y+1) style bump of the
            # second-to-last specified segment
            if v < self.version:
                return False
            segs = list(self.version.segments)
            if len(segs) == 1:
                upper = [segs[0] + 1]
            else:
                upper = segs[:-2] + [segs[-2] + 1, 0]
            bound = Version(".".join(map(str, upper)))
            return v < bound
        return False


class Constraints:
    """A comma-separated conjunction of constraints."""

    def __init__(self, text: str):
        parts = [p for p in (x.strip() for x in text.split(",")) if p]
        if not parts:
            raise ValueError("empty constraint")
        self.constraints: List[Constraint] = [Constraint(p) for p in parts]

    def check(self, v: Version) -> bool:
        return all(c.check(v) for c in self.constraints)


def parse_version(text: str) -> Optional[Version]:
    try:
        return Version(text)
    except ValueError:
        return None


def parse_constraints(text: str) -> Optional[Constraints]:
    try:
        return Constraints(text)
    except ValueError:
        return None
