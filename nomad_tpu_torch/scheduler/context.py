"""The part of the evaluation context that constraint checks read
(``nomad_tpu/scheduler/context.py:22-62``): the per-evaluation caches of
parsed version constraints and compiled regular expressions."""
from __future__ import annotations

import re
from typing import Dict, Optional

from ..utils import version as goversion


class EvalCache:
    """Regex and version-constraint caches (context.go:46-62)."""

    def __init__(self) -> None:
        self.re_cache: Dict[str, Optional[re.Pattern]] = {}
        self.constraint_cache: Dict[str, Optional[goversion.Constraints]] = {}


class EvalContext:
    """Holds the caches of one evaluation; the batch encoder makes one per
    batch, as the reference's encoder does."""

    def __init__(self) -> None:
        self.cache = EvalCache()
