"""The port's static analysis pass: an AST lint for its own disciplines
(a copy of ``nomad_tpu/analysis/__init__.py`` with three of its four rule
families).

``python -m nomad_tpu_torch.analysis --check`` runs over the
``nomad_tpu_torch`` package and the root ``chip_smoke.py`` (tests are
exempt: they hold locks and inject faults in shapes the program must
not):

- **lock-discipline** (``lockrules``): ``with <lock>:`` regions per
  module; a blocking operation held under one fails (fsync, socket
  send and receive, subprocess, ``time.sleep``, and the torch device
  syncs: ``torch.cuda.synchronize``, ``.synchronize()``, ``.item()``,
  ``.tolist()``, ``.cpu()``), and so does a cycle in the static
  lock-order graph;
- **guard-coverage** (``guardrules``): every native twin, columnar
  mirror and resident device mirror is declared in ``ops/guards.py``
  with its guard, its reference route and what a mismatch does, and
  the declarations are true of the tree;
- **device-discipline** (``devicerules``, the reference's ``jaxrules``):
  over ``ops/`` and ``parallel/``, every host read of the card
  (``torch-host-sync``) is a sanctioned, allowlisted site, and every
  module that launches a ``csrc`` kernel calls ``note_signature``
  (``torch-note-signature``).

Not ported: the reference's ``knobrules`` (the port has no environment
knobs, ROADMAP queue 3 item 8(c)), and ``jaxrules``' donated-buffer
rule (torch donates nothing; see ``devicerules``).

Suppression is by a justified allowlist (``allowlist.txt`` beside this
file): one line per violation key with a written reason; an entry that
matches nothing fails the pass, so the file cannot rot.  Violation keys
do not move with line numbers: ``rule path::qualname::detail``.
"""
from __future__ import annotations

import ast
import fnmatch
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Violation", "SourceFile", "Allowlist", "repo_root",
    "iter_source_files", "load_tree", "run_checks", "RULE_FAMILIES",
    "expr_text",
]

RULE_FAMILIES = ("lock-discipline", "guard-coverage", "device-discipline")

#: The package the pass scans, and the root scripts beside it.
PACKAGE = "nomad_tpu_torch"
ROOT_SCRIPTS = ("chip_smoke.py",)


def expr_text(node: ast.expr) -> Optional[str]:
    """Dotted text of a Name/Attribute chain (``self._lock``,
    ``torch.cuda.synchronize``), or None for anything dynamic."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = expr_text(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


_HERE = os.path.dirname(os.path.abspath(__file__))


def repo_root() -> str:
    # nomad_tpu_torch/analysis/ -> nomad_tpu_torch/ -> the repository
    return os.path.dirname(os.path.dirname(_HERE))


@dataclass
class Violation:
    rule: str
    path: str          # relative to the root, forward slashes
    line: int
    detail: str        # stable within (rule, path)
    message: str
    qualname: str = ""

    @property
    def key(self) -> str:
        q = self.qualname or "<module>"
        return f"{self.rule} {self.path}::{q}::{self.detail}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] {self.message}"
                f"\n    key: {self.key}")


@dataclass
class SourceFile:
    path: str           # relative to the root, forward slashes
    abspath: str
    source: str
    tree: ast.Module
    lines: List[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.lines:
            self.lines = self.source.splitlines()


class Allowlist:
    """``allowlist.txt``: ``<key-pattern>  # <reason>`` lines.  The pattern
    is fnmatch-matched against violation keys; every entry must carry a
    reason and must match at least one violation (a stale entry is itself
    a violation, so a suppression cannot outlive the code it excuses)."""

    def __init__(self, path: str):
        self.path = path
        self.entries: List[Tuple[str, str, int]] = []  # pattern, reason, line
        self.used: Dict[int, int] = {}
        self.malformed: List[Tuple[int, str]] = []
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as fh:
                for lineno, raw in enumerate(fh, 1):
                    line = raw.rstrip("\n")
                    if not line.strip() or line.lstrip().startswith("#"):
                        continue
                    if "#" not in line:
                        self.malformed.append(
                            (lineno, "entry has no '# reason' part"))
                        continue
                    pattern, reason = line.split("#", 1)
                    pattern = pattern.strip()
                    reason = reason.strip()
                    if not pattern or not reason:
                        self.malformed.append(
                            (lineno, "empty pattern or empty reason"))
                        continue
                    self.entries.append((pattern, reason, lineno))

    def suppresses(self, violation: Violation) -> bool:
        hit = False
        for i, (pattern, _reason, _ln) in enumerate(self.entries):
            if (violation.key == pattern
                    or fnmatch.fnmatchcase(violation.key, pattern)):
                self.used[i] = self.used.get(i, 0) + 1
                hit = True
        return hit

    def stale_entries(self) -> List[Tuple[str, int]]:
        return [(pattern, ln)
                for i, (pattern, _r, ln) in enumerate(self.entries)
                if i not in self.used]


DEFAULT_ALLOWLIST = os.path.join(_HERE, "allowlist.txt")

EXCLUDE_DIRS = {"__pycache__", ".git", "tests", ".claude"}


def iter_source_files(root: Optional[str] = None) -> List[str]:
    """Root-relative paths of every Python source the pass scans: the
    package's and the root scripts'."""
    root = root or repo_root()
    out: List[str] = []
    pkg = os.path.join(root, PACKAGE)
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in sorted(dirnames)
                       if d not in EXCLUDE_DIRS]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.relpath(
                    os.path.join(dirpath, fn), root).replace(os.sep, "/"))
    for fn in ROOT_SCRIPTS:
        if os.path.exists(os.path.join(root, fn)):
            out.append(fn)
    return out


def load_tree(root: Optional[str] = None,
              paths: Optional[List[str]] = None) -> List[SourceFile]:
    root = root or repo_root()
    files: List[SourceFile] = []
    for rel in (paths if paths is not None else iter_source_files(root)):
        abspath = os.path.join(root, rel)
        with open(abspath, "r", encoding="utf-8") as fh:
            source = fh.read()
        files.append(SourceFile(
            path=rel, abspath=abspath, source=source,
            tree=ast.parse(source, filename=rel)))
    return files


def run_checks(root: Optional[str] = None,
               allowlist_path: Optional[str] = None,
               rules: Optional[List[str]] = None,
               ) -> Tuple[List[Violation], List[Violation]]:
    """Run every rule family; returns ``(active, suppressed)``.  Malformed
    and stale allowlist entries come back as active ``allowlist``
    violations."""
    from . import devicerules, guardrules, lockrules

    root = root or repo_root()
    if rules:
        unknown = sorted(set(rules) - set(RULE_FAMILIES))
        if unknown:
            # An unknown family must not run no rule and report "clean".
            raise ValueError(f"unknown rule family {unknown}: choose from "
                             f"{list(RULE_FAMILIES)}")
    files = load_tree(root)
    all_violations: List[Violation] = []
    families = {"lock-discipline": lockrules.check,
                "guard-coverage": guardrules.check,
                "device-discipline": devicerules.check}
    for name, fn in families.items():
        if rules and name not in rules:
            continue
        all_violations.extend(fn(root, files))

    allow = Allowlist(allowlist_path or DEFAULT_ALLOWLIST)
    active: List[Violation] = []
    suppressed: List[Violation] = []
    for v in all_violations:
        (suppressed if allow.suppresses(v) else active).append(v)
    rel_allow = os.path.relpath(allow.path, root).replace(os.sep, "/")
    for lineno, why in allow.malformed:
        active.append(Violation(
            rule="allowlist", path=rel_allow, line=lineno,
            detail=f"malformed:{lineno}",
            message=f"malformed allowlist entry: {why}"))
    if rules is None:  # a stale entry means something on a full run only
        for pattern, lineno in allow.stale_entries():
            active.append(Violation(
                rule="allowlist", path=rel_allow, line=lineno,
                detail=f"stale:{pattern}",
                message=f"stale allowlist entry matches nothing: "
                        f"{pattern!r}: delete it or fix the pattern"))
    active.sort(key=lambda v: (v.path, v.line, v.rule))
    suppressed.sort(key=lambda v: (v.path, v.line, v.rule))
    return active, suppressed
