"""Rule family 2: guard coverage, checked against ``ops/guards.py`` (a copy
of ``nomad_tpu/analysis/guardrules.py`` without its knob checks).

The registry (:mod:`nomad_tpu_torch.ops.guards`) declares every fast-path
/ reference-path pair; this family checks that the declarations are true
of the tree:

- every ``native/*.cc`` source is claimed by a registry entry (an
  unclaimed one is unguarded native code), and every claimed source
  exists;
- each entry's module is in the tree and defines the named guard symbol;
- an entry whose mismatch ``raise``-s names an error its module makes
  and raises; one that feeds the ``breaker`` contains the feed
  (``.record(False)``);
- an entry without a guard or a mismatch action carries a written
  waiver, and every entry names its reference route.

The reference also checks each entry's kill switch and cadence knob
against ``utils/knobs.py``; the port has no knobs (ROADMAP queue 3 item
8(c)), and its entries name arguments instead.  The registry is loaded
by file path, not imported, so the pass imports nothing of the package.
"""
from __future__ import annotations

import ast
import importlib.util
import os
from typing import Dict, List, Optional

from . import SourceFile, Violation

RULE = "guard-coverage"

GUARDS_PATH = "nomad_tpu_torch/ops/guards.py"
NATIVE_DIR = "nomad_tpu_torch/native"


def registry_missing(root: str, rel: str, rule: str) -> Optional[Violation]:
    """A tree without its registry file is a violation, not a crash."""
    if os.path.exists(os.path.join(root, rel)):
        return None
    return Violation(
        rule=rule, path=rel, line=1, detail="registry-missing",
        message=f"tree has no {rel}: the registry this rule family "
                f"checks against is required")


def _load_by_path(root: str, rel: str, name: str):
    import hashlib
    import sys

    # The cache key carries the resolved path: runs against different
    # roots (tests, --root) must not see each other's registries.
    abspath = os.path.abspath(os.path.join(root, rel))
    name = f"{name}_{hashlib.sha256(abspath.encode()).hexdigest()[:12]}"
    cached = sys.modules.get(name)
    if cached is not None and getattr(cached, "__file__", None) == abspath:
        return cached
    spec = importlib.util.spec_from_file_location(name, abspath)
    mod = importlib.util.module_from_spec(spec)
    # dataclasses resolves cls.__module__ through sys.modules.
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        sys.modules.pop(name, None)
        raise
    return mod


def _module_rel_path(dotted: str) -> str:
    return dotted.replace(".", "/") + ".py"


def _module_symbols(sf: SourceFile) -> Dict[str, int]:
    """Top-level defs and assignments of a module -> line."""
    out: Dict[str, int] = {}
    for node in sf.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out[node.name] = node.lineno
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out[tgt.id] = node.lineno
        elif isinstance(node, ast.AnnAssign) and isinstance(
                node.target, ast.Name):
            out[node.target.id] = node.lineno
    return out


def _has_breaker_feed(sf: SourceFile) -> bool:
    return ".record(False)" in sf.source


def _raises(sf: SourceFile, error: str) -> bool:
    """The module makes ``error`` (a call of that name) and has a raise
    statement (the guard's raise may go through a helper that returns the
    error, as ``raise _mismatch(...)`` does)."""
    makes = raises = False
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Raise):
            raises = True
        elif isinstance(node, ast.Call):
            fn = node.func
            name = (fn.id if isinstance(fn, ast.Name)
                    else fn.attr if isinstance(fn, ast.Attribute) else None)
            makes = makes or name == error
    return makes and raises


def check(root: str, files: List[SourceFile]) -> List[Violation]:
    violations: List[Violation] = []
    by_path = {sf.path: sf for sf in files}

    missing = registry_missing(root, GUARDS_PATH, RULE)
    if missing is not None:
        return [missing]
    try:
        guards = _load_by_path(root, GUARDS_PATH, "_analysis_guards")
    except Exception as exc:  # the registry must at least load
        return [Violation(
            rule=RULE, path=GUARDS_PATH, line=1, detail="registry-load",
            message=f"guard registry failed to load: {exc!r}")]

    # 1. every .cc claimed, nothing claimed that does not exist.
    native_dir = os.path.join(root, NATIVE_DIR)
    cc_files = sorted(fn for fn in (
        os.listdir(native_dir) if os.path.isdir(native_dir) else ())
        if fn.endswith(".cc"))
    claimed = guards.native_sources()
    for fn in cc_files:
        if fn not in claimed:
            violations.append(Violation(
                rule=RULE, path=f"{NATIVE_DIR}/{fn}", line=1,
                detail="unclaimed-native-source",
                message=f"native source {fn} has no ops/guards.py registry "
                        f"entry: every native twin needs a declared guard "
                        f"and reference route"))
    for fn in claimed:
        if fn not in cc_files:
            violations.append(Violation(
                rule=RULE, path=GUARDS_PATH, line=1,
                detail=f"phantom-native-source:{fn}",
                message=f"registry claims native source {fn}, which is "
                        f"not in {NATIVE_DIR}/"))

    # 2. each entry.
    seen = set()
    for entry in guards.REGISTRY:
        if entry.name in seen:
            violations.append(Violation(
                rule=RULE, path=GUARDS_PATH, line=1,
                detail=f"dup-entry:{entry.name}",
                message=f"duplicate registry entry {entry.name}"))
            continue
        seen.add(entry.name)
        waived = bool(entry.waiver.strip())

        mod_rel = _module_rel_path(entry.module)
        sf = by_path.get(mod_rel)
        if sf is None:
            violations.append(Violation(
                rule=RULE, path=GUARDS_PATH, line=1,
                detail=f"{entry.name}:missing-module",
                message=f"registry entry {entry.name} names module "
                        f"{entry.module}, which is not in the tree"))
            continue

        if entry.guard_symbol is not None:
            if entry.guard_symbol not in _module_symbols(sf):
                violations.append(Violation(
                    rule=RULE, path=mod_rel, line=1,
                    detail=f"{entry.name}:missing-guard-symbol",
                    message=f"registry entry {entry.name} names guard "
                            f"symbol {entry.guard_symbol!r}, which "
                            f"{entry.module} does not define"))
        elif not waived:
            violations.append(Violation(
                rule=RULE, path=GUARDS_PATH, line=1,
                detail=f"{entry.name}:unjustified-no-guard",
                message=f"registry entry {entry.name} has no guard symbol "
                        f"and no written waiver"))

        action = entry.on_mismatch
        if action == "raise":
            if not entry.raises or not _raises(sf, entry.raises):
                violations.append(Violation(
                    rule=RULE, path=mod_rel, line=1,
                    detail=f"{entry.name}:missing-raise",
                    message=f"registry entry {entry.name} claims a mismatch "
                            f"raises {entry.raises or '<none named>'}, but "
                            f"{entry.module} does not make and raise it"))
        elif action == "breaker":
            if not _has_breaker_feed(sf):
                violations.append(Violation(
                    rule=RULE, path=mod_rel, line=1,
                    detail=f"{entry.name}:missing-breaker-feed",
                    message=f"registry entry {entry.name} claims a breaker "
                            f"feed, but {entry.module} makes no "
                            f".record(False) call"))
        elif action:
            violations.append(Violation(
                rule=RULE, path=GUARDS_PATH, line=1,
                detail=f"{entry.name}:unknown-action:{action}",
                message=f"registry entry {entry.name} names mismatch "
                        f"action {action!r}, not one of "
                        f"{list(guards.MISMATCH_ACTIONS)}"))
        elif not waived:
            violations.append(Violation(
                rule=RULE, path=GUARDS_PATH, line=1,
                detail=f"{entry.name}:unjustified-no-action",
                message=f"registry entry {entry.name} says nothing of what "
                        f"a mismatch does and has no written waiver"))

        if not entry.reference_route.strip():
            violations.append(Violation(
                rule=RULE, path=GUARDS_PATH, line=1,
                detail=f"{entry.name}:no-reference-route",
                message=f"registry entry {entry.name} names no argument "
                        f"or route that asks for the reference path"))
    return violations
