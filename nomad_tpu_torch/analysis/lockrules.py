"""Rule family 1: lock discipline (a copy of
``nomad_tpu/analysis/lockrules.py`` with torch's device syncs in place of
JAX's).

Reconstructs lock regions per module from the AST and enforces two
invariants:

- **lock-blocking**: no blocking operation inside a lock region.  In the
  reference, an fsync under the raft log lock made the WAL's group commit
  impossible, and the snapshot sequencer's drain deadlocked under the log
  lock.  Blocking means: file durability (fsync/fdatasync), socket
  traffic (sendall/recv/connect/accept), subprocess execution,
  ``time.sleep``, and a device synchronization: ``torch.cuda.
  synchronize``, ``.synchronize()`` (a stream or an event), and the
  device-to-host reads ``.item()``, ``.tolist()`` and ``.cpu()``.  The
  AST cannot tell a CUDA tensor from a numpy array, so a numpy
  ``.tolist()`` or ``.item()`` under a lock fires too: hoist it or
  allowlist it with the reason.  ``Condition.wait`` is not blocking in
  this sense: it releases the lock it waits on.
- **lock-order**: the static acquisition graph (lock A held while
  acquiring lock B) must be acyclic.  A lock is ``module:owner.attr``,
  resolved from ``threading.Lock()`` / ``RLock()`` / ``Condition()``
  assignment sites and lock-like names; ``with`` regions nest the graph,
  and ``X.acquire()`` sites feed it as edge targets.  The cycle finder is
  the runtime sanitizer's (``utils/lockcheck.cycle_in_edges``), which
  also owns the cross-module orders static names cannot see.

Both rules follow one call level within a module (to a fixpoint): a
function that fsyncs is itself blocking, and calling it under a lock is
flagged at the call site.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from . import SourceFile, Violation, expr_text

RULE_BLOCKING = "lock-blocking"
RULE_ORDER = "lock-order"

BLOCKING_ATTRS = {
    "fsync": "os.fsync", "fdatasync": "os.fdatasync",
    "sendall": "socket send", "recv": "socket recv",
    "recv_into": "socket recv", "connect": "socket connect",
    "accept": "socket accept",
    "synchronize": "torch device sync",
    "item": "torch device-to-host read (.item)",
    "tolist": "torch device-to-host read (.tolist)",
    "cpu": "torch device-to-host copy (.cpu)",
    "sleep": "time.sleep",
    "check_output": "subprocess", "check_call": "subprocess",
    "communicate": "subprocess wait",
    "urlopen": "network request",
}
# Only blocking when called on the named module object.
BLOCKING_QUALIFIED = {
    ("subprocess", "run"): "subprocess",
    ("subprocess", "Popen"): "subprocess spawn",
    ("select", "select"): "select",
}
# Bare-name calls (``sleep()`` after ``from time import sleep``) count
# only for the unambiguous names.
BARE_BLOCKING = {"sleep", "fsync", "fdatasync", "urlopen"}

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}

_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                ast.ClassDef)


def _call_name(node: ast.Call) -> Tuple[Optional[str], Optional[str]]:
    fn = node.func
    if isinstance(fn, ast.Name):
        return None, fn.id
    if isinstance(fn, ast.Attribute):
        return expr_text(fn.value), fn.attr
    return None, None


def _blocking_kind(node: ast.Call) -> Optional[str]:
    base, attr = _call_name(node)
    if attr is None:
        return None
    if (base, attr) in BLOCKING_QUALIFIED:
        return BLOCKING_QUALIFIED[(base, attr)]
    if attr in BLOCKING_ATTRS:
        if base is None and attr not in BARE_BLOCKING:
            return None
        return BLOCKING_ATTRS[attr]
    return None


def _is_lock_ctor(node: ast.expr) -> bool:
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr in _LOCK_CTORS:
        return expr_text(fn.value) == "threading"
    if isinstance(fn, ast.Name) and fn.id in _LOCK_CTORS:
        return True
    return False


def _looks_lockish(name: str) -> bool:
    low = name.lower().lstrip("_")
    return (low.endswith("lock") or low.endswith("cond")
            or low.endswith("_cv") or low in ("cv", "l", "mu"))


class _FuncInfo:
    def __init__(self, qualname: str) -> None:
        self.qualname = qualname
        self.blocking: Set[str] = set()   # "callee:kind" tags
        self.acquires: Set[str] = set()   # lock ids taken anywhere
        self.calls: Set[str] = set()      # same-module calls, unlocked


class _FileLockPass:
    def __init__(self, sf: SourceFile) -> None:
        self.sf = sf
        # Dotted module path, not the basename — every package's
        # __init__.py would otherwise share one "__init__" namespace
        # and same-named locks in different packages would merge into
        # one lock-order-graph node.
        mod = sf.path[:-3] if sf.path.endswith(".py") else sf.path
        mod = mod.replace("/", ".")
        if mod.endswith(".__init__"):
            mod = mod[:-len(".__init__")]
        self.module = mod
        self.known_locks: Set[str] = set()
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute):
                        self.known_locks.add(tgt.attr)
                    elif isinstance(tgt, ast.Name):
                        self.known_locks.add(tgt.id)
        self.funcs: Dict[str, _FuncInfo] = {}
        self.violations: List[Violation] = []
        # (src, dst) -> (path, line, qualname) witness
        self.edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
        # same-module calls made while holding locks, resolved later:
        # (callee, line, qualname, held-ids)
        self.held_calls: List[Tuple[str, int, str, Tuple[str, ...]]] = []

    def _lock_id(self, expr: ast.expr) -> Optional[str]:
        text = expr_text(expr)
        if text is None:
            return None
        parts = text.split(".")
        attr = parts[-1]
        if attr not in self.known_locks and not _looks_lockish(attr):
            return None
        owner = ".".join(p for p in parts[:-1] if p != "self")
        return f"{self.module}:{owner + '.' if owner else ''}{attr}"

    # -- recursive region walk ---------------------------------------------

    def _visit(self, node: ast.AST, info: _FuncInfo,
               held: Tuple[str, ...]) -> None:
        if isinstance(node, _SCOPE_NODES):
            return  # separate scope; analyzed on its own
        if isinstance(node, ast.With):
            lock_ids: List[str] = []
            for item in node.items:
                self._visit(item.context_expr, info, held)
                lid = self._lock_id(item.context_expr)
                if lid is not None:
                    lock_ids.append(lid)
            for lid in lock_ids:
                info.acquires.add(lid)
                for held_id in held:
                    if held_id != lid:
                        self.edges.setdefault(
                            (held_id, lid),
                            (self.sf.path, node.lineno, info.qualname))
            inner = held + tuple(l for l in lock_ids if l not in held)
            for stmt in node.body:
                self._visit(stmt, info, inner)
            return
        if isinstance(node, ast.Call):
            self._visit_call(node, info, held)
            for child in ast.iter_child_nodes(node):
                self._visit(child, info, held)
            return
        for child in ast.iter_child_nodes(node):
            self._visit(child, info, held)

    def _visit_call(self, node: ast.Call, info: _FuncInfo,
                    held: Tuple[str, ...]) -> None:
        base, attr = _call_name(node)
        if attr == "acquire" and isinstance(node.func, ast.Attribute):
            lid = self._lock_id(node.func.value)
            if lid is not None:
                info.acquires.add(lid)
                for held_id in held:
                    if held_id != lid:
                        self.edges.setdefault(
                            (held_id, lid),
                            (self.sf.path, node.lineno, info.qualname))
            return
        kind = _blocking_kind(node)
        if kind is not None:
            if held:
                lock_names = ", ".join(
                    h.split(":", 1)[1] for h in held)
                self.violations.append(Violation(
                    rule=RULE_BLOCKING, path=self.sf.path,
                    line=node.lineno, qualname=info.qualname,
                    detail=f"{attr}:under:{lock_names}",
                    message=f"blocking call {attr} ({kind}) inside "
                            f"lock region [{lock_names}]: hoist it "
                            f"out of the lock or allowlist with a "
                            f"reason"))
            else:
                info.blocking.add(f"{attr}:{kind}")
            return
        # Same-module call resolution: bare names and self-methods
        # only.  An attribute call whose base does not resolve to text
        # (``rx["chunks"].append``) is a foreign object's method, not
        # this module's function of the same name.
        if attr is None:
            return
        if isinstance(node.func, ast.Name) or base == "self":
            if held:
                self.held_calls.append(
                    (attr, node.lineno, info.qualname, held))
            else:
                info.calls.add(attr)

    # -- driver ------------------------------------------------------------

    def run(self) -> None:
        for node in ast.walk(self.sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info = _FuncInfo(node.name)
                for stmt in node.body:
                    self._visit(stmt, info, held=())
                # Last definition wins on name collision across
                # classes — acceptable for a per-module heuristic.
                self.funcs[node.name] = info
        # Fixpoint: calling a blocking same-module function (outside
        # locks) makes the caller blocking too.
        changed = True
        while changed:
            changed = False
            for info in self.funcs.values():
                for callee in list(info.calls):
                    sub = self.funcs.get(callee)
                    if sub is None or sub is info:
                        continue
                    for tag in sub.blocking:
                        root_call = tag.split(":", 1)[0]
                        merged = f"{callee}->{tag}" \
                            if "->" not in tag else tag
                        if merged not in info.blocking:
                            info.blocking.add(merged)
                            changed = True
                    for lid in sub.acquires:
                        if lid not in info.acquires:
                            info.acquires.add(lid)
                            changed = True
        # Held-region same-module calls: blocking callees flag at the
        # call site; lock-acquiring callees feed the order graph.
        for attr, lineno, qualname, held in self.held_calls:
            sub = self.funcs.get(attr)
            if sub is None:
                continue
            lock_names = ", ".join(h.split(":", 1)[1] for h in held)
            for tag in sorted(sub.blocking):
                kind = tag.rsplit(":", 1)[-1]
                self.violations.append(Violation(
                    rule=RULE_BLOCKING, path=self.sf.path, line=lineno,
                    qualname=qualname,
                    detail=f"{attr}[{tag.split(':')[0]}]:under:"
                           f"{lock_names}",
                    message=f"call to {attr}() inside lock region "
                            f"[{lock_names}] reaches blocking {kind} "
                            f"— hoist or allowlist with a reason"))
            for acquired in sorted(sub.acquires):
                for held_id in held:
                    if held_id != acquired:
                        self.edges.setdefault(
                            (held_id, acquired),
                            (self.sf.path, lineno, qualname))


def _find_cycle(edges: Dict[Tuple[str, str], Tuple[str, int, str]]
                ) -> Optional[List[Tuple[str, str]]]:
    # One cycle finder for the static pass and the runtime sanitizer: the
    # iterative DFS of utils/lockcheck (a graph search, no sanitizer
    # state).
    from ..utils.lockcheck import cycle_in_edges

    return cycle_in_edges(edges)


def check(root: str, files: List[SourceFile]) -> List[Violation]:
    violations: List[Violation] = []
    all_edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
    for sf in files:
        fp = _FileLockPass(sf)
        fp.run()
        violations.extend(fp.violations)
        for edge, where in fp.edges.items():
            all_edges.setdefault(edge, where)
    cycle = _find_cycle(all_edges)
    if cycle is not None:
        witness = []
        for a, b in cycle:
            path, line, qual = all_edges[(a, b)]
            witness.append(f"{a} -> {b} at {path}:{line} ({qual})")
        path0, line0, qual0 = all_edges[cycle[0]]
        chain = " -> ".join(a for a, _ in cycle) + f" -> {cycle[-1][1]}"
        violations.append(Violation(
            rule=RULE_ORDER, path=path0, line=line0, qualname=qual0,
            detail=f"cycle:{chain}",
            message="lock-order cycle: " + "; ".join(witness)))
    return violations
