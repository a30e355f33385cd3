"""Rule family 3: torch device discipline in the hot-path modules
(``nomad_tpu_torch/ops/`` and ``nomad_tpu_torch/parallel/``), the
counterpart of ``nomad_tpu/analysis/jaxrules.py``.

- **torch-host-sync**: a read that makes the host wait for the card --
  ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize`` and ``.synchronize()``, and ``int(...)``,
  ``bool(...)`` or ``float(...)`` applied directly to a tensor
  expression.  Every such site is a sanctioned one, allowlisted with its
  reason (the one result fetch, the forensics fetch, the staged
  dispatch's sync, the round kernel's status read once a call, the
  mesh loop's per-step reads); anything else is a stealth sync inside
  the device pass.  ``.item()`` and ``.tolist()`` are flagged on a
  tensor only (numpy has them too), and ``.cpu().numpy()`` counts once.
- **torch-note-signature**: a module that launches a ``csrc`` kernel
  (it calls ``load_library`` or the kernel table's ``_fn``) must call
  ``kernels.note_signature``, so its launch signatures show in the
  ``batch.compiles`` gauge.

The reference's third rule, ``jax-donated-reuse``, has no counterpart:
torch does not donate buffers.  An argument stays valid after a call,
and the port's in-place updates (``index_add_`` on the resident mirror,
the round kernel's commits into the loop's own copies) are written out
where they happen.

Tensor-ness is read from the function alone: a name is a tensor when it
is bound from a ``torch.*`` call, from a method call, subscript or
arithmetic of a tensor, is annotated ``torch.Tensor``, or is a parameter
the function uses as one (``.clone``, ``.contiguous``, ``.data_ptr``,
``.index_add_``, ...); it is numpy when bound from an ``np.*`` call or a
``.numpy()``.  Keys carry the enclosing function and the call, not the
line: ``torch-host-sync <path>::<function>::<call>``.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set

from . import SourceFile, Violation, expr_text

RULE_HOSTSYNC = "torch-host-sync"
RULE_NOTESIG = "torch-note-signature"

HOT_PREFIXES = ("nomad_tpu_torch/ops/", "nomad_tpu_torch/parallel/")

# Methods that read a tensor back to the host.
SYNC_METHODS = ("item", "tolist", "cpu", "numpy", "synchronize")
# Methods that only a torch tensor has: a parameter used with one is a
# tensor.
TENSOR_ONLY = {"clone", "contiguous", "data_ptr", "numel", "element_size",
               "index_add_", "scatter_", "scatter_reduce_", "masked_fill",
               "bitwise_or_", "add_", "sub_", "is_contiguous", "new_zeros"}
CASTS = ("int", "bool", "float")
# What makes a module a kernel launcher.
LAUNCH_CALLS = ("load_library", "_fn")


def _root_name(node: ast.expr) -> Optional[str]:
    """The leftmost name of a call/subscript/attribute chain."""
    while True:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Attribute):
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, (ast.Compare, ast.BinOp)):
            node = node.left
        elif isinstance(node, ast.UnaryOp):
            node = node.operand
        else:
            return None


def _annotated(node: Optional[ast.expr]) -> Optional[str]:
    """"tensor" for an annotation naming ``Tensor`` (a tensor, or a
    container of them), "numpy" for one naming ``ndarray``."""
    words = set(re.findall(r"\w+", ast.unparse(node))) if node else set()
    return ("tensor" if "Tensor" in words
            else "numpy" if "ndarray" in words else None)


def _tensor_functions(tree: ast.Module) -> Set[str]:
    """The module's functions annotated to return tensors."""
    return {n.name for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and _annotated(n.returns) == "tensor"}


class _Kinds:
    """Which names of one function hold tensors and which numpy values."""

    def __init__(self, fn: ast.AST, tensor_fns: Set[str] = frozenset()):
        self.tensor_fns = tensor_fns
        self.tensor: Set[str] = set()
        self.numpy: Set[str] = set()
        params = {a.arg for a in ast.walk(fn.args)
                  if isinstance(a, ast.arg)} - {"self", "cls"}
        for node in ast.walk(fn):
            if (isinstance(node, ast.Attribute) and node.attr in TENSOR_ONLY
                    and isinstance(node.value, ast.Name)
                    and node.value.id in params):
                self.tensor.add(node.value.id)
        for a in ast.walk(fn.args):
            if isinstance(a, ast.arg) and a.annotation is not None:
                kind = _annotated(a.annotation)
                if kind == "tensor":
                    self.tensor.add(a.arg)
                elif kind == "numpy":
                    self.numpy.add(a.arg)
        assigns = sorted((n for n in ast.walk(fn)
                          if isinstance(n, (ast.Assign, ast.AnnAssign))),
                         key=lambda n: (n.lineno, n.col_offset))
        for node in assigns:
            if node.value is None:
                continue
            kind = self.kind(node.value)
            if isinstance(node, ast.AnnAssign):
                kind = _annotated(node.annotation) or kind
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for tgt in targets:
                for name in ast.walk(tgt):
                    if isinstance(name, ast.Name):
                        self.tensor.discard(name.id)
                        self.numpy.discard(name.id)
                        if kind == "tensor":
                            self.tensor.add(name.id)
                        elif kind == "numpy":
                            self.numpy.add(name.id)

    def kind(self, node: ast.expr) -> Optional[str]:
        """"tensor", "numpy", or None (unknown or host) of an expression."""
        if isinstance(node, ast.Name):
            if node.id in self.tensor:
                return "tensor"
            return "numpy" if node.id in self.numpy else None
        if isinstance(node, ast.Call):
            text = expr_text(node.func) or ""
            if text.startswith(("np.", "numpy.")):
                return "numpy"
            if (text.startswith("torch.") and not text.startswith(
                    ("torch.cuda.", "torch.device"))) \
                    or text in self.tensor_fns:
                return "tensor"
            if isinstance(node.func, ast.Attribute):
                if node.func.attr == "numpy":
                    return "numpy"
                if node.func.attr in ("tolist", "item"):
                    return None
                return self.kind(node.func.value)
            return None
        if isinstance(node, ast.Subscript):
            return self.kind(node.value)
        if isinstance(node, ast.Attribute):
            if node.attr in ("shape", "dtype", "device"):
                return None
            return self.kind(node.value)
        if isinstance(node, ast.BinOp):
            kinds = (self.kind(node.left), self.kind(node.right))
            return ("tensor" if "tensor" in kinds
                    else "numpy" if "numpy" in kinds else None)
        if isinstance(node, ast.UnaryOp):
            return self.kind(node.operand)
        if isinstance(node, ast.Compare):
            kinds = [self.kind(node.left)] + [self.kind(c)
                                              for c in node.comparators]
            return ("tensor" if "tensor" in kinds
                    else "numpy" if "numpy" in kinds else None)
        return None


def _functions(tree: ast.Module):
    """Every function with its qualified name (``Class.method``)."""
    out = []

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                out.append((q, child))
                walk(child, q + ".")
            elif isinstance(child, ast.ClassDef):
                walk(child, f"{prefix}{child.name}.")
            else:
                walk(child, prefix)

    walk(tree, "")
    return out


def _own_nodes(fn: ast.AST):
    """The nodes of ``fn`` outside its nested functions."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _check_host_sync(sf: SourceFile, violations: List[Violation]) -> None:
    tensor_fns = _tensor_functions(sf.tree)
    for qual, fn in _functions(sf.tree):
        kinds = _Kinds(fn, tensor_fns)
        seen: Dict[str, int] = {}
        for node in sorted((n for n in _own_nodes(fn)
                            if isinstance(n, ast.Call)),
                           key=lambda n: (n.lineno, n.col_offset)):
            text = expr_text(node.func) or ""
            detail = None
            if text == "torch.cuda.synchronize":
                detail = "torch.cuda.synchronize"
            elif (isinstance(node.func, ast.Attribute)
                    and node.func.attr in SYNC_METHODS):
                attr = node.func.attr
                recv = node.func.value
                if attr in ("item", "tolist") and kinds.kind(recv) != "tensor":
                    continue
                if (attr == "numpy" and isinstance(recv, ast.Call)
                        and isinstance(recv.func, ast.Attribute)
                        and recv.func.attr == "cpu"):
                    continue    # the read is the .cpu() before it
                detail = (f"{expr_text(recv) or _root_name(recv) or '<expr>'}"
                          f".{attr}")
            elif (isinstance(node.func, ast.Name) and node.func.id in CASTS
                    and len(node.args) == 1
                    and isinstance(node.args[0], (ast.Call, ast.Subscript))
                    and kinds.kind(node.args[0]) == "tensor"):
                root = _root_name(node.args[0]) or "<expr>"
                detail = f"{node.func.id}({root})"
            if detail is None:
                continue
            n = seen.get(detail, 0)
            seen[detail] = n + 1
            violations.append(Violation(
                rule=RULE_HOSTSYNC, path=sf.path, line=node.lineno,
                qualname=qual, detail=detail if not n else f"{detail}#{n}",
                message=f"host sync {detail} in a hot-path module: every "
                        f"read of the card must be a sanctioned site "
                        f"(allowlist it with its reason)"))


def _check_note_signature(sf: SourceFile,
                          violations: List[Violation]) -> None:
    has_note = False
    launches = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        text = expr_text(node.func) or ""
        last = text.rsplit(".", 1)[-1]
        if last == "note_signature":
            has_note = True
        elif last in LAUNCH_CALLS:
            launches.append(node)
    if launches and not has_note:
        quals = {}
        for qual, fn in _functions(sf.tree):
            for node in _own_nodes(fn):
                quals[id(node)] = qual
        seen = set()
        for node in launches:
            qual = quals.get(id(node), "")
            detail = f"launch-in:{qual or '<module>'}"
            if detail in seen:
                continue
            seen.add(detail)
            violations.append(Violation(
                rule=RULE_NOTESIG, path=sf.path, line=node.lineno,
                qualname=qual, detail=detail,
                message="module launches a csrc kernel but never calls "
                        "kernels.note_signature: its launch signatures "
                        "would not show in batch.compiles"))


def check(root: str, files: List[SourceFile]) -> List[Violation]:
    violations: List[Violation] = []
    for sf in files:
        if not sf.path.startswith(HOT_PREFIXES):
            continue
        _check_host_sync(sf, violations)
        _check_note_signature(sf, violations)
    return violations
