"""A self-contained HCL1-subset parser (a copy of
``nomad_tpu/jobspec/hcl.py``).

The reference parses job files with the hashicorp/hcl Go library
(jobspec/parse.go:30 uses hcl.Parse + ast walking).  This module implements
the slice of the HCL grammar job files actually use — blocks with string
labels, attribute assignments, strings (with literal ``${...}``
interpolations preserved), heredocs, numbers, bools, lists, nested objects,
``#``/``//``/``/* */`` comments — as a small hand-written lexer + recursive
descent parser with line-accurate errors.  No third-party dependency.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterator, List, Optional, Tuple


class HCLError(ValueError):
    pass


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass
class Entry:
    """One member of a block body: ``key [labels...] { body }`` or
    ``key = value``."""

    key: str
    labels: Tuple[str, ...]
    value: Any  # Block for block-form, python scalar/list/Block for attrs
    line: int = 0

    @property
    def is_block(self) -> bool:
        return isinstance(self.value, Block)


@dataclass
class Block:
    """An ordered multi-map: HCL1 allows repeated keys (repeated blocks
    accumulate, e.g. multiple ``task`` blocks)."""

    entries: List[Entry] = field(default_factory=list)
    line: int = 0

    def get(self, key: str) -> List[Entry]:
        return [e for e in self.entries if e.key == key]

    def one(self, key: str) -> Optional[Entry]:
        items = self.get(key)
        return items[0] if items else None

    def keys(self) -> List[str]:
        seen, out = set(), []
        for e in self.entries:
            if e.key not in seen:
                seen.add(e.key)
                out.append(e.key)
        return out

    def to_dict(self) -> dict:
        """Collapse into plain python data: repeated keys -> list, labeled
        blocks -> nested dicts keyed by label (how HCL1 decodes
        ``port_map { db = 1234 }`` style config bodies)."""
        out: dict = {}
        for e in self.entries:
            v = e.value.to_dict() if isinstance(e.value, Block) else e.value
            for label in reversed(e.labels):
                v = {label: v}
            if e.key in out:
                prev = out[e.key]
                if isinstance(prev, dict) and isinstance(v, dict):
                    prev.update(v)
                elif isinstance(prev, list):
                    prev.append(v)
                else:
                    out[e.key] = [prev, v]
            else:
                out[e.key] = v
        return out


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_PUNCT = "{}[]=,"


@dataclass
class Token:
    kind: str  # punct | str | num | ident | eof
    value: Any
    line: int


def _lex(src: str) -> Iterator[Token]:
    i, n, line = 0, len(src), 1
    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c in " \t\r":
            i += 1
            continue
        if c == "#" or src.startswith("//", i):
            while i < n and src[i] != "\n":
                i += 1
            continue
        if src.startswith("/*", i):
            end = src.find("*/", i + 2)
            if end < 0:
                raise HCLError(f"line {line}: unterminated block comment")
            line += src.count("\n", i, end)
            i = end + 2
            continue
        if c in _PUNCT:
            yield Token("punct", c, line)
            i += 1
            continue
        if c == '"':
            value, i, line = _lex_string(src, i, line)
            yield Token("str", value, line)
            continue
        if src.startswith("<<", i):
            value, i, line = _lex_heredoc(src, i, line)
            yield Token("str", value, line)
            continue
        if c.isdigit() or (c == "-" and i + 1 < n and src[i + 1].isdigit()):
            j = i + 1
            while j < n and (src[j].isdigit() or src[j] in ".eExXabcdefABCDEF+-"):
                # stop at punctuation/whitespace; permissive scan then parse
                if src[j] in _PUNCT or src[j] in ' \t\r\n"#':
                    break
                j += 1
            text = src[i:j]
            try:
                num: Any = int(text, 0)
            except ValueError:
                try:
                    num = float(text)
                except ValueError:
                    raise HCLError(f"line {line}: invalid number {text!r}")
            yield Token("num", num, line)
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] in "_.-"):
                j += 1
            yield Token("ident", src[i:j], line)
            i = j
            continue
        raise HCLError(f"line {line}: unexpected character {c!r}")
    yield Token("eof", None, line)


def _lex_string(src: str, i: int, line: int) -> Tuple[str, int, int]:
    # i points at the opening quote.  ${ ... } interpolations are preserved
    # literally (brace-nesting aware, as HCL does).
    out: List[str] = []
    i += 1
    n = len(src)
    while i < n:
        c = src[i]
        if c == '"':
            return "".join(out), i + 1, line
        if c == "\n":
            raise HCLError(f"line {line}: newline in string")
        if c == "\\":
            if i + 1 >= n:
                break
            esc = src[i + 1]
            mapped = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\"}.get(esc)
            if mapped is None:
                out.append("\\" + esc)
            else:
                out.append(mapped)
            i += 2
            continue
        if src.startswith("${", i):
            depth = 0
            j = i
            while j < n:
                if src[j] == "{":
                    depth += 1
                elif src[j] == "}":
                    depth -= 1
                    if depth == 0:
                        break
                j += 1
            if depth != 0:
                raise HCLError(f"line {line}: unterminated interpolation")
            out.append(src[i:j + 1])
            i = j + 1
            continue
        out.append(c)
        i += 1
    raise HCLError(f"line {line}: unterminated string")


def _lex_heredoc(src: str, i: int, line: int) -> Tuple[str, int, int]:
    n = len(src)
    j = i + 2
    indent = False
    if j < n and src[j] == "-":
        indent = True
        j += 1
    k = j
    while k < n and (src[k].isalnum() or src[k] == "_"):
        k += 1
    tag = src[j:k]
    if not tag:
        raise HCLError(f"line {line}: invalid heredoc")
    nl = src.find("\n", k)
    if nl < 0:
        raise HCLError(f"line {line}: unterminated heredoc")
    body_start = nl + 1
    lines: List[str] = []
    pos = body_start
    cur_line = line + 1
    while pos <= n:
        eol = src.find("\n", pos)
        if eol < 0:
            eol = n
        text = src[pos:eol]
        if text.strip() == tag:
            body = "\n".join(lines)
            if lines:
                body += "\n"
            if indent:
                body = "\n".join(l.lstrip("\t ") for l in body.split("\n"))
            return body, eol + 1 if eol < n else n, cur_line
        lines.append(text)
        pos = eol + 1
        cur_line += 1
        if eol == n:
            break
    raise HCLError(f"line {line}: heredoc tag {tag!r} never closed")


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, src: str):
        self.tokens = list(_lex(src))
        self.pos = 0

    def peek(self) -> Token:
        return self.tokens[self.pos]

    def next(self) -> Token:
        t = self.tokens[self.pos]
        self.pos += 1
        return t

    def expect_punct(self, ch: str) -> Token:
        t = self.next()
        if t.kind != "punct" or t.value != ch:
            raise HCLError(f"line {t.line}: expected {ch!r}, got {t.value!r}")
        return t

    def parse_body(self, top: bool) -> Block:
        blk = Block(line=self.peek().line)
        while True:
            t = self.peek()
            if t.kind == "eof":
                if not top:
                    raise HCLError(f"line {t.line}: unexpected EOF, missing '}}'")
                return blk
            if t.kind == "punct" and t.value == "}":
                if top:
                    raise HCLError(f"line {t.line}: unexpected '}}'")
                self.next()
                return blk
            blk.entries.append(self.parse_member())

    def parse_member(self) -> Entry:
        t = self.next()
        if t.kind not in ("ident", "str"):
            raise HCLError(f"line {t.line}: expected key, got {t.value!r}")
        key = t.value
        labels: List[str] = []
        while True:
            nxt = self.peek()
            if nxt.kind == "punct" and nxt.value == "=":
                self.next()
                return Entry(key, tuple(labels), self.parse_value(), t.line)
            if nxt.kind == "punct" and nxt.value == "{":
                self.next()
                return Entry(key, tuple(labels), self.parse_body(top=False), t.line)
            if nxt.kind in ("str", "ident"):
                labels.append(self.next().value)
                continue
            raise HCLError(
                f"line {nxt.line}: expected '=', '{{' or label after "
                f"{key!r}, got {nxt.value!r}")

    def parse_value(self) -> Any:
        t = self.next()
        if t.kind == "str" or t.kind == "num":
            return t.value
        if t.kind == "ident":
            if t.value == "true":
                return True
            if t.value == "false":
                return False
            raise HCLError(f"line {t.line}: unexpected identifier {t.value!r}")
        if t.kind == "punct" and t.value == "[":
            items: List[Any] = []
            while True:
                nxt = self.peek()
                if nxt.kind == "punct" and nxt.value == "]":
                    self.next()
                    return items
                items.append(self.parse_value())
                nxt = self.peek()
                if nxt.kind == "punct" and nxt.value == ",":
                    self.next()
                elif not (nxt.kind == "punct" and nxt.value == "]"):
                    raise HCLError(f"line {nxt.line}: expected ',' or ']'")
        if t.kind == "punct" and t.value == "{":
            return self.parse_body(top=False)
        raise HCLError(f"line {t.line}: unexpected token {t.value!r}")


def parse_hcl(src: str) -> Block:
    """Parse HCL source into the top-level Block."""
    return _Parser(src).parse_body(top=True)
