"""Query DSL: tokenizer -> recursive-descent parser -> AST -> NodeFilter.

Grammar parity with crates/cortex-core/src/query/mod.rs:1-850:

    kind:decision AND importance>0.7
    tags:backend,rust AND agent:kai
    created_after:7d AND kind:fact
    importance>=0.5 AND NOT deleted:true
    (kind:decision OR kind:pattern) AND tags:architecture

  - fields: kind (comma list), tags (comma list), agent,
    importance (> >= < <= =), created_after / created_before
    (relative 7d/24h/30m or ISO-8601), deleted:true|false, limit:N
  - OR only merges same-typed kind/tags fields; NOT only flips
    deleted — everything else is a CompileError, matching the
    reference's single-NodeFilter compilation model.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field as dc_field
from datetime import datetime, timezone
from typing import List, Optional, Tuple, Union

from ..errors import QueryParseError
from ..storage.base import NodeFilter
from ..types import validate_kind

GT, LT, GTE, LTE, EQ = ">", "<", ">=", "<=", "="


class ParseError(QueryParseError):
    def __init__(self, message: str, position: int):
        super().__init__(f"Parse error at position {position}: {message}")
        self.message = message
        self.position = position


class CompileError(QueryParseError):
    def __init__(self, message: str):
        super().__init__(f"Compile error: {message}")
        self.message = message


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass
class FieldFilter:
    field: str                       # kind|tags|agent|importance|created_after|
    #                                  created_before|deleted|limit
    values: List[str] = dc_field(default_factory=list)
    op: Optional[str] = None         # importance comparisons
    number: Optional[float] = None
    when: Optional[float] = None     # resolved epoch seconds
    flag: Optional[bool] = None


@dataclass
class FilterExpr:
    kind: str                        # field|and|or|not
    field: Optional[FieldFilter] = None
    left: Optional["FilterExpr"] = None
    right: Optional["FilterExpr"] = None
    inner: Optional["FilterExpr"] = None


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_PUNCT = {":": "colon", ",": "comma", "(": "lparen", ")": "rparen"}


@dataclass
class Tok:
    kind: str       # word|number|colon|comma|lparen|rparen|op|and|or|not
    text: str
    pos: int


def tokenize(s: str) -> List[Tok]:
    toks: List[Tok] = []
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c.isspace():
            i += 1
            continue
        if c in _PUNCT:
            toks.append(Tok(_PUNCT[c], c, i))
            i += 1
            continue
        if c == ">":
            if i + 1 < n and s[i + 1] == "=":
                toks.append(Tok("op", GTE, i))
                i += 2
            else:
                toks.append(Tok("op", GT, i))
                i += 1
            continue
        if c == "<":
            if i + 1 < n and s[i + 1] == "=":
                toks.append(Tok("op", LTE, i))
                i += 2
            else:
                toks.append(Tok("op", LT, i))
                i += 1
            continue
        if c == "=":
            toks.append(Tok("op", EQ, i))
            i += 1
            continue
        # word / number: everything until whitespace or punctuation
        start = i
        while i < n and not s[i].isspace() and s[i] not in _PUNCT \
                and s[i] not in "><=":
            i += 1
        word = s[start:i]
        # keywords are exact-uppercase (reference tokenizer behavior)
        if word == "AND":
            toks.append(Tok("and", word, start))
        elif word == "OR":
            toks.append(Tok("or", word, start))
        elif word == "NOT":
            toks.append(Tok("not", word, start))
        else:
            try:
                float(word)
                toks.append(Tok("number", word, start))
            except ValueError:
                toks.append(Tok("word", word, start))
    return toks


# ---------------------------------------------------------------------------
# Parser: or_expr -> and_expr -> unary -> primary
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, toks: List[Tok], raw: str):
        self.toks = toks
        self.i = 0
        self.raw = raw

    def peek(self) -> Optional[Tok]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def advance(self) -> Optional[Tok]:
        t = self.peek()
        if t is not None:
            self.i += 1
        return t

    def pos(self) -> int:
        t = self.peek()
        return t.pos if t else len(self.raw)

    def expect(self, kind: str) -> Tok:
        t = self.advance()
        if t is None or t.kind != kind:
            raise ParseError(
                f"Expected {kind}, found "
                f"{t.kind if t else 'end of input'}", self.pos())
        return t

    def parse(self) -> FilterExpr:
        e = self.or_expr()
        if self.peek() is not None:
            raise ParseError(f"Unexpected token '{self.peek().text}'",
                             self.pos())
        return e

    def or_expr(self) -> FilterExpr:
        left = self.and_expr()
        while self.peek() is not None and self.peek().kind == "or":
            self.advance()
            right = self.and_expr()
            left = FilterExpr(kind="or", left=left, right=right)
        return left

    def and_expr(self) -> FilterExpr:
        left = self.unary()
        while self.peek() is not None and self.peek().kind == "and":
            self.advance()
            right = self.unary()
            left = FilterExpr(kind="and", left=left, right=right)
        return left

    def unary(self) -> FilterExpr:
        if self.peek() is not None and self.peek().kind == "not":
            self.advance()
            return FilterExpr(kind="not", inner=self.unary())
        return self.primary()

    def primary(self) -> FilterExpr:
        t = self.peek()
        if t is not None and t.kind == "lparen":
            self.advance()
            inner = self.or_expr()
            self.expect("rparen")
            return inner
        return self.field_expr()

    def value(self) -> str:
        t = self.advance()
        if t is None:
            raise ParseError("Expected value, found end of input", self.pos())
        if t.kind in ("word", "number"):
            return t.text
        raise ParseError(f"Expected value, found {t.kind}", t.pos)

    def comma_values(self) -> List[str]:
        vals = [self.value()]
        while self.peek() is not None and self.peek().kind == "comma":
            self.advance()
            vals.append(self.value())
        return vals

    def number(self) -> float:
        t = self.advance()
        if t is None:
            raise ParseError("Expected number, found end of input", self.pos())
        try:
            return float(t.text)
        except ValueError:
            raise ParseError(f"Expected number, found '{t.text}'", t.pos)

    def field_expr(self) -> FilterExpr:
        t = self.advance()
        if t is None:
            raise ParseError("Expected field name, found end of input",
                             self.pos())
        if t.kind != "word":
            raise ParseError(f"Expected field name, found {t.kind}", t.pos)
        name = t.text
        if name == "kind":
            self.expect("colon")
            return FilterExpr(kind="field", field=FieldFilter(
                field="kind", values=self.comma_values()))
        if name == "tags":
            self.expect("colon")
            return FilterExpr(kind="field", field=FieldFilter(
                field="tags", values=self.comma_values()))
        if name == "agent":
            self.expect("colon")
            return FilterExpr(kind="field", field=FieldFilter(
                field="agent", values=[self.value()]))
        if name == "importance":
            op_tok = self.advance()
            if op_tok is None or op_tok.kind != "op":
                raise ParseError("Expected comparison operator",
                                 op_tok.pos if op_tok else self.pos())
            return FilterExpr(kind="field", field=FieldFilter(
                field="importance", op=op_tok.text, number=self.number()))
        if name in ("created_after", "created_before"):
            self.expect("colon")
            v = self.value()
            # ISO datetimes contain ':' (tokenized as punctuation) — rejoin
            while (self.peek() is not None and self.peek().kind == "colon"
                   and self.i + 1 < len(self.toks)
                   and self.toks[self.i + 1].kind in ("word", "number")):
                self.advance()
                v += ":" + self.value()
            return FilterExpr(kind="field", field=FieldFilter(
                field=name, when=parse_duration_or_date(v, t.pos)))
        if name == "deleted":
            self.expect("colon")
            v = self.value()
            if v not in ("true", "false"):
                raise ParseError(
                    f"Expected 'true' or 'false' for deleted, found '{v}'",
                    t.pos)
            return FilterExpr(kind="field", field=FieldFilter(
                field="deleted", flag=v == "true"))
        if name == "limit":
            self.expect("colon")
            return FilterExpr(kind="field", field=FieldFilter(
                field="limit", number=self.number()))
        raise ParseError(f"Unknown field: '{name}'", t.pos)


def parse_duration_or_date(value: str, pos: int) -> float:
    """'7d' / '24h' / '30m' relative to now, or ISO-8601 -> epoch secs."""
    if len(value) >= 2 and value[-1] in "dhm" and value[:-1].lstrip("-").isdigit():
        n = int(value[:-1])
        secs = {"d": 86400, "h": 3600, "m": 60}[value[-1]] * n
        return time.time() - secs
    try:
        dt = datetime.fromisoformat(value.replace("Z", "+00:00"))
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=timezone.utc)
        return dt.timestamp()
    except ValueError:
        raise ParseError(
            f"Invalid duration or date: '{value}'. Use 7d, 24h, 30m, or "
            "ISO-8601.", pos)


def parse(input_str: str) -> FilterExpr:
    toks = tokenize(input_str)
    if not toks:
        raise ParseError("Empty query", 0)
    return _Parser(toks, input_str).parse()


# ---------------------------------------------------------------------------
# Compiler: AST -> NodeFilter
# ---------------------------------------------------------------------------


def _try_collect_kinds(e: FilterExpr, out: List[str]) -> bool:
    if e.kind == "field" and e.field.field == "kind":
        out.extend(e.field.values)
        return True
    if e.kind == "or":
        return _try_collect_kinds(e.left, out) and \
            _try_collect_kinds(e.right, out)
    return False


def _try_collect_tags(e: FilterExpr, out: List[str]) -> bool:
    """Recursive OR-of-tags collector — 'tags:a OR tags:b OR tags:c'
    parses left-associatively, so the binary-only merge rejected three
    or more terms while the identical kind query compiled fine."""
    if e.kind == "field" and e.field.field == "tags":
        out.extend(e.field.values)
        return True
    if e.kind == "or":
        return _try_collect_tags(e.left, out) and \
            _try_collect_tags(e.right, out)
    return False


def _apply_field(f: FieldFilter, flt: NodeFilter) -> None:
    if f.field == "kind":
        for k in f.values:
            try:
                validate_kind(k)
            except Exception as e:  # noqa: BLE001
                raise CompileError(f"Invalid node kind: {e}")
        flt.kinds = (flt.kinds or []) + list(f.values)
    elif f.field == "tags":
        flt.tags = (flt.tags or []) + list(f.values)
    elif f.field == "agent":
        flt.source_agent = f.values[0]
    elif f.field == "importance":
        if f.op == GTE:
            flt.min_importance = f.number
        elif f.op == GT:
            # NodeFilter bounds are inclusive; step just above for
            # strict > (the LT branch has had the symmetric step)
            flt.min_importance = f.number + 1e-9
        elif f.op == EQ:
            flt.min_importance = f.number
            flt.max_importance = f.number
        elif f.op == LTE:
            flt.max_importance = f.number
        elif f.op == LT:
            # NodeFilter bounds are inclusive; step just below for strict <
            flt.max_importance = f.number - 1e-9
        else:
            raise CompileError(
                f"importance{f.op}{f.number}: unsupported operator")
    elif f.field == "created_after":
        flt.created_after = f.when
    elif f.field == "created_before":
        flt.created_before = f.when
    elif f.field == "deleted":
        flt.deleted_only = bool(f.flag)
        flt.include_deleted = bool(f.flag)
    elif f.field == "limit":
        flt.limit = int(f.number)


def _collect_into(e: FilterExpr, flt: NodeFilter) -> None:
    if e.kind == "field":
        _apply_field(e.field, flt)
        return
    if e.kind == "and":
        _collect_into(e.left, flt)
        _collect_into(e.right, flt)
        return
    if e.kind == "or":
        lk: List[str] = []
        if _try_collect_kinds(e, lk):
            _apply_field(FieldFilter(field="kind", values=lk), flt)
            return
        tg: List[str] = []
        if _try_collect_tags(e, tg):
            if flt.tags_any is not None:
                # two separate OR-groups of tags can't merge into
                # one any-of list — that would turn (a OR b) AND
                # (c OR d) into (a OR b OR c OR d)
                raise CompileError(
                    "multiple tag OR groups cannot be compiled to "
                    "a single NodeFilter")
            # OR of tags = match ANY (NodeFilter.tags is ALL-of)
            flt.tags_any = tg
            return
        raise CompileError(
            "OR is only supported between the same field type (e.g. kind:a "
            "OR kind:b). Complex OR expressions cannot be compiled to a "
            "single NodeFilter.")
    if e.kind == "not":
        inner = e.inner
        if inner.kind == "field" and inner.field.field == "deleted":
            _apply_field(FieldFilter(field="deleted",
                                     flag=not inner.field.flag), flt)
            return
        raise CompileError(
            "NOT is only supported for the 'deleted' field. Negation of "
            "other fields cannot be represented in a NodeFilter.")


def compile_expr(e: FilterExpr) -> NodeFilter:
    flt = NodeFilter()
    _collect_into(e, flt)
    return flt


def parse_and_compile(input_str: str) -> NodeFilter:
    return compile_expr(parse(input_str))
