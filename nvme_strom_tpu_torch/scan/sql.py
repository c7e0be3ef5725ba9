"""SQL front-end: a parsed SELECT subset over heap tables, in torch.

A port of the JAX package's ``scan/sql.py``.  The reference ships as a
PostgreSQL extension, so SQL is its users' interface
(`pgsql/nvme_strom.c:941-979` hands tuples to the SQL executor).  This
module gives the scan tier the same face: a hand-rolled tokenizer and
recursive-descent parser map a SELECT statement onto the
:class:`.query.Query` builder, so every access path the planner knows
(direct, vfs, index sidecars), both routes and the mesh are reachable from
a SQL string.

Supported subset (one fact table, one terminal, the Query contract)::

    SELECT select_list FROM <name>
      [[INNER|LEFT|SEMI|ANTI] JOIN <dim> ON cN = <dim>.cM]...
      [WHERE cond]
      [GROUP BY cN[, cM]...]
      [HAVING agg cmp literal [AND ...]]
      [ORDER BY cN[, cM] | agg [ASC|DESC]]
      [LIMIT n [OFFSET m]]

    select_list := [DISTINCT] '*' | item [AS name] (',' item [AS name])*
    item  := cN | dim.cK | COUNT(*) | COUNT(cN) | COUNT(DISTINCT cN)
           | SUM(cN|dim.cK|expr) | AVG(cN|dim.cK|expr) | MIN(cN) | MAX(cN)
    where := term (OR term)* ; term := factor (AND factor)*
    factor := NOT factor | '(' where ')' | cond      -- SQL precedence
    cond  := expr cmp expr | cN IS [NOT] NULL
           | cN BETWEEN lit AND lit | cN IN (lit[, lit]...)
    expr  := cN | number | '(' expr ')' | -expr | expr (+|-|*|/) expr
    cmp   := = | == | != | <> | < | <= | > | >=
    literal := number | 'string'   (strings need a dictionary sidecar)

JOIN binds a dimension table given as ``tables={"dim": (path, schema)}``.
One JOIN serves the aggregate face (``COUNT(*)``, ``SUM(cN)``,
``SUM(dim.cK)``) or, with plain columns, the joined rows; two or more form
a star statement, every dimension probed in the same scan
(:meth:`.query.Query.star_join`).

Columns are named ``c0..cN-1``.  The mapping is exact: a statement outside
the subset raises EINVAL naming the construct.  Mapping (SQL shape -> the
Query terminal that serves it):

* plain columns                  -> ``select(cols)`` (LIMIT/OFFSET stop
  the scan early)
* COUNT(*) / SUM / AVG, no GROUP -> ``aggregate(cols=...)``; with an
  arithmetic argument ``aggregate_exprs``
* sole MIN(c) / MAX(c), no GROUP -> ``top_k(c, 1)``
* sole COUNT(DISTINCT c)         -> ``count_distinct(c)``
* GROUP BY c[, c2...]            -> ``group_by_cols`` (HAVING composes)
* ORDER BY c[, c2] [DESC]        -> ``order_by``; other selected columns
  fetched by position.  ORDER BY an aggregate + LIMIT on grouped results
  = the top-N groups
* SELECT DISTINCT cols           -> ``group_by_cols``, keys only
* AS name                        -> relabels the output (after the string
  decode)
* :func:`create_table_as`        -> the result as a new heap table
* WHERE: the first index-capable leaf of a top-level AND (``=``,
  ``BETWEEN``, ``IN``) becomes ``where_eq`` / ``where_range`` /
  ``where_in``, which the planner can serve from a sidecar.  The other
  leaves of the AND that are plain ``cN cmp literal`` or ``cN BETWEEN``
  become :class:`..ops.filter.FilterPred` terms, at most 8 with the
  structured filter's, so the statement takes the CUDA route exactly
  where the same ``Query``-API form does.  What is left (OR, NOT, IS
  NULL, expression comparisons, leaves beyond 8 terms) is one ``where``
  callable with its picklable tree, which worker processes rebuild.  The
  JAX package lowers none of the leaves: the rows are its rows, only the
  route differs.

Expressions: int arithmetic runs at int32 (it wraps at the storage
width), float math at float32, mixed operands promote to float32,
integer / integer is EINVAL, uint32 operands and string columns in
arithmetic are EINVAL; the port's 64-bit rule for 8-byte operands is
:func:`_bin_dtype`'s.  Float division follows IEEE 754 (``x / 0.0`` is
±inf, ``0.0 / 0.0`` NaN, NaN compares false).  Trees are picklable tuples
— ``("col", c) | ("lit", v) | ("neg", e) | ("bin", op, l, r)``.  A plain
``cN cmp literal`` compares as ``jnp`` compares the column with the
literal (:func:`..ops.filter.term_value`).

WHERE keeps SQL's three values over nullable columns: a comparison with a
NULL operand is UNKNOWN, NOT of UNKNOWN stays UNKNOWN, and only the
definitely-TRUE rows are selected.

Divergences from the JAX package's facade, each a wrong answer there:
``c0 != 'absent'`` on a nullable string column keeps its NULL rows
UNKNOWN (the JAX package drops the leaf and counts them); a nullable
string column decodes with None at its NULL rows (the JAX package
raises TypeError); ORDER BY's projected columns keep their NULLs (the
JAX package returns the stored word, or the dictionary's first string);
NOT of a leaf TRUE on every row is FALSE on every row (the JAX package
makes it ``c0 IN ()``, UNKNOWN on c0's NULL rows, so ``NOT NOT (c1 IS
NOT NULL)`` drops them).  Where the JAX package raises OverflowError (a
literal no jnp compare takes), the port raises EINVAL.
"""

from __future__ import annotations

import errno as _errno
import inspect
import os
import re
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..api import StromError
from ..ops.filter import _CMP, MAX_TERMS, FilterPred, _scalar, \
    compare_view, term_value
from .heap import HeapSchema, build_heap_file
from .query import Query
from .strings import StringDict, dict_path_for, load_dict, save_dict

__all__ = ["parse_sql", "sql_query", "create_table_as"]

_EINVAL = _errno.EINVAL

_TOKEN = re.compile(r"""
    \s*(?:
      (?P<str>'[^']*')
    | (?P<num>\d+\.\d+(?:[eE][+-]?\d+)?|\d+)
    | (?P<name>[A-Za-z_][A-Za-z_0-9]*)
    | (?P<op><=|>=|!=|<>|==|=|<|>|\(|\)|,|\*|\.|\+|-|/|%)
    )""", re.VERBOSE)

_AGGS = ("count", "sum", "avg", "min", "max")
_CMPS = ("=", "==", "!=", "<>", "<", "<=", ">", ">=")
_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
_TERM_OP = {"=": "eq", "==": "eq", "!=": "ne", "<>": "ne", "<": "lt",
            "<=": "le", ">": "gt", ">=": "ge"}
_FIELD = {"sum": "sums", "avg": "avgs", "min": "mins", "max": "maxs"}

_U32 = np.dtype(np.uint32)
_I64, _F64 = np.dtype(np.int64), np.dtype(np.float64)
_TORCH = {np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32,
          _I64: torch.int64, _F64: torch.float64}
_NUMPY = {t: d for d, t in _TORCH.items()}


# ---------------------------------------------------------------------------
# Tokens and the recursive descent
# ---------------------------------------------------------------------------

def _tokenize(sql: str) -> List[Tuple[str, str]]:
    out, pos = [], 0
    while pos < len(sql):
        m = _TOKEN.match(sql, pos)
        if m is None:
            if sql[pos:].strip() == "":
                break
            raise StromError(_EINVAL, f"SQL: cannot tokenize at "
                                      f"{sql[pos:pos + 20]!r}")
        pos = m.end()
        for kind in ("str", "num", "name", "op"):
            v = m.group(kind)
            if v is not None:
                out.append((kind, v[1:-1] if kind == "str" else v))
                break
    return out


class _P:
    """Token cursor with the helpers a recursive descent needs."""

    def __init__(self, toks: List[Tuple[str, str]]):
        self.toks = toks
        self.i = 0

    def peek(self) -> Optional[Tuple[str, str]]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> Tuple[str, str]:
        t = self.peek()
        if t is None:
            raise StromError(_EINVAL, "SQL: unexpected end of statement")
        self.i += 1
        return t

    def kw(self, word: str) -> bool:
        """Consume *word* (a case-insensitive keyword) if it is next."""
        t = self.peek()
        if t and t[0] == "name" and t[1].lower() == word:
            self.i += 1
            return True
        return False

    def expect_op(self, op: str) -> None:
        t = self.next()
        if t != ("op", op):
            raise StromError(_EINVAL, f"SQL: expected {op!r}, got {t[1]!r}")

    def expect_kw(self, word: str) -> None:
        if not self.kw(word):
            t = self.peek()
            raise StromError(_EINVAL, f"SQL: expected {word.upper()}, got "
                                      f"{t[1] if t else 'end'!r}")

    def is_call(self) -> bool:
        """The name at the cursor is followed by '('."""
        return self.i + 1 < len(self.toks) \
            and self.toks[self.i + 1] == ("op", "(")


def _col(tok: Tuple[str, str], n_cols: int) -> int:
    kind, v = tok
    m = re.fullmatch(r"[cC](\d+)", v) if kind == "name" else None
    if not m:
        raise StromError(_EINVAL, f"SQL: expected a column (c0..c"
                                  f"{n_cols - 1}), got {v!r}")
    c = int(m.group(1))
    if not 0 <= c < n_cols:
        raise StromError(_EINVAL, f"SQL: column c{c} out of range (table "
                                  f"has {n_cols})")
    return c


class _Str(str):
    """Marker for a parsed SQL string literal ('...'): translated to
    dictionary codes before the numeric machinery sees it, and never part
    of arithmetic."""


def _lit(tok: Tuple[str, str]):
    kind, v = tok
    if kind == "str":
        return _Str(v)
    if kind != "num":
        raise StromError(_EINVAL, f"SQL: expected a literal, got {v!r}")
    return float(v) if ("." in v or "e" in v or "E" in v) else int(v)


def _plit(p: _P):
    """A literal, possibly negated (the tokenizer emits '-' as an
    operator so that expressions can subtract)."""
    if p.peek() == ("op", "-"):
        p.next()
        v = _lit(p.next())
        if isinstance(v, _Str):
            raise StromError(_EINVAL, "SQL: cannot negate a string literal")
        return -v
    return _lit(p.next())


def _parse_expr(p: _P, n_cols: int):
    """expr := term (('+'|'-') term)* ; term := factor (('*'|'/') factor)*
    ; factor := ['-'] atom ; atom := cN | number | '(' expr ')'"""
    def atom():
        t = p.peek()
        if t == ("op", "("):
            p.next()
            e = add()
            p.expect_op(")")
            return e
        if t is not None and t[0] in ("num", "str"):
            return ("lit", _lit(p.next()))
        return ("col", _col(p.next(), n_cols))

    def factor():
        if p.peek() == ("op", "-"):
            p.next()
            f = factor()
            if f[0] == "lit" and not isinstance(f[1], _Str):
                return ("lit", -f[1])
            return ("neg", f)
        return atom()

    def term():
        e = factor()
        while p.peek() in (("op", "*"), ("op", "/"), ("op", "%")):
            op = p.next()[1]
            if op == "%":
                raise StromError(_EINVAL, "SQL: the modulo operator is "
                                          "outside this subset")
            e = ("bin", op, e, factor())
        return e

    def add():
        e = term()
        while p.peek() in (("op", "+"), ("op", "-")):
            op = p.next()[1]
            e = ("bin", op, e, term())
        return e

    return add()


class _Item:
    """One select-list item: ``kind`` "col" (``col``), "agg" (``fn``,
    ``col`` or None for ``*``, ``distinct``) or "agge" (``fn``, ``expr``
    the argument tree); ``table`` is None for a fact column, else the
    dimension of a qualified ``dim.cK``."""

    def __init__(self, kind, fn=None, col=None, distinct=False, label="",
                 table=None, expr=None):
        self.kind, self.fn, self.col = kind, fn, col
        self.distinct, self.label, self.table = distinct, label, table
        self.expr = expr
        self.alias = None


def _colref(p: _P, n_cols: int) -> Tuple[Optional[str], int]:
    """``(table | None, col)``: a bare fact column (checked now) or a
    qualified ``name.cK`` (checked when the table is bound)."""
    t = p.next()
    if t[0] == "name" and p.peek() == ("op", "."):
        p.next()
        nxt = p.next()
        m = re.fullmatch(r"[cC](\d+)", nxt[1]) if nxt[0] == "name" else None
        if not m:
            raise StromError(_EINVAL, f"SQL: expected {t[1]}.cK, got "
                                      f"{nxt[1]!r}")
        return t[1], int(m.group(1))
    return None, _col(t, n_cols)


def _parse_agg_item(p: _P, n_cols: int) -> _Item:
    fn = p.next()[1].lower()
    p.next()   # the '('
    distinct, expr, tbl, col = False, None, None, None
    if p.peek() == ("op", "*"):
        p.next()
        if fn != "count":
            raise StromError(_EINVAL, f"SQL: {fn.upper()}(*) is not a "
                                      f"thing; name a column")
        label = "count(*)"
    else:
        if p.kw("distinct"):
            distinct = True
            if fn != "count":
                raise StromError(_EINVAL, "SQL: DISTINCT only under COUNT "
                                          "in this subset")
        t2 = p.peek()
        qualified = (t2 is not None and t2[0] == "name"
                     and p.i + 1 < len(p.toks)
                     and p.toks[p.i + 1] == ("op", "."))
        if distinct or qualified:
            tbl, col = _colref(p, n_cols)
        else:
            e = _parse_expr(p, n_cols)
            if e[0] == "col":
                col = e[1]
            elif fn not in ("sum", "avg"):
                raise StromError(_EINVAL, f"SQL: {fn.upper()} over an "
                                          f"expression is outside this "
                                          f"subset (SUM/AVG take "
                                          f"arithmetic)")
            else:
                expr = e
        if expr is not None:
            label = f"{fn}({_expr_str(expr)})"
        else:
            base = f"{tbl}.c{col}" if tbl else f"c{col}"
            label = f"{fn}(distinct {base})" if distinct else f"{fn}({base})"
    p.expect_op(")")
    if expr is not None:
        return _Item("agge", fn, label=label, expr=expr)
    return _Item("agg", fn, col, distinct, label, tbl)


def _parse_select_list(p: _P, n_cols: int) -> Optional[List[_Item]]:
    """The select list; None for ``*``."""
    if p.peek() == ("op", "*"):
        p.next()
        return None
    items = []
    while True:
        t = p.peek()
        if t and t[0] == "name" and t[1].lower() in _AGGS and p.is_call():
            items.append(_parse_agg_item(p, n_cols))
        else:
            tbl, c = _colref(p, n_cols)
            items.append(_Item("col", col=c, table=tbl,
                               label=f"{tbl}.c{c}" if tbl else f"c{c}"))
        if p.kw("as"):
            alias = p.next()
            if alias[0] != "name":
                raise StromError(_EINVAL, "SQL: AS needs a name")
            items[-1].alias = alias[1]
        if p.peek() != ("op", ","):
            return items
        p.next()


def _parse_cond_leaf(p: _P, n_cols: int) -> tuple:
    """One comparison: ``("cmp", col, op, lit)``, ``("between", col, lo,
    hi)``, ``("in", col, [lits])``, ``("isnull", col, negated)`` or, where
    either side carries arithmetic or a second column, ``("cmpe", lexpr,
    op, rexpr)``."""
    # a bare string literal can only open `'lit' cmp cN`
    if p.peek() is not None and p.peek()[0] == "str":
        lit = _lit(p.next())
        op = p.next()
        if op[0] != "op" or op[1] not in _CMPS:
            raise StromError(_EINVAL, f"SQL: expected comparison, got "
                                      f"{op[1]!r}")
        c = _col(p.next(), n_cols)
        return ("cmp", c, _FLIP.get(op[1], op[1]), lit)
    left = _parse_expr(p, n_cols)
    if left[0] == "col":
        c = left[1]
        if p.kw("is"):
            neg = p.kw("not")
            p.expect_kw("null")
            return ("isnull", c, neg)
        if p.kw("between"):
            lo = _plit(p)
            p.expect_kw("and")
            return ("between", c, lo, _plit(p))
        if p.kw("in"):
            p.expect_op("(")
            lits = [_plit(p)]
            while p.peek() == ("op", ","):
                p.next()
                lits.append(_plit(p))
            p.expect_op(")")
            return ("in", c, lits)
    op = p.next()
    if op[0] != "op" or op[1] not in _CMPS:
        raise StromError(_EINVAL, f"SQL: expected comparison, got "
                                  f"{op[1]!r}")
    if p.peek() is not None and p.peek()[0] == "str":
        right = ("lit", _lit(p.next()))
    else:
        right = _parse_expr(p, n_cols)
    if left[0] == "col" and right[0] == "lit":
        return ("cmp", left[1], op[1], right[1])
    if left[0] == "lit" and right[0] == "col":   # literal cmp col: flip
        return ("cmp", right[1], _FLIP.get(op[1], op[1]), left[1])
    return ("cmpe", left, op[1], right)


def _parse_where(p: _P, n_cols: int):
    """The condition tree, with SQL precedence (AND binds tighter than OR;
    parentheses group): ``("leaf", cond) | ("and", [t..]) | ("or", [t..])
    | ("not", [t])``."""
    def factor():
        if p.kw("not"):
            return ("not", [factor()])
        if p.peek() == ("op", "("):
            # '(' opens a condition group or an arithmetic subexpression
            # ("(c0 + c1) > 5"): try the group, else backtrack to a leaf
            mark = p.i
            try:
                p.next()
                t = expr()
                p.expect_op(")")
                return t
            except StromError:
                p.i = mark
        return ("leaf", _parse_cond_leaf(p, n_cols))

    def term():
        fs = [factor()]
        while p.kw("and"):
            fs.append(factor())
        return fs[0] if len(fs) == 1 else ("and", fs)

    def expr():
        ts = [term()]
        while p.kw("or"):
            ts.append(term())
        return ts[0] if len(ts) == 1 else ("or", ts)

    return expr()


def _parse_having(p: _P, n_cols: int) -> List[tuple]:
    """``[(fn, col | None, op, lit)]``: aggregate comparisons only."""
    out = []
    while True:
        t = p.next()
        if t[0] != "name" or t[1].lower() not in _AGGS:
            raise StromError(_EINVAL, "SQL: HAVING takes aggregate "
                                      "comparisons (COUNT/SUM/AVG/MIN/MAX)")
        fn = t[1].lower()
        p.expect_op("(")
        if p.peek() == ("op", "*"):
            p.next()
            col = None
            if fn != "count":
                raise StromError(_EINVAL, f"SQL: {fn.upper()}(*) in HAVING")
        else:
            col = _col(p.next(), n_cols)
        p.expect_op(")")
        op = p.next()
        if op[0] != "op" or op[1] not in _CMPS:
            raise StromError(_EINVAL, "SQL: HAVING needs a comparison")
        lit = _plit(p)
        if isinstance(lit, _Str):
            raise StromError(_EINVAL, "SQL: HAVING against a string literal "
                                      "is outside this subset (aggregates "
                                      "compare numerically)")
        out.append((fn, col, op[1], lit))
        if not p.kw("and"):
            return out


# ---------------------------------------------------------------------------
# Arithmetic expressions
# ---------------------------------------------------------------------------

def _bin_dtype(ld: np.dtype, rd: np.dtype, op: str) -> np.dtype:
    """The type a binary node computes in (both operands cast to it).  An
    int64 or float64 operand makes the node 64-bit: int64 when every
    operand is an integer, float64 when one is a float or the operator is
    ``/``.  The JAX package types such a node by its 4-byte rule alone (it
    sums ``SUM(c * 3)`` over a float64 column as an int32); the port sums
    8-byte columns in 64 bits as its aggregates do."""
    if 8 in (ld.itemsize, rd.itemsize):
        return _F64 if op == "/" or "f" in (ld.kind, rd.kind) else _I64
    if op == "/" or np.dtype(np.float32) in (ld, rd):
        return np.dtype(np.float32)
    return np.dtype(np.int32)


def _expr_info(e, schema) -> Tuple[np.dtype, set]:
    """(result dtype, referenced columns) of an expression tree, raising
    EINVAL for shapes outside the subset: strings in arithmetic, uint32
    operands, negated uint32, integer / integer, literals outside int32,
    columns outside the schema."""
    k = e[0]
    if k == "col":
        c = int(e[1])
        if not 0 <= c < schema.n_cols:
            raise StromError(_EINVAL, f"SQL: column c{c} out of range "
                                      f"(table has {schema.n_cols})")
        dt = schema.col_dtype(c)
        if dt.kind not in "iuf":
            raise StromError(_EINVAL, f"SQL: c{c} ({dt}) in an expression")
        return dt, {c}
    if k == "lit":
        v = e[1]
        if isinstance(v, _Str):
            raise StromError(_EINVAL, "SQL: string literals cannot appear "
                                      "in arithmetic")
        if isinstance(v, int):
            if not -(1 << 31) <= v < (1 << 31):
                raise StromError(_EINVAL, f"SQL: integer literal {v} "
                                          f"outside int32 in an expression")
            return np.dtype(np.int32), set()
        return np.dtype(np.float32), set()
    if k == "neg":
        dt, cs = _expr_info(e[1], schema)
        if dt == _U32:
            raise StromError(_EINVAL, "SQL: negating a uint32 column is "
                                      "outside this subset")
        return dt, cs
    _k, op, l, r = e
    ld, lc = _expr_info(l, schema)
    rd, rc = _expr_info(r, schema)
    if _U32 in (ld, rd):
        raise StromError(_EINVAL, "SQL: uint32 columns in arithmetic are "
                                  "outside this subset (no SQL unsigned "
                                  "type to map the wraparound onto)")
    if op == "/" and ld.kind != "f" and rd.kind != "f":
        raise StromError(_EINVAL, "SQL: integer / integer is outside this "
                                  "subset (PostgreSQL truncates; use a "
                                  "float operand for float division)")
    return _bin_dtype(ld, rd, op), lc | rc


def _eval(e, cols, device) -> Tuple[torch.Tensor, np.dtype]:
    k = e[0]
    if k == "col":
        # a uint32 column (int64 here) only ever stands alone
        a = cols[int(e[1])]
        return a, _NUMPY[a.dtype]
    if k == "lit":
        v = e[1]
        dt = np.dtype(np.float32) if isinstance(v, float) \
            else np.dtype(np.int32)
        return torch.tensor(v, dtype=_TORCH[dt], device=device), dt
    if k == "neg":
        a, dt = _eval(e[1], cols, device)
        return -a, dt
    _k, op, l, r = e
    (a, ld), (b, rd) = _eval(l, cols, device), _eval(r, cols, device)
    dt = _bin_dtype(ld, rd, op)
    # explicit casts, as the JAX package's: a Python scalar would take
    # the tensor's dtype, and torch's own promotion differs from jnp's
    a, b = a.to(_TORCH[dt]), b.to(_TORCH[dt])
    if op == "+":
        return a + b, dt
    if op == "-":
        return a - b, dt
    if op == "*":
        return a * b, dt
    return a / b, dt


def _eval_expr(e, cols) -> torch.Tensor:
    """Torch evaluation of an expression tree over decoded columns, in
    the dtype :func:`_expr_info` names (a lone uint32 column comes back as
    its decode: int64 holding the unsigned value)."""
    return _eval(e, cols, cols[0].device)[0]


def _expr_str(e) -> str:
    k = e[0]
    if k == "col":
        return f"c{e[1]}"
    if k == "lit":
        return str(e[1])
    if k == "neg":
        return f"-{_expr_str(e[1])}"
    _k, op, l, r = e
    return f"({_expr_str(l)} {op} {_expr_str(r)})"


def _expr_cols(e) -> set:
    if e[0] == "col":
        return {e[1]}
    if e[0] == "lit":
        return set()
    if e[0] == "neg":
        return _expr_cols(e[1])
    return _expr_cols(e[2]) | _expr_cols(e[3])


# ---------------------------------------------------------------------------
# String columns: literals onto dictionary codes, codes back to strings
# ---------------------------------------------------------------------------

def _dict_cache(source):
    """Per-statement dictionary loader: ``get(col) -> StringDict | None``
    (no sidecar = a plain numeric column; a stale one raises EIO)."""
    path = os.fspath(source) if isinstance(source, (str, os.PathLike)) \
        else None
    cache: dict = {}

    def get(c: int):
        if c not in cache:
            try:
                cache[c] = None if path is None else load_dict(path, c)
            except FileNotFoundError:
                cache[c] = None
        return cache[c]
    return get


def _string_cmp(c: int, op: str, lit: str, d, nullable: bool):
    vals = np.asarray(d.values)
    nothing = ("in", c, [])
    if op in ("=", "=="):
        code = d.code_of(lit)
        return nothing if code is None else ("cmp", c, "=", code)
    if op in ("!=", "<>"):
        code = d.code_of(lit)
        if code is not None:
            return ("cmp", c, "!=", code)
        # every stored string differs: TRUE on each non-NULL row, UNKNOWN
        # on a NULL one (the whole code range keeps both, NOT included)
        return ("between", c, 0, len(vals) - 1) if nullable else None
    if op in ("<", "<="):
        hi = int(np.searchsorted(vals, str(lit),
                                 "left" if op == "<" else "right")) - 1
        return ("between", c, 0, hi) if hi >= 0 else nothing
    lo = int(np.searchsorted(vals, str(lit), "right" if op == ">" else "left"))
    return ("between", c, lo, len(vals) - 1) if lo < len(vals) else nothing


def _translate_cond(cond, dicts, schema) -> Optional[tuple]:
    """One leaf onto dictionary-code space; None when the leaf is TRUE on
    every row (``IS NOT NULL`` on a non-nullable column, ``!= 'absent'``
    on a non-nullable string column)."""
    if cond[0] == "isnull":
        _k, c, neg = cond
        if not schema.col_nullable(c):
            # constant-folded exactly: always TRUE or always FALSE
            return None if neg else ("in", c, [])
        return cond
    if cond[0] == "cmpe":
        # both sides type-check; no dictionary column (codes are ranks,
        # arithmetic over them would be nonsense)
        _k, l, op, r = cond
        ld, lc = _expr_info(l, schema)
        rd, rc = _expr_info(r, schema)
        for cc in sorted(lc | rc):
            if dicts(cc) is not None:
                raise StromError(_EINVAL, f"SQL: c{cc} (string column) in "
                                          f"an expression comparison")
        if _U32 in (ld, rd) and ld != rd:
            raise StromError(_EINVAL, "SQL: comparing uint32 with a "
                                      "different type is outside this "
                                      "subset")
        return cond
    c = cond[1]
    has_str = any(isinstance(x, _Str) for x in
                  (cond[2:] if cond[0] != "in" else cond[2]))
    if not has_str:
        if dicts(c) is not None:
            raise StromError(_EINVAL, f"SQL: comparing c{c} (string column) "
                                      f"with a number — use a 'string' "
                                      f"literal")
        return cond
    d = dicts(c)
    if d is None:
        raise StromError(_EINVAL, f"SQL: string literal against c{c}, which "
                                  f"has no string dictionary "
                                  f"(scan.strings.save_dict builds one)")
    if cond[0] == "cmp":
        _k, _c, op, lit = cond
        return _string_cmp(c, op, lit, d, schema.col_nullable(c))
    if cond[0] == "between":
        _k, _c, lo, hi = cond
        if not (isinstance(lo, _Str) and isinstance(hi, _Str)):
            raise StromError(_EINVAL, f"SQL: BETWEEN on c{c} mixes string "
                                      f"and numeric bounds")
        clo, chi = d.range_codes(lo, hi)
        return ("between", c, clo, chi) if clo <= chi else ("in", c, [])
    if not all(isinstance(x, _Str) for x in cond[2]):
        raise StromError(_EINVAL, f"SQL: IN list on c{c} mixes strings and "
                                  f"numbers")
    codes = [d.code_of(x) for x in cond[2]]
    return ("in", c, [x for x in codes if x is not None])


def _translate_tree(tree, dicts, schema):
    """Translate every leaf; leaves TRUE on every row simplify out (such a
    child makes an OR TRUE and drops from an AND).  None = no filter."""
    if tree is None:
        return None
    kind = tree[0]
    if kind == "leaf":
        cond = _translate_cond(tree[1], dicts, schema)
        return None if cond is None else ("leaf", cond)
    kids = [_translate_tree(t, dicts, schema) for t in tree[1]]
    if kind == "not":
        # NOT of an always-TRUE child is FALSE on every row, never UNKNOWN
        return ("not", kids) if kids[0] is not None \
            else ("leaf", ("false",))
    if kind == "or" and any(k is None for k in kids):
        return None
    kids = [k for k in kids if k is not None]
    if not kids:
        return None
    return kids[0] if len(kids) == 1 else (kind, kids)


def _decode_strings(out: dict, dicts) -> dict:
    """The result-edge decode: labels naming a dictionary column (``cN``,
    ``min(cN)``, ``max(cN)``) turn codes back into strings, None staying
    None (a NULL row, or MIN/MAX over no row)."""
    for label, v in list(out.items()):
        m = re.fullmatch(r"(?:(min|max)\()?c(\d+)\)?", label)
        if not m or v is None:
            continue
        d = dicts(int(m.group(2)))
        if d is None:
            continue
        arr = np.asarray(v)
        if arr.ndim == 0:
            out[label] = d.decode([arr.item()])[0]
        else:
            out[label] = d.decode(arr)
    return out


# ---------------------------------------------------------------------------
# WHERE in torch: SQL's three values over the decoded columns
# ---------------------------------------------------------------------------

def _cmp_np(op: str):
    return {"=": np.equal, "==": np.equal, "!=": np.not_equal,
            "<>": np.not_equal, "<": np.less, "<=": np.less_equal,
            ">": np.greater, ">=": np.greater_equal}[op]


def _term_mask(col: torch.Tensor, dt: np.dtype, op: str, v) -> torch.Tensor:
    """``col op v`` with jnp's promotion of the literal, as a FilterPred
    term compares (EINVAL where jnp raises OverflowError)."""
    kind, val = term_value(dt, v)
    return _CMP[op](compare_view(col, kind), _scalar(val, kind, col.device))


def _null_mask(cols, refs):
    """OR of the NULL masks of the referenced nullable columns: the rows
    where a comparison is UNKNOWN.  None when none is nullable."""
    u = None
    for c in sorted(refs):
        n = cols.nulls.get(c)
        if n is not None:
            u = n if u is None else (u | n)
    return u


def _leaf_refs(cond) -> set:
    if cond[0] == "cmpe":
        return _expr_cols(cond[1]) | _expr_cols(cond[3])
    return {cond[1]}


def _leaf_mask(cond, cols, schema) -> torch.Tensor:
    """The TRUE mask of one leaf (a NULL operand is never TRUE)."""
    kind = cond[0]
    if kind == "false":
        return torch.zeros(cols[0].shape, dtype=torch.bool,
                           device=cols[0].device)
    if kind == "isnull":
        _k, c, neg = cond
        n = cols.nulls.get(c)
        if n is None:
            n = torch.zeros(cols[c].shape, dtype=torch.bool,
                            device=cols[c].device)
        return ~n if neg else n
    if kind == "cmpe":
        _k, l, op, r = cond
        a, b = _eval_expr(l, cols), _eval_expr(r, cols)
        if a.dtype != b.dtype:     # checked: int and float mixing only
            dt = _TORCH[_bin_dtype(_NUMPY[a.dtype], _NUMPY[b.dtype], op)]
            a, b = a.to(dt), b.to(dt)
        m = _CMP[_TERM_OP[op]](a, b)
    else:
        c = cond[1]
        x, dt = cols[c], schema.col_dtype(c)
        if kind == "cmp":
            m = _term_mask(x, dt, _TERM_OP[cond[2]], cond[3])
        elif kind == "between":
            m = _term_mask(x, dt, "ge", cond[2]) \
                & _term_mask(x, dt, "le", cond[3])
        else:
            m = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
            for v in cond[2]:
                m = m | _term_mask(x, dt, "eq", v)
    u = _null_mask(cols, _leaf_refs(cond))
    return m if u is None else m & ~u


def _leaf_unknown(cond, cols):
    """The UNKNOWN mask of one leaf: the rows where a referenced nullable
    column is NULL (IS [NOT] NULL is never UNKNOWN).  None = no row."""
    if cond[0] in ("isnull", "false"):
        return None
    return _null_mask(cols, _leaf_refs(cond))


def _or_unknown(a, b):
    if a is None:
        return b
    return a if b is None else (a | b)


def _tree_masks(tree, cols, schema):
    """Kleene masks of a subtree: ``(true, unknown)``, *unknown* None when
    no NULL reaches it; FALSE is what is neither.  NOT swaps TRUE and
    FALSE and keeps UNKNOWN; AND is FALSE where an operand is FALSE, OR is
    TRUE where an operand is TRUE."""
    if tree[0] == "leaf":
        return _leaf_mask(tree[1], cols, schema), \
            _leaf_unknown(tree[1], cols)
    if tree[0] == "not":
        t, u = _tree_masks(tree[1][0], cols, schema)
        return (~t if u is None else ~t & ~u), u
    t, u = _tree_masks(tree[1][0], cols, schema)
    for kid in tree[1][1:]:
        t2, u2 = _tree_masks(kid, cols, schema)
        if tree[0] == "and":
            if u is not None or u2 is not None:
                f1 = ~t if u is None else ~t & ~u
                f2 = ~t2 if u2 is None else ~t2 & ~u2
                u = _or_unknown(u, u2) & ~f1 & ~f2
            t = t & t2
        else:
            t = t | t2
            if u is not None or u2 is not None:
                u = _or_unknown(u, u2) & ~t
    return t, u


def _tree_mask(tree, cols, schema) -> torch.Tensor:
    """The WHERE answer over *schema*'s decoded columns: the
    definitely-TRUE rows (UNKNOWN drops, as in SQL).  Workers rebuild the
    predicate from the shipped tree."""
    return _tree_masks(tree, cols, schema)[0]


# ---------------------------------------------------------------------------
# WHERE onto the Query: the index condition, FilterPred terms, the tree
# ---------------------------------------------------------------------------

def _promotable(cond) -> bool:
    return (cond[0] == "cmp" and cond[2] in ("=", "==")) \
        or cond[0] in ("between", "in")


def _promote(q: Query, cond) -> Query:
    if cond[0] == "cmp":
        return q.where_eq(cond[1], cond[3])
    if cond[0] == "between":
        return q.where_range(cond[1], cond[2], cond[3])
    return q.where_in(cond[1], cond[2])


def _leaf_terms(cond, schema) -> Optional[tuple]:
    """FilterPred terms whose conjunction selects exactly the TRUE rows of
    *cond* (a term compares as the tree's leaf does, and never selects a
    NULL row), or None: not a plain ``cN cmp literal`` / ``BETWEEN``, or
    a literal the column cannot meet (the tree raises its EINVAL)."""
    if cond[0] == "cmp":
        terms = ((cond[1], _TERM_OP[cond[2]], cond[3]),)
    elif cond[0] == "between":
        terms = ((cond[1], "ge", cond[2]), (cond[1], "le", cond[3]))
    else:
        return None
    for c, _op, v in terms:
        if not isinstance(v, (int, float)):
            return None
        try:
            term_value(schema.col_dtype(c), v)
        except StromError:
            return None
    return terms


def _apply_where(q: Query, tree) -> Query:
    """The first index-capable leaf of a top-level AND (or a sole leaf)
    becomes a structured filter the planner can serve from a sidecar; the
    AND's plain leaves become FilterPred terms while the 8 terms last;
    the rest (OR and NOT trees, IS NULL, expression comparisons) is one
    ``where`` callable carrying its tree, which the index path rechecks
    and worker processes rebuild."""
    if tree is None:
        return q
    kids = list(tree[1]) if tree[0] == "and" else [tree]
    pick = next((i for i, k in enumerate(kids)
                 if k[0] == "leaf" and _promotable(k[1])), None)
    if pick is not None:
        q = _promote(q, kids.pop(pick)[1])
    room = MAX_TERMS - len(q._terms)
    terms, rest = [], []
    for k in kids:
        t = _leaf_terms(k[1], q.schema) if k[0] == "leaf" else None
        if t is not None and len(terms) + len(t) <= room:
            terms.extend(t)
        else:
            rest.append(k)
    if terms:
        q = q.where(FilterPred(tuple(terms)))
    if rest:
        r = rest[0] if len(rest) == 1 else ("and", rest)
        q = q.where(lambda cols, r=r, s=q.schema: _tree_mask(r, cols, s),
                    _tree=r)
    return q


def _having_fn(havings: List[tuple], agg_cols: List[int]):
    if not havings:
        return None

    def hv(res, havings=havings, agg_cols=agg_cols):
        m = np.ones(len(np.asarray(res["count"])), bool)
        for fn, col, op, lit in havings:
            if fn == "count":
                vals = np.asarray(res["count"])
            else:
                if col not in agg_cols:
                    raise StromError(_EINVAL, f"SQL: HAVING {fn}(c{col}) "
                                              f"needs c{col} aggregated in "
                                              f"the SELECT list")
                vals = np.asarray(res[_FIELD[fn]][agg_cols.index(col)])
            m = m & _cmp_np(op)(vals, lit)
        return m
    return hv


# ---------------------------------------------------------------------------
# The statement mapper
# ---------------------------------------------------------------------------

_JOIN_TYPES = ("inner", "left", "semi", "anti")


def _refuse_string_join(dicts, probe_col: int, dpath, key_col: int) -> None:
    """Two string columns carry codes of separate dictionaries: joining
    them would compare incomparable ranks."""
    if dicts(probe_col) is not None or (
            isinstance(dpath, (str, os.PathLike))
            and os.path.exists(dict_path_for(os.fspath(dpath), key_col))):
        raise StromError(_EINVAL, "SQL: JOIN on string-dictionary columns "
                                  "is outside this subset (separate "
                                  "dictionaries make codes incomparable)")


def _bound_table(tables, dname: str):
    if not tables or dname not in tables:
        raise StromError(_EINVAL, f"SQL: JOIN table {dname!r} not bound "
                                  f"(pass tables={{{dname!r}: (path, "
                                  f"schema)}})")
    return tables[dname]


def _sum_or_avg(fn: str, s, nn: int):
    """SQL's ``SUM``/``AVG`` of a column whose sum is *s* over *nn*
    non-NULL cells: NULL (None) when there is none."""
    if not nn:
        return None
    return s if fn == "sum" else s / nn


def _build_star(q: Query, joins, items, tables, limit, off, dicts):
    """The statement with two or more JOINs: every dimension probes in
    the same scan (:meth:`.query.Query.star_join`).  Faces: additive
    aggregates (COUNT(*), SUM/AVG over fact columns or expressions,
    SUM/AVG(dim.cK)) or the rows (fact columns and dimension payloads; a
    LEFT dimension adds ``matched_<dim>``)."""
    if items is None:
        raise StromError(_EINVAL, "SQL: JOIN needs an explicit select list")
    dim_names = [dname for _h, dname, _pc, _kc in joins]
    payload: dict = {}
    for it in items:
        if it.table is not None:
            if it.table not in dim_names:
                raise StromError(_EINVAL, f"SQL: unknown table "
                                          f"{it.table!r}")
            payload.setdefault(it.table, set()).add(it.col)
    specs = []
    for how, dname, pc, kc in joins:
        dpath, dschema = _bound_table(tables, dname)
        if not 0 <= kc < dschema.n_cols:
            raise StromError(_EINVAL, f"SQL: {dname}.c{kc} out of range")
        _refuse_string_join(dicts, pc, dpath, kc)
        cols_ref = sorted(payload.get(dname, ()))
        if len(cols_ref) > 1:
            raise StromError(_EINVAL, f"SQL: one {dname}.cK column per "
                                      f"dimension in this subset")
        if cols_ref and how in ("semi", "anti"):
            raise StromError(_EINVAL, f"SQL: {how.upper()} JOIN does not "
                                      f"expose {dname} columns (EXISTS "
                                      f"semantics)")
        vc = cols_ref[0] if cols_ref else None
        if vc is not None and not 0 <= vc < dschema.n_cols:
            raise StromError(_EINVAL, f"SQL: {dname}.c{vc} out of range")
        specs.append({"probe_col": pc, "table": dpath, "schema": dschema,
                      "key_col": kc, "value_col": vc, "how": how})
    dim_idx = {dname: i for i, dname in enumerate(dim_names)}
    agg_items = [it for it in items if it.kind in ("agg", "agge")]
    if agg_items and len(agg_items) != len(items):
        raise StromError(_EINVAL, "SQL: JOIN mixes aggregates and bare "
                                  "columns")
    if agg_items:
        if limit is not None:
            raise StromError(_EINVAL, "SQL: LIMIT on a join aggregate")
        exprs, eidx = [], {}
        for it in agg_items:
            if it.kind == "agge":
                eidx[id(it)] = len(exprs)
                exprs.append(it.expr)
                continue
            ok = (it.fn == "count" and it.col is None and not it.distinct) \
                or (it.fn in ("sum", "avg") and not it.distinct
                    and it.col is not None)
            if not ok:
                raise StromError(_EINVAL, f"SQL: {it.label} with a star "
                                          f"join is outside this subset")
            if it.table is None and it.fn in ("sum", "avg") \
                    and dicts(it.col) is not None:
                raise StromError(_EINVAL, f"SQL: {it.label} over a string "
                                          f"column")
        q = q.star_join(specs, exprs=exprs)

        def assemble(res):
            out = {}
            n = int(res["count"])
            for it in agg_items:
                if it.fn == "count" and it.kind != "agge":
                    out[it.label] = n
                    continue
                if it.kind == "agge":
                    s = np.asarray(res["esums"][eidx[id(it)]]).item()
                    nn = n
                elif it.table is None:
                    # NULL cells are skipped: the non-NULL count
                    s = np.asarray(res["sums"][it.col]).item()
                    nnc = res.get("nncounts")
                    nn = n if nnc is None else int(np.asarray(nnc[it.col]))
                else:
                    # the payload of the rows with a partner there
                    i = dim_idx[it.table]
                    s = np.asarray(res["pay_sums"][i]).item()
                    nn = n - int(np.asarray(res["null_counts"][i]))
                out[it.label] = _sum_or_avg(it.fn, s, nn)
            return out
        return q, assemble
    fact_cols = []
    for it in items:
        if it.table is None and it.col not in fact_cols:
            fact_cols.append(it.col)
    q = q.star_join(specs, materialize=True, fact_cols=fact_cols,
                    limit=limit, offset=off)

    def assemble(res):
        out = {}
        for it in items:
            key = f"c{it.col}" if it.table is None \
                else f"pay{dim_idx[it.table]}"
            out[it.label] = np.asarray(res[key])
        for how, dname, _pc, _kc in joins:
            if how == "left":   # the per-dimension NULL indicator
                out[f"matched_{dname}"] = np.asarray(
                    res[f"m{dim_idx[dname]}"])
        out["positions"] = np.asarray(res["positions"])
        return out
    return q, assemble


def _build_join(q: Query, join, items, tables, limit, off, dicts):
    """The statement with one JOIN: the aggregate face (COUNT(*), SUM over
    fact columns or the payload) or the joined rows (the probe column and
    one payload column; LEFT adds ``matched``)."""
    how, dname, probe_col, key_col = join
    dpath, dschema = _bound_table(tables, dname)
    if items is None:
        raise StromError(_EINVAL, "SQL: JOIN needs an explicit select list")
    if not 0 <= key_col < dschema.n_cols:
        raise StromError(_EINVAL, f"SQL: {dname}.c{key_col} out of range")
    _refuse_string_join(dicts, probe_col, dpath, key_col)
    for it in items:
        if it.kind == "agge":
            raise StromError(_EINVAL, f"SQL: {it.label} with a single JOIN "
                                      f"is outside this subset (star "
                                      f"statements serve expression "
                                      f"aggregates)")
        if it.table is not None and it.table != dname:
            raise StromError(_EINVAL, f"SQL: unknown table {it.table!r}")
    dim_cols = sorted({it.col for it in items if it.table == dname})
    if len(dim_cols) > 1:
        raise StromError(_EINVAL, f"SQL: one {dname}.cK column per join in "
                                  f"this subset")
    if dim_cols and how in ("semi", "anti"):
        raise StromError(_EINVAL, f"SQL: {how.upper()} JOIN does not expose "
                                  f"{dname} columns (EXISTS semantics)")
    value_col = dim_cols[0] if dim_cols else key_col
    if not 0 <= value_col < dschema.n_cols:
        raise StromError(_EINVAL, f"SQL: {dname}.c{value_col} out of range")
    agg_items = [it for it in items if it.kind == "agg"]
    if agg_items and len(agg_items) != len(items):
        raise StromError(_EINVAL, "SQL: JOIN mixes aggregates and bare "
                                  "columns")
    if agg_items:
        if limit is not None:
            raise StromError(_EINVAL, "SQL: LIMIT on a join aggregate")
        for it in agg_items:
            if not ((it.fn == "count" and it.col is None)
                    or (it.fn == "sum" and not it.distinct)):
                raise StromError(_EINVAL, f"SQL: {it.label} with JOIN is "
                                          f"outside this subset")
        q = q.join_table(probe_col, dpath, dschema, key_col, value_col,
                         how=how)

        def assemble(res):
            out = {}
            n = int(res["matched"])
            for it in agg_items:
                if it.fn == "count":
                    out[it.label] = n
                elif it.table is None:
                    nnc = res.get("nncounts")   # a nullable fact column
                    out[it.label] = _sum_or_avg(
                        "sum", np.asarray(res["sums"][it.col]).item(),
                        n if nnc is None else int(np.asarray(nnc[it.col])))
                else:
                    # a LEFT join's unpartnered rows have no payload
                    out[it.label] = _sum_or_avg(
                        "sum", np.asarray(res["payload_sum"]).item(),
                        n - int(np.asarray(res.get("null_count", 0))))
            return out
        return q, assemble
    for it in items:
        if it.table is None and it.col != probe_col:
            raise StromError(_EINVAL, f"SQL: the row face serves the probe "
                                      f"column c{probe_col} and {dname}.cK; "
                                      f"fetch() other fact columns by "
                                      f"position")
    q = q.join_table(probe_col, dpath, dschema, key_col, value_col,
                     materialize=True, limit=limit, offset=off, how=how)

    def assemble(res):
        out = {it.label: np.asarray(res["keys"] if it.table is None
                                    else res["payload"]) for it in items}
        out["positions"] = np.asarray(res["positions"])
        if "matched" in res:   # the LEFT face's NULL indicator
            out["matched"] = np.asarray(res["matched"])
        return out
    return q, assemble


def _build_group(q: Query, items, group_cols, havings, order, limit, off,
                 dicts):
    """GROUP BY (and SELECT DISTINCT): ``group_by_cols``; ORDER BY a key
    or an aggregate sorts the finished groups (the top-N groups)."""
    if items is None:
        raise StromError(_EINVAL, "SQL: GROUP BY needs an explicit select "
                                  "list (group cols + aggregates)")
    agg_cols: List[int] = []
    for it in items:
        if it.kind == "agge":
            raise StromError(_EINVAL, f"SQL: {it.label} under GROUP BY is "
                                      f"outside this subset (expression "
                                      f"aggregates are scalar-only)")
        if it.kind == "col":
            if it.col not in group_cols:
                raise StromError(_EINVAL, f"SQL: c{it.col} is neither "
                                          f"grouped nor aggregated")
        elif it.fn == "count" and it.col is None and not it.distinct:
            pass
        elif it.fn in ("sum", "avg", "min", "max"):
            if it.fn in ("sum", "avg") and dicts(it.col) is not None:
                raise StromError(_EINVAL, f"SQL: {it.label} over a string "
                                          f"column (codes would sum "
                                          f"meaninglessly; MIN/MAX/COUNT "
                                          f"are the string aggregates)")
            if it.col not in agg_cols:
                agg_cols.append(it.col)
        else:
            raise StromError(_EINVAL, f"SQL: {it.label} under GROUP BY is "
                                      f"outside this subset")
    for _fn, col, _op, _lit_ in havings:
        if col is not None and col not in agg_cols:
            agg_cols.append(col)
    # an ORDER BY aggregate may need aggregating though unselected
    if order is not None and order[0][0] == "agg" \
            and order[0][2] is not None and order[0][2] not in agg_cols:
        agg_cols.append(order[0][2])
    if order is not None and order[0][0] == "cols":
        raise StromError(_EINVAL, "SQL: multi-key ORDER BY on grouped "
                                  "results is outside this subset")
    if order is not None and order[0][0] == "col" \
            and order[0][1] not in group_cols:
        raise StromError(_EINVAL, f"SQL: ORDER BY c{order[0][1]} is neither "
                                  f"grouped nor an aggregate")
    # a COUNT(*)-only statement aggregates the first key column (its sums
    # go unused)
    eff_aggs = agg_cols or [group_cols[0]]
    q = q.group_by_cols(group_cols, agg_cols=eff_aggs,
                        having=_having_fn(havings, eff_aggs))

    def assemble(res):
        def field(kind, fn=None, col=None):
            if kind == "col":
                return np.asarray(res["key_cols"][group_cols.index(col)])
            if fn == "count":
                return np.asarray(res["count"])
            return np.asarray(res[_FIELD[fn]][eff_aggs.index(col)])

        perm = np.arange(len(np.asarray(res["count"])))
        if order is not None:
            okey, desc = order
            vals = field(*okey) if okey[0] == "agg" \
                else field("col", col=okey[1])
            perm = np.argsort(vals, kind="stable")
            if desc:
                perm = perm[::-1]
        if order is not None or limit is not None or off:
            perm = perm[off:None if limit is None else off + limit]
        return {it.label: field(it.kind, it.fn, it.col)[perm]
                for it in items}
    return q, assemble


def _with_nulls(arr: np.ndarray, nulls) -> np.ndarray:
    """*arr* as an object array with None at the NULL rows (a nullable
    column at the result's edge: never a stored word)."""
    if nulls is None:
        return arr
    obj = arr.astype(object)
    obj[np.asarray(nulls).astype(bool)] = None
    return obj


def _build_order(q: Query, items, order, limit, off, source, schema):
    """ORDER BY outside GROUP BY: ``order_by``; the other selected columns
    are fetched by position, NULLs kept."""
    okey, desc = order
    if okey[0] == "agg":
        raise StromError(_EINVAL, "SQL: ORDER BY an aggregate requires "
                                  "GROUP BY")
    ocols = [okey[1]] if okey[0] == "col" else list(okey[1])
    oc = ocols[0]
    extra: List[int] = []
    if items is not None:
        for it in items:
            if it.kind != "col":
                raise StromError(_EINVAL, "SQL: ORDER BY with aggregates "
                                          "requires GROUP BY")
            if it.col != oc and it.col not in extra:
                extra.append(it.col)
        labels = [it.label for it in items]
    else:
        extra = [c for c in range(schema.n_cols) if c != oc]
        labels = [f"c{c}" for c in range(schema.n_cols)]
    q = q.order_by(ocols, descending=desc, limit=limit, offset=off)

    def assemble(res, session=None, device=None):
        pos = np.asarray(res["positions"])
        out = {f"c{oc}": np.asarray(res["values"])}
        if extra:
            # point lookups by position, in the sorted order, on the
            # caller's session and device
            fetched = Query(source, schema).fetch(
                pos, cols=extra, session=session, device=device)
            for c in extra:
                out[f"c{c}"] = _with_nulls(np.asarray(fetched[f"col{c}"]),
                                           fetched.get(f"null{c}"))
        return {**{lbl: out[lbl] for lbl in labels}, "positions": pos}
    return q, assemble


def _build_select(q: Query, items, limit, off):
    cols = None if items is None else [it.col for it in items]
    q = q.select(cols, limit=limit, offset=off)

    def assemble(res):
        sel = cols if cols is not None else \
            [int(k[3:]) for k in res if k.startswith("col")]
        out = {f"c{c}": _with_nulls(np.asarray(res[f"col{c}"]),
                                    res.get(f"null{c}")) for c in sel}
        out["positions"] = np.asarray(res["positions"])
        return out
    return q, assemble


def _build_scalar(q: Query, items, limit, dicts):
    """Aggregates without GROUP BY: ``aggregate``, ``aggregate_exprs``,
    ``count_distinct`` or a sole MIN/MAX's ``top_k``."""
    if limit is not None:
        raise StromError(_EINVAL, "SQL: LIMIT on a scalar aggregate")
    aggs = [it for it in items if it.kind == "agg"]
    agges = [it for it in items if it.kind == "agge"]
    if len(aggs) + len(agges) != len(items):
        raise StromError(_EINVAL, "SQL: mixing bare columns with aggregates "
                                  "needs GROUP BY")
    if agges:
        # an expression aggregate takes the whole list through the
        # expression terminal (a plain SUM(cN) as the ("col", c) tree)
        trees, tmap = [], {}
        for it in items:
            if it.kind == "agge":
                tmap[id(it)] = len(trees)
                trees.append(it.expr)
            elif it.fn == "count" and it.col is None and not it.distinct:
                pass
            elif it.fn in ("sum", "avg") and not it.distinct:
                if dicts(it.col) is not None:
                    raise StromError(_EINVAL, f"SQL: {it.label} over a "
                                              f"string column")
                tmap[id(it)] = len(trees)
                trees.append(("col", it.col))
            else:
                raise StromError(_EINVAL, f"SQL: {it.label} cannot combine "
                                          f"with expression aggregates")
        q = q.aggregate_exprs(trees)

        def assemble(res):
            out = {}
            n = int(res["count"])
            for it in items:
                if it.kind == "agg" and it.fn == "count":
                    out[it.label] = n
                    continue
                out[it.label] = _sum_or_avg(
                    it.fn, np.asarray(res["esums"][tmap[id(it)]]).item(), n)
            return out
        return q, assemble
    if len(aggs) == 1 and aggs[0].distinct:
        lbl = aggs[0].label
        return q.count_distinct(aggs[0].col), \
            (lambda res: {lbl: int(res["distinct"])})
    if len(aggs) == 1 and aggs[0].fn in ("min", "max"):
        it = aggs[0]
        q = q.top_k(it.col, 1, largest=(it.fn == "max"))

        def assemble(res):
            vals = np.asarray(res["values"])
            poss = np.asarray(res["positions"])
            empty = len(vals) == 0 or int(poss[0]) < 0
            return {it.label: None if empty else vals[0].item()}
        return q, assemble
    sum_cols: List[int] = []
    for it in aggs:
        if it.fn in ("sum", "avg") or (it.fn == "count"
                                       and it.col is not None
                                       and not it.distinct):
            # COUNT(cN) is the non-NULL count: it rides the same slot
            if it.fn != "count" and dicts(it.col) is not None:
                raise StromError(_EINVAL, f"SQL: {it.label} over a string "
                                          f"column (MIN/MAX/COUNT are the "
                                          f"string aggregates)")
            if it.col not in sum_cols:
                sum_cols.append(it.col)
        elif not (it.fn == "count" and it.col is None):
            raise StromError(_EINVAL, f"SQL: {it.label} cannot combine with "
                                      f"other aggregates without GROUP BY")
    q = q.aggregate(cols=sum_cols or None)

    def assemble(res):
        out = {}
        n = int(res["count"])
        nnc = res.get("nncounts")   # present iff a column is nullable

        def denom(col):
            return int(np.asarray(nnc[sum_cols.index(col)])) \
                if nnc is not None else n
        for it in aggs:
            if it.fn == "count":
                out[it.label] = n if it.col is None else denom(it.col)
            else:
                out[it.label] = _sum_or_avg(
                    it.fn, np.asarray(res["sums"][sum_cols.index(it.col)])
                    .item(), denom(it.col))
        return out
    return q, assemble


def _parse_order(p: _P, n_cols: int):
    """ORDER BY's ``(key, descending)``: ``("col", c)``, ``("cols",
    [c..])`` or ``("agg", fn, col | None)``."""
    t2 = p.peek()
    if t2 and t2[0] == "name" and t2[1].lower() in _AGGS and p.is_call():
        fn = p.next()[1].lower()
        p.next()   # '('
        if p.peek() == ("op", "*"):
            p.next()
            ocol = None
            if fn != "count":
                raise StromError(_EINVAL, f"SQL: {fn.upper()}(*)")
        else:
            ocol = _col(p.next(), n_cols)
            if fn == "count":
                raise StromError(_EINVAL, "SQL: COUNT takes (*) in this "
                                          "subset (COUNT(cN) would silently "
                                          "mean COUNT(*))")
        p.expect_op(")")
        okey = ("agg", fn, ocol)
    else:
        ocols = [_col(p.next(), n_cols)]
        while p.peek() == ("op", ","):
            p.next()
            ocols.append(_col(p.next(), n_cols))
        okey = ("col", ocols[0]) if len(ocols) == 1 else ("cols", ocols)
    desc = p.kw("desc")
    if not desc:
        p.kw("asc")
    return okey, desc


def _parse_joins(p: _P, n_cols: int) -> List[tuple]:
    """``[(how, dim_name, probe_col, dim_key_col)]``."""
    joins: List[tuple] = []
    while True:
        nxt = p.peek()
        how = "inner"
        if nxt and nxt[0] == "name" and nxt[1].lower() in _JOIN_TYPES:
            how = p.next()[1].lower()
            p.expect_kw("join")  # "FROM t LEFT ..." can be nothing else
        elif not p.kw("join"):
            return joins
        dn = p.next()
        if dn[0] != "name":
            raise StromError(_EINVAL, "SQL: JOIN needs a table name")
        p.expect_kw("on")
        lt, lc = _colref(p, n_cols)
        p.expect_op("=")
        rt, rc = _colref(p, n_cols)
        sides = {lt: lc, rt: rc}
        if None not in sides or dn[1] not in sides:
            raise StromError(_EINVAL, f"SQL: ON must equate a fact column "
                                      f"with a {dn[1]}.cK column")
        if any(j[1] == dn[1] for j in joins):
            raise StromError(_EINVAL, f"SQL: table {dn[1]!r} joined twice")
        joins.append((how, dn[1], sides[None], sides[dn[1]]))


def _parse_sql_raw(sql: str, source, schema, tables: Optional[dict],
                   dicts, aliases: dict, workers: int):
    n_cols = schema.n_cols
    p = _P(_tokenize(sql))
    p.expect_kw("select")
    select_distinct = p.kw("distinct")
    items = _parse_select_list(p, n_cols)
    if items:
        aliases.update({it.label: it.alias for it in items if it.alias})
    p.expect_kw("from")
    t = p.next()
    if t[0] != "name":
        raise StromError(_EINVAL, f"SQL: FROM needs a table name, got "
                                  f"{t[1]!r}")
    joins = _parse_joins(p, n_cols)
    where_tree = _parse_where(p, n_cols) if p.kw("where") else None
    where_tree = _translate_tree(where_tree, dicts, schema)
    group_cols: Optional[List[int]] = None
    if p.kw("group"):
        p.expect_kw("by")
        group_cols = [_col(p.next(), n_cols)]
        while p.peek() == ("op", ","):
            p.next()
            group_cols.append(_col(p.next(), n_cols))
    havings = _parse_having(p, n_cols) if p.kw("having") else []
    order = None
    if p.kw("order"):
        p.expect_kw("by")
        order = _parse_order(p, n_cols)
    limit = offset = None
    if p.kw("limit"):
        limit = int(_plit(p))
    if p.kw("offset"):
        offset = int(_plit(p))
    if p.peek() is not None:
        raise StromError(_EINVAL, f"SQL: trailing input at "
                                  f"{p.peek()[1]!r}")
    if havings and group_cols is None:
        raise StromError(_EINVAL, "SQL: HAVING requires GROUP BY")
    if not joins and items is not None:
        for it in items:
            if it.table is not None:
                raise StromError(_EINVAL, f"SQL: {it.label} references a "
                                          f"table with no JOIN")
    if select_distinct:
        if items is None or any(it.kind != "col" or it.table is not None
                                for it in items):
            raise StromError(_EINVAL, "SQL: SELECT DISTINCT takes 1-2 plain "
                                      "fact columns")
        if group_cols is not None or len(joins) == 1:
            raise StromError(_EINVAL, "SQL: SELECT DISTINCT with GROUP BY/"
                                      "JOIN is outside this subset")
        group_cols = list(dict.fromkeys(it.col for it in items))
    q = _apply_where(Query(source, schema, workers=workers), where_tree)
    off = offset or 0
    if joins and (group_cols is not None or havings or order is not None):
        raise StromError(_EINVAL, "SQL: GROUP BY/HAVING/ORDER BY with JOIN "
                                  "are outside this subset")
    if len(joins) >= 2:
        return _build_star(q, joins, items, tables, limit, off, dicts)
    if joins:
        return _build_join(q, joins[0], items, tables, limit, off, dicts)
    if group_cols is not None:
        return _build_group(q, items, group_cols, havings, order, limit, off,
                            dicts)
    if order is not None:
        return _build_order(q, items, order, limit, off, source, schema)
    if items is None or all(it.kind == "col" for it in items):
        return _build_select(q, items, limit, off)
    return _build_scalar(q, items, limit, dicts)


def parse_sql(sql: str, source, schema, tables: Optional[dict] = None,
              workers: int = 0):
    """Parse *sql* against *source* / *schema*: ``(query, assemble)``,
    where ``assemble(run_result) -> dict`` relabels the terminal's output
    with the statement's select-list names, dictionary-encoded string
    columns decoded back to strings.  *tables* binds JOIN dimension names
    to ``(path, schema)``; ``workers=N`` plans the scan over N worker
    processes (the predicate trees ship to them)."""
    aliases: dict = {}
    dicts = _dict_cache(source)
    q, assemble = _parse_sql_raw(sql, source, schema, tables, dicts,
                                 aliases, workers)

    def assemble_decoded(res, **kw):
        # decode first: the decode reads the unaliased labels
        out = _decode_strings(assemble(res, **kw), dicts)
        return {aliases.get(k, k): v for k, v in out.items()}

    assemble_decoded.__signature__ = inspect.signature(assemble)
    return q, assemble_decoded


def sql_query(sql: str, source, schema, tables: Optional[dict] = None,
              **run_kw) -> dict:
    """Parse and run in one call: the select-list-labelled result.
    *run_kw* go to :meth:`.query.Query.run` (``device``, ``kernel``,
    ``mesh``, ``batch_pages``, ``session``, ``analyze``, ``workers``);
    ``session`` and ``device`` also reach the ORDER BY assembler's
    point lookups (over a mesh, on its first member of this process)."""
    q, assemble = parse_sql(sql, source, schema, tables=tables,
                            workers=int(run_kw.get("workers") or 0))
    res = q.run(**run_kw)
    params = inspect.signature(assemble).parameters
    look = {k: run_kw[k] for k in ("session", "device") if k in run_kw}
    if run_kw.get("mesh") is not None:
        look["device"] = run_kw["mesh"].home()
    out = assemble(res, **{k: v for k, v in look.items() if k in params})
    for k in ("_analyze", "_workers"):
        if isinstance(res, dict) and k in res:
            out[k] = res[k]
    return out


def _left_join_nulls(out: dict) -> dict:
    """LEFT-join NULL indicators as real NULLs: the unaliased payload
    labels (``<dim>.cK``) become nullable columns masked by their
    indicator, which drops.  Aliased payloads keep the indicator."""
    null_of: dict = {}
    for key in [k for k in out if k == "matched" or k.startswith("matched_")]:
        prefix = "" if key == "matched" else key[len("matched_"):] + "."
        hits = [lbl for lbl in out if "." in lbl and lbl.startswith(prefix)]
        if hits:
            m = ~np.asarray(out.pop(key)).astype(bool)
            for lbl in hits:
                null_of[lbl] = m
    return null_of


def create_table_as(dest_path: str, sql: str, source, schema,
                    tables: Optional[dict] = None, overwrite: bool = False,
                    **run_kw):
    """CREATE TABLE AS: run *sql* and write its result as a new heap table
    at *dest_path*, which requeries with the whole scan machinery.

    Every equal-length result column becomes a table column in select-list
    order: ints land as int32 (range-checked, ERANGE rather than a wrap),
    uint as uint32, floats as float32, and string columns re-encode with a
    fresh sorted dictionary saved as the new table's sidecar (stamped after
    the table is written).  NULLs (a nullable column projected, a LEFT
    join's unpartnered payload) become nullable columns.  A scalar result
    builds a 1-row table; ``positions`` drops.  An existing *dest_path* is
    EEXIST unless ``overwrite=True``.  Returns ``(dest_schema, n_rows)``."""
    if os.path.exists(dest_path) and not overwrite:
        raise StromError(_errno.EEXIST, f"CREATE TABLE AS: {dest_path} "
                                        f"exists (overwrite=True replaces "
                                        f"it)")
    out = sql_query(sql, source, schema, tables=tables, **run_kw)
    for k in ("_analyze", "_workers", "positions"):
        out.pop(k, None)     # telemetry and row provenance, not data
    null_of = _left_join_nulls(out)
    cols, dts, dict_cols, nullable, nulls = [], [], {}, [], {}
    n_rows = None

    def add(arr, dt, mask):
        has = mask is not None and bool(mask.any())
        if has:
            nulls[len(cols)] = mask
        nullable.append(has)
        cols.append(arr)
        dts.append(dt)

    for label, v in out.items():
        if v is None:
            # MIN over zero rows: the heap has no scalar NULL
            raise StromError(_EINVAL, f"CREATE TABLE AS: {label!r} is NULL "
                                      f"(aggregate over zero rows) — no "
                                      f"NULL scalar representation in the "
                                      f"heap format")
        arr = np.asarray([v]) if np.isscalar(v) else np.asarray(v)
        arr = arr.reshape(-1)
        if arr.dtype.kind in "US":
            arr = arr.astype(object)
        if n_rows is None:
            n_rows = len(arr)
        elif len(arr) != n_rows:
            raise StromError(_EINVAL, f"CREATE TABLE AS: column {label!r} "
                                      f"has {len(arr)} rows, expected "
                                      f"{n_rows} (mixed result faces)")
        mask = null_of.get(label)
        if arr.dtype.kind == "O":
            present = [x for x in arr if x is not None]
            if any(isinstance(x, str) for x in present):
                if len(present) != len(arr) or mask is not None:
                    raise StromError(_EINVAL, f"CREATE TABLE AS: {label!r} "
                                              f"mixes strings and NULLs "
                                              f"(nullable string columns "
                                              f"are outside this subset)")
                d = StringDict(arr.tolist())
                dict_cols[len(cols)] = d
                add(d.encode(arr.tolist()), "uint32", None)
                continue
            # a numeric column with None holes: real NULLs round-trip
            om = np.array([x is None for x in arr], dtype=bool)
            mask = om if mask is None else (mask | om)
            isf = any(isinstance(x, float) for x in present)
            arr = np.array([0 if x is None else x for x in arr],
                           dtype=np.float64 if isf else np.int64)
        if arr.dtype.kind == "f":
            f32 = arr.astype(np.float32)
            if mask is not None:
                f32 = np.where(mask, np.float32(0), f32)
            add(f32, "float32", mask)
        elif arr.dtype.kind == "u":
            if len(arr) and int(arr.max()) > 0xFFFFFFFF:
                raise StromError(_errno.ERANGE, f"CREATE TABLE AS: "
                                                f"{label!r} exceeds uint32")
            add(arr.astype(np.uint32), "uint32", mask)
        else:
            live = arr if mask is None else arr[~mask]
            if len(live) and (int(live.min()) < -(1 << 31)
                              or int(live.max()) >= (1 << 31)):
                raise StromError(_errno.ERANGE, f"CREATE TABLE AS: "
                                                f"{label!r} exceeds int32")
            add((arr if mask is None else np.where(mask, 0, arr))
                .astype(np.int32), "int32", mask)
    if not cols:
        raise StromError(_EINVAL, "CREATE TABLE AS: the statement returned "
                                  "no columns")
    dest_schema = HeapSchema(n_cols=len(cols), visibility=False,
                             dtypes=tuple(dts),
                             nullable=tuple(nullable) if any(nullable)
                             else None)
    build_heap_file(dest_path, cols, dest_schema, nulls=nulls or None)
    for c, d in dict_cols.items():
        save_dict(dest_path, c, d)
    return dest_schema, n_rows
