"""strom_query — run a declarative scan query from the command line.

The CLI face of :mod:`..scan.query` and :mod:`..scan.sql`, the way psql is
the CLI face of the reference's transparent CustomScan
(`pgsql/nvme_strom.c:1642-1667`): the user states what (filter, aggregate,
group, top-k, SQL), the planner decides how (direct or vfs path, the CUDA
kernels or the torch route) and ``--explain`` shows the decision without
running it.  A port of the JAX package's ``tools/strom_query.py``.

Usage:
  strom_query_gpu FILE --cols 3 [--dtypes int32,float32,int32] [--visibility]
              [--where "c0 > 10"] [--where-eq/-range/-in ...]
              [--group-by "c1 % 8" --groups 8 | --group-by-cols 0,1]
              [--top-k COL:K[:smallest]] [--agg-cols 0,1]
              [--select COLS|all --limit N --offset M]
              [--join COL:TABLE --join-how inner|left|semi|anti]
              [--sql "SELECT ..." [--sql-table d=DIM.heap:2]
                                  [--sql-create DEST]]
              [--explain] [--analyze] [--kernel auto|cuda|torch] [--mesh]
              [-d DEV]

The query runs on cuda:0 unless ``-d`` names another device (``-d cpu``
runs the torch route on the host).  Predicates and keys are restricted
expressions over the columns c0..cN-1 (and abs, minimum, maximum, where,
torch), evaluated with eval() on a whitelisted namespace over the decoded
torch columns: an operator convenience, not a security boundary.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import math
import struct
import sys
import types

import numpy as np
import torch

from ..api import StromError
from ..scan.heap import HeapSchema

__all__ = ["main", "cli"]


def _compile_whitelisted(expr: str, label: str, name_error):
    """Compile an eval'd CLI expression (--where, --group-by, --having) and
    refuse any name *name_error* flags (it returns an error string, or
    None for an allowed name).  The check recurses into nested code
    objects (lambdas, comprehensions): their names live in the inner code
    object, and an attribute chain such as ``().__class__.__bases__``
    inside a lambda would otherwise slip past."""
    def check(code):
        for name in code.co_names + code.co_varnames + code.co_freevars:
            msg = name_error(name)
            if msg:
                raise SystemExit(f"error: {msg}")
        for const in code.co_consts:
            if isinstance(const, types.CodeType):
                check(const)

    code = compile(expr, f"<strom_query:{label}>", "eval")
    check(code)
    return code


def _eval_sandboxed(code, ns: dict):
    return eval(code, {"__builtins__": {}}, ns)


def _expr_fn(expr: str, n_cols: int):
    """"c0 > 10"-style expressions as ``fn(cols)`` over the decoded torch
    columns, on a whitelisted namespace (no builtins)."""
    def name_error(name):
        if name.startswith("c") and name[1:].isdigit():
            if int(name[1:]) >= n_cols:
                return (f"{name} out of range — this schema has columns "
                        f"c0..c{n_cols - 1}")
            return None
        if name in ("abs", "minimum", "maximum", "where", "torch"):
            return None
        return (f"name {name!r} not allowed in expressions (use "
                f"c0..c{n_cols - 1}, abs, minimum, maximum, where)")

    code = _compile_whitelisted(expr, "expr", name_error)

    def fn(cols):
        ns = {f"c{i}": cols[i] for i in range(len(cols))}
        ns.update(abs=torch.abs, minimum=torch.minimum,
                  maximum=torch.maximum, where=torch.where, torch=torch)
        return _eval_sandboxed(code, ns)

    return fn


def _having_fn(expr: str):
    """A HAVING expression over the finished numpy group arrays (count,
    sums, mins, maxs, avgs, ...) on the same sandbox as :func:`_expr_fn`."""
    allowed = ("count", "sums", "sumsqs", "mins", "maxs", "avgs", "vars",
               "stds", "abs", "minimum", "maximum", "where", "np")
    code = _compile_whitelisted(
        expr, "having",
        lambda name: None if name in allowed else
        f"name {name!r} not allowed in --having (use {', '.join(allowed)})")

    def fn(groups):
        ns = dict(groups)
        ns.update(abs=np.abs, minimum=np.minimum, maximum=np.maximum,
                  where=np.where, np=np)
        return _eval_sandboxed(code, ns)

    return fn


def _parse_number(s: str):
    """One numeric-literal grammar for every CLI value flag: int unless it
    reads as a float."""
    return float(s) if "." in s or "e" in s.lower() else int(s)


def _to_jsonable(v):
    """tolist() with non-finite floats as null: group avgs are NaN for
    empty groups, and a bare NaN breaks strict RFC-8259 readers."""
    if v is None:   # an aggregate over no row (SQL MAX over nothing)
        return None
    a = np.asarray(v)
    if a.dtype.kind != "f":
        return a.tolist()

    def fix(x):
        if isinstance(x, list):
            return [fix(y) for y in x]
        return x if math.isfinite(x) else None

    return fix(a.astype(float).tolist())


def _print_json(out: dict) -> None:
    print(json.dumps({k: _to_jsonable(v) for k, v in out.items()},
                     allow_nan=False))


def _print_plan(plan, as_json: bool) -> None:
    print(json.dumps(dataclasses.asdict(plan)) if as_json else plan)


def _mesh(dev):
    from ..parallel.mesh import make_scan_mesh
    return make_scan_mesh() if dev.type == "cuda" else make_scan_mesh([dev])


def _sql_tables(ap, specs) -> dict:
    tables = {}
    for spec in specs:
        name, eq, rest = spec.partition("=")
        tpath, colon, tail = rest.rpartition(":")
        if not eq or not colon:
            ap.error("--sql-table takes NAME=PATH:NCOLS or NAME=PATH:DT,DT,"
                     "... (dtypes like the main table's --dtypes)")
        if tail.isdigit():
            # a bare count is all int32 columns; a typed payload needs the
            # dtype form or SUM(dim.cK) reinterprets its bits
            tsch = HeapSchema(n_cols=int(tail), visibility=False)
        else:
            try:
                tsch = HeapSchema(n_cols=len(tail.split(",")),
                                  visibility=False,
                                  dtypes=tuple(tail.split(",")))
            except (TypeError, ValueError) as e:
                ap.error(f"--sql-table {name}: bad dtype list {tail!r} "
                         f"({e})")
        tables[name] = (tpath, tsch)
    return tables


def _run_sql(ap, args, src, schema, dev) -> int:
    from ..scan.sql import create_table_as, parse_sql
    tables = _sql_tables(ap, args.sql_table)
    if args.sql_create:
        try:
            dsch, n = create_table_as(
                args.sql_create, args.sql, src, schema, tables=tables,
                overwrite=args.sql_create_force, device=dev)
        except StromError as e:
            ap.error(f"--sql-create: {e}")
        dts = ",".join(str(dsch.col_dtype(i)) for i in range(dsch.n_cols))
        print(f"created {args.sql_create}: {n} rows, {dsch.n_cols} columns "
              f"({dts})")
        return 0
    try:
        q, assemble = parse_sql(args.sql, src, schema, tables=tables,
                                workers=args.workers)
    except StromError as e:
        ap.error(f"--sql: {e}")
    mesh = _mesh(dev) if args.mesh else None
    if args.explain:
        _print_plan(q.explain(device=dev, mesh=mesh), args.as_json)
        return 0
    res = q.run(device=dev, mesh=mesh, kernel=args.kernel,
                analyze=args.analyze)
    # the ORDER BY assembler's point lookups run on the query's device
    kw = {"device": dev} \
        if "device" in inspect.signature(assemble).parameters else {}
    out = assemble(res, **kw)
    ana = res.get("_analyze") if isinstance(res, dict) else None
    if args.as_json:
        body = {k: _to_jsonable(v) for k, v in out.items()}
        if ana:
            body["_analyze"] = ana
        print(json.dumps(body, allow_nan=False))
    else:
        for k, v in out.items():
            print(f"{k}: {v}")
        if ana:
            print(f"_analyze: {ana}")
    return 0


def _run_index(ap, args, src, schema, q, dev) -> int:
    from ..scan.index import build_index, open_index
    if not isinstance(src, str):
        ap.error("index operations take a single table file")
    if args.build_index is not None:
        spec = args.build_index
        try:
            key = tuple(int(c) for c in spec.split(",")) \
                if "," in spec else int(spec)
            if isinstance(key, tuple) and len(key) != 2:
                raise ValueError
        except ValueError:
            ap.error("--build-index takes COL or C0,C1")
        print(f"built {build_index(src, schema, key, device=dev)}")
        if not args.index_lookup:
            return 0
    colspec, _, vspec = args.index_lookup.partition(":")
    if not colspec.isdigit() or not vspec:
        ap.error("--index-lookup takes COL:V[,V...]")
    try:
        vals = [_parse_number(x) for x in vspec.split(",")]
    except ValueError:
        ap.error("--index-lookup: values must be numbers")
    try:
        idx = open_index(f"{src}.idx{colspec}", table_path=src)
    except FileNotFoundError:
        ap.error(f"no index at {src}.idx{colspec}; build it with "
                 f"--build-index {colspec}")
    except (StromError, OSError, ValueError, KeyError, struct.error) as e:
        # the stale and corrupt shapes open_index raises
        ap.error(f"{src}.idx{colspec}: {e}; rebuild with --build-index "
                 f"{colspec}")
    _print_rows(idx.fetch(q, values=vals, device=dev), args.as_json)
    return 0


def _print_rows(out: dict, as_json: bool) -> None:
    if as_json:
        _print_json(out)
        return
    for k, v in out.items():
        print(f"{k}: {np.array2string(np.asarray(v), threshold=32)}")


def _join_table_arrays(ap, table: str):
    """``(keys, values)`` of a .npz (``keys``/``values``) or .npy ((N, 2)
    ``[key, value]`` rows) dimension table."""
    from ..ops.join import _value_dtype
    try:
        if table.endswith(".npz"):
            z = np.load(table)
            if "keys" not in z or "values" not in z:
                ap.error("--join .npz table needs 'keys' and 'values' "
                         "arrays")
            return np.asarray(z["keys"], np.int32), \
                np.asarray(z["values"], _value_dtype(z["values"]))
        a = np.load(table)
        if a.ndim != 2 or a.shape[1] != 2:
            ap.error("--join .npy table must be (N, 2) [key, value]")
        return np.asarray(a[:, 0], np.int32), \
            np.asarray(a[:, 1], _value_dtype(a[:, 1]))
    except (OSError, ValueError) as e:
        ap.error(f"--join table {table!r} unreadable: {e}")


def _structured_filter(ap, args, q):
    """The structured filter first: a --where beside it composes as the
    residual the index path rechecks (Index Cond + Filter)."""
    if args.where_in:
        colspec, _, vspec = args.where_in.partition(":")
        if not colspec.isdigit() or not vspec:
            ap.error("--where-in takes COL:V[,V...]")
        try:
            ivals = [_parse_number(x) for x in vspec.split(",")]
        except ValueError:
            ap.error("--where-in: values must be numbers")
        return q.where_in(int(colspec), ivals)
    if args.where_range:
        parts = args.where_range.split(":")
        if len(parts) != 3 or not parts[0].isdigit():
            ap.error("--where-range takes COL:LO:HI (empty = open bound)")
        try:
            rlo = _parse_number(parts[1]) if parts[1] else None
            rhi = _parse_number(parts[2]) if parts[2] else None
        except ValueError:
            ap.error("--where-range: bounds must be numbers")
        return q.where_range(int(parts[0]), rlo, rhi)
    if args.where_eq:
        colspec, _, vspec = args.where_eq.partition(":")
        if not vspec:
            ap.error("--where-eq takes COL:VALUE or C0,C1:V0,V1")
        try:
            if "," in colspec:
                cpair = tuple(int(c) for c in colspec.split(","))
                vpair = tuple(_parse_number(v) for v in vspec.split(","))
                if len(cpair) != 2 or len(vpair) != 2:
                    raise ValueError
                return q.where_eq(cpair, vpair)
            return q.where_eq(int(colspec), _parse_number(vspec))
        except ValueError:
            ap.error("--where-eq takes COL:VALUE or C0,C1:V0,V1 (numbers)")
    return q


def _terminal(ap, args, q, agg_cols):
    """The one terminal operator the flags name."""
    if args.select:
        sel = None if args.select == "all" else \
            [int(c) for c in args.select.split(",")]
        return q.select(sel, limit=args.limit, offset=args.offset)
    if args.group_by:
        if not args.groups:
            ap.error("--group-by requires --groups")
        return q.group_by(_expr_fn(args.group_by, args.cols), args.groups,
                          agg_cols=agg_cols,
                          having=_having_fn(args.having)
                          if args.having else None)
    if args.group_by_cols:
        try:
            kcols = [int(c) for c in args.group_by_cols.split(",")]
            return q.group_by_cols(kcols, agg_cols=agg_cols,
                                   having=_having_fn(args.having)
                                   if args.having else None,
                                   max_groups=args.max_groups)
        except (ValueError, StromError) as e:
            ap.error(f"--group-by-cols: {e}")
    if args.top_k:
        parts = args.top_k.split(":")
        largest = not (len(parts) > 2 and parts[2] == "smallest")
        return q.top_k(int(parts[0]), int(parts[1]), largest=largest)
    if args.order_by:
        parts = args.order_by.split(":")
        return q.order_by([int(c) for c in parts[0].split(",")],
                          descending=len(parts) > 1 and parts[1] == "desc",
                          limit=args.limit, offset=args.offset)
    if args.join:
        colspec, _, table = args.join.partition(":")
        if not table or not colspec.isdigit():
            ap.error("--join takes COL:TABLE (integer column index)")
        rows = dict(materialize=args.join_rows,
                    limit=args.limit if args.join_rows else None,
                    offset=args.offset if args.join_rows else 0,
                    how=args.join_how)
        if table.endswith(".heap"):
            # an on-disk dimension: join_table streams it when it exceeds
            # the host budget
            bschema = HeapSchema(n_cols=args.join_build_cols,
                                 visibility=False)
            try:
                return q.join_table(int(colspec), table, bschema,
                                    args.join_key_col, args.join_value_col,
                                    **rows)
            except StromError as e:
                ap.error(f"--join heap table: {e}")
        jk, jv = _join_table_arrays(ap, table)
        return q.join(int(colspec), jk, jv, **rows)
    if args.quantiles:
        colspec, _, qspec = args.quantiles.partition(":")
        if not colspec.isdigit() or not qspec:
            ap.error("--quantiles takes COL:Q[,Q...]")
        try:
            qlist = [float(x) for x in qspec.split(",")]
        except ValueError:
            ap.error("--quantiles: quantiles must be floats in [0, 1]")
        return q.quantiles(int(colspec), qlist)
    if args.count_distinct is not None:
        return q.count_distinct(args.count_distinct)
    if agg_cols is not None:
        return q.aggregate(cols=agg_cols)
    return q


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="strom_query_gpu", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("file", nargs="+", help="heap file(s); several = stripe "
                                            "set")
    ap.add_argument("-d", "--device", default=None,
                    help="cuda ordinal, 'cuda:N' or 'cpu' (default cuda:0)")
    ap.add_argument("--stripe-chunk", default="512k",
                    help="stripe chunk size for multi-file sets (default "
                         "512k)")
    ap.add_argument("--cols", type=int, required=True,
                    help="number of data columns in the schema")
    ap.add_argument("--dtypes", default=None,
                    help="comma-separated per-column dtypes (int32/uint32/"
                         "float32/int64/float64; default all int32)")
    ap.add_argument("--nullable", default=None, metavar="C[,C...]",
                    help="columns carrying a NULL validity bitmap (IS [NOT] "
                         "NULL, NULL-aware COUNT/SUM/AVG)")
    ap.add_argument("--visibility", action="store_true",
                    help="schema carries a per-tuple visibility column")
    ap.add_argument("--where", default=None, metavar="EXPR",
                    help='row filter, e.g. "c0 > 10" (torch ops)')
    ap.add_argument("--where-eq", default=None, metavar="COL:VALUE",
                    help="structured equality filter the planner can see: "
                         "with a fresh --build-index sidecar, --select "
                         "runs as an index scan (check with --explain)")
    ap.add_argument("--where-range", default=None, metavar="COL:LO:HI",
                    help="structured range filter (empty LO or HI = open "
                         "bound); index-scan capable like --where-eq")
    ap.add_argument("--where-in", default=None, metavar="COL:V[,V...]",
                    help="structured membership filter (SQL IN); "
                         "index-scan capable like --where-eq")
    ap.add_argument("--group-by", default=None, metavar="EXPR",
                    help='int32 group key, e.g. "c1 %% 8"')
    ap.add_argument("--groups", type=int, default=None,
                    help="number of groups (required with --group-by)")
    ap.add_argument("--group-by-cols", default=None, metavar="C[,C2]",
                    help="SQL GROUP BY over column values: distinct keys "
                         "discovered (sidecar or scan), result carries "
                         "key_cols")
    ap.add_argument("--max-groups", type=int, default=1 << 16, metavar="N",
                    help="with --group-by-cols: the sorted spill past N "
                         "distinct keys")
    ap.add_argument("--agg-cols", default=None,
                    help="comma-separated column indices to aggregate")
    ap.add_argument("--having", default=None, metavar="EXPR",
                    help='post-aggregation group filter over count/sums/'
                         'mins/maxs/avgs, e.g. "count > 100" or '
                         '"avgs[0] > 5" (requires --group-by)')
    ap.add_argument("--top-k", default=None, metavar="COL:K[:smallest]",
                    help="top-k of a column instead of aggregation")
    ap.add_argument("--select", default=None, metavar="COLS|all",
                    help="materialize matching rows: comma-separated column "
                         "indices (or 'all'); values + row positions")
    ap.add_argument("--order-by", default=None,
                    metavar="COL[,COL...][:desc]",
                    help="full ordering (values + row positions); extra "
                         "columns break ties")
    ap.add_argument("--limit", type=int, default=None,
                    help="with --select/--order-by: return at most N rows "
                         "(--select stops scanning early)")
    ap.add_argument("--offset", type=int, default=0,
                    help="with --select/--order-by: skip the first N rows")
    ap.add_argument("--count-distinct", default=None, metavar="COL",
                    type=int, help="exact COUNT(DISTINCT col)")
    ap.add_argument("--quantiles", default=None, metavar="COL:Q[,Q...]",
                    help="exact nearest-rank quantiles of a column, e.g. "
                         "0:0.5,0.9,0.99")
    ap.add_argument("--fetch", default=None, metavar="POS[,POS...]",
                    help="point lookup by global row position: reads only "
                         "the pages holding those rows (no scan)")
    ap.add_argument("--build-index", default=None, metavar="COL|C0,C1",
                    help="one scan -> sorted (key, position) sidecar at "
                         "FILE.idxCOL (C0,C1: a composite FILE.idxC0_C1)")
    ap.add_argument("--index-lookup", default=None, metavar="COL:V[,V...]",
                    help="index scan: positions from the sidecar, only "
                         "their pages read (stale indexes are refused)")
    ap.add_argument("--join", default=None, metavar="COL:TABLE",
                    help="join the probe column against a dimension table "
                         "(.npz with 'keys'/'values', .npy of (N, 2) [key, "
                         "value] rows, or a .heap file)")
    ap.add_argument("--join-build-cols", type=int, default=2, metavar="N",
                    help="with --join COL:TABLE.heap: the dimension's int32 "
                         "column count")
    ap.add_argument("--join-key-col", type=int, default=0, metavar="C",
                    help="with --join COL:TABLE.heap: build key column")
    ap.add_argument("--join-value-col", type=int, default=1, metavar="C",
                    help="with --join COL:TABLE.heap: build payload column")
    ap.add_argument("--join-how", default="inner",
                    choices=("inner", "left", "semi", "anti"),
                    help="join face: inner (default), left (every selected "
                         "row, NULL-indicated payload), semi (EXISTS), anti "
                         "(NOT EXISTS)")
    ap.add_argument("--join-rows", action="store_true",
                    help="with --join: the joined rows themselves "
                         "(positions/keys/payload; --limit/--offset apply)")
    ap.add_argument("--kernel", choices=("auto", "cuda", "torch"),
                    default="auto",
                    help="route: the CUDA kernels, the torch route, or the "
                         "planner's choice")
    ap.add_argument("--workers", type=int, default=0, metavar="N",
                    help="run the scan as N worker processes sharing one "
                         "cursor (structured filters and --sql predicates "
                         "ship; exclusive with --mesh)")
    ap.add_argument("--mesh", action="store_true",
                    help="stream sharded over every card (with -d cpu: a "
                         "one-member host ring)")
    ap.add_argument("--sql", default=None, metavar="STATEMENT",
                    help="run a SQL SELECT (subset; columns named c0..cN-1; "
                         "the FROM name is nominal, the positional file is "
                         "the table); exclusive with the per-flag builders")
    ap.add_argument("--sql-create-force", action="store_true",
                    help="with --sql-create: replace an existing DEST")
    ap.add_argument("--sql-create", default=None, metavar="DEST",
                    help="with --sql: CREATE TABLE AS, the result as a new "
                         "heap table at DEST (string columns re-encoded "
                         "with fresh dictionaries)")
    ap.add_argument("--sql-table", action="append", default=[],
                    metavar="NAME=PATH:NCOLS",
                    help="bind a JOIN dimension table for --sql "
                         "(repeatable): NAME as written after JOIN, PATH a "
                         "heap file, NCOLS its column count")
    ap.add_argument("--explain", action="store_true",
                    help="print the plan and exit without scanning")
    ap.add_argument("--analyze", action="store_true",
                    help="EXPLAIN ANALYZE: run, then report elapsed time "
                         "and the engine's per-run I/O counters")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    from ..config import parse_size
    from ..hbm.staging import resolve_device
    from ..scan.query import Query
    dtypes = tuple(args.dtypes.split(",")) if args.dtypes else None
    nullable = None
    if args.nullable:
        try:
            nn = {int(c) for c in args.nullable.split(",")}
        except ValueError:
            ap.error("--nullable takes column indices: C[,C...]")
        if any(not 0 <= c < args.cols for c in nn):
            ap.error("--nullable column out of range")
        nullable = tuple(c in nn for c in range(args.cols))
    schema = HeapSchema(n_cols=args.cols, visibility=args.visibility,
                        dtypes=dtypes, nullable=nullable)
    agg_cols = [int(c) for c in args.agg_cols.split(",")] \
        if args.agg_cols else None
    dev = resolve_device(int(args.device) if (args.device or "").isdigit()
                         else args.device)
    src = args.file[0] if len(args.file) == 1 else list(args.file)
    terminals = [f for f, v in (("--select", args.select),
                                ("--group-by", args.group_by),
                                ("--group-by-cols", args.group_by_cols),
                                ("--top-k", args.top_k),
                                ("--order-by", args.order_by),
                                ("--join", args.join),
                                ("--quantiles", args.quantiles),
                                ("--count-distinct",
                                 args.count_distinct is not None)) if v]
    if len(terminals) > 1:
        ap.error(f"{' and '.join(terminals)} are exclusive (one terminal "
                 f"operator per query)")
    if (args.select or args.top_k or args.order_by or args.join
            or args.quantiles
            or args.count_distinct is not None) and agg_cols is not None:
        ap.error(f"--agg-cols has no effect with {terminals[0]}")
    if (args.limit is not None or args.offset) \
            and not (args.select or args.order_by
                     or (args.join and args.join_rows)):
        ap.error("--limit/--offset apply to --select, --order-by, or --join "
                 "with --join-rows")
    if args.join_rows and not args.join:
        ap.error("--join-rows requires --join")
    if args.workers and args.mesh:
        ap.error("--workers and --mesh are exclusive scan modes")
    filters = args.where or args.where_eq or args.where_range \
        or args.where_in
    if args.sql:
        if terminals or filters or args.having or args.fetch \
                or args.build_index is not None or args.index_lookup:
            ap.error("--sql is the whole query; drop the per-flag builders")
        return _run_sql(ap, args, src, schema, dev)
    q = Query(src, schema, stripe_chunk_size=parse_size(args.stripe_chunk),
              workers=args.workers)
    if args.build_index is not None or args.index_lookup:
        if terminals or filters or args.fetch:
            ap.error("--build-index/--index-lookup are exclusive index "
                     "operations")
        for flag, given in (("--explain", args.explain),
                            ("--having", args.having),
                            ("--mesh", args.mesh),
                            ("--kernel", args.kernel != "auto")):
            if given:
                ap.error(f"{flag} does not apply to index operations")
        return _run_index(ap, args, src, schema, q, dev)
    if args.fetch:
        if terminals:
            ap.error(f"--fetch is a point lookup, exclusive of "
                     f"{terminals[0]}")
        if filters:
            ap.error("--fetch reads rows by position; --where filters do "
                     "not apply (filter with a scan terminal instead)")
        for flag, given in (("--explain", args.explain),
                            ("--having", args.having),
                            ("--mesh", args.mesh),
                            ("--kernel", args.kernel != "auto")):
            if given:
                ap.error(f"--fetch is a point lookup; {flag} does not apply")
        try:
            fpos = [int(x) for x in args.fetch.split(",")]
        except ValueError:
            ap.error("--fetch takes comma-separated integer positions")
        _print_rows(q.fetch(fpos, device=dev), args.as_json)
        return 0
    if sum(bool(x) for x in (args.where_eq, args.where_range,
                             args.where_in)) > 1:
        ap.error("--where-eq, --where-range and --where-in are exclusive "
                 "(one structured filter); --where composes with any of "
                 "them as a residual")
    q = _structured_filter(ap, args, q)
    if args.where:
        q = q.where(_expr_fn(args.where, args.cols))
    if args.having and not (args.group_by or args.group_by_cols):
        ap.error("--having requires --group-by or --group-by-cols")
    q = _terminal(ap, args, q, agg_cols)
    mesh = _mesh(dev) if args.mesh else None
    plan = q.explain(device=dev, mesh=mesh)
    if args.explain:
        _print_plan(plan, args.as_json)
        return 0
    out = q.run(device=dev, mesh=mesh, kernel=args.kernel,
                analyze=args.analyze)
    if args.as_json:
        _print_json(out)
        return 0
    if args.kernel != "auto" and args.kernel != plan.kernel \
            and not (args.order_by or args.select or args.join
                     or args.quantiles or args.count_distinct is not None):
        # the printed plan names the route that ran (order_by has a fixed
        # sort pipeline: run() takes no kernel override there)
        plan = dataclasses.replace(
            plan, kernel=args.kernel,
            reason=plan.reason + f" [overridden: --kernel {args.kernel}]")
    print(plan)
    for k, v in out.items():
        a = np.asarray(v)
        print(f"{k}: {a}" if a.ndim == 0
              else f"{k}: {np.array2string(a, threshold=32)}")
    return 0


def cli() -> None:
    sys.exit(main())


if __name__ == "__main__":
    cli()
