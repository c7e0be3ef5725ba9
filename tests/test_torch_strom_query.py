"""The port's ``strom_query`` CLI (``tools/strom_query.py``) against the JAX
package's: every ``test_strom_query_*`` case of ``tests/test_tools.py``,
both CLIs called in process (``main(argv)``, the port with ``-d cpu``), on
the same heap bytes.  The ``--json`` documents compare (integers,
positions and strings exact; floats within ``1e-4 * sum(|x|) + 1e-6``);
plans compare by their ``access_path`` and operator, not their text (the
port names its routes ``cuda``/``torch``, the JAX package
``pallas``/``xla``).  A refusal exits the same way in both (argparse's
exit 2, or the sandbox's error message), naming the same flag.  The port
has no environment tier for its config, so the cases set both packages'
config values directly.  Two cases run the port as a subprocess: ``--help``
and the string statement, whose quoting must survive the process
boundary."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from nvme_strom_tpu.config import config as jconfig
from nvme_strom_tpu.scan.heap import HeapSchema as JSchema
from nvme_strom_tpu.scan.heap import build_heap_file
from nvme_strom_tpu.tools import strom_query as jcli
from nvme_strom_tpu_torch.config import config
from nvme_strom_tpu_torch.testing.sql_results import assert_same_result
from nvme_strom_tpu_torch.tools import strom_query as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def configs():
    snap, jsnap = config.snapshot(), jconfig.snapshot()
    yield
    config.restore(snap)
    jconfig.restore(jsnap)


def _call(main, argv, capsys):
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


def run(capsys, *argv):
    """Both CLIs on *argv*: ``(port, jax)``, each ``(rc, stdout, stderr)``
    (rc an int, or the message of a SystemExit that carries one)."""
    return (_call(tcli.main, [*argv, "-d", "cpu"], capsys),
            _call(jcli.main, list(argv), capsys))


def _doc(stdout: str):
    return json.loads(stdout.strip().splitlines()[-1])


def same_json(capsys, *argv, scale=None):
    """Both CLIs with ``--json``; the port's document, equal to the JAX
    package's."""
    (prc, pout, perr), (jrc, jout, jerr) = run(capsys, *argv, "--json")
    assert prc == 0, perr
    assert jrc == 0, jerr
    got, want = _doc(pout), _doc(jout)
    assert_same_result(got, want, scale=scale, what=" ".join(argv))
    return got


def same_refusal(capsys, *argv, needle):
    (prc, _pout, perr), (jrc, _jout, jerr) = run(capsys, *argv)
    assert prc != 0 and jrc != 0
    # the same exit: argparse's 2 in both, or a message in both
    assert type(prc) is type(jrc), (prc, jrc)
    if isinstance(prc, int):
        assert prc == jrc
    for where in (perr + str(prc), jerr + str(jrc)):
        assert needle in where, (needle, where)


def same_plan(capsys, *argv):
    (prc, pout, perr), (jrc, jout, jerr) = run(capsys, *argv, "--explain",
                                               "--json")
    assert prc == 0 and jrc == 0, (perr, jerr)
    p, j = _doc(pout), _doc(jout)
    assert p["operator"] == j["operator"]
    assert p["access_path"] == j["access_path"]
    assert p["kernel"] == "torch"
    return p, j


def _table(tmp_path, name, cols, **kw):
    path = str(tmp_path / name)
    build_heap_file(path, cols, JSchema(visibility=False, n_cols=len(cols),
                                        **kw))
    return path


def _tpp(n_cols=2, **kw):
    return JSchema(n_cols=n_cols, visibility=False, **kw).tuples_per_page


def test_strom_query_cli_explain_and_run(tmp_path, capsys):
    rng = np.random.default_rng(3)
    n = _tpp() * 8
    path = _table(tmp_path, "q.heap", [
        rng.integers(-100, 100, n).astype(np.int32),
        rng.integers(0, 8, n).astype(np.int32)])
    base = [path, "--cols", "2", "--where", "c0 > 0"]
    (prc, pout, _), _j = run(capsys, *base, "--explain")
    assert prc == 0 and "aggregate scan" in pout
    same_plan(capsys, *base)
    same_json(capsys, *base)
    same_json(capsys, *base, "--group-by", "c1", "--groups", "8",
              "--agg-cols", "0")


def test_strom_query_rejects_evil_expression(tmp_path, capsys):
    path = _table(tmp_path, "q.heap", [np.zeros(10, np.int32)])
    same_refusal(capsys, path, "--cols", "1", "--where",
                 "__import__('os').system('true')", needle="not allowed")


def test_strom_query_cli_conflicting_terminals_and_bad_column(tmp_path,
                                                              capsys):
    path = _table(tmp_path, "q.heap", [np.zeros(10, np.int32)] * 2)
    base = [path, "--cols", "2"]
    same_refusal(capsys, *base, "--group-by", "c1", "--groups", "4",
                 "--top-k", "0:4", needle="exclusive")
    same_refusal(capsys, *base, "--where", "c9 > 0", needle="out of range")


def test_strom_query_cli_order_by(tmp_path, capsys):
    rng = np.random.default_rng(6)
    c0 = rng.integers(-100, 100, _tpp(1) * 4).astype(np.int32)
    path = _table(tmp_path, "o.heap", [c0])
    res = same_json(capsys, path, "--cols", "1", "--order-by", "0:desc")
    assert res["values"] == np.sort(c0)[::-1].tolist()


def test_strom_query_cli_select_limit(tmp_path, capsys):
    rng = np.random.default_rng(9)
    n = _tpp() * 4
    c0 = rng.integers(-100, 100, n).astype(np.int32)
    path = _table(tmp_path, "s.heap", [
        c0, rng.integers(0, 8, n).astype(np.int32)])
    res = same_json(capsys, path, "--cols", "2", "--where", "c0 > 50",
                    "--select", "1", "--limit", "6")
    assert res["count"] == 6 and all(c0[p] > 50 for p in res["positions"])
    same_refusal(capsys, path, "--cols", "2", "--limit", "3",
                 needle="--limit")


def test_strom_query_cli_having(tmp_path, capsys):
    rng = np.random.default_rng(12)
    n = _tpp() * 4
    path = _table(tmp_path, "h.heap", [
        rng.integers(0, 100, n).astype(np.int32),
        (np.arange(n) % 4).astype(np.int32)])
    base = [path, "--cols", "2"]
    same_json(capsys, *base, "--group-by", "c1", "--groups", "4",
              "--agg-cols", "0", "--having", "avgs[0] > 45")
    same_refusal(capsys, *base, "--having", "count > 1", needle="--having")
    same_refusal(capsys, *base, "--group-by", "c1", "--groups", "4",
                 "--having", "__import__('os')", needle="not allowed")


def test_strom_query_json_empty_group_avgs_are_null(tmp_path, capsys):
    n = _tpp()
    path = _table(tmp_path, "n.heap", [np.arange(n, dtype=np.int32),
                                       (np.arange(n) % 3).astype(np.int32)])
    res = same_json(capsys, path, "--cols", "2", "--group-by", "c1",
                    "--groups", "5", "--agg-cols", "0")
    assert res["avgs"][0][3] is None and res["avgs"][0][4] is None
    assert res["avgs"][0][0] is not None


def test_strom_query_sandbox_rejects_nested_code_objects(tmp_path, capsys):
    path = _table(tmp_path, "sb.heap", [np.zeros(10, np.int32)])
    evil = "(lambda: ().__class__.__bases__[0].__subclasses__())()"
    same_refusal(capsys, path, "--cols", "1", "--where", evil,
                 needle="not allowed")
    same_refusal(capsys, path, "--cols", "1", "--group-by", "c0",
                 "--groups", "2", "--having", evil, needle="not allowed")


def test_strom_query_cli_join(tmp_path, capsys):
    rng = np.random.default_rng(21)
    n = _tpp() * 4
    path = _table(tmp_path, "j.heap", [
        rng.integers(0, 100, n).astype(np.int32),
        rng.integers(0, 16, n).astype(np.int32)])
    table = str(tmp_path / "dim.npz")
    keys = np.arange(0, 8, dtype=np.int32)
    np.savez(table, keys=keys, values=keys * 100)
    base = [path, "--cols", "2", "--join", f"1:{table}"]
    same_json(capsys, *base)
    res = same_json(capsys, *base, "--join-rows", "--limit", "5")
    assert res["count"] == 5
    same_refusal(capsys, path, "--cols", "2", "--join-rows",
                 needle="--join-rows")
    res = same_json(capsys, *base, "--join-how", "anti")
    assert "payload_sum" not in res
    res = same_json(capsys, *base, "--join-how", "left", "--join-rows")
    assert res["count"] == n


def test_strom_query_cli_fetch(tmp_path, capsys):
    path = _table(tmp_path, "f.heap",
                  [np.arange(_tpp(1) * 2, dtype=np.int32) * 3])
    res = same_json(capsys, path, "--cols", "1", "--fetch", "7,0,1000")
    assert res["col0"] == [21, 0, 3000]
    same_refusal(capsys, path, "--cols", "1", "--fetch", "1", "--where",
                 "c0 > 0", needle="--fetch")


def test_strom_query_cli_index(tmp_path, capsys):
    rng = np.random.default_rng(29)
    n = _tpp() * 4
    path = _table(tmp_path, "i.heap", [
        rng.integers(0, 50, n).astype(np.int32),
        np.arange(n, dtype=np.int32)])
    (prc, pout, _), _j = run(capsys, path, "--cols", "2", "--build-index",
                             "0")
    assert prc == 0 and "built" in pout
    same_json(capsys, path, "--cols", "2", "--index-lookup", "0:7")
    same_refusal(capsys, path, "--cols", "2", "--index-lookup", "0:7",
                 "--top-k", "0:3", needle="exclusive")


def test_strom_query_cli_where_eq_index_plan(tmp_path, capsys):
    rng = np.random.default_rng(31)
    n = _tpp() * 4
    path = _table(tmp_path, "w.heap", [
        rng.integers(0, 30, n).astype(np.int32),
        np.arange(n, dtype=np.int32)])
    config.set("debug_no_threshold", True)
    jconfig.set("debug_no_threshold", True)
    run(capsys, path, "--cols", "2", "--build-index", "0")
    base = [path, "--cols", "2", "--where-eq", "0:9", "--select", "all"]
    p, _j = same_plan(capsys, *base)
    assert p["access_path"] == "index"
    same_json(capsys, *base)
    same_json(capsys, *base, "--where", "c1 > 0")


def test_strom_query_cli_where_range(tmp_path, capsys):
    n = _tpp(1)
    path = _table(tmp_path, "r.heap", [np.arange(n, dtype=np.int32)])
    base = [path, "--cols", "1", "--select", "all"]
    res = same_json(capsys, *base, "--where-range", "0:5:9")
    assert sorted(res["positions"]) == list(range(5, 10))
    same_json(capsys, *base, "--where-range", f"0:{n - 3}:")
    same_json(capsys, *base, "--where", "c0 > 1", "--where-range", "0:1:2")


def test_strom_query_help_renders():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-m",
                          "nvme_strom_tpu_torch.tools.strom_query", "--help"],
                         capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "--join" in out.stdout and "cuda|torch" in out.stdout


def test_strom_query_join_heap_table(tmp_path, capsys):
    rng = np.random.default_rng(9)
    t = _tpp()
    c0 = rng.integers(0, 2000, t * 8).astype(np.int32)
    fpath = _table(tmp_path, "f.heap", [c0, np.ones(t * 8, np.int32)])
    pk = rng.permutation(2000).astype(np.int32)[:t]
    dpath = _table(tmp_path, "d.heap", [pk, (pk * 2).astype(np.int32)])
    config.set("debug_no_threshold", True)
    jconfig.set("debug_no_threshold", True)
    base = [fpath, "--cols", "2", "--join", f"0:{dpath}"]
    res = same_json(capsys, *base)
    assert res["matched"] == int(np.isin(c0, pk).sum())
    # the streamed build (the partitioned strategy) agrees
    config.set("join_broadcast_max", 1024)
    jconfig.set("join_broadcast_max", 1024)
    same_json(capsys, *base)
    res = same_json(capsys, *base, "--join-rows", "--limit", "5")
    assert res["count"] == 5


def test_strom_query_join_heap_rejects_bad_table(tmp_path, capsys):
    t = _tpp()
    fpath = _table(tmp_path, "f.heap", [np.arange(t, dtype=np.int32)] * 2)
    t3 = _tpp(3)
    dpath = _table(tmp_path, "d3.heap", [np.arange(t3, dtype=np.int32)] * 3)
    base = [fpath, "--cols", "2", "--json", "--join"]
    same_refusal(capsys, *base, f"0:{dpath}", needle="columns")
    (prc, _o, perr), (jrc, _jo, jerr) = run(capsys, *base,
                                            f"0:{tmp_path}/nope.heap")
    assert prc == jrc == 2 and "Traceback" not in perr


def test_strom_query_cli_group_by_cols(tmp_path, capsys):
    rng = np.random.default_rng(13)
    n = _tpp() * 4
    path = _table(tmp_path, "g.heap", [
        rng.integers(0, 6, n).astype(np.int32),
        rng.integers(0, 50, n).astype(np.int32)])
    same_json(capsys, path, "--cols", "2", "--group-by-cols", "0",
              "--agg-cols", "1")
    same_refusal(capsys, path, "--cols", "2", "--group-by-cols", "0",
                 "--select", "all", needle="exclusive")


def test_strom_query_cli_sql(tmp_path, capsys):
    rng = np.random.default_rng(4)
    n = _tpp() * 4
    path = _table(tmp_path, "s.heap", [
        rng.integers(0, 10, n).astype(np.int32),
        rng.integers(-50, 50, n).astype(np.int32)])
    base = [path, "--cols", "2", "--sql"]
    same_json(capsys, *base, "SELECT c0, COUNT(*), SUM(c1) FROM t "
                             "GROUP BY c0 HAVING COUNT(*) > 10")
    p, _j = same_plan(capsys, *base, "SELECT COUNT(*) FROM t")
    assert p["operator"] == "aggregate"
    same_refusal(capsys, *base, "SELECT COUNT(*) FROM t", "--select", "all",
                 needle="whole query")


def test_strom_query_cli_sql_join(tmp_path, capsys):
    rng = np.random.default_rng(8)
    n = _tpp() * 4
    fpath = _table(tmp_path, "f.heap", [
        rng.integers(0, 30, n).astype(np.int32),
        rng.integers(0, 16, n).astype(np.int32)])
    keys = np.arange(0, 8, dtype=np.int32)
    dpath = _table(tmp_path, "d.heap", [keys, keys * 7])
    base = [fpath, "--cols", "2", "--sql"]
    same_json(capsys, *base, "SELECT COUNT(*), SUM(d.c1) FROM t "
                             "JOIN d ON c1 = d.c0", "--sql-table",
              f"d={dpath}:2")
    same_refusal(capsys, *base, "SELECT COUNT(*) FROM t JOIN d ON "
                                "c1 = d.c0", needle="not bound")


def test_strom_query_cli_analyze(tmp_path, capsys):
    rng = np.random.default_rng(2)
    c0 = rng.integers(0, 10, _tpp() * 4).astype(np.int32)
    path = _table(tmp_path, "a.heap", [c0, c0])
    for extra in (["--where", "c0 > 3"],
                  ["--sql", "SELECT COUNT(*) FROM t WHERE c0 > 3"]):
        res = same_json(capsys, path, "--cols", "2", *extra, "--analyze")
        ana = res["_analyze"]
        assert ana["elapsed_s"] > 0
        assert "kernel_dispatches" in ana and "submit_syscalls" in ana


def test_strom_query_cli_where_composes_with_structured(tmp_path, capsys):
    from nvme_strom_tpu_torch.scan.heap import HeapSchema
    from nvme_strom_tpu_torch.scan.index import build_index
    rng = np.random.default_rng(6)
    n = _tpp() * 4
    path = _table(tmp_path, "w.heap", [
        rng.integers(0, 10, n).astype(np.int32),
        rng.integers(-50, 50, n).astype(np.int32)])
    build_index(path, HeapSchema(n_cols=2, visibility=False), 0,
                device="cpu")
    base = [path, "--cols", "2", "--where-eq", "0:3", "--where", "c1 > 0"]
    (prc, pout, _), _j = run(capsys, *base, "--explain")
    assert prc == 0 and "index" in pout and "RECHECKED" in pout
    p, _j = same_plan(capsys, *base)
    assert p["access_path"] == "index"
    same_json(capsys, *base)
    same_refusal(capsys, path, "--cols", "2", "--where-eq", "0:3",
                 "--where-in", "0:1,2", needle="exclusive")


def test_strom_query_cli_sql_create(tmp_path, capsys):
    rng = np.random.default_rng(3)
    c0 = rng.integers(0, 5, _tpp() * 2).astype(np.int32)
    path = _table(tmp_path, "s.heap", [c0, c0 * 2])
    sql = "SELECT c0, COUNT(*) FROM t GROUP BY c0"
    dest, jdest = str(tmp_path / "d.heap"), str(tmp_path / "jd.heap")
    prc, pout, _ = _call(tcli.main, [path, "--cols", "2", "--sql", sql,
                                     "--sql-create", dest, "-d", "cpu"],
                         capsys)
    jrc, jout, _ = _call(jcli.main, [path, "--cols", "2", "--sql", sql,
                                     "--sql-create", jdest], capsys)
    assert prc == jrc == 0
    assert pout.replace(dest, "D") == jout.replace(jdest, "D")
    assert "created" in pout and "5 rows" in pout
    assert open(dest, "rb").read() == open(jdest, "rb").read()


def test_strom_query_cli_sql_strings(tmp_path, capsys):
    """String literals through the CLI: the port as a subprocess on the
    CPU (the quoting survives the process boundary), the JAX package in
    process."""
    from nvme_strom_tpu.scan.strings import encode_strings, save_dict
    names = ["x", "y", "z"] * 400
    codes, d = encode_strings(names)
    path = _table(tmp_path, "s.heap",
                  [codes, np.arange(len(names), dtype=np.int32)],
                  dtypes=("uint32", "int32"))
    save_dict(path, 0, d)
    argv = [path, "--cols", "2", "--dtypes", "uint32,int32", "--sql",
            "SELECT c0, COUNT(*) FROM t WHERE c0 != 'y' GROUP BY c0",
            "--json"]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-m",
                          "nvme_strom_tpu_torch.tools.strom_query", *argv,
                          "-d", "cpu"], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    got = _doc(out.stdout)
    jrc, jout, _ = _call(jcli.main, argv, capsys)
    assert jrc == 0
    assert_same_result(got, _doc(jout))
    assert got["c0"] == ["x", "z"] and got["count(*)"] == [400, 400]
