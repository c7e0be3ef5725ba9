"""Multi-process proof harness: ranks over ``torch.distributed``.

A port of the JAX package's ``testing/distributed.py``.  The reference's
multi-worker story is process-parallel PostgreSQL workers sharing DSM
state (`pgsql/nvme_strom.c:1057-1112`); its TPU analog is multi-host SPMD,
where every process owns a slice of the global mesh and touches only its
**addressable** shards.  A single-process mesh cannot prove that posture,
so this module launches separate processes joined by
:func:`..parallel.dist.init_process_group` and runs its checks across
them:

* ``sharded_load`` — :func:`..parallel.stream.load_pages_sharded`, each
  rank reading only its members' rows;
* ``scan_step`` — :func:`..parallel.dscan.make_distributed_scan_step` over
  ``sp = 2`` lanes with the cross-process psum (B1 on CUDA members);
* ``stream_fold`` — the streamed fold
  (:func:`..parallel.stream.distributed_scan_filter`);
* ``dist_sort`` — the sample sort's splitter gather and bucket all-to-all,
  and the bucket exchange alone;
* ``ckpt_restore`` / ``ckpt_save_sharded`` — the sharded restore and the
  multi-process sharded save (one shared file, each rank its own rows);
* ``pjoin`` / ``pjoin_rows`` — the partitioned join's routing and psum,
  and its row face (the rows routed to this rank's members);
* ``group_by_cols`` — key discovery across ranks, then the fold, the same
  result on every rank;
* the ``q_*`` checks — every face of :class:`..scan.query.Query` (and
  ``sql_query``) run over the mesh of both ranks (:data:`QUERY_CHECKS`):
  ``select``, the sort faces, ``top_k``, a GROUP BY key (B3 on CUDA
  members), the broadcast and partitioned joins and their row faces, the
  star join, ``where_eq`` with and without a sidecar, ``build_index``,
  GROUP BY's sorted spill and SQL statements.  Each runs on the query
  fixture (three columns, a tail past the last whole batch, its
  dimension tables) or, for the faces ``launch(table=)`` names, on that
  table.  Inside the worker ``join_broadcast_max`` is
  :data:`JOIN_BROADCAST_MAX` (16 KiB: the fixture's 3000-key build
  table is partitioned, its one-page dimensions broadcast) and the spill's
  ``max_groups`` :data:`SPILL_MAX_GROUPS` (16, under the fixture's 50
  keys), and ``cache_arbitration`` is off, so every chunk the engine
  reads is a direct read.  Each rank checks that every rank returned the
  same result, saves the outputs (``q_<face>__<key>``; SQL results in the
  result JSON) and records its engine ``total_dma_length`` delta a face
  (``result["dma"]``: its members' pages; the tail and the dimension
  loads read buffered) with the B1 and B3 launches.

Every check holds this rank's addressable shards against the file's bytes
and numpy, and each rank saves what it computed (``out_<rank>.npz``) for
a caller to hold against another implementation.  Members are
``devices_per_proc × cpu``, or ``× cuda:0`` (ranks sharing one card,
``gloo``), or ``× cuda:<rank>`` (a card a rank, ``nccl``).

Run: :func:`launch` from Python, or one worker by hand with ``python -m
nvme_strom_tpu_torch.testing.distributed SPEC.json``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

HEAP_NAME = "table.heap"
CKPT_NAME = "ck.strom"
#: the query checks' fixture, its two dimensions and its partitioned build
QUERY_NAME = "query.heap"
DIM_NAMES = ("dim1.heap", "dim2.heap")
BUILD_NAME = "build.heap"
QUERY_CHECKS = ("q_select", "q_order_by", "q_quantiles", "q_count_distinct",
                "q_top_k", "q_group_by", "q_join", "q_join_rows",
                "q_pjoin_query", "q_star", "q_where_eq", "q_build_index",
                "q_groupby_spill", "q_sql")
CHECKS = ("sharded_load", "scan_step", "stream_fold", "dist_sort",
          "ckpt_restore", "ckpt_save_sharded", "pjoin", "pjoin_rows",
          "group_by_cols") + QUERY_CHECKS
#: the workers' ``join_broadcast_max``: the query fixture's build table
#: (three pages) is partitioned, its dimensions (a page each) broadcast
JOIN_BROADCAST_MAX = 16 << 10
#: the spill check's ``max_groups``: below the fixture's 50 keys of c1
SPILL_MAX_GROUPS = 16
#: the query fixture's pages past its whole batches (read by member 0)
QUERY_TAIL_PAGES = 3

__all__ = ["prepare_fixtures", "launch", "CHECKS", "QUERY_CHECKS",
           "HEAP_NAME", "CKPT_NAME", "QUERY_NAME", "DIM_NAMES",
           "BUILD_NAME", "JOIN_BROADCAST_MAX", "SPILL_MAX_GROUPS",
           "query_fixture_schema"]


# ---------------------------------------------------------------------------
# fixtures (parent side)
# ---------------------------------------------------------------------------

def _make_schema():
    from ..scan.heap import HeapSchema
    return HeapSchema(n_cols=2, visibility=True)


def query_fixture_schema():
    """The query fixture's schema: int32 c0 in [-100, 100), int32 c1 in
    [0, 50), float32 c2, a visibility column."""
    from ..scan.heap import HeapSchema
    return HeapSchema(n_cols=3, visibility=True,
                      dtypes=("int32", "int32", "float32"))


def _dim_schema(float_value: bool = False):
    from ..scan.heap import HeapSchema
    return HeapSchema(n_cols=2, visibility=False,
                      dtypes=("int32", "float32" if float_value else "int32"))


def prepare_fixtures(workdir: str, n_global_devices: int) -> None:
    """Write the shared inputs every worker reads: a heap table of two
    pages a member, a checkpoint with one dp-shardable leaf and a scalar
    (the reference's, from the same seed), and the query checks' tables:
    the query fixture (two pages a member and :data:`QUERY_TAIL_PAGES`
    more), two dimensions (80 keys on c0's range, 25 on c1's with a
    float32 payload) and a 3000-key build table."""
    from ..data.checkpoint import save_checkpoint
    from ..scan.heap import build_heap_file

    schema = _make_schema()
    n_pages = 2 * n_global_devices
    n_rows = schema.tuples_per_page * n_pages
    rng = np.random.default_rng(1234)
    cols = [rng.integers(-100, 100, n_rows).astype(np.int32),
            rng.integers(0, 50, n_rows).astype(np.int32)]
    build_heap_file(os.path.join(workdir, HEAP_NAME), cols, schema)
    tree = {"w": rng.standard_normal((4 * n_global_devices, 16))
                    .astype(np.float32),
            "step": np.int32(7)}
    save_checkpoint(os.path.join(workdir, CKPT_NAME), tree)

    qschema = query_fixture_schema()
    qrows = qschema.tuples_per_page * (n_pages + QUERY_TAIL_PAGES)
    qrng = np.random.default_rng(4321)
    build_heap_file(os.path.join(workdir, QUERY_NAME), [
        qrng.integers(-100, 100, qrows).astype(np.int32),
        qrng.integers(0, 50, qrows).astype(np.int32),
        qrng.standard_normal(qrows).astype(np.float32)], qschema,
        visibility=(qrng.random(qrows) > 0.2).astype(np.int32))
    k1 = np.arange(-40, 40, dtype=np.int32)
    build_heap_file(os.path.join(workdir, DIM_NAMES[0]),
                    [k1, (k1 * 7).astype(np.int32)], _dim_schema())
    k2 = np.arange(0, 25, dtype=np.int32)
    build_heap_file(os.path.join(workdir, DIM_NAMES[1]),
                    [k2, (k2 * 0.5).astype(np.float32)], _dim_schema(True))
    kb = qrng.permutation(np.arange(-1500, 1500, dtype=np.int32))
    build_heap_file(os.path.join(workdir, BUILD_NAME),
                    [kb, (kb * 3).astype(np.int32)], _dim_schema())


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(num_processes: int, devices_per_proc: int,
           workdir: Optional[str] = None, *, timeout: float = 420.0,
           device: str = "cpu", backend: Optional[str] = None,
           table: Optional[dict] = None) -> List[Dict]:
    """Spawn *num_processes* ranks over one TCP rendezvous and return their
    result dicts (rank order).  *device* is the members' type (``cpu`` or
    ``cuda``), *backend* the process group's (None: :mod:`..parallel.dist`
    chooses).  *table* (``{"path", "n_cols", "dtypes", "visibility",
    "threshold", "count", "sums", "batch_pages"}``) puts another heap
    table, with its expected ``col0 > threshold`` count and int32 sums, in
    place of the fixture's for ``scan_step`` and ``stream_fold``; its
    optional ``"query_faces"`` (names of :data:`QUERY_CHECKS`) run on it
    too, with ``col0 > query_threshold`` and, for ``q_pjoin_query``, the
    build table ``join_build`` (``{"path", "n_cols", "dtypes"}``), in
    ``batch_pages`` batches.

    Raises ``RuntimeError`` with the failing rank's log tail on a nonzero
    exit, a missing result or a failed check; the first rank to die is
    blamed and its blocked peers are killed."""
    own_dir = workdir is None
    if own_dir:
        workdir = tempfile.mkdtemp(prefix="strom_dist_")
    try:
        return _launch_in(num_processes, devices_per_proc, workdir, timeout,
                          device, backend, table)
    finally:
        if own_dir:
            import shutil
            shutil.rmtree(workdir, ignore_errors=True)


def _launch_in(num_processes, devices_per_proc, workdir, timeout, device,
               backend, table) -> List[Dict]:
    os.makedirs(workdir, exist_ok=True)
    prepare_fixtures(workdir, num_processes * devices_per_proc)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs, logs = [], []
    for rank in range(num_processes):
        spec = {"rank": rank, "world": num_processes,
                "devices_per_proc": devices_per_proc, "port": port,
                "workdir": workdir, "device": device, "backend": backend,
                "table": table}
        spec_path = os.path.join(workdir, f"spec_{rank}.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        log_path = os.path.join(workdir, f"worker_{rank}.log")
        logs.append(log_path)
        lf = open(log_path, "wb")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "nvme_strom_tpu_torch.testing.distributed",
             spec_path], env=env, cwd=_REPO_ROOT, stdout=lf,
            stderr=subprocess.STDOUT), lf))

    # poll every rank: one that dies mid-run leaves its peers blocked in a
    # collective, so a wait in rank order would burn the whole timeout on
    # a hung peer and blame its clean log; the first nonzero exit wins and
    # the rest are killed
    deadline = time.monotonic() + timeout
    first_bad: Optional[int] = None
    try:
        while True:
            running = [r for r, (p, _lf) in enumerate(procs)
                       if p.poll() is None]
            for r, (p, _lf) in enumerate(procs):
                if p.poll() is not None and p.returncode != 0 \
                        and first_bad is None:
                    first_bad = r
            if first_bad is not None or not running:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"distributed workers {running} timed out after "
                    f"{timeout}s; log: {_tail(logs[running[0]])}")
            time.sleep(0.05)
    finally:
        for p, lf in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            lf.close()
    if first_bad is not None:
        raise RuntimeError(
            f"distributed worker {first_bad} exited "
            f"rc={procs[first_bad][0].returncode}; "
            f"log: {_tail(logs[first_bad])}")
    results = []
    for r in range(num_processes):
        rpath = os.path.join(workdir, f"result_{r}.json")
        if not os.path.exists(rpath):
            raise RuntimeError(f"worker {r} wrote no result; "
                               f"log: {_tail(logs[r])}")
        with open(rpath) as f:
            results.append(json.load(f))
    for r in results:
        if not r.get("ok"):
            raise RuntimeError(f"worker {r.get('process_id')} failed: {r}")
    return results


def _tail(path: str, n: int = 2500) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, 2)
            f.seek(max(f.tell() - n, 0))
            return f.read().decode("utf-8", "replace")
    except OSError:
        return "<no log>"


# ---------------------------------------------------------------------------
# worker (child process)
# ---------------------------------------------------------------------------

def _expected(pages_np: np.ndarray, schema, threshold: int):
    """``col0 > threshold`` over every valid row: (count, int32 sums),
    from the plain decode on the host."""
    import torch
    from ..ops.filter import decode_pages
    cols, valid = decode_pages(torch.from_numpy(pages_np), schema)
    sel = (valid & (cols[0] > threshold)).numpy()
    sums = [int(np.uint32(np.where(sel, c.numpy(), 0).astype(np.int64).sum()
                          & 0xFFFFFFFF).view(np.int32)) for c in cols]
    return int(sel.sum()), sums, cols, valid


def _worker_main(spec: dict) -> None:
    rank, world = int(spec["rank"]), int(spec["world"])
    dpp = int(spec["devices_per_proc"])
    workdir = spec["workdir"]
    from ..parallel import dist
    backend = dist.init_process_group(
        rank, world, init_method=f"tcp://127.0.0.1:{spec['port']}",
        backend=spec.get("backend"), device_type=spec["device"])

    # test hook: die between init and the first collective, so launch()'s
    # failure attribution (blame the dead rank, kill its blocked peer) can
    # be exercised; os._exit skips every atexit teardown
    if os.environ.get("STROM_TEST_DIE_AFTER_INIT") and rank == 1:
        os._exit(41)

    import torch
    from ..data.checkpoint import (checkpoint_info, restore_checkpoint,
                                   save_checkpoint_sharded)
    from ..engine import open_source
    from ..ops import filter_cuda, groupby_cuda
    from ..ops.filter import STEP_PRED
    from ..parallel.dscan import make_distributed_scan_step
    from ..parallel.mesh import RingSharding, ShardedTensor, make_scan_mesh
    from ..parallel.stream import distributed_scan_filter, load_pages_sharded
    from ..scan.heap import PAGE_SIZE, HeapSchema

    if dpp <= 0:
        raise SystemExit(f"rank {rank}: {dpp} members a rank")
    if spec["device"] == "cuda":
        card = rank if backend == "nccl" else 0
        members = [torch.device("cuda", card)] * dpp
    else:
        members = [torch.device("cpu")] * dpp
    mesh = make_scan_mesh(members)
    n_global, n_local = mesh.size, len(mesh.local)
    assert n_global == world * dpp, (n_global, world, dpp)
    assert n_local == dpp, (n_local, dpp)

    schema = _make_schema()
    heap_path = os.path.join(workdir, HEAP_NAME)
    pages_np = np.fromfile(heap_path, np.uint8).reshape(-1, PAGE_SIZE)
    result = {"process_id": rank, "n_global": n_global, "n_local": n_local,
              "backend": backend, "members": [str(d) for d in members],
              "checks": {}, "b1_launches": {}}
    saved: Dict[str, np.ndarray] = {}

    def host(t):
        from ..scan.executor import _to_numpy
        return _to_numpy(t)

    # 1. sharded direct load: every addressable shard holds exactly its
    #    own page rows, and only those were read
    with open_source(heap_path) as src:
        shards = load_pages_sharded(src, mesh)
    seen_rows = 0
    r = pages_np.shape[0] // mesh.dp
    for i, t in shards.addressable():
        got = host(t)
        np.testing.assert_array_equal(got, pages_np[i * r:(i + 1) * r])
        saved[f"load_m{i}"] = got
        seen_rows += got.shape[0]
    assert [i for i, _ in shards.addressable()] == list(mesh.local)
    assert seen_rows == pages_np.shape[0] * n_local // n_global
    result["checks"]["sharded_load"] = seen_rows

    # 2. the distributed scan step over sp lanes, folded by the
    #    cross-process psum; the oracle is the plain decode of the table
    tab = spec.get("table")
    if tab:
        tschema = HeapSchema(n_cols=int(tab["n_cols"]),
                             visibility=bool(tab["visibility"]),
                             dtypes=None if tab.get("dtypes") is None
                             else tuple(tab["dtypes"]))
        tpath, th = tab["path"], int(tab["threshold"])
        tpages = np.memmap(tpath, np.uint8, "r").reshape(-1, PAGE_SIZE)
        exp_count, exp_sums = int(tab["count"]), [int(v) for v in
                                                  tab["sums"]]
        batch_pages = int(tab["batch_pages"])
    else:
        tschema, tpath, th, tpages = schema, heap_path, 0, pages_np
        exp_count, exp_sums, _c, _v = _expected(pages_np, schema, 0)
        batch_pages = n_global
    sp = 2 if n_global % 2 == 0 else 1
    run, smesh = make_distributed_scan_step(mesh, sp=sp, schema=tschema)
    filter_cuda.launches = 0
    if tab:
        # a large table goes through in batches; the int32 folds wrap
        if len(tpages) % batch_pages:
            raise SystemExit(f"{len(tpages)} pages are not whole batches "
                             f"of {batch_pages}")
        got_count, acc = 0, np.zeros(tschema.n_cols, np.int64)
        for b0 in range(0, len(tpages), batch_pages):
            out = run(torch.from_numpy(np.array(tpages[b0:b0 + batch_pages])),
                      np.int32(th))
            got_count += int(out["count"])
            acc += host(out["sums"]).astype(np.int64)
        got_sums = [int(np.uint32(v & 0xFFFFFFFF).view(np.int32))
                    for v in acc]
        out = {"count": got_count, "sums": np.asarray(got_sums, np.int32)}
    else:
        out = run(torch.from_numpy(tpages), np.int32(th))
        got_count = int(out["count"])
        got_sums = [int(v) for v in host(out["sums"]).astype(np.int64)]
    result["b1_launches"]["scan_step"] = filter_cuda.launches
    assert got_count == exp_count, (got_count, exp_count)
    assert got_sums == exp_sums, (got_sums, exp_sums)
    saved["scan_count"] = np.asarray(got_count)
    saved["scan_sums"] = host(out["sums"])
    result["checks"]["scan_step"] = {"count": got_count, "sp": sp}

    # 3. the streamed fold over the same mesh: each rank reads the dp
    #    shards of its own members, batch by batch
    filter_cuda.launches = 0
    with open_source(tpath) as src:
        folded = distributed_scan_filter(
            src, smesh, lambda a: run(a, np.int32(th)),
            batch_pages=batch_pages)
    result["b1_launches"]["stream_fold"] = filter_cuda.launches
    assert int(folded["count"]) == exp_count, \
        (int(folded["count"]), exp_count)
    saved["fold_count"] = np.asarray(folded["count"])
    saved["fold_sums"] = np.asarray(folded["sums"])
    result["checks"]["stream_fold"] = int(folded["count"])
    if members[0].type == "cuda":
        # B1 against its plain version on one member batch of this rank
        # (the table's first, the fixture's shard without one)
        one = torch.from_numpy(np.array(
            tpages[:max(batch_pages // mesh.dp, 1)])).to(members[0]) \
            if tab else shards[mesh.local[0]]
        k = filter_cuda.filter_pages_cuda(one, np.int32(th), tschema,
                                          STEP_PRED)
        p = filter_cuda.filter_pages_cuda(one.cpu(), np.int32(th), tschema,
                                          STEP_PRED)
        err = max(abs(int(k["count"]) - int(p["count"])),
                  max(abs(int(a) - int(b)) for a, b in
                      zip(host(torch.stack(list(k["sums"]))),
                          host(torch.stack(list(p["sums"]))))))
        result["b1_vs_plain_max_abs_err"] = err
        assert err == 0, f"B1 disagrees with its plain version by {err}"
        # ... and B3, the GROUP BY kernel of q_group_by, on the same batch
        from ..ops.filter import FilterPred
        from ..ops.groupby import GroupKey
        gargs = (tschema, GroupKey(1, mod=16), 16)
        gkw = dict(agg_cols=[0], predicate=FilterPred(((0, "gt", th),)))
        l3 = groupby_cuda.launches
        k = groupby_cuda.groupby_pages_cuda(one, 0, *gargs, **gkw)
        p = groupby_cuda.groupby_pages_cuda(one.cpu(), 0, *gargs, **gkw)
        assert groupby_cuda.launches == l3 + 1, "B3 did not launch"
        err = max(int(np.abs(host(k[f]).astype(np.int64)
                             - host(p[f]).astype(np.int64)).max())
                  for f in ("count", "sums", "mins", "maxs"))
        result["b3_vs_plain_max_abs_err"] = err
        assert err == 0, f"B3 disagrees with its plain version by {err}"

    # 4. the sample sort: splitter gather and bucket all-to-all across
    #    ranks; each rank checks its own buckets against numpy
    from ..parallel.sort import make_distributed_sort
    rng = np.random.default_rng(99)
    svals = rng.integers(-10_000, 10_000, 64 * n_global).astype(np.int32)
    srun, _ = make_distributed_sort(mesh, capacity=len(svals))
    sout = srun(svals)
    assert int(sout["n_dropped"]) == 0
    scounts = host(sout["count"]).reshape(-1)
    sorted_all = np.sort(svals)
    bounds = np.concatenate([[0], np.cumsum(scounts)])
    for b, t in sout["values"].addressable():
        got = host(t)[:scounts[b]]
        np.testing.assert_array_equal(got, sorted_all[bounds[b]:
                                                      bounds[b + 1]])
        saved[f"sort_m{b}"] = got
    saved["sort_count"] = scounts
    # ... and the bucket exchange on its own: each rank's buckets hold
    # exactly the rows whose key names its members
    from ..parallel.exchange import make_bucket_exchange
    xrows = rng.integers(-1000, 1000, (32 * n_global, 2)).astype(np.int32)
    xkeys = rng.integers(0, mesh.dp, 32 * n_global).astype(np.int32)
    xrun, _ = make_bucket_exchange(mesh, capacity=len(xkeys), width=2)
    xout = xrun(xrows, xkeys)
    assert int(xout["n_dropped"]) == 0
    cap, per = len(xkeys), len(xkeys) // mesh.dp
    for b, t in enumerate(xout["rows"]):
        if t is None:
            continue
        got = host(t)
        # sender s's slab: the rows of its contiguous range bound for b,
        # in arrival order
        for sdr in range(mesh.dp):
            want = xrows[sdr * per:(sdr + 1) * per][
                xkeys[sdr * per:(sdr + 1) * per] == b]
            np.testing.assert_array_equal(
                got[sdr * cap:sdr * cap + len(want)], want)
        saved[f"xch_m{b}"] = got
    saved["xch_count"] = host(xout["count"]).reshape(-1)
    result["checks"]["dist_sort"] = int(scounts.sum())

    # 5. the sharded restore: a dp-sharded leaf against the file's raw
    #    bytes (no framework code), the scalar whole
    ck_path = os.path.join(workdir, CKPT_NAME)
    meta = checkpoint_info(ck_path)
    leaves = {e["key"]: e for e in meta["leaves"]}
    wmeta = leaves["['w']"]
    wshape = tuple(wmeta["shape"])
    raw_w = np.fromfile(ck_path, np.uint8, count=wmeta["nbytes"],
                        offset=meta["data_offset"] + wmeta["offset"]
                        ).view(wmeta["dtype"]).reshape(wshape)
    sh = RingSharding(mesh, spec=("dp", None))
    restored = restore_checkpoint(ck_path, shardings={"['w']": sh},
                                  device=mesh.home())
    rw = restored["['w']"]
    assert rw.shape == wshape
    for i, idx, t in rw.addressable_shards():
        np.testing.assert_array_equal(host(t), raw_w[idx])
        saved[f"ckpt_m{i}"] = host(t)
    np.testing.assert_array_equal(host(restored["['step']"]), np.int32(7))
    result["checks"]["ckpt_restore"] = list(wshape)

    # 6. the sharded SAVE: each rank writes only its own shards into one
    #    shared file (the replicated leaf once); the oracle is the file's
    #    bytes against the global value
    wsave = (np.arange(np.prod(wshape), dtype=np.float32)
             .reshape(wshape) * 0.5)
    idxs = sh.indices(wshape)
    wsh = ShardedTensor([torch.from_numpy(wsave[idxs[i]].copy()).to(
        mesh.devices[i]) if mesh.is_local(i) else None
        for i in range(mesh.size)], sh)
    rsh = RingSharding(mesh, axis=None)
    rep = ShardedTensor([torch.arange(3, dtype=torch.int32).to(
        mesh.devices[i]) if mesh.is_local(i) else None
        for i in range(mesh.size)], rsh)
    save_path = os.path.join(workdir, "saved.strom")
    save_checkpoint_sharded(save_path, {"w": wsh, "r": rep,
                                        "step": np.int32(11)})
    smeta = checkpoint_info(save_path)
    sl = {e["key"]: e for e in smeta["leaves"]}
    raw_saved = np.fromfile(save_path, np.float32,
                            count=int(np.prod(wshape)),
                            offset=smeta["data_offset"]
                            + sl["['w']"]["offset"]).reshape(wshape)
    np.testing.assert_array_equal(raw_saved, wsave)
    raw_rep = np.fromfile(save_path, np.int32, count=3,
                          offset=smeta["data_offset"]
                          + sl["['r']"]["offset"])
    np.testing.assert_array_equal(raw_rep, np.arange(3, dtype=np.int32))
    back = restore_checkpoint(save_path, shardings={"['w']": sh},
                              device=mesh.home())
    for _i, idx, t in back["['w']"].addressable_shards():
        np.testing.assert_array_equal(host(t), wsave[idx])
    result["checks"]["ckpt_save_sharded"] = list(wshape)

    # 7. the partitioned hash join: build hash-split over dp, rows routed
    #    to their key's owner across ranks, local sorted probe, psum
    from ..ops.join import key_hash32
    from ..parallel.pjoin import (combine_pos_words,
                                  make_partitioned_join_rows_step,
                                  make_partitioned_join_step)
    _n, _s, cols, valid = _expected(pages_np, schema, 0)
    jkeys = np.arange(-60, 60, dtype=np.int32)
    jstep = make_partitioned_join_step(mesh, schema, 0, jkeys,
                                       (jkeys * 3).astype(np.int32))
    jout = jstep(pages_np)
    c0v = cols[0].numpy().reshape(-1)
    vv = valid.numpy().reshape(-1).astype(bool)
    exp_m = int((vv & np.isin(c0v, jkeys)).sum())
    got_m = int(jout["matched"])
    assert got_m == exp_m, (got_m, exp_m)
    saved["pjoin_matched"] = np.asarray(got_m)
    saved["pjoin_sums"] = np.asarray([int(x) for x in jout["sums"]])
    saved["pjoin_payload_sum"] = host(jout["payload_sum"])
    result["checks"]["pjoin"] = got_m

    # 7b. the row face: each rank sees the outcomes of the rows routed to
    #     ITS members, so its oracle is the valid matching rows whose key's
    #     hash owner is one of its dp indices
    jrstep = make_partitioned_join_rows_step(
        mesh, schema, 0, jkeys, (jkeys * 3).astype(np.int32))
    jr = {k: host(v) for k, v in jrstep(pages_np).items()}
    hit = jr["hit"].astype(bool)
    mypos = np.sort(combine_pos_words(jr["pos_lo"][hit], jr["pos_hi"][hit]))
    owner = (key_hash32(c0v) % np.uint32(mesh.dp)).astype(np.int64)
    exp_pos = np.flatnonzero(vv & np.isin(c0v, jkeys)
                             & np.isin(owner, list(mesh.local)))
    np.testing.assert_array_equal(mypos, exp_pos)
    for k, v in jr.items():
        saved[f"pjr_{k}"] = v
    result["checks"]["pjoin_rows"] = int(len(mypos))

    # 7c. value-keyed GROUP BY: keys discovered across ranks, then the
    #     fold; the replicated result equals the global oracle on every
    #     rank
    from ..config import config
    from ..scan.query import Query
    snap = config.snapshot()
    try:
        config.set("debug_no_threshold", True)
        gout = Query(heap_path, schema).group_by_cols(
            1, agg_cols=[0]).run(mesh=mesh)
    finally:
        config.restore(snap)
    c1v = cols[1].numpy().reshape(-1)
    want_keys = np.unique(c1v[vv])
    np.testing.assert_array_equal(np.asarray(gout["key_cols"][0]),
                                  want_keys)
    assert int(np.asarray(gout["count"]).sum()) == int(vv.sum())
    for k, v in gout.items():
        if k == "key_cols":
            saved["gb_key0"] = np.asarray(v[0])
        elif isinstance(v, (np.ndarray, np.generic, int, float)):
            saved[f"gb_{k}"] = np.asarray(v)
    result["checks"]["group_by_cols"] = int(len(want_keys))

    # 8. every Query face over the ranks' mesh
    _query_checks(spec, mesh, result, saved)

    np.savez(os.path.join(workdir, f"out_{rank}.npz"), **saved)
    result["ok"] = True
    with open(os.path.join(workdir, f"result_{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.barrier("done")
    dist.shutdown()


class _Table:
    """Where a query check runs: the table, its schema, the predicate
    ``c0 > threshold``, the batch size and the partitioned build table."""

    def __init__(self, path, schema, threshold, batch_pages, build,
                 build_schema):
        from ..ops.filter import FilterPred
        self.path, self.schema, self.bp = path, schema, batch_pages
        self.threshold = int(threshold)
        self.pred = FilterPred(((0, "gt", self.threshold),))
        self.build, self.build_schema = build, build_schema
        self.n_bytes = os.path.getsize(path)


def _jsonable(v):
    """A result value as JSON: arrays as lists, numpy scalars as Python
    ones, None kept."""
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, np.ndarray):
        return [_jsonable(x) for x in v.tolist()] if v.dtype.kind == "O" \
            else v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


def _flat(prefix: str, out: dict) -> Dict[str, np.ndarray]:
    """A Query result as ``{prefix_key: array}`` (list-valued keys one
    array an element; ``_analyze`` and plans dropped)."""
    flat = {}
    for k, v in out.items():
        if k.startswith("_"):
            continue
        if isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                flat[f"{prefix}_{k}{i}"] = np.asarray(x)
        else:
            flat[f"{prefix}_{k}"] = np.asarray(v)
    return flat


def _query_faces(mesh, dims) -> Dict[str, object]:
    """The query checks: each ``face(table) -> (outputs, sql results)``,
    run over *mesh* (every call a collective: every rank runs the same
    faces in the same order)."""
    from ..ops.groupby import GroupKey
    from ..scan.index import build_index, index_path_for, probe_index
    from ..scan.query import Query
    from ..scan.sql import sql_query
    from ..parallel import dist

    def run(t, build, **kw):
        return build(Query(t.path, t.schema).where(t.pred)).run(
            mesh=mesh, batch_pages=t.bp, **kw)

    def faces(t, named):
        out = {}
        for tag, build in named.items():
            out.update(_flat(tag, run(t, build)))
        return out, None

    dkeys = np.arange(-40, 40, dtype=np.int32)
    dvals = (dkeys * 7).astype(np.int32)

    def star_specs():
        return [{"probe_col": 0, "table": dims[0], "schema": _dim_schema(),
                 "key_col": 0, "value_col": 1, "how": "inner"},
                {"probe_col": 1, "table": dims[1],
                 "schema": _dim_schema(True), "key_col": 0, "value_col": 1,
                 "how": "left"}]

    def where_eq(t):
        eq = {"eq_agg": lambda q: q.where_eq(0, 7).aggregate(),
              "eq_rows": lambda q: q.where_eq(0, 7).select(),
              "in_agg": lambda q: q.where_in(0, [3, 5, 7]).aggregate(),
              "range_agg": lambda q: q.where_range(0, -5, 5).aggregate()}
        out = {}
        for tag, build in eq.items():
            out.update(_flat(tag, build(Query(t.path, t.schema)).run(
                mesh=mesh, batch_pages=t.bp)))
        # a fresh sidecar changes no mesh plan; the local run is the index
        # face (the sidecar and the fetched pages, no table scan).  A
        # table's own fresh sidecar serves, else one is built over the mesh
        # and removed after
        ipath = index_path_for(t.path, 0)
        built = not probe_index(ipath, t.path, expect_col=0)
        if built:
            ipath = build_index(t.path, t.schema, 0, mesh=mesh)
        try:
            q = Query(t.path, t.schema).where_eq(0, 7).aggregate()
            plans = (q.explain(mesh=mesh).access_path,
                     q.explain(device=mesh.home()).access_path)
            if plans[0] == "index" or plans[1] != "index":
                raise AssertionError(f"where_eq plans {plans}")
            out.update(_flat("sidecar_mesh", q.run(mesh=mesh,
                                                   batch_pages=t.bp)))
            from ..stats import stats
            d0 = stats.snapshot().get("total_dma_length", 0)
            out.update(_flat("index", Query(t.path, t.schema).where_eq(
                0, 7).aggregate().run(device=mesh.home())))
            out["index_dma"] = np.asarray(
                stats.snapshot().get("total_dma_length", 0) - d0)
        finally:
            dist.barrier("where_eq sidecar read")
            if built and dist.process_index() == mesh.owners[0]:
                os.unlink(ipath)
        return out, None

    def build_idx(t):
        out = {}
        work = os.path.dirname(dims[0])
        for tag, col in (("c1", 1), ("pair", (0, 1))):
            p = build_index(t.path, t.schema, col, mesh=mesh,
                            index_path=os.path.join(work, f"q_{tag}.idx"))
            out[tag] = np.fromfile(p, np.uint8)
        return out, None

    def spill(t):
        # one accumulator dtype a GROUP BY: int32 c0, float32 c2
        fagg = [2] if t.schema.n_cols > 2 else [0]
        out = {}
        for tag, key, agg in (("one", 1, [0]), ("pair", [0, 1], fagg)):
            r = Query(t.path, t.schema).group_by_cols(
                key, agg_cols=agg, max_groups=SPILL_MAX_GROUPS).run(
                mesh=mesh, batch_pages=t.bp)
            for i, k in enumerate(r.pop("key_cols")):
                out[f"{tag}_key{i}"] = k
            out.update(_flat(tag, r))
        return out, None

    def sql(t):
        th = t.threshold
        tables = {"d": (dims[0], _dim_schema()),
                  "e": (dims[1], _dim_schema(True))}
        stmts = [
            "SELECT COUNT(*), SUM(c0), AVG(c0) FROM t WHERE c0 > 1000",
            f"SELECT COUNT(*), SUM(c0), SUM(c1) FROM t WHERE c0 > {th}",
            f"SELECT c0, COUNT(*), SUM(c1) FROM t WHERE c0 > {th} "
            f"GROUP BY c0",
            f"SELECT c0, c1 FROM t WHERE c0 > {th} ORDER BY c1 LIMIT 5",
            "SELECT c0, c1 FROM t WHERE c0 = 7 LIMIT 4 OFFSET 2",
            "SELECT COUNT(*), SUM(c1), SUM(d.c1) FROM t JOIN d ON c0 = d.c0",
            "SELECT COUNT(*), SUM(c1), SUM(d.c1) FROM t JOIN d ON c0 = d.c0 "
            "WHERE c0 > 1000",
            "SELECT COUNT(*), SUM(c0), SUM(d.c1), SUM(e.c1) FROM t JOIN d ON "
            "c0 = d.c0 LEFT JOIN e ON c1 = e.c0",
            "SELECT COUNT(*), SUM(c0), SUM(d.c1), SUM(e.c1) FROM t JOIN d ON "
            "c0 = d.c0 LEFT JOIN e ON c1 = e.c0 WHERE c0 > 1000"]
        return None, [[q, _jsonable(sql_query(q, t.path, t.schema,
                                              tables=tables, mesh=mesh,
                                              batch_pages=t.bp))]
                      for q in stmts]

    return {
        "q_select": lambda t: faces(t, {
            "all": lambda q: q.select(),
            "win": lambda q: q.select(limit=700, offset=1000),
            "head": lambda q: q.select([1], limit=50, offset=7)}),
        "q_order_by": lambda t: faces(t, {
            "asc": lambda q: q.order_by(1),
            "desc": lambda q: q.order_by(1, descending=True, limit=1000,
                                         offset=500)}),
        "q_quantiles": lambda t: faces(t, {
            "q": lambda q: q.quantiles(1, [0.0, 0.25, 0.5, 0.99, 1.0])}),
        "q_count_distinct": lambda t: faces(t, {
            "d0": lambda q: q.count_distinct(0),
            "d1": lambda q: q.count_distinct(1)}),
        "q_top_k": lambda t: faces(t, {
            "max": lambda q: q.top_k(1, 10),
            "min": lambda q: q.top_k(0, 5, largest=False)}),
        "q_group_by": lambda t: faces(t, {
            "g": lambda q: q.group_by(GroupKey(1, mod=16), 16,
                                      agg_cols=[0])}),
        "q_join": lambda t: faces(t, {
            "inner": lambda q: q.join(0, dkeys, dvals),
            "left": lambda q: q.join(0, dkeys, dvals, how="left")}),
        "q_join_rows": lambda t: faces(t, {
            "inner": lambda q: q.join(0, dkeys, dvals, materialize=True,
                                      limit=300, offset=20),
            "left": lambda q: q.join(0, dkeys, dvals, materialize=True,
                                     how="left")}),
        "q_pjoin_query": lambda t: faces(t, {
            "agg": lambda q: q.join_table(0, t.build, t.build_schema, 0, 1),
            "rows": lambda q: q.join_table(0, t.build, t.build_schema, 0, 1,
                                           materialize=True, limit=400,
                                           offset=10)}),
        "q_star": lambda t: faces(t, {
            "agg": lambda q: q.star_join(star_specs()),
            "rows": lambda q: q.star_join(star_specs(), materialize=True,
                                          fact_cols=[0, 1], limit=100,
                                          offset=5)}),
        "q_where_eq": where_eq,
        "q_build_index": build_idx,
        "q_groupby_spill": spill,
        "q_sql": sql,
    }


def _query_checks(spec: dict, mesh, result: dict, saved: dict) -> None:
    """Run :data:`QUERY_CHECKS` over *mesh*: each face on the query
    fixture or on ``spec["table"]``, its outputs held equal on every rank
    and saved, with its time, this rank's engine bytes and its B1 / B3
    launches."""
    import hashlib

    from ..config import config
    from ..ops import filter_cuda, groupby_cuda
    from ..parallel import dist
    from ..scan.heap import HeapSchema
    from ..stats import stats

    workdir = spec["workdir"]
    dims = [os.path.join(workdir, n) for n in DIM_NAMES]
    fixture = _Table(os.path.join(workdir, QUERY_NAME),
                     query_fixture_schema(), 0, None,
                     os.path.join(workdir, BUILD_NAME), _dim_schema())
    tab = spec.get("table") or {}
    given = None
    if tab.get("query_faces"):
        jb = tab["join_build"]
        given = _Table(
            tab["path"], HeapSchema(
                n_cols=int(tab["n_cols"]), visibility=bool(tab["visibility"]),
                dtypes=None if tab.get("dtypes") is None
                else tuple(tab["dtypes"])),
            tab["query_threshold"], int(tab["batch_pages"]), jb["path"],
            HeapSchema(n_cols=int(jb["n_cols"]), visibility=False,
                       dtypes=None if jb.get("dtypes") is None
                       else tuple(jb["dtypes"])))
    faces = _query_faces(mesh, dims)
    for key in ("dma", "q_seconds", "q_table", "b3_launches"):
        result.setdefault(key, {})
    snap = config.snapshot()
    try:
        config.set("join_broadcast_max", JOIN_BROADCAST_MAX)
        # every chunk read direct, page-cached or not: the engine's bytes
        # are then each rank's share of the table
        config.set("cache_arbitration", False)
        for name in QUERY_CHECKS:
            t = given if given is not None and name in tab["query_faces"]                 else fixture
            l1, l3 = filter_cuda.launches, groupby_cuda.launches
            d0 = stats.snapshot().get("total_dma_length", 0)
            dist.barrier(name)
            t0 = time.monotonic()
            arrays, sql = faces[name](t)
            dt = time.monotonic() - t0
            result["dma"][name] = int(
                stats.snapshot().get("total_dma_length", 0) - d0)
            result["b1_launches"][name] = filter_cuda.launches - l1
            result["b3_launches"][name] = groupby_cuda.launches - l3
            result["q_seconds"][name] = dt
            result["q_table"][name] = {"path": t.path, "bytes": t.n_bytes}
            h = hashlib.sha256()
            for k in sorted(arrays or {}):
                a = np.ascontiguousarray(arrays[k])
                h.update(f"{k}:{a.dtype.str}:{a.shape}".encode())
                h.update(a.tobytes())
            h.update(json.dumps(sql, sort_keys=True).encode())
            digests = dist.all_gather_object(h.hexdigest())
            if len(set(digests)) != 1:
                raise AssertionError(f"{name}: the ranks' results differ "
                                     f"({digests})")
            for k, v in (arrays or {}).items():
                saved[f"{name}__{k}"] = v
            result["checks"][name] = sql if sql is not None \
                else len(arrays)
    finally:
        config.restore(snap)


if __name__ == "__main__":
    with open(sys.argv[1]) as _f:
        _worker_main(json.load(_f))
