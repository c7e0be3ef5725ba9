"""Multi-process proof harness: ranks over ``torch.distributed``.

A port of the JAX package's ``testing/distributed.py``.  The reference's
multi-worker story is process-parallel PostgreSQL workers sharing DSM
state (`pgsql/nvme_strom.c:1057-1112`); its TPU analog is multi-host SPMD,
where every process owns a slice of the global mesh and touches only its
**addressable** shards.  A single-process mesh cannot prove that posture,
so this module launches separate processes joined by
:func:`..parallel.dist.init_process_group` and runs nine checks across
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
  result on every rank.

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
CHECKS = ("sharded_load", "scan_step", "stream_fold", "dist_sort",
          "ckpt_restore", "ckpt_save_sharded", "pjoin", "pjoin_rows",
          "group_by_cols")

__all__ = ["prepare_fixtures", "launch", "CHECKS", "HEAP_NAME", "CKPT_NAME"]


# ---------------------------------------------------------------------------
# fixtures (parent side)
# ---------------------------------------------------------------------------

def _make_schema():
    from ..scan.heap import HeapSchema
    return HeapSchema(n_cols=2, visibility=True)


def prepare_fixtures(workdir: str, n_global_devices: int) -> None:
    """Write the shared inputs every worker reads: a heap table of two
    pages a member and a checkpoint with one dp-shardable leaf and a
    scalar (the reference's, from the same seed)."""
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
    place of the fixture's for ``scan_step`` and ``stream_fold``.

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
    from ..ops import filter_cuda
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

    np.savez(os.path.join(workdir, f"out_{rank}.npz"), **saved)
    result["ok"] = True
    with open(os.path.join(workdir, f"result_{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.barrier("done")
    dist.shutdown()


if __name__ == "__main__":
    with open(sys.argv[1]) as _f:
        _worker_main(json.load(_f))
