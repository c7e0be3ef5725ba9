"""NUMA binding of the PyTorch port's scans and lanes (``numa.py``, the
engine's ``_pin_lanes``, ``DmaBuffer(numa_node=)``, the per-node
freelists of ``scan/pool.py``, ``TableScanner(numa_bind=)``) against the
JAX package: the counterparts of the NUMA tests of
``tests/test_stripe_lanes.py`` (``auto`` without topology, ``node:N``,
the policy's validation) and ``tests/test_scan_engine.py`` (the affinity
restored at close), plus ``parse_cpulist``, ``nodes_with_memory``,
``node_cpus`` and ``allowed_nodes`` over fake sysfs trees, each through
both packages.

The JAX oracle comes from its pure functions and its python pool path:
nothing here needs the JAX package's native library.  The stripe reads
run on the port's native engine, whose lanes are the ones pinned."""

import os
import threading
import types

import numpy as np
import pytest

import nvme_strom_tpu.engine as jeng
import nvme_strom_tpu.numa as jnuma
import nvme_strom_tpu.scan.executor as jexec
import nvme_strom_tpu.scan.pool as jpool
from nvme_strom_tpu.config import config as jcfg
import nvme_strom_tpu_torch.engine as teng
import nvme_strom_tpu_torch.numa as tnuma
import nvme_strom_tpu_torch.scan.executor as texec
import nvme_strom_tpu_torch.scan.planner as tplanner
import nvme_strom_tpu_torch.scan.pool as tpool
from nvme_strom_tpu_torch.config import ConfigError
from nvme_strom_tpu_torch.config import config as tcfg
from nvme_strom_tpu_torch.scan.heap import HeapSchema, build_heap_file
from nvme_strom_tpu_torch.testing import make_test_file, reset_residency

CHUNK = 256 << 10
STRIPE = 64 << 10
NUMAS = {"jax": jnuma, "torch": tnuma}


@pytest.fixture(autouse=True)
def _configs():
    snap, jsnap = tcfg.snapshot(), jcfg.snapshot()
    reset_residency()
    tcfg.set("cache_arbitration", False)
    aff = os.sched_getaffinity(0)
    yield
    os.sched_setaffinity(0, aff)
    tcfg.restore(snap)
    jcfg.restore(jsnap)
    reset_residency()


def _fake_sysfs(root, nodes, *, has_memory=True, online=True):
    """A ``/sys/devices/system/node`` tree: *nodes* maps node -> cpulist
    text (None: no cpulist file)."""
    base = root / "node"
    base.mkdir()
    text = ",".join(str(n) for n in sorted(nodes))
    if has_memory:
        (base / "has_memory").write_text(text + "\n")
    if online:
        (base / "online").write_text(text + "\n")
    for n, cpus in nodes.items():
        d = base / f"node{n}"
        d.mkdir()
        if cpus is not None:
            (d / "cpulist").write_text(cpus + "\n")
    return str(base)


@pytest.fixture()
def sysfs(tmp_path, monkeypatch):
    """Point both packages' NUMA readers at a fake tree."""
    def make(nodes, **kw):
        base = _fake_sysfs(tmp_path, nodes, **kw)
        for mod in NUMAS.values():
            monkeypatch.setattr(mod, "_SYS_NODE", base)
        return base
    return make


def _both(fn):
    out = {name: fn(mod) for name, mod in NUMAS.items()}
    assert out["torch"] == out["jax"], out
    return out["torch"]


# ---------------------------------------------------------------------------
# the sysfs readers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text,want", [
    ("0-3", [0, 1, 2, 3]),
    ("0-3,8,10-11", [0, 1, 2, 3, 8, 10, 11]),
    ("5", [5]),
    ("", []),
    ("0,,2\n", [0, 2]),
    ("16-17,0", [16, 17, 0]),
])
def test_parse_cpulist_like_reference(text, want):
    assert _both(lambda m: m.parse_cpulist(text)) == want


@pytest.mark.parametrize("mask,want", [
    (-1, [0, 1, 3]),
    (0b1, [0]),
    (0b1010, [1, 3]),
    (0b100, [0, 1, 3]),          # only absent nodes: every node
    (0, [0, 1, 3]),
])
def test_allowed_nodes_over_fake_sysfs(sysfs, mask, want):
    sysfs({0: "0-1", 1: "2-3", 3: "6"})
    assert _both(lambda m: m.allowed_nodes(mask)) == want


@pytest.mark.parametrize("layout,nodes", [
    (dict(has_memory=True, online=True), [0, 2]),
    (dict(has_memory=False, online=True), [0, 2]),
    (dict(has_memory=False, online=False), [0]),
])
def test_nodes_with_memory_fallbacks(sysfs, layout, nodes):
    """``has_memory``, else ``online``, else node 0 alone."""
    sysfs({0: "0", 2: None}, **layout)
    assert _both(lambda m: m.nodes_with_memory()) == nodes
    # a node without a cpulist answers with every cpu of the host
    assert _both(lambda m: m.node_cpus(2)) == \
        list(range(os.cpu_count() or 1))
    assert _both(lambda m: m.node_cpus(0)) == [0]


def test_bind_to_node_and_device_node(sysfs, tmp_path):
    """node -1 never binds; a node's cpu set binds the calling thread;
    the device's node comes from each package's eligibility walk."""
    mine = sorted(os.sched_getaffinity(0))
    sysfs({0: str(mine[0]), 1: "100000"})
    assert _both(lambda m: m.bind_to_node(-1)) is False
    for mod in NUMAS.values():
        assert mod.bind_to_node(0) is True
        assert os.sched_getaffinity(0) == {mine[0]}
        os.sched_setaffinity(0, mine)
        assert mod.bind_to_node(1) is False          # a refused set
        assert sorted(os.sched_getaffinity(0)) == mine
    path = str(tmp_path / "dev.bin")
    make_test_file(path, 4096)
    assert _both(lambda m: m.device_numa_node(path)) >= -1


# ---------------------------------------------------------------------------
# the lanes: numa_policy
# ---------------------------------------------------------------------------

def _members(tmp_path, n=4, size=1 << 20, tag="m"):
    paths = []
    for i in range(n):
        p = str(tmp_path / f"{tag}{i}.bin")
        make_test_file(p, size, seed=100 + i)
        paths.append(p)
    return paths


def _read_all(sess, src, chunk=CHUNK):
    total = src.size // chunk * chunk
    handle, buf = sess.alloc_dma_buffer(total)
    want = list(range(total // chunk))
    try:
        res = sess.memcpy_ssd2ram(src, handle, want, chunk)
        sess.memcpy_wait(res.dma_task_id)
        host = teng.reorder_chunks(np.frombuffer(buf.view()[:total],
                                                 np.uint8),
                                   chunk, res.chunk_ids, want)
        return bytes(host), total
    finally:
        sess.unmap_buffer(handle)


def _reference_stream(paths, total):
    """The JAX package's python pool over the same stripe set."""
    src = jeng.open_source(paths, stripe_chunk_size=STRIPE)
    try:
        with jeng.Session(io_backend="python") as sess:
            handle, buf = sess.alloc_dma_buffer(total)
            want = list(range(total // CHUNK))
            res = sess.memcpy_ssd2ram(src, handle, want, CHUNK)
            sess.memcpy_wait(res.dma_task_id)
            return bytes(jeng.reorder_chunks(
                np.frombuffer(buf.view()[:total], np.uint8), CHUNK,
                res.chunk_ids, want))
    finally:
        src.close()


def _striped_read(paths):
    with teng.open_source(paths, stripe_chunk_size=STRIPE) as src, \
            teng.Session(device="cpu") as sess:
        if sess._native is None:
            pytest.fail("the port's native engine did not come up")
        got, total = _read_all(sess, src)
        return got, total, sess._native.nlanes(), sess.lanes_pinned


def test_numa_auto_without_topology(tmp_path, monkeypatch):
    """``auto`` on a host whose devices' nodes are unknown leaves the
    lanes floating: the scale-out still happens, nothing raises, no cpu
    set is asked for."""
    monkeypatch.setattr(tnuma, "device_numa_node", lambda path: -1)
    calls = []
    monkeypatch.setattr(tnuma, "node_cpus",
                        lambda node: calls.append(node) or [])
    paths = _members(tmp_path)
    got, total, nlanes, pinned = _striped_read(paths)
    assert nlanes == 4 and pinned == 0
    assert calls == []
    assert got == _reference_stream(paths, total)


def test_numa_auto_pins_each_lane_to_its_members_node(tmp_path,
                                                      monkeypatch):
    """``auto`` with a known node a member: each lane asks for its first
    member's node and is pinned there."""
    cpu = min(os.sched_getaffinity(0))
    nodes = {}
    monkeypatch.setattr(tnuma, "device_numa_node",
                        lambda path: int(path[-5]) % 2)
    monkeypatch.setattr(tnuma, "node_cpus",
                        lambda node: nodes.setdefault(node, [cpu]))
    paths = _members(tmp_path)
    got, total, nlanes, pinned = _striped_read(paths)
    assert nlanes == pinned == 4
    assert sorted(nodes) == [0, 1]
    assert got == _reference_stream(paths, total)


def test_numa_fixed_node_policy(tmp_path, monkeypatch):
    """``node:N`` pins every lane to node N's cpus."""
    cpu = min(os.sched_getaffinity(0))
    asked = []
    monkeypatch.setattr(tnuma, "node_cpus",
                        lambda node: asked.append(node) or [cpu])
    tcfg.set("numa_policy", "node:0")
    paths = _members(tmp_path, n=2)
    got, total, nlanes, pinned = _striped_read(paths)
    assert nlanes == pinned == 2
    assert asked == [0, 0]
    assert got == _reference_stream(paths, total)


@pytest.mark.parametrize("case", ["off", "refused"])
def test_numa_off_or_refused_pins_nothing(tmp_path, monkeypatch, case):
    """``off`` asks for nothing; a pin the kernel refuses is logged and
    the read goes on, byte-identical."""
    import nvme_strom_tpu_torch._native as tnat
    asked = []
    monkeypatch.setattr(tnuma, "node_cpus",
                        lambda node: asked.append(node) or [0])
    if case == "off":
        tcfg.set("numa_policy", "off")
    else:
        tcfg.set("numa_policy", "node:0")
        monkeypatch.setattr(tnat.NativeEngine, "lane_pin",
                            lambda self, lane, cpus: False)
    paths = _members(tmp_path, n=2, tag=case)
    got, total, nlanes, pinned = _striped_read(paths)
    assert nlanes == 2 and pinned == 0
    assert asked == ([] if case == "off" else [0, 0])
    assert got == _reference_stream(paths, total)


@pytest.mark.parametrize("value", ["off", "auto", "node:0", "node:3",
                                   "node:-1", "node:x", "sideways", "node"])
def test_numa_policy_validation_like_reference(value):
    verdicts = []
    for cfg in (tcfg, jcfg):
        try:
            cfg.set("numa_policy", value)
            verdicts.append(True)
        except (ConfigError, ValueError):
            verdicts.append(False)
    assert verdicts[0] == verdicts[1], value
    assert tcfg.get("numa_node_mask") == jcfg.get("numa_node_mask") == -1


# ---------------------------------------------------------------------------
# buffers, the pool's freelists, the scan's binding
# ---------------------------------------------------------------------------

def test_dma_buffer_records_its_node():
    for eng in (teng, jeng):
        buf = eng.DmaBuffer(4096, numa_node=1)
        assert buf.numa_node == 1
        buf.close()
        assert eng.DmaBuffer(4096).numa_node == -1
    with teng.Session(device="cpu", io_backend="python") as sess:
        handle, buf = sess.alloc_dma_buffer(8192, numa_node=0)
        assert buf.numa_node == 0
        sess.unmap_buffer(handle)


@pytest.mark.parametrize("node", [0, 1, -1])
def test_dma_buffer_is_faulted_in_on_its_node(sysfs, monkeypatch, node):
    """A buffer given a node is locked and faulted in by a thread bound to
    that node's CPUs (the default local policy then places its pages
    there); the caller's affinity is untouched.  Without a node the
    calling thread faults it in and binds nothing."""
    mine = os.sched_getaffinity(0)
    sysfs({0: str(min(mine)), 1: str(max(mine))})
    seen = []
    real = tnuma.bind_to_node

    def spy(n):
        ok = real(n)
        seen.append((n, threading.current_thread().name, ok,
                     os.sched_getaffinity(0)))
        return ok

    monkeypatch.setattr(tnuma, "bind_to_node", spy)
    buf = teng.DmaBuffer(3 * 4096, numa_node=node)
    try:
        assert bytes(buf.view()) == bytes(3 * 4096)
    finally:
        buf.close()
    assert os.sched_getaffinity(0) == mine
    if node < 0:
        assert seen == [] and not buf.placed
    else:
        want = {min(mine) if node == 0 else max(mine)}
        assert seen == [(node, "strom-numa-place", True, want)]
        assert buf.placed


@pytest.mark.parametrize("chunks,nodes,want", [
    (6, {0: "0", 1: "0"}, 6), (5, {0: "0", 1: "0"}, 6),
    (7, {0: "0", 1: "0", 2: "0"}, 9), (1, {0: "0", 1: "0"}, 2),
])
def test_pool_never_holds_fewer_chunks_than_sized(sysfs, chunks, nodes,
                                                  want):
    """Each node's share is rounded up, so a pool over N nodes holds at
    least the chunks its caller sized (the JAX package rounds down and
    loses the remainder: 5 chunks over 2 nodes give it 4), every node's
    buffer placed."""
    sysfs(nodes)
    with tpool.DmaBufferPool(chunk_size=8192,
                             total_size=chunks * 8192) as pool:
        assert pool.n_chunks == want >= chunks
        assert all(b.placed for b in pool.buffers)
        got = [pool.alloc(timeout=0.1) for _ in range(want)]
        assert len({(c.node, c.index) for c in got}) == want
        for c in got:
            c.release()
    jpool_ = jpool.DmaBufferPool(chunk_size=8192, total_size=chunks * 8192)
    try:
        assert jpool_.n_chunks == max(chunks // len(nodes), 1) * len(nodes)
    finally:
        jpool_.close()


@pytest.mark.parametrize("node", [1, -1])
def test_scan_takes_chunks_from_its_bound_node(tmp_path, monkeypatch,
                                               sysfs, node):
    """A scan bound to the storage's node asks the pool for that node's
    chunks first; an unbound scan asks for any."""
    mine = os.sched_getaffinity(0)
    sysfs({0: str(min(mine)), 1: str(max(mine))})
    path, schema, cols = _heap(tmp_path)
    real = tplanner.capability_cache.probe
    monkeypatch.setattr(
        tplanner.capability_cache, "probe",
        lambda p: types.SimpleNamespace(numa_node_id=node) if p == path
        else real(p))
    asked = []
    alloc = tpool.DmaBufferPool.alloc

    def spy(self, **kw):
        asked.append(kw.get("preferred_node", -1))
        return alloc(self, **kw)

    monkeypatch.setattr(tpool.DmaBufferPool, "alloc", spy)
    with texec.TableScanner(path, schema, chunk_size=1 << 16,
                            numa_bind=True) as sc:
        assert sc.numa_node == node
        res = sc.scan_filter(lambda p: {"n": p.shape[0]}, device="cpu")
    assert int(res["n"]) == 16 and sc.numa_node == -1
    assert asked and set(asked) == {node}


@pytest.mark.parametrize("mask", [-1, 0b10, 0b100])
def test_pool_per_node_freelists_like_reference(sysfs, mask):
    """The pool carves one buffer a node of ``numa_node_mask``: the same
    nodes, chunk counts and allocation order (preferred node first, then
    the others in order) as the JAX package's pool."""
    sysfs({0: "0", 1: "0"})
    tcfg.set("numa_node_mask", mask)
    jcfg.set("numa_node_mask", mask)
    out = {}
    for name, mod in (("jax", jpool), ("torch", tpool)):
        pool = mod.DmaBufferPool(chunk_size=8192, total_size=6 * 8192)
        try:
            order = [pool.alloc(preferred_node=1, timeout=0.1)
                     for _ in range(pool.n_chunks)]
            out[name] = (pool.nodes, pool.n_chunks,
                         [c.node for c in order],
                         [pool.backing_buffer(n).numa_node
                          for n in pool.nodes])
            for c in order:
                c.release()
            assert pool.outstanding == 0
        finally:
            pool.close()
    assert out["torch"] == out["jax"]


def _heap(tmp_path):
    schema = HeapSchema(n_cols=2, visibility=True)
    rng = np.random.default_rng(5)
    n = schema.tuples_per_page * 16
    cols = [rng.integers(-100, 100, n).astype(np.int32) for _ in range(2)]
    path = str(tmp_path / "t.heap")
    build_heap_file(path, cols, schema)
    return path, schema, cols


@pytest.mark.parametrize("node", [0, -1])
def test_scan_binds_and_restores_affinity_on_close(tmp_path, monkeypatch,
                                                   sysfs, node):
    """``TableScanner(numa_bind=True)`` binds the scanning thread to the
    storage's node (none for an unknown one) and ``close()`` restores the
    affinity, as the JAX package's scanner does; the scan's sums hold."""
    mine = os.sched_getaffinity(0)
    sysfs({0: str(min(mine))})
    path, schema, cols = _heap(tmp_path)
    real = tplanner.capability_cache.probe
    monkeypatch.setattr(
        tplanner.capability_cache, "probe",
        lambda p: types.SimpleNamespace(numa_node_id=node) if p == path
        else real(p))
    sc = texec.TableScanner(path, schema, chunk_size=1 << 16,
                            numa_bind=True)
    try:
        assert sc.numa_bound is (node >= 0)
        assert os.sched_getaffinity(0) == ({min(mine)} if node >= 0
                                           else mine)
        res = sc.scan_filter(lambda p: {"n": p.shape[0]}, device="cpu")
        assert int(res["n"]) == 16
    finally:
        sc.close()
    assert os.sched_getaffinity(0) == mine and not sc.numa_bound
    # the JAX package's scanner, on the same table: restored too
    jsc = jexec.TableScanner(path, None, chunk_size=1 << 16, numa_bind=True,
                             session=jeng.Session(io_backend="python"))
    jsc.session.close()
    jsc.close()
    assert os.sched_getaffinity(0) == mine


def test_scan_without_numa_bind_touches_nothing(tmp_path, monkeypatch):
    path, schema, _ = _heap(tmp_path)
    monkeypatch.setattr(tnuma, "node_cpus", lambda node: [])
    calls = []
    monkeypatch.setattr(texec, "bind_to_node",
                        lambda node: calls.append(node) or True)
    with texec.TableScanner(path, schema, chunk_size=1 << 16,
                            numa_bind=False) as sc:
        assert not sc.numa_bound
    assert calls == []
