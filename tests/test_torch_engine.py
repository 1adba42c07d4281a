"""The port's ServeEngine on the CPU (reduced qwen2-7b, the plain versions of
the kernels): the outcomes ``tests/test_serving.py``, ``test_snapshots.py``,
``test_snapshot_plane.py`` and ``test_kernels.py`` assert for the JAX
engine, and the port's own duty that an unplug frees the dropped rows'
storage.  The snapshot data plane's host half is held against the JAX
package's functions on the same blobs."""
import dataclasses
from collections import deque

import jax
import numpy as np
import pytest
import torch

from repro.serving import engine as jax_engine
from repro_torch.cluster.host import HostMemoryBroker
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.arena import ArenaSpec
from repro_torch.kernels import kv_snapshot, ops
from repro_torch.models import model as M
from repro_torch.models.layers import tree_flatten, tree_leaves
from repro_torch.serving.engine import (ServeEngine, StagedRow,
                                        assemble_pages, blob_to_row_tree,
                                        paginate_blob)
from repro_torch.serving.request import (PROFILES, FunctionProfile, Request,
                                         State)
from repro_torch.serving.tracegen import assign_profiles, bursty_trace

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("qwen2-7b"))
    params = M.init_params(cfg, 0, device="cpu")
    spec = ArenaSpec.from_model(cfg, partition_tokens=128, n_partitions=8,
                                block_tokens=32)
    return cfg, params, spec


def _trace(seed=3, duration=16.0):
    arr = bursty_trace(duration, 0.8, burst_x=6, burst_at=(0.0,),
                       burst_len=3.0, quiet_after=duration / 2, seed=seed)
    return assign_profiles(arr, PROFILES, seed)


def _run_one(eng, rid, prof="cnn"):
    eng.submit(Request(rid=rid, profile=PROFILES[prof], submit_s=eng.now))
    empty = deque()
    while eng.active or eng.pending:
        eng._tick(empty)


def _expire(eng):
    eng.now += eng.keep_alive + 1.0
    eng._recycle_idle()


def _pooled(setup, **kw):
    cfg, params, spec = setup
    bpp = spec.blocks_per_partition
    broker = HostMemoryBroker(budget_units=12 * bpp,
                              snapshot_pool_units=4 * bpp)
    return broker, ServeEngine(cfg, params, spec, mode="hotmem",
                               keep_alive=2.0, seed=0, broker=broker,
                               replica_id="A", **kw)


# ------------------------------------------ tests/test_serving.py outcomes


@pytest.mark.parametrize("mode", ["hotmem", "vanilla", "static"])
def test_trace_completes(setup, mode):
    cfg, params, spec = setup
    reqs = [Request(rid=f"{mode}{i}", profile=p, submit_s=t)
            for i, (t, p) in enumerate(_trace())]
    eng = ServeEngine(cfg, params, spec, mode=mode, keep_alive=3.0)
    m = eng.run(reqs, max_virtual_s=2000)
    assert m["completed"] == len(reqs)
    assert m["killed"] == 0
    if mode != "vanilla":
        assert m["migrated_bytes"] == 0          # C1: zero migration
    eng.arena.manager.check_invariants()
    if mode != "static":
        assert m["reclaimed_bytes"] > 0          # elasticity engaged
        assert {"plug", "unplug"} <= {e.kind for e in eng.events}
    else:
        assert m["reclaim_events"] == 0


def test_budget_kill(setup):
    cfg, params, spec = setup
    greedy = FunctionProfile("greedy", prompt_tokens=8, decode_tokens=400,
                             max_tokens=spec.partition_tokens * 4)
    eng = ServeEngine(cfg, params, spec, mode="hotmem")
    eng.run([Request(rid="g", profile=greedy, submit_s=0.0)],
            max_virtual_s=500)
    assert eng.arena.manager.kills == 1
    assert eng.done[0].state is State.KILLED


def test_warm_start_skips_prefill(setup):
    cfg, params, spec = setup
    prof = PROFILES["cnn"]
    reqs = [Request(rid="a", profile=prof, submit_s=0.0),
            Request(rid="b", profile=prof, submit_s=100.0)]
    eng = ServeEngine(cfg, params, spec, mode="hotmem", keep_alive=1000.0)
    eng.run(reqs, max_virtual_s=5000)
    assert sum(e.kind == "prefill" for e in eng.events) == 1


def test_waitqueue_admission(setup):
    cfg, params, spec = setup
    tiny = dataclasses.replace(spec, n_partitions=2)
    reqs = [Request(rid=f"q{i}", profile=PROFILES["cnn"], submit_s=0.0)
            for i in range(5)]
    eng = ServeEngine(cfg, params, tiny, mode="static", keep_alive=0.0)
    m = eng.run(reqs, max_virtual_s=2000)
    assert m["completed"] == 5


# ------------------------------------------------------ unplug frees rows


def test_unplug_drops_the_old_storage(setup):
    """Rows dropped by an unplug must not stay alive behind a view: after
    the shrink no cache tensor shares storage with the pre-unplug ones,
    and each owns exactly its own bytes."""
    cfg, params, spec = setup
    eng = ServeEngine(cfg, params, spec, mode="hotmem", keep_alive=1.0)
    eng._grow_and_sync(6, via_gate=True)
    assert eng._rows() == 8
    old = {x.untyped_storage().data_ptr() for x in tree_leaves(eng.caches)}
    ev = eng._unplug_now(4)
    assert ev.reclaimed_units == 4 and ev.migrated_bytes == 0
    assert eng._rows() == 4
    for x in tree_leaves(eng.caches):
        assert x.untyped_storage().data_ptr() not in old
        assert x.untyped_storage().nbytes() == x.numel() * x.element_size()
    assert ev.reclaimed_bytes == 4 * spec.bytes_per_partition


# ----------------------------- tests/test_snapshots.py end to end (:360)


def test_snapshot_capture_and_restore_end_to_end(setup):
    cfg, params, spec = setup
    broker, eng = _pooled(setup)
    _run_one(eng, "c0")                        # cold (prefill)
    _run_one(eng, "w0")                        # warm adopt (same profile)
    assert eng.cold_starts == 1 and eng.warm_starts == 1
    warm_evs = [e for e in eng.events if e.kind == "warm_start"]
    assert len(warm_evs) == 1 and warm_evs[0].wall_s == 0.0
    _expire(eng)                               # container expires: capture
    broker.check_invariants()
    assert broker.snapshot_available("cnn")
    snap_evs = [e for e in eng.events if e.kind == "snapshot"]
    assert len(snap_evs) == 1 and snap_evs[0].wall_s > 0
    assert snap_evs[0].detail["bytes"] == \
        kv_snapshot.expected_row_bytes(cfg, spec.partition_tokens)
    assert broker.snapshot_units() == spec.blocks_per_partition
    _run_one(eng, "s0")                        # restore from the pool
    broker.check_invariants()
    assert eng.restore_starts == 1 and eng.cold_starts == 1
    rest_evs = [e for e in eng.events if e.kind == "restore"]
    assert len(rest_evs) == 1 and rest_evs[0].detail["key"] == "cnn"
    assert 0.0 < rest_evs[0].wall_s
    _expire(eng)
    _run_one(eng, "s1")                        # the snapshot stays pooled
    m = eng.metrics()
    assert (m["cold_starts"], m["warm_starts"], m["restore_starts"]) == \
        (1, 1, 2)


def test_restored_row_is_bit_identical_to_the_captured_row(setup):
    _broker, eng = _pooled(setup)
    _run_one(eng, "c0")
    before = M.cache_read_row(eng.caches, eng.warm["cnn"][0][2])
    _expire(eng)
    _run_one(eng, "s0")
    after = M.cache_read_row(eng.caches, eng.done[-1].partition)
    n = PROFILES["cnn"].prompt_tokens      # decode rewrote later slots
    for a, b in zip(tree_leaves(after), tree_leaves(before)):
        assert torch.equal(a[:, :, :n], b[:, :, :n])


# ------------- tests/test_kernels.py one-launch / one-transfer data plane


@pytest.fixture
def launches(monkeypatch):
    """Calls of the fused snapshot wrappers.  One call is one kernel launch
    on the card, where ``ops.LAUNCHES`` counts it; on the CPU it runs the
    plain version and counts nothing there."""
    n = {"snapshot_capture": 0, "snapshot_restore": 0}
    for name in n:
        def counted(*a, _fn=getattr(ops, name), _name=name, **kw):
            n[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    return n


def _new_events(eng, n0: int, kind: str) -> list:
    return [e for e in eng.events[n0:] if e.kind == kind]


def test_engine_capture_restore_transfer_counts(setup, launches):
    _broker, eng = _pooled(setup)
    _run_one(eng, "c0")
    layout = eng._snapshot_layout()
    n0 = len(eng.events)
    _expire(eng)                               # capture on expiry
    snap = _new_events(eng, n0, "snapshot")    # one device->host copy
    assert len(snap) == 1 and snap[0].detail["bytes"] == layout.row_bytes
    assert _new_events(eng, n0, "restore") == []
    assert launches == {"snapshot_capture": 1, "snapshot_restore": 0}
    n0 = len(eng.events)
    _run_one(eng, "s0")                        # restore from the pool
    assert eng.restore_starts == 1
    rest = _new_events(eng, n0, "restore")
    assert len(rest) == 1 and rest[0].detail["remap"] is False
    assert rest[0].detail["h2d_bytes"] == layout.row_bytes
    assert _new_events(eng, n0, "snapshot") == []   # never reads back
    assert launches == {"snapshot_capture": 1, "snapshot_restore": 1}


# -------------------------- tests/test_snapshot_plane.py paged CoW restore


def test_fully_mapped_local_cow_restore_moves_zero_h2d_bytes(setup,
                                                            launches):
    broker, eng = _pooled(setup, snapshot_page_bytes=4096)
    _run_one(eng, "c0")
    _expire(eng)                                  # capture + page index
    snap = broker.snapshots.peek("cnn")
    assert snap is not None and snap.pages is not None
    n0 = len(eng.events)
    _run_one(eng, "r0")                           # every page device-mapped
    assert eng.restore_starts == 1
    rest = _new_events(eng, n0, "restore")
    assert len(rest) == 1 and rest[0].detail["remap"] is True
    assert rest[0].detail["h2d_bytes"] == 0
    assert launches["snapshot_restore"] == 1      # still ONE fused scatter
    ev = next(e for e in eng.events if e.kind == "restore")
    assert ev.detail["pages_shared"] == ev.detail["pages_total"]
    broker.check_invariants()


def test_paged_restore_on_fresh_replica_pays_one_h2d(setup):
    cfg, params, spec = setup
    broker, a = _pooled(setup, snapshot_page_bytes=4096)
    b = ServeEngine(cfg, params, spec, keep_alive=2.0, seed=1,
                    broker=broker, replica_id="B", snapshot_page_bytes=4096)
    _run_one(a, "c0")
    _expire(a)
    layout = a._snapshot_layout()
    _run_one(b, "r1")
    rest = _new_events(b, 0, "restore")
    assert b.restore_starts == 1 and len(rest) == 1
    assert rest[0].detail["remap"] is False
    assert rest[0].detail["h2d_bytes"] == layout.row_bytes
    assert _new_events(a, 0, "restore") == []
    ev = next(e for e in b.events if e.kind == "restore")
    assert ev.detail["pages_shared"] == 0
    broker.check_invariants()


# ------------------------------- host-side data plane vs the JAX package


def _blob(n, seed=0):
    return np.frombuffer(np.random.default_rng(seed).bytes(n),
                         np.uint8).copy()


@pytest.mark.parametrize("n,units,page,n_dev", [
    (100, 8, 4096, 1), (1000, 6, 384, 1), (1000, 8, 1, 2),
    (32768, 4, 4096, 4), (0, 4, 64, 1)])
def test_paginate_blob_digests_match_jax(n, units, page, n_dev):
    blob = _blob(n, seed=n + page)
    got = paginate_blob(blob, units, page, n_dev)
    assert got == jax_engine.paginate_blob(blob, units, page, n_dev)
    assert assemble_pages(got).tobytes() == \
        jax_engine.assemble_pages(got).tobytes() == blob.tobytes()


def test_engine_blob_digests_match_jax_on_the_same_cache(setup):
    """The page digests of a captured row are the JAX package's digests of
    the JAX capture of the same cache bytes."""
    from repro.models import model as JM
    cfg, _params, spec = setup
    caches = M.init_caches(cfg, 3, spec.partition_tokens, device="cpu")
    gen = torch.Generator().manual_seed(4)
    for x in tree_leaves(caches):
        x.copy_(torch.randn(x.shape, generator=gen))
    blob = M.cache_read_rows(caches, [1]).view(torch.uint8).reshape(-1)
    jc = jax.tree.map(
        lambda x: np.asarray(x.view(torch.int16).numpy()).view(
            jax.numpy.bfloat16), caches)
    jblob = np.asarray(JM.cache_read_rows(
        jc, jax.numpy.asarray([1], jax.numpy.int32), impl="ref"))
    want = jax_engine.paginate_blob(jblob.view(np.uint8).reshape(-1), 8,
                                    4096)
    assert paginate_blob(blob.numpy(), 8, 4096) == want


def test_staged_row_carves_zero_copy_views(setup):
    cfg, _params, spec = setup
    caches = M.init_caches(cfg, 2, spec.partition_tokens, device="cpu")
    for i, x in enumerate(tree_leaves(caches)):
        x.fill_(i + 1)
    layout = M.cache_row_layout(caches)
    blob = M.cache_read_rows(caches, [1]).view(torch.uint8).reshape(-1)
    treedef = tree_flatten(caches)[1]
    metas = tuple((s.block_shape, layout.dtype) for s in layout.slots)
    sr = StagedRow(blob=blob.numpy(), treedef=treedef, metas=metas)
    assert sr.nbytes == layout.row_bytes
    row = sr.tree()
    for i, leaf in enumerate(tree_leaves(row)):
        assert bool((leaf == i + 1).all())
        assert leaf.untyped_storage().data_ptr() == \
            torch.from_numpy(sr.blob).untyped_storage().data_ptr()
    assert sum(x.numel() * x.element_size() for x in tree_leaves(
        blob_to_row_tree(sr.blob, treedef, metas))) == sr.nbytes


@pytest.mark.parametrize("mode", ["hotmem", "vanilla"])
def test_serve_launcher_runs_on_cpu(mode):
    from repro_torch.launch.serve import serve
    eng, m = serve("qwen2-7b", mode=mode, duration=4.0, rate=1.0,
                   device="cpu")
    assert m["completed"] == len(eng.done) > 0 and m["killed"] == 0


def test_elastic_arena_resizes_a_cache_tree_in_fresh_storage(setup):
    """The arena's own data plane (leading axis = rows): plug grows with
    zeroed rows, unplug keeps the prefix in fresh storage."""
    from repro_torch.core.elastic import ElasticArena
    cfg, _params, spec = setup
    caches = {"k": torch.ones((2, 4, 3)), "v": torch.ones((2, 5))}
    arena = ElasticArena(cfg, spec, "hotmem", caches=caches)
    arena.manager.unplug(6)
    assert arena.units() == 2 and arena.plug(3) >= 0.0
    assert arena.units() == 5 and arena.caches["k"].shape[0] == 5
    assert bool((arena.caches["k"][:2] == 1).all())
    assert not arena.caches["v"][2:].any()
    old = arena.caches["k"].untyped_storage().data_ptr()
    ev = arena.unplug(2)
    assert ev.reclaimed_units == 2 and arena.caches["k"].shape[0] == 3
    assert arena.caches["k"].untyped_storage().data_ptr() != old
    # the vanilla arena's leading axis is the block pool: a shrink keeps
    # the block prefix in fresh storage after moving live tail blocks
    pool = {"k": torch.arange(spec.n_blocks, dtype=torch.float32)[:, None]
            .repeat(1, 3)}
    va = ElasticArena(cfg, spec, "vanilla", caches=pool, seed=0)
    assert va.units() == spec.n_blocks
    va.admit("r")
    va.on_tokens("r", spec.partition_tokens)
    was = list(va.manager.block_table("r"))        # block k holds value k
    bpp = spec.blocks_per_partition
    ev = va.unplug(spec.n_blocks - bpp)
    assert va.units() == bpp and va.caches["k"].shape[0] == bpp
    assert ev.migrated_blocks == sum(b >= bpp for b in was) > 0
    now = va.manager.block_table("r")
    assert [int(va.caches["k"][b, 0]) for b in now] == was
