"""The port's vanilla paged baseline on the CPU, held against the JAX
package on the same numpy inputs: ``paged_attention`` (the Pallas kernel
in interpret mode, as ``tests/test_kernels.py`` runs it, and its oracle),
``kv_compact`` and ``apply_migrations`` (bit-exact), the block gather and
scatter, a scripted vanilla ``ElasticArena`` shrink driven identically
through both packages, the engine's paged twin, and the layout-contrast
entry point.

Attention tolerances are the JAX package's kernel-test tolerances (2e-2 in
bf16, 2e-5 in f32); block moves are data movement and must be bit-exact.
The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against these plain versions there."""
import types
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import elastic as jelastic
from repro.core.arena import ArenaSpec as JArenaSpec
from repro.kernels import ref as jref
from repro.kernels.kv_compact import kv_compact as pallas_kv_compact
from repro.kernels.paged_attention import \
    paged_attention as pallas_paged_attention
from repro.models import model as JM
from repro.serving import engine as jax_engine
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import tree_from_numpy
from repro_torch.core import elastic
from repro_torch.core.arena import ArenaSpec
from repro_torch.kernels import ops, ref
from repro_torch.launch import kernel_demo
from repro_torch.models import model as M
from repro_torch.models.layers import tree_leaves
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.request import PROFILES, FunctionProfile, Request

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _both(a, jdt, tdt):
    """One numpy array as a JAX and a torch array of the same values."""
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


# ------------------------------------------------------- paged_attention


def _paged_inputs(dtype, nb, bt, mb, seed):
    """The ``tests/test_kernels.py`` sweep's inputs: each row maps a random
    number of distinct blocks, -1 after them, its position inside its last
    mapped block (every row has a valid token)."""
    p, hkv, g, dh = 3, 2, 2, 32
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    q = _both(rng.normal(size=(p, hkv, g, dh)), jdt, tdt)
    kp = _both(rng.normal(size=(nb, bt, hkv, dh)), jdt, tdt)
    vp = _both(rng.normal(size=(nb, bt, hkv, dh)), jdt, tdt)
    tables = np.full((p, mb), -1, np.int32)
    pos = np.zeros((p,), np.int32)
    for i in range(p):
        nblk = int(rng.integers(1, mb + 1))
        tables[i, :nblk] = rng.choice(nb, size=nblk, replace=False)
        pos[i] = nblk * bt - int(rng.integers(1, bt))
    tab = (jnp.asarray(tables), torch.from_numpy(tables))
    po = (jnp.asarray(pos), torch.from_numpy(pos))
    return q, kp, vp, tab, po, tol


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("nb,bt,mb", [(8, 8, 4), (16, 16, 8), (32, 8, 6)])
def test_paged_attention_vs_pallas_interpret(dtype, nb, bt, mb):
    q, kp, vp, tab, pos, tol = _paged_inputs(dtype, nb, bt, mb, nb * bt)
    want = pallas_paged_attention(q[0], kp[0], vp[0], tab[0], pos[0],
                                  interpret=True)
    _close(ref.paged_attention(q[1], kp[1], vp[1], tab[1], pos[1]), want,
           tol)
    # the wrapper takes the plain version for CPU tensors
    _close(ops.paged_attention(q[1], kp[1], vp[1], tab[1], pos[1]), want,
           tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_paged_attention_plain_vs_jax_oracle(dtype, cap):
    q, kp, vp, tab, pos, tol = _paged_inputs(dtype, 16, 16, 8, 3)
    want = jref.paged_attention(q[0] * 8, kp[0], vp[0], tab[0], pos[0],
                                logit_cap=cap)
    _close(ref.paged_attention(q[1] * 8, kp[1], vp[1], tab[1], pos[1],
                               logit_cap=cap), want, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_attention_no_valid_token_rows_in_pallas(dtype):
    """What the Pallas kernel (interpret mode) gives for the two paged edge
    rows, the expectations the card's kernel is held to in
    ``chip_smoke.py``: a row with no mapped token at or before its position
    averages V over every mapped slot of its table (its masked scores are
    the finite NEG_INF and ``-1`` entries are skipped), and a table of only
    ``-1`` gives zeros.  A third row with valid tokens and a ``-1`` entry
    inside its range matches the plain version.  (The plain version masks
    ``-1`` slots instead of skipping them, so it differs on the first two
    rows.)"""
    jdt, tdt, tol = DTYPES[dtype]
    nb, bt, mb, hkv, g, dh = 12, 8, 4, 2, 3, 16
    rng = np.random.default_rng(21)
    q = _both(rng.normal(size=(3, hkv, g, dh)), jdt, tdt)
    kp = _both(rng.normal(size=(nb, bt, hkv, dh)), jdt, tdt)
    vp = _both(rng.normal(size=(nb, bt, hkv, dh)), jdt, tdt)
    tables = np.array([[-1, 3, 5, -1], [-1, -1, -1, -1], [2, -1, 7, 9]],
                      np.int32)
    pos = np.array([bt - 1, 20, 3 * bt + 2], np.int32)
    want = np.asarray(pallas_paged_attention(
        q[0], kp[0], vp[0], jnp.asarray(tables), jnp.asarray(pos),
        interpret=True), np.float32)
    v32 = np.asarray(vp[0], np.float32)
    mean = v32[[3, 5]].reshape(2 * bt, hkv, dh).mean(axis=0)   # (Hkv, Dh)
    np.testing.assert_allclose(want[0], np.broadcast_to(
        mean[:, None], (hkv, g, dh)), atol=tol, rtol=tol)
    assert np.all(want[1] == 0.0)
    got = ref.paged_attention(q[1], kp[1], vp[1], torch.from_numpy(tables),
                              torch.from_numpy(pos))
    _close(got[2], want[2], tol)


def test_paged_equals_partition_when_contiguous():
    """The two layouts agree when the block table is the identity
    (``tests/test_kernels.py::test_paged_equals_partition_when_
    contiguous``), in the port and against the JAX Pallas kernel."""
    rng = np.random.default_rng(0)
    p, hkv, g, dh, bt, nblk = 2, 2, 2, 32, 16, 4
    t = bt * nblk
    q = _both(rng.normal(size=(p, hkv, g, dh)), jnp.float32, torch.float32)
    k = _both(rng.normal(size=(p, t, hkv, dh)), jnp.float32, torch.float32)
    v = _both(rng.normal(size=(p, t, hkv, dh)), jnp.float32, torch.float32)
    pos = np.asarray([t - 1, t // 2], np.int32)
    tables = np.asarray([[i * nblk + j for j in range(nblk)]
                         for i in range(p)], np.int32)
    part = ops.partition_attention(q[1], k[1], v[1], torch.from_numpy(pos))
    paged = ops.paged_attention(
        q[1], k[1].reshape(p * nblk, bt, hkv, dh),
        v[1].reshape(p * nblk, bt, hkv, dh), torch.from_numpy(tables),
        torch.from_numpy(pos))
    np.testing.assert_allclose(part.numpy(), paged.numpy(), atol=1e-5,
                               rtol=1e-5)
    want = pallas_paged_attention(
        q[0], k[0].reshape(p * nblk, bt, hkv, dh),
        v[0].reshape(p * nblk, bt, hkv, dh), jnp.asarray(tables),
        jnp.asarray(pos), interpret=True)
    _close(paged, want, 2e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_layout_contrast_on_cpu(dtype):
    """The layout-contrast entry point: the permuted pool decodes as the
    contiguous rows do (and as the JAX oracle does), and the two tail
    blocks arrive in the head."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(1)
    p, t, hkv, g, dh, bt = 4, 256, 2, 4, 64, 64
    q = _both(rng.normal(size=(p, hkv, g, dh)), jdt, tdt)
    k = _both(rng.normal(size=(p, t, hkv, dh)), jdt, tdt)
    v = _both(rng.normal(size=(p, t, hkv, dh)), jdt, tdt)
    pos = np.asarray([255, 100, 30, 200], np.int32)
    ops.reset_launches()
    res = kernel_demo.layout_contrast(q[1], k[1], v[1],
                                      torch.from_numpy(pos),
                                      block_tokens=bt, seed=2)
    assert not any(ops.LAUNCHES.values())     # plain versions on the CPU
    want = jref.partition_attention(q[0], k[0], v[0], jnp.asarray(pos))
    _close(res["partition"], want, tol)
    _close(res["paged"], want, tol)
    assert res["max_abs_diff"] <= tol
    assert res["compacted"] and res["moves"] == [(15, 0), (14, 1)]
    assert tuple(res["k_pool"].shape) == (16, bt, hkv, dh)


def test_kernel_demo_main_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", ["kernel_demo", "--device", "cpu"])
    kernel_demo.main()
    assert "kernel demo OK" in capsys.readouterr().out


# ------------------------------------------------------------ kv_compact


KV_DTYPES = {"f32": (jnp.float32, torch.float32),
             "bf16": (jnp.bfloat16, torch.bfloat16),
             "i32": (jnp.int32, torch.int32)}


def _pool(dtype, nb, bt, seed):
    jdt, tdt = KV_DTYPES[dtype]
    rng = np.random.default_rng(seed)
    if dtype == "i32":
        a = rng.integers(0, 100, size=(nb, bt, 2, 8)).astype(np.int32)
        return jnp.asarray(a), torch.from_numpy(a)
    return _both(rng.normal(size=(nb, bt, 2, 8)), jdt, tdt)


@pytest.mark.parametrize("dtype", list(KV_DTYPES))
@pytest.mark.parametrize("nb,bt,m", [(8, 4, 3), (16, 8, 8), (64, 16, 31)])
def test_kv_compact_plain_vs_jax_oracle_on_the_sweep(dtype, nb, bt, m):
    """``tests/test_kernels.py``'s sweep (sources and destinations drawn
    independently, so they may overlap): the plain version gathers every
    source before any write, as the JAX oracle does."""
    jp, tp = _pool(dtype, nb, bt, nb + m)
    rng = np.random.default_rng(nb + m)
    src = rng.choice(nb, size=m, replace=False).astype(np.int32)
    dst = rng.choice(nb, size=m, replace=False).astype(np.int32)
    want = jref.kv_compact(jp, jnp.asarray(src), jnp.asarray(dst), m)
    got = ref.kv_compact(tp, torch.from_numpy(src), torch.from_numpy(dst), m)
    assert got is tp                                  # in place
    assert _bytes(got) == _bytes(want)


def _tail_to_head(nb, m, seed):
    """A shrink plan's kind of move list: ``m`` tail blocks into permuted
    free head slots (no destination is another move's source)."""
    rng = np.random.default_rng(seed)
    src = rng.permutation(np.arange(nb - m, nb)).astype(np.int32)
    dst = rng.permutation(nb - m)[:m].astype(np.int32)
    return src, dst


@pytest.mark.parametrize("dtype", list(KV_DTYPES))
@pytest.mark.parametrize("nb,bt,m", [(8, 4, 3), (16, 8, 8), (64, 16, 31)])
def test_kv_compact_wrapper_vs_pallas_interpret(dtype, nb, bt, m):
    jp, tp = _pool(dtype, nb, bt, nb * m)
    src, dst = _tail_to_head(nb, m, m)
    want = pallas_kv_compact(jp, jnp.asarray(src), jnp.asarray(dst),
                             interpret=True)
    assert _bytes(want) == _bytes(jref.kv_compact(
        jp, jnp.asarray(src), jnp.asarray(dst), m))
    ops.reset_launches()
    (got,) = ops.kv_compact([tp], src.tolist(), dst.tolist())
    assert got is tp and _bytes(got) == _bytes(want)
    assert not any(ops.LAUNCHES.values())


@pytest.mark.parametrize("nmov,count", [(5, 5), (5, 3), (9, 0)])
def test_apply_migrations_matches_jax_with_padding(nmov, count):
    """Fixed-capacity vectors padded with ``dst = NB`` (the arena's
    padding): the port's in-place pass over a two-leaf pool equals the JAX
    ``apply_migrations``, leaf by leaf and byte for byte."""
    nb, cap = 24, 16
    rng = np.random.default_rng(nmov * 10 + count)
    k = _both(rng.normal(size=(nb, 4, 2, 8)), jnp.bfloat16, torch.bfloat16)
    v = _both(rng.normal(size=(nb, 4, 3)), jnp.float32, torch.float32)
    s, d = _tail_to_head(nb, nmov, count)
    src = np.zeros(cap, np.int32)
    dst = np.full(cap, nb, np.int32)
    src[:nmov], dst[:nmov] = s, d
    want = jelastic.apply_migrations({"k": k[0], "v": v[0]},
                                     jnp.asarray(src), jnp.asarray(dst),
                                     jnp.asarray(count))
    pool = {"k": k[1], "v": v[1]}
    got = elastic.apply_migrations(pool, src.tolist(), dst.tolist(), count)
    assert got is pool
    for name in ("k", "v"):
        assert _bytes(got[name]) == _bytes(want[name])


@pytest.mark.parametrize("src,dst,err", [
    ([7, 6], [2, 2], ValueError),       # two live moves, one destination
    ([7, 2], [2, 3], ValueError),       # a destination another move reads
    ([8, 6], [1, 2], IndexError),       # source out of range
    ([7, 6], [-1, 2], IndexError),      # negative destination
])
def test_kv_compact_wrapper_rejects_dependent_moves(src, dst, err):
    pool = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    before = pool.clone()
    with pytest.raises(err):
        ops.kv_compact([pool], src, dst)
    assert torch.equal(pool, before)


def test_kv_compact_wrapper_drops_dead_and_out_of_range_moves():
    """A self-move is a no-op, a destination at or past NB is dropped and
    moves past ``count`` are not live (none of them can race)."""
    pool = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    want = pool.clone()
    want[1] = pool[7]
    ops.kv_compact([pool], [7, 4, 6, 5, 3], [1, 4, 8, 9, 6], count=4)
    assert torch.equal(pool, want)


# --------------------------------------------------- gather / scatter


def _tables():
    # -1 entries; block 0 is never mapped (the JAX scatter writes the old
    # block 0 back for every unmapped slot)
    return np.asarray([[3, 5, -1], [1, -1, -1], [6, 2, 7]], np.int32)


def test_gather_blocks_matches_jax():
    rng = np.random.default_rng(4)
    k = _both(rng.normal(size=(8, 4, 2, 3)), jnp.bfloat16, torch.bfloat16)
    v = _both(rng.normal(size=(8, 4, 5)), jnp.float32, torch.float32)
    tables = _tables()
    want = jelastic.gather_blocks({"k": k[0], "v": v[0]},
                                  jnp.asarray(tables))
    got = elastic.gather_blocks({"k": k[1], "v": v[1]},
                                torch.from_numpy(tables))
    for name in ("k", "v"):
        assert tuple(got[name].shape) == want[name].shape
        assert _bytes(got[name]) == _bytes(want[name])
    assert elastic.pool_rows(got) == 3 and elastic.pool_rows(
        {"k": k[1]}) == 8


def test_scatter_blocks_matches_jax():
    rng = np.random.default_rng(5)
    k = _both(rng.normal(size=(8, 4, 2, 3)), jnp.float32, torch.float32)
    rows = _both(rng.normal(size=(3, 12, 2, 3)), jnp.float32, torch.float32)
    tables = _tables()
    want = jelastic.scatter_blocks({"k": k[0]}, {"k": rows[0]},
                                   jnp.asarray(tables))
    pool = {"k": k[1]}
    got = elastic.scatter_blocks(pool, {"k": rows[1]},
                                 torch.from_numpy(tables))
    assert got is pool                                # in place
    assert _bytes(got["k"]) == _bytes(want["k"])


# ------------------------------------------ vanilla ElasticArena, both


def _arenas(seed):
    jcfg = jreduced(jget_config("qwen2-7b"))
    cfg = reduced(get_config("qwen2-7b"))
    jspec = JArenaSpec.from_model(jcfg, partition_tokens=64, n_partitions=8,
                                  block_tokens=16)
    spec = ArenaSpec.from_model(cfg, partition_tokens=64, n_partitions=8,
                                block_tokens=16)
    assert spec.bytes_per_block == jspec.bytes_per_block
    rng = np.random.default_rng(seed)
    k = _both(rng.normal(size=(spec.n_blocks, 16, 2, 4)), jnp.bfloat16,
              torch.bfloat16)
    v = _both(rng.normal(size=(spec.n_blocks, 16, 2, 4)), jnp.bfloat16,
              torch.bfloat16)
    ja = jelastic.ElasticArena(jcfg, jspec, "vanilla",
                               caches=[k[0], v[0]], seed=seed)
    ta = elastic.ElasticArena(cfg, spec, "vanilla", caches=[k[1], v[1]],
                              seed=seed)
    return ja, ta


@pytest.mark.parametrize("seed,n_live", [(2, 1), (3, 3), (4, 5)])
def test_vanilla_arena_shrink_matches_jax(seed, n_live):
    """The same script through both arenas (same seed, so the same
    manager decisions): equal tables, events and pools byte for byte after
    a migrating shrink and a regrow; the port's pool is fresh storage."""
    ja, ta = _arenas(seed)
    for arena in (ja, ta):
        for i in range(n_live + 2):
            arena.admit(f"r{i}")
            arena.on_tokens(f"r{i}", 40)
        for i in range(0, n_live + 2, 2):
            arena.finish(f"r{i}")             # holes between live blocks
    old = {x.untyped_storage().data_ptr() for x in ta.caches}
    jev, tev = ja.unplug(16), ta.unplug(16)
    assert (tev.reclaimed_units, tev.migrated_blocks, tev.migrated_bytes) \
        == (jev.reclaimed_units, jev.migrated_blocks, jev.migrated_bytes)
    assert ta.units() == ja.units() == 32 - tev.reclaimed_units
    assert ta.manager._tables == ja.manager._tables
    for x, y in zip(ta.caches, ja.caches):
        assert _bytes(x) == _bytes(y)
        assert x.untyped_storage().data_ptr() not in old
        assert x.untyped_storage().nbytes() == x.numel() * x.element_size()
    ja.plug(8)
    ta.plug(8)
    for x, y in zip(ta.caches, ja.caches):
        assert _bytes(x) == _bytes(y)
    ta.manager.check_invariants()


def test_absorb_takes_whole_stripes_only():
    """``absorb(units, shards)`` carries the JAX signature and its assert:
    units delivered to a sharded host land as a whole stripe, one slab
    per device; a partial stripe is a caller bug, in both packages."""
    ja, ta = _arenas(5)
    for arena in (ja, ta):
        arena.unplug(16)
        with pytest.raises(AssertionError, match="not a whole 2-shard"):
            arena.absorb(3, shards=2)
    before = ta.units()
    ja.absorb(4, shards=2)
    ta.absorb(4, shards=2)
    assert ta.units() == ja.units() == before + 4
    for x, y in zip(ta.caches, ja.caches):
        assert _bytes(x) == _bytes(y)


def test_vanilla_unplug_grows_with_occupancy():
    """``tests/test_elastic.py``'s Fig. 6 statement through the port's
    arena: migration volume rises with occupancy, HotMem stays at zero."""
    cfg = reduced(get_config("qwen2-7b"))
    spec = ArenaSpec.from_model(cfg, partition_tokens=64, n_partitions=8,
                                block_tokens=16)
    results = []
    for n_live in (1, 3, 5):
        va = elastic.ElasticArena(cfg, spec, "vanilla", seed=2)
        hm = elastic.ElasticArena(cfg, spec, "hotmem")
        for i in range(n_live):
            va.admit(f"r{i}")
            va.on_tokens(f"r{i}", 64)
            hm.admit(f"h{i}")
            hm.on_tokens(f"h{i}", 64)
        results.append(len(va.manager.shrink_plan(8)[1]))
        assert hm.unplug(2).migrated_bytes == 0
    assert results[0] <= results[-1] and results[-1] > 0


# ----------------------------------------------------- vanilla engine


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("qwen2-7b"))
    params = M.init_params(cfg, 0, device="cpu")
    spec = ArenaSpec.from_model(cfg, partition_tokens=128, n_partitions=8,
                                block_tokens=32)
    return cfg, params, spec


@pytest.mark.parametrize("parts", [2, 8])
def test_make_pool_matches_jax(setup, parts):
    """The engine's paged twin of converted caches equals the JAX engine's
    byte for byte, and owns its storage (the moved and reshaped row cache
    is a view that the in-place migration must not write)."""
    cfg, _params, spec = setup
    jcfg = jreduced(jget_config("qwen2-7b"))
    rng = np.random.default_rng(parts)
    jc = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), dtype=x.dtype),
        JM.init_caches(jcfg, spec.n_partitions, spec.partition_tokens))
    tc = tree_from_numpy(jax.device_get(jc), "cpu")
    want = jax_engine.ServeEngine._make_pool(
        types.SimpleNamespace(spec=spec, caches=jc), parts)
    got = ServeEngine._make_pool(types.SimpleNamespace(spec=spec, caches=tc),
                                 parts)
    assert len(got) == len(want) == 2
    cache_ptrs = {x.untyped_storage().data_ptr() for x in tree_leaves(tc)}
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (
            parts * spec.blocks_per_partition, spec.block_tokens,
            cfg.num_layers, cfg.num_kv_heads, cfg.head_dim)
        assert _bytes(g) == _bytes(w)
        assert g.is_contiguous()
        assert g.untyped_storage().data_ptr() not in cache_ptrs


@pytest.mark.parametrize("mode,seed", [("vanilla", 0), ("vanilla", 3),
                                       ("hotmem", 0), ("static", 0)])
def test_the_arena_seats_its_manager_as_the_jax_engine_does(setup, mode,
                                                            seed):
    """The manager the arena seats at the engine's start size is the JAX
    engine's: vanilla's pool and block hand-out order (the full pool
    shuffled, then the start pool with the same ``Random``), hotmem's and
    static's plugged partitions and free heap."""
    cfg, params, spec = setup
    jcfg = jreduced(jget_config("qwen2-7b"))
    jspec = JArenaSpec.from_model(jcfg, spec.partition_tokens,
                                  spec.n_partitions, spec.block_tokens)
    want = jax_engine.ServeEngine(jcfg, None, jspec, mode=mode, seed=seed,
                                  prewarm=False).arena.manager
    got = ServeEngine(cfg, params, spec, mode=mode, seed=seed,
                      prewarm=False).arena.manager
    if mode == "vanilla":
        assert got.pool_blocks == want.pool_blocks \
            == 2 * spec.blocks_per_partition
        assert got._free == want._free
        assert sorted(got._free) == list(range(got.pool_blocks))
    else:
        assert got.plugged == want.plugged \
            == (spec.n_partitions if mode == "static" else 2)
        assert got._free == want._free == list(range(got.plugged))


def test_vanilla_engine_unplug_migrates_into_fresh_pool(setup):
    """A scripted vanilla schedule whose unplug must migrate (as
    ``chip_smoke.py`` drives it on the card): the planned moves run, the
    moved blocks arrive, the kept blocks keep their bytes and the pool is
    new storage; the long request then warm-starts on its moved blocks."""
    cfg, params, spec = setup
    eng = ServeEngine(cfg, params, spec, mode="vanilla", keep_alive=1000.0,
                      seed=1)
    mgr = eng.arena.manager
    empty = deque()
    for i in range(7):
        eng.submit(Request(rid=f"v{i}", profile=PROFILES["bert"],
                           submit_s=eng.now))
    while eng.active or eng.pending:
        eng._tick(empty)
    assert eng._units() == 8 and eng._rows() == 8
    long = FunctionProfile("long", prompt_tokens=64, decode_tokens=8,
                           max_tokens=128)
    eng.submit(Request(rid="L", profile=long, submit_s=eng.now))
    while eng.active or eng.pending:
        eng._tick(empty)
    for prof in [p for p in eng.warm if p != "long"]:
        for _t, rid, _row in eng.warm.pop(prof):
            eng.arena.finish(rid)
    units = (eng._units() - eng.ladder[0]) * spec.blocks_per_partition
    k, moves = mgr.shrink_plan(units)
    assert moves and k == units
    gen = torch.Generator().manual_seed(0)
    for x in eng.pool:
        x.copy_(torch.randn(x.shape, generator=gen))
    before = [x.clone() for x in eng.pool]
    old = {x.untyped_storage().data_ptr() for x in eng.pool}
    eng._resize()
    ev = mgr.reclaim_events[-1]
    assert ev.migrated_blocks == len(moves)
    assert ev.migrated_bytes == len(moves) * spec.bytes_per_block
    assert eng._units() == eng.ladder[0] and eng._rows() == 8
    src = torch.tensor([m[0] for m in moves])
    dst = torch.tensor([m[1] for m in moves])
    kept = torch.tensor(sorted(set(range(mgr.pool_blocks))
                               - {m[1] for m in moves}))
    for x, y in zip(eng.pool, before):
        assert x.shape[0] == mgr.pool_blocks
        assert torch.equal(x[dst], y[src]) and torch.equal(x[kept], y[kept])
        assert x.untyped_storage().data_ptr() not in old
    unplug = [e for e in eng.events if e.kind == "unplug"][-1]
    assert unplug.detail["migrated_bytes"] == ev.migrated_bytes > 0
    eng.submit(Request(rid="L2", profile=long, submit_s=eng.now))
    while eng.active or eng.pending:
        eng._tick(empty)
    assert eng.warm_starts >= 1
    m = eng.metrics()
    assert m["completed"] == 9 and m["killed"] == 0
    mgr.check_invariants()


def test_vanilla_engine_under_a_broker_steal(setup):
    """Broker-initiated reclaim of a vanilla replica (the victim side):
    warm containers are recycled oldest-first, the blocks come back to the
    host in block units, and the manager stays consistent."""
    from repro_torch.cluster.host import HostMemoryBroker
    cfg, params, spec = setup
    bpp = spec.blocks_per_partition
    broker = HostMemoryBroker(budget_units=12 * bpp)
    eng = ServeEngine(cfg, params, spec, mode="vanilla", keep_alive=1000.0,
                      broker=broker, replica_id="V")
    empty = deque()
    for i in range(3):
        eng.submit(Request(rid=f"v{i}", profile=PROFILES["cnn"],
                           submit_s=eng.now))
    while eng.active or eng.pending:
        eng._tick(empty)
    held = eng.arena.units()
    freed, ev = eng.reclaim_for_broker(2 * bpp)
    assert freed == ev.reclaimed_units == 2 * bpp
    assert eng.arena.units() == held - 2 * bpp
    assert any(e.detail.get("stolen") for e in eng.events
               if e.kind == "unplug")
    eng.arena.manager.check_invariants()
    broker.check_invariants()
