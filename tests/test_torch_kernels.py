"""The port's kernel module on the CPU: the plain PyTorch versions
(``repro_torch.kernels.ref``) and the dispatch wrappers (``ops``) against
the JAX package's oracles and Pallas kernels, on the same numpy inputs.

Attention tolerances are the JAX package's kernel-test tolerances (2e-2 in
bf16, 2e-5 in f32).  Snapshot capture/restore is data movement and must be
bit-exact.  The CUDA kernels themselves run only on the card; ``chip_smoke.py``
holds them against these plain versions there."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.partition_attention import \
    partition_attention as pallas_partition_attention
from repro.models import model as JM
from repro_torch import roofline
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import tree_from_numpy
from repro_torch.kernels import kv_snapshot, ops, ref
from repro_torch.models import model as M
from repro_torch.models.layers import tree_leaves

torch.set_num_threads(1)

SHAPES = [  # (P, T, HKV, G, DH) — the JAX package's kernel sweep
    (2, 32, 1, 1, 16),
    (4, 64, 2, 3, 32),
    (3, 128, 4, 2, 64),
    (1, 256, 2, 7, 128),
]
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _both(a, jdt, tdt):
    """One numpy array as a JAX and a torch array of the same values."""
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _attn_inputs(shape, dtype, seed):
    p, t, hkv, g, dh = shape
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    q = _both(rng.normal(size=(p, hkv, g, dh)), jdt, tdt)
    k = _both(rng.normal(size=(p, t, hkv, dh)), jdt, tdt)
    v = _both(rng.normal(size=(p, t, hkv, dh)), jdt, tdt)
    pos = rng.integers(0, 3 * t, size=(p,)).astype(np.int32)
    return q, k, v, (jnp.asarray(pos), torch.from_numpy(pos)), tol


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("window", [0, 24])
def test_partition_attention_plain_vs_jax(shape, dtype, window):
    q, k, v, pos, tol = _attn_inputs(shape, dtype, sum(shape) + window)
    want = jref.partition_attention(q[0], k[0], v[0], pos[0], window=window)
    _close(ref.partition_attention(q[1], k[1], v[1], pos[1], window=window),
           want, tol)
    # the wrapper takes the plain version for CPU tensors
    _close(ops.partition_attention(q[1], k[1], v[1], pos[1], window=window),
           want, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_partition_attention_softcap_vs_jax(dtype, cap):
    q, k, v, pos, tol = _attn_inputs((2, 64, 2, 2, 32), dtype, 7)
    pos = (jnp.asarray([10, 63], jnp.int32),
           torch.tensor([10, 63], dtype=torch.int32))
    want = jref.partition_attention(q[0] * 8, k[0], v[0], pos[0],
                                    logit_cap=cap)
    _close(ref.partition_attention(q[1] * 8, k[1], v[1], pos[1],
                                   logit_cap=cap), want, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window,cap", [(0, 0.0), (24, 0.0), (0, 30.0)])
@pytest.mark.parametrize("blocks", [2, 4])
def test_partition_attention_partials_merge_to_jax(dtype, window, cap,
                                                   blocks):
    """The ring split into ``blocks`` blocks of slots (a cache split on
    "kv_seq"): each block's partials, merged as a mesh merges them, give
    the JAX package's attention over the whole ring."""
    q, k, v, pos, tol = _attn_inputs((4, 64, 2, 3, 32), dtype,
                                     blocks + window)
    want = jref.partition_attention(q[0] * 4, k[0], v[0], pos[0],
                                    window=window, logit_cap=cap)
    tb = 64 // blocks
    parts = [ref.partition_attention(
        q[1] * 4, k[1][:, i * tb:(i + 1) * tb], v[1][:, i * tb:(i + 1) * tb],
        pos[1], window=window, logit_cap=cap, off=i * tb, t=64,
        partials=True) for i in range(blocks)]
    m = torch.stack([p[0] for p in parts]).amax(0)
    e = [torch.exp(p[0] - m) for p in parts]
    acc = sum(p[2] * w[..., None] for p, w in zip(parts, e))
    l = sum(p[1] * w for p, w in zip(parts, e))
    _close((acc / l[..., None]).to(v[1].dtype), want, tol)


def test_partition_attention_plain_vs_pallas_interpret():
    q, k, v, pos, tol = _attn_inputs((4, 64, 2, 3, 32), "f32", 3)
    want = pallas_partition_attention(q[0], k[0], v[0], pos[0], window=24,
                                      block_t=16, interpret=True)
    _close(ref.partition_attention(q[1], k[1], v[1], pos[1], window=24),
           want, tol)


def test_partition_attention_all_masked_row_stays_finite():
    """A window of 1 at pos 40 in a ring of 16 leaves one valid slot (slot
    8, gidx 40): the output is that slot's V row, finite, in the Pallas
    kernel and the plain version alike."""
    q, k, v, _pos, tol = _attn_inputs((1, 16, 1, 2, 16), "f32", 4)
    pos = (jnp.asarray([40], jnp.int32), torch.tensor([40],
                                                      dtype=torch.int32))
    got = ref.partition_attention(q[1], k[1], v[1], pos[1], window=1,
                                  logit_cap=0.0)
    assert torch.isfinite(got).all()
    want = np.broadcast_to(np.asarray(v[0])[0, 8, 0], (2, 16))
    _close(got[0, 0], want, tol)
    pallas = pallas_partition_attention(q[0], k[0], v[0], pos[0], window=1,
                                        block_t=8, interpret=True)
    np.testing.assert_allclose(np.asarray(pallas, np.float32)[0, 0], want,
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_partition_attention_no_valid_slot_is_mean_of_v(dtype, window):
    """pos = -1: every ring slot is masked at the finite NEG_INF, so the
    Pallas kernel (interpret mode), the plain version and the mean of V
    over all T slots agree.  The card's kernel is held to the same in
    ``chip_smoke.py``."""
    q, k, v, _pos, tol = _attn_inputs((2, 32, 2, 3, 16), dtype, 9)
    pos = np.array([-1, 7], np.int32)
    pj, pt = jnp.asarray(pos), torch.from_numpy(pos)
    want = pallas_partition_attention(q[0], k[0], v[0], pj, window=window,
                                      block_t=8, interpret=True)
    got = ref.partition_attention(q[1], k[1], v[1], pt, window=window)
    _close(got, want, tol)
    mean = np.asarray(v[0].astype(jnp.float32))[0].mean(axis=0)  # (Hkv, Dh)
    _close(got[0], np.broadcast_to(mean[:, None], (2, 3, 16)), tol)
    np.testing.assert_allclose(np.asarray(want, np.float32)[0],
                               np.broadcast_to(mean[:, None], (2, 3, 16)),
                               atol=tol, rtol=tol)


# ------------------------------------- fused snapshot capture/restore


def _snap_caches(rows, t, seed):
    """Reduced qwen2-7b cache tree with random contents, in both packages
    (cache leaves are zero-initialized, which would make bit-identity
    vacuous)."""
    from repro.configs.base import get_config as jget, reduced as jred
    cfg = jred(jget("qwen2-7b"))
    rng = np.random.default_rng(seed)
    jc = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), dtype=x.dtype),
        JM.init_caches(cfg, rows, t))
    return jc, tree_from_numpy(jax.device_get(jc), "cpu")


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


def test_row_layout_matches_jax():
    jc, tc = _snap_caches(4, 64, 0)
    jl, tl = JM.cache_row_layout(jc), M.cache_row_layout(tc)
    assert [dataclasses.astuple(s) for s in tl.slots] == \
        [dataclasses.astuple(s) for s in jl.slots]
    assert tl.total_elems == jl.total_elems
    assert tl.dtype == jl.dtype == "bfloat16"
    assert tl.row_bytes == jl.row_bytes


@pytest.mark.parametrize("t,rows", [(64, [1]), (128, [3, 1, 2])])
def test_snapshot_capture_bit_exact_vs_jax(t, rows):
    jc, tc = _snap_caches(len(rows) + 2, t, t + len(rows))
    layout = M.cache_row_layout(tc)
    want = JM.cache_read_rows(jc, jnp.asarray(rows, jnp.int32), impl="ref")
    got = M.cache_read_rows(tc, rows, layout=layout)
    assert tuple(got.shape) == (len(rows), layout.total_elems)
    assert _bytes(got) == _bytes(jax.device_get(want))


def test_snapshot_restore_bit_exact_vs_jax_and_untouched_rows():
    jc, tc = _snap_caches(5, 128, 11)
    before = [x.clone() for x in tree_leaves(tc)]
    layout = M.cache_row_layout(tc)
    blob = np.random.default_rng(12).standard_normal(
        (2, layout.total_elems))
    jblob, tblob = _both(blob, jnp.bfloat16, torch.bfloat16)
    want = JM.cache_write_rows(jc, jblob, jnp.asarray([3, 1], jnp.int32),
                               impl="ref")
    got = M.cache_write_rows(tc, tblob, [3, 1], layout=layout)
    assert got is tc                                  # in place
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert _bytes(g) == _bytes(w)
    keep = torch.tensor([0, 2, 4])
    leaves, axes, _ = M.cache_flat_axes(tc)
    for x, old, ax in zip(leaves, before, axes):
        assert _bytes(x.index_select(ax, keep)) == \
            _bytes(old.index_select(ax, keep))


def test_snapshot_roundtrip_bit_identity():
    _jc, tc = _snap_caches(4, 64, 3)
    blob = M.cache_read_rows(tc, [0, 3])
    fresh = M.init_caches(reduced(get_config("qwen2-7b")), 4, 64,
                          device="cpu")
    M.cache_write_rows(fresh, blob, [0, 3])
    assert _bytes(M.cache_read_rows(fresh, [0, 3])) == _bytes(blob)


def test_snapshot_wrappers_reject_bad_rows():
    _jc, tc = _snap_caches(3, 64, 5)
    with pytest.raises(IndexError):
        M.cache_read_rows(tc, [3])
    with pytest.raises(ValueError):
        M.cache_read_rows(tc, [])


def test_expected_row_bytes_and_cost_models():
    from repro.configs.base import get_config as jget
    from repro.kernels import kv_snapshot as jkv
    cfg = get_config("qwen2-7b")
    want = jkv.expected_row_bytes(jget("qwen2-7b"), 2048)
    assert kv_snapshot.expected_row_bytes(cfg, 2048) == want == 117_440_512
    cap = kv_snapshot.capture_cost(want, 1)
    res = kv_snapshot.restore_cost(want, 1, new_fraction=0.5)
    assert cap["hbm_bytes"] == res["hbm_bytes"] == 2.0 * want
    assert cap["host_bytes"] == want and res["host_bytes"] == want / 2
    # H100 device-memory rate, not the TPU's
    assert cap["memory_s"] == 2.0 * want / 3.35e12
    assert roofline.bound_seconds(3.35e12, 1.0) == (1.0, "bytes")
    assert roofline.bound_seconds(1.0, 989e12) == (1.0, "operations")


@pytest.mark.parametrize("keys", [("snapshot_capture", "snapshot_restore"),
                                  ("decode_qkv_rope",)],
                         ids=["snapshot", "decode_qkv_rope"])
def test_snapshot_stats_counters(keys):
    """The port counts the kernels' launches in ``ops.LAUNCHES`` alone
    (the snapshot kernels' and the decode front end's), and
    ``reset_launches`` clears every count: the JAX package's ``STATS``
    transfer counters are not kept (the engine's events carry the
    bytes)."""
    assert not hasattr(kv_snapshot, "STATS")
    assert set(keys) <= set(ops.LAUNCHES)
    for n, key in enumerate(keys, 1):
        ops.LAUNCHES[key] += n
    ops.reset_launches()
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)


def test_cpu_wrappers_do_not_count_launches():
    """Launch counters tick only where a kernel launches (on the card)."""
    ops.reset_launches()
    _jc, tc = _snap_caches(3, 64, 6)
    blob = M.cache_read_rows(tc, [1])
    M.cache_write_rows(tc, blob, [2])
    q = torch.zeros((1, 2, 2, 16))
    kv = torch.zeros((1, 8, 2, 16))
    ops.partition_attention(q, kv, kv, torch.tensor([3], dtype=torch.int32))
    assert not any(ops.LAUNCHES.values())
