"""Decode over a KV cache split along "kv_seq": the attention kernel's
block and partials contract on the CPU, and ``_decode_block``'s merge over
2 and 4 gloo ranks against the JAX package.

``ops.partition_attention(..., off, t, partials=True)`` takes the plain
version on the CPU; a float64 model of what the CUDA kernel does with a
block (``partition_attention.block_runs``, the mirror of the kernel's two
runs of valid slots, cut into the kernel's splits and merged as its
cluster merges them) is held to those partials, and the partials of every
block, merged, to the Pallas kernel over the whole ring in interpret mode.

The gloo groups: each rank holds its block of the ring (over "model" on a
(1, 2) mesh, over ("data", "model") on a (2, 2) mesh, as the long-context
rules split it), writes the new K/V where its block holds the slot, and
merges the ranks' partials (an all-reduce max and two sums).  Their output
is held to the JAX package's decode attention on the same numpy inputs:
the Pallas kernel in interpret mode (as ``tests/test_kernels.py`` runs it)
and ``repro.models.attention._decode_attention`` (XLA, what GSPMD
partitions), within 2e-5 (f32) and 2e-2 (bf16) of the largest output, the
attention kernels' own bounds: the blocks' partials are summed in another
order than one softmax sums.  The rows cover pos < 0 (every slot masked:
the mean of V over the ring), a position inside the first block only, one
at a block's edge, and rings wrapped past t; the cases a window and a
logit cap."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.partition_attention import \
    partition_attention as pallas_partition_attention
from repro.models.attention import _decode_attention as jax_decode_attention
from repro_torch.kernels import ops, ref
from repro_torch.kernels import partition_attention as pa
from repro_torch.models.attention import merge_partials

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
GROUP_TIMEOUT_S = 300
NEG_INF = -2.0 ** 30
TOL = {"f32": 2e-5, "bf16": 2e-2}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
P, T, HKV, G, DH = 6, 32, 2, 3, 16
# pos < 0; inside the first quarter only; at the first half's last slot;
# the ring's last slot; wrapped once; wrapped far past t
POSITIONS = [-1, 5, 15, 31, 40, 7 * T + 3]
# (name, window, logit cap, query scale)
CASES = [("plain", 0, 0.0, None), ("window", 12, 0.0, None),
         ("window_cap", 20, 5.0, 0.5)]
# (world, mesh shape, the axes "kv_seq" is split over)
WORLDS = [(2, (1, 2), ("model",)), (4, (2, 2), ("data", "model"))]


def _inputs(dtype: str, seed: int = 0) -> dict:
    """q (P, Hkv, G, Dh), the cache before the step (P, T, Hkv, Dh), the
    step's new K/V (P, Hkv, Dh) and the positions, as numpy arrays
    rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    tdt = DTYPES[dtype][0]

    def arr(*shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.to(tdt).float().numpy()
    return {"q": arr(P, HKV, G, DH), "k": arr(P, T, HKV, DH),
            "v": arr(P, T, HKV, DH), "kn": arr(P, HKV, DH),
            "vn": arr(P, HKV, DH),
            "pos": np.array(POSITIONS, np.int32)}


def _written(x: dict) -> tuple[np.ndarray, np.ndarray]:
    """The cache after the step: the new K/V in slot pos mod t (floor)."""
    k, v = x["k"].copy(), x["v"].copy()
    rows, slot = np.arange(P), np.mod(x["pos"], T)
    k[rows, slot], v[rows, slot] = x["kn"], x["vn"]
    return k, v


def _jax_outputs(x: dict, dtype: str, window, cap, scale) -> tuple:
    """The Pallas kernel (interpret mode) and XLA's decode attention over
    the whole written ring, in f32."""
    jdt = DTYPES[dtype][1]
    k, v = _written(x)
    q, k, v = (jnp.asarray(a, jdt) for a in (x["q"], k, v))
    pos = jnp.asarray(x["pos"])
    pallas = pallas_partition_attention(
        q, k, v, pos, window=window, logit_cap=cap, scale=scale,
        block_t=8, interpret=True)
    xla = jax_decode_attention(q[:, None], k, v, pos, window,
                               scale or DH ** -0.5, cap)[:, 0]
    return (np.asarray(pallas, np.float32), np.asarray(xla, np.float32))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------- the contract on the CPU


def _kernel_model(q, k, v, pos, *, t, off, window, cap, scale, splits):
    """float64 partials of one (row, KV head) block as the CUDA kernel
    forms them: q (G, Dh), k/v (Tb, Dh) the block, its valid slots
    ``block_runs`` in the range's order, cut into ``splits`` slices, each
    slice's (m, l, acc) from NEG_INF, merged as the cluster merges them.
    A masked row (pos < 0) scores every slot NEG_INF."""
    slots = [s for a, b in pa.block_runs(pos, t, window, off, k.shape[0])
             for s in range(a, b)]
    g = q.shape[0]
    top, lsum = np.empty(g), np.empty(g)
    acc = np.zeros((g, q.shape[1]))
    for gi in range(g):
        parts = []
        for j0, j1 in pa.split_bounds(len(slots), splits):
            sl = slots[j0:j1]
            if pos < 0:
                sc = np.full(len(sl), NEG_INF)
            else:
                sc = (k[sl] @ q[gi]) * scale
                if cap:
                    sc = np.tanh(sc / cap) * cap
            m = max([NEG_INF] + list(sc))
            e = np.exp(sc - m)
            parts.append((m, e.sum(), (e[:, None] * v[sl]).sum(0)))
        mm = max(m for m, _, _ in parts)
        w = [np.exp(m - mm) for m, _, _ in parts]
        top[gi] = mm
        lsum[gi] = sum(l * x for (_, l, _), x in zip(parts, w))
        acc[gi] = sum(a * x for (_, _, a), x in zip(parts, w))
    return top, lsum, acc


@pytest.mark.parametrize("blocks", [1, 2, 4])
@pytest.mark.parametrize("name,window,cap,scale", CASES)
def test_block_partials_match_the_plain_version(name, window, cap, scale,
                                                blocks):
    """Per block: the CPU dispatch returns the plain version's partials;
    the kernel's model (its runs of valid slots, splits and merge) gives
    the same max, normaliser and unnormalised output wherever the block
    holds a valid slot for the row, and max NEG_INF (merge weight 0)
    where it holds none."""
    x = _inputs("f32")
    k, v = _written(x)
    tb = T // blocks
    sc = scale or DH ** -0.5
    q = torch.from_numpy(x["q"])
    pos = torch.from_numpy(x["pos"])
    for b in range(blocks):
        off = b * tb
        kb = torch.from_numpy(np.ascontiguousarray(k[:, off:off + tb]))
        vb = torch.from_numpy(np.ascontiguousarray(v[:, off:off + tb]))
        kw = dict(window=window, logit_cap=cap, scale=scale, off=off, t=T)
        got = ops.partition_attention(q, kb, vb, pos, partials=True, **kw)
        want = ref.partition_attention(q, kb, vb, pos, partials=True, **kw)
        for a, w in zip(got, want, strict=True):
            assert torch.equal(a, w)
        top, lsum, acc = (w.double().numpy() for w in want)
        for r, p in enumerate(POSITIONS):
            valid = bool(pa.block_runs(p, T, window, off, tb))
            for h in range(HKV):
                m_top, m_l, m_acc = _kernel_model(
                    x["q"][r, h].astype(np.float64),
                    k[r, off:off + tb, h].astype(np.float64),
                    v[r, off:off + tb, h].astype(np.float64), p, t=T,
                    off=off, window=window, cap=cap, scale=sc, splits=3)
                if p >= 0 and not valid:
                    assert (m_top == NEG_INF).all() and (m_l == 0).all()
                    assert (top[r, h] == NEG_INF).all()
                    continue
                np.testing.assert_allclose(m_top, top[r, h], rtol=1e-6,
                                           atol=1e-6)
                np.testing.assert_allclose(m_l, lsum[r, h], rtol=1e-5)
                np.testing.assert_allclose(m_acc, acc[r, h], rtol=1e-5,
                                           atol=1e-5)


@pytest.mark.parametrize("blocks", [2, 4])
@pytest.mark.parametrize("name,window,cap,scale", CASES)
def test_merged_blocks_match_pallas_over_the_whole_ring(name, window, cap,
                                                        scale, blocks):
    """The blocks' partials merged by ``merge_partials`` (reductions over
    a stacked block dim) equal the Pallas kernel over the whole ring, the
    one-block kernel's plain version, and the mean of V for pos < 0."""
    x = _inputs("f32", seed=1)
    k, v = _written(x)
    tb = T // blocks
    q, pos = torch.from_numpy(x["q"]), torch.from_numpy(x["pos"])
    parts = [ops.partition_attention(
        q, torch.from_numpy(np.ascontiguousarray(k[:, o:o + tb])),
        torch.from_numpy(np.ascontiguousarray(v[:, o:o + tb])), pos,
        window=window, logit_cap=cap, scale=scale, off=o, t=T,
        partials=True) for o in range(0, T, tb)]
    top, lsum, acc = (torch.stack(z) for z in zip(*parts))
    got = merge_partials(top, lsum, acc,
                         lambda z: z.amax(0, keepdim=True),
                         lambda z: z.sum(0))
    pallas, _ = _jax_outputs(x, "f32", window, cap, scale)
    assert _rel(got, pallas) < TOL["f32"]
    whole = ops.partition_attention(q, torch.from_numpy(k),
                                    torch.from_numpy(v), pos, window=window,
                                    logit_cap=cap, scale=scale)
    assert _rel(got, whole) < TOL["f32"]
    mean_v = v[0].mean(0)[:, None, :]                 # row 0: pos = -1
    np.testing.assert_allclose(got[0].numpy(), np.broadcast_to(
        mean_v, (HKV, G, DH)), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- the gloo groups


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _worker(workdir: str, world: int) -> None:
    """One rank: its block of every case's ring, ``_decode_block`` under
    the mesh's context; rank 0 saves every output."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import sharding as S
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch.distributed import initialize
    from repro_torch.models.attention import _decode_block
    torch.set_num_threads(1)
    rank, _ = initialize(device="cpu")
    _, shape, axes = next(w for w in WORLDS if w[0] == world)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    rules = S.serve_rules_for(reduced(get_config("qwen2-7b")), "decode_32k")
    tb = T // world
    out = {}
    with S.sharding_ctx(mesh, rules):
        off = S.block_start(axes, tb)
        for dtype in DTYPES:
            tdt = DTYPES[dtype][0]
            x = _inputs(dtype)

            def t(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(tdt)
            for name, window, cap, scale in CASES:
                kc, vc = t(x["k"][:, off:off + tb]), t(x["v"][:, off:off + tb])
                got = _decode_block(
                    t(x["q"]), t(x["kn"]), t(x["vn"]), kc, vc,
                    torch.from_numpy(x["pos"]), t=T, axes=axes,
                    window=window, scale=scale or DH ** -0.5, cap=cap)
                blocks = [torch.empty_like(kc) for _ in range(world)]
                dist.all_gather(blocks, kc)
                out[dtype, name] = {"out": got.float(),
                                    "k": torch.cat(blocks, 1).float()}
    if rank == 0:
        torch.save(out, Path(workdir) / f"world{world}.pt")
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both worlds' processes at once; killed at the timeout."""
    workdir = tmp_path_factory.mktemp("kv_seq")
    procs = []
    for world, _, _ in WORLDS:
        port = _free_port()
        code = ("import sys; sys.path[:0] = [%r, %r]; import "
                "test_torch_kv_seq_decode as t; t._worker(%r, %d)"
                % (str(TESTS), str(SRC), str(workdir), world))
        for rank in range(world):
            env = dict(os.environ, PYTHONPATH=str(SRC),
                       REPRO_COORDINATOR=f"127.0.0.1:{port}",
                       REPRO_NUM_PROCESSES=str(world),
                       REPRO_PROCESS_ID=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=GROUP_TIMEOUT_S)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"kv_seq groups did not finish in {GROUP_TIMEOUT_S} s")
    bad = [o[-3000:] for p, o in zip(procs, outs) if p.returncode != 0]
    assert not bad, f"kv_seq groups failed: {bad}"
    return {w: torch.load(workdir / f"world{w}.pt") for w, _, _ in WORLDS}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name,window,cap,scale", CASES)
@pytest.mark.parametrize("world", [w for w, _, _ in WORLDS])
def test_split_decode_on_gloo_matches_jax(world, name, window, cap, scale,
                                          dtype, ranks):
    """The ranks' merged output against the Pallas kernel and XLA's
    decode attention on the same inputs, and each rank's written block,
    gathered, against the reference's cache update."""
    r = ranks[world][dtype, name]
    x = _inputs(dtype)
    pallas, xla = _jax_outputs(x, dtype, window, cap, scale)
    assert r["out"].shape == (P, HKV, G, DH)
    assert _rel(r["out"], pallas) < TOL[dtype]
    assert _rel(r["out"], xla) < TOL[dtype]
    np.testing.assert_array_equal(r["k"].numpy(), _written(x)[0])
