"""Prefill and decode on a mesh: the serving rules shard every KV cache on
"kv_seq" (over "model", and over ("data", "model") under the long-context
rules), and each rank writes and attends over its own block of it.

Four gloo processes form a data 2 x model 2 mesh (as in
``tests/test_torch_mesh.py``), and reduced qwen2-7b, gemma2-9b (a ring of
8 slots on its local blocks, a linear cache on its global ones) and
recurrentgemma-2b (RG-LRU states sharded on "lru", a local ring) each run
a prefill of 12 tokens and 4 decode steps, under
``serve_rules_for(cfg, "decode_32k")`` and, for the two long-context
configs, ``serve_rules_for(cfg, "long_500k")``.  The weights are the JAX
package's (``PRNGKey(0)``, carried across by ``repro_torch.convert``) and
the tokens are made with numpy; the pytest process runs the JAX package's
prefill and decode steps on the same weights and tokens, and rank 0 runs
the port's steps unsharded.  Both the sharded and the unsharded logits and
caches are held to JAX's, and the sharded ones to the unsharded port's as
well.

Tolerances: the logits within 2e-5 (f32) and 2e-2 (bf16) of the largest
reference logit, the bounds of the attention kernels' own tests
(``tests/test_kernels.py``): the ranks' partial softmaxes are merged in
another order than one softmax sums, and JAX's matmuls round in another
order than torch's.  The caches, gathered, are within the same bounds;
the RG-LRU state, which both packages keep in bf16 in an f32 run too, at
the bf16 bound, as one rounding of it may flip.  Every cache leaf is a
DTensor whose local block has its shard shape."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import sharding as S
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import model as M
from repro_torch.models.layers import tree_leaves, tree_map

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
WORLD = 4
GROUP_TIMEOUT_S = 300
BATCH, PROMPT, CACHE, STEPS = 4, 12, 16, 4
TOL = {"f32": 2e-5, "bf16": 2e-2}
# (arch, rules' shape name): the long-context rules only for configs that
# run long_500k
CASES = [("qwen2-7b", "decode_32k"), ("gemma2-9b", "decode_32k"),
         ("gemma2-9b", "long_500k"), ("recurrentgemma-2b", "decode_32k"),
         ("recurrentgemma-2b", "long_500k")]


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Run every case in WORLD processes, and the JAX package's steps here
    meanwhile; kill the processes at the timeout or a failure here."""
    workdir = tmp_path_factory.mktemp("serve_mesh")
    jparams = _jax_params(workdir)
    port = _free_port()
    code = ("import sys; sys.path[:0] = [%r, %r]; import "
            "test_torch_serve_mesh as t; t._worker(%r)"
            % (str(TESTS), str(SRC), str(workdir)))
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, PYTHONPATH=str(SRC),
                   REPRO_COORDINATOR=f"127.0.0.1:{port}",
                   REPRO_NUM_PROCESSES=str(WORLD),
                   REPRO_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        want = _jax_steps(jparams)
        outs = [p.communicate(timeout=GROUP_TIMEOUT_S)[0] for p in procs]
    except BaseException as e:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        if isinstance(e, subprocess.TimeoutExpired):
            pytest.fail(f"serving mesh did not finish in {GROUP_TIMEOUT_S} s")
        raise
    bad = [(r, o[-3000:]) for r, (p, o) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    assert not bad, f"serving mesh failed: {bad}"
    res = torch.load(workdir / "serve.pt", weights_only=False)
    for (arch, _, dtype), r in res.items():
        r["jax"], r["jax_caches"] = want[arch, dtype]
    return res


def _tokens(cfg):
    return np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(BATCH, PROMPT + STEPS)).astype(np.int32)


def _jax_params(workdir: Path, cases=CASES) -> dict:
    """The JAX package's ``PRNGKey(0)`` weights of every arch of
    ``cases``, as numpy trees; saved in ``workdir`` as the port's tensors
    for the ranks."""
    import jax

    from repro.configs.base import get_config as jax_get_config
    from repro.configs.base import reduced as jax_reduced
    from repro.models import model as JM
    from repro_torch.convert import tree_from_numpy
    out = {}
    for arch in dict.fromkeys(a for a, _ in cases):
        jp = jax.device_get(JM.init_params(
            jax_reduced(jax_get_config(arch)), jax.random.PRNGKey(0)))
        torch.save(tree_from_numpy(jp, "cpu"), workdir / f"{arch}.pt")
        out[arch] = jp
    return out


def _jax_steps(jparams: dict) -> dict:
    """The JAX package's prefill and STEPS decode steps on the same weights
    (cast as the ranks cast them) and tokens: (arch, dtype) -> (logits of
    every step in f32, cache leaves in f32 or, where JAX keeps them so,
    bf16)."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_config as jax_get_config
    from repro.configs.base import reduced as jax_reduced
    from repro.models import model as JM

    def f32(x):
        return torch.from_numpy(np.array(x, np.float32))
    out = {}
    for arch, jp in jparams.items():
        jcfg = jax_reduced(jax_get_config(arch))
        toks = _tokens(jcfg)
        for name, jdt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            p = jax.tree.map(lambda x: jnp.asarray(x).astype(jdt) if
                             jnp.issubdtype(x.dtype, jnp.floating) else
                             jnp.asarray(x), jp)
            c = _cast_caches(JM.init_caches(jcfg, BATCH, CACHE), jdt)
            logits, c = JM.prefill(jcfg, p, {"tokens": jnp.asarray(
                toks[:, :PROMPT])}, c)
            steps = [f32(logits)]
            for i in range(STEPS):
                pos = jnp.full((BATCH,), PROMPT + i, jnp.int32)
                logits, c = JM.decode_step(
                    jcfg, p, jnp.asarray(toks[:, PROMPT + i:PROMPT + i + 1]),
                    pos, c)
                steps.append(f32(logits))
            out[arch, name] = steps, [
                f32(x).to(torch.bfloat16) if x.dtype == jnp.bfloat16
                else f32(x) for x in jax.tree.leaves(c)]
    return out


def _cast_caches(tree, dtype):
    """Every cache leaf in ``dtype`` but the RG-LRU state, which both
    packages write in bf16 whatever the cache's dtype."""
    if isinstance(tree, dict):
        return {k: v if k == "state" else _cast_caches(v, dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_caches(v, dtype) for v in tree)
    return tree.to(dtype) if isinstance(tree, torch.Tensor) \
        else tree.astype(dtype)


def _steps(cfg, params, caches, dtype, place=None):
    """Prefill PROMPT tokens, then STEPS decode steps; ``place(x, axes)``
    puts an input on the mesh.  Returns the logits of every step."""
    place = place or (lambda x, axes: x)
    toks = torch.from_numpy(_tokens(cfg))
    out = []
    with torch.no_grad():
        logits, caches = M.prefill(
            cfg, params, {"tokens": place(toks[:, :PROMPT],
                                          ("batch", "seq"))}, caches)
        out.append(logits)
        for i in range(STEPS):
            pos = torch.full((BATCH,), PROMPT + i, dtype=torch.int32)
            logits, caches = M.decode_step(
                cfg, params, place(toks[:, PROMPT + i:PROMPT + i + 1],
                                   ("batch", None)),
                place(pos, ("batch",)), caches)
            out.append(logits)
    return [x.full_tensor() if S.is_dtensor(x) else x for x in out], caches


def _worker(workdir: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.distributed import initialize
    torch.set_num_threads(1)
    rank, _ = initialize(device="cpu")
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    res = {}
    for arch, shape in CASES:
        cfg = reduced(get_config(arch))
        rules = S.serve_rules_for(cfg, shape)
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            params = tree_map(
                lambda x: x.to(dtype) if x.is_floating_point() else x,
                torch.load(Path(workdir) / f"{arch}.pt"))
            caches = _cast_caches(M.init_caches(cfg, BATCH, CACHE,
                                                device="cpu"), dtype)
            psh = M.param_shardings(cfg, mesh, rules)
            csh = M.cache_shardings(cfg, BATCH, CACHE, mesh, rules)

            def put(tree, shardings):
                return type(tree)(S.distribute(x, sh) for x, sh in zip(
                    tree_leaves(tree), tree_leaves(shardings)))

            def place(x, axes):
                return S.distribute(x, S.named_sharding(
                    axes, tuple(x.shape), mesh, rules))

            from repro_torch.models.layers import tree_flatten, tree_unflatten
            pl, pdef = tree_flatten(params)
            cl, cdef = tree_flatten(caches)
            dparams = tree_unflatten(pdef, list(put(pl, psh)))
            dcaches = tree_unflatten(cdef, list(put(cl, csh)))
            with S.sharding_ctx(mesh, rules):
                logits, dcaches = _steps(cfg, dparams, dcaches, dtype, place)
            shards_ok = all(
                S.is_dtensor(x) and x.placements == sh.placements
                and tuple(x.to_local().shape) == sh.shard_shape(
                    tuple(x.shape))
                for x, sh in zip(tree_leaves(dcaches), tree_leaves(csh),
                                 strict=True))
            sharded_kv = [tuple(sh.spec) for sh in tree_leaves(csh)]
            entry = {"logits": logits, "shards_ok": shards_ok,
                     "specs": sharded_kv,
                     "caches": [x.full_tensor() for x in
                                tree_leaves(dcaches)]}
            if rank == 0:
                plain, pc = _steps(cfg, params, caches, dtype)
                entry.update(plain=plain, plain_caches=tree_leaves(pc))
            res[arch, shape, name] = entry
    if rank == 0:
        torch.save(res, Path(workdir) / "serve.pt")
    dist.barrier()
    dist.destroy_process_group()


def _leaf_tol(dtype, got, want) -> float:
    """A bf16 leaf (the RG-LRU state in an f32 run too) at the bf16 bound."""
    return TOL["bf16"] if torch.bfloat16 in (got.dtype, want.dtype) \
        else TOL[dtype]


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch,shape", CASES)
def test_logits_on_the_mesh_match_the_unsharded_run(arch, shape, dtype,
                                                    served):
    r = served[arch, shape, dtype]
    assert len(r["logits"]) == STEPS + 1
    for step, (got, want) in enumerate(zip(r["logits"], r["plain"])):
        assert _rel(got, want) < TOL[dtype], (step, _rel(got, want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch,shape", CASES)
def test_prefill_and_decode_on_the_mesh_match_jax(arch, shape, dtype,
                                                  served):
    """The sharded run and the unsharded port, each against the JAX
    package's steps on the same weights and tokens: logits and caches."""
    r = served[arch, shape, dtype]
    for run, caches in (("logits", "caches"), ("plain", "plain_caches")):
        for step, (got, want) in enumerate(zip(r[run], r["jax"],
                                               strict=True)):
            assert got.shape == want.shape, (run, step)
            assert _rel(got, want) < TOL[dtype], (run, step,
                                                  _rel(got, want))
        for got, want in zip(r[caches], r["jax_caches"], strict=True):
            assert got.shape == want.shape
            assert _rel(got, want) < _leaf_tol(dtype, got, want) \
                or not want.abs().max()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch,shape", CASES)
def test_each_cache_leaf_holds_only_its_shard(arch, shape, dtype, served):
    r = served[arch, shape, dtype]
    assert r["shards_ok"]
    # the KV leaves are split on kv_seq: over "model", or both axes
    kv_entry = ("data", "model") if shape == "long_500k" else "model"
    assert any(len(s) >= 3 and s[-3] == kv_entry for s in r["specs"]), \
        r["specs"]
    for got, want in zip(r["caches"], r["plain_caches"], strict=True):
        assert _rel(got, want) < _leaf_tol(dtype, got, want) \
            or not want.abs().max()


def test_decode_over_a_split_kv_seq_takes_the_kernel_partials(monkeypatch):
    """Over a kv_seq axis of more than one rank, ``_decode_block`` asks the
    kernel's wrapper (``ops.partition_attention``, which launches the CUDA
    kernel on the card) for its block's partials, with the block's offset
    and the ring's length, and merges them; it calls no plain version
    itself.  One process: the all-reduces are left out, so the merge is
    this rank's block alone."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention as A

    assert not hasattr(A, "ref")
    calls, kernel = [], ops.partition_attention

    def spy(*args, **kw):
        calls.append(kw)
        return kernel(*args, **kw)

    class Mesh:
        shape = {"data": 1, "model": 2}

        @staticmethod
        def get_local_rank(axis):
            return 1 if axis == "model" else 0

        @staticmethod
        def get_group(axis):
            return None

    monkeypatch.setattr(A.ops, "partition_attention", spy)
    monkeypatch.setattr(A.dist, "all_reduce", lambda x, **kw: None)
    monkeypatch.setattr(A, "psum", lambda x, axis: x)
    rng = np.random.default_rng(3)
    b, tb, hkv, g, dh = 3, 8, 2, 3, 16

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    qg, kn, vn = randn(b, hkv, g, dh), randn(b, hkv, dh), randn(b, hkv, dh)
    kc, vc = randn(b, tb, hkv, dh), randn(b, tb, hkv, dh)
    pos = torch.tensor([12, 28, 3], dtype=torch.int32)   # 3: another rank's
    before = kc[2].clone()
    with S.sharding_ctx(Mesh(), S.serve_rules_for(
            reduced(get_config("qwen2-7b")), "decode_32k")):
        got = A._decode_block(qg, kn, vn, kc, vc, pos, t=2 * tb,
                              axes=("model",), window=0, scale=0.25,
                              cap=0.0)
    assert len(calls) == 1
    assert {k: calls[0][k] for k in ("partials", "off", "t")} == \
        {"partials": True, "off": tb, "t": 2 * tb}
    assert torch.equal(kc[0, 12 - tb], kn[0]) and torch.equal(vc[1, 4], vn[1])
    assert torch.equal(kc[2], before)
    top, l, acc = ref.partition_attention(qg, kc, vc, pos, scale=0.25,
                                          off=tb, t=2 * tb, partials=True)
    torch.testing.assert_close(got, acc / l[..., None])
