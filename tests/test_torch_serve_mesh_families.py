"""Prefill and decode on a mesh for the families that
``tests/test_torch_serve_mesh.py`` leaves out: mamba2-780m (its SSM state
and conv tails, under ``decode_32k`` and ``long_500k``), mixtral-8x7b (MoE
decode), seamless-m4t-medium (the encoder over stub frames, and its cross-
attention cache split on "kv_seq") and qwen2-vl-72b (the vision stub and
M-RoPE grid positions, under ``SERVE_BIG_RULES``: weights over "data" as
well as "model").

As in that file: four gloo processes form a data 2 x model 2 mesh, each
case runs a prefill of 12 tokens and 4 decode steps on the JAX package's
``PRNGKey(0)`` weights and numpy tokens (and frames, or patches and grid
positions), in f32 and in bf16, and the pytest process runs the JAX
package's steps meanwhile; rank 0 also runs the port's steps unsharded.
The sharded and the unsharded logits and caches are held to JAX's, and the
sharded ones to the unsharded port's, within 2e-5 (f32) and 2e-2 (bf16)
of the largest reference value, and on the MoE model in bf16 within 8e-2,
the reference's MoE bound: bf16 rounding in another order can flip a
top-k choice near a tie (``tests/test_decode_consistency.py``).  A bf16
cache leaf (the SSM state, which both packages keep in bf16) is held at
the bf16 bound.

On a mesh the reference routes each "data" shard's tokens through its MoE
layers on their own (``repro.models.moe._moe_shard_map``: the capacity of
an expert counts that shard's tokens), so a sharded MoE run is the model
run on each data half of the batch.  For mixtral the references (JAX's
steps and the port's unsharded steps) run each half of the rows on its
own, as ``tests/test_torch_mesh.py`` holds ``_moe_shard_map`` to the
dense layer on each half; the full batch routes otherwise once a token is
dropped."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import sharding as S
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import model as M
from repro_torch.models.layers import (tree_flatten, tree_leaves, tree_map,
                                       tree_unflatten)
from test_torch_serve_mesh import (_cast_caches, _free_port, _jax_params,
                                   _leaf_tol, _rel)

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
WORLD = 4
GROUP_TIMEOUT_S = 300
BATCH, PROMPT, CACHE, STEPS = 4, 12, 16, 4
TOL = {"f32": 2e-5, "bf16": 2e-2}
TOL_MOE = 8e-2
# (arch, rules): a shape name for serve_rules_for, or a rule table's name
CASES = [("mamba2-780m", "decode_32k"), ("mamba2-780m", "long_500k"),
         ("mixtral-8x7b", "decode_32k"),
         ("seamless-m4t-medium", "decode_32k"),
         ("qwen2-vl-72b", "SERVE_BIG_RULES")]


def _halves(cfg) -> list[slice]:
    """The rows each reference run takes: each data half for MoE."""
    if cfg.num_experts:
        return [slice(0, BATCH // 2), slice(BATCH // 2, BATCH)]
    return [slice(0, BATCH)]


def _join(parts: list, axes=None) -> list:
    """Per-half leaves joined on their batch axes (``axes``, one a leaf;
    default 0, the logits')."""
    if len(parts) == 1:
        return parts[0]
    axes = axes or [0] * len(parts[0])
    return [torch.cat(leaves, dim=ax) for leaves, ax in
            zip(zip(*parts, strict=True), axes, strict=True)]


def _batch_axes(cfg) -> list[int]:
    """Each cache leaf's batch axis, in tree order."""
    return [s.axes.index("batch") for s in
            tree_leaves(M.cache_specs(cfg, BATCH, CACHE))]


def _rows(x, rows: slice, key: str = ""):
    """An extra's rows: M-RoPE positions (3, B, S) on axis 1."""
    return x[:, rows] if key == "positions" else x[rows]


def _rules(cfg, name: str):
    return getattr(S, name) if name.isupper() else \
        S.serve_rules_for(cfg, name)


def _tol(arch: str, dtype: str) -> float:
    return TOL_MOE if arch == "mixtral-8x7b" and dtype == "bf16" \
        else TOL[dtype]


def _tokens(cfg):
    return np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(BATCH, PROMPT + STEPS)).astype(np.int32)


def _extras(cfg) -> dict:
    """The prompt's other inputs, numpy, with their logical axes: stub
    frames for the encoder-decoder; stub patches over the first tokens
    and (3, B, S) M-RoPE positions (the patches' grid rows and columns in
    sections 1 and 2) for the VLM."""
    rng = np.random.default_rng(11)
    if cfg.family == "audio":
        return {"frames": (rng.standard_normal(
            (BATCH, cfg.encoder_src_len, cfg.d_model)).astype(np.float32),
            ("batch", "src", None))}
    if cfg.family == "vlm":
        n = cfg.vision_stub_tokens
        pos = np.broadcast_to(np.arange(PROMPT, dtype=np.int32),
                              (3, BATCH, PROMPT)).copy()
        pos[1, :, :n], pos[2, :, :n] = np.arange(n) // 2, np.arange(n) % 2
        return {"vision_embeds": (rng.standard_normal(
            (BATCH, n, cfg.d_model)).astype(np.float32),
            ("batch", None, None)),
            "positions": (pos, (None, "batch", "seq"))}
    return {}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every case in WORLD processes, the JAX package's steps here
    meanwhile; the processes are killed at the timeout or a failure."""
    workdir = tmp_path_factory.mktemp("serve_mesh_families")
    jparams = _jax_params(workdir, CASES)
    port = _free_port()
    code = ("import sys; sys.path[:0] = [%r, %r]; import "
            "test_torch_serve_mesh_families as t; t._worker(%r)"
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


def _jax_steps(jparams: dict) -> dict:
    """The JAX package's prefill (with the extras) and STEPS decode steps
    on the same weights, cast as the ranks cast them: (arch, dtype) ->
    (logits of every step in f32, cache leaves in f32 or bf16)."""
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
            logit_parts, cache_parts = [], []
            for rows in _halves(jcfg):
                n = rows.stop - rows.start
                extras = {k: jnp.asarray(_rows(v, rows, k))
                          for k, (v, _) in _extras(jcfg).items()}
                c = _cast_caches(JM.init_caches(jcfg, n, CACHE), jdt)
                logits, c = JM.prefill(jcfg, p, {"tokens": jnp.asarray(
                    toks[rows, :PROMPT]), **extras}, c)
                steps = [f32(logits)]
                for i in range(STEPS):
                    pos = jnp.full((n,), PROMPT + i, jnp.int32)
                    logits, c = JM.decode_step(jcfg, p, jnp.asarray(
                        toks[rows, PROMPT + i:PROMPT + i + 1]), pos, c)
                    steps.append(f32(logits))
                logit_parts.append(steps)
                cache_parts.append([
                    f32(x).to(torch.bfloat16) if x.dtype == jnp.bfloat16
                    else f32(x) for x in jax.tree.leaves(c)])
            out[arch, name] = _join(logit_parts), _join(
                cache_parts, _batch_axes(reduced(get_config(arch))))
    return out


def _steps(cfg, params, caches, place=None, rows=slice(0, BATCH)):
    """Prefill PROMPT tokens (with the extras), then STEPS decode steps,
    of ``rows``; ``place(x, axes)`` puts an input on the mesh."""
    place = place or (lambda x, axes: x)
    toks = torch.from_numpy(_tokens(cfg))[rows]
    n = toks.shape[0]
    batch = {"tokens": place(toks[:, :PROMPT], ("batch", "seq"))}
    batch.update({k: place(torch.from_numpy(_rows(v, rows, k)), axes)
                  for k, (v, axes) in _extras(cfg).items()})
    out = []
    with torch.no_grad():
        logits, caches = M.prefill(cfg, params, batch, caches)
        out.append(logits)
        for i in range(STEPS):
            pos = torch.full((n,), PROMPT + i, dtype=torch.int32)
            logits, caches = M.decode_step(
                cfg, params, place(toks[:, PROMPT + i:PROMPT + i + 1],
                                   ("batch", None)),
                place(pos, ("batch",)), caches)
            out.append(logits)
    return [x.full_tensor() if S.is_dtensor(x) else x for x in out], caches


def _plain(cfg, params, dtype):
    """The port's unsharded steps of each reference half, joined."""
    logit_parts, cache_parts = [], []
    for rows in _halves(cfg):
        caches = _cast_caches(M.init_caches(
            cfg, rows.stop - rows.start, CACHE, device="cpu"), dtype)
        logits, caches = _steps(cfg, params, caches, rows=rows)
        logit_parts.append(logits)
        cache_parts.append(tree_leaves(caches))
    return _join(logit_parts), _join(cache_parts, _batch_axes(cfg))


def _worker(workdir: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.distributed import initialize
    torch.set_num_threads(1)
    rank, _ = initialize(device="cpu")
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    res = {}
    for arch, rules_name in CASES:
        cfg = reduced(get_config(arch))
        rules = _rules(cfg, rules_name)
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            params = tree_map(
                lambda x: x.to(dtype) if x.is_floating_point() else x,
                torch.load(Path(workdir) / f"{arch}.pt"))
            caches = _cast_caches(M.init_caches(cfg, BATCH, CACHE,
                                                device="cpu"), dtype)
            psh = M.param_shardings(cfg, mesh, rules)
            csh = M.cache_shardings(cfg, BATCH, CACHE, mesh, rules)

            def put(tree, shardings):
                leaves, treedef = tree_flatten(tree)
                return tree_unflatten(treedef, [
                    S.distribute(x, sh) for x, sh in zip(
                        leaves, tree_leaves(shardings), strict=True)])

            def place(x, axes):
                return S.distribute(x, S.named_sharding(
                    axes, tuple(x.shape), mesh, rules))

            dparams, dcaches = put(params, psh), put(caches, csh)
            with S.sharding_ctx(mesh, rules):
                logits, dcaches = _steps(cfg, dparams, dcaches, place)
            shards_ok = all(
                S.is_dtensor(x) and x.placements == sh.placements
                and tuple(x.to_local().shape) == sh.shard_shape(
                    tuple(x.shape))
                for x, sh in zip(tree_leaves(dcaches), tree_leaves(csh),
                                 strict=True))
            entry = {"logits": logits, "shards_ok": shards_ok,
                     "specs": [tuple(sh.spec) for sh in tree_leaves(csh)],
                     "caches": [x.full_tensor() for x in
                                tree_leaves(dcaches)]}
            if rank == 0:
                plain, pc = _plain(cfg, params, dtype)
                entry.update(plain=plain, plain_caches=pc)
            res[arch, rules_name, name] = entry
    if rank == 0:
        torch.save(res, Path(workdir) / "serve.pt")
    dist.barrier()
    dist.destroy_process_group()


def _cache_tol(arch, dtype, got, want) -> float:
    return max(_leaf_tol(dtype, got, want), _tol(arch, dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch,rules", CASES)
def test_logits_on_the_mesh_match_the_unsharded_run(arch, rules, dtype,
                                                    served):
    r = served[arch, rules, dtype]
    assert len(r["logits"]) == STEPS + 1
    for step, (got, want) in enumerate(zip(r["logits"], r["plain"])):
        assert _rel(got, want) < _tol(arch, dtype), (step, _rel(got, want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch,rules", CASES)
def test_prefill_and_decode_on_the_mesh_match_jax(arch, rules, dtype,
                                                  served):
    """The sharded run and the unsharded port, each against the JAX
    package's steps on the same inputs: logits and caches."""
    r = served[arch, rules, dtype]
    for run, caches in (("logits", "caches"), ("plain", "plain_caches")):
        for step, (got, want) in enumerate(zip(r[run], r["jax"],
                                               strict=True)):
            assert got.shape == want.shape, (run, step)
            assert _rel(got, want) < _tol(arch, dtype), (run, step,
                                                         _rel(got, want))
        for got, want in zip(r[caches], r["jax_caches"], strict=True):
            assert got.shape == want.shape
            assert _rel(got, want) < _cache_tol(arch, dtype, got, want) \
                or not want.abs().max()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch,rules", CASES)
def test_each_cache_leaf_holds_only_its_shard(arch, rules, dtype, served):
    """Every cache leaf a DTensor with its shard's shape; the attention
    caches (seamless' self and cross K/V) split on "kv_seq", over "model"
    or, under the long-context rules, both axes; mamba2's state and conv
    tails on its heads and channels."""
    r = served[arch, rules, dtype]
    assert r["shards_ok"]
    if arch != "mamba2-780m":
        kv_entry = ("data", "model") if rules == "long_500k" else "model"
        assert any(len(s) >= 3 and s[-3] == kv_entry for s in r["specs"]), \
            r["specs"]
    else:
        assert any("model" in s for s in r["specs"]), r["specs"]
    for got, want in zip(r["caches"], r["plain_caches"], strict=True):
        assert _rel(got, want) < _cache_tol(arch, dtype, got, want) \
            or not want.abs().max()
