"""The chunked attention path on a mesh: reduced gemma2-9b prefills 8192
tokens (``FLASH_SEQ``: every block takes ``_chunked_attention``) on a
data 2 x model 2 gloo mesh under ``serve_rules_for(cfg, "decode_32k")``,
its global caches split on "kv_seq" over "model", then decodes one step
over the split cache; held to the JAX package's prefill and decode step on
the same ``PRNGKey(0)`` weights and numpy tokens, as
``tests/test_torch_families.py::test_long_prefill_matches_jax`` holds the
unsharded port.  bf16 weights, so the bound is 2e-2 of the largest
reference value for the logits and every cache leaf."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.models import attention as attn
from test_torch_serve_mesh import _free_port, _rel

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
WORLD = 4
GROUP_TIMEOUT_S = 400
ARCH = "gemma2-9b"
BATCH, SEQ = 2, attn.FLASH_SEQ
TOL = 2e-2


def _tokens(cfg):
    return np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(BATCH, SEQ + 1)).astype(np.int32)


def _worker(workdir: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import sharding as S
    from repro_torch.launch.distributed import initialize
    from repro_torch.models import model as M
    from repro_torch.models.layers import (tree_flatten, tree_leaves,
                                           tree_unflatten)
    torch.set_num_threads(1)
    rank, _ = initialize(device="cpu")
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = reduced(get_config(ARCH))
    rules = S.serve_rules_for(cfg, "decode_32k")
    calls = []
    chunked = attn._chunked_attention

    def spy(*a):
        calls.append(tuple(a[0].shape))
        return chunked(*a)
    attn._chunked_attention = spy

    def put(tree, shardings):
        leaves, treedef = tree_flatten(tree)
        return tree_unflatten(treedef, [S.distribute(x, sh) for x, sh in zip(
            leaves, tree_leaves(shardings), strict=True)])

    def place(x, axes):
        return S.distribute(x, S.named_sharding(axes, tuple(x.shape), mesh,
                                                rules))
    params = put(torch.load(Path(workdir) / f"{ARCH}.pt"),
                 M.param_shardings(cfg, mesh, rules))
    csh = M.cache_shardings(cfg, BATCH, SEQ, mesh, rules)
    caches = put(M.init_caches(cfg, BATCH, SEQ, device="cpu"), csh)
    toks = torch.from_numpy(_tokens(cfg))
    with torch.no_grad(), S.sharding_ctx(mesh, rules):
        prefill, caches = M.prefill(
            cfg, params, {"tokens": place(toks[:, :SEQ], ("batch", "seq"))},
            caches)
        step, caches = M.decode_step(
            cfg, params, place(toks[:, SEQ:], ("batch", None)),
            place(torch.full((BATCH,), SEQ, dtype=torch.int32), ("batch",)),
            caches)
    out = {"calls": calls, "specs": [tuple(sh.spec) for sh in
                                     tree_leaves(csh)],
           "logits": [x.full_tensor() for x in (prefill, step)],
           "caches": [x.full_tensor() for x in tree_leaves(caches)]}
    if rank == 0:
        torch.save(out, Path(workdir) / "long.pt")
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' prefill, and the JAX package's meanwhile."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_config as jax_get_config
    from repro.configs.base import reduced as jax_reduced
    from repro.models import model as JM
    from repro_torch.convert import tree_from_numpy
    workdir = tmp_path_factory.mktemp("long_prefill")
    jcfg = jax_reduced(jax_get_config(ARCH))
    jp = jax.device_get(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    torch.save(tree_from_numpy(jp, "cpu"), workdir / f"{ARCH}.pt")
    port = _free_port()
    code = ("import sys; sys.path[:0] = [%r, %r]; import "
            "test_torch_mesh_long_prefill as t; t._worker(%r)"
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
        toks = _tokens(jcfg)
        jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(
            toks[:, :SEQ])}, JM.init_caches(jcfg, BATCH, SEQ))
        js, jc = JM.decode_step(jcfg, jp, jnp.asarray(toks[:, SEQ:]),
                                jnp.full((BATCH,), SEQ, jnp.int32), jc)
        want = {"logits": [np.asarray(x, np.float32) for x in (jl, js)],
                "caches": [np.asarray(x, np.float32)
                           for x in jax.tree.leaves(jc)]}
        outs = [p.communicate(timeout=GROUP_TIMEOUT_S)[0] for p in procs]
    except BaseException as e:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        if isinstance(e, subprocess.TimeoutExpired):
            pytest.fail(f"long prefill did not finish in {GROUP_TIMEOUT_S} s")
        raise
    bad = [(r, o[-3000:]) for r, (p, o) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    assert not bad, f"long prefill failed: {bad}"
    return torch.load(workdir / "long.pt", weights_only=False), want


def test_every_block_takes_the_chunked_path(runs):
    """Each attention block ran ``_chunked_attention`` once on this rank,
    on its own data row, and the global caches are split on "kv_seq"."""
    got, _ = runs
    cfg = reduced(get_config(ARCH))
    assert len(got["calls"]) == cfg.num_layers
    assert all(c[:2] == (BATCH // 2, SEQ) for c in got["calls"])
    assert any(len(s) >= 3 and s[-3] == "model" for s in got["specs"])


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_logits_match_jax(step, runs):
    got, want = runs
    i = ["prefill", "decode"].index(step)
    assert tuple(got["logits"][i].shape) == want["logits"][i].shape
    assert _rel(got["logits"][i], torch.from_numpy(want["logits"][i])) < TOL


def test_caches_match_jax(runs):
    got, want = runs
    for g, w in zip(got["caches"], want["caches"], strict=True):
        assert tuple(g.shape) == w.shape
        assert _rel(g, torch.from_numpy(w)) < TOL
